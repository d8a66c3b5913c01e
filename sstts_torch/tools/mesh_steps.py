"""Train steps on a data x model layout, for holding a mesh to one device.

`run_steps` takes full weights and global batches and runs the port's
train step on them: in this process without a layout, or as a rank of
`sstts_torch.parallel.mesh.launch` with one (each rank builds its mesh,
keeps its shard and takes its rows).  It returns what a comparison needs,
the same on every rank: each step's metrics and wall time, the whole
parameters, batch-norm statistics and Adam moments gathered after the last
step, and this rank's shard shapes.

    from sstts_torch.parallel.mesh import launch
    ranks = launch(run_steps, 4, cfg, params, batches, "cpu", (2, 2))
    one = run_steps(cfg, params, batches, "cpu")
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from sstts_torch.config import Config
from sstts_torch.ops import kernel_wrappers
from sstts_torch.parallel import mesh as mesh_mod


def run_steps(
    cfg: Config,
    params: Mapping[str, torch.Tensor],
    batches: Sequence[Mapping],
    device_type: str = "cpu",
    layout: Optional[Tuple[int, int]] = None,
    deterministic: bool = False,
    workdir: Optional[str] = None,
) -> Dict:
    """`len(batches)` train steps from the state dict `params` (parameters
    and batch-norm statistics, whole); `layout` = (data, model) makes this
    process a rank of that mesh.  `deterministic` runs the steps under
    PyTorch's deterministic algorithms; `workdir` keeps the final state as
    a checkpoint there (every rank takes part, rank 0 writes)."""
    from sstts_torch import train as tr
    from sstts_torch.checkpoint import CheckpointManager

    mesh = None
    dev = torch.device(device_type)
    if layout is not None:
        mesh = mesh_mod.make_mesh(data_parallel=layout[0], model_parallel=layout[1])
        if device_type == "cuda":
            dev = torch.device("cuda", mesh.rank)
    state = tr.create_state(cfg, device=dev, mesh=mesh)
    state.model.load_state_dict(
        {n: mesh_mod.shard_tensor(n, v, mesh) for n, v in params.items()}
    )
    step = tr.make_train_step(cfg)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    metrics: List[Dict[str, float]] = []
    walls: List[float] = []
    try:
        for batch in batches:
            t0 = time.perf_counter()
            m = step(state, batch)
            m = {k: float(v) for k, v in m.items()}  # waits for the device
            walls.append(time.perf_counter() - t0)
            metrics.append(m)
    finally:
        torch.use_deterministic_algorithms(saved)
    if workdir is not None:
        if mesh is None or mesh.rank == 0:
            CheckpointManager(cfg, workdir)  # the directory and its fingerprint
        if mesh is not None:
            torch.distributed.barrier()
        CheckpointManager(cfg, workdir).save(state.step, state)
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    moments = {
        n: {k: mesh_mod.gather_tensor(n, state.optimizer.state[p][k], mesh).cpu()
            for k in ("exp_avg", "exp_avg_sq")}
        for n, p in zip(names, model.parameters())
    }
    return {
        "metrics": metrics,
        "walls": walls,
        "params": {n: mesh_mod.gather_tensor(n, p.detach(), mesh).cpu()
                   for n, p in model.named_parameters()},
        "buffers": {n: b.detach().cpu() for n, b in model.named_buffers()},
        "moments": moments,
        "shard_shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
        "moment_shapes": {
            n: tuple(state.optimizer.state[p]["exp_avg"].shape)
            for n, p in model.named_parameters()
        },
        "launches": {k: w.launches for k, w in wrappers.items()},
        "rank": None if mesh is None else mesh.rank,
        "coords": None if mesh is None else mesh.coords,
        "device": str(dev),
    }
