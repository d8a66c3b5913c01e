"""Host and device time of a train step on one device and as a mesh rank.

    python3 -m sstts_torch.tools.mesh_profile [--warmup 3] [--steps 4] [--profiled 2]

Run from the root of the repository (it takes phase 3b's batch from
`chip_smoke.fixed_batch`: b=32 in the 515-frame bucket, the default
widths).  The same init and batch go through the port's train step in this
process and as the one rank of a (1, 1) mesh over NCCL (`mesh.launch`),
each `--warmup` steps, then `--steps` timed ones, then `--profiled` under
`torch.profiler`.  It prints one JSON line a run: the timed steps' walls,
the profiled steps' host self time (summed over the host's threads) and
device time, the count and host time of the rank's all-reduces
(`c10d::allreduce_`), and the host time of `_FusedTeacherScanBackward`
(B6's backward replaying the f32 scan) over that host self time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Mapping, Optional, Tuple

import torch


def _host_and_device_us(events) -> Tuple[float, float]:
    host = sum(e.self_cpu_time_total for e in events)
    device = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
    return host, device


def profile_steps(cfg, params: Mapping[str, torch.Tensor], batch: Mapping,
                  device_type: str = "cuda", layout: Optional[Tuple[int, int]] = None,
                  warmup: int = 3, steps: int = 4, profiled: int = 2) -> Dict:
    """Train steps on `batch` from the state dict `params`, in this process
    (`layout` None) or as a rank of `layout` (a `mesh.launch` worker)."""
    from torch.profiler import ProfilerActivity, profile

    from sstts_torch import train as tr
    from sstts_torch.parallel import mesh as mesh_mod

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

    def one():
        return {k: float(v) for k, v in step(state, batch).items()}  # waits for the device

    for _ in range(warmup):
        one()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        one()
        walls.append((time.perf_counter() - t0) * 1e3)
    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(profiled):
            one()
    events = prof.key_averages()
    host_us, device_us = _host_and_device_us(events)
    allreduce = [e for e in events if e.key == "c10d::allreduce_"]
    # The autograd engine's event wraps the function's own: count it alone.
    teacher = [e for e in events
               if e.key == "autograd::engine::evaluate_function: _FusedTeacherScanBackward"]
    return {
        "layout": None if layout is None else list(layout),
        "ms_per_step": walls,
        "profiled_steps": profiled,
        "host_self_ms": host_us / 1e3,
        "device_ms": device_us / 1e3,
        "allreduce_count": sum(e.count for e in allreduce),
        "allreduce_host_ms": sum(e.cpu_time_total for e in allreduce) / 1e3,
        "teacher_backward_host_share": (
            sum(e.cpu_time_total for e in teacher) / host_us if host_us else None
        ),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--profiled", type=int, default=2)
    args = ap.parse_args()

    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from sstts_torch.config import Config
    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.parallel.mesh import launch

    if not torch.cuda.is_available():
        raise SystemExit("mesh_profile: no CUDA device")
    cfg = Config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, dataset="synthetic"),
        training=dataclasses.replace(cfg.training, batch_size=32),
    )
    batch = chip_smoke.fixed_batch(cfg, 32, 1, (10, 16))
    params = init_state_dict(cfg.arch, cfg.dataset, 0)
    counts = (args.warmup, args.steps, args.profiled)
    card = chip_smoke.card_line()
    runs = [profile_steps(cfg, params, batch, "cuda", None, *counts)]
    runs += launch(profile_steps, 1, cfg, params, batch, "cuda", (1, 1), *counts,
                   device="cuda", timeout=900.0)
    for run in runs:
        print(json.dumps({**run, "card": card}), flush=True)


if __name__ == "__main__":
    main()
