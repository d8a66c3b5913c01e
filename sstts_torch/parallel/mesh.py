"""Device mesh, sharding rules and the process launcher: the port of
`sstts/parallel/mesh.py` (31-97).

A `Mesh` lays devices out on the JAX package's two axes, ("data", "model"):
the batch splits over "data" in contiguous rows (`P("data")`), and the
"model" axis tensor-parallelizes the two widest matrices (`TP_RULES`): the
character embedding column-parallel over its feature dim and the post-net
projection row-parallel over its input dim, its 1025-wide bias whole.
Every other parameter, the batch-norm statistics and the Adam moments of
replicated parameters are replicated; the moments of a sharded parameter
mirror its shard.

XLA emits the collectives of a GSPMD program from these annotations.  Here
they are explicit, over `torch.distributed` groups, and each is written so
that a mesh computes what one device computes:

* one process per device (`launch`: NCCL with rank r on `cuda:r`, gloo on
  the CPU), laid out row-major, rank = data index x model + model index;
  one "data" group per model index (the ranks holding the same shard) and
  one "model" group per data index (the ranks holding the same rows);
* batch norm and the masked losses take their sums over the data group
  (`all_reduce_sum`, `sum_over`), so their statistics and denominators are
  the global batch's; each rank's loss is its own numerator over the
  global denominator, and the gradients are summed over the data group
  (`reduce_gradients`);
* the tensor-parallel layers (`gather_from_group`, `copy_to_group`,
  `reduce_from_group`) follow Megatron's pairs: the computation after them
  is replicated over the model group, so a gather's backward keeps its own
  slice and a reduction's backward is the identity;
* the gradient norm counts each sharded gradient once over the model group
  and each replicated one once (`global_grad_norm`).

A mesh of one process (`make_mesh(devices=[...])` without a process group)
is a layout of that process's devices: `Synthesizer(mesh=...)` runs one
shard of the batch on each data device and needs no collective.

Importing this module starts nothing and touches no CUDA device.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

#: Tensor-parallel layout (`sstts/parallel/mesh.py:58-61`): parameter name
#: -> the dim of the torch tensor that shards over "model".  flax keeps a
#: dense kernel as (in, out) and `nn.Linear` as (out, in), so the post-net
#: projection's input dim is dim 1 here, as the embedding's feature dim is.
TP_RULES: Mapping[str, int] = {"embedding.weight": 1, "linear_proj.weight": 1}


class Mesh:
    """A (data, model) grid of devices.

    `members` is an (n, m) object array: torch devices of this process, or
    the ranks of the default process group (one device each), with `rank`
    this process's rank and the groups that hold it."""

    def __init__(self, members: np.ndarray, rank: Optional[int] = None,
                 data_group=None, model_group=None):
        self.members = members
        self.rank = rank
        self.data_group = data_group
        self.model_group = model_group
        self.coords = None
        if rank is not None:
            hit = np.argwhere(members == rank)
            if len(hit):
                self.coords = tuple(int(c) for c in hit[0])

    @property
    def shape(self) -> Dict[str, int]:
        n, m = self.members.shape
        return {"data": n, "model": m}

    @property
    def distributed(self) -> bool:
        return self.rank is not None

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    @property
    def tp(self) -> bool:
        """Whether the model axis shards anything (more than one rank)."""
        return self.distributed and self.shape["model"] > 1

    def data_devices(self) -> List[torch.device]:
        """A one-process mesh's devices along "data" (its first model
        column; the model axis replicates inference)."""
        if self.distributed:
            raise ValueError("a mesh of processes has one device per rank")
        return [torch.device(d) for d in self.members[:, 0]]

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch` rows."""
        return row_slices(batch, self.shape["data"])[self.data_index]

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank})"


def make_mesh(
    devices: Optional[Sequence[Any]] = None,
    data_parallel: Optional[int] = None,
    model_parallel: int = 1,
) -> Mesh:
    """A data_parallel x model_parallel mesh of the first devices.

    `devices` defaults to the ranks of the default process group where one
    is initialized (every rank must then call this, as it creates the
    groups), else to every visible CUDA device, else the CPU.  Integers
    name ranks; anything else a torch device of this process.
    `data_parallel` defaults to every device left after the model axis.
    Raises ValueError when the axes need more devices than there are."""
    if devices is None:
        if dist.is_available() and dist.is_initialized():
            devices = list(range(dist.get_world_size()))
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cpu")]
    n = data_parallel or len(devices) // model_parallel
    if n < 1 or n * model_parallel > len(devices):
        raise ValueError(
            f"make_mesh: {n} x {model_parallel} mesh needs "
            f"{max(n, 1) * model_parallel} devices, have {len(devices)}"
        )
    members = np.empty(n * model_parallel, dtype=object)
    members[:] = list(devices[: n * model_parallel])
    members = members.reshape(n, model_parallel)
    if not all(isinstance(d, (int, np.integer)) for d in members.flat):
        return Mesh(members)
    members = members.astype(np.int64)
    rank = dist.get_rank()
    # Every rank creates every group, in one order (new_group is collective
    # over the default group).
    data_group = model_group = None
    for j in range(model_parallel):
        g = dist.new_group([int(r) for r in members[:, j]])
        if rank in members[:, j]:
            data_group = g
    for i in range(n):
        g = dist.new_group([int(r) for r in members[i, :]])
        if rank in members[i, :]:
            model_group = g
    return Mesh(members, rank, data_group, model_group)


def row_slices(batch: int, n: int) -> List[slice]:
    """The contiguous rows each of `n` data shards takes, [r*b/n, (r+1)*b/n),
    as `P("data")` lays them out; n must divide the batch."""
    if batch % n:
        raise ValueError(f"a batch of {batch} rows does not split over {n} data shards")
    k = batch // n
    return [slice(r * k, (r + 1) * k) for r in range(n)]


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of every array of a batch."""
    return {k: v[mesh.rows(len(v))] for k, v in batch.items()}


# --------------------------------------------------------------- sharding --


def shard_tensor(name: str, full: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's shard of a full tensor stored under parameter `name` (the
    parameter itself, its EMA or an Adam moment); the tensor itself where
    it is whole on this rank."""
    dim = TP_RULES.get(name)
    if mesh is None or dim is None or not mesh.tp:
        return full
    m, size = mesh.shape["model"], full.shape[dim]
    if size % m:
        raise ValueError(f"{name}: dim {dim} of {size} does not split over {m} model shards")
    k = size // m
    return full.narrow(dim, mesh.model_index * k, k).contiguous()


def gather_tensor(name: str, local: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The full tensor of a shard stored under parameter `name`, gathered
    over the model group (every rank of the group must call it)."""
    if mesh is None or not mesh.tp or name not in TP_RULES:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, local.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=TP_RULES[name])


def shard_model(model: torch.nn.Module, mesh: Mesh) -> None:
    """Put a full model on the mesh, in place: keep this rank's shard of
    each TP_RULES parameter and give every masked batch norm the data group
    (its statistics become the global batch's in train mode)."""
    from sstts_torch.model.modules import MaskedBatchNorm

    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            local = shard_tensor(name, p.data, mesh)
            if local is not p.data:
                owner, attr = _owner(model, name)
                setattr(owner, attr, torch.nn.Parameter(local.clone()))
    for mod in model.modules():
        if isinstance(mod, MaskedBatchNorm):
            mod.group = mesh.data_group
    model.mesh = mesh


def _owner(model: torch.nn.Module, name: str):
    *path, attr = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    return mod, attr


# ------------------------------------------------------------ collectives --


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, without gradient (None: `x`)."""
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose ranks each go on with their own computation:
    the gradient of every rank's input is the sum of all ranks' output
    gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    input is replicated, each rank uses its own part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum of partial results over the group, whose ranks then compute the
    same thing: the backward passes the gradient through."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """Concatenation of every rank's part along `dim`, which the ranks then
    use alike: the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.index, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _GatherFromGroup.apply(x, group, dim % x.dim())


def reduce_gradients(params: Sequence[torch.nn.Parameter], mesh: Mesh) -> None:
    """Sum every gradient over the data group, in one flat all-reduce."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()


def global_grad_norm(named_grads: Sequence, mesh: Mesh, norm: Callable) -> torch.Tensor:
    """The global norm of a mesh's gradients: each replicated gradient
    counted once, each sharded one summed over the model group.  `norm` is
    the one-device global norm of a list of tensors; without tensor
    parallelism it is that of every gradient, as on one device."""
    if not mesh.tp:
        return norm([g for _, g in named_grads])
    whole = [g for n, g in named_grads if n not in TP_RULES]
    parts = [g for n, g in named_grads if n in TP_RULES]
    sq = norm(parts) ** 2
    dist.all_reduce(sq, group=mesh.model_group)
    return torch.sqrt(norm(whole) ** 2 + sq)


# --------------------------------------------------------------- launcher --


_DEFAULT_COLLECTIVE_S = 1800.0  # torch's default bound on a group's collectives


def _worker(rank, fn, args, world, backend, store_path, out_dir, timeout_s):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    kw = {"device_id": torch.device("cuda", rank)} if backend == "nccl" else {}
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kw,
    )
    try:
        result = fn(*args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _hash_seed():
    """One string-hash seed for every rank (the synthetic corpus seeds its
    noise from `hash(uid)`), set while the ranks start."""
    saved = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = saved or "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["PYTHONHASHSEED"]


def launch(fn: Callable, world_size: int, *args, device: str = "cpu",
           timeout: Optional[float] = 600.0,
           collective_timeout: Optional[float] = None) -> List[Any]:
    """Run `fn(*args)` in `world_size` new processes, one rank each, and
    return their results by rank.

    Each process joins one process group before `fn` runs: NCCL with rank r
    on `cuda:r` where `device` is "cuda" (never gloo there), gloo on the CPU
    with torch pinned to one thread.  The rendezvous is a `FileStore` in a
    temporary directory (no port to collide on).  `collective_timeout`
    bounds the rendezvous and each of the group's collectives (None:
    `timeout`, or torch's 30 minutes where that is None too); `timeout`
    bounds the whole run, and None sets no deadline.  A rank that dies, or
    a collective that waits past its bound, fails the launch, and every
    process is stopped before it returns.
    `fn` must be importable by name, and the caller's main script must
    keep its work under `if __name__ == "__main__"`: spawned processes
    import both."""
    kind = torch.device(device).type
    if kind == "cuda" and torch.cuda.device_count() < world_size:
        raise ValueError(
            f"launch: {world_size} ranks need {world_size} CUDA devices, "
            f"have {torch.cuda.device_count()}"
        )
    backend = "nccl" if kind == "cuda" else "gloo"
    import multiprocessing.connection as mp_connection

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="sstts_mesh_") as tmp:
        if collective_timeout is None:
            collective_timeout = timeout if timeout is not None else _DEFAULT_COLLECTIVE_S
        args_ = (fn, args, world_size, backend, str(Path(tmp) / "store"), tmp,
                 collective_timeout)
        with _hash_seed():
            ctx = mp.start_processes(
                _worker, args=args_, nprocs=world_size, join=False, start_method="spawn"
            )
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            # Poll exit codes: ProcessContext.join blocks on a process that
            # has signalled its end but not yet exited, past any deadline.
            while True:
                codes = [p.exitcode for p in ctx.processes]
                if any(c not in (None, 0) for c in codes):
                    ctx.join(timeout=0.1)  # raises with the rank's traceback
                    raise RuntimeError(f"launch: a rank failed, exit codes {codes}")
                if all(c == 0 for c in codes):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"launch: {world_size} ranks still running after {timeout} s")
                mp_connection.wait([p.sentinel for p in ctx.processes if p.exitcode is None],
                                   timeout=1.0)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [
            torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)
        ]
