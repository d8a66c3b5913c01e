"""Parallelism: the ("data", "model") device mesh, its sharding rules and
the process launcher (`sstts_torch.parallel.mesh`)."""

from sstts_torch.parallel.mesh import Mesh, launch, make_mesh, row_slices, shard_batch

__all__ = ["Mesh", "launch", "make_mesh", "row_slices", "shard_batch"]
