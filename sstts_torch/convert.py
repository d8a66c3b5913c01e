"""flax parameter trees <-> the port's `state_dict`.

`convert_params` takes the JAX package's `params` and `batch_stats` trees as
nested dicts of numpy arrays (what `jax.tree.map(np.asarray, ...)` gives)
and returns a `state_dict` for `sstts_torch.model.tacotron.Tacotron`.  The
layout rules:

* Dense `kernel` (in, out) -> `Linear.weight` (out, in), i.e. transposed;
* conv kernels, the bank's `conv{k}` and the projections' `kernel`,
  (k, D, C) "WIO" -> (C, D, k), PyTorch's Conv1d layout;
* GRU `wx`/`wh`/`b` keep the fused r, z, n layout; a BiGRU's `forward` and
  `backward` become `forward_gru`/`backward_gru` (an `nn.Module` cannot
  have a child named `forward`);
* batch-norm `scale`/`bias` plus `mean`/`var` from batch_stats;
* attention `memory_proj`/`query_proj` kernels as Dense, Bahdanau's `b`
  and `v` as is (a local-Luong tree has only the two projections, and each
  model refuses the other's tree);
* the fused and unfused conv banks share their `conv{k}` parameters, and
  `compute_dtype` changes no parameter (they stay f32), so the three
  convert identically;
* `embedding/embedding` -> `embedding.weight`.

It raises on a leaf the port has no place for and on a port tensor that no
leaf fills, so nothing is silently dropped or left at its init.  `to_flax`
is the inverse: a `state_dict` (or any name -> tensor map of the model's
parameters, such as their gradients) -> flax-shaped `params` and
`batch_stats` trees of numpy leaves.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from sstts_torch.config import Config
from sstts_torch.model.tacotron import Tacotron

_RENAME = {"forward": "forward_gru", "backward": "backward_gru"}
_UNRENAME = {v: k for k, v in _RENAME.items()}


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _convert_leaf(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    leaf = path[-1]
    mods = [_RENAME.get(p, p) for p in path[:-1]]
    if path[-2:] == ("embedding", "embedding"):
        return ".".join(mods + ["weight"]), value
    if leaf == "kernel":
        if value.ndim == 2:
            return ".".join(mods + ["weight"]), value.T
        if value.ndim == 3:
            return ".".join(mods + ["weight"]), value.transpose(2, 1, 0)
        raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {value.shape}")
    if leaf.startswith("conv") and value.ndim == 3:
        return ".".join(mods + [leaf]), value.transpose(2, 1, 0)
    return ".".join(mods + [leaf]), value


def convert_params(params: Any, batch_stats: Any, cfg: Config) -> Dict[str, torch.Tensor]:
    """flax `params` + `batch_stats` -> a strict `state_dict` for
    `Tacotron(cfg.arch, cfg.dataset)` (f32 CPU tensors)."""
    expected = Tacotron(cfg.arch, cfg.dataset).state_dict()
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, value in _leaves(tree):
            key, arr = _convert_leaf(path, value)
            if key not in expected:
                raise KeyError(f"flax leaf {'/'.join(path)} has no port tensor ({key})")
            if key in out:
                raise KeyError(f"two flax leaves map to {key}")
            if tuple(arr.shape) != tuple(expected[key].shape):
                raise ValueError(
                    f"{'/'.join(path)} -> {key}: shape {arr.shape} vs "
                    f"{tuple(expected[key].shape)}"
                )
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port tensors with no flax leaf: {missing}")
    return out


def to_flax(state: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A port name -> tensor map -> (params, batch_stats) nested dicts of
    numpy arrays in the flax layout (the inverse of `convert_params`)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, tensor in state.items():
        *mods, leaf = key.split(".")
        mods = [_UNRENAME.get(m, m) for m in mods]
        value = tensor.detach().cpu().numpy().copy()
        tree = stats if leaf in ("mean", "var") else params
        if leaf == "weight" and mods[-1] == "embedding":
            leaf = "embedding"
        elif leaf == "weight":
            leaf = "kernel"
            value = value.T if value.ndim == 2 else value.transpose(2, 1, 0)
        elif leaf.startswith("conv") and value.ndim == 3:
            value = value.transpose(2, 1, 0)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(value)
    return params, stats
