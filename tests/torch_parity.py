"""Shared set-up for the parity tests between `sstts` (JAX, the reference)
and `sstts_torch` (the PyTorch port): one tiny configuration built in both
packages, a JAX init with perturbed batch-norm statistics, and the port
model loaded from it through `sstts_torch.convert`.  Data crosses between
the two as numpy arrays."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sstts.config import tiny_config as jax_tiny_config
from sstts.model.tacotron import Tacotron as JaxTacotron
from sstts_torch.config import tiny_config as port_tiny_config
from sstts_torch.convert import convert_params
from sstts_torch.model.tacotron import Tacotron


def tiny_pair(**sections):
    """(JAX Config, port Config): tiny_config() in each package with the
    same field overrides, given per section: tiny_pair(arch={...})."""

    def apply(cfg):
        return cfg.replace(
            **{
                name: dataclasses.replace(getattr(cfg, name), **fields)
                for name, fields in sections.items()
            }
        )

    jcfg, tcfg = apply(jax_tiny_config()), apply(port_tiny_config())
    assert jcfg.fingerprint() == tcfg.fingerprint()
    return jcfg, tcfg


def jax_variables(cfg, seed: int = 0):
    """A JAX init of the whole model (numpy leaves) whose batch-norm running
    statistics are set to seeded random values, so that the conversion of
    mean/var is exercised."""
    model = JaxTacotron(cfg.arch, cfg.dataset)
    ids = jnp.zeros((2, 16), jnp.int32)
    mel = jnp.zeros((2, 16, cfg.dataset.n_mels), jnp.float32)
    init = jax.jit(
        lambda r: model.init(
            {"params": r, "dropout": r}, ids, mel, jnp.ones((2, 16), bool),
            train=True,
        )
    )
    v = jax.tree.map(np.asarray, jax.device_get(init(jax.random.PRNGKey(seed))))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    v["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, v["batch_stats"])
    return v


def port_model(tcfg, variables) -> Tacotron:
    model = Tacotron(tcfg.arch, tcfg.dataset)
    model.load_state_dict(
        convert_params(variables["params"], variables["batch_stats"], tcfg)
    )
    return model.eval()


def text_ids(rng: np.random.Generator, lengths, width: int, vocab: int = 40):
    """Padded id batch (B, width) with ids in [2, vocab) and zero padding."""
    ids = np.zeros((len(lengths), width), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(2, vocab, n)
    return ids


def t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))
