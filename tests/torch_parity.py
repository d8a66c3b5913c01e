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


def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref|| in f64."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def train_batch(cfg, seed: int = 0):
    """One bucketed batch of two short synthetic utterances (the first
    bucket); each waveform is made once here and the same arrays feed both
    packages."""
    from sstts_torch.data import pipeline
    from sstts_torch.data.synthetic import make_utterances, synth_waveform

    utts = make_utterances(8, cfg.dataset, min_words=1, max_words=2)
    items = [
        (pipeline.text_mod.encode(u.text), synth_waveform(u.uid, u.text, cfg.dataset))
        for u in utts[seed * 2 : seed * 2 + 2]
    ]
    lt, fr = pipeline.frame_bucket_shapes(cfg)[0]
    return pipeline.make_batch(items, lt, fr, cfg)


def jax_train_grads(jcfg, variables, batch):
    """The JAX train step's loss, metrics and parameter gradients
    (value_and_grad of `sstts.train`'s loss, the model built by
    `build_model`, so in the config's compute dtype)."""
    import optax

    from sstts import train as jtrain
    from sstts.dsp.ops import wav_to_features
    from sstts.model.losses import frame_mask_from_lengths, tacotron_loss

    model = jtrain.build_model(jcfg)

    @jax.jit
    def grads_fn(params, batch_stats, batch):
        samples = batch["samples"].astype(jnp.float32) * (1.0 / 32767.0)
        lin, mel = wav_to_features(samples, jcfg.dataset)
        fmask = frame_mask_from_lengths(batch["n_frames"], mel.shape[1])

        def loss_fn(p):
            out, _ = model.apply(
                {"params": p, "batch_stats": batch_stats}, batch["char_ids"], mel,
                fmask, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"],
            )
            return tacotron_loss(out, mel, lin, batch["loss_frames"], jcfg.arch,
                                 jcfg.dataset, text_lengths=batch["text_len"])

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        metrics["grad_norm"] = optax.global_norm(grads)
        return metrics, grads

    metrics, grads = jax.device_get(
        grads_fn(variables["params"], variables["batch_stats"], batch)
    )
    return {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads)


def port_train_grads(pcfg, variables, batch):
    """The port's train step (`make_train_step`, on the CPU) from the same
    converted weights: its metrics and its gradients before clipping, as a
    flax tree."""
    from sstts_torch import train as ptrain
    from sstts_torch.convert import to_flax

    state = ptrain.create_state(pcfg, device="cpu")
    state.model.load_state_dict(
        convert_params(variables["params"], variables["batch_stats"], pcfg)
    )
    metrics = {k: float(v) for k, v in ptrain.make_train_step(pcfg)(state, batch).items()}
    unclip = max(1.0, metrics["grad_norm"] / pcfg.training.grad_clip_norm)
    grads = to_flax({n: p.grad * unclip for n, p in state.model.named_parameters()})[0]
    return metrics, grads


def tree_pairs(ref_tree, got_tree):
    """(path, got, ref) for every leaf of `ref_tree`."""
    for path, r in jax.tree_util.tree_leaves_with_path(ref_tree):
        node = got_tree
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), np.asarray(node), np.asarray(r)
