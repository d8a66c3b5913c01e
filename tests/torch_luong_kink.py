"""The Luong train-step parity case at a given string hash, traced.

    PYTHONPATH=. python tests/torch_luong_kink.py 86 [270 ...] [--window 16] [--arch bahdanau]

`tests/test_torch_arch_variants.py::test_train_step_matches_jax[luong]`
draws its batch's audio noise from Python's per-process string hash of the
utterance ids.  For each PYTHONHASHSEED given, this script computes that
hash in a child process, gives it to the synthetic corpus, and prints: both
packages' gradient norm over one train-mode forward and loss (the test's
grad_norm, before clipping); the linear and mel outputs lying within 1e-5
of their L1 targets, with both packages' values (where they sit on
opposite sides, the L1 term's gradient flips sign there); and the port's
grad_norm once its value at each such element is put on JAX's side of the
kink (the same gradient otherwise).  Not a test; it imports both
packages, as the tests do.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from torch_parity import jax_variables, port_model, t, tiny_pair, train_batch

import sstts_torch.data.synthetic as syn
from sstts import train as jtrain
from sstts.dsp.ops import wav_to_features
from sstts.model.losses import frame_mask_from_lengths, tacotron_loss as jax_loss
from sstts_torch.convert import to_flax
from sstts_torch.model.losses import tacotron_loss as port_loss

UIDS = ("SYN-00000", "SYN-00001")


def hashes(seed: int) -> dict:
    """hash() of the batch's utterance ids under PYTHONHASHSEED=seed."""
    out = subprocess.run(
        [sys.executable, "-c", f"print(*(hash(u) for u in {UIDS!r}))"],
        env=dict(os.environ, PYTHONHASHSEED=str(seed)), capture_output=True, text=True,
        check=True,
    ).stdout.split()
    return dict(zip(UIDS, map(int, out)))


def trace(seed: int, window: int, arch: str) -> None:
    h = hashes(seed)
    syn.hash = lambda uid: h[uid]  # the corpus's noise under that seed
    variant = ({"attention_type": "local_luong", "local_attention_window": window}
               if arch == "luong" else {})
    jcfg, pcfg = tiny_pair(
        dataset={"dataset": "synthetic"}, arch={**variant, "prenet_dropout": 0.0},
        training={"batch_size": 2, "text_buckets": (48,), "frame_buckets": (96,)},
    )
    v = jax_variables(jcfg, seed=7)
    batch = train_batch(pcfg)
    model = jtrain.build_model(jcfg)
    samples = jnp.asarray(batch["samples"]).astype(jnp.float32) * (1.0 / 32767.0)
    lin, mel = wav_to_features(samples, jcfg.dataset)
    fmask = frame_mask_from_lengths(jnp.asarray(batch["n_frames"]), mel.shape[1])
    ids, lf = jnp.asarray(batch["char_ids"]), jnp.asarray(batch["loss_frames"])
    tl = jnp.asarray(batch["text_len"])

    def jax_step(params):
        o, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]}, ids, mel,
                           fmask, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                           mutable=["batch_stats"])
        return jax_loss(o, mel, lin, lf, jcfg.arch, jcfg.dataset, text_lengths=tl)[0], o

    (_, jout), jgrads = jax.value_and_grad(jax_step, has_aux=True)(v["params"])

    def port_norm(shift=None):
        pm = port_model(pcfg, v).train()
        o = pm(t(np.asarray(ids)).long(), t(np.asarray(mel)), t(np.asarray(fmask)))
        if shift is not None:
            o = dict(o, linear=o["linear"] + shift, mel=o["mel"])
        loss, _ = port_loss(o, t(np.asarray(mel)), t(np.asarray(lin)),
                            torch.as_tensor(np.asarray(lf)), pcfg.arch, pcfg.dataset,
                            text_lengths=torch.as_tensor(np.asarray(tl)))
        loss.backward()
        grads = to_flax({n: p.grad if p.grad is not None else torch.zeros_like(p)
                         for n, p in pm.named_parameters()})[0]
        return float(optax.global_norm(jax.tree.map(np.asarray, grads))), o

    p_norm, pout = port_norm()
    j_norm = float(optax.global_norm(jgrads))
    print(f"PYTHONHASHSEED={seed} {arch} window {window}: grad_norm JAX {j_norm:.7f} "
          f"port {p_norm:.7f} ({abs(p_norm - j_norm) / j_norm:.2e} relative)")
    valid = np.asarray(frame_mask_from_lengths(lf, mel.shape[1]))[..., None]
    shift = torch.zeros_like(pout["linear"])
    for key, target in (("mel", mel), ("linear", lin)):
        jp, pp, tg = np.asarray(jout[key]), pout[key].detach().numpy(), np.asarray(target)
        near = (np.abs(jp - tg) < 1e-5) & np.broadcast_to(valid, jp.shape)
        for idx in map(tuple, np.argwhere(near)):
            flip = np.sign(jp[idx] - tg[idx]) != np.sign(pp[idx] - tg[idx])
            print(f"  {key}{idx}: JAX {jp[idx]:.8f} port {pp[idx]:.8f} target "
                  f"{tg[idx]:.8f}{'  <- opposite sides of the kink' if flip else ''}")
            if key == "linear" and flip:
                shift[idx] = float(jp[idx] - pp[idx])
    if shift.any():
        fixed, _ = port_norm(shift)
        print(f"  the port with JAX's side of each flipped kink: grad_norm {fixed:.7f} "
              f"({abs(fixed - j_norm) / j_norm:.2e} relative)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seeds", nargs="+", type=int)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--arch", choices=("luong", "bahdanau"), default="luong")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    for seed in args.seeds:
        trace(seed, args.window, args.arch)


if __name__ == "__main__":
    main()
