"""The driver-parity case over Python's string hash, in one process.

    PYTHONPATH=.:tests python tests/torch_driver_sweep.py 0 1 2 ... [--range A B]
        [--spc 1] [--lr 2e-3] [--trace]

`tests/test_torch_train_driver.py::test_driver_matches_jax_at_default_corpus_cache`
trains both packages on a synthetic corpus whose audio noise is seeded from
Python's per-process string hash of the utterance ids.  For each
PYTHONHASHSEED given, this script computes those hashes in a child
process, gives them to both packages' synthetic corpora and runs the test's
comparison (both drivers for 4 steps from one init, dropout off, JAX on the
test harness's 8 CPU devices), printing each seed's largest relative miss
of a logged loss with its record and key, and the final parameters'
largest and median difference, each beside the test's limit.  The JAX
driver's compiles are cached across seeds (`sstts.train`'s lru_caches), so
a seed costs a few seconds after the first.

`--trace` follows each seed's difference from its start: the first train
step's linear and mel outputs lying within 1e-5 of their L1 targets, in the
port, in the port from an init whose nonzero floats moved by one ulp, and
in JAX's forward on the same batch (where the port and JAX sit on opposite
sides of such a kink, the L1 term's gradient there flips sign); the step-1
gradients of both drivers (from Adam's first moments after one step: their
relative L2 difference, the tensors that differ most, the entries whose
signs differ), the parameters after that step, and the logged losses of
every step for JAX against the port, the port against the port from the
moved init, JAX against JAX from such an init, and JAX against the port
with each kink that the moved init crosses crossed in its first step.  Not a test; it imports both
packages, as the tests do.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import tiny_pair

import sstts.data.synthetic as jsyn
import sstts_torch.data.synthetic as psyn
import sstts_torch.utils.logging as plog
from sstts import train as jtrain
from sstts.dsp.ops import wav_to_features
from sstts.model.losses import frame_mask_from_lengths
from sstts_torch import train as ptrain
from sstts_torch.convert import convert_params, to_flax

MAX_STEPS = 4
KEYS = ("loss", "loss_mel", "loss_linear", "loss_stop")


def hashes(seed: int, uids) -> dict:
    """hash() of each utterance id under PYTHONHASHSEED=seed."""
    out = subprocess.run(
        [sys.executable, "-c", f"print(*(hash(u) for u in {tuple(uids)!r}))"],
        env=dict(os.environ, PYTHONHASHSEED=str(seed)), capture_output=True, text=True,
        check=True,
    ).stdout.split()
    return dict(zip(uids, map(int, out)))


def configs(lr: float, steps_per_call: int):
    """The test's `_pair(((40,), (160,)), steps_per_call=...)`."""
    return tiny_pair(
        dataset={"dataset": "synthetic", "synthetic_size": 40, "max_text_len": 40},
        arch={"prenet_dropout": 0.0},
        training={"batch_size": 2, "text_buckets": (40,), "frame_buckets": (160,),
                  "learning_rate": lr, "summary_every": 1, "checkpoint_every": 100,
                  "steps_per_call": steps_per_call},
    )


def records(workdir: Path, prefix: str):
    lines = (workdir / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r["prefix"] == prefix]


def use_seed(seed: int) -> None:
    """Both synthetic corpora's noise as under PYTHONHASHSEED=seed."""
    h = hashes(seed, [f"SYN-{i:05d}" for i in range(40)])
    jsyn.hash = psyn.hash = lambda uid: h[uid]


def nudge(tree):
    """Every nonzero float one ulp away from 0 (a zero would become a
    subnormal, which XLA's CPU flushes to zero and torch does not)."""
    return jax.tree.map(lambda a: np.where(a != 0, np.nextafter(a, np.copysign(np.inf, a)), a)
                        .astype(a.dtype) if np.issubdtype(a.dtype, np.floating) else a, tree)


def jax_run(jcfg, workdir: Path, steps: int, nudged: bool = False):
    """JAX's driver; returns its state."""
    create = jtrain.create_state
    if nudged:
        jtrain.create_state = lambda *a, **k: (lambda st: st.replace(
            params=jax.tree.map(jnp.asarray, nudge(jax.device_get(st.params)))))(create(*a, **k))
    try:
        return jtrain.train(jcfg, workdir, max_steps=steps)
    finally:
        jtrain.create_state = create


def port_run(pcfg, params0, stats0, workdir: Path, steps: int, nudged: bool = False):
    """The port's driver from JAX's init (converted); returns its state."""
    converted = convert_params(nudge(params0) if nudged else params0, stats0, pcfg)
    ptrain.init_state_dict = lambda *a, **k: converted
    return ptrain.train(pcfg, workdir, max_steps=steps, device="cpu")


def jax_params(state) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(jax.device_get(state.params))}


def port_params(state, moments: bool = False) -> dict:
    """The port's parameters (or Adam's first moments) by flax path."""
    model, opt = state.model, state.optimizer
    named = {n: (opt.state[p]["exp_avg"] if moments else p).detach()
             for n, p in model.named_parameters()}
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)
    walk(to_flax(named)[0], ())
    return flat


def jax_moments(state) -> dict:
    """Adam's first moments (mu) by flax path."""
    found = [node for node in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda n: hasattr(n, "mu")) if hasattr(node, "mu")]
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(jax.device_get(found[0].mu))}


def loss_misses(ref_dir: Path, got_dir: Path):
    """[(record, step, key, relative difference)] of every logged loss."""
    out = []
    for prefix in ("train", "eval"):
        for g, r in zip(records(got_dir, prefix), records(ref_dir, prefix)):
            for k in KEYS:
                out.append((prefix, r["step"], k, abs(g[k] - r[k]) / abs(r[k])))
    return out


def compare(seed: int, lr: float, steps_per_call: int) -> dict:
    """The test's comparison at one seed."""
    use_seed(seed)
    jcfg, pcfg = configs(lr, steps_per_call)
    init = jtrain.create_state(jcfg)
    params0 = jax.tree.map(np.asarray, jax.device_get(init.params))
    stats0 = jax.tree.map(np.asarray, jax.device_get(init.batch_stats))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        jstate = jax_run(jcfg, tmp / "jax", MAX_STEPS)
        pstate = port_run(pcfg, params0, stats0, tmp / "port", MAX_STEPS)
        worst = max(loss_misses(tmp / "jax", tmp / "port"), key=lambda m: m[3])
    ref, got = jax_params(jstate), port_params(pstate)
    flat = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    return {"seed": seed, "rel": worst[3], "where": "{} step {} {}".format(*worst[:3]),
            "max": float(flat.max()), "median": float(np.median(flat)),
            "ok": worst[3] <= 1e-3 and flat.max() <= 2.1 * lr * MAX_STEPS
            and np.median(flat) <= lr / 20}


def first_step_outputs(pcfg, params0, stats0, workdir: Path, nudged: bool):
    """The port's driver for one step, keeping its first train batch and
    that step's forward outputs (linear, mel) and targets."""
    seen = {}
    targets, loss = ptrain._targets, ptrain.tacotron_loss

    def keep_batch(b, cfg):
        seen.setdefault("batch", {k: v.clone() for k, v in b.items()})
        return targets(b, cfg)

    def keep_outputs(out, mel, lin, *a, **k):
        seen.setdefault("out", {"linear": out["linear"].detach().clone(),
                                "mel": out["mel"].detach().clone(), "lin_gt": lin.clone(),
                                "mel_gt": mel.clone()})
        return loss(out, mel, lin, *a, **k)

    ptrain._targets, ptrain.tacotron_loss = keep_batch, keep_outputs
    try:
        state = port_run(pcfg, params0, stats0, workdir, 1, nudged)
    finally:
        ptrain._targets, ptrain.tacotron_loss = targets, loss
    return state, seen


def port_run_shifted(pcfg, params0, stats0, workdir: Path, key: str, idx, shift: float):
    """The port's driver for 4 steps with its first step's output `key` at
    `idx` moved by `shift` (across its L1 kink; the gradient is otherwise
    the same)."""
    loss, done = ptrain.tacotron_loss, []

    def moved(out, *a, **k):
        if not done:
            done.append(True)
            delta = torch.zeros_like(out[key])
            delta[idx] = shift
            out = dict(out, **{key: out[key] + delta})
        return loss(out, *a, **k)

    ptrain.tacotron_loss = moved
    try:
        return port_run(pcfg, params0, stats0, workdir, MAX_STEPS)
    finally:
        ptrain.tacotron_loss = loss


def jax_forward(jcfg, params0, stats0, batch):
    """JAX's train-mode forward on the port's first batch (its own features
    from the same samples), outside its jitted step: linear, mel, targets."""
    b = {k: np.asarray(v) for k, v in batch.items()}
    samples = jnp.asarray(b["samples"]).astype(jnp.float32) * (1.0 / 32767.0)
    lin, mel = wav_to_features(samples, jcfg.dataset)
    fmask = frame_mask_from_lengths(jnp.asarray(b["n_frames"]), mel.shape[1])
    out, _ = jtrain.build_model(jcfg).apply(
        {"params": params0, "batch_stats": stats0}, jnp.asarray(b["char_ids"]), mel, fmask,
        train=True, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    return {"linear": np.asarray(out["linear"]), "mel": np.asarray(out["mel"]),
            "lin_gt": np.asarray(lin), "mel_gt": np.asarray(mel)}


def trace(seed: int, lr: float, steps_per_call: int) -> None:
    use_seed(seed)
    jcfg, pcfg = configs(lr, steps_per_call)
    b1 = jcfg.training.adam_beta1
    init = jtrain.create_state(jcfg)
    params0 = jax.tree.map(np.asarray, jax.device_get(init.params))
    stats0 = jax.tree.map(np.asarray, jax.device_get(init.batch_stats))
    print(f"PYTHONHASHSEED={seed} at lr {lr}:")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        j1 = jax_run(jcfg, tmp / "j1", 1)
        p1, first = first_step_outputs(pcfg, params0, stats0, tmp / "p1", False)
        _, nudged = first_step_outputs(pcfg, params0, stats0, tmp / "p1u", True)
        ref = jax_forward(jcfg, params0, stats0, first["batch"])
        print(f"  step 1 losses (train, then eval after the update): relative differences "
              f"{[f'{k} {r:.1e}' for _, s, k, r in loss_misses(tmp / 'j1', tmp / 'p1')]}")
        # The L1 terms' kinks: outputs within 1e-5 of their targets, valid
        # frames; those the moved init carries across, moved across in the
        # port's first step alone (the same gradient otherwise).
        valid = np.asarray(first["batch"]["loss_frames"])
        crossed = []
        for key, gt in (("linear", "lin_gt"), ("mel", "mel_gt")):
            p = first["out"][key].numpy()
            t = first["out"][gt].numpy()
            u = nudged["out"][key].numpy()
            frames = np.arange(p.shape[1])[None, :] < valid[:, None]
            near = (np.abs(p - t) < 1e-5) & frames[..., None]
            for idx in map(tuple, np.argwhere(near).tolist()):
                across = np.sign(p[idx] - t[idx]) != np.sign(u[idx] - t[idx])
                print(f"  {key}{idx}: port {p[idx]:.8f} (target {t[idx]:.8f}), from the moved "
                      f"init {u[idx]:.8f}; JAX's forward outside its step {ref[key][idx]:.8f} "
                      f"(target {ref[gt][idx]:.8f})"
                      + ("  <- the moved init crosses the kink" if across else ""))
                if across:
                    crossed.append((key, idx, float(u[idx] - p[idx])))
        for key, idx, shift in crossed:
            port_run_shifted(pcfg, params0, stats0, tmp / f"shift{idx}", key, idx, shift)
        gj = {k: v / (1 - b1) for k, v in jax_moments(j1).items()}
        gp = {k: v / (1 - b1) for k, v in port_params(p1, moments=True).items()}
        a = np.concatenate([gj[k].ravel() for k in gj]).astype(np.float64)
        b = np.concatenate([gp[k].ravel() for k in gj]).astype(np.float64)
        flip = np.sign(a) != np.sign(b)
        worst = sorted(((np.linalg.norm(gj[k] - gp[k]) / max(np.linalg.norm(gj[k]), 1e-30), k)
                        for k in gj), reverse=True)[:3]
        print(f"  step-1 gradients ({a.size} entries): relative L2 difference "
              f"{np.linalg.norm(a - b) / np.linalg.norm(a):.2e} (largest: "
              + ", ".join(f"{k} {r:.1e}" for r, k in worst)
              + f"); signs differ at {int(flip.sum())}, the largest |g| among them "
              f"{np.abs(a[flip]).max(initial=0):.2e} (largest |g| {np.abs(a).max():.2e}, "
              f"median {np.median(np.abs(a)):.2e})")
        pj, pp = jax_params(j1), port_params(p1)
        d = np.concatenate([np.abs(pp[k] - pj[k]).ravel() for k in pj])
        print(f"  parameters after step 1: {int((d > lr).sum())} differ by more than lr "
              f"(largest {d.max():.3e} = {d.max() / lr:.3f} lr), median {np.median(d):.1e}")
        jax_run(jcfg, tmp / "jax", MAX_STEPS)
        port_run(pcfg, params0, stats0, tmp / "port", MAX_STEPS)
        port_run(pcfg, params0, stats0, tmp / "port+ulp", MAX_STEPS, True)
        jax_run(jcfg, tmp / "jax+ulp", MAX_STEPS, True)
        pairs = [("jax", "port"), ("port", "port+ulp"), ("jax", "jax+ulp")]
        pairs += [("jax", f"shift{idx}") for _, idx, _ in crossed]
        for ref_run, got in pairs:
            by_step = {}
            for prefix, step, _, r in loss_misses(tmp / ref_run, tmp / got):
                key = f"{prefix} {step}"
                by_step[key] = max(by_step.get(key, 0.0), r)
            print(f"  {got} against {ref_run}: largest relative loss difference by record "
                  + ", ".join(f"{k} {v:.2e}" for k, v in by_step.items()))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--range", nargs=2, type=int)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--spc", type=int, default=1, help="steps_per_call")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    seeds = list(args.seeds) + (list(range(*args.range)) if args.range else [])
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)  # as tests/conftest.py
    torch.set_num_threads(1)
    plog._tensorboard_writer = lambda logdir: None
    jtrain._log_eval_media = ptrain._log_eval_media = lambda *a, **k: None
    for seed in seeds:
        if args.trace:
            trace(seed, args.lr, args.spc)
            continue
        res = compare(seed, args.lr, args.spc)
        print(f"PYTHONHASHSEED={seed} {'ok  ' if res['ok'] else 'MISS'} loss rel "
              f"{res['rel']:.3e} (limit 1e-3; {res['where']}); params max "
              f"{res['max']:.3e} (limit {2.1 * args.lr * MAX_STEPS:.3e}) median "
              f"{res['median']:.3e} (limit {args.lr / 20:.1e})", flush=True)


if __name__ == "__main__":
    main()
