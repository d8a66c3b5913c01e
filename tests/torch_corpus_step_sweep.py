"""The cached-step parity case over Python's string hash, in one process.

    PYTHONPATH=.:tests python tests/torch_corpus_step_sweep.py 0 1 2 ... [--range A B]
        [--formats pcm16 features features_bf16] [--trace]

`tests/test_torch_train_corpus.py::test_cached_step_matches_jax` builds both
packages' device corpora from synthetic utterances whose audio noise is
seeded from Python's per-process string hash of the utterance ids, and
holds one cached train step of the port to JAX's (rtol 1e-4 on every
metric).  For each PYTHONHASHSEED given, this script computes those hashes
in a child process, gives them to both packages' synthetic corpora and runs
the test's comparison (`_cached_steps`) for each corpus format, printing
each metric's relative difference, grad_norm's both as the test compared it
before (the port's step as it is) and as it compares it now (the values
that lie on the other side of a kink from JAX's, within the two packages'
f32 rounding, put on JAX's side: outputs at their L1 targets, ReLU inputs
at 0), and how many values that moved.  In "features_bf16" the mel values
the two packages round apart are taken as JAX rounded them, as the test
does, in both columns.  The JAX step's compile is kept across seeds, so a
seed and format cost a few seconds after the first.

`--trace` follows a seed's difference to its first differing value: each
ReLU input of the model on opposite sides of 0 in the two packages, how
far the two packages' linear and mel outputs and their targets lie apart,
each output on opposite sides of its L1 target (its L1 gradient flips sign
there) with both values and both targets, and grad_norm before and after
the move.  Not a test; it imports both
packages, as the tests do.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from functools import lru_cache

import jax
import numpy as np
import torch
import torch.nn.functional as F

import sstts.data.synthetic as jsyn
import sstts_torch.data.synthetic as psyn
from sstts import train as jtrain
from sstts_torch import train as ptrain

import test_torch_train_corpus as case

UIDS = tuple(f"SYN-{i:05d}" for i in range(8))


def use_seed(seed: int) -> None:
    """Both synthetic corpora's noise as under PYTHONHASHSEED=seed."""
    out = subprocess.run(
        [sys.executable, "-c", f"print(*(hash(u) for u in {UIDS!r}))"],
        env=dict(os.environ, PYTHONHASHSEED=str(seed)), capture_output=True, text=True,
        check=True,
    ).stdout.split()
    h = dict(zip(UIDS, map(int, out)))
    jsyn.hash = psyn.hash = lambda uid: h[uid]


def compare(fmt: str) -> dict:
    """Each metric's relative difference in the test's comparison; grad_norm
    also with the near-kink outputs on JAX's side, and how many moved."""
    ref, got, on_side, moved = case._cached_steps(fmt)
    rel = {k: abs(float(got[k]) - float(ref[k])) / abs(float(ref[k])) for k in ref}
    g = float(ref["grad_norm"])
    rel["grad_norm_on_side"] = abs(float(on_side["grad_norm"]) - g) / g
    rel["moved"] = moved
    return rel


def trace(fmt: str) -> None:
    """The step's outputs on opposite sides of their L1 targets in the two
    packages, with both packages' outputs and targets, and grad_norm before
    and after the port's are put on JAX's side."""
    jcfg, pcfg = case._pair(device_corpus_format=fmt)
    utts = case._utts(pcfg)
    (jcorpus, counts), _ = jtrain.build_device_corpus(jcfg, utts)
    corpus, _ = case._port_corpus(pcfg, utts)
    bucket = max(counts)
    idx = np.array([counts[bucket] - 1, 0], np.int32)
    valid = np.array([1.0, 0.0], np.float32)
    jstate = jtrain.create_state(jcfg)
    variables = (jax.tree.map(np.asarray, jax.device_get(jstate.params)),
                 jax.tree.map(np.asarray, jax.device_get(jstate.batch_stats)))
    rows = corpus[bucket]
    if fmt == "features_bf16":
        rows = case._rounded_as_jax(rows, jcorpus[bucket])
    ref, kept, relu_inputs = case._jax_step_keeping_kinks(jcfg, jstate, jcorpus[bucket], idx,
                                                           valid)
    seen, loss_fn, relu, relus = {}, ptrain.tacotron_loss, F.relu, []

    def keep(out, mel_gt, linear_gt, *a, **k):
        seen.update({key: (out[key].detach().numpy().copy(), gt.numpy().copy())
                     for key, gt in (("linear", linear_gt), ("mel", mel_gt))})
        return loss_fn(out, mel_gt, linear_gt, *a, **k)

    def keep_relu(x, *a, **k):
        relus.append(x.detach().numpy().copy())
        return relu(x, *a, **k)

    ptrain.tacotron_loss, F.relu = keep, keep_relu
    try:
        got = ptrain.make_cached_train_step(pcfg)(case._state(pcfg, variables), rows, idx,
                                                  valid)
    finally:
        ptrain.tacotron_loss, F.relu = loss_fn, relu
    on_side, moved = case._port_step_on_jax_side(pcfg, variables, rows, idx, valid, kept,
                                                 relu_inputs)
    for i, (mine, theirs) in enumerate(zip(relus, relu_inputs)):
        flip = np.sign(mine) != np.sign(theirs)
        for j in map(tuple, np.argwhere(flip)):
            print(f"    ReLU call {i} {mine.shape} at {j}: port {mine[j]:.4e}, JAX "
                  f"{theirs[j]:.4e}  <- opposite sides of the kink")
    for key in case._RESIDUALS:
        p_out, p_gt = seen[key]
        j_out, j_res = kept[key]
        j_gt = j_out - j_res
        d_out, d_gt = np.abs(p_out - j_out), np.abs(p_gt - j_gt)
        print(f"  {key}: outputs differ by at most {d_out.max():.2e} (median "
              f"{np.median(d_out):.1e}), targets by at most {d_gt.max():.2e} at "
              f"{int((d_gt > 0).sum())} of {d_gt.size}")
        flip = np.sign(p_out - p_gt) != np.sign(j_res)
        for i in map(tuple, np.argwhere(flip)):
            print(f"    {key}{i}: port {p_out[i]:.8f} (target {p_gt[i]:.8f}), JAX "
                  f"{j_out[i]:.8f} (target {j_gt[i]:.8f})  <- opposite sides of the kink")
    g = float(ref["grad_norm"])
    print(f"  grad_norm: JAX {g:.7f} port {float(got['grad_norm']):.7f} "
          f"({abs(float(got['grad_norm']) - g) / g:.2e}); with {moved} outputs on JAX's side "
          f"{float(on_side['grad_norm']):.7f} ({abs(float(on_side['grad_norm']) - g) / g:.2e})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--range", nargs=2, type=int)
    ap.add_argument("--formats", nargs="+", default=list(case.FORMATS))
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    seeds = list(args.seeds) + (list(range(*args.range)) if args.range else [])
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)  # as tests/conftest.py
    torch.set_num_threads(1)  # as the test module's fixture
    # The test builds JAX's step unmemoized (it traces a patched loss); here
    # one build a format serves every seed.
    build = lru_cache(maxsize=None)(jtrain.make_cached_train_step.__wrapped__)
    jtrain.make_cached_train_step = type("memo", (), {"__wrapped__": staticmethod(build)})
    for seed in seeds:
        use_seed(seed)
        for fmt in args.formats:
            if args.trace:
                print(f"PYTHONHASHSEED={seed} {fmt}:")
                trace(fmt)
                continue
            rel = compare(fmt)
            before = max(v for k, v in rel.items() if k not in ("grad_norm_on_side", "moved"))
            after = max(v for k, v in rel.items() if k not in ("grad_norm", "moved"))
            print(f"PYTHONHASHSEED={seed} {fmt:13s} as before {'MISS' if before > 1e-4 else 'ok  '}"
                  f" now {'MISS' if after > 1e-4 else 'ok  '} "
                  + " ".join(f"{k} {v:.2e}" for k, v in rel.items() if k != "moved")
                  + f" moved {rel['moved']} (limit 1e-4)", flush=True)


if __name__ == "__main__":
    main()
