"""Kernels B1, B2 and B5 past n_fft 2048 and past 16 overlapping frames a
side, held on the CPU to the JAX package's Pallas kernels in interpret
mode, and the `Synthesizer` at 48 kHz against the JAX package's.

The wide configuration of B2 and B5 (`csrc/gl_wide.cuh`) and B1's direct
configuration take these geometries on the card since they lost their
lane caps, B2's and B5's D reaching the reference kernels' 128 and B1's
its 256; `chip_smoke.py` holds the kernels to these plain versions there.
Here: the plain B2 with its edge repair (`fused_reproject_analyze`)
against `sstts.dsp.gl_fused.fused_reproject_analyze`, the plain B5 with
its edge repair (`fused_gl_iteration`) against `fused_gl_iteration`, each
in bf16 and f32, and B1's plain version (`reproject_frames`) against
`reproject_frames_pallas` (and its XLA formulation: the Pallas path's
windowed mirror runs are wrong at D = 17 and 32 in head rows whose run
takes its source beyond the window, as at T = 5 in
tests/test_torch_reproject.py), in bf16 and f32.

Geometries (n_fft, hop, window): 48 kHz at 50 / 12.5 ms (4096, 600, 2400:
w_len 2399 in wp 2432, D = 3), 44.1 kHz at n_fft 4096 and 50 / 12.5 ms
(4096, 551, 2205: w_len 2204 in wp 2304, D = 3), and 22.05 kHz at hops of
2.86 and 1.55 ms (2048, 63, 1102 and 2048, 34, 1102: D = 17 and 32).  Each
runs 24 frames, 48 at D = 32 (the reference's halo comes from one
neighbouring block, so it needs d_max <= its block: `_pick_block` gives 24
at T = 24 and 48 at 48), with head and tail mirror runs the edge repair
rebuilds, over 128 bins (2 hp = 256 lanes; the geometry is in the frames'
lanes, not in the bins, as in tests/test_torch_gl_geometry.py).

Tolerances, those of tests/test_torch_gl_geometry.py (B2, B5) and
tests/test_torch_reproject.py (B1).  B2, B5 bf16: 1e-2 absolute, and under
0.1% of the elements may differ at all (both round the reprojected frames
and the outputs to bf16 at the same points); f32: 1e-5 relative L2 and
2e-4 absolute at |q| <= 1 (other summation orders of the f32 products,
divided by a near-zero |s| in the renorm now and then).  B5's GEMM1 runs on
small dyadic operands, exact in any summation order.  B1: exact in f32
(the same terms in the same order), one bf16 step (2^-8 of the largest
value) on under 1% of the elements in bf16.

The Synthesizer at 48 kHz (the tiny model with the reference's 50 / 12.5 ms
window at n_fft 4096): built without raising on the CPU, and its choice on
the card (asked of the pure rule, no card needed) is "semi" on the wide
configuration; one short batch against the JAX Synthesizer on the same
converted weights, under tests/test_torch_synthesize.py's tolerances: 1e-4
on the spectrograms, 1e-5 on the waveform in the f32 loop ("dft_highest"),
5% relative L2 in the default bf16 loop (the JAX package on the CPU runs
"split", the port "semi").

The reference runs under `jax.jit`: one compile a call.  Torch runs on one
thread in this module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_variables, t, tiny_pair

from sstts.dsp.gl_fused import fused_gl_iteration as jax_fused_gl_iteration
from sstts.dsp.gl_fused import fused_reproject_analyze as jax_fra
from sstts.dsp.reproject import reproject as jax_reproject
from sstts.dsp.reproject import reproject_frames_pallas
from sstts.synthesize import Synthesizer as JaxSynthesizer
from sstts_torch.convert import convert_params
from sstts_torch.dsp import gl_tiles
from sstts_torch.dsp.gl_fused import (
    fused_gl_iteration, fused_reproject_analyze, gl_iteration, reproject_analyze,
)
from sstts_torch.dsp.griffin_lim import kernel_config, resolve_iter_impl
from sstts_torch.dsp.reproject import MAX_D, band_plan, reproject_frames
from sstts_torch.synthesize import Synthesizer, check_supported

#: (case, n_fft, hop, window, frames) past n_fft 2048 and D = 16.
GEOMETRIES = [
    ("48kHz", 4096, 600, 2400, 24),
    ("44kHz4096", 4096, 551, 2205, 24),
    ("hop2.86ms", 2048, 63, 1102, 24),
    ("hop1.55ms", 2048, 34, 1102, 48),
]
#: (w_len, D) of each, as the rule reckons them.
PLANS = {"48kHz": (2399, 3), "44kHz4096": (2204, 3), "hop2.86ms": (1101, 17),
         "hop1.55ms": (1101, 32)}
L = 256
IDS = [g[0] for g in GEOMETRIES]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(name, n_fft, hop, win, n_frames, seed):
    length = (n_frames - 1) * hop
    plan = band_plan(n_fft, hop, win, n_frames, length)
    assert (plan["w_len"], plan["d_max"]) == PLANS[name]
    assert plan["runs"], "the geometry must exercise the mirror runs"
    wp = -(-plan["w_len"] // 128) * 128
    rng = np.random.default_rng(seed)
    x = {
        "frames": rng.normal(size=(2, n_frames, wp)).astype(np.float32),
        "mag2": rng.uniform(0.1, 1.0, size=(2, n_frames, L)).astype(np.float32),
        "w_fwd": (rng.normal(size=(wp, L)) / 20).astype(np.float32),
    }
    # GEMM1 operands whose f32 products and sums are exact: multiples of
    # 2^-3 and 2^-10 (bf16 values), sums of 256 products below 2^16 ulps.
    x["q_exact"] = rng.integers(-8, 9, size=(2, n_frames, L)).astype(np.float32) / 8
    x["w_inv_exact"] = rng.integers(-32, 33, size=(L, wp)).astype(np.float32) / 1024
    x["frames"][..., plan["w_len"]:] = 0.0  # GEMM1's zero lanes
    x["w_inv_exact"][:, plan["w_len"]:] = 0.0  # the loop's zero-padded synthesis columns
    return x, (n_fft, hop, win, length), plan


def _hold(got, ref, dtype):
    g, r = got.float().numpy(), np.asarray(ref, np.float32)
    assert np.isfinite(g).all()
    if dtype == "float32":
        assert np.linalg.norm(g - r) <= 1e-5 * np.linalg.norm(r)
        np.testing.assert_allclose(g, r, atol=2e-4)
    else:
        np.testing.assert_allclose(g, r, atol=1e-2)
        assert (g != r).mean() < 1e-3


def _precision(dtype):
    return jax.lax.Precision.HIGHEST if dtype == "float32" else jax.lax.Precision.DEFAULT


def test_the_rule_takes_every_geometry_here_and_refuses_past_the_envelope():
    """B2 and B5 take each geometry on the card in both loop dtypes (the
    wide configuration: no lane cap, D <= 128), B1 likewise (D <= 256);
    past the reference kernels' bounds the rules raise by name."""
    for _, n_fft, hop, win, _ in GEOMETRIES:
        for fft_impl in ("dft_default", "dft_high"):
            for impl in ("semi", "fused"):
                assert kernel_config(impl, n_fft, hop, win, fft_impl, "cuda") == "wide"
    d = band_plan(2048, 8, 1102, 70, 69 * 8)["d_max"]
    assert gl_tiles.WIDE_MAX_D < d <= MAX_D  # 137: past B2 and B5, inside B1
    with pytest.raises(NotImplementedError, match="at most 128 overlapping"):
        kernel_config("semi", 2048, 8, 1102, "dft_default", "cuda")
    with pytest.raises(NotImplementedError, match="at most 128 overlapping"):
        kernel_config("fused", 2048, 8, 1102, "dft_high", "cuda")


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_semi_matches_pallas_past_n_fft_2048_and_d_16(geom):
    """Plain B2 + edge repair against the Pallas kernel, bf16 and f32."""
    x, g, _ = _inputs(*geom, 31)
    for dtype in ("float32", "bfloat16"):
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        ref = jax.jit(lambda f, m, w: jax_fra(
            f, m, w, *g, precision=_precision(dtype), interpret=True,
        ))(jnp.asarray(x["frames"], jd), jnp.asarray(x["mag2"], jd), jnp.asarray(x["w_fwd"], jd))
        before = reproject_analyze.launches
        got = fused_reproject_analyze(
            t(x["frames"]).to(td), t(x["mag2"]).to(td), t(x["w_fwd"]).to(td), *g
        )
        assert reproject_analyze.launches == before  # CPU: the plain version
        assert got.dtype == td and got.shape == x["mag2"].shape
        _hold(got, ref, dtype)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_fused_matches_pallas_past_n_fft_2048_and_d_16(geom):
    """Plain B5 + edge repair against the Pallas kernel, bf16 and f32
    (GEMM1 on exact operands)."""
    x, g, _ = _inputs(*geom, 37)
    q, w_inv = x["q_exact"], x["w_inv_exact"]
    for dtype in ("float32", "bfloat16"):
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        ref = jax.jit(lambda a, m, wi, wf: jax_fused_gl_iteration(
            a, m, wi, wf, *g, _precision(dtype), interpret=True,
        ))(jnp.asarray(q, jd), jnp.asarray(x["mag2"], jd), jnp.asarray(w_inv, jd),
           jnp.asarray(x["w_fwd"], jd))
        before = gl_iteration.launches
        got = fused_gl_iteration(
            t(q).to(td), t(x["mag2"]).to(td), t(w_inv).to(td), t(x["w_fwd"]).to(td), *g,
        )
        assert gl_iteration.launches == before
        assert got.dtype == td and got.shape == q.shape
        _hold(got, ref, dtype)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_reproject_matches_pallas_past_n_fft_2048_and_d_16(geom):
    """B1's plain version against the Pallas kernel (exact in f32, one bf16
    step in bf16) on the rows the reference's windowed mirror-run fault
    leaves alone, and against the XLA formulation everywhere (1e-6 of the
    largest value in f32; one bf16 step on under 1% in bf16), at the
    128-lane width the loop gives it."""
    x, g, plan = _inputs(*geom, 41)
    frames = x["frames"]
    for dtype in ("float32", "bfloat16"):
        jd, td = getattr(jnp, dtype), getattr(torch, dtype)
        before = reproject_frames.launches
        got = reproject_frames(t(frames).to(td), *g)
        assert reproject_frames.launches == before
        assert got.dtype == td and got.shape == frames.shape
        assert not got[..., plan["w_len"]:].any()
        got = got.float().numpy()
        pallas = np.asarray(jax.jit(lambda f: reproject_frames_pallas(f, *g, interpret=True))(
            jnp.asarray(frames, jd)), np.float32)
        xla = np.asarray(jax.jit(lambda f: jax_reproject(f, *g, impl="xla"))(
            jnp.asarray(frames, jd)), np.float32)
        scale = np.abs(pallas).max()
        # The reference's Pallas path applies its mirror runs in a window of
        # head rows, and at D = 17 and 32 a run there takes its source from
        # beyond the window (the fault tests/test_torch_reproject.py steps
        # around at T = 5): those rows differ from its own XLA formulation.
        # The port applies the runs in order on the whole array, as the XLA
        # formulation does; it is held to that everywhere, to the Pallas
        # kernel on the rows the fault leaves alone.
        fault = np.unique(np.argwhere(np.abs(pallas - xla) > 1e-3 * scale)[:, 1])
        assert set(fault.tolist()) <= {r[0] for r in plan["runs"]}
        ok = np.setdiff1d(np.arange(frames.shape[1]), fault)
        if dtype == "float32":
            np.testing.assert_allclose(got[:, ok], pallas[:, ok], atol=0.0)
            np.testing.assert_allclose(got, xla, atol=1e-6 * scale)
        else:
            np.testing.assert_allclose(got[:, ok], pallas[:, ok], atol=2.0**-8 * scale)
            np.testing.assert_allclose(got, xla, atol=2.0**-8 * scale)
            assert (got != xla).mean() < 1e-2


def _pair_48k(fft_impl):
    jcfg, tcfg = tiny_pair(
        dataset={"sample_rate": 48000, "n_fft": 4096, "mel_fmax": 24000.0},
        arch={"prenet_dropout_at_inference": False},
        inference={"max_decoder_steps": 6, "griffin_lim_iters": 3, "min_decoder_steps": 2,
                   "griffin_lim_fft_impl": fft_impl},
    )
    ds = tcfg.dataset
    assert (ds.win_len, ds.hop_len, ds.n_fft) == (2400, 600, 4096)
    return jcfg, tcfg


@pytest.mark.parametrize("fft_impl", ["dft_default", "dft_highest"])
def test_synthesizer_at_48khz_matches_jax(fft_impl):
    """The Synthesizer at 48 kHz: built on the CPU without raising; on the
    card "auto" is "semi" on the wide configuration (the rule asked without
    a card); one short batch against the JAX Synthesizer."""
    jcfg, tcfg = _pair_48k(fft_impl)
    assert resolve_iter_impl(None, 0.0, fft_impl, "cuda") == "semi"
    assert check_supported(tcfg, torch.device("cuda")) in ("fused", "xla")
    ds = tcfg.dataset
    assert kernel_config("semi", ds.n_fft, ds.hop_len, ds.win_len, fft_impl, "cuda") == "wide"
    v = jax_variables(jcfg, seed=4)
    jax_synth = JaxSynthesizer(jcfg, v["params"], v["batch_stats"])
    port = Synthesizer(tcfg, convert_params(v["params"], v["batch_stats"], tcfg), device="cpu")
    texts = ["hello world", "a much longer sentence"]
    _, jfull = jax_synth.synthesize_batch(texts, full_output=True)
    _, tfull = port.synthesize_batch(texts, full_output=True)
    np.testing.assert_array_equal(tfull["n_samples"], np.asarray(jfull["n_samples"]))
    for key in ("mel", "linear"):
        np.testing.assert_allclose(tfull[key], np.asarray(jfull[key]), atol=1e-4, err_msg=key)
    assert tfull["linear"].shape[-1] == 2049
    ref, got = np.asarray(jfull["wav"]), tfull["wav"]
    assert np.isfinite(got).all() and got.shape == ref.shape
    if fft_impl == "dft_highest":
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-2
