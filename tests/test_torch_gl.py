"""Griffin-Lim in the port, held to JAX: the host plan, the windowed DFT
matrices, kernel B2's plain version (against the Pallas kernel in interpret
mode), the whole loop and de-emphasis.

Geometry: n_fft 512, hop 100, window 400 (the tiny config's 8 kHz STFT)
over 20 frames, so the reflect-pad mirror runs at both edges are exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t

from sstts.dsp import fft as jax_fft
from sstts.dsp.gl_fused import fused_reproject_analyze as jax_fra
from sstts.dsp.griffin_lim import griffin_lim as jax_griffin_lim
from sstts.dsp.ops import deemphasis as jax_deemphasis
from sstts.dsp.reproject import _band_plan as jax_band_plan
from sstts.dsp.stft import _window as jax_window
from sstts_torch.dsp import fft as port_fft
from sstts_torch.dsp import stft as port_stft
from sstts_torch.dsp.gl_fused import fused_reproject_analyze
from sstts_torch.dsp.griffin_lim import griffin_lim
from sstts_torch.dsp.ops import deemphasis
from sstts_torch.dsp.reproject import band_plan

N_FFT, HOP, WIN, T = 512, 100, 400, 20
LENGTH = (T - 1) * HOP


@pytest.mark.parametrize(
    "geom",
    [(N_FFT, HOP, WIN, T, LENGTH), (2048, 275, 1102, 800, 799 * 275)],
    ids=["tiny", "default"],
)
def test_band_plan_matches_jax(geom):
    """The copied host plan is the JAX plan (at the main path's geometry:
    lo 474, w_len 1101, d_max 4 and 9 mirror runs)."""
    got, ref = band_plan(*geom), jax_band_plan(*geom)
    for key in ("lo", "w_len", "start", "d_max", "runs"):
        assert got[key] == ref[key], key
    np.testing.assert_array_equal(got["wss2d"], ref["wss2d"])
    if geom[0] == 2048:
        assert (got["lo"], got["w_len"], got["d_max"], len(got["runs"])) == (
            474, 1101, 4, 9,
        )


@pytest.mark.parametrize("n_fft,win", [(N_FFT, WIN), (2048, 1102)])
def test_windowed_dft_matrices_match_jax(n_fft, win):
    """f32 cos/sin of the same integer phase (t*k mod n): within 1e-6."""
    window = port_stft.window(n_fft, win)
    np.testing.assert_array_equal(window, jax_window(n_fft, win))
    got = port_fft.rdft_matrices_windowed(n_fft, window)
    ref = jax_fft._rdft_matrices_windowed(n_fft, jax_window(n_fft, win))
    assert got[:2] == ref[:2]
    for g, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("momentum", [0.0, 0.99], ids=["classic", "momentum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_reproject_analyze_matches_pallas(dtype, momentum):
    """Plain B2 (+ edge repair) vs the Pallas kernel in interpret mode.

    f32: 2e-5 (sum order over a 512-deep product).  bf16: both round the
    reprojected frames and the outputs to bf16 at the same points, so only
    f32 summation order differs; that flips an output's last bf16 bit
    rarely (2^-8 relative at |q| <= 1): 1e-2 absolute, and under 0.1% of
    the elements may differ at all.
    """
    rng = np.random.default_rng(7)
    plan = band_plan(N_FFT, HOP, WIN, T, LENGTH)
    assert plan["runs"], "geometry must exercise the mirror runs"
    wp, L = 512, (512 if dtype == "bfloat16" else 768)
    frames = rng.normal(size=(2, T, wp)).astype(np.float32)
    frames[..., plan["w_len"]:] = 0.0  # GEMM1's zero lanes
    mag2 = rng.uniform(0.1, 1.0, size=(2, T, L)).astype(np.float32)
    w_fwd = (rng.normal(size=(wp, L)) / 20).astype(np.float32)
    prev = rng.normal(size=(2, T, L)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jkw = {"prev": jnp.asarray(prev, jd), "momentum": momentum} if momentum else {}
    tkw = {"prev": t(prev).to(td), "momentum": momentum} if momentum else {}
    ref = jax_fra(
        jnp.asarray(frames, jd), jnp.asarray(mag2, jd), jnp.asarray(w_fwd, jd),
        N_FFT, HOP, WIN, LENGTH, precision=jax.lax.Precision.HIGHEST,
        interpret=True, **jkw,
    )
    got = fused_reproject_analyze(
        t(frames).to(td), t(mag2).to(td), t(w_fwd).to(td), N_FFT, HOP, WIN,
        LENGTH, **tkw,
    )
    pairs = zip(got, ref) if momentum else [(got, ref)]
    for g, r in pairs:
        g, r = g.float().numpy(), np.asarray(r, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=2e-5)
        else:
            np.testing.assert_allclose(g, r, atol=1e-2)
            assert (g != r).mean() < 1e-3


@pytest.fixture(scope="module")
def magnitude():
    return np.random.default_rng(3).uniform(0.0, 2.0, size=(2, T, 257)).astype(np.float32)


@pytest.mark.parametrize("momentum", [0.0, 0.99], ids=["classic", "momentum"])
def test_griffin_lim_f32_matches_jax_tightly(magnitude, momentum):
    """dft_highest: the f32 loop against JAX's f32 loop, 4 iterations.
    Measured ~1e-6 absolute at amplitude ~0.33; held to 1e-5."""
    ref = jax_griffin_lim(
        jnp.asarray(magnitude), N_FFT, HOP, WIN, 4, LENGTH, momentum=momentum,
        fft_impl="dft_highest",
    )
    got = griffin_lim(
        t(magnitude), N_FFT, HOP, WIN, 4, LENGTH, momentum=momentum,
        fft_impl="dft_highest",
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.99], ids=["classic", "momentum"])
def test_griffin_lim_bf16_matches_jax_loosely(magnitude, momentum):
    """dft_default (bf16 loop): JAX on the CPU runs the "split" iteration,
    which rounds the spectrum to bf16 before the renorm; the port runs the
    "semi" iteration, which renorms from f32 (as JAX does on its TPU).
    Those extra roundings make a phase difference of bf16 size per
    iteration: measured 0.8% (classic) and 1.5% (momentum) relative L2
    after 4 iterations; held to 5%."""
    ref = np.asarray(
        jax_griffin_lim(
            jnp.asarray(magnitude), N_FFT, HOP, WIN, 4, LENGTH,
            momentum=momentum, fft_impl="dft_default",
        )
    )
    got = griffin_lim(
        t(magnitude), N_FFT, HOP, WIN, 4, LENGTH, momentum=momentum,
        fft_impl="dft_default",
    ).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-2


def test_deemphasis_matches_jax():
    """Block Toeplitz + block-carry recurrence in f32 vs JAX's Toeplitz +
    associative scan: relative 1e-5 of the output's range (the IIR gain is
    up to 1/(1-0.97) = 33)."""
    y = np.random.default_rng(4).normal(size=(2, 3001)).astype(np.float32)
    ref = np.asarray(jax_deemphasis(jnp.asarray(y), 0.97))
    got = deemphasis(t(y), 0.97).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
