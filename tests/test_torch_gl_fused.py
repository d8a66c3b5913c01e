"""Kernel B5's plain version with the edge repair (`fused_gl_iteration` on
the CPU) held to the JAX package's Pallas kernel `fused_gl_iteration` in
interpret mode, which repairs its edge rows with `_patch_edges`.

Geometry: n_fft 512, hop 100, window 400 (w_len 399 in 512 lanes, D = 3)
over T = 20 frames (mirror runs at both edges) and T = 5 (the head and
tail slabs overlap, so every row is rebuilt).

Tolerances: f32 takes both products in f32 in another summation order:
measured 1.2e-5 absolute at |q| <= 1, held to 2e-5.  bf16: both keep
GEMM1's frames in f32 and round the reprojected frames and the outputs to
bf16 at the same points, so only f32 summation order differs; that flips a
bf16 value now and then: measured 1.2e-4 absolute on 1.5e-4 of the
elements (T = 20) and none (T = 5); held to 1e-2, and under 0.1% of the
elements may differ at all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t

from sstts.dsp.gl_fused import fused_gl_iteration as jax_fused_gl_iteration
from sstts_torch.dsp.gl_fused import fused_gl_iteration, gl_iteration
from sstts_torch.dsp.griffin_lim import griffin_lim
from sstts_torch.dsp.reproject import band_plan

N_FFT, HOP, WIN = 512, 100, 400


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_frames", [20, 5])
def test_fused_gl_iteration_matches_pallas(n_frames, dtype):
    length = (n_frames - 1) * HOP
    plan = band_plan(N_FFT, HOP, WIN, n_frames, length)
    assert plan["runs"]
    rng = np.random.default_rng(11 + n_frames)
    wp, L = 512, (512 if dtype == "bfloat16" else 768)
    q = rng.normal(size=(2, n_frames, L)).astype(np.float32)
    mag2 = rng.uniform(0.1, 1.0, size=(2, n_frames, L)).astype(np.float32)
    w_inv = (rng.normal(size=(L, wp)) / 20).astype(np.float32)
    w_inv[:, plan["w_len"]:] = 0.0  # the loop's zero-padded synthesis columns
    w_fwd = (rng.normal(size=(wp, L)) / 20).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    precision = (
        jax.lax.Precision.HIGHEST if dtype == "float32" else jax.lax.Precision.DEFAULT
    )
    ref = jax_fused_gl_iteration(
        jnp.asarray(q, jd), jnp.asarray(mag2, jd), jnp.asarray(w_inv, jd),
        jnp.asarray(w_fwd, jd), N_FFT, HOP, WIN, length, precision,
        interpret=True,
    )
    before = gl_iteration.launches
    got = fused_gl_iteration(
        t(q).to(td), t(mag2).to(td), t(w_inv).to(td), t(w_fwd).to(td),
        N_FFT, HOP, WIN, length,
    )
    assert gl_iteration.launches == before  # CPU: the plain version
    assert got.dtype == td and got.shape == q.shape
    g, r = got.float().numpy(), np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, r, atol=2e-5)
    else:
        np.testing.assert_allclose(g, r, atol=1e-2)
        assert (g != r).mean() < 1e-3


def test_fused_with_momentum_raises():
    """As in JAX: the fused iteration folds the renorm into the kernel and
    has no momentum variant."""
    mag = torch.ones(1, 20, 257)
    with pytest.raises(ValueError, match="momentum"):
        griffin_lim(mag, N_FFT, HOP, WIN, 2, 1900, momentum=0.5, iter_impl="fused")
