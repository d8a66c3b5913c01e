"""Kernel B1's plain version (`reproject_frames_plain`, which the wrapper
runs on the CPU) held to the JAX package's Pallas kernel in interpret mode
and to its XLA formulation.

Geometry: n_fft 512, hop 100, window 400 (the tiny config's 8 kHz STFT):
w_len 399, 128-lane width 512, D = 3.  T = 20 has mirror runs at both
edges; T = 5 is short enough that the head and tail runs overlap.

At T = 5 the Pallas path's windowed mirror runs
(`sstts/dsp/reproject.py:_mirror_runs_windowed`, 160-190) are wrong in the
JAX package: a run in the 2-row head window takes its source from rows 2
and 3, outside that window, and JAX clamps the index.  The port applies the
runs in order on the whole array, as the XLA formulation does (which the
JAX package's own tests hold to istft -> stft); there it is held to the XLA
formulation everywhere and to the Pallas kernel on the rows the fault
leaves alone (ROADMAP C).

Tolerances: the plain version sums the same f32 terms as the Pallas kernel
in the same order (d = 0 first), so against it f32 is exact (measured
equal in f32 and bf16); the XLA formulation sums d = -D..D in order, a
different f32 rounding: measured 4.8e-7 at a largest value of ~4.5, held
to 1e-6 of the largest value.  In bf16 all round once at the end: a sum
that differs in its last f32 bit can round to the neighbouring bf16 value,
one bf16 step (2^-8 of the largest value), and under 1% of the elements
may differ (measured equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t

from sstts.dsp.reproject import reproject as jax_reproject
from sstts.dsp.reproject import reproject_frames_pallas
from sstts_torch.dsp.reproject import band_plan, reproject, reproject_frames

N_FFT, HOP, WIN = 512, 100, 400


def _frames(n_frames, width, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, n_frames, width)).astype(np.float32)


def _check(got, ref, dtype, exact):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=0.0 if exact else 1e-6 * scale)
    else:
        np.testing.assert_allclose(got, ref, atol=2.0**-8 * scale)
        assert (got != ref).mean() < 1e-2


def test_pallas_mirror_runs_fault_at_five_frames():
    """The reference fault the T = 5 case steps around: JAX's Pallas path
    differs from its own XLA formulation in rows 0-1 only, and the port
    agrees with the XLA formulation."""
    n_frames, length = 5, 400
    x = _frames(n_frames, 399, seed=5)
    geom = (N_FFT, HOP, WIN, length)
    pallas = np.asarray(reproject_frames_pallas(jnp.asarray(x), *geom, interpret=True))
    xla = np.asarray(jax_reproject(jnp.asarray(x), *geom, impl="xla"))
    bad_rows = np.unique(np.argwhere(np.abs(pallas - xla) > 1e-5)[:, 1])
    assert bad_rows.tolist() == [0, 1]
    got = reproject_frames(t(x), *geom).numpy()
    np.testing.assert_allclose(got, xla, atol=1e-6 * np.abs(xla).max())


@pytest.mark.parametrize("padded", [False, True], ids=["w_len", "lanes128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_frames", [20, 5])
def test_reproject_plain_matches_pallas_and_xla(n_frames, dtype, padded):
    length = (n_frames - 1) * HOP
    plan = band_plan(N_FFT, HOP, WIN, n_frames, length)
    assert plan["runs"], "geometry must exercise the mirror runs"
    width = 512 if padded else plan["w_len"]
    x = _frames(n_frames, width, seed=n_frames)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    before = reproject_frames.launches
    got = reproject_frames(t(x).to(td), N_FFT, HOP, WIN, length)
    assert reproject_frames.launches == before  # CPU: the plain version
    assert got.dtype == td and got.shape == x.shape
    if padded:
        assert not got[..., plan["w_len"]:].any()
    geom = (N_FFT, HOP, WIN, length)
    pallas = np.asarray(
        reproject_frames_pallas(jnp.asarray(x, jd), *geom, interpret=True), np.float32
    )
    rows = slice(2, None) if n_frames == 5 else slice(None)  # see the docstring
    _check(got[:, rows], pallas[:, rows], dtype, exact=True)
    xla = jax_reproject(jnp.asarray(x, jd), *geom, impl="xla")
    _check(got, xla, dtype, exact=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reproject_xla_impl_on_padded_layout(dtype):
    """`reproject(impl="xla")`, the no-kernel path of "split_xla", on the
    128-lane layout against JAX's: padding lanes come back exactly zero."""
    n_frames = 20
    length = (n_frames - 1) * HOP
    x = _frames(n_frames, 512, seed=3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = reproject(t(x).to(td), N_FFT, HOP, WIN, length, impl="xla")
    ref = jax_reproject(jnp.asarray(x, jd), N_FFT, HOP, WIN, length, impl="xla")
    assert not got[..., 399:].any()
    _check(got, ref, dtype, exact=False)


def test_reproject_refuses_unknown_impl_and_width():
    x = torch.zeros(1, 20, 512)
    with pytest.raises(ValueError, match="impl"):
        reproject(x, N_FFT, HOP, WIN, 1900, impl="pallas")
    with pytest.raises(ValueError, match="width"):
        reproject(torch.zeros(1, 20, 400), N_FFT, HOP, WIN, 1900)
