"""Kernels B2 and B5 at the geometries their wide configuration takes on the
card, held on the CPU to the JAX package's Pallas kernels in interpret mode:
the plain B2 with its edge repair (`fused_reproject_analyze`) against
`sstts.dsp.gl_fused.fused_reproject_analyze`, the plain B5 with its edge
repair (`fused_gl_iteration`) against `fused_gl_iteration`, each in bf16
and f32.

The reference runs under `jax.jit`: one compile a call (~1 s) instead of
one per op.

Geometries (n_fft, hop, window): 24 kHz at 50 / 12.5 ms (w_len 1199, D =
3), 22.05 kHz at hops of 10, 5 and 3 ms (D = 5, 10, 16) and 44.1 kHz at
n_fft 2048 with a 2048-sample window and a 512-sample hop (w_len 2047,
D = 3).  Each runs 24 frames, whose head and tail mirror runs the edge
repair rebuilds (at D = 16 the two slabs meet, so every row is rebuilt),
over 128 bins (2 hp = 256 lanes; the geometry is in the frames' lanes, not
in the bins).

Tolerances.  bf16, those of tests/test_torch_gl.py and
test_torch_gl_fused.py: 1e-2 absolute, and under 0.1% of the elements may
differ at all (both round the reprojected frames and the outputs to bf16
at the same points).  f32: 1e-5 relative L2 (the limit `chip_smoke.py`
holds the f32 kernels to) and 2e-4 absolute at |q| <= 1.  Both take the
products in f32 in other summation orders, and at 1101-2047 lanes of K
that noise, divided by a near-zero |s| in the renorm, reaches single
outputs: over this module's inputs at seeds 31, 37 and 41 the largest
difference per case read 4.8e-6 to 1.04e-4 (the second largest at most
3.4e-5) while the relative L2 error stayed at 5.2e-7 to 2.4e-6; the 2e-5
absolute of the 399-lane tests held in 21 of those 30 cases.
`PYTHONPATH=. python tests/test_torch_gl_geometry.py` prints the readings.

B5's inputs to GEMM1 (q and w_inv) are small dyadic values, so that
GEMM1's f32 frames are exact in any summation order and GEMM2's order is
the only difference left, as in B2's test, whose frames are the input.
With Gaussian ones the two packages' GEMM1 sums differ in the last f32
bits.  In bf16 the reprojected frames' rounding turns that now and then
into a flipped bf16 frame value, which moves its whole output row a
little, a bf16 step for a few of the row's outputs: over the 15 cases of
the readings above, 0 to 1.8% of the outputs differed (by at most 3.9e-3,
one bf16 step), more than 0.1% in 7 of them.  That is summation order,
not a fault of either package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t

from sstts.dsp.gl_fused import fused_gl_iteration as jax_fused_gl_iteration
from sstts.dsp.gl_fused import fused_reproject_analyze as jax_fra
from sstts_torch.dsp.gl_fused import (
    fused_gl_iteration, fused_reproject_analyze, gl_iteration, reproject_analyze,
)
from sstts_torch.dsp.reproject import band_plan

#: (case, n_fft, hop, window) of the wide configuration's geometries.
GEOMETRIES = [
    ("24kHz", 2048, 300, 1200),
    ("hop10ms", 2048, 220, 1102),
    ("hop5ms", 2048, 110, 1102),
    ("hop3ms", 2048, 66, 1102),
    ("44kHz", 2048, 512, 2048),
]
T = 24
L = 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n_fft, hop, win, seed):
    length = (T - 1) * hop
    plan = band_plan(n_fft, hop, win, T, length)
    assert plan["runs"], "the geometry must exercise the mirror runs"
    wp = -(-plan["w_len"] // 128) * 128
    rng = np.random.default_rng(seed)
    x = {
        "frames": rng.normal(size=(2, T, wp)).astype(np.float32),
        "mag2": rng.uniform(0.1, 1.0, size=(2, T, L)).astype(np.float32),
        "w_fwd": (rng.normal(size=(wp, L)) / 20).astype(np.float32),
    }
    # GEMM1 operands whose f32 products and sums are exact: multiples of
    # 2^-3 and 2^-10 (bf16 values), sums of 256 products below 2^16 ulps.
    x["q_exact"] = rng.integers(-8, 9, size=(2, T, L)).astype(np.float32) / 8
    x["w_inv_exact"] = rng.integers(-32, 33, size=(L, wp)).astype(np.float32) / 1024
    x["frames"][..., plan["w_len"]:] = 0.0  # GEMM1's zero lanes
    x["w_inv_exact"][:, plan["w_len"]:] = 0.0  # the loop's zero-padded synthesis columns
    return x, (n_fft, hop, win, length)


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


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_semi_matches_pallas_at_wide_geometries(geom):
    """Plain B2 + edge repair against the Pallas kernel, bf16 and f32."""
    _, n_fft, hop, win = geom
    x, g = _inputs(n_fft, hop, win, 31)
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


@pytest.mark.parametrize("geom", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_fused_matches_pallas_at_wide_geometries(geom):
    """Plain B5 + edge repair against the Pallas kernel, bf16 and f32
    (GEMM1 on exact operands, see the module docstring)."""
    _, n_fft, hop, win = geom
    x, g = _inputs(n_fft, hop, win, 37)
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


def _measure(seeds=(31, 37, 41)):
    """The readings the module docstring quotes: per case and seed, the f32
    outputs' largest and second-largest difference and relative L2 error
    (B2 on Gaussian frames, B5 on the exact GEMM1 operands), and the share
    of bf16 outputs that differ with Gaussian GEMM1 operands for B5."""
    torch.set_num_threads(1)
    hi, lo = jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT
    for name, n_fft, hop, win in GEOMETRIES:
        for seed in seeds:
            x, g = _inputs(n_fft, hop, win, seed)
            rng = np.random.default_rng(seed + 1000)
            q = rng.normal(size=(2, T, L)).astype(np.float32)
            w_inv = (rng.normal(size=x["w_inv_exact"].shape) / 20).astype(np.float32)
            w_inv[:, band_plan(n_fft, hop, win, T, g[3])["w_len"]:] = 0.0
            runs = {
                "B2 f32": (jax_fra(*(jnp.asarray(x[k]) for k in ("frames", "mag2", "w_fwd")),
                                   *g, precision=hi, interpret=True),
                           fused_reproject_analyze(*(t(x[k]) for k in ("frames", "mag2", "w_fwd")),
                                                   *g)),
                "B5 f32": (jax_fused_gl_iteration(
                               *(jnp.asarray(a) for a in (x["q_exact"], x["mag2"],
                                                          x["w_inv_exact"], x["w_fwd"])),
                               *g, hi, interpret=True),
                           fused_gl_iteration(*(t(a) for a in (x["q_exact"], x["mag2"],
                                                               x["w_inv_exact"], x["w_fwd"])),
                                              *g)),
            }
            bf = torch.bfloat16
            ref = jax_fused_gl_iteration(
                *(jnp.asarray(a, jnp.bfloat16) for a in (q, x["mag2"], w_inv, x["w_fwd"])),
                *g, lo, interpret=True)
            got = fused_gl_iteration(*(t(a).to(bf) for a in (q, x["mag2"], w_inv, x["w_fwd"])),
                                     *g)
            line = [f"{name} seed {seed}:"]
            for case, (r, p) in runs.items():
                r, p = np.asarray(r, np.float32), p.numpy()
                d = np.sort(np.abs(p - r).ravel())
                rel = np.linalg.norm(p - r) / np.linalg.norm(r)
                line.append(f"{case} max {d[-1]:.2e} 2nd {d[-2]:.2e} rel {rel:.2e};")
            g32, r32 = got.float().numpy(), np.asarray(ref, np.float32)
            line.append(f"B5 bf16 Gaussian GEMM1 differing {(g32 != r32).mean():.2e} "
                        f"max {np.abs(g32 - r32).max():.2e}")
            print(" ".join(line), flush=True)


if __name__ == "__main__":  # PYTHONPATH=. python tests/test_torch_gl_geometry.py
    _measure()
