"""Every Griffin-Lim iteration and transform of the port held to the JAX
package's `griffin_lim` on the CPU, 4 iterations of a seeded random
magnitude (2 x 20 frames x 257 bins, n_fft 512, hop 100, window 400).

On the CPU both run the same iteration here: "split" (JAX: the XLA
reprojection on the window-support widths; the port: kernel B1's plain
version on the same widths), "split_xla" (both on the 128-lane layout),
"fused" (JAX: its Pallas kernel in interpret mode; the port: B5's plain
version) and the complex loop over the centred STFT ("xla"/"default").

Tolerances, measured at amplitude ~0.32:
- f32 loops ("dft_high") and the complex loop: sums in another order,
  measured up to 1.1e-6 absolute; held to 1e-5.
- the bf16 loop ("dft_default"): both round the frames and the spectrum
  to bf16 at the same points, and a sum that differs in its last f32 bit
  now and then rounds to the neighbouring bf16 value, which later
  iterations carry: measured 9.5e-4 (split), 2.3e-3 (split with
  momentum), 8.7e-4 / 1.8e-3 (split_xla) and 4.7e-4 (fused) relative L2;
  held to 5e-3, ten times tighter than the 5% that "semi" against JAX's
  "split" needs (tests/test_torch_gl.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import t

from sstts.dsp.griffin_lim import griffin_lim as jax_griffin_lim
from sstts_torch.dsp.griffin_lim import griffin_lim

N_FFT, HOP, WIN, T = 512, 100, 400, 20
LENGTH = (T - 1) * HOP


@pytest.fixture(scope="module")
def magnitude():
    return np.random.default_rng(3).uniform(0.0, 2.0, size=(2, T, 257)).astype(np.float32)


def _both(magnitude, fft_impl, iter_impl, momentum):
    kw = dict(momentum=momentum, fft_impl=fft_impl, iter_impl=iter_impl)
    ref = np.asarray(
        jax_griffin_lim(jnp.asarray(magnitude), N_FFT, HOP, WIN, 4, LENGTH, **kw)
    )
    got = griffin_lim(t(magnitude), N_FFT, HOP, WIN, 4, LENGTH, **kw).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    return got, ref


def _hold(got, ref, fft_impl):
    if fft_impl == "dft_default":
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-3
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.99], ids=["classic", "momentum"])
@pytest.mark.parametrize("fft_impl", ["dft_default", "dft_high"])
def test_split_matches_jax(magnitude, fft_impl, momentum):
    _hold(*_both(magnitude, fft_impl, "split", momentum), fft_impl)


@pytest.mark.parametrize(
    "fft_impl,momentum",
    [("dft_default", 0.0), ("dft_default", 0.99), ("dft_high", 0.0)],
    ids=["bf16-classic", "bf16-momentum", "f32-classic"],
)
def test_split_xla_matches_jax(magnitude, fft_impl, momentum):
    _hold(*_both(magnitude, fft_impl, "split_xla", momentum), fft_impl)


@pytest.mark.parametrize("fft_impl", ["dft_default", "dft_high"])
def test_fused_matches_jax(magnitude, fft_impl):
    _hold(*_both(magnitude, fft_impl, "fused", 0.0), fft_impl)


@pytest.mark.parametrize(
    "fft_impl,momentum",
    [("xla", 0.0), ("xla", 0.99), ("default", 0.0)],
    ids=["xla-classic", "xla-momentum", "default"],
)
def test_complex_loop_matches_jax(magnitude, fft_impl, momentum):
    _hold(*_both(magnitude, fft_impl, "auto", momentum), fft_impl)


@pytest.mark.parametrize(
    "kw",
    [{"iter_impl": "splitt"}, {"fft_impl": "dft_low"}],
    ids=["iter_impl", "fft_impl"],
)
def test_unknown_names_raise_as_in_jax(magnitude, kw):
    for fn, mag in ((jax_griffin_lim, jnp.asarray(magnitude)), (griffin_lim, t(magnitude))):
        with pytest.raises(ValueError, match="unknown"):
            fn(mag, N_FFT, HOP, WIN, 2, LENGTH, **kw)
