"""The port's matmul transforms (`sstts_torch/dsp/fft.py`) held to the JAX
package's (`sstts/dsp/fft.py`) and to `torch.fft`, on the CPU: the
four-step real FFT and its inverse (`fft_impl="ct_matmul"`), the direct
rDFT GEMMs, the STFT pair with every `fft_impl`, and the Griffin-Lim
complex loop on the matmul FFT.

Tolerances: f32 on every side with sums in other orders; the transforms
within 1e-5 relative L2 (the largest seen ~3e-7); four Griffin-Lim
iterations carry that through the renorm, within 1e-5 relative L2 of
JAX's loop (seen ~1e-6)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sstts.dsp import fft as jfft
from sstts.dsp import griffin_lim as jgl
from sstts.dsp import stft as jstft
from sstts_torch.dsp import fft as pfft
from sstts_torch.dsp import griffin_lim as pgl
from sstts_torch.dsp import stft as pstft

SIZES = [2048, 512, 400, 96, 22, 14, 9]


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_split_and_support_follow_the_reference():
    for n in range(2, 300):
        assert pfft._best_split(n) == jfft._best_split(n), n
        assert pfft.supported(n) == jfft.supported(n), n
    assert pfft.supported(2048) and pfft._best_split(1024) == (32, 32)
    assert not pfft.supported(22) and not pfft.supported(9)


@pytest.mark.parametrize("n", SIZES)
def test_rfft_matches_jax_and_torch(n):
    x = np.random.default_rng(n).standard_normal((3, 5, n)).astype(np.float32)
    got = pfft.rfft(torch.as_tensor(x), n)
    assert got.dtype == torch.complex64 and got.shape == (3, 5, n // 2 + 1)
    assert rel(got, jfft.rfft(jnp.asarray(x), n)) <= 1e-5
    assert rel(got, torch.fft.rfft(torch.as_tensor(x).double(), n=n)) <= 1e-5


@pytest.mark.parametrize("n", SIZES)
def test_irfft_matches_jax_and_torch(n):
    x = np.random.default_rng(n + 1).standard_normal((4, n)).astype(np.float32)
    spec = np.fft.rfft(x).astype(np.complex64)
    got = pfft.irfft(torch.as_tensor(spec), n)
    assert got.dtype == torch.float32 and got.shape == (4, n)
    assert rel(got, jfft.irfft(jnp.asarray(spec), n)) <= 1e-5
    assert rel(got, x) <= 1e-5


def test_transforms_check_their_width():
    with pytest.raises(ValueError, match="expected last dim 512"):
        pfft.rfft(torch.zeros(2, 500), 512)
    with pytest.raises(ValueError, match="expected last dim 257"):
        pfft.irfft(torch.zeros(2, 256, dtype=torch.complex64), 512)


@pytest.mark.parametrize("impl", pfft.DFT_IMPLS)
def test_direct_rdft_matches_jax(impl):
    """On the CPU every rung is f32 in both packages (XLA:CPU ignores the
    precision)."""
    import jax

    prec = {"dft_default": jax.lax.Precision.DEFAULT, "dft_high": jax.lax.Precision.HIGH,
            "dft_highest": jax.lax.Precision.HIGHEST}[impl]
    n = 400
    x = np.random.default_rng(3).standard_normal((2, 6, n)).astype(np.float32)
    xt = torch.as_tensor(x)
    spec = pfft.rdft(xt, n, impl)
    assert rel(spec, jfft.rdft(jnp.asarray(x), n, prec)) <= 1e-5
    assert rel(pfft.irdft(spec, n, impl), x) <= 1e-5
    assert rel(pfft.irdft(spec, n, impl),
               jfft.irdft(jnp.asarray(spec.numpy()), n, prec)) <= 1e-5
    re, im = pfft.rdft_ri(xt, n, impl)
    jre, jim = jfft.rdft_ri(jnp.asarray(x), n, prec)
    assert rel(re, jre) <= 1e-5 and rel(im, jim) <= 1e-5
    back = pfft.irdft_ri(re, im, n, impl)
    assert rel(back, jfft.irdft_ri(jre, jim, n, prec)) <= 1e-5
    assert rel(back, x) <= 1e-5


@pytest.mark.parametrize("impl", ["default", "xla", "ct_matmul", "dft_high"])
def test_stft_pair_with_every_fft_impl(impl):
    """`stft`/`istft(fft_impl=)` against the JAX package's with the same
    impl, and the round trip."""
    n_fft, hop, win = 512, 128, 400
    y = np.random.default_rng(5).standard_normal((2, 4000)).astype(np.float32)
    spec = pstft.stft(torch.as_tensor(y), n_fft, hop, win, impl)
    jspec = jstft.stft(jnp.asarray(y), n_fft, hop, win, fft_impl=impl)
    assert rel(spec, jspec) <= 1e-5
    back = pstft.istft(spec, n_fft, hop, win, 4000, impl)
    assert rel(back, jstft.istft(jspec, n_fft, hop, win, 4000, fft_impl=impl)) <= 1e-5
    assert rel(back, y) <= 1e-5


def test_an_unsupported_size_takes_torch_fft_under_ct_matmul():
    y = np.random.default_rng(6).standard_normal((1, 900)).astype(np.float32)
    a = pstft.stft(torch.as_tensor(y), 22, 11, 22, "ct_matmul")
    b = pstft.stft(torch.as_tensor(y), 22, 11, 22, "xla")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown fft impl"):
        pstft.stft(torch.as_tensor(y), 512, 128, 400, "bogus")


@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_griffin_lim_on_the_matmul_fft_matches_jax(momentum):
    """`griffin_lim(fft_impl="ct_matmul")` no longer raises: the complex
    loop on the four-step FFT, against the JAX package's same loop and the
    port's `torch.fft` loop."""
    n_fft, hop, win, frames = 512, 128, 400, 20
    x = np.random.default_rng(7).standard_normal((2, frames, n_fft))
    mag = np.abs(np.fft.rfft(x, axis=-1)).astype(np.float32)
    length = (frames - 1) * hop
    got = pgl.griffin_lim(torch.as_tensor(mag), n_fft, hop, win, 4, length,
                          momentum=momentum, fft_impl="ct_matmul").numpy()
    ref = np.asarray(jgl.griffin_lim(jnp.asarray(mag), n_fft, hop, win, 4, length,
                                     momentum=momentum, fft_impl="ct_matmul"))
    assert got.shape == ref.shape == (2, length)
    assert rel(got, ref) <= 1e-5
    xla = pgl.griffin_lim(torch.as_tensor(mag), n_fft, hop, win, 4, length,
                          momentum=momentum, fft_impl="xla").numpy()
    assert rel(got, xla) <= 1e-5


def test_ct_matmul_is_accepted_where_it_was_refused():
    """The Griffin-Lim resolution takes "ct_matmul" on either device (the
    complex loop, no kernel) and a Synthesizer runs on it."""
    from sstts_torch.config import tiny_config
    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.synthesize import Synthesizer, check_supported

    cfg = tiny_config()
    cfg = cfg.replace(inference=dataclasses.replace(cfg.inference,
                                                    griffin_lim_fft_impl="ct_matmul"))
    for dev in ("cpu", "cuda"):
        check_supported(cfg, torch.device(dev))
    wav = Synthesizer(cfg, init_state_dict(cfg.arch, cfg.dataset, 0),
                      device="cpu").synthesize("hello")
    assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()
    with pytest.raises(ValueError, match="unknown griffin_lim fft_impl"):
        pgl.resolve_iter_impl(None, 0.0, "ct_fft", "cpu")
