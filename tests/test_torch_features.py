"""The training targets and losses of the port, held to JAX.

Tolerances: the mel filterbank is the same float64 construction rounded to
f32, so it agrees to 1e-7.  Features run an f32 FFT on both sides (XLA's
and pocketfft's) in another summation order.  After the dB compression and
the [0, 1] normalization the mel features agree to 1e-5 absolute; the
linear ones too, but for near-silent bins close to the dB floor, where
log10 amplifies f32 rounding (measured: at most 8.3e-5 on 0.14% of the
values).  The losses are f32 reductions over identical inputs: rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t, tiny_pair

import sstts.config as jax_config
import sstts_torch.config as port_config
from sstts.dsp import mel as jax_mel
from sstts.dsp import stft as jax_stft
from sstts.dsp.ops import wav_to_features as jax_features
from sstts.model.losses import tacotron_loss as jax_loss
from sstts_torch.dsp import mel as port_mel
from sstts_torch.dsp import stft as port_stft
from sstts_torch.dsp.ops import wav_to_features
from sstts_torch.model.losses import tacotron_loss


def _wave(rng, n, sr):
    tt = np.arange(n) / sr
    y = 0.5 * np.sin(2 * np.pi * 220.0 * tt) + 0.2 * np.sin(2 * np.pi * 1330.0 * tt)
    return (y + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_mel_filterbank_matches_jax(which):
    ds = (port_config.tiny_config().dataset if which == "tiny"
          else port_config.DatasetConfig())
    got = port_mel.filterbank(ds).numpy()
    ref = np.asarray(jax_mel.mel_filterbank(ds))
    assert got.shape == (ds.n_mels, ds.n_linear)
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


def test_stft_frames_match_jax():
    """The centered STFT's frame count and (complex) values against the JAX
    STFT on one batch: the framing and the reflect padding."""
    ds = port_config.tiny_config().dataset
    y = np.random.default_rng(0).standard_normal((2, 1234)).astype(np.float32)
    got = port_stft.stft(t(y), ds.n_fft, ds.hop_len, ds.win_len).numpy()
    ref = np.asarray(jax_stft.stft(jnp.asarray(y), ds.n_fft, ds.hop_len, ds.win_len))
    assert got.shape == ref.shape
    assert got.shape[-2] == port_stft.num_frames(1234, ds.hop_len)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_wav_to_features_matches_jax(which):
    pcfg = port_config.tiny_config() if which == "tiny" else port_config.Config()
    jcfg = jax_config.tiny_config() if which == "tiny" else jax_config.Config()
    ds = pcfg.dataset
    rng = np.random.default_rng(1)
    y = np.stack([_wave(rng, ds.sample_rate // 2, ds.sample_rate) for _ in range(2)])
    y[1, ds.sample_rate // 4 :] = 0.0  # a padded tail: exact silence
    lin, mel = wav_to_features(t(y), ds)
    ref_lin, ref_mel = jax.jit(lambda a: jax_features(a, jcfg.dataset))(jnp.asarray(y))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), atol=1e-5, rtol=0)
    assert lin.shape == ref_lin.shape
    d = np.abs(lin.numpy() - np.asarray(ref_lin))
    # A tight mean and a looser max, the rule tests/test_dsp.py:182-188
    # applies to the JAX package's own two FFT paths.
    assert d.mean() < 1e-6 and d.max() < 5e-4 and (d > 1e-5).mean() < 1e-2


def test_dft_feature_impls_are_refused():
    """An unknown transform is refused with the valid ones named; the
    direct-DFT rungs are ported (held to JAX in test_torch_train_corpus.py)."""
    ds = port_config.tiny_config().dataset
    with pytest.raises(ValueError, match="'dft_default', 'dft_high', 'dft_highest'"):
        wav_to_features(torch.zeros(1, 800), ds, "dft_fast")
    lin, mel = wav_to_features(torch.zeros(1, 800), ds, "dft_high")
    assert lin.shape == (1, 9, ds.n_linear) and mel.shape == (1, 9, ds.n_mels)


@pytest.mark.parametrize("guided", [0.0, 0.7], ids=["plain", "guided"])
def test_losses_match_jax(guided):
    """Every term and the total, with a fill row (loss_frames = 0) and
    a row whose stop mask is clipped at the end."""
    jcfg, pcfg = tiny_pair(arch={"guided_attention_weight": guided})
    rng = np.random.default_rng(2)
    B, F, S, T = 3, 12, 6, 7
    ds = pcfg.dataset
    out = {
        "mel": rng.normal(size=(B, F, ds.n_mels)).astype(np.float32),
        "linear": rng.normal(size=(B, F, ds.n_linear)).astype(np.float32),
        "stop_logits": rng.normal(size=(B, F)).astype(np.float32),
        "alignments": rng.uniform(size=(B, S, T)).astype(np.float32),
    }
    mel_gt = rng.uniform(size=(B, F, ds.n_mels)).astype(np.float32)
    lin_gt = rng.uniform(size=(B, F, ds.n_linear)).astype(np.float32)
    loss_frames = np.array([9, 0, 12], np.int32)
    text_len = np.array([7, 3, 5], np.int32)
    ref_loss, ref = jax_loss(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(mel_gt),
        jnp.asarray(lin_gt), jnp.asarray(loss_frames), jcfg.arch, jcfg.dataset,
        text_lengths=jnp.asarray(text_len),
    )
    loss, got = tacotron_loss(
        {k: t(v) for k, v in out.items()}, t(mel_gt), t(lin_gt),
        torch.as_tensor(loss_frames), pcfg.arch, pcfg.dataset,
        text_lengths=torch.as_tensor(text_len),
    )
    assert set(got) == set(ref)
    assert ("loss_attn" in got) == (guided > 0)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)


def test_fill_row_contributes_nothing():
    """A fill row (loss_frames = 0) changes no term, whatever its values."""
    _, pcfg = tiny_pair()
    ds = pcfg.dataset
    B, F = 2, 8

    def outputs(scale):
        rng = np.random.default_rng(3)
        o = {
            "mel": rng.normal(size=(B, F, ds.n_mels)),
            "linear": rng.normal(size=(B, F, ds.n_linear)),
            "stop_logits": rng.normal(size=(B, F)),
            "alignments": rng.uniform(size=(B, 4, 5)),
        }
        return {k: torch.as_tensor(v * np.array([1.0, scale]).reshape(-1, *[1] * (v.ndim - 1)),
                                   dtype=torch.float32) for k, v in o.items()}

    mel_gt = torch.rand(B, F, ds.n_mels)
    lin_gt = torch.rand(B, F, ds.n_linear)
    lf = torch.tensor([6, 0])
    a = tacotron_loss(outputs(1.0), mel_gt, lin_gt, lf, pcfg.arch, ds)[1]
    b = tacotron_loss(outputs(50.0), mel_gt, lin_gt, lf, pcfg.arch, ds)[1]
    for k in a:
        assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-6), k


def test_default_dataset_bucket_shapes():
    """The training bucket at the default config: text 128, 512 -> 515
    frames (a multiple of r = 5), 103 decoder steps."""
    from sstts_torch.data.pipeline import frame_bucket_shapes

    cfg = port_config.Config()
    assert frame_bucket_shapes(cfg)[1] == (128, 515)
    assert dataclasses.asdict(cfg.training) == dataclasses.asdict(jax_config.Config().training)
