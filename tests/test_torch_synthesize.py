"""The slice as a whole: the port's Synthesizer on the CPU against the JAX
Synthesizer, on the same converted weights with prenet dropout off.

Tolerances: encoder, decoder and post-net are f32 on both sides (1e-4 on
mel and linear after 6 autoregressive steps).  The waveform is held tightly
with the f32 Griffin-Lim loop ("dft_highest", 1e-5), and loosely with the
default bf16 loop, where the JAX package on the CPU runs its "split"
iteration and the port its "semi" iteration (see test_torch_gl.py): 5%
relative L2.
"""

import numpy as np
import pytest

from torch_parity import jax_variables, tiny_pair

from sstts.synthesize import Synthesizer as JaxSynthesizer
from sstts_torch.convert import convert_params
from sstts_torch.synthesize import Synthesizer

TEXTS = ["hello world", "a much longer sentence to speak"]


def _pair(fft_impl):
    jcfg, tcfg = tiny_pair(
        arch={"prenet_dropout_at_inference": False},
        inference={
            "max_decoder_steps": 6, "griffin_lim_iters": 3,
            "min_decoder_steps": 2, "griffin_lim_fft_impl": fft_impl,
        },
    )
    v = jax_variables(jcfg, seed=4)
    jax_synth = JaxSynthesizer(jcfg, v["params"], v["batch_stats"])
    port = Synthesizer(
        tcfg, convert_params(v["params"], v["batch_stats"], tcfg), device="cpu"
    )
    return jax_synth, port


@pytest.fixture(scope="module", params=["dft_highest", "dft_default"])
def outputs(request):
    jax_synth, port = _pair(request.param)
    jw, jfull = jax_synth.synthesize_batch(TEXTS, full_output=True)
    tw, tfull = port.synthesize_batch(TEXTS, full_output=True)
    return request.param, port, (jw, jfull), (tw, tfull)


def test_lengths_identical(outputs):
    _, _, (jw, jfull), (tw, tfull) = outputs
    np.testing.assert_array_equal(tfull["n_frames"], np.asarray(jfull["n_frames"]))
    np.testing.assert_array_equal(tfull["n_samples"], np.asarray(jfull["n_samples"]))
    assert [len(w) for w in tw] == [len(w) for w in jw]


def test_spectrograms_agree(outputs):
    _, _, (_, jfull), (_, tfull) = outputs
    for key in ("mel", "linear", "alignments"):
        np.testing.assert_allclose(
            tfull[key], np.asarray(jfull[key]), atol=1e-4, err_msg=key
        )


def test_waveform_agrees(outputs):
    fft_impl, _, (jw, jfull), (tw, tfull) = outputs
    ref, got = np.asarray(jfull["wav"]), tfull["wav"]
    assert np.isfinite(got).all()
    if fft_impl == "dft_highest":
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-2
    # The PCM16 wire decodes to the f32 waveform within one quantum.
    for w, full, n in zip(tw, got, tfull["n_samples"]):
        np.testing.assert_allclose(w, full[: int(n)], atol=1.0 / 32767 + 1e-7)


def test_padded_batch_equals_batch_of_one(outputs):
    """Masking is a correctness contract: an utterance synthesized inside a
    padded batch equals the same utterance alone."""
    _, port, _, (tw, tfull) = outputs
    (single,), sfull = port.synthesize_batch(TEXTS[:1], full_output=True)
    assert len(single) == len(tw[0]) == int(sfull["n_samples"][0])
    np.testing.assert_allclose(single, tfull["wav"][0, : len(single)], atol=1e-6)
    pcm = tfull["wav_wire"][0, : len(single)].astype(np.float32) / 32767.0
    np.testing.assert_allclose(port.synthesize(TEXTS[0]), pcm, atol=1.0 / 32767 + 1e-7)
