"""The serving entry points of the port's Synthesizer on the CPU:
`synthesize_stream`, `synthesize_longform`, `to_file` and the compressed
wires, held to `synthesize_batch` and to the JAX Synthesizer on the same
converted weights (tiny config, 6 decoder steps, 3 Griffin-Lim
iterations; `ref_level_db` 80 on both sides so that the untrained model
speaks at ~0.24 instead of ~3e-5, where PCM16 would round everything to a
few codes).

Tolerances: long-form runs the bf16 "split" iteration on both sides
(`tests/test_torch_gl_iters.py`: the same iteration, rounding at the same
points) and crosses the PCM16 wire: measured 8.7e-4 relative L2 between the
two joined waveforms; held to 1e-2.  A stream yield and `synthesize_batch`
run the same code on the same dropout draws: equal.  Each wire against the
f32 audio of the same batch: above the SNR bounds of the JAX package's
round-trip tests (`tests/test_wire.py`: 32, 27, 21 and 14 dB for mulaw8,
adpcm4, adpcm3, adpcm2); measured 38.0, 34.5, 27.2 and 20.8 dB.
"""

import dataclasses

import numpy as np
import pytest

from torch_parity import jax_variables, tiny_pair

from sstts.data.wav import load_wav as jax_load_wav
from sstts.synthesize import Synthesizer as JaxSynthesizer
from sstts_torch.convert import convert_params
from sstts_torch.synthesize import Synthesizer

INFERENCE = {"max_decoder_steps": 6, "griffin_lim_iters": 3, "min_decoder_steps": 2}
PARAGRAPH = "The cat sat down. A dog ran far away today. Birds sing."


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_pair(inference=INFERENCE, dataset={"ref_level_db": 80.0})
    v = jax_variables(jcfg, seed=5)
    return jcfg, tcfg, v, convert_params(v["params"], v["batch_stats"], tcfg)


def _port(tcfg, params, seed=3, **inference):
    cfg = tcfg.replace(inference=dataclasses.replace(tcfg.inference, **inference))
    return Synthesizer(cfg, params, seed=seed, device="cpu")


def test_stream_yields_equal_synthesize_batch(setup):
    """Prenet dropout on: three batches streamed at depth 2 equal three
    `synthesize_batch` calls on a Synthesizer with the same seed."""
    _, tcfg, _, params = setup
    batches = [["hello world", "abc"], ["a much longer sentence"], ["one", "two"]]
    streamed = list(_port(tcfg, params).synthesize_stream(batches, depth=2))
    single = _port(tcfg, params)
    assert len(streamed) == len(batches)
    for texts, got in zip(batches, streamed):
        want = single.synthesize_batch(texts)
        assert len(got) == len(want) == len(texts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_abandoned_stream_stops(setup):
    """Closing the generator early leaves no batch behind and raises
    nothing; the Synthesizer stays usable."""
    _, tcfg, _, params = setup
    synth = _port(tcfg, params)
    gen = synth.synthesize_stream([["abc"]] * 5, depth=2)
    first = next(gen)
    gen.close()
    assert len(first) == 1 and len(synth.synthesize_batch(["abc"])) == 1


def test_longform_matches_jax_split(setup):
    jcfg, tcfg, v, params = setup
    overrides = {"griffin_lim_iter_impl": "split"}
    jcfg = jcfg.replace(
        arch=dataclasses.replace(jcfg.arch, prenet_dropout_at_inference=False),
        inference=dataclasses.replace(jcfg.inference, **overrides),
    )
    tcfg = tcfg.replace(
        arch=dataclasses.replace(tcfg.arch, prenet_dropout_at_inference=False)
    )
    ref = JaxSynthesizer(jcfg, v["params"], v["batch_stats"]).synthesize_longform(PARAGRAPH)
    got = _port(tcfg, params, **overrides).synthesize_longform(PARAGRAPH)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2


def test_longform_refuses_full_output_and_empty_text(setup):
    _, tcfg, _, params = setup
    synth = _port(tcfg, params)
    with pytest.raises(ValueError, match="full_output"):
        synth.synthesize_longform(PARAGRAPH, full_output=True)
    assert synth.synthesize_longform("").shape == (0,)


def test_to_file_reads_back_with_jax_load_wav(setup, tmp_path):
    _, tcfg, _, params = setup
    tcfg = tcfg.replace(
        arch=dataclasses.replace(tcfg.arch, prenet_dropout_at_inference=False)
    )
    synth = _port(tcfg, params)
    path = synth.to_file("hello world", tmp_path / "out" / "hello.wav")
    samples, sr = jax_load_wav(path)
    want = synth.synthesize("hello world")
    assert sr == tcfg.dataset.sample_rate and samples.shape == want.shape
    # PCM16 written at 32767 per unit, read back at 32768.
    np.testing.assert_allclose(samples, want, atol=1e-4)


@pytest.mark.parametrize(
    "wire,snr_db",
    [("mulaw8", 32.0), ("adpcm4", 27.0), ("adpcm3", 21.0), ("adpcm2", 14.0)],
)
def test_wire_formats_decode_to_the_f32_audio(setup, wire, snr_db):
    _, tcfg, _, params = setup
    synth = _port(tcfg, params, wire_format=wire)
    texts = ["hello world", "a much longer sentence to speak"]
    wavs = synth.synthesize_batch(texts)
    _, full = _port(tcfg, params, wire_format=wire).synthesize_batch(texts, full_output=True)
    assert full["wav_wire"].dtype == np.uint8
    for w, f, n in zip(wavs, full["wav"], full["n_samples"]):
        ref = np.clip(f[: int(n)], -1, 1)
        assert w.shape == ref.shape
        snr = 10 * np.log10(np.mean(ref**2) / np.mean((w - ref) ** 2))
        assert snr > snr_db, snr
