"""The port's native C++ WAV decoder, trimmer and ADPCM row decoder
(`sstts_torch.data.native_loader`, `sstts_torch/csrc/host/wavio.cpp`)
against the port's numpy codec, the mirror of `tests/test_native.py`.

Decode and trim are bit-equal to the numpy path; the ADPCM rows within
f32 summation-order rounding (atol 1e-6, ~1e-7 seen: the C++ accumulates
sequentially, numpy's cumsum may associate otherwise).  The library must
build wherever `g++` is present, as it is on this host and the card's.
No JAX here."""

import shutil
import struct

import numpy as np
import pytest
import torch

from sstts_torch.config import Config
from sstts_torch.data import native_loader
from sstts_torch.data import pipeline
from sstts_torch.data import wav as wav_mod
from sstts_torch.data.ljspeech import Utterance
from sstts_torch.dsp import ops

CODECS = [
    (4, ops.adpcm4_encode_wire, ops._adpcm4_decode_rows_np, ops.adpcm4_decode_host_rows),
    (3, ops.adpcm3_encode_wire, ops._adpcm3_decode_rows_np, ops.adpcm3_decode_host_rows),
    (2, ops.adpcm2_encode_wire, ops._adpcm2_decode_rows_np, ops.adpcm2_decode_host_rows),
]


def _write_float_wav(path, samples, sr, channels=1):
    """IEEE float32 WAV (format 3), interleaved channels."""
    body = np.asarray(samples, "<f4").tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    header += b"fmt " + struct.pack("<IHHIIHH", 16, 3, channels, sr, sr * 4 * channels,
                                    4 * channels, 32)
    path.write_bytes(header + b"data" + struct.pack("<I", len(body)) + body)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths, signals = [], []
    for i in range(6):
        n = int(rng.integers(3000, 12000))
        y = (0.5 * np.sin(np.linspace(0, 50 + i * 10, n))).astype(np.float32)
        y[: n // 10] = 0.0  # leading silence for the trim
        p = root / f"u{i}.wav"
        wav_mod.save_wav(p, y, 22050)
        paths.append(str(p))
        signals.append(y)
    stereo = rng.uniform(-0.5, 0.5, (4000, 2)).astype(np.float32)
    _write_float_wav(root / "float_stereo.wav", stereo.reshape(-1), 16000, channels=2)
    return paths, signals, str(root / "float_stereo.wav")


def test_native_builds_into_the_port_build_dir():
    """Built with g++ into the git-ignored `sstts_torch/_build/`, never the
    JAX package's cache, so the port loads its own library."""
    assert shutil.which("g++"), "g++ toolchain expected in this image"
    assert native_loader.available()
    path = native_loader.library_path()
    assert path.exists() and path.parent == native_loader.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "sstts_torch"
    assert path.name.startswith("libsstts_torch_wavio-")


def test_native_decode_matches_numpy(corpus):
    paths, _, stereo = corpus
    for p in [*paths, stereo]:
        got, sr = native_loader.load_wav(p)
        want, sr2 = wav_mod.load_wav(p)
        assert sr == sr2 and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_native_decode_grows_a_short_buffer(corpus):
    """A file longer than the first bound is decoded after a retry."""
    paths, _, _ = corpus
    got, _ = native_loader.load_wav(paths[0], max_seconds=0.01, sample_rate_hint=22050)
    np.testing.assert_array_equal(got, wav_mod.load_wav(paths[0])[0])


def test_native_batch_decode(corpus):
    paths, _, _ = corpus
    out, lengths, srs = native_loader.decode_batch(paths, max_len=20000)
    assert (srs == 22050).all()
    for i, p in enumerate(paths):
        want, _ = wav_mod.load_wav(p)
        assert lengths[i] == len(want)
        np.testing.assert_array_equal(out[i, : lengths[i]], want)
        assert (out[i, lengths[i]:] == 0).all()


def test_native_reports_bad_files(corpus, tmp_path):
    paths, _, _ = corpus
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"garbage")
    out, lengths, srs = native_loader.decode_batch([paths[0], str(bad)], 20000)
    assert lengths[0] > 0 and lengths[1] < 0
    with pytest.raises(ValueError, match="native WAV decode failed"):
        native_loader.load_wav(bad)


def test_native_trim_matches_numpy(corpus):
    _, signals, _ = corpus
    for y in signals:
        got = native_loader.trim_silence(y, 40.0)
        want = pipeline.trim_silence(y, 40.0)
        assert len(got) < len(y)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native_loader.trim_silence(np.zeros(0, np.float32), 40.0),
                                  np.zeros(0, np.float32))


@pytest.mark.parametrize("n", [256, 700, 5000])
@pytest.mark.parametrize("bits,encode,decode_np,_", CODECS, ids=["adpcm4", "adpcm3", "adpcm2"])
def test_native_adpcm_decode_matches_numpy(n, bits, encode, decode_np, _):
    """Silence rows, fp16-subnormal block scales, clipped rows and lengths
    that are not a multiple of 256 (padded tail blocks)."""
    rng = np.random.default_rng(7)
    wav = np.clip(rng.standard_normal((4, n)).astype(np.float32) * 0.3, -1, 1)
    wav[0] = 0.0
    wav[1] *= 1e-6
    wav[2] = np.clip(wav[2] * 10, -1, 1)
    rows = encode(torch.as_tensor(wav)).numpy()
    want = decode_np(rows)
    got = native_loader.adpcm_decode_rows(rows, bits)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("bits,encode,decode_np,decode", CODECS,
                         ids=["adpcm4", "adpcm3", "adpcm2"])
def test_public_decoders_take_the_native_rows(bits, encode, decode_np, decode):
    """`adpcm*_decode_host_rows` and `decode_wire_rows` (the Synthesizer's
    fetch) run the native decoder, within f32 rounding of numpy's."""
    rng = np.random.default_rng(8)
    wav = np.clip(rng.standard_normal((3, 1000)).astype(np.float32) * 0.2, -1, 1)
    rows = encode(torch.as_tensor(wav)).numpy()
    native = native_loader.adpcm_decode_rows(rows, bits)
    np.testing.assert_array_equal(decode(rows), native)
    np.testing.assert_array_equal(ops.decode_wire_rows(rows, f"adpcm{bits}"), native)
    np.testing.assert_allclose(decode(rows), decode_np(rows), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="bits"):
        native_loader.adpcm_decode_rows(rows, 5)


def test_load_audio_decodes_and_trims_natively(corpus, monkeypatch):
    """The corpus loader goes through the library; without it (no
    toolchain) the numpy codec gives the same samples."""
    paths, _, _ = corpus
    cfg = Config()  # 22,050 Hz, as the files
    utt = Utterance("u0", paths[1], "hello")
    calls = []
    load = native_loader.load_wav
    monkeypatch.setattr(native_loader, "load_wav",
                        lambda *a, **k: calls.append(a) or load(*a, **k))
    native = pipeline.load_audio(utt, cfg)
    assert calls
    monkeypatch.setattr(native_loader, "_library", lambda: None)
    assert not native_loader.available()
    fallback = pipeline.load_audio(utt, cfg)
    np.testing.assert_array_equal(native, fallback)
    assert native_loader.adpcm_decode_rows(np.zeros((1, 132), np.uint8), 4) is None
    out, lengths, _ = native_loader.decode_batch(paths[:2], 20000)
    assert (lengths > 0).all()
