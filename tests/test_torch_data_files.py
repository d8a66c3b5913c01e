"""The port's on-disk corpus path held to the JAX package on the same files
written into `tmp_path`: the LJSpeech, Blizzard-Nancy and CSS10 loaders
(equal `Utterance` lists), `load_audio` with resampling and trimming, the
offline cache in both directions (the same bytes on disk, byte-equal
batches), the precomputed features, the corpus statistics and
`load_corpus`.

Tolerances: `load_audio` against the JAX package's (its native decoder
where built, else numpy) the same length and atol 1e-6, the contract of
`tests/test_native.py`; the trim against `sstts/dsp/reference.py` and the
resampler against its original bit for bit; the features, stored as
float16, within 2**-10 (one float16 step just below 1.0 is 2**-11, so an
f32 difference of an FFT's rounding can move a value by one step); the
statistics within 1e-4 dB.
"""

import dataclasses

import numpy as np
import pytest

from torch_parity import tiny_pair

from sstts import train as jtrain
from sstts.data import corpora as jcorpora
from sstts.data import features_cache as jcache
from sstts.data import ljspeech as jlj
from sstts.data import pipeline as jpipe
from sstts.data.statistics import compute_statistics as jax_statistics
from sstts.dsp import reference as jref
from sstts.dsp.resample import resample as jax_resample
from sstts_torch import train as ptrain
from sstts_torch.data import corpora as pcorpora
from sstts_torch.data import features_cache as pcache
from sstts_torch.data import ljspeech as plj
from sstts_torch.data import pipeline as ppipe
from sstts_torch.data.statistics import compute_statistics as port_statistics
from sstts_torch.data.synthetic import materialize_corpus
from sstts_torch.dsp.resample import resample as port_resample

LAYOUTS = ("ljspeech", "blizzard_nancy", "css10")


def _pair(kind, root, **dataset):
    return tiny_pair(
        dataset={"dataset": kind, "dataset_dir": str(root), "eval_fraction": 0.25,
                 **dataset},
        training={"batch_size": 2, "text_buckets": (32,), "frame_buckets": (160,)},
    )


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """One corpus of each layout at the tiny config's 8 kHz, 12 utterances
    of 1-2 words with 0.3 s of silence at each end, and a CSS10 corpus at
    16 kHz."""
    _, pcfg = tiny_pair()
    root = tmp_path_factory.mktemp("corpora")
    out = {}
    for layout in LAYOUTS:
        out[layout] = materialize_corpus(root / layout, 12, pcfg.dataset, layout,
                                         pad_s=0.3, min_words=1, max_words=2)
    out["css10_16k"] = materialize_corpus(root / "css10_16k", 4, pcfg.dataset, "css10",
                                          sample_rate=16000, pad_s=0.3, min_words=1,
                                          max_words=2)
    return out


def _records(utts):
    return [(u.uid, u.wav_path, u.text) for u in utts]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_loaders_give_equal_utterances(corpora, layout):
    jcfg, pcfg = _pair(layout, corpora[layout])
    jload = {"ljspeech": jlj.load_metadata, "blizzard_nancy": jcorpora.load_blizzard_nancy,
             "css10": jcorpora.load_css10}[layout]
    pload = {"ljspeech": plj.load_metadata, "blizzard_nancy": pcorpora.load_blizzard_nancy,
             "css10": pcorpora.load_css10}[layout]
    ref, got = jload(jcfg.dataset), pload(pcfg.dataset)
    assert len(ref) == 12
    assert _records(got) == _records(ref)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_missing_corpus_file_raises(tmp_path, layout):
    _, pcfg = _pair(layout, tmp_path)
    load = {"ljspeech": plj.load_metadata, "blizzard_nancy": pcorpora.load_blizzard_nancy,
            "css10": pcorpora.load_css10}[layout]
    with pytest.raises(FileNotFoundError):
        load(pcfg.dataset)


def test_corpus_text_rules_match(tmp_path):
    """Texts that normalize to nothing or exceed max_text_len are dropped,
    the normalized column wins, CSS10 uids keep the book, digits expand."""
    (tmp_path / "metadata.csv").write_text(
        "A|Raw one.|norm one.\nB||\nC|Only raw 42.\nD|" + "x" * 40 + "\n", encoding="utf-8"
    )
    (tmp_path / "transcript.txt").write_text(
        "b1/1.wav|Ein Mädchen.|Ein Maedchen.|2.1\nb2/1.wav|Zwei.||1.0\nbad\n",
        encoding="utf-8",
    )
    (tmp_path / "prompts.data").write_text('( P1 "Hello there." )\n( P2 "" )\n')
    jcfg, pcfg = _pair("ljspeech", tmp_path)
    assert _records(plj.load_metadata(pcfg.dataset)) == _records(
        jlj.load_metadata(jcfg.dataset)
    )
    assert _records(pcorpora.load_css10(pcfg.dataset)) == _records(
        jcorpora.load_css10(jcfg.dataset)
    )
    assert _records(pcorpora.load_blizzard_nancy(pcfg.dataset)) == _records(
        jcorpora.load_blizzard_nancy(jcfg.dataset)
    )
    assert [u.uid for u in pcorpora.load_css10(pcfg.dataset)] == ["b1_1", "b2_1"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_load_audio_matches_jax(corpora, layout):
    jcfg, pcfg = _pair(layout, corpora[layout])
    for u in plj.load_metadata(pcfg.dataset) if layout == "ljspeech" else (
        pcorpora.load_blizzard_nancy(pcfg.dataset) if layout == "blizzard_nancy"
        else pcorpora.load_css10(pcfg.dataset)
    ):
        got = ppipe.load_audio(u, pcfg)
        ref = jpipe.load_audio(jlj.Utterance(u.uid, u.wav_path, u.text), jcfg)
        assert got.dtype == np.float32
        assert len(got) == len(ref)
        assert len(got) < 0.3 * 8000 * 2 + 0.06 * 8000 * len(u.text)  # trimmed
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=u.uid)


def test_load_audio_resamples_16k(corpora):
    """A 16 kHz corpus into the 8 kHz pipeline: resampled and trimmed
    where resample_on_load is set, a ValueError where it is not."""
    root = corpora["css10_16k"]
    jcfg, pcfg = _pair("css10", root, resample_on_load=True)
    utts = pcorpora.load_css10(pcfg.dataset)
    for u in utts:
        got = ppipe.load_audio(u, pcfg)
        ref = jpipe.load_audio(jlj.Utterance(u.uid, u.wav_path, u.text), jcfg)
        assert len(got) == len(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=u.uid)
    jstrict, pstrict = _pair("css10", root)
    with pytest.raises(ValueError, match="resample_on_load"):
        ppipe.load_audio(utts[0], pstrict)
    with pytest.raises(ValueError, match="resample_on_load"):
        jpipe.load_audio(jlj.Utterance(utts[0].uid, utts[0].wav_path, ""), jstrict)


@pytest.mark.parametrize("case", ["tones", "short", "silent", "empty", "quiet_edges"])
def test_trim_silence_matches_reference(case):
    rng = np.random.default_rng(3)
    y = {
        "tones": np.sin(np.arange(30000) * 0.05) * np.linspace(0, 1, 30000) ** 3,
        "short": rng.normal(size=1500) * 0.1,
        "silent": np.zeros(9000),
        "empty": np.zeros(0),
        "quiet_edges": np.concatenate([rng.normal(size=6000) * 1e-5,
                                       rng.normal(size=20000) * 0.3,
                                       rng.normal(size=7000) * 1e-4]),
    }[case].astype(np.float32)
    for top_db in (40.0, 60.0):
        got = ppipe.trim_silence(y, top_db)
        ref = jref.trim_silence(y, top_db).astype(np.float32)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rates", [(16000, 22050), (22050, 16000), (48000, 22050), (8000, 8000)])
def test_resample_equals_original(rates):
    y = np.random.default_rng(5).normal(size=3001).astype(np.float32)
    np.testing.assert_array_equal(port_resample(y, *rates), jax_resample(y, *rates))


def _utts(jcfg, pcfg):
    jtr, jev = jtrain.load_corpus(jcfg)
    ptr, pev = ptrain.load_corpus(pcfg)
    assert _records(ptr) == _records(jtr) and _records(pev) == _records(jev)
    return ptr + pev


def test_caches_interoperate(corpora, tmp_path):
    """A cache built by either package has the same files, opens in the
    other, and its batches are byte-equal to the other package's batches
    and to batches from the WAV files."""
    jcfg, pcfg = _pair("ljspeech", corpora["ljspeech"])
    utts = _utts(jcfg, pcfg)
    jutts = [jlj.Utterance(u.uid, u.wav_path, u.text) for u in utts]
    jbuilt = jcache.build_audio_cache(jutts, jcfg, tmp_path / "jax")
    pbuilt = pcache.build_audio_cache(utts, pcfg, tmp_path / "port")
    for name in ("index.json", "audio.bin"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    in_port = pcache.AudioCache(tmp_path / "jax", pcfg)
    in_jax = jcache.AudioCache(tmp_path / "port", jcfg)
    assert len(in_port) == len(jbuilt) == len(pbuilt) == len(in_jax) == len(utts)
    for u in utts:
        np.testing.assert_array_equal(in_port.get_pcm(u.uid), jbuilt.get_pcm(u.uid))
        np.testing.assert_array_equal(in_port.get(u.uid), jbuilt.get(u.uid))
        assert in_port.length(u.uid) == jbuilt.length(u.uid)
    from_cache = list(ppipe.Batcher(utts, pcfg, audio_cache=in_port).epoch(7, 2))
    ref = list(jpipe.Batcher(jutts, jcfg, audio_cache=jbuilt).epoch(7, 2))
    from_files = list(ppipe.Batcher(utts, pcfg, audio_cache=None).epoch(7, 2))
    assert len(from_cache) == len(ref) == len(from_files) > 1
    for (pb, p), (jb, j), (fb, f) in zip(from_cache, ref, from_files):
        assert pb == jb == fb
        for k in j:
            assert p[k].dtype == j[k].dtype
            assert p[k].tobytes() == j[k].tobytes() == f[k].tobytes(), k
    # The fingerprint guards the dataset hyperparameters.
    other = pcfg.replace(dataset=dataclasses.replace(pcfg.dataset, trim_top_db=30.0))
    with pytest.raises(ValueError, match="different"):
        pcache.AudioCache(tmp_path / "jax", other)


def test_batcher_reads_the_configured_cache(corpora, tmp_path, monkeypatch):
    """With dataset.cache_dir set the Batcher opens the cache, counts an
    epoch from its index and batches without reading a WAV file."""
    _, pcfg = _pair("ljspeech", corpora["ljspeech"], cache_dir=str(tmp_path / "c"))
    utts = ptrain.load_corpus(pcfg)[0]
    pcache.build_audio_cache(utts, pcfg, tmp_path / "c")
    monkeypatch.setattr(ppipe, "load_audio", lambda *a: pytest.fail("read a WAV file"))
    batcher = ppipe.Batcher(utts, pcfg)
    assert batcher.audio_cache is not None
    n = batcher.batches_per_epoch(2)
    assert n == len(list(batcher.epoch(0, 2))) > 0


def test_precompute_features_matches_jax(corpora, tmp_path):
    jcfg, pcfg = _pair("ljspeech", corpora["ljspeech"])
    utts = _utts(jcfg, pcfg)
    jutts = [jlj.Utterance(u.uid, u.wav_path, u.text) for u in utts]
    jc = jcache.build_audio_cache(jutts, jcfg, tmp_path / "jax")
    pc = pcache.build_audio_cache(utts, pcfg, tmp_path / "port")
    jcache.precompute_features(jc, jutts, jcfg, batch_frames=256)
    pcache.precompute_features(pc, utts, pcfg, batch_frames=256, device="cpu")
    assert pc.has_features()
    reopened = pcache.AudioCache(tmp_path / "port", pcfg)
    for u in utts:
        jl, jm = jc.get_features(u.uid, jcfg)
        pl, pm = reopened.get_features(u.uid, pcfg)
        assert pl.dtype == pm.dtype == np.float16
        assert pl.shape == jl.shape and pm.shape == jm.shape
        assert pm.shape == (min(1 + pc.length(u.uid) // pcfg.dataset.hop_len, 256), 20)
        np.testing.assert_allclose(pl.astype(np.float32), jl.astype(np.float32),
                                   rtol=0, atol=2**-10, err_msg=u.uid)
        np.testing.assert_allclose(pm.astype(np.float32), jm.astype(np.float32),
                                   rtol=0, atol=2**-10, err_msg=u.uid)
    # The JAX package reads the port's features.
    jl, jm = jcache.AudioCache(tmp_path / "port", jcfg).get_features(utts[0].uid, jcfg)
    np.testing.assert_array_equal(jm, reopened.get_features(utts[0].uid, pcfg)[1])


def test_compute_statistics_matches_jax(corpora):
    jcfg, pcfg = _pair("ljspeech", corpora["ljspeech"])
    utts = _utts(jcfg, pcfg)
    ref = jax_statistics([jlj.Utterance(u.uid, u.wav_path, u.text) for u in utts], jcfg)
    got = port_statistics(utts, pcfg, device="cpu")
    assert set(got) == set(ref)
    assert got["n_utterances"] == ref["n_utterances"] == 12
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("kind", ["ljspeech", "csv", "blizzard_nancy", "css10", "synthetic"])
def test_load_corpus_each_kind(corpora, kind):
    root = corpora[{"csv": "ljspeech"}.get(kind, kind)] if kind != "synthetic" else ""
    jcfg, pcfg = _pair(kind, root, synthetic_size=24)
    jtr, jev = jtrain.load_corpus(jcfg)
    ptr, pev = ptrain.load_corpus(pcfg)
    assert _records(ptr) == _records(jtr)
    assert _records(pev) == _records(jev)
    assert ptr and pev


def test_load_corpus_refuses_an_unknown_kind():
    _, pcfg = _pair("nope", "")
    with pytest.raises(ValueError, match="unknown dataset kind"):
        ptrain.load_corpus(pcfg)
