"""Data-parallel synthesis (`Synthesizer(mesh=..., partition=...)`) on a
mesh of this process's devices, held to one device on the CPU; the
behaviour of the reference's `tests/test_synthesize.py:188-320`.

Each shard runs the whole pipeline on its rows, so a shard's numbers
differ from one device's only where a product's blocking depends on the
batch: the waveforms, mel and linear spectrograms within atol 1e-5 (the
largest seen is ~3e-7 on the spectrograms), the frame and sample counts
exact.  No JAX here."""

import dataclasses

import numpy as np
import pytest
import torch

from sstts_torch.config import tiny_config
from sstts_torch.data.text import split_sentences
from sstts_torch.model.tacotron import init_state_dict
from sstts_torch.parallel.mesh import Mesh, make_mesh
from sstts_torch.synthesize import Synthesizer

TEXTS = ["hello world", "abc", "a longer one to speak", "x", "two words", "mesh"]


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    return cfg, init_state_dict(cfg.arch, cfg.dataset, 0)


def _mesh(n):
    return make_mesh(devices=[torch.device("cpu")] * n)


def _synth(cfg, params, mesh=None, partition="gspmd", seed=3, **arch):
    if arch:
        cfg = cfg.replace(arch=dataclasses.replace(cfg.arch, **arch))
    return Synthesizer(cfg, params, seed=seed, device="cpu", mesh=mesh, partition=partition)


@pytest.mark.parametrize("n", [2, 3, 6])
def test_gspmd_mesh_equals_one_device(setup, n):
    """Prenet dropout on at inference: the keep masks are one draw for the
    global batch, sliced, so the mesh gives one device's output."""
    cfg, params = setup
    assert cfg.arch.prenet_dropout_at_inference
    w1, f1 = _synth(cfg, params).synthesize_batch(TEXTS, full_output=True)
    synth = _synth(cfg, params, _mesh(n))
    assert len(synth.models) == n and synth.partition == "gspmd"
    w2, f2 = synth.synthesize_batch(TEXTS, full_output=True)
    assert set(f2) == set(f1)
    for k in ("n_frames", "n_samples", "wav_wire"):
        np.testing.assert_array_equal(f2[k], f1[k], err_msg=k)
    for k in ("wav", "mel", "linear", "alignments"):
        assert f2[k].shape == f1[k].shape
        np.testing.assert_allclose(f2[k], f1[k], atol=1e-5, err_msg=k)
    for a, b in zip(w1, w2):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-5)


def test_every_shard_keeps_the_global_text_width(setup, monkeypatch):
    cfg, params = setup
    synth = _synth(cfg, params, _mesh(2))
    widths = []
    run = synth._run_shard

    def spy(i, ids, max_steps, keep):
        widths.append((i, ids.shape))
        return run(i, ids, max_steps, keep)

    monkeypatch.setattr(synth, "_run_shard", spy)
    synth.synthesize_batch(["a", "b", "a longer sentence than the rest", "c"])
    assert widths == [(0, (2, 32)), (1, (2, 32))]


def test_shard_map_shards_draw_their_own_streams(setup):
    """"shard_map": each shard's stream is the seed folded with its index,
    so one text in row 0 of two shards decodes two ways; the same seed
    gives the same output again; with dropout off at inference it is one
    device's output."""
    cfg, params = setup
    texts = ["same text"] * 4
    synth = _synth(cfg, params, _mesh(2), "shard_map")
    _, f = synth.synthesize_batch(texts, full_output=True)
    assert not np.array_equal(f["mel"][0], f["mel"][2])
    assert not np.array_equal(f["mel"][0], f["mel"][1])
    _, again = _synth(cfg, params, _mesh(2), "shard_map").synthesize_batch(texts, full_output=True)
    np.testing.assert_array_equal(again["mel"], f["mel"])
    _, gspmd = _synth(cfg, params, _mesh(2)).synthesize_batch(texts, full_output=True)
    assert not np.array_equal(gspmd["mel"], f["mel"])
    _, off = _synth(cfg, params, _mesh(2), "shard_map",
                    prenet_dropout_at_inference=False).synthesize_batch(texts, full_output=True)
    _, one = _synth(cfg, params, prenet_dropout_at_inference=False).synthesize_batch(
        texts, full_output=True)
    np.testing.assert_allclose(off["mel"], one["mel"], atol=1e-5)


def test_shard_map_keeps_the_stop_token_trim(setup):
    """The reference's shard_map contract: every waveform finite, non-empty,
    a whole number of hops, at most max_decoder_steps' worth; the stream
    goes through the same shards."""
    cfg, params = setup
    synth = _synth(cfg, params, _mesh(2), "shard_map")
    r, hop = cfg.arch.reduction_factor, cfg.dataset.hop_len
    max_len = (cfg.inference.max_decoder_steps * r - 1) * hop
    for a in synth.synthesize_batch(["hello world"] * 4):
        assert np.isfinite(a).all() and 0 < len(a) <= max_len and len(a) % hop == 0
    outs = list(synth.synthesize_stream([["hello world"] * 4] * 2, depth=1))
    assert [len(o) for o in outs] == [4, 4]


def test_stream_on_a_mesh_equals_its_batches(setup):
    cfg, params = setup
    batches = [TEXTS[:4], TEXTS[2:]]
    streamed = list(_synth(cfg, params, _mesh(2)).synthesize_stream(batches, depth=2))
    single = _synth(cfg, params, _mesh(2))
    for texts, got in zip(batches, streamed):
        for g, w in zip(got, single.synthesize_batch(texts)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,want", [(2, 4), (3, 6), (4, 4)])
def test_longform_batch_rounds_up_to_the_data_axis(setup, monkeypatch, n, want):
    """Three chunks pad to the next power of two, 4, then up to a multiple
    of the data axis (`sstts/synthesize.py:674`); every chunk comes back."""
    cfg, params = setup
    synth = _synth(cfg, params, _mesh(n))
    text = "one sentence. two sentences! three now."
    assert len(split_sentences(text, 15)) == 3
    sizes = []
    batch = synth.synthesize_batch

    def spy(texts, **kw):
        sizes.append(len(texts))
        return batch(texts, **kw)

    monkeypatch.setattr(synth, "synthesize_batch", spy)
    wav = synth.synthesize_longform(text, max_chars=15, gap_ms=50.0)
    assert sizes == [want]
    gap = int(cfg.dataset.sample_rate * 0.05)
    assert wav.ndim == 1 and len(wav) >= 2 * gap and np.isfinite(wav).all()


def test_longform_on_a_mesh_equals_one_device(setup):
    """With dropout off at inference, padding rows change nothing: the
    document on a 3-device mesh (6 rows) is the one-device one (4 rows)."""
    cfg, params = setup
    text = "one sentence. two sentences! three now."
    one = _synth(cfg, params, prenet_dropout_at_inference=False).synthesize_longform(
        text, max_chars=15)
    mesh = _synth(cfg, params, _mesh(3), prenet_dropout_at_inference=False).synthesize_longform(
        text, max_chars=15)
    assert mesh.shape == one.shape
    np.testing.assert_allclose(mesh, one, atol=1e-5)


def test_a_batch_that_does_not_split_is_refused(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="does not split over 2 data shards"):
        _synth(cfg, params, _mesh(2)).synthesize_batch(TEXTS[:3])


def test_mesh_arguments_are_checked(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="partition"):
        _synth(cfg, params, _mesh(2), "pjit")
    ranks = Mesh(np.arange(2, dtype=np.int64).reshape(2, 1), rank=0)
    with pytest.raises(ValueError, match="one device per rank"):
        _synth(cfg, params, ranks)
    # The model axis replicates inference: a 2 x 2 mesh runs 2 shards.
    grid = make_mesh(devices=[torch.device("cpu")] * 4, model_parallel=2)
    assert len(_synth(cfg, params, grid).models) == 2
