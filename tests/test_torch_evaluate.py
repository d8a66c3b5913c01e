"""The port's evaluation held to `sstts/evaluate.py` on the CPU, and its
metrics logger to `sstts/utils/logging.py`.

Both sides evaluate the same JAX init (perturbed batch-norm statistics,
converted with `sstts_torch.convert`) at `tiny_config` with the prenets'
dropout at rate 0, on the same synthetic corpus in one process (so the
same waveforms).  Tolerances: `evaluate_state`'s losses within rtol 1e-5;
`resynthesis_metrics`' mel-L1 within 1e-4 and its relative length error
equal (the waveforms are not compared: on the CPU the JAX package runs the
bf16 Griffin-Lim loop as "split" and the port as "semi", ROADMAP C); the
`sstts_torch.dsp.metrics` functions within 1e-6 of their originals; the
logger's records equal but for `wall_s`.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_parity import jax_variables, tiny_pair

from sstts import evaluate as jeval
from sstts import train as jtrain
from sstts.dsp import metrics as jmetrics
from sstts.utils.logging import MetricsLogger as JaxLogger
from sstts_torch import evaluate as peval
from sstts_torch import train as ptrain
from sstts_torch.checkpoint import CheckpointManager
from sstts_torch.convert import convert_params
from sstts_torch.data import pipeline as ppipe
from sstts_torch.dsp import metrics as pmetrics
from sstts_torch.utils import logging as plogging


@pytest.fixture(autouse=True)
def _no_tensorboard(request, monkeypatch):
    """TensorBoard imports TensorFlow where it is installed (~16 s a
    process); only the test of the event files writes them."""
    if "tensorboard" not in request.node.name:
        monkeypatch.setattr(plogging, "_tensorboard_writer", lambda logdir: None)


def _pair(**inference):
    return tiny_pair(
        dataset={"dataset": "synthetic", "synthetic_size": 40, "eval_fraction": 0.3,
                 "max_text_len": 96},
        arch={"prenet_dropout": 0.0},
        training={"batch_size": 2, "text_buckets": (48, 96), "frame_buckets": (160, 320)},
        evaluation={"batch_size": 4},
        inference=inference,
    )


@pytest.fixture(scope="module")
def states():
    jcfg, pcfg = _pair()
    v = jax_variables(jcfg)
    # evaluate_state and resynthesis_metrics read the variables alone.
    jstate = jtrain.TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                               opt_state=None)
    pstate = ptrain.create_state(pcfg, device="cpu")
    pstate.model.load_state_dict(convert_params(v["params"], v["batch_stats"], pcfg))
    return jcfg, pcfg, jstate, pstate


def test_evaluate_state_matches_jax(states):
    jcfg, pcfg, jstate, pstate = states
    ref = jeval.evaluate_state(jcfg, jstate, num_batches=2)
    got = peval.evaluate_state(pcfg, pstate, num_batches=2)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


def test_resynthesis_metrics_match_jax(states):
    jcfg, pcfg, jstate, pstate = states
    ref = jeval.resynthesis_metrics(jcfg, jstate)
    got = peval.resynthesis_metrics(pcfg, pstate)
    assert set(got) == set(ref)
    assert got["resynthesis_utterances"] == ref["resynthesis_utterances"] == 8
    assert np.isfinite(ref["resynthesis_mel_l1"])
    np.testing.assert_allclose(got["resynthesis_mel_l1"], ref["resynthesis_mel_l1"],
                               rtol=0, atol=1e-4)
    assert got["resynthesis_len_rel_err"] == ref["resynthesis_len_rel_err"]


def test_empty_eval_split_raises(states):
    _, pcfg, _, pstate = states
    cfg = pcfg.replace(dataset=dataclasses.replace(pcfg.dataset, dataset="ljspeech",
                                                   dataset_dir="/nonexistent"))
    with pytest.raises(FileNotFoundError):
        peval.evaluate_state(cfg, pstate)
    cfg = pcfg.replace(training=dataclasses.replace(pcfg.training, text_buckets=(4,)))
    with pytest.raises(ValueError, match="no batches"):
        peval.evaluate_state(cfg, pstate)


def _mel_pair(seed, shape=(3, 40, 20)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0.0, 0.05, shape), 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("name", ["mcd_db", "mcd_from_normalized_mel",
                                  "peak_masked_l1_db", "spectral_snr_db"])
def test_quality_metrics_match(name):
    a, b = _mel_pair(11)
    if name in ("mcd_db", "peak_masked_l1_db"):
        a, b = a * 100.0 - 100.0, b * 100.0 - 100.0
    got = getattr(pmetrics, name)(a, b)
    ref = getattr(jmetrics, name)(a, b)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        getattr(pmetrics, name)(a, b[:, 1:])


def test_metrics_logger_records_match_jax(tmp_path, capsys):
    metrics = {"loss": np.float32(0.53125), "lr": 1e-3, "count": 3,
               "grad_norm": torch.tensor(2.5), "note": "text"}
    lines = {}
    for name, cls in (("jax", JaxLogger), ("port", plogging.MetricsLogger)):
        logger = cls(tmp_path / name, use_tensorboard=False)
        logger.log(7, metrics, prefix="eval")
        logger.log(8, {"loss": 0.25})
        logger.log_image(8, "eval/mel", np.zeros((4, 4, 3), np.uint8))
        logger.log_audio(8, "eval/audio", np.zeros(100), 8000)
        logger.close()
        lines[name] = capsys.readouterr().out
    assert lines["port"] == lines["jax"]
    assert "[eval] step 7: loss=0.5312" in lines["port"]

    def records(name):
        out = [json.loads(x) for x in (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
        for r in out:
            assert isinstance(r.pop("wall_s"), float)
        return out

    assert records("port") == records("jax")
    assert records("port")[0] == {"step": 7, "prefix": "eval", "loss": 0.53125, "lr": 1e-3,
                                  "count": 3.0, "grad_norm": 2.5, "note": "text"}


def test_metrics_logger_writes_tensorboard_events(tmp_path):
    """Event files where torch.utils.tensorboard imports, none otherwise."""
    try:
        import torch.utils.tensorboard  # noqa: F401
        available = True
    except ImportError:
        available = False
    logger = plogging.MetricsLogger(tmp_path)
    logger.log(1, {"loss": 0.5})
    logger.log_image(1, "eval/mel", np.zeros((8, 6, 3), np.uint8))
    logger.log_audio(1, "eval/audio", np.full(800, 2.0, np.float32), 8000)
    logger.close()
    events = list((tmp_path / "tb").glob("events.out.tfevents*"))
    assert bool(events) == available
    assert all(e.stat().st_size > 0 for e in events)


def test_eval_media_logs_images_and_audio(states, capsys):
    """`train`'s eval media: the alignment and mel images and the
    Griffin-Lim audio of an eval batch's first row; a failure is printed,
    never raised."""
    _, pcfg, _, pstate = states
    batcher = ppipe.Batcher(ptrain.load_corpus(pcfg)[1], pcfg)
    _, out = ptrain.make_eval_step(pcfg)(pstate, next(batcher.epoch(0, 2))[1])

    class Recorder:
        def __init__(self):
            self.images, self.audio = [], []

        def log_image(self, step, tag, image):
            self.images.append((tag, np.asarray(image)))

        def log_audio(self, step, tag, wav, sample_rate):
            self.audio.append((tag, np.asarray(wav), sample_rate))

    rec = Recorder()
    ptrain._log_eval_media(rec, 3, pcfg, out)
    if _has_matplotlib():
        assert [t for t, _ in rec.images] == ["eval/alignment", "eval/mel"]
        assert all(im.ndim == 3 and im.shape[2] == 3 and im.dtype == np.uint8
                   for _, im in rec.images)
        [(tag, wav, sr)] = rec.audio
        assert tag == "eval/audio" and sr == pcfg.dataset.sample_rate
        assert wav.shape == ((out["linear"].shape[1] - 1) * pcfg.dataset.hop_len,)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 0
    else:
        assert "matplotlib" in capsys.readouterr().out
    ptrain._log_eval_media(rec, 3, pcfg, {"alignments": None})
    assert "eval media logging failed" in capsys.readouterr().out


def _save(cfg, state, workdir, step=3):
    CheckpointManager(cfg, workdir).save(step, state)


def test_evaluate_writes_wavs_and_an_eval_record(states, tmp_path):
    _, pcfg, _, pstate = states
    _save(pcfg, pstate, tmp_path)
    got = peval.evaluate(pcfg, tmp_path, num_batches=1, synthesize_count=2, device="cpu")
    assert np.isfinite(got["loss"]) and np.isfinite(got["resynthesis_mel_l1"])
    np.testing.assert_allclose(
        got["loss"], peval.evaluate_state(pcfg, pstate, 1)["loss"], rtol=1e-6
    )
    records = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 1
    assert records[0]["prefix"] == "eval" and records[0]["step"] == 3
    assert records[0]["resynthesis_mel_l1"] == pytest.approx(got["resynthesis_mel_l1"])
    eval_utts = ptrain.load_corpus(pcfg)[1][:2]
    out = tmp_path / pcfg.inference.output_dir
    for u in eval_utts:
        assert (out / f"eval_{u.uid}.wav").stat().st_size > 44
    if _has_matplotlib():
        assert (out / f"eval_{eval_utts[0].uid}_alignment.png").exists()
    with pytest.raises(FileNotFoundError):
        peval.evaluate(pcfg, tmp_path / "empty", device="cpu")


def _has_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def test_evaluate_use_ema_both_ways(states, tmp_path):
    """use_ema without a stored EMA tree raises; with one, every metric is
    that of the EMA weights."""
    _, pcfg, _, pstate = states
    use_ema = pcfg.replace(inference=dataclasses.replace(pcfg.inference, use_ema=True))
    _save(pcfg, pstate, tmp_path / "plain")
    with pytest.raises(ValueError, match="ema_params"):
        peval.evaluate(use_ema, tmp_path / "plain", num_batches=1, device="cpu")

    ema_cfg = use_ema.replace(training=dataclasses.replace(pcfg.training, ema_decay=0.5))
    state = ptrain.create_state(ema_cfg, device="cpu")
    state.model.load_state_dict(pstate.model.state_dict())
    state.ema_params = {n: p.detach() * 0.9 for n, p in state.model.named_parameters()}
    _save(ema_cfg, state, tmp_path / "ema")
    got = peval.evaluate(ema_cfg, tmp_path / "ema", num_batches=1, device="cpu")
    swapped = ptrain.create_state(ema_cfg, device="cpu")
    swapped.model.load_state_dict(pstate.model.state_dict())
    swapped.model.load_state_dict(state.ema_params, strict=False)
    want = peval.evaluate_state(ema_cfg, swapped, 1)
    want.update(peval.resynthesis_metrics(ema_cfg, swapped))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    plain = peval.evaluate_state(pcfg, pstate, 1)
    assert abs(got["loss"] - plain["loss"]) > 1e-4
