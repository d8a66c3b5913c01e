"""Both packages' `train` driven end to end in the corpus modes other than
the default: the host-fed Batcher (`device_corpus_cache="off"`) and the
resident corpus stored as features (`device_corpus_format="features"`).
Their steps are held one by one in tests/test_torch_train_corpus.py; here
the drivers, which choose the batches and their order, are held to each
other, as tests/test_torch_train_driver.py holds them at the default
"auto" with PCM16 rows.

The same set-up and tolerances as that module: one process (the synthetic
waveforms' noise follows Python's per-process hash), the JAX init
converted, dropout off, 4 steps; every logged train and eval loss within
rtol 1e-3; every final parameter within 2.1 lr a step of JAX's and their
median difference at most lr / 20.  The learning rate is 2e-4, a tenth of
that module's: Adam's first updates are about -lr * sign(g), so a
gradient near 0 whose sign differs between the packages moves its
parameter 2 lr the other way, and at 2e-3 that spread the later losses
past 1e-3 in about one batch order in ten ("off": a step-4 mel loss 1.5e-3
apart after a gradient norm 1.9% apart at step 3); the drift scales with
lr, and the fault these tests look for (other batches than JAX's) moves
the first logged loss by ~1.6% at any rate.  Torch runs on one thread.
"""

import json

import jax
import numpy as np
import pytest
import torch

from torch_parity import tiny_pair, tree_pairs

import sstts_torch.utils.logging as plog
from sstts import train as jtrain
from sstts_torch import train as ptrain
from sstts_torch.convert import convert_params, to_flax

MAX_STEPS = 4
LR = 2e-4


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(plog, "_tensorboard_writer", lambda logdir: None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _records(workdir, prefix):
    lines = (workdir / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r["prefix"] == prefix]


@pytest.mark.parametrize("training,resident", [
    ({"device_corpus_cache": "off"}, False),
    ({"device_corpus_format": "features"}, True),
], ids=["off", "features"])
def test_driver_matches_jax(tmp_path, monkeypatch, capsys, training, resident):
    jcfg, pcfg = tiny_pair(
        dataset={"dataset": "synthetic", "synthetic_size": 40, "max_text_len": 40},
        arch={"prenet_dropout": 0.0},
        training={"batch_size": 2, "text_buckets": (40,), "frame_buckets": (160,),
                  "learning_rate": LR, "summary_every": 1, "checkpoint_every": 100,
                  **training},
    )
    init = jtrain.create_state(jcfg)
    params0 = jax.tree.map(np.asarray, jax.device_get(init.params))
    stats0 = jax.tree.map(np.asarray, jax.device_get(init.batch_stats))
    converted = convert_params(params0, stats0, pcfg)
    monkeypatch.setattr(ptrain, "init_state_dict", lambda *a, **k: converted)
    # Media logging (plots, Griffin-Lim) is not what is compared here.
    monkeypatch.setattr(jtrain, "_log_eval_media", lambda *a, **k: None)
    monkeypatch.setattr(ptrain, "_log_eval_media", lambda *a, **k: None)
    jstate = jtrain.train(jcfg, tmp_path / "jax", max_steps=MAX_STEPS)
    pstate = ptrain.train(pcfg, tmp_path / "port", max_steps=MAX_STEPS, device="cpu")
    assert pstate.step == int(jstate.step) == MAX_STEPS

    for prefix in ("train", "eval"):
        ref, got = _records(tmp_path / "jax", prefix), _records(tmp_path / "port", prefix)
        assert [r["step"] for r in got] == [r["step"] for r in ref]
        assert got and got[-1]["step"] == MAX_STEPS
        for g, r in zip(got, ref):
            for k in ("loss", "loss_mel", "loss_linear", "loss_stop"):
                np.testing.assert_allclose(g[k], r[k], rtol=1e-3, err_msg=f"{prefix} {k}")

    # Both drivers took the same corpus mode.
    resident_lines = capsys.readouterr().out.count("utterances resident in HBM")
    assert resident_lines == (2 if resident else 0)

    got = to_flax(pstate.model.state_dict())[0]
    diffs = np.concatenate([
        np.abs(g - r).ravel()
        for _, g, r in tree_pairs(jax.device_get(jstate.params), got)
    ])
    assert diffs.max() <= 2.1 * LR * MAX_STEPS, diffs.max()
    assert np.median(diffs) <= LR / 20, np.median(diffs)
