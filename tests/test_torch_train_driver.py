"""The port's training driver held to `sstts.train.train` on the CPU, and its
parts: the resume through grouped steps, the device-corpus modes, the
prefetch, `debug_nans`, the command line's training settings and the
overfit tool.

The driver-parity test runs both packages' `train` at the default
`device_corpus_cache="auto"` on the same synthetic corpus (one process:
the waveforms' noise follows Python's per-process hash, the same for
both), from the same init (the JAX init, converted), dropout off, for 4
steps at lr 2e-4.  Tolerances, those of a multi-step run in
`tests/test_torch_train.py`: every logged train loss and the final eval
losses within rtol 1e-3.  The final parameters: Adam's first updates are
about -lr * sign(g), so a gradient near 0 can flip sign between two
correct implementations, and a flipped parameter moves the other way by
up to ~1.01 lr a step (Cauchy-Schwarz on Adam's moment weights over 4
steps); so every parameter lies within 2.1 lr a step of JAX's (1.68e-3
after 4 steps) and the median difference is at most lr / 20 (1e-5).

The learning rate is that of tests/test_torch_train_driver_modes.py, a
tenth of the 2e-3 this test first ran at.  At 2e-3 it missed in 32 of 400
string-hash seeds (`tests/torch_driver_sweep.py`), by up to 4.6e-3 in a
step-4 loss; the trace of PYTHONHASHSEED=13: the step-1 losses agree to
1.8e-7, but one linear output of the first batch lies 1.8e-6 above its L1
target in the port and below it in JAX, so the L1 term's gradient there
flips sign; the step-1 gradients then differ by 7.7e-4 (relative L2, all
in the post-CBHG), 14 near-zero entries change sign, Adam moves those
parameters 2 lr apart, and the losses part by 2.6e-4, 1.5e-3 and 4.6e-3
over steps 2-4.  The port from an init moved by one ulp crosses the same
kink and parts from the port by the same amounts, and the port with that
one output moved across the kink in its first step stays within 1.7e-5 of
JAX at every record: f32 noise, no port line at fault.  Other seeds (21)
part later, where JAX itself parts by 7.5e-4 from a one-ulp move of its
init.  At 2e-4 none of the 400 seeds missed (largest loss difference
1.3e-4, parameters 8.3e-4 and median 1.1e-6 against their limits), and
the fault this test was written for (other batches than JAX's at "auto")
still fails it: the first logged loss by 1.6% (taken before any update,
at any rate) at steps_per_call=1, the logged steps at 2.

Torch runs on one thread in these modules: the tiny model gains nothing
from more, and a test suite with one process per core oversubscribes.
"""

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from torch_parity import tiny_pair

import sstts_torch.utils.logging as plog
from sstts import train as jtrain
from sstts_torch import cli
from sstts_torch import train as ptrain
from sstts_torch.convert import convert_params, to_flax
from sstts_torch.tools import overfit_demo

MAX_STEPS = 4
LR = 2e-3
#: The driver-parity test's learning rate (see the module docstring).
PARITY_LR = 2e-4


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(plog, "_tensorboard_writer", lambda logdir: None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(buckets=((32, 40), (128, 160)), **training):
    """A tiny corpus of ~12 synthetic utterances, in two buckets by default."""
    return tiny_pair(
        dataset={"dataset": "synthetic", "synthetic_size": 40, "max_text_len": 40},
        arch={"prenet_dropout": 0.0},
        training={"batch_size": 2, "text_buckets": buckets[0], "frame_buckets": buckets[1],
                  "learning_rate": LR, "summary_every": 1, "checkpoint_every": 100,
                  **training},
    )


def _records(workdir, prefix):
    lines = (workdir / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r["prefix"] == prefix]


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_driver_matches_jax_at_default_corpus_cache(tmp_path, monkeypatch, capsys,
                                                    steps_per_call):
    jcfg, pcfg = _pair(((40,), (160,)), steps_per_call=steps_per_call,
                       learning_rate=PARITY_LR)
    assert pcfg.training.device_corpus_cache == "auto"
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

    # Both drivers took the device-resident corpus ("auto": it fits).
    assert capsys.readouterr().out.count("utterances resident in HBM (1 buckets)") == 2

    got = to_flax(pstate.model.state_dict())[0]
    diffs = []
    for path, r in jax.tree_util.tree_leaves_with_path(jax.device_get(jstate.params)):
        g = got
        for k in path:
            g = g[k.key]
        diffs.append(np.abs(np.asarray(g) - np.asarray(r)).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2.1 * PARITY_LR * MAX_STEPS, diffs.max()
    assert np.median(diffs) <= PARITY_LR / 20, np.median(diffs)


def test_grouped_resume_lands_on_max_steps(tmp_path):
    """S=3: the budget tail runs as singles (7 = 3 + 3 + 1 or any mix), and
    the resumed run (10) splits a grouped op that straddles its offset."""
    _, pcfg = _pair(steps_per_call=3, device_corpus_cache="on", checkpoint_every=5)
    state = ptrain.train(pcfg, tmp_path, max_steps=7, device="cpu", log_every=2)
    assert state.step == 7
    state = ptrain.train(pcfg, tmp_path, max_steps=10, device="cpu", log_every=2)
    assert state.step == 10
    steps = [r["step"] for r in _records(tmp_path, "train")]
    assert steps == sorted(steps) and steps[-1] == 10


def test_resume_skip_splits_straddling_grouped_op(capsys):
    idxs = np.arange(8, dtype=np.int32).reshape(8, 1)
    valids = np.ones((8, 1), np.float32)
    ops = [("single", 16, np.array([9], np.int32), np.array([1.0], np.float32)),
           ("grouped", 16, idxs, valids)]
    out = list(ptrain._skip_epoch_steps(iter(ops), 5))
    assert [o[0] for o in out] == ["single"] * 4
    np.testing.assert_array_equal(np.concatenate([o[2] for o in out]), idxs[4:].ravel())
    assert "re-emitting 4 of its 8 steps as singles" in capsys.readouterr().out
    assert [o[0] for o in ptrain._skip_epoch_steps(iter(ops), 1)] == ["grouped"]
    out = list(ptrain._skip_epoch_steps(iter(ops), 8))
    assert [o[0] for o in out] == ["single"] and int(out[0][2][0]) == 7


def test_corpus_cache_on_over_budget_raises_and_auto_host_feeds(tmp_path, capsys):
    _, on = _pair(device_corpus_cache="on", device_corpus_budget_mb=0)
    with pytest.raises(ValueError, match="device_corpus_cache=on but corpus exceeds"):
        ptrain.train(on, tmp_path / "on", max_steps=1, device="cpu")
    _, auto = _pair(device_corpus_budget_mb=0, steps_per_call=2)
    state = ptrain.train(auto, tmp_path / "auto", max_steps=3, device="cpu")
    out = capsys.readouterr().out
    assert "device corpus cache disabled: corpus exceeds the 0 MiB device budget" in out
    assert "falling back to single-step dispatch because the corpus is host-fed" in out
    assert state.step == 3
    assert [r["step"] for r in _records(tmp_path / "auto", "train")] == [1, 2, 3]


def test_host_fed_resume_continues_the_batcher_order(tmp_path):
    """"off" feeds `Batcher.epoch`, as the JAX driver does; a run of 3 then
    5 steps ends where one run of 5 does."""
    _, off = _pair(device_corpus_cache="off")
    whole = ptrain.train(off, tmp_path / "whole", max_steps=5, device="cpu")
    ptrain.train(off, tmp_path / "parts", max_steps=3, device="cpu")
    parts = ptrain.train(off, tmp_path / "parts", max_steps=5, device="cpu")
    for a, b in zip(whole.model.parameters(), parts.model.parameters()):
        assert torch.equal(a, b)


def test_prefetch_keeps_order_and_content():
    """The worker thread pulls and builds the items itself, in order, at
    most depth + 1 ahead; on the CPU the prefetch passes batches through."""
    items = [(i % 3, {"x": np.full((2, 3), i, np.int32)}) for i in range(9)]
    pulled, threads = [], set()

    def source():
        for item in items:
            pulled.append(item[0])
            yield item

    def put(item):
        threads.add(threading.get_ident())
        return item[0], {k: v.copy() for k, v in item[1].items()}

    out = []
    for n, got in enumerate(ptrain._read_ahead(source(), put, depth=2)):
        assert len(pulled) <= n + 3
        out.append(got)
    assert threads and threading.get_ident() not in threads
    assert [b for b, _ in out] == [b for b, _ in items]
    for (_, g), (_, r) in zip(out, items):
        np.testing.assert_array_equal(g["x"], r["x"])
    assert list(ptrain._prefetch_to_device(iter(items), "cpu")) == items
    # Closing early stops the worker.
    gen = ptrain._read_ahead(source(), put, depth=2)
    next(gen)
    gen.close()


def _nan_setup():
    jcfg, pcfg = _pair()
    init = jtrain.create_state(jcfg)
    params = jax.tree.map(np.asarray, jax.device_get(init.params))
    stats = jax.tree.map(np.asarray, jax.device_get(init.batch_stats))
    built, reason = ptrain.build_device_corpus(
        pcfg, ptrain.load_corpus(pcfg)[0], device="cpu")
    assert built is not None, reason
    corpus, counts = built
    bucket = min(counts)
    batch = {k: v.numpy()[:2] for k, v in corpus[bucket].items()}
    return jcfg, pcfg, init, params, stats, batch


def test_debug_nans_raises_in_both_packages_and_changes_nothing_when_clean():
    jcfg, pcfg, init, params, stats, batch = _nan_setup()
    dcfg = pcfg.replace(training=dataclasses.replace(pcfg.training, debug_nans=True))

    def port_state(p):
        state = ptrain.create_state(pcfg, device="cpu")
        state.model.load_state_dict(convert_params(p, stats, pcfg))
        return state

    # Clean parameters: the step with the flag equals the step without it.
    plain, guarded = port_state(params), port_state(params)
    m0 = ptrain.make_train_step(pcfg)(plain, batch)
    m1 = ptrain.make_train_step(dcfg)(guarded, batch)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(plain.model.parameters(), guarded.model.parameters()):
        assert torch.equal(a, b)

    # A NaN planted in the encoder's embedding.
    bad = jax.tree.map(np.copy, params)
    emb = next(k for k in bad if "embed" in k.lower())
    leaf = next(iter(bad[emb]))
    bad[emb][leaf][3, 0] = np.nan
    with pytest.raises(FloatingPointError, match="NaN"):
        ptrain.make_train_step(dcfg)(port_state(bad), batch)
    jstate = init.replace(params=jax.tree.map(jax.numpy.asarray, bad))
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jtrain.make_train_step(jcfg)(jstate, batch))


def test_debug_nans_backward_anomaly_is_a_floating_point_error():
    """A NaN that only the backward makes (sqrt's gradient at 0 times an
    infinite weight is fine forward) surfaces as FloatingPointError."""
    model = torch.nn.Linear(2, 1)
    with torch.no_grad():
        model.weight.fill_(1.0)
        model.bias.fill_(0.0)
    x = torch.zeros(1, 2)
    with pytest.raises(FloatingPointError, match="nan values"):
        with ptrain._debug_nans(model, step=7):
            y = torch.sqrt(model(x)).sum()
            y.backward()


@pytest.mark.parametrize("sets", [
    ["training.steps_per_call=4", "training.device_corpus_cache=on",
     "training.feature_fft_impl=dft_highest"],
    ["training.device_corpus_format=features", "training.feature_fft_impl=dft_high"],
    ["training.device_corpus_format=features_bf16", "training.steps_per_call=3"],
    ["training.feature_fft_impl=dft_default", "training.debug_nans=true"],
], ids=["grouped-on-dft_highest", "features-dft_high", "features_bf16-grouped",
        "dft_default-debug_nans"])
def test_cli_train_takes_the_corpus_settings(tmp_path, monkeypatch, sets):
    """`python -m sstts_torch.cli train --set ...` with the settings the
    port refused before, on the tiny config (`Config()` in the CLI), lands
    exactly on --max-steps."""
    _, pcfg = _pair()
    monkeypatch.setattr(cli, "Config", lambda **kw: type(pcfg)(**kw) if kw else pcfg)
    argv = ["train", "--workdir", str(tmp_path), "--max-steps", "5",
            "--set", "evaluation.eval_every=100000"]
    assert cli.main(argv + [x for o in sets for x in ("--set", o)], device="cpu") == 0
    steps = [r["step"] for r in _records(tmp_path, "train")]
    assert steps[-1] == 5 and steps == sorted(steps)


def test_overfit_tool_loss_falls():
    cfg = overfit_demo.demo_config(1, spec=True)
    from sstts_torch.data.synthetic import make_utterances

    utts = make_utterances(1, cfg.dataset, min_words=2, max_words=3)
    state, _, history = overfit_demo.overfit(cfg, utts, 6, spec=True, device="cpu",
                                             every=1, log=lambda msg: None)
    losses = [m["loss"] for _, m in history]
    assert state.step == 6 and len(losses) == 6
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
