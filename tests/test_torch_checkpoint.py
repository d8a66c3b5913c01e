"""Checkpoints of the port: a save and restore round trip, the config
fingerprint guard, the EMA adaptation both ways, serving from a
checkpoint, the training driver's resume, and the weight bridge back to
the flax layout."""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from torch_parity import jax_variables, tiny_pair

from sstts_torch import train as ptrain
from sstts_torch.checkpoint import CheckpointManager, config_from_dict, load_params
from sstts_torch.convert import convert_params, to_flax
from sstts_torch.synthesize import Synthesizer


@pytest.fixture(scope="module", autouse=True)
def _no_tensorboard():
    """`train`'s logger would import TensorFlow for TensorBoard where it is
    installed (~16 s a process); the records in metrics.jsonl are what is
    tested."""
    from sstts_torch.utils import logging as plogging

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plogging, "_tensorboard_writer", lambda logdir: None)
        yield


def _cfg(**training):
    _, pcfg = tiny_pair(
        dataset={"dataset": "synthetic", "synthetic_size": 24},
        arch={"prenet_dropout_at_inference": False, "reduction_factor": 4},
        training={"batch_size": 2, "text_buckets": (96,), "frame_buckets": (400,),
                  "checkpoint_every": 2, "summary_every": 1, **training},
        evaluation={"eval_every": 2, "num_eval_batches": 1, "batch_size": 2},
        inference={"max_decoder_steps": 6, "stop_threshold": 1.1},
    )
    return pcfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three driver steps on the CPU (checkpoints at steps 2 and 3)."""
    workdir = tmp_path_factory.mktemp("run")
    cfg = _cfg()
    state = ptrain.train(cfg, workdir, max_steps=3, device="cpu")
    return cfg, workdir, state


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i in oa["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(oa["state"][i][k], ob["state"][i][k], rtol=0, atol=0)
    assert a.step == b.step


def test_driver_logs_checkpoints_and_evaluates(trained):
    cfg, workdir, state = trained
    assert state.step == 3
    lines = [json.loads(x) for x in (workdir / "metrics.jsonl").read_text().splitlines()]
    train_lines = [x for x in lines if x["prefix"] == "train"]
    assert [x["step"] for x in train_lines] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in train_lines)
    assert any(x["prefix"] == "eval" and "loss" in x for x in lines)
    mgr = CheckpointManager(cfg, workdir)
    assert mgr.latest_step() == 3


def test_restore_gives_the_saved_state(trained):
    cfg, workdir, state = trained
    fresh = ptrain.create_state(cfg, seed=99, device="cpu")
    assert CheckpointManager(cfg, workdir).restore_latest(fresh) == 3
    _same_state(fresh, state)


def test_driver_resumes_where_it_stopped(trained, tmp_path):
    """A run stopped at step 3 and resumed to 4 ends in the state of an
    uninterrupted run to 4: the resume continues the data order and the
    dropout stream."""
    cfg, workdir, _ = trained
    shutil.copytree(workdir, tmp_path / "resumed")
    resumed = ptrain.train(cfg, tmp_path / "resumed", max_steps=4, device="cpu")
    straight = ptrain.train(cfg, tmp_path / "straight", max_steps=4, device="cpu")
    assert CheckpointManager(cfg, tmp_path / "resumed").latest_step() == 4
    _same_state(resumed, straight)


def test_fingerprint_guard_refuses_another_config(trained):
    cfg, workdir, _ = trained
    other = cfg.replace(arch=dataclasses.replace(cfg.arch, decoder_gru_units=48))
    with pytest.raises(ValueError, match="different config"):
        CheckpointManager(other, workdir)
    with pytest.raises(ValueError, match="different config"):
        load_params(workdir, other)
    # Training-only fields stay free.
    free = cfg.replace(training=dataclasses.replace(cfg.training, learning_rate=1e-4))
    CheckpointManager(free, workdir)


def test_ema_adapts_both_ways(tmp_path):
    plain_cfg, ema_cfg = _cfg(), _cfg(ema_decay=0.9)
    plain = ptrain.create_state(plain_cfg, device="cpu")
    CheckpointManager(plain_cfg, tmp_path / "a").save(1, plain)
    target = ptrain.create_state(ema_cfg, seed=5, device="cpu")
    CheckpointManager(ema_cfg, tmp_path / "a").restore_latest(target)
    for n, p in target.model.named_parameters():  # seeded from the params
        torch.testing.assert_close(target.ema_params[n], p.detach(), rtol=0, atol=0)
    ema = ptrain.create_state(ema_cfg, device="cpu")
    ema.ema_params = {n: v + 1.0 for n, v in ema.ema_params.items()}
    CheckpointManager(ema_cfg, tmp_path / "b").save(1, ema)
    target = ptrain.create_state(plain_cfg, device="cpu")
    assert target.ema_params is None
    CheckpointManager(plain_cfg, tmp_path / "b").restore_latest(target)
    for n in ema.ema_params:  # kept for inference.use_ema
        torch.testing.assert_close(target.ema_params[n], ema.ema_params[n], rtol=0, atol=0)
    use_ema = plain_cfg.replace(inference=dataclasses.replace(plain_cfg.inference, use_ema=True))
    _, params = load_params(tmp_path / "b", use_ema)
    for n, v in ema.ema_params.items():
        torch.testing.assert_close(params[n], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="ema"):
        load_params(tmp_path / "a", use_ema)


def test_from_checkpoint_synthesizes_the_same_audio(trained):
    cfg, workdir, state = trained
    texts = ["the quick brown fox", "over the dog"]
    direct = Synthesizer(cfg, state.model.state_dict(), device="cpu").synthesize_batch(texts)
    loaded = Synthesizer.from_checkpoint(workdir, device="cpu")
    assert loaded.cfg == cfg  # the stored config, rebuilt
    got = loaded.synthesize_batch(texts)
    for a, b in zip(got, direct):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        Synthesizer.from_checkpoint(workdir / "nothing", device="cpu")


def test_config_round_trips_through_a_dict():
    cfg = _cfg()
    assert config_from_dict(dataclasses.asdict(cfg)) == cfg


def test_to_flax_inverts_convert_params():
    jcfg, pcfg = tiny_pair()
    v = jax_variables(jcfg, seed=4)
    sd = convert_params(v["params"], v["batch_stats"], pcfg)
    params, stats = to_flax(sd)
    for tree, ref in ((params, v["params"]), (stats, v["batch_stats"])):
        flat = jax.tree_util.tree_leaves_with_path(ref)
        assert len(flat) == len(jax.tree.leaves(tree))
        for path, r in flat:
            node = tree
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, r, err_msg=jax.tree_util.keystr(path))
    back = convert_params(params, stats, pcfg)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
