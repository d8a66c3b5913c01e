"""`python -m sstts_torch.cli train --set training.model_parallel=2` on the
CPU: four gloo ranks (`main(..., n_devices=4)`, the reference's layout rule gives
data 2 x model 2) train a tiny LJSpeech-layout corpus written to disk
from the resident corpus, two steps in one grouped call
(`steps_per_call=2`) and a third as a single cached step (the budget's
clamp), and equal one device's training of the same corpus (the same
batches, init and dropout: the training loop and its data order are
rank-independent).  Only rank 0 writes `metrics.jsonl` and the
checkpoints.  Tolerances as in tests/test_torch_mesh_train.py: the logged
losses and gradient norms within rtol 1e-5 at steps 1 and 2; Adam carries
last-bit differences of near-zero gradients into every later step, so
step 3 and the evaluation within 1e-4, and the parameters within 1e-5
relative L2 where the first moment is above 1e-5.  The launch's clock is
made to run 3600 times fast: a mesh's training run has no deadline, and
outlives its collectives' timeout.  No JAX here."""

import dataclasses
import json
import time
import types

import numpy as np
import pytest
import torch

from torch_mesh_helpers import rel_l2, write_ljspeech

from sstts_torch import cli as cli_mod
from sstts_torch import train as ptrain
from sstts_torch.checkpoint import CheckpointManager
from sstts_torch.config import Config, tiny_config
from sstts_torch.parallel import mesh as mesh_mod
from sstts_torch.utils import logging as plogging


def _tiny(corpus):
    cfg = tiny_config()
    return cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset, dataset="ljspeech", dataset_dir=str(corpus), eval_fraction=0.3,
        ),
        arch=dataclasses.replace(cfg.arch, prenet_dropout=0.5),
        training=dataclasses.replace(
            cfg.training, batch_size=2, text_buckets=(32,), frame_buckets=(160,),
            checkpoint_every=2, summary_every=1, learning_rate=2e-4, steps_per_call=2,
        ),
        evaluation=dataclasses.replace(cfg.evaluation, batch_size=2, num_eval_batches=1),
    )


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    corpus = write_ljspeech(root / "corpus", 12, tiny_config().dataset)
    cfg = _tiny(corpus)
    clock = {"launches": []}

    def spy(*args, **kw):
        clock["launches"].append(kw)
        return launch(*args, **kw)

    launch = mesh_mod.launch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_mod, "Config", lambda **kw: Config(**kw) if kw else cfg)
        mp.setattr(plogging, "_tensorboard_writer", lambda logdir: None)
        mp.setattr(mesh_mod, "time",
                   types.SimpleNamespace(monotonic=lambda: 3600.0 * time.monotonic()))
        mp.setattr(mesh_mod, "launch", spy)
        t0 = time.monotonic()
        rc = cli_mod.main(
            ["train", "--workdir", str(root / "mesh"), "--max-steps", "3",
             "--set", "training.model_parallel=2"],
            device="cpu", n_devices=4,
        )
        clock["seconds"] = 3600.0 * (time.monotonic() - t0)
        one = ptrain.train(cfg, root / "one", max_steps=3, device="cpu")
    return cfg, rc, root, one, clock


def _records(workdir):
    return [json.loads(x) for x in (workdir / "metrics.jsonl").read_text().splitlines()]


def test_cli_trains_on_a_2x2_mesh_of_gloo_ranks(runs):
    cfg, rc, root, _, _ = runs
    assert rc == 0
    assert ptrain.mesh_layout(
        cfg.replace(training=dataclasses.replace(cfg.training, model_parallel=2)), 4
    ) == (2, 2)
    train = [r for r in _records(root / "mesh") if r["prefix"] == "train"]
    # Rank 0 alone writes; a grouped call logs once, at its last step.
    assert [r["step"] for r in train] == [2, 3]
    assert [r["prefix"] for r in _records(root / "mesh")].count("eval") == 1
    ckpts = sorted(p.name for p in (root / "mesh" / cfg.training.checkpoint_dir).glob("*.pt"))
    assert ckpts == ["step_2.pt", "step_3.pt"]


def test_cli_mesh_run_equals_one_device(runs):
    cfg, _, root, one, _ = runs
    mesh, ref = _records(root / "mesh"), _records(root / "one")
    assert [(r["prefix"], r["step"]) for r in mesh] == [(r["prefix"], r["step"]) for r in ref]
    for got, want in zip(mesh, ref):
        for k in ("loss", "grad_norm", "loss_mel", "loss_linear", "loss_stop"):
            if k in want:
                rtol = 1e-5 if got["prefix"] == "train" and got["step"] <= 2 else 1e-4
                np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=(got["step"], k))
    state = ptrain.create_state(cfg, device="cpu")
    assert CheckpointManager(cfg, root / "mesh").restore_latest(state) == 3
    got = {n: p.detach() for n, p in state.model.named_parameters()}
    want = {n: p.detach() for n, p in one.model.named_parameters()}
    select = {n: one.optimizer.state[p]["exp_avg"].abs() > 1e-5
              for n, p in one.model.named_parameters()}
    assert rel_l2(got, want, select) <= 1e-5
    assert rel_l2(dict(state.model.named_buffers()), dict(one.model.named_buffers())) <= 1e-5


def test_cli_mesh_run_has_no_deadline(runs):
    """`train()` launches with no deadline on the run and 30 minutes on a
    collective; on the launch's clock the run lasted hours, past both (a
    600 s deadline would have stopped it)."""
    _, rc, _, _, clock = runs
    assert rc == 0
    (kw,) = clock["launches"]
    assert kw["timeout"] is None
    assert kw["collective_timeout"] == ptrain.COLLECTIVE_TIMEOUT_S >= 1800.0
    assert clock["seconds"] > ptrain.COLLECTIVE_TIMEOUT_S + 600.0
