"""Training on a ("data", "model") mesh (`sstts_torch.parallel.mesh`) held
to one device, in gloo processes on the CPU (`mesh.launch`: a FileStore
rendezvous in a temporary directory, torch pinned to one thread a rank,
every collective and the whole launch bounded by a timeout, so a dead rank
fails its test rather than the suite).

The same full init and the same global batches (ragged: the ranks' valid
frame counts differ) go through `tools/mesh_steps.run_steps` on one device
and on (2, 1) and (2, 2) layouts, with prenet dropout on (the keep masks
are drawn for the global batch and sliced).  Tolerances: every sum runs in
another order on a mesh (halves of the batch, partial products of the
tensor-parallel layers), in f32: the loss and the gradient norm within
rtol 1e-5 at both steps; the batch-norm running statistics and the Adam
moments within 1e-5 relative L2 over all their elements.  Adam's update
is about -lr * g / (|g| + eps): where |g| is at the gradients' f32 noise
(a tiny gradient made of large cancelling terms) a last-bit difference
moves the update by a visible part of lr, so the parameters are held to
1e-5 relative L2 over the elements whose first moment exceeds 1e-5
(|g| above ~1e-4, the rule of tests/test_torch_train.py), the others
through the moments.  The control: averaging per-rank masked means, the
naive data-parallel loss, misses the global loss by far more than these
tolerances on the same ragged batch.  The JAX package's own mesh step is
the reference in tests/test_torch_mesh_jax.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_mesh_helpers import TIMEOUT, mesh_cfg, rel_l2, seeded_batches

from sstts_torch import train as ptrain
from sstts_torch.checkpoint import CheckpointManager
from sstts_torch.config import tiny_config
from sstts_torch.model.losses import tacotron_loss
from sstts_torch.model.tacotron import init_state_dict
from sstts_torch.parallel import mesh as mesh_mod
from sstts_torch.tools.mesh_steps import run_steps

LAYOUTS = [(2, 1), (2, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = mesh_cfg()
    batches = seeded_batches(cfg, 2)
    params = init_state_dict(cfg.arch, cfg.dataset, 5)
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    out = {"cfg": cfg, "batches": batches, "params": params, "ckpt": ckpt,
           "one": run_steps(cfg, params, batches)}
    for data, model in LAYOUTS:
        out[(data, model)] = mesh_mod.launch(
            run_steps, data * model, cfg, params, batches, "cpu", (data, model), False,
            str(ckpt) if (data, model) == (2, 2) else None, timeout=TIMEOUT,
        )
    return out


def test_the_batch_is_ragged_across_ranks(runs):
    """Each rank's half of the batch has another count of loss frames, the
    case where a per-rank mean is not the global one."""
    for b in runs["batches"]:
        halves = [int(b["loss_frames"][s].sum()) for s in mesh_mod.row_slices(4, 2)]
        assert halves[0] != halves[1]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_layout_metrics_equal_one_device(runs, layout):
    one = runs["one"]["metrics"]
    for r in runs[layout]:
        assert len(r["metrics"]) == 2
        for got, ref in zip(r["metrics"], one):
            assert set(got) == set(ref)
            for k in ("loss", "grad_norm", "loss_mel", "loss_linear", "loss_stop"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
            assert got["lr"] == ref["lr"]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_layout_state_equals_one_device(runs, layout):
    one = runs["one"]
    m1 = {n: v["exp_avg"] for n, v in one["moments"].items()}
    select = {n: m.abs() > 1e-5 for n, m in m1.items()}
    assert sum(int(s.sum()) for s in select.values()) > 0.5 * sum(s.numel() for s in select.values())
    for r in runs[layout]:
        assert rel_l2(r["params"], one["params"], select) <= 1e-5
        assert rel_l2(r["buffers"], one["buffers"]) <= 1e-5
        for k in ("exp_avg", "exp_avg_sq"):
            got = {n: v[k] for n, v in r["moments"].items()}
            ref = {n: v[k] for n, v in one["moments"].items()}
            assert rel_l2(got, ref) <= 1e-5, k


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_every_rank_holds_the_same_state(runs, layout):
    """Replicated parameters, gathered shards and batch-norm statistics are
    bit-equal on every rank (one reduced gradient, one update)."""
    ranks = runs[layout]
    assert [r["rank"] for r in ranks] == list(range(len(ranks)))
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k in ("params", "buffers"):
            for n, v in ranks[0][k].items():
                assert torch.equal(r[k][n], v), (k, n)


def test_tensor_parallel_shards_follow_tp_rules(runs):
    """(2, 2): the embedding column-parallel and the post-net projection
    row-parallel over its input dim (flax's kernel (in, out) is
    `nn.Linear`'s (out, in)), the 1025-wide bias whole; the Adam moments
    mirror the shards.  (2, 1) keeps every parameter whole."""
    cfg = runs["cfg"]
    full = {n: tuple(v.shape) for n, v in runs["params"].items()}
    e, lp = full["embedding.weight"], full["linear_proj.weight"]
    for r in runs[(2, 2)]:
        shapes = r["shard_shapes"]
        assert shapes["embedding.weight"] == (e[0], e[1] // 2)
        assert shapes["linear_proj.weight"] == (lp[0], lp[1] // 2)
        assert shapes["linear_proj.bias"] == (cfg.dataset.n_linear,)
        assert r["moment_shapes"] == shapes
        assert {n: s for n, s in shapes.items() if n not in mesh_mod.TP_RULES} == {
            n: s for n, s in full.items() if n in shapes and n not in mesh_mod.TP_RULES
        }
    assert set(mesh_mod.TP_RULES) == {"embedding.weight", "linear_proj.weight"}
    for r in runs[(2, 1)]:
        assert r["shard_shapes"] == {n: s for n, s in full.items() if n in r["shard_shapes"]}
    assert [r["coords"] for r in runs[(2, 2)]] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_checkpoint_of_2x2_restores_on_one_device(runs):
    """The (2, 2) ranks' checkpoint holds whole tensors: restored on one
    device it equals the gathered state, Adam moments included, and trains
    on."""
    cfg, ref = runs["cfg"], runs[(2, 2)][0]
    state = ptrain.create_state(cfg, seed=99, device="cpu")
    assert CheckpointManager(cfg, runs["ckpt"]).restore_latest(state) == 2
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), ref["params"][n]), n
        st = state.optimizer.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[k], ref["moments"][n][k]), (n, k)
    for n, b in state.model.named_buffers():
        assert torch.equal(b, ref["buffers"][n]), n
    m = ptrain.make_train_step(cfg)(state, runs["batches"][0])
    assert np.isfinite(float(m["loss"])) and state.step == 3


def test_naive_per_rank_normalization_misses_the_global_loss(runs):
    """The control: each half of the ragged batch normalized by its own
    counts (per-rank batch norm and loss means, averaged as a naive
    data-parallel step would) against one device's step on the whole
    batch, from the same weights and keep masks.  It must miss by far more
    than the mesh's tolerance, or the mesh tests could not see the trap."""
    cfg, params, batch = runs["cfg"], runs["params"], runs["batches"][0]
    b = {k: torch.as_tensor(v) for k, v in batch.items()}

    def loss_on(rows, total):
        state = ptrain.create_state(cfg, device="cpu")
        state.model.load_state_dict(params)
        model = state.model.train()
        gen = torch.Generator().manual_seed((cfg.training.seed + 1) << 32)
        part = {k: v[rows] for k, v in b.items()}
        linear, mel, fmask = ptrain._targets(part, cfg)
        out = model(part["char_ids"], mel, fmask, gen, (rows.start, total))
        loss, _ = tacotron_loss(out, mel, linear, part["loss_frames"], cfg.arch,
                                cfg.dataset, text_lengths=part["text_len"])
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        return float(loss.detach()), grads

    whole, g_whole = loss_on(slice(0, 4), 4)
    halves = [loss_on(s, 4) for s in mesh_mod.row_slices(4, 2)]
    naive = sum(h[0] for h in halves) / 2
    g_naive = {n: sum(h[1][n] for h in halves) / 2 for n in g_whole}
    np.testing.assert_allclose(whole, runs["one"]["metrics"][0]["loss"], rtol=1e-6)
    assert abs(naive - whole) / whole > 1e-3
    assert rel_l2(g_naive, g_whole) > 1e-3


def test_make_mesh_refuses_axes_beyond_the_devices():
    cpus = [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match="devices"):
        mesh_mod.make_mesh(cpus, model_parallel=16)
    with pytest.raises(ValueError, match="devices"):
        mesh_mod.make_mesh(cpus, data_parallel=8, model_parallel=2)
    mesh = mesh_mod.make_mesh(cpus, data_parallel=2, model_parallel=3)
    assert mesh.shape == {"data": 2, "model": 3} and not mesh.distributed
    assert mesh.data_devices() == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="does not split"):
        mesh_mod.row_slices(5, 2)


@pytest.mark.parametrize(
    "batch,devices,model,want",
    [(4, 4, 2, (2, 2)), (6, 4, 1, (2, 1)), (32, 8, 2, (4, 2)), (3, 4, 1, (1, 1))],
)
def test_layout_follows_the_reference_rule(batch, devices, model, want):
    """data = gcd(batch_size, devices / model_parallel), as
    `sstts/train.py:779-792` picks it."""
    cfg = tiny_config()
    cfg = cfg.replace(training=dataclasses.replace(
        cfg.training, batch_size=batch, model_parallel=model))
    assert ptrain.mesh_layout(cfg, devices) == want


def test_layout_refuses_a_model_axis_that_does_not_divide():
    cfg = tiny_config()
    cfg = cfg.replace(training=dataclasses.replace(cfg.training, model_parallel=3))
    with pytest.raises(ValueError, match="does not divide the 4 visible devices"):
        ptrain.mesh_layout(cfg, 4)


def _raise_on_rank_one():
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    torch.distributed.barrier()


def test_a_failing_rank_fails_the_launch():
    """A rank that raises ends the launch at once with a rank's error (its
    own, or its peer's barrier broken by the lost connection, whichever
    the parent sees first), long before the timeout; the launch stops
    every process before it returns."""
    import time

    import torch.multiprocessing as mp

    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException):
        mesh_mod.launch(_raise_on_rank_one, 2, timeout=120.0)
    assert time.monotonic() - t0 < 60.0

