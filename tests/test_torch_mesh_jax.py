"""The port's (2, 2) mesh step against the JAX package's step on its own
`make_mesh(data_parallel=2, model_parallel=2)` GSPMD mesh (the 8 virtual
CPU devices of tests/conftest.py), from the JAX init converted to the port
(`sstts_torch.convert`), dropout off, on one ragged batch; the port's ranks
are gloo processes (`mesh.launch`)."""

import jax
import numpy as np
import pytest
import torch

from torch_mesh_helpers import TIMEOUT, mesh_cfg, seeded_batches
from torch_parity import tiny_pair

from sstts import train as jtrain
from sstts.parallel.mesh import batch_sharding, make_mesh as jax_make_mesh
from sstts_torch.convert import convert_params
from sstts_torch.parallel import mesh as mesh_mod
from sstts_torch.tools.mesh_steps import run_steps


@pytest.fixture(scope="module")
def steps():
    """One step on each side; JAX's state before and after, the port's
    ranks' results."""
    sections = dict(
        dataset={"dataset": "synthetic"}, arch={"prenet_dropout": 0.0},
        training={"batch_size": 4, "text_buckets": (32,), "frame_buckets": (64,),
                  "learning_rate": 2e-4},
    )
    jcfg, pcfg = tiny_pair(**sections)
    batch = seeded_batches(mesh_cfg(), 1)[0]
    mesh = jax_make_mesh(data_parallel=2, model_parallel=2)
    state = jtrain.create_state(jcfg, mesh)
    specs = {
        "embedding.weight": tuple(state.params["embedding"]["embedding"].sharding.spec),
        "linear_proj.weight": tuple(state.params["linear_proj"]["kernel"].sharding.spec),
    }
    params0 = jax.tree.map(np.asarray, jax.device_get(state.params))
    stats0 = jax.tree.map(np.asarray, jax.device_get(state.batch_stats))
    sharded = jax.tree.map(lambda x: jax.device_put(x, batch_sharding(mesh)), batch)
    state, jm = jtrain.make_train_step(jcfg, mesh)(state, sharded)
    ranks = mesh_mod.launch(
        run_steps, 4, pcfg, convert_params(params0, stats0, pcfg), [batch], "cpu",
        (2, 2), timeout=TIMEOUT,
    )
    return dict(
        pcfg=pcfg, specs=specs, stats0=stats0, ranks=ranks,
        jm={k: float(v) for k, v in jax.device_get(jm).items()},
        params1=jax.tree.map(np.asarray, jax.device_get(state.params)),
        stats1=jax.tree.map(np.asarray, jax.device_get(state.batch_stats)),
        mu=jax.tree.map(np.asarray, jax.device_get(state.opt_state[1][0].mu)),
    )


def test_2x2_loss_matches_the_jax_mesh_step(steps):
    """The reference's own tolerance on the loss (rtol 1e-4,
    tests/test_train.py:141), and on its terms and the gradient norm."""
    for r in steps["ranks"]:
        for k in ("loss", "loss_mel", "loss_linear", "loss_stop", "grad_norm", "lr"):
            np.testing.assert_allclose(r["metrics"][0][k], steps["jm"][k], rtol=1e-4, err_msg=k)


def test_2x2_updated_parameters_match_the_jax_mesh_step(steps):
    """Where |g| > 1e-4 (JAX's first moment above 1e-5) within atol 1e-6
    (Adam moves each by about lr = 2e-4), the rule of
    tests/test_torch_train.py; the rest is held by the gradient norm."""
    pcfg, stats0 = steps["pcfg"], steps["stats0"]
    want = convert_params(steps["params1"], stats0, pcfg)
    moment = convert_params(steps["mu"], stats0, pcfg)
    got = steps["ranks"][0]["params"]
    compared = 0
    for n, p in got.items():
        sel = torch.as_tensor(moment[n]).abs() > 1e-5
        compared += int(sel.sum())
        np.testing.assert_allclose(p[sel].numpy(), torch.as_tensor(want[n])[sel].numpy(),
                                   atol=1e-6, err_msg=n)
    assert compared > 0.5 * sum(p.numel() for p in got.values())


def test_2x2_batch_statistics_match_the_jax_mesh_step(steps):
    """GSPMD's batch norm takes the global batch's statistics; so do the
    ranks' (their data-group all-reduce): within 1e-5."""
    pcfg = steps["pcfg"]
    want = convert_params(steps["params1"], steps["stats1"], pcfg)
    for r in steps["ranks"]:
        for n, b in r["buffers"].items():
            np.testing.assert_allclose(b.numpy(), np.asarray(want[n]), atol=1e-5, err_msg=n)


def test_tp_rules_shard_the_same_dims_as_the_reference(steps):
    """The reference's specs (flax layouts) and the port's torch dims name
    the same axis: the embedding's features; the projection's input, dim 0
    of flax's (in, out) kernel and dim 1 of `nn.Linear`'s (out, in)."""
    assert steps["specs"] == {"embedding.weight": (None, "model"),
                              "linear_proj.weight": ("model", None)}
    assert dict(mesh_mod.TP_RULES) == {"embedding.weight": 1, "linear_proj.weight": 1}
    shapes = steps["ranks"][0]["shard_shapes"]
    full = steps["ranks"][0]["params"]
    assert shapes["embedding.weight"][1] * 2 == full["embedding.weight"].shape[1]
    assert shapes["linear_proj.weight"][1] * 2 == full["linear_proj.weight"].shape[1]
