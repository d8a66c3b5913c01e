"""flax tree -> port state_dict: every leaf lands, with the layout rules of
`sstts_torch.convert`, and nothing is dropped or left unfilled."""

import copy

import numpy as np
import pytest
import torch

from torch_parity import jax_variables, port_model, tiny_pair

from sstts_torch.convert import convert_params
from sstts_torch.model.tacotron import Tacotron


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_pair()
    return tcfg, jax_variables(jcfg)


def _n_leaves(tree):
    return sum(_n_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


def test_every_leaf_converts(setup):
    tcfg, v = setup
    sd = convert_params(v["params"], v["batch_stats"], tcfg)
    assert len(sd) == _n_leaves(v["params"]) + _n_leaves(v["batch_stats"])
    model = Tacotron(tcfg.arch, tcfg.dataset)
    model.load_state_dict(sd, strict=True)


def test_layout_rules(setup):
    tcfg, v = setup
    sd = convert_params(v["params"], v["batch_stats"], tcfg)
    p, bs = v["params"], v["batch_stats"]
    np.testing.assert_array_equal(
        sd["linear_proj.weight"].numpy(), p["linear_proj"]["kernel"].T
    )
    np.testing.assert_array_equal(
        sd["encoder_cbhg.bank.conv3"].numpy(),
        p["encoder_cbhg"]["bank"]["conv3"].transpose(2, 1, 0),
    )
    np.testing.assert_array_equal(
        sd["post_cbhg.proj1.weight"].numpy(),
        p["post_cbhg"]["proj1"]["kernel"].transpose(2, 1, 0),
    )
    np.testing.assert_array_equal(
        sd["encoder_cbhg.gru.backward_gru.wh"].numpy(),
        p["encoder_cbhg"]["gru"]["backward"]["wh"],
    )
    np.testing.assert_array_equal(
        sd["post_cbhg.proj2_bn.var"].numpy(), bs["post_cbhg"]["proj2_bn"]["var"]
    )
    np.testing.assert_array_equal(
        sd["embedding.weight"].numpy(), p["embedding"]["embedding"]
    )
    np.testing.assert_array_equal(
        sd["decoder_cell.attention.query_proj.weight"].numpy(),
        p["decoder_cell"]["attention"]["query_proj"]["kernel"].T,
    )


def test_missing_leaf_raises(setup):
    tcfg, v = setup
    params = copy.deepcopy(v["params"])
    del params["decoder_cell"]["dec_gru1"]["wh"]
    with pytest.raises(KeyError, match="no flax leaf"):
        convert_params(params, v["batch_stats"], tcfg)


def test_missing_batch_stat_raises(setup):
    tcfg, v = setup
    stats = copy.deepcopy(v["batch_stats"])
    del stats["encoder_cbhg"]["bank"]["bn2"]["var"]
    with pytest.raises(KeyError, match="no flax leaf"):
        convert_params(v["params"], stats, tcfg)


def test_extra_leaf_raises(setup):
    tcfg, v = setup
    params = copy.deepcopy(v["params"])
    params["decoder_cell"]["dec_gru2"] = copy.deepcopy(params["decoder_cell"]["dec_gru1"])
    with pytest.raises(KeyError, match="no port tensor"):
        convert_params(params, v["batch_stats"], tcfg)


def test_shape_mismatch_raises(setup):
    tcfg, v = setup
    params = copy.deepcopy(v["params"])
    params["linear_proj"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert_params(params, v["batch_stats"], tcfg)


def test_port_model_loads_and_runs(setup):
    """The converted model encodes a batch to finite memory."""
    tcfg, v = setup
    model = port_model(tcfg, v)
    with torch.no_grad():
        memory, mask = model.encode(torch.tensor([[5, 9, 3, 1, 0, 0]]))
    assert memory.shape == (1, 6, 2 * tcfg.arch.encoder_gru_units)
    assert torch.isfinite(memory).all() and mask.sum() == 4
