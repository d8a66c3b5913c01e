"""Kernel B3's plain version and the CBHG blocks around it, held to JAX.

Tolerances: everything is f32 on both sides; sums run in another order
(PyTorch's GEMMs vs XLA's), which over a 16-step recurrence and a stack of
convs and highways stays within a few 1e-6; 2e-5 absolute leaves an order
of magnitude of room and still catches any wrong gate, mask or direction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_variables, port_model, t, text_ids, tiny_pair

from sstts.model.rnn import BiGRU as JaxBiGRU
from sstts.model.tacotron import Tacotron as JaxTacotron
from sstts.ops.pallas_gru import gru_sequence as jax_gru_pallas
from sstts.ops.pallas_gru import gru_sequence_xla
from sstts_torch.ops.gru import gru_sequence

ATOL = 2e-5


@pytest.fixture(scope="module")
def gru_inputs():
    rng = np.random.default_rng(0)
    B, T, D, H = 3, 11, 6, 5
    xs = rng.normal(size=(B, T, D)).astype(np.float32)
    wx = (rng.normal(size=(D, 3 * H)) / np.sqrt(D)).astype(np.float32)
    wh = (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    b = rng.normal(0.0, 0.1, 3 * H).astype(np.float32)
    lengths = np.array([11, 7, 3])
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return xs, wx, wh, b, mask


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_gru_sequence_matches_pallas_and_scan(gru_inputs, reverse, masked):
    xs, wx, wh, b, mask = gru_inputs
    m = mask if masked else None
    got = gru_sequence(t(xs), t(wx), t(wh), t(b), None if m is None else t(m), reverse)
    ref_pallas = jax_gru_pallas(
        jnp.asarray(xs), wx, wh, b, None if m is None else jnp.asarray(m),
        reverse=reverse, interpret=True,
    )
    ref_scan = gru_sequence_xla(
        jnp.asarray(xs), wx, wh, b, None if m is None else jnp.asarray(m),
        reverse=reverse,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_pallas), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_scan), atol=ATOL)
    if masked:  # padded steps emit exact zeros
        assert np.all(got.numpy()[mask == 0] == 0.0)


@pytest.fixture(scope="module")
def model_pair():
    jcfg, tcfg = tiny_pair()
    v = jax_variables(jcfg, seed=1)
    return jcfg, tcfg, v, port_model(tcfg, v)


def test_bigru_matches_flax(model_pair):
    jcfg, tcfg, v, model = model_pair
    rng = np.random.default_rng(1)
    H = jcfg.arch.encoder_gru_units
    xs = rng.normal(size=(3, 9, jcfg.arch.encoder_highway_units)).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([[9], [4], [6]])
    ref = JaxBiGRU(H, backend="xla").apply(
        {"params": v["params"]["encoder_cbhg"]["gru"]}, jnp.asarray(xs),
        jnp.asarray(mask),
    )
    with torch.no_grad():
        got = model.encoder_cbhg.gru(t(xs), t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_encoder_matches_flax(model_pair):
    """Embedding -> prenet -> encoder CBHG (bank with asymmetric SAME pads,
    -inf max-pool, projections, BN with running stats, highways, BiGRU)."""
    jcfg, tcfg, v, model = model_pair
    ids = text_ids(np.random.default_rng(2), [12, 5, 9], 12)
    memory, mask = JaxTacotron(jcfg.arch, jcfg.dataset).apply(
        v, jnp.asarray(ids), False, method=JaxTacotron.encode
    )
    with torch.no_grad():
        got, got_mask = model.encode(torch.as_tensor(ids, dtype=torch.long))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(memory), atol=ATOL)


def test_postprocess_matches_flax(model_pair):
    """Post-CBHG (highway_in projection, BiGRU over frames) -> linear."""
    jcfg, tcfg, v, model = model_pair
    rng = np.random.default_rng(3)
    mel = rng.normal(size=(2, 14, jcfg.dataset.n_mels)).astype(np.float32)
    fmask = np.arange(14)[None, :] < np.array([[14], [8]])
    ref = JaxTacotron(jcfg.arch, jcfg.dataset).apply(
        v, jnp.asarray(mel), jnp.asarray(fmask), False,
        method=JaxTacotron.postprocess,
    )
    with torch.no_grad():
        got = model.postprocess(t(mel), t(fmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
