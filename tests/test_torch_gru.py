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
from sstts_torch.ops import gru as gru_ops
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


@pytest.mark.parametrize(
    "t_len,lengths",
    [(1, [1, 1, 1]), (1, [1, 0, 1]), (7, [7, 0, 4])],
    ids=["one-step", "one-step-empty-row", "empty-row"],
)
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_gru_sequence_one_step_and_empty_row(gru_inputs, t_len, lengths, reverse):
    """A single step, and a row that is all padding: its outputs are exact
    zeros and its carry never leaves 0."""
    xs, wx, wh, b, _ = gru_inputs
    xs = xs[:, :t_len]
    mask = (np.arange(t_len)[None, :] < np.array(lengths)[:, None]).astype(np.float32)
    got = gru_sequence(t(xs), t(wx), t(wh), t(b), t(mask), reverse).numpy()
    ref_pallas = jax_gru_pallas(
        jnp.asarray(xs), wx, wh, b, jnp.asarray(mask), reverse=reverse, interpret=True
    )
    ref_scan = gru_sequence_xla(jnp.asarray(xs), wx, wh, b, jnp.asarray(mask), reverse=reverse)
    assert got.shape == (3, t_len, 5)
    np.testing.assert_allclose(got, np.asarray(ref_pallas), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(ref_scan), atol=ATOL)
    assert np.all(got[mask == 0] == 0.0)


def test_gru_sequence_rejects_a_mask_that_is_not_batch_by_time(gru_inputs):
    """The kernels index the mask as (B, T); any other shape is refused
    before a device is chosen, under grad as well."""
    xs, wx, wh, b, mask = (t(a) for a in gru_inputs)
    for bad in (mask[:, :-1], mask[:2], mask[..., None], mask.T):
        with pytest.raises(ValueError, match=r"mask .* must be \(B, T\)"):
            gru_sequence(xs, wx, wh, b, bad)
        with pytest.raises(ValueError, match=r"mask .* must be \(B, T\)"):
            gru_sequence(xs.clone().requires_grad_(), wx, wh, b, bad)
    gates = torch.zeros(3, 11, 20)
    with pytest.raises(ValueError, match=r"mask .* must be \(B, T\)"):
        gru_ops.gru_sequence_backward(torch.zeros(3, 11, 5), gates, xs[..., :5], wh, mask[:2])
    with pytest.raises(ValueError, match="do not agree"):
        gru_sequence(xs, wx[:, :-1], wh, b, mask)


def test_kernel_kind_follows_the_hidden_width():
    """H = 128 takes the register-resident kernels, every other width up to
    137 the generic ones, wider ones the wide kind on a cluster, and from
    523 to 5456 the grid kind (one grid a direction; past 1419 its blocks
    stream what their shared memory cannot hold of their slice of Wh):
    four kinds (`kernel_config`); the C entry points' signatures carry the
    kind and the cluster size (the grid's blocks)."""
    assert gru_ops.kernel_config(128) == (gru_ops.KIND_H128, 1)
    assert {gru_ops.kernel_config(h) for h in (1, 16, 127, 129, 137)} == {
        (gru_ops.KIND_GENERIC, 1)
    }
    assert gru_ops.kernel_config(256) == (gru_ops.KIND_WIDE, 8)
    assert gru_ops.kernel_config(752) == (gru_ops.KIND_GRID, 126)
    assert gru_ops.kernel_config(1420) == (gru_ops.KIND_GRID, 130)
    assert gru_ops.kernel_config(5456) == (gru_ops.KIND_GRID, 130)
    assert len({gru_ops.KIND_GENERIC, gru_ops.KIND_H128, gru_ops.KIND_WIDE,
                gru_ops.KIND_GRID}) == 4
    for fn in ("sstts_gru_sequence", "sstts_gru_sequence_backward", "sstts_gru_recurrence"):
        argtypes, _ = gru_ops.SIGNATURES[fn]
        assert argtypes[-3:] == [gru_ops._I, gru_ops._I, gru_ops._P]


def test_ptxas_report_reads_the_log_kept_beside_the_library(tmp_path, monkeypatch):
    """`build.ptxas_report` parses what `nvcc -Xptxas -v` printed when the
    library was built (the log is written next to it by `build_all`)."""
    from sstts_torch.ops import build

    assert "-Xptxas" in build.NVCC_FLAGS and "-v" in build.NVCC_FLAGS
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    lib = build.library_path("gru")
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN3abc12gru_fwd_h128ILb1EEEvPKf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN3abc12gru_fwd_h128ILb1EEEvPKf\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 124 registers, used 1 barriers, 20096 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z15gru_bwd_generic' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z15gru_bwd_generic\n"
        "    64 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 400 bytes cmem[0]\n"
    )
    assert build.ptxas_report("gru") == {
        "_ZN3abc12gru_fwd_h128ILb1EEEvPKf": {
            "registers": 124, "stack_bytes": 0, "spill_store_bytes": 0,
            "spill_load_bytes": 0},
        "_Z15gru_bwd_generic": {
            "registers": 40, "stack_bytes": 64, "spill_store_bytes": 8,
            "spill_load_bytes": 12},
    }


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
