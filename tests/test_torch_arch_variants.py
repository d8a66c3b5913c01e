"""The architectures the reference's model accepts beyond the default, held
to JAX in f32 on the CPU: local-Luong attention (`attention_type=
"local_luong"`) and the fused conv bank (`fused_conv_bank=True`).

Both sides start from one JAX init, converted (`sstts_torch.convert`), with
the prenets' dropout off.  Tolerances, f32 on both sides in other
summation orders: the attention and the bank alone within 1e-5; the
teacher-forced forward and an 8-step decode as tests/test_torch_decoder.py
holds the default architecture (mel, linear and stop logits 2e-4,
alignments 2e-5); one train step's loss within rtol 1e-4 and its gradients
within atol 1e-5, rtol 1e-3, as tests/test_torch_train.py.  The window
of the Luong attention, forward and decode tests is 2 positions, so that
it masks inside the tiny texts.  The train step runs Luong at its default
window (16): the window is a hard mask on |position - center|, and the
two packages sum the center in other orders, so a position that lies
within f32 rounding of the window's edge falls inside on one side and
outside on the other; at 2 positions that happened in about one of 30
batches (the batches follow the process's hash), and it moves the
gradient norm by ~3e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    jax_train_grads, jax_variables, port_model, port_train_grads, t, text_ids,
    tiny_pair, train_batch, tree_pairs,
)

from sstts.model.attention import LocalLuongAttention as JaxLuong
from sstts.model.modules import Conv1dBank as JaxBank
from sstts.model.tacotron import Tacotron as JaxTacotron
from sstts_torch.convert import convert_params, to_flax
from sstts_torch.model.attention import LocalLuongAttention, make_attention
from sstts_torch.model.modules import Conv1dBank
from sstts_torch.model.tacotron import Tacotron

VARIANTS = {
    "luong": {"attention_type": "local_luong", "local_attention_window": 2},
    "fused_bank": {"fused_conv_bank": True},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(variant, **arch):
    return tiny_pair(arch={**VARIANTS[variant], "prenet_dropout_at_inference": False, **arch})


@pytest.mark.parametrize("with_prev", [True, False], ids=["prev", "no_prev"])
def test_luong_attention_matches_jax(with_prev):
    rng = np.random.default_rng(0)
    B, T, Dm, Dq, A = 3, 9, 6, 5, 4
    memory = rng.normal(size=(B, T, Dm)).astype(np.float32)
    query = rng.normal(size=(B, Dq)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[9], [4], [7]])
    prev = rng.dirichlet(np.ones(T), size=B).astype(np.float32) if with_prev else None
    jatt = JaxLuong(A, window=2)
    v = jatt.init(jax.random.PRNGKey(1), jnp.asarray(memory), jnp.asarray(query),
                  method=lambda m, mem, q: m(q, m.init_keys(mem), None))
    keys_j = jatt.apply(v, jnp.asarray(memory), method=JaxLuong.init_keys)
    ref = jatt.apply(v, jnp.asarray(query), keys_j, jnp.asarray(mask),
                     None if prev is None else jnp.asarray(prev))
    att = LocalLuongAttention(Dm, Dq, A, window=2)
    with torch.no_grad():
        att.memory_proj.weight.copy_(t(v["params"]["memory_proj"]["kernel"]).T)
        att.query_proj.weight.copy_(t(v["params"]["query_proj"]["kernel"]).T)
        keys = att.init_keys(t(memory))
        got = att(t(query), keys, t(mask), None if prev is None else t(prev))
    np.testing.assert_allclose(keys.numpy(), np.asarray(keys_j), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if with_prev:  # the window masked something inside the valid rows
        assert (got.numpy()[mask] < 1e-12).any()
    with pytest.raises(ValueError, match="unknown attention type"):
        make_attention("location", Dm, Dq, A)


def test_fused_bank_matches_jax_and_the_unfused_bank():
    """Train mode (masked batch statistics): JAX's fused bank, the port's
    fused bank and the port's unfused bank on the same parameters."""
    rng = np.random.default_rng(2)
    B, T, D, K, C = 2, 11, 6, 5, 3
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[11], [6]])
    jbank = JaxBank(K, C, fused=True)
    v = jbank.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(mask), True)
    ref, _ = jbank.apply(v, jnp.asarray(x), jnp.asarray(mask), True, mutable=["batch_stats"])
    got = {}
    for fused in (True, False):
        bank = Conv1dBank(D, K, C, fused=fused).train()
        with torch.no_grad():
            for k in range(1, K + 1):
                getattr(bank, f"conv{k}").copy_(t(v["params"][f"conv{k}"]).permute(2, 1, 0))
            got[fused] = bank(t(x), t(mask)).numpy()
    np.testing.assert_allclose(got[True], np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got[True], got[False], atol=1e-5)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model_pair(request):
    jcfg, pcfg = _pair(request.param)
    v = jax_variables(jcfg, seed=4)
    ids = text_ids(np.random.default_rng(5), [8, 3, 6], 8)
    mel = np.random.default_rng(6).normal(size=(3, 10, jcfg.dataset.n_mels)).astype(np.float32)
    fmask = np.arange(10)[None] < np.array([[10], [5], [10]])
    return request.param, jcfg, pcfg, v, ids, mel, fmask


def test_forward_matches_jax(model_pair):
    """The teacher-forced forward in eval mode (running statistics)."""
    name, jcfg, pcfg, v, ids, mel, fmask = model_pair
    ref = JaxTacotron(jcfg.arch, jcfg.dataset).apply(
        v, jnp.asarray(ids), jnp.asarray(mel), jnp.asarray(fmask), train=False,
        rngs={"dropout": jax.random.PRNGKey(0)},
    )
    with torch.no_grad():
        got = port_model(pcfg, v)(t(ids).long(), t(mel), t(fmask))
    for key, atol in (("mel", 2e-4), ("linear", 2e-4), ("stop_logits", 2e-4),
                      ("alignments", 2e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=atol,
                                   err_msg=f"{name} {key}")


def test_decode_infer_matches_jax(model_pair):
    """8 autoregressive steps of the plain loop against flax's nn.scan."""
    name, jcfg, pcfg, v, ids, _, _ = model_pair
    jmodel = JaxTacotron(jcfg.arch, jcfg.dataset)
    memory, mmask = jmodel.apply(v, jnp.asarray(ids), False, method=JaxTacotron.encode)
    ref = jmodel.apply(v, memory, mmask, 8, 0.5, 2, method=JaxTacotron.decode_infer,
                       rngs={"dropout": jax.random.PRNGKey(1)})
    model = port_model(pcfg, v)
    with torch.no_grad():
        pmem, pmask = model.encode(t(ids).long())
        got = model.decode_infer(pmem, pmask, 8, 0.5, 2)
    np.testing.assert_allclose(pmem.numpy(), np.asarray(memory), atol=1e-5)
    np.testing.assert_array_equal(got["n_frames"].numpy(), np.asarray(ref["n_frames"]))
    for key, atol in (("mel", 2e-4), ("stop_logits", 2e-4), ("alignments", 2e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=atol,
                                   err_msg=f"{name} {key}")


def test_train_step_matches_jax(model_pair):
    """One train step's loss terms and every gradient leaf."""
    name = model_pair[0]
    jcfg, pcfg = tiny_pair(
        dataset={"dataset": "synthetic"},
        arch={**VARIANTS[name], "local_attention_window": 16, "prenet_dropout": 0.0},
        training={"batch_size": 2, "text_buckets": (48,), "frame_buckets": (96,)},
    )
    v = jax_variables(jcfg, seed=7)
    batch = train_batch(pcfg)
    jm, jgrads = jax_train_grads(jcfg, v, batch)
    pm, pgrads = port_train_grads(pcfg, v, batch)
    for k in ("loss", "loss_mel", "loss_linear", "loss_stop", "grad_norm"):
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=f"{name} {k}")
    n = 0
    for path, g, r in tree_pairs(jgrads, pgrads):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-3, err_msg=f"{name} {path}")
        n += 1
    assert n == len(jax.tree.leaves(pgrads))


def test_luong_checkpoint_round_trip(tmp_path):
    """A Luong tree converts leaf for leaf (two projections, no b or v) and
    back, and survives the port's checkpoint; a Bahdanau tree does not
    load into a Luong model, nor the other way round."""
    from sstts_torch import train as ptrain
    from sstts_torch.checkpoint import CheckpointManager

    jcfg, pcfg = _pair("luong")
    v = jax_variables(jcfg, seed=8)
    att = v["params"]["decoder_cell"]["attention"]
    assert sorted(att) == ["memory_proj", "query_proj"]
    sd = convert_params(v["params"], v["batch_stats"], pcfg)
    params, stats = to_flax(sd)
    for path, g, r in tree_pairs(v["params"], params):
        np.testing.assert_array_equal(g, r, err_msg=path)
    for path, g, r in tree_pairs(v["batch_stats"], stats):
        np.testing.assert_array_equal(g, r, err_msg=path)

    state = ptrain.create_state(pcfg, device="cpu")
    state.model.load_state_dict(sd)
    CheckpointManager(pcfg, tmp_path).save(3, state)
    fresh = ptrain.create_state(pcfg, seed=9, device="cpu")
    assert CheckpointManager(pcfg, tmp_path).restore_latest(fresh) == 3
    for k, x in fresh.model.state_dict().items():
        assert torch.equal(x, sd[k]), k

    bjcfg, bpcfg = tiny_pair()
    bv = jax_variables(bjcfg, seed=8)
    with pytest.raises(KeyError):
        convert_params(bv["params"], bv["batch_stats"], pcfg)
    with pytest.raises(KeyError):
        convert_params(v["params"], v["batch_stats"], bpcfg)
    assert not hasattr(Tacotron(pcfg.arch, pcfg.dataset).decoder_cell.attention, "v")
