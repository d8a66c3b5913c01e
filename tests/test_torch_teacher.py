"""Kernel B6's plain version, its `autograd.Function` and the teacher-forced
decoder of the port, held to JAX; and the inference-only guards of B2 and
B4.

Tolerances follow tests/test_pallas_decoder.py:126-172: in f32 the scan's
features (and the mel frames and stop logits projected from them) within
2e-4 and the alignments within 2e-5 after S steps in another summation
order; parameter gradients within atol 5e-4, rtol 1e-3.  With bf16
products both sides round the same operands, so they agree to f32 noise
re-rounded to bf16: 2e-2.  Both sides run with the prenet's dropout at
rate 0 (flax's Dropout is then the identity).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_variables, port_model, t, text_ids, tiny_pair

from sstts.model.tacotron import Tacotron as JaxTacotron
from sstts.ops import pallas_decoder as jpd
from sstts_torch.convert import to_flax
from sstts_torch.model.tacotron import Tacotron
from sstts_torch.ops import teacher as tops


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_pair(arch={"prenet_dropout": 0.0})
    v = jax_variables(jcfg, seed=3)
    jmodel = JaxTacotron(jcfg.arch, jcfg.dataset)
    ids = text_ids(np.random.default_rng(6), [8, 3, 6], 8)
    memory, mmask = jmodel.apply(v, jnp.asarray(ids), False, method=JaxTacotron.encode)
    mel_gt = np.random.default_rng(7).normal(size=(3, 10, jcfg.dataset.n_mels)).astype(np.float32)
    return jcfg, tcfg, v, port_model(tcfg, v), np.asarray(memory), np.asarray(mmask), mel_gt


def _scan_inputs(setup):
    jcfg, tcfg, v, model, memory, mmask, _ = setup
    rng = np.random.default_rng(8)
    pre = rng.uniform(size=(3, 5, jcfg.arch.prenet_units[-1])).astype(np.float32)
    keys = rng.normal(0.0, 0.5, size=(3, memory.shape[1], jcfg.arch.attention_units)).astype(np.float32)
    return pre, keys, mmask.astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_scan_matches_jax_kernel(setup, dtype):
    jcfg, tcfg, v, model, memory, mmask, _ = setup
    pre, keys, maskf = _scan_inputs(setup)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref_xs, ref_al = jpd.fused_teacher_scan(
        jpd.teacher_weights_from_tree(v["params"]["decoder_cell"]), jnp.asarray(pre),
        jnp.asarray(memory), jnp.asarray(keys), jnp.asarray(maskf), jdt, interpret=True,
    )
    with torch.no_grad():
        xs, al = tops.fused_teacher_scan(
            tops.teacher_weights_from_cell(model.decoder_cell), t(pre), t(memory),
            t(keys), t(maskf), tdt,
        )
    atol = (2e-4, 2e-5) if dtype == "f32" else (2e-2, 2e-2)
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref_xs), atol=atol[0])
    np.testing.assert_allclose(al.numpy(), np.asarray(ref_al), atol=atol[1])


def _decode_teacher_port(model, memory, mmask, mel_gt, impl):
    model.teacher_impl = impl
    return model.decode_teacher(t(memory), t(mmask), t(mel_gt))


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_decode_teacher_matches_jax(setup, impl):
    """The port's plain module loop ("xla") and its fused scan's plain
    version ("fused") against JAX's decode_teacher with the same impl."""
    jcfg, tcfg, v, model, memory, mmask, mel_gt = setup
    ref = JaxTacotron(jcfg.arch, jcfg.dataset, teacher_backend=impl).apply(
        v, jnp.asarray(memory), jnp.asarray(mmask), jnp.asarray(mel_gt), False,
        method=JaxTacotron.decode_teacher, rngs={"dropout": jax.random.PRNGKey(0)},
    )
    with torch.no_grad():
        got = _decode_teacher_port(model, memory, mmask, mel_gt, impl)
    for g, r, atol in zip(got, ref, (2e-4, 2e-4, 2e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol)


def test_fused_scan_gradients_match_jax(setup):
    """Parameter gradients through the port's Function (plain forward,
    recompute backward) against jax.grad of the JAX package's fused path."""
    jcfg, tcfg, v, model, memory, mmask, mel_gt = setup

    def jloss(params):
        mel, stops, align = JaxTacotron(jcfg.arch, jcfg.dataset, teacher_backend="fused").apply(
            {**v, "params": params}, jnp.asarray(memory), jnp.asarray(mmask),
            jnp.asarray(mel_gt), False, method=JaxTacotron.decode_teacher,
            rngs={"dropout": jax.random.PRNGKey(0)},
        )
        return jnp.mean(jnp.abs(mel - mel_gt)) + jnp.mean(stops**2) + jnp.mean(align**2)

    ref = jax.grad(jloss)(v["params"])
    model.zero_grad()
    mel, stops, align = _decode_teacher_port(model, memory, mmask, mel_gt, "fused")
    loss = (mel - t(mel_gt)).abs().mean() + (stops**2).mean() + (align**2).mean()
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    got = to_flax(grads)[0]
    ref_cell = jax.tree.map(np.asarray, ref["decoder_cell"])
    flat = jax.tree_util.tree_leaves_with_path(ref_cell)
    assert len(flat) == len(jax.tree.leaves(got["decoder_cell"]))
    for path, r in flat:
        node = got["decoder_cell"]
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, r, atol=5e-4, rtol=1e-3, err_msg=jax.tree_util.keystr(path))
    assert any(np.abs(r).max() > 1e-3 for _, r in flat)


def test_resolve_teacher_impl():
    """The kernel on CUDA for the architecture it implements; "xla" (the
    reference's name for its scan) is the plain loop on any device, and
    "auto" takes it on the card for a topology the kernel lacks, as the
    reference's "auto" does (tests/test_torch_impls.py has the full table)."""
    _, tcfg = tiny_pair()
    a = tcfg.arch
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tops.resolve_teacher_impl(None, a, cuda) == "fused"
    assert tops.resolve_teacher_impl("auto", a, cuda) == "fused"
    assert tops.resolve_teacher_impl(None, a, cpu) == "xla"
    assert tops.resolve_teacher_impl("fused", a, cpu) == "fused"
    assert tops.resolve_teacher_impl("xla", a, cuda) == "xla"
    deep = a.__class__(**{**a.__dict__, "decoder_gru_layers": 3})
    assert tops.resolve_teacher_impl(None, deep, cuda) == "xla"
    with pytest.raises(ValueError, match="requires Bahdanau attention"):
        tops.resolve_teacher_impl("fused", deep, cuda)
    with pytest.raises(ValueError):
        tops.resolve_teacher_impl("scan", a, cpu)


def test_teacher_weights_stay_in_the_graph(setup):
    """The Function's forward takes the live parameters (never detached),
    so every teacher weight receives a gradient."""
    _, _, _, model, memory, mmask, mel_gt = setup
    model.zero_grad()
    mel, _, _ = _decode_teacher_port(model, memory, mmask, mel_gt, "fused")
    mel.sum().backward()
    scan = ("attn_gru.", "attention.query_proj.", "attention.v", "attention.b",
            "dec_proj.", "dec_gru0.", "dec_gru1.")
    names = [n for n, _ in model.decoder_cell.named_parameters() if n.startswith(scan)]
    assert len(names) == len(tops.TeacherWeights._fields)
    for n, p in model.decoder_cell.named_parameters():
        if n in names:
            assert p.grad is not None and float(p.grad.abs().sum()) > 0, n


def test_inference_only_kernels_refuse_grad(setup):
    """B4 (fused_decode) and B2 (fused_reproject_analyze) have no gradient:
    under grad mode with an input that requires grad they raise instead of
    returning a tensor with none; under no_grad they run."""
    from sstts_torch.dsp.gl_fused import reproject_analyze
    from sstts_torch.ops import decoder as dec_ops

    _, _, _, model, memory, mmask, _ = setup
    mem = t(memory).requires_grad_()
    p = dec_ops.prepare_decode(model.decoder_cell, mem, t(mmask), 3, matmul_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="inference-only"):
        dec_ops.decode_steps(p)
    with torch.no_grad():
        assert dec_ops.decode_steps(p)["mel"].shape[1] == 3
    frames = torch.zeros(1, 4, 128, requires_grad=True)
    args = (torch.ones(1, 4, 128), torch.zeros(128, 128), torch.ones(4, 128), 100, 25, 3)
    with pytest.raises(RuntimeError, match="inference-only"):
        reproject_analyze(frames, *args)
    with torch.no_grad():
        assert reproject_analyze(frames, *args)[0].shape == (1, 4, 128)


def test_teacher_module_without_generator_refuses_dropout():
    """Dropout needs an explicit generator: train mode with a positive rate
    and none given raises rather than drawing from a global stream."""
    _, tcfg = tiny_pair()
    model = Tacotron(tcfg.arch, tcfg.dataset).train()
    with pytest.raises(ValueError, match="Generator"):
        model.encode(torch.ones(2, 5, dtype=torch.long))
