"""`compute_dtype="bfloat16"` held to the JAX package's bf16 model on the
CPU: encode, the teacher-forced forward, an 8-step decode, the post-net,
the Synthesizer end to end, one train step and the checkpoint's
fingerprint; and the port's bf16 against its own f32, the size of the
bf16 effect.

Both sides cast to bf16 at the same places (flax's `dtype=`: dense layers,
convolutions, the embedding, batch norm's output, the decoder's carry), but
a bf16 op's result is rounded once per op in the port, where XLA on the CPU
may compute a fused chain of them in f32 and round at its end, and the
products sum in other orders.  So the two agree to bf16 noise,
not to f32 noise: about 5e-3 relative L2 on activations (measured 3e-3 to
5e-3), the same size as the bf16 effect itself (JAX's bf16 against its f32:
2e-3 to 5e-3).  Limits, relative L2: 2e-2 on encoder memory, forward
outputs, decode (8 steps, stop threshold above 1 so every row runs them
all) and post-net; 5e-2 on the waveform after 3 Griffin-Lim iterations in
f32 ("dft_highest"; measured 2.4e-2, where the bf16 effect on it is
4.4e-2).  The train step, over six batches (they follow the process's
hash): loss within rtol 2e-3 (measured up to 3.3e-4), the gradient norm
within 2e-2 (up to 7.7e-3), and three named gradients within 3e-2
relative L2 (4e-3 to 1.2e-2).  A bf16 gradient leaf far down the graph
(the post-net's conv bank) reads up to ~0.2 apart, as JAX's own bf16
gradient reads ~0.25 from its f32 one: those are not compared here.  The
whole gradient reads 4e-2 to 7e-2 relative L2 from JAX's (cosine 0.997 to
0.999), where JAX's own bf16 gradient reads 5e-2 to 1.1e-1 from its f32
one: past a few layers the roundings compound, so these limits cannot tell
where each side casts.  tests/test_torch_bf16_layers.py holds that, layer
by layer, outputs and every parameter's gradient, to a rounding or so.
Dropout is off on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    jax_train_grads, jax_variables, port_model, port_train_grads, rel_l2, t, text_ids,
    tiny_pair, train_batch, tree_pairs,
)

from sstts.model.tacotron import Tacotron as JaxTacotron
from sstts.synthesize import Synthesizer as JaxSynthesizer
from sstts_torch.convert import convert_params
from sstts_torch.synthesize import Synthesizer

ACT, WAV = 2e-2, 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = tiny_pair(arch={"compute_dtype": "bfloat16",
                                 "prenet_dropout_at_inference": False})
    v = jax_variables(jcfg, seed=4)
    jmodel = JaxTacotron(jcfg.arch, jcfg.dataset, dtype=jnp.bfloat16)
    model = port_model(pcfg, v)
    assert model.dtype == torch.bfloat16
    ids = text_ids(np.random.default_rng(5), [8, 3, 6], 8)
    mel = np.random.default_rng(6).normal(size=(3, 10, jcfg.dataset.n_mels)).astype(np.float32)
    fmask = np.arange(10)[None] < np.array([[10], [5], [10]])
    return jcfg, pcfg, v, jmodel, model, ids, mel, fmask


def test_encode_forward_and_postprocess_match_jax(setup):
    jcfg, pcfg, v, jmodel, model, ids, mel, fmask = setup
    memory, _ = jmodel.apply(v, jnp.asarray(ids), False, method=JaxTacotron.encode)
    ref = jmodel.apply(v, jnp.asarray(ids), jnp.asarray(mel), jnp.asarray(fmask),
                       train=False, rngs={"dropout": jax.random.PRNGKey(0)})
    post = jmodel.apply(v, jnp.asarray(mel, jnp.bfloat16), jnp.asarray(fmask), False,
                        method=JaxTacotron.postprocess)
    with torch.no_grad():
        pmem, _ = model.encode(t(ids).long())
        got = model(t(ids).long(), t(mel), t(fmask))
        ppost = model.postprocess(t(mel).to(torch.bfloat16), t(fmask))
    assert memory.dtype == jnp.bfloat16 and pmem.dtype == torch.bfloat16
    assert ppost.dtype == torch.bfloat16
    assert rel_l2(f32(pmem), f32(memory)) < ACT
    assert rel_l2(f32(ppost), f32(post)) < ACT
    for key in ("mel", "linear", "stop_logits", "alignments"):
        assert got[key].dtype == torch.float32  # the losses read f32
        assert rel_l2(f32(got[key]), f32(ref[key])) < ACT, key


def test_decode_matches_jax(setup):
    """8 steps of the plain loop (a bf16 carry, as the reference's scan)."""
    jcfg, pcfg, v, jmodel, model, ids, _, _ = setup
    memory, mmask = jmodel.apply(v, jnp.asarray(ids), False, method=JaxTacotron.encode)
    ref = jmodel.apply(v, memory, mmask, 8, 1.1, 2, method=JaxTacotron.decode_infer,
                       rngs={"dropout": jax.random.PRNGKey(1)})
    with torch.no_grad():
        pmem, pmask = model.encode(t(ids).long())
        got = model.decode_infer(pmem, pmask, 8, 1.1, 2)
    np.testing.assert_array_equal(got["n_frames"].numpy(), np.asarray(ref["n_frames"]))
    for key in ("mel", "stop_logits", "alignments"):
        assert got[key].dtype == torch.bfloat16, key
        assert rel_l2(f32(got[key]), f32(ref[key])) < ACT, key


def test_bf16_effect_against_f32(setup):
    """The port's bf16 forward against its f32 forward on the same weights:
    a real but small effect, the size of JAX's own."""
    jcfg, pcfg, v, jmodel, model, ids, mel, fmask = setup
    f32cfg = pcfg.replace(arch=dataclasses.replace(pcfg.arch, compute_dtype="float32"))
    model32 = port_model(f32cfg, v)
    assert model32.dtype == torch.float32
    with torch.no_grad():
        a = model(t(ids).long(), t(mel), t(fmask))
        b = model32(t(ids).long(), t(mel), t(fmask))
    for key in ("mel", "linear"):
        effect = rel_l2(f32(a[key]), f32(b[key]))
        assert 1e-4 < effect < ACT, (key, effect)


def test_synthesizer_matches_jax():
    """The slice end to end: the bf16 linear spectrogram enters the f32
    Griffin-Lim loop through bf16 dB-to-magnitude arithmetic in both."""
    jcfg, pcfg = tiny_pair(
        arch={"compute_dtype": "bfloat16", "prenet_dropout_at_inference": False},
        inference={"max_decoder_steps": 6, "griffin_lim_iters": 3, "stop_threshold": 1.1,
                   "griffin_lim_fft_impl": "dft_highest"},
    )
    v = jax_variables(jcfg, seed=4)
    texts = ["hello world", "a much longer sentence to speak"]
    jw, jfull = JaxSynthesizer(jcfg, v["params"], v["batch_stats"]).synthesize_batch(
        texts, full_output=True)
    port = Synthesizer(pcfg, convert_params(v["params"], v["batch_stats"], pcfg), device="cpu")
    assert port.model.dtype == torch.bfloat16
    tw, tfull = port.synthesize_batch(texts, full_output=True)
    np.testing.assert_array_equal(tfull["n_samples"], np.asarray(jfull["n_samples"]))
    for key in ("mel", "linear"):
        assert tfull[key].dtype == np.float32  # bf16 leaves the device as f32
        assert rel_l2(tfull[key], f32(jfull[key])) < ACT, key
    assert np.isfinite(tfull["wav"]).all()
    assert rel_l2(tfull["wav"], f32(jfull["wav"])) < WAV
    assert [len(w) for w in tw] == [len(w) for w in jw]


def test_train_step_matches_jax():
    jcfg, pcfg = tiny_pair(
        dataset={"dataset": "synthetic"},
        arch={"compute_dtype": "bfloat16", "prenet_dropout": 0.0},
        training={"batch_size": 2, "text_buckets": (48,), "frame_buckets": (96,)},
    )
    v = jax_variables(jcfg, seed=7)
    batch = train_batch(pcfg)
    jm, jgrads = jax_train_grads(jcfg, v, batch)
    pm, pgrads = port_train_grads(pcfg, v, batch)
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=2e-3)
    np.testing.assert_allclose(pm["grad_norm"], jm["grad_norm"], rtol=2e-2)
    named = {"['decoder_cell']['stop_proj']['kernel']", "['linear_proj']['bias']",
             "['post_cbhg']['gru']['forward']['b']"}
    seen = set()
    for path, g, r in tree_pairs(jgrads, pgrads):
        assert g.dtype == np.float32  # parameters and their gradients stay f32
        if path in named:
            assert rel_l2(g, r) < 3e-2, (path, rel_l2(g, r))
            seen.add(path)
    assert seen == named


def test_checkpoint_fingerprint_and_f32_parameters(tmp_path):
    """The port's bf16 checkpoint carries the reference's fingerprint (which
    names compute_dtype), stores f32 parameters, and refuses the f32
    config."""
    from sstts_torch import train as ptrain
    from sstts_torch.checkpoint import CheckpointManager

    jcfg, pcfg = tiny_pair(arch={"compute_dtype": "bfloat16"})
    assert pcfg.fingerprint() == jcfg.fingerprint()
    assert '"compute_dtype": "bfloat16"' in pcfg.fingerprint()
    state = ptrain.create_state(pcfg, device="cpu")
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    ckpt = CheckpointManager(pcfg, tmp_path)
    ckpt.save(1, state)
    assert (ckpt.dir / "config.json").read_text() == jcfg.fingerprint()
    f32cfg = pcfg.replace(arch=dataclasses.replace(pcfg.arch, compute_dtype="float32"))
    with pytest.raises(ValueError):
        CheckpointManager(f32cfg, tmp_path)
    fresh = ptrain.create_state(pcfg, seed=3, device="cpu")
    assert CheckpointManager(pcfg, tmp_path).restore_latest(fresh) == 1
    for (n, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_gru_gradient_of_a_bf16_activation_is_bf16(monkeypatch):
    """The GRU upcasts its input to f32 (as the reference's kernel) and
    returns f32; the gradient reaching a bf16 activation comes back in
    bf16, once per direction through the backward recurrence."""
    import sstts_torch.ops.gru as gru_ops
    from sstts_torch.model.rnn import BiGRU

    g = torch.Generator().manual_seed(0)
    gru = BiGRU(4, 3)
    with torch.no_grad():
        for p in gru.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    x = torch.randn(2, 5, 4, generator=g).to(torch.bfloat16).requires_grad_()
    mask = torch.arange(5)[None] < torch.tensor([[5], [3]])
    calls = []
    orig = gru_ops.gru_sequence_backward

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(gru_ops, "gru_sequence_backward", counting)
    y = gru(x, mask)
    assert y.dtype == torch.float32  # the CBHG casts it to the compute dtype
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
    assert len(calls) == 2
    assert all(p.grad.dtype == torch.float32 for p in gru.parameters())
