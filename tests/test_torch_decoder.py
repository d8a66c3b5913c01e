"""Kernel B4's plain version and the port's decoder loop, held to JAX.

Both sides run f32 with dropout off (JAX's kernel draws its noise on the
TPU core, a different stream by design).  Tolerances follow
tests/test_pallas_decoder.py: mel and stop logits within 2e-4 and
alignments within 2e-5 after S autoregressive steps (f32, another
summation order), and the frame counts identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_variables, port_model, t, text_ids, tiny_pair

from sstts.model.tacotron import Tacotron as JaxTacotron
from sstts.ops.pallas_decoder import fused_decode as jax_fused_decode
from sstts_torch.ops import decoder as dec_ops


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_pair(arch={"prenet_dropout_at_inference": False})
    v = jax_variables(jcfg, seed=2)
    jmodel = JaxTacotron(jcfg.arch, jcfg.dataset)
    ids = text_ids(np.random.default_rng(5), [8, 3, 6], 8)
    memory, mmask = jmodel.apply(v, jnp.asarray(ids), False, method=JaxTacotron.encode)
    return jcfg, tcfg, v, jmodel, port_model(tcfg, v), np.asarray(memory), np.asarray(mmask)


def _compare(got, ref, mel_atol=2e-4):
    np.testing.assert_array_equal(got["n_frames"].numpy(), np.asarray(ref["n_frames"]))
    for key, atol in (("mel", mel_atol), ("stop_logits", mel_atol), ("alignments", 2e-5)):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(ref[key], np.float32), atol=atol, err_msg=key
        )


@pytest.mark.parametrize(
    "stop_threshold,min_steps", [(1.5, 2), (0.0, 3)], ids=["never", "at_min"]
)
def test_fused_decode_plain_matches_jax_kernel(setup, stop_threshold, min_steps):
    jcfg, tcfg, v, jmodel, model, memory, mmask = setup
    ref = jax_fused_decode(
        v["params"]["decoder_cell"], jnp.asarray(memory), jnp.asarray(mmask), 7,
        n_mels=jcfg.dataset.n_mels, reduction=jcfg.arch.reduction_factor,
        stop_threshold=stop_threshold, min_steps=min_steps,
        apply_dropout=False, matmul_dtype=jnp.float32, interpret=True,
    )
    with torch.no_grad():
        got = dec_ops.fused_decode(
            model.decoder_cell, t(memory), t(mmask), 7,
            stop_threshold=stop_threshold, min_steps=min_steps,
            matmul_dtype=torch.float32,
        )
    _compare(got, ref)


def test_decode_infer_matches_jax(setup):
    """The module loop against flax's nn.scan, with a threshold at which
    rows stop at different steps."""
    jcfg, tcfg, v, jmodel, model, memory, mmask = setup
    ref = jmodel.apply(
        v, jnp.asarray(memory), jnp.asarray(mmask), 6, 0.5, 1,
        method=JaxTacotron.decode_infer, rngs={"dropout": jax.random.PRNGKey(1)},
    )
    with torch.no_grad():
        got = model.decode_infer(t(memory), t(mmask), 6, 0.5, 1)
    _compare(got, ref)
    n = got["n_frames"].numpy()
    mel = got["mel"].numpy()
    for b in range(mel.shape[0]):  # silence after each row's stop
        assert np.abs(mel[b, n[b]:]).max(initial=0.0) == 0.0


def test_plain_kernel_math_matches_module_loop_with_dropout(setup):
    """With dropout ON at one seed, the kernel's plain version (f32) and the
    module loop draw the same keep masks (`keep_masks`, the kernel's bits)
    and agree: the seed is the whole noise contract between the paths."""
    jcfg, tcfg, v, jmodel, model, memory, mmask = setup
    keep = dec_ops.keep_masks(123, 0, 7, memory.shape[0], tcfg.arch.prenet_units, 0.5)
    assert 0.3 < float(keep[0].mean()) < 0.7
    with torch.no_grad():
        a = dec_ops.fused_decode(
            model.decoder_cell, t(memory), t(mmask), 7, stop_threshold=0.5,
            min_steps=2, seed=123, matmul_dtype=torch.float32,
        )
        b = model.decode_infer(t(memory), t(mmask), 7, 0.5, 2, 123)
    np.testing.assert_array_equal(a["n_frames"].numpy(), b["n_frames"].numpy())
    for key in ("mel", "stop_logits", "alignments"):
        np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), atol=2e-5, err_msg=key)


def test_fused_decode_bf16_plain_matches_jax_kernel(setup):
    """The default bf16 products: both sides round activations and weights
    to bf16 before each product, so they agree to f32 summation noise
    re-rounded to bf16 (a bf16 step is 2^-8 relative): 2e-2."""
    jcfg, tcfg, v, jmodel, model, memory, mmask = setup
    ref = jax_fused_decode(
        v["params"]["decoder_cell"], jnp.asarray(memory), jnp.asarray(mmask), 7,
        n_mels=jcfg.dataset.n_mels, reduction=jcfg.arch.reduction_factor,
        stop_threshold=1.5, min_steps=2, apply_dropout=False,
        matmul_dtype=jnp.bfloat16, interpret=True,
    )
    with torch.no_grad():
        got = dec_ops.fused_decode(
            model.decoder_cell, t(memory), t(mmask), 7, stop_threshold=1.5,
            min_steps=2, matmul_dtype=torch.bfloat16,
        )
    np.testing.assert_array_equal(got["n_frames"].numpy(), np.asarray(ref["n_frames"]))
    for key in ("mel", "stop_logits", "alignments"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(ref[key], np.float32), atol=2e-2, err_msg=key
        )
