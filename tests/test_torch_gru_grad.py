"""The gradient of kernel B3: the port's `autograd.Function` (whose CPU
backward is `gru_sequence_backward_plain`, the backward kernel's explicit
reverse loop) against `jax.vjp` of the JAX package's `gru_sequence_ad` in
interpret mode, and against torch.autograd through the plain forward.

Tolerances: f32 on both sides, sums in another order over an 11-step
recurrence and its reverse: atol 1e-5, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t

from sstts.ops.pallas_gru import gru_sequence_ad
from sstts_torch.ops.gru import (
    gru_sequence,
    gru_sequence_backward_plain,
    gru_sequence_forward_plain,
    gru_sequence_plain,
)

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    B, T, D, H = 3, 11, 6, 5
    return {
        "xs": rng.normal(size=(B, T, D)).astype(np.float32),
        "wx": (rng.normal(size=(D, 3 * H)) / np.sqrt(D)).astype(np.float32),
        "wh": (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
        "b": rng.normal(0.0, 0.1, 3 * H).astype(np.float32),
        "mask": (np.arange(T)[None, :] < np.array([[11], [7], [3]])).astype(np.float32),
        "g": rng.normal(size=(B, T, H)).astype(np.float32),
    }


def _port_grads(x, masked, reverse, fn=gru_sequence):
    args = [t(x[k]).requires_grad_() for k in ("xs", "wx", "wh", "b")]
    y = fn(*args, t(x["mask"]) if masked else None, reverse)
    return torch.autograd.grad(y, args, t(x["g"]))


_CASES = [(False, False), (True, False), (True, True), (False, True)]


@pytest.mark.parametrize("masked,reverse", _CASES, ids=["full-fwd", "ragged-fwd", "ragged-rev", "full-rev"])
def test_gru_gradient_matches_jax_vjp(inputs, masked, reverse):
    x = inputs
    mask = jnp.asarray(x["mask"]) if masked else None
    _, vjp = jax.vjp(
        lambda xs, wx, wh, b: gru_sequence_ad(xs, wx, wh, b, mask, reverse, True),
        *(jnp.asarray(x[k]) for k in ("xs", "wx", "wh", "b")),
    )
    ref = vjp(jnp.asarray(x["g"]))
    got = _port_grads(x, masked, reverse)
    for name, a, r in zip(("dxs", "dwx", "dwh", "db"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize(
    "t_len,lengths,reverse",
    [(1, [1, 1, 1], False), (1, [1, 0, 1], True), (7, [7, 0, 4], False), (7, [7, 0, 4], True)],
    ids=["one-step", "one-step-empty-row", "empty-row-fwd", "empty-row-rev"],
)
def test_gru_gradient_one_step_and_empty_row(inputs, t_len, lengths, reverse):
    """A single step, and a row that is all padding: that row's dxs is zero
    and it adds nothing to the weight gradients."""
    x = dict(inputs)
    x["xs"], x["g"] = x["xs"][:, :t_len], x["g"][:, :t_len]
    x["mask"] = (np.arange(t_len)[None, :] < np.array(lengths)[:, None]).astype(np.float32)
    _, vjp = jax.vjp(
        lambda xs, wx, wh, b: gru_sequence_ad(
            xs, wx, wh, b, jnp.asarray(x["mask"]), reverse, True),
        *(jnp.asarray(x[k]) for k in ("xs", "wx", "wh", "b")),
    )
    ref = vjp(jnp.asarray(x["g"]))
    got = _port_grads(x, True, reverse)
    for name, a, r in zip(("dxs", "dwx", "dwh", "db"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL, err_msg=name)
    assert torch.all(got[0][torch.as_tensor(x["mask"]) == 0] == 0.0)


@pytest.mark.parametrize("masked,reverse", _CASES[1:3], ids=["ragged-fwd", "ragged-rev"])
def test_gru_gradient_matches_autograd_of_plain_forward(inputs, masked, reverse):
    got = _port_grads(inputs, masked, reverse)
    ref = _port_grads(inputs, masked, reverse, gru_sequence_plain)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=ATOL, rtol=RTOL)


def test_backward_plain_passes_the_carry_through_padding(inputs):
    """On padded steps the gate gradients are exactly zero, and the carry
    gradient crosses them unchanged (the padded row's early steps still get
    the gradient of its later valid outputs in the reverse direction)."""
    x = inputs
    xs, wx, wh, b, mask = (t(x[k]) for k in ("xs", "wx", "wh", "b", "mask"))
    for reverse in (False, True):
        _, gates, hprev = gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
        dgx, dgh = gru_sequence_backward_plain(t(x["g"]), gates, hprev, wh, mask, reverse)
        assert dgx.shape == dgh.shape == (3, 11, 15)
        assert torch.all(dgx[mask == 0] == 0.0) and torch.all(dgh[mask == 0] == 0.0)
        assert torch.all(dgx[mask > 0].abs().sum(-1) > 0)


def test_gradient_path_only_under_grad(inputs):
    """Under no_grad nothing is kept; with grad the output hangs off the
    Function, never a detached tensor."""
    x = inputs
    args = [t(x[k]).requires_grad_() for k in ("xs", "wx", "wh", "b")]
    with torch.no_grad():
        assert gru_sequence(*args, None, False).grad_fn is None
    y = gru_sequence(*args, None, False)
    assert y.requires_grad and type(y.grad_fn).__name__ == "_GRUSequenceBackward"
