"""Each layer of a `compute_dtype="bfloat16"` model held to its flax
counterpart on the same bf16 inputs and f32 parameters, on the CPU: the
outputs and their dtypes, the running statistics where batch norm trains,
and the gradients (one seeded cotangent) of the inputs and of every
parameter the layer reads.  The layers: a dense layer, the embedding, a
prenet, a highway, the conv bank (unfused in train mode, fused in eval
mode), masked batch norm (masked, unmasked, eval), the GRU cell, the
BiGRU, `masked_softmax`, both attentions, one decoder step with each, and
the whole CBHG in both modes.

Both sides round at the same places, so one layer's outputs are bit-equal
(the highway's one rounding apart: XLA fuses its gate's sum), and its
gradients a rounding or so apart where a gradient is a bf16 sum.  `LIMITS`
gives each case's limits beside its readings.  The controls compute one of
the reference's f32 islands in bf16 instead and read thousands of times
their limits: the BiGRU's recurrence (4.8e-3 against the BiGRU's
exactness), the attention's softmax (1.3e-3) and masked batch norm's
statistics (3.9e-3).
"""

import dataclasses
from typing import Callable, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_variables, port_model, rel_l2, text_ids, tiny_pair

import sstts_torch.model.attention as patt
import sstts_torch.model.rnn as prnn
from sstts.model import modules as jmod
from sstts.model.attention import masked_softmax as jax_masked_softmax
from sstts.model.decoder import DecoderCarry as JaxCarry
from sstts.model.rnn import BiGRU as JaxBiGRU
from sstts.model.tacotron import Tacotron as JaxTacotron
from sstts_torch.convert import _convert_leaf, _leaves, to_flax
from sstts_torch.model import modules as pmod
from sstts_torch.model.attention import linear, masked_softmax
from sstts_torch.model.decoder import DecoderCarry
from sstts_torch.model.rnn import BiGRU
from sstts_torch.ops.gru import gru_step_math

BF = jnp.bfloat16
CONTROL_MARGIN = 10.0
B, T = 3, 9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_values(a) -> np.ndarray:
    """`a` rounded to bf16, as f32 numpy: the same values on both sides."""
    return np.asarray(jnp.asarray(a, BF).astype(jnp.float32))


def to_port(a):
    if a is None:
        return None
    a = torch.from_numpy(np.array(a))
    return a.to(torch.bfloat16) if a.dtype == torch.float32 else a


@dataclasses.dataclass
class Case:
    """`jax_fn(params, *inputs)` and `port_fn(*inputs)` each return (outputs,
    aux): outputs are differentiated, aux (running statistics) only
    compared.  `inputs` are numpy bf16 values; `module` holds the port's
    parameters, loaded from `params`."""

    jax_fn: Callable
    port_fn: Callable
    module: torch.nn.Module
    params: dict
    inputs: Sequence[np.ndarray]


def load(module, params, stats=None):
    """The flax `params` (and `batch_stats`) of a module into its port."""
    state = {}
    for tree in (params, stats or {}):
        for path, value in _leaves(tree):
            key, arr = _convert_leaf(path, value)
            state[key] = torch.from_numpy(np.array(arr, np.float32))
    module.load_state_dict(state)
    return module


def buffers(module) -> dict:
    """A module's running statistics as a flax `batch_stats` tree."""
    return to_flax({n: b.detach() for n, b in module.named_buffers()})[1]


def perturbed_stats(stats, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.normal(0, 0.2, x.shape) if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, x.shape)).astype(np.float32),
        stats)


@pytest.fixture(scope="module")
def models():
    """The tiny bf16 model, Bahdanau and local-Luong, in both packages
    (prenet dropout off at inference, so the decoder step is
    deterministic)."""
    out = {}
    for kind, extra in (("bahdanau", {}),
                        ("luong", {"attention_type": "local_luong",
                                   "local_attention_window": 2})):
        jcfg, pcfg = tiny_pair(arch={"compute_dtype": "bfloat16",
                                     "prenet_dropout_at_inference": False, **extra})
        v = jax_variables(jcfg, seed=4)
        out[kind] = (JaxTacotron(jcfg.arch, jcfg.dataset, dtype=BF), v, port_model(pcfg, v),
                     pcfg)
    return out


def rand(rng, *shape, scale=1.0):
    return bf16_values(rng.normal(0.0, scale, shape).astype(np.float32))


def model_case(models, kind, jax_method, port_fn, inputs, train=False):
    jmodel, v, model, _ = models[kind]

    def jax_fn(p, *xs):
        return jmodel.apply({"params": p, "batch_stats": v["batch_stats"]}, *xs,
                            method=jax_method), ()

    model.train(train)
    return Case(jax_fn, port_fn, model, v["params"], inputs)


def standalone_case(jmodule, pmodule, inputs, consts=(), train=None, seed=0):
    """A flax module initialised from `seed` and its port; `train` None for
    a module without batch norm, else its mode (train: the updated running
    statistics are aux outputs)."""
    jconsts = [None if c is None else jnp.asarray(c) for c in consts]
    jx = [jnp.asarray(a, BF) for a in inputs] + jconsts
    extra = () if train is None else (train,)
    v = jmodule.init(jax.random.PRNGKey(seed), *jx, *extra)
    v = jax.tree.map(np.asarray, v)
    stats = perturbed_stats(v["batch_stats"], seed) if "batch_stats" in v else None
    load(pmodule, v["params"], stats)
    pmodule.train(bool(train))

    def jax_fn(p, *xs):
        variables = {"params": p} if stats is None else {"params": p, "batch_stats": stats}
        if train:
            out, upd = jmodule.apply(variables, *xs, *jconsts, *extra,
                                     mutable=["batch_stats"])
            return out, upd["batch_stats"]
        return jmodule.apply(variables, *xs, *jconsts, *extra), ()

    def port_fn(*xs):
        out = pmodule(*xs, *map(to_port, consts))
        return out, buffers(pmodule) if train else ()

    return Case(jax_fn, port_fn, pmodule, v["params"], inputs)


def carry_inputs(rng, arch, memory_dim):
    align = bf16_values(rng.dirichlet(np.ones(T), size=B).astype(np.float32))
    return [rand(rng, B, arch.attention_gru_units, scale=0.5),
            *[rand(rng, B, arch.decoder_gru_units, scale=0.5)
              for _ in range(arch.decoder_gru_layers)],
            rand(rng, B, memory_dim, scale=0.5), align, rand(rng, B, 20)]


def decoder_step_case(models, kind):
    jmodel, v, model, pcfg = models[kind]
    a = pcfg.arch
    rng = np.random.default_rng(11)
    dm = 2 * a.encoder_gru_units
    mask = np.arange(T)[None] < np.array([[9], [4], [7]])
    inputs = [rand(rng, B, T, dm)] + carry_inputs(rng, a, dm)
    n = a.decoder_gru_layers

    def jax_step(m, memory, attn_h, *rest):
        dec_hs, (context, align, prev) = rest[:n], rest[n:]
        carry = JaxCarry(attn_h, tuple(dec_hs), context, align, prev, jnp.zeros(B, bool))
        cell = m.decoder_cell
        new, out = cell(carry, None, memory, cell.init_keys(memory), jnp.asarray(mask),
                        train=False)
        return (out.mel, out.stop_logits, out.alignment, new.attn_h, *new.dec_hs,
                new.context)

    def port_step(memory, attn_h, *rest):
        dec_hs, (context, align, prev) = rest[:n], rest[n:]
        carry = DecoderCarry(attn_h, tuple(dec_hs), context, align, prev,
                             torch.zeros(B, dtype=torch.bool))
        cell = model.decoder_cell
        new, out = cell(carry, memory, cell.attention.init_keys(memory), torch.as_tensor(mask))
        return (out.mel, out.stop_logits, out.alignment, new.attn_h, *new.dec_hs,
                new.context), ()

    return model_case(models, kind, jax_step, port_step, inputs)


def attention_case(models, kind):
    jmodel, v, model, pcfg = models[kind]
    a = pcfg.arch
    rng = np.random.default_rng(12)
    mask = np.arange(T)[None] < np.array([[9], [4], [7]])
    align = bf16_values(rng.dirichlet(np.ones(T), size=B).astype(np.float32))
    inputs = [rand(rng, B, a.attention_gru_units), rand(rng, B, T, 2 * a.encoder_gru_units),
              align]

    def jax_att(m, query, memory, prev):
        att = m.decoder_cell.attention
        keys = m.decoder_cell.init_keys(memory)
        return keys, att(query, keys, jnp.asarray(mask), prev)

    def port_att(query, memory, prev):
        att = model.decoder_cell.attention
        keys = att.init_keys(memory)
        return (keys, att(query, keys, torch.as_tensor(mask), prev)), ()

    return model_case(models, kind, jax_att, port_att, inputs)


def cbhg_case(models, train):
    jmodel, v, model, pcfg = models["bahdanau"]
    rng = np.random.default_rng(13)
    ids = text_ids(rng, [9, 4, 7], T)
    mask = ids != 0
    x = rand(rng, B, T, pcfg.arch.prenet_units[-1])

    def jax_fn(p, x):
        variables = {"params": p, "batch_stats": v["batch_stats"]}
        call = lambda m, x: m.encoder_cbhg(x, jnp.asarray(mask), train=train)  # noqa: E731
        if train:
            out, upd = jmodel.apply(variables, x, method=call, mutable=["batch_stats"])
            return out, upd["batch_stats"]["encoder_cbhg"]
        return jmodel.apply(variables, x, method=call), ()

    def port_fn(x):
        cbhg = model.encoder_cbhg
        return cbhg(x, torch.as_tensor(mask)), buffers(cbhg) if train else ()

    model.train(train)
    return Case(jax_fn, port_fn, model, v["params"], [x])


def cases(models) -> dict:
    rng = np.random.default_rng(7)
    ids = text_ids(rng, [9, 4, 7], T)
    mask = ids != 0
    _, _, model, pcfg = models["bahdanau"]
    a = pcfg.arch
    x16 = rand(rng, B, T, 16)
    return {
        "dense": lambda: model_case(
            models, "bahdanau", lambda m, x: m.linear_proj(x),
            lambda x: (linear(x, model.linear_proj, torch.bfloat16), ()),
            [rand(rng, B, T, 2 * a.post_gru_units)]),
        "embedding": lambda: model_case(
            models, "bahdanau", lambda m: m.embedding(jnp.asarray(ids)),
            lambda: (model.embed(torch.as_tensor(ids).long()), ()), []),
        "prenet": lambda: model_case(
            models, "bahdanau", lambda m, x: m.encoder_prenet(x, train=False),
            lambda x: (model.encoder_prenet(x), ()), [rand(rng, B, T, a.embedding_dim)]),
        "highway": lambda: standalone_case(
            jmod.Highway(16, dtype=BF), pmod.Highway(16, torch.bfloat16), [x16]),
        "conv_bank_train": lambda: standalone_case(
            jmod.Conv1dBank(4, 8, dtype=BF), pmod.Conv1dBank(16, 4, 8, torch.bfloat16),
            [x16], [mask], train=True),
        "conv_bank_fused_eval": lambda: standalone_case(
            jmod.Conv1dBank(4, 8, dtype=BF, fused=True),
            pmod.Conv1dBank(16, 4, 8, torch.bfloat16, True), [x16], [mask], train=False),
        "batchnorm_train_masked": lambda: standalone_case(
            jmod.MaskedBatchNorm(dtype=BF), pmod.MaskedBatchNorm(16, dtype=torch.bfloat16),
            [x16], [mask], train=True),
        "batchnorm_train_unmasked": lambda: standalone_case(
            jmod.MaskedBatchNorm(dtype=BF), pmod.MaskedBatchNorm(16, dtype=torch.bfloat16),
            [x16], [None], train=True),
        "batchnorm_eval": lambda: standalone_case(
            jmod.MaskedBatchNorm(dtype=BF), pmod.MaskedBatchNorm(16, dtype=torch.bfloat16),
            [x16], [mask], train=False),
        "gru_cell": lambda: model_case(
            models, "bahdanau", lambda m, x, h: m.decoder_cell.attn_gru(h, (x, None))[0],
            lambda x, h: (model.decoder_cell.attn_gru(x, h), ()),
            [rand(rng, B, a.prenet_units[-1] + 2 * a.encoder_gru_units),
             rand(rng, B, a.attention_gru_units, scale=0.5)]),
        "bigru": lambda: bigru_case(rng, mask),
        "masked_softmax": lambda: Case(
            lambda p, s: (jax_masked_softmax(s, jnp.asarray(mask)), ()),
            lambda s: (masked_softmax(s, torch.as_tensor(mask)), ()),
            torch.nn.Module(), {}, [rand(rng, B, T, scale=3.0)]),
        "bahdanau_attention": lambda: attention_case(models, "bahdanau"),
        "luong_attention": lambda: attention_case(models, "luong"),
        "decoder_step_bahdanau": lambda: decoder_step_case(models, "bahdanau"),
        "decoder_step_luong": lambda: decoder_step_case(models, "luong"),
        "cbhg_train": lambda: cbhg_case(models, True),
        "cbhg_eval": lambda: cbhg_case(models, False),
    }


def bigru_case(rng, mask):
    """The BiGRU computes in f32 and its caller (the CBHG) casts the output
    to the compute dtype, as flax's BiGRU(dtype=bf16) returns it."""
    gru = BiGRU(16, 8)
    case = standalone_case(JaxBiGRU(8, dtype=BF, backend="xla"), gru,
                           [rand(rng, B, T, 16)], [mask])
    port_fn = case.port_fn
    case.port_fn = lambda x: (port_fn(x)[0].to(torch.bfloat16), ())
    return case


def as_list(out) -> List:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare(got, ref) -> float:
    """Relative L2 of `got` (a tensor, or None for no gradient) to `ref`;
    where `ref` is zero, 0 if `got` is zero too, else infinity."""
    ref = np.asarray(ref, np.float32)
    got = np.zeros_like(ref) if got is None else np.asarray(got, np.float32)
    if not np.any(ref):
        return 0.0 if not np.any(got) else float("inf")
    return rel_l2(got, ref)


def by_path(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def run(case: Case, out_limit: float, grad_limit: float, seed: int = 0) -> dict:
    """Outputs, aux and gradients of both sides -> {name: (rel_l2, limit)}:
    outputs and aux held to `out_limit`, gradients to `grad_limit`."""
    jx = [jnp.asarray(a, BF) for a in case.inputs]
    jout, vjp, jaux = jax.vjp(case.jax_fn, case.params, *jx, has_aux=True)
    jouts = as_list(jout)
    rng = np.random.default_rng(seed + 100)
    cots = [bf16_values(rng.normal(size=o.shape).astype(np.float32)) for o in jouts]
    jcots = [jnp.asarray(c, o.dtype) for c, o in zip(cots, jouts)]
    jgrads = vjp(type(jout)(jcots) if isinstance(jout, (tuple, list)) else jcots[0])
    pparams = dict(case.module.named_parameters())
    for p in pparams.values():
        p.grad = None
    px = [to_port(a).requires_grad_() for a in case.inputs]
    pout, paux = case.port_fn(*px)
    pout = as_list(pout)
    assert len(pout) == len(jouts)
    torch.autograd.backward(pout, [torch.as_tensor(c).to(o.dtype) for c, o in zip(cots, pout)])
    res = {}
    dtypes = {jnp.dtype(BF): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    for i, (g, r) in enumerate(zip(pout, jouts)):
        assert g.dtype == dtypes[r.dtype], (i, g.dtype, r.dtype)
        res[f"out{i}"] = (compare(g.detach().float(), r), out_limit)
    jaux, paux = by_path(jaux), by_path(paux)
    assert sorted(jaux) == sorted(paux)
    for k, r in jaux.items():
        res["aux" + k] = (compare(paux[k], r), out_limit)
    for i, (g, r) in enumerate(zip(px, jgrads[1:])):
        assert g.grad is None or g.grad.dtype == torch.bfloat16
        res[f"d_in{i}"] = (compare(None if g.grad is None else g.grad.float(), r),
                           grad_limit)
    got = by_path(to_flax({n: p.grad for n, p in pparams.items() if p.grad is not None})[0])
    for k, r in by_path(jgrads[0]).items():
        if np.any(r):
            res["d" + k] = (compare(got[k], r), grad_limit)
    return res


#: (outputs, gradients) limits by case, relative L2, beside the readings.
#: EXACT: the outputs bit-equal (f32 ones, the softmax's, to f32 rounding);
#: the gradients hold bf16 sums (a bias's over B x T, the query's over T),
#: which XLA rounds as it adds and PyTorch once: up to 1.1e-2.  The CBHG
#: is a dozen layers deep, and its roundings compound.
EXACT, ONE_ROUNDING, LAYER_GRAD = 1e-6, 4e-3, 1.5e-2
LIMITS = {
    "dense": (EXACT, LAYER_GRAD),  # out 0; grads 7.1e-3 (bias)
    "embedding": (EXACT, LAYER_GRAD),  # 0; 0
    "prenet": (EXACT, LAYER_GRAD),  # 0; 7.2e-3 (bias)
    "highway": (ONE_ROUNDING, LAYER_GRAD),  # 2.6e-3 (XLA fuses the gate's sum); 7.8e-3
    "conv_bank_train": (EXACT, LAYER_GRAD),  # 0, statistics 0; 6e-8
    "conv_bank_fused_eval": (EXACT, LAYER_GRAD),  # 0; 9e-8
    "batchnorm_train_masked": (EXACT, LAYER_GRAD),  # 0, statistics 0; 2e-7
    # Without a mask both take the statistics of the bf16 batch in bf16
    # (jnp.mean of a bf16 array): the running statistics 1.9e-5 apart.
    "batchnorm_train_unmasked": (1e-4, LAYER_GRAD),  # 0; 3.0e-3
    "batchnorm_eval": (EXACT, LAYER_GRAD),  # 0; 2e-7
    "gru_cell": (EXACT, LAYER_GRAD),  # 0; 2.8e-3
    "bigru": (EXACT, LAYER_GRAD),  # 0; 2e-7
    "masked_softmax": (EXACT, LAYER_GRAD),  # 1.2e-8; 0
    "bahdanau_attention": (EXACT, LAYER_GRAD),  # 2.3e-8; 9.2e-3 (query)
    "luong_attention": (EXACT, LAYER_GRAD),  # 4e-9; 0
    "decoder_step_bahdanau": (EXACT, LAYER_GRAD),  # 0; 1.07e-2 (attention bias)
    "decoder_step_luong": (EXACT, LAYER_GRAD),  # 0; 3.4e-3
    "cbhg_train": (8e-3, 5e-2),  # 3.8e-3; 1.9e-2
    "cbhg_eval": (1.5e-2, 5e-2),  # 7.6e-3; 4.0e-2
}


def checked(models, name) -> dict:
    return run(cases(models)[name](), *LIMITS[name])


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_bf16_layer_matches_flax(models, name):
    res = checked(models, name)
    bad = {k: v for k, (v, lim) in res.items() if not v <= lim}
    assert not bad, bad


def bf16_gru_sequence(xs, wx, wh, b, mask, reverse):
    """A GRU recurrence in bf16: the carry rounded every step."""
    bf = torch.bfloat16
    h = xs.new_zeros(xs.shape[0], wh.shape[0], dtype=bf)
    ys = [None] * xs.shape[1]
    for t in (range(xs.shape[1] - 1, -1, -1) if reverse else range(xs.shape[1])):
        m = mask[:, t, None].to(bf)
        h = m * gru_step_math(xs[:, t].to(bf), h, wx.to(bf), wh.to(bf), b.to(bf)) + (1 - m) * h
        ys[t] = m * h
    return torch.stack(ys, 1)


def bf16_softmax(scores, mask):
    """The attention's softmax in bf16, returned as f32."""
    scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
    return torch.softmax(scores.to(torch.bfloat16), -1).float()


def bf16_statistics(self, x, mask=None):
    """Masked batch norm whose batch statistics are taken in bf16."""
    m = mask[..., None].to(x.dtype)
    count = m.sum().clamp(min=1.0)
    mean = (x * m).sum((0, 1)) / count
    var = (((x - mean) ** 2) * m).sum((0, 1)) / count
    with torch.no_grad():
        self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
        self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
    y = (x - mean) / torch.sqrt(var + self.epsilon)
    return (y * self.scale + self.bias).to(self.dtype)


@pytest.mark.parametrize("island,case,patch", [
    ("bigru", "bigru", (prnn, "gru_sequence", bf16_gru_sequence)),
    ("softmax", "bahdanau_attention", (patt, "masked_softmax", bf16_softmax)),
    ("batchnorm_statistics", "batchnorm_train_masked",
     (pmod.MaskedBatchNorm, "forward", bf16_statistics)),
])
def test_an_f32_island_computed_in_bf16_fails_the_limits(models, monkeypatch, island, case,
                                                          patch):
    """The controls: the port with one of the reference's f32 islands
    computed in bf16 instead reads past its case's limits, by more than
    CONTROL_MARGIN times."""
    monkeypatch.setattr(*patch)
    res = checked(models, case)
    worst = max(v / lim for v, lim in res.values())
    assert worst > CONTROL_MARGIN, (island, worst)
