"""The port's training path held to `sstts.train` on the CPU: batch norm in
train mode, one whole train step (loss, metrics, every gradient leaf, the
new batch statistics, the updated parameters), three steps' losses, the
eval step, the learning-rate schedule and the batching.

Both sides start from the same JAX init (converted with
`sstts_torch.convert`), see the same batch and run with the prenets'
dropout at rate 0.  Tolerances: f32 on both sides with sums in other orders
through an encoder, a 48-step teacher-forced decoder and a 96-frame
post-net: the loss and its terms within rtol 1e-4; gradients within atol
1e-5, rtol 1e-3; batch statistics within 1e-5.  Adam's first update is
about -lr * sign(g), so a gradient of ~1e-9 can flip sign between two
correct implementations and move its parameter by 2 lr: updated
parameters are compared (atol 1e-6) only where |g| > 1e-4 (below it the
gradients' f32 noise, ~1e-7, is a large part of g, and the update's
slope eps / |g|^2 magnifies it), the rest by their gradients.  Over
three steps such flips move later losses slightly: rtol 1e-3 there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import tiny_pair

from sstts import train as jtrain
from sstts.data import pipeline as jpipe
from sstts.dsp.ops import wav_to_features as jax_features
from sstts.model.losses import frame_mask_from_lengths as jax_frame_mask
from sstts.model.losses import tacotron_loss as jax_loss
from sstts.model.modules import MaskedBatchNorm as JaxBN
from sstts_torch import train as ptrain
from sstts_torch.convert import convert_params, to_flax
from sstts_torch.data import pipeline as ppipe
from sstts_torch.data.synthetic import make_utterances, synth_waveform
from sstts_torch.model.modules import MaskedBatchNorm

STEPS = 3


def _sections(dropout=0.0):
    return dict(
        dataset={"dataset": "synthetic"},
        arch={"prenet_dropout": dropout},
        training={"batch_size": 2, "text_buckets": (48,), "frame_buckets": (96,),
                  "learning_rate": 2e-3},
    )


def _batch(cfg, seed=0):
    """One bucketed batch; each waveform is generated once here (its noise
    follows Python's salted hash) and the same arrays feed both sides."""
    utts = make_utterances(8, cfg.dataset, min_words=1, max_words=2)
    items = []
    for u in utts[seed * 2 : seed * 2 + 2]:
        ids = ppipe.text_mod.encode(u.text)
        items.append((ids, synth_waveform(u.uid, u.text, cfg.dataset)))
    lt, fr = ppipe.frame_bucket_shapes(cfg)[0]
    return ppipe.make_batch(items, lt, fr, cfg), items


@pytest.fixture(scope="module")
def run():
    """JAX: gradients by value_and_grad of the train step's loss, then
    STEPS applications of make_train_step and one eval step.  Port: the
    same from the converted init."""
    jcfg, pcfg = tiny_pair(**_sections())
    batches = [_batch(pcfg, i)[0] for i in range(STEPS)]
    state = jtrain.create_state(jcfg)
    params0 = jax.tree.map(np.asarray, jax.device_get(state.params))
    stats0 = jax.tree.map(np.asarray, jax.device_get(state.batch_stats))
    model = jtrain.build_model(jcfg)

    @jax.jit
    def grads_fn(params, batch_stats, batch):
        samples = batch["samples"].astype(jnp.float32) * (1.0 / 32767.0)
        lin, mel = jax_features(samples, jcfg.dataset)
        fmask = jax_frame_mask(batch["n_frames"], mel.shape[1])

        def loss_fn(p):
            out, mutated = model.apply(
                {"params": p, "batch_stats": batch_stats}, batch["char_ids"], mel,
                fmask, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"],
            )
            loss, metrics = jax_loss(out, mel, lin, batch["loss_frames"], jcfg.arch,
                                     jcfg.dataset, text_lengths=batch["text_len"])
            return loss, (metrics, mutated["batch_stats"])

        (_, (metrics, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return metrics, stats, grads

    jm, jstats, jgrads = jax.device_get(grads_fn(state.params, state.batch_stats, batches[0]))
    step = jtrain.make_train_step(jcfg)
    jmetrics = []
    for b in batches:
        state, m = step(state, b)
        jmetrics.append(jax.device_get(m))
        if len(jmetrics) == 1:
            params1 = jax.tree.map(np.asarray, jax.device_get(state.params))
    jeval, _ = jax.device_get(jtrain.make_eval_step(jcfg)(state, batches[0]))

    pstate = ptrain.create_state(pcfg, device="cpu")
    pstate.model.load_state_dict(convert_params(params0, stats0, pcfg))
    pstep = ptrain.make_train_step(pcfg)
    pmetrics = [pstep(pstate, batches[0])]
    pgrads = to_flax({n: p.grad for n, p in pstate.model.named_parameters()})[0]
    pparams1, pstats1 = to_flax(pstate.model.state_dict())
    for b in batches[1:]:
        pmetrics.append(pstep(pstate, b))
    peval, _ = ptrain.make_eval_step(pcfg)(pstate, batches[0])
    return dict(
        jm=jm, jstats=jstats, jgrads=jgrads, jmetrics=jmetrics, params1=params1,
        jeval=jeval, pmetrics=pmetrics, pgrads=pgrads, pparams1=pparams1,
        pstats1=pstats1, peval=peval,
    )


def _pairs(ref_tree, got_tree):
    for path, r in jax.tree_util.tree_leaves_with_path(ref_tree):
        node = got_tree
        for k in path:
            node = node[k.key]
        yield jax.tree_util.keystr(path), np.asarray(node), np.asarray(r)


def test_train_step_loss_and_metrics(run):
    got, ref = run["pmetrics"][0], run["jmetrics"][0]
    assert set(got) == set(ref)
    for k in ref:
        rtol = 1e-6 if k == "lr" else 1e-4
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=rtol, err_msg=k)
    for k, v in run["jm"].items():  # the value_and_grad run agrees with the step
        np.testing.assert_allclose(float(ref[k]), float(v), rtol=1e-6, err_msg=k)


def test_train_step_gradients(run):
    n = 0
    for name, g, r in _pairs(run["jgrads"], run["pgrads"]):
        # The port's grads are clipped in place by the step; undo the scale.
        np.testing.assert_allclose(g * _unclip(run), r, atol=1e-5, rtol=1e-3, err_msg=name)
        n += 1
    assert n == len(jax.tree.leaves(run["pgrads"]))


def _unclip(run):
    norm = float(run["pmetrics"][0]["grad_norm"])
    return max(1.0, norm / 1.0)


def test_train_step_batch_stats(run):
    for name, s, r in _pairs(run["jstats"], run["pstats1"]):
        np.testing.assert_allclose(s, r, atol=1e-5, err_msg=name)


def test_train_step_updated_params(run):
    compared = 0
    for (name, p, r), (_, g, _) in zip(_pairs(run["params1"], run["pparams1"]),
                                       _pairs(run["params1"], run["jgrads"])):
        sel = np.abs(g) > 1e-4
        compared += int(sel.sum())
        np.testing.assert_allclose(p[sel], r[sel], atol=1e-6, err_msg=name)
    assert compared > 0.5 * sum(x.size for x in jax.tree.leaves(run["params1"]))


def test_three_steps_and_eval(run):
    for i, (got, ref) in enumerate(zip(run["pmetrics"], run["jmetrics"])):
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-3,
                                   err_msg=f"step {i}")
    assert set(run["peval"]) == set(run["jeval"])
    for k in run["jeval"]:
        np.testing.assert_allclose(float(run["peval"][k]), float(run["jeval"][k]),
                                   rtol=1e-3, err_msg=k)


def test_masked_batch_norm_train_mode_matches_flax():
    """Batch statistics over the valid positions of a ragged mask, the
    normalized output and the EMA update of the running statistics."""
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, size=(3, 7, 5)).astype(np.float32)
    mask = np.arange(7)[None, :] < np.array([[7], [2], [5]])
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                   "bias": rng.normal(size=5).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(size=5).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, 5).astype(np.float32)},
    }
    for m in (mask, None):
        ref, mutated = JaxBN().apply(
            variables, jnp.asarray(x), None if m is None else jnp.asarray(m),
            train=True, mutable=["batch_stats"],
        )
        bn = MaskedBatchNorm(5).train()
        with torch.no_grad():
            for k in ("scale", "bias"):
                getattr(bn, k).copy_(torch.as_tensor(variables["params"][k]))
            for k in ("mean", "var"):
                getattr(bn, k).copy_(torch.as_tensor(variables["batch_stats"][k]))
        got = bn(torch.as_tensor(x), None if m is None else torch.as_tensor(m))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(),
                                       np.asarray(mutated["batch_stats"][k]), atol=1e-6)


def test_lr_schedule_matches_optax():
    jcfg, pcfg = tiny_pair(training={"lr_decay_steps": 10, "lr_decay_rate": 0.5,
                                     "learning_rate": 1e-3, "lr_min": 1e-4})
    ref = jtrain.lr_schedule(jcfg)
    got = ptrain.lr_schedule(pcfg)
    for step in (0, 1, 9, 10, 11, 25, 30, 40, 1000):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, err_msg=str(step))


def test_batching_matches_jax():
    """make_batch on the same arrays, the bucket shapes, and a Batcher
    epoch's coverage with its fill rows."""
    jcfg, pcfg = tiny_pair(**_sections())
    _, items = _batch(pcfg)
    lt, fr = ppipe.frame_bucket_shapes(pcfg)[0]
    assert ppipe.frame_bucket_shapes(pcfg) == jpipe.frame_bucket_shapes(jcfg)
    got = ppipe.make_batch(items, lt, fr, pcfg)
    ref = jpipe.make_batch(items, lt, fr, jcfg)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    utts = make_utterances(7, pcfg.dataset, min_words=1, max_words=2)
    batcher = ppipe.Batcher(utts, pcfg)
    batches = list(batcher.epoch(0, 2))
    assert len(batches) == batcher.batches_per_epoch(2) == 4
    assert sum(int((b["loss_frames"] > 0).sum()) for _, b in batches) == 7


def test_unported_training_settings_raise():
    _, pcfg = tiny_pair()
    # model_parallel trains on a mesh (tests/test_torch_mesh_train.py); as in
    # the reference, it must divide the visible devices and be positive.
    cfg = pcfg.replace(training=dataclasses.replace(pcfg.training, model_parallel=2))
    with pytest.raises(ValueError, match="does not divide the 1 visible devices"):
        ptrain.train(cfg, max_steps=1, device="cpu")
    cfg = pcfg.replace(training=dataclasses.replace(pcfg.training, model_parallel=0))
    with pytest.raises(ValueError, match="model_parallel"):
        ptrain.create_state(cfg, device="cpu")
    # B3's width limit raises on the card before anything is launched
    # (resolution needs no card): a BiGRU past H = 5456.  The widths past the
    # kernels' single-block limits are taken: B3's wide kind (H = 160) and
    # spilling kind (H = 752), B6's column panels (a 1280-column query).
    cuda = torch.device("cuda")
    cfg = pcfg.replace(arch=dataclasses.replace(pcfg.arch, post_gru_units=5457))
    with pytest.raises(NotImplementedError, match="H=5457"):
        ptrain.check_trainable(cfg, cuda)
    for fields in ({"encoder_gru_units": 160}, {"post_gru_units": 752},
                   {"attention_units": 1280}):
        cfg = pcfg.replace(arch=dataclasses.replace(pcfg.arch, **fields))
        ptrain.check_trainable(cfg, cuda)
    # An LJSpeech corpus without its metadata.csv raises, as the JAX loader does.
    cfg = pcfg.replace(dataset=dataclasses.replace(pcfg.dataset, dataset="ljspeech",
                                                   dataset_dir="/nonexistent"))
    with pytest.raises(FileNotFoundError, match="metadata.csv"):
        ptrain.load_corpus(cfg)


@pytest.mark.parametrize("fields,dtype", [
    ({"fused_conv_bank": True}, torch.float32),
    ({"compute_dtype": "bfloat16"}, torch.bfloat16),
], ids=["fused_conv_bank", "bfloat16"])
def test_architecture_training_settings_are_accepted(fields, dtype):
    """Values the port refused before it took every architecture of the
    reference's model: the state builds in the compute dtype with f32
    parameters."""
    _, pcfg = tiny_pair()
    cfg = pcfg.replace(arch=dataclasses.replace(pcfg.arch, **fields))
    state = ptrain.create_state(cfg, device="cpu")
    assert state.model.dtype == dtype
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    ptrain.check_trainable(cfg, torch.device("cuda"))


def test_create_state_defaults_to_cuda(monkeypatch):
    """The training entry points run on the card unless the caller passes
    device="cpu"; without CUDA the default raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg = tiny_pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        ptrain.create_state(pcfg)
