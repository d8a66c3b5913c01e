"""The port's device-resident corpus, its op streams, the cached and grouped
train steps and the direct-DFT features, held to `sstts.train` and
`sstts.dsp.ops` on the CPU.

Both packages read the same synthetic utterances in one process (their
waveforms' noise follows Python's per-process hash, the same for both), at
`tiny_config` widths with the prenets' dropout at rate 0.  Tolerances:
- PCM16 corpus rows: byte-equal, with equal counts per bucket.
- Features (the "features" corpus and the direct-DFT transforms): XLA's and
  PyTorch's f32 sums in other orders.  Mel within 1e-5; linear within 1e-5
  but for near-silent bins at the dB floor, where log10 amplifies f32
  rounding (on these tests' inputs at most 2.0e-4, on 0.04% of the
  values): there the rule of `tests/test_torch_features.py` (mean < 1e-6,
  max < 5e-4, under 1% of the values beyond 1e-5).
- "features_bf16": within one bf16 ulp of the port's f32 features.
- A train step against JAX: the loss and its terms within rtol 1e-4, as in
  `tests/test_torch_train.py`; grad_norm within rtol 1e-4 once the values
  lying within the two packages' f32 rounding of a kink sit on the same
  side of it in both (`test_cached_step_matches_jax`).
- The port against itself (a cached against a host-fed step, a grouped
  against single steps, the chunked against the one-shot build): equal bit
  for bit, the same arithmetic on the same values.

Torch runs on one thread here: the tiny model gains nothing from more, and
a test suite with one process per core oversubscribes.
"""

import dataclasses

import flax.linen
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_parity import tiny_pair

from sstts import train as jtrain
from sstts.dsp.ops import wav_to_features as jax_features
from sstts_torch import train as ptrain
from sstts_torch.convert import convert_params
from sstts_torch.data.synthetic import make_utterances
from sstts_torch.dsp.fft import tf32_split
from sstts_torch.dsp.ops import wav_to_features

FORMATS = ("pcm16", "features", "features_bf16")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(**training):
    return tiny_pair(
        dataset={"dataset": "synthetic"},
        arch={"prenet_dropout": 0.0},
        training={"batch_size": 2, "text_buckets": (16, 48), "frame_buckets": (48, 96),
                  "learning_rate": 2e-3, **training},
    )


def _utts(cfg, n=8):
    return make_utterances(n, cfg.dataset, min_words=1, max_words=2)


def _port_corpus(pcfg, utts):
    built, reason = ptrain.build_device_corpus(pcfg, utts, device="cpu")
    assert built is not None, reason
    return built


def _jax_corpus(jcfg, utts):
    built, reason = jtrain.build_device_corpus(jcfg, utts)
    assert built is not None, reason
    corpus, counts = built
    return {b: {k: np.asarray(v.astype(np.float32) if v.dtype == jax.numpy.bfloat16 else v)
                for k, v in rows.items()} for b, rows in corpus.items()}, counts


def _assert_features_close(got, ref, name):
    """The module docstring's rule for features."""
    d = np.abs(np.asarray(got, np.float32) - ref)
    if name == "mel":
        assert d.max() <= 1e-5, (name, d.max())
    else:
        assert d.mean() < 1e-6 and d.max() < 5e-4 and (d > 1e-5).mean() < 1e-2, (
            name, d.mean(), d.max(), (d > 1e-5).mean())


def test_pcm16_corpus_matches_jax_byte_for_byte():
    jcfg, pcfg = _pair()
    utts = _utts(pcfg)
    corpus, counts = _port_corpus(pcfg, utts)
    ref, ref_counts = _jax_corpus(jcfg, utts)
    assert counts == ref_counts and len(counts) == 2
    for b in ref:
        assert set(corpus[b]) == set(ref[b]) == set(ptrain._CORPUS_KEYS)
        for k in ref[b]:
            got = corpus[b][k].numpy()
            assert got.dtype == ref[b][k].dtype and got.shape == ref[b][k].shape, k
            assert got.tobytes() == ref[b][k].tobytes(), k


def test_features_corpus_matches_jax():
    jcfg, pcfg = _pair(device_corpus_format="features")
    utts = _utts(pcfg)
    corpus, counts = _port_corpus(pcfg, utts)
    ref, ref_counts = _jax_corpus(jcfg, utts)
    assert counts == ref_counts
    for b in ref:
        assert set(corpus[b]) == set(ref[b]) == set(ptrain._CORPUS_KEYS_FEATURES)
        for k in ("char_ids", "text_len", "n_frames", "loss_frames"):
            np.testing.assert_array_equal(corpus[b][k].numpy(), ref[b][k], err_msg=k)
        for k in ("linear", "mel"):
            assert corpus[b][k].dtype == torch.float32
            _assert_features_close(corpus[b][k].numpy(), ref[b][k], k)


def test_features_bf16_corpus_within_one_ulp_of_f32():
    _, pcfg = _pair(device_corpus_format="features")
    _, hcfg = _pair(device_corpus_format="features_bf16")
    utts = _utts(pcfg)
    f32, counts = _port_corpus(pcfg, utts)
    bf16, counts_h = _port_corpus(hcfg, utts)
    assert counts == counts_h
    for b in counts:
        for k in ("linear", "mel"):
            h = bf16[b][k]
            assert h.dtype == torch.bfloat16
            f = f32[b][k]
            # One bf16 ulp of |f|: 2**(floor(log2 |f|) - 7); features lie in [0, 1].
            ulp = torch.exp2(torch.floor(torch.log2(f.abs().clamp_min(2.0**-126))) - 7)
            assert bool(((h.float() - f).abs() <= ulp).all()), k


@pytest.mark.parametrize("fmt", ["features", "features_bf16"])
def test_chunked_build_equals_one_shot(monkeypatch, fmt):
    """Chunks of 2 rows into the preallocated buffers, the last chunk
    re-covering written rows, give the one-chunk build bit for bit."""
    _, pcfg = _pair(device_corpus_format=fmt)
    utts = make_utterances(9, pcfg.dataset, min_words=1, max_words=1)
    one, counts = _port_corpus(pcfg, utts)
    monkeypatch.setattr(ptrain, "_FEATURIZE_CHUNK_ROWS", 2)
    chunked, counts_c = _port_corpus(pcfg, utts)
    assert counts == counts_c
    assert any(n > 2 and n % 2 for n in counts.values())  # an overlapping last chunk
    for b in counts:
        for k in one[b]:
            assert torch.equal(one[b][k], chunked[b][k]), (b, k)


def test_over_budget_and_empty_reasons_match_jax():
    for fmt in ("pcm16", "features"):
        jcfg, pcfg = _pair(device_corpus_format=fmt, device_corpus_budget_mb=0)
        utts = _utts(pcfg)
        got = ptrain.build_device_corpus(pcfg, utts, device="cpu")
        ref = jtrain.build_device_corpus(jcfg, utts)
        assert got[0] is None and got == ref
        assert "exceeds the 0 MiB device budget" in got[1]
    jcfg, pcfg = _pair(text_buckets=(2,), frame_buckets=(4,))
    got = ptrain.build_device_corpus(pcfg, _utts(pcfg), device="cpu")
    assert got == jtrain.build_device_corpus(jcfg, _utts(pcfg))
    assert got == (None, "no utterance fits the configured buckets")


# ---------------------------------------------------------------- op streams

_COUNTS = st.dictionaries(st.integers(0, 5), st.integers(1, 23), min_size=1, max_size=4)


def _same_ops(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


@settings(max_examples=60, deadline=None)
@given(counts=_COUNTS, batch=st.integers(1, 6), seed=st.integers(0, 2**31))
def test_cached_epoch_indices_match_jax(counts, batch, seed):
    _same_ops(ptrain.cached_epoch_indices(counts, batch, seed),
              jtrain.cached_epoch_indices(counts, batch, seed))


@settings(max_examples=60, deadline=None)
@given(counts=_COUNTS, batch=st.integers(1, 6), S=st.integers(1, 5), seed=st.integers(0, 2**31))
def test_grouped_epoch_indices_match_jax(counts, batch, S, seed):
    got = list(ptrain.grouped_epoch_indices(counts, batch, S, seed))
    _same_ops(got, jtrain.grouped_epoch_indices(counts, batch, S, seed))
    # Every row once per epoch (fill rows carry valid=0).
    seen = {b: [] for b in counts}
    for op in got:
        seen[op[1]].extend(np.asarray(op[2])[np.asarray(op[3]) > 0].ravel().tolist())
    assert all(sorted(seen[b]) == list(range(n)) for b, n in counts.items())


@settings(max_examples=60, deadline=None)
@given(counts=_COUNTS, batch=st.integers(1, 4), S=st.integers(2, 5),
       seed=st.integers(0, 2**31), budget=st.integers(0, 40))
def test_clamp_grouped_ops_matches_jax(counts, batch, S, seed, budget):
    ops = list(ptrain.grouped_epoch_indices(counts, batch, S, seed))
    got = list(ptrain._clamp_grouped_ops(iter(ops), budget))
    _same_ops(got, jtrain._clamp_grouped_ops(iter(ops), budget))
    total = sum(len(op[2]) if op[0] == "grouped" else 1 for op in ops)
    assert sum(len(op[2]) if op[0] == "grouped" else 1 for op in got) == min(budget, total)


@settings(max_examples=60, deadline=None)
@given(counts=_COUNTS, batch=st.integers(1, 4), S=st.integers(1, 5),
       seed=st.integers(0, 2**31), skip=st.integers(0, 40))
def test_skip_epoch_steps_matches_jax(counts, batch, S, seed, skip):
    ops = list(ptrain.grouped_epoch_indices(counts, batch, S, seed))
    _same_ops(ptrain._skip_epoch_steps(iter(ops), skip),
              jtrain._skip_epoch_steps(iter(ops), skip))


# ---------------------------------------------------------------- the steps


def _state(pcfg, variables=None):
    state = ptrain.create_state(pcfg, seed=0, device="cpu")
    if variables is not None:
        state.model.load_state_dict(convert_params(*variables, pcfg))
    return state


def _params(state):
    return [p.detach().clone() for p in state.model.parameters()]


def test_cached_step_equals_host_step_and_fill_rows_add_nothing():
    _, pcfg = _pair()
    corpus, counts = _port_corpus(pcfg, _utts(pcfg))
    bucket = min(b for b, n in counts.items() if n >= 2)
    rows = corpus[bucket]
    cases = [(np.array([0, 1], np.int32), np.ones(2, np.float32)),
             (np.array([1, 1], np.int32), np.array([1.0, 0.0], np.float32))]
    for idx, valid in cases:
        s1, s2 = _state(pcfg), _state(pcfg)
        m1 = ptrain.make_cached_train_step(pcfg)(s1, rows, idx, valid)
        host = {k: v.numpy()[idx].copy() for k, v in rows.items()}
        host["loss_frames"][valid == 0] = 0  # a fill row: no loss
        m2 = ptrain.make_train_step(pcfg)(s2, host)
        for k in m2:
            assert torch.equal(m1[k], m2[k]), k
        assert all(torch.equal(a, b) for a, b in zip(_params(s1), _params(s2)))
        assert s1.step == s2.step == 1


#: Values whose two packages' forwards lie this close count as equal but
#: for f32 rounding (the forwards agree to ~1e-6 on these inputs).
KINK_BAND = 1e-5
_RESIDUALS = ("linear", "mel")


_JAX_LOSS, _FLAX_RELU, _RELU_INPUTS = jtrain.tacotron_loss, flax.linen.relu, []


def _keeping_residuals(out, mel_gt, linear_gt, *a, **k):
    loss, metrics = _JAX_LOSS(out, mel_gt, linear_gt, *a, **k)
    extra = {f"_{key}": (out[key], out[key] - gt)
             for key, gt in (("linear", linear_gt), ("mel", mel_gt))}
    return loss, dict(metrics, **extra)


def _reporting_relu(x):
    jax.debug.callback(lambda v: _RELU_INPUTS.append(np.array(v)), x, ordered=True)
    return _FLAX_RELU(x)


def _jax_step_keeping_kinks(jcfg, jstate, rows, idx, valid):
    """JAX's cached step (`make_cached_train_step` unmemoized), traced with
    a loss that also returns the linear and mel outputs and their residuals
    against the targets, and with every ReLU of the model reporting its
    input (jax.debug.callback, in call order): (metrics, {key: (output,
    residual)}, [ReLU inputs])."""
    _RELU_INPUTS.clear()
    jtrain.tacotron_loss, flax.linen.relu = _keeping_residuals, _reporting_relu
    try:
        _, ref = jtrain.make_cached_train_step.__wrapped__(jcfg)(jstate, rows, idx, valid)
        jax.effects_barrier()
    finally:
        jtrain.tacotron_loss, flax.linen.relu = _JAX_LOSS, _FLAX_RELU
    ref = jax.device_get(ref)
    kept = {key: tuple(np.asarray(a) for a in ref.pop(f"_{key}")) for key in _RESIDUALS}
    return ref, kept, list(_RELU_INPUTS)


def _port_step_on_jax_side(pcfg, variables, rows, idx, valid, kept, relu_inputs):
    """The port's cached step with every value that sits at a kink on the
    other side from JAX's, where the two packages' values agree within
    KINK_BAND, moved by a constant to JAX's side: a linear or mel output to
    JAX's residual against its L1 target, a ReLU input to JAX's value (in
    call order; the model's ReLUs are its only other kinks).  The gradient
    there then takes JAX's branch; nothing else changes.  (metrics, how
    many values were moved)."""
    loss_fn, relu, moved, calls = ptrain.tacotron_loss, F.relu, [], []

    def on_jax_side(out, mel_gt, linear_gt, *a, **k):
        out = dict(out)
        for key, gt in (("linear", linear_gt), ("mel", mel_gt)):
            j_out, j_res = (torch.tensor(v) for v in kept[key])
            res = (out[key] - gt).detach()
            flip = (torch.sign(res) != torch.sign(j_res)) & (
                (out[key].detach() - j_out).abs() <= KINK_BAND)
            moved.append(int(flip.sum()))
            out[key] = out[key] + torch.where(flip, j_res - res, torch.zeros_like(res))
        return loss_fn(out, mel_gt, linear_gt, *a, **k)

    def relu_on_jax_side(x, *a, **k):
        theirs = torch.tensor(relu_inputs[len(calls)])
        calls.append(x.shape)
        assert theirs.shape == x.shape, (len(calls), theirs.shape, x.shape)
        mine = x.detach()
        flip = (torch.sign(mine) != torch.sign(theirs)) & ((mine - theirs).abs() <= KINK_BAND)
        moved.append(int(flip.sum()))
        return relu(x + torch.where(flip, theirs - mine, torch.zeros_like(mine)), *a, **k)

    ptrain.tacotron_loss, F.relu = on_jax_side, relu_on_jax_side
    try:
        got = ptrain.make_cached_train_step(pcfg)(_state(pcfg, variables), rows, idx, valid)
    finally:
        ptrain.tacotron_loss, F.relu = loss_fn, relu
    assert len(calls) == len(relu_inputs), (len(calls), len(relu_inputs))
    return got, sum(moved)


def _cached_steps(fmt):
    """The comparison's results from one init and one corpus format: JAX's
    step (`_jax_step_keeping_kinks`), the port's step, the port's step with
    its values at kinks on JAX's side, and how many it moved."""
    jcfg, pcfg = _pair(device_corpus_format=fmt)
    utts = _utts(pcfg)
    jbuilt, _ = jtrain.build_device_corpus(jcfg, utts)
    jcorpus, counts = jbuilt
    corpus, _ = _port_corpus(pcfg, utts)
    bucket = max(counts)
    idx = np.array([counts[bucket] - 1, 0], np.int32)
    valid = np.array([1.0, 0.0], np.float32)
    jstate = jtrain.create_state(jcfg)
    variables = (jax.tree.map(np.asarray, jax.device_get(jstate.params)),
                 jax.tree.map(np.asarray, jax.device_get(jstate.batch_stats)))
    rows = corpus[bucket]
    if fmt == "features_bf16":
        rows = _rounded_as_jax(rows, jcorpus[bucket])
    ref, kept, relu_inputs = _jax_step_keeping_kinks(jcfg, jstate, jcorpus[bucket], idx, valid)
    got = ptrain.make_cached_train_step(pcfg)(_state(pcfg, variables), rows, idx, valid)
    on_side, moved = _port_step_on_jax_side(pcfg, variables, rows, idx, valid, kept,
                                            relu_inputs)
    return ref, got, on_side, moved


def _rounded_as_jax(rows, jrows):
    """The port's bf16 bucket with each mel value that the two packages
    round to neighbouring bf16 values taken as JAX rounded it.  Their f32
    mel values agree within 1e-5 (`test_features_corpus_matches_jax`), so
    where one lies that close to a bf16 rounding midpoint the two bf16
    values differ by one ulp (about 1 in 10^4 here).  The mel frames are
    the decoder's teacher-forced inputs: one such value moves the step's
    outputs by up to 4e-4.  (The linear targets enter only the loss, whose
    kinks `_port_step_on_jax_side` accounts for.)  Any other difference
    fails here."""
    mine = rows["mel"]
    theirs = torch.from_numpy(np.asarray(jrows["mel"]).astype(np.float32)).bfloat16()
    apart = mine != theirs
    ulp = torch.exp2(torch.floor(torch.log2(theirs.float().abs().clamp_min(2.0**-126))) - 7)
    assert bool(((mine.float() - theirs.float()).abs() <= ulp)[apart].all())
    assert float(apart.float().mean()) < 1e-3, float(apart.float().mean())
    return dict(rows, mel=torch.where(apart, theirs, mine))


@pytest.mark.parametrize("fmt", FORMATS)
def test_cached_step_matches_jax(fmt):
    """One cached step against JAX's.  The loss and its terms, forward
    quantities, within rtol 1e-4.  grad_norm within rtol 1e-4 once the
    values lying within the two packages' f32 rounding of a kink (an output
    at its L1 target, a ReLU input at 0) sit on the same side of it in both
    (`_port_step_on_jax_side`): on opposite sides the gradient takes
    another branch there, and grad_norm moves by up to 1.2e-3.  In
    "features_bf16" the mel inputs that the two packages round to
    neighbouring bf16 values are taken as JAX rounded them
    (`_rounded_as_jax`).  `tests/torch_corpus_step_sweep.py` counts the
    string hashes at which the comparison missed before and misses now."""
    ref, got, on_side, _ = _cached_steps(fmt)
    assert set(got) == set(ref) == set(on_side)
    for k in ref:
        mine = on_side if k == "grad_norm" else got
        np.testing.assert_allclose(float(mine[k]), float(ref[k]), rtol=1e-4, err_msg=k)


def test_grouped_step_equals_cached_steps():
    _, pcfg = _pair(steps_per_call=3)
    corpus, counts = _port_corpus(pcfg, _utts(pcfg))
    bucket = max(counts, key=counts.get)
    n = counts[bucket]
    idxs = (np.arange(6, dtype=np.int32).reshape(3, 2) * 5) % n
    valids = np.array([[1, 1], [1, 0], [1, 1]], np.float32)
    s1, s2 = _state(pcfg), _state(pcfg)
    grouped = ptrain.make_grouped_train_step(pcfg)(s1, corpus[bucket], idxs, valids)
    cached = ptrain.make_cached_train_step(pcfg)
    singles = [cached(s2, corpus[bucket], idxs[i], valids[i]) for i in range(3)]
    assert s1.step == s2.step == 3
    for k in singles[0]:
        assert grouped[k].shape == (3,), k
        assert torch.equal(grouped[k], torch.stack([m[k] for m in singles])), k
    assert all(torch.equal(a, b) for a, b in zip(_params(s1), _params(s2)))


@pytest.mark.parametrize("impl", ["dft_default", "dft_high", "dft_highest"])
def test_dft_features_match_jax(impl):
    """On the CPU every rung runs in f32 on both sides (XLA:CPU ignores the
    precision rung); on these inputs against JAX: mel 1.6e-6, linear 7.6e-5
    at most, 0.17% of the values beyond 1e-5 (the near-silent bins)."""
    jcfg, pcfg = _pair()
    ds = pcfg.dataset
    rng = np.random.default_rng(5)
    n = ds.sample_rate // 2
    tt = np.arange(n) / ds.sample_rate
    y = np.stack([0.5 * np.sin(2 * np.pi * f * tt) + 0.01 * rng.standard_normal(n)
                  for f in (220.0, 1330.0)]).astype(np.float32)
    y[1, n // 3:] = 0.0  # a padded tail: exact silence
    got = wav_to_features(torch.as_tensor(y), ds, impl)
    ref = jax.jit(lambda a: jax_features(a, jcfg.dataset, impl))(y)
    for g, r, name in zip(got, ref, ("linear", "mel")):
        assert g.shape == r.shape
        _assert_features_close(g.numpy(), np.asarray(r), name)


def test_dft_highest_train_step_matches_default():
    """`feature_fft_impl` swaps the featurization transform, not the
    training math: the fingerprint is unchanged and one step's loss equals
    the default path's within rtol 1e-5."""
    _, pcfg = _pair()
    _, fcfg = _pair(feature_fft_impl="dft_highest")
    assert fcfg.fingerprint() == pcfg.fingerprint()
    corpus, counts = _port_corpus(pcfg, _utts(pcfg))
    host = {k: v.numpy()[:2] for k, v in corpus[min(counts)].items()}
    m0 = ptrain.make_train_step(pcfg)(_state(pcfg), host)
    m1 = ptrain.make_train_step(fcfg)(_state(fcfg), host)
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]), rtol=1e-5)


def test_tf32_split_is_exact():
    """"dft_high" on the card splits each operand into a part exact in
    TF32 (10 mantissa bits) and the rest; the split loses nothing."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor((rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096))
                        .astype(np.float32))
    hi, lo = tf32_split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(hi + lo, x)
    assert bool((lo.abs() <= x.abs() * 2.0**-11).all())
