"""B6's backward as a captured CUDA graph (`sstts_torch/ops/teacher.py`:
`scan_grad`, `ScanGraphs`, `graph_key`).

On the CPU: the key and the route (the CPU eager always; on the card a
shape's first backward eager, its second a capture, later ones replays;
anomaly mode eager; a graph kept for every shape), the counters and the
two spans, and the replay's plumbing with a stand-in for the graph that
reruns into the same static buffers: through the Function, and through
four host-fed steps and a grouped S=4 call against the eager route.  On
the card (marker `cuda`; no JAX here, so that the test runs where JAX is
not installed): the replay bit-equal to the eager rerun at bucket 1's
shape (b 32, T 128, S 103) and at a second shape, captured into one
shared pool, the weights changed in place between calls, and no returned
gradient overwritten by a later call; and four host-fed steps, with the
prefetch thread uploading a batch while the graph is captured, and a
grouped S=4 call, each bit-equal to the eager route under PyTorch's
deterministic algorithms.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sstts_torch import train as ptrain
from sstts_torch.config import Config, tiny_config
from sstts_torch.data.synthetic import make_utterances
from sstts_torch.model.tacotron import Tacotron, init_state_dict
from sstts_torch.ops import teacher as tops
from sstts_torch.utils import profiling

N_INPUTS = 3 + len(tops.TeacherWeights._fields)  # pre, memory, keys, *w


def _cell(cfg, device="cpu"):
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, 0))
    return model.decoder_cell.to(device)


def _case(cell, B, T, S, seed, device="cpu"):
    """(pre, memory, keys, maskf, dxs, dalign) of a scan at (B, T, S)."""
    g = torch.Generator().manual_seed(seed)
    P1, Dm, A, _, Hd = tops.cell_widths(cell)
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g)
    tensors = (
        torch.rand(B, S, P1, generator=g),
        0.5 * torch.randn(B, T, Dm, generator=g),
        0.5 * torch.randn(B, T, A, generator=g),
        (torch.arange(T)[None, :] < lengths[:, None]).float(),
        torch.randn(B, S, Hd, generator=g) / (B * S),
        torch.randn(B, S, T, generator=g) / (B * S),
    )
    return tuple(t.to(device) for t in tensors)


def _key(device="cuda", B=2):
    return tops.GraphKey((B, 5, 7, 4, 6, 3, 8, 8), torch.bfloat16, torch.device(device), ())


@pytest.fixture
def counters():
    """The three counters' values now, read back as a delta."""
    before = (tops.scan_grad.eager, tops.scan_grad.captures, tops.scan_grad.replays)
    return lambda: tuple(n - b for n, b in zip(
        (tops.scan_grad.eager, tops.scan_grad.captures, tops.scan_grad.replays), before))


def test_both_spans_are_program_spans():
    assert {"sstts.train.scan_grad", "sstts.train.scan_graph"} <= set(profiling.SPANS)


def test_the_cpu_stays_eager():
    graphs = tops.ScanGraphs()
    assert [graphs.route(_key("cpu")) for _ in range(3)] == ["eager"] * 3
    assert not graphs.seen and not graphs.graphs


def test_first_sighting_eager_second_captures_then_replays():
    graphs = tops.ScanGraphs()
    a, b = _key(B=2), _key(B=3)
    assert [graphs.route(a), graphs.route(b), graphs.route(a)] == ["eager", "eager", "capture"]
    graphs.graphs[a] = "graph a"
    assert [graphs.route(a), graphs.route(a), graphs.route(b)] == ["replay", "replay", "capture"]


def test_anomaly_mode_stays_eager():
    graphs = tops.ScanGraphs()
    k = _key()
    assert [graphs.route(k, anomaly=True) for _ in range(2)] == ["eager", "eager"]
    assert graphs.route(k) == "eager" and graphs.route(k) == "capture"
    graphs.graphs[k] = "graph"
    assert graphs.route(k, anomaly=True) == "eager"


def test_every_shape_keeps_its_graph():
    """A graph a shape (a bucket's), however many: none is dropped, so a
    shape once captured is never captured again."""
    graphs = tops.ScanGraphs()
    keys = [_key(B=b) for b in range(2, 14)]
    for k in keys:
        assert [graphs.route(k), graphs.route(k)] == ["eager", "capture"]
        graphs.graphs[k] = k.dims
    assert [graphs.route(k) for k in reversed(keys)] == ["replay"] * len(keys)
    assert len(graphs.graphs) == len(keys)


def test_graph_key():
    cell = _cell(tiny_config())
    pre, memory, keys, maskf, dxs, dalign = _case(cell, 3, 9, 4, 1)
    w = tuple(tops.teacher_weights_from_cell(cell))
    key = tops.graph_key((maskf, pre, memory, keys, *w), dxs, dalign, torch.bfloat16)
    P1, Dm, A, Ha, Hd = tops.cell_widths(cell)
    assert key.dims == (3, 4, 9, P1, Dm, A, Ha, Hd)
    assert (key.matmul_dtype, key.device) == (torch.bfloat16, torch.device("cpu"))
    same = tops.graph_key((maskf.clone(), pre.clone(), memory, keys, *w), dxs.clone(), dalign,
                          torch.bfloat16)
    assert same == key and hash(same) == hash(key)
    strided = pre.transpose(0, 1).contiguous().transpose(0, 1)
    others = [
        tops.graph_key((maskf, strided, memory, keys, *w), dxs, dalign, torch.bfloat16),
        tops.graph_key((maskf, pre, memory, keys, *w), dxs, dalign, torch.float32),
        tops.graph_key((maskf, pre[:, :3], memory, keys, *w), dxs[:, :3], dalign[:, :3],
                       torch.bfloat16),
    ]
    assert len({key, *others}) == 4


def _function_grads(cell, case, dt=torch.float32):
    """The gradients of (pre, memory, keys, *w) through `_FusedTeacherScan`."""
    pre, memory, keys, maskf, dxs, dalign = case
    leaves = [t.detach().requires_grad_() for t in (pre, memory, keys)]
    w = tuple(tops.teacher_weights_from_cell(cell))
    out = tops.fused_teacher_scan_ad(tops.TeacherWeights(*w), *leaves, maskf, dt)
    return torch.autograd.grad(out, [*leaves, *w], (dxs, dalign), allow_unused=True)


def test_a_cpu_backward_is_eager_and_spanned(counters):
    cell = _cell(tiny_config())
    case = _case(cell, 2, 7, 3, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            got = _function_grads(cell, case)
    names = [e.name for e in prof.events()]
    assert names.count("sstts.train.scan_grad") == 3
    assert "sstts.train.scan_graph" not in names
    assert counters() == (3, 0, 0)
    pre, memory, keys, maskf, dxs, dalign = case
    saved = (maskf, pre, memory, keys, *tops.teacher_weights_from_cell(cell))
    want = tops._rerun_grad(tuple(t.detach() for t in saved), dxs, dalign)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


class _RerunGraph:
    """A stand-in for a captured graph on the CPU: `replay` reruns the
    scan's gradient on the static inputs into the static gradients."""

    def __init__(self, static, grads):
        self.static, self.grads = static, grads

    def replay(self):
        for g, new in zip(self.grads, tops._rerun_grad(self.static[:-2], *self.static[-2:])):
            if g is not None:
                g.copy_(new)


class _CpuGraphs(tops.ScanGraphs):
    """`ScanGraphs` whose captures are `_RerunGraph`s."""

    def capture(self, key, tensors):
        static = tuple(torch.empty_like(t) for t in tensors)
        for s, t in zip(static, tensors):
            s.copy_(t)
        grads = tuple(g.clone() for g in tops._rerun_grad(static[:-2], *static[-2:]))
        captured = self.graphs[key] = tops._Captured(_RerunGraph(static, grads), static, grads)
        return captured


def test_the_replay_reads_this_calls_inputs_and_hands_out_copies(monkeypatch, counters):
    """Through the Function, with the route of the card: eager, capture,
    replay, replay; each call's gradients equal to the eager rerun's on
    that call's weights (changed in place between calls) and inputs, and
    none changed by a later call."""
    graphs = _CpuGraphs()
    monkeypatch.setattr(tops, "GRAPHS", graphs)
    key = tops.graph_key  # routed as the card's
    monkeypatch.setattr(tops, "graph_key",
                        lambda *a: key(*a)._replace(device=torch.device("cuda")))
    cell = _cell(tiny_config())
    got, kept = [], []
    for call in range(4):
        with torch.no_grad():
            for p in cell.parameters():
                p.mul_(1.0 + 0.01 * (call + 1))
        case = _case(cell, 2, 7, 3, 10 + call)
        grads = _function_grads(cell, case)
        pre, memory, keys, maskf, dxs, dalign = case
        saved = (maskf, pre, memory, keys, *(t.detach() for t in
                                             tops.teacher_weights_from_cell(cell)))
        want = tops._rerun_grad(saved, dxs, dalign)
        assert all(torch.equal(a, b) for a, b in zip(grads, want)), call
        got.append(grads)
        kept.append([g.clone() for g in grads])
        assert counters() == [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 1, 2)][call]
    for grads, copies in zip(got, kept):
        assert all(torch.equal(a, b) for a, b in zip(grads, copies))
    final = list(graphs.graphs.values())[0]
    assert not any(g.data_ptr() == s.data_ptr() for grads in got for g in grads
                   for s in final.grads)


class _EagerGraphs(tops.ScanGraphs):
    """`ScanGraphs` that sends every backward the eager way: the route
    the graphs are held to."""

    def route(self, key, anomaly=False):
        return "eager"


MODES = ("host-fed", "grouped S=4")


def _train_run(cfg, rows, host, device, mode, batches=None):
    """From one init, four host-fed steps (through the prefetch; `batches`,
    four (bucket, batch) pairs of `host`, by default) or a grouped S=4
    call on `rows`: the losses and the parameters after them."""
    state = ptrain.create_state(cfg, seed=0, device=device)
    state.model.teacher_impl = "fused"  # the card's scan, under its autograd.Function
    if mode == "host-fed":
        step = ptrain.make_train_step(cfg)
        fed = ptrain._prefetch_to_device(batches or ((1, host) for _ in range(4)), device)
        losses = [step(state, b)["loss"] for _, b in fed]
    else:
        B = host["char_ids"].shape[0]
        idxs = np.arange(4 * B, dtype=np.int32).reshape(4, B) % rows["char_ids"].shape[0]
        valids = np.ones((4, B), np.float32)
        valids[3, B // 2:] = 0.0  # an epoch tail's fill rows
        grouped = ptrain.make_grouped_train_step(dataclasses.replace(
            cfg, training=dataclasses.replace(cfg.training, steps_per_call=4)))
        losses = grouped(state, rows, idxs, valids)["loss"]
    return [float(x) for x in losses], [p.detach().clone() for p in state.model.parameters()]


def _train_runs(monkeypatch, graphs, *args):
    """`_train_run` in each mode, with a fresh `graphs()` as the process's
    captured backwards in each."""
    out = {}
    for mode in MODES:
        monkeypatch.setattr(tops, "GRAPHS", graphs())
        out[mode] = _train_run(*args, mode)
    return out


def _bit_equal(got, want):
    for mode in want:
        (gl, gp), (wl, wp) = got[mode], want[mode]
        assert gl == wl, (mode, gl, wl)
        gaps = [float((a - b).abs().max()) for a, b in zip(gp, wp)]
        assert all(torch.equal(a, b) for a, b in zip(gp, wp)), (mode, max(gaps))


def test_host_fed_and_grouped_steps_equal_the_eager_route(monkeypatch, counters):
    """Four host-fed steps and a grouped S=4 call on the tiny config, with
    the card's route (eager, capture, replay, replay) and the stand-in
    graph: the losses and the parameters bit-equal to the eager route's,
    Adam's in-place updates of the weights read by every replay."""
    cfg = tiny_config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, dataset="synthetic"),
        training=dataclasses.replace(cfg.training, batch_size=2, text_buckets=(16, 48),
                                     frame_buckets=(48, 96)),
    )
    utts = make_utterances(8, cfg.dataset, min_words=1, max_words=2)
    (corpus, counts), _ = ptrain.build_device_corpus(cfg, utts, device="cpu")
    rows = corpus[min(b for b, n in counts.items() if n >= 2)]
    host = {k: v[:2].numpy() for k, v in rows.items()}
    want = _train_runs(monkeypatch, _EagerGraphs, cfg, rows, host, "cpu")
    assert counters() == (8, 0, 0)
    key = tops.graph_key  # routed as the card's
    monkeypatch.setattr(tops, "graph_key",
                        lambda *a: key(*a)._replace(device=torch.device("cuda")))
    got = _train_runs(monkeypatch, _CpuGraphs, cfg, rows, host, "cpu")
    assert counters() == (10, 2, 4)
    _bit_equal(got, want)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replay_bit_equal_to_the_eager_rerun_on_the_card(monkeypatch, counters):
    """Bucket 1's shape (b 32, T 128, S 103) and a second (b 16, T 64, S
    40) in turns: eager, eager, capture, capture, then replays, both
    graphs in one pool; every call's gradients bit-equal to the eager
    rerun's on that call's weights and inputs, and every returned
    gradient unchanged by the calls after it."""
    dev = _card()
    monkeypatch.setattr(tops, "GRAPHS", tops.ScanGraphs())
    cell = _cell(Config(), dev)
    shapes = [(32, 128, 103), (16, 64, 40)]
    routes = [(1, 0, 0), (2, 0, 0), (2, 1, 0), (2, 2, 0), (2, 2, 1), (2, 2, 2), (2, 2, 3)]
    got, kept = [], []
    for call, want_count in enumerate(routes):
        B, T, S = shapes[call % 2]
        with torch.no_grad():
            for p in cell.parameters():
                p.add_(1e-3 * torch.randn_like(p))
        case = _case(cell, B, T, S, 100 + call, dev)
        grads = _function_grads(cell, case, torch.bfloat16)
        pre, memory, keys, maskf, dxs, dalign = case
        saved = (maskf, pre, memory, keys, *(t.detach() for t in
                                             tops.teacher_weights_from_cell(cell)))
        want = tops._rerun_grad(saved, dxs, dalign)
        torch.cuda.synchronize()
        gaps = [float((a - b).abs().max()) for a, b in zip(grads, want)]
        assert all(torch.equal(a, b) for a, b in zip(grads, want)), (call, gaps)
        assert counters() == want_count, call
        got.append(grads)
        kept.append([g.clone() for g in grads])
    torch.cuda.synchronize()
    for call, (grads, copies) in enumerate(zip(got, kept)):
        assert all(torch.equal(a, b) for a, b in zip(grads, copies)), call
    assert len(tops.GRAPHS.graphs) == 2 and len(tops.GRAPHS._pools) == 1


@pytest.mark.cuda
def test_host_fed_and_grouped_steps_bit_equal_to_the_eager_route_on_the_card(monkeypatch,
                                                                            counters):
    """The default `Config()` at b 32 in bucket 1 (T 128, S 103), under
    PyTorch's deterministic algorithms: four host-fed steps through the
    prefetch, whose thread uploads the fourth batch while the second
    step's backward is being captured, and a grouped S=4 call, each from
    one init with a fresh cache (eager, capture, replay, replay), their
    losses and parameters bit-equal to the eager route's."""
    dev = _card()
    cfg = Config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, dataset="synthetic"),
        training=dataclasses.replace(cfg.training, batch_size=32),
    )
    utts = ptrain.load_corpus(cfg)[0]
    (corpus, counts), _ = ptrain.build_device_corpus(cfg, utts, device=dev)
    assert counts.get(1, 0) >= 32, counts
    rows = corpus[1]
    host = {k: v[:32].cpu().numpy() for k, v in rows.items()}

    # The prefetch thread's fourth upload waits for the capture to start,
    # and the capture for that upload to end.
    capturing, uploaded, during = threading.Event(), threading.Event(), []
    rerun, pinned = tops._rerun_grad, ptrain._pinned_to

    def rerun_when_uploaded(*args):
        if torch.cuda.is_current_stream_capturing():
            capturing.set()
            assert uploaded.wait(120), "the prefetch thread uploaded nothing in the capture"
        return rerun(*args)

    def pinned_in_capture(dev_, *arrays):
        live = capturing.is_set() and not uploaded.is_set()
        out = pinned(dev_, *arrays)
        if live and threading.current_thread() is not threading.main_thread():
            during.append(threading.current_thread().name)
            uploaded.set()
        return out

    def batches():
        for i in range(4):
            if i == 3:
                assert capturing.wait(120), "no capture began"
            yield 1, host

    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = _train_runs(monkeypatch, _EagerGraphs, cfg, rows, host, dev)
        assert counters() == (8, 0, 0)
        monkeypatch.setattr(tops, "_rerun_grad", rerun_when_uploaded)
        monkeypatch.setattr(ptrain, "_pinned_to", pinned_in_capture)
        monkeypatch.setattr(tops, "GRAPHS", tops.ScanGraphs())
        got = {"host-fed": _train_run(cfg, rows, host, dev, "host-fed", batches())}
        monkeypatch.setattr(tops, "GRAPHS", tops.ScanGraphs())
        got["grouped S=4"] = _train_run(cfg, rows, host, dev, "grouped S=4")
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(saved)
    assert counters() == (10, 2, 4)
    assert len(during) == 1, during
    _bit_equal(got, want)
