"""The recurrent kernels past their single-block widths, on the CPU: B3 and
B3' past H = 137 (the wide kind, a thread-block cluster a sequence) and B4
and B6 past 1024 columns (products streamed in column panels).  The grid
kind past 543 has its own module, test_torch_gru_grid.py; the plain
versions at its widths 560 and 752 are held to JAX here too.

The kernels run only on the card (`chip_smoke.py` phase 2 holds them to
their plain versions at full size, phase 3i drives them through
`Synthesizer` and `train`).  Here:

* the plain versions at those widths against the JAX package's kernels in
  interpret mode (the GRU and its gradient at H = 144 and 256, and at 560
  and 752 with the model's D = 128; the decode and the teacher-forced scan,
  and the scan's gradients, at a cell of 1152 columns);
* a numpy replay of `chunk_schedule` as the ring's producer and consumers
  read it (stream.cuh: the copies, the panels, their columns);
* the rule that picks the GRU's kernel from H (`kernel_config`), and the
  reference kernel's reach, from its block shapes, against MAX_HIDDEN.

Tolerances: f32 on both sides with sums in another order.  The GRU forward
within 2e-5 and its gradient within atol 2e-5, rtol 1e-4 (test_torch_gru.py
and test_torch_gru_grad.py hold the narrow GRU to 2e-5 and 1e-5 / 1e-4; at
H = 256 a gradient entry sums twice the terms); the decode's mel frames and
stop logits within 2e-4 and its alignments within 2e-5, the scan's
features within 2e-4, alignments 2e-5 and gradients atol 5e-4, rtol 1e-3
(tests/test_pallas_decoder.py's limits, as test_torch_decoder.py and
test_torch_teacher.py); the schedule replay exactly (small integers).  The
wide GRU's split over a cluster and its batch tiles are replayed in
test_torch_gru_wide.py.
Torch runs on one thread in this module.
"""

import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t

from sstts.ops import pallas_decoder as jpd
from sstts.ops import pallas_gru as jpg
from sstts.ops.pallas_gru import gru_sequence as jax_gru_sequence
from sstts.ops.pallas_gru import gru_sequence_ad
from sstts_torch.config import tiny_config
from sstts_torch.convert import to_flax
from sstts_torch.model.tacotron import Tacotron, init_state_dict
from sstts_torch.ops import build
from sstts_torch.ops import decoder as dec
from sstts_torch.ops import gru as gru_ops
from sstts_torch.ops import teacher as tops


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gru_arrays(H, B=2, T=9, D=7, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "xs": rng.normal(size=(B, T, D)).astype(np.float32),
        "wx": (rng.normal(size=(D, 3 * H)) / np.sqrt(D)).astype(np.float32),
        "wh": (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
        "b": rng.normal(0.0, 0.1, 3 * H).astype(np.float32),
        "mask": (np.arange(T)[None, :] < np.array([[T], [T - 4]])[:B]).astype(np.float32),
        "g": rng.normal(size=(B, T, H)).astype(np.float32),
    }


# ------------------------------------------------------------------ B3, B3' --


#: The widths held to the JAX package, the kind each takes on the card and
#: its input width: past 543 the model's D = 128 (the highway width).
WIDTHS = {144: (gru_ops.KIND_WIDE, 7), 256: (gru_ops.KIND_WIDE, 7),
          560: (gru_ops.KIND_GRID, 128), 752: (gru_ops.KIND_GRID, 128)}


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("H", sorted(WIDTHS))
def test_wide_gru_plain_matches_pallas(H, reverse):
    kind, D = WIDTHS[H]
    x = gru_arrays(H, D=D)
    assert gru_ops.kernel_config(H)[0] == kind
    got = gru_ops.gru_sequence(*(t(x[k]) for k in ("xs", "wx", "wh", "b", "mask")), reverse)
    ref = jax_gru_sequence(jnp.asarray(x["xs"]), x["wx"], x["wh"], x["b"],
                           jnp.asarray(x["mask"]), reverse=reverse, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    assert np.all(got.numpy()[x["mask"] == 0] == 0.0)


@pytest.mark.parametrize("H", sorted(WIDTHS))
def test_wide_gru_gradient_matches_jax_vjp(H):
    """Masked and reversed: the port's Function (CPU backward: the backward
    kernel's explicit reverse loop) against jax.vjp of gru_sequence_ad."""
    x = gru_arrays(H, D=WIDTHS[H][1], seed=1)
    _, vjp = jax.vjp(
        lambda xs, wx, wh, b: gru_sequence_ad(xs, wx, wh, b, jnp.asarray(x["mask"]), True, True),
        *(jnp.asarray(x[k]) for k in ("xs", "wx", "wh", "b")),
    )
    ref = vjp(jnp.asarray(x["g"]))
    args = [t(x[k]).requires_grad_() for k in ("xs", "wx", "wh", "b")]
    y = gru_ops.gru_sequence(*args, t(x["mask"]), True)
    got = torch.autograd.grad(y, args, t(x["g"]))
    for name, a, r in zip(("dxs", "dwx", "dwh", "db"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=2e-5, rtol=1e-4, err_msg=name)


def test_gru_kernel_config_rule(monkeypatch):
    """One pure function of H picks the kind before any launch, among four:
    the register kernels at 128, the generic ones up to 137 (138 is the
    first whose Wh and vectors pass a block's 232,448 bytes), then the wide
    ones on the smallest cluster, up to 16 blocks, of at most 32 units a
    rank (where 16 ranks allow it), whose tile of Bt = ceil(32 /
    WIDE_CLUSTERS[C]) batch rows fits its block in both directions, so
    that B = 32 runs in one wave of the clusters an H100 SXM holds (the
    reference count; on the card the library reads the card's), up to H =
    522; from 523 (no cluster's block holds the rows one
    wave needs) the grid kind, up to MAX_HIDDEN = 5456 (test_torch_gru_grid.py
    holds its rule); past it NotImplementedError.  Bt at other batches:
    enough for one wave, at most 8 and what the block holds.  The constants
    are csrc/gru.cu's."""
    monkeypatch.setattr(build, "load", lambda *a: pytest.fail("kernel_config built a library"))
    src = (build.CSRC / "gru.cu").read_text()
    for name, value in (("kWideThreads", gru_ops.WIDE_THREADS),
                        ("kMaxCluster", gru_ops.MAX_CLUSTER),
                        ("kWideMaxRows", gru_ops.WIDE_MAX_ROWS),
                        ("kWideMinSmem", gru_ops.WIDE_MIN_SMEM),
                        ("kWideMaxSmem", build.MAX_SMEM)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == value, name
    # The library reads the clusters of each C from the card (no fixed
    # table); WIDE_CLUSTERS is the CPU's reference count the rule reckons by.
    assert "kWideClusters" not in src and "cudaOccupancyMaxActiveClusters" in src
    assert re.search(r"int wide_clusters\(int C\) \{", src)
    probe = int(re.search(r"constexpr int kWideProbeHidden = (\d+);", src).group(1))
    assert probe == gru_ops.WIDE_PROBE_HIDDEN and gru_ops._config(probe)[0] == gru_ops.KIND_WIDE
    assert all(gru_ops.wide_shape(probe, c, 1, b)["valid"]
               for c in range(2, gru_ops.MAX_CLUSTER + 1) for b in (False, True))
    assert "SSTTS_GRU_WIDE = 2" in src and gru_ops.KIND_WIDE == 2
    assert "SPILL" not in src and "kSpill" not in src and not hasattr(gru_ops, "KIND_SPILL")
    kinds = {gru_ops.KIND_GENERIC, gru_ops.KIND_H128, gru_ops.KIND_WIDE, gru_ops.KIND_GRID}
    assert len(kinds) == 4
    assert gru_ops.MAX_HIDDEN == 5456 and gru_ops.GRID_MIN_HIDDEN == 523
    # The clusters of C the card holds shrink as C grows (one block an SM).
    held = gru_ops.WIDE_CLUSTERS
    assert all(held[c] >= held[c + 1] and held[c] * c <= 132 for c in range(1, 16))
    seen = set()
    for H in [*range(1, 1601), 2048, 2113, gru_ops.MAX_HIDDEN, gru_ops.MAX_HIDDEN + 1]:
        if H > gru_ops.MAX_HIDDEN:
            with pytest.raises(NotImplementedError, match=rf"MAX_HIDDEN = 5456, .*H={H}$"):
                gru_ops.kernel_config(H)
            continue
        kind, C = gru_ops.kernel_config(H)
        assert gru_ops.kernel_config(H) == (kind, C) and kind in kinds
        seen.add(kind)
        fits = max(gru_ops.generic_smem_bytes(H)) <= build.MAX_SMEM
        if H == 128:
            assert (kind, C) == (gru_ops.KIND_H128, 1)
        elif fits:
            assert (kind, C) == (gru_ops.KIND_GENERIC, 1)
        elif H < gru_ops.GRID_MIN_HIDDEN:
            assert kind == gru_ops.KIND_WIDE and 2 <= C <= gru_ops.MAX_CLUSTER
            rows = gru_ops.wide_rows(H, 32, C)
            assert rows == -(-32 // held[C]) and rows * held[C] >= 32
            assert max(gru_ops.wide_smem_bytes(H, C, rows)) <= build.MAX_SMEM
            first = min(gru_ops.MAX_CLUSTER, -(-H // gru_ops.WIDE_UNITS))
            assert C >= first
            for c in range(first, C):  # no smaller such cluster takes the batch in one wave
                assert gru_ops.wide_rows(H, 32, c) < -(-32 // held[c])
            for bwd in (False, True):
                ws = gru_ops.wide_shape(H, C, rows, bwd)
                U = ws["U"]
                assert (C - 1) * U < H <= C * U and ws["valid"]
                assert ws["threads"] <= gru_ops.WIDE_THREADS and rows * U <= ws["threads"]
                assert ws["KA"] % 4 == 0 and ws["ldw"] % 8 == 4 and ws["KS"] >= 1
                assert ws["smem"] == max(ws["floats"] * 4, gru_ops.WIDE_MIN_SMEM)
                if bwd:
                    assert ws["KS"] == 1 and ws["N"] >= H and ws["KA"] >= 3 * U
                else:
                    assert ws["N"] == 3 * U and ws["KA"] >= H and U * ws["KS"] <= ws["threads"]
                    assert (ws["KS"] == min(gru_ops.WIDE_THREADS // U, ws["KA"] // 4)
                            or ws["floats"] + rows * ws["N"] > build.MAX_SMEM // 4), H
            for B in (1, 3, 33, 64, 300):  # other batches: one wave where 8 rows allow
                r = gru_ops.wide_rows(H, B, C)
                assert 1 <= r <= min(gru_ops.WIDE_MAX_ROWS, -(-B // held[C]))
                assert r == -(-B // held[C]) or not all(
                    gru_ops.wide_shape(H, C, r + 1, b)["valid"] for b in (False, True))
        else:
            assert (kind, C) == (gru_ops.KIND_GRID, gru_ops.grid_shape(H, False)["NB"])
            assert max(gru_ops.grid_smem_bytes(H)) <= build.MAX_SMEM
            streams = [gru_ops.grid_shape(H, b)["S"] > 0 for b in (False, True)]
            assert streams == [H > 1430, H > 1419]
        assert fits == (H <= 137)
    assert seen == kinds


#: Scoped VMEM of the reference's chips: 16 MiB (v5e, the BASELINE's), 32 MiB.
VMEM_BYTES = (16 << 20, 32 << 20)


def reference_gru_vmem(hidden: int, d_in: int, batch: int = 32) -> int:
    """VMEM that `sstts/ops/pallas_gru.py:gru_sequence` needs at (B, D, H):
    each block of its BlockSpecs (inputs, with the mask, and the output)
    twice, as Pallas double-buffers them, and its VMEM scratch once, each
    padded to (8, 128) f32 tiles in its last two dims; shapes read from the
    function's source."""
    src = inspect.getsource(jpg.gru_sequence)
    names = {"batch": batch, "d_in": d_in, "hidden": hidden}
    blocks = re.findall(r"pl\.BlockSpec\((\([^()]*\))", src)
    scratch = re.findall(r"pltpu\.VMEM\((\([^()]*\))", src)
    assert len(blocks) == 6 and len(scratch) == 1  # xs, mask, wx, wh, b, out; h

    def tile_bytes(shape: str) -> int:
        *lead, rows, cols = eval(shape, {}, names)  # noqa: S307 - the reference's own source
        lead_n = int(np.prod(lead)) if lead else 1
        return lead_n * -(-rows // 8) * 8 * -(-cols // 128) * 128 * 4

    return 2 * sum(map(tile_bytes, blocks)) + sum(map(tile_bytes, scratch))


def test_max_hidden_covers_the_reference_kernels_reach():
    """The reference's GRU kernel keeps Wx (D, 3H), Wh (H, 3H) and b
    resident in VMEM, so its reach depends on D as well as H: at B = 32 it
    fits 16 MiB up to H = 752 at the model's D = 128 (the highway width) and
    560 at D = H, and 32 MiB up to 1104 and 810.  The port's kernels take
    every one of those widths (the input projection runs outside the
    recurrence, so only H bounds them)."""
    reach = {}
    for vmem in VMEM_BYTES:
        for label, d_of in (("D=128", lambda h: 128), ("D=H", lambda h: h)):
            reach[vmem >> 20, label] = max(
                h for h in range(1, 2049) if reference_gru_vmem(h, d_of(h)) <= vmem)
    assert reach == {(16, "D=128"): 752, (16, "D=H"): 560,
                     (32, "D=128"): 1104, (32, "D=H"): 810}, reach
    assert gru_ops.MAX_HIDDEN >= max(reach.values())
    for h in range(1, max(reach.values()) + 1):
        gru_ops.kernel_config(h)


# ------------------------------------------------------------------ B4, B6 --


@pytest.fixture(scope="module")
def wide_cell():
    """The tiny config with attention and decoder GRUs of 384 units (3 Ha =
    3 Hd = 1152 columns: two panels), its port model from a seeded init and
    the same parameters in flax's layout; memory and its mask."""
    cfg = tiny_config()
    cfg = cfg.replace(arch=dataclasses.replace(
        cfg.arch, attention_gru_units=384, decoder_gru_units=384, prenet_dropout=0.0))
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=4))
    params = to_flax(model.state_dict())[0]["decoder_cell"]
    rng = np.random.default_rng(5)
    B, T = 2, 7
    memory = rng.normal(0.0, 0.5, (B, T, 2 * cfg.arch.encoder_gru_units)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[T], [4]])
    return cfg, model.eval(), params, memory, mask


def test_wide_decode_plain_matches_jax_kernel(wide_cell):
    cfg, model, params, memory, mask = wide_cell
    w = dec.weights_from_cell(model.decoder_cell, torch.float32)
    assert len(dec.panels(w.attn_wh.shape[1])) == 2
    ref = jpd.fused_decode(
        params, jnp.asarray(memory), jnp.asarray(mask), 5, n_mels=cfg.dataset.n_mels,
        reduction=cfg.arch.reduction_factor, stop_threshold=1.5, min_steps=2,
        apply_dropout=False, matmul_dtype=jnp.float32, interpret=True)
    with torch.no_grad():
        got = dec.fused_decode(model.decoder_cell, t(memory), t(mask), 5, stop_threshold=1.5,
                               min_steps=2, matmul_dtype=torch.float32)
    np.testing.assert_array_equal(got["n_frames"].numpy(), np.asarray(ref["n_frames"]))
    for key, atol in (("mel", 2e-4), ("stop_logits", 2e-4), ("alignments", 2e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key], np.float32),
                                   atol=atol, err_msg=key)


def scan_arrays(cfg, memory, seed=6):
    rng = np.random.default_rng(seed)
    B, T, _ = memory.shape
    pre = rng.uniform(size=(B, 5, cfg.arch.prenet_units[-1])).astype(np.float32)
    keys = rng.normal(0.0, 0.5, (B, T, cfg.arch.attention_units)).astype(np.float32)
    return pre, keys


def test_wide_teacher_scan_plain_matches_jax_kernel(wide_cell):
    cfg, model, params, memory, mask = wide_cell
    pre, keys = scan_arrays(cfg, memory)
    maskf = mask.astype(np.float32)
    ref_xs, ref_al = jpd.fused_teacher_scan(
        jpd.teacher_weights_from_tree(params), jnp.asarray(pre), jnp.asarray(memory),
        jnp.asarray(keys), jnp.asarray(maskf), jnp.float32, interpret=True)
    with torch.no_grad():
        xs, al = tops.fused_teacher_scan(tops.teacher_weights_from_cell(model.decoder_cell),
                                         t(pre), t(memory), t(keys), t(maskf), torch.float32)
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref_xs), atol=2e-4)
    np.testing.assert_allclose(al.numpy(), np.asarray(ref_al), atol=2e-5)


def test_wide_teacher_scan_gradient_matches_jax_vjp(wide_cell):
    """Every input's and weight's gradient through the port's Function
    (plain forward, plain f32 recompute backward) against jax.vjp of
    fused_teacher_scan_ad."""
    cfg, model, params, memory, mask = wide_cell
    pre, keys = scan_arrays(cfg, memory, seed=7)
    maskf = mask.astype(np.float32)
    rng = np.random.default_rng(8)
    jw = jpd.teacher_weights_from_tree(params)
    B, S, T = pre.shape[0], pre.shape[1], memory.shape[1]
    g_xs = rng.normal(size=(B, S, cfg.arch.decoder_gru_units)).astype(np.float32)
    g_al = rng.normal(size=(B, S, T)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda w, p, m, k: jpd.fused_teacher_scan_ad(w, p, m, k, jnp.asarray(maskf),
                                                     jnp.float32, interpret=True),
        jw, jnp.asarray(pre), jnp.asarray(memory), jnp.asarray(keys))
    ref_w, *ref_in = vjp((jnp.asarray(g_xs), jnp.asarray(g_al)))
    w = tops.TeacherWeights(*[p.detach().clone().requires_grad_()
                              for p in tops.teacher_weights_from_cell(model.decoder_cell)])
    ins = [t(a).requires_grad_() for a in (pre, memory, keys)]
    out = tops.fused_teacher_scan_ad(w, *ins, t(maskf), torch.float32)
    got = torch.autograd.grad(out, [*w, *ins], (t(g_xs), t(g_al)))
    for name, a, r in zip((*tops.TeacherWeights._fields, "pre", "memory", "keys"), got,
                          [*ref_w, *ref_in]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r).reshape(a.shape), atol=5e-4,
                                   rtol=1e-3, err_msg=name)


def replay_products(sched, packed, memory_buf, keys, B, T, itemsize, order, batch_index):
    """The ring's reading of one step's schedule for utterance `batch_index`
    (stream.cuh): the producer's copy of each chunk (weights from the packed
    buffer; keys and memory from their tensors at the utterance's first
    row), and the consumers' products, panel by panel, each panel's columns
    written at its col0.  Returns {name: [(col0, the next panel's col0 or
    None, the panel's sums)]} with x = 1, 2, ... as each product's input."""
    dt = {2: np.dtype("<u2"), 4: np.float32}[itemsize]
    srcs = {dec.SRC_WEIGHTS: packed, dec.SRC_KEYS: keys, dec.SRC_MEMORY: memory_buf}
    rows = sched.tolist()
    out = {}
    i = 0
    while i < len(rows):
        pid = rows[i][1]
        name = order[pid]
        while i < len(rows) and rows[i][1] == pid:
            col0 = rows[i][7]
            acc = None
            while i < len(rows) and rows[i][1] == pid and rows[i][7] == col0:
                src, _, offset, nbytes, k0, k1, rb, _ = rows[i]
                assert 0 < nbytes <= dec.STAGE_BYTES and rb % 16 == 0 and nbytes == (k1 - k0) * rb
                base = 0 if src == dec.SRC_WEIGHTS else batch_index * T * rb
                stage = srcs[src][base + offset: base + offset + nbytes]
                assert len(stage) == nbytes
                block = stage.view(dt).reshape(k1 - k0, rb // itemsize)
                if itemsize == 2:  # bf16 bits -> f32
                    block = (block.astype(np.uint32) << 16).view(np.float32)
                x = np.arange(k0 + 1, k1 + 1, dtype=np.float64)
                part = x @ block.astype(np.float64)
                acc = part if acc is None else acc + part
                i += 1
            nxt_col0 = rows[i][7] if i < len(rows) and rows[i][1] == pid else None
            out.setdefault(name, []).append((col0, nxt_col0, acc))
    return out


def numpy_bytes(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.uint8).reshape(-1).numpy()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("cols", [1024, 1025, 1280, 1536, 2048, 4100])
def test_chunk_schedule_replays_each_product(cols, dtype):
    """A step of a weight matrix (70 rows: several chunks a panel in bf16),
    keys and memory `cols` wide, packed, laid out and scheduled as the
    wrappers do for two utterances; the replay of the ring's reading of
    utterance 1 assembles x . W panel by panel, each column once, equal to
    the product, with no chunk over a stage and no panel over MAX_COLS."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    B, T, K = 2, 3, 70
    g = torch.Generator().manual_seed(cols)
    ints = lambda *s: torch.randint(-3, 4, s, generator=g).to(dt)  # noqa: E731
    w = type("W", (), {"m": ints(K, cols)})()
    memory, keys = ints(B, T, cols), ints(B, T, cols)
    layout = dec.weight_layout(w, ("m",), dt)
    order = ("m", "keys", "memory")
    products = dec.step_products(layout, T, cols, cols, dt.itemsize, order, B)
    n_panels = -(-cols // dec.MAX_COLS)
    assert [pr.name for pr in products] == ["m"] * n_panels + ["keys"] + ["memory"] * n_panels
    assert all(pr.cols <= dec.MAX_COLS for pr in products if pr.name != "keys")
    sched = dec.chunk_schedule(products)
    got = replay_products(sched, numpy_bytes(dec.pack_weights(w, ("m",), dt)),
                          numpy_bytes(dec.memory_panels(memory)),
                          numpy_bytes(dec._rows16(keys)), B, T, dt.itemsize, order, 1)
    x = {"m": torch.arange(1, K + 1, dtype=torch.float64),
         "memory": torch.arange(1, T + 1, dtype=torch.float64)}
    want = {"m": x["m"] @ w.m.double(), "memory": x["memory"] @ memory[1].double(),
            "keys": torch.arange(1, T + 1, dtype=torch.float64) @ keys[1].double()}
    for name in order:
        panels = got[name]
        firsts = [c0 for c0, _, _ in panels]
        if name == "keys":  # whole rows, for the scores: one run
            assert firsts == [0]
        else:
            assert firsts == [c0 for c0, _ in dec.panels(cols)]
        assembled = np.full(cols, np.nan)
        for c0, nxt, acc in panels:
            width = (nxt if nxt is not None else cols) - c0
            assert 0 < width <= (dec.MAX_COLS if name != "keys" else cols)
            assert np.isnan(assembled[c0: c0 + width]).all()  # each column once
            assembled[c0: c0 + width] = acc[:width]
        np.testing.assert_array_equal(assembled, want[name].numpy(), err_msg=name)
