"""B3 and B3' from H = 523 to 5456, the grid kind, on the CPU.

The grid kind's kernels (`gru_fwd_grid`, `gru_bwd_grid` in csrc/gru.cu) run
only on the card, where `chip_smoke.py` phase 2 holds them to their plain
versions at full size and phases 3j and 3k drive them through `Synthesizer`
and `train`.  Here:

* the rule that picks the grid kind from H (`kernel_config`), its shared
  memory (`grid_smem_bytes`), the K range of each block's slice it keeps in
  shared memory (R), its scratch and its reach, against the source's
  constants;
* a torch replay of the grid kind's arithmetic (`GridShape`: each block's
  slice of Wh, its K range [0, R) as the kernel loads it and [R, KA) from
  the packed copy by `gru_pack_grid`'s flat index rule, read tile by tile at
  the kernel's offsets; the batch in tiles of 32 rows, the K tiles and the
  K slices' float4 quads summed in a fixed order, the carry and the step's
  dgh exchanged through a (2, Bp, KA) buffer laid out as the kernels lay it
  out, the backward's carried direct part), forward and backward, at widths
  whose last block owns fewer units, widths that stream part of the slice
  (1420 backward, 1701, 2048, and 2113, whose gate pass takes two items a
  thread), odd batches, ragged masks with an all-padding row, both
  directions, held to the plain versions;
* the plain GRU at H = 752 and 1420 against the JAX package's scan
  (`gru_sequence_xla`) and its gradient against `jax.vjp` of
  `gru_sequence_ad`.

Tolerances: the replay runs in float64, so what it differs by from the f32
plain version is the latter's rounding: within 2e-6 of the largest value
(at H = 752 the plain version's raw candidate term hn, a 752-term f32 sum,
lies 1.1e-6 of the largest gate value from the float64 replay after 4
steps).  The plain GRU
against JAX: f32 both sides, within 2e-5 (forward) and atol 2e-5, rtol 1e-4
(gradient), as tests/test_torch_widths.py holds the wide widths.  Torch
runs on one thread in this module.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t

from sstts.ops.pallas_gru import gru_sequence_ad, gru_sequence_xla
from sstts_torch.ops import build
from sstts_torch.ops import gru as gru_ops


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gru_arrays(H, B, T, D=16, seed=0):
    """Seeded inputs; a ragged mask whose row 0 is all padding (where B >
    1), and an output gradient."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(max(T // 2, 1), T + 1, B)
    if B > 1:
        lengths[0] = 0
    return {
        "xs": rng.normal(size=(B, T, D)).astype(np.float32),
        "wx": (rng.normal(size=(D, 3 * H)) / np.sqrt(D)).astype(np.float32),
        "wh": (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
        "b": rng.normal(0.0, 0.1, 3 * H).astype(np.float32),
        "mask": (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32),
        "g": rng.normal(size=(B, T, H)).astype(np.float32),
    }


# ------------------------------------------------------------- the rule --


#: (H, blocks, units a block, forward and backward shared-memory bytes,
#: forward and backward K range in shared memory R).
GRID_WIDTHS = {544: (109, 5, 91632, 142944, 576, 1792),
               560: (112, 5, 91632, 142944, 576, 1792),
               752: (126, 6, 120864, 155232, 800, 2304),
               1104: (123, 9, 175152, 223920, 1120, 3528),
               1419: (129, 11, 222864, 232128, 1440, 4288),
               1420: (130, 11, 222864, 229656, 1440, 4032),
               2048: (128, 16, 225816, 229272, 832, 2480),
               2113: (125, 17, 223416, 229272, 720, 2480),
               5456: (130, 42, 227736, 222360, 192, 960)}


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_grid_kind_rule(monkeypatch):
    """From 523 (the first width at which no cluster's wide block holds the
    batch rows that B = 32 needs for one wave) to
    MAX_HIDDEN = 5456 `kernel_config` gives the grid kind on NB = ceil(H /
    U) blocks, U = ceil(H / 132) the fewest units a block with at most 132
    blocks.  Up to 1419 (forward 1430) a block's whole slice fits 232,448
    bytes of shared memory beside its ring (K tiles of about 32 quads
    forward and 48 backward, fewer where it would not fit); past it the
    block keeps the K range [0, R) of its slice, R the most whole K tiles
    of 16 quads beside a ring whose stages also carry a tile of the slice's
    N rows, and streams the rest (a tile as one bulk copy where all
    blocks' packed tiles pass L2's 50 MB, else as 16-byte copies).  The gate pass takes one (row, unit) item a thread where
    the slice is resident, at most 3 where it streams.  A pure function of
    H; the constants are csrc/gru.cu's."""
    monkeypatch.setattr(build, "load", lambda *a: pytest.fail("kernel_config built a library"))
    src = (build.CSRC / "gru.cu").read_text()
    for name, value in (("kGridBlocks", gru_ops.GRID_BLOCKS),
                        ("kGridThreads", gru_ops.GRID_THREADS),
                        ("kGridRows", gru_ops.GRID_ROWS), ("kGridStages", gru_ops.GRID_STAGES),
                        ("kGridStreamQuads", gru_ops.GRID_STREAM_QUADS),
                        ("kGridGateItems", gru_ops.GRID_GATE_ITEMS),
                        ("kGridMaxHidden", gru_ops.MAX_HIDDEN),
                        ("kGridL2Bytes", gru_ops.GRID_L2_BYTES),
                        ("kGridMaxSmem", build.MAX_SMEM)):
        assert _constant(src, name) == value, name
    assert "SSTTS_GRU_GRID = 4" in src and gru_ops.KIND_GRID == 4
    assert gru_ops.GRID_MIN_HIDDEN == 523 and gru_ops.MAX_HIDDEN == 5456
    assert gru_ops.kernel_config(522)[0] == gru_ops.KIND_WIDE
    for H, (blocks, units, fwd, bwd, r_fwd, r_bwd) in GRID_WIDTHS.items():
        assert gru_ops.kernel_config(H) == (gru_ops.KIND_GRID, blocks)
        assert gru_ops.grid_smem_bytes(H) == (fwd, bwd)
        shapes = [gru_ops.grid_shape(H, backward) for backward in (False, True)]
        assert [(gs["NB"], gs["U"]) for gs in shapes] == [(blocks, units)] * 2
        assert [gs["R"] for gs in shapes] == [r_fwd, r_bwd]
    first_streamed = {}
    for H in range(gru_ops.GRID_MIN_HIDDEN, gru_ops.MAX_HIDDEN + 1):
        gs = [gru_ops.grid_shape(H, b) for b in (False, True)]
        U = gs[0]["U"]
        assert gru_ops.kernel_config(H) == (gru_ops.KIND_GRID, gs[0]["NB"])
        assert -(-H // U) <= 132 and (U == 1 or -(-H // (U - 1)) > 132)
        assert (gs[0]["NB"] - 1) * U < H <= gs[0]["NB"] * U
        assert max(gru_ops.grid_smem_bytes(H)) <= build.MAX_SMEM
        for bwd, g in enumerate(gs):
            assert g["KS"] >= 1 and g["threads"] <= gru_ops.GRID_THREADS
            assert 32 * U <= gru_ops.GRID_GATE_ITEMS * g["threads"]
            assert g["threads"] >= min(32 * U, gru_ops.GRID_THREADS)
            assert g["KT"] % (4 * g["KS"]) == 0 and g["KA"] % g["KT"] == 0
            assert g["ldw"] % 8 == 4 and g["ldt"] % 8 == 4 and g["N"] % 3 == 0
            assert g["R"] % g["KT"] == 0 and 0 <= g["R"] <= g["KA"] and g["S"] == g["KA"] - g["R"]
            packed = g["NB"] * gru_ops.grid_pack_floats(H, bool(bwd)) * 4
            assert g["bulk"] == (g["S"] > 0 and packed > gru_ops.GRID_L2_BYTES)
            if g["R"] < g["KA"]:  # streamed: tiles of 16 quads, the most whole ones kept
                first_streamed.setdefault(bwd, H)
                assert g["KT"] == 4 * g["KS"] * -(-gru_ops.GRID_STREAM_QUADS // g["KS"])
                more = dict(g, R=g["R"] + g["KT"])
                assert (more["R"] >= g["KA"]
                        or gru_ops._grid_smem(more) > build.MAX_SMEM), (H, bwd)
        assert gs[0]["KA"] >= gs[0]["NB"] * U and gs[1]["KA"] >= gs[1]["NB"] * 3 * U
    assert first_streamed == {0: 1431, 1: 1420}
    # Bulk copies where the packed tiles pass L2, from 2377 (U = 19: always
    # more than one gate item a thread); 16-byte copies at 1420 and 2048.
    assert [[gru_ops.grid_shape(H, b)["bulk"] for b in (False, True)]
            for H in (1420, 2048, 2376, 2377, 5456)] == [[False] * 2] * 3 + [[True] * 2] * 2
    assert gru_ops.grid_shape(2377, False)["U"] == 19
    assert gru_ops.grid_shape(1430, False)["S"] == 0
    assert [gru_ops.grid_shape(1104, b)["KT"] for b in (False, True)] == [140, 252]
    assert [gru_ops.grid_shape(1419, b)["KT"] for b in (False, True)] == [80, 64]
    with pytest.raises(NotImplementedError, match=r"MAX_HIDDEN = 5456, .*H=5457$"):
        gru_ops.kernel_config(5457)
    # The scratch: the exchange buffer (2, Bp, KA), and the backward's (Bp,
    # NB U), Bp = B to 32; then the packed tiles, (NB, S / KT, N, ldt).
    gs = [gru_ops.grid_shape(1104, b) for b in (False, True)]
    assert gru_ops.grid_scratch_floats(1, 1104, False) == 32 * 2 * gs[0]["KA"]
    assert gru_ops.grid_scratch_floats(33, 1104, True) == 64 * (2 * gs[1]["KA"] + 123 * 9)
    gs = gru_ops.grid_shape(1701, True)
    exchange = 32 * (2 * gs["KA"] + gs["NB"] * gs["U"])
    assert gru_ops.grid_exchange_floats(3, 1701, True) == exchange
    packed = gs["NB"] * gs["S"] // gs["KT"] * gs["N"] * gs["ldt"]
    assert gru_ops.grid_pack_floats(1701, True) * gs["NB"] == packed
    assert gru_ops.grid_scratch_floats(3, 1701, True) == exchange + packed


# ----------------------------------------------------------- the replay --


def k_slices(gs):
    """The K columns each of the KS slices sums, in the kernel's order: in
    each K tile, the float4 quads ks, ks + KS, ..."""
    kt4 = gs["KT"] // 4
    return [torch.tensor([kt * gs["KT"] + 4 * q + e for kt in range(gs["KA"] // gs["KT"])
                          for q in range(ks, kt4, gs["KS"]) for e in range(4)])
            for ks in range(gs["KS"])]


def grid_product(gs, a, w):
    """gru.cu's grid_product for every block: a (32, KA) rows of the
    exchange buffer, w (NB, N, KA) the slices as the blocks read them ->
    each K slice's sums, (NB, 32, N), in the order the gate threads add
    them."""
    return [torch.einsum("rk,cnk->crn", a[:, idx], w[:, :, idx]) for idx in k_slices(gs)]


def grid_slice(wh, gs, backward, c, n, k):
    """gru.cu's grid_slice: entry (n, k) of block c's slice, for tensors of
    n and k; zero past H."""
    H, U, NB = wh.shape[0], gs["U"], gs["NB"]
    if not backward:  # w[g U + u][k] = Wh[k][g H + c U + u]
        g, unit = n // U, c * U + n % U
        ok = (k < H) & (unit < H)
        return torch.where(ok, wh[k.clamp(max=H - 1), (g * H + unit).clamp(max=3 * H - 1)], 0)
    G = 3 * U  # w[u][c' 3U + g U + u'] = Wh[c U + u][g H + c' U + u']
    c2, g, u2 = k // G, k % G // U, k % U
    unit, col = c * U + n, c2 * U + u2
    ok = (n < U) & (unit < H) & (c2 < NB) & (col < H)
    return torch.where(ok, wh[unit.clamp(max=H - 1), (g * H + col).clamp(max=3 * H - 1)], 0)


def block_slices(wh, gs, backward):
    """Each block's slice as grid_product reads it, (NB, N, KA): the K
    range [0, R) as load_grid_slice writes it, and each streamed K tile kt
    as the bulk copy moves it, N rows of ldt floats from the block's packed
    tiles at (kt - R / KT) N ldt, of a copy filled by gru_pack_grid's flat
    index rule (i -> block i // P, P = gru_ops.grid_pack_floats; in the
    block, tile, row and column of ldt; zero past KT)."""
    N, KA, R, KT, ldt, NB = gs["N"], gs["KA"], gs["R"], gs["KT"], gs["ldt"], gs["NB"]
    per = gs["S"] // KT * N * ldt
    e = torch.arange(per)  # i - blk P for the flat indices i of block blk
    jt, row, q = e // (N * ldt), e % (N * ldt) // ldt, e % ldt
    pack = torch.cat([torch.where(q < KT, grid_slice(wh, gs, backward, blk, row,
                                                      R + jt * KT + q.clamp(max=KT - 1)), 0)
                      for blk in range(NB)]) if per else torch.zeros(0, dtype=wh.dtype)
    n = torch.arange(N)[:, None]
    w = torch.zeros(NB, N, KA, dtype=wh.dtype)
    for blk in range(NB):
        w[blk, :, :R] = grid_slice(wh, gs, backward, blk, n, torch.arange(R)[None])
        for kt in range(R // KT, KA // KT):
            tile = pack[blk * per + (kt - R // KT) * N * ldt:][: N * ldt].reshape(N, ldt)
            assert torch.all(tile[:, KT:] == 0)
            w[blk, :, kt * KT: (kt + 1) * KT] = tile[:, :KT]
    return w


def replay_grid_forward(gx, wh, mask, reverse):
    """gru_fwd_grid's arithmetic, in float64: (out, gates, hprev) as it
    writes them."""
    B, T, _ = gx.shape
    H = wh.shape[0]
    gs = gru_ops.grid_shape(H, False)
    U, NB = gs["U"], gs["NB"]
    w = block_slices(wh, gs, False)
    Bp = -(-B // 32) * 32
    f64 = dict(dtype=torch.float64)
    xbuf = torch.zeros(2, Bp, gs["KA"], **f64)
    out, gates, hprev = (torch.zeros(B, T, n * H, **f64) for n in (1, 4, 1))

    def by_unit(p):  # (NB, 32, U) -> (32, NB U) -> (32, H)
        return p.permute(1, 0, 2).reshape(32, NB * U)[:, :H]

    for s in range(T):
        t_ = T - 1 - s if reverse else s
        hc, hn = xbuf[s % 2], xbuf[(s + 1) % 2]
        for r0 in range(0, B, 32):
            rows = slice(r0, min(B, r0 + 32))
            nr = rows.stop - r0
            parts = grid_product(gs, hc[r0: r0 + 32], w)
            sums = parts[0]
            for p in parts[1:]:
                sums = sums + p
            hr, hz, hh = (by_unit(sums[:, :, g * U: (g + 1) * U])[:nr] for g in range(3))
            g = gx[rows, t_]
            h = hc[rows, :H]
            r = torch.sigmoid(g[:, :H] + hr)
            z = torch.sigmoid(g[:, H: 2 * H] + hz)
            n = torch.tanh(g[:, 2 * H:] + r * hh)
            gates[rows, t_] = torch.cat([r, z, n, hh], -1)
            hprev[rows, t_] = h
            m = mask[rows, t_, None]
            h_new = m * (z * h + (1 - z) * n) + (1 - m) * h
            out[rows, t_] = m * h_new
            hn[rows, :H] = h_new
    return out, gates, hprev


def replay_grid_backward(dout, gates, hprev, wh, mask, reverse):
    """gru_bwd_grid's arithmetic, in float64: (dgx, dgh) as it writes
    them."""
    B, T, H = dout.shape
    gs = gru_ops.grid_shape(H, True)
    U, NB = gs["U"], gs["NB"]
    w = block_slices(wh, gs, True)
    Bp = -(-B // 32) * 32
    f64 = dict(dtype=torch.float64)
    xbuf = torch.zeros(2, Bp, gs["KA"], **f64)
    dhc = torch.zeros(Bp, NB * U, **f64)
    units = torch.arange(H)
    block, u = units // U, units % U
    cols = [block * 3 * U + g * U + u for g in range(3)]  # the exchange's columns
    dgx, dgh = torch.zeros(B, T, 3 * H, **f64), torch.zeros(B, T, 3 * H, **f64)
    for s in range(T):
        t_ = s if reverse else T - 1 - s
        xc, xp = xbuf[s % 2], xbuf[(s + 1) % 2]
        for r0 in range(0, B, 32):
            rows = slice(r0, min(B, r0 + 32))
            nr = rows.stop - r0
            dh = dhc[rows, :H]
            for p in grid_product(gs, xp[r0: r0 + 32], w):  # (NB, 32, N)
                dh = dh + p[:, :, :U].permute(1, 0, 2).reshape(32, NB * U)[:nr, :H]
            g = gates[rows, t_]
            r, z, n, hn = g[:, :H], g[:, H: 2 * H], g[:, 2 * H: 3 * H], g[:, 3 * H:]
            m = mask[rows, t_, None]
            dh_t = dh + m * dout[rows, t_]
            dh_new = m * dh_t
            dz = dh_new * (hprev[rows, t_] - n)
            dan = dh_new * (1 - z) * (1 - n * n)
            dar = dan * hn * r * (1 - r)
            daz = dz * z * (1 - z)
            dgx[rows, t_] = torch.cat([dar, daz, dan], -1)
            dgh[rows, t_] = torch.cat([dar, daz, dan * r], -1)
            for col, v in zip(cols, (dar, daz, dan * r)):
                xc[rows, col] = v
            dhc[rows, :H] = (1 - m) * dh_t + dh_new * z
    return dgx, dgh


#: (H, B): a last block of 1 unit (561 = 112 x 5 + 1) and two row tiles,
#: the 752 of phase 3j at one sequence, 1104 (9 units a block, K tiles of
#: 140 forward and 252 backward) at an odd batch, 1419 (11 units a block,
#: the largest whole slices) at two sequences; then the widths that stream:
#: 1420 (phase 3k's; the backward streams 5 of its 68 K tiles) at two row
#: tiles, 1701 (both directions stream; a last block of 11 of 13 units),
#: 2048 (16 units, 32 gate items: one pass of 512 threads) and 2113 (17
#: units, a last block of 5; the forward's gate pass takes two items a
#: thread).
REPLAY_CASES = [(561, 33), (752, 1), (1104, 3), (1419, 2),
                (1420, 33), (1701, 3), (2048, 2), (2113, 5)]


def _held(got, ref, what):
    err = float((got - ref.double()).abs().max()) / max(float(ref.abs().max()), 1e-30)
    assert err <= 2e-6, (what, err)


@pytest.mark.parametrize("H,B", REPLAY_CASES)
def test_grid_forward_replays_the_plain_version(H, B):
    """The forward's slices (resident and streamed), row tiles, K slices
    and carry exchange, masked (row 0 all padding), both directions, against
    the plain version: the outputs, the saved gates and the carries."""
    assert gru_ops.kernel_config(H)[0] == gru_ops.KIND_GRID
    x = gru_arrays(H, B, T=5 if H < 1420 else 3, seed=3)
    xs, wx, wh, b, mask = (t(x[k]) for k in ("xs", "wx", "wh", "b", "mask"))
    for reverse in (False, True):
        ref = gru_ops.gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
        got = replay_grid_forward((xs @ wx + b).double(), wh.double(), mask.double(), reverse)
        for name, a, r in zip(("out", "gates", "hprev"), got, ref):
            _held(a, r, (name, reverse))
        assert torch.all(got[0][mask == 0] == 0)


@pytest.mark.parametrize("H,B", REPLAY_CASES)
def test_grid_backward_replays_the_plain_version(H, B):
    """The backward's slices (rows of Wh in the exchange's column order,
    resident and streamed), row tiles, K slices, dgh exchange and carried
    direct part, masked (row 0 all padding), both directions, against the
    plain version."""
    x = gru_arrays(H, B, T=5 if H < 1420 else 3, seed=4)
    xs, wx, wh, b, mask, g = (t(x[k]) for k in ("xs", "wx", "wh", "b", "mask", "g"))
    for reverse in (False, True):
        _, gates, hprev = gru_ops.gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
        ref = gru_ops.gru_sequence_backward_plain(g, gates, hprev, wh, mask, reverse)
        got = replay_grid_backward(*(a.double() for a in (g, gates, hprev, wh, mask)), reverse)
        for name, a, r in zip(("dgx", "dgh"), got, ref):
            _held(a, r, (name, reverse))


# ------------------------------------------------- the plain GRU vs JAX --


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_plain_gru_752_matches_jax(reverse):
    """The plain version at phase 3j's width (B = 3, T = 6, D = 16, row 0
    all padding) against the JAX package's scan oracle."""
    _plain_matches_jax(752, reverse, seed=5, T=6)


def test_plain_gru_752_gradient_matches_jax_vjp():
    """The port's Function (its CPU backward: the backward kernel's explicit
    reverse loop) against jax.vjp of gru_sequence_ad, masked, reversed."""
    _gradient_matches_jax_vjp(752, seed=6, T=6)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_plain_gru_1420_matches_jax(reverse):
    """As at 752, at phase 3k's width (B = 3, T = 4)."""
    _plain_matches_jax(1420, reverse, seed=7, T=4)


def test_plain_gru_1420_gradient_matches_jax_vjp():
    """As at 752, at phase 3k's width (B = 3, T = 4)."""
    _gradient_matches_jax_vjp(1420, seed=8, T=4)


def _plain_matches_jax(H, reverse, seed, T):
    x = gru_arrays(H, 3, T, seed=seed)
    got = gru_ops.gru_sequence(*(t(x[k]) for k in ("xs", "wx", "wh", "b", "mask")), reverse)
    ref = gru_sequence_xla(jnp.asarray(x["xs"]), x["wx"], x["wh"], x["b"],
                           jnp.asarray(x["mask"]), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    assert np.all(got.numpy()[x["mask"] == 0] == 0.0)


def _gradient_matches_jax_vjp(H, seed, T):
    x = gru_arrays(H, 3, T, seed=seed)
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
