"""B3 and B3' past H = 137 on a thread-block cluster, the wide kind, on the
CPU.

The wide kind's kernels (`gru_fwd_wide`, `gru_bwd_wide` in csrc/gru.cu) run
only on the card, where `chip_smoke.py` phase 2 holds them to their plain
versions at full size and phase 3i drives them through `Synthesizer` and
`train`.  A cluster of C blocks runs a tile of Bt batch rows (`wide_rows`:
enough for the batch in one wave of the clusters the card holds); rank c
owns U = ceil(H / C) units and keeps their 3U gate columns of Wh.  Here a
torch replay in float64 of both kernels' arithmetic as they lay it out
(`wide_shape`): each rank's slice, the tile's rows (rows past B carried as
zeros and written nowhere), the forward's K slices of float4 quads summed
in the kernel's order and its carry pushed into every rank's copy, the
backward's partial dh_prev of each rank's columns sent to the units'
owners and added there in rank order; at widths no cluster divides (139,
301), at B = 1, 3 and 33 (a last tile not full), on the rule's cluster and
on the smaller clusters the kernels also take (one and two rows a tile),
masked with an all-padding row, both
directions, held to the plain versions within 1e-5 (the replay in float64
against the f32 plain version).  No JAX here: the plain versions are held
to the JAX package in test_torch_widths.py.  Torch runs on one thread in
this module.
"""

import numpy as np
import pytest
import torch

from torch_parity import t

from sstts_torch.ops import gru as gru_ops


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gru_arrays(H, B, T=5, D=16, seed=0):
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


def rank_columns(wh, U, c):
    """Rank c's gate columns of Wh, (H, 3U): column g U + u is Wh's column
    g H + c U + u, zero past the last unit."""
    H = wh.shape[0]
    j = torch.arange(3 * U)
    unit = c * U + j % U
    cols = (j // U * H + unit).clamp(max=3 * H - 1)
    return torch.where(unit < H, wh[:, cols], 0)


def forward_slice(wh, ws, c):
    """gru_fwd_wide's w_s: (N, KA), slice row g U + u over the carry's
    columns k, zero past H."""
    H = wh.shape[0]
    w = torch.zeros(ws["N"], ws["KA"], dtype=wh.dtype)
    w[:, :H] = rank_columns(wh, ws["U"], c).T
    return w


def backward_slice(wh, ws, c):
    """gru_bwd_wide's w_s: (N, KA), Wh's row k over the rank's gate
    columns, zero past H rows and 3U columns."""
    H = wh.shape[0]
    w = torch.zeros(ws["N"], ws["KA"], dtype=wh.dtype)
    w[:H, : 3 * ws["U"]] = rank_columns(wh, ws["U"], c)
    return w


def k_slices(ws):
    """The carry columns each of the forward's KS slices sums, in order:
    the float4 quads ks, ks + KS, ..."""
    return [torch.tensor([4 * q + e for q in range(ks, ws["KA"] // 4, ws["KS"])
                          for e in range(4)]) for ks in range(ws["KS"])]


def replay_wide_forward(gx, wh, mask, reverse, C):
    """gru_fwd_wide's arithmetic on clusters of C, in float64: (out, gates,
    hprev) as it writes them."""
    B, T, _ = gx.shape
    H = wh.shape[0]
    rows = gru_ops.wide_rows(H, B, C)
    ws = gru_ops.wide_shape(H, C, rows, False)
    U, KA = ws["U"], ws["KA"]
    w = [forward_slice(wh, ws, c) for c in range(C)]
    idx = k_slices(ws)
    f64 = dict(dtype=torch.float64)
    out, gates, hprev = (torch.zeros(B, T, n * H, **f64) for n in (1, 4, 1))
    for b0 in range(0, B, rows):
        h_s = torch.zeros(C, 2, rows, KA, **f64)  # every rank's copy of the tile's carry
        h_own = torch.zeros(rows, C * U, **f64)   # each gate thread's own carry
        for s in range(T):
            t_ = T - 1 - s if reverse else s
            for c in range(C):
                hc = h_s[c, s % 2]
                part = [hc[:, k] @ w[c][:, k].T for k in idx]  # (KS) x (rows, N)
                sums = part[0]
                for p in part[1:]:
                    sums = sums + p
                for r in range(rows):
                    b = b0 + r
                    units = torch.arange(c * U, min(H, c * U + U))
                    if b >= B or len(units) == 0:
                        continue
                    u = units - c * U
                    g = gx[b, t_]
                    hr, hz, hn = sums[r, u], sums[r, U + u], sums[r, 2 * U + u]
                    rg = torch.sigmoid(g[units] + hr)
                    z = torch.sigmoid(g[H + units] + hz)
                    n = torch.tanh(g[2 * H + units] + rg * hn)
                    h = h_own[r, units]
                    for q, v in enumerate((rg, z, n, hn)):
                        gates[b, t_, q * H + units] = v
                    hprev[b, t_, units] = h
                    m = mask[b, t_]
                    h_new = m * (z * h + (1 - z) * n) + (1 - m) * h
                    out[b, t_, units] = m * h_new
                    h_own[r, units] = h_new
                    h_s[:, (s + 1) % 2, r, units] = h_new  # pushed into every rank
        assert torch.all(h_s[:, :, :, H:] == 0)
        assert torch.all(h_s[:, :, B - b0:] == 0)  # rows past B stay zero
    return out, gates, hprev


def replay_wide_backward(dout, gates, hprev, wh, mask, reverse, C):
    """gru_bwd_wide's arithmetic on clusters of C, in float64: (dgx, dgh) as
    it writes them."""
    B, T, H = dout.shape
    rows = gru_ops.wide_rows(H, B, C)
    ws = gru_ops.wide_shape(H, C, rows, True)
    U, KA = ws["U"], ws["KA"]
    w = [backward_slice(wh, ws, c) for c in range(C)]
    f64 = dict(dtype=torch.float64)
    dgx, dgh = torch.zeros(B, T, 3 * H, **f64), torch.zeros(B, T, 3 * H, **f64)
    for b0 in range(0, B, rows):
        recv = torch.zeros(C, 2, C, rows, U, **f64)  # [owner, half, sender, row, unit]
        dhc = torch.zeros(rows, C * U, **f64)
        for s in range(T):
            t_ = s if reverse else T - 1 - s
            d_s = torch.zeros(C, rows, KA, **f64)
            for c in range(C):
                units = torch.arange(c * U, min(H, c * U + U))
                u = units - c * U
                for r in range(rows):
                    b = b0 + r
                    if b >= B or len(units) == 0:
                        continue
                    dh = dhc[r, units]
                    for q in range(C):  # the senders in rank order
                        dh = dh + recv[c, s % 2, q, r, u]
                    g = gates[b, t_]
                    rg, z, n, hn = (g[q * H + units] for q in range(4))
                    m = mask[b, t_]
                    dh_t = dh + m * dout[b, t_, units]
                    dh_new = m * dh_t
                    dz = dh_new * (hprev[b, t_, units] - n)
                    dan = dh_new * (1 - z) * (1 - n * n)
                    dar = dan * hn * rg * (1 - rg)
                    daz = dz * z * (1 - z)
                    for q, (vx, vh) in enumerate(((dar, dar), (daz, daz), (dan, dan * rg))):
                        dgx[b, t_, q * H + units] = vx
                        dgh[b, t_, q * H + units] = vh
                        d_s[c, r, q * U + u] = vh
                    dhc[r, units] = (1 - m) * dh_t + dh_new * z
            nxt = torch.zeros_like(recv[:, 0])
            valid = min(rows, B - b0)
            for c in range(C):
                p = d_s[c] @ w[c].T  # (rows, N): a partial dh_prev of Wh's rows
                part = torch.zeros(rows, C * U, **f64)
                part[:, :H] = p[:, :H]  # unit k to rank k // U, its unit k % U
                nxt[:, c, :valid] = part[:valid].reshape(valid, C, U).permute(1, 0, 2)
            recv[:, (s + 1) % 2] = nxt
    return dgx, dgh


#: (H, B, C): widths no cluster divides on the rule's cluster (139: C = 5,
#: tiles of 2 rows, the last rank 27 of 28 units, at B = 33 a last tile of
#: one row; 301: C = 10, tiles of 5 rows, the last rank 22 of 31 units, at
#: B = 33 a last tile of 3 rows, at B = 3 one tile of 3 of its 5 rows) and
#: on smaller clusters (139 on 2: one row a tile, the last rank one unit
#: short; 301 on 6: tiles of 2 rows, at B = 33 a last tile of one row).
def _cases():
    return [(139, 1, None), (139, 3, None), (139, 33, None), (301, 1, None),
            (301, 3, None), (301, 33, None), (139, 33, 2), (301, 33, 6)]


def _cluster(H, C):
    kind, rule = gru_ops.kernel_config(H)
    assert kind == gru_ops.KIND_WIDE
    return rule if C is None else C


def _held(got, ref, what):
    np.testing.assert_allclose(got.numpy(), ref.double().numpy(), atol=1e-5, err_msg=str(what))


@pytest.mark.parametrize("H,B,C", _cases())
def test_wide_forward_replays_the_plain_version(H, B, C):
    """The forward's slices, tiles, K slices and carry exchange, masked (row
    0 all padding), both directions, against the plain version: the
    outputs, the saved gates and the carries."""
    C = _cluster(H, C)
    x = gru_arrays(H, B, seed=3)
    xs, wx, wh, b, mask = (t(x[k]) for k in ("xs", "wx", "wh", "b", "mask"))
    for reverse in (False, True):
        ref = gru_ops.gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
        got = replay_wide_forward((xs @ wx + b).double(), wh.double(), mask.double(), reverse, C)
        for name, a, r in zip(("out", "gates", "hprev"), got, ref):
            _held(a, r, (name, reverse))
        assert torch.all(got[0][mask == 0] == 0)


@pytest.mark.parametrize("H,B,C", _cases())
def test_wide_backward_replays_the_plain_version(H, B, C):
    """The backward's slices, tiles and reduce-scatter of partial dh_prev,
    masked (row 0 all padding), both directions, against the plain
    version."""
    C = _cluster(H, C)
    x = gru_arrays(H, B, seed=4)
    xs, wx, wh, b, mask, g = (t(x[k]) for k in ("xs", "wx", "wh", "b", "mask", "g"))
    for reverse in (False, True):
        _, gates, hprev = gru_ops.gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
        ref = gru_ops.gru_sequence_backward_plain(g, gates, hprev, wh, mask, reverse)
        got = replay_wide_backward(*(a.double() for a in (g, gates, hprev, wh, mask)),
                                   reverse, C)
        for name, a, r in zip(("dgx", "dgh"), got, ref):
            _held(a, r, (name, reverse))


def test_wide_tiles_cover_the_batch_once():
    """At every width the wide kind takes and B = 1..70, the tiles of
    `wide_rows` rows cover the batch in ceil(B / Bt) clusters, the last
    one not empty; at B = 32 in one wave of the clusters the card holds."""
    for H in range(138, gru_ops.GRID_MIN_HIDDEN):
        C = gru_ops.kernel_config(H)[1]
        for B in range(1, 71):
            rows = gru_ops.wide_rows(H, B, C)
            assert 1 <= rows <= gru_ops.WIDE_MAX_ROWS
            clusters = -(-B // rows)
            assert (clusters - 1) * rows < B <= clusters * rows
            if B <= 32:
                assert clusters <= gru_ops.WIDE_CLUSTERS[C], (H, B)


@pytest.mark.parametrize("counts", [
    gru_ops.WIDE_CLUSTERS,  # the H100 SXM's reference count, the CPU's default
    (0, 132, 64, 40, 32, 24, 18, 16, 14, 8, 6, 6, 6, 6, 5, 5, 4),  # a die with fewer
    (0, 132, 66, 44, 33, 26, 22, 18, 16, 14, 13, 12, 11, 10, 9, 8, 8),  # one with more
    (0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1),  # one cluster at a time
], ids=["reference", "fewer", "more", "one"])
def test_wide_rows_divide_the_batch_by_the_cards_clusters(counts):
    """`wide_rows` with the clusters of each C that a card holds gives Bt =
    ceil(B / count), capped at WIDE_MAX_ROWS and at what the block holds in
    both directions (then the batch runs in more waves); the CPU's default
    is the reference table, and a card holding no cluster of C gives 0."""
    for C in range(2, gru_ops.MAX_CLUSTER + 1):
        assert gru_ops.wide_clusters(C, "cpu") == gru_ops.WIDE_CLUSTERS[C]
        assert gru_ops.wide_rows(139, 32, C, 0) == 0
    for H in (138, 139, 256, 301, 384, 512, 522):
        C = gru_ops.kernel_config(H)[1]
        for c in range(C, gru_ops.MAX_CLUSTER + 1):
            for B in (1, 3, 32, 33, 64, 177):
                rows = gru_ops.wide_rows(H, B, c, counts[c])
                want = min(-(-B // counts[c]), gru_ops.WIDE_MAX_ROWS)
                fits = [r for r in range(1, want + 1)
                        if all(gru_ops.wide_shape(H, c, r, b)["valid"] for b in (False, True))]
                assert rows == max(fits, default=0), (H, c, B)
                if counts is gru_ops.WIDE_CLUSTERS:
                    assert rows == gru_ops.wide_rows(H, B, c)
                if rows == want == -(-B // counts[c]):  # one wave
                    assert -(-B // rows) <= counts[c]
