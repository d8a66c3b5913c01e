"""What the CUDA kernels B2 and B5 (`sstts_torch/csrc/gl_tail.cuh`,
`gl_semi.cu`, `gl_fused.cu`) rely on, held on the CPU: their index rules,
written out below in Python (the swizzle, the shift-add through a ring of
row groups, a bf16 pair from two words, the work schedule), against
`shift_add_rows` and plain products; and the wrappers' reckoning of shared
memory and scratch (`sstts_torch/dsp/gl_tiles.py`) against the constants in
the sources, and the choice between the kernels' two tile configurations
(whole panel, wide) at every geometry of their envelope.  The Python rules are a second statement of the design, not the
kernels: those run only on a card, where `chip_smoke.py` holds them to their
plain versions.

Exactness: the shift-add tests compare f32 sums of the same terms in the
same order, so they must be equal bit for bit; the product tests use small
integers, whose f32 sums are exact in any order.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sstts_torch.dsp import gl_tiles as gt
from sstts_torch.dsp.reproject import band_plan, shift_add_rows

CSRC = Path(gt.__file__).resolve().parent.parent / "csrc"

#: (n_fft, hop, win): the tiny config's geometry (w_len 399, D = 3) and one
#: with an odd hop and a support that is no multiple of 16 (w_len 219, D = 4).
GEOMETRIES = [(512, 100, 400), (256, 53, 220)]


# ------------------------------------------- the kernels' index rules --


def swizzle128_offset(row: int, k: int) -> int:
    """Byte offset of bf16 element (row, k) in the panel: 8 KB chunks of 64
    lanes, rows of 128 bytes whose 16-byte pieces are XOR-ed with the row's
    low three bits (TMA's SWIZZLE_128B, what a wgmma descriptor reads)."""
    chunk, kk = divmod(k, gt.BK)
    piece = (kk // 8) ^ (row & 7)
    return chunk * gt.CHUNK_BYTES + row * 128 + piece * 16 + (kk % 8) * 2


def shift_order(d_max: int) -> list:
    """The order the shifted terms are added in: 0, then -D..D without 0."""
    return [0] + [d for d in range(-d_max, d_max + 1) if d]


def pair_from_words(words, lane: int, w_len: int):
    """The bf16 lanes (lane, lane + 1) of a row given as little-endian 32-bit
    words (numpy uint32), as the kernel reads them: the two words that hold
    them joined by a funnel shift when `lane` is odd, each lane as the f32
    whose high half it is, +0 for a lane outside [0, w_len).  The words may
    be read outside the row (the kernel's loads are not masked, only their
    values are), so `words` is indexed modulo its length."""
    n = len(words)
    w0 = int(words[(lane >> 1) % n])
    w1 = int(words[((lane >> 1) + 1) % n])
    pair = ((w0 >> 16) | (w1 << 16)) & 0xFFFFFFFF if lane & 1 else w0
    bits = [(pair << 16) & 0xFFFFFFFF, pair & 0xFFFF0000]
    vals = np.array(bits, dtype=np.uint32).view(np.float32)
    ok = [0 <= lane < w_len, 0 <= lane + 1 < w_len]
    return [float(v) if good else 0.0 for v, good in zip(vals, ok)]


def ring_shift_add(f: torch.Tensor, w_len: int, hop: int, d_max: int, t0: int,
                   elem_bytes: int) -> torch.Tensor:
    """The panel's sums for frames [t0, t0 + BM) of F (T, wp) as the kernels
    form them.  Rows pass through F_SLOTS slots of `group` = 16 / elem_bytes
    rows: group g holds frames [t0 + (g - 1) group, t0 + g group), only those
    inside the utterance and the halo; the producer runs as far ahead as the
    slots allow (group g lands when output group g - F_SLOTS is done).  For
    output row r and shift d the source row is found at ring row
    (r - d + group) mod (F_SLOTS * group); a row outside [0, T) and a lane
    outside [0, w_len) add nothing.  Terms are added in `shift_order`.
    Returns (BM, k_needed(w_len)) f32."""
    group = 16 // elem_bytes
    n_frames = f.shape[-2]
    kd = gt.k_needed(w_len)
    ring = torch.full((gt.F_SLOTS * group, f.shape[-1]), float("nan"))
    out = torch.zeros(gt.BM, kd)
    n_groups = gt.BM // group + 2
    loaded = 0

    def load_until(g_hi: int) -> None:
        nonlocal loaded
        while loaded < min(g_hi, n_groups):
            g = loaded
            u0 = t0 + (g - 1) * group
            ring[g % gt.F_SLOTS * group : (g % gt.F_SLOTS + 1) * group] = float("nan")
            lo = max(u0, 0, t0 - d_max)
            hi = min(u0 + group, n_frames, t0 + gt.BM + d_max)
            for u in range(lo, hi):
                ring[g % gt.F_SLOTS * group + (u - u0)] = f[u].float()
            loaded += 1

    lanes = torch.arange(kd)
    for og in range(gt.BM // group):
        load_until(og + gt.F_SLOTS)  # everything the free slots can take
        for rg in range(group):
            r = og * group + rg
            t = t0 + r
            acc = torch.zeros(kd)
            for d in shift_order(d_max):
                u = t - d
                if t >= n_frames or u < 0 or u >= n_frames:
                    continue
                row = ring[(r - d + group) % (gt.F_SLOTS * group)]
                src = lanes + d * hop
                ok = (src >= 0) & (src < w_len)
                acc = acc + torch.where(ok, row[src.clamp(0, f.shape[-1] - 1)],
                                        torch.zeros(()))
            out[r] = acc
    return out


def cluster_size(bt: int, built_for: int = 2) -> int:
    """Blocks a cluster (`cluster_size` in gl_tail.cuh): what the library was
    built for (SSTTS_CLUSTER, 2 unless a tool sets it), 1 for a single
    utterance."""
    return built_for if bt >= 2 else 1


def schedule(n_frames: int, bt: int, hp: int, cluster: int):
    """Every (row block, utterance, bin tile, cluster member, warpgroup) the
    grid computes and stores: the grid is (row blocks, bt rounded up to whole
    clusters); member r of the cluster at y takes utterance y + r and stores
    only when that utterance exists; of a block's hp / BN bin tiles,
    consumer warpgroup w takes w, w + 2, ..."""
    for rb in range(-(-n_frames // gt.BM)):
        for y in range(0, gt.round_up(bt, cluster), cluster):
            for member in range(cluster):
                if y + member >= bt:
                    continue
                for pair in range(hp // (2 * gt.BN)):
                    for wg in range(2):
                        yield rb, y + member, 2 * pair + wg, member, wg


def ring_stage(n: int, n_kc: int, n_pairs: int, rotation: int = 0) -> tuple:
    """(slot, use, bin tile, K chunk) of the n-th stage the producer loads.
    A block starts its cycle of the n_pairs bin-tile pairs at pair
    `rotation` (its row block plus its cluster's number), so that blocks
    running together work at different bins."""
    pair = ((n >> 1) // n_kc + rotation) % n_pairs
    return n % gt.STAGES, n // gt.STAGES, 2 * pair + (n & 1), (n >> 1) % n_kc


# ---------------------------------------------------------- the tests --


def _frames(n_frames, wp, w_len, dtype, seed, batch=()):
    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.normal(size=(*batch, n_frames, wp)).astype(np.float32))
    f[..., w_len:] = 0.0
    return f.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_frames,t0", [(150, 0), (150, 128), (37, 0), (3, 0), (70, 64)])
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_ring_shift_add_equals_shift_add_rows(geom, n_frames, t0, dtype):
    """The kernels' formulation of the shift-add, equal bit for bit to
    `shift_add_rows`: rows of F through a ring of four row groups (8 bf16 or
    4 f32 rows), the producer as far ahead as the ring allows, each source
    row found at (r - d + group) mod ring size; T no multiple of 64, T <= D,
    w_len no multiple of 16, a row block at an utterance's end, and lanes
    beyond the support that hold no zeros."""
    n_fft, hop, win = geom
    plan = band_plan(n_fft, hop, win, n_frames, (n_frames - 1) * hop)
    w_len, d_max = plan["w_len"], plan["d_max"]
    wp = gt.round_up(w_len, 128)
    f = _frames(n_frames, wp, w_len, dtype, 4)
    f[..., w_len:] = 7.0  # lanes beyond the support must not be read
    got = ring_shift_add(f, w_len, hop, d_max, t0, f.element_size())
    rows = min(gt.BM, n_frames - t0)
    clean = f.clone()
    clean[..., w_len:] = 0.0
    ref = shift_add_rows(clean, w_len, hop, d_max, t0, t0 + rows)
    assert torch.isfinite(got).all()  # no row read that was not loaded
    assert torch.equal(got[:rows, :w_len], ref[:, :w_len])
    assert not got[rows:].any()


@pytest.mark.parametrize("lane", [-3, -2, -1, 0, 1, 6, 7, 17, 18, 19, 20])
def test_pair_from_words(lane):
    """A bf16 pair at an even or odd lane out of 32-bit words, masked to
    [0, w_len)."""
    w_len = 19
    row = torch.arange(1, 25, dtype=torch.float32).to(torch.bfloat16)
    words = row.view(torch.int16).numpy().view(np.uint32)
    got = pair_from_words(words, lane, w_len)
    want = [float(row[l]) if 0 <= l < w_len else 0.0 for l in (lane, lane + 1)]
    assert got == want


@pytest.mark.parametrize("w_len", [399, 219, 1101])
def test_k_cut_and_k_major_reproduce_the_product(w_len):
    """GEMM2 over K = w_len rounded up to 16 with the transposed, K-major
    w_fwd equals the plain product over all wp lanes (integers: exact)."""
    wp, L = gt.round_up(w_len, 128), 256
    rng = np.random.default_rng(w_len)
    a = torch.from_numpy(rng.integers(-4, 5, size=(64, wp)).astype(np.float32))
    a[:, w_len:] = 0.0
    w = torch.from_numpy(rng.integers(-4, 5, size=(wp, L)).astype(np.float32))
    a16, w16 = a.to(torch.bfloat16), w.to(torch.bfloat16)
    w_t = gt.k_major(w16)
    assert w_t.shape == (L, wp) and w_t.is_contiguous()
    assert torch.equal(w_t.t(), w16)
    kd = gt.k_needed(w_len)
    assert kd % 16 == 0 and w_len <= kd < w_len + 16 and kd <= wp
    full = a16.float() @ w16.float()
    cut = a16[:, :kd].float() @ w_t[:, :kd].float().t()
    assert torch.equal(full, cut)


def test_swizzle128_is_a_permutation_of_each_chunk():
    """Each 8 KB chunk of the panel holds its 64 rows x 64 lanes once, a
    row's 16-byte pieces XOR-ed with its low three bits."""
    offs = {swizzle128_offset(r, k) for r in range(gt.BM) for k in range(2 * gt.BK)}
    assert len(offs) == gt.BM * 2 * gt.BK
    assert offs == set(range(0, 2 * gt.CHUNK_BYTES, 2))
    assert swizzle128_offset(0, 8) == 16 and swizzle128_offset(1, 8) == 128
    assert swizzle128_offset(5, 64 + 3) == gt.CHUNK_BYTES + 5 * 128 + 5 * 16 + 6


@pytest.mark.parametrize("bt", [1, 3, 32])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_schedule_covers_every_output_tile_once(cluster, bt):
    n_frames, hp = 150, 256
    seen = list(schedule(n_frames, bt, hp, cluster))
    tiles = [(rb, utt, tile) for rb, utt, tile, _, _ in seen]
    want = {(rb, utt, tile) for rb in range(3) for utt in range(bt)
            for tile in range(hp // gt.BN)}
    assert len(tiles) == len(set(tiles)) and set(tiles) == want
    for rb, utt, tile, member, wg in seen:
        assert member == utt % cluster and wg == tile % 2
    assert cluster_size(bt) == (1 if bt == 1 else 2)
    assert cluster_size(bt, cluster) == (1 if bt == 1 else cluster)


@pytest.mark.parametrize("rotation", [0, 3, 13])
@pytest.mark.parametrize("n_kc", [7, 18])
def test_ring_stages_carry_every_tile_chunk_once(n_kc, rotation):
    """The producer's n-th stage: every (bin tile, K chunk) once whatever
    pair the block starts at, alternate stages to alternate warpgroups,
    slots in turn."""
    n_pairs = 4
    stages = [ring_stage(n, n_kc, n_pairs, rotation) for n in range(2 * n_pairs * n_kc)]
    assert {(tile, kc) for _, _, tile, kc in stages} == {
        (tile, kc) for tile in range(2 * n_pairs) for kc in range(n_kc)}
    for n, (slot, use, tile, kc) in enumerate(stages):
        assert slot == n % gt.STAGES and use == n // gt.STAGES and tile % 2 == n % 2
    for wg in range(2):  # a warpgroup sees its tiles whole, K in order
        mine = [(tile, kc) for n, (_, _, tile, kc) in enumerate(stages) if n % 2 == wg]
        order = [2 * ((pr + rotation) % n_pairs) + wg for pr in range(n_pairs)]
        assert mine == [(tile, kc) for tile in order for kc in range(n_kc)]


def _constants(*names):
    """`constexpr int NAME = <expression>;` of the sources, evaluated."""
    text = "".join((CSRC / n).read_text() for n in names)
    env = {}
    for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
        env[m[1]] = int(eval(m[2], {"__builtins__": {}}, dict(env)))  # noqa: S307
    return env


def test_python_reckoning_matches_the_sources():
    c = _constants("gl_tail.cuh", "gl_fused.cu")
    mirror = {
        "BM": gt.BM, "BN": gt.BN, "BK": gt.BK, "kStages": gt.STAGES,
        "kChunkBytes": gt.CHUNK_BYTES, "kStageBytes": gt.STAGE_BYTES,
        "kFSlots": gt.F_SLOTS, "kMaxPass": gt.MAX_PASS,
        "kBarrierBytes": gt.BARRIER_BYTES, "N1": gt.N1, "M1_TILES": gt.M1_TILES,
        "kG1StageBytes": gt.G1_STAGE_BYTES, "kG1MaxStages": gt.G1_MAX_STAGES,
    }
    assert {k: c[k] for k in mirror} == mirror
    assert c["kProducerRegs"] * 128 + c["kConsumerRegs"] * 256 <= 65536
    assert c["kThreads"] == 384 and c["kConsumers"] == 256
    assert 2 * gt.BN % c["kBoxRows"] == 0  # whole TMA boxes a ring stage
    # the barriers fit their area: ring full/empty, F full/empty, 9 of GEMM1
    assert (2 * gt.STAGES + 2 * gt.F_SLOTS + 2 * gt.G1_MAX_STAGES + 1) * 8 <= gt.BARRIER_BYTES
    # the default config (w_len 1101, D = 4) and the tiny one (399, D = 3)
    assert gt.check_shapes("gl_semi", 1152, 1024, 1101, 4) == 230656 <= gt.MAX_SMEM
    assert gt.check_shapes("gl_fused", 1152, 1024, 1101, 4, fused=True) == 230656
    assert gt.check_shapes("gl_fused", 512, 256, 399, 3, fused=True) == 140544
    assert gt.g1_stages(1101) == 4 and gt.g1_stages(399) == 3 and gt.g1_stages(16) == 2
    assert gt.slab_floats(1152) == 72 * 1152
    # the wide configuration (gl_wide.cuh)
    w = _constants("gl_wide.cuh")
    wide = {
        "kThreads": gt.WIDE_THREADS, "kRows": gt.WIDE_ROWS, "kG1Rows": gt.WIDE_G1_ROWS,
        "kMaxD": gt.WIDE_MAX_D, "kMaxLanes": gt.WIDE_MAX_LANES, "kBins": gt.WIDE_BINS,
        "kLanes": gt.WIDE_LANES, "kKBytes": gt.WIDE_K_BYTES,
        "kRowBytes": gt.WIDE_ROW_BYTES, "kStageRows": gt.WIDE_STAGE_ROWS,
        "kStages": gt.WIDE_STAGES, "kSmemBytes": gt.WIDE_SMEM, "kKAlign": gt.WIDE_K_ALIGN,
    }
    assert {k: w[k] for k in wide} == wide
    assert gt.WIDE_SMEM == 76800 and 2 * (gt.WIDE_SMEM + 1024) <= 233472  # two blocks an SM
    assert gt.WIDE_G1_ROWS == gt.WIDE_ROWS + 2 * gt.WIDE_MAX_D
    assert gt.wide_smem_bytes(2047, 16) == 76800 and gt.wide_smem_bytes(2047, 17) == -1
    assert gt.wide_smem_bytes(2049, 3) == -1
    assert gt.wide_slab_bytes(1152, 2, False) == 64 * 1152 * 2
    assert gt.wide_slab_bytes(2048, 4, True) == (96 + 64) * 2048 * 4
    # the padded rows put the fragment loads of a warp's 8 rows x 4 words on
    # 32 different banks
    banks = {(g * gt.WIDE_ROW_BYTES // 4 + t) % 32 for g in range(8) for t in range(4)}
    assert len(banks) == 32


@pytest.mark.parametrize("kw,err", [
    (dict(wp=1280, hp=1024, w_len=1200, d_max=4), NotImplementedError),  # panel > 227 KB
    (dict(wp=1152, hp=1024, w_len=1101, d_max=9), NotImplementedError),  # beyond a group
    (dict(wp=1152, hp=1024, w_len=1101, d_max=5, fused=True), NotImplementedError),
    (dict(wp=1100, hp=1024, w_len=1100, d_max=4), ValueError),
    (dict(wp=1152, hp=1000, w_len=1101, d_max=4), ValueError),
    # beyond the wide configuration too: D = 17, a window over 2048 samples,
    # and n_fft 4096's bins in the f32 loop at a short hop
    (dict(wp=1152, hp=1024, w_len=1101, d_max=17), NotImplementedError),
    (dict(wp=2176, hp=1024, w_len=2100, d_max=3, fused=True), NotImplementedError),
    (dict(wp=1152, hp=1280, w_len=1101, d_max=9), NotImplementedError),
])
def test_shapes_beyond_the_kernels_raise(kw, err):
    """The panel configuration refuses each shape (`check_shapes`).  The
    first three are inside the envelope (n_fft <= 2048, D <= 16), so
    `config` takes them in both loop dtypes with the wide configuration: its
    shared memory fits the card whatever the support, and B5's GEMM1 tile
    covers the block's 64 frames and D halo rows a side.  The rest raise
    there too, the layouts the kernels never take with ValueError."""
    with pytest.raises(err):
        gt.check_shapes("gl", **kw)
    fused = kw.pop("fused", False)
    inside = (err is NotImplementedError and kw["d_max"] <= gt.WIDE_MAX_D
              and kw["wp"] <= gt.WIDE_MAX_LANES and kw["hp"] <= gt.MAX_HP)
    for dtype in (torch.bfloat16, torch.float32):
        if not inside:
            with pytest.raises(err):
                gt.config("gl", **kw, fused=fused, dtype=dtype)
            continue
        name, smem = gt.config("gl", **kw, fused=fused, dtype=dtype)
        assert name == "wide" and smem == gt.WIDE_SMEM <= gt.MAX_SMEM
        assert gt.WIDE_ROWS + 2 * kw["d_max"] <= gt.WIDE_G1_ROWS
        assert gt.WIDE_G1_ROWS + gt.WIDE_LANES <= gt.WIDE_STAGE_ROWS


#: (case, n_fft, hop, window, w_len, D, the panel configuration takes B2,
#: B5) for the dataset settings of the kernels' envelope: the defaults,
#: 16 kHz at n_fft 1024, 24 kHz at the reference's 50 / 12.5 ms, hops of
#: 10, 5 and 3 ms at 22.05 kHz, and 44.1 kHz at n_fft 2048 with a
#: 2048-sample window and a 512-sample hop.
GEOMETRY_TABLE = [
    ("defaults", 2048, 275, 1102, 1101, 4, True, True),
    ("16kHz", 1024, 200, 800, 799, 3, True, True),
    ("24kHz", 2048, 300, 1200, 1199, 3, False, False),
    ("hop10ms", 2048, 220, 1102, 1101, 5, True, False),
    ("hop5ms", 2048, 110, 1102, 1101, 10, False, False),
    ("hop3ms", 2048, 66, 1102, 1101, 16, False, False),
    ("44kHz", 2048, 512, 2048, 2047, 3, False, False),
]


@pytest.mark.parametrize("case", GEOMETRY_TABLE, ids=[c[0] for c in GEOMETRY_TABLE])
def test_every_geometry_of_the_envelope_has_a_configuration(case):
    """Each geometry, B2 and B5, bf16 and f32: the whole-panel
    configuration where it fits in bf16 (the defaults keep it), the wide one
    elsewhere; `griffin_lim.kernel_config` asks the same of a dataset's
    settings."""
    from sstts_torch.dsp.griffin_lim import kernel_config

    _, n_fft, hop, win, w_len, d_max, semi_panel, fused_panel = case
    plan = band_plan(n_fft, hop, win, 70, 69 * hop)
    assert (plan["w_len"], plan["d_max"]) == (w_len, d_max)
    wp = gt.round_up(w_len, 128)
    for fft_impl, dtype, half in (("dft_default", torch.bfloat16, n_fft // 2),
                                  ("dft_high", torch.float32, n_fft // 2 + 1)):
        hp = gt.round_up(half, 128)
        for kernel, fused, panel in (("gl_semi", False, semi_panel),
                                     ("gl_fused", True, fused_panel)):
            name, smem = gt.config(kernel, wp, hp, w_len, d_max, fused, dtype)
            want = "panel" if panel and dtype == torch.bfloat16 else "wide"
            assert name == want and smem <= gt.MAX_SMEM
            impl = "fused" if fused else "semi"
            assert kernel_config(impl, n_fft, hop, win, fft_impl, "cuda") == want
            assert kernel_config(impl, n_fft, hop, win, fft_impl, "cpu") is None


def test_resolve_iter_impl_takes_the_f32_loop_on_the_card():
    """The f32 loop runs B2 ("auto" is "semi") and B5 on the card: no
    refusal by dtype any more; the reference's ValueErrors stay."""
    from sstts_torch.dsp.griffin_lim import resolve_iter_impl

    assert resolve_iter_impl(None, 0.0, "dft_high", "cuda") == "semi"
    assert resolve_iter_impl("fused", 0.0, "dft_highest", "cuda") == "fused"
    assert resolve_iter_impl("semi", 0.99, "dft_highest", "cuda") == "semi"
    with pytest.raises(ValueError, match="momentum"):
        resolve_iter_impl("fused", 0.5, "dft_high", "cuda")


def wide_b_row(c: int, j0: int, hp: int) -> int:
    """Row of the transposed w_fwd (2 hp, wp) that column c (0..255) of a
    wide GEMM2 tile at bin j0 multiplies (the `b_row` of gl_wide.cuh's
    gemm2_renorm): warp column wn = c // 64 holds bins j0 + 32 wn .. + 32,
    their real columns in its n8 tiles 0..3, their imaginary ones in 4..7."""
    nt = (c & 63) >> 3
    return (hp if nt >= 4 else 0) + j0 + 32 * (c >> 6) + 8 * (nt & 3) + (c & 7)


@pytest.mark.parametrize("hp", [128, 512, 1152])
def test_wide_column_tiles_pair_re_and_im_in_one_thread(hp):
    """Over the hp / 128 column tiles every real and imaginary column of
    w_fwd is multiplied once, and the fragment element a thread holds in n8
    tile nt (< 4) is the real part of the bin whose imaginary part it holds
    in tile nt + 4: bin j0 + 32 wn + 8 nt + 2 t + e, where the epilogue
    loads mag2 and stores q'."""
    rows = [wide_b_row(c, j0, hp) for j0 in range(0, hp, gt.WIDE_BINS) for c in range(256)]
    assert sorted(rows) == list(range(2 * hp))
    for j0 in range(0, hp, gt.WIDE_BINS):
        for wn in range(4):
            for nt in range(4):
                for t in range(4):
                    for e in range(2):
                        col = 8 * nt + 2 * t + e
                        re = wide_b_row(64 * wn + col, j0, hp)
                        im = wide_b_row(64 * wn + 32 + col, j0, hp)
                        assert re == j0 + 32 * wn + 8 * nt + 2 * t + e and im == hp + re


def tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: x rounded to 10 bits of mantissa, ties away from
    zero, as f32."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x1000) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def test_three_tf32_products_carry_an_f32_product():
    """The wide configuration's f32 products: x = hi + lo with both tf32
    (`split_tf32` in sm90.cuh), and hi*hi' + hi*lo' + lo*hi' (the three
    mma.sync products) within 2^-20 of the product's size, where one tf32
    product is off by up to ~2^-10."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=100_000).astype(np.float32)
    b = rng.normal(size=100_000).astype(np.float32)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    exact = a.astype(np.float64) * b.astype(np.float64)
    three = (ah.astype(np.float64) * bh + ah.astype(np.float64) * bl
             + al.astype(np.float64) * bh)
    one = ah.astype(np.float64) * bh
    scale = np.abs(exact)
    assert (np.abs(three - exact) <= 2.0**-20 * scale).all()
    assert np.abs(one - exact).max() / scale[np.argmax(np.abs(one - exact))] > 2.0**-12


def l2_bytes_per_block(design: str, wp: int, hp: int, w_len: int, d_max: int,
                       elem_bytes: int = 2) -> int:
    """Bytes a block of 64 frames reads from L2 for its panel and GEMM2 (B2)
    in each design the kernels could take at geometries beyond the panel
    configuration, the reckoning that chose the wide one:

    - "streamed": the panel rebuilt in K pieces for each of GEMM2's
      column tiles of 128 bins, each piece re-reading the 2 D + 1 shifted
      rows of F (64 + 2 D rows): (2 D + 1) x (64 + 2 D) x w_len values a
      tile;
    - "slab" (the wide configuration): F's rows once, 2 D + 1 reads each,
      the panel written once and read back a tile (64 x wp values each).

    Both read all of w_fwd's needed rows once a block (2 hp x w_len), which
    is added."""
    tiles = hp // gt.WIDE_BINS
    weights = 2 * hp * w_len * elem_bytes
    if design == "streamed":
        return tiles * (2 * d_max + 1) * (gt.WIDE_ROWS + 2 * d_max) * w_len * elem_bytes + weights
    if design == "slab":
        build = (2 * d_max + 1) * gt.WIDE_ROWS * w_len * elem_bytes
        return build + (1 + tiles) * gt.WIDE_ROWS * wp * elem_bytes + weights
    raise ValueError(f"unknown design {design!r}")



def test_wide_design_reads_less_from_l2_than_a_streamed_panel():
    """The reckoning that chose the wide configuration's slab over a panel
    streamed in K pieces (gl_wide.cuh's header quotes these numbers, bf16
    MB a block of 64 frames)."""
    mb = lambda *a: round(l2_bytes_per_block(*a) / 1e6, 1)  # noqa: E731
    assert (mb("streamed", 1152, 1024, 1101, 4), mb("slab", 1152, 1024, 1101, 4)) == (15.9, 7.1)
    assert (mb("streamed", 1152, 1024, 1101, 16), mb("slab", 1152, 1024, 1101, 16)) == (60.3, 10.5)
    for geom in GEOMETRY_TABLE:
        _, _, _, _, w_len, d_max, _, _ = geom
        wp = gt.round_up(w_len, 128)
        assert mb("slab", wp, 1024, w_len, d_max) < mb("streamed", wp, 1024, w_len, d_max)
