"""What the CUDA kernels B2 and B5 (`sstts_torch/csrc/gl_tail.cuh`,
`gl_semi.cu`, `gl_fused.cu`) rely on, held on the CPU: their index rules,
written out below in Python (the swizzle, the shift-add through a ring of
row groups, a bf16 pair from two words, the work schedule), against
`shift_add_rows` and plain products; and the wrappers' reckoning of shared
memory and scratch (`sstts_torch/dsp/gl_tiles.py`) against the constants in
the sources.  The Python rules are a second statement of the design, not the
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


@pytest.mark.parametrize("kw,err", [
    (dict(wp=1280, hp=1024, w_len=1200, d_max=4), NotImplementedError),  # panel > 227 KB
    (dict(wp=1152, hp=1024, w_len=1101, d_max=9), NotImplementedError),  # beyond a group
    (dict(wp=1152, hp=1024, w_len=1101, d_max=5, fused=True), NotImplementedError),
    (dict(wp=1100, hp=1024, w_len=1100, d_max=4), ValueError),
    (dict(wp=1152, hp=1000, w_len=1101, d_max=4), ValueError),
])
def test_shapes_beyond_the_kernels_raise(kw, err):
    with pytest.raises(err):
        gt.check_shapes("gl", **kw)
