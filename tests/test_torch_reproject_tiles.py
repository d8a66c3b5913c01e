"""Kernel B1's index rules, on the CPU (sstts_torch/csrc/reproject.cu and
its host side in sstts_torch/dsp/reproject.py).  The kernel runs only on
the card (`chip_smoke.py` holds it to its plain version bit for bit); these
tests state in Python what each of its blocks does, run that statement on
seeded frames, and hold the result to `reproject_frames_plain` bit for bit:

- the strips (`strip_count`, `strip_starts`): a block walks rows [t0, t1)
  of one utterance and every mirror run lies inside the strip of its target
  row;
- the ring (`ring_config`): input rows [t0 - D, t1 + D) within [0, T), G
  rows a stage, NS stages; a producer that reuses a stage only after every
  consumer warp released it, consumers that wait for the stage of row
  t + D before row t and release a stage after its last row's last use;
- a segment of 8 bf16 or 4 f32 lanes: its source segment for a term is all
  inside the window support (two aligned 16-byte loads, a lane's float
  from its word by a shift or a mask), all
  outside (skipped) or across the edge (lane by lane); the terms added in
  f32 in the kernel's order, one rounding at the end;
- the mirror runs from the device run table, in run order, by the block
  whose strip holds them.

Geometries: the default config's (22.05 kHz, n_fft 2048, hop 275, window
1102: w_len 1101 in wp 1152, D = 4), a hop of 137 (D = 8) and a 16 kHz
corpus (hop 200, window 800: w_len 799 in wp 896, D = 3), at 800, 515, 37
and 5 frames.  No JAX: `reproject_frames_plain` is held to the JAX package
by tests/test_torch_reproject.py.
"""

import re

import numpy as np
import pytest
import torch

from sstts_torch.dsp import reproject as rp
from sstts_torch.ops import build

GEOMETRIES = {
    "22k": (2048, 275, 1102),
    "hop137": (2048, 137, 1102),
    "16k": (1024, 200, 800),
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


#: Output rows a consumer computes together (kRows in reproject.cu).
ROWS = int(re.search(r"constexpr int kRows = (\d+);", (build.CSRC / "reproject.cu").read_text())[1])


def smem_bytes(wp, elem_bytes, group, stages):
    """csrc/reproject.cu's sstts_reproject_smem_bytes (held to the source
    by test_host_mirrors_match_reproject_cu)."""
    return 16 * stages + stages * group * wp * elem_bytes + 16


def geometry(name, n_frames):
    n_fft, hop, win = GEOMETRIES[name]
    length = (n_frames - 1) * hop
    plan = rp.band_plan(n_fft, hop, win, n_frames, length)
    wp = -(-plan["w_len"] // 128) * 128
    return (n_fft, hop, win, length), plan, wp


def shifted_bf16(words, r):
    """The kernel's Lanes<bf16>::add_shifted<R> on two aligned segments
    (eight 32-bit words, two bf16 lanes each): lane r + m is the high half
    of word (r + m) / 2 when r + m is odd, else its low half, taken as the
    f32 bit pattern by one mask or one shift."""
    out = []
    for m in range(8):
        w = words[(r + m) >> 1]
        f32 = (w & 0xFFFF0000) if (r + m) & 1 else ((w << 16) & 0xFFFFFFFF)
        out.append(f32 >> 16)
    return out


def test_shifted_lanes_come_from_their_words():
    rng = np.random.default_rng(0)
    for _ in range(20):
        lanes = [int(v) for v in rng.integers(0, 1 << 16, 16)]
        words = [lanes[2 * i] | (lanes[2 * i + 1] << 16) for i in range(8)]
        for r in range(8):
            assert shifted_bf16(words, r) == lanes[r : r + 8]


def ring_walk(t0, t1, n_frames, d, group, stages, rows=ROWS):
    """The ring protocol of one block, stepped in one order: returns the
    ring row of each input row an output row reads, {t: {r: ring row}};
    asserts that the producer never overwrites a stage a consumer still
    reads and that no wait waits forever.  Output rows go in blocks of
    `rows`; after a block, the stages whose last row it read for the last
    time are released."""
    rlo, rhi = max(0, t0 - d), min(n_frames, t1 + d)
    n_stages = -(-(rhi - rlo) // group)
    ring_rows = stages * group
    holds = [None] * ring_rows  # input row in each ring row
    released, loaded, waited = set(), 0, 0
    seen = {}
    for tb in range(t0, t1, rows):
        nr = min(rows, t1 - tb)
        need = (min(tb + nr - 1 + d, rhi - 1) - rlo) // group
        while waited <= need:
            # The producer runs ahead as far as released stages allow.
            while loaded < n_stages and (loaded < stages or loaded - stages in released):
                for i in range(group):
                    r = rlo + loaded * group + i
                    if r < rhi:
                        holds[(loaded % stages) * group + i] = r
                loaded += 1
            assert loaded > waited, f"stage {waited} never arrives (rows {tb}..)"
            waited += 1
        pos0 = (tb - rlo) % ring_rows
        if nr == rows and tb >= d and tb + rows - 1 + d < n_frames:
            # An interior block: each row's ring row steps back one a term
            # from d = -D (two across d = 0), wrapping once at most.
            for i in range(rows):
                pos = (pos0 + i + d) % ring_rows
                for dd in [*range(-d, 0), *range(1, d + 1)]:
                    assert pos == (pos0 + i - dd) % ring_rows
                    pos = (pos - (2 if dd == -1 else 1)) % ring_rows
        for i in range(nr):
            rows_t = {}
            for dd in range(-d, d + 1):
                r = tb + i - dd
                if 0 <= r < n_frames:
                    pos = pos0 + i - dd
                    pos += ring_rows if pos < 0 else (-ring_rows if pos >= ring_rows else 0)
                    assert holds[pos] == r, (tb + i, r, pos, holds[pos])
                    rows_t[r] = pos
            seen[tb + i] = rows_t
        for i in range(nr):
            rr = tb + i - d - rlo
            if rr >= 0 and (rr + 1) % group == 0:
                released.add(rr // group)
    return seen


def test_ring_protocol_holds_for_any_block_of_rows():
    """The ring's size rule holds the rows every block of `rows` output
    rows reads, for any D, stage size, prefetch and strip."""
    for d in (0, 1, 3, 4, 8):
        for rows in (1, 2, 4, 8):
            for g in (1, 2, 4, 8):
                for pf in (0, 1):
                    ns = -(-(2 * d + rows - 1) // g) + 1 + pf
                    for t0, t1 in ((0, 5), (0, 50), (13, 77), (40, 100)):
                        ring_walk(t0, min(t1, 100), 100, d, g, ns, rows)


def kernel_statement(frames, wss2d, plan, hop, slots):
    """What the kernel's blocks compute, block by block, from the host's
    choices (`ring_config`, `strip_count`, `run_table`); `frames` is
    (Bt, T, wp) bf16 or f32."""
    bt, n_frames, wp = frames.shape
    es = frames.element_size()
    V = 16 // es
    d, w_len = plan["d_max"], plan["w_len"]
    group, stages, _ = rp.ring_config(smem_bytes, wp, es, d, ROWS)
    runs = rp.run_table(plan["runs"], torch.device("cpu")).tolist()
    strips = rp.strip_count(bt, n_frames, plan["runs"], slots)
    starts = rp.strip_starts(n_frames, strips)
    out = torch.zeros_like(frames)
    j0 = torch.arange(0, wp, V)  # first lane of each segment
    lanes = torch.arange(wp)
    inside = lanes < w_len
    whole = (j0 + V <= w_len).repeat_interleave(V)  # every lane of the segment inside
    for s in range(strips):
        t0, t1 = starts[s], starts[s + 1]
        ring_pos = ring_walk(t0, t1, n_frames, d, group, stages)
        ring = torch.zeros(bt, stages * group, wp, dtype=frames.dtype)
        for t in range(t0, t1):
            for r, pos in ring_pos[t].items():
                ring[:, pos] = frames[:, r]  # what the stage copies put there
            row = ring[:, ring_pos[t][t]].float()
            acc = torch.where(inside, row, torch.zeros(()))
            for dd in [*range(-d, 0), *range(1, d + 1)]:
                r = t - dd
                if not 0 <= r < n_frames:
                    continue
                src = lanes + dd * hop
                s0 = (j0 + dd * hop).repeat_interleave(V)  # segment's first source lane
                outside = (s0 + V <= 0) | (s0 >= w_len)
                fast = whole & (s0 >= 0) & (s0 + V <= w_len)
                edge = ~outside & ~fast & inside & (src >= 0) & (src < w_len)
                take = fast | edge
                # Fast segments read lanes a .. a + 2V of two aligned loads
                # and keep lanes r .. r + V of them: the lanes src.
                a = s0 & ~(V - 1)
                assert bool(((a + (s0 - a) + lanes % V) == src)[fast].all())
                assert bool((a[fast] >= 0).all()) and bool((a[fast] + V <= wp).all())
                val = ring[:, ring_pos[t][r]].float()[:, src.clamp(0, wp - 1)]
                acc = torch.where(take, acc + val, acc)
            res = torch.where(inside, acc * wss2d[t], torch.zeros(()))
            out[:, t] = res.to(frames.dtype)
        for t, lo, hi, t_src, src_lo, src_hi in runs:
            if t0 <= t < t1:
                assert t0 <= t_src < t1
                out[:, t, lo:hi] = out[:, t_src, src_lo:src_hi].flip(-1)
    return out, strips


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_frames", [800, 515, 37, 5])
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_kernel_statement_is_the_plain_version_bit_for_bit(geom, n_frames, dtype):
    args, plan, wp = geometry(geom, n_frames)
    g = torch.Generator().manual_seed(n_frames)
    frames = torch.randn(2, n_frames, wp, generator=g)
    frames[..., plan["w_len"]:] = torch.randn(2, n_frames, wp - plan["w_len"], generator=g)
    frames = frames.to(DTYPES[dtype])  # lanes beyond w_len hold noise: ignored
    wss2d = rp.padded_wss2d(plan, wp, "cpu")
    want = rp.reproject_frames_plain(frames, *args, wss2d)
    for slots in (528, 7):  # a wave of one H100 at 4 blocks an SM; a small card
        got, strips = kernel_statement(frames, wss2d, plan, args[1], slots)
        assert torch.equal(got, want), (geom, n_frames, dtype, slots)
        if n_frames == 5:
            assert strips == 1  # head and tail runs meet: one strip


def test_strips_fill_one_wave_and_hold_every_run():
    """The default geometry at the split iteration's batch: 16 strips of
    50 rows (512 blocks of the 528 one wave holds); with fewer slots,
    longer strips; never shorter than MIN_STRIP; a run never crosses."""
    _, plan, _ = geometry("22k", 800)
    runs = plan["runs"]
    assert rp.strip_count(32, 800, runs, 528) == 16
    assert rp.strip_count(32, 800, runs, 264) == 8
    assert rp.strip_count(1, 800, runs, 528) == 800 // rp.MIN_STRIP
    assert rp.strip_count(600, 800, runs, 528) == 1  # more utterances than slots
    for strips in range(1, 26):
        if rp.strip_count(1, 800, runs, strips) == strips:
            assert rp.runs_fit(runs, 800, strips)


def test_runs_beyond_a_strip_take_larger_strips(monkeypatch):
    """A geometry whose mirror runs reach far (a 64-sample hop under a
    2048-sample window: sources up to ~17 rows from their targets) and one
    whose head and tail runs meet (5 frames) are not cut where a run would
    cross a strip: the wrapper takes fewer, longer strips, down to one an
    utterance, which holds every run."""
    plan = rp.band_plan(2048, 64, 2048, 200, 199 * 64)
    runs = plan["runs"]
    reach = max(abs(t - t_src) for t, _, _, t_src, _, _ in runs)
    assert reach >= 16
    assert not rp.runs_fit(runs, 200, 12)
    monkeypatch.setattr(rp, "MIN_STRIP", 16)
    strips = rp.strip_count(1, 200, runs, 528)
    assert 1 <= strips < 12 and rp.runs_fit(runs, 200, strips)
    _, plan5, _ = geometry("22k", 5)
    monkeypatch.setattr(rp, "MIN_STRIP", 1)
    assert not rp.runs_fit(plan5["runs"], 5, 2) and rp.strip_count(1, 5, plan5["runs"], 528) == 1


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_ring_takes_every_shape_the_first_kernel_took(elem_bytes):
    """The first design of this kernel staged 16 + 2 D rows of wp lanes in
    one block; every such shape within the card's shared memory has a ring
    here (at worst G = 2 with no prefetch), and the default geometry gets
    the 16 KB stage with a stage of prefetch."""
    for wp in (8, 16, 128, 512, 896, 1152, 2048, 4096, 8192):
        for d in sorted({0, 1, 2, 4, 8, 17, 42, wp // 2, wp - 1}):
            if d >= wp:
                continue
            if (16 + 2 * d) * wp * elem_bytes > build.MAX_SMEM:
                continue
            g, ns, smem = rp.ring_config(smem_bytes, wp, elem_bytes, d, ROWS)
            assert smem <= build.MAX_SMEM and (ns - 1) * g >= 2 * d + ROWS - 1, (wp, d)
    g, ns, _ = rp.ring_config(smem_bytes, 1152, elem_bytes, 4, ROWS)
    assert g * 1152 * elem_bytes >= rp.STAGE_BYTES
    assert (ns - 1 - rp.PREFETCH_STAGES) * g >= 8 + ROWS - 1


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_every_geometry_of_the_gl_kernels_envelope_has_a_configuration(elem_bytes):
    """"split" stays the explicit route beside B2 and B5, so B1 takes every
    geometry they take, in both loop dtypes: window supports up to 2048
    lanes (wp 896 at 16 kHz, 1152 at 22.05 kHz, 1280 at 24 kHz, 2048 at
    44.1 kHz and n_fft 2048) with up to 16 overlapping frames a side.  The
    ring holds all of them but f32 rows of 2048 lanes at D >= 13 (35 rows of
    8 KB at D = 16), which the direct configuration takes; past them (D =
    17 at 2048 lanes, f32 rows of 4096 lanes) the direct one takes what no
    ring holds, up to D = MAX_D = 256, and past that the wrapper refuses."""
    for wp in (896, 1152, 1280, 2048):
        for d in range(17):
            ring = rp.config(smem_bytes, wp, elem_bytes, d, ROWS)
            if elem_bytes == 4 and wp == 2048 and d >= 13:
                assert ring is None, (wp, d)
                continue
            g, ns = ring
            assert (ns - 1) * g >= 2 * d + ROWS - 1, (wp, d)
            assert smem_bytes(wp, elem_bytes, g, ns) <= build.MAX_SMEM
    assert rp.config(smem_bytes, 2048, 4, 17, ROWS) is None
    assert rp.config(smem_bytes, 4096, 4, 8, ROWS) is None
    with pytest.raises(NotImplementedError, match="256 overlapping frames"):
        rp.config(smem_bytes, 2048, elem_bytes, 257, ROWS)


#: (case, n_fft, hop, window, D, the ring takes bf16, f32) past n_fft 2048
#: and D = 16: 48 kHz and 44.1 kHz at n_fft 4096 and 50 / 12.5 ms (wp 2432,
#: 2304), hops of 2.86 and 1.55 ms at 22.05 kHz (D = 17, 32), the most
#: overlapping frames B2 and B5 take (a 9-sample hop: D = 122) and B1's
#: own bound (a 1102-sample window at n_fft 2048 cannot reach D = 256: a
#: 4096-sample window and a 16-sample hop, D = 255).  None is past MAX_D.
WIDE_GEOMETRIES = [
    ("48kHz", 4096, 600, 2400, 3, True, True),
    ("44kHz4096", 4096, 551, 2205, 3, True, True),
    ("hop2.86ms", 2048, 63, 1102, 17, True, True),
    ("hop1.55ms", 2048, 34, 1102, 32, True, False),
    ("hop9", 2048, 9, 1102, 122, False, False),
    ("D255", 4096, 16, 4096, 255, False, False),
]


@pytest.mark.parametrize("case", WIDE_GEOMETRIES, ids=[c[0] for c in WIDE_GEOMETRIES])
def test_geometries_past_n_fft_2048_and_d_16_have_a_configuration(case):
    """Each geometry in both loop dtypes: the ring where one fits shared
    memory (its stages covering the band), else the direct configuration;
    none refused.  Past MAX_D (a 4-sample hop: D = 275) `config` raises by
    name, before any launch, whichever configuration would take it."""
    _, n_fft, hop, win, d_max, ring_bf16, ring_f32 = case
    plan = rp.band_plan(n_fft, hop, win, 70, 69 * hop)
    assert plan["d_max"] == d_max <= rp.MAX_D
    wp = -(-plan["w_len"] // 128) * 128
    for elem_bytes, ring in ((2, ring_bf16), (4, ring_f32)):
        got = rp.config(smem_bytes, wp, elem_bytes, d_max, ROWS)
        assert (got is not None) == ring, elem_bytes
        if ring:
            g, ns = got
            assert (ns - 1) * g >= 2 * d_max + ROWS - 1
            assert smem_bytes(wp, elem_bytes, g, ns) <= build.MAX_SMEM
    past = rp.band_plan(n_fft, 4, win, 70, 69 * 4)["d_max"]
    assert past > rp.MAX_D
    for elem_bytes in (2, 4):
        with pytest.raises(NotImplementedError, match=f"at most {rp.MAX_D} overlapping"):
            rp.config(smem_bytes, wp, elem_bytes, past, ROWS)


class _RefusingLibrary:
    """A stand-in for the built library: csrc's count of shared memory; it
    launches nothing."""

    def sstts_reproject_smem_bytes(self, *a):
        return smem_bytes(*a)

    def sstts_reproject_rows(self):
        return ROWS

    def sstts_reproject(self, *a):
        raise AssertionError("launched a refused shape")


def test_a_ring_beyond_shared_memory_is_refused_before_launch():
    """No ring holds 32 KB rows: the ring's own reckoning refuses them, and
    the launch takes the direct configuration up to MAX_D; past it the
    wrapper refuses before anything is launched."""
    lib = _RefusingLibrary()
    f3 = torch.zeros(1, 8, 8192, dtype=torch.float32)  # 32 KB rows
    assert rp.config(smem_bytes, 8192, 4, 4, ROWS) is None
    with pytest.raises(NotImplementedError, match="exceeds 232448 bytes"):
        rp.ring_config(smem_bytes, 8192, 4, 4, ROWS)
    with pytest.raises(NotImplementedError, match=f"at most {rp.MAX_D} overlapping"):
        rp.launch(lib, f3, torch.zeros(8, 8192), 8100, 30, rp.MAX_D + 1, ())
    with pytest.raises(NotImplementedError, match="exceeds"):
        rp.ring_config(smem_bytes, 2048, 4, 40, ROWS)


def test_run_table_is_the_plans_runs():
    _, plan, _ = geometry("22k", 37)
    table = rp.run_table(plan["runs"], torch.device("cpu"))
    assert table.dtype == torch.int32 and table.shape == (len(plan["runs"]), 6)
    assert [tuple(r) for r in table.tolist()] == list(plan["runs"])
    assert rp.run_table(plan["runs"], torch.device("cpu")) is table  # made once
    # Within one run a row is never its own source's lanes: the kernel
    # copies a run without a barrier inside it.
    for name in GEOMETRIES:
        for n in (5, 37, 800):
            for t, a, b, t_src, lo, hi in geometry(name, n)[1]["runs"]:
                assert t != t_src or b <= lo or hi <= a


def test_host_mirrors_match_reproject_cu():
    """`_ReprojectArgs` has the C struct's fields in its order, and the
    count of shared memory the tests use is the library's."""
    src = (build.CSRC / "reproject.cu").read_text()
    body = re.search(r"struct ReprojectArgs \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.split(";")[:-1]:
        decl = re.sub(r"//[^\n]*", "", line).strip()
        names = decl.split(None, 1)[1] if decl.startswith("int ") else decl
        fields += [re.sub(r"^.*[\s*]", "", n.strip()) for n in names.split(",")]
    assert fields == [f for f, _ in rp._ReprojectArgs._fields_]
    assert "return 16 * stages + stages * group * wp * elem_bytes + 16;" in src
