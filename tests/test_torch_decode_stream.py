"""Kernel B4's weight stream, on the CPU: how `pack_weights` packs the
decoder cell, how `chunk_schedule` cuts a step into the chunks the kernel's
producer copies into its ring, and what the wrapper refuses
(sstts_torch/ops/decoder.py).  The kernel itself runs only on the card
(`chip_smoke.py` holds it to its plain version and takes it to its longest
T); these tests hold the host side it runs on, at the tiny config's widths
and the default Config()'s, in bf16 and f32.
"""

import re

import pytest
import torch

from sstts_torch.config import Config, tiny_config
from sstts_torch.model.tacotron import Tacotron, init_state_dict
from sstts_torch.ops import build
from sstts_torch.ops import decoder as dec

CONFIGS = {"tiny": tiny_config, "default": Config}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
_cells = {}


def cell_of(name):
    if name not in _cells:
        cfg = CONFIGS[name]()
        model = Tacotron(cfg.arch, cfg.dataset)
        model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=1))
        _cells[name] = (cfg, model.decoder_cell.eval())
    return _cells[name]


def inputs(name, dtype, T, B=2, S=3):
    cfg, cell = cell_of(name)
    g = torch.Generator().manual_seed(T)
    memory = torch.randn(B, T, 2 * cfg.arch.encoder_gru_units, generator=g)
    mask = torch.ones(B, T, dtype=torch.bool)
    with torch.no_grad():
        return dec.prepare_decode(cell, memory, mask, S, matmul_dtype=dtype)


def unpack_weights(packed, layout, dtype):
    """The matrices back out of a packed buffer (the inverse of
    `pack_weights`)."""
    out = {}
    for pr in layout:
        raw = packed[pr.offset : pr.offset + pr.rows * pr.row_bytes]
        out[pr.name] = raw.view(dtype).reshape(pr.rows, -1)[:, : pr.cols]
    return out


def plan(p):
    """What `prepare_decode` makes on the card: the step's products, their
    schedule and the packed matrices (here on the CPU)."""
    products = dec.step_products(dec.weight_layout(p.w), p.memory.shape[1],
                                 p.keys.shape[-1], p.memory.shape[-1],
                                 p.w.attn_wx.element_size())
    return products, dec.chunk_schedule(products), dec.pack_weights(p.w)


def schedule_rows(sched):
    return [dict(zip(dec.CHUNK_FIELDS, row)) for row in sched.tolist()]


@pytest.mark.parametrize("T", [7, 96, 300])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CONFIGS)
def test_schedule_covers_each_operand_once_in_step_order(name, dtype, T):
    p = inputs(name, DTYPES[dtype], T)
    # On the CPU nothing is packed: the plain version reads the matrices.
    assert p.packed is None and p.schedule is None
    products, sched, packed_buf = plan(p)
    keys, memory = dec._rows16(p.keys), dec._rows16(p.memory)
    assert [pr.name for pr in products] == list(dec.STEP_ORDER)
    chunks = schedule_rows(sched)
    stage = dec.STAGE_BYTES
    # Products in step order, each one run of chunks.
    ids = [c["product"] for c in chunks]
    assert ids == sorted(ids) and set(ids) == set(range(len(products)))
    for pid, pr in enumerate(products):
        mine = [c for c in chunks if c["product"] == pid]
        assert {c["src"] for c in mine} == {pr.src}
        # The bytes of the operand, exactly once, in order, in whole rows.
        offset, k = pr.offset, 0
        for c in mine:
            assert c["offset"] == offset and c["k0"] == k
            assert c["row_bytes"] == pr.row_bytes and c["pad"] == 0
            assert c["bytes"] == (c["k1"] - c["k0"]) * pr.row_bytes
            assert 0 < c["bytes"] <= stage and c["bytes"] % 16 == 0
            assert c["offset"] % 16 == 0
            offset, k = offset + c["bytes"], c["k1"]
        assert k == pr.rows and offset == pr.offset + pr.rows * pr.row_bytes
        # No chunk stops short of a stage where the next row would fit.
        assert all(c["bytes"] + pr.row_bytes > stage for c in mine[:-1])
    # The twelve packed matrices lie back to back and fill the buffer.
    packed = [pr for pr in products if pr.src == dec.SRC_WEIGHTS]
    assert [pr.name for pr in packed] == list(dec._MATRICES)
    ends = [pr.offset + pr.rows * pr.row_bytes for pr in packed]
    assert [pr.offset for pr in packed] == [0] + ends[:-1]
    assert ends[-1] == packed_buf.numel()
    # Keys and memory: T rows of this utterance, rows padded to 16 bytes,
    # as the tensors handed to the kernel are laid out.
    for pr, t in ((products[5], keys), (products[6], memory)):
        assert (pr.rows, pr.offset) == (T, 0)
        assert t.shape[-1] * t.element_size() == pr.row_bytes
        assert t.data_ptr() % 16 == 0 and t.is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CONFIGS)
def test_unpacking_gives_back_the_cells_matrices(name, dtype):
    p = inputs(name, DTYPES[dtype], 7)
    layout = dec.weight_layout(p.w)
    packed = dec.pack_weights(p.w)
    assert packed.dtype == torch.uint8 and packed.is_contiguous()
    got = unpack_weights(packed, layout, DTYPES[dtype])
    for pr in layout:
        want = getattr(p.w, pr.name)
        assert want.dtype == DTYPES[dtype]
        assert torch.equal(got[pr.name], want), pr.name
        # Each row's padding is zeros.
        rows = packed[pr.offset : pr.offset + pr.rows * pr.row_bytes]
        pad = rows.reshape(pr.rows, pr.row_bytes)[:, pr.cols * want.element_size():]
        assert not pad.any(), pr.name


@pytest.mark.parametrize("dtype", DTYPES)
def test_narrow_rows_are_padded_to_16_bytes(dtype):
    """stop_w's r columns (10 bytes in bf16, 20 in f32 at the default) and
    every row of the tiny config start on a 16-byte boundary."""
    for name in CONFIGS:
        layout = dec.weight_layout(inputs(name, DTYPES[dtype], 7).w)
        size = torch.tensor([], dtype=DTYPES[dtype]).element_size()
        for pr in layout:
            assert pr.row_bytes % 16 == 0 and pr.offset % 16 == 0
            assert pr.row_bytes - pr.cols * size < 16
    assert dec.row_bytes(5, 2) == 16 and dec.row_bytes(5, 4) == 32
    assert dec.row_bytes(256, 2) == 512 and dec.row_bytes(1, 4) == 16


@pytest.mark.parametrize("stage_bytes", [16, 4096, 65536])
def test_schedule_follows_the_stage_size(stage_bytes):
    p = inputs("tiny", torch.float32, 96)
    products = dec.step_products(dec.weight_layout(p.w), 96, p.keys.shape[-1],
                                 p.memory.shape[-1], 4)
    if stage_bytes < max(pr.row_bytes for pr in products):
        with pytest.raises(NotImplementedError, match="ring stage"):
            dec.chunk_schedule(products, stage_bytes)
        return
    chunks = schedule_rows(dec.chunk_schedule(products, stage_bytes))
    assert max(c["bytes"] for c in chunks) <= stage_bytes
    assert sum(c["bytes"] for c in chunks) == sum(pr.rows * pr.row_bytes for pr in products)


class _Library:
    """A stand-in for the built library whose shared-memory count is a
    fixed part and T floats of scores, rounded up to 4; it launches
    nothing.  (decoder.cu's own count and its limit at the default widths,
    15,792, are taken to the card by chip_smoke.py.)"""

    def __init__(self, fixed):
        self.fixed = fixed

    def sstts_decode_smem_bytes(self, ref):
        return self.fixed + 16 * (-(-ref._obj.T // 4))

    def sstts_fused_decode(self, *a):
        raise AssertionError("launched a refused shape")


@pytest.mark.parametrize("dtype", DTYPES)
def test_longest_text_the_kernel_takes_and_its_refusal(dtype):
    """T = 4096 is cut into whole rows of at most a stage; the wrapper asks
    the library for the longest T that fits (`longest_text`), and refuses
    the next by name before anything is launched."""
    p = inputs("default", DTYPES[dtype], 4096, B=1, S=1)
    products, sched, packed = plan(p)
    chunks = schedule_rows(sched)
    keys = [c for c in chunks if c["src"] == dec.SRC_KEYS]
    assert keys[-1]["k1"] == 4096 and max(c["bytes"] for c in chunks) <= dec.STAGE_BYTES
    lib = _Library(fixed=build.MAX_SMEM - 4 * 15792)
    assert dec.longest_text(lib, p) == 15792
    assert dec.longest_text(_Library(build.MAX_SMEM + 4), p) == -1
    for t, ok in ((15792, True), (15793, False)):
        q = inputs("default", DTYPES[dtype], t, B=1, S=1)
        q = q._replace(packed=packed, schedule=plan(q)[1])
        if ok:
            assert dec.longest_text(lib, q) == t
            continue
        with pytest.raises(NotImplementedError, match=r"T=15793.*T up to 15792"):
            dec.launch(lib, q)


@pytest.mark.parametrize("cols,ok", [(1024, True), (1025, False)])
def test_widest_product_the_kernel_takes(cols, ok):
    """Products up to 1024 columns (here the frame projection, r * M) are
    taken; the wrapper refuses a wider one by name before it looks at the
    library."""
    p = inputs("tiny", torch.bfloat16, 7)
    w = p.w._replace(frame_w=torch.zeros(p.w.frame_w.shape[0], cols, dtype=torch.bfloat16))
    p = p._replace(w=w, n_mels=cols, reduction=1)
    if ok:
        dec.check_widths(p)
        assert max(c["bytes"] for c in schedule_rows(plan(p)[1])) <= dec.STAGE_BYTES
    else:
        with pytest.raises(NotImplementedError, match="up to 1024 columns"):
            dec.launch(None, p)


def test_host_mirrors_match_decoder_cu():
    """`STAGE_BYTES` is decoder.cu's stage size, `_DecodeArgs` has the C
    struct's fields in its order, and the schedule's fields are the
    stream::Chunk's (stream.cuh)."""
    src = (build.CSRC / "decoder.cu").read_text()
    kb = re.search(r"constexpr int kStageBytes = (\d+) \* 1024;", src).group(1)
    assert dec.STAGE_BYTES == 1024 * int(kb)
    body = re.search(r"struct DecodeArgs \{(.*?)\};", src, re.S).group(1)
    fields = []
    for line in body.split(";")[:-1]:
        decl = re.sub(r"//[^\n]*", "", line).strip()
        names = decl.split(None, 1)[1] if decl.startswith(("int ", "float ")) else decl
        fields += [re.sub(r"^.*[\s*]", "", n.strip()) for n in names.split(",")]
    assert fields == [f for f, _ in dec._DecodeArgs._fields_]
    chunk = re.search(r"struct alignas\(16\) Chunk \{\s*int ([^;]*);",
                      (build.CSRC / "stream.cuh").read_text()).group(1)
    assert tuple(n.strip() for n in chunk.split(",")) == dec.CHUNK_FIELDS


def test_plain_version_reads_the_unpacked_weights():
    """The plain version gives the same outputs whatever the packed buffer
    holds: it is the kernel's definition, not a reader of its stream."""
    p = inputs("tiny", torch.float32, 7)
    with torch.no_grad():
        want = dec.decode_steps_plain(p)
        packed, sched = dec.pack_weights(p.w), plan(p)[1]
        got = dec.decode_steps_plain(p._replace(packed=torch.zeros_like(packed),
                                                schedule=torch.zeros_like(sched)))
    for k in want:
        assert torch.equal(want[k], got[k]), k
