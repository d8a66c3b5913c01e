"""The weight stream of the two ring kernels, on the CPU: kernel B4 (the
autoregressive decode, sstts_torch/ops/decoder.py) and kernel B6 (the
teacher-forced scan, sstts_torch/ops/teacher.py), which share the host's
packing and schedule and the device's ring and step chain.  How
`pack_weights` packs a cell's matrices (B4's twelve, B6's eight), how
`chunk_schedule` cuts a step into the chunks the kernel's producer copies
into its ring, in each kernel's step order, and what the wrappers refuse.
The kernels run only on the card (`chip_smoke.py` holds them to their plain
versions and takes them to their longest T); these tests hold the host side
they run on, at the tiny config's widths and the default Config()'s, in
bf16 and f32.
"""

import re
from typing import NamedTuple

import pytest
import torch

from sstts_torch.config import Config, tiny_config
from sstts_torch.model.tacotron import Tacotron, init_state_dict
from sstts_torch.ops import build
from sstts_torch.ops import decoder as dec
from sstts_torch.ops import teacher as tops

CONFIGS = {"tiny": tiny_config, "default": Config}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
KERNELS = ("decode", "teacher")
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


class Case(NamedTuple):
    """One kernel's host side for one cell, as its wrapper makes it on the
    card: the step's products, their schedule, the packed matrices, the
    matrices' and the step's orders, the matrices in the matmul dtype, and
    keys and memory as the kernel reads them."""

    products: tuple
    schedule: torch.Tensor
    packed: torch.Tensor
    matrices: tuple
    order: tuple
    weights: dict
    keys: torch.Tensor
    memory: torch.Tensor


def teacher_inputs(name, dtype, T, B=2, S=3, widen=None):
    """B6's arguments: the cell's live weights (f32), prenet rows, memory
    and keys; `widen` makes the query (and so keys) that many columns."""
    cfg, cell = cell_of(name)
    g = torch.Generator().manual_seed(T)
    w = tops.teacher_weights_from_cell(cell)
    Dm = 2 * cfg.arch.encoder_gru_units
    memory = torch.randn(B, T, Dm, generator=g)
    with torch.no_grad():
        keys = cell.attention.init_keys(memory)
    if widen:
        w = w._replace(query_w=torch.zeros(w.query_w.shape[0], widen),
                       score_v=torch.zeros(widen), score_b=torch.zeros(widen))
        keys = torch.zeros(B, T, widen)
    pre = torch.zeros(B, S, w.attn_wx.shape[0] - Dm)
    return w, pre, memory, keys, torch.ones(B, T)


def case(kernel, name, dtype, T, B=2, S=3):
    if kernel == "decode":
        p = inputs(name, dtype, T, B, S)
        # On the CPU nothing is packed: the plain version reads the matrices.
        assert p.packed is None and p.schedule is None
        products = dec.step_products(dec.weight_layout(p.w), T, p.keys.shape[-1],
                                     p.memory.shape[-1], p.w.attn_wx.element_size(),
                                     dec.STEP_ORDER, B)
        return Case(products, dec.chunk_schedule(products), dec.pack_weights(p.w),
                    dec._MATRICES, dec.STEP_ORDER,
                    {n: getattr(p.w, n) for n in dec._MATRICES},
                    dec._rows16(p.keys), dec._rows16(p.memory))
    w, pre, memory, keys, _ = teacher_inputs(name, dtype, T, B, S)
    products = tops.step_products(w, tops.dims(w, pre, memory, keys), dtype)
    with torch.no_grad():
        packed = dec.pack_weights(w, tops.MATRICES, dtype)
    return Case(products, dec.chunk_schedule(products, tops.STAGE_BYTES), packed,
                tops.MATRICES, tops.STEP_ORDER,
                {n: getattr(w, n).detach().to(dtype) for n in tops.MATRICES},
                dec._rows16(keys.to(dtype).contiguous()),
                dec._rows16(memory.to(dtype).contiguous()))


def unpack_weights(packed, layout, dtype):
    """The matrices back out of a packed buffer (the inverse of
    `pack_weights`)."""
    out = {}
    for pr in layout:
        raw = packed[pr.offset : pr.offset + pr.rows * pr.row_bytes]
        out[pr.name] = raw.view(dtype).reshape(pr.rows, -1)[:, : pr.cols]
    return out


def schedule_rows(sched):
    return [dict(zip(dec.CHUNK_FIELDS, row)) for row in sched.tolist()]


@pytest.mark.parametrize("T", [7, 96, 300])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_schedule_covers_each_operand_once_in_step_order(kernel, name, dtype, T):
    c = case(kernel, name, DTYPES[dtype], T)
    products = c.products
    assert [pr.name for pr in products] == list(c.order)
    chunks = schedule_rows(c.schedule)
    stage = dec.STAGE_BYTES
    # Products in step order, each one run of chunks.
    ids = [ch["product"] for ch in chunks]
    assert ids == sorted(ids) and set(ids) == set(range(len(products)))
    for pid, pr in enumerate(products):
        mine = [ch for ch in chunks if ch["product"] == pid]
        assert {ch["src"] for ch in mine} == {pr.src}
        # The bytes of the operand, exactly once, in order, in whole rows.
        offset, k = pr.offset, 0
        for ch in mine:
            assert ch["offset"] == offset and ch["k0"] == k
            assert ch["row_bytes"] == pr.row_bytes and ch["col0"] == pr.col0 == 0
            assert ch["bytes"] == (ch["k1"] - ch["k0"]) * pr.row_bytes
            assert 0 < ch["bytes"] <= stage and ch["bytes"] % 16 == 0
            assert ch["offset"] % 16 == 0
            offset, k = offset + ch["bytes"], ch["k1"]
        assert k == pr.rows and offset == pr.offset + pr.rows * pr.row_bytes
        # No chunk stops short of a stage where the next row would fit.
        assert all(ch["bytes"] + pr.row_bytes > stage for ch in mine[:-1])
    # The packed matrices lie back to back and fill the buffer.
    packed = [pr for pr in products if pr.src == dec.SRC_WEIGHTS]
    assert [pr.name for pr in packed] == list(c.matrices)
    ends = [pr.offset + pr.rows * pr.row_bytes for pr in packed]
    assert [pr.offset for pr in packed] == [0] + ends[:-1]
    assert ends[-1] == c.packed.numel()
    # Keys and memory: T rows of this utterance, rows padded to 16 bytes,
    # as the tensors handed to the kernel are laid out, after the query.
    at = c.order.index("keys")
    assert c.order[at - 1 : at + 2] == ("query_w", "keys", "memory")
    for pr, t in ((products[at], c.keys), (products[at + 1], c.memory)):
        assert (pr.rows, pr.offset) == (T, 0)
        assert t.shape[-1] * t.element_size() == pr.row_bytes
        assert t.data_ptr() % 16 == 0 and t.is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_unpacking_gives_back_the_cells_matrices(kernel, name, dtype):
    c = case(kernel, name, DTYPES[dtype], 7)
    layout = [pr for pr in c.products if pr.src == dec.SRC_WEIGHTS]
    assert c.packed.dtype == torch.uint8 and c.packed.is_contiguous()
    got = unpack_weights(c.packed, layout, DTYPES[dtype])
    for pr in layout:
        want = c.weights[pr.name]
        assert want.dtype == DTYPES[dtype]
        assert torch.equal(got[pr.name], want), pr.name
        # Each row's padding is zeros.
        rows = c.packed[pr.offset : pr.offset + pr.rows * pr.row_bytes]
        pad = rows.reshape(pr.rows, pr.row_bytes)[:, pr.cols * want.element_size():]
        assert not pad.any(), pr.name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_narrow_rows_are_padded_to_16_bytes(kernel, dtype):
    """stop_w's r columns (10 bytes in bf16, 20 in f32 at the default) and
    every row of the tiny config start on a 16-byte boundary."""
    for name in CONFIGS:
        c = case(kernel, name, DTYPES[dtype], 7)
        size = torch.tensor([], dtype=DTYPES[dtype]).element_size()
        for pr in c.products:
            assert pr.row_bytes % 16 == 0 and pr.offset % 16 == 0
            assert pr.row_bytes - pr.cols * size < 16
    assert dec.row_bytes(5, 2) == 16 and dec.row_bytes(5, 4) == 32
    assert dec.row_bytes(256, 2) == 512 and dec.row_bytes(1, 4) == 16


@pytest.mark.parametrize("stage_bytes", [16, 4096, 65536])
@pytest.mark.parametrize("kernel", KERNELS)
def test_schedule_follows_the_stage_size(kernel, stage_bytes):
    products = case(kernel, "tiny", torch.float32, 96).products
    if stage_bytes < max(pr.row_bytes for pr in products):
        with pytest.raises(NotImplementedError, match="ring stage"):
            dec.chunk_schedule(products, stage_bytes)
        return
    chunks = schedule_rows(dec.chunk_schedule(products, stage_bytes))
    assert max(ch["bytes"] for ch in chunks) <= stage_bytes
    assert sum(ch["bytes"] for ch in chunks) == sum(pr.rows * pr.row_bytes for pr in products)


class _Library:
    """A stand-in for a built ring library whose shared-memory count is a
    fixed part and T floats of scores, rounded up to 4; it launches
    nothing.  (decoder.cu's and teacher.cu's own counts and their limits at
    the default widths are taken to the card by chip_smoke.py.)"""

    def __init__(self, fixed):
        self.fixed = fixed

    def smem(self, ref):
        return self.fixed + 16 * (-(-ref._obj.T // 4))

    sstts_decode_smem_bytes = sstts_teacher_smem_bytes = smem

    def sstts_fused_decode(self, *a):
        raise AssertionError("launched a refused shape")

    sstts_fused_teacher_scan = sstts_fused_decode


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_longest_text_the_kernel_takes_and_its_refusal(kernel, dtype):
    """T = 4096 is cut into whole rows of at most a stage; the wrapper asks
    the library for the longest T that fits (`longest_text`), and refuses
    the next by name before anything is launched."""
    dt = DTYPES[dtype]
    c = case(kernel, "default", dt, 4096, B=1, S=1)
    chunks = schedule_rows(c.schedule)
    keys = [ch for ch in chunks if ch["src"] == dec.SRC_KEYS]
    assert keys[-1]["k1"] == 4096 and max(ch["bytes"] for ch in chunks) <= dec.STAGE_BYTES
    lib = _Library(fixed=build.MAX_SMEM - 4 * 15792)
    for t, ok in ((15792, True), (15793, False)):
        if kernel == "decode":
            q = inputs("default", dt, t, B=1, S=1)
            assert dec.longest_text(_Library(build.MAX_SMEM + 4), q) == -1
            q = q._replace(packed=c.packed, schedule=case(kernel, "default", dt, 8).schedule)
            longest = dec.longest_text(lib, q)
            run = lambda: dec.launch(lib, q)  # noqa: E731
        else:
            w, pre, memory, keys_t, maskf = teacher_inputs("default", dt, t, B=1, S=1)
            d = tops.dims(w, pre, memory, keys_t)
            assert tops.longest_text(_Library(build.MAX_SMEM + 4), d) == -1
            longest = tops.longest_text(lib, d)
            run = lambda: tops.launch(lib, w, pre, memory, keys_t, maskf, dt)  # noqa: E731
        assert longest == 15792
        if not ok:
            with pytest.raises(NotImplementedError, match=r"T=15793.*T up to 15792"):
                run()


@pytest.mark.parametrize("cols", [1024, 1025, 2560])
@pytest.mark.parametrize("kernel", KERNELS)
def test_widest_product_the_kernel_takes(kernel, cols):
    """Products of any width are taken (B4: the frame projection, r * M;
    B6: the query, and so the keys): up to 1024 columns as one panel, wider
    as panels of at most 1024 columns, each its own run of chunks over all
    K rows that carries its first column; the keys' rows stay whole (the
    scores read a row a warp).  Nothing on the host refuses the width."""
    if kernel == "decode":
        p = inputs("tiny", torch.bfloat16, 7)
        w = p.w._replace(frame_w=torch.zeros(p.w.frame_w.shape[0], cols, dtype=torch.bfloat16))
        p = p._replace(w=w, n_mels=cols, reduction=1)
        products = dec.step_products(dec.weight_layout(w), 7, p.keys.shape[-1],
                                     p.memory.shape[-1], 2, dec.STEP_ORDER, 2)
        wide, matrix = "frame_w", w.frame_w
    else:
        w, pre, memory, keys, maskf = teacher_inputs("tiny", torch.bfloat16, 7, widen=cols)
        d = tops.dims(w, pre, memory, keys)
        products = tops.step_products(w, d, torch.bfloat16)
        wide, matrix = "query_w", w.query_w
        assert [pr.cols for pr in products if pr.name == "keys"] == [cols]
    panels = [pr for pr in products if pr.name == wide]
    assert [(pr.col0, pr.cols) for pr in panels] == list(dec.panels(cols))
    assert len(panels) == -(-cols // dec.MAX_COLS)
    assert all(pr.rows == matrix.shape[0] for pr in panels)
    chunks = schedule_rows(dec.chunk_schedule(products))
    assert max(ch["bytes"] for ch in chunks) <= dec.STAGE_BYTES
    pid = products.index(panels[0])
    pid = len({pr.name for pr in products[:pid]})
    mine = [ch for ch in chunks if ch["product"] == pid]
    starts = [ch["col0"] for ch in mine if ch["k0"] == 0]
    assert starts == [pr.col0 for pr in panels]
    assert sorted(ch["col0"] for ch in mine) == [ch["col0"] for ch in mine]


def c_struct_fields(src, struct):
    """Field names of `struct` in a C source, in order."""
    body = re.search(rf"struct {struct} \{{(.*?)\}};", src, re.S).group(1)
    fields = []
    for line in body.split(";")[:-1]:
        decl = re.sub(r"//[^\n]*", "", line).strip()
        names = decl.split(None, 1)[1] if decl.startswith(("int ", "float ")) else decl
        fields += [re.sub(r"^.*[\s*]", "", n.strip()) for n in names.split(",")]
    return fields


@pytest.mark.parametrize("kernel", KERNELS)
def test_host_mirrors_match_decoder_cu(kernel):
    """The host's stage size and widest product are the ring's settings,
    defined once in chain.cuh for both kernels (decoder.cu and teacher.cu
    take them from there and define none of their own), its args structure
    has the kernel source's C struct's fields in their order, and the
    schedule's fields are the stream::Chunk's (stream.cuh)."""
    source, struct, args, stage, cols = {
        "decode": ("decoder.cu", "DecodeArgs", dec._DecodeArgs, dec.STAGE_BYTES, dec.MAX_COLS),
        "teacher": ("teacher.cu", "TeacherArgs", tops._TeacherArgs, tops.STAGE_BYTES,
                    tops.MAX_COLS),
    }[kernel]
    chain = (build.CSRC / "chain.cuh").read_text()
    kb = re.search(r"constexpr int kStageBytes = (\d+) \* 1024;", chain).group(1)
    assert stage == 1024 * int(kb)
    assert cols == int(re.search(r"constexpr int kMaxCols = (\d+);", chain).group(1))
    settings = {n: re.search(rf"constexpr int {n} = (\d+);", chain).group(1)
                for n in ("kStages", "kConsumerWarps")}
    assert settings == {"kStages": "2", "kConsumerWarps": "16"}
    src = (build.CSRC / source).read_text()
    assert '#include "chain.cuh"' in src and '#include "stream.cuh"' in src
    assert "using Ring = chain::Ring<kStream>;" in src
    assert not re.search(r"constexpr int k(Stages|StageBytes|ConsumerWarps|MaxCols)\b", src)
    assert c_struct_fields(src, struct) == [f for f, _ in args._fields_]
    chunk = re.search(r"struct alignas\(16\) Chunk \{\s*int ([^;]*);",
                      (build.CSRC / "stream.cuh").read_text()).group(1)
    assert tuple(n.strip() for n in chunk.split(",")) == dec.CHUNK_FIELDS


def test_teacher_step_is_the_decode_steps_chain():
    """B6's step reads the operands of B4's steps 2-4 in B4's order (the
    chain both kernels run, csrc/chain.cuh), and its matrices are the
    teacher weights' matrices."""
    chain = tuple(n for n in dec.STEP_ORDER
                  if n not in ("prenet_w0", "prenet_w1", "frame_w", "stop_w"))
    assert tops.STEP_ORDER == chain
    assert tops.MATRICES == tuple(n for n in chain if n not in ("keys", "memory"))
    assert set(tops.MATRICES) <= set(tops.TeacherWeights._fields)
    assert not (build.CSRC / "cell.cuh").exists()


def test_plain_version_reads_the_unpacked_weights():
    """The plain version gives the same outputs whatever the packed buffer
    holds: it is the kernel's definition, not a reader of its stream."""
    p = inputs("tiny", torch.float32, 7)
    with torch.no_grad():
        want = dec.decode_steps_plain(p)
        c = case("decode", "tiny", torch.float32, 7)
        got = dec.decode_steps_plain(p._replace(packed=torch.zeros_like(c.packed),
                                                schedule=torch.zeros_like(c.schedule)))
    for k in want:
        assert torch.equal(want[k], got[k]), k
