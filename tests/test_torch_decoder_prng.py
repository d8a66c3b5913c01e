"""The prenet dropout of kernel B4 and its plain versions: `keep_bits`
(Philox4x32-10 of (seed + t, global row, layer, unit)), the reference's
uint32 keep rule, and the decodes and the Synthesizer that draw from them.

The reference kernel draws its bits from the TPU core's PRNG, seeded with
`seed + t` each step (`sstts/ops/pallas_decoder.py:156-166, 231-239`); no
other device reproduces that stream, so what is held here is the function
and its contract: bits that a numpy copy of the generator gives bit for
bit, a keep share and a lack of correlation that a fair coin gives, the
reference's threshold and edge rates, and shards that draw the global
batch's rows.  No JAX here; torch on one thread.
"""

import re

import numpy as np
import pytest
import torch

from sstts_torch.config import tiny_config
from sstts_torch.model.tacotron import Tacotron, init_state_dict
from sstts_torch.ops import build
from sstts_torch.ops import decoder as dec
from sstts_torch.synthesize import Synthesizer

torch.set_num_threads(1)

U32 = np.uint64(0xFFFFFFFF)


def philox_numpy(c, k):
    """Philox4x32-10 in numpy uint64: each 32 x 32 product whole (it fits
    in 64 bits), then split into its words."""
    c = [np.asarray(x, np.uint64) for x in c]
    k0, k1 = (np.asarray(x, np.uint64) for x in k)
    for i in range(10):
        if i:
            k0, k1 = (k0 + np.uint64(0x9E3779B9)) & U32, (k1 + np.uint64(0xBB67AE85)) & U32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & U32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & U32]
    return c


def bits_numpy(seed, steps, row0, rows, layer, units):
    t = np.arange(steps, dtype=np.int64)[:, None, None]
    key = ((seed + t) & 0xFFFFFFFF).astype(np.uint64)
    row = (row0 + np.arange(rows, dtype=np.uint64))[None, :, None]
    unit = np.arange(units, dtype=np.uint64)[None, None, :]
    return philox_numpy((unit, row, np.uint64(layer), np.uint64(0)), (key, np.uint64(0)))[0]


# Random123's known-answer vectors for Philox4x32-10 (kat_vectors).
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    counter, key, want = KAT[case]
    got = dec.philox4x32(counter, key)
    assert tuple(int(w) for w in got) == want
    assert tuple(int(w) for w in philox_numpy(counter, key)) == want


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 3, 2**31 - 1, -5])
def test_keep_bits_equal_a_numpy_copy(seed):
    """Over steps, rows from a shard's first row, both layers and a few
    units; seeds whose seed + t crosses 2^31 (the int32 wrap) and a
    negative one (an int32 bit pattern)."""
    for layer, row0 in ((0, 0), (1, 5)):
        got = dec.keep_bits(seed, 6, row0, 3, layer, 40)
        assert got.dtype == torch.int64 and int(got.min()) >= 0 and int(got.max()) < 2**32
        np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                      bits_numpy(seed, 6, row0, 3, layer, 40))


def test_seed_plus_t_wraps_as_int32():
    """Step t of seed s draws from the key s + t, wrapped to 32 bits: the
    last steps of a seed just below 2^31 are the first of the seed
    -2^31 (its int32 neighbour), and step 1 of seed s is step 0 of s + 1."""
    a = dec.keep_bits(2**31 - 2, 4, 0, 2, 0, 16)
    b = dec.keep_bits(-(2**31), 2, 0, 2, 0, 16)
    assert torch.equal(a[2:], b)
    assert torch.equal(dec.keep_bits(7, 2, 0, 2, 1, 16)[1], dec.keep_bits(8, 1, 0, 2, 1, 16)[0])


def test_keep_share_at_half_is_binomial():
    """At rate 0.5 the kept share over 160 x 32 x 384 units lies within 5
    sigma of its binomial mean."""
    keep = dec.keep_masks(2024, 0, 160, 32, (256, 128), 0.5)
    n = sum(k.numel() for k in keep)
    kept = sum(float(k.sum()) for k in keep)
    sigma = (n * 0.25) ** 0.5
    assert abs(kept - 0.5 * n) < 5 * sigma
    quarter = dec.keep_masks(2024, 0, 20, 32, (256,), 0.25)[0]
    sigma = (quarter.numel() * 0.25 * 0.75) ** 0.5
    assert abs(float(quarter.sum()) - 0.75 * quarter.numel()) < 5 * sigma


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.1, 0.25, 0.5, 0.75, 0.999999, 1.0, 1.5, -0.2])
def test_threshold_is_the_references(rate):
    """`np.uint32(min(rate 2^32, 2^32 - 1))` of the rate clamped to [0, 1]
    (`sstts/ops/pallas_decoder.py:158-164`)."""
    r = min(max(rate, 0.0), 1.0)
    assert dec.keep_threshold(rate) == int(np.uint32(min(r * 4294967296.0, 4294967295.0)))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, 0))
    model.eval()
    g = torch.Generator().manual_seed(0)
    memory = torch.randn(3, 11, 2 * cfg.arch.encoder_gru_units, generator=g)
    mask = torch.arange(11)[None] < torch.tensor([11, 7, 9])[:, None]
    return cfg, model, memory, mask


def _decode(model, memory, mask, seed, rate=None):
    cell = model.decoder_cell
    saved = cell.prenet.dropout
    if rate is not None:
        cell.prenet.dropout = rate
    try:
        with torch.no_grad():
            return dec.fused_decode(cell, memory, mask, 6, stop_threshold=1.1, min_steps=2,
                                    seed=seed, matmul_dtype=torch.float32)
    finally:
        cell.prenet.dropout = saved


def test_edge_rates(tiny):
    """Rate 0 keeps everything (threshold 0, scale 1): a seed changes
    nothing.  Rate >= 1 zeroes the prenet (threshold 2^32 - 1, scale 0),
    whatever the bits: two seeds decode alike, and unlike no dropout."""
    cfg, model, memory, mask = tiny
    assert dec.keep_threshold(0.0) == 0 and dec.dropout_scale(0.0) == 1.0
    assert dec.keep_threshold(1.0) == 2**32 - 1 and dec.dropout_scale(1.0) == 0.0
    off = _decode(model, memory, mask, None)
    assert torch.equal(_decode(model, memory, mask, 9, rate=0.0)["mel"], off["mel"])
    ones = [_decode(model, memory, mask, s, rate=1.0) for s in (1, 2)]
    assert torch.equal(ones[0]["mel"], ones[1]["mel"])
    assert not torch.equal(ones[0]["mel"], off["mel"])
    half = [_decode(model, memory, mask, s, rate=0.5) for s in (1, 2)]
    assert not torch.equal(half[0]["mel"], half[1]["mel"])


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.flatten().double(), b.flatten().double()
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / (a.norm() * b.norm()))


def test_masks_of_steps_rows_layers_and_units_are_uncorrelated():
    """|r| < 0.02 between neighbouring steps, rows, layers and units over
    at least 1e5 draws each (a fair coin's r has sigma 1/sqrt(n) = 3e-3)."""
    S, B, P = 65, 24, 128  # 64 x 24 x 128 = 196,608 pairs a comparison
    k0, k1 = dec.keep_masks(77, 0, S, B, (P, P), 0.5)
    pairs = {
        "steps": (k0[1:], k0[:-1]),
        "rows": (k0[:-1, 1:], k0[:-1, :-1]),
        "layers": (k0[:-1], k1[:-1]),
        "units": (k0[:-1, :, 1:], k0[:-1, :, :-1]),
    }
    for name, (a, b) in pairs.items():
        assert a.numel() >= 10**5, name
        assert abs(_corr(a, b)) < 0.02, (name, _corr(a, b))


def test_a_shards_rows_are_the_global_draws():
    """"gspmd": a shard given its first global row draws those rows of the
    global batch's masks."""
    full = dec.keep_masks(31, 0, 5, 12, (32, 16), 0.5)
    for row0, rows in ((0, 4), (4, 4), (8, 4), (3, 5)):
        part = dec.keep_masks(31, row0, 5, rows, (32, 16), 0.5)
        for f, p in zip(full, part):
            assert torch.equal(p, f[:, row0 : row0 + rows])


def test_plain_decode_and_module_loop_draw_the_same_masks(tiny, monkeypatch):
    """`decode_steps_plain` and `Tacotron.decode_infer` at one seed with
    dropout on build their masks from the same `keep_masks` call, bit for
    bit, and decode alike (the same function through other torch products:
    2e-5, as tests/test_torch_decoder.py holds them)."""
    cfg, model, memory, mask = tiny
    seen = []
    real = dec.keep_masks

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(dec, "keep_masks", spy)
    with torch.no_grad():
        a = _decode(model, memory, mask, 1234)
        b = model.decode_infer(memory, mask, 6, 1.1, 2, 1234)
    assert len(seen) == 2
    for x, y in zip(*seen):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a["n_frames"].numpy(), b["n_frames"].numpy())
    for key in ("mel", "stop_logits", "alignments"):
        np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), atol=2e-5, err_msg=key)
    with torch.no_grad():
        other = model.decode_infer(memory, mask, 6, 1.1, 2, 1235)
    assert float((other["mel"] - b["mel"]).abs().max()) > 1e-3


def test_synthesizer_seed_is_the_noise():
    """A Synthesizer at one seed gives the same audio twice; another seed
    gives other audio (dropout on at inference)."""
    cfg = tiny_config()
    params = init_state_dict(cfg.arch, cfg.dataset, 0)
    texts = ["hello world", "abc"]
    run = lambda seed: Synthesizer(cfg, params, seed=seed, device="cpu").synthesize_batch(  # noqa: E731
        texts)
    a, b, c = run(3), run(3), run(4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(x.shape != z.shape or not np.array_equal(x, z) for x, z in zip(a, c))


def test_kernel_uses_the_same_generator():
    """decoder.cu's Philox constants, its counter and key, and its keep
    rule are the plain version's; no keep-mask pointer is left."""
    src = (build.CSRC / "decoder.cu").read_text()
    for const in (*dec._PHILOX_M, *dec._PHILOX_W):
        assert f"0x{const:08X}u" in src
    assert "uint32_t c0 = unit, c1 = row, c2 = layer, c3 = 0u, k0 = key, k1 = 0u;" in src
    assert "const uint32_t key = p.seed + (uint32_t)t, row = (uint32_t)(p.row0 + b);" in src
    assert ">= p.threshold ? 1.f : 0.f" in src
    assert not re.search(r"\bkeep[01]\b", src)
