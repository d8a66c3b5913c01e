"""The port's wire codecs held to the JAX package's: the device encoders
byte for byte, the host decoders bit for bit against JAX's numpy decoders
and, against its native C++ decoder, within the 1e-6 that the JAX package
holds that decoder to its numpy one (`tests/test_native.py:104`: the
native running sum rounds in another order, 8317 of 16000 samples differ
in the last bit); and each side's wire through the other side's decoder.

The ADPCM encoders give JAX's bytes exactly: the port writes out what XLA
does on the CPU (a fused multiply-add in the feedback loop, true divisions
by the constants; `sstts_torch/dsp/ops.py`).  mu-law: the port takes log1p
in f64 (so the card and the CPU agree), XLA its own f32 log1p, which is not
always correctly rounded; a code can then differ by one where the companded
value lies within an f32 rounding of a half-step boundary.  Measured: 1 of
1,600,000 samples of a speech-like mix, 3 of 20,000,000 normal samples.
The test audio below gives equal bytes; `test_mulaw_codes_differ_only_at_
rounding_boundaries` states the general rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sstts.data import native_loader
from sstts.dsp import ops as jops
from sstts_torch.dsp import ops

N = 8000

ENCODERS = {
    "mulaw8": (jops.mulaw_encode_u8, ops.mulaw_encode_u8),
    "adpcm4": (jops.adpcm4_encode_wire, ops.adpcm4_encode_wire),
    "adpcm3": (jops.adpcm3_encode_wire, ops.adpcm3_encode_wire),
    "adpcm2": (jops.adpcm2_encode_wire, ops.adpcm2_encode_wire),
    "adpcm2-ns0.6": (
        lambda y: jops.adpcm2_encode_wire(y, ns_beta=0.6),
        lambda y: ops.adpcm2_encode_wire(y, ns_beta=0.6),
    ),
}
BITS = {"adpcm4": 4, "adpcm3": 3, "adpcm2": 2}
PORT_DECODERS = {
    "adpcm4": ops._adpcm4_decode_rows_np,
    "adpcm3": ops._adpcm3_decode_rows_np,
    "adpcm2": ops._adpcm2_decode_rows_np,
}
JAX_DECODERS = {
    "adpcm4": jops._adpcm4_decode_rows_np,
    "adpcm3": jops._adpcm3_decode_rows_np,
    "adpcm2": jops._adpcm2_decode_rows_np,
}
WIRE_BYTES = {
    "adpcm4": (jops.adpcm4_wire_bytes, ops.adpcm4_wire_bytes),
    "adpcm3": (jops.adpcm3_wire_bytes, ops.adpcm3_wire_bytes),
    "adpcm2": (jops.adpcm2_wire_bytes, ops.adpcm2_wire_bytes),
}


@pytest.fixture(scope="module")
def audio():
    """Rows of a harmonic mix with noise at three levels (the block scales
    are f16, so the codecs are level-invariant) plus one row past [-1, 1]
    (clipped), 8000 samples: not a multiple of the 256-sample block."""
    rng = np.random.default_rng(0)
    tt = np.arange(N) / 8000.0
    y = (
        0.5 * np.sin(2 * np.pi * 220 * tt)
        + 0.2 * np.sin(2 * np.pi * 730 * tt)
        + 0.05 * np.sin(2 * np.pi * 2900 * tt)
        + 0.02 * rng.standard_normal(N)
    )
    rows = [np.clip(y, -1, 1) * a for a in (1.0, 0.05, 0.002)] + [1.3 * y]
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("codec", sorted(ENCODERS))
def test_encoder_bytes_equal_jax(audio, codec):
    jenc, penc = ENCODERS[codec]
    for x in (audio, audio[:, :1000]):
        ref = np.asarray(jenc(jnp.asarray(x)))
        got = penc(torch.as_tensor(x)).numpy()
        assert got.dtype == ref.dtype == np.uint8
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_mulaw_codes_differ_only_at_rounding_boundaries():
    """On 2,000,000 normal samples: every code that differs from JAX's
    differs by one, at a sample whose companded value (f64) lies within
    1e-4 of a half-step boundary; and at most 1 in 100,000 differs."""
    y = np.clip(np.random.default_rng(9).normal(0, 0.3, (2, 1_000_000)), -1, 1)
    y = y.astype(np.float32)
    ref = np.asarray(jops.mulaw_encode_u8(jnp.asarray(y))).astype(int)
    got = ops.mulaw_encode_u8(torch.as_tensor(y)).numpy().astype(int)
    diff = got != ref
    assert diff.mean() <= 1e-5
    assert np.all(np.abs(got - ref)[diff] == 1)
    y64 = y.astype(np.float64)
    c = (np.sign(y64) * np.log1p(255.0 * np.abs(y64)) / np.log1p(255.0) + 1.0) * 127.5
    assert np.all(np.abs(c[diff] - np.floor(c[diff]) - 0.5) < 1e-4)


@pytest.mark.parametrize("codec", sorted(BITS))
def test_decoders_match_jax_numpy_and_native(audio, codec):
    wire = np.asarray(ENCODERS[codec][0](jnp.asarray(audio)))
    got = PORT_DECODERS[codec](wire)
    np.testing.assert_array_equal(got, JAX_DECODERS[codec](wire))
    assert native_loader.available(), "g++ toolchain expected in this image"
    native = native_loader.adpcm_decode_rows(wire, BITS[codec])
    np.testing.assert_allclose(got, native, rtol=0, atol=1e-6)


def test_mulaw_decoder_bit_equal_jax():
    codes = np.arange(256, dtype=np.uint8).reshape(4, 64)
    np.testing.assert_array_equal(ops.mulaw_decode_host(codes), jops.mulaw_decode_host(codes))


@pytest.mark.parametrize("codec", ["mulaw8", "adpcm4", "adpcm3", "adpcm2"])
def test_cross_decode(audio, codec):
    """The port's wire through JAX's host decoder, JAX's wire through the
    port's: the same audio, within the codec's SNR of the input."""
    jenc, penc = ENCODERS[codec]
    port_wire = penc(torch.as_tensor(audio)).numpy()
    jax_wire = np.asarray(jenc(jnp.asarray(audio)))
    if codec == "mulaw8":
        a, b = jops.mulaw_decode_host(port_wire), ops.decode_wire_rows(jax_wire, codec)
    else:  # JAX's public decoder runs the native one here
        a = getattr(jops, f"{codec}_decode_host_rows")(port_wire)[:, :N]
        b = ops.decode_wire_rows(jax_wire, codec)[:, :N]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    x = np.clip(audio[0], -1, 1)
    snr = 10 * np.log10(np.mean(x**2) / np.mean((b[0] - x) ** 2))
    assert snr > {"mulaw8": 32.0, "adpcm4": 27.0, "adpcm3": 21.0, "adpcm2": 14.0}[codec]


def test_wire_bytes_match_jax():
    for n in (1, 255, 256, 257, 8000, 219725):
        for codec, (jfn, pfn) in WIRE_BYTES.items():
            assert pfn(n) == jfn(n), (codec, n)
    for codec in BITS:
        wire = ENCODERS[codec][1](torch.zeros(1, 1000))
        assert wire.shape == (1, WIRE_BYTES[codec][1](1000))


def test_adpcm2_noise_shaping_decodes_with_the_same_decoder(audio):
    """`ns_beta` changes the codes, not the layout: the shaped wire decodes
    with the unshaped decoder, within a few dB of the unshaped SNR."""
    x = np.clip(audio[:1], -1, 1)
    snrs = []
    for beta in (0.0, 0.6):
        wire = ops.adpcm2_encode_wire(torch.as_tensor(x), ns_beta=beta).numpy()
        back = ops.adpcm2_decode_host(wire[0], N)
        snrs.append(10 * np.log10(np.mean(x**2) / np.mean((back - x[0]) ** 2)))
    assert snrs[1] > snrs[0] - 4.0
