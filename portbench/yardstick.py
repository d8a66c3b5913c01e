"""The benchmark's yardstick: the chip's published peaks, each kernel's
least time from its shapes, and the operations of a whole batch or step.

Frozen here so that a change to the program cannot move the yardstick.
The bounds are the arithmetic behind the "bound ms" column of the port's
kernel table: the larger of the operations over the peak of their operand
type and the bytes over the HBM rate, inputs read once and outputs written
once.  At the table's shapes they give B2 0.1167, B3 0.0751, B3' 0.0303,
B4 0.0174 and B6 0.0103 ms (`tests/test_portbench_yardstick.py`).

Shapes come from the configuration (`Config` as a plain dict tree, as the
configuration file holds it) and from the traffic's batch or step; nothing
here imports the program.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

#: Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
#: bytes/s of HBM3 and operations/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def bound_ms(n_bytes: float, n_ops: float, op_type: str) -> Tuple[float, str]:
    """(least time in ms, "operations" or "bytes")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[op_type] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------ geometry --


def win_len(ds: Mapping) -> int:
    return int(ds["sample_rate"] * ds["win_len_ms"] / 1000.0)


def hop_len(ds: Mapping) -> int:
    return int(ds["sample_rate"] * ds["win_hop_ms"] / 1000.0)


def support(n_fft: int, wl: int) -> Tuple[int, int]:
    """(first lane, lanes) of the periodic Hann window of `wl` samples
    centred in n_fft: its first sample is zero, so the support is wl - 1
    lanes from (n_fft - wl) // 2 + 1."""
    return (n_fft - wl) // 2 + 1, wl - 1


def gl_lanes(n_fft: int, loop_bf16: bool = True) -> int:
    """hp, the spectrum's lanes a half (real or imaginary) in the
    Griffin-Lim loop's flat layout: the bins, less one where the bf16 loop
    packs the Nyquist bin into DC's imaginary slot, rounded up to 128."""
    half = n_fft // 2 + 1
    packed = loop_bf16 and n_fft % 2 == 0 and half % 2 == 1 and half > 2
    hb = half - 1 if packed else half
    return -(-hb // 128) * 128


# -------------------------------------------------------------- kernels --


def b2_bound(rows_b: int, n_frames: int, w_len: int, hp: int) -> Tuple[float, str]:
    """B2 (reprojection, analysis GEMM, renorm) on Bt x T frames, bf16."""
    rows = rows_b * n_frames
    n_bytes = (rows * w_len * 2 + rows * 2 * hp * 2 + w_len * 2 * hp * 2
               + n_frames * w_len * 4 + rows * 2 * hp * 2)
    return bound_ms(n_bytes, 2 * rows * w_len * 2 * hp, "bf16")


def b3_bound(B: int, T: int, D: int, H: int) -> Tuple[float, str]:
    """B3, a GRU sequence forward (input projection and recurrence), f32."""
    n_bytes = 4 * (B * T * D + D * 3 * H + H * 3 * H + 3 * H + B * T + B * T * H)
    return bound_ms(n_bytes, 2 * B * T * (D * 3 * H + H * 3 * H), "f32")


def b3_backward_bound(B: int, T: int, H: int) -> Tuple[float, str]:
    """B3', the recurrence of a GRU sequence's gradient, f32."""
    n_bytes = 4 * (B * T * H + B * T * 4 * H + B * T * H + H * 3 * H + B * T
                   + 2 * B * T * 3 * H)
    return bound_ms(n_bytes, 2 * B * T * 3 * H * H, "f32")


def decoder_matrices(arch: Mapping, n_mels: int) -> Dict[str, Tuple[int, int]]:
    """The decoder cell's matrices (in, out), Bahdanau attention and two
    decoder GRUs, as B4 streams them."""
    p0, p1 = arch["prenet_units"]
    ha, hd, a = arch["attention_gru_units"], arch["decoder_gru_units"], arch["attention_units"]
    dm = 2 * arch["encoder_gru_units"]
    r = arch["reduction_factor"]
    return {
        "prenet_w0": (n_mels, p0), "prenet_w1": (p0, p1),
        "attn_wx": (p1 + dm, 3 * ha), "attn_wh": (ha, 3 * ha), "query_w": (ha, a),
        "dec_w": (ha + dm, hd),
        "gru0_wx": (hd, 3 * hd), "gru0_wh": (hd, 3 * hd),
        "gru1_wx": (hd, 3 * hd), "gru1_wh": (hd, 3 * hd),
        "frame_w": (hd, r * n_mels), "stop_w": (hd, r),
    }


_SCAN_MATRICES = ("attn_wx", "attn_wh", "query_w", "dec_w",
                  "gru0_wx", "gru0_wh", "gru1_wx", "gru1_wh")


def _macs(mats: Dict[str, Tuple[int, int]], names) -> int:
    return sum(mats[n][0] * mats[n][1] for n in names)


def _vector_bytes(mats: Dict[str, Tuple[int, int]], names, a: int) -> int:
    """f32 biases of the products (the query projection has none) and the
    score vector and bias."""
    return 4 * (sum(mats[n][1] for n in names if not n.endswith("_wh") and n != "query_w")
                + 2 * a)


def b4_bound(arch: Mapping, n_mels: int, B: int, T: int, S: int) -> Tuple[float, str]:
    """B4, the whole autoregressive decode of S steps, bf16 products."""
    mats = decoder_matrices(arch, n_mels)
    a, dm, r = arch["attention_units"], 2 * arch["encoder_gru_units"], arch["reduction_factor"]
    macs = _macs(mats, mats) + T * (a + dm)
    n_bytes = (2 * _macs(mats, mats) + _vector_bytes(mats, mats, a)
               + 2 * B * T * (dm + a) + 4 * B * T + 4 * B * S * (r * n_mels + r + T + 1))
    return bound_ms(n_bytes, 2 * S * B * macs, "bf16")


def b6_bound(arch: Mapping, n_mels: int, B: int, T: int, S: int) -> Tuple[float, str]:
    """B6, the teacher-forced scan's forward of S steps, bf16 products."""
    mats = decoder_matrices(arch, n_mels)
    a, dm, p1 = arch["attention_units"], 2 * arch["encoder_gru_units"], arch["prenet_units"][1]
    hd = arch["decoder_gru_units"]
    macs = _macs(mats, _SCAN_MATRICES) + T * (a + dm)
    n_bytes = (2 * _macs(mats, _SCAN_MATRICES) + _vector_bytes(mats, _SCAN_MATRICES, a)
               + 4 * B * S * p1 + 2 * B * T * (dm + a) + 4 * B * T + 4 * B * S * (hd + T))
    return bound_ms(n_bytes, 2 * S * B * macs, "bf16")


# ----------------------------------------------------- whole-batch work --


def _cbhg_ops(B: int, T: int, d_in: int, bank_k: int, bank_c: int, proj: Tuple[int, int],
              highway_layers: int, highway_units: int, gru_units: int) -> float:
    """Multiply-adds x 2 of one CBHG over B x T positions."""
    bank = sum(2 * d_in * bank_c * k for k in range(1, bank_k + 1))
    proj1 = 2 * 3 * bank_k * bank_c * proj[0]
    proj2 = 2 * 3 * proj[0] * proj[1]
    hw_in = 2 * proj[1] * highway_units if proj[1] != highway_units else 0
    highway = highway_layers * 2 * 2 * highway_units * highway_units
    gru = 2 * 2 * 3 * gru_units * (highway_units + gru_units)
    return float(B * T * (bank + proj1 + proj2 + hw_in + highway + gru))


def encoder_ops(arch: Mapping, B: int, T: int) -> float:
    """Pre-net, CBHG and the attention's key projection over B x T ids."""
    e, (p0, p1) = arch["embedding_dim"], arch["prenet_units"]
    prenet = 2 * B * T * (e * p0 + p0 * p1)
    cbhg = _cbhg_ops(B, T, p1, arch["encoder_bank_k"], arch["encoder_bank_channels"],
                     tuple(arch["encoder_proj_channels"]), arch["encoder_highway_layers"],
                     arch["encoder_highway_units"], arch["encoder_gru_units"])
    keys = 2 * B * T * 2 * arch["encoder_gru_units"] * arch["attention_units"]
    return float(prenet + cbhg + keys)


def decoder_step_macs(arch: Mapping, n_mels: int, T: int, scan_only: bool = False) -> int:
    mats = decoder_matrices(arch, n_mels)
    names = _SCAN_MATRICES if scan_only else mats
    return _macs(mats, names) + T * (arch["attention_units"] + 2 * arch["encoder_gru_units"])


def postnet_ops(arch: Mapping, n_mels: int, n_linear: int, B: int, F: int) -> float:
    """Post-CBHG and the linear projection over B x F frames."""
    cbhg = _cbhg_ops(B, F, n_mels, arch["post_bank_k"], arch["post_bank_channels"],
                     (arch["post_proj_channels"][0], n_mels), arch["post_highway_layers"],
                     arch["post_highway_units"], arch["post_gru_units"])
    return float(cbhg + 2 * B * F * 2 * arch["post_gru_units"] * n_linear)


def gl_ops(ds: Mapping, B: int, n_frames: int, iters: int) -> Dict[str, float]:
    """The Griffin-Lim loop's DFT products: per iteration the synthesis and
    the analysis GEMM over the window's support (bf16), then the final f32
    synthesis over every bin."""
    n_fft = ds["n_fft"]
    _, w_len = support(n_fft, win_len(ds))
    rows = B * n_frames
    hp = gl_lanes(n_fft)
    return {"bf16": float(iters * 2 * (2 * rows * w_len * 2 * hp)),
            "f32": float(2 * rows * 2 * (n_fft // 2 + 1) * w_len)}


def synth_batch_seconds(cfg: Mapping, B: int, T: int, S: int) -> float:
    """The least device time of one synthesis batch: each part's operations
    over the peak of its stated precision (the model f32, the decode's and
    the Griffin-Lim loop's products bf16, the final synthesis f32)."""
    a, ds, inf = cfg["arch"], cfg["dataset"], cfg["inference"]
    n_mels, n_linear = ds["n_mels"], ds["n_fft"] // 2 + 1
    F = S * a["reduction_factor"]
    f32 = encoder_ops(a, B, T) + postnet_ops(a, n_mels, n_linear, B, F)
    bf16 = 2.0 * B * S * decoder_step_macs(a, n_mels, T)
    gl = gl_ops(ds, B, F, inf["griffin_lim_iters"])
    return (f32 + gl["f32"]) / PEAK_OPS["f32"] + (bf16 + gl["bf16"]) / PEAK_OPS["bf16"]


def train_step_seconds(cfg: Mapping, B: int, T: int, F: int) -> float:
    """The least device time of one train step: the teacher-forced forward
    (the scan's products bf16, the rest f32) and a backward of twice the
    forward's operations in f32 (the scan's gradient recomputes it in f32)."""
    a, ds = cfg["arch"], cfg["dataset"]
    n_mels, n_linear = ds["n_mels"], ds["n_fft"] // 2 + 1
    r = a["reduction_factor"]
    S = F // r
    p0, p1 = a["prenet_units"]
    dec_prenet = 2.0 * B * S * (n_mels * p0 + p0 * p1)
    proj = 2.0 * B * S * a["decoder_gru_units"] * r * (n_mels + 1)
    f32 = encoder_ops(a, B, T) + postnet_ops(a, n_mels, n_linear, B, F) + dec_prenet + proj
    scan = 2.0 * B * S * decoder_step_macs(a, n_mels, T, scan_only=True)
    return f32 / PEAK_OPS["f32"] + scan / PEAK_OPS["bf16"] + 2.0 * (f32 + scan) / PEAK_OPS["f32"]
