"""The comparison that decides `correct`: the program's output against
the plain reference's (`portbench/reference/`), each number beside its
limit from `portbench/limits/<cell>.json`.

Synthesis: for each sampled row (a text served in the window, with its
batch's dropout seed and its place in the batch), the reference's audio
as the wire delivers it against the program's:
- `wave_rel`: the largest relative L2 gap of the waveforms;
- `mag_rel`: the largest relative L2 gap of their STFT magnitudes (the
  configuration's n_fft, window and hop);
- `band_db`: the largest RMS, over frames and 80 mel bands, of the dB gap
  of the mel-band energies of those magnitudes (floor 80 dB below the
  row's loudest band): the spectral envelope, which Griffin-Lim's
  rounding-level chaos moves least;
- `ltas_db`: the RMS over the bands of the dB gap of each band's energy
  summed over the row's frames (its long-term spectrum), where the
  rounding-level chaos of the loop averages out and a change of the model
  does not; `ltas_db_lo` the same over the 40 lower bands, above which
  ADPCM4's quantisation noise moves the long-term spectrum.

Training: the first `check_steps` steps of the run's train state against
the reference's steps from the same weights on the same rows:
- `loss_gap`: the largest relative gap of a step's loss;
- `grad_gap`: over the parameters, the largest gap between the norms of
  the first step's clipped gradient (the program's from Adam's first
  moment after one step), over the reference's norm of that parameter or
  the median parameter's, whichever is larger;
- `update_gap`: the same of each parameter's change over the checked
  steps, leaving out parameters whose reference gradient is under a
  thousandth of the median's (they move by round-off alone under Adam).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from portbench.reference import STATED, Precision
from portbench.reference import synthesis as ref_synth


def stft_mag(w: np.ndarray, ds: Mapping) -> torch.Tensor:
    n_fft = ds["n_fft"]
    hop = int(ds["sample_rate"] * ds["win_hop_ms"] / 1000.0)
    wl = int(ds["sample_rate"] * ds["win_len_ms"] / 1000.0)
    y = torch.as_tensor(np.asarray(w, np.float64))
    win = torch.hann_window(wl, periodic=True, dtype=torch.float64)
    return torch.stft(y, n_fft, hop, wl, win, center=True, return_complex=True).abs()


def rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def mel_bands(mag: torch.Tensor, ds: Mapping) -> torch.Tensor:
    """(80, frames) Slaney mel-band sums of an STFT magnitude (bins, frames)
    over 0 Hz to the Nyquist frequency."""
    from portbench.reference.train import mel_filterbank

    fb = mel_filterbank(ds["sample_rate"], ds["n_fft"], 80, 0.0, ds["sample_rate"] / 2.0)
    return torch.as_tensor(fb, dtype=torch.float64) @ mag


def row_gaps(got: Sequence[np.ndarray], ref: Sequence[np.ndarray], ds: Mapping,
             rows: Optional[list] = None) -> Dict[str, float]:
    """The largest gap over the rows of each number; with `rows`, each
    row's gaps are appended to it."""
    out = dict.fromkeys(("wave_rel", "mag_rel", "band_rel", "band_db", "ltas_db",
                         "ltas_db_lo"), 0.0)
    for g, r in zip(got, ref):
        if g.shape != r.shape:
            gaps = dict.fromkeys(out, float("inf"))
        else:
            mg, mr = stft_mag(g, ds), stft_mag(r, ds)
            bg, br = mel_bands(mg, ds), mel_bands(mr, ds)
            floor = 1e-4 * float(br.max())
            db = 20.0 * torch.log10((bg + floor) / (br + floor))
            ltg, ltr = bg.sum(1), br.sum(1)
            lt = 20.0 * torch.log10((ltg + floor) / (ltr + floor))
            gaps = {"wave_rel": rel(g, r),
                    "mag_rel": float((mg - mr).norm() / mr.norm()),
                    "band_rel": float((bg - br).norm() / br.norm()),
                    "band_db": float(db.pow(2).mean().sqrt()),
                    "ltas_db": float(lt.pow(2).mean().sqrt()),
                    "ltas_db_lo": float(lt[:40].pow(2).mean().sqrt())}
        if rows is not None:
            rows.append(gaps)
        out = {k: max(out[k], gaps[k]) for k in out}
    return out


def reference_rows(sd, cfg_tree: Mapping, sample: List[tuple], steps: int, synth_seed: int,
                   P: Precision, device) -> List[np.ndarray]:
    """The reference's host audio of each sampled row
    (key, batch index, row, text, duration, program's waveform)."""
    out = []
    for _, batch, row, text, _, _ in sample:
        seed = ref_synth.dropout_seed(synth_seed, batch)
        out += ref_synth.synthesize_rows(sd, cfg_tree, [text], steps, seed, [row], P, device)
    return out


def held(readings: Mapping[str, float], limits: Mapping) -> Dict[str, tuple]:
    """name -> (reading, limit) of each reading the cell's limits file
    holds, and (reading, None) of the others, which are printed only."""
    lim = limits.get("limits", {})
    return {k: (v, lim.get(k)) for k, v in readings.items()}


def passed(checks: Mapping[str, tuple]) -> bool:
    return all(lim is None or (np.isfinite(v) and v <= lim) for v, lim in checks.values())


def synthesis_checks(sd, cfg_tree: Mapping, sample: List[tuple], steps: int, synth_seed: int,
                     limits: Mapping, device, rows: Optional[list] = None) -> Dict[str, tuple]:
    ref = reference_rows(sd, cfg_tree, sample, steps, synth_seed, STATED, device)
    got = [s[5] for s in sample]
    return held(row_gaps(got, ref, cfg_tree["dataset"], rows), limits)


def train_batches(rows, checked, shape, ds: Mapping):
    """The reference's inputs of each checked step: ((ids, samples,
    frames, loss_frames), valid)."""
    from portbench.reference import train as ref_train

    return [(ref_train.make_rows([rows[int(i)] for i in idx], shape[0], shape[1], ds), valid)
            for idx, valid in checked]


def train_gaps(got: Mapping, ref: Mapping, info: Optional[dict] = None) -> Dict[str, float]:
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["loss"], ref["loss"]))
    names = list(ref["grad1"])
    g_ref = np.array([ref["grad1"][n] for n in names])
    g_med = float(np.median(g_ref))
    grad = max(abs(got["grad1"][n] - ref["grad1"][n]) / max(ref["grad1"][n], g_med)
               for n in names)
    kept = [n for n in names if ref["grad1"][n] >= 1e-3 * g_med]
    if info is not None:
        info.update(leaves=len(names), left_out=sorted(set(names) - set(kept)))
    d_med = float(np.median([ref["delta"][n] for n in kept]))
    update = max(abs(got["delta"][n] - ref["delta"][n]) / max(ref["delta"][n], d_med)
                 for n in kept)
    return {"loss_gap": float(loss), "grad_gap": float(grad), "update_gap": float(update)}


def train_checks(sd, cfg_tree: Mapping, rows, checked, shape, got: Mapping, limits: Mapping,
                 device, P: Optional[Precision] = None,
                 info: Optional[dict] = None) -> Dict[str, tuple]:
    from portbench.reference import train as ref_train

    batches = train_batches(rows, checked, shape, cfg_tree["dataset"])
    ref = ref_train.train_steps(sd, cfg_tree, batches, P or STATED, device)
    return held(train_gaps(got, ref, info), limits)
