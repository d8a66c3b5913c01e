"""Reference synthesis of chosen rows of served batches: text -> ids ->
encoder -> decode of the batch's steps with its dropout seed at the rows'
places in the batch -> post-net -> masked linear spectrogram ->
Griffin-Lim -> de-emphasis -> the wire -> host audio trimmed to each
row's sample count.  Rows are independent of their batch but for the
batch's step count, its dropout seed and their row index, which the
caller passes."""

from __future__ import annotations

from typing import List, Mapping, Sequence

import numpy as np
import torch

from portbench.reference import Precision, audio, matmul_precision, model, text


def dropout_seed(generator_seed: int, batch_index: int) -> int:
    """The dropout seed of the `batch_index`-th batch a synthesizer seeded
    with `generator_seed` serves: one draw of randint(0, 2^31 - 1) a batch
    from a CPU generator of that seed."""
    g = torch.Generator().manual_seed(int(generator_seed))
    seed = None
    for _ in range(batch_index + 1):
        seed = int(torch.randint(0, 2**31 - 1, (), generator=g))
    return seed


def synthesize_rows(sd: Mapping[str, torch.Tensor], cfg: Mapping, texts: Sequence[str],
                    steps: int, seed: int, rows: Sequence[int], P: Precision,
                    device) -> List[np.ndarray]:
    """Host waveforms of `texts`, served as rows `rows` of a batch of
    `steps` decode steps whose dropout seed is `seed`."""
    a, ds, inf = cfg["arch"], cfg["dataset"], cfg["inference"]
    hop = int(ds["sample_rate"] * ds["win_hop_ms"] / 1000.0)
    wl = int(ds["sample_rate"] * ds["win_len_ms"] / 1000.0)
    with torch.no_grad(), matmul_precision(P):
        ids = text.batch_ids(texts, device)
        memory, mask = model.encode(sd, a, ids, P)
        dec = model.decode(sd, a, ds["n_mels"], memory, mask, steps, seed,
                           torch.as_tensor(list(rows)), inf["stop_threshold"],
                           inf["min_decoder_steps"], P)
        mel = dec["mel"]
        total = mel.shape[1]
        fmask = torch.arange(total, device=device)[None] < dec["n_frames"][:, None]
        lin = model.postnet(sd, a, mel, fmask, P).float()
        lin = torch.where(fmask[..., None], lin, torch.zeros_like(lin))
        mag = audio.spectrogram_to_magnitude(lin, ds, inf)
        loop = torch.float32 if inf.get("griffin_lim_fft_impl") in ("dft_high", "dft_highest") \
            else P.half
        wav = audio.griffin_lim(mag, ds["n_fft"], hop, wl, inf["griffin_lim_iters"],
                                inf["griffin_lim_momentum"], loop)
        wav = audio.deemphasis(wav, ds["preemphasis"])
        host = audio.through_wire(wav, inf["wire_format"])
    length = (total - 1) * hop
    n_samples = torch.clamp(dec["n_frames"] * hop, max=length).tolist()
    return [host[i, : int(n)] for i, n in enumerate(n_samples)]
