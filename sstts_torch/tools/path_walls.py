"""Repeated wall times of the synthesis and training paths of one tree.

    cd TREE && python3 PATH/TO/sstts_torch/tools/path_walls.py [--batches 12] [--steps 8]

Run as a script from the root of the tree to be measured (this one, or
another checkout unpacked beside it): it imports `chip_smoke` and
`sstts_torch` from the current directory, so one copy of this file times
two trees in turns on one card.  It drives `chip_smoke.py`'s synthesis
workload (`Synthesizer.synthesize_batch`, b=32, 800 frames, GL-60, PCM16)
`--batches` times after two warm-up batches, and its training workload
(b=32 in the 515-frame bucket) `--steps` times after one warm-up step,
in turns with a cached step (`make_cached_train_step` on 32 rows of
`chip_smoke.corpus_config()`'s pcm16 device corpus, bucket 1, as phase
3e), and prints one JSON line with every reading, the medians and the
card.  A single reading of either moves by more than 10% with the host;
compare medians.  It also times, five times, the host's side of one decode
(`prepare_decode` and `decode_steps` at b=32, T=96, 160 steps, bf16) while
the card is held busy for ~100 ms: a host that waits for the card there
reads near that time, one that does not a few ms.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()

    # The tree under measurement is the current directory, not this file's.
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke
    from sstts_torch import train as tr
    from sstts_torch.config import Config
    from sstts_torch.model.tacotron import Tacotron, init_state_dict
    from sstts_torch.ops import decoder as dec
    from sstts_torch.synthesize import Synthesizer

    if not torch.cuda.is_available():
        raise SystemExit("path_walls: no CUDA device")
    cfg = chip_smoke.bench_config()
    texts = ["the quick brown fox jumps over the lazy dog " * 2] * 32
    synth = Synthesizer(cfg, init_state_dict(cfg.arch, cfg.dataset, seed=0), seed=0)
    walls = []
    for i in range(args.batches + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synth.synthesize_batch(texts)
        if i >= 2:
            walls.append(time.perf_counter() - t0)

    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=0))
    cell = model.decoder_cell.cuda().eval()
    memory = 0.5 * torch.randn(32, 96, 2 * cfg.arch.encoder_gru_units, device="cuda")
    mask = torch.ones(32, 96, dtype=torch.bool, device="cuda")
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        with torch.no_grad():
            dec.decode_steps(dec.prepare_decode(cell, memory, mask, 160, stop_threshold=1.1,
                                                matmul_dtype=torch.bfloat16))
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()

    tcfg = Config()
    tcfg = tcfg.replace(
        dataset=dataclasses.replace(tcfg.dataset, dataset="synthetic"),
        training=dataclasses.replace(tcfg.training, batch_size=32),
    )
    batch = chip_smoke.fixed_batch(tcfg, 32, 1, (10, 16))
    state = tr.create_state(tcfg, seed=0)
    step = tr.make_train_step(tcfg)
    ccfg = chip_smoke.corpus_config()
    (corpus, _), _ = tr.build_device_corpus(ccfg, tr.load_corpus(ccfg)[0],
                                           device=torch.device("cuda"))
    cstate = tr.create_state(ccfg, seed=0)
    cstep = tr.make_cached_train_step(ccfg)
    idx, valid = np.arange(32, dtype=np.int32), np.ones(32, np.float32)
    runs = {"host": lambda: step(state, batch),
            "cached": lambda: cstep(cstate, corpus[1], idx, valid)}
    ms = {k: [] for k in runs}
    for i in range(args.steps + 1):
        for k, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            if i >= 1:
                ms[k].append((time.perf_counter() - t0) * 1e3)
    steps = ms["host"]
    print(json.dumps({
        "tree": os.getcwd(),
        "batch_wall_s": {"median": statistics.median(walls), "all": walls},
        "train_step_ms": {"median": statistics.median(steps), "all": steps},
        "cached_step_ms": {"median": statistics.median(ms["cached"]), "all": ms["cached"]},
        "decode_host_ms_card_busy": {"median": statistics.median(host), "all": host},
        "card": chip_smoke.card_line(),
    }))


if __name__ == "__main__":
    main()
