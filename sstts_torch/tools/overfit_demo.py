"""End-to-end quality check of the port: overfit a small model on a few
synthetic utterances, then synthesize them back and measure the mel-L1 of
the predictions against the ground-truth features.  The port of
`scripts/overfit_demo.py`, with its configuration, on the card.

    python3 -m sstts_torch.tools.overfit_demo [--steps 1500] [--utts 4]
    python3 -m sstts_torch.tools.overfit_demo --spec [--workdir DIR]

`--spec` is the reference's gate: one example, dropout off, lr 8e-3, Adam
beta2 0.99, and the teacher-forced mel L1 of the training loss must reach
<= 0.01 within 1000 steps (read every 50 steps, as the reference does; it
also prints the value at step 500).  Without it, 4 utterances train with
the production dropout and the worst predicted mel-L1 of the synthesized
batch must be < 0.08.  Exit status 0 when the gate holds, 1 otherwise.
`--device cpu` runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Tuple


def demo_config(utts: int, spec: bool):
    """The reference demo's configuration (`scripts/overfit_demo.py`):
    tiny_config at 8 kHz, r=2, one (64, 220) bucket, widths of 32-64."""
    from sstts_torch.config import tiny_config

    cfg = tiny_config()
    return cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset, dataset="synthetic", sample_rate=8000, n_fft=512,
            n_mels=40, mel_fmax=4000.0,
        ),
        training=dataclasses.replace(
            cfg.training, batch_size=utts, text_buckets=(64,), frame_buckets=(220,),
            learning_rate=8e-3 if spec else 1.5e-3,
            **({"adam_beta2": 0.99} if spec else {}),
        ),
        arch=dataclasses.replace(
            cfg.arch,
            embedding_dim=64,
            encoder_bank_k=8, encoder_bank_channels=32,
            encoder_proj_channels=(32, 32), encoder_highway_units=32,
            encoder_gru_units=32, attention_units=64,
            post_bank_k=4, post_bank_channels=32,
            post_proj_channels=(64, 40), post_highway_units=32,
            post_gru_units=32, reduction_factor=2,
            # A diagonal attention prior; a mild one for one example.
            guided_attention_weight=0.2 if spec else 1.0,
            prenet_units=(64, 32), attention_gru_units=64,
            decoder_gru_units=64,
            # Memorizing one example: dropout off.
            **({"prenet_dropout": 0.0} if spec else {}),
        ),
        inference=dataclasses.replace(
            cfg.inference, max_decoder_steps=110, griffin_lim_iters=30,
            stop_threshold=0.8, min_decoder_steps=4,
        ),
    )


def overfit(cfg, utts, steps: int, spec: bool, device=None, every: int = 0,
            log=print) -> Tuple[object, Dict, List[Tuple[int, Dict[str, float]]]]:
    """Train on the first batch of `utts` for up to `steps` steps (with
    `spec`, until the mel L1 reaches 0.01).  Reads the metrics every
    `every` steps (default: 50 with `spec`, 200 without); returns (state,
    batch, [(step, metrics)])."""
    from sstts_torch.data import pipeline
    from sstts_torch.train import create_state, make_train_step

    every = every or (50 if spec else 200)
    batcher = pipeline.Batcher(utts, cfg)
    _, batch = next(iter(batcher.epoch(0, len(utts))))
    state = create_state(cfg, device=device)
    step_fn = make_train_step(cfg)
    history = []
    t0 = time.perf_counter()
    for i in range(steps):
        metrics = step_fn(state, batch)
        if (i + 1) % every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append((i + 1, m))
            if (i + 1) % 100 == 0 or not spec:
                log(f"step {i + 1}: loss={m['loss']:.4f} mel={m['loss_mel']:.4f} "
                    f"stop={m['loss_stop']:.4f} "
                    f"({(i + 1) / (time.perf_counter() - t0):.1f} steps/s)")
            if spec and m["loss_mel"] <= 0.01:
                break
    return state, batch, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--utts", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--workdir", default=None, help="write the synthesized WAVs here")
    ap.add_argument("--spec", action="store_true",
                    help="1 example, teacher-forced mel L1 <= 0.01 within 1000 steps")
    args = ap.parse_args(argv)
    if args.spec:
        args.utts = 1
        args.steps = min(args.steps, 1000)

    import numpy as np
    import torch

    from sstts_torch.data.synthetic import make_utterances
    from sstts_torch.dsp.ops import wav_to_features
    from sstts_torch.synthesize import Synthesizer

    cfg = demo_config(args.utts, args.spec)
    utts = make_utterances(args.utts, cfg.dataset, min_words=2, max_words=3)
    t0 = time.perf_counter()
    state, batch, history = overfit(cfg, utts, args.steps, args.spec, device=args.device)
    dev = next(state.model.parameters()).device
    print(f"trained {state.step} steps in {time.perf_counter() - t0:.1f} s on {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""),
          flush=True)

    synth = Synthesizer(cfg, state.model.state_dict(), device=dev)
    with torch.no_grad():
        samples = torch.as_tensor(batch["samples"]).float() * (1.0 / 32767.0)
        _, gt_mel = wav_to_features(samples, cfg.dataset)
    wavs, full = synth.synthesize_batch([u.text for u in utts], full_output=True)
    worst = 0.0
    for i, u in enumerate(utts):
        n = min(int(full["n_frames"][i]), int(batch["loss_frames"][i]))
        if n < 10:
            print(f"utt {i}: too short ({n} frames): the stop token fired early")
            worst = max(worst, 1.0)
            continue
        syn = wav_to_features(
            torch.as_tensor(wavs[i][: (n - 1) * cfg.dataset.hop_len]), cfg.dataset
        )[1]
        l1 = float((syn[:n] - gt_mel[i, :n]).abs().mean())
        pred_l1 = float(np.abs(full["mel"][i, :n] - gt_mel[i, :n].numpy()).mean())
        print(f"utt {i} ({u.text[:32]!r}): frames={n} mel-L1(pred)={pred_l1:.4f} "
              f"mel-L1(resynth audio)={l1:.4f}", flush=True)
        worst = max(worst, pred_l1)
    if args.spec:
        tf_step, tf_mel = history[-1][0], history[-1][1]["loss_mel"]
        at500 = next((f"{m['loss_mel']:.4f}" for s, m in history if s == 500), "n/a")
        ok = tf_mel <= 0.01
        print(f"RESULT: teacher-forced mel-L1 {tf_mel:.4f} at step {tf_step} (gate: "
              f"<=0.01 within 1000 steps; at step 500: {at500}) -> "
              f"{'OK' if ok else 'WEAK'}")
    else:
        ok = worst < 0.08
        print(f"RESULT: worst predicted mel-L1 {worst:.4f} -> {'OK' if ok else 'WEAK'}")
    if args.workdir:
        from pathlib import Path

        from sstts_torch.data.wav import save_wav

        out = Path(args.workdir)
        out.mkdir(parents=True, exist_ok=True)
        for i in range(len(utts)):
            save_wav(out / f"overfit_{i}.wav", wavs[i], cfg.dataset.sample_rate)
        print("wavs written to", out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
