"""Command-line interface: the port of `sstts/cli.py`, with the same
commands, flags, messages and exit codes.

    python -m sstts_torch.cli train      --workdir runs/lj [--set training.batch_size=16]
    python -m sstts_torch.cli evaluate   --workdir runs/lj [--synthesize 4]
    python -m sstts_torch.cli precompute --workdir runs/lj --features --stats
    python -m sstts_torch.cli synthesize --workdir runs/lj --text "hello world" --out out.wav

Config overrides use dotted paths into the five hparam sections
(`--set dataset.dataset_dir=/data/LJSpeech-1.1`).  `train` lays a mesh over
every visible GPU as the reference lays one over every device
(`--set training.model_parallel=2` puts two on the model axis).  Every
command runs on the CUDA card and raises where there is none;
`main(argv, device="cpu")` runs the plain versions on the CPU (the tests
do), and `n_devices=N` there lays `train`'s mesh over N gloo processes.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import sys
from pathlib import Path
from typing import List

from sstts_torch.config import Config


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """`section.key=value` overrides (values read as Python literals, else
    as strings); a copy of `sstts/cli.py:apply_overrides`."""
    sections = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for item in overrides:
        if "=" not in item:
            raise SystemExit(f"--set expects section.key=value, got: {item}")
        path, raw = item.split("=", 1)
        parts = path.split(".")
        if len(parts) != 2 or parts[0] not in sections:
            raise SystemExit(
                f"--set path must be one of "
                f"{sorted(sections)}.<field>, got: {path}"
            )
        section, key = parts
        obj = sections[section]
        if not any(f.name == key for f in dataclasses.fields(obj)):
            raise SystemExit(f"unknown field {key!r} in config section {section!r}")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw  # plain string
        current = getattr(obj, key)
        if current is not None and not isinstance(value, type(current)):
            if isinstance(current, float) and isinstance(value, int):
                value = float(value)
            elif isinstance(current, tuple) and isinstance(value, (list, tuple)):
                value = tuple(value)
        sections[section] = dataclasses.replace(obj, **{key: value})
    return Config(**sections)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sstts_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--workdir", default="runs/default")
        sp.add_argument(
            "--set", dest="overrides", action="append", default=[],
            metavar="SECTION.KEY=VALUE", help="config override (repeatable)",
        )

    t = sub.add_parser("train", help="train a model")
    common(t)
    t.add_argument("--max-steps", type=int, default=None)

    e = sub.add_parser("evaluate", help="evaluate the latest checkpoint")
    common(e)
    e.add_argument("--num-batches", type=int, default=None)
    e.add_argument("--synthesize", type=int, default=0, metavar="N",
                   help="also synthesize N eval utterances to WAV")

    pc = sub.add_parser(
        "precompute",
        help="build the offline corpus cache (decode+trim audio; "
        "optionally mel/linear features) and print corpus statistics",
    )
    common(pc)
    pc.add_argument("--cache-dir", default=None,
                    help="cache directory (default: dataset.cache_dir or "
                    "<workdir>/cache)")
    pc.add_argument("--features", action="store_true",
                    help="also precompute normalized mel/linear features")
    pc.add_argument("--stats", action="store_true",
                    help="also compute and print corpus dB statistics")

    s = sub.add_parser("synthesize", help="text -> WAV from a checkpoint")
    common(s)
    s.add_argument("--text", action="append", default=[],
                   help="text to synthesize (repeatable for a batch)")
    s.add_argument("--text-file", default=None,
                   help="file with one sentence per line (batch synthesis)")
    s.add_argument("--longform", action="store_true",
                   help="treat all input text as ONE document: split at "
                   "sentence boundaries, batch-synthesize, join into a "
                   "single WAV (--out applies)")
    s.add_argument("--out", default=None, help="output WAV path (single text)")
    s.add_argument("--fast-vocoder", action="store_true",
                   help="quality-gated fast Griffin-Lim preset (30 "
                   "iterations at momentum 0.99). Explicit --set "
                   "inference.* overrides still win")
    return p


def main(argv=None, device=None, n_devices=None) -> int:
    """Run one command; `device` None means the card, and `n_devices` (the
    devices `train` lays its mesh over) None means every visible GPU there,
    one on the CPU."""
    args = build_parser().parse_args(argv)
    cfg = apply_overrides(Config(), args.overrides)

    if args.command == "train":
        from sstts_torch.train import train

        train(cfg, workdir=args.workdir, max_steps=args.max_steps, device=device,
              n_devices=n_devices)
        return 0

    if args.command == "evaluate":
        from sstts_torch.evaluate import evaluate

        metrics = evaluate(
            cfg, args.workdir, args.num_batches, synthesize_count=args.synthesize,
            device=device,
        )
        print({k: round(v, 5) for k, v in metrics.items()})
        return 0

    if args.command == "precompute":
        from sstts_torch.data import features_cache
        from sstts_torch.train import load_corpus

        cache_dir = (
            args.cache_dir
            or cfg.dataset.cache_dir
            or str(Path(args.workdir) / "cache")
        )
        train_utts, eval_utts = load_corpus(cfg)
        utts = train_utts + eval_utts
        print(f"caching {len(utts)} utterances -> {cache_dir}")
        cache = features_cache.build_audio_cache(utts, cfg, cache_dir)
        if args.features:
            features_cache.precompute_features(cache, utts, cfg, device=device)
        if args.stats:
            from sstts_torch.data.statistics import compute_statistics

            print(json.dumps(compute_statistics(utts, cfg, device=device), indent=2))
        print(f"done; train with --set dataset.cache_dir={cache_dir}")
        return 0

    if args.command == "synthesize":
        from sstts_torch.synthesize import Synthesizer

        if args.fast_vocoder:
            # The preset first, then the user's overrides again, so that an
            # explicit --set inference.griffin_lim_* wins.
            from sstts_torch.config import with_fast_vocoder

            cfg = apply_overrides(with_fast_vocoder(Config()), args.overrides)

        texts = list(args.text)
        if args.text_file:
            try:
                with open(args.text_file) as fh:
                    texts += [line.strip() for line in fh if line.strip()]
            except OSError as e:
                print(f"cannot read --text-file: {e}", file=sys.stderr)
                return 1
        if not texts:
            print("nothing to synthesize: pass --text and/or --text-file",
                  file=sys.stderr)
            return 1
        if args.out and len(texts) > 1 and not args.longform:
            print(
                "--out applies to single-text runs only; writing "
                "synthesis_<i>.wav files under the workdir output dir",
                file=sys.stderr,
            )
        try:
            synth = Synthesizer.from_checkpoint(args.workdir, cfg, device)
        except FileNotFoundError:
            print(f"no checkpoint under {args.workdir}", file=sys.stderr)
            return 1
        from sstts_torch.data.wav import save_wav

        outdir = Path(args.workdir) / cfg.inference.output_dir
        if args.longform:
            wav = synth.synthesize_longform(" ".join(texts))
            if len(wav) == 0:
                print("no synthesizable text after normalization",
                      file=sys.stderr)
                return 1
            out = Path(args.out) if args.out else outdir / "longform.wav"
            out.parent.mkdir(parents=True, exist_ok=True)
            save_wav(out, wav, cfg.dataset.sample_rate)
            print(f"wrote {out}")
        elif len(texts) == 1:
            out = Path(args.out) if args.out else outdir / "synthesis_0.wav"
            print(f"wrote {synth.to_file(texts[0], out)}")
        else:
            # One padded batch for all the texts.
            outdir.mkdir(parents=True, exist_ok=True)
            for i, wav in enumerate(synth.synthesize_batch(texts)):
                path = outdir / f"synthesis_{i}.wav"
                save_wav(path, wav, cfg.dataset.sample_rate)
                print(f"wrote {path}")
        return 0

    return 2


if __name__ == "__main__":
    raise SystemExit(main())
