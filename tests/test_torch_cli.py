"""The port's command line (`python -m sstts_torch.cli`) end to end on the
CPU, modelled on `tests/test_cli.py`: train on a tiny LJSpeech-layout
corpus written into `tmp_path`, evaluate, synthesize with --text,
--text-file and --longform, precompute the cache and statistics; the
exit codes and messages of the JAX CLI, the --fast-vocoder precedence,
the override errors, and the card by default.  No JAX here."""

import dataclasses
import json

import pytest
import torch

from sstts_torch import cli as cli_mod
from sstts_torch.config import Config, tiny_config
from sstts_torch.data.synthetic import materialize_corpus
from sstts_torch.utils import logging as plogging


def _tiny(corpus):
    cfg = tiny_config()
    return cfg.replace(
        dataset=dataclasses.replace(
            cfg.dataset, dataset="ljspeech", dataset_dir=str(corpus), eval_fraction=0.3,
        ),
        training=dataclasses.replace(
            cfg.training, batch_size=2, text_buckets=(32,), frame_buckets=(160,),
            checkpoint_every=2, summary_every=1,
        ),
        evaluation=dataclasses.replace(cfg.evaluation, batch_size=2, num_eval_batches=1),
        inference=dataclasses.replace(cfg.inference, max_decoder_steps=12, griffin_lim_iters=4),
    )


def _patch(monkeypatch, corpus):
    """`Config()` in the CLI gives the tiny config on `corpus`; TensorBoard
    stays off (it imports TensorFlow where that is installed, ~16 s)."""
    tiny = _tiny(corpus)
    monkeypatch.setattr(cli_mod, "Config", lambda **kw: Config(**kw) if kw else tiny)
    monkeypatch.setattr(plogging, "_tensorboard_writer", lambda logdir: None)
    return tiny


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A corpus of 12 utterances and two train steps through the CLI."""
    root = tmp_path_factory.mktemp("cli")
    corpus = materialize_corpus(root / "corpus", 12, tiny_config().dataset, pad_s=0.2,
                                min_words=1, max_words=2)
    with pytest.MonkeyPatch.context() as mp:
        cfg = _patch(mp, corpus)
        rc = cli_mod.main(["train", "--workdir", str(root / "run"), "--max-steps", "2"],
                          device="cpu")
    assert rc == 0
    return cfg, corpus, root / "run"


def test_cli_train_logs_in_the_reference_shape(run):
    cfg, _, workdir = run
    records = [json.loads(x) for x in (workdir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    for r in train:
        assert {"step", "wall_s", "prefix", "loss", "grad_norm", "lr", "steps_per_s"} <= set(r)
    assert [r["prefix"] for r in records].count("eval") == 1
    assert (workdir / cfg.training.checkpoint_dir / "step_2.pt").exists()


def test_cli_evaluate_then_synthesize(run, tmp_path, monkeypatch, capsys):
    cfg, corpus, workdir = run
    _patch(monkeypatch, corpus)
    assert cli_mod.main(["evaluate", "--workdir", str(workdir), "--num-batches", "1",
                         "--synthesize", "2"], device="cpu") == 0
    assert "resynthesis_mel_l1" in capsys.readouterr().out
    outdir = workdir / cfg.inference.output_dir
    assert len(list(outdir.glob("eval_*.wav"))) == 2
    records = [json.loads(x) for x in (workdir / "metrics.jsonl").read_text().splitlines()]
    assert records[-1]["prefix"] == "eval" and "resynthesis_len_rel_err" in records[-1]

    sentences = tmp_path / "sentences.txt"
    sentences.write_text("hello world\n\nthe quick brown fox\n")
    assert cli_mod.main(["synthesize", "--workdir", str(workdir), "--text", "a third one",
                         "--text-file", str(sentences)], device="cpu") == 0
    wavs = sorted(outdir.glob("synthesis_*.wav"))
    assert len(wavs) == 3  # 1 --text + 2 non-blank file lines
    assert all(w.stat().st_size > 44 for w in wavs)
    out = tmp_path / "one.wav"
    assert cli_mod.main(["synthesize", "--workdir", str(workdir), "--text", "hello",
                         "--out", str(out)], device="cpu") == 0
    assert out.stat().st_size > 44


def test_cli_longform(run, tmp_path, monkeypatch):
    _, corpus, workdir = run
    _patch(monkeypatch, corpus)
    out = tmp_path / "doc.wav"
    rc = cli_mod.main(["synthesize", "--workdir", str(workdir), "--longform",
                       "--text", "one sentence here. and another one!", "--out", str(out)],
                      device="cpu")
    assert rc == 0 and out.stat().st_size > 44
    # Text that normalizes to nothing is an error, not an empty WAV.
    assert cli_mod.main(["synthesize", "--workdir", str(workdir), "--longform",
                         "--text", "你好"], device="cpu") == 1


def test_cli_synthesize_errors(run, tmp_path, monkeypatch, capsys):
    _, corpus, workdir = run
    _patch(monkeypatch, corpus)
    assert cli_mod.main(["synthesize", "--workdir", str(workdir)], device="cpu") == 1
    assert "nothing to synthesize" in capsys.readouterr().err
    assert cli_mod.main(["synthesize", "--workdir", str(tmp_path / "empty"), "--text", "hi"],
                        device="cpu") == 1
    assert "no checkpoint under" in capsys.readouterr().err
    assert cli_mod.main(["synthesize", "--workdir", str(workdir), "--text-file",
                         str(tmp_path / "missing.txt")], device="cpu") == 1
    assert "cannot read --text-file" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        cli_mod.main(["evaluate", "--workdir", str(tmp_path / "empty")], device="cpu")


def test_fast_vocoder_preset_and_override_precedence(tmp_path, monkeypatch):
    """--fast-vocoder applies the GL-30 at m=0.99 preset; an explicit --set
    inference.* still wins; the checkpoint is asked for with the port's
    argument order (workdir, cfg, device)."""
    _patch(monkeypatch, tmp_path)
    captured = {}

    class FakeSynth:
        @classmethod
        def from_checkpoint(cls, workdir, cfg, device):
            captured.update(cfg=cfg, workdir=workdir, device=device)
            raise FileNotFoundError(workdir)

    monkeypatch.setattr("sstts_torch.synthesize.Synthesizer", FakeSynth)
    args = ["synthesize", "--workdir", str(tmp_path), "--text", "hi", "--fast-vocoder"]
    assert cli_mod.main(args, device="cpu") == 1
    assert captured["cfg"].inference.griffin_lim_iters == 30
    assert captured["cfg"].inference.griffin_lim_momentum == 0.99
    assert captured["workdir"] == str(tmp_path) and captured["device"] == "cpu"
    assert cli_mod.main(args + ["--set", "inference.griffin_lim_iters=40"], device="cpu") == 1
    assert captured["cfg"].inference.griffin_lim_iters == 40  # --set wins
    assert captured["cfg"].inference.griffin_lim_momentum == 0.99
    assert cli_mod.main(args[:-1], device="cpu") == 1  # no preset without the flag
    assert captured["cfg"].inference.griffin_lim_iters == 4


@pytest.mark.parametrize("item,message", [
    ("training.batch_size", "expects section.key=value"),
    ("nosection.x=1", "--set path must be one of"),
    ("training.batch_size.x=1", "--set path must be one of"),
    ("training.nofield=1", "unknown field 'nofield'"),
])
def test_apply_overrides_errors(item, message):
    with pytest.raises(SystemExit, match=message):
        cli_mod.apply_overrides(Config(), [item])


def test_apply_overrides_types():
    cfg = cli_mod.apply_overrides(Config(), [
        "training.learning_rate=1", "training.text_buckets=[64, 128]",
        "dataset.dataset_dir=/data/LJ", "inference.griffin_lim_fft_impl=dft_high",
    ])
    assert cfg.training.learning_rate == 1.0 and isinstance(cfg.training.learning_rate, float)
    assert cfg.training.text_buckets == (64, 128)
    assert cfg.dataset.dataset_dir == "/data/LJ"
    assert cfg.inference.griffin_lim_fft_impl == "dft_high"


def test_cli_precompute_stats_then_train_from_the_cache(run, tmp_path, monkeypatch, capsys):
    _, corpus, _ = run
    _patch(monkeypatch, corpus)
    cache = tmp_path / "cache"
    assert cli_mod.main(["precompute", "--workdir", str(tmp_path), "--cache-dir", str(cache),
                         "--features", "--stats"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "caching 12 utterances" in out and f"dataset.cache_dir={cache}" in out
    stats = json.loads(out[out.index("{"): out.rindex("}") + 1])
    assert stats["n_utterances"] == 12.0 and stats["mel_db_max"] > stats["mel_db_min"]
    index = json.loads((cache / "index.json").read_text())
    assert len(index["audio"]) == len(index["features"]) == 12
    assert (cache / "mel.bin").stat().st_size > 0
    # Training reads the cache, not the WAV files.
    monkeypatch.setattr("sstts_torch.data.pipeline.load_audio",
                        lambda *a: pytest.fail("read a WAV file"))
    assert cli_mod.main(["train", "--workdir", str(tmp_path / "run"), "--max-steps", "1",
                         "--set", f"dataset.cache_dir={cache}"], device="cpu") == 0


def test_cli_architecture_settings_reach_the_model(run, tmp_path, monkeypatch, capsys):
    """`--set arch.compute_dtype=bfloat16`, `arch.attention_type=local_luong`
    and `arch.fused_conv_bank=True` train, evaluate and synthesize: the
    checkpoint's config carries them and the restored model computes in
    bf16 with Luong attention and the fused bank."""
    from sstts_torch.model.attention import LocalLuongAttention
    from sstts_torch.synthesize import Synthesizer

    _, corpus, _ = run
    _patch(monkeypatch, corpus)
    workdir = str(tmp_path / "variants")
    sets = ["--set", "arch.compute_dtype=bfloat16", "--set", "arch.attention_type=local_luong",
            "--set", "arch.fused_conv_bank=True"]
    assert cli_mod.main(["train", "--workdir", workdir, "--max-steps", "1", *sets],
                        device="cpu") == 0
    assert cli_mod.main(["evaluate", "--workdir", workdir, "--num-batches", "1", *sets],
                        device="cpu") == 0
    assert "resynthesis_mel_l1" in capsys.readouterr().out
    out = tmp_path / "v.wav"
    assert cli_mod.main(["synthesize", "--workdir", workdir, "--text", "hello there",
                         "--out", str(out), *sets], device="cpu") == 0
    assert out.exists() and out.stat().st_size > 44
    synth = Synthesizer.from_checkpoint(workdir, device="cpu")
    a = synth.cfg.arch
    assert (a.compute_dtype, a.attention_type, a.fused_conv_bank) == (
        "bfloat16", "local_luong", True)
    assert synth.model.dtype == torch.bfloat16 and synth.model.encoder_cbhg.bank.fused
    assert isinstance(synth.model.decoder_cell.attention, LocalLuongAttention)
    assert synth._decoder_impl == "xla"


def test_cli_runs_on_the_card_by_default(run, tmp_path, monkeypatch):
    """From the shell every command runs on CUDA; without it, it raises
    and does not fall back to the CPU."""
    _, corpus, workdir = run
    _patch(monkeypatch, corpus)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["train", "--workdir", str(tmp_path / "t"), "--max-steps", "1"],
                 ["evaluate", "--workdir", str(workdir)],
                 ["synthesize", "--workdir", str(workdir), "--text", "hi"],
                 ["precompute", "--workdir", str(tmp_path), "--features"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_mod.main(argv)


def test_cli_from_the_shell_needs_the_card(tmp_path):
    """`python -m sstts_torch.cli` in a fresh interpreter with no CUDA
    device exits non-zero with the reason, having trained nothing."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "sstts_torch.cli", "train", "--workdir", str(tmp_path / "w"),
         "--max-steps", "1", "--set", "dataset.dataset=synthetic"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert not (tmp_path / "w" / "metrics.jsonl").exists()
