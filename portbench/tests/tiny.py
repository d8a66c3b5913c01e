"""Tiny cells for the CPU tests: the program's `tiny_config()` with the
benchmark's traffic kinds cut to it."""

import json

from portbench import harness

BENCH = harness.BENCH_DIR


def synth_tree(**inference):
    from sstts_torch.config import tiny_config

    tree = harness.config_tree(tiny_config())
    # The card's decode (B4) on the CPU is its plain version.
    tree["inference"].update({"stop_threshold": 1.1, "decoder_impl": "fused"}, **inference)
    return tree


def synth_traffic(name="stream_b32"):
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t.update({"batch": 4, "pool": 64, "lookahead": 20, "check_rows": 3, "trace_batches": 3,
              "duration": {"dist": "beta", "a": 3.2, "b": 2.0, "lo_s": 0.3, "hi_s": 1.0}})
    t["inference"] = {**t.get("inference", {}), "griffin_lim_iters": 8}
    return t


def train_tree():
    from sstts_torch.config import tiny_config

    return harness.config_tree(tiny_config())


def train_traffic():
    t = json.loads((BENCH / "traffic" / "train_cached_b32.json").read_text())
    t.update({"batch": 2, "utterances": 8, "duration_s": [0.1, 0.18], "chars_per_s": 60.0,
              "trace_steps": 2})
    return t


def run(kind, tree, traffic, seed=2**33 + 11, seconds=1.0, trace=False, limits=None):
    from portbench.drivers import Run

    r = Run(cell="tiny", cfg_tree=tree, traffic=traffic, limits=limits or {"limits": {}},
            seed=seed, seconds=seconds, trace=trace, device="cpu")
    return harness.driver(kind).run(r)
