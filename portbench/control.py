#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip, in one
process:

    python3 portbench/control.py --workload <cell> --seeds 12 --controls 3 --seconds 4

- the program's readings: a short window of the cell at its own load on
  each of `--seeds` seeds (the run's own comparison with the reference);
- the controls' readings: on each of `--controls` seeds, the rows a
  window would sample, computed by the reference below the stated
  precision (`reference.CONTROLS`: `all_lower`, one step down everywhere:
  the float32 parts with TF32, the bfloat16 products on float8 operands
  scaled a tensor; `model_bf16`, the model in bfloat16) in the program's
  place, against the reference as stated.

Prints one JSON line a reading and a summary last: the largest program
reading and the smallest control reading of each number.  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def program_readings(cell, seeds, seconds):
    from portbench.drivers import Run

    spec = harness.benchmark_spec(ROOT)
    w = harness.cell_spec(spec, cell)
    conf = harness.load_json(ROOT / harness.config_spec(spec, w["config"])["file"])
    traffic = harness.traffic_file(w["traffic"])
    drv = harness.driver(traffic["kind"])
    for seed in seeds:
        t = time.time()
        r = Run(cell=cell, cfg_tree=conf["config"], traffic=traffic,
                limits={"limits": {}}, seed=seed, seconds=seconds, trace=False,
                device="cuda:0")
        res = drv.run(r)
        for note in res.notes:
            print(f"  {note}", flush=True)
        yield seed, {k: v for k, (v, _) in res.checks.items()}, time.time() - t


def control_readings(cell, seeds):
    spec = harness.benchmark_spec(ROOT)
    w = harness.cell_spec(spec, cell)
    conf = harness.load_json(ROOT / harness.config_spec(spec, w["config"])["file"])
    traffic = harness.traffic_file(w["traffic"])
    drv = harness.driver(traffic["kind"])
    for seed in seeds:
        rows: list = []
        for name, reading in drv.control(conf["config"], traffic, seed, "cuda:0", rows):
            yield seed, name, reading
        for name, per in rows:
            print(json.dumps({"control": name, "seed": seed, "rows": per}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    args = p.parse_args(argv)
    harness.set_cache_env(ROOT)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    lower, upper = {}, {}
    for seed, readings, took in program_readings(args.workload, seeds, args.seconds):
        print(json.dumps({"program": seed, "readings": readings, "s": took}), flush=True)
        for k, v in readings.items():
            lower[k] = max(lower.get(k, 0.0), v)
    cseeds = [args.first_seed + 104729 * (i + 1) for i in range(args.controls)]
    for seed, name, readings in control_readings(args.workload, cseeds):
        print(json.dumps({"control": name, "seed": seed, "readings": readings}), flush=True)
        for k, v in readings.items():
            upper.setdefault(name, {})
            upper[name][k] = min(upper[name].get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
