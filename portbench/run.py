#!/usr/bin/env python3
"""The benchmark of `sstts_torch` on one NVIDIA card, one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in `BENCHMARK.json`, its
configuration file and its traffic file under `portbench/`, the runner of
the traffic's kind under `portbench/drivers/`, each per-layer metric's
reader under `portbench/metrics/`, and the cell's limits under
`portbench/limits/`.  With `--trace 0` the result holds the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics read from a
profiled window.  Set-up (`setup_s`) runs from the process's start to the
first timed batch or step.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, outside a checkout that holds the program, or when JAX
or the JAX package (`sstts`) was loaded.  The last lines of standard error
and the result's last key give each number compared with the reference
beside its limit.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    t0 = harness.process_start_time() or _T_IMPORT
    args = parse(argv)
    spec = harness.benchmark_spec(ROOT)
    cell = harness.cell_spec(spec, args.workload)
    harness.set_cache_env(ROOT)
    harness.set_threads()
    import torch

    torch.set_num_threads(harness.HOST_THREADS)

    if not torch.cuda.is_available():
        return fail("no CUDA device", 3)
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
                    f"{cell['chips']}", 3)
    if not (ROOT / "sstts_torch").is_dir():
        return fail("the program (sstts_torch) is not in this checkout", 3)
    conf = harness.config_spec(spec, cell["config"])
    conf_file = harness.load_json(ROOT / conf["file"])
    traffic = harness.traffic_file(cell["traffic"])
    from portbench.drivers import Run

    timed = {}
    run = Run(cell=cell["name"], cfg_tree=conf_file["config"], traffic=traffic,
              limits=harness.limits_file(cell["name"]), seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device="cuda:0",
              on_timed=lambda: timed.setdefault("at", time.time()))
    print(f"portbench: {time.time() - t0:.3f} s from the process's start to the driver",
          file=sys.stderr)
    res = harness.driver(traffic["kind"]).run(run)
    setup_s = timed["at"] - t0
    metrics = {}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": res.memory_peak_bytes}
    out = {}
    if args.trace:
        tr = res.trace
        for m in harness.per_layer_metrics(spec, cell["name"]):
            value = harness.metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        out["breakdown"] = harness.breakdown(tr)
    else:
        for m in harness.end_to_end_metrics(spec, cell["name"]):
            value = setup_s if m["name"] == "setup_s" else harness.e2e_value(res.e2e, m["name"])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    from portbench import check

    correct = check.passed(res.checks) and res.failed == 0
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"modules of JAX or the JAX package were loaded: {bad}", 4)
    for note in res.notes:
        print(f"portbench: {note}", file=sys.stderr)
    info = {k: v for k, (v, lim) in res.checks.items() if lim is None}
    if info:
        print(f"portbench: other readings (not held): {info}", file=sys.stderr)
    # A reading that could not be taken (a row of the wrong length) is inf:
    # printed as the largest finite number, so that the line stays JSON.
    compared = {k: {"value": v if math.isfinite(v) else sys.float_info.max, "limit": lim}
                for k, (v, lim) in res.checks.items() if lim is not None}
    for k, c in compared.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": bool(correct), "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": device}
    line.update(out)
    line["checks"] = compared
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
