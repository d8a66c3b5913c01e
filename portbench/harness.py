"""What every cell shares: the benchmark's files found by name, the
program's configuration built from a configuration file, the device, the
profiler's trace reduced to device intervals, and the result line.

Nothing here imports the program at module import; `config_from_file`
imports the program's `Config` when it is called.
"""

from __future__ import annotations

import dataclasses
import heapq
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: Top-level module names that may not be loaded in a run's process: JAX
#: and the JAX package, compared whole (`sstts_torch` is the program).
FORBIDDEN = ("jax", "jaxlib", "flax", "sstts")
#: Build and kernel caches at fixed places inside the checkout (the
#: program builds its own kernels into `sstts_torch/_build/`).
CACHE_ENV = {
    "TRITON_CACHE_DIR": ".portbench_cache/triton",
    "TORCH_EXTENSIONS_DIR": ".portbench_cache/torch_extensions",
    "CUDA_CACHE_PATH": ".portbench_cache/cuda",
}


def set_cache_env(root: Path = ROOT) -> None:
    for k, rel in CACHE_ENV.items():
        path = root / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[k] = str(path)
    os.environ["USE_FLAX"] = "0"


#: Threads of the host's math libraries in a run: the program's host work
#: is dispatch, and a pool of idle threads only takes cores from it (one
#: thread steadied the host-bound cell's runs on the chip's hosts).
HOST_THREADS = 1


def set_threads() -> None:
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = str(HOST_THREADS)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_spec(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_spec(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_metrics(spec: dict, cell: str) -> List[dict]:
    return [m for m in spec["end_to_end"] if _applies(m, cell)]


def per_layer_metrics(spec: dict, cell: str) -> List[dict]:
    """The cell's per-layer metrics: those that list it, and those without
    a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(spec, cell)}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def e2e_value(e2e: Mapping[str, float], name: str) -> float:
    """The runner's reading of end-to-end metric `name`: its own, else that
    of the quantity before the first dot (`audio_rtf.kernel_bound` is
    `audio_rtf`, held to a bound of its own in other cells)."""
    return e2e[name] if name in e2e else e2e[name.split(".")[0]]


def traffic_file(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def limits_file(cell: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "limits" / f"{cell}.json")


def driver(kind: str):
    """The general generator and runner of a traffic kind."""
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """`read(trace) -> value or None` of the per-layer metric `name`, from
    `portbench/metrics/<name>.py`."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def config_from_dict(tree: Mapping):
    """The program's `Config` from its dict tree (as the file holds it)."""
    from sstts_torch.config import (
        ArchitectureConfig, Config, DatasetConfig, EvaluationConfig, InferenceConfig,
        TrainingConfig,
    )

    kinds = {"dataset": DatasetConfig, "arch": ArchitectureConfig,
             "training": TrainingConfig, "evaluation": EvaluationConfig,
             "inference": InferenceConfig}
    return Config(**{k: kinds[k](**_tuples(tree[k])) for k in kinds})


def config_tree(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def with_overrides(tree: Mapping, overrides: Mapping) -> dict:
    """A copy of a config tree with {section: {field: value}} applied."""
    out = json.loads(json.dumps(tree))
    for section, fields in overrides.items():
        out[section].update(fields)
    return out


# ----------------------------------------------------------------- trace --


class Trace:
    """What a traced window gives the per-layer readers.

    `events`: (name, start_us, end_us) of every device operation (kernels,
    copies, sets) in the window; `units`: one dict of shapes per batch or
    step the window completed; `window_s`: the window's length on the
    host's clock; `cfg`: the configuration tree; `host_spans`: the host's
    operations, as (name, start_us, end_us); `unit_s`: the wall seconds a
    batch or step of the run's untraced window, which the profiler's cost
    on the host does not stretch (None where there was none)."""

    def __init__(self, cfg: dict, units: List[dict], window_s: float,
                 events: List[Tuple[str, float, float]],
                 host_spans: List[Tuple[str, float, float]],
                 unit_s: Optional[float] = None):
        self.cfg = cfg
        self.units = units
        self.window_s = window_s
        self.events = events
        self.host_spans = host_spans
        self.unit_s = unit_s

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged_intervals(self.events)) / 1e6

    def device_seconds(self, pattern) -> Tuple[float, int]:
        """(seconds, count) of device events whose name matches `pattern`
        (a compiled regular expression)."""
        t, n = 0.0, 0
        for name, s, e in self.events:
            if pattern.search(name):
                t += e - s
                n += 1
        return t / 1e6, n


def merged_intervals(events) -> List[Tuple[float, float]]:
    spans = sorted((s, e) for _, s, e in events)
    out: List[Tuple[float, float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def profile_events(prof) -> Tuple[List[Tuple[str, float, float]], List[Tuple[str, float, float]]]:
    """(device events, host events) of a finished torch.profiler run, as
    (name, start_us, end_us).  The device's are its kernels, copies and
    sets; the spans that `record_function` marks on the device's timeline
    (such as the optimizer's step) are neither."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            host.append(row)
        elif not getattr(e, "is_user_annotation", False):
            dev.append(row)
    return dev, host


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device by the innermost host operation that spans each
    gap's middle."""
    by_op: Dict[str, float] = {}
    for name, s, e in trace.events:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    spans = merged_intervals(trace.events)
    host = sorted(trace.host_spans, key=lambda h: h[1])
    mids = sorted((0.5 * (e0 + s1), (s1 - e0) / 1e6)
                  for (_, e0), (s1, _) in zip(spans, spans[1:]))
    gaps: Dict[str, float] = {}
    active: list = []  # heap of (-start, end, name): the latest-starting on top
    i = 0
    for mid, gap in mids:
        while i < len(host) and host[i][1] <= mid:
            heapq.heappush(active, (-host[i][1], host[i][2], host[i][0]))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        key = active[0][2] if active else "(no host operation)"
        gaps[key] = gaps.get(key, 0.0) + gap
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], v] for n, v in ops],
            "idle_gaps": [[n[:200], v] for n, v in idle]}


def process_start_time() -> Optional[float]:
    """The process's start on the `time.time()` clock, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import time

        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None
