"""One general generator and runner for each kind of traffic
(`kind` in a traffic file under `portbench/traffic/`).  A runner takes a
`Run` and returns a `Result`; it measures the program and leaves the
reference's comparison to `check`, which it runs after the window, once
the program's state is freed."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class Run:
    cell: str
    cfg_tree: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    #: Called as the first timed batch or step starts: the end of set-up.
    on_timed: Callable[[], None] = lambda: None


@dataclass
class Result:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    #: The comparison with the reference: name -> (reading, limit or None).
    checks: Dict[str, tuple] = field(default_factory=dict)
    #: The traced window (`harness.Trace`), with `--trace 1`.
    trace: Optional[Any] = None
    memory_peak_bytes: int = 0
    notes: List[str] = field(default_factory=list)
