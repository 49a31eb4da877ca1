"""Structured step metrics + profiler hooks.

The reference profiles distributed runs post-hoc by mining Giraph logs for
per-superstep wall times and message counts (``utils/SuperstepTimes.java:
14-45``, ``utils/LogProcess.java:19-45``).  Here metrics are first-class:
every superstep/loop records wall time and byte counts directly, and
``trace_profile`` wraps a region in a ``jax.profiler`` trace for on-device
inspection.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StepMetrics:
    """Per-superstep records: the SuperstepTimes/LogProcess replacement."""

    steps: List[Dict] = field(default_factory=list)
    _t0: Optional[float] = None

    @contextlib.contextmanager
    def step(self, name: str, **extra):
        t0 = time.time()
        rec = {"step": name, **extra}
        try:
            yield rec
        finally:
            rec["seconds"] = time.time() - t0
            self.steps.append(rec)

    def record(self, name: str, seconds: float, **extra) -> None:
        self.steps.append({"step": name, "seconds": seconds, **extra})

    def total_seconds(self) -> float:
        return sum(s.get("seconds", 0.0) for s in self.steps)

    def bucket_histogram(self, bucket: float = 1.0) -> Dict[int, int]:
        """Wall-time histogram, the SuperstepTimes bucket view."""
        out: Dict[int, int] = {}
        for s in self.steps:
            b = int(s.get("seconds", 0.0) / bucket)
            out[b] = out.get(b, 0) + 1
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for s in self.steps:
                f.write(json.dumps(s) + "\n")


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]):
    """jax.profiler trace when a logdir is given, no-op otherwise."""
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
