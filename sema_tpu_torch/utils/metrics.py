# Copy of sema_tpu/utils/metrics.py with imports renamed and torch.profiler in trace(); tests/test_torch_imports.py checks it for drift.
"""Per-stage timing + counters + structured logging.

Covers SURVEY.md §5's observability plan: crawl/chunk/tokenize/embed/write
stage timers, files/chunks/QPS counters, p50/p99 latency percentiles, and a
one-line JSON report. ``torch.profiler`` trace capture is exposed for deep
dives (``SEMA_TPU_TRACE_DIR`` or the ``trace()`` context manager).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List


def _percentile(samples, p: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(int(round(p / 100 * (len(s) - 1))), len(s) - 1)
    return s[idx]


# percentile window per stage: unbounded sample lists leaked memory in
# the serve daemon (every query appends 3+ floats to the process-global
# null_metrics(); review finding, r3). Totals/counters stay exact.
SAMPLE_WINDOW = 8192


class Metrics:
    def __init__(self, log_stream=None):
        self.stage_time: Dict[str, float] = defaultdict(float)
        self.stage_samples: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=SAMPLE_WINDOW))
        self.counters: Dict[str, int] = defaultdict(int)
        self._log = log_stream

    @contextlib.contextmanager
    def timer(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stage_time[stage] += dt
            self.stage_samples[stage].append(dt)
            if self._log is not None:
                self.log_event("stage", stage=stage, seconds=round(dt, 6))

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def log_event(self, event: str, **fields) -> None:
        if self._log is not None:
            print(json.dumps({"event": event, "ts": time.time(), **fields}),
                  file=self._log, flush=True)

    def percentile(self, stage: str, p: float) -> float:
        return _percentile(self.stage_samples[stage], p)

    def report(self) -> dict:
        return {
            "stages_s": {k: round(v, 6) for k, v in self.stage_time.items()},
            "p50_s": {k: round(_percentile(v, 50), 6)
                      for k, v in self.stage_samples.items()},
            "p99_s": {k: round(_percentile(v, 99), 6)
                      for k, v in self.stage_samples.items()},
            "counters": dict(self.counters),
        }


_NULL = None


def null_metrics() -> Metrics:
    """Shared no-logging Metrics (still accumulates, costs ~nothing)."""
    global _NULL
    if _NULL is None:
        _NULL = Metrics()
    return _NULL


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a torch.profiler trace (view in Perfetto/chrome://tracing)."""
    import torch

    log_dir = log_dir or os.environ.get("SEMA_TPU_TRACE_DIR", "/tmp/sema_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        print(f"trace written to {log_dir}", file=sys.stderr)
