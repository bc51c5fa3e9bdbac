# Copy of sema_tpu/utils/__init__.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Observability: per-stage timing, counters, structured logs, profiling.

The reference has none of this (SURVEY.md §5: no tracing/log crate, only
eprintln warnings); it is a required subsystem of the new framework.
"""

from sema_tpu_torch.utils.metrics import Metrics, null_metrics

__all__ = ["Metrics", "null_metrics"]
