# Copy of sema_tpu/search/__init__.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Headless search engine state (the testable seam under the TUI)."""

from sema_tpu_torch.search.engine import Engine, group_results_by_file

__all__ = ["Engine", "group_results_by_file"]
