# Copy of sema_tpu/tui/__init__.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Curses TUI (≙ reference src/tui/: ratatui app loop, events, rendering)."""
