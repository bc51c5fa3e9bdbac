# Copy of sema_tpu/utils/hfcache.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""HF hub cache resolution shared by the weight and tokenizer loaders
(was duplicated in models/loader.py and tokenizer/wordpiece.py —
review finding, r3)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def hf_cache_snapshot(repo: str) -> Optional[Path]:
    """Locate the newest cached HF snapshot dir for ``repo`` without
    network access (``HF_HUB_CACHE`` > ``HF_HOME``/hub > default)."""
    cache = Path(os.environ.get(
        "HF_HUB_CACHE",
        Path(os.environ.get("HF_HOME",
                            Path.home() / ".cache" / "huggingface"))
        / "hub"))
    snaps = cache / ("models--" + repo.replace("/", "--")) / "snapshots"
    if not snaps.is_dir():
        return None
    try:
        candidates = sorted(snaps.iterdir(), key=lambda p: p.stat().st_mtime)
    except OSError:
        return None
    return candidates[-1] if candidates else None
