# Copy of sema_tpu/crawl/__init__.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Host-side directory crawling (gitignore-aware)."""

from sema_tpu_torch.crawl.crawler import FileCrawler
from sema_tpu_torch.crawl.gitignore import GitignoreMatcher

__all__ = ["FileCrawler", "GitignoreMatcher"]
