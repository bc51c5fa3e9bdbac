# Copy of sema_tpu/types.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Core shared types.

Parity: mirrors the reference's ``src/types/mod.rs:3-60`` (CrawlerConfig,
AppState, UIMode, Chunk, FileIndex, SearchResult) as Python dataclasses.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class CrawlerConfig:
    """Crawl-time options (ref: src/types/mod.rs:4-11).

    ``ignore_gitignore=True`` means .gitignore rules are *honored* (files they
    match are excluded) — the reference wires this flag straight into
    ``ignore::WalkBuilder::git_ignore`` (src/crawler/mod.rs:50), where ``true``
    enables gitignore filtering, despite the name.
    """

    max_file_size: int = 10_485_760
    follow_symlinks: bool = False
    include_hidden: bool = False
    file_extensions: tuple = ()
    exclude_patterns: tuple = ()
    ignore_gitignore: bool = True


class AppState(enum.Enum):
    """Indexing lifecycle states (ref: src/types/mod.rs:27-31)."""

    CRAWLING = "crawling"
    CHUNKING = "chunking"
    READY = "ready"


class UIMode(enum.Enum):
    """TUI focus modes (ref: src/types/mod.rs:34-38)."""

    SEARCH_INPUT = "search_input"
    SEARCH_RESULTS = "search_results"
    FILE_PREVIEW = "file_preview"


@dataclass
class Chunk:
    """A contiguous piece of a file (ref: src/types/mod.rs:41-47).

    ``id`` is ``"{file_path}:{n}"`` with n the per-file chunk ordinal
    (ref: src/storage/processor.rs:62). Line numbers are 1-based and
    inclusive.
    """

    id: str
    file_path: Path
    start_line: int
    end_line: int
    content: str


@dataclass
class FileIndex:
    """Per-file content-hash manifest row (ref: src/types/mod.rs:50-53)."""

    file_path: Path
    hash: str


@dataclass
class SearchResult:
    """One search hit (ref: src/types/mod.rs:56-60).

    After grouping, one result represents a whole file and
    ``total_matches_in_file`` counts the collapsed hits
    (ref: src/tui/engine.rs:156-182).
    """

    chunk: Chunk
    score: float
    total_matches_in_file: int = 1
