# Copy of sema_tpu/search/engine.py with imports renamed and a KernelError raised out of execute_search; tests/test_torch_imports.py checks it for drift.
"""Search engine state machine (≙ reference ``Engine``, src/tui/engine.rs).

Headless by design: the reference keeps all mutable search/UI state in
``Engine`` with the TUI as a thin shell (engine.rs/ui.rs split); we keep the
same seam so the engine is testable without a terminal (SURVEY.md §4).

Parity notes:

- SEARCH_RESULTS_LIMIT = 50 (engine.rs:11);
- queries of <= 2 chars are rejected before reaching the engine in the
  reference (app.rs:165); enforced here so every frontend inherits it;
- result grouping: one row per file carrying the earliest chunk by
  start_line and the file's total match count, rows sorted by score
  descending (engine.rs:156-182). The reference's order is nondeterministic
  for tied scores (HashMap iteration); we tie-break on path;
- file preview content: 1 MiB cap with a "File too large to display
  (N.N MB)" message; read errors degrade to a message (engine.rs:184-196);
- search errors are captured into ``search_error``, not raised
  (engine.rs:147-149).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.types import AppState, SearchResult, UIMode

SEARCH_RESULTS_LIMIT = 50          # engine.rs:11
MIN_QUERY_BYTES = 3                # app.rs:165 rejects query.trim().len() <= 2
                                   # (Rust str::len counts UTF-8 BYTES, so a
                                   # 1-char CJK query passes the gate there)
PREVIEW_MAX_BYTES = 1_048_576      # engine.rs:186


def group_results_by_file(results: List[SearchResult]) -> List[SearchResult]:
    """engine.rs:156-182, deterministic tie-break added."""
    groups: Dict[Path, List[SearchResult]] = {}
    for r in results:
        groups.setdefault(r.chunk.file_path, []).append(r)

    grouped: List[SearchResult] = []
    for group in groups.values():
        group.sort(key=lambda r: r.chunk.start_line)
        first = group[0]
        first.total_matches_in_file = len(group)
        grouped.append(first)

    grouped.sort(key=lambda r: (-r.score, str(r.chunk.file_path)))
    return grouped


@dataclass
class Engine:
    index_manager: object = None      # IndexManager; None until initialized
    state: AppState = AppState.CRAWLING
    ui_mode: UIMode = UIMode.SEARCH_INPUT
    should_quit: bool = False
    spinner_frame: int = 0

    search_results: List[SearchResult] = field(default_factory=list)
    selected_search_result: int = 0
    search_results_scroll_offset: int = 0
    file_preview_scroll_offset: int = 0
    # extensions beyond the reference (ratatui wraps unconditionally,
    # ui.rs:260): 'w' in preview mode toggles soft wrap; with wrap off,
    # left/right scroll the content horizontally
    preview_wrap: bool = True
    file_preview_hscroll: int = 0
    current_search_query: str = ""
    search_error: Optional[str] = None

    current_file_content: Optional[str] = None
    current_file_path: Optional[Path] = None

    def clear_search(self) -> None:
        """engine.rs:64-73."""
        self.search_results = []
        self.selected_search_result = 0
        self.search_results_scroll_offset = 0
        self.current_search_query = ""
        self.search_error = None
        self.current_file_content = None
        self.current_file_path = None
        self.ui_mode = UIMode.SEARCH_INPUT

    def execute_search(self, query: str,
                       limit: int = SEARCH_RESULTS_LIMIT) -> None:
        """engine.rs:102-154 with the app.rs:165 length gate folded in."""
        query = query.strip()
        if len(query.encode("utf-8")) < MIN_QUERY_BYTES:
            return
        self.search_error = None
        if self.index_manager is None:
            self.search_error = "Failed to initialize search"
            return
        try:
            raw = self.index_manager.search(query, limit)
        except KernelError:
            raise   # a kernel that does not build or launch is a fault,
            #         never a failed search
        except Exception as e:  # noqa: BLE001 — parity: capture, don't raise
            self.search_error = f"Search failed: {e}"
            return
        # recorded only on SUCCESS: a failed search keeps the previous
        # results on screen, and recording the failed query first made
        # the stale preview highlight the failed query's terms
        self.current_search_query = query
        results = [SearchResult(chunk=c, score=s) for c, s in raw]
        self.search_results = group_results_by_file(results)
        self.selected_search_result = 0
        self.search_results_scroll_offset = 0
        if self.search_results and self.ui_mode is UIMode.SEARCH_INPUT:
            self.ui_mode = UIMode.SEARCH_RESULTS

    # -- preview -----------------------------------------------------------

    @staticmethod
    def load_file_content(file_path: Path) -> str:
        """engine.rs:184-196."""
        try:
            size = file_path.stat().st_size
            if size > PREVIEW_MAX_BYTES:
                return f"File too large to display ({size / 1_048_576.0:.1f} MB)"
            return file_path.read_text(errors="replace")
        except OSError as e:
            return f"Failed to read file: {e}"

    def update_current_file_content(self, file_path: Path) -> None:
        """engine.rs:198-205."""
        self.current_file_content = self.load_file_content(Path(file_path))
        self.current_file_path = Path(file_path)
        self.file_preview_hscroll = 0

    def selected_result(self) -> Optional[SearchResult]:
        if not self.search_results:
            return None
        idx = min(self.selected_search_result, len(self.search_results) - 1)
        return self.search_results[idx]
