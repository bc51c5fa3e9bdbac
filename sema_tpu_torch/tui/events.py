# Copy of sema_tpu/tui/events.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Key routing (≙ reference src/tui/events.rs) — pure logic, no curses.

Parity notes:

- results_per_page = max((terminal_height - 5) / 3, 1) — 3-line result rows
  sized to THIS layout's rendered window (≙ events.rs:26's intent; see
  results_per_page docstring);
- Enter: SearchInput → ExecuteSearch (non-empty input); Results/Preview →
  OpenFile (events.rs:30-45);
- Esc walks back Preview → Results → Input; in Input it clears the query
  (events.rs:46-59, an empty ExecuteSearch triggers clear, app.rs:164-168);
- Tab cycles modes, only when there are results (events.rs:60-69);
- Up/Down/PgUp/PgDn: selection + scroll clamping in Results; line/10-line
  scrolling in Preview (events.rs:70-147, 202-212);
- Ctrl-C always quits. The reference also quits on a bare ``q`` even while
  typing in the search box (events.rs:29 precedes the Char input arm —
  you cannot type the letter q into a query). Deviation: we only quit on
  ``q`` outside SearchInput, and route it into the input otherwise;
- while indexing (non-Ready), typing is buffered into the search box and
  only quit keys act (events.rs:176-200).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from sema_tpu_torch.types import AppState, UIMode


class EventResult(enum.Enum):
    CONTINUE = "continue"
    EXECUTE_SEARCH = "execute_search"
    OPEN_FILE = "open_file"
    QUIT = "quit"


@dataclass
class InputState:
    """≙ tui_input::Input — text buffer + cursor."""

    text: str = ""
    cursor: int = 0

    def insert(self, ch: str) -> None:
        self.text = self.text[:self.cursor] + ch + self.text[self.cursor:]
        self.cursor += len(ch)

    def backspace(self) -> None:
        if self.cursor > 0:
            self.text = self.text[:self.cursor - 1] + self.text[self.cursor:]
            self.cursor -= 1

    def delete(self) -> None:
        self.text = self.text[:self.cursor] + self.text[self.cursor + 1:]

    def left(self) -> None:
        self.cursor = max(0, self.cursor - 1)

    def right(self) -> None:
        self.cursor = min(len(self.text), self.cursor + 1)

    def home(self) -> None:
        self.cursor = 0

    def end(self) -> None:
        self.cursor = len(self.text)

    def reset(self) -> None:
        self.text = ""
        self.cursor = 0


# abstract key names produced by the curses layer
KEY_ENTER, KEY_ESC, KEY_TAB = "enter", "esc", "tab"
KEY_UP, KEY_DOWN, KEY_PGUP, KEY_PGDN = "up", "down", "pgup", "pgdn"
KEY_LEFT, KEY_RIGHT, KEY_HOME, KEY_END = "left", "right", "home", "end"
KEY_BACKSPACE, KEY_DELETE, KEY_CTRL_C = "backspace", "delete", "ctrl_c"


def results_per_page(terminal_height: int) -> int:
    """Visible 3-line result rows: must match the RENDERER's geometry
    (body = h - 3 for the search box, minus 2 border rows — app.py
    draw / render.result_rows), not the reference's (h-2)/3
    (events.rs:26, a different frame layout): with the larger keyboard
    page the selection scrolled one row past the visible window and
    navigation went blind (review finding, r3)."""
    return max((max(terminal_height - 5, 0)) // 3, 1)


def update_scroll_offset(selected: int, scroll_offset: int,
                         visible: int) -> int:
    """events.rs:202-212."""
    if selected < scroll_offset:
        return selected
    if selected >= scroll_offset + visible:
        return selected - visible + 1
    return scroll_offset


def handle_key_ready(key: str, engine, inp: InputState,
                     terminal_height: int) -> EventResult:
    """Key routing in the Ready state (events.rs:15-174)."""
    per_page = results_per_page(terminal_height)
    mode = engine.ui_mode
    n = len(engine.search_results)

    if key == KEY_CTRL_C:
        return EventResult.QUIT
    if key == "q" and mode is not UIMode.SEARCH_INPUT:
        return EventResult.QUIT

    if key == KEY_ENTER:
        if mode is UIMode.SEARCH_INPUT:
            if inp.text.strip():
                return EventResult.EXECUTE_SEARCH
            return EventResult.CONTINUE
        if engine.selected_result() is not None:
            return EventResult.OPEN_FILE
        return EventResult.CONTINUE

    if key == KEY_ESC:
        if mode is UIMode.FILE_PREVIEW:
            engine.ui_mode = UIMode.SEARCH_RESULTS
        elif mode is UIMode.SEARCH_RESULTS:
            engine.ui_mode = UIMode.SEARCH_INPUT
        else:
            inp.reset()
            return EventResult.EXECUTE_SEARCH  # empty → clear (app.rs:164-168)
        return EventResult.CONTINUE

    if key == KEY_TAB:
        if n > 0:
            engine.ui_mode = {
                UIMode.SEARCH_INPUT: UIMode.SEARCH_RESULTS,
                UIMode.SEARCH_RESULTS: UIMode.FILE_PREVIEW,
                UIMode.FILE_PREVIEW: UIMode.SEARCH_INPUT,
            }[mode]
        return EventResult.CONTINUE

    if key == KEY_UP:
        if mode is UIMode.SEARCH_RESULTS and engine.selected_search_result > 0:
            engine.selected_search_result -= 1
            engine.search_results_scroll_offset = update_scroll_offset(
                engine.selected_search_result,
                engine.search_results_scroll_offset, per_page)
        elif mode is UIMode.FILE_PREVIEW and engine.file_preview_scroll_offset > 0:
            engine.file_preview_scroll_offset -= 1
        return EventResult.CONTINUE

    if key == KEY_DOWN:
        if mode is UIMode.SEARCH_RESULTS and engine.selected_search_result < max(n - 1, 0):
            engine.selected_search_result += 1
            engine.search_results_scroll_offset = update_scroll_offset(
                engine.selected_search_result,
                engine.search_results_scroll_offset, per_page)
        elif mode is UIMode.FILE_PREVIEW and engine.selected_result() is not None:
            engine.file_preview_scroll_offset += 1
        return EventResult.CONTINUE

    if key == KEY_PGUP:
        if mode is UIMode.SEARCH_RESULTS:
            engine.selected_search_result = max(
                engine.selected_search_result - per_page, 0)
            engine.search_results_scroll_offset = update_scroll_offset(
                engine.selected_search_result,
                engine.search_results_scroll_offset, per_page)
        elif mode is UIMode.FILE_PREVIEW:
            engine.file_preview_scroll_offset = max(
                engine.file_preview_scroll_offset - 10, 0)
        return EventResult.CONTINUE

    if key == KEY_PGDN:
        if mode is UIMode.SEARCH_RESULTS:
            engine.selected_search_result = min(
                engine.selected_search_result + per_page, max(n - 1, 0))
            engine.search_results_scroll_offset = update_scroll_offset(
                engine.selected_search_result,
                engine.search_results_scroll_offset, per_page)
        elif mode is UIMode.FILE_PREVIEW:
            engine.file_preview_scroll_offset += 10
        return EventResult.CONTINUE

    if mode is UIMode.FILE_PREVIEW:
        # extensions beyond the reference (it always wraps, ui.rs:260):
        # 'w' toggles soft wrap; with wrap off, ←/→ scroll horizontally
        HSTEP = 8
        if key == "w":
            engine.preview_wrap = not engine.preview_wrap
            engine.file_preview_hscroll = 0
            return EventResult.CONTINUE
        if not engine.preview_wrap and key == KEY_LEFT:
            engine.file_preview_hscroll = max(
                engine.file_preview_hscroll - HSTEP, 0)
            return EventResult.CONTINUE
        if not engine.preview_wrap and key == KEY_RIGHT:
            engine.file_preview_hscroll += HSTEP
            return EventResult.CONTINUE

    if mode is UIMode.SEARCH_INPUT:
        if key == KEY_BACKSPACE:
            inp.backspace()
        elif key == KEY_DELETE:
            inp.delete()
        elif key == KEY_LEFT:
            inp.left()
        elif key == KEY_RIGHT:
            inp.right()
        elif key == KEY_HOME:
            inp.home()
        elif key == KEY_END:
            inp.end()
        elif len(key) == 1 and key.isprintable():
            inp.insert(key)
    return EventResult.CONTINUE


def handle_mouse(engine, x: int, y: int, width: int,
                 height: int, split_in_input: bool = False) -> bool:
    """Left-click routing — pure layout math, mirrors TuiApp.draw.

    The reference only refocuses the search box on any click
    (app.rs:150-158); here a click additionally focuses the pane it lands
    in and selects the clicked result row (3-line rows, ui.rs:110-211) —
    a documented usability improvement over the reference. Returns True
    when the selection changed (the caller syncs the file preview)."""
    if engine.state is not AppState.READY or not engine.search_results:
        return False
    body_h = height - 3
    # with incremental search the split stays visible during input
    # (TuiApp.draw), so clicks land on it in SEARCH_INPUT mode too
    in_split = (engine.ui_mode is not UIMode.SEARCH_INPUT
                or split_in_input)
    if y >= body_h or not in_split:
        engine.ui_mode = UIMode.SEARCH_INPUT   # reference behavior
        return False
    left_w = max(width * 30 // 100, 20)
    if x < left_w:
        engine.ui_mode = UIMode.SEARCH_RESULTS
        if 1 <= y <= body_h - 2:
            row = (y - 1) // 3
            idx = engine.search_results_scroll_offset + row
            # bound by the RENDERED page too: (body_h-2)//3 full rows are
            # drawn, and a click on the partial last band past them must
            # not select an invisible result (review finding)
            per_page = max((body_h - 2) // 3, 1)
            if (row < per_page
                    and 0 <= idx < len(engine.search_results)
                    and idx != engine.selected_search_result):
                engine.selected_search_result = idx
                return True
        return False
    engine.ui_mode = UIMode.FILE_PREVIEW
    return False


class IncrementalSearch:
    """Debounced search-as-you-type (opt-in, ``[tui] incremental_search``).

    The reference searches only on Enter (events.rs:30-37); this is a
    documented usability extension, off by default. Pure logic with an
    injectable clock so tests don't sleep: ``on_edit`` records the latest
    input text, ``poll`` returns it once the debounce window has elapsed
    (at most once per distinct text), ``searched`` marks a query as
    already executed (e.g. by an explicit Enter) so it won't re-fire."""

    def __init__(self, debounce_ms: int = 300, clock=None):
        import time
        self.debounce_s = debounce_ms / 1000.0
        self._clock = clock or time.monotonic
        self._pending: str | None = None
        self._edit_t = 0.0
        self._last_run: str | None = None

    def on_edit(self, text: str) -> None:
        if text == self._last_run:
            self._pending = None
            return
        if text != self._pending:
            self._pending = text
            self._edit_t = self._clock()

    def searched(self, text: str) -> None:
        self._last_run = text
        if self._pending == text:
            self._pending = None

    def poll(self) -> str | None:
        if self._pending is None:
            return None
        if self._clock() - self._edit_t < self.debounce_s:
            return None
        q = self._pending
        self._pending = None
        self._last_run = q
        return q


def handle_key_non_ready(key: str, inp: InputState) -> EventResult:
    """Key routing while indexing (events.rs:176-200)."""
    if key == KEY_CTRL_C:
        # the reference also quits on bare q here (events.rs:178) — but
        # OUR status screen invites type-ahead ("type your search query
        # now"), and a query containing the letter q aborted indexing
        # mid-batch (review finding, r3). Same deviation as ready-mode
        # SearchInput: q types, Ctrl-C quits.
        return EventResult.QUIT
    if key == KEY_BACKSPACE:
        inp.backspace()
    elif key == KEY_DELETE:
        inp.delete()
    elif key == KEY_LEFT:
        inp.left()
    elif key == KEY_RIGHT:
        inp.right()
    elif key == KEY_HOME:
        inp.home()
    elif key == KEY_END:
        inp.end()
    elif len(key) == 1 and key.isprintable():
        inp.insert(key)
    return EventResult.CONTINUE
