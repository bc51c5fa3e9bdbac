"""The port's TUI (``sema_tpu_torch/tui/``, headed copies of
``sema_tpu/tui/``) and its ``Engine``: every test of
``tests/test_tui_logic.py`` on the port (key routing and rendering,
curses-free), the render functions of both packages on the same inputs,
a ``KernelError`` leaving the engine and the app's indexing, the bare
``[DIR]`` default of ``parse_args``, and the real curses path under a pty
on the CPU."""

import json
import os
import pty
import select
import sys
import time
from pathlib import Path

import pytest

import sema_tpu.cli as jax_cli
import sema_tpu.tui.render as jrd
import sema_tpu.types as jtypes
import sema_tpu_torch.types as ptypes
from sema_tpu_torch import cli
from sema_tpu_torch.index.manager import IndexManager
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.search.engine import Engine
from sema_tpu_torch.tui import events as ev
from sema_tpu_torch.tui import render as rd
from sema_tpu_torch.tui.app import TuiApp
from sema_tpu_torch.types import Chunk, SearchResult, UIMode, AppState

REPO = Path(__file__).resolve().parents[1]


def results(n, path_fmt="f{}.py"):
    return [SearchResult(
        chunk=Chunk(id=f"{i}", file_path=Path(path_fmt.format(i)),
                    start_line=i * 10 + 1, end_line=i * 10 + 5,
                    content="c"), score=1.0 - i * 0.01)
        for i in range(n)]


def ready_engine(n=5):
    eng = Engine()
    eng.state = AppState.READY
    eng.search_results = results(n)
    eng.ui_mode = UIMode.SEARCH_RESULTS
    return eng


# -- input state (≙ tui_input) ------------------------------------------------

def test_input_state_editing():
    s = ev.InputState()
    for ch in "abc":
        s.insert(ch)
    s.left(); s.insert("X")
    assert s.text == "abXc" and s.cursor == 3
    s.backspace()
    assert s.text == "abc" and s.cursor == 2
    s.home(); s.delete()
    assert s.text == "bc" and s.cursor == 0
    s.end()
    assert s.cursor == 2


# -- key routing --------------------------------------------------------------

def test_results_per_page():
    # (h-5)/3: matches the renderer's visible rows (body h-3, borders 2)
    # — the reference's (h-2)/3 frame math scrolled the selection out of
    # the rendered window in THIS layout (review finding, r3)
    assert ev.results_per_page(32) == 9
    assert ev.results_per_page(2) == 1     # min 1 (events.rs:26)


def test_enter_in_input_executes_search():
    eng = ready_engine()
    eng.ui_mode = UIMode.SEARCH_INPUT
    inp = ev.InputState(text="hello", cursor=5)
    assert ev.handle_key_ready(ev.KEY_ENTER, eng, inp, 30) is \
        ev.EventResult.EXECUTE_SEARCH


def test_enter_empty_input_continues():
    eng = ready_engine()
    eng.ui_mode = UIMode.SEARCH_INPUT
    inp = ev.InputState(text="   ", cursor=3)
    assert ev.handle_key_ready(ev.KEY_ENTER, eng, inp, 30) is \
        ev.EventResult.CONTINUE


def test_enter_in_results_opens_file():
    eng = ready_engine()
    assert ev.handle_key_ready(ev.KEY_ENTER, eng, ev.InputState(), 30) is \
        ev.EventResult.OPEN_FILE


def test_esc_walks_back_modes():
    eng = ready_engine()
    eng.ui_mode = UIMode.FILE_PREVIEW
    ev.handle_key_ready(ev.KEY_ESC, eng, ev.InputState(), 30)
    assert eng.ui_mode is UIMode.SEARCH_RESULTS
    ev.handle_key_ready(ev.KEY_ESC, eng, ev.InputState(), 30)
    assert eng.ui_mode is UIMode.SEARCH_INPUT
    # in input mode Esc clears (ExecuteSearch with empty text)
    inp = ev.InputState(text="abc", cursor=3)
    assert ev.handle_key_ready(ev.KEY_ESC, eng, inp, 30) is \
        ev.EventResult.EXECUTE_SEARCH
    assert inp.text == ""


def test_tab_cycles_only_with_results():
    eng = ready_engine()
    eng.ui_mode = UIMode.SEARCH_INPUT
    ev.handle_key_ready(ev.KEY_TAB, eng, ev.InputState(), 30)
    assert eng.ui_mode is UIMode.SEARCH_RESULTS
    ev.handle_key_ready(ev.KEY_TAB, eng, ev.InputState(), 30)
    assert eng.ui_mode is UIMode.FILE_PREVIEW
    ev.handle_key_ready(ev.KEY_TAB, eng, ev.InputState(), 30)
    assert eng.ui_mode is UIMode.SEARCH_INPUT

    empty = Engine()
    empty.state = AppState.READY
    empty.ui_mode = UIMode.SEARCH_INPUT
    ev.handle_key_ready(ev.KEY_TAB, empty, ev.InputState(), 30)
    assert empty.ui_mode is UIMode.SEARCH_INPUT  # events.rs:60-69


def test_navigation_and_scroll_clamping():
    eng = ready_engine(20)
    # page = (11-5)/3 = 2 rows visible (renderer geometry)
    for _ in range(5):
        ev.handle_key_ready(ev.KEY_DOWN, eng, ev.InputState(), 11)
    assert eng.selected_search_result == 5
    assert eng.search_results_scroll_offset == 4  # sel - visible + 1
    ev.handle_key_ready(ev.KEY_PGUP, eng, ev.InputState(), 11)
    assert eng.selected_search_result == 3
    ev.handle_key_ready(ev.KEY_PGDN, eng, ev.InputState(), 11)
    assert eng.selected_search_result == 5
    # up beyond 0 clamps
    eng.selected_search_result = 0
    ev.handle_key_ready(ev.KEY_UP, eng, ev.InputState(), 11)
    assert eng.selected_search_result == 0


def test_preview_scrolling():
    eng = ready_engine()
    eng.ui_mode = UIMode.FILE_PREVIEW
    ev.handle_key_ready(ev.KEY_DOWN, eng, ev.InputState(), 30)
    assert eng.file_preview_scroll_offset == 1
    ev.handle_key_ready(ev.KEY_PGDN, eng, ev.InputState(), 30)
    assert eng.file_preview_scroll_offset == 11
    ev.handle_key_ready(ev.KEY_PGUP, eng, ev.InputState(), 30)
    assert eng.file_preview_scroll_offset == 1
    ev.handle_key_ready(ev.KEY_UP, eng, ev.InputState(), 30)
    assert eng.file_preview_scroll_offset == 0


def test_q_quits_outside_input_only():
    """Deviation from events.rs:29 (where q quits even while typing)."""
    eng = ready_engine()
    assert ev.handle_key_ready("q", eng, ev.InputState(), 30) is \
        ev.EventResult.QUIT
    eng.ui_mode = UIMode.SEARCH_INPUT
    inp = ev.InputState()
    assert ev.handle_key_ready("q", eng, inp, 30) is ev.EventResult.CONTINUE
    assert inp.text == "q"


def test_ctrl_c_always_quits():
    eng = ready_engine()
    eng.ui_mode = UIMode.SEARCH_INPUT
    assert ev.handle_key_ready(ev.KEY_CTRL_C, eng, ev.InputState(), 30) is \
        ev.EventResult.QUIT
    assert ev.handle_key_non_ready(ev.KEY_CTRL_C, ev.InputState()) is \
        ev.EventResult.QUIT


def test_non_ready_buffers_typing():
    inp = ev.InputState()
    for ch in "hello":
        ev.handle_key_non_ready(ch, inp)
    assert inp.text == "hello"  # events.rs:176-200


# -- rendering ----------------------------------------------------------------

def test_status_messages_parity():
    title, msg = rd.status_message(AppState.CRAWLING, 0, "")
    assert "Crawling files..." in title and title.startswith(" ⠋")
    title, msg = rd.status_message(AppState.CHUNKING, 1, "")
    assert "Processing files..." in title and "⠙" in title
    title, msg = rd.status_message(AppState.READY, 0, "")
    assert title == " Ready to Search "
    assert "Type your search query" in msg
    _, msg2 = rd.status_message(AppState.READY, 0, "abc")
    assert "refine your query" in msg2


def test_search_box_title():
    assert rd.search_box_title(None, 0, "", UIMode.SEARCH_INPUT) == " Search "
    assert rd.search_box_title("oops", 5, "q", UIMode.SEARCH_INPUT) == \
        " Search - oops "
    assert rd.search_box_title(None, 5, "q", UIMode.SEARCH_INPUT) == \
        " Search - 5 results "
    assert rd.search_box_title(None, 5, "q", UIMode.SEARCH_RESULTS) == " Search "


def test_display_path():
    assert rd.display_path(Path("/srv/x/a.py"), Path("/srv/x")) == "a.py"
    assert rd.display_path(Path("/other/place/deep/a.py"), Path("/srv/x")) \
        == "deep/a.py"
    long = Path("/a/" + "b" * 60 + "/c.py")
    dp = rd.display_path(long, Path("/srv/x"))
    assert dp.startswith("...") and len(dp) == 50


def test_result_rows_badge_and_range():
    rs = results(2)
    rs[0].total_matches_in_file = 3
    rows = rd.result_rows(rs, selected=1, scroll_offset=0, width=40,
                          height=9, base_dir=Path("."))
    assert len(rows) == 6  # 2 results × 3 lines
    # row 0: path, bold (not selected)
    assert rows[0][0] == ("f0.py", rd.S_BOLD)
    # badge on first result
    assert rows[1][0] == ("+3", rd.S_BADGE)
    assert rows[1][-1][0] == "L1-5"
    # selected styling on second result
    assert rows[3][0][1] == rd.S_SELECTED


def test_merge_term_matches_overlap():
    # ui.rs:524-570 overlap merge
    assert rd.merge_term_matches("abcabc", ["abc", "bca"]) == [(0, 6)]
    assert rd.merge_term_matches("xx abc yy", ["abc"]) == [(3, 6)]
    assert rd.merge_term_matches("ABC", ["abc"]) == [(0, 3)]


def test_highlight_terms_splits_spans():
    spans = [("the quick fox", rd.S_DEFAULT)]
    out = rd.highlight_terms(spans, ["quick"])
    assert out == [("the ", rd.S_DEFAULT), ("quick", rd.S_MATCH),
                   (" fox", rd.S_DEFAULT)]


def test_preview_lines_numbers_and_scroll():
    content = "\n".join(f"line{i}" for i in range(1, 21)) + "\n"
    lines = rd.preview_lines(content, Path("f.txt"), scroll_offset=4,
                             visible_lines=3, search_query="hello")
    assert len(lines) == 3
    assert lines[0][0][0].strip().startswith("5")  # 1-based numbering
    # semantic query → no term highlighting
    assert all(tag != rd.S_MATCH for line in lines for _, tag in line)


def test_preview_lines_keyword_highlight():
    lines = rd.preview_lines("foo bar baz\n", Path("f.txt"), 0, 10, "'bar")
    flat = [(t, s) for line in lines for t, s in line]
    assert ("bar", rd.S_MATCH) in flat


def test_preview_highlight_skips_operators_and_exclusions():
    """Operator queries highlight only the positive parsed terms: the
    AND keyword, +/- prefixes, and excluded clauses are never painted."""
    lines = rd.preview_lines("foo AND bar and baz\n", Path("f.txt"),
                             0, 10, "'+foo AND bar -baz")
    flat = [(t, s) for line in lines for t, s in line]
    assert ("foo", rd.S_MATCH) in flat
    assert ("bar", rd.S_MATCH) in flat
    assert all(s != rd.S_MATCH or t.lower() != "baz" for t, s in flat)
    # the literal AND in the content is not a highlighted term
    assert all(s != rd.S_MATCH or t != "AND" for t, s in flat)


def test_preview_empty_file():
    lines = rd.preview_lines("", Path("f.txt"), 0, 10, "")
    assert lines == [[("  1 │ (empty file)", rd.S_DIM)]]


def test_preview_scroll_clamped():
    lines = rd.preview_lines("one\ntwo\n", Path("f.txt"), 999, 10, "")
    assert len(lines) == 1
    assert "two" in "".join(t for t, _ in lines[0])


def test_wrap_spans():
    spans = [("0123456789", rd.S_DEFAULT), ("abcde", rd.S_KW)]
    rows = rd.wrap_spans(spans, 6)
    assert rows == [[("012345", rd.S_DEFAULT)],
                    [("6789", rd.S_DEFAULT), ("ab", rd.S_KW)],
                    [("cde", rd.S_KW)]]
    # width larger than content → single row, styles preserved
    assert rd.wrap_spans(spans, 99) == [spans]


# -- mouse routing (improvement over app.rs:150-158's refocus-only) -----------

class TestMouse:
    W, H = 100, 32  # body_h = 29, left_w = 30

    def test_click_selects_result_row(self):
        eng = ready_engine(8)
        # row i occupies 3 lines starting at y = 1 + 3*i
        changed = ev.handle_mouse(eng, x=5, y=1 + 3 * 2, width=self.W,
                                  height=self.H)
        assert changed and eng.selected_search_result == 2
        assert eng.ui_mode is UIMode.SEARCH_RESULTS

    def test_click_respects_scroll_offset(self):
        eng = ready_engine(30)
        eng.search_results_scroll_offset = 10
        changed = ev.handle_mouse(eng, x=5, y=4, width=self.W, height=self.H)
        assert changed and eng.selected_search_result == 11

    def test_click_preview_focuses_preview(self):
        eng = ready_engine(5)
        changed = ev.handle_mouse(eng, x=60, y=5, width=self.W, height=self.H)
        assert not changed
        assert eng.ui_mode is UIMode.FILE_PREVIEW

    def test_click_search_box_focuses_input(self):
        eng = ready_engine(5)
        changed = ev.handle_mouse(eng, x=5, y=self.H - 2, width=self.W,
                                  height=self.H)
        assert not changed
        assert eng.ui_mode is UIMode.SEARCH_INPUT

    def test_click_same_row_no_resync(self):
        eng = ready_engine(5)
        eng.selected_search_result = 0
        assert not ev.handle_mouse(eng, x=5, y=1, width=self.W, height=self.H)

    def test_click_past_results_clamps(self):
        eng = ready_engine(2)
        assert not ev.handle_mouse(eng, x=5, y=25, width=self.W,
                                   height=self.H)
        assert eng.selected_search_result == 0

    def test_click_ignored_when_not_ready(self):
        eng = Engine()
        eng.state = AppState.CRAWLING
        assert not ev.handle_mouse(eng, x=5, y=4, width=self.W, height=self.H)

    def test_click_without_split_refocuses_input(self):
        eng = ready_engine(5)
        eng.ui_mode = UIMode.SEARCH_INPUT   # no split shown
        assert not ev.handle_mouse(eng, x=5, y=4, width=self.W, height=self.H)
        assert eng.ui_mode is UIMode.SEARCH_INPUT


# -- incremental search (opt-in extension; ref searches only on Enter) --------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TestIncrementalSearch:
    def make(self, debounce_ms=300):
        clk = FakeClock()
        return ev.IncrementalSearch(debounce_ms, clock=clk), clk

    def test_fires_after_debounce(self):
        inc, clk = self.make()
        inc.on_edit("quick")
        assert inc.poll() is None          # too soon
        clk.t = 0.31
        assert inc.poll() == "quick"
        assert inc.poll() is None          # fires once

    def test_keystrokes_reset_window(self):
        inc, clk = self.make()
        inc.on_edit("qu")
        clk.t = 0.2
        inc.on_edit("qui")                 # edit during window resets it
        clk.t = 0.4
        assert inc.poll() is None          # only 0.2s since last edit
        clk.t = 0.61
        assert inc.poll() == "qui"

    def test_enter_suppresses_refire(self):
        inc, clk = self.make()
        inc.on_edit("query text")
        inc.searched("query text")         # user hit Enter first
        clk.t = 1.0
        assert inc.poll() is None

    def test_same_text_not_rescheduled(self):
        inc, clk = self.make()
        inc.on_edit("abc")
        clk.t = 0.31
        assert inc.poll() == "abc"
        clk.t = 1.0
        inc.on_edit("abc")                 # e.g. arrow keys, no text change
        clk.t = 2.0
        assert inc.poll() is None

    def test_edit_after_run_fires_again(self):
        inc, clk = self.make()
        inc.on_edit("abc")
        clk.t = 0.31
        assert inc.poll() == "abc"
        inc.on_edit("abcd")
        clk.t = 0.62
        assert inc.poll() == "abcd"


def test_app_query_gate_counts_utf8_bytes(tmp_path):
    """app.rs:165 gates on query.trim().len() — UTF-8 BYTES: a 2-char CJK
    query (6 bytes) must run, a 2-char ASCII query must clear."""
    from pathlib import Path
    from sema_tpu_torch.config import Config
    from sema_tpu_torch.tui.app import TuiApp

    app = TuiApp(Path(str(tmp_path)), Config())
    ran = []
    app.engine.execute_search = lambda q, limit=50: ran.append(q)
    cleared = []
    app.engine.clear_search = lambda: cleared.append(True)

    app.execute_search("ab")          # 2 bytes -> cleared
    assert cleared and not ran
    app.execute_search("日本")        # 2 chars, 6 bytes -> runs
    assert ran == ["日本"]


# -- preview wrap toggle + horizontal scroll (extension over ui.rs:260) -------

class TestPreviewWrapToggle:
    def test_w_toggles_and_resets_hscroll(self):
        eng = ready_engine(3)
        eng.ui_mode = UIMode.FILE_PREVIEW
        eng.preview_wrap = False
        eng.file_preview_hscroll = 24
        ev.handle_key_ready("w", eng, ev.InputState(), 30)
        assert eng.preview_wrap and eng.file_preview_hscroll == 0
        ev.handle_key_ready("w", eng, ev.InputState(), 30)
        assert not eng.preview_wrap

    def test_arrows_scroll_only_when_unwrapped(self):
        eng = ready_engine(3)
        eng.ui_mode = UIMode.FILE_PREVIEW
        ev.handle_key_ready(ev.KEY_RIGHT, eng, ev.InputState(), 30)
        assert eng.file_preview_hscroll == 0      # wrap on: ignored
        eng.preview_wrap = False
        ev.handle_key_ready(ev.KEY_RIGHT, eng, ev.InputState(), 30)
        ev.handle_key_ready(ev.KEY_RIGHT, eng, ev.InputState(), 30)
        assert eng.file_preview_hscroll == 16
        ev.handle_key_ready(ev.KEY_LEFT, eng, ev.InputState(), 30)
        ev.handle_key_ready(ev.KEY_LEFT, eng, ev.InputState(), 30)
        ev.handle_key_ready(ev.KEY_LEFT, eng, ev.InputState(), 30)
        assert eng.file_preview_hscroll == 0      # clamped

    def test_w_in_input_mode_types(self):
        eng = ready_engine(3)
        eng.ui_mode = UIMode.SEARCH_INPUT
        inp = ev.InputState()
        ev.handle_key_ready("w", eng, inp, 30)
        assert inp.text == "w" and eng.preview_wrap

    def test_file_change_resets_hscroll(self, tmp_path):
        f = tmp_path / "x.txt"
        f.write_text("hello")
        eng = ready_engine(2)
        eng.file_preview_hscroll = 40
        eng.update_current_file_content(f)
        assert eng.file_preview_hscroll == 0


def test_drop_cols_preserves_styles():
    spans = [("abc", rd.S_DIM), ("defg", rd.S_KW)]
    assert rd.drop_cols(spans, 0) == spans
    assert rd.drop_cols(spans, 2) == [("c", rd.S_DIM), ("defg", rd.S_KW)]
    assert rd.drop_cols(spans, 3) == [("defg", rd.S_KW)]
    assert rd.drop_cols(spans, 5) == [("fg", rd.S_KW)]
    assert rd.drop_cols(spans, 99) == []


def test_preview_lines_hscroll_keeps_gutter(tmp_path):
    lines = rd.preview_lines("abcdefghij\nklm", Path("f.txt"), 0, 5, "",
                             hscroll=4)
    # gutter prefix intact, content shifted
    text0 = "".join(t for t, _ in lines[0])
    assert text0.startswith("  1 │ ")
    assert text0.endswith("efghij")
    text1 = "".join(t for t, _ in lines[1])
    assert text1 == "  2 │ "            # short line fully scrolled off


def test_click_past_rendered_page_ignored():
    """Review finding: only (body_h-2)//3 full result rows render; a
    click on the partial band below them must not select an invisible
    result. height=13 -> body_h=10, inner height 8 -> 2 rendered rows
    (y=1..6); y=7..8 is the partial band."""
    eng = ready_engine(30)
    eng.search_results_scroll_offset = 0
    assert not ev.handle_mouse(eng, x=5, y=7, width=100, height=13)
    assert eng.selected_search_result == 0
    assert not ev.handle_mouse(eng, x=5, y=8, width=100, height=13)
    assert eng.selected_search_result == 0
    # y=4 (row 1) is rendered and selects
    assert ev.handle_mouse(eng, x=5, y=4, width=100, height=13)
    assert eng.selected_search_result == 1


# -- the port against the JAX package -----------------------------------------

def both_results(types, n, counts=()):
    out = [types.SearchResult(
        chunk=types.Chunk(id=f"{i}", file_path=Path(f"/t/pkg/m{i}.py"),
                          start_line=i * 7 + 1, end_line=i * 7 + 30,
                          content="c"), score=0.9 - i * 0.05)
        for i in range(n)]
    for r, c in zip(out, counts):
        r.total_matches_in_file = c
    return out


@pytest.mark.parametrize("n, selected, scroll, width, height", [
    (3, 0, 0, 40, 9), (8, 5, 3, 28, 12), (2, 1, 0, 80, 30), (0, 0, 0, 30, 9)])
def test_result_rows_equal_across_packages(n, selected, scroll, width,
                                           height):
    args = (selected, scroll, width, height, Path("/t"))
    assert rd.result_rows(both_results(ptypes, n, (3, 1, 2)), *args) \
        == jrd.result_rows(both_results(jtypes, n, (3, 1, 2)), *args)


PREVIEW = ("def retry(request, backoff=2):\n    # exponential backoff\n"
           "    return request.send(timeout=backoff * 3)\n\n" * 6)


@pytest.mark.parametrize("path, scroll, visible, query, hscroll", [
    ("m.py", 0, 10, "retry the request", 0),
    ("m.py", 3, 5, "'backoff", 0),
    ("m.txt", 2, 8, "'+retry AND request -timeout", 4),
    ("m.md", 99, 4, "", 0),
    ("empty.py", 0, 3, "'x", 0)])
def test_preview_lines_equal_across_packages(path, scroll, visible, query,
                                             hscroll):
    content = "" if path == "empty.py" else PREVIEW
    args = (content, Path(path), scroll, visible, query)
    assert rd.preview_lines(*args, hscroll=hscroll) == \
        jrd.preview_lines(*args, hscroll=hscroll)


@pytest.mark.parametrize("spans, terms", [
    ([("the quick fox", rd.S_DEFAULT)], ["quick"]),
    ([("abcabc", rd.S_KW), ("ABC xx", rd.S_STR)], ["abc", "bca"]),
    ([("no match here", rd.S_DEFAULT)], ["zzz"])])
def test_highlight_terms_equal_across_packages(spans, terms):
    assert rd.highlight_terms(spans, terms) == jrd.highlight_terms(spans,
                                                                   terms)


@pytest.mark.parametrize("state", ["CRAWLING", "CHUNKING", "READY"])
@pytest.mark.parametrize("frame, text", [(0, ""), (5, "abc")])
def test_status_message_equal_across_packages(state, frame, text):
    assert rd.status_message(AppState[state], frame, text) == \
        jrd.status_message(jtypes.AppState[state], frame, text)


ARGVS = [[], ["."], ["some/dir", "--include-hidden", "--model", "gte-large"],
         ["--exclude", "a,b"], ["tui", "x", "--follow-symlinks"],
         ["index", "x", "--reindex", "--stats"], ["index"],
         ["query", "text", "--limit", "5", "--group"],
         ["serve", "x", "--port", "1", "--reindex-interval", "2"],
         ["doctor"], ["doctor", "--skip-quality", "--weights", "w"],
         ["bench"], ["bench", "--config", "c", "--model", "gte-large"]]


@pytest.mark.parametrize("argv", ARGVS, ids=" ".join)
def test_parse_args_routes_like_the_jax_cli(argv):
    """The same argv reaches the same command with the same flags; the
    port adds --device (default cuda) to every command that runs one."""
    got = vars(cli.parse_args(argv))
    want = vars(jax_cli.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want


def test_bench_names_the_tools_and_exits_2(monkeypatch, capsys):
    """``bench`` is a command, not the TUI on a directory named bench: it
    says the harness is not written yet, names the tools and exits 2."""
    def no_tui(args):
        raise AssertionError("bench started the TUI")
    monkeypatch.setattr(cli, "cmd_tui", no_tui)
    assert cli.main(["bench", "--config", "minilm-10k"]) == 2
    err = capsys.readouterr().err
    assert "not written yet" in err
    for tool in ("load_test", "ivf_bench", "spill_ivf_bench"):
        assert f"python -m sema_tpu_torch.tools.{tool}" in err


# -- a KernelError is a fault, never a failed search --------------------------

def test_engine_raises_a_kernel_error_and_captures_the_rest(monkeypatch):
    mgr = IndexManager.__new__(IndexManager)
    eng = Engine(index_manager=mgr, state=AppState.READY)

    def kernel_fails(self, query, limit):
        raise KernelError("kernel build failed: planted")
    monkeypatch.setattr(IndexManager, "search", kernel_fails)
    with pytest.raises(KernelError, match="planted"):
        eng.execute_search("retry the request")
    assert eng.search_error is None

    def value_fails(self, query, limit):
        raise ValueError("bad query")
    monkeypatch.setattr(IndexManager, "search", value_fails)
    eng.execute_search("retry the request")
    assert eng.search_error == "Search failed: bad query"


class _Manager:
    """An IndexManager stand-in for run_indexing: ``fail`` names the step
    that raises ``error``."""

    def __init__(self, fail, error):
        self.fail, self.error = fail, error
        self.vector_store = type("Store", (), {"live_rows": 3})()

    def process_and_index_files(self, files, progress=None,
                                purge_missing_under=None):
        if self.fail == "index":
            raise self.error

    def search(self, query, limit):
        if self.fail == "warmup":
            raise self.error
        return []


@pytest.mark.parametrize("step", ["crawl", "index", "warmup"])
@pytest.mark.parametrize("error", [KernelError("kernel build failed: x"),
                                   ValueError("not a kernel")],
                         ids=["KernelError", "ValueError"])
def test_run_indexing_raises_only_a_kernel_error(step, error, tmp_path,
                                                 monkeypatch):
    """A KernelError of the crawl, the index or the warm-up leaves
    run_indexing; anything else keeps the JAX app's behaviour (the
    warm-up's is dropped, the rest becomes index_error), and the app
    comes up READY."""
    from sema_tpu_torch import crawl
    from sema_tpu_torch.config import Config

    def crawl_directory(self, directory):
        if step == "crawl":
            raise error
        return []
    monkeypatch.setattr(crawl.FileCrawler, "crawl_directory",
                        crawl_directory)
    monkeypatch.setattr(cli, "make_index_manager",
                        lambda config, device: _Manager(step, error))
    monkeypatch.setattr(TuiApp, "_pump", lambda self, stdscr: None)
    app = TuiApp(tmp_path, Config(), "cpu")
    if isinstance(error, KernelError):
        with pytest.raises(KernelError, match="kernel build failed"):
            app.run_indexing(None)
        return
    app.run_indexing(None)
    assert app.engine.state is AppState.READY
    if step == "warmup":
        assert app.index_error is None
        assert app.engine.index_manager is not None
    else:
        assert app.index_error == "not a kernel"
        assert app.engine.search_error == "Indexing failed: not a kernel"


# -- the curses path under a pty ----------------------------------------------

# The TUI in a fresh process: the app's indexing and searches note what
# they did in a log (argv[1]); argv[2] plants a KernelError in the index or
# in the searches after the warm-up; the rest is the CLI's argv.
_RUNNER = r"""
import json, sys
from sema_tpu_torch import cli
from sema_tpu_torch.index.manager import IndexManager
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.tui.app import TuiApp
log = open(sys.argv[1], "a", buffering=1)
fault = sys.argv[2]

def planted(*args, **kwargs):
    raise KernelError("kernel build failed: planted")

if fault == "index":
    IndexManager.process_and_index_files = planted
run_indexing, execute_search = TuiApp.run_indexing, TuiApp.execute_search

def indexed(self, stdscr):
    run_indexing(self, stdscr)
    if fault == "search":
        IndexManager.search = planted
    log.write(json.dumps({"event": "ready", "error": self.index_error})
              + "\n")

def searched(self, query):
    execute_search(self, query)
    log.write(json.dumps({
        "event": "search", "query": query,
        "error": self.engine.search_error,
        "files": [str(r.chunk.file_path)
                  for r in self.engine.search_results]}) + "\n")

TuiApp.run_indexing, TuiApp.execute_search = indexed, searched
sys.exit(cli.main(sys.argv[3:]))
"""


def tui_session(tmp_path, fault, timeout=60.0):
    """Run the bare CLI (the TUI) over a 3-file tree on the CPU with
    test-tiny under a pty: once READY, type a semantic query and Enter,
    then 'q' once it has answered. Returns (exit code, the terminal's
    output, the log's events)."""
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "net.py").write_text(
        "def retry(request):\n    # exponential backoff on failure\n"
        "    return request.send()\n" * 4)
    (tree / "parse.md").write_text("# Parsing\nTokens become a tree.\n" * 5)
    (tree / "cache.txt").write_text("An LRU cache evicts the oldest key.\n"
                                    * 6)
    home = tmp_path / "home"
    home.mkdir()
    (home / "config.toml").write_text('[model]\nname = "test-tiny"\n')
    log = tmp_path / "events.jsonl"
    env = dict(os.environ, SEMA_TPU_HOME=str(home),
               SEMA_TPU_DATA=str(tmp_path / "data"), TERM="xterm-256color",
               COLUMNS="100", LINES="30", PYTHONPATH=str(REPO))
    pid, fd = pty.fork()
    if pid == 0:
        os.chdir(REPO)
        os.execvpe(sys.executable, [sys.executable, "-c", _RUNNER, str(log),
                                    fault, str(tree), "--device", "cpu"],
                   env)
    out, sent, status = b"", [], None
    deadline = time.monotonic() + timeout
    try:
        while status is None and time.monotonic() < deadline:
            if select.select([fd], [], [], 0.1)[0]:
                try:
                    out += os.read(fd, 65536)
                except OSError:
                    pass
            events = ([json.loads(line) for line in log.read_text()
                       .splitlines()] if log.exists() else [])
            kinds = [e["event"] for e in events]
            if "ready" in kinds and "query" not in sent:
                os.write(fd, b"exponential backoff\r")
                sent.append("query")
            if "search" in kinds and "quit" not in sent:
                os.write(fd, b"q")
                sent.append("quit")
            done, code = os.waitpid(pid, os.WNOHANG)
            if done:
                status = code
    finally:
        if status is None:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
        os.close(fd)
    assert status is not None, f"no exit within {timeout} s: {out[-2000:]}"
    return os.waitstatus_to_exitcode(status), out.decode(errors="replace"), \
        events


def test_tui_indexes_answers_and_quits_under_a_pty(tmp_path):
    code, out, events = tui_session(tmp_path, fault="none")
    assert code == 0, out[-2000:]
    ready, search = events
    assert ready == {"event": "ready", "error": None}
    assert search["query"] == "exponential backoff"
    assert search["error"] is None and search["files"]
    assert search["files"][0].endswith("net.py")
    assert "Search Results (" in out


@pytest.mark.parametrize("fault", ["index", "search"])
def test_tui_ends_non_zero_on_a_kernel_error(tmp_path, fault):
    """A KernelError of the startup index or of a search ends the TUI with
    exit code 1 and the kernel's message once curses has restored the
    terminal; the app shows no "Indexing failed" or "Search failed"."""
    code, out, events = tui_session(tmp_path, fault=fault)
    assert code == 1, out[-2000:]
    assert "Error: a CUDA kernel failed: kernel build failed: planted" in out
    assert "Indexing failed" not in out and "Search failed" not in out
    assert [e["event"] for e in events] == (["ready"] if fault == "search"
                                             else [])
