# Copy of sema_tpu/tui/render.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Rendering logic (≙ reference src/tui/ui.rs), kept curses-free.

Produces abstract "spans" — (text, style_tag) pairs — that the curses layer
maps to terminal attributes, so layout/highlighting logic is unit-testable
headlessly (the reference's Engine/UI seam, SURVEY.md §4).

Parity with ui.rs:

- 30/70 results/preview split (ui.rs:13), 3-line result rows: bold display
  path (+N yellow badge), right-aligned L{start}-{end}, separator rule
  (ui.rs:152-204);
- status screen with 8-frame braille spinner and the exact state messages
  (ui.rs:483-522);
- preview: line numbers `{n:>w} │ `, scroll clamped to the last line,
  syntax highlighting (pygments here, syntect there), search terms
  highlighted with overlap merging ONLY for '-prefixed keyword queries
  (ui.rs:318-331, 524-588);
- search box title carries errors or the result count (ui.rs:447-455);
- display paths: relative to the crawl root, else last two components
  ellipsized past 50 chars (ui.rs:590-617).

Improvement: the reference reloads the entire syntect SyntaxSet and
ThemeSet on every frame (ui.rs:299-300); we cache pygments lexers per path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from sema_tpu_torch.types import AppState, SearchResult, UIMode

Span = Tuple[str, str]  # (text, style_tag)

SPINNER_CHARS = "⠋⠙⠹⠸⠼⠴⠦⠧"  # ui.rs:519-522

# style tags understood by the curses layer
S_DEFAULT, S_DIM, S_BOLD = "default", "dim", "bold"
S_SELECTED, S_BADGE, S_MATCH = "selected", "badge", "match"
S_KW, S_STR, S_COM, S_NUM, S_NAME = "kw", "str", "com", "num", "name"


def spinner_char(frame: int) -> str:
    return SPINNER_CHARS[frame % len(SPINNER_CHARS)]


def status_message(state: AppState, frame: int,
                   search_input: str) -> Tuple[str, str]:
    """ui.rs:483-517 verbatim."""
    if state is AppState.CRAWLING:
        return (f" {spinner_char(frame)} Crawling files... ",
                "Discovering files in the directory.\n"
                "You can type your search query now.")
    if state is AppState.CHUNKING:
        return (f" {spinner_char(frame)} Processing files... ",
                "Breaking files into searchable chunks.\n"
                "Almost ready for search!")
    if not search_input:
        return (" Ready to Search ",
                "Type your search query and press Enter\n"
                "to search through indexed files.")
    return (" Ready to Search ",
            "Press Enter to execute search, or\n"
            "continue typing to refine your query.")


def search_box_title(search_error: Optional[str], n_results: int,
                     input_text: str, ui_mode: UIMode) -> str:
    """ui.rs:444-455."""
    if search_error:
        return f" Search - {search_error} "
    if n_results and input_text.strip() and ui_mode is UIMode.SEARCH_INPUT:
        return f" Search - {n_results} results "
    return " Search "


def display_path(file_path: Path, base_dir: Path) -> str:
    """ui.rs:590-617."""
    try:
        return str(file_path.relative_to(base_dir))
    except ValueError:
        parts = file_path.parts
        if len(parts) >= 2:
            dp = f"{parts[-2]}/{parts[-1]}"
            if len(dp) > 50:
                return "..." + dp[-47:]
            return dp
        return file_path.name


def result_rows(results: Sequence[SearchResult], selected: int,
                scroll_offset: int, width: int, height: int,
                base_dir: Path) -> List[List[Span]]:
    """3-line rows for the visible page (ui.rs:137-204). ``width``/``height``
    are the inner (borderless) dimensions."""
    per_page = max(height // 3, 1)
    start = scroll_offset
    end = min(start + per_page, len(results))
    lines: List[List[Span]] = []
    avail = max(width - 2, 0)
    for i in range(start, end):
        r = results[i]
        is_sel = i == selected
        path = display_path(r.chunk.file_path, base_dir)
        badge = (f"+{r.total_matches_in_file}"
                 if r.total_matches_in_file > 1 else "")
        line_range = f"L{r.chunk.start_line}-{r.chunk.end_line}"
        pad = max(avail - len(badge) - len(line_range), 0)

        lines.append([(path[:avail], S_SELECTED if is_sel else S_BOLD)])
        info: List[Span] = []
        if badge:
            info.append((badge, S_BADGE))
        info.append((" " * pad, S_DEFAULT))
        info.append((line_range, S_DIM))
        lines.append(info)
        lines.append([("─" * avail, S_DIM)])
    return lines


def merge_term_matches(text: str, terms: Sequence[str]
                       ) -> List[Tuple[int, int]]:
    """Find all case-insensitive term occurrences and merge overlaps
    (ui.rs:524-570)."""
    low = text.lower()
    if len(low) != len(text):
        # rare scripts where lowercasing changes string LENGTH (e.g.
        # 'İ'.lower() is two chars) would shift every offset found in
        # `low` relative to `text` — fall back to casefold-free matching
        # rather than painting highlights off by a column
        low = text
    matches: List[Tuple[int, int]] = []
    for term in terms:
        t = term.lower()
        if not t:
            continue
        if len(t) != len(term):
            t = term
        pos = 0
        while True:
            idx = low.find(t, pos)
            if idx == -1:
                break
            matches.append((idx, idx + len(t)))
            pos = idx + 1
    matches.sort()
    merged: List[Tuple[int, int]] = []
    for start, end in matches:
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(end, merged[-1][1]))
        else:
            merged.append((start, end))
    return merged


def highlight_terms(spans: List[Span], terms: Sequence[str]) -> List[Span]:
    """Split spans at term boundaries, tagging matches (ui.rs:524-588)."""
    out: List[Span] = []
    for text, style in spans:
        merged = merge_term_matches(text, terms)
        if not merged:
            out.append((text, style))
            continue
        pos = 0
        for start, end in merged:
            if start > pos:
                out.append((text[pos:start], style))
            out.append((text[start:end], S_MATCH))
            pos = end
        if pos < len(text):
            out.append((text[pos:], style))
    return out


_LEXER_CACHE: Dict[str, object] = {}


def _lexer_for(file_path: Path, content: str):
    # suffix-less files (Makefile, Dockerfile) resolve by NAME — caching
    # them under the shared '' suffix key highlighted every such file
    # with whichever lexer was resolved first
    key = file_path.suffix.lower() or file_path.name
    if key not in _LEXER_CACHE:
        try:
            from pygments.lexers import get_lexer_for_filename
            _LEXER_CACHE[key] = get_lexer_for_filename(str(file_path))
        except Exception:  # noqa: BLE001 — unknown types fall back to plain
            _LEXER_CACHE[key] = None
    return _LEXER_CACHE[key]


# one-entry memo of the last tokenized preview: draw runs every 100 ms
# idle tick, and re-running pygments over a large file each frame pinned
# the CPU and lagged the event loop behind keystrokes. Keyed by content
# identity + path; the TUI previews one file at a time.
_SYNTAX_MEMO: Dict[str, object] = {}


def _style_for_token(tok) -> str:
    from pygments.token import (Comment, Keyword, Name, Number, Operator,
                                String)
    if tok in Comment:
        return S_COM
    if tok in Keyword:
        return S_KW
    if tok in String:
        return S_STR
    if tok in Number:
        return S_NUM
    if tok in Name.Function or tok in Name.Class:
        return S_NAME
    return S_DEFAULT


def _syntax_lines(content: str, file_path: Path) -> List[List[Span]]:
    """Per-line pygments spans; plain text when no lexer matches."""
    lines = content.split("\n")
    lexer = _lexer_for(file_path, content)
    if lexer is None:
        return [[(line, S_DEFAULT)] for line in lines]
    out: List[List[Span]] = [[]]
    try:
        for tok, text in lexer.get_tokens(content):
            style = _style_for_token(tok)
            pieces = text.split("\n")
            for j, piece in enumerate(pieces):
                if j > 0:
                    out.append([])
                if piece:
                    out[-1].append((piece, style))
    except Exception:  # noqa: BLE001
        return [[(line, S_DEFAULT)] for line in lines]
    # pygments may emit a trailing newline; align to source line count
    while len(out) > len(lines):
        out.pop()
    while len(out) < len(lines):
        out.append([])
    return out


def wrap_spans(spans: List[Span], width: int) -> List[List[Span]]:
    """Soft-wrap one spans-line into display rows of at most ``width``
    columns (≙ ratatui Paragraph Wrap{trim:false}, ui.rs:260)."""
    if width <= 0:
        return [spans]
    rows: List[List[Span]] = [[]]
    used = 0
    for text, style in spans:
        while text:
            space = width - used
            if space == 0:
                rows.append([])
                used = 0
                space = width
            piece = text[:space]
            rows[-1].append((piece, style))
            used += len(piece)
            text = text[space:]
    return rows


def drop_cols(spans: List[Span], n: int) -> List[Span]:
    """Drop the first ``n`` display columns from a spans-line (the
    horizontal-scroll transform for unwrapped previews)."""
    if n <= 0:
        return spans
    out: List[Span] = []
    for text, style in spans:
        if n >= len(text):
            n -= len(text)
            continue
        out.append((text[n:], style) if n else (text, style))
        n = 0
    return out


def preview_lines(content: str, file_path: Path, scroll_offset: int,
                  visible_lines: int, search_query: str,
                  hscroll: int = 0) -> List[List[Span]]:
    """ui.rs:285-438: numbered, scrolled, syntax+term highlighted lines.

    ``hscroll`` drops leading columns of the CONTENT (line-number gutter
    stays put) — used by the no-wrap preview mode, an extension over the
    reference's always-wrapping ratatui Paragraph."""
    if not content:
        return [[("  1 │ (empty file)", S_DIM)]]

    is_semantic = not search_query.strip().startswith("'")
    terms: List[str] = []
    if not is_semantic:
        # highlight the POSITIVE side of the parsed query (matching is
        # case-insensitive, so the analyzer's lowercase tokens are
        # fine): operators (AND/OR), +/- prefixes, and excluded clauses
        # must not be painted as matches — "+cat -dog" highlights cat
        # occurrences, never dog or a literal "+cat"
        from sema_tpu_torch.index.text_index import _parse_query
        q = _parse_query(search_query.strip().removeprefix("'"))
        terms = list(dict.fromkeys(q.score_terms))

    lines = content.split("\n")
    if lines and lines[-1] == "":
        lines = lines[:-1] or [""]
    total = len(lines)
    safe_scroll = min(scroll_offset, max(total - 1, 0))
    # gutter width from the file's LAST line number: total+scroll grew
    # the gutter a column mid-scroll and shifted every visible line
    num_width = max(len(str(total)), 3)

    memo_key = (str(file_path), id(content), len(content), content[:256])
    if _SYNTAX_MEMO.get("key") == memo_key:
        highlighted = _SYNTAX_MEMO["lines"]
    else:
        highlighted = _syntax_lines("\n".join(lines), file_path)
        _SYNTAX_MEMO["key"] = memo_key
        _SYNTAX_MEMO["lines"] = highlighted
    out: List[List[Span]] = []
    for i in range(safe_scroll, min(safe_scroll + visible_lines, total)):
        prefix = f"{i + 1:>{num_width}} │ "
        spans: List[Span] = [(prefix, S_DIM)]
        content_spans = highlighted[i] or [("", S_DEFAULT)]
        if terms:
            content_spans = highlight_terms(list(content_spans), terms)
        if hscroll:
            content_spans = drop_cols(list(content_spans), hscroll)
        spans.extend(content_spans)
        out.append(spans)
    return out
