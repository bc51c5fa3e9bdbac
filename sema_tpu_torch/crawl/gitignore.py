# Copy of sema_tpu/crawl/gitignore.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Gitignore pattern matching.

Implements the core of .gitignore semantics, the subset exercised by the
reference's use of the ``ignore`` crate (src/crawler/mod.rs:44-57):

- comments (``#``) and blank lines are skipped;
- ``!`` negates (re-includes); the *last* matching rule wins;
- a trailing ``/`` makes the pattern directory-only;
- a pattern containing a non-trailing ``/`` is anchored to the directory
  holding the .gitignore; otherwise it matches at any depth below it;
- ``*`` matches anything except ``/``; ``?`` matches one non-``/`` char;
  ``**`` spans directory separators (leading ``**/``, trailing ``/**``,
  and infix ``/**/`` forms);
- character classes ``[...]`` are passed through.

Matching is performed against paths *relative to the .gitignore's directory*
using ``/`` separators.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple


def _glob_to_regex(pattern: str, anchored: bool) -> str:
    """Translate one gitignore glob into a Python regex (full-path match)."""
    out = []
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            # backslash escapes the next char ('\#notes', '\!bang',
            # trailing '\ '): match it literally — without this the
            # escaped rule compiled to a regex requiring a literal
            # backslash and could never match anything
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "*":
            if pattern.startswith("**", i):
                # Collapse any run of * beyond the double.
                j = i
                while j < n and pattern[j] == "*":
                    j += 1
                if i == 0 and j < n and pattern[j] == "/":
                    out.append("(?:[^/]+/)*")   # leading "**/"
                    j += 1
                elif j == n:
                    out.append(".*")            # trailing "**"
                elif pattern[j] == "/" and out and out[-1] == "/":
                    # infix "/**/": zero or more whole directories
                    out.pop()
                    out.append("/(?:[^/]+/)*")
                    j += 1
                else:
                    out.append(".*")
                i = j
                continue
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        elif c == "[":
            j = pattern.find("]", i + 1)
            if j == -1:
                out.append(re.escape(c))
            else:
                cls = pattern[i + 1:j]
                neg = cls.startswith("!")
                if neg:
                    cls = cls[1:]
                out.append("[" + ("^" if neg else "") + cls.replace("\\", "\\\\") + "]")
                i = j
        else:
            out.append(re.escape(c))
        i += 1
    body = "".join(out)
    prefix = "" if anchored else "(?:[^/]+/)*"
    return prefix + body


@dataclass
class _Rule:
    regex: re.Pattern
    negated: bool
    dir_only: bool


class GitignoreMatcher:
    """Rules from one .gitignore file (or an explicit pattern list)."""

    def __init__(self, patterns: List[str]):
        self.rules: List[_Rule] = []
        for raw in patterns:
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            # Trailing spaces are stripped unless backslash-escaped.
            line = re.sub(r"(?<!\\) +$", "", line)
            negated = line.startswith("!")
            if negated:
                line = line[1:]
            dir_only = line.endswith("/")
            if dir_only:
                line = line[:-1]
            if not line:
                continue
            anchored = line.startswith("/") or "/" in line
            if line.startswith("/"):
                line = line[1:]
            try:
                rx = re.compile(_glob_to_regex(line, anchored) + r"\Z")
            except re.error:
                continue
            self.rules.append(_Rule(rx, negated, dir_only))

    def match(self, rel_path: str, is_dir: bool) -> Optional[bool]:
        """Return True (ignored) / False (re-included) / None (no rule hit)
        for ``rel_path`` relative to this matcher's directory."""
        verdict: Optional[bool] = None
        for rule in self.rules:
            if rule.dir_only and not is_dir:
                continue
            if rule.regex.match(rel_path):
                verdict = not rule.negated
        return verdict


class GitignoreStack:
    """Per-directory matchers collected while descending a tree.

    ``frames`` holds (depth_prefix, matcher) pairs where ``depth_prefix`` is
    the path of the directory containing the .gitignore, relative to the
    crawl root ("" for the root itself).
    """

    def __init__(self):
        self.frames: List[Tuple[str, GitignoreMatcher]] = []
        # .gitignore files from ANCESTORS of the crawl root (outermost
        # first): each carries the root's path relative to ITS directory,
        # prepended before matching — ≙ the ignore crate's parents(true)
        # default the reference relies on (crawler/mod.rs:44)
        self.ancestors: List[Tuple[str, GitignoreMatcher]] = []

    def push_ancestor(self, root_prefix: str,
                      matcher: GitignoreMatcher) -> None:
        self.ancestors.append((root_prefix, matcher))

    def push(self, dir_rel: str, matcher: GitignoreMatcher) -> None:
        self.frames.append((dir_rel, matcher))

    def pop_to(self, dir_rel: str) -> None:
        """Drop frames that are not ancestors of ``dir_rel``."""
        def is_ancestor(a: str, b: str) -> bool:
            return a == "" or b == a or b.startswith(a + "/")
        self.frames = [f for f in self.frames if is_ancestor(f[0], dir_rel)]

    def ignored(self, rel_path: str, is_dir: bool) -> bool:
        """Deepest .gitignore wins; within one file the last rule wins."""
        verdict = False
        for prefix, matcher in self.ancestors:
            sub = f"{prefix}/{rel_path}" if prefix else rel_path
            hit = matcher.match(sub, is_dir)
            if hit is not None:
                verdict = hit
        for dir_rel, matcher in self.frames:
            if dir_rel == "":
                sub = rel_path
            elif rel_path == dir_rel or not rel_path.startswith(dir_rel + "/"):
                continue
            else:
                sub = rel_path[len(dir_rel) + 1:]
            hit = matcher.match(sub, is_dir)
            if hit is not None:
                verdict = hit
        return verdict
