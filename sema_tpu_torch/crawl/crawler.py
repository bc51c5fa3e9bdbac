# Copy of sema_tpu/crawl/crawler.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Gitignore-aware directory crawler.

Parity with the reference's ``src/crawler/mod.rs``:

- honors per-directory ``.gitignore`` files when ``ignore_gitignore=True``
  (the flag *enables* gitignore filtering — it feeds
  ``WalkBuilder::git_ignore`` directly, crawler/mod.rs:50);
- skips hidden entries (dotfiles/dirs) unless ``include_hidden``
  (crawler/mod.rs:47);
- does not cross filesystem boundaries (``same_file_system(true)``,
  crawler/mod.rs:51);
- symlinks are not followed unless ``follow_symlinks``; when following,
  cycles are broken by (st_dev, st_ino) ancestor tracking
  (crawler/mod.rs:46);
- keeps only regular files with 0 < size <= max_file_size
  (crawler/mod.rs:84-86);
- extension allow-list: each configured extension is normalized by stripping
  ``*.``/``.`` prefixes and lowercasing; files with no extension are rejected
  whenever the list is non-empty (crawler/mod.rs:28-42, 88-100);
- exclude patterns: the reference *intends* to exclude its configured
  patterns but passes them to ``WalkBuilder::add_ignore`` as file *paths*
  (crawler/mod.rs:53-55), which silently does nothing. We implement the
  intent: a path is excluded when any path component — or the root-relative
  path — glob-matches a pattern.

Results are returned in sorted order for determinism (the reference's walk
order is unspecified).

The C++ native backend (sema_tpu/native) implements the same walk with
parallel directory listing; used automatically when built.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Set, Tuple

from sema_tpu_torch.crawl.gitignore import GitignoreMatcher, GitignoreStack
from sema_tpu_torch.types import CrawlerConfig


def _normalize_extensions(extensions) -> Optional[Set[str]]:
    """Ref crawler/mod.rs:28-42: strip '*.'/'.' prefixes, lowercase."""
    if not extensions:
        return None
    out = set()
    for ext in extensions:
        e = ext
        if e.startswith("*."):
            e = e[2:]
        e = e.lstrip(".")
        out.add(e.lower())
    return out


class FileCrawler:
    def __init__(self, config: CrawlerConfig):
        self.config = config
        self._extensions = _normalize_extensions(config.file_extensions)
        self._exclude = list(config.exclude_patterns)
        self._exclude_rx: dict = {}

    def crawl_directory(self, root_path: Path | str,
                        use_native: Optional[bool] = None) -> List[Path]:
        """Walk ``root_path`` and return the files to index, sorted."""
        root = Path(root_path)
        if use_native is not False:
            try:
                from sema_tpu_torch.native import crawl_native
            except ImportError:
                if use_native:
                    raise
            else:
                return [Path(p) for p in crawl_native(str(root), self.config)]
        return self._crawl_python(root)

    # -- pure-Python walk ---------------------------------------------------

    def _pattern_regex(self, pattern: str):
        """Exclude patterns use the same glob dialect as .gitignore rules
        ('*' does NOT cross '/') — matching the C++ backend's glob_match.
        fnmatch's '.*'-style '*' silently excluded whole subtrees for
        path-shaped patterns like 'docs/*.md' (review finding, r3)."""
        rx = self._exclude_rx.get(pattern)
        if rx is None:
            import re
            from sema_tpu_torch.crawl.gitignore import _glob_to_regex
            try:
                rx = re.compile(_glob_to_regex(pattern, anchored=True)
                                + r"\Z")
            except re.error:
                rx = re.compile(r"(?!)")   # malformed: match nothing
            self._exclude_rx[pattern] = rx
        return rx

    def _excluded(self, rel_path: str, name: str) -> bool:
        for pattern in self._exclude:
            rx = self._pattern_regex(pattern)
            if rx.match(name) or rx.match(rel_path):
                return True
            if "/" not in pattern:
                for part in rel_path.split("/"):
                    if rx.match(part):
                        return True
        return False

    @staticmethod
    def _ancestor_gitignores(root: Path, stack: GitignoreStack) -> None:
        """Collect .gitignore files from the crawl root's ANCESTORS
        (outermost pushed first — nearer files win by stack order),
        stopping at the repository boundary (the first ancestor that
        contains ``.git``, itself included). ≙ the ignore crate's
        parents(true) default: indexing ``repo/src`` must still honor
        ``repo/.gitignore`` (review finding, r3)."""
        chain = []
        cur = root
        prefix_parts: List[str] = []
        while True:
            try:
                if (cur / ".git").exists():
                    break   # repository boundary: nothing above applies
            except OSError:
                break
            parent = cur.parent
            if parent == cur:
                break
            prefix_parts.insert(0, cur.name)
            cur = parent
            gi = cur / ".gitignore"
            try:
                if gi.is_file():
                    chain.insert(0, ("/".join(prefix_parts),
                                     gi.read_text(errors="replace")
                                     .splitlines()))
            except OSError:
                pass
        for prefix, lines in chain:
            stack.push_ancestor(prefix, GitignoreMatcher(lines))

    def _crawl_python(self, root: Path) -> List[Path]:
        cfg = self.config
        files: List[Path] = []
        try:
            root_dev = root.stat().st_dev
        except OSError:
            return files

        stack = GitignoreStack()
        if cfg.ignore_gitignore:
            self._ancestor_gitignores(root, stack)
        # (st_dev, st_ino) of the CURRENT ancestor chain only — cycle
        # breaking, not global dedup: a directory reachable via two
        # distinct non-cyclic paths (sibling symlinks) is indexed under
        # both, as the reference's walker does (crawler/mod.rs:46).
        # The walk is an explicit stack: a pathological ~1000-deep tree
        # must not hit Python's recursion limit (both review findings,
        # r3). Work items: ("enter", path, rel) / ("exit", key).
        ancestors: Set[Tuple[int, int]] = set()
        work: list = [("enter", root, "")]
        while work:
            item = work.pop()
            if item[0] == "exit":
                ancestors.discard(item[1])
                continue
            _, dir_path, dir_rel = item
            if cfg.follow_symlinks:
                try:
                    st = dir_path.stat()
                except OSError:
                    continue
                key = (st.st_dev, st.st_ino)
                if key in ancestors:
                    continue   # symlink cycle
                ancestors.add(key)
                work.append(("exit", key))

            stack.pop_to(dir_rel)
            if cfg.ignore_gitignore:
                gi = dir_path / ".gitignore"
                try:
                    if gi.is_file():
                        stack.push(dir_rel, GitignoreMatcher(
                            gi.read_text(errors="replace").splitlines()))
                except OSError:
                    pass

            try:
                entries = sorted(os.scandir(dir_path), key=lambda e: e.name)
            except OSError:
                continue

            subdirs = []
            for entry in entries:
                name = entry.name
                rel = f"{dir_rel}/{name}" if dir_rel else name
                if not cfg.include_hidden and name.startswith("."):
                    continue
                if self._excluded(rel, name):
                    continue
                try:
                    is_symlink = entry.is_symlink()
                    is_dir = entry.is_dir(follow_symlinks=cfg.follow_symlinks)
                    is_file = entry.is_file(follow_symlinks=cfg.follow_symlinks)
                except OSError:
                    continue
                if is_symlink and not cfg.follow_symlinks:
                    # ignore-crate behavior: unfollowed symlinks are yielded
                    # but fail metadata.is_file() → dropped (crawler/mod.rs:84)
                    continue
                if is_dir:
                    if cfg.ignore_gitignore and stack.ignored(rel, is_dir=True):
                        continue
                    try:
                        if entry.stat(follow_symlinks=cfg.follow_symlinks).st_dev != root_dev:
                            continue  # same_file_system(true)
                    except OSError:
                        continue
                    subdirs.append(("enter", Path(entry.path), rel))
                elif is_file:
                    if cfg.ignore_gitignore and stack.ignored(rel, is_dir=False):
                        continue
                    try:
                        size = entry.stat(follow_symlinks=cfg.follow_symlinks).st_size
                    except OSError:
                        continue
                    if size == 0 or size > cfg.max_file_size:
                        continue
                    if self._extensions is not None:
                        dot = name.rfind(".")
                        if dot <= 0:
                            continue
                        if name[dot + 1:].lower() not in self._extensions:
                            continue
                    files.append(Path(entry.path))
            # LIFO: push reversed so subdirs pop in sorted order
            work.extend(reversed(subdirs))

        return sorted(files)
