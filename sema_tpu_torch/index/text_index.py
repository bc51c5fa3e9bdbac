# Copy of sema_tpu/index/text_index.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""BM25 full-text index, disk-resident.

Replaces the reference's Tantivy index (src/storage/text_indexer.rs):

- tokenization matches tantivy's ``default`` analyzer: split on
  non-alphanumeric, lowercase, drop tokens longer than 40 chars;
- scoring is BM25 with the Lucene constants k1=1.2, b=0.75 over an
  OR-of-terms query, the behavior of ``QueryParser`` + ``TopDocs`` at
  text_indexer.rs:81-83; quoted phrases require all terms adjacent in
  order, answered from v3 positional postings (≙ tantivy's PhraseQuery
  — index-native, content untouched for rejected candidates; legacy v2
  segments fall back to per-candidate content re-tokenization);
- real scores are returned (text_indexer.rs:144-153 keeps them, unlike
  the semantic path);
- ``commit()`` persists to disk; the index reopens incrementally
  (text_indexer.rs:159-162).

Storage is tantivy-shaped (text_indexer.rs:58-73: immutable mmap'd
segments, content left on disk): one immutable binary segment per commit
batch (format in text_segment.py), accessed by mmap/pread — host RSS is
O(segments + tombstone bitmaps), NOT O(corpus), so the 10M/100M-chunk
configs fit. Tombstones are per-segment ``.del`` bitmap sidecars (a
delete is O(log n_files + rows-of-file) via the segment's sorted
file-run table — never a corpus scan); segments merge Lucene-log-style
(MERGE_FANOUT same-tier neighbors collapse into the next tier, so commit
cost stays O(batch) amortized and a 10M-doc index holds ~O(log) small
segments plus sealed TARGET_DOCS-sized ones); past 25% global dead the
index compacts the tombstoned segments on open. Pre-v2 indexes (round-1
single-file JSON/bin and round-2 JSON/bin segment formats, both
backends) migrate on first open.

Two interchangeable compute engines over the SAME on-disk format:
``TextIndex`` scores with numpy over the mmaps (the semantics oracle)
and ``NativeTextIndex`` dispatches tokenize+build+search to C++
(native/text_index.cpp, ≙ tantivy's role as the native full-text
engine). The parity suite asserts identical rankings and scores.
"""

from __future__ import annotations

import json
import math
import os
import re
import struct
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from sema_tpu_torch.index.text_segment import Segment, write_segment
from sema_tpu_torch.types import Chunk
from sema_tpu_torch.utils.fsio import atomic_write_json as _atomic_write_json


def _locked(fn):
    """Serialize a method behind the instance's RLock. The text index
    is mutated by the serve daemon's re-index thread while HTTP threads
    run keyword searches (sema-tpu serve --reindex-interval); the
    segment list and tombstone bitmaps need the coarse lock — searches
    are sub-ms, so contention is negligible."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        with self._lock:
            return fn(self, *a, **kw)
    return wrapper


K1 = 1.2
B = 0.75
MAX_TOKEN_LEN = 40  # tantivy default analyzer's RemoveLongFilter(40)
_COMPACT_DEAD_FRACTION = 0.25


# tantivy SimpleTokenizer splits on non-alphanumeric (unicode-aware);
# '_' is NOT alphanumeric in Rust, so "foo_bar" → ["foo", "bar"]
_SPLIT_RE = re.compile(r"[^\W_]+", re.UNICODE)

# ^boost (tantivy grammar): unsigned decimal. _QBOOST_RE matches right
# after a closing quote (longest digits(.digits) run); _SBOOST_RE is
# the end-anchored bare-clause suffix form. The C++ parser mirrors both
# character for character.
# [0-9], not \d: \d matches Unicode digits ('٢') that float() parses
# but the C++ engine's ASCII isdigit rejects — the engines would parse
# the same query differently (review finding, r3)
_QBOOST_RE = re.compile(r"\^([0-9]+(?:\.[0-9]+)?)")
_SBOOST_RE = re.compile(r"\^([0-9]+(?:\.[0-9]+)?)$")


def tokenize(text: str) -> List[str]:
    """tantivy default analyzer: alphanumeric runs, lowercased, ≤40 chars.

    Lowercasing is SIMPLE (per-codepoint): the ~100 characters whose
    full lowercase EXPANDS ('İ' → 'i̇') keep their original codepoint —
    the C++ engine's single-cp table cannot express expansions, and a
    full-mapping Python engine diverged from it on both the emitted
    term and the 40-char length check (review finding, r3; cross-engine
    segment opens require identical analysis)."""
    out = []
    for m in _SPLIT_RE.finditer(text):
        raw = m.group(0)
        tok = raw.lower()
        if len(tok) != len(raw):
            tok = "".join(c if len(cl := c.lower()) != 1 else cl
                          for c in raw)
        if len(tok) <= MAX_TOKEN_LEN:
            out.append(tok)
    return out


class _Query:
    """Parsed keyword query (the tantivy QueryParser subset both
    engines implement — the shared grammar spec lives here; the C++
    parser in native/text_index.cpp mirrors it token for token):

    - a clause is ``[+|-]`` immediately followed by a word-run or a
      ``"quoted phrase"``; ``+`` = MUST, ``-`` = MUST_NOT, plain =
      SHOULD (tantivy's default OR-of-terms);
    - a clause may carry a ``^boost`` suffix (tantivy grammar:
      ``term^2``, ``"a b"^1.5``) — an unsigned decimal immediately
      after the word-run / closing quote; it multiplies the BM25
      contribution of the clause's scoring tokens (MUST_NOT and
      ``path:`` clauses ignore the value but still strip the suffix).
      A malformed suffix (``foo^x``) is not a boost and tokenizes as
      plain text, preserving the historical parse;
    - standalone UPPERCASE ``AND`` promotes its adjacent SHOULD bare
      clauses to MUST (≙ tantivy's infix AND); ``OR`` is a no-op (OR is
      already the default occur);
    - bare/``+`` phrases keep this engine's established REQUIRED-filter
      semantics; ``-"phrase"`` excludes its matches;
    - scoring = sum of BM25 contributions of SHOULD+MUST term tokens
      (phrase tokens included), accumulated in clause order then phrase
      order — bit-identical to the historical OR-of-terms scores for
      operator-free queries. MUST_NOT tokens never score;
    - a multi-token clause (``+foo_bar`` tokenizes to two terms)
      applies its occur to the SET of its tokens: MUST requires all,
      MUST_NOT excludes docs containing all;
    - a query with no scoring tokens (pure negative) matches nothing
      (tantivy: a lone must_not clause matches no documents);
    - operators inside quotes are plain terms; lowercase and/or are
      plain terms (the analyzer lowercases them);
    - clause boundaries are ASCII whitespace (both engines — C++
      ``isspace``); a non-ASCII space glues its neighbors into one
      multi-token clause;
    - ``path:`` field clauses (the one queryable non-default field —
      the reference indexes ``path`` as TEXT, text_indexer.rs:32, so
      tantivy's parser accepts ``path:term`` even though the default
      field list is just ``content``): ``path:term``, ``+path:term``
      and ``path:"quoted path"`` FILTER on the file-path's analyzer
      tokens (``src/foo_bar.py`` → ``src foo bar py``) — bare and
      ``+`` require the clause (all its tokens present; a quoted path
      phrase must appear as consecutive path tokens in order),
      ``-path:…`` excludes. Path clauses never score and never
      highlight; a query consisting ONLY of path requirements matches
      the filtered docs with score 0.0 in global doc order. BOUNDARY
      vs tantivy: tantivy scores path matches with BM25 over the path
      field and treats bare ``path:x`` as SHOULD; this engine pins
      path clauses to filter semantics (deterministic content-only
      scores, the useful behavior for code search). Field names are
      case-sensitive like tantivy's; anything other than ``path:``
      (including ``id:`` — stored but not indexed in the reference
      schema) is NOT a field and tokenizes as plain terms;
    - KNOWN BOUNDARY vs tantivy: queries MIXING AND with OR use flat
      adjacent-clause promotion, not tantivy's precedence-nested
      boolean tree — ``alpha OR beta AND gamma`` promotes beta and
      gamma to MUST globally, where tantivy parses
      ``alpha OR (beta AND gamma)``. Parentheses are not implemented
      either.
    """

    __slots__ = ("score_terms", "must_sets", "not_sets",
                 "req_phrases", "not_phrases", "path_must", "path_not",
                 "score_boosts")

    def __init__(self, score_terms, must_sets, not_sets,
                 req_phrases, not_phrases, path_must=None, path_not=None,
                 score_boosts=None):
        self.score_terms = score_terms
        self.must_sets = must_sets
        self.not_sets = not_sets
        self.req_phrases = req_phrases
        self.not_phrases = not_phrases
        # path field clauses: lists of (tokens, is_phrase); is_phrase
        # requires the tokens consecutive in order within the path's
        # token sequence, plain clauses require mere containment
        self.path_must = path_must or []
        self.path_not = path_not or []
        # per-score-term boost multipliers, parallel to score_terms
        # (1.0 = unboosted; scores are bit-identical to the pre-boost
        # engine because c * 1.0 == c exactly)
        self.score_boosts = (score_boosts if score_boosts is not None
                             else [1.0] * len(score_terms))

    @property
    def has_filters(self) -> bool:
        return bool(self.must_sets or self.not_sets
                    or self.req_phrases or self.not_phrases
                    or self.path_must or self.path_not)


def _parse_query(query: str) -> _Query:
    """Parse into a :class:`_Query`. Quote pairing is a sequential
    ``find('"')`` scan (identical to the C++ engine; an unmatched
    trailing quote stays in the bare part and tokenizes away)."""
    # a literal \x01 in user input would collide with the phrase
    # placeholder below and silently change AND promotion — sanitize
    # (mirrored in the C++ parser)
    query = query.replace("\x01", " ")
    req_phrases: List[List[str]] = []
    req_pboosts: List[float] = []
    not_phrases: List[List[str]] = []
    path_must: List[Tuple[List[str], bool]] = []
    path_not: List[Tuple[List[str], bool]] = []
    bare = ""
    pos = 0
    while True:
        open_ = query.find('"', pos)
        close = query.find('"', open_ + 1) if open_ >= 0 else -1
        if open_ < 0 or close < 0:
            bare += query[pos:]
            break
        pre = query[pos:open_]
        # field prefix binds tighter than the occur char: +path:"a b".
        # The prefix must start at a token boundary: `filepath:"a b"`
        # is NOT a path clause (the docstring grammar says only `path:`
        # is a field) — a bare endswith() silently turned such queries
        # into impossible path filters (review finding, r3)
        # boundary rule (byte-identical in both engines): preceded by
        # the start or an ASCII non-word char; any non-ASCII char also
        # blocks (C++ sees it as an opaque UTF-8 byte)
        is_path = (pre.endswith("path:")
                   and (len(pre) == 5
                        or not (pre[-6].isalnum() or pre[-6] == "_"
                                or ord(pre[-6]) >= 0x80)))
        if is_path:
            pre = pre[:-5]
        occ = ""
        if pre and pre[-1] in "+-":
            occ = pre[-1]
            pre = pre[:-1]
        pt = tokenize(query[open_ + 1:close])
        # ^boost immediately after the closing quote ("a b"^1.5);
        # longest digits(.digits) run, consumed whether used or not
        pos = close + 1
        boost = 1.0
        mb = _QBOOST_RE.match(query, pos)
        if mb:
            boost = float(mb.group(1))
            pos = mb.end()
        bare += pre + " "
        if pt:
            if is_path:
                if occ == "-":
                    path_not.append((pt, True))
                else:
                    # adjacency marker, same role as required phrases
                    bare += "\x01 "
                    path_must.append((pt, True))
            elif occ == "-":
                not_phrases.append(pt)
            else:
                # a phrase placeholder keeps clause adjacency for AND
                # promotion (a required phrase is already a filter, so
                # promotion is a no-op on it)
                bare += "\x01 "
                req_phrases.append(pt)
                req_pboosts.append(boost)

    # bare clauses in order: (occ, tokens) or the operators themselves.
    # Split on ASCII whitespace ONLY — the C++ engine splits with
    # isspace(), and str.split()'s Unicode whitespace (NBSP, U+3000…)
    # would make the engines parse the same query differently
    items: List = []   # ("AND"/"OR") | ["occ", [tokens]] | "\x01"
    for piece in re.split(r"[ \t\r\n\f\v]+", bare):
        if not piece:
            continue
        if piece in ("AND", "OR"):
            items.append(piece)
            continue
        if piece == "\x01":
            items.append("\x01")
            continue
        occ = ""
        if piece[0] in "+-":
            occ = piece[0]
            piece = piece[1:]
        # ^boost suffix (term^2); malformed suffixes are not boosts and
        # tokenize as plain text (historical parse preserved)
        boost = 1.0
        mb = _SBOOST_RE.search(piece)
        if mb:
            boost = float(mb.group(1))
            piece = piece[:mb.start()]
        if piece.startswith("path:"):
            toks = tokenize(piece[5:])
            if toks:
                # path clauses are filters: like required phrases they
                # take an adjacency marker (AND promotion is a no-op on
                # them but must not walk past to a farther clause)
                items.append("\x01")
                if occ == "-":
                    path_not.append((toks, False))
                else:
                    path_must.append((toks, False))
            continue
        toks = tokenize(piece)
        if toks:
            items.append([occ, toks, boost])
    # AND promotes the nearest clause on each side (SHOULD -> MUST);
    # phrases and MUST_NOT clauses are left as-is
    for i, it in enumerate(items):
        if it != "AND":
            continue
        for j in (range(i - 1, -1, -1), range(i + 1, len(items))):
            for k in j:
                nb = items[k]
                if isinstance(nb, list):
                    if nb[0] == "":
                        nb[0] = "+"
                    break
                if nb == "\x01":
                    break   # adjacent required phrase: no-op

    score_terms: List[str] = []
    score_boosts: List[float] = []
    must_sets: List[List[str]] = []
    not_sets: List[List[str]] = []
    for it in items:
        if not isinstance(it, list):
            continue
        occ, toks, boost = it
        if occ == "-":
            not_sets.append(toks)
            continue
        score_terms.extend(toks)
        score_boosts.extend([boost] * len(toks))
        if occ == "+":
            must_sets.append(toks)
    for pt, pb in zip(req_phrases, req_pboosts):
        score_terms.extend(pt)
        score_boosts.extend([pb] * len(pt))
    return _Query(score_terms, must_sets, not_sets,
                  req_phrases, not_phrases, path_must, path_not,
                  score_boosts)


class DiskTextIndex:
    """Manifest + segment-list orchestration shared by both engines."""

    TARGET_DOCS = 65536      # sealed segment size; merge outputs flush here
    MERGE_FANOUT = 8         # same-tier neighbors that trigger a merge
    engine = "python"

    def __init__(self, data_dir: Path | str):
        self._lock = threading.RLock()
        self.dir = Path(data_dir) / "text_index"
        self.seg_dir = self.dir / "segments"
        self.seg_dir.mkdir(parents=True, exist_ok=True)
        self.segments: List[Segment] = []
        self._names: List[str] = []
        self._gen = 0
        self._seq = 0
        self._load()

    # -- persistence ------------------------------------------------------------

    @property
    def _manifest_path(self) -> Path:
        return self.dir / "manifest2.json"

    def _seg_path(self, name: str) -> Path:
        return self.seg_dir / f"{name}.seg"

    def _next_name(self) -> str:
        name = f"g{self._gen:04d}-{self._seq:06d}"
        self._seq += 1
        return name

    def _write_manifest(self) -> None:
        _atomic_write_json(self._manifest_path, {
            "version": 2,
            "gen": self._gen,
            "segments": [{"name": n} for n in self._names],
        })

    def _load(self) -> None:
        if self._manifest_path.exists():
            m = json.loads(self._manifest_path.read_text())
            self._gen = int(m.get("gen", 0))
            for s in m["segments"]:
                self.segments.append(self._open_segment(s["name"]))
                self._names.append(s["name"])
            self._seq = 1 + max(
                (int(n.split("-")[1]) for n in self._names
                 if n.startswith(f"g{self._gen:04d}-")), default=-1)
            self._gc_orphans()
            self._maybe_compact()
        else:
            migrated = list(self._iter_legacy_docs())
            if migrated:
                for start in range(0, len(migrated), self.TARGET_DOCS):
                    self._append_segment(
                        migrated[start:start + self.TARGET_DOCS])
                self._write_manifest()
            self._drop_legacy_files()

    def _gc_orphans(self) -> None:
        """Unlink segment/sidecar files a crash left unreferenced (writes
        happen under fresh names BEFORE the manifest swap, so orphans are
        always safe to drop)."""
        live = set(self._names)
        for p in self.seg_dir.iterdir():
            if p.suffix == ".tmp":   # interrupted atomic write, any name
                p.unlink(missing_ok=True)
            elif p.suffix in (".seg", ".del") and \
                    p.name.split(".")[0] not in live:
                p.unlink(missing_ok=True)

    # -- legacy migration -------------------------------------------------------

    def _iter_legacy_docs(self) -> Iterator[tuple]:
        """Stream live docs out of every pre-v2 layout present (round-1
        single files and round-2 JSON/bin segment formats, either
        backend), in original doc order."""
        # round-2 Python segmented
        mpath = self.dir / "manifest.json"
        if mpath.exists():
            m = json.loads(mpath.read_text())
            deleted = set(m.get("deleted", []))
            base = 0
            for s in m["segments"]:
                seg = json.loads(
                    (self.seg_dir / f"{s['name']}.json").read_text())
                for rel, d in enumerate(seg["docs"]):
                    if d is not None and base + rel not in deleted:
                        yield (d["id"], d["file_path"], d["start_line"],
                               d["end_line"], d["content"])
                base += s["docs"]
        # round-1 Python single file
        lpath = self.dir / "index.json"
        if lpath.exists():
            data = json.loads(lpath.read_text())
            for d in data["docs"]:
                if d is not None:
                    yield (d["id"], d["file_path"], d["start_line"],
                           d["end_line"], d["content"])
        # round-2 native segmented
        nmpath = self.dir / "manifest.native.json"
        if nmpath.exists():
            m = json.loads(nmpath.read_text())
            deleted = set(m.get("deleted", []))
            base = 0
            for s in m["segments"]:
                for rel, doc in enumerate(_read_native_v1_segment(
                        self.seg_dir / f"{s['name']}.bin")):
                    if base + rel not in deleted:
                        yield doc
                base += s["docs"]
        # round-1 native single file
        nlpath = self.dir / "index.native.bin"
        if nlpath.exists():
            yield from _read_native_v1_snapshot(nlpath)

    def _drop_legacy_files(self) -> None:
        for name in ("manifest.json", "index.json", "manifest.native.json",
                     "index.native.bin"):
            (self.dir / name).unlink(missing_ok=True)
        if self.seg_dir.exists():
            for p in self.seg_dir.iterdir():
                if p.suffix in (".json", ".bin"):
                    p.unlink(missing_ok=True)

    # -- segment building (engine dispatch) -------------------------------------

    def _build_segment(self, path: Path, docs: Sequence[tuple]) -> None:
        if self.engine == "native":
            from sema_tpu_torch.native.bindings import tseg_build
            tseg_build(docs, str(path))
        else:
            write_segment(path, docs, [tokenize(d[4]) for d in docs])

    def _open_segment(self, name: str) -> Segment:
        seg = Segment(self._seg_path(name))
        if self.engine == "native":
            # eager, like the numpy memmap: the C++ mmap handle stays
            # valid after compaction unlinks the file; freed at GC
            import weakref
            from sema_tpu_torch.native.bindings import tseg_close, tseg_open
            seg._nat_handle = tseg_open(str(seg.path))
            weakref.finalize(seg, tseg_close, seg._nat_handle)
        return seg

    def _append_segment(self, docs: Sequence[tuple]) -> None:
        name = self._next_name()
        self._build_segment(self._seg_path(name), docs)
        self.segments.append(self._open_segment(name))
        self._names.append(name)

    # -- merging / compaction ---------------------------------------------------

    @staticmethod
    def _tier(live: int) -> int:
        return max(1, live).bit_length() // 3   # ~log8 buckets

    def _pick_merge(self) -> Optional[Tuple[int, int]]:
        """Rightmost window of MERGE_FANOUT consecutive unsealed segments
        sharing a size tier (Lucene log-merge shape: each doc is
        rewritten O(log_FANOUT N) times over the index's life)."""
        segs = self.segments
        f = self.MERGE_FANOUT
        for i in range(len(segs) - f, -1, -1):
            window = segs[i:i + f]
            if any(s.n_live >= self.TARGET_DOCS for s in window):
                continue
            tiers = {self._tier(s.n_live) for s in window}
            if len(tiers) == 1:
                return i, i + f
        return None

    def _rebuild(self, i: int, j: int) -> None:
        """Rewrite segments[i:j] as fresh segments holding only live docs,
        flushed every TARGET_DOCS (RSS stays bounded by one flush group).
        New files land under a bumped generation — names the committed
        manifest cannot reference — then the manifest swaps atomically,
        then the old files unlink: a crash at any point leaves a loadable
        index."""
        self._gen += 1
        self._seq = 0
        old_segments = self.segments[i:j]
        new_names: List[str] = []
        new_segments: List[Segment] = []
        group: List[tuple] = []

        def flush():
            if not group:
                return
            name = self._next_name()
            self._build_segment(self._seg_path(name), group)
            new_segments.append(self._open_segment(name))
            new_names.append(name)
            group.clear()

        for seg in old_segments:
            for _, doc in seg.iter_live():
                group.append(doc)
                if len(group) >= self.TARGET_DOCS:
                    flush()
        flush()
        self.segments[i:j] = new_segments
        self._names[i:j] = new_names
        self._write_manifest()
        for seg in old_segments:
            seg.unlink()

    def _maybe_merge(self) -> None:
        while True:
            pick = self._pick_merge()
            if pick is None:
                return
            self._rebuild(*pick)

    def _maybe_compact(self) -> None:
        total = sum(s.n_docs for s in self.segments)
        dead = sum(s.dead for s in self.segments)
        if total == 0 or dead / total <= _COMPACT_DEAD_FRACTION:
            return
        # rewrite each maximal run of adjacent tombstoned segments; clean
        # segments are left untouched (their files never rewritten)
        i = len(self.segments)
        while i > 0:
            if self.segments[i - 1].dead == 0:
                i -= 1
                continue
            j = i
            while i > 0 and self.segments[i - 1].dead > 0:
                i -= 1
            self._rebuild(i, j)

    # -- public API -------------------------------------------------------------

    @property
    def num_live_docs(self) -> int:
        return sum(s.n_live for s in self.segments)

    @_locked
    def index_chunks(self, chunks: Sequence[Chunk]) -> None:
        """Add documents and commit: one immutable segment per batch
        (text_indexer.rs:58-73 commits per batch), O(batch) amortized."""
        docs = [(c.id, str(c.file_path), c.start_line, c.end_line,
                 c.content) for c in chunks]
        if not docs:
            return
        self._append_segment(docs)
        self._maybe_merge()
        self._write_manifest()

    @_locked
    def remove_file_chunks(self, file_path) -> int:
        """Tombstone a file's documents: O(log + rows-of-file) per segment
        via the sorted file-run table — never a doc scan."""
        pb = str(file_path).encode()
        removed = 0
        for seg in self.segments:
            rows = seg.file_rows(pb)
            if rows:
                removed += seg.tombstone(rows)
        return removed

    @_locked
    def search(self, query: str, limit: int) -> List[Tuple[Chunk, float]]:
        """BM25 over the tantivy QueryParser subset (grammar spec:
        :class:`_Query` — OR-of-terms default, ``+``/``-`` occurs,
        infix ``AND``/``OR``, quoted phrases). Empty query → no results
        (text_indexer.rs:76-78); a pure-negative query matches nothing
        (tantivy BooleanQuery with only must_not clauses)."""
        query = query.strip()
        if not query or limit <= 0:
            # limit<=0: the emit loops appended one hit before their
            # bound check and diverged from the C++ engine's zero hits
            return []
        # '\x00' is in-band for the C ABI's NUL-terminated query string
        # (the C++ engine would silently truncate there while this
        # engine tokenized past it) — it is a token separator in both
        # grammars, so normalize it to one here
        query = query.replace("\x00", " ").strip()
        if not query:
            return []
        q = _parse_query(query)
        n_live = self.num_live_docs
        if n_live == 0:
            return []
        if not q.score_terms:
            if not q.path_must:
                return []   # empty / pure-negative: matches nothing
            # filter-only query (just path: requirements): score 0.0,
            # global doc order — see the _Query grammar spec
            if self.engine == "native":
                return self._search_native(query, limit, 1.0, n_live)
            return self._search_filter_only(q, limit)
        avg = sum(s.live_len for s in self.segments) / n_live
        if avg == 0.0:
            avg = 1.0
        if self.engine == "native":
            return self._search_native(query, limit, avg, n_live)
        return self._search_py(q, limit, avg, n_live)

    @_locked
    def commit(self) -> None:
        """Durable write (≙ tantivy writer.commit, text_indexer.rs:70,159).
        Segments and tombstones are already durable at mutation time, so
        this only materializes a manifest for an empty fresh index."""
        if not self._manifest_path.exists():
            self._write_manifest()

    @_locked
    def close(self) -> None:
        self.commit()
        for s in self.segments:
            s.close()

    # -- python engine ----------------------------------------------------------

    def _bases(self) -> List[int]:
        bases = [0]
        for s in self.segments:
            bases.append(bases[-1] + s.n_docs)
        return bases

    def _search_py(self, q: "_Query", limit: int, avg: float,
                   n_live: int) -> List[Tuple[Chunk, float]]:
        terms = q.score_terms
        boosts = q.score_boosts
        ptoks = q.req_phrases
        bases = self._bases()
        gids_all: List[np.ndarray] = []
        contribs_all: List[np.ndarray] = []
        for term, boost in zip(terms, boosts):
            tb = term.encode()
            seg_hits = []
            df = 0
            for base, seg in zip(bases, self.segments):
                t = seg.find_term(tb)
                if t < 0:
                    continue
                ids, tfs = seg.postings(t)
                live = seg.live_mask(ids)
                if not live.all():
                    ids, tfs = ids[live], tfs[live]
                if len(ids) == 0:
                    continue
                df += len(ids)
                seg_hits.append((base, seg, ids, tfs))
            if df == 0:
                continue
            idf = math.log(1.0 + (n_live - df + 0.5) / (df + 0.5))
            for base, seg, ids, tfs in seg_hits:
                tf = tfs.astype(np.float64)
                dl = seg.doc_len[ids].astype(np.float64)
                denom = tf + K1 * (1 - B + B * dl / avg)
                # boost outermost (C++ mirrors the expression tree);
                # 1.0 * c == c exactly, so unboosted queries keep their
                # historical bit-identical scores
                contribs_all.append(boost * (idf * tf * (K1 + 1)
                                             / denom))
                gids_all.append(ids.astype(np.int64) + base)
        if not gids_all:
            return []
        g = np.concatenate(gids_all)
        c = np.concatenate(contribs_all)
        total = bases[-1]
        # High-match queries (stop-word-like terms over a multi-million
        # doc corpus) would pay an O(P log P) unique/sort on millions of
        # postings; a dense accumulator + threshold selection is ~10×
        # cheaper there. Both paths sum per-doc contributions in the
        # same (query-term-major) order, so scores are bit-identical;
        # phrase queries keep the sparse path (verification needs the
        # full rank order).
        if not q.has_filters and len(g) * 8 >= total:
            dense = np.bincount(g, weights=c, minlength=total)
            if limit < total:
                thr = -np.partition(-dense, limit - 1)[limit - 1]
            else:
                thr = 0.0
            cand = np.nonzero(dense >= max(thr, 1e-300))[0]
            cand = cand[dense[cand] > 0]
            # sort candidates by (-score, gid); gid asc via stable sort
            order_c = np.argsort(-dense[cand], kind="stable")
            uniq = cand[order_c][:limit * 4 + 64]
            scores_arr = dense[uniq]
            order = np.arange(len(uniq))
            scores = scores_arr
        else:
            # bincount accumulates in array order → per-doc contributions
            # sum in query-term order, bit-identical to the C++ engine's
            # term-major loop
            uniq, inv = np.unique(g, return_inverse=True)
            scores = np.bincount(inv, weights=c)
            # drop zero-total docs (reachable via term^0) — the dense
            # path and the C++ dense path already do, and the switch
            # between paths must not be observable (review finding, r3)
            nz = scores > 0
            uniq, scores = uniq[nz], scores[nz]
            # stable sort on -score: ties break by ascending global doc
            # id (uniq is sorted), matching the C++ comparator
            order = np.argsort(-scores, kind="stable")

        out: List[Tuple[Chunk, float]] = []
        # The walk runs in rank-order BLOCKS. Phrase filtering: within a
        # block, v3 segments answer membership vectorized (np.isin
        # against per-segment positional row sets computed LAZILY on
        # first touch — only segments that actually surface among the
        # top candidates are evaluated, parity with the C++ engine's
        # lazy walk); v2 segments keep the per-candidate content
        # re-tokenize check. Content is never read for positionally
        # rejected candidates, and a zero-hit phrase costs
        # len(order)/BLK vectorized passes, never a per-candidate
        # Python loop.
        # per-segment filter row sets, computed lazily on first touch:
        # combined MUST requirement (must-clause term sets ∩ positional
        # phrase rows) and MUST_NOT exclusion (∪ of not-clause /
        # not-phrase rows). v2 segments without positions apply the
        # term-set parts here and fall back to content checks for the
        # phrase parts in the emit loop.
        seg_filters: Dict[int, tuple] = {}

        def _filters(si: int):
            f = seg_filters.get(si)
            if f is None:
                seg = self.segments[si]
                req = None
                for toks in q.must_sets:
                    rows = _term_rows_all(seg, toks)
                    req = rows if req is None else np.intersect1d(
                        req, rows, assume_unique=True)
                for toks, isp in q.path_must:
                    rows = _path_clause_rows(seg, toks, isp)
                    req = rows if req is None else np.intersect1d(
                        req, rows, assume_unique=True)
                if q.req_phrases and seg.has_positions:
                    pr = _phrase_rows_positional(seg, q.req_phrases)
                    req = pr if req is None else np.intersect1d(
                        req, pr, assume_unique=True)
                excl = None
                for toks in q.not_sets:
                    rows = _term_rows_all(seg, toks)
                    excl = rows if excl is None else np.union1d(excl,
                                                                rows)
                if q.not_phrases and seg.has_positions:
                    for npt in q.not_phrases:
                        rows = _phrase_rows_positional(seg, [npt])
                        excl = rows if excl is None else np.union1d(
                            excl, rows)
                for toks, isp in q.path_not:
                    rows = _path_clause_rows(seg, toks, isp)
                    excl = rows if excl is None else np.union1d(excl,
                                                                rows)
                f = (req, excl)
                seg_filters[si] = f
            return f

        BLK = 8192
        for blk0 in range(0, len(order), BLK):
            oblk = order[blk0:blk0 + BLK]
            gids = uniq[oblk].astype(np.int64)
            sis = np.searchsorted(bases, gids, side="right") - 1
            if q.has_filters:
                keep = np.ones(len(gids), dtype=bool)
                for si in np.unique(sis):
                    req, excl = _filters(int(si))
                    m = sis == si
                    local = gids[m] - bases[int(si)]
                    kk = np.ones(len(local), dtype=bool)
                    if req is not None:
                        kk &= np.isin(local, req)
                    if excl is not None and len(excl):
                        kk &= ~np.isin(local, excl)
                    keep[m] = kk
                idxs = np.nonzero(keep)[0]
            else:
                idxs = range(len(gids))
            for j in idxs:
                oi = oblk[j]
                si = int(sis[j])
                seg = self.segments[si]
                row = int(gids[j]) - bases[si]
                content = seg.content(row)
                if not seg.has_positions:
                    if q.req_phrases and not _has_phrases(
                            content, q.req_phrases):
                        continue
                    if q.not_phrases and any(
                            _has_phrases(content, [npt])
                            for npt in q.not_phrases):
                        continue
                doc_id, fpath, start, end = seg.meta(row)
                out.append((Chunk(id=doc_id, file_path=Path(fpath),
                                  start_line=start, end_line=end,
                                  content=content),
                            float(scores[oi])))
                if len(out) >= limit:
                    return out
        return out

    def _search_filter_only(self, q: "_Query", limit: int
                            ) -> List[Tuple[Chunk, float]]:
        """Walk for queries whose only requirements are ``path:``
        clauses (no scoring terms): emit matching live docs with score
        0.0 in global doc order, exclusions applied."""
        out: List[Tuple[Chunk, float]] = []
        for seg in self.segments:
            req: Optional[np.ndarray] = None
            for toks, isp in q.path_must:
                rows = _path_clause_rows(seg, toks, isp)
                req = rows if req is None else np.intersect1d(
                    req, rows, assume_unique=True)
                if len(req) == 0:
                    break
            if req is None or len(req) == 0:
                continue
            excl: Optional[np.ndarray] = None
            for toks, isp in q.path_not:
                rows = _path_clause_rows(seg, toks, isp)
                excl = rows if excl is None else np.union1d(excl, rows)
            if excl is not None and len(excl):
                req = req[~np.isin(req, excl)]
            if len(req) == 0:
                continue
            req = req[seg.live_mask(req.astype(np.uint32))]
            for row in req:
                row = int(row)
                doc_id, fpath, start, end = seg.meta(row)
                out.append((Chunk(id=doc_id, file_path=Path(fpath),
                                  start_line=start, end_line=end,
                                  content=seg.content(row)), 0.0))
                if len(out) >= limit:
                    return out
        return out

    # -- native engine ----------------------------------------------------------

    def _search_native(self, query: str, limit: int, avg: float,
                       n_live: int) -> List[Tuple[Chunk, float]]:
        from sema_tpu_torch.native.bindings import tseg_search
        descs = []
        base = 0
        for seg in self.segments:
            descs.append((seg._nat_handle, base, seg.del_bytes()))
            base += seg.n_docs
        hits = tseg_search(descs, query, limit, avg, n_live)
        return [(Chunk(id=i, file_path=Path(p), start_line=s, end_line=e,
                       content=content), float(score))
                for i, p, s, e, content, score in hits]


def _term_rows_all(seg, toks: List[str]) -> np.ndarray:
    """Local doc ids of ``seg`` containing EVERY token of one clause
    (postings only — no positions needed, so it works on v2 segments).
    Postings ids are unique and ascending per term, so the intersection
    can assume uniqueness."""
    rows: Optional[np.ndarray] = None
    for t in toks:
        ti = seg.find_term(t.encode())
        if ti < 0:
            return np.empty(0, dtype=np.int64)
        ids, _ = seg.postings(ti)
        ids = ids.astype(np.int64)
        rows = ids if rows is None else np.intersect1d(
            rows, ids, assume_unique=True)
        if len(rows) == 0:
            return rows
    return rows if rows is not None else np.empty(0, dtype=np.int64)


def _phrase_rows_positional(seg, ptoks: List[List[str]]) -> np.ndarray:
    """Local doc ids of ``seg`` satisfying ALL phrases, answered entirely
    from v3 positional postings (≙ tantivy's PhraseQuery; the content
    blob is never touched).

    A doc matches one phrase when some start position p has term k at
    p+k for every k. Each term's occurrences become sorted keys
    ``(doc << 32) | (pos - k)``; a sorted-set intersection across the
    phrase's terms leaves exactly the valid start positions. Keys are
    unique (one per (doc, pos)) and ascending (docs ascend, positions
    ascend within a doc), so ``np.intersect1d(assume_unique=True)``
    is safe. Phrase semantics match ``_has_phrases``: positions index
    the token LIST (>40-char tokens are dropped by the analyzer before
    position assignment, identically to content re-tokenization)."""
    rows_all: Optional[np.ndarray] = None
    empty = np.empty(0, dtype=np.int64)
    for pt in ptoks:
        keys: Optional[np.ndarray] = None
        for k, term in enumerate(pt):
            t = seg.find_term(term.encode())
            if t < 0:
                return empty
            ids, tfs = seg.postings(t)
            pos = seg.term_positions(t).astype(np.int64)
            docs_rep = np.repeat(ids.astype(np.int64), tfs)
            adj = pos - k
            ok = adj >= 0        # term k can't start a phrase before pos k
            kk = (docs_rep[ok] << 32) | adj[ok]
            keys = kk if keys is None else np.intersect1d(
                keys, kk, assume_unique=True)
            if len(keys) == 0:
                return empty
        prows = np.unique(keys >> 32)
        rows_all = (prows if rows_all is None
                    else np.intersect1d(rows_all, prows, assume_unique=True))
        if len(rows_all) == 0:
            return empty
    return rows_all if rows_all is not None else empty


def _seg_path_runs(seg) -> List[Tuple[Tuple[str, ...], int, int]]:
    """(path tokens, row_start, row_count) per file run of ``seg``,
    tokenized with the content analyzer (tantivy applies the same
    default analyzer to its TEXT path field). Cached on the segment —
    segments are immutable, and the table is tiny (one entry per file,
    not per doc). The path string comes from the run's first doc's meta
    record; the file table itself stores only hashes."""
    cached = getattr(seg, "_path_runs_cache", None)
    if cached is None:
        cached = []
        runs = seg.file_runs_all()
        for j in range(len(runs)):
            start = int(runs["start"][j])
            count = int(runs["count"][j])
            toks = tuple(tokenize(seg.doc_path_bytes(start).decode()))
            cached.append((toks, start, count))
        seg._path_runs_cache = cached
    return cached


def _path_clause_rows(seg, toks: List[str], is_phrase: bool) -> np.ndarray:
    """Local doc ids of ``seg`` whose file path satisfies one ``path:``
    clause: containment of every clause token (plain) or a consecutive
    in-order token run (quoted path phrase)."""
    spans: List[Tuple[int, int]] = []
    for ptoks, start, count in _seg_path_runs(seg):
        if is_phrase:
            n, m = len(ptoks), len(toks)
            ok = any(list(ptoks[i:i + m]) == toks
                     for i in range(n - m + 1))
        else:
            ok = all(t in ptoks for t in toks)
        if ok:
            spans.append((start, count))
    if not spans:
        return np.empty(0, dtype=np.int64)
    rows = np.concatenate([np.arange(s, s + c, dtype=np.int64)
                           for s, c in spans])
    rows.sort()
    return rows


def _has_phrases(content: str, ptoks: List[List[str]]) -> bool:
    # sentinel-wrapped join: every token is bounded by \x00 on BOTH sides
    # so a phrase term can never match a substring of a longer token
    # ("bar" must not match "barometer"); the C++ engine uses the
    # identical convention
    joined = "\x00" + "\x00".join(tokenize(content)) + "\x00"
    return all(("\x00" + "\x00".join(pt) + "\x00") in joined
               for pt in ptoks)


# -- legacy native binary readers (pure Python, no lib required) ---------------

_V1_SNAP_MAGIC = 0x53454D54   # "SEMT"
_V1_SEG_MAGIC = 0x53454D53    # "SEMS"


class _V1Reader:
    def __init__(self, path: Path):
        self.b = path.read_bytes()
        self.off = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.b, self.off)
        self.off += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.b, self.off)
        self.off += 8
        return v

    def s(self) -> str:
        n = self.u32()
        v = self.b[self.off:self.off + n].decode()
        self.off += n
        return v


def _read_native_v1_snapshot(path: Path) -> Iterator[tuple]:
    r = _V1Reader(path)
    if r.u32() != _V1_SNAP_MAGIC or r.u32() != 1:
        return
    for _ in range(r.u64()):
        alive = r.b[r.off]
        r.off += 1
        doc = (r.s(), r.s(), r.u64(), r.u64(), r.s())
        r.u32()   # doc_len — recomputed on re-index
        if alive:
            yield doc


def _read_native_v1_segment(path: Path) -> Iterator[tuple]:
    r = _V1Reader(path)
    if r.u32() != _V1_SEG_MAGIC or r.u32() != 1:
        return
    for _ in range(r.u64()):
        doc = (r.s(), r.s(), r.u64(), r.u64(), r.s())
        r.u32()
        yield doc


class TextIndex(DiskTextIndex):
    """numpy-engine index — the scoring-semantics oracle."""

    engine = "python"


class NativeTextIndex(DiskTextIndex):
    """C++-engine index (≙ tantivy's role; SURVEY.md §2 native
    inventory). Same on-disk format as :class:`TextIndex`; the parity
    suite asserts identical rankings and scores."""

    engine = "native"

    def __init__(self, data_dir: Path | str):
        import sema_tpu_torch.native.bindings  # noqa: F401 — ImportError probe
        super().__init__(data_dir)


def make_text_index(data_dir: Path | str, backend: str = "auto"):
    """Engine selection: 'native' (C++), 'python', or 'auto' (native when
    built). Both engines share the v2 on-disk format, so auto no longer
    needs to pin a backend to an existing index — any engine opens any
    index (round-2 formats migrate on open either way)."""
    backend = os.environ.get("SEMA_TPU_TEXT_BACKEND", backend)
    if backend == "python":
        return TextIndex(data_dir)
    try:
        return NativeTextIndex(data_dir)
    except ImportError:
        if backend == "native":
            raise
        return TextIndex(data_dir)
