# Copy of sema_tpu/index/text_segment.py with imports renamed and the reference's path made relative; tests/test_torch_imports.py checks it for drift.
"""On-disk immutable text-index segments (format v2, shared by engines).

The reference's text index is Tantivy, which commits immutable mmap'd
segment files and leaves document content on disk, reading it per hit
(the reference's src/storage/text_indexer.rs:58-73, 86-154). Round 2's
segments were JSON/own-binary but *fully re-inflated into host RAM* on
open — O(corpus) residency, structurally unable to reach the 10M/100M
chunk configs. v2 is the tantivy-shaped fix: everything lives on disk and
is accessed by mmap/pread; the only per-segment RAM is the ~100-byte
descriptor plus (when tombstones exist) an n_docs/8-byte delete bitmap.

One ``.seg`` file per commit batch, written atomically (tmp + rename),
never modified afterwards::

    u32  magic   "SMT2"
    u32  version 2
    u64  n_docs
    u64  total_len            sum of per-doc token counts
    u64  n_terms
    u64  n_files              file-run records (for O(file) deletes)
    u64  off[11]              absolute byte offsets, 8-aligned sections:
         0 doc_len      u32[n_docs]
         1 meta_idx     u64[n_docs+1]   byte offsets into the meta blob
         2 meta         per doc: u32 start_line, u32 end_line,
                        u16 id_len, u16 path_len, id utf8, path utf8
         3 content_idx  u64[n_docs+1]
         4 content      raw utf8 blob (read per hit, never wholesale)
         5 term_idx     u64[n_terms+1]  byte offsets into the terms blob
         6 terms        sorted (bytewise) utf8 term blob
         7 post_idx     u64[n_terms+1]  ENTRY offsets into postings
         8 post_ids     u32[P] local doc ids, ascending per term
         9 post_tfs     u32[P]
        10 files        (u64 fnv1a64(path), u32 row_start, u32 row_count)
                        sorted by hash; consecutive same-path docs form
                        one run, so lookup is O(log n_files + rows(file))
        -- v3 only (VERSION=3; phrase queries become index-native,
           ≙ tantivy's positional postings) --
        11 pos_term_idx u64[n_terms+1]  POSITION offsets per term
        12 positions    u32[total_len]  token positions (index into the
                        doc's token list), ascending within each
                        (term, doc) run; the run for posting entry e of
                        term t has length post_tfs[e], so per-entry
                        offsets are pos_term_idx[t] + cumsum of the
                        term's tfs

    v2 segments (no positions) stay readable; phrase queries over them
    fall back to per-candidate content re-tokenization, and any merge
    rewrites them as v3 (merges re-tokenize from content).

Tombstones live in a mutable ``.del`` sidecar next to the segment,
rewritten atomically as a whole (it is n_docs/8 bytes — trivial)::

    u32 magic "SDEL"  u32 dead  u64 dead_len  u8 bitmap[(n_docs+7)/8]

``dead``/``dead_len`` ride the header so opening an index needs only a
16-byte read per segment to know global live counts — no bitmap scan.

Cited behaviors: BM25 parameters and live-doc df/avg-len semantics match
the Python oracle of rounds 1-2 bit-for-bit (see text_index.py); the C++
engine (native/text_index.cpp) reads and writes this exact layout.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = 0x32544D53      # "SMT2" (shared by v2 and v3)
VERSION = 3
DEL_MAGIC = 0x4C454453  # "SDEL"
_HEADER_V2 = struct.Struct("<II4Q11Q")  # magic, ver, 4 counters, 11 offsets
_HEADER_V3 = struct.Struct("<II4Q13Q")  # v3 adds pos_term_idx + positions
_DEL_HEADER = struct.Struct("<IIQ")   # magic, dead, dead_len

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64 of raw bytes — the file-table hash. Chosen over xxh3 so
    both engines implement it in ~5 lines with no dependency; collisions
    are verified against the stored path before any tombstone."""
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def _pad8(parts: List[bytes]) -> int:
    """Append padding so the next section starts 8-aligned; returns the
    aligned offset."""
    n = sum(len(p) for p in parts)
    pad = (-n) % 8
    if pad:
        parts.append(b"\0" * pad)
    return n + pad


def write_segment(path: Path, docs: Sequence[tuple],
                  tokens_per_doc: Sequence[List[str]],
                  version: int = VERSION) -> Tuple[int, int]:
    """Write one immutable segment (atomic tmp+rename).

    ``docs``: (id, path, start_line, end_line, content) tuples.
    ``tokens_per_doc``: the tokenizer output per doc (the caller owns
    tokenization so the native engine can run its own C++ tokenizer).
    ``version``: 3 (default) writes positional postings; 2 exists so
    tests can produce legacy segments and pin the fallback path.
    Returns (n_docs, total_len).
    """
    n_docs = len(docs)
    doc_len = np.zeros(n_docs, dtype=np.uint32)
    meta_parts: List[bytes] = []
    meta_idx = np.zeros(n_docs + 1, dtype=np.uint64)
    content_parts: List[bytes] = []
    content_idx = np.zeros(n_docs + 1, dtype=np.uint64)
    # term → parallel lists: (doc, tf) entries and the doc's token
    # positions for that term (ascending; run length == tf)
    postings: Dict[bytes, List[Tuple[int, int]]] = {}
    positions: Dict[bytes, List[int]] = {}
    file_runs: List[Tuple[int, int, int]] = []   # (hash, start, count)
    run_path: Optional[str] = None

    moff = coff = 0
    for i, ((doc_id, fpath, start, end, content), toks) in enumerate(
            zip(docs, tokens_per_doc)):
        doc_len[i] = len(toks)
        occ: Dict[str, List[int]] = {}
        for p, t in enumerate(toks):
            occ.setdefault(t, []).append(p)
        for term, plist in occ.items():
            tb = term.encode()
            postings.setdefault(tb, []).append((i, len(plist)))
            positions.setdefault(tb, []).extend(plist)
        idb = doc_id.encode()
        pb = fpath.encode()
        rec = struct.pack("<IIHH", start, end, len(idb), len(pb)) + idb + pb
        meta_parts.append(rec)
        moff += len(rec)
        meta_idx[i + 1] = moff
        cb = content.encode()
        content_parts.append(cb)
        coff += len(cb)
        content_idx[i + 1] = coff
        if fpath != run_path:
            file_runs.append([fnv1a64(pb), i, 1])
            run_path = fpath
        else:
            file_runs[-1][2] += 1

    terms = sorted(postings)
    term_idx = np.zeros(len(terms) + 1, dtype=np.uint64)
    term_blob_parts: List[bytes] = []
    post_idx = np.zeros(len(terms) + 1, dtype=np.uint64)
    ids_parts: List[np.ndarray] = []
    tfs_parts: List[np.ndarray] = []
    toff = pcount = 0
    for t, term in enumerate(terms):
        term_blob_parts.append(term)
        toff += len(term)
        term_idx[t + 1] = toff
        plist = postings[term]                      # ascending doc order
        ids_parts.append(np.asarray([d for d, _ in plist], dtype=np.uint32))
        tfs_parts.append(np.asarray([c for _, c in plist], dtype=np.uint32))
        pcount += len(plist)
        post_idx[t + 1] = pcount
    post_ids = (np.concatenate(ids_parts) if ids_parts
                else np.zeros(0, dtype=np.uint32))
    post_tfs = (np.concatenate(tfs_parts) if tfs_parts
                else np.zeros(0, dtype=np.uint32))
    file_runs.sort(key=lambda r: r[0])
    files_arr = np.zeros(len(file_runs), dtype=_FILES_DT)
    for j, (h, s, c) in enumerate(file_runs):
        files_arr[j] = (h, s, c)

    sections = [
        doc_len.tobytes(), meta_idx.tobytes(), b"".join(meta_parts),
        content_idx.tobytes(), b"".join(content_parts),
        term_idx.tobytes(), b"".join(term_blob_parts), post_idx.tobytes(),
        post_ids.tobytes(), post_tfs.tobytes(), files_arr.tobytes(),
    ]
    if version >= 3:
        pos_term_idx = np.zeros(len(terms) + 1, dtype=np.uint64)
        pos_parts: List[np.ndarray] = []
        pcount = 0
        for t, term in enumerate(terms):
            arr = np.asarray(positions[term], dtype=np.uint32)
            pos_parts.append(arr)
            pcount += len(arr)
            pos_term_idx[t + 1] = pcount
        pos_arr = (np.concatenate(pos_parts) if pos_parts
                   else np.zeros(0, dtype=np.uint32))
        sections += [pos_term_idx.tobytes(), pos_arr.tobytes()]
    header = _HEADER_V3 if version >= 3 else _HEADER_V2
    parts: List[bytes] = [b"\0" * header.size]
    offs: List[int] = []
    _pad8(parts)
    for sec in sections:
        offs.append(sum(len(p) for p in parts))
        parts.append(sec)
        _pad8(parts)
    total_len = int(doc_len.sum())
    parts[0] = header.pack(MAGIC, version, n_docs, total_len,
                           len(terms), len(file_runs), *offs)
    tmp = Path(str(path) + ".tmp")
    with open(tmp, "wb") as f:
        for p in parts:
            f.write(p)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return n_docs, total_len


_FILES_DT = np.dtype([("hash", "<u8"), ("start", "<u4"), ("count", "<u4")])


class Segment:
    """mmap-backed reader over one v2/v3 segment + its ``.del`` sidecar.

    RAM held: descriptor fields and (only when tombstones exist) the
    delete bitmap, n_docs/8 bytes. Everything else is views into the
    mapping — the page cache decides residency.
    """

    def __init__(self, path: Path):
        self.path = path
        raw = path.open("rb").read(_HEADER_V3.size)
        magic, self.version = struct.unpack_from("<II", raw)
        if magic != MAGIC or self.version not in (2, 3):
            raise ValueError(f"not a v2/v3 segment: {path}")
        header = _HEADER_V3 if self.version >= 3 else _HEADER_V2
        hdr = header.unpack(raw[:header.size])
        (self.n_docs, self.total_len, self.n_terms,
         self.n_files) = hdr[2:6]
        self._off = hdr[6:]
        # the mapping opens EAGERLY: once a reader holds a segment, the
        # file may be unlinked by compaction (possibly by another index
        # instance) and the mapping stays valid — standard LSM reader
        # semantics (tantivy's mmap'd segments behave the same way)
        self._mm: np.memmap = np.memmap(path, dtype=np.uint8, mode="r")
        self.dead = 0
        self.dead_len = 0
        self._del_bits: Optional[np.ndarray] = None   # uint8 packed bitmap
        self._del_bytes: Optional[bytes] = None       # native-blob cache
        self._read_del()

    # -- raw views ------------------------------------------------------------

    @property
    def mm(self) -> np.memmap:
        return self._mm

    def _view(self, sec: int, dtype, count: int) -> np.ndarray:
        return np.frombuffer(self.mm, dtype=dtype, count=count,
                             offset=self._off[sec])

    @property
    def doc_len(self) -> np.ndarray:
        return self._view(0, np.uint32, self.n_docs)

    def _blob(self, idx_sec: int, blob_sec: int, i: int) -> bytes:
        idx = self._view(idx_sec, np.uint64, self.n_docs + 1)
        a, b = int(idx[i]), int(idx[i + 1])
        base = self._off[blob_sec]
        return bytes(self.mm[base + a:base + b])

    def meta(self, i: int) -> Tuple[str, str, int, int]:
        """(id, path, start_line, end_line) for local doc i."""
        rec = self._blob(1, 2, i)
        start, end, idl, pl = struct.unpack_from("<IIHH", rec)
        idb = rec[12:12 + idl]
        pb = rec[12 + idl:12 + idl + pl]
        return idb.decode(), pb.decode(), start, end

    def content(self, i: int) -> str:
        return self._blob(3, 4, i).decode()

    def doc_path_bytes(self, i: int) -> bytes:
        rec = self._blob(1, 2, i)
        _, _, idl, pl = struct.unpack_from("<IIHH", rec)
        return rec[12 + idl:12 + idl + pl]

    # -- term lookup ----------------------------------------------------------

    def _term_bytes(self, t: int) -> bytes:
        idx = self._view(5, np.uint64, self.n_terms + 1)
        base = self._off[6]
        return bytes(self.mm[base + int(idx[t]):base + int(idx[t + 1])])

    def find_term(self, term: bytes) -> int:
        """Binary search the sorted term blob; -1 when absent."""
        lo, hi = 0, int(self.n_terms)
        while lo < hi:
            mid = (lo + hi) // 2
            t = self._term_bytes(mid)
            if t < term:
                lo = mid + 1
            elif t > term:
                hi = mid
            else:
                return mid
        return -1

    def postings(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        idx = self._view(7, np.uint64, self.n_terms + 1)
        a, b = int(idx[t]), int(idx[t + 1])
        total = int(idx[self.n_terms])
        ids = self._view(8, np.uint32, total)[a:b]
        tfs = self._view(9, np.uint32, total)[a:b]
        return ids, tfs

    # -- positional postings (v3) ---------------------------------------------

    @property
    def has_positions(self) -> bool:
        return self.version >= 3

    def term_positions(self, t: int) -> np.ndarray:
        """All token positions of term ``t``, concatenated over its
        postings in doc order; the run for posting entry ``e`` has
        length ``tfs[e]`` (slice via a cumsum of the term's tfs)."""
        idx = self._view(11, np.uint64, self.n_terms + 1)
        a, b = int(idx[t]), int(idx[t + 1])
        total = int(idx[self.n_terms])
        return self._view(12, np.uint32, total)[a:b]

    # -- file runs (O(file) delete) -------------------------------------------

    def file_runs_all(self) -> np.ndarray:
        """The whole (hash, row_start, row_count) file-run table — one
        row per contiguous run of docs sharing a path (sorted by hash).
        Consumers needing the path STRING of a run read the first doc's
        meta record (``doc_path_bytes(start)``); used by the ``path:``
        field-query filters in text_index.py."""
        return self._view(10, _FILES_DT, self.n_files)

    def file_rows(self, path_bytes: bytes) -> List[int]:
        files = self._view(10, _FILES_DT, self.n_files)
        h = fnv1a64(path_bytes)
        lo = int(np.searchsorted(files["hash"], h, side="left"))
        rows: List[int] = []
        while lo < self.n_files and files["hash"][lo] == h:
            start, count = int(files["start"][lo]), int(files["count"][lo])
            # hash collision guard: verify the actual stored path
            if self.doc_path_bytes(start) == path_bytes:
                rows.extend(range(start, start + count))
            lo += 1
        return rows

    # -- tombstones -----------------------------------------------------------

    @property
    def del_path(self) -> Path:
        return self.path.with_suffix(".del")

    def _read_del(self) -> None:
        if not self.del_path.exists():
            return
        with open(self.del_path, "rb") as f:
            hdr = f.read(_DEL_HEADER.size)
            magic, self.dead, self.dead_len = _DEL_HEADER.unpack(hdr)
            if magic != DEL_MAGIC:
                raise ValueError(f"bad .del sidecar: {self.del_path}")
            # eager like the mapping: n_docs/8 bytes, unlink-immune
            self._del_bits = np.frombuffer(
                f.read((self.n_docs + 7) // 8), dtype=np.uint8).copy()

    @property
    def del_bits(self) -> Optional[np.ndarray]:
        """Packed tombstone bitmap (uint8), or None when nothing deleted."""
        return self._del_bits if self.dead else None

    def del_bytes(self) -> bytes:
        """The bitmap serialized for the native engine's request blob,
        cached until the next tombstone() — re-serializing n_docs/8
        bytes per segment per QUERY was ~1.25 MB of memcpy per search
        on a 10M-doc index (review finding, r3)."""
        if self._del_bytes is None:
            bits = self.del_bits
            self._del_bytes = bits.tobytes() if bits is not None else b""
        return self._del_bytes

    def live_mask(self, ids: np.ndarray) -> np.ndarray:
        """Boolean live mask for an array of local doc ids."""
        bits = self.del_bits
        if bits is None:
            return np.ones(len(ids), dtype=bool)
        return (bits[ids >> 3] >> (ids & 7).astype(np.uint8)) & 1 == 0

    def is_live(self, i: int) -> bool:
        bits = self.del_bits
        if bits is None:
            return True
        return (int(bits[i >> 3]) >> (i & 7)) & 1 == 0

    def tombstone(self, rows: Sequence[int]) -> int:
        """Mark rows deleted; atomically rewrite the sidecar. Returns the
        number of rows that were live. O(n_docs/8) bytes — trivial."""
        bits = self.del_bits
        if bits is None:
            bits = np.zeros((self.n_docs + 7) // 8, dtype=np.uint8)
        hit = 0
        dlen = 0
        doc_len = self.doc_len
        for r in rows:
            if (int(bits[r >> 3]) >> (r & 7)) & 1 == 0:
                bits[r >> 3] |= np.uint8(1 << (r & 7))
                hit += 1
                dlen += int(doc_len[r])
        if hit == 0:
            return 0
        self.dead += hit
        self.dead_len += dlen
        self._del_bits = bits
        self._del_bytes = None   # invalidate the native-blob cache
        tmp = Path(str(self.del_path) + ".tmp")
        with open(tmp, "wb") as f:
            f.write(_DEL_HEADER.pack(DEL_MAGIC, self.dead, self.dead_len))
            f.write(bits.tobytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.del_path)
        return hit

    # -- iteration (merges / compaction / substring fallback) -----------------

    def iter_live(self) -> Iterator[Tuple[int, tuple]]:
        """Stream (row, (id, path, start, end, content)) for live docs."""
        for i in range(self.n_docs):
            if not self.is_live(i):
                continue
            doc_id, fpath, start, end = self.meta(i)
            yield i, (doc_id, fpath, start, end, self.content(i))

    @property
    def n_live(self) -> int:
        return self.n_docs - self.dead

    @property
    def live_len(self) -> int:
        return self.total_len - self.dead_len

    def close(self) -> None:
        """Intentionally keeps the mapping (and any native-engine handle)
        alive: a closed-then-searched index instance must stay correct
        even after another instance compacted the files away. Resources
        are freed when the object is collected."""

    def unlink(self) -> None:
        self.path.unlink(missing_ok=True)
        self.del_path.unlink(missing_ok=True)
