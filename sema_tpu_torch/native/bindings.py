# Copy of sema_tpu/native/bindings.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""ctypes bindings for libsema_native.so (built from /native).

Wire format: every native call returns a malloc'd ``[u64 len][payload]``
buffer freed with ``sema_free``. Payload layouts are documented alongside
each wrapper. Raises ImportError at import time if the library is absent,
so ``from sema_tpu.native import ...`` doubles as a feature probe.
"""

from __future__ import annotations

import ctypes
import os
import struct
from pathlib import Path
from typing import List

from sema_tpu_torch.types import Chunk, CrawlerConfig

_CANDIDATES = [
    Path(__file__).resolve().parent / "libsema_native.so",
    Path(__file__).resolve().parents[2] / "native" / "libsema_native.so",
]


def lib_path() -> Path:
    override = os.environ.get("SEMA_TPU_NATIVE_LIB")
    if override:
        return Path(override)
    for p in _CANDIDATES:
        if p.exists():
            return p
    raise ImportError("libsema_native.so not built (run: make -C native)")


_lib = ctypes.CDLL(str(lib_path()))

_lib.sema_free.argtypes = [ctypes.c_void_p]
_lib.sema_free.restype = None
_lib.sema_hash_file.argtypes = [ctypes.c_char_p]
_lib.sema_hash_file.restype = ctypes.c_void_p
_lib.sema_chunk_files.argtypes = [ctypes.c_char_p, ctypes.c_int]
_lib.sema_chunk_files.restype = ctypes.c_void_p
_lib.sema_crawl.argtypes = [
    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p]
_lib.sema_crawl.restype = ctypes.c_void_p
_lib.sema_tseg_build.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.c_char_p]
_lib.sema_tseg_build.restype = ctypes.c_int
_lib.sema_tseg_open.argtypes = [ctypes.c_char_p]
_lib.sema_tseg_open.restype = ctypes.c_void_p
_lib.sema_tseg_close.argtypes = [ctypes.c_void_p]
_lib.sema_tseg_close.restype = None
_lib.sema_tseg_search.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_char_p, ctypes.c_uint32]
_lib.sema_tseg_search.restype = ctypes.c_void_p


def _take(ptr) -> bytes:
    if not ptr:
        raise RuntimeError("native call returned NULL")
    try:
        (n,) = struct.unpack_from("<Q", ctypes.string_at(ptr, 8))
        return ctypes.string_at(ptr + 8, n)
    finally:
        _lib.sema_free(ptr)


def hash_file_native(path: str) -> str:
    """xxh3-128 unpadded lowercase hex; empty string if unreadable."""
    out = _take(_lib.sema_hash_file(str(path).encode())).decode()
    if not out:
        raise OSError(f"native hash failed for {path}")
    return out


def crawl_native(root: str, config: CrawlerConfig) -> List[str]:
    payload = _take(_lib.sema_crawl(
        str(root).encode(),
        config.max_file_size,
        int(config.follow_symlinks),
        int(config.include_hidden),
        int(config.ignore_gitignore),
        "\n".join(config.file_extensions).encode(),
        "\n".join(config.exclude_patterns).encode()))
    text = payload.decode("utf-8", "surrogateescape")
    return [p for p in text.split("\n") if p]


def chunk_files_native(files: List[str], n_threads: int = 0) -> List[Chunk]:
    """Parallel chunking; payload is
    u32 count then per chunk: str path, u32 ordinal, u64 start, u64 end,
    str content (str = u32 length + utf8 bytes)."""
    payload = _take(_lib.sema_chunk_files(
        "\n".join(str(f) for f in files).encode(), n_threads))
    off = 0

    def u32():
        nonlocal off
        (v,) = struct.unpack_from("<I", payload, off)
        off += 4
        return v

    def u64():
        nonlocal off
        (v,) = struct.unpack_from("<Q", payload, off)
        off += 8
        return v

    def s():
        nonlocal off
        n = u32()
        v = payload[off:off + n]
        off += n
        return v

    count = u32()
    chunks: List[Chunk] = []
    for _ in range(count):
        path = s().decode()
        ordinal = u32()
        start_line = u64()
        end_line = u64()
        content = s().decode()
        chunks.append(Chunk(
            id=f"{path}:{ordinal}", file_path=Path(path),
            start_line=start_line, end_line=end_line, content=content))
    return chunks


def _pack_docs(docs) -> bytes:
    """u32 n; per doc: str id, str path, u64 start, u64 end, str content
    (str = u32 length + utf8 bytes)."""
    docs = list(docs)
    parts = [struct.pack("<I", len(docs))]
    for doc_id, path, start, end, content in docs:
        for s in (doc_id, path):
            b = s.encode("utf-8")
            parts.append(struct.pack("<I", len(b)))
            parts.append(b)
        parts.append(struct.pack("<QQ", start, end))
        b = content.encode("utf-8")
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    return b"".join(parts)


def tseg_build(docs, path: str) -> None:
    """Tokenize a doc batch in C++ and write one immutable v3 segment
    (format incl. positional postings: sema_tpu/index/text_segment.py).
    docs: iterable of (id, path, start_line, end_line, content)."""
    blob = _pack_docs(docs)
    rc = _lib.sema_tseg_build(blob, len(blob), str(path).encode())
    if rc != 0:
        raise OSError(f"native segment build failed ({rc}): {path}")


def tseg_open(path: str) -> int:
    """Persistent C++ mmap handle over a segment (valid across unlink,
    like the Python engine's eager memmap). Freed with tseg_close."""
    h = _lib.sema_tseg_open(str(path).encode())
    if not h:
        raise OSError(f"native segment open failed: {path}")
    return h


def tseg_close(handle: int) -> None:
    _lib.sema_tseg_close(handle)


def tseg_search(segments, query: str, limit: int, avg_len: float,
                n_live: int):
    """BM25 search over v2/v3 segments in C++. ``segments``: iterables of
    (handle from tseg_open, global_base, del_bitmap_bytes — empty when
    nothing is deleted). Returns (id, path, start, end, content, score)
    tuples."""
    parts = [struct.pack("<dQI", avg_len, n_live, len(segments))]
    for handle, base, bits in segments:
        parts.append(struct.pack("<QQQ", handle, base, len(bits)))
        parts.append(bits)
    blob = b"".join(parts)
    payload = _take(_lib.sema_tseg_search(blob, len(blob),
                                          query.encode("utf-8"), limit))
    off = 0

    def u32():
        nonlocal off
        (v,) = struct.unpack_from("<I", payload, off)
        off += 4
        return v

    def u64():
        nonlocal off
        (v,) = struct.unpack_from("<Q", payload, off)
        off += 8
        return v

    def s():
        nonlocal off
        n = u32()
        v = payload[off:off + n].decode("utf-8")
        off += n
        return v

    out = []
    for _ in range(u32()):
        doc_id, path = s(), s()
        start, end = u64(), u64()
        content = s()
        (score,) = struct.unpack("<d", struct.pack("<Q", u64()))
        out.append((doc_id, path, start, end, content, score))
    return out
