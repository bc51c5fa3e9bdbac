# Copy of sema_tpu/ingest/chunker.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Byte-window file chunker.

Parity: byte-for-byte the reference's ``src/storage/processor.rs:31-85``:

- window of CHUNK_SIZE=1000 bytes, OVERLAP_SIZE=100, MIN_CHUNK_SIZE=50
  (processor.rs:6-8);
- the tentative end is snapped *back* to a UTF-8 character boundary
  (processor.rs:44-47), then — unless the window already reaches EOF —
  back to just after the last ``\\n`` in the window (processor.rs:49-53);
- a chunk is kept if it has >= MIN bytes, or it is the would-be first chunk
  (processor.rs:57);
- 1-based line numbers derived by counting newlines (processor.rs:58-59);
- the next window starts OVERLAP bytes before the previous end, unless that
  would not advance, in which case it starts exactly at the previous end
  (processor.rs:72-77);
- files shorter than MIN bytes produce no chunks (processor.rs:34-36);
- chunk id is ``"{path}:{ordinal}"`` counting only *kept* chunks
  (processor.rs:62,69).

All offsets are byte offsets into the UTF-8 encoding, exactly as Rust string
indices are. Files that are not valid UTF-8 are skipped, matching
``std::fs::read_to_string`` failure → file skipped (processor.rs:18,26).

The native C++ backend (sema_tpu/native) implements the same algorithm with
a thread pool; this module transparently uses it when available.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

from sema_tpu_torch.types import Chunk

CHUNK_SIZE = 1000
OVERLAP_SIZE = 100
MIN_CHUNK_SIZE = 50

# 0b10xxxxxx bytes are UTF-8 continuation bytes; any other byte value starts
# a character, so Rust's is_char_boundary(i) == not continuation(b[i]).
def _is_char_boundary(data: bytes, i: int) -> bool:
    if i == 0 or i == len(data):
        return True
    return (data[i] & 0xC0) != 0x80


def create_chunks(file_path: Path | str, content: str) -> List[Chunk]:
    """Split ``content`` into overlapping byte-window chunks."""
    file_path = Path(file_path)
    data = content.encode("utf-8")
    n = len(data)
    chunks: List[Chunk] = []
    if n < MIN_CHUNK_SIZE:
        return chunks

    start = 0
    chunk_id = 0
    # newlines in data[:start], maintained incrementally: counting from
    # byte 0 each window made the pure-Python path O(n^2) per file
    # (~11k windows x up to 10 MB rescans on a max-size file)
    lines_before = 0
    path_str = str(file_path)
    while start < n:
        end = min(start + CHUNK_SIZE, n)

        safe_end = end
        while safe_end > start and not _is_char_boundary(data, safe_end):
            safe_end -= 1

        if safe_end < n:
            newline_pos = data.rfind(b"\n", start, safe_end)
            if newline_pos != -1:
                safe_end = newline_pos + 1

        chunk_bytes = data[start:safe_end]

        if len(chunk_bytes) >= MIN_CHUNK_SIZE or chunk_id == 0:
            start_line = lines_before + 1
            end_line = start_line + chunk_bytes.count(b"\n")
            chunks.append(Chunk(
                id=f"{path_str}:{chunk_id}",
                file_path=file_path,
                start_line=start_line,
                end_line=end_line,
                content=chunk_bytes.decode("utf-8"),
            ))
            chunk_id += 1

        next_start = max(safe_end - OVERLAP_SIZE, 0)
        # Deviation from the reference: it computes next_start in raw bytes
        # and would panic slicing mid-character (&content[start..] with a
        # non-boundary start, processor.rs:55,58 — a latent crash on
        # multibyte content). We snap back to the previous char boundary;
        # identical behavior for ASCII content.
        while next_start > 0 and not _is_char_boundary(data, next_start):
            next_start -= 1
        new_start = safe_end if next_start <= start else next_start
        lines_before += data.count(b"\n", start, new_start)
        start = new_start
        if start >= n:
            break

    return chunks


def _process_file(file_path: Path) -> List[Chunk]:
    try:
        content = file_path.read_bytes().decode("utf-8")
    except (OSError, UnicodeDecodeError):
        return []
    return create_chunks(file_path, content)


def process_files(files: Sequence[Path | str],
                  use_native: Optional[bool] = None) -> List[Chunk]:
    """Chunk many files; per-file errors are swallowed (processor.rs:18).

    Uses the C++ native backend (parallel over a thread pool, mirroring the
    reference's rayon fan-out at processor.rs:14-20) when it is built, unless
    ``use_native=False``.
    """
    if use_native is not False:
        try:
            from sema_tpu_torch.native import chunk_files_native
        except ImportError:
            if use_native:
                raise
        else:
            return chunk_files_native([str(f) for f in files])

    out: List[Chunk] = []
    for f in files:
        out.extend(_process_file(Path(f)))
    return out
