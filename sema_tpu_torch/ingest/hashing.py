# Copy of sema_tpu/ingest/hashing.py with imports renamed and an optional xxhash (blake2b "b2:" digests without it); tests/test_torch_imports.py checks it for drift.
"""Content-change detection hashing.

Parity: the reference hashes file contents with xxh3-128 and formats the
digest as lowercase hex with no zero padding (Rust ``format!("{:x}", u128)``,
src/storage/mod.rs:78,92). Files <= 1 MiB are hashed in one read; larger files
are streamed in 128 KiB blocks (src/storage/mod.rs:72-94) — the digest is
identical either way; the split only bounds memory.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

try:
    import xxhash
except ImportError:
    # blake2b-128 instead; the "b2:" prefix keeps these digests from ever
    # matching an xxh3 manifest written by a host that has xxhash
    xxhash = None

HASH_NAME = "xxh3-128" if xxhash is not None else "blake2b-128"

_STREAM_THRESHOLD = 1_048_576   # 1 MiB (ref storage/mod.rs:75)
_BLOCK = 131_072                # 128 KiB (ref storage/mod.rs:82)


def hash_bytes(data: bytes) -> str:
    """xxh3-128 of ``data`` as unpadded lowercase hex."""
    if xxhash is None:
        return "b2:" + hashlib.blake2b(data, digest_size=16).hexdigest()
    return format(xxhash.xxh3_128_intdigest(data), "x")


def hash_file(file_path: Path | str) -> str:
    """xxh3-128 of a file's contents, streamed for files > 1 MiB."""
    file_path = Path(file_path)
    size = file_path.stat().st_size
    if size <= _STREAM_THRESHOLD:
        return hash_bytes(file_path.read_bytes())
    if xxhash is None:
        h = hashlib.blake2b(digest_size=16)
    else:
        h = xxhash.xxh3_128()
    with open(file_path, "rb") as f:
        while True:
            block = f.read(_BLOCK)
            if not block:
                break
            h.update(block)
    if xxhash is None:
        return "b2:" + h.hexdigest()
    return format(h.intdigest(), "x")
