# Copy of sema_tpu/utils/fsio.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Filesystem helpers shared by the index persistence layers."""

from __future__ import annotations

import json
import os
from pathlib import Path

# Durability barriers (fsync of data, tmp files, and directories) make
# the "manifest rename is the commit point" guarantee hold across POWER
# LOSS, not just process crashes: without them the rename can become
# durable while the data pages it references are not. They cost one
# fsync per file per commit; SEMA_TPU_NO_FSYNC=1 turns them off for
# throwaway runs (benchmark trees, tests on throttled disks).


def _fsync_enabled() -> bool:
    return os.environ.get("SEMA_TPU_NO_FSYNC") != "1"


def fsync_file(path: Path) -> None:
    """fsync an already-written file's data (no-op when disabled)."""
    if not _fsync_enabled():
        return
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: Path) -> None:
    """fsync a directory so renames/creates inside it are durable."""
    if not _fsync_enabled():
        return
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: Path, obj) -> None:
    """Write ``obj`` as JSON via a temp file + ``os.replace`` so readers
    (and crash recovery) only ever see the old or the new version, never
    a partial write. The temp file is fsynced BEFORE the rename and the
    directory after it, so the commit also survives power loss. Used for
    every manifest/sidecar commit in ``sema_tpu.index``.

    The temp name is UNIQUE per writer (mkstemp): with a fixed '.tmp'
    name, two concurrent writers (owner index + serve-time re-index in
    another process) could interleave truncate/write/replace and commit
    a partial file — exactly the torn state this helper exists to
    prevent (review finding, r3)."""
    import tempfile
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(obj))
            if _fsync_enabled():
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(path.parent)
