# Copy of sema_tpu/index/ivf_cache.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Persisted IVF layout sidecars (``ivf-<key>.bin``).

IVF mode (vector_store.py "IVF mode" comment block) k-means-clusters every
sealed bucket and lays its device copy out cluster-major. The layout is a
pure function of the bucket's rows, so recomputing it on every store open
is wasted device time (8 Lloyd iterations per 262k-row bucket — a 10M-row
store re-clusters ~40 buckets per open), and for HBM-SPILLED buckets the
layout is useless without a cluster-major copy of the rows ON DISK: the
whole point of a probe is to read only the probed clusters, which the
row-ordered segment files cannot serve contiguously.

One sidecar file per sealed bucket, keyed by the bucket's exact segment
composition (names + row counts) plus every parameter that shapes the
layout — any compaction/merge that changes the composition changes the
key, so stale sidecars are never *read*; they are unlinked by the owner's
load-time sweep (same age-gate as segment orphans). Layout::

    magic "SEMAIVF1" | u32 header_len | header JSON
    perm       (n_pad,)  i32   cluster-major position -> original row
    centroids  (C, d) or (shards, C, d)  f32
    starts     (C+2,) or (shards, C+2)   i64  cumulative cluster offsets
    vectors    (n_pad, d) blob dtype     OPTIONAL (spilled buckets only):
               the bucket's rows in cluster-major order, memmapped at
               probe time so a dispatch reads only the probed tiles
    scales     (n_pad,) f32              OPTIONAL (int8 blobs only):
               per-row symmetric quantization scales, gathered alongside
               the probed tiles for the int8 pruned kernel

Device buckets persist only the small arrays (the device copy is rebuilt
from the ordinary segments, permuted on host pre-upload); host-resident
(spilled) buckets persist the vectors blob too — one extra disk copy of
the bucket, the classic on-disk IVF trade (≙ what a LanceDB IVF_PQ index
stores next to the table; the reference never builds one,
src/storage/lance_indexer.rs).

Writes are atomic (tmp + rename) and fsynced under the same
``SEMA_TPU_NO_FSYNC`` escape hatch as segment writes (utils/fsio.py); the
sidecar is a pure cache — a torn or missing file only costs a re-cluster.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from sema_tpu_torch.utils.fsio import fsync_dir, fsync_file

_MAGIC = b"SEMAIVF1"
# v2: spilled-bucket blobs are TILE-ALIGNED (every real cluster starts on
# an IVF_SPILL_TILE boundary; the zero-pad overflow cluster is dropped),
# so a probed tile never carries a neighbor cluster's rows. v3: int8
# stores persist QUANTIZED blobs (int8 rows + per-row f32 scales) —
# half the disk and half the staged upload of the bf16 originals the
# probe previously streamed. Old-version sidecars fail the header check,
# are never read, and the load-time sweep unlinks them like any other
# unreadable sidecar. The version is deliberately shared with
# DEVICE-layout sidecars even though their format is unchanged: the
# one-time cost of the bump is a re-cluster per device bucket on first
# open (~0.2 s each) and up to an hour of doubled blob disk for
# freshly-written old spill sidecars (the sweep is age-gated), which
# buys never having to reason about per-artifact version skew.
_VERSION = 3


def layout_key(segments: Sequence[Tuple[str, int]], n_pad: int, dim: int,
               dtype: str, shards: int, tile: int,
               cluster_rows: int, spill: bool = False) -> str:
    """Content key of one bucket's layout: the segment composition plus
    every parameter the clustering depends on. ``spill`` marks the
    tile-aligned blob-backed layout of a host-resident bucket — a
    DIFFERENT artifact from the device layout (aligned perm with
    sentinel gaps vs a true permutation), so the two must never share a
    key even at identical geometry. 16 hex chars."""
    blob = json.dumps({
        "v": _VERSION, "segments": [[n, r] for n, r in segments],
        "n_pad": n_pad, "dim": dim, "dtype": dtype, "shards": shards,
        "tile": tile, "cluster_rows": cluster_rows, "spill": spill,
    }, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def sidecar_path(dir: Path, key: str) -> Path:
    return Path(dir) / f"ivf-{key}.bin"


def save_layout(dir: Path, key: str,
                segments: Sequence[Tuple[str, int]],
                perm: np.ndarray, centroids: np.ndarray,
                starts: np.ndarray,
                vectors: Optional[np.ndarray] = None,
                scales: Optional[np.ndarray] = None) -> None:
    """Atomically persist one bucket's layout (vectors/scales optional;
    scales require vectors — they describe the blob's rows)."""
    if scales is not None and vectors is None:
        raise ValueError("scales without a vectors blob")
    path = sidecar_path(dir, key)
    header = json.dumps({
        "version": _VERSION, "key": key,
        "segments": [[n, int(r)] for n, r in segments],
        "n_pad": int(perm.shape[0]),
        "centroids_shape": list(centroids.shape),
        "starts_shape": list(starts.shape),
        "vectors_dtype": (_dtype_name(vectors.dtype)
                          if vectors is not None else None),
        "vectors_dim": (int(vectors.shape[1])
                        if vectors is not None else None),
        "scales": scales is not None,
    }).encode()
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(np.uint32(len(header)).tobytes())
        f.write(header)
        f.write(np.ascontiguousarray(perm, dtype=np.int32).tobytes())
        f.write(np.ascontiguousarray(centroids,
                                     dtype=np.float32).tobytes())
        f.write(np.ascontiguousarray(starts, dtype=np.int64).tobytes())
        if vectors is not None:
            np.ascontiguousarray(vectors).tofile(f)
        if scales is not None:
            np.ascontiguousarray(scales, dtype=np.float32).tofile(f)
    fsync_file(tmp)
    os.replace(tmp, path)
    fsync_dir(Path(dir))


def _read_header(path: Path) -> Optional[Tuple[dict, int]]:
    """(header, payload_offset) or None on any malformed/foreign file."""
    try:
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                return None
            (hlen,) = np.frombuffer(f.read(4), dtype=np.uint32)
            header = json.loads(f.read(int(hlen)))
            if header.get("version") != _VERSION:
                return None
            return header, 12 + int(hlen)
    except (OSError, ValueError, KeyError):
        return None


def load_layout(dir: Path, key: str, need_vectors: bool = False
                ) -> Optional[dict]:
    """Load a persisted layout, or None (missing/corrupt/wrong-shape —
    the caller re-clusters; a cache never fails a build).

    Returns ``{"perm", "centroids", "starts"}`` plus, when the sidecar
    carries the blob and ``need_vectors``, ``"vectors"`` as a read-only
    (n_pad, d) memmap — and ``"scales"`` as an (n_pad,) f32 memmap when
    the blob is quantized (int8 stores)."""
    path = sidecar_path(dir, key)
    got = _read_header(path)
    if got is None:
        return None
    header, off = got
    if header.get("key") != key:
        return None
    n_pad = header["n_pad"]
    c_shape = tuple(header["centroids_shape"])
    s_shape = tuple(header["starts_shape"])
    if need_vectors and header.get("vectors_dtype") is None:
        return None   # layout-only sidecar; the spill path needs the blob
    has_scales = bool(header.get("scales"))
    try:
        sizes = [n_pad * 4,
                 int(np.prod(c_shape)) * 4,
                 int(np.prod(s_shape)) * 8]
        need = off + sum(sizes)
        if header.get("vectors_dtype") is not None:
            vdt = np.dtype(_np_dtype(header["vectors_dtype"]))
            need += n_pad * header["vectors_dim"] * vdt.itemsize
            if has_scales:
                need += n_pad * 4
        if path.stat().st_size < need:
            return None   # truncated (e.g. partial copy) — recompute
        with open(path, "rb") as f:
            f.seek(off)
            perm = np.fromfile(f, dtype=np.int32, count=n_pad)
            centroids = np.fromfile(
                f, dtype=np.float32,
                count=int(np.prod(c_shape))).reshape(c_shape)
            starts = np.fromfile(
                f, dtype=np.int64,
                count=int(np.prod(s_shape))).reshape(s_shape)
            vec_off = f.tell()
        out = {"perm": perm, "centroids": centroids, "starts": starts}
        if need_vectors:
            vdt = np.dtype(_np_dtype(header["vectors_dtype"]))
            out["vectors"] = np.memmap(
                path, dtype=vdt, mode="r",
                offset=vec_off, shape=(n_pad, header["vectors_dim"]))
            if has_scales:
                out["scales"] = np.memmap(
                    path, dtype=np.float32, mode="r",
                    offset=vec_off
                    + n_pad * header["vectors_dim"] * vdt.itemsize,
                    shape=(n_pad,))
        return out
    except (OSError, ValueError):
        return None


def _np_dtype(name: str):
    if name == "bfloat16":
        # the port holds bf16 rows as their uint16 bit patterns
        return np.uint16
    return np.dtype(name)


def _dtype_name(dtype) -> str:
    """A blob's dtype as the header names it: the port's uint16 bit
    patterns are bf16 rows, named as the JAX package names its own."""
    dtype = np.dtype(dtype)
    return "bfloat16" if dtype == np.uint16 else str(dtype)


def sweep_stale(dir: Path, live_seg_names: set, keep_any: bool,
                age_s: float = 3600.0) -> None:
    """Unlink sidecars whose covered segments no longer exist (compaction
    rewrote them under fresh names) or, with ``keep_any=False`` (IVF mode
    off), every sidecar — blobs are a full extra copy of their bucket and
    must not leak disk once the mode is disabled. Age-gated like the
    segment orphan sweep: a fresh file may belong to a concurrent writer
    whose manifest commit (new segment names) lands within seconds."""
    import time
    cutoff = time.time() - age_s
    for p in Path(dir).glob("ivf-*.tmp"):
        try:   # torn write (crash mid-save): never readable, just old
            if p.stat().st_mtime < cutoff:
                p.unlink(missing_ok=True)
        except OSError:
            pass
    for p in Path(dir).glob("ivf-*.bin"):
        try:
            if p.stat().st_mtime >= cutoff:
                continue
            got = _read_header(p)
            stale = got is None or not keep_any or any(
                name not in live_seg_names
                for name, _ in got[0].get("segments", []))
            if stale:
                p.unlink(missing_ok=True)
        except OSError:
            pass
