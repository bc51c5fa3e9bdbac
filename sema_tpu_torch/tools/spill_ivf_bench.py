"""Spilled-IVF benchmark on the port (``tools/spill_ivf_bench.py``): the
union probe against the streamed exact scan over a store whose sealed
buckets stay on the host.

Builds a real on-disk VectorStore whose sealed buckets are forced
host-resident (``SEMA_TPU_HBM_BUDGET_MB``, 16 unless set), with IVF on, so
the build writes each spilled bucket's cluster-major blob sidecar, and
measures end-to-end ``search_batch`` wall time for:

  1. the union probe: the probed tiles gathered from the blobs into one
     pinned staging buffer, uploaded, and scanned by K3 (K4b over an int8
     store's quantized blob), and
  2. the streamed exact scan: the same store reopened without IVF, every
     row of every spilled bucket staged host to device in slices of
     ``SPILL_SLICE_ROWS`` per batch, K1 over each slice (an int8 store
     streams its bf16 originals),

plus recall@k of (1) against (2)'s ids and the staged upload bytes of
each. Wall time is the metric here: the spill path is bound by host
fills and PCIe, not by its kernels. The corpus is the JAX tool's,
clustered, from the same numpy seeds (``_centers``, ``_slice_corpus``,
``_queries``).

Prints ONE JSON line: the JAX tool's keys, ``backend`` the torch device
type, plus ``device`` and ``launches``. The JAX tool's ``--split-ab``
timed its store's two-half staging (``SEMA_TPU_IVF_SPLIT``); the port's
store stages a probe into one buffer and has no such knob, so the flag is
gone and ``split_ab`` is always false. Exits non-zero when no bucket
spilled with an IVF blob. ``--device cpu`` runs the plain versions.

    python -m sema_tpu_torch.tools.spill_ivf_bench [--rows 262144]
        [--dim 384] [--q 1] [--store-dtype bfloat16|int8]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.index.vector_store import VectorStore, _stage_tiles
from sema_tpu_torch.ops.ivf import select_tiles
from sema_tpu_torch.tools import device_label, launch_counts, launches_since
from sema_tpu_torch.types import Chunk


def _centers(centers: int, dim: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    cent = rng.standard_normal((centers, dim), dtype=np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    return cent


def _slice_corpus(cent: np.ndarray, n: int, dim: int, noise: float,
                  slice_idx: int) -> np.ndarray:
    """One slice of the clustered corpus, a function of ``slice_idx``
    alone: a large build never holds the whole corpus."""
    rng = np.random.default_rng([1234, slice_idx])
    g = rng.integers(0, len(cent), size=n)
    x = cent[g] + (noise / np.sqrt(dim)) * rng.standard_normal(
        (n, dim), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def _queries(x0: np.ndarray, dim: int, qnoise: float,
             qn: int) -> tuple:
    """Perturbed rows of slice 0 as queries (their true neighbours may
    lie in any slice): (queries, source rows)."""
    rng = np.random.default_rng(99)
    qrows = rng.integers(0, len(x0), size=qn)
    q = x0[qrows] + (qnoise / np.sqrt(dim)) * rng.standard_normal(
        (qn, dim), dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, qrows


def _chunks(lo: int, hi: int, fname: str):
    return [Chunk(id=f"{fname}:{i}", file_path=Path(fname),
                  start_line=i, end_line=i, content=f"row {i}")
            for i in range(lo, hi)]


@contextmanager
def _ivf_env(value: str):
    """``SEMA_TPU_IVF`` at ``value`` while a store opens (the store reads
    it over its ``ivf`` argument, as the JAX tool sets it before each
    open), so an inherited value cannot make the exact reopen IVF; the
    caller's value is restored after."""
    saved = os.environ.get("SEMA_TPU_IVF")
    os.environ["SEMA_TPU_IVF"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("SEMA_TPU_IVF", None)
        else:
            os.environ["SEMA_TPU_IVF"] = saved


def _measure(store, queries: np.ndarray, k: int, repeats: int):
    """Median end-to-end search_batch wall seconds (after one warm-up
    call) and the last call's ids."""
    store.search_batch(queries, k)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _, ids = store.search_batch(queries, k)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), ids


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=262144)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--q", type=int, default=1,
                    help="query batch (interactive default 1: a large "
                         "batch's tile union exceeds the probe budget "
                         "by design and streams instead)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--centers", type=int, default=2048)
    ap.add_argument("--noise", type=float, default=1.5)
    ap.add_argument("--qnoise", type=float, default=1.0)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--recall-queries", type=int, default=16,
                    help="extra single-query probes scored against one "
                         "streamed exact batch for the recall estimate")
    ap.add_argument("--keep", type=str, default=None,
                    help="reuse/keep the store at this dir (skips the "
                         "build when the manifest already exists)")
    ap.add_argument("--seal-rows", type=int, default=None,
                    help="override SEAL_ROWS/IVF geometry for small "
                         "CPU smoke runs")
    ap.add_argument("--slice-rows", type=int, default=0,
                    help="build the store in slices of this many rows "
                         "(one segment each; 0 = one-shot); the corpus "
                         "is generated per slice, never whole")
    ap.add_argument("--store-dtype", type=str, default="bfloat16",
                    choices=("bfloat16", "int8"),
                    help="int8: quantized spill blobs, about half the "
                         "staged probe upload; full-precision rescore")
    ap.add_argument("--nprobe", type=int, default=None,
                    help="override SEMA_TPU_IVF_NPROBE for this run")
    ap.add_argument("--exact-oracle-only", action="store_true",
                    help="time the streamed exact leg as ONE oracle "
                         "batch instead of warmup+repeats")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="soft wall-clock budget: past it the tool sheds "
                         "work (fewer recall queries, a one-batch "
                         "streamed leg) and exits with what it has")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()

    def overtime() -> bool:
        return (args.deadline_s is not None
                and time.perf_counter() - t_start > args.deadline_s)

    # the sealed buckets go to the host before the store is built
    os.environ.setdefault("SEMA_TPU_HBM_BUDGET_MB", "16")
    if args.nprobe is not None:
        os.environ["SEMA_TPU_IVF_NPROBE"] = str(args.nprobe)
    dev = resolve_device(args.device)
    if args.seal_rows:
        VectorStore.SEAL_ROWS = args.seal_rows
        VectorStore.IVF_TILE = max(128, args.seal_rows // 8)
        VectorStore.IVF_CLUSTER_ROWS = VectorStore.IVF_TILE

    rows = args.rows - args.rows % VectorStore.IVF_TILE
    slice_rows = args.slice_rows or rows
    slice_rows -= slice_rows % VectorStore.IVF_TILE
    work = Path(args.keep) if args.keep else Path(
        tempfile.mkdtemp(prefix="spill-ivf-"))
    work.mkdir(parents=True, exist_ok=True)
    print(f"# device {device_label(dev)}  rows {rows}x{args.dim} "
          f"{args.store_dtype}  slices of {slice_rows}  dir {work}",
          file=sys.stderr, flush=True)

    rq = max(args.q, args.recall_queries)
    cent = _centers(args.centers, args.dim)
    x0 = _slice_corpus(cent, min(slice_rows, rows), args.dim,
                       args.noise, 0)
    q_all, _ = _queries(x0, args.dim, args.qnoise, rq)
    q = q_all[:args.q]

    before = launch_counts()
    with _ivf_env("1"):
        store = VectorStore(work, args.dim, "bench", ivf=True,
                            store_dtype=args.store_dtype, device=dev)
    built = store.total_rows
    if built == 0:
        t0 = time.perf_counter()
        for s, lo in enumerate(range(0, rows, slice_rows)):
            hi = min(lo + slice_rows, rows)
            x = x0 if s == 0 else _slice_corpus(
                cent, hi - lo, args.dim, args.noise, s)
            store.add_chunks(_chunks(lo, hi, f"corpus-{s}.txt"),
                             x[:hi - lo])
            print(f"# slice {s}: rows {lo}..{hi} written "
                  f"({time.perf_counter() - t0:.0f}s)",
                  file=sys.stderr, flush=True)
        print(f"# built in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    elif built != rows:
        raise SystemExit(f"kept store has {built} rows, want {rows}")
    del x0
    t0 = time.perf_counter()
    buckets = store.device_buckets()   # the spilled-IVF layouts build here
    print(f"# bucket/IVF layout build: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    spilled = [b for b in buckets if b.get("host_resident")]
    if not spilled or spilled[0].get("ivf_spill") is None:
        print("!! the store did not spill with an IVF blob (the bench "
              "would measure nothing)", file=sys.stderr)
        store.close()
        return 1
    tile = store._spill_tile()    # the blob/probe tile, not IVF_TILE
    n_tiles = sum(b["ivf_spill"]["n_pad"] // tile for b in spilled
                  if b.get("ivf_spill"))

    probe_s, _ = _measure(store, q, args.k, args.repeats)
    # recall sample: one probe per query (the interactive shape); under a
    # deadline, queries past a floor of 32 are shed
    probe_id_rows = []
    for i in range(rq):
        probe_id_rows.append(store.search_batch(q_all[i:i + 1],
                                                args.k)[1][0])
        if len(probe_id_rows) >= 32 and overtime():
            break
    rq = len(probe_id_rows)
    q_all = q_all[:rq]
    probe_ids = np.stack(probe_id_rows)
    # staged bytes of one call: every spilled bucket's probed tiles
    itemsize = 2                  # bf16 rows, as the streamed path moves
    probe_bytes, n_live, staged_tiles = 0, 0, 0
    for b in spilled:
        iv = b.get("ivf_spill")
        if iv is None:    # too small for a blob: streams whole
            probe_bytes += b["rows"] * args.dim * itemsize
            continue
        # int8 blobs stage 1 byte an element and a 4-byte scale a row
        row_bytes = (args.dim + 4 if iv.get("scales") is not None
                     else args.dim * itemsize)
        bt = iv["n_pad"] // tile
        budget = max(2, bt // VectorStore.IVF_BUDGET_DIV)
        sel = select_tiles(iv["centroids"], iv["starts"],
                           q.astype(np.float32), store.ivf_nprobe,
                           tile, budget)
        if sel is None:   # over budget: the bucket streams whole
            probe_bytes += iv["n_pad"] * args.dim * itemsize
            continue
        b_eff = _stage_tiles(int(sel[1]), budget)
        n_live += int(sel[1])
        staged_tiles += b_eff
        probe_bytes += b_eff * tile * row_bytes
    nprobe = store.ivf_nprobe
    store.close()

    with _ivf_env("0"):
        store2 = VectorStore(work, args.dim, "bench", ivf=False,
                             store_dtype=args.store_dtype, device=dev)
    exact_bytes = rows * args.dim * itemsize
    oracle_only = bool(args.exact_oracle_only or overtime())
    if oracle_only:
        # one full stream timed as the oracle batch itself (the streamed
        # scan's wall is bound by its upload, whatever the batch)
        t0 = time.perf_counter()
        _, oracle_ids = store2.search_batch(q_all, args.k)
        exact_s = time.perf_counter() - t0
    else:
        exact_s, _ = _measure(store2, q, args.k, args.repeats)
        # one exact batch scores the whole recall sample in one pass
        _, oracle_ids = store2.search_batch(q_all, args.k)
    store2.close()

    # the per-query recall distribution, not just its mean
    per_q = np.asarray([
        len(set(probe_ids[i].tolist()) & set(oracle_ids[i].tolist()))
        / args.k for i in range(rq)])
    recall = float(per_q.mean())

    out = {
        "metric": "spill_ivf_probe_speedup",
        "value": round(exact_s / probe_s, 2),
        "unit": "x vs streamed exact (end-to-end batch wall)",
        "rows": rows, "dim": args.dim, "q_batch": args.q,
        "recall_at_k": round(recall, 4), "k": args.k,
        "recall_queries": rq,
        "recall_p5": round(float(np.percentile(per_q, 5)), 4),
        "recall_min": round(float(per_q.min()), 4),
        "probe_batch_s": round(probe_s, 4),
        "streamed_batch_s": round(exact_s, 4),
        "probe_upload_mb": round(probe_bytes / 1e6, 1),
        "streamed_upload_mb": round(exact_bytes / 1e6, 1),
        "probed_tiles": n_live, "staged_tiles": staged_tiles,
        "spilled_buckets": len(spilled),
        "total_tiles": n_tiles, "nprobe": nprobe,
        "store_dtype": args.store_dtype,
        "exact_oracle_only": oracle_only,
        "split_ab": False,
        "backend": dev.type,
        "device": device_label(dev),
        "launches": launches_since(before),
    }
    print(json.dumps(out), flush=True)
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
