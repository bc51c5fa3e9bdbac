"""Concurrent serving load test on the port (``tools/load_test.py``).

Drives a real :class:`VectorStore` through :class:`QueryBatcher` with N
concurrent client threads while (optionally) a mutator thread streams a
re-index into the same store: the "streaming re-index + 1024 concurrent
batched queries" configuration. Each client loops on planted probe
queries whose true top-1 row is known by construction (the planted rows
live in a file the mutator never touches), so every response is also a
correctness check under mutation. Before the clients, a capacity phase
runs full batches straight through the store, sequential and pipelined.

The store and its probes are the JAX tool's, from the same numpy seed
(``build_store``); the scans are the port's kernels: K1 on an exact bf16
store, K4a on an int8 one, K3/K4b on ``--ivf`` buckets, and the
mutator's appends go into the store's device tail in place.

Prints ONE JSON line with client-observed p50/p99 latency, aggregate QPS,
and error/mismatch counts: the JAX tool's keys, with ``scan_paths`` the
scan kernels that launched (the JAX tool lists its compiled scan
variants), plus ``device`` and ``launches``. Exits non-zero on an error or
a mismatch. ``--device cpu`` runs the plain versions. Usage::

    python -m sema_tpu_torch.tools.load_test --rows 262144 --clients 1024 \\
        --max-batch 256 --duration 15 --mutate
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.search.server import QueryBatcher
from sema_tpu_torch.tools import (device_label, launch_counts,
                                  launches_since)
from sema_tpu_torch.types import Chunk


def stream_path(gen: int) -> str:
    """The file the mutator's ``gen``-th batch lands in."""
    return f"stream-{gen}.txt"


def build_store(tmp, rows: int, dim: int, seed: int = 0,
                n_probe: int = 32, batches: int = 0, ivf: bool = False,
                store_dtype: str = "bfloat16", device="cuda"):
    """Synthetic normalized store with planted probe winners: (store,
    probes, planted ids), the JAX tool's from the same ``seed``.

    The first ``n_probe`` rows of ``planted.txt`` are the probes scaled by
    0.95, which beats any random row at realistic widths. One add per
    ``SEAL_ROWS``-sized batch, so each lands as one sealed bucket. With a
    persistent ``tmp`` a store that already holds >= ``rows`` live rows is
    reused as is: probes and planted ids are pure functions of ``seed``."""
    rng = np.random.default_rng(seed)
    probes = rng.standard_normal((n_probe, dim)).astype(np.float32)
    probes /= np.linalg.norm(probes, axis=1, keepdims=True)

    store = VectorStore(tmp, dim=dim, model="loadtest", ivf=ivf,
                        store_dtype=store_dtype, device=device)
    planted_ids = list(range(n_probe))
    if store.live_rows >= rows:
        print(f"# reusing existing store: {store.live_rows} live rows",
              file=sys.stderr, flush=True)
        return store, probes, planted_ids
    if not batches:
        batches = max(8, rows // VectorStore.SEAL_ROWS)
    per = rows // batches
    for b in range(batches):
        vecs = rng.standard_normal((per, dim)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        path = "planted.txt" if b == 0 else f"base-{b}.txt"
        if b == 0:
            vecs[:n_probe] = probes * 0.95
        chunks = [Chunk(id=f"{path}:{i}", file_path=Path(path),
                        start_line=i, end_line=i + 1,
                        content=f"chunk {b}/{i}")
                  for i in range(per)]
        store.add_chunks(chunks, vecs)
        print(f"# built {(b + 1) * per}/{rows} rows "
              f"({time.strftime('%H:%M:%S')})", file=sys.stderr,
              flush=True)
    return store, probes, planted_ids


def _unit_rows(rng, n: int, dim: int) -> np.ndarray:
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    return vecs


def _rows_chunks(path: str, n: int, content: str) -> list:
    return [Chunk(id=f"{path}:{i}", file_path=Path(path), start_line=i,
                  end_line=i + 1, content=content.format(i=i))
            for i in range(n)]


def run(rows: int, dim: int, clients: int, max_batch: int,
        duration: float, mutate: bool, k: int = 10,
        data_dir: str | None = None, mut_batch: int = 4096,
        ivf: bool = False, store_dtype: str = "bfloat16",
        warmup: float = 6.0, device="cuda") -> dict:
    """One load test (see the module docstring): the JSON line's dict."""
    dev = resolve_device(device)
    tmp = data_dir or tempfile.mkdtemp(prefix="sema-loadtest-")
    before = launch_counts()
    t0 = time.perf_counter()
    store, probes, planted = build_store(tmp, rows, dim, ivf=ivf,
                                         store_dtype=store_dtype,
                                         device=dev)
    n_probe = len(probes)
    build_s = time.perf_counter() - t0

    # the serving k-class on the store, and (mutating) the tail shapes
    # the streaming appends go through, once before the clocks start
    warm_timeout = 1800.0
    warm_t0 = time.perf_counter()
    batcher = QueryBatcher(store, max_batch=max_batch, max_wait_ms=2.0)
    batcher.search(probes[0], k, timeout=warm_timeout)
    mut_rng = np.random.default_rng(99)
    if mutate:
        for _ in range(3):
            store.add_chunks(_rows_chunks("warm.txt", mut_batch, "w"),
                             _unit_rows(mut_rng, mut_batch, dim))
            batcher.search(probes[0], k, timeout=warm_timeout)
        store.remove_file_chunks(Path("warm.txt"))
        batcher.search(probes[0], k, timeout=warm_timeout)
    warm_s = time.perf_counter() - warm_t0

    stop = threading.Event()
    # every sample is (query start, latency): the stats cover queries
    # issued after the first ``warmup`` seconds only (the herd of
    # ``clients`` threads starting at once)
    latencies: list[list[tuple[float, float]]] = [[] for _ in range(clients)]
    errors = [0] * clients
    err_times: list[list[float]] = [[] for _ in range(clients)]
    mismatches = [0] * clients

    # capacity phase: full batches straight through the store while the
    # mutator runs, the device serving floor without the client threads
    cap_queries = np.repeat(probes, max(1, max_batch // n_probe + 1),
                            axis=0)[:max_batch]
    cap_times: list[float] = []
    cap_seq_times: list[float] = []

    def capacity(rounds: int = 4, depth: int = 2) -> None:
        """Sequential and pipelined batches in turns, so that both see
        the same store states as the mutator adds buckets: one batch end
        to end at a time, then ``depth`` batches in flight (what
        QueryBatcher's dispatch/completion pipeline sustains)."""
        for _ in range(rounds):
            for _ in range(4):
                t = time.perf_counter()
                store.search_batch(cap_queries, k)
                cap_seq_times.append(time.perf_counter() - t)
            handles: list = []
            n_pipe = 8
            t0 = time.perf_counter()
            for _ in range(n_pipe):
                handles.append(store.search_batch_async(cap_queries, k))
                if len(handles) > depth:
                    store.search_batch_finish(handles.pop(0), cap_queries)
            while handles:
                store.search_batch_finish(handles.pop(0), cap_queries)
            per = (time.perf_counter() - t0) / n_pipe
            cap_times.extend([per] * n_pipe)

    def client(ci: int) -> None:
        rng = np.random.default_rng(1000 + ci)
        while not stop.is_set():
            pi = int(rng.integers(n_probe))
            t = time.perf_counter()
            try:
                res = batcher.search(probes[pi], k, timeout=120.0)
            except Exception:
                errors[ci] += 1
                err_times[ci].append(t)
                # back off as a client honouring 503/Retry-After would
                stop.wait(0.1)
                continue
            latencies[ci].append((t, time.perf_counter() - t))
            if not res or res[0][0].id != f"planted.txt:{planted[pi]}":
                mismatches[ci] += 1

    mutated_batches = [0]

    def mutator() -> None:
        gen = 0
        while not stop.is_set():
            path = stream_path(gen)
            store.add_chunks(
                _rows_chunks(path, mut_batch, f"stream {gen}/{{i}}"),
                _unit_rows(mut_rng, mut_batch, dim))
            if gen >= 2:
                store.remove_file_chunks(Path(stream_path(gen - 2)))
            mutated_batches[0] += 1
            gen += 1
            stop.wait(0.5)

    mut_thread = (threading.Thread(target=mutator, daemon=True)
                  if mutate else None)
    if mut_thread:
        mut_thread.start()

    capacity()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(warmup + duration)
    stop.set()
    t_stop = time.perf_counter()
    for t in threads:
        t.join(timeout=180)
    if mut_thread:
        mut_thread.join(timeout=60)

    # the steady window: queries issued in [t0 + warmup, stop); those
    # issued inside it and done after stop still count
    m_start = t0 + warmup
    all_samples = [s for l in latencies for s in l]
    warm_n = sum(1 for ts, _ in all_samples if ts < m_start)
    lats = np.asarray(sorted(lat for ts, lat in all_samples
                             if ts >= m_start))
    elapsed = t_stop - m_start
    win_errors = sum(1 for l in err_times for ts in l if ts >= m_start)
    cap_p50 = float(np.percentile(cap_times, 50)) if cap_times else None
    cap_seq_p50 = (float(np.percentile(cap_seq_times, 50))
                   if cap_seq_times else None)
    launches = launches_since(before)
    result = {
        "capacity_qps": round(max_batch / cap_p50, 1) if cap_p50 else None,
        "capacity_batch_p50_ms": round(cap_p50 * 1e3, 2) if cap_p50
        else None,
        "capacity_seq_qps": round(max_batch / cap_seq_p50, 1)
        if cap_seq_p50 else None,
        "capacity_seq_batch_p50_ms": round(cap_seq_p50 * 1e3, 2)
        if cap_seq_p50 else None,
        "batcher": batcher.stats(),
        "clients": clients,
        "max_batch": max_batch,
        "rows": rows, "dim": dim, "k": k,
        "duration_s": round(elapsed, 2),
        "warmup_s": warmup,
        "warmup_queries": int(warm_n),
        "queries": int(lats.size),
        "qps": round(lats.size / elapsed, 1),
        "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 2)
        if lats.size else None,
        "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 2)
        if lats.size else None,
        "errors": int(sum(errors)),
        "errors_steady": int(win_errors),
        "mismatches": int(sum(mismatches)),
        "mutated_batches": mutated_batches[0],
        "live_rows_end": store.live_rows,
        "build_s": round(build_s, 1), "warm_s": round(warm_s, 1),
        "residency": store.device_residency(),
        "ivf": ivf, "store_dtype": store_dtype,
        "hbm_budget_mb": os.environ.get("SEMA_TPU_HBM_BUDGET_MB"),
        "scan_paths": sorted(name for name in launches
                             if name.startswith("scan_")),
        "device": device_label(dev),
        "launches": launches,
    }
    batcher.close()
    store.close()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=262_144)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--clients", type=int, default=1024)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--duration", type=float, default=15.0,
                    help="steady-state measurement window (seconds); "
                    "runs AFTER --warmup")
    ap.add_argument("--warmup", type=float, default=6.0,
                    help="seconds of client traffic excluded from stats "
                    "(the herd of threads starting at once)")
    ap.add_argument("--mutate", action="store_true",
                    help="stream a re-index concurrently with serving")
    ap.add_argument("--mut-batch", type=int, default=4096,
                    help="rows per streamed re-index batch (every 0.5 s)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ivf", action="store_true",
                    help="cluster sealed buckets; serve via pruned probes")
    ap.add_argument("--store-dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8"])
    ap.add_argument("--hbm-budget-mb", type=float, default=None,
                    help="force an HBM budget (engages spill when the "
                    "store exceeds it); sets SEMA_TPU_HBM_BUDGET_MB")
    ap.add_argument("--data-dir", default=None,
                    help="persistent store directory (reused if it "
                    "already holds >= --rows live rows)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.hbm_budget_mb is not None:
        os.environ["SEMA_TPU_HBM_BUDGET_MB"] = str(args.hbm_budget_mb)
    result = run(args.rows, args.dim, args.clients, args.max_batch,
                 args.duration, args.mutate, k=args.k,
                 mut_batch=args.mut_batch, ivf=args.ivf,
                 store_dtype=args.store_dtype, data_dir=args.data_dir,
                 warmup=args.warmup, device=args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["errors"] == 0 and result["mismatches"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
