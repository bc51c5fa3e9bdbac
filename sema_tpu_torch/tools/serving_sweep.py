"""Serving headroom sweep on the port (``tools/serving_sweep.py``):
achieved QPS/p50/p99 against offered load.

Sweeps closed-loop client counts over one store and one QueryBatcher
(one process, one store: rung-to-rung numbers compare) and records the
batcher's per-stage stats ring after each rung:

  * achieved QPS flat while clients grow -> that rung was the knee;
  * queue_wait_p99 exploding, device_fetch flat -> dispatch/batching
    saturated (host side);
  * device_fetch_p50 growing with batch_size_mean -> the device scan is
    the wall (capacity = batch/device_time);
  * neither -> the client threads themselves (the GIL, scheduling);
    compare against the capacity phase's pipelined floor.

The store is ``load_test.build_store``'s (planted probe winners); the
scan is K1 on the card. Prints ONE JSON line: the JAX tool's keys plus
``device`` and ``launches``; exits non-zero when a rung has an error or a
mismatch. ``--device cpu`` runs the plain versions.

    python -m sema_tpu_torch.tools.serving_sweep --rows 1048576 \\
        --clients 8 32 128 512 1024 --duration 10
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time

import numpy as np

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.search.server import QueryBatcher
from sema_tpu_torch.tools import (device_label, launch_counts,
                                  launches_since)
from sema_tpu_torch.tools.load_test import build_store


def rung(batcher, probes, planted, clients: int, duration: float,
         k: int, warmup: float = 3.0) -> dict:
    """One closed-loop rung. Stats cover only the window [t0 + warmup,
    stop): queries issued while ``clients`` threads are still starting
    would put the herd's queue in the rung's p99."""
    stop = threading.Event()
    lat: list[list[tuple[float, float]]] = [[] for _ in range(clients)]
    errors = [0] * clients
    mismatches = [0] * clients
    n_probe = len(probes)

    def client(ci: int) -> None:
        rng = np.random.default_rng(7000 + ci)
        while not stop.is_set():
            pi = int(rng.integers(n_probe))
            t = time.perf_counter()
            try:
                res = batcher.search(probes[pi], k, timeout=120.0)
            except Exception:
                errors[ci] += 1
                stop.wait(0.1)   # Retry-After-style backoff
                continue
            lat[ci].append((t, time.perf_counter() - t))
            if not res or res[0][0].id != f"planted.txt:{planted[pi]}":
                mismatches[ci] += 1

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
    m_start = t0 + warmup
    lats = np.asarray(sorted(x for l in lat for ts, x in l
                             if ts >= m_start))
    elapsed = t_stop - m_start
    return {
        "clients": clients,
        "qps": round(lats.size / elapsed, 1),
        "p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 2)
        if lats.size else None,
        "p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 2)
        if lats.size else None,
        "errors": int(sum(errors)),
        "mismatches": int(sum(mismatches)),
        "batcher": batcher.stats(),   # the ring covers (the tail of) this rung
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--clients", type=int, nargs="+",
                    default=[8, 32, 128, 512, 1024])
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--duration", type=float, default=10.0,
                    help="steady-state window per rung (after --warmup)")
    ap.add_argument("--warmup", type=float, default=3.0,
                    help="per-rung seconds excluded from stats "
                    "(thread-start herd)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    before = launch_counts()
    tmp = args.data_dir or tempfile.mkdtemp(prefix="sema-sweep-")
    store, probes, planted = build_store(tmp, args.rows, args.dim,
                                         device=dev)
    batcher = QueryBatcher(store, max_batch=args.max_batch,
                           max_wait_ms=2.0)
    batcher.search(probes[0], args.k, timeout=1800.0)

    # the device capacity floor (pipelined batches straight through the
    # store): no rung can beat it; how close one gets says whether the
    # knee is on the device or the host
    qbatch = np.repeat(probes, args.max_batch // len(probes) + 1,
                       axis=0)[:args.max_batch]
    handles = []
    t0 = time.perf_counter()
    n_pipe = 8
    for _ in range(n_pipe):
        handles.append(store.search_batch_async(qbatch, args.k))
        if len(handles) > 2:
            store.search_batch_finish(handles.pop(0), qbatch)
    while handles:
        store.search_batch_finish(handles.pop(0), qbatch)
    cap_per = (time.perf_counter() - t0) / n_pipe
    capacity_qps = args.max_batch / cap_per

    rungs = []
    for c in args.clients:
        r = rung(batcher, probes, planted, c, args.duration, args.k,
                 warmup=args.warmup)
        r["frac_of_capacity"] = round(r["qps"] / capacity_qps, 3)
        rungs.append(r)
        print(f"# clients {c}: qps {r['qps']} p50 {r['p50_ms']} "
              f"p99 {r['p99_ms']} ({r['frac_of_capacity']:.0%} of "
              f"device capacity)", file=sys.stderr, flush=True)

    # the knee: the first rung whose QPS gains under 10% on the one before
    knee = None
    for i in range(1, len(rungs)):
        if rungs[i]["qps"] < rungs[i - 1]["qps"] * 1.1:
            knee = rungs[i - 1]["clients"]
            break

    print(json.dumps({
        "rows": args.rows, "dim": args.dim, "k": args.k,
        "max_batch": args.max_batch,
        "capacity_qps_pipelined": round(capacity_qps, 1),
        "knee_clients": knee,
        "rungs": rungs,
        "device": device_label(dev),
        "launches": launches_since(before),
    }), flush=True)
    batcher.close()
    store.close()
    ok = all(r["errors"] == 0 and r["mismatches"] == 0 for r in rungs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
