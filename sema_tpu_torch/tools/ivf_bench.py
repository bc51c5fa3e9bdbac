"""IVF benchmark on the port (``tools/ivf_bench.py``): the pruned scan's
recall and latency against the exact scan.

At the production bucket geometry (``ops/ivf.py`` and
``VectorStore.IVF_TILE``/``IVF_CLUSTER_ROWS``/``IVF_BUDGET_DIV``):

  1. the k-means build of one store's worth of rows on the device,
  2. the exact scan's (K1) single-query latency,
  3. the pruned scan's (K3) single-query latency and recall@k against the
     exact ids over an ``--nprobe`` sweep, with the share of tiles scanned.

The corpus is clustered: unit Gaussian centres plus noise scaled by
``--noise / sqrt(dim)`` (the ratio of noise norm to centre norm), cast to
bf16; queries are perturbed corpus rows (``--qnoise``). The JAX tool draws
them with ``jax.random`` on the device; the port draws them with numpy
from ``--seed`` by the same recipe (``make_corpus``, ``make_queries``).

Latency: one query's kernels take less time on the card than a wrapper
call takes on the host, so each latency gives the kernels' own time that
torch.profiler sums over ``--chain`` back-to-back calls, a call
(``exact_single_query_ms``, ``single_query_ms_device``), and the CUDA
event ms a call around the same block (``exact_single_query_event_ms``,
``single_query_event_ms``; not in the JAX tool). ``exact_recall_at_k``
(K1's ids against its plain version's) and ``plain_check`` (the first 8
queries' K3 hits at the first rung against the plain version's on the
same tiles: scores within 1e-5, a differing id only where its own score
is within 1e-5 of the slot's) are the port's own keys. Prints ONE JSON
line, with ``device`` and ``launches``; exits non-zero when the exact
recall is below 1 or ``plain_check`` fails. ``--device cpu`` runs the
plain versions.

    python -m sema_tpu_torch.tools.ivf_bench [--rows 1048576] [--dim 384]
        [--q 64]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.ops.ivf import cluster_layout, kmeans_cluster, select_tiles
from sema_tpu_torch.ops.scan_topk import (scan_topk, scan_topk_pruned,
                                          scan_topk_pruned_reference,
                                          scan_topk_reference)
from sema_tpu_torch.tools import (call_ms, device_label, launch_counts,
                                  launches_since)

PLAIN_CHECK_QUERIES = 8


def make_corpus(rows: int, dim: int, centers: int, noise: float,
                rng: np.random.Generator) -> np.ndarray:
    """(rows, dim) f32 unit rows around ``centers`` unit centres."""
    cent = rng.standard_normal((centers, dim), dtype=np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    g = rng.integers(0, centers, size=rows)
    x = cent[g]
    x += (noise / np.sqrt(dim)) * rng.standard_normal((rows, dim),
                                                      dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def make_queries(store: torch.Tensor, qn: int, qnoise: float,
                 rng: np.random.Generator) -> np.ndarray:
    """(qn, dim) f32 unit queries: ``qn`` rows of ``store`` (as the scans
    see them) drawn by ``rng``, plus noise of ratio ``qnoise``."""
    dim = store.shape[1]
    pick = torch.from_numpy(rng.integers(0, store.shape[0], size=qn))
    x = store[pick.to(store.device)].float().cpu().numpy()
    x += (qnoise / np.sqrt(dim)) * rng.standard_normal((qn, dim),
                                                       dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def hits_agree(store, q, got, want) -> tuple:
    """(ok, max abs score error) of a scan's (scores, ids) against its
    plain version's on the same rows: the same -inf slots, scores within
    1e-5, and a differing id only where the kernel's row scores within
    1e-5 of the plain version's score in that slot."""
    s_k, i_k = (t.cpu() for t in got)
    s_p, i_p = (t.cpu() for t in want)
    fin = torch.isfinite(s_p)
    if not torch.equal(torch.isfinite(s_k), fin):
        return False, float("inf")
    err = float((s_k[fin] - s_p[fin]).abs().max()) if fin.any() else 0.0
    ok = err <= 1e-5
    differ = (i_k != i_p) & fin
    if differ.any():
        rows = store[i_k.long().to(store.device)].float().cpu()
        own = (rows * q.to(store.dtype).float().cpu()[:, None, :]).sum(-1)
        ok = ok and bool(((own - s_p).abs() <= 1e-5)[differ].all())
    return ok, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--q", type=int, default=64, help="recall query count")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--centers", type=int, default=4096,
                    help="true generative clusters in the corpus")
    ap.add_argument("--noise", type=float, default=1.5,
                    help="corpus noise-to-center norm ratio")
    ap.add_argument("--qnoise", type=float, default=1.0,
                    help="query perturbation ratio")
    ap.add_argument("--nprobe", type=int, nargs="*",
                    default=[8, 16, 32, 64])
    ap.add_argument("--chain", type=int, default=64,
                    help="calls in a timed block")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tile = VectorStore.IVF_TILE
    rows = args.rows - args.rows % 8192  # k-means block alignment
    dim, k, qn = args.dim, args.k, args.q
    c = max(16, rows // VectorStore.IVF_CLUSTER_ROWS)
    n_tiles = rows // tile
    budget = max(2, n_tiles // VectorStore.IVF_BUDGET_DIV)
    print(f"# device {device_label(dev)}  rows {rows}x{dim}  c {c}  tiles "
          f"{n_tiles} budget {budget}", file=sys.stderr, flush=True)

    rng = np.random.default_rng(args.seed)
    store = torch.from_numpy(make_corpus(rows, dim, args.centers,
                                         args.noise, rng)).to(dev)
    store = store.to(torch.bfloat16)
    valid = torch.ones(rows, dtype=torch.bool, device=dev)
    qnp = make_queries(store, qn, args.qnoise, rng)
    queries = torch.from_numpy(qnp).to(dev)
    before = launch_counts()

    print("# stage: kmeans build", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    assign, cent = kmeans_cluster(store, c)
    assign = assign.cpu().numpy()    # the store's build fetches it too
    build_s = time.perf_counter() - t0
    perm, starts = cluster_layout(assign, c + 1)
    store_perm = store[torch.from_numpy(perm).long().to(dev)]
    cent_np = cent.cpu().numpy()

    print("# stage: exact scan", file=sys.stderr, flush=True)
    oracle = scan_topk(store, queries, valid, k, masked=False)
    oracle_ids = oracle[1].cpu().numpy()
    plain_ids = scan_topk_reference(store, queries, valid, k,
                                    masked=False)[1].cpu().numpy()
    exact_recall = float(np.mean([
        len(set(oracle_ids[i]) & set(plain_ids[i])) / k for i in range(qn)]))
    singles = [queries[i:i + 1] for i in range(min(4, qn))]
    turn = itertools.cycle(singles)
    exact = call_ms(lambda: scan_topk(store, next(turn), valid, k,
                                      masked=False), args.chain, dev)

    rungs = {}
    plain_check = None
    for nprobe in args.nprobe:
        # each query's tile list, picked on the host as the store does
        t0 = time.perf_counter()
        sels = [select_tiles(cent_np, starts, qnp[i:i + 1], nprobe, tile,
                             budget) for i in range(qn)]
        probe_ms = (time.perf_counter() - t0) / qn * 1e3
        if any(s is None for s in sels):
            rungs[f"nprobe{nprobe}"] = {"fallback": True}
            continue
        nlive = np.array([s[1] for s in sels], np.int64)

        def pruned(i, fn=scan_topk_pruned):
            return fn(store_perm, queries[i:i + 1], valid, sels[i][0],
                      int(nlive[i]), k, tile)

        got_all = [pruned(i) for i in range(qn)]
        if plain_check is None:
            checks = [hits_agree(store_perm, queries[i:i + 1], got_all[i],
                                 pruned(i, scan_topk_pruned_reference))
                      for i in range(min(PLAIN_CHECK_QUERIES, qn))]
            plain_check = {"nprobe": nprobe, "queries": len(checks),
                           "ok": all(ok for ok, _ in checks),
                           "max_abs_err": max(err for _, err in checks)}
        # recall@k against the exact ids, the per-query distribution
        recs = np.empty(qn)
        for i in range(qn):
            got = set(perm[got_all[i][1].cpu().numpy()[0]].tolist())
            recs[i] = len(got & set(oracle_ids[i].tolist())) / k
        turn_p = itertools.cycle(range(qn))
        t = call_ms(lambda: pruned(next(turn_p)), args.chain, dev)
        rungs[f"nprobe{nprobe}"] = {
            "recall_at_k": round(float(recs.mean()), 4),
            "recall_p5": round(float(np.percentile(recs, 5)), 4),
            "recall_min": round(float(recs.min()), 4),
            "single_query_ms_device": round(t["kernel_ms"], 4),
            "single_query_event_ms": round(t["event_ms"], 4),
            "tiles_scanned_frac": round(float(nlive.mean()) / n_tiles, 4),
            "host_probe_ms": round(probe_ms, 3),
            "speedup_vs_exact": round(exact["kernel_ms"] / t["kernel_ms"],
                                      2),
        }
        print(f"# nprobe {nprobe}: {rungs[f'nprobe{nprobe}']}",
              file=sys.stderr, flush=True)

    out = {
        "metric": f"ivf_pruned_scan_{rows // 1000}k_{dim}d",
        "rows": rows, "dim": dim, "k": k, "clusters": c,
        "tile": tile, "budget_tiles": budget, "q": qn,
        "noise": args.noise, "qnoise": args.qnoise,
        "centers": args.centers,
        "kmeans_build_s": round(build_s, 2),
        "exact_single_query_ms": round(exact["kernel_ms"], 4),
        "exact_single_query_event_ms": round(exact["event_ms"], 4),
        "exact_recall_at_k": exact_recall,
        "plain_check": plain_check,
        "device": device_label(dev),
        "launches": launches_since(before),
        "rungs": rungs,
    }
    print(json.dumps(out), flush=True)
    ok = exact_recall == 1.0 and (plain_check is None or plain_check["ok"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
