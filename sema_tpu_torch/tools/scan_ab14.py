"""Scan A/B #14 on the port: the fold-merge scan (K9) against the shipped one (K1).

The port of ``tools/scan_ab14.py``. The same data from the same numpy
seed (1): an unnormalized normal store cast to bf16 and 4 query sets.
``fold_topk`` (K9) is held against ``scan_topk(masked=False)`` (K1): ids
and scores equal, then both timed, K1 once more after K9 to bound drift.

Usage:  python -m sema_tpu_torch.tools.scan_ab14 [--rows 1048576]
        [--dim 384] [--q 256] [--k 10] [--small] [--device cuda|cpu]

``--small`` is the JAX tool's ``--interpret`` check, on the chosen
device: an f32 store of 8,192 x 128 from seed 0 with row 4096 = row 100
(a duplicate in another span) and row 5000 = row 5001 (a tie in one
span), Q 8, k 10. ``--device cpu`` runs the plain versions; the JAX
tool's ``--tile-n`` has no counterpart. On a card the fast-path share of
K9's merged spans is printed too. Prints, last, one JSON line: rows, dim,
qbatch, k, ids_identical, ms, device, launches. Exits non-zero on an id
mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.ops.scan_topk import fold_topk, scan_topk
from sema_tpu_torch.tools import device_name, measure


def small_data():
    """The JAX tool's ``--interpret`` data: (8192, 128) f32 store with its
    two planted ties, (8, 128) queries, from seed 0."""
    rng = np.random.default_rng(0)
    store = rng.standard_normal((8192, 128), dtype=np.float32)
    store[4096] = store[100]      # cross-tile duplicate (tie)
    store[5000] = store[5001]     # in-tile same-lane-region tie
    queries = rng.standard_normal((8, 128), dtype=np.float32)
    return store, queries


def make_data(n: int, d: int, qn: int):
    """The JAX tool's store (n, d) and query sets (4, qn, d), f32 numpy,
    from seed 1."""
    rng = np.random.default_rng(1)
    store = rng.standard_normal((n, d), dtype=np.float32)
    qsets = rng.standard_normal((4, qn, d), dtype=np.float32)
    return store, qsets


def same(got, want) -> tuple:
    """(ids equal, scores equal with -inf slots as 0)."""
    fin = lambda s: torch.where(torch.isfinite(s), s, torch.zeros_like(s))
    return (torch.equal(got[1], want[1]),
            torch.equal(fin(got[0]), fin(want[0])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--q", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--small", action="store_true",
                    help="the small semantics check with planted ties")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    before = (scan_topk.launches, fold_topk.launches)

    def report(n, d, qn, k, ok, ms):
        print(json.dumps({
            "rows": n, "dim": d, "qbatch": qn, "k": k, "ids_identical": ok,
            "ms": ms, "device": device_name(dev),
            "launches": {"scan_topk": scan_topk.launches - before[0],
                         "fold_topk": fold_topk.launches - before[1]}}))

    if args.small:
        store_np, q_np = small_data()
        store = torch.from_numpy(store_np).to(dev)
        qs = torch.from_numpy(q_np).to(dev)
        valid = torch.ones(store.shape[0], dtype=torch.bool, device=dev)
        ids_eq, sc_eq = same(fold_topk(store, qs, 10),
                             scan_topk(store, qs, valid, 10, masked=False))
        print("small semantics:", "OK" if ids_eq and sc_eq else "MISMATCH")
        report(8192, 128, 8, 10, ids_eq and sc_eq, {})
        return 0 if ids_eq and sc_eq else 1

    n, d, qn, k = args.rows, args.dim, args.q, args.k
    print(f"store {n}x{d} bf16, Q={qn}, k={k}, device {device_name(dev)}")
    store_np, qsets_np = make_data(n, d, qn)
    store = torch.from_numpy(store_np).to(dev).to(torch.bfloat16)
    del store_np
    qsets = torch.from_numpy(qsets_np).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)

    def ref(q):
        return scan_topk(store, q, valid, k, masked=False)

    def var(q):
        return fold_topk(store, q, k)

    # correctness first
    stats = (torch.zeros(2, dtype=torch.int64, device=dev)
             if dev.type == "cuda" else None)
    ids_eq, sc_eq = same(fold_topk(store, qsets[0], k, stats=stats),
                         ref(qsets[0]))
    print("ids equal:", ids_eq, " scores equal:", sc_eq)
    if stats is not None:
        merged, fast = stats.tolist()
        print(f"fold fast path: {fast} of {merged} merged spans "
              f"({fast / max(merged, 1):.3f})")
    if not ids_eq:
        report(n, d, qn, k, False, {})
        return 1

    t_ref = measure(ref, qsets, n_calls=64)
    t_var = measure(var, qsets, n_calls=64)
    # interleave once more to bound drift
    t_ref2 = measure(ref, qsets, n_calls=64)
    unit = "device" if dev.type == "cuda" else "host"
    print(f"shipped: {t_ref:.2f} / {t_ref2:.2f} ms/batch   "
          f"fold: {t_var:.2f} ms/batch ({unit} ms)")
    report(n, d, qn, k, True,
           {"shipped": t_ref, "fold": t_var, "shipped_again": t_ref2})
    return 0


if __name__ == "__main__":
    sys.exit(main())
