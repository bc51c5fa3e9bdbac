"""Scan A/B #15 on the port: the warm-start scan (K8) against the cold one (K1).

The port of ``tools/scan_ab15.py``. The same data from the same numpy
seed (0): a store of unit rows cast to bf16, 4 sets of unit queries.
Each variant, cold and one warm start per ``--warm``, scans the store
without a mask (``scan_topk(..., masked=False, warm_rows=w)``); the ids
of the first query set are checked against cold's first, then each
variant is timed at ``--qbatch`` queries and at one.

Usage:  python -m sema_tpu_torch.tools.scan_ab15 [--rows 1048576]
        [--dim 384] [--qbatch 256] [--k 10] [--warm 2048 4096 8192]
        [--device cuda|cpu]

``--device cpu`` runs the plain versions (the JAX tool's ``--interpret``);
the JAX tool's ``--tile-n`` has no counterpart. Prints ms a call of each
variant (device time on a card, host time on the CPU) and, last, one JSON
line: rows, dim, qbatch, k, ids_identical, ms, device, launches. Exits
non-zero on an id mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.ops.scan_topk import scan_topk, scan_topk_warm
from sema_tpu_torch.tools import device_name, measure


def make_data(n: int, d: int, qn: int):
    """``tools/scan_ab15.py``'s store (n, d) and query sets (4, qn, d),
    f32 numpy, from seed 0."""
    rng = np.random.default_rng(0)
    store = rng.standard_normal((n, d)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    qsets = rng.standard_normal((4, qn, d)).astype(np.float32)
    qsets /= np.linalg.norm(qsets, axis=2, keepdims=True)
    return store, qsets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--qbatch", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--warm", type=int, nargs="+",
                    default=[2048, 4096, 8192])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n, d, qn, k = args.rows, args.dim, args.qbatch, args.k
    print(f"# device: {device_name(dev)}, {n}x{d} bf16, Q={qn}, k={k}",
          file=sys.stderr, flush=True)
    store_np, qsets_np = make_data(n, d, qn)
    store = torch.from_numpy(store_np).to(dev).to(torch.bfloat16)
    del store_np
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    qsets = torch.from_numpy(qsets_np).to(dev)

    variants = {"cold": 0}
    for w in args.warm:
        variants[f"warm{w}"] = w
    before = (scan_topk.launches, scan_topk_warm.launches)
    results = {}
    ref_ids = None
    fail = False
    for name, w in variants.items():
        def fn(q, w=w):
            return scan_topk(store, q, valid, k, masked=False, warm_rows=w)
        ids = fn(qsets[0])[1].cpu()
        if ref_ids is None:
            ref_ids = ids
        elif not torch.equal(ids, ref_ids):
            bad = torch.nonzero(ids != ref_ids)[:5].tolist()
            print(f"!! {name}: ids MISMATCH at {bad}", file=sys.stderr)
            fail = True
        ms = measure(fn, qsets, n_calls=64)
        results[name] = ms
        print(f"# {name}: {ms:.3f} ms/batch-{qn}"
              + ("" if name == "cold" else
                 f"  ({results['cold'] / ms:.2f}x vs cold)"),
              file=sys.stderr, flush=True)

    # single-query variant (serving path's latency class)
    singles = qsets[:, :1, :].contiguous()
    for name, w in list(variants.items()):
        def fn1(q, w=w):
            return scan_topk(store, q, valid, k, masked=False, warm_rows=w)
        ms = measure(fn1, singles, n_calls=32)
        results[name + "_q1"] = ms
        print(f"# {name} single-query: {ms:.3f} ms", file=sys.stderr,
              flush=True)

    print(json.dumps({
        "rows": n, "dim": d, "qbatch": qn, "k": k, "ids_identical": not fail,
        "ms": results, "device": device_name(dev),
        "launches": {"scan_topk": scan_topk.launches - before[0],
                     "scan_topk_warm": scan_topk_warm.launches - before[1]}}))
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
