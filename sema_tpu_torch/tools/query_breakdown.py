"""Single-query latency anatomy on the port (``tools/query_breakdown.py``).

Splits a ``manager.search``-shaped semantic query into its stages, on a
real disk-backed store (``load_test.build_store``) and the MiniLM-L6
encoder with random weights from seed 0:

    tokenize        host-only WordPiece of the query text
    rtt             a one-element add on the device and its ``.item()``
    embed_device    the encoder's forward (K2) at batch 1, device time
    scan_device     the store's scan of one query (K1), device time
    embed_e2e       one forward, call to host copy
    search_e2e      encode_query_device -> VectorStore.search, per call
                    (the CLI / engine path)

``embed_device_ms`` and ``scan_device_ms`` are the kernels' own time that
torch.profiler sums over ``--iters`` calls, a call; ``embed_event_ms``
and ``scan_event_ms`` (not in the JAX tool) are CUDA events around the
same back-to-back calls, which a call's host work bounds from below when
the kernels take less. The residual ``search_e2e - tokenize -
embed_device - scan_device`` is host work; ``residual_in_rtts`` sets it
against the round trip. On ``--device cpu`` every device time is host
time. Prints ONE JSON line, with ``device`` and ``launches``; exits
non-zero unless every stage is positive.

Usage: python -m sema_tpu_torch.tools.query_breakdown --rows 262144
       [--iters 32]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import random_params
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.tokenizer import load_tokenizer
from sema_tpu_torch.tools import (call_ms, device_label, launch_counts,
                                  launches_since)
from sema_tpu_torch.tools.load_test import build_store

QUERY = "how does the crawler respect gitignore rules"


def _p50(xs):
    return float(np.percentile(xs, 50))


def _host_ms(fn, n: int) -> float:
    """p50 host ms of ``n`` calls of ``fn``."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return _p50(ts) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=262_144)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    before = launch_counts()
    store, probes, _ = build_store(
        tempfile.mkdtemp(prefix="sema-qbreak-"), args.rows, args.dim,
        device=dev)
    spec = get_spec("minilm-l6")
    tok, _ = load_tokenizer(spec.vocab_size, spec.hf_repo)
    enc = Encoder(spec, random_params(spec, seed=0), tok,
                  compute_dtype=torch.bfloat16, device=dev)
    n = args.iters

    qv = enc.encode_query_device(QUERY)       # every path once
    store.search(qv, 10)

    tokenize_ms = _host_ms(lambda: enc.tokenize_batch([QUERY], pad_to=1), n)
    one = torch.zeros(1, device=dev)
    rtt_ms = _host_ms(lambda: (one + 1).item(), n)

    ids, mask = enc.tokenize_batch([QUERY], pad_to=1)
    dids = torch.as_tensor(ids, device=dev)
    dmask = torch.as_tensor(mask, device=dev)
    embed = call_ms(lambda: enc.embed_ids(dids, dmask), n, dev)
    q1 = probes[:1]
    scan = call_ms(lambda: store.search_batch(q1, 10), n, dev)

    embed_e2e_ms = _host_ms(lambda: enc.embed_ids(dids, dmask)[0].cpu(), n)
    res = []

    def search():
        res[:] = store.search(enc.encode_query_device(QUERY), 10)
    search_e2e_ms = _host_ms(search, n)

    residual = (search_e2e_ms - tokenize_ms - embed["kernel_ms"]
                - scan["kernel_ms"])
    out = {
        "rows": args.rows,
        "tokenize_ms": round(tokenize_ms, 3),
        "rtt_ms": round(rtt_ms, 3),
        "embed_device_ms": round(embed["kernel_ms"], 3),
        "scan_device_ms": round(scan["kernel_ms"], 3),
        "embed_event_ms": round(embed["event_ms"], 3),
        "scan_event_ms": round(scan["event_ms"], 3),
        "embed_e2e_ms": round(embed_e2e_ms, 3),
        "search_e2e_ms": round(search_e2e_ms, 3),
        "residual_ms": round(residual, 3),
        "residual_in_rtts": round(residual / rtt_ms, 2) if rtt_ms else None,
        "device": device_label(dev),
        "launches": launches_since(before),
    }
    print(json.dumps(out), flush=True)
    store.close()
    stages = ("tokenize_ms", "rtt_ms", "embed_device_ms", "scan_device_ms",
              "embed_e2e_ms", "search_e2e_ms")
    # a random-init encoder ranks meaninglessly: the path must answer
    return 0 if res and all(out[s] > 0 for s in stages) else 1


if __name__ == "__main__":
    sys.exit(main())
