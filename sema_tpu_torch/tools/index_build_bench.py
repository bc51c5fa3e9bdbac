"""End-to-end index-build throughput on the port
(``tools/index_build_bench.py``).

Generates a synthetic source tree (the JAX tool's, ``build_tree``), runs
``IndexManager.process_and_index_files`` over it end to end (crawl list,
chunk, hash, tokenize, length-bucketed embedding on the device, the
vector store's segments and the disk text index) and reports chunks per
second with the manager's per-stage totals (``Metrics.stage_time``). The
encoder has random weights from seed 0; ``--quant int8`` runs its linears
W8A8 (K5), else in bf16 (K2).

Prints ONE JSON line: the JAX tool's keys plus ``tree_chunks`` (what the
chunker makes of the tree, counted apart), ``device`` and ``launches``;
exits non-zero unless ``chunks`` equals ``tree_chunks`` and the store
holds them. ``--device cpu`` runs the plain versions.

Usage: python -m sema_tpu_torch.tools.index_build_bench --chunks 50000
       [--model minilm-l6] [--quant none|int8]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.index.manager import IndexManager
from sema_tpu_torch.ingest.chunker import process_files
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import random_params
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.tokenizer import load_tokenizer
from sema_tpu_torch.tools import device_label, launch_counts, launches_since
from sema_tpu_torch.utils.metrics import Metrics

_LOREM = ("the quick brown fox jumps over the lazy dog while the "
          "crawler walks directory trees and the chunker splits byte "
          "windows on newline boundaries before the encoder embeds "
          "them into the device resident store for exact retrieval ")


def build_tree(root: Path, n_chunks: int) -> int:
    """About 1,000-byte chunks, a few dozen a file (the chunker's windows
    are 1,000 B with 100 B overlap, so about ``n_chunks`` chunks come out
    of ``n_chunks`` KB). Returns the number of files."""
    root.mkdir(parents=True)
    per_file = 32  # ~32 KB files
    n_files = max(1, n_chunks // per_file)
    body = (_LOREM * 6)[:900]
    for i in range(n_files):
        lines = [f"file{i} chunk{j} " + body for j in range(per_file)]
        (root / f"src_{i:05d}.txt").write_text("\n".join(lines))
    return n_files


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, default=50_000)
    ap.add_argument("--model", default="minilm-l6")
    ap.add_argument("--quant", default="none", choices=("none", "int8"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tmp = Path(tempfile.mkdtemp(prefix="sema-ibench-"))
    tree = tmp / "tree"
    t0 = time.perf_counter()
    n_files = build_tree(tree, args.chunks)
    gen_s = time.perf_counter() - t0

    spec = get_spec(args.model)
    tok, _ = load_tokenizer(spec.vocab_size, spec.hf_repo)
    enc = Encoder(spec, random_params(spec, seed=0), tok,
                  compute_dtype=torch.bfloat16, quant=args.quant,
                  device=dev)
    metrics = Metrics()
    mgr = IndexManager(tmp / "data", enc, metrics=metrics)

    files = sorted(tree.glob("*"))
    before = launch_counts()
    t0 = time.perf_counter()
    n = mgr.process_and_index_files(files)
    build_s = time.perf_counter() - t0
    launches = launches_since(before)
    stored = mgr.vector_store.live_rows
    mgr.close()
    tree_chunks = len(process_files(files))

    stages = {name: round(t * 1e3, 1)
              for name, t in metrics.stage_time.items()}
    out = {
        "model": args.model,
        "quant": args.quant,
        "files": n_files,
        "chunks": n,
        "tree_chunks": tree_chunks,
        "tree_gen_s": round(gen_s, 1),
        "build_s": round(build_s, 1),
        "chunks_per_sec_e2e": round(n / build_s, 1),
        "stage_totals_ms": stages,
        "device": device_label(dev),
        "launches": launches,
        "extrapolated_1m_chunks_min_1chip": round(
            1e6 / (n / build_s) / 60, 1),
    }
    print(json.dumps(out), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0 if n == tree_chunks == stored else 1


if __name__ == "__main__":
    sys.exit(main())
