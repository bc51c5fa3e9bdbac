#!/usr/bin/env python3
"""Smoke run of ``sema_tpu_torch``, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, one JSON line each:

1. ``device``         the card, its power limit (nvidia-smi), torch and CUDA
2. ``build``          every kernel source of ``sema_tpu_torch/csrc``: one
                      ``nvcc`` each, all started together
3. ``scan_topk``      K1 against its plain version: bf16 stores of 262,144
                      and 3,000 rows at d=384, Q in {1, 256}, k in
                      {16, 64, 128}, masked and not, and f32 stores at the
                      wider models' d (768, 1024), whose rows pass 1 reads
                      in slabs. Duplicated rows must
                      give identical ids; elsewhere ids may differ only
                      between scores within 1e-5 of each other, and scores
                      agree within 1e-5 (both sum the same f32 products in
                      another order). Kernel, plain and library times
                      beside the bound.
4. ``encoder_layer``  K2 against its plain version, bf16, at MiniLM width
                      (head dim 32) at every bucket shape of the index and
                      at the query's (1, 256), and at e5-base width (head
                      dim 64): see ``layer_close`` for the limits. The
                      same limits must reject the plain version with the
                      mask dropped, with the context zeroed and with the
                      keys' heads rotated, so the check sees attention.
                      K2 also in f32 (limit: the JAX package's f32
                      parity bound, 5e-5 + 1e-4 |x|; with the time of its
                      attention alone, K7 at the layer's shape) and f16 (limits of
                      its own, tighter than bf16's) at (256, 128), in bf16
                      at S = 384 and 512 (the key-block attention), and at
                      gte-large width (head dim 64, H = 1024) at every
                      bucket shape of the index, (64, 256) and the query's
                      (1, 256). The mutants must fail at every shape,
                      under the limit of its dtype. A case is timed as
                      the Encoder calls the layer, with its operands
                      gathered once (``layer_operands``; the output must
                      equal a call without them). Each case also times
                      its five launches apart (torch.profiler, by position
                      in the layer), and one query (B = 1) also over
                      copies of the weights that exceed L2 (``cold_ms``,
                      as a 24-layer query reads them); the LayerNorm
                      GEMMs' plan (``ln_gemm_plan``) must be the kernel's
                      own and their traced grids the plan's.
5. ``encoder_layer_int8``  K5 against its plain version: ``qmm`` (the row
                      quantization, the int8 GEMM and the rescale) bit-equal
                      at the four products of MiniLM and gte-large at M =
                      256 and 65,536; the W8A8 layer in bf16, f16 and f32 at
                      MiniLM (256, 256) and in bf16 at gte-large (1, 256),
                      (64, 256), (256, 256), (2048, 32) and (32, 512), under
                      ``K5_LIMITS``, which must reject the plain version with
                      attention broken. Library: ``torch._int_mm`` of the
                      four products alone. Launch times, the cold time and
                      the plans as K2's.
6. ``attention``      K6 (the qkv projection + attention of one shard of
                      heads) and K7 (attention alone, from a qkv) against
                      their plain versions at the local widths of gte-large
                      at tp 2 and 4 (512 and 256 wide, head dim 64) and of
                      MiniLM at tp 2 and 4 (192 and 96, head dim 32), in
                      bf16, f16 and f32: K6 at (B, S) (1, 256), (64, 256)
                      and (256, 192), K7 at (256, 32), (128, 128), (32,
                      512) and (16, 640) (the three-pass route), then both
                      at the tp_path's batches (K6 at the TP index batch
                      in f16 too). Limits: ``K67_LIMITS``, K2's
                      widened for what attention alone returns; they must
                      reject the plain version with the mask dropped, with
                      the keys' heads rotated and (K6) with its bias
                      dropped; ``rounding_probe`` (K7 at (4, 512) on scores
                      a fraction of a bf16 ulp apart) must reject the plain
                      version with its scores unrounded. Library:
                      ``F.scaled_dot_product_attention`` on the qkv viewed
                      as heads (K6: after ``torch.addmm``). K6 in bf16 and
                      f16 splits its device ms between its two launches
                      (the qkv GEMM, then the attention; torch.profiler)
                      beside ``addmm`` and SDPA alone, and checks the qkv
                      GEMM's plan (``ops/encoder_layer.py:qkv_gemm_plan``:
                      ``wgmma`` at index batches, the ring GEMM at one
                      query) against the kernel's own (``sema_qkv_plan``)
                      and its traced grid; in f32 it splits its time
                      between the SIMT qkv GEMM and the attention (K7
                      alone at its shape).
7. ``scan_int8``      K4a against its plain version: int8 stores of 262,144
                      rows at d = 1024 and 384, Q in {1, 256}, k in
                      {16, 128}, masked rows, a 17-way tie in one tile
                      (TIE) and one spread over 17 tiles (SPREAD_TIE,
                      across chunks and pass 2's runs); scores and ids
                      bit-equal; then K4a and K4b at d = 1024, Q 1, k
                      128 over the int8 rows in mapped pinned host memory
                      (``late_copies``: every copy of pass 1 crosses
                      PCIe), still bit-equal. Library: ``torch._int_mm`` + scales +
                      ``torch.topk`` (one query padded to the 17 rows
                      ``_int_mm`` needs). Each case also gives pass 1's
                      and pass 2's device ms apart (``scan_passes``).
8. ``scan_pruned``    K3 (bf16) and K4b (int8) over 40 of a 128-tile probe
                      budget of the same stores (tiles of 512, SPREAD_TIE's
                      among them): K4b bit-equal, K3 under K1's limits,
                      both ties in row order. Library: ``index_select`` of
                      the tiles + the product + topk. Pass 1 and pass 2
                      apart, as for ``scan_int8``.
9. ``main_path``      ``index`` then ``query`` of a generated tree of source
                      files through the CLI (MiniLM-L6, bf16, random weights
                      from seed 0, on the card). The launch counts are set
                      to 0 before each step and read after it: the index
                      must launch K2, the query K2 and K1. A second index
                      must index 0 chunks, and neither the index's embed
                      failure warning nor the query's substring fallback
                      may fire. The stored rows (per-row cosine >= 0.9999)
                      and the query's hits are held against the plain
                      versions on a sample. ``query --limit 1500``, above
                      the scans' K_MAX, must launch no scan (the store's
                      hierarchical route) and answer as with the plain
                      versions (``wide_query``); K1 and K4a must still
                      refuse k = 1,025 (``k_max_refusals``).
10. ``int8_ivf_path``  BASELINE config 4 with IVF on top: gte-large (24
                      layers, 1024 wide, random weights from seed 0, written
                      once as a safetensors file that every process loads)
                      with W8A8 linears (``quant = "int8"``), ``store_dtype =
                      "int8"``, ``rescore_k = 100``, ``ivf = true``,
                      ``ivf_nprobe = 32``. ``VectorStore.add_chunks`` fills
                      the data dir with 1,048,576 seeded synthetic rows
                      (unit vectors around 2,048 random centres, the JAX
                      package's clustered synthetic of ``tools/ivf_bench.py``):
                      4 sealed buckets. Then the CLI's ``index`` of the tree
                      above (its chunks land in the unsealed tail) and
                      ``query``: the query must launch K5 24 times, K2
                      not at all, K4b once per sealed bucket, K4a once (the
                      tail) and K1 not at all; the index's K5 launches must
                      match its batches per sequence bucket, with no K2.
                      The stored rows of a sample of the tail are held
                      against the plain encoder on the card (per-row
                      cosine >= 0.9999). The kernels' hits must equal the
                      plain versions' on the same card with the same tile
                      selection; a stored row as the query must come back
                      first through IVF; ``exact=True`` must launch K4a on
                      every bucket and no K4b. Prints recall@10 of the IVF
                      route against ``exact=True`` over 100 perturbed
                      stored rows (no limit: the frontier constant was
                      measured on other data), the query p50 over 20 warm
                      queries, the device busy share and per-stage seconds.
                      Then ``serve``: ``python -m sema_tpu_torch serve`` on
                      that data dir with ``--reindex-interval 2`` answers
                      256 requests from 32 clients (semantic queries from
                      the tree's chunks at k 10, one in 8 ``exact=true``, a
                      few keyword ones) with no error and no status but
                      200, every exact answer id for id the in-process
                      ``IndexManager.search``'s; three rewritten files are
                      found after the next re-index tick, and ``/healthz``
                      still shows one unsealed tail bucket and no new
                      bucket (the tick's rows went into the tail's spare
                      rows); SIGTERM stops it
                      with exit code 0 and no traceback. Prints qps,
                      p50/p99 ms, recall@10 of the IVF answers and
                      ``/healthz``'s batcher stats.
11. ``bf16_ivf_path`` the same with ``store_dtype = "bfloat16"`` and float
                      linears (``quant = "none"``): K2 24 times a query, K3
                      once per sealed bucket and K1 once; no serve.
12. ``spill_path``    the HBM spill: both stores of the IVF paths (filled
                      and indexed here when those phases did not run)
                      reopened through ``cli.make_index_manager`` with
                      ``[index] hbm_budget_mb = 640``, which leaves one
                      sealed bucket on the card (``device_residency``: 3
                      host buckets, 786,432 spilled rows). The first query
                      builds the three spill layouts (k-means on the
                      card, cluster-major blobs written; timed). 20 warm
                      queries on the IVF route (k 10) launch exactly the
                      encoder's 24 layers, the device bucket's K3/K4b at
                      tile 512, one or two K3/K4b over the staged probe at
                      tile 128 and the tail's K1/K4a, no K1 over a slice;
                      their hits equal the plain versions'; the first and
                      last row of a cluster of each spilled bucket come
                      back first; recall@10 against ``exact=True`` over
                      100 perturbed stored rows (not gated). 5 queries
                      with ``exact=True`` launch K1 once per spilled slice
                      of 262,144 rows; the bf16 store's hits and scores
                      equal bit for bit those of the store reopened with
                      no budget, the int8 store's those of the plain
                      versions. Then a real OOM: the bf16 store built with
                      no budget beside a ballast tensor that leaves 1.25
                      GiB free must spill each bucket whose upload raises
                      ``OutOfMemoryError``, and with the ballast freed
                      answer as before; a ``KernelError`` from a bucket
                      build must raise out of ``search``. Prints the first
                      query's seconds, the p50s, MiB staged, the host fill
                      per slice, the card's pinned host-to-device rate
                      and the exact route's bound from it, each spilled
                      launch's device ms and the busy share.
13. ``append_path``   the store's in-place device append, through
                      ``IndexManager`` as ``serve --reindex-interval``
                      drives it. The main path's store (MiniLM-L6, bf16,
                      the tree's 3,600 chunks; indexed here when
                      ``main_path`` did not run) takes 12 rounds of 3
                      rewritten files (the last in index slices of 10, so
                      several segments meet in one append), each round's
                      build then a query for an appended chunk's text.
                      Each round: the index stashed one segment of device
                      rows a slice, none left after the build; one
                      unsealed tail, grown in place while it had room
                      (``n_pad`` kept; a rebuilt tail holds
                      ``_pad_rows(2 * rows)``); no row copied from the
                      host (``h2d_bytes``: every ``Tensor.to`` to the
                      card); one K1 launch a query; the chunk found first.
                      Then a tombstone between an append and its build
                      must hide its rows; a search launched before an
                      append and build and finished after them answers as
                      before the append, plain and with the stream held
                      300 ms before its scan (the append then queued in
                      under half of that); the tail's live rows and mask
                      bit-equal to the same rows built from disk by a
                      second store; K1 on the tail under ``check_scan``
                      and the store's hits equal to the plain scans'.
                      Then one append each into the int8 IVF store of
                      ``int8_ivf_path`` (gte-large W8A8; filled and
                      indexed here when that phase did not run) with no
                      budget and under ``SPILL_BUDGET_MB`` (three sealed
                      buckets on the host, which must stay the same
                      objects; the tail on the card): the same round
                      checks, one K4a and 24 K5 launches a query, int8
                      values and scales bit-equal to a rebuild, hits and
                      rescored scores equal to the plain versions'. Every
                      number is printed before the failed checks fail the
                      phase, so it also runs on a revision without the
                      arena (step 0). Prints each round's index and append
                      ms, MiB of rows and masks copied to the card, the
                      buckets, the tail's rows and capacity, the query p50
                      after rounds 1, 8 and 12, the residency (the
                      arena's device bytes) and the card's power limit.
14. ``tp_path``       the tensor-parallel encoder: gte-large at full width
                      and depth over a (data 1, model 2) mesh whose two
                      shards lie on the card, behind an ``IndexManager``
                      with an exact bf16 store: the tree indexed (K6 for
                      each shard and layer of the 256 bucket's batches, K7
                      for the shorter buckets', exactly), 3 + 20 warm
                      queries (K6 48 times and K1 once a query), K2, K5
                      and every plain version never; the stored rows of
                      256 chunks against the single-device encoder (K2) on
                      the card at per-row cosine >= 0.999; the query and
                      its hits against the same TP path through the plain
                      versions. Then the same with W8A8 linears (K7 and
                      ``qmm`` in every layer, against K5), then four shards
                      at 4 of the 24 layers, embeddings only. First,
                      ``bert._linear`` at gte-large's widest shard product
                      must sum in f32, and every (B, S) at which the path
                      launches K6 or K7 must be one ``attention`` holds.
15. ``scan_ab``       the scan A/B paths, K8 (the warm-start scan) and K9
                      (the fold-merge scan) beside K1, each call counted
                      from 0 and checked against the count of calls made:
                      at 1,048,576 x 384 bf16 without a mask, Q 256 and 1,
                      k 10 (K8 warm 2,048, 4,096 and 8,192), 64 and 128
                      (warm 2,048), K8 on unit rows (``scan_ab15``'s kind),
                      K9 on normal rows (``scan_ab14``'s) with three planted
                      ties that the first queries hit; K8 masked on a sealed
                      bucket with 10% tombstones and TIE, with its warm
                      sample all tombstoned, and on one-hot rows whose
                      global k-th ties the sample's k-th
                      (``one_hot_ties``). Every K8 and K9 result must equal
                      K1's on the same inputs bit for bit; K1, K8 and K9
                      against their plain versions under ``check_scan``.
                      Kernel, plain and library (``torch.topk`` of the bf16
                      product) times beside the bound, and the share of
                      K9's merged spans that took the fast path. Then
                      ``python -m sema_tpu_torch.tools.scan_ab15`` and
                      ``scan_ab14`` (and ``scan_ab14 --small``) at their
                      default shapes, which must exit 0 with ids identical
                      through their kernels.
16. ``tui_path``      (right after ``main_path``, before ``append_path``
                      rewrites the tree) the bare ``python -m
                      sema_tpu_torch TREE``, the curses TUI, on the main
                      path's tree in fresh config and data dirs (MiniLM-L6,
                      random weights from seed 0), exec'd under a pty by a
                      runner (``TUI_RUNNER``) that logs the app's startup,
                      searches and previews with their wall ms and
                      launches: READY, two semantic queries (K2 and K1, no
                      other scan), the keyword query ``'backoff`` (no
                      launch), Down, Enter (a preview in plain text: the
                      runner blocks pygments), Esc, q; exit code 0. The
                      first one's results must equal, file for file and line
                      for line, ``Engine``'s grouping of an in-process
                      ``IndexManager.search`` on the same data dir; then the
                      port's ``tools/tui_monkey.py`` over the warm index
                      must print OK (the app's exit status it prints is
                      reported: see ``run_monkey``). Prints the time to
                      READY, each search's ms and the startup's launches.
17. ``doctor_path``   ``python -m sema_tpu_torch doctor --skip-quality``
                      in-process for MiniLM-L6 bf16, gte-large bf16 and
                      gte-large W8A8 over an int8 store (the weights of the
                      IVF paths): exit 0, the seven self-test checks ok
                      (``scan-mesh``: the bf16 store over a mesh of the one
                      card) and the unported one n/a, the self-test's K1, K4a
                      and K3 and the encoder's K2 (K5 for W8A8) launched;
                      then one full ``doctor`` on random MiniLM weights
                      must print ``quality gate     : SKIPPED`` and exit 1.
                      Prints each check's seconds and each encoder parity's
                      min cosine.

18. ``shard_path``    (after ``spill_path``) the store's rows sharded over a
                      mesh's ``index`` axis, SHARDS = 4 shards on the one
                      card (``make_mesh(..., devices=[cuda] * 4)``): first
                      small stores (``shard_synthetic``: a tie planted in
                      each of 4 shards must answer in row order over (1,
                      4) and (2, 1, 2); stored rows of a store clustered
                      per shard come back first through the probe and the
                      exact scan). Then the main path's MiniLM store
                      (3,600 chunks; indexed here when ``main_path`` did
                      not run) single-shard, then over (data 1, index 4)
                      and (slice 2, data 1, index 2): 20 queries answer the
                      single-shard store's row ids in order, scores within
                      1e-5; 4 K1 launches a bucket and 6 K2 a query;
                      ``--limit 1500`` (K1 at k 1,024 on each shard)
                      equal where scores are more than 1e-5 apart. Then
                      both IVF paths' stores (1,048,576 rows + the tree,
                      filled here when needed; no budget) single-shard,
                      then over (1, 4): the open re-clusters each sealed
                      bucket per shard (the single-shard sidecars' key
                      has shards 1; one sidecar a bucket written, the old
                      ones kept), 5 ``exact=True`` queries answer the
                      single-shard store's ids, K1/K4a once a shard a
                      bucket; 20 queries at the configured nprobe 32 and
                      at SHARD_NPROBE = 8, each bucket's shards through
                      K3/K4b or the exact scan, with recall@10 against
                      ``exact=True``. Every shard's launch of one query
                      is held against its plain version (``check_scan``'s
                      limits; K4a and K4b bit for bit). Prints each open's
                      seconds, the p50s, the busy shares and the launches
                      a query beside the single-shard store's.
19. ``tools_path``    (last) the port's measuring tools, each as ``python
                      -m sema_tpu_torch.tools.<name>`` in a fresh process
                      (``TOOLS``): ``load_test`` at 262,144 x 384 with 256
                      clients and the mutator, then at BASELINE config 4's
                      widths (int8 IVF, d 1,024, 64 clients); 0 errors, 0
                      mismatches. ``spill_ivf_bench`` in bf16 and int8: a
                      bucket spilled, the probe staging less than the
                      stream. ``query_breakdown`` (every stage > 0),
                      ``ivf_bench`` at 1,048,576 x 384 (K1's recall 1
                      against its plain version, recall not falling with
                      nprobe, K3's hits of 8 queries under ``check_scan``'s
                      limits), ``serving_sweep`` (8, 32, 128 clients, no
                      error), ``index_build_bench`` (MiniLM, then
                      gte-large W8A8; every chunk of the tree indexed) and
                      ``encoder_ablate`` at MiniLM (256, 256) (prod bit-equal
                      to K2; no_exp and no_softmax, the builds of
                      ``encoder_layer.cu`` with ``-DSEMA_ABLATE`` made in
                      the build phase, unequal to prod and at per-row
                      cosine >= 0.9999 to their plain versions), with
                      ``text_index_scale`` at 200,000 chunks on the host
                      beside it. Each must exit 0, name the card's
                      nvidia-smi line as its ``device`` and launch the
                      kernels its path reaches; their launches add to the
                      kernels line's.

``--parent-source DIR`` (another revision's tree, e.g. ``git archive REV
| tar -x -C build/parent``; its two kernel sources are built beside this
tree's) adds two phases, each output bit for bit against the parent's,
or where they differ, and both timed in turns in the same run:
``layer_bits``: K2, K5, K6 and K7 at every case of K2_SHAPES, K5_SHAPES,
K6_BS and K7_BS, and K6 and K7 at the tp_path's batches (K67_PATH);
``scan_bits``: K1, K3, K4a, K4b, K8 and K9 at every case of the
phases ``scan_topk``, ``scan_int8``, ``scan_pruned`` and ``scan_ab`` and
at the paths' shapes (PATH_SCANS), through the parent's own
``ops/scan_topk.py`` over its ``csrc/scan_topk.cu``; the scan cases must
be bit-equal. With ``--phases``, name them to run them.

Then the kernels line, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Every failure raises, so the script
exits non-zero before the last line; without a card, or without the
repository beside it, it exits non-zero at once. ``--phases a,b`` runs
only the named phases (and ``device`` and ``build``) and ends without the
kernels and ``ok`` lines.

Bounds use the H100 SXM data sheet: 3.35 TB/s of HBM, 989 TFLOP/s of
dense bf16 and f16, 1,979 TOP/s of int8 and 67 TFLOP/s of f32 outside the
tensor cores (at the 700 W limit; the device line says what this card
has).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import (ExitStack, contextmanager, redirect_stderr,
                        redirect_stdout)
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# the timing helpers and the wrappers' names the port's tools share;
# WRAPPERS maps a kernel's name in the kernels line to its wrapper's in
# sema_tpu_torch.ops
from sema_tpu_torch.tools import (WRAPPERS, device_ms, query_device_time,
                                  short_name)

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
D = 384                        # MiniLM-L6 width, the store's row width
DEV = torch.device("cuda")
QUERY = "retry the request with exponential backoff"
SEAL = 262_144                 # rows of a sealed bucket (VectorStore)
IVF_MODEL, GTE_D = "gte-large", 1024    # the int8/IVF paths' model, width
# the scan wrappers, by the name the store calls them under
SCANS = ("scan_topk", "scan_topk_int8", "scan_topk_pruned",
         "scan_topk_int8_pruned")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check(ok, what="check failed") -> None:
    """Raise unless ``ok`` (an ``assert`` would vanish under ``-O``)."""
    if not ok:
        raise RuntimeError(what)


def launch_profile(fn, per_call: int, iters: int = 5, layers: int = 1,
                   keep=lambda name: "at::native" not in name) -> list:
    """Device ms of each launch of ``fn()``, which runs ``layers`` layers
    of ``per_call`` kernels of ``csrc/`` each, by position in the layer
    (position ``i`` takes every ``per_call``-th kernel from ``i``): the
    mean over the last ``iters`` of ``iters + 1`` calls of ``fn`` under
    torch.profiler (the trace may miss a first kernel), with the kernel's
    name, grid, block and dynamic shared memory as the trace records them.
    PyTorch's own kernels (casts of the weights to the compute dtype) are
    left out (``keep``: the kernels to count, by name). A trace that
    misses more is taken again, twice at most, then reported as
    ``[{"error": ...}]``."""
    from torch.profiler import ProfilerActivity, profile
    want = per_call * layers * iters
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters + 1):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = sorted((e for e in events if e.get("cat") == "kernel"
                          and keep(e["name"])),
                         key=lambda e: e["ts"])
        if len(kernels) >= want:
            break
    else:
        return [{"error": f"{len(kernels)} kernels traced for {iters + 1} "
                          f"calls of {layers} x {per_call} launches"}]
    kernels = kernels[-want:]
    out = []
    for i in range(per_call):
        evs = kernels[i::per_call]
        names = sorted({short_name(e["name"]) for e in evs})
        args = evs[0].get("args", {})
        out.append({"kernel": names[0] if len(names) == 1 else names,
                    "ms": sum(e["dur"] for e in evs) / len(evs) / 1e3,
                    "grid": args.get("grid"), "block": args.get("block"),
                    "smem": args.get("shared memory")})
    return out


def scan_passes(fn) -> dict:
    """Device ms of each of a scan call's two launches (pass 1, pass 2)
    by ``launch_profile``, with pass 1's kernel and grid."""
    got = launch_profile(fn, 2, iters=10, keep=lambda n: "scan_pass" in n)
    if "error" in got[0]:
        return got[0]
    p1, p2 = got
    return {"pass1_ms": p1["ms"], "pass2_ms": p2["ms"],
            "pass1": p1["kernel"], "pass1_grid": p1["grid"],
            "pass1_smem": p1["smem"], "pass2_grid": p2["grid"],
            "pass2_block": p2["block"]}


def weight_copies(layer: dict, names, total_bytes: float = 100e6) -> list:
    """``layer`` and copies of it whose tensors ``names`` are clones, so
    many that their weights together pass ``total_bytes`` (twice the
    H100's 50 MB L2): a loop over the copies reads every layer's weights
    from device memory, as the 24 layers of a gte-large query do, where a
    loop over one layer finds them in L2."""
    size = sum(layer[n].numel() * layer[n].element_size() for n in names)
    return [layer] + [{**layer, **{n: layer[n].clone() for n in names}}
                      for _ in range(math.ceil(total_bytes / size) - 1)]


def layer_launches(fn, args, operands, names, per_call, iters) -> dict:
    """A layer's launches, each timed apart by the profiler, with the
    same layer over and over (``launches``: its weights stay in L2, as in
    ``ms``); for one query (B = 1) also over a loop of ``weight_copies``
    (``cold_ms`` by CUDA events and ``cold_launches``, per layer: each
    layer's weights come from device memory, as on the path). Every call
    takes its layer's operands, made once, as the Encoder's do
    (``operands(layer)``)."""
    x, layer, *rest = args
    warm = operands(layer)
    out = {"launches": launch_profile(lambda: fn(*args, operands=warm),
                                      per_call)}
    if x.shape[0] == 1:
        copies = [(c, operands(c)) for c in weight_copies(layer, names)]
        cycle = lambda: [fn(x, c, *rest, operands=o) for c, o in copies]
        out.update(copies=len(copies),
                   cold_ms=device_ms(cycle, max(2, iters // len(copies)))
                   / len(copies),
                   cold_launches=launch_profile(cycle, per_call, 2,
                                                len(copies)))
    return out


def bound(bytes_moved: float, ops: float, ops_per_s: float = BF16_OPS_PER_S):
    """(least ms the card could take, what bounds it): each input read
    once and each output written once at the HBM rate, against the
    operations at the peak rate of their type (bf16 tensor cores unless
    given)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _wrappers() -> dict:
    from sema_tpu_torch import ops
    return {name: getattr(ops, attr) for name, attr in WRAPPERS.items()}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


@contextmanager
def swapped(module: str, replacements: dict):
    """``module``'s attributes replaced by ``replacements`` (name → object)
    for the duration, then restored."""
    mod = importlib.import_module(module)
    saved = {name: getattr(mod, name) for name in replacements}
    for name, obj in replacements.items():
        setattr(mod, name, obj)
    try:
        yield
    finally:
        for name, obj in saved.items():
            setattr(mod, name, obj)


@contextmanager
def plain_layers():
    """The encoder's layer wrappers (K2, K5) replaced by their plain
    versions, on the same card (as ``plain_scans`` does for the scans)."""
    ops = importlib.import_module("sema_tpu_torch.ops")
    with swapped("sema_tpu_torch.models.bert", {
            "fused_encoder_layer": ops.encoder_layer_reference,
            "fused_encoder_layer_int8": ops.encoder_layer_int8_reference}):
        yield


@contextmanager
def plain_attention():
    """The tensor-parallel layer's kernels (K6, K7 and K5's ``qmm``)
    replaced by their plain versions, on the same card."""
    ops = importlib.import_module("sema_tpu_torch.ops")
    with swapped("sema_tpu_torch.models.bert", {
            "fused_attention_block": ops.attention_block_reference,
            "fused_attention_qkv": ops.attention_qkv_reference,
            "qmm": ops.qmm_reference}):
        yield


# every kernel's plain version, by the module its wrapper calls it from
PLAIN = {"sema_tpu_torch.ops.attention": ("attention_qkv_reference",
                                          "attention_block_reference"),
         "sema_tpu_torch.ops.encoder_layer": ("encoder_layer_reference",),
         "sema_tpu_torch.ops.encoder_layer_int8": (
             "encoder_layer_int8_reference", "qmm_reference")}


@contextmanager
def counted_plain_calls():
    """A Counter of the calls of each plain version of PLAIN, made through
    its wrapper's module, for the duration."""
    counts = Counter()
    with ExitStack() as stack:
        for module, names in PLAIN.items():
            mod = importlib.import_module(module)
            for name in names:
                def counted(*a, _fn=getattr(mod, name), _name=name, **k):
                    counts[_name] += 1
                    return _fn(*a, **k)
                stack.enter_context(swapped(module, {name: counted}))
        yield counts


@contextmanager
def plain_scans():
    """The store's scan wrappers replaced by their plain versions, on the
    same card (the port itself never does this: a CUDA tensor launches
    the kernel or raises)."""
    store_mod = importlib.import_module("sema_tpu_torch.index.vector_store")
    scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    saved = {name: getattr(store_mod, name) for name in SCANS}
    for name in SCANS:
        setattr(store_mod, name, getattr(scan_mod, f"{name}_reference"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(store_mod, name, fn)


# -- K1 -----------------------------------------------------------------------

TIE = [7] + list(range(100, 116))      # rows 100..115 duplicate row 7


def check_scan(store, queries, valid, masked, got, want,
               relative=False) -> float:
    """Raise unless the kernel's (scores, ids) agree with the plain
    version's: the same -inf slots (id 0), scores within 1e-5 (relative,
    floor 1, where ``relative``: rows and queries that are not unit
    vectors), and where ids differ, the kernel's row scores within 1e-5
    (relative, floor 1) of the plain version's score in that slot. Both
    sum the same f32 products in another order (6.6e-7 apart at most when
    measured on unit vectors), so a kernel that scored in bf16 would
    fail. Returns the max abs error."""
    s_k, i_k = got
    s_p, i_p = want
    fin = torch.isfinite(s_p)
    check(torch.equal(torch.isfinite(s_k), fin), "-inf slots differ")
    check(not i_k[~fin].any(), "a -inf slot has an id other than 0")
    diff = (s_k[fin] - s_p[fin]).abs()
    scale = s_p[fin].abs().clamp(min=1.0) if relative else 1.0
    err = float(diff.max()) if fin.any() else 0.0
    check(bool((diff <= 1e-5 * scale).all()), f"scores differ by {err}")
    differ = (i_k != i_p) & fin
    if differ.any():
        rows = store[i_k.long()].float()                        # (Q, k, d)
        own = (rows * queries.to(store.dtype).float()[:, None, :]).sum(-1)
        tol = 1e-5 * s_p.abs().clamp(min=1.0)
        check(((own - s_p).abs() <= tol)[differ].all(), "ids differ")
        if masked:
            check(valid[i_k.long()][differ].all(), "a tombstoned row")
    ids = i_k.masked_fill(~fin, -1).sort(dim=1).values
    check(not ((ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] >= 0)).any(),
          "a row appears twice")
    return err


def k1_inputs(n, nq, d, dtype, gen):
    """A K1 case's unit rows with TIE, queries (query 0 on TIE) and
    tombstones."""
    store = F.normalize(torch.randn(n, d, generator=gen, device=DEV), dim=1)
    store[TIE[1:]] = store[TIE[0]].clone()
    store = store.to(dtype)
    q = F.normalize(torch.randn(nq, d, generator=gen, device=DEV), dim=1)
    q[0] = store[TIE[0]].float()
    valid = torch.rand(n, generator=gen, device=DEV) > 0.1
    valid[TIE] = True
    return store, q, valid


def scan_case(n, nq, k, masked, gen, iters, d=D, dtype=torch.bfloat16):
    from sema_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference
    store, q, valid = k1_inputs(n, nq, d, dtype, gen)
    got = scan_topk(store, q, valid, k, masked)
    want = scan_topk_reference(store, q, valid, k, masked)
    torch.cuda.synchronize()
    err = check_scan(store, q, valid, masked, got, want)
    t = min(k, len(TIE))
    check(got[1][0, :t].tolist() == TIE[:t], "tied rows out of id order")
    qb = q.to(dtype)
    ms, bound_by = bound(n * d * store.element_size() + (n if masked else 0)
                         + nq * d * 4 + nq * k * 8, 2.0 * nq * n * d,
                         F32_OPS_PER_S if dtype == torch.float32
                         else BF16_OPS_PER_S)
    return {
        "n": n, "q": nq, "k": k, "masked": masked, "d": d,
        "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
        "ms": device_ms(lambda: scan_topk(store, q, valid, k, masked), iters),
        "plain_ms": device_ms(
            lambda: scan_topk_reference(store, q, valid, k, masked), iters),
        "library_ms": device_ms(lambda: torch.topk(qb @ store.T, k), iters),
        "bound_ms": ms, "bound_by": bound_by}


# phase scan_topk's cases: (n, Q, k, masked, d, dtype)
K1_CASES = tuple((n, nq, k, masked, D, torch.bfloat16)
                 for n in (262_144, 3_000) for nq in (1, 256)
                 for k in (16, 64, 128) for masked in (True, False)) + tuple(
    (3_000, nq, 64, True, d, torch.float32)
    for d in (768, 1024) for nq in (1, 256))


def phase_scan(gen):
    cases = [scan_case(n, nq, k, masked, gen, 10 if n > 10_000 else 30,
                       d=d, dtype=dt)
             for n, nq, k, masked, d, dt in K1_CASES]
    emit("scan_topk", cases=cases)


# -- K4a, K3, K4b -------------------------------------------------------------

IVF_TILE = 512                 # VectorStore.IVF_TILE on device buckets
PROBE_BUDGET = SEAL // IVF_TILE // 4    # a sealed bucket's tile budget
PROBE_LIVE = 40                # live tiles of the probes below
# 17 rows equal to row 1,000, one in each of 17 tiles spread over a sealed
# bucket: a tie that crosses chunks, and pass 2's runs
SPREAD_TIE = [1_000 + j * (SEAL // 17) for j in range(17)]


def scan_store(d, gen):
    """A sealed bucket's worth of unit rows with the 17-way tie TIE and
    SPREAD_TIE, as bf16 rows and as the int8 store quantizes them;
    tombstones; a tile list of PROBE_LIVE live tiles (tile 0, which holds
    TIE, and SPREAD_TIE's tiles among them) padded to the budget as
    ops/ivf.py:select_tiles pads it."""
    from sema_tpu_torch.ops.quant import quantize_rows_device
    rows = F.normalize(torch.randn(SEAL, d, generator=gen, device=DEV), dim=1)
    rows[TIE[1:]] = rows[TIE[0]].clone()
    rows[SPREAD_TIE[1:]] = rows[SPREAD_TIE[0]].clone()
    bf = rows.to(BF16)
    del rows
    qvals, scales = quantize_rows_device(bf)
    valid = torch.rand(SEAL, generator=gen, device=DEV) > 0.1
    valid[TIE + SPREAD_TIE] = True
    fixed = {0} | {r // IVF_TILE for r in SPREAD_TIE}
    others = [t for t in (torch.randperm(SEAL // IVF_TILE - 1, generator=gen,
                                         device=DEV) + 1).tolist()
              if t not in fixed][:PROBE_LIVE - len(fixed)]
    live = sorted(fixed | set(others))
    tiles = np.full(PROBE_BUDGET, live[-1], dtype=np.int32)
    tiles[:PROBE_LIVE] = live
    rows_idx = (torch.as_tensor(live, device=DEV)[:, None] * IVF_TILE
                + torch.arange(IVF_TILE, device=DEV)[None, :]).reshape(-1)
    return {"bf16": bf, "qvals": qvals, "scales": scales, "valid": valid,
            "tiles": tiles, "rows_idx": rows_idx, "d": d}


def int8_library(qvals, scales, valid, queries, k, idx=None):
    """(``index_select`` of the rows ``idx`` when given, then)
    ``torch._int_mm`` + scales + mask + ``torch.topk``, or None with the
    reason where ``_int_mm`` does not take the shape. ``_int_mm`` wants
    more than 16 rows, so fewer queries are padded with zero rows to 17
    and the padding's scores dropped."""
    from sema_tpu_torch.ops.quant import quantize_query
    nq = queries.shape[0]

    def fn():
        qv, sc, va = qvals, scales, valid
        if idx is not None:
            qv, sc, va = (qv.index_select(0, idx), sc.index_select(0, idx),
                          va.index_select(0, idx))
        qi, qs = quantize_query(queries)
        if nq <= 16:
            qi = torch.cat([qi, qi.new_zeros(17 - nq, qi.shape[1])])
        raw = torch._int_mm(qi, qv.t())[:nq]
        s = raw.float() * sc[None, :] * qs[:, None]
        return torch.topk(s.masked_fill(~va[None, :], float("-inf")), k)
    try:
        fn()
    except RuntimeError as e:
        return None, (f"no library call at Q={nq}, "
                      f"k={k}: {str(e).splitlines()[0][:120]}")
    return fn, None


def more_queries(data, nq, gen):
    """Unit queries: query 0 on TIE, query 1 on SPREAD_TIE."""
    q = F.normalize(torch.randn(nq, data["d"], generator=gen, device=DEV),
                    dim=1)
    q[0] = data["bf16"][TIE[0]].float()
    if nq > 1:
        q[1] = data["bf16"][SPREAD_TIE[0]].float()
    return q


def more_args(kind, data, q, k):
    """(wrapper name, args) of a K4a ("int8"), K3 ("pruned") or K4b
    ("int8_pruned") call on scan_store's data."""
    if kind == "int8":
        return "scan_topk_int8", (data["qvals"], data["scales"], q,
                                  data["valid"], k)
    store = ((data["qvals"], data["scales"]) if kind == "int8_pruned"
             else (data["bf16"],))
    return f"scan_topk_{kind}", (*store, q, data["valid"], data["tiles"],
                                 PROBE_LIVE, k, IVF_TILE)


def scan_more_case(kind, data, nq, k, gen, iters):
    """One case of K4a ("int8"), K3 ("pruned") or K4b ("int8_pruned")
    against its plain version, with times and bound."""
    scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    d, valid, tiles = data["d"], data["valid"], data["tiles"]
    q = more_queries(data, nq, gen)
    name, args = more_args(kind, data, q, k)
    fn, ref = getattr(scan_mod, name), getattr(scan_mod, f"{name}_reference")
    rows = SEAL if kind == "int8" else PROBE_LIVE * IVF_TILE
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    if kind == "pruned":
        err = check_scan(data["bf16"], q, valid, True, got, want)
    else:
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{kind} (d={d}, Q={nq}, k={k}): not bit-equal to the plain "
              "version")
        err = 0.0
    t = min(k, len(TIE))
    check(got[1][0, :t].tolist() == TIE[:t], f"{kind}: tied rows out of id "
          "order")
    check(nq == 1 or got[1][1, :t].tolist() == SPREAD_TIE[:t],
          f"{kind}: the tie across chunks out of id order")
    if kind != "int8":
        live_tiles = set(tiles[:PROBE_LIVE].tolist())
        fin = torch.isfinite(got[0])
        check(all(int(i) // IVF_TILE in live_tiles
                  for i in got[1][fin].tolist()), f"{kind}: a row outside "
              "the probed tiles")
    isz = 2 if kind == "pruned" else 1
    ms, bound_by = bound(
        rows * d * isz + rows * (1 if kind == "pruned" else 5)
        + nq * d * 4 + nq * k * 8 + (0 if kind == "int8" else 4 * PROBE_LIVE),
        2.0 * nq * rows * d,
        BF16_OPS_PER_S if kind == "pruned" else INT8_OPS_PER_S)
    idx = data["rows_idx"]
    note = None
    if kind == "pruned":
        store = data["bf16"]
        lib = lambda: torch.topk((q.to(BF16) @ store.index_select(0, idx).T)
                                 .masked_fill(~valid[idx][None, :],
                                              float("-inf")), k)
    else:
        lib, note = int8_library(data["qvals"], data["scales"], valid, q, k,
                                 idx if kind == "int8_pruned" else None)
    out = {"kernel": {"int8": "K4a", "pruned": "K3",
                      "int8_pruned": "K4b"}[kind],
           "n": SEAL, "rows_scanned": rows, "d": d, "q": nq, "k": k,
           "max_abs_err": err, "ms": device_ms(lambda: fn(*args), iters),
           "plain_ms": device_ms(lambda: ref(*args), max(2, iters // 3)),
           "library_ms": None if lib is None else device_ms(lib, iters),
           "bound_ms": ms, "bound_by": bound_by,
           "passes": scan_passes(lambda: fn(*args))}
    if note:
        out["library_note"] = note
    return out


def host_mapped(t: torch.Tensor):
    """(a CUDA tensor over a copy of int8 ``t`` in pinned host memory,
    that memory): a kernel reads the rows across PCIe, so each of its
    copies lands microseconds late."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)

    class Mapped:
        __cuda_array_interface__ = {"shape": tuple(t.shape), "typestr": "|i1",
                                    "data": (host.data_ptr(), False),
                                    "strides": None, "version": 2}
    mapped = torch.as_tensor(Mapped(), device=DEV)
    check(mapped.data_ptr() == host.data_ptr(), "the mapped rows moved")
    return mapped, host


def late_copies_case(kind, data, gen) -> dict:
    """K4a ("int8") or K4b ("int8_pruned") at one query, where pass 1
    keeps three stages in flight, over int8 rows in mapped host memory
    (``host_mapped``): a stage scored before its copies have landed reads
    the rows of an earlier stage. Scores and ids must equal the plain
    version's on the same rows on the card, bit for bit."""
    scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    q = more_queries(data, 1, gen)
    mapped, host = host_mapped(data["qvals"])
    name, args = more_args(kind, dict(data, qvals=mapped), q, 128)
    _, ref_args = more_args(kind, data, q, 128)
    got = getattr(scan_mod, name)(*args)
    torch.cuda.synchronize()
    want = getattr(scan_mod, f"{name}_reference")(*ref_args)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{kind} over rows in host memory (d={data['d']}, Q=1, k=128): "
          "not bit-equal to the plain version")
    ms = device_ms(lambda: getattr(scan_mod, name)(*args), 3)
    del mapped, host
    return {"kernel": {"int8": "K4a", "int8_pruned": "K4b"}[kind],
            "d": data["d"], "q": 1, "k": 128, "ms": ms}


def phase_scan_more(gen):
    int8_cases, pruned_cases, late = [], [], []
    for d in (GTE_D, D):
        data = scan_store(d, gen)
        for nq in (1, 256):
            for k in (16, 128):
                iters = 10 if nq == 1 else 5
                int8_cases.append(scan_more_case("int8", data, nq, k, gen,
                                                 iters))
                for kind in ("pruned", "int8_pruned"):
                    pruned_cases.append(scan_more_case(kind, data, nq, k,
                                                       gen, iters))
        if d == GTE_D:
            late = [late_copies_case(kind, data, gen)
                    for kind in ("int8", "int8_pruned")]
        del data
        torch.cuda.empty_cache()
    emit("scan_int8", cases=int8_cases, late_copies=late)
    emit("scan_pruned", cases=pruned_cases)
    return int8_cases, pruned_cases


# -- K8, K9: the scan A/B paths -----------------------------------------------

AB_N = 1 << 20                 # the A/B tools' store: 1,048,576 rows at D
AB_WARM = (2048, 4096, 8192)   # scan_ab15's warm starts (k 10; k 64, 128: 2048)
AB_SHAPES = ((256, 10), (1, 10), (256, 64), (1, 64), (256, 128), (1, 128))
# K9's planted ties: an adjacent pair (two lanes of one span: the fast
# path's tie order), a pair 32 rows apart (one lane: the slow path) and a
# duplicate in another span (scan_ab14's 4096 = 100), each the query of
# one of the first three queries, so the ties land in the top k
FOLD_TIES = ((406_200, 406_201), (700_000, 700_032), (100, 4096))
AB_TIE_N, AB_TIE_Q, AB_TIE_K = SEAL, 8, 10


def ab_stores(gen):
    """scan_ab15's kind of store (unit rows, bf16) and scan_ab14's
    (normal rows, bf16, with FOLD_TIES), made on the card."""
    warm = F.normalize(torch.randn(AB_N, D, generator=gen, device=DEV),
                       dim=1).to(BF16)
    fold = torch.randn(AB_N, D, generator=gen, device=DEV)
    for a, b in FOLD_TIES:
        fold[b] = fold[a]
    return warm, fold.to(BF16)


def ab_queries(warm, fold, nq, gen):
    qw = F.normalize(torch.randn(nq, D, generator=gen, device=DEV), dim=1)
    qf = torch.randn(nq, D, generator=gen, device=DEV)
    for j, (a, _) in enumerate(FOLD_TIES[:nq]):
        qf[j] = fold[a].float()
    return qw, qf


def one_hot_ties(warm_rows, gen):
    """The JAX tie test (tests/test_pallas_topk.py:287-304) scaled up:
    AB_TIE_N rows of zeros but for the first AB_TIE_Q columns, query c
    one-hot on column c, so each score is one stored bf16 value exactly.
    In column c, at scale 2^c / 256: the background under 0.4; inside the
    warm sample 2 rows at 0.9 and 9 at 0.5, so the sample's k-th is 0.5;
    outside it 3 rows at 0.95 and 4 at 0.5. The top 10 are the 0.95s, the
    0.9s and the first five 0.5s, all inside the sample: the global k-th
    equals the sample's, and a screen at the sample's k-th itself drops
    five rows of the top 10. Query c + 1's threshold (about 2^c / 256)
    lies above every score of query c."""
    store = torch.zeros(AB_TIE_N, D, device=DEV)
    for c in range(AB_TIE_Q):
        s = 2.0 ** c / 256
        col = torch.rand(AB_TIE_N, generator=gen, device=DEV) * 0.4 * s
        pick = torch.randperm(warm_rows, generator=gen, device=DEV)[:11]
        col[pick[:2]], col[pick[2:]] = 0.9 * s, 0.5 * s
        pick = torch.randperm(AB_TIE_N - warm_rows, generator=gen,
                              device=DEV)[:7] + warm_rows
        col[pick[:3]], col[pick[3:]] = 0.95 * s, 0.5 * s
        store[:, c] = col
    q = torch.zeros(AB_TIE_Q, D, device=DEV)
    q[:, :AB_TIE_Q] = torch.eye(AB_TIE_Q, device=DEV)
    return store.to(BF16), q


def ab_record(kernel, store, q, k, fn, plain, lib_q, err, **extra):
    """Times of one kernel at one A/B shape, with its bound (no mask)."""
    nq, n = q.shape[0], store.shape[0]
    iters = 5 if nq > 1 else 20
    ms, bound_by = bound(n * D * 2 + nq * D * 4 + nq * k * 8,
                         2.0 * nq * n * D)
    return {"kernel": kernel, "n": n, "d": D, "q": nq, "k": k, **extra,
            "max_abs_err": err, "ms": device_ms(fn, iters),
            "plain_ms": device_ms(plain, 2 if nq > 1 else 5),
            "library_ms": device_ms(lambda: torch.topk(lib_q @ store.T, k),
                                    iters),
            "bound_ms": ms, "bound_by": bound_by}


def run_tool(module: str, *argv) -> dict:
    """``python -m sema_tpu_torch.tools.<module>`` on the card at its
    default shapes: it must exit 0 with ids identical, through its
    kernels. Returns its last line and what it printed."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"sema_tpu_torch.tools.{module}", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"{module} exited {proc.returncode}: "
          f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    check(last["ids_identical"] and all(last["launches"].values()),
          f"{module}: {last}")
    return {"tool": module, "seconds": time.perf_counter() - t0,
            "last": last, "printed": (proc.stdout + proc.stderr)[-1500:]}


def phase_scan_ab(gen):
    """K8 and K9 on the scan A/B paths: every call of K1, K8 and K9 below
    is the path's, counted from 0; then each K8 and K9 result against K1's
    on the same inputs, bit for bit, K1 against its plain version, the
    times, and the two tools on the card."""
    scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    scan_topk, fold_topk = scan_mod.scan_topk, scan_mod.fold_topk
    warm_store, fold_store = ab_stores(gen)
    live = torch.ones(AB_N, dtype=torch.bool, device=DEV)
    queries = {nq: ab_queries(warm_store, fold_store, nq, gen)
               for nq in sorted({nq for nq, _ in AB_SHAPES})}
    # K8 more: a sealed bucket with tombstones and TIE, and with the
    # whole sample tombstoned; the one-hot ties
    tie_store, tie_q = one_hot_ties(AB_WARM[0], gen)
    tomb = F.normalize(torch.randn(SEAL, D, generator=gen, device=DEV), dim=1)
    tomb[TIE[1:]] = tomb[TIE[0]].clone()
    tomb = tomb.to(BF16)
    tomb_valid = torch.rand(SEAL, generator=gen, device=DEV) > 0.1
    tomb_valid[TIE] = True
    dead_sample = tomb_valid.clone()
    dead_sample[:AB_WARM[0]] = False
    tomb_q = F.normalize(torch.randn(256, D, generator=gen, device=DEV), dim=1)
    tomb_q[0] = tomb[TIE[0]].float()

    # the path: K1 cold beside each K8 and K9 call, counted from 0
    reset_launch_counts()
    calls = Counter()
    runs, more_runs = [], []
    for nq, k in AB_SHAPES:
        qw, qf = queries[nq]
        stats = torch.zeros(2, dtype=torch.int64, device=DEV)
        run = {"nq": nq, "k": k,
               "cold": scan_topk(warm_store, qw, live, k, masked=False),
               "warm": {w: scan_topk(warm_store, qw, live, k, masked=False,
                                     warm_rows=w)
                        for w in (AB_WARM if k == 10 else AB_WARM[:1])},
               "fold_cold": scan_topk(fold_store, qf, live, k, masked=False),
               "fold": fold_topk(fold_store, qf, k, stats=stats),
               "stats": stats}
        calls["scan_topk"] += 2
        calls["scan_topk_warm"] += len(run["warm"])
        calls["fold_topk"] += 1
        runs.append(run)
    for name, store, q, valid, k, masked in (
            ("tombstones", tomb, tomb_q[:1], tomb_valid, 16, True),
            ("tombstones", tomb, tomb_q, tomb_valid, 16, True),
            ("tombstones", tomb, tomb_q, tomb_valid, 128, True),
            ("dead_sample", tomb, tomb_q, dead_sample, 10, True),
            ("one_hot_ties", tie_store, tie_q, live[:AB_TIE_N], AB_TIE_K,
             True),
            ("one_hot_ties", tie_store, tie_q, live[:AB_TIE_N], AB_TIE_K,
             False)):
        more_runs.append({
            "name": name, "store": store, "q": q, "valid": valid, "k": k,
            "masked": masked,
            "cold": scan_topk(store, q, valid, k, masked),
            "warm": scan_topk(store, q, valid, k, masked,
                              warm_rows=AB_WARM[0])})
        calls["scan_topk"] += 1
        calls["scan_topk_warm"] += 1
    torch.cuda.synchronize()
    launches = launch_counts()
    want = dict.fromkeys(launches, 0)
    want.update(calls)
    check(launches == want, f"scan_ab launches {launches}, want {want}")

    def equal(got, ref, what):
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"{what}: not bit-equal to K1")

    cases = []
    for run in runs:
        nq, k = run["nq"], run["k"]
        qw, qf = queries[nq]
        for w, got in run["warm"].items():
            equal(got, run["cold"], f"K8 warm {w}, Q={nq}, k={k}")
        equal(run["fold"], run["fold_cold"], f"K9, Q={nq}, k={k}")
        for j, pair in enumerate(FOLD_TIES[:nq]):
            check(run["fold"][1][j, :2].tolist() == list(pair),
                  f"K9, Q={nq}, k={k}: the tie {pair} out of id order")
        err_cold = check_scan(warm_store, qw, live, False, run["cold"],
                              scan_mod.scan_topk_reference(
                                  warm_store, qw, live, k, masked=False))
        err_fold = check_scan(fold_store, qf, live, False, run["fold"],
                              scan_mod.fold_topk_reference(fold_store, qf, k),
                              relative=True)
        w0 = AB_WARM[0]
        err_warm = check_scan(warm_store, qw, live, False, run["warm"][w0],
                              scan_mod.scan_topk_warm_reference(
                                  warm_store, qw, live, k, w0, masked=False))
        qb = qw.to(BF16)
        cases.append(ab_record(
            "K1", warm_store, qw, k,
            lambda: scan_topk(warm_store, qw, live, k, masked=False),
            lambda: scan_mod.scan_topk_reference(warm_store, qw, live, k,
                                                 masked=False), qb, err_cold))
        for w in run["warm"]:
            cases.append(ab_record(
                "K8", warm_store, qw, k,
                lambda: scan_topk(warm_store, qw, live, k, masked=False,
                                  warm_rows=w),
                lambda: scan_mod.scan_topk_warm_reference(
                    warm_store, qw, live, k, w, masked=False), qb, err_warm,
                warm=w))
        merged, fast = run["stats"].tolist()
        cases.append(ab_record(
            "K9", fold_store, qf, k, lambda: fold_topk(fold_store, qf, k),
            lambda: scan_mod.fold_topk_reference(fold_store, qf, k),
            qf.to(BF16), err_fold, spans_merged=merged,
            fast_share=fast / max(merged, 1),
            k1_ms=device_ms(lambda: scan_topk(fold_store, qf, live, k,
                                              masked=False),
                            5 if nq > 1 else 20)))
        torch.cuda.empty_cache()
    more_cases = []
    for r in more_runs:
        name, store, q, valid, k = (r[key] for key in ("name", "store", "q",
                                                       "valid", "k"))
        what = f"K8 {name}, Q={q.shape[0]}, k={k}, masked={r['masked']}"
        equal(r["warm"], r["cold"], what)
        plain = scan_mod.scan_topk_warm_reference(store, q, valid, k,
                                                  AB_WARM[0], r["masked"])
        err = check_scan(store, q, valid, r["masked"], r["warm"], plain)
        check_scan(store, q, valid, r["masked"], r["cold"],
                   scan_mod.scan_topk_reference(store, q, valid, k,
                                                r["masked"]))
        if name == "one_hot_ties":    # exact scores: the plain ids exactly
            check(torch.equal(r["warm"][1], plain[1]), f"{what}: ids")
        if name == "tombstones":
            t = min(k, len(TIE))
            check(r["warm"][1][0, :t].tolist() == TIE[:t],
                  f"{what}: tied rows out of id order")
        more_cases.append({"case": name, "n": store.shape[0], "d": D,
                             "q": q.shape[0], "k": k,
                             "masked": r["masked"], "warm": AB_WARM[0],
                             "max_abs_err": err})
    del warm_store, fold_store, runs, more_runs, queries, tomb, tie_store
    torch.cuda.empty_cache()
    tools = [run_tool("scan_ab15"), run_tool("scan_ab14"),
             run_tool("scan_ab14", "--small")]
    emit("scan_ab", launches=launches, cases=cases,
         more_cases=more_cases, tools=tools)
    pick = lambda kernel, **kw: next(
        c for c in cases if c["kernel"] == kernel and c["q"] == 256
        and c["k"] == 10 and all(c.get(a) == b for a, b in kw.items()))
    return {"launches": launches, "K1": pick("K1"),
            "K8": pick("K8", warm=AB_WARM[0]), "K9": pick("K9")}


# -- K2 -----------------------------------------------------------------------

BF16 = torch.bfloat16
K2_SHAPES = (("minilm-l6", BF16, 2048, 32), ("minilm-l6", BF16, 1024, 64),
             ("minilm-l6", BF16, 512, 128), ("minilm-l6", BF16, 256, 256),
             ("minilm-l6", BF16, 1, 256), ("e5-base", BF16, 256, 128),
             ("minilm-l6", torch.float32, 256, 128),
             ("minilm-l6", torch.float16, 256, 128),
             ("minilm-l6", BF16, 64, 384), ("minilm-l6", BF16, 32, 512),
             ("gte-large", BF16, 2048, 32), ("gte-large", BF16, 1024, 64),
             ("gte-large", BF16, 512, 128), ("gte-large", BF16, 256, 256),
             ("gte-large", BF16, 64, 256), ("gte-large", BF16, 1, 256))
COS_MIN = 0.9995               # per output row
REL_MAX = 2.0 ** -3            # |got - want| / max(|want|, 1)
COS_MIN_F16, REL_MAX_F16 = 0.99998, 0.015
F32_ATOL, F32_RTOL = 5e-5, 1e-4


def layer_close(got, want, cos_min=COS_MIN, rel_max=REL_MAX):
    """(ok, min per-row cosine, max error relative to max(|want|, 1)).
    Both sides round to bf16 at the same places but sum in another order,
    so an intermediate (a probability, h1, a GELU input) may land one bf16
    ulp apart and carry on through the products after it. On an H100 with
    the weights of ``layer_params`` the kernel read, at worst over the
    bf16 shapes of K2_SHAPES, cosine 0.99970 and a relative error of 0.090
    (gte-large at (512, 128)); the limits leave 1.7 and 1.4 times that.
    The plain version with attention broken (``broken_layers``, the mask
    dropped) read cosine 0.12 to 0.45, and the CUDA mutants of
    chip_mutants.sh relative errors above 4 (bf16 and f32) or NaN."""
    h = got.shape[-1]
    g, w = got.float().reshape(-1, h), want.float().reshape(-1, h)
    cos = float(F.cosine_similarity(g, w, dim=1).min())
    rel = float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
    return cos >= cos_min and rel <= rel_max, cos, rel


def layer_close_f16(got, want):
    """``layer_close`` at f16's own limits. f16 rounds at the same places
    with three more mantissa bits, and the kernel read cosine 0.999998 and
    a relative error of 0.0044 at (256, 128) on an H100, where the bf16
    shapes read 0.036 to 0.070: a relative error of 0.015 (and 1 - cosine
    of 2e-5) lets the f16 kernel through and not one that rounds its
    results at bf16's precision."""
    return layer_close(got, want, COS_MIN_F16, REL_MAX_F16)


def layer_close_f32(got, want):
    """(ok, min per-row cosine, max relative error) for f32, where nothing
    rounds and only the order of the f32 sums differs: every output within
    5e-5 + 1e-4 |want|, the JAX package's bound between its fused and
    composed f32 layers (tests/test_fused_attention.py)."""
    _, cos, rel = layer_close(got, want)
    g, w = got.float(), want.float()
    ok = bool(((g - w).abs() <= F32_ATOL + F32_RTOL * w.abs()).all())
    return ok, cos, rel


def layer_params(h, inter, gen):
    """One layer's params at sigma 0.08, as in
    tests/test_torch_encoder_layer.py: at the 0.02 of random_params the
    attention branch is 1-3% of the residual, too little for a check of the
    output to see it; at 0.08 it is as large as the residual and the
    softmax is neither flat nor one-hot. Weights bf16 as Encoder casts
    them, LayerNorm params f32."""
    w = lambda *shape: 0.08 * torch.randn(*shape, generator=gen, device=DEV)
    bf = torch.bfloat16
    return {"qkv_w": w(h, 3 * h).to(bf), "qkv_b": w(3 * h).to(bf),
            "attn_out_w": w(h, h).to(bf), "attn_out_b": w(h).to(bf),
            "ffn_in_w": w(h, inter).to(bf), "ffn_in_b": w(inter).to(bf),
            "ffn_out_w": w(inter, h).to(bf), "ffn_out_b": w(h).to(bf),
            "attn_ln_scale": 1.0 + w(h), "attn_ln_bias": w(h),
            "ffn_ln_scale": 1.0 + w(h), "ffn_ln_bias": w(h)}


def broken_layers(layer, heads):
    """The plain version's inputs with attention broken three ways: the
    context zeroed (out-proj weight 0) and the keys' heads rotated by one;
    the mask is dropped separately."""
    h = layer["qkv_w"].shape[0]
    rot_w = layer["qkv_w"].clone()
    rot_w[:, h:2 * h] = rot_w[:, h:2 * h].reshape(h, heads, -1).roll(
        1, dims=1).reshape(h, h)
    return {"zero_ctx": {**layer, "attn_out_w": torch.zeros_like(
                layer["attn_out_w"])},
            "heads_rotated": {**layer, "qkv_w": rot_w}}


def library_layer(layer, heads, eps, dtype):
    """torch.nn.TransformerEncoderLayer holding the same weights: the one
    PyTorch call that computes a post-LN BERT layer (timed, never used by
    the port)."""
    h = layer["qkv_w"].shape[0]
    inter = layer["ffn_in_w"].shape[1]
    mod = torch.nn.TransformerEncoderLayer(
        h, heads, inter, dropout=0.0, activation="gelu",
        layer_norm_eps=eps, batch_first=True, norm_first=False,
        device=DEV, dtype=dtype).eval()
    with torch.no_grad():
        for dst, name in ((mod.self_attn.in_proj_weight, "qkv_w"),
                          (mod.self_attn.out_proj.weight, "attn_out_w"),
                          (mod.linear1.weight, "ffn_in_w"),
                          (mod.linear2.weight, "ffn_out_w")):
            dst.copy_(layer[name].T)
        for dst, name in ((mod.self_attn.in_proj_bias, "qkv_b"),
                          (mod.self_attn.out_proj.bias, "attn_out_b"),
                          (mod.linear1.bias, "ffn_in_b"),
                          (mod.linear2.bias, "ffn_out_b"),
                          (mod.norm1.weight, "attn_ln_scale"),
                          (mod.norm1.bias, "attn_ln_bias"),
                          (mod.norm2.weight, "ffn_ln_scale"),
                          (mod.norm2.bias, "ffn_ln_bias")):
            dst.copy_(layer[name])
    return mod


def layer_inputs(spec, dtype, b, s, gen):
    """(x, padding mask, mask bias, heads, scale) of a layer case: x
    normal, random lengths (one query: 12 tokens, padded to s)."""
    h, heads = spec.hidden_size, spec.num_heads
    x = torch.randn(b, s, h, generator=gen, device=DEV).to(dtype)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=DEV)
    lens[0] = s if b > 1 else min(12, s)
    pad = torch.arange(s, device=DEV)[None, :] >= lens[:, None]
    return x, pad, pad.float() * -1e9, heads, 1.0 / math.sqrt(h // heads)


def ln_plans(spec, m, quantized) -> list:
    """The launch plan of the layer's two LayerNorm GEMMs at M = m
    (``ln_gemm_plan``), which must be the kernel's own (``sema_gemm_plan``),
    with the clusters of it the card holds at once."""
    from sema_tpu_torch.ops import _cuda
    from sema_tpu_torch.ops.encoder_layer import ln_gemm_plan
    lib = _cuda.library("encoder_layer", {"sema_gemm_plan": [ctypes.c_int] * 5
                                          + [ctypes.POINTER(ctypes.c_int)]})
    h = spec.hidden_size
    plans = []
    for gemm, k in (("out-proj + LN1", h),
                    ("FFN-out + LN2", spec.intermediate_size)):
        want = ln_gemm_plan(m, h, k, quantized)
        got = (ctypes.c_int * 7)()
        _cuda.check(lib, lib.sema_gemm_plan(m, h, k, 1, int(quantized), got),
                    "sema_gemm_plan")
        check(want is not None and tuple(got[:6]) == tuple(want),
              f"{spec.name} M={m}: ln_gemm_plan {want}, the kernel's "
              f"{list(got)}")
        check(got[6] >= 1, f"{spec.name} M={m}: no cluster of {want} fits")
        plans.append({"gemm": gemm, **want._asdict(),
                      "max_active_clusters": got[6]})
    return plans


def check_ln_launches(launches, positions, plans, what):
    """The traced grid of each LayerNorm GEMM (at ``positions`` of the
    layer's launches) is its plan's: row blocks x the cluster's blocks.
    Where the profiler gave no trace (``launch_profile``'s error), the
    plans stand checked against the kernel's own alone."""
    if "error" in launches[0]:
        return
    for i, plan in zip(positions, plans):
        grid = launches[i].get("grid")
        check(grid is not None and grid[1] == plan["cluster"]
              and grid[0] * grid[1] == plan["blocks"],
              f"{what}: launch {i} ran grid {grid}, plan {plan}")


def layer_case(layer, spec, dtype, b, s, gen, iters):
    from sema_tpu_torch.models.bert import LN_EPS
    from sema_tpu_torch.ops.encoder_layer import (encoder_layer_reference,
                                                  fused_encoder_layer,
                                                  layer_operands)
    h, inter = spec.hidden_size, spec.intermediate_size
    close = {torch.float32: layer_close_f32,
             torch.float16: layer_close_f16}.get(dtype, layer_close)
    x, pad, bias, heads, scale = layer_inputs(spec, dtype, b, s, gen)
    args = (x, layer, bias, heads, scale, LN_EPS)
    operands = layer_operands(layer, dtype)
    got = fused_encoder_layer(*args, operands=operands)
    check(torch.equal(got, fused_encoder_layer(*args)),
          f"{spec.name} {dtype} ({b}, {s}): the layer differs without its "
          "operands made beforehand (or is not finite)")
    want = encoder_layer_reference(*args)
    torch.cuda.synchronize()
    ok, cos, rel = close(got, want)
    check(ok, f"{spec.name} {dtype} ({b}, {s}): cosine {cos}, relative "
          f"error {rel}, max abs error "
          f"{float((got.float() - want.float()).abs().max())}")
    broken = {name: encoder_layer_reference(x, bad, bias, heads, scale,
                                            LN_EPS)
              for name, bad in broken_layers(layer, heads).items()}
    broken["no_mask"] = encoder_layer_reference(
        x, layer, torch.zeros_like(bias), heads, scale, LN_EPS)
    for name, out in broken.items():
        check(not close(out, want)[0],
              f"{spec.name} {dtype} ({b}, {s}): the check passes {name}")
    m = b * s
    isz = x.element_size()
    weights = 4 * h * h + 2 * h * inter
    ms, bound_by = bound(
        2 * isz * m * h + isz * weights + isz * (3 * h + h + inter + h)
        + 4 * 4 * h + 4 * b * s,
        2.0 * m * weights + 4.0 * b * s * s * h,
        F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S)
    lib = library_layer(layer, heads, LN_EPS, dtype)
    with torch.inference_mode():
        library_ms = device_ms(lambda: lib(x, src_key_padding_mask=pad),
                               iters)
    share = layer_launches(fused_encoder_layer, args,
                           lambda lay: layer_operands(lay, dtype),
                           [n for n, _, _ in linears(spec)], 5, iters)
    if dtype != F32:       # the f32 route's GEMMs are SIMT, one per row
        share["ln_plans"] = ln_plans(spec, b * s, False)
        check_ln_launches(share["launches"], (2, 4), share["ln_plans"],
                          f"K2 {spec.name} {dtype} ({b}, {s})")
    if dtype == F32:    # the f32 attention's share of the layer: K7 alone
        share["attention_ms"] = attention_ms(b, s, h, heads, scale, bias,
                                             gen, iters)
    return {"model": spec.name, "dtype": str(dtype).removeprefix("torch."),
            "b": b, "s": s, "head_dim": h // heads,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_rel_err": rel, "min_cosine": cos,
            "broken_min_cosine": {name: close(out, want)[1]
                                  for name, out in broken.items()},
            "ms": device_ms(lambda: fused_encoder_layer(
                *args, operands=operands), iters),
            "plain_ms": device_ms(lambda: encoder_layer_reference(*args),
                                  iters),
            "library_ms": library_ms, "bound_ms": ms, "bound_by": bound_by,
            **share}


def attention_ms(b, s, h_out, heads, scale, bias, gen, iters) -> float:
    """Device ms of K7 in f32 on a (b, s, 3 h_out) qkv: the attention that
    K2's and K6's f32 routes run after their qkv GEMM, at their shape."""
    from sema_tpu_torch.ops.attention import fused_attention_qkv
    qkv = 1.5 * torch.randn(b, s, 3 * h_out, generator=gen, device=DEV)
    return device_ms(lambda: fused_attention_qkv(qkv, bias, heads, scale),
                     iters)


def phase_layer(gen):
    from sema_tpu_torch.models.registry import get_spec
    cases = []
    for name in dict.fromkeys(m for m, _, _, _ in K2_SHAPES):
        spec = get_spec(name)
        layer = layer_params(spec.hidden_size, spec.intermediate_size, gen)
        cases += [layer_case(layer, spec, dt, b, s, gen, iters=10)
                  for m, dt, b, s in K2_SHAPES if m == name]
        del layer
    emit("encoder_layer", cases=cases)
    return cases


# -- K5 -----------------------------------------------------------------------

F16, F32 = torch.float16, torch.float32
K5_QMM_M = (256, 65_536)
K5_SHAPES = (("minilm-l6", BF16, 256, 256), ("minilm-l6", F16, 256, 256),
             ("minilm-l6", F32, 256, 256), ("gte-large", BF16, 1, 256),
             ("gte-large", BF16, 64, 256), ("gte-large", BF16, 256, 256),
             ("gte-large", BF16, 2048, 32), ("gte-large", BF16, 32, 512))
# (min per-row cosine, max error relative to max(|want|, 1)) of K5 against
# its plain version. Where the two sides' sums land one ulp apart (as K2's
# do), a row's int8 quantum can move by one: a value on a rounding
# boundary, or the row's absmax and so its scale. One quantum is 1/127 of
# the row's absmax; at the weights of int8_layer_params one quantum of the
# FFN-out input moves an output by about 0.015, more than an f16 or f32
# ulp, so those dtypes take limits set by quanta, not by their ulps. On an
# H100 the kernel read: bf16 cosine >= 0.99969, relative error <= 0.096
# (over the bf16 shapes); f16 0.99984 and 0.070; f32 0.99997 and 0.027
# (two quanta). The plain version with attention broken read cosine 0.15
# to 0.33.
K5_LIMITS = {BF16: (COS_MIN, REL_MAX),   # K2's bf16 limits
             # K2's f16 limits (0.99998, 0.015) sit below one quantum:
             # bf16's instead
             F16: (COS_MIN, REL_MAX),
             # K2's 5e-5 + 1e-4 |x| cannot hold once a quantum moves: four
             # quanta of FFN-out
             F32: (0.9999, 0.06)}


def linears(spec):
    """(name, K, N) of a layer's four products."""
    h, i = spec.hidden_size, spec.intermediate_size
    return (("qkv_w", h, 3 * h), ("attn_out_w", h, h), ("ffn_in_w", h, i),
            ("ffn_out_w", i, h))


def int8_layer_params(spec, gen):
    """One quantized layer at sigma 0.08 (as ``layer_params``): the f32
    weights quantized per output channel and laid out as the Encoder lays
    them out for K5; biases bf16, LayerNorm params f32."""
    from sema_tpu_torch.models.bert import quantize_linear
    from sema_tpu_torch.ops.encoder_layer_int8 import column_major
    w = lambda *shape: 0.08 * torch.randn(*shape, generator=gen, device=DEV)
    h, inter = spec.hidden_size, spec.intermediate_size
    layer = {"qkv_b": w(3 * h).to(BF16), "attn_out_b": w(h).to(BF16),
             "ffn_in_b": w(inter).to(BF16), "ffn_out_b": w(h).to(BF16),
             "attn_ln_scale": 1.0 + w(h), "attn_ln_bias": w(h),
             "ffn_ln_scale": 1.0 + w(h), "ffn_ln_bias": w(h)}
    for name, k, n in linears(spec):
        q, sc = quantize_linear(w(k, n))
        layer[name + "_q"], layer[name + "_s"] = column_major(q), sc
    return layer


def broken_int8_layers(layer, heads):
    """``broken_layers`` for the int8 layer: the context zeroed and the
    keys' heads rotated (their scales with them)."""
    h = layer["qkv_w_q"].shape[0]
    rot = {}
    for name in ("qkv_w_q", "qkv_w_s"):
        t = layer[name].clone()
        keys = t[..., h:2 * h]
        t[..., h:2 * h] = keys.reshape(*keys.shape[:-1], heads, -1).roll(
            1, dims=-2).reshape(keys.shape)
        rot[name] = t
    return {"zero_ctx": {**layer, "attn_out_w_q": torch.zeros_like(
                layer["attn_out_w_q"])},
            "heads_rotated": {**layer, **rot}}


def int_mm_ms(m, spec, gen, iters):
    """The library yardstick of K5: ``torch._int_mm`` of the layer's four
    products alone, on int8 rows of its M (no quantization, no rescale,
    no epilogue)."""
    mats = [(torch.randint(-127, 128, (m, k), generator=gen, device=DEV,
                           dtype=torch.int8),
             torch.randint(-127, 128, (n, k), generator=gen, device=DEV,
                           dtype=torch.int8).t())
            for _, k, n in linears(spec)]
    return device_ms(lambda: [torch._int_mm(a, b) for a, b in mats], iters)


def qmm_case(spec, m, k, n, name, gen, iters):
    from sema_tpu_torch.models.bert import quantize_linear
    from sema_tpu_torch.ops.encoder_layer_int8 import (column_major, qmm,
                                                       qmm_reference)
    x = torch.randn(m, k, generator=gen, device=DEV).to(BF16)
    wq, ws = quantize_linear(0.08 * torch.randn(k, n, generator=gen,
                                                device=DEV))
    wq = column_major(wq)
    got, want = qmm(x, wq, ws), qmm_reference(x, wq, ws)
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=DEV,
                       dtype=torch.int8)
    ms, bound_by = bound(m * k * 2 + k * n + n * 4 + m * n * 4,
                         2.0 * m * k * n, INT8_OPS_PER_S)
    return {"model": spec.name, "linear": name, "m": m, "k": k, "n": n,
            "bit_equal": equal,
            "max_abs_err": float((got - want).abs().max()),
            "ms": device_ms(lambda: qmm(x, wq, ws), iters),
            "plain_ms": device_ms(lambda: qmm_reference(x, wq, ws),
                                  max(2, iters // 2)),
            "library_ms": device_ms(lambda: torch._int_mm(xq, wq), iters),
            "library_call": "torch._int_mm of int8 rows alone",
            "bound_ms": ms, "bound_by": bound_by}


def int8_layer_case(layer, spec, dtype, b, s, gen, iters):
    from sema_tpu_torch.models.bert import LN_EPS
    from sema_tpu_torch.ops.encoder_layer_int8 import (
        encoder_layer_int8_reference, fused_encoder_layer_int8,
        layer_operands)
    h, inter = spec.hidden_size, spec.intermediate_size
    cos_min, rel_max = K5_LIMITS[dtype]
    close = lambda got, want: layer_close(got, want, cos_min, rel_max)
    x, pad, bias, heads, scale = layer_inputs(spec, dtype, b, s, gen)
    args = (x, layer, bias, heads, scale, LN_EPS)
    operands = layer_operands(layer, dtype)
    got = fused_encoder_layer_int8(*args, operands=operands)
    check(torch.equal(got, fused_encoder_layer_int8(*args)),
          f"{spec.name} {dtype} ({b}, {s}): the int8 layer differs without "
          "its operands made beforehand (or is not finite)")
    want = encoder_layer_int8_reference(*args)
    torch.cuda.synchronize()
    ok, cos, rel = close(got, want)
    broken = {name: encoder_layer_int8_reference(x, bad, bias, heads, scale,
                                                 LN_EPS)
              for name, bad in broken_int8_layers(layer, heads).items()}
    broken["no_mask"] = encoder_layer_int8_reference(
        x, layer, torch.zeros_like(bias), heads, scale, LN_EPS)
    m = b * s
    isz = x.element_size()
    weights = 4 * h * h + 2 * h * inter
    launches = layer_launches(fused_encoder_layer_int8, args,
                              lambda lay: layer_operands(lay, dtype),
                              [n + "_q" for n, _, _ in linears(spec)], 8,
                              iters)
    plans = ln_plans(spec, m, True)
    check_ln_launches(launches["launches"], (4, 7), plans,
                      f"K5 {spec.name} {dtype} ({b}, {s})")
    # int8 products at the int8 rate plus attention at the bf16 (f32) rate,
    # as int8-rate-equivalent operations
    attn_rate = F32_OPS_PER_S if dtype == F32 else BF16_OPS_PER_S
    ms, bound_by = bound(
        2 * isz * m * h + weights + (4 + isz) * (3 * h + h + inter + h)
        + 4 * 4 * h + 4 * b * s,
        2.0 * m * weights + 4.0 * b * s * s * h * INT8_OPS_PER_S / attn_rate,
        INT8_OPS_PER_S)
    return {"model": spec.name, "dtype": str(dtype).removeprefix("torch."),
            "b": b, "s": s, "head_dim": h // heads, "ok": ok,
            "limits": {"min_cosine": cos_min, "max_rel_err": rel_max},
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_rel_err": rel, "min_cosine": cos,
            "broken_min_cosine": {name: close(out, want)[1]
                                  for name, out in broken.items()},
            "broken_passes": [name for name, out in broken.items()
                              if close(out, want)[0]],
            "ms": device_ms(lambda: fused_encoder_layer_int8(
                *args, operands=operands), iters),
            "plain_ms": device_ms(
                lambda: encoder_layer_int8_reference(*args),
                max(2, iters // 3)),
            "library_ms": int_mm_ms(m, spec, gen, iters),
            "library_call": "torch._int_mm x4, the four products alone",
            "bound_ms": ms, "bound_by": bound_by, "ln_plans": plans,
            **launches}


def phase_layer_int8(gen):
    """K5: ``qmm`` bit-equal to its plain version at the four products of
    MiniLM and gte-large at M = 256 and 65,536; the layer against its
    plain version under K5_LIMITS, which must reject the plain version
    with attention broken. Every case is emitted before a failure
    raises."""
    from sema_tpu_torch.models.registry import get_spec
    qmm_cases, cases = [], []
    for name in ("minilm-l6", "gte-large"):
        spec = get_spec(name)
        for m in K5_QMM_M:
            for lin, k, n in linears(spec):
                qmm_cases.append(qmm_case(spec, m, k, n, lin, gen,
                                          iters=20 if m == 256 else 5))
        layer = int8_layer_params(spec, gen)
        cases += [int8_layer_case(layer, spec, dt, b, s, gen, iters=10)
                  for m, dt, b, s in K5_SHAPES if m == name]
        del layer
        torch.cuda.empty_cache()
    emit("encoder_layer_int8", qmm=qmm_cases, cases=cases)
    bad = ([f"qmm {c['model']} {c['linear']} M={c['m']}: not bit-equal "
            f"(max abs error {c['max_abs_err']})"
            for c in qmm_cases if not c["bit_equal"]]
           + [f"{c['model']} {c['dtype']} ({c['b']}, {c['s']}): cosine "
              f"{c['min_cosine']}, relative error {c['max_rel_err']}"
              for c in cases if not c["ok"]]
           + [f"{c['model']} {c['dtype']} ({c['b']}, {c['s']}): the check "
              f"passes {c['broken_passes']}" for c in cases
              if c["broken_passes"]])
    check(not bad, "K5: " + "; ".join(bad))
    return cases


# -- K6, K7 -------------------------------------------------------------------

# (model, tp): the local width of one shard of heads, H_out = H / tp over
# heads / tp heads: gte-large 512 (8 heads of 64) and 256 (4), MiniLM 192
# (6 heads of 32) and 96 (3)
K67_WIDTHS = (("gte-large", 2), ("gte-large", 4), ("minilm-l6", 2),
              ("minilm-l6", 4))
K6_BS = ((1, 256), (64, 256), (256, 192))
# 512: the longest row of the one-pass route; 640: the three-pass route
K7_BS = ((256, 32), (128, 128), (32, 512), (16, 640))
# the tp_path's own (B, S) of gte-large at tp 2, bf16, beyond those of
# K6_BS and K7_BS: a full index batch of each sequence bucket
# (``Encoder.encode_texts``: batch_size * max_length // S rows) through K6
# (the 256 bucket, float linears) and K7 (the shorter buckets, and every
# bucket with W8A8), and the W8A8 query's K7; tp_run fails if the path
# runs K6 or K7 at a (B, S) that phase_attention does not hold
K67_PATH = (("block", 256, 256), ("qkv", 2048, 32), ("qkv", 1024, 64),
            ("qkv", 512, 128), ("qkv", 256, 256), ("qkv", 1, 256))
# (min per-row cosine, max relative error) of K6 and K7 in bf16 and f16;
# f32 takes ``layer_close_f32``. Both round at K2's places, but what they
# return is the context itself, not a LayerNorm's output, and K6's qkv
# comes from its own GEMM, so an element of q, k or v may land one ulp
# (2^-5 of |qkv| up to 8 in bf16, 2^-8 in f16) from the plain version's
# before the softmax weighs it. On an H100 over the cases of
# phase_attention the kernels read at worst cosine 0.99992 and relative
# error 0.110 in bf16 (K6, gte-large tp 4, (256, 192)) and 0.9999976 and
# 0.0166 in f16 (K6, gte-large tp 2, (64, 256)), above K2's f16 limit of
# 0.015. The limits leave 1.8 times those errors; the plain versions with
# the mask dropped, the keys' heads rotated or K6's bias dropped read
# cosine 0.54 at best.
K67_LIMITS = {BF16: (COS_MIN, 0.2), F16: (COS_MIN_F16, 0.03)}


def attention_close(got, want):
    """``layer_close`` at K67_LIMITS for ``want``'s dtype, or
    ``layer_close_f32``."""
    if want.dtype == F32:
        return layer_close_f32(got, want)
    return layer_close(got, want, *K67_LIMITS[want.dtype])


def sdpa(qkv, bias, heads, scale):
    """The library yardstick of K7: ``F.scaled_dot_product_attention`` on
    the (B, S, 3·H_out) qkv viewed as heads, with its transposes back to
    the (B, S, H_out) layout."""
    b, s, h3 = qkv.shape
    q, k, v = qkv.view(b, s, 3, heads, h3 // 3 // heads).permute(2, 0, 3, 1,
                                                                  4)
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias[:, None, None, :].to(qkv.dtype), scale=scale)
    return out.transpose(1, 2).reshape(b, s, h3 // 3)


def rotated_keys(t, h_out, heads):
    """``t`` (..., 3·H_out) with the keys' heads rotated by one."""
    t = t.clone()
    keys = t[..., h_out:2 * h_out]
    t[..., h_out:2 * h_out] = keys.reshape(*keys.shape[:-1], heads, -1).roll(
        1, dims=-2).reshape(keys.shape)
    return t


def attention_case(kind, spec, tp, dtype, b, s, gen, iters):
    """K6 (``kind`` "block") or K7 ("qkv") at one shard of heads of
    ``spec`` at ``tp`` against its plain version, under
    ``attention_close``, which must reject the plain version with the mask
    dropped, with the keys' heads rotated and, for K6, with its bias
    dropped. K6's weights are drawn at 1.5/sqrt(H) and K7's qkv at 1.5, so
    that q, k and v are about 1.5 and the scaled scores about 2: a softmax
    neither flat nor one-hot; K6's bias at 1, as large as what it is added
    to, so that a kernel that drops it fails."""
    from sema_tpu_torch.ops.attention import (attention_block_reference,
                                              attention_qkv_reference,
                                              fused_attention_block,
                                              fused_attention_qkv)
    h, heads = spec.hidden_size, spec.num_heads
    h_out, n = h // tp, heads // tp
    scale = 1.0 / math.sqrt(h // heads)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=DEV)
    lens[0] = s if b > 1 else min(12, s)   # one query: 12 tokens, padded
    if b > 1:
        lens[-1] = max(1, s // 3)          # a padded row, whatever the draw
    bias = (torch.arange(s, device=DEV)[None, :] >= lens[:, None]).float() \
        * -1e9
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=DEV)
    isz = torch.tensor([], dtype=dtype).element_size()
    if kind == "block":
        x = randn(b, s, h).to(dtype)
        w = (1.5 / math.sqrt(h) * randn(h, 3 * h_out)).to(dtype)
        qb = randn(3 * h_out).to(dtype)
        fn, ref = fused_attention_block, attention_block_reference
        args = (x, w, qb, bias, n, scale)
        broken = {"no_mask": (x, w, qb, torch.zeros_like(bias), n, scale),
                  "heads_rotated": (x, rotated_keys(w, h_out, n), qb, bias,
                                    n, scale),
                  "no_bias": (x, w, torch.zeros_like(qb), bias, n, scale)}
        lib = lambda: sdpa(torch.addmm(qb, x.view(b * s, h), w).view(
            b, s, 3 * h_out), bias, n, scale)
        moved = (b * s * h + h * 3 * h_out + 3 * h_out + b * s * h_out) \
            * isz + 4 * b * s
        ops = 2.0 * b * s * h * 3 * h_out + 4.0 * b * s * s * h_out
    else:
        qkv = (1.5 * randn(b, s, 3 * h_out)).to(dtype)
        fn, ref = fused_attention_qkv, attention_qkv_reference
        args = (qkv, bias, n, scale)
        broken = {"no_mask": (qkv, torch.zeros_like(bias), n, scale),
                  "heads_rotated": (rotated_keys(qkv, h_out, n), bias, n,
                                    scale)}
        lib = lambda: sdpa(qkv, bias, n, scale)
        moved = (b * s * 3 * h_out + b * s * h_out) * isz + 4 * b * s
        ops = 4.0 * b * s * s * h_out
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    ok, cos, rel = attention_close(got, want)
    broken = {name: ref(*a) for name, a in broken.items()}
    ms, bound_by = bound(moved, ops, F32_OPS_PER_S if dtype == F32
                         else BF16_OPS_PER_S)
    with torch.inference_mode():
        library_ms = device_ms(lib, iters)
    kernel_ms = device_ms(lambda: fn(*args), iters)
    split = {}
    if kind == "block" and dtype != F32:
        plan = qkv_plan(b * s, 3 * h_out, h)
        split = {"plan": plan, **block_split(lambda: fn(*args), x, w, qb,
                                             bias, n, scale, iters)}
        grid = split.get("gemm_grid")   # None where the trace missed
        if grid is not None:
            check(("wgmma" in str(split["gemm_kernel"]))
                  == (plan["route"] == "wgmma")
                  and grid[0] * grid[1] == plan["grid"],
                  f"K6 {spec.name} tp {tp} ({b}, {s}): the qkv GEMM ran "
                  f"{split['gemm_kernel']} on grid {grid}, plan {plan}")
    elif kind == "block":
        # K6 f32 is the SIMT qkv GEMM, then K7's attention at its shape
        split["attention_ms"] = attention_ms(b, s, h_out, n, scale, bias,
                                             gen, iters)
        split["gemm_ms"] = kernel_ms - split["attention_ms"]
    return {"kernel": "K6" if kind == "block" else "K7",
            "model": spec.name, "tp": tp, "h": h, "h_out": h_out,
            "heads": n, "head_dim": h // heads,
            "dtype": str(dtype).removeprefix("torch."), "b": b, "s": s,
            "ok": ok, "max_abs_err": float((got.float() - want.float())
                                           .abs().max()),
            "max_rel_err": rel, "min_cosine": cos,
            "broken_min_cosine": {name: attention_close(out, want)[1]
                                  for name, out in broken.items()},
            "broken_passes": [name for name, out in broken.items()
                              if attention_close(out, want)[0]],
            "ms": kernel_ms,
            "plain_ms": device_ms(lambda: ref(*args), max(2, iters // 2)),
            "library_ms": library_ms,
            "library_call": ("torch.addmm + " if kind == "block" else "")
            + "F.scaled_dot_product_attention with its transposes",
            "bound_ms": ms, "bound_by": bound_by, **split}


def qkv_plan(m, n, k) -> dict:
    """K6's qkv GEMM plan for (m, k) @ (k, n) on this card
    (``qkv_gemm_plan`` of the clusters the kernel reports the card holds),
    which must be the kernel's own (``sema_qkv_plan``) and fit a block's
    shared memory."""
    from sema_tpu_torch.ops import _cuda
    from sema_tpu_torch.ops.encoder_layer import SMEM_MAX, qkv_gemm_plan
    lib = _cuda.library("encoder_layer", {"sema_qkv_plan": [ctypes.c_int] * 3
                                          + [ctypes.POINTER(ctypes.c_int)]})
    got = (ctypes.c_int * 8)()
    _cuda.check(lib, lib.sema_qkv_plan(m, n, k, got), "sema_qkv_plan")
    want = qkv_gemm_plan(m, n, k, got[7])
    check(tuple(got[:7]) == (int(want.route == "wgmma"), *want[1:])
          and want.smem <= SMEM_MAX,
          f"M={m} N={n} K={k}: qkv_gemm_plan {want}, the kernel's "
          f"{list(got)}")
    return {**want._asdict(), "clusters_at_once": got[7]}


def block_split(run, x, w, qb, bias, heads, scale, iters) -> dict:
    """K6's two launches apart (the qkv GEMM, then the attention), device
    ms by the profiler with each kernel's name and the GEMM's grid, and
    the library's two calls alone by CUDA events: ``torch.addmm``, then
    SDPA on its output."""
    got = launch_profile(run, 2)
    if "error" in got[0]:
        return {"split_error": got[0]["error"]}
    gemm, attn = got
    b, s, h = x.shape
    addmm = lambda: torch.addmm(qb, x.view(b * s, h), w)
    qkv = addmm().view(b, s, -1)
    with torch.inference_mode():
        addmm_ms = device_ms(addmm, iters)
        sdpa_ms = device_ms(lambda: sdpa(qkv, bias, heads, scale), iters)
    return {"gemm_ms": gemm["ms"], "gemm_kernel": gemm["kernel"],
            "gemm_grid": gemm["grid"], "gemm_block": gemm["block"],
            "attention_ms": attn["ms"], "attention_kernel": attn["kernel"],
            "addmm_ms": addmm_ms, "sdpa_ms": sdpa_ms}


def unrounded_attention(qkv, bias, heads, scale):
    """``heads_attention`` with the scores left in f32 before the softmax
    (the probabilities still rounded to qkv's dtype): what a kernel that
    does not round its scores returns."""
    b, s, h3 = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, heads, h3 // 3 // heads).permute(
        2, 0, 3, 1, 4)
    scores = q.float() @ k.float().transpose(-1, -2) * scale \
        + bias.float()[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(qkv.dtype)
    ctx = (probs.float() @ v.float()).to(qkv.dtype)
    return ctx.permute(0, 2, 1, 3).reshape(b, s, h3 // 3)


ROUNDING_PROBE = (4, 512)      # K7's (B, S) of the probe below


def rounding_probe(gen) -> dict:
    """K7 in bf16 at gte-large tp 2 on a qkv whose scaled scores lie a
    fraction of a bf16 ulp apart: q = (16, 1, 0, ...), key j = (16, t_j,
    0, ...) with t_j in [0, 2) (exact in bf16), so a score is 32 + t_j / 8
    (scale 1/8), which rounds to 32 or 32.25; the values are random. The
    kernel must pass ``attention_close`` against its plain version, and
    the plain version with its scores left unrounded must fail it: every
    probability moves by up to 13% without the rounding, where the other
    cases' scores (about 2) move theirs by 0.4%, under what the limits
    see."""
    from sema_tpu_torch.models.registry import get_spec
    from sema_tpu_torch.ops.attention import (attention_qkv_reference,
                                              fused_attention_qkv)
    spec = get_spec(IVF_MODEL)
    b, s = ROUNDING_PROBE
    h_out, n = spec.hidden_size // 2, spec.num_heads // 2
    hd = h_out // n
    qkv = torch.zeros(b, s, 3, n, hd, device=DEV)
    qkv[:, :, 0, :, 0] = 16.0
    qkv[:, :, 0, :, 1] = 1.0
    qkv[:, :, 1, :, 0] = 16.0
    qkv[:, :, 1, :, 1] = torch.randint(0, 128, (b, s, n), generator=gen,
                                       device=DEV) / 64.0
    qkv[:, :, 2] = torch.randn(b, s, n, hd, generator=gen, device=DEV)
    qkv = qkv.reshape(b, s, 3 * h_out).to(BF16)
    bias = torch.zeros(b, s, device=DEV)
    scale = 1.0 / math.sqrt(hd)
    got = fused_attention_qkv(qkv, bias, n, scale)
    want = attention_qkv_reference(qkv, bias, n, scale)
    unrounded = unrounded_attention(qkv, bias, n, scale)
    torch.cuda.synchronize()
    ok, cos, rel = attention_close(got, want)
    bad, bad_cos, _ = attention_close(unrounded, want)
    return {"kernel": "K7", "model": spec.name, "tp": 2, "dtype": "bfloat16",
            "b": b, "s": s, "probe": "scores a fraction of an ulp apart",
            "ok": ok, "min_cosine": cos, "max_rel_err": rel,
            "broken_min_cosine": {"scores_unrounded": bad_cos},
            "broken_passes": ["scores_unrounded"] if bad else []}


def phase_attention(gen):
    """K6 and K7 at the local widths of K67_WIDTHS, in bf16, f16 and f32,
    K6 at K6_BS and K7 at K7_BS, then both at the tp_path's batches
    (K67_PATH). Every case is emitted before a failure raises."""
    from sema_tpu_torch.models.registry import get_spec
    cases = []
    for model, tp in K67_WIDTHS:
        spec = get_spec(model)
        for dtype in (BF16, F16, F32):
            for kind, shapes in (("block", K6_BS), ("qkv", K7_BS)):
                cases += [attention_case(kind, spec, tp, dtype, b, s, gen,
                                         iters=10) for b, s in shapes]
    spec = get_spec(IVF_MODEL)
    cases += [attention_case(kind, spec, 2, BF16, b, s, gen, iters=10)
              for kind, b, s in K67_PATH]
    cases += [attention_case(kind, spec, 2, F16, b, s, gen, iters=10)
              for kind, b, s in K67_PATH if kind == "block"]
    cases.append(rounding_probe(gen))
    emit("attention", cases=cases)
    bad = ([f"{c['kernel']} {c['model']} tp {c['tp']} {c['dtype']} "
            f"({c['b']}, {c['s']}): cosine {c['min_cosine']}, relative "
            f"error {c['max_rel_err']}" for c in cases if not c["ok"]]
           + [f"{c['kernel']} {c['model']} tp {c['tp']} {c['dtype']} "
              f"({c['b']}, {c['s']}): the check passes {c['broken_passes']}"
              for c in cases if c["broken_passes"]])
    check(not bad, "K6/K7: " + "; ".join(bad))
    return cases


# -- the kernels against another revision's, bit for bit ---------------------


def parent_libraries(root: Path, names) -> dict:
    """The kernel sources ``names`` (of ``csrc/encoder_layer.cu`` and
    ``csrc/scan_topk.cu``) of another revision's tree ``root``
    (``--parent-source``), built with the port's nvcc flags into
    build/kernels/parent/, one nvcc each, started together, and loaded:
    {source name: library}. The libraries are bound by the
    modules that call them (``bind``)."""
    from sema_tpu_torch.ops import _cuda
    out_dir = _cuda.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = root / "sema_tpu_torch" / "csrc" / f"{name}.cu"
        out = out_dir / f"lib{name}.so"
        procs[name] = (out, src, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, src, proc) in procs.items():
        log = proc.communicate()[0]
        check(proc.returncode == 0, f"{src} does not build: {log}")
        lib = ctypes.CDLL(str(out))
        lib.sema_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sema_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def bind(lib, modules) -> None:
    """Set the argument types of each entry point the ``modules`` call."""
    for module in modules:
        for fn, argtypes in module._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int


def in_library(fn, lib):
    """``fn`` run with ``_cuda.library`` giving ``lib``: this tree's
    wrappers over another build of the same entry points."""
    def run(*args):
        with swapped("sema_tpu_torch.ops._cuda", {"library": lambda *a: lib}):
            return fn(*args)
    return run


def bits_case(what, fn, parent_fn, args, iters) -> dict:
    """``fn(*args)`` through this tree's kernels and ``parent_fn(*args)``
    through the parent's: where their outputs (a tensor or a tuple of
    them) differ, and the ms of each by CUDA events (``ms``,
    ``parent_ms``), the means of three turns each in the order this tree,
    parent, parent, this tree, this tree, parent on the same card."""
    got, want = fn(*args), parent_fn(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    diff = [g.float() != w.float() for g, w in zip(got, want)]
    both = [torch.isfinite(g.float()) & torch.isfinite(w.float())
            for g, w in zip(got, want)]
    gaps = [(g.float() - w.float()).abs()[f] for g, w, f in
            zip(got, want, both)]
    times = {"ms": [], "parent_ms": []}
    for side in ("", "parent_", "parent_", "", "", "parent_"):
        f = parent_fn if side else fn
        times[side + "ms"].append(device_ms(lambda: f(*args), iters))
    return {"case": what,
            "bit_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
            "elements_differing": sum(int(d.sum()) for d in diff),
            "rows_differing": int(torch.stack(
                [d.reshape(-1, d.shape[-1]).any(1) for d in diff]).any(0)
                .sum()),
            "max_abs_diff": max((float(g.max()) for g in gaps if g.numel()),
                                default=0.0),
            **{key: sum(v) / len(v) for key, v in times.items()}}


def phase_layer_bits(gen, parent):
    """K2 at every K2_SHAPES case, K5 at every K5_SHAPES case, K6 at
    every K6_BS shape and K7 at every K7_BS shape of every K67_WIDTHS width
    and dtype, and both at the tp_path's (K67_PATH, gte-large tp 2, bf16),
    against the same wrappers with ``parent``, another revision's
    ``encoder_layer`` library, on the same inputs (K6's and K7's rows
    padded past random lengths): each output bit for bit, or where it
    differs, and both timed in turns in this run (the layers with their
    operands gathered once, as the Encoder calls them; 50 calls a turn at
    one query, whose host time varies most). Run with ``--parent-source``;
    not a phase of the default run."""
    from sema_tpu_torch.models.bert import LN_EPS
    from sema_tpu_torch.models.registry import get_spec
    from sema_tpu_torch.ops import attention, encoder_layer, encoder_layer_int8
    from sema_tpu_torch.ops.attention import (fused_attention_block,
                                              fused_attention_qkv)
    bind(parent, (encoder_layer, encoder_layer_int8, attention))
    cases = []
    for kernel, shapes, params, module, fn in (
            ("K2", K2_SHAPES, lambda sp: layer_params(
                sp.hidden_size, sp.intermediate_size, gen), encoder_layer,
             encoder_layer.fused_encoder_layer),
            ("K5", K5_SHAPES, lambda sp: int8_layer_params(sp, gen),
             encoder_layer_int8, encoder_layer_int8.fused_encoder_layer_int8)):
        for name in dict.fromkeys(m for m, _, _, _ in shapes):
            spec = get_spec(name)
            layer = params(spec)
            for m, dt, b, s in shapes:
                if m != name:
                    continue
                x, _, bias, heads, scale = layer_inputs(spec, dt, b, s, gen)
                ops = module.layer_operands(layer, dt)
                what = f"{kernel} {name} {str(dt).removeprefix('torch.')} " \
                       f"({b}, {s})"
                run = lambda *a, _o=ops: fn(*a, operands=_o)
                cases.append(bits_case(
                    what, run, in_library(run, parent),
                    (x, layer, bias, heads, scale, LN_EPS),
                    iters=50 if b == 1 else 10))
            del layer
            torch.cuda.empty_cache()
    def k67_shapes(model, tp, dt):
        shapes = [("K6", b, s) for b, s in K6_BS] + [("K7", b, s)
                                                     for b, s in K7_BS]
        if (model, tp, dt) == (IVF_MODEL, 2, BF16):   # the tp_path's own
            shapes += [("K6" if kind == "block" else "K7", b, s)
                       for kind, b, s in K67_PATH]
        return dict.fromkeys(shapes)

    for model, tp in K67_WIDTHS:
        spec = get_spec(model)
        h, heads = spec.hidden_size, spec.num_heads
        h_out, n = h // tp, heads // tp
        for dt in (BF16, F16, F32):
            for kernel, b, s in k67_shapes(model, tp, dt):
                lens = torch.randint(1, s + 1, (b,), generator=gen,
                                     device=DEV)
                lens[0] = s
                bias = (torch.arange(s, device=DEV)[None, :]
                        >= lens[:, None]).float() * -1e9
                if kernel == "K6":
                    x = torch.randn(b, s, h, generator=gen, device=DEV).to(dt)
                    w = (1.5 / math.sqrt(h) * torch.randn(
                        h, 3 * h_out, generator=gen, device=DEV)).to(dt)
                    qb = torch.randn(3 * h_out, generator=gen,
                                     device=DEV).to(dt)
                    fn, args = fused_attention_block, (x, w, qb, bias)
                else:
                    qkv = (1.5 * torch.randn(b, s, 3 * h_out, generator=gen,
                                             device=DEV)).to(dt)
                    fn, args = fused_attention_qkv, (qkv, bias)
                cases.append(bits_case(
                    f"{kernel} {model} tp {tp} "
                    f"{str(dt).removeprefix('torch.')} ({b}, {s})", fn,
                    in_library(fn, parent),
                    (*args, n, 1.0 / math.sqrt(h // heads)),
                    iters=50 if b == 1 else 10))
    emit("layer_bits", cases=cases)
    return cases


def parent_scans(root: Path, lib):
    """The scan wrappers of another revision's tree ``root``
    (``sema_tpu_torch/ops/scan_topk.py``, loaded as a module of its own,
    so that its own plan and entry points drive its kernels) over
    ``lib``, its ``scan_topk`` library."""
    import importlib.util
    from types import SimpleNamespace
    from sema_tpu_torch.ops import _cuda
    spec = importlib.util.spec_from_file_location(
        "parent_scan_topk", root / "sema_tpu_torch" / "ops" / "scan_topk.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bind(lib, (mod,))
    mod._cuda = SimpleNamespace(library=lambda *a: lib, aligned=_cuda.aligned,
                                launch=_cuda.launch, check=_cuda.check)
    return mod


# the paths' scan shapes: (what, kernel, rows or live tiles, d, k); a
# bucket's probe of 61 tiles of 512 (int8, k 128) or 62 (bf16, k 64), the
# tail's 3,600 rows, and the main path's MiniLM store
PATH_SCANS = (("K4b int8 IVF probe", "int8_pruned", 61, GTE_D, 128),
              ("K4a int8 tail", "int8", 3_600, GTE_D, 128),
              ("K3 bf16 IVF probe", "pruned", 62, GTE_D, 64),
              ("K1 bf16 tail", "bf16", 3_600, GTE_D, 64),
              ("K1 main path", "bf16", 3_600, D, 64))


def phase_scan_bits(gen, root: Path, lib):
    """K1, K3, K4a, K4b, K8 and K9 at every case of the phases scan_topk,
    scan_int8, scan_pruned and scan_ab, at the paths' shapes (PATH_SCANS),
    and K1, K4a and K4b at k = K_MAX, through this tree's wrappers and kernels and through
    another revision's (``parent_scans``), on the same inputs: scores and
    ids bit for bit, and both timed in turns in this run (``bits_case``).
    Run with ``--parent-source``; not a phase of the default run."""
    ours = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    theirs = parent_scans(root, lib)
    k_max = ours.K_MAX
    cases = []

    def add(kernel, what, name, args, nq, **kw):
        iters = 20 if nq == 1 else 5
        case = bits_case(f"{kernel} {what}",
                         lambda *a: getattr(ours, name)(*a, **kw),
                         lambda *a: getattr(theirs, name)(*a, **kw),
                         args, iters)
        cases.append({"kernel": kernel, "q": nq, **case})

    for n, nq, k, masked, d, dt in K1_CASES:
        store, q, valid = k1_inputs(n, nq, d, dt, gen)
        add("K1", f"({n}, {d}) {str(dt).removeprefix('torch.')}, Q {nq}, "
            f"k {k}, masked {masked}", "scan_topk", (store, q, valid, k,
                                                     masked), nq)
    del store, q, valid
    for d in (GTE_D, D):
        data = scan_store(d, gen)
        for nq in (1, 256):
            q = more_queries(data, nq, gen)
            for k in (16, 128):
                for kind, kernel in (("int8", "K4a"), ("pruned", "K3"),
                                     ("int8_pruned", "K4b")):
                    name, args = more_args(kind, data, q, k)
                    add(kernel, f"d {d}, Q {nq}, k {k}", name, args, nq)
        if d == GTE_D:      # k_max, and the paths' shapes, on the same rows
            for nq in (1, 256):
                q = more_queries(data, nq, gen)
                for kind, kernel in (("int8", "K4a"), ("int8_pruned", "K4b")):
                    name, args = more_args(kind, data, q, k_max)
                    add(kernel, f"d {d}, Q {nq}, k {k_max}", name, args, nq)
            q = more_queries(data, 1, gen)
            live = np.sort(np.random.default_rng(0).choice(
                SEAL // IVF_TILE, size=62, replace=False)).astype(np.int32)
            for what, kind, size, _, k in PATH_SCANS[:4]:
                if kind in ("pruned", "int8_pruned"):
                    store = ((data["qvals"], data["scales"])
                             if kind == "int8_pruned" else (data["bf16"],))
                    name = f"scan_topk_{kind}"
                    args = (*store, q, data["valid"], live, size, k,
                            IVF_TILE)
                elif kind == "int8":
                    name = "scan_topk_int8"
                    args = (data["qvals"][:size], data["scales"][:size], q,
                            data["valid"][:size], k)
                else:
                    name = "scan_topk"
                    args = (data["bf16"][:size], q, data["valid"][:size], k,
                            False)
                add(what.split()[0], f"path: {what}", name, args, 1)
        del data
        torch.cuda.empty_cache()
    store, q, valid = k1_inputs(3_600, 1, D, BF16, gen)
    add("K1", f"path: {PATH_SCANS[4][0]}", "scan_topk",
        (store, q, valid, 64, False), 1)
    store, q, valid = k1_inputs(SEAL, 256, D, BF16, gen)
    for nq in (1, 256):
        add("K1", f"({SEAL}, {D}) bfloat16, Q {nq}, k {k_max}", "scan_topk",
            (store, q[:nq], valid, k_max, True), nq)
    del store, q, valid
    # scan_ab's shapes and its K8 cases
    warm_store, fold_store = ab_stores(gen)
    live = torch.ones(AB_N, dtype=torch.bool, device=DEV)
    for nq, k in AB_SHAPES:
        qw, qf = ab_queries(warm_store, fold_store, nq, gen)
        add("K1", f"A/B ({AB_N}, {D}), Q {nq}, k {k}", "scan_topk",
            (warm_store, qw, live, k, False), nq)
        for w in (AB_WARM if k == 10 else AB_WARM[:1]):
            add("K8", f"A/B warm {w}, Q {nq}, k {k}", "scan_topk",
                (warm_store, qw, live, k, False), nq, warm_rows=w)
        add("K9", f"A/B ({AB_N}, {D}), Q {nq}, k {k}", "fold_topk",
            (fold_store, qf, k), nq)
    del warm_store, fold_store
    torch.cuda.empty_cache()
    tie_store, tie_q = one_hot_ties(AB_WARM[0], gen)
    add("K8", "one-hot ties", "scan_topk",
        (tie_store, tie_q, live[:AB_TIE_N], AB_TIE_K, True), AB_TIE_Q,
        warm_rows=AB_WARM[0])
    tomb, tomb_q, tomb_valid = k1_inputs(SEAL, 256, D, BF16, gen)
    for nq, k in ((1, 16), (256, 16), (256, 128)):
        add("K8", f"tombstones, Q {nq}, k {k}", "scan_topk",
            (tomb, tomb_q[:nq], tomb_valid, k, True), nq,
            warm_rows=AB_WARM[0])
    torch.cuda.empty_cache()
    differ = [c["case"] for c in cases if not c["bit_equal"]]
    check(not differ, f"scan_bits: not bit-equal to the parent's kernels: "
          f"{differ}")
    slower = [(c["case"], c["ms"] / c["parent_ms"]) for c in cases
              if c["ms"] > 1.05 * c["parent_ms"]]
    emit("scan_bits", cases=cases, slower_than_parent_by_5pc=slower)
    return cases


# -- main path ----------------------------------------------------------------

_WORDS = ("request", "retry", "backoff", "socket", "parse", "token", "vector",
          "index", "query", "cache", "buffer", "stream", "config", "error",
          "handler", "batch", "encode", "decode", "offset", "window")


def module_text(rng) -> str:
    """One Python-like source of about 7 KB (40 functions) from ``rng``."""
    lines = []
    for i in range(40):
        w = rng.choice(_WORDS, size=6)
        lines.append(f"def {w[0]}_{w[1]}_{i}(self, {w[2]}, {w[3]}=None):")
        lines.append(f"    # {' '.join(rng.choice(_WORDS, size=9))}")
        lines.append(f"    return self.{w[4]}({w[2]}, {w[5]}={w[3]})")
        lines.append("")
    return "\n".join(lines)


def make_tree(root: Path, n_files: int) -> Path:
    """``n_files`` Python-like sources of about 7 KB each, from seed 0."""
    rng = np.random.default_rng(0)
    for f in range(n_files):
        d = root / f"pkg{f % 16:02d}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"mod{f:04d}.py").write_text(module_text(rng))
    return root


def bucket_batches(enc, texts):
    """The index's rows and batches per sequence bucket of ``texts``, as
    Encoder.encode_texts forms them: per super-batch of 8 * batch_size
    chunks. Returns (rows, batches), two Counters keyed by bucket length."""
    counts, batches = Counter(), Counter()
    for off in range(0, len(texts), 8 * enc.batch_size):
        part = Counter(enc._bucket_len(len(tok_ids)) for tok_ids, _ in
                       enc._encode(texts[off:off + 8 * enc.batch_size]))
        for s, n in part.items():
            counts[s] += n
            batches[s] += -(-n // (enc.batch_size
                                   * max(1, enc.max_length // s)))
    return counts, batches


def run_cli(argv):
    """Run the port's CLI in-process; raise on a non-zero exit or on the
    warnings of a swallowed embed failure or of the substring fallback."""
    from sema_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(list(argv))
    check(rc == 0, f"{argv[0]} exited {rc}: {err.getvalue()[-2000:]}")
    for warning in ("Failed to index chunks", "falling back to substring"):
        check(warning not in err.getvalue(), err.getvalue()[-2000:])
    return out.getvalue()


WIDE_LIMIT = 1500              # a --limit above the scans' K_MAX


def wide_query(n_chunks: int, hits: list, extra=()) -> dict:
    """``query --limit WIDE_LIMIT``: above K_MAX the store takes the
    hierarchical route (``ops/hier_topk.py``), on the card, and launches
    no scan kernel. It must exit 0 with its hits equal, line for line, to
    those of the same query with the scans' plain versions swapped in, and
    its first hits must be the default query's (K1's), ids equal where
    the scores are more than 1e-5 apart."""
    argv = ["query", QUERY, "--json", "--limit", str(WIDE_LIMIT), *extra]
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_cli(argv)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    with plain_scans():
        plain = run_cli(argv)
    got = [json.loads(line) for line in out.splitlines()]
    check(len(got) == min(WIDE_LIMIT, n_chunks)
          and all(math.isfinite(h["score"]) for h in got),
          f"--limit {WIDE_LIMIT}: {len(got)} hits, or a score that is not "
          "finite")
    check(out == plain, f"--limit {WIDE_LIMIT}: the hits differ from the "
          "plain versions'")
    check(launches["encoder_layer"] > 0
          and not any(launches[name] for name in SCANS),
          f"--limit {WIDE_LIMIT} launches {launches}")
    for h, w in zip(hits, got):
        check(h["id"] == w["id"] or abs(h["score"] - w["score"]) <= 1e-5,
              f"--limit {WIDE_LIMIT}: hit {w['id']} ({w['score']}) where "
              f"K1 has {h['id']} ({h['score']})")
    return {"limit": WIDE_LIMIT, "hits": len(got), "seconds": seconds,
            "launches": launches}


def k_max_refusals(b: dict, qvec) -> None:
    """K1 and K4a on the card still refuse k above K_MAX with a
    KernelError, and count no launch."""
    from sema_tpu_torch.ops._cuda import KernelError
    from sema_tpu_torch.ops.quant import quantize_rows_device
    from sema_tpu_torch.ops.scan_topk import (K_MAX, scan_topk,
                                              scan_topk_int8)
    qvals, scales = quantize_rows_device(b["store"])
    for fn, args in ((scan_topk, (b["store"], qvec, b["valid"])),
                     (scan_topk_int8, (qvals, scales, qvec, b["valid"]))):
        before = fn.launches
        try:
            fn(*args, K_MAX + 1)
        except KernelError as e:
            check(f"k={K_MAX + 1}" in str(e), str(e))
        else:
            raise RuntimeError(f"{fn.__name__} took k={K_MAX + 1}")
        check(fn.launches == before, f"{fn.__name__} counted a refusal")


def phase_main_path(work: Path, n_files: int, extra=()):
    from sema_tpu_torch import cli
    from sema_tpu_torch.ingest.hashing import HASH_NAME
    from sema_tpu_torch.models.encoder import Encoder
    from sema_tpu_torch.utils.metrics import Metrics
    from sema_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference
    tree = make_tree(work / "tree", n_files)
    os.environ["SEMA_TPU_HOME"] = str(work / "home")
    os.environ["SEMA_TPU_DATA"] = str(work / "data")

    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_cli(["index", str(tree), "--stats", *extra])
    index_s = time.perf_counter() - t0
    index_launches = launch_counts()
    n_chunks = int(re.search(r"indexed (\d+) chunks", out).group(1))
    stats = json.loads(out[out.index("{"):])
    check(n_chunks >= n_files and index_launches["encoder_layer"] > 0, out)

    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_cli(["query", QUERY, "--json", *extra])
    query_cli_s = time.perf_counter() - t0
    query_launches = launch_counts()
    hits = [json.loads(line) for line in out.splitlines()]
    check(len(hits) == 50 and all(math.isfinite(h["score"]) for h in hits),
          f"{len(hits)} hits, or a score that is not finite")
    check(query_launches["encoder_layer"] > 0
          and query_launches["scan_topk"] > 0
          and not any(query_launches[n] for n in SCANS[1:]),
          f"query launches {query_launches}")

    wide = wide_query(n_chunks, hits, extra)

    again = run_cli(["index", str(tree), *extra])
    check("indexed 0 chunks" in again, again)

    # a manager of the same config: query latency and its stages, the
    # device's busy time under torch.profiler, then the sample checks
    args = cli.build_parser().parse_args(["query", QUERY, *extra])
    metrics = Metrics()
    mgr = cli.make_index_manager(cli.load_config(args), args.device,
                                 metrics=metrics)
    store, enc = mgr.vector_store, mgr.encoder
    for _ in range(3):
        mgr.search(QUERY, 50)
    metrics.stage_samples.clear()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        mgr.search(QUERY, 50)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    stages_p50_ms = {k: v * 1e3 for k, v in metrics.report()["p50_s"].items()}
    device = query_device_time(lambda: mgr.search(QUERY, 50), 20)

    # the query's hits against the plain scan of the same device rows
    qvec = enc.encode_query_device(QUERY)[None, :]
    buckets = store.device_buckets()
    check(len(buckets) == 1, f"{len(buckets)} device buckets")
    b = buckets[0]
    masked = not b["all_valid"]
    k = min(64, b["rows"])          # the k class of --limit 50
    got = scan_topk(b["store"], qvec, b["valid"], k, masked)
    want = scan_topk_reference(b["store"], qvec, b["valid"], k, masked)
    scan_err = check_scan(b["store"], qvec, b["valid"], masked, got, want)
    ids = store.search_batch(qvec, 50)[1][0]
    check([h["id"] for h in hits]
          == [store.chunk_at(int(i)).id for i in ids], "CLI hits differ")

    # stored rows of a sample against the plain encoder on the CPU
    sample = list(range(0, n_chunks, max(1, n_chunks // 16)))[:16]
    texts = [store.chunk_at(i).content for i in sample]
    cpu = Encoder(enc.spec, enc.params, enc.tokenizer,
                  max_length=enc.max_length, batch_size=enc.batch_size,
                  compute_dtype=enc.compute_dtype, device="cpu")
    ref = cpu.encode_texts(texts)
    rows = b["store"][sample].float().cpu()
    cos = F.cosine_similarity(rows, ref, dim=1)
    check(float(cos.min()) >= 0.9999, f"stored rows: cosine {cos.min()}")

    counts, batches = bucket_batches(
        enc, [store.chunk_at(i).content for i in range(n_chunks)])
    check(sum(batches.values()) * enc.spec.num_layers
          == index_launches["encoder_layer"],
          f"batches {dict(batches)}, launches {index_launches}")
    k1 = {"n": b["rows"], "q": 1, "k": k, "masked": masked,
          "max_abs_err": scan_err}
    ms, bound_by = bound(b["rows"] * D * 2 + (b["rows"] if masked else 0)
                         + D * 4 + k * 8, 2.0 * b["rows"] * D)
    k1.update(
        ms=device_ms(lambda: scan_topk(b["store"], qvec, b["valid"], k,
                                       masked), 50),
        plain_ms=device_ms(lambda: scan_topk_reference(
            b["store"], qvec, b["valid"], k, masked), 50),
        library_ms=device_ms(lambda: torch.topk(
            qvec.to(torch.bfloat16) @ b["store"].T, k), 50),
        bound_ms=ms, bound_by=bound_by)
    k_max_refusals(b, qvec)
    mgr.close()
    emit("main_path", files=n_files, chunks=n_chunks, hash=HASH_NAME,
         index_s=index_s, chunks_per_s=n_chunks / index_s,
         index_stages_s=stats["stages_s"], query_cli_s=query_cli_s,
         query_p50_ms=lat[len(lat) // 2], query_max_ms=lat[-1],
         query_stages_p50_ms=stages_p50_ms, query_device=device,
         index_launches=index_launches, query_launches=query_launches,
         bucket_rows={str(s): n for s, n in sorted(counts.items())},
         bucket_batches={str(s): n for s, n in sorted(batches.items())},
         stored_min_cosine=float(cos.min()), hits=len(hits), wide=wide)
    return index_launches, query_launches, k1


# -- int8 and IVF stores (BASELINE config 4) ----------------------------------

N_CENTRES = 2048               # true clusters of the synthetic corpus
NOISE, QNOISE = 1.5, 1.0       # tools/ivf_bench.py's defaults


def write_weights(path: Path) -> Path:
    """gte-large's random weights from seed 0 (``random_params``, what the
    port would draw with no weights at hand) written once as a
    ``model.safetensors`` under HF names, so each process of the paths
    loads them instead of drawing 335M numbers again. Returns the dir."""
    from sema_tpu_torch.models.loader import (_EMB_LEAVES, _LAYER_LEAVES,
                                              random_params)
    from sema_tpu_torch.models.registry import get_spec
    spec = get_spec(IVF_MODEL)
    params = random_params(spec, seed=0)
    emb, layers = params["embeddings"], params["layers"]
    h = spec.hidden_size
    tensors = {hf: emb[ours] for ours, hf in _EMB_LEAVES}
    for i in range(spec.num_layers):
        pre = f"encoder.layer.{i}."
        for ours, suffix, transpose in _LAYER_LEAVES:
            tensors[pre + suffix] = (layers[ours][i].T if transpose
                                     else layers[ours][i])
        for j, part in enumerate(("query", "key", "value")):
            self_ = pre + f"attention.self.{part}."
            tensors[self_ + "weight"] = layers["qkv_w"][i][:, j * h:
                                                         (j + 1) * h].T
            tensors[self_ + "bias"] = layers["qkv_b"][i][j * h:(j + 1) * h]
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * 4
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "model.safetensors", "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for t in tensors.values():
            f.write(t.contiguous().numpy().tobytes())
    return path


def write_config(home: Path, store_dtype: str, weights: Path) -> None:
    """gte-large from ``weights``, bf16 compute, max_length 256, batch
    256, with W8A8 linears (``[model] quant = "int8"``) over an int8 store:
    BASELINE config 4; the store in ``store_dtype`` with rescore_k 100
    and IVF at nprobe 32."""
    from sema_tpu_torch.config import ConfigManager
    manager = ConfigManager(home)
    config = manager.load_config()
    m, ix = config.model, config.index
    m.name, m.dtype, m.max_length, m.batch_size = (IVF_MODEL, "bfloat16",
                                                   256, 256)
    m.quant = "int8" if store_dtype == "int8" else "none"
    m.weights_path = str(weights)
    ix.store_dtype, ix.rescore_k, ix.ivf, ix.ivf_nprobe = (store_dtype, 100,
                                                           True, 32)
    manager.save_config(config)


def fill_store(data: Path, store_dtype: str, n_rows: int, gen) -> float:
    """``n_rows`` seeded synthetic rows through ``VectorStore.add_chunks``
    (the call IndexManager makes), one sealed bucket's worth per segment:
    unit vectors around N_CENTRES random unit centres, noise NOISE/sqrt(d)
    per dimension (tools/ivf_bench.py's clustered synthetic), with minimal
    chunk metadata. Returns the seconds it took."""
    from sema_tpu_torch.index.vector_store import VectorStore
    from sema_tpu_torch.types import Chunk
    t0 = time.perf_counter()
    store = VectorStore(data, GTE_D, IVF_MODEL, store_dtype=store_dtype,
                        ivf=True, device=DEV)
    seal = store.SEAL_ROWS
    cent = F.normalize(torch.randn(N_CENTRES, GTE_D, generator=gen,
                                   device=DEV), dim=1)
    for part in range(n_rows // seal):
        g = torch.randint(0, N_CENTRES, (seal,), generator=gen, device=DEV)
        rows = F.normalize(cent[g] + NOISE / math.sqrt(GTE_D) * torch.randn(
            seal, GTE_D, generator=gen, device=DEV), dim=1).to(BF16)
        path = Path(f"/synthetic/part{part}.txt")
        store.add_chunks([Chunk(f"{path}:{i}", path, i + 1, i + 1, "")
                          for i in range(seal)], rows)
    store.close()
    return time.perf_counter() - t0


def path_scan_times(store, qvec, k) -> dict:
    """The path's scan kernels at the path's shapes (the first sealed
    bucket's probe for this query, and the tail), against their plain
    versions and the library call: {kernel name: fields}."""
    scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    from sema_tpu_torch.ops.ivf import select_tiles
    buckets = store.device_buckets()
    b, tail = buckets[0], buckets[-1]
    ivf = b["ivf"]
    budget = max(2, (b["n_pad"] // store.IVF_TILE) // store.IVF_BUDGET_DIV)
    tiles, n_live = select_tiles(ivf["centroids"], ivf["starts"],
                                 qvec.cpu().numpy(), store.ivf_nprobe,
                                 store.IVF_TILE, budget)
    idx = (torch.as_tensor(tiles[:n_live], device=DEV)[:, None]
           * store.IVF_TILE + torch.arange(store.IVF_TILE, device=DEV)
           ).reshape(-1)
    rows, n, d = n_live * store.IVF_TILE, tail["rows"], GTE_D
    out = {}
    if store.quantized:
        cases = {
            "scan_topk_int8_pruned": ((*b["store"], qvec, b["valid"], tiles,
                                       n_live, k, store.IVF_TILE), rows,
                                      b["store"], b["valid"], idx),
            "scan_topk_int8": ((*tail["store"], qvec, tail["valid"], k), n,
                               tail["store"], tail["valid"], None)}
        for name, (args, r, (qv, sc), valid, gather) in cases.items():
            lib, note = int8_library(qv, sc, valid, qvec, k, gather)
            out[name] = {"library_ms": None if lib is None
                         else device_ms(lib, 20), "library_note": note,
                         "rows_scanned": r, "k": k, "args": args,
                         "bound": bound(r * (d + 5) + d * 4 + k * 8
                                        + (0 if gather is None
                                           else 4 * n_live),
                                        2.0 * r * d, INT8_OPS_PER_S)}
    else:
        store_b, tail_s = b["store"], tail["store"]
        out["scan_topk_pruned"] = {
            "args": (store_b, qvec, b["valid"], tiles, n_live, k,
                     store.IVF_TILE), "rows_scanned": rows, "k": k,
            "library_ms": device_ms(lambda: torch.topk(
                qvec.to(BF16) @ store_b.index_select(0, idx).T, k), 20),
            "bound": bound(rows * (2 * d + 1) + d * 4 + k * 8 + 4 * n_live,
                           2.0 * rows * d)}
        out["scan_topk"] = {
            "args": (tail_s, qvec, tail["valid"], k,
                     not tail["all_valid"]), "rows_scanned": n, "k": k,
            "library_ms": device_ms(lambda: torch.topk(
                qvec.to(BF16) @ tail_s.T, k), 20),
            "bound": bound(n * (2 * d + 1) + d * 4 + k * 8, 2.0 * n * d)}
    for name, f in out.items():
        fn = getattr(scan_mod, name)
        ref = getattr(scan_mod, f"{name}_reference")
        args = f.pop("args")
        got, want = fn(*args), ref(*args)
        torch.cuda.synchronize()
        fin = torch.isfinite(want[0])
        f["max_abs_err"] = (float((got[0][fin] - want[0][fin]).abs().max())
                            if fin.any() else 0.0)
        check(torch.equal(got[1], want[1]), f"{name} on the path: ids differ "
              "from the plain version's")
        f["ms"] = device_ms(lambda: fn(*args), 50)
        f["plain_ms"] = device_ms(lambda: ref(*args), 20)
        f["passes"] = scan_passes(lambda: fn(*args))
        f["bound_ms"], f["bound_by"] = f.pop("bound")
        if f.get("library_note") is None:
            f.pop("library_note", None)
    return out


def phase_ivf_path(work: Path, tree: Path, store_dtype: str, n_rows: int,
                   gen, weights: Path, device: str = "cuda") -> dict:
    from sema_tpu_torch import cli
    from sema_tpu_torch.models.registry import get_spec
    from sema_tpu_torch.utils.metrics import Metrics
    name = "int8_ivf_path" if store_dtype == "int8" else "bf16_ivf_path"
    home, data = work / f"home-{store_dtype}", work / f"data-{store_dtype}"
    os.environ["SEMA_TPU_HOME"] = str(home)
    os.environ["SEMA_TPU_DATA"] = str(data)
    write_config(home, store_dtype, weights)
    fill_s = fill_store(data, store_dtype, n_rows, gen)
    # the int8 deployment runs every layer through K5, the bf16 one K2
    int8 = store_dtype == "int8"
    layer_k, other_k = (("encoder_layer_int8", "encoder_layer") if int8
                        else ("encoder_layer", "encoder_layer_int8"))

    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_cli(["index", str(tree), "--stats", "--device", device])
    index_s = time.perf_counter() - t0
    index_launches = launch_counts()
    n_chunks = int(re.search(r"indexed (\d+) chunks", out).group(1))
    stats = json.loads(out[out.index("{"):])
    check(n_chunks > 0 and index_launches[layer_k] > 0
          and not index_launches[other_k]
          and not any(index_launches[n] for n in SCANS),
          f"{name} index: {n_chunks} chunks, launches {index_launches}")

    # the first query of the store: it builds the buckets (k-means of each
    # sealed one, its sidecar written) before it scans
    pruned, exact_scan = (("scan_topk_int8_pruned", "scan_topk_int8") if int8
                          else ("scan_topk_pruned", "scan_topk"))
    sealed = n_rows // SEAL
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_cli(["query", QUERY, "--json", "--device", device])
    query_cli_s = time.perf_counter() - t0
    query_launches = launch_counts()
    hits = [json.loads(line) for line in out.splitlines()]
    check(len(hits) == 50 and all(math.isfinite(h["score"]) for h in hits),
          f"{name}: {len(hits)} hits, or a score that is not finite")
    want = dict.fromkeys(query_launches, 0)
    want.update({layer_k: get_spec(IVF_MODEL).num_layers,
                 pruned: sealed, exact_scan: 1})
    check(query_launches == want, f"{name} query launches {query_launches}, "
          f"want {want}")

    args = cli.build_parser().parse_args(["query", QUERY])
    metrics = Metrics()
    mgr = cli.make_index_manager(cli.load_config(args), device,
                                 metrics=metrics)
    store, enc = mgr.vector_store, mgr.encoder
    t0 = time.perf_counter()
    buckets = store.device_buckets()          # the sidecars, no k-means
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    check([b["ivf"] is not None for b in buckets] == [True] * sealed
          + [False] and buckets[-1]["rows"] == n_chunks,
          f"{name}: buckets {[(b['rows'], b['sealed']) for b in buckets]}")

    # the index's K2 launches per sequence bucket; the stored rows of a
    # sample of the tail (bf16 originals on disk) against the plain
    # encoder on the card
    tail = buckets[-1]
    texts = [store.chunk_at(tail["row_offset"] + i).content
             for i in range(n_chunks)]
    counts, batches = bucket_batches(enc, texts)
    layers = get_spec(IVF_MODEL).num_layers
    check(sum(batches.values()) * layers == index_launches[layer_k],
          f"{name}: batches {dict(batches)}, launches {index_launches}")
    sample = list(range(0, n_chunks, max(1, n_chunks // 16)))[:16]
    with plain_layers():
        ref = enc.encode_texts([texts[i] for i in sample])
    rows = torch.from_numpy(store.rows_at(
        np.array([tail["row_offset"] + i for i in sample])))
    cos = F.cosine_similarity(rows, ref, dim=1)
    check(float(cos.min()) >= 0.9999,
          f"{name}: stored rows against the plain encoder: cosine "
          f"{cos.tolist()}")
    for _ in range(3):
        mgr.search(QUERY, 50)
    metrics.stage_samples.clear()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        mgr.search(QUERY, 50)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    stages_p50_ms = {k: v * 1e3 for k, v in metrics.report()["p50_s"].items()}
    busy = query_device_time(lambda: mgr.search(QUERY, 50), 20)

    # the kernels' hits against the plain versions', same card, same query
    # vector, so the same tile selection
    qvec = enc.encode_query_device(QUERY)[None, :]
    got = store.search_batch(qvec, 50)
    with plain_scans():
        plain = store.search_batch(qvec, 50)
    check(np.array_equal(got[1], plain[1]), f"{name}: the kernels' hits "
          "differ from the plain versions'")
    if int8:
        check(np.array_equal(got[0], plain[0]), f"{name}: rescored scores "
              "differ from the plain versions'")

    # a stored row of each sealed bucket, as the query, comes back first
    # through the probe; exact=True scans every bucket whole
    for b in buckets[:sealed]:
        row = b["row_offset"] + 12_345 % b["rows"]
        q = torch.from_numpy(store.rows_at(np.array([row])))[0]
        reset_launch_counts()
        top = store.search(q, 10)[0][0]
        c = launch_counts()
        check(top.id == store.chunk_at(row).id and c[pruned] == sealed,
              f"{name}: planted row {row} came back as {top.id}, "
              f"launches {c}")
    reset_launch_counts()
    store.search(q, 10, exact=True)
    c = launch_counts()
    check(c[exact_scan] == sealed + 1 and c[pruned] == 0,
          f"{name}: exact=True launches {c}")

    # recall@10 of the probe against exact=True: perturbed stored rows
    rng = np.random.default_rng(1)
    picks = rng.choice(n_rows, size=100, replace=False)
    qs = store.rows_at(picks) + (QNOISE / math.sqrt(GTE_D)) * \
        rng.standard_normal((100, GTE_D)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    recall, ivf_ms, exact_ms = [], [], []
    for q in qs:
        t0 = time.perf_counter()
        a = store.search_batch(q[None], 10)[1][0]
        t1 = time.perf_counter()
        e = store.search_batch(q[None], 10, exact=True)[1][0]
        t2 = time.perf_counter()
        recall.append(len(set(a.tolist()) & set(e.tolist())) / 10)
        ivf_ms.append((t1 - t0) * 1e3)
        exact_ms.append((t2 - t1) * 1e3)
    recall = np.asarray(recall)
    kernels = path_scan_times(store, qvec, 128 if int8 else 64)
    requests = serve_requests(mgr) if int8 else None
    mgr.close()
    del store, buckets, mgr, enc
    torch.cuda.empty_cache()
    emit(name, rows=n_rows, sealed_buckets=sealed, tail_chunks=n_chunks,
         fill_s=fill_s, index_s=index_s, index_stages_s=stats["stages_s"],
         index_launches=index_launches, query_cli_s=query_cli_s,
         query_launches=query_launches, open_s=open_s,
         bucket_rows={str(s): n for s, n in sorted(counts.items())},
         bucket_batches={str(s): n for s, n in sorted(batches.items())},
         stored_min_cosine=float(cos.min()),
         query_p50_ms=lat[len(lat) // 2], query_max_ms=lat[-1],
         query_stages_p50_ms=stages_p50_ms, query_device=busy,
         recall_at_10_mean=float(recall.mean()),
         recall_at_10_p5=float(np.percentile(recall, 5)),
         recall_at_10_min=float(recall.min()),
         search_batch_p50_ms={"ivf": float(np.median(ivf_ms)),
                              "exact": float(np.median(exact_ms))},
         kernels=kernels)
    if requests is not None:
        phase_serve(tree, requests, device)
    return {"query_launches": query_launches,
            "index_launches": index_launches, "kernels": kernels,
            "recall_at_10_mean": float(recall.mean())}


# -- spill (the stores past a device budget: HBM spill, spilled-IVF probe) ---

SPILL_BUDGET_MB = 640          # [index] hbm_budget_mb: one sealed bucket fits
SPILL_WARM = 20                # warm queries on the IVF route
SPILL_QUERIES = (QUERY, "parse the socket token stream",
                 "vector index of each file", "request timeout handling",
                 "token parser for the request body")   # the exact route's
SPILL_SLICE = 262_144          # VectorStore.SPILL_SLICE_ROWS
SPILL_TILE = 128               # VectorStore.IVF_SPILL_TILE
BLOB_ROOM = 4 << 30            # bytes the spill layouts may write
SPILL_SPLIT_TURNS = 20         # IVF probes a staging mode, in turns


class ScanRecorder:
    """The store's scan wrappers, each call recorded as (name, rows of the
    tensor it scans, tile_n or None) with its arguments, then made
    through the wrapper, which counts its launch."""

    def __init__(self):
        self.calls = []

    @contextmanager
    def recording(self):
        store_mod = importlib.import_module(
            "sema_tpu_torch.index.vector_store")
        wrap = {}
        for name in SCANS:
            def call(*a, _fn=getattr(store_mod, name), _name=name, **k):
                tile_n = a[-1] if "pruned" in _name else None
                self.calls.append((_name, a[0].shape[0], tile_n, a))
                return _fn(*a, **k)
            wrap[name] = call
        with swapped("sema_tpu_torch.index.vector_store", wrap):
            yield self

    def shapes(self) -> Counter:
        return Counter((n, r, t) for n, r, t, _ in self.calls)


@contextmanager
def spill_counters():
    """Host seconds and rows of each slice fill (on the prefetch thread)
    and the bytes each search copies to the card, through the store's
    ``_fill_rows_range`` and ``_upload``."""
    from sema_tpu_torch.index.vector_store import VectorStore
    stats = {"fills": [], "staged_bytes": 0}
    fill, upload = VectorStore._fill_rows_range, VectorStore._upload

    def timed_fill(self, seg_range, lo, hi, *a):
        t0 = time.perf_counter()
        fill(self, seg_range, lo, hi, *a)
        stats["fills"].append(((time.perf_counter() - t0) * 1e3, hi - lo))

    def counted_upload(self, *host):
        stats["staged_bytes"] += sum(t.numel() * t.element_size()
                                     for t in host)
        return upload(self, *host)
    VectorStore._fill_rows_range = timed_fill
    VectorStore._upload = counted_upload
    try:
        yield stats
    finally:
        VectorStore._fill_rows_range = fill
        VectorStore._upload = upload


def pinned_rate() -> float:
    """The card's own pinned host-to-device rate, bytes a second: one
    copy of SPILL_SLICE bf16 rows at GTE_D (512 MiB) from pinned memory,
    timed by CUDA events over 5 copies after one."""
    n = SPILL_SLICE * GTE_D * 2
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device=DEV)
    ms = device_ms(lambda: dev.copy_(host, non_blocking=True), 5)
    del host, dev
    return n / (ms / 1e3)


def stall_cycles(ms: float) -> int:
    """The ``torch.cuda._sleep`` cycles that hold the stream ``ms``."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    return int(10 ** 7 * ms / start.elapsed_time(end))


@contextmanager
def stalled_uploads(ms: float = 300.0):
    """Each of the store's uploads queued behind ``ms`` of sleep on the
    current stream, so that the host fills the next slice or stage while
    the copy of the last one still waits: a pinned buffer filled again
    before its copy has read it hands the scan other rows."""
    from sema_tpu_torch.index.vector_store import VectorStore
    upload = VectorStore._upload
    cycles = stall_cycles(ms)

    def stalled(self, *host):
        torch.cuda._sleep(cycles)
        return upload(self, *host)
    VectorStore._upload = stalled
    try:
        yield
    finally:
        VectorStore._upload = upload


def set_budget(home: Path, budget_mb: float) -> None:
    from sema_tpu_torch.config import ConfigManager
    manager = ConfigManager(home)
    config = manager.load_config()
    config.index.hbm_budget_mb = budget_mb
    manager.save_config(config)


def open_manager(device: str, metrics=None):
    from sema_tpu_torch import cli
    args = cli.build_parser().parse_args(["query", QUERY])
    return cli.make_index_manager(cli.load_config(args), device,
                                  metrics=metrics)


def spill_prepare(work: Path, tree: Path, store_dtype: str, gen, weights,
                  device: str) -> Path:
    """The data dir of ``*_ivf_path`` for ``store_dtype``, filled and
    indexed as that phase does when the phase did not run before."""
    home, data = work / f"home-{store_dtype}", work / f"data-{store_dtype}"
    os.environ["SEMA_TPU_HOME"] = str(home)
    os.environ["SEMA_TPU_DATA"] = str(data)
    if not (data / "vector_index" / "manifest.json").exists():
        write_config(home, store_dtype, weights)
        fill_store(data, store_dtype, 4 * SEAL, gen)
        run_cli(["index", str(tree), "--device", device])
    return home


def planted_rows(b: dict) -> list:
    """Rows of a spilled bucket that open and close a cluster's span in
    its blob: a probe whose spans are off by a tile misses one of them."""
    iv = b["ivf_spill"]
    starts, c = iv["starts"], len(iv["centroids"])
    sizes = np.diff(starts[:c + 1])
    big = int(np.argmax(sizes))
    span = iv["perm"][int(starts[big]):int(starts[big + 1])]
    span = span[span < b["rows"]]
    return [b["row_offset"] + int(span[0]), b["row_offset"] + int(span[-1])]


def spill_launch_ms(fn, n_scans: int) -> list:
    """Device ms of each scan call of ``fn()`` in order (its pass 1 and
    pass 2 summed), by the profiler."""
    got = launch_profile(fn, 2 * n_scans, iters=3,
                         keep=lambda n: "scan_pass" in n)
    if "error" in got[0]:
        return got
    return [got[2 * i]["ms"] + got[2 * i + 1]["ms"] for i in range(n_scans)]


def split_specs(live: np.ndarray, b_eff: int) -> tuple:
    """(live tiles, staging tiles) of each stage where the JAX package
    stages a probe of ``live`` tiles in a buffer of ``b_eff``: from 16 live
    tiles up in two halves, the first on the staging grid
    (``sema_tpu/index/vector_store.py:133-149, 1880-1899``)."""
    if len(live) < 16:
        return ((live, b_eff),)
    half = b_eff // 2
    if half >= 64:
        b1 = half // 64 * 64
    else:
        b1 = 1
        while b1 * 2 <= half:
            b1 *= 2
    n1 = min(len(live) // 2, b1)
    return ((live[:n1], b1), (live[n1:], b_eff - b1))


def split_dispatch(self, spill_bs, q, q_host, k_scan, window):
    """``VectorStore._ivf_spill_dispatch`` staging as the JAX package
    stages (:func:`split_specs`), the second half gathered while the first
    is copied: the store's route with the split, to time against its
    own."""
    from sema_tpu_torch.index.vector_store import _stage_tiles
    from sema_tpu_torch.ops.ivf import select_tiles
    if k_scan > 128:
        return None
    view = self._spill_union_view(spill_bs)
    budget = max(2, view["n_tiles"] // self.IVF_BUDGET_DIV)
    sel = select_tiles(view["centroids"], view["starts"], q_host,
                       self.ivf_nprobe, self._spill_tile(), budget)
    if sel is None:
        return None
    tiles, n_live = sel
    return [self._ivf_spill_stage(spill_bs, view, lt, be, q, k_scan, window)
            for lt, be in split_specs(tiles[:n_live],
                                      _stage_tiles(n_live, budget))]


def spill_kernel_case(name, args, k, staged: bool) -> dict:
    """One of the spill path's new launch shapes against its plain
    version, with its time, the plain version's, the library call's and
    the bound. ``args`` are the wrapper's arguments as the path gave
    them."""
    scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    fn = getattr(scan_mod, name)
    ref = getattr(scan_mod, f"{name}_reference")
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    if name == "scan_topk_int8_pruned":
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{name} at tile 128 differs from its plain version")
        fin = torch.isfinite(want[0])
        err = (float((got[0][fin] - want[0][fin]).abs().max())
               if fin.any() else 0.0)
    else:
        # the slice's or the staged rows' own scores within 1e-5, the
        # -inf slots and no row twice (the path scans masked), and the
        # ids as the plain version ranks them
        check(torch.equal(got[1], want[1]),
              f"{name} on the spill path: ids differ from the plain "
              "version's")
        err = check_scan(args[0], args[1], args[2], True, got, want)
    store, q = args[0], args[2] if name == "scan_topk_int8_pruned" else args[1]
    rows, d = store.shape
    if name == "scan_topk_int8_pruned":
        qv, sc = args[0], args[1]
        lib, note = int8_library(qv, sc, args[3], q, k)
        lib_ms = None if lib is None else device_ms(lib, 20)
        bnd = bound(rows * (d + 5) + d * 4 + k * 8 + 4 * args[5],
                    2.0 * rows * d, INT8_OPS_PER_S)
    else:
        lib_ms = device_ms(lambda: torch.topk(q.to(store.dtype) @ store.T,
                                              k), 20)
        bnd = bound(rows * (2 * d + 1) + d * 4 + k * 8
                    + (4 * args[4] if staged else 0), 2.0 * rows * d)
    return {"max_abs_err": err, "ms": device_ms(lambda: fn(*args), 50),
            "plain_ms": device_ms(lambda: ref(*args), 20),
            "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "rows": rows, "k": k}


def spill_store(work: Path, tree: Path, store_dtype: str, gen, weights,
                device: str, device_recall) -> dict:
    """One store of the IVF paths reopened under ``hbm_budget_mb =
    SPILL_BUDGET_MB``: three of its four sealed buckets spill; the first
    query builds their spill layouts; SPILL_WARM queries take the union
    probe; the exact route streams the spilled buckets through K1."""
    from sema_tpu_torch.index.vector_store import _host_np, _stage_tiles
    from sema_tpu_torch.models.registry import get_spec
    from sema_tpu_torch.ops.ivf import select_tiles
    from sema_tpu_torch.utils.metrics import Metrics
    int8 = store_dtype == "int8"
    name = f"spill {store_dtype}"
    home = spill_prepare(work, tree, store_dtype, gen, weights, device)
    check(shutil.disk_usage(work).free >= BLOB_ROOM,
          f"{name}: {shutil.disk_usage(work).free} bytes free for the "
          "spill layouts' blobs")
    set_budget(home, SPILL_BUDGET_MB)
    layer_k = "encoder_layer_int8" if int8 else "encoder_layer"
    pruned, tail_scan = (("scan_topk_int8_pruned", "scan_topk_int8") if int8
                         else ("scan_topk_pruned", "scan_topk"))
    layers = get_spec(IVF_MODEL).num_layers
    mgr = open_manager(device, Metrics())
    store, enc = mgr.vector_store, mgr.encoder
    rec = ScanRecorder()
    out = {"launches": Counter(), "stage_launches": 0, "slice_launches": 0}
    with spill_counters() as stats:
        # the first query: the bucket build, three spill layouts (k-means
        # on the card, blobs written) and the probe
        reset_launch_counts()
        t0 = time.perf_counter()
        mgr.search(QUERY, 10)
        torch.cuda.synchronize()
        out["first_query_s"] = time.perf_counter() - t0
        res = store.device_residency()
        buckets = store.device_buckets()
        spilled = [b for b in buckets if b.get("host_resident")]
        # the tree's tail: one bucket, more after int8_ivf_path's serve
        # re-indexed files
        tails = buckets[4:]
        check(res["host_buckets"] == 3 and res["spilled_rows"] == 3 * SEAL
              and [bool(b.get("host_resident")) for b in buckets]
              == [False, True, True, True] + [False] * len(tails)
              and tails and not any(b["sealed"] for b in tails)
              and buckets[0]["ivf"] is not None
              and all(b["ivf_spill"] is not None for b in spilled),
              f"{name}: residency {res}, buckets "
              f"{[(b['rows'], bool(b.get('host_resident'))) for b in buckets]}")
        out.update(residency=res, tail_buckets=len(tails))

        # the IVF route: launches counted exactly, query by query
        qvec = enc.encode_query_device(QUERY)[None, :]
        view = store._spill_union_view(spilled)
        t = store._spill_tile()
        tiles, n_live = select_tiles(
            view["centroids"], view["starts"], qvec.cpu().numpy(),
            store.ivf_nprobe, t, max(2, view["n_tiles"] // store.IVF_BUDGET_DIV))
        want_shapes = Counter([(pruned, SEAL, store.IVF_TILE)]
                              + [(tail_scan, b["rows"], None) for b in tails])
        for _ in range(3):
            mgr.search(QUERY, 10)
        lat, staged = [], []
        for _ in range(SPILL_WARM):
            reset_launch_counts()
            rec.calls.clear()
            stats["staged_bytes"] = 0
            t0 = time.perf_counter()
            with rec.recording():
                mgr.search(QUERY, 10)
            lat.append((time.perf_counter() - t0) * 1e3)
            staged.append(stats["staged_bytes"])
            c = launch_counts()
            out["launches"].update(c)
            want = dict.fromkeys(c, 0)
            want.update({layer_k: layers, pruned: 2,
                         tail_scan: len(tails)})
            shapes = rec.shapes()
            stage_shapes = {k: v for k, v in shapes.items()
                            if k[0] == pruned and k[2] == SPILL_TILE}
            check(c == want and sum(stage_shapes.values()) == 1
                  and all(shapes[k] == v for k, v in want_shapes.items())
                  and sum(shapes.values()) == 2 + len(tails),
                  f"{name}: IVF route launches {c}, want {want}; shapes "
                  f"{dict(shapes)}")
            out["stage_launches"] += 1
        stage_args = [a for n, _, tn, a in rec.calls
                      if n == pruned and tn == SPILL_TILE]
        rec.calls.clear()
        lat.sort()
        out.update(ivf_p50_ms=lat[len(lat) // 2], ivf_max_ms=lat[-1],
                   live_tiles=int(n_live),
                   ivf_staged_mib=float(np.median(staged)) / 2 ** 20)
        out["ivf_device"] = query_device_time(lambda: mgr.search(QUERY, 10),
                                              SPILL_WARM)
        tail_names = [f"tail{i}" for i in range(len(tails))]
        out["ivf_launch_ms"] = dict(zip(
            ["stage", "device_bucket"] + tail_names,
            spill_launch_ms(lambda: store.search_batch(qvec, 10),
                            2 + len(tails))))

        # the kernels' hits against the plain versions', same tiles
        got = store.search_batch(qvec, 10)
        with plain_scans():
            plain = store.search_batch(qvec, 10)
        check(np.array_equal(got[1], plain[1]), f"{name}: the union probe's "
              f"hits {got[1]} differ from the plain versions' {plain[1]}")
        # the JAX package's split (a probe of 16 live tiles or more staged
        # in two halves, the second gathered while the first is copied)
        # against the port's one buffer, in turns: the IVF route (one
        # query's search_batch, the same answer both ways), and the
        # store's own stage alone (each probe's candidates fetched, the
        # same top 10 both ways)
        from sema_tpu_torch.index.vector_store import VectorStore
        own = VectorStore._ivf_spill_dispatch
        budget = max(2, view["n_tiles"] // store.IVF_BUDGET_DIV)
        live = tiles[:n_live]
        b_eff = _stage_tiles(int(n_live), budget)
        q_stage, k_stage = stage_args[0][2 if int8 else 1], stage_args[0][-2]
        modes = {"one_buffer": ((live, b_eff),),
                 "split": split_specs(live, b_eff)}
        check(len(modes["split"]) == 2, f"{name}: {n_live} live tiles")
        route_ms, stage_ms = {m: [] for m in modes}, {m: [] for m in modes}
        tops = {}
        for turn in range(SPILL_SPLIT_TURNS):
            for mode in sorted(modes, reverse=bool(turn % 2)):
                VectorStore._ivf_spill_dispatch = (split_dispatch
                                                   if mode == "split"
                                                   else own)
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    one = store.search_batch(qvec, 10)
                    route_ms[mode].append((time.perf_counter() - t0) * 1e3)
                finally:
                    VectorStore._ivf_spill_dispatch = own
                check(np.array_equal(one[0], got[0])
                      and np.array_equal(one[1], got[1]),
                      f"{name}: the probe staged as {mode} answers {one}, "
                      f"not {got}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                window = []
                entries = [store._ivf_spill_stage(spilled, view, lt, be,
                                                  q_stage, k_stage, window)
                           for lt, be in modes[mode]]
                cand = [(float(sc), int(e[3][ix]))
                        for e in entries
                        for sc, ix in zip(_host_np(e[0])[0],
                                          _host_np(e[1])[0])
                        if np.isfinite(sc)]
                stage_ms[mode].append((time.perf_counter() - t0) * 1e3)
                tops[mode] = sorted(cand, key=lambda c: (-c[0], c[1]))[:10]
        check(tops["split"] == tops["one_buffer"], f"{name}: the probe "
              f"staged in two halves gives {tops['split']}, in one buffer "
              f"{tops['one_buffer']}")
        out["split_turns"] = SPILL_SPLIT_TURNS
        for m in modes:
            out[f"ivf_{m}_route_p50_ms"] = float(np.median(route_ms[m]))
            out[f"ivf_{m}_stage_p50_ms"] = float(np.median(stage_ms[m]))
        # rows that open and close a cluster of each spilled bucket come
        # back first through the union probe
        for b in spilled:
            for row in planted_rows(b):
                q = torch.from_numpy(store.rows_at(np.array([row])))
                top = store.search_batch(q, 10)[1][0][0]
                check(int(top) == row, f"{name}: planted row {row} came "
                      f"back as {top}")

        # recall@10 of the IVF route against exact=True
        rng = np.random.default_rng(1)
        picks = rng.choice(4 * SEAL, size=100, replace=False)
        qs = store.rows_at(picks) + (QNOISE / math.sqrt(GTE_D)) * \
            rng.standard_normal((100, GTE_D)).astype(np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        exact_ids = store.search_batch(qs, 10, exact=True)[1]
        recall = [len(set(store.search_batch(q[None], 10)[1][0].tolist())
                      & set(e.tolist())) / 10
                  for q, e in zip(qs, exact_ids)]
        out.update(recall_at_10_mean=float(np.mean(recall)),
                   recall_at_10_min=float(np.min(recall)),
                   device_resident_recall_at_10=device_recall)

        # the exact route: the three spilled buckets stream a slice each
        qvs = torch.stack([enc.encode_query_device(s) for s in SPILL_QUERIES])
        dev_rows = buckets[0]["store"][0] if int8 else buckets[0]["store"]
        exact_scan = "scan_topk_int8" if int8 else "scan_topk"
        answers, lat = [], []
        stats["fills"].clear()
        for qv in qvs:
            reset_launch_counts()
            rec.calls.clear()
            stats["staged_bytes"] = 0
            t0 = time.perf_counter()
            with rec.recording():
                answers.append(store.search_batch(qv[None], 10, exact=True))
            lat.append((time.perf_counter() - t0) * 1e3)
            c = launch_counts()
            out["launches"].update(c)
            want = dict.fromkeys(c, 0)
            want.update({"scan_topk": 3 + (0 if int8 else 1 + len(tails))})
            if int8:
                want["scan_topk_int8"] = 1 + len(tails)
            # K1 over a staged slice: not over the device bucket's rows
            slices = [a for n, r, _, a in rec.calls
                      if n == "scan_topk" and r == SPILL_SLICE
                      and a[0].data_ptr() != dev_rows.data_ptr()]
            out["slice_launches"] += len(slices)
            check(c == want and len(slices) == 3
                  and stats["staged_bytes"] == 3 * SPILL_SLICE * (
                      GTE_D * 2 + 1),
                  f"{name}: exact route launches {c}, want {want}; shapes "
                  f"{dict(rec.shapes())}; staged {stats['staged_bytes']}")
        slice_args = slices[0]
        rec.calls.clear()
        fills = [ms for ms, rows in stats["fills"] if rows == SPILL_SLICE]
        lat.sort()
        out.update(exact_p50_ms=lat[len(lat) // 2], exact_max_ms=lat[-1],
                   exact_staged_mib=3 * SPILL_SLICE * (GTE_D * 2 + 1)
                   / 2 ** 20,
                   fill_ms_per_slice=float(np.median(fills)),
                   fill_ms_max=float(max(fills)), slices_filled=len(fills))
        out["exact_launch_ms"] = dict(zip(
            ["device_bucket", "slice1", "slice2", "slice3"] + tail_names,
            spill_launch_ms(lambda: store.search_batch(
                qvs[:1], 10, exact=True), 4 + len(tails))))
        out["exact_device"] = query_device_time(
            lambda: store.search_batch(qvs[:1], 10, exact=True), 3)
        if int8:
            with plain_scans():
                plain = [store.search_batch(qv[None], 10, exact=True)
                         for qv in qvs]
            for (gs, gi), (ps, pi) in zip(answers, plain):
                check(np.array_equal(gi, pi) and np.array_equal(gs, ps),
                      f"{name}: exact hits {gi} differ from the plain "
                      f"versions' {pi}")
        # no pinned buffer is filled again before its copy has read it:
        # with every upload stalled on the stream, the next slice's or
        # stage's fill runs while the copy waits, and the answers stay
        row = planted_rows(spilled[0])[0]
        qrow = torch.from_numpy(store.rows_at(np.array([row])))
        with stalled_uploads():
            st_exact = store.search_batch(qvs[:1], 10, exact=True)
            st_row = int(store.search_batch(qrow, 10, exact=True)[1][0][0])
            st_ivf = store.search_batch(qvec, 10)
        check(np.array_equal(st_exact[0], answers[0][0])
              and np.array_equal(st_exact[1], answers[0][1])
              and st_row == row and np.array_equal(st_ivf[0], got[0])
              and np.array_equal(st_ivf[1], got[1]),
              f"{name}: with the uploads stalled the exact route answers "
              f"{st_exact[1]} (not {answers[0][1]}), row {row} comes back "
              f"as {st_row}, the probe answers {st_ivf[1]} (not {got[1]})")
        out["answers"] = answers
        out["kernels"] = {
            "slice": {**spill_kernel_case("scan_topk", slice_args,
                                          slice_args[3], False),
                      "launches": out["slice_launches"]},
            "stage": {**spill_kernel_case(pruned, stage_args[0],
                                          stage_args[0][-2], True),
                      "launches": out["stage_launches"]}}
    mgr.close()
    del store, buckets, spilled, mgr, enc
    torch.cuda.empty_cache()
    if not int8:
        # the same store with no budget, every bucket on the card: the
        # exact route's hits and scores bit for bit
        set_budget(home, 0.0)
        mgr = open_manager(device)
        check(not any(b.get("host_resident")
                      for b in mgr.vector_store.device_buckets()),
              f"{name}: a bucket spilled with no budget")
        for qv, (gs, gi) in zip(qvs, out["answers"]):
            ws, wi = mgr.vector_store.search_batch(qv[None], 10, exact=True)
            check(np.array_equal(gi, wi) and np.array_equal(gs, ws),
                  f"{name}: exact route {gi} {gs} against the store on the "
                  f"card {wi} {ws}")
        mgr.close()
        del mgr
        torch.cuda.empty_cache()
        out["query_vectors"] = qvs
    return out


def spill_oom(work: Path, qvs, answers) -> dict:
    """A real OOM: the bf16 store opened with no budget while a ballast
    tensor leaves the card less free memory than its four sealed buckets
    need (each takes its rows and, while it is permuted, a second copy).
    At least one bucket's upload must raise OutOfMemoryError and become a
    host bucket; with the ballast freed, the exact route must answer as
    before. A KernelError in a bucket build must still raise."""
    from sema_tpu_torch.index.vector_store import VectorStore
    from sema_tpu_torch.ops._cuda import KernelError
    data = work / "data-bfloat16"
    store = VectorStore(data, GTE_D, IVF_MODEL, store_dtype="bfloat16",
                        ivf=True, device=DEV)
    check(store._owner, "spill oom: the store is not its data dir's owner")
    ooms = []
    build = store._build_bucket

    def watched(seg_range, row_offset):
        try:
            return build(seg_range, row_offset)
        except torch.cuda.OutOfMemoryError:
            ooms.append(tuple(seg_range))
            raise
    store._build_bucket = watched
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(DEV)[0]
    leave = 5 * SEAL * GTE_D * 2 // 2        # 1.25 GiB: one bucket's build
    ballast = torch.empty(free - leave, dtype=torch.uint8, device=DEV)
    buckets = store.device_buckets()
    res = store.device_residency()
    del ballast
    torch.cuda.empty_cache()
    host = [b["seg_range"] for b in buckets if b.get("host_resident")]
    check(ooms and set(ooms) <= set(host) and res["host_buckets"] >= 1,
          f"spill oom: OutOfMemoryError in {ooms}, host buckets {host}, "
          f"residency {res}")
    for qv, (gs, gi) in zip(qvs, answers):
        ws, wi = store.search_batch(qv[None], 10, exact=True)
        check(np.array_equal(gi, wi) and np.array_equal(gs, ws),
              f"spill oom: exact route {wi} {ws} against {gi} {gs}")
    store.close()

    def refusing(seg_range, row_offset):
        raise KernelError("scan_topk: CUDA error 700 (an illegal memory "
                          "access was encountered)")
    other = VectorStore(data, GTE_D, IVF_MODEL, store_dtype="bfloat16",
                        ivf=True, device=DEV)
    other._build_bucket = refusing
    try:
        other.search(qvs[0], 10)
    except KernelError:
        refused = True
    else:
        refused = False
    other.close()
    check(refused, "spill oom: a KernelError in a bucket build did not "
          "raise out of search")
    return {"oom_buckets": [list(r) for r in ooms], "host_buckets": len(host),
            "residency": res, "kernel_error_raised": refused}


def phase_spill_path(work: Path, tree: Path, gen, weights, paths: dict,
                     device: str = "cuda") -> dict:
    smi = smi_line()
    os.environ.pop("SEMA_TPU_HBM_BUDGET_MB", None)
    rate = pinned_rate()
    stores = {}
    for store_dtype in ("int8", "bfloat16"):
        recall = paths.get(store_dtype, {}).get("recall_at_10_mean")
        stores[store_dtype] = spill_store(work, tree, store_dtype, gen,
                                          weights, device, recall)
    bf = stores["bfloat16"]
    oom = spill_oom(work, bf.pop("query_vectors"), bf["answers"])
    for s in stores.values():
        s.pop("answers")
        s["exact_bound_ms"] = s["exact_staged_mib"] * 2 ** 20 / rate * 1e3
        s["upload_ms_per_slice"] = SPILL_SLICE * GTE_D * 2 / rate * 1e3
    emit("spill_path", nvidia_smi=smi, budget_mb=SPILL_BUDGET_MB,
         pinned_h2d_gb_s=rate / 1e9,
         **{s: {k: v for k, v in r.items() if k not in ("kernels",
                                                          "launches")}
            for s, r in stores.items()}, oom=oom)
    return stores


# -- shard (the store's rows over a mesh's index axis, shards on the card) ---

SHARDS = 4                     # shards of the (1, 4) and (2, 1, 2) meshes
SHARD_WARM = 20                # warm queries of each store
SHARD_EXACT = 5                # exact=True queries of each IVF store
SHARD_RECALL = 100             # perturbed stored rows for recall@10
SHARD_NPROBE = 8               # nprobe a shard: 32 x 128 / 512 clusters
# queries of the block-recall check: the sharded store's recall@10 at
# SHARD_NPROBE may fall below that of a single-shard store of one shard's
# block (the same rows a cluster, the same share probed) on the same
# queries by at most 3 standard errors of their per-query differences
SHARD_BLOCK_QUERIES = 300
SHARD_TIES = [7, 1030, 2050, 3080]   # a row in each shard of 1,024


def shard_mesh(slices: int = 0):
    """(data 1, index SHARDS), or (slice, data 1, index) with ``slices``
    slices, every shard on the card."""
    from sema_tpu_torch.parallel.mesh import make_mesh
    if slices:
        return make_mesh([slices, 1, SHARDS // slices],
                         ("slice", "data", "index"), devices=[DEV] * SHARDS)
    return make_mesh([1, SHARDS], ("data", "index"), devices=[DEV] * SHARDS)


def sharded_manager(data: Path, enc, store_dtype: str, slices: int = 0,
                    **kw):
    """An ``IndexManager`` over ``data`` with ``enc`` (single-device) and
    its store's rows sharded over ``shard_mesh(slices)``."""
    from sema_tpu_torch.index import IndexManager
    return IndexManager(data, enc, store_dtype=store_dtype,
                        mesh=shard_mesh(slices),
                        slice_axis="slice" if slices else None, **kw)


def warm_queries(search, shapes: Counter = None, n: int = SHARD_WARM
                 ) -> tuple:
    """(p50 ms, launches a query) of ``n`` warm calls of ``search()``,
    after 3 warm-ups, host clock; ``shapes`` gains the scan launches of
    the ``n`` calls by (wrapper, rows of the block)."""
    for _ in range(3):
        search()
    reset_launch_counts()
    lat = []
    rec = ScanRecorder()
    with rec.recording():
        for _ in range(n):
            t0 = time.perf_counter()
            search()
            lat.append((time.perf_counter() - t0) * 1e3)
    if shapes is not None:
        shapes.update(Counter((name, rows) for name, rows, _, _ in
                              rec.calls))
    lat.sort()
    return lat[n // 2], {k: v / n for k, v in launch_counts().items() if v}


def shard_check(name: str, args) -> float:
    """A shard's launch as the store made it, against its plain version on
    the same arguments: K4a and K4b bit for bit, K1 and K3 under
    ``check_scan``. Returns the max abs error."""
    scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    got = getattr(scan_mod, name)(*args)
    want = getattr(scan_mod, f"{name}_reference")(*args)
    torch.cuda.synchronize()
    if "int8" not in name:
        return check_scan(args[0], args[1], args[2], True, got, want)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{name} on a shard differs from its plain version")
    fin = torch.isfinite(want[0])
    return float((got[0][fin] - want[0][fin]).abs().max()) if fin.any() \
        else 0.0


def shard_kernel_case(name: str, args) -> dict:
    """``shard_check``, then the launch's time, the plain version's, the
    library call's and the bound."""
    scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    fn = getattr(scan_mod, name)
    ref = getattr(scan_mod, f"{name}_reference")
    err = shard_check(name, args)
    int8, pruned = "int8" in name, "pruned" in name
    rows_t, q, valid = ((args[0], args[2], args[3]) if int8
                        else (args[0], args[1], args[2]))
    n, d = rows_t.shape
    k = args[-2] if pruned else args[-1]
    idx, n_live = None, 0
    if pruned:
        tiles, n_live, tile = args[-4], args[-3], args[-1]
        idx = (torch.as_tensor(tiles[:n_live], device=DEV)[:, None] * tile
               + torch.arange(tile, device=DEV)).reshape(-1)
        n = n_live * tile
    if int8:
        lib, _ = int8_library(args[0], args[1], valid, q, k, idx)
        bnd = bound(n * (d + 5) + d * 4 + k * 8 + 4 * n_live,
                    2.0 * n * d, INT8_OPS_PER_S)
    else:
        rows_s = rows_t if idx is None else rows_t.index_select(0, idx)
        lib = lambda: torch.topk(q.to(rows_t.dtype) @ rows_s.T, k)
        bnd = bound(n * (2 * d + 1) + d * 4 + k * 8 + 4 * n_live,
                    2.0 * n * d)
    return {"max_abs_err": err, "ms": device_ms(lambda: fn(*args), 50),
            "plain_ms": device_ms(lambda: ref(*args), 20),
            "library_ms": None if lib is None else device_ms(lib, 20),
            "bound_ms": bnd[0], "bound_by": bnd[1], "rows": n, "k": k}


def shard_calls(fn) -> dict:
    """Each distinct (wrapper, rows of its block) of the scan calls that
    ``fn()`` makes through the store, every call held against its plain
    version; the first call of each shape timed (``shard_kernel_case``),
    with the count of its calls."""
    rec = ScanRecorder()
    with rec.recording():
        fn()
    out = {}
    for name, rows, _, args in rec.calls:
        key = f"{name}:{rows}"
        if key in out:
            shard_check(name, args)
            out[key]["calls"] += 1
        else:
            out[key] = {**shard_kernel_case(name, args), "calls": 1}
    return out


def shard_synthetic(work: Path, gen) -> dict:
    """Small stores on the meshes, first (a fault of the merge fails here
    in seconds): 4,096 bf16 rows at d = 384, row 7 copied into one row of
    every other shard, on (1, 4) and (2, 1, 2): row 7 as the query must
    answer SHARD_TIES first, in row order. Then the same rows sealed and
    clustered per shard (IVF tiles of 128, bf16 and int8): the stored
    rows of every shard must come back first through the probe and
    through the exact scan."""
    from sema_tpu_torch.index.vector_store import VectorStore
    from sema_tpu_torch.types import Chunk
    rows = F.normalize(torch.randn(4096, D, generator=gen, device=DEV),
                       dim=1).to(BF16)
    rows[SHARD_TIES[1:]] = rows[SHARD_TIES[0]].clone()
    host = rows.cpu()
    chunks = [Chunk(f"r{i}", Path("/synthetic/ties.txt"), i + 1, i + 1, "")
              for i in range(4096)]
    probes = [0, 1500, 2999, 4095]
    out = {}
    for label, slices, ivf, dtype in (("ties", 0, False, "bfloat16"),
                                      ("ties_slices", 2, False, "bfloat16"),
                                      ("ivf_bf16", 0, True, "bfloat16"),
                                      ("ivf_int8", 2, True, "int8")):
        with tempfile.TemporaryDirectory(dir=work) as td:
            store = VectorStore(td, D, "shard-synthetic", store_dtype=dtype,
                                mesh=shard_mesh(slices), ivf=ivf,
                                slice_axis="slice" if slices else None,
                                rescore_k=16)
            if ivf:
                store.SEAL_ROWS, store.IVF_TILE = 4096, 128
                store.IVF_CLUSTER_ROWS, store.IVF_BUDGET_DIV = 128, 1
                store.ivf_nprobe = 2
            store.add_chunks(chunks, host)
            buckets = store.device_buckets()
            check(all(len(b["store"]) == SHARDS for b in buckets)
                  and (not ivf or buckets[0]["ivf"]["centroids"].shape[0]
                       == SHARDS), f"{label}: not {SHARDS} shards")
            reset_launch_counts()
            got = store.search_batch(rows[SHARD_TIES[0]][None].float(), 16)
            ids = got[1][0].tolist()
            if not ivf:
                check(ids[:4] == SHARD_TIES, f"{label}: the tie across "
                      f"shards answered {ids[:4]}, want {SHARD_TIES}")
            for p in probes:
                q = rows[p][None].float()
                top = [int(store.search_batch(q, 16, exact=exact)[1][0][0])
                       for exact in (False, True)]
                check(top == [p, p], f"{label}: row {p} answered {top}")
            out[label] = {"answer": ids[:8], "launches": {
                k: v for k, v in launch_counts().items() if v}}
            store.close()
    return out


def shard_main(work: Path, tree: Path, device: str) -> dict:
    """(a) and (b): the main path's MiniLM store opened single-shard, then
    over (1, 4) and (2, 1, 2): the same row ids in the same order for
    SHARD_WARM queries (the stored chunks' own text), scores within 1e-5,
    4 K1 launches a bucket a query, the --limit WIDE_LIMIT query's hits
    (K1 at k 1,024 on each shard; single-shard, the hierarchical route)
    equal where scores are more than 1e-5 apart, and every shard's launch
    against its plain version."""
    os.environ["SEMA_TPU_HOME"] = str(work / "home")
    os.environ["SEMA_TPU_DATA"] = str(work / "data")
    if not (work / "data" / "vector_index" / "manifest.json").exists():
        run_cli(["index", str(tree), "--device", device])
    single = open_manager(device)
    st, enc = single.vector_store, single.encoder
    picks = np.linspace(0, st.total_rows - 1, SHARD_WARM).astype(int)
    texts = [st.chunk_at(int(r)).content[:400] for r in picks]
    qvecs = [enc.encode_query_device(t)[None] for t in texts]
    want = [st.search_batch(q, 10) for q in qvecs]
    wide = single.search(QUERY, WIDE_LIMIT)
    turn = iter(range(10 ** 9))
    one = lambda m: m.search(texts[next(turn) % SHARD_WARM], 10)
    p50, per_q = warm_queries(lambda: one(single))
    runs = {"single": {"query_p50_ms": p50, "launches_per_query": per_q,
                       "query_device": query_device_time(
                           lambda: one(single), SHARD_WARM)}}
    single.close()
    launches, shapes = Counter(), Counter()
    for label, slices in (("index4", 0), ("slice2_index2", 2)):
        t0 = time.perf_counter()
        mgr = sharded_manager(work / "data", enc, "bfloat16", slices)
        sst = mgr.vector_store
        buckets = sst.device_buckets()
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        check(all(len(b["store"]) == SHARDS for b in buckets),
              f"main store {label}: buckets not in {SHARDS} shards")
        for q, (ws, wi), text in zip(qvecs, want, texts):
            gs, gi = sst.search_batch(q, 10)
            check(np.array_equal(gi, wi) and np.allclose(gs, ws, atol=1e-5,
                                                         rtol=0),
                  f"main store {label}: {text[:40]!r} answered {gi[0]} "
                  f"({gs[0]}), single-shard {wi[0]} ({ws[0]})")
        p50, per_q = warm_queries(lambda: one(mgr), shapes)
        launches.update({k: v * SHARD_WARM for k, v in per_q.items()})
        check(per_q.get("scan_topk") == SHARDS * len(buckets)
              and per_q.get("encoder_layer") == 6
              and not any(per_q.get(n) for n in SCANS[1:]),
              f"main store {label}: launches a query {per_q}")
        reset_launch_counts()
        got = mgr.search(QUERY, WIDE_LIMIT)
        wide_launches = launch_counts()
        launches.update(wide_launches)
        check(len(got) == len(wide) and close_hits(got, wide, 1e-5)
              and wide_launches["scan_topk"] == SHARDS * len(buckets),
              f"main store {label}: --limit {WIDE_LIMIT} answered "
              f"{len(got)} hits, launches {wide_launches}")
        runs[label] = {"open_s": open_s, "buckets": len(buckets),
                       "n_pad": [b["n_pad"] for b in buckets],
                       "query_p50_ms": p50, "launches_per_query": per_q,
                       "query_device": query_device_time(lambda: one(mgr),
                                                         SHARD_WARM),
                       "wide_launches": {k: v for k, v in
                                         wide_launches.items() if v}}
        if not slices:
            runs[label]["kernels"] = shard_calls(lambda: one(mgr))
        mgr.close()
    return {"runs": runs, "launches": launches, "shapes": shapes}


def shard_ivf(work: Path, tree: Path, store_dtype: str, gen, weights,
              device: str) -> dict:
    """(c), (d) and (f): the IVF path's store (1,048,576 rows + the tree),
    single-shard first (its sidecars, no budget), then over (1, 4) after
    it closed: the open re-clusters each sealed bucket per shard (the
    single-shard sidecars' key has shards 1), writes one sidecar a bucket
    and keeps the old ones; SHARD_EXACT exact=True queries answer the
    single-shard store's ids, with K1/K4a once a shard a bucket; the
    probe at the configured nprobe and at SHARD_NPROBE (each shard's
    clusters are a quarter of the bucket's), each bucket's shards through
    K3/K4b or, any shard over its budget, the exact scan; recall@10
    against exact=True; every shard's launch against its plain version."""
    store_mod = importlib.import_module("sema_tpu_torch.index.vector_store")
    home = spill_prepare(work, tree, store_dtype, gen, weights, device)
    set_budget(home, 0.0)
    data = work / f"data-{store_dtype}"
    int8 = store_dtype == "int8"
    pruned, exact_k = (("scan_topk_int8_pruned", "scan_topk_int8") if int8
                       else ("scan_topk_pruned", "scan_topk"))
    single = open_manager(device)
    st, enc = single.vector_store, single.encoder
    sealed = sum(b["ivf"] is not None for b in st.device_buckets())
    rng = np.random.default_rng(3)
    qs = st.rows_at(rng.choice(sealed * SEAL, size=SHARD_RECALL,
                               replace=False))
    qs += (QNOISE / math.sqrt(GTE_D)) * rng.standard_normal(
        qs.shape).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    want = [st.search_batch(q[None], 10, exact=True)
            for q in qs[:SHARD_EXACT]]
    search = lambda m: m.search(QUERY, 50)
    p50, per_q = warm_queries(lambda: search(single))
    runs = {"single": {"query_p50_ms": p50, "launches_per_query": per_q,
                       "nprobe": st.ivf_nprobe,
                       "query_device": query_device_time(
                           lambda: search(single), SHARD_WARM)}}
    nprobe = st.ivf_nprobe
    single.close()
    vi = data / "vector_index"
    before = set(vi.glob("ivf-*.bin"))
    kmeans = store_mod.kmeans_cluster
    clustered = []

    def counted(*a, **k):
        clustered.append(a[0].shape[0])
        return kmeans(*a, **k)
    t0 = time.perf_counter()
    with swapped("sema_tpu_torch.index.vector_store",
                 {"kmeans_cluster": counted}):
        mgr = sharded_manager(data, enc, store_dtype, rescore_k=100,
                              ivf=True, ivf_nprobe=nprobe)
        sst = mgr.vector_store
        buckets = sst.device_buckets()
        torch.cuda.synchronize()
    open_s = time.perf_counter() - t0
    written = set(vi.glob("ivf-*.bin")) - before
    check(len(clustered) == SHARDS * sealed and len(written) == sealed
          and before <= set(vi.glob("ivf-*.bin")),
          f"{store_dtype}: k-means on {clustered}, sidecars written "
          f"{len(written)}, want {SHARDS * sealed} and {sealed}")
    for b in buckets[:sealed]:
        sr = b["n_pad"] // SHARDS
        perm = b["ivf"]["perm"]
        check(b["ivf"]["centroids"].shape[0] == SHARDS and all(
            perm[s * sr:(s + 1) * sr].min() >= s * sr
            and perm[s * sr:(s + 1) * sr].max() < (s + 1) * sr
            for s in range(SHARDS)),
              f"{store_dtype}: a permutation leaves its shard's block")
    for q, (ws, wi) in zip(qs[:SHARD_EXACT], want):
        gs, gi = sst.search_batch(q[None], 10, exact=True)
        check(np.array_equal(gi, wi) and np.allclose(gs, ws, atol=1e-5,
                                                     rtol=0),
              f"{store_dtype} exact: {gi[0]} ({gs[0]}), single-shard "
              f"{wi[0]} ({ws[0]})")
    reset_launch_counts()
    sst.search_batch(qs[:1], 10, exact=True)
    exact_launches = {k: v for k, v in launch_counts().items() if v}
    check(exact_launches == {exact_k: SHARDS * len(buckets)},
          f"{store_dtype} exact launches {exact_launches}")
    launches, shapes = Counter(exact_launches), Counter()
    probes = {}
    for n in (nprobe, SHARD_NPROBE):
        sst.ivf_nprobe = n
        p50, per_q = warm_queries(lambda: search(mgr), shapes)
        launches.update({k: v * SHARD_WARM for k, v in per_q.items()})
        check(per_q.get(pruned, 0) % SHARDS == 0
              and per_q.get(pruned, 0) + per_q.get(exact_k, 0)
              == SHARDS * len(buckets),
              f"{store_dtype} nprobe {n}: launches a query {per_q}")
        recall = recall_at_10(sst, qs)
        probes[n] = {"query_p50_ms": p50, "launches_per_query": per_q,
                     "pruned_share": per_q.get(pruned, 0)
                     / (SHARDS * sealed),
                     "recall_at_10_mean": float(np.mean(recall)),
                     "recall_at_10_min": float(np.min(recall)),
                     "query_device": query_device_time(lambda: search(mgr),
                                                       SHARD_WARM)}
    check(probes[SHARD_NPROBE]["pruned_share"] > 0,
          f"{store_dtype}: no probe took the pruned scan at nprobe "
          f"{SHARD_NPROBE}")
    block = shard_block_recall(work, sst, store_dtype, pruned)
    q = torch.from_numpy(qs[:1]).to(DEV)
    kernels = shard_calls(lambda: sst.search_batch(q, 50))
    kernels.update(shard_calls(lambda: sst.search_batch(q, 50, exact=True)))
    mgr.close()
    del sst, buckets, mgr
    torch.cuda.empty_cache()
    runs["index4"] = {"open_s": open_s, "kmeans_rows": clustered[:1],
                      "kmeans_runs": len(clustered),
                      "sidecars": {"single_shard": len(before),
                                   "written": len(written)},
                      "exact_launches": exact_launches, "probes": probes,
                      "block_recall": block, "kernels": kernels}
    return {"runs": runs, "launches": launches, "shapes": shapes}


def recall_at_10(store, qs: np.ndarray) -> np.ndarray:
    """Each query's recall@10 of ``store``'s probe against exact=True."""
    out = []
    for q in qs:
        a = store.search_batch(q[None], 10)[1][0]
        e = store.search_batch(q[None], 10, exact=True)[1][0]
        out.append(len(set(a.tolist()) & set(e.tolist())) / 10)
    return np.asarray(out)


def shard_block_recall(work: Path, sst, store_dtype: str, pruned: str
                       ) -> dict:
    """Whether a low recall of the sharded probe is the probe's fault or
    the rows': a single-shard store of one shard's block (the first
    SEAL / SHARDS rows, block 0 of the first sealed bucket: its clusters
    and tile budget those of a shard) probed at SHARD_NPROBE, every query
    through K3/K4b, against exact=True, and the sharded store ``sst`` at
    SHARD_NPROBE on the same SHARD_BLOCK_QUERIES queries (perturbed rows
    of the block). Fails where the sharded recall's mean falls below the
    block's by more than 3 standard errors of the per-query differences
    (a block's recall is near all or nothing a query: its probe reaches
    the query's centre or misses it, where the sharded store's 16 blocks
    average out)."""
    from sema_tpu_torch.index.vector_store import VectorStore
    from sema_tpu_torch.types import Chunk
    n = SEAL // SHARDS
    rows = sst.rows_at(np.arange(n))
    rng = np.random.default_rng(4)
    qs = rows[rng.choice(n, SHARD_BLOCK_QUERIES, replace=False)]
    qs += (QNOISE / math.sqrt(GTE_D)) * rng.standard_normal(
        qs.shape).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    path = Path("/synthetic/block.txt")
    with tempfile.TemporaryDirectory(dir=work) as td:
        store = VectorStore(td, GTE_D, IVF_MODEL, store_dtype=store_dtype,
                            ivf=True, device=DEV, rescore_k=100,
                            ivf_nprobe=SHARD_NPROBE)
        store.SEAL_ROWS = n
        store.add_chunks([Chunk(f"{path}:{i}", path, i + 1, i + 1, "")
                          for i in range(n)], torch.from_numpy(rows))
        (b,) = store.device_buckets()
        clusters = int(b["ivf"]["centroids"].shape[0])
        reset_launch_counts()
        for q in qs:
            store.search_batch(q[None], 10)
        probed = launch_counts()[pruned]
        block = recall_at_10(store, qs)
        store.close()
        del store, b
    torch.cuda.empty_cache()
    check(clusters == sst.device_buckets()[0]["ivf"]["centroids"].shape[1]
          and probed == len(qs),
          f"{store_dtype} block store: {clusters} clusters, {probed} of "
          f"{len(qs)} queries through {pruned}")
    sst.ivf_nprobe = SHARD_NPROBE
    sharded = recall_at_10(sst, qs)
    diff = sharded - block
    limit = 3 * float(diff.std(ddof=1)) / math.sqrt(len(diff))
    out = {"rows": n, "clusters": clusters, "queries": len(qs),
           "mean_difference": float(diff.mean()), "limit": -limit,
           "block_recall_at_10_mean": float(block.mean()),
           "block_recall_at_10_min": float(block.min()),
           "sharded_recall_at_10_mean": float(sharded.mean()),
           "sharded_recall_at_10_min": float(sharded.min())}
    check(diff.mean() >= -limit,
          f"{store_dtype}: sharded recall@10 {sharded.mean():.3f} at "
          f"nprobe {SHARD_NPROBE}, a single block's {block.mean():.3f}, "
          f"below it by more than 3 standard errors ({limit:.3f})")
    return out


def phase_shard_path(work: Path, tree: Path, gen, weights,
                     device: str = "cuda") -> dict:
    smi = smi_line()
    os.environ.pop("SEMA_TPU_HBM_BUDGET_MB", None)
    t0 = time.perf_counter()
    synthetic = shard_synthetic(work, gen)
    main = shard_main(work, tree, device)
    stores = {dtype: shard_ivf(work, tree, dtype, gen, weights, device)
              for dtype in ("int8", "bfloat16")}
    launches = Counter(main["launches"])
    shapes = {"main": main["shapes"]}
    for d, s in stores.items():
        launches.update(s["launches"])
        shapes[d] = s["shapes"]
    emit("shard_path", nvidia_smi=smi, shards=SHARDS,
         seconds=time.perf_counter() - t0, synthetic=synthetic,
         main=main["runs"], **{d: s["runs"] for d, s in stores.items()})
    return {"launches": dict(launches), "shapes": shapes,
            "main": main["runs"], **{d: s["runs"] for d, s in stores.items()}}


# -- serve (the int8 deployment behind its HTTP daemon) -----------------------

SERVE_REQUESTS, SERVE_CLIENTS = 256, 32


def serve_requests(mgr) -> dict:
    """The serve sub-phase's requests and the answers they are held to:
    64 semantic queries taken from the tree's chunks (a chunk's first 12
    words), 256 requests at k 10 cycling over them, every 8th with
    ``exact=true`` and every 32nd a keyword query; for each semantic query
    the ids of ``IndexManager.search(q, 10, exact=True)`` in this process,
    from the same int8 encoder."""
    store = mgr.vector_store
    tail = store.device_buckets()[-1]
    texts = []
    for i in range(0, tail["rows"], max(1, tail["rows"] // 64))[:64]:
        words = store.chunk_at(tail["row_offset"] + i).content.split()
        texts.append(" ".join(words[:12]))
    exact_ids = {q: [c.id for c, _ in mgr.search(q, 10, exact=True)]
                 for q in dict.fromkeys(texts)}
    requests = [(("'backoff", "'retry")[i // 32 % 2], False) if i % 32 == 5
                else (texts[i % len(texts)], i % 8 == 0)
                for i in range(SERVE_REQUESTS)]
    return {"requests": requests, "exact_ids": exact_ids}


def http_get(url: str, timeout: float = 120.0):
    """(status, JSON body); an HTTP error status is returned, not
    raised."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def search_url(base: str, q: str, exact: bool = False, k: int = 10) -> str:
    import urllib.parse
    args = {"q": q, "k": k, **({"exact": 1} if exact else {})}
    return f"{base}/search?{urllib.parse.urlencode(args)}"


def phase_serve(tree: Path, plan: dict, device: str = "cuda") -> None:
    """``python -m sema_tpu_torch serve`` on the int8 deployment's data
    dir with ``--reindex-interval 2``: SERVE_REQUESTS requests from
    SERVE_CLIENTS concurrent clients, 0 errors and 0 non-200 answers,
    every ``exact=true`` answer id for id the in-process one; recall@10 of
    the IVF answers against the in-process exact ones; three files of the
    tree rewritten, found by keyword and by their text after the next
    re-index tick; then SIGTERM, an exit code of 0 and no traceback."""
    import signal
    import socket
    from concurrent.futures import ThreadPoolExecutor
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    out_path, err_path = tree.parent / "serve.out", tree.parent / "serve.err"
    t0 = time.perf_counter()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "sema_tpu_torch", "serve", str(tree),
             "--port", str(port), "--reindex-interval", "2",
             "--device", device],
            cwd=ROOT, stdout=out, stderr=err)
    try:
        while True:
            check(proc.poll() is None, "serve exited before it answered: "
                  + err_path.read_text()[-3000:])
            check(time.perf_counter() - t0 < 600, "serve: no /healthz in "
                  "600 s")
            try:
                if http_get(f"{base}/healthz", 5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        start_s = time.perf_counter() - t0

        def one(req):
            q, exact = req
            t = time.perf_counter()
            try:
                code, body = http_get(search_url(base, q, exact))
            except OSError as e:
                code, body = None, str(e)
            return q, exact, code, body, time.perf_counter() - t

        t1 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            answers = list(pool.map(one, plan["requests"]))
        wall_s = time.perf_counter() - t1
        errors = [a for a in answers if a[2] is None]
        non_200 = [a for a in answers if a[2] not in (None, 200)]
        check(not errors and not non_200, f"serve: {len(errors)} errors, "
              f"{len(non_200)} non-200: {(errors + non_200)[:3]}")
        ids = lambda body: [h["id"] for h in body["results"]]
        wrong = [q for q, exact, _, body, _ in answers
                 if exact and ids(body) != plan["exact_ids"][q]]
        check(not wrong, f"serve: {len(wrong)} exact answers differ from "
              f"the in-process ones, e.g. {wrong[:2]}")
        recall = [len(set(ids(body)) & set(plan["exact_ids"][q]))
                  / max(1, len(plan["exact_ids"][q]))
                  for q, exact, _, body, _ in answers
                  if not exact and not q.startswith("'")]
        lat = sorted(a[4] * 1e3 for a in answers)
        health = http_get(f"{base}/healthz")[1]
        residency_before = store_residency(base)

        # three files rewritten while serving: found after the next tick
        changed = sorted(tree.rglob("*.py"))[:3]
        for j, f in enumerate(changed):
            f.write_text(f"def okapi_{j}(zebra):\n    # the quagga herd {j} "
                         "crosses the river at dawn\n    return zebra\n")
        t2 = time.perf_counter()
        want = {str(f) for f in changed}
        while True:
            body = http_get(search_url(base, "'quagga"))[1]
            found = {h["file_path"]: h["content"] for h in body["results"]}
            if want <= set(found):
                break
            check(time.perf_counter() - t2 < 120, f"serve: the rewritten "
                  f"files not found by keyword after 120 s: {sorted(found)}")
            time.sleep(0.5)
        reindex_s = time.perf_counter() - t2
        for path in want:
            body = http_get(search_url(base, found[path], exact=True))[1]
            check(body["results"][0]["file_path"] == path, f"serve: the "
                  f"text of {path} finds {body['results'][0]['file_path']}")
        # the tick's rows went into the tail's spare rows: no new bucket
        residency_after = store_residency(base)
        check(residency_after["buckets"] == residency_before["buckets"]
              and residency_after.get("tail_buckets") == 1,
              f"serve: residency {residency_before} before the re-index "
              f"tick, {residency_after} after it")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err_text = err_path.read_text()
    check(rc == 0 and "stopped by signal 15" in err_text
          and "Traceback" not in err_text,
          f"serve exited {rc}: {err_text[-3000:]}")
    emit("serve", requests=len(answers), clients=SERVE_CLIENTS,
         exact_requests=sum(a[1] for a in answers),
         keyword_requests=sum(a[0].startswith("'") for a in answers),
         errors=len(errors), non_200=len(non_200), start_s=start_s,
         wall_s=wall_s, qps=len(answers) / wall_s,
         p50_ms=lat[len(lat) // 2], p99_ms=lat[int(0.99 * (len(lat) - 1))],
         max_ms=lat[-1], ivf_recall_at_10_mean=float(np.mean(recall)),
         ivf_recall_at_10_min=float(np.min(recall)),
         reindex_found_s=reindex_s, healthz=health,
         residency_before=residency_before, residency_after=residency_after,
         exit_code=rc)


def store_residency(base: str) -> dict:
    """``/healthz``'s store residency, once the store is not busy."""
    for _ in range(100):
        store = http_get(f"{base}/healthz")[1]["store"]
        if not store["busy"]:
            return store
        time.sleep(0.1)
    raise RuntimeError(f"serve: the store stayed busy: {store}")


# -- the store's in-place device append (serve-time re-index) ----------------

APPEND_ROUNDS = 12             # re-index rounds on the main path's store
APPEND_FILES = 3               # files rewritten a round
APPEND_P50_AFTER = (1, 8, 12)  # rounds after which the query p50 is taken
APPEND_STALL_MS = 300.0        # the stream held before a snapshot's scan


@contextmanager
def h2d_bytes():
    """Bytes that ``Tensor.to`` copies from the host to the card while
    open (every upload of the store goes through it), 2-d tensors (rows)
    apart from the rest (masks)."""
    stats = {"rows": 0, "other": 0}
    to = torch.Tensor.to

    def counted(self, *a, **k):
        out = to(self, *a, **k)
        if self.device.type == "cpu" and out.device.type == "cuda":
            stats["rows" if self.dim() == 2 else "other"] += (
                self.numel() * self.element_size())
        return out
    torch.Tensor.to = counted
    try:
        yield stats
    finally:
        torch.Tensor.to = to


def rewrite(files, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for f in files:
        f.write_text(module_text(rng))


def launch_delta(fn) -> tuple:
    """(fn(), the wrappers' launches during the call)."""
    before = launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def pending_rows(store) -> int:
    return len(getattr(store, "_pending_dev", {}))


def append_round(mgr, files, seed: int, name: str, fails: list,
                 prev: dict) -> tuple:
    """One re-index round: ``files`` rewritten from ``seed`` and indexed
    through ``IndexManager``, the buckets built (the append, its host to
    card bytes counted), then one query for the text of an appended
    chunk, its launches counted. The checks of the arena go to
    ``fails``: no device rows pending after the build; one unsealed tail,
    grown in place while it had room (its ``n_pad`` kept), else rebuilt
    at ``_pad_rows(2 * rows)``; no row uploaded; the appended chunk found
    first."""
    store = mgr.vector_store
    rewrite(files, seed)
    n_segs = len(store.segments)
    t0 = time.perf_counter()
    n = mgr.process_and_index_files(files)
    torch.cuda.synchronize()
    index_ms = (time.perf_counter() - t0) * 1e3
    stashed, new_segs = pending_rows(store), len(store.segments) - n_segs
    with h2d_bytes() as up:
        t0 = time.perf_counter()
        buckets = store.device_buckets()
        torch.cuda.synchronize()
        append_ms = (time.perf_counter() - t0) * 1e3
    tail = buckets[-1]
    added = store.total_rows - prev["total"]
    where = f"{name} round {seed}"
    if stashed != new_segs or not new_segs:
        fails.append(f"{where}: {stashed} segments of device rows stashed "
                     f"by the index, want {new_segs}")
    if pending_rows(store):
        fails.append(f"{where}: {pending_rows(store)} device rows still "
                     "pending after the build")
    unsealed = [b for b in buckets if not b["sealed"]]
    if len(unsealed) != 1 or unsealed[0] is not tail:
        fails.append(f"{where}: {len(unsealed)} unsealed buckets "
                     f"{[(b['rows'], b['n_pad']) for b in unsealed]}")
    if prev["rows"] + added <= prev["n_pad"]:
        if not (len(buckets) == prev["buckets"]
                and tail["row_offset"] == prev["row_offset"]
                and tail["n_pad"] == prev["n_pad"]
                and tail["rows"] == prev["rows"] + added):
            fails.append(f"{where}: {added} rows did not land in the tail's "
                         f"room ({prev['rows']} of {prev['n_pad']}): "
                         f"{len(buckets)} buckets, tail {tail['rows']} of "
                         f"{tail['n_pad']}")
    elif tail["n_pad"] != store._pad_rows(2 * tail["rows"]):
        fails.append(f"{where}: a rebuilt tail of {tail['rows']} rows holds "
                     f"{tail['n_pad']}, want {store._pad_rows(2 * tail['rows'])}")
    if up["rows"]:
        fails.append(f"{where}: {up['rows']} bytes of rows uploaded")
    text = store.chunk_at(store.total_rows - 1).content
    hits, launches = launch_delta(lambda: mgr.search(text, 10))
    if not hits or str(hits[0][0].file_path) not in {str(f) for f in files}:
        fails.append(f"{where}: an appended chunk's text finds "
                     f"{hits[0][0].file_path if hits else None}")
    return {"round": seed, "chunks": n, "index_ms": index_ms,
            "append_ms": append_ms, "rows_uploaded_mib": up["rows"] / 2 ** 20,
            "masks_uploaded_mib": up["other"] / 2 ** 20,
            "segments": new_segs, "buckets": len(buckets),
            "tail_rows": tail["rows"], "tail_n_pad": tail["n_pad"],
            "query_launches": launches}, tail_state(buckets, store)


def tail_state(buckets, store) -> dict:
    """What the next round's checks compare with: the store's rows, the
    bucket count and the tail's rows, capacity and offset."""
    tail = buckets[-1]
    return {"total": store.total_rows, "buckets": len(buckets),
            "rows": tail["rows"], "n_pad": tail["n_pad"],
            "row_offset": tail["row_offset"]}


def query_p50(mgr, n: int = 20) -> float:
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        mgr.search(QUERY, 10)
        lat.append((time.perf_counter() - t0) * 1e3)
    return sorted(lat)[n // 2]


def rebuilt_equal(store, tail: dict) -> dict:
    """The tail's live rows and mask against the same rows built from the
    segment files by a second store opened on the directory: bf16 rows,
    int8 values and scales, bit for bit."""
    from sema_tpu_torch.index.vector_store import VectorStore
    ref = VectorStore(store.dir.parent, store.dim, store.model,
                      store_dtype=store.store_dtype, device=store.device,
                      ivf=store.ivf)
    rb = ref._build_bucket(tail["seg_range"], tail["row_offset"])
    n = tail["rows"]
    parts = (tail["store"] if isinstance(tail["store"], tuple)
             else (tail["store"],))
    want = rb["store"] if isinstance(rb["store"], tuple) else (rb["store"],)
    return {"rows": n, "store": all(torch.equal(a[:n], b[:n])
                                    for a, b in zip(parts, want)),
            "valid": torch.equal(tail["valid"][:n], rb["valid"][:n])}


def append_snapshot(mgr, f: Path, seed: int, stall_ms: float, name: str,
                    fails: list) -> dict:
    """A search in flight across an append returns its snapshot's answer:
    the rows of a rewritten file encoded first, then the search launched
    (behind ``stall_ms`` of sleep on the stream when given), the rows
    appended and the buckets built, and only then the search finished.
    The query is the first new row, which tops any search once appended,
    so the answer must be the one from before the append. With the stall,
    the append must also be queued without waiting for the stream."""
    import inspect
    from sema_tpu_torch.ingest.chunker import process_files
    store, enc = mgr.vector_store, mgr.encoder
    rewrite([f], seed)
    chunks = process_files([f])
    kw = ({"return_device": True} if "return_device" in inspect.signature(
        enc.encode_texts).parameters else {})
    emb = enc.encode_texts([c.content for c in chunks],
                           out_dtype=store.torch_dtype, **kw)
    host = emb.host if kw else emb
    q = host[:1].float().to(store.device)
    before = store.search_batch(q, 10)
    cycles = stall_cycles(stall_ms) if stall_ms else 0
    torch.cuda.synchronize()
    first = store.total_rows
    if cycles:
        torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    handle = store.search_batch_async(q, 10)
    store.add_chunks(chunks, emb)
    store.device_buckets()
    queued_ms = (time.perf_counter() - t0) * 1e3
    got = store.search_batch_finish(handle, q)
    finish_ms = (time.perf_counter() - t0) * 1e3
    after = store.search_batch(q, 10)
    where = f"{name} snapshot (stall {stall_ms:g} ms)"
    if not (np.array_equal(got[1], before[1])
            and np.array_equal(got[0], before[0])):
        fails.append(f"{where}: the search in flight answers {got[1][0]}, "
                     f"before the append {before[1][0]}")
    if after[1][0][0] != first:
        fails.append(f"{where}: row {first} is not first after the append: "
                     f"{after[1][0]}")
    if cycles and not (queued_ms < stall_ms / 2 <= finish_ms):
        fails.append(f"{where}: the append waited for the stream (queued "
                     f"in {queued_ms:.1f} ms, finished in {finish_ms:.1f})")
    if pending_rows(store):
        fails.append(f"{where}: device rows still pending")
    return {"stall_ms": stall_ms, "chunks": len(chunks),
            "queued_ms": queued_ms, "finish_ms": finish_ms}


def append_main(work: Path, tree: Path, device: str, files: list,
                fails: list, driven: Counter) -> dict:
    """The main path's store (MiniLM-L6, bf16, the tree's chunks), through
    ``IndexManager``: APPEND_ROUNDS rounds, a tombstone between an
    append and its build, two snapshots, the tail against the rows
    rebuilt from disk, and the hits against the plain scan."""
    from sema_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference
    os.environ["SEMA_TPU_HOME"] = str(work / "home")
    os.environ["SEMA_TPU_DATA"] = str(work / "data")
    if not (work / "data" / "vector_index" / "manifest.json").exists():
        run_cli(["index", str(tree), "--device", device])
    mgr = open_manager(device)
    store = mgr.vector_store
    name = "main store"
    reset_launch_counts()
    mgr.search(QUERY, 10)                      # the device copy goes live
    buckets = store.device_buckets()
    first = buckets[-1]
    if first["n_pad"] != store._pad_rows(2 * first["rows"]):
        fails.append(f"{name}: the first tail of {first['rows']} rows holds "
                     f"{first['n_pad']}, want "
                     f"{store._pad_rows(2 * first['rows'])}")
    prev = tail_state(buckets, store)
    rounds, p50 = [], {}
    for r in range(1, APPEND_ROUNDS + 1):
        if r == APPEND_ROUNDS:
            # the last round's chunks in slices of 10: several segments,
            # each with its device rows, in one append
            os.environ["SEMA_TPU_INDEX_BATCH"] = "10"
        rec, prev = append_round(mgr, files[(r - 1) * APPEND_FILES:
                                            r * APPEND_FILES], r, name,
                                 fails, prev)
        os.environ.pop("SEMA_TPU_INDEX_BATCH", None)
        k1 = rec["query_launches"]["scan_topk"]
        if k1 != 1:
            fails.append(f"{name} round {r}: {k1} K1 launches a query")
        rounds.append(rec)
        if r in APPEND_P50_AFTER:
            p50[str(r)] = query_p50(mgr)
    extra = files[APPEND_ROUNDS * APPEND_FILES:]

    # a tombstone between the append and the build
    f = extra[0]
    rewrite([f], 100)
    mgr.process_and_index_files([f])
    seg = store.segments[-1]
    lo = store.total_rows - seg.rows
    store.remove_file_chunks(f)
    tail = store.device_buckets()[-1]
    dead_live = int(tail["valid"][lo - tail["row_offset"]:].sum())
    hits = mgr.search(store.chunk_at(lo).content, 10)
    tomb = {"rows": seg.rows, "valid_after": dead_live,
            "hits_from_file": sum(str(c.file_path) == str(f)
                                  for c, _ in hits)}
    if dead_live or tomb["hits_from_file"]:
        fails.append(f"{name}: a tombstone between the append and the build "
                     f"was not honoured: {tomb}")
    snaps = [append_snapshot(mgr, extra[1], 101, 0.0, name, fails),
             append_snapshot(mgr, extra[2], 102, APPEND_STALL_MS, name,
                             fails)]
    driven.update(launch_counts())

    buckets = store.device_buckets()
    tail = buckets[-1]
    residency = store.device_residency()
    equal = rebuilt_equal(store, tail)
    if not (equal["store"] and equal["valid"]):
        fails.append(f"{name}: the tail's live rows differ from the rows "
                     f"rebuilt from disk: {equal}")
    qvec = mgr.encoder.encode_query_device(QUERY)[None, :]
    masked = not tail["all_valid"]
    k = min(64, tail["rows"])
    scan_err = check_scan(tail["store"], qvec, tail["valid"], masked,
                          scan_topk(tail["store"], qvec, tail["valid"], k,
                                    masked),
                          scan_topk_reference(tail["store"], qvec,
                                              tail["valid"], k, masked))
    got = store.search_batch(qvec, 50)
    with plain_scans():
        plain = store.search_batch(qvec, 50)
    if not np.array_equal(got[1], plain[1]):
        fails.append(f"{name}: the hits differ from the plain scan's")
    mgr.close()
    return {"rounds": rounds, "query_p50_ms": p50,
            "tail_rows": tail["rows"], "tail_n_pad": tail["n_pad"],
            "buckets": len(buckets), "residency": residency,
            "tombstone": tomb, "snapshots": snaps, "rebuilt_equal": equal,
            "scan_max_abs_err": scan_err}


def append_int8(work: Path, tree: Path, gen, weights, device: str,
                files: list, seed: int, budget_mb: float, name: str,
                fails: list, driven: Counter) -> dict:
    """One append into the int8 IVF store of ``int8_ivf_path`` (gte-large
    W8A8), reopened with ``hbm_budget_mb = budget_mb``: 0, every bucket
    on the card; SPILL_BUDGET_MB, three sealed buckets spilled, which
    must stay as they were. Then the tail against the rows rebuilt from
    disk (int8 values and scales) and the hits against the plain
    versions'."""
    from sema_tpu_torch.models.registry import get_spec
    home = spill_prepare(work, tree, "int8", gen, weights, device)
    set_budget(home, budget_mb)
    mgr = open_manager(device)
    store = mgr.vector_store
    reset_launch_counts()
    mgr.search(QUERY, 10)
    before = store.device_buckets()
    spilled = [b for b in before if b.get("host_resident")]
    rec, _ = append_round(mgr, files, seed, name, fails,
                          tail_state(before, store))
    driven.update(launch_counts())
    after = store.device_buckets()
    tail = after[-1]
    sealed = sum(1 for b in after if b["sealed"])
    got_l = rec["query_launches"]
    if (got_l["scan_topk_int8"] != 1 or got_l["scan_topk"]
            or got_l["encoder_layer_int8"] != get_spec(IVF_MODEL).num_layers):
        fails.append(f"{name}: query launches {got_l}")
    if tail.get("host_resident"):
        fails.append(f"{name}: the tail is not on the card")
    still = [b for b in after if b.get("host_resident")]
    if len(still) != len(spilled) or any(a is not b
                                         for a, b in zip(spilled, still)):
        fails.append(f"{name}: the spilled buckets changed")
    equal = rebuilt_equal(store, tail)
    if not (equal["store"] and equal["valid"]):
        fails.append(f"{name}: the tail's int8 rows or scales differ from "
                     f"those rebuilt from disk: {equal}")
    qvec = mgr.encoder.encode_query_device(QUERY)[None, :]
    got = store.search_batch(qvec, 10)
    with plain_scans():
        plain = store.search_batch(qvec, 10)
    if not (np.array_equal(got[1], plain[1])
            and np.array_equal(got[0], plain[0])):
        fails.append(f"{name}: the hits differ from the plain versions'")
    residency = store.device_residency()
    mgr.close()
    return {"round": rec, "sealed_buckets": sealed, "spilled_buckets": len(spilled),
            "residency": residency, "rebuilt_equal": equal}


def phase_append_path(work: Path, tree: Path, gen, weights,
                      device: str = "cuda") -> dict:
    """The store's in-place device append, driven through
    ``IndexManager`` as ``serve --reindex-interval`` drives it: rows
    encoded on the card, stashed by ``add_chunks`` and written into the
    spare rows of the unsealed tail (``append_main``, then one append
    into the int8 IVF store with every bucket on the card and one with
    three sealed buckets spilled, ``append_int8``). Every round's numbers
    are emitted before the checks fail the phase, so the phase also runs
    on a revision without the arena (step 0) and says what it misses
    there."""
    smi = smi_line()
    files = sorted(tree.rglob("*.py"))[3:]     # serve rewrites the first 3
    n = APPEND_ROUNDS * APPEND_FILES
    fails, driven = [], Counter()
    main = append_main(work, tree, device, files[:n + 3], fails, driven)
    int8 = append_int8(work, tree, gen, weights, device,
                       files[n + 3:n + 6], 200, 0, "int8 store", fails,
                       driven)
    spill = append_int8(work, tree, gen, weights, device,
                        files[n + 6:n + 9], 201, SPILL_BUDGET_MB,
                        "spilled int8 store", fails, driven)
    emit("append_path", nvidia_smi=smi, **main, int8=int8, spill=spill,
         launches=dict(driven), failed=fails)
    check(not fails, "append_path: " + "; ".join(fails[:6]))
    return {"launches": dict(driven)}


# -- the tensor-parallel encoder (K6, K7) -------------------------------------

TP_SAMPLE = 256                # chunks held against the single-device encoder
TP4_LAYERS = 4                 # depth of the tp = 4 embeddings check
TP_COS_MIN = 0.999             # TP against single-device, per row: see below


def close_hits(got, want, tol) -> bool:
    """``got`` and ``want`` ((chunk, score) lists) name the same chunks at
    every rank, or where they differ the two scores are within ``tol`` of
    each other: two query vectors ``tol`` / 2 apart give the same unit row
    scores ``tol`` / 2 apart, so such near-ties may swap places."""
    return len(got) == len(want) and all(
        a.id == b.id or abs(sa - sb) <= tol
        for (a, sa), (b, sb) in zip(got, want))


def tp_run(work: Path, tree: Path, weights, quant: str, mesh,
           model: str = IVF_MODEL) -> dict:
    """``model`` (bf16, ``quant``) on the tensor-parallel ``Encoder`` over
    ``mesh`` behind an ``IndexManager`` with an exact bf16 store: the
    tree indexed, then 3 warm-up and 20 warm queries. Launches: K6 for
    every shard of every layer of every index batch of the 256 bucket with
    float linears, K7 for the others and for every int8 layer; one query
    K6 (K7 with int8) once per shard and layer and K1 once; K2, K5 and
    every plain version never. The stored rows of TP_SAMPLE chunks are
    held against the single-device encoder (K2 or K5) on the card at
    per-row cosine >= TP_COS_MIN: the TP layer rounds as the JAX package's
    does (f32 partials summed over the shards, then the bias, then bf16
    before the residual add), K2 and K5 as their kernels do, so the two
    differ by design by a few bf16 ulps a layer. The query vector and hits
    of the same path through the plain versions (``plain_attention``) on
    the card must agree with the kernels' (``close_hits``)."""
    from sema_tpu_torch import cli
    from sema_tpu_torch.config import Config, ModelConfig
    from sema_tpu_torch.crawl import FileCrawler
    from sema_tpu_torch.index import IndexManager
    from sema_tpu_torch.models.encoder import Encoder
    from sema_tpu_torch.utils.metrics import Metrics
    cfg = ModelConfig(name=model, max_length=256, batch_size=256,
                      dtype="bfloat16", quant=quant,
                      weights_path=str(weights or ""))
    t0 = time.perf_counter()
    enc = Encoder.from_config(cfg, mesh=mesh, data_axis="data",
                              model_axis="model")
    load_s = time.perf_counter() - t0
    metrics = Metrics()
    mgr = IndexManager(work / f"data-tp-{quant}", enc,
                       store_dtype="bfloat16", metrics=metrics)
    files = FileCrawler(cli.crawler_config(Config())).crawl_directory(tree)
    layers, tp = enc.spec.num_layers, mesh.shape["model"]
    err = io.StringIO()
    with counted_plain_calls() as plain, redirect_stderr(err):
        reset_launch_counts()
        t0 = time.perf_counter()
        n_chunks = mgr.process_and_index_files(files)
        index_s = time.perf_counter() - t0
        index_launches = launch_counts()
        index_stages_s = metrics.report()["stages_s"]
        reset_launch_counts()
        mgr.search(QUERY, 50)
        one_query = launch_counts()
        for _ in range(3):
            mgr.search(QUERY, 50)
        metrics.stage_samples.clear()
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            mgr.search(QUERY, 50)
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        stages_p50_ms = {k: v * 1e3
                         for k, v in metrics.report()["p50_s"].items()}
        busy = query_device_time(lambda: mgr.search(QUERY, 50), 20)
    check("Failed to index" not in err.getvalue()
          and "falling back" not in err.getvalue(),
          f"tp_path {quant}: {err.getvalue()[-2000:]}")
    check(not sum(plain.values()), f"tp_path {quant}: plain versions "
          f"called {dict(plain)}")
    store = mgr.vector_store
    texts = [store.chunk_at(i).content for i in range(n_chunks)]
    counts, batches = bucket_batches(enc, texts)
    k6 = (sum(n for s, n in batches.items() if s >= 192)
          if quant == "none" else 0)
    want = dict.fromkeys(index_launches, 0)
    want.update(attention_block=k6 * layers * tp,
                attention_qkv=(sum(batches.values()) - k6) * layers * tp)
    check(n_chunks > 0 and index_launches == want,
          f"tp_path {quant} index: {n_chunks} chunks, batches "
          f"{dict(batches)}, launches {index_launches}, want {want}")
    # every (B, S) at which this run launched K6 or K7 (a full batch of
    # each bucket, and the query) is one that phase_attention holds
    kind = lambda s: "block" if quant == "none" and s >= 192 else "qkv"
    ran = {(kind(s), enc.batch_size * max(1, enc.max_length // s), s)
           for s in batches} | {(kind(enc.max_length), 1, enc.max_length)}
    held = ({*K67_PATH} | {("block", b, s) for b, s in K6_BS}
            | {("qkv", b, s) for b, s in K7_BS})
    check(ran <= held, f"tp_path {quant}: K6/K7 ran at {sorted(ran - held)}"
          f", which phase_attention does not hold (K67_PATH)")
    want = dict.fromkeys(one_query, 0)
    want.update({"attention_block" if quant == "none" else "attention_qkv":
                 layers * tp, "scan_topk": 1})
    check(one_query == want, f"tp_path {quant} query launches {one_query}, "
          f"want {want}")

    # the same path through the plain versions on the card
    qvec = enc.encode_query_device(QUERY)
    hits = mgr.search(QUERY, 50)
    with plain_attention():
        qvec_p = enc.encode_query_device(QUERY)
        hits_p = mgr.search(QUERY, 50)
    q_cos = float(F.cosine_similarity(qvec, qvec_p, dim=0))
    q_err = float((qvec - qvec_p).norm())
    check(q_cos >= 0.9999 and close_hits(hits, hits_p, 2 * q_err),
          f"tp_path {quant}: the kernels' query (cosine {q_cos} to the "
          f"plain versions') finds {[c.id for c, _ in hits[:10]]}, the "
          f"plain versions {[c.id for c, _ in hits_p[:10]]}")

    # stored rows against the single-device encoder on the card
    sample = list(range(0, n_chunks, max(1, n_chunks // TP_SAMPLE)))
    sample = sample[:TP_SAMPLE]
    bucket = store.device_buckets()
    check(len(bucket) == 1, f"tp_path: {len(bucket)} device buckets")
    rows = bucket[0]["store"][sample].float()
    single = Encoder.from_config(cfg, device=DEV)
    ref = single.encode_texts([texts[i] for i in sample]).to(rows.device)
    cos = F.cosine_similarity(rows, ref, dim=1)
    check(float(cos.min()) >= TP_COS_MIN, f"tp_path {quant}: TP rows "
          f"against the single-device encoder: cosine {float(cos.min())}")
    mgr.close()
    del single, mgr, store, bucket, enc
    torch.cuda.empty_cache()
    return {"quant": quant, "tp": tp, "chunks": n_chunks, "load_s": load_s,
            "index_s": index_s, "chunks_per_s": n_chunks / index_s,
            "index_stages_s": index_stages_s,
            "bucket_rows": {str(s): n for s, n in sorted(counts.items())},
            "bucket_batches": {str(s): n for s, n in sorted(batches.items())},
            "index_launches": index_launches, "query_launches": one_query,
            "query_p50_ms": lat[len(lat) // 2], "query_max_ms": lat[-1],
            "query_stages_p50_ms": stages_p50_ms, "query_device": busy,
            "query_cosine_to_plain": q_cos,
            "hits_equal_plain": [c.id for c, _ in hits]
            == [c.id for c, _ in hits_p],
            "hit_ranks_differing": [i for i, ((a, _), (b, _)) in enumerate(
                zip(hits, hits_p)) if a.id != b.id],
            "hit_score_tolerance": 2 * q_err,
            "single_device_min_cosine": float(cos.min()),
            "single_device_mean_cosine": float(cos.mean())}


def tp_embeddings(weights, texts, shape, layers=None,
                  model: str = IVF_MODEL) -> dict:
    """``model`` (cut to ``layers`` layers if given), bf16, on a (data,
    model) mesh of ``shape`` whose shards all lie on the card: the
    embeddings of ``texts`` against the single-device encoder (K2) there,
    per-row cosine >= TP_COS_MIN, with K6 and K7 launching and K2 not."""
    import dataclasses
    from sema_tpu_torch.models.encoder import Encoder
    from sema_tpu_torch.models.loader import load_params
    from sema_tpu_torch.models.registry import get_spec
    from sema_tpu_torch.parallel.mesh import make_mesh
    from sema_tpu_torch.tokenizer import HashTokenizer
    spec = get_spec(model)
    params, _ = load_params(spec, str(weights or ""))
    spec = dataclasses.replace(
        spec, num_layers=min(layers or spec.num_layers, spec.num_layers))
    params["layers"] = {k: v[:spec.num_layers]
                        for k, v in params["layers"].items()}
    tok = HashTokenizer(spec.vocab_size)
    mesh = make_mesh(shape, ("data", "model"),
                     devices=[DEV] * math.prod(shape))
    enc = Encoder(spec, params, tok, max_length=256, batch_size=256,
                  mesh=mesh, data_axis="data", model_axis="model")
    reset_launch_counts()
    t0 = time.perf_counter()
    got = enc.encode_texts(texts)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    single = Encoder(spec, params, tok, max_length=256, batch_size=256,
                     device=DEV)
    cos = F.cosine_similarity(got, single.encode_texts(texts), dim=1)
    check(launches["attention_block"] > 0 and launches["attention_qkv"] > 0
          and not launches["encoder_layer"]
          and float(cos.min()) >= TP_COS_MIN,
          f"mesh {mesh.shape}: launches {launches}, cosine "
          f"{float(cos.min())}")
    return {"mesh": mesh.shape, "layers": spec.num_layers,
            "chunks": len(texts),
            "encode_s": seconds, "launches": launches,
            "min_cosine": float(cos.min()), "mean_cosine": float(cos.mean())}


def tree_heads(tree: Path) -> list:
    """Heads of TP_SAMPLE of the tree's files, 40 to 1,570 characters:
    every sequence bucket."""
    return [f.read_text()[:40 + 6 * i] for i, f in enumerate(
        sorted(tree.rglob("*.py"))[:TP_SAMPLE])]


# the tp_path's widest row-parallel product: gte-large's FFN-out at tp 2
# over a full index batch of the 256 bucket, (65,536, 2,048) @ (2,048, 1,024)
LINEAR_SHAPE = (256 * 256, 2048, 1024)


def linear_sums(gen) -> dict:
    """``bert._linear`` at LINEAR_SHAPE in bf16 against the f32 product of
    the same operands: its sums must be f32 (relative error, norm-wise,
    <= 1e-5; sums in another order read about 1e-7, a GEMM that rounded
    or reduced in bf16 about 2^-9). Times it against that f32 product."""
    from sema_tpu_torch.models.bert import _linear
    m, k, n = LINEAR_SHAPE
    x = torch.randn(1, m, k, generator=gen, device=DEV).to(BF16)
    w = (torch.randn(k, n, generator=gen, device=DEV) / math.sqrt(k)).to(BF16)
    layer = {"ffn_out_w": w}
    got = _linear(x, layer, "ffn_out_w", F32)
    f32_product = lambda: torch.matmul(x.float(), w.float())
    want = f32_product()
    rel = float((got - want).norm() / want.norm())
    out = {"shape": list(LINEAR_SHAPE), "rel_err": rel,
           "ms": device_ms(lambda: _linear(x, layer, "ffn_out_w", F32), 5),
           "f32_product_ms": device_ms(f32_product, 5),
           "bound_ms": bound((m * k + k * n) * 2 + m * n * 4,
                             2.0 * m * k * n)[0]}
    check(got.dtype == F32 and rel <= 1e-5,
          f"tp_path: _linear's sums are not f32: {out}")
    return out


def phase_tp_path(work: Path, tree: Path, weights, gen,
                  model: str = IVF_MODEL):
    """The slice end to end: ``_linear``'s f32 sums (``linear_sums``),
    then gte-large at full width and depth over a (data 1, model 2) mesh
    of two shards on the card, float linears (K6 and K7) then W8A8 (K7
    and ``qmm``), through ``tp_run``; then four shards on the card at
    TP4_LAYERS layers (``tp_embeddings``)."""
    from sema_tpu_torch.parallel.mesh import make_mesh
    linear = linear_sums(gen)
    mesh = make_mesh([1, 2], ("data", "model"), devices=[DEV] * 2)
    runs = [tp_run(work, tree, weights, quant, mesh, model)
            for quant in ("none", "int8")]
    tp4 = tp_embeddings(weights, tree_heads(tree), [1, 4], TP4_LAYERS, model)
    emit("tp_path", model=model, mesh={"data": 1, "model": 2},
         linear=linear, runs=runs, tp4=tp4)
    return runs


# -- the TUI and doctor -------------------------------------------------------

TUI_AGAIN = "parse the socket token stream"   # the session's later query
TUI_KEYWORD = "'backoff"       # the session's keyword query
TUI_WAIT_S = 300.0             # the most any step of the session may take
ESC = b"\x1b"
DOWN = b"\x1bOB"               # SS3: curses keypad mode, as tui_monkey sends

# The TUI in a fresh process: exec'd, never forked from this one (CUDA
# cannot be used in the forked child of a process that initialised it).
# argv[1] is a JSON-lines log, argv[2] WRAPPERS as JSON; the rest is the
# CLI's argv. The app's startup, searches and opened previews each note
# their wall time, the launches they made and what they showed. pygments
# is blocked, so that a preview takes the plain-text fallback of
# render._lexer_for (tui_monkey's TUI highlights where it is installed).
TUI_RUNNER = r"""
import time
t0 = time.perf_counter()
import importlib.util, json, sys
pygments = importlib.util.find_spec("pygments") is not None
sys.modules["pygments"] = None
from sema_tpu_torch import cli, ops
from sema_tpu_torch.tui import render
from sema_tpu_torch.tui.app import TuiApp
log = open(sys.argv[1], "a", buffering=1)
wrappers = {name: getattr(ops, attr)
            for name, attr in json.loads(sys.argv[2]).items()}

def counts():
    return {name: fn.launches for name, fn in wrappers.items()}

def note(event, before, t, **fields):
    after = counts()
    log.write(json.dumps({
        "event": event, "ms": (time.perf_counter() - t) * 1e3,
        "launches": {n: after[n] - before[n] for n in after},
        **fields}) + "\n")

run_indexing, execute_search, open_file = (
    TuiApp.run_indexing, TuiApp.execute_search, TuiApp.open_file)

def indexed(self, stdscr):
    before, t = counts(), time.perf_counter()
    run_indexing(self, stdscr)
    note("ready", before, t, ready_s=time.perf_counter() - t0,
         error=self.index_error,
         live_rows=self.engine.index_manager.vector_store.live_rows)

def searched(self, query):
    before, t = counts(), time.perf_counter()
    execute_search(self, query)
    note("search", before, t, query=query, error=self.engine.search_error,
         results=[[str(r.chunk.file_path), r.chunk.start_line,
                   r.chunk.end_line, r.total_matches_in_file, r.score]
                  for r in self.engine.search_results])

def opened(self):
    before, t = counts(), time.perf_counter()
    open_file(self)
    self.draw(self.stdscr)
    path = self.engine.current_file_path
    note("open", before, t, path=str(path), mode=self.engine.ui_mode.name,
         pygments_installed=pygments,
         lexer=repr(render._LEXER_CACHE.get(path.suffix.lower())))

run = TuiApp.run
def run_keeping_screen(self, stdscr):
    self.stdscr = stdscr
    return run(self, stdscr)

TuiApp.run_indexing, TuiApp.execute_search, TuiApp.open_file = (
    indexed, searched, opened)
TuiApp.run = run_keeping_screen
rc = cli.main(sys.argv[3:])
log.write(json.dumps({"event": "exit", "rc": rc}) + "\n")
sys.exit(rc)
"""


def tui_env(home: Path) -> dict:
    """The environment of a TUI process: its own config and data dirs, a
    terminal of 120 x 40, a short ESCDELAY so that a lone Esc is a key."""
    return dict(os.environ, SEMA_TPU_HOME=str(home),
                SEMA_TPU_DATA=str(home / "data"), TERM="xterm-256color",
                COLUMNS="120", LINES="40", ESCDELAY="25",
                PYTHONPATH=str(ROOT))


class TuiSession:
    """``python3 -c TUI_RUNNER`` under a pty: the events it logs, keys sent
    to it, its output drained so that it never blocks on the terminal."""

    def __init__(self, log: Path, env: dict, argv):
        import pty
        self.log, self.out, self.status = log, b"", None
        self.pid, self.fd = pty.fork()
        if self.pid == 0:
            try:
                os.chdir(ROOT)
                os.execvpe(sys.executable, [sys.executable, "-c", TUI_RUNNER,
                                            str(log), json.dumps(WRAPPERS),
                                            *argv], env)
            finally:
                os._exit(127)

    def events(self) -> list:
        return ([json.loads(line) for line in self.log.read_text()
                 .splitlines()] if self.log.exists() else [])

    def pump(self, seconds: float) -> None:
        import select
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            if select.select([self.fd], [], [], 0.05)[0]:
                try:
                    self.out += os.read(self.fd, 65536)
                except OSError:
                    pass
            if self.status is None:
                done, status = os.waitpid(self.pid, os.WNOHANG)
                if done:
                    self.status = status

    def wait_for(self, kind: str, n: int, seconds: float = TUI_WAIT_S):
        """The ``n``-th event of ``kind``, once logged; raises on a timeout
        or when the app has exited without it."""
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            got = [e for e in self.events() if e["event"] == kind]
            if len(got) >= n:
                return got[n - 1]
            check(self.status is None, f"the TUI exited before {kind} {n}: "
                  f"{self.out[-1500:].decode(errors='replace')}")
            self.pump(0.1)
        raise RuntimeError(f"no {kind} {n} from the TUI in {seconds} s")

    def send(self, keys: bytes, settle: float = 0.3) -> None:
        os.write(self.fd, keys)
        self.pump(settle)

    def close(self, seconds: float = 60.0) -> int:
        """The exit code, once the app has quit (killed past ``seconds``)."""
        end = time.monotonic() + seconds
        while self.status is None and time.monotonic() < end:
            self.pump(0.1)
        if self.status is None:
            os.kill(self.pid, 9)
            os.waitpid(self.pid, 0)
        os.close(self.fd)
        check(self.status is not None, f"the TUI did not quit in {seconds} s")
        return os.waitstatus_to_exitcode(self.status)


def grouped_search(query: str, device: str) -> list:
    """``Engine``'s grouping of an in-process ``IndexManager.search`` of
    ``query`` on the data dir of ``SEMA_TPU_HOME``/``SEMA_TPU_DATA``, as the
    TUI shows it."""
    from sema_tpu_torch import cli
    from sema_tpu_torch.search.engine import Engine
    from sema_tpu_torch.types import AppState
    args = cli.parse_args(["--device", device])
    config = cli.load_config(args)
    mgr = cli.make_index_manager(config, device)
    try:
        engine = Engine(index_manager=mgr, state=AppState.READY)
        engine.execute_search(query, limit=config.index.result_limit)
        check(engine.search_error is None, engine.search_error)
        return [[str(r.chunk.file_path), r.chunk.start_line,
                 r.chunk.end_line, r.total_matches_in_file, r.score]
                for r in engine.search_results]
    finally:
        mgr.close()


def run_monkey(tree: Path, env: dict) -> dict:
    """The port's ``tools/tui_monkey.py`` over ``tree``: it must print OK.
    The app's exit status, which it prints, is reported and not held: it
    quits on Ctrl-C, and where the pty also raises SIGINT for it in raw
    mode (a sandboxed pty may), the app's KeyboardInterrupt races its quit
    (status 2 = SIGINT)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sema_tpu_torch.tools.tui_monkey", str(tree)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=400)
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    check(proc.returncode == 0 and line.startswith("OK"),
          f"tui_monkey exited {proc.returncode}: {line} "
          f"{proc.stderr[-1500:]}")
    return {"line": line, "seconds": time.perf_counter() - t0}


def phase_tui_path(work: Path, tree: Path, device: str = "cuda",
                   monkey: bool = True) -> list:
    """The bare ``python -m sema_tpu_torch TREE`` (the TUI, MiniLM-L6 at
    full width, random weights from seed 0) over the main path's tree, in
    fresh config and data dirs, under a pty: READY (the startup index and
    warm-up), two semantic queries, the keyword query TUI_KEYWORD, Down,
    Enter (a file's preview, in plain text), Esc, q. Then the first
    semantic results against ``grouped_search`` and, with ``monkey``,
    ``tools/tui_monkey.py`` over the warm index. Returns the launch counts
    of the startup and the three searches."""
    home = work / "tui-home"
    env = tui_env(home)
    extra = [] if device == "cuda" else ["--device", device]
    t0 = time.perf_counter()
    session = TuiSession(work / "tui-events.jsonl", env, [str(tree), *extra])
    try:
        ready = session.wait_for("ready", 1)
        ready_wall_s = time.perf_counter() - t0
        searches = []
        for n, query in enumerate((QUERY, TUI_AGAIN, TUI_KEYWORD), 1):
            if n > 1:       # back to the input, and clear it
                session.send(ESC, 0.5)
                session.send(b"\x7f" * (len(QUERY) + 8))
            session.send(query.encode() + b"\r")
            searches.append(session.wait_for("search", n))
        semantic, again, keyword = searches
        session.send(DOWN)
        session.send(b"\r")
        opened = session.wait_for("open", 1)
        session.send(ESC, 0.5)
        session.send(b"q")
    finally:
        code = session.close()
    exit_event = session.wait_for("exit", 1, 5.0)
    check(code == 0 and exit_event["rc"] == 0,
          f"the TUI exited {code} (rc {exit_event['rc']}): "
          f"{session.out[-1500:].decode(errors='replace')}")
    check(ready["error"] is None and ready["live_rows"] > 0, ready)
    check(ready["launches"]["encoder_layer"] > 0,
          f"startup launches {ready['launches']}")
    for search in (semantic, again):
        sl = search["launches"]
        check(search["error"] is None and search["results"], search)
        check(sl["encoder_layer"] > 0 and sl["scan_topk"] > 0
              and not any(sl[n] for n in SCANS[1:]),
              f"semantic search launches {sl}")
    check(keyword["error"] is None and keyword["results"]
          and not any(keyword["launches"].values()), keyword)
    check(opened["mode"] == "FILE_PREVIEW"
          and opened["path"] == keyword["results"][1][0]
          and opened["lexer"] == "None", opened)
    os.environ["SEMA_TPU_HOME"] = env["SEMA_TPU_HOME"]
    os.environ["SEMA_TPU_DATA"] = env["SEMA_TPU_DATA"]
    want = grouped_search(QUERY, device)
    check([r[:4] for r in semantic["results"]] == [r[:4] for r in want],
          "the TUI's semantic results differ from the in-process search's")
    score_diff = max(abs(a[4] - b[4])
                     for a, b in zip(semantic["results"], want))
    monkey_run = run_monkey(tree, env) if monkey else None
    emit("tui_path", files=len(list(tree.rglob("*.py"))),
         chunks=ready["live_rows"], ready_s=ready["ready_s"],
         ready_wall_s=ready_wall_s, startup_ms=ready["ms"],
         semantic_ms=[semantic["ms"], again["ms"]], keyword_ms=keyword["ms"],
         open_ms=opened["ms"], groups=len(semantic["results"]),
         score_max_diff=score_diff,
         pygments_installed=opened["pygments_installed"],
         lexer=opened["lexer"], startup_launches=ready["launches"],
         semantic_launches=semantic["launches"], monkey=monkey_run,
         exit_code=code)
    return [ready["launches"]] + [s["launches"] for s in searches]


# (model, dtype, quant, store dtype) of the doctor's three cases, and the
# wrappers each must launch: the scans of the self-test, and K2 or K5
DOCTOR_CASES = (("minilm-l6", "bfloat16", "none", "bfloat16"),
                (IVF_MODEL, "bfloat16", "none", "bfloat16"),
                (IVF_MODEL, "bfloat16", "int8", "int8"))
DOCTOR_SCANS = ("scan_topk", "scan_topk_int8", "scan_topk_pruned")
CHECK_LINE = re.compile(r"^device (\S+)\s*: (ok|FAIL|n/a) — (.*?)"
                        r"(?: \[([\d.]+) s\])?$")


def run_doctor(home: Path, model: str, dtype: str, quant: str,
               store_dtype: str, weights, argv) -> dict:
    """``cli.main(["doctor", *argv])`` in-process with a config of its own
    in ``home``: exit code, seconds, its lines, each check's verdict,
    seconds and detail, and the launches it made."""
    from sema_tpu_torch import cli
    from sema_tpu_torch.config import ConfigManager
    manager = ConfigManager(home)
    config = manager.load_config()
    m = config.model
    m.name, m.dtype, m.quant = model, dtype, quant
    m.weights_path = "" if weights is None else str(weights)
    config.index.store_dtype = store_dtype
    manager.save_config(config)
    os.environ["SEMA_TPU_HOME"] = str(home)
    os.environ["SEMA_TPU_DATA"] = str(home / "data")
    out = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        rc = cli.main(["doctor", *argv])
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    checks = {}
    for line in lines:
        hit = CHECK_LINE.match(line)
        if hit:
            name, verdict, detail, s = hit.groups()
            checks[name] = {"verdict": verdict, "detail": detail,
                            "seconds": None if s is None else float(s)}
    parity = checks.get("encoder-parity", {}).get("detail", "")
    cos = re.search(r"min cosine ([\d.]+)", parity)
    return {"model": model, "quant": quant, "store_dtype": store_dtype,
            "rc": rc, "seconds": seconds, "lines": lines, "checks": checks,
            "min_cosine": float(cos.group(1)) if cos else None,
            "launches": launch_counts()}


def phase_doctor_path(work: Path, weights, extra=(), cases=DOCTOR_CASES):
    """``doctor --skip-quality`` in-process for each of ``cases`` (gte-large
    from ``weights``): exit 0 with each of the seven checks ok and the
    unported one n/a, and the self-test's scans (K1, K4a, K3) and the
    encoder's kernel (K2, or K5 for W8A8) launched; then one full
    ``doctor`` on random MiniLM weights, which must skip the quality gate
    and exit 1. Returns the launch counts of every run."""
    runs, report = [], []
    for i, (model, dtype, quant, store_dtype) in enumerate(cases):
        got = run_doctor(work / f"doctor-{i}", model, dtype, quant,
                         store_dtype, weights if model == IVF_MODEL else None,
                         ["--skip-quality", *extra])
        runs.append(got["launches"])
        report.append({k: v for k, v in got.items() if k != "lines"})
        text = "\n".join(got["lines"])
        check(got["rc"] == 0, f"doctor {model} {quant} exited {got['rc']}:"
              f"\n{text}")
        verdicts = {name: c["verdict"] for name, c in got["checks"].items()}
        check(verdicts == {"scan-ids": "ok", "scan-int8": "ok",
                           "scan-mesh": "ok", "scan-spill": "ok",
                           "scan-ivf": "ok", "scan-spill-ivf": "ok",
                           "encoder-parity": "ok", "scan-ids-pallas": "n/a"},
              f"doctor {model} {quant}: {verdicts}\n{text}")
        layer = "encoder_layer_int8" if quant == "int8" else "encoder_layer"
        other = ("encoder_layer" if quant == "int8"
                 else "encoder_layer_int8")
        launched = got["launches"]
        check(all(launched[n] > 0 for n in DOCTOR_SCANS + (layer,))
              and launched[other] == 0,
              f"doctor {model} {quant} launches {launched}")
    full = run_doctor(work / "doctor-full", *cases[0], None, list(extra))
    runs.append(full["launches"])
    skipped = [line for line in full["lines"]
               if line.startswith("quality gate     : SKIPPED")]
    check(full["rc"] == 1 and skipped,
          f"full doctor exited {full['rc']}: {full['lines'][-3:]}")
    emit("doctor_path", cases=report,
         full={"rc": full["rc"], "seconds": full["seconds"],
               "quality": skipped[0]})
    return runs


# -- tools_path: the port's measuring tools ------------------------------------

# (tool, arguments, the kernels its run must launch); text_index_scale,
# host only, runs beside encoder_ablate (whose times are the profiler's)
TOOLS = (
    ("load_test", ["--rows", "262144", "--dim", "384", "--clients", "256",
                   "--max-batch", "256", "--duration", "8", "--warmup", "3",
                   "--mutate"], ("scan_topk",)),
    ("load_test", ["--ivf", "--store-dtype", "int8", "--dim", "1024",
                   "--rows", "262144", "--clients", "64", "--duration", "5"],
     ("scan_topk_int8_pruned",)),
    ("spill_ivf_bench", [], ("scan_topk", "scan_topk_pruned")),
    ("spill_ivf_bench", ["--store-dtype", "int8"],
     ("scan_topk", "scan_topk_int8_pruned")),
    ("query_breakdown", ["--rows", "262144"], ("scan_topk", "encoder_layer")),
    ("ivf_bench", ["--rows", "1048576", "--dim", "384"],
     ("scan_topk", "scan_topk_pruned")),
    ("serving_sweep", ["--rows", "262144", "--clients", "8", "32", "128",
                       "--duration", "4", "--warmup", "2"], ("scan_topk",)),
    ("index_build_bench", ["--chunks", "20000"], ("encoder_layer",)),
    ("index_build_bench", ["--model", "gte-large", "--quant", "int8",
                           "--chunks", "2048"], ("encoder_layer_int8",)),
    ("encoder_ablate", ["--model", "minilm-l6", "--batch", "256", "--seq",
                        "256"], ("encoder_layer",)),
)
TEXT_SCALE_ARGS = ["--docs", "200000"]


def tool_command(module: str, argv) -> list:
    return [sys.executable, "-m", f"sema_tpu_torch.tools.{module}", *argv]


def tool_result(module: str, argv, proc, out: str, err: str,
                t0: float) -> dict:
    """A finished tool run: its exit code, seconds, last line (None when
    it printed no JSON) and the end of what it printed."""
    try:
        last = json.loads(out.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        last = None
    return {"tool": module, "argv": list(argv), "rc": proc.returncode,
            "seconds": time.perf_counter() - t0, "last": last,
            "printed": (out + err)[-1500:]}


def tool_checks(module: str, argv, last: dict) -> list:
    """The table's checks of one tool's last line: what failed."""
    bad = []

    def need(ok, what):
        if not ok:
            bad.append(f"{module} {' '.join(argv)}: {what}")
    if module == "load_test":
        need(last["errors"] == 0 and last["mismatches"] == 0
             and last["mutated_batches"] >= (1 if "--mutate" in argv else 0),
             "errors, mismatches or no mutation")
    elif module == "spill_ivf_bench":
        need(last["spilled_buckets"] >= 1, "nothing spilled")
        need(last["probe_upload_mb"] < last["streamed_upload_mb"],
             "the probe staged no less than the stream")
        need(0.0 <= last["recall_at_k"] <= 1.0, "recall out of [0, 1]")
    elif module == "query_breakdown":
        need(all(last[s] > 0 for s in (
            "tokenize_ms", "rtt_ms", "embed_device_ms", "scan_device_ms",
            "embed_e2e_ms", "search_e2e_ms")), "a stage is not positive")
    elif module == "ivf_bench":
        rungs = [r for r in last["rungs"].values() if "recall_at_k" in r]
        need(last["exact_recall_at_k"] == 1.0, "exact recall below 1")
        need(len(rungs) >= 2 and rungs[-1]["recall_at_k"]
             >= rungs[0]["recall_at_k"], "recall fell with nprobe")
        need(last["plain_check"]["ok"]
             and last["plain_check"]["queries"] == 8,
             f"K3 against its plain version: {last['plain_check']}")
    elif module == "serving_sweep":
        need(all(r["errors"] == 0 and r["mismatches"] == 0
                 for r in last["rungs"]), "a rung with errors")
    elif module == "index_build_bench":
        need(last["chunks"] == last["tree_chunks"] > 0,
             "chunks are not the tree's")
    elif module == "encoder_ablate":
        c = last["checks"]
        need(c["prod_bit_equal"], "prod is not K2 bit for bit")
        for name in ("no_exp", "no_softmax"):
            need(c[name]["differs_from_prod"] and c[name]["min_cos"]
                 >= 0.9999, f"{name} against prod and its plain version: "
                 f"{c[name]}")
    return bad


def phase_tools_path(work: Path, smi: str, tools=TOOLS,
                     text_args=TEXT_SCALE_ARGS) -> dict:
    """Each of the port's tools as ``python -m sema_tpu_torch.tools.<name>``
    in a fresh process on the card (TMPDIR in ``work``), its last line
    printed as it comes and checked (``tool_checks``): exit 0, ``device``
    the card's nvidia-smi line, and the kernels it must reach among its
    ``launches``; ``text_index_scale`` on the host beside
    ``encoder_ablate``, with no launch (its ``rss_*`` keys, ``ru_maxrss``,
    are this process's peak, which a child inherits at fork and keeps
    across exec: its own RSS shows only when it runs by hand). Every run
    is printed before a failed check fails the phase. Returns the
    launches summed over the tools."""
    tmp = work / "tools-tmp"
    tmp.mkdir(exist_ok=True)
    env = {**os.environ, "TMPDIR": str(tmp)}
    t_phase = time.perf_counter()
    failed, launches = [], Counter()
    for module, argv, kernels in tools:
        side = None
        if module == "encoder_ablate":
            side = (time.perf_counter(), subprocess.Popen(
                tool_command("text_index_scale", text_args), cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        t0 = time.perf_counter()
        proc = subprocess.run(tool_command(module, argv), cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        runs = [tool_result(module, argv, proc, proc.stdout, proc.stderr,
                            t0)]
        if side is not None:
            t_side, sp = side
            out, err = sp.communicate(timeout=600)
            runs.append(tool_result("text_index_scale", text_args, sp, out,
                                    err, t_side))
        for r, must in zip(runs, (kernels, ())):
            last = r["last"]
            emit("tools_path", **{k: v for k, v in r.items()
                                  if k != "printed" or last is None
                                  or r["rc"] != 0})
            what = f"{r['tool']} {' '.join(r['argv'])}"
            if r["rc"] != 0 or last is None:
                failed.append(f"{what}: exit {r['rc']}")
                continue
            launched = last["launches"]
            launches.update(launched)
            if must:
                if last["device"] != smi:
                    failed.append(f"{what}: device {last['device']!r}")
                if not all(launched.get(k, 0) > 0 for k in must):
                    failed.append(f"{what}: launches {launched}, want "
                                  f"{must}")
                failed += tool_checks(r["tool"], r["argv"], last)
            elif launched:
                failed.append(f"{what}: host only, launched {launched}")
    seconds = time.perf_counter() - t_phase
    emit("tools_path", seconds=seconds, launches=dict(launches),
         failed=failed)
    check(not failed, f"tools_path: {failed}")
    return dict(launches)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: all)")
    ap.add_argument("--parent-source", type=Path, default=None,
                    help="another revision's tree (e.g. `git archive REV | "
                         "tar -x -C build/parent`): run the layer_bits and "
                         "scan_bits phases against its kernels")
    ap.add_argument("--tools", default=None,
                    help="comma-separated tools that tools_path runs "
                         "(default: all of TOOLS)")
    cli_args = ap.parse_args()
    phases = (None if cli_args.phases is None
              else set(cli_args.phases.split(",")))
    run = lambda name: phases is None or name in phases
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    from sema_tpu_torch.ops import _cuda       # fails without the repo
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    if run("tools_path"):
        # encoder_ablate's three builds of encoder_layer.cu, beside the
        # product's: the tool then finds them built
        from concurrent.futures import ThreadPoolExecutor
        from sema_tpu_torch.tools.encoder_ablate import build_variants
        with ThreadPoolExecutor(1) as ex:
            ablate = ex.submit(build_variants)
            seconds = _cuda.build()
            seconds["encoder_ablate"] = ablate.result()
    else:
        seconds = _cuda.build()
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0)

    gen = torch.Generator(device=DEV).manual_seed(0)
    if run("scan_topk"):
        phase_scan(gen)
    if run("encoder_layer"):
        layer_cases = phase_layer(gen)
    if run("encoder_layer_int8"):
        int8_cases = phase_layer_int8(gen)
    if run("attention"):
        attention_cases = phase_attention(gen)
    if run("scan_int8") or run("scan_pruned"):
        phase_scan_more(gen)
    if run("scan_ab"):
        scan_ab = phase_scan_ab(gen)
    if cli_args.parent_source is not None:
        root = cli_args.parent_source.resolve()
        parent = parent_libraries(root, [
            name for name, phase in (("encoder_layer", "layer_bits"),
                                     ("scan_topk", "scan_bits"))
            if run(phase)])
        if run("layer_bits"):
            phase_layer_bits(gen, parent["encoder_layer"])
        if run("scan_bits"):
            phase_scan_bits(gen, root, parent["scan_topk"])
    (ROOT / "build").mkdir(exist_ok=True)
    paths = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        work = Path(work)
        if run("main_path"):
            index_launches, query_launches, k1 = phase_main_path(work, 400)
        tree = work / "tree"
        if not tree.exists():
            make_tree(tree, 400)
        if run("tui_path"):     # before append_path rewrites the tree
            tui_runs = phase_tui_path(work, tree)
        weights = None
        if any(run(name) for name in (
                "int8_ivf_path", "bf16_ivf_path", "spill_path",
                "shard_path", "append_path", "tp_path", "doctor_path")):
            t0 = time.perf_counter()
            weights = write_weights(work / "gte-weights")
            emit("weights", model=IVF_MODEL,
                 seconds=time.perf_counter() - t0)
        for store_dtype in ("int8", "bfloat16"):
            name = ("int8_ivf_path" if store_dtype == "int8"
                    else "bf16_ivf_path")
            if run(name):
                paths[store_dtype] = phase_ivf_path(work, tree, store_dtype,
                                                    4 * SEAL, gen, weights)
        if run("spill_path"):
            spill = phase_spill_path(work, tree, gen, weights, paths)
        if run("shard_path"):   # before append_path rewrites the tree
            shard = phase_shard_path(work, tree, gen, weights)
        if run("append_path"):
            append = phase_append_path(work, tree, gen, weights)
        if run("tp_path"):
            tp_runs = phase_tp_path(work, tree, weights, gen)
        if run("doctor_path"):
            doctor_runs = phase_doctor_path(work, weights)
        if run("tools_path"):
            chosen = (cli_args.tools or "").split(",")
            tools_launches = phase_tools_path(work, smi, [
                t for t in TOOLS if cli_args.tools is None or t[0] in chosen])
    if phases is not None:
        print(f"partial run of {sorted(phases)}: no kernels line", flush=True)
        return 0

    k2 = next(c for c in layer_cases
              if (c["model"], c["dtype"], c["b"], c["s"])
              == ("minilm-l6", "bfloat16", 256, 256))
    k5 = next(c for c in int8_cases
              if (c["model"], c["dtype"], c["b"], c["s"])
              == (IVF_MODEL, "bfloat16", 1, 256))
    int8_k, bf16_k = paths["int8"]["kernels"], paths["bfloat16"]["kernels"]
    runs = [index_launches, query_launches, scan_ab["launches"]] + [
        p[key] for p in [*paths.values(), *tp_runs]
        for key in ("index_launches", "query_launches")] + [
        dict(s["launches"]) for s in spill.values()] + [append["launches"]] \
        + tui_runs + doctor_runs + [shard["launches"], tools_launches]
    launches = {name: sum(r.get(name, 0) for r in runs) for name in runs[0]}
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")

    def entry(name, source, replaces, shape, f):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "shape": shape, **{key: f[key] for key in fields}}
    scan_src = "sema_tpu_torch/csrc/scan_topk.cu"
    kernels = [
        entry("scan_topk", scan_src, "sema_tpu/ops/pallas_topk.py:280",
              [k1["n"], 1, k1["k"]], k1),
        entry("encoder_layer", "sema_tpu_torch/csrc/encoder_layer.cu",
              "sema_tpu/ops/fused_attention.py:356", [256, 256, D], k2),
        entry("encoder_layer_int8", "sema_tpu_torch/csrc/encoder_layer.cu",
              "sema_tpu/ops/fused_attention.py:493", [1, 256, GTE_D], k5),
        entry("scan_topk_pruned", scan_src, "sema_tpu/ops/pallas_topk.py:544",
              [bf16_k["scan_topk_pruned"]["rows_scanned"], 1, 64],
              bf16_k["scan_topk_pruned"]),
        entry("scan_topk_int8", scan_src, "sema_tpu/ops/pallas_topk.py:368",
              [int8_k["scan_topk_int8"]["rows_scanned"], 1, 128],
              int8_k["scan_topk_int8"]),
        entry("scan_topk_int8_pruned", scan_src,
              "sema_tpu/ops/pallas_topk.py:580",
              [int8_k["scan_topk_int8_pruned"]["rows_scanned"], 1, 128],
              int8_k["scan_topk_int8_pruned"]),
    ]
    k6, k7 = (next(c for c in attention_cases
                   if (c["kernel"], c["model"], c["tp"], c["dtype"], c["b"],
                       c["s"]) == (kernel, IVF_MODEL, 2, "bfloat16", b, s))
              for kernel, b, s in (("K6", 1, 256), ("K7", 256, 32)))
    kernels += [
        entry("attention_block", "sema_tpu_torch/csrc/encoder_layer.cu",
              "sema_tpu/ops/fused_attention.py:216", [1, 256, GTE_D, 512],
              k6),
        entry("attention_qkv", "sema_tpu_torch/csrc/encoder_layer.cu",
              "sema_tpu/ops/fused_attention.py:134", [256, 32, 3 * 512], k7),
        entry("scan_topk_warm", scan_src, "sema_tpu/ops/pallas_topk.py:280",
              [AB_N, 256, 10], scan_ab["K8"]),
        entry("fold_topk", scan_src, "tools/scan_ab14.py:164",
              [AB_N, 256, 10], scan_ab["K9"])]
    # the spill path's new launch shapes: K1 over a streamed slice, K3 and
    # K4b over a staged probe at tiles of 128 rows, each with its launches
    # at that shape
    for dtype, case, name, replaces in (
            ("bfloat16", "slice", "scan_topk", "pallas_topk.py:280"),
            ("int8", "slice", "scan_topk", "pallas_topk.py:280"),
            ("bfloat16", "stage", "scan_topk_pruned", "pallas_topk.py:544"),
            ("int8", "stage", "scan_topk_int8_pruned",
             "pallas_topk.py:580")):
        f = spill[dtype]["kernels"][case]
        kernels.append({**entry(name, scan_src, f"sema_tpu/ops/{replaces}",
                                [f["rows"], 1, f["k"]], f),
                        "name": f"{name}:spill_{case}_{dtype}",
                        "launches": f["launches"]})
    # the shard path's launch shapes: each wrapper on one shard's block of
    # a store row-sharded over (1, 4), with its launches at that shape in
    # the phase's warm queries
    replaces = {"scan_topk": "pallas_topk.py:280",
                "scan_topk_int8": "pallas_topk.py:368",
                "scan_topk_pruned": "pallas_topk.py:544",
                "scan_topk_int8_pruned": "pallas_topk.py:580"}
    for store_name, key in (("main", "main"), ("int8", "int8"),
                            ("bf16", "bfloat16")):
        for case, f in shard[key]["index4"]["kernels"].items():
            name, rows = case.split(":")
            kernels.append({**entry(name, scan_src,
                                    f"sema_tpu/ops/{replaces[name]}",
                                    [f["rows"], 1, f["k"]], f),
                            "name": f"{name}:shard_{store_name}_{rows}",
                            "launches": shard["shapes"][key][
                                (name, int(rows))]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
