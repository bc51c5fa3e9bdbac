"""The root ``tools/`` of the JAX package on the port, each run as
``python -m sema_tpu_torch.tools.<name>`` on ``cuda`` unless given
``--device cpu`` (the plain versions), each ending on one JSON line with
the JAX tool's keys plus ``device`` (the card's name and power limit as
``nvidia-smi`` gives them, or "cpu") and ``launches`` (the kernels'
wrapper calls during the run, by kernel); each exits non-zero when its
correctness field fails.

- ``scan_ab15`` (the warm-start scan, K8, against the cold one, K1) and
  ``scan_ab14`` (the fold-merge scan, K9, against K1).
- ``load_test``: client threads through one ``QueryBatcher`` over a
  synthetic store with planted probe winners, optionally while a mutator
  streams appends and tombstones into it (K1, K4a or K3/K4b).
- ``serving_sweep``: closed-loop client rungs over one store and batcher,
  with the batcher's per-stage stats after each rung.
- ``spill_ivf_bench``: the spilled-IVF union probe (K3/K4b over the
  staging buffer) against the streamed exact scan (K1 over each slice).
- ``query_breakdown``: one query's stages (tokenize, round trip, device
  embed and scan, end to end) and the host residual.
- ``ivf_bench``: k-means build, K1's single-query latency and the
  ``--nprobe`` sweep through K3, with recall@k.
- ``index_build_bench``: ``IndexManager.process_and_index_files`` over a
  generated tree (K2, or K5 with ``--quant int8``).
- ``text_index_scale``: the disk text index at millions of chunks (host
  only; a headed copy).
- ``encoder_ablate``: the encoder (K2) with its softmax's exponentials,
  then the whole softmax, taken out of the attention kernel, to attribute
  device time (two builds of ``csrc/encoder_layer.cu`` with
  ``-DSEMA_ABLATE``, loaded by this tool only).
- ``tui_monkey`` (a headed copy of ``tools/tui_monkey.py``) drives
  ``python -m sema_tpu_torch tui DIR`` through a pty with random keys,
  then a keyword search and a quit, and prints ``OK`` when the app
  survived.

Device times: a wrapper call costs the host more (0.06-0.3 ms) than one
query's kernels take on the card, so CUDA events around back-to-back
calls measure the host's issue rate. A tool that reports a device time
gives both: the event ms a call (:func:`device_ms`) and the kernels' own
time that torch.profiler sums over the same calls
(:func:`query_device_time`).
"""

from __future__ import annotations

import functools
import subprocess
import time
from collections import Counter

import torch

# every kernel's wrapper: its name in a tool's ``launches`` (and in
# chip_smoke.py's kernels line) → its name in sema_tpu_torch.ops
WRAPPERS = {"scan_topk": "scan_topk", "scan_topk_int8": "scan_topk_int8",
            "scan_topk_pruned": "scan_topk_pruned",
            "scan_topk_int8_pruned": "scan_topk_int8_pruned",
            "scan_topk_warm": "scan_topk_warm", "fold_topk": "fold_topk",
            "encoder_layer": "fused_encoder_layer",
            "encoder_layer_int8": "fused_encoder_layer_int8",
            "attention_block": "fused_attention_block",
            "attention_qkv": "fused_attention_qkv"}


def launch_counts() -> dict:
    """Every wrapper's ``.launches``, by kernel name."""
    from sema_tpu_torch import ops
    return {name: getattr(ops, attr).launches
            for name, attr in WRAPPERS.items()}


def launches_since(before: dict) -> dict:
    """The kernels launched since ``before`` (:func:`launch_counts`), with
    their counts; a kernel not launched is left out."""
    now = launch_counts()
    return {name: now[name] - before[name] for name in now
            if now[name] != before[name]}


def measure(fn_one, xs: torch.Tensor, n_calls: int, repeats: int = 3) -> float:
    """Milliseconds a call of ``fn_one``: the best of ``repeats`` blocks of
    ``n_calls`` calls over the query sets ``xs`` in turn, after one
    warm-up call. On a card, device time between CUDA events around the
    block, then a synchronize; on the CPU, host time."""
    fn_one(xs[0])
    cuda = xs.device.type == "cuda"
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for i in range(n_calls):
            fn_one(xs[i % xs.shape[0]])
        if cuda:
            end.record()
            torch.cuda.synchronize(xs.device)
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / n_calls)
    return best


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def short_name(key: str) -> str:
    """A kernel's name as the profiler reports it, without its return
    type, anonymous namespace and argument list: ``gemm_kernel<0, 2,
    16>``. Two instantiations of one template keep their template
    arguments apart."""
    name = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()
    return name.strip()


def query_device_time(search, n: int) -> dict:
    """Device time of ``n`` calls of ``search()`` under torch.profiler:
    busy ms per call, the busy share of the wall time, and the kernels
    that take the most of it (device ms per call, summed by
    ``short_name``). Raises if the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            search()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not events:
        raise RuntimeError("the profiler saw no device activity")
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    by_name = Counter()
    for e in events:
        by_name[short_name(e.key)] += e.self_device_time_total / 1e3 / n
    return {"busy_ms": busy_ms / n, "busy_share": busy_ms / wall_ms,
            "top_ms": dict(by_name.most_common(10))}


def call_ms(fn, n: int, device: torch.device) -> dict:
    """``fn()``'s time a call over ``n`` calls: on a card ``event_ms``
    (:func:`device_ms`) and ``kernel_ms`` (:func:`query_device_time`'s
    busy ms), on the CPU host ms for both."""
    if device.type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / n
        return {"event_ms": ms, "kernel_ms": ms}
    return {"event_ms": device_ms(fn, n),
            "kernel_ms": query_device_time(fn, n)["busy_ms"]}


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu": every printed time names where it ran."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


@functools.lru_cache(maxsize=None)
def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit`` gives them (its name alone where nvidia-smi does not
    answer), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
        return lines[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return device_name(device)
