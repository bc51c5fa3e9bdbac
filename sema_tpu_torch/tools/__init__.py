"""The scan A/B harnesses of ``tools/`` on the port: ``scan_ab15`` (the
warm-start scan, K8, against the cold one, K1) and ``scan_ab14`` (the
fold-merge scan, K9, against K1), run as ``python -m
sema_tpu_torch.tools.scan_ab15``. Each makes the JAX tool's data from the
same numpy seed, runs on ``cuda`` unless given ``--device cpu`` (the plain
versions), checks the ids first and exits non-zero when they differ."""

from __future__ import annotations

import time

import torch


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


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu": every printed time names where it ran."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
