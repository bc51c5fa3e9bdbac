"""Int8 quantization and the full-precision rescore (from ``sema_tpu/ops/quant.py``).

The int8 store (BASELINE config 4, "int8 quantized scan + bf16 rescore of
top-100") holds symmetric per-row int8 values and f32 scales on the
device; the scan (K4a/K4b of ``ops/scan_topk.py``) scores int8 x int8 in
i32; the top ``rescore_k`` candidates are re-scored at full precision from
the bf16 originals on disk and re-ranked.

Scoring math: score ~= (q_i8 . r_i8) * (s_q * s_r) where s_* = max|x|/127.

:func:`quantize_rows` and :func:`rescore_exact` are the JAX package's numpy
functions, unchanged. :func:`quantize_query` is its device function in
torch: ``torch.round`` rounds half to even, as ``jnp.round`` does.
:func:`int8_topk_scores` is its XLA scan, the store's route for a k above
the scan kernels' limit, on the exact sums of :func:`int8_dot`. None of
this is a kernel: the JAX package runs it outside Pallas too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sema_tpu_torch.ops.hier_topk import hier_topk_scores
from sema_tpu_torch.ops.topk import stable_topk


def quantize_rows(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8: returns (values int8 (N,d), scales f32 (N,))."""
    x = np.asarray(x, dtype=np.float32)
    scales = np.max(np.abs(x), axis=1) / 127.0
    safe = np.where(scales > 0, scales, 1.0)
    q = np.clip(np.rint(x / safe[:, None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32)


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division on any device, as numpy and JAX
    divide: PyTorch's CUDA division by a Python scalar multiplies by the
    scalar's reciprocal instead, which can land one ulp off."""
    return t / torch.full_like(t, 127.0)


def quantize_query(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of (Q, d) f32 rows, on their device:
    (int8 (Q, d), f32 scales (Q,)). A zero row has scale 0 and values 0."""
    scale = div127(q.abs().amax(dim=1))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    qi = torch.round(q / safe[:, None]).clamp_(-127, 127).to(torch.int8)
    return qi, scale


def int8_dot(qi: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Exact (Q, N) i32 sums of int8 products, as f32 (rounded once, as
    the kernel converts them). f32 products sum exactly while every
    partial sum stays below 2^24, that is for d * 127^2 < 2^24; wider rows
    sum in f64."""
    d = qi.shape[1]
    dt = torch.float32 if d * 127 * 127 < 2 ** 24 else torch.float64
    return (qi.to(dt) @ rows.to(dt).T).float()


def quantize_rows_device(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An int8 bucket's rows from its bf16 rows, on their device
    (``vector_store.py:99-111``): :func:`quantize_query` of the f32 rows."""
    return quantize_query(x.float())


def int8_topk_scores(store_q: torch.Tensor, store_scale: torch.Tensor,
                     queries: torch.Tensor, valid: torch.Tensor, k: int,
                     group: int = 128):
    """The int8 store's route above the scan kernels' ``K_MAX``
    (``sema_tpu/ops/quant.py:int8_topk_scores``): each query quantized
    per row, the exact i32 sums of :func:`int8_dot` times the product of
    the two scales, masked rows -inf, then the hierarchical selection
    (groups of ``group``; N not a multiple of it, or under two groups, the
    plain one). Approximate scores: the store re-scores the ids from the
    originals."""
    qi, qscale = quantize_query(queries.float())
    s = int8_dot(qi, store_q) * (qscale[:, None] * store_scale[None, :])
    s = s.masked_fill(~valid.bool()[None, :], float("-inf"))
    n = s.shape[1]
    if n % group or n < group * 2:
        return stable_topk(s, min(k, n))
    return hier_topk_scores(s, k, group=group)


def rescore_exact(candidates_full: np.ndarray, query: np.ndarray,
                  candidate_ids: np.ndarray, k: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Full-precision host rescore of gathered candidate rows.

    candidates_full: (R, d) f32 original vectors (host)
    query: (d,) f32;  candidate_ids: (R,) global row ids
    Returns (scores (k,), ids (k,)) sorted descending.
    """
    scores = candidates_full.astype(np.float32) @ query.astype(np.float32)
    order = np.argsort(-scores, kind="stable")[:k]
    return scores[order], candidate_ids[order]
