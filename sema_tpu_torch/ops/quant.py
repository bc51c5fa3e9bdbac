"""Int8 quantization and the full-precision rescore (from ``sema_tpu/ops/quant.py``).

The int8 store (BASELINE config 4, "int8 quantized scan + bf16 rescore of
top-100") holds symmetric per-row int8 values and f32 scales on the
device; the scan (K4a/K4b of ``ops/scan_topk.py``) scores int8 x int8 in
i32; the top ``rescore_k`` candidates are re-scored at full precision from
the bf16 originals on disk and re-ranked.

Scoring math: score ~= (q_i8 . r_i8) * (s_q * s_r) where s_* = max|x|/127.

:func:`quantize_rows` and :func:`rescore_exact` are the JAX package's numpy
functions, unchanged. :func:`quantize_query` is its device function in
torch: ``torch.round`` rounds half to even, as ``jnp.round`` does. None of
this is a kernel: the JAX package runs it outside Pallas too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def quantize_rows_device(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An int8 bucket's rows from its bf16 rows, on their device
    (``vector_store.py:99-111``): :func:`quantize_query` of the f32 rows."""
    return quantize_query(x.float())


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
