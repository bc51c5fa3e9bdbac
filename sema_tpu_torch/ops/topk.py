"""Exact top-k of ``queries @ store.T`` by one product and a selection: the
oracle the scans are tested against (``sema_tpu/ops/topk.py``, rewritten
in torch).

Torch, not a kernel: the JAX package leaves this to XLA as well. The
product is the store dtype's with f32 sums (:func:`scores`); masked rows
score -inf. ``torch.topk`` stands for ``lax.top_k`` through a stable sort,
so that, as there, equal scores keep the lower row id first.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def scores(store: torch.Tensor, queries: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32 scores of ``queries`` cast to the store dtype against
    ``store``, rows whose ``valid`` entry is False at -inf. On the card a
    bf16/f16 store takes a GEMM with f32 output (as ``bert._linear``); on
    the CPU, which has none, the f32 product of the same operands, whose
    products f32 holds exactly."""
    q = queries.to(store.dtype)
    if store.dtype == torch.float32:
        out = q @ store.T
    elif store.is_cuda:
        out = torch.mm(q, store.T, out_dtype=torch.float32)
    else:
        out = q.float() @ store.float().T
    return out.masked_fill(~valid.bool()[None, :], NEG_INF)


def stable_topk(x: torch.Tensor, k: int):
    """The k largest of each row of ``x``, largest first and equal values
    in column order, with their int32 columns (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def batched_topk_scores(store: torch.Tensor, queries: torch.Tensor,
                        valid: torch.Tensor, k: int):
    """Scores (Q, k) f32 and row ids (Q, k) int32 of the top-k rows of
    ``store`` (N, d) for each query of ``queries`` (Q, d); ``valid`` (N,)
    bool is False for padding and tombstoned rows."""
    return stable_topk(scores(store, queries, valid), k)


def exact_topk(store: torch.Tensor, query: torch.Tensor, valid: torch.Tensor,
               k: int):
    """One query (d,): (k,) f32 scores and (k,) int32 row ids."""
    s, i = batched_topk_scores(store, query[None, :], valid, k)
    return s[0], i[0]
