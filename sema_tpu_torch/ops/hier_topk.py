"""Hierarchical exact top-k (``sema_tpu/ops/hier_topk.py``, rewritten in
torch): the store's route for a k above the scan kernels' ``K_MAX``, as
the JAX package takes it above its kernels' limit.

Scores (Q, N) are cut into groups of ``group`` columns; the k groups with
the largest maxima hold every top-k score (a group holding one has a max
at least the k-th score, and a group whose max beats the k-th holds a
top-k score itself), so the top k of those groups' scores are the top k
of the row. Exact in score. Torch, not a kernel, like ``ops/quant.py``.

Order among equal scores: the lower row id first, the scan kernels' rule.
The groups are picked by a stable sort of their maxima (the lower group
first among equal maxima) and the candidates selected by a stable sort
in row order, so equal scores at the k-th place resolve to the lowest ids
as a sort of the whole row would. The JAX version may swap them.
"""

from __future__ import annotations

import torch

from sema_tpu_torch.ops.topk import scores as _scores
from sema_tpu_torch.ops.topk import stable_topk


def hier_topk_scores(scores: torch.Tensor, k: int, group: int = 64):
    """Exact top-k over the last axis of (Q, N) f32 scores, N a multiple
    of ``group`` (ValueError otherwise). Returns (values (Q, k) f32,
    indices (Q, k) int32), k clamped to N."""
    q, n = scores.shape
    if n % group:
        raise ValueError(f"N={n} not a multiple of group={group}")
    g = n // group
    blocked = scores.reshape(q, g, group)
    k_groups = min(k, g)
    _, top = stable_topk(blocked.amax(dim=-1), k_groups)      # (Q, kG)
    top = top.long().sort(dim=1).values                       # row order
    cand = torch.gather(blocked, 1,
                        top[..., None].expand(q, k_groups, group))
    vals, local = stable_topk(cand.reshape(q, k_groups * group), k)
    local = local.long()
    idx = torch.gather(top, 1, local // group) * group + local % group
    return vals, idx.to(torch.int32)


def batched_topk_scores_hier(store: torch.Tensor, queries: torch.Tensor,
                             valid: torch.Tensor, k: int, group: int = 64):
    """``ops.topk.batched_topk_scores`` through the hierarchical selection
    (same contract: masked rows are -inf). N not a multiple of ``group``,
    or under two groups, takes the plain selection."""
    s = _scores(store, queries, valid)
    n = s.shape[1]
    if n % group or n < group * 2:
        return stable_topk(s, min(k, n))
    return hier_topk_scores(s, k, group=group)
