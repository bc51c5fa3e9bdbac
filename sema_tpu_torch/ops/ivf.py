"""IVF clustering for the pruned (ANN) scan path (from ``sema_tpu/ops/ivf.py``).

In IVF mode a sealed bucket is k-means-clustered when it is built and its
device rows are permuted cluster-major, so that each cluster is a run of
rows; a query probes its ``nprobe`` nearest clusters on the host, unions
their covering tiles, and the pruned scan (K3/K4b of ``ops/scan_topk.py``)
reads only those tiles.

:func:`cluster_layout` and :func:`select_tiles` are the JAX package's numpy
functions, unchanged. :func:`kmeans_cluster` is its XLA function in torch:
the same strided real-rows-first init, dead-centroid replacement and
penalty, Lloyd iterations over blocks of 8,192 rows cast to f32 one block
at a time, one-hot matmuls for the centroid sums, and the overflow id
``c`` for all-zero (padding) rows. The matmuls and the argmax are plain
XLA in the JAX package and plain ``torch.matmul``/``argmax`` here: no
kernel. Everything is deterministic (no RNG), but the two packages sum in
another order, so a row near a boundary between two clusters may be
assigned differently (``tests/test_torch_ivf.py`` states the agreement).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_DEAD_PENALTY = -1.0e30
_BLOCK = 8192


def _l2(x: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=1e-12)


def kmeans_cluster(x: torch.Tensor, c: int, iters: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine k-means over (N, d) rows → (assign (N,) i32, cent (C, d) f32),
    on the rows' device.

    Rows are expected L2-normalized-or-zero (real rows are unit vectors,
    bucket padding is all-zero). Zero rows get zero weight in centroid
    updates and the overflow assignment ``c`` (pass ``c + 1`` to
    :func:`cluster_layout`); centroids that never attract a row stay
    all-zero and are skipped by the host probe (empty ranges).
    """
    n, d = x.shape
    if n == 0:
        raise ValueError("kmeans_cluster: empty input")
    block = min(_BLOCK, n)
    pad = (-n) % block
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))], dim=0)
    nb = (n + pad) // block
    # the rows stay in their input dtype; each block is cast to f32 in turn
    blocks = [x[i * block:(i + 1) * block] for i in range(nb)]
    w_full = torch.cat([(b.float() ** 2).sum(1) for b in blocks]) > 0
    w = w_full.float().reshape(nb, block)

    # seeds from real rows first: zero rows sort after them (stable)
    order = torch.argsort((~w_full).to(torch.uint8), stable=True)
    stride = max(1, n // c)
    cent = _l2(x[order[::stride][:c]].float())
    if cent.shape[0] < c:  # n < c: degenerate tiny bucket
        cent = F.pad(cent, (0, 0, 0, c - cent.shape[0]))
    n_real = max(int(w_full.sum()), 1)
    repl = _l2(x[order[torch.arange(c, device=x.device) % n_real]].float())
    dead0 = (torch.sum(cent * cent, dim=1) == 0)[:, None]
    cent = torch.where(dead0, repl, cent)

    def scores(xbl, cent):
        # dead (all-zero) centroids score 0 against everything, which
        # would beat genuinely negative cosines: penalize them out
        dead = (torch.sum(cent * cent, dim=1) == 0).float()
        return xbl @ cent.T + dead * _DEAD_PENALTY

    for _ in range(iters):
        sums = torch.zeros((c, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros((c,), dtype=torch.float32, device=x.device)
        for xbl, wbl in zip(blocks, w):
            xbl = xbl.float()
            a = torch.argmax(scores(xbl, cent), dim=1)
            oh = F.one_hot(a, c).float() * wbl[:, None]
            sums += oh.T @ xbl
            counts += oh.sum(0)
        new = _l2(sums)
        # an empty cluster keeps its old centroid (it may re-attract later)
        cent = torch.where((counts > 0)[:, None], new, cent)

    assign = []
    for xbl, wbl in zip(blocks, w):
        a = torch.argmax(scores(xbl.float(), cent), dim=1).to(torch.int32)
        # zero (padding) rows take the overflow id c, past every real
        # cluster, so that they never splice into a real cluster's range
        assign.append(torch.where(wbl > 0, a, torch.full_like(a, c)))
    return torch.cat(assign)[:n], cent


def cluster_layout(assign: np.ndarray, c: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Host side of the build: cluster-major row order.

    Returns ``perm`` (new position → original row, i32) and ``starts``
    (C+1 cumulative row offsets per cluster, i64). The store's device
    array is reordered as ``rows[perm]``; a kernel hit at permuted
    position p maps back through ``perm[p]``.
    """
    assign = np.asarray(assign)
    perm = np.argsort(assign, kind="stable").astype(np.int32)
    counts = np.bincount(assign, minlength=c)
    starts = np.zeros(c + 1, dtype=np.int64)
    starts[1:] = np.cumsum(counts)
    return perm, starts


def select_tiles(centroids: np.ndarray, starts: np.ndarray,
                 queries: np.ndarray, nprobe: int, tile_n: int,
                 budget: int) -> Optional[Tuple[np.ndarray, int]]:
    """Host side of a probe: the tile list for one dispatch.

    ``queries`` are the LIVE query rows only (phantom zero-padded rows
    would probe garbage clusters and blow the budget). Returns
    ``(tile_ids (budget,) i32, n_live)`` — padded by repeating the last
    live tile id so Mosaic elides the pad steps' DMA — or ``None`` when
    the union of probed clusters exceeds ``budget`` tiles (caller falls
    back to the exact full scan) or probes nothing.
    """
    if len(queries) == 0:
        return None
    cs = np.asarray(queries, dtype=np.float32) @ centroids.T  # (Q, C)
    # dead (all-zero) centroids score exactly 0 — which outranks every
    # real cluster a query is anti-aligned with, silently eating probe
    # slots (the `keep` filter below drops them AFTER selection, so the
    # effective nprobe shrank with no signal; review finding, r3)
    dead = np.sum(np.asarray(centroids, dtype=np.float32) ** 2,
                  axis=1) == 0
    if dead.any():
        cs[:, dead] = -np.inf
    nprobe = min(nprobe, cs.shape[1])
    if nprobe < cs.shape[1]:
        idx = np.argpartition(-cs, nprobe - 1, axis=1)[:, :nprobe]
    else:
        idx = np.broadcast_to(np.arange(cs.shape[1]), cs.shape)
    sel = np.unique(idx)
    lo, hi = starts[sel], starts[sel + 1]
    keep = hi > lo  # skip empty/dead clusters
    lo, hi = lo[keep], hi[keep]
    if len(lo) == 0:
        return None
    spans = [np.arange(a // tile_n, (b - 1) // tile_n + 1)
             for a, b in zip(lo, hi)]
    tiles = np.unique(np.concatenate(spans))
    n_live = len(tiles)
    if n_live > budget:
        return None
    out = np.full(budget, tiles[-1], dtype=np.int32)
    out[:n_live] = tiles
    return out, n_live
