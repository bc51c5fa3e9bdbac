"""Exact top-k over a row-sharded store (from
``sema_tpu/parallel/sharded_topk.py:1-169``).

The store's N rows are cut into equal blocks over the mesh's ``index``
axis, block s on shard s's device. The queries go to every shard; each
scans its block for its own top-k (``local_fn``: the store passes its
scan kernel, K1 or K4a, or K3/K4b over a probe's tiles), its ids become
global by the shard's row offset ``s * shard_rows``, and the (Q, k)
candidates of every shard merge into the global top-k. Exact: the global
top-k is a subset of the union of the shards' top-k.

The JAX package runs the shards under ``shard_map`` and merges with an
``all_gather`` and ``lax.top_k`` (``merge_axis``, :28-40). The port's one
process drives every shard in shard order
(:mod:`sema_tpu_torch.parallel.mesh`), and :func:`merge_shards` brings
the candidates to the mesh's first device and keeps the k best by a
stable descending sort of the shard-major candidates: ``lax.top_k``'s
order, so equal scores keep the lower global row id, and a -inf slot
never outranks a live row. The merge is torch, not a kernel, as it is XLA
outside any Pallas kernel in the JAX package.

A store reaches the returned functions as a list of per-shard blocks,
each on its shard's device, as :class:`~sema_tpu_torch.index.
vector_store.VectorStore` keeps it: a block is a tensor, or a tuple of
tensors such as the int8 store's (values, scales), cut along its rows, so
the JAX package's ``store_specs`` (the pytree's PartitionSpecs) has no
counterpart. ``local_fn`` is the caller's scan kernel; nothing is
compiled, so nothing is cached either.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.ops.topk import stable_topk


def shard_devices(mesh, axes: Union[str, Sequence[str]]) -> list:
    """The device of each shard along ``axes`` (one axis, or several,
    the first outermost: ``(slice, index)`` is slice-major), in shard
    order. Axes not named repeat the same shard; their first entry holds
    it."""
    axes = [axes] if isinstance(axes, str) else list(axes)
    return [resolve_device(d) for d in mesh.grid(axes).reshape(-1)]


def shard_rows_of(total_rows: int, shards: int) -> int:
    """Rows of one shard's block; ValueError where they do not divide."""
    if total_rows % shards:
        raise ValueError(f"rows {total_rows} not divisible by {shards} "
                         "shards")
    return total_rows // shards


def merge_shards(scores: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
                 k: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each shard's (Q, k_s) candidates, ids already global, in shard order
    → the k best of their union on ``device`` (``merge_axis``): (Q,
    min(k, sum k_s)) f32 scores and ids, equal scores in candidate order,
    which is the lower global row id first."""
    s = torch.cat([t.to(device) for t in scores], 1)
    i = torch.cat([t.to(device) for t in ids], 1)
    top_s, pos = stable_topk(s, min(k, s.shape[1]))
    return top_s, torch.gather(i, 1, pos.long())


def scan_shards(devices: Sequence[torch.device], shard_rows: int,
                local_fn: Callable, store: Sequence, queries: torch.Tensor,
                valid: Sequence, k: int, tiles: Optional[np.ndarray] = None,
                n_live=None):
    """Every shard's ``local_fn`` over its block on its device, in shard
    order (``_local_then_merge``, ``_local_pruned_then_merge``): ``store``
    and ``valid`` hold one block a shard, the queries are copied to the
    shard's device, and its (Q, k) scores and ids come back, the ids
    offset by the shard's first row. With ``tiles`` ((shards, T) tile ids
    of each shard's probe) and ``n_live`` ((shards, 1) or (shards,) live
    counts), ``local_fn(block, q, valid, tile_ids, n_live, k)``, else
    ``local_fn(block, q, valid, k)``."""
    c = len(devices)
    if len(store) != c or len(valid) != c:
        raise ValueError(f"{len(store)} blocks and {len(valid)} masks for "
                         f"{c} shards")
    if tiles is not None:
        tiles = np.asarray(tiles)
        n_live = np.asarray(n_live).reshape(c)
    scores, ids = [], []
    for s, dev in enumerate(devices):
        probe = () if tiles is None else (tiles[s], int(n_live[s]))
        sc, ix = local_fn(store[s], queries.to(dev), valid[s], *probe, k)
        scores.append(sc)
        ids.append(ix + s * shard_rows)
    return scores, ids


def make_sharded_topk(mesh, total_rows: int, k: int, axis: str = "index",
                      *, local_fn: Callable) -> Callable:
    """A (store, queries, valid) → (scores, ids) function over the shards
    of ``mesh``'s ``axis`` (``make_sharded_topk``, :53-87): ``total_rows``
    must divide into them (the store pads its rows to a shard multiple and
    masks the padding). ``local_fn(block, queries, valid_block, k)`` is
    each shard's scan, a kernel's wrapper (the store's K1 or K4a)."""
    devices = shard_devices(mesh, axis)
    shard_rows = shard_rows_of(total_rows, len(devices))

    def fn(store, queries, valid):
        scores, ids = scan_shards(devices, shard_rows, local_fn, store,
                                  queries, valid, k)
        return merge_shards(scores, ids, k, devices[0])
    return fn


def sharded_topk(mesh, store: Sequence[torch.Tensor], queries, valid,
                 k: int, axis: str = "index"):
    """One call of :func:`make_sharded_topk` for a bf16/f16/f32 store in
    per-shard blocks (``sharded_topk``, :93-107), each shard's scan K1
    (``ops.scan_topk.scan_topk``). For the int8 (values, scales) store or
    another scan, call :func:`make_sharded_topk` with ``local_fn``."""
    from sema_tpu_torch.ops.scan_topk import scan_topk
    return make_sharded_topk(mesh, sum(b.shape[0] for b in store), k,
                             axis=axis, local_fn=scan_topk)(
        store, queries, valid)


def make_sharded_pruned_topk(mesh, total_rows: int, k: int,
                             axis: str = "index", *,
                             local_fn: Callable) -> Callable:
    """Sharded IVF (``make_sharded_pruned_topk``, :127-169): a (store,
    queries, valid, tiles, n_live) → (scores, ids) function. Each shard's
    block is clustered on its own (cluster-major within its rows);
    ``tiles`` is the (shards, T) table of each shard's probe, in tile ids
    local to its block, and ``n_live`` its (shards, 1) live counts.
    ``local_fn(block, queries, valid_block, tile_ids, n_live, k)`` is the
    shard's pruned scan (the store's K3 or K4b). The ids are permuted
    positions, global by the shard's offset; the store maps them through
    its composed permutation on the host."""
    devices = shard_devices(mesh, axis)
    shard_rows = shard_rows_of(total_rows, len(devices))

    def fn(store, queries, valid, tiles, n_live):
        scores, ids = scan_shards(devices, shard_rows, local_fn, store,
                                  queries, valid, k, tiles, n_live)
        return merge_shards(scores, ids, k, devices[0])
    return fn
