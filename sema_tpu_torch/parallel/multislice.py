"""Two-level top-k merge over a (slice, index) mesh (from
``sema_tpu/parallel/multislice.py:1-134``).

A deployment over several TPU slices talks fast within a slice (ICI) and
slowly between slices (DCN), so the JAX package merges in two levels:
each chip's (Q, k) candidates merge within its slice, then only the
slice winners merge across slices. The store's rows shard over both
axes, slice-major: shard ``slice * chips_per_slice + chip`` holds block
``shard`` of the rows.

The port keeps these functions for the JAX package's API and runs the
same two levels with
:func:`~sema_tpu_torch.parallel.sharded_topk.merge_shards`: a slice's
candidates on the slice's first device, the slice winners on the mesh's
first. Both merges keep the lower global row id first among equal
scores, so the result is the flat merge's; one process has no slow link
between slices to spare, so the store merges its slice-major shards in
one flat merge.
"""

from __future__ import annotations

from typing import Callable

from sema_tpu_torch.parallel.sharded_topk import (merge_shards, scan_shards,
                                                  shard_devices,
                                                  shard_rows_of)


def _two_level(scores, ids, k: int, devices, per_slice: int):
    """Merge within each slice, then the slice winners (``_two_level``,
    :201-215)."""
    winners = [merge_shards(scores[lo:lo + per_slice], ids[lo:lo + per_slice],
                            k, devices[lo])
               for lo in range(0, len(devices), per_slice)]
    return merge_shards([s for s, _ in winners], [i for _, i in winners], k,
                        devices[0])


def make_multislice_topk(mesh, total_rows: int, k: int,
                         slice_axis: str = "slice",
                         index_axis: str = "index", *,
                         local_fn: Callable) -> Callable:
    """The two-level exact top-k over a (slice, index) mesh
    (``make_multislice_topk``, :218-242): a (store, queries, valid) →
    (scores, ids) function, rows in slice-major blocks; ValueError where
    ``total_rows`` does not divide into the shards."""
    devices = shard_devices(mesh, (slice_axis, index_axis))
    shard_rows = shard_rows_of(total_rows, len(devices))
    per_slice = mesh.shape[index_axis]

    def fn(store, queries, valid):
        scores, ids = scan_shards(devices, shard_rows, local_fn, store,
                                  queries, valid, k)
        return _two_level(scores, ids, k, devices, per_slice)
    return fn


def make_multislice_pruned_topk(mesh, total_rows: int, k: int,
                                slice_axis: str = "slice",
                                index_axis: str = "index", *,
                                local_fn: Callable) -> Callable:
    """Multislice IVF (``make_multislice_pruned_topk``, :264-303): the
    contract of :func:`~sema_tpu_torch.parallel.sharded_topk.
    make_sharded_pruned_topk` with slice-major shards, ``tiles`` and
    ``n_live`` tables of (slices x chips) rows, and the two-level merge."""
    devices = shard_devices(mesh, (slice_axis, index_axis))
    shard_rows = shard_rows_of(total_rows, len(devices))
    per_slice = mesh.shape[index_axis]

    def fn(store, queries, valid, tiles, n_live):
        scores, ids = scan_shards(devices, shard_rows, local_fn, store,
                                  queries, valid, k, tiles, n_live)
        return _two_level(scores, ids, k, devices, per_slice)
    return fn
