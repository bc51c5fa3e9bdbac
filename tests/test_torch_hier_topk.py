"""The hierarchical exact top-k (``sema_tpu_torch/ops/hier_topk.py``) and
the int8 route (``ops/quant.py:int8_topk_scores``) against ``sema_tpu``'s
on the same numpy inputs: the tests of ``tests/test_hier_topk.py`` run
through both packages. Then the store's dispatch by k: above the scan
kernels' ``K_MAX`` a bucket goes to these routes and never to K1 or K4a,
whose check on the card raises there."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sema_tpu.ops.hier_topk import batched_topk_scores_hier as jax_hier
from sema_tpu.ops.hier_topk import hier_topk_scores as jax_hier_scores
from sema_tpu.ops.quant import int8_topk_scores as jax_int8_topk
from sema_tpu.ops.topk import batched_topk_scores as jax_topk
from sema_tpu_torch.index import vector_store as store_mod
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.hier_topk import (batched_topk_scores_hier,
                                          hier_topk_scores)
from sema_tpu_torch.ops.quant import int8_topk_scores, quantize_rows
from sema_tpu_torch.ops.scan_topk import K_MAX, scan_topk_reference
from sema_tpu_torch.ops.topk import batched_topk_scores
from sema_tpu_torch.types import Chunk


def _data(n, d=32, q=4, seed=0):
    rng = np.random.default_rng(seed)
    store = rng.standard_normal((n, d)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return store, queries


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _agree(got, want, atol=1e-6):
    """Scores within ``atol``; ids equal wherever a query's scores are
    distinct from their neighbours'."""
    gs, gi = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(gs, ws, atol=atol)
    for s, a, b in zip(ws, gi, wi):
        gap = np.diff(s)
        distinct = np.ones(len(s), bool)
        distinct[1:] &= gap != 0
        distinct[:-1] &= gap != 0
        np.testing.assert_array_equal(a[distinct], b[distinct])


@pytest.mark.parametrize("group", [8, 64, 128])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_matches_naive_exactly(group, k):
    store, queries = _data(4096)
    valid = np.ones(4096, bool)
    nv, ni = batched_topk_scores(*_t(store, queries, valid), k)
    hv, hi = batched_topk_scores_hier(*_t(store, queries, valid), k,
                                      group=group)
    # exact, and in the naive selection's order, ties included
    np.testing.assert_array_equal(hv.numpy(), nv.numpy())
    np.testing.assert_array_equal(hi.numpy(), ni.numpy())
    _agree((hv, hi), jax_hier(*_j(store, queries, valid), k, group=group))
    _agree((hv, hi), jax_topk(*_j(store, queries, valid), k))


def test_adversarial_clustered_topk():
    """All top-k rows packed into ONE group — the case where per-group max
    selection must still recover every one of them."""
    rng = np.random.default_rng(0)
    n, d, k, group = 1024, 16, 8, 64
    store = rng.standard_normal((n, d)).astype(np.float32) * 0.01
    q = rng.standard_normal((1, d)).astype(np.float32)
    q /= np.linalg.norm(q)
    base = 5 * group
    for j in range(k):
        store[base + j] = q[0] * (1.0 - 0.001 * j)
    valid = np.ones(n, bool)
    hv, hi = batched_topk_scores_hier(*_t(store, q, valid), k, group=group)
    assert hi[0].tolist() == [base + j for j in range(k)]
    _agree((hv, hi), jax_hier(*_j(store, q, valid), k, group=group))


def test_masked_rows_stay_excluded():
    store, queries = _data(512)
    valid = np.ones(512, bool)
    store[100] = queries[0]
    valid[100] = False
    hv, hi = batched_topk_scores_hier(*_t(store, queries, valid), 10,
                                      group=64)
    assert 100 not in hi[0].tolist()
    _agree((hv, hi), jax_hier(*_j(store, queries, valid), 10, group=64))


def test_indivisible_n_falls_back():
    store, queries = _data(100)  # 100 % 64 != 0 → naive selection
    valid = np.ones(100, bool)
    got = batched_topk_scores_hier(*_t(store, queries, valid), 5)
    np.testing.assert_array_equal(
        got[1].numpy(), batched_topk_scores(*_t(store, queries, valid),
                                            5)[1].numpy())
    _agree(got, jax_hier(*_j(store, queries, valid), 5))


def test_k_exceeds_groups():
    # G = 2 groups but k = 5: k_groups clamps to G, candidates = all rows
    scores = np.random.default_rng(0).standard_normal((2, 16)).astype(
        np.float32)
    vals, idx = hier_topk_scores(torch.from_numpy(scores), k=5, group=8)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(idx.numpy(), order)
    _agree((vals, idx), jax_hier_scores(jnp.asarray(scores), k=5, group=8))


def test_equal_scores_resolve_to_the_lowest_rows():
    """Ties across groups, at the k-th place too: the lowest row ids, as
    a stable sort of the whole row (the scan kernels' rule)."""
    store, queries = _data(1024, q=1)
    tied = [900, 70, 130, 5, 640]
    for r in tied:
        store[r] = queries[0]
    valid = np.ones(1024, bool)
    for k in (1, 3, 5, 7):
        hv, hi = batched_topk_scores_hier(*_t(store, queries, valid), k,
                                          group=64)
        assert hi[0, :min(k, 5)].tolist() == sorted(tied)[:k]
        nv, ni = batched_topk_scores(*_t(store, queries, valid), k)
        np.testing.assert_array_equal(hi.numpy(), ni.numpy())


@pytest.mark.parametrize("n,k", [(4096, 10), (4096, 300), (1000, 50)])
def test_int8_topk_scores_matches_jax(n, k):
    store, queries = _data(n, d=64)
    qv, sc = quantize_rows(store)
    valid = np.ones(n, bool)
    valid[::7] = False
    got = int8_topk_scores(*_t(qv, sc, queries, valid), k)
    want = jax_int8_topk(*_j(qv, sc, queries, valid), k)
    # the i32 sums are exact and both multiply by (qscale * row scale)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _agree(got, want, atol=0)
    assert not np.isin(got[1].numpy(), np.flatnonzero(~valid)).any()


# -- the store's dispatch by k -------------------------------------------------

DIM, ROWS = 64, 2048


def _store(tmp_path, dtype):
    store = VectorStore(tmp_path, DIM, "test-tiny", store_dtype=dtype,
                        device="cpu")
    rows, _ = _data(ROWS, d=DIM, seed=3)
    store.add_chunks([Chunk(id=f"c{i}", file_path=Path(f"/src/f{i % 7}.py"),
                            start_line=i + 1, end_line=i + 2,
                            content=f"row {i}") for i in range(ROWS)], rows)
    return store


class _KernelSpy:
    """The K1 or K4a wrapper of the store, raising for k > K_MAX as the
    card's check does, else calling through; records each k."""

    def __init__(self, monkeypatch, name):
        self.ks = []
        fn = getattr(store_mod, name)

        def spy(*a, **kw):
            k = a[4] if name == "scan_topk_int8" else a[3]
            self.ks.append(k)
            if not 1 <= k <= K_MAX:
                raise KernelError(f"k={k} outside [1, {K_MAX}]")
            return fn(*a, **kw)
        monkeypatch.setattr(store_mod, name, spy)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_k_above_k_max_takes_the_hierarchical_route(tmp_path, monkeypatch,
                                                    dtype):
    store = _store(tmp_path, dtype)
    name = "scan_topk_int8" if dtype == "int8" else "scan_topk"
    spy = _KernelSpy(monkeypatch, name)
    hier = "int8_topk_scores" if dtype == "int8" else \
        "batched_topk_scores_hier"
    route, fn = [], getattr(store_mod, hier)
    monkeypatch.setattr(store_mod, hier,
                        lambda *a, **kw: route.append(a[-1]) or fn(*a, **kw))
    q = _data(4, d=DIM, seed=11)[1][:2]
    s, ids = store.search_batch(q, 1500)
    assert spy.ks == []                   # the wrapper never saw k 1500
    assert s.shape == (2, 1500) and np.isfinite(s).all()
    assert all(len(set(r.tolist())) == 1500 for r in ids)
    assert (np.diff(s, axis=1) <= 0).all()
    rows = store.rows_at(np.arange(ROWS))
    if dtype == "int8":
        # candidates by int8 score, re-scored from the originals: the best
        # rows of the f32 product lead
        want = np.argsort(-(q @ rows.T), axis=1, kind="stable")[:, :10]
        np.testing.assert_array_equal(ids[:, :10], want)
    else:
        # the plain version of K1 on the whole bucket: the same product,
        # the same selection rule
        b = store.device_buckets()[0]
        ws, wi = scan_topk_reference(b["store"], torch.from_numpy(q),
                                     b["valid"], 1500)
        np.testing.assert_array_equal(s, ws.numpy())
        np.testing.assert_array_equal(ids, wi.numpy())
    # k at K_MAX and below still goes through the wrapper
    store.search_batch(q, 1000)
    store.search_batch(q, 10)
    assert spy.ks == [K_MAX, 16 if dtype == "bfloat16" else 128]
    assert route == [1500]               # one bucket, one call
    store.close()
