"""The port's exact top-k oracle (``sema_tpu_torch/ops/topk.py``) against
``sema_tpu/ops/topk.py`` on the same numpy inputs: the tests of
``tests/test_topk.py`` run through both. Scores agree within f32
tolerance; ids are equal where scores are distinct."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sema_tpu.ops.topk import batched_topk_scores as jax_topk
from sema_tpu.ops.topk import exact_topk as jax_exact
from sema_tpu_torch.ops.topk import batched_topk_scores, exact_topk


def _data(n=1000, d=64, q=4, seed=0):
    rng = np.random.default_rng(seed)
    store = rng.standard_normal((n, d)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return store, queries


def _oracle(store, queries, valid, k):
    scores = queries @ store.T
    scores[:, ~valid] = -np.inf
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def _both(store, queries, valid, k, dtype=torch.float32):
    got = batched_topk_scores(torch.from_numpy(store).to(dtype),
                              torch.from_numpy(queries),
                              torch.from_numpy(valid), k)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_topk(jnp.asarray(store, dtype=jdt), jnp.asarray(queries),
                    jnp.asarray(valid), k)
    return ((got[0].numpy(), got[1].numpy()),
            (np.asarray(want[0]), np.asarray(want[1])))


def _agree(got, want, atol=1e-6):
    """Scores within ``atol``; ids equal wherever a query's scores are
    distinct from their neighbours'."""
    np.testing.assert_allclose(got[0], want[0], atol=atol)
    assert got[1].dtype == np.int32
    for s, gi, wi in zip(want[0], got[1], want[1]):
        gap = np.diff(s)
        distinct = np.ones(len(s), bool)
        distinct[1:] &= gap != 0
        distinct[:-1] &= gap != 0
        np.testing.assert_array_equal(gi[distinct], wi[distinct])


def test_exact_topk_recall_is_one():
    store, queries = _data()
    valid = np.ones(1000, dtype=bool)
    got, want = _both(store, queries, valid, 10)
    ref_scores, ref_idx = _oracle(store, queries, valid, 10)
    _agree(got, want)
    for i in range(queries.shape[0]):
        assert set(got[1][i].tolist()) == set(ref_idx[i].tolist())
    np.testing.assert_allclose(got[0], ref_scores, atol=1e-5)


def test_single_query_wrapper():
    store, queries = _data(q=1)
    valid = np.ones(1000, dtype=bool)
    s, i = exact_topk(torch.from_numpy(store), torch.from_numpy(queries[0]),
                      torch.from_numpy(valid), 5)
    js, ji = jax_exact(jnp.asarray(store), jnp.asarray(queries[0]),
                       jnp.asarray(valid), 5)
    assert s.shape == (5,) and i.shape == (5,)
    assert np.all(np.diff(s.numpy()) <= 1e-6)  # descending
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_masked_rows_excluded():
    store, queries = _data(n=100)
    valid = np.ones(100, dtype=bool)
    # make row 7 the best possible match for query 0, then tombstone it
    store[7] = queries[0]
    valid[7] = False
    got, want = _both(store, queries, valid, 10)
    assert 7 not in got[1][0].tolist()
    _agree(got, want)


def test_bf16_store_close_to_f32():
    store, queries = _data(n=512)
    valid = np.ones(512, dtype=bool)
    f32, _ = _both(store, queries, valid, 10)
    bf16, jax_bf16 = _both(store, queries, valid, 10, torch.bfloat16)
    # bf16 rounding may swap near-ties but scores agree to bf16 eps; the
    # bf16 products sum in f32 on both sides
    np.testing.assert_allclose(bf16[0], f32[0], atol=2e-2)
    _agree(bf16, jax_bf16, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_equal_scores_keep_the_lower_row_first(k):
    """``lax.top_k``'s order: equal scores, lower row id first."""
    store, queries = _data(n=64, q=1)
    for r in (40, 9, 33, 2):
        store[r] = queries[0]
    got, want = _both(store, queries, np.ones(64, bool), k)
    assert got[1][0, :min(k, 4)].tolist() == [2, 9, 33, 40][:k]
    np.testing.assert_array_equal(got[1], want[1])
