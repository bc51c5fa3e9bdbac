"""K8 of the port: ``scan_topk(warm_rows=)`` (on CPU tensors, its plain
version ``scan_topk_warm_reference``) held against the JAX package's
warm-start Pallas scan in interpret mode, on the same numpy inputs, in the
cases of ``tests/test_pallas_topk.py::TestWarmStart``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops.pallas_topk import _warm_thr0, pallas_topk
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.scan_topk import (scan_topk, scan_topk_reference,
                                          scan_topk_warm, warm_threshold)

scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")


def _data(n, d=128, q=4, seed=0):
    """``tests/test_pallas_topk.py``'s unit rows and queries."""
    rng = np.random.default_rng(seed)
    store = rng.standard_normal((n, d)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return store, queries


def _jax(store, queries, valid, k, warm_rows, masked=True):
    s, i = pallas_topk(jnp.asarray(store), jnp.asarray(queries),
                       jnp.asarray(valid), k, tile_n=128, interpret=True,
                       masked=masked, warm_rows=warm_rows)
    return np.asarray(s), np.asarray(i)


def _port(store, queries, valid, k, warm_rows, masked=True):
    s, i = scan_topk(torch.from_numpy(store), torch.from_numpy(queries),
                     torch.from_numpy(valid), k, masked=masked,
                     warm_rows=warm_rows)
    return s.numpy(), i.numpy()


def _same(got, want):
    """Ids identical; scores within 1e-6, as tests/test_torch_scan_topk.py
    holds K1 (f32 dot products of unit vectors summed in another order)."""
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(np.isfinite(got[0]), np.isfinite(want[0]))
    fin = np.isfinite(want[0])
    np.testing.assert_allclose(got[0][fin], want[0][fin], atol=1e-6, rtol=0)


def _tie_at_kth():
    """One-hot scores where the global k-th (k = 5) EQUALS the sample's
    k-th and a row at that score is in the top k: inside the 128-row
    sample 0.9 at row 5 and 0.5 at rows 20, 40, 60, 80; outside it 0.95 at
    row 300 and 0.5 at rows 200 and 400. The top 5 are 300, 5, 20, 40, 60;
    a screen at the sample's k-th itself (no one-ULP backoff) would drop
    the three rows at 0.5."""
    store = np.zeros((512, 128), dtype=np.float32)
    store[5, 0], store[300, 0] = 0.9, 0.95
    store[[20, 40, 60, 80, 200, 400], 0] = 0.5
    q = np.zeros((1, 128), dtype=np.float32)
    q[0, 0] = 1.0
    return store, q, np.ones(512, bool)


@pytest.mark.parametrize("warm_rows", [128, 512, 1024])
@pytest.mark.parametrize("k", [1, 10])
def test_matches_pallas_warm_scan(k, warm_rows):
    store, queries = _data(1024, seed=3)
    valid = np.ones(1024, bool)
    valid[::13] = False
    want = _jax(store, queries, valid, k, warm_rows)
    _same(_port(store, queries, valid, k, warm_rows), want)
    # and K1's (cold) result
    _same(_port(store, queries, valid, k, 0), want)


def test_exact_when_kth_ties_sample_kth_as_in_jax():
    """``TestWarmStart.test_exact_when_kth_ties_sample_kth``'s case."""
    d = 128
    store = np.zeros((512, d), dtype=np.float32)
    q = np.zeros((1, d), dtype=np.float32)
    q[0, 0] = 1.0
    for r in (5, 60, 200, 400):
        store[r, 0] = 0.75
    store[300, 0] = 0.9
    valid = np.ones(512, bool)
    want = _jax(store, q, valid, 5, 128)
    got = _port(store, q, valid, 5, 128)
    _same(got, want)
    assert got[1][0].tolist() == [300, 5, 60, 200, 400]


def test_global_kth_equal_to_sample_kth():
    store, q, valid = _tie_at_kth()
    want = _jax(store, q, valid, 5, 128)
    got = _port(store, q, valid, 5, 128)
    _same(got, want)
    assert got[1][0].tolist() == [300, 5, 20, 40, 60]


def test_without_the_backoff_the_tie_case_fails(monkeypatch):
    """The screen at the sample's k-th itself drops rows of the true top k:
    the test above sees a plain version without the one-ULP backoff."""
    store, q, valid = _tie_at_kth()
    monkeypatch.setattr(scan_mod, "warm_threshold", lambda t: t)
    s, i = _port(store, q, valid, 5, 128)
    assert i[0].tolist() != [300, 5, 20, 40, 60]
    assert np.isneginf(s[0, 2:]).all()


def test_fully_masked_sample_degrades_cold():
    store, queries = _data(512, q=2, seed=4)
    valid = np.ones(512, bool)
    valid[:128] = False           # the whole sample is tombstoned
    want = _jax(store, queries, valid, 3, 128)
    _same(_port(store, queries, valid, 3, 128), want)
    _same(_port(store, queries, valid, 3, 0), want)


def test_nomask_variant():
    store, queries = _data(1024, seed=5)
    valid = np.ones(1024, bool)
    want = _jax(store, queries, valid, 10, 256, masked=False)
    _same(_port(store, queries, valid, 10, 256, masked=False), want)


def test_warm_rows_larger_than_store_clamped():
    store, queries = _data(256, q=2, seed=6)
    valid = np.ones(256, bool)
    want = _jax(store, queries, valid, 4, 4096)
    _same(_port(store, queries, valid, 4, 4096), want)


@pytest.mark.parametrize("warm_rows,n", [(5, 512), (4096, 8)])
def test_k_beyond_the_sample_raises_value_error_as_jax(warm_rows, n):
    store, queries = _data(n, q=2, seed=7)
    valid = np.ones(n, bool)
    with pytest.raises(ValueError):
        _jax(store, queries, valid, 10, warm_rows)
    with pytest.raises(ValueError, match="warm-start sample"):
        _port(store, queries, valid, 10, warm_rows)


@pytest.mark.parametrize("masked", [True, False])
def test_threshold_matches_jax_warm_thr0(masked):
    """The port's threshold (the plain version's scores of the sample, one
    ULP down) against ``_warm_thr0``: within 1e-6, the f32 sums of 128
    products of unit vectors in another order; -inf where the sample has
    fewer than k live rows."""
    store, queries = _data(1024, q=6, seed=8)
    valid = np.ones(1024, bool)
    valid[::3] = False
    valid[:64] = False
    # a sample of 70 rows holds 4 live ones: -inf when masked
    for w, k in ((512, 10), (70, 10)):
        want = np.asarray(_warm_thr0(jnp.asarray(store), jnp.asarray(queries),
                                     jnp.asarray(valid), k, w, masked))[:, 0]
        kth = scan_topk_reference(torch.from_numpy(store[:w]),
                                  torch.from_numpy(queries),
                                  torch.from_numpy(valid[:w]), k,
                                  masked)[0][:, k - 1]
        got = warm_threshold(kth).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=1e-6, rtol=0)
        assert (got[fin] < kth.numpy()[fin]).all()
    assert np.isneginf(got).all() == masked


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor off the CPU reaches the kernel path or raises, as for K1
    (tests/test_torch_scan_topk.py); the ValueError comes first."""
    called = []
    monkeypatch.setattr(scan_mod, "scan_topk_warm_reference",
                        lambda *a, **k: called.append(1))
    monkeypatch.setattr(scan_mod, "scan_topk_reference",
                        lambda *a, **k: called.append(1))
    store, q, valid = _meta(64, 32), _meta(2, 32), _meta(64, dtype=torch.bool)
    with pytest.raises(ValueError):
        scan_topk(store, q, valid, 5, warm_rows=4)
    with pytest.raises(KernelError, match="CPU or CUDA"):
        scan_topk(store, q, valid, 5, warm_rows=16)
    monkeypatch.setattr(scan_mod, "_check", lambda *a, **k: None)

    def failing_library(*a, **k):
        raise KernelError("kernel build failed: nvcc rc=1")
    monkeypatch.setattr(scan_mod._cuda, "library", failing_library)
    before = (scan_topk.launches, scan_topk_warm.launches)
    with pytest.raises(KernelError, match="kernel build failed"):
        scan_topk_warm(store, q, valid, 5, 16)
    assert not called
    assert (scan_topk.launches, scan_topk_warm.launches) == before
