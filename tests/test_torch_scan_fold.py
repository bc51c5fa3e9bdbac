"""K9 of the port: ``fold_topk`` (on CPU tensors, its plain version) held
against the JAX tool's fold-merge Pallas scan (``tools/scan_ab14.py``,
loaded by path) in interpret mode and against ``pallas_topk(masked=False)``,
on the tool's data with its planted ties."""

import importlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops.pallas_topk import pallas_topk
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.scan_topk import fold_topk, scan_topk
from sema_tpu_torch.tools.scan_ab14 import small_data

scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
_TOOL = Path(__file__).resolve().parents[1] / "tools" / "scan_ab14.py"


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_scan_ab14", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_data(n):
    """The tool's ``--interpret`` store cut to ``n`` rows (planted ties
    4096 = 100 and 5000 = 5001 when n = 8192, else at the same places
    scaled down), with queries 0 and 1 set to the tied rows so that the
    ties land in the top k."""
    store, queries = small_data()
    store = store[:n].copy()
    if n < 8192:
        store[n // 2] = store[100]
        store[n // 2 + 904] = store[n // 2 + 905]
    tied = 5000 if n == 8192 else n // 2 + 904
    queries[0] = store[tied]
    queries[1] = store[100]
    return store, queries, tied


def _same(got, want):
    """Ids identical; scores within 2e-6 relative (f32 sums of 128
    products of normal values in another order)."""
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=2e-6, atol=0)


@pytest.mark.parametrize("n,k,tile_n", [(8192, 10, 1024), (4096, 1, 512),
                                        (4096, 64, 512)])
def test_fold_matches_jax_fold_and_pallas_scan(jax_tool, n, k, tile_n):
    store, queries, tied = _tool_data(n)
    js, jq = jnp.asarray(store), jnp.asarray(queries)
    fs, fi = jax_tool.fold_topk(js, jq, k, tile_n=tile_n, interpret=True)
    ps, pi = pallas_topk(js, jq, jnp.ones(n, bool), k, tile_n=tile_n,
                         interpret=True, masked=False)
    s, i = fold_topk(torch.from_numpy(store), torch.from_numpy(queries), k)
    got = (s.numpy(), i.numpy())
    _same(got, (np.asarray(fs), np.asarray(fi)))
    _same(got, (np.asarray(ps), np.asarray(pi)))
    if k > 1:
        assert got[1][0, :2].tolist() == [tied, tied + 1]
        assert got[1][1, :2].tolist() == [100, n // 2]


def test_fold_equals_k1_without_mask():
    store, queries, _ = _tool_data(4096)
    st, q = torch.from_numpy(store), torch.from_numpy(queries)
    valid = torch.ones(4096, dtype=torch.bool)
    for k in (3, 128):
        got, want = fold_topk(st, q, k), scan_topk(st, q, valid, k,
                                                   masked=False)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("d,itemsize,k", [(384, 2, 10), (384, 2, 128),
                                          (1024, 2, 128), (1024, 4, 1024)])
def test_fold_span_fits_shared_memory(d, itemsize, k):
    """K9's scores of a 256-row span leave room for the rows, at the A/B
    path's Q 256 and at one query: bf16 at d = 384 stages whole rows at
    k 10, and one query's block fits two an SM."""
    for nq in (1, 256):
        slab = scan_mod.slab_words(d, itemsize, k, nq, span=256)
        assert slab % 4 == 0 and slab >= 4
        smem = scan_mod.pass1_smem_bytes(d, itemsize, k, nq, span=256)
        assert smem <= scan_mod._SMEM_MAX
        if (d, itemsize, k) == (384, 2, 10):
            assert slab == d * itemsize // 4
            assert nq > 1 or 2 * smem <= 228 * 1024


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    called = []
    monkeypatch.setattr(scan_mod, "fold_topk_reference",
                        lambda *a, **k: called.append(1))
    store, q = _meta(64, 32), _meta(2, 32)
    with pytest.raises(KernelError, match="CPU or CUDA"):
        fold_topk(store, q, 5)
    monkeypatch.setattr(scan_mod, "_check", lambda *a, **k: None)
    with pytest.raises(KernelError, match="stats must be"):
        fold_topk(store, q, 5, stats=_meta(3, dtype=torch.int64))

    def failing_library(*a, **k):
        raise KernelError("kernel build failed: nvcc rc=1")
    monkeypatch.setattr(scan_mod._cuda, "library", failing_library)
    before = (scan_topk.launches, fold_topk.launches)
    with pytest.raises(KernelError, match="kernel build failed"):
        fold_topk(store, q, 5)
    assert not called and (scan_topk.launches, fold_topk.launches) == before
