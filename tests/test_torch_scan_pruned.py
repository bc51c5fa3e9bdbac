"""K4a, K3 and K4b of the port (``sema_tpu_torch.ops.scan_topk``'s int8 and
pruned scans; on CPU tensors, their plain versions) held against the JAX
package's Pallas kernels in interpret mode on the same numpy inputs.
K4a and K4b must be bit-equal in scores and ids, ties and masked slots
included; K3 sums f32 products in another order (1e-5)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops.pallas_topk import (pallas_topk_int8,
                                      pallas_topk_int8_pruned,
                                      pallas_topk_pruned)
from sema_tpu.ops.quant import quantize_rows
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.scan_topk import (scan_topk_int8,
                                          scan_topk_int8_pruned,
                                          scan_topk_pruned)

scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
TILE = 128


def _case(n=1024, d=64, q=5, seed=0, live=None):
    """Rows with a 5-way tie (rows 7, 40, 97, 300, 700 equal), tombstones,
    queries (query 1 equals row 7, query 4 is zero)."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows[[40, 97, 300, 700]] = rows[7]
    valid = rng.random(n) > 0.2
    valid[[7, 40, 97, 300, 700]] = True
    if live is not None:
        valid[:] = False
        valid[:live] = True
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries[1] = rows[7]
    queries[4] = 0.0
    return rows, queries, valid


def _tiles(n, seed, n_live, t=6):
    """A sorted tile list of ``n_live`` live tiles padded to ``t`` by
    repeating the last live id, as ops/ivf.py:select_tiles gives it."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(n // TILE, size=n_live, replace=False))
    if 0 not in live:                 # keep the tied rows 7 and 40 in
        live[0] = 0
        live = np.sort(live)
    out = np.full(t, live[-1], dtype=np.int32)
    out[:n_live] = live
    return out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("k", [1, 16, 100, 128])
def test_int8_scan_bit_equal_to_pallas_kernel(k):
    rows, queries, valid = _case()
    qv, sc = quantize_rows(rows)
    want = pallas_topk_int8(jnp.asarray(qv), jnp.asarray(sc),
                            jnp.asarray(queries), jnp.asarray(valid), k,
                            tile_n=TILE, interpret=True)
    got = scan_topk_int8(*_t(qv, sc, queries, valid), k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    if k >= 5:                        # the tie, in row order
        assert got[1][1, :5].tolist() == [7, 40, 97, 300, 700]
        # the zero query: every live row ties at 0
        assert got[1][4, :5].tolist() == np.flatnonzero(valid)[:5].tolist()


def test_int8_scan_masked_slots():
    rows, queries, valid = _case(live=3)
    qv, sc = quantize_rows(rows)
    want = pallas_topk_int8(jnp.asarray(qv), jnp.asarray(sc),
                            jnp.asarray(queries), jnp.asarray(valid), 16,
                            tile_n=TILE, interpret=True)
    got = scan_topk_int8(*_t(qv, sc, queries, valid), 16)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.isneginf(got[0][:, 3:].numpy()).all()
    assert not got[1][:, 3:].any()


@pytest.mark.parametrize("k,n_live", [(16, 6), (100, 3), (128, 1)])
def test_pruned_scan_matches_pallas_kernel(k, n_live):
    rows, queries, valid = _case(seed=1)
    tiles = _tiles(len(rows), 2, n_live)
    want_s, want_i = pallas_topk_pruned(
        jnp.asarray(rows), jnp.asarray(queries), jnp.asarray(valid),
        jnp.asarray(tiles), jnp.asarray([n_live], dtype=jnp.int32), k,
        tile_n=TILE, interpret=True)
    got_s, got_i = scan_topk_pruned(*_t(rows, queries, valid), tiles,
                                    n_live, k, TILE)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5,
                               rtol=0)
    # only rows of the live tiles come back
    tile_of = got_i.numpy()[np.isfinite(got_s.numpy())] // TILE
    assert np.isin(tile_of, tiles[:n_live]).all()


@pytest.mark.parametrize("k,n_live", [(16, 6), (100, 3), (128, 1)])
def test_int8_pruned_scan_bit_equal_to_pallas_kernel(k, n_live):
    rows, queries, valid = _case(seed=3)
    qv, sc = quantize_rows(rows)
    tiles = _tiles(len(rows), 4, n_live)
    want = pallas_topk_int8_pruned(
        jnp.asarray(qv), jnp.asarray(sc), jnp.asarray(queries),
        jnp.asarray(valid), jnp.asarray(tiles),
        jnp.asarray([n_live], dtype=jnp.int32), k, tile_n=TILE,
        interpret=True)
    got = scan_topk_int8_pruned(*_t(qv, sc, queries, valid), tiles, n_live,
                                k, TILE)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if k >= 2:                        # rows 7 and 40 of tile 0 tie
        assert got[1][1, :2].tolist() == [7, 40]


def test_bf16_pruned_store():
    rows, queries, valid = _case(seed=5)
    tiles = _tiles(len(rows), 6, 4)
    store = torch.from_numpy(rows).bfloat16()
    got_s, got_i = scan_topk_pruned(store, *_t(queries, valid), tiles, 4,
                                    16, TILE)
    want_s, want_i = pallas_topk_pruned(
        jnp.asarray(store.float().numpy(), dtype=jnp.bfloat16),
        jnp.asarray(queries), jnp.asarray(valid), jnp.asarray(tiles),
        jnp.asarray([4], dtype=jnp.int32), 16, tile_n=TILE, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name", ["scan_topk_int8", "scan_topk_pruned",
                                  "scan_topk_int8_pruned"])
def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch, name):
    called = []
    for ref in ("scan_topk_int8_reference", "scan_topk_pruned_reference",
                "scan_topk_int8_pruned_reference"):
        monkeypatch.setattr(scan_mod, ref, lambda *a, **k: called.append(1))
    int8 = "int8" in name
    store = _meta(256, 64, dtype=torch.int8 if int8 else torch.bfloat16)
    args = ([store, _meta(256)] if int8 else [store]) + [
        _meta(2, 64), _meta(256, dtype=torch.bool)]
    if "pruned" in name:
        args += [np.array([0, 1], dtype=np.int32), 2]
    args.append(5)
    if "pruned" in name:
        args.append(TILE)
    fn = getattr(scan_mod, name)
    with pytest.raises(KernelError, match="CPU or CUDA"):
        fn(*args)
    for check in ("_check", "_check_int8"):
        monkeypatch.setattr(scan_mod, check, lambda *a, **k: None)

    def failing_library(*a, **k):
        raise RuntimeError("kernel build failed: nvcc rc=1")
    monkeypatch.setattr(scan_mod._cuda, "library", failing_library)
    before = fn.launches
    with pytest.raises(RuntimeError, match="kernel build failed"):
        fn(*args)
    assert not called and fn.launches == before


@pytest.mark.parametrize("tiles,n_live,tile_n,match", [
    ([0, 1], 3, 128, "n_live"),
    ([0, 1], 0, 128, "n_live"),
    ([0, 1], 2, 100, "multiple of 64"),
    ([0, 2], 2, 128, "outside"),
    ([-1, 0], 2, 128, "outside"),
    ([1, 0], 2, 128, "strictly increasing"),
    ([1, 1], 2, 128, "strictly increasing"),
])
def test_tile_list_checked_on_the_host(tiles, n_live, tile_n, match):
    with pytest.raises(KernelError, match=match):
        scan_mod._check_tiles(np.array(tiles), n_live, tile_n, 256)


@pytest.mark.parametrize("d,k", [(384, 128), (1024, 128), (1024, 1024)])
def test_int8_rows_fit_shared_memory_whole(d, k):
    """int8 rows of every registered width go through pass 1 whole at one
    query and k <= 128 (in three stage buffers), else in equal slabs of
    whole k-steps (32 values); shared memory fits either way."""
    words = d // 4
    for nq in (1, 256):
        slab = scan_mod.slab_words(d, 1, k, nq)
        slabs = -(-words // slab)
        assert slab % 8 == 0 and (slabs - 1) * slab < words <= slabs * slab
        assert scan_mod.pass1_smem_bytes(d, 1, k, nq) <= scan_mod._SMEM_MAX
    assert (scan_mod.slab_words(d, 1, k, 1) == words) == (k <= 128)
