"""K1 of the port: ``sema_tpu_torch.ops.scan_topk`` (on CPU tensors, its
plain version) held against the JAX package's Pallas scan in interpret
mode and against its XLA oracle, on the same numpy inputs."""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops.pallas_topk import pallas_topk
from sema_tpu.ops.topk import batched_topk_scores
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference

# the package re-exports the function under the module's name
scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")


def _case(n=256, d=64, q=6, live=None, dup=True, seed=0):
    """Store with duplicated rows (exact score ties), tombstones, and
    queries; ``live`` keeps only that many leading rows valid."""
    rng = np.random.default_rng(seed)
    store = rng.standard_normal((n, d)).astype(np.float32)
    if dup:
        store[[40, 97, 200]] = store[7]          # four-way tie with row 7
        store[150] = store[3]
    valid = rng.random(n) > 0.2
    if dup:
        valid[[7, 40, 97, 200, 3, 150]] = True
    if live is not None:
        valid[:] = False
        valid[:live] = True
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries[1] = store[7]                        # the tied rows score top
    return store, queries, valid


def _jax_scan(store, queries, valid, k, masked):
    s, i = pallas_topk(jnp.asarray(store), jnp.asarray(queries),
                       jnp.asarray(valid), k, tile_n=128, interpret=True,
                       masked=masked)
    return np.asarray(s), np.asarray(i)


def _port_scan(store, queries, valid, k, masked):
    s, i = scan_topk(torch.from_numpy(store), torch.from_numpy(queries),
                     torch.from_numpy(valid), k, masked=masked)
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("masked", [True, False])
def test_scan_matches_pallas_kernel(k, masked):
    store, queries, valid = _case()
    want_s, want_i = _jax_scan(store, queries, valid, k, masked)
    got_s, got_i = _port_scan(store, queries, valid, k, masked)
    assert got_i.dtype == np.int32 and got_s.dtype == np.float32
    # ids identical, ties included: both rank equal scores by row id
    np.testing.assert_array_equal(got_i, want_i)
    # f32 dot products of 64 terms summed in another order
    np.testing.assert_allclose(got_s, want_s, atol=1e-6, rtol=0)
    assert list(got_i[1, :4]) == sorted(got_i[1, :4])


@pytest.mark.parametrize("k", [5, 64])
def test_masked_slots_are_neg_inf_with_id_zero(k):
    store, queries, valid = _case(live=3, dup=False)
    want_s, want_i = _jax_scan(store, queries, valid, k, True)
    got_s, got_i = _port_scan(store, queries, valid, k, True)
    np.testing.assert_array_equal(got_i, want_i)
    assert np.isneginf(got_s[:, 3:]).all() and (got_i[:, 3:] == 0).all()
    np.testing.assert_allclose(got_s[:, :3], want_s[:, :3], atol=1e-6)


@pytest.mark.parametrize("k,live", [(1, None), (5, None), (64, None),
                                    (5, 3)])
def test_scan_matches_xla_oracle_on_finite_slots(k, live):
    """The XLA oracle gives masked slots ids 0, 1, ... (lax.top_k over
    -inf) where K1 gives 0, so only finite slots are compared."""
    store, queries, valid = _case(live=live)
    want_s, want_i = batched_topk_scores(jnp.asarray(store),
                                         jnp.asarray(queries),
                                         jnp.asarray(valid), k)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    got_s, got_i = _port_scan(store, queries, valid, k, True)
    finite = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), finite)
    np.testing.assert_array_equal(got_i[finite], want_i[finite])
    np.testing.assert_allclose(got_s[finite], want_s[finite], atol=1e-6)


def test_k_beyond_store_pads_and_bf16_store():
    store, queries, valid = _case(n=8, d=32, dup=False)
    s, i = scan_topk_reference(torch.from_numpy(store).bfloat16(),
                               torch.from_numpy(queries),
                               torch.from_numpy(valid), 16)
    assert s.shape == (6, 16) and i.shape == (6, 16)
    assert np.isneginf(s[:, 8:].numpy()).all() and (i[:, 8:] == 0).all()
    # queries are cast to the store dtype before the product
    sb = torch.from_numpy(store).bfloat16().float()
    qb = torch.from_numpy(queries).bfloat16().float()
    top = (qb @ sb.T).masked_fill(~torch.from_numpy(valid), -np.inf)
    np.testing.assert_allclose(s[:, 0].numpy(), top.max(1).values.numpy(),
                               atol=1e-6)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    """A tensor off the CPU reaches the kernel path or raises: the plain
    version is chosen only by the tensor's device, and a failing kernel
    build surfaces as an exception."""
    called = []
    monkeypatch.setattr(scan_mod, "scan_topk_reference",
                        lambda *a, **k: called.append(1))
    store, q, valid = _meta(64, 32), _meta(2, 32), _meta(64, dtype=torch.bool)
    with pytest.raises(KernelError, match="CPU or CUDA"):
        scan_topk(store, q, valid, 5)
    monkeypatch.setattr(scan_mod, "_check", lambda *a: None)

    def failing_library(*a, **k):
        raise RuntimeError("kernel build failed: nvcc rc=1")
    monkeypatch.setattr(scan_mod._cuda, "library", failing_library)
    before = scan_topk.launches
    with pytest.raises(RuntimeError, match="kernel build failed"):
        scan_topk(store, q, valid, 5)
    assert not called and scan_topk.launches == before


def test_kernel_error_code_raises(monkeypatch):
    """A non-zero cudaError_t from the C entry point raises."""
    lib = types.SimpleNamespace(
        sema_cuda_error_string=lambda e: b"invalid configuration argument")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        scan_mod._cuda.check(lib, 9, "scan_topk")
    scan_mod._cuda.check(lib, 0, "scan_topk")


@pytest.mark.parametrize("n,nq,k", [(262_144, 1, 16), (262_144, 256, 128),
                                    (3_000, 1, 64), (100, 300, 1024)])
def test_chunk_plan_covers_rows(n, nq, k):
    qb = scan_mod._query_block(384, 2, k, nq)
    smem = scan_mod.pass1_smem_bytes(384, 2, k, nq)
    rows, chunks = scan_mod.chunk_plan(n, nq, qb, sms=132, smem=smem)
    assert rows % 64 == 0 and (chunks - 1) * rows < n <= chunks * rows
    per_sm = 2 if 2 * smem + 2048 <= 228 * 1024 else 1
    q_blocks = -(-nq // qb)
    assert chunks == 1 or chunks * q_blocks <= per_sm * 132   # one wave
    assert smem <= scan_mod._SMEM_MAX


@pytest.mark.parametrize("d,itemsize,k,whole", [
    (384, 2, 128, True), (1024, 2, 128, False),     # bf16: gte in two slabs
    (768, 4, 128, False), (1024, 4, 1024, False),   # f32 e5/gte: slabs
])
def test_slab_words_fit_shared_memory(d, itemsize, k, whole):
    """One query's pass 1. The tensor-core route (itemsize 2) double-
    buffers its slabs, so a gte-large bf16 row goes in two equal halves;
    the SIMT route stages f32 rows of the wider models in slabs of the
    most words that fit."""
    words = d * itemsize // 4
    slab = scan_mod.slab_words(d, itemsize, k, 1)
    assert slab % 4 == 0 and 4 <= slab <= words and (slab == words) == whole
    if itemsize == 2:
        assert slab % 8 == 0 and words % slab == 0   # equal whole k-steps
    assert scan_mod.pass1_smem_bytes(d, itemsize, k, 1) <= scan_mod._SMEM_MAX


@pytest.mark.parametrize("d,k,qb,whole", [(384, 10, 64, True),
                                          (384, 128, 64, False),
                                          (1024, 16, 64, False),
                                          (1024, 128, 32, False),
                                          (384, 1024, 16, False)])
def test_batch_query_block(d, k, qb, whole):
    """At Q 256 the bf16 route takes the most of 64, 32, 16 and 8 queries
    a block (the store read 256 / qb times, the query blocks of a chunk
    side by side in the grid) beside which slabs of 64 elements still fit:
    at k 1,024 16, where lists of 8 queries alone once left room; f32
    keeps 16 (4 above k 128)."""
    assert scan_mod._query_block(d, 2, k, 256) == qb
    assert scan_mod._query_block(d, 2, k, 8) == 8
    assert scan_mod._query_block(d, 4, k, 256) == (16 if k <= 128 else 4)
    slab = scan_mod.slab_words(d, 2, k, 256)
    assert slab >= 8 and (slab == d // 2) == whole
    assert scan_mod.pass1_smem_bytes(d, 2, k, 256) <= scan_mod._SMEM_MAX
    smem = scan_mod.pass1_smem_bytes(d, 2, k, 256)
    rows, chunks = scan_mod.chunk_plan(1 << 20, 256, qb, sms=132, smem=smem)
    q_blocks = 256 // qb
    per_sm = 2 if 2 * smem + 2048 <= 228 * 1024 else 1
    assert chunks * q_blocks <= per_sm * 132 < (chunks + 1) * q_blocks
    assert (chunks - 1) * rows < 1 << 20 <= chunks * rows