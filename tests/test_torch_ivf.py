"""IVF and int8 stores of the port against the JAX package's, on the CPU.

``sema_tpu_torch.ops.ivf`` against ``sema_tpu.ops.ivf`` (k-means on the
same rows; the numpy layout and probe), then whole stores: an int8 (and a
bf16) IVF store written by either package opens in the other, loads the
other's sidecar instead of re-clustering, and answers with the same ids.
The JAX package runs its Pallas kernels in interpret mode
(``SEMA_TPU_SCAN_BACKEND=pallas``); both use tiles of 128 rows and seal at
2,048 rows, so that a sealed bucket pads to the same 2,048 rows in both
and has 16 clusters and a budget of 4 tiles."""

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.ops import ivf as jax_ivf
from sema_tpu.types import Chunk as JaxChunk
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.ops import ivf
from sema_tpu_torch.types import Chunk

store_mod = importlib.import_module("sema_tpu_torch.index.vector_store")
DIM = 64
MODEL = "test-ivf"
SEALED = 2048


def clustered(n, d=DIM, centres=40, seed=0, noise=0.6):
    """Unit rows drawn around ``centres`` random unit centres."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centres, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = (c[rng.integers(0, centres, n)]
         + noise * rng.standard_normal((n, d)).astype(np.float32)
         / np.sqrt(d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _chunks(cls, n, first):
    return [cls(id=f"c{first + i}", file_path=Path(f"/src/f{i % 7}.py"),
                start_line=i + 1, end_line=i + 2, content=f"row {first + i}")
            for i in range(n)]


@pytest.fixture()
def ivf_env(monkeypatch):
    monkeypatch.setenv("SEMA_TPU_SCAN_BACKEND", "pallas")
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "2")
    for cls in (JaxStore, VectorStore):
        monkeypatch.setattr(cls, "SEAL_ROWS", SEALED)
        monkeypatch.setattr(cls, "IVF_TILE", 128)
        monkeypatch.setattr(cls, "IVF_CLUSTER_ROWS", 128)


ROWS = clustered(SEALED + 100)
QUERIES = np.concatenate([ROWS[[5, 1500, 2090]],        # planted rows
                          clustered(2, seed=7)])


def _fill(store, cls):
    store.add_chunks(_chunks(cls, SEALED, 0), ROWS[:SEALED])   # sealed
    store.add_chunks(_chunks(cls, 100, SEALED), ROWS[SEALED:])  # tail


def _answers(store, k=10):
    """One query at a time (a batch unions its probes), each query's
    scores and ids."""
    out = [store.search_batch(QUERIES[i:i + 1], k) for i in
           range(len(QUERIES))]
    return (np.concatenate([s for s, _ in out]),
            np.concatenate([np.asarray(i, dtype=np.int64) for _, i in out]))


class _Calls:
    """Records which scan wrappers the port's store calls."""

    def __init__(self, monkeypatch):
        self.names = []
        for name in ("scan_topk", "scan_topk_int8", "scan_topk_pruned",
                     "scan_topk_int8_pruned"):
            fn = getattr(store_mod, name)
            monkeypatch.setattr(store_mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*a, **k):
            self.names.append(name)
            return fn(*a, **k)
        return call


def _port(tmp_path, dtype, **kw):
    return VectorStore(tmp_path, DIM, MODEL, store_dtype=dtype,
                       device="cpu", ivf=True, **kw)


def _jax(tmp_path, dtype):
    return JaxStore(tmp_path, DIM, MODEL, store_dtype=dtype, ivf=True)


# -- ops/ivf.py -------------------------------------------------------------

@pytest.mark.parametrize("n,c,pad,dtype", [
    (4096, 32, 0, torch.float32), (4096, 16, 1000, torch.bfloat16),
    (3000, 40, 0, torch.float32)])
def test_kmeans_matches_the_jax_package(n, c, pad, dtype):
    """Same init, same Lloyd steps, same overflow id: the assignments
    agree on at least 99% of the rows (a row on a boundary may go either
    way, the two sum in another order; all agreed when measured) and the
    centroids within 1e-5."""
    x = clustered(n, centres=64, seed=n)
    if pad:
        x[-pad:] = 0.0                           # bucket padding
    xt = torch.from_numpy(x).to(dtype)
    got_a, got_c = ivf.kmeans_cluster(xt, c)
    want_a, want_c = jax_ivf.kmeans_cluster(
        jnp.asarray(xt.float().numpy(), dtype=jnp.bfloat16
                    if dtype == torch.bfloat16 else jnp.float32), c)
    got_a = got_a.numpy()
    assert got_a.dtype == np.int32 and got_a.shape == (n,)
    assert (got_a == np.asarray(want_a)).mean() >= 0.99
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)
    if pad:
        assert (got_a[-pad:] == c).all()         # the overflow cluster
    assert got_c.shape == (c, DIM)


def test_layout_and_probe_identical():
    rng = np.random.default_rng(1)
    assign = rng.integers(0, 17, 2048)
    got = ivf.cluster_layout(assign, 18)
    want = jax_ivf.cluster_layout(assign, 18)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    cent = clustered(16, seed=2)
    cent[3] = 0.0                                # a dead centroid
    starts = got[1]
    queries = clustered(3, seed=3)
    for nprobe, budget in ((2, 4), (3, 16), (16, 16), (16, 2)):
        g = ivf.select_tiles(cent, starts, queries, nprobe, 128, budget)
        w = jax_ivf.select_tiles(cent, starts, queries, nprobe, 128, budget)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1]


# -- stores, both ways -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_jax_written_ivf_store_answers_in_the_port(tmp_path, ivf_env,
                                                   monkeypatch, dtype):
    js = _jax(tmp_path, dtype)
    _fill(js, JaxChunk)
    want = _answers(js)
    sidecar = [b["ivf"] for b in js.device_buckets() if b.get("ivf")]
    assert len(sidecar) == 1 and any(k[0] == "ivf" for k in js._topk_fns)
    js.close()

    def no_kmeans(*a, **k):
        raise AssertionError("the port re-clustered a bucket whose "
                             "sidecar the JAX package wrote")
    monkeypatch.setattr(store_mod, "kmeans_cluster", no_kmeans)
    calls = _Calls(monkeypatch)
    ps = _port(tmp_path, dtype)
    got = _answers(ps)
    (b,) = [b for b in ps.device_buckets() if b["ivf"] is not None]
    np.testing.assert_array_equal(b["ivf"]["perm"], sidecar[0]["perm"])
    assert b["n_pad"] == SEALED and b["ivf"]["centroids"].shape == (16, DIM)
    # a query whose probe fits the 4-tile budget takes the pruned scan
    fits = sum(ivf.select_tiles(b["ivf"]["centroids"], b["ivf"]["starts"],
                                QUERIES[i:i + 1], 2, 128, 4) is not None
               for i in range(len(QUERIES)))
    pruned = "scan_topk_int8_pruned" if dtype == "int8" else \
        "scan_topk_pruned"
    assert fits >= 3 and calls.names.count(pruned) == fits
    np.testing.assert_array_equal(got[1], want[1])
    if dtype == "int8":       # scores from the same f32 rescore
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    else:
        np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-5)
    assert list(got[1][:3, 0]) == [5, 1500, 2090]   # planted rows first
    ps.close()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_port_written_ivf_store_answers_in_jax(tmp_path, ivf_env,
                                               monkeypatch, dtype):
    ps = _port(tmp_path, dtype)
    _fill(ps, Chunk)
    want = _answers(ps)
    perm = [b["ivf"]["perm"] for b in ps.device_buckets() if b["ivf"]]
    ps.close()

    def no_kmeans(*a, **k):
        raise AssertionError("the JAX package re-clustered a bucket whose "
                             "sidecar the port wrote")
    monkeypatch.setattr(jax_ivf, "kmeans_cluster", no_kmeans)
    js = _jax(tmp_path, dtype)
    got = _answers(js)
    (b,) = [b for b in js.device_buckets() if b.get("ivf")]
    np.testing.assert_array_equal(b["ivf"]["perm"], perm[0])
    assert any(k[0] == "ivf" for k in js._topk_fns)
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])
    js.close()


# -- routing ------------------------------------------------------------------

def _exact_answers(tmp_path, k=10):
    ps = VectorStore(tmp_path, DIM, MODEL, store_dtype="int8", device="cpu")
    out = _answers(ps, k)
    ps.close()
    return out


def test_over_budget_probe_takes_the_exact_scan(tmp_path, ivf_env,
                                                monkeypatch):
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "16")       # every cluster
    monkeypatch.setattr(VectorStore, "IVF_BUDGET_DIV", 4096)  # 2 tiles
    ps = _port(tmp_path, "int8")
    _fill(ps, Chunk)
    calls = _Calls(monkeypatch)
    got = _answers(ps)
    assert calls.names == ["scan_topk_int8"] * (2 * len(QUERIES))
    ps.close()
    want = _exact_answers(tmp_path)
    np.testing.assert_array_equal(got[1], want[1])


def test_k_above_128_and_exact_take_the_exact_scan(tmp_path, ivf_env,
                                                   monkeypatch):
    ps = _port(tmp_path, "int8")
    _fill(ps, Chunk)
    calls = _Calls(monkeypatch)
    wide = ps.search_batch(QUERIES[:1], 200)             # k class 1024
    assert calls.names == ["scan_topk_int8"] * 2
    calls.names.clear()
    exact = [ps.search(QUERIES[i], 10, exact=True)
             for i in range(len(QUERIES))]
    assert calls.names == ["scan_topk_int8"] * (2 * len(QUERIES))
    calls.names.clear()
    ps.ivf_nprobe = 1                    # a probe inside the budget
    ps.search(QUERIES[0], 10)
    assert calls.names == ["scan_topk_int8_pruned", "scan_topk_int8"]
    ps.close()
    want = _exact_answers(tmp_path, 200)
    np.testing.assert_array_equal(wide[1][0], want[1][0])
    assert [[int(c.id[1:]) for c, _ in hits] for hits in exact] == \
        want[1][:, :10].tolist()


def test_min_recall_above_the_frontier_routes_exact(tmp_path, ivf_env,
                                                    monkeypatch):
    assert VectorStore.nprobe_for_recall(0.94) == 32
    assert VectorStore.nprobe_for_recall(0.97) is None
    monkeypatch.delenv("SEMA_TPU_IVF_NPROBE")
    ps = _port(tmp_path, "int8", ivf_min_recall=0.95)
    assert ps.ivf_nprobe == 64 and not ps._ivf_route_exact
    ps.close()
    ps = _port(tmp_path, "int8", ivf_min_recall=0.99)
    _fill(ps, Chunk)
    calls = _Calls(monkeypatch)
    ps.search(QUERIES[0], 10)
    assert calls.names == ["scan_topk_int8"] * 2
    ps.close()


def test_tombstones_respected_through_the_probe(tmp_path, ivf_env,
                                                monkeypatch):
    ps = _port(tmp_path, "int8")
    ps.ivf_nprobe = 1                    # a probe inside the budget
    _fill(ps, Chunk)
    assert ps.search(QUERIES[0], 1)[0][0].id == "c5"
    removed = ps.remove_file_chunks("/src/f5.py")        # row 5 is f5's
    assert removed > 0
    calls = _Calls(monkeypatch)
    hits = ps.search(QUERIES[0], 10)
    assert calls.names[0] == "scan_topk_int8_pruned"
    assert hits and all(c.file_path != Path("/src/f5.py") for c, _ in hits)
    (b,) = [b for b in ps.device_buckets() if b["ivf"] is not None]
    live = b["valid"].numpy()
    assert not live[np.argsort(b["ivf"]["perm"])[5]]   # permuted mask
    assert live.sum() == SEALED - sum(1 for i in range(SEALED) if i % 7 == 5)
    ps.close()
