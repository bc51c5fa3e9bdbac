"""The port's store row-sharded over a mesh (``VectorStore(mesh=)``) on
``["cpu"] * 8``, held against the JAX package's on its 8 virtual CPU
devices: the mirrors of ``tests/test_vector_store.py::
test_mesh_sharded_store``, ``tests/test_quant.py::test_int8_mesh_sharded``,
``tests/test_ivf_store.py::TestMeshIVF`` and
``tests/test_multislice_store.py``; exact bf16 and int8 stores with their
rescore against the JAX package's sharded stores on the same rows; IVF
stores clustered per shard by either package, each opened in the other
(its k-means patched to raise) and answering the same ids through the
pruned route (the JAX side with ``SEMA_TPU_SCAN_BACKEND=pallas``, whose
2,048-row shard unit gives the same padded size at 9,000 rows); the
features a mesh turns off; and a store without a mesh as before."""

import importlib
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.ops import ivf as jax_ivf
from sema_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sema_tpu.types import Chunk as JaxChunk
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.ops import ivf
from sema_tpu_torch.parallel.mesh import make_mesh
from sema_tpu_torch.types import Chunk

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")

store_mod = importlib.import_module("sema_tpu_torch.index.vector_store")
SCANS = ("scan_topk", "scan_topk_int8", "scan_topk_pruned",
         "scan_topk_int8_pruned")


def chunks_and_vecs(n, d=128, path="f.txt", seed=0, start=0, cls=Chunk):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    cs = [cls(id=f"{path}:{start + i}", file_path=Path(path),
              start_line=i + 1, end_line=i + 2, content=f"content {start + i}")
          for i in range(n)]
    return cs, vecs


def cpu_mesh(shape=(1, 8), axes=("data", "index")):
    return make_mesh(list(shape), axes,
                     devices=["cpu"] * int(np.prod(shape)))


def ms_mesh():
    return cpu_mesh((2, 4), ("slice", "index"))


def make_store(tmp_path, d=128, mesh="flat", **kw):
    mesh = cpu_mesh() if mesh == "flat" else mesh
    return VectorStore(tmp_path, dim=d, model="test-tiny", device="cpu",
                       mesh=mesh, **kw)


class Calls:
    """The store's scan wrappers, each call recorded with the rows of the
    block it scans."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in SCANS:
            def call(*a, _fn=getattr(store_mod, name), _name=name, **k):
                self.calls.append((_name, a[0].shape[0]))
                return _fn(*a, **k)
            monkeypatch.setattr(store_mod, name, call)

    def names(self):
        return [n for n, _ in self.calls]


def _finite(s, i):
    return [list(np.asarray(r)[np.isfinite(x)]) for x, r in zip(s, i)]


# -- exact stores (test_mesh_sharded_store, test_int8_mesh_sharded) ----------

def test_mesh_sharded_store(tmp_path, monkeypatch):
    store = make_store(tmp_path)
    cs, vecs = chunks_and_vecs(500)
    store.add_chunks(cs, vecs)
    calls = Calls(monkeypatch)
    results = store.search(vecs[123], k=5)
    assert results[0][0].id == "f.txt:123"
    # the rows really lie in 8 blocks of the padded 1,024, a K1 each
    (b,) = store.device_buckets()
    assert store._shards() == 8 and b["n_pad"] == 1024
    assert [t.shape for t in b["store"]] == [(128, 128)] * 8
    assert [v.shape for v in b["valid"]] == [(128,)] * 8
    assert calls.calls == [("scan_topk", 128)] * 8
    store.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_exact_store_answers_as_the_jax_sharded_store(tmp_path, dtype):
    """The same rows, tombstones and queries through both packages'
    8-shard stores: the same ids (the int8 store's after its rescore, at
    rescore_k 50) and scores within 1e-6 (the int8 rescore's bit-equal);
    a k above 128 (the hierarchical route on each shard) too."""
    cs, vecs = chunks_and_vecs(600, d=32)
    jcs, _ = chunks_and_vecs(600, d=32, cls=JaxChunk)
    files = [f"/src/f{i % 6}.py" for i in range(600)]
    for c, jc, f in zip(cs, jcs, files):
        c.file_path, jc.file_path = Path(f), Path(f)
    port = make_store(tmp_path / "port", d=32, store_dtype=dtype,
                      rescore_k=50)
    jax_store = JaxStore(tmp_path / "jax", dim=32, model="test-tiny",
                         store_dtype=dtype, mesh=jax_make_mesh(),
                         rescore_k=50)
    for store, chunks in ((port, cs), (jax_store, jcs)):
        store.add_chunks(chunks[:400], vecs[:400])
        store.add_chunks(chunks[400:], vecs[400:])
        assert store.remove_file_chunks("/src/f2.py") == 100
    queries = np.concatenate([vecs[[7, 321, 599]],
                              chunks_and_vecs(3, d=32, seed=9)[1]])
    for k in (10, 200):
        got = port.search_batch(queries, k)
        want = jax_store.search_batch(queries, k)
        assert _finite(*got) == _finite(*want)
        exact = dtype == "int8"
        np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                   atol=0 if exact else 1e-6, rtol=0)
    assert port.search(vecs[321], k=5)[0][0].id == "f.txt:321"
    port.close()
    jax_store.close()


def test_int8_mesh_sharded(tmp_path):
    store = VectorStore(tmp_path, dim=32, model="m", store_dtype="int8",
                        device="cpu", mesh=cpu_mesh(), rescore_k=50)
    cs, vecs = chunks_and_vecs(600, d=32)
    store.add_chunks(cs, vecs)
    assert store.search(vecs[321], k=5)[0][0].id == "f.txt:321"
    (b,) = store.device_buckets()
    assert all(q.dtype == torch.int8 and s.shape == (128,)
               for q, s in b["store"])
    store.close()


# -- multislice (tests/test_multislice_store.py) ------------------------------

def test_multislice_exact_search(tmp_path, monkeypatch):
    store = make_store(tmp_path, mesh=ms_mesh(), slice_axis="slice")
    assert store._shards() == 8 and store._row_axes() == ("slice", "index")
    cs, vecs = chunks_and_vecs(500)
    store.add_chunks(cs, vecs)
    calls = Calls(monkeypatch)
    for row in (3, 123, 321, 499):
        res = store.search(vecs[row], k=3)
        assert res[0][0].id == f"f.txt:{row}"
        assert res[0][1] == pytest.approx(1.0, abs=1e-2)
    assert calls.names() == ["scan_topk"] * 32
    store.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_multislice_matches_flat_and_jax(tmp_path, dtype):
    """The two-level merge through the store answers as the flat merge
    over the same 8 shards, and as the JAX package's multislice store."""
    cs, vecs = chunks_and_vecs(400, seed=5)
    jcs, _ = chunks_and_vecs(400, seed=5, cls=JaxChunk)
    ms = make_store(tmp_path / "ms", mesh=ms_mesh(), slice_axis="slice",
                    store_dtype=dtype)
    flat = make_store(tmp_path / "flat", store_dtype=dtype)
    js = JaxStore(tmp_path / "jax", dim=128, model="test-tiny",
                  store_dtype=dtype, slice_axis="slice",
                  mesh=jax_make_mesh(shape=[2, 4],
                                     axis_names=("slice", "index")))
    for store, chunks in ((ms, cs), (flat, cs), (js, jcs)):
        store.add_chunks(chunks, vecs)
    queries = vecs[7:11]
    s_ms, i_ms = ms.search_batch(queries, k=10)
    s_fl, i_fl = flat.search_batch(queries, k=10)
    s_j, i_j = js.search_batch(queries, k=10)
    np.testing.assert_array_equal(i_ms, i_fl)
    np.testing.assert_array_equal(s_ms, s_fl)
    np.testing.assert_array_equal(i_ms, np.asarray(i_j))
    np.testing.assert_allclose(s_ms, np.asarray(s_j), atol=1e-6, rtol=0)
    for store in (ms, flat, js):
        store.close()


def test_multislice_cli_shaped_mesh(tmp_path):
    """(slice, data, index), as the CLI builds it: data repeats."""
    mesh = cpu_mesh((2, 1, 4), ("slice", "data", "index"))
    store = make_store(tmp_path, mesh=mesh, slice_axis="slice")
    cs, vecs = chunks_and_vecs(300, seed=3)
    store.add_chunks(cs, vecs)
    assert store.search(vecs[42], k=2)[0][0].id == "f.txt:42"
    assert store._shards() == 8
    store.close()


def test_slice_axis_ignored_when_absent(tmp_path):
    store = make_store(tmp_path, slice_axis="slice")
    assert store.slice_axis is None and store._shards() == 8
    cs, vecs = chunks_and_vecs(200, seed=4)
    store.add_chunks(cs, vecs)
    assert store.search(vecs[9], k=1)[0][0].id == "f.txt:9"
    store.close()


@pytest.mark.parametrize("mesh", ["flat", "slice"])
def test_mesh_tombstones(tmp_path, mesh):
    kw = ({"mesh": ms_mesh(), "slice_axis": "slice"} if mesh == "slice"
          else {})
    store = make_store(tmp_path, **kw)
    cs_a, v_a = chunks_and_vecs(250, path="a.txt", seed=6)
    cs_b, v_b = chunks_and_vecs(250, path="b.txt", seed=7)
    store.add_chunks(cs_a, v_a)
    store.add_chunks(cs_b, v_b)
    assert store.search(v_a[11], k=1)[0][0].id == "a.txt:11"
    assert store.remove_file_chunks("a.txt") == 250
    assert store.search(v_a[11], k=1)[0][0].id != "a.txt:11"
    assert store.search(v_b[11], k=1)[0][0].id == "b.txt:11"
    # the new masks went to each shard: b's 250 rows live, a's none
    (b,) = store.device_buckets()
    assert sum(int(v.sum()) for v in b["valid"]) == 250
    store.close()


# -- IVF on a mesh (TestMeshIVF, TestMultisliceIVF) ---------------------------

@pytest.fixture()
def ivf_env(monkeypatch):
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 256)
    monkeypatch.setattr(VectorStore, "IVF_TILE", 128)
    monkeypatch.setattr(VectorStore, "IVF_CLUSTER_ROWS", 128)
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "3")


def _ivf_buckets(store):
    return [b for b in store.device_buckets() if b.get("ivf") is not None]


def test_per_shard_clustering_block_local(tmp_path, ivf_env):
    """1,100 rows pad to 2,048, 256 a shard (two tiles): shards 0-3 full,
    shard 4 part, shards 5-7 all padding."""
    store = make_store(tmp_path, ivf=True)
    cs, vecs = chunks_and_vecs(1100, seed=10)
    store.add_chunks(cs, vecs)
    (b,) = _ivf_buckets(store)
    iv = b["ivf"]
    assert iv["centroids"].shape == (8, 16, 128)      # (shards, C, d)
    assert iv["starts"].shape == (8, 18)
    sr = b["n_pad"] // 8
    assert b["n_pad"] == 2048 and sr == 256
    for s in range(8):                     # the permutation stays in-block
        blk = iv["perm"][s * sr:(s + 1) * sr]
        assert sorted(blk.tolist()) == list(range(s * sr, (s + 1) * sr))
    assert iv["starts"][:, 16].tolist() == [256] * 4 + [76, 0, 0, 0]
    store.close()


@pytest.mark.parametrize("mesh", ["flat", "slice"])
def test_planted_winners_across_shards(tmp_path, ivf_env, monkeypatch,
                                       mesh):
    # 8 tiles a shard, each admissible: every probe takes the pruned scan
    monkeypatch.setattr(VectorStore, "IVF_BUDGET_DIV", 1)
    kw = ({"mesh": ms_mesh(), "slice_axis": "slice"} if mesh == "slice"
          else {})
    store = make_store(tmp_path, ivf=True, **kw)
    cs, vecs = chunks_and_vecs(4400, seed=11)
    store.add_chunks(cs, vecs)
    assert _ivf_buckets(store)[0]["ivf"]["centroids"].shape[0] == 8
    calls = Calls(monkeypatch)
    for row in (100, 2500, 4300):              # shards 0, 4, 7 of 8
        res = store.search(vecs[row], k=1)
        assert res[0][0].id == f"f.txt:{row}"
        assert res[0][1] == pytest.approx(1.0, abs=1e-2)
    assert calls.names() == ["scan_topk_pruned"] * 24
    store.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_full_probe_matches_exact(tmp_path, ivf_env, monkeypatch, dtype):
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "4096")
    monkeypatch.setattr(VectorStore, "IVF_BUDGET_DIV", 1)
    store = make_store(tmp_path, ivf=True, store_dtype=dtype)
    cs, vecs = chunks_and_vecs(1100, seed=12)
    store.add_chunks(cs, vecs)
    queries = vecs[[40, 300, 700, 1099]]
    calls = Calls(monkeypatch)
    s_ivf, i_ivf = store.search_batch(queries, k=5)
    pruned = ("scan_topk_int8_pruned" if dtype == "int8"
              else "scan_topk_pruned")
    assert calls.names() == [pruned] * 8
    s_ex, i_ex = store.search_batch(queries, k=5, exact=True)
    exact = make_store(tmp_path, ivf=False, store_dtype=dtype)
    s_pl, i_pl = exact.search_batch(queries, k=5)
    np.testing.assert_array_equal(i_ivf, i_ex)
    np.testing.assert_array_equal(i_ivf, i_pl)
    np.testing.assert_allclose(s_ivf, s_pl, atol=1e-6, rtol=0)
    exact.close()
    store.close()


def test_over_budget_shard_sends_the_bucket_to_the_exact_scan(
        tmp_path, ivf_env, monkeypatch):
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "4096")
    monkeypatch.setattr(VectorStore, "IVF_BUDGET_DIV", 4)
    store = make_store(tmp_path, ivf=True)      # 8 tiles a shard, budget 2
    cs, vecs = chunks_and_vecs(4400, seed=12)
    store.add_chunks(cs, vecs)
    calls = Calls(monkeypatch)
    assert store.search(vecs[17], k=3)[0][0].id == "f.txt:17"
    assert calls.names() == ["scan_topk"] * 8
    store.close()


def test_ivf_tombstones_respected(tmp_path, ivf_env):
    store = make_store(tmp_path, ivf=True)
    cs, vecs = chunks_and_vecs(1100, path="a.txt", seed=13)
    store.add_chunks(cs, vecs)
    assert _ivf_buckets(store)
    assert store.remove_file_chunks("a.txt") == 1100
    assert store.search(vecs[11], k=2) == []
    store.close()


# -- sidecars of either package, on 8 shards ----------------------------------

SEALED = 9000      # pads to 16,384 rows in both: 8 x 2,048 (JAX's pallas unit)


@pytest.fixture()
def cross_env(monkeypatch):
    monkeypatch.setenv("SEMA_TPU_SCAN_BACKEND", "pallas")
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "2")
    for cls in (JaxStore, VectorStore):
        monkeypatch.setattr(cls, "SEAL_ROWS", 8192)
        monkeypatch.setattr(cls, "IVF_TILE", 128)
        monkeypatch.setattr(cls, "IVF_CLUSTER_ROWS", 128)
        monkeypatch.setattr(cls, "IVF_BUDGET_DIV", 2)


def _cross_fill(store, cls, vecs):
    cs, _ = chunks_and_vecs(SEALED, d=64, cls=cls)
    store.add_chunks(cs[:SEALED], vecs)


def _cross_answers(store, queries, k=10):
    out = [store.search_batch(queries[i:i + 1], k)
           for i in range(len(queries))]
    return (np.concatenate([s for s, _ in out]),
            np.concatenate([np.asarray(i, dtype=np.int64) for _, i in out]))


def _cross_case():
    rng = np.random.default_rng(3)
    cent = rng.standard_normal((60, 64)).astype(np.float32)
    rows = cent[rng.integers(0, 60, SEALED)] + 0.08 * rng.standard_normal(
        (SEALED, 64)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    queries = np.concatenate([rows[[5, 2100, 4500, 8999]],
                              rng.standard_normal((2, 64)).astype(
                                  np.float32)])
    return rows, queries / np.linalg.norm(queries, axis=1, keepdims=True)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_jax_sharded_ivf_store_answers_in_the_port(tmp_path, cross_env,
                                                   monkeypatch, dtype):
    rows, queries = _cross_case()
    js = JaxStore(tmp_path, 64, "test-ivf", store_dtype=dtype, ivf=True,
                  mesh=jax_make_mesh())
    _cross_fill(js, JaxChunk, rows)
    want = _cross_answers(js, queries)
    (jb,) = [b for b in js.device_buckets() if b.get("ivf")]
    assert jb["n_pad"] == 16384 and any(k[0] == "ivf" for k in js._topk_fns)
    js.close()

    def no_kmeans(*a, **k):
        raise AssertionError("the port re-clustered a bucket whose "
                             "sidecar the JAX package wrote")
    monkeypatch.setattr(store_mod, "kmeans_cluster", no_kmeans)
    ps = VectorStore(tmp_path, 64, "test-ivf", store_dtype=dtype, ivf=True,
                     device="cpu", mesh=cpu_mesh())
    calls = Calls(monkeypatch)
    got = _cross_answers(ps, queries)
    (b,) = _ivf_buckets(ps)
    np.testing.assert_array_equal(b["ivf"]["perm"], jb["ivf"]["perm"])
    assert b["ivf"]["centroids"].shape == (8, 16, 64)
    pruned = ("scan_topk_int8_pruned" if dtype == "int8"
              else "scan_topk_pruned")
    # every query through the probe: 8 shards, 3 of them all padding
    assert calls.names() == [pruned] * (8 * len(queries))
    np.testing.assert_array_equal(got[1], want[1])
    if dtype == "int8":
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    assert list(got[1][:4, 0]) == [5, 2100, 4500, 8999]
    ps.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_port_sharded_ivf_store_answers_in_jax(tmp_path, cross_env,
                                               monkeypatch, dtype):
    rows, queries = _cross_case()
    ps = VectorStore(tmp_path, 64, "test-ivf", store_dtype=dtype, ivf=True,
                     device="cpu", mesh=cpu_mesh())
    _cross_fill(ps, Chunk, rows)
    want = _cross_answers(ps, queries)
    (b,) = _ivf_buckets(ps)
    perm = b["ivf"]["perm"]
    ps.close()

    def no_kmeans(*a, **k):
        raise AssertionError("the JAX package re-clustered a bucket whose "
                             "sidecar the port wrote")
    monkeypatch.setattr(jax_ivf, "kmeans_cluster", no_kmeans)
    js = JaxStore(tmp_path, 64, "test-ivf", store_dtype=dtype, ivf=True,
                  mesh=jax_make_mesh())
    got = _cross_answers(js, queries)
    (jb,) = [b for b in js.device_buckets() if b.get("ivf")]
    np.testing.assert_array_equal(jb["ivf"]["perm"], perm)
    assert any(k[0] == "ivf" for k in js._topk_fns)
    np.testing.assert_array_equal(got[1], want[1])
    js.close()


def test_single_shard_sidecar_is_not_read_on_a_mesh(tmp_path, ivf_env,
                                                    monkeypatch):
    """The sidecar key carries the shard count: a store clustered on one
    device re-clusters per shard when it opens on a mesh, and answers the
    same exact ids; reopened on the mesh, it reads its own sidecar."""
    cs, vecs = chunks_and_vecs(1100, seed=14)
    single = VectorStore(tmp_path, 128, "test-tiny", device="cpu", ivf=True)
    single.add_chunks(cs, vecs)
    assert _ivf_buckets(single)[0]["ivf"]["centroids"].ndim == 2
    want = single.search_batch(vecs[:5], 10, exact=True)
    single.close()
    runs = []
    monkeypatch.setattr(store_mod, "kmeans_cluster",
                        lambda *a, **k: runs.append(1) or ivf.kmeans_cluster(
                            *a, **k))
    sharded = make_store(tmp_path, ivf=True)
    got = sharded.search_batch(vecs[:5], 10, exact=True)
    assert len(runs) == 8 and len(list((tmp_path / "vector_index").glob(
        "ivf-*.bin"))) == 2
    np.testing.assert_array_equal(got[1], want[1])
    sharded.close()
    again = make_store(tmp_path, ivf=True)
    np.testing.assert_array_equal(again.search_batch(vecs[:5], 10,
                                                     exact=True)[1], want[1])
    assert len(runs) == 8
    again.close()


def tp_mesh():
    """The CLI's tensor-parallel mesh, ``[mesh] model_axis`` with shape
    [1, 2, 1]: one shard of rows."""
    return cpu_mesh((1, 2, 1), ("data", "model", "index"))


def _one_shard_answers(store, queries, monkeypatch):
    """The store's answers, every query through the pruned route (K3, or
    K4b for int8), and its one IVF bucket's layout, which must be the
    single-device one: (C, d) centroids and (C + 2,) starts."""
    calls = Calls(monkeypatch)
    got = _cross_answers(store, queries)
    assert set(calls.names()) <= {"scan_topk_pruned",
                                  "scan_topk_int8_pruned"}
    assert len(calls.names()) == len(queries)
    (b,) = _ivf_buckets(store)
    assert b["ivf"]["centroids"].ndim == 2 and b["ivf"]["starts"].ndim == 1
    return got, b["ivf"]["perm"]


@pytest.mark.parametrize("first", ["mesh", "none"])
def test_one_shard_mesh_keeps_the_single_device_layout(tmp_path, cross_env,
                                                       monkeypatch, first):
    """An IVF store clustered on a one-shard mesh writes the single-device
    sidecar under the same key, and the other side (no mesh, or the mesh)
    opens it without k-means and answers the same ids through the
    probe."""
    rows, queries = _cross_case()
    meshes = {"mesh": tp_mesh(), "none": None}
    order = [first, "none" if first == "mesh" else "mesh"]
    a = VectorStore(tmp_path, 64, "test-ivf", ivf=True, device="cpu",
                    mesh=meshes[order[0]])
    _cross_fill(a, Chunk, rows)
    want, perm = _one_shard_answers(a, queries, monkeypatch)
    a.close()

    def no_kmeans(*a, **k):
        raise AssertionError("re-clustered a one-shard layout")
    monkeypatch.setattr(store_mod, "kmeans_cluster", no_kmeans)
    b = VectorStore(tmp_path, 64, "test-ivf", ivf=True, device="cpu",
                    mesh=meshes[order[1]])
    got, perm_b = _one_shard_answers(b, queries, monkeypatch)
    np.testing.assert_array_equal(perm_b, perm)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    assert list(got[1][:4, 0]) == [5, 2100, 4500, 8999]
    b.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_one_shard_mesh_ivf_store_opens_in_the_other_package(
        tmp_path, cross_env, monkeypatch, writer):
    """The port's IVF store on a one-shard mesh and ``sema_tpu``'s without
    one share their sidecar: either package's layout opens in the other
    without k-means and answers the same ids through its probe."""
    rows, queries = _cross_case()
    if writer == "port":
        ps = VectorStore(tmp_path, 64, "test-ivf", ivf=True, device="cpu",
                         mesh=tp_mesh())
        _cross_fill(ps, Chunk, rows)
        want, perm = _one_shard_answers(ps, queries, monkeypatch)
        ps.close()
        monkeypatch.setattr(jax_ivf, "kmeans_cluster", lambda *a, **k: 1 / 0)
        js = JaxStore(tmp_path, 64, "test-ivf", ivf=True)
        got = _cross_answers(js, queries)
        (jb,) = [b for b in js.device_buckets() if b.get("ivf")]
        assert any(k[0] == "ivf" for k in js._topk_fns)
        np.testing.assert_array_equal(jb["ivf"]["perm"], perm)
        js.close()
    else:
        js = JaxStore(tmp_path, 64, "test-ivf", ivf=True)
        _cross_fill(js, JaxChunk, rows)
        want = _cross_answers(js, queries)
        (jb,) = [b for b in js.device_buckets() if b.get("ivf")]
        js.close()
        monkeypatch.setattr(store_mod, "kmeans_cluster", lambda *a, **k: 1 / 0)
        ps = VectorStore(tmp_path, 64, "test-ivf", ivf=True, device="cpu",
                         mesh=tp_mesh())
        got, perm = _one_shard_answers(ps, queries, monkeypatch)
        np.testing.assert_array_equal(perm, jb["ivf"]["perm"])
        ps.close()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)


# -- what a mesh turns off, and a store without one ---------------------------

def test_spill_and_oom_degrade_off_on_a_mesh(tmp_path, monkeypatch):
    """A budget that spills every sealed bucket on one device spills none
    on a mesh, and an OOM in a bucket build raises there."""
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 128)
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "0.000001")
    cs, vecs = chunks_and_vecs(400, d=32)
    one = VectorStore(tmp_path / "one", 32, "m", device="cpu")
    one.add_chunks(cs, vecs)
    assert all(b.get("host_resident") for b in one.device_buckets())
    one.close()
    store = make_store(tmp_path / "mesh", d=32)
    store.add_chunks(cs, vecs)
    buckets = store.device_buckets()
    assert not any(b.get("host_resident") for b in buckets)
    assert store.device_residency()["host_buckets"] == 0
    assert store.search(vecs[77], 1)[0][0].id == "f.txt:77"
    store.add_chunks(*chunks_and_vecs(200, d=32, start=400, seed=1))

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("no room")
    monkeypatch.setattr(VectorStore, "_build_sharded_bucket", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        store.device_buckets()
    store.close()


def test_in_place_append_off_on_a_mesh(tmp_path):
    """No headroom, no arena and no stashed device rows on a mesh: each
    append after a search is a bucket of its own, padded to the shards'
    unit, until the tail merges."""
    store = make_store(tmp_path, d=32)
    cs, vecs = chunks_and_vecs(100, d=32)
    store.add_chunks(cs, vecs)
    assert store.search(vecs[3], 1)[0][0].id == "f.txt:3"
    assert not store.device_copy_live()
    (b,) = store.device_buckets()
    assert b["n_pad"] == 1024 and "arena" not in b
    more, mv = chunks_and_vecs(20, d=32, start=100, seed=1)
    store.add_chunks(more, torch.from_numpy(mv))
    assert not store._pending_dev
    buckets = store.device_buckets()
    assert [(x["rows"], x["n_pad"]) for x in buckets] == [(100, 1024),
                                                          (20, 1024)]
    assert store.search(mv[5], 1)[0][0].id == "f.txt:105"
    for i in range(7):           # past MAX_TAIL_BUCKETS the tail merges
        c, v = chunks_and_vecs(5, d=32, start=120 + 5 * i, seed=2 + i)
        store.add_chunks(c, v)
        store.device_buckets()
    buckets = store.device_buckets()
    assert [(x["rows"], x["n_pad"]) for x in buckets] == [(155, 1024)]
    store.close()


def test_without_a_mesh_nothing_changes(tmp_path):
    """One device: the tail keeps its 2x arena and takes appends in place,
    sealed buckets keep their rows, the sidecar key carries one shard."""
    store = VectorStore(tmp_path, 32, "m", device="cpu")
    assert store.mesh is None and store._shards() == 1
    assert (store._pad_rows(300), store._pad_rows(1)) == (512, 128)
    cs, vecs = chunks_and_vecs(300, d=32)
    store.add_chunks(cs, vecs)
    (b,) = store.device_buckets()
    assert b["n_pad"] == 1024 and "arena" in b
    assert isinstance(b["store"], torch.Tensor)
    assert store.device_copy_live()
    more, mv = chunks_and_vecs(10, d=32, start=300, seed=1)
    store.add_chunks(more, torch.from_numpy(mv))
    (b,) = store.device_buckets()
    assert b["rows"] == 310 and b["n_pad"] == 1024
    key = store._ivf_key((0, 1), 1024)[0]
    assert key == ivf_cache_key(store, 1024)
    store.close()


def ivf_cache_key(store, n_pad):
    from sema_tpu_torch.index import ivf_cache
    segs = [(s.name, s.rows) for s in store.segments[:1]]
    return ivf_cache.layout_key(segs, n_pad, store.dim, store.store_dtype,
                                1, store.IVF_TILE, store.IVF_CLUSTER_ROWS)
