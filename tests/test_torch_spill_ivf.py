"""The port's spilled-IVF union probe against ``tests/test_ivf_persist.py``
and the JAX package, on the CPU.

A spilled bucket in IVF mode keeps a tile-aligned, cluster-major copy of
its rows in its sidecar; a query probes the union of every spilled
bucket's centroids, stages only the probed tiles and scans them with K3
(K4b for an int8 store's quantized blob). The 10 spilled-IVF tests of
``tests/test_ivf_persist.py`` run here against the port's store
(``device="cpu"``, the plain versions) with the same geometry: sealed
buckets of 512 rows, tiles and clusters of 128, a budget of half the
tiles, nprobe 2. Then a spilled store written by either package (the JAX
package with ``SEMA_TPU_SCAN_BACKEND=pallas``, its kernels in interpret
mode) opens in the other, which loads the sidecar (its k-means patched
to raise) and must answer with the same ids: the two packages' k-means
differ (``tests/test_torch_ivf.py``), so both sides share one sidecar.
int8 scores come from one f32 rescore and are equal; bf16 and f32
scores agree within 1e-5."""

import importlib
from pathlib import Path

import numpy as np
import pytest

from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.ops import ivf as jax_ivf
from sema_tpu.types import Chunk as JaxChunk
from sema_tpu_torch.index.vector_store import VectorStore, _stage_tiles
from sema_tpu_torch.ops.quant import quantize_rows
from sema_tpu_torch.types import Chunk

store_mod = importlib.import_module("sema_tpu_torch.index.vector_store")


def chunks_and_vecs(n, d=128, path="f.txt", seed=0, start=0, cls=Chunk):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    cs = [cls(id=f"{path}:{start + i}", file_path=Path(path),
              start_line=i + 1, end_line=i + 2,
              content=f"content {start + i}")
          for i in range(n)]
    return cs, vecs


@pytest.fixture()
def spill_ivf_env(monkeypatch):
    """Every sealed bucket spills; layouts carry their blob; a probe may
    take half the tiles, so that one query takes the pruned scan."""
    for cls in (JaxStore, VectorStore):
        monkeypatch.setattr(cls, "SEAL_ROWS", 512)
        monkeypatch.setattr(cls, "IVF_TILE", 128)
        monkeypatch.setattr(cls, "IVF_CLUSTER_ROWS", 128)
        monkeypatch.setattr(cls, "IVF_BUDGET_DIV", 2)
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "2")
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "0.000001")


def make_store(tmp_path, **kw):
    return VectorStore(tmp_path, dim=128, model="test-ivf", ivf=True,
                       device="cpu", **kw)


class Spy:
    """Counts the calls of store methods or of the scan wrappers the
    store calls, each still doing its work."""

    def __init__(self, monkeypatch, target, *names):
        self.calls = {name: [] for name in names}
        for name in names:
            fn = getattr(target, name)

            def spy(*a, _fn=fn, _name=name, **k):
                self.calls[_name].append(a)
                return _fn(*a, **k)
            monkeypatch.setattr(target, name, spy)


def streamed_spy(monkeypatch):
    return Spy(monkeypatch, VectorStore, "_scan_host_bucket").calls[
        "_scan_host_bucket"]


def test_spilled_ivf_probe(tmp_path, spill_ivf_env, monkeypatch):
    store = make_store(tmp_path)
    cs, vecs = chunks_and_vecs(1000, seed=8)
    store.add_chunks(cs, vecs)
    buckets = store.device_buckets()
    assert buckets and all(b.get("host_resident") for b in buckets)
    assert all(b.get("ivf_spill") is not None for b in buckets)
    assert list(Path(store.dir).glob("ivf-*.bin"))

    streamed = streamed_spy(monkeypatch)
    scans = Spy(monkeypatch, store_mod, "scan_topk_pruned").calls
    for row in (3, 456, 999):
        res = store.search(vecs[row], k=2)
        assert res[0][0].id == f"f.txt:{row}"
        assert res[0][1] == pytest.approx(1.0, abs=1e-2)
    assert not streamed, "probes must not fall back to the full stream"
    assert scans["scan_topk_pruned"]
    # each stage scans at the spill tile, over identity tile ids
    for store_t, _, _, tiles, n_live, _, tile_n in scans["scan_topk_pruned"]:
        assert tile_n == 128 and store_t.shape[0] == n_live * 128
        np.testing.assert_array_equal(tiles, np.arange(n_live))
    store.close()


def test_spilled_ivf_overbudget_falls_back_exact(tmp_path, spill_ivf_env,
                                                 monkeypatch):
    """A probe over its tile budget streams the whole bucket, and the
    result is then exact."""
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "4096")
    monkeypatch.setattr(VectorStore, "IVF_BUDGET_DIV", 4096)
    store = make_store(tmp_path)
    cs, vecs = chunks_and_vecs(700, seed=9)
    store.add_chunks(cs, vecs)
    streamed = streamed_spy(monkeypatch)
    qs = vecs[100:103]
    scores, ids = store.search_batch(qs, k=5)
    assert streamed
    full = vecs @ qs.T
    for qi in range(3):
        oracle = np.argsort(-full[:, qi], kind="stable")[:5]
        np.testing.assert_array_equal(ids[qi], oracle)
    store.close()


def test_spilled_ivf_tombstones(tmp_path, spill_ivf_env):
    store = make_store(tmp_path)
    cs, vecs = chunks_and_vecs(600, path="a.txt", seed=10)
    store.add_chunks(cs, vecs)
    cs2, vecs2 = chunks_and_vecs(600, path="b.txt", seed=11, start=600)
    store.add_chunks(cs2, vecs2)
    assert store.remove_file_chunks("a.txt") == 600
    res = store.search(vecs[5], k=3)
    assert res and all(c.id.startswith("b.txt") for c, _ in res)
    store.close()


def test_spilled_ivf_reopen_probes_from_disk(tmp_path, spill_ivf_env,
                                             monkeypatch):
    """Reopened, the store probes from its blob sidecar: no k-means, no
    whole-bucket read."""
    store = make_store(tmp_path)
    cs, vecs = chunks_and_vecs(1000, seed=12)
    store.add_chunks(cs, vecs)
    store.search(vecs[0], k=1)
    store.close()

    monkeypatch.setattr(store_mod, "kmeans_cluster",
                        lambda *a, **k: (_ for _ in ()).throw(
                            AssertionError("re-clustered on reopen")))
    streamed = streamed_spy(monkeypatch)
    store2 = make_store(tmp_path)
    res = store2.search(vecs[777], k=1)
    assert res[0][0].id == "f.txt:777"
    assert all(b.get("ivf_spill") is not None
               for b in store2.device_buckets())
    assert not streamed
    store2.close()


def test_spilled_ivf_int8_store(tmp_path, spill_ivf_env, monkeypatch):
    """An int8 store persists a quantized blob (int8 rows, f32 scales),
    selects on K4b and re-ranks its candidates from the originals."""
    store = make_store(tmp_path, store_dtype="int8")
    cs, vecs = chunks_and_vecs(700, seed=13)
    store.add_chunks(cs, vecs)
    buckets = store.device_buckets()
    assert all(b.get("host_resident") for b in buckets)
    for b in buckets:
        iv = b.get("ivf_spill")
        assert iv is not None
        assert np.asarray(iv["vectors"]).dtype == np.int8
        assert iv.get("scales") is not None
        assert iv["scales"].shape == (iv["n_pad"],)
    scans = Spy(monkeypatch, store_mod, "scan_topk_int8_pruned",
                "scan_topk", "scan_topk_int8").calls
    res = store.search(vecs[321], k=2)
    assert res[0][0].id == "f.txt:321"
    # the rescore reads the bf16 originals: the exact cosine
    assert res[0][1] == pytest.approx(1.0, abs=1e-2)
    assert scans["scan_topk_int8_pruned"] and not scans["scan_topk"] \
        and not scans["scan_topk_int8"]
    store.close()


def test_spilled_ivf_int8_blob_quantization_matches_oracle(
        tmp_path, spill_ivf_env):
    """The blob's rows and scales are ``quantize_rows`` of the
    cluster-major bf16 originals; gap slots are zero with scale 0."""
    store = make_store(tmp_path, store_dtype="int8")
    cs, vecs = chunks_and_vecs(600, seed=14)
    store.add_chunks(cs, vecs)
    b = store.device_buckets()[0]
    iv = b["ivf_spill"]
    rows = b["rows"]
    perm = iv["perm"]
    blob = np.asarray(iv["vectors"])
    scales = np.asarray(iv["scales"])
    orig = store.rows_at(np.arange(rows))
    live = perm < rows
    expect_rows = np.zeros((len(perm), 128), dtype=np.float32)
    expect_rows[live] = orig[perm[live]]
    eq, es = quantize_rows(expect_rows)
    np.testing.assert_array_equal(blob, eq)
    np.testing.assert_array_equal(scales, es)
    assert (scales[~live] == 0).all()
    store.close()


def test_spilled_ivf_blob_tile_aligned(tmp_path, spill_ivf_env):
    """Every real cluster starts on a spill tile, the overflow cluster
    is dropped, gap slots carry the ``rows`` sentinel and zero vectors,
    and the live entries are a permutation of the bucket's rows."""
    store = make_store(tmp_path)
    cs, vecs = chunks_and_vecs(1000, seed=21)
    store.add_chunks(cs, vecs)
    b = store.device_buckets()[0]
    iv = b["ivf_spill"]
    assert iv is not None
    t = store._spill_tile()
    c = iv["centroids"].shape[0]
    starts = iv["starts"]
    assert all(int(s) % t == 0 for s in starts[:c + 1])
    assert int(starts[c]) == int(starts[c + 1]) == iv["n_pad"]
    assert iv["n_pad"] % t == 0
    assert iv["vectors"].shape[0] == iv["n_pad"]
    rows = b["rows"]
    perm = np.asarray(iv["perm"])
    pad = perm == rows
    assert sorted(perm[~pad].tolist()) == list(range(rows))
    assert not np.asarray(iv["vectors"])[pad].any()
    res = store.search(vecs[123], k=1)
    assert res[0][0].id == "f.txt:123"
    store.close()


def test_spilled_ivf_probe_one_stage(tmp_path, spill_ivf_env, monkeypatch):
    """A probe of 16 live tiles, which the JAX package stages in two
    halves, stages in one ``_stage_tiles`` buffer in the port, and its
    candidates stay exact."""
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 4096)
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "16")
    store = make_store(tmp_path)
    cs, vecs = chunks_and_vecs(4096, seed=13)
    store.add_chunks(cs, vecs)
    assert all(b.get("ivf_spill") is not None
               for b in store.device_buckets())

    # pin the probe at 16 live tiles whatever k-means gave (more tiles
    # only add candidates)
    orig_sel = store_mod.select_tiles

    def pinned_select(centroids, starts, queries, nprobe, tile_n, budget):
        out = orig_sel(centroids, starts, queries, nprobe, tile_n, budget)
        assert out is not None, "probe must fit the budget"
        tiles, n_live = out
        want = min(16, budget)
        live = sorted(set(tiles[:n_live].tolist()))
        n_tiles = int(starts[-1]) // tile_n
        for extra in range(n_tiles):
            if len(live) >= want:
                break
            if extra not in live:
                live.append(extra)
        live = np.asarray(sorted(live), dtype=np.int32)
        padded = np.full(budget, live[-1], dtype=np.int32)
        padded[:len(live)] = live
        return padded, len(live)

    monkeypatch.setattr(store_mod, "select_tiles", pinned_select)
    stages = Spy(monkeypatch, VectorStore, "_ivf_spill_stage").calls[
        "_ivf_spill_stage"]
    streamed = streamed_spy(monkeypatch)

    scores, ids = store.search_batch(vecs[123:124], k=5)
    assert not streamed, "the probe must not fall back to the stream"
    b = store.device_buckets()[0]
    n_tiles = b["ivf_spill"]["n_pad"] // store._spill_tile()
    budget = max(2, n_tiles // VectorStore.IVF_BUDGET_DIV)
    assert len(stages) == 1, stages
    n_live = len(stages[0][3])
    assert n_live >= 16
    assert stages[0][4] == _stage_tiles(n_live, budget)
    assert ids[0][0] == 123
    assert scores[0][0] == pytest.approx(1.0, abs=1e-2)
    # the staged candidates are the exact scan's over the same rows: the
    # exact route, which scans every row, ranks 123 first with the same
    # score
    s_x, i_x = store.search_batch(vecs[123:124], k=5, exact=True)
    assert i_x[0][0] == 123 and s_x[0][0] == scores[0][0]
    store.close()


def test_spilled_ivf_union_probe_multibucket(tmp_path, spill_ivf_env,
                                             monkeypatch):
    """Six spilled buckets probe as one index: one union dispatch,
    nprobe clusters a query over every bucket's centroids, each bucket's
    planted winner back with its global row id; a tombstoned bucket's
    rows never come back."""
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "8")
    monkeypatch.setattr(VectorStore, "IVF_BUDGET_DIV", 1)
    store = make_store(tmp_path)
    n_b = 6
    all_vecs = []
    for b in range(n_b):
        cs, vecs = chunks_and_vecs(512, path=f"f{b}.txt", seed=20 + b)
        store.add_chunks(cs, vecs)
        all_vecs.append(vecs)
    buckets = store.device_buckets()
    assert len([b for b in buckets if b.get("host_resident")]) == n_b
    assert all(b.get("ivf_spill") is not None for b in buckets)

    calls = Spy(monkeypatch, VectorStore, "_ivf_spill_dispatch").calls[
        "_ivf_spill_dispatch"]
    streamed = streamed_spy(monkeypatch)

    q = np.stack([all_vecs[b][7] for b in range(n_b)])
    scores, ids = store.search_batch(q, k=3)
    assert [len(a[1]) for a in calls] == [n_b]
    assert not streamed
    for b in range(n_b):
        assert ids[b][0] == b * 512 + 7, f"bucket {b} winner id"
        assert scores[b][0] == pytest.approx(1.0, abs=1e-2)

    store.remove_file_chunks(Path("f2.txt"))
    calls.clear()
    scores2, ids2 = store.search_batch(q, k=3)
    assert [len(a[1]) for a in calls] == [n_b]
    finite2 = [int(i) for i, s in zip(ids2[2], scores2[2])
               if np.isfinite(s)]
    assert all(not (2 * 512 <= i < 3 * 512) for i in finite2)
    for b in (0, 1, 3, 4, 5):
        assert ids2[b][0] == b * 512 + 7
    store.close()


def test_spilled_ivf_union_budget_fallback(tmp_path, spill_ivf_env,
                                           monkeypatch):
    """A union probe over its budget retries bucket by bucket; buckets
    whose own probes fit stay pruned, and the answers are right."""
    store = make_store(tmp_path)
    n_b = 3
    all_vecs = []
    for b in range(n_b):
        cs, vecs = chunks_and_vecs(512, path=f"f{b}.txt", seed=40 + b)
        store.add_chunks(cs, vecs)
        all_vecs.append(vecs)
    buckets = store.device_buckets()
    assert all(b.get("ivf_spill") is not None for b in buckets)
    n_union = sum(len(b["ivf_spill"]["centroids"]) for b in buckets)

    orig_sel = store_mod.select_tiles

    def sel(centroids, starts, queries, nprobe, tile_n, budget):
        if len(centroids) == n_union:
            return None     # the union over its budget
        return orig_sel(centroids, starts, queries, nprobe, tile_n, budget)

    monkeypatch.setattr(store_mod, "select_tiles", sel)
    calls = Spy(monkeypatch, VectorStore, "_ivf_spill_dispatch").calls[
        "_ivf_spill_dispatch"]
    streamed = streamed_spy(monkeypatch)

    q = np.stack([all_vecs[b][11] for b in range(n_b)])
    scores, ids = store.search_batch(q, k=2)
    assert [len(a[1]) for a in calls] == [n_b] + [1] * n_b
    assert not streamed, "per-bucket probes fit: nothing streams"
    for b in range(n_b):
        assert ids[b][0] == b * 512 + 11
        assert scores[b][0] == pytest.approx(1.0, abs=1e-2)
    store.close()


# -- one sidecar, both packages ------------------------------------------------

def _fill(store, cls):
    """Three sealed buckets (spilled) and a 40-row tail; tombstones in
    one file of the second bucket."""
    for b in range(3):
        cs, vecs = chunks_and_vecs(512, path=f"f{b}.txt", seed=60 + b,
                                   start=512 * b, cls=cls)
        if b == 1:
            for c in cs[:100]:
                c.file_path = Path("gone.txt")
        store.add_chunks(cs, vecs)
    store.add_chunks(*chunks_and_vecs(40, path="t.txt", seed=70, cls=cls))
    store.remove_file_chunks(Path("gone.txt"))


def _queries():
    rows = np.concatenate([chunks_and_vecs(512, seed=60 + b)[1]
                           for b in range(3)])
    rng = np.random.default_rng(3)
    picks = rows[[7, 520, 530, 1100, 1500]]          # 520, 530: tombstoned
    qs = picks + 0.3 * rng.standard_normal(picks.shape).astype(np.float32) \
        / np.sqrt(128)
    return (qs / np.linalg.norm(qs, axis=1, keepdims=True)).astype(
        np.float32)


def _answers(store):
    """One query at a time (a batch unions its probes)."""
    out = [store.search_batch(q[None], 10) for q in _queries()]
    return (np.concatenate([np.asarray(s) for s, _ in out]),
            np.concatenate([np.asarray(i, dtype=np.int64) for _, i in out]))


def _check_same(got, want, dtype):
    np.testing.assert_array_equal(got[1], want[1])
    if dtype == "int8":       # one f32 rescore from the same originals
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    assert not np.isin(got[1], np.arange(512, 612)).any()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_jax_written_spill_sidecar_answers_in_the_port(
        tmp_path, spill_ivf_env, monkeypatch, dtype):
    monkeypatch.setenv("SEMA_TPU_SCAN_BACKEND", "pallas")
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "4")
    js = JaxStore(tmp_path, 128, "test-ivf", store_dtype=dtype, ivf=True)
    _fill(js, JaxChunk)
    want = _answers(js)
    jb = [b for b in js.device_buckets() if b.get("host_resident")]
    assert len(jb) == 3 and all(b.get("ivf_spill") is not None for b in jb)
    js.close()

    monkeypatch.setattr(store_mod, "kmeans_cluster",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError(
                            "the port re-clustered a bucket whose spill "
                            "sidecar the JAX package wrote")))
    streamed = streamed_spy(monkeypatch)
    ps = make_store(tmp_path, store_dtype=dtype)
    got = _answers(ps)
    pb = [b for b in ps.device_buckets() if b.get("host_resident")]
    for p, j in zip(pb, jb):
        np.testing.assert_array_equal(p["ivf_spill"]["perm"],
                                      j["ivf_spill"]["perm"])
        np.testing.assert_array_equal(
            np.asarray(p["ivf_spill"]["vectors"]).view(np.uint8),
            np.asarray(j["ivf_spill"]["vectors"]).view(np.uint8))
    assert not streamed
    _check_same(got, want, dtype)
    ps.close()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_port_written_spill_sidecar_answers_in_jax(
        tmp_path, spill_ivf_env, monkeypatch, dtype):
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "4")
    ps = make_store(tmp_path, store_dtype=dtype)
    _fill(ps, Chunk)
    want = _answers(ps)
    perms = [b["ivf_spill"]["perm"] for b in ps.device_buckets()
             if b.get("host_resident")]
    assert len(perms) == 3
    ps.close()

    monkeypatch.setenv("SEMA_TPU_SCAN_BACKEND", "pallas")
    monkeypatch.setattr(jax_ivf, "kmeans_cluster",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError(
                            "the JAX package re-clustered a bucket whose "
                            "spill sidecar the port wrote")))
    streamed = []
    orig = JaxStore._scan_host_bucket
    monkeypatch.setattr(JaxStore, "_scan_host_bucket",
                        lambda self, *a, **k: streamed.append(1)
                        or orig(self, *a, **k))
    js = JaxStore(tmp_path, 128, "test-ivf", store_dtype=dtype, ivf=True)
    got = _answers(js)
    jb = [b for b in js.device_buckets() if b.get("host_resident")]
    for p, j in zip(perms, jb):
        np.testing.assert_array_equal(j["ivf_spill"]["perm"], p)
    assert not streamed
    _check_same(got, want, dtype)
    js.close()
