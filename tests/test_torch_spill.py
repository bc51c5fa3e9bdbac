"""The port's HBM spill against ``tests/test_hbm_spill.py`` and the JAX
package, on the CPU.

Sealed buckets past the device-bucket budget stay on the host and stream
through the scan in slices (``VectorStore._scan_host_bucket``). The 19
tests of ``tests/test_hbm_spill.py`` run here against the port's store
(``device="cpu"``, the plain versions of the kernels) with the same
``SEAL_ROWS = 64`` and ``SPILL_SLICE_ROWS = 96``; then the same seeded
rows, tombstones and queries go through both packages' spilled stores,
whose ids must be equal (f32: scores equal too; bf16: scores within
1e-3; int8: the same f32 rescore, scores equal)."""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.types import Chunk as JaxChunk
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.types import Chunk


def chunks_and_vecs(n, d=32, path="f.txt", seed=0, start=0, cls=Chunk):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    cs = [cls(id=f"{path}:{start + i}", file_path=Path(path),
              start_line=i + 1, end_line=i + 2,
              content=f"content {start + i}")
          for i in range(n)]
    return cs, vecs


def oracle_topk(store_vecs, dead_rows, q, k):
    scores = store_vecs @ q
    scores[list(dead_rows)] = -np.inf
    order = np.argsort(-scores, kind="stable")[:k]
    return scores[order], order


def bf16(x):
    """f32 rows rounded to bf16 and back, as the store keeps them."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.fixture
def spill_env(monkeypatch):
    """Tiny budget: every sealed bucket spills; buckets and slices small
    enough that one store has several buckets of several slices (a
    partial last slice among them)."""
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 64)
    monkeypatch.setattr(VectorStore, "SPILL_SLICE_ROWS", 96)  # pads→128
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "0.000001")


def make_store(tmp_path, d=32, **kw):
    # f32 store: the numpy oracle is then exact
    return VectorStore(tmp_path, dim=d, model="test-tiny",
                       store_dtype=kw.pop("store_dtype", "float32"),
                       device="cpu", **kw)


def test_all_buckets_spill_exact_parity(tmp_path, spill_env):
    store = make_store(tmp_path)
    all_vecs = []
    for i in range(5):
        cs, v = chunks_and_vecs(64, path=f"f{i}.txt", seed=i)
        store.add_chunks(cs, v)
        all_vecs.append(v)
    buckets = store.device_buckets()
    assert buckets and all(b.get("host_resident") for b in buckets)
    assert all(b["store"] is None for b in buckets)

    mat = np.concatenate(all_vecs)
    rng = np.random.default_rng(99)
    qs = rng.standard_normal((7, 32)).astype(np.float32)
    scores, ids = store.search_batch(qs, k=5)
    for qi in range(len(qs)):
        o_s, o_i = oracle_topk(mat, [], qs[qi], 5)
        np.testing.assert_array_equal(ids[qi], o_i)
        np.testing.assert_allclose(scores[qi], o_s, rtol=1e-5)


def test_multi_slice_bucket_with_partial_tail(tmp_path, spill_env):
    """One 300-row segment → one spilled bucket → slices of 128 rows:
    [0,128) [128,256) [256,300), the last one partly filled."""
    store = make_store(tmp_path)
    cs, v = chunks_and_vecs(300, seed=3)
    store.add_chunks(cs, v)
    [b] = store.device_buckets()
    assert b.get("host_resident") and b["rows"] == 300

    q = v[271]  # in the partial last slice
    results = store.search(q, k=3)
    assert results[0][0].id == "f.txt:271"
    assert results[0][1] == pytest.approx(1.0, abs=1e-5)


def test_mixed_device_and_host_buckets(tmp_path, spill_env, monkeypatch):
    """A budget for exactly one sealed bucket on the card: the rest
    spill, and the merge takes both kinds. The port does not pad a
    bucket outside IVF mode, so a sealed bucket is 64 rows x 32 x 4 B =
    8 KiB (the JAX package's pads to 128 rows, 16 KiB, under its budget
    of 0.02 MB); 0.01 MB admits one of them, not two."""
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "0.01")
    store = make_store(tmp_path)
    all_vecs = []
    for i in range(3):
        cs, v = chunks_and_vecs(64, path=f"f{i}.txt", seed=10 + i)
        store.add_chunks(cs, v)
        all_vecs.append(v)
    buckets = store.device_buckets()
    kinds = [bool(b.get("host_resident")) for b in buckets]
    assert kinds == [False, True, True]

    mat = np.concatenate(all_vecs)
    rng = np.random.default_rng(5)
    qs = rng.standard_normal((4, 32)).astype(np.float32)
    scores, ids = store.search_batch(qs, k=4)
    for qi in range(len(qs)):
        o_s, o_i = oracle_topk(mat, [], qs[qi], 4)
        np.testing.assert_array_equal(ids[qi], o_i)


def test_spill_sees_fresh_tombstones(tmp_path, spill_env):
    """A host bucket reads its tombstones at each scan: a delete after
    the bucket was built masks its rows with no re-upload."""
    store = make_store(tmp_path)
    cs0, v0 = chunks_and_vecs(64, path="dead.txt", seed=20)
    cs1, v1 = chunks_and_vecs(64, path="live.txt", seed=21)
    store.add_chunks(cs0, v0)
    store.add_chunks(cs1, v1)
    store.device_buckets()            # the spill happens here
    assert store.remove_file_chunks(Path("dead.txt")) == 64

    q = v0[7]                          # its own row is tombstoned
    scores, ids = store.search_batch(q[None, :], k=3)
    assert all(i >= 64 for i in ids[0])       # only live.txt rows
    mat = np.concatenate([v0, v1])
    o_s, o_i = oracle_topk(mat, range(64), q, 3)
    np.testing.assert_array_equal(ids[0], o_i)


def test_append_after_spill(tmp_path, spill_env):
    """Rows appended after the spill land in a device tail bucket; the
    merge spans spilled and device buckets."""
    store = make_store(tmp_path)
    cs, v = chunks_and_vecs(64, path="old.txt", seed=30)
    store.add_chunks(cs, v)
    store.device_buckets()
    cs2, v2 = chunks_and_vecs(8, path="new.txt", seed=31)
    store.add_chunks(cs2, v2)
    buckets = store.device_buckets()
    assert [bool(b.get("host_resident")) for b in buckets] == [True, False]

    results = store.search(v2[3], k=1)
    assert results[0][0].id == "new.txt:3"
    results = store.search(v[5], k=1)
    assert results[0][0].id == "old.txt:5"


def test_spill_int8_scans_bf16_originals(tmp_path, spill_env, monkeypatch):
    """An int8 store's spilled slices stream the bf16 originals through
    K1 (never K4a) and go through the exact rescore: ids equal the
    full-precision oracle's."""
    store = make_store(tmp_path, store_dtype="int8")
    all_vecs = []
    for i in range(2):
        cs, v = chunks_and_vecs(64, path=f"f{i}.txt", seed=40 + i)
        store.add_chunks(cs, v)
        all_vecs.append(v)
    assert all(b.get("host_resident") for b in store.device_buckets())
    calls = []
    import sema_tpu_torch.index.vector_store as store_mod
    for name in ("scan_topk", "scan_topk_int8"):
        fn = getattr(store_mod, name)
        monkeypatch.setattr(store_mod, name,
                            lambda *a, _n=name, _f=fn, **k:
                            calls.append((_n, a[0].dtype)) or _f(*a, **k))

    mat = bf16(np.concatenate(all_vecs))      # the bf16 originals
    rng = np.random.default_rng(8)
    qs = rng.standard_normal((3, 32)).astype(np.float32)
    scores, ids = store.search_batch(qs, k=5)
    assert calls and all(c == ("scan_topk", torch.bfloat16) for c in calls)
    for qi in range(len(qs)):
        o_s, o_i = oracle_topk(mat, [], qs[qi], 5)
        np.testing.assert_array_equal(ids[qi], o_i)
        np.testing.assert_allclose(scores[qi], o_s, rtol=1e-2)


def test_oom_fallback_spills(tmp_path, monkeypatch):
    """The card running out of memory in a sealed bucket's upload
    (``torch.cuda.OutOfMemoryError``) degrades to a host bucket (no
    budget set)."""
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 64)
    monkeypatch.setattr(VectorStore, "SPILL_SLICE_ROWS", 96)
    monkeypatch.delenv("SEMA_TPU_HBM_BUDGET_MB", raising=False)
    store = make_store(tmp_path)
    orig = store._build_bucket

    def exploding(seg_range, row_offset):
        if sum(s.rows for s in store.segments[seg_range[0]:seg_range[1]]) \
                >= store.SEAL_ROWS:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 512.00 MiB")
        return orig(seg_range, row_offset)

    monkeypatch.setattr(store, "_build_bucket", exploding)
    cs, v = chunks_and_vecs(64, seed=50)
    store.add_chunks(cs, v)
    [b] = store.device_buckets()
    assert b.get("host_resident")
    results = store.search(v[10], k=1)
    assert results[0][0].id == "f.txt:10"


@pytest.mark.parametrize("error", [KernelError("scan_topk: CUDA error 700"),
                                   RuntimeError("out of memory")])
def test_only_out_of_memory_degrades(tmp_path, monkeypatch, error):
    """Any other exception in a bucket build, a KernelError or a
    RuntimeError that merely says "out of memory", raises out of the
    search: the degrade is for the card's OOM alone."""
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 64)
    store = make_store(tmp_path)

    def failing(seg_range, row_offset):
        raise error

    monkeypatch.setattr(store, "_build_bucket", failing)
    cs, v = chunks_and_vecs(64, seed=51)
    store.add_chunks(cs, v)
    with pytest.raises(type(error)):
        store.search(v[0], k=1)
    assert store._buckets is None


def test_persistence_roundtrip_with_spill(tmp_path, spill_env):
    """The spill is a policy of the search, not a state on disk:
    reopened under the same budget, the store spills again and
    answers."""
    store = make_store(tmp_path)
    cs, v = chunks_and_vecs(128, seed=60)
    store.add_chunks(cs, v)
    store.close()

    store2 = make_store(tmp_path)
    assert all(b.get("host_resident")
               for b in store2.device_buckets())
    results = store2.search(v[100], k=1)
    assert results[0][0].id == "f.txt:100"
    store2.close()


def test_query_batcher_over_spilled_store(tmp_path, spill_env):
    """Serving: the QueryBatcher's dispatch and completion work while
    ``search_batch_async`` stages spilled slices (concurrent callers,
    exact winners, a clean close)."""
    from sema_tpu_torch.search.server import QueryBatcher

    store = make_store(tmp_path)
    vecs_all = []
    for i in range(3):
        cs, v = chunks_and_vecs(64, path=f"f{i}.txt", seed=70 + i)
        store.add_chunks(cs, v)
        vecs_all.append(v)
    assert all(b.get("host_resident") for b in store.device_buckets())
    vecs = np.concatenate(vecs_all)

    b = QueryBatcher(store, max_batch=8, max_wait_ms=5)
    results, errors = {}, []

    def worker(i):
        try:
            results[i] = b.search(vecs[i * 7], k=1)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(24)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        assert len(results) == 24
        for i, res in results.items():
            fi, local = divmod(i * 7, 64)
            assert res[0][0].id == f"f{fi}.txt:{local}"
    finally:
        b.close()


def test_constructor_budget_knob(tmp_path, monkeypatch):
    """``hbm_budget_mb`` spills with no environment variable, and the
    variable wins over it."""
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 64)
    monkeypatch.setattr(VectorStore, "SPILL_SLICE_ROWS", 96)
    monkeypatch.delenv("SEMA_TPU_HBM_BUDGET_MB", raising=False)
    store = VectorStore(tmp_path, dim=32, model="test-tiny",
                        store_dtype="float32", device="cpu",
                        hbm_budget_mb=1e-6)
    cs, v = chunks_and_vecs(64, seed=80)
    store.add_chunks(cs, v)
    [b] = store.device_buckets()
    assert b.get("host_resident")
    assert store.search(v[9], k=1)[0][0].id == "f.txt:9"
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "1024")
    store._buckets = None
    [b2] = store.device_buckets()
    assert not b2.get("host_resident")


def test_config_roundtrip_budget(tmp_path):
    from sema_tpu_torch.config import Config, dumps_toml, loads_toml
    c = Config()
    assert c.index.hbm_budget_mb == 0.0
    c.index.hbm_budget_mb = 12288.0
    c2 = loads_toml(dumps_toml(c))
    assert c2.index.hbm_budget_mb == 12288.0


def test_concurrent_deletes_during_spilled_search(tmp_path, spill_env):
    """``remove_file_chunks`` changes a segment's tombstone set while a
    spilled scan reads it: the scan takes its snapshot under the lock
    (``_deleted_snapshot``)."""
    store = make_store(tmp_path)
    for i in range(4):
        cs, v = chunks_and_vecs(64, path=f"f{i}.txt", seed=90 + i)
        for c in cs:           # a file per row: one tombstone at a time
            c.file_path = Path(f"f{i}_{c.start_line}.txt")
        store.add_chunks(cs, v)
    assert all(b.get("host_resident") for b in store.device_buckets())

    errors = []
    stop = threading.Event()

    def deleter():
        try:
            for i in range(4):
                for ln in range(1, 65):
                    store.remove_file_chunks(Path(f"f{i}_{ln}.txt"))
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=deleter)
    t.start()
    rng = np.random.default_rng(1)
    try:
        while not stop.is_set():
            q = rng.standard_normal(32).astype(np.float32)
            store.search_batch(q[None, :], k=5)
    finally:
        t.join(timeout=30)
    assert not errors
    scores, ids = store.search_batch(
        rng.standard_normal((1, 32)).astype(np.float32), k=5)
    assert not np.isfinite(scores).any()


def test_spill_staging_window_is_global(tmp_path, spill_env):
    """The SPILL_INFLIGHT bound spans every spilled bucket of a search:
    once ``search_batch_async`` returns, at most SPILL_INFLIGHT entries
    hold unfetched scan results."""
    store = make_store(tmp_path)
    all_vecs = []
    for i in range(6):
        cs, v = chunks_and_vecs(64, path=f"f{i}.txt", seed=100 + i)
        store.add_chunks(cs, v)
        all_vecs.append(v)
    assert all(b.get("host_resident") for b in store.device_buckets())

    qs = np.random.default_rng(2).standard_normal(
        (3, 32)).astype(np.float32)
    handle = store.search_batch_async(qs, k=4)
    pending = handle[2]
    assert len(pending) >= 6
    n_unfetched = sum(1 for e in pending if not isinstance(e[1], np.ndarray))
    assert n_unfetched <= VectorStore.SPILL_INFLIGHT

    scores, ids = store.search_batch_finish(handle, qs)
    mat = np.concatenate(all_vecs)
    for qi in range(len(qs)):
        o_s, o_i = oracle_topk(mat, [], qs[qi], 4)
        np.testing.assert_array_equal(ids[qi], o_i)


def test_device_residency_stats(tmp_path, spill_env):
    """``device_residency()`` reports the spill without building the
    buckets."""
    store = make_store(tmp_path)
    cs, v = chunks_and_vecs(128, seed=110)
    store.add_chunks(cs, v)
    r0 = store.device_residency()
    assert r0 == {"buckets": 0, "tail_buckets": 0, "host_buckets": 0,
                  "spilled_rows": 0, "device_bytes": 0,
                  "busy": False}                       # nothing built yet
    store.search(v[0], k=1)                     # builds (and spills)
    r1 = store.device_residency()
    assert r1["buckets"] == 1 and r1["host_buckets"] == 1
    assert r1["spilled_rows"] == 128 and r1["device_bytes"] == 0
    cs2, v2 = chunks_and_vecs(8, path="t.txt", seed=111)
    store.add_chunks(cs2, v2)
    store.device_buckets()
    r2 = store.device_residency()   # the tail: rows, mask, on the device
    assert r2["buckets"] == 2 and r2["spilled_rows"] == 128
    # the 8-row tail's arena holds _pad_rows(16) = 128 rows and flags
    assert r2["tail_buckets"] == 1
    assert r2["device_bytes"] == 128 * 32 * 4 + 128


def test_consolidation_respects_budget(tmp_path, monkeypatch):
    """A sealing bulk append over the budget stays on the host and
    freezes the unsealed buckets before it: two 60-row appends share the
    first tail's arena (pad 128), a 40-row one overflows it into a second
    tail, then a 300-row append seals (SEAL_ROWS = 256) and spills, and
    both tails are sealed where they are, still on the device (only the
    last bucket ever grows or merges)."""
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 256)
    monkeypatch.setattr(VectorStore, "SPILL_SLICE_ROWS", 96)
    monkeypatch.setattr(VectorStore, "MAX_TAIL_BUCKETS", 2)
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "0.000001")
    store = make_store(tmp_path)
    all_vecs = []
    for i, n in enumerate((60, 60, 40, 300)):
        cs, v = chunks_and_vecs(n, path=f"f{i}.txt", seed=120 + i)
        store.add_chunks(cs, v)
        all_vecs.append(v)
        store.device_buckets()
    buckets = store.device_buckets()
    assert [(b["rows"], b["n_pad"], b["sealed"], bool(b.get("host_resident")))
            for b in buckets] == [(120, 128, True, False),
                                  (40, 128, True, False),
                                  (300, 300, True, True)]

    mat = np.concatenate(all_vecs)
    q = mat[377]
    scores, ids = store.search_batch(q[None, :], k=3)
    o_s, o_i = oracle_topk(mat, [], q, 3)
    np.testing.assert_array_equal(ids[0], o_i)


def test_residency_nonblocking_when_lock_held(tmp_path):
    """/healthz must not hang behind a mutator that holds the store's
    lock."""
    store = make_store(tmp_path)
    cs, v = chunks_and_vecs(16, seed=130)
    store.add_chunks(cs, v)
    acquired = threading.Event()
    release = threading.Event()

    def holder():
        with store._lock:
            acquired.set()
            release.wait(timeout=10)

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert acquired.wait(timeout=5)
        r = store.device_residency()
        assert r["busy"] is True and r["buckets"] is None
    finally:
        release.set()
        t.join(timeout=5)
    r = store.device_residency()
    assert r["busy"] is False


def test_malformed_env_budget_falls_through(tmp_path, monkeypatch,
                                            capsys):
    """``SEMA_TPU_HBM_BUDGET_MB=2GB`` warns and falls through to the
    knob; it does not disable the budget."""
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 64)
    monkeypatch.setattr(VectorStore, "SPILL_SLICE_ROWS", 96)
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "2GB")
    store = VectorStore(tmp_path, dim=32, model="test-tiny",
                        store_dtype="float32", device="cpu",
                        hbm_budget_mb=1e-6)
    cs, v = chunks_and_vecs(64, seed=140)
    store.add_chunks(cs, v)
    [b] = store.device_buckets()
    assert b.get("host_resident")    # the knob still applied
    assert "malformed" in capsys.readouterr().err
    # with neither, a CPU store has no budget
    monkeypatch.delenv("SEMA_TPU_HBM_BUDGET_MB")
    assert make_store(tmp_path / "other")._hbm_budget_bytes() is None


def test_int8_admission_charges_bf16_transient(tmp_path):
    """An int8 bucket uploads bf16 rows before it quantizes them:
    admission charges that peak (2 bytes a value), the running total
    the steady int8 rows and f32 scales."""
    store = make_store(tmp_path, store_dtype="int8")
    steady = store._bucket_dev_bytes(1024)
    transient = store._bucket_dev_bytes(1024, transient=True)
    assert steady == 1024 * (32 + 4)
    assert transient == 1024 * 32 * 2 > steady


def test_manager_end_to_end_with_spill(tmp_path, spill_env):
    """Through IndexManager over a spilled store: the knob reaches the
    store, the semantic search streams host buckets, the keyword search
    is untouched."""
    from sema_tpu_torch.index.manager import IndexManager

    class StubEncoder:
        device = torch.device("cpu")

        class spec:
            dim = 32
            name = "test-tiny"

        def encode_texts(self, texts, progress=None, out_dtype=None):
            rng = np.random.default_rng(
                [len(t) for t in texts] or [1])
            v = rng.standard_normal((len(texts), 32)).astype(np.float32)
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            return torch.from_numpy(v)

        def encode_query_device(self, text):
            return self.encode_texts([text])[0]

    mgr = IndexManager(tmp_path, StubEncoder(), store_dtype="float32",
                       hbm_budget_mb=1e-6)
    assert mgr.vector_store.hbm_budget_mb == 1e-6
    chunks = [Chunk(id=f"f{i // 64}.txt:{i}",
                    file_path=Path(f"f{i // 64}.txt"),
                    start_line=1, end_line=2,
                    content=f"chunk body number {i}")
              for i in range(192)]
    mgr.index_chunks(chunks)
    assert all(b.get("host_resident")
               for b in mgr.vector_store.device_buckets())

    hits = mgr.search("chunk body number 7", limit=5)
    assert len(hits) == 5 and all(np.isfinite(s) for _, s in hits)
    khits = mgr.search("'number AND 190", limit=5)
    assert [c.id for c, _ in khits] == ["f2.txt:190"]


def test_cli_passes_the_config_budget(tmp_path, monkeypatch):
    """``[index] hbm_budget_mb`` reaches the store through
    ``cli.make_index_manager``."""
    from sema_tpu_torch import cli
    from sema_tpu_torch.config import Config
    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "data"))
    config = Config()
    config.model.name = "test-tiny"
    config.index.hbm_budget_mb = 640.0
    mgr = cli.make_index_manager(config, "cpu")
    try:
        assert mgr.vector_store.hbm_budget_mb == 640.0
        assert mgr.vector_store._hbm_budget_bytes() == 640 << 20
    finally:
        mgr.close()


# -- against the JAX package ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_spilled_store_answers_as_the_jax_package(tmp_path, monkeypatch,
                                                  dtype):
    """Five sealed buckets and a tail, every sealed bucket spilled in
    both packages, tombstones in two files, seven queries: equal ids;
    f32 and int8 (one f32 rescore) scores equal, bf16 within 1e-3."""
    for cls in (JaxStore, VectorStore):
        monkeypatch.setattr(cls, "SEAL_ROWS", 64)
        monkeypatch.setattr(cls, "SPILL_SLICE_ROWS", 96)
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "0.000001")
    stores = {"jax": JaxStore(tmp_path / "jax", 32, "test-tiny",
                              store_dtype=dtype),
              "port": VectorStore(tmp_path / "port", 32, "test-tiny",
                                  store_dtype=dtype, device="cpu")}
    qs = np.random.default_rng(7).standard_normal((7, 32)).astype(np.float32)
    out = {}
    for name, store in stores.items():
        cls = JaxChunk if name == "jax" else Chunk
        for i in range(5):
            store.add_chunks(*chunks_and_vecs(70 if i == 2 else 64,
                                              path=f"f{i}.txt", seed=150 + i,
                                              cls=cls))
        store.add_chunks(*chunks_and_vecs(9, path="t.txt", seed=160,
                                          cls=cls))
        store.device_buckets()
        for f in ("f1.txt", "t.txt"):
            store.remove_file_chunks(Path(f))
        kinds = [bool(b.get("host_resident")) for b in store.device_buckets()]
        assert kinds == [True] * 5 + [False], (name, kinds)
        out[name] = store.search_batch(qs, k=8)
        store.close()
    (js, ji), (ps, pi) = out["jax"], out["port"]
    np.testing.assert_array_equal(pi, np.asarray(ji, dtype=np.int64))
    assert not np.isin(pi, np.arange(64, 128)).any()   # f1.txt's rows
    if dtype == "bfloat16":
        np.testing.assert_allclose(ps, js, atol=1e-3)
    else:
        np.testing.assert_array_equal(ps, js)
