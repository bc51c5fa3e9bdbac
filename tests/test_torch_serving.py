"""Serving of the port on the CPU: ``QueryBatcher`` over the port's store
(the cases of ``tests/test_query_batcher.py`` and
``tests/test_serving_stress.py``), the store's ``search_batch_async`` /
``search_batch_finish`` against ``search_batch`` and its snapshots, and a
``KernelError`` getting through the manager and the CLI where any other
error degrades. Every threaded wait has its own timeout."""

import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sema_tpu_torch import cli
from sema_tpu_torch.index import IndexManager
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.models import Encoder
from sema_tpu_torch.models.loader import random_params
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.search.server import (QueryBatcher, ServerOverloaded,
                                          _Request)
from sema_tpu_torch.tokenizer import HashTokenizer
from sema_tpu_torch.types import Chunk

DIM = 32


def chunks_and_vecs(n, d=DIM, path="f.txt", seed=0, start=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    cs = [Chunk(id=f"{path}:{start + i}", file_path=Path(path),
                start_line=i + 1, end_line=i + 2,
                content=f"content {start + i}")
          for i in range(n)]
    return cs, vecs


def make_store(path, d=DIM, **kw):
    return VectorStore(path, dim=d, model="test-tiny", device="cpu", **kw)


@pytest.fixture()
def store(tmp_path):
    s = make_store(tmp_path)
    cs, vecs = chunks_and_vecs(300)
    s.add_chunks(cs, vecs)
    s._test_vecs = vecs
    return s


def _join(threads, timeout):
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "a thread hung"


# -- QueryBatcher (tests/test_query_batcher.py) -------------------------------

def test_single_query(store):
    b = QueryBatcher(store, max_batch=8)
    try:
        res = b.search(store._test_vecs[42], k=3, timeout=30)
        assert res[0][0].id == "f.txt:42"
        assert len(res) == 3
    finally:
        b.close()


def test_many_concurrent_queries(store):
    b = QueryBatcher(store, max_batch=16, max_wait_ms=5)
    results, errors = {}, []

    def worker(i):
        try:
            results[i] = b.search(store._test_vecs[i], k=1, timeout=30)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(64)]
    try:
        for t in threads:
            t.start()
        _join(threads, 60)
        assert not errors
        assert len(results) == 64
        for i, res in results.items():
            assert res[0][0].id == f"f.txt:{i}"
    finally:
        b.close()


def test_mixed_k(store):
    b = QueryBatcher(store, max_batch=4, max_wait_ms=5)
    try:
        r1 = b.search(store._test_vecs[0], k=1, timeout=30)
        r5 = b.search(store._test_vecs[1], k=5, timeout=30)
        assert len(r1) == 1 and len(r5) == 5
    finally:
        b.close()


def test_error_propagates(store):
    b = QueryBatcher(store, max_batch=4)
    try:
        with pytest.raises(ValueError):
            b.search(np.zeros(999, dtype=np.float32), k=1)  # wrong dim
    finally:
        b.close()


def test_kernel_error_of_a_batch_reaches_its_callers(store):
    """A scan that fails on the card fails every caller of its batch with
    the KernelError itself, not a timeout."""
    class Failing:
        dim = DIM

        def __getattr__(self, name):
            return getattr(store, name)

        def search_batch_async(self, *a, **k):
            raise KernelError("scan_topk: CUDA error 9")

    b = QueryBatcher(Failing(), max_batch=4)
    try:
        with pytest.raises(KernelError, match="CUDA error 9"):
            b.search(store._test_vecs[0], k=1, timeout=30)
    finally:
        b.close()


def test_streaming_reindex_while_serving(store):
    """Appends and tombstones while queries are in flight."""
    b = QueryBatcher(store, max_batch=8, max_wait_ms=2)
    stop = threading.Event()
    errors = []

    def mutate():
        i = 0
        while not stop.is_set():
            cs, vecs = chunks_and_vecs(20, path=f"new{i}.txt", seed=100 + i)
            store.add_chunks(cs, vecs)
            store.remove_file_chunks(Path(f"new{i - 1}.txt"))
            i += 1

    def query(worker):
        try:
            for j in range(10):
                i = (worker * 10 + j) % 300
                res = b.search(store._test_vecs[i], k=1, timeout=30)
                assert res and res[0][0].id == f"f.txt:{i}"
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    mut = threading.Thread(target=mutate)
    workers = [threading.Thread(target=query, args=(w,)) for w in range(4)]
    mut.start()
    try:
        for t in workers:
            t.start()
        _join(workers, 60)
    finally:
        stop.set()
        _join([mut], 10)
        b.close()
    assert not errors, errors


class _SlowStore:
    def __init__(self, inner, delay):
        self._inner, self._delay = inner, delay

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def search_batch_async(self, q, k, **kw):
        time.sleep(self._delay)
        return self._inner.search_batch_async(q, k, **kw)


def test_overload_sheds_with_503_class_error(store):
    b = QueryBatcher(_SlowStore(store, 0.2), max_batch=1, max_wait_ms=0.1,
                     max_queue=2)
    try:
        shed, done = [], []

        def worker(i):
            try:
                done.append(b.search(store._test_vecs[i], k=1, timeout=30))
            except ServerOverloaded:
                shed.append(i)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        _join(threads, 60)
        assert shed, "overload must shed some requests"
        assert done, "non-shed requests must still answer"
    finally:
        b.close()


def test_queue_deadline_fails_stale_requests(store):
    b = QueryBatcher(store, max_batch=4, deadline_ms=500.0)
    try:
        req = _Request(np.asarray(store._test_vecs[0], dtype=np.float32),
                       1, time.perf_counter() - 10.0)
        b._queue.put(req)
        assert req.event.wait(10)
        assert isinstance(req.error, ServerOverloaded)
        res = b.search(store._test_vecs[5], k=1, timeout=30)
        assert res[0][0].id == "f.txt:5"
        assert b.stats()["batches"] >= 1
    finally:
        b.close()


def test_close_fails_undispatched_requests(store):
    b = QueryBatcher(store, max_batch=4)
    b._stop.set()
    b._dispatch_thread.join(timeout=5)
    req = _Request(np.asarray(store._test_vecs[0], dtype=np.float32),
                   1, time.perf_counter())
    b._queue.put_nowait(req)
    b.close()
    assert req.event.is_set()
    assert isinstance(req.error, ServerOverloaded)


def test_batch_closes_at_max_wait_under_trickle(store):
    b = QueryBatcher(store, max_batch=64, max_wait_ms=30.0)
    try:
        t0 = time.perf_counter()
        res = b.search(store._test_vecs[3], k=1, timeout=30)
        assert res[0][0].id == "f.txt:3"
        assert time.perf_counter() - t0 < 1.5
    finally:
        b.close()


# -- load (tests/test_serving_stress.py, driven from here) --------------------

def _load(tmp_path, rows, clients, max_batch, duration, mutate, k=5,
          n_probe=16):
    """Clients loop on planted probes (true top-1 known by construction)
    through the batcher while a mutator appends and tombstones; returns
    counts and latencies."""
    rng = np.random.default_rng(0)
    probes = rng.standard_normal((n_probe, DIM)).astype(np.float32)
    probes /= np.linalg.norm(probes, axis=1, keepdims=True)
    store = make_store(tmp_path)
    per = rows // 4
    for part in range(4):
        vecs = rng.standard_normal((per, DIM)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        path = "planted.txt" if part == 0 else f"base-{part}.txt"
        if part == 0:
            vecs[:n_probe] = probes * 0.95
        store.add_chunks([Chunk(f"{path}:{i}", Path(path), i, i + 1, "c")
                          for i in range(per)], vecs)
    batcher = QueryBatcher(store, max_batch=max_batch, max_wait_ms=2.0)
    batcher.search(probes[0], k, timeout=60)
    stop = threading.Event()
    lat, errors, mismatches, mutated = [], [0], [0], [0]

    def client(ci):
        r = np.random.default_rng(1000 + ci)
        while not stop.is_set():
            pi = int(r.integers(n_probe))
            t = time.perf_counter()
            try:
                res = batcher.search(probes[pi], k, timeout=30)
            except Exception:  # noqa: BLE001
                errors[0] += 1
                continue
            lat.append(time.perf_counter() - t)
            if not res or res[0][0].id != f"planted.txt:{pi}":
                mismatches[0] += 1

    def mutator():
        gen = 0
        while not stop.is_set():
            vecs = rng.standard_normal((128, DIM)).astype(np.float32)
            vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
            path = f"stream-{gen}.txt"
            store.add_chunks([Chunk(f"{path}:{i}", Path(path), i, i + 1, "s")
                              for i in range(128)], vecs)
            store.remove_file_chunks(f"stream-{gen - 1}.txt")
            mutated[0] += 1
            gen += 1

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    if mutate:
        threads.append(threading.Thread(target=mutator))
    for t in threads:
        t.start()
    time.sleep(duration)
    stop.set()
    _join(threads, 60)
    batcher.close()
    store.close()
    lat.sort()
    return {"queries": len(lat), "errors": errors[0],
            "mismatches": mismatches[0], "mutated_batches": mutated[0],
            "p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3 if lat else None}


def test_concurrent_serving_with_streaming_reindex(tmp_path):
    result = _load(tmp_path, rows=4096, clients=32, max_batch=32,
                   duration=3.0, mutate=True)
    assert result["errors"] == 0
    assert result["mismatches"] == 0
    assert result["queries"] > 0
    assert result["mutated_batches"] >= 1
    assert result["p99_ms"] is not None


def test_concurrent_serving_static_store(tmp_path):
    result = _load(tmp_path, rows=2048, clients=16, max_batch=16,
                   duration=1.5, mutate=False)
    assert result["errors"] == 0
    assert result["mismatches"] == 0
    assert result["queries"] > 0


# -- the store's two halves ---------------------------------------------------

def _queries(n, seed=9):
    q = np.random.default_rng(seed).standard_normal((n, DIM))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _fill_small_ivf(store):
    rng = np.random.default_rng(4)
    for part, n in enumerate((2048, 60)):
        vecs = rng.standard_normal((n, DIM)).astype(np.float32)
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
        store.add_chunks(chunks_and_vecs(n, path=f"p{part}.txt")[0], vecs)
    store.remove_file_chunks("p1.txt")
    store.add_chunks(*chunks_and_vecs(40, path="p2.txt", seed=5))


@pytest.mark.parametrize("store_dtype,ivf", [("bfloat16", False),
                                             ("int8", False),
                                             ("int8", True),
                                             ("bfloat16", True)])
def test_async_finish_equal_search_batch(tmp_path, monkeypatch, store_dtype,
                                         ivf):
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 2048)
    monkeypatch.setattr(VectorStore, "IVF_TILE", 128)
    monkeypatch.setattr(VectorStore, "IVF_CLUSTER_ROWS", 128)
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "2")
    store = make_store(tmp_path, store_dtype=store_dtype, ivf=ivf,
                       rescore_k=20)
    _fill_small_ivf(store)
    assert (store.device_buckets()[0]["ivf"] is not None) == ivf
    q = _queries(5)
    for k, exact in ((10, False), (3, True), (64, False)):
        want = store.search_batch(q, k, exact=exact)
        got = store.search_batch_finish(
            store.search_batch_async(q, k, exact=exact), q)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
        # a padded batch: the live rows answer as they do alone
        padded = np.concatenate([q[:2], np.zeros((6, DIM), np.float32)])
        live = store.search_batch_finish(
            store.search_batch_async(padded, k, live=2, exact=exact), padded)
        alone = store.search_batch(q[:2], k, exact=exact)
        assert live[0].shape == (2, k)
        for g, w in zip(live, alone):
            assert np.array_equal(g, w)
    store.close()


def test_async_on_an_empty_store(tmp_path):
    store = make_store(tmp_path)
    scores, ids = store.search_batch_finish(
        store.search_batch_async(_queries(3), 5, live=2), _queries(3))
    assert scores.shape == (2, 5) and np.isneginf(scores).all()
    assert not ids.any()


def test_bucket_snapshot_survives_tombstones_and_appends(store):
    snap = store.device_buckets()
    valid = snap[0]["valid"].clone()
    store.remove_file_chunks("f.txt")
    store.add_chunks(*chunks_and_vecs(10, path="g.txt", seed=3))
    now = store.device_buckets()
    assert torch.equal(snap[0]["valid"], valid) and valid.all()
    # the 10 rows went into the tail's spare rows: one bucket, whose mask
    # is new; the snapshot's views still end at its 300 rows
    assert len(now) == 1 and now[0]["rows"] == 310
    assert not now[0]["valid"][:300].any() and now[0]["valid"][300:].all()
    assert snap[0]["store"].shape[0] == snap[0]["valid"].shape[0] == 300
    assert now[0] is not snap[0]


def test_int8_rescore_reads_its_view_after_close(tmp_path):
    """An int8 batch in flight rescored from the segments it was launched
    on, after the store closed them."""
    store = make_store(tmp_path, store_dtype="int8", rescore_k=10)
    cs, vecs = chunks_and_vecs(200)
    store.add_chunks(cs, vecs)
    q = vecs[[7, 150]]
    want = store.search_batch(q, 5)
    handle = store.search_batch_async(q, 5)
    store.close()
    got = store.search_batch_finish(handle, q)
    assert np.array_equal(got[1], want[1]) and list(got[1][:, 0]) == [7, 150]


def test_device_residency(store):
    before = store.device_residency()
    assert before["buckets"] == 0 and before["busy"] is False
    store.device_buckets()
    after = store.device_residency()
    assert after["buckets"] == 1 and after["host_buckets"] == 0
    assert after["spilled_rows"] == 0
    # the 300-row tail's arena: _pad_rows(600) = 1,024 bf16 rows + flags
    assert after["tail_buckets"] == 1
    assert after["device_bytes"] == 1024 * DIM * 2 + 1024
    hold = threading.Thread(target=lambda: (store._lock.acquire(),
                                            time.sleep(0.5),
                                            store._lock.release()))
    hold.start()
    time.sleep(0.1)
    assert store.device_residency()["busy"] is True
    _join([hold], 10)


# -- KernelError through the manager and the CLI ------------------------------

def _manager(tmp_path):
    spec = get_spec("test-tiny")
    enc = Encoder(spec, random_params(spec), HashTokenizer(spec.vocab_size),
                  batch_size=8, compute_dtype=torch.float32, device="cpu")
    mgr = IndexManager(tmp_path / "data", enc)
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "doc.txt").write_text("needle in the haystack content\n" * 8)
    mgr.process_and_index_files(sorted(tree.glob("*")))
    return mgr, tree


def _raiser(exc):
    def fail(*a, **k):
        raise exc
    return fail


def test_kernel_error_propagates_from_search_and_index(tmp_path, capsys):
    mgr, tree = _manager(tmp_path)
    real_query, real_texts = (mgr.encoder.encode_query_device,
                              mgr.encoder.encode_texts)
    mgr.encoder.encode_query_device = _raiser(
        KernelError("fused_encoder_layer: CUDA error 9"))
    with pytest.raises(KernelError):
        mgr.search("needle", 5)
    mgr.encoder.encode_query_device = real_query
    mgr.vector_store.search = _raiser(KernelError("scan_topk: refused"))
    with pytest.raises(KernelError):
        mgr.search("needle", 5)
    # a plain error still degrades to the substring scan
    mgr.vector_store.search = _raiser(RuntimeError("device gone"))
    hits = mgr.search("needle", 5)
    assert hits and all("needle" in c.content for c, _ in hits)
    assert "falling back to substring" in capsys.readouterr().err

    (tree / "new.txt").write_text("a fresh file about haystacks\n" * 4)
    mgr.encoder.encode_texts = _raiser(KernelError("kernel build failed"))
    with pytest.raises(KernelError):
        mgr.process_and_index_files(sorted(tree.glob("*")))
    mgr.encoder.encode_texts = _raiser(RuntimeError("out of memory"))
    mgr.process_and_index_files(sorted(tree.glob("*")))
    assert "Failed to index chunks in vector" in capsys.readouterr().err
    mgr.encoder.encode_texts = real_texts
    mgr.close()


def test_cli_exits_nonzero_on_a_kernel_error(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SEMA_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "data"))
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "net.md").write_text("Retry logic with exponential backoff.\n" * 8)
    assert cli.main(["index", str(tree), "--device", "cpu"]) == 0
    query = ["query", "exponential backoff", "--device", "cpu"]
    assert cli.main(query) == 0
    bert_mod = __import__("sema_tpu_torch.models.bert", fromlist=["bert"])
    monkeypatch.setattr(bert_mod, "fused_encoder_layer", _raiser(
        KernelError("fused_encoder_layer: CUDA error 700")))
    capsys.readouterr()
    assert cli.main(query) == 1
    err = capsys.readouterr().err
    assert "CUDA error 700" in err and "substring" not in err
    (tree / "more.md").write_text("Another file to embed, and a kernel "
                                  "that fails.\n" * 4)
    assert cli.main(["index", str(tree), "--device", "cpu"]) == 1
    # the keyword path runs no kernel
    assert cli.main(["query", "'backoff", "--device", "cpu"]) == 0
