"""The port's in-place device append against ``tests/test_device_append.py``
and the JAX package, on the CPU.

``VectorStore.add_chunks`` keeps device rows (``_pending_dev``) once the
store holds a live device copy, and the next build writes them into the
spare rows of the unsealed tail (its arena) instead of reading them back
from the fresh memmap. The 11 tests of ``tests/test_device_append.py``
run here against the port (``device="cpu"``: a CPU tensor is the store's
device rows, a numpy array host rows; ``EncodedBatch`` for the pair).
Then the same seeded appends, with a search between them, go through both
packages' stores (bf16 and int8, with and without IVF, ``SEAL_ROWS`` and
the IVF tile small): the bucket layouts must be equal after every build,
the ids equal and the scores within 1e-6 (bf16) or 1e-5 (int8, rescored).
Last, the port's ``encode_texts(return_device=True)`` against the JAX
package's (the weights through ``params_from_jax``), the cases of
``tests/test_encoder_drain.py`` that apply (the port holds no device
outputs between batches, so it has no drain), and the JAX form of the
consolidation test of ``tests/test_hbm_spill.py``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.models.encoder import Encoder as JaxEncoder
from sema_tpu.models.loader import random_params as jax_random_params
from sema_tpu.models.registry import get_spec as jax_spec
from sema_tpu.tokenizer import HashTokenizer as JaxHashTokenizer
from sema_tpu.types import Chunk as JaxChunk
from sema_tpu_torch.index.manager import IndexManager
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.models import EncodedBatch, Encoder, get_spec
from sema_tpu_torch.models.loader import params_from_jax, random_params
from sema_tpu_torch.tokenizer import HashTokenizer
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


def make_store(tmp_path, d=32, **kw):
    return VectorStore(tmp_path, dim=d, model="test-tiny", device="cpu",
                       **kw)


def oracle_topk(store_vecs, q, k):
    scores = store_vecs @ q
    order = np.argsort(-scores, kind="stable")[:k]
    return scores[order], order


# -- tests/test_device_append.py, on the port ---------------------------------

def test_device_append_served_store(tmp_path):
    """Device rows appended while the device copy is live: found, the
    pendings consumed, and the disk copy round-trips."""
    store = make_store(tmp_path / "a")
    cs1, v1 = chunks_and_vecs(60, path="a.txt", seed=1)
    store.add_chunks(cs1, v1)
    store.search(v1[0], k=1)                    # device copy goes live
    assert store.device_copy_live()

    cs2, v2 = chunks_and_vecs(40, path="b.txt", seed=2)
    store.add_chunks(cs2, torch.from_numpy(v2))
    assert len(store._pending_dev) == 1         # kept until the next build
    res = store.search(v2[10], k=1)
    assert res[0][0].id == "b.txt:10"
    assert res[0][1] == pytest.approx(1.0, abs=1e-2)
    assert not store._pending_dev               # consumed by the build
    [tail] = store.device_buckets()             # one bucket: the arena
    assert tail["rows"] == 100 and tail["n_pad"] == 128

    # the disk segment persisted the same rows (bf16-rounded)
    store.close()
    store2 = make_store(tmp_path / "a")
    got = torch.from_numpy(np.array(
        store2.segments[-1].vectors)).view(torch.bfloat16).float()
    torch.testing.assert_close(
        got, torch.from_numpy(v2).to(torch.bfloat16).float(), rtol=0,
        atol=0)


def test_device_rows_used_without_touching_disk(tmp_path):
    """The extension consumes the device rows: the appended segment's
    vector file is unlinked before the first search; a build from the
    memmaps would need it, the device path never opens it."""
    store = make_store(tmp_path / "a")
    cs1, v1 = chunks_and_vecs(60, path="a.txt", seed=1)
    store.add_chunks(cs1, v1)
    store.search(v1[0], k=1)

    cs2, v2 = chunks_and_vecs(40, path="b.txt", seed=2)
    store.add_chunks(cs2, torch.from_numpy(v2))
    store.segments[-1].vec_path.unlink()
    res = store.search(v2[7], k=1)
    assert res[0][0].id == "b.txt:7"


def test_device_and_host_append_identical_results(tmp_path):
    dev_store = make_store(tmp_path / "dev")
    host_store = make_store(tmp_path / "host")
    cs1, v1 = chunks_and_vecs(50, path="a.txt", seed=3)
    cs2, v2 = chunks_and_vecs(30, path="b.txt", seed=4)
    for s in (dev_store, host_store):
        s.add_chunks(cs1, v1)
        s.search(v1[0], k=1)
    dev_store.add_chunks(cs2, torch.from_numpy(v2))
    host_store.add_chunks(cs2, v2)
    assert len(dev_store._pending_dev) == 1 and not host_store._pending_dev
    _, qs = chunks_and_vecs(8, seed=5)
    for q in qs:
        a = dev_store.search(q, k=5)
        b = host_store.search(q, k=5)
        assert [(c.id, pytest.approx(s, abs=1e-6)) for c, s in a] \
            == [(c.id, s) for c, s in b]
    for a, b in zip(dev_store.device_buckets(), host_store.device_buckets()):
        assert torch.equal(a["store"], b["store"])
        assert torch.equal(a["valid"], b["valid"])


def test_tombstone_lands_between_append_and_build(tmp_path):
    """The mask is built on the host even on the device path: rows
    tombstoned after the append but before the build must not
    surface."""
    store = make_store(tmp_path / "a")
    cs1, v1 = chunks_and_vecs(60, path="a.txt", seed=1)
    store.add_chunks(cs1, v1)
    store.search(v1[0], k=1)
    cs2, v2 = chunks_and_vecs(20, path="b.txt", seed=2)
    store.add_chunks(cs2, torch.from_numpy(v2))
    removed = store.remove_file_chunks(Path("b.txt"))
    assert removed == 20
    res = store.search(v2[3], k=3)
    assert all(c.file_path != Path("b.txt") for c, _ in res)
    [tail] = store.device_buckets()
    assert tail["rows"] == 80 and not tail["valid"][60:].any()


def test_int8_store_device_append(tmp_path):
    dev_store = make_store(tmp_path / "dev", store_dtype="int8")
    host_store = make_store(tmp_path / "host", store_dtype="int8")
    cs1, v1 = chunks_and_vecs(64, path="a.txt", seed=6)
    cs2, v2 = chunks_and_vecs(32, path="b.txt", seed=7)
    for s in (dev_store, host_store):
        s.add_chunks(cs1, v1)
        s.search(v1[0], k=1)
    dev_store.add_chunks(cs2, torch.from_numpy(v2))
    host_store.add_chunks(cs2, v2)
    for q in v2[:4]:
        a = dev_store.search(np.array(q), k=5)
        b = host_store.search(np.array(q), k=5)
        assert [c.id for c, _ in a] == [c.id for c, _ in b]
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                                   atol=1e-6)
    # the quantized rows written in place equal those built from disk
    [a], [b] = dev_store.device_buckets(), host_store.device_buckets()
    for x, y in zip(a["store"], b["store"]):
        assert torch.equal(x, y)


def test_several_pending_segments_in_one_append(tmp_path):
    """Three appends before one build: one extension over three segments,
    each segment's device rows in its own range, equal to the rows the
    same store builds from disk."""
    dev_store = make_store(tmp_path / "dev")
    cs1, v1 = chunks_and_vecs(40, path="a.txt", seed=8)
    dev_store.add_chunks(cs1, v1)
    dev_store.search(v1[0], k=1)
    parts = [chunks_and_vecs(n, path=f"p{i}.txt", seed=20 + i)
             for i, n in enumerate((7, 13, 5))]
    for cs, v in parts:
        dev_store.add_chunks(cs, torch.from_numpy(v))
    assert len(dev_store._pending_dev) == 3
    [tail] = dev_store.device_buckets()
    assert tail["rows"] == 65 and not dev_store._pending_dev
    dev_store.close()
    disk = make_store(tmp_path / "dev")
    [want] = disk.device_buckets()
    assert torch.equal(tail["store"], want["store"])
    assert torch.equal(tail["valid"], want["valid"])


def test_no_stash_without_live_device_copy(tmp_path):
    """Builds before any search keep no device rows: the first search
    reads them from the memmaps anyway."""
    store = make_store(tmp_path / "a")
    cs, vecs = chunks_and_vecs(40)
    store.add_chunks(cs, torch.from_numpy(vecs))
    assert not store._pending_dev and not store.device_copy_live()
    res = store.search(vecs[11], k=1)
    assert res[0][0].id == "f.txt:11"


@pytest.fixture(scope="module")
def encoder():
    spec = get_spec("test-tiny")
    return Encoder(spec, random_params(spec), HashTokenizer(spec.vocab_size),
                   batch_size=8, compute_dtype=torch.float32, device="cpu")


def _texts(n):
    return [("word " * (1 + (i * 7) % 30)).strip() + f" {i}"
            for i in range(n)]


def test_encode_texts_return_device_matches_host(encoder):
    texts = _texts(37)
    host = encoder.encode_texts(texts)
    pair = encoder.encode_texts(texts, return_device=True)
    assert isinstance(pair, EncodedBatch)
    torch.testing.assert_close(pair.host, host, rtol=0, atol=0)
    # both placements carry the same rows in the same order
    assert torch.equal(pair.device, pair.host)


def test_encode_texts_return_device_out_dtype(encoder):
    texts = _texts(12)
    pair = encoder.encode_texts(texts, return_device=True,
                                out_dtype=torch.bfloat16)
    assert pair.device.dtype == pair.host.dtype == torch.bfloat16
    assert torch.equal(pair.device, pair.host)
    host = encoder.encode_texts(texts)
    torch.testing.assert_close(pair.host.float(), host, rtol=0, atol=1e-2)
    empty = encoder.encode_texts([], return_device=True)
    assert empty.host.shape == empty.device.shape == (0, encoder.spec.dim)


def test_encode_texts_return_device_many_batches(encoder):
    """batch_size 8 and 57 texts of several sequence buckets: many
    batches and a partial last one, each kept on the device (the JAX
    package's case across drains; the port holds no output between
    batches, so it has none)."""
    texts = _texts(57)
    pair = encoder.encode_texts(texts, return_device=True)
    ref = encoder.encode_texts(texts)
    torch.testing.assert_close(pair.host, ref, rtol=0, atol=0)
    assert torch.equal(pair.device, pair.host)


def test_add_chunks_encoded_pair(tmp_path, encoder):
    """add_chunks takes the (host, device) pair: the disk from host,
    the arena from device."""
    dim = encoder.spec.dim
    store = make_store(tmp_path / "a", d=dim)
    cs1, _ = chunks_and_vecs(20, d=dim, path="a.txt")
    v1 = encoder.encode_texts(_texts(20))
    store.add_chunks(cs1, v1.numpy())
    store.search(v1[0], k=1)
    pair = encoder.encode_texts(
        ["second wave " + t for t in _texts(20)], return_device=True)
    cs2, _ = chunks_and_vecs(20, d=dim, path="b.txt")
    store.add_chunks(cs2, pair)
    assert len(store._pending_dev) == 1
    res = store.search(pair.host[5], k=1)
    assert res[0][0].id == "b.txt:5"
    assert not store._pending_dev
    # a pair of the wrong length is refused before anything is written
    with pytest.raises(ValueError):
        store.add_chunks(cs2[:3], pair)
    assert store.total_rows == 40


def test_manager_serve_time_reindex_uses_device_path(tmp_path, encoder):
    """After a first search the manager asks the encoder for device rows
    (seen through the encode_texts arguments)."""
    calls = []
    orig = encoder.encode_texts

    class Spy:
        spec = encoder.spec
        device = encoder.device

        def encode_texts(self, texts, progress=None,
                         out_dtype=torch.float32, return_device=False):
            calls.append({"out_dtype": out_dtype,
                          **({"return_device": True} if return_device
                             else {})})
            return orig(texts, progress=progress, out_dtype=out_dtype,
                        return_device=return_device)

        def encode_query_device(self, text):
            return encoder.encode_query_device(text)

    src = tmp_path / "src"
    src.mkdir()
    f = src / "doc.txt"
    f.write_text("alpha beta gamma\n" * 5)
    mgr = IndexManager(tmp_path / "data", Spy())
    mgr.process_and_index_files([f])
    assert calls and "return_device" not in calls[-1]   # cold build: host

    hits = mgr.search("alpha beta", limit=5)            # device copy live
    assert hits

    f.write_text("delta epsilon zeta\n" * 5)
    mgr.process_and_index_files([f])
    assert calls[-1].get("return_device") is True       # serve-time path
    assert len(mgr.vector_store._pending_dev) == 1
    hits = mgr.search("delta epsilon", limit=5)
    assert hits and hits[0][0].content.startswith("delta")
    assert len(mgr.vector_store.device_buckets()) == 1
    mgr.close()


# -- the arena's capacity against the budget (tests/test_hbm_spill.py) --------

def test_consolidation_of_arena_tails_respects_budget(tmp_path, monkeypatch):
    """The JAX form of the consolidation test: 100-row appends, the arena
    (pad 256) absorbs one extension, then overflows, so unsealed buckets
    of 200, 200 and 100 rows accumulate until they merge into 500 rows,
    sealed at SEAL_ROWS = 256 and spilled under the tiny budget."""
    monkeypatch.setattr(VectorStore, "SEAL_ROWS", 256)
    monkeypatch.setattr(VectorStore, "SPILL_SLICE_ROWS", 96)
    monkeypatch.setattr(VectorStore, "MAX_TAIL_BUCKETS", 2)
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "0.000001")
    store = make_store(tmp_path, store_dtype="float32")
    all_vecs, layouts = [], []
    for i in range(5):
        cs, v = chunks_and_vecs(100, path=f"f{i}.txt", seed=120 + i)
        store.add_chunks(cs, v)
        all_vecs.append(v)
        layouts.append([(b["rows"], b["n_pad"], b["sealed"],
                         bool(b.get("host_resident")))
                        for b in store.device_buckets()])
    assert layouts[1] == [(200, 256, False, False)]
    assert layouts[3] == [(200, 256, False, False), (200, 256, False, False)]
    assert layouts[4] == [(500, 500, True, True)]

    mat = np.concatenate(all_vecs)
    q = mat[377]
    scores, ids = store.search_batch(q[None, :], k=3)
    o_s, o_i = oracle_topk(mat, q, 3)
    np.testing.assert_array_equal(ids[0], o_i)


# -- against the JAX package -------------------------------------------------

# rows of each append, a search after each: a bulk build of 300 rows (its
# arena 1,024), two appends that extend it, one that seals it (540 rows,
# clustered in IVF mode), tails that overflow into new ones until four
# unsealed buckets merge (650 rows, sealed), a 45-row tail that a sealing
# bulk append of 700 rows freezes, and a last tail
APPENDS = [300, 80, 60, 100, 90, 100, 70, 100, 100, 100, 90, 45, 700, 85]


def _layout(buckets):
    return [(b["rows"], tuple(b["seg_range"]), bool(b["sealed"]),
             bool(b.get("host_resident")),
             None if b["sealed"] else int(b["n_pad"])) for b in buckets]


@pytest.mark.parametrize("dtype,ivf", [("bfloat16", False),
                                       ("bfloat16", True),
                                       ("int8", False), ("int8", True)])
def test_appends_lay_out_buckets_as_the_jax_package(tmp_path, monkeypatch,
                                                    dtype, ivf):
    """The same seeded appends, the device rows handed over in each
    package's form, a search after each: equal bucket layouts (rows,
    segment range, sealed, host_resident, an unsealed bucket's n_pad)
    after every build, equal ids, scores within 1e-6 (bf16) or 1e-5
    (int8, rescored). IVF stores search ``exact=True`` (the JAX package
    probes only on a TPU or with its Pallas backend pinned, which pads
    buckets to another size); their sealed buckets are clustered in
    both."""
    monkeypatch.delenv("SEMA_TPU_SCAN_BACKEND", raising=False)
    monkeypatch.delenv("SEMA_TPU_HBM_BUDGET_MB", raising=False)
    for cls in (JaxStore, VectorStore):
        monkeypatch.setattr(cls, "SEAL_ROWS", 512)
        monkeypatch.setattr(cls, "MAX_TAIL_BUCKETS", 3)
        monkeypatch.setattr(cls, "IVF_TILE", 128)
        monkeypatch.setattr(cls, "IVF_CLUSTER_ROWS", 128)
    d = 32
    port = VectorStore(tmp_path / "port", d, "test-tiny", store_dtype=dtype,
                       device="cpu", ivf=ivf, rescore_k=20)
    jax_store = JaxStore(tmp_path / "jax", d, "test-tiny", store_dtype=dtype,
                         ivf=ivf, rescore_k=20)
    rng = np.random.default_rng(7)
    tol = 1e-5 if dtype == "int8" else 1e-6
    sealed_by = set()
    for i, n in enumerate(APPENDS):
        path = f"f{i}.txt"
        cs, v = chunks_and_vecs(n, d=d, path=path, seed=300 + i)
        jcs, _ = chunks_and_vecs(n, d=d, path=path, seed=300 + i,
                                 cls=JaxChunk)
        if i == 0:
            port.add_chunks(cs, v)
            jax_store.add_chunks(jcs, v)
        else:
            port.add_chunks(cs, torch.from_numpy(v))
            jax_store.add_chunks(jcs, jnp.asarray(v))
            assert len(port._pending_dev) == len(jax_store._pending_dev) == 1
        q = rng.standard_normal((3, d)).astype(np.float32)
        q[0] = v[n // 2]
        got = port.search_batch(q, 10, exact=ivf)
        want = jax_store.search_batch(q, 10, exact=ivf)
        assert not port._pending_dev and not jax_store._pending_dev
        assert _layout(port.device_buckets()) == \
            _layout(jax_store.device_buckets()), f"after append {i}"
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0,
                                   atol=tol)
        assert got[1][0][0] == port.total_rows - n + n // 2
        for b in port.device_buckets():
            if b["sealed"]:
                sealed_by.add(b["rows"])
            if ivf and b["rows"] >= 512:
                assert b["ivf"] is not None
    layouts = _layout(port.device_buckets())
    # the sequence reached every branch: sealed by extension (540), by a
    # merge (650), in bulk (700), frozen (45), and a last tail that still
    # holds spare rows
    assert {540, 650, 700, 45} <= sealed_by
    assert [rows for rows, *_ in layouts] == [540, 650, 45, 700, 85]
    assert layouts[-1][2] is False and layouts[-1][4] == 256


@pytest.mark.parametrize("out_dtype,jax_dtype", [
    (torch.float32, np.float32), (torch.bfloat16, jnp.bfloat16)])
def test_encode_texts_return_device_as_the_jax_package(out_dtype, jax_dtype):
    """The port's ``encode_texts(return_device=True)`` against the JAX
    package's on the same weights: ``.host`` within the encoder parity
    tolerance (2e-5 in f32, one bf16 rounding apart in bf16), and in each
    package ``.device`` equal to ``.host`` bit for bit."""
    js, ps = jax_spec("test-tiny"), get_spec("test-tiny")
    jparams = jax_random_params(js)
    jenc = JaxEncoder(js, jparams, JaxHashTokenizer(js.vocab_size),
                      max_length=64, batch_size=4,
                      compute_dtype=jnp.float32)
    penc = Encoder(ps, params_from_jax(jparams),
                   HashTokenizer(ps.vocab_size), max_length=64,
                   batch_size=4, compute_dtype=torch.float32, device="cpu")
    texts = _texts(23)
    want = jenc.encode_texts(texts, return_device=True, out_dtype=jax_dtype)
    got = penc.encode_texts(texts, return_device=True, out_dtype=out_dtype)
    assert torch.equal(got.device, got.host)
    np.testing.assert_array_equal(np.asarray(want.device), want.host)
    atol = 2e-5 if out_dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.host.float().numpy(),
                               np.asarray(want.host, dtype=np.float32),
                               rtol=0, atol=atol)


# -- tests/test_encoder_drain.py where it applies -----------------------------

def test_progress_monotonic_and_complete(encoder):
    seen = []
    texts = _texts(30)
    encoder.encode_texts(texts, progress=lambda d, t: seen.append((d, t)),
                         return_device=True)
    assert seen[-1] == (len(texts), len(texts))
    assert all(a[0] < b[0] for a, b in zip(seen, seen[1:]))
    assert all(t == len(texts) for _, t in seen)


def test_out_dtype_bf16_matches_f32(encoder):
    texts = _texts(20)
    ref = encoder.encode_texts(texts)
    got = encoder.encode_texts(texts, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, rtol=1 / 128, atol=1 / 128)
    # the cast happens on the device, before the copy out: the device
    # rows of return_device carry the same bits
    pair = encoder.encode_texts(texts, out_dtype=torch.bfloat16,
                                return_device=True)
    assert torch.equal(pair.host, got) and torch.equal(pair.device, got)
