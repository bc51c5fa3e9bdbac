"""Store format, both ways: a vector index written by ``sema_tpu``'s
``VectorStore`` opens in the port's and answers with the same row ids, and
the reverse, through tombstones, a re-open and a load-time compaction."""

from pathlib import Path

import numpy as np
import pytest
import torch

from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.types import Chunk as JaxChunk
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.types import Chunk

DIM = 64
MODEL = "test-tiny"


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, DIM)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _chunks(cls, n, first, files=5):
    return [cls(id=f"c{first + i}", file_path=Path(f"/src/f{i % files}.py"),
                start_line=i + 1, end_line=i + 3, content=f"row {first + i}")
            for i in range(n)]


def _queries(seed=99):
    return _rows(4, seed)


def _finite_ids(scores, ids):
    return [list(np.asarray(i)[np.isfinite(s)]) for s, i in zip(scores, ids)]


def _port(tmp_path, dtype):
    return VectorStore(tmp_path, DIM, MODEL, store_dtype=dtype, device="cpu")


def _jax(tmp_path, dtype):
    return JaxStore(tmp_path, DIM, MODEL, store_dtype=dtype)


def _fill(store, chunk_cls, as_tensor=False):
    """Two segments, 120 + 80 rows, then one file's rows tombstoned
    (40 of 200: under the 25% that compacts on load)."""
    for seed, (n, first) in enumerate(((120, 0), (80, 120))):
        rows = _rows(n, seed)
        store.add_chunks(_chunks(chunk_cls, n, first),
                         torch.from_numpy(rows) if as_tensor else rows)
    assert store.remove_file_chunks("/src/f3.py") == 40
    store.update_file_hash("/src/f0.py", "abc123")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_written_store_answers_in_the_port(tmp_path, dtype):
    js = _jax(tmp_path, dtype)
    _fill(js, JaxChunk)
    want = js.search_batch(_queries(), 16)
    js.close()

    ps = _port(tmp_path, dtype)
    assert ps.live_rows == 160 and ps.total_rows == 200
    assert ps.get_file_hash("/src/f0.py") == "abc123"
    got = ps.search_batch(_queries(), 16)
    assert _finite_ids(*got) == _finite_ids(*want)
    # scores are f32 sums over identical stored rows
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-5)
    top = int(got[1][0, 0])
    assert ps.chunk_at(top).id == f"c{top}"
    assert all("f3.py" not in str(ps.chunk_at(int(i)).file_path)
               for i in got[1].ravel())
    ps.close()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_written_store_answers_in_jax(tmp_path, dtype):
    ps = _port(tmp_path, dtype)
    _fill(ps, Chunk, as_tensor=True)
    want = ps.search_batch(_queries(), 16)
    ps.close()

    js = _jax(tmp_path, dtype)
    assert js.live_rows == 160
    got = js.search_batch(_queries(), 16)
    assert _finite_ids(*got) == _finite_ids(*want)
    assert js.chunk_at(int(want[1][1, 0])).content == f"row {want[1][1, 0]}"
    js.close()


def test_reopen_compacts_and_both_agree(tmp_path):
    ps = _port(tmp_path, "bfloat16")
    _fill(ps, Chunk)
    ps.remove_file_chunks("/src/f1.py")        # 80 of 200 dead: compacts
    ps.close()

    ps = _port(tmp_path, "bfloat16")           # the owner compacts on load
    assert ps.total_rows == ps.live_rows == 120
    assert len(ps.segments) == 1
    got = ps.search_batch(_queries(), 64)
    ids = [ps.chunk_at(int(i)).id for i in got[1][0] if i >= 0]
    ps.close()

    js = _jax(tmp_path, "bfloat16")
    assert js.total_rows == 120
    want = js.search_batch(_queries(), 64)
    assert _finite_ids(*got) == _finite_ids(*want)
    assert ids == [js.chunk_at(int(i)).id for i in want[1][0]]
    js.close()


def test_k_larger_than_live_rows_and_empty_store(tmp_path):
    ps = _port(tmp_path, "float32")
    s, i = ps.search_batch(_queries(), 5)
    assert s.shape == (4, 5) and np.isneginf(s).all() and (i == 0).all()
    assert ps.search(_queries()[0], 5) == []
    ps.add_chunks(_chunks(Chunk, 3, 0), _rows(3, 0))
    s, i = ps.search_batch(_queries(), 5)
    assert s.shape == i.shape == (4, 5)
    assert np.isfinite(s[:, :3]).all() and np.isneginf(s[:, 3:]).all()
    assert (i[:, 3:] == 0).all() and sorted(i[0, :3]) == [0, 1, 2]
    hits = ps.search(_queries()[0], 10)
    assert len(hits) == 3 and [h[1] for h in hits] == sorted(
        (h[1] for h in hits), reverse=True)
    assert ps.substring_scan("row 1", 10)[0][0].id == "c1"
    ps.close()


def test_int8_manifest_opens_in_the_port(tmp_path):
    """An int8 manifest opens in the port (the disk holds bf16
    originals) and answers as the JAX package does, also when the port is
    configured for another dtype (the disk format wins)."""
    js = _jax(tmp_path, "int8")
    js.add_chunks(_chunks(JaxChunk, 10, 0), _rows(10, 0))
    want = js.search_batch(_queries(), 5)
    js.close()
    ps = _port(tmp_path, "bfloat16")
    assert ps.store_dtype == "int8" and ps.quantized
    got = ps.search_batch(_queries(), 5)
    assert _finite_ids(*got) == _finite_ids(*want)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    ps.close()
    fresh = VectorStore(tmp_path / "other", DIM, MODEL, store_dtype="int8",
                        device="cpu")
    assert fresh.quantized and fresh.np_dtype == np.uint16
    fresh.close()
