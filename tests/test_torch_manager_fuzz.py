"""The incremental re-index under seeded tree edits (those of
``tests/test_manager_fuzz.py``: create, modify, delete, touch), through
the port's ``IndexManager`` and ``sema_tpu``'s side by side on the same
tree, with test-tiny's weights carried across (``params_from_jax``), f32
encoders and f32 stores. After every re-index both managers must hold the
same live rows (the chunker's count over the live tree), find each live
file's planted token by keyword and no deleted file's, and answer a
semantic query with the same chunks; the port embeds only what changed."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.index.manager import IndexManager as JaxManager
from sema_tpu.ingest.chunker import process_files
from sema_tpu.models import Encoder as JaxEncoder
from sema_tpu.models import get_spec as jax_spec
from sema_tpu.models.loader import random_params
from sema_tpu.tokenizer import HashTokenizer as JaxHashTokenizer
from sema_tpu_torch.index.manager import IndexManager
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import params_from_jax
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.tokenizer import HashTokenizer

QUERIES = ("word3 word10 word17", "uniqtok2v1 word40")


class CountingEncoder:
    """An encoder and a count of the texts it embedded."""

    def __init__(self, enc):
        self._enc = enc
        self.spec = enc.spec
        self.embedded = 0

    def __getattr__(self, name):
        return getattr(self._enc, name)

    def encode_texts(self, texts, *a, **k):
        self.embedded += len(texts)
        return self._enc.encode_texts(texts, *a, **k)


def _managers(tmp_path):
    weights = random_params(jax_spec("test-tiny"))
    jenc = JaxEncoder(jax_spec("test-tiny"), weights,
                      JaxHashTokenizer(jax_spec("test-tiny").vocab_size),
                      batch_size=8, compute_dtype=jnp.float32)
    spec = get_spec("test-tiny")
    penc = CountingEncoder(Encoder(spec, params_from_jax(weights),
                                   HashTokenizer(spec.vocab_size),
                                   batch_size=8, compute_dtype=torch.float32,
                                   device="cpu"))
    return (JaxManager(tmp_path / "jax-data", jenc, store_dtype="float32"),
            IndexManager(tmp_path / "port-data", penc,
                         store_dtype="float32"), penc)


def _file_text(fid: int, version: int) -> str:
    token = f"uniqtok{fid}v{version}"
    body = " ".join(f"word{(fid * 31 + i * 7 + version) % 97}"
                    for i in range(60))
    return f"{token} {body}\n" * 12


def _hits(mgr, query, limit=5):
    return [(c.id, str(c.file_path), c.start_line, c.end_line)
            for c, _ in mgr.search(query, limit=limit)]


def _same_hits(got, want, q, tol=2e-5):
    """The same chunks, scores within ``tol``; a file's repeated lines
    make chunks of the same text, whose scores differ in the last bits
    from batch to batch, so two chunks may swap only within such a tie
    (another slot's score within ``tol`` of theirs)."""
    assert len(got) == len(want), q
    gs = np.array([s for _, s in got])
    ws = np.array([s for _, s in want])
    np.testing.assert_allclose(gs, ws, atol=tol)
    for i, ((g, _), (w, _)) in enumerate(zip(got, want)):
        if g.id != w.id:
            near = np.abs(ws - ws[i]) <= tol
            assert near.sum() >= 2, (q, i, g.id, w.id)


@pytest.mark.parametrize("seed", [11, 57])
def test_incremental_index_fuzz_matches_jax(tmp_path, seed):
    rng = random.Random(seed)
    tree = tmp_path / "tree"
    tree.mkdir()
    jmgr, pmgr, penc = _managers(tmp_path)
    live, dead, next_fid = {}, set(), 0

    def reindex():
        files = sorted(tree.glob("*.txt"))
        got = [m.process_and_index_files(files) for m in (jmgr, pmgr)]
        assert got[0] == got[1]
        for m in (jmgr, pmgr):
            for fid in dead:
                p = tree / f"f{fid}.txt"
                if m.vector_store.get_file_hash(p) is not None:
                    m.vector_store.remove_file_chunks(p)
                    m.text_index.remove_file_chunks(p)
                    m.vector_store.remove_file_hash(p)

    def check():
        want_rows = len(process_files(sorted(tree.glob("*.txt"))))
        assert (pmgr.vector_store.live_rows == jmgr.vector_store.live_rows
                == want_rows)
        for fid, ver in live.items():
            hits = _hits(pmgr, f"'uniqtok{fid}v{ver}")
            assert hits and hits == _hits(jmgr, f"'uniqtok{fid}v{ver}")
            assert all(h[1] == str(tree / f"f{fid}.txt") for h in hits)
        for fid in dead:
            assert not _hits(pmgr, f"'uniqtok{fid}v0")
            assert not _hits(jmgr, f"'uniqtok{fid}v0")
        for q in QUERIES:
            _same_hits(pmgr.search(q, limit=8), jmgr.search(q, limit=8), q)

    for _ in range(18):
        op = rng.random()
        if op < 0.4 or not live:                      # create
            fid, next_fid = next_fid, next_fid + 1
            (tree / f"f{fid}.txt").write_text(_file_text(fid, 0))
            live[fid] = 0
        elif op < 0.65:                               # modify
            fid = rng.choice(sorted(live))
            live[fid] += 1
            (tree / f"f{fid}.txt").write_text(_file_text(fid, live[fid]))
        elif op < 0.8 and len(live) > 1:              # delete
            fid = rng.choice(sorted(live))
            (tree / f"f{fid}.txt").unlink()
            del live[fid]
            dead.add(fid)
        else:                                         # touch, no change
            fid = rng.choice(sorted(live))
            p = tree / f"f{fid}.txt"
            p.write_text(p.read_text())
        before = penc.embedded
        reindex()
        one_file = len(process_files(
            [tree / f"f{max(live, default=0)}.txt"])) if live else 0
        assert penc.embedded - before <= max(one_file, 4) * 2
        check()

    before = penc.embedded
    reindex()
    assert penc.embedded == before
    check()
    jmgr.close()
    pmgr.close()
