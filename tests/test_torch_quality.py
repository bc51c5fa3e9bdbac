"""The port's semantic quality gate (``sema_tpu_torch/quality.py``, a
headed copy of ``sema_tpu/quality.py``): the cases of
``tests/test_quality_gate.py`` with encoder doubles shaped like the port's
``Encoder``, the fixture cross-check on its torch output, and the gate on
random ``test-tiny`` weights against ``sema_tpu``'s on the same weights."""

import hashlib
import os
import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.index.manager import IndexManager as JaxIndexManager
from sema_tpu.models.encoder import Encoder as JaxEncoder
from sema_tpu.models.loader import random_params
from sema_tpu.models.registry import get_spec as jax_spec
from sema_tpu.quality import run_quality_gate as jax_gate
from sema_tpu.tokenizer import HashTokenizer as JaxHashTokenizer
from sema_tpu_torch import quality
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import params_from_jax
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.quality import (CORPUS, QUERIES, QualityReport,
                                    run_quality_gate)
from sema_tpu_torch.tokenizer import HashTokenizer


class _FakeEncoder:
    """Encoder-shaped test double on the CPU (the surface IndexManager
    calls: ``spec``, ``device``, ``encode_texts`` returning a tensor,
    ``encode_query_device``); subclasses define _vec(text)."""

    weights_source = "local"
    tokenizer_source = "local"
    device = torch.device("cpu")

    def __init__(self, dim=32):
        self.spec = SimpleNamespace(name="test-tiny", dim=dim)

    def encode_texts(self, texts, progress=None, out_dtype=torch.float32):
        out = torch.from_numpy(np.stack([self._vec(t) for t in texts]))
        if progress:
            progress(len(texts), len(texts))
        return out.to(out_dtype)

    def encode_query_device(self, text):
        return torch.from_numpy(self._vec(text))


class PerfectEncoder(_FakeEncoder):
    """Maps each doc and its paraphrase query to the same basis vector."""

    def __init__(self):
        super().__init__(dim=max(32, len(CORPUS)))
        self._doc_axis = {name: i for i, name in enumerate(sorted(CORPUS))}
        self._query_axis = {q: self._doc_axis[doc] for q, doc in QUERIES}

    def _vec(self, text):
        v = np.zeros(self.spec.dim, np.float32)
        for name, content in CORPUS.items():
            if content == text or content.startswith(text[:40]):
                v[self._doc_axis[name]] = 1.0
                return v
        if text in self._query_axis:
            v[self._query_axis[text]] = 1.0
            return v
        v[-1] = 1.0
        return v


class GarbageEncoder(_FakeEncoder):
    """Deterministic but semantically meaningless (hash-seeded random)."""

    def _vec(self, text):
        seed = int.from_bytes(
            hashlib.sha256(text.encode()).digest()[:4], "big")
        v = np.random.default_rng(seed).standard_normal(self.spec.dim)
        return (v / np.linalg.norm(v)).astype(np.float32)


class RandomWeightsEncoder(_FakeEncoder):
    weights_source = "random"

    def _vec(self, text):
        return np.ones(self.spec.dim, np.float32)


def test_gate_passes_with_perfect_encoder():
    report = run_quality_gate(PerfectEncoder())
    assert report.ran
    assert report.correct_at_1 == report.total == len(QUERIES)
    assert report.passed
    assert report.fixture_checked is None  # no fixture for test-tiny


def test_gate_fails_with_garbage_encoder():
    """The gate must have teeth: meaningless embeddings cannot pass."""
    report = run_quality_gate(GarbageEncoder())
    assert report.ran
    assert not report.passed
    assert report.failures


def test_gate_skips_on_random_weights():
    report = run_quality_gate(RandomWeightsEncoder())
    assert not report.ran
    assert "random" in report.reason and "--weights" in report.reason
    assert "fetch_weights" not in report.reason
    assert not report.passed


def test_corpus_queries_consistent():
    """Every query targets an existing doc; every doc fits in one chunk
    (< 1000 bytes, the chunk window) so retrieval is file-granular."""
    for q, doc in QUERIES:
        assert doc in CORPUS, doc
    for name, text in CORPUS.items():
        assert 50 <= len(text.encode()) < 1000, name
    assert len(QUERIES) >= 10


def test_fixture_cross_check_on_the_ports_tensor_output(tmp_path,
                                                        monkeypatch):
    """A fixture of the encoder's own vectors (what an HF export of the
    same model would hold) passes the cosine check: the port's encoder
    returns a torch tensor, which the check takes as an array."""
    enc = PerfectEncoder()
    names = sorted(CORPUS)
    queries = [q for q, _ in QUERIES]
    path = tmp_path / "quality_vectors_test-tiny.npz"
    np.savez(path, doc_names=np.array(names), query_texts=np.array(queries),
             doc_vectors=enc.encode_texts([CORPUS[n] for n in names]).numpy(),
             query_vectors=enc.encode_texts(queries).numpy())
    monkeypatch.setattr(quality, "_fixture_path", lambda name: path)
    report = QualityReport(ran=True)
    quality.check_fixture_vectors(enc, report)
    assert report.fixture_checked == len(names) + len(queries)
    assert report.fixture_min_cosine == pytest.approx(1.0, abs=1e-6)


def _real_encoder_or_none():
    from sema_tpu_torch.models.loader import load_params

    weights = os.environ.get("SEMA_TPU_WEIGHTS", "")
    spec = get_spec(os.environ.get("SEMA_TPU_QUALITY_MODEL", "minilm-l6"))
    try:
        params, source = load_params(spec, weights)
    except FileNotFoundError:
        return None
    if source == "random":
        return None
    cfg = SimpleNamespace(name=spec.name, weights_path=weights,
                          dtype="float32", max_length=None, batch_size=32,
                          quant="none")
    return Encoder.from_config(cfg, device="cpu")


def test_real_weights_semantic_quality():
    """With real MiniLM weights, every paraphrase query must rank its
    document #1 (and match the fixture vectors, where present). Skips
    here: no weights on this host, and the port downloads none."""
    encoder = _real_encoder_or_none()
    if encoder is None:
        pytest.skip("no real weights on this host (the port fetches "
                    "none); set SEMA_TPU_WEIGHTS to a local model dir")
    report = run_quality_gate(encoder)
    assert report.ran
    assert report.failures == []
    assert report.correct_at_1 == report.total
    if report.fixture_min_cosine is not None:
        assert report.fixture_min_cosine >= 0.999
    assert report.passed


MARGIN = 1e-4


def _jax_rank1_and_margins(jenc):
    """The JAX gate's own run (the canned corpus through sema_tpu's
    IndexManager, limit 3): each query's rank-1 file and its top-two
    score margin."""
    out = {}
    with tempfile.TemporaryDirectory() as td:
        corpus = Path(td) / "corpus"
        corpus.mkdir()
        for name, text in CORPUS.items():
            (corpus / name).write_text(text)
        mgr = JaxIndexManager(Path(td) / "data", jenc)
        try:
            mgr.process_and_index_files(sorted(corpus.iterdir()))
            for query, _ in QUERIES:
                hits = mgr.search(query, limit=3)
                out[query] = (hits[0][0].file_path.name,
                              hits[0][1] - hits[1][1])
        finally:
            mgr.close()
    return out


def _rank1(report):
    got = {q: expected for q, expected in QUERIES}
    got.update({q: g for q, _, g in report.failures})
    return got


def test_gate_agrees_with_sema_tpu_on_random_weights():
    """Random test-tiny weights carried across (``params_from_jax``), f32
    on both sides: the port's gate ranks the same file first as
    ``sema_tpu``'s for every query whose top-two margin in the JAX run
    exceeds MARGIN. With these weights that is all 12 queries (the least
    margin is 1.6e-4), and their rank-1 files are the JAX gate's."""
    js = jax_spec("test-tiny")
    jparams = random_params(js)
    jenc = JaxEncoder(js, jparams, JaxHashTokenizer(js.vocab_size),
                      batch_size=8, compute_dtype=jnp.float32)
    ps = get_spec("test-tiny")
    penc = Encoder(ps, params_from_jax(jparams),
                   HashTokenizer(ps.vocab_size), batch_size=8,
                   compute_dtype=torch.float32, device="cpu")
    jax_report = jax_gate(jenc, require_real_weights=False)
    report = run_quality_gate(penc, require_real_weights=False)
    assert jax_report.ran and report.ran
    jax_run = _jax_rank1_and_margins(jenc)
    assert {q: f for q, (f, _) in jax_run.items()} == _rank1(jax_report)
    clear = [q for q, (_, m) in jax_run.items() if m > MARGIN]
    assert len(clear) == 12
    got = _rank1(report)
    assert {q: got[q] for q in clear} == {q: jax_run[q][0] for q in clear}
