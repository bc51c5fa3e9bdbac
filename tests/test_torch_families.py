"""The four public model families of the port held against ``sema_tpu``:
the registries, each family's ``Encoder`` at full width (2 layers) on the
same carried weights in f32, and ``index`` then ``query`` through both
CLIs at bge-small-en's widths, whose [CLS] pooling no other test reaches."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu import cli as jax_cli
from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.models import encoder as jax_encoder
from sema_tpu.models.encoder import Encoder as JaxEncoder
from sema_tpu.models.loader import random_params
from sema_tpu.models.registry import ENCODERS as JAX_ENCODERS
from sema_tpu.tokenizer import HashTokenizer as JaxHashTokenizer
from sema_tpu_torch import cli
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.models import encoder as port_encoder
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import params_from_jax
from sema_tpu_torch.models.registry import ENCODERS
from sema_tpu_torch.tokenizer import HashTokenizer

FAMILIES = ("minilm-l6", "bge-small-en", "e5-base", "gte-large")
# lengths that share one bucket, so that most rows of a batch are padded
TEXTS = ["retry the request with exponential backoff " * 3,
         "parse tokens",
         "socket buffer stream " * 2,
         "x",
         "vector index query cache " * 5]
QUERY = "exponential backoff for a socket retry"


def test_registries_equal():
    assert set(ENCODERS) == set(JAX_ENCODERS)
    for name, spec in ENCODERS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            JAX_ENCODERS[name]), name
    assert {ENCODERS[n].pooling for n in FAMILIES} == {"mean", "cls"}


@pytest.mark.parametrize("name", FAMILIES)
def test_family_encoder_matches_jax(name):
    """Full width, 2 layers, the same weights in f32: ``encode_texts``
    (one bucket of 64, the short texts padded, so CLS pooling and the
    masked mean see padding) and ``encode_query`` (padded to max_length)
    agree with the JAX package's ``Encoder`` within 2e-5."""
    spec = dataclasses.replace(ENCODERS[name], num_layers=2)
    jspec = dataclasses.replace(JAX_ENCODERS[name], num_layers=2)
    weights = random_params(jspec, seed=3)
    jenc = JaxEncoder(jspec, weights, JaxHashTokenizer(jspec.vocab_size),
                      max_length=64, batch_size=8,
                      compute_dtype=jnp.float32)
    penc = Encoder(spec, params_from_jax(weights),
                   HashTokenizer(spec.vocab_size), max_length=64,
                   batch_size=8, compute_dtype=torch.float32, device="cpu")
    want = np.asarray(jenc.encode_texts(TEXTS))
    got = penc.encode_texts(TEXTS).numpy()
    assert got.shape == (len(TEXTS), spec.dim)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    q_want = np.asarray(jenc.encode_query(QUERY))
    q_got = np.asarray(penc.encode_query(QUERY))
    np.testing.assert_allclose(q_got, q_want, atol=2e-5, rtol=0)
    # the pooling is the family's: CLS reads token 0 alone, so a text's
    # CLS row differs from its masked mean
    if spec.pooling == "cls":
        from sema_tpu_torch.models import bert
        ids, mask = (torch.as_tensor(a) for a in penc.tokenize_batch(
            TEXTS[:2]))
        hidden = bert.bert_forward(penc.params, ids, mask, spec,
                                   torch.float32)
        mean = bert.mean_pool_normalize(hidden, mask)
        cls = bert.cls_pool_normalize(hidden, mask)
        assert not torch.allclose(mean, cls, atol=1e-3)
        np.testing.assert_allclose(cls.numpy(), got[:2], atol=2e-5)


# -- index -> query at bge-small-en's widths -------------------------------

@pytest.fixture()
def tree(tmp_path):
    root = tmp_path / "tree"
    (root / "pkg").mkdir(parents=True)
    words = ["parse", "token", "retry", "socket", "vector", "index", "query",
             "cache", "buffer", "stream"]
    rng = np.random.default_rng(0)
    for f in range(3):
        lines = [f"def f{f}_{i}(x):  # " + " ".join(
            rng.choice(words, size=8)) for i in range(40)]
        (root / "pkg" / f"mod{f}.py").write_text("\n".join(lines) + "\n")
    (root / "notes.md").write_text(
        "# HTTP networking\nRetry logic with exponential backoff.\n" * 12)
    return root


def _bge(load):
    def patched(args):
        config = load(args)
        config.model.name = "bge-small-en"
        config.model.dtype = "float32"
        config.model.max_length = 64
        config.model.batch_size = 8
        config.index.store_dtype = "float32"
        return config
    return patched


def _record_row_ids(monkeypatch, store_cls, sink):
    orig = store_cls.search_batch

    def search_batch(self, *a, **k):
        scores, ids = orig(self, *a, **k)
        sink.append([int(i) for s, i in zip(scores[0], ids[0])
                     if np.isfinite(s)])
        return scores, ids
    monkeypatch.setattr(store_cls, "search_batch", search_batch)


def _run(main, tree, capsys, extra=()):
    assert main(["index", str(tree), *extra]) == 0
    first = capsys.readouterr().out
    results = []
    for q in (QUERY, "parse the token stream"):
        assert main(["query", q, "--json", "--limit", "8", *extra]) == 0
        results.append([json.loads(line) for line in
                        capsys.readouterr().out.splitlines()])
    return first, results


def test_bge_small_index_query_matches_jax(tmp_path, tree, monkeypatch,
                                           capsys):
    """bge-small-en's 12 layers at its widths, CLS pooling, random weights
    carried across, f32 encoder and store: both CLIs index the same
    chunks and answer with the same files, lines and row ids."""
    monkeypatch.setenv("SEMA_TPU_HOME", str(tmp_path / "home"))
    weights = random_params(JAX_ENCODERS["bge-small-en"], seed=0)
    monkeypatch.setattr(jax_encoder, "load_params",
                        lambda spec, path: (weights, "random"))
    monkeypatch.setattr(port_encoder, "load_params",
                        lambda spec, path: (params_from_jax(weights),
                                            "random"))
    monkeypatch.setattr(jax_cli, "load_config", _bge(jax_cli.load_config))
    monkeypatch.setattr(cli, "load_config", _bge(cli.load_config))
    jax_rows, port_rows = [], []
    _record_row_ids(monkeypatch, JaxStore, jax_rows)
    _record_row_ids(monkeypatch, VectorStore, port_rows)

    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "jax-data"))
    j_first, j_results = _run(jax_cli.main, tree, capsys)
    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "port-data"))
    p_first, p_results = _run(cli.main, tree, capsys,
                              extra=("--device", "cpu"))

    n_chunks = int(p_first.split("indexed ")[1].split()[0])
    assert n_chunks > 4 and f"indexed {n_chunks} chunks" in j_first
    key = lambda r: (r["id"], r["file_path"], r["start_line"], r["end_line"])
    for want, got in zip(j_results, p_results):
        assert got and [key(r) for r in got] == [key(r) for r in want]
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in want], atol=2e-5)
    assert len(port_rows) == len(jax_rows) == 2
    assert port_rows == jax_rows and all(port_rows)
    vecs = VectorStore(tmp_path / "port-data", 384, "bge-small-en",
                       store_dtype="float32", device="cpu")
    assert vecs.model == "bge-small-en" and vecs.live_rows == n_chunks
    vecs.close()
