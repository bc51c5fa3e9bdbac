"""End to end on the CPU: ``index`` then ``query`` through each package's
CLI, on one fixture tree, with the tiny encoder in f32, the same carried
weights and an f32 store. Both must return the same files, lines and row
ids, and a second ``index`` run must index nothing."""

import json

import numpy as np
import pytest

from sema_tpu import cli as jax_cli
from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.models import encoder as jax_encoder
from sema_tpu.models.loader import random_params
from sema_tpu.models.registry import get_spec
from sema_tpu_torch import cli
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.models import encoder as port_encoder
from sema_tpu_torch.models.loader import params_from_jax

QUERIES = ["parse arithmetic expressions", "retry with exponential backoff",
           "'backoff"]


@pytest.fixture()
def tree(tmp_path):
    root = tmp_path / "tree"
    (root / "pkg").mkdir(parents=True)
    words = ["parse", "token", "retry", "socket", "vector", "index", "query",
             "cache", "buffer", "stream"]
    rng = np.random.default_rng(0)
    for f in range(6):
        lines = [f"def f{f}_{i}(x):  # " + " ".join(
            rng.choice(words, size=8)) for i in range(60)]
        (root / "pkg" / f"mod{f}.py").write_text("\n".join(lines) + "\n")
    (root / "notes.md").write_text(
        "# HTTP networking\nRetry logic with exponential backoff.\n" * 20)
    (root / ".gitignore").write_text("*.log\n")
    (root / "noise.log").write_text("not indexed " * 50)
    return root


def _tiny(load):
    def patched(args):
        config = load(args)
        config.model.name = "test-tiny"
        config.model.dtype = "float32"
        config.model.max_length = 32
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
    """index, index again, then each query; returns what was printed."""
    assert main(["index", str(tree), *extra]) == 0
    first = capsys.readouterr().out
    assert main(["index", str(tree), *extra]) == 0
    second = capsys.readouterr().out
    results = []
    for q in QUERIES:
        assert main(["query", q, "--json", "--limit", "8", *extra]) == 0
        results.append([json.loads(line) for line in
                        capsys.readouterr().out.splitlines()])
    return first, second, results


def test_index_query_matches_jax_package(tmp_path, tree, monkeypatch,
                                         capsys):
    monkeypatch.setenv("SEMA_TPU_HOME", str(tmp_path / "home"))
    weights = random_params(get_spec("test-tiny"))
    monkeypatch.setattr(jax_encoder, "load_params",
                        lambda spec, path: (weights, "random"))
    monkeypatch.setattr(port_encoder, "load_params",
                        lambda spec, path: (params_from_jax(weights),
                                            "random"))
    monkeypatch.setattr(jax_cli, "load_config", _tiny(jax_cli.load_config))
    monkeypatch.setattr(cli, "load_config", _tiny(cli.load_config))
    jax_rows, port_rows = [], []
    _record_row_ids(monkeypatch, JaxStore, jax_rows)
    _record_row_ids(monkeypatch, VectorStore, port_rows)

    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "jax-data"))
    j_first, j_second, j_results = _run(jax_cli.main, tree, capsys)
    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "port-data"))
    p_first, p_second, p_results = _run(cli.main, tree, capsys,
                                        extra=("--device", "cpu"))

    assert "crawled 7 files" in p_first
    n_chunks = int(p_first.split("indexed ")[1].split()[0])
    assert n_chunks > 10 and f"indexed {n_chunks} chunks" in j_first
    assert "indexed 0 chunks" in j_second and "indexed 0 chunks" in p_second

    key = lambda r: (r["id"], r["file_path"], r["start_line"], r["end_line"])
    for q, want, got in zip(QUERIES, j_results, p_results):
        assert got, q
        assert [key(r) for r in got] == [key(r) for r in want], q
        # f32 encoder and store: scores agree to f32 rounding
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in want], atol=2e-5)
    # the two semantic queries scanned the vector store in both packages
    assert len(port_rows) == len(jax_rows) == 2
    assert port_rows == jax_rows and all(port_rows)
