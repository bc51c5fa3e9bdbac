"""The store's and the encoder's environment settings in the port, held
against ``sema_tpu`` under the same variables: ``SEMA_TPU_IVF``,
``SEMA_TPU_IVF_MIN_RECALL`` (with ``SEMA_TPU_IVF_NPROBE``),
``SEMA_TPU_SEAL_ROWS`` and ``SEMA_TPU_BUCKETS=off``, and
``spill_ivf_bench``'s exact reopen under an inherited ``SEMA_TPU_IVF``."""

import importlib
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.models.encoder import Encoder as JaxEncoder
from sema_tpu.models.loader import random_params
from sema_tpu.models.registry import get_spec as jax_spec
from sema_tpu.tokenizer import HashTokenizer as JaxHashTokenizer
from sema_tpu.types import Chunk as JaxChunk
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import params_from_jax
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.tokenizer import HashTokenizer
from sema_tpu_torch.tools import spill_ivf_bench
from sema_tpu_torch.types import Chunk

store_mod = importlib.import_module("sema_tpu_torch.index.vector_store")
DIM = 64
SETTINGS = ("SEMA_TPU_IVF", "SEMA_TPU_IVF_MIN_RECALL", "SEMA_TPU_IVF_NPROBE",
            "SEMA_TPU_SEAL_ROWS", "SEMA_TPU_BUCKETS")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in SETTINGS:
        monkeypatch.delenv(name, raising=False)


def _unit(n, seed, centres=0):
    rng = np.random.default_rng(seed)
    if centres:         # rows around ``centres`` unit centres (IVF data)
        c = rng.standard_normal((centres, DIM)).astype(np.float32)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        x = c[rng.integers(0, centres, n)] + 0.6 * rng.standard_normal(
            (n, DIM)).astype(np.float32) / np.sqrt(DIM)
    else:
        x = rng.standard_normal((n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _chunks(cls, n, first):
    return [cls(id=f"c{first + i}", file_path=Path(f"/src/f{i % 7}.py"),
                start_line=i + 1, end_line=i + 2, content=f"row {first + i}")
            for i in range(n)]


def _stores(tmp_path, **kw):
    """The JAX package's store and the port's (on the CPU), same args."""
    js = JaxStore(tmp_path / "jax", DIM, "settings", **kw)
    ps = VectorStore(tmp_path / "port", DIM, "settings", device="cpu", **kw)
    return js, ps


def _settings(store):
    return (store.ivf, store.ivf_min_recall, store._ivf_route_exact,
            store.ivf_nprobe, store.SEAL_ROWS)


@pytest.mark.parametrize("env,kw,want", [
    # SEMA_TPU_IVF: "" and "0" off, any other value on, unset the argument
    ({}, {"ivf": True}, (True, 0.0, False, 32, 262_144)),
    ({"SEMA_TPU_IVF": "1"}, {}, (True, 0.0, False, 32, 262_144)),
    ({"SEMA_TPU_IVF": "yes"}, {}, (True, 0.0, False, 32, 262_144)),
    ({"SEMA_TPU_IVF": "0"}, {"ivf": True}, (False, 0.0, False, 32, 262_144)),
    ({"SEMA_TPU_IVF": ""}, {"ivf": True}, (False, 0.0, False, 32, 262_144)),
    # SEMA_TPU_IVF_MIN_RECALL over the argument; 0.97 routes exact
    ({"SEMA_TPU_IVF": "1", "SEMA_TPU_IVF_MIN_RECALL": "0.97"}, {},
     (True, 0.97, True, 32, 262_144)),
    ({"SEMA_TPU_IVF_MIN_RECALL": "0.945"}, {"ivf": True,
                                            "ivf_min_recall": 0.5},
     (True, 0.945, False, 64, 262_144)),
    ({"SEMA_TPU_IVF_MIN_RECALL": "0.945"}, {"ivf": True, "ivf_nprobe": 8},
     (True, 0.945, False, 64, 262_144)),
    ({"SEMA_TPU_IVF_MIN_RECALL": "0.94"}, {"ivf": True, "ivf_nprobe": 8},
     (True, 0.94, False, 32, 262_144)),
    # an explicit SEMA_TPU_IVF_NPROBE wins over the contract's nprobe
    ({"SEMA_TPU_IVF_MIN_RECALL": "0.945", "SEMA_TPU_IVF_NPROBE": "5"},
     {"ivf": True}, (True, 0.945, False, 5, 262_144)),
    # the contract applies only with IVF on
    ({"SEMA_TPU_IVF": "0", "SEMA_TPU_IVF_MIN_RECALL": "0.99"},
     {"ivf": True}, (False, 0.99, False, 32, 262_144)),
    # SEMA_TPU_SEAL_ROWS: a positive int, at least 1; empty is unset
    ({"SEMA_TPU_SEAL_ROWS": "96"}, {}, (False, 0.0, False, 32, 96)),
    ({"SEMA_TPU_SEAL_ROWS": "0"}, {}, (False, 0.0, False, 32, 1)),
    ({"SEMA_TPU_SEAL_ROWS": ""}, {}, (False, 0.0, False, 32, 262_144)),
])
def test_store_settings_match_jax(tmp_path, monkeypatch, env, kw, want):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    js, ps = _stores(tmp_path, **kw)
    assert _settings(js) == want
    assert _settings(ps) == want
    js.close()
    ps.close()


def test_seal_rows_env_shadows_only_when_set(tmp_path, monkeypatch):
    """Unset, a store reads the class constant, so a test that patches
    the class wins; set, the instance attribute shadows the class."""
    for cls in (JaxStore, VectorStore):
        monkeypatch.setattr(cls, "SEAL_ROWS", 512)
    js, ps = _stores(tmp_path)
    assert js.SEAL_ROWS == ps.SEAL_ROWS == 512
    assert "SEAL_ROWS" not in vars(ps)
    monkeypatch.setenv("SEMA_TPU_SEAL_ROWS", "96")
    js2, ps2 = _stores(tmp_path / "again")
    assert js2.SEAL_ROWS == ps2.SEAL_ROWS == vars(ps2)["SEAL_ROWS"] == 96
    assert VectorStore.SEAL_ROWS == 512
    for s in (js, ps, js2, ps2):
        s.close()


@pytest.mark.parametrize("value", ["abc", "1.5", "96rows"])
def test_malformed_seal_rows_warns_and_keeps_default(tmp_path, monkeypatch,
                                                    capsys, value):
    monkeypatch.setenv("SEMA_TPU_SEAL_ROWS", value)
    want = f"Warning: ignoring malformed SEMA_TPU_SEAL_ROWS={value!r}"
    js = JaxStore(tmp_path / "jax", DIM, "settings")
    jax_err = capsys.readouterr().err
    ps = VectorStore(tmp_path / "port", DIM, "settings", device="cpu")
    port_err = capsys.readouterr().err
    assert want in jax_err and want in port_err
    assert js.SEAL_ROWS == ps.SEAL_ROWS == 262_144
    js.close()
    ps.close()


@pytest.mark.parametrize("batches", [(300,), (100, 100, 100), (40, 200, 60)])
def test_seal_rows_env_same_buckets(tmp_path, monkeypatch, batches):
    """300 rows at SEMA_TPU_SEAL_ROWS=96: the same buckets, sealed the
    same, in both packages, and the same answers."""
    monkeypatch.setenv("SEMA_TPU_SEAL_ROWS", "96")
    js, ps = _stores(tmp_path)
    first = 0
    for n in batches:
        rows = _unit(n, first)
        js.add_chunks(_chunks(JaxChunk, n, first), rows)
        ps.add_chunks(_chunks(Chunk, n, first), rows)
        first += n
    jb, pb = js.device_buckets(), ps.device_buckets()
    assert len(pb) == len(jb)
    assert [b["sealed"] for b in pb] == [b["sealed"] for b in jb]
    assert any(b["sealed"] for b in pb)
    q = _unit(3, 99)
    want, got = js.search_batch(q, 10), ps.search_batch(q, 10)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    js.close()
    ps.close()


SEALED = 2048


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_min_recall_env_answers_exactly(tmp_path, monkeypatch, dtype):
    """IVF on through SEMA_TPU_IVF and SEMA_TPU_IVF_MIN_RECALL=0.97: the
    port routes every query to the exact scan and answers with the JAX
    package's ids; without the variable the same store probes (its pruned
    scan runs)."""
    for cls in (JaxStore, VectorStore):
        monkeypatch.setattr(cls, "SEAL_ROWS", SEALED)
        monkeypatch.setattr(cls, "IVF_TILE", 128)
        monkeypatch.setattr(cls, "IVF_CLUSTER_ROWS", 128)
    monkeypatch.setenv("SEMA_TPU_IVF", "1")
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "1")
    monkeypatch.setenv("SEMA_TPU_IVF_MIN_RECALL", "0.97")
    calls = []
    pruned = ("scan_topk_int8_pruned" if dtype == "int8"
              else "scan_topk_pruned")
    fn = getattr(store_mod, pruned)
    monkeypatch.setattr(store_mod, pruned,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    rows = _unit(SEALED + 100, 0, centres=40)
    q = np.concatenate([rows[[5, 1500, 2090]], _unit(5, 7, centres=40)])
    js, ps = _stores(tmp_path, store_dtype=dtype)
    for s, cls in ((js, JaxChunk), (ps, Chunk)):
        s.add_chunks(_chunks(cls, SEALED, 0), rows[:SEALED])
        s.add_chunks(_chunks(cls, 100, SEALED), rows[SEALED:])
    assert ps.ivf and ps._ivf_route_exact and js._ivf_route_exact
    assert any(b["ivf"] is not None for b in ps.device_buckets())
    want = js.search_batch(q, 10)
    got = ps.search_batch(q, 10)
    exact = ps.search_batch(q, 10, exact=True)
    assert not calls
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[1], exact[1])
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-5)
    js.close()
    ps.close()

    # non-vacuity: the same store without the contract probes at nprobe 1
    monkeypatch.delenv("SEMA_TPU_IVF_MIN_RECALL")
    ps = VectorStore(tmp_path / "port", DIM, "settings", store_dtype=dtype,
                     device="cpu")
    assert ps.ivf and not ps._ivf_route_exact
    probed = [ps.search_batch(q[i:i + 1], 10) for i in range(len(q))]
    assert calls
    assert [int(s[1][0, 0]) for s in probed[:3]] == [5, 1500, 2090]
    ps.close()


# -- SEMA_TPU_BUCKETS=off ------------------------------------------------------

TEXTS = (["hi"] * 3 + ["a few more words here now"] * 4
         + ["word " * 20] * 5 + ["longer " * 40] * 3 + ["x"])


def _encoders():
    js, ps = jax_spec("test-tiny"), get_spec("test-tiny")
    weights = random_params(js)
    # max_length 128 (test-tiny's position table), so that the 32 and 64
    # buckets are shorter than it
    jenc = JaxEncoder(js, weights, JaxHashTokenizer(js.vocab_size),
                      max_length=128, batch_size=8,
                      compute_dtype=jnp.float32)
    penc = Encoder(ps, params_from_jax(weights),
                   HashTokenizer(ps.vocab_size), max_length=128,
                   batch_size=8, compute_dtype=torch.float32, device="cpu")
    return jenc, penc


@pytest.mark.parametrize("value,bucketed", [("off", False), ("on", True),
                                            (None, True)])
def test_buckets_env_matches_jax(monkeypatch, value, bucketed):
    """``SEMA_TPU_BUCKETS=off``: every text at max_length, in both
    packages; otherwise by length buckets. The embeddings agree with the
    JAX package's either way."""
    if value is not None:
        monkeypatch.setenv("SEMA_TPU_BUCKETS", value)
    jenc, penc = _encoders()
    widths = []
    embed_ids = penc.embed_ids
    monkeypatch.setattr(penc, "embed_ids", lambda ids, mask: (
        widths.append(ids.shape[1]), embed_ids(ids, mask))[1])
    want = np.asarray(jenc.encode_texts(TEXTS))
    got = penc.encode_texts(TEXTS).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert widths
    if bucketed:
        assert min(widths) < penc.max_length
    else:
        assert set(widths) == {penc.max_length}
    # the length a text takes, as callers that count batches read it
    assert penc.bucket_len(5) == (32 if bucketed else penc.max_length)
    # padding-invariant: the unbucketed embeddings are the bucketed ones
    monkeypatch.setenv("SEMA_TPU_BUCKETS", "on")
    np.testing.assert_allclose(penc.encode_texts(TEXTS).numpy(), got,
                               atol=1e-5, rtol=0)


# -- spill_ivf_bench under an inherited SEMA_TPU_IVF ---------------------------

@pytest.mark.parametrize("inherited", ["1", None])
def test_spill_ivf_bench_reopen_is_exact(monkeypatch, capsys, inherited):
    """The tool sets SEMA_TPU_IVF for each of its two opens, as the JAX
    tool does: the probe store opens with IVF and the reopen (the exact
    oracle) without it, whatever the caller exported; the caller's value
    is left as it was."""
    for name in ("SEAL_ROWS", "IVF_TILE", "IVF_CLUSTER_ROWS"):
        monkeypatch.setattr(VectorStore, name, getattr(VectorStore, name))
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "0.01")
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "2")
    if inherited is not None:
        monkeypatch.setenv("SEMA_TPU_IVF", inherited)
    opened = []

    class Recorded(VectorStore):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            opened.append(self.ivf)
    monkeypatch.setattr(spill_ivf_bench, "VectorStore", Recorded)
    rc = spill_ivf_bench.main([
        "--rows", "4096", "--dim", "64", "--seal-rows", "2048",
        "--slice-rows", "2048", "--centers", "64", "--nprobe", "2",
        "--repeats", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and opened == [True, False]
    assert 0.0 <= line["recall_at_k"] <= 1.0
    assert os.environ.get("SEMA_TPU_IVF") == inherited
