"""The port's measuring tools (``sema_tpu_torch.tools``) on the CPU, at a
few thousand rows, against the JAX package's ``tools/``: their data is the
JAX tools' own bytes where those draw with numpy, ``load_test``'s serving
cases hold with 0 errors and 0 mismatches, the plain ablated attentions of
``encoder_ablate`` match the JAX tool's, and each tool's JSON line has the
JAX tool's keys plus ``device``, ``launches`` and the keys its docstring
names."""

import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.ops.attention import heads_attention
from sema_tpu_torch.tools import (encoder_ablate, index_build_bench,
                                  ivf_bench, load_test, query_breakdown,
                                  serving_sweep, spill_ivf_bench,
                                  text_index_scale)

REPO = Path(__file__).resolve().parents[1]

# each JAX tool's last-line keys, as its source writes them (nested dicts:
# "name.key" for the keys of each entry of ``name``)
JAX_KEYS = {
    "load_test": """capacity_qps capacity_batch_p50_ms capacity_seq_qps
        capacity_seq_batch_p50_ms batcher clients max_batch rows dim k
        duration_s warmup_s warmup_queries queries qps p50_ms p99_ms errors
        errors_steady mismatches mutated_batches live_rows_end build_s
        warm_s residency ivf store_dtype hbm_budget_mb scan_paths""",
    "spill_ivf_bench": """metric value unit rows dim q_batch recall_at_k k
        recall_queries recall_p5 recall_min probe_batch_s streamed_batch_s
        probe_upload_mb streamed_upload_mb probed_tiles staged_tiles
        spilled_buckets total_tiles nprobe store_dtype exact_oracle_only
        split_ab backend""",
    "query_breakdown": """rows tokenize_ms rtt_ms embed_device_ms
        scan_device_ms embed_e2e_ms search_e2e_ms residual_ms
        residual_in_rtts device""",
    "ivf_bench": """metric rows dim k clusters tile budget_tiles q noise
        qnoise centers kmeans_build_s exact_single_query_ms device rungs
        rungs.recall_at_k rungs.recall_p5 rungs.recall_min
        rungs.single_query_ms_device rungs.tiles_scanned_frac
        rungs.host_probe_ms rungs.speedup_vs_exact""",
    "serving_sweep": """rows dim k max_batch capacity_qps_pipelined
        knee_clients rungs rungs.clients rungs.qps rungs.p50_ms rungs.p99_ms
        rungs.errors rungs.mismatches rungs.batcher rungs.frac_of_capacity""",
    "index_build_bench": """model quant files chunks tree_gen_s build_s
        chunks_per_sec_e2e stage_totals_ms device
        extrapolated_1m_chunks_min_1chip""",
    "text_index_scale": """engine docs segments build_s docs_per_sec
        rss_start_mb rss_track_mb rss_built_mb reopen_s search_ms_full_corpus
        phrase_hit_ms phrase_miss_ms delete_one_file_ms commit_ms_p50_first16
        commit_ms_p50_last16""",
    "encoder_ablate": """model batch seq device variants exp_ms softmax_ms
        variants.ms_per_call variants.chunks_per_sec""",
}
PORT_TOOLS = {"load_test": load_test, "spill_ivf_bench": spill_ivf_bench,
              "query_breakdown": query_breakdown, "ivf_bench": ivf_bench,
              "serving_sweep": serving_sweep,
              "index_build_bench": index_build_bench,
              "text_index_scale": text_index_scale,
              "encoder_ablate": encoder_ablate}


def jax_tool(name, monkeypatch):
    """``tools/<name>.py`` of the JAX package, loaded by path (no compile
    cache written)."""
    monkeypatch.setenv("SEMA_TPU_NO_COMP_CACHE", "1")
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def keys_of(line: dict) -> set:
    """A last line's keys, with "name.key" for each entry of a nested
    list or dict of dicts (``rungs``, ``variants``)."""
    out = set(line)
    for name, v in line.items():
        entries = (v if isinstance(v, list) else list(v.values())
                   if isinstance(v, dict) and name in ("rungs", "variants")
                   else [])
        for e in entries:
            if isinstance(e, dict):
                out |= {f"{name}.{k}" for k in e}
    return out


def check_keys(name: str, line: dict) -> None:
    """The port's keys are the JAX tool's, ``device``, ``launches`` and
    extras its docstring names; the JAX keys are its source's."""
    want = set(JAX_KEYS[name].split())
    source = (REPO / "tools" / f"{name}.py").read_text()
    for key in want:
        assert f'"{key.split(".")[-1]}"' in source, (name, key)
    got = keys_of(line)
    assert want <= got, (name, want - got)
    doc = PORT_TOOLS[name].__doc__
    for extra in got - want - {"device", "launches"}:
        assert f"``{extra.split('.')[-1]}``" in doc, (name, extra)
    assert line["device"] == "cpu" and line["launches"] == {}


def last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# -- load_test ------------------------------------------------------------


@pytest.mark.parametrize("case", ["streaming_reindex", "static_store"])
def test_load_test_serving_cases(tmp_path, case):
    """tests/test_serving_stress.py's two cases on the port's run."""
    if case == "streaming_reindex":
        result = load_test.run(rows=4096, dim=64, clients=32, max_batch=32,
                               duration=3.0, mutate=True, k=5,
                               data_dir=str(tmp_path), mut_batch=512,
                               warmup=1.0, device="cpu")
        assert result["mutated_batches"] >= 1
        assert result["p99_ms"] is not None
    else:
        result = load_test.run(rows=2048, dim=64, clients=16, max_batch=16,
                               duration=1.5, mutate=False, k=5,
                               data_dir=str(tmp_path), warmup=1.0,
                               device="cpu")
    assert result["errors"] == 0
    assert result["mismatches"] == 0
    assert result["queries"] > 0
    check_keys("load_test", result)


def test_load_test_store_is_the_jax_tools(tmp_path, monkeypatch):
    """The same probes and planted ids from the same seed, and each
    probe's top-1 the same row in both packages' stores."""
    jax_lt = jax_tool("load_test", monkeypatch)
    jstore, jprobes, jplanted = jax_lt.build_store(tmp_path / "jax", 2048, 64)
    store, probes, planted = load_test.build_store(tmp_path / "port", 2048,
                                                   64, device="cpu")
    np.testing.assert_array_equal(probes, jprobes)
    assert planted == jplanted
    for p in probes:
        assert (store.search(p, 1)[0][0].id == jstore.search(p, 1)[0][0].id)
    jstore.close()
    store.close()


def test_load_test_main_exits_on_its_result(tmp_path, capsys):
    rc = load_test.main(["--rows", "2048", "--dim", "64", "--clients", "4",
                         "--max-batch", "8", "--duration", "0.5",
                         "--warmup", "0.2", "--data-dir", str(tmp_path),
                         "--device", "cpu"])
    line = last_line(capsys)
    assert rc == 0 and line["mismatches"] == 0 and line["scan_paths"] == []


# -- spill_ivf_bench ----------------------------------------------------------


def test_spill_data_is_the_jax_tools(monkeypatch):
    jax_sp = jax_tool("spill_ivf_bench", monkeypatch)
    cent = spill_ivf_bench._centers(64, 32)
    np.testing.assert_array_equal(cent, jax_sp._centers(64, 32))
    for s in (0, 3):
        np.testing.assert_array_equal(
            spill_ivf_bench._slice_corpus(cent, 500, 32, 1.5, s),
            jax_sp._slice_corpus(cent, 500, 32, 1.5, s))
    x0 = spill_ivf_bench._slice_corpus(cent, 500, 32, 1.5, 0)
    for got, want in zip(spill_ivf_bench._queries(x0, 32, 1.0, 16),
                         jax_sp._queries(x0, 32, 1.0, 16)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_spill_ivf_bench_spills_and_probes(monkeypatch, capsys, dtype):
    # the tool sets these for its run: restored after the test
    for name in ("SEAL_ROWS", "IVF_TILE", "IVF_CLUSTER_ROWS"):
        monkeypatch.setattr(VectorStore, name, getattr(VectorStore, name))
    monkeypatch.setenv("SEMA_TPU_HBM_BUDGET_MB", "0.01")
    monkeypatch.setenv("SEMA_TPU_IVF_NPROBE", "2")
    rc = spill_ivf_bench.main([
        "--rows", "4096", "--dim", "64", "--seal-rows", "2048",
        "--slice-rows", "2048", "--centers", "64", "--nprobe", "2",
        "--repeats", "2", "--store-dtype", dtype, "--device", "cpu"])
    line = last_line(capsys)
    assert rc == 0 and line["spilled_buckets"] >= 1
    assert 0.0 <= line["recall_at_k"] <= 1.0
    assert line["probed_tiles"] > 0
    assert line["probe_upload_mb"] < line["streamed_upload_mb"]
    assert line["split_ab"] is False and line["store_dtype"] == dtype
    check_keys("spill_ivf_bench", line)


# -- query_breakdown, serving_sweep, ivf_bench --------------------------------


def test_query_breakdown_stages(capsys):
    rc = query_breakdown.main(["--rows", "2048", "--iters", "2",
                               "--device", "cpu"])
    line = last_line(capsys)
    assert rc == 0
    for stage in ("tokenize_ms", "rtt_ms", "embed_device_ms",
                  "scan_device_ms", "embed_e2e_ms", "search_e2e_ms"):
        assert line[stage] > 0
    check_keys("query_breakdown", line)


def test_serving_sweep_rungs(tmp_path, capsys):
    rc = serving_sweep.main(["--rows", "2048", "--dim", "64", "--clients",
                             "2", "8", "--duration", "0.6", "--warmup",
                             "0.3", "--max-batch", "16", "--data-dir",
                             str(tmp_path), "--device", "cpu"])
    line = last_line(capsys)
    assert rc == 0 and [r["clients"] for r in line["rungs"]] == [2, 8]
    assert all(r["errors"] == 0 and r["mismatches"] == 0
               for r in line["rungs"])
    check_keys("serving_sweep", line)


def test_ivf_bench_sweep(monkeypatch, capsys):
    monkeypatch.setattr(VectorStore, "IVF_TILE", 128)
    monkeypatch.setattr(VectorStore, "IVF_CLUSTER_ROWS", 128)
    monkeypatch.setattr(VectorStore, "IVF_BUDGET_DIV", 1)
    rc = ivf_bench.main(["--rows", "16384", "--dim", "64", "--q", "16",
                         "--centers", "64", "--nprobe", "2", "8",
                         "--chain", "2", "--device", "cpu"])
    line = last_line(capsys)
    assert rc == 0 and line["exact_recall_at_k"] == 1.0
    assert line["plain_check"]["ok"] and line["plain_check"]["queries"] == 8
    rungs = line["rungs"]
    assert rungs["nprobe8"]["recall_at_k"] >= rungs["nprobe2"]["recall_at_k"]
    assert (rungs["nprobe8"]["tiles_scanned_frac"]
            > rungs["nprobe2"]["tiles_scanned_frac"])
    check_keys("ivf_bench", line)


def test_ivf_bench_data_recipe():
    """The clustered corpus: unit rows, each nearer its own centre than
    noise alone would put it, drawn from one numpy seed."""
    a = ivf_bench.make_corpus(512, 32, 8, 0.5, np.random.default_rng(3))
    b = ivf_bench.make_corpus(512, 32, 8, 0.5, np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1, atol=1e-6)
    rng = np.random.default_rng(3)
    cent = rng.standard_normal((8, 32), dtype=np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    assert ((a @ cent.T).max(axis=1) > 0.7).all()     # mean 1 / sqrt(1.25)


# -- index_build_bench, text_index_scale --------------------------------------


def test_index_build_tree_is_the_jax_tools(tmp_path, monkeypatch):
    jax_ib = jax_tool("index_build_bench", monkeypatch)
    assert index_build_bench.build_tree(tmp_path / "port", 200) == \
        jax_ib.build_tree(tmp_path / "jax", 200)
    port = sorted((tmp_path / "port").iterdir())
    assert [p.name for p in port] == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    for p in port:
        assert p.read_bytes() == (tmp_path / "jax" / p.name).read_bytes()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_index_build_bench_counts_the_trees_chunks(capsys, quant):
    rc = index_build_bench.main(["--chunks", "64", "--model", "test-tiny",
                                 "--quant", quant, "--device", "cpu"])
    line = last_line(capsys)
    assert rc == 0 and line["chunks"] == line["tree_chunks"] > 0
    assert line["quant"] == quant and "embed" in line["stage_totals_ms"]
    check_keys("index_build_bench", line)


def test_text_index_scale_batches_are_the_jax_tools(monkeypatch, capsys):
    jax_ts = jax_tool("text_index_scale", monkeypatch)
    for got, want in zip(text_index_scale.make_batch(4000, 100),
                         jax_ts.make_batch(4000, 100)):
        assert (got.id, str(got.file_path), got.start_line, got.end_line,
                got.content) == (want.id, str(want.file_path),
                                 want.start_line, want.end_line,
                                 want.content)
    monkeypatch.setattr(sys, "argv", ["text_index_scale", "--docs", "8192",
                                      "--batch", "1024"])
    assert text_index_scale.main() == 0
    line = last_line(capsys)
    assert line["docs"] == 8192 and line["rss_built_mb"] > 0
    check_keys("text_index_scale", line)


# -- encoder_ablate -------------------------------------------------------------


@pytest.mark.parametrize("variant", ["no_exp", "no_softmax"])
def test_ablated_plain_attention_matches_the_jax_tools(monkeypatch, variant):
    """The plain ablated attentions against the JAX tool's cores on the
    same qkv row and bias, in f32 (limit: 1e-5 relative, 1e-6 absolute;
    both sum the same f32 products in another order)."""
    jax_ea = jax_tool("encoder_ablate", monkeypatch)
    jax_fn = getattr(jax_ea, f"_heads_attention_{variant}")
    rng = np.random.default_rng(5)
    s, h, heads = 48, 64, 4
    row = rng.standard_normal((s, 3 * h)).astype(np.float32)
    bias = -rng.random((1, s)).astype(np.float32)
    scale = 1.0 / np.sqrt(h // heads)
    want = np.asarray(jax_fn(row, bias, heads, scale))
    got = heads_attention(torch.from_numpy(row)[None],
                          torch.from_numpy(bias), heads, scale,
                          softmax=variant)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    prod = heads_attention(torch.from_numpy(row)[None],
                           torch.from_numpy(bias), heads, scale)[0].numpy()
    assert not np.allclose(got, prod)


def test_encoder_ablate_ids_are_the_jax_tools():
    ids = np.random.default_rng(0).integers(0, 30522, (4, 16))
    want = np.random.default_rng(0).integers(0, 30522, (4, 16))
    np.testing.assert_array_equal(ids, want)
    assert re.search(r"rng = np\.random\.default_rng\(0\)\n\s+ids = "
                     r"jnp\.asarray\(rng\.integers\(0, spec\.vocab_size,",
                     (REPO / "tools" / "encoder_ablate.py").read_text())


def test_encoder_ablate_on_the_cpu(capsys):
    rc = encoder_ablate.main(["--model", "test-tiny", "--batch", "4",
                              "--seq", "32", "--calls", "2", "--device",
                              "cpu"])
    line = last_line(capsys)
    assert rc == 0 and line["checks"]["prod_bit_equal"]
    assert line["checks"]["no_exp"]["differs_from_prod"]
    assert line["checks"]["no_softmax"]["differs_from_prod"]
    assert set(line["variants"]) == {"prod", "no_exp", "no_softmax"}
    check_keys("encoder_ablate", line)
