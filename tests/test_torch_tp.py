"""The port's tensor-parallel and data-parallel encoder (``parallel/mesh.py``,
``models/tp.py``, ``bert.encoder_layer_tp``, ``Encoder(mesh=)``) on meshes of
``cpu`` shards, held against the JAX package's TP ``Encoder`` on its 8
virtual CPU devices with ``SEMA_TPU_ATTN=fused`` (its K6 and K7 in
interpret mode, as ``tests/test_tensor_parallel.py`` runs them), on the
same numpy weights; and the ``[mesh]`` wiring of the CLI."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.models import bert as jax_bert
from sema_tpu.models.encoder import Encoder as JaxEncoder
from sema_tpu.models.loader import random_params
from sema_tpu.models.registry import get_spec as jax_spec
from sema_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sema_tpu.tokenizer import HashTokenizer as JaxHashTokenizer
from sema_tpu_torch import cli
from sema_tpu_torch.config import Config
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.bert import quantize_params_int8
from sema_tpu_torch.models.loader import params_from_jax
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.models.tp import (permute_qkv_heads, shard_params_tp,
                                      tp_param_specs)
from sema_tpu_torch.ops import attention as attn
from sema_tpu_torch.parallel.mesh import Mesh, default_mesh, make_mesh
from sema_tpu_torch.tokenizer import HashTokenizer
from sema_tpu_torch.types import Chunk

TEXTS = [f"padded doc {i} " + "word " * (3 + 9 * i) for i in range(8)]
# over 128 tokens each: one batch in the 256 bucket, where K6 runs
LONG_TEXTS = [f"padded doc {i} " + "word " * (130 + 9 * i) for i in range(8)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def tiny_params():
    return random_params(jax_spec("test-tiny"), seed=3)


# (quant, dtype, max_length): f32 at 256 runs K6 in every layer (the long
# texts), at 32 K7; int8 runs K7 and W8A8 products; bf16 at 256
RUNS = {"f32-256": ("none", "f32", 256), "f32-32": ("none", "f32", 32),
        "int8-32": ("int8", "f32", 32), "bf16-256": ("none", "bf16", 256)}


def _texts(max_length):
    return LONG_TEXTS if max_length == 256 else TEXTS


@pytest.fixture(scope="module")
def jax_tp_out(tiny_params):
    """JAX's TP embeddings of TEXTS on a (2, 4) mesh of its 8 virtual
    devices, per run of RUNS, with the fused kernels."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SEMA_TPU_ATTN", "fused")
    spec = jax_spec("test-tiny")
    mesh = jax_make_mesh(shape=[2, 4], axis_names=("data", "model"))
    out = {}
    try:
        for key, (quant, dt, max_length) in RUNS.items():
            enc = JaxEncoder(spec, tiny_params,
                             JaxHashTokenizer(spec.vocab_size), batch_size=8,
                             compute_dtype=DTYPES[dt][1],
                             max_length=max_length, mesh=mesh,
                             data_axis="data", model_axis="model",
                             quant=quant)
            out[key] = enc.encode_texts(_texts(max_length))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("shape", [[2, 4], [4, 2]])
@pytest.mark.parametrize("run", list(RUNS))
def test_tp_encoder_matches_jax_tp_encoder(run, shape, tiny_params,
                                           jax_tp_out, monkeypatch):
    quant, dt, max_length = RUNS[run]
    spec = get_spec("test-tiny")
    calls = {"qkv": 0, "block": 0}
    for name, key in (("attention_qkv_reference", "qkv"),
                      ("attention_block_reference", "block")):
        fn = getattr(attn, name)

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)
        monkeypatch.setattr(attn, name, counted)
    enc = Encoder(spec, params_from_jax(tiny_params),
                  HashTokenizer(spec.vocab_size), batch_size=8,
                  compute_dtype=DTYPES[dt][0], max_length=max_length,
                  mesh=cpu_mesh(shape), data_axis="data", model_axis="model",
                  quant=quant)
    got = enc.encode_texts(_texts(max_length)).numpy()
    want = jax_tp_out[run]
    cos = (got * want).sum(-1)
    if run.startswith("f32"):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    elif run.startswith("int8"):
        assert cos.min() >= 1 - 1e-6
    else:
        assert cos.min() >= 0.999
    # K6 at S >= 192 with float qkv weights, K7 otherwise, on every shard
    # of every layer (one batch of one sequence bucket here)
    k6 = quant == "none" and max_length >= 192
    n = shape[0] * shape[1] * spec.num_layers
    assert calls == {"qkv": 0 if k6 else n, "block": n if k6 else 0}


def test_tp_gte_large_width_matches_jax_single_device():
    """gte-large's width and heads (1,024 wide, 16 heads of 64, FFN 4,096)
    at 2 layers: the port's forward at tp 2 against the JAX package's
    single-device f32 forward, batch 2 at S 32."""
    cut = dict(num_layers=2, vocab_size=2048)
    js = dataclasses.replace(jax_spec("gte-large"), **cut)
    ps = dataclasses.replace(get_spec("gte-large"), **cut)
    jp = random_params(js, seed=5)
    rng = np.random.default_rng(5)
    ids = rng.integers(5, js.vocab_size, size=(2, 32)).astype(np.int32)
    mask = (np.arange(32)[None, :] < np.array([[32], [19]])).astype(np.int32)
    want = np.asarray(jax_bert.embed(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     js, compute_dtype=jnp.float32))
    enc = Encoder(ps, params_from_jax(jp), HashTokenizer(ps.vocab_size),
                  batch_size=2, compute_dtype=torch.float32, max_length=32,
                  mesh=cpu_mesh([1, 2]), data_axis="data", model_axis="model")
    got = enc.embed_ids(ids, mask).numpy()
    assert (got * want).sum(-1).min() >= 1 - 1e-6
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_shards_and_qkv_permutation(tiny_params):
    spec = get_spec("test-tiny")               # H 64, 4 heads, FFN 128
    h, n_layers = spec.hidden_size, spec.num_layers
    params = params_from_jax(tiny_params)
    # the permutation: shard c holds q|k|v of heads c·H/tp..(c+1)·H/tp
    perm = permute_qkv_heads(params, 4)["layers"]["qkv_w"]
    qkv = params["layers"]["qkv_w"]
    for c in range(4):
        for third in range(3):
            got = perm[..., c * 48 + third * 16:c * 48 + (third + 1) * 16]
            want = qkv[..., third * h + c * 16:third * h + (c + 1) * 16]
            assert torch.equal(got, want)
    with pytest.raises(ValueError, match="not divisible"):
        permute_qkv_heads(params, 3)
    mesh = cpu_mesh([2, 4])
    trees = shard_params_tp(params, mesh, "model")
    assert trees.shape == (2, 4)
    assert trees[0, 1] is trees[1, 1]          # one tree per device + shard
    layers = trees[1, 2]["layers"]
    assert layers["qkv_w"].shape == (n_layers, h, 3 * h // 4)
    assert layers["qkv_b"].shape == (n_layers, 3 * h // 4)
    assert layers["ffn_in_w"].shape == (n_layers, h, 128 // 4)
    assert layers["attn_out_w"].shape == (n_layers, h // 4, h)
    assert layers["ffn_out_w"].shape == (n_layers, 128 // 4, h)
    assert layers["attn_out_b"].shape == (n_layers, h)
    assert torch.equal(layers["ffn_ln_scale"],
                       params["layers"]["ffn_ln_scale"])
    assert torch.equal(layers["ffn_out_w"],
                       params["layers"]["ffn_out_w"][:, 64:96])
    specs = tp_param_specs()["layers"]
    assert (specs["qkv_w_q"], specs["qkv_w_s"], specs["ffn_out_w_q"],
            specs["ffn_out_w_s"]) == (2, 1, 1, None)
    # quantized twins shard with their scales, laid out for qmm
    q = shard_params_tp(quantize_params_int8(params), mesh, "model")[0, 3]
    assert q["layers"]["qkv_w_q"].shape == (n_layers, h, 3 * h // 4)
    assert q["layers"]["qkv_w_s"].shape == (n_layers, 3 * h // 4)
    assert q["layers"]["ffn_out_w_s"].shape == (n_layers, h)
    assert q["layers"]["attn_out_w_q"][0].t().is_contiguous()


def test_tp_must_divide_the_heads_and_meshes_are_checked(tiny_params):
    spec = get_spec("test-tiny")               # 4 heads
    params = params_from_jax(tiny_params)
    tok = HashTokenizer(spec.vocab_size)
    with pytest.raises(ValueError, match="must divide"):
        Encoder(spec, params, tok, mesh=cpu_mesh([1, 3]), model_axis="model")
    with pytest.raises(ValueError, match="device count"):
        make_mesh([2, 4], ("data", "model"), devices=["cpu"] * 6)
    mesh = make_mesh([], ("data", "model"), devices=["cpu"] * 3)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 1, "model": 3}
    if not torch.cuda.is_available():
        assert default_mesh() is None


def test_data_parallel_encoder_rounds_the_batch_up(tiny_params):
    spec = get_spec("test-tiny")
    params = params_from_jax(tiny_params)
    tok = HashTokenizer(spec.vocab_size)
    single = Encoder(spec, params, tok, batch_size=8, device="cpu",
                     compute_dtype=torch.float32)
    dp = Encoder(spec, params, tok, batch_size=7, compute_dtype=torch.float32,
                 mesh=cpu_mesh([3, 1]), data_axis="data")
    assert dp.batch_size == 9 and dp.device == torch.device("cpu")
    np.testing.assert_allclose(dp.encode_texts(TEXTS),
                               single.encode_texts(TEXTS), atol=1e-6)
    q = dp.encode_query_device("one query, padded to the data axis")
    assert q.shape == (spec.dim,)


def _config(**mesh):
    cfg = Config()
    cfg.model.name = "test-tiny"
    cfg.model.batch_size = 8
    for k, v in mesh.items():
        setattr(cfg.mesh, k, v)
    return cfg


def test_mesh_config_reaches_the_encoder(tmp_path, monkeypatch):
    """``[mesh]`` through ``cli.make_index_manager`` on CPU shards, as
    ``sema_tpu/cli.py:175-204`` builds it: the encoder's batch splits over
    ``index`` and its weights over ``model_axis``; the store's rows shard
    over ``index`` (and ``slice_axis``, the outermost axis); every mesh's
    manager indexes and answers a query."""
    monkeypatch.setenv("SEMA_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "data"))
    chunks = [Chunk(id=f"c{i}", file_path=tmp_path / f"f{i % 3}.py",
                    start_line=i + 1, end_line=i + 1,
                    content=f"production wiring doc {i} " + "word " * i)
              for i in range(40)]

    def answers(mgr):
        mgr.index_chunks(chunks)
        hits = mgr.search(chunks[7].content, 5)
        assert hits and hits[0][0].id == "c7", hits
        mgr.close()

    mgr = cli.make_index_manager(
        _config(model_axis="model", shape=[2, 2, 1]), "cpu")
    enc = mgr.encoder
    assert enc.model_axis == "model" and enc.mesh.shape == {
        "data": 2, "model": 2, "index": 1}
    assert enc.shards.shape == (1, 2)       # index x model
    assert enc.shards[0, 1]["layers"]["qkv_w"].shape[-1] == 3 * 64 // 2
    out = enc.encode_texts(["production wiring doc"])
    assert out.shape == (1, enc.spec.dim)
    assert float(out[0].norm()) == pytest.approx(1.0, abs=1e-3)
    assert mgr.vector_store._shards() == 1
    answers(mgr)
    with pytest.raises(SystemExit):          # no explicit 3-entry shape
        cli.make_index_manager(_config(model_axis="model"), "cpu")
    with pytest.raises(SystemExit):
        cli.make_index_manager(_config(model_axis="model", shape=[1, 2]),
                               "cpu")
    with pytest.raises(SystemExit):          # slice needs its shape too
        cli.make_index_manager(_config(slice_axis="slice"), "cpu")
    assert cli.config_mesh(_config(), "cpu") is None   # default_mesh
    for mesh, shards, enc_shards, axes in (
            ({"model_axis": "model", "shape": [1, 2, 2]}, 2, (2, 2),
             ("data", "model", "index")),
            ({"shape": [1, 4]}, 4, (4, 1), ("data", "index")),
            # data-parallel: the batch splits over index, here of one
            ({"shape": [2, 1]}, 1, (1, 1), ("data", "index")),
            ({"slice_axis": "slice", "shape": [2, 1, 2]}, 4, (2, 1),
             ("slice", "data", "index"))):
        mgr = cli.make_index_manager(_config(**mesh), "cpu")
        store = mgr.vector_store
        assert store.mesh.axis_names == axes and store._shards() == shards
        assert store.slice_axis == mesh.get("slice_axis")
        assert mgr.encoder.shards.shape == enc_shards
        assert mgr.encoder.model_axis == mesh.get("model_axis")
        answers(mgr)
