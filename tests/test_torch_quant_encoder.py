"""The W8A8 encoder of the port (K5, ``quantize_params_int8``, ``qmm``) held
against ``sema_tpu``'s on the same numpy weights and inputs: the weight
quantization and the product bit for bit, the layer's plain version
against the fused int8 Pallas layer in interpret mode, and the forward."""

import dataclasses
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.models import bert as jax_bert
from sema_tpu.models.encoder import Encoder as JaxEncoder
from sema_tpu.models.loader import random_params
from sema_tpu.models.registry import get_spec as jax_spec
from sema_tpu.ops.fused_attention import fused_encoder_layer_int8 as jax_layer
from sema_tpu.tokenizer import HashTokenizer as JaxHashTokenizer
from sema_tpu_torch.config import ModelConfig
from sema_tpu_torch.models import bert
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import params_from_jax
from sema_tpu_torch.models.registry import ENCODERS, get_spec
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.encoder_layer import (LN_SLICE, MAX_CLUSTER,
                                              ln_gemm_plan)
from sema_tpu_torch.ops.encoder_layer_int8 import (column_major,
                                                   fused_encoder_layer_int8,
                                                   qmm, qmm_reference)
from sema_tpu_torch.tokenizer import HashTokenizer

int8_mod = importlib.import_module("sema_tpu_torch.ops.encoder_layer_int8")
LN_EPS = 1e-12
LEAVES = ("qkv_w", "attn_out_w", "ffn_in_w", "ffn_out_w")


def _assert_same_quantization(jax_layers, port_layers):
    for name in LEAVES:
        q, s = port_layers[name + "_q"], port_layers[name + "_s"]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.cpu().numpy(),
                              np.asarray(jax_layers[name + "_q"]))
        assert np.array_equal(s.cpu().numpy(),
                              np.asarray(jax_layers[name + "_s"]))
        assert name not in port_layers


@pytest.mark.parametrize("model", ["test-tiny", "minilm-l6"])
def test_quantize_params_int8_bit_equal(model):
    """The four linears of every layer at the model's shapes, drawn as
    its random init draws them (sigma 0.02), plus an all-zero column (the
    1e-12 floor) and exact halves of a quantum."""
    spec = get_spec(model)
    h, inter, n = spec.hidden_size, spec.intermediate_size, spec.num_layers
    rng = np.random.default_rng(n)
    shapes = {"qkv_w": (n, h, 3 * h), "attn_out_w": (n, h, h),
              "ffn_in_w": (n, h, inter), "ffn_out_w": (n, inter, h)}
    layers = {name: (0.02 * rng.standard_normal(shape)).astype(np.float32)
              for name, shape in shapes.items()}
    layers["qkv_w"][0, :, 5] = 0.0
    layers["qkv_w"][0, :3, 6] = [1.0, 0.5 / 127, -1.5 / 127]
    want = jax_bert.quantize_params_int8({"layers": layers})["layers"]
    got = bert.quantize_params_int8(
        {"layers": {k: torch.from_numpy(v) for k, v in layers.items()}})
    _assert_same_quantization(want, got["layers"])


def test_encoder_quantizes_before_the_bf16_cast():
    """The JAX Encoder quantizes the params as loaded; the port's must do
    the same, not quantize weights already rounded to bf16."""
    js, ps = jax_spec("test-tiny"), get_spec("test-tiny")
    jp = random_params(js)
    jenc = JaxEncoder(js, jp, JaxHashTokenizer(js.vocab_size),
                      compute_dtype=jnp.bfloat16, quant="int8")
    enc = Encoder(ps, params_from_jax(jp), HashTokenizer(ps.vocab_size),
                  compute_dtype=torch.bfloat16, device="cpu", quant="int8")
    _assert_same_quantization(jenc.params["layers"], enc.params["layers"])
    rounded = bert.quantize_params_int8(bert.cast_params(
        params_from_jax(jp), torch.bfloat16))["layers"]
    assert any(not torch.equal(rounded[n + "_q"],
                               enc.params["layers"][n + "_q"])
               for n in LEAVES)
    assert enc.params["layers"]["qkv_b"].dtype == torch.bfloat16
    assert enc.params["layers"]["attn_ln_scale"].dtype == torch.float32


@pytest.mark.parametrize("m,k,n,dtype", [
    (6, 64, 192, torch.float32),          # test-tiny's qkv
    (8, 384, 1152, torch.float32),        # MiniLM's qkv
    (8, 1536, 384, torch.bfloat16),       # MiniLM's FFN-out, bf16 rows
])
def test_qmm_reference_bit_equal_to_int8_matmul(m, k, n, dtype):
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((m, k)) * 3.0).astype(np.float32)
    x[0, :5] = [0.5, -1.5, 2.5, 127.0, -127.0]     # halves of a quantum
    x[1] = 0.0                                     # the 1e-8 floor
    w = (rng.standard_normal((1, k, n)) * 0.05).astype(np.float32)
    jq = jax_bert.quantize_params_int8(
        {"layers": {name: w for name in LEAVES}})["layers"]
    wq, ws = np.array(jq["qkv_w_q"][0]), np.array(jq["qkv_w_s"][0])
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = np.asarray(jax_bert._int8_matmul(jnp.asarray(x, dtype=jdt),
                                            jnp.asarray(wq), jnp.asarray(ws),
                                            jnp.float32))
    xt = torch.from_numpy(x).to(dtype)
    got = qmm_reference(xt, torch.from_numpy(wq), torch.from_numpy(ws))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version on the CPU, in either layout
    assert torch.equal(qmm(xt, column_major(torch.from_numpy(wq)),
                           torch.from_numpy(ws)), got)


def _quantized_layer(h, inter, seed):
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) * 0.08).astype(np.float32)
    layer = {"qkv_w": w(1, h, 3 * h), "attn_out_w": w(1, h, h),
             "ffn_in_w": w(1, h, inter), "ffn_out_w": w(1, inter, h)}
    q = jax_bert.quantize_params_int8({"layers": layer})["layers"]
    q = {k: np.array(v[0]) for k, v in q.items()}
    q.update({"qkv_b": w(3 * h), "attn_out_b": w(h), "ffn_in_b": w(inter),
              "ffn_out_b": w(h), "attn_ln_scale": 1.0 + w(h),
              "attn_ln_bias": w(h), "ffn_ln_scale": 1.0 + w(h),
              "ffn_ln_bias": w(h)})
    return q


def _layer_both(b, s, h, heads, inter, dtype, seed=0):
    layer = _quantized_layer(h, inter, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    bias = ((np.arange(s)[None, :] >= lengths[:, None]) * -1e9).astype(
        np.float32)
    scale = 1.0 / math.sqrt(h // heads)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    want = jax_layer(jnp.asarray(x, dtype=jdt),
                     {k: jnp.asarray(v) for k, v in layer.items()},
                     jnp.asarray(bias), num_heads=heads, scale=scale,
                     ln_eps=LN_EPS, interpret=True)
    got = fused_encoder_layer_int8(
        torch.from_numpy(x).to(dtype),
        {k: torch.from_numpy(v) for k, v in layer.items()},
        torch.from_numpy(bias), heads, scale, LN_EPS)
    assert got.dtype == dtype and got.shape == (b, s, h)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("b,s,h,heads,inter", [
    (2, 16, 64, 4, 128),     # test-tiny
    (2, 32, 64, 2, 128),     # head dim 32 (MiniLM's)
])
def test_int8_layer_matches_pallas_kernel_f32(b, s, h, heads, inter):
    want, got = _layer_both(b, s, h, heads, inter, torch.float32)
    # the JAX package's own bound between its int8 kernel and the
    # composed XLA W8A8 layer (tests/test_fused_attention.py)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,heads,inter,atol", [
    # K2's bf16 limits (tests/test_torch_encoder_layer.py)
    (2, 16, 64, 4, 128, 3e-2),
    (2, 32, 64, 2, 128, 3e-2),
    # head dim 64 (gte-large's), at twice K2's atol: where both sides land
    # a bf16 ulp apart on a row's absmax, that row's scale moves by 2^-8
    # and every quantum of the row may shift by one; read 0.047 at worst
    # over seeds 0-3 (K2's layer at this shape: 0.031)
    (3, 16, 128, 2, 256, 6e-2),
])
def test_int8_layer_matches_pallas_kernel_bf16(b, s, h, heads, inter, atol):
    want, got = _layer_both(b, s, h, heads, inter, torch.bfloat16)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999
    np.testing.assert_allclose(got, want, atol=atol, rtol=2 ** -8)


def _two_layers_both(dtype, seeds=(0, 1), b=2, s=32, h=128, heads=2,
                     inter=256):
    """Two W8A8 layers in turn: ``sema_tpu``'s fused int8 layer in
    interpret mode applied layer by layer, and the port's wrapper on the
    CPU (its plain version) with the first layer's output rows carried
    into the second (``out_rows``, then ``x_rows``). Returns the JAX and
    port outputs of the second layer, the port's first output and the
    carried rows."""
    layers = [_quantized_layer(h, inter, seed) for seed in seeds]
    rng = np.random.default_rng(seeds[0] + 7)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    bias = ((np.arange(s)[None, :] >= lengths[:, None]) * -1e9).astype(
        np.float32)
    scale = 1.0 / math.sqrt(h // heads)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    want = jnp.asarray(x, dtype=jdt)
    for layer in layers:
        want = jax_layer(want, {k: jnp.asarray(v) for k, v in layer.items()},
                         jnp.asarray(bias), num_heads=heads, scale=scale,
                         ln_eps=LN_EPS, interpret=True)
    xt = torch.from_numpy(x).to(dtype)
    port = [{k: torch.from_numpy(v) for k, v in layer.items()}
            for layer in layers]
    rows = int8_mod.row_buffers(xt)
    first = fused_encoder_layer_int8(xt, port[0], torch.from_numpy(bias),
                                     heads, scale, LN_EPS, out_rows=rows)
    carried = (rows[0].clone(), rows[1].clone())
    got = fused_encoder_layer_int8(first, port[1], torch.from_numpy(bias),
                                   heads, scale, LN_EPS, x_rows=rows)
    assert got.dtype == dtype and got.shape == (b, s, h)
    return (np.asarray(want.astype(jnp.float32)), got.float().numpy(), first,
            carried)


@pytest.mark.parametrize("dtype,atol", [
    # the JAX package's own bound between its int8 kernel and the composed
    # XLA W8A8 layer (tests/test_fused_attention.py), held over two layers
    (torch.float32, 5e-5),
    # the bf16 layer's bound at head dim 64 (above), over two layers
    (torch.bfloat16, 6e-2),
])
def test_two_int8_layers_with_carried_rows_match_pallas_kernel(dtype, atol):
    """H 128, 2 heads, I 256, B 2, S 32: two layers through the port's
    plain path with the first's output rows carried into the second equal
    sema_tpu's fused_encoder_layer_int8 applied layer by layer."""
    want, got, _, _ = _two_layers_both(dtype)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999
    np.testing.assert_allclose(got, want, atol=atol, rtol=2 ** -8
                               if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_carried_rows_are_qmm_references_own_quantization(dtype):
    """The rows and scales a layer carries out are the quantization
    qmm_reference makes of its output, bit for bit, so the next layer's
    products with them are qmm_reference's; and the layer given them
    equals the layer that quantizes its x itself."""
    _, got, first, (q, sx) = _two_layers_both(dtype)
    want_q, want_s = int8_mod.quantize_rows(first.reshape(-1, 128))
    assert q.dtype == torch.int8 and sx.dtype == torch.float32
    assert torch.equal(q, want_q) and torch.equal(sx, want_s)
    layer = {k: torch.from_numpy(v) for k, v in _quantized_layer(
        128, 256, 1).items()}
    x2 = first.reshape(-1, 128)
    assert torch.equal(
        int8_mod.qmm_rows(q, sx, layer["qkv_w_q"], layer["qkv_w_s"]),
        qmm_reference(x2, layer["qkv_w_q"], layer["qkv_w_s"]))
    bias = torch.zeros(first.shape[:2])
    alone = fused_encoder_layer_int8(first, layer, bias, 2, 0.125, LN_EPS)
    given = fused_encoder_layer_int8(first, layer, bias, 2, 0.125, LN_EPS,
                                     x_rows=(q, sx))
    assert torch.equal(alone, given)


def test_row_buffers_are_checked():
    """The rows a layer takes or writes must be (B*S, H) contiguous int8
    rows and (B*S,) f32 scales on x's device."""
    x = torch.zeros((2, 32, 64), dtype=torch.bfloat16)
    layer = {k: torch.from_numpy(v) for k, v in _quantized_layer(
        64, 128, 0).items()}
    bias = torch.zeros((2, 32))
    q, sx = int8_mod.row_buffers(x)
    assert q.shape == (64, 64) and q.dtype == torch.int8
    assert sx.shape == (64,) and sx.dtype == torch.float32
    for bad in ((q[:, :32], sx), (q, sx.double()), (q.float(), sx),
                (q.t().contiguous().t(), sx)):
        with pytest.raises(KernelError, match="x_rows"):
            fused_encoder_layer_int8(x, layer, bias, 2, 0.17, LN_EPS,
                                     x_rows=bad)
    with pytest.raises(KernelError, match="out_rows"):
        fused_encoder_layer_int8(x, layer, bias, 2, 0.17, LN_EPS,
                                 out_rows=(q[:32], sx))


def test_quantized_embed_matches_jax_embed():
    """2 layers at MiniLM width, f32, the same quantized params: the port's
    forward (the int8 layer's plain version) against ``sema_tpu``'s int8
    forward (its fused int8 kernel in interpret mode)."""
    cut = dict(num_layers=2, vocab_size=2048)     # the width stays
    js = dataclasses.replace(jax_spec("minilm-l6"), **cut)
    ps = dataclasses.replace(get_spec("minilm-l6"), **cut)
    jq = jax_bert.quantize_params_int8(random_params(js))
    rng = np.random.default_rng(3)
    ids = rng.integers(5, js.vocab_size, size=(2, 32)).astype(np.int32)
    mask = (np.arange(32)[None, :] < np.array([[32], [20]])).astype(np.int32)
    want = np.asarray(jax_bert.embed(jq, jnp.asarray(ids), jnp.asarray(mask),
                                     js, compute_dtype=jnp.float32,
                                     attn_impl="fused"))
    got = bert.embed(params_from_jax(jq), torch.from_numpy(ids),
                     torch.from_numpy(mask), ps,
                     compute_dtype=torch.float32).numpy()
    assert (got * want).sum(-1).min() >= 0.99999


def test_quant_mode_from_config_and_environment(monkeypatch):
    spec = get_spec("test-tiny")
    params = params_from_jax(random_params(jax_spec("test-tiny")))
    tok = HashTokenizer(spec.vocab_size)
    monkeypatch.delenv("SEMA_TPU_ENCODER_QUANT", raising=False)
    plain = Encoder(spec, params, tok, device="cpu")
    assert plain.quant == "none" and "qkv_w" in plain.params["layers"]
    enc = Encoder.from_config(ModelConfig(name="test-tiny", quant="int8"),
                              device="cpu")
    assert enc.quant == "int8" and "qkv_w_q" in enc.params["layers"]
    assert enc.encode_texts(["int8 encoder"]).shape == (1, spec.dim)
    monkeypatch.setenv("SEMA_TPU_ENCODER_QUANT", "none")
    assert Encoder(spec, params, tok, device="cpu", quant="int8").quant == \
        "none"
    monkeypatch.setenv("SEMA_TPU_ENCODER_QUANT", "int8")
    assert Encoder(spec, params, tok, device="cpu").quant == "int8"
    monkeypatch.setenv("SEMA_TPU_ENCODER_QUANT", "int4")
    with pytest.raises(ValueError, match="int4"):
        Encoder(spec, params, tok, device="cpu")
    monkeypatch.delenv("SEMA_TPU_ENCODER_QUANT")
    with pytest.raises(ValueError, match="fp8"):
        Encoder.from_config(ModelConfig(name="test-tiny", quant="fp8"),
                            device="cpu")


def test_int8_weights_are_laid_out_once_for_the_kernel():
    spec = get_spec("test-tiny")
    enc = Encoder(spec, params_from_jax(random_params(jax_spec("test-tiny"))),
                  HashTokenizer(spec.vocab_size), device="cpu", quant="int8")
    for name in LEAVES:
        leaf = enc.params["layers"][name + "_q"]
        assert leaf.shape[0] == spec.num_layers
        assert leaf[0].t().is_contiguous()      # (out, in) rows, no copy


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    called = []
    monkeypatch.setattr(int8_mod, "encoder_layer_int8_reference",
                        lambda *a, **k: called.append(1))
    monkeypatch.setattr(int8_mod, "qmm_reference",
                        lambda *a, **k: called.append(1))
    x = torch.empty((1, 32, 64), dtype=torch.bfloat16, device="meta")
    mask = torch.empty((1, 32), device="meta")
    with pytest.raises(KernelError, match="CPU or CUDA"):
        fused_encoder_layer_int8(x, {}, mask, 2, 0.17, LN_EPS)
    with pytest.raises(KernelError, match="int8 weights"):
        qmm(x[0], torch.empty((64, 96), device="meta"),
            torch.empty((96,), device="meta"))
    monkeypatch.setattr(int8_mod, "_check", lambda *a, **k: None)

    def failing_library(*a, **k):
        raise KernelError("kernel build failed: nvcc rc=1")
    monkeypatch.setattr(int8_mod._cuda, "library", failing_library)
    before = fused_encoder_layer_int8.launches
    with pytest.raises(KernelError, match="kernel build failed"):
        fused_encoder_layer_int8(x, {}, mask, 2, 0.17, LN_EPS)
    with pytest.raises(KernelError, match="kernel build failed"):
        qmm(x[0], torch.empty((64, 96), dtype=torch.int8, device="meta"),
            torch.empty((96,), device="meta"))
    assert not called and fused_encoder_layer_int8.launches == before


def _meta_int8_args(h=64, heads=2, inter=128, **change):
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                        device="meta")
    layer = {"qkv_b": meta(3 * h), "attn_out_b": meta(h),
             "ffn_in_b": meta(inter), "ffn_out_b": meta(h),
             **{n: meta(h) for n in ("attn_ln_scale", "attn_ln_bias",
                                     "ffn_ln_scale", "ffn_ln_bias")}}
    for name, (i, o) in {"qkv_w": (h, 3 * h), "attn_out_w": (h, h),
                         "ffn_in_w": (h, inter),
                         "ffn_out_w": (inter, h)}.items():
        layer[name + "_q"] = meta(i, o, dt=torch.int8)
        layer[name + "_s"] = meta(o)
    layer.update(change)
    return meta(2, 32, h, dt=torch.bfloat16), layer, meta(2, 32), heads


def test_check_args_of_the_int8_layer():
    layer_mod = importlib.import_module("sema_tpu_torch.ops.encoder_layer")
    layer_mod._check_args(*_meta_int8_args(), quantized=True)
    layer_mod._check_args(*_meta_int8_args(h=128, inter=256), quantized=True)
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                        device="meta")
    for change, match in (
            ({"qkv_w_q": meta(64, 192)}, "int8"),
            ({"ffn_out_w_s": meta(64, dt=torch.bfloat16)}, "f32"),
            ({"attn_out_w_q": meta(64, 128, dt=torch.int8)}, "attn_out_w_q"),
            ({"qkv_w_s": meta(64)}, "qkv_w_s")):
        with pytest.raises(KernelError, match=match):
            layer_mod._check_args(*_meta_int8_args(**change), quantized=True)


# -- K5's LayerNorm GEMMs: the int8 launch plan -------------------------------

H100_BLOCK_SMEM = 232_448        # the most shared memory a block may take


def _path_rows(spec, batch_size=256):
    """Every M the paths launch the layer at: one query (max_length rows)
    and a full index batch of each sequence bucket."""
    length = spec.default_max_length
    buckets = sorted({min(b, length) for b in Encoder.BUCKETS})
    return [length] + [batch_size * max(1, length // s) * s for s in buckets]


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_int8_ln_gemm_plan_at_every_width_and_path_shape(name):
    spec = ENCODERS[name]
    h = spec.hidden_size
    for m in _path_rows(spec):
        for k in (h, spec.intermediate_size):
            plan = ln_gemm_plan(m, h, k, quantized=True)
            assert plan.cluster <= MAX_CLUSTER
            assert plan.cluster == (h // LN_SLICE if h >= LN_SLICE else 1)
            assert plan.blocks == -(-m // plan.bm) * plan.cluster
            assert plan.smem <= H100_BLOCK_SMEM
            assert plan.slabs == -(-k // 128)      # int8 slabs of 128
    if name == "gte-large":           # one W8A8 query fills the card
        assert ln_gemm_plan(256, h, 4 * h, quantized=True).blocks >= 128
    # at an index batch the wgmma route's LayerNorm GEMMs: the f32 slice of
    # a row tile over a ring of at least three stages, in the 227 KB a block
    # may take, clusters of at most 8 column tiles that hold whole rows
    layer_mod = importlib.import_module("sema_tpu_torch.ops.encoder_layer")
    for m in _path_rows(spec) + [64 * 256, 32 * 512]:
        for k in (h, spec.intermediate_size):
            plan = layer_mod.gemm_route(m, h, k, True, True, 2, 66)
            if plan.route != "wgmma":
                assert m < 16_384 or h < LN_SLICE
                continue
            assert plan.cluster * plan.bn == h and plan.cluster <= MAX_CLUSTER
            assert plan.stages >= 3 and plan.smem <= H100_BLOCK_SMEM
            assert layer_mod.wg_ln_bytes(plan.bn) <= (
                plan.stages * layer_mod.wg_stage_bytes(plan.bn))


@pytest.mark.parametrize("h", [64, 128, 192, 320, 384, 768, 1024, 1280])
def test_int8_wrapper_refuses_what_the_plan_refuses(h):
    plan = ln_gemm_plan(256, h, 2 * h, quantized=True)
    args = _meta_int8_args(h=h, heads=h // 64, inter=2 * h)
    if plan is not None:
        assert plan.cluster == max(1, h // LN_SLICE)
        importlib.import_module("sema_tpu_torch.ops.encoder_layer")._check_args(
            *args, quantized=True)
    else:
        assert h % LN_SLICE and h > LN_SLICE or h > LN_SLICE * MAX_CLUSTER
        with pytest.raises(KernelError, match="LayerNorm GEMM"):
            importlib.import_module(
                "sema_tpu_torch.ops.encoder_layer")._check_args(
                    *args, quantized=True)


def test_int8_layer_operands_in_the_entry_points_order():
    """K5's gathered leaves: the int8 values as (out, in) rows (the leaf
    itself when it is already column-major, else a copy), the scales, the
    biases in the compute dtype and the LayerNorms in f32."""
    h, inter = 64, 128
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    layer = {"qkv_b": f(3 * h).to(torch.bfloat16),
             "attn_out_b": f(h).to(torch.bfloat16),
             "ffn_in_b": f(inter).to(torch.bfloat16),
             "ffn_out_b": f(h).to(torch.bfloat16),
             **{n: f(h) for n in ("attn_ln_scale", "attn_ln_bias",
                                  "ffn_ln_scale", "ffn_ln_bias")}}
    for name, (k, n) in {"qkv_w": (h, 3 * h), "attn_out_w": (h, h),
                         "ffn_in_w": (h, inter),
                         "ffn_out_w": (inter, h)}.items():
        q, s = bert.quantize_linear(f(k, n))
        layer[name + "_q"] = column_major(q) if name != "qkv_w" else q
        layer[name + "_s"] = s
    ops = int8_mod.layer_operands(layer, torch.bfloat16)
    assert (ops.h, ops.inter, ops.quantized) == (h, inter, True)
    for name, t, ptr in zip(int8_mod._OPERANDS, ops.tensors, ops.ptrs):
        assert t.data_ptr() == ptr
        if name.endswith("_q"):
            torch.testing.assert_close(t, layer[name].t(), rtol=0, atol=0)
            # a view of the leaf where it is already column-major
            assert t.is_contiguous() and ((t.data_ptr()
                                           == layer[name].data_ptr())
                                          == (name != "qkv_w_q"))
        else:
            assert t is layer[name]
    with pytest.raises(KernelError, match="f32"):
        int8_mod.layer_operands(
            {**layer, "ffn_out_w_s": layer["ffn_out_w_s"].to(torch.bfloat16)},
            torch.bfloat16)


# -- K5's four int8 GEMMs: the route of each (gemm_route) ---------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_int8_layer_gemm_plans_at_every_width_and_path_shape(name, dtype):
    """At every path shape and the quarter batches (64, 256) and (32,
    512), each of K5's four int8 GEMMs takes wgmma from 16,384 rows on (in
    f32 too: the int8 products stay on the tensor cores) and the ring at
    one query; int8 slabs of 128 bytes, the f32 outputs with no staging
    (a stage more at the same tile)."""
    layer_mod = importlib.import_module("sema_tpu_torch.ops.encoder_layer")
    spec = ENCODERS[name]
    h, inter = spec.hidden_size, spec.intermediate_size
    for m in _path_rows(spec) + [64 * 256, 32 * 512]:
        plans = layer_mod.layer_gemm_plans(m, h, inter, True, dtype, 66)
        bf16 = layer_mod.layer_gemm_plans(m, h, inter, True, torch.bfloat16,
                                          66)
        routes = {p.route for p in plans}
        assert routes <= {"wgmma", "ring"}
        if m >= 16_384 and h >= LN_SLICE:
            assert routes == {"wgmma"}, (name, m)
        if m <= 256:
            assert routes == {"ring"}, (name, m)
        for g, (plan, ref) in enumerate(zip(plans, bf16)):
            assert plan.smem <= H100_BLOCK_SMEM
            assert (plan.route, plan.bn, plan.tiles) == (
                ref.route, ref.bn, ref.tiles)
            if plan.route == "wgmma" and g in (0, 2):   # int8: 128 wide
                assert plan.bn == 128
                # no output staging in f32: a stage more
                assert plan.stages == ref.stages + (dtype == torch.float32)
            elif plan.route == "ring" and g in (1, 3):
                want = ln_gemm_plan(m, h, inter if g == 3 else h,
                                    quantized=True)
                assert (plan.bm, plan.cluster, plan.grid, plan.smem) == (
                    want.bm, want.cluster, want.blocks, want.smem)


@pytest.mark.parametrize("k", [64, 96, 120, 128, 384])
def test_int8_gemm_route_strides(k):
    """wgmma's int8 rows need K a multiple of 16 (TMA's 16-byte strides);
    a 16-bit GEMM's a multiple of 8."""
    layer_mod = importlib.import_module("sema_tpu_torch.ops.encoder_layer")
    s8 = layer_mod.gemm_route(65_536, 1152, k, False, True, 2, 66)
    f16 = layer_mod.gemm_route(65_536, 1152, k, False, False, 2, 66)
    assert s8.route == ("wgmma" if k % 16 == 0 else "ring")
    assert f16.route == ("wgmma" if k % 8 == 0 else "ring")
