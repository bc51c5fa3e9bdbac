"""K2 of the port: ``sema_tpu_torch.ops.fused_encoder_layer`` (on CPU
tensors, its plain version) held against the JAX package's fused Pallas
layer in interpret mode, and against its K6 + XLA layer over the VMEM
gate, on the same numpy weights and inputs."""

import importlib
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops.fused_attention import fused_encoder_layer as jax_layer
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.registry import ENCODERS
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.encoder_layer import (LN_SLICE, MAX_CLUSTER,
                                              fused_encoder_layer,
                                              ln_gemm_plan)

layer_mod = importlib.import_module("sema_tpu_torch.ops.encoder_layer")
LN_EPS = 1e-12


def _layer(h, inter, seed):
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) * 0.08).astype(np.float32)
    return {
        "qkv_w": w(h, 3 * h), "qkv_b": w(3 * h),
        "attn_out_w": w(h, h), "attn_out_b": w(h),
        "attn_ln_scale": 1.0 + w(h), "attn_ln_bias": w(h),
        "ffn_in_w": w(h, inter), "ffn_in_b": w(inter),
        "ffn_out_w": w(inter, h), "ffn_out_b": w(h),
        "ffn_ln_scale": 1.0 + w(h), "ffn_ln_bias": w(h),
    }


def _inputs(b, s, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)
    return x, ((1.0 - mask) * -1e9).astype(np.float32)


def _run_both(b, s, h, heads, inter, dtype, seed=0):
    layer = _layer(h, inter, seed)
    x, bias = _inputs(b, s, h, seed + 1)
    scale = 1.0 / math.sqrt(h // heads)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
           torch.float32: jnp.float32}[dtype]
    want = jax_layer(jnp.asarray(x, dtype=jdt),
                     {k: jnp.asarray(v) for k, v in layer.items()},
                     jnp.asarray(bias), num_heads=heads, scale=scale,
                     ln_eps=LN_EPS, interpret=True)
    got = fused_encoder_layer(torch.from_numpy(x).to(dtype),
                              {k: torch.from_numpy(v)
                               for k, v in layer.items()},
                              torch.from_numpy(bias), heads, scale, LN_EPS)
    assert got.dtype == dtype and got.shape == (b, s, h)
    return (np.asarray(want.astype(jnp.float32)),
            got.float().numpy())


@pytest.mark.parametrize("b,s,h,heads,inter", [
    (2, 32, 64, 2, 128),     # head dim 32 (MiniLM's)
    (3, 16, 128, 2, 256),    # head dim 64 (e5-base's)
])
def test_layer_matches_pallas_kernel_f32(b, s, h, heads, inter):
    want, got = _run_both(b, s, h, heads, inter, torch.float32)
    # the JAX package's own bound between its fused and composed layers
    # (tests/test_fused_attention.py): f32 sums taken in another order
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,heads,inter", [
    (2, 32, 64, 2, 128),
    (3, 16, 128, 2, 256),
])
def test_layer_matches_pallas_kernel_bf16(b, s, h, heads, inter):
    want, got = _run_both(b, s, h, heads, inter, torch.bfloat16)
    # bf16 rounds at the same places in both, but a softmax or GELU input
    # that lands one bf16 ulp apart propagates: per-row cosine plus an
    # absolute bound of a few bf16 ulps at LayerNorm scale (|x| ~ 1);
    # rtol lets one ulp through past |x| = 4, where an ulp is 2^-5 > atol
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=2 ** -8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_layer_at_s384_matches_pallas_kernel(dtype):
    """A row longer than 256 (the kernel's key-block attention on the
    card), and f16, at a narrow width: the plain version against the
    fused Pallas layer."""
    want, got = _run_both(1, 384, 64, 2, 128, dtype, seed=5)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
    elif dtype == torch.float16:
        # the bf16 limits scaled by 2^-3 for f16's three more mantissa
        # bits (read: max abs error 0.002, 1 - cosine 2.4e-7); a layer
        # that rounded at bf16's precision would not pass
        assert cos.min() >= 0.9999
        np.testing.assert_allclose(got, want, atol=4e-3, rtol=2 ** -11)
    else:
        # the limits of the bf16 case above
        assert cos.min() >= 0.999
        np.testing.assert_allclose(got, want, atol=3e-2, rtol=2 ** -8)


@pytest.mark.parametrize("dtype,s", [(torch.bfloat16, 192),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 192)])
def test_layer_matches_jax_layer_over_the_vmem_gate(monkeypatch, dtype, s):
    """gte-large's layers are over the JAX package's 14.5 MB VMEM gate
    (sema_tpu/models/bert.py:278-281), so there a layer at S >= 192 runs
    K6 (``fused_attention_block``) and XLA epilogues, and a shorter one
    XLA alone. The port runs K2 for every layer and keeps K2's rounding:
    f32 residuals where the XLA epilogues add them in bf16, and at S < 192
    f32 scores where XLA rounds them to bf16. Held here at H = 768 with an
    FFN of 4,096 (17.3 MB of bf16 weights, head dim 64), over the gate."""
    fa = importlib.import_module("sema_tpu.ops.fused_attention")
    jax_bert = importlib.import_module("sema_tpu.models.bert")
    calls = []
    real_block = fa.fused_attention_block
    monkeypatch.setattr(
        fa, "fused_attention_block",
        lambda *a, **k: calls.append(1) or real_block(*a, **k))
    monkeypatch.setattr(fa, "fused_encoder_layer",
                        lambda *a, **k: pytest.fail("under the gate"))
    h, heads, inter = 768, 12, 4096
    layer = _layer(h, inter, 7)
    x, bias = _inputs(2, s, h, 8)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_bert.encoder_layer(
        jnp.asarray(x, dtype=jdt),
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(bias),
        heads, attn_impl="fused")
    want = np.asarray(want.astype(jnp.float32))
    assert len(calls) == (1 if s >= 192 else 0)
    got = fused_encoder_layer(torch.from_numpy(x).to(dtype),
                              {k: torch.from_numpy(v)
                               for k, v in layer.items()},
                              torch.from_numpy(bias), heads,
                              1.0 / math.sqrt(h // heads), LN_EPS)
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
        return
    # the bf16 limits of chip_smoke.py's layer_close (read: 1 - cosine
    # 3.1e-5 and 3.0e-4, relative error 0.027 and 0.090 at S 192 and 128)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert rel.max() <= 2 ** -3


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    called = []
    monkeypatch.setattr(layer_mod, "encoder_layer_reference",
                        lambda *a, **k: called.append(1))
    x = torch.empty((1, 32, 64), dtype=torch.bfloat16, device="meta")
    mask = torch.empty((1, 32), device="meta")
    with pytest.raises(KernelError, match="CPU or CUDA"):
        fused_encoder_layer(x, {}, mask, 2, 0.17, LN_EPS)
    monkeypatch.setattr(layer_mod, "_check", lambda *a: None)

    def failing_library(*a, **k):
        raise RuntimeError("kernel build failed: nvcc rc=1")
    monkeypatch.setattr(layer_mod._cuda, "library", failing_library)
    before = fused_encoder_layer.launches
    with pytest.raises(RuntimeError, match="kernel build failed"):
        fused_encoder_layer(x, {}, mask, 2, 0.17, LN_EPS)
    assert not called and fused_encoder_layer.launches == before


def _meta_args(b=2, s=32, h=64, heads=2, inter=128, dtype=torch.bfloat16):
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                        device="meta")
    shapes = {"qkv_w": (h, 3 * h), "qkv_b": (3 * h,), "attn_out_w": (h, h),
              "attn_out_b": (h,), "ffn_in_w": (h, inter),
              "ffn_in_b": (inter,), "ffn_out_w": (inter, h),
              "ffn_out_b": (h,), "attn_ln_scale": (h,), "attn_ln_bias": (h,),
              "ffn_ln_scale": (h,), "ffn_ln_bias": (h,)}
    layer = {name: meta(*shape) for name, shape in shapes.items()}
    return meta(b, s, h, dt=dtype), layer, meta(b, s), heads


def test_check_args_takes_the_shapes_the_kernels_take():
    for hd_case in ({}, {"h": 128, "heads": 2, "inter": 256}):
        layer_mod._check_args(*_meta_args(**hd_case))      # head dims 32 and 64


@pytest.mark.parametrize("case", [
    {"dtype": torch.float16}, {"dtype": torch.float32},
    {"s": 257}, {"s": 384}, {"s": 512}, {"s": 1}, {"s": 512, "h": 128,
                                                    "heads": 2, "inter": 256},
])
def test_check_args_takes_every_dtype_and_length(case):
    """K2 takes f16 and f32 as well as bf16, and any S >= 1 (rows longer
    than 256 go through the attention in key blocks)."""
    layer_mod._check_args(*_meta_args(**case))


@pytest.mark.parametrize("change,match", [
    ({"dtype": torch.float64}, "takes bf16"),
    ({"dtype": torch.int32}, "takes bf16"),
    ({"h": 96, "heads": 3}, "multiple of 64"),
    ({"h": 128, "heads": 1}, "head dim 32 or 64"),
    pytest.param({"s": 0}, "S >= 1", id="change4-S <= 256"),
    ({"inter": 96}, "multiple of 64"),
])
def test_check_args_raises_on_what_the_kernels_do_not_take(change, match):
    with pytest.raises(KernelError, match=match):
        layer_mod._check_args(*_meta_args(**change))


def test_check_args_raises_on_a_misshapen_weight_or_mask():
    x, layer, mask, heads = _meta_args()
    with pytest.raises(KernelError, match="qkv_w"):
        layer_mod._check_args(x, {**layer, "qkv_w": layer["attn_out_w"]}, mask,
                         heads)
    with pytest.raises(KernelError, match="mask_bias"):
        layer_mod._check_args(x, layer, mask[:, :16], heads)


# -- the LayerNorm GEMMs' launch plan (ln_gemm_plan mirrors the kernel's) ----

H100_BLOCK_SMEM = 232_448        # the most shared memory a block may take


def _path_rows(spec, batch_size=256):
    """Every M the paths launch the layer at: one query (max_length rows)
    and a full index batch of each sequence bucket (Encoder.encode_texts:
    batch_size * max_length // S sequences of S)."""
    length = spec.default_max_length
    buckets = sorted({min(b, length) for b in Encoder.BUCKETS})
    return [length] + [batch_size * max(1, length // s) * s for s in buckets]


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_ln_gemm_plan_at_every_width_and_path_shape(name):
    spec = ENCODERS[name]
    h = spec.hidden_size
    for m in _path_rows(spec):
        for k in (h, spec.intermediate_size):
            plan = ln_gemm_plan(m, h, k, quantized=False)
            assert plan.cluster <= MAX_CLUSTER
            assert plan.cluster == (h // LN_SLICE if h >= LN_SLICE else 1)
            assert plan.cluster * plan.slice == h
            assert plan.bm in (16, 32, 64)
            assert plan.blocks == -(-m // plan.bm) * plan.cluster
            assert plan.smem <= H100_BLOCK_SMEM
            assert plan.slabs == -(-k // 64)
    if name == "gte-large":           # one query fills the card
        assert ln_gemm_plan(256, h, h, quantized=False).blocks >= 128
        assert ln_gemm_plan(65_536, h, h, quantized=False).bm == 64


@pytest.mark.parametrize("h", [32, 64, 96, 128, 192, 256, 384, 640, 768,
                               1024, 1152, 2048])
def test_wrapper_refuses_what_the_plan_refuses(h):
    """H a multiple of 128 up to 1,024 takes a cluster of H / 128, an H
    under 128 one block of an H-column slice; the wrapper raises
    KernelError for every other H, and for an H its head dims refuse."""
    plan = ln_gemm_plan(256, h, 4 * h, quantized=False)
    if h % LN_SLICE == 0 and h <= LN_SLICE * MAX_CLUSTER:
        assert (plan.cluster, plan.slice) == (h // LN_SLICE, LN_SLICE)
    elif h < LN_SLICE:
        assert (plan.cluster, plan.slice) == (1, h)
    else:
        assert plan is None
    args = _meta_args(h=h, heads=h // 64 if h % 64 == 0 else h // 32,
                      inter=2 * h)
    if h % 64 == 0 and plan is not None:
        layer_mod._check_args(*args)
    else:
        with pytest.raises(KernelError):
            layer_mod._check_args(*args)


def test_layer_operands_in_the_entry_points_order():
    """An Encoder gathers each layer's leaves once (``layer_operands``):
    in sema_encoder_layer's order, the leaves themselves where they are
    already in the compute dtype (LayerNorms in f32), copies where not."""
    layer = {n: torch.from_numpy(v) for n, v in _layer(64, 128, 0).items()}
    for name in layer_mod._OPERANDS:
        if name not in layer_mod._LN and name != "qkv_b":
            layer[name] = layer[name].to(torch.bfloat16)
    ops = layer_mod.layer_operands(layer, torch.bfloat16)
    assert (ops.h, ops.inter, ops.quantized) == (64, 128, False)
    for name, t, ptr in zip(layer_mod._OPERANDS, ops.tensors, ops.ptrs):
        want = torch.float32 if name in layer_mod._LN else torch.bfloat16
        assert t.dtype == want and t.data_ptr() == ptr
        assert (t is layer[name]) == (name != "qkv_b")   # the f32 bias: cast
        torch.testing.assert_close(t.float(), layer[name].to(want).float())
    with pytest.raises(KernelError, match="qkv_w"):
        layer_mod.layer_operands({**layer, "qkv_w": layer["attn_out_w"]},
                                 torch.bfloat16)
    x = torch.empty((1, 32, 64), dtype=torch.float16, device="meta")
    with pytest.raises(KernelError, match="operands made for"):
        fused_encoder_layer(x, layer, torch.empty((1, 32), device="meta"), 2,
                            0.17, LN_EPS, operands=ops)


# -- the layer's GEMM routes (gemm_route mirrors the kernel's) ----------------

CSRC = Path(layer_mod.__file__).resolve().parents[1] / "csrc"
# (B, S) of the quarter batches of K2_SHAPES and K5_SHAPES besides the path
# rows: the longer buckets at a quarter batch
QUARTER_BATCHES = ((64, 256), (32, 512))
CLUSTERS = 66                     # an H100's clusters of two at once


def source_constants() -> dict:
    """Every ``constexpr int|size_t NAME = EXPR;`` of
    csrc/encoder_layer.cu whose EXPR is plain arithmetic, evaluated."""
    src = (CSRC / "encoder_layer.cu").read_text()
    out = {}
    for name, expr in re.findall(
            r"^constexpr (?:int|size_t) (k\w+|[A-Z_0-9]+) = ([^;]+);", src,
            re.M):
        expr = re.sub(r"\b(k\w+|[A-Z][A-Z_0-9]*)\b",
                      lambda m: str(out.get(m.group(1), m.group(1))), expr)
        if re.fullmatch(r"[\d\s+*/()-]+", expr):
            out[name] = eval(expr)        # digits and operators alone
    return out


def test_plan_constants_are_the_sources():
    """The mirror's tiles, thresholds and shared-memory budget are the
    source's own, read from csrc/encoder_layer.cu."""
    c = source_constants()
    assert (c["kWgBM"], c["kWgBK"], c["kWgMinTiles"], c["kWgCluster"],
            c["kWgPiece"], c["kWgReserve"]) == (
        layer_mod.WG_BM, layer_mod.WG_BK, layer_mod.WG_MIN_TILES,
        layer_mod.WG_CLUSTER, layer_mod.WG_PIECE, layer_mod.WG_RESERVE)
    assert (c["BN"], c["BK"], c["BK8"], c["kLnSlice"], c["kMaxCluster"],
            c["kFillBlocks"], c["kGemmThreads"]) == (
        layer_mod.BN, layer_mod.BK, layer_mod.BK8, LN_SLICE, MAX_CLUSTER,
        layer_mod.FILL_BLOCKS, layer_mod.GEMM_THREADS)
    src = (CSRC / "encoder_layer.cu").read_text()
    assert f"return (int)(({layer_mod.SMEM_MAX} - kWgReserve" in src
    # the route codes, in ROUTES' order
    assert "enum Route { kRouteRing = 0, kRouteWgmma = 1, kRouteSimt = 2 };" \
        in src and layer_mod.ROUTES == ("ring", "wgmma", "simt")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_layer_gemm_plans_at_every_width_and_path_shape(name, dtype):
    """At every path shape (one query; each index bucket) and the quarter
    batches, each of K2's four GEMMs takes wgmma from 16,384 rows on and
    the ring at one query: tiles of 128 rows, whole clusters, a grid of
    every tile (LayerNorm) or of at most the card's clusters, shared memory
    a block may take; the LayerNorm route's clusters hold whole rows."""
    spec = ENCODERS[name]
    h, inter = spec.hidden_size, spec.intermediate_size
    rows = _path_rows(spec) + [b * s for b, s in QUARTER_BATCHES]
    for m in rows:
        plans = layer_mod.layer_gemm_plans(m, h, inter, False, dtype,
                                           CLUSTERS)
        assert len(plans) == len(layer_mod.GEMMS)
        for g, plan in enumerate(plans):
            ln = g in (1, 3)
            assert plan.smem <= H100_BLOCK_SMEM
            if plan.route == "ring":
                assert plan.tiles == plan.grid
                continue
            assert plan.route == "wgmma" and plan.bm == 128
            if ln:
                assert plan.cluster * plan.bn == h <= LN_SLICE * MAX_CLUSTER
                assert plan.cluster <= MAX_CLUSTER and plan.stages >= 3
                assert plan.grid == plan.tiles == -(-m // 128) * plan.cluster
                assert layer_mod.wg_ln_bytes(plan.bn) <= (
                    plan.stages * layer_mod.wg_stage_bytes(plan.bn))
            else:
                assert plan.cluster == 2 and plan.bn in (128, 256)
                assert plan.grid <= 2 * CLUSTERS and plan.grid % 2 == 0
                assert plan.tiles >= 128
        routes = {p.route for p in plans}
        if m >= 16_384 and h >= 128:
            assert routes == {"wgmma"}, (name, m)
        if m <= 256:
            assert routes == {"ring"}, (name, m)
    if name == "gte-large":        # the LayerNorm tiles 256 wide, 4 a row
        ln = layer_mod.layer_gemm_plans(65_536, h, inter, False, dtype,
                                        CLUSTERS)[1]
        assert (ln.bn, ln.cluster, ln.stages, ln.grid) == (256, 4, 4, 2048)


@pytest.mark.parametrize("case,want", [
    # (m, n, k, ln, quantized, out_bytes, clusters): the route
    ((65_536, 1152, 384, False, False, 2, 66), "wgmma"),
    ((65_536, 1152, 380, False, False, 2, 66), "ring"),    # K % 8
    ((65_536, 1156, 384, False, False, 2, 66), "ring"),    # N % 8
    ((65_536, 1152, 384, False, True, 2, 66), "wgmma"),
    ((65_536, 1152, 376, False, True, 2, 66), "ring"),     # int8 K % 16
    ((65_536, 1152, 384, False, False, 2, 0), "ring"),     # no cluster fits
    ((65_536, 1152, 384, False, False, 4, 66), "simt"),    # K2 in f32
    ((65_536, 1152, 384, False, True, 4, 66), "wgmma"),    # K5 in f32
    ((16_384, 384, 1536, True, False, 2, 66), "wgmma"),
    ((5_376, 384, 1536, True, False, 2, 66), "ring"),      # 42 x 3 tiles
    ((65_536, 1280, 1280, True, False, 2, 66), "ring"),    # c 5 > 1,024 wide
    ((65_536, 640, 640, True, False, 2, 66), "wgmma"),     # c 5 of 128
    ((65_536, 64, 128, True, False, 2, 66), "ring"),       # narrower than 128
    ((65_536, 1024, 4096, True, True, 2, 0), "wgmma"),     # a grid of every tile
    ((256, 1024, 4096, True, True, 2, 66), "ring"),        # one query
])
def test_gemm_route_refuses_what_the_source_refuses(case, want):
    """wgmma only where TMA can stride the rows (N of 8, K of 8, of 16 in
    int8), the tiles fill the card and, for the LayerNorm GEMM, a cluster
    of at most 1,024 columns holds the rows; else the ring, which refuses
    a LayerNorm width it does not take (cluster 0); K2's f32 GEMMs SIMT."""
    plan = layer_mod.gemm_route(*case)
    assert plan.route == want
    if case[:2] == (65_536, 1280):
        assert plan.cluster == 0       # the ring refuses it too
        assert layer_mod.ln_gemm_plan(65_536, 1280, 1280, False) is None


def test_qkv_gemm_plan_is_the_bias_gemms_route():
    """K6's qkv GEMM plan is the EPI_BIAS GEMM's route of K2."""
    for m, n, k in ((65_536, 3072, 1024), (256, 1536, 1024),
                    (16_384, 576, 384)):
        r = layer_mod.gemm_route(m, n, k, False, False, 2, CLUSTERS)
        q = layer_mod.qkv_gemm_plan(m, n, k, CLUSTERS)
        assert (q.route, q.bm, q.bn, q.stages, q.tiles, q.grid, q.smem) == (
            r.route, r.bm, r.bn, r.stages, r.tiles, r.grid, r.smem)


# -- the f32 route's SIMT GEMMs (simt_plan mirrors the kernel's) -------------


def test_simt_constants_are_the_sources():
    """The f32 GEMM's slab, padding, fill target, stages and tiles are the
    source's own, read from csrc/encoder_layer.cu."""
    c = source_constants()
    assert (c["kSimtBK"], c["kSimtPad"], c["kSimtFill"]) == (
        layer_mod.SIMT_BK, layer_mod.SIMT_PAD, layer_mod.SIMT_FILL)
    src = (CSRC / "encoder_layer.cu").read_text()
    assert ("constexpr int simt_stages(int bm) { return bm >= 64 ? 4 : 6; }"
            in src)
    assert [layer_mod.simt_stages(bm) for bm in (8, 16, 32, 64, 128)] == [
        6, 6, 6, 4, 4]
    body = re.search(r"constexpr SimtTile kSimtTiles\[\] = \{(.*?)\};", src,
                     re.S).group(1)
    tiles = tuple(tuple(int(v) for v in t.split(","))
                  for t in re.findall(r"\{([\d,\s]+)\}", body))
    assert tiles == layer_mod.SIMT_TILES
    # every tile is 256 threads of TM x TN outputs; the launcher's switch
    # instantiates each, in kSimtTiles' order (a LayerNorm GEMMs' tile for
    # EPI_LN alone)
    cases = src[src.index("cudaError_t with_simt_kernel("):]
    for i, (bm, bn, tm, tn, ln) in enumerate(tiles):
        assert (bm // tm) * (bn // tn) == layer_mod.GEMM_THREADS
        case = cases[cases.index(f"case {i}:"):cases.index(
            f"case {i + 1}:" if i + 1 < len(tiles) else "default:")]
        assert f"go(gemm_simt_kernel<EPI, {bm}, {bn}, {tm}, {tn}>)" in case
        assert ("if constexpr (EPI == EPI_LN)" in case) == bool(ln)


def test_f32_route_no_longer_reaches_the_old_gemm():
    """K2's f32 layer and K6's f32 qkv product launch the SIMT GEMM of
    simt_plan, four GEMMs a layer; the SIMT GEMM of one row block a
    block (gemm_f32_kernel) is gone."""
    src = (CSRC / "encoder_layer.cu").read_text()
    assert "gemm_f32_kernel" not in src and "launch_gemm_f32" not in src
    layer = src[src.index("cudaError_t layer_f32("):]
    layer = layer[:layer.index("\n}\n")]
    assert [m.group(1) for m in re.finditer(
        r"launch_gemm_simt<(EPI_\w+)>", layer)] == [
        "EPI_BIAS", "EPI_LN", "EPI_GELU", "EPI_LN"]
    block = src[src.index("cudaError_t attention_block("):]
    block = block[:block.index("\n}\n")]
    assert "launch_gemm_simt<EPI_BIAS>(x, w_qkv" in block


@pytest.mark.parametrize("m", [256, 65_536])
@pytest.mark.parametrize("name", ["minilm-l6", "e5-base", "gte-large"])
def test_f32_layer_plans_fill_the_card(name, m):
    """At one query (m = 256) and an index batch, each of K2's four f32
    GEMMs takes the SIMT route on a grid of every tile that puts a block on
    each of an H100's 132 SMs, in shared memory a block may take; the
    LayerNorm GEMMs as clusters of at most 8 column tiles that hold whole
    rows (at one query on 192 or more blocks, where the GEMM of 32 rows a
    block before took 8); an index batch in tiles of 128 x 128."""
    spec = ENCODERS[name]
    h, inter = spec.hidden_size, spec.intermediate_size
    plans = layer_mod.layer_gemm_plans(m, h, inter, False, torch.float32,
                                       CLUSTERS)
    for g, (plan, (n, k)) in enumerate(zip(plans, (
            (3 * h, h), (h, h), (inter, h), (h, inter)))):
        ln = g in (1, 3)
        assert plan == layer_mod.gemm_route(m, n, k, ln, False, 4, 0)
        assert plan.route == "simt" and plan.smem <= layer_mod.SMEM_MAX
        assert plan.stages == layer_mod.simt_stages(plan.bm)
        assert plan.grid == plan.tiles == -(-m // plan.bm) * -(-n // plan.bn)
        assert plan.grid >= layer_mod.SIMT_FILL
        if ln:
            assert plan.cluster * plan.bn == h and plan.cluster <= MAX_CLUSTER
            assert plan.smem >= (plan.bm * (plan.bn + 8) + 8 * h) * 4
        else:
            assert plan.cluster == 1
        if m == 256 and ln:
            assert plan.grid >= 192
        if m == 65_536:      # MiniLM's LayerNorm GEMMs in clusters of 6
            assert (plan.bm, plan.bn) == (
                (128, 64) if ln and h // 64 <= MAX_CLUSTER else (128, 128))


@pytest.mark.parametrize("case,want", [
    # (m, n, k, ln): (bm, bn, cluster, grid), or None where it refuses
    ((256, 1152, 384, False), (32, 64, 1, 144)),      # MiniLM's qkv, a query
    ((256, 384, 384, True), (8, 64, 6, 192)),         # its LayerNorm GEMMs
    ((256, 4096, 1024, False), (64, 64, 1, 256)),     # gte-large's FFN up
    ((256, 1024, 4096, True), (8, 128, 8, 256)),      # its FFN down + LN2
    ((256, 1536, 1024, False), (32, 64, 1, 192)),     # K6, gte-large tp 2
    ((256, 288, 384, False), (8, 64, 1, 160)),        # K6, MiniLM tp 4
    ((8, 64, 64, False), (8, 64, 1, 1)),              # nothing fills: the last
    ((64, 64, 128, True), (8, 64, 1, 8)),             # H 64: one block a row
    ((256, 1152, 376, False), None),                  # K % 16
    ((256, 1150, 384, False), None),                  # N % 4
    ((32_768, 384, 1536, True), (128, 64, 6, 1536)),  # MiniLM's at an index
    ((32_768, 384, 1536, False), (128, 128, 1, 768)), # not a LayerNorm GEMM
    ((65_536, 1024, 4096, True), (128, 128, 8, 4096)),  # 16 tiles of 64: 128
    ((256, 1280, 1280, True), None),                  # 10 column tiles of 128
    ((256, 96, 96, True), None),                      # no tile divides H
])
def test_simt_plan_by_shape(case, want):
    """The tile is the first of SIMT_TILES whose grid has SIMT_FILL blocks,
    else the last the shape takes; a LayerNorm GEMM only takes a tile whose
    width divides N in at most 8 tiles; cluster 0 where the kernel refuses
    the shape (K a multiple of 16, N of 4)."""
    plan = layer_mod.simt_plan(*case)
    assert plan.route == "simt"
    if want is None:
        assert plan.cluster == 0 and plan.grid == 0
    else:
        assert (plan.bm, plan.bn, plan.cluster, plan.grid) == want
