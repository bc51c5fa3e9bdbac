"""K6 and K7 of the port: ``sema_tpu_torch.ops.fused_attention_block`` and
``fused_attention_qkv`` (on CPU tensors, their plain versions) held
against the JAX package's Pallas kernels in interpret mode, at the full
width and at the local width of one tensor-parallel shard of heads, on
the same numpy inputs; and the wrappers' refusals of what the CUDA
kernels do not take."""

import importlib
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops.fused_attention import (
    fused_attention_block as jax_block, fused_attention_qkv as jax_qkv)
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.registry import ENCODERS
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.attention import (attention_plan, check_block_args,
                                          check_qkv_args,
                                          fused_attention_block,
                                          fused_attention_qkv)
from sema_tpu_torch.ops.encoder_layer import SMEM_MAX, qkv_gemm_plan

attn_mod = importlib.import_module("sema_tpu_torch.ops.attention")
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _mask_bias(b, s, rng):
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s                                 # one row unpadded
    return ((np.arange(s)[None, :] >= lengths[:, None]) * -1e9).astype(
        np.float32)


def _assert_close(got, want, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    # K2's bf16 limits (tests/test_torch_encoder_layer.py): a score that
    # lands one bf16 ulp apart moves a probability by one ulp
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=2 ** -8)


# (H, heads of the whole layer, tp, B, S, dtype): H_out = H / tp over
# heads / tp local heads; head dims 32 (MiniLM's) and 64 (gte-large's)
CASES = [
    (128, 4, 1, 2, 8, torch.float32),
    (128, 4, 2, 3, 64, torch.float32),
    (128, 4, 4, 2, 192, torch.float32),
    (128, 2, 2, 2, 192, torch.float32),
    (128, 2, 1, 3, 64, torch.bfloat16),
    (128, 4, 2, 2, 192, torch.bfloat16),
    (128, 4, 4, 3, 8, torch.bfloat16),
    # rows past 256 keys, the tiles whose scores the kernel keeps in shared
    # memory: a ragged one and the longest of the one-pass kernel
    (128, 2, 1, 2, 300, torch.float32),
    (128, 2, 1, 2, 300, torch.bfloat16),
    (128, 2, 1, 2, 512, torch.float32),
    (128, 2, 1, 2, 512, torch.bfloat16),
    # the full width (tp 1) at head dim 32 and a 256-key row: K2's and K5's
    # attention launch at an index bucket
    (128, 4, 1, 2, 256, torch.bfloat16),
]


@pytest.mark.parametrize("h,heads,tp,b,s,dtype", CASES)
def test_qkv_attention_matches_pallas_kernel(h, heads, tp, b, s, dtype):
    rng = np.random.default_rng(s + tp)
    h_out, n_local = h // tp, heads // tp
    qkv = (1.5 * rng.standard_normal((b, s, 3 * h_out))).astype(np.float32)
    bias = _mask_bias(b, s, rng)
    scale = 1.0 / math.sqrt(h // heads)
    want = jax_qkv(jnp.asarray(qkv, dtype=JDT[dtype]), jnp.asarray(bias),
                   num_heads=n_local, scale=scale, interpret=True)
    got = fused_attention_qkv(torch.from_numpy(qkv).to(dtype),
                              torch.from_numpy(bias), n_local, scale)
    assert got.dtype == dtype and got.shape == (b, s, h_out)
    _assert_close(got.float().numpy(),
                  np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("h,heads,tp,b,s,dtype", CASES)
def test_block_attention_matches_pallas_kernel(h, heads, tp, b, s, dtype):
    rng = np.random.default_rng(100 + s + tp)
    h_out, n_local = h // tp, heads // tp
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    w = (0.08 * rng.standard_normal((h, 3 * h_out))).astype(np.float32)
    qkv_b = (0.5 * rng.standard_normal(3 * h_out)).astype(np.float32)
    bias = _mask_bias(b, s, rng)
    scale = 1.0 / math.sqrt(h // heads)
    want = jax_block(jnp.asarray(x, dtype=JDT[dtype]), jnp.asarray(w),
                     jnp.asarray(qkv_b), jnp.asarray(bias),
                     num_heads=n_local, scale=scale, interpret=True)
    got = fused_attention_block(torch.from_numpy(x).to(dtype),
                                torch.from_numpy(w), torch.from_numpy(qkv_b),
                                torch.from_numpy(bias), n_local, scale)
    assert got.dtype == dtype and got.shape == (b, s, h_out)
    _assert_close(got.float().numpy(),
                  np.asarray(want.astype(jnp.float32)), dtype)


def _meta(*shape, dt=torch.bfloat16):
    return torch.empty(shape, dtype=dt, device="meta")


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    called = []
    for name in ("attention_qkv_reference", "attention_block_reference"):
        monkeypatch.setattr(attn_mod, name, lambda *a, **k: called.append(1))
    mask = _meta(2, 32, dt=torch.float32)
    with pytest.raises(KernelError, match="CPU or CUDA"):
        fused_attention_qkv(_meta(2, 32, 3 * 96), mask, 3, 0.17)
    with pytest.raises(KernelError, match="CPU or CUDA"):
        fused_attention_block(_meta(2, 32, 384), _meta(384, 3 * 96),
                              _meta(3 * 96), mask, 3, 0.17)
    monkeypatch.setattr(attn_mod, "_on_card", lambda *a: None)

    def failing_library(*a, **k):
        raise KernelError("kernel build failed: nvcc rc=1")
    monkeypatch.setattr(attn_mod._cuda, "library", failing_library)
    before = (fused_attention_qkv.launches, fused_attention_block.launches)
    with pytest.raises(KernelError, match="kernel build failed"):
        fused_attention_qkv(_meta(2, 32, 3 * 96), mask, 3, 0.17)
    with pytest.raises(KernelError, match="kernel build failed"):
        fused_attention_block(_meta(2, 32, 384), _meta(384, 3 * 96),
                              _meta(3 * 96), mask, 3, 0.17)
    assert not called
    assert (fused_attention_qkv.launches,
            fused_attention_block.launches) == before


def test_check_args_take_local_widths_and_refuse_the_rest():
    mask = _meta(2, 32, dt=torch.float32)
    # MiniLM at tp 4 (96 = 3 heads of 32), gte-large at tp 2 and tp 4
    for h, h_out, n in ((384, 96, 3), (1024, 512, 8), (1024, 256, 4)):
        check_qkv_args(_meta(2, 32, 3 * h_out), mask, n)
        check_block_args(_meta(2, 32, h), _meta(h, 3 * h_out),
                         _meta(3 * h_out, dt=torch.float32), mask, n)
    for qkv, n, match in ((_meta(2, 32, 3 * 96 + 1), 3, "thirds"),
                          (_meta(2, 32, 3 * 96), 2, "head dim"),
                          (_meta(2, 32, 3 * 96, dt=torch.int8), 3, "bf16"),
                          (_meta(2, 0, 3 * 96), 3, "S >= 1")):
        with pytest.raises(KernelError, match=match):
            check_qkv_args(qkv, mask if qkv.shape[1] else _meta(2, 0), n)
    with pytest.raises(KernelError, match="mask_bias"):
        check_qkv_args(_meta(2, 32, 3 * 96), _meta(2, 16), 3)
    for x, w, b in ((_meta(2, 32, 400), _meta(400, 288), _meta(288)),
                    (_meta(2, 32, 384), _meta(256, 288), _meta(288)),
                    (_meta(2, 32, 384), _meta(384, 288), _meta(96))):
        with pytest.raises(KernelError, match="fused_attention_block"):
            check_block_args(x, w, b, mask, 3)


# K6's qkv GEMM plan at (B·S, 3·H_out, H) on a card that holds 66 clusters
# of two blocks at once: the index batches of gte-large and MiniLM at tp 2
# and 4 take wgmma, one query the ring GEMM; (route, BM, BN, stages, tiles,
# grid)
PLANS = [
    ((65_536, 1536, 1024), ("wgmma", 128, 256, 3, 3072, 132)),
    ((16_384, 1536, 1024), ("wgmma", 128, 256, 3, 768, 132)),
    ((49_152, 768, 1024), ("wgmma", 128, 256, 3, 1152, 132)),
    ((16_384, 576, 384), ("wgmma", 128, 128, 6, 640, 132)),
    ((49_152, 288, 384), ("wgmma", 128, 128, 6, 1152, 132)),
    ((8_320, 1536, 1024), ("wgmma", 128, 256, 3, 396, 132)),  # ragged M
    ((256, 1536, 1024), ("ring", 32, 128, 4, 96, 96)),
    ((256, 288, 384), ("ring", 32, 128, 4, 24, 24)),
    ((16_384, 1536, 1020), ("ring", 64, 128, 3, 3072, 3072)),  # K % 8
    ((5_376, 288, 384), ("ring", 32, 128, 4, 504, 504)),   # 126 tiles
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_qkv_gemm_plan_routes_by_shape(shape, want):
    plan = qkv_gemm_plan(*shape, 66)
    assert tuple(plan)[:6] == want
    assert plan.smem <= SMEM_MAX


def test_qkv_gemm_plan_grid_is_persistent_only_on_wgmma():
    small = qkv_gemm_plan(16_384, 1536, 1024, 4)
    assert small.route == "wgmma" and small.grid == 8
    assert small.tiles == qkv_gemm_plan(16_384, 1536, 1024, 66).tiles
    few = qkv_gemm_plan(16_384, 128, 1024, 66)     # 64 cluster tiles
    assert few.route == "wgmma" and few.grid == few.tiles == 128
    assert qkv_gemm_plan(16_384, 1536, 1024, 0).route == "ring"
    ring = qkv_gemm_plan(256, 1536, 1024, 4)
    assert ring.route == "ring" and ring.grid == ring.tiles


# The attention plan at every shape the paths launch: each bucket of
# Encoder.BUCKETS at its index batch (batch_size 256 x max_length 256 / S
# rows) and at one query, at every width of the registry whose heads the
# kernels take (head dim 32 or 64), at tp 1, 2 and 4, in each dtype, on a
# card of 132 SMs: the wgmma route where the batch holds AW_MIN_PAIRS
# (batch row, head) pairs and 32 < S <= 256, the mma.sync kernel at one
# query and the 32-key buckets, f32's SIMT kernel; every route's shared
# memory within what a block may use.
PATH_SHAPES = [(name, tp, b, s, dt)
               for name, spec in ENCODERS.items()
               if spec.hidden_size // spec.num_heads in (32, 64)
               for tp in (1, 2, 4) if spec.num_heads % tp == 0
               for s in Encoder.BUCKETS for b in (256 * 256 // s, 1)
               for dt in (torch.bfloat16, torch.float16, torch.float32)]


@pytest.mark.parametrize("name,tp,b,s,dtype", PATH_SHAPES)
def test_attention_plan_routes_every_path_shape(name, tp, b, s, dtype):
    spec = ENCODERS[name]
    h, heads = spec.hidden_size // tp, spec.num_heads // tp
    plan = attention_plan(b, s, h, heads, dtype, 132)
    want = ("simt" if dtype == torch.float32
            else "wgmma" if s > 32 and b * heads >= 132 else "mma")
    assert plan.route == want
    assert plan.hd == spec.hidden_size // spec.num_heads
    assert 0 < plan.smem <= SMEM_MAX
    if want == "wgmma":
        assert plan.tile == -(-s // 64) and plan.stages >= 2
        assert plan.grid == min(b * heads, 132) and plan.threads == 256
    else:
        assert plan.grid == -(-s // 64) * heads * b


# (B, S, H, heads, dtype) -> (route, head dim, key tile or chunks, stages,
# grid, threads, shared memory) on a card of 132 SMs: the index batches of
# gte-large (tp 1 and 2) and MiniLM on the wgmma route, its rows of 64
# keys with eight stages, one query and 512 keys on the mma.sync kernel,
# 640 keys on the long rows' kernel, f32 on its SIMT kernel
ATTN_PLANS = [
    ((256, 256, 1024, 16, torch.bfloat16),
     ("wgmma", 64, 4, 2, 132, 256, 216_256)),
    ((256, 256, 512, 8, torch.bfloat16),
     ("wgmma", 64, 4, 2, 132, 256, 216_256)),
    ((256, 192, 192, 6, torch.float16),
     ("wgmma", 32, 3, 5, 132, 256, 198_848)),
    ((1024, 64, 384, 12, torch.bfloat16),
     ("wgmma", 32, 1, 8, 132, 256, 115_904)),
    ((2, 256, 1024, 16, torch.bfloat16),
     ("mma", 64, 64, 0, 128, 128, 70_656)),
    ((1, 256, 1024, 16, torch.bfloat16),
     ("mma", 64, 64, 0, 64, 128, 70_656)),
    ((2048, 32, 1024, 16, torch.bfloat16),
     ("mma", 64, 32, 0, 32_768, 128, 27_264)),
    ((32, 512, 512, 8, torch.bfloat16),
     ("mma", 64, 64, 0, 2_048, 128, 104_448)),
    ((16, 640, 512, 8, torch.bfloat16),
     ("long", 64, 64, 0, 1_280, 128, 27_904)),
    ((256, 128, 384, 12, torch.float32),
     ("simt", 32, 64, 0, 6_144, 256, 64_512)),
]


@pytest.mark.parametrize("shape,want", ATTN_PLANS)
def test_attention_plan_by_shape(shape, want):
    plan = attention_plan(*shape, 132)
    assert tuple(plan) == want
    assert plan.smem <= SMEM_MAX


def test_attention_plan_refuses_what_no_kernel_takes():
    assert attention_plan(256, 256, 1024, 8, torch.bfloat16, 132) is None
    assert attention_plan(256, 256, 1000, 16, torch.bfloat16, 132) is None
    assert attention_plan(0, 256, 1024, 16, torch.bfloat16, 132) is None
    # a card that cannot say its SMs: no wgmma route
    assert attention_plan(256, 256, 1024, 16, torch.bfloat16, 0).route \
        == "mma"


def test_attention_plan_constants_are_the_sources():
    """The mirror's tiles, chunks, ring, threshold and threads are
    csrc/encoder_layer.cu's own, and its routes the source's codes."""
    src = (Path(attn_mod.__file__).resolve().parents[1] / "csrc"
           / "encoder_layer.cu").read_text()
    c = {}
    for name, expr in re.findall(r"^constexpr (?:int|size_t) (k\w+) = ([^;]+);",
                                 src, re.M):
        expr = re.sub(r"\b(k\w+)\b", lambda m: str(c.get(m.group(1),
                                                           m.group(1))), expr)
        if re.fullmatch(r"[\d\s+*/()-]+", expr):
            c[name] = eval(expr)          # digits and operators alone
    assert (c["kAwChunk"], c["kAwMaxChunks"], c["kAwThreads"],
            c["kAwMaxStages"], c["kAwMinPairs"], c["kAwReserve"]) == (
        attn_mod.AW_CHUNK, attn_mod.AW_MAX_CHUNKS, attn_mod.AW_THREADS,
        attn_mod.AW_MAX_STAGES, attn_mod.AW_MIN_PAIRS, attn_mod.AW_RESERVE)
    assert (c["kAttnMaxKeys"], c["kAttnWarps"], c["kAttnStages"],
            c["kKeyBlock"]) == (attn_mod.ATTN_MAX_KEYS, attn_mod.ATTN_WARPS,
                                attn_mod.ATTN_STAGES, attn_mod.KEY_BLOCK)
    assert (c["kF32Rows"], c["kF32Keys"], c["kF32CachedKeys"],
            c["kF32Threads"]) == (attn_mod.F32_ROWS, attn_mod.F32_KEYS,
                                  attn_mod.F32_CACHED, attn_mod.F32_THREADS)
    assert (f"(({attn_mod.SMEM_MAX} - kAwReserve - aw_staging(hd)) / "
            "aw_stage_bytes(hd, nt))" in src)
    assert ("enum AttnRoute { kAttnMma = 0, kAttnWgmma = 1, kAttnLong = 2, "
            "kAttnSimt = 3 };" in src and attn_mod.ATTN_ROUTES == (
                "mma", "wgmma", "long", "simt"))
