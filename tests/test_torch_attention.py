"""K6 and K7 of the port: ``sema_tpu_torch.ops.fused_attention_block`` and
``fused_attention_qkv`` (on CPU tensors, their plain versions) held
against the JAX package's Pallas kernels in interpret mode, at the full
width and at the local width of one tensor-parallel shard of heads, on
the same numpy inputs; and the wrappers' refusals of what the CUDA
kernels do not take."""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops.fused_attention import (
    fused_attention_block as jax_block, fused_attention_qkv as jax_qkv)
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.attention import (check_block_args,
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
