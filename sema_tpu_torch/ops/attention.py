"""Multi-head attention of one shard of heads: K6 and K7 of the port.

K7, :func:`fused_attention_qkv`, replaces the TPU kernel
``sema_tpu/ops/fused_attention.py:fused_attention_qkv`` (``_attn_kernel``):
softmax attention from a qkv projection in its natural (B, S, 3·H_out)
layout, q|k|v on the feature axis with the heads inside each third, to the
(B, S, H_out) context. K6, :func:`fused_attention_block`, replaces
``fused_attention_block`` (``_attn_block_kernel``): the qkv projection of
x (B, S, H) by a (H, 3·H_out) weight and (3·H_out,) bias, then K7's
attention. Under tensor parallelism the weight holds the local heads'
columns only (``models/tp.py``), so H_out = H / tp and the heads are
heads / tp; at tp = 1 H_out = H. Both run on the tensor-parallel encoder
(``models/bert.py:encoder_layer_tp``); the single-device encoder runs
K2, whose qkv GEMM and attention are the same kernels.

On a CUDA tensor each wrapper launches the kernels of
``csrc/encoder_layer.cu`` or raises
:class:`~sema_tpu_torch.ops._cuda.KernelError`; on a CPU tensor it runs
its plain version. There is no other path. K7 is the attention, on the
route of :func:`attention_plan` (the kernel's ``sema_attention_plan``):
at an index batch of 33 to 256 keys a persistent ``wgmma`` kernel fed by
TMA that reads each (batch row, head)'s Q, K and V once and keeps the
scores and exponentials in registers; else up to 512 keys one kernel
that streams each key and value tile through shared memory once, beyond
that three passes over the key blocks; f32 a SIMT kernel. Every route
gives the same bits. K6 is the qkv
product with its bias epilogue at N = 3·H_out, K = H, into a (B·S,
3·H_out) scratch, then the attention; the product runs on ``wgmma``, fed
by TMA, in clusters of two blocks that share the weight's slabs, where
the batch fills the card, else on K2's ring GEMM (one query), as
:func:`~sema_tpu_torch.ops.encoder_layer.qkv_gemm_plan` mirrors.

Numerics (``fused_attention.py:58-81, 168-172``): scores are f32 sums of
products of the compute-dtype operands, times ``scale``, plus the f32
mask bias, rounded to the compute dtype before the softmax; the
probabilities are in the compute dtype and the context an f32 sum rounded
once. K6's projection adds the bias rounded to x's dtype, in f32, to the
f32 product and rounds once. The kernels take bf16, f16 and f32, head dim
32 or 64 (so H_out a multiple of 32: MiniLM's 96 at tp = 4 as well), H a
multiple of 32 and any S >= 1 (rows longer than 512 in key blocks).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sema_tpu_torch.ops import _cuda
from sema_tpu_torch.ops._cuda import KernelError

# the dtype argument of every entry point of csrc/encoder_layer.cu
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sema_attention_qkv": [_P] * 3 + [_I] * 5 + [_F, _P, _I],  # stream,
    "sema_attention_block": [_P] * 6 + [_I] * 6 + [_F, _P, _I],  # card
}

# the attention's launch plan (``attention_plan``), as csrc/encoder_layer.cu
# has it: its routes by the source's codes, the mma.sync kernel's tiles,
# the wgmma kernel's chunks and ring, the long rows' and f32's kernels
ATTN_ROUTES = ("mma", "wgmma", "long", "simt")
ATTN_MAX_KEYS = 512             # the longest row of the one-pass kernels
ATTN_WARPS, ATTN_STAGES = 4, 3  # the mma.sync kernel: 64 query rows a block
AW_CHUNK = 64                   # a TMA box's rows: a query tile, a key chunk
AW_MAX_CHUNKS = 4               # the wgmma route's longest row: 256 keys
AW_THREADS = 256                # two warpgroups, each filling the ring too
AW_MAX_STAGES = 8               # its ring's pair stages, at most
AW_MIN_PAIRS = 132              # (batch row, head) pairs from which it runs
AW_RESERVE = 1024 + 3 * AW_MAX_STAGES * 8   # alignment; the barriers
KEY_BLOCK = 64                  # the long rows' key block
F32_ROWS, F32_KEYS, F32_CACHED, F32_THREADS = 64, 64, 512, 256
SMEM_MAX = 232_448              # dynamic shared memory a block may use


class AttnPlan(NamedTuple):
    """How one attention launch runs: ``route`` "mma" (the mma.sync
    kernel, a block a 64-row query tile of a (batch row, head)), "wgmma"
    (the persistent TMA and wgmma kernel, a block an SM walking the pairs),
    "long" (rows past 512 keys) or "simt" (f32); head dim ``hd``; ``tile``
    the mma route's key tile (32 or 64), the wgmma route's key chunks of
    64, the others' key block; ``stages`` the wgmma ring's pair stages;
    ``grid`` blocks of ``threads`` threads, each with ``smem`` bytes of
    dynamic shared memory."""
    route: str
    hd: int
    tile: int
    stages: int
    grid: int
    threads: int
    smem: int


def aw_staging(hd: int) -> int:
    """The wgmma route's two context tiles on their way out (TMA's store):
    64 rows of ``hd`` a warpgroup."""
    return 2 * AW_CHUNK * hd * 2


def aw_stage_bytes(hd: int, nt: int) -> int:
    """A pair stage of the wgmma route at ``nt`` key chunks: nt chunks
    each of Q, K and V (64 rows of a head of ``hd``) and the mask bias of
    nt * 64 keys, in whole KB."""
    return -(-(3 * nt * AW_CHUNK * hd * 2 + nt * AW_CHUNK * 4) // 1024) * 1024


@functools.lru_cache(maxsize=1024)
def attention_plan(b: int, s: int, h: int, heads: int, dtype,
                   sms: int) -> AttnPlan:
    """The kernel's ``attention_plan`` for a (b, s, h) context over
    ``heads`` heads in ``dtype`` on a card of ``sms`` SMs (what
    ``sema_attention_plan`` exports): the wgmma route for bf16/f16 rows of
    33 to 256 keys where the batch holds AW_MIN_PAIRS pairs or more, on
    min(pairs, sms) blocks whose ring holds as many pair stages as fit;
    the mma.sync kernel for the rest up to 512 keys (one query, the 32-key
    buckets), key tiles of 32 for rows of 32 keys or fewer; the long rows'
    kernel beyond; f32 its SIMT kernel. None where no kernel takes the
    head dim."""
    if b <= 0 or s <= 0 or heads <= 0 or h % heads or h // heads not in (32,
                                                                         64):
        return None
    hd, q_tiles = h // heads, -(-s // 64)
    if dtype == torch.float32:
        keys = -(-s // F32_KEYS) * F32_KEYS if s <= F32_CACHED else F32_KEYS
        smem = 4 * (F32_ROWS * (hd + 4) * (3 if s <= F32_CACHED else 5)
                    + F32_ROWS * (keys + 16))
        return AttnPlan("simt", hd, F32_KEYS, 0, -(-s // F32_ROWS) * heads * b,
                        F32_THREADS, smem)
    if s > ATTN_MAX_KEYS:
        return AttnPlan("long", hd, KEY_BLOCK, 0, q_tiles * heads * b, 128,
                        (64 + 2 * KEY_BLOCK) * (hd + 8) * 2 + KEY_BLOCK * 4)
    if 32 < s <= AW_MAX_CHUNKS * AW_CHUNK and b * heads >= AW_MIN_PAIRS \
            and sms > 0:
        nt = -(-s // AW_CHUNK)
        stages = min(AW_MAX_STAGES, (SMEM_MAX - AW_RESERVE - aw_staging(hd))
                     // aw_stage_bytes(hd, nt))
        return AttnPlan("wgmma", hd, nt, stages, min(b * heads, sms),
                        AW_THREADS, stages * aw_stage_bytes(hd, nt)
                        + aw_staging(hd) + AW_RESERVE)
    kt = 32 if s <= 32 else 64
    smem = ((ATTN_WARPS * 16 + ATTN_STAGES * kt) * (hd + 8) * 2
            + -(-s // kt) * kt * (4 + ATTN_WARPS * 16 * 2))
    return AttnPlan("mma", hd, kt, 0, q_tiles * heads * b, ATTN_WARPS * 32,
                    smem)


# the softmaxes of heads_attention: the product's, and the two that
# tools/encoder_ablate.py times its attention without (the plain versions
# of csrc/encoder_layer.cu built with -DSEMA_ABLATE=1 and 2)
SOFTMAXES = ("exp", "no_exp", "no_softmax")


def heads_attention(qkv: torch.Tensor, mask_bias: torch.Tensor,
                    num_heads: int, scale: float,
                    softmax: str = "exp") -> torch.Tensor:
    """The attention core every kernel of the encoder shares
    (``fused_attention.py:_heads_attention``): (B, S, 3·H) qkv in the
    compute dtype and (B, S) f32 mask bias → (B, S, H) context in the
    compute dtype. ``softmax`` other than "exp" computes wrong attention,
    for attribution only: "no_exp" takes s - max + 1 for exp(s - max)
    (``tools/encoder_ablate.py:_heads_attention_no_exp``), "no_softmax"
    the rounded score times 1e-3 as the probability
    (``_heads_attention_no_softmax``), each in f32 from the scores in the
    compute dtype, as the ablated kernels do."""
    b, s, h3 = qkv.shape
    h = h3 // 3
    dt = qkv.dtype
    q, k, v = qkv.reshape(b, s, 3, num_heads, h // num_heads).permute(
        2, 0, 3, 1, 4)
    scores = q.float() @ k.float().transpose(-1, -2)          # (b, n, s, s)
    scores = scores * scale + mask_bias.float()[:, None, None, :]
    scores = scores.to(dt)
    if softmax == "exp":
        probs = torch.softmax(scores, dim=-1)
    elif softmax == "no_exp":
        e = scores.float() - scores.float().amax(-1, keepdim=True) + 1.0
        probs = (e / e.sum(-1, keepdim=True)).to(dt)
    elif softmax == "no_softmax":
        probs = (scores.float() * 1e-3).to(dt)
    else:
        raise ValueError(f"softmax must be one of {SOFTMAXES}, got "
                         f"{softmax!r}")
    ctx = (probs.float() @ v.float()).to(dt)
    return ctx.permute(0, 2, 1, 3).reshape(b, s, h)


def attention_qkv_reference(qkv: torch.Tensor, mask_bias: torch.Tensor,
                            num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_attention_qkv`."""
    return heads_attention(qkv, mask_bias, num_heads, scale)


def attention_block_reference(x: torch.Tensor, qkv_w: torch.Tensor,
                              qkv_b: torch.Tensor, mask_bias: torch.Tensor,
                              num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_attention_block`."""
    b, s, h = x.shape
    dt = x.dtype
    qkv = x.reshape(b * s, h).float() @ qkv_w.to(dt).float()
    qkv = (qkv + qkv_b.to(dt).float()).to(dt)
    return heads_attention(qkv.reshape(b, s, -1), mask_bias, num_heads,
                           scale)


def _check_heads(what: str, t: torch.Tensor, width: int, num_heads: int,
                 mask_bias: torch.Tensor) -> None:
    """Raise KernelError unless the attention kernels take a (B, S, ...)
    tensor ``t`` with ``width`` = H_out over ``num_heads`` heads and its
    (B, S) mask."""
    if t.dtype not in DTYPE_CODES:
        raise KernelError(f"{what} takes bf16, f16 or f32, got {t.dtype}")
    if t.dim() != 3 or t.shape[1] < 1:
        raise KernelError(f"{what}: want (B, S >= 1, ...), got "
                          f"{tuple(t.shape)}")
    if (num_heads < 1 or width % num_heads
            or width // num_heads not in (32, 64)):
        raise KernelError(f"{what}: local width {width} over {num_heads} "
                          "heads; the kernels take head dim 32 or 64")
    b, s = t.shape[:2]
    if tuple(mask_bias.shape) != (b, s) or mask_bias.device != t.device:
        raise KernelError(f"{what}: mask_bias must be ({b}, {s}) on "
                          f"{t.device}, got {tuple(mask_bias.shape)} on "
                          f"{mask_bias.device}")


def check_qkv_args(qkv, mask_bias, num_heads) -> None:
    """Raise KernelError unless K7 takes these arguments."""
    h3 = qkv.shape[-1]
    if h3 % 3:
        raise KernelError(f"fused_attention_qkv: qkv width {h3} is not "
                          "three equal thirds")
    _check_heads("fused_attention_qkv", qkv, h3 // 3, num_heads, mask_bias)


def check_block_args(x, qkv_w, qkv_b, mask_bias, num_heads) -> None:
    """Raise KernelError unless K6 takes these arguments."""
    h3 = qkv_w.shape[-1]
    _check_heads("fused_attention_block", x, h3 // 3, num_heads, mask_bias)
    h = x.shape[-1]
    if (h % 32 or h3 % 3 or tuple(qkv_w.shape) != (h, h3)
            or tuple(qkv_b.shape) != (h3,)
            or not x.device == qkv_w.device == qkv_b.device):
        raise KernelError(
            f"fused_attention_block takes x (B, S, H) with H a multiple of "
            f"32, qkv_w (H, 3·H_out) and qkv_b (3·H_out,) on x's device; "
            f"got {tuple(x.shape)} on {x.device}, {tuple(qkv_w.shape)} on "
            f"{qkv_w.device}, {tuple(qkv_b.shape)} on {qkv_b.device}")


def _on_card(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise KernelError(f"{what} takes CPU or CUDA tensors, got {t.device}")


def fused_attention_qkv(qkv: torch.Tensor, mask_bias: torch.Tensor,
                        num_heads: int, scale: float) -> torch.Tensor:
    """K7: (B, S, 3·H_out) qkv → (B, S, H_out) context (see the module
    docstring). CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if qkv.device.type == "cpu":
        return attention_qkv_reference(qkv, mask_bias, num_heads, scale)
    _on_card("fused_attention_qkv", qkv)
    check_qkv_args(qkv, mask_bias, num_heads)
    lib = _cuda.library("encoder_layer", _SIGNATURES)
    b, s, h3 = qkv.shape
    qkv = _cuda.aligned(qkv)
    mask = _cuda.aligned(mask_bias.float())
    ctx = torch.empty((b, s, h3 // 3), dtype=qkv.dtype, device=qkv.device)
    err = _cuda.launch(
        lib.sema_attention_qkv, qkv.device,
        qkv.data_ptr(), mask.data_ptr(), ctx.data_ptr(), b, s, h3 // 3,
        num_heads, DTYPE_CODES[qkv.dtype], scale)
    _cuda.check(lib, err, "fused_attention_qkv")
    fused_attention_qkv.launches += 1
    return ctx


def fused_attention_block(x: torch.Tensor, qkv_w: torch.Tensor,
                          qkv_b: torch.Tensor, mask_bias: torch.Tensor,
                          num_heads: int, scale: float) -> torch.Tensor:
    """K6: x (B, S, H), qkv_w (H, 3·H_out), qkv_b (3·H_out,) → (B, S,
    H_out) context (see the module docstring). The weight and bias are
    rounded to x's dtype. CPU tensors run the plain version; CUDA tensors
    launch the kernels or raise."""
    if x.device.type == "cpu":
        return attention_block_reference(x, qkv_w, qkv_b, mask_bias,
                                         num_heads, scale)
    _on_card("fused_attention_block", x)
    check_block_args(x, qkv_w, qkv_b, mask_bias, num_heads)
    lib = _cuda.library("encoder_layer", _SIGNATURES)
    b, s, h = x.shape
    h3 = qkv_w.shape[-1]
    dt = x.dtype
    x = _cuda.aligned(x)
    w = _cuda.aligned(qkv_w.to(dt))
    bias = _cuda.aligned(qkv_b.to(dt))
    mask = _cuda.aligned(mask_bias.float())
    qkv = torch.empty((b * s, h3), dtype=dt, device=x.device)
    ctx = torch.empty((b, s, h3 // 3), dtype=dt, device=x.device)
    err = _cuda.launch(
        lib.sema_attention_block, x.device,
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), mask.data_ptr(),
        qkv.data_ptr(), ctx.data_ptr(), b, s, h, h3 // 3, num_heads,
        DTYPE_CODES[dt], scale)
    _cuda.check(lib, err, "fused_attention_block")
    fused_attention_block.launches += 1
    return ctx


fused_attention_qkv.launches = 0
fused_attention_block.launches = 0
