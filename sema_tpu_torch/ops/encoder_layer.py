"""One post-LN BERT encoder layer (K2 of the port).

Replaces the TPU kernel ``sema_tpu/ops/fused_attention.py:
fused_encoder_layer`` (``_encoder_layer_kernel``). On a CUDA tensor
:func:`fused_encoder_layer` launches the Hopper kernels of
``csrc/encoder_layer.cu`` (five launches on the current stream: qkv GEMM,
attention, out-proj GEMM + LN1, FFN-in GEMM + GELU, FFN-out GEMM + LN2);
on a CPU tensor it runs :func:`encoder_layer_reference`, the plain
PyTorch version. There is no other path.

Contract (``fused_attention.py:313-369``): ``x`` (B, S, H) in the compute
dtype; ``layer`` the per-layer param dict of ``models/bert.py`` (weights
cast to x's dtype, LayerNorm params f32); ``mask_bias`` (B, S) f32,
0 where attended and -1e9 where padded. The rounding sequence is the TPU
kernel's (``fused_attention.py:269-307``): in bf16 the products round to
bf16 before their bias is added in bf16, the softmax runs in bf16 and
residuals and LayerNorm statistics stay f32; in f16 the biases add in f32
and a result rounds to f16 where it is stored (qkv, the out-projection,
the GELU output, the scores, the probabilities, the context, the LayerNorm
outputs); in f32 nothing rounds.

The CUDA kernels take bf16, f16 and f32 (every compute dtype of the JAX
package's ``Encoder``), head dims 32 and 64, H of 64 or a multiple of 128
up to 1,024 (:func:`ln_gemm_plan`) and any S >= 1; the wrapper raises
:class:`~sema_tpu_torch.ops._cuda.KernelError` on anything else. The W8A8
layer (K5) is ``ops/encoder_layer_int8.py``, on the same rounding sequence
(:func:`layer_with_products`).

The LayerNorm GEMMs (out-proj + LN1, FFN-out + LN2) of K2 and K5 run as
thread-block clusters: c = H / 128 blocks share each row block, one
128-column slice each, and normalise whole rows through distributed
shared memory. :func:`ln_gemm_plan` mirrors the launch (cluster size,
rows a block, blocks, shared memory, slabs of K), as ``scan_topk.py:
chunk_plan`` mirrors K1's; the kernel's own plan is ``sema_gemm_plan``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from sema_tpu_torch.ops import _cuda
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.attention import DTYPE_CODES as _DTYPE_CODES
from sema_tpu_torch.ops.attention import heads_attention

_P = ctypes.c_void_p
_SIGNATURES = {"sema_encoder_layer": (
    [_P] * 19                  # x, 12 params, mask, 5 outs
    + [ctypes.c_int] * 6       # B, S, H, I, heads, dtype
    + [ctypes.c_float, ctypes.c_float, _P])}      # scale, eps, stream
_LN = ("attn_ln_scale", "attn_ln_bias", "ffn_ln_scale", "ffn_ln_bias")

# the GEMMs' tiles and plan, as csrc/encoder_layer.cu has them
GEMM_THREADS = 256
BN, BK, BK8 = 128, 64, 128         # tile columns; K of a bf16/f16, int8 slab
A_STRIDE, B_STRIDE, S8_STRIDE = BK + 8, BN + 8, BK8 + 16
LN_SLICE = 128                      # columns of a LayerNorm GEMM block
MAX_CLUSTER = 8                     # the portable cluster size
FILL_BLOCKS = 256                   # blocks a grid reaches before BM shrinks


class LnGemmPlan(NamedTuple):
    """One LayerNorm GEMM launch: ``cluster`` blocks of ``slice`` columns
    each share each row block of ``bm`` rows, ``blocks`` in all, each with
    ``smem`` bytes of dynamic shared memory, streaming ``slabs`` slabs of
    K."""
    cluster: int
    slice: int
    bm: int
    blocks: int
    smem: int
    slabs: int


def gemm_stages(bm: int) -> int:
    """The cp.async stages of a GEMM block of ``bm`` rows."""
    return 5 if bm <= 16 else 4 if bm <= 32 else 3


@functools.lru_cache(maxsize=256)
def ln_gemm_plan(m: int, h: int, k: int,
                 quantized: bool) -> Optional[LnGemmPlan]:
    """The LayerNorm GEMM's launch for ``m`` rows of width ``h`` over K =
    ``k`` (the int8 GEMM of K5 if ``quantized``), or None where the kernel
    does not take ``h``. A cluster of c = h / 128 blocks (at most 8) shares
    each row block, one 128-column slice a block; an ``h`` under 128 is one
    block's narrower slice. BM is the largest of 64, 32 and 16 whose grid
    still has FILL_BLOCKS blocks (else 16): an index batch reuses each
    weight slab over 64 rows, one gte-large query (m = 256) runs 16 x 8 =
    128 blocks. Shared memory: the ring of slabs, which the block's f32
    slice of its rows and one row a warp for the LayerNorm take over once
    the products are done."""
    if h % LN_SLICE == 0 and 1 <= h // LN_SLICE <= MAX_CLUSTER:
        cluster, sw = h // LN_SLICE, LN_SLICE
    elif 0 < h < LN_SLICE and h % 8 == 0:
        cluster, sw = 1, h
    else:
        return None
    bm = 64
    while bm > 16 and -(-m // bm) * cluster < FILL_BLOCKS:
        bm //= 2
    stage = ((bm + BN) * S8_STRIDE if quantized
             else (bm * A_STRIDE + BK * B_STRIDE) * 2)
    ring = gemm_stages(bm) * stage
    ln_bytes = (bm * (sw + 8) + GEMM_THREADS // 32 * h) * 4
    slab = BK8 if quantized else BK
    return LnGemmPlan(cluster, sw, bm, -(-m // bm) * cluster,
                      max(ring, ln_bytes), -(-k // slab))


# K6's qkv GEMM on wgmma (``gemm_wgmma_kernel``), as csrc/encoder_layer.cu
# has it
WG_BM, WG_BK = 128, 64              # a tile's rows; K of a slab
WG_MIN_TILES = 128                  # tiles from which K6's plan takes wgmma
WG_CLUSTER = 2                      # row tiles of a cluster, sharing W's slabs
SMEM_MAX = 232_448                  # dynamic shared memory a block may use


class QkvGemmPlan(NamedTuple):
    """K6's qkv GEMM launch: ``route`` "wgmma" (the persistent TMA and
    wgmma kernel) or "ring" (K2's ring GEMM), tiles of ``bm`` x ``bn``, a
    ring of ``stages`` slabs of K, ``tiles`` tiles on ``grid`` blocks, each
    with ``smem`` bytes of dynamic shared memory."""
    route: str
    bm: int
    bn: int
    stages: int
    tiles: int
    grid: int
    smem: int


def wg_stages(bn: int) -> int:
    """The TMA stages of a wgmma GEMM block of tiles ``bn`` wide: as many
    as fit, beside the output tile's staging (128 x bn, 16-bit), in the 227
    KB a block may use: 3 of 48 KB at bn 256, 6 of 32 KB at bn 128."""
    return ((SMEM_MAX - 1024 - 128 - WG_BM * bn * 2)
            // ((WG_BM + bn) * WG_BK * 2))


@functools.lru_cache(maxsize=256)
def qkv_gemm_plan(m: int, n: int, k: int, clusters: int) -> QkvGemmPlan:
    """K6's qkv GEMM, (m, k) @ (k, n), on a card that holds ``clusters``
    clusters of the wgmma kernel at once: the wgmma kernel where its tiles
    of 128 x bn, counted in whole clusters of WG_CLUSTER row tiles, number
    WG_MIN_TILES or more (one an SM) and n and k are multiples of 8 (TMA's
    row strides), with bn of 128 or 256, whichever pads n less (256 on a
    tie), on a persistent grid of min(cluster tiles, ``clusters``)
    clusters; else K2's ring GEMM (``gemm_plan`` in the source): BM 64, or
    32 where 64 leaves the grid under FILL_BLOCKS blocks. One gte-large
    query at tp 2 (m = 256, n = 1,536) is 12 tiles: the ring."""
    bn = 128 if -(-n // 128) * 128 < -(-n // 256) * 256 else 256
    cluster_tiles = -(-m // (WG_CLUSTER * WG_BM)) * -(-n // bn)
    if (n % 8 == 0 and k % 8 == 0 and clusters > 0
            and cluster_tiles * WG_CLUSTER >= WG_MIN_TILES):
        stages = wg_stages(bn)
        smem = (stages * (WG_BM + bn) * WG_BK * 2 + WG_BM * bn * 2
                + 1024 + 128)
        return QkvGemmPlan("wgmma", WG_BM, bn, stages,
                           cluster_tiles * WG_CLUSTER,
                           min(cluster_tiles, clusters) * WG_CLUSTER, smem)
    cols = -(-n // BN)
    bm = 64 if -(-m // 64) * cols >= FILL_BLOCKS else 32
    blocks = -(-m // bm) * cols
    return QkvGemmPlan("ring", bm, BN, gemm_stages(bm), blocks, blocks,
                       gemm_stages(bm) * (bm * A_STRIDE + BK * B_STRIDE) * 2)


def layer_norm_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics; returns f32."""
    r = x.float()
    mean = r.mean(-1, keepdim=True)
    var = (r - mean).square().mean(-1, keepdim=True)
    return (r - mean) * torch.rsqrt(var + eps) * g.float() + b.float()


def encoder_layer_reference(x: torch.Tensor, layer: dict,
                            mask_bias: torch.Tensor, num_heads: int,
                            scale: float, ln_eps: float,
                            operands=None, softmax: str = "exp"
                            ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_encoder_layer`
    (``operands``, the kernels' gathered leaves, is not used). The
    product calls it with the default ``softmax``; the others are the
    plain versions of the ablated builds (``attention.SOFTMAXES``)."""
    dt = x.dtype

    def mm(a, name):                     # f32 accumulation of dt operands
        return a.float() @ layer[name].to(dt).float()

    return layer_with_products(x, layer, mask_bias, num_heads, scale,
                               ln_eps, mm, softmax)


def layer_with_products(x: torch.Tensor, layer: dict,
                        mask_bias: torch.Tensor, num_heads: int,
                        scale: float, ln_eps: float, mm,
                        softmax: str = "exp") -> torch.Tensor:
    """The layer's rounding sequence around its four products, each
    ``mm(rows, name)``: the f32 (rows, out) product of ``(rows, in)``
    activations in the compute dtype with the linear ``name``, and the
    attention's ``softmax`` (``attention.heads_attention``)."""
    b, s, h = x.shape
    dt = x.dtype
    f32 = torch.float32
    acc = dt if dt == torch.bfloat16 else f32

    def bias(name, d):                   # the bias rounded to dt, then d
        return layer[name].to(dt).to(d)

    xf = x.reshape(b * s, h)
    qkv = (mm(xf, "qkv_w") + bias("qkv_b", f32)).to(dt)
    ctx = heads_attention(qkv.view(b, s, 3 * h), mask_bias, num_heads,
                          scale, softmax).reshape(b * s, h)

    attn = mm(ctx, "attn_out_w").to(acc)
    attn = (attn + bias("attn_out_b", acc)).to(dt)
    y = layer_norm_f32(xf.float() + attn.float(), layer["attn_ln_scale"],
                       layer["attn_ln_bias"], ln_eps).to(dt)
    up = mm(y, "ffn_in_w").to(acc)
    up = (up + bias("ffn_in_b", acc)).float()
    up = 0.5 * up * (1.0 + torch.erf(up * (2.0 ** -0.5)))
    down = mm(up.to(dt), "ffn_out_w").to(acc)
    down = down + bias("ffn_out_b", acc)
    out = layer_norm_f32(y.float() + down.float(), layer["ffn_ln_scale"],
                         layer["ffn_ln_bias"], ln_eps)
    return out.to(dt).reshape(b, s, h)


def _check(x, layer, mask_bias, num_heads, quantized=False):
    if x.device.type != "cuda":
        raise KernelError(f"fused_encoder_layer takes CPU or CUDA tensors, "
                          f"got {x.device}")
    _check_args(x, layer, mask_bias, num_heads, quantized)


@functools.lru_cache(maxsize=64)
def _leaf_specs(h: int, inter: int, quantized: bool) -> tuple:
    """(name, shape, dtype or None) of every leaf the layer kernels read,
    at width ``h`` and FFN width ``inter``: the float layer's (K2) or,
    ``quantized``, the int8 layer's (K5), whose linears are ``{name}_q``
    int8 (in, out) and ``{name}_s`` f32 (out,)."""
    linears = {"qkv_w": (h, 3 * h), "attn_out_w": (h, h),
               "ffn_in_w": (h, inter), "ffn_out_w": (inter, h)}
    specs = [("qkv_b", (3 * h,), None), ("attn_out_b", (h,), None),
             ("ffn_in_b", (inter,), None), ("ffn_out_b", (h,), None),
             *((n, (h,), None) for n in _LN)]
    for name, shape in linears.items():
        if quantized:
            specs += [(name + "_q", shape, torch.int8),
                      (name + "_s", shape[1:], torch.float32)]
        else:
            specs.append((name, shape, None))
    return tuple((n, torch.Size(shape), d) for n, shape, d in specs)


def _check_args(x, layer, mask_bias, num_heads, quantized=False):
    """Raise KernelError unless the CUDA kernels take these arguments: the
    float layer's (K2) or, ``quantized``, the int8 layer's (K5), whose
    linears are ``{name}_q`` int8 (in, out) and ``{name}_s`` f32 (out,)."""
    inter = layer["ffn_in_w_q" if quantized else "ffn_in_w"].shape[-1]
    _check_input(x, mask_bias, num_heads, inter, quantized)
    _check_leaves(layer, x.shape[-1], inter, x.device, quantized)


def _check_input(x, mask_bias, num_heads, inter, quantized):
    """The half of :func:`_check_args` that looks at the call's input and
    mask, for a layer of FFN width ``inter``."""
    if x.dtype not in _DTYPE_CODES:
        raise KernelError("the CUDA encoder layer takes bf16, f16 or f32, "
                          f"got {x.dtype}")
    if x.dim() != 3:
        raise KernelError(f"x must be (B, S, H), got {tuple(x.shape)}")
    b, s, h = x.shape
    if h % 64 or h % num_heads or h // num_heads not in (32, 64):
        raise KernelError(f"H={h} with {num_heads} heads: the kernel takes "
                          "H a multiple of 64 and head dim 32 or 64")
    if s < 1:
        raise KernelError(f"S={s}: the kernel takes S >= 1")
    if ln_gemm_plan(b * s, h, inter, quantized) is None:
        raise KernelError(f"H={h}: the LayerNorm GEMM takes H of 64 or a "
                          f"multiple of {LN_SLICE} up to "
                          f"{LN_SLICE * MAX_CLUSTER}")
    if inter % 64:
        raise KernelError(f"FFN width {inter} must be a multiple of 64")
    if mask_bias.shape != (b, s) or mask_bias.device != x.device:
        raise KernelError(f"mask_bias must be ({b}, {s}) on {x.device}")


def _check_leaves(layer, h, inter, device, quantized):
    """The half of :func:`_check_args` that looks at the layer's leaves."""
    for name, shape, dtype in _leaf_specs(h, inter, quantized):
        t = layer[name]
        if t.shape != shape or t.device != device:
            raise KernelError(f"layer[{name!r}] must be {tuple(shape)} on "
                              f"{device}, got {tuple(t.shape)} on "
                              f"{t.device}")
        if dtype is not None and t.dtype != dtype:
            raise KernelError(f"layer[{name!r}] must be int8 (values) or "
                              f"f32 (scales), got {t.dtype}")


class LayerOperands(NamedTuple):
    """A layer's parameters as a CUDA entry point reads them: the tensors
    (in the compute dtype, the LayerNorms in f32, contiguous and 16-byte
    aligned: copies where a leaf was not), their addresses in the entry
    point's order, and what they were made for."""
    tensors: tuple
    ptrs: tuple
    h: int
    inter: int
    dtype: torch.dtype
    device: torch.device
    quantized: bool


def gather_operands(layer, names, prepare, dtype, quantized):
    """:class:`LayerOperands` of ``layer``'s leaves ``names``, in that
    order, each through ``prepare(name, leaf)``; no check."""
    tensors = tuple(prepare(n, layer[n]) for n in names)
    inter = layer["ffn_in_w_q" if quantized else "ffn_in_w"].shape[-1]
    return LayerOperands(tensors, tuple(t.data_ptr() for t in tensors),
                         layer["attn_ln_scale"].shape[0], inter, dtype,
                         tensors[0].device, quantized)


def _check_operands(x, mask_bias, num_heads, operands, quantized):
    """:func:`_check` of a call whose leaves ``operands`` holds, checked
    when it was made."""
    if (operands.quantized != quantized or operands.dtype != x.dtype
            or operands.device != x.device or operands.h != x.shape[-1]):
        raise KernelError(f"operands made for H={operands.h} "
                          f"{operands.dtype} on {operands.device}, "
                          f"quantized={operands.quantized}; got x "
                          f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if x.device.type != "cuda":
        raise KernelError(f"fused_encoder_layer takes CPU or CUDA tensors, "
                          f"got {x.device}")
    _check_input(x, mask_bias, num_heads, operands.inter, quantized)


def scratch(device, sizes) -> tuple:
    """One uint8 buffer on ``device`` holding a region of each of
    ``sizes`` bytes, 256-byte aligned: (buffer, the regions' addresses).
    A layer's intermediates in one allocation, not one each: at one query
    the host's allocations cost more than the kernels that fill them."""
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    return buf, [buf.data_ptr() + o for o in offsets]


def in_dtype(t: torch.Tensor, dt) -> torch.Tensor:
    """``t`` in ``dt``, 16-byte aligned and contiguous: ``t`` itself when
    it already is (as the Encoder's cast params are), else a copy."""
    return _cuda.aligned(t if t.dtype == dt else t.to(dt))


# K2's leaves in the order sema_encoder_layer takes them
_OPERANDS = ("qkv_w", "qkv_b", "attn_out_w", "attn_out_b", *_LN[:2],
             "ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b", *_LN[2:])


def _prepare(dtype):
    return lambda name, t: in_dtype(t, torch.float32 if name in _LN
                                    else dtype)


def layer_operands(layer: dict, dtype) -> LayerOperands:
    """K2's operands of ``layer`` in compute dtype ``dtype``, every leaf
    checked: an Encoder makes them once per layer and hands them to each
    call (``operands=``), which then checks only its input; a query's 24
    layers would otherwise check and gather 12 leaves each on the host."""
    h, inter = layer["attn_ln_scale"].shape[0], layer["ffn_in_w"].shape[-1]
    _check_leaves(layer, h, inter, layer["qkv_w"].device, False)
    return gather_operands(layer, _OPERANDS, _prepare(dtype), dtype, False)


def fused_encoder_layer(x: torch.Tensor, layer: dict,
                        mask_bias: torch.Tensor, num_heads: int,
                        scale: float, ln_eps: float,
                        operands: Optional[LayerOperands] = None
                        ) -> torch.Tensor:
    """One post-LN BERT layer (see the module docstring). CPU tensors run
    the plain version; CUDA tensors launch the kernels or raise.
    ``operands``: :func:`layer_operands` of ``layer``, if the caller keeps
    them."""
    if x.device.type == "cpu":
        return encoder_layer_reference(x, layer, mask_bias, num_heads,
                                       scale, ln_eps)
    if operands is None:
        _check(x, layer, mask_bias, num_heads)
    else:
        _check_operands(x, mask_bias, num_heads, operands, False)
    lib = _cuda.library("encoder_layer", _SIGNATURES)
    if operands is None:
        operands = gather_operands(layer, _OPERANDS, _prepare(x.dtype),
                                   x.dtype, False)
    b, s, h = x.shape
    inter, dt = operands.inter, x.dtype
    m, isz = b * s, x.element_size()
    # x, the mask and every operand stay referenced until the launch: a
    # copy freed before it could hand its memory to the scratch below
    x_ = _cuda.aligned(x)
    mask = in_dtype(mask_bias, torch.float32)
    out = torch.empty((b, s, h), dtype=dt, device=x.device)
    buf, (qkv, ctx, h1, up) = scratch(
        x.device, (m * 3 * h * isz, m * h * isz, m * h * isz,
                   m * inter * isz))
    err = _cuda.launch(
        lib.sema_encoder_layer, x.device, x_.data_ptr(), *operands.ptrs,
        mask.data_ptr(), qkv, ctx, h1, up, out.data_ptr(), b, s, h, inter,
        num_heads, _DTYPE_CODES[dt], scale, ln_eps)
    _cuda.check(lib, err, "fused_encoder_layer")
    fused_encoder_layer.launches += 1
    return out


fused_encoder_layer.launches = 0
