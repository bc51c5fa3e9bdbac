"""One post-LN BERT encoder layer with W8A8 linears (K5 of the port).

Replaces the TPU kernel ``sema_tpu/ops/fused_attention.py:
fused_encoder_layer_int8`` (``_encoder_layer_kernel_int8`` with ``_qmm``).
On a CUDA tensor :func:`fused_encoder_layer_int8` launches the int8 route
of ``csrc/encoder_layer.cu`` (eight launches on the current stream: three
row quantizations, four int8 GEMMs with K2's epilogues, K2's attention;
seven where the caller hands it x's int8 rows, ``x_rows``, which the
layer before wrote beside its output, ``out_rows``);
on a CPU tensor it runs :func:`encoder_layer_int8_reference`, the plain
PyTorch version. There is no other path.

Contract (``fused_attention.py:372-440``): ``x`` (B, S, H) in the compute
dtype; ``layer`` the quantized per-layer dict of ``models/bert.py``
(``{name}_q`` int8 (in, out) and ``{name}_s`` f32 (out,) for the four
linears; biases in the compute dtype, LayerNorm params f32); ``mask_bias``
(B, S) f32. Each product is :func:`qmm`: the activation rows quantized per
row, ``sx = max(max|x|, 1e-8) / 127`` and ``round_half_even(x / sx)``
clipped to +-127, an i32 dot with the int8 weights, then ``f32(acc) * sx *
ws``. Around the products the rounding sequence is K2's: for qkv the f32
bias is added before the one rounding to the compute dtype; the other
three round the product to ``acc`` (bf16 in bf16, else f32) and add the
bias there. Attention stays full precision, as in K2.

The kernel reads each int8 weight as (out, in) rows, K-contiguous per
output column: :func:`column_major` lays a ``{name}_q`` out so once (the
``Encoder`` does at load) and the wrapper then passes it without a copy.
The plain version's i32 dot is an f64 product of the int8 values, exact
for the sums of at most 4,096 products these widths give, so the product
alone is bit-equal between the two (``chip_smoke.py`` holds it so).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sema_tpu_torch.ops import _cuda
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.encoder_layer import (_DTYPE_CODES, _LN,
                                              LayerOperands, _check,
                                              _check_leaves, _check_operands,
                                              gather_operands, in_dtype,
                                              layer_with_products, scratch)
from sema_tpu_torch.ops.quant import div127

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sema_encoder_layer_int8": (
        [_P] * 29              # x, 16 params, mask, 5 outs, 6 scratch
        + [_I] * 6             # B, S, H, I, heads, dtype
        + [_F, _F, _P, _I]),   # scale, eps, stream, card
    "sema_encoder_layer_int8_rows": (
        [_P] * 33              # as above, then x's and out's int8 rows
        + [_I] * 6             # and scales
        + [_F, _F, _P, _I]),
    "sema_qmm": [_P] * 6 + [_I] * 4 + [_P, _I],
}
LINEARS = ("qkv_w", "attn_out_w", "ffn_in_w", "ffn_out_w")


def quantize_rows(x: torch.Tensor) -> tuple:
    """K5's row quantization of (..., K) activations: (int8 values, f32
    scales (...,)), ``sx = max(max|x|, 1e-8) / 127`` and
    ``round_half_even(x / sx)`` clipped to +-127."""
    xf = x.float()
    sx = div127(xf.abs().amax(-1, keepdim=True).clamp(min=1e-8))
    xq = torch.round(xf / sx).clamp(-127.0, 127.0)
    return xq.to(torch.int8), sx.squeeze(-1)


def qmm_rows(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
             ws: torch.Tensor) -> torch.Tensor:
    """The product of rows already quantized (:func:`quantize_rows`'s
    pair) with (K, N) int8 weights and (N,) f32 scales → (..., N) f32."""
    acc = xq.double() @ wq.double()      # exact: integers below 2^53
    return acc.float() * sx.unsqueeze(-1) * ws


def qmm_reference(x: torch.Tensor, wq: torch.Tensor,
                  ws: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`qmm`: (..., K) activations, (K, N) int8
    weights, (N,) f32 scales → (..., N) f32."""
    return qmm_rows(*quantize_rows(x), wq, ws)


def column_major(wq: torch.Tensor) -> torch.Tensor:
    """``wq`` (..., in, out) with its values laid out (..., out, in): the
    same tensor to every reader, each output column's weights contiguous
    for the kernel."""
    return wq.transpose(-1, -2).contiguous().transpose(-1, -2)


def _rows(wq: torch.Tensor) -> torch.Tensor:
    """The (out, in) int8 rows the kernel reads: a view when ``wq`` is
    already :func:`column_major`, else a copy."""
    return _cuda.aligned(wq.t())


def qmm(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """K5's product alone: the row quantization, the int8 GEMM and the
    rescale, (M, K) bf16/f16/f32 ``x`` → (M, N) f32. CPU tensors run the
    plain version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return qmm_reference(x, wq, ws)
    m, k = x.shape
    n = wq.shape[1]
    if (x.dtype not in _DTYPE_CODES or k % 64 or n % 8
            or wq.shape != (k, n) or wq.dtype != torch.int8
            or ws.shape != (n,) or ws.dtype != torch.float32
            or not x.device == wq.device == ws.device):
        raise KernelError(f"qmm takes (M, K) bf16/f16/f32 x with K a "
                          f"multiple of 64, (K, N) int8 weights and (N,) "
                          f"f32 scales on one card; got {tuple(x.shape)} "
                          f"{x.dtype}, {tuple(wq.shape)} {wq.dtype}, "
                          f"{tuple(ws.shape)} {ws.dtype}")
    lib = _cuda.library("encoder_layer", _SIGNATURES)
    x = _cuda.aligned(x)
    rows = _rows(wq)
    ws = _cuda.aligned(ws)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = _cuda.launch(lib.sema_qmm, x.device, x.data_ptr(), rows.data_ptr(),
                       ws.data_ptr(), xq.data_ptr(), sx.data_ptr(),
                       out.data_ptr(), m, k, n, _DTYPE_CODES[x.dtype])
    _cuda.check(lib, err, "qmm")
    return out


def encoder_layer_int8_reference(x: torch.Tensor, layer: dict,
                                 mask_bias: torch.Tensor, num_heads: int,
                                 scale: float, ln_eps: float,
                                 operands=None, x_rows=None,
                                 out_rows=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_encoder_layer_int8`
    (``operands``, the kernels' gathered leaves, is not used): with
    ``x_rows`` the qkv product takes them for x's quantization, and
    ``out_rows`` receive the output's."""
    def mm(a, name):
        if name == "qkv_w" and x_rows is not None:
            return qmm_rows(x_rows[0].reshape(a.shape),
                            x_rows[1].reshape(a.shape[:-1]),
                            layer[name + "_q"], layer[name + "_s"])
        return qmm_reference(a, layer[name + "_q"], layer[name + "_s"])

    out = layer_with_products(x, layer, mask_bias, num_heads, scale,
                              ln_eps, mm)
    if out_rows is not None:
        q, sx = quantize_rows(out)
        out_rows[0].copy_(q.reshape(out_rows[0].shape))
        out_rows[1].copy_(sx.reshape(out_rows[1].shape))
    return out


def row_buffers(x: torch.Tensor) -> tuple:
    """A pair of buffers for a (B, S, H) activation's int8 rows (B*S, H)
    and f32 scales (B*S,), on x's device: what :func:`fused_encoder_layer_int8`
    takes as ``x_rows`` and ``out_rows``."""
    m, h = x.shape[0] * x.shape[1], x.shape[2]
    return (torch.empty((m, h), dtype=torch.int8, device=x.device),
            torch.empty((m,), dtype=torch.float32, device=x.device))


# K5's leaves in the order sema_encoder_layer_int8 takes them
_OPERANDS = ("qkv_w_q", "qkv_w_s", "qkv_b", "attn_out_w_q", "attn_out_w_s",
             "attn_out_b", *_LN[:2], "ffn_in_w_q", "ffn_in_w_s", "ffn_in_b",
             "ffn_out_w_q", "ffn_out_w_s", "ffn_out_b", *_LN[2:])


def _prepare(dtype):
    def prepare(name, t):
        if name.endswith("_q"):
            return _rows(t)
        if name.endswith("_s"):
            return _cuda.aligned(t)
        return in_dtype(t, torch.float32 if name in _LN else dtype)
    return prepare


def layer_operands(layer: dict, dtype) -> LayerOperands:
    """K5's operands of ``layer`` in compute dtype ``dtype``, every leaf
    checked (as ``encoder_layer.layer_operands`` makes K2's)."""
    h, inter = layer["attn_ln_scale"].shape[0], layer["ffn_in_w_q"].shape[-1]
    _check_leaves(layer, h, inter, layer["qkv_w_q"].device, True)
    return gather_operands(layer, _OPERANDS, _prepare(dtype), dtype, True)


def _check_rows(rows, x, what) -> None:
    if rows is None:
        return
    m, h = x.shape[0] * x.shape[1], x.shape[2]
    q, sx = rows
    if (q.shape != (m, h) or q.dtype != torch.int8 or sx.shape != (m,)
            or sx.dtype != torch.float32 or not q.is_contiguous()
            or not sx.is_contiguous() or q.device != x.device
            or sx.device != x.device or q.data_ptr() % 16):
        raise KernelError(f"{what} takes ({m}, {h}) contiguous int8 rows "
                          f"and ({m},) f32 scales on {x.device} "
                          f"(row_buffers); got {tuple(q.shape)} {q.dtype} "
                          f"on {q.device}, {tuple(sx.shape)} {sx.dtype}")


def fused_encoder_layer_int8(x: torch.Tensor, layer: dict,
                             mask_bias: torch.Tensor, num_heads: int,
                             scale: float, ln_eps: float,
                             operands: Optional[LayerOperands] = None,
                             x_rows: Optional[tuple] = None,
                             out_rows: Optional[tuple] = None
                             ) -> torch.Tensor:
    """One post-LN BERT layer with W8A8 linears (see the module
    docstring). CPU tensors run the plain version; CUDA tensors launch the
    kernels or raise. ``operands``: :func:`layer_operands` of ``layer``,
    if the caller keeps them. ``x_rows``: x's int8 rows and scales
    (:func:`row_buffers`), as the layer before wrote them into its
    ``out_rows``; the layer then skips x's quantization. ``out_rows``:
    where the layer also writes its output's (the LayerNorm quantizes the
    rows it stores); they may be ``x_rows`` themselves."""
    _check_rows(x_rows, x, "x_rows")
    _check_rows(out_rows, x, "out_rows")
    if x.device.type == "cpu":
        return encoder_layer_int8_reference(x, layer, mask_bias, num_heads,
                                            scale, ln_eps, x_rows=x_rows,
                                            out_rows=out_rows)
    if operands is None:
        _check(x, layer, mask_bias, num_heads, quantized=True)
    else:
        _check_operands(x, mask_bias, num_heads, operands, True)
    lib = _cuda.library("encoder_layer", _SIGNATURES)
    if operands is None:
        operands = gather_operands(layer, _OPERANDS, _prepare(x.dtype),
                                   x.dtype, True)
    b, s, h = x.shape
    inter, dt, dev = operands.inter, x.dtype, x.device
    m, isz = b * s, x.element_size()
    # x, the mask and every operand stay referenced until the launch: a
    # copy freed before it could hand its memory to the scratch below
    x_ = _cuda.aligned(x)
    mask = in_dtype(mask_bias, torch.float32)
    out = torch.empty((b, s, h), dtype=dt, device=dev)
    buf, (qkv, ctx, h1, up, qa, sa, qh, sh, qu, su) = scratch(dev, (
        m * 3 * h * isz, m * h * isz, m * h * isz, m * inter * isz,
        m * h, m * 4, m * h, m * 4, m * inter, m * 4))
    common = (x_.data_ptr(), *operands.ptrs, mask.data_ptr(), qkv, ctx,
              h1, up, out.data_ptr(), qa, sa, qh, sh, qu, su)
    shape = (b, s, h, inter, num_heads, _DTYPE_CODES[dt], scale, ln_eps)
    if x_rows is None and out_rows is None:
        err = _cuda.launch(lib.sema_encoder_layer_int8, dev, *common, *shape)
    else:
        ptr = lambda rows, i: None if rows is None else rows[i].data_ptr()
        err = _cuda.launch(lib.sema_encoder_layer_int8_rows, dev, *common,
                           ptr(x_rows, 0), ptr(x_rows, 1), ptr(out_rows, 0),
                           ptr(out_rows, 1), *shape)
    _cuda.check(lib, err, "fused_encoder_layer_int8")
    fused_encoder_layer_int8.launches += 1
    return out


fused_encoder_layer_int8.launches = 0
