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
package's ``Encoder``), head dims 32 and 64, H a multiple of 64 and any
S >= 1; the wrapper raises :class:`~sema_tpu_torch.ops._cuda.KernelError`
on anything else. The W8A8 layer (K5) is ``ops/encoder_layer_int8.py``,
on the same rounding sequence (:func:`layer_with_products`).
"""

from __future__ import annotations

import ctypes

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
_WEIGHTS = ("qkv_w", "attn_out_w", "ffn_in_w", "ffn_out_w")
_BIASES = ("qkv_b", "attn_out_b", "ffn_in_b", "ffn_out_b")
_LN = ("attn_ln_scale", "attn_ln_bias", "ffn_ln_scale", "ffn_ln_bias")


def layer_norm_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics; returns f32."""
    r = x.float()
    mean = r.mean(-1, keepdim=True)
    var = (r - mean).square().mean(-1, keepdim=True)
    return (r - mean) * torch.rsqrt(var + eps) * g.float() + b.float()


def encoder_layer_reference(x: torch.Tensor, layer: dict,
                            mask_bias: torch.Tensor, num_heads: int,
                            scale: float, ln_eps: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_encoder_layer`."""
    dt = x.dtype

    def mm(a, name):                     # f32 accumulation of dt operands
        return a.float() @ layer[name].to(dt).float()

    return layer_with_products(x, layer, mask_bias, num_heads, scale,
                               ln_eps, mm)


def layer_with_products(x: torch.Tensor, layer: dict,
                        mask_bias: torch.Tensor, num_heads: int,
                        scale: float, ln_eps: float, mm) -> torch.Tensor:
    """The layer's rounding sequence around its four products, each
    ``mm(rows, name)``: the f32 (rows, out) product of ``(rows, in)``
    activations in the compute dtype with the linear ``name``."""
    b, s, h = x.shape
    dt = x.dtype
    f32 = torch.float32
    acc = dt if dt == torch.bfloat16 else f32

    def bias(name, d):                   # the bias rounded to dt, then d
        return layer[name].to(dt).to(d)

    xf = x.reshape(b * s, h)
    qkv = (mm(xf, "qkv_w") + bias("qkv_b", f32)).to(dt)
    ctx = heads_attention(qkv.view(b, s, 3 * h), mask_bias, num_heads,
                          scale).reshape(b * s, h)

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


def _check_args(x, layer, mask_bias, num_heads, quantized=False):
    """Raise KernelError unless the CUDA kernels take these arguments: the
    float layer's (K2) or, ``quantized``, the int8 layer's (K5), whose
    linears are ``{name}_q`` int8 (in, out) and ``{name}_s`` f32 (out,)."""
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
    inter = layer["ffn_in_w_q" if quantized else "ffn_in_w"].shape[-1]
    linears = {"qkv_w": (h, 3 * h), "attn_out_w": (h, h),
               "ffn_in_w": (h, inter), "ffn_out_w": (inter, h)}
    shapes = {"qkv_b": (3 * h,), "attn_out_b": (h,), "ffn_in_b": (inter,),
              "ffn_out_b": (h,), **{n: (h,) for n in _LN}}
    for name, shape in linears.items():
        if quantized:
            shapes[name + "_q"] = shape
            shapes[name + "_s"] = shape[1:]
        else:
            shapes[name] = shape
    for name, shape in shapes.items():
        t = layer[name]
        if tuple(t.shape) != shape or t.device != x.device:
            raise KernelError(f"layer[{name!r}] must be {shape} on "
                              f"{x.device}, got {tuple(t.shape)} on "
                              f"{t.device}")
        if quantized and name.endswith(("_q", "_s")) and t.dtype != (
                torch.int8 if name.endswith("_q") else torch.float32):
            raise KernelError(f"layer[{name!r}] must be int8 (values) or "
                              f"f32 (scales), got {t.dtype}")
    if inter % 64:
        raise KernelError(f"FFN width {inter} must be a multiple of 64")
    if mask_bias.shape != (b, s) or mask_bias.device != x.device:
        raise KernelError(f"mask_bias must be ({b}, {s}) on {x.device}")


def fused_encoder_layer(x: torch.Tensor, layer: dict,
                        mask_bias: torch.Tensor, num_heads: int,
                        scale: float, ln_eps: float) -> torch.Tensor:
    """One post-LN BERT layer (see the module docstring). CPU tensors run
    the plain version; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return encoder_layer_reference(x, layer, mask_bias, num_heads,
                                       scale, ln_eps)
    _check(x, layer, mask_bias, num_heads)
    lib = _cuda.library("encoder_layer", _SIGNATURES)
    b, s, h = x.shape
    inter = layer["ffn_in_w"].shape[-1]
    dt = x.dtype
    x = _cuda.aligned(x)
    weights = [_cuda.aligned(layer[n].to(dt)) for n in _WEIGHTS]
    biases = [_cuda.aligned(layer[n].to(dt)) for n in _BIASES]
    lns = [_cuda.aligned(layer[n].float()) for n in _LN]
    mask = _cuda.aligned(mask_bias.float())
    m = b * s
    qkv = torch.empty((m, 3 * h), dtype=dt, device=x.device)
    ctx = torch.empty((m, h), dtype=dt, device=x.device)
    h1 = torch.empty((m, h), dtype=dt, device=x.device)
    up = torch.empty((m, inter), dtype=dt, device=x.device)
    out = torch.empty((b, s, h), dtype=dt, device=x.device)
    ptr = lambda t: t.data_ptr()
    err = _cuda.launch(
        lib.sema_encoder_layer, x.device,
        ptr(x), ptr(weights[0]), ptr(biases[0]), ptr(weights[1]),
        ptr(biases[1]), ptr(lns[0]), ptr(lns[1]), ptr(weights[2]),
        ptr(biases[2]), ptr(weights[3]), ptr(biases[3]), ptr(lns[2]),
        ptr(lns[3]), ptr(mask), ptr(qkv), ptr(ctx), ptr(h1), ptr(up),
        ptr(out), b, s, h, inter, num_heads, _DTYPE_CODES[dt], scale, ln_eps)
    _cuda.check(lib, err, "fused_encoder_layer")
    fused_encoder_layer.launches += 1
    return out


fused_encoder_layer.launches = 0
