"""Functional BERT encoder forward in PyTorch (from ``sema_tpu/models/bert.py``).

Post-LN residual blocks, exact-erf GELU, learned position embeddings,
additive attention mask, masked-mean or [CLS] pooling + L2 — the
semantics of HF ``BertModel`` as the JAX package computes them.

Every layer goes through :func:`sema_tpu_torch.ops.fused_encoder_layer`
or, when the params carry W8A8 linears (:func:`quantize_params_int8`),
:func:`sema_tpu_torch.ops.fused_encoder_layer_int8`: on the card the
Hopper kernels (K2, K5) for every layer of every bucket, as the JAX
package runs its fused kernels on the TPU (``bert.py:268-296``); on the
CPU their plain versions. The JAX package's TPU-only dispatch
(``resolve_attn_impl``, the ``SEMA_TPU_FUSED_MIN_S`` floor and the VMEM
gate of ``bert.py:51-63, 256-281``) has no counterpart here. Its
``_int8_matmul`` is :func:`sema_tpu_torch.ops.encoder_layer_int8.
qmm_reference` (the same numerics; the port has no unfused int8 path).

The tensor-parallel forward (:func:`embed_tp`, :func:`encoder_layer_tp`)
runs each layer over the shards of ``models/tp.py``, one process driving
every shard: the local attention through K6 (``fused_attention_block``)
at S >= 192 with float qkv weights and through the qkv product and K7
(``fused_attention_qkv``) otherwise, int8 layers included, as the JAX
package dispatches on its TPU (``attn_impl == "fused"``); the linears
around it are :func:`_linear`, and the all-reduce of JAX's ``psum`` is
:func:`psum`.

Parameter tree: see :mod:`sema_tpu_torch.models.loader`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from sema_tpu_torch.models.registry import EncoderSpec
from sema_tpu_torch.ops.attention import (fused_attention_block,
                                          fused_attention_qkv)
from sema_tpu_torch.ops.encoder_layer import fused_encoder_layer
from sema_tpu_torch.ops.encoder_layer import \
    layer_operands as layer_operands_float
from sema_tpu_torch.ops.encoder_layer import layer_norm_f32
from sema_tpu_torch.ops.encoder_layer_int8 import (LINEARS, column_major,
                                                   fused_encoder_layer_int8,
                                                   qmm, row_buffers)
from sema_tpu_torch.ops.encoder_layer_int8 import \
    layer_operands as layer_operands_int8
from sema_tpu_torch.ops.quant import div127

Params = Dict[str, Dict[str, torch.Tensor]]

LN_EPS = 1e-12  # BERT default


# the leaves the layer kernel reads in the compute dtype (never the int8
# values or f32 scales of a quantized linear)
_CAST_LEAVES = ("qkv_w", "qkv_b", "attn_out_w", "attn_out_b", "ffn_in_w",
                "ffn_in_b", "ffn_out_w", "ffn_out_b")


def quantize_params_int8(params: Params) -> Params:
    """Per-output-channel symmetric int8 of the four linears of every
    layer (``bert.py:66-91``): ``s = max(max|w| over in, 1e-12) / 127``,
    ``q = clip(round_half_even(w / s), -127, 127)`` in f32, as
    ``{name}_q`` (L, in, out) int8 and ``{name}_s`` (L, out) f32 in place
    of ``{name}``. Embeddings, biases and LayerNorms stay as they are.
    Quantize the params as loaded, before :func:`cast_params` rounds the
    weights to the compute dtype, as the JAX ``Encoder`` does."""
    layers = dict(params["layers"])
    for name in LINEARS:
        layers[name + "_q"], layers[name + "_s"] = quantize_linear(
            layers.pop(name))
    return {**params, "layers": layers}


def quantize_linear(w: torch.Tensor):
    """(..., in, out) weights → (int8 values of the same shape, (..., out)
    f32 scales), per output channel (see :func:`quantize_params_int8`)."""
    w = w.float()
    s = div127(w.abs().amax(dim=-2).clamp(min=1e-12))
    q = torch.round(w / s.unsqueeze(-2)).clamp(-127, 127)
    return q.to(torch.int8), s


def int8_kernel_layout(params: Params) -> Params:
    """``params`` with each ``{name}_q`` laid out as K5 reads it (see
    :func:`sema_tpu_torch.ops.encoder_layer_int8.column_major`); the same
    values under the same (L, in, out) shape."""
    layers = {name: column_major(leaf) if name.endswith("_w_q") else leaf
              for name, leaf in params["layers"].items()}
    return {**params, "layers": layers}


def cast_params(params: Params, compute_dtype, biases: bool = True) -> Params:
    """``params`` with the word table and each layer's weights and, with
    ``biases``, biases rounded to the compute dtype once, as every forward
    would round them; the position and token-type tables and the LayerNorm
    parameters stay as they are. The tensor-parallel layer adds two of its
    biases in f32 (:func:`encoder_layer_tp`), so its trees keep them."""
    emb = dict(params["embeddings"])
    emb["word"] = emb["word"].to(compute_dtype)
    cast = _CAST_LEAVES if biases else LINEARS
    layers = {name: leaf.to(compute_dtype) if name in cast else leaf
              for name, leaf in params["layers"].items()}
    return {"embeddings": emb, "layers": layers}


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics whatever the compute dtype."""
    return layer_norm_f32(x, scale, bias, LN_EPS).to(x.dtype)


def _embed_tokens(emb: Dict[str, torch.Tensor], input_ids: torch.Tensor,
                  compute_dtype) -> torch.Tensor:
    """Token embeddings + LN → (b, s, h) in the compute dtype. The word
    table is gathered at the compute dtype; token_type_ids are all zero,
    so row 0 broadcasts; positions past the table repeat row P-1 (the
    JAX gather clamps, ``bert.py:146-159``)."""
    seq = input_ids.shape[1]
    wt = emb["word"].to(compute_dtype)
    pos = emb["position"][:seq]
    if pos.shape[0] < seq:
        pos = torch.cat([pos, pos[-1:].expand(seq - pos.shape[0], -1)])
    pos_tt = pos.float() + emb["token_type"][0].float()
    x = wt[input_ids.long()] + pos_tt.to(compute_dtype)[None, :, :]
    return layer_norm(x, emb["ln_scale"], emb["ln_bias"])


def layer_views(params: Params) -> List[Dict[str, torch.Tensor]]:
    """Each layer's leaves, a dict of views into the stacked (L, ...)
    params: what :func:`bert_forward` hands the layer kernel. An
    ``Encoder`` makes them once; slicing 16 leaves again for each of
    gte-large's 24 layers costs the host more than a query's layers
    take on the card."""
    leaves = {name: leaf.unbind(0) for name, leaf in params["layers"].items()}
    return [dict(zip(leaves, layer)) for layer in zip(*leaves.values())]


def layer_operands(views: List[Dict[str, torch.Tensor]],
                   compute_dtype) -> list:
    """Each layer's operands as the layer kernel reads them
    (``ops.encoder_layer.layer_operands`` or its int8 counterpart), checked
    once, for a caller that runs the layers on the card many times."""
    make = (layer_operands_int8 if views and "qkv_w_q" in views[0]
            else layer_operands_float)
    return [make(layer, compute_dtype) for layer in views]


def bert_forward(params: Params, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, spec: EncoderSpec,
                 compute_dtype=torch.float32,
                 views: Optional[List[Dict[str, torch.Tensor]]] = None,
                 operands: Optional[list] = None) -> torch.Tensor:
    """Token-level hidden states (batch, seq, hidden). ``views``:
    :func:`layer_views` of ``params``, and ``operands``: their
    :func:`layer_operands`, each made once by the caller."""
    x = _embed_tokens(params["embeddings"], input_ids, compute_dtype)
    # additive mask: 0 where attended, -1e9 (f32) where padded
    mask_bias = (1.0 - attention_mask.float()) * -1e9
    scale = 1.0 / math.sqrt(spec.hidden_size // spec.num_heads)
    quantized = "qkv_w_q" in params["layers"]
    fused = fused_encoder_layer_int8 if quantized else fused_encoder_layer
    views = layer_views(params) if views is None else views
    layers = views[:spec.num_layers]
    # W8A8: each layer's LN2 also writes its output's int8 rows, which the
    # next layer takes for its x instead of quantizing x again; one pair of
    # buffers carries them (a layer reads them before it writes them)
    rows = row_buffers(x) if quantized and len(layers) > 1 else None
    for i, layer in enumerate(layers):
        extra = {} if operands is None else {"operands": operands[i]}
        if rows is not None:
            extra.update(x_rows=rows if i > 0 else None,
                         out_rows=rows if i + 1 < len(layers) else None)
        x = fused(x, layer, mask_bias, spec.num_heads, scale, LN_EPS, **extra)
    return x


def _linear(x: torch.Tensor, layer: dict, name: str, acc) -> torch.Tensor:
    """One linear of a tensor-parallel layer (``bert.py:108-116``): x
    (B, S, in) in the compute dtype → (B, S, out) in ``acc``. Float
    weights (in the compute dtype, ``cast_params``): the sums in f32, as
    JAX's ``preferred_element_type`` makes them, rounded to ``acc``. On
    the card a bf16 or f16 GEMM with f32 output (``out_dtype``), which
    accumulates and reduces in f32 whatever
    ``allow_bf16_reduced_precision_reduction`` says; on the CPU, which
    has no such GEMM, the f32 product of the same operands, whose
    products f32 holds exactly. W8A8 weights: K5's
    :func:`~sema_tpu_torch.ops.encoder_layer_int8.qmm`, with one
    activation scale per token of this shard's features."""
    b, s, k = x.shape
    x2 = x.reshape(b * s, k)
    wq = layer.get(name + "_q")
    if wq is not None:
        y = qmm(x2, wq, layer[name + "_s"])
    elif x.dtype == torch.float32:
        y = torch.mm(x2, layer[name])
    elif x.is_cuda:
        y = torch.mm(x2, layer[name], out_dtype=torch.float32)
    else:
        y = torch.mm(x2.float(), layer[name].float())
    return y.reshape(b, s, -1).to(acc)


def psum(parts):
    """The f32 sum of the shards' partials, in shard order, on the first
    shard's device; then one reference to it on every shard's device."""
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.to(total.device, torch.float32)
    return [total.to(p.device) for p in parts]


def encoder_layer_tp(xs, layers, mask_biases, num_heads: int, tp: int):
    """One post-LN BERT block over ``tp`` shards of heads
    (``bert.py:306-371``): per shard, ``xs[i]`` (B, S, H) the replicated
    layer input on the shard's device, ``layers[i]`` its local weights
    (head-contiguous qkv columns, contiguous FFN splits,
    ``models/tp.py``), ``mask_biases[i]`` the (B, S) f32 mask there.
    Local attention over heads/tp heads (K6 at S >= 192 with float qkv
    weights, else the qkv product and K7), partial out-projection, sum
    over the shards, residual + LN1, local FFN-in half, partial FFN-out,
    sum, residual + LN2. Returns the shards' outputs.

    Rounding as the JAX package's: products round to ``acc`` (bf16 in
    bf16, else f32) and take the bias there, but the row-parallel
    partials stay f32 through the sum, take the f32 bias and round to the
    compute dtype before the residual add."""
    b, s, h = xs[0].shape
    dt = xs[0].dtype
    f32 = torch.float32
    acc = dt if dt == torch.bfloat16 else f32
    n_local = num_heads // tp
    scale = 1.0 / math.sqrt(h // num_heads)
    ctxs = []
    for x, layer, mb in zip(xs, layers, mask_biases):
        if s >= 192 and "qkv_w" in layer:
            ctx = fused_attention_block(x, layer["qkv_w"], layer["qkv_b"],
                                        mb, n_local, scale)
        else:
            qkv = _linear(x, layer, "qkv_w", acc)
            qkv = (qkv + layer["qkv_b"].to(acc)).to(dt)
            ctx = fused_attention_qkv(qkv, mb, n_local, scale)
        ctxs.append(ctx)
    attn = psum([_linear(c, layer, "attn_out_w", f32)
                 for c, layer in zip(ctxs, layers)])
    xs = [layer_norm(x + (a + layer["attn_out_b"].float()).to(dt),
                     layer["attn_ln_scale"], layer["attn_ln_bias"])
          for x, a, layer in zip(xs, attn, layers)]
    downs = []
    for x, layer in zip(xs, layers):
        up = _linear(x, layer, "ffn_in_w", acc)
        up = (up + layer["ffn_in_b"].to(acc)).float()
        up = 0.5 * up * (1.0 + torch.erf(up * (2.0 ** -0.5)))
        downs.append(_linear(up.to(dt), layer, "ffn_out_w", f32))
    down = psum(downs)
    return [layer_norm(x + (d + layer["ffn_out_b"].float()).to(dt),
                       layer["ffn_ln_scale"], layer["ffn_ln_bias"])
            for x, d, layer in zip(xs, down, layers)]


def embed_tp(shards, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             spec: EncoderSpec, compute_dtype=torch.float32) -> torch.Tensor:
    """Tensor-parallel sentence embeddings (``bert.py:374-391``): one
    per-layer-stacked tree per model shard, each on its own device
    (``models/tp.py:shard_params_tp``). Embeddings, LayerNorms and
    pooling are replicated work, done on every shard as on every chip.
    (batch, dim) f32 on the first shard's device."""
    tp = len(shards)
    devices = [sh["embeddings"]["word"].device for sh in shards]
    ids = [input_ids.to(d) for d in devices]
    masks = [attention_mask.to(d) for d in devices]
    xs = [_embed_tokens(sh["embeddings"], i, compute_dtype)
          for sh, i in zip(shards, ids)]
    mask_biases = [(1.0 - m.float()) * -1e9 for m in masks]
    for i in range(spec.num_layers):
        layers = [{name: leaf[i] for name, leaf in sh["layers"].items()}
                  for sh in shards]
        xs = encoder_layer_tp(xs, layers, mask_biases, spec.num_heads, tp)
    if spec.pooling == "cls":
        return cls_pool_normalize(xs[0], masks[0])
    return mean_pool_normalize(xs[0], masks[0])


def mean_pool_normalize(hidden: torch.Tensor,
                        attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean pool + L2 normalize, always in f32."""
    h = hidden.float()
    m = attention_mask.float()[..., None]
    summed = (h * m).sum(-2)
    mask_sum = m.sum(-2)
    pooled = torch.where(mask_sum > 0,
                         summed / torch.clamp(mask_sum, min=1e-9), summed)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return torch.where(norm > 0, pooled / torch.clamp(norm, min=1e-12),
                       pooled)


def cls_pool_normalize(hidden: torch.Tensor,
                       attention_mask: torch.Tensor) -> torch.Tensor:
    """[CLS] pooling + L2 normalize (bge-family convention), f32."""
    pooled = hidden[..., 0, :].float()
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return torch.where(norm > 0, pooled / torch.clamp(norm, min=1e-12),
                       pooled)


def embed(params: Params, input_ids: torch.Tensor,
          attention_mask: torch.Tensor, spec: EncoderSpec,
          compute_dtype=torch.float32,
          views: Optional[List[Dict[str, torch.Tensor]]] = None,
          operands: Optional[list] = None) -> torch.Tensor:
    """Full sentence-embedding forward: encoder → pooling → L2.
    (batch, dim) f32."""
    hidden = bert_forward(params, input_ids, attention_mask, spec,
                          compute_dtype, views, operands)
    if spec.pooling == "cls":
        return cls_pool_normalize(hidden, attention_mask)
    return mean_pool_normalize(hidden, attention_mask)
