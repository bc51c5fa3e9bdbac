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

Parameter tree: see :mod:`sema_tpu_torch.models.loader`.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from sema_tpu_torch.models.registry import EncoderSpec
from sema_tpu_torch.ops.encoder_layer import (fused_encoder_layer,
                                              layer_norm_f32)
from sema_tpu_torch.ops.encoder_layer_int8 import (LINEARS, column_major,
                                                   fused_encoder_layer_int8)
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


def cast_params(params: Params, compute_dtype) -> Params:
    """``params`` with the word table and each layer's weights and biases
    rounded to the compute dtype once, as every forward would round them;
    the position and token-type tables and the LayerNorm parameters stay
    as they are."""
    emb = dict(params["embeddings"])
    emb["word"] = emb["word"].to(compute_dtype)
    layers = {name: leaf.to(compute_dtype) if name in _CAST_LEAVES else leaf
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


def bert_forward(params: Params, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor, spec: EncoderSpec,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """Token-level hidden states (batch, seq, hidden)."""
    x = _embed_tokens(params["embeddings"], input_ids, compute_dtype)
    # additive mask: 0 where attended, -1e9 (f32) where padded
    mask_bias = (1.0 - attention_mask.float()) * -1e9
    layers = params["layers"]
    scale = 1.0 / math.sqrt(spec.hidden_size // spec.num_heads)
    fused = (fused_encoder_layer_int8 if "qkv_w_q" in layers
             else fused_encoder_layer)
    for i in range(spec.num_layers):
        layer = {name: leaf[i] for name, leaf in layers.items()}
        x = fused(x, layer, mask_bias, spec.num_heads, scale, LN_EPS)
    return x


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
          compute_dtype=torch.float32) -> torch.Tensor:
    """Full sentence-embedding forward: encoder → pooling → L2.
    (batch, dim) f32."""
    hidden = bert_forward(params, input_ids, attention_mask, spec,
                          compute_dtype)
    if spec.pooling == "cls":
        return cls_pool_normalize(hidden, attention_mask)
    return mean_pool_normalize(hidden, attention_mask)
