"""Tensor parallelism for the larger encoders (from ``sema_tpu/models/tp.py``).

Megatron-style sharding over the ``model`` axis of a
:class:`~sema_tpu_torch.parallel.mesh.Mesh`: column-parallel projections
(qkv, FFN-in) shard their output features, row-parallel ones (attn-out,
FFN-out) their input features, and ``bert.encoder_layer_tp`` sums the
row-parallel partials over the shards after each of them. LayerNorm,
bias-of-row-parallel and embedding leaves are replicated.

The JAX package places one sharded array per leaf (``NamedSharding``) and
runs the per-chip body under ``shard_map``. The port's process drives every
shard itself, so :func:`shard_params_tp` returns one per-layer-stacked
tree per device of the mesh, holding the shard of that device's model
index, on that device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sema_tpu_torch.ops.encoder_layer_int8 import column_major

# column-parallel: output features sharded; row-parallel: input features
_COLUMN = ("qkv", "ffn_in")
_ROW = ("attn_out", "ffn_out")


def tp_param_specs() -> Dict[str, Dict[str, Optional[int]]]:
    """The sharded dim of every leaf (None: replicated), layer-stacked
    leaves leading with L (``tp.py:30-64``). The quantized weight shards
    with its per-output-channel scales; the scales of a row-parallel
    projection index its output, which stays whole, so they replicate."""
    layers: Dict[str, Optional[int]] = {}
    for p in _COLUMN:
        layers.update({f"{p}_w": 2, f"{p}_w_q": 2, f"{p}_w_s": 1,
                       f"{p}_b": 1})
    for p in _ROW:
        layers.update({f"{p}_w": 1, f"{p}_w_q": 1, f"{p}_w_s": None,
                       f"{p}_b": None})
    for ln in ("attn_ln_scale", "attn_ln_bias", "ffn_ln_scale",
               "ffn_ln_bias"):
        layers[ln] = None
    return {"embeddings": dict.fromkeys(
                ("word", "position", "token_type", "ln_scale", "ln_bias")),
            "layers": layers}


def permute_qkv_heads(params, tp: int):
    """Reorder the fused qkv projection's output columns so that a
    contiguous 1/tp column shard holds exactly [q|k|v] of a contiguous
    block of heads (``tp.py:75-104``): for shard c, q[c·hl:(c+1)·hl] |
    k[...] | v[...] with hl = H / tp. The quantized twins' columns and
    per-column scales move with them. Numerics unchanged."""
    layers = dict(params["layers"])
    some_w = layers.get("qkv_w", layers.get("qkv_w_q"))
    h = some_w.shape[-1] // 3
    if h % tp:
        raise ValueError(
            f"hidden size {h} not divisible by tensor-parallel degree {tp}")
    hl = h // tp
    perm = [third * h + c * hl + i for c in range(tp) for third in range(3)
            for i in range(hl)]
    for name in ("qkv_w", "qkv_w_q", "qkv_b", "qkv_w_s"):
        if name in layers:
            leaf = layers[name]
            layers[name] = leaf[..., torch.as_tensor(perm,
                                                     device=leaf.device)]
    return {**params, "layers": layers}


def _shard(name: str, leaf: torch.Tensor, dim: Optional[int], index: int,
           tp: int, device: torch.device) -> torch.Tensor:
    """Shard ``index`` of ``tp`` of ``leaf`` along ``dim`` (the whole leaf
    for None), on ``device``, contiguous; an int8 weight laid out as
    :func:`column_major` for ``qmm``."""
    if dim is not None:
        if leaf.shape[dim] % tp:
            raise ValueError(f"{name}: dim {dim} of {tuple(leaf.shape)} "
                             f"does not split {tp} ways")
        size = leaf.shape[dim] // tp
        leaf = leaf.narrow(dim, index * size, size)
    leaf = leaf.to(device)
    if name.endswith("_w_q"):
        return column_major(leaf)
    return leaf if dim is None else leaf.contiguous()


def shard_params_tp(params, mesh, model_axis: str = "model") -> np.ndarray:
    """One tree per device of ``mesh`` (an object ndarray of its shape):
    the shard of the device's index along ``model_axis``, placed on it,
    after the qkv columns are permuted to head-contiguous shards. Devices
    that repeat with one model index share a tree."""
    tp = mesh.shape[model_axis]
    params = permute_qkv_heads(params, tp)
    specs = tp_param_specs()
    axis = mesh.axis_names.index(model_axis)
    out = np.empty(mesh.devices.shape, dtype=object)
    placed: dict = {}
    for idx in np.ndindex(*mesh.devices.shape):
        device, m = mesh.devices[idx], idx[axis]
        key = (str(device), m)
        if key not in placed:
            placed[key] = {
                group: {name: _shard(name, leaf, specs[group][name], m, tp,
                                     device)
                        for name, leaf in params[group].items()}
                for group in ("embeddings", "layers")}
        out[idx] = placed[key]
    return out
