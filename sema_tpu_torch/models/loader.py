"""Encoder weight loading for the port (from ``sema_tpu/models/loader.py``).

Sources, in priority order:

1. an explicit local directory containing ``model.safetensors`` or
   ``pytorch_model.bin`` (``model.weights_path`` / ``--weights``);
2. the local HF hub cache (``~/.cache/huggingface/hub``);
3. the port's own deterministic random initialization (trunc-normal
   σ=0.02 from a numpy ``Generator(seed)``). ``jax.random`` cannot be
   reproduced, so these weights differ from ``sema_tpu``'s random ones;
   the tests carry the JAX package's params across with
   :func:`params_from_jax` instead.

There is no hub download: the port runs offline.

The parameter tree is the JAX package's, as torch tensors (f32 unless
asked otherwise): ``{"embeddings": {word, position, token_type, ln_scale,
ln_bias}, "layers": {qkv_w (L,H,3H), qkv_b (L,3H), attn_out_w, ...}}``
with q|k|v fused and torch ``Linear.weight`` (out, in) transposed to
(in, out).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from sema_tpu_torch.models.registry import EncoderSpec
from sema_tpu_torch.utils.hfcache import hf_cache_snapshot

# (our leaf name, HF suffix, transpose?) — q/k/v are fused after loading
_LAYER_LEAVES = [
    ("attn_out_w", "attention.output.dense.weight", True),
    ("attn_out_b", "attention.output.dense.bias", False),
    ("attn_ln_scale", "attention.output.LayerNorm.weight", False),
    ("attn_ln_bias", "attention.output.LayerNorm.bias", False),
    ("ffn_in_w", "intermediate.dense.weight", True),
    ("ffn_in_b", "intermediate.dense.bias", False),
    ("ffn_out_w", "output.dense.weight", True),
    ("ffn_out_b", "output.dense.bias", False),
    ("ffn_ln_scale", "output.LayerNorm.weight", False),
    ("ffn_ln_bias", "output.LayerNorm.bias", False),
]

_EMB_LEAVES = [
    ("word", "embeddings.word_embeddings.weight"),
    ("position", "embeddings.position_embeddings.weight"),
    ("token_type", "embeddings.token_type_embeddings.weight"),
    ("ln_scale", "embeddings.LayerNorm.weight"),
    ("ln_bias", "embeddings.LayerNorm.bias"),
]

_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")

Params = Dict[str, Dict[str, torch.Tensor]]


def from_hf_tensors(tensors: Mapping[str, np.ndarray], spec: EncoderSpec,
                    param_dtype=torch.float32) -> Params:
    """Convert a flat {hf_name: array} dict into the stacked param tree.
    Accepts names with or without a ``bert.``/``model.``/``encoder.``
    prefix."""
    def get(name: str) -> np.ndarray:
        for prefix in ("", "bert.", "model.", "encoder."):
            if prefix + name in tensors:
                return np.asarray(tensors[prefix + name], dtype=np.float32)
        raise KeyError(f"missing weight {name!r}; have e.g. "
                       f"{sorted(tensors)[:5]}")

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(param_dtype)

    emb = {ours: t(get(hf)) for ours, hf in _EMB_LEAVES}
    layers: Dict[str, list] = {ours: [] for ours, _, _ in _LAYER_LEAVES}
    layers["qkv_w"] = []
    layers["qkv_b"] = []
    for i in range(spec.num_layers):
        for ours, suffix, transpose in _LAYER_LEAVES:
            w = get(f"encoder.layer.{i}.{suffix}")
            layers[ours].append(w.T if transpose else w)
        layers["qkv_w"].append(np.concatenate([
            get(f"encoder.layer.{i}.attention.self.{p}.weight").T
            for p in ("query", "key", "value")], axis=1))
        layers["qkv_b"].append(np.concatenate([
            get(f"encoder.layer.{i}.attention.self.{p}.bias")
            for p in ("query", "key", "value")]))
    return {"embeddings": emb,
            "layers": {k: t(np.stack(v)) for k, v in layers.items()}}


def params_from_jax(tree: Mapping[str, Mapping[str, Any]],
                    param_dtype=torch.float32) -> Params:
    """The port's params from a ``sema_tpu`` param pytree (its leaves as
    numpy arrays or anything ``np.asarray`` takes), so both packages can
    compute with identical weights. A quantized tree
    (``quantize_params_int8``) keeps its int8 ``*_q`` values and f32
    ``*_s`` scales as they are."""
    def leaf_tensor(name, leaf):
        if name.endswith("_w_q"):
            return torch.from_numpy(np.array(leaf, dtype=np.int8))
        t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        return t if name.endswith("_w_s") else t.to(param_dtype)

    return {group: {name: leaf_tensor(name, leaf)
                    for name, leaf in tree[group].items()}
            for group in ("embeddings", "layers")}


def _trunc_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """N(0, 1) truncated to [-2, 2] by redrawing, times 0.02."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return (out * 0.02).astype(np.float32)


def random_params(spec: EncoderSpec, seed: int = 0,
                  param_dtype=torch.float32) -> Params:
    """Deterministic BERT-style initialization (trunc-normal σ=0.02,
    LayerNorms at identity) from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    H, I, L = spec.hidden_size, spec.intermediate_size, spec.num_layers
    t = lambda a: torch.from_numpy(a).to(param_dtype)
    emb = {
        "word": t(_trunc_normal(rng, (spec.vocab_size, H))),
        "position": t(_trunc_normal(rng, (spec.max_position_embeddings, H))),
        "token_type": t(_trunc_normal(rng, (2, H))),
        "ln_scale": torch.ones(H, dtype=param_dtype),
        "ln_bias": torch.zeros(H, dtype=param_dtype),
    }
    shapes = {
        "qkv_w": (L, H, 3 * H), "qkv_b": (L, 3 * H),
        "attn_out_w": (L, H, H), "attn_out_b": (L, H),
        "ffn_in_w": (L, H, I), "ffn_in_b": (L, I),
        "ffn_out_w": (L, I, H), "ffn_out_b": (L, H),
    }
    layers = {name: t(_trunc_normal(rng, shape))
              for name, shape in shapes.items()}
    for name in ("attn_ln_scale", "ffn_ln_scale"):
        layers[name] = torch.ones((L, H), dtype=param_dtype)
    for name in ("attn_ln_bias", "ffn_ln_bias"):
        layers[name] = torch.zeros((L, H), dtype=param_dtype)
    return {"embeddings": emb, "layers": layers}


_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": np.uint16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
    "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: Path | str) -> Dict[str, np.ndarray]:
    """Read a ``.safetensors`` file: a little-endian u64 header length, a
    JSON header {name: {dtype, shape, data_offsets}}, then the raw
    little-endian tensors. BF16 tensors come back widened to f32."""
    data = bytearray(Path(path).stat().st_size)    # writable arrays
    with open(path, "rb") as f:
        f.readinto(data)
    (hlen,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + hlen])
    base = 8 + hlen
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {info['dtype']}")
        start, end = info["data_offsets"]
        arr = np.frombuffer(data, dtype=np.dtype(dtype).newbyteorder("<"),
                            count=(end - start) // np.dtype(dtype).itemsize,
                            offset=base + start).reshape(info["shape"])
        if info["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def _load_tensor_file(path: Path) -> Dict[str, np.ndarray]:
    """Read model.safetensors or a torch pytorch_model.bin."""
    if path.suffix == ".safetensors":
        return read_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in state.items()}


def load_params(spec: EncoderSpec, weights_path: str = "",
                param_dtype=torch.float32, seed: int = 0):
    """Resolve weights per the priority order above. Returns (params,
    source) with source ∈ {"local", "hf-cache", "random"}."""
    if weights_path:
        p = Path(weights_path)
        candidates = [p / n for n in _WEIGHT_FILES] if p.is_dir() else [p]
        for c in candidates:
            if c.exists():
                return (from_hf_tensors(_load_tensor_file(c), spec,
                                        param_dtype), "local")
        raise FileNotFoundError(f"no weights found under: {weights_path}")
    if spec.hf_repo:
        snap = hf_cache_snapshot(spec.hf_repo)
        for name in _WEIGHT_FILES if snap is not None else ():
            if (snap / name).exists():
                return (from_hf_tensors(_load_tensor_file(snap / name), spec,
                                        param_dtype), "hf-cache")
    return random_params(spec, seed=seed, param_dtype=param_dtype), "random"
