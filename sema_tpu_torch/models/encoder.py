"""Batched sentence encoder (from ``sema_tpu/models/encoder.py``).

The model is loaded once per process and placed on its device; chunks
are tokenized on the host, grouped into sequence-length buckets
(32/64/128/max) and embedded bucket by bucket, each bucket's batch
holding ``batch_size * max_length // bucket`` rows so that every launch
carries about the same number of tokens. Results leave the card through
non-blocking copies into pinned host memory and are gathered once, after
the last batch has been launched.

``quant="int8"`` (``[model] quant``, overridden by
``SEMA_TPU_ENCODER_QUANT``) quantizes the four linears of every layer to
int8 with per-output-channel scales as loaded, before any cast, and each
layer then runs W8A8 (K5); the int8 weights are laid out once, at load,
as the kernel reads them.

Data-parallel and tensor-parallel meshes and the device-resident
``return_device`` result are not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.models import bert
from sema_tpu_torch.models.loader import load_params
from sema_tpu_torch.models.registry import EncoderSpec, get_spec
from sema_tpu_torch.tokenizer import load_tokenizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class Encoder:
    """Owns spec + params (on the device) + tokenizer."""

    # sequence-length bucket ladder (encoder.py:201): both the linear
    # FLOPs (∝ S) and the attention FLOPs (∝ S²) shrink with the bucket
    BUCKETS = (32, 64, 128, 256)

    def __init__(self, spec: EncoderSpec, params, tokenizer,
                 max_length: Optional[int] = None, batch_size: int = 256,
                 compute_dtype=torch.bfloat16, device=None,
                 quant: str = "none"):
        quant = os.environ.get("SEMA_TPU_ENCODER_QUANT", quant)
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown encoder quant mode {quant!r}")
        self.device = resolve_device(device)
        self.quant = quant
        self.spec = spec
        params = {g: {k: v.to(self.device) for k, v in leaves.items()}
                  for g, leaves in params.items()}
        if quant == "int8":
            params = bert.int8_kernel_layout(
                bert.quantize_params_int8(params))
        self.params = bert.cast_params(params, compute_dtype)
        self.tokenizer = tokenizer
        self.max_length = max_length or spec.default_max_length
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype

    @classmethod
    def from_config(cls, model_cfg, device=None) -> "Encoder":
        """Build from a :class:`sema_tpu_torch.config.ModelConfig`."""
        spec = get_spec(model_cfg.name)
        params, wsource = load_params(spec, model_cfg.weights_path)
        tok, tsource = load_tokenizer(spec.vocab_size, spec.hf_repo,
                                      path=model_cfg.weights_path)
        enc = cls(spec, params, tok, max_length=model_cfg.max_length,
                  batch_size=model_cfg.batch_size,
                  compute_dtype=DTYPES[model_cfg.dtype], device=device,
                  quant=model_cfg.quant)
        enc.weights_source = wsource
        enc.tokenizer_source = tsource
        return enc

    def _encode(self, texts: Sequence[str]):
        if hasattr(self.tokenizer, "encode_batch"):
            return self.tokenizer.encode_batch(list(texts), self.max_length)
        return [self.tokenizer.encode(t, self.max_length) for t in texts]

    def tokenize_batch(self, texts: Sequence[str],
                       pad_to: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-shape (rows, max_length) int32 ids + mask; rows past
        ``len(texts)`` are all-PAD with a zero mask."""
        rows = pad_to if pad_to is not None else len(texts)
        L = self.max_length
        ids = np.full((rows, L), self.tokenizer.pad_id, dtype=np.int32)
        mask = np.zeros((rows, L), dtype=np.int32)
        for i, (tok_ids, tok_mask) in enumerate(self._encode(texts)):
            ids[i, :len(tok_ids)] = tok_ids
            mask[i, :len(tok_ids)] = tok_mask
        return ids, mask

    def embed_ids(self, ids, mask) -> torch.Tensor:
        """(batch, dim) f32 L2-normalized embeddings on the device."""
        ids = torch.as_tensor(ids).to(self.device, non_blocking=True)
        mask = torch.as_tensor(mask).to(self.device, non_blocking=True)
        with torch.inference_mode():
            return bert.embed(self.params, ids, mask, self.spec,
                              self.compute_dtype)

    def _bucket_len(self, n: int) -> int:
        for b in self.BUCKETS:
            if n <= b <= self.max_length:
                return b
        return self.max_length

    def encode_texts(self, texts: Sequence[str], progress=None,
                     out_dtype=torch.float32) -> torch.Tensor:
        """Embed any number of texts: a (len(texts), dim) CPU tensor of
        ``out_dtype`` (f32 by default; the index build passes the store's
        dtype so the cast happens on the device and the copy back is
        narrower). Output order matches input order: embeddings do not
        depend on padding. ``progress(done, total)`` is called after each
        launched batch; (n, n) only once the results are on the host."""
        n = len(texts)
        dim = self.spec.dim
        out = torch.empty((n, dim), dtype=out_dtype)
        if n == 0:
            return out
        pin = self.device.type == "cuda"
        held = []          # (host copy in flight, row indices)
        submitted = 0
        SB = 8 * self.batch_size   # super-batch: bucketing granularity
        for soff in range(0, n, SB):
            encs = self._encode(texts[soff:soff + SB])
            buckets: dict = {}
            for i, (tok_ids, _) in enumerate(encs):
                buckets.setdefault(self._bucket_len(len(tok_ids)),
                                   []).append(i)
            for blen in sorted(buckets):
                idxs = buckets[blen]
                rows = self.batch_size * max(1, self.max_length // blen)
                for boff in range(0, len(idxs), rows):
                    part = idxs[boff:boff + rows]
                    ids = np.full((len(part), blen), self.tokenizer.pad_id,
                                  dtype=np.int32)
                    mask = np.zeros((len(part), blen), dtype=np.int32)
                    for r, i in enumerate(part):
                        tok_ids, tok_mask = encs[i]
                        k = min(len(tok_ids), blen)
                        ids[r, :k] = tok_ids[:k]
                        mask[r, :k] = tok_mask[:k]
                    emb = self.embed_ids(ids, mask).to(out_dtype)
                    host = torch.empty(emb.shape, dtype=out_dtype,
                                       pin_memory=pin)
                    host.copy_(emb, non_blocking=pin)
                    held.append((host, [soff + i for i in part]))
                    submitted += len(part)
                    if progress is not None and submitted < n:
                        progress(submitted, n)
        if pin:
            torch.cuda.synchronize(self.device)
        for host, idxs in held:
            out[idxs] = host
        if progress is not None:
            progress(n, n)
        return out

    def encode_query(self, text: str) -> np.ndarray:
        """Single-query embedding, (dim,) f32 numpy."""
        return self.encode_query_device(text).cpu().numpy()

    def encode_query_device(self, text: str) -> torch.Tensor:
        """Single-query embedding left on the device, (dim,) f32. The
        query is padded to ``max_length``, as in the JAX package."""
        ids, mask = self.tokenize_batch([text], pad_to=1)
        return self.embed_ids(ids, mask)[0]
