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

With a :class:`~sema_tpu_torch.parallel.mesh.Mesh` (``mesh=``), the
batch splits over ``data_axis`` (data parallelism: each part embedded on
its shard's device with the params replicated there) and, with
``model_axis``, every layer's weights shard over that axis (Megatron
tensor parallelism, ``models/tp.py``; each layer runs
``bert.encoder_layer_tp``, K6 and K7). The two compose over a (data,
model) mesh; other axes of the mesh repeat the same work, so it runs once.
One process drives every shard, and a device may hold several.

``encode_texts(return_device=True)`` returns an :class:`EncodedBatch`:
the host rows and the same rows left on the device, in order, for the
vector store's in-place append (``VectorStore.add_chunks``). The JAX
package holds its batch outputs on the device up to ``HOLD_MB`` and
drains them in bulk; here each batch is copied out as soon as it is
launched, so there is nothing to drain and no hold budget.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.models import bert
from sema_tpu_torch.models.loader import load_params
from sema_tpu_torch.models.registry import EncoderSpec, get_spec
from sema_tpu_torch.models.tp import shard_params_tp
from sema_tpu_torch.tokenizer import load_tokenizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class EncodedBatch(NamedTuple):
    """Both placements of one ``encode_texts(return_device=True)`` result
    (``sema_tpu/models/encoder.py:43-49``): ``host`` for the disk segment,
    ``device`` for the vector store's append."""
    host: torch.Tensor
    device: torch.Tensor


class Encoder:
    """Owns spec + params (on the device, or one tree per shard of the
    mesh) + tokenizer."""

    # sequence-length bucket ladder (encoder.py:201): both the linear
    # FLOPs (∝ S) and the attention FLOPs (∝ S²) shrink with the bucket
    BUCKETS = (32, 64, 128, 256)

    def __init__(self, spec: EncoderSpec, params, tokenizer,
                 max_length: Optional[int] = None, batch_size: int = 256,
                 compute_dtype=torch.bfloat16, device=None,
                 quant: str = "none", mesh=None, data_axis: str = "data",
                 model_axis: Optional[str] = None):
        quant = os.environ.get("SEMA_TPU_ENCODER_QUANT", quant)
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown encoder quant mode {quant!r}")
        self.quant = quant
        self.spec = spec
        self.mesh, self.data_axis = mesh, data_axis
        # tensor parallelism shards over an axis of a mesh
        self.model_axis = model_axis if mesh is not None else None
        self.tokenizer = tokenizer
        self.max_length = max_length or spec.default_max_length
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        if mesh is None:
            self.device = resolve_device(device)
            grid = np.empty((1, 1), dtype=object)
            grid[0, 0] = self.device
        else:
            # the mesh's devices: ``device`` names none of them
            grid = mesh.grid([data_axis] + ([model_axis] if model_axis
                                            else []))
            grid = grid.reshape(grid.shape[0], -1).copy()
            for idx in np.ndindex(*grid.shape):
                grid[idx] = resolve_device(grid[idx])
            self.device = grid[0, 0]
        self._dp = grid.shape[0]
        params = {g: {k: v.to(self.device) for k, v in leaves.items()}
                  for g, leaves in params.items()}
        if quant == "int8":
            # quantized as loaded, before any cast or shard: the scales
            # of the column-parallel linears move with their columns
            params = bert.quantize_params_int8(params)
            if self.model_axis is None:   # TP shards lay out their own
                params = bert.int8_kernel_layout(params)
        self.params = self.shards = None
        # bert.layer_views(self.params) and, on the card, their
        # bert.layer_operands: made at the first embed
        self.views = self.operands = None
        if mesh is None:
            self.params = bert.cast_params(params, compute_dtype)
        elif self.model_axis is not None:
            tp = mesh.shape[self.model_axis]
            if spec.num_heads % tp:
                # a tp that does not divide the heads would cut across
                # them: fail loudly, as the JAX Encoder does
                raise ValueError(
                    f"model {spec.name!r} has {spec.num_heads} heads; "
                    f"tensor-parallel degree {tp} must divide them")
            trees = mesh.grid([data_axis, self.model_axis], shard_params_tp(
                params, mesh, self.model_axis))
            cast: dict = {}           # one cast per distinct tree
            self.shards = np.empty(trees.shape, dtype=object)
            for idx in np.ndindex(*trees.shape):
                tree = trees[idx]
                if id(tree) not in cast:
                    cast[id(tree)] = bert.cast_params(tree, compute_dtype,
                                                      biases=False)
                self.shards[idx] = cast[id(tree)]
        else:
            placed: dict = {}         # the params once per distinct device
            self.shards = np.empty(grid.shape, dtype=object)
            for idx in np.ndindex(*grid.shape):
                dev = grid[idx]
                if str(dev) not in placed:
                    placed[str(dev)] = bert.cast_params(
                        {g: {k: v.to(dev) for k, v in leaves.items()}
                         for g, leaves in params.items()}, compute_dtype)
                self.shards[idx] = placed[str(dev)]
        if self.batch_size % self._dp:
            self.batch_size += self._dp - self.batch_size % self._dp

    @classmethod
    def from_config(cls, model_cfg, device=None, mesh=None,
                    data_axis: str = "data",
                    model_axis: Optional[str] = None) -> "Encoder":
        """Build from a :class:`sema_tpu_torch.config.ModelConfig`.
        ``model_axis`` (from ``[mesh] model_axis``) turns on tensor
        parallelism over that axis of ``mesh``."""
        spec = get_spec(model_cfg.name)
        params, wsource = load_params(spec, model_cfg.weights_path)
        tok, tsource = load_tokenizer(spec.vocab_size, spec.hf_repo,
                                      path=model_cfg.weights_path)
        enc = cls(spec, params, tok, max_length=model_cfg.max_length,
                  batch_size=model_cfg.batch_size,
                  compute_dtype=DTYPES[model_cfg.dtype], device=device,
                  quant=model_cfg.quant, mesh=mesh, data_axis=data_axis,
                  model_axis=model_axis)
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
        """(batch, dim) f32 L2-normalized embeddings on the device (the
        mesh's first). On a mesh the batch is padded with all-PAD rows to
        a multiple of the data-parallel degree and split over it."""
        ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
        if self.shards is None:
            if self.views is None:
                views = bert.layer_views(self.params)
                if self.device.type == "cuda":
                    self.operands = bert.layer_operands(views,
                                                        self.compute_dtype)
                self.views = views
            with torch.inference_mode():
                return bert.embed(self.params,
                                  ids.to(self.device, non_blocking=True),
                                  mask.to(self.device, non_blocking=True),
                                  self.spec, self.compute_dtype, self.views,
                                  self.operands)
        n = ids.shape[0]
        pad = -n % self._dp
        if pad:
            ids = torch.cat([ids, ids.new_full((pad, ids.shape[1]),
                                               self.tokenizer.pad_id)])
            mask = torch.cat([mask, mask.new_zeros((pad, mask.shape[1]))])
        outs = []
        with torch.inference_mode():
            for row, i, m in zip(self.shards, ids.chunk(self._dp),
                                 mask.chunk(self._dp)):
                if self.model_axis is None:
                    dev = row[0]["embeddings"]["word"].device
                    out = bert.embed(row[0], i.to(dev), m.to(dev), self.spec,
                                     self.compute_dtype)
                else:
                    out = bert.embed_tp(list(row), i, m, self.spec,
                                        self.compute_dtype)
                outs.append(out.to(self.device))
        return torch.cat(outs)[:n]

    def bucket_len(self, n: int) -> int:
        """The sequence length a text of ``n`` tokens is padded to: the
        smallest bucket that holds it, or ``max_length`` when none does
        or when ``SEMA_TPU_BUCKETS=off`` (as in ``sema_tpu``'s encoder)."""
        if os.environ.get("SEMA_TPU_BUCKETS", "on") == "off":
            return self.max_length
        for b in self.BUCKETS:
            if n <= b <= self.max_length:
                return b
        return self.max_length

    def encode_texts(self, texts: Sequence[str], progress=None,
                     out_dtype=torch.float32, return_device: bool = False):
        """Embed any number of texts: a (len(texts), dim) CPU tensor of
        ``out_dtype`` (f32 by default; the index build passes the store's
        dtype so the cast happens on the device and the copy back is
        narrower). Output order matches input order: embeddings do not
        depend on padding. ``progress(done, total)`` is called after each
        launched batch; (n, n) only once the results are on the host.

        ``return_device=True`` returns an :class:`EncodedBatch`: the same
        host tensor, and an in-order (n, dim) tensor of ``out_dtype`` on
        the encoder's device (a mesh's first), assembled from the kept
        batch outputs by a ``cat`` and an ``index_select`` by the inverse
        of the bucketing order, both enqueued. The device rows stay
        resident until the caller drops them: a mode for bounded batches
        (a re-index's changed files), which ``IndexManager`` takes only
        once the store holds a live device copy."""
        n = len(texts)
        dim = self.spec.dim
        out = torch.empty((n, dim), dtype=out_dtype)
        if n == 0:
            if return_device:
                return EncodedBatch(out, torch.empty(
                    (0, dim), dtype=out_dtype, device=self.device))
            return out
        pin = self.device.type == "cuda"
        held = []          # (host copy in flight, row indices)
        kept = []          # return_device: the batch outputs, in order
        submitted = 0
        SB = 8 * self.batch_size   # super-batch: bucketing granularity
        for soff in range(0, n, SB):
            encs = self._encode(texts[soff:soff + SB])
            buckets: dict = {}
            for i, (tok_ids, _) in enumerate(encs):
                buckets.setdefault(self.bucket_len(len(tok_ids)),
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
                    if return_device:
                        kept.append(emb)
                    submitted += len(part)
                    if progress is not None and submitted < n:
                        progress(submitted, n)
        if pin:
            torch.cuda.synchronize(self.device)
        for host, idxs in held:
            out[idxs] = host
        if progress is not None:
            progress(n, n)
        if not return_device:
            return out
        order = torch.as_tensor([i for _, idxs in held for i in idxs])
        inverse = torch.empty_like(order)
        inverse[order] = torch.arange(n)
        device = torch.cat(kept).index_select(
            0, inverse.to(self.device, non_blocking=pin))
        return EncodedBatch(out, device)

    def encode_query(self, text: str) -> np.ndarray:
        """Single-query embedding, (dim,) f32 numpy."""
        return self.encode_query_device(text).cpu().numpy()

    def encode_query_device(self, text: str) -> torch.Tensor:
        """Single-query embedding left on the device, (dim,) f32. The
        query is padded to ``max_length`` (and on a mesh to the
        data-parallel degree in rows), as in the JAX package."""
        ids, mask = self.tokenize_batch([text], pad_to=1)
        return self.embed_ids(ids, mask)[0]
