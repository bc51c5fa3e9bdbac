"""Exact top-k scan of ``queries @ store.T`` (K1 of the port).

Replaces the TPU kernel ``sema_tpu/ops/pallas_topk.py:pallas_topk``
(``_scan_kernel`` / ``_scan_kernel_nomask`` over ``_merge_and_emit``).
On a CUDA tensor :func:`scan_topk` launches the Hopper kernel of
``csrc/scan_topk.cu``; on a CPU tensor it runs
:func:`scan_topk_reference`, the plain PyTorch version of the same
contract. There is no other path.

Contract (that of ``pallas_topk``, ``pallas_topk.py:309-344``):

- scores are ``queries.astype(store.dtype) @ store.T`` with f32
  accumulation; rows whose ``valid`` entry is False score -inf
  (``masked=False`` skips the mask: every row is live);
- each query's k best rows, ranked by score descending; equal scores put
  the lower row id first;
- slots past the live rows are -inf with id 0;
- returns (Q, k) f32 scores and (Q, k) int32 ids.

Unlike the TPU kernel, N need not be a tile multiple (the kernel masks its
own ragged edge) and k may reach 1024 (the store's largest k class).
"""

from __future__ import annotations

import ctypes

import torch

from sema_tpu_torch.ops import _cuda

K_MAX = 1024
_TILE_ROWS = 64         # rows per tile of pass 1 (csrc/scan_topk.cu)
_SMEM_MAX = 232_448     # dynamic shared memory one block may use on Hopper
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_SIGNATURES = {"sema_scan_topk": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # store, q, valid
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, d, nq, k
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    # dtype, query block, rows per chunk, words per slab, chunks
    ctypes.c_void_p, ctypes.c_void_p,                    # candidates
    ctypes.c_void_p, ctypes.c_void_p,                    # outputs
    ctypes.c_void_p]}                                    # stream


def scan_topk_reference(store: torch.Tensor, queries: torch.Tensor,
                        valid: torch.Tensor, k: int, masked: bool = True):
    """Plain PyTorch version of :func:`scan_topk` (same contract)."""
    n = store.shape[0]
    scores = queries.to(store.dtype).float() @ store.float().T   # (Q, N)
    if masked:
        scores = scores.masked_fill(~valid.bool()[None, :], float("-inf"))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    kk = min(k, n)
    top_s = vals[:, :kk].contiguous()
    top_i = idx[:, :kk].to(torch.int32)
    top_i = top_i.masked_fill(torch.isneginf(top_s), 0)
    if kk < k:
        q = scores.shape[0]
        top_s = torch.cat([top_s, top_s.new_full((q, k - kk),
                                                 float("-inf"))], 1)
        top_i = torch.cat([top_i, top_i.new_zeros((q, k - kk))], 1)
    return top_s, top_i


def _query_block(k: int) -> int:
    return 16 if k <= 128 else 4


def slab_words(d: int, itemsize: int, k: int) -> int:
    """32-bit words of each row that pass 1 stages at a time: the whole
    row where shared memory holds 64 of them beside the queries and the
    lists, else the most that fit, a multiple of 4 (0: nothing fits)."""
    qb = _query_block(k)
    words = d * itemsize // 4
    free = _SMEM_MAX - (qb * d * 4 + qb * _TILE_ROWS * 4 + qb * k * 8)
    return max(0, min(words, (free // (_TILE_ROWS * 4) - 1) // 4 * 4))


def pass1_smem_bytes(d: int, itemsize: int, k: int) -> int:
    """Dynamic shared memory of pass 1 (mirrors csrc/scan_topk.cu)."""
    qb = _query_block(k)
    return (qb * d * 4 + _TILE_ROWS * (slab_words(d, itemsize, k) + 1) * 4
            + qb * _TILE_ROWS * 4 + qb * k * 8)


def chunk_plan(n: int, nq: int, k: int, sms: int):
    """(rows per chunk, chunks): split N so that about two blocks per SM
    are in flight whatever Q is (Q=1 at query time)."""
    q_blocks = -(-nq // _query_block(k))
    tiles = -(-n // _TILE_ROWS)
    chunks = max(1, min(tiles, -(-2 * sms // q_blocks)))
    rows = -(-tiles // chunks) * _TILE_ROWS
    return rows, -(-n // rows)


def _check(store, queries, valid, k, masked):
    if store.device.type != "cuda":
        raise ValueError(f"scan_topk takes CPU or CUDA tensors, got "
                         f"{store.device}")
    if store.dim() != 2 or not store.is_contiguous():
        raise ValueError("store must be a contiguous (N, d) tensor")
    if store.dtype not in _DTYPE_CODES:
        raise ValueError(f"store dtype {store.dtype} not supported; "
                         "bf16, f16 or f32")
    n, d = store.shape
    if n < 1:
        raise ValueError("empty store")
    if (d * store.element_size()) % 16 or store.data_ptr() % 16:
        raise ValueError(f"store rows must be 16-byte multiples, d={d}")
    if queries.dim() != 2 or queries.shape[1] != d or queries.shape[0] < 1:
        raise ValueError(f"queries must be (Q, {d}), got "
                         f"{tuple(queries.shape)}")
    if queries.device != store.device:
        raise ValueError("queries and store lie on different devices")
    if masked and (valid.shape != (n,) or valid.dtype != torch.bool
                   or valid.device != store.device
                   or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous (N,) bool tensor on "
                         "the store's device")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k={k} outside [1, {K_MAX}]")
    if slab_words(d, store.element_size(), k) < 4:
        raise ValueError(f"d={d} at {store.dtype}, k={k}: the queries and "
                         "lists alone fill the scan's shared memory")


def scan_topk(store: torch.Tensor, queries: torch.Tensor,
              valid: torch.Tensor, k: int, masked: bool = True):
    """Exact top-k (see the module docstring). CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    if store.device.type == "cpu":
        return scan_topk_reference(store, queries, valid, k, masked=masked)
    _check(store, queries, valid, k, masked)
    lib = _cuda.library("scan_topk", _SIGNATURES)
    n, d = store.shape
    q = _cuda.aligned(queries.to(store.dtype))
    nq = q.shape[0]
    sms = torch.cuda.get_device_properties(store.device).multi_processor_count
    rows, chunks = chunk_plan(n, nq, k, sms)
    cand_s = torch.empty((nq, chunks, k), dtype=torch.float32,
                         device=store.device)
    cand_i = torch.empty((nq, chunks, k), dtype=torch.int32,
                         device=store.device)
    out_s = torch.empty((nq, k), dtype=torch.float32, device=store.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=store.device)
    err = lib.sema_scan_topk(
        store.data_ptr(), q.data_ptr(),
        valid.data_ptr() if masked else None,
        n, d, nq, k, _DTYPE_CODES[store.dtype], _query_block(k), rows,
        slab_words(d, store.element_size(), k), chunks, cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), _cuda.stream_ptr(store.device))
    _cuda.check(lib, err, "scan_topk")
    scan_topk.launches += 1
    return out_s, out_i


scan_topk.launches = 0
