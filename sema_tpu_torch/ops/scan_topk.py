"""Exact top-k scans of ``queries @ store.T`` (K1, K4a, K3, K4b, K8 and K9
of the port).

Six wrappers, one kernel source (``csrc/scan_topk.cu``), each replacing a
TPU kernel of ``sema_tpu/ops/pallas_topk.py`` or ``tools/scan_ab14.py``:

- :func:`scan_topk` (K1, ``pallas_topk``): a bf16/f16/f32 store;
- :func:`scan_topk_warm` (K8, ``pallas_topk(warm_rows=)``): K1 with each
  query's screen started one ULP below the k-th best of the store's first
  ``warm_rows`` rows; ``scan_topk(warm_rows=)`` calls it;
- :func:`fold_topk` (K9, ``tools/scan_ab14.py:fold_topk``): K1 without a
  mask, merging each span of rows through a per-lane fold;
- :func:`scan_topk_int8` (K4a, ``pallas_topk_int8``): an int8 store;
- :func:`scan_topk_pruned` (K3, ``pallas_topk_pruned``): the tiles of an
  IVF probe of a bf16/f16/f32 store;
- :func:`scan_topk_int8_pruned` (K4b, ``pallas_topk_int8_pruned``): the
  same of an int8 store.

On a CUDA tensor each launches the Hopper kernel; on a CPU tensor it runs
its ``*_reference``, the plain PyTorch version of the same contract. There
is no other path. Each wrapper counts its launches in ``.launches``.

Contract (``pallas_topk.py:309-344, 407-433, 520-594``):

- bf16/f16/f32 scores are ``queries.astype(store.dtype) @ store.T`` with
  f32 accumulation; int8 scores are ``(qi . row_i8)`` summed in i32, cast
  to f32 and multiplied by the row's f32 scale, where ``qi`` is the query
  quantized per row (:func:`sema_tpu_torch.ops.quant.quantize_query`; on
  the card the scan's first launch quantizes with the same arithmetic),
  and the query's scale multiplies the merged scores;
- rows whose ``valid`` entry is False score -inf (``masked=False`` skips
  the mask of K1: every row is live);
- each query's k best rows, ranked by score descending; equal scores put
  the row scanned first first, which is the lower row id (a pruned scan's
  tile ids come sorted from ``ops/ivf.py:select_tiles``, and the card's
  wrappers refuse live ids that are not strictly increasing);
- slots past the live rows are -inf with id 0;
- returns (Q, k) f32 scores and (Q, k) int32 ids.

A pruned scan reads the tiles ``tile_ids[:n_live]`` of ``tile_n`` rows
each; entries past ``n_live`` add nothing; ids are rows of the store as
given (the cluster-major bucket). ``tile_ids`` is a host array: the store
picks it on the host, and its range is checked there.

Unlike the TPU kernels, N need not be a tile multiple (the kernel masks
its own ragged edge) and k may reach ``K_MAX`` = 1024 (the store's largest
k class); above it the store takes the hierarchical route of
``ops/hier_topk.py``, and a CUDA tensor given here raises. bf16/f16 rows
are scored on the tensor cores (f32 accumulation in their own order),
int8 rows on the tensor cores too (i32 accumulation), f32 rows by scalar
FMAs; the block's queries, the staged slab of each row and the chunks
follow :func:`_query_block`, :func:`slab_words` and :func:`chunk_plan`,
and pass 2's warps :func:`pass2_warps` (its plain version is
:func:`scan_pass2_reference`). bf16/f16 rows of K1, K3 and K8 merge pass
1's survivors in warps of their own beside the scoring warps, through
queues flushed by rank (``csrc/scan_topk.cu:scan_pass1_merged``); their
query block, score buffers and slab follow :func:`merge_layout`, and
:func:`pass1_merge_reference` is the plain model of that merge, down to
the counters the kernel can report (survivors queued, flushes). K1 and
K8 of a batch of more than 8 queries over a whole bf16/f16 store score on
``wgmma`` fed by TMA instead of ``mma.sync`` (``csrc/scan_topk.cu:
wgmma_scorers``) where :func:`wgmma_layout` finds a block of 32 or 64
queries and a ring of at least three stages, with the same mergers and
the same bits.
A call on the card (:func:`_launch`) makes one device allocation, cut
into the returned scores and ids, pass 1's candidates, a pruned scan's
tile ids and an int8 scan's quantized queries (:func:`workspace_layout`);
the entry point stages the tile list through a pinned buffer of the
card's, raises each kernel's shared-memory limit once a card, and
refuses a card that is not the current one. At one query the bf16/f16
route takes one launch where the chunk lists fit pass 1's shared memory
(:func:`one_launch`, :func:`one_launch_fits`): the last block of pass 1
to finish merges them as pass 2 would, and f32 queries are rounded to
the store dtype as pass 1 stages them, with no cast launch before it.
The int8 scores and ids equal the plain version's bit for bit: an i32 sum
of d <= 1040 products of int8 values is exact in any order and converts
to f32 without loss. K8 and K9 compute K1's function: on the card their
scores and ids equal K1's bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from sema_tpu_torch.ops import _cuda
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.ops.quant import int8_dot, quantize_query

K_MAX = 1024
_TILE_ROWS = 64         # rows per tile of pass 1 (csrc/scan_topk.cu)
_SMEM_MAX = 232_448     # dynamic shared memory one block may use on Hopper
_SM_SMEM = 233_472      # shared memory of one SM, of which the runtime
_SMEM_RESERVED = 1_024  # keeps this much for each block
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2,
                torch.int8: 3}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"sema_scan_topk": [
    _P, _P, _I,            # store, queries, queries in f32
    _P, _P,                # valid, row scales
    _P, _I, _I,            # tile ids (a host array), live tiles, tile_n
    _I, _I, _I, _I,        # n, d, nq, k
    _I, _I, _I, _I, _I,    # dtype, query block, rows per chunk, words per
                           # slab, chunks
    _I, _I, _I, _I, _I,    # pass-2 warps, score buffers, the wgmma
                           # route's ring stages, pass 1's shared memory,
                           # one launch
    _P, _L, _P, _P,        # workspace, its bytes, warm thresholds, merge
                           # counters
    _P, _I],               # stream, card
    "sema_fold_topk": [
    _P, _P,                # store, queries
    _I, _I, _I, _I,        # n, d, nq, k
    _I, _I, _I, _I, _I,    # dtype, query block, rows per chunk, words per
    _I, _I,                # slab, chunks, pass-2 warps, pass 1's shared
                           # memory
    _P, _L, _P,            # workspace, its bytes, span counters
    _P, _I]}               # stream, card
_FOLD_SPAN = 256        # rows each K9 merge takes (csrc/scan_topk.cu)
_RANKED_SLOTS = 1_024   # the int8 route's merge_ranked slots: 8 warps x 32 words
_PASS2_MAX_WARPS = 32   # warps of a pass-2 block
_PASS2_SLOTS = 4_096    # warps x k of a pass-2 block: three lists each, 96 KB
# the bf16/f16 route of K1, K3 and K8 (csrc/scan_topk.cu:scan_pass1_merged)
_MERGED_BLOCKS = (64, 32, 16, 8)   # the query blocks its kernel takes
_QUEUE = 32             # survivors a query's queue holds (kQueue)
_SCORE_STRIDE = _TILE_ROWS + 4     # a query's scores, floats apart
# the one-launch route (pass 2's merge in pass 1's last block) takes calls
# of at most this many queries: its merge runs a query at a time in one
# block, where pass 2 runs a block a query
_ONE_LAUNCH_MAX_Q = 1
# the wgmma route of K1 and K8 over a whole bf16/f16 store
# (csrc/scan_topk.cu:wgmma_scorers)
_WG_BLOCKS = (64, 32)   # the query blocks its kernel takes (wgmma N)
_RING_STAGE = _TILE_ROWS * 128   # a TMA stage, 64 rows x 128 B (kRingStage)
_RING_MIN = 3           # the fewest stages it takes (kRingMin)
_RING_ALIGN = 1_024     # the ring's alignment, the 128-byte swizzle's unit
# the fewest ring stages (64 rows x 64 values each) a block of the route
# streams: below, its fixed cost (the queries staged, the ring armed) is a
# visible share of a call of some 50 us and the mma.sync scorers are as
# fast or faster (chip_wgmma_ab.py's crossover, PERF.md)
_WG_MIN_SLABS = 24


def _select(scores: torch.Tensor, k: int):
    """(Q, N) f32 scores → the k best of each row (stable: equal scores
    keep the lower column), -inf slots with id 0, padded to k."""
    n = scores.shape[1]
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


def _scores(store, queries, valid, masked):
    """(Q, N) f32 scores, masked rows -inf."""
    scores = queries.to(store.dtype).float() @ store.float().T
    if masked:
        scores = scores.masked_fill(~valid.bool()[None, :], float("-inf"))
    return scores


def scan_topk_reference(store: torch.Tensor, queries: torch.Tensor,
                        valid: torch.Tensor, k: int, masked: bool = True):
    """Plain PyTorch version of :func:`scan_topk` (same contract)."""
    return _select(_scores(store, queries, valid, masked), k)


def _warm_rows(warm_rows: int, n: int, k: int) -> int:
    """The warm-start sample's rows, ``warm_rows`` clamped to N; raises
    ValueError when it holds fewer than k rows, as ``pallas_topk`` does
    (``lax.top_k`` of the sample refuses)."""
    w = min(warm_rows, n)
    if k > w:
        raise ValueError(f"k={k} exceeds the warm-start sample of {w} rows "
                         f"(warm_rows={warm_rows}, N={n})")
    return w


def warm_threshold(sample_kth: torch.Tensor) -> torch.Tensor:
    """K8's per-query threshold: one ULP below the sample's k-th best score
    (``_warm_thr0``), so a score equal to it still passes the strict
    screen. -inf (a sample with fewer than k live rows) stays -inf: a cold
    start."""
    return torch.nextafter(sample_kth, sample_kth.new_tensor(float("-inf")))


def scan_topk_warm_reference(store: torch.Tensor, queries: torch.Tensor,
                             valid: torch.Tensor, k: int, warm_rows: int,
                             masked: bool = True):
    """Plain PyTorch version of :func:`scan_topk_warm`. The threshold comes
    from the sample's columns of the one (Q, N) product (a second product
    of the sample might round differently), and the screen is applied:
    scores at or below it are dropped before the selection."""
    w = _warm_rows(warm_rows, store.shape[0], k)
    scores = _scores(store, queries, valid, masked)
    thr0 = warm_threshold(torch.topk(scores[:, :w], k, dim=1).values[:, -1])
    return _select(scores.masked_fill(scores <= thr0[:, None],
                                      float("-inf")), k)


def fold_topk_reference(store: torch.Tensor, queries: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`fold_topk`: K1's without a mask,
    the function the fold computes."""
    return scan_topk_reference(store, queries, None, k, masked=False)


def scan_topk_int8_reference(qvals: torch.Tensor, scales: torch.Tensor,
                             queries: torch.Tensor, valid: torch.Tensor,
                             k: int):
    """Plain PyTorch version of :func:`scan_topk_int8` (same contract)."""
    qi, qscale = quantize_query(queries.float())
    scores = int8_dot(qi, qvals) * scales.float()[None, :]
    scores = scores.masked_fill(~valid.bool()[None, :], float("-inf"))
    top_s, top_i = _select(scores, k)
    top_s = torch.where(torch.isneginf(top_s), top_s,
                        top_s * qscale[:, None])
    return top_s, top_i


def _tile_rows(tile_ids, n_live: int, tile_n: int, device) -> torch.Tensor:
    """The physical rows a pruned scan reads, in scan order."""
    tiles = torch.as_tensor(np.asarray(tile_ids)[:n_live], dtype=torch.long)
    rows = tiles[:, None] * tile_n + torch.arange(tile_n)[None, :]
    return rows.reshape(-1).to(device)


def _pruned(select, rows: torch.Tensor):
    """Map a scan of the gathered rows back to physical ids."""
    top_s, top_i = select
    top_i = rows[top_i.long()].to(torch.int32)
    return top_s, top_i.masked_fill(torch.isneginf(top_s), 0)


def scan_topk_pruned_reference(store, queries, valid, tile_ids, n_live: int,
                               k: int, tile_n: int):
    """Plain PyTorch version of :func:`scan_topk_pruned`."""
    rows = _tile_rows(tile_ids, n_live, tile_n, store.device)
    return _pruned(scan_topk_reference(store[rows], queries, valid[rows], k),
                   rows)


def scan_topk_int8_pruned_reference(qvals, scales, queries, valid, tile_ids,
                                    n_live: int, k: int, tile_n: int):
    """Plain PyTorch version of :func:`scan_topk_int8_pruned`."""
    rows = _tile_rows(tile_ids, n_live, tile_n, qvals.device)
    return _pruned(scan_topk_int8_reference(qvals[rows], scales[rows],
                                            queries, valid[rows], k), rows)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _stages(itemsize: int, qb: int) -> int:
    """Stage buffers of the tensor-core route: int8 rows in blocks of 8
    queries keep two stages in flight, the others one."""
    return 3 if itemsize == 1 and qb == 8 else 2


def _int8_extra(itemsize: int) -> int:
    """Shared memory only the int8 route takes: merge_ranked's slots and
    each stage's row scales (f32) and valid flags (bytes)."""
    return _RANKED_SLOTS + 3 * _TILE_ROWS * 5 if itemsize == 1 else 0


def _mma_slab_most(d: int, qb: int, k: int, span: int,
                   itemsize: int = 2) -> int:
    """The widest slab (16-bit units, a multiple of 16) whose stage
    buffers fit the tensor-core route's shared memory beside ``qb``
    staged queries of ``d`` units, their scores, lists and screen flags,
    and what the int8 route (``itemsize`` 1) adds; below 16 nothing
    fits."""
    free = _SMEM_MAX - (qb * (_up(d, 16) + 8) * 2 + qb * (span + 4) * 4
                        + qb * k * 8 + qb * 4 + _int8_extra(itemsize))
    return (free // (_stages(itemsize, qb) * _TILE_ROWS * 2) - 8) // 16 * 16


def _units(d: int, itemsize: int) -> int:
    """A row's width in the tensor-core route's 16-bit units: an int8
    row of d values is d / 2 pairs."""
    return d * itemsize // 2


def _merged(itemsize: int, span: int) -> bool:
    """bf16/f16 rows of K1, K3 and K8: scan_pass1_merged's route (K9,
    span 256, keeps the tensor-core route of the int8 rows)."""
    return itemsize == 2 and span == _TILE_ROWS


def _mergers(qb: int) -> int:
    """scan_pass1_merged's merger warps for a block of ``qb`` queries
    (``Merged<QB>::kMergers``): one a query in a block of 8, else 16."""
    return 8 if qb == 8 else 16


def _merged_fixed(d: int, qb: int, k: int, nb: int) -> int:
    """scan_pass1_merged's shared memory beside its two stage buffers:
    ``qb`` queries of ``d`` units, ``nb`` score buffers, the lists of k,
    the queues, the thresholds, the queues' counts, ``nb`` flag sets and
    the mergers' placement scratch."""
    return (qb * (_up(d, 16) + 8) * 2 + nb * qb * _SCORE_STRIDE * 4
            + qb * k * 8 + qb * _QUEUE * 8 + qb * 8 + nb * qb * 4
            + _mergers(qb) * -(-k // 32) * 4)


def _merged_smem(d: int, qb: int, k: int, nb: int, slab: int) -> int:
    """scan_pass1_merged's shared memory with slabs of ``slab`` units."""
    return _merged_fixed(d, qb, k, nb) + 2 * _TILE_ROWS * (slab + 8) * 2


def _even_slab(d: int, most: int) -> int:
    """A row of ``d`` units (padded to 16) in as few slabs of at most
    ``most`` units as fit, of equal width rounded up to 16 units."""
    dp = _up(d, 16)
    return _up(-(-dp // -(-dp // most)), 16)


def _per_sm(smem: int) -> int:
    """Blocks of pass 1 one SM holds: two where two fit, else one."""
    return 2 if 2 * (smem + _SMEM_RESERVED) <= _SM_SMEM else 1


@functools.lru_cache(maxsize=1024)
def merge_layout(d: int, k: int, nq: int) -> tuple:
    """(query block, score buffers, slab units) of scan_pass1_merged for
    a bf16/f16 row of ``d``: the lists' room sets the query block, the
    most of 64, 32, 16 and 8 (8 for a batch of 8 or fewer) beside whose
    lists, queries, queues and one score buffer a slab of 64 units fits
    (at d 384: 64 up to k 128, 32 at k 256 and 512, 16 at k 1,024); a
    second score buffer, which lets the scorers run a tile ahead of the
    mergers, where it costs neither a slab nor an SM's second block; the
    row in as few equal slabs as fit (0: not even a slab of 16)."""
    def most(qb, nb):
        free = _SMEM_MAX - _merged_fixed(d, qb, k, nb)
        return (free // (2 * _TILE_ROWS * 2) - 8) // 16 * 16
    blocks = _MERGED_BLOCKS if nq > 8 else (8,)
    qb = next((b for b in blocks if most(b, 1) >= 64), 8)
    if most(qb, 1) < 16:
        return qb, 1, 0
    slab = _even_slab(d, most(qb, 1))
    if most(qb, 2) >= 16 and _even_slab(d, most(qb, 2)) == slab and (
            _per_sm(_merged_smem(d, qb, k, 2, slab))
            == _per_sm(_merged_smem(d, qb, k, 1, slab))):
        return qb, 2, slab
    return qb, 1, slab


def _wgmma_fixed(d: int, qb: int, k: int, nb: int) -> int:
    """The wgmma route's shared memory beside its ring: the alignment, the
    ``qb`` queries in slabs of 64 values (128 bytes a query), and what
    :func:`_merged_fixed` counts beside its queries."""
    slabs = -(-_up(d, 16) // 64)
    return (_RING_ALIGN + slabs * qb * 128
            + _merged_fixed(d, qb, k, nb) - qb * (_up(d, 16) + 8) * 2)


def _wgmma_smem(d: int, qb: int, k: int, nb: int, stages: int) -> int:
    """The wgmma route's shared memory with a ring of ``stages`` (each a
    box of 64 rows x 128 bytes and its full and empty mbarriers)."""
    return _wgmma_fixed(d, qb, k, nb) + stages * (_RING_STAGE + 16)


@functools.lru_cache(maxsize=1024)
def wgmma_layout(d: int, k: int, nq: int):
    """(query block, score buffers, ring stages) of the wgmma route of K1
    and K8 over a whole bf16/f16 store (``csrc/scan_topk.cu:
    wgmma_scorers``), or None where the plan keeps the mma.sync scorers:
    a batch of 8 or fewer (one n8 tile), a row narrower than a TMA box
    (64 values), or where no block of 32 or 64 leaves room for
    ``_RING_MIN`` stages. The block is 32 for a batch of
    32 or fewer, else 64 where it fits (the store read once per 64
    queries), else 32; a second score buffer where a fourth stage still
    fits beside it; the ring takes the rest of the block's shared memory,
    so one block holds an SM (800 threads of up to 80 registers). Each
    score buffer has a consumer warpgroup of its own (two take alternate
    tiles)."""
    if nq <= 8 or d < _TILE_ROWS:
        return None
    room = lambda qb, nb: ((_SMEM_MAX - _wgmma_fixed(d, qb, k, nb))
                           // (_RING_STAGE + 16))
    for qb in _WG_BLOCKS if nq > 32 else _WG_BLOCKS[1:]:
        if room(qb, 1) >= _RING_MIN:
            nb = 2 if room(qb, 2) >= _RING_MIN + 1 else 1
            return qb, nb, room(qb, nb)
    return None


def _query_block(d: int, itemsize: int, k: int, nq: int,
                 span: int = _TILE_ROWS) -> int:
    """Queries one block of pass 1 takes. bf16/f16 rows of K1, K3 and
    K8: :func:`merge_layout`'s. int8 rows and K9's bf16/f16 (the
    tensor-core route): 64 for a batch of more than 8 at k <= 128 where
    slabs of at least 64 units fit beside them, so that the store is read
    once per 64 queries; else 8, one n8 tile of the mma. f32 rows (the
    SIMT route): 16 at k <= 128, else 4."""
    if _merged(itemsize, span):
        return merge_layout(d, k, nq)[0]
    if itemsize in (1, 2):
        wide = nq > 8 and k <= 128 and _mma_slab_most(
            _units(d, itemsize), 64, k, span, itemsize) >= 64
        return 64 if wide else 8
    return 16 if k <= 128 else 4


def slab_words(d: int, itemsize: int, k: int, nq: int,
               span: int = _TILE_ROWS) -> int:
    """32-bit words of each row that pass 1 stages at a time (0: nothing
    fits), beside the queries, the scores of a merge's ``span`` rows (K9's
    is longer) and the lists. ``itemsize`` 1 is an int8 store.

    bf16/f16/int8 (the tensor-core route, two or three stage buffers):
    the row, padded with zeros to a multiple of 16 units (16 values; 32
    for int8), in as few slabs as fit, of equal width rounded up to 16
    units. f32 (the SIMT route, one buffer): the whole row where it
    fits, else the most that fit, a multiple of 4. bf16/f16 rows of K1,
    K3 and K8: :func:`merge_layout`'s slab."""
    if _merged(itemsize, span):
        return merge_layout(d, k, nq)[2] // 2
    qb = _query_block(d, itemsize, k, nq, span)
    if itemsize in (1, 2):
        du = _units(d, itemsize)
        most = _mma_slab_most(du, qb, k, span, itemsize)
        return 0 if most < 16 else _even_slab(du, most) // 2
    free = _SMEM_MAX - (qb * d * 4 + qb * span * 4 + qb * k * 8)
    return max(0, min(d, (free // (_TILE_ROWS * 4) - 1) // 4 * 4))


def pass1_smem_bytes(d: int, itemsize: int, k: int, nq: int,
                     span: int = _TILE_ROWS) -> int:
    """Dynamic shared memory of pass 1 (mirrors csrc/scan_topk.cu, whose
    launch refuses a plan that differs)."""
    if _merged(itemsize, span):
        qb, nb, slab = merge_layout(d, k, nq)
        return _merged_smem(d, qb, k, nb, slab)
    qb = _query_block(d, itemsize, k, nq, span)
    words = slab_words(d, itemsize, k, nq, span)
    if itemsize in (1, 2):
        return (qb * (_up(_units(d, itemsize), 16) + 8) * 2
                + _stages(itemsize, qb) * _TILE_ROWS * (2 * words + 8) * 2
                + qb * (span + 4) * 4 + qb * k * 8 + qb * 4
                + _int8_extra(itemsize))
    return (qb * d * 4 + _TILE_ROWS * (words + 1) * 4
            + qb * span * 4 + qb * k * 8)


def chunk_plan(n: int, nq: int, qb: int, sms: int, smem: int,
               select_k: int = 0, per_sm: int = 0):
    """(rows per chunk, chunks) for ``nq`` queries in blocks of ``qb``:
    split N so that the blocks of pass 1 (``smem`` bytes of shared memory
    each) fill the card once and no more, two an SM where two fit, else
    one, whatever Q is (Q=1 at query time): a second wave of a few blocks
    would run alone, and shorter chunks only restart more lists. The grid
    runs the query blocks of one chunk side by side, so that they read
    its rows from L2 at about the same time.

    ``select_k``, the int8 route's k (0 for the others): with one query
    block, at most N / (4 k) chunks, so that at most a quarter of the
    rows scanned become pass 2's candidates. At one gte-large query the
    one-wave plan cut an IVF probe of 64 tiles into 256 chunks of 128
    rows: at k 128 every live row was a candidate, pass 1 inserted each
    one and pass 2 merged them all (0.38 of K4b's 0.50 device ms on an
    H100, by chip_smoke.py's profile of the path). Longer chunks leave pass 1 a real
    selection, which merge_ranked makes in one step a tile, and a block
    of 512 rows still streams its 512 KB at about the rate a share of
    the card's memory gives it. The bf16/f16/f32 routes keep the
    one-wave plan. ``per_sm``: the blocks an SM holds where something
    other than shared memory sets it (0: by ``smem``)."""
    per_sm = per_sm or _per_sm(smem)
    q_blocks = -(-nq // qb)
    tiles = -(-n // _TILE_ROWS)
    chunks = max(1, min(tiles, per_sm * sms // q_blocks))
    if select_k and q_blocks == 1:
        chunks = max(1, min(chunks, n // (4 * select_k)))
    rows = -(-tiles // chunks) * _TILE_ROWS
    return rows, -(-n // rows)


def pass2_warps(chunks: int, k: int) -> int:
    """Warps of pass 2's block for one query: min(32, chunks, 4096 / k).
    Each merges a run of consecutive chunk lists (``run_bounds``), then
    the runs' lists merge in a tree; a warp's three lists of k take 24 k
    bytes of shared memory, 96 KB for the block at most."""
    return max(1, min(_PASS2_MAX_WARPS, chunks, _PASS2_SLOTS // k))


def run_bounds(chunks: int, warps: int) -> list:
    """The runs of pass 2: warp w merges chunks [b[w], b[w + 1])."""
    return [w * chunks // warps for w in range(warps + 1)]


def _before(s1, i1, s2, i2):
    """The order of every list: a higher score first, then a lower id."""
    return (s1 > s2) | ((s1 == s2) & (i1 < i2))


def merge_lists_reference(a_s, a_i, b_s, b_i):
    """Plain version of the kernel's ``merge_lists``: the first k entries
    of the union of two (Q, k) lists sorted by ``_before``, each finite
    entry placed at its index plus the entries of the other list that
    come before it; the slots past the finite entries are -inf, id 0."""
    nq, k = a_s.shape
    out_s = a_s.new_full((nq, k), float("-inf"))
    out_i = a_i.new_zeros((nq, k))
    index = torch.arange(k, device=a_s.device)[None, :]
    row = torch.arange(nq, device=a_s.device)[:, None].expand(nq, k)
    for xs, xi, ys, yi in ((a_s, a_i, b_s, b_i), (b_s, b_i, a_s, a_i)):
        ahead = _before(ys[:, None, :], yi[:, None, :], xs[:, :, None],
                        xi[:, :, None]).sum(-1)
        pos = index + ahead
        keep = ~torch.isneginf(xs) & (pos < k)
        out_s[row[keep], pos[keep]] = xs[keep]
        out_i[row[keep], pos[keep]] = xi[keep]
    return out_s, out_i


def _flush_model(ls, li, qv, qi):
    """``flush_queue`` on numpy arrays: the queue (qv, qi) sorted by
    ``_before``, each entry of the list and of the sorted queue placed at
    its index plus the entries of the other before it, slots k and past
    dropped."""
    k = len(ls)
    order = np.lexsort((qi, -qv))
    qv, qi = qv[order], qi[order]
    qpos = np.arange(len(qv)) + _before(ls[None, :], li[None, :],
                                        qv[:, None], qi[:, None]).sum(1)
    lpos = np.arange(k) + _before(qv[None, :], qi[None, :],
                                  ls[:, None], li[:, None]).sum(1)
    out_s = np.full(k, -np.inf, dtype=np.float32)
    out_i = np.zeros(k, dtype=np.int64)
    for pos, s, i in ((lpos, ls, li), (qpos, qv, qi)):
        keep = pos < k
        out_s[pos[keep]], out_i[pos[keep]] = s[keep], i[keep]
    return out_s, out_i


def pass1_merge_reference(scores: torch.Tensor, ids: torch.Tensor, k: int,
                          rows_per_chunk: int, warm: torch.Tensor = None,
                          queue: int = _QUEUE, flush_rounds=(),
                          refresh: bool = True):
    """Plain model of the bf16/f16 route's pass-1 merge
    (``scan_pass1_merged``), query by query and chunk by chunk as the
    kernel's mergers make it. ``scores`` (Q, N) f32 in scan order, masked
    rows -inf; ``ids`` (N,) the rows' ids (physical rows of a pruned
    scan); ``warm`` K8's (Q,) thresholds or None. Each chunk of
    ``rows_per_chunk`` rows starts a list of k at -inf (id 0) and the
    threshold at the warm one (-inf); its rows go in rounds of 32 (half a
    tile): the round's scores above the threshold join the query's queue
    in row order, except that a round that does not fit the queue's
    ``queue`` entries flushes the queue first, and the round is screened
    again at the threshold that flush leaves, max(the list's k-th, warm)
    (the warm one alone where ``refresh`` is False). A flush sorts the
    queue by ``_before`` and places each entry of it and of the list at
    its index plus the entries of the other before it, dropping slots k
    and past. The queue also flushes after each round (its index in the
    chunk) of ``flush_rounds`` and at the chunk's end, where it holds
    any. Returns the (Q, chunks, k) candidate lists pass 1 writes and
    (survivors queued, flushes), the kernel's merge counters."""
    s_all = scores.float().numpy()
    id_all = np.asarray(ids, dtype=np.int64)
    nq, n = s_all.shape
    chunks = -(-n // rows_per_chunk)
    cand_s = np.full((nq, chunks, k), -np.inf, dtype=np.float32)
    cand_i = np.zeros((nq, chunks, k), dtype=np.int64)
    queued = flushes = 0
    for q in range(nq):
        w = np.float32(-np.inf if warm is None else warm[q])
        for c in range(chunks):
            ls = np.full(k, -np.inf, dtype=np.float32)
            li = np.zeros(k, dtype=np.int64)
            qv, qi = np.zeros(0, np.float32), np.zeros(0, np.int64)
            thr = w
            lo, hi = c * rows_per_chunk, min(n, (c + 1) * rows_per_chunk)

            def flush():
                nonlocal ls, li, qv, qi, thr, flushes
                ls, li = _flush_model(ls, li, qv, qi)
                qv, qi = qv[:0], qi[:0]
                thr = max(ls[-1], w) if refresh else w
                flushes += 1
            for rnd, r0 in enumerate(range(lo, hi, 32)):
                seg = s_all[q, r0:min(r0 + 32, hi)]
                up = seg > thr
                if up.any() and len(qv) + up.sum() > queue:
                    flush()
                    up = seg > thr
                qv = np.concatenate([qv, seg[up]])
                qi = np.concatenate([qi, id_all[r0:r0 + len(seg)][up]])
                queued += int(up.sum())
                if rnd in flush_rounds and len(qv):
                    flush()
            if len(qv):
                flush()
            cand_s[q, c], cand_i[q, c] = ls, li
    return (torch.from_numpy(cand_s),
            torch.from_numpy(cand_i.astype(np.int32)), (queued, flushes))


def scan_pass2_reference(cand_s: torch.Tensor, cand_i: torch.Tensor,
                         qscale: torch.Tensor = None, runs=None):
    """Plain version of pass 2 (``scan_pass2``): (Q, chunks, k) candidate
    lists, each sorted by ``_before`` with -inf (id 0) past its rows, in
    scan order, and the int8 scans' per-query scales (Q,) or None → the
    merged (Q, k) scores and ids, scaled after the merge (-inf slots stay
    -inf, id 0). ``runs`` splits the chunks as the kernel's warps do
    (default ``run_bounds(chunks, pass2_warps(chunks, k))``): each run's
    lists merged in order, then the runs' lists pairwise in a tree, list
    i taking list i + s at step s."""
    nq, chunks, k = cand_s.shape
    if runs is None:
        runs = run_bounds(chunks, pass2_warps(chunks, k))
    lists = []
    for c0, c1 in zip(runs[:-1], runs[1:]):
        s = cand_s.new_full((nq, k), float("-inf"))
        i = cand_i.new_zeros((nq, k))
        for c in range(c0, c1):
            s, i = merge_lists_reference(s, i, cand_s[:, c], cand_i[:, c])
        lists.append((s, i))
    step = 1
    while step < len(lists):
        for a in range(0, len(lists) - step, 2 * step):
            lists[a] = merge_lists_reference(*lists[a], *lists[a + step])
        step *= 2
    s, i = lists[0]
    if qscale is not None:
        s = torch.where(torch.isneginf(s), s, s * qscale[:, None])
    return s, i.masked_fill(torch.isneginf(s), 0)


def _check(store, queries, valid, k, masked, dtypes=(torch.bfloat16,
                                                     torch.float16,
                                                     torch.float32),
           span=_TILE_ROWS):
    if store.device.type != "cuda":
        raise KernelError(f"the scan takes CPU or CUDA tensors, got "
                          f"{store.device}")
    if store.dim() != 2 or not store.is_contiguous():
        raise KernelError("store must be a contiguous (N, d) tensor")
    if store.dtype not in dtypes:
        raise KernelError(f"store dtype {store.dtype} not supported; "
                          f"{', '.join(str(t) for t in dtypes)}")
    n, d = store.shape
    if n < 1:
        raise KernelError("empty store")
    if (d * store.element_size()) % 16 or store.data_ptr() % 16:
        raise KernelError(f"store rows must be 16-byte multiples, d={d}")
    if queries.dim() != 2 or queries.shape[1] != d or queries.shape[0] < 1:
        raise KernelError(f"queries must be (Q, {d}), got "
                          f"{tuple(queries.shape)}")
    if queries.device != store.device:
        raise KernelError("queries and store lie on different devices")
    if masked and (valid.shape != (n,) or valid.dtype != torch.bool
                   or valid.device != store.device
                   or not valid.is_contiguous()):
        raise KernelError("valid must be a contiguous (N,) bool tensor on "
                          "the store's device")
    if not 1 <= k <= K_MAX:
        raise KernelError(f"k={k} outside [1, {K_MAX}]")
    if slab_words(d, store.element_size(), k, queries.shape[0], span) < 4:
        raise KernelError(f"d={d} at {store.dtype}, k={k}, Q="
                          f"{queries.shape[0]}: the queries and lists alone "
                          "fill the scan's shared memory")


def _check_int8(qvals, scales, queries, valid, k):
    _check(qvals, queries, valid, k, True, dtypes=(torch.int8,))
    n = qvals.shape[0]
    if (scales.shape != (n,) or scales.dtype != torch.float32
            or scales.device != qvals.device or not scales.is_contiguous()):
        raise KernelError("scales must be a contiguous (N,) f32 tensor on "
                          "the store's device")


def _check_tiles(tile_ids, n_live: int, tile_n: int, n: int) -> np.ndarray:
    tiles = np.asarray(tile_ids)
    if tiles.ndim != 1 or not 1 <= n_live <= len(tiles):
        raise KernelError(f"n_live={n_live} with {tiles.shape} tile ids")
    if tile_n % _TILE_ROWS or tile_n < _TILE_ROWS:
        raise KernelError(f"tile_n={tile_n} must be a multiple of "
                          f"{_TILE_ROWS}")
    live = tiles[:n_live].astype(np.int64)
    if (live[1:] <= live[:-1]).any():
        raise KernelError("live tile ids must be strictly increasing, as "
                          "ops/ivf.py:select_tiles gives them: equal "
                          "scores keep the lower row id")
    if live[0] < 0 or (int(live[-1]) + 1) * tile_n > n:
        raise KernelError(f"tile ids outside the store's {n // tile_n} "
                          "whole tiles")
    return live.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _merged_warps(qb: int) -> int:
    """The warps of a scan_pass1_merged block of ``qb`` queries
    (``Merged<QB>::kThreads / 32``): its scorers (4 row groups x qb / 32
    or qb / 8 query groups), at least 8 warps that copy, and its mergers."""
    scorers = 4 * (qb // (32 if qb >= 32 else 8))
    return max(8, scorers) + _mergers(qb)


def one_launch(nq: int, itemsize: int, span: int = _TILE_ROWS) -> bool:
    """Whether a scan of ``nq`` queries over rows of ``itemsize`` bytes
    may take the one-launch route, pass 2's merge in the last block of
    pass 1 (``csrc/scan_topk.cu:scan_pass1_merged``): bf16/f16 rows of K1,
    K3 and K8 at one query. The plan takes it where the merge fits
    (:func:`one_launch_fits`)."""
    return _merged(itemsize, span) and nq <= _ONE_LAUNCH_MAX_Q


def one_launch_warps(chunks: int, k: int, smem: int, qb: int) -> int:
    """Warps of the one-launch route's merge: pass 2's rule
    (:func:`pass2_warps`) within the merging block's warps and its shared
    memory (three lists of k a warp, 24 k bytes)."""
    return max(1, min(_merged_warps(qb), chunks, _PASS2_SLOTS // k,
                      smem // (24 * k)))


def one_launch_fits(chunks: int, k: int, smem: int, warps: int) -> bool:
    """The last block's merge fits pass 1's ``smem`` bytes: its warps'
    lists (24 k bytes a warp) beside a query's ``chunks`` lists, which it
    copies in first (8 k bytes a list)."""
    return 24 * warps * k + chunks * k * 8 <= smem


def workspace_layout(nq: int, k: int, chunks: int, n_tiles: int, d: int,
                     int8: bool) -> dict:
    """The pieces of a scan call's one device allocation, {name: (byte
    offset, bytes)}, in ``csrc/scan_topk.cu:carve``'s order, each rounded
    up to 16 bytes: the (Q, k) scores and ids returned, the (Q, chunks, k)
    candidates of pass 1, a pruned scan's tile ids (staged from the host),
    an int8 scan's quantized queries (Q, d) and their scales (Q,);
    ``"total"`` is (0, the allocation's bytes)."""
    sizes = (("out_s", nq * k * 4), ("out_i", nq * k * 4),
             ("cand_s", nq * chunks * k * 4), ("cand_i", nq * chunks * k * 4),
             ("tiles", n_tiles * 4), ("qbuf", nq * d if int8 else 0),
             ("qscale", nq * 4 if int8 else 0))
    out, at = {}, 0
    for name, nbytes in sizes:
        out[name] = (at, nbytes)
        at += _up(nbytes, 16)
    out["total"] = (0, at)
    return out


class ScanPlan(NamedTuple):
    """One scan shape's launch: pass 1's query block, rows per chunk, words
    per slab, chunks, score buffers and shared memory; the merge's warps
    (pass 2's, or the one-launch route's); whether it is one launch; the
    workspace's bytes and where the returned ids start in it (f32 words);
    the wgmma route's ring stages (0: the mma.sync scorers)."""
    qb: int
    rows: int
    words: int
    chunks: int
    warps2: int
    nb: int
    smem: int
    one: bool
    ws_bytes: int
    out_i: int
    stages: int = 0


@functools.lru_cache(maxsize=4096)
def _plan(n: int, nq: int, d: int, isz: int, k: int, span: int, sms: int,
          n_tiles: int = 0) -> ScanPlan:
    """The :class:`ScanPlan` of one scan shape: a pure function of it,
    planned once. bf16/f16 rows of a whole store (K1, K8) of at least a
    TMA box's 64 rows take the wgmma route where :func:`wgmma_layout`
    plans one and each block's chunk streams at least ``_WG_MIN_SLABS``
    slabs of 64 values; a tile list (K3) and the rest keep their
    routes."""
    wg = (_merged(isz, span) and not n_tiles and n >= _TILE_ROWS
          and wgmma_layout(d, k, nq))
    if wg:
        qb, nb, stages = wg
        smem = _wgmma_smem(d, qb, k, nb, stages)
        words = _TILE_ROWS // 2     # a ring stage's 64 values of a row
        # 800 threads of up to 80 registers fill an SM's registers,
        # whatever the ring leaves of shared memory: one block an SM
        rows, chunks = chunk_plan(n, nq, qb, sms, smem, per_sm=1)
        if rows // _TILE_ROWS * -(-_up(d, 16) // 64) < _WG_MIN_SLABS:
            wg = None
    if not wg:
        qb, stages = _query_block(d, isz, k, nq, span), 0
        smem = pass1_smem_bytes(d, isz, k, nq, span)
        words = slab_words(d, isz, k, nq, span)
        nb = merge_layout(d, k, nq)[1] if _merged(isz, span) else 1
        rows, chunks = chunk_plan(n, nq, qb, sms, smem,
                                  select_k=k if isz == 1 else 0)
    warps2 = one_launch_warps(chunks, k, smem, qb)
    one = one_launch(nq, isz, span) and one_launch_fits(chunks, k, smem,
                                                        warps2)
    if not one:
        warps2 = pass2_warps(chunks, k)
    layout = workspace_layout(nq, k, chunks, n_tiles, d, isz == 1)
    return ScanPlan(qb, rows, words, chunks, warps2, nb, smem, one,
                    layout["total"][1], layout["out_i"][0] // 4, stages)


def plan_on(device, n: int, nq: int, d: int, isz: int, k: int,
            span: int = _TILE_ROWS, n_tiles: int = 0) -> ScanPlan:
    """The :class:`ScanPlan` of a scan on CUDA ``device``: :func:`_plan`
    with that card's SMs."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _plan(n, nq, d, isz, k, span, _sm_count(index), n_tiles)


def _launch(store, q, valid, k, *, row_scale=None, tiles=None, tile_n=0,
            thr0=None, fold=False, stats=None):
    """The scan on the current stream of the store's card; returns (Q, k)
    scores and ids. ``q`` is in the store dtype, or f32: an int8 scan's
    (the kernel quantizes it per row and scales the merged scores by the
    query's scale), or a bf16/f16 scan's (pass 1 rounds it to the store
    dtype as it stages it); ``tiles`` a pruned scan's int32 host array of
    live tile ids; ``thr0`` K8's (Q,) thresholds; ``fold`` K9 (no mask, no
    tiles). ``stats``, a (2,) int64 tensor or None, gains K9's spans
    merged and those merged on the fast path, or the bf16/f16 route's
    survivors queued and flushes (those of :func:`pass1_merge_reference`
    on the kernel's scores).

    A call makes one device allocation (:func:`workspace_layout`), whose
    first two pieces it returns; the entry point stages the tile list
    through a pinned buffer of the card's, sets each kernel's
    shared-memory limit once per card, and launches pass 1 and pass 2, or
    pass 1 alone where it merges in its last block (:func:`one_launch`)."""
    lib = _cuda.library("scan_topk", _SIGNATURES)
    q = _cuda.aligned(q)
    dev = store.device
    nq, d = q.shape
    n_tiles = 0 if tiles is None else len(tiles)
    n = store.shape[0] if tiles is None else n_tiles * tile_n
    isz, span = store.element_size(), _FOLD_SPAN if fold else _TILE_ROWS
    p = plan_on(dev, n, nq, d, isz, k, span, n_tiles)
    ws = torch.empty(p.ws_bytes // 4, dtype=torch.float32, device=dev)
    plan = (_DTYPE_CODES[store.dtype], p.qb, p.rows, p.words, p.chunks,
            p.warps2)
    ptr = lambda t: None if t is None else t.data_ptr()
    if fold:
        err = _cuda.launch(
            lib.sema_fold_topk, dev, store.data_ptr(), q.data_ptr(),
            n, d, nq, k, *plan, p.smem, ws.data_ptr(), p.ws_bytes,
            ptr(stats))
    else:
        err = _cuda.launch(
            lib.sema_scan_topk, dev, store.data_ptr(), q.data_ptr(),
            q.dtype != store.dtype, ptr(valid), ptr(row_scale),
            None if tiles is None else tiles.ctypes.data, n_tiles, tile_n,
            n, d, nq, k, *plan, p.nb, p.stages, p.smem, p.one,
            ws.data_ptr(), p.ws_bytes, ptr(thr0), ptr(stats))
    _cuda.check(lib, err, "fold_topk" if fold else "scan_topk")
    return (ws[:nq * k].view(nq, k),
            ws[p.out_i:p.out_i + nq * k].view(torch.int32).view(nq, k))


def _query(queries: torch.Tensor, store: torch.Tensor) -> torch.Tensor:
    """The queries a bf16/f16/f32 scan takes: f32 as they are (a 16-bit
    store's pass 1 rounds them as it stages them, where a cast would launch
    a kernel of its own), any other dtype cast to the store's."""
    return queries if queries.dtype == torch.float32 else queries.to(
        store.dtype)


def scan_topk(store: torch.Tensor, queries: torch.Tensor,
              valid: torch.Tensor, k: int, masked: bool = True,
              warm_rows: int = 0):
    """K1: exact top-k of a bf16/f16/f32 store (see the module
    docstring); ``warm_rows > 0`` is K8, :func:`scan_topk_warm`. CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if warm_rows > 0:
        return scan_topk_warm(store, queries, valid, k, warm_rows, masked)
    if store.device.type == "cpu":
        return scan_topk_reference(store, queries, valid, k, masked=masked)
    _check(store, queries, valid, k, masked)
    out = _launch(store, _query(queries, store), valid if masked else None, k)
    scan_topk.launches += 1
    return out


def scan_topk_warm(store: torch.Tensor, queries: torch.Tensor,
                   valid: torch.Tensor, k: int, warm_rows: int,
                   masked: bool = True):
    """K8: K1's result, each query's screen started at one ULP below the
    k-th best score of the first ``warm_rows`` rows (clamped to N;
    ValueError when that is fewer than k rows). The threshold comes from
    the kernel's own scores of those rows, both passes over
    ``store[:w]``, inside this one call. CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    w = _warm_rows(warm_rows, store.shape[0], k)
    if store.device.type == "cpu":
        return scan_topk_warm_reference(store, queries, valid, k, w,
                                        masked=masked)
    _check(store, queries, valid, k, masked)
    q = _query(queries, store)
    live = valid if masked else None
    sample = _launch(store[:w], q, None if live is None else live[:w], k)
    out = _launch(store, q, live, k, thr0=warm_threshold(sample[0][:, -1]))
    scan_topk_warm.launches += 1
    return out


def fold_topk(store: torch.Tensor, queries: torch.Tensor, k: int,
              stats: torch.Tensor = None):
    """K9: K1's result without a mask (every row live), each span of rows
    merged through the per-lane fold of scan A/B #14. The TPU version's
    ``tile_n`` is its grid's tile and changes no result; this one takes
    none, as :func:`scan_topk` takes none, and N need not be a multiple
    of anything. ``stats``, a (2,) int64 CUDA tensor, gains the spans
    merged and those that took the fast path. CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    if store.device.type == "cpu":
        return fold_topk_reference(store, queries, k)
    _check(store, queries, None, k, False, span=_FOLD_SPAN)
    if stats is not None and (stats.shape != (2,)
                              or stats.dtype != torch.int64
                              or stats.device != store.device):
        raise KernelError("stats must be a (2,) int64 tensor on the "
                          "store's device")
    out = _launch(store, queries.to(store.dtype), None, k, fold=True,
                  stats=stats)
    fold_topk.launches += 1
    return out


def scan_topk_int8(qvals: torch.Tensor, scales: torch.Tensor,
                   queries: torch.Tensor, valid: torch.Tensor, k: int):
    """K4a: exact top-k of an int8 store, ``queries`` f32 (quantized
    here). CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if qvals.device.type == "cpu":
        return scan_topk_int8_reference(qvals, scales, queries, valid, k)
    _check_int8(qvals, scales, queries, valid, k)
    out = _launch(qvals, queries.float(), _cuda.aligned(valid), k,
                  row_scale=_cuda.aligned(scales))
    scan_topk_int8.launches += 1
    return out


def scan_topk_pruned(store: torch.Tensor, queries: torch.Tensor,
                     valid: torch.Tensor, tile_ids, n_live: int, k: int,
                     tile_n: int):
    """K3: top-k of a bf16/f16/f32 store over ``tile_ids[:n_live]``.
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if store.device.type == "cpu":
        return scan_topk_pruned_reference(store, queries, valid, tile_ids,
                                          n_live, k, tile_n)
    _check(store, queries, valid, k, True)
    tiles = _check_tiles(tile_ids, n_live, tile_n, store.shape[0])
    out = _launch(store, _query(queries, store), valid, k, tiles=tiles,
                  tile_n=tile_n)
    scan_topk_pruned.launches += 1
    return out


def scan_topk_int8_pruned(qvals: torch.Tensor, scales: torch.Tensor,
                          queries: torch.Tensor, valid: torch.Tensor,
                          tile_ids, n_live: int, k: int, tile_n: int):
    """K4b: top-k of an int8 store over ``tile_ids[:n_live]``. CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if qvals.device.type == "cpu":
        return scan_topk_int8_pruned_reference(
            qvals, scales, queries, valid, tile_ids, n_live, k, tile_n)
    _check_int8(qvals, scales, queries, valid, k)
    tiles = _check_tiles(tile_ids, n_live, tile_n, qvals.shape[0])
    out = _launch(qvals, queries.float(), _cuda.aligned(valid), k,
                  row_scale=_cuda.aligned(scales), tiles=tiles, tile_n=tile_n)
    scan_topk_int8_pruned.launches += 1
    return out


for _fn in (scan_topk, scan_topk_int8, scan_topk_pruned,
            scan_topk_int8_pruned, scan_topk_warm, fold_topk):
    _fn.launches = 0
