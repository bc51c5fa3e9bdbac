"""Pass 2 of the port's scans and the int8 route's plan.

``sema_tpu_torch.ops.scan_topk.scan_pass2_reference`` is the plain version
of the kernels' pass 2: runs of chunk lists merged by the warps of a
block, then the runs' lists merged in a tree, each merge ranking entries
by "higher score first, then lower row id". It is held here, on candidate
lists cut chunk by chunk from the int8 scan's plain scores, against the
sequential merge that the TPU kernel performs (insertion after equals),
for any split of the chunks into runs; against the selection over the
whole range; and against the JAX package's Pallas int8 scans in
interpret mode, bit for bit. The ties of the cases cross chunk
boundaries. Then the int8 route's query blocks, shared memory and chunk
plan, and pass 2's warps.

Then pass 1's merge of the bf16/f16 route (K1, K3, K8 on the card:
``scan_pass1_merged``), whose plain model is ``pass1_merge_reference``:
survivors queued 32 columns at a time above a threshold refreshed only
at flushes, a queue flushed when a round does not fit and at the chunk's
end, each flush sorted and placed by rank. It is held, for any queue
size from 32 to k, any extra flush points and a threshold never
refreshed at all, against the sequential merge row by row (insertion
after equals), against ``scan_topk_reference`` and its warm and pruned
versions, and against the JAX package's ``pallas_topk`` and
``pallas_topk_pruned`` in interpret mode, bit for bit, on bf16 rows of
whole numbers (exact scores in any order: many ties, within a round,
across tiles and across chunks). Then the route's query blocks: each
fits shared memory, and the lists' room sets it."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sema_tpu.ops.pallas_topk import (pallas_topk, pallas_topk_int8,
                                      pallas_topk_int8_pruned,
                                      pallas_topk_pruned)
from sema_tpu.ops.quant import quantize_rows
from sema_tpu_torch.ops.quant import int8_dot, quantize_query

scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
TILE = 128
N = 1024
TIE = [7 + 60 * j for j in range(17)]     # rows equal to row 7, 60 apart


def _case(seed=0, live=None):
    """int8 rows with a 17-way tie spread over the store (so every chunk
    split below cuts it), tombstones, and queries: query 1 equals row 7,
    query 4 is zero (every live row scores 0)."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((N, 64)).astype(np.float32)
    rows[TIE[1:]] = rows[TIE[0]]
    valid = rng.random(N) > 0.2
    valid[TIE] = True
    if live is not None:
        valid[:] = False
        valid[:live] = True
    queries = rng.standard_normal((5, 64)).astype(np.float32)
    queries[1] = rows[TIE[0]]
    queries[4] = 0.0
    qv, sc = quantize_rows(rows)
    return qv, sc, queries, valid


def _scores(qv, sc, queries, valid, rows=None):
    """The int8 scan's plain scores (before the query's scale) of the
    rows ``rows`` (default all) in scan order, and the query scales."""
    qi, qscale = quantize_query(torch.from_numpy(queries))
    idx = torch.arange(N) if rows is None else rows
    s = int8_dot(qi, torch.from_numpy(qv)[idx]) * torch.from_numpy(sc)[idx]
    return s.masked_fill(~torch.from_numpy(valid)[idx], float("-inf")), qscale


def _cut(scores, k, chunk_rows, ids=None):
    """(Q, chunks, k) candidate lists: each chunk of ``chunk_rows``
    columns selected as pass 1 leaves it, ids the rows ``ids`` (default
    the columns)."""
    n = scores.shape[1]
    ids = torch.arange(n) if ids is None else ids
    out_s, out_i = [], []
    for c in range(0, n, chunk_rows):
        s, i = scan_mod._select(scores[:, c:c + chunk_rows], k)
        i = ids[c:c + chunk_rows][i.long()].to(torch.int32)
        out_s.append(s)
        out_i.append(i.masked_fill(torch.isneginf(s), 0))
    return torch.stack(out_s, 1), torch.stack(out_i, 1)


def _sequential(cand_s, cand_i, qscale):
    """The TPU kernel's merge: chunk lists in scan order, each entry that
    beats the running k-th inserted after equal scores, a list left at its
    first entry that does not."""
    nq, chunks, k = cand_s.shape
    out_s = torch.full((nq, k), float("-inf"))
    out_i = torch.zeros((nq, k), dtype=torch.int32)
    for q in range(nq):
        ls, li = [float("-inf")] * k, [0] * k
        for c in range(chunks):
            for s, i in zip(cand_s[q, c].tolist(), cand_i[q, c].tolist()):
                if not s > ls[-1]:
                    break
                p = sum(x >= s for x in ls)
                ls = ls[:p] + [s] + ls[p:-1]
                li = li[:p] + [i] + li[p:-1]
        out_s[q], out_i[q] = torch.tensor(ls), torch.tensor(li)
    fin = ~torch.isneginf(out_s)
    out_s = torch.where(fin, out_s * qscale[:, None], out_s)
    return out_s, out_i.masked_fill(~fin, 0)


def _splits(chunks, seed):
    """Run boundaries: the kernel's for every warp count, and random ones."""
    out = [scan_mod.run_bounds(chunks, w) for w in range(1, chunks + 1)]
    rng = np.random.default_rng(seed)
    for _ in range(4):
        cuts = sorted(rng.choice(np.arange(1, chunks), size=min(
            chunks - 1, int(rng.integers(1, 6))), replace=False).tolist())
        out.append([0] + cuts + [chunks])
    return out


def _equal(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k,chunk_rows", [(1, 64), (5, 64), (16, 128),
                                          (17, 64), (64, 256), (128, 128)])
def test_any_split_into_runs_gives_the_sequential_merge(k, chunk_rows):
    qv, sc, queries, valid = _case()
    scores, qscale = _scores(qv, sc, queries, valid)
    cand = _cut(scores, k, chunk_rows)
    want = _sequential(*cand, qscale)
    for runs in _splits(cand[0].shape[1], k):
        got = scan_mod.scan_pass2_reference(*cand, qscale, runs=runs)
        assert _equal(got, want), runs
    # the 17-way tie across chunk boundaries, in row order
    t = min(k, len(TIE))
    assert want[1][1, :t].tolist() == TIE[:t]


@pytest.mark.parametrize("k,chunk_rows", [(1, 64), (16, 64), (100, 128),
                                          (128, 64)])
def test_pass2_equals_the_selection_over_the_whole_range(k, chunk_rows):
    qv, sc, queries, valid = _case(seed=1)
    scores, qscale = _scores(qv, sc, queries, valid)
    got = scan_mod.scan_pass2_reference(*_cut(scores, k, chunk_rows), qscale)
    want = scan_mod.scan_topk_int8_reference(
        *(torch.from_numpy(a) for a in (qv, sc, queries, valid)), k)
    assert _equal(got, want)


@pytest.mark.parametrize("k", [1, 16, 100, 128])
def test_pass2_bit_equal_to_pallas_int8(k):
    qv, sc, queries, valid = _case(seed=2)
    scores, qscale = _scores(qv, sc, queries, valid)
    got = scan_mod.scan_pass2_reference(*_cut(scores, k, 64), qscale)
    want = pallas_topk_int8(jnp.asarray(qv), jnp.asarray(sc),
                            jnp.asarray(queries), jnp.asarray(valid), k,
                            tile_n=TILE, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    t = min(k, len(TIE))
    assert got[1][1, :t].tolist() == TIE[:t]
    # the zero query: every live row ties at 0, in row order
    assert got[1][4, :t].tolist() == np.flatnonzero(valid)[:t].tolist()


@pytest.mark.parametrize("k,n_live", [(16, 6), (100, 3), (128, 8)])
def test_pass2_bit_equal_to_pallas_int8_pruned(k, n_live):
    qv, sc, queries, valid = _case(seed=3)
    rng = np.random.default_rng(4)
    live = np.sort(np.concatenate([[0], rng.choice(
        np.arange(1, N // TILE), size=n_live - 1, replace=False)]))
    tiles = np.full(8, live[-1], dtype=np.int32)
    tiles[:n_live] = live
    rows = torch.as_tensor(live[:, None] * TILE + np.arange(TILE)[None, :]
                           ).reshape(-1)
    scores, qscale = _scores(qv, sc, queries, valid, rows)
    got = scan_mod.scan_pass2_reference(*_cut(scores, k, 64, rows), qscale)
    want = pallas_topk_int8_pruned(
        jnp.asarray(qv), jnp.asarray(sc), jnp.asarray(queries),
        jnp.asarray(valid), jnp.asarray(tiles),
        jnp.asarray([n_live], dtype=jnp.int32), k, tile_n=TILE,
        interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1][1, :2].tolist() == TIE[:2]     # both in tile 0


@pytest.mark.parametrize("k", [4, 16])
def test_pass2_masked_rows_and_k_above_the_live_rows(k):
    """Three live rows: every list is mostly -inf, and so is the merge."""
    qv, sc, queries, valid = _case(live=3)
    scores, qscale = _scores(qv, sc, queries, valid)
    cand = _cut(scores, k, 64)
    got = scan_mod.scan_pass2_reference(*cand, qscale)
    assert _equal(got, _sequential(*cand, qscale))
    assert torch.isneginf(got[0][:, 3:]).all() and not got[1][:, 3:].any()
    assert (got[1][:, :3].sort(1).values == torch.arange(3)).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_lists_is_the_union_in_order_whichever_list_comes_first(seed):
    """merge_lists ranks by score and id, not by which list an entry came
    from: both argument orders give the union's first k."""
    rng = np.random.default_rng(seed)
    k = 12
    vals = torch.from_numpy(np.round(rng.standard_normal((3, 2 * k)))
                            .astype(np.float32))
    ids = torch.stack([torch.randperm(100, generator=torch.Generator()
                                      .manual_seed(seed + q))[:2 * k]
                       for q in range(3)]).to(torch.int32)
    vals[:, -3:] = float("-inf")
    ids[:, -3:] = 0

    def sorted_list(s, i):
        key = torch.argsort(i.long(), stable=True)
        s, i = s.gather(1, key), i.gather(1, key)
        order = torch.argsort(s, dim=1, descending=True, stable=True)
        return s.gather(1, order), i.gather(1, order)
    a = sorted_list(vals[:, :k], ids[:, :k])
    b = sorted_list(vals[:, k:], ids[:, k:])
    ab = scan_mod.merge_lists_reference(*a, *b)
    ba = scan_mod.merge_lists_reference(*b, *a)
    both = sorted_list(vals, ids)
    want = (both[0][:, :k],
            both[1][:, :k].masked_fill(torch.isneginf(both[0][:, :k]), 0))
    assert _equal(ab, want) and _equal(ba, want)


@pytest.mark.parametrize("d,k,nq,qb", [
    (384, 16, 256, 64), (384, 128, 256, 64), (1024, 16, 256, 64),
    (1024, 128, 256, 64), (1024, 129, 256, 8), (1024, 1024, 256, 8),
    (1024, 128, 8, 8), (1024, 128, 1, 8), (384, 10, 1, 8)])
def test_int8_batch_query_block(d, k, nq, qb):
    """int8 rows take the tensor-core route's blocks: 64 queries for a
    batch at k <= 128 (a store read once per 64 queries), else 8; the
    row staged in equal slabs of whole k-steps (the last one padded with
    zeros), inside shared memory."""
    assert scan_mod._query_block(d, 1, k, nq) == qb
    slab, words = scan_mod.slab_words(d, 1, k, nq), d // 4
    slabs = -(-words // slab)
    assert slab >= 8 and slab % 8 == 0
    assert (slabs - 1) * slab < words <= slabs * slab
    assert scan_mod.pass1_smem_bytes(d, 1, k, nq) <= scan_mod._SMEM_MAX
    # one query block of 8: three stage buffers, two of them in flight
    assert scan_mod._stages(1, qb) == (3 if qb == 8 else 2)


@pytest.mark.parametrize("n,nq,k", [
    (31_232, 1, 128), (32_768, 1, 128), (3_600, 1, 128), (262_144, 1, 16),
    (262_144, 1, 128), (200, 1, 128), (3_600, 8, 1024), (262_144, 256, 16),
    (262_144, 256, 128)])
def test_int8_chunk_plan_bounds_candidates(n, nq, k):
    """With one query block the int8 route's chunks are long enough that
    at most a quarter of the rows scanned become candidates (one chunk
    where k exceeds a quarter of them); a batch keeps the one-wave plan.
    The chunks cover the rows, and pass 2's warps split them."""
    qb = scan_mod._query_block(1024, 1, k, nq)
    smem = scan_mod.pass1_smem_bytes(1024, 1, k, nq)
    rows, chunks = scan_mod.chunk_plan(n, nq, qb, sms=132, smem=smem,
                                       select_k=k)
    assert rows % 64 == 0 and (chunks - 1) * rows < n <= chunks * rows
    q_blocks = -(-nq // qb)
    one_wave = scan_mod.chunk_plan(n, nq, qb, sms=132, smem=smem)
    if q_blocks == 1:
        assert chunks * k <= max(n // 4, k)
        assert chunks <= one_wave[1]
    else:
        assert (rows, chunks) == one_wave
    w = scan_mod.pass2_warps(chunks, k)
    bounds = scan_mod.run_bounds(chunks, w)
    assert bounds[0] == 0 and bounds[-1] == chunks
    assert all(b > a for a, b in zip(bounds[:-1], bounds[1:]))


@pytest.mark.parametrize("chunks,k,warps", [
    (1, 128, 1), (7, 128, 7), (61, 128, 32), (244, 128, 32), (66, 10, 32),
    (33, 16, 32), (66, 1024, 4), (66, 129, 31), (264, 512, 8)])
def test_pass2_warps_fit_shared_memory(chunks, k, warps):
    """Pass 2 takes a warp a run of at least one chunk, up to 32, and its
    three lists of k a warp fit 96 KB of shared memory."""
    w = scan_mod.pass2_warps(chunks, k)
    assert w == warps and 1 <= w <= min(32, chunks)
    assert 3 * w * k * 8 <= 96 * 1024


# -- pass 1's merge of the bf16/f16 route -------------------------------------

D16 = 32                                    # row width of the bf16 cases


def _int_case(n, nq, seed, live=None, zero=True):
    """bf16 rows of whole numbers in [-2, 2] (their f32 scores are exact
    in any order, so JAX's, the plain version's and the model's agree bit
    for bit, and many tie), the 17-way tie TIE as far as it fits,
    tombstones, and queries: query 1 equals row 7 (the tied rows score
    top), query 2 is zero where ``zero`` (every live row scores 0);
    ``live`` keeps only that many leading rows valid."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2, 3, (n, D16)).astype(np.float32)
    tie = [t for t in TIE if t < n] or [0]
    rows[tie[1:]] = rows[tie[0]]
    valid = rng.random(n) > 0.2
    valid[tie] = True
    if live is not None:
        valid[:] = False
        valid[:live] = True
    queries = rng.integers(-2, 3, (max(nq, 3), D16)).astype(np.float32)
    queries[1] = rows[tie[0]]
    if zero:
        queries[2] = 0.0
    return rows, queries, valid


def _torch(rows, queries, valid):
    return (torch.from_numpy(rows).bfloat16(), torch.from_numpy(queries),
            torch.from_numpy(valid))


def _sequential_rows(scores, ids, k, rows_per_chunk, warm=None):
    """The TPU kernel's merge of each chunk, row by row: a score that beats
    max(the list's k-th, warm) goes in after equal scores."""
    nq, n = scores.shape
    chunks = -(-n // rows_per_chunk)
    out_s = torch.full((nq, chunks, k), float("-inf"))
    out_i = torch.zeros((nq, chunks, k), dtype=torch.int32)
    for q in range(nq):
        w = float("-inf") if warm is None else float(warm[q])
        for c in range(chunks):
            ls, li = [float("-inf")] * k, [0] * k
            for r in range(c * rows_per_chunk,
                           min(n, (c + 1) * rows_per_chunk)):
                s = float(scores[q, r])
                if s > max(ls[-1], w):
                    p = sum(x >= s for x in ls)
                    ls = ls[:p] + [s] + ls[p:-1]
                    li = li[:p] + [int(ids[r])] + li[p:-1]
            out_s[q, c], out_i[q, c] = torch.tensor(ls), torch.tensor(li)
    return out_s, out_i


def _warm(scores, k, w):
    """K8's thresholds from the sample's columns of the same scores."""
    return scan_mod.warm_threshold(
        torch.topk(scores[:, :w], k, dim=1).values[:, -1])


@settings(max_examples=60, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 700),
       k=st.integers(1, 130), chunk_tiles=st.integers(1, 6),
       queue_mult=st.integers(1, 5), refresh=st.booleans(),
       flush_rounds=st.sets(st.integers(0, 11), max_size=4),
       live=st.one_of(st.none(), st.integers(0, 40)),
       warm_rows=st.sampled_from([0, 0, 64, 256]))
def test_merge_model_is_the_sequential_merge(seed, n, k, chunk_tiles,
                                             queue_mult, refresh,
                                             flush_rounds, live, warm_rows):
    """Whatever the queue's size (32 to k, in 32s), wherever the extra
    flushes fall, and whether the threshold is refreshed at flushes or
    never, each chunk's list is the sequential merge's, bit for bit; and
    the chunks merged by pass 2 are the plain version's (K8's with its
    warm thresholds), masked rows and k above the live rows included."""
    queue = 32 * min(queue_mult, max(1, -(-k // 32)))
    rows, queries, valid = _int_case(n, 4, seed, live)
    store, q, v = _torch(rows, queries, valid)
    scores = scan_mod._scores(store, q, v, True)
    warm = None
    if warm_rows and k <= min(warm_rows, n):
        warm = _warm(scores, k, min(warm_rows, n))
    rows_per_chunk = 64 * chunk_tiles
    got_s, got_i, (queued, flushes) = scan_mod.pass1_merge_reference(
        scores, np.arange(n), k, rows_per_chunk, warm, queue=queue,
        flush_rounds=flush_rounds, refresh=refresh)
    want_s, want_i = _sequential_rows(scores, np.arange(n), k,
                                      rows_per_chunk, warm)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)
    merged = scan_mod.scan_pass2_reference(got_s, got_i)
    plain = (scan_mod.scan_topk_reference(store, q, v, k) if warm is None
             else scan_mod.scan_topk_warm_reference(store, q, v, k,
                                                    min(warm_rows, n)))
    assert _equal(merged, plain)
    assert flushes <= queued


@pytest.mark.parametrize("k,masked,rows_per_chunk", [
    (1, True, 64), (16, True, 128), (17, False, 192), (64, True, 256),
    (100, True, 128), (128, False, 512)])
def test_merge_model_bit_equal_to_pallas_topk(k, masked, rows_per_chunk):
    """The model's chunks merged by pass 2 equal the JAX package's Pallas
    scan in interpret mode, bit for bit; the 17-way tie and the zero
    query (every live row ties at 0) in row order."""
    rows, queries, valid = _int_case(N, 5, 5)
    store, q, v = _torch(rows, queries, valid)
    scores = scan_mod._scores(store, q, v, masked)
    cand = scan_mod.pass1_merge_reference(scores, np.arange(N), k,
                                          rows_per_chunk)
    got = scan_mod.scan_pass2_reference(*cand[:2])
    want = pallas_topk(jnp.asarray(store.float().numpy(), jnp.bfloat16),
                       jnp.asarray(queries), jnp.asarray(valid), k,
                       tile_n=TILE, interpret=True, masked=masked)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    t = min(k, len(TIE))
    assert got[1][1, :t].tolist() == TIE[:t]
    live = np.flatnonzero(valid) if masked else np.arange(N)
    assert got[1][2, :t].tolist() == live[:t].tolist()


@pytest.mark.parametrize("k,n_live", [(16, 6), (64, 3), (128, 8)])
def test_merge_model_bit_equal_to_pallas_topk_pruned(k, n_live):
    """K3's ids are physical rows of sorted tiles, so a chunk's rows are
    not contiguous: the model over the probe's rows equals the Pallas
    pruned scan in interpret mode, bit for bit."""
    rows, queries, valid = _int_case(N, 5, 6)
    rng = np.random.default_rng(7)
    live = np.sort(np.concatenate([[0], rng.choice(
        np.arange(1, N // TILE), size=n_live - 1, replace=False)]))
    tiles = np.full(8, live[-1], dtype=np.int32)
    tiles[:n_live] = live
    phys = (live[:, None] * TILE + np.arange(TILE)[None, :]).reshape(-1)
    store, q, v = _torch(rows, queries, valid)
    scores = scan_mod._scores(store[phys], q, v[phys], True)
    cand = scan_mod.pass1_merge_reference(scores, phys, k, 128)
    got = scan_mod.scan_pass2_reference(*cand[:2])
    want = pallas_topk_pruned(
        jnp.asarray(store.float().numpy(), jnp.bfloat16),
        jnp.asarray(queries), jnp.asarray(valid), jnp.asarray(tiles),
        jnp.asarray([n_live], dtype=jnp.int32), k, tile_n=TILE,
        interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1][1, :2].tolist() == TIE[:2]     # both in tile 0


@pytest.mark.parametrize("k,warm_rows", [(10, 128), (64, 256), (100, 512)])
def test_merge_model_warm_screen_bit_equal_to_pallas_warm(k, warm_rows):
    """K8: the screen starts at one ULP below the sample's k-th, so rows
    that tie the global k-th still enter; the model with those
    thresholds equals ``pallas_topk(warm_rows=)`` in interpret mode. No
    zero query: its threshold, one ULP below 0, is a denormal, which JAX
    flushes to 0 on the CPU (its warm scan then drops the tied zeros)."""
    rows, queries, valid = _int_case(N, 5, 8, zero=False)
    store, q, v = _torch(rows, queries, valid)
    scores = scan_mod._scores(store, q, v, True)
    cand = scan_mod.pass1_merge_reference(
        scores, np.arange(N), k, 256, _warm(scores, k, warm_rows))
    got = scan_mod.scan_pass2_reference(*cand[:2])
    want = pallas_topk(jnp.asarray(store.float().numpy(), jnp.bfloat16),
                       jnp.asarray(queries), jnp.asarray(valid), k,
                       tile_n=TILE, interpret=True, warm_rows=warm_rows)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("k", [1, 20, 32])
def test_merge_model_counts_what_a_strict_screen_queues(k):
    """The counters the kernel reports, on a query whose every live score
    is 0: the first round queues its 32 rows, the second does not fit
    and flushes them (the list, k <= 32, is then full at 0), and a
    strict screen queues nothing more, so each chunk queues 32 and
    flushes once. A screen that let scores equal to the threshold in
    would queue every row."""
    n, rows_per_chunk = 1024, 256
    scores = torch.zeros((1, n))
    got_s, got_i, counts = scan_mod.pass1_merge_reference(
        scores, np.arange(n), k, rows_per_chunk)
    chunks = n // rows_per_chunk
    assert counts == (32 * chunks, chunks)
    assert (got_i[0, :, :k] == torch.arange(k)[None, :]
            + torch.arange(0, n, rows_per_chunk)[:, None]).all()


@pytest.mark.parametrize("d", [64, 384, 768, 1024])
@pytest.mark.parametrize("k", [1, 10, 16, 64, 100, 128, 256, 512, 1024])
@pytest.mark.parametrize("nq", [1, 8, 9, 124, 256])
def test_merge_layout_fits_shared_memory(d, k, nq):
    """Every query block the bf16 route plans is one its kernel takes,
    fits shared memory as the kernel carves it with equal slabs of whole
    k-steps covering the row, and is the largest beside whose lists a
    slab of 64 elements fits (8 for a batch of 8 or fewer); a second
    score buffer only where it costs neither a slab nor an SM's second
    block."""
    qb, nb, slab = scan_mod.merge_layout(d, k, nq)
    assert qb in scan_mod._MERGED_BLOCKS and nb in (1, 2)
    assert scan_mod._query_block(d, 2, k, nq) == qb
    assert scan_mod.slab_words(d, 2, k, nq) * 2 == slab
    dp = -(-d // 16) * 16
    slabs = -(-dp // slab)
    assert slab % 16 == 0 and 16 <= slab and (slabs - 1) * slab < dp
    smem = scan_mod.pass1_smem_bytes(d, 2, k, nq)
    assert smem == scan_mod._merged_smem(d, qb, k, nb, slab)
    assert smem <= scan_mod._SMEM_MAX
    if nq <= 8:
        assert qb == 8
    else:
        larger = [b for b in scan_mod._MERGED_BLOCKS if b > qb]
        room = lambda b: scan_mod._SMEM_MAX - scan_mod._merged_fixed(
            d, b, k, 1) - 2 * 64 * (64 + 8) * 2
        assert all(room(b) < 0 for b in larger)
        assert qb == 8 or room(qb) >= 0
    if nb == 2:
        one = scan_mod._merged_smem(d, qb, k, 1, slab)
        assert scan_mod._per_sm(smem) == scan_mod._per_sm(one)


def test_merge_query_block_reads_the_store_fewer_times_above_k_128():
    """At k 1,024 a batch of 256 takes blocks of 16 (the store read 16
    times; the int8 route's blocks of 8 read it 32), 32 at k 256 and 512,
    64 up to k 128, at MiniLM's width."""
    assert [scan_mod.merge_layout(384, k, 256)[0]
            for k in (16, 64, 128, 256, 512, 1024)] == [64, 64, 64, 32, 32,
                                                       16]
    assert scan_mod._query_block(384, 1, 1024, 256) == 8
