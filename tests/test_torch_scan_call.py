"""The scans' launch path: one call's workspace, the one-launch route's
merge, the card guard.

``sema_tpu_torch.ops.scan_topk._launch`` makes one device allocation a
call, which ``csrc/scan_topk.cu:carve`` cuts into the returned scores and
ids, pass 1's candidates, a pruned scan's staged tile ids and an int8
scan's quantized queries (``workspace_layout``); at one query the bf16/f16
route of K1, K3 and K8 launches pass 1 alone and its last block merges the
chunk lists as pass 2 does, with fewer warps (``one_launch_warps``). Held
here on the CPU: the layout at the paths' one-query shapes and at Q 256
(aligned, disjoint, each piece the size the kernels read and write, in
the kernel's order); the merge with the one-launch route's runs against
``scan_pass2_reference`` and against the JAX package's Pallas scan in
interpret mode, ties included; ``_cuda.launch``, which enters
``torch.cuda.device`` only when another card is current (a stubbed
``torch.cuda``); and every ``extern "C"`` entry point that takes a stream,
which must refuse a card that is not current before it launches (the
sources read as text), with ctypes signatures of its own length."""

import ctypes
import importlib
import re
from contextlib import contextmanager
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops.pallas_topk import pallas_topk
from sema_tpu_torch.ops import _cuda

scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
CSRC = Path(scan_mod.__file__).resolve().parents[1] / "csrc"
SMS = 132                  # the H100's SMs
PIECES = ("out_s", "out_i", "cand_s", "cand_i", "tiles", "qbuf", "qscale")

# (rows of the store or live tiles x tile rows, d, itemsize, Q, k, tiles,
# span): the paths' one-query calls (PERF.md's host-bound rows) and the
# batches
SHAPES = {
    "K1 main path": (3_600, 384, 2, 1, 64, 0, 64),
    "K3 shard probe": (17 * 512, 1024, 2, 1, 64, 17, 64),
    "K3 spill stage": (138 * 128, 1024, 2, 1, 16, 138, 64),
    "K1 shard block 1,024": (1_024, 384, 2, 1, 16, 0, 64),
    "K1 shard block 65,536": (65_536, 1024, 2, 1, 64, 0, 64),
    "K1 spill slice": (262_144, 1024, 2, 1, 128, 0, 64),
    "K1 k_max": (262_144, 384, 2, 1, 1024, 0, 64),
    "K4a tail": (3_600, 1024, 1, 1, 128, 0, 64),
    "K4b probe": (61 * 512, 1024, 1, 1, 128, 61, 64),
    "K1 Q 256": (1 << 20, 384, 2, 256, 64, 0, 64),
    "K1 Q 256 k_max": (1 << 20, 384, 2, 256, 1024, 0, 64),
    "K3 Q 256": (40 * 512, 1024, 2, 256, 128, 40, 64),
    "K4a Q 256": (262_144, 1024, 1, 256, 128, 0, 64),
    "K9 Q 256": (1 << 20, 384, 2, 256, 10, 0, 256),
    "K9 Q 1": (1 << 20, 384, 2, 1, 64, 0, 256),
}


def _up16(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("name", list(SHAPES))
def test_workspace_is_aligned_disjoint_and_exactly_what_the_kernel_uses(
        name):
    n, d, isz, nq, k, n_tiles, span = SHAPES[name]
    p = scan_mod._plan(n, nq, d, isz, k, span, SMS, n_tiles)
    layout = scan_mod.workspace_layout(nq, k, p.chunks, n_tiles, d, isz == 1)
    assert tuple(layout)[:-1] == PIECES
    want = {"out_s": nq * k * 4, "out_i": nq * k * 4,
            "cand_s": nq * p.chunks * k * 4, "cand_i": nq * p.chunks * k * 4,
            "tiles": n_tiles * 4, "qbuf": nq * d if isz == 1 else 0,
            "qscale": nq * 4 if isz == 1 else 0}
    at = 0
    for piece in PIECES:
        offset, nbytes = layout[piece]
        assert nbytes == want[piece], piece
        assert offset % 16 == 0 and offset == at, piece   # packed, aligned
        at = offset + _up16(nbytes)
    assert layout["total"] == (0, at) and p.ws_bytes == at
    assert p.out_i * 4 == layout["out_i"][0]
    # the wrapper's views of the one allocation: the returned pieces first,
    # neither overlapping the candidates nor each other
    ws = torch.empty(p.ws_bytes // 4, dtype=torch.float32)
    out_s = ws[:nq * k].view(nq, k)
    out_i = ws[p.out_i:p.out_i + nq * k].view(torch.int32).view(nq, k)
    base = ws.data_ptr()
    for t, piece in ((out_s, "out_s"), (out_i, "out_i")):
        assert t.data_ptr() - base == layout[piece][0]
        assert t.data_ptr() % 16 == 0 and t.is_contiguous()
    assert layout["out_i"][0] + nq * k * 4 <= layout["cand_s"][0]
    # where the route merges in pass 1's last block, the merge's lists fit
    # the block's warps and its shared memory
    if p.one:
        assert isz == 2 and span == 64 and nq == 1
        assert 1 <= p.warps2 <= scan_mod._merged_warps(p.qb)
        assert 24 * p.warps2 * k + p.chunks * k * 8 <= p.smem
    else:
        assert p.warps2 == scan_mod.pass2_warps(p.chunks, k)
    assert p.warps2 <= min(p.chunks, 32, 4096 // k)


def test_workspace_pieces_in_the_kernels_order():
    """``carve`` takes the pieces in ``workspace_layout``'s order."""
    src = (CSRC / "scan_topk.cu").read_text()
    body = src[src.index("Workspace carve("):]
    body = body[:body.index("\n}\n")]
    assert re.findall(r"w\.(\w+) = reinterpret_cast<[^>]+>\(take\(",
                      body) == list(PIECES)


# -- the one-launch route's merge ---------------------------------------------

D16 = 64
TIE = [7 + 60 * j for j in range(17)]     # rows equal to row 7


def _int_rows(n, seed):
    """bf16 rows of whole numbers (exact scores in any order, many ties),
    the 17-way tie TIE, tombstones; query 0 equals row 7, query 1 is zero
    (every live row scores 0)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2, 3, (n, D16)).astype(np.float32)
    tie = [t for t in TIE if t < n]
    rows[tie[1:]] = rows[tie[0]]
    valid = rng.random(n) > 0.2
    valid[tie] = True
    queries = rng.integers(-2, 3, (3, D16)).astype(np.float32)
    queries[0] = rows[tie[0]]
    queries[1] = 0.0
    return (torch.from_numpy(rows).bfloat16(), torch.from_numpy(queries),
            torch.from_numpy(valid))


@pytest.mark.parametrize("n,k,rows_per_chunk,smem", [
    (3_600, 64, 64, 110_000),     # the main path: 57 chunks of one tile
    (3_600, 16, 64, 110_000),
    (1_100, 1, 64, 110_000),
    (1_100, 17, 128, 110_000),
    (2_048, 128, 64, 60_000),     # fewer warps than the block's 16
    (4_096, 200, 256, 232_448),
    (700, 1024, 64, 232_448),     # k above the live rows: -inf tails
    (5_000, 33, 320, 110_000)])
def test_last_block_merge_is_pass2_ties_included(n, k, rows_per_chunk, smem):
    """Pass 1's chunk lists (``pass1_merge_reference``) merged with the
    one-launch route's runs (W = ``one_launch_warps``) equal pass 2's
    merge with its own runs, and the plain version, bit for bit: the
    17-way tie and the zero query's live rows in row order."""
    store, q, valid = _int_rows(n, n + k)
    scores = scan_mod._scores(store, q, valid, True)
    cs, ci, _ = scan_mod.pass1_merge_reference(scores, np.arange(n), k,
                                               rows_per_chunk)
    chunks = cs.shape[1]
    w1 = scan_mod.one_launch_warps(chunks, k, smem, 8)
    assert w1 <= 16 and 24 * w1 * k <= smem
    one = scan_mod.scan_pass2_reference(
        cs, ci, runs=scan_mod.run_bounds(chunks, w1))
    two = scan_mod.scan_pass2_reference(cs, ci)
    plain = scan_mod.scan_topk_reference(store, q, valid, k)
    for got in (one, two):
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    t = min(k, len([x for x in TIE if x < n]))
    assert one[1][0, :t].tolist() == [x for x in TIE if x < n][:t]
    live = np.flatnonzero(valid.numpy())[:min(k, int(valid.sum()))]
    assert one[1][1, :len(live)].tolist() == live.tolist()


@pytest.mark.parametrize("k", [1, 16, 32])
def test_last_block_merge_bit_equal_to_pallas_topk(k):
    """The one-launch route at one query (the main path's plan on 1,024
    rows: a chunk a tile) equals the JAX package's Pallas scan in
    interpret mode, bit for bit."""
    store, q, valid = _int_rows(1_024, k)
    p = scan_mod._plan(1_024, 1, D16, 2, k, 64, SMS)
    assert p.one and p.rows == 64
    for j in range(2):
        scores = scan_mod._scores(store, q[j:j + 1], valid, True)
        cs, ci, _ = scan_mod.pass1_merge_reference(scores, np.arange(1_024),
                                                   k, p.rows)
        got = scan_mod.scan_pass2_reference(
            cs, ci, runs=scan_mod.run_bounds(p.chunks, p.warps2))
        want = pallas_topk(jnp.asarray(store.float().numpy(), jnp.bfloat16),
                           jnp.asarray(q[j:j + 1].numpy()),
                           jnp.asarray(valid.numpy()), k, tile_n=128,
                           interpret=True)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("nq,itemsize,span,one", [
    (1, 2, 64, True), (2, 2, 64, False), (256, 2, 64, False),
    (1, 1, 64, False), (1, 4, 64, False), (1, 2, 256, False)])
def test_one_launch_only_at_one_query_of_the_merged_route(nq, itemsize,
                                                          span, one):
    """bf16/f16 rows of K1, K3 and K8 at one query; int8, f32, K9 and
    batches keep pass 2's launch."""
    assert scan_mod.one_launch(nq, itemsize, span) is one


# -- the card guard -------------------------------------------------------------

@pytest.mark.parametrize("current,card", [(0, 0), (0, 2), (2, 2), (3, 1),
                                          (1, None)])
def test_launch_enters_the_card_only_when_another_is_current(
        monkeypatch, current, card):
    """``_cuda.launch`` calls the entry point with the card's current
    stream and the card, entering ``torch.cuda.device`` exactly when
    another card is current (a device without an index is the current
    card)."""
    entered = []
    state = {"current": current}

    @contextmanager
    def device(c):
        entered.append(c)
        before, state["current"] = state["current"], c
        try:
            yield
        finally:
            state["current"] = before
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_cuda, "_stream", lambda c: 1000 + c)
    calls = []

    def entry(*args):
        calls.append((args, state["current"]))
        return 0
    dev = torch.device("cuda") if card is None else torch.device("cuda", card)
    assert _cuda.launch(entry, dev, 5, 6) == 0
    want = current if card is None else card
    assert calls == [((5, 6, 1000 + want, want), want)]
    assert entered == ([] if want == current else [want])


def _entry_points(name):
    """{entry point: (parameters, body)} of ``csrc/<name>.cu``'s extern "C"
    functions."""
    src = (CSRC / f"{name}.cu").read_text()
    out = {}
    for m in re.finditer(r'extern "C" \w+\*? (\w+)\((.*?)\) \{\n(.*?)\n\}\n',
                         src, re.S):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = (params, m.group(3))
    return out


STREAM_ENTRIES = {
    "scan_topk": ("sema_scan_topk", "sema_fold_topk"),
    "encoder_layer": ("sema_encoder_layer", "sema_encoder_layer_int8",
                      "sema_encoder_layer_int8_rows", "sema_qmm",
                      "sema_attention_qkv", "sema_attention_block")}
GUARDED = [(src, e) for src, entries in STREAM_ENTRIES.items()
           for e in entries]


@pytest.mark.parametrize("source", list(STREAM_ENTRIES))
def test_every_entry_point_with_a_stream_is_listed(source):
    entries = _entry_points(source)
    with_stream = {e for e, (params, _) in entries.items()
                   if "void* stream" in params}
    assert with_stream == set(STREAM_ENTRIES[source])
    guard = (CSRC / f"{source}.cu").read_text()
    guard = guard[guard.index("cudaError_t on_card(int card, void* stream)"):]
    guard = guard[:guard.index("\n}\n")]
    assert "if (cur != card" in guard and "cudaStreamGetDevice" in guard


@pytest.mark.parametrize("source,entry", GUARDED)
def test_entry_point_refuses_another_card_before_it_launches(source, entry):
    """The stream comes last but one, the card last, and the body's first
    statement is the guard, whose error it returns."""
    params, body = _entry_points(source)[entry]
    assert params[-2:] == ["void* stream", "int card"]
    assert re.match(r"\s*(const )?cudaError_t (\w+) = on_card\(card, stream\);"
                    r"\n\s*if \(\2 != cudaSuccess\) return \2;", body), body


@pytest.mark.parametrize("source,entry", GUARDED)
def test_entry_point_ctypes_signature_has_its_parameters(source, entry):
    """The wrappers' ctypes argtypes have one entry a C parameter, the
    card's c_int last."""
    modules = {"sema_scan_topk": "scan_topk", "sema_fold_topk": "scan_topk",
               "sema_encoder_layer": "encoder_layer",
               "sema_encoder_layer_int8": "encoder_layer_int8",
               "sema_encoder_layer_int8_rows": "encoder_layer_int8",
               "sema_qmm": "encoder_layer_int8",
               "sema_attention_qkv": "attention",
               "sema_attention_block": "attention"}
    mod = importlib.import_module(f"sema_tpu_torch.ops.{modules[entry]}")
    argtypes = list(mod._SIGNATURES[entry])
    params, _ = _entry_points(source)[entry]
    assert len(argtypes) == len(params)
    assert argtypes[-1] is ctypes.c_int


def _before(s1, i1, s2, i2):
    return s1 > s2 or (s1 == s2 and i1 < i2)


def _capped_merge(a_s, a_i, b_s, b_i):
    """The kernel's ``merge_lists``, entry by entry: only a's entries
    before b's k-th and b's before a's k-th are placed, each at its index
    plus the other's placed entries before it; slots from fa + fb on are
    -inf, id 0."""
    k = len(a_s)
    count = lambda s, i, v, vi: sum(_before(s[j], i[j], v, vi)
                                    for j in range(k))
    fa = count(a_s, a_i, b_s[-1], b_i[-1])
    fb = count(b_s, b_i, a_s[-1], a_i[-1])
    out_s, out_i = [float("-inf")] * k, [0] * k
    written = [False] * k
    for j in range(min(k, fa + fb), k):
        written[j] = True
    for xs, xi, ys, yi, fx, fy in ((a_s, a_i, b_s, b_i, fa, fb),
                                   (b_s, b_i, a_s, a_i, fb, fa)):
        for j in range(fx):
            p = j + sum(_before(ys[m], yi[m], xs[j], xi[j])
                        for m in range(fy))
            if p < k:
                assert not written[p]
                out_s[p], out_i[p], written[p] = xs[j], xi[j], True
    assert all(written)
    return out_s, out_i


@pytest.mark.parametrize("seed", range(8))
def test_merge_of_two_lists_places_only_what_can_rank_below_k(seed):
    """``merge_lists`` counts only the entries of each list that come
    before the other's k-th (all finite ones where the other is not
    full): the first k of the union, every slot written once, as
    ``merge_lists_reference`` places every entry; ties of score order by
    row id, and short lists leave -inf tails."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 40))

    def sorted_list(ids):
        fill = int(rng.integers(0, k + 1))
        s = rng.integers(-3, 4, fill).astype(np.float32)
        i = rng.choice(ids, fill, replace=False)
        order = np.lexsort((i, -s))
        s = np.concatenate([s[order], np.full(k - fill, -np.inf,
                                              np.float32)])
        return s, np.concatenate([i[order], np.zeros(k - fill, np.int64)])
    ids = rng.permutation(1000) + 1
    a_s, a_i = sorted_list(ids[:500])
    b_s, b_i = sorted_list(ids[500:])
    got = _capped_merge(list(a_s), list(a_i), list(b_s), list(b_i))
    t = lambda x, dt: torch.tensor(np.asarray(x)[None, :], dtype=dt)
    want = scan_mod.merge_lists_reference(
        t(a_s, torch.float32), t(a_i, torch.int64), t(b_s, torch.float32),
        t(b_i, torch.int64))
    assert got[0] == want[0][0].tolist() and got[1] == want[1][0].tolist()
