"""K1's and K8's wgmma route (``csrc/scan_topk.cu:wgmma_scorers``, TMA
stages feeding ``wgmma`` in ``scan_pass1_merged``) as the CPU can hold
it: the plan mirror (``ops/scan_topk.py:wgmma_layout`` and ``_plan``),
which the kernel's launch refuses to differ from, and the plain version
the route's results are held to on the card, against the JAX package's
Pallas scan in interpret mode at e5-base's and gte-large's widths."""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops.pallas_topk import pallas_topk
from sema_tpu_torch.index.vector_store import K_CLASSES

scan_mod = importlib.import_module("sema_tpu_torch.ops.scan_topk")
SMS = 132                  # the H100's SMs
WIDTHS = [8, 64, 384, 760, 768, 1024, 2048]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("k", K_CLASSES)
@pytest.mark.parametrize("nq", [9, 64, 256])
def test_chosen_route_fits_shared_memory(d, k, nq):
    """Whichever route the plan takes fits a block's shared memory; where
    it is the wgmma route, its ring holds at least three stages, takes
    what the queries, lists and queues leave (one more stage would not
    fit, so one block holds an SM), stages slabs of 64 values, and never
    merges in its last block."""
    p = scan_mod._plan(1 << 20, nq, d, 2, k, 64, SMS)
    layout = scan_mod.wgmma_layout(d, k, nq)
    assert p.smem <= scan_mod._SMEM_MAX
    if layout is None:
        assert p.stages == 0
        assert p.smem == scan_mod.pass1_smem_bytes(d, 2, k, nq)
        return
    qb, nb, stages = layout
    assert (p.qb, p.nb, p.stages) == layout
    assert qb in (32, 64) and nb in (1, 2) and stages >= 3
    assert qb == 32 if nq <= 32 else True
    assert p.smem == scan_mod._wgmma_smem(d, qb, k, nb, stages)
    assert scan_mod._wgmma_smem(d, qb, k, nb, stages + 1) > \
        scan_mod._SMEM_MAX
    assert scan_mod._per_sm(p.smem) == 1
    assert p.words * 2 == 64 and not p.one
    q_blocks = -(-nq // qb)
    assert p.chunks * q_blocks <= SMS < (p.chunks + 1) * q_blocks


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("k", K_CLASSES)
def test_small_batches_and_tile_lists_keep_the_mma_sync_scorers(d, k):
    """A batch of 8 or fewer (one n8 tile of mma.sync), a pruned scan's
    tile list (K3), int8 and f32 rows, K9's spans and a store of fewer
    rows than a TMA box keep the routes they had."""
    for nq in (1, 2, 8):
        assert scan_mod.wgmma_layout(d, k, nq) is None
        assert scan_mod._plan(1 << 20, nq, d, 2, k, 64, SMS).stages == 0
    for nq in (9, 256):
        assert scan_mod._plan(40 * 512, nq, d, 2, k, 64, SMS, 40).stages \
            == 0
        assert scan_mod._plan(63, nq, d, 2, k, 64, SMS).stages == 0
        if k <= 128 and d % 4 == 0:
            assert scan_mod._plan(1 << 20, nq, d, 1, k, 64, SMS).stages \
                == 0
        assert scan_mod._plan(1 << 20, nq, d, 4, k, 64, SMS).stages == 0
        if k <= 128:
            assert scan_mod._plan(1 << 20, nq, d, 2, k, 256, SMS).stages \
                == 0


def test_wgmma_route_at_the_batch_shapes():
    """The shapes the route was built for: e5-base's batches (d 768; the
    benchmark's 1,048,576 x 768 at Q 64 and k 10) and a gte-large bf16
    store's (d 1,024), each a block of 64 queries; Q 1 keeps the one
    launch."""
    plan = lambda n, nq, d, k: scan_mod._plan(n, nq, d, 2, k, 64, SMS)
    for n, nq, d, k in ((262_144, 256, 768, 64), (1 << 20, 64, 768, 10),
                        (262_144, 64, 1024, 64), (262_144, 256, 1024, 64),
                        (1 << 20, 256, 384, 10)):
        p = plan(n, nq, d, k)
        assert p.stages >= 3 and p.qb == 64, (n, nq, d, k, p)
    p = plan(1 << 20, 1, 768, 10)
    assert p.stages == 0 and p.one
    assert plan(1 << 20, 20, 384, 64).qb == 32


@pytest.mark.parametrize("n,nq,d,wg", [
    (3_000, 16, 384, False), (3_000, 64, 1024, False),   # a tile a chunk
    (3_000, 256, 384, False),                            # 2 tiles x 6 slabs
    (3_000, 256, 768, True), (3_000, 256, 1024, True),   # 2 x 12, 2 x 16
    (16_384, 64, 384, False), (16_384, 64, 768, True),
    (65_536, 16, 384, True), (262_144, 124, 384, True)])
def test_small_chunks_keep_the_mma_sync_scorers(n, nq, d, wg):
    """The crossover: the route where each block streams at least
    ``_WG_MIN_SLABS`` ring slabs (its chunk's tiles times the row's
    slabs of 64 values); below, the mma.sync scorers, whose chunk plan
    (two blocks an SM where shared memory allows) is then the plan."""
    p = scan_mod._plan(n, nq, d, 2, 64, 64, SMS)
    slabs = p.rows // 64 * -(-d // 64)
    assert bool(p.stages) == wg
    if wg:
        assert slabs >= scan_mod._WG_MIN_SLABS
    else:
        old = scan_mod._query_block(d, 2, 64, nq)
        smem = scan_mod.pass1_smem_bytes(d, 2, 64, nq)
        assert (p.qb, p.smem) == (old, smem)
        assert (p.rows, p.chunks) == scan_mod.chunk_plan(n, nq, old, SMS,
                                                         smem)


def _wide_case(n, d, q, seed):
    """Unit rows (bf16) with a 4-way exact tie (rows 40, 97, 200 equal
    row 7) and another (row 150 equals row 3), tombstones, and unit
    queries, query 1 on row 7."""
    rng = np.random.default_rng(seed)
    store = rng.standard_normal((n, d)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    store[[40, 97, 200]] = store[7]
    store[150] = store[3]
    store = np.asarray(torch.from_numpy(store).bfloat16().float())
    valid = rng.random(n) > 0.2
    valid[[7, 40, 97, 200, 3, 150]] = True
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    queries[1] = store[7]
    return store, queries, valid


@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("masked", [True, False])
def test_plain_version_matches_pallas_at_batch_widths(d, masked):
    """The plain version the route is held to on the card against
    ``pallas_topk`` in interpret mode, both over a bf16 store at d 768
    and 1,024 with 64 queries (the route's block): the same ids in the
    same order, the tied rows by row id, and scores within 1e-6 (both sum
    the exact bf16 products in f32, in another order; unit rows and
    queries keep each score under 1)."""
    store, queries, valid = _wide_case(512, d, 64, seed=d)
    k = 64
    want_s, want_i = pallas_topk(
        jnp.asarray(store, dtype=jnp.bfloat16), jnp.asarray(queries),
        jnp.asarray(valid), k, tile_n=128, interpret=True, masked=masked)
    got_s, got_i = scan_mod.scan_topk(
        torch.from_numpy(store).bfloat16(), torch.from_numpy(queries),
        torch.from_numpy(valid), k, masked=masked)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=1e-6, rtol=0)
    assert list(got_i[1, :4].numpy()) == [7, 40, 97, 200]
    if masked:
        assert valid[got_i.numpy()].all()


def test_plan_constants_are_the_sources():
    """The mirror's ring stage, fewest stages and alignment, and the
    route's query blocks and threads, are the kernel's own, read from
    csrc/scan_topk.cu, whose launch refuses a plan that differs."""
    src = (Path(scan_mod.__file__).resolve().parents[1] / "csrc"
           / "scan_topk.cu").read_text()
    assert "constexpr int kRingStage = kTileRows * 128;" in src
    assert scan_mod._RING_STAGE == scan_mod._TILE_ROWS * 128
    assert f"constexpr int kRingMin = {scan_mod._RING_MIN};" in src
    assert "smem_addr(smem) & 1023" in src and scan_mod._RING_ALIGN == 1024
    launch = src[src.index("cudaError_t launch_merged_qb("):]
    launch = launch[:launch.index("\n}\n")]
    wg = launch[:launch.index("switch (qb) {", launch.index("switch (qb) {")
                                 + 1)]
    assert sorted(int(b) for b in re.findall(
        r"case (\d+): return launch_merged<DT, \d+, true>", wg)) == sorted(
            scan_mod._WG_BLOCKS)
    # 8 consumer warps, the producer and 16 mergers: 800 threads
    assert "static constexpr int kCopiers = WG ? 9 :" in src
