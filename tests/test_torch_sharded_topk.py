"""The port's sharded and two-level top-k (``sema_tpu_torch/parallel/
sharded_topk.py``, ``multislice.py``) held against the JAX package's
(``sema_tpu/parallel/sharded_topk.py``, ``multislice.py``) on 8 shards:
the JAX side on ``tests/conftest.py``'s 8 virtual CPU devices, the port's
on ``["cpu"] * 8``, the same numpy inputs. The mirrors of
``tests/test_topk.py::TestShardedTopk``, ``tests/test_sharded_pruned.py``
and ``tests/test_multislice.py``, plus ties planted across shards (the
lower global row id first), an all-padding shard, heterogeneous probes
and the int8 (values, scales) store. Ids must be equal and scores within
1e-6; the int8 kernels' scores, which both sum exactly, bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sema_tpu.ops.pallas_topk import (pallas_topk_int8,
                                      pallas_topk_int8_pruned,
                                      pallas_topk_pruned)
from sema_tpu.ops.quant import quantize_rows
from sema_tpu.parallel import make_mesh as jax_make_mesh
from sema_tpu.parallel import sharded_topk as jax_sharded_topk
from sema_tpu.parallel.multislice import (
    make_multislice_pruned_topk as jax_multislice_pruned,
    make_multislice_topk as jax_multislice)
from sema_tpu.parallel.sharded_topk import (
    make_sharded_pruned_topk as jax_sharded_pruned,
    make_sharded_topk as jax_make_sharded)
from sema_tpu_torch.ops.scan_topk import (scan_topk, scan_topk_int8,
                                          scan_topk_int8_pruned,
                                          scan_topk_pruned)
from sema_tpu_torch.parallel import make_mesh, sharded_topk
from sema_tpu_torch.parallel.multislice import (make_multislice_pruned_topk,
                                                make_multislice_topk)
from sema_tpu_torch.parallel.sharded_topk import (make_sharded_pruned_topk,
                                                  make_sharded_topk,
                                                  merge_shards, shard_devices)

pytestmark = pytest.mark.skipif(jax.device_count() < 8,
                                reason="needs 8 virtual devices")

TILE = 128
SLICES = (("slice", "index"), [2, 4])


def _data(n, d=64, q=3, seed=0):
    rng = np.random.default_rng(seed)
    store = rng.standard_normal((n, d)).astype(np.float32)
    store /= np.linalg.norm(store, axis=1, keepdims=True)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return store, queries


def _mesh(axes=("data", "index"), shape=(1, 8)):
    return make_mesh(list(shape), axes, devices=["cpu"] * 8)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _cut(x, c=8):
    """A whole array (or a tuple of arrays) as ``c`` per-shard row blocks
    on the CPU, the form the store hands to the sharded scans."""
    if isinstance(x, tuple):
        return [tuple(b) for b in zip(*(_cut(a, c) for a in x))]
    return _t(*np.array_split(x, c))


def _b(store, queries, valid, c=8):
    """(store blocks, queries, mask blocks) of one sharded call."""
    return _cut(store, c), torch.from_numpy(queries), _cut(valid, c)


def _same(got, want, exact=False):
    """Ids equal in every live slot, in order; scores within 1e-6 (equal
    where ``exact``); -inf in the same slots."""
    gs, gi = (t.numpy() for t in got)
    ws, wi = (np.asarray(t) for t in want)
    assert gs.shape == ws.shape
    live = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), live)
    np.testing.assert_array_equal(gi[live], wi[live])
    if exact:
        np.testing.assert_array_equal(gs, ws)
    else:
        np.testing.assert_allclose(gs[live], ws[live], atol=1e-6, rtol=0)


def _put(mesh, x, axes):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*axes)))


# -- the flat merge (TestShardedTopk) ----------------------------------------

def test_dense_matches_jax_with_tombstones():
    store, queries = _data(1024)
    valid = np.ones(1024, dtype=bool)
    valid[::5] = False
    want = jax_sharded_topk(jax_make_mesh(), jnp.asarray(store),
                            jnp.asarray(queries), jnp.asarray(valid), 10)
    _same(sharded_topk(_mesh(), *_b(store, queries, valid), 10), want)


def test_global_ids_cross_shards():
    n = 800                                   # 100 rows a shard
    store, queries = _data(n, q=1)
    valid = np.ones(n, dtype=bool)
    for shard, row in [(0, 3), (3, 350), (7, 777)]:
        store[row] = queries[0] * (1 - 0.001 * shard)
    want = jax_sharded_topk(jax_make_mesh(), jnp.asarray(store),
                            jnp.asarray(queries), jnp.asarray(valid), 3)
    got = sharded_topk(_mesh(), *_b(store, queries, valid), 3)
    _same(got, want)
    assert got[1][0].tolist() == [3, 350, 777]


def test_ties_across_shards_rank_the_lower_global_id_first():
    """Row 7 copied into shards 2, 5 and 7 and twice into shard 0: every
    copy scores the same, and both packages put them in row order."""
    store, queries = _data(1024)
    ties = [7, 40, 300, 650, 1000]
    store[ties[1:]] = store[7]
    queries[1] = store[7]
    valid = np.ones(1024, dtype=bool)
    want = jax_sharded_topk(jax_make_mesh(), jnp.asarray(store),
                            jnp.asarray(queries), jnp.asarray(valid), 8)
    got = sharded_topk(_mesh(), *_b(store, queries, valid), 8)
    _same(got, want)
    assert got[1][1, :5].tolist() == ties
    assert np.asarray(want[1])[1, :5].tolist() == ties


def test_all_padding_shard_and_fewer_live_rows_than_k():
    """Shard 3 all invalid, and only 6 live rows in all: the -inf slots
    come last, after every live row."""
    store, queries = _data(1024, seed=4)
    valid = np.zeros(1024, dtype=bool)
    valid[[5, 130, 260, 700, 900, 1023]] = True
    want = jax_sharded_topk(jax_make_mesh(), jnp.asarray(store),
                            jnp.asarray(queries), jnp.asarray(valid), 10)
    got = sharded_topk(_mesh(), *_b(store, queries, valid), 10)
    _same(got, want)
    assert np.isfinite(got[0][:, :6].numpy()).all()
    assert np.isneginf(got[0][:, 6:].numpy()).all()


@pytest.mark.parametrize("k", [16, 100])
def test_int8_store_bit_equal_to_jax(k):
    """The int8 (values, scales) store through each package's int8 kernel
    (interpret mode, tiles of 128) as the local scan."""
    store, queries = _data(1024, seed=5)
    store[[300, 900]] = store[20]
    queries[0] = store[20]
    valid = np.ones(1024, dtype=bool)
    valid[::7] = False
    valid[[20, 300, 900]] = True
    qv, sc = quantize_rows(store)
    jmesh = jax_make_mesh()

    def jax_local(st, q, v, kk):
        return pallas_topk_int8(st[0], st[1], q, v, kk, tile_n=TILE,
                                interpret=True)
    fn = jax_make_sharded(jmesh, 1024, k, local_fn=jax_local,
                          store_specs=(P("index", None), P("index")))
    want = fn((_put(jmesh, qv, ("index", None)),
               _put(jmesh, sc, ("index",))),
              jnp.asarray(queries), _put(jmesh, valid, ("index",)))
    got = make_sharded_topk(
        _mesh(), 1024, k,
        local_fn=lambda b, q, v, kk: scan_topk_int8(*b, q, v, kk))(
        *_b((qv, sc), queries, valid))
    _same(got, want, exact=True)
    assert got[1][0, :3].tolist() == [20, 300, 900]


def test_indivisible_rows_rejected():
    store, queries = _data(100, q=1)              # 100 % 8 != 0
    with pytest.raises(ValueError, match="not divisible"):
        jax_sharded_topk(jax_make_mesh(), jnp.asarray(store),
                         jnp.asarray(queries), jnp.asarray(np.ones(100, bool)),
                         3)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_topk(_mesh(), *_b(store, queries, np.ones(100, bool)), 3)
    for make in (make_sharded_topk, make_sharded_pruned_topk):
        with pytest.raises(ValueError, match="not divisible"):
            make(_mesh(), 100, 3, local_fn=scan_topk)


def test_blocks_and_merge_contract():
    """Per-shard blocks go through as given (the store's placement), each
    shard's scan the caller's ``local_fn`` (no default); a list of the
    wrong length is refused; the merge keeps candidate order among equal
    scores and puts -inf last."""
    store, queries = _data(1024, seed=6)
    mesh, valid = _mesh(), np.ones(1024, dtype=bool)
    devices = shard_devices(mesh, "index")
    assert devices == [torch.device("cpu")] * 8
    blocks, q, masks = _b(store, queries, valid)
    assert len(blocks) == 8 and blocks[3].shape == (128, 64)
    whole = sharded_topk(mesh, blocks, q, masks, 10)
    split = make_sharded_topk(mesh, 1024, 10, local_fn=scan_topk)(
        blocks, q, masks)
    assert torch.equal(whole[0], split[0]) and torch.equal(whole[1],
                                                           split[1])
    with pytest.raises(ValueError, match="7 blocks and 8 masks"):
        make_sharded_topk(mesh, 1024, 10, local_fn=scan_topk)(
            blocks[:7], q, masks)
    with pytest.raises(TypeError, match="local_fn"):
        make_sharded_topk(mesh, 1024, 10)
    inf = float("-inf")
    s, i = merge_shards([torch.tensor([[0.5, inf]]),
                         torch.tensor([[0.5, 0.75]])],
                        [torch.tensor([[3, 0]]), torch.tensor([[130, 140]])],
                        4, torch.device("cpu"))
    assert s.tolist() == [[0.75, 0.5, 0.5, inf]]
    assert i.tolist() == [[140, 3, 130, 0]]


# -- the sharded pruned scan (tests/test_sharded_pruned.py) -----------------

def _jax_pruned_local(st, q, v, tiles, n_live, k):
    return pallas_topk_pruned(st, q, v, tiles, n_live, k, tile_n=TILE,
                              interpret=True)


def _port_pruned_local(b, q, v, tiles, n_live, k):
    return scan_topk_pruned(b, q, v, tiles, n_live, k, TILE)


def _pruned_pair(store, queries, valid, tiles, n_live, k):
    """(port, JAX) of the same sharded pruned scan over 8 shards."""
    n = len(store)
    jmesh = jax_make_mesh()
    want = jax_sharded_pruned(jmesh, n, k, local_fn=_jax_pruned_local)(
        jnp.asarray(store), jnp.asarray(queries), jnp.asarray(valid),
        jnp.asarray(tiles), jnp.asarray(n_live))
    got = make_sharded_pruned_topk(_mesh(), n, k,
                                   local_fn=_port_pruned_local)(
        *_b(store, queries, valid), tiles, n_live)
    return got, want


def test_pruned_all_tiles_matches_jax():
    n, per = 2048, 2                          # 256 rows a shard
    store, queries = _data(n)
    valid = np.ones(n, bool)
    valid[::7] = False
    tiles = np.tile(np.arange(per, dtype=np.int32), (8, 1))
    n_live = np.full((8, 1), per, dtype=np.int32)
    got, want = _pruned_pair(store, queries, valid, tiles, n_live, 10)
    _same(got, want)
    _same(got, sharded_topk(_mesh(), *_b(store, queries, valid), 10))


def test_pruned_subset_matches_jax():
    """Only each shard's first tile probed (the pad entry repeats it):
    nothing from an unprobed tile comes back."""
    n, sr = 2048, 256
    store, queries = _data(n, seed=1)
    valid = np.ones(n, bool)
    tiles = np.zeros((8, 2), dtype=np.int32)
    got, want = _pruned_pair(store, queries, valid, tiles,
                             np.ones((8, 1), dtype=np.int32), 5)
    _same(got, want)
    assert all(r % sr < TILE for r in got[1].flatten().tolist())


def test_pruned_heterogeneous_probes_and_global_ids():
    """Shards probe different local tiles; planted winners in three
    shards come back at their global (permuted) positions."""
    n, sr = 2048, 256
    store, queries = _data(n, q=1, seed=2)
    valid = np.ones(n, bool)
    plants = [(0, 1, 5), (3, 0, 17), (7, 1, 99)]
    rows = []
    tiles = np.zeros((8, 2), dtype=np.int32)
    for rank, (shard, tile, off) in enumerate(plants):
        r = shard * sr + tile * TILE + off
        store[r] = queries[0] * (1.0 - 0.001 * rank)
        rows.append(r)
        tiles[shard] = tile
    got, want = _pruned_pair(store, queries, valid, tiles,
                             np.ones((8, 1), dtype=np.int32), 3)
    _same(got, want)
    assert got[1][0].tolist() == rows


def test_pruned_all_padding_shard_dummy_probe():
    """Shard 5 all padding takes the store's dummy probe (its tile 0, one
    live tile): only -inf from it, the other shards as probed."""
    n, sr = 2048, 256
    store, queries = _data(n, seed=8)
    valid = np.ones(n, bool)
    valid[5 * sr:6 * sr] = False
    tiles = np.tile(np.array([0, 1], dtype=np.int32), (8, 1))
    n_live = np.full((8, 1), 2, dtype=np.int32)
    tiles[5], n_live[5] = 0, 1
    got, want = _pruned_pair(store, queries, valid, tiles, n_live, 10)
    _same(got, want)
    assert not any(5 * sr <= r < 6 * sr for r in got[1].flatten().tolist())


def test_pruned_int8_bit_equal_to_jax():
    n, per, k = 2048, 2, 16
    store, queries = _data(n, seed=9)
    valid = np.ones(n, bool)
    valid[::9] = False
    qv, sc = quantize_rows(store)
    tiles = np.tile(np.array([1, 1], dtype=np.int32), (8, 1))
    tiles[::2] = [0, 1]
    n_live = np.where(np.arange(8) % 2 == 0, per, 1).astype(
        np.int32)[:, None]
    jmesh = jax_make_mesh()

    def jax_local(st, q, v, t, nl, kk):
        return pallas_topk_int8_pruned(st[0], st[1], q, v, t, nl, kk,
                                       tile_n=TILE, interpret=True)
    want = jax_sharded_pruned(
        jmesh, n, k, local_fn=jax_local,
        store_specs=(P("index", None), P("index")))(
        (_put(jmesh, qv, ("index", None)), _put(jmesh, sc, ("index",))),
        jnp.asarray(queries), jnp.asarray(valid), jnp.asarray(tiles),
        jnp.asarray(n_live))
    got = make_sharded_pruned_topk(
        _mesh(), n, k,
        local_fn=lambda b, q, v, t, nl, kk: scan_topk_int8_pruned(
            *b, q, v, t, nl, kk, TILE))(
        *_b((qv, sc), queries, valid), tiles, n_live)
    _same(got, want, exact=True)


def test_pruned_default_local_fn_full_coverage():
    """No default ``local_fn`` (the JAX package's is its pruned kernel,
    the port's would be a plain version on the card): the caller passes
    the kernel. K3 at the JAX kernel's tile of 512, every tile probed,
    equals the exact sharded scan."""
    n, k, t = 8 * 2 * 512, 5, 512
    store, queries = _data(n)
    valid = np.ones(n, dtype=bool)
    per = (n // 8) // t
    tiles = np.tile(np.arange(per, dtype=np.int32), (8, 1))
    mesh = make_mesh([8], ("index",), devices=["cpu"] * 8)
    with pytest.raises(TypeError, match="local_fn"):
        make_sharded_pruned_topk(mesh, n, k)
    got = make_sharded_pruned_topk(
        mesh, n, k, local_fn=lambda b, q, v, ti, nl, kk: scan_topk_pruned(
            b, q, v, ti, nl, kk, t))(
        *_b(store, queries, valid), tiles, np.full((8, 1), per))
    _same(got, sharded_topk(mesh, *_b(store, queries, valid), k))


# -- the two-level merge (tests/test_multislice.py) --------------------------

def _jax_ms_put(jmesh, x):
    return _put(jmesh, x, (("slice", "index"),) + (None,) * (x.ndim - 1))


def test_two_level_matches_jax():
    n, k = 1024, 10
    store, queries = _data(n, d=32)
    valid = np.ones(n, bool)
    valid[::7] = False
    jmesh = jax_make_mesh(shape=[2, 4], axis_names=("slice", "index"))
    want = jax_multislice(jmesh, n, k)(
        _jax_ms_put(jmesh, store), jnp.asarray(queries),
        _jax_ms_put(jmesh, valid))
    got = make_multislice_topk(_mesh(*SLICES), n, k, local_fn=scan_topk)(
        *_b(store, queries, valid))
    _same(got, want)
    _same(got, sharded_topk(_mesh(), *_b(store, queries, valid), k))


def test_two_level_winners_and_ties_across_slices():
    """Winners in both slices and several shards come back in order; a
    tie spread over both slices ranks in row order, as the flat merge."""
    n, k = 512, 6
    store, queries = _data(n, d=32, q=2)
    valid = np.ones(n, bool)
    for rank, row in enumerate([5, 100, 300, 480]):
        store[row] = queries[0] * (1 - 0.001 * rank)
    store[[70, 200, 330, 460, 500]] = store[9]
    queries[1] = store[9]
    jmesh = jax_make_mesh(shape=[2, 4], axis_names=("slice", "index"))
    want = jax_multislice(jmesh, n, k)(
        _jax_ms_put(jmesh, store), jnp.asarray(queries),
        _jax_ms_put(jmesh, valid))
    got = make_multislice_topk(_mesh(*SLICES), n, k, local_fn=scan_topk)(
        *_b(store, queries, valid))
    _same(got, want)
    assert got[1][0, :4].tolist() == [5, 100, 300, 480]
    assert got[1][1].tolist() == [9, 70, 200, 330, 460, 500]


def test_two_level_indivisible_rejected():
    with pytest.raises(ValueError, match="not divisible"):
        jax_multislice(jax_make_mesh(shape=[2, 4],
                                     axis_names=("slice", "index")), 100, 5)
    for make in (make_multislice_topk, make_multislice_pruned_topk):
        with pytest.raises(ValueError, match="not divisible"):
            make(_mesh(*SLICES), 100, 5, local_fn=scan_topk)


def test_two_level_pruned_matches_jax():
    """Every shard probes a different subset of its tiles: the slice-major
    globalization and both merge levels, against the JAX package's."""
    per, k = 2, 6
    n = TILE * per * 8
    store, queries = _data(n, q=4, seed=3)
    valid = np.ones(n, bool)
    valid[::11] = False
    tiles = np.tile(np.arange(per, dtype=np.int32), (8, 1))
    n_live = np.full((8, 1), per, dtype=np.int32)
    tiles[[1, 6]], n_live[[1, 6]] = 1, 1
    jmesh = jax_make_mesh(shape=[2, 4], axis_names=("slice", "index"))
    want = jax_multislice_pruned(jmesh, n, k, local_fn=_jax_pruned_local)(
        _jax_ms_put(jmesh, store), jnp.asarray(queries),
        _jax_ms_put(jmesh, valid), _jax_ms_put(jmesh, tiles),
        _jax_ms_put(jmesh, n_live))
    got = make_multislice_pruned_topk(_mesh(*SLICES), n, k,
                                      local_fn=_port_pruned_local)(
        *_b(store, queries, valid), tiles, n_live)
    _same(got, want)
