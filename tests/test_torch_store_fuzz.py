"""The store's state machine under seeded op sequences (those of
``tests/test_vector_store_fuzz.py``, ``store_fuzz.fuzz_ops``): adds that
cross the tail's spare rows and the seal, per-file removes, reopens and
searches, in five spill/IVF modes. The port's store on the CPU against
the sequence's own numpy answer; the port against ``sema_tpu``'s store op
for op; and each package's directory reopened by the other."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from sema_tpu.index.vector_store import VectorStore as JaxStore
from sema_tpu.models.encoder import EncodedBatch as JaxEncodedBatch
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.tools.store_fuzz import (FUZZ_MODES, StoreFuzz,
                                             fuzz_agree, fuzz_case,
                                             fuzz_geometry, fuzz_ops,
                                             fuzz_place)

store_mod = importlib.import_module("sema_tpu_torch.index.vector_store")
D = 32
PRUNED = {"bfloat16": "scan_topk_pruned", "int8": "scan_topk_int8_pruned"}
SCANS = ("scan_topk", "scan_topk_int8", "scan_topk_pruned",
         "scan_topk_int8_pruned")


@pytest.fixture()
def scan_calls(monkeypatch):
    """The store's scan wrappers, counting their calls by name."""
    calls = {}
    for name in SCANS:
        fn = getattr(store_mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(store_mod, name, counted)
    return calls


@pytest.mark.parametrize("mode", FUZZ_MODES)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("seed", [3, 41])
def test_port_store_fuzz_against_oracle(tmp_path, scan_calls, seed, dtype,
                                        mode):
    """Every search of the sequence against the live rows in bf16 (scores
    within 1e-5, chunks equal but between near-ties, no removed chunk),
    ``live_rows`` and each remove's count after every step; the mode's
    machinery engaged (sealed buckets, spilled ones, clusters probed by
    the pruned scan)."""
    out = fuzz_case(tmp_path, dtype, mode, seed, D, ["cpu"])
    assert out["steps"]["search"] >= 2 and out["sealed"]
    if mode in ("all", "mixed", "ivf+spill"):
        assert out["spilled"]
    if mode == "mixed":
        assert out["spilled"] < out["sealed"]
    if mode in ("ivf", "ivf+spill"):
        assert out["clustered"] and scan_calls.get(PRUNED[dtype], 0)


def _jax_place(store, rows, placement):
    """The JAX fuzz's three placements: host rows, a device array, an
    EncodedBatch of both."""
    if placement < 0.4:
        return rows
    if placement < 0.7:
        return jnp.asarray(rows)
    return JaxEncodedBatch(rows.astype(store.np_dtype),
                           jnp.asarray(rows, dtype=jnp.bfloat16))


def _ids(answer):
    return [c for c, _ in answer]


@pytest.mark.parametrize("mode", ["exact", "mixed", "ivf"])
def test_port_store_fuzz_against_jax(tmp_path, monkeypatch, mode):
    """The same sequence through the port's store and the JAX package's
    in lockstep (bf16, seed 3): equal remove counts and ``live_rows``
    after every step, the same chunks from every search (scores within
    1e-5); then each package's directory reopened by the other answers
    with the same chunks as the package that wrote it."""
    ivf = mode == "ivf"
    opens = [lambda: VectorStore(tmp_path / "port", D, "fuzz", device="cpu",
                                 ivf=ivf),
             lambda: JaxStore(tmp_path / "jax", D, "fuzz", ivf=ivf)]
    ops = fuzz_ops(3, D)
    with fuzz_geometry(mode, D, (VectorStore, JaxStore)):
        if ivf:   # the JAX store's pruned route: its kernels, interpreted
            monkeypatch.setenv("SEMA_TPU_SCAN_BACKEND", "pallas")
        run = StoreFuzz(opens, [fuzz_place, _jax_place])
        searched = 0
        for step, op in enumerate(ops):
            answers = run.apply(op, f"step {step}")
            if answers:
                port, jax_ = answers
                assert _ids(port) == _ids(jax_), step
                fuzz_agree(port, jax_, run.vecs, op[1], True,
                           what=f"step {step}")
                searched += 1
        assert searched >= 2
        run.close()
        q = ops[-1][1]
        for path, own, other in (
                ("port", opens[0], lambda p: JaxStore(p, D, "fuzz", ivf=ivf)),
                ("jax", opens[1], lambda p: VectorStore(p, D, "fuzz",
                                                        device="cpu",
                                                        ivf=ivf))):
            written, reopened = own(), other(tmp_path / path)
            want = written.search_batch(q, 10)
            got = reopened.search_batch(q, 10)
            assert reopened.live_rows == written.live_rows > 0
            assert ([written.chunk_at(int(i)).id for i in want[1][0]]
                    == [reopened.chunk_at(int(i)).id for i in got[1][0]])
            np.testing.assert_allclose(np.asarray(got[0]),
                                       np.asarray(want[0]), atol=1e-5)
            written.close()
            reopened.close()
