"""The store's differential fuzz: seeded op sequences (those of
``tests/test_vector_store_fuzz.py``) applied to several stores in
lockstep, each search's answers held against each other and against the
sequence's own.

An op sequence (:func:`fuzz_ops`) adds rows that cross the tail's spare
rows and the seal, removes a file's rows, reopens and searches; it depends
on its seed alone, never on a store's answers. :func:`fuzz_geometry` sets
the store constants and variables of one of :data:`FUZZ_MODES` (exact,
spilled, partly spilled, IVF, IVF + spill) at a small size.
:func:`fuzz_case` runs one sequence through the port's store on each of
some devices. ``chip_smoke.py``'s ``fuzz_path`` runs it on a card against
the CPU; ``tests/test_torch_store_fuzz.py`` runs it on the CPU, and runs
:class:`StoreFuzz` over the port's store and ``sema_tpu``'s side by side.
"""

from __future__ import annotations

import os
import random
import sys
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.models.encoder import EncodedBatch

FUZZ_MODES = ("exact", "all", "mixed", "ivf", "ivf+spill")
FUZZ_STEPS = 40                # ops a sequence, then one last search
FUZZ_TOL = 1e-5                # a search's score limit


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def fuzz_ops(seed: int, d: int, steps: int = FUZZ_STEPS) -> list:
    """The seeded op sequence: adds of 3 to 150 unit rows to one of 13
    files, per-file removes, reopens and searches at k 1, 5 or 20, then a
    search at k 10. Each op is a tuple: ("add", path, first chunk ordinal,
    (n, d) f32 rows, placement in [0, 1)), ("remove", path), ("reopen",)
    or ("search", (1, d) f32 query, k)."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    ops, files, first = [], {}, 0

    def unit(n):
        x = rng.standard_normal((n, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    for _ in range(steps):
        op = pyrng.random()
        if op < 0.5 or not first:
            n = pyrng.choice((3, 7, 16, 40, 100, 150))
            path = f"f{pyrng.randint(0, 12)}.txt"
            ops.append(("add", path, first, unit(n), pyrng.random()))
            files[path] = True
            first += n
        elif op < 0.65:
            ops.append(("remove", pyrng.choice(list(files))))
        elif op < 0.75:
            ops.append(("reopen",))
        else:
            ops.append(("search", unit(1), pyrng.choice((1, 5, 20))))
    ops.append(("search", unit(1), 10))
    return ops


@contextmanager
def fuzz_geometry(mode: str, d: int, classes):
    """The class constants and variables of one fuzz mode, set on each of
    the store ``classes`` as ``tests/test_vector_store_fuzz.py`` sets them,
    restored after: seal at 96 rows, at most 3 tail buckets; "all" and
    "ivf+spill" spill every sealed bucket (a budget of 1 byte), "mixed"
    keeps about two sealed buckets on the device (0.02 MB at d 32, scaled
    by d / 32), both in slices of 64 rows; "ivf" and "ivf+spill" cluster
    sealed buckets in tiles of 128 and 64 rows (the scans' tile is 64
    rows: the smallest the pruned kernels take) and probe every tile
    (nprobe 99,999, the whole bucket as budget), so the answers stay
    exact. Variables that would override these are unset for the
    duration."""
    attrs = {"SEAL_ROWS": 96, "MAX_TAIL_BUCKETS": 3}
    env = {name: None for name in (
        "SEMA_TPU_HBM_BUDGET_MB", "SEMA_TPU_IVF", "SEMA_TPU_IVF_NPROBE",
        "SEMA_TPU_IVF_MIN_RECALL", "SEMA_TPU_SEAL_ROWS")}
    if mode in ("all", "ivf+spill"):
        env["SEMA_TPU_HBM_BUDGET_MB"] = "0.000001"
        attrs["SPILL_SLICE_ROWS"] = 64
    elif mode == "mixed":
        env["SEMA_TPU_HBM_BUDGET_MB"] = str(0.02 * d / 32)
        attrs["SPILL_SLICE_ROWS"] = 64
    if mode in ("ivf", "ivf+spill"):
        env["SEMA_TPU_IVF_NPROBE"] = "99999"
        tile = 64 if mode == "ivf+spill" else 128
        attrs.update(IVF_TILE=tile, IVF_CLUSTER_ROWS=tile, IVF_BUDGET_DIV=1)
    saved_attrs = {(cls, name): cls.__dict__[name] for cls in classes
                   for name in attrs}
    saved_env = {name: os.environ.get(name) for name in env}
    for cls in classes:
        for name, value in attrs.items():
            setattr(cls, name, value)
    for name, value in env.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
    try:
        yield
    finally:
        for (cls, name), value in saved_attrs.items():
            setattr(cls, name, value)
        for name, value in saved_env.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def fuzz_place(store, rows: np.ndarray, placement: float):
    """The port's three placements of an add's rows: host rows (numpy), a
    tensor on the store's device, or an ``EncodedBatch`` of both (the
    serving re-index's in-place append)."""
    if placement < 0.4:
        return rows
    t = torch.from_numpy(rows)
    if placement < 0.7:
        return t.to(store.device)
    return EncodedBatch(t, t.to(store.device, torch.bfloat16))


def _fuzz_chunk(store, cid: str, path: str):
    """A fuzz row's chunk, of the store's own package (its module's
    ``Chunk``)."""
    chunk_cls = sys.modules[type(store).__module__].Chunk
    return chunk_cls(id=cid, file_path=Path(path), start_line=1,
                     end_line=2, content="c")


class StoreFuzz:
    """``fuzz_ops`` applied to several stores in lockstep, with the rows
    the sequence wrote: ``opens`` are callables that open (and reopen)
    each store, ``places`` each store's placement of an add's rows
    (:func:`fuzz_place` by default). After every op each store's
    ``live_rows`` must equal the sequence's live rows, and a remove's
    count its live rows of the file, in every store; a search returns each
    store's answer as a list of (chunk id, score), best first."""

    def __init__(self, opens, places=None):
        self.opens = list(opens)
        self.places = list(places or [fuzz_place] * len(self.opens))
        self.stores = [open_() for open_ in self.opens]
        self.vecs = {}            # chunk id -> its f32 row
        self.alive = {}           # chunk id -> live
        self.by_file = {}         # path -> chunk ids
        self.steps = Counter()

    def live(self) -> list:
        return [cid for cid, ok in self.alive.items() if ok]

    def apply(self, op, where: str = "") -> list:
        kind = op[0]
        self.steps[kind] += 1
        answers = []
        if kind == "add":
            _, path, first, rows, placement = op
            ids = [f"{path}:{first + j}" for j in range(len(rows))]
            for store, place in zip(self.stores, self.places):
                chunks = [_fuzz_chunk(store, cid, path) for cid in ids]
                store.add_chunks(chunks, place(store, rows, placement))
            for cid, v in zip(ids, rows):
                self.vecs[cid] = v
                self.alive[cid] = True
                self.by_file.setdefault(path, []).append(cid)
        elif kind == "remove":
            path = op[1]
            want = sum(self.alive[c] for c in self.by_file[path])
            got = [store.remove_file_chunks(Path(path))
                   for store in self.stores]
            _check(got == [want] * len(got), f"{where}: remove {path} "
                   f"counted {got}, {want} rows were live")
            for c in self.by_file[path]:
                self.alive[c] = False
        elif kind == "reopen":
            for store in self.stores:
                store.close()
            self.stores = [open_() for open_ in self.opens]
        else:
            _, q, k = op
            for store in self.stores:
                s, i = store.search_batch(q, k)
                answers.append([(store.chunk_at(int(r)).id, float(v))
                                for v, r in zip(s[0], i[0])
                                if np.isfinite(v)])
        n_live = len(self.live())
        got = [store.live_rows for store in self.stores]
        _check(got == [n_live] * len(got),
               f"{where}: live_rows {got}, the sequence has {n_live}")
        return answers

    def oracle(self, q: np.ndarray, k: int, q16: bool) -> list:
        """The sequence's own answer: the live rows in bf16, as stored,
        against the query (``fuzz_query``), the best ``min(k, live)``
        (stable)."""
        live = self.live()
        if not live:
            return []
        rows = torch.from_numpy(np.stack([self.vecs[c] for c in live]))
        scores = rows.to(torch.bfloat16).float().numpy() @ fuzz_query(q, q16)
        order = np.argsort(-scores, kind="stable")[:k]
        return [(live[i], float(scores[i])) for i in order]

    def close(self) -> None:
        for store in self.stores:
            store.close()


def fuzz_query(q: np.ndarray, q16: bool) -> np.ndarray:
    """The query as a store scores it: a bf16/f16 store's scan rounds it
    to bf16 (``q16``); an int8 store's rescore takes it in f32."""
    q = torch.from_numpy(q[0])
    return (q.to(torch.bfloat16).float() if q16 else q).numpy()


def fuzz_agree(got: list, want: list, vecs: dict, q: np.ndarray,
               q16: bool, tol: float = FUZZ_TOL, what: str = "") -> float:
    """One search's answers of two stores, by ``chip_smoke.check_scan``'s
    rules: the same number of hits, scores within ``tol``, and where the
    chunks differ, the first store's chunk scores (its row in bf16, as
    stored, against the query as the store takes it, :func:`fuzz_query`)
    within ``tol`` of the second's score in that slot; no chunk twice. An
    int8 store's hits are re-scored from the same bf16 rows, so the same
    rules hold. Returns the max abs score error."""
    _check(len(got) == len(want), f"{what}: {len(got)} hits, want "
           f"{len(want)}")
    if not want:
        return 0.0
    gs = np.array([s for _, s in got])
    ws = np.array([s for _, s in want])
    err = float(np.abs(gs - ws).max())
    _check(err <= tol, f"{what}: scores differ by {err}")
    for (gi, _), (wi, w) in zip(got, want):
        if gi != wi:
            row = torch.from_numpy(vecs[gi]).to(torch.bfloat16).float()
            own = float(row.numpy() @ fuzz_query(q, q16))
            _check(abs(own - w) <= tol, f"{what}: {gi} ({own}) where the "
                   f"other store has {wi} ({w})")
    _check(len({g for g, _ in got}) == len(got), f"{what}: a chunk twice")
    return err


def fuzz_case(work: Path, dtype: str, mode: str, seed: int, d: int,
              devices) -> dict:
    """One op sequence through the port's store on each of ``devices`` in
    lockstep (the first the one under test, the others references, such
    as the plain versions on the CPU), in ``mode``'s geometry: after every
    search each store's answer against the sequence's own
    (:meth:`StoreFuzz.oracle`) and the first store's against each other's,
    by :func:`fuzz_agree`, no removed chunk among them. Returns the steps,
    the comparisons, the max score error and the buckets of the last build
    (sealed, spilled, clustered)."""
    ivf = mode in ("ivf", "ivf+spill")
    q16 = dtype != "int8"
    case = work / f"fuzz-{dtype}-{mode}-{seed}"
    opens = [lambda dev=dev, i=i: VectorStore(
        case / f"store{i}", d, "fuzz", store_dtype=dtype, device=dev,
        ivf=ivf) for i, dev in enumerate(devices)]
    what = f"fuzz {dtype} {mode} seed {seed}"
    with fuzz_geometry(mode, d, (VectorStore,)):
        run = StoreFuzz(opens)
        err, compared = 0.0, 0
        for step, op in enumerate(fuzz_ops(seed, d)):
            answers = run.apply(op, f"{what} step {step}")
            if answers:
                want = run.oracle(op[1], op[2], q16)
                for got in answers:
                    fuzz_agree(got, want, run.vecs, op[1], q16,
                               what=f"{what} step {step} oracle")
                    _check(all(run.alive[c] for c, _ in got),
                           f"{what} step {step}: a removed chunk")
                for other in answers[1:]:
                    err = max(err, fuzz_agree(
                        answers[0], other, run.vecs, op[1], q16,
                        what=f"{what} step {step}"))
                    compared += 1
        buckets = run.stores[0].device_buckets()
        out = {"dtype": dtype, "mode": mode, "seed": seed,
               "steps": dict(run.steps), "compared": compared,
               "max_abs_err": err, "buckets": len(buckets),
               "sealed": sum(b["sealed"] for b in buckets),
               "spilled": sum(bool(b.get("host_resident"))
                              for b in buckets),
               "clustered": sum(b.get("ivf") is not None
                                or b.get("ivf_spill") is not None
                                for b in buckets)}
        run.close()
    return out
