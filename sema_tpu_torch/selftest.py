"""Device numeric self-test of the port: the scan and encoder paths run end
to end on the device that ``doctor`` will use (the counterpart of
``sema_tpu/selftest.py``).

A CPU-green suite holds each kernel's plain version, not the kernel: a
kernel that builds for the card but returns a wrong row, or a store that
reaches it through the wrong route, shows only there. ``python -m
sema_tpu_torch doctor`` runs these probes through the real store and
encoder, each store with planted self-match winners at rows 0, 1, rows/3,
rows-2 and rows-1 that must come back as their own row ids:

- ``scan-ids``: 300 bf16 rows, the unsealed tail (K1);
- ``scan-int8``: the same over int8 rows, rescored from bf16 (K4a);
- ``scan-spill``: a host bucket under ``SEMA_TPU_HBM_BUDGET_MB``, streamed
  in 3 slices (K1);
- ``scan-ivf``: a sealed, clustered bucket, each probe through the pruned
  scan (K3), hits mapped back through the cluster permutation;
- ``scan-spill-ivf``: 900 rows in two spilled buckets, each probe through
  the union probe's staged tiles (K3) and mapped back through the
  stage's row map;
- ``encoder-parity``: the configured encoder (K2, or K5 for W8A8) against
  the same weights in f32 on the CPU through the plain versions, over texts
  that fill each sequence bucket; min cosine >= 0.999.

An IVF probe that fell back to the exact scan fails its check: the store
records each probe's route (:func:`_pruned_routes`). The JAX package's
``scan-ids-pallas`` and ``scan-mesh`` have nothing to run here
(:data:`NOT_PORTED` says why). Each check returns ``(name, ok, detail)``,
its seconds at the end of the detail.
"""

from __future__ import annotations

import os
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

Check = Tuple[str, bool, str]

# the JAX package's checks that have no counterpart, and why
NOT_PORTED: Dict[str, str] = {
    "scan-ids-pallas": "the port has one scan route on the card (K1), "
                       "which scan-ids runs",
    "scan-mesh": "needs the store's row sharding, not ported yet",
}


@contextmanager
def _env(key: str, value: Optional[str]):
    old = os.environ.get(key)
    try:
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
        yield
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old


def _pruned_routes(store) -> List[int]:
    """A one-entry list counting the store's IVF probes that took the
    pruned scan (a bucket's probe through K3/K4b, or the spilled union's
    staged probe); a probe that falls back returns None from its route and
    is not counted. Wraps the two routes on this store instance only."""
    taken = [0]

    def counted(route):
        def call(*args, **kwargs):
            got = route(*args, **kwargs)
            taken[0] += got is not None
            return got
        return call

    store._ivf_scan = counted(store._ivf_scan)
    store._ivf_spill_dispatch = counted(store._ivf_spill_dispatch)
    return taken


def _scan_check(name: str, dim: int, store_dtype: str, rows: int, device,
                spill: bool = False, ivf: bool = False,
                segments: int = 1) -> Check:
    from sema_tpu_torch.index.vector_store import VectorStore
    from sema_tpu_torch.types import Chunk

    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((rows, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    chunks = [Chunk(id=f"r{i}", file_path=Path("selftest.txt"),
                    start_line=1, end_line=1, content="")
              for i in range(rows)]
    probes = [0, 1, rows // 3, rows - 2, rows - 1]
    with tempfile.TemporaryDirectory() as td, \
            _env("SEMA_TPU_IVF_NPROBE", "2" if ivf else None), \
            _env("SEMA_TPU_HBM_BUDGET_MB", "0.000001" if spill else None):
        store = VectorStore(td, dim=dim, model="selftest",
                            store_dtype=store_dtype, device=device, ivf=ivf)
        try:
            if spill:
                # instance-level shrink so this small store seals, spills
                # and streams in more than one slice
                store.SEAL_ROWS = 128
                store.SPILL_SLICE_ROWS = 128
            if ivf:
                # seals and clusters at this size: tiles of 128 rows, and
                # every tile admissible, so that an nprobe-2 self-match
                # probe always fits the budget and must take the pruned
                # scan (the JAX package pads to 16 tiles instead)
                store.SEAL_ROWS = 256
                store.IVF_TILE = 128
                store.IVF_CLUSTER_ROWS = 128
                store.IVF_BUDGET_DIV = 1
            bounds = np.linspace(0, rows, segments + 1).astype(int)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                store.add_chunks(chunks[lo:hi], vecs[lo:hi])
            misses = []
            buckets = store.device_buckets()
            if spill and not all(b.get("host_resident") for b in buckets):
                misses.append("store did not spill (check is vacuous)")
            ivf_field = "ivf_spill" if (ivf and spill) else "ivf"
            if ivf and not any(b.get(ivf_field) is not None
                               for b in buckets):
                misses.append("store did not cluster (check is vacuous)")
            pruned = _pruned_routes(store)
            for p in probes:
                before = pruned[0]
                res = store.search(vecs[p], k=1)
                got = res[0][0].id if res else "<none>"
                if got != f"r{p}":
                    misses.append(f"row {p} -> {got}")
                if ivf and pruned[0] == before:
                    misses.append(f"row {p}: probe fell back to the exact "
                                  "scan (pruned kernel never dispatched)")
        finally:
            store.close()
    if misses:
        return (name, False, "planted winners missed: " + "; ".join(misses))
    return (name, True, f"{len(probes)} planted winners exact "
                        f"({rows} rows, {store_dtype}"
                        f"{', spilled' if spill else ''}"
                        f"{', ivf-pruned' if ivf else ''})")


# one text a sequence bucket (32, 64, 128, 256 tokens), so that the
# attention of the parity check reads more than one key tile
PARITY_WORDS = (6, 20, 50, 110, 200)


def _parity_texts() -> List[str]:
    words = ("self test document number with a few more words to cross "
             "one vector register and then some").split()
    return [f"{i}: " + " ".join(words[j % len(words)] for j in range(n))
            for i, n in enumerate(PARITY_WORDS)]


def _encoder_parity_check(model_cfg, enc=None, device=None) -> Check:
    """The configured encoder against the same weights in f32 on the CPU,
    through the plain versions (the counterpart of the JAX package's XLA
    f32 reference). Pass ``enc`` to reuse an encoder already built (doctor
    holds one); only the f32 reference is built here."""
    from dataclasses import replace

    from sema_tpu_torch.models import Encoder

    texts = _parity_texts()
    if enc is None:
        enc = Encoder.from_config(model_cfg, device=device)
    with _env("SEMA_TPU_ENCODER_QUANT", "none"):
        ref = Encoder.from_config(
            replace(model_cfg, dtype="float32", quant="none"), device="cpu")
    a = enc.encode_texts(texts)
    b = ref.encode_texts(texts)
    cos = float((a * b).sum(dim=1).min())
    ok = cos >= 0.999
    return ("encoder-parity", ok,
            f"min cosine {cos:.6f} vs f32 on the CPU (gate >= 0.999; "
            f"{enc.spec.name}, quant={enc.quant}, {enc.device})")


def _timed(check) -> Check:
    t0 = time.perf_counter()
    name, ok, detail = check()
    return name, ok, f"{detail} [{time.perf_counter() - t0:.3f} s]"


def run_device_selftest(model_cfg=None, dim: int = 384,
                        with_encoder: bool = True, encoder=None,
                        device="cuda") -> List[Check]:
    """Every check on ``device`` (default ``cuda``, which raises without a
    card), in the JAX package's order less :data:`NOT_PORTED`."""
    checks = [
        lambda: _scan_check("scan-ids", dim, "bfloat16", 300, device),
        lambda: _scan_check("scan-int8", dim, "int8", 300, device),
        lambda: _scan_check("scan-spill", dim, "bfloat16", 300, device,
                            spill=True),
        lambda: _scan_check("scan-ivf", dim, "bfloat16", 300, device,
                            ivf=True),
        # two spilled buckets: the union probe maps each stage row back
        # through its bucket's row offset
        lambda: _scan_check("scan-spill-ivf", dim, "bfloat16", 900, device,
                            ivf=True, spill=True, segments=2),
    ]
    if with_encoder and model_cfg is not None:
        checks.append(lambda: _encoder_parity_check(model_cfg, enc=encoder,
                                                    device=device))
    return [_timed(check) for check in checks]
