#!/usr/bin/env python3
"""The A/B runs behind the plan of K1's wgmma route
(``sema_tpu_torch/csrc/scan_topk.cu:wgmma_scorers``, planned by
``ops/scan_topk.py:wgmma_layout`` and ``_plan``), on one NVIDIA card,
each side timed in turns in the same process (CUDA events: the plan's
side, the other, the other, the plan's, the plan's, the other; 5 calls a
turn) and held bit for bit to the first side's result:

    python3 chip_wgmma_ab.py                 # from the repository root
    python3 chip_wgmma_ab.py --phases crossover

Phases (``--phases a,b``; default both):

1. ``crossover``: K1 (bf16 rows, f32 queries, masked) at every n of
   CROSS_N, Q of CROSS_Q, d of CROSS_D and k of CROSS_K, the wgmma route
   (``wgmma_layout``'s layout) against the mma.sync scorers of the same
   build (the plan forced to them), with each side's query block, stages
   and chunks: where the route loses, the shapes the plan leaves to the
   mma.sync scorers.
2. ``layouts``: at each shape of LAYOUT_SHAPES, the plan's (query block,
   score buffers, ring stages) against the other score-buffer count, a
   ring of three and of four stages, and blocks of 32 queries where the
   plan takes 64.
3. ``consumers``: at each shape of LAYOUT_SHAPES where the plan takes two
   score buffers, and so two consumer warpgroups on alternate tiles,
   against a build of this tree's source whose one warpgroup takes every
   tile, bit for bit.
4. ``split``: where a batch's time goes, at each shape of LAYOUT_SHAPES:
   the route against builds of this tree's source (``build/var/<name>/``)
   without the merge (no query flagged, so the mergers only hand the
   score buffers back), without the products (no wgmma issued: the ring
   streamed, the epilogue written), and with neither. Their results are
   not K1's and are not compared.

Prints one JSON line a measurement, then the card's ``nvidia-smi`` line.
Exits non-zero when any side's result differs from the first side's, or
where a variant's edit does not apply.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import torch

import chip_smoke as cs

CROSS_N = (3_000, 16_384, 65_536, 262_144)
CROSS_Q = (16, 64, 256)
CROSS_D = (384, 768, 1024)
CROSS_K = (16, 64)
# (n, Q, d, k): the batches the route was built for
LAYOUT_SHAPES = ((262_144, 256, 768, 64), (262_144, 256, 768, 16),
                 (262_144, 256, 768, 128), (1 << 20, 64, 768, 10),
                 (1 << 20, 256, 384, 10), (1 << 20, 256, 384, 64),
                 (262_144, 256, 1024, 64), (262_144, 64, 1024, 64))
ORDER = (0, 1, 1, 0, 0, 1)    # the plan's side first, in turns
ROOT = Path(__file__).resolve().parent
NO_MERGE = ("csrc/scan_topk.cu",
            "const bool mine = qj < nqb && hit[b * QB + qj];",
            "const bool mine = false;")
NO_PRODUCTS = ("csrc/scan_topk.cu",
               "for (int kk = 0; kk < 4; ++kk)  // k16 steps",
               "for (int kk = 0; kk < 0; ++kk)  // k16 steps")
SPLITS = {"no merge": [NO_MERGE], "no products": [NO_PRODUCTS],
          "stream only": [NO_MERGE, NO_PRODUCTS]}
ONE_CONSUMER = ("csrc/scan_topk.cu",
                "const int wg = warp / 4, consumers = nb;",
                "const int wg = warp / 4, consumers = 1;")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


@contextmanager
def route(ours, layout):
    """``ours``'s plan with ``wgmma_layout`` replaced by ``layout`` (a
    function of (d, k, Q), None for the mma.sync scorers), planned anew."""
    saved = ours.wgmma_layout
    ours.wgmma_layout = layout
    ours._plan.cache_clear()
    try:
        yield
    finally:
        ours.wgmma_layout = saved
        ours._plan.cache_clear()


def turns(ours, what, sides, args, iters=5) -> dict:
    """``ours.scan_topk(*args)`` under each of two layouts ``sides``
    ({name: layout}), timed in the turns of ORDER; each side's result
    must equal the first side's bit for bit. Returns each side's mean
    ms and plan."""
    names = list(sides)
    out, first = {"case": what}, None
    times = {name: [] for name in names}
    n, nq, d = args[0].shape[0], args[1].shape[0], args[0].shape[1]
    for name in names:
        with route(ours, sides[name]):
            got = ours.scan_topk(*args)
            torch.cuda.synchronize()
            p = ours.plan_on(cs.DEV, n, nq, d, 2, args[3])
            out[f"{name}_plan"] = {"qb": p.qb, "nb": p.nb, "stages": p.stages,
                                   "chunks": p.chunks, "smem": p.smem}
        if first is None:
            first = got
        else:
            cs.check(torch.equal(got[0], first[0])
                     and torch.equal(got[1], first[1]),
                     f"{what}: {name} differs from {names[0]}")
    for i in ORDER:
        with route(ours, sides[names[i]]):
            times[names[i]].append(cs.device_ms(
                lambda: ours.scan_topk(*args), iters))
    for name in names:
        out[f"{name}_ms"] = sum(times[name]) / len(times[name])
    out["ratio"] = out[f"{names[0]}_ms"] / out[f"{names[1]}_ms"]
    return out


def phase_crossover(ours, gen):
    plan = ours.wgmma_layout
    for d in CROSS_D:
        for n in CROSS_N:
            store, q, valid = cs.k1_inputs(n, max(CROSS_Q), d, torch.bfloat16,
                                           gen)
            for nq in CROSS_Q:
                for k in CROSS_K:
                    if plan(d, k, nq) is None:
                        continue
                    emit("crossover", n=n, q=nq, d=d, k=k, **turns(
                        ours, f"wgmma / mma.sync: ({n}, {d}), Q {nq}, k {k}",
                        {"wgmma": plan, "mma_sync": lambda *a: None},
                        (store, q[:nq], valid, k, True)))
            del store, q, valid
            torch.cuda.empty_cache()


def phase_layouts(ours, gen):
    plan = ours.wgmma_layout
    for n, nq, d, k in LAYOUT_SHAPES:
        store, q, valid = cs.k1_inputs(n, nq, d, torch.bfloat16, gen)
        qb, nb, stages = plan(d, k, nq)
        room = lambda b, buffers: ((ours._SMEM_MAX - ours._wgmma_fixed(
            d, b, k, buffers)) // (ours._RING_STAGE + 16))
        variants = {}
        if room(qb, 3 - nb) >= 3:
            variants[f"nb {3 - nb}"] = (qb, 3 - nb, room(qb, 3 - nb))
        for s in (3, 4):
            if s < stages:
                variants[f"stages {s}"] = (qb, nb, s)
        if qb == 64 and room(32, nb) >= 3:
            variants["qb 32"] = (32, nb, room(32, nb))
        for name, layout in variants.items():
            emit("layouts", n=n, q=nq, d=d, k=k, variant=name, **turns(
                ours, f"plan / {name}: ({n}, {d}), Q {nq}, k {k}",
                {"plan": plan, "variant": lambda *a, v=layout: v},
                (store, q, valid, k, True)))
        del store, q, valid
        torch.cuda.empty_cache()


def variant(name: str, edits):
    """This tree's scan source and plan with ``edits`` ((file under
    sema_tpu_torch/, old text, new text), each found once), built and
    loaded as ``chip_smoke.parent_scans`` loads another tree's."""
    from sema_tpu_torch.ops import _cuda
    root = ROOT / "build" / "var" / name.replace(" ", "_")
    for sub in ("csrc", "ops"):
        (root / "sema_tpu_torch" / sub).mkdir(parents=True, exist_ok=True)
    texts = {f: (ROOT / "sema_tpu_torch" / f).read_text()
             for f in ("csrc/scan_topk.cu", "ops/scan_topk.py",
                       "ops/_cuda.py")}
    for f, old, new in edits:
        cs.check(texts[f].count(old) == 1, f"{name}: {old!r} not in {f}")
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (root / "sema_tpu_torch" / f).write_text(text)
    out = root / "libscan_topk.so"
    proc = subprocess.run(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
         str(out), str(root / "sema_tpu_torch" / "csrc" / "scan_topk.cu")],
        capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"{name} does not build: {proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.sema_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sema_cuda_error_string.restype = ctypes.c_char_p
    return cs.parent_scans(root, lib)


def phase_consumers(ours, gen):
    mod = variant("one consumer", [ONE_CONSUMER])
    for n, nq, d, k in LAYOUT_SHAPES:
        if ours.wgmma_layout(d, k, nq)[1] != 2:
            continue
        store, q, valid = cs.k1_inputs(n, nq, d, torch.bfloat16, gen)
        args = (store, q, valid, k, True)
        want = ours.scan_topk(*args)
        got = mod.scan_topk(*args)
        torch.cuda.synchronize()
        cs.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                 f"one consumer: ({n}, {d}), Q {nq}, k {k} differs")
        times = {"two": [], "one": []}
        for i in ORDER:
            side, fn = (("two", ours.scan_topk) if i == 0
                        else ("one", mod.scan_topk))
            times[side].append(cs.device_ms(lambda: fn(*args), 5))
        emit("consumers", n=n, q=nq, d=d, k=k,
             two_ms=sum(times["two"]) / 3, one_ms=sum(times["one"]) / 3)
        del store, q, valid
        torch.cuda.empty_cache()


def phase_split(ours, gen):
    mods = {name: variant(name, edits) for name, edits in SPLITS.items()}
    for n, nq, d, k in LAYOUT_SHAPES:
        store, q, valid = cs.k1_inputs(n, nq, d, torch.bfloat16, gen)
        args = (store, q, valid, k, True)
        for name, mod in mods.items():
            times = {"route": [], name: []}
            for i in ORDER:
                side, fn = (("route", ours.scan_topk) if i == 0
                            else (name, mod.scan_topk))
                times[side].append(cs.device_ms(lambda: fn(*args), 5))
            emit("split", n=n, q=nq, d=d, k=k, variant=name,
                 route_ms=sum(times["route"]) / 3,
                 variant_ms=sum(times[name]) / 3)
        del store, q, valid
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="crossover,layouts,consumers,split")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_wgmma_ab: no card", file=sys.stderr)
        return 1
    from sema_tpu_torch.ops import _cuda
    _cuda.build(["scan_topk"])
    torch.backends.cuda.matmul.allow_tf32 = False
    ours = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    if "crossover" in phases:
        phase_crossover(ours, gen)
    if "layouts" in phases:
        phase_layouts(ours, gen)
    if "consumers" in phases:
        phase_consumers(ours, gen)
    if "split" in phases:
        phase_split(ours, gen)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
