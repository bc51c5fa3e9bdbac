#!/usr/bin/env python3
"""The A/B runs behind the design of the bf16/f16 scans' pass-1 merge
(``sema_tpu_torch/csrc/scan_topk.cu:scan_pass1_merged``), on one NVIDIA
card, each side timed in turns in the same process (CUDA events,
``chip_smoke.bits_case``: this tree, other, other, this tree, this tree,
other):

    python3 chip_merge_ab.py --parent-source build/parent   # from the repository root

``build/parent`` is another revision's tree (``git archive REV | tar -x
-C build/parent``). Phases (``--phases a,b``; default all):

1. ``mergers``: K1 at 1,048,576 x 384, Q 256, k 10 / 64 / 128 / 1,024,
   against builds of this tree's source with 4, 8 and 12 merger warps in
   the blocks of 16 queries or more (``Merged<QB>::kMergers``; the Python
   plan's ``_mergers`` to match), bit for bit.
2. ``copiers``: K1 over a 262,144 x 1,024 slice at Q 1, k 16 and 128,
   against a build without the copy-only warps, with pass 1's device ms
   (the profiler) on each side.
3. ``score_buffers``: one score buffer against two at each shape of
   ``mergers`` and at Q 1, k 16 / 64 / 128, beside the plan's choice.
4. ``parent``: the Q 1 path shapes (K1 on the main path's 3,600 rows, K1
   over a spill slice, K3 over an IVF probe and a spill stage) against
   the parent's kernels: CUDA-event ms in turns and each pass's device
   ms.
5. ``load_test``: ``python -m sema_tpu_torch.tools.load_test --k 50``
   (262,144 x 384, 256 clients) through the parent's tree and this one,
   parent, this, this, parent.

Prints one JSON line a measurement, then the card's ``nvidia-smi`` line.
Variant builds go to ``build/var/<name>/``. Exits non-zero, before the
measurements, where a variant's edit does not apply, and when any result
differs from this tree's.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
# (name, [(file under sema_tpu_torch/, old text, new text), ...])
MERGER_LINE = ("csrc/scan_topk.cu",
               "static constexpr int kMergers = QB == 8 ? 8 : 16;",
               "static constexpr int kMergers = QB == 8 ? 8 : {m};")
MERGER_PLAN = ("ops/scan_topk.py", "return 8 if qb == 8 else 16",
               "return 8 if qb == 8 else {m}")
VARIANTS = {f"mergers_{m}": [(f, old, new.format(m=m)) for f, old, new in
                             (MERGER_LINE, MERGER_PLAN)] for m in (4, 8, 12)}
VARIANTS["no_copiers"] = [(
    "csrc/scan_topk.cu",
    "static constexpr int kCopiers = kScorers < 8 ? 8 : kScorers;",
    "static constexpr int kCopiers = kScorers;")]
AB_SHAPES = ((256, 10), (256, 64), (256, 128), (256, 1024))
LOAD_ARGS = ["--rows", "262144", "--dim", "384", "--clients", "256",
             "--max-batch", "256", "--duration", "8", "--warmup", "3",
             "--k", "50"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def variant(name: str, edits):
    """This tree's scan source and plan with ``edits``, built and loaded
    as ``chip_smoke.parent_scans`` loads another tree's."""
    from sema_tpu_torch.ops import _cuda
    root = ROOT / "build" / "var" / name
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


def turns(what, ours, other, args, nq):
    """``bits_case`` of ``ours`` against ``other``; raises unless equal."""
    case = cs.bits_case(what, ours, other, args, 5 if nq > 1 else 20)
    cs.check(case["bit_equal"], f"{what}: not bit-equal")
    return case


def pass_ms(fn) -> dict:
    p = cs.scan_passes(fn)
    return {"pass1_ms": p.get("pass1_ms"), "pass2_ms": p.get("pass2_ms")}


def phase_mergers(ours, ab):
    store, q, valid = ab
    for name in ("mergers_4", "mergers_8", "mergers_12"):
        mod = variant(name, VARIANTS[name])
        for nq, k in AB_SHAPES:
            emit("mergers", variant=name, **turns(
                f"16 mergers / {name}: Q {nq}, k {k}",
                lambda *a: ours.scan_topk(*a),
                lambda *a, m=mod: m.scan_topk(*a),
                (store, q[:nq], valid, k, False), nq))


def phase_copiers(ours, slice_args):
    mod = variant("no_copiers", VARIANTS["no_copiers"])
    for k in (16, 128):
        args = (*slice_args[:3], k, True)
        case = turns(f"copiers / none: spill slice, Q 1, k {k}",
                     lambda *a: ours.scan_topk(*a),
                     lambda *a: mod.scan_topk(*a), args, 1)
        emit("copiers", **case, device=pass_ms(lambda: ours.scan_topk(*args)),
             device_other=pass_ms(lambda: mod.scan_topk(*args)))


def forced(ours, layout, nb):
    """``merge_layout`` with ``nb`` score buffers, the slab recomputed."""
    def plan(d, k, nq):
        qb = layout(d, k, nq)[0]
        free = ours._SMEM_MAX - ours._merged_fixed(d, qb, k, nb)
        return qb, nb, ours._even_slab(d, (free // 256 - 8) // 16 * 16)
    return plan


def phase_score_buffers(ours, ab):
    store, q, valid = ab
    layout = ours.merge_layout

    def with_nb(nb):
        def run(*a):
            ours.merge_layout = forced(ours, layout, nb)
            ours._plan.cache_clear()
            try:
                return ours.scan_topk(*a)
            finally:
                ours.merge_layout = layout
                ours._plan.cache_clear()
        return run
    for nq, k in AB_SHAPES + ((1, 16), (1, 64), (1, 128)):
        emit("score_buffers", plan=layout(cs.D, k, nq), **turns(
            f"1 / 2 score buffers: Q {nq}, k {k}", with_nb(1), with_nb(2),
            (store, q[:nq], valid, k, False), nq))


def phase_parent(ours, theirs, data, q1, gen):
    small, qs, vs = cs.k1_inputs(3_600, 1, cs.D, torch.bfloat16, gen)
    stage = np.sort(np.random.default_rng(1).choice(
        cs.SEAL // cs.SPILL_TILE, size=138, replace=False)).astype(np.int32)
    probe = np.sort(np.random.default_rng(0).choice(
        cs.SEAL // cs.IVF_TILE, size=62, replace=False)).astype(np.int32)
    rows = (data["bf16"], q1, data["valid"])
    for what, name, args in (
            ("K1 main path, k 64", "scan_topk", (small, qs, vs, 64, False)),
            ("K1 spill slice, k 16", "scan_topk", (*rows, 16, True)),
            ("K1 spill slice, k 128", "scan_topk", (*rows, 128, True)),
            ("K3 IVF probe (62 tiles of 512), k 64", "scan_topk_pruned",
             (*rows, probe, 62, 64, cs.IVF_TILE)),
            ("K3 spill stage (138 tiles of 128), k 16", "scan_topk_pruned",
             (*rows, stage, 138, 16, cs.SPILL_TILE))):
        fo, ft = getattr(ours, name), getattr(theirs, name)
        emit("parent", **turns(f"this / parent: {what}", fo, ft, args, 1),
             device=pass_ms(lambda: fo(*args)),
             device_parent=pass_ms(lambda: ft(*args)))


def phase_load_test(parent: Path):
    for side in ("parent", "this", "this", "parent"):
        proc = subprocess.run(
            [sys.executable, "-m", "sema_tpu_torch.tools.load_test",
             *LOAD_ARGS], cwd=parent if side == "parent" else ROOT,
            capture_output=True, text=True, timeout=600)
        cs.check(proc.returncode == 0, f"load_test ({side}) exited "
                 f"{proc.returncode}: {proc.stderr[-1500:]}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        emit("load_test", side=side, **{key: last[key] for key in (
            "qps", "p50_ms", "p99_ms", "capacity_qps",
            "capacity_batch_p50_ms", "errors", "mismatches", "launches",
            "batcher")})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-source", type=Path, required=True)
    ap.add_argument("--phases", default="mergers,copiers,score_buffers,"
                    "parent,load_test")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_merge_ab: no card", file=sys.stderr)
        return 1
    from sema_tpu_torch.ops import _cuda
    _cuda.build()
    ours = importlib.import_module("sema_tpu_torch.ops.scan_topk")
    parent = args.parent_source.resolve()
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    ab = cs.k1_inputs(cs.AB_N, 256, cs.D, torch.bfloat16, gen)
    data = cs.scan_store(cs.GTE_D, gen)
    q1 = cs.more_queries(data, 1, gen)
    if "mergers" in phases:
        phase_mergers(ours, ab)
    if "copiers" in phases:
        phase_copiers(ours, (data["bf16"], q1, data["valid"]))
    if "score_buffers" in phases:
        phase_score_buffers(ours, ab)
    if "parent" in phases:
        lib = cs.parent_libraries(parent, ["scan_topk"])["scan_topk"]
        phase_parent(ours, cs.parent_scans(parent, lib), data, q1, gen)
    if "load_test" in phases:
        phase_load_test(parent)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
