#!/usr/bin/env python3
"""The A/B runs behind the design of the f32 route's SIMT GEMM
(``sema_tpu_torch/csrc/encoder_layer.cu:gemm_simt_kernel``, planned by
``simt_plan``), on one NVIDIA card:

    python3 chip_simt_ab.py                  # from the repository root
    python3 chip_simt_ab.py --variants ln_regs,ln_128 --cases minilm-l6:256

Each variant is a build of this tree's ``csrc/encoder_layer.cu`` with one
edit (VARIANTS), one ``nvcc`` each, all started together, into
``build/var/simt/``. K2 in f32 at each case of CASES runs through every
build on the same inputs, with the layer's operands gathered once as the
Encoder gathers them: the output bit for bit against this tree's build,
CUDA-event ms in turns (the builds in order, then in reverse) and each of
the layer's five launches apart (torch.profiler: qkv GEMM, attention,
out-proj + LN1, FFN up, FFN down + LN2). Then the library's f32 product
(``torch.mm``, TF32 off) at the layers' GEMM shapes, and each build's
plan of MiniLM's and gte-large's LayerNorm GEMMs with the clusters of it
the card holds at once (``sema_layer_plan``).

Prints one JSON line a measurement, then the card's ``nvidia-smi`` line.
Exits non-zero, before the measurements, where a variant's edit does not
apply, and after them when any output differs from this tree's.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "sema_tpu_torch" / "csrc" / "encoder_layer.cu"
OUT = ROOT / "build" / "var" / "simt"
LN_CALL = ("    cluster_rows<DT_F32>(slice, BN, BM, m0, M, N, gamma, beta, eps, "
           "out, nullptr, nullptr,\n                         slice + BM * "
           "(BN + 8));")
# name: [(old text, new text), ...] edits of SOURCE
VARIANTS = {
    # the LayerNorm's rows in registers (cluster_rows_regs), no row a warp
    # in shared memory
    "ln_regs": [(LN_CALL, "    cluster_rows_regs<DT_F32>(slice, BN, BM, m0, "
                 "M, N, gamma, beta, eps, out, nullptr, nullptr,\n"
                 "                              tid >> 5);"),
                ("+ (size_t)(kGemmThreads / 32) * N) * sizeof(float);",
                 ") * sizeof(float);")],
    # no LayerNorm tile of 128 x 64: MiniLM's in clusters of 3 of 128 x 128
    "ln_128": [("{128, 64, 8, 4, 1}", "{128, 64, 8, 4, 2}")],
    # the LayerNorm GEMMs one block an SM (more registers, no spill)
    "ln_one_block": [("__global__ void __launch_bounds__(kGemmThreads, 2)\n"
                      "gemm_simt_kernel(",
                      "__global__ void __launch_bounds__(kGemmThreads, "
                      "EPI == EPI_LN ? 1 : 2)\ngemm_simt_kernel(")],
    # slabs of 32 (three stages of 64 rows or more, five below)
    "bk32": [("constexpr int kSimtBK = 16;", "constexpr int kSimtBK = 32;"),
             ("return bm >= 64 ? 4 : 6; }", "return bm >= 64 ? 3 : 5; }")],
    # a plan that stops at 128 blocks, not 132: gte-large's one-query
    # LayerNorm GEMMs on 16-row tiles
    "fill128": [("constexpr int kSimtFill = 132;",
                 "constexpr int kSimtFill = 128;")],
    # every warp rows of TX threads (one query's 8-row tiles: one row of 32)
    "warp_rows": [("  const int tx = TX == 32 ? warp % 4 * 8 + (lane & 7) : "
                   "tid % TX;\n  const int ty = TX == 32 ? warp / 4 * 4 + "
                   "(lane >> 3) : tid / TX;",
                   "  const int tx = tid % TX, ty = tid / TX;")],
    # every warp 8 threads of 4 rows (A: 4 rows, W: 8 vectors a read)
    "warp8x4": [("  const int tx = TX == 32 ? warp % 4 * 8 + (lane & 7) : "
                 "tid % TX;\n  const int ty = TX == 32 ? warp / 4 * 4 + "
                 "(lane >> 3) : tid / TX;",
                 "  const int tx = warp % (TX / 8) * 8 + (lane & 7);\n"
                 "  const int ty = warp / (TX / 8) * 4 + (lane >> 3);")],
}
# (model, B, S) of K2 in f32
CASES = (("minilm-l6", 256, 128), ("minilm-l6", 1, 256),
         ("gte-large", 256, 256), ("gte-large", 1, 256))
MM_SHAPES = ((32_768, 1152, 384), (32_768, 1536, 384), (32_768, 384, 1536),
             (65_536, 4096, 1024))


def variant_sources(names) -> dict:
    """{name: source text}, "product" this tree's source unchanged; raises
    where an edit does not apply exactly once."""
    src = SOURCE.read_text()
    out = {"product": src}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            cs.check(text.count(old) == 1, f"{name}: edit does not apply: "
                     f"{old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict) -> dict:
    """Each source built with the port's nvcc flags, all at once, and
    loaded with the entry points the layer wrappers bind: {name: lib}."""
    from sema_tpu_torch.ops import _cuda, attention, encoder_layer
    from sema_tpu_torch.ops import encoder_layer_int8
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, lib = OUT / f"encoder_layer_{name}.cu", OUT / f"lib{name}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        (OUT / f"lib{name}.log").write_text(log)
        cs.check(proc.returncode == 0, f"{name} does not build: {log[-2000:]}")
        lib = ctypes.CDLL(str(path))
        lib.sema_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sema_cuda_error_string.restype = ctypes.c_char_p
        lib.sema_layer_plan.argtypes = ([ctypes.c_int] * 5
                                        + [ctypes.POINTER(ctypes.c_int)])
        cs.bind(lib, (encoder_layer, encoder_layer_int8, attention))
        libs[name] = lib
    return libs


def layer_case(libs: dict, name: str, b: int, s: int, gen) -> dict:
    """K2 f32 at (b, s) of ``name`` through every build: bits against the
    product's, ms in turns, each launch's device ms."""
    from sema_tpu_torch.models.bert import LN_EPS
    from sema_tpu_torch.models.registry import get_spec
    from sema_tpu_torch.ops import encoder_layer
    spec = get_spec(name)
    layer = cs.layer_params(spec.hidden_size, spec.intermediate_size, gen)
    x, _, bias, heads, scale = cs.layer_inputs(spec, torch.float32, b, s, gen)
    ops = encoder_layer.layer_operands(layer, torch.float32)
    args = (x, layer, bias, heads, scale, LN_EPS)
    run = lambda *a: encoder_layer.fused_encoder_layer(*a, operands=ops)
    fns = {n: cs.in_library(run, lib) for n, lib in libs.items()}
    want = fns["product"](*args)
    bits = {n: bool(torch.equal(f(*args), want)) for n, f in fns.items()}
    ms = {n: [] for n in libs}
    for n in list(libs) + list(libs)[::-1]:
        ms[n].append(cs.device_ms(lambda: fns[n](*args), 50 if b == 1 else 10))
    launches = {n: [round(l.get("ms", 0.0), 4) for l in
                    cs.launch_profile(lambda: f(*args), 5)]
                for n, f in fns.items()}
    return {"case": f"K2 {name} f32 ({b}, {s})", "bit_equal": bits,
            "ms": {n: sum(v) / len(v) for n, v in ms.items()},
            "launch_ms": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated VARIANTS (default: all)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated MODEL:B of CASES (default: all)")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(variant_sources(args.variants.split(",")))
    cases = [c for c in CASES if args.cases is None
             or f"{c[0]}:{c[1]}" in args.cases.split(",")]
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    differ = []
    for name, b, s in cases:
        row = layer_case(libs, name, b, s, gen)
        differ += [f"{row['case']} {n}" for n, ok in row["bit_equal"].items()
                   if not ok]
        cs.emit("simt_ab", **row)
        torch.cuda.empty_cache()
    for m, n, k in MM_SHAPES:
        a = torch.randn(m, k, device=cs.DEV, generator=gen)
        w = torch.randn(k, n, device=cs.DEV, generator=gen)
        ms = cs.device_ms(lambda: a @ w, 10)
        cs.emit("simt_ab:torch.mm", m=m, n=n, k=k, ms=ms,
                tflops=2.0 * m * n * k / ms / 1e9)
        del a, w
    for n, lib in libs.items():
        for m, h, inter in ((32_768, 384, 1536), (256, 384, 1536),
                            (65_536, 1024, 4096), (256, 1024, 4096)):
            out = (ctypes.c_int * 35)()
            rc = lib.sema_layer_plan(m, h, inter, 0, 2, out)
            cs.emit("simt_ab:ln_plan", build=n, m=m, h=h, rc=rc,
                    out_proj_ln1=list(out[8:16]),
                    ln_clusters_at_once=[out[33], out[34]])
    print(cs.smi_line(), flush=True)
    cs.check(not differ, f"not bit-equal to this tree's build: {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
