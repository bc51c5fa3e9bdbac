#!/usr/bin/env python3
"""The A/B runs behind the design of K5's and K2's LayerNorm GEMMs and
K5's row quantizations at an index batch
(``sema_tpu_torch/csrc/encoder_layer.cu``: ``gemm_wgmma_kernel``'s
EPI_LN, ``quantize_rows_kernel``, ``layer_int8``), on one NVIDIA card:

    python3 chip_layer_ab.py                 # from the repository root
    python3 chip_layer_ab.py --variants no_prefetch --cases k5:gte-large:256
    python3 chip_layer_ab.py --source build/parent --variants mma_no_softmax

Each variant is a build of this tree's ``csrc/encoder_layer.cu`` (or of
the tree ``--source`` names, another revision unpacked by ``git
archive``: the variants of its own kernels) with one edit (VARIANTS),
one ``nvcc`` each, all started together, into ``build/var/layer/``.
Every case of CASES runs through every build on the
same inputs, with the layer's operands gathered once as the Encoder
gathers them: the output bit for bit against this tree's build (the
variants marked timing-only compute another function and are not
compared), CUDA-event ms in turns (the builds in order, then in reverse,
twice) and each of the layer's launches apart (torch.profiler). A "k5x2"
case is two K5 layers in turn with the int8 rows carried
(``chip_smoke.chained_int8``); a "k7" case the attention launch alone
(K7 at the model's full width, tp 1).

Prints one JSON line a case, then the card's ``nvidia-smi`` line. Exits
non-zero, before the measurements, where a variant's edit does not
apply, and after them when an output that must be equal differs.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "sema_tpu_torch" / "csrc" / "encoder_layer.cu"
OUT = ROOT / "build" / "var" / "layer"
# the wgmma attention's probabilities of a k16 step, as the source has them
PA_LINE = ("          a[4 * kb + r] = Ty<DT>::pack(softmax_quotient(e[2 * r], "
           "sum[r & 1], inv[r & 1]),\n                                       "
           "softmax_quotient(e[2 * r + 1], sum[r & 1], inv[r & 1]));")
# name: ([(old text, new text), ...] edits of SOURCE, bit-equal to the
# product's build)
VARIANTS = {
    # the LayerNorm GEMMs' residual rows not prefetched into L2
    "no_prefetch": ([("    else if (LN && threadIdx.x >= 32) {",
                      "    else if (LN && threadIdx.x >= 32 && M < 0) {")],
                    True),
    # each int8 value by an IEEE division (__fdiv_rn), not by the row's
    # reciprocal and one correction
    "fdiv_quant": ([("  return max(-127, min(127, __float2int_rn(quotient(v, sx, "
                     "inv))));", "  return quant_value(v, sx);")], True),
    # timing only, where a LayerNorm GEMM's time goes: its rows never
    # normalised, no residual read, no int8 rows written by the LayerNorm
    "no_ln_rows": ([("      cluster_rows_regs<DT, BN>(reinterpret_cast<const "
                     "float*>(ring), kWgBM,",
                     "      if (M < 0) cluster_rows_regs<DT, BN>("
                     "reinterpret_cast<const float*>(ring), kWgBM,")], False),
    "no_resid": ([("               Ty<DT>::to_f(resid[o + lane + 32 * i]);",
                   "               0.f;")], False),
    "no_ln_quant": ([("                                ep.out, ep.outq, ep.outs, "
                      "(wg - 1) * 4 + warp);", "                                "
                      "ep.out, nullptr, ep.outs, (wg - 1) * 4 + warp);")],
                    False),
    # timing only, where the mma.sync attention's time goes (PR 22's
    # attention_kernel; run with --source on a tree that has it): no
    # exponential, sum or quotient (the probabilities are the rounded
    # scores); no P.V product (the probabilities still computed, folded
    # into one accumulator); no scores written to shared memory between the
    # passes (the later passes read what is there)
    "mma_no_softmax": ([("          sum[h] += softmax_exp(v.x, mx[h]);\n"
                         "          sum[h] += softmax_exp(v.y, mx[h]);\n", ""),
                        ("    return Ty<DT>::pack(softmax_quotient(softmax_exp("
                         "v.x, mx[h]), sum[h], inv[h]),\n                      "
                         "  softmax_quotient(softmax_exp(v.y, mx[h]), sum[h], "
                         "inv[h]));", "    return w;")], False),
    "mma_no_pv": ([("      a[3] = probs(sj[96], 1);\n#pragma unroll\n"
                    "      for (int np = 0; np < NO / 2; ++np) {",
                    "      a[3] = probs(sj[96], 1);\n      o[0][0] += "
                    "__uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3]);\n"
                    "      for (int np = 0; np < 0; ++np) {")], False),
    "mma_no_score_stores": ([("        sj[(t * 2 + h) * 32] = pair;\n", "")],
                            False),
    # timing only, where the wgmma attention's time goes: no exponential
    # and no quotient (a product and the exponential's input instead); no
    # P V products (the probabilities still computed); no context stored
    "aw_no_softmax": ([("          v[0] = softmax_exp(v[0], mx[h]);",
                        "          v[0] = v[0] * 1e-3f;"),
                       ("          v[1] = softmax_exp(v[1], mx[h]);",
                        "          v[1] = v[1] * 1e-3f;"),
                       (PA_LINE, "          a[4 * kb + r] = Ty<DT>::pack("
                                 "e[2 * r], e[2 * r + 1]);")], False),
    "aw_no_pv": ([("      for (int kb = 0; kb < 4; ++kb)\n        wgmma_16_rs<",
                   "      for (int kb = 0; kb < 4 && S < 0; ++kb)\n"
                   "        wgmma_16_rs<")], False),
    "aw_no_store": ([("      tma_store_3d(&map_ctx, mine_out,",
                      "      if (S < 0) tma_store_3d(&map_ctx, mine_out,")],
                    False),
    # each score's scale and bias in one FFMA: the same bits only where the
    # scale is a power of two (head dim 64) and the product is normal
    "aw_ffma_scores": ([("Ty<DT>::pack(__fadd_rn(__fmul_rn(v[0], scale), bb.x),\n"
                         "                                                       "
                         "__fadd_rn(__fmul_rn(v[1], scale), bb.y))",
                         "Ty<DT>::pack(__fmaf_rn(v[0], scale, bb.x), "
                         "__fmaf_rn(v[1], scale, bb.y))")], False),
    # the ring of one pair stage: no pair's copies fly while another is used
    "aw_one_stage": ([("    p.stages = aw_stages(p.hd, p.tile);",
                       "    p.stages = 1;")], True),
    # the scores of a row as one m64n64 product a key chunk and k16 step,
    # not one m64n(64 NT)
    "aw_n64_scores": ([("    if constexpr (NT != 3) {  // every key at once",
                        "    if constexpr (NT != 3 && false) {  // every key "
                        "at once")], True),
    # the wgmma route at the 32-key buckets too (the plan keeps the mma.sync
    # kernel there)
    "aw_at_32_keys": ([("  } else if (S > 32 && S <= kAwMaxChunks * kAwChunk",
                        "  } else if (S > 0 && S <= kAwMaxChunks * kAwChunk")],
                      True),
    # the two warpgroups' Q K^T products in turn (named barriers 1 and 2,
    # warpgroup 0 first): one's products on the tensor cores while the
    # other's softmax runs
    "aw_pingpong": ([("  const int items = mine * NT;\n",
                      "  const int items = mine * NT;\n  if (wg == 1) asm "
                      "volatile(\"bar.arrive 1, 256;\\n\" ::: \"memory\");\n"),
                     ("    float sc[NT * 32];  // key chunk j's scores, then "
                      "exponentials: sc[32 j ..]\n    wgmma_fence();",
                      "    float sc[NT * 32];  // key chunk j's scores, then "
                      "exponentials: sc[32 j ..]\n    asm volatile(\"bar.sync "
                      "%0, 256;\\n\" ::\"r\"(1 + wg) : \"memory\");\n"
                      "    wgmma_fence();"),
                     ("    fence_acc<NT * 32>(sc);\n",
                      "    fence_acc<NT * 32>(sc);\n    if (it + 1 < items) asm "
                      "volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(2 - wg) : "
                      "\"memory\");\n")], True),
    # each exponential computed again for its probability (the mma.sync
    # kernel's way), not kept from the sum
    "aw_exp_twice": ([("          v[0] = softmax_exp(v[0], mx[h]);\n"
                       "          sum[h] += v[0];\n"
                       "          v[1] = softmax_exp(v[1], mx[h]);\n"
                       "          sum[h] += v[1];",
                       "          sum[h] += softmax_exp(v[0], mx[h]);\n"
                       "          sum[h] += softmax_exp(v[1], mx[h]);"),
                      (PA_LINE, "          a[4 * kb + r] = Ty<DT>::pack("
                       "softmax_quotient(softmax_exp(e[2 * r], mx[r & 1]), "
                       "sum[r & 1], inv[r & 1]),\n                          "
                       "             softmax_quotient(softmax_exp(e[2 * r + 1], "
                       "mx[r & 1]), sum[r & 1], inv[r & 1]));")], True),
}
# (kind, model, B, S): K5 or K2 one layer, or two K5 layers in turn
CASES = (("k5", "gte-large", 256, 256), ("k5", "gte-large", 2048, 32),
         ("k5", "gte-large", 64, 256), ("k5", "gte-large", 1, 256),
         ("k5x2", "gte-large", 256, 256), ("k5", "minilm-l6", 256, 256),
         ("k2", "gte-large", 256, 256), ("k2", "gte-large", 2048, 32),
         ("k2", "e5-base", 256, 256), ("k2", "minilm-l6", 256, 256),
         ("k7", "gte-large", 256, 256), ("k7", "minilm-l6", 256, 256),
         ("k7", "e5-base", 256, 256),
         ("k7", "gte-large", 2048, 32), ("k7", "minilm-l6", 2048, 32))


def variant_sources(names, source=SOURCE) -> dict:
    """{name: source text}, "product" ``source`` unchanged; raises where
    an edit does not apply exactly once."""
    src = source.read_text()
    out = {"product": src}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            cs.check(text.count(old) == 1, f"{name}: edit does not apply: "
                     f"{old[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict, csrc=None) -> dict:
    """Each source built with the port's nvcc flags (its headers from
    ``csrc``, this tree's by default), all at once, and loaded with the
    entry points the layer wrappers bind: {name: lib}."""
    import ctypes

    from sema_tpu_torch.ops import _cuda, attention, encoder_layer
    from sema_tpu_torch.ops import encoder_layer_int8
    csrc = csrc or _cuda.CSRC
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, lib = OUT / f"encoder_layer_{name}.cu", OUT / f"lib{name}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(csrc), "-o",
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
        cs.bind(lib, (encoder_layer, encoder_layer_int8, attention))
        libs[name] = lib
    return libs


def case_fn(kind, name, b, s, gen):
    """(what, fn, launches a call): the case's call on its inputs, with
    the layers' operands gathered once."""
    from sema_tpu_torch.models.bert import LN_EPS
    from sema_tpu_torch.models.registry import get_spec
    from sema_tpu_torch.ops import encoder_layer, encoder_layer_int8
    spec = get_spec(name)
    dt = cs.BF16
    x, _, bias, heads, scale = cs.layer_inputs(spec, dt, b, s, gen)
    if kind == "k7":
        from sema_tpu_torch.ops.attention import fused_attention_qkv
        qkv = (1.5 * torch.randn(b, s, 3 * spec.hidden_size, generator=gen,
                                 device=cs.DEV)).to(dt)
        return (f"K7 {name} bf16 ({b}, {s})",
                lambda: fused_attention_qkv(qkv, bias, heads, scale), 1)
    if kind == "k2":
        layer = cs.layer_params(spec.hidden_size, spec.intermediate_size, gen)
        ops = encoder_layer.layer_operands(layer, dt)
        return (f"K2 {name} bf16 ({b}, {s})",
                lambda: encoder_layer.fused_encoder_layer(
                    x, layer, bias, heads, scale, LN_EPS, operands=ops), 5)
    layers = [cs.int8_layer_params(spec, gen)
              for _ in range(2 if kind == "k5x2" else 1)]
    ops = [encoder_layer_int8.layer_operands(lay, dt) for lay in layers]
    rows = encoder_layer_int8.row_buffers(x) if kind == "k5x2" else None
    args = (x, bias, heads, scale, LN_EPS)
    what = f"K5{' x2 carried' if rows is not None else ''} {name} bf16 " \
           f"({b}, {s})"
    return what, lambda: cs.chained_int8(layers, args, ops, rows), \
        15 if rows is not None else 8


def run_case(libs: dict, kind, name, b, s, gen) -> dict:
    what, fn, per_call = case_fn(kind, name, b, s, gen)
    fns = {n: cs.in_library(fn, lib) for n, lib in libs.items()}
    want = fns["product"]()
    torch.cuda.synchronize()
    bits = {}
    for n, f in fns.items():
        got = f()
        bits[n] = all(torch.equal(g, w) for g, w in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
    ms = {n: [] for n in libs}
    order = list(libs) + list(libs)[::-1]
    for n in order + order:
        ms[n].append(cs.device_ms(fns[n], 50 if b == 1 else 10))
    launches = {n: [[str(l.get("kernel")), round(l["ms"], 4)]
                    if "ms" in l else l for l in
                    cs.launch_profile(f, per_call)]
                for n, f in fns.items()}
    return {"case": what, "bit_equal": bits,
            "ms": {n: sum(v) / len(v) for n, v in ms.items()},
            "ratio_to_product": {n: sum(v) / sum(ms["product"])
                                 for n, v in ms.items()},
            "launch_ms": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated VARIANTS (default: all)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated KIND:MODEL:B of CASES "
                         "(default: all)")
    ap.add_argument("--source", default=None,
                    help="another tree whose csrc/encoder_layer.cu the "
                         "variants edit (default: this tree's)")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs an NVIDIA card")
    names = args.variants.split(",")
    csrc = (Path(args.source).resolve() / "sema_tpu_torch" / "csrc"
            if args.source else None)
    libs = build(variant_sources(names, csrc / "encoder_layer.cu" if csrc
                                 else SOURCE), csrc)
    cases = [c for c in CASES if args.cases is None
             or f"{c[0]}:{c[1]}:{c[2]}" in args.cases.split(",")]
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    differ = []
    for kind, name, b, s in cases:
        row = run_case(libs, kind, name, b, s, gen)
        differ += [f"{row['case']} {n}" for n, ok in row["bit_equal"].items()
                   if not ok and (n == "product" or VARIANTS[n][1])]
        cs.emit("layer_ab", **row)
        torch.cuda.empty_cache()
    print(cs.smi_line(), flush=True)
    cs.check(not differ, f"not bit-equal to this tree's build: {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
