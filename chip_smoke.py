#!/usr/bin/env python3
"""Smoke run of ``sema_tpu_torch``, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, one JSON line each:

1. ``device``         the card, its power limit (nvidia-smi), torch and CUDA
2. ``build``          every kernel source of ``sema_tpu_torch/csrc``: one
                      ``nvcc`` each, all started together
3. ``scan_topk``      K1 against its plain version: bf16 stores of 262,144
                      and 3,000 rows at d=384, Q in {1, 256}, k in
                      {16, 64, 128}, masked and not, and f32 stores at the
                      wider models' d (768, 1024), whose rows pass 1 reads
                      in slabs. Duplicated rows must
                      give identical ids; elsewhere ids may differ only
                      between scores within 1e-5 of each other, and scores
                      agree within 1e-5 (both sum the same f32 products in
                      another order). Kernel, plain and library times
                      beside the bound.
4. ``encoder_layer``  K2 against its plain version, bf16, at MiniLM width
                      (head dim 32) at every bucket shape of the index and
                      at the query's (1, 256), and at e5-base width (head
                      dim 64): see ``layer_close`` for the limits. The
                      same limits must reject the plain version with the
                      mask dropped, with the context zeroed and with the
                      keys' heads rotated, so the check sees attention.
5. ``main_path``      ``index`` then ``query`` of a generated tree of source
                      files through the CLI (MiniLM-L6, bf16, random weights
                      from seed 0, on the card). The launch counts are set
                      to 0 before each step and read after it: the index
                      must launch K2, the query K2 and K1. A second index
                      must index 0 chunks, and neither the index's embed
                      failure warning nor the query's substring fallback
                      may fire. The stored rows (per-row cosine >= 0.9999)
                      and the query's hits are held against the plain
                      versions on a sample.

Then the kernels line, the card's ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``. Every failure raises, so the script
exits non-zero before the last line; without a card, or without the
repository beside it, it exits non-zero at once.

Bounds use the H100 SXM data sheet: 3.35 TB/s of HBM, 989 TFLOP/s of
dense bf16 and 67 TFLOP/s of f32 outside the tensor cores (at the 700 W
limit; the device line says what this card has).
"""

from __future__ import annotations

import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
D = 384                        # MiniLM-L6 width, the store's row width
DEV = torch.device("cuda")
QUERY = "retry the request with exponential backoff"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok, what="check failed") -> None:
    """Raise unless ``ok`` (an ``assert`` would vanish under ``-O``)."""
    if not ok:
        raise RuntimeError(what)


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_per_s: float = BF16_OPS_PER_S):
    """(least ms the card could take, what bounds it): each input read
    once and each output written once at the HBM rate, against the
    operations at the peak rate of their type (bf16 tensor cores unless
    given)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def launch_counts() -> dict:
    from sema_tpu_torch.ops import fused_encoder_layer, scan_topk
    return {"scan_topk": scan_topk.launches,
            "encoder_layer": fused_encoder_layer.launches}


def reset_launch_counts() -> None:
    from sema_tpu_torch.ops import fused_encoder_layer, scan_topk
    scan_topk.launches = 0
    fused_encoder_layer.launches = 0


# -- K1 -----------------------------------------------------------------------

TIE = [7] + list(range(100, 116))      # rows 100..115 duplicate row 7


def check_scan(store, queries, valid, masked, got, want) -> float:
    """Raise unless the kernel's (scores, ids) agree with the plain
    version's: the same -inf slots (id 0), scores within 1e-5, and where
    ids differ, the kernel's row scores within 1e-5 (relative, floor 1) of
    the plain version's score in that slot. Both sum the same f32
    products in another order (6.6e-7 apart at most when measured), so a
    kernel that scored in bf16 would fail. Returns the max abs error."""
    s_k, i_k = got
    s_p, i_p = want
    fin = torch.isfinite(s_p)
    check(torch.equal(torch.isfinite(s_k), fin), "-inf slots differ")
    check(not i_k[~fin].any(), "a -inf slot has an id other than 0")
    err = float((s_k[fin] - s_p[fin]).abs().max()) if fin.any() else 0.0
    check(err <= 1e-5, f"scores differ by {err}")
    differ = (i_k != i_p) & fin
    if differ.any():
        rows = store[i_k.long()].float()                        # (Q, k, d)
        own = (rows * queries.to(store.dtype).float()[:, None, :]).sum(-1)
        tol = 1e-5 * s_p.abs().clamp(min=1.0)
        check(((own - s_p).abs() <= tol)[differ].all(), "ids differ")
        if masked:
            check(valid[i_k.long()][differ].all(), "a tombstoned row")
    ids = i_k.masked_fill(~fin, -1).sort(dim=1).values
    check(not ((ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] >= 0)).any(),
          "a row appears twice")
    return err


def scan_case(n, nq, k, masked, gen, iters, d=D, dtype=torch.bfloat16):
    from sema_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference
    store = F.normalize(torch.randn(n, d, generator=gen, device=DEV), dim=1)
    store[TIE[1:]] = store[TIE[0]].clone()
    store = store.to(dtype)
    q = F.normalize(torch.randn(nq, d, generator=gen, device=DEV), dim=1)
    q[0] = store[TIE[0]].float()
    valid = torch.rand(n, generator=gen, device=DEV) > 0.1
    valid[TIE] = True
    got = scan_topk(store, q, valid, k, masked)
    want = scan_topk_reference(store, q, valid, k, masked)
    torch.cuda.synchronize()
    err = check_scan(store, q, valid, masked, got, want)
    t = min(k, len(TIE))
    check(got[1][0, :t].tolist() == TIE[:t], "tied rows out of id order")
    qb = q.to(dtype)
    ms, bound_by = bound(n * d * store.element_size() + (n if masked else 0)
                         + nq * d * 4 + nq * k * 8, 2.0 * nq * n * d,
                         F32_OPS_PER_S if dtype == torch.float32
                         else BF16_OPS_PER_S)
    return {
        "n": n, "q": nq, "k": k, "masked": masked, "d": d,
        "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
        "ms": device_ms(lambda: scan_topk(store, q, valid, k, masked), iters),
        "plain_ms": device_ms(
            lambda: scan_topk_reference(store, q, valid, k, masked), iters),
        "library_ms": device_ms(lambda: torch.topk(qb @ store.T, k), iters),
        "bound_ms": ms, "bound_by": bound_by}


def phase_scan(gen):
    cases = []
    for n in (262_144, 3_000):
        for nq in (1, 256):
            for k in (16, 64, 128):
                for masked in (True, False):
                    cases.append(scan_case(n, nq, k, masked, gen,
                                           iters=10 if n > 10_000 else 30))
    for d in (768, 1024):
        for nq in (1, 256):
            cases.append(scan_case(3_000, nq, 64, True, gen, 30, d=d,
                                   dtype=torch.float32))
    emit("scan_topk", cases=cases)


# -- K2 -----------------------------------------------------------------------

K2_SHAPES = (("minilm-l6", 2048, 32), ("minilm-l6", 1024, 64),
             ("minilm-l6", 512, 128), ("minilm-l6", 256, 256),
             ("minilm-l6", 1, 256), ("e5-base", 256, 128))
COS_MIN = 0.9995               # per output row
REL_MAX = 2.0 ** -3            # |got - want| / max(|want|, 1)


def layer_close(got, want):
    """(ok, min per-row cosine, max error relative to max(|want|, 1)).
    Both sides round to bf16 at the same places but sum in another order,
    so an intermediate (a probability, h1, a GELU input) may land one bf16
    ulp apart and carry on through the products after it. On an H100 with
    the weights of ``layer_params`` the kernel read, at worst over
    K2_SHAPES, cosine 0.99991 and a relative error of 0.052 (e5-base); the
    limits leave five and two times that. The plain version with attention
    broken (``broken_layers``, the mask dropped) and three such mutants of
    the CUDA source read cosine 0.14 to 0.42 and relative errors above 3."""
    h = got.shape[-1]
    g, w = got.float().reshape(-1, h), want.float().reshape(-1, h)
    cos = float(F.cosine_similarity(g, w, dim=1).min())
    rel = float(((g - w).abs() / w.abs().clamp(min=1.0)).max())
    return cos >= COS_MIN and rel <= REL_MAX, cos, rel


def layer_params(h, inter, gen):
    """One layer's params at sigma 0.08, as in
    tests/test_torch_encoder_layer.py: at the 0.02 of random_params the
    attention branch is 1-3% of the residual, too little for a check of the
    output to see it; at 0.08 it is as large as the residual and the
    softmax is neither flat nor one-hot. Weights bf16 as Encoder casts
    them, LayerNorm params f32."""
    w = lambda *shape: 0.08 * torch.randn(*shape, generator=gen, device=DEV)
    bf = torch.bfloat16
    return {"qkv_w": w(h, 3 * h).to(bf), "qkv_b": w(3 * h).to(bf),
            "attn_out_w": w(h, h).to(bf), "attn_out_b": w(h).to(bf),
            "ffn_in_w": w(h, inter).to(bf), "ffn_in_b": w(inter).to(bf),
            "ffn_out_w": w(inter, h).to(bf), "ffn_out_b": w(h).to(bf),
            "attn_ln_scale": 1.0 + w(h), "attn_ln_bias": w(h),
            "ffn_ln_scale": 1.0 + w(h), "ffn_ln_bias": w(h)}


def broken_layers(layer, heads):
    """The plain version's inputs with attention broken three ways: the
    context zeroed (out-proj weight 0) and the keys' heads rotated by one;
    the mask is dropped separately."""
    h = layer["qkv_w"].shape[0]
    rot_w = layer["qkv_w"].clone()
    rot_w[:, h:2 * h] = rot_w[:, h:2 * h].reshape(h, heads, -1).roll(
        1, dims=1).reshape(h, h)
    return {"zero_ctx": {**layer, "attn_out_w": torch.zeros_like(
                layer["attn_out_w"])},
            "heads_rotated": {**layer, "qkv_w": rot_w}}


def library_layer(layer, heads, eps):
    """torch.nn.TransformerEncoderLayer holding the same weights: the one
    PyTorch call that computes a post-LN BERT layer (timed, never used by
    the port)."""
    h = layer["qkv_w"].shape[0]
    inter = layer["ffn_in_w"].shape[1]
    mod = torch.nn.TransformerEncoderLayer(
        h, heads, inter, dropout=0.0, activation="gelu",
        layer_norm_eps=eps, batch_first=True, norm_first=False,
        device=DEV, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        for dst, name in ((mod.self_attn.in_proj_weight, "qkv_w"),
                          (mod.self_attn.out_proj.weight, "attn_out_w"),
                          (mod.linear1.weight, "ffn_in_w"),
                          (mod.linear2.weight, "ffn_out_w")):
            dst.copy_(layer[name].T)
        for dst, name in ((mod.self_attn.in_proj_bias, "qkv_b"),
                          (mod.self_attn.out_proj.bias, "attn_out_b"),
                          (mod.linear1.bias, "ffn_in_b"),
                          (mod.linear2.bias, "ffn_out_b"),
                          (mod.norm1.weight, "attn_ln_scale"),
                          (mod.norm1.bias, "attn_ln_bias"),
                          (mod.norm2.weight, "ffn_ln_scale"),
                          (mod.norm2.bias, "ffn_ln_bias")):
            dst.copy_(layer[name])
    return mod


def layer_case(layer, spec, b, s, gen, iters):
    from sema_tpu_torch.models.bert import LN_EPS
    from sema_tpu_torch.ops.encoder_layer import (encoder_layer_reference,
                                                  fused_encoder_layer)
    h, heads, inter = spec.hidden_size, spec.num_heads, spec.intermediate_size
    scale = 1.0 / math.sqrt(h // heads)
    x = torch.randn(b, s, h, generator=gen, device=DEV).to(torch.bfloat16)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device=DEV)
    lens[0] = s if b > 1 else min(12, s)   # one query: 12 tokens, padded
    pad = torch.arange(s, device=DEV)[None, :] >= lens[:, None]
    bias = pad.float() * -1e9
    args = (x, layer, bias, heads, scale, LN_EPS)
    got = fused_encoder_layer(*args)
    want = encoder_layer_reference(*args)
    torch.cuda.synchronize()
    ok, cos, rel = layer_close(got, want)
    check(ok, f"{spec.name} ({b}, {s}): cosine {cos}, relative error {rel}")
    broken = {name: encoder_layer_reference(x, bad, bias, heads, scale,
                                            LN_EPS)
              for name, bad in broken_layers(layer, heads).items()}
    broken["no_mask"] = encoder_layer_reference(
        x, layer, torch.zeros_like(bias), heads, scale, LN_EPS)
    for name, out in broken.items():
        check(not layer_close(out, want)[0],
              f"{spec.name} ({b}, {s}): the check passes {name}")
    m = b * s
    weights = 4 * h * h + 2 * h * inter
    ms, bound_by = bound(
        2 * 2 * m * h + 2 * weights + 2 * (3 * h + h + inter + h)
        + 4 * 4 * h + 4 * b * s,
        2.0 * m * weights + 4.0 * b * s * s * h)
    lib = library_layer(layer, heads, LN_EPS)
    with torch.inference_mode():
        library_ms = device_ms(lambda: lib(x, src_key_padding_mask=pad),
                               iters)
    return {"model": spec.name, "b": b, "s": s, "head_dim": h // heads,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_rel_err": rel, "min_cosine": cos,
            "broken_min_cosine": {name: layer_close(out, want)[1]
                                  for name, out in broken.items()},
            "ms": device_ms(lambda: fused_encoder_layer(*args), iters),
            "plain_ms": device_ms(lambda: encoder_layer_reference(*args),
                                  iters),
            "library_ms": library_ms, "bound_ms": ms, "bound_by": bound_by}


def phase_layer(gen):
    from sema_tpu_torch.models.registry import get_spec
    cases = []
    for name in dict.fromkeys(m for m, _, _ in K2_SHAPES):
        spec = get_spec(name)
        layer = layer_params(spec.hidden_size, spec.intermediate_size, gen)
        cases += [layer_case(layer, spec, b, s, gen, iters=10)
                  for m, b, s in K2_SHAPES if m == name]
    emit("encoder_layer", cases=cases)
    return cases


# -- main path ----------------------------------------------------------------

_WORDS = ("request", "retry", "backoff", "socket", "parse", "token", "vector",
          "index", "query", "cache", "buffer", "stream", "config", "error",
          "handler", "batch", "encode", "decode", "offset", "window")


def make_tree(root: Path, n_files: int) -> Path:
    """``n_files`` Python-like sources of about 7 KB each, from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    for f in range(n_files):
        d = root / f"pkg{f % 16:02d}"
        d.mkdir(parents=True, exist_ok=True)
        lines = []
        for i in range(40):
            w = rng.choice(_WORDS, size=6)
            lines.append(f"def {w[0]}_{w[1]}_{i}(self, {w[2]}, {w[3]}=None):")
            lines.append(f"    # {' '.join(rng.choice(_WORDS, size=9))}")
            lines.append(f"    return self.{w[4]}({w[2]}, {w[5]}={w[3]})")
            lines.append("")
        (d / f"mod{f:04d}.py").write_text("\n".join(lines))
    return root


def query_device_time(search, n: int) -> dict:
    """Device time of ``n`` queries under torch.profiler: busy ms per
    query, the busy share of the wall time, and the kernels that take
    the most of it (device ms per query)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            search()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    check(events, "the profiler saw no device activity")
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return {"busy_ms": busy_ms / n, "busy_share": busy_ms / wall_ms,
            "top_ms": {e.key[:60]: e.self_device_time_total / 1e3 / n
                       for e in top}}


def run_cli(argv):
    """Run the port's CLI in-process; raise on a non-zero exit or on the
    warnings of a swallowed embed failure or of the substring fallback."""
    from sema_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = cli.main(list(argv))
    check(rc == 0, f"{argv[0]} exited {rc}: {err.getvalue()[-2000:]}")
    for warning in ("Failed to index chunks", "falling back to substring"):
        check(warning not in err.getvalue(), err.getvalue()[-2000:])
    return out.getvalue()


def phase_main_path(work: Path, n_files: int, extra=()):
    from sema_tpu_torch import cli
    from sema_tpu_torch.ingest.hashing import HASH_NAME
    from sema_tpu_torch.models.encoder import Encoder
    from sema_tpu_torch.utils.metrics import Metrics
    from sema_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference
    tree = make_tree(work / "tree", n_files)
    os.environ["SEMA_TPU_HOME"] = str(work / "home")
    os.environ["SEMA_TPU_DATA"] = str(work / "data")

    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_cli(["index", str(tree), "--stats", *extra])
    index_s = time.perf_counter() - t0
    index_launches = launch_counts()
    n_chunks = int(re.search(r"indexed (\d+) chunks", out).group(1))
    stats = json.loads(out[out.index("{"):])
    check(n_chunks >= n_files and index_launches["encoder_layer"] > 0, out)

    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_cli(["query", QUERY, "--json", *extra])
    query_cli_s = time.perf_counter() - t0
    query_launches = launch_counts()
    hits = [json.loads(line) for line in out.splitlines()]
    check(len(hits) == 50 and all(math.isfinite(h["score"]) for h in hits),
          f"{len(hits)} hits, or a score that is not finite")
    check(all(v > 0 for v in query_launches.values()),
          f"query launches {query_launches}")

    again = run_cli(["index", str(tree), *extra])
    check("indexed 0 chunks" in again, again)

    # a manager of the same config: query latency and its stages, the
    # device's busy time under torch.profiler, then the sample checks
    args = cli.build_parser().parse_args(["query", QUERY, *extra])
    metrics = Metrics()
    mgr = cli.make_index_manager(cli.load_config(args), args.device,
                                 metrics=metrics)
    store, enc = mgr.vector_store, mgr.encoder
    for _ in range(3):
        mgr.search(QUERY, 50)
    metrics.stage_samples.clear()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        mgr.search(QUERY, 50)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    stages_p50_ms = {k: v * 1e3 for k, v in metrics.report()["p50_s"].items()}
    device = query_device_time(lambda: mgr.search(QUERY, 50), 20)

    # the query's hits against the plain scan of the same device rows
    qvec = enc.encode_query_device(QUERY)[None, :]
    buckets = store.device_buckets()
    check(len(buckets) == 1, f"{len(buckets)} device buckets")
    b = buckets[0]
    masked = not b["all_valid"]
    k = min(64, b["rows"])          # the k class of --limit 50
    got = scan_topk(b["store"], qvec, b["valid"], k, masked)
    want = scan_topk_reference(b["store"], qvec, b["valid"], k, masked)
    scan_err = check_scan(b["store"], qvec, b["valid"], masked, got, want)
    ids = store.search_batch(qvec, 50)[1][0]
    check([h["id"] for h in hits]
          == [store.chunk_at(int(i)).id for i in ids], "CLI hits differ")

    # stored rows of a sample against the plain encoder on the CPU
    sample = list(range(0, n_chunks, max(1, n_chunks // 16)))[:16]
    texts = [store.chunk_at(i).content for i in sample]
    cpu = Encoder(enc.spec, enc.params, enc.tokenizer,
                  max_length=enc.max_length, batch_size=enc.batch_size,
                  compute_dtype=enc.compute_dtype, device="cpu")
    ref = cpu.encode_texts(texts)
    rows = b["store"][sample].float().cpu()
    cos = F.cosine_similarity(rows, ref, dim=1)
    check(float(cos.min()) >= 0.9999, f"stored rows: cosine {cos.min()}")

    # the index's batches per sequence bucket, as Encoder.encode_texts
    # forms them: per super-batch of 8 * batch_size chunks
    counts, batches = Counter(), Counter()
    texts = [store.chunk_at(i).content for i in range(n_chunks)]
    for off in range(0, n_chunks, 8 * enc.batch_size):
        part = Counter(enc._bucket_len(len(tok_ids)) for tok_ids, _ in
                       enc._encode(texts[off:off + 8 * enc.batch_size]))
        for s, n in part.items():
            counts[s] += n
            batches[s] += -(-n // (enc.batch_size
                                   * max(1, enc.max_length // s)))
    check(sum(batches.values()) * enc.spec.num_layers
          == index_launches["encoder_layer"],
          f"batches {dict(batches)}, launches {index_launches}")
    k1 = {"n": b["rows"], "q": 1, "k": k, "masked": masked,
          "max_abs_err": scan_err}
    ms, bound_by = bound(b["rows"] * D * 2 + (b["rows"] if masked else 0)
                         + D * 4 + k * 8, 2.0 * b["rows"] * D)
    k1.update(
        ms=device_ms(lambda: scan_topk(b["store"], qvec, b["valid"], k,
                                       masked), 50),
        plain_ms=device_ms(lambda: scan_topk_reference(
            b["store"], qvec, b["valid"], k, masked), 50),
        library_ms=device_ms(lambda: torch.topk(
            qvec.to(torch.bfloat16) @ b["store"].T, k), 50),
        bound_ms=ms, bound_by=bound_by)
    mgr.close()
    emit("main_path", files=n_files, chunks=n_chunks, hash=HASH_NAME,
         index_s=index_s, chunks_per_s=n_chunks / index_s,
         index_stages_s=stats["stages_s"], query_cli_s=query_cli_s,
         query_p50_ms=lat[len(lat) // 2], query_max_ms=lat[-1],
         query_stages_p50_ms=stages_p50_ms, query_device=device,
         index_launches=index_launches, query_launches=query_launches,
         bucket_rows={str(s): n for s, n in sorted(counts.items())},
         bucket_batches={str(s): n for s, n in sorted(batches.items())},
         stored_min_cosine=float(cos.min()), hits=len(hits))
    return index_launches, query_launches, k1


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    from sema_tpu_torch.ops import _cuda       # fails without the repo
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    seconds = _cuda.build()
    emit("build", seconds=seconds, wall_s=time.perf_counter() - t0)

    gen = torch.Generator(device=DEV).manual_seed(0)
    phase_scan(gen)
    layer_cases = phase_layer(gen)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        index_launches, query_launches, k1 = phase_main_path(Path(work), 400)

    k2 = next(c for c in layer_cases
              if (c["model"], c["b"], c["s"]) == ("minilm-l6", 256, 256))
    kernels = [
        {"name": "scan_topk", "route": "cuda",
         "source": "sema_tpu_torch/csrc/scan_topk.cu",
         "replaces": "sema_tpu/ops/pallas_topk.py:280",
         "launches": index_launches["scan_topk"]
         + query_launches["scan_topk"], "shape": [k1["n"], 1, k1["k"]],
         **{key: k1[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}},
        {"name": "encoder_layer", "route": "cuda",
         "source": "sema_tpu_torch/csrc/encoder_layer.cu",
         "replaces": "sema_tpu/ops/fused_attention.py:356",
         "launches": index_launches["encoder_layer"]
         + query_launches["encoder_layer"], "shape": [256, 256, D],
         **{key: k2[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
