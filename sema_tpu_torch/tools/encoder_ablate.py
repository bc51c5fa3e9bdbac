"""Encoder attribution on the port (``tools/encoder_ablate.py``): how much
of the encoder's device time its softmax's exponentials, then its whole
softmax, take.

The JAX tool swaps the attention core the fused kernels call by name
(``fused_attention._heads_attention``) and re-traces. The port's attention
is inside K2's CUDA source, so the tool builds ``csrc/encoder_layer.cu``
again with ``-DSEMA_ABLATE=0``, ``1`` and ``2`` into libraries of its own
under ``build/kernels/`` (``_cuda.library(..., defines=...)``; nothing
else loads them) and runs the port's ``Encoder`` on each:

  prod        the product's softmax (exp, max, sum, divide), built again
  no_exp      the same max/sum/divide passes, exp(s - m) taken as s - m + 1
  no_softmax  the probability taken as the score times 1e-3, undivided

``no_exp`` and ``no_softmax`` compute wrong embeddings; they exist only to
attribute device time. Each variant is held against its plain version
(``ops/encoder_layer.py:encoder_layer_reference`` with ``softmax`` of
``ops/attention.SOFTMAXES``) on the same card: per-row cosine of the
embeddings >= 0.9999, and the ablated ones must differ from prod; prod
must equal the product's K2 forward bit for bit (``checks``, not in the
JAX tool). ``exp_ms`` and ``softmax_ms`` are differences of the kernels'
own time that torch.profiler sums over ``--calls`` forwards
(``kernel_ms`` of each variant); ``ms_per_call`` is CUDA events around
the same calls. The ids are the JAX tool's, from numpy seed 0; MiniLM's
random weights come from seed 0. On ``--device cpu`` every variant is its
plain version. Prints ONE JSON line, with ``device`` and ``launches``;
exits non-zero when a check fails.

Usage: python -m sema_tpu_torch.tools.encoder_ablate [--model minilm-l6]
       [--batch 256] [--seq 256]
"""

from __future__ import annotations

import argparse
import functools
import importlib
import itertools
import json
import sys
import threading
from contextlib import contextmanager

import numpy as np
import torch

from sema_tpu_torch.device import resolve_device
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import random_params
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.ops import _cuda
from sema_tpu_torch.ops.attention import SOFTMAXES
from sema_tpu_torch.ops.encoder_layer import encoder_layer_reference
from sema_tpu_torch.tokenizer import load_tokenizer
from sema_tpu_torch.tools import (call_ms, device_label, launch_counts,
                                  launches_since)

# variant → its SEMA_ABLATE level, which is also its softmax's index in
# attention.SOFTMAXES
VARIANTS = {"prod": 0, "no_exp": 1, "no_softmax": 2}
COS_MIN = 0.9999            # each variant against its plain version, per row


def defines(level: int) -> tuple:
    return (f"SEMA_ABLATE={level}",)


def build_variants() -> dict:
    """Build the three ablation libraries (and nothing else), one nvcc
    each, all at once: {variant: seconds}."""
    seconds, errors = {}, []

    def one(name, level):
        try:
            seconds[name] = _cuda.build(["encoder_layer"],
                                        defines(level))["encoder_layer"]
        except _cuda.KernelError as e:
            errors.append(e)
    threads = [threading.Thread(target=one, args=item)
               for item in VARIANTS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return seconds


class _Build:
    """``ops/_cuda`` as the layer wrapper sees it, with ``library`` giving
    the ablation build of ``level``."""

    def __init__(self, level: int):
        self.level = level

    def __getattr__(self, name):
        return getattr(_cuda, name)

    def library(self, name, signatures):
        return _cuda.library(name, signatures, defines(self.level))


@contextmanager
def _swapped(module: str, name: str, obj):
    mod = importlib.import_module(module)
    saved = getattr(mod, name)
    setattr(mod, name, obj)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def variant_layers(level: int, plain: bool):
    """The encoder's K2 launches through the build of ``level`` or, with
    ``plain``, its layers are the plain version of that build."""
    if plain:
        return _swapped("sema_tpu_torch.models.bert", "fused_encoder_layer",
                        functools.partial(encoder_layer_reference,
                                          softmax=SOFTMAXES[level]))
    return _swapped("sema_tpu_torch.ops.encoder_layer", "_cuda",
                    _Build(level))


def row_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    """The least per-row cosine of two (rows, dim) batches."""
    return float(torch.nn.functional.cosine_similarity(
        a.float(), b.float(), dim=1).min())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="minilm-l6")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--calls", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    card = dev.type == "cuda"
    if card:
        build_variants()
    spec = get_spec(args.model)
    tok, _ = load_tokenizer(spec.vocab_size, spec.hf_repo)
    enc = Encoder(spec, random_params(spec, seed=0), tok,
                  compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, spec.vocab_size,
                                        (args.batch, args.seq))).to(
        torch.int32).to(dev)
    mask = torch.ones((args.batch, args.seq), dtype=torch.int32, device=dev)
    idsets = [ids] + [torch.roll(ids, i, 0) for i in (1, 2, 3)]
    print(f"# device {device_label(dev)} model {args.model} "
          f"B={args.batch} S={args.seq}", file=sys.stderr, flush=True)

    before = launch_counts()
    product = enc.embed_ids(ids, mask)
    results, outs, checks = {}, {}, {}
    for name, level in VARIANTS.items():
        with variant_layers(level, plain=not card):
            outs[name] = enc.embed_ids(ids, mask)
            turn = itertools.cycle(idsets)
            t = call_ms(lambda: enc.embed_ids(next(turn), mask), args.calls,
                        dev)
        results[name] = {"ms_per_call": round(t["event_ms"], 3),
                         "kernel_ms": round(t["kernel_ms"], 3),
                         "chunks_per_sec": round(
                             args.batch / t["event_ms"] * 1e3, 1)}
        print(f"# {name}: {t['event_ms']:.2f} ms/call, kernels "
              f"{t['kernel_ms']:.2f} ms", file=sys.stderr, flush=True)
    launches = launches_since(before)
    checks["prod_bit_equal"] = bool(torch.equal(outs["prod"], product))
    for name, level in VARIANTS.items():
        with variant_layers(level, plain=True):
            want = enc.embed_ids(ids, mask)
        checks[name] = {"min_cos": row_cos(outs[name], want),
                        "differs_from_prod": not torch.equal(outs[name],
                                                             outs["prod"])}
    ok = checks["prod_bit_equal"] and all(
        checks[name]["min_cos"] >= COS_MIN
        and (name == "prod" or checks[name]["differs_from_prod"])
        for name in VARIANTS)

    prod = results["prod"]["kernel_ms"]
    out = {
        "model": args.model, "batch": args.batch, "seq": args.seq,
        "device": device_label(dev),
        "variants": results,
        "exp_ms": round(prod - results["no_exp"]["kernel_ms"], 3),
        "softmax_ms": round(prod - results["no_softmax"]["kernel_ms"], 3),
        "checks": checks,
        "launches": launches,
    }
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
