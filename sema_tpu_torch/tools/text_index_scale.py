# Copy of tools/text_index_scale.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Text-index scale proof: flat host RSS at multi-million-chunk corpora.

Round 2's text index kept every doc (including content) plus the whole
postings table in host RAM — O(corpus) residency that could not reach
the 10M/100M-chunk BASELINE rungs. The v2 disk-resident format
(sema_tpu/index/text_segment.py) keeps RSS at O(segments + tombstone
bitmaps). This tool builds an N-chunk corpus in batches and records:

- RSS after every ~10% of the build (flatness is the claim),
- per-batch commit latency at the start vs the end (O(batch) claim),
- reopen time + RSS (open reads only fixed headers),
- search latency on the full corpus,
- one O(file) delete.

Prints ONE JSON line. Usage:
    python -m sema_tpu_torch.tools.text_index_scale --docs 2000000 [--batch 4096]
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from sema_tpu_torch.index.text_index import make_text_index  # noqa: E402
from sema_tpu_torch.types import Chunk  # noqa: E402

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa "
         "lambda mu nu xi omicron pi rho sigma tau upsilon").split()


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def make_batch(start: int, n: int):
    out = []
    for i in range(start, start + n):
        w = [WORDS[(i + j) % 20] for j in range(8)]
        content = f"chunk {i} body " + " ".join(w) + f" tag{i % 977}"
        path = f"src/file_{i // 64:06d}.py"
        out.append(Chunk(id=f"{path}:{i % 64}", file_path=Path(path),
                         start_line=i % 64, end_line=i % 64 + 1,
                         content=content))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", type=int, default=2_000_000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--backend", default="auto")
    args = ap.parse_args()

    tmp = tempfile.mkdtemp(prefix="sema-tscale-")
    idx = make_text_index(tmp, backend=args.backend)
    engine = type(idx).__name__

    rss0 = rss_mb()
    rss_track = []
    early, late = [], []
    n_batches = args.docs // args.batch
    t_build0 = time.perf_counter()
    for b in range(n_batches):
        batch = make_batch(b * args.batch, args.batch)
        t0 = time.perf_counter()
        idx.index_chunks(batch)
        dt = time.perf_counter() - t0
        if b < 16:
            early.append(dt)
        if b >= n_batches - 16:
            late.append(dt)
        if b % max(1, n_batches // 10) == 0:
            rss_track.append(round(rss_mb(), 1))
    build_s = time.perf_counter() - t_build0
    rss_built = rss_mb()
    n_segs = len(idx.segments)
    idx.close()

    t0 = time.perf_counter()
    idx2 = make_text_index(tmp, backend=args.backend)
    reopen_s = time.perf_counter() - t0
    assert idx2.num_live_docs == n_batches * args.batch

    t0 = time.perf_counter()
    hits = idx2.search("alpha tag123", 10)
    search_ms = (time.perf_counter() - t0) * 1e3
    assert hits

    # phrase rungs (v3 positional postings): terms common, adjacency
    # decided by the index alone. "beta gamma" matches everywhere;
    # "gamma beta" NEVER occurs — the adversarial case where the pre-v3
    # content-verify walk read every candidate's content before
    # concluding zero hits.
    t0 = time.perf_counter()
    ph = idx2.search('"beta gamma"', 10)
    phrase_hit_ms = (time.perf_counter() - t0) * 1e3
    assert ph
    t0 = time.perf_counter()
    ph0 = idx2.search('"gamma beta"', 10)
    phrase_miss_ms = (time.perf_counter() - t0) * 1e3
    assert ph0 == []

    t0 = time.perf_counter()
    removed = idx2.remove_file_chunks(Path("src/file_000100.py"))
    delete_ms = (time.perf_counter() - t0) * 1e3
    assert removed == 64

    import statistics
    print(json.dumps({
        "engine": engine,
        "docs": n_batches * args.batch,
        "segments": n_segs,
        "build_s": round(build_s, 1),
        "docs_per_sec": round(n_batches * args.batch / build_s, 0),
        "rss_start_mb": round(rss0, 1),
        "rss_track_mb": rss_track,
        "rss_built_mb": round(rss_built, 1),
        "reopen_s": round(reopen_s, 3),
        "search_ms_full_corpus": round(search_ms, 2),
        "phrase_hit_ms": round(phrase_hit_ms, 2),
        "phrase_miss_ms": round(phrase_miss_ms, 2),
        "delete_one_file_ms": round(delete_ms, 2),
        "commit_ms_p50_first16": round(
            statistics.median(early) * 1e3, 1),
        "commit_ms_p50_last16": round(
            statistics.median(late) * 1e3, 1),
        "device": "cpu",
        "launches": {},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
