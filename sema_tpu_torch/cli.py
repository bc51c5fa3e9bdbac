"""Command-line interface of the port (from ``sema_tpu/cli.py``).

    python -m sema_tpu_torch [DIR] [flags]          crawl + index + the TUI
                                                    (``tui``, the default)
    python -m sema_tpu_torch index [DIR] [flags]    headless index build
    python -m sema_tpu_torch query "text" [flags]   headless query
                                                    ('-prefix = keyword)
    python -m sema_tpu_torch serve [DIR] [flags]    HTTP search daemon
                                                    (--host, --port,
                                                    --reindex-interval)
    python -m sema_tpu_torch doctor [flags]         environment, the device
                                                    self-test and the
                                                    quality gate
    python -m sema_tpu_torch bench [flags]          not written yet: names
                                                    the tools, exits 2

The flags are the JAX package's, plus ``--device {cuda,cpu}`` (default
``cuda``; a missing card raises rather than falling back). Config and
data live where the JAX package keeps them (``SEMA_TPU_HOME``,
``SEMA_TPU_DATA``), so both packages can serve one data dir. ``serve``
answers ``GET /healthz`` and ``GET``/``POST /search`` (see
``search/http_server.py``) until SIGINT or SIGTERM; with
``--reindex-interval N`` a thread re-crawls DIR every N seconds and
indexes what changed while queries go on. ``doctor`` builds the kernels,
runs ``selftest.run_device_selftest`` on the device (planted-winner scans
through the real store, the encoder against its f32 plain version on the
CPU) and, unless ``--skip-quality``, ``quality.run_quality_gate``. Every
command exits non-zero when a kernel does not build, launch or take its
tensors (:class:`~sema_tpu_torch.ops._cuda.KernelError`); ``serve`` does
so before it takes traffic, from its warm-up query, and the TUI once
curses has restored the terminal. ``[mesh]`` builds a mesh
(:func:`config_mesh`): the store's rows shard over its ``index`` axis
(and ``slice_axis``), the encoder's batch splits over ``index`` and, with
``model_axis``, its weights over that axis. ``[index]
hbm_budget_mb`` caps the store's device buckets: past it, sealed buckets
stay on the host and stream (``VectorStore``'s HBM spill). ``bench``
takes the JAX package's flags, says that the port's benchmark harness is
not written yet, names the tools that measure the port today
(``python -m sema_tpu_torch.tools.load_test``, ``ivf_bench``,
``spill_ivf_bench``) and exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

from sema_tpu_torch.config import (Config, ConfigManager, apply_cli_overrides,
                                   data_dir)
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.types import CrawlerConfig

SUBCOMMANDS = {"index", "query", "tui", "bench", "serve", "doctor"}


def _add_crawl_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("directory", nargs="?", help="Directory path to crawl")
    p.add_argument("--max-file-size", type=int, default=None,
                   help="Maximum file size to process (in bytes)")
    p.add_argument("--include-hidden", action="store_true",
                   help="Include hidden files in crawling")
    p.add_argument("--follow-symlinks", action="store_true",
                   help="Follow symbolic links")
    p.add_argument("--extensions", type=lambda s: s.split(","), default=None,
                   help="File extensions to crawl (comma-separated). "
                        "When specified, ignores default extensions.")
    p.add_argument("--exclude", type=lambda s: s.split(","), default=None,
                   help="Additional patterns to exclude (comma-separated)")
    p.add_argument("--ignore-gitignore", action="store_true",
                   help="Ignore files and patterns listed in .gitignore files")


def _add_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default=None,
                   help="Encoder model (minilm-l6, bge-small-en, e5-base, "
                        "gte-large)")
    p.add_argument("--weights", default=None,
                   help="Local safetensors dir for encoder weights")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda)")


def build_parser() -> argparse.ArgumentParser:
    from sema_tpu_torch import __version__
    p = argparse.ArgumentParser(
        prog="sema_tpu_torch",
        description="Semantic File Search — semantic + keyword search in "
                    "local files, on an NVIDIA GPU")
    p.add_argument("--version", action="version",
                   version=f"sema_tpu_torch {__version__}")
    sub = p.add_subparsers(dest="command")

    tui = sub.add_parser("tui", help="interactive TUI (default)")
    _add_crawl_flags(tui)
    _add_model_flags(tui)

    index = sub.add_parser("index", help="build/update the index headlessly")
    _add_crawl_flags(index)
    _add_model_flags(index)
    index.add_argument("--reindex", action="store_true",
                       help="Discard the existing index first")
    index.add_argument("--stats", action="store_true",
                       help="Print per-stage timing JSON")

    query = sub.add_parser("query", help="run one query against the index")
    query.add_argument("text", help="query text; prefix with ' for keyword "
                                    "(BM25) search")
    query.add_argument("--limit", type=int, default=50,
                       help="max results (default 50)")
    query.add_argument("--json", action="store_true", help="JSON output")
    query.add_argument("--group", action="store_true",
                       help="group results by file (TUI behavior)")
    query.add_argument("--trace", metavar="DIR", default=None,
                       help="capture a torch.profiler trace into DIR")
    _add_model_flags(query)

    bench = sub.add_parser("bench", help="run the standard benchmark "
                                         "(not written yet)")
    bench.add_argument("--config", default="minilm-10k",
                       help="benchmark config name")
    _add_model_flags(bench)

    serve = sub.add_parser("serve", help="HTTP search daemon over the index")
    _add_crawl_flags(serve)
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=7700)
    serve.add_argument("--reindex-interval", type=float, default=0,
                       metavar="SECONDS",
                       help="re-crawl the directory and incrementally "
                            "index changed files every N seconds while "
                            "serving (0 = off)")
    _add_model_flags(serve)

    doctor = sub.add_parser(
        "doctor", help="environment + device self-test + semantic-quality "
                       "check")
    _add_model_flags(doctor)
    doctor.add_argument("--skip-quality", action="store_true",
                        help="only report environment and the device "
                             "self-test, skip the canned-corpus retrieval "
                             "gate")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    argv = list(sys.argv[1:] if argv is None else argv)
    # as sema_tpu/cli.py:121-128: a bare `[DIR] [flags]` runs the TUI
    passthrough = ("-h", "--help", "--version")
    if not argv or (argv[0] not in SUBCOMMANDS
                    and argv[0] not in passthrough):
        argv = ["tui"] + argv
    return build_parser().parse_args(argv)


def load_config(args) -> Config:
    """Init-on-first-run, then CLI overrides in memory."""
    manager = ConfigManager()
    manager.init()
    config = manager.load_config()
    if getattr(args, "weights", None):
        config.model.weights_path = args.weights
    return apply_cli_overrides(config, args)


def resolve_directory(args) -> Path:
    """Default cwd, canonicalize, must be a directory."""
    target = Path(getattr(args, "directory", None) or os.getcwd())
    try:
        canonical = target.resolve(strict=True)
    except OSError:
        sys.exit(f"Error: Directory '{target}' does not exist or cannot be "
                 f"accessed")
    if not canonical.is_dir():
        sys.exit(f"Error: '{canonical}' is not a directory")
    return canonical


def crawler_config(config: Config) -> CrawlerConfig:
    g = config.general
    return CrawlerConfig(
        max_file_size=g.max_file_size,
        follow_symlinks=g.follow_symlinks,
        include_hidden=g.include_hidden,
        file_extensions=tuple(g.file_extensions),
        exclude_patterns=tuple(g.exclude_patterns),
        ignore_gitignore=g.ignore_gitignore)


def config_mesh(config: Config, device: str):
    """The mesh of ``[mesh]`` (``sema_tpu/cli.py:175-201``): with
    ``model_axis`` or ``slice_axis``, a (slice, data, model, index) mesh,
    each named axis only, ``slice`` outermost so that the store's row
    blocks are slice-major, of the explicit ``shape`` (SystemExit
    without one of that length); else a (data, index) mesh of an explicit
    ``shape``; else :func:`~sema_tpu_torch.parallel.mesh.default_mesh`,
    every card on ``index`` (None on one card, and for ``device="cpu"``).
    The shards lie on the CUDA devices, or for ``device="cpu"`` all on
    the CPU (the counterpart of the JAX package's virtual CPU devices)."""
    from sema_tpu_torch.device import resolve_device
    from sema_tpu_torch.parallel.mesh import (default_mesh, local_devices,
                                              make_mesh)
    m = config.mesh
    kind = resolve_device(device).type
    model_axis, slice_axis = m.model_axis or None, m.slice_axis or None
    if model_axis or slice_axis:
        axes = ([slice_axis] if slice_axis else []) + [m.data_axis] \
            + ([model_axis] if model_axis else []) + [m.index_axis]
        if len(m.shape) != len(axes):
            raise SystemExit(
                f"[mesh] model_axis/slice_axis require an explicit "
                f"{len(axes)}-entry shape ({' x '.join(axes)}), e.g. "
                f"shape = {[1] * (len(axes) - 1) + [8]} on 8 cards")
    elif m.shape:
        axes = [m.data_axis, m.index_axis]
    else:
        return default_mesh() if kind == "cuda" else None
    devices = (local_devices() if kind == "cuda"
               else local_devices("cpu") * math.prod(m.shape))
    return make_mesh(m.shape, axes, devices)


def make_index_manager(config: Config, device: str, metrics=None):
    from sema_tpu_torch.index import IndexManager
    from sema_tpu_torch.models import Encoder

    mesh = config_mesh(config, device)
    if metrics is None and os.environ.get("SEMA_TPU_LOG"):
        from sema_tpu_torch.utils.metrics import Metrics
        metrics = Metrics(log_stream=open(
            os.environ["SEMA_TPU_LOG"], "a", buffering=1))
    # the encoder's batch splits over the index axis, as the JAX CLI's
    # (its default mesh's only axis of more than one device)
    encoder = Encoder.from_config(config.model, device=device, mesh=mesh,
                                  data_axis=config.mesh.index_axis,
                                  model_axis=config.mesh.model_axis or None)
    if encoder.weights_source == "random":
        print("Warning: no weights for model "
              f"{config.model.name!r} (none under --weights or in the HF "
              "cache); using random init (rankings will be meaningless).",
              file=sys.stderr)
    return IndexManager(data_dir(), encoder,
                        store_dtype=config.index.store_dtype, mesh=mesh,
                        index_axis=config.mesh.index_axis,
                        slice_axis=config.mesh.slice_axis or None,
                        metrics=metrics, rescore_k=config.index.rescore_k,
                        hbm_budget_mb=config.index.hbm_budget_mb,
                        ivf=config.index.ivf,
                        ivf_nprobe=config.index.ivf_nprobe,
                        ivf_min_recall=config.index.ivf_min_recall)


def cmd_index(args) -> int:
    from sema_tpu_torch.crawl import FileCrawler
    from sema_tpu_torch.utils.metrics import Metrics

    config = load_config(args)
    directory = resolve_directory(args)

    if args.reindex:
        import shutil
        for sub in ("vector_index", "text_index"):
            shutil.rmtree(data_dir() / sub, ignore_errors=True)

    metrics = Metrics()
    t0 = time.perf_counter()
    with metrics.timer("crawl"):
        files = FileCrawler(crawler_config(config)).crawl_directory(directory)
    print(f"crawled {len(files)} files")

    mgr = make_index_manager(config, args.device, metrics=metrics)

    def progress(stage, done, total):
        if total:
            print(f"\r{stage}: {done}/{total}", end="", file=sys.stderr)
            if done == total:
                print(file=sys.stderr)

    try:
        n = mgr.process_and_index_files(files, progress=progress,
                                        purge_missing_under=directory)
    finally:
        mgr.close()
    dt = time.perf_counter() - t0
    print(f"indexed {n} chunks in {dt:.1f}s "
          f"({mgr.vector_store.live_rows} live vectors)")
    if args.stats:
        print(json.dumps(metrics.report(), indent=2))
    return 0


def cmd_query(args) -> int:
    config = load_config(args)
    mgr = make_index_manager(config, args.device)
    tracer = contextlib.nullcontext()
    if args.trace:
        from sema_tpu_torch.utils.metrics import trace
        tracer = trace(args.trace)
    t0 = time.perf_counter()
    try:
        with tracer:
            results = mgr.search(args.text, args.limit)
    finally:
        mgr.close()
    dt = time.perf_counter() - t0

    if args.group:
        from sema_tpu_torch.search.engine import group_results_by_file
        from sema_tpu_torch.types import SearchResult
        grouped = group_results_by_file(
            [SearchResult(chunk=c, score=s) for c, s in results])
        results = [(g.chunk, g.score) for g in grouped]
        counts = {str(g.chunk.file_path): g.total_matches_in_file
                  for g in grouped}

    if args.json:
        for chunk, score in results:
            print(json.dumps({
                "id": chunk.id, "file_path": str(chunk.file_path),
                "start_line": chunk.start_line, "end_line": chunk.end_line,
                "score": score,
                "content": chunk.content}))
    else:
        if not results:
            print("no results")
        for chunk, score in results:
            loc = f"{chunk.file_path}:L{chunk.start_line}-{chunk.end_line}"
            extra = (f"  (+{counts[str(chunk.file_path)] - 1} more)"
                     if args.group and counts.get(str(chunk.file_path), 1) > 1
                     else "")
            print(f"{score:8.4f}  {loc}{extra}")
        print(f"-- {len(results)} results in {dt * 1e3:.1f} ms",
              file=sys.stderr)
    return 0


def cmd_tui(args) -> int:
    from sema_tpu_torch.tui.app import run_app
    config = load_config(args)
    directory = resolve_directory(args)
    return run_app(directory, config, args.device)


def cmd_doctor(args) -> int:
    """Self-check (``sema_tpu/cli.py:323-382``): the environment, the
    kernels built, weight resolution, the device self-test, then the
    semantic quality gate. Exit 0 only when every self-test check is ok
    and (without ``--skip-quality``) the gate ran and passed; random
    weights skip the gate, which exits 1 as the JAX package does."""
    import torch

    from sema_tpu_torch.device import resolve_device
    from sema_tpu_torch.models import Encoder
    from sema_tpu_torch.selftest import NOT_PORTED, run_device_selftest

    config = load_config(args)
    device = resolve_device(args.device)
    print(f"torch            : {torch.__version__} "
          f"(CUDA {torch.version.cuda})")
    if device.type == "cuda":
        from sema_tpu_torch.ops import _cuda
        print(f"card             : {torch.cuda.get_device_name(device)} "
              f"({torch.cuda.device_count()} device(s))")
        t0 = time.perf_counter()
        built = _cuda.build()      # a failed build raises KernelError
        print(f"kernels          : built in {time.perf_counter() - t0:.2f}s ("
              + ", ".join(f"{name} {s:.1f}s" for name, s in
                          sorted(built.items()))
              + "; 0.0s: built before)")
    else:
        print("card             : not used (--device cpu: the kernels' "
              "plain versions)")
    try:
        import sema_tpu_torch.native.bindings  # noqa: F401
        print("native extension : built (crawler/chunker/xxh3/BM25 in C++)")
    except ImportError:
        print("native extension : NOT built — run `make -C native` "
              "(pure-Python fallbacks active)")

    encoder = Encoder.from_config(config.model, device=device)
    print(f"model            : {encoder.spec.name} "
          f"({encoder.spec.dim}-d, {encoder.spec.num_layers} layers, "
          f"quant={encoder.quant})")
    print(f"weights          : {encoder.weights_source}")
    print(f"tokenizer        : {encoder.tokenizer_source}")

    selftest_ok = True
    for name, ok, detail in run_device_selftest(
            config.model, dim=encoder.spec.dim, encoder=encoder,
            device=device):
        selftest_ok &= ok
        print(f"device {name:<15}: {'ok' if ok else 'FAIL'} — {detail}")
    for name, reason in NOT_PORTED.items():
        print(f"device {name:<15}: n/a — {reason}")

    if args.skip_quality:
        return 0 if selftest_ok else 1
    from sema_tpu_torch.quality import run_quality_gate
    report = run_quality_gate(encoder)
    if not report.ran:
        print(f"quality gate     : SKIPPED — {report.reason}")
        return 1
    print(f"quality gate     : {report.correct_at_1}/{report.total} "
          f"queries ranked their document #1")
    for query, expected, got in report.failures:
        print(f"  MISS  {query!r}: expected {expected}, got {got}")
    if report.fixture_min_cosine is not None:
        print(f"fixture vectors  : {report.fixture_checked} checked, "
              f"min cosine {report.fixture_min_cosine:.6f} "
              f"(gate ≥ 0.999)")
    else:
        print("fixture vectors  : no fixture file (tests/fixtures/"
              f"quality_vectors_{encoder.spec.name}.npz)")
    passed = report.passed and selftest_ok
    print(f"RESULT           : {'PASS' if passed else 'FAIL'}")
    return 0 if passed else 1


def cmd_serve(args) -> int:
    """The HTTP daemon (``sema_tpu/cli.py:385-425``) until SIGINT or
    SIGTERM, with the streaming re-index thread when asked. A KernelError
    of the warm-up or of a re-index ends it and propagates."""
    import _thread
    import signal
    import threading
    from sema_tpu_torch.search.http_server import serve_forever
    config = load_config(args)
    mgr = make_index_manager(config, args.device)
    failed: List[KernelError] = []
    stop = threading.Event()

    def on_signal(signum, _frame):
        print(f"stopped by signal {signum}", file=sys.stderr)
        raise KeyboardInterrupt

    if args.reindex_interval > 0:
        # streaming re-index while serving: each pass appends its segments
        # and tombstones under the store's lock; searches scan the bucket
        # snapshot they took, and the text index serializes its writes
        from sema_tpu_torch.crawl import FileCrawler
        directory = resolve_directory(args)

        def reindex_loop():
            while not stop.wait(args.reindex_interval):
                try:
                    files = FileCrawler(
                        crawler_config(config)).crawl_directory(directory)
                    n = mgr.process_and_index_files(
                        files, purge_missing_under=directory)
                    if n:
                        print(f"re-indexed {n} chunks "
                              f"({mgr.vector_store.live_rows} live)",
                              file=sys.stderr)
                except KernelError as e:
                    failed.append(e)
                    _thread.interrupt_main()
                    return
                except Exception as e:  # noqa: BLE001 — keep serving
                    print(f"re-index failed: {e}", file=sys.stderr)

        threading.Thread(target=reindex_loop, daemon=True,
                         name="reindex").start()
        print(f"re-indexing {directory} every "
              f"{args.reindex_interval:g}s", file=sys.stderr)
    main_thread = threading.current_thread() is threading.main_thread()
    if main_thread:             # only the main thread may take a signal
        previous = signal.signal(signal.SIGTERM, on_signal)
    try:
        serve_forever(mgr, host=args.host, port=args.port)
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
    if failed:
        raise failed[0]
    return 0


BENCH_TOOLS = ("load_test", "ivf_bench", "spill_ivf_bench")


def cmd_bench(args) -> int:
    """The port has no benchmark harness yet: say so and name the tools
    that measure it (``sema_tpu``'s ``bench`` calls ``bench.run`` with an
    argument it does not take)."""
    print(f"bench: the port's benchmark harness is not written yet "
          f"(config {args.config!r} not run). Its measuring tools:",
          file=sys.stderr)
    for tool in BENCH_TOOLS:
        print(f"  python -m sema_tpu_torch.tools.{tool}", file=sys.stderr)
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    cmd = {"index": cmd_index, "query": cmd_query, "tui": cmd_tui,
           "bench": cmd_bench, "serve": cmd_serve,
           "doctor": cmd_doctor}[args.command]
    try:
        return cmd(args)
    except KernelError as e:
        print(f"Error: a CUDA kernel failed: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
