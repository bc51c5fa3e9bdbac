"""The port's HTTP daemon on the CPU (the cases of
``tests/test_http_server.py`` against the port's manager and store), a
``KernelError`` getting through ``SearchService.search`` and the warm-up
of ``serve_forever`` where any other error degrades, and ``python -m
sema_tpu_torch serve`` end to end with its re-index thread."""

import importlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from sema_tpu_torch import cli
from sema_tpu_torch.index import IndexManager
from sema_tpu_torch.models import Encoder
from sema_tpu_torch.models.loader import random_params
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.search.http_server import (SearchService, make_server,
                                               serve_forever)
from sema_tpu_torch.search.server import QueryBatcher, ServerOverloaded
from sema_tpu_torch.tokenizer import HashTokenizer

REPO = Path(__file__).resolve().parents[1]
http_mod = importlib.import_module("sema_tpu_torch.search.http_server")


def _manager(tmp, files):
    spec = get_spec("test-tiny")
    enc = Encoder(spec, random_params(spec), HashTokenizer(spec.vocab_size),
                  batch_size=8, compute_dtype=torch.float32, device="cpu")
    mgr = IndexManager(tmp / "data", enc)
    tree = tmp / "tree"
    tree.mkdir()
    for name, text in files.items():
        (tree / name).write_text(text)
    mgr.process_and_index_files(sorted(tree.glob("*")))
    return mgr


def _join(threads, timeout):
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "a thread hung"


def _serve(service):
    httpd = make_server(service, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    mgr = _manager(tmp_path_factory.mktemp("srv"), {
        "auth.py": "def verify_token(jwt):\n    return decode_and_check(jwt)\n"
                   * 4,
        "cache.md": "# LRU cache eviction policy\nleast recently used "
                    "entries drop\n" * 4})
    service = SearchService(mgr, max_batch=4, max_wait_ms=2)
    httpd, base = _serve(service)
    yield base
    httpd.shutdown()
    service.close()
    mgr.close()


def get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _status(url, data=None):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(server):
    status, body = get(f"{server}/healthz")
    assert status == 200
    assert body["status"] == "ok" and body["rows"] > 0
    assert body["model"] == "test-tiny"
    assert body["store"]["host_buckets"] == 0
    assert "batches" in body["batcher"]


def test_semantic_search_get(server):
    status, body = get(f"{server}/search?q=token+verification&k=3")
    assert status == 200
    assert len(body["results"]) == 3 and body["took_ms"] > 0
    assert {"id", "file_path", "start_line", "end_line", "score",
            "content"} <= set(body["results"][0])


def test_semantic_search_get_exact(server):
    status, body = get(f"{server}/search?q=token+verification&k=3&exact=1")
    assert status == 200
    _, base = get(f"{server}/search?q=token+verification&k=3")
    assert [r["id"] for r in body["results"]] == \
        [r["id"] for r in base["results"]]


def test_keyword_search_get(server):
    status, body = get(f"{server}/search?q='eviction&k=10")
    assert status == 200 and body["results"]
    assert all("cache.md" in r["file_path"] for r in body["results"])


def test_post_search(server):
    status, body = _status(f"{server}/search",
                           json.dumps({"q": "cache", "k": 2}).encode())
    assert status == 200 and len(body["results"]) <= 2


@pytest.mark.parametrize("path,code", [
    ("/search", 400),                      # no query
    ("/search?q=x&k=banana", 400),
    ("/search?q=a", 400),                  # under MIN_QUERY_BYTES
    ("/nope", 404),
])
def test_client_errors(server, path, code):
    status, payload = _status(f"{server}{path}")
    assert status == code and "error" in payload


@pytest.mark.parametrize("body", [b'{"q": "x", "k": null}', b'{"q": "x", '
                                  b'"k": [1]}', b'[1, 2]', b'"hi"',
                                  b'{"q": 123}'])
def test_post_wrong_shape_is_400(server, body):
    status, payload = _status(f"{server}/search", body)
    assert status == 400 and "error" in payload


def test_concurrent_requests(server):
    results, errors = [], []

    def hit(i):
        try:
            results.append(get(f"{server}/search?q=query+number+{i}&k=1"))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    _join(threads, 60)
    assert not errors and len(results) == 16
    assert all(s == 200 for s, _ in results)


def test_overload_returns_503_with_retry_after(tmp_path):
    mgr = _manager(tmp_path, {"a.md": "alpha beta gamma delta " * 20})
    service = SearchService(mgr, max_batch=1, max_wait_ms=0.1, max_queue=1)

    class SlowStore:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def search_batch_async(self, q, k, **kw):
            time.sleep(0.3)
            return self._inner.search_batch_async(q, k, **kw)

    service.batcher.close()
    service.batcher = QueryBatcher(SlowStore(mgr.vector_store), max_batch=1,
                                   max_wait_ms=0.1, max_queue=1)
    httpd, base = _serve(service)
    try:
        codes, retry = [], []

        def hit():
            try:
                with urllib.request.urlopen(f"{base}/search?q=alpha&k=2",
                                            timeout=30) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                retry.append(e.headers.get("Retry-After"))

        threads = [threading.Thread(target=hit) for _ in range(12)]
        for t in threads:
            t.start()
        _join(threads, 60)
        assert 503 in codes and 200 in codes, codes
        assert set(retry) == {"1"}
    finally:
        httpd.shutdown()
        service.close()
        mgr.close()


def test_embed_failure_degrades_but_kernel_error_does_not(tmp_path, capsys):
    """A failed query embedding degrades to the substring scan, as
    ``IndexManager.search`` does; a KernelError does not: it reaches the
    caller, and a request for it answers 500."""
    mgr = _manager(tmp_path, {"doc.txt": "needle in the haystack content\n"
                                         * 8})
    service = SearchService(mgr, max_batch=4, max_wait_ms=2)
    mgr.encoder.encode_query = lambda _: (_ for _ in ()).throw(
        RuntimeError("device gone"))
    results = service.search("needle", 5)
    assert results and all("needle" in c.content for c, _ in results)
    mgr.encoder.encode_query = lambda _: (_ for _ in ()).throw(
        KernelError("fused_encoder_layer_int8: CUDA error 700"))
    capsys.readouterr()
    with pytest.raises(KernelError):
        service.search("needle", 5)
    assert "substring" not in capsys.readouterr().err
    # from the batcher's threads too: a scan that fails on the card
    del mgr.encoder.encode_query
    mgr.vector_store.search_batch_async = lambda *a, **k: (
        _ for _ in ()).throw(KernelError("scan_topk: refused"))
    with pytest.raises(KernelError, match="refused"):
        service.search("needle", 5)
    httpd, base = _serve(service)
    try:
        status, payload = _status(f"{base}/search?q=needle&k=3")
        assert status == 500 and "refused" in payload["error"]
    finally:
        httpd.shutdown()
        service.close()
        mgr.close()


def test_warmup_kernel_error_stops_serve_forever(tmp_path, monkeypatch):
    mgr = _manager(tmp_path, {"doc.txt": "needle in the haystack content\n"
                                         * 8})
    mgr.encoder.encode_query = lambda _: (_ for _ in ()).throw(
        KernelError("kernel build failed: nvcc rc=1"))
    with pytest.raises(KernelError, match="build failed"):
        serve_forever(mgr, host="127.0.0.1", port=0)
    # a plain failure of the warm-up is best effort: the daemon goes on to
    # serve (here a server that returns at once)
    mgr.encoder.encode_query = lambda _: (_ for _ in ()).throw(
        RuntimeError("device gone"))
    served = []

    def returning_server(service, host, port):
        httpd = make_server(service, host, port)
        httpd.serve_forever = lambda: served.append(True)
        return httpd
    monkeypatch.setattr(http_mod, "make_server", returning_server)
    serve_forever(mgr, host="127.0.0.1", port=0)
    assert served
    mgr.close()


def test_cli_serve_exits_nonzero_on_a_kernel_error(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("SEMA_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "data"))
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "net.md").write_text("Retry logic with exponential backoff.\n" * 8)
    assert cli.main(["index", str(tree), "--device", "cpu"]) == 0
    bert_mod = __import__("sema_tpu_torch.models.bert", fromlist=["bert"])
    monkeypatch.setattr(bert_mod, "fused_encoder_layer", lambda *a: (
        _ for _ in ()).throw(KernelError("fused_encoder_layer: CUDA error 9")))
    before = signal.getsignal(signal.SIGTERM)
    assert cli.main(["serve", str(tree), "--port", "0",
                     "--device", "cpu"]) == 1
    assert "CUDA error 9" in capsys.readouterr().err
    assert signal.getsignal(signal.SIGTERM) == before


def test_serve_subprocess_reindexes_and_stops_on_sigterm(tmp_path):
    """``python -m sema_tpu_torch serve`` on the CPU: answers, picks up a
    changed file at its next re-index tick, and stops on SIGTERM with
    exit code 0 and no traceback."""
    env = dict(os.environ, SEMA_TPU_HOME=str(tmp_path / "home"),
               SEMA_TPU_DATA=str(tmp_path / "data"))
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "net.md").write_text("Retry logic with exponential backoff.\n" * 8)
    run = lambda *args: subprocess.run(
        [sys.executable, "-m", "sema_tpu_torch", *args, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert run("index", str(tree)).returncode == 0
    proc = subprocess.Popen(
        [sys.executable, "-m", "sema_tpu_torch", "serve", str(tree),
         "--port", "0", "--reindex-interval", "0.3", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()       # printed after the warm-up
        base = re.search(r"serving on (http://\S+) ", line).group(1)
        status, body = get(f"{base}/healthz")
        assert status == 200 and body["rows"] > 0
        (tree / "new.md").write_text("Zebra crossings and the quagga "
                                     "herd.\n" * 6)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            _, body = get(f"{base}/search?q='quagga&k=5")
            if body["results"]:
                break
            time.sleep(0.2)
        assert {Path(r["file_path"]).name for r in body["results"]} == \
            {"new.md"}
        _, sem = get(f"{base}/search?q=zebra+crossings+quagga&k=3")
        assert "new.md" in {Path(r["file_path"]).name
                            for r in sem["results"]}
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "stopped by signal 15" in err and "Traceback" not in err


def test_batcher_close_fails_pending_fast():
    class SlowStore:
        dim = 8

        def search_batch_async(self, q, k, live=None, exact=False):
            return (q, k)

        def search_batch_finish(self, handle, q):
            time.sleep(0.2)
            qq, k = handle
            return (np.full((qq.shape[0], k), -np.inf, np.float32),
                    np.zeros((qq.shape[0], k), np.int64))

    b = QueryBatcher(SlowStore(), max_batch=2, max_wait_ms=1.0)
    b.close()
    with pytest.raises(ServerOverloaded):
        b.search(np.zeros(8, np.float32), 1, timeout=5)


def test_batcher_rejects_unbounded_queue():
    class S:
        dim = 4
    with pytest.raises(ValueError):
        QueryBatcher(S(), max_queue=0)
