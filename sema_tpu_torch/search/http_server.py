# Copy of sema_tpu/search/http_server.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""HTTP serving daemon — ``sema-tpu serve``.

The reference is TUI-only (SURVEY.md §1: "no headless/index-only or
query-only mode"). Production serving needs a long-lived process that keeps
the model and the device-resident store warm and multiplexes concurrent
clients; this daemon exposes the search engine over HTTP using only the
stdlib:

    GET  /healthz              → {"status": "ok", rows, model}
    GET  /search?q=...&k=10    → {"results": [{id, file_path, start_line,
                                   end_line, score, content}], "took_ms": N}
    POST /search               → same, JSON body {"q": ..., "k": ...}

Semantic queries ride the :class:`QueryBatcher` so concurrent requests
coalesce into one device dispatch (BASELINE config 5); ``'``-prefixed
keyword queries answer from the host BM25 index directly.
"""

from __future__ import annotations

import json
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.search.server import QueryBatcher, ServerOverloaded


def _result_row(chunk, score: float) -> dict:
    return {
        "id": chunk.id, "file_path": str(chunk.file_path),
        "start_line": chunk.start_line, "end_line": chunk.end_line,
        "score": score, "content": chunk.content,
    }


class SearchService:
    """Shared state behind the HTTP handlers (and reusable headlessly)."""

    def __init__(self, index_manager, max_batch: int = 64,
                 max_wait_ms: float = 2.0,
                 max_queue: Optional[int] = None,
                 deadline_ms: Optional[float] = 10_000.0):
        self.manager = index_manager
        self.batcher = QueryBatcher(
            index_manager.vector_store, max_batch=max_batch,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            deadline_ms=deadline_ms)

    def search(self, query: str, k: int, exact: bool = False):
        query = query.strip()
        if query.startswith("'"):
            # delegate the keyword branch to the manager's dispatch (one
            # copy of the prefix semantics + its text_search metrics
            # timer) — only the semantic branch needs the batcher
            return self.manager.search(query, k)
        # minimum-length gate: parity with the TUI/CLI frontends
        # (engine.py MIN_QUERY_BYTES ≙ app.rs:165) — without it a 1-char
        # HTTP query burns a device batch slot on meaningless matches
        from sema_tpu_torch.search.engine import MIN_QUERY_BYTES
        if len(query.encode("utf-8")) < MIN_QUERY_BYTES:
            raise ValueError(
                f"query must be at least {MIN_QUERY_BYTES} bytes")
        try:
            qvec = self.manager.encoder.encode_query(query)
            # exact: the per-query recall contract (docs/API.md) — IVF
            # stores serve THIS request through the exact scan
            # (recall@k 1.0); the batcher partitions so pruned traffic
            # keeps its latency
            return self.batcher.search(qvec, k, exact=exact)
        except KernelError:
            raise   # a kernel that does not build or launch is a fault to
            #         surface (500), never a query to degrade
        except (ServerOverloaded, TimeoutError):
            raise   # shed load; degrading a timed-out query to a host
            #         substring scan would ADD load under overload
        except Exception as e:  # noqa: BLE001 — parity with
            # IndexManager.search: a failed query embedding degrades to
            # the substring scan (lance_indexer.rs:143-148) instead of a
            # 500 that the TUI/CLI would not produce for the same state
            import sys
            print(f"Warning: semantic query failed ({e}); falling back "
                  "to substring scan", file=sys.stderr)
            return self.manager.vector_store.substring_scan(query, k)

    def stats(self) -> dict:
        return {
            "status": "ok",
            "model": self.manager.encoder.spec.name,
            "rows": self.manager.vector_store.live_rows,
            "text_docs": self.manager.text_index.num_live_docs,
            # device vs HBM-spilled residency (non-forcing peek): a
            # nonzero host_buckets explains streamed-scan latency
            "store": self.manager.vector_store.device_residency(),
            # live serving breakdown (per-stage p50/p99 over the last
            # stats window) — the production view of where batch time goes
            "batcher": self.batcher.stats(),
        }

    def close(self):
        self.batcher.close()


class _Handler(BaseHTTPRequestHandler):
    service: SearchService  # injected via the server class

    def _send(self, code: int, obj, headers: Optional[dict] = None) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _handle_search(self, query, k: int, exact: bool = False) -> None:
        if not query or not isinstance(query, str):
            self._send(400, {"error": "missing query parameter 'q'"})
            return
        t0 = time.perf_counter()
        try:
            results = self.service.search(query, k, exact=exact)
        except (ServerOverloaded, TimeoutError) as e:
            # shed load explicitly: clients should back off and retry
            # rather than pile onto a 60 s timeout
            self._send(503, {"error": str(e)},
                       headers={"Retry-After": "1"})
            return
        except ValueError as e:
            # client-shaped error (short query, bad vector): 400, not 500
            self._send(400, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001
            self._send(500, {"error": str(e)})
            return
        self._send(200, {
            "results": [_result_row(c, s) for c, s in results],
            "took_ms": round((time.perf_counter() - t0) * 1e3, 3),
        })

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        if url.path == "/healthz":
            self._send(200, self.service.stats())
            return
        if url.path == "/search":
            qs = urllib.parse.parse_qs(url.query)
            query = (qs.get("q") or [None])[0]
            try:
                k = int((qs.get("k") or ["10"])[0])
            except ValueError:
                self._send(400, {"error": "k must be an integer"})
                return
            exact = (qs.get("exact") or ["0"])[0] not in ("0", "", "false")
            self._handle_search(query, max(1, min(k, 1000)), exact=exact)
            return
        self._send(404, {"error": f"unknown path {url.path}"})

    def do_POST(self):
        url = urllib.parse.urlparse(self.path)
        if url.path != "/search":
            self._send(404, {"error": f"unknown path {url.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            query = payload.get("q")
            k = int(payload.get("k") if payload.get("k") is not None
                    else 10)
            exact = bool(payload.get("exact", False))
        except (ValueError, TypeError, json.JSONDecodeError):
            # TypeError covers valid-JSON-wrong-shape bodies like
            # {"k": null} / {"k": [1]} — previously these escaped
            # do_POST and reset the connection with no HTTP response
            self._send(400, {"error": "invalid JSON body"})
            return
        self._handle_search(query, max(1, min(k, 1000)), exact=exact)


def make_server(service: SearchService, host: str = "127.0.0.1",
                port: int = 7700) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(index_manager, host: str = "127.0.0.1", port: int = 7700):
    service = SearchService(index_manager)
    # bind FIRST so a taken port fails fast (EADDRINUSE before paying
    # the multi-second warmup); early connections just sit in the listen
    # backlog until serve_forever starts accepting
    server = make_server(service, host, port)
    # warm the query path before accepting traffic: first dispatch in a
    # process pays executable load + param placement (seconds even with the
    # persistent compile cache)
    if index_manager.vector_store.live_rows:
        try:
            service.search("warmup", 1)
        except KernelError:
            # kernels that do not build or launch: take no traffic
            service.close()
            server.server_close()
            raise
        except Exception:  # noqa: BLE001 — warmup is best-effort
            pass
    print(f"serving on http://{host}:{server.server_address[1]} "
          f"({service.stats()['rows']} vectors)")
    try:
        server.serve_forever()
    finally:
        service.close()
