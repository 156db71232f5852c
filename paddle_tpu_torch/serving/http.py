"""Stdlib HTTP surface for the ServingFrontend (zero new dependencies) —
the twin of ``paddle_tpu/serving/http.py``.

Endpoints
---------
``POST /generate``   body: ``{"prompt": [ids...], "max_new_tokens": N,
                     "deadline_ms": float?, "stream": bool?,
                     "request_id": str?}``.
                     ``stream=true`` (default): ``200`` with
                     ``Transfer-Encoding: chunked`` NDJSON — one line
                     per event: ``{"token": t, "index": i}`` per
                     generated token, ``{"restart": true}`` when a
                     replica failure restarts the stream from token 0,
                     and a final
                     ``{"done": true, "status": ..., "retried": ...,
                     "num_tokens": ..., "ttft_ms": ..., "e2e_ms": ...}``.
                     ``stream=false``: one JSON body with the full
                     token list after the request reaches a terminal
                     state.  Overload rejection maps to ``429``,
                     deadline miss to ``504``, invalid input to ``400``.
``GET /healthz``     router/frontend health JSON; ``200`` while at
                     least one replica is healthy, else ``503``.
``GET /metrics``     Prometheus text exposition of the process-wide
                     StatRegistry (``serving.*`` engine metrics,
                     ``serving.frontend.*`` request metrics, and
                     everything else the process records).
``GET /debug/requests``
                     recent TERMINAL request traces (newest last) plus
                     the ids of live ones — the flight recorder's
                     request index.
``GET /debug/requests/<rid>``
                     one request's structured lifecycle timeline
                     (queued → placed → admitted → ... → terminal,
                     replica-annotated — a failover trace spans both
                     replicas); unknown/evicted ids are ``404``.
                     ``?format=chrome`` renders it as a Chrome trace
                     (``profiler.chrome_trace.request_trace_events``:
                     one row per replica, loadable in chrome://tracing
                     and Perfetto).

A client disconnect mid-stream cancels the request (frees its pages and
batch lane) instead of decoding tokens nobody will read.
"""
from __future__ import annotations

import http.server
import json
import threading

from ..framework.errors import InvalidArgumentError, http_status_for
from ..profiler.exposition import prometheus_text
from ..testing.chaos import chaos_site
from .frontend import CANCELLED, COMPLETED, ServingFrontend

__all__ = ["ServingHTTPServer", "start_http_server"]


def _http_status(handle) -> int:
    """HTTP status of a terminal handle, DERIVED from the typed error
    taxonomy (framework.errors.ERROR_HTTP_STATUS) instead of an ad-hoc
    per-status table: queue_cap rejection carries ResourceExhausted →
    429, brownout/no-replica carries Unavailable → 503, deadline_miss
    carries DeadlineExceeded → 504, failed carries Internal → 500.
    ``cancelled`` keeps the conventional (non-RFC) 499, ``completed``
    is 200."""
    status = handle.status
    if status == COMPLETED:
        return 200
    if status == CANCELLED:
        return 499
    err = handle.error_cls
    return 500 if err is None else http_status_for(err)


def _terminal_payload(handle) -> dict:
    err = handle.error_cls
    return {
        "done": True,
        "request_id": handle.request_id,
        "status": handle.status,
        "detail": handle.detail or None,
        "error": None if err is None else err.__name__,
        "retried": handle.retried,
        "resumed_from": handle.resumed_from,
        "num_tokens": handle.num_tokens,
        "ttft_ms": handle.ttft_ms,
        "e2e_ms": handle.e2e_ms,
    }


class _Handler(http.server.BaseHTTPRequestHandler):
    # HTTP/1.1 so Transfer-Encoding: chunked is legal (1.0 has no
    # chunked framing — a streaming response would have to close the
    # connection to delimit the body)
    protocol_version = "HTTP/1.1"

    @property
    def frontend(self) -> ServingFrontend:
        return self.server.frontend       # type: ignore[attr-defined]

    def log_message(self, *a):            # silence per-request stderr spam
        pass

    # --- helpers ------------------------------------------------------------
    def _send_json(self, code: int, obj: dict):
        body = (json.dumps(obj) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _chunk(self, obj: dict):
        data = (json.dumps(obj) + "\n").encode()
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _end_chunks(self):
        self.wfile.write(b"0\r\n\r\n")

    # --- routes -------------------------------------------------------------
    def do_GET(self):                     # noqa: N802 — http.server contract
        path, _, query = self.path.partition("?")
        path = path.rstrip("/")
        if path == "/healthz":
            hz = self.frontend.healthz()
            self._send_json(200 if hz["status"] == "ok" else 503, hz)
        elif path == "/metrics":
            body = prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/debug/requests":
            from ..profiler.flight_recorder import recorder

            self._send_json(200, {
                "recent": self.frontend.recent_traces(),
                "live": recorder.live_request_ids()})
        elif path.startswith("/debug/requests/"):
            rid = path[len("/debug/requests/"):]
            trace = self.frontend.trace(rid)
            if trace is None:
                self._send_json(404, {"error": f"no trace for request "
                                               f"{rid!r} (unknown or "
                                               "evicted)"})
                return
            if "format=chrome" in query:
                from ..profiler.chrome_trace import request_trace_events

                self._send_json(200, request_trace_events(trace))
            else:
                self._send_json(200, trace)
        else:
            self._send_json(404, {"error": f"no route {self.path!r}"})

    def do_POST(self):                    # noqa: N802 — http.server contract
        path = self.path.split("?", 1)[0].rstrip("/")
        if path != "/generate":
            self._send_json(404, {"error": f"no route {self.path!r}"})
            return
        # chaos site "http.request": inject a 5xx before the frontend is
        # touched (clients must survive transport-level failures too)
        fault = chaos_site("http.request", key=path)
        if fault is not None and fault.action == "http_error":
            self._send_json(fault.status,
                            {"error": fault.message, "chaos": True})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict):
                raise InvalidArgumentError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._send_json(400, {"error": f"bad request body: {e}"})
            return
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            self._send_json(
                400, {"error": "prompt must be a non-empty list of "
                               "integer token ids"})
            return
        stream = bool(body.get("stream", True))
        try:
            handle = self.frontend.submit(
                prompt,
                max_new_tokens=int(body.get("max_new_tokens", 32)),
                deadline_ms=body.get("deadline_ms"),
                stream=stream,
                request_id=body.get("request_id"))
        except (ValueError, TypeError) as e:
            self._send_json(400, {"error": str(e)})
            return
        if not stream:
            handle.wait()
            payload = _terminal_payload(handle)
            payload["tokens"] = [int(t) for t in handle.tokens]
            self._send_json(_http_status(handle), payload)
            return
        if handle.done and handle.status != COMPLETED:
            # rejected/missed before any token: a plain JSON error beats
            # an empty chunked stream
            self._send_json(_http_status(handle),
                            _terminal_payload(handle))
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for ev in handle.events():
                if ev[0] == "token":
                    self._chunk({"token": ev[2], "index": ev[1]})
                elif ev[0] == "restart":
                    self._chunk({"restart": True})
                elif ev[0] == "resume":
                    # warm failover: tokens already streamed stay valid,
                    # decoding resumed at from_index on a survivor
                    self._chunk({"resumed": True, "from_index": ev[1]})
                else:                      # ("end", status)
                    self._chunk(_terminal_payload(handle))
            self._end_chunks()
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-stream: stop decoding for nobody
            handle.cancel()


class ServingHTTPServer:
    """Daemon-thread HTTP server bound to one ServingFrontend."""

    def __init__(self, frontend: ServingFrontend, port: int = 0,
                 host: str = "127.0.0.1"):
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.frontend = frontend   # type: ignore[attr-defined]
        self.frontend = frontend
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serving-http", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self, close_frontend: bool = False):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if close_frontend:
            self.frontend.close()


def start_http_server(frontend: ServingFrontend, port: int = 0,
                      host: str = "127.0.0.1") -> ServingHTTPServer:
    """Serve ``frontend`` over HTTP; ``port=0`` picks a free port (read
    it back from ``.port``)."""
    return ServingHTTPServer(frontend, port=port, host=host)
