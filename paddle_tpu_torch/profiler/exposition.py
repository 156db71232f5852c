"""Prometheus text-exposition formatter + optional stdlib /metrics server
— the twin of ``paddle_tpu/profiler/exposition.py``.

Renders ``framework.monitor.stat_registry`` (counters-as-gauges, labeled
gauges, log-bucketed histograms) in the Prometheus text format
(version 0.0.4), so a serving deployment can be scraped with zero new
dependencies: ``start_metrics_server(port)`` runs a daemon-thread
``http.server`` answering ``GET /metrics``.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Optional

from ..framework.monitor import StatRegistry, stat_registry

__all__ = ["prometheus_text", "start_metrics_server", "MetricsServer"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape_label(v: str) -> str:
    # exposition format: backslash, double-quote and newline must be
    # escaped in label values or the scraper rejects the whole page
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _labels_str(label_items) -> str:
    if not label_items:
        return ""
    body = ",".join(f'{_sanitize(k)}="{_escape_label(v)}"'
                    for k, v in label_items)
    return "{" + body + "}"


def prometheus_text(registry: Optional[StatRegistry] = None) -> str:
    """Render every stat/gauge/histogram in ``registry`` (default: the
    process-wide one) as Prometheus text exposition.

    Families are keyed by the SANITIZED name: two raw registry names
    that collapse to the same exposition name (``t.mem`` and ``t_mem``)
    merge into one family — one ``# TYPE`` line, samples grouped —
    because a duplicate TYPE line makes the scraper reject the whole
    page.  A cross-TYPE collision (a gauge and a histogram collapsing
    to the same name) disambiguates by suffixing the later family with
    its type instead of emitting an invalid page.
    """
    reg = registry if registry is not None else stat_registry
    # family order = first appearance; value = [type, [sample lines]]
    families: dict = {}

    def family(raw_name: str, typ: str):
        pn = _sanitize(raw_name)
        while pn in families and families[pn][0] != typ:
            pn = f"{pn}_{typ}"
        entry = families.setdefault(pn, [typ, []])
        return pn, entry[1]

    # plain stats: exposed as gauges (callers use both add() and set())
    for name, value in sorted(reg.stat_values().items()):
        pn, out = family(name, "gauge")
        out.append(f"{pn} {_fmt(value)}")
    for name, gauge in sorted(reg.labeled_gauges().items()):
        pn, out = family(name, "gauge")
        for label_items, value in sorted(gauge.values().items()):
            out.append(f"{pn}{_labels_str(label_items)} {_fmt(value)}")
    for name, hist in sorted(reg.histograms().items()):
        pn, out = family(name, "histogram")
        buckets, total, count = hist.exposition_state()
        for le, cum in buckets:
            out.append(f'{pn}_bucket{{le="{_fmt(le)}"}} {cum}')
        out.append(f"{pn}_sum {_fmt(total)}")
        out.append(f"{pn}_count {count}")
    # windowed histograms: recent-window percentiles render as a
    # Prometheus SUMMARY (quantiles are point-in-time estimates over
    # the rotating window, not cumulative — exactly what summary means)
    for name, whist in sorted(reg.windowed_histograms().items()):
        pn, out = family(name, "summary")
        quantiles, total, count = whist.exposition_state()
        for q, value in quantiles:
            out.append(f'{pn}{{quantile="{_fmt(q)}"}} {_fmt(value)}')
        out.append(f"{pn}_sum {_fmt(total)}")
        out.append(f"{pn}_count {count}")
    lines = []
    for pn, (typ, samples) in families.items():
        lines.append(f"# TYPE {pn} {typ}")
        lines.extend(samples)
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Minimal /metrics endpoint over http.server (stdlib only)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[StatRegistry] = None):
        import http.server

        reg = registry

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server contract
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = prometheus_text(reg).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="paddle-tpu-metrics",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         registry: Optional[StatRegistry] = None
                         ) -> MetricsServer:
    """Start the daemon /metrics server; ``port=0`` picks a free port
    (read it back from ``.port``)."""
    return MetricsServer(port=port, host=host, registry=registry)
