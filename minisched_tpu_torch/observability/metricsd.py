"""A metrics listener for a process without a REST façade, and the
scrape CLI.

A copy of ``minisched_tpu/observability/metricsd.py``.  The REST façade
serves ``/metrics`` itself; an engine run without one (a bench, a script
around ``SchedulerService``) can serve the same exposition with
``start_metrics_server``: a daemon HTTP server with ``/metrics``,
``/debug/trace`` (the span ring as JSONL), ``/healthz`` and
``/debug/metrics.json`` off the process-global registries.
``scrape_main`` is ``python -m minisched_tpu_torch metrics <url>``.

``start_metrics_server(collect=fn)`` (the port's addition) calls ``fn``
before each ``/metrics`` or ``/debug/metrics.json`` answer, so a process
can publish gauges it keeps elsewhere exactly at scrape time (an HA
engine child publishes its kernels' launch counts so).
"""

from __future__ import annotations

import json
import sys
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple

from minisched_tpu_torch.observability import hist, trace


class _MetricsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args) -> None:  # quiet
        pass

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        collect = getattr(self.server, "collect", None)
        if collect is not None and path in ("/metrics",
                                            "/debug/metrics.json"):
            collect()
        if path == "/metrics":
            body = hist.render_prometheus().encode()
            ctype = "text/plain; version=0.0.4"
        elif path == "/debug/trace":
            body = trace.dump_jsonl().encode()
            ctype = "application/x-ndjson"
        elif path == "/healthz":
            body = b"ok"
            ctype = "text/plain"
        elif path == "/debug/metrics.json":
            body = json.dumps(hist.snapshot(), default=str).encode()
            ctype = "application/json"
        else:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         collect: Optional[Callable[[], None]] = None
                         ) -> Tuple[ThreadingHTTPServer, int,
                                    Callable[[], None]]:
    """Serve ``/metrics`` (and ``/healthz``, ``/debug/metrics.json``) on
    ``host:port`` (port 0: ephemeral).  ``collect`` runs before each
    metrics answer.  Returns (server, bound port, shutdown)."""
    srv = ThreadingHTTPServer((host, port), _MetricsHandler)
    srv.daemon_threads = True
    srv.collect = collect
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="metricsd")
    t.start()

    def shutdown() -> None:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=2.0)

    return srv, srv.server_address[1], shutdown


def scrape_main(argv) -> int:
    """``python -m minisched_tpu_torch metrics <url>``: fetch
    ``<url>/metrics`` and print the snapshot: counters and gauges as
    name/value lines, histograms as count and p50/p99 bucket upper
    bounds, with the exemplar of the slowest bucket that has one."""
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m minisched_tpu_torch metrics <url>")
        return 0 if argv else 2
    url = argv[0].rstrip("/")
    if not url.endswith("/metrics"):
        url += "/metrics"
    try:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            text = r.read().decode()
    except OSError as e:
        print(f"metrics: scrape of {url} failed: {e}", file=sys.stderr)
        return 1
    types, samples = hist.parse_prometheus(text)
    exemplars = hist.parse_exemplars(text)
    hist_names = sorted(n for n, t in types.items() if t == "histogram")
    for name, labels, val in samples:
        if types.get(name) in ("counter", "gauge") and not labels:
            shown = int(val) if val == int(val) else val
            print(f"{types[name]:9s} {name} = {shown}")
    for name in hist_names:
        count = sum(v for n, _labels, v in samples if n == name + "_count")
        p50 = hist.parsed_histogram_quantile(samples, name, 0.50)
        p99 = hist.parsed_histogram_quantile(samples, name, 0.99)

        def fmt(b):
            return "-" if b is None else f"<={b[1]:.6g}s"

        print(f"histogram {name}: count={int(count)} p50{fmt(p50)} "
              f"p99{fmt(p99)}")
        # buckets render low to high, so the last exemplar-carrying bucket
        # line is the slowest sample stamped
        exs = [e for e in exemplars if e[0] == name + "_bucket"]
        if exs:
            _n, _sl, ex_labels, ex_val = exs[-1]
            who = ex_labels.get("key", "?")
            print(f"          exemplar(slowest bucket): {who} "
                  f"({ex_val:.6g}s)")
    if not samples:
        print("(empty exposition)")
    return 0
