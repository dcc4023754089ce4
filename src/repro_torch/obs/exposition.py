"""Exposition for the port's metrics registry: JSON snapshots, Prometheus
text format, an HTTP endpoint, and a periodic stats line. The port's own
copy of `repro/obs/exposition.py`, with the same schema string, so the
two packages' snapshots compare field for field.

  * `snapshot_json(registry, extra=...)`: the canonical JSON snapshot.
  * `to_prometheus(registry)`: Prometheus text format; counters and
    gauges verbatim, histograms as summaries (`_count`/`_sum`/`_max` plus
    `quantile="0.5|0.95|0.99"` lines over the resident window).
  * `MetricsServer(registry, port=...)`: a threaded stdlib HTTP server,
    `GET /metrics` (Prometheus text) and `GET /metrics.json` (JSON
    snapshot). `port=0` binds an ephemeral port; `.port` tells which.
  * `StatsReporter(line_fn, interval_s)`: a background thread printing
    one summary line per interval; `close()` joins it.

The server binds 127.0.0.1 by default: an operator diagnostic endpoint,
not a public API.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from repro_torch.obs.registry import MetricsRegistry, flat_name


def snapshot_json(registry: MetricsRegistry,
                  extra: Optional[Dict] = None) -> Dict:
    """The canonical JSON snapshot envelope."""
    out = {
        "schema": "repro.obs/v1",
        "ts_unix_s": time.time(),
        "metrics": registry.snapshot(),
    }
    if extra:
        out["stats"] = extra
    return out


def _prom_labels(labels, extra=()) -> str:
    items = list(labels) + list(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


def to_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition (counters, gauges, histogram summaries)."""
    lines = []
    typed = set()

    def head(name: str, kind: str):
        if name not in typed:
            lines.append(f"# TYPE {name} {kind}")
            typed.add(name)

    for m in registry.metrics():
        if m.kind == "counter":
            head(m.name, "counter")
            lines.append(f"{m.name}{_prom_labels(m.labels)} {m.value}")
        elif m.kind == "gauge":
            head(m.name, "gauge")
            lines.append(f"{m.name}{_prom_labels(m.labels)} {m.value}")
        else:                                        # histogram -> summary
            head(m.name, "summary")
            snap = m.snapshot()
            for q in (50, 95, 99):
                lines.append(
                    f"{m.name}"
                    f"{_prom_labels(m.labels, [('quantile', q / 100)])} "
                    f"{snap[f'p{q}']}")
            lines.append(
                f"{m.name}_count{_prom_labels(m.labels)} {snap['count']}")
            lines.append(
                f"{m.name}_sum{_prom_labels(m.labels)} {snap['sum']}")
            lines.append(
                f"{m.name}_max{_prom_labels(m.labels)} {snap['max']}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Threaded HTTP exposition of one registry (+ optional extra stats).

    `extra` is a zero-arg callable evaluated per request and merged into
    the JSON snapshot under "stats" — the engine passes its `stats()` so
    scrapes see derived state (FPS, resident scenes) alongside the raw
    metrics.
    """

    def __init__(self, registry: MetricsRegistry, *, port: int = 0,
                 host: str = "127.0.0.1",
                 extra: Optional[Callable[[], Dict]] = None):
        self.registry = registry
        self.extra = extra
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                try:
                    if self.path.startswith("/metrics.json"):
                        extra_stats = server.extra() if server.extra else None
                        body = json.dumps(snapshot_json(
                            server.registry, extra_stats), indent=2)
                        ctype = "application/json"
                    elif self.path.startswith("/metrics"):
                        body = to_prometheus(server.registry)
                        ctype = "text/plain; version=0.0.4"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:       # surface, don't kill the server
                    self.send_error(500, str(e))
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):        # keep serve stdout clean
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-server",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StatsReporter:
    """Print `line_fn()` every `interval_s` seconds on a daemon thread."""

    def __init__(self, line_fn: Callable[[], str], interval_s: float):
        self._line_fn = line_fn
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="obs-stats-reporter", daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                print(self._line_fn(), flush=True)
            except Exception as e:            # never kill the host process
                print(f"[obs] stats reporter error: {e}", flush=True)

    def close(self):
        self._stop.set()
        self._thread.join()


__all__ = ["MetricsServer", "StatsReporter", "snapshot_json",
           "to_prometheus", "flat_name"]
