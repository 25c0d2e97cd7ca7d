"""Live pull endpoint: ``/metrics`` in Prometheus text format.

Port of :mod:`repro.obs.server` (standard library only).

Everything the registry holds — the per-site execution counters, the
serve latency histograms, the SLO burn-rate gauges — becomes visible
*while the job runs*: :class:`MetricsServer` is a stdlib
``http.server`` wrapper (no new dependencies) that a training loop or
serve engine starts on a daemon thread and any Prometheus scraper (or
plain ``curl``) can poll.

Routes:

``GET /metrics``
    The registry rendered in the Prometheus text exposition format
    (version 0.0.4): counters and gauges as plain series, histograms as
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count`` and
    estimated ``_quantile{quantile="0.5|0.95|0.99"}`` gauge series from
    the decade buckets.  Label values are escaped per the format
    (``\\`` , ``"`` , newline) — site labels like
    ``shmap0/dot1 [dp=4,tp=2]`` round-trip through a parser.

``GET /healthz``
    JSON liveness: uptime, local series count, pushed sources.

``GET /runs``
    JSON listing of the metrics directory's ``events-NNNN.jsonl`` runs
    (event counts and ``events_torn_lines`` per run), when the server
    was built over one.

``POST /push``
    The aggregator mode: a multi-process mesh job has one scrapeable
    endpoint (usually rank 0's) and every other process periodically
    POSTs its registry snapshot via :func:`push_snapshot`.  Pushed
    series render alongside the local ones with a ``src`` label, so
    per-process counters stay distinguishable and sum server-side in
    the scraper (the standard Prometheus aggregation model).

The handler only reads registry *snapshots* (each metric locks itself),
so scraping never blocks the offload's hook updating a counter.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional
from urllib.parse import urlsplit

from .log import get_logger

__all__ = ["MetricsServer", "render_prometheus", "push_snapshot"]

log = get_logger("obs.server")

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")

#: The quantile series rendered per histogram (matches the snapshot).
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def _name(raw: str) -> str:
    """Sanitize to a legal Prometheus metric/label name."""
    name = _NAME_BAD.sub("_", str(raw))
    return name if not name[:1].isdigit() else "_" + name


def _escape(value) -> str:
    """Escape one label VALUE per the text exposition format."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _num(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return f"{v:.10g}"


def _labels(labels: dict, *extra) -> str:
    """Render a label set (sorted, plus ``extra`` (k, v) pairs last)."""
    items = sorted((labels or {}).items()) + list(extra)
    if not items:
        return ""
    return ("{" + ",".join(f'{_name(k)}="{_escape(v)}"'
                           for k, v in items) + "}")


def render_prometheus(snapshots: List[dict]) -> str:
    """Registry snapshot dicts -> Prometheus text exposition format.

    ``snapshots`` is any concatenation of
    :meth:`repro_torch.obs.Registry.snapshot` outputs (each entry may carry an
    extra ``src`` key naming the pushed source).  One ``# TYPE`` line
    per metric name; histograms expand into cumulative buckets,
    sum/count, and ``<name>_quantile`` gauge series.
    """
    out: List[str] = []
    typed: set = set()

    def type_line(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            out.append(f"# TYPE {name} {kind}")

    def order(snap: dict):
        return (snap.get("name", ""), str(snap.get("src", "")),
                sorted((snap.get("labels") or {}).items()))

    for snap in sorted(snapshots, key=order):
        kind = snap.get("kind")
        name = _name(snap.get("name", ""))
        extra = ((("src", snap["src"]),) if snap.get("src") else ())
        labels = snap.get("labels") or {}
        if kind in ("counter", "gauge"):
            type_line(name, kind)
            out.append(f"{name}{_labels(labels, *extra)} "
                       f"{_num(snap.get('value', 0.0))}")
        elif kind == "histogram":
            type_line(name, "histogram")
            cum = 0
            for bound, cnt in snap.get("buckets", ()):
                cum += cnt
                le = "+Inf" if bound == "inf" else _num(bound)
                out.append(f"{name}_bucket"
                           f"{_labels(labels, *extra, ('le', le))} "
                           f"{cum}")
            out.append(f"{name}_sum{_labels(labels, *extra)} "
                       f"{_num(snap.get('sum', 0.0))}")
            out.append(f"{name}_count{_labels(labels, *extra)} "
                       f"{int(snap.get('count', 0))}")
            qname = f"{name}_quantile"
            for q, key in _QUANTILES:
                if snap.get(key) is None:
                    continue
                type_line(qname, "gauge")
                out.append(
                    f"{qname}"
                    f"{_labels(labels, *extra, ('quantile', q))} "
                    f"{_num(snap[key])}")
    return "\n".join(out) + ("\n" if out else "")


def push_snapshot(url: str, source: str, registry,
                  timeout: float = 5.0) -> dict:
    """POST a registry snapshot to an aggregating server's ``/push``.

    ``registry`` is a :class:`repro_torch.obs.Registry` (snapshotted here) or
    an already-rendered snapshot list.  Returns the server's JSON ack.
    The caller owns failure policy — a mesh worker that cannot reach
    the aggregator should log and keep training, so this function
    raises rather than swallowing errors.
    """
    metrics = (registry.snapshot() if hasattr(registry, "snapshot")
               else list(registry))
    body = json.dumps({"source": str(source),
                       "metrics": metrics}).encode()
    if not url.rstrip("/").endswith("/push"):
        url = url.rstrip("/") + "/push"
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


class MetricsServer:
    """Serve a registry live over HTTP; optionally aggregate pushes.

    Args:
      registry: the local :class:`repro_torch.obs.Registry` to expose (may be
        ``None`` for a pure aggregator that only re-serves pushes).
      host/port: bind address; ``port=0`` picks an ephemeral port
        (read it back from :attr:`port` — what the tests do).
      runs_dir: optional metrics directory behind ``GET /runs``.
      stale_s: pushed sources older than this are dropped from
        ``/metrics`` (a crashed worker stops polluting the scrape);
        ``0`` keeps everything forever.
    """

    def __init__(self, registry=None, *, host: str = "127.0.0.1",
                 port: int = 0, runs_dir=None,
                 stale_s: float = 300.0):
        self.registry = registry
        self.runs_dir = Path(runs_dir) if runs_dir else None
        self.stale_s = float(stale_s)
        self._host, self._want_port = host, int(port)
        self._lock = threading.Lock()
        self._pushed: Dict[str, List[dict]] = {}
        self._pushed_at: Dict[str, float] = {}
        self._t0 = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- data plane ----------------------------------------------------

    def push(self, source: str, metrics: List[dict]) -> int:
        """Store one source's snapshot (replacing its previous one)."""
        clean = [m for m in metrics
                 if isinstance(m, dict) and m.get("name")]
        with self._lock:
            self._pushed[str(source)] = clean
            self._pushed_at[str(source)] = time.time()
        return len(clean)

    def sources(self) -> List[str]:
        with self._lock:
            return sorted(self._pushed)

    def snapshots(self) -> List[dict]:
        """Local registry snapshot + live pushed snapshots (tagged)."""
        snaps = list(self.registry.snapshot()) if self.registry else []
        now = time.time()
        with self._lock:
            for source in sorted(self._pushed):
                if (self.stale_s
                        and now - self._pushed_at[source] > self.stale_s):
                    continue
                snaps.extend({**m, "src": source}
                             for m in self._pushed[source])
        return snaps

    def render(self) -> str:
        return render_prometheus(self.snapshots())

    def _runs_payload(self) -> dict:
        from .events import read_events

        runs = []
        if self.runs_dir is not None and self.runs_dir.is_dir():
            for p in sorted(self.runs_dir.glob("events-*.jsonl")):
                events = read_events(p)
                runs.append({"run_id": p.stem.partition("-")[2],
                             "events": len(events),
                             "events_torn_lines": events.dropped,
                             "path": str(p)})
        return {"directory": (str(self.runs_dir)
                              if self.runs_dir else None),
                "runs": runs}

    def _health_payload(self) -> dict:
        local = len(self.registry.snapshot()) if self.registry else 0
        return {"status": "ok",
                "uptime_s": round(time.time() - self._t0, 3),
                "series": local,
                "pushed_sources": self.sources()}

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            server_version = "repro-obs"

            def log_message(self, *args):  # quiet: we have a logger
                pass

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, payload: dict, code: int = 200):
                self._reply(code, (json.dumps(payload) + "\n").encode(),
                            "application/json")

            def do_GET(self):
                path = urlsplit(self.path).path
                if path == "/metrics":
                    self._reply(
                        200, server.render().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    self._json(server._health_payload())
                elif path == "/runs":
                    self._json(server._runs_payload())
                else:
                    self._json({"error": f"no route {path!r}; have "
                                "/metrics /healthz /runs"}, code=404)

            def do_POST(self):
                path = urlsplit(self.path).path
                if path != "/push":
                    self._json({"error": f"no POST route {path!r}; "
                                "have /push"}, code=404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(
                        self.rfile.read(length).decode())
                    source = str(payload["source"])
                    metrics = payload["metrics"]
                    if not isinstance(metrics, list):
                        raise TypeError("metrics must be a list of "
                                        "snapshot dicts")
                except (KeyError, TypeError, ValueError) as e:
                    self._json({"error": f"bad push payload: {e}"},
                               code=400)
                    return
                n = server.push(source, metrics)
                self._json({"ok": True, "source": source, "series": n})

        self._httpd = ThreadingHTTPServer((self._host, self._want_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro-obs-metrics-server", daemon=True)
        self._thread.start()
        log.info(f"metrics server on http://{self._host}:{self.port}"
                 "/metrics")
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            return self._want_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def close(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
