"""Live ops plane (counterpart of ``deepspeed_tpu/telemetry/ops_server.py``,
copied): a stdlib-only threaded HTTP exporter for one serving replica,
the scrape surface an operator reads WITHOUT stopping the process.

Endpoints:

- ``/metrics`` — Prometheus text exposition (format 0.0.4) rendered from
  a :class:`MetricsRegistry` dump: counters and gauges verbatim,
  histograms as summaries (``_count``/``_sum`` plus p50/p95 as
  ``quantile``-labeled sample lines). Metric names sanitize to the
  Prometheus charset (dots from ``<kind>.<field>`` histograms become
  underscores); label values escape per the exposition rules.
- ``/healthz`` — ``{"status": ...}``; HTTP 200 only for ``"ok"``.
  ``"recovering"`` / ``"poisoned"`` / ``"draining"`` answer 503 so a
  load balancer's readiness probe fails exactly when the replica must
  not take traffic.
- ``/statusz`` — one JSON object from the ``status`` callback
  (``ServingEngine.statusz()``: slots, queue depth, committed KV
  tokens, in-flight depth, tick overlap, recovery generation, uptime).

The server runs on a daemon thread and never blocks the tick loop: every
handler only READS (a registry dump under its own lock, atomic-copy
snapshots of serving state), and a callback that raises answers 500
instead of propagating into the serving process.

    srv = ServingEngine(engine, ...)
    ops = srv.start_ops_server(port=0)       # 0 = ephemeral
    print(ops.url)                           # http://127.0.0.1:NNNNN
    # curl $URL/metrics | grep serve_queue_depth
"""

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Union

# statuses whose readiness probe must FAIL (everything except "ok"):
# recovering (circuit breaker open), poisoned (engine state untrusted,
# no recovery armed), draining (operator removing the replica)
HEALTHY = "ok"


def _sanitize(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    """Label-value escaping per the exposition format: backslash, quote,
    newline."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _parse_key(key: str):
    """Invert ``registry.metric_key``: ``name{k=v,...}`` -> (name, labels).
    Registry label values never contain ``,``/``=`` (they are enum-ish
    strings: component/family/kind/outcome), so the plain split is exact."""
    if "{" not in key or not key.endswith("}"):
        return key, {}
    name, _, inner = key.partition("{")
    labels = {}
    for part in inner[:-1].split(","):
        k, _, v = part.partition("=")
        labels[k] = v
    return name, labels


def _label_str(labels: dict, quantile: Optional[str] = None) -> str:
    items = [(k, labels[k]) for k in sorted(labels)]
    if quantile is not None:
        items.append(("quantile", quantile))
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in items) + "}"


def _num(v) -> str:
    v = float(v)
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render_prometheus(dump: dict) -> str:
    """Prometheus text format from a ``MetricsRegistry.dump()`` dict.

    Counters/gauges render one sample per labeled key; histograms render
    as summaries — ``quantile``-labeled p50/p95 sample lines plus
    ``_count``/``_sum`` — since the registry keeps a percentile reservoir,
    not fixed buckets. Output is deterministic: metric names sorted, then
    label sets sorted, labels within a set sorted (quantile last)."""
    lines = []
    for section, ptype in (("counters", "counter"), ("gauges", "gauge")):
        grouped = {}
        for key, value in dump.get(section, {}).items():
            name, labels = _parse_key(key)
            grouped.setdefault(_sanitize(name), []).append((labels, value))
        for name in sorted(grouped):
            lines.append(f"# TYPE {name} {ptype}")
            for labels, value in sorted(grouped[name],
                                        key=lambda lv: _label_str(lv[0])):
                lines.append(f"{name}{_label_str(labels)} {_num(value)}")
    grouped = {}
    for key, snap in dump.get("histograms", {}).items():
        name, labels = _parse_key(key)
        grouped.setdefault(_sanitize(name), []).append((labels, snap))
    for name in sorted(grouped):
        lines.append(f"# TYPE {name} summary")
        for labels, snap in sorted(grouped[name],
                                   key=lambda lv: _label_str(lv[0])):
            for q, field in (("0.5", "p50"), ("0.95", "p95")):
                lines.append(f"{name}{_label_str(labels, q)} "
                             f"{_num(snap.get(field, 0.0))}")
            lines.append(f"{name}_sum{_label_str(labels)} "
                         f"{_num(snap.get('sum', 0.0))}")
            lines.append(f"{name}_count{_label_str(labels)} "
                         f"{_num(snap.get('count', 0))}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "dstpu-ops/1"

    def _respond(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — http.server API
        ops: "OpsServer" = self.server.ops  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = render_prometheus(ops.registry_dump()).encode("utf-8")
                self._respond(200, body,
                              "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                status = ops.health()
                body = json.dumps({"status": status}).encode("utf-8")
                self._respond(200 if status == HEALTHY else 503, body,
                              "application/json")
            elif path == "/statusz":
                body = json.dumps(ops.status(), default=str,
                                  sort_keys=True).encode("utf-8")
                self._respond(200, body, "application/json")
            else:
                self._respond(404, b'{"error": "unknown endpoint"}',
                              "application/json")
        except Exception as e:  # noqa: BLE001 — a broken callback must
            # answer 500, never propagate into (or kill) the serving thread
            body = json.dumps({"error": f"{type(e).__name__}: {e}"})
            try:
                self._respond(500, body.encode("utf-8"), "application/json")
            except OSError:
                pass  # client went away mid-error: nothing left to tell it

    def log_message(self, *args):
        """Silence the default stderr access log: scrape traffic must not
        interleave with the serving process's own output."""


class OpsServer:
    """Threaded HTTP exporter over a metrics registry + health/status
    callbacks. ``registry`` is a :class:`MetricsRegistry` (its ``dump()``
    is called per scrape) or a zero-arg callable returning a dump-shaped
    dict. ``port=0`` binds an ephemeral port (read it back from
    ``.port`` / ``.url``)."""

    def __init__(self, registry: Union[object, Callable[[], dict], None] = None,
                 health: Optional[Callable[[], str]] = None,
                 status: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self._registry = registry
        self._health = health
        self._status = status
        self._host = host
        self._want_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- handler callbacks ---------------------------------------------
    def registry_dump(self) -> dict:
        reg = self._registry
        if reg is None:
            return {}
        if callable(reg):
            return reg()
        return reg.dump()

    def health(self) -> str:
        return self._health() if self._health is not None else HEALTHY

    def status(self) -> dict:
        return self._status() if self._status is not None else {}

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "OpsServer":
        if self._httpd is not None:
            return self  # already serving: idempotent
        httpd = ThreadingHTTPServer((self._host, self._want_port), _Handler)
        httpd.daemon_threads = True  # scrapes never pin process exit
        httpd.ops = self  # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="dstpu-ops-server", daemon=True,
            kwargs={"poll_interval": 0.1})
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        assert self._httpd is not None, "start() the server first"
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def close(self):
        """Stop serving and release the port. Idempotent; safe to call
        from shutdown paths (never raises)."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:  # noqa: BLE001 — shutdown must not raise
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
