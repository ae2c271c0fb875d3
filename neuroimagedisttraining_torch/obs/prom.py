"""Prometheus text exposition for the obs metrics registry (counterpart of
``neuroimagedisttraining_tpu/obs/prom.py``, copied: the bodies are its
bytes).

``--obs_prom_port N`` gives any long-lived process (the federation
aggregator, the serve worker) a standard scrape surface: an HTTP
thread serving ``/metrics`` in Prometheus text format 0.0.4, rendered
from the existing :class:`obs.metrics.MetricsRegistry` snapshot. No
new dependency — the server is stdlib ``http.server`` on a daemon
thread, and the renderer is a pure function of the snapshot
(deterministic key order, golden-file-pinned in tests/test_prom.py).

Mapping (registry kind -> prom type):

* counter -> ``counter`` (value row, plus one row per label set)
* gauge   -> ``gauge``   (an unset gauge with only labeled children
  renders the children alone)
* distribution -> ``summary``: ``{quantile="0.5"|"0.99"}`` rows from
  the streaming p50/p99, plus ``_sum`` / ``_count`` — the standard
  summary triple scrapers already understand.

Flag inertness: the port never enters ``run_identity`` and the server
reads the registry, never writes it — scraping a run cannot change
it.
"""
from __future__ import annotations

import http.server
import json
import logging
import re
import socket
import threading
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

__all__ = ["PromServer", "render_prom"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _name(name: str) -> str:
    """A registry name as a legal prom metric name (the registry
    already sticks to ``[a-z0-9_]``; this is the belt)."""
    n = _NAME_RE.sub("_", str(name))
    return "_" + n if n[:1].isdigit() else n


def _fmt(v: float) -> str:
    """Shortest-roundtrip float text (``repr``) with prom's special
    values spelled the prom way."""
    f = float(v)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_body(label_key: str) -> str:
    """The registry's ``k=v,k2=v2`` label-set key -> prom label body
    (values escaped per the text-format rules)."""
    parts = []
    for kv in label_key.split(","):
        k, _, v = kv.partition("=")
        v = v.replace("\\", r"\\").replace("\n", r"\n") \
             .replace('"', r'\"')
        parts.append(f'{_name(k)}="{v}"')
    return ",".join(parts)


def _dist_rows(base: str, label: str,
               stats: Dict[str, Any]) -> list:
    ins = "{" + label + ("," if label else "")
    rows = []
    for q, key in (("0.5", "p50"), ("0.99", "p99")):
        if isinstance(stats.get(key), (int, float)):
            rows.append(f'{base}{ins}quantile="{q}"}} '
                        f"{_fmt(stats[key])}")
    suffix = ("{" + label + "}") if label else ""
    rows.append(f"{base}_sum{suffix} {_fmt(stats.get('sum', 0.0))}")
    rows.append(f"{base}_count{suffix} "
                f"{_fmt(stats.get('count', 0.0))}")
    return rows


def render_prom(snapshot: Dict[str, Any]) -> str:
    """One registry snapshot -> the full ``/metrics`` body. Pure and
    deterministic: metrics in sorted name order (the snapshot's own
    order), label sets in sorted order (ditto), floats via shortest
    roundtrip — two identical snapshots render byte-identical
    bodies."""
    lines = []
    for name in sorted(snapshot):
        info = snapshot[name] or {}
        kind = info.get("type", "gauge")
        base = _name(name)
        value = info.get("value")
        labeled = info.get("labeled") or {}
        if kind == "distribution":
            lines.append(f"# TYPE {base} summary")
            if isinstance(value, dict):
                lines.extend(_dist_rows(base, "", value))
            for lk in sorted(labeled):
                lv = labeled[lk]
                if isinstance(lv, dict):
                    lines.extend(_dist_rows(base, _label_body(lk), lv))
            continue
        prom_kind = "counter" if kind == "counter" else "gauge"
        lines.append(f"# TYPE {base} {prom_kind}")
        if isinstance(value, (int, float)):
            lines.append(f"{base} {_fmt(value)}")
        for lk in sorted(labeled):
            lv = labeled[lk]
            if isinstance(lv, (int, float)):
                lines.append(
                    f"{base}{{{_label_body(lk)}}} {_fmt(lv)}")
    return "\n".join(lines) + ("\n" if lines else "")


class PromServer:
    """The scrape endpoint: ``GET /metrics`` renders the snapshot the
    constructor's callable produces at scrape time (so the body tracks
    the live registry); anything else is 404. Daemon-threaded, bound
    to localhost, closed idempotently — observability must never keep
    the process it observes alive."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]],
                 port: int = 0, host: str = "127.0.0.1"):
        self._snapshot_fn = snapshot_fn
        self._host = host
        self._want_port = int(port)
        self._httpd: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port = 0

    def start(self) -> "PromServer":
        snapshot_fn = self._snapshot_fn

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404)
                    return
                try:
                    body = render_prom(snapshot_fn()).encode()
                except Exception:
                    logger.warning("prom render failed",
                                   exc_info=True)
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not run logs
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self._host, self._want_port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval":
                                                      0.1},
            name=f"prom:{self.port}", daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}/metrics"

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def maybe_prom_server(snapshot_fn: Callable[[], Dict[str, Any]],
                      port: int) -> Optional[PromServer]:
    """The runtime gate: a started server when ``port`` is set
    (``-1`` picks an ephemeral port — the smoke/test mode), else
    None. A bind failure logs and returns None — a taken port must
    not kill the run it would have observed."""
    if not port:
        return None
    try:
        return PromServer(snapshot_fn,
                          port=0 if port < 0 else int(port)).start()
    except (OSError, socket.error):
        logger.warning("prom exposition disabled: port %s unusable",
                       port, exc_info=True)
        return None


def parse_prom_text(body: str) -> Dict[str, float]:
    """A tiny parser for the text format (the smoke's scrape
    assertion, not a general client): sample name+labels -> value.
    Raises ValueError on a malformed sample line."""
    out: Dict[str, float] = {}
    for i, line in enumerate(body.splitlines()):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(None, 1)
            out[key] = float(val.replace("+Inf", "inf")
                             .replace("-Inf", "-inf"))
        except ValueError as e:
            raise ValueError(
                f"malformed prom sample line {i + 1}: "
                f"{json.dumps(line)}") from e
    return out
