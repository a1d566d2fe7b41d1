"""Exporters: Prometheus text rendering + the /metrics HTTP endpoint.

Port of lightgbm_tpu/observability/export.py, with the same
``lightgbm_tpu_*`` metric family names, so one scrape configuration
reads either package.

`prometheus_lines` flattens a nested snapshot dict into Prometheus
text-exposition (version 0.0.4) lines: numeric leaves become samples
named `<prefix>_<path>` (bools as 0/1, None and strings skipped),
optional labels render as `{k="v"}`. Each metric family gets a
`# TYPE ... gauge` header — counters here are monotonic in-process but
reset on restart, so gauge is the honest declaration.

`MetricsHTTPServer` is a stdlib-only (http.server) daemon-thread
endpoint: GET /metrics -> text format, /healthz -> ok, /snapshot ->
JSON. Bind port 0 for an ephemeral port (tests); `.port` carries the
bound port. No third-party client library is required or used.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

__all__ = ["prometheus_lines", "render_prometheus", "MetricsHTTPServer"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(*parts: str) -> str:
    name = "_".join(p for p in parts if p)
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _label_str(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    items = ",".join(
        '%s="%s"' % (_LABEL_RE.sub("_", str(k)),
                     str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{" + items + "}"


def prometheus_lines(mapping: Dict, prefix: str,
                     labels: Optional[Dict[str, str]] = None,
                     _seen_types: Optional[set] = None) -> List[str]:
    """Flatten `mapping` (nested dicts / numeric leaves) into text-
    format lines. Non-numeric leaves (strings, None) are skipped."""
    out: List[str] = []
    seen = set() if _seen_types is None else _seen_types
    label_s = _label_str(labels)
    for key in sorted(mapping):
        value = mapping[key]
        name = _metric_name(prefix, str(key))
        if isinstance(value, dict):
            out.extend(prometheus_lines(value, name, labels, seen))
            continue
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)) or value != value:
            continue          # strings, None, NaN
        if name not in seen:
            seen.add(name)
            out.append(f"# TYPE {name} gauge")
        out.append(f"{name}{label_s} {value}")
    return out


def render_prometheus(sections) -> str:
    """Join (mapping, prefix, labels) sections into one scrape body."""
    lines: List[str] = []
    seen: set = set()
    for mapping, prefix, labels in sections:
        lines.extend(prometheus_lines(mapping, prefix, labels, seen))
    return "\n".join(lines) + "\n"


class MetricsHTTPServer:
    """Daemon-thread HTTP endpoint serving live metrics callbacks."""

    def __init__(self, render_text: Callable[[], str],
                 render_json: Optional[Callable[[], Dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib contract)
                path = self.path.split("?", 1)[0]
                try:
                    if path in ("/metrics", "/"):
                        body = outer._render_text().encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    elif path == "/healthz":
                        body, ctype = b"ok\n", "text/plain"
                    elif path == "/snapshot" and outer._render_json:
                        body = (json.dumps(outer._render_json())
                                + "\n").encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as exc:  # render fault -> 500, not crash
                    self.send_error(500, str(exc)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes stay out of stderr
                pass

        self._render_text = render_text
        self._render_json = render_json
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="lgbmtpu-metrics",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsHTTPServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
