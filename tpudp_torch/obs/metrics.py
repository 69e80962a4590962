"""Prometheus-style text exposition of ``metrics()`` snapshots — the port
of ``tpudp/obs/metrics.py``.

:func:`prometheus_text` flattens the numeric leaves of a nested dict
(``Engine.metrics()``, ``Trainer.metrics()``) into ``# TYPE`` + ``name
value`` lines (path segments joined by ``_``, other characters
sanitized), byte for byte JAX's; :class:`MetricsServer` serves that text
over HTTP on a daemon thread (``tpudp_torch.cli --metrics-port N``).  The
text format only, on the standard library: no client library.
"""

from __future__ import annotations

import re
import threading

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _flatten(prefix: str, value, out: list[tuple[str, float]]) -> None:
    if isinstance(value, dict):
        for key in sorted(value, key=str):
            name = f"{prefix}_{key}" if prefix else str(key)
            _flatten(name, value[key], out)
        return
    if isinstance(value, bool):
        out.append((prefix, 1.0 if value else 0.0))
    elif isinstance(value, (int, float)):
        out.append((prefix, float(value)))
    # non-numeric leaves (strings, None, lists) are not series — skipped


def prometheus_text(metrics: dict, prefix: str = "tpudp") -> str:
    """Flatten a ``metrics()`` snapshot into Prometheus text format."""
    series: list[tuple[str, float]] = []
    _flatten(prefix, metrics, series)
    lines = []
    for name, value in series:
        name = _NAME_RE.sub("_", name)
        lines.append(f"# TYPE {name} gauge")
        # full precision, never %g: a token counter past ~1e6 must not
        # round to 6 significant digits on the wire
        text = "%d" % value if value.is_integer() else repr(value)
        lines.append(f"{name} {text}")
    return "\n".join(lines) + ("\n" if lines else "")


class MetricsServer:
    """Tiny ``/metrics`` HTTP endpoint on a daemon thread.

    ``supplier`` is called per request and must return the metrics
    dict; a supplier failure serves a 500 with the error text instead
    of killing the serving thread.  Binds localhost only — this is an
    operator peephole, not an ingress."""

    def __init__(self, port: int, supplier, prefix: str = "tpudp",
                 host: str = "127.0.0.1"):
        import http.server

        server_self = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                try:
                    body = prometheus_text(server_self.supplier(),
                                           server_self.prefix)
                    code = 200
                except Exception as exc:  # supplier is user code
                    body, code = f"# metrics supplier failed: {exc!r}\n", 500
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # quiet by default
                pass

        self.supplier = supplier
        self.prefix = prefix
        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="tpudp-metrics")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
