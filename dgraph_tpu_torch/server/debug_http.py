"""Debug/observability HTTP listener for cluster node processes.

A `dgraph-tpu node` process speaks the framed cluster wire protocol —
great for data traffic, useless for an operator with curl, a
Prometheus scraper, tools/dgtop.py or tools/dgbench.py's collector.
This module is the reference's debug mux (x/metrics.go wires pprof +
expvar + /debug/prometheus_metrics onto every node) for those
processes: a tiny read-only HTTP server over the SAME planes the main
Alpha surface exposes —

    GET /health                     liveness + identity
    GET /debug/stats                tablet statistics + cost store +
                                    metrics counters/gauges/histograms
    GET /debug/requests             the bounded request ring
    GET /debug/prometheus_metrics   text exposition 0.0.4
    GET /debug/traces[?trace_id=]   node-local span slice
    GET /debug/pprof?seconds=N      wall-clock sampling profile
    GET /debug/fault                active network-fault rules
    POST /debug/fault               fault control (utils/netfault.py):
                                    {"action": "set|add|remove|clear",
                                     "rules": [...]} — curl-able chaos
                                    arming/healing for an operator

It is deliberately NOT the query surface: no txn state, no ACL store,
and the single POST handler touches only the process-local fault
table — bind it to localhost (the default) or scrape-net interfaces
only. `serve_debug` takes callables so AlphaServer and ZeroServer plug
in whatever stats they have without this module importing engine
internals.

Port of `dgraph_tpu/server/debug_http.py`: a copy, its imports pointed at this
package.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from dgraph_tpu_torch.utils import metrics, reqlog, tracing


class _DebugHandler(BaseHTTPRequestHandler):
    server_version = "dgraph-tpu-debug/0.1"
    stats_fn: Optional[Callable[[], dict]] = None
    health_fn: Optional[Callable[[], dict]] = None
    node_name: str = "node"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code: int, obj, ctype="application/json"):
        data = obj if isinstance(obj, bytes) else \
            json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        u = urlparse(self.path)
        params = {k: v[-1] for k, v in parse_qs(u.query).items()}
        try:
            if u.path == "/health":
                out = {"status": "healthy", "node": self.node_name}
                if self.health_fn is not None:
                    out.update(self.health_fn())
                self._send(200, out)
            elif u.path == "/debug/stats":
                out = self.stats_fn() if self.stats_fn is not None \
                    else {}
                out.setdefault("node", self.node_name)
                metrics.collect_process_gauges()
                out["counters"] = metrics.counters_snapshot()
                out["gauges"] = metrics.gauges_snapshot()
                out["histograms"] = metrics.histograms_snapshot()
                self._send(200, out)
            elif u.path == "/debug/requests":
                self._send(200, reqlog.snapshot())
            elif u.path == "/debug/prometheus_metrics":
                self._send(200, metrics.render_prometheus().encode(),
                           ctype="text/plain; version=0.0.4")
            elif u.path == "/debug/traces":
                tid = params.get("trace_id") or None
                self._send(200, {"traceEvents":
                                 tracing.export_chrome_trace(
                                     trace_id=tid)})
            elif u.path == "/debug/pprof":
                from dgraph_tpu_torch.utils import pprof
                self._send(200, pprof.handle_params(
                    params, node=self.node_name))
            elif u.path == "/debug/fault":
                from dgraph_tpu_torch.utils import netfault
                self._send(200, {"node": self.node_name,
                                 "rules": netfault.rules()})
            elif u.path == "/debug/alerts":
                from dgraph_tpu_torch.utils import watchdog
                if params.get("ack"):
                    out: dict = {"acked":
                                 watchdog.ack(params["ack"])}
                elif params.get("silence"):
                    watchdog.silence(params["silence"],
                                     float(params.get("ttlS", 3600)))
                    out = {"silenced": True}
                else:
                    out = watchdog.alerts_payload()
                out["node"] = self.node_name
                self._send(200, out)
            elif u.path == "/debug/incidents":
                from dgraph_tpu_torch.utils import watchdog
                out = watchdog.incidents_payload(
                    limit=int(params.get("limit", 16)),
                    bundle=params.get("id"))
                out["node"] = self.node_name
                self._send(200, out)
            else:
                self._send(404, {"errors": [
                    {"message": f"no handler for GET {u.path}"}]})
        except (ValueError, KeyError) as e:
            self._send(400, {"errors": [{"message": str(e)}]})
        except Exception as e:  # noqa: BLE001 — debug surface: report  # dglint: disable=DG07 (read-only debug listener; no request ctx flows here)
            self._send(500, {"errors": [{"message": str(e)}]})

    def do_POST(self):
        """The one control surface on this listener: the network fault
        table (chaos arming/healing with nothing but curl). Everything
        else stays read-only GET."""
        u = urlparse(self.path)
        if u.path != "/debug/fault":
            self._send(404, {"errors": [
                {"message": f"no handler for POST {u.path}"}]})
            return
        from dgraph_tpu_torch.utils import netfault
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            out = netfault.handle_control(body)
            out["node"] = self.node_name
            self._send(200, out)
        except (ValueError, KeyError, TypeError) as e:
            self._send(400, {"errors": [{"message": str(e)}]})


def serve_debug(stats_fn: Optional[Callable[[], dict]] = None,
                health_fn: Optional[Callable[[], dict]] = None,
                node_name: str = "node",
                host: str = "127.0.0.1", port: int = 0
                ) -> tuple[ThreadingHTTPServer, int]:
    """Start the debug listener in a daemon thread; returns
    (httpd, bound_port) — port 0 binds an ephemeral port, the caller
    prints/records the real one."""
    handler = type("BoundDebugHandler", (_DebugHandler,), {
        "stats_fn": staticmethod(stats_fn) if stats_fn else None,
        "health_fn": staticmethod(health_fn) if health_fn else None,
        "node_name": node_name})
    httpd = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name=f"debug-http-{node_name}")
    t.start()
    return httpd, httpd.server_address[1]
