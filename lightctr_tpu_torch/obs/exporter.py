"""HTTP ops endpoints: the pull-based scrape/health surface per process.

Everything the obs layer buffers in-process — registry snapshots, health
verdicts, the span ring, the flight recorder — becomes scrapeable over one
stdlib ``http.server`` daemon thread, attachable to trainer, ``ps_server``
and ``master`` processes alike:

    GET  /metrics    Prometheus text: default registry merged with every
                     flight-registered registry (PS shards, master)
    GET  /varz       JSON snapshot: per-registry snapshots + health
                     verdicts + trace/flight state
    GET  /healthz    aggregate verdict across every registered
                     HealthMonitor, HTTP 200 (ok/degraded) or 503
                     (unhealthy), per-detector detail in the body
    GET  /tracez     recent finished spans from the in-memory ring
                     (``?n=`` caps the count, default 100)
    POST /flightz    trigger an on-demand flight bundle; replies with the
                     bundle path

Services can add JSON routes of their own with :func:`register_json_route`
(the master's cluster rollup serves ``/stragglerz`` this way — the
straggler-attribution verdict, docs/OBSERVABILITY.md) and POST routes
with :func:`register_post_route` (the device plane's ``POST /profilez``
profiler trigger).

Arming: ``LIGHTCTR_OPS_PORT=<port>`` starts the server at obs import in
every process that inherits the variable (port ``0`` auto-assigns — the
multi-process-per-host and test case; a taken fixed port falls back to
auto-assign so the second process on a host still serves).  Programmatic:
:func:`install` / :func:`uninstall`.  ``LIGHTCTR_TELEMETRY=0`` hard-
disables the exporter along with the rest of the obs layer.

The server is deliberately an *ops* plane: localhost by default, no TLS,
no auth — bind it to a routable interface only behind your own ingress.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from lightctr_tpu_torch.obs import flight as flight_mod
from lightctr_tpu_torch.obs import gate
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.obs import trace as trace_mod
from lightctr_tpu_torch.obs.registry import (
    default_registry,
    merge_snapshots,
    render_prometheus,
)

_LOG = logging.getLogger(__name__)

#: default Prometheus metric prefix on /metrics
PROM_PREFIX = "lightctr_"


# -- pluggable JSON routes ---------------------------------------------------

_routes_lock = threading.Lock()
_json_routes: Dict[str, Callable[[], Dict]] = {}

#: paths the handler owns; a pluggable route may not shadow them
_BUILTIN_ROUTES = ("/", "/metrics", "/varz", "/healthz", "/tracez",
                   "/flightz")


def register_json_route(path: str, provider: Callable[[], Dict]) -> None:
    """Serve ``provider()`` as JSON at ``path`` on every ops server in
    this process (the cluster rollup registers ``/stragglerz``).  The
    provider runs per request; raising yields a 500 the scraper can
    see.  Re-registering a path replaces its provider."""
    path = "/" + str(path).strip("/")
    if path in _BUILTIN_ROUTES:
        raise ValueError(f"{path!r} is a built-in ops route")
    with _routes_lock:
        _json_routes[path] = provider


def unregister_json_route(path: str) -> None:
    path = "/" + str(path).strip("/")
    with _routes_lock:
        _json_routes.pop(path, None)


def json_routes() -> Dict[str, Callable[[], Dict]]:
    with _routes_lock:
        return dict(_json_routes)


# POST routes: handler(query) -> (http_status, json_body).  The device
# plane's profiler trigger mounts ``POST /profilez`` this way — same
# replace-on-reregister semantics as the GET routes.
_post_routes: Dict[str, Callable[[Dict[str, list]], Tuple[int, Dict]]] = {}


def register_post_route(
        path: str,
        handler: Callable[[Dict[str, list]], Tuple[int, Dict]]) -> None:
    """Serve ``handler(query) -> (status, body)`` for ``POST path`` on
    every ops server in this process.  ``query`` is the parsed query
    string (``parse_qs`` shape); raising yields a 500."""
    path = "/" + str(path).strip("/")
    if path in _BUILTIN_ROUTES:
        raise ValueError(f"{path!r} is a built-in ops route")
    with _routes_lock:
        _post_routes[path] = handler


def unregister_post_route(path: str) -> None:
    path = "/" + str(path).strip("/")
    with _routes_lock:
        _post_routes.pop(path, None)


def post_routes() -> Dict[str, Callable]:
    with _routes_lock:
        return dict(_post_routes)


# -- payload builders (module-level: tools/tests reuse them) -----------------


def registry_snapshots() -> Dict[str, Dict]:
    """Per-registry snapshots: the process default plus every registry a
    long-lived service registered with the flight recorder."""
    snaps = {"default": default_registry().snapshot()}
    for name, reg in flight_mod.registered_registries().items():
        try:
            snaps[name] = reg.snapshot()
        except Exception:
            continue
    return snaps


def metrics_text() -> str:
    """The /metrics body: one merged exposition (merging rather than
    concatenating keeps series and # TYPE lines unique when several
    registries in one process carry the same name)."""
    return render_prometheus(
        merge_snapshots(registry_snapshots().values()), prefix=PROM_PREFIX
    )


def health_payload() -> Tuple[int, Dict]:
    """(http_status, body) for /healthz: the worst status across every
    registered HealthMonitor; 503 only when some component is UNHEALTHY
    (degraded still serves — it is a warning, not an outage)."""
    components = flight_mod.health_verdicts()
    status = health_mod.worst(
        v.get("status", health_mod.OK) for v in components.values()
    )
    code = 503 if status == health_mod.UNHEALTHY else 200
    return code, {
        "status": status,
        "enabled": health_mod.enabled(),
        "components": components,
    }


def varz_payload() -> Dict:
    code, health = health_payload()
    del code
    return {
        "pid": os.getpid(),
        "telemetry_enabled": gate.enabled(),
        "registries": registry_snapshots(),
        "health": health,
        "trace": {
            "spans_buffered": len(trace_mod.finished()),
            "sink": trace_mod.sink_path(),
        },
        "flight": {
            "armed": flight_mod.armed(),
            "coalesced_dumps": flight_mod.coalesced_dumps(),
        },
    }


def tracez_payload(limit: int = 100) -> Dict:
    spans = trace_mod.finished()
    limit = max(0, int(limit))
    return {"buffered": len(spans),
            "spans": spans[-limit:] if limit else []}


# -- server ------------------------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server_version = "lightctr-ops/1"

    def log_message(self, fmt, *args):  # quiet: per-scrape stderr lines
        _LOG.debug("ops %s " + fmt, self.client_address[0], *args)

    def _reply(self, code: int, body: bytes,
               ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj) -> None:
        self._reply(code, json.dumps(obj, sort_keys=True,
                                     default=repr).encode())

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            url = urlsplit(self.path)
            path = url.path.rstrip("/") or "/"
            if path == "/metrics":
                self._reply(200, metrics_text().encode(),
                            ctype="text/plain; version=0.0.4")
            elif path == "/varz":
                self._reply_json(200, varz_payload())
            elif path == "/healthz":
                code, body = health_payload()
                self._reply_json(code, body)
            elif path == "/tracez":
                q = parse_qs(url.query)
                try:
                    n = int(q.get("n", ["100"])[0])
                except ValueError:
                    n = 100
                self._reply_json(200, tracez_payload(n))
            elif path == "/flightz":
                self._reply_json(405, {"error": "POST triggers a dump"})
            else:
                with _routes_lock:
                    provider = _json_routes.get(path)
                if provider is not None:
                    self._reply_json(200, provider())
                else:
                    self._reply_json(404, {"error": f"no route {path!r}"})
        except Exception:
            # the ops plane must never kill its own connection thread
            # with a traceback — degrade to a 500 the scraper can see
            _LOG.debug("ops handler failed", exc_info=True)
            try:
                self._reply_json(500, {"error": "internal"})
            except Exception:
                pass

    def do_POST(self):  # noqa: N802
        try:
            url = urlsplit(self.path)
            path = url.path.rstrip("/")
            if path == "/flightz":
                if not flight_mod.armed():
                    # an unarmed process has no bundle destination; the
                    # dump fallback would litter the cwd
                    self._reply_json(
                        409, {"error": "flight recorder not armed (set "
                                       "LIGHTCTR_FLIGHT or call "
                                       "flight.install)"})
                    return
                bundle = flight_mod.dump("ops:flightz")
                if bundle is None:
                    self._reply_json(
                        503, {"error": "dump failed or coalesced with one "
                                       "in progress"})
                else:
                    self._reply_json(200, {"bundle": bundle})
            else:
                with _routes_lock:
                    handler = _post_routes.get(path)
                if handler is not None:
                    code, body = handler(parse_qs(url.query))
                    self._reply_json(code, body)
                else:
                    self._reply_json(404, {"error": f"no route {path!r}"})
        except Exception:
            _LOG.debug("ops handler failed", exc_info=True)
            try:
                self._reply_json(500, {"error": "internal"})
            except Exception:
                pass


class OpsServer:
    """The per-process ops HTTP server (daemon threads; ``close()`` to
    stop).  ``port=0`` auto-assigns — read the bound port back from
    ``self.address``."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.address: Tuple[str, int] = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="lightctr-ops",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)


# -- module singleton / env arming -------------------------------------------

_install_lock = threading.Lock()
_server: Optional[OpsServer] = None


def install(port: int = 0, host: str = "127.0.0.1") -> OpsServer:
    """Start (or return) the process ops server.  Idempotent: a second
    call returns the running server regardless of the requested port."""
    global _server
    with _install_lock:
        if _server is None:
            _server = OpsServer(port=port, host=host)
            _LOG.info("ops endpoints serving on http://%s:%d",
                      *_server.address)
        return _server


def installed() -> Optional[OpsServer]:
    return _server


def uninstall() -> None:
    """Stop the process ops server (tests, clean shutdown)."""
    global _server
    with _install_lock:
        if _server is not None:
            _server.close()
            _server = None


def maybe_install_from_env() -> None:
    """Arm from ``LIGHTCTR_OPS_PORT`` (obs/__init__ calls this once at
    import, so every process of a launched run serves for free).  A taken
    fixed port degrades to port-0 auto-assign — on a host running several
    processes of one job, each still gets an endpoint (read the chosen
    port from the log or ``exporter.installed().address``).  Telemetry
    off (``LIGHTCTR_TELEMETRY=0``) hard-disables the exporter."""
    val = os.environ.get("LIGHTCTR_OPS_PORT")
    if not val or not gate.enabled():
        return
    try:
        port = int(val)
    except ValueError:
        _LOG.warning("LIGHTCTR_OPS_PORT=%r is not a port; exporter off",
                     val)
        return
    try:
        install(port)
    except OSError:
        try:
            srv = install(0)
            _LOG.warning(
                "ops port %d taken; serving on http://%s:%d instead",
                port, *srv.address,
            )
        except OSError:
            _LOG.warning("ops exporter failed to bind", exc_info=True)
