"""The HTTP surface of the analysis daemon (stdlib-only; own copy of
``mythril_tpu/serve/http.py``).

Endpoints::

    POST /analyze    submit one contract (serve/protocol.py body);
                     blocks until the engine answers, 503+Retry-After
                     on any shed (queue full, RSS watermark, breaker
                     open, draining), structured 4xx on malformed input
    GET  /healthz    liveness: 200 while the process is up
    GET  /readyz     readiness: 200 only while admitting AND the engine
                     thread is alive; body carries mode
                     ("device" | "cpu"), queue depths, breaker states —
                     a lost card stops the engine, so readiness fails
                     (the port's divergence: the JAX server degrades to
                     its host CDCL and stays ready)
    GET  /metrics    the unified metrics registry, live, in Prometheus
                     text format (the same registry ``--metrics-out``
                     dumps at CLI exit)
    GET  /debug/requests
                     live introspection: the in-flight request (phase,
                     deadline budget remaining, lane counts by tier)
                     plus a bounded history of finished requests —
                     what ``myth top`` polls
    GET  /debug/lanes
                     the lane-attribution ledger's aggregates (tier
                     decisions, transitions, per-contract and
                     per-request splits; observability/ledger.py)
    GET  /debug/autopilot
                     the autopilot's live state: policy, routing
                     counters, cost-model signature buckets, tuner
                     EWMAs/overrides (mythril_tpu_torch/autopilot; what the
                     ``myth top`` autopilot panel renders)
    GET  /debug/fleet
                     the serving fabric: coordinator seat/lease table
                     (serve/fabric.py) plus per-tenant rolling quota
                     consumption — null fabric when --fleet-listen is
                     not configured
    GET  /debug/watch
                     live-chain ingestion status: the in-process
                     watcher (or the last snapshot a `myth watch
                     --serve` tenant POSTed here) plus the serve-side
                     dedup attribution (report-cache hits, the watch
                     tenant's quota spend) — what the `myth top` watch
                     panel renders

Shutdown: SIGTERM/SIGINT ride the resilience plane's cooperative drain
(``install_signal_handlers``).  The serve loop notices, closes
admission (readyz flips 503, new POSTs shed with ``draining``), lets
the in-flight request finish — an expired-budget drain bounds how long
that takes — fails every still-queued ticket, flushes the
``--trace-out`` / ``--metrics-out`` artifacts, and exits 0.  A second
signal force-exits, as in the CLI.  An engine that stopped because the
card was lost takes the same drain, and the server exits 1.
"""

import json
import logging
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mythril_tpu_torch.serve.admission import AdmissionQueue
from mythril_tpu_torch.serve.config import ServeConfig, current_rss_mb
from mythril_tpu_torch.serve.engine import AnalysisEngine
from mythril_tpu_torch.serve.protocol import RequestError, parse_analyze_request

log = logging.getLogger(__name__)

#: extra seconds a handler waits on the engine past the request budget
#: before answering 504 (the engine is wedged — which the watchdog
#: ladder should already be escalating)
_RESPONSE_MARGIN_S = 60.0


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "mythril-tpu-serve"

    # -- plumbing -------------------------------------------------------

    def log_message(self, format, *args):  # noqa: A002 — stdlib name
        log.debug("http: %s", format % args)

    def _send_json(self, status: int, body: dict,
                   retry_after=None) -> None:
        payload = json.dumps(body).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        if retry_after is not None:
            self.send_header("Retry-After", str(int(retry_after)))
        self.end_headers()
        self.wfile.write(payload)

    def _send_error_obj(self, exc: RequestError) -> None:
        self._send_json(
            exc.status, exc.payload(),
            retry_after=exc.extra.get("retry_after_s"),
        )

    @property
    def _srv(self) -> "AnalysisServer":
        return self.server.analysis_server

    # -- GET ------------------------------------------------------------

    def do_GET(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            self._send_json(200, self._srv.health_body())
        elif path == "/readyz":
            ready, body = self._srv.ready_body()
            self._send_json(
                200 if ready else 503, body,
                retry_after=None if ready
                else self._srv.config.retry_after_s,
            )
        elif path == "/metrics":
            from mythril_tpu_torch.observability.metrics import get_registry

            payload = get_registry().render().encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4"
            )
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        elif path == "/debug/requests":
            self._send_json(200, self._srv.engine.debug_requests())
        elif path == "/debug/lanes":
            from mythril_tpu_torch.observability.ledger import get_ledger

            self._send_json(200, get_ledger().snapshot())
        elif path == "/debug/autopilot":
            from mythril_tpu_torch.autopilot import get_autopilot

            self._send_json(200, get_autopilot().debug_state())
        elif path == "/debug/fleet":
            router = self._srv.router
            self._send_json(200, {
                "fabric": (router.debug_status()
                           if router is not None else None),
                "tenants": self._srv.queue.tenant_usage(),
                "tenant_quota_s": self._srv.config.tenant_quota_s,
            })
        elif path == "/debug/watch":
            self._send_json(200, self._srv.watch_body())
        else:
            self._send_json(404, {"error": {
                "code": "not_found", "message": f"no route {path!r}",
            }})

    # -- POST -----------------------------------------------------------

    def do_POST(self) -> None:
        path = self.path.split("?", 1)[0]
        if path == "/debug/watch":
            # a `myth watch --serve URL` tenant pushes its status
            # snapshot here so the daemon's debug surface (and the
            # `myth top` watch panel) can show the follower's state
            try:
                body = json.loads(self._read_body().decode("utf-8"))
                if not isinstance(body, dict):
                    raise ValueError("snapshot must be a JSON object")
            except (RequestError, ValueError,
                    UnicodeDecodeError) as exc:
                self._send_json(400, {"error": {
                    "code": "bad_snapshot", "message": str(exc),
                }})
                return
            self._srv.watch_snapshot = body
            self._send_json(200, {"ok": True})
            return
        if path != "/analyze":
            self._send_json(404, {"error": {
                "code": "not_found",
                "message": f"no route {self.path!r}",
            }})
            return
        try:
            raw = self._read_body()
            request = parse_analyze_request(raw, self._srv.config)
            # admission-edge report cache (persist/plane.py): an exact
            # re-submission of a finished analysis answers here, before
            # the queue ever sees it — no analysis, no queue slot, no
            # tenant quota spend.  Inert without a persist store.
            cached = self._srv.queue.cached_response(request)
            if cached is not None:
                self._send_json(200, cached)
                return
            ticket = self._srv.queue.submit(request)
        except RequestError as exc:
            self._send_error_obj(exc)
            return
        deadline_s = (
            request.deadline_s or self._srv.config.default_deadline_s
        )
        deadline = time.monotonic() + deadline_s + _RESPONSE_MARGIN_S
        # wait in slices so a client hangup is noticed while the
        # request is queued or executing: the engine skips an
        # abandoned ticket, the fabric revokes its lease
        while not ticket.done.wait(1.0):
            if time.monotonic() >= deadline:
                self._send_json(504, {"error": {
                    "code": "engine_timeout",
                    "message": "the analysis engine did not answer "
                               "within the budget plus margin",
                }})
                return
            if self._client_gone():
                ticket.abandoned.set()
                self.close_connection = True
                return
        self._send_json(ticket.status, ticket.response)

    def _client_gone(self) -> bool:
        """True when the client closed its end: a readable socket
        whose peek returns EOF.  Pipelined bytes (readable, non-empty
        peek) mean the client is very much alive."""
        try:
            readable, _w, _x = select.select(
                [self.connection], [], [], 0
            )
            if not readable:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    def _read_body(self) -> bytes:
        length = self.headers.get("Content-Length")
        if length is None:
            raise RequestError(
                "length_required", "Content-Length is required",
                status=411,
            )
        try:
            length = int(length)
        except ValueError as exc:
            raise RequestError(
                "bad_length", "Content-Length is not an integer"
            ) from exc
        max_body = self._srv.config.max_body_bytes
        if length > max_body:
            # reject from the header alone — never buffer an oversized
            # body just to refuse it
            raise RequestError(
                "body_too_large",
                f"request body exceeds MYTHRIL_TPU_SERVE_MAX_BODY "
                f"({max_body} bytes)",
                status=413, limit_bytes=max_body,
            )
        return self.rfile.read(length)


class AnalysisServer:
    """One daemon: admission queue + engine thread + HTTP listener."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self.queue = AdmissionQueue(config)
        self.engine = AnalysisEngine(self.queue, config)
        self.router = None
        if config.fleet_listen is not None:
            from mythril_tpu_torch.parallel.fleet import _killed

            if _killed():
                # MYTHRIL_TPU_FLEET=0 is the whole-fabric kill switch:
                # exactly the single-process serve path, no listener
                log.warning("serve fabric disabled by "
                            "MYTHRIL_TPU_FLEET=0; running in-process")
            else:
                from mythril_tpu_torch.serve.fabric import FleetRouter

                self.router = FleetRouter(config)
                self.engine.router = self.router
        #: latest status snapshot a `myth watch --serve` tenant pushed
        #: (POST /debug/watch); an in-process watcher wins over it
        self.watch_snapshot = None
        self.started_at = time.time()
        self._httpd = ThreadingHTTPServer(
            (config.host, config.port), _Handler
        )
        self._httpd.daemon_threads = True
        self._httpd.analysis_server = self
        self.port = self._httpd.server_address[1]  # resolved (port 0)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mythril-serve-http", daemon=True,
        )

    # -- status bodies --------------------------------------------------

    def health_body(self) -> dict:
        return {
            "ok": True,
            "uptime_s": round(time.time() - self.started_at, 1),
            "rss_mb": round(current_rss_mb(), 1),
            "requests_done": self.engine.requests_done,
        }

    def ready_body(self):
        draining = self.queue.closed
        engine_ok = self.engine.alive
        ready = engine_ok and not draining
        body = {
            "ready": ready,
            "draining": draining,
            "engine_alive": engine_ok,
            # a lost card stops the engine: not ready, and it stays so
            "degraded": self.engine.degraded(),
            "mode": self.engine.mode(),
            "queue_depths": self.queue.depths(),
            "breakers": self.queue.breaker_states(),
            "in_flight": self.engine.in_flight,
            "requests": {
                "done": self.engine.requests_done,
                "failed": self.engine.requests_failed,
                "partial": self.engine.requests_partial,
            },
            "fabric": (self.router.summary()
                       if self.router is not None else None),
        }
        return ready, body

    def watch_body(self) -> dict:
        """The ``/debug/watch`` body: the live in-process watcher when
        one runs here, else the last snapshot a ``--serve`` watch
        tenant pushed, else inactive — plus the serve-side dedup
        attribution (report-cache hits, the watch tenant's rolling
        quota spend)."""
        from mythril_tpu_torch.watch import debug_status

        watch = debug_status()
        if not watch.get("active") and self.watch_snapshot is not None:
            watch = self.watch_snapshot
        return {
            "watch": watch,
            "serve_cache_hits": self.queue._m_cache_hits.value,
            "watch_tenant_spent_s": self.queue.tenant_usage().get(
                "watch", 0.0
            ),
        }

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self.router is not None:
            self.router.start()
        self.engine.start()
        self._http_thread.start()
        log.info(
            "myth serve: listening on %s:%d (interactive queue %d, "
            "batch queue %d, default deadline %.0fs)",
            self.config.host, self.port,
            self.config.queue_cap_interactive,
            self.config.queue_cap_batch,
            self.config.default_deadline_s,
        )

    def drain_and_stop(self, reason: str = "shutdown") -> None:
        """Graceful shutdown: close admission, fail queued tickets,
        wait for the in-flight request, flush artifacts, stop HTTP."""
        log.info("myth serve: draining (%s)", reason)
        pending = self.queue.close()
        for ticket in pending:
            ticket.resolve(503, {"error": {
                "code": "draining",
                "message": "server is draining for shutdown",
            }})
        self.engine.join(timeout=self.config.max_deadline_s)
        if self.router is not None:
            self.router.shutdown()
        # the coalescer leaves cross-request mode with the engine
        from mythril_tpu_torch.ops.coalesce import (
            set_request_scope, set_serve_mode,
        )

        set_serve_mode(False)
        set_request_scope(None)
        # drain boundary: everything the daemon learned becomes durable
        # before the process goes away (no-op without a persist store)
        from mythril_tpu_torch.persist.plane import get_knowledge_plane

        get_knowledge_plane().flush()
        from mythril_tpu_torch.observability import finalize_outputs

        finalize_outputs()
        self._httpd.shutdown()
        self._httpd.server_close()

    def serve_until_drained(self) -> int:
        """Foreground loop for ``serve``: run until the resilience
        plane's drain flag fires (SIGTERM/SIGINT), or the engine stops,
        then shut down gracefully.  Returns the exit code: 0 after a
        drain, 1 when the engine stopped (a lost card)."""
        from mythril_tpu_torch.resilience.checkpoint import _drain_event

        self.start()
        try:
            while not _drain_event.wait(0.2):
                if not self.engine.alive:
                    log.error("engine thread stopped (%s); shutting down",
                              self.engine.device_lost)
                    break
        finally:
            self.drain_and_stop(
                "signal" if _drain_event.is_set() else "engine-dead"
            )
        return 0 if self.engine.device_lost is None else 1


def run_server(host: str, port: int, fleet_listen=None,
               secret_file=None, device=None) -> int:
    """CLI entry (``serve``): validate the config, resolve the device
    (``RuntimeError`` without a card, before anything is bound), start,
    block until drained.  Returns the process exit code."""
    from mythril_tpu_torch.ops import default_device
    from mythril_tpu_torch.resilience.checkpoint import install_signal_handlers

    config = ServeConfig.from_env(host=host, port=port,
                                  fleet_listen=fleet_listen,
                                  secret_file=secret_file, device=device)
    default_device(config.device)
    install_signal_handlers()
    server = AnalysisServer(config)
    return server.serve_until_drained()
