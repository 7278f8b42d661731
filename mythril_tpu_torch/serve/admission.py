"""Admission control for the analysis daemon: bounded per-class queues,
watermark load shedding, and per-source circuit breakers (own copy of
``mythril_tpu/serve/admission.py``).

The daemon's overload story is *bounded everywhere*:

- **Bounded queues, per class.**  Interactive and batch traffic queue
  separately (an editor ping must not sit behind a 10k-contract batch
  sweep), each behind a hard depth cap.  A full class sheds the request
  with a 503 + ``Retry-After`` — queueing unbounded work is how a
  solver daemon OOMs an hour after the spike, not during it.
- **Memory watermark.**  When resident set exceeds
  ``MYTHRIL_TPU_SERVE_RSS_MB`` the queue sheds *all* new admissions
  until RSS recedes: shedding at admission is cheap; an OOM kill throws
  away every request in flight.
- **Per-source circuit breakers.**  ``breaker_threshold`` consecutive
  request *failures* (engine crashes, not findings) from one ``source``
  open that source's breaker: its requests shed instantly for
  ``breaker_cooldown_s``, then exactly one half-open probe is admitted
  — success closes the breaker, failure re-opens it.  One caller
  repeatedly submitting a poisoned contract cannot grind the fleet.

Everything here is plain threading + the metrics registry; the engine
thread is the single consumer, HTTP handler threads are producers.
"""

import logging
import threading
import time
from collections import deque
from typing import Optional

from mythril_tpu_torch.observability.metrics import get_registry
from mythril_tpu_torch.serve.config import ServeConfig, current_rss_mb
from mythril_tpu_torch.serve.protocol import AnalyzeRequest, RequestError

log = logging.getLogger(__name__)


class Ticket:
    """One queued request: the parsed body plus the rendezvous the
    HTTP handler thread blocks on."""

    __slots__ = ("request", "enqueued_at", "done", "response", "status",
                 "abandoned")

    def __init__(self, request: AnalyzeRequest):
        self.request = request
        self.enqueued_at = time.monotonic()
        self.done = threading.Event()
        self.response: Optional[dict] = None
        self.status: int = 500
        #: set by the HTTP handler when the client hangs up — the
        #: engine skips it, the fabric revokes its lease
        self.abandoned = threading.Event()

    def resolve(self, status: int, response: dict) -> None:
        self.status = status
        self.response = response
        self.done.set()

    def queued_s(self) -> float:
        return time.monotonic() - self.enqueued_at


class CircuitBreaker:
    """Per-source consecutive-failure breaker (closed → open →
    half-open → closed)."""

    __slots__ = ("threshold", "cooldown_s", "failures", "opened_at",
                 "half_open_probe")

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.half_open_probe = False

    @property
    def state(self) -> str:
        if self.opened_at is None:
            return "closed"
        if time.monotonic() - self.opened_at >= self.cooldown_s:
            return "half-open"
        return "open"

    def allow(self) -> bool:
        """Admission-time check; a half-open breaker admits exactly one
        probe request until its outcome lands."""
        state = self.state
        if state == "closed":
            return True
        if state == "open":
            return False
        if self.half_open_probe:
            return False  # a probe is already in flight
        self.half_open_probe = True
        return True

    def retry_after_s(self) -> int:
        if self.opened_at is None:
            return 0
        return max(
            1,
            int(self.cooldown_s - (time.monotonic() - self.opened_at)) + 1,
        )

    def record_success(self) -> None:
        self.failures = 0
        self.opened_at = None
        self.half_open_probe = False

    def record_failure(self) -> None:
        self.half_open_probe = False
        if self.opened_at is not None:
            # a failed half-open probe re-opens for a fresh cooldown
            self.opened_at = time.monotonic()
            return
        self.failures += 1
        if self.threshold and self.failures >= self.threshold:
            self.opened_at = time.monotonic()


#: the one queue the registry collector reads — the LAST constructed
#: queue wins (one live server per process; tests constructing several
#: must not leave stale collectors emitting dead depths)
_active_queue = None
_collector_registry = None


def _set_active_queue(queue, registry) -> None:
    global _active_queue, _collector_registry
    _active_queue = queue
    if _collector_registry is not registry:  # survives registry resets
        registry.register_collector(_active_queue_collector)
        _collector_registry = registry


def _active_queue_collector():
    queue = _active_queue
    return iter(()) if queue is None else queue._collect()


class AdmissionQueue:
    """Bounded two-class admission queue + breaker table.  Producers
    (HTTP handler threads) call :meth:`submit`; the single engine
    thread calls :meth:`pop`."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._queues = {
            "interactive": deque(),
            "batch": deque(),
        }
        self._caps = {
            "interactive": config.queue_cap_interactive,
            "batch": config.queue_cap_batch,
        }
        self._breakers = {}
        self._closed = False
        registry = get_registry()
        self._admitted = registry.counter(
            "mythril_tpu_serve_admitted_total",
            "requests admitted to the analysis queue",
        )
        self._m_cache_hits = registry.counter(
            "mythril_tpu_serve_cache_hits",
            "requests answered from the admission-edge report cache",
        )
        self._shed = {
            reason: registry.counter(
                f"mythril_tpu_serve_shed_{reason}_total",
                f"admissions shed: {help_}",
            )
            for reason, help_ in (
                ("queue_full", "class queue at its depth cap"),
                ("overloaded_rss", "resident set above the watermark"),
                ("breaker_open", "per-source circuit breaker open"),
                ("draining", "server draining for shutdown"),
                ("tenant_quota", "per-source analysis-seconds quota "
                                 "exhausted"),
            )
        }
        #: fair-share state: requests served per source (halved on
        #: overflow so ancient history cannot starve a new tenant)
        self._served = {}
        #: rolling per-source analysis-seconds: source -> deque of
        #: (monotonic time, cost_s) inside the quota window
        self._usage = {}
        _set_active_queue(self, registry)

    # -- metrics --------------------------------------------------------

    def _collect(self):
        with self._lock:
            depths = {c: len(q) for c, q in self._queues.items()}
            open_breakers = sum(
                1 for b in self._breakers.values() if b.state != "closed"
            )
        for cls, depth in sorted(depths.items()):
            yield ("gauge", f"mythril_tpu_serve_queue_depth_{cls}",
                   "queued requests in this admission class", depth)
        yield ("gauge", "mythril_tpu_serve_breakers_open",
               "sources whose circuit breaker is open or half-open",
               open_breakers)

    # -- producer side --------------------------------------------------

    def _shed_error(self, reason: str, message: str,
                    retry_after: Optional[int] = None,
                    status: int = 503) -> RequestError:
        self._shed[reason].inc()
        return RequestError(
            reason, message, status=status,
            retry_after_s=(
                self.config.retry_after_s
                if retry_after is None else retry_after
            ),
        )

    #: rolling window the tenant quota is metered over
    QUOTA_WINDOW_S = 60.0

    def note_usage(self, source: str, cost_s: float) -> None:
        """Engine-side: charge ``cost_s`` analysis-seconds to a tenant
        (fed by the ledger-backed per-request wall accounting)."""
        if not self.config.tenant_quota_s:
            return
        with self._lock:
            window = self._usage.setdefault(source, deque())
            window.append((time.monotonic(), float(cost_s)))

    def _tenant_spent_s(self, source: str) -> float:
        """Seconds this source consumed inside the rolling window
        (caller holds the lock)."""
        window = self._usage.get(source)
        if not window:
            return 0.0
        horizon = time.monotonic() - self.QUOTA_WINDOW_S
        while window and window[0][0] < horizon:
            window.popleft()
        return sum(cost for _t, cost in window)

    def tenant_usage(self) -> dict:
        """Per-source window consumption for ``/debug/fleet``."""
        with self._lock:
            return {
                source: round(self._tenant_spent_s(source), 3)
                for source in list(self._usage)
            }

    def cached_response(self, request: AnalyzeRequest):
        """Admission-edge report cache: the stored response body for an
        EXACT prior submission (same bytecode digest, tx_count,
        max_depth, module set, tool version), or None.  A hit is
        re-stamped so a consumer can tell it apart from a fresh
        analysis; the stored verdict itself is untouched.  Always None
        when the persist plane is inert, while draining (a draining
        server answers nothing), or on any cache-layer error — the
        cache can only ever short-circuit, never shed or corrupt."""
        if self._closed:
            return None
        try:
            from mythril_tpu_torch.persist.plane import (
                code_digest, get_knowledge_plane,
            )

            plane = get_knowledge_plane()
            if not plane.active:
                return None
            body = plane.report_cache_get(
                code_digest(request.code), request.tx_count,
                request.max_depth, request.modules,
            )
        except Exception:  # noqa: BLE001 — the cache never 500s a request
            log.debug("persist: report cache lookup failed",
                      exc_info=True)
            return None
        if body is None:
            return None
        body = dict(body)
        body["cached"] = True
        body["analysis_s"] = 0.0
        # a cache hit is still a served request: echo the caller's
        # trace_id (or mint one) so dedup is attributable in traces —
        # stored bodies predate the engine's trace stamp, so this is
        # set unconditionally, never inherited from the stored row
        from mythril_tpu_torch.observability import new_trace_id

        body["trace_id"] = request.trace_id or new_trace_id()
        self._m_cache_hits.inc()
        return body

    def submit(self, request: AnalyzeRequest) -> Ticket:
        """Admit or shed.  Raises :class:`RequestError` (503 + a
        Retry-After the handler turns into the header) on any shed."""
        with self._lock:
            if self._closed:
                raise self._shed_error(
                    "draining", "server is draining for shutdown"
                )
            breaker = self._breakers.get(request.source)
            if breaker is not None and not breaker.allow():
                raise self._shed_error(
                    "breaker_open",
                    f"circuit breaker open for source "
                    f"{request.source!r} (consecutive failures)",
                    retry_after=breaker.retry_after_s(),
                )
            quota = self.config.tenant_quota_s
            if quota and self._tenant_spent_s(request.source) >= quota:
                raise self._shed_error(
                    "tenant_quota",
                    f"source {request.source!r} spent its "
                    f"{quota:g} analysis-seconds for this "
                    f"{self.QUOTA_WINDOW_S:.0f}s window",
                    status=429,
                    retry_after=int(self.QUOTA_WINDOW_S),
                )
            watermark = self.config.rss_watermark_mb
            if watermark and current_rss_mb() > watermark:
                raise self._shed_error(
                    "overloaded_rss",
                    f"resident set above MYTHRIL_TPU_SERVE_RSS_MB "
                    f"({watermark} MiB); retry later",
                )
            queue = self._queues[request.priority]
            if len(queue) >= self._caps[request.priority]:
                raise self._shed_error(
                    "queue_full",
                    f"{request.priority} queue at its depth cap "
                    f"({self._caps[request.priority]})",
                )
            ticket = Ticket(request)
            queue.append(ticket)
            self._admitted.inc()
            self._ready.notify()
            return ticket

    # -- breaker outcome (engine side) ----------------------------------

    def record_outcome(self, source: str, ok: bool) -> None:
        if not self.config.breaker_threshold:
            return
        with self._lock:
            breaker = self._breakers.get(source)
            if breaker is None:
                if ok:
                    return
                breaker = self._breakers[source] = CircuitBreaker(
                    self.config.breaker_threshold,
                    self.config.breaker_cooldown_s,
                )
            if ok:
                breaker.record_success()
            else:
                breaker.record_failure()

    def breaker_states(self) -> dict:
        with self._lock:
            return {
                source: breaker.state
                for source, breaker in self._breakers.items()
            }

    # -- consumer side --------------------------------------------------

    def _pop_fair(self, queue: deque) -> Ticket:
        """Pop the oldest ticket of the least-served source (caller
        holds the lock).  With one source queued this is exactly FIFO;
        with several, a burst tenant cannot starve the others — the
        per-tenant fair share the fabric's admission edge promises."""
        first_source = queue[0].request.source
        if all(t.request.source == first_source for t in queue):
            ticket = queue.popleft()
        else:
            best_index, best_key = 0, None
            for index, candidate in enumerate(queue):
                key = (self._served.get(candidate.request.source, 0),
                       index)
                if best_key is None or key < best_key:
                    best_index, best_key = index, key
            ticket = queue[best_index]
            del queue[best_index]
        source = ticket.request.source
        self._served[source] = self._served.get(source, 0) + 1
        if self._served[source] > (1 << 20):
            self._served = {
                s: count // 2 for s, count in self._served.items()
            }
        return ticket

    def pop(self, timeout: Optional[float] = None) -> Optional[Ticket]:
        """Next ticket, interactive class first, fair-shared across
        sources within a class; None on timeout or when the queue is
        closed and empty."""
        with self._ready:
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
            while True:
                for cls in ("interactive", "batch"):
                    if self._queues[cls]:
                        return self._pop_fair(self._queues[cls])
                if self._closed:
                    return None
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return None
                self._ready.wait(remaining)

    def close(self) -> list:
        """Stop admitting (readiness goes false), return every still-
        queued ticket so the server can fail them with 503/draining."""
        with self._lock:
            self._closed = True
            pending = []
            for queue in self._queues.values():
                pending.extend(queue)
                queue.clear()
            self._ready.notify_all()
            return pending

    @property
    def closed(self) -> bool:
        return self._closed

    def depths(self) -> dict:
        with self._lock:
            return {c: len(q) for c, q in self._queues.items()}
