"""The analysis engine: one worker thread that executes admitted
requests serially against the warm, device-resident solver state (own
copy of ``mythril_tpu/serve/engine.py``).

Serial on purpose — device dispatch is a single stream, and the entire
amortization story of the daemon (built kernels, resident clause pool,
cone memo, warm-start models, solver memo channels) lives on ONE blast
context that requests share.  The device is fixed per server
(``ServeConfig.device``, ``--device`` at start): the engine thread makes
it current and builds every kernel library before the first request,
so no build runs on an HTTP thread or against a request's budget.  What is per-request is everything
that must not leak between callers:

- **Telemetry scope** — dispatch/resilience counters, solver
  statistics, and detection-module state reset per request, so each
  response's ``meta.resilience`` block describes *that* request (the
  same per-contract contract the CLI and bench rows keep).  Registry
  counters prefixed ``mythril_tpu_serve_*`` carry the server-lifetime
  totals instead.
- **Deadline budget** — the request's wall-clock budget is installed in
  ``resilience/budget.py`` before execution and cleared after; an
  expiring budget drains the analysis at a transaction boundary through
  the same cooperative checkpoints a SIGTERM walks, and the response
  ships ``partial: true`` with whatever the boundary held.
- **Failure scope** — an unhandled executor crash (or an injected
  ``serve_crash``) fails *that request* with a flight-recorder dump
  attached to the error body, records a breaker failure for the
  request's source, and decontaminates the shared state: blast context
  dropped, resident device pools reset, model cache cleared, coalescer
  queue purged.  The next request starts from a cold-but-consistent
  pool; the process never dies.
- **A lost card ends the server** — the port's divergence from the JAX
  package, whose engine flips to a degraded host-CDCL mode and goes on
  serving.  The port has no demotion state: a
  ``ops/device_health.DeviceLost``, a ``torch.cuda`` error, or a
  kernel's build or launch error (:func:`device_fatal`) answers the
  request in flight with 503 (code ``device_lost``, or the error's
  type), stops the engine thread (``/readyz`` answers 503), and
  ``run_server`` drains the queue and returns 1.  Nothing carries on
  without the card.  ``mode`` is ``"device"`` on the card and ``"cpu"``
  for a server started with ``--device cpu``.
"""

import collections
import importlib
import logging
import math
import threading
import time
import uuid
from typing import Optional

import torch

from mythril_tpu_torch.observability.metrics import get_registry
from mythril_tpu_torch.serve.admission import AdmissionQueue, Ticket
from mythril_tpu_torch.serve.config import ServeConfig

log = logging.getLogger(__name__)

#: margin added to the laser execution timeout over the budget: the
#: budget (drain semantics, partial report) must always govern; the
#: laser's own timeout is only the backstop behind it
_EXEC_TIMEOUT_MARGIN_S = 30.0

#: the kernel libraries of the analysis (``ops/``), built by the engine
#: thread before it takes a request
KERNEL_MODULES = ("dense_sweep", "dpll_step", "frontier_kernels",
                  "round_lane", "word_fixpoint", "lockstep", "keccak")

#: what the port's kernel wrappers put in the message of a build or
#: launch error (``ops/dense_sweep.build_cuda_library``, each wrapper's
#: ``... kernel launch failed: cudaError N``) and torch's CUDA errors
_DEVICE_ERROR_MARKS = ("nvcc", "kernel launch failed", "cudaError",
                       "CUDA error")


def device_fatal(exc: BaseException) -> Optional[str]:
    """The error code of an exception that ends the server (a lost
    card, a ``torch.cuda`` error, a kernel's build or launch error,
    anywhere on its cause chain), or None for one that fails its request
    alone."""
    from mythril_tpu_torch.ops.device_health import DeviceLost
    from mythril_tpu_torch.ops.keccak import KeccakKernelError

    cuda_errors = tuple(
        cls for cls in (getattr(torch.cuda, "CudaError", None),
                        getattr(torch.cuda, "OutOfMemoryError", None),
                        getattr(torch, "AcceleratorError", None))
        if isinstance(cls, type)
    )
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, DeviceLost):
            return "device_lost"
        if isinstance(exc, (KeccakKernelError, *cuda_errors)) or (
            isinstance(exc, RuntimeError)
            and any(mark in str(exc) for mark in _DEVICE_ERROR_MARKS)
        ):
            return type(exc).__name__
        exc = exc.__cause__ or exc.__context__
    return None


class AnalysisEngine:
    """Single-consumer analysis worker over an :class:`AdmissionQueue`."""

    def __init__(self, queue: AdmissionQueue, config: ServeConfig):
        self.queue = queue
        self.config = config
        #: serving-fabric router (serve/fabric.py), attached by the
        #: server when --fleet-listen is configured; None = every
        #: request runs in-process
        self.router = None
        self.requests_done = 0
        self.requests_failed = 0
        self.requests_partial = 0
        self.in_flight = None  # request id while executing
        # live introspection (/debug/requests): the in-flight request's
        # descriptor and a bounded history of recently finished ones
        self.in_flight_info = None
        self.recent_requests = collections.deque(maxlen=16)
        self.started_at = time.time()
        #: the error that ended the engine (a lost card), else None
        self.device_lost: Optional[BaseException] = None
        #: set by the engine thread once its device is ready (or failed)
        self._prepared = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="mythril-serve-engine", daemon=True
        )
        registry = get_registry()
        self._m_total = registry.counter(
            "mythril_tpu_serve_requests_total",
            "requests executed (all outcomes)",
        )
        self._m_failed = registry.counter(
            "mythril_tpu_serve_failures_total",
            "requests failed by an executor crash",
        )
        self._m_partial = registry.counter(
            "mythril_tpu_serve_partial_total",
            "requests answered with a partial (deadline-drained) report",
        )
        self._m_expired_queue = registry.counter(
            "mythril_tpu_serve_expired_in_queue_total",
            "requests whose budget expired before execution started",
        )
        self._m_latency = registry.histogram(
            "mythril_tpu_serve_request_seconds",
            "end-to-end request latency (admission to response)",
        )

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        """Configure the process, start the engine thread and wait until
        it has made its device current and built the kernels (or failed
        to: the thread then ends, and so does the server)."""
        self._configure_process()
        self._thread.start()
        self._prepared.wait()

    def join(self, timeout=None) -> None:
        self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def _configure_process(self) -> None:
        """Server-mode defaults on the args bus: the server's device, no
        per-request checkpoint journaling (the daemon's durability is
        the queue, not a journal), coalescer in cross-request mode."""
        from mythril_tpu_torch.ops.coalesce import set_serve_mode
        from mythril_tpu_torch.support.support_args import args

        args.device = self.config.device
        args.checkpoint_dir = None
        args.resume_from = None
        set_serve_mode(True)
        # the knowledge store loads ONCE at engine start (not lazily on
        # the first request), so the first request already warm-starts
        # and a corrupt store is quarantined before traffic arrives
        from mythril_tpu_torch.persist.plane import get_knowledge_plane

        plane = get_knowledge_plane()
        if plane.active:
            plane.store  # open + load + register the atexit flush

    def debug_requests(self) -> dict:
        """The ``/debug/requests`` body: the in-flight request (phase =
        the engine thread's innermost open span, deadline budget
        remaining, per-tier lane counts so far) plus a bounded history
        of finished ones.  Read from HTTP handler threads — everything
        here is an advisory snapshot, nothing locks the engine."""
        from mythril_tpu_torch.observability import get_tracer
        from mythril_tpu_torch.observability.ledger import get_ledger
        from mythril_tpu_torch.resilience.budget import current_budget

        in_flight = None
        info = self.in_flight_info
        if info is not None:
            budget = current_budget()
            in_flight = dict(info)
            elapsed = time.monotonic() - in_flight.pop(
                "started_monotonic"
            )
            in_flight["elapsed_s"] = round(elapsed, 3)
            in_flight["budget_remaining_s"] = (
                round(budget.remaining_s(), 3) if budget else None
            )
            phase = None
            tid = self._thread.ident
            if tid is not None:
                phase = get_tracer().live_spans().get(tid)
            in_flight["phase"] = phase
            in_flight["lanes_by_tier"] = get_ledger().scope_snapshot(
                info["request_id"]
            )
        return {
            "in_flight": in_flight,
            "recent": list(self.recent_requests),
            "requests": {
                "done": self.requests_done,
                "failed": self.requests_failed,
                "partial": self.requests_partial,
            },
            "queue_depths": self.queue.depths(),
        }

    def degraded(self) -> bool:
        """True when the card was lost (the engine has stopped)."""
        return self.device_lost is not None

    def mode(self) -> str:
        return "cpu" if torch.device(self.config.device).type == "cpu" \
            else "device"

    def _prepare_device(self) -> None:
        """On the engine thread: make the server's card current and
        build and load every kernel library (a no-op on the CPU)."""
        from mythril_tpu_torch.ops import default_device

        device = default_device(self.config.device)
        if device.type != "cuda":
            return
        torch.cuda.set_device(0 if device.index is None else device.index)
        for name in KERNEL_MODULES:
            importlib.import_module(
                f"mythril_tpu_torch.ops.{name}").load_library()

    # -- the loop -------------------------------------------------------

    def _run(self) -> None:
        from mythril_tpu_torch.resilience.checkpoint import _drain_event

        try:
            self._prepare_device()
        except Exception as exc:  # noqa: BLE001 — no card, no server
            log.error("engine: the device is not usable: %s", exc,
                      exc_info=True)
            self.device_lost = exc
            return
        finally:
            self._prepared.set()
        while True:
            if _drain_event.is_set():
                # process drain (SIGTERM): stop executing; the server
                # fails queued tickets and flushes artifacts
                break
            ticket = self.queue.pop(timeout=0.25)
            if ticket is None:
                if self.queue.closed:
                    break
                continue
            try:
                self._execute(ticket)
            except Exception:  # noqa: BLE001 — the engine never dies
                log.exception("engine: ticket fell through all handlers")
                ticket.resolve(500, {
                    "error": {
                        "code": "internal",
                        "message": "request handling failed",
                    }
                })
            if self.device_lost is not None:
                # the card is gone: the engine ends, readiness goes
                # false, and the server drains what waits
                log.error("engine: stopping, the device was lost (%s)",
                          self.device_lost)
                break

    # -- per-request execution -----------------------------------------

    def _execute(self, ticket: Ticket) -> None:
        request = ticket.request
        if ticket.abandoned.is_set():
            # the client hung up while this sat in the queue: spending
            # engine (or fabric seat) time on it starves live callers
            ticket.resolve(499, {"error": {
                "code": "client_gone",
                "message": "client disconnected while queued",
            }})
            return
        rid = uuid.uuid4().hex[:12]
        deadline_s = request.deadline_s or self.config.default_deadline_s
        budget_s = deadline_s - ticket.queued_s()
        self._m_total.inc()
        if budget_s <= 0:
            # the budget drained away in the queue: answering with an
            # empty "partial" analysis would waste engine time the
            # requests behind this one were promised
            self._m_expired_queue.inc()
            ticket.resolve(504, {
                "error": {
                    "code": "expired_in_queue",
                    "message": "request deadline expired while queued",
                    "queued_s": round(ticket.queued_s(), 3),
                }
            })
            return

        trace_id = request.trace_id
        if trace_id is None:
            from mythril_tpu_torch.observability import new_trace_id

            trace_id = new_trace_id()
        self.in_flight = rid
        self.in_flight_info = {
            "request_id": rid,
            "trace_id": trace_id,
            "contract": request.name,
            "source": request.source,
            "priority": request.priority,
            "budget_s": round(budget_s, 3),
            "started_monotonic": time.monotonic(),
        }
        began = time.monotonic()
        try:
            status, body = self._analyze(ticket, rid, trace_id,
                                         budget_s)
        finally:
            self.in_flight = None
            self.in_flight_info = None
        elapsed = time.monotonic() - began
        self._m_latency.observe(ticket.queued_s())
        self.requests_done += 1
        ok = status < 500
        self.queue.record_outcome(request.source, ok)
        # charge the tenant's rolling quota window with the wall time
        # this request actually consumed (in-process or fabric seat)
        self.queue.note_usage(request.source, elapsed)
        if not ok:
            self.requests_failed += 1
            self._m_failed.inc()
        if isinstance(body, dict):
            body.setdefault("request_id", rid)
            body.setdefault("trace_id", trace_id)
            body.setdefault("analysis_s", round(elapsed, 3))
        self.recent_requests.appendleft({
            "request_id": rid,
            "trace_id": trace_id,
            "contract": request.name,
            "source": request.source,
            "status": status,
            "partial": bool(
                isinstance(body, dict) and body.get("partial")
            ),
            "analysis_s": round(elapsed, 3),
        })
        ticket.resolve(status, body)

    def _analyze(self, ticket: Ticket, rid: str, trace_id: str,
                 budget_s: float):
        """Run one analysis inside the full isolation scope; returns
        (status, body) and never raises."""
        from mythril_tpu_torch.observability import set_trace_id, spans as obs
        from mythril_tpu_torch.resilience import budget as request_budget

        request = ticket.request
        try:
            # the request's trace identity governs everything this
            # execution produces: the span tree, the lane-ledger scope,
            # the coalescer stamps, and — through the fleet payload —
            # any worker processes it spawns
            set_trace_id(trace_id)
            with obs.span("serve.request", cat="serve", rid=rid,
                          trace_id=trace_id,
                          source=request.source, contract=request.name,
                          priority=request.priority):
                self._reset_request_scope(rid, trace_id)
                request_budget.install_budget(
                    budget_s, label=f"{request.source}/{rid}"
                )
                # resource governor rides the same per-request scope as
                # the wall-clock budget: a state-explosion request
                # degrades to a partial verdict instead of taking the
                # serving process (the serve path bypasses
                # MythrilAnalyzer, so it arms its own)
                from mythril_tpu_torch.resilience.governor import (
                    clear_governor, install_governor,
                )

                install_governor(label=f"{request.source}/{rid}")
                try:
                    if self.router is not None:
                        # fabric first: a connected seat answers the
                        # request off-box; None walks the degradation
                        # ladder down to in-process execution
                        routed = self.router.execute(
                            ticket, request, rid, trace_id, budget_s
                        )
                        if routed is not None:
                            status, body = routed
                            if isinstance(body, dict) and body.get(
                                "partial"
                            ):
                                self.requests_partial += 1
                                self._m_partial.inc()
                            return status, body
                    return 200, self._fire(request, rid, budget_s)
                finally:
                    clear_governor()
                    request_budget.clear_budget()
        except Exception as exc:  # noqa: BLE001 — isolate the request
            code = device_fatal(exc)
            if code is not None:
                return 503, self._lose_device(rid, exc, code)
            return 500, self._fail_request(rid, request, exc)

    def _reset_request_scope(self, rid: str,
                             trace_id: str = None) -> None:
        """Per-request state: telemetry scopes and detection modules
        reset; the WARM solver state (blast context, resident pool,
        memo channels, model cache) deliberately survives — that
        amortization is the daemon's reason to exist.
        ``MYTHRIL_TPU_SERVE_COLD=1`` resets it too (parity debugging)."""
        from mythril_tpu_torch.analysis.module.loader import ModuleLoader
        from mythril_tpu_torch.ops.async_dispatch import reset_async_dispatch
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats
        from mythril_tpu_torch.ops.coalesce import set_request_scope
        from mythril_tpu_torch.resilience.checkpoint import get_checkpoint_plane
        from mythril_tpu_torch.smt.solver import SolverStatistics

        if self.config.cold_per_request:
            self._decontaminate("cold-per-request")
        # a prefetch of the last request is joined and forgotten
        reset_async_dispatch()
        for module in ModuleLoader().get_detection_modules():
            module.reset_module()
            module.cache.clear()
        dispatch_stats.reset()
        stats = SolverStatistics()
        stats.enabled = True
        stats.reset()
        # the partial flag is per-request in serve mode: a prior
        # request's deadline drain must not mark this one partial
        get_checkpoint_plane().partial = False
        set_request_scope(rid, trace_id)
        # lane-ledger origin: records produced by this request carry
        # its contract name, scope and trace id (/debug/lanes keys the
        # per-scope aggregates on rid)
        from mythril_tpu_torch.observability.ledger import set_origin

        set_origin(contract=self.in_flight_info["contract"]
                   if self.in_flight_info else None,
                   tx_index=None, scope=rid, trace=trace_id)

    def _fire(self, request, rid: str, budget_s: float) -> dict:
        """The analysis proper (the bench/_analyze_one shape), plus the
        response body."""
        import json as _json

        from mythril_tpu_torch.analysis.report import Report
        from mythril_tpu_torch.analysis.security import fire_lasers
        from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
        from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
        from mythril_tpu_torch.ops.async_dispatch import get_async_dispatcher
        from mythril_tpu_torch.resilience import faults
        from mythril_tpu_torch.resilience.budget import current_budget
        from mythril_tpu_torch.resilience.checkpoint import (
            drain_requested, get_checkpoint_plane,
        )
        from mythril_tpu_torch.solidity.evmcontract import EVMContract

        faults.maybe_fault_request()  # chaos seam: poisoned request
        exec_timeout = math.ceil(budget_s + _EXEC_TIMEOUT_MARGIN_S)
        time_handler.start_execution(exec_timeout)
        contract = EVMContract(code=request.code, name=request.name)
        began = time.monotonic()
        sym = SymExecWrapper(
            contract,
            address=0x901D12EBE1B195E5AA8748E62BD7734AE19B51F,
            strategy="bfs",
            max_depth=request.max_depth,
            execution_timeout=exec_timeout,
            create_timeout=10,
            transaction_count=request.tx_count,
            modules=request.modules,
            compulsory_statespace=False,
        )
        issues = fire_lasers(sym, request.modules)
        # a prefetch still in flight is waited for, and its failure
        # raised here (no later funnel call of this request harvests it)
        get_async_dispatcher().finish()
        analysis_s = time.monotonic() - began

        report = Report(contracts=[contract])
        for issue in issues:
            report.append_issue(issue)
        # render INSIDE the budget scope: the partial flag rides
        # drain_requested(), which reads the installed budget
        rendered = _json.loads(report.as_swc_standard_format())[0]
        partial = bool(
            drain_requested() or get_checkpoint_plane().partial
        )
        if partial:
            self.requests_partial += 1
            self._m_partial.inc()
            # a drained request's deferred lanes must not ride into a
            # later request's device batch — purge its coalescer scope
            from mythril_tpu_torch.ops.coalesce import purge_scope

            purge_scope(rid)
        budget = current_budget()
        body = {
            "request_id": rid,
            "name": request.name,
            "issues": rendered["issues"],
            "findings_swc": sorted(
                {i.swc_id for i in issues if i.swc_id}
            ),
            "meta": rendered["meta"],
            "partial": partial,
            "aborted_at_tx": getattr(sym.laser, "aborted_at_tx", None),
            "analysis_s": round(analysis_s, 3),
            "budget_s": round(budget_s, 3),
            "budget_remaining_s": round(
                budget.remaining_s(), 3
            ) if budget else None,
            "mode": self.mode(),
        }
        try:
            from mythril_tpu_torch.persist.plane import (
                code_digest, get_knowledge_plane,
            )

            # a finished, non-partial verdict becomes the admission
            # edge's report cache entry (partial bodies are refused by
            # report_cache_put itself); inert without a persist dir
            get_knowledge_plane().report_cache_put(
                code_digest(request.code), request.tx_count,
                request.max_depth, request.modules, body,
            )
        except Exception:  # noqa: BLE001 — caching never fails a request
            log.debug("persist: report cache store failed", exc_info=True)
        return body

    def _fail_request(self, rid: str, request, exc) -> dict:
        """The isolation contract for a crashed request: flight dump
        attached, shared state decontaminated, structured error out —
        the engine (and so the server) keeps going."""
        from mythril_tpu_torch.observability import flight

        log.error("request %s (%s) crashed: %s", rid, request.source,
                  exc, exc_info=True)
        dump_path = flight.get_flight_recorder().dump("serve_request")
        self._decontaminate(f"request {rid} crashed")
        return {
            "error": {
                "code": "analysis_failed",
                "message": f"{type(exc).__name__}: {exc}",
                "flight_dump": dump_path,
            },
            "request_id": rid,
        }

    def _lose_device(self, rid: str, exc: BaseException, code: str) -> dict:
        """The card is gone (:func:`device_fatal`): record it, so that
        the engine stops after this request, and answer 503."""
        from mythril_tpu_torch.observability import flight

        log.error("request %s: the device was lost: %s", rid, exc,
                  exc_info=True)
        self.device_lost = exc
        dump_path = flight.get_flight_recorder().dump("serve_device_lost")
        return {
            "error": {
                "code": code,
                "message": f"{type(exc).__name__}: {exc}",
                "flight_dump": dump_path,
            },
            "request_id": rid,
            "mode": self.mode(),
        }

    def _decontaminate(self, reason: str) -> None:
        """Drop every piece of shared mutable solver state a crashed
        request may have left inconsistent.  Generation scoping does
        the heavy lifting: a fresh blast context moves the generation,
        and the resident-pool reset drops device buffers keyed to the
        old one.  On the card the streams are synchronized first, so
        that the dropped buffers are no longer in use, and the
        allocator's cache is emptied after."""
        log.warning("decontaminating shared solver state (%s)", reason)
        from mythril_tpu_torch.ops.async_dispatch import reset_async_dispatch
        from mythril_tpu_torch.ops.batched_sat import reset_resident_pools
        from mythril_tpu_torch.ops.coalesce import reset_coalescer
        from mythril_tpu_torch.smt.solver import reset_blast_context
        from mythril_tpu_torch.support.model import clear_model_cache

        on_card = torch.device(self.config.device).type == "cuda"
        reset_async_dispatch()
        if on_card:
            torch.cuda.synchronize()
        reset_blast_context()
        clear_model_cache()
        reset_resident_pools()
        reset_coalescer(hard=True)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
