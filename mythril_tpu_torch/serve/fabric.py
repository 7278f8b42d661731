"""The serving fabric's request router: ``myth serve`` as the
admission edge of an authenticated multi-host fleet (own copy of
``mythril_tpu/serve/fabric.py``, on the port's ``parallel/``).

The daemon owns ONE long-lived :class:`Coordinator` in attach-only
mode (``workers=0`` — it never spawns; seats appear when remote
``myth worker --connect`` processes complete the fabric handshake in
``parallel/fabric.py``).  Each admitted request becomes one lease with
a *per-lease payload* (the contract bytecode and knobs ride the grant;
``Lease.payload`` overrides the coordinator-wide payload the
``--workers N`` CLI path uses), granted to a remote seat, journal
shipped over the wire, and settled back into an HTTP response body.

Division of labour with the engine thread:

- the **router loop thread** owns every piece of coordinator state —
  the coordinator is a single-threaded lease machine, so commands from
  engine/handler threads arrive through a queue, exactly like worker
  messages arrive through the coordinator's inbox;
- the **engine thread** calls :meth:`execute` and blocks on the job's
  event; ``None`` means "run it in-process" — no connected seats, the
  lease failed past its retry budget, rendering broke, or the budget
  ran out while the fabric held it.  The degradation ladder always
  ends at the engine's own ``_fire``.  A worker error the fleet did not
  inject (``parallel/coordinator.FleetWorkerError``) is not re-run: it
  fails that request, as it fails a ``--workers N`` analysis.

The leases carry the server's device in their args snapshot
(``parallel/fleet._args_snapshot``): a request cannot choose it.

Chaos posture: a worker SIGKILL mid-request surfaces as a missed
heartbeat → the lease re-stages from its last boundary journal onto
another seat (epoch-fenced against the zombie's late frames) → the
client sees nothing but latency.  A client hangup surfaces as
``Ticket.abandoned`` → :meth:`Coordinator.cancel_lease` revokes the
seat at its next boundary so an abandoned request cannot hold a seat
for its full budget.
"""

import logging
import math
import os
import queue
import shutil
import tempfile
import threading
import time
from typing import Optional, Tuple

from mythril_tpu_torch.observability.metrics import get_registry
from mythril_tpu_torch.serve.admission import Ticket
from mythril_tpu_torch.serve.config import ServeConfig

log = logging.getLogger(__name__)

#: the fixed analysis address every execution path uses (CLI, bench,
#: serve in-process, fleet workers)
FABRIC_ADDRESS = 0x901D12EBE1B195E5AA8748E62BD7734AE19B51F

#: extra seconds the router waits past the request budget before it
#: cancels the lease and hands the request back to the engine
_FABRIC_MARGIN_S = 30.0


class _FabricJob:
    """One request in flight on the fabric: the rendezvous between the
    engine thread (waits) and the router loop thread (settles)."""

    __slots__ = ("ticket", "request", "rid", "trace_id", "budget_s",
                 "lease", "done", "cancelled", "error")

    def __init__(self, ticket: Ticket, request, rid: str,
                 trace_id: str, budget_s: float):
        self.ticket = ticket
        self.request = request
        self.rid = rid
        self.trace_id = trace_id
        self.budget_s = budget_s
        self.lease = None          # set by the loop thread at submit
        self.done = threading.Event()
        self.cancelled = False
        self.error = None          # a worker error the fleet did not inject


class FleetRouter:
    """Admission-edge router over one attach-only :class:`Coordinator`."""

    def __init__(self, config: ServeConfig):
        from mythril_tpu_torch.parallel import fabric
        from mythril_tpu_torch.parallel.coordinator import (
            Coordinator, FleetConfig,
        )

        self.config = config
        host, port = fabric.parse_listen(config.fleet_listen)
        secret = (fabric.load_secret(config.fleet_secret_file)
                  if config.fleet_secret_file else None)
        fleet_config = FleetConfig.from_env(workers=0)
        # attach-only: workers=0 makes _maybe_respawn a no-op — every
        # seat is a remote `myth worker --connect` that authenticated
        fleet_config.workers = 0
        fleet_config.listen_host = host
        fleet_config.listen_port = port
        fleet_config.secret = secret
        self._base_dir = tempfile.mkdtemp(prefix="mtpu-fabric-")
        self.coordinator = Coordinator(
            fleet_config, lease_payload={},
            spawner=lambda *a, **k: None,
        )
        self._commands: "queue.Queue" = queue.Queue()
        self._jobs = {}            # lease_id -> _FabricJob (loop thread)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="mythril-serve-fabric", daemon=True
        )
        self.routed = 0
        self.fallbacks = 0
        self.revoked = 0
        registry = get_registry()
        self._m_routed = registry.counter(
            "mythril_tpu_serve_fabric_routed_total",
            "requests answered by a fabric worker seat",
        )
        self._m_fallbacks = registry.counter(
            "mythril_tpu_serve_fabric_fallbacks_total",
            "requests the fabric handed back for in-process execution",
        )
        self._m_revoked = registry.counter(
            "mythril_tpu_serve_fabric_revoked_total",
            "leases revoked because the client abandoned the request",
        )

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        port = self.coordinator.open_listener()
        self._thread.start()
        log.info(
            "serve fabric: coordinator listening on %s:%d (%s)",
            self.coordinator.config.listen_host, port,
            "authenticated" if self.coordinator.config.secret
            else "loopback-only",
        )

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            self.coordinator.shutdown()
        except Exception:  # noqa: BLE001 — best-effort teardown
            log.debug("fabric: coordinator shutdown failed",
                      exc_info=True)
        shutil.rmtree(self._base_dir, ignore_errors=True)

    # -- the loop thread (owns all coordinator state) -------------------

    def _loop(self) -> None:
        from mythril_tpu_torch.parallel.coordinator import FleetWorkerError

        coordinator = self.coordinator
        while not self._stop.is_set():
            try:
                worker_id, header, body = coordinator.inbox.get(
                    timeout=0.25
                )
            except queue.Empty:
                pass
            else:
                try:
                    coordinator.handle_message(worker_id, header, body)
                except FleetWorkerError as exc:
                    self._fail_worker_job(worker_id, exc)
                except Exception:  # noqa: BLE001 — the loop never dies
                    log.exception("fabric: message handling failed")
            self._drain_commands()
            try:
                coordinator.sweep()
                coordinator.assign()
            except Exception:  # noqa: BLE001
                log.exception("fabric: sweep/assign failed")
            self._settle()

    def _drain_commands(self) -> None:
        while True:
            try:
                verb, job = self._commands.get_nowait()
            except queue.Empty:
                return
            try:
                if verb == "submit":
                    self._stage(job)
                elif verb == "cancel":
                    self._cancel(job)
            except Exception:  # noqa: BLE001 — fail the one job only
                log.exception("fabric: %s failed for %s", verb, job.rid)
                job.done.set()

    def _stage(self, job: _FabricJob) -> None:
        """One request → one lease.  The journal dir starts empty (a
        fresh request has no frontier; resume-from-empty runs from
        transaction zero) and fills with boundary generations the
        worker ships back — death re-leases from the last boundary."""
        from mythril_tpu_torch.parallel.fleet import _args_snapshot

        request = job.request
        journal_dir = os.path.join(self._base_dir, job.rid)
        os.makedirs(journal_dir, exist_ok=True)
        lease = self.coordinator.add_lease(journal_dir, tx_index=0,
                                           n_states=1)
        lease.payload = {
            "name": request.name,
            "address": FABRIC_ADDRESS,
            "code": request.code,
            "transaction_count": int(request.tx_count),
            "max_depth": int(request.max_depth),
            "execution_timeout": max(1, math.ceil(job.budget_s)),
            "create_timeout": 10,
            "args": _args_snapshot(),
            "trace": False,
            "trace_id": job.trace_id,
        }
        job.lease = lease
        self._jobs[lease.lease_id] = job

    def _cancel(self, job: _FabricJob) -> None:
        job.cancelled = True
        if job.lease is not None:
            self.coordinator.cancel_lease(
                job.lease.lease_id, reason="client abandoned"
            )

    def _fail_worker_job(self, worker_id: str, exc: Exception) -> None:
        """A worker failed its lease with an error the fleet did not
        inject: fail the lease, free the seat, and hand the error to the
        request waiting on it."""
        from mythril_tpu_torch.parallel.coordinator import FAILED

        log.error("fabric: %s", exc)
        seat = self.coordinator.seats.get(worker_id)
        lease = self.coordinator._lease_of(seat) if seat else None
        if seat is not None:
            seat.lease_id = None
        if lease is None:
            return
        lease.state = FAILED
        lease.worker_id = None
        job = self._jobs.pop(lease.lease_id, None)
        if job is not None:
            job.error = exc
            job.done.set()

    def _settle(self) -> None:
        from mythril_tpu_torch.parallel.coordinator import DONE, FAILED

        finished = [
            lease_id for lease_id, job in self._jobs.items()
            if job.lease is not None
            and job.lease.state in (DONE, FAILED)
        ]
        for lease_id in finished:
            job = self._jobs.pop(lease_id)
            job.done.set()

    # -- engine-thread side ---------------------------------------------

    def seat_count(self) -> int:
        """Connected, live seats (advisory snapshot)."""
        try:
            return sum(
                1 for seat in list(self.coordinator.seats.values())
                if not seat.dead
                and self.coordinator._connected(seat)
            )
        except Exception:  # noqa: BLE001 — racing the loop thread
            return 0

    def execute(self, ticket: Ticket, request, rid: str,
                trace_id: str, budget_s: float
                ) -> Optional[Tuple[int, dict]]:
        """Route one admitted request onto the fabric.  Returns
        ``(status, body)``, or ``None`` when the engine should run it
        in-process (the bottom of the degradation ladder)."""
        if self.seat_count() == 0:
            self.fallbacks += 1
            self._m_fallbacks.inc()
            return None
        job = _FabricJob(ticket, request, rid, trace_id, budget_s)
        self._commands.put(("submit", job))
        deadline = time.monotonic() + budget_s + _FABRIC_MARGIN_S
        while not job.done.wait(0.25):
            if ticket.abandoned.is_set():
                # the client hung up: revoke the lease so an abandoned
                # request cannot hold a seat for its whole budget
                self.revoked += 1
                self._m_revoked.inc()
                self._commands.put(("cancel", job))
                job.done.wait(5.0)
                return 499, {
                    "request_id": rid,
                    "cancelled": True,
                    "mode": "fabric",
                }
            if time.monotonic() >= deadline:
                # the fabric sat on it past the budget: take it back
                self._commands.put(("cancel", job))
                job.done.wait(5.0)
                self.fallbacks += 1
                self._m_fallbacks.inc()
                return None
        if job.error is not None:
            raise job.error
        lease = job.lease
        if lease is None:
            self.fallbacks += 1
            self._m_fallbacks.inc()
            return None
        result = lease.result or {}
        if job.cancelled or result.get("cancelled"):
            return 499, {
                "request_id": rid,
                "cancelled": True,
                "mode": "fabric",
            }
        from mythril_tpu_torch.parallel.coordinator import DONE

        if lease.state != DONE or not lease.result_body:
            self.fallbacks += 1
            self._m_fallbacks.inc()
            return None
        try:
            body = self._render(request, rid, budget_s, lease)
        except Exception:  # noqa: BLE001 — a torn result costs an
            #               in-process re-run, never a 500
            log.warning("fabric: result render failed for %s; "
                        "falling back in-process", rid, exc_info=True)
            self.fallbacks += 1
            self._m_fallbacks.inc()
            return None
        self.routed += 1
        self._m_routed.inc()
        return 200, body

    def _render(self, request, rid: str, budget_s: float,
                lease) -> dict:
        """Rebuild the engine's response-body shape from a worker
        result (the ``_fire`` contract, with ``mode: fabric``)."""
        import io
        import json as _json

        from mythril_tpu_torch.analysis.report import Report
        from mythril_tpu_torch.observability.ledger import get_ledger
        from mythril_tpu_torch.parallel.fleet import ResultUnpickler
        from mythril_tpu_torch.solidity.evmcontract import EVMContract

        result = lease.result or {}
        # the fleet's own reader: globals of this package only
        data = ResultUnpickler(io.BytesIO(lease.result_body)).load()
        findings = data.get("findings") or {}
        issues = []
        for module_name, per_module in (
            findings.get("issues") or {}
        ).items():
            if request.modules and module_name not in request.modules:
                continue  # honour the request's detector allow-list
            issues.extend(per_module)
        contract = EVMContract(code=request.code, name=request.name)
        report = Report(contracts=[contract])
        for issue in issues:
            report.append_issue(issue)
        rendered = _json.loads(report.as_swc_standard_format())[0]
        try:
            get_ledger().merge_snapshot(data.get("ledger"))
        except Exception:  # noqa: BLE001 — telemetry only
            log.debug("fabric: ledger merge failed", exc_info=True)
        return {
            "request_id": rid,
            "name": request.name,
            "issues": rendered["issues"],
            "findings_swc": sorted(
                {i.swc_id for i in issues if i.swc_id}
            ),
            "meta": rendered["meta"],
            "partial": bool(result.get("partial")),
            "aborted_at_tx": None,
            "analysis_s": result.get("wall_s"),
            "budget_s": round(budget_s, 3),
            "budget_remaining_s": None,
            "mode": "fabric",
            "worker": result.get("worker_id") or lease.worker_id,
        }

    # -- introspection --------------------------------------------------

    def summary(self) -> dict:
        """The small block ``/readyz`` carries."""
        return {
            "listen": "{}:{}".format(
                self.coordinator.config.listen_host,
                self.coordinator.port,
            ),
            "authenticated": self.coordinator.config.secret is not None,
            "seats": self.seat_count(),
            "routed": self.routed,
            "fallbacks": self.fallbacks,
            "revoked": self.revoked,
        }

    def debug_status(self) -> dict:
        """The ``/debug/fleet`` body (advisory — races the loop
        thread, so a torn read degrades to the summary)."""
        body = self.summary()
        body["jobs_in_flight"] = len(self._jobs)
        try:
            body["coordinator"] = self.coordinator.debug_status()
        except Exception:  # noqa: BLE001 — snapshot raced a mutation
            body["coordinator"] = None
        return body
