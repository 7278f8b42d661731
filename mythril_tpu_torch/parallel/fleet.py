"""The frontier fleet: the LASER world-state frontier sharded across
worker processes (own copy of ``mythril_tpu/parallel/fleet.py``).

``python3 -m mythril_tpu_torch analyze --workers N`` (or
``MYTHRIL_TPU_FLEET_WORKERS=N``) turns the transaction loop's frontier
into leased subtrees: at the first transaction boundary holding at least
``MYTHRIL_TPU_FLEET_MIN_STATES`` (default 2) open world states, the
coordinator (``coordinator.py``) writes each subtree as a journal of the
checkpoint plane, leases the journals to N worker processes, and each
worker runs the port's whole dispatch plane (word tier, prefetch,
resident and dense tiers, lockstep, keccak, CDCL tail) on its subtree by
resuming from the lease journal, on the device the lease names
(``args.device`` in the payload's args snapshot: a worker asked for the
card on a host without one fails its lease, it never runs on the CPU
instead).  Findings merge back under the detection modules' own dedup
keys, so the union over subtrees is the single-process finding set.

Failure detection and recovery are the JAX package's: heartbeats and
lease expiry, re-lease from the dead worker's last journal boundary,
straggler splitting, epoch-fenced knowledge gossip (``gossip.py``), and
the in-process finish of what a fleet that lost every worker could not.
Unlike the JAX package, a worker error the fleet did not inject fails
the analysis (``coordinator.FleetWorkerError``), and :func:`svm_boundary`
catches only the fleet's own failures (a socket's ``OSError``,
``FrameError``, ``FleetAuthError``, ``FaultInjected``).

Kill switch: ``MYTHRIL_TPU_FLEET=0`` (or ``--workers 0``) is the
single-process path: the svm seam returns before any fleet code loads.
Run a worker seat with ``python -m mythril_tpu_torch.parallel.fleet
--worker --connect HOST:PORT --id ID`` (what the coordinator spawns) or
``python3 -m mythril_tpu_torch worker --connect HOST:PORT``.
"""

import io
import logging
import os
import pickle
import queue
import shutil
import socket
import sys
import tempfile
import threading
import time
from typing import List, Optional

log = logging.getLogger(__name__)

_PREFIX = "mythril_tpu_fleet_"

#: field -> help; in ``DispatchStats.as_dict`` as ``fleet_<field>`` and
#: in the jsonv2 ``meta.resilience`` block (nonzero only).  The JAX
#: package's fields, and the port's ``inprocess_leases``.
_FIELDS = {
    "leases": "subtree leases granted (initial + re-leases + splits)",
    "rebalances": "straggler subtrees split and re-leased",
    "worker_deaths": "workers declared dead (TTL, crash, disconnect)",
    "gossip_sent": "knowledge messages accepted and routed",
    "gossip_dropped_stale": "messages fenced for a stale lease epoch",
    "auth_rejects": "connections rejected by the fabric handshake",
    "frame_rejects": "malformed/tampered/oversized frames struck",
    "remote_attaches": "externally-launched workers attached",
    # knowledge deltas riding heartbeat frames (persist/plane.py), sent
    # by workers and applied by the coordinator
    "persist_deltas_sent": "knowledge deltas sent on heartbeats",
    "persist_deltas_applied": "heartbeat knowledge deltas applied",
    # the total-loss rung: leases the coordinator finished itself
    "inprocess_leases": "leases finished in-process after the fleet "
                        "gave them up",
}


class FleetStats:
    """Fleet counters over the metrics registry (``mythril_tpu_fleet_*``),
    reset per analyzed contract with ``DispatchStats``."""

    __slots__ = ()

    @staticmethod
    def _cell(field: str):
        from mythril_tpu_torch.observability.metrics import get_registry

        return get_registry().counter(_PREFIX + field, _FIELDS[field])

    def reset(self):
        for field in _FIELDS:
            self._cell(field).set(0)

    def __getattr__(self, name):
        if name in _FIELDS:
            return self._cell(name).value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name not in _FIELDS:
            raise AttributeError(
                f"unknown fleet counter {name!r} (registered: "
                f"{tuple(_FIELDS)})")
        self._cell(name).set(value)

    def as_dict(self):
        return {field: self._cell(field).value for field in _FIELDS}


fleet_stats = FleetStats()


# ---------------------------------------------------------------------------
# knobs and roles
# ---------------------------------------------------------------------------


def _killed() -> bool:
    return os.environ.get("MYTHRIL_TPU_FLEET", "").lower() in (
        "0", "off", "false")


def worker_role() -> bool:
    return os.environ.get("MYTHRIL_TPU_FLEET_ROLE") == "worker"


def effective_workers() -> int:
    """``--workers`` (``args.fleet_workers``) wins; None defers to
    ``MYTHRIL_TPU_FLEET_WORKERS``; 0 anywhere is the fleet off."""
    if _killed():
        return 0
    from mythril_tpu_torch.support.support_args import args

    configured = getattr(args, "fleet_workers", None)
    if configured is None:
        try:
            configured = int(os.environ.get("MYTHRIL_TPU_FLEET_WORKERS", "0"))
        except ValueError:
            configured = 0
    return max(0, int(configured))


def seam_enabled() -> bool:
    """The svm loop's gate: anything for the fleet to do at a
    transaction boundary?  False is the single-process path."""
    if worker_role():
        return True  # the worker's boundary duties
    return effective_workers() > 0


def min_states() -> int:
    """The smallest frontier worth sharding (default 2; 1 delegates the
    whole remaining analysis as one lease at the first boundary)."""
    try:
        return max(1, int(os.environ.get("MYTHRIL_TPU_FLEET_MIN_STATES",
                                         "2")))
    except ValueError:
        return 2


def should_delegate(laser) -> bool:
    from mythril_tpu_torch.resilience.checkpoint import drain_requested

    if worker_role() or effective_workers() < 1:
        return False
    if getattr(laser, "_fleet_attempted", False):
        return False
    if drain_requested():
        return False
    return len(laser.open_states) >= min_states()


def svm_boundary(laser, address: int, tx_index: int) -> bool:
    """The seam ``LaserEVM._execute_transactions`` calls at each
    transaction boundary (when :func:`seam_enabled`).  In a worker it
    does the boundary duties and returns False; in the coordinating
    process it may delegate the remaining transactions to the fleet:
    True means the fleet (and any in-process finish) completed them.  A
    failure of the fleet's own transport leaves the analysis
    single-process; any other error propagates and fails it."""
    from mythril_tpu_torch.parallel.gossip import FrameError
    from mythril_tpu_torch.resilience.faults import FaultInjected

    if worker_role():
        session = _worker_session
        if session is not None:
            session.tx_boundary(tx_index)
        return False
    if not should_delegate(laser):
        return False
    laser._fleet_attempted = True
    try:
        return run_fleet(laser, address, tx_index)
    except (OSError, FrameError, FaultInjected) as exc:
        log.warning("fleet: delegation failed (%s: %s); continuing "
                    "in-process", type(exc).__name__, exc)
        return False


# ---------------------------------------------------------------------------
# coordinator side: shard, lease, merge, finish
# ---------------------------------------------------------------------------


def _target_bytecode(states, address: int) -> Optional[str]:
    """The runtime bytecode of the analysis target, read out of the
    frontier's world states."""
    for world_state in states:
        account = world_state.accounts.get(int(address))
        if account is None:
            continue
        bytecode = getattr(getattr(account, "code", None), "bytecode", "")
        if bytecode:
            return bytecode
    return None


def _args_snapshot() -> dict:
    """The analysis flags a worker mirrors (plain values only; the
    journal, fleet and artifact flags are per process), ``device``
    among them."""
    from mythril_tpu_torch.support.support_args import args

    skip = {"checkpoint_dir", "resume_from", "trace_out", "metrics_out",
            "lane_ledger_out", "fleet_workers"}
    return {key: value for key, value in vars(args).items()
            if key not in skip
            and isinstance(value, (bool, int, float, str, type(None)))}


def _frontier_chunks(states: List, shards: int) -> List[List]:
    """Round-robin partition: neighbouring frontier states are usually
    siblings of near-equal cost, so striping balances depth skew better
    than contiguous slabs."""
    chunks = [[] for _ in range(shards)]
    for index, state in enumerate(states):
        chunks[index % shards].append(state)
    return [chunk for chunk in chunks if chunk]


def _write_lease_journal(directory: str, address: int, tx_index: int,
                         transaction_count: int, states: List,
                         findings: Optional[dict] = None) -> None:
    from mythril_tpu_torch.resilience.checkpoint import write_journal

    write_journal(directory, {
        "kind": "mythril-tpu-checkpoint",
        "address": int(address),
        "tx_index": int(tx_index),
        "transaction_count": int(transaction_count),
        "open_states": list(states),
        "findings": findings or {"issues": {}, "caches": {}},
        "channels": {},
        "partial": False,
    })


def split_lease_journal(journal_dir: str):
    """Carve a lease's newest journal into two half-frontier journals
    (the straggler split): ``[(dir, tx_index, n_states), ...]``, or None
    when the boundary frontier cannot be split."""
    from mythril_tpu_torch.resilience.checkpoint import (
        JournalCorrupt,
        load_journal,
    )

    try:
        payload = load_journal(journal_dir)
    except JournalCorrupt:
        log.warning("fleet: split aborted, journal unreadable",
                    exc_info=True)
        return None
    if payload is None:
        return None
    states = list(payload.get("open_states", ()))
    if len(states) < 2:
        return None
    half = (len(states) + 1) // 2
    halves = []
    for tag, chunk in (("a", states[:half]), ("b", states[half:])):
        directory = journal_dir.rstrip(os.sep) + f".split-{tag}"
        _write_lease_journal(directory, payload["address"],
                             payload["tx_index"],
                             payload["transaction_count"], chunk,
                             findings=payload.get("findings"))
        halves.append((directory, int(payload["tx_index"]), len(chunk)))
    return halves


def apply_gossip_local(body: bytes) -> None:
    """Apply a routed knowledge body to the coordinator's own context
    (so an in-process finish starts warm); a body the port did not
    write is dropped (knowledge is optional)."""
    from mythril_tpu_torch.parallel.gossip import (
        ForeignKnowledge,
        apply_knowledge,
    )
    from mythril_tpu_torch.smt.solver import get_blast_context

    try:
        apply_knowledge(get_blast_context(), body)
    except (ForeignKnowledge, EOFError) as exc:
        log.debug("fleet: routed knowledge dropped: %s", exc)


def _merge_findings(findings: dict) -> int:
    """Fold a worker's detection-module snapshot into this process's
    modules under their address-keyed dedup; returns the issues
    accepted."""
    from mythril_tpu_torch.analysis.module.loader import ModuleLoader

    accepted = 0
    issues_by_module = (findings or {}).get("issues", {})
    caches_by_module = (findings or {}).get("caches", {})
    for module in ModuleLoader().get_detection_modules():
        name = type(module).__name__
        for issue in issues_by_module.get(name, ()):
            if issue.address in module.cache:
                continue
            module.issues.append(issue)
            module.cache.add(issue.address)
            accepted += 1
        module.cache |= set(caches_by_module.get(name, ()))
    return accepted


class ForeignResult(pickle.UnpicklingError):
    """A result body that names a global outside this package (a body of
    the JAX package, or not a result at all)."""


class ResultUnpickler(pickle.Unpickler):
    """Unpickler of a worker's result body: resolves the globals of this
    package and the builtins, collections and numpy types an issue, a
    module cache, a ledger snapshot or a span list holds; refuses any
    other before it is built."""

    _SAFE = frozenset((
        ("builtins", "set"), ("builtins", "frozenset"),
        ("builtins", "complex"), ("builtins", "bytearray"),
        ("builtins", "slice"), ("builtins", "range"),
        ("collections", "OrderedDict"), ("collections", "defaultdict"),
        ("collections", "deque"), ("copyreg", "_reconstructor"),
        ("builtins", "object"),
        ("numpy", "dtype"), ("numpy", "ndarray"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
    ))

    def find_class(self, module, name):
        if (module == "mythril_tpu_torch"
                or module.startswith("mythril_tpu_torch.")
                or (module, name) in self._SAFE):
            return super().find_class(module, name)
        raise ForeignResult(f"result body names {module}.{name}")


def _result_dumps(payload: dict) -> bytes:
    """A result body, pickled with the journal's reducers (a tensor goes
    to host numpy; nodes re-intern in the coordinator)."""
    from mythril_tpu_torch.resilience.checkpoint import dumps

    return dumps(payload)


def _merge_result(lease, tracer) -> None:
    """One finished lease's result: findings, ledger, spans.  A body this
    package cannot read raises :class:`coordinator.FleetWorkerError`
    (its findings would be lost)."""
    from mythril_tpu_torch.observability.ledger import get_ledger
    from mythril_tpu_torch.parallel.coordinator import FleetWorkerError

    if not lease.result_body:
        return
    try:
        body = ResultUnpickler(io.BytesIO(lease.result_body)).load()
    except (pickle.UnpicklingError, EOFError, AttributeError,
            ImportError) as exc:
        raise FleetWorkerError(
            f"result body of {lease.lease_id} unreadable: "
            f"{type(exc).__name__}: {exc}") from exc
    _merge_findings(body.get("findings"))
    get_ledger().merge_snapshot(body.get("ledger"))
    result = lease.result or {}
    worker_id = result.get("worker_id", "?")
    if tracer is not None:
        tracer.add_external_total(f"fleet.worker:{worker_id}",
                                  float(result.get("wall_s", 0.0)))
        events = body.get("spans")
        if events:
            # a synthetic track per worker, re-parented under the run's
            # trace id
            tracer.absorb_events(
                events, worker=str(worker_id),
                trace_id=result.get("trace_id") or tracer.trace_id)


def _explore_inprocess(laser, address: int, tx_index: int,
                       states: List) -> None:
    """Run transactions ``tx_index`` onwards over a thawed subtree in
    this process (the total-loss rung), as the svm's transaction loop
    does: the module hooks fire and dedup as in a sequential run."""
    from mythril_tpu_torch.laser.ethereum.svm import _WorldStateView
    from mythril_tpu_torch.laser.ethereum.transaction import (
        execute_message_call,
    )
    from mythril_tpu_torch.laser.batch import prune_infeasible
    from mythril_tpu_torch.observability.ledger import set_origin
    from mythril_tpu_torch.resilience.checkpoint import drain_requested

    laser.open_states = list(states)
    for i in range(tx_index, laser.transaction_count):
        if not laser.open_states or drain_requested():
            break
        laser.open_states = [
            view.world_state for view in prune_infeasible(
                [_WorldStateView(ws) for ws in laser.open_states])
        ]
        set_origin(tx_index=i)
        laser._execute_hooks(laser._start_exec_hooks)
        execute_message_call(laser, address)
        laser._execute_hooks(laser._stop_exec_hooks)


def _finish_lease_inprocess(laser, address: int, lease) -> bool:
    """Resume one unfinished lease from its journal in this process."""
    from mythril_tpu_torch.resilience.checkpoint import (
        JournalCorrupt,
        load_journal,
    )

    try:
        payload = load_journal(lease.journal_dir)
    except JournalCorrupt:
        payload = None
    if payload is None:
        log.error("fleet: lease %s has no readable journal", lease.lease_id)
        return False
    fleet_stats.inprocess_leases += 1
    _merge_findings(payload.get("findings"))
    _explore_inprocess(laser, address, int(payload["tx_index"]),
                       list(payload.get("open_states", ())))
    return True


def run_fleet(laser, address: int, tx_index: int) -> bool:
    """Shard ``laser.open_states`` into leases and drive them to
    completion across worker processes (finishing in-process what the
    fleet could not).  Returns True when the remaining transactions are
    accounted for, False when the fleet could not start."""
    from mythril_tpu_torch.observability import spans as obs
    from mythril_tpu_torch.parallel.coordinator import (
        Coordinator,
        FleetConfig,
    )
    from mythril_tpu_torch.resilience.checkpoint import (
        CheckpointPlane,
        JournalCorrupt,
        drain_requested,
        get_checkpoint_plane,
        load_journal,
    )

    workers = effective_workers()
    states = CheckpointPlane._frontier_snapshot(laser.open_states)
    bytecode = _target_bytecode(states, address)
    if bytecode is None:
        log.warning("fleet: target bytecode not found in the frontier; "
                    "staying single-process")
        return False
    max_depth = laser.max_depth
    tracer = obs.get_tracer()
    payload = {
        "name": "fleet-target",
        "address": int(address),
        "code": bytecode,
        "transaction_count": int(laser.transaction_count),
        "max_depth": (int(max_depth)
                      if max_depth not in (None, float("inf")) else None),
        "execution_timeout": int(laser.execution_timeout or 0) or None,
        "create_timeout": int(laser.create_timeout or 0) or None,
        "args": _args_snapshot(),
        "trace": bool(tracer.enabled and tracer.record_events),
        # the run's trace identity: workers stamp their spans with it
        "trace_id": obs.get_trace_id(),
    }
    config = FleetConfig.from_env(workers)
    base_dir = tempfile.mkdtemp(prefix="mtpu-fleet-")
    try:
        coordinator = Coordinator(config, payload)
        shards = min(workers, len(states))
        for index, chunk in enumerate(_frontier_chunks(states, shards)):
            lease_dir = os.path.join(base_dir, f"lease{index}")
            _write_lease_journal(lease_dir, address, tx_index,
                                 laser.transaction_count, chunk)
            coordinator.add_lease(lease_dir, tx_index, len(chunk))
        coordinator.open_listener()
        coordinator.open_debug_listener()
        began = time.monotonic()
        try:
            with obs.span("fleet.run", cat="fleet", leases=shards,
                          workers=workers, tx=tx_index):
                coordinator.run()
        finally:
            coordinator.shutdown()
        tracer = tracer if tracer.enabled else None
        for lease in sorted(coordinator.finished(),
                            key=lambda l: l.lease_id):
            _merge_result(lease, tracer)
        partial = False
        for lease in sorted(coordinator.unfinished(),
                            key=lambda l: l.lease_id):
            if drain_requested():
                # merge what the lease journal holds; the rest is the
                # partial report's gap, as in a drained single process
                partial = True
                try:
                    journal = load_journal(lease.journal_dir)
                except JournalCorrupt:
                    journal = None
                if journal is not None:
                    _merge_findings(journal.get("findings"))
                continue
            _finish_lease_inprocess(laser, address, lease)
        if any((lease.result or {}).get("partial")
               for lease in coordinator.finished()):
            partial = True
        if partial:
            laser.aborted_at_tx = tx_index
            get_checkpoint_plane().partial = True
        log.info("fleet: %d lease(s) done (%d in-process), %d worker "
                 "deaths, %d rebalances, %.1fs",
                 len(coordinator.finished()), len(coordinator.unfinished()),
                 fleet_stats.worker_deaths, fleet_stats.rebalances,
                 time.monotonic() - began)
        laser.open_states = []
        return True
    finally:
        if os.environ.get("MYTHRIL_TPU_FLEET_KEEP_JOURNALS") != "1":
            shutil.rmtree(base_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------


class _WorkerSession:
    """What the worker's comms threads and its analysis thread share:
    the active lease, the gossip inbox and the send lock."""

    def __init__(self, worker_id: str, conn: socket.socket, channel=None):
        self.worker_id = worker_id
        self.conn = conn
        #: the authenticated channel (``fabric.AuthedChannel``)
        self.channel = channel
        self.send_lock = threading.Lock()
        self.lease_header: Optional[dict] = None
        self.lease_lock = threading.Lock()
        self.gossip_in: "queue.Queue" = queue.Queue()
        self.lease_queue: "queue.Queue" = queue.Queue()
        self.closed = False
        #: the local journal directory of a lease that came over the
        #: wire (a remote seat shares no filesystem)
        self.wire_dir: Optional[str] = None

    # -- comms ----------------------------------------------------------

    def send(self, header: dict, body: bytes = b"") -> None:
        from mythril_tpu_torch.parallel.gossip import FrameError, send_frame

        if self.closed:
            return
        try:
            with self.send_lock:
                if self.channel is not None:
                    self.channel.send(header, body)
                else:
                    send_frame(self.conn, header, body)
        except (FrameError, OSError):
            self.closed = True

    def reader_loop(self) -> None:
        from mythril_tpu_torch.parallel.gossip import FrameError, recv_frame

        while True:
            try:
                if self.channel is not None:
                    header, body = self.channel.recv()
                else:
                    header, body = recv_frame(self.conn)
            except (FrameError, OSError):
                self.closed = True
                self._abort_active_lease()
                self.lease_queue.put(None)
                return
            kind = header.get("type")
            if kind == "lease":
                self.lease_queue.put((header, body))
            elif kind == "gossip":
                self.gossip_in.put((header, body))
            elif kind == "revoke":
                self._on_revoke(header)
            elif kind == "drain":
                # the frame twin of SIGTERM for a remote seat
                from mythril_tpu_torch.resilience.checkpoint import (
                    request_drain,
                )

                request_drain("coordinator drain frame")
            elif kind == "shutdown":
                # the end for a spawned seat; a pause for a remote one
                # with a redial budget (worker_main decides)
                self.closed = True
                self._abort_active_lease()
                self.lease_queue.put(None)
                return

    def _abort_active_lease(self) -> None:
        """The coordinator is gone mid-lease: expire the lease's budget,
        so the analysis drains at its next boundary."""
        from mythril_tpu_torch.resilience.budget import install_budget

        with self.lease_lock:
            header = self.lease_header
        if header is not None:
            install_budget(0.0, label="coordinator lost")

    def _on_revoke(self, header: dict) -> None:
        """A revoked lease drains at its next boundary; the seat stays
        leasable."""
        from mythril_tpu_torch.resilience.budget import install_budget

        with self.lease_lock:
            current = self.lease_header
        if (current is not None
                and header.get("lease_id") == current["lease_id"]):
            install_budget(0.0, label="lease revoked")

    def heartbeat_loop(self, interval_holder: dict) -> None:
        """Beat while a lease runs.  A knowledge delta of the knowledge
        plane rides a beat when the channels changed since the last one
        (no device work here: the freeze reads host memos)."""
        from mythril_tpu_torch.parallel.gossip import ForeignKnowledge
        from mythril_tpu_torch.persist.plane import get_knowledge_plane
        from mythril_tpu_torch.smt.solver import get_blast_context

        while not self.closed:
            with self.lease_lock:
                header = self.lease_header
            if header is not None:
                beat = {"type": "heartbeat",
                        "lease_id": header["lease_id"],
                        "stamp": header["stamp"],
                        "worker_id": self.worker_id}
                body = b""
                try:
                    delta = get_knowledge_plane().encode_heartbeat_delta(
                        get_blast_context())
                except (RuntimeError, ForeignKnowledge) as exc:
                    # a freeze racing the analysis thread skips this
                    # beat's delta; the next beat carries it
                    log.debug("worker: knowledge delta skipped: %s", exc)
                    delta = None
                if delta:
                    beat["persist"] = True
                    body = delta
                    fleet_stats.persist_deltas_sent += 1
                self.send(beat, body)
            time.sleep(interval_holder.get("s", 0.5))

    # -- boundary duties (from the svm seam) ----------------------------

    def tx_boundary(self, tx_index: int) -> None:
        """Apply queued knowledge, publish ours, ship the journal of a
        wire lease, flush the knowledge store and hit the preemption
        fault seam: at the one point where no dispatch is in flight."""
        from mythril_tpu_torch.parallel.gossip import (
            ForeignKnowledge,
            apply_knowledge,
            freeze_knowledge,
            stamp_for,
        )
        from mythril_tpu_torch.persist.plane import get_knowledge_plane
        from mythril_tpu_torch.resilience.faults import (
            maybe_fault_worker_kill,
        )
        from mythril_tpu_torch.smt.solver import get_blast_context

        maybe_fault_worker_kill()
        with self.lease_lock:
            header = self.lease_header
        if header is None:
            return
        ctx = get_blast_context()
        while True:
            try:
                _gheader, body = self.gossip_in.get_nowait()
            except queue.Empty:
                break
            try:
                apply_knowledge(ctx, body)
            except (ForeignKnowledge, EOFError) as exc:
                log.debug("worker: gossip dropped: %s", exc)
        epoch = int(header["stamp"].get("lease_epoch", 0))
        self.send({"type": "gossip",
                   "lease_id": header["lease_id"],
                   "stamp": stamp_for(ctx, epoch).as_dict(),
                   "worker_id": self.worker_id,
                   "tx": tx_index},
                  freeze_knowledge(ctx))
        self.ship_checkpoint(header)
        get_knowledge_plane().maybe_flush()

    def ship_checkpoint(self, header: dict) -> None:
        """Ship the local boundary journal of a wire lease back, so that
        the coordinator can lease it again from this boundary."""
        from mythril_tpu_torch.parallel import fabric

        if self.wire_dir is None:
            return
        self.send({"type": "checkpoint",
                   "lease_id": header["lease_id"],
                   "stamp": header["stamp"],
                   "worker_id": self.worker_id},
                  fabric.pack_journal(self.wire_dir))


_worker_session: Optional[_WorkerSession] = None


def _worker_reset_scope(journal_dir: str, knobs: dict) -> None:
    """Per-lease isolation in the worker (a seat may serve leases of
    different analyses): the port's resets of an analysis, then the
    lease's flags, and the lease journal becomes this process's
    checkpoint plane (resume restores the subtree, progress writes
    back)."""
    from mythril_tpu_torch.analysis.module.loader import ModuleLoader
    from mythril_tpu_torch.observability.ledger import get_ledger
    from mythril_tpu_torch.ops.async_dispatch import (
        async_stats,
        reset_async_dispatch,
    )
    from mythril_tpu_torch.ops.batched_sat import (
        dispatch_stats,
        reset_resident_pools,
    )
    from mythril_tpu_torch.resilience import checkpoint
    from mythril_tpu_torch.smt import SolverStatistics
    from mythril_tpu_torch.smt.solver import reset_blast_context
    from mythril_tpu_torch.support.model import clear_model_cache
    from mythril_tpu_torch.support.support_args import args

    reset_async_dispatch()
    reset_blast_context()
    clear_model_cache()
    reset_resident_pools()
    for module in ModuleLoader().get_detection_modules():
        module.reset_module()
        module.cache.clear()
    dispatch_stats.reset()
    async_stats.reset()
    # each lease's lanes go home with its result: a second lease must
    # not ship the first one's (the origin survives the reset)
    get_ledger().reset()
    stats = SolverStatistics()
    stats.enabled = True
    stats.reset()
    plane = checkpoint.get_checkpoint_plane()
    plane.partial = False
    plane.configure(journal_dir, resume=True)
    for key, value in knobs.items():
        if hasattr(args, key):
            setattr(args, key, value)
    args.fleet_workers = 0
    args.trace_out = None
    args.metrics_out = None
    args.lane_ledger_out = None
    args.checkpoint_dir = journal_dir
    args.resume_from = journal_dir


def _worker_lease_cleanup(session: _WorkerSession) -> None:
    from mythril_tpu_torch.resilience.budget import clear_budget

    clear_budget()  # a revoke's expired budget must not leak forward
    if session.wire_dir is not None:
        shutil.rmtree(session.wire_dir, ignore_errors=True)
        session.wire_dir = None


def _error_frame(session: _WorkerSession, header: dict,
                 exc: BaseException) -> dict:
    """The ``error`` frame of a failed lease: the exception's type (the
    coordinator leases again only an injected one) and message."""
    from mythril_tpu_torch.resilience.faults import FaultInjected
    from mythril_tpu_torch.resilience.watchdog import WatchdogTimeout

    return {
        "type": "error",
        "lease_id": header["lease_id"],
        "stamp": header["stamp"],
        "worker_id": session.worker_id,
        "error_type": type(exc).__name__,
        "injected": isinstance(exc, (FaultInjected, WatchdogTimeout)),
        "message": f"{type(exc).__name__}: {exc}",
    }


def _device_report() -> dict:
    """The lease's device: its type, and on the card its name and the
    caching allocator's peak bytes in this process."""
    import torch

    from mythril_tpu_torch.support.support_args import args

    if str(args.device or "cuda").startswith("cpu") \
            or not torch.cuda.is_initialized():
        return {"type": "cpu"}
    return {"type": "cuda", "name": torch.cuda.get_device_name(),
            "peak_bytes": int(torch.cuda.max_memory_allocated())}


def _worker_run_lease(session: _WorkerSession, header: dict,
                      body: bytes = b"") -> None:
    """Run one lease end to end and report its result or its error."""
    from mythril_tpu_torch.observability import spans as obs
    from mythril_tpu_torch.observability.ledger import get_ledger, set_origin
    from mythril_tpu_torch.parallel import fabric
    from mythril_tpu_torch.resilience.checkpoint import (
        CheckpointPlane,
        drain_requested,
        get_checkpoint_plane,
    )

    payload = header["payload"]
    journal_dir = header["journal_dir"]
    if header.get("journal_wire"):
        # a remote seat: the grant's body is the journal
        journal_dir = tempfile.mkdtemp(prefix="mtpu-wire-")
        fabric.unpack_journal(body, journal_dir)
        session.wire_dir = journal_dir
    tracer = obs.get_tracer()
    if payload.get("trace"):
        tracer.enable(record_events=True)
        tracer.reset()
    # this worker's spans and lane records belong to the run's timeline
    obs.set_trace_id(payload.get("trace_id"))
    set_origin(contract=payload.get("name"), scope=header.get("lease_id"),
               trace=payload.get("trace_id"))
    _worker_reset_scope(journal_dir, payload.get("args", {}))
    with session.lease_lock:
        session.lease_header = header
    began = time.time()
    error = None
    try:
        from mythril_tpu_torch.analysis.symbolic import SymExecWrapper
        from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
        from mythril_tpu_torch.ops import default_device
        from mythril_tpu_torch.ops.async_dispatch import get_async_dispatcher
        from mythril_tpu_torch.solidity.evmcontract import EVMContract
        from mythril_tpu_torch.support.support_args import args

        # the lease's device, resolved here: no card for "cuda" fails
        # the lease, it never runs on the CPU instead
        default_device(args.device)
        exec_timeout = payload.get("execution_timeout") or 86400
        time_handler.start_execution(exec_timeout)
        contract = EVMContract(code=payload["code"],
                               name=payload.get("name", "contract"))
        sym = SymExecWrapper(
            contract,
            address=payload["address"],
            strategy="bfs",
            max_depth=payload.get("max_depth") or 10 ** 9,
            execution_timeout=exec_timeout,
            create_timeout=payload.get("create_timeout") or 10,
            transaction_count=payload["transaction_count"],
            compulsory_statespace=False,
        )
        # a prefetch still in flight is waited for (and its failure
        # raised) here, as the analyzer does: nothing of this lease runs
        # on after its result
        get_async_dispatcher().finish()
    except Exception as exc:  # noqa: BLE001 — every error is reported:
        #                       the coordinator decides what it costs
        log.exception("worker: lease %s failed", header["lease_id"])
        error = exc
    finally:
        with session.lease_lock:
            session.lease_header = None
    if error is not None:
        session.send(_error_frame(session, header, error))
        _worker_lease_cleanup(session)
        return
    findings = CheckpointPlane._findings_snapshot()
    issues = [issue for per_module in findings["issues"].values()
              for issue in per_module]
    partial = bool(drain_requested() or get_checkpoint_plane().partial)
    if partial:
        # a drained wire lease: the coordinator leases again from the
        # boundary journal, which it has only if shipped once more
        session.ship_checkpoint(header)
    result_body = _result_dumps({
        "findings": findings,
        "spans": tracer.events() if payload.get("trace") else None,
        # the ledger's aggregates go home with the result (its records
        # stay here)
        "ledger": get_ledger().snapshot(),
    })
    session.send({
        "type": "result",
        "lease_id": header["lease_id"],
        "stamp": header["stamp"],
        "worker_id": session.worker_id,
        "trace_id": payload.get("trace_id"),
        "partial": partial,
        "found_swcs": sorted({i.swc_id for i in issues if i.swc_id}),
        "wall_s": round(time.time() - began, 3),
        # where the lease ran: what the coordinator's caller can check
        # without reading another process's device
        "pid": os.getpid(),
        "states": int(sym.laser.total_states),
        "device": _device_report(),
    }, result_body)
    _worker_lease_cleanup(session)


#: from _worker_connect_once: a redial could help (coordinator restart,
#: network blip)
_RECONNECT = -1


def _worker_connect_once(host: str, port: int, worker_id: str,
                         secret: Optional[bytes]) -> int:
    """One connect, handshake and lease-serving session: an exit code,
    or :data:`_RECONNECT`."""
    global _worker_session
    from mythril_tpu_torch.parallel import fabric
    from mythril_tpu_torch.resilience import checkpoint

    try:
        conn = socket.create_connection((host, port), timeout=30)
    except OSError as exc:
        log.warning("worker: connect to %s:%d failed: %s", host, port, exc)
        return _RECONNECT
    try:
        # the handshake under the connect timeout: a listener that
        # accepts and never answers is a failed dial, not a hang
        channel = fabric.client_handshake(conn, secret, worker_id)
        conn.settimeout(None)
    except fabric.FleetAuthError as exc:
        # a wrong secret will not fix itself
        log.error("worker: authentication failed: %s", exc)
        print(f"myth worker: authentication failed: {exc}", file=sys.stderr)
        conn.close()
        return 2
    except (fabric.FrameError, OSError) as exc:
        log.warning("worker: handshake failed: %s", exc)
        conn.close()
        return _RECONNECT
    session = _WorkerSession(worker_id, conn, channel=channel)
    _worker_session = session
    interval = {"s": 0.5}
    threading.Thread(target=session.reader_loop, name="fleet-reader",
                     daemon=True).start()
    threading.Thread(target=session.heartbeat_loop, args=(interval,),
                     name="fleet-heartbeat", daemon=True).start()
    while True:
        item = session.lease_queue.get()
        if item is None:
            return _RECONNECT if session.closed else 0
        if session.closed:
            return _RECONNECT
        header, body = item
        interval["s"] = float(header.get("heartbeat_s", 0.5))
        _worker_run_lease(session, header, body)
        if checkpoint._drain_event.is_set():
            # a signal drain is sticky: this process reported its
            # partial result and is replaced, not reused
            return 0


def worker_main(argv: Optional[List[str]] = None) -> int:
    """``python -m mythril_tpu_torch.parallel.fleet --worker`` and
    ``python3 -m mythril_tpu_torch worker``: connect (authenticated when
    a secret is configured), heartbeat, run leases until shutdown, and
    redial up to ``--reconnect`` times."""
    import argparse

    from mythril_tpu_torch.parallel import fabric
    from mythril_tpu_torch.persist.plane import get_knowledge_plane
    from mythril_tpu_torch.resilience import checkpoint
    from mythril_tpu_torch.support.env import env_int

    global _worker_session
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--connect", required=True)
    parser.add_argument("--id", required=True)
    parser.add_argument("--secret-file", default=None)
    parser.add_argument("--reconnect", type=int, default=None)
    opts = parser.parse_args(argv)
    host, _, port = opts.connect.rpartition(":")
    try:
        secret = (fabric.load_secret(opts.secret_file) if opts.secret_file
                  else fabric.resolve_secret())
    except fabric.FleetAuthError as exc:
        print(f"myth worker: {exc}", file=sys.stderr)
        return 2
    retries = (opts.reconnect if opts.reconnect is not None
               else env_int("MYTHRIL_TPU_FLEET_RECONNECT", 0, floor=0))
    checkpoint.install_signal_handlers()
    # the knowledge store loads once at seat start (inert without a
    # directory)
    plane = get_knowledge_plane()
    if plane.active:
        plane.store
    attempt = 0
    while True:
        _worker_session = None
        code = _worker_connect_once(host or "127.0.0.1", int(port), opts.id,
                                    secret)
        if code != _RECONNECT:
            return code
        if checkpoint._drain_event.is_set():
            return 0
        if _worker_session is not None:
            # a session was made and then lost: progress, not a dead
            # endpoint; the budget meters consecutive failures
            attempt = 0
        attempt += 1
        if attempt > retries:
            return 0
        time.sleep(min(5.0, 0.5 * attempt))


def reset_fleet_for_tests() -> None:
    global _worker_session
    _worker_session = None
    fleet_stats.reset()


if __name__ == "__main__":
    # ``python -m`` runs this file as a second module object: delegate to
    # the canonical import, where the svm seam looks for the session
    from mythril_tpu_torch.parallel.fleet import worker_main as _main

    sys.exit(_main())
