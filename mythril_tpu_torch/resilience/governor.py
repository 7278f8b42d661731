"""Per-analysis resource governor: budgets and graceful degradation
rungs (own copy of ``mythril_tpu/resilience/governor.py``).

The drain plane (``checkpoint.py``, ``budget.py``) bounds wall-clock;
the governor bounds what a hostile contract can exhaust otherwise (open
states, interned term nodes, solver lanes, process RSS) and turns a
breach into a ladder of degradations:

====================  ==================================================
``shrink_frontier``    halve ``args.batch_width`` (min 1); restored at
                       :func:`clear_governor`
``disable_planes``     turn the symbolic lockstep tier and its memory,
                       storage and keccak planes off for the rest of the
                       analysis (``symbolic_lockstep`` reads
                       :func:`planes_disabled`)
``cap_tx_depth``       start no new transaction: the current one
                       finishes, and the verdict is partial over fewer
                       transactions
``drain_partial``      the terminal rung: :func:`drain_rung_active` makes
                       ``checkpoint.drain_requested()`` true, and every
                       cooperative boundary winds down to a partial
                       report
====================  ==================================================

Each :func:`poll` that observes a breach applies exactly the next rung,
in that order, under a lock.  Every rung counts a
``mythril_tpu_resilience_governor_*`` counter and fires a
``governor.rung`` instant; :func:`governor_meta` is the report's
``meta.resilience.governor`` block.  Budgets come from the
``MYTHRIL_TPU_GOVERNOR_*`` knobs (0 = unlimited, the default) or from
``install_governor``'s arguments; ``MYTHRIL_TPU_GOVERNOR=0`` is the kill
switch.  The ``governor_breach`` fault point forces one breach.  The
analyzer installs and clears a governor per contract, and the svm polls
it at every scheduler round and transaction boundary.
"""

import logging
import os
import threading
from typing import Optional

from mythril_tpu_torch.support.env import env_flag, env_int

log = logging.getLogger(__name__)

#: rung order IS the escalation order; every entry has a
#: ``governor_<rung>`` resilience counter
RUNGS = ("shrink_frontier", "disable_planes", "cap_tx_depth",
         "drain_partial")

#: RSS is read from /proc/self/statm at most every Nth poll — a file
#: read per scheduler round would be the governor's own overload
_RSS_POLL_PERIOD = 16

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _rss_mb() -> float:
    """Resident set size in MiB; 0.0 when unreadable (non-Linux)."""
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE_SIZE / (1 << 20)
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return resource.getrusage(
                resource.RUSAGE_SELF
            ).ru_maxrss / 1024.0
        except Exception:  # noqa: BLE001 — a blind governor still works
            return 0.0


class Governor:
    """One analysis's resource budgets and applied degradation rungs."""

    def __init__(self, max_states: int = 0, max_terms: int = 0,
                 max_lanes: int = 0, max_rss_mb: int = 0,
                 label: str = ""):
        self.max_states = max_states
        self.max_terms = max_terms
        self.max_lanes = max_lanes
        self.max_rss_mb = max_rss_mb
        self.label = label
        self.tripped: list = []       # budget names, first trip order
        self.rungs_applied: list = []
        self.breaches = 0
        self._lock = threading.Lock()
        self._polls = 0
        self._saved_batch_width: Optional[int] = None

    # -- rung predicates (hot-path reads, no lock) ---------------------

    def planes_off(self) -> bool:
        return "disable_planes" in self.rungs_applied

    def tx_capped(self) -> bool:
        return "cap_tx_depth" in self.rungs_applied

    def draining(self) -> bool:
        return "drain_partial" in self.rungs_applied

    # -- budget checks -------------------------------------------------

    def _breached(self, svm) -> list:
        """Budget names over their limit right now (possibly empty)."""
        over = []
        if self.max_states and svm is not None:
            live = len(getattr(svm, "work_list", ())) + len(
                getattr(svm, "open_states", ())
            )
            if live > self.max_states:
                over.append("states")
        if self.max_terms:
            from mythril_tpu_torch.smt import terms

            if len(terms._I.table) > self.max_terms:
                over.append("terms")
        if self.max_lanes:
            from mythril_tpu_torch.ops.batched_sat import dispatch_stats

            if dispatch_stats.lanes > self.max_lanes:
                over.append("lanes")
        if self.max_rss_mb and self._polls % _RSS_POLL_PERIOD == 1:
            if _rss_mb() > self.max_rss_mb:
                over.append("rss")
        return over

    def poll(self, svm=None) -> Optional[str]:
        """One breach check at a cooperative boundary.  Returns the
        rung applied this poll (None when nothing breached or the
        ladder is exhausted).  The ``governor_breach`` fault point
        forces one breach observation."""
        from mythril_tpu_torch.resilience import faults

        self._polls += 1
        over = self._breached(svm)
        if faults.maybe_fault_governor():
            over = over or ["injected"]
        if not over:
            return None
        with self._lock:
            self.breaches += 1
            for name in over:
                if name not in self.tripped:
                    self.tripped.append(name)
            rung = next(
                (r for r in RUNGS if r not in self.rungs_applied), None
            )
            if rung is None:
                return None  # fully degraded; the drain rung is doing its job
            self.rungs_applied.append(rung)
        self._apply(rung, over)
        return rung

    # -- rung effects --------------------------------------------------

    def _apply(self, rung: str, over: list) -> None:
        from mythril_tpu_torch.resilience.telemetry import resilience_stats

        resilience_stats.governor_breaches += 1
        setattr(resilience_stats, f"governor_{rung}",
                getattr(resilience_stats, f"governor_{rung}") + 1)
        if rung == "shrink_frontier":
            from mythril_tpu_torch.support.support_args import args

            width = max(1, getattr(args, "batch_width", 1))
            if self._saved_batch_width is None:
                self._saved_batch_width = width
            args.batch_width = max(1, width // 2)
        elif rung == "drain_partial":
            # mark the checkpoint plane partial directly too: the flag
            # must survive clear_governor(), which runs before the
            # report is rendered
            from mythril_tpu_torch.resilience.checkpoint import (
                get_checkpoint_plane,
            )

            get_checkpoint_plane().partial = True
        log.warning(
            "governor: budget breach (%s) on %s — applying rung %r "
            "(ladder so far: %s)",
            "/".join(over), self.label or "analysis", rung,
            "->".join(self.rungs_applied),
        )
        try:
            from mythril_tpu_torch.observability import spans as obs

            obs.instant("governor.rung", cat="resilience", rung=rung,
                        tripped="/".join(over), label=self.label)
        except Exception:  # noqa: BLE001 — telemetry never blocks a rung
            pass

    def restore(self) -> None:
        """Undo the process-global effects (batch width) at clear."""
        if self._saved_batch_width is not None:
            from mythril_tpu_torch.support.support_args import args

            args.batch_width = self._saved_batch_width
            self._saved_batch_width = None

    def meta(self) -> Optional[dict]:
        """The ``meta.resilience.governor`` block; None when the
        governor never breached (absent-not-null in reports)."""
        if not self.breaches:
            return None
        budgets = {}
        if self.max_states:
            budgets["states"] = self.max_states
        if self.max_terms:
            budgets["terms"] = self.max_terms
        if self.max_lanes:
            budgets["lanes"] = self.max_lanes
        if self.max_rss_mb:
            budgets["rss_mb"] = self.max_rss_mb
        return {
            "tripped": list(self.tripped),
            "rungs": list(self.rungs_applied),
            "breaches": self.breaches,
            "budgets": budgets,
        }


_lock = threading.Lock()
_governor: Optional[Governor] = None
#: the last cleared governor's meta, so the report (rendered after
#: clear_governor) can still carry the block for THIS contract
_last_meta: Optional[dict] = None


def install_governor(max_states: Optional[int] = None,
                     max_terms: Optional[int] = None,
                     max_lanes: Optional[int] = None,
                     max_rss_mb: Optional[int] = None,
                     label: str = "") -> Optional[Governor]:
    """Arm the governor for the current analysis.  Explicit arguments
    win; unset ones come from the ``MYTHRIL_TPU_GOVERNOR_*`` knobs
    (0 = that budget unlimited).  ``MYTHRIL_TPU_GOVERNOR=0`` is the
    kill switch: nothing installs and every seam no-ops."""
    global _governor, _last_meta
    if not env_flag("MYTHRIL_TPU_GOVERNOR", True):
        with _lock:
            _governor = None
        return None
    governor = Governor(
        max_states=max_states if max_states is not None else env_int(
            "MYTHRIL_TPU_GOVERNOR_STATES", 0, floor=0),
        max_terms=max_terms if max_terms is not None else env_int(
            "MYTHRIL_TPU_GOVERNOR_TERMS", 0, floor=0),
        max_lanes=max_lanes if max_lanes is not None else env_int(
            "MYTHRIL_TPU_GOVERNOR_LANES", 0, floor=0),
        max_rss_mb=max_rss_mb if max_rss_mb is not None else env_int(
            "MYTHRIL_TPU_GOVERNOR_RSS_MB", 0, floor=0),
        label=label,
    )
    with _lock:
        _governor = governor
        _last_meta = None
    return governor


def clear_governor() -> None:
    """Disarm and restore global effects; the meta block survives
    until the next install so the report can still ship it."""
    global _governor, _last_meta
    with _lock:
        governor = _governor
        _governor = None
    if governor is not None:
        governor.restore()
        _last_meta = governor.meta()


def current_governor() -> Optional[Governor]:
    return _governor


def poll(svm=None) -> Optional[str]:
    """Module-level poll seam (svm loops): no-op when disarmed."""
    governor = _governor
    return None if governor is None else governor.poll(svm)


def planes_disabled() -> bool:
    """True once the ``disable_planes`` rung applied — consulted by
    symbolic_lockstep before engaging the batched tier."""
    governor = _governor
    return governor is not None and governor.planes_off()


def tx_depth_capped() -> bool:
    """True once the ``cap_tx_depth`` rung applied — consulted at the
    transaction start boundary."""
    governor = _governor
    return governor is not None and governor.tx_capped()


def drain_rung_active() -> bool:
    """True once the terminal ``drain_partial`` rung applied —
    consulted by ``checkpoint.drain_requested()`` alongside the signal
    flag and the wall-clock budget."""
    governor = _governor
    return governor is not None and governor.draining()


def governor_meta() -> Optional[dict]:
    """The report's governor block: the armed governor's meta, or the
    last cleared one's (reports render after clear_governor)."""
    governor = _governor
    if governor is not None:
        return governor.meta()
    return _last_meta


def reset_for_tests() -> None:
    global _governor, _last_meta
    with _lock:
        _governor = None
        _last_meta = None
