"""Per-request wall-clock deadline budgets (own copy of
``mythril_tpu/resilience/budget.py``).

A CLI analysis owns its process, so ``--execution-timeout`` and the
process-wide drain cover it.  An embedder that runs one analysis after
another in one process (a service, a corpus sweep) installs a budget
per request: when it expires, that request stops at a clean boundary
with a partial report while the process and the requests behind it
stay healthy.

One installed budget per process, and one predicate,
:func:`budget_expired`, which ``resilience.checkpoint.drain_requested()``
consults: everything that polls the cooperative drain (the svm
transaction loop and scheduler rounds, the dispatch gate in
``laser/batch.py``, the round ladders in ``ops/batched_sat.py`` and
``ops/dense_prop.py``) sees an expired budget as a drain, and the
report carries ``meta.resilience.partial``.  Unlike the signal drain,
an expired budget clears with :func:`clear_budget`.  The first expiry
fires one ``budget.expired`` instant and counts ``deadline_expiries``.
"""

import logging
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)


class RequestBudget:
    """One request's wall-clock allowance, anchored at install time."""

    __slots__ = ("total_s", "began", "deadline", "label", "_reported")

    def __init__(self, seconds: float, label: str = ""):
        self.total_s = float(seconds)
        self.began = time.monotonic()
        self.deadline = self.began + self.total_s
        self.label = label
        self._reported = False

    def remaining_s(self) -> float:
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.deadline


_lock = threading.Lock()
_budget: Optional[RequestBudget] = None


def install_budget(seconds: float, label: str = "") -> RequestBudget:
    """Arm a wall-clock budget for the current request.  Replaces any
    previous budget (the engine installs per request, strictly
    serially)."""
    global _budget
    budget = RequestBudget(seconds, label=label)
    with _lock:
        _budget = budget
    return budget


def clear_budget() -> None:
    global _budget
    with _lock:
        _budget = None


def current_budget() -> Optional[RequestBudget]:
    return _budget


def remaining_s() -> Optional[float]:
    """Seconds left on the installed budget; None when no budget is
    armed (CLI runs)."""
    budget = _budget
    return None if budget is None else budget.remaining_s()


def budget_expired() -> bool:
    """True once the installed budget's deadline has passed.  Hot path
    (polled per scheduler round and per ladder round): one attribute
    read + one clock read when a budget is armed, one attribute read
    when not."""
    budget = _budget
    if budget is None or not budget.expired():
        return False
    if not budget._reported:
        with _lock:
            if not budget._reported:
                budget._reported = True
                _report_expiry(budget)
    return True


def _report_expiry(budget: RequestBudget) -> None:
    from mythril_tpu_torch.resilience.telemetry import resilience_stats

    resilience_stats.deadline_expiries += 1
    try:
        from mythril_tpu_torch.observability import spans as obs

        obs.instant(
            "budget.expired", cat="serve", label=budget.label,
            budget_s=round(budget.total_s, 3),
        )
    except Exception:  # noqa: BLE001 — telemetry never breaks a drain
        pass
    log.warning(
        "request budget expired after %.2fs (%s): draining this "
        "request at the next boundary, later requests unaffected",
        budget.total_s, budget.label or "unlabeled",
    )


def reset_for_tests() -> None:
    clear_budget()
