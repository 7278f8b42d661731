"""Online knob tuner: bounded steps, automatic revert-on-regression
(own copy of ``mythril_tpu/autopilot/tuner.py``).

Bitwuzla's SMT-COMP postmortems (arxiv 2006.01621) show no single
solver configuration wins across benchmark families — so the funnel's
static knobs (frontier FAN/PERIOD, tier period, coalesce window) leave
performance on the table for any workload the defaults weren't tuned
on.  This tuner closes the loop from the live signals the X-ray
already publishes:

- the ledger's ``tier_decided_pct`` tail share (the headline gate —
  lanes leaking to the host CDCL is THE regression signal), and
- the coalescer's admission-queue depth.

Operation is deliberately conservative:

- **operator pins win** — a knob whose env var is explicitly set is
  never touched;
- **one bounded step at a time** — knobs advance round-robin, each by
  its fixed step within [lo, hi], never two knobs in one window;
- **revert-on-regression** — after every step the tuner watches one
  evaluation window (EVAL_EVERY ledgered batches); if the tail-share
  EWMA worsened by more than REVERT_TOL points the step is undone and
  the knob sits out a cooldown;
- **no environ mutation** — tuned values live here and are consulted
  by the knob getters via ``autopilot.knob_override``; killing the
  autopilot (MYTHRIL_TPU_AUTOPILOT=0) therefore restores the exact
  static values instantly.
"""

import threading
from typing import Dict, NamedTuple, Optional

from mythril_tpu_torch.support.env import env_int

#: EWMA smoothing for the observed series
ALPHA = 0.3
#: tail-share percentage-point worsening that triggers a revert
REVERT_TOL = 2.0
#: evaluation windows a reverted knob sits out
COOLDOWN_WINDOWS = 4
#: queue-depth EWMA past which the coalesce window is considered
#: oversized (lanes waiting too long for a merged dispatch)
QUEUE_DEEP = 8.0


def eval_every() -> int:
    """Ledgered batches per evaluation window."""
    return env_int("MYTHRIL_TPU_AUTOPILOT_EVAL_EVERY", 8, floor=1)


class Knob(NamedTuple):
    env: str        # the operator pin that freezes this knob
    default: int
    lo: int
    hi: int
    step: int       # bounded per-window step
    direction: int  # preferred sign when chasing tail share down


#: every knob the tuner may touch.  The tuner only ever publishes an
#: override, never a default: the getters keep theirs.
KNOBS: Dict[str, Knob] = {
    "frontier_fan": Knob(
        "MYTHRIL_TPU_FRONTIER_FAN", 16, 4, 64, 8, +1),
    "frontier_period": Knob(
        "MYTHRIL_TPU_FRONTIER_PERIOD", 8, 2, 32, 2, -1),
    "tier_period": Knob(
        "MYTHRIL_TPU_TIER_PERIOD", 8, 2, 32, 2, -1),
    "coalesce_window": Knob(
        "MYTHRIL_TPU_COALESCE_WINDOW", 2, 0, 8, 1, -1),
}


class OnlineTuner:
    """One per Autopilot instance (process-wide in practice)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._overrides: Dict[str, int] = {}
        self._pinned: Dict[str, bool] = {}
        self.tail_ewma: Optional[float] = None
        self.queue_ewma = 0.0
        self._batches = 0
        self._order = list(KNOBS)
        self._next = 0
        self._pending: Optional[tuple] = None  # (knob, prev, baseline)
        self._cooldown: Dict[str, int] = {}
        self.adjustments = 0
        self.reverts = 0

    # -- the getter-side API ------------------------------------------

    def override(self, name: str) -> Optional[int]:
        return self._overrides.get(name)

    # -- the observation side -----------------------------------------

    def observe(self, tail_pct: Optional[float],
                queue_depth: int) -> None:
        """One ledgered batch closed.  ``tail_pct`` is the ledger's
        current tail share (None until anything settled)."""
        with self._lock:
            if tail_pct is not None:
                self.tail_ewma = (
                    tail_pct if self.tail_ewma is None
                    else (1 - ALPHA) * self.tail_ewma + ALPHA * tail_pct
                )
            self.queue_ewma = (
                (1 - ALPHA) * self.queue_ewma + ALPHA * queue_depth
            )
            self._batches += 1
            if self._batches % eval_every() == 0:
                self._evaluate_locked()

    def _pinned_by_operator(self, knob: Knob) -> bool:
        import os

        pinned = self._pinned.get(knob.env)
        if pinned is None:
            pinned = bool(os.environ.get(knob.env, "").strip())
            self._pinned[knob.env] = pinned
        return pinned

    def _evaluate_locked(self) -> None:
        # settle the in-flight step first: keep or revert
        if self._pending is not None:
            name, prev, baseline = self._pending
            self._pending = None
            worsened = (
                self.tail_ewma is not None and baseline is not None
                and self.tail_ewma > baseline + REVERT_TOL
            )
            if worsened:
                if prev is None:
                    self._overrides.pop(name, None)
                else:
                    self._overrides[name] = prev
                self._cooldown[name] = COOLDOWN_WINDOWS
                self.reverts += 1
                return  # let the revert settle before stepping again
        if self.tail_ewma is None:
            return  # nothing to chase yet
        for name in list(self._cooldown):
            self._cooldown[name] -= 1
            if self._cooldown[name] <= 0:
                del self._cooldown[name]
        # pick the next eligible knob round-robin
        for _ in range(len(self._order)):
            name = self._order[self._next % len(self._order)]
            self._next += 1
            knob = KNOBS[name]
            if name in self._cooldown or self._pinned_by_operator(knob):
                continue
            current = self._overrides.get(name, knob.default)
            direction = knob.direction
            if name == "coalesce_window":
                # queue-driven: deep queue -> dispatch sooner; shallow
                # queue leaves the window alone entirely
                if self.queue_ewma < QUEUE_DEEP:
                    continue
                direction = -1
            proposed = max(knob.lo,
                           min(knob.hi, current + direction * knob.step))
            if proposed == current:
                continue
            self._pending = (
                name, self._overrides.get(name), self.tail_ewma,
            )
            self._overrides[name] = proposed
            self.adjustments += 1
            return

    # -- introspection -------------------------------------------------

    def debug_state(self) -> dict:
        with self._lock:
            return {
                "tail_ewma": (
                    round(self.tail_ewma, 2)
                    if self.tail_ewma is not None else None
                ),
                "queue_ewma": round(self.queue_ewma, 2),
                "batches": self._batches,
                "overrides": dict(self._overrides),
                "pending": (
                    self._pending[0] if self._pending else None
                ),
                "cooldown": dict(self._cooldown),
                "adjustments": self.adjustments,
                "reverts": self.reverts,
            }
