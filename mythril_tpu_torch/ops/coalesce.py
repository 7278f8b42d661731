"""Cross-dispatch lane coalescing: the admission queue in front of the
device dispatch path (own copy of ``mythril_tpu/ops/coalesce.py``,
without the serve plane's request scopes and trace ids, and without the
autopilot's window override).

The symbolic executor presents frontier batches one after another, so
the only way to fill a lane bucket across scheduler rounds is a short
admission window:

- a batch that would badly underfill its lane bucket is DEFERRED: its
  deduped lanes go into the queue and the round's verdicts fall back to
  the CDCL tail (what an undecided device lane does);
- the next batch of the same blast-context generation merges the queue
  into its own dispatch, filling bucket slots that would have been
  padding.  Merged lanes' verdicts land in the UNSAT-memo / nogood /
  remembered-model channels (the async harvest's contract), so when the
  frontier presents those sets again the host skips the solve;
- the window is bounded three ways (consecutive deferrals, queue age,
  queue size), and a context's FIRST batch is never deferred.

The queue also feeds the async prefetch: when the profit gate declines
a frontier and launches it as an idle-time prefetch, queued lanes ride
along to fill that bucket too.

Env knobs: ``MYTHRIL_TPU_COALESCE`` (0 disables, 1 forces; otherwise
``args.device_coalesce``), ``MYTHRIL_TPU_COALESCE_WINDOW`` (default 2),
``MYTHRIL_TPU_COALESCE_FILL`` (default 0.75).
"""

import os
import time
from collections import namedtuple
from typing import Dict, List, Optional

COALESCE_WINDOW = 2       # max consecutive deferred admissions
COALESCE_MIN_FILL = 0.75  # dispatch once the merged bucket is this full
COALESCE_QUEUE_CAP = 256  # queued lanes beyond this are not admitted
COALESCE_MAX_AGE_S = 5.0  # a queue older than this stops deferring

#: one deferred lane: dedupe key (sorted assumption lits), the literal
#: set, the constraint nodes (for the UNSAT memo) and the original
#: constraint objects (for model verification at merge time)
QueuedLane = namedtuple("QueuedLane", "key lits nodes constraints")


def _enabled() -> bool:
    env = os.environ.get("MYTHRIL_TPU_COALESCE", "").lower()
    if env in ("0", "off", "false"):
        return False
    if env in ("1", "on", "force"):
        return True
    from mythril_tpu_torch.support.support_args import args

    return bool(getattr(args, "device_coalesce", True))


def _window() -> int:
    if not os.environ.get("MYTHRIL_TPU_COALESCE_WINDOW", "").strip():
        # the autopilot tuner may shrink the window when its queue-depth
        # EWMA says lanes wait too long for a merged dispatch; an
        # operator pin always wins (autopilot/tuner.py)
        from mythril_tpu_torch.autopilot import knob_override

        tuned = knob_override("coalesce_window")
        if tuned is not None:
            return max(0, tuned)
    from mythril_tpu_torch.support.env import env_int

    return env_int("MYTHRIL_TPU_COALESCE_WINDOW", COALESCE_WINDOW, floor=0)


def _min_fill() -> float:
    from mythril_tpu_torch.support.env import env_float

    return env_float("MYTHRIL_TPU_COALESCE_FILL", COALESCE_MIN_FILL,
                     floor=0.0)


class LaneCoalescer:
    """Generation-scoped admission queue (one per process, matching the
    one-dispatch-at-a-time host loop; reset whenever the blast context
    generation moves on)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.generation = -1
        self.queue: Dict[tuple, QueuedLane] = {}
        self.dispatched = 0  # dispatches admitted this generation
        self.oldest_s = 0.0  # when the oldest queued lane arrived
        self.deferrals = 0   # consecutive deferred admissions

    def _sync(self, ctx):
        if self.generation != ctx.generation:
            self.reset()
            self.generation = ctx.generation

    def admit(self, ctx, rep_sets, rep_nodes, rep_constraints,
              force_now: bool = False) -> Optional[List[QueuedLane]]:
        """Admission decision for a ready-to-dispatch deduped batch.

        Returns ``None`` to DEFER (the caller leaves this round to the
        CDCL tail; the lanes wait in the queue), or the list of queued
        extras to merge into the dispatch (possibly empty).  A batch is
        deferred only when (a) coalescing is enabled, (b) it is not the
        context's first batch, (c) the deferral window and queue age
        allow, and (d) even merged with the queue it would underfill
        its lane bucket.
        """
        self._sync(ctx)
        from mythril_tpu_torch.ops.batched_sat import (
            dispatch_stats, lane_bucket,
        )

        keys = [tuple(sorted(lits)) for lits in rep_sets]
        current = set(keys)
        extras_avail = sum(1 for k in self.queue if k not in current)
        n_merged = len(rep_sets) + extras_avail
        bucket = lane_bucket(max(1, n_merged), floor=8)
        underfilled = n_merged < _min_fill() * bucket
        stale = bool(self.queue) and (
            time.monotonic() - self.oldest_s > COALESCE_MAX_AGE_S
        )
        if (
            _enabled()
            and not force_now
            and self.dispatched >= 1
            and self.deferrals < _window()
            and underfilled
            and not stale
            and len(self.queue) + len(rep_sets) <= COALESCE_QUEUE_CAP
        ):
            if not self.queue:
                self.oldest_s = time.monotonic()
            for key, lits, nodes, cons in zip(
                keys, rep_sets, rep_nodes, rep_constraints
            ):
                self.queue.setdefault(
                    key, QueuedLane(key, list(lits), nodes, cons))
            self.deferrals += 1
            dispatch_stats.coalesce_deferred += len(rep_sets)
            return None
        extras = self.drain(ctx, exclude=current)
        self.deferrals = 0
        self.dispatched += 1
        return extras

    def drain(self, ctx, exclude=frozenset()) -> List[QueuedLane]:
        """Pop every queued lane not covered by ``exclude`` (lanes the
        current batch already carries are dropped: their merged twin
        answers for them)."""
        self._sync(ctx)
        extras = [q for k, q in self.queue.items() if k not in exclude]
        self.queue.clear()
        return extras

    def requeue(self, ctx, extras: List[QueuedLane]) -> None:
        """Put drained lanes back (a prefetch launch that never went in
        flight must not silently drop them)."""
        self._sync(ctx)
        for q in extras:
            if len(self.queue) < COALESCE_QUEUE_CAP:
                self.queue.setdefault(q.key, q)
        if self.queue and not self.oldest_s:
            self.oldest_s = time.monotonic()


_coalescer: Optional[LaneCoalescer] = None


def get_coalescer() -> LaneCoalescer:
    global _coalescer
    if _coalescer is None:
        _coalescer = LaneCoalescer()
    return _coalescer


def reset_coalescer() -> None:
    """Reset the admission window (with the dispatch statistics)."""
    if _coalescer is not None:
        _coalescer.reset()
