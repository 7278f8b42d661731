"""Cross-dispatch lane coalescing: the admission queue in front of the
device dispatch path (own copy of ``mythril_tpu/ops/coalesce.py``).

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

Across requests (the serve plane, ``serve/engine.py``): the daemon keeps
one blast context warm, so the window spans requests, and the tail lanes
of one request's last underfilled dispatch merge into the next one's
first.  :func:`set_serve_mode` turns on two behaviours:

- the per-request telemetry reset (``dispatch_stats.reset()``) keeps the
  queue and the dispatched count (a hard reset still drops everything:
  the decontamination after a crashed request);
- queued lanes carry the admitting request's scope and trace id
  (:func:`set_request_scope`), so an aborted request's lanes can be
  purged (:func:`purge_scope`), and a merged dispatch that carries
  another request's lanes names their trace ids on the timeline.

Env knobs: ``MYTHRIL_TPU_COALESCE`` (0 disables, 1 forces; otherwise
``args.device_coalesce``), ``MYTHRIL_TPU_COALESCE_WINDOW`` (default 2,
or 4 in serve mode; unset, the autopilot's tuner may shrink it),
``MYTHRIL_TPU_COALESCE_FILL`` (default 0.75).
"""

import os
import time
from collections import namedtuple
from typing import Dict, List, Optional

COALESCE_WINDOW = 2       # max consecutive deferred admissions
SERVE_WINDOW = 4          # serve mode: cross-request windows run longer
COALESCE_MIN_FILL = 0.75  # dispatch once the merged bucket is this full
COALESCE_QUEUE_CAP = 256  # queued lanes beyond this are not admitted
COALESCE_MAX_AGE_S = 5.0  # a queue older than this stops deferring

#: one deferred lane: dedupe key (sorted assumption lits), the literal
#: set, the constraint nodes (for the UNSAT memo), the original
#: constraint objects (for model verification at merge time), and the
#: admitting request's scope and trace id (serve mode; None for a CLI
#: run)
QueuedLane = namedtuple(
    "QueuedLane", "key lits nodes constraints scope trace",
    defaults=(None, None),
)

_serve_mode = False
_request_scope = None
_request_trace = None


def set_serve_mode(enabled: bool) -> None:
    """Coalesce across requests (the serve daemon): per-request
    statistics resets keep the admission queue, and the deferral window
    defaults to :data:`SERVE_WINDOW`."""
    global _serve_mode
    _serve_mode = bool(enabled)


def serve_mode() -> bool:
    return _serve_mode


def set_request_scope(scope, trace_id=None) -> None:
    """Stamp lanes queued from here on with ``scope`` (the serve
    engine's request id) and ``trace_id``."""
    global _request_scope, _request_trace
    _request_scope = scope
    _request_trace = trace_id


def purge_scope(scope) -> int:
    """Drop every queued lane admitted under ``scope``; returns the
    count (an aborted request's lanes must not ride into a later
    request's dispatch)."""
    if _coalescer is None or scope is None:
        return 0
    queue = _coalescer.queue
    stale = [k for k, q in queue.items() if q.scope == scope]
    for key in stale:
        del queue[key]
    return len(stale)


def _enabled() -> bool:
    env = os.environ.get("MYTHRIL_TPU_COALESCE", "").lower()
    if env in ("0", "off", "false"):
        return False
    if env in ("1", "on", "force"):
        return True
    from mythril_tpu_torch.support.support_args import args

    return bool(getattr(args, "device_coalesce", True))


def _window() -> int:
    default = SERVE_WINDOW if _serve_mode else COALESCE_WINDOW
    if not os.environ.get("MYTHRIL_TPU_COALESCE_WINDOW", "").strip():
        # the autopilot tuner may shrink the window when its queue-depth
        # EWMA says lanes wait too long for a merged dispatch; an
        # operator pin always wins (autopilot/tuner.py)
        from mythril_tpu_torch.autopilot import knob_override

        tuned = knob_override("coalesce_window")
        if tuned is not None:
            return max(0, tuned)
    from mythril_tpu_torch.support.env import env_int

    return env_int("MYTHRIL_TPU_COALESCE_WINDOW", default, floor=0)


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

    def reset(self, keep_queue: bool = False):
        """A full reset, or with ``keep_queue`` (serve mode's per-request
        statistics reset) one that keeps the queue and the dispatched
        count, so that the cross-request window stays armed.  A
        generation move (``_sync``) always resets fully: queued lanes
        reference nodes of the dead context."""
        if not keep_queue:
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
                    key, QueuedLane(key, list(lits), nodes, cons,
                                    _request_scope, _request_trace))
            self.deferrals += 1
            dispatch_stats.coalesce_deferred += len(rep_sets)
            return None
        extras = self.drain(ctx, exclude=current)
        self.deferrals = 0
        self.dispatched += 1
        foreign = sorted({
            q.trace for q in extras
            if q.trace is not None and q.trace != _request_trace
        })
        if foreign:
            # a cross-request merge: the dispatch carries lanes minted
            # under other requests' trace ids, so neither request's
            # timeline has a silent gap
            from mythril_tpu_torch.observability import spans as obs

            obs.instant("coalesce.merge_traces", cat="dispatch",
                        traces=foreign, lanes=len(extras))
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


def reset_coalescer(hard: bool = False) -> None:
    """Reset the admission window (with the dispatch statistics).  In
    serve mode the default reset is soft (the queue and the dispatched
    count survive: the cross-request window is the daemon's point);
    ``hard`` drops everything either way (the decontamination after a
    crashed request, tests)."""
    if _coalescer is not None:
        _coalescer.reset(keep_queue=_serve_mode and not hard)
