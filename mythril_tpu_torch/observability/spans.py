"""Hierarchical spans: the tracer of the observability plane (own copy
of ``mythril_tpu/observability/spans.py``).

One process-wide :class:`Tracer` records *spans* (named, timed regions
with thread-local nesting), *instant events* and counter samples, and
exports them as Chrome/Perfetto ``trace_event`` JSON
(``python3 -m mythril_tpu_torch analyze --trace-out FILE``).  The span
taxonomy covers the pipeline — CLI → analyzer → svm transactions →
frontier pruning → the funnel's tiers → solver rounds → H2D uploads →
the CDCL tail — so a slow analysis is attributable to a *layer*, not
just a counter delta.

Design constraints, in order:

1. **Disabled paths are near-zero-cost.**  ``span()`` with no stats
   sink returns a module-level no-op singleton after a single attribute
   check — no allocation, no clock read.  ``instant()`` is one check
   and a return.  The kill switch ``MYTHRIL_TPU_TRACE=0`` wins over
   every programmatic ``enable()``.
2. **Spans are the timing primitive.**  Call sites that must keep
   feeding wall-clock counters even when tracing is off (the
   ``SolverStatistics`` split, ``DispatchStats.device_s``) pass
   ``sink=(obj, field)``: the span always times and accumulates into
   the sink, and *additionally* lands on the timeline when tracing is
   on — one clock pair, two consumers, so ``--trace-out`` and the bench
   breakdown can never disagree.
3. **Bounded memory.**  The event buffer is capped
   (``MYTHRIL_TPU_TRACE_CAP``, default 200k events); overflow drops the
   event (counted in ``dropped``) but still updates the per-name totals
   that back :func:`phase_totals`.  The flight recorder
   (observability/flight.py) keeps its own ring of the most recent
   events independent of this cap.
4. **Profiler ranges stay where they were.**  A span opened with
   ``profile=True`` also opens a ``torch.profiler.record_function``
   range of the same name, whether or not tracing is on, so the
   profiler's view of the solver tiers (``tier.dense``,
   ``resident.solve``, ``funnel.*``, ...) keeps its boundaries.  No span
   synchronizes the card: where a span must cover device time, the code
   inside it ends with a host read.

Thread model: events append under one lock; span *stacks* are
thread-local, so nesting/parent attribution is correct per thread and
Perfetto renders each thread's track from ts/dur containment.
"""

import json
import os
import threading
import time
import uuid
from typing import Dict, Optional

from torch.profiler import record_function

#: event-buffer cap (events beyond it are dropped, counted, and still
#: totaled); override with MYTHRIL_TPU_TRACE_CAP
TRACE_CAP = 200_000

#: span-name prefixes -> bench phase buckets (cone / upload / sweep /
#: tail).  Leaf names only: enclosing spans (dispatch.batch_check,
#: svm.transaction) would double-count their children.
PHASE_PREFIXES = (
    ("cone.", "cone"),
    ("solver.cone", "cone"),
    ("upload.", "upload"),
    ("dispatch.round", "sweep"),
    ("dense.rounds", "sweep"),
    ("cdcl.solve", "tail"),
    ("word.", "word"),
    ("frontier.round", "frontier"),
    ("svm.segment", "lockstep"),
)
PHASE_KEYS = ("cone", "upload", "sweep", "tail", "word", "frontier",
              "lockstep")


def _kill_switched() -> bool:
    return os.environ.get("MYTHRIL_TPU_TRACE", "").lower() in (
        "0", "off", "false",
    )


def _env_cap() -> int:
    try:
        return max(1024, int(os.environ.get("MYTHRIL_TPU_TRACE_CAP",
                                            TRACE_CAP)))
    except ValueError:
        return TRACE_CAP


class _NoopSpan:
    """Shared no-op span: returned (never allocated) on every disabled
    ``span()`` call without a sink."""

    __slots__ = ()
    elapsed_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, func):  # decorator form stays a no-op wrapper
        return func


_NOOP = _NoopSpan()


class _StatSpan:
    """Sink-only span: times the region and accumulates into
    ``sink=(obj, field)`` — the disabled-tracing replacement for the old
    ad-hoc ``time.monotonic()`` pairs, same cost (one clock pair)."""

    __slots__ = ("_sink", "_t0", "elapsed_s")

    def __init__(self, sink):
        self._sink = sink
        self.elapsed_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self._t0
        obj, field = self._sink
        setattr(obj, field, getattr(obj, field) + self.elapsed_s)
        return False


class _Span:
    """Recording span: one completed ``ph: "X"`` trace event."""

    __slots__ = ("_tracer", "name", "cat", "_sink", "_attrs", "_t0_ns",
                 "elapsed_s")

    def __init__(self, tracer, name, cat, sink, attrs):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self._sink = sink
        self._attrs = attrs
        self.elapsed_s = 0.0

    def __enter__(self):
        stack = self._tracer._stack()
        if stack:
            self._attrs = dict(self._attrs or ())
            self._attrs.setdefault("parent", stack[-1])
        stack.append(self.name)
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur_ns = time.perf_counter_ns() - self._t0_ns
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        self.elapsed_s = dur_ns / 1e9
        if self._sink is not None:
            obj, field = self._sink
            setattr(obj, field, getattr(obj, field) + self.elapsed_s)
        if exc_type is not None:
            self._attrs = dict(self._attrs or ())
            self._attrs["error"] = exc_type.__name__
        self._tracer._record_span(
            self.name, self.cat, self._t0_ns, dur_ns, self._attrs
        )
        return False


class Tracer:
    """Process-wide span/instant recorder (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._epoch_ns = time.perf_counter_ns()
        self._events = []
        self._cap = _env_cap()
        self._totals: Dict[str, float] = {}  # name -> cumulative seconds
        self._counts: Dict[str, int] = {}    # name -> completed spans
        # thread ident -> that thread's span stack (the list itself,
        # registered once per thread; the serve plane's /debug/requests
        # reads it without touching the hot path)
        self._all_stacks: Dict[int, list] = {}
        # the run's trace identity, minted at the CLI edge and carried
        # to the fleet's workers in the lease payload
        self.trace_id: Optional[str] = None
        # the synthetic pids of absorbed worker streams, by worker name:
        # a respawned worker reusing an earlier one's OS pid must not
        # merge into its track
        self._absorbed_pids: Dict[str, int] = {}
        self.span_count = 0
        self.instant_count = 0
        self.dropped = 0
        self.record_events = True
        # enabled only on an explicit opt-in: env MYTHRIL_TPU_TRACE
        # truthy, --trace-out (observability.configure_from_cli), or a
        # programmatic enable().  The kill switch wins.
        env = os.environ.get("MYTHRIL_TPU_TRACE", "").lower()
        self.enabled = env in ("1", "on", "true") and not _kill_switched()

    # -- control -------------------------------------------------------

    def enable(self, record_events: bool = True) -> bool:
        """Turn tracing on (False when the ``MYTHRIL_TPU_TRACE=0`` kill
        switch vetoes it).  ``record_events=False`` keeps only the
        per-name totals/counts (the phase breakdown without the event
        buffer)."""
        if _kill_switched():
            return False
        self.enabled = True
        self.record_events = record_events
        return True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop events, totals, and counters; keeps enablement."""
        with self._lock:
            self._events = []
            self._totals = {}
            self._counts = {}
            self.span_count = 0
            self.instant_count = 0
            self.dropped = 0
            self._epoch_ns = time.perf_counter_ns()

    # -- recording -----------------------------------------------------

    def _stack(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
            self._all_stacks[threading.get_ident()] = stack
        return stack

    def live_spans(self) -> Dict[int, str]:
        """Each thread's innermost open span name (the serve plane's
        ``/debug/requests`` phase).  Read without the lock: a torn read
        can at worst name a span that has just closed."""
        out = {}
        for tid, stack in list(self._all_stacks.items()):
            if stack:
                out[tid] = stack[-1]
        return out

    def _record_span(self, name, cat, t0_ns, dur_ns, attrs) -> None:
        event = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1e3,  # microseconds
            "dur": dur_ns / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if attrs:
            event["args"] = attrs
        with self._lock:
            self.span_count += 1
            self._totals[name] = self._totals.get(name, 0.0) + dur_ns / 1e9
            self._counts[name] = self._counts.get(name, 0) + 1
            if self.record_events:
                if len(self._events) < self._cap:
                    self._events.append(event)
                else:
                    self.dropped += 1
        from mythril_tpu_torch.observability.flight import get_flight_recorder

        get_flight_recorder().record(event)

    def record_instant(self, name, cat, attrs) -> None:
        event = {
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "p",  # process-scoped instant marker
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if attrs:
            event["args"] = attrs
        with self._lock:
            self.instant_count += 1
            if self.record_events:
                if len(self._events) < self._cap:
                    self._events.append(event)
                else:
                    self.dropped += 1
        from mythril_tpu_torch.observability.flight import get_flight_recorder

        get_flight_recorder().record(event)

    def record_counter(self, name: str, values: dict) -> None:
        """Perfetto counter track (``ph: "C"``): live lanes, frontier
        queue depth, resident-pool rows ride the trace as numeric
        series alongside the spans."""
        event = {
            "name": name,
            "cat": "counter",
            "ph": "C",
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": {k: float(v) for k, v in values.items()},
        }
        with self._lock:
            if self.record_events:
                if len(self._events) < self._cap:
                    self._events.append(event)
                else:
                    self.dropped += 1

    # -- export / aggregation ------------------------------------------

    def absorb_events(self, events: list, worker: Optional[str] = None,
                      trace_id: Optional[str] = None) -> int:
        """Merge trace events made in another process (a fleet worker's
        span stream) into the buffer, so that ``--trace-out`` renders one
        timeline.  The per-name totals are not updated: they describe
        this process's wall, which spent the worker's time waiting.

        ``worker`` names the stream: its events move to a synthetic pid
        of that worker's (1,000,001 up), labelled by a ``process_name``
        metadata event; ``trace_id`` re-parents the stream under the
        run's trace (every absorbed event gains ``args.trace_id``).
        Returns the number absorbed."""
        absorbed = 0
        remap_pid = None
        with self._lock:
            if worker is not None:
                remap_pid = self._absorbed_pids.get(worker)
                if remap_pid is None:
                    remap_pid = 1_000_000 + len(self._absorbed_pids) + 1
                    self._absorbed_pids[worker] = remap_pid
                    if self.record_events and len(self._events) < self._cap:
                        label = f"fleet-worker {worker}"
                        if trace_id:
                            label += f" [trace {trace_id}]"
                        self._events.append({
                            "name": "process_name", "ph": "M",
                            "pid": remap_pid, "tid": 0,
                            "args": {"name": label},
                        })
            for event in events:
                if not isinstance(event, dict) or "ph" not in event:
                    continue
                if remap_pid is not None or trace_id is not None:
                    event = dict(event)
                    if remap_pid is not None:
                        event["pid"] = remap_pid
                    if trace_id is not None:
                        args = dict(event.get("args") or {})
                        args["trace_id"] = trace_id
                        event["args"] = args
                if len(self._events) < self._cap:
                    if self.record_events:
                        self._events.append(event)
                    self.span_count += int(event.get("ph") == "X")
                    self.instant_count += int(event.get("ph") == "i")
                    absorbed += 1
                else:
                    self.dropped += 1
        return absorbed

    def add_external_total(self, name: str, seconds: float) -> None:
        """Count wall time measured outside this process (a fleet
        worker's lease wall) under a span name, in the totals and counts
        only."""
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + seconds
            self._counts[name] = self._counts.get(name, 0) + 1

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def totals_snapshot(self) -> Dict[str, float]:
        """Per-name cumulative span seconds (copy)."""
        with self._lock:
            return dict(self._totals)

    def counts_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def export_chrome(self, path: str) -> str:
        """Write the Chrome/Perfetto ``trace_event`` JSON.  The object
        form (``{"traceEvents": [...]}``) is used so metadata rides
        alongside without breaking loaders.  When the buffer cap
        dropped events, a ``trace.truncated`` instant marks the
        timeline itself — a consumer must not mistake a capped trace
        for a complete one (the registry's
        ``mythril_tpu_trace_dropped_events`` counter carries the same
        number)."""
        events = self.events()
        if self.dropped:
            last_ts = max(
                (e.get("ts", 0.0) for e in events if "ts" in e),
                default=0.0,
            )
            events.append({
                "name": "trace.truncated", "cat": "meta", "ph": "i",
                "s": "g", "ts": last_ts, "pid": os.getpid(), "tid": 0,
                "args": {"dropped_events": int(self.dropped),
                         "cap": int(self._cap)},
            })
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "mythril-tpu observability plane",
                "span_events": self.span_count,
                "instant_events": self.instant_count,
                "dropped_events": self.dropped,
                "trace_id": self.trace_id,
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
        return path


class _ProfiledSpan:
    """A span inside a ``record_function`` range of its own name."""

    __slots__ = ("_range", "_inner")

    def __init__(self, name, inner):
        self._range = record_function(name)
        self._inner = inner

    @property
    def elapsed_s(self):
        return self._inner.elapsed_s

    def __enter__(self):
        self._range.__enter__()
        self._inner.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._inner.__exit__(*exc)
        finally:
            self._range.__exit__(*exc)
        return False


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def span(name: str, sink=None, cat: str = "pipeline",
         profile: bool = False, **attrs):
    """Context manager timing a named region.

    Disabled + no sink: returns the shared no-op singleton (one
    attribute check, no allocation).  ``sink=(obj, field)`` always
    times and accumulates ``field += elapsed`` on exit — use it where a
    wall-clock counter must keep working with tracing off.
    ``profile=True`` wraps the span in a ``record_function`` range of
    the same name (tracing on or off)."""
    tracer = _tracer
    if not tracer.enabled:
        inner = _NOOP if sink is None else _StatSpan(sink)
    else:
        inner = _Span(tracer, name, cat, sink, attrs)
    return _ProfiledSpan(name, inner) if profile else inner


def instant(name: str, cat: str = "event", **attrs) -> None:
    """Record an instant event (watchdog trip, fault, demotion,
    checkpoint write) on the timeline.  No-op when tracing is off."""
    tracer = _tracer
    if not tracer.enabled:
        return
    tracer.record_instant(name, cat, attrs)


def counter(name: str, **values) -> None:
    """Record a Perfetto counter-track sample (live lanes, frontier
    queue depth, pool rows).  No-op when tracing is off — one attribute
    check, same contract as :func:`instant`."""
    tracer = _tracer
    if not tracer.enabled:
        return
    tracer.record_counter(name, values)


def new_trace_id() -> str:
    """Mint a run's trace identity (hex), once at the CLI edge."""
    return uuid.uuid4().hex[:16]


def set_trace_id(trace_id: Optional[str]) -> None:
    _tracer.trace_id = trace_id


def get_trace_id() -> Optional[str]:
    return _tracer.trace_id


def traced(name: str, cat: str = "pipeline"):
    """Decorator form of :func:`span`."""

    def wrap(func):
        def inner(*args, **kwargs):
            with span(name, cat=cat):
                return func(*args, **kwargs)

        inner.__name__ = getattr(func, "__name__", name)
        inner.__doc__ = func.__doc__
        return inner

    return wrap


def totals_snapshot() -> Dict[str, float]:
    return _tracer.totals_snapshot()


def phase_totals(totals: Optional[Dict[str, float]] = None,
                 base: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Fold per-name span totals into the bench phase buckets
    (cone/upload/sweep/tail seconds).  ``base`` subtracts an earlier
    :func:`totals_snapshot` so callers can scope the breakdown to one
    contract."""
    if totals is None:
        totals = _tracer.totals_snapshot()
    out = {key: 0.0 for key in PHASE_KEYS}
    for name, seconds in totals.items():
        if base:
            seconds -= base.get(name, 0.0)
        if seconds <= 0.0:
            continue
        for prefix, key in PHASE_PREFIXES:
            if name.startswith(prefix):
                out[key] += seconds
                break
    return {f"{key}_s": round(value, 4) for key, value in out.items()}


def reset_for_tests() -> None:
    global _tracer
    _tracer = Tracer()
