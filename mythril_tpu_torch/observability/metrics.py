"""Unified metrics registry (own copy of
``mythril_tpu/observability/metrics.py``): one process-wide home for
every named counter/gauge/histogram, dumpable in Prometheus text format
(``python3 -m mythril_tpu_torch analyze --metrics-out FILE``).

- the port's counter bags keep their hot mutable fields (incremented
  all over the dispatch path) and are absorbed at *render time* by
  registered collectors: ``DispatchStats`` (``ops/batched_sat.py``,
  every numeric field, the tiers' seconds among them) as
  ``mythril_tpu_dispatch_*`` and ``AsyncStats``
  (``ops/async_dispatch.py``) as ``mythril_tpu_async_*``;
- the resilience counters live here as registry counters
  (``mythril_tpu_resilience_*``; ``resilience/telemetry.py`` is the
  attribute API over them), one source of truth for the dump, the
  dispatch stats and the report;
- the lane ledger and the autopilot mirror their aggregates as
  ``mythril_tpu_ledger_*`` / ``mythril_tpu_autopilot_*``;
- the tracer and the flight recorder report their own meta-counters
  (``mythril_tpu_trace_*``).

Render-time dedupe guarantees each metric name appears exactly once in
a dump even if a collector misbehaves.  The module imports nothing of
the package at module load.
"""

import threading
from typing import Callable, Dict, List, Optional, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                    60.0)


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, float) and value == int(value) and (
        abs(value) < 1e15
    ):
        return str(int(value))
    return repr(value) if isinstance(value, float) else str(value)


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, newline
    and double-quote must be escaped (contract source paths — the
    ledger's contract label — can contain any of them; an unescaped
    quote corrupts the whole exposition)."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r'\"')
    )


def escape_help(text: str) -> str:
    """HELP-line escaping per the text-format spec: backslash and
    newline (a literal newline would terminate the HELP line early and
    leave the remainder as a garbage sample)."""
    return str(text).replace("\\", r"\\").replace("\n", r"\n")


def _base_name(sample_name: str) -> str:
    """Metric name without the label set (``foo{bar="x"}`` -> ``foo``)
    — HELP/TYPE lines are emitted once per base name, while sample
    dedupe keys on the full labeled name."""
    return sample_name.split("{", 1)[0]


class Counter:
    """Monotonic-by-convention numeric cell."""

    __slots__ = ("name", "help", "_lock", "value")
    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, amount=1):
        with self._lock:
            self.value += amount

    def set(self, value):
        with self._lock:
            self.value = value

    def samples(self) -> List[Tuple[str, object]]:
        return [(self.name, self.value)]


class Gauge(Counter):
    kind = "gauge"


class Histogram:
    """Fixed-bucket histogram (cumulative ``_bucket`` lines plus
    ``_sum`` / ``_count``, Prometheus semantics)."""

    __slots__ = ("name", "help", "_lock", "buckets", "counts", "sum",
                 "count")
    kind = "histogram"

    def __init__(self, name: str, help_: str = "", buckets=None):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self.buckets = tuple(buckets or _DEFAULT_BUCKETS)
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self.counts[i] += 1

    def samples(self) -> List[Tuple[str, object]]:
        out = []
        cumulative = 0
        with self._lock:
            for bound, n in zip(self.buckets, self.counts):
                cumulative = max(cumulative, n)
                out.append(
                    (f'{self.name}_bucket{{le="{_fmt(bound)}"}}', n)
                )
            out.append((f'{self.name}_bucket{{le="+Inf"}}', self.count))
            out.append((f"{self.name}_sum", self.sum))
            out.append((f"{self.name}_count", self.count))
        return out


class MetricsRegistry:
    """Named-metric table + render-time collectors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._collectors: List[Callable] = []

    def _get_or_create(self, cls, name: str, help_: str, **kwargs):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, help_, **kwargs)
                self._metrics[name] = metric
            elif not isinstance(metric, cls) and type(metric) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}"
                )
            return metric

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help_,
                                   buckets=buckets)

    def register_collector(self, collect: Callable) -> None:
        """``collect()`` yields ``(kind, name, help, value)`` tuples at
        render time — used to absorb external mutable counter bags
        (DispatchStats, AsyncStats, tracer meta) without moving their
        hot fields."""
        with self._lock:
            self._collectors.append(collect)

    def render(self) -> str:
        """Prometheus text exposition.  Each sample name (including its
        label set) is emitted exactly once — registered metrics win
        over collector mirrors of the same name — while HELP/TYPE
        lines are emitted once per *base* name so labeled series from
        collectors stay spec-shaped.  HELP text is escaped per the
        text-format rules (see :func:`escape_help`)."""
        lines: List[str] = []
        emitted = set()       # full sample names (with labels)
        emitted_meta = set()  # base names whose HELP/TYPE went out
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for metric in metrics:
            if metric.name in emitted:
                continue
            emitted.add(metric.name)
            emitted_meta.add(metric.name)
            if metric.help:
                lines.append(
                    f"# HELP {metric.name} {escape_help(metric.help)}"
                )
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            for sample_name, value in metric.samples():
                lines.append(f"{sample_name} {_fmt(value)}")
        for collect in collectors:
            rows = list(collect())
            for kind, name, help_, value in rows:
                if name in emitted:
                    continue
                emitted.add(name)
                base = _base_name(name)
                if base not in emitted_meta:
                    emitted_meta.add(base)
                    if help_:
                        lines.append(
                            f"# HELP {base} {escape_help(help_)}"
                        )
                    lines.append(f"# TYPE {base} {kind}")
                lines.append(f"{name} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def dump(self, path: str) -> str:
        import os

        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.render())
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# default collectors: absorb the pre-existing counter bags at render time
# ---------------------------------------------------------------------------


def _dispatch_stats_collector():
    """Mirror ``DispatchStats``'s numeric fields (its dicts and lists —
    round budgets, decline caps, last tiers — are not series)."""
    from mythril_tpu_torch.ops.batched_sat import dispatch_stats

    for field, value in sorted(dispatch_stats.__dict__.items()):
        if isinstance(value, (int, float, bool)):
            yield ("gauge", f"mythril_tpu_dispatch_{field}",
                   "DispatchStats field (ops/batched_sat.py)", value)


def _async_stats_collector():
    from mythril_tpu_torch.ops.async_dispatch import async_stats

    for field, value in sorted(vars(async_stats).items()):
        if isinstance(value, (int, float, bool)):
            yield ("gauge", f"mythril_tpu_async_{field}",
                   "AsyncStats field (ops/async_dispatch.py)", value)


def _ledger_collector():
    """Lazy pass-through to the lane ledger's own collector (the
    registry is created before the ledger module loads, and a test
    registry reset must re-attach it automatically)."""
    from mythril_tpu_torch.observability.ledger import _ledger_collector as c

    yield from c()


def _autopilot_collector():
    """Lazy pass-through to the autopilot's collector (same shape as
    the ledger's — mythril_tpu_autopilot_* series)."""
    from mythril_tpu_torch.autopilot import _autopilot_collector as c

    yield from c()


def _trace_collector():
    from mythril_tpu_torch.observability.flight import get_flight_recorder
    from mythril_tpu_torch.observability.spans import get_tracer

    tracer = get_tracer()
    yield ("gauge", "mythril_tpu_trace_enabled",
           "1 when the span tracer is recording", int(tracer.enabled))
    yield ("counter", "mythril_tpu_trace_span_events",
           "completed spans recorded", tracer.span_count)
    yield ("counter", "mythril_tpu_trace_instant_events",
           "instant events recorded", tracer.instant_count)
    yield ("counter", "mythril_tpu_trace_dropped_events",
           "events dropped at the trace buffer cap", tracer.dropped)
    yield ("counter", "mythril_tpu_flight_dumps",
           "flight-recorder dumps written",
           get_flight_recorder().dumps_written)


_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                registry = MetricsRegistry()
                registry.register_collector(_dispatch_stats_collector)
                registry.register_collector(_async_stats_collector)
                registry.register_collector(_trace_collector)
                registry.register_collector(_ledger_collector)
                registry.register_collector(_autopilot_collector)
                _registry = registry
    return _registry


def reset_for_tests() -> None:
    global _registry
    _registry = None
