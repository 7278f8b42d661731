"""Observability plane of the port (own copy of
``mythril_tpu/observability``): hierarchical tracing, unified metrics,
a crash-safe flight recorder and the per-lane attribution ledger.

Four pillars, each kill-switchable (``MYTHRIL_TPU_TRACE=0`` for the
tracer, ``MYTHRIL_TPU_LEDGER=0`` for the ledger):

- :mod:`.spans` — the tracer: spans with thread-local nesting across
  the pipeline (those of the solver tiers also ``record_function``
  ranges), instant events, Perfetto counter tracks and the run's trace
  identity; exported as Chrome/Perfetto ``trace_event`` JSON via
  ``--trace-out``;
- :mod:`.metrics` — one process-wide registry of named
  counters/gauges/histograms that mirrors ``DispatchStats``,
  ``AsyncStats``, the lane ledger and the autopilot at render time;
  Prometheus text dump via ``--metrics-out``;
- :mod:`.ledger` — the per-lane attribution ledger, exported via
  ``--lane-ledger-out``;
- :mod:`.flight` — a bounded ring of the most recent events, dumped on
  a watchdog trip, a ladder demotion, a drain or an unhandled
  exception.
"""

from mythril_tpu_torch.observability.flight import (  # noqa: F401
    get_flight_recorder,
    install_excepthook,
)
from mythril_tpu_torch.observability.ledger import get_ledger  # noqa: F401
from mythril_tpu_torch.observability.metrics import get_registry  # noqa: F401
from mythril_tpu_torch.observability.spans import (  # noqa: F401
    counter,
    get_trace_id,
    get_tracer,
    instant,
    new_trace_id,
    phase_totals,
    set_trace_id,
    span,
    totals_snapshot,
    traced,
)


def configure_from_cli(trace_out, metrics_out,
                       lane_ledger_out=None) -> None:
    """CLI entry wiring (``analyze --trace-out F --metrics-out G
    --lane-ledger-out H``): publish the paths on the args bus (the
    report's meta block and the flight recorder read them), enable the
    tracer when a trace file was requested, mint the run's trace
    identity, and hook the crash dump."""
    from mythril_tpu_torch.support.support_args import args

    args.trace_out = trace_out
    args.metrics_out = metrics_out
    args.lane_ledger_out = lane_ledger_out
    # one trace id per CLI invocation, minted at the edge; the jsonv2
    # meta carries it
    set_trace_id(new_trace_id())
    if trace_out:
        get_tracer().enable(record_events=True)
    if trace_out or metrics_out or lane_ledger_out:
        install_excepthook()


def finalize_outputs() -> None:
    """Write the requested artifact files (end of a CLI analysis).  A
    failing export is logged, not raised: a full disk must not fail an
    analysis that already produced its report."""
    import logging

    from mythril_tpu_torch.support.support_args import args

    log = logging.getLogger(__name__)
    trace_out = getattr(args, "trace_out", None)
    metrics_out = getattr(args, "metrics_out", None)
    lane_ledger_out = getattr(args, "lane_ledger_out", None)
    if trace_out:
        try:
            get_tracer().export_chrome(trace_out)
        except Exception as exc:  # noqa: BLE001
            log.error("trace export to %s failed: %s", trace_out, exc)
    if metrics_out:
        try:
            get_registry().dump(metrics_out)
        except Exception as exc:  # noqa: BLE001
            log.error("metrics dump to %s failed: %s", metrics_out, exc)
    if lane_ledger_out:
        try:
            get_ledger().export_json(lane_ledger_out)
        except Exception as exc:  # noqa: BLE001
            log.error("lane-ledger export to %s failed: %s",
                      lane_ledger_out, exc)


def observability_meta() -> dict:
    """Stable ``meta.observability`` block for the jsonv2 report:
    artifact paths, event counts and the run's trace identity, every
    key always present."""
    from mythril_tpu_torch.support.support_args import args

    tracer = get_tracer()
    return {
        "enabled": bool(tracer.enabled),
        "trace_id": get_trace_id(),
        "trace_out": getattr(args, "trace_out", None),
        "metrics_out": getattr(args, "metrics_out", None),
        "lane_ledger_out": getattr(args, "lane_ledger_out", None),
        "span_events": int(tracer.span_count),
        "instant_events": int(tracer.instant_count),
        "dropped_events": int(tracer.dropped),
        "flight_dumps": int(get_flight_recorder().dumps_written),
        "ledger_lanes": int(get_ledger().lanes_total),
    }
