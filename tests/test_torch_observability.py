"""The port's observability plane (``mythril_tpu_torch/observability``)
against the JAX package's (``mythril_tpu/observability``), on the CPU.

The tracer: nesting, sinks, instants, counters, the kill switch, the
event cap and the phase buckets, with the same call sequence giving the
same trace in both packages (times, pids and thread ids aside), and the
``record_function`` ranges of the spans opened with ``profile=True``.
The lane ledger: the same call sequence gives the same export in both
packages (walls and ids aside), its state machine is the JAX package's,
and ``scripts/trace_lint.py``'s checks pass on the port's files.  The
metrics registry, the flight recorder, the CLI wiring
(``configure_from_cli`` / ``finalize_outputs``) and the jsonv2
``meta.observability`` block, each held to its JAX twin.
"""

import importlib
import json
import os
import sys

import pytest

from test_torch_analyze import fresh_planes, parse_prometheus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import trace_lint  # noqa: E402

PACKAGES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}
PLANE_KNOBS = ("MYTHRIL_TPU_TRACE", "MYTHRIL_TPU_TRACE_CAP",
               "MYTHRIL_TPU_LEDGER", "MYTHRIL_TPU_LEDGER_CAP",
               "MYTHRIL_TPU_FLIGHT_EVENTS", "MYTHRIL_TPU_FLIGHT_DIR")


def mod(side, name):
    return importlib.import_module(f"{PACKAGES[side]}.observability{name}")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """No plane knob set; both packages' singletons made afresh before
    the case and dropped after it."""
    for var in PLANE_KNOBS:
        monkeypatch.delenv(var, raising=False)
    with fresh_planes():
        yield


def _scrub(events):
    """Trace events without what differs from run to run."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "pid",
                                                      "tid")}
        out.append(e)
    return out


class _Sink:
    seconds = 0.0


def trace_sequence(side):
    """One call sequence on ``side``'s tracer: nested spans (one with a
    sink, one raising), an instant, a counter sample, the decorator
    form; returns the tracer."""
    spans = mod(side, ".spans")
    tracer = spans.get_tracer()
    assert tracer.enable()
    sink = _Sink()
    with spans.span("svm.transaction", cat="svm", tx=0):
        with spans.span("dispatch.round", cat="sweep", budget=64):
            with spans.span("cdcl.solve", sink=(sink, "seconds"),
                            cat="tail"):
                pass
        spans.instant("watch.me", cat="event", lanes=3)
        spans.counter("lanes.live", live=4, bucket=8)
        with pytest.raises(KeyError):
            with spans.span("word.prop", cat="word"):
                raise KeyError("x")

    @spans.traced("cone.build", cat="cone")
    def build():
        return 7

    assert build() == 7
    assert sink.seconds > 0
    return tracer


def test_tracer_sequence_matches_jax(tmp_path):
    """The same spans, instants and counters in both packages: equal
    events (names, categories, phases, nesting parents, the error
    attribute, arguments) and counts; the exported file has
    ``traceEvents`` and passes ``trace_lint``; ``phase_totals`` folds
    the same names into the same buckets."""
    events, totals = {}, {}
    for side in PACKAGES:
        tracer = trace_sequence(side)
        events[side] = _scrub(tracer.events())
        totals[side] = sorted(tracer.totals_snapshot())
        assert (tracer.span_count, tracer.instant_count) == (5, 1)
        path = str(tmp_path / f"{side}.json")
        tracer.export_chrome(path)
        payload = json.loads(open(path).read())
        assert not trace_lint.lint_trace(payload)
        buckets = mod(side, ".spans").phase_totals()
        assert {k for k, v in buckets.items() if v > 0} <= {
            "cone_s", "sweep_s", "tail_s", "word_s"}
    assert events["port"] == events["jax"]
    assert totals["port"] == totals["jax"]
    parents = {e["name"]: e.get("args", {}).get("parent")
               for e in events["port"] if e["ph"] == "X"}
    assert parents["cdcl.solve"] == "dispatch.round"
    assert parents["dispatch.round"] == "svm.transaction"
    word = next(e for e in events["port"] if e["name"] == "word.prop")
    assert word["args"]["error"] == "KeyError"


def test_disabled_spans_and_the_kill_switch(monkeypatch):
    """Tracing off: a span without a sink is the shared no-op, with a
    sink it still times into it; ``MYTHRIL_TPU_TRACE=0`` vetoes
    ``enable()`` and ``MYTHRIL_TPU_TRACE=1`` turns a fresh tracer on,
    in both packages."""
    for side in PACKAGES:
        spans = mod(side, ".spans")
        assert not spans.get_tracer().enabled
        assert spans.span("a") is spans._NOOP
        sink = _Sink()
        with spans.span("b", sink=(sink, "seconds")) as sp:
            pass
        assert sink.seconds == sp.elapsed_s > 0
        spans.instant("c")
        assert spans.get_tracer().events() == []
        monkeypatch.setenv("MYTHRIL_TPU_TRACE", "0")
        assert spans.get_tracer().enable() is False
        monkeypatch.setenv("MYTHRIL_TPU_TRACE", "1")
        spans.reset_for_tests()
        assert spans.get_tracer().enabled
        monkeypatch.delenv("MYTHRIL_TPU_TRACE")


def test_trace_cap_drops_and_keeps_totals(monkeypatch, tmp_path):
    """Past ``MYTHRIL_TPU_TRACE_CAP`` (floored at 1024) events are
    dropped and counted, the per-name totals still grow, and the export
    marks the truncation, alike in both packages."""
    monkeypatch.setenv("MYTHRIL_TPU_TRACE_CAP", "10")
    got = {}
    for side in PACKAGES:
        spans = mod(side, ".spans")
        spans.reset_for_tests()
        tracer = spans.get_tracer()
        tracer.enable()
        for _ in range(1500):
            with spans.span("upload.pool", cat="h2d"):
                pass
        path = str(tmp_path / f"{side}.json")
        tracer.export_chrome(path)
        payload = json.loads(open(path).read())
        got[side] = (len(tracer.events()), tracer.dropped,
                     tracer.counts_snapshot(), payload["traceEvents"][-1][
                         "name"], payload["otherData"]["dropped_events"])
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (1024, 476)
    assert got["port"][3] == "trace.truncated"


@pytest.mark.parametrize("enabled", [False, True])
def test_profiled_spans_open_record_function_ranges(enabled):
    """``profile=True`` spans open a ``record_function`` range of their
    own name, tracing on or off (the profiler's view of the tiers keeps
    its boundaries), nested as the spans are."""
    from torch.profiler import ProfilerActivity, profile

    spans = mod("port", ".spans")
    if enabled:
        spans.get_tracer().enable()
    sink = _Sink()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("tier.gather", sink=(sink, "seconds"),
                        profile=True):
            with spans.span("resident.solve", profile=True):
                pass
        with spans.span("svm.round"):
            pass
    names = [e.key for e in prof.key_averages()]
    assert "tier.gather" in names and "resident.solve" in names
    assert "svm.round" not in names
    assert sink.seconds > 0
    assert bool(spans.get_tracer().events()) == enabled


def ledger_sequence(side):
    """One call sequence on ``side``'s ledger: origins, two batches
    (every terminal tier, deferred, dispatched, opaque, features and a
    route, walls, sweeps, learned clauses), prune-level singles and
    aggregate-only transitions; returns the ledger."""
    ledger = mod(side, ".ledger")
    led = ledger.get_ledger()
    ledger.set_origin(contract="MAIN", tx_index=None)
    ledger.set_origin(tx_index=1)
    batch = led.begin_batch("batch_check", 6)
    batch.decide(0, "structural", "unsat")
    batch.set_features(1, {"v": 1, "constraints": 1, "tx": 1})
    batch.set_routed(1, "word-skip+tail-direct")
    batch.decide(2, "probe", "sat")
    batch.decide(2, "word", "sat")  # the first decision wins
    batch.decide(3, "word", "unsat")
    batch.transition_open([4, 5], "dispatched")
    batch.decide(4, "frontier", "unsat")
    batch.tier_wall("frontier", 0.25)
    batch.tier_wall("probe", 0.0)
    batch.add_sweeps("frontier", 12)
    batch.add_learned(3)
    batch.close()
    batch.close()  # idempotent
    batch = led.begin_batch("batch_check", 3)
    batch.transition(0, "opaque")
    batch.transition_open([1], "deferred")
    batch.transition_open([2], "dispatched")
    batch.decide(2, "sweep", "sat")
    batch.close()
    assert led.begin_batch("batch_check", 0) is ledger._NOOP_BATCH
    ledger.set_origin(tx_index=2)
    led.single("prune", "structural", "unsat")
    led.single("prune", "tail", "sat")
    led.count_transition("lockstep", 4)
    led.count_transition("merge", 1)
    led.count_transition("subsume", 2)
    led.count_transition("merge", 0)
    return led


def test_ledger_sequence_matches_jax(tmp_path):
    """The same calls on both ledgers give the same export, walls and
    record ids aside; the port's passes ``trace_lint``'s schema,
    legality and conservation checks; ``tier_decided_pct`` and the
    registry's ledger series agree."""
    exports = {}
    for side in PACKAGES:
        led = ledger_sequence(side)
        path = str(tmp_path / f"{side}.json")
        led.export_json(path)
        payload = json.loads(open(path).read())
        assert not trace_lint.lint_ledger(payload), side
        assert led.tier_decided_pct() == {"word": 9.1, "frontier": 9.1,
                                          "full": 9.1, "tail": 45.5}
        payload["aggregates"].pop("tier_wall_s")
        for record in payload["records"]:
            record.pop("id")
        exports[side] = payload
        samples = parse_prometheus(
            mod(side, ".metrics").get_registry().render())
        assert samples["mythril_tpu_ledger_lanes_total"] == 11
        assert samples['mythril_tpu_ledger_decided_total{tier="tail"}'] == 5
    assert exports["port"] == exports["jax"]
    agg = exports["port"]["aggregates"]
    assert agg["transitions"] == {"dispatched": 3, "opaque": 1,
                                  "deferred": 1, "lockstep": 4,
                                  "merge": 1, "subsume": 2}
    assert agg["routed"] == {"word-skip+tail-direct": 1}
    assert exports["port"]["schema"] == "mythril-tpu-lane-ledger/2"


def test_ledger_state_machine_matches_jax():
    """The terminal tiers, transitions, legal moves, verdicts, caps and
    schema are the JAX package's."""
    for name in ("TERMINAL_TIERS", "TRANSITIONS", "LEGAL_NEXT", "VERDICTS",
                 "LEDGER_CAP", "MAX_CONTRACTS", "MAX_SCOPES", "SCHEMA"):
        assert (getattr(mod("port", ".ledger"), name)
                == getattr(mod("jax", ".ledger"), name)), name


def test_ledger_cap_and_kill_switch(monkeypatch):
    """Past ``MYTHRIL_TPU_LEDGER_CAP`` (floored at 64) only the
    aggregates grow; ``MYTHRIL_TPU_LEDGER=0`` gives the shared no-op
    batch and counts nothing; alike in both packages."""
    monkeypatch.setenv("MYTHRIL_TPU_LEDGER_CAP", "1")
    got = {}
    for side in PACKAGES:
        ledger = mod(side, ".ledger")
        ledger.reset_for_tests()
        led = ledger.get_ledger()
        for _ in range(100):
            led.single("prune", "tail", "sat")
        got[side] = (len(led.records), led.records_dropped, led.lanes_total)
    assert got["port"] == got["jax"] == (64, 36, 100)
    monkeypatch.setenv("MYTHRIL_TPU_LEDGER", "0")
    for side in PACKAGES:
        ledger = mod(side, ".ledger")
        ledger.reset_for_tests()
        led = ledger.get_ledger()
        assert led.begin_batch("batch_check", 4) is ledger._NOOP_BATCH
        led.single("prune", "tail", "sat")
        led.count_transition("lockstep", 3)
        assert led.lanes_total == 0 and not led.transitions


def test_ledger_observers_see_each_closed_batch():
    """A batch observer runs once per closed batch, outside the lock (it
    may read the ledger back)."""
    ledger = mod("port", ".ledger")
    seen = []

    def observer(batch):
        seen.append((batch.kind, ledger.get_ledger().lanes_total))

    ledger.add_batch_observer(observer)
    try:
        ledger_sequence("port")
    finally:
        ledger.remove_batch_observer(observer)
    assert seen == [("batch_check", 6), ("batch_check", 9),
                    ("prune", 10), ("prune", 11)]


def test_registry_mirrors_the_port_counters():
    """The registry's render parses as Prometheus text, mirrors every
    numeric ``DispatchStats`` field (the tiers' seconds among them) and
    ``AsyncStats``, the trace and flight meta-counters, and the
    autopilot's series; a metric name is never registered twice as two
    kinds."""
    from mythril_tpu_torch import autopilot
    from mythril_tpu_torch.ops.async_dispatch import async_stats
    from mythril_tpu_torch.ops.batched_sat import dispatch_stats

    registry = mod("port", ".metrics").get_registry()
    registry.counter("mythril_tpu_test_total", "a test counter").inc(3)
    registry.histogram("mythril_tpu_test_lanes", buckets=(1, 4)).observe(2)
    autopilot.get_autopilot().counters.lanes_seen += 5
    text = registry.render()
    samples = parse_prometheus(text)
    numeric = [f for f, v in vars(dispatch_stats).items()
               if isinstance(v, (int, float, bool))]
    assert {"dense_s", "dense_rounds_s", "gather_s", "resident_s",
            "word_s", "segment_s", "merge_span_s"} <= set(numeric)
    for field in numeric:
        assert f"mythril_tpu_dispatch_{field}" in samples, field
    for field in vars(async_stats):
        assert f"mythril_tpu_async_{field}" in samples, field
    assert samples["mythril_tpu_test_total"] == 3
    assert samples['mythril_tpu_test_lanes_bucket{le="4"}'] == 1
    assert samples["mythril_tpu_autopilot_lanes_seen"] == 5
    assert samples["mythril_tpu_trace_enabled"] == 0
    assert "# TYPE mythril_tpu_dispatch_dense_s gauge" in text
    with pytest.raises(TypeError):
        registry.gauge("mythril_tpu_test_total")


def test_flight_recorder_dumps_on_an_unhandled_exception(monkeypatch,
                                                         tmp_path):
    """The ring keeps the last ``MYTHRIL_TPU_FLIGHT_EVENTS`` events the
    tracer produced, and the hook ``install_excepthook`` chains dumps it
    into ``MYTHRIL_TPU_FLIGHT_DIR`` before the previous hook runs;
    ``KeyboardInterrupt`` dumps nothing; an empty ring dumps nothing."""
    flight = mod("port", ".flight")
    spans = mod("port", ".spans")
    monkeypatch.setenv("MYTHRIL_TPU_FLIGHT_EVENTS", "16")
    monkeypatch.setenv("MYTHRIL_TPU_FLIGHT_DIR", str(tmp_path))
    flight.reset_for_tests()
    assert flight.get_flight_recorder().dump("empty") is None
    spans.get_tracer().enable()
    for i in range(40):
        spans.instant("tick", i=i)
    assert len(flight.get_flight_recorder()) == 16
    called = []
    monkeypatch.setattr(sys, "excepthook",
                        lambda *exc: called.append(exc[0]))
    monkeypatch.setattr(flight, "_excepthook_installed", False)
    flight.install_excepthook()
    flight.install_excepthook()  # idempotent
    sys.excepthook(KeyboardInterrupt, KeyboardInterrupt(), None)
    sys.excepthook(ValueError, ValueError("boom"), None)
    assert called == [KeyboardInterrupt, ValueError]
    dumps = sorted(os.listdir(tmp_path))
    assert len(dumps) == 1 and "unhandled_exception" in dumps[0]
    payload = json.loads((tmp_path / dumps[0]).read_text())
    assert [e["args"]["i"] for e in payload["traceEvents"]] == list(
        range(24, 40))
    assert flight.get_flight_recorder().dumps_written == 1


def test_cli_wiring_writes_the_artifacts(monkeypatch, tmp_path):
    """``configure_from_cli`` with the three paths enables the tracer,
    mints a trace id and publishes the paths; ``finalize_outputs``
    writes the three files; ``observability_meta`` has the JAX
    package's keys; a failing export is logged and the others still
    land."""
    from mythril_tpu.observability import observability_meta as jax_meta
    from mythril_tpu_torch.support.support_args import args

    obs = importlib.import_module("mythril_tpu_torch.observability")
    for name in ("trace_out", "metrics_out", "lane_ledger_out"):
        monkeypatch.setattr(args, name, None)
    monkeypatch.setattr(obs.flight, "_excepthook_installed", True)
    paths = [str(tmp_path / n) for n in ("t.json", "m.prom", "l.json")]
    obs.configure_from_cli(*paths)
    assert obs.get_tracer().enabled and obs.get_trace_id()
    ledger_sequence("port")
    with obs.span("cli.analyze", cat="cli"):
        pass
    obs.finalize_outputs()
    trace = json.loads(open(paths[0]).read())
    assert not trace_lint.lint_trace(trace)
    assert trace["otherData"]["trace_id"] == obs.get_trace_id()
    assert parse_prometheus(open(paths[1]).read())[
        "mythril_tpu_ledger_lanes_total"] == 11
    assert not trace_lint.lint_ledger(json.loads(open(paths[2]).read()))
    meta = obs.observability_meta()
    assert sorted(meta) == sorted(jax_meta())
    assert meta["trace_out"] == paths[0] and meta["ledger_lanes"] == 11
    assert meta["span_events"] == 1
    # a failing export is logged; the report's caller goes on
    monkeypatch.setattr(args, "trace_out", str(tmp_path / "no" / "t.json"))
    os.remove(paths[2])
    obs.finalize_outputs()
    assert os.path.exists(paths[2])
