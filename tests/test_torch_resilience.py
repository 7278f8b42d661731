"""The port's resilience plane (``mythril_tpu_torch/resilience``,
``ops/device_health.py`` and the ladder in ``ops/batched_sat.py``)
against the JAX package's, on the CPU.

The port's counterparts of ``tests/test_faults.py``: each end-to-end
case runs the same analysis of the chaos contract
(``bench.chaos_tree_contract``, one transaction) on both packages, under
the slice pins, force-dispatched, with ``MYTHRIL_TPU_PALLAS=force`` on
the JAX side (``test_torch_analyze.analysis_pins``) and the JAX chaos
tests' argument pins (``chaos_pins``), with the same fault schedule
armed on both fault planes.  The issue lists, states, prune verdicts,
solver counters, lane ledgers (the ``quarantined`` transitions among
them) and autopilots must be equal (``_parity``), and so must the
resilience counters (retries, watchdog trips, demotions, quarantined
lanes, bisection dispatches, faults fired, governor rungs).

Where the port's rules differ, the cases say so: an injected
``probe_flap`` degrades the JAX package to ``unhealthy_skips`` and
raises ``DeviceLost`` in the port, a failed re-probe raises
``DeviceLost`` where JAX demotes the process, and an exception that is
not the fault plane's or the watchdog's propagates out of the port's
ladder unretried where JAX retries it.

Every test resets both packages' resilience singletons (the fault
plane, the watchdog's table, the drain flag, the checkpoint plane, the
request budget, the governor and the counters) before and after, and
puts SIGTERM/SIGINT back (:func:`fresh_resilience`).  Injected hangs
and deadlines stay under 2 s.
"""

import contextlib
import importlib
import json
import threading
import time

import numpy as np
import pytest

import bench
from mythril_tpu.resilience import faults as jax_faults
from mythril_tpu.resilience import watchdog as jax_watchdog
from mythril_tpu.resilience.telemetry import resilience_stats as jax_stats
from mythril_tpu_torch.ops import batched_sat as port_bs
from mythril_tpu_torch.ops.device_health import DeviceLost
from mythril_tpu_torch.resilience import faults as port_faults
from mythril_tpu_torch.resilience import watchdog as port_watchdog
from mythril_tpu_torch.resilience.telemetry import (
    resilience_stats as port_stats,
)
from mythril_tpu_torch.support.support_args import args as port_args
from test_torch_analyze import _run, analysis_pins, jax_args

pytestmark = pytest.mark.faults

PACKAGES = ("mythril_tpu", "mythril_tpu_torch")
#: the resilience singletons of each package, reset around every test
RESILIENCE_MODULES = ("faults", "watchdog", "checkpoint", "budget",
                      "governor")
#: the counters compared between the packages (the JAX package's other
#: counters belong to planes the port does not have)
RESILIENCE_COUNTERS = tuple(port_stats.as_dict())


def reset_resilience():
    """Both packages' resilience singletons made afresh, their counters
    zeroed, the JAX package's health verdict forgotten, and signal
    handlers the checkpoint planes installed put back."""
    import signal

    from mythril_tpu.ops import device_health as jax_health
    from mythril_tpu_torch.resilience import checkpoint as port_checkpoint

    for package in PACKAGES:
        for name in RESILIENCE_MODULES:
            importlib.import_module(
                f"{package}.resilience.{name}").reset_for_tests()
    port_checkpoint.restore_signal_handlers()
    jax_checkpoint = importlib.import_module(
        "mythril_tpu.resilience.checkpoint")
    if jax_checkpoint._handlers_installed:
        jax_checkpoint._handlers_installed = False
        for signum in (signal.SIGTERM, signal.SIGINT):
            signal.signal(signum, signal.default_int_handler
                          if signum == signal.SIGINT else signal.SIG_DFL)
    jax_health.reset_for_tests()
    jax_stats.reset()
    port_stats.reset()


@contextlib.contextmanager
def fresh_resilience():
    """:func:`reset_resilience` before and after the block, with SIGTERM
    and SIGINT as they were: a drain flag or an armed fault left behind
    would stop or fail a later test of the same process."""
    import signal

    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                              signal.SIGINT)}
    reset_resilience()
    try:
        yield
    finally:
        reset_resilience()
        for signum, handler in saved.items():
            signal.signal(signum, handler)


def chaos_pins(monkeypatch):
    """The JAX chaos tests' argument pins on both packages (a 2-lane
    floor, no host word probing, 32 states a round, no coalescing), the
    checkpoint plane off, a short retry backoff, and a small resident
    budget, so the chaos contract's lanes reach the device quickly."""
    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "device_min_lanes", 2)
        monkeypatch.setattr(args, "device_force_dispatch", True)
        monkeypatch.setattr(args, "async_dispatch", False)
        monkeypatch.setattr(args, "word_probing", False)
        monkeypatch.setattr(args, "batch_width", 32)
        monkeypatch.setattr(args, "device_coalesce", False)
        monkeypatch.setattr(args, "checkpoint_dir", None, raising=False)
        monkeypatch.setattr(args, "resume_from", None, raising=False)
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_BACKOFF_S", "0.01")
    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_BUDGET", "64")


@pytest.fixture(autouse=True)
def chaos_env(monkeypatch):
    with analysis_pins(monkeypatch), fresh_resilience():
        chaos_pins(monkeypatch)
        yield


CHAOS = bench.chaos_tree_contract()


def arm(schedule, **extra):
    """Arm ``schedule`` (``[(point, times, skip, lane)]``) on both fault
    planes."""
    for plane in (jax_faults.get_fault_plane(),
                  port_faults.get_fault_plane()):
        for point, times, skip, lane in schedule:
            plane.arm(point, times=times, skip=skip, lane=lane, **extra)


def resilience_row(stats):
    return {k: getattr(stats, k) for k in RESILIENCE_COUNTERS
            if k != "checkpoint_s"}


def chaos_parity(schedule=(), code=CHAOS, tx_count=1, **extra):
    """One analysis a side with ``schedule`` armed on both: ``_parity``
    (issues, states, prunes, counters, ledgers, autopilots) and equal
    resilience counters.  Returns (jax, port) with each side's
    resilience counters under ``"resilience"``."""
    for module in (jax_faults, port_faults, jax_watchdog, port_watchdog):
        module.reset_for_tests()
    arm(schedule, **extra)
    jax = _run("jax", code, tx_count)
    jax["resilience"] = resilience_row(jax_stats)
    jax["fused"] = jax_bs_stats().fused
    port = _run("port", code, tx_count)
    port["resilience"] = resilience_row(port_stats)
    port["fused"] = port_bs.dispatch_stats.fused
    _assert_same(jax, port)
    return jax, port


def jax_bs_stats():
    from mythril_tpu.ops.batched_sat import dispatch_stats

    return dispatch_stats


def _assert_same(jax, port):
    for key in ("issues", "total_states", "prunes", "dispatches",
                "sweeps", "counters", "ledger", "autopilot",
                "resilience", "fused"):
        assert port[key] == jax[key], key


_baseline = {}


def baseline():
    """The fault-free parity run, once per process (it also warms the
    JAX package's compiled solves, which a short dispatch deadline must
    not pay for)."""
    if "runs" not in _baseline:
        _baseline["runs"] = chaos_parity()
    return _baseline["runs"]


def swcs(result):
    return {issue["swc_id"] for issue in result["issues"]}


# ---------------------------------------------------------------------------
# end to end: each injected fault against the fault-free findings
# ---------------------------------------------------------------------------


def test_fault_free_baseline_dispatches_and_is_clean():
    jax, port = baseline()
    assert "106" in swcs(port)
    assert port["dispatches"] > 0, "the chaos contract no longer dispatches"
    assert not any(port["resilience"].values())
    assert port["fused"] is False


def test_dispatch_hang_trips_watchdog_and_demotes(monkeypatch):
    base, _ = baseline()
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "0.4")
    began = time.monotonic()
    jax, port = chaos_parity([("dispatch_hang", 99, 0, None)], hang_s=1.0)
    assert time.monotonic() - began < 30
    assert swcs(port) == swcs(base)
    assert port["resilience"]["watchdog_trips"] >= 1
    assert port["resilience"]["demotions"] >= 1
    assert port["fused"] is True
    assert port["dispatches"] == 0


def test_dispatch_error_once_is_retried_and_recovers():
    base, _ = baseline()
    jax, port = chaos_parity([("dispatch_error", 1, 0, None)])
    assert swcs(port) == swcs(base)
    assert port["resilience"]["dispatch_retries"] >= 1
    assert port["resilience"]["demotions"] == 0
    assert port["dispatches"] == base["dispatches"] > 0


def test_dispatch_error_mid_analysis_is_retried():
    """A skip lands the error on a later dispatch (the chip check's
    ``MYTHRIL_TPU_FAULT=dispatch_error:1:SKIP``)."""
    base, _ = baseline()
    jax, port = chaos_parity([("dispatch_error", 1, 3, None)])
    assert swcs(port) == swcs(base)
    assert port["resilience"]["dispatch_retries"] == 1
    assert port["resilience"]["faults_fired"] == 1


def test_dispatch_error_exhaustion_demotes():
    base, _ = baseline()
    jax, port = chaos_parity([("dispatch_error", 99, 0, None)])
    assert swcs(port) == swcs(base)
    assert port["resilience"]["dispatch_retries"] >= 2
    assert port["resilience"]["demotions"] >= 1
    assert port["fused"] is True
    assert port["dispatches"] == 0


def test_frontier_stall_is_retried_like_jax():
    base, _ = baseline()
    jax, port = chaos_parity([("frontier_stall", 2, 0, None)])
    assert swcs(port) == swcs(base)
    assert port["resilience"]["dispatch_retries"] == 2


def test_lane_poison_quarantines_one_lane_end_to_end():
    """A lane-dependent abort on one lane of every dispatch that carries
    it: bisection quarantines it, the context stays on the card, the
    ledger counts each quarantine as a ``quarantined`` transition, and
    findings do not move."""
    base, _ = baseline()
    jax, port = chaos_parity([("lane_poison", 99, 0, 2)])
    assert swcs(port) == swcs(base)
    quarantined = port["resilience"]["quarantined_lanes"]
    assert quarantined >= 1
    assert port["resilience"]["bisect_dispatches"] > 0
    assert port["resilience"]["demotions"] == 0
    assert port["ledger"]["aggregates"]["transitions"]["quarantined"] \
        == quarantined


def test_garbage_dispatch_end_to_end_keeps_findings():
    base, _ = baseline()
    jax, port = chaos_parity([("dispatch_garbage", 99, 0, None)])
    assert swcs(port) == swcs(base)
    assert port["counters"]["sat_verified"] == 0
    assert port["resilience"]["faults_fired"] >= 1


def test_cdcl_raise_is_retried_and_findings_survive():
    base, _ = baseline()
    jax, port = chaos_parity([("cdcl_error", 1, 0, None)])
    assert swcs(port) == swcs(base)
    assert port["resilience"]["dispatch_retries"] >= 1


def test_probe_flap_raises_device_lost_where_jax_degrades():
    """The port's rule for a lost card: JAX flips its health verdict and
    degrades to the CDCL (``unhealthy_skips``) with the fault-free
    findings; the port raises ``DeviceLost`` and gives no findings."""
    base, _ = baseline()
    arm([("probe_flap", 1, 1, None)])
    jax = _run("jax", CHAOS, 1)
    from mythril_tpu.ops.device_health import device_ok

    assert swcs(jax) == swcs(base)
    assert jax_bs_stats().unhealthy_skips >= 1
    assert device_ok() is False
    with pytest.raises(DeviceLost):
        _run("port", CHAOS, 1)
    assert port_faults.get_fault_plane().fired == {"probe_flap": 1}


def test_governor_breach_applies_the_rungs_in_order():
    """Four forced breaches: the four rungs apply in order on both
    sides, the run is partial, and the report's governor block names
    them."""
    from mythril_tpu.resilience import governor as jax_governor
    from mythril_tpu_torch.analysis.report import Report
    from mythril_tpu_torch.resilience import governor as port_governor

    for governor in (jax_governor, port_governor):
        governor.install_governor(label="chaos")
    try:
        jax, port = chaos_parity([("governor_breach", 4, 0, None)])
    finally:
        for governor in (jax_governor, port_governor):
            governor.clear_governor()
    assert port_governor.governor_meta() == jax_governor.governor_meta()
    assert port_governor.governor_meta()["rungs"] == list(
        port_governor.RUNGS)
    assert port_args.batch_width == 32  # restored at the clear
    meta = json.loads(Report().as_swc_standard_format())[0]["meta"]
    assert meta["resilience"]["partial"] is True
    assert meta["resilience"]["governor"]["rungs"] == list(
        port_governor.RUNGS)
    assert meta["resilience"]["governor_drain_partial"] == 1


def test_governor_two_rungs_keep_exploring_like_jax():
    """Two breaches (shrink the frontier, turn the lockstep planes off):
    the analysis goes on at the halved batch width and without the
    planes, equal on both sides, with the fault-free findings."""
    from mythril_tpu.resilience import governor as jax_governor
    from mythril_tpu_torch.resilience import governor as port_governor

    base, _ = baseline()
    for governor in (jax_governor, port_governor):
        governor.install_governor(label="chaos")
    try:
        jax, port = chaos_parity([("governor_breach", 2, 0, None)])
    finally:
        for governor in (jax_governor, port_governor):
            governor.clear_governor()
    assert swcs(port) == swcs(base)
    assert port_governor.governor_meta()["rungs"] == [
        "shrink_frontier", "disable_planes"]
    assert port["counters"]["states_stepped"] == 0


# ---------------------------------------------------------------------------
# frontier level: garbage lanes, the prefetch, the funnel's propagation
# ---------------------------------------------------------------------------


def _frontier(package, tag):
    """6 lanes: even = satisfiable multiplier guards, odd = UNSAT
    interval contradictions (the JAX chaos tests' frontier)."""
    smt = importlib.import_module(f"{package}.smt")
    Constraints = importlib.import_module(
        f"{package}.laser.ethereum.state.constraints").Constraints
    lanes = []
    odd = smt.symbol_factory.BitVecVal(0x2B, 16)
    for i in range(6):
        x = smt.symbol_factory.BitVecSym(f"{tag}{i}", 16)
        if i % 2 == 0:
            lanes.append([(x * odd) == smt.symbol_factory.BitVecVal(
                (0x34 + 37 * i) & 0xFFFF, 16)])
        else:
            lanes.append([smt.ULT(x, smt.symbol_factory.BitVecVal(2, 16)),
                          smt.UGT(x, smt.symbol_factory.BitVecVal(9, 16))])
    return [Constraints(lane) for lane in lanes]


def frontier_check(package, tag):
    """``batch_check_states`` over :func:`_frontier` on a fresh context,
    with no CDCL tail (the JAX funnel leaves undecided lanes to its
    caller); returns (verdicts, dispatch stats)."""
    bs = importlib.import_module(f"{package}.ops.batched_sat")
    importlib.import_module(f"{package}.smt.solver").reset_blast_context()
    bs.dispatch_stats.reset()
    kwargs = ({"device": "cpu", "tail": False}
              if package == "mythril_tpu_torch" else {})
    return bs.batch_check_states(_frontier(package, tag), **kwargs), \
        bs.dispatch_stats


def test_garbage_lanes_are_rejected_by_host_verification():
    """Corrupted device output claims every lane SAT over a garbage
    assignment: host verification rejects all of it and no verdict
    flips, on both sides alike."""
    out = {}
    for package in PACKAGES:
        clean, _ = frontier_check(package, "gc")
        importlib.import_module(
            f"{package}.resilience.faults").get_fault_plane().arm(
                "dispatch_garbage", times=99)
        corrupted, stats = frontier_check(package, "gd")
        assert stats.sat_verified == 0
        for i, verdict in enumerate(corrupted):
            if verdict is not None:
                assert verdict == clean[i]
        out[package] = (clean, corrupted)
    assert out["mythril_tpu"] == out["mythril_tpu_torch"]
    assert port_stats.faults_fired == jax_stats.faults_fired >= 1


def test_prefetch_fault_drops_the_batch(monkeypatch):
    """An injected prefetch failure drops the batch (JAX's rule), on
    both sides alike."""
    counts = {}
    for package in PACKAGES:
        ad = importlib.import_module(f"{package}.ops.async_dispatch")
        args = jax_args if package == "mythril_tpu" else port_args
        monkeypatch.setattr(args, "device_force_dispatch", False)
        monkeypatch.setattr(args, "async_dispatch", True)
        monkeypatch.setattr(args, "device_min_save_s", 1e9)
        ad.async_stats.reset()
        importlib.import_module(
            f"{package}.resilience.faults").get_fault_plane().arm(
                "prefetch_error", times=1)
        dispatcher = ad.get_async_dispatcher()
        frontier_check(package, "pf")
        dispatcher._live_thread.join(timeout=60)
        assert dispatcher.pending["done"]
        assert dispatcher.pending["failed"]
        ctx = importlib.import_module(
            f"{package}.smt.solver").get_blast_context()
        dispatcher.harvest(ctx)
        counts[package] = (ad.async_stats.launches, ad.async_stats.dropped,
                           ad.async_stats.harvested)
    assert counts["mythril_tpu_torch"] == counts["mythril_tpu"] == (1, 1, 0)


def test_a_prefetch_failure_not_injected_still_raises(monkeypatch):
    """Only the fault plane's failure is dropped: a real worker failure
    reaches the next harvest (a kernel error is never hidden)."""
    from mythril_tpu_torch.ops import async_dispatch as ad
    from mythril_tpu_torch.smt.solver import get_blast_context

    dispatcher = ad.AsyncDispatcher()
    dispatcher.pending = {"generation": get_blast_context().generation,
                          "done": True, "error": RuntimeError("launch")}
    with pytest.raises(RuntimeError, match="launch"):
        dispatcher.harvest(get_blast_context())


def test_wedged_prefetch_is_abandoned_at_deadline(monkeypatch):
    """A batch in flight past the deadline cap is dropped at harvest,
    counting a watchdog trip and a demotion, as in JAX."""
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "0.1")
    rows = []
    for package in PACKAGES:
        ad = importlib.import_module(f"{package}.ops.async_dispatch")
        stats = jax_stats if package == "mythril_tpu" else port_stats
        ctx = importlib.import_module(
            f"{package}.smt.solver").get_blast_context()
        ad.async_stats.reset()
        dispatcher = ad.AsyncDispatcher()
        dispatcher.pending = {"generation": ctx.generation, "done": False,
                              "began": time.monotonic() - 5.0}
        dispatcher.harvest(ctx)
        assert dispatcher.pending is None
        rows.append((ad.async_stats.dropped, stats.watchdog_trips,
                     stats.demotions))
    assert rows[0] == rows[1] == (1, 1, 1)


def test_a_tier_failure_not_injected_propagates_from_the_funnel(
        monkeypatch):
    """A failure of a round's solve that is no injected fault (here a
    ``RuntimeError`` as a launch's error code gives) leaves the port's
    funnel unchanged, with no retry and no demotion; JAX's ladder
    retries the same failure and demotes the context."""
    def broken(*args, **kwargs):
        raise RuntimeError("frontier scan_rows kernel launch failed: "
                           "cudaError 1")

    from mythril_tpu.ops import resident as jax_resident
    from mythril_tpu_torch.ops import resident as port_resident

    monkeypatch.setattr(port_resident, "resident_solve", broken)
    monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", "0")
    with pytest.raises(RuntimeError, match="cudaError 1"):
        frontier_check("mythril_tpu_torch", "rt")
    assert port_stats.dispatch_retries == 0
    assert port_stats.demotions == 0
    assert port_bs.dispatch_stats.fused is False

    monkeypatch.setattr(jax_resident, "make_resident_step",
                        lambda *args, **kwargs: broken)
    from mythril_tpu.ops.batched_sat import get_backend

    # a cache of its own for the broken step, the real one back after
    monkeypatch.setattr(get_backend(), "_step_cache", {})
    verdicts, stats = frontier_check("mythril_tpu", "rt")
    assert jax_stats.dispatch_retries >= 2
    assert jax_stats.demotions >= 1
    assert stats.fused is True
    assert all(v is None for v in verdicts)


# ---------------------------------------------------------------------------
# the watchdog's rules
# ---------------------------------------------------------------------------


def test_watchdog_deadline_follows_the_latency_ewma(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "100")
    for module in (jax_watchdog, port_watchdog):
        monkeypatch.setattr(module, "DEADLINE_FLOOR_S", 5.0)
    rows = []
    for module in (jax_watchdog, port_watchdog):
        dog = module.DispatchWatchdog()
        row = [dog.deadline_for("k")]
        dog.observe("k", 0.2)
        row.append(dog.deadline_for("k"))
        for _ in range(20):
            dog.observe("k", 30.0)
        row.append(dog.deadline_for("k"))
        monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "0.3")
        row.append(dog.deadline_for("k"))
        monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "100")
        rows.append(row)
    # cold: the cap; warm: the EWMA x 8, floored; capped; the cap wins
    assert rows[1] == rows[0] == [100.0, 5.0, 100.0, 0.3]


def test_a_failed_reprobe_raises_device_lost(monkeypatch):
    """Retries exhausted on a CUDA device and the re-probe does not
    answer: the port raises ``DeviceLost`` (JAX demotes the process);
    the trips are counted, no demotion is."""
    from mythril_tpu_torch.ops import device_health

    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "0.2")
    monkeypatch.setattr(device_health, "subprocess_probe_ok",
                        lambda timeout_s=None: False)
    dog = port_watchdog.DispatchWatchdog()
    with pytest.raises(DeviceLost):
        dog.supervised("k", lambda: time.sleep(2), device="cuda")
    assert port_stats.watchdog_trips == 3
    assert port_stats.demotions == 0


def test_a_healthy_reprobe_demotes_the_context(monkeypatch):
    from mythril_tpu_torch.ops import device_health

    probes = []
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "0.2")
    monkeypatch.setattr(device_health, "subprocess_probe_ok",
                        lambda timeout_s=None: probes.append(1) or True)
    dog = port_watchdog.DispatchWatchdog()
    with pytest.raises(port_watchdog.DispatchAbandoned):
        dog.supervised("k", lambda: time.sleep(2), device="cuda")
    assert probes == [1]
    assert port_stats.demotions == 1
    # a CPU device is never re-probed
    with pytest.raises(port_watchdog.DispatchAbandoned):
        dog.supervised("k", lambda: time.sleep(2), device="cpu")
    assert probes == [1]


def test_a_trip_on_a_cuda_stream_goes_straight_to_the_reprobe(monkeypatch):
    """A worker that ran on a CUDA stream and tripped may have left its
    launch stuck there, so the port neither retries nor bisects: one
    trip, then the re-probe and the demotion."""
    from mythril_tpu_torch.ops import device_health

    probes = []
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "0.2")
    monkeypatch.setattr(port_watchdog, "_callers_stream", lambda: "stream")
    monkeypatch.setattr(port_watchdog, "_on_stream",
                        lambda stream, thunk: thunk())
    monkeypatch.setattr(device_health, "subprocess_probe_ok",
                        lambda timeout_s=None: probes.append(1) or True)
    dog = port_watchdog.DispatchWatchdog()
    with pytest.raises(port_watchdog.DispatchAbandoned):
        dog.supervised("k", lambda: time.sleep(1), device="cuda")
    assert (port_stats.watchdog_trips, port_stats.dispatch_retries,
            port_stats.demotions, probes) == (1, 0, 1, [1])
    # an injected fault on the same stream still walks the retry rung
    port_faults.get_fault_plane().arm("dispatch_error", times=1)
    assert dog.supervised("k", lambda: port_faults.maybe_fault_dispatch()
                          or "ok", device="cuda") == "ok"
    assert port_stats.dispatch_retries == 1


def test_a_trip_on_a_cuda_stream_is_not_bisected(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "0.2")
    monkeypatch.setattr(port_watchdog, "_callers_stream", lambda: "stream")
    monkeypatch.setattr(port_watchdog, "_on_stream",
                        lambda stream, thunk: thunk())
    backend = port_bs.BatchedSatBackend("cpu")
    calls = []

    def step_fn(sub):
        calls.append(len(sub["status"]))
        return {k: v.copy() for k, v in sub.items()}

    state = {"status": np.zeros(8, np.int32)}
    port_faults.get_fault_plane().arm("dispatch_hang", times=99, hang_s=0.5)
    with pytest.raises(port_watchdog.DispatchAbandoned):
        backend._dispatch_round("frontier:64", step_fn, state, ("status",),
                                np.arange(6))
    assert (port_stats.watchdog_trips, port_stats.dispatch_retries,
            port_stats.bisect_dispatches, port_stats.demotions) == (
        1, 0, 0, 1)
    assert calls == []


def test_a_non_injected_exception_propagates_with_no_retry():
    """JAX's retry rung takes any exception; the port's takes only the
    fault plane's and its own timeout, so a plain ``RuntimeError`` from
    the thunk leaves ``supervised`` unchanged on the first attempt."""
    calls = {"jax": 0, "port": 0}

    def failing(side):
        def thunk():
            calls[side] += 1
            raise RuntimeError("kernel launch failed")
        return thunk

    with pytest.raises(jax_watchdog.DispatchAbandoned):
        jax_watchdog.DispatchWatchdog().supervised("k", failing("jax"))
    assert jax_stats.dispatch_retries == 2
    assert calls["jax"] == 3
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port_watchdog.DispatchWatchdog().supervised("k", failing("port"))
    assert port_stats.dispatch_retries == 0
    assert port_stats.demotions == 0
    assert calls["port"] == 1


def test_an_injected_fault_walks_the_same_rungs_as_jax():
    rows = []
    for module, faults, stats in ((jax_watchdog, jax_faults, jax_stats),
                                  (port_watchdog, port_faults,
                                   port_stats)):
        def thunk(faults=faults):
            faults.maybe_fault_dispatch()
            return "ok"

        faults.get_fault_plane().arm("dispatch_error", times=2)
        assert module.DispatchWatchdog().supervised("k", thunk) == "ok"
        rows.append((stats.dispatch_retries, stats.faults_fired,
                     stats.demotions))
    assert rows[0] == rows[1] == (2, 2, 0)


def test_cancellation_checkpoint_stops_abandoned_workers(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "0.2")
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_RETRIES", "0")
    progressed = []
    resumed = threading.Event()

    def wedge_then_touch_ctx():
        time.sleep(0.6)
        port_watchdog.raise_if_cancelled()
        progressed.append(True)
        resumed.set()

    dog = port_watchdog.DispatchWatchdog()
    with pytest.raises(port_watchdog.DispatchAbandoned):
        dog.supervised("k", wedge_then_touch_ctx)
    assert not resumed.wait(timeout=1.0)
    assert not progressed, "abandoned worker ran past the checkpoint"


def test_supervised_runs_are_counted_with_their_thread_cost():
    dog = port_watchdog.DispatchWatchdog()
    assert [dog.supervised("k", lambda i=i: i) for i in range(3)] == [0, 1, 2]
    assert dog.runs == 3
    assert 0.0 <= dog.thread_s < 1.0


# ---------------------------------------------------------------------------
# the fault plane's specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "dispatch_hang:3:1, rpc_error",
    "lane_poison:9:0:2,dispatch_error",
    "governor_breach:4,merge_abort:1000000",
])
def test_fault_env_spec_parses_like_jax(monkeypatch, spec):
    monkeypatch.setenv("MYTHRIL_TPU_FAULT", spec)
    planes = []
    for faults in (jax_faults, port_faults):
        faults.reset_for_tests()
        planes.append(faults.get_fault_plane())
    assert planes[1]._armed == planes[0]._armed
    point = next(iter(planes[1]._armed))
    lane_ids = [planes[1]._armed[point]["lane"]]
    fired = [[plane.fire(point, lane_ids=lane_ids) is not None
              for _ in range(4)] for plane in planes]
    assert fired[0] == fired[1]
    assert port_faults.FAULT_POINTS == jax_faults.FAULT_POINTS


def test_malformed_fault_spec_fails_loudly(monkeypatch):
    for bad in ("bogus_point:2", "dispatch_hang:lots", "dispatch_hang:1:x"):
        monkeypatch.setenv("MYTHRIL_TPU_FAULT", bad)
        for faults in (jax_faults, port_faults):
            faults.reset_for_tests()
            with pytest.raises(faults.FaultSpecError):
                faults.get_fault_plane()
    monkeypatch.delenv("MYTHRIL_TPU_FAULT")
    monkeypatch.setenv("MYTHRIL_TPU_KILL_AT", "no_such_point")
    port_faults.reset_for_tests()
    with pytest.raises(port_faults.FaultSpecError):
        port_faults.get_fault_plane()


def test_cli_exits_2_on_a_bad_fault_spec(monkeypatch, capsys):
    from mythril_tpu_torch.interfaces import cli

    monkeypatch.setenv("MYTHRIL_TPU_FAULT", "dispatch_hang:lots")
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["analyze", "-c", "6001", "--device", "cpu"])
    assert exit_info.value.code == 2
    assert "bad fault spec" in capsys.readouterr().err


def test_shutdown_join_is_bounded(monkeypatch):
    import mythril_tpu_torch.ops.async_dispatch as ad

    monkeypatch.setenv("MYTHRIL_TPU_SHUTDOWN_JOIN_S", "0.2")
    wedged = threading.Thread(target=lambda: time.sleep(3), daemon=True)
    wedged.start()
    dispatcher = ad.get_async_dispatcher()
    monkeypatch.setattr(dispatcher, "_live_thread", wedged)
    began = time.monotonic()
    ad.join_pending_at_exit()
    assert time.monotonic() - began < 2.0


# ---------------------------------------------------------------------------
# telemetry: the report, the dispatch stats, the registry
# ---------------------------------------------------------------------------


def test_jsonv2_report_carries_degradation_telemetry():
    from mythril_tpu.analysis.report import Report as JaxReport
    from mythril_tpu_torch.analysis.report import Report

    for stats in (jax_stats, port_stats):
        stats.watchdog_trips = 2
        stats.demotions = 1
    port_meta = json.loads(Report().as_swc_standard_format())[0]["meta"]
    jax_meta = json.loads(JaxReport().as_swc_standard_format())[0]["meta"]
    assert port_meta["resilience"] == {"watchdog_trips": 2, "demotions": 1}
    assert jax_meta["resilience"] == port_meta["resilience"]
    port_stats.reset()
    port_meta = json.loads(Report().as_swc_standard_format())[0]["meta"]
    assert "resilience" not in port_meta


def test_dispatch_stats_and_registry_share_the_counters():
    from mythril_tpu_torch.observability.metrics import get_registry

    port_stats.quarantined_lanes = 3
    assert port_bs.dispatch_stats.as_dict()["quarantined_lanes"] == 3
    text = get_registry().render()
    assert "mythril_tpu_resilience_quarantined_lanes 3" in text
    port_bs.dispatch_stats.reset()
    assert port_stats.quarantined_lanes == 0


def test_the_ladder_bisects_over_lane_buckets_with_inert_pads():
    """The bisection's sub-dispatches run in the smallest lane bucket
    with the pads at status 3, and only the lanes that fail alone are
    quarantined."""
    backend = port_bs.BatchedSatBackend("cpu")
    seen = []

    def step_fn(sub):
        seen.append((len(sub["status"]), list(sub["status"])))
        out = {k: v.copy() for k, v in sub.items()}
        out["status"][:] = np.where(sub["status"] == 3, 3, 1)
        return out

    state = {"status": np.zeros(8, np.int32),
             "assign": np.zeros((8, 4), np.int8)}
    port_faults.get_fault_plane().arm("lane_poison", times=99, lane=5)
    out, quarantined = backend._dispatch_round(
        "frontier:64", step_fn, state, ("status", "assign"), np.arange(6))
    assert quarantined == [5]
    assert port_stats.quarantined_lanes == 1
    # [0..2] passes; [3..5] fails, then [3], [4, 5], [4] and [5]
    assert port_stats.bisect_dispatches == 6
    assert list(out["status"][:6]) == [1, 1, 1, 1, 1, 0]
    assert seen == [(4, [0, 0, 0, 3]), (4, [0, 3, 3, 3]),
                    (4, [0, 3, 3, 3])]
