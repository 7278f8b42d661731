"""``myth analyze`` on the port against the JAX package, on the CPU.

Each case runs the JAX package's ``SymExecWrapper`` + ``fire_lasers``
and the port's, one after the other in this process, under the slice
pins (``mythril_tpu_torch/support/support_args.py``; the symbolic
lockstep tier, the word tier, the host probe, the dispatcher pre-split,
the concrete replay, the lane ledger and the autopilot on, on both
sides), with the port's dense tier and lockstep interpreter on
``device="cpu"``.  The issue lists (field by field, with the exploit
transactions' calldata, value and caller, and each issue's concrete
replay status), the total state count, the pre-split's seeded states,
the number of prune calls, every prune call's per-state verdicts, the
solver, probe, word-tier and segment-tier counters, the lane ledger
(its aggregates and records, walls and ids aside) and the autopilot's
counters and tuner overrides must be exactly equal; neither side may
time out.
"""

import contextlib
import importlib
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench
from mythril_tpu.laser.ethereum import svm as jax_svm
from mythril_tpu.ops import batched_sat as jax_bs
from mythril_tpu.support.support_args import args as jax_args
from mythril_tpu_torch import contracts
from mythril_tpu_torch.laser.ethereum import svm as port_svm
from mythril_tpu_torch.ops import batched_sat as port_bs
from mythril_tpu_torch.support.support_args import (
    FORCE_DISPATCH_ARGS,
    SLICE_PINS_ARGS,
    SLICE_PINS_CPU_ENV,
    SLICE_PINS_ENV,
)
from mythril_tpu_torch.support.support_args import args as port_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "mainnet")
ADDRESS = 0x901D12EBE1B195E5AA8748E62BD7734AE19B51F
EXEC_TIMEOUT = 600


def one_device(monkeypatch):
    """``jax.devices()`` of the JAX package reduced to its first device."""
    import jax

    devices = jax.devices
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: devices(*a, **k)[:1])


@pytest.fixture(autouse=True)
def slice_pins(monkeypatch):
    """:func:`analysis_pins` around every test of this file."""
    with analysis_pins(monkeypatch):
        yield


@contextlib.contextmanager
def analysis_pins(monkeypatch):
    """The slice pins on both sides, the force-dispatched rungs
    (:data:`FORCE_DISPATCH_ARGS`) on both sides, and what reads the wall
    clock set out of reach on both sides, so that the parity does not
    depend on the machine: the slow-dispatch fuse, and both packages'
    dispatch watchdogs (a cold jit of a JAX resident solve takes
    seconds here, and so can the port's plain resident solve on a
    loaded machine).  The JAX side sees one device, as the port runs on one: the
    test process's eight forced CPU devices would send its gather tiers
    to the sharded mesh.  The overflow module's annotations iterate in
    creation order on both sides (:func:`numbered_overflow_annotations`)."""
    from mythril_tpu.resilience import watchdog
    from mythril_tpu_torch.resilience import watchdog as port_watchdog

    one_device(monkeypatch)

    for name, value in {**SLICE_PINS_ENV, **SLICE_PINS_CPU_ENV}.items():
        monkeypatch.setenv(name, value)
    for name in ("MYTHRIL_TPU_RESIDENT_KERNEL", "MYTHRIL_TPU_RESIDENT_BUDGET",
                 "MYTHRIL_TPU_RESIDENT_WATCHDOG", "MYTHRIL_TPU_RESIDENT_EXTRA",
                 "MYTHRIL_TPU_FRONTIER_PERIOD", "MYTHRIL_TPU_FRONTIER_FAN",
                 "MYTHRIL_TPU_FRONTIER_DEG", "MYTHRIL_TPU_VERITEST",
                 "MYTHRIL_TPU_MERGE_MAX_ITES", "MYTHRIL_TPU_MERGE_WINDOW",
                 "MYTHRIL_TPU_SUBSUME_PERIOD", *PLANE_KNOBS):
        monkeypatch.delenv(name, raising=False)
    for name, value in DETERMINISTIC_ENV.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(jax_bs, "SLOW_DISPATCH_FUSE_S", float("inf"))
    monkeypatch.setattr(port_bs, "SLOW_DISPATCH_FUSE_S", float("inf"))
    monkeypatch.setattr(watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setattr(port_watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "3600")
    for name, value in SLICE_PINS_ARGS.items():
        monkeypatch.setattr(jax_args, name, value)
    for name, value in FORCE_DISPATCH_ARGS.items():
        monkeypatch.setattr(port_args, name, value)
    # the analysis flags both packages read, at the port's values (a test
    # that ran earlier in this process may have left others behind)
    for name, value in vars(port_args).items():
        if name != "device" and hasattr(jax_args, name):
            monkeypatch.setattr(jax_args, name, value)
    monkeypatch.setattr(port_args, "device", "cpu")
    numbered_overflow_annotations(monkeypatch)
    with fresh_planes():
        yield


#: the knobs of the lane ledger, the tracer and the autopilot, unset for
#: the parity runs (both packages read them)
PLANE_KNOBS = (
    "MYTHRIL_TPU_LEDGER", "MYTHRIL_TPU_LEDGER_CAP", "MYTHRIL_TPU_TRACE",
    "MYTHRIL_TPU_TRACE_CAP", "MYTHRIL_TPU_AUTOPILOT",
    "MYTHRIL_TPU_AUTOPILOT_POLICY", "MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES",
    "MYTHRIL_TPU_AUTOPILOT_LADDER", "MYTHRIL_TPU_AUTOPILOT_TAIL_SHARE",
    "MYTHRIL_TPU_AUTOPILOT_EVAL_EVERY", "MYTHRIL_TPU_TIER_PERIOD",
    "MYTHRIL_TPU_COALESCE_WINDOW",
)
#: The autopilot decides on counts, except for one rule: it declines a
#: lockstep segment shape whose per-lane wall EWMA passes
#: ``MYTHRIL_TPU_SEG_CEIL_MS`` (50 ms by default), a wall-clock reading
#: that differs between the packages and between machines.  The parity
#: runs set that ceiling out of reach on both sides, so that every route
#: they compare is decided on counts.
DETERMINISTIC_ENV = {"MYTHRIL_TPU_SEG_CEIL_MS": "1e9"}

#: the process-wide singletons of the observability planes and the
#: autopilot, in each package
PLANE_MODULES = tuple(
    f"{package}.{module}"
    for package in ("mythril_tpu", "mythril_tpu_torch")
    for module in ("autopilot", "observability.ledger",
                   "observability.spans", "observability.metrics",
                   "observability.flight"))


def reset_planes():
    """Drop both packages' autopilot, lane ledger, tracer, metrics
    registry and flight recorder (each made afresh when next used)."""
    for name in PLANE_MODULES:
        importlib.import_module(name).reset_for_tests()


@contextlib.contextmanager
def fresh_planes():
    """:func:`reset_planes` before and after the block: a singleton made
    under a test's pins (a ledger made disabled, an autopilot's model,
    a tracer left on) must not outlive them, nor one made before them
    serve them; the JAX package's own ledger, autopilot and
    observability tests must not see a port test's counts."""
    reset_planes()
    try:
        yield
    finally:
        reset_planes()


#: the overflow module of each package, whose annotations the parity
#: harness numbers (:func:`numbered_overflow_annotations`)
OVERFLOW_MODULES = {
    side: importlib.import_module(
        f"{package}.analysis.module.modules.integer")
    for side, package in (("jax", "mythril_tpu"),
                          ("port", "mythril_tpu_torch"))
}


def numbered_overflow_annotations(monkeypatch):
    """The overflow module keeps a path's overflow annotations in a set
    and reports (and solves for) them in the set's order, which Python
    takes from the objects' addresses: it changes from one process to
    the next, and differs between the two packages in one process.  On
    both sides each annotation gets the number of its creation within
    the analysis (:func:`_run` restarts the count) as its hash, so that
    both sets iterate in creation order."""
    for module in OVERFLOW_MODULES.values():
        cls = module.OverUnderflowAnnotation

        def numbered(self, *args, _init=cls.__init__, _cls=cls, **kwargs):
            _init(self, *args, **kwargs)
            self.number = next(_cls.numbers)

        monkeypatch.setattr(cls, "__init__", numbered)
        monkeypatch.setattr(cls, "__hash__", lambda self: self.number)
        monkeypatch.setattr(cls, "numbers", itertools.count(),
                            raising=False)


@contextlib.contextmanager
def kept_deadlines():
    """Each package's execution deadline, a process-wide singleton that
    ``sym_exec`` arms, put back as it was when the block ends: a
    deadline left armed would expire under a later test in the same
    process and make its ``get_model`` answer UNSAT."""
    from mythril_tpu.laser.ethereum.time_handler import (
        time_handler as jax_deadline,
    )
    from mythril_tpu_torch.laser.ethereum.time_handler import (
        time_handler as port_deadline,
    )

    handlers = (jax_deadline, port_deadline)
    saved = [handler._deadline_ms for handler in handlers]
    try:
        yield
    finally:
        for handler, value in zip(handlers, saved):
            handler._deadline_ms = value


def _reset_jax():
    from mythril_tpu.analysis.module.loader import ModuleLoader
    from mythril_tpu.laser.ethereum.keccak_function_manager import (
        keccak_function_manager,
    )
    from mythril_tpu.laser.ethereum.transaction import reset_transaction_ids
    from mythril_tpu.smt.solver import reset_blast_context

    reset_blast_context()  # also clears the model cache and the autopilot
    from mythril_tpu.observability import ledger

    ledger.reset_for_tests()  # a fresh process's ledger, as the port's
    for module in ModuleLoader().get_detection_modules():
        module.reset_module()
        module.cache.clear()
    reset_transaction_ids()
    keccak_function_manager.reset()
    jax_bs.dispatch_stats.reset()
    from mythril_tpu.ops import async_dispatch

    dispatcher = async_dispatch.get_async_dispatcher()
    if dispatcher._live_thread is not None:
        dispatcher._live_thread.join()
    dispatcher.pending = None
    async_dispatch.async_stats.reset()


def _issue_fields(issue):
    sequence = issue.transaction_sequence or {}
    return {
        "swc_id": issue.swc_id,
        "address": issue.address,
        "function": issue.function,
        "title": issue.title,
        "severity": issue.severity,
        "description": issue.description,
        "steps": [(step["calldata"], step["value"], step["origin"])
                  for step in sequence.get("steps", [])],
        "concrete_replay": getattr(issue, "concrete_replay", None),
    }


def _run(side, code, tx_count):
    """One analysis on ``side`` ("jax" or "port"); returns what the
    parity tests compare."""
    if side == "jax":
        import mythril_tpu.analysis.security as security
        import mythril_tpu.analysis.symbolic as symbolic
        import mythril_tpu.solidity.evmcontract as evmcontract
        from mythril_tpu.laser.ethereum.time_handler import time_handler
        from mythril_tpu.mythril.mythril_analyzer import MythrilAnalyzer

        svm, stats = jax_svm, jax_bs.dispatch_stats
        from mythril_tpu import autopilot
        from mythril_tpu.observability import ledger

        _reset_jax()
    else:
        import mythril_tpu_torch.analysis.security as security
        import mythril_tpu_torch.analysis.symbolic as symbolic
        import mythril_tpu_torch.solidity.evmcontract as evmcontract
        from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
        from mythril_tpu_torch.mythril.mythril_analyzer import (
            MythrilAnalyzer,
            reset_analysis_state,
        )

        svm, stats = port_svm, port_bs.dispatch_stats
        from mythril_tpu_torch import autopilot
        from mythril_tpu_torch.observability import ledger

        reset_analysis_state()

    annotation = OVERFLOW_MODULES[side].OverUnderflowAnnotation
    if "numbers" in vars(annotation):
        annotation.numbers = itertools.count()
    prunes = []
    real_prune = svm.prune_infeasible

    def recording_prune(states):
        kept = {id(s) for s in real_prune(states)}
        prunes.append([id(s) in kept for s in states])
        return [s for s in states if id(s) in kept]

    cut = []
    real_round = svm.LaserEVM._exec_round

    def watched_round(self, *a, **kw):
        timed_out = real_round(self, *a, **kw)
        cut.append(timed_out is not None)
        return timed_out

    svm.prune_infeasible = recording_prune
    svm.LaserEVM._exec_round = watched_round
    try:
        with kept_deadlines():
            time_handler.start_execution(EXEC_TIMEOUT)
            contract = evmcontract.EVMContract(code=code, name="MAIN")
            sym = symbolic.SymExecWrapper(
                contract,
                address=ADDRESS,
                strategy="bfs",
                max_depth=128,
                execution_timeout=EXEC_TIMEOUT,
                create_timeout=10,
                transaction_count=tx_count,
                compulsory_statespace=False,
            )
            issues = security.fire_lasers(sym)
            # the analyzer's replay of each issue's exploit sequence
            MythrilAnalyzer._confirm_by_replay(issues, contract)
            remaining = time_handler.time_remaining()
    finally:
        svm.prune_infeasible = real_prune
        svm.LaserEVM._exec_round = real_round
    assert not any(cut), f"{side}: a round hit the execution deadline"
    assert remaining > 0, f"{side}: timed out"
    return {
        "issues": sorted((_issue_fields(i) for i in issues),
                         key=lambda f: (f["address"], f["title"])),
        "total_states": sym.laser.total_states,
        "presplit_states": stats.presplit_states,
        "prunes": prunes,
        "dispatches": stats.dispatches,
        "sweeps": (stats.rounds, stats.device_sweeps),
        "counters": {name: _copy(getattr(stats, name)) for name in COUNTERS},
        "ledger": ledger_view(ledger.get_ledger()),
        "autopilot": autopilot_view(autopilot),
    }


def ledger_view(led):
    """What the parity compares of a lane ledger: its aggregates and its
    records, without the walls (``tier_wall_s``) and the record ids."""
    snap = led.snapshot()
    snap.pop("tier_wall_s")
    records = [{k: v for k, v in r.items() if k != "id"}
               for r in led.records]
    return {"aggregates": snap, "records": records}


def autopilot_view(package):
    """What the parity compares of an autopilot: its counters (lanes
    routed, word skips, tail routes, ladder rungs, segments declined,
    tuner steps and reverts) and the tuner's overrides."""
    pilot = package._autopilot
    tuner = pilot.tuner.debug_state() if pilot is not None else {}
    return {"counters": package.counters_snapshot(),
            "overrides": tuner.get("overrides"),
            "tuner_batches": tuner.get("batches")}


def _copy(value):
    return dict(value) if isinstance(value, dict) else value


#: solver-tier and segment-tier counters both packages keep, compared
#: exactly (``boundary_causes`` as a dict)
COUNTERS = (
    "lanes", "unsat", "sat_verified", "undecided", "frontier_steps",
    "learned_clauses", "size_bailouts", "cone_bailouts",
    "resident_dispatches", "resident_exit_all_decided",
    "resident_exit_budget", "resident_exit_watchdog",
    "resident_delegations", "pool_uploads", "delta_uploads", "repacks",
    # the probe phase and the word tier, on by default on both sides
    "host_probe_sat", "word_decided_unsat", "word_decided_sat",
    "word_tightened_bits",
    # the symbolic lockstep tier, on by default on both sides
    "states_stepped", "needs_host_boundaries", "boundary_causes",
    "plane_known_bits", "plane_total_bits", "mem_plane_ops",
    "storage_plane_ops", "keccak_device_hashes",
    # the veritesting tier, on by default on both sides
    "merges", "merged_lanes", "merge_ites", "merge_aborts",
    "subsume_sweeps", "subsumed_lanes",
)


def _parity(code, tx_count):
    jax = _run("jax", code, tx_count)
    port = _run("port", code, tx_count)
    assert port["issues"] == jax["issues"]
    assert port["total_states"] == jax["total_states"]
    assert port["presplit_states"] == jax["presplit_states"]
    assert len(port["prunes"]) == len(jax["prunes"])
    assert port["prunes"] == jax["prunes"]
    assert port["dispatches"] == jax["dispatches"]
    assert port["sweeps"] == jax["sweeps"]
    assert port["counters"] == jax["counters"]
    assert port["ledger"] == jax["ledger"]
    assert port["autopilot"] == jax["autopilot"]
    return jax, port


CORPUS = {name: (code, tx) for name, code, tx, _ in bench._corpus()}


@pytest.mark.parametrize("name", ["killbilly", "overflow_token",
                                  "origin_gate", "veritest_gauntlet"])
def test_corpus_findings_match_jax(name):
    code, tx_count = CORPUS[name]
    jax, _port = _parity(code, tx_count)
    expected = {n: swcs for n, _c, _t, swcs in bench._corpus()}[name]
    assert {i["swc_id"] for i in jax["issues"]} == expected


@pytest.mark.parametrize("name,tx_count", [
    ("suicide_anyone", 1), ("origin_check", 1), ("assert_fail", 1),
    ("delegate_call", 1), ("calldata_echo", 1),
    ("unchecked_add", 2), ("vault_withdraw", 2), ("erc20_transfer", 2),
])
def test_fixture_findings_match_jax(name, tx_count):
    _jax, port = _parity(contracts.fixture(name), tx_count)
    if name == "vault_withdraw":
        # the probe phase and the word tier decide lanes on this one
        counters = port["counters"]
        assert counters["host_probe_sat"] > 0
        assert counters["word_decided_unsat"] > 0


@pytest.mark.parametrize("knob", [None, "MYTHRIL_TPU_SYM_LOCKSTEP",
                                  "MYTHRIL_TPU_SEG_PLANES_MEM"])
def test_constant_key_mapping_matches_jax(monkeypatch, knob):
    """The chip run whose SHA3 windows are concrete: the tier hashes them
    (the keccak kernel's plain version on the port's side) with the same
    issues, states, prunes and counters as the JAX package; with either
    kill switch set on both sides, no hash, and still equal."""
    if knob is not None:
        monkeypatch.setenv(knob, "0")
    _jax, port = _parity(contracts.constant_key_mapping(), 2)
    counters = port["counters"]
    assert {i["swc_id"] for i in port["issues"]} == {"101"}
    assert (counters["keccak_device_hashes"] > 0) == (knob is None)
    assert (counters["states_stepped"] > 0) == (
        knob != "MYTHRIL_TPU_SYM_LOCKSTEP")


#: the CPU tier's cell cap (2^22, the JAX package's interpret tier) is
#: below every LASER frontier of these contracts: the smallest union
#: cone, the selector tree's first fork, is 5521 clauses x 1628 vars,
#: i.e. 8192 x 2048 cells bucketed.  The scale test raises the cap on
#: both sides to let that frontier in, and cuts the step budget to one
#: 48-step round (the JAX interpret sweep of that plane takes ~0.3 s).
SCALE_CPU_CELLS = 1 << 24
SCALE_CPU_STEPS = 48


def test_scale_contract_dispatches_on_both_sides(monkeypatch):
    """A dense dispatch on both sides on the path ``myth analyze``
    takes, with equal rounds and sweeps, and the SWC-106 suicide leaves
    found.  Both sides run the CPU tier with the cell cap and step
    budget of :data:`SCALE_CPU_CELLS` / :data:`SCALE_CPU_STEPS`, with
    the resident solver off so that the dense tier keeps the frontiers
    it would otherwise delegate."""
    import mythril_tpu.ops.pallas_prop as jax_pp
    from mythril_tpu_torch.ops import dense_prop

    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_KERNEL", "0")
    monkeypatch.setattr(jax_pp, "MAX_CELLS_DENSE", SCALE_CPU_CELLS)
    monkeypatch.setattr(jax_pp, "DPLL_STEPS_INTERPRET", SCALE_CPU_STEPS)
    monkeypatch.setattr(jax_pp, "ROUND_BUDGETS_INTERPRET",
                        (SCALE_CPU_STEPS,))
    monkeypatch.setattr(dense_prop, "CPU_TIER", dense_prop.CPU_TIER._replace(
        max_cells=SCALE_CPU_CELLS, steps=SCALE_CPU_STEPS,
        round_budgets=(SCALE_CPU_STEPS,)))
    monkeypatch.setattr(dense_prop, "_backends", {})
    code = bench.scale_contract(depth=3, guard_bits=16, guard="mul")
    jax, port = _parity(code, 1)
    assert jax["dispatches"] >= 1 and port["dispatches"] >= 1
    assert {i["swc_id"] for i in port["issues"]} == {"106"}


#: the rungs' counters both packages keep (dispatch and async statistics)
RUNG_COUNTERS = ("profit_skips", "coalesced_dispatches", "coalesced_lanes",
                 "coalesce_deferred")
ASYNC_COUNTERS = ("launches", "harvested", "unsat", "models", "dropped")


@pytest.mark.parametrize("min_save_s", [0.0, 1e9])
def test_default_rungs_analysis_matches_jax(monkeypatch, min_save_s):
    """``myth analyze`` in the JAX package's default configuration of the
    dispatch rungs (profit gate on, async prefetch on, coalescer on) on
    both sides, with the timing seams pinned: ``device_min_save_s`` at 0
    (the gate never declines, the coalescer defers and merges) or 1e9
    (it always declines and every frontier is prefetched), each
    prefetch joined right after its launch, the coalescer's queue age
    out of reach.  Issues, states, prune verdicts, dispatch and async
    counters equal."""
    from mythril_tpu.ops import async_dispatch as jax_ad
    from mythril_tpu.ops import coalesce as jax_co
    from mythril_tpu_torch.ops import async_dispatch as port_ad
    from mythril_tpu_torch.ops import coalesce as port_co

    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "device_force_dispatch", False)
        monkeypatch.setattr(args, "device_coalesce", True)
        monkeypatch.setattr(args, "async_dispatch", True)
        monkeypatch.setattr(args, "device_min_save_s", min_save_s)
    for co in (jax_co, port_co):
        monkeypatch.setattr(co, "COALESCE_MAX_AGE_S", 1e9)
    for ad in (jax_ad, port_ad):
        launch = ad.AsyncDispatcher.launch

        def joined(self, *a, _launch=launch, **k):
            launched = _launch(self, *a, **k)
            if self._live_thread is not None:
                self._live_thread.join()
            return launched

        monkeypatch.setattr(ad.AsyncDispatcher, "launch", joined)
    code, tx_count = bench.scale_contract(depth=3, guard_bits=16,
                                          guard="mul"), 1
    jax = _run("jax", code, tx_count)
    jax_rungs = [getattr(jax_bs.dispatch_stats, k) for k in RUNG_COUNTERS]
    jax_async = [getattr(jax_ad.async_stats, k) for k in ASYNC_COUNTERS]
    port = _run("port", code, tx_count)
    assert port["issues"] == jax["issues"]
    assert port["total_states"] == jax["total_states"]
    assert port["prunes"] == jax["prunes"]
    assert port["dispatches"] == jax["dispatches"]
    assert port["counters"] == jax["counters"]
    assert [getattr(port_bs.dispatch_stats, k)
            for k in RUNG_COUNTERS] == jax_rungs
    assert [getattr(port_ad.async_stats, k)
            for k in ASYNC_COUNTERS] == jax_async
    if min_save_s:
        assert jax_rungs[0] > 0 and jax_async[0] > 0
        assert port["dispatches"] == 0
    else:
        assert jax_rungs[0] == 0 and port["dispatches"] > 0


def test_scale_contract_resident_solver_at_default_caps():
    """The scale contract at the default caps and the default
    configuration: the dense tier delegates every frontier, and the
    resident solver answers them on both sides, with equal full sweeps,
    gather steps, learned clauses and exits."""
    code = bench.scale_contract(depth=3, guard_bits=16, guard="mul")
    jax, port = _parity(code, 1)
    counters = port["counters"]
    assert counters["resident_dispatches"] >= 1
    assert counters["resident_delegations"] >= 1
    assert counters["frontier_steps"] > 0
    assert port["sweeps"][1] > 0
    assert {i["swc_id"] for i in port["issues"]} == {"106"}


class _State:
    """Stand-in for a GlobalState: ``prune_infeasible`` reads only the
    path constraints."""

    def __init__(self, constraints):
        class _World:
            pass

        self.world_state = _World()
        self.world_state.constraints = constraints


def _distinct_states(count):
    """Feasible states with distinct multiplier guards, which neither the
    host probe nor the word tier decides (so they reach a device tier)."""
    from mythril_tpu_torch.laser.ethereum.state.constraints import (
        Constraints,
    )
    from mythril_tpu_torch.smt import symbol_factory

    bv = symbol_factory.BitVecVal
    x = symbol_factory.BitVecSym("prune_x", 256)
    guard = (x * bv(0x6D2B, 256)) & bv(0xFFFF, 256)
    return [_State(Constraints([guard == bv(0x1234 + 7 * i, 256)]))
            for i in range(count)]


def test_prune_propagates_a_dense_tier_failure(monkeypatch):
    """A failure of the dense tier (or of its kernel) reaches the caller
    of ``prune_infeasible``: no fallback hands the frontier to the CDCL
    in its place."""
    from mythril_tpu_torch.laser.batch import prune_infeasible
    from mythril_tpu_torch.mythril.mythril_analyzer import (
        reset_analysis_state,
    )
    from mythril_tpu_torch.ops.dense_prop import DenseSatBackend

    def broken(self, ctx, assumption_sets):
        raise RuntimeError("sweep kernel failed")

    reset_analysis_state()
    states = _distinct_states(6)
    assert len(prune_infeasible(states)) == 6  # the working path
    reset_analysis_state()
    monkeypatch.setattr(DenseSatBackend, "check_assumption_sets", broken)
    with pytest.raises(RuntimeError, match="sweep kernel failed"):
        prune_infeasible(_distinct_states(6))


def test_dispatch_fuse_follows_the_jax_rule(monkeypatch):
    """The funnel's fuse, as ``mythril_tpu/ops/batched_sat.py`` runs it:
    three zero-decision dispatches blow it for the context; then every
    8th eligible frontier retries, at most three times; a retry that
    decides a lane re-arms it; a slow zero-decision dispatch blows it at
    once and stops the retries; a new context starts armed.  (The
    fixture sets the slow threshold out of reach; here it is the JAX
    package's 10 s.)"""
    from types import SimpleNamespace

    monkeypatch.setattr(port_bs, "SLOW_DISPATCH_FUSE_S", 10.0)

    fuse = port_bs.DispatchFuse()
    ctx = SimpleNamespace(generation=101)
    for _ in range(port_bs.FUTILE_DISPATCH_FUSE):
        assert fuse.admit(ctx)
        fuse.settle(ctx, 0, 0.1)
    admitted = [fuse.admit(ctx) for _ in range(port_bs.FUSE_RETRY_PERIOD)]
    assert admitted == [False] * (port_bs.FUSE_RETRY_PERIOD - 1) + [True]
    fuse.settle(ctx, 0, 0.1)  # the retry decided nothing: still fused
    retries = sum(fuse.admit(ctx) or 0 for _ in range(64))
    assert retries == port_bs.MAX_FUSE_RETRIES - 1
    assert fuse.admit(SimpleNamespace(generation=102))  # new context

    ctx = SimpleNamespace(generation=103)
    for _ in range(port_bs.FUTILE_DISPATCH_FUSE):
        fuse.admit(ctx)
        fuse.settle(ctx, 0, 0.1)
    for _ in range(port_bs.FUSE_RETRY_PERIOD):
        retried = fuse.admit(ctx)
    assert retried
    fuse.settle(ctx, 2, 0.1)  # the retry decided lanes: re-armed
    assert all(fuse.admit(ctx) for _ in range(4))

    ctx = SimpleNamespace(generation=104)
    assert fuse.admit(ctx)
    fuse.settle(ctx, 0, port_bs.SLOW_DISPATCH_FUSE_S + 1)
    assert not any(fuse.admit(ctx) for _ in range(64))


#: ``python3 myth analyze`` with the slice pins that have no CLI flag, on
#: one JAX device
JAX_MYTH = """
import json, runpy, sys
import jax
devices = jax.devices
jax.devices = lambda *a, **k: devices(*a, **k)[:1]  # one device, as the port
pins = json.loads(sys.argv.pop(1))
from mythril_tpu.support.support_args import args
for name, value in pins["args"].items():
    setattr(args, name, value)
sys.argv[0] = "myth"
runpy.run_path("myth", run_name="__main__")
"""


def _jsonv2_issues(stdout):
    issues = json.loads(stdout)[0]["issues"]
    for issue in issues:
        issue["extra"].pop("discoveryTime")
    return issues


def _cli_issues(extra=()):
    """The jsonv2 issues of ``python -m mythril_tpu_torch analyze --device
    cpu`` and of the JAX package's ``myth analyze``, each in a fresh
    process under the slice pins and force-dispatched
    (``--device-force-dispatch --no-async-dispatch``,
    ``MYTHRIL_TPU_COALESCE=0``), with ``extra`` options on both."""
    jax, port = _cli_reports(extra, extra)
    return _jsonv2_issues(jax), _jsonv2_issues(port)


def _cli_reports(jax_extra, port_extra):
    """The jsonv2 reports (stdout) of the two CLIs of
    :func:`_cli_issues`, with options of each side's own."""
    hexfile = os.path.join(FIXTURES, "suicide_anyone.hex")
    common = ["-f", hexfile, "--bin-runtime", "-t", "1",
              "--no-onchain-data", "-o", "jsonv2",
              "--device-force-dispatch", "--no-async-dispatch"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", MYTHRIL_TPU_COALESCE="0",
               **SLICE_PINS_ENV, **SLICE_PINS_CPU_ENV, **DETERMINISTIC_ENV)
    pins = json.dumps({"args": {**SLICE_PINS_ARGS, **FORCE_DISPATCH_ARGS}})
    jax = subprocess.run(
        [sys.executable, "-c", JAX_MYTH, pins, "analyze", *common,
         *jax_extra, "--workers", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert jax.returncode == 0, jax.stderr[-2000:]
    port = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", *common,
         *port_extra, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert port.returncode == 0, port.stderr[-2000:]
    return jax.stdout, port.stdout


def test_cli_report_matches_jax_cli(tmp_path):
    """Both CLIs at their defaults (the dispatcher pre-split, the
    concrete replay, the lane ledger and the autopilot on) report the
    same issues, with ``--trace-out``, ``--metrics-out`` and
    ``--lane-ledger-out`` on both: the port writes all three files; its
    trace has ``traceEvents`` and passes ``scripts/trace_lint.py``'s
    checks, as does its ledger (schema, legal transitions, lane
    conservation); its Prometheus text parses; its ledger's aggregates
    (walls aside) are the JAX package's; the jsonv2
    ``meta.observability`` blocks have the same keys."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import trace_lint

    def flags(side):
        return ["--trace-out", str(tmp_path / f"{side}.trace.json"),
                "--metrics-out", str(tmp_path / f"{side}.prom"),
                "--lane-ledger-out", str(tmp_path / f"{side}.ledger.json")]

    jax, port = _cli_reports(flags("jax"), flags("port"))
    want = _jsonv2_issues(jax)
    assert want and [i["swcID"] for i in want] == ["SWC-106"]
    assert _jsonv2_issues(port) == want
    metas = {side: json.loads(out)[0]["meta"]["observability"]
             for side, out in (("jax", jax), ("port", port))}
    assert sorted(metas["port"]) == sorted(metas["jax"])
    assert metas["port"]["enabled"] and metas["port"]["trace_id"]
    assert metas["port"]["ledger_lanes"] == metas["jax"]["ledger_lanes"] > 0
    trace = json.loads((tmp_path / "port.trace.json").read_text())
    assert trace["traceEvents"] and not trace_lint.lint_trace(trace)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"cli.analyze", "analyzer.contract", "svm.transaction",
            "batch.prune"} <= names
    ledgers = {side: json.loads((tmp_path / f"{side}.ledger.json")
                                .read_text()) for side in ("jax", "port")}
    assert not trace_lint.lint_ledger(ledgers["port"])
    for payload in ledgers.values():
        payload["aggregates"].pop("tier_wall_s")
    assert ledgers["port"]["aggregates"] == ledgers["jax"]["aggregates"]
    samples = parse_prometheus((tmp_path / "port.prom").read_text())
    assert samples["mythril_tpu_ledger_lanes_total"] == (
        metas["port"]["ledger_lanes"])
    assert "mythril_tpu_dispatch_resident_s" in samples


def parse_prometheus(text):
    """Prometheus text exposition -> {sample name with labels: value};
    fails on a line that is neither a comment nor ``name value``."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            assert line.startswith(("# HELP ", "# TYPE ")) or not line
            continue
        name, value = line.rsplit(" ", 1)
        samples[name] = float(value)
    return samples


def test_cli_report_matches_jax_cli_without_presplit():
    """``--no-lockstep-dispatch`` on both CLIs: the pre-split off, the
    same issues."""
    want, got = _cli_issues(["--no-lockstep-dispatch"])
    assert want and [i["swcID"] for i in want] == ["SWC-106"]
    assert got == want


def test_cli_refuses_missing_card_and_unported_options():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    hexfile = os.path.join(FIXTURES, "suicide_anyone.hex")
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
         hexfile, "--bin-runtime", "-t", "1", "--no-onchain-data"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 2
    assert "CUDA" in run.stderr and "--device cpu" in run.stderr
    assert "SWC" not in run.stdout
    # --solv is taken: without a matching binary on PATH (solc-0.8.0,
    # solc0.8.0 or solc) the command ends with the JAX CLI's message
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
         hexfile, "--bin-runtime", "--solv", "0.8.0", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 1, run.stderr[-2000:]
    assert "No matching solc binary found for version 0.8.0" in run.stderr
    assert "not supported by this build" not in run.stderr
    # -g is taken: without a card the command gets as far as the card
    # check
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
         hexfile, "--bin-runtime", "-g", "graph.html"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 2
    assert "CUDA" in run.stderr and "--device cpu" in run.stderr
    assert "not supported by this build" not in run.stderr
    assert not os.path.exists(os.path.join(ROOT, "graph.html"))
    # --workers is taken: without a card the command gets as far as the
    # card check, and on the CPU the analysis runs
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
         hexfile, "--bin-runtime", "-t", "1", "--no-onchain-data",
         "--workers", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 2
    assert "CUDA" in run.stderr and "--device cpu" in run.stderr
    assert "not supported by this build" not in run.stderr
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
         hexfile, "--bin-runtime", "-t", "1", "--no-onchain-data",
         "--workers", "2", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr[-2000:]
    assert "SWC ID: 106" in run.stdout
    # the observability plane's flags are taken: the command gets as far
    # as the card check
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
         hexfile, "--bin-runtime", "--trace-out", os.devnull,
         "--metrics-out", os.devnull, "--lane-ledger-out", os.devnull],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert "not supported by this build" not in run.stderr
    assert run.returncode == 2 and "CUDA" in run.stderr


@pytest.mark.parametrize("flag", ["--lockstep-dispatch",
                                  "--no-lockstep-dispatch"])
def test_cli_takes_the_lockstep_dispatch_flags(flag):
    """Neither pre-split flag is refused any more: the option parses and
    the command gets as far as the card check (exit 2 for the missing
    card, not for the option)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    hexfile = os.path.join(FIXTURES, "suicide_anyone.hex")
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
         hexfile, "--bin-runtime", "-t", "1", "--no-onchain-data", flag],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert "not supported by this build" not in run.stderr
    assert run.returncode == 2 and "CUDA" in run.stderr


def test_port_assembler_builds_the_bench_contracts():
    assert contracts.scale_contract(6, 16, "mul") == bench.scale_contract(
        6, 16, "mul")
    assert contracts.scale_contract(3, 16, "mul") == bench.scale_contract(
        3, 16, "mul")
    assert contracts.corpus() == bench._corpus()


def test_native_keccak_matches_python_and_jax():
    from mythril_tpu.support.crypto import keccak256 as jax_keccak
    from mythril_tpu_torch.native import keccak256 as native_keccak
    from mythril_tpu_torch.support import crypto

    rng = np.random.default_rng(20261016)
    for _ in range(200):
        data = rng.integers(0, 256, size=int(rng.integers(0, 301)),
                            dtype=np.uint8).tobytes()
        want = crypto._keccak256_py(data)
        assert native_keccak(data) == want
        assert crypto.keccak256(data) == want
        assert jax_keccak(data) == want
    assert crypto._load_native() is native_keccak


def test_recorded_swc_sets_match_jax():
    """The SWC sets the chip check holds the card's runs to
    (``contracts.CHIP_RUNS``) are the JAX package's, on the CPU, under
    the slice pins (the word tier, the host probe, the dispatcher
    pre-split, the concrete replay and the veritesting tier on), and so
    are each run's ``dense`` flag (force-dispatched, the JAX funnel
    engages a device tier on exactly the runs so flagged), ``presplit``
    flag (the JAX pre-split seeds exactly those runs) and ``merges``
    count (the JAX veritesting tier's merges); the port builds the same
    contracts."""
    for run in contracts.CHIP_RUNS:
        code = run.code()
        if run.name.startswith("scale_mul"):
            depth = int(run.name.split()[1][1:])
            assert code == bench.scale_contract(depth, 16, "mul")
        jax = _run("jax", code, run.transaction_count)
        assert {i["swc_id"] for i in jax["issues"]} == run.swc_ids, run.name
        assert (jax["dispatches"] >= 1) == run.dense, run.name
        assert (jax["presplit_states"] > 0) == run.presplit, run.name
        assert jax["counters"]["merges"] == run.merges, run.name
    assert contracts.VERITEST_RUN in contracts.CHIP_RUNS
    assert contracts.VERITEST_RUN.merges > 0
