"""The port's proof log (``mythril_tpu_torch/smt/drat.py``, the proof
calls of its native CDCL, the hooks of ``smt/bitblast.py`` and the
confirmations of ``ops/batched_sat.py`` / ``ops/async_dispatch.py``)
against the JAX package's, on the CPU.

The port's counterparts of ``tests/test_drat.py``: both packages' native
solvers record the same event stream for the same clauses and queries
(``np.array_equal``), and both checkers certify it with the same counts,
reject the same tampered stream and certify an assumption of the
constant-FALSE literal.  Under ``proof_log`` a force-dispatched analysis
of scale_mul d4 -t 1 gives the JAX package's findings, dispatches and
stream, with no device-learned clause harvested; the funnel confirms
each device-refuted lane by a bounded host solve before it decides a
state (an unconfirmed lane is left to the tail), and the prefetch's
harvest confirms before it learns.
"""

import random

import numpy as np
import pytest

import bench
import mythril_tpu.smt as JS
import mythril_tpu_torch.smt as PS
from mythril_tpu.native import SatSolver as JaxSolver
from mythril_tpu.smt import drat as jax_drat
from mythril_tpu.support.support_args import args as jax_args
from mythril_tpu_torch.native import SatSolver
from mythril_tpu_torch.smt import drat
from mythril_tpu_torch.support.support_args import args as port_args
from test_solver_torture import _parity_cnf
from test_torch_analyze import _run, analysis_pins, kept_deadlines

SOLVERS = {"jax": JaxSolver, "port": SatSolver}


def parity_instance(solver, rng, num_vars, rows):
    for _ in range(num_vars - 1):
        solver.new_var()
    for _ in range(rows):
        xor_vars = rng.sample(range(2, num_vars + 1), rng.choice((2, 3, 3, 4)))
        for clause in _parity_cnf(xor_vars, rng.getrandbits(1)):
            solver.add_clause(list(clause))


def both_streams(build):
    """``build(solver)`` on a proof-logging solver of each package: the
    two event streams, which must be equal."""
    streams = {}
    for side, cls in SOLVERS.items():
        solver = cls()
        solver.enable_proof()
        assert solver.proof_enabled
        build(solver)
        assert not solver.proof_overflowed
        streams[side] = solver.fetch_proof()
        solver.clear_proof()
        assert solver.fetch_proof().size == 0
    assert np.array_equal(streams["port"], streams["jax"])
    return streams["port"]


@pytest.mark.parametrize("seed", [99, 7, 2026])
def test_unsat_proofs_certify_like_jax(seed):
    """Random parity systems queried under random assumption cubes: the
    same stream from both solvers, certified by both checkers with the
    same counts, several UNSAT verdicts among them."""
    verdicts = []

    def build(solver):
        rng = random.Random(seed)
        for _trial in range(4):
            num_vars = rng.randint(14, 24)
            parity_instance(solver, rng, num_vars, num_vars + 2)
            for _query in range(6):
                cube = [rng.choice((1, -1)) * v for v in rng.sample(
                    range(2, num_vars + 1), rng.randint(2, 6))]
                verdicts.append(solver.solve(cube))

    stream = both_streams(build)
    stats = drat.check_proof(stream)
    assert stats == jax_drat.check_proof(stream)
    assert stats["orig"] > 0
    assert verdicts.count(SatSolver.UNSAT) >= 2
    assert drat.parse_events(stream) == jax_drat.parse_events(stream)


def over_constrained(solver):
    """A parity system with more rows than variables: UNSAT, refuted by
    real search with learned clauses."""
    rng = random.Random(7)
    num_vars = 26
    for _ in range(num_vars - 1):
        solver.new_var()
    for _ in range(num_vars + 10):
        xor_vars = rng.sample(range(2, num_vars + 1), rng.choice((3, 4)))
        for clause in _parity_cnf(xor_vars, rng.getrandbits(1)):
            solver.add_clause(list(clause))
    assert solver.solve([]) == SatSolver.UNSAT


def test_a_tampered_learned_clause_is_rejected_by_both_checkers():
    stream = both_streams(over_constrained)
    assert drat.check_proof(stream) == jax_drat.check_proof(stream)
    events = drat.parse_events(stream)
    learned = [i for i, (marker, lits) in enumerate(events)
               if marker == drat.LEARN and len(lits) >= 2]
    assert learned
    target = learned[len(learned) // 2]
    tampered = []
    for i, (marker, lits) in enumerate(events):
        if i == target:
            lits = lits[:-1]  # stronger than derivable
        tampered.extend([marker, *lits, 0])
    tampered = np.asarray(tampered, dtype=np.int32)
    with pytest.raises(drat.ProofError, match="not RUP"):
        drat.check_proof(tampered)
    with pytest.raises(jax_drat.ProofError, match="not RUP"):
        jax_drat.check_proof(tampered)


def test_the_incremental_checker_feeds_a_growing_stream():
    """Fed a stream in three growing prefixes, the incremental checker
    ends at the whole stream's counts, as the JAX package's does."""
    stream = both_streams(over_constrained)
    ends = [i + 1 for i, v in enumerate(stream) if v == 0]
    cuts = [ends[len(ends) // 3], ends[2 * len(ends) // 3], len(stream)]
    port, jax = drat.IncrementalChecker(), jax_drat.IncrementalChecker()
    for cut in cuts:
        assert port.feed(stream[:cut]) == jax.feed(stream[:cut])
    assert port.feed(stream) == drat.check_proof(stream)


def test_a_false_literal_assumption_certifies():
    """``enable_proof`` emits the constant-TRUE anchor, so assuming the
    constant-FALSE literal certifies."""

    def build(solver):
        solver.add_clause([solver.new_var()])
        assert solver.solve([-1]) == SatSolver.UNSAT

    stream = both_streams(build)
    assert drat.check_proof(stream)["unsat_verdicts"] == 1
    assert jax_drat.check_proof(stream)["unsat_verdicts"] == 1


# ---------------------------------------------------------------------------
# the hooks of the blast context
# ---------------------------------------------------------------------------


@pytest.fixture
def proof_log(monkeypatch):
    """``proof_log`` on both packages, each with a fresh blast context
    made after the flag (a context made before it records nothing)."""
    from mythril_tpu.smt.solver import reset_blast_context as jax_reset
    from mythril_tpu_torch.smt.solver import reset_blast_context

    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "proof_log", True)
    monkeypatch.setattr(port_args, "device", "cpu")
    jax_reset()
    reset_blast_context()
    yield
    jax_reset()
    reset_blast_context()


def test_the_context_refuses_unconfirmed_nogoods_and_device_clauses(
        proof_log):
    """Under ``proof_log`` the context records from its creation, learns
    a nogood only when the caller certified it, harvests no
    device-learned clause, and confirms a refuted cube by a host solve
    that records its ASSUMPTION_CONFLICT event."""
    from mythril_tpu_torch.smt.solver import get_blast_context

    ctx = get_blast_context()
    assert ctx.solver.proof_enabled
    x = PS.symbol_factory.BitVecSym("hooks_x", 8)
    lo = ctx.blast_lit(PS.ULT(x, PS.symbol_factory.BitVecVal(2, 8)).raw)
    hi = ctx.blast_lit(PS.UGT(x, PS.symbol_factory.BitVecVal(9, 8)).raw)
    clauses = ctx.pool.num_clauses
    ctx.learn_nogood([lo, hi])
    assert ctx.pool.num_clauses == clauses  # not certified: refused
    assert ctx.harvest_device_clauses([[-lo, -hi]]) == 0
    assert ctx.device_learned == 0
    assert ctx.confirm_unsat([lo, hi])
    assert not ctx.confirm_unsat([lo])  # satisfiable: no certificate
    ctx.learn_nogood([lo, hi], certified=True)
    assert ctx.pool.num_clauses == clauses + 1
    stats = drat.check_proof(ctx.solver.fetch_proof())
    assert stats["unsat_verdicts"] == 1


def test_certification_warns_without_a_recorded_stream(monkeypatch,
                                                       caplog):
    """``proof_log`` set after the blast context was made: nothing was
    recorded, and the certification says so instead of passing; an
    overflowed stream is reported the same way."""
    import logging

    from mythril_tpu_torch.analysis import security
    from mythril_tpu_torch.smt.solver import (
        get_blast_context, reset_blast_context,
    )

    reset_blast_context()
    get_blast_context()
    monkeypatch.setattr(port_args, "proof_log", True)
    with caplog.at_level(logging.WARNING, logger=security.__name__):
        security._certify_unsat_verdicts()
    assert "NOT certified" in caplog.text and "reset_blast_context" in (
        caplog.text)
    caplog.clear()
    reset_blast_context()
    assert get_blast_context().solver.proof_enabled
    monkeypatch.setattr(SatSolver, "proof_overflowed",
                        property(lambda self: True))
    with caplog.at_level(logging.WARNING, logger=security.__name__):
        security._certify_unsat_verdicts()
    assert "overflowed" in caplog.text
    reset_blast_context()


# ---------------------------------------------------------------------------
# the funnel and the prefetch under proof_log
# ---------------------------------------------------------------------------


@pytest.fixture
def funnel_pins(monkeypatch):
    """The slice pins on both packages with the dense tiers off and the
    word tier off (the device refutations are the subject), a 2-lane
    floor and ``proof_log`` on, each side's funnel on a fresh context."""
    from mythril_tpu.smt.solver import reset_blast_context as jax_reset
    from mythril_tpu_torch.smt.solver import reset_blast_context

    with analysis_pins(monkeypatch), kept_deadlines():
        monkeypatch.setenv("MYTHRIL_TPU_PALLAS", "off")
        monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", "0")
        for args in (jax_args, port_args):
            monkeypatch.setattr(args, "proof_log", True)
            monkeypatch.setattr(args, "device_min_lanes", 2)
            monkeypatch.setattr(args, "batched_solving", True)
        yield
    # no proof-recording context outlives the flag
    jax_reset()
    reset_blast_context()


def lanes_of(S, tag, n, sat_value):
    """``n`` lanes alternating SAT (``x == sat_value + i``) and UNSAT
    (``x < 3 and x > 11``) over one 16-bit symbol each."""
    from importlib import import_module

    package = "mythril_tpu" if S is JS else "mythril_tpu_torch"
    Constraints = import_module(
        f"{package}.laser.ethereum.state.constraints").Constraints
    lanes = []
    for i in range(n):
        x = S.symbol_factory.BitVecSym(f"{tag}{i}", 16)
        if i % 2 == 0:
            lanes.append(Constraints([x == sat_value + i]))
        else:
            lanes.append(Constraints(
                [S.ULT(x, S.symbol_factory.BitVecVal(3, 16)),
                 S.UGT(x, S.symbol_factory.BitVecVal(11, 16))]))
    return lanes


def funnel_run(side, lanes_for, confirm=None):
    """One call of ``side``'s funnel on a fresh context: (verdicts,
    dispatches, device UNSAT lanes, the checker's counts, the stream)."""
    from importlib import import_module

    package = "mythril_tpu" if side == "jax" else "mythril_tpu_torch"
    bs = import_module(f"{package}.ops.batched_sat")
    solver_mod = import_module(f"{package}.smt.solver")
    solver_mod.reset_blast_context()
    bs.dispatch_stats.reset()
    ctx = solver_mod.get_blast_context()
    if confirm is not None:
        ctx.confirm_unsat = confirm
    if side == "jax":
        verdicts = bs.batch_check_states(lanes_for(JS))
    else:
        verdicts = bs.batch_check_states(lanes_for(PS), device="cpu",
                                         tail=False)
    assert ctx.solver.proof_enabled and not ctx.solver.proof_overflowed
    stream = ctx.solver.fetch_proof()
    return (verdicts, bs.dispatch_stats.dispatches, bs.dispatch_stats.unsat,
            drat.check_proof(stream), stream)


def test_device_dispatch_stays_on_under_proof_log(monkeypatch,
                                                  funnel_pins):
    """Force-dispatched: the device refutes the UNSAT lanes, each is
    confirmed on the host before it decides, and the stream certifies
    every one of them; the JAX package's verdicts, counts and stream."""
    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "device_force_dispatch", True)
    out = {side: funnel_run(side, lambda S: lanes_of(S, "plog_dev", 8, 41))
           for side in ("jax", "port")}
    verdicts, dispatches, unsat, stats, stream = out["port"]
    assert dispatches > 0 and unsat > 0
    assert [verdicts[i] for i in range(1, 8, 2)] == [False] * 4
    assert stats["unsat_verdicts"] >= unsat
    assert out["port"][:4] == out["jax"][:4]
    assert np.array_equal(stream, out["jax"][4])


def test_an_unconfirmed_refutation_is_left_to_the_tail(monkeypatch,
                                                       funnel_pins):
    """A device refutation the host does not confirm (its budget ran out)
    decides nothing, on both sides: the lane stays open for the CDCL
    tail, and nothing is learned from it."""
    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "device_force_dispatch", True)
    asked = {"jax": [], "port": []}
    out = {}
    for side in ("jax", "port"):
        def never(lits, conflict_budget=4000, _asked=asked[side]):
            _asked.append(conflict_budget)
            return False

        out[side] = funnel_run(
            side, lambda S: lanes_of(S, "plog_unc", 8, 41), confirm=never)
    verdicts, dispatches, unsat, stats, _stream = out["port"]
    assert dispatches > 0 and unsat == 0
    assert [verdicts[i] for i in range(1, 8, 2)] == [None] * 4
    assert stats["unsat_verdicts"] == 0
    assert asked["port"] and set(asked["port"]) == {4000}
    assert out["port"][:4] == out["jax"][:4]
    assert asked["port"] == asked["jax"]


def forget_prefetch(ad, dispatcher):
    """The prefetch of a package made idle: its worker joined, its batch
    forgotten, its statistics zeroed."""
    if dispatcher._live_thread is not None:
        dispatcher._live_thread.join()
    dispatcher.pending = None
    ad.async_stats.reset()


def test_the_prefetch_harvest_confirms_before_it_learns(monkeypatch,
                                                        funnel_pins):
    """The profit gate declines, the prefetch refutes the UNSAT lanes;
    its harvest confirms each (a bounded solve of 1,000 conflicts) before
    the memo and the nogood take it, so the stream certifies every
    harvested refutation; the JAX package's counts and stream."""
    from importlib import import_module

    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "device_force_dispatch", False)
        monkeypatch.setattr(args, "async_dispatch", True)
        monkeypatch.setattr(args, "device_min_save_s", 1e9)
    out = {}
    for side, package, S, kwargs in (
            ("jax", "mythril_tpu", JS, {}),
            ("port", "mythril_tpu_torch", PS,
             {"device": "cpu", "tail": False})):
        ad = import_module(f"{package}.ops.async_dispatch")
        bs = import_module(f"{package}.ops.batched_sat")
        solver_mod = import_module(f"{package}.smt.solver")
        dispatcher = ad.get_async_dispatcher()
        forget_prefetch(ad, dispatcher)
        solver_mod.reset_blast_context()
        bs.dispatch_stats.reset()
        ctx = solver_mod.get_blast_context()
        budgets = []
        confirm = ctx.confirm_unsat

        def counting(lits, conflict_budget=4000, _confirm=confirm,
                     _budgets=budgets):
            _budgets.append(conflict_budget)
            return _confirm(lits, conflict_budget=conflict_budget)

        ctx.confirm_unsat = counting
        bs.batch_check_states(lanes_of(S, "plog_async", 6, 7), **kwargs)
        assert ad.async_stats.launches == 1
        if dispatcher._live_thread is not None:
            dispatcher._live_thread.join(timeout=120)
        assert not budgets  # nothing confirmed before the harvest
        dispatcher.harvest(ctx)
        stream = ctx.solver.fetch_proof()
        out[side] = (ad.async_stats.harvested, ad.async_stats.unsat,
                     budgets, drat.check_proof(stream), stream)
        forget_prefetch(ad, dispatcher)
        solver_mod.reset_blast_context()
    harvested, unsat, budgets, stats, stream = out["port"]
    assert harvested == 1 and unsat > 0
    assert budgets == [1000] * unsat
    assert stats["unsat_verdicts"] >= unsat
    assert out["port"][:4] == out["jax"][:4]
    assert np.array_equal(stream, out["jax"][4])


# ---------------------------------------------------------------------------
# an analysis under proof_log
# ---------------------------------------------------------------------------


def test_proof_log_analysis_matches_jax(monkeypatch):
    """scale_mul d4 -t 1 under ``proof_log``, force-dispatched, on both
    packages (the parity harness of ``test_torch_analyze``): the same
    issues, states, prune verdicts, dispatches and counters; each
    package certifies its run in ``fire_lasers``; the two streams are
    equal and certify with the same counts, with UNSAT verdicts among
    them and no device-learned clause harvested."""
    from mythril_tpu.smt.solver import get_blast_context as jax_context
    from mythril_tpu_torch.smt.solver import get_blast_context

    from mythril_tpu.smt.solver import reset_blast_context as jax_reset
    from mythril_tpu_torch.smt.solver import reset_blast_context

    code = bench.scale_contract(4, 16, "mul")
    with analysis_pins(monkeypatch):
        for args in (jax_args, port_args):
            monkeypatch.setattr(args, "proof_log", True)
        jax = _run("jax", code, 1)
        jax_stream = jax_context().solver.fetch_proof()
        port = _run("port", code, 1)
        ctx = get_blast_context()
        assert ctx.solver.proof_enabled and not ctx.solver.proof_overflowed
        stream = ctx.solver.fetch_proof()
        assert ctx.device_learned == 0
    for key in ("issues", "total_states", "prunes", "dispatches", "sweeps",
                "counters", "ledger", "autopilot"):
        assert port[key] == jax[key], key
    assert {i["swc_id"] for i in port["issues"]} == {"106"}
    assert port["dispatches"] > 0
    assert port["counters"]["learned_clauses"] == 0
    jax_reset()
    reset_blast_context()
    assert np.array_equal(stream, jax_stream)
    stats = drat.check_proof(stream)
    assert stats == jax_drat.check_proof(jax_stream)
    assert stats["unsat_verdicts"] >= 1 and stats["orig"] > 10_000
