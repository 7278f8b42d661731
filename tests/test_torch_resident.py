"""The port's resident solver (``mythril_tpu_torch/ops/resident.py``,
run on the plain versions of the kernels of ``ops/frontier_kernels.py``)
against the JAX package's ``mythril_tpu/ops/resident.py`` on the CPU:
every field of the state, the shared learned-row pool and the loop
counters included, equal after one dispatch, on seeded random CNFs that
reach every exit and both ways an append can drop a row; and a failure
of the resident solve reaching the caller of ``prune_infeasible``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mythril_tpu.ops import resident as JR
from mythril_tpu.ops.frontier import build_adjacency
from mythril_tpu_torch.ops import frontier_kernels as FK
from mythril_tpu_torch.ops import resident as PR

from test_torch_frontier import KNOBS, random_assign, random_cnf

#: (seed, vars, clause ratio, lanes, real lanes, knobs)
CASES = [
    (11, 50, 4.3, 8, 6, {}),
    (12, 60, 4.2, 16, 13, {"MYTHRIL_TPU_RESIDENT_EXTRA": "4"}),
    (13, 60, 4.2, 8, 6, {"MYTHRIL_TPU_RESIDENT_BUDGET": "40"}),
    (17, 40, 3.0, 8, 6, {"MYTHRIL_TPU_RESIDENT_WATCHDOG": "1"}),
]


@pytest.fixture(scope="module")
def results():
    """Every case through both solvers, once per module, with a record
    of each epilogue's append: (rows learned, pool rows before, after,
    cap)."""
    mp = pytest.MonkeyPatch()
    out = []
    try:
        for seed, nv, ratio, B, n_real, knobs in CASES:
            for name in KNOBS:
                mp.delenv(name, raising=False)
            for name, value in knobs.items():
                mp.setenv(name, value)
            rng = np.random.default_rng(seed)
            lits = random_cnf(rng, nv, ratio)
            assign = random_assign(rng, nv, B, n_real)
            adj = build_adjacency(lits, nv + 1)
            state = JR.resident_state0(assign, n_real, 256)
            step = JR.make_resident_step(nv, 256)
            jout = step(jnp.asarray(lits), jnp.asarray(adj),
                        *[jnp.asarray(state[k])
                          for k in JR.RESIDENT_STATE_FIELDS])
            want = {k: np.asarray(v)
                    for k, v in zip(JR.RESIDENT_STATE_FIELDS, jout)}
            appends = []
            real = FK._round_epilogue_plain

            def recording(loop, parity):
                ctl = loop.ctl
                before = int(ctl[parity, FK.NEXTRA])
                learned = int((loop.buf["okl"] != 0).sum())
                real(loop, parity)
                if not int(ctl[parity, FK.HALT]):
                    appends.append((learned, before,
                                    int(ctl[1 - parity, FK.NEXTRA]),
                                    loop.cfg.extra_cap))

            mp.setattr(FK, "_round_epilogue_plain", recording)
            got = PR.resident_solve(torch.from_numpy(lits),
                                    torch.from_numpy(adj), state)
            mp.setattr(FK, "_round_epilogue_plain", real)
            reason = (
                PR.exit_reason(got["status"], int(got["stall"][0]),
                               int(got["itc"][0]),
                               PR.resident_watchdog_limit(),
                               PR.resident_budget()),
                JR.exit_reason(want["status"], int(want["stall"][0]),
                               int(want["itc"][0]),
                               JR.resident_watchdog_limit(),
                               JR.resident_budget()),
            )
            out.append((want, got, appends, reason))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", range(len(CASES)))
def test_resident_solve_matches_jax(results, case):
    want, got, _appends, reason = results[case]
    for name in JR.RESIDENT_STATE_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert reason[0] == reason[1]


def test_resident_cases_are_not_vacuous(results):
    """Between them the cases reach every exit, decide lanes both ways,
    learn, append to the shared pool, drop a duplicate row (twin lanes
    learn equal clauses) and overflow the pool."""
    reasons = [r[0] for _w, _g, _a, r in results]
    assert {"all_decided", "budget", "watchdog"} <= set(reasons)
    status = np.concatenate([w["status"] for w, _g, _a, _r in results])
    assert (status == 1).any() and (status == 2).any()
    assert all(int(w["nlearn"].sum()) > 0 for w, _g, _a, _r in results)
    appends = [a for _w, _g, rec, _r in results for a in rec]
    assert any(after > before for _n, before, after, _cap in appends)
    # a duplicate: fewer rows appended than learned, with room left
    assert any(after - before < learned and before + learned <= cap
               for learned, before, after, cap in appends)
    # an overflow: the pool at its cap with rows still learned
    assert any(after == cap and before + learned > cap and learned
               for learned, before, after, cap in appends)


def test_resident_solve_on_the_learning_problem_matches_jax(monkeypatch):
    """``frontiers.learning_problem`` (the chip check's input for the
    frontier kernels, here at a small size) through both resident
    solvers: every field equal, and the run holds what the kernels'
    learning paths must be held on: several lanes learning in one
    iteration, equal rows from twin lanes, a lane re-learning a row of
    the shared pool, an overflow of the pool, and cascades."""
    from mythril_tpu_torch import frontiers

    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    C, V1, B, E, prefill = 1024, 513, 8, 8, 6
    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_EXTRA", str(E))
    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_BUDGET", "40")
    rows, assign, extra = frontiers.learning_problem(C, V1, B, E,
                                                     prefill=prefill)
    adj = build_adjacency(rows, V1)
    state = JR.resident_state0(assign, B, 256)
    state["extra"] = extra
    state["nextra"] = np.array([prefill], np.int32)
    jout = JR.make_resident_step(V1 - 1, 256)(
        jnp.asarray(rows), jnp.asarray(adj),
        *[jnp.asarray(state[k]) for k in JR.RESIDENT_STATE_FIELDS])
    want = {k: np.asarray(v) for k, v in zip(JR.RESIDENT_STATE_FIELDS, jout)}

    events = []
    real = FK._round_epilogue_plain

    def recording(loop, parity):
        ctl, buf = loop.ctl, loop.buf
        ne = int(ctl[parity, FK.NEXTRA])
        okl = buf["okl"] != 0
        learned = [tuple(r) for r in buf["litrow"][okl].tolist()]
        pool = {tuple(r) for r in loop.extra[:ne].tolist()}
        cascades = int(((buf["flags"] & FK.FLAG_CASCADE) != 0).sum())
        halted = int(ctl[parity, FK.HALT])
        real(loop, parity)
        if not halted:
            events.append((learned, pool, ne, int(ctl[1 - parity, FK.NEXTRA]),
                           cascades))

    monkeypatch.setattr(FK, "_round_epilogue_plain", recording)
    got = PR.resident_solve(torch.from_numpy(rows), torch.from_numpy(adj),
                            state)
    for name in JR.RESIDENT_STATE_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert any(len(learned) >= 2 for learned, *_ in events)
    assert any(len(set(learned)) < len(learned) for learned, *_ in events)
    assert any(set(learned) & pool for learned, pool, *_ in events)
    assert any(after == E and ne + len(set(learned) - pool) > E
               for learned, pool, ne, after, _c in events)
    assert any(cascades for *_, cascades in events)


def test_state_layout_and_knobs_match_jax():
    assert PR.RESIDENT_LANE_FIELDS == JR.RESIDENT_LANE_FIELDS
    assert PR.RESIDENT_SHARED_FIELDS == JR.RESIDENT_SHARED_FIELDS
    assert PR.resident_budget() == JR.resident_budget()
    assert PR.resident_watchdog_limit() == JR.resident_watchdog_limit()
    assert PR.resident_extra_cap() == JR.resident_extra_cap()
    assign = np.zeros((4, 9), np.int8)
    got = PR.resident_state0(assign, 3, 256, extra_cap=5)
    want = JR.resident_state0(assign, 3, 256, extra_cap=5)
    for name in JR.RESIDENT_STATE_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for args in ((np.array([1, 2]), 0, 0, 8, 9),
                 (np.array([0, 3]), 8, 0, 8, 9),
                 (np.array([0, 3]), 2, 9, 8, 9)):
        assert PR.exit_reason(*args) == JR.exit_reason(*args)


def test_prune_propagates_a_resident_solve_failure(monkeypatch):
    """A failure of the resident solve (or of its kernels) reaches the
    caller of ``prune_infeasible``: no fallback hands the frontier to
    the CDCL in its place.  Force-dispatched, so that the frontier
    reaches the resident solver whatever the profit gate would say."""
    from mythril_tpu_torch.laser.batch import prune_infeasible
    from mythril_tpu_torch.mythril.mythril_analyzer import (
        reset_analysis_state,
    )
    from mythril_tpu_torch.ops import batched_sat as port_bs
    from mythril_tpu_torch.support.support_args import FORCE_DISPATCH_ARGS
    from mythril_tpu_torch.support.support_args import args as port_args
    from test_torch_analyze import _distinct_states

    monkeypatch.setattr(port_args, "device", "cpu")
    for name, value in FORCE_DISPATCH_ARGS.items():
        monkeypatch.setattr(port_args, name, value)
    reset_analysis_state()
    assert len(prune_infeasible(_distinct_states(6))) == 6
    assert port_bs.dispatch_stats.resident_dispatches == 1  # delegated

    def broken(lits, adj, state):
        raise RuntimeError("resident kernel failed")

    reset_analysis_state()
    monkeypatch.setattr(PR, "resident_solve", broken)
    with pytest.raises(RuntimeError, match="resident kernel failed"):
        prune_infeasible(_distinct_states(6))
