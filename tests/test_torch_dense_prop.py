"""The port's dense tier (``mythril_tpu_torch/ops/dense_prop.py`` and
``ops/dense_sweep.py``) against the JAX package's Pallas tier.

The JAX side runs as its own tests run it on the CPU: the Pallas sweep
in interpret mode, under ``MYTHRIL_TPU_PALLAS=force`` with the resident
kernel, word tier and autopilot off.  The port runs with
``device="cpu"``, where the sweep wrapper takes its plain version.
Inputs are made from numpy seeds and handed to both.  Every comparison
is exact: the sweeps count 0/1 products in float32 (exact below 2^24),
and the DPLL control flow is integer/sign logic.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mythril_tpu.smt as JS
from mythril_tpu.ops import batched_sat as jax_bs
from mythril_tpu.ops import pallas_prop as jax_pp
from mythril_tpu.smt.solver import get_blast_context as jax_context
from mythril_tpu.smt.solver import reset_blast_context as jax_reset
from mythril_tpu_torch import frontiers
from mythril_tpu_torch.native import SatSolver
from mythril_tpu_torch.ops import batched_sat as port_bs
from mythril_tpu_torch.ops import dense_prop as port_dp
from mythril_tpu_torch.ops.carry import frontier_from_numpy, state_from_numpy
from mythril_tpu_torch.ops.dense_sweep import rows_to_planes, sweep_plain
from mythril_tpu_torch.ops.incremental import reset_cone_memo


@pytest.fixture(autouse=True)
def slice_config(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_PALLAS", "force")
    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_KERNEL", "0")
    monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", "0")
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT", "0")
    jax_reset()
    reset_cone_memo()
    yield
    jax_reset()


def _random_planes(rng, C, V, density=0.03):
    P = (rng.random((C, V)) < density).astype(np.float32)
    N = (rng.random((C, V)) < density).astype(np.float32) * (1 - P)
    P[:, :2] = 0
    N[:, :2] = 0
    width = (P.sum(1) + N.sum(1))[None, :].astype(np.float32)
    width[0, -C // 8:] = 0  # bucket-padding rows
    return P, N, width


def _random_assignment(rng, B, V):
    A = rng.choice([-1.0, 0.0, 0.0, 1.0], size=(B, V)).astype(np.float32)
    A[:, 0] = 0.0
    A[:, 1] = 1.0
    return A


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("scores", [True, False])
@pytest.mark.parametrize("rows", [None, 256])
def test_sweep_plain_matches_pallas_sweep(scores, rows):
    """``sweep_plain`` equals ``_make_dpll_sweep(..., interpret=True)``
    on numpy-seeded planes, with scores on and off, full and hot prefix."""
    rng = np.random.default_rng(7)
    C, V, B = 512, 128, 8
    P, N, width = _random_planes(rng, C, V)
    A = _random_assignment(rng, B, V)
    TC = jax_pp._tile_c(C, V)
    call = jax_pp._make_dpll_sweep(rows or C, V, B, TC, True, scores)
    want = call(jnp.asarray(P, jnp.bfloat16), jnp.asarray(N, jnp.bfloat16),
                jnp.asarray(width), jnp.asarray(A))
    got = sweep_plain(_bf16(P), _bf16(N), torch.from_numpy(width),
                      torch.from_numpy(A), scores, rows)
    assert len(got) == len(want) == (5 if scores else 3)
    # Pallas returns (fpos, fneg, conf, spos, sneg)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert float(got[0].sum()) > 0  # vacuity: some clause is unit


@pytest.mark.parametrize("decisions", [True, False])
def test_batched_sweep_matches_xla(decisions):
    rng = np.random.default_rng(11)
    B, C, V = 8, 256, 128
    planes = [_random_planes(rng, C, V) for _ in range(B)]
    P = np.stack([p for p, _, _ in planes])
    N = np.stack([n for _, n, _ in planes])
    W = np.concatenate([w for _, _, w in planes])
    A = _random_assignment(rng, B, V)
    want = jax_pp._make_batched_sweep(decisions)(
        jnp.asarray(P, jnp.bfloat16), jnp.asarray(N, jnp.bfloat16),
        jnp.asarray(W), jnp.asarray(A),
    )
    got = port_dp._make_batched_sweep(decisions)(
        torch.from_numpy(P), torch.from_numpy(N), torch.from_numpy(W),
        torch.from_numpy(A),
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _planted_cnf(rng, num_vars, num_clauses):
    planted = {v: rng.random() < 0.5 for v in range(2, num_vars + 2)}
    clauses = []
    for _ in range(num_clauses):
        picks = rng.sample(sorted(planted), 3)
        lits = [v if rng.random() < 0.5 else -v for v in picks]
        if not any((lit > 0) == planted[abs(lit)] for lit in lits):
            lits[0] = -lits[0]
        clauses.append(tuple(lits))
    return clauses


@pytest.mark.parametrize("tiered", [False, True])
def test_round_loop_state_matches(tiered):
    """One ``_dpll_round_loop`` budget from the same state: every state
    field and ``steps_used`` equal, with and without the hot tier."""
    rng = random.Random(5)
    num_vars, B, budget = 90, 8, 48
    clauses = _planted_cnf(rng, num_vars, 400)
    jpool = jax_pp.DenseClausePool()
    jpool.refresh(clauses, num_vars + 1)
    ppool = port_dp.DenseClausePool("cpu")
    ppool.refresh(clauses, num_vars + 1)
    for jplane, pplane in zip((jpool.P, jpool.N), rows_to_planes(
            ppool.rows, ppool.V)):
        assert np.array_equal(np.asarray(jplane, np.float32),
                              pplane.float().numpy())
    C, V = jpool.C, jpool.V
    np_rng = np.random.default_rng(3)
    A0 = np.zeros((B, V), np.float32)
    A0[:, 1] = 1.0
    A0[:, num_vars + 2:] = 1.0
    for lane in range(B):  # a few assumption literals per lane
        cols = np_rng.choice(np.arange(2, num_vars + 2), 3, replace=False)
        A0[lane, cols] = np_rng.choice([-1.0, 1.0], 3)
    pref = np_rng.choice([-1.0, 0.0, 1.0], size=V).astype(np.float32)
    D = min(port_dp.MAX_DECISIONS, V)
    state = jax_pp._dpll_state0(A0, D, B - 1, pref)
    hot_c, period = (256, 4) if tiered else (0, 1)
    jfn = jax_pp.make_dense_rounds(C, V, B, budget, True,
                                   jax_pp.MAX_DECISIONS, hot_c, period)
    jout = jfn(jpool.P, jpool.N, jpool.width,
               *[jnp.asarray(a) for a in state])
    pfn = port_dp.make_dense_rounds(C, V, B, budget, port_dp.CPU_TIER,
                                    port_dp.MAX_DECISIONS, hot_c, period)
    pout = pfn(*ppool.rows,
               *state_from_numpy(state, device="cpu"))
    assert int(jout[-1]) == pout[-1] > 0
    for name, j, p in zip(jax_pp.DPLL_STATE_FIELDS, jout[:-1], pout[:-1]):
        assert np.array_equal(np.asarray(j), p.numpy()), name
    status = pout[port_dp._STATUS_IDX][:, 0].numpy()
    assert (status != 0).any()  # the budget decided something


def _per_lane_recipe(S):
    """Disjoint cones (one variable per lane): the per-lane layout."""
    bv = S.symbol_factory.BitVecVal
    lanes = []
    for i in range(8):
        x = S.symbol_factory.BitVecSym(f"lane_x{i}", 12)
        if i % 3 == 1:
            lanes.append([S.ULT(x, bv(5, 12)), S.UGT(x, bv(10, 12))])
        else:
            lanes.append([x * bv(2 * i + 3, 12) == bv(100 + i, 12)])
    return lanes


LAYOUTS = {
    "union": lambda S: frontiers.guard_chain_frontier(
        8, 8, 2, smt=S, calldata="words")[0],
    "union_scale_mul": lambda S: frontiers.scale_mul_frontier(
        3, 8, smt=S, calldata="words")[0],
    "per-lane": _per_lane_recipe,
}


@pytest.mark.parametrize("recipe", sorted(LAYOUTS))
def test_backend_matches_pallas_backend(recipe):
    """``DenseSatBackend(device="cpu")`` against ``PallasSatBackend`` on
    the carried-across pool and cones: per-lane results, assignments,
    rounds and sweeps equal, for both layouts."""
    jctx = jax_context()
    lanes = LAYOUTS[recipe](JS)
    sets = [list(dict.fromkeys(jctx.blast_lit(c.raw) for c in lane))
            for lane in lanes]
    before = (jax_bs.dispatch_stats.rounds,
              jax_bs.dispatch_stats.device_sweeps)
    jresults, jassign = jax_pp.PallasSatBackend().check_assumption_sets(
        jctx, sets
    )
    jrounds = jax_bs.dispatch_stats.rounds - before[0]
    jsweeps = jax_bs.dispatch_stats.device_sweeps - before[1]

    lits, indptr = jctx.pool.csr()
    carried = frontier_from_numpy(
        lits, indptr, jctx.solver.num_vars,
        [(s, *jctx.cone(s)) for s in sets],
    )
    port_bs.dispatch_stats.reset()
    backend = port_dp.DenseSatBackend(device="cpu")
    presults, passign = backend.check_assumption_sets(carried, sets)
    assert backend.last_layout == recipe.split("_")[0]
    assert presults == jresults
    assert np.array_equal(passign, jassign)
    assert port_bs.dispatch_stats.rounds == jrounds > 0
    assert port_bs.dispatch_stats.device_sweeps == jsweeps > 0
    assert False in presults  # vacuity: the device refuted a lane


@pytest.mark.parametrize("recipe", sorted(LAYOUTS))
def test_backend_counts_round_budgets_and_hot_view_steps(recipe,
                                                         monkeypatch):
    """``dispatch_stats.dense_round_budgets`` counts the rounds the
    ladder ran by their step budget, and ``hot_view_steps`` the steps
    that swept only the hot prefix: each equal to what the round makers
    and the step saw."""
    jctx = jax_context()
    lanes = LAYOUTS[recipe](JS)
    sets = [list(dict.fromkeys(jctx.blast_lit(c.raw) for c in lane))
            for lane in lanes]
    lits, indptr = jctx.pool.csr()
    carried = frontier_from_numpy(
        lits, indptr, jctx.solver.num_vars,
        [(s, *jctx.cone(s)) for s in sets],
    )
    budgets, views = {}, []
    for name in ("make_dense_rounds", "make_batched_rounds"):
        def maker(C, V, B, budget, *args, _real=getattr(port_dp, name),
                  **kwargs):
            budgets[budget] = budgets.get(budget, 0) + 1
            return _real(C, V, B, budget, *args, **kwargs)
        monkeypatch.setattr(port_dp, name, maker)
    real_step = port_dp.dpll_step

    def step(state, outs, flags, k, full_view, *args):
        views.append(full_view)
        return real_step(state, outs, flags, k, full_view, *args)
    monkeypatch.setattr(port_dp, "dpll_step", step)
    port_bs.dispatch_stats.reset()
    port_dp.DenseSatBackend(device="cpu").check_assumption_sets(carried,
                                                                sets)
    stats = port_bs.dispatch_stats
    assert stats.dense_round_budgets == budgets
    assert sum(budgets.values()) == stats.rounds > 0
    assert set(budgets) <= set(port_dp.CPU_TIER.round_budgets)
    assert stats.hot_view_steps == views.count(False)
    assert len(views) >= stats.device_sweeps > 0


@pytest.mark.parametrize("caps, want", [
    ({"max_vars": 1, "max_clauses": 1}, "union C+V; per-lane C+V"),
    ({"max_cells": 1}, "union cells; per-lane cells"),
])
def test_backend_counts_declines_by_cap(caps, want):
    """A dispatch that no dense layout fits is declined (None, for the
    gather tiers) and counted in ``dense_declines`` and, by the caps
    each layout passed, in ``dense_decline_caps``."""
    jctx = jax_context()
    lanes = LAYOUTS["union"](JS)
    sets = [list(dict.fromkeys(jctx.blast_lit(c.raw) for c in lane))
            for lane in lanes]
    lits, indptr = jctx.pool.csr()
    carried = frontier_from_numpy(
        lits, indptr, jctx.solver.num_vars,
        [(s, *jctx.cone(s)) for s in sets],
    )
    backend = port_dp.DenseSatBackend(device="cpu")
    backend.tier = backend.tier._replace(**caps)
    port_bs.dispatch_stats.reset()
    assert backend.check_assumption_sets(carried, sets) is None
    assert port_bs.dispatch_stats.dense_declines == 1
    assert port_bs.dispatch_stats.dense_decline_caps == {want: 1}
    assert port_bs.dispatch_stats.rounds == 0


def test_differential_random_cnf_vs_cdcl():
    """Random 3-CNF instances: the port's dense DPLL never calls a
    satisfiable instance UNSAT, its SAT assignments satisfy every
    clause, and it decides every tiny instance (as test_pallas.py does
    for the JAX kernel)."""
    rng = random.Random(1234)
    truths, unsats = [], 0
    for trial in range(12):
        num_vars = rng.randint(4, 10)
        clauses = [
            tuple(rng.choice([1, -1]) * rng.randint(2, num_vars + 1)
                  for _ in range(rng.randint(1, 3)))
            for _ in range(rng.randint(6, 42))
        ]
        ref = SatSolver()
        for _ in range(num_vars + 2):
            ref.new_var()
        ok = all(ref.add_clause(list(c)) for c in clauses)
        truth = ok and ref.solve([1]) == SatSolver.SAT
        pool = port_dp.DenseClausePool("cpu")
        pool.refresh(clauses, num_vars + 1)
        B = 8
        A0 = np.zeros((B, pool.V), np.float32)
        A0[:, 1] = 1.0
        A0[:, num_vars + 2:] = 1.0
        D = min(port_dp.MAX_DECISIONS, pool.V)
        rounds = port_dp.make_dense_rounds(
            pool.C, pool.V, B, 96, port_dp.CPU_TIER
        )
        out = rounds(*pool.rows,
                     *port_dp._dpll_state0(A0, D, B, "cpu"))
        status = int(out[port_dp._STATUS_IDX][0, 0])
        truths.append(truth)
        if status == 2:
            unsats += 1
            assert not truth, f"trial {trial}: UNSAT on a SAT instance"
        elif status == 1:
            assert truth, f"trial {trial}: SAT on an UNSAT instance"
            signs = np.sign(out[0][0].numpy())
            for clause in clauses:
                assert any(signs[abs(l)] == (1 if l > 0 else -1)
                           for l in clause)
        assert status in (1, 2), f"trial {trial}: undecided tiny CNF"
    assert any(truths) and not all(truths) and unsats > 0


def test_clause_pool_defaults_to_the_card(monkeypatch):
    """``DenseClausePool()`` takes the entry points' default device: with
    no card it raises the "needs a CUDA device" error (it built its planes
    on the CPU before); asked for the CPU, it builds its rows there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        port_dp.DenseClausePool()
    pool = port_dp.DenseClausePool("cpu")
    pool.refresh([(2, 3), (-2, 3)], 4)
    assert pool.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in pool.rows) and pool.C >= 2


def test_state_from_numpy_defaults_to_the_card():
    """``carry.state_from_numpy`` resolves its device as every entry
    point of the port does: the card unless the caller passes
    ``device="cpu"``, and no silent CPU fall back without one."""
    state = [np.arange(6, dtype=np.int32).reshape(2, 3),
             np.ones((2,), dtype=np.int8)]
    on_cpu = state_from_numpy(state, device="cpu")
    assert [t.device.type for t in on_cpu] == ["cpu", "cpu"]
    assert np.array_equal(on_cpu[0].numpy(), state[0])
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in state_from_numpy(state))
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            state_from_numpy(state)


@pytest.mark.parametrize("resident", ["0", "1"])
def test_tier_clock_splits_the_device_seconds(monkeypatch, resident):
    """``dispatch_stats`` splits the funnel's device seconds by tier: the
    dense tier and the gather / cone tiers after it sum to ``device_s``
    within the funnel's own bookkeeping, the resident solves lie inside
    the gather tiers' seconds and the round ladders inside the dense
    tier's, and the word rung has its own: with the
    resident solver off the dense tier answers the frontier alone, with
    it on the dense tier delegates it to the resident solve."""
    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_KERNEL", resident)
    monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", "1")
    from mythril_tpu_torch.smt.solver import reset_blast_context
    from mythril_tpu_torch.support.support_args import (
        FORCE_DISPATCH_ARGS, args,
    )

    for key, value in FORCE_DISPATCH_ARGS.items():
        monkeypatch.setattr(args, key, value)
    reset_blast_context()
    plan, expected = frontiers.guard_chain_frontier(8, 8, 2,
                                                    calldata="words")
    port_bs.dispatch_stats.reset()
    assert port_bs.batch_check_states(plan, device="cpu") == expected
    stats = port_bs.dispatch_stats
    assert stats.dispatches == 1 and stats.word_s > 0
    assert 0 < stats.dense_s + stats.gather_s <= stats.device_s
    assert stats.resident_s <= stats.gather_s
    assert stats.dense_rounds_s <= stats.dense_s
    if resident == "0":
        assert stats.gather_s == stats.resident_s == 0
        assert 0 < stats.dense_rounds_s and stats.rounds > 0
    else:
        assert stats.resident_delegations == 1
        assert 0 < stats.resident_s and stats.resident_dispatches > 0
