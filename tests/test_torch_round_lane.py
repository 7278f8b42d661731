"""The port's round lane (``mythril_tpu_torch/ops/round_lane.py``) against
the JAX package's ``make_round_step`` / ``make_solve_step``, on the CPU.

The same seeded numpy inputs go through the vmapped JAX loop and through
``round_lane_plain`` / ``solve_lane`` (the plain version on CPU
tensors); every state field must be equal bit for bit.  The problems
cover SAT lanes, UNSAT at zero decisions, UNSAT after backtracking, a
bail at a small decision-stack depth, a nonzero warm-start phase, pad
lanes (status 3), rows narrower than 8 literals with padding, and the
budgets 1, 7, 64 and 768."""

import numpy as np
import pytest
import torch

from mythril_tpu.ops import batched_sat as jax_bs
from mythril_tpu_torch.ops import round_lane as RL

FIELDS = RL.ROUND_STATE_FIELDS
BUDGETS = (1, 7, 64, 768)


def _random_rows(rng, n_rows, first_var, n_vars, width=3):
    """``n_rows`` random clauses of ``width`` distinct vars in
    [first_var, first_var + n_vars), random signs."""
    rows = np.zeros((n_rows, width), np.int32)
    for r in range(n_rows):
        vs = rng.choice(np.arange(first_var, first_var + n_vars), size=width,
                        replace=False)
        rows[r] = vs * rng.choice([1, -1], size=width)
    return rows


def _pack(rows, K=8, C=None):
    """Rows into a [C, K] int32 pool (padding literals 0, padding rows
    all zero); row 0 is the TRUE anchor's unit."""
    C = C or 1 + len(rows)
    lits = np.zeros((C, K), np.int32)
    lits[0, 0] = 1
    for r, row in enumerate(rows, start=1):
        lits[r, :len(row)] = row
    return lits


def _state(assign, max_decisions, pref=None, pads=0):
    B, V1 = assign.shape
    D = max(1, min(max_decisions, V1))   # the JAX stack depth
    state = {
        "assign": assign.astype(np.int8),
        "lvl": np.zeros((B, V1), np.int32),
        "dvar": np.zeros((B, D), np.int32),
        "dphase": np.zeros((B, D), np.int8),
        "dflip": np.zeros((B, D), bool),
        "depth": np.zeros(B, np.int32),
        "status": np.zeros(B, np.int32),
        "step": np.zeros(B, np.int32),
        "pref": np.zeros((B, V1), np.int8),
    }
    if pref is not None:
        state["pref"][:] = pref
    if pads:
        state["assign"][B - pads:] = 1
        state["status"][B - pads:] = 3
    return state


def _assign(rng, B, V1, assumptions=3):
    """Lanes with the anchor true and a few random assumptions each."""
    assign = np.zeros((B, V1), np.int8)
    assign[:, 1] = 1
    for lane in range(B):
        vs = rng.choice(np.arange(2, V1), size=assumptions, replace=False)
        assign[lane, vs] = rng.choice([1, -1], size=assumptions)
    return assign


def problem(kind, seed=7):
    """(lits [C, K], state, max_decisions) for one case."""
    rng = np.random.default_rng(seed)
    D = jax_bs.GATHER_DECISIONS
    if kind == "sat":
        V1 = 42
        lits = _pack(_random_rows(rng, 60, 2, V1 - 2))
        return lits, _state(_assign(rng, 6, V1), D), D
    if kind == "unsat_zero":
        V1 = 24
        rows = list(_random_rows(rng, 20, 4, V1 - 4))
        rows += [np.array([2]), np.array([-3])]
        lits = _pack(rows)
        assign = _assign(rng, 4, V1, assumptions=0)
        assign[0, 2] = -1     # contradicts unit (2)
        assign[1, 3] = 1      # contradicts unit (-3)
        return lits, _state(assign, D), D
    if kind == "unsat_backtrack":
        V1 = 20
        full = [np.array([a * 2, b * 3, c * 4]) for a in (1, -1)
                for b in (1, -1) for c in (1, -1)]
        rows = full + list(_random_rows(rng, 24, 5, V1 - 5))
        lits = _pack(rows)
        return lits, _state(_assign(rng, 4, V1, assumptions=1), D), D
    if kind == "bail":
        V1 = 42
        lits = _pack(_random_rows(rng, 70, 2, V1 - 2))
        return lits, _state(_assign(rng, 5, V1, assumptions=1), 3), 3
    if kind == "pref":
        V1 = 42
        lits = _pack(_random_rows(rng, 60, 2, V1 - 2))
        pref = rng.choice([-1, 0, 1], size=V1).astype(np.int8)
        return lits, _state(_assign(rng, 6, V1), D, pref=pref), D
    if kind == "pads":
        V1 = 42
        lits = _pack(_random_rows(rng, 60, 2, V1 - 2))
        return lits, _state(_assign(rng, 8, V1), D, pads=3), D
    if kind == "narrow":
        V1 = 30
        rows = list(_random_rows(rng, 30, 2, V1 - 2)) + list(
            _random_rows(rng, 10, 2, V1 - 2, width=2))
        lits = _pack(rows, K=3, C=64)   # trailing all-zero rows
        return lits, _state(_assign(rng, 5, V1), D), D
    raise ValueError(kind)


KINDS = ("sat", "unsat_zero", "unsat_backtrack", "bail", "pref", "pads",
         "narrow")


def _jax_round(lits, state, budget, max_decisions):
    import jax

    V1 = state["assign"].shape[1]
    fn = jax.jit(jax.vmap(
        jax_bs.build_round_lane(V1 - 1, budget, max_decisions),
        in_axes=(None,) + (0,) * 9,
    ))
    out = fn(lits, *[state[k] for k in FIELDS])
    return {k: np.array(v) for k, v in zip(FIELDS, out)}


def _port_round(lits, state, budget):
    out = RL.round_lane(torch.from_numpy(lits),
                        {k: torch.from_numpy(np.array(v))
                         for k, v in state.items()}, budget)
    return {k: v.numpy() for k, v in out.items()}


def _assert_equal(port, jax):
    for k in FIELDS:
        assert port[k].dtype == jax[k].dtype, k
        assert np.array_equal(port[k], jax[k]), k


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("kind", KINDS)
def test_round_lane_matches_jax(kind, budget):
    lits, state, max_decisions = problem(kind)
    jax = _jax_round(lits, state, budget, max_decisions)
    port = _port_round(lits, state, budget)
    _assert_equal(port, jax)
    live = state["status"] == 0
    assert (port["step"][live] <= budget).all()
    assert (port["step"][~live] == 0).all()   # pad lanes never step
    if budget == 768:
        # the cases the problem is there for, at the full budget
        status = port["status"][live]
        want = {"sat": 1, "unsat_zero": 2, "unsat_backtrack": 2, "bail": 3,
                "pref": 1, "pads": 1, "narrow": 1}[kind]
        assert want in status, (kind, status)
        if kind == "unsat_backtrack":
            assert port["step"][live].min() > 4   # searched, not BCP
        if kind == "unsat_zero":
            assert (port["step"][:2] == 1).all()


def test_round_lane_resumes_like_the_jax_ladder():
    """Two rounds back to back, ``step`` zeroed between them as the
    ladder does: equal to JAX after each."""
    lits, state, D = problem("unsat_backtrack", seed=3)
    port_state, jax_state = dict(state), dict(state)
    for budget in (7, 64):
        port_state = _port_round(lits, port_state, budget)
        jax_state = _jax_round(lits, jax_state, budget, D)
        _assert_equal(port_state, jax_state)
        port_state["step"][:] = 0
        jax_state["step"][:] = 0


@pytest.mark.parametrize("kind", ["sat", "unsat_backtrack", "narrow"])
def test_solve_lane_matches_make_solve_step(kind):
    lits, state, _ = problem(kind, seed=11)
    assign = state["assign"]
    step = jax_bs.make_solve_step(assign.shape[1] - 1)
    jax_assign, jax_status = (np.asarray(x) for x in step(lits, assign))
    port_assign, port_status = RL.solve_lane(torch.from_numpy(lits),
                                             torch.from_numpy(assign))
    assert np.array_equal(port_assign.numpy(), jax_assign)
    assert np.array_equal(port_status.numpy(), jax_status)
    assert port_status.dtype == torch.int32


def test_solve_lane_maps_a_bail_to_undecided():
    lits, state, _ = problem("bail")
    _, status = RL.solve_lane(torch.from_numpy(lits),
                              torch.from_numpy(state["assign"]), decisions=3)
    raw = _port_round(lits, state, jax_bs.GATHER_STEPS)["status"]
    assert 3 in raw
    assert np.array_equal(status.numpy(), np.where(raw == 3, 0, raw))


def test_wrapper_never_falls_back_for_device_tensors(monkeypatch):
    """A tensor off the CPU goes to the kernel path or raises: the plain
    version is never taken for it."""
    def no_plain(*_args, **_kwargs):
        raise AssertionError("plain version taken for a device tensor")

    monkeypatch.setattr(RL, "round_lane_plain", no_plain)
    lits = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    state = RL.initial_state(torch.zeros((2, 9), dtype=torch.int8,
                                         device="meta"), 4)
    before = RL.launch_count
    with pytest.raises(ValueError):
        RL.round_lane(lits, state, 8)
    assert RL.launch_count == before


@pytest.mark.parametrize("C", [16384, 32768])
def test_shared_memory_layout_fits_the_largest_pool(C):
    """The tiers' largest lane (V1 = 8193, D = 256, the cone tier's
    16,384 rows and their next bucket) fits a block at every cluster
    size: its owned slice of the scores, levels and vote bitmaps, the
    replicas of the assignment and phase preference, the stack, the
    words of bitmaps it receives (16 bytes for 32 vars), a uint16 record
    a pool row, and the block's rows as int16 literals where they fit (at
    two blocks a lane and more for 16,384 rows)."""
    V1, D = 8193, 256
    for S in (1, 2, 4, 8):
        Ws = (-(-V1 // S) + 31) & ~31
        rows = -(-C // S)
        head = 12 * Ws + 2 * ((Ws // 8 + 15) & ~15) + 6 * D + 2 * S * Ws \
            + S * Ws // 2 + ((2 * rows + 15) & ~15)
        resident = head + 16 * rows <= RL.MAX_DYNAMIC_SMEM
        assert RL.layout(C, V1, D, S)["resident"] == resident
        assert RL.smem_bytes(C, V1, D, S) == head + (16 * rows if resident
                                                     else 0)
        assert RL.smem_bytes(C, V1, D, S) <= RL.MAX_DYNAMIC_SMEM
        assert resident == (S >= (2 if C == 16384 else 4))
    assert RL.smem_bytes(16384, V1, D, 2) == 220224


@pytest.mark.parametrize("B, C, V1, S", [
    (4, 256, 257, 8), (8, 16384, 8193, 8), (16, 16384, 2049, 8),
    (32, 16384, 8193, 4), (64, 16384, 8193, 2), (64, 16384, 2049, 2),
    (127, 8192, 4097, 2), (128, 16384, 8193, 1), (256, 16384, 8193, 1),
    (1, 32768, 8193, 8),
])
def test_round_lane_cluster_follows_the_rule(B, C, V1, S):
    """Each lane runs on a cluster of the smallest power of two S of
    blocks with B x S >= 128 (about one block an SM), at most the
    portable 8, at the main path's shapes (the full-pool and cone tiers'
    64 lanes, the scale runs' 4 to 32) and the widest."""
    assert RL.cluster_size(B, C, V1, 256) == S
    assert B * S >= RL.CLUSTER_BLOCKS or S == RL.MAX_CLUSTER
    assert S == 1 or B * S // 2 < RL.CLUSTER_BLOCKS


def test_cluster_rule_refuses_a_block_past_shared_memory():
    """A lane whose block fits at no cluster size gets none (the wrapper
    refuses it), here a stack of 60,000 slots."""
    assert RL.cluster_size(64, 16384, 8193, 60000) == 0


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("kind", KINDS)
def test_skip_record_is_exact(kind, budget):
    """The plain model of the kernel's record of satisfied rows: on every
    sweep, the scan without the recorded rows equals the full scan of
    ``round_lane_plain``, and wherever a lane decides, every free var's
    scores equal its pool occurrences less those in recorded rows (the
    kernel's count); the round ends in the plain version's state."""
    lits, state, _ = problem(kind)
    st = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    got, counts = RL.skip_record_model(torch.from_numpy(lits), st, budget)
    want = RL.round_lane_plain(torch.from_numpy(lits), st, budget)
    for k in FIELDS:
        assert torch.equal(got[k], want[k]), k
    assert counts["differs"] == 0 and counts["score_differs"] == 0, counts
    if budget > 1:
        assert counts["skipped"] > 0, counts
    if kind == "unsat_backtrack" and budget >= 7:
        assert counts["invalidated"] > 0, counts


def test_skip_record_takes_the_deepest_initial_level():
    """A state whose assumptions sit at level 3 while the depth is 0: a
    row they satisfy is recorded at level 3 or deeper, so a backtrack to
    Lm <= 3, which unassigns them, voids the record; the model stays
    exact and ends in the plain version's state."""
    lits, state, _ = problem("unsat_backtrack", seed=3)
    st = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    assumed = (st["assign"] != 0) & (torch.arange(st["lvl"].shape[1]) > 1)
    st["lvl"] = torch.where(assumed, 3, st["lvl"]).to(torch.int32)
    got, counts = RL.skip_record_model(torch.from_numpy(lits), st, 64)
    want = RL.round_lane_plain(torch.from_numpy(lits), st, 64)
    for k in FIELDS:
        assert torch.equal(got[k], want[k]), k
    assert counts["differs"] == 0 and counts["score_differs"] == 0, counts
    assert counts["invalidated"] > 0, counts
