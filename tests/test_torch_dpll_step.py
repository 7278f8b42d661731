"""The dense tier's DPLL step (``mythril_tpu_torch/ops/dpll_step.py`` and
``ops/csrc/dpll_step.cu``), its round loop and the one-shot solves,
against the plain version and the JAX package's Pallas tier, on the CPU.

- The kernel's own source built as host C++ with g++
  (``dpll_step_host``: a lane's thread-block cluster emulated, each
  phase running every block's 512 threads one after another, in the
  order of the block and cluster barriers) against ``dpll_step_plain``
  on the seeded states of ``frontiers.dpll_step_problem`` at V in {128,
  1024, 2048}, B in {1, 7, 64} and D in {1, 16, 1024}, decisions on and
  off, on a full view, a hot view and a hot view under the gate: every
  state field, the sweep workspace it zeroes and the live / step-count
  flags bit for bit; the cases together must show every transition of
  ``STEP_EVENTS``.  The same at clusters of 1, 2 and 8 blocks forced,
  and on hand-made states: a V that no block slice divides, top-K ties
  across a block boundary, a winner in every block, a backtrack whose
  variable and popped slots lie past rank 0, the live and step-count
  flags from a step number past them and on lanes that are not live.
- Whole rounds: ``make_dense_rounds`` and ``make_batched_rounds`` with
  the host build as the step, against JAX's ``make_dense_rounds(...,
  interpret=True)`` and ``make_batched_rounds``, tiered and not, with
  decisions on and off: every state field and ``steps_used``; also at
  forced cluster sizes, and rounds whose lanes all finish inside a
  16-step window, untiered and with a tier period that does not divide
  the window (its hot-view steps counted).
- The one-shots ``make_dense_solve`` and ``make_batched_solve``, with
  the plain step and with the host build, against JAX's on the inputs of
  ``tests/test_pallas.py``'s random-CNF tests: ``A``, ``status`` and
  ``steps_used``.
- The wrapper: a launch on device tensors counts once, under its (B, V,
  D), and never takes the plain version; a library that refuses every
  launch raises; bad inputs raise before any launch.

Every comparison is exact: the step is integer and sign logic over
small integer-valued float32 counts.
"""

import random
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.ops import pallas_prop as jax_pp
from mythril_tpu_torch import frontiers
from mythril_tpu_torch.ops import dense_prop as port_dp
from mythril_tpu_torch.ops import dense_sweep as port_ds
from mythril_tpu_torch.ops import dpll_step as DS
from mythril_tpu_torch.ops.carry import state_from_numpy

#: (B, V, D, decisions) of the step cases
STEP_SHAPES = (
    (1, 128, 1, True), (7, 128, 16, True), (64, 128, 16, True),
    (1, 1024, 1024, True), (7, 1024, 1, False), (64, 1024, 1024, True),
    (64, 2048, 1024, True), (64, 128, 1, False), (7, 2048, 16, True),
)
#: (full_view, hot_gate) of a step: full view, hot view, hot view gated
VIEWS = ((True, False), (False, False), (False, True))
SEEDS = (0, 1)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``dpll_step.cu`` built as host C++, bound by the wrapper's own
    ``bind``."""
    path = tmp_path_factory.mktemp("dpll_step") / "libdpll_step_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-x", "c++", "-shared",
                    "-fPIC", "-o", str(path), DS.SOURCE],
                   check=True, capture_output=True)
    lib = DS.bind(str(path))
    assert lib.dpll_step_threads() == 512
    return lib


def _host_step(lib, cluster=0):
    """A step with :func:`dpll_step`'s signature that runs the host build
    on CPU tensors, on emulated clusters of ``cluster`` blocks a lane (0:
    the library's choice)."""
    def step(state, outs, flags, step, full_view, hot_gate, clear):
        args = DS.step_args(state, outs, flags, step, full_view, hot_gate,
                            clear, cluster)
        assert lib.dpll_step_host(*args) == 0
    return step


def _views(decisions):
    return VIEWS if decisions else VIEWS[:2]


def _tensors(arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _check_step(lib, state, outs, cluster=0, views=None, what=()):
    """One step from numpy ``state`` / ``outs``, the host build on
    emulated clusters of ``cluster`` blocks against the plain version, at
    every view (``views``, default all the case's) and with and without
    ``clear``, from flags already past 0: every field bit for bit.
    Returns the plain step's states."""
    host = _host_step(lib, cluster)
    decisions = len(outs) == 5
    names = port_dp.DPLL_STATE_FIELDS + ("fpos", "fneg", "conf", "spos",
                                         "sneg")
    after = []
    for full_view, hot_gate in views or _views(decisions):
        for clear in (True, False):
            want = _tensors(state) + _tensors(outs)
            got = _tensors(state) + _tensors(outs)
            flags_want = torch.tensor([4, 6], dtype=torch.int32)
            flags_got = flags_want.clone()
            DS.dpll_step_plain(want[:11], want[11:], flags_want, 9,
                               full_view, hot_gate, clear)
            host(got[:11], got[11:], flags_got, 9, full_view, hot_gate,
                 clear)
            for name, w, g in zip(names, want, got):
                assert torch.equal(w, g), (*what, cluster, full_view,
                                           hot_gate, clear, name)
            assert torch.equal(flags_want, flags_got)
            live_before = (state[7] == 0).any()
            live_after = (want[7] == 0).any()
            assert flags_got.tolist() == [10 if live_after else 4,
                                          10 if live_before else 6]
            if clear:
                assert all(not t.any() for t in got[11:])
            after.append(want)
    return after


@pytest.mark.parametrize("shape", STEP_SHAPES,
                         ids=lambda s: "B{}-V{}-D{}-{}".format(
                             *s[:3], "dec" if s[3] else "bcp"))
def test_host_build_matches_plain_step(host_kernel, shape):
    """Every field after one step, host build against the plain version,
    on seeded states at every view, from flags already past 0."""
    B, V, D, decisions = shape
    for seed in SEEDS:
        state, outs = frontiers.dpll_step_problem(B, V, D, decisions, seed)
        _check_step(host_kernel, state, outs, what=(shape, seed))


#: cluster sizes the host build emulates in the cases below
CLUSTERS = (1, 2, 8)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("shape", [(7, 1024, 16, True),
                                   (64, 2048, 1024, True),
                                   (16, 1024, 1, False)],
                         ids=lambda s: "B{}-V{}-D{}-{}".format(
                             *s[:3], "dec" if s[3] else "bcp"))
def test_host_build_at_every_cluster_size_matches_plain_step(
        host_kernel, shape, cluster):
    """The seeded states with a lane's columns and slots split over 1, 2
    or 8 emulated blocks (the library picks 8 at B <= 16 and 2 at
    B = 64 on the card)."""
    B, V, D, decisions = shape
    for seed in SEEDS:
        state, outs = frontiers.dpll_step_problem(B, V, D, decisions, seed)
        _check_step(host_kernel, state, outs, cluster, what=(shape, seed))


@pytest.mark.parametrize("cluster", (0, 2, 8))
@pytest.mark.parametrize("V", [1000, 130, 1030])
def test_columns_no_block_slice_divides_evenly(host_kernel, V, cluster):
    """V not a multiple of 4 (no 16-byte access) or of the cluster: the
    last block's slice is short, or empty (V = 130 over 8 blocks of 20
    columns)."""
    for seed in SEEDS:
        state, outs = frontiers.dpll_step_problem(7, V, 16, True, seed)
        _check_step(host_kernel, state, outs, cluster, what=(V, seed))


def _quiet_state(B, V, D):
    """Every lane live at depth 0 with every column assigned (+1) and no
    sweep output: numpy (state, outs) for hand-made cases."""
    f32, i32 = np.float32, np.int32
    state = [np.ones((B, V), f32), np.zeros((B, V), i32),
             np.zeros((B, D), i32), np.zeros((B, D), f32),
             np.zeros((B, D), f32), np.zeros((B, D), f32),
             np.zeros((B, 1), i32), np.zeros((B, 1), i32),
             np.zeros((B, 1), f32), np.zeros((B, 1), i32),
             np.zeros((B, V), f32)]
    outs = [np.zeros((B, V), f32), np.zeros((B, V), f32),
            np.zeros((B, 1), f32), np.zeros((B, V), f32),
            np.zeros((B, V), f32)]
    return state, outs


def _hold(state, b, depth, rng):
    """Lane ``b`` at ``depth`` with every level flipped (no backtrack)."""
    D = state[2].shape[1]
    state[6][b] = depth
    state[2][b, :depth] = rng.integers(2, state[0].shape[1], size=depth)
    state[3][b, :depth] = rng.choice([-1.0, 1.0], size=depth)
    state[4][b, :depth] = 1.0
    assert depth <= D


def _decided(after, b):
    """Columns the step assigned at the lane's new level."""
    A, lvl, depth = after[0], after[1], after[6]
    return set(torch.nonzero(lvl[b] == depth[b, 0]).flatten().tolist())


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_top_k_ties_across_a_block_boundary(host_kernel, cluster):
    """Past the single-var window, 16 columns from free columns 120-140
    of one score, and a few of a higher one: the kept ties are the
    lowest columns, across the boundary at column 128 (2 blocks of 128,
    8 of 32 columns); inside the window, the lowest tied column."""
    rng = np.random.default_rng(7)
    state, outs = _quiet_state(3, 256, 32)
    for b, depth in ((0, 12), (1, 12), (2, 3)):
        _hold(state, b, depth, rng)
        state[0][b, 120:141] = 0.0
        outs[3][b, 120:141] = 2.0
    state[0][0, [30, 200, 250]] = 0.0
    outs[3][0, [30, 200, 250]] = 5.0
    outs[4][1, 120:141] = 1.0      # equal scores of spos + sneg
    after = _check_step(host_kernel, state, outs, cluster,
                        views=[(True, False)])[0]
    assert _decided(after, 0) == {30, 200, 250, *range(120, 133)}
    assert _decided(after, 1) == set(range(120, 136))
    assert _decided(after, 2) == {120}


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_a_winner_in_every_block(host_kernel, cluster):
    """16 free columns of distinct scores, two in each eighth of the
    lane's 1,024 columns (one block's slice at 8 blocks): all 16 kept
    past the window; inside it, the best in the last block."""
    rng = np.random.default_rng(8)
    state, outs = _quiet_state(2, 1024, 64)
    cols = [c for r in range(8) for c in (128 * r + 5, 128 * r + 100)]
    for b, depth in ((0, 20), (1, 4)):
        _hold(state, b, depth, rng)
        state[0][b, cols] = 0.0
        outs[3][b, cols] = np.arange(10, 26, dtype=np.float32)
    after = _check_step(host_kernel, state, outs, cluster,
                        views=[(True, False)])[0]
    assert _decided(after, 0) == set(cols)
    assert _decided(after, 1) == {cols[-1]}
    assert int(after[2][0, 20]) == cols[-1]   # the primary: best score
    assert float(after[5][0, 20]) == 1.0      # a bulk level


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_backtrack_slots_and_variable_past_rank_0(host_kernel, cluster):
    """A conflict whose deepest unflipped decision is slot 37 (block 4 of
    8 blocks of 8 slots), its variable column 700 (block 5 of 8 blocks of
    128 columns), levels up to 40 popped: with a bulk level among the
    popped (taint) and without."""
    rng = np.random.default_rng(9)
    state, outs = _quiet_state(2, 1024, 64)
    for b in range(2):
        _hold(state, b, 40, rng)
        state[4][b, 37] = 0.0
        state[2][b, 37] = 700
        state[1][b] = rng.integers(0, 41, size=1024)
        state[0][b] = rng.choice([-1.0, 1.0], size=1024)
        outs[2][b] = 1.0
    state[5][0, 39] = 1.0
    after = _check_step(host_kernel, state, outs, cluster)[0]
    assert after[6][:, 0].tolist() == [38, 38]
    assert after[8][:, 0].tolist() == [1.0, 0.0]
    assert (after[1][:, 700] == 38).all()
    assert not after[2][:, 38:].any()


@pytest.mark.parametrize("cluster", (0, 8))
def test_step_flags_count_from_the_step_number(host_kernel, cluster):
    """The live and step-count flags are integer maxes of ``step + 1``:
    a step past the flags raises both (live lanes after it), a step
    behind them leaves them, and a batch whose lanes are all retired
    raises neither."""
    state, outs = frontiers.dpll_step_problem(16, 512, 16, True, 2)
    for step, start, retired, want in ((7, [4, 6], False, [8, 8]),
                                       (3, [9, 9], False, [9, 9]),
                                       (30, [4, 6], True, [4, 6])):
        planes = [np.array(a, copy=True) for a in state]
        if retired:
            planes[7][:] = 3
        got = _tensors(planes) + _tensors(outs)
        plain = _tensors(planes) + _tensors(outs)
        flags_got = torch.tensor(start, dtype=torch.int32)
        flags_plain = flags_got.clone()
        DS.dpll_step_plain(plain[:11], plain[11:], flags_plain, step, True,
                           False, True)
        _host_step(host_kernel, cluster)(got[:11], got[11:], flags_got,
                                         step, True, False, True)
        for w, g in zip(plain, got):
            assert torch.equal(w, g)
        assert flags_got.tolist() == flags_plain.tolist() == want


def test_step_cases_show_every_transition():
    """The cases above, together, take every transition of
    ``STEP_EVENTS`` (counted on the plain version's own masks)."""
    seen = dict.fromkeys(DS.STEP_EVENTS, 0)
    for B, V, D, decisions in STEP_SHAPES:
        for seed in SEEDS:
            state, outs = frontiers.dpll_step_problem(B, V, D, decisions,
                                                      seed)
            for full_view, hot_gate in _views(decisions):
                events = DS.step_events(_tensors(state), _tensors(outs),
                                        full_view, hot_gate)
                for name, n in events.items():
                    seen[name] += n
    assert all(seen.values()), seen


def test_a_step_with_no_live_lane_changes_nothing(host_kernel):
    """Retired lanes only: the state and flags stay, the workspace is
    zeroed."""
    state, outs = frontiers.dpll_step_problem(16, 256, 16, True, 3)
    state[7][:] = np.random.default_rng(0).integers(1, 4, size=(16, 1))
    got = _tensors(state) + _tensors(outs)
    flags = torch.tensor([2, 2], dtype=torch.int32)
    _host_step(host_kernel)(got[:11], got[11:], flags, 5, True, False,
                            True)
    for before, after in zip(state, got):
        assert np.array_equal(before, after.numpy())
    assert flags.tolist() == [2, 2]
    assert all(not t.any() for t in got[11:])


# ----------------------------------------------------------- whole rounds


def _planted_cnf(rng, num_vars, num_clauses, width=3):
    planted = {v: rng.random() < 0.5 for v in range(2, num_vars + 2)}
    clauses = []
    for _ in range(num_clauses):
        picks = rng.sample(sorted(planted), width)
        lits = [v if rng.random() < 0.5 else -v for v in picks]
        if not any((lit > 0) == planted[abs(lit)] for lit in lits):
            lits[0] = -lits[0]
        clauses.append(tuple(lits))
    return clauses


def _round_state(B, V, num_vars, D, seed):
    np_rng = np.random.default_rng(seed)
    A0 = np.zeros((B, V), np.float32)
    A0[:, 1] = 1.0
    A0[:, num_vars + 2:] = 1.0
    for lane in range(B):
        cols = np_rng.choice(np.arange(2, num_vars + 2), 3, replace=False)
        A0[lane, cols] = np_rng.choice([-1.0, 1.0], 3)
    pref = np_rng.choice([-1.0, 0.0, 1.0], size=V).astype(np.float32)
    return jax_pp._dpll_state0(A0, D, B - 1, pref)


def _compare_rounds(jout, pout):
    assert int(jout[-1]) == pout[-1] > 0
    for name, j, p in zip(jax_pp.DPLL_STATE_FIELDS, jout[:-1], pout[:-1]):
        assert np.array_equal(np.asarray(j), p.numpy()), name


@pytest.mark.parametrize("decisions", [True, False])
@pytest.mark.parametrize("tiered", [False, True])
def test_dense_rounds_with_host_step_match_jax(host_kernel, monkeypatch,
                                               tiered, decisions):
    """``make_dense_rounds`` with the host build as its step against
    JAX's Pallas round (interpret mode) from the same state."""
    rng = random.Random(5)
    num_vars, B, budget = 90, 8, 48
    clauses = _planted_cnf(rng, num_vars, 400)
    jpool = jax_pp.DenseClausePool()
    jpool.refresh(clauses, num_vars + 1)
    ppool = port_dp.DenseClausePool("cpu")
    ppool.refresh(clauses, num_vars + 1)
    C, V = jpool.C, jpool.V
    max_dec = port_dp.MAX_DECISIONS if decisions else 0
    D = max(1, min(max_dec, V))
    state = _round_state(B, V, num_vars, D, 3)
    hot_c, period = (256, 4) if tiered else (0, 1)
    jfn = jax_pp.make_dense_rounds(C, V, B, budget, True, max_dec, hot_c,
                                   period)
    jout = jfn(jpool.P, jpool.N, jpool.width,
               *[jnp.asarray(a) for a in state])
    monkeypatch.setattr(port_dp, "dpll_step", _host_step(host_kernel))
    pfn = port_dp.make_dense_rounds(C, V, B, budget, port_dp.CPU_TIER,
                                    max_dec, hot_c, period)
    pout = pfn(ppool.P, ppool.N, ppool.width,
               *state_from_numpy([a.copy() for a in state], device="cpu"))
    _compare_rounds(jout, pout)
    assert (pout[port_dp._STATUS_IDX] != 0).any()


@pytest.mark.parametrize("cluster", (1, 2))
def test_dense_rounds_at_cluster_sizes_match_jax(host_kernel, monkeypatch,
                                                 cluster):
    """The tiered round of ``test_dense_rounds_with_host_step_match_jax``
    with the host build's lanes on 1 or 2 emulated blocks (the library
    picks 8 at B = 8)."""
    rng = random.Random(5)
    num_vars, B, budget = 90, 8, 48
    clauses = _planted_cnf(rng, num_vars, 400)
    jpool = jax_pp.DenseClausePool()
    jpool.refresh(clauses, num_vars + 1)
    ppool = port_dp.DenseClausePool("cpu")
    ppool.refresh(clauses, num_vars + 1)
    C, V = jpool.C, jpool.V
    D = min(port_dp.MAX_DECISIONS, V)
    state = _round_state(B, V, num_vars, D, 3)
    jout = jax_pp.make_dense_rounds(C, V, B, budget, True,
                                    port_dp.MAX_DECISIONS, 256, 4)(
        jpool.P, jpool.N, jpool.width, *[jnp.asarray(a) for a in state])
    monkeypatch.setattr(port_dp, "dpll_step", _host_step(host_kernel,
                                                         cluster))
    pout = port_dp.make_dense_rounds(C, V, B, budget, port_dp.CPU_TIER,
                                     port_dp.MAX_DECISIONS, 256, 4)(
        ppool.P, ppool.N, ppool.width,
        *state_from_numpy([a.copy() for a in state], device="cpu"))
    _compare_rounds(jout, pout)


def _finishing_state(rng, B, V, num_vars, clauses_planted, free):
    """A round's state whose lanes each assume a planted model on all but
    ``free`` of the CNF's columns: every lane's search ends early, at a
    step of its own."""
    state = _round_state(B, V, num_vars, min(port_dp.MAX_DECISIONS, V), 1)
    A0 = np.asarray(state[0]).copy()
    for lane in range(B):
        A0[lane, 2:num_vars + 2] = clauses_planted[2:num_vars + 2]
        A0[lane, rng.choice(np.arange(2, num_vars + 2), free[lane],
                            replace=False)] = 0.0
    state = list(state)
    state[0] = A0
    return state


#: (hot rows, tier period, budget) of the finishing rounds: every step on
#: the full view (every lane done after 92 steps), or the first 256 rows
#: swept every step and the rest every third step, a period that does not
#: divide the 16-step window (done after 172)
FINISHING_TIERS = {"plain": (0, 1, 96), "tiered": (256, 3, 192)}


@pytest.fixture(scope="module")
def finishing_round():
    """A planted 3-CNF over 120 variables (350 rows) and 8 lanes (the last
    a pad) that each assume the planted model on all but 20-100 columns,
    so every lane is done before the round's budget.  Returns the port's
    pool, the state and JAX's rounds (interpret mode) by tier."""
    rng = random.Random(13)
    num_vars, B = 120, 8
    planted = {v: rng.random() < 0.5 for v in range(2, num_vars + 2)}
    clauses = []
    for _ in range(350):
        picks = rng.sample(sorted(planted), 3)
        lits = [v if rng.random() < 0.5 else -v for v in picks]
        if not any((lit > 0) == planted[abs(lit)] for lit in lits):
            lits[0] = -lits[0]
        clauses.append(tuple(lits))
    jpool = jax_pp.DenseClausePool()
    jpool.refresh(clauses, num_vars + 1)
    ppool = port_dp.DenseClausePool("cpu")
    ppool.refresh(clauses, num_vars + 1)
    model = np.zeros(jpool.V, np.float32)
    for v, value in planted.items():
        model[v] = 1.0 if value else -1.0
    np_rng = np.random.default_rng(4)
    state = _finishing_state(np_rng, B, jpool.V, num_vars, model,
                             np_rng.integers(20, 100, size=B))
    jouts = {
        windows: jax_pp.make_dense_rounds(
            jpool.C, jpool.V, B, budget, True, port_dp.MAX_DECISIONS, hot_c,
            period)(jpool.P, jpool.N, jpool.width,
                    *[jnp.asarray(a) for a in state])
        for windows, (hot_c, period, budget) in FINISHING_TIERS.items()}
    return ppool, state, jouts


@pytest.mark.parametrize("windows", sorted(FINISHING_TIERS))
@pytest.mark.parametrize("step", ["plain", "host"])
def test_rounds_whose_lanes_all_finish_mid_window_match_jax(
        host_kernel, monkeypatch, finishing_round, step, windows):
    """Every lane done after a step count that is no multiple of the
    16-step window, on every step's full view or tiered with a period
    that does not divide the window: the round (the host reads the live
    marker once a window, the step count stays exact) equals JAX's round,
    every field and the step count; the hot-view steps are counted, one
    for each launched step that is not a multiple of the period."""
    from mythril_tpu_torch.ops.batched_sat import dispatch_stats

    ppool, state, jouts = finishing_round
    hot_c, period, budget = FINISHING_TIERS[windows]
    B = state[0].shape[0]
    if step == "host":
        monkeypatch.setattr(port_dp, "dpll_step", _host_step(host_kernel))
    dispatch_stats.reset()
    pout = port_dp.make_dense_rounds(ppool.C, ppool.V, B, budget,
                                     port_dp.CPU_TIER,
                                     port_dp.MAX_DECISIONS, hot_c, period)(
        ppool.P, ppool.N, ppool.width,
        *state_from_numpy([a.copy() for a in state], device="cpu"))
    _compare_rounds(jouts[windows], pout)
    steps = pout[-1]
    assert steps % port_dp.SYNC_EVERY and port_dp.SYNC_EVERY < steps < budget
    assert (pout[port_dp._STATUS_IDX] != 0).all()
    launched = -(-steps // port_dp.SYNC_EVERY) * port_dp.SYNC_EVERY
    assert dispatch_stats.hot_view_steps == sum(
        1 for k in range(launched) if k % period)
    assert dispatch_stats.hot_view_steps > 0 or period == 1


def _lane_planes(rng, B, C, V, num_vars):
    P = np.zeros((B, C, V), np.float32)
    N = np.zeros((B, C, V), np.float32)
    W = np.zeros((B, C), np.float32)
    for lane in range(B):
        for row, clause in enumerate(_planted_cnf(rng, num_vars, C // 2)):
            W[lane, row] = len(clause)
            for lit in clause:
                (P if lit > 0 else N)[lane, row, abs(lit)] = 1.0
    return P, N, W


@pytest.mark.parametrize("decisions", [True, False])
@pytest.mark.parametrize("tiered", [False, True])
def test_batched_rounds_with_host_step_match_jax(host_kernel, monkeypatch,
                                                 tiered, decisions):
    """``make_batched_rounds`` with the host build as its step against
    JAX's batched round from the same state."""
    rng = random.Random(11)
    B, C, V, num_vars, budget = 8, 256, 128, 60, 40
    P, N, W = _lane_planes(rng, B, C, V, num_vars)
    max_dec = port_dp.MAX_DECISIONS if decisions else 0
    D = max(1, min(max_dec, V))
    state = _round_state(B, V, num_vars, D, 4)
    hot_c, period = (64, 4) if tiered else (0, 1)
    jfn = jax_pp.make_batched_rounds(C, V, B, budget, max_dec, hot_c, period)
    jout = jfn(jnp.asarray(P, jnp.bfloat16), jnp.asarray(N, jnp.bfloat16),
               jnp.asarray(W), *[jnp.asarray(a) for a in state])
    monkeypatch.setattr(port_dp, "dpll_step", _host_step(host_kernel))
    pfn = port_dp.make_batched_rounds(C, V, B, budget, max_dec, hot_c,
                                      period)
    pout = pfn(torch.from_numpy(P), torch.from_numpy(N), torch.from_numpy(W),
               *state_from_numpy([a.copy() for a in state], device="cpu"))
    _compare_rounds(jout, pout)


# ---------------------------------------------------------------- one-shots


def _dense_trials():
    """The random CNFs of ``tests/test_pallas.py``'s dense differential
    test (the same generator and seed)."""
    rng = random.Random(1234)
    trials = []
    for _ in range(12):
        num_vars = rng.randint(4, 10)
        num_clauses = rng.randint(6, 42)
        clauses = []
        for _ in range(num_clauses):
            width = rng.randint(1, 3)
            clauses.append(tuple(
                rng.choice([1, -1]) * rng.randint(2, num_vars + 1)
                for _ in range(width)
            ))
        trials.append((num_vars, clauses))
    return trials


@pytest.mark.parametrize("step", ["plain", "host"])
def test_dense_solve_matches_jax(host_kernel, monkeypatch, step):
    if step == "host":
        monkeypatch.setattr(port_dp, "dpll_step", _host_step(host_kernel))
    statuses = set()
    for num_vars, clauses in _dense_trials():
        jpool = jax_pp.DenseClausePool()
        jpool.refresh(clauses, num_vars + 1)
        ppool = port_dp.DenseClausePool("cpu")
        ppool.refresh(clauses, num_vars + 1)
        B = 8
        A0 = np.zeros((B, jpool.V), np.float32)
        A0[:, 1] = 1.0
        A0[:, num_vars + 2:] = 1.0
        jA, jst, jsteps = jax_pp.make_dense_solve(
            jpool.C, jpool.V, B, 96, True)(jpool.P, jpool.N, jpool.width,
                                           jnp.asarray(A0))
        A0_port = torch.from_numpy(A0.copy())
        pA, pst, psteps = port_dp.make_dense_solve(
            ppool.C, ppool.V, B, 96)(ppool.P, ppool.N, ppool.width, A0_port)
        assert np.array_equal(np.asarray(jA), pA.numpy())
        assert np.array_equal(np.asarray(jst), pst.numpy())
        assert int(jsteps) == psteps > 0
        assert np.array_equal(A0_port.numpy(), A0)  # A0 is not written
        statuses.update(pst[:, 0].tolist())
    assert {1, 2} <= statuses


@pytest.mark.parametrize("step", ["plain", "host"])
def test_batched_solve_matches_jax(host_kernel, monkeypatch, step):
    """The per-lane one-shot on ``tests/test_pallas.py``'s batched input
    (the same generator and seed)."""
    if step == "host":
        monkeypatch.setattr(port_dp, "dpll_step", _host_step(host_kernel))
    rng = random.Random(4321)
    B, C, V = 8, 128, 128
    P = np.zeros((B, C, V), np.float32)
    N = np.zeros((B, C, V), np.float32)
    W = np.zeros((B, C), np.float32)
    A0 = np.zeros((B, V), np.float32)
    A0[:, 1] = 1.0
    for lane in range(B):
        num_vars = rng.randint(5, 12)
        clauses = []
        for _ in range(rng.randint(8, 48)):
            width = rng.randint(1, 3)
            clauses.append(tuple(
                rng.choice([1, -1]) * rng.randint(2, num_vars + 1)
                for _ in range(width)
            ))
        for row, clause in enumerate(clauses):
            lits = set(clause)
            if any(-l in lits for l in lits):
                continue
            W[lane, row] = len(lits)
            for lit in lits:
                (P if lit > 0 else N)[lane, row, abs(lit)] = 1.0
        A0[lane, num_vars + 2:] = 1.0
    jA, jst, jsteps = jax_pp.make_batched_solve(C, V, B, 96)(
        jnp.asarray(P, jnp.bfloat16), jnp.asarray(N, jnp.bfloat16),
        jnp.asarray(W), jnp.asarray(A0))
    pA, pst, psteps = port_dp.make_batched_solve(C, V, B, 96)(
        torch.from_numpy(P), torch.from_numpy(N), torch.from_numpy(W),
        torch.from_numpy(A0))
    assert np.array_equal(np.asarray(jA), pA.numpy())
    assert np.array_equal(np.asarray(jst), pst.numpy())
    assert int(jsteps) == psteps > 0
    assert {1, 2} <= set(pst[:, 0].tolist())


@pytest.mark.parametrize("max_dec", [port_dp.MAX_DECISIONS, 0])
def test_dense_solve_bcp_only_and_budget_match_jax(max_dec):
    """A planted CNF under a short budget: bailed lanes map to 0
    (undecided), with and without decisions."""
    rng = random.Random(9)
    num_vars = 70
    clauses = _planted_cnf(rng, num_vars, 300)
    jpool = jax_pp.DenseClausePool()
    jpool.refresh(clauses, num_vars + 1)
    ppool = port_dp.DenseClausePool("cpu")
    ppool.refresh(clauses, num_vars + 1)
    B = 8
    A0 = np.asarray(_round_state(B, jpool.V, num_vars, 1, 6)[0])
    jout = jax_pp.make_dense_solve(jpool.C, jpool.V, B, 12, True, max_dec)(
        jpool.P, jpool.N, jpool.width, jnp.asarray(A0))
    pout = port_dp.make_dense_solve(ppool.C, ppool.V, B, 12, max_dec)(
        ppool.P, ppool.N, ppool.width, torch.from_numpy(A0.copy()))
    assert np.array_equal(np.asarray(jout[0]), pout[0].numpy())
    assert np.array_equal(np.asarray(jout[1]), pout[1].numpy())
    assert int(jout[2]) == pout[2] > 0


# ----------------------------------------------------------------- wrapper


def _stand_in_card(monkeypatch, launch):
    """A card for the wrapper: a library whose launch is ``launch``, a
    stream, and the ``meta`` device for the data."""
    monkeypatch.setattr(DS, "load_library",
                        lambda: types.SimpleNamespace(dpll_step_launch=launch))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(DS, "dpll_step_plain", lambda *args: pytest.fail(
        "plain version taken for a device tensor"))


def _meta_step(B=4, V=128, D=16, decisions=True):
    state, outs = frontiers.dpll_step_problem(B, V, D, decisions, 0)
    state = [torch.from_numpy(a).to("meta") for a in state]
    outs = [torch.from_numpy(a).to("meta") for a in outs]
    return state, outs, torch.zeros(2, dtype=torch.int32, device="meta")


def test_wrapper_launches_once_and_never_takes_the_plain_version(
        monkeypatch):
    calls = []
    _stand_in_card(monkeypatch, lambda *args: calls.append(args) or 0)
    DS.reset_launch_count()
    state, outs, flags = _meta_step()
    DS.dpll_step(state, outs, flags, 3, False, True, True)
    assert len(calls) == 1 and calls[0][1:9] == (4, 128, 16, 3, 0, 1, 1, 1)
    assert DS.launch_count == 1


def test_wrapper_counts_launches_by_shape(monkeypatch):
    """A launch counts once, under its (B, V, D), with the cluster left to
    the library; flags the kernel cannot take raise before any launch;
    a reset clears both counts."""
    calls = []
    _stand_in_card(monkeypatch, lambda *args: calls.append(args) or 0)
    DS.reset_launch_count()
    state, outs, flags = _meta_step()
    DS.dpll_step(state, outs, flags, 15, True, False, True)
    DS.dpll_step(state, outs, flags, 16, True, False, True)
    wide, wide_outs, _ = _meta_step(B=2, V=256, D=8)
    DS.dpll_step(wide, wide_outs, flags, 0, True, False, True)
    assert [c[1:10] for c in calls] == [(4, 128, 16, 15, 1, 0, 1, 1, 0),
                                        (4, 128, 16, 16, 1, 0, 1, 1, 0),
                                        (2, 256, 8, 0, 1, 0, 1, 1, 0)]
    assert DS.launch_count == 3
    assert DS.launch_shapes == {(4, 128, 16): 2, (2, 256, 8): 1}
    with pytest.raises(TypeError):
        DS.dpll_step(state, outs, flags.to(torch.int64), 0, True, False,
                     True)
    assert len(calls) == 3 and DS.launch_count == 3
    DS.reset_launch_count()
    assert DS.launch_count == 0 and DS.launch_shapes == {}


def test_a_refused_launch_raises(monkeypatch):
    """A library that refuses every launch: the wrapper raises and does
    not return the plain result."""
    _stand_in_card(monkeypatch, lambda *args: 700)
    DS.reset_launch_count()
    state, outs, flags = _meta_step()
    with pytest.raises(RuntimeError, match="cudaError 700"):
        DS.dpll_step(state, outs, flags, 0, True, False, True)
    assert DS.launch_count == 0


@pytest.mark.parametrize("fault", ["dtype", "shape", "strides", "device",
                                   "hot gate without scores", "too wide"])
def test_bad_inputs_raise_before_any_launch(monkeypatch, fault):
    _stand_in_card(monkeypatch, lambda *args: pytest.fail("launched"))
    decisions = fault != "hot gate without scores"
    V = DS.MAX_COLS * 2 if fault == "too wide" else 128
    state, outs, flags = _meta_step(V=V, D=1 if fault == "too wide" else 16,
                                    B=2, decisions=decisions)
    if fault == "dtype":
        state[1] = state[1].to(torch.int64)
    elif fault == "shape":
        state[2] = state[2][:, :8]
    elif fault == "strides":
        state[0] = torch.empty((128, 2), device="meta").T
    elif fault == "device":
        flags = torch.zeros(2, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        DS.dpll_step(state, outs, flags, 0, False, True, True)


def test_sweep_workspace_adds_into_the_given_buffers():
    """``dense_sweep(..., out=...)`` on the CPU adds into the buffers it
    is given, so a workspace left dirty shows in the results."""
    rng = np.random.default_rng(2)
    C, V, B = 256, 128, 4
    P = torch.from_numpy((rng.random((C, V)) < 0.03).astype(np.float32))
    N = torch.from_numpy((rng.random((C, V)) < 0.03).astype(np.float32))
    P[:, :2] = 0
    N[:, :2] = 0
    N *= 1 - P
    width = (P.sum(1) + N.sum(1))[None, :]
    A = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], size=(B, V))
                         .astype(np.float32))
    P, N = P.to(torch.bfloat16), N.to(torch.bfloat16)
    fresh = port_ds.dense_sweep(P, N, width, A, True)
    out = port_dp._sweep_workspace(B, V, True, "cpu")
    got = port_ds.dense_sweep(P, N, width, A, True, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, f in zip(got, fresh):
        assert torch.equal(g, f)
    again = port_ds.dense_sweep(P, N, width, A, True, out=out)
    assert torch.equal(again[0], 2 * fresh[0]) and fresh[0].any()
