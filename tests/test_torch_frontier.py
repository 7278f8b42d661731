"""The port's frontier solver (``mythril_tpu_torch/ops/frontier.py`` and
the plain versions of the kernels in ``ops/frontier_kernels.py``)
against the JAX package's ``mythril_tpu/ops/frontier.py``, on the CPU:
the adjacency, the BCP row scan, the multi-dispatch frontier round
field for field, and the gather and cone tiers of the backend with the
resident solver on and off.  Every comparison is exact (integers)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mythril_tpu.smt as JS
from mythril_tpu.ops import batched_sat as jax_bs
from mythril_tpu.ops import frontier as JF
from mythril_tpu.smt.solver import get_blast_context as jax_context
from mythril_tpu.smt.solver import reset_blast_context as jax_reset
from mythril_tpu_torch import frontiers
from mythril_tpu_torch.ops import batched_sat as port_bs
from mythril_tpu_torch.ops import frontier as PF
from mythril_tpu_torch.ops import frontier_kernels as FK
from mythril_tpu_torch.ops.incremental import reset_cone_memo
from mythril_tpu_torch.smt.solver import get_blast_context as port_context
from mythril_tpu_torch.smt.solver import reset_blast_context as port_reset

K = 8
KNOBS = ("MYTHRIL_TPU_FRONTIER", "MYTHRIL_TPU_FRONTIER_PERIOD",
         "MYTHRIL_TPU_FRONTIER_FAN", "MYTHRIL_TPU_FRONTIER_DEG",
         "MYTHRIL_TPU_RESIDENT_KERNEL", "MYTHRIL_TPU_RESIDENT_BUDGET",
         "MYTHRIL_TPU_RESIDENT_WATCHDOG", "MYTHRIL_TPU_RESIDENT_EXTRA")


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    yield


def random_cnf(rng, nv, ratio, width=3):
    """Clause rows over vars 2..nv (var 1 the TRUE anchor, a unit row),
    bucketed to a power of two with all-zero pad rows."""
    nc = int(ratio * nv)
    rows = np.zeros((nc + 1, K), np.int32)
    rows[0, 0] = 1
    for i in range(1, nc + 1):
        vs = rng.choice(np.arange(2, nv + 1), size=width, replace=False)
        rows[i, :width] = vs * rng.choice([1, -1], size=width)
    C = 64
    while C < len(rows):
        C *= 2
    lits = np.zeros((C, K), np.int32)
    lits[: len(rows)] = rows
    return lits


def random_assign(rng, nv, B, n_real, fixed=2, twins=True):
    """Assumption-seeded lanes; bucket pads are all ones.  With
    ``twins`` lane 1 repeats lane 0 (they learn equal clauses)."""
    assign = np.ones((B, nv + 1), np.int8)
    assign[:n_real] = 0
    assign[:, 1] = 1
    for lane in range(n_real):
        for v in rng.choice(np.arange(2, nv + 1), size=fixed, replace=False):
            assign[lane, v] = rng.choice([-1, 1])
    if twins and n_real > 1:
        assign[1] = assign[0]
    return assign


# ------------------------------------------------------------- adjacency


def test_adjacency_matches_jax():
    rng = np.random.default_rng(5)
    lits = random_cnf(rng, 40, 6.0)
    for deg in (2, 4, 32):
        np.testing.assert_array_equal(
            PF.build_adjacency(lits, 41, deg=deg),
            JF.build_adjacency(lits, 41, deg=deg))


# ------------------------------------------------------------- row scan


@pytest.mark.parametrize("scores", [True, False])
@pytest.mark.parametrize("view", ["full", "gather"])
def test_scan_rows_plain_matches_jax(view, scores):
    """All eight outputs of ``scan_rows_plain`` equal JAX
    ``make_scan_rows`` (jitted), over rows with pad literals, all-zero
    rows, invalid rows (gather view), units, conflicts and open rows."""
    import jax

    rng = np.random.default_rng(17 if view == "full" else 18)
    B, G, V1 = 6, 96, 40
    rows = np.zeros((B, G, K), np.int32)
    for b in range(B):
        for g in range(G - 8):  # the last rows stay all-zero padding
            w = int(rng.integers(1, K + 1))
            vs = rng.choice(np.arange(1, V1), size=w, replace=False)
            rows[b, g, :w] = vs * rng.choice([1, -1], size=w)
    row_ids = rng.integers(0, 5000, size=(B, G)).astype(np.int32)
    valid = (np.ones((B, G), bool) if view == "full"
             else rng.random((B, G)) < 0.7)
    assign = rng.choice([-1, 0, 0, 1], size=(B, V1)).astype(np.int8)
    assign[:, 0] = 0
    assign[:, 1] = 1
    want = jax.jit(JF.make_scan_rows(V1), static_argnums=4)(
        jnp.asarray(rows), jnp.asarray(row_ids), jnp.asarray(valid),
        jnp.asarray(assign), scores)
    got = PF.scan_rows_plain(torch.from_numpy(rows),
                             torch.from_numpy(row_ids),
                             torch.from_numpy(valid),
                             torch.from_numpy(assign), V1, scores)
    for name, w, g in zip(
        ("fpos", "fneg", "rpos", "rneg", "conflict", "conflict_row",
         "spos", "sneg"), want, got,
    ):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert np.asarray(want[0]).any() and np.asarray(want[4]).any()
    assert np.asarray(want[6]).any() == scores


# ------------------------------------------------------ the frontier round

#: (seed, vars, clause ratio, lanes, real lanes, round budget)
ROUND_CASES = [
    (1, 40, 4.2, 8, 6, 16),
    (2, 60, 4.0, 8, 7, 32),
    (3, 30, 4.6, 4, 3, 24),
    (4, 80, 3.6, 16, 12, 8),
]


@pytest.fixture(scope="module")
def round_results():
    """Every case through both rounds, once per module."""
    out = []
    for seed, nv, ratio, B, n_real, budget in ROUND_CASES:
        rng = np.random.default_rng(seed)
        lits = random_cnf(rng, nv, ratio)
        assign = random_assign(rng, nv, B, n_real)
        adj = JF.build_adjacency(lits, nv + 1)
        pref = np.zeros(nv + 1, np.int8)
        pref[2:6] = rng.choice([-1, 1], size=4)
        state = JF.frontier_state0(assign, n_real, 256, pref_row=pref)
        step = JF.make_frontier_round_step(nv, budget, 256)
        jout = step(jnp.asarray(lits), jnp.asarray(adj),
                    *[jnp.asarray(state[k]) for k in JF.FRONTIER_STATE_FIELDS])
        want = {k: np.asarray(v)
                for k, v in zip(JF.FRONTIER_STATE_FIELDS, jout)}
        got = PF.frontier_round(torch.from_numpy(lits),
                                torch.from_numpy(adj), state, budget)
        out.append((want, got))
    return out


@pytest.mark.parametrize("case", range(len(ROUND_CASES)))
def test_frontier_round_matches_jax(round_results, case):
    want, got = round_results[case]
    for name in JF.FRONTIER_STATE_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_frontier_round_cases_are_not_vacuous(round_results):
    """The cases hold a SAT lane, an UNSAT lane, a lane still live at
    the budget, learned clauses, and both kinds of view."""
    status = np.concatenate([w["status"] for w, _ in round_results])
    assert (status == 1).any() and (status == 2).any()
    assert (status == 0).any()
    assert sum(int(w["nlearn"].sum()) for w, _ in round_results) > 0
    assert any(w["fsteps"].any() for w, _ in round_results)
    assert any(w["fullsw"].any() for w, _ in round_results)


# ------------------------------------------------------------- harvest


class _HarvestCtx:
    def __init__(self):
        self.harvested = []

    def harvest_device_clauses(self, clauses):
        self.harvested.extend(tuple(sorted(int(x) for x in c))
                              for c in clauses)
        return len(clauses)


def test_harvest_learned_remaps_and_dedupes():
    rows = [
        np.asarray([-2, 3, 0, 0], np.int32),
        np.asarray([3, -2, 0, 0], np.int32),   # the same clause
        np.asarray([-9, 0, 0, 0], np.int32),   # column 9 unmapped
    ]
    col_to_var = np.asarray([0, 1, 17, 23], np.int64)
    got, want = _HarvestCtx(), _HarvestCtx()
    assert PF.harvest_learned(got, rows, col_to_var) == JF.harvest_learned(
        want, rows, col_to_var) == 1
    assert got.harvested == want.harvested == [(-17, 23)]


# ---------------------------------------------------------- the wrappers


def test_wrappers_never_fall_back_for_device_tensors(monkeypatch):
    """Tensors off the CPU go to the kernels or raise: the plain
    versions are never taken for them, and nothing is counted."""
    def no_plain(*_args, **_kwargs):
        raise AssertionError("plain version taken for a device tensor")

    for name in ("_scan_rows_plain", "_lane_step_plain",
                 "_round_epilogue_plain"):
        monkeypatch.setattr(FK, name, no_plain)
    meta = torch.device("meta")
    lane = {k: torch.zeros((4, 16), dtype=FK._DTYPES.get(k, torch.int32),
                           device=meta) for k in PF.FRONTIER_STATE_FIELDS}
    lane["dvar"] = torch.zeros((4, 16), dtype=torch.int32, device=meta)
    lane["learned"] = torch.zeros((4, 8, K), dtype=torch.int32, device=meta)
    for k in ("depth", "status", "stamp", "fullsw", "fsteps", "nlearn"):
        lane[k] = torch.zeros(4, dtype=torch.int32, device=meta)
    cfg = FK.StepConfig(fan=16, period=8, limit=8, watchdog=0, extra_cap=0,
                        learn_cap=8, uip_iters=PF.UIP_ITERS)
    lits = torch.zeros((64, K), dtype=torch.int32, device=meta)
    adj = torch.zeros((16, 4), dtype=torch.int32, device=meta)
    before = dict(FK.launch_counts)
    for wrapper in (FK.scan_rows, FK.lane_step, FK.round_epilogue):
        loop = FK.Loop(lits, adj,
                       torch.zeros((1, K), dtype=torch.int32, device=meta),
                       torch.zeros((2, FK.NCTL), dtype=torch.int32,
                                   device=meta),
                       lane, FK.make_buffers(4, 16, meta), cfg)
        with pytest.raises((ValueError, RuntimeError)):
            wrapper(loop, 0)
    assert FK.launch_counts == before


def test_kernel_shared_memory_takes_every_tier_shape():
    """The kernels' shared-memory layout takes every shape the gather
    tiers give them: each lane's scan runs on a cluster of blocks that
    splits its four accumulation planes (the smallest power of two up to
    8 whose block fits and whose lanes x blocks fill the card's SMs), so
    the full-pool tier's V1 = 8193 and the union-cone tier's largest
    bucket (V1 = 16385) keep the planes in shared memory at 64 lanes and
    at any lane count from 1 to 1024; the epilogue stages the resident
    pool and the learned rows; a shape no block fits is refused before
    any launch."""
    def scan_bytes(V1, S, fan=PF.DEFAULT_FAN):
        width = (-(-V1 // S) + 3) & ~3      # each block's slice of vars
        a16 = (V1 + 15) & ~15
        return 16 * width + 2 * 512 * 32 + 2 * (a16 + 16) + 4 * fan

    pool_v1 = port_bs.MAX_GATHER_VARS + 1
    assert pool_v1 == 8193
    pool = FK.smem_layout(64, pool_v1, PF.DEFAULT_FAN, PF.UIP_ITERS, 64)
    assert pool["cluster"] == 2
    assert pool["scan_rows"] == scan_bytes(pool_v1, 2) == 114880
    assert pool["round_epilogue"] == 8208 + 32 * (64 + 64) + 12 * 64
    cone_v1 = port_bs.DevicePool._bucket(port_bs.MAX_CONE_GATHER_VARS + 1) + 1
    assert cone_v1 == 16385
    cone = FK.smem_layout(64, cone_v1, PF.DEFAULT_FAN, PF.UIP_ITERS, 64)
    assert cone["cluster"] == 2
    assert cone["scan_rows"] == scan_bytes(cone_v1, 2) == 196800
    # one block a lane is too small for the cone tier's planes
    assert 16 * cone_v1 + 2 * 16384 > FK.MAX_DYNAMIC_SMEM
    for B, at_pool, at_cone in ((1, 8, 8), (7, 8, 8), (16, 8, 8),
                                (32, 4, 4), (64, 2, 2), (128, 1, 2),
                                (1024, 1, 2)):
        for V1, S in ((pool_v1, at_pool), (cone_v1, at_cone)):
            layout = FK.smem_layout(B, V1, PF.DEFAULT_FAN, PF.UIP_ITERS, 64)
            assert layout["cluster"] == S, (B, V1)
            assert layout["scan_rows"] == scan_bytes(V1, S)
            assert B * S >= FK.CLUSTER_BLOCKS or S == FK.MAX_CLUSTER
    for layout in (pool, cone, FK.smem_layout(4096, cone_v1, 1024, 512)):
        assert all(0 < layout[k] <= FK.MAX_DYNAMIC_SMEM
                   for k in FK.KERNEL_IDS)
    with pytest.raises(ValueError, match="shared memory"):
        FK.smem_layout(64, 1 << 17, PF.DEFAULT_FAN, PF.UIP_ITERS)
    with pytest.raises(ValueError, match="round_epilogue"):
        FK.smem_layout(1024, cone_v1, PF.DEFAULT_FAN, PF.UIP_ITERS, 8192)


@pytest.mark.parametrize("B,V1,S", [
    (64, 2049, 2), (64, 8193, 2), (64, 16385, 2), (8, 4097, 8),
    (4, 4097, 8), (8, 2049, 8), (4, 2049, 8), (1, 2049, 8),
    (16, 8193, 8), (32, 8193, 4), (128, 2049, 1), (256, 16385, 1)])
def test_lane_step_cluster_follows_the_rule(B, V1, S):
    """The lane step runs each lane on a cluster of the smallest power
    of two S of blocks with B x S >= 128 (about one block an SM), at
    most the portable 8, at the main path's shapes (the guard chain's
    64 x 2049, the scale runs' 4 and 8 lanes by 2049 and 4097) and the
    tiers' widest; every block takes the first-UIP walk's list (16
    bytes and two flag bytes for each of up to 8 (uip_iters + 1) vars)
    and two bitmaps over V1."""
    layout = FK.smem_layout(B, V1, PF.DEFAULT_FAN, PF.UIP_ITERS, 64)
    assert layout["lane_cluster"] == S
    assert B * S >= FK.CLUSTER_BLOCKS or S == FK.MAX_CLUSTER
    assert S == 1 or B * S // 2 < FK.CLUSTER_BLOCKS
    cap = K * (PF.UIP_ITERS + 1)
    bitmap = (4 * -(-V1 // 32) + 15) & ~15
    assert layout["lane_step"] == 16 * cap + ((2 * cap + 15) & ~15) \
        + 2 * bitmap


def test_epilogue_when_every_lane_learns_matches_jax(monkeypatch):
    """Two resident iterations from a state in which every lane has
    decided its gadget's ``x`` and forced ``a``, ``b`` and ``c`` (the
    gadgets of ``frontiers.learning_problem``): in the first every lane
    conflicts and learns ``(-x, -s)``, and the plain epilogue appends rows
    equal across lanes, a row equal to a live pool row and more rows than
    the pool has room for; in the second (a full view) the lanes decide
    and cascade.  The JAX resident solve and the port's (the plain
    kernels) leave every field equal: the pool, its count and the
    cascade's vars among them."""
    from mythril_tpu.ops import resident as JR
    from mythril_tpu_torch.ops import resident as PR

    C, V1, E = 1024, 513, 8
    for name, value in (("MYTHRIL_TPU_RESIDENT_EXTRA", str(E)),
                        ("MYTHRIL_TPU_RESIDENT_BUDGET", "2"),
                        ("MYTHRIL_TPU_FRONTIER_PERIOD", "1")):
        monkeypatch.setenv(name, value)
    rows, _, extra = frontiers.learning_problem(C, V1, 12, E, prefill=6)
    gadgets = [0, 0, 1, 1, 2, 3, 4, 5]
    B = len(gadgets)
    selectors = 3 + 5 * np.arange(6)
    assign = np.zeros((B, V1), np.int8)
    assign[:, 1] = 1  # the TRUE anchor
    assign[:, 2] = 1  # the delay var: its rows are satisfied
    assign[:, selectors] = -1
    state = JR.resident_state0(assign, B, 256)
    for lane, g in enumerate(gadgets):
        s, x, a, b, c = selectors[g] + np.arange(5)
        state["assign"][lane, [s, x, a, b, c]] = 1
        state["lvl"][lane, [x, a, b, c]] = 1
        state["reason"][lane, [a, b, c]] = 1 + 4 * g + np.arange(3)
        state["tpos"][lane, [x, a, b, c]] = (1, 2, 2, 3)
        state["dvar"][lane, 0] = x
        state["dphase"][lane, 0] = 1
    state["depth"][:] = 1
    state["stamp"][:] = 3
    extra[E - 2, :2] = (-(selectors[5] + 1), -selectors[5])  # lane 7's row
    state["extra"] = extra
    state["nextra"] = np.array([E - 1], np.int32)
    before = state["assign"].copy()
    adj = JF.build_adjacency(rows, V1)
    jout = JR.make_resident_step(V1 - 1, 256)(
        jnp.asarray(rows), jnp.asarray(adj),
        *[jnp.asarray(state[k]) for k in JR.RESIDENT_STATE_FIELDS])
    want = {k: np.asarray(v) for k, v in zip(JR.RESIDENT_STATE_FIELDS, jout)}

    events = []
    real = FK._round_epilogue_plain

    def recording(loop, parity):
        ne = int(loop.ctl[parity, FK.NEXTRA])
        okl = loop.buf["okl"] != 0
        learned = [tuple(r) for r in loop.buf["litrow"][okl].tolist()]
        pool = {tuple(r) for r in loop.extra[:ne].tolist()}
        cascades = int(((loop.buf["flags"] & FK.FLAG_CASCADE) != 0).sum())
        real(loop, parity)
        events.append((learned, pool, ne,
                       int(loop.ctl[1 - parity, FK.NEXTRA]), cascades))

    monkeypatch.setattr(FK, "_round_epilogue_plain", recording)
    got = PR.resident_solve(torch.from_numpy(rows), torch.from_numpy(adj),
                            state)
    for name in JR.RESIDENT_STATE_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    (learned, pool, ne, after, _), (_, _, _, _, cascades) = events
    assert len(learned) == B and len(set(learned)) < B
    assert set(learned) & pool
    assert after == E and ne + len(set(learned) - pool) > E
    assert cascades
    settled = (want["assign"] != 0) & (before == 0)
    assert settled[:, -(V1 // 8):].any()  # unused vars: the cascade's


def test_kernel_build_raises_without_toolkit(monkeypatch, tmp_path):
    from mythril_tpu_torch.ops import dense_sweep

    monkeypatch.setattr(dense_sweep, "CUDA_HOMES", (str(tmp_path),))
    monkeypatch.setattr(dense_sweep.shutil, "which", lambda _name: None)
    monkeypatch.setattr(FK, "LIBRARY", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="nvcc"):
        FK.build_library()


# ------------------------------------------ the backend's gather tiers


def _backend_run(side, recipe, tier):
    """One frontier through ``check_assumption_sets`` on ``side``: the
    verdicts, the assignments, the pool after the harvest (CSR) and the
    counters."""
    if side == "jax":
        jax_reset()
        lanes, _ = recipe(JS)
        ctx = jax_context()
        backend = jax_bs.BatchedSatBackend()
        stats = jax_bs.dispatch_stats
    else:
        port_reset()
        reset_cone_memo()
        lanes, _ = recipe(None)
        ctx = port_context()
        backend = port_bs.BatchedSatBackend("cpu")
        stats = port_bs.dispatch_stats
    sets = [list(dict.fromkeys(ctx.blast_lit(c.raw) for c in lane))
            for lane in lanes]
    # a CDCL model of lane 0 seeds the warm-start phases
    ctx.check([c.raw for c in lanes[0]])
    stats.reset()
    verdicts = backend.check_assumption_sets(ctx, sets)
    assert backend.device_engaged
    counters = {name: getattr(stats, name) for name in (
        "frontier_steps", "warm_start_hits", "learned_clauses", "pool_uploads",
        "delta_uploads", "size_bailouts", "cone_bailouts", "rounds",
        "device_sweeps", "repacks", "resident_dispatches",
        "resident_exit_all_decided", "resident_exit_budget",
        "resident_exit_watchdog", "resident_delegations",
        "lane_slots_filled", "lane_slots_total")}
    lits, indptr = ctx.pool.csr()
    return (verdicts, np.asarray(backend.last_assignments), counters,
            (lits.tolist(), indptr.tolist()))


@pytest.mark.parametrize("resident", ["1", "0"])
@pytest.mark.parametrize("tier", ["gather", "cone"])
def test_gather_tiers_match_jax(monkeypatch, tier, resident):
    """A frontier in the full-pool gather tier and one in the union-cone
    tier (the pool caps set to 0 on both sides), with the resident
    solver on and off: verdicts, assignments, every new counter and the
    pool after the learned-clause harvest are equal."""
    import jax
    from mythril_tpu.resilience import watchdog
    from mythril_tpu_torch.resilience import watchdog as port_watchdog

    devices = jax.devices  # one device, as the port (no sharded mesh)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    # both dispatch watchdogs out of reach (a cold jit takes seconds)
    monkeypatch.setattr(watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setattr(port_watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "3600")
    monkeypatch.setenv("MYTHRIL_TPU_PALLAS", "0")
    monkeypatch.setenv("MYTHRIL_TPU_DENSE", "0")
    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_KERNEL", resident)
    if tier == "cone":
        monkeypatch.setattr(jax_bs, "MAX_GATHER_VARS", 0)
        monkeypatch.setattr(port_bs, "MAX_GATHER_VARS", 0)

    def recipe(S):
        return frontiers.scale_mul_frontier(3, 8, smt=S, calldata="words")

    try:
        want = _backend_run("jax", recipe, tier)
        got = _backend_run("port", recipe, tier)
    finally:
        jax_reset()
        port_reset()
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[3] == want[3]
    counters = got[2]
    assert False in got[0] and counters["frontier_steps"] > 0
    assert counters["learned_clauses"] > 0 and counters["warm_start_hits"]
    assert counters["resident_dispatches"] == (1 if resident == "1" else 0)
    if tier == "cone":
        assert counters["pool_uploads"] == 0
    else:
        assert counters["pool_uploads"] == 1
