"""The port's veritesting tier (``mythril_tpu_torch/laser/ethereum/
veritest.py``) against the JAX package's, on the CPU.

Each unit case builds the same states on both packages (a copy of the
JAX package's own veritest harness: ``make_state``, ``diverged_pair``,
``_identical_twins``) and runs the same transition: the merge of a
diverged pair (the join, the ite budget, the divergence window, diverged
storage, prefix-shaped constraints) and the four subsumption cases.  The
outcome (merged or not, the lanes a sweep retires), ``str`` of the
merged lane's stack words and constraints and the tier's counters are
equal; a merged constraint set is satisfiable through each package's
``get_model``.  ``subset_matrix`` and ``_merge_planes`` are held against
the JAX package's on seeded inputs, the engine's gate on both sides, and
whole analyses through ``test_torch_analyze._parity`` (issues, states,
prune verdicts and every counter equal) with ``merges > 0`` on both
sides, and under the ``MYTHRIL_TPU_VERITEST=0`` kill switch.  Nothing is
compared with a tolerance: everything is exact.

Each merge is a ``merge`` transition of both lane ledgers, and an armed
``merge_abort`` fault (``resilience/faults.py``, on both fault planes)
degrades every join to plain forking on both sides alike.
"""

import importlib
from copy import copy
from datetime import datetime
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mythril_tpu_torch import contracts
from mythril_tpu_torch.support.support_args import args as port_args
from test_torch_analyze import _parity, analysis_pins, fresh_planes

pytestmark = pytest.mark.veritest

#: the tier's knobs, unset around every test
KNOBS = ("MYTHRIL_TPU_VERITEST", "MYTHRIL_TPU_MERGE_MAX_ITES",
         "MYTHRIL_TPU_MERGE_WINDOW", "MYTHRIL_TPU_SUBSUME_PERIOD")

#: the tier's counters, compared exactly
COUNTERS = ("merges", "merged_lanes", "merge_ites", "merge_aborts",
            "subsume_sweeps", "subsumed_lanes")


def _side(package):
    def mod(name):
        return importlib.import_module(f"{package}.{name}")

    state = "laser.ethereum.state"
    return SimpleNamespace(
        name=package,
        Disassembly=mod("disassembler.disassembly").Disassembly,
        ConcreteCalldata=mod(f"{state}.calldata").ConcreteCalldata,
        Environment=mod(f"{state}.environment").Environment,
        GlobalState=mod(f"{state}.global_state").GlobalState,
        MachineState=mod(f"{state}.machine_state").MachineState,
        WorldState=mod(f"{state}.world_state").WorldState,
        LaserEVM=mod("laser.ethereum.svm").LaserEVM,
        MessageCallTransaction=mod(
            "laser.ethereum.transaction.transaction_models"
        ).MessageCallTransaction,
        veritest=mod("laser.ethereum.veritest"),
        lockstep=mod("laser.ethereum.symbolic_lockstep"),
        resident=mod("ops.resident"),
        stats=mod("ops.batched_sat").dispatch_stats,
        ledger=mod("observability.ledger"),
        smt=mod("smt"),
        get_model=mod("support.model").get_model,
        time_handler=mod("laser.ethereum.time_handler").time_handler,
    )


SIDES = {"jax": _side("mythril_tpu"), "port": _side("mythril_tpu_torch")}


@pytest.fixture(autouse=True)
def no_deadline(monkeypatch):
    """Both packages' execution deadlines disarmed before and after each
    test (a deadline an earlier test armed in this process would make
    ``get_model`` answer UNSAT once it expired), the tier's knobs unset,
    and the port's solver on the CPU."""
    for side in SIDES.values():
        side.time_handler._deadline_ms = None
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(port_args, "device", "cpu")
    try:
        yield
    finally:
        for side in SIDES.values():
            side.time_handler._deadline_ms = None


# ---------------------------------------------------------------------------
# harness: the JAX package's own veritest harness, on either package
# ---------------------------------------------------------------------------


def bv(S, value, width=256):
    return S.smt.symbol_factory.BitVecVal(value, width)


def make_state(S, code_hex, stack=None, pc=0, gas_limit=8_000_000):
    world_state = S.WorldState()
    account = world_state.create_account(
        balance=10, address=0x0A, concrete_storage=True,
        code=S.Disassembly(code_hex),
    )
    environment = S.Environment(
        account,
        sender=bv(S, 0xB0B),
        calldata=S.ConcreteCalldata("1", []),
        gasprice=bv(S, 1),
        callvalue=bv(S, 0),
        origin=bv(S, 0xB0B),
    )
    state = S.GlobalState(world_state, environment, None,
                          S.MachineState(gas_limit))
    state.transaction_stack.append((
        S.MessageCallTransaction(
            world_state=world_state, callee_account=account,
            caller=environment.sender, gas_limit=8_000_000,
        ),
        None,
    ))
    state.mstate.pc = pc
    for item in stack or []:
        state.mstate.stack.append(
            bv(S, item) if isinstance(item, int) else item)
    return state


def make_svm(S):
    svm = S.LaserEVM(requires_statespace=False, execution_timeout=600)
    svm.time = datetime.now()
    return svm


def make_engine(S):
    return S.veritest.VeritestEngine(make_svm(S))


def diverged_pair(S, code_hex="6001600201", stack_a=7, stack_b=9):
    """Two fork siblings at the same frame: a shared prefix constraint,
    one diverging constraint each, one diverging stack word."""
    x = S.smt.symbol_factory.BitVecSym("vt_x", 256)
    base = make_state(S, code_hex)
    base.world_state.constraints.append(x < bv(S, 100))
    a, b = copy(base), copy(base)
    a.world_state.constraints.append(x == bv(S, 1))
    b.world_state.constraints.append(x == bv(S, 2))
    a.mstate.stack.append(bv(S, stack_a))
    b.mstate.stack.append(bv(S, stack_b))
    return a, b


def identical_twins(S):
    base = make_state(S, "6001600201")
    return copy(base), copy(base)


def counters(S):
    return {name: getattr(S.stats, name) for name in COUNTERS}


def merge_outcome(S, a, b):
    """Merge ``a`` and ``b`` on a fresh engine: what both sides compare,
    and the merged lane (or None)."""
    engine = make_engine(S)
    S.stats.reset()
    merged = engine._try_merge(a, b, a.mstate.pc)
    out = {"merged": merged is not None, "counters": counters(S),
           "max_ites": engine.max_ites, "window": engine.window}
    if merged is not None:
        ms = merged.mstate
        out.update(
            pc=ms.pc, depth=ms.depth,
            gas=(ms.min_gas_used, ms.max_gas_used),
            stack=[str(word) for word in ms.stack],
            constraints=[str(c) for c in merged.world_state.constraints],
        )
    return out, merged


def both(case):
    """``case(S)`` on each package, the port's outcome held equal to
    JAX's: (that outcome, the port's merged lane or None)."""
    (want, _), (got, merged) = (case(SIDES[name]) for name in ("jax", "port"))
    assert got == want
    return want, merged


# ---------------------------------------------------------------------------
# the merge join
# ---------------------------------------------------------------------------


def test_merge_pair_joins_stack_word_and_constraints():
    def case(S):
        a, b = diverged_pair(S)
        prefix = [str(c) for c in list(a.world_state.constraints)[:-1]]
        out, merged = merge_outcome(S, a, b)
        assert merged is not None
        # the shared prefix verbatim and one disjunction; the diverging
        # word one guarded term, not either arm's constant
        assert out["constraints"][:-1] == prefix
        assert len(out["constraints"]) == len(prefix) + 1
        assert merged.mstate.stack[-1].symbolic
        assert out["stack"][-1] not in ("7", "9")
        assert S.get_model(list(merged.world_state.constraints)) is not None
        return out, merged

    want, _ = both(case)
    assert want["counters"]["merge_ites"] == 1


def test_merge_counts_ites_and_preserves_agreeing_words():
    def case(S):
        a, b = diverged_pair(S)
        agreeing = bv(S, 42)
        a.mstate.stack.insert(0, agreeing)
        b.mstate.stack.insert(0, agreeing)
        return merge_outcome(S, a, b)

    want, merged = both(case)
    assert want["merged"] and want["stack"][0] == "42"
    assert want["counters"]["merge_ites"] == 1
    assert SIDES["port"].get_model(
        list(merged.world_state.constraints)) is not None


def test_merge_joins_memory_and_keeps_lanes_apart():
    """A diverging memory byte past lane a's extent: the merged lane's
    memory grows to lane b's and holds one guarded byte; neither arm's
    stack or memory is the merged lane's list."""
    def case(S):
        a, b = diverged_pair(S)
        b.mstate.mem_extend(0, 32)
        b.mstate.memory[31] = 0x5A
        out, merged = merge_outcome(S, a, b)
        assert merged is not None
        for arm in (a, b):
            assert merged.mstate.stack is not arm.mstate.stack
            assert merged.mstate.memory._memory is not arm.mstate.memory._memory
        out["memory"] = [str(v) for v in merged.mstate.memory._memory]
        return out, merged

    want, _ = both(case)
    assert want["counters"]["merge_ites"] == 2
    assert len(want["memory"]) == 32 and want["memory"][0] == "0"


def test_merge_joins_path_local_annotations():
    """Lanes that differ only in their path-local annotations (the loop
    tracer's JUMPDEST trace, the dependency pruner's records) merge; the
    merged lane holds each class's join: the longer trace, the union of
    the records and the intersection of the blocks seen."""
    def case(S):
        bounded = importlib.import_module(
            f"{S.name}.laser.ethereum.strategy.extensions.bounded_loops")
        plugin = importlib.import_module(
            f"{S.name}.laser.plugin.plugins.plugin_annotations")
        a, b = diverged_pair(S)
        for state, trace, loaded, blocks, call in (
                (a, [1, 5], [7], {1, 2}, False),
                (b, [1, 5, 9, 5], [8, 7], {2, 3}, True)):
            jumps = bounded.JumpdestCountAnnotation()
            jumps.trace = list(trace)
            deps = plugin.DependencyAnnotation()
            deps.storage_loaded = list(loaded)
            deps.storage_written = {0: list(loaded)}
            deps.path = [0] + list(loaded)
            deps.blocks_seen = set(blocks)
            deps.has_call = call
            state.annotate(jumps)
            state.annotate(deps)
        out, merged = merge_outcome(S, a, b)
        assert merged is not None
        jumps, deps = merged.annotations[-2:]
        out["annotations"] = (
            jumps.trace, deps.storage_loaded, deps.storage_written,
            deps.path, sorted(deps.blocks_seen), deps.has_call)
        return out, merged

    want, _ = both(case)
    assert want["annotations"] == (
        [1, 5, 9, 5], [7, 8], {0: [7, 8]}, [0, 7, 8], [2], True)


def test_merge_ite_budget_aborts_to_fork(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_MERGE_MAX_ITES", "0")
    want, _ = both(lambda S: merge_outcome(S, *diverged_pair(S)))
    assert want["max_ites"] == 0 and not want["merged"]
    assert want["counters"]["merge_aborts"] == 1
    assert want["counters"]["merges"] == 0


def test_merge_window_bounds_constraint_suffix(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_MERGE_WINDOW", "1")

    def case(S):
        a, b = diverged_pair(S)
        y = S.smt.symbol_factory.BitVecSym("vt_y", 256)
        # a suffix of 2 on one side, past the window of 1
        a.world_state.constraints.append(y == bv(S, 3))
        return merge_outcome(S, a, b)

    want, _ = both(case)
    assert not want["merged"] and want["counters"]["merge_aborts"] == 1


def test_diverged_storage_aborts_merge():
    def case(S):
        a, b = diverged_pair(S)
        b.environment.active_account.storage[bv(S, 0)] = bv(S, 0xDEAD)
        return merge_outcome(S, a, b)

    want, _ = both(case)
    assert not want["merged"] and want["counters"]["merge_aborts"] == 1


def test_prefix_shaped_constraints_never_merge():
    """One side's constraints a prefix of the other's: a subsumption
    shape, not a diamond; the merge declines it without an abort."""
    def case(S):
        base = make_state(S, "6001600201")
        x = S.smt.symbol_factory.BitVecSym("vt_p", 256)
        base.world_state.constraints.append(x == bv(S, 1))
        a, b = copy(base), copy(base)
        b.world_state.constraints.append(x < bv(S, 50))
        return merge_outcome(S, a, b)

    want, _ = both(case)
    assert not want["merged"] and want["counters"]["merge_aborts"] == 0


# ---------------------------------------------------------------------------
# subsumption: the stronger lane retires into the weaker, never the reverse
# ---------------------------------------------------------------------------


def subsume_outcome(S, work_list):
    """One sweep over ``work_list``: the indices of the lanes left, the
    counters, and the lane ledger's transitions and conservation (a
    fresh ledger)."""
    engine = make_engine(S)
    lanes = list(work_list)
    S.stats.reset()
    with fresh_planes():
        engine._subsume_pass(work_list)
        snap = S.ledger.get_ledger().snapshot()
    return {"left": [lanes.index(s) for s in work_list],
            "counters": counters(S), "transitions": snap["transitions"],
            "conserved": sum(snap["decided"].values())
            == snap["lanes_total"]}, None


def test_subsume_retires_superset_constraint_lane():
    def case(S, weak_first):
        weak, strong = identical_twins(S)
        x = S.smt.symbol_factory.BitVecSym("vt_s", 256)
        p = x < bv(S, 10)
        weak.world_state.constraints.append(p)
        strong.world_state.constraints.append(p)
        strong.world_state.constraints.append(x == bv(S, 5))
        return subsume_outcome(
            S, [weak, strong] if weak_first else [strong, weak])

    for weak_first in (True, False):
        want, _ = both(lambda S: case(S, weak_first))
        assert want["left"] == [0 if weak_first else 1]
        assert want["counters"]["subsumed_lanes"] == 1
        assert want["counters"]["subsume_sweeps"] == 1
        # the ledger's aggregate-only transition, conservation intact
        assert want["transitions"] == {"subsume": 1} and want["conserved"]


def test_subsume_interval_implication_direction():
    """No constraint node in common: x == 5 retires into x < 10 through
    the word tier's interval implication; the weak lane never retires."""
    def case(S):
        weak, strong = identical_twins(S)
        v = S.smt.symbol_factory.BitVecSym("vt_i", 256)
        weak.world_state.constraints.append(S.smt.ULT(v, bv(S, 10)))
        strong.world_state.constraints.append(v == bv(S, 5))
        return subsume_outcome(S, [strong, weak])

    want, _ = both(case)
    assert want["left"] == [1] and want["counters"]["subsumed_lanes"] == 1


def test_subsume_never_fires_across_diverged_machines():
    def case(S):
        weak, strong = identical_twins(S)
        x = S.smt.symbol_factory.BitVecSym("vt_m", 256)
        p = x < bv(S, 10)
        weak.world_state.constraints.append(p)
        strong.world_state.constraints.append(p)
        strong.world_state.constraints.append(x == bv(S, 5))
        strong.mstate.stack.append(bv(S, 1))
        weak.mstate.stack.append(bv(S, 2))
        return subsume_outcome(S, [strong, weak])

    want, _ = both(case)
    assert want["left"] == [0, 1] and want["counters"]["subsumed_lanes"] == 0


def test_subsume_equal_sets_keep_exactly_one():
    def case(S):
        a, b = identical_twins(S)
        x = S.smt.symbol_factory.BitVecSym("vt_e", 256)
        p = x < bv(S, 10)
        a.world_state.constraints.append(p)
        b.world_state.constraints.append(p)
        return subsume_outcome(S, [a, b])

    want, _ = both(case)
    # the earlier of two equal sets survives
    assert want["left"] == [0] and want["counters"]["subsumed_lanes"] == 1


# ---------------------------------------------------------------------------
# subset_matrix and _merge_planes on seeded inputs
# ---------------------------------------------------------------------------


def random_id_sets(seed):
    """Lanes' constraint-id sets: empty sets, subsets of earlier sets and
    unions of two, over an id range wide enough for several 64-bit
    words."""
    rng = np.random.default_rng(seed)
    lanes = int(rng.integers(1, 14))
    top = int(rng.integers(1, 300))
    out = []
    for _ in range(lanes):
        roll = rng.random()
        if roll < 0.15:
            out.append(frozenset())
        elif roll < 0.4 and out:
            base = sorted(out[int(rng.integers(len(out)))])
            keep = rng.random(len(base)) < 0.6
            out.append(frozenset(np.asarray(base)[keep].tolist()))
        elif roll < 0.55 and len(out) > 1:
            i, j = rng.choice(len(out), size=2, replace=False)
            out.append(out[int(i)] | out[int(j)])
        else:
            size = int(rng.integers(1, min(top, 40) + 1))
            out.append(frozenset(
                rng.choice(top, size=size, replace=False).tolist()))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_subset_matrix_matches_jax(seed):
    id_sets = random_id_sets(seed)
    want = SIDES["jax"].resident.subset_matrix(id_sets)
    got = SIDES["port"].resident.subset_matrix(id_sets)
    assert got.dtype == want.dtype == np.bool_
    assert np.array_equal(got, want)
    truth = np.array([[y <= x for y in id_sets] for x in id_sets])
    assert np.array_equal(got, truth)


@pytest.mark.parametrize("id_sets", [
    [], [frozenset()], [frozenset(), frozenset()],
    [frozenset(), frozenset({7})], [frozenset({64}), frozenset({0, 64})],
], ids=["none", "one-empty", "two-empty", "empty-and-one", "word-edge"])
def test_subset_matrix_edge_cases_match_jax(id_sets):
    want = SIDES["jax"].resident.subset_matrix(id_sets)
    got = SIDES["port"].resident.subset_matrix(id_sets)
    assert got.shape == want.shape == (len(id_sets), len(id_sets))
    assert np.array_equal(got, want)


PLANE_ARRAYS = ("mem_kv", "mem_km", "skeys", "slo", "shi", "skm", "skv",
                "sused")


def random_planes(rng, lanes, mem_bytes, slots, shape):
    """Seeded plane contents of ``lanes`` rows as numpy arrays.  Row 1's
    storage keys are row 0's in another slot order (``shape`` "random"),
    fresh ones ("no common key"), or row 0's with every known value bit
    of both rows flipped ("disagree")."""
    limbs = SIDES["port"].lockstep._LIMBS

    def words(*dims):
        return rng.integers(0, 1 << 32, size=dims, dtype=np.uint32)

    out = {
        "mem_kv": rng.integers(0, 256, (lanes, mem_bytes), dtype=np.uint8),
        "mem_km": rng.random((lanes, mem_bytes)) < 0.7,
        "skeys": words(lanes, slots, limbs),
        "slo": words(lanes, slots, limbs),
        "shi": words(lanes, slots, limbs),
        "skm": words(lanes, slots, limbs),
        "skv": words(lanes, slots, limbs),
        "sused": rng.random((lanes, slots)) < 0.8,
    }
    # row 1's memory agrees with row 0's on about half of the bytes
    same = rng.random(mem_bytes) < 0.5
    out["mem_kv"][1, same] = out["mem_kv"][0, same]
    if shape != "no common key":
        order = rng.permutation(slots)
        for name in ("skeys", "slo", "shi", "skv", "skm"):
            out[name][1] = out[name][0][order]
        # some slots keep their keys but not their intervals
        moved = rng.random(slots) < 0.3
        out["slo"][1, moved] ^= np.uint32(1)
        # the known bits overlap in part, and the values agree in part
        out["skm"][1] = words(slots, limbs)
        out["skv"][1] ^= words(slots, limbs) & words(slots, limbs)
    if shape == "disagree":
        out["skm"][:2] = np.uint32(0xFFFFFFFF)
        out["skv"][1] = ~out["skv"][0][order]
        out["slo"][1] = out["slo"][0][order]
    if shape == "duplicate key":
        # row 1 holds each of row 0's first two keys twice, with other
        # values: the join takes the first slot that matches
        for i in range(2):
            for slot in (2 * i, 2 * i + 1):
                for name in ("skeys", "slo", "shi"):
                    out[name][1, slot] = out[name][0, i]
                out["sused"][1, slot] = True
        out["sused"][0, :2] = True
    return out


def load_planes(S, arrays):
    lanes, mem_bytes = arrays["mem_kv"].shape
    planes = S.lockstep._LanePlanes(lanes, mem_bytes,
                                    arrays["skeys"].shape[1])
    for name in PLANE_ARRAYS:
        if S.name == "mythril_tpu":
            getattr(planes, name)[...] = arrays[name]
        else:
            target = getattr(planes, name)
            target.copy_(torch.from_numpy(arrays[name]).to(target.dtype))
    return planes


def merged_planes(S, arrays, pc_a=5, pc_b=5, pc=5):
    planes = load_planes(S, arrays)
    a, b = SimpleNamespace(), SimpleNamespace()
    a.__dict__["_seg_planes"] = (planes, 0, pc_a)
    b.__dict__["_seg_planes"] = (planes, 1, pc_b)
    return S.veritest._merge_planes(a, b, pc)


def as_numpy(array):
    if isinstance(array, torch.Tensor):
        array = array.numpy()
    return np.asarray(array).astype(np.int64)


@pytest.mark.parametrize("shape", ["random", "no common key", "disagree",
                                   "duplicate key"])
@pytest.mark.parametrize("seed", range(3))
def test_merge_planes_matches_jax(shape, seed):
    arrays = random_planes(np.random.default_rng(seed), 3, 96, 12, shape)
    want = merged_planes(SIDES["jax"], arrays)
    got = merged_planes(SIDES["port"], arrays)
    assert want is not None and got is not None
    assert got[1:] == want[1:] == (0, 5)
    joined, jax_joined = got[0], want[0]
    assert joined.shared is False
    for name in PLANE_ARRAYS:
        assert getattr(joined, name).dtype == getattr(
            load_planes(SIDES["port"], arrays), name).dtype, name
        assert np.array_equal(as_numpy(getattr(joined, name)),
                              as_numpy(getattr(jax_joined, name))), name
    used = int(as_numpy(joined.sused).sum())
    if shape == "no common key":
        assert used == 0
    if shape == "disagree":
        # every surviving slot knows no bit of its value
        assert used > 0 and not as_numpy(joined.skm)[0, :used].any()


def test_merge_planes_declines_like_jax():
    """No plane ref, a ref at another pc, or arenas of other sizes: no
    joined planes on either side."""
    rng = np.random.default_rng(11)
    arrays = random_planes(rng, 2, 64, 4, "random")
    for S in SIDES.values():
        assert merged_planes(S, arrays, pc_b=6) is None
        assert merged_planes(S, arrays, pc_a=4, pc_b=4) is None
        assert S.veritest._merge_planes(
            SimpleNamespace(), SimpleNamespace(), 5) is None
        small = load_planes(S, random_planes(rng, 2, 32, 4, "random"))
        a, b = SimpleNamespace(), SimpleNamespace()
        a.__dict__["_seg_planes"] = (load_planes(S, arrays), 0, 5)
        b.__dict__["_seg_planes"] = (small, 1, 5)
        assert S.veritest._merge_planes(a, b, 5) is None


# ---------------------------------------------------------------------------
# the engine's gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["jax", "port"])
def test_engine_gate_declines_unsupported_consumers(monkeypatch, side):
    S = SIDES[side]
    svm = make_svm(S)
    assert S.veritest.engine_for(svm, False, False) is not None
    assert S.veritest.engine_for(svm, True, False) is None   # CREATE
    assert S.veritest.engine_for(svm, False, True) is None   # track_gas
    svm.requires_statespace = True
    assert S.veritest.engine_for(svm, False, False) is None
    svm.requires_statespace = False
    monkeypatch.setenv("MYTHRIL_TPU_VERITEST", "0")
    assert S.veritest.engine_for(svm, False, False) is None
    assert S.veritest.veritest_enabled() is False


def test_engine_knobs_match_jax(monkeypatch):
    """The defaults and the floors of the tier's three numeric knobs."""
    def knobs():
        return [(e.max_ites, e.window, e.subsume_period)
                for e in (make_engine(S) for S in SIDES.values())]

    want = [(16, 8, 4)] * 2
    assert knobs() == want
    for name in KNOBS[1:]:
        monkeypatch.setenv(name, "-3")
    assert knobs() == [(0, 1, 1)] * 2
    for name in KNOBS[1:]:
        monkeypatch.setenv(name, "bogus")
    assert knobs() == want


# ---------------------------------------------------------------------------
# whole analyses: the port against the JAX package, the tier on and off
# ---------------------------------------------------------------------------

@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread for the test: the port's resident
    solver runs its plain versions here, hundreds of small tensor ops an
    iteration, and with several test processes on one machine each
    process's thread pool oversubscribes the cores (the fork-only
    gauntlet took over 600 s beside five other test processes, 35 s on
    one thread beside three)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


#: the chip check's veritest run and the three branch shapes
SHAPES = {
    "veritest_gauntlet": contracts.veritest_gauntlet,
    "diamond": contracts.diamond,
    "nested_diamond": contracts.nested_diamond,
    "loop_exit": contracts.loop_exit,
}


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("shape", SHAPES)
def test_analysis_merges_like_jax(monkeypatch, shape):
    """Issues, states, prune verdicts, every counter (the tier's among
    them), the lane ledger and the autopilot equal, with the tier on and
    merging on both sides; every merge counts as a ``merge`` transition
    of the ledger."""
    with analysis_pins(monkeypatch):
        jax, port = _parity(SHAPES[shape](), 1)
    assert jax["counters"]["merges"] > 0
    assert port["counters"]["merges"] > 0
    # each merge is a ledger transition on both sides (``_parity`` holds
    # the ledgers equal), and the solver lanes stay conserved
    ledger = port["ledger"]["aggregates"]
    assert ledger["transitions"]["merge"] == port["counters"]["merges"]
    assert sum(ledger["decided"].values()) == ledger["lanes_total"]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("shape", SHAPES)
def test_kill_switch_forks_like_jax(monkeypatch, shape):
    """``MYTHRIL_TPU_VERITEST=0`` on both sides: no merge and no retired
    lane, equal to the JAX package, the tier-on run's SWC set, and no
    fewer states stepped than with the tier on."""
    with analysis_pins(monkeypatch):
        _jax, on = _parity(SHAPES[shape](), 1)
        monkeypatch.setenv("MYTHRIL_TPU_VERITEST", "0")
        _jax, off = _parity(SHAPES[shape](), 1)
    assert off["counters"]["merges"] == 0
    assert off["counters"]["subsumed_lanes"] == 0
    assert ({i["swc_id"] for i in off["issues"]}
            == {i["swc_id"] for i in on["issues"]})
    assert off["counters"]["states_stepped"] >= on["counters"][
        "states_stepped"]


@pytest.mark.usefixtures("one_torch_thread")
def test_merge_abort_fault_seam_degrades_to_fork(monkeypatch):
    """The port's counterpart of the JAX package's test of the same
    name: an armed ``merge_abort`` fault kills every join mid-commit on
    both sides; the degraded path is plain forking (no merge, the abort
    counter moving, the same faults fired) with the unfaulted run's
    findings, equal to the JAX package under the same schedule."""
    from mythril_tpu.resilience import faults as jax_faults
    from mythril_tpu.resilience.telemetry import resilience_stats as jax_rs
    from mythril_tpu_torch.resilience import faults as port_faults
    from mythril_tpu_torch.resilience.telemetry import (
        resilience_stats as port_rs,
    )
    from test_torch_resilience import fresh_resilience

    code = SHAPES["diamond"]()
    with analysis_pins(monkeypatch), fresh_resilience():
        _jax, clean = _parity(code, 1)
        # aborted pairs stay in the work list and retry every round, so
        # the seam needs enough shots to outlast the analysis
        for faults in (jax_faults, port_faults):
            faults.get_fault_plane().arm("merge_abort", times=10**6)
        _jax, faulted = _parity(code, 1)
        fired = (jax_rs.faults_fired, port_rs.faults_fired)
    assert clean["counters"]["merges"] > 0
    assert faulted["counters"]["merges"] == 0
    assert faulted["counters"]["merge_aborts"] > 0
    assert fired[0] == fired[1] > 0
    assert ({i["swc_id"] for i in faulted["issues"]}
            == {i["swc_id"] for i in clean["issues"]})
