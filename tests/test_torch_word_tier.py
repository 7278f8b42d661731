"""The port's word tier (``mythril_tpu_torch/smt/word_tier.py``, its
packed node table and the kernel's plain version in
``ops/word_fixpoint.py``) against the JAX package's
``smt/word_tier.py``, on the CPU.

- ``decide`` on both sides on the shapes of ``tests/test_word_tier.py``
  (interval UNSAT, known-bits contradiction, dead branch, pinned-model
  SAT, selector hints, unsupported ops open, >256-bit opaque) and on
  seeded random term DAGs at 16 and 64 lanes: verdicts, hints and
  verified models equal, for every executor of the port (scalar, host
  planes, device on ``device="cpu"`` = the kernel's plain version)
  against the JAX package's scalar and numpy executors;
- the packed table: ``word_fixpoint_plain`` equals the batched walk and
  the JAX package's numpy planes, plane for plane;
- ``hint_literals``, ``tightening_digest``, the cone memo keyed on the
  tightening, the kill switch both ways, generation scoping and
  ``reset_resident_pools``.

Node ids differ between the two packages' interners, so hints and
models are compared by variable name.  Inputs come from seeded numpy
generators; every comparison is exact.  The JAX package's dispatch
statistics and coalescer are restored after each test.
"""

import copy

import numpy as np
import pytest
import torch

from mythril_tpu.ops import batched_sat as jax_bs
from mythril_tpu.ops import coalesce as jax_co
from mythril_tpu.smt import terms as JT
from mythril_tpu.smt import word_tier as JWT
from mythril_tpu.smt.solver import get_blast_context as jax_context
from mythril_tpu.smt.solver import reset_blast_context as jax_reset
from mythril_tpu_torch.frontiers import word_dag_lanes
from mythril_tpu_torch.ops import batched_sat as port_bs
from mythril_tpu_torch.ops import word_fixpoint as WF
from mythril_tpu_torch.smt import terms as PT
from mythril_tpu_torch.smt import word_tier as PWT
from mythril_tpu_torch.smt.solver import get_blast_context as port_context
from mythril_tpu_torch.smt.solver import reset_blast_context as port_reset
from mythril_tpu_torch.support.support_args import args as port_args

#: MYTHRIL_TPU_WORD_XP per executor, and the executor the port reports
JAX_EXECUTORS = {"scalar": "scalar", "numpy": "np"}
PORT_EXECUTORS = {"scalar": "scalar", "host": "np", "device": "device"}


def _restore(obj, saved):
    state = vars(obj)
    state.clear()
    state.update(saved)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Fresh contexts and tiers on both sides, the port on the CPU; the
    JAX package's dispatch statistics and coalescer as they were."""
    saved_stats = copy.copy(vars(jax_bs.dispatch_stats))
    coalescer = jax_co.get_coalescer()
    saved_co = copy.copy(vars(coalescer))
    for name in ("MYTHRIL_TPU_WORD_TIER", "MYTHRIL_TPU_WORD_XP",
                 "MYTHRIL_TPU_WORD_ROUNDS", "MYTHRIL_TPU_WORD_MAX_NODES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(port_args, "device", "cpu")
    for reset in (jax_reset, port_reset, JWT.reset_word_tier,
                  PWT.reset_word_tier):
        reset()
    port_bs.dispatch_stats.reset()
    try:
        yield
    finally:
        for reset in (jax_reset, port_reset, JWT.reset_word_tier,
                      PWT.reset_word_tier):
            reset()
        _restore(jax_bs.dispatch_stats, saved_stats)
        _restore(coalescer, saved_co)


# ------------------------------------------------------------ term shapes


def _shapes(T):
    """name -> lanes (lists of constraint nodes), as tests/test_word_tier.py
    builds them; built in the same order on both sides."""
    x = T.var("x", 256)
    y = T.var("y", 256)
    masked = T.bv_and(x, T.const(0xFF, 256))
    sel = T.eq(T.lshr(y, T.const(224, 256)), T.const(0xDEADBEEF, 256))
    residue = T.eq(
        T.bv_and(T.mul(y, T.const(0x6D2B, 256)), T.const(0xFFFF, 256)),
        T.const(0x1234, 256))
    wide = T.add(T.zext(1, x), T.zext(1, y))  # 257 bits: opaque
    overflow = T.eq(T.extract(256, 256, wide), T.const(1, 1))
    arr = T.avar("store", 256, 256)
    return {
        "interval_unsat": [[T.ult(x, T.const(5, 256)),
                            T.ult(T.const(7, 256), x)]],
        "known_bits_contradiction": [[
            T.eq(T.bv_and(x, T.const(1, 256)), T.const(1, 256)),
            T.eq(T.bv_and(x, T.const(3, 256)), T.const(0, 256))]],
        "dead_branch": [[
            T.eq(T.bv_and(x, T.const(1, 256)), T.const(1, 256)),
            T.eq(T.bv_and(x, T.const(2, 256)), T.const(2, 256)),
            T.eq(T.bv_and(x, T.const(3, 256)), T.const(1, 256))]],
        "valid_fold": [[T.ule(T.bv_and(x, T.const(0xF, 256)),
                              T.const(0xF, 256))]],
        "pinned_model": [[T.eq(x, T.const(5, 256)),
                          T.ult(x, T.const(10, 256))]],
        "selector_sat": [[sel]],
        "selector_hints": [[sel, residue]],
        "shared_slot": [[T.eq(masked, T.const(5, 256)),
                         T.eq(masked, T.const(7, 256))]],
        "unsupported_open": [[T.eq(T.select(arr, x), T.const(1, 256))]],
        "opaque_257": [[overflow, T.ult(x, T.const(3, 256))]],
        "inverse_chain": [[T.eq(
            T.bv_xor(T.add(x, T.const(17, 256)), T.const(0xAA, 256)),
            T.const(0x1234, 256))]],
        "mixed_batch": [
            [T.ult(x, T.const(5, 256)), T.ult(T.const(7, 256), x)],
            [sel, residue],
            [T.eq(x, T.const(5, 256))],
            [T.ult(T.const(2, 256), y), T.ule(y, T.const(0x100, 256))],
        ] * 5,
    }


def _var_names(lanes):
    names = {}
    stack = [n for nodes in lanes if nodes for n in nodes]
    seen = set()
    while stack:
        n = stack.pop()
        if n.id in seen:
            continue
        seen.add(n.id)
        if n.op == "var":
            names[n.id] = n.params[0]
        stack.extend(n.args)
    return names


def _by_name(out, lanes):
    """decide's (verdicts, hints, envs) with node ids replaced by names."""
    verdicts, hints, envs = out
    names = _var_names(lanes)
    return (
        verdicts,
        [None if h is None else {names[k]: v for k, v in h.items()}
         for h in hints],
        [None if e is None else {names.get(k, k): v
                                 for k, v in e.variables.items()}
         for e in envs],
    )


STAT_FIELDS = ("word_decided_unsat", "word_decided_sat",
               "word_tightened_bits")


def _decide(side, lanes_of, monkeypatch, xp, device="cpu"):
    """One decide on ``side`` under MYTHRIL_TPU_WORD_XP=xp; returns the
    result by name and the word counters."""
    monkeypatch.setenv("MYTHRIL_TPU_WORD_XP", xp)
    if side == "jax":
        T, ctx, tier, stats = JT, jax_context(), JWT.get_word_tier(), \
            jax_bs.dispatch_stats
        kwargs = {}
    else:
        T, ctx, tier, stats = PT, port_context(), PWT.get_word_tier(), \
            port_bs.dispatch_stats
        kwargs = {"device": device}
    lanes = lanes_of(T)
    before = {f: getattr(stats, f) for f in STAT_FIELDS}
    out = tier.decide(ctx, lanes, **kwargs)
    counts = {f: getattr(stats, f) - before[f] for f in STAT_FIELDS}
    return _by_name(out, lanes), counts


SHAPE_NAMES = ("interval_unsat", "known_bits_contradiction", "dead_branch",
               "valid_fold", "pinned_model", "selector_sat",
               "selector_hints", "shared_slot", "unsupported_open",
               "opaque_257", "inverse_chain", "mixed_batch")


@pytest.mark.parametrize("name", SHAPE_NAMES)
def test_decide_shapes_match_jax_for_every_executor(name, monkeypatch):
    want = None
    for side, executors in (("jax", JAX_EXECUTORS),
                            ("port", PORT_EXECUTORS)):
        for label, xp in executors.items():
            for reset in (jax_reset, port_reset, JWT.reset_word_tier,
                          PWT.reset_word_tier):
                reset()
            got = _decide(side, lambda T: _shapes(T)[name], monkeypatch, xp)
            if want is None:
                want = got
            assert got == want, (side, label)
            if side == "port":
                assert PWT.get_word_tier().last_executor == label
    verdicts = want[0][0]
    expected = {
        "interval_unsat": [False], "known_bits_contradiction": [False],
        "dead_branch": [False], "valid_fold": [True],
        "pinned_model": [True], "selector_sat": [True],
        "selector_hints": [None], "shared_slot": [False],
        "unsupported_open": [None],
    }.get(name)
    if expected is not None:
        assert verdicts == expected
    if name == "selector_hints":
        mask, val = want[0][1][0]["y"]
        assert mask >> 224 == 0xFFFFFFFF and val >> 224 == 0xDEADBEEF
    if name == "unsupported_open":
        assert not want[0][1][0]


# ----------------------------------------------------------- random DAGs


#: (seed, lanes, widths): DAGs on which the tier decides lanes UNSAT
#: and SAT and leaves others open with hints
DAG_CASES = [(9, 16, (256, 64, 8)), (7, 16, (8, 16)),
             (9, 64, (256, 64, 8)), (10, 64, (32, 8))]


@pytest.mark.parametrize("seed,n_lanes,widths", DAG_CASES)
def test_random_dags_match_jax_for_every_executor(seed, n_lanes, widths,
                                                  monkeypatch):
    want = None
    for side, executors in (("jax", JAX_EXECUTORS),
                            ("port", PORT_EXECUTORS)):
        for label, xp in executors.items():
            for reset in (jax_reset, port_reset, JWT.reset_word_tier,
                          PWT.reset_word_tier):
                reset()
            got = _decide(side, lambda T: word_dag_lanes(
                seed, n_lanes, widths, terms=T), monkeypatch, xp)
            if want is None:
                want = got
            assert got == want, (side, label)
    (verdicts, hints, _envs), counts = want
    assert False in verdicts and True in verdicts and any(hints)
    assert counts["word_decided_unsat"] == verdicts.count(False)


def test_funnel_picks_the_device_executor_on_the_card_only(monkeypatch):
    """The port's policy (JAX: 16+ lanes on a TPU): 16+ lanes with the
    funnel on ``cuda`` take the device executor, every other batch the
    scalar one."""
    tier = PWT.WordTier()
    assert tier._executor(16, None) == "device"
    assert tier._executor(64, "cuda") == "device"
    assert tier._executor(15, "cuda") == "scalar"
    assert tier._executor(64, "cpu") == "scalar"
    for xp, kind in (("int", "scalar"), ("numpy", "host"), ("host", "host"),
                     ("jnp", "device"), ("jax", "device")):
        monkeypatch.setenv("MYTHRIL_TPU_WORD_XP", xp)
        assert tier._executor(1, "cpu") == kind


# ------------------------------------------------------------ the table


def _jax_planes(prog, lanes, rounds=2):
    """The JAX package's numpy planes for ``lanes`` over ``prog``."""
    tier = JWT.WordTier()
    batch = len(lanes)
    bv = [None] * len(prog.bv_slot)
    tri = [None] * len(prog.bool_slot)
    conflict = np.zeros((batch,), dtype=bool)
    root_mask = {}
    for nodes in lanes:
        for n in nodes:
            root_mask[n.id] = np.array(
                [any(m.id == n.id for m in lane) for lane in lanes])
    conflict = tier._forward(prog, bv, tri, conflict, batch, np)
    for _ in range(rounds):
        conflict = tier._backward(prog, bv, tri, conflict, root_mask,
                                  batch, np)
        conflict = tier._forward(prog, bv, tri, conflict, batch, np)
    planes = np.stack([np.stack([np.asarray(f) for f in word], axis=1)
                       for word in bv], axis=1).astype(np.int64)
    return planes, np.stack([np.asarray(t) for t in tri], axis=1), conflict


@pytest.mark.parametrize("seed,n_lanes,widths", DAG_CASES[:3])
def test_word_fixpoint_plain_equals_the_batched_walk_and_jax(
        seed, n_lanes, widths):
    j_lanes = word_dag_lanes(seed, n_lanes, widths, terms=JT)
    p_lanes = word_dag_lanes(seed, n_lanes, widths, terms=PT)
    j_roots = list({n.id: n for lane in j_lanes for n in lane}.values())
    p_roots = list({n.id: n for lane in p_lanes for n in lane}.values())
    j_prog = JWT._compile(j_roots, JWT.WORD_MAX_NODES)
    p_prog = PWT._compile(p_roots, PWT.WORD_MAX_NODES)
    assert len(p_prog.order) == len(j_prog.order)
    root_mask = {
        n.id: np.array([any(m.id == n.id for m in lane) for lane in p_lanes])
        for n in p_roots}
    table = WF.lower_program(p_prog)
    want0 = np.zeros((table.n_bool, n_lanes), dtype=np.int8)
    for rid, mask in root_mask.items():
        want0[p_prog.bool_slot[rid]] |= mask.astype(np.int8)
    planes, tri, conflict = WF.word_fixpoint(
        table, torch.from_numpy(want0), 2)
    walk = WF._pack(*PWT.WordTier().fixpoint(
        p_prog, root_mask, n_lanes, 2, torch.device("cpu")))
    assert torch.equal(planes, walk[0]) and torch.equal(tri, walk[1])
    assert torch.equal(conflict, walk[2])
    j_planes, j_tri, j_conflict = _jax_planes(j_prog, j_lanes)
    assert np.array_equal(planes.numpy(), j_planes)
    assert np.array_equal(tri.numpy(), j_tri)
    assert np.array_equal(conflict.numpy(), j_conflict)
    # the table round-trips: decoding gives the program's structure
    decoded = WF.decode_table(table)
    assert [(e.op, e.sort, e.width) for e in decoded.order] == [
        (n.op, n.sort, n.width if n.sort == "bv" else 0)
        for n in p_prog.order]
    assert decoded.opaque == {k for k, n in enumerate(p_prog.order)
                              if n.id in p_prog.opaque}


def test_word_fixpoint_refuses_mismatched_inputs():
    lanes = word_dag_lanes(1, 4, terms=PT)
    prog = PWT._compile(
        list({n.id: n for lane in lanes for n in lane}.values()), 1024)
    table = WF.lower_program(prog)
    planes, tri, conflict = WF.word_fixpoint(
        table, torch.zeros((table.n_bool, 4), dtype=torch.int8), 2)
    assert planes.shape == (4, table.n_bv, 4, 8)
    assert tri.shape == (4, table.n_bool) and conflict.shape == (4,)
    assert WF.launch_count == 0  # the CPU never launches the kernel
    assert len(WF.OP_NAMES) == 32 and len(WF.ENTRY_COLUMNS) == 8


# -------------------------------------------------- seams and lifecycle


def test_hint_literals_and_digest_match_jax():
    out = {}
    for side, T, ctx_of, mod in (("jax", JT, jax_context, JWT),
                                 ("port", PT, port_context, PWT)):
        ctx = ctx_of()
        x = T.var("hl", 8)
        ctx.blast_bits(x)
        bits = ctx.var_bits[x.id]
        lits = mod.hint_literals(ctx, {x.id: (0b101, 0b001)})
        assert lits == [bits[0], -bits[2]]
        out[side] = (lits, mod.hint_literals(ctx, None),
                     mod.hint_literals(ctx, {x.id + 10 ** 6: (1, 1)}))
    assert out["port"] == out["jax"]
    for hints in ({3: (0xF0, 0x10), 9: (0x1, 0x1)}, {9: (0x1, 0x1)}, None,
                  {}, {5: ((1 << 256) - 1, 12345)}):
        assert PWT.tightening_digest(hints) == JWT.tightening_digest(hints)
    assert PWT.tightening_digest({3: (0xF0, 0x10), 9: (1, 1)}) == \
        PWT.tightening_digest({9: (1, 1), 3: (0xF0, 0x10)})


def test_cone_memo_keys_on_the_tightening():
    """A memoized untightened cone row never serves a tightened query:
    the known bits are part of the key, on both sides alike."""
    from mythril_tpu.ops.incremental import ConeMemo as JaxMemo
    from mythril_tpu_torch.ops.incremental import ConeMemo as PortMemo

    out = {}
    for side, T, ctx_of, memo in (("jax", JT, jax_context, JaxMemo()),
                                  ("port", PT, port_context, PortMemo())):
        ctx = ctx_of()
        x = T.var("cm", 8)
        lit = ctx.blast_lit(T.eq(x, T.const(3, 8)))
        bit0 = ctx.var_bits[x.id][0]
        plain = memo.cone(ctx, [lit])
        tight = memo.cone(ctx, [lit], known_bits=[bit0])
        again = memo.cone(ctx, [lit], known_bits=[bit0])
        assert len(memo) == 2 and again is tight
        assert set(plain[1].tolist()) <= set(tight[1].tolist())
        direct = ctx.cone([lit], known_bits=[bit0])
        assert np.array_equal(direct[1], tight[1])
        out[side] = (plain[0].tolist(), plain[1].tolist(),
                     tight[0].tolist(), tight[1].tolist())
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("value", ["0", "1"])
def test_kill_switch_both_ways(value, monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", value)
    out = {}
    for side in ("jax", "port"):
        out[side] = _decide(side, lambda T: _shapes(T)["interval_unsat"],
                            monkeypatch, "scalar")
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == ([None] if value == "0" else [False])


def test_generation_scoping_and_reset_resident_pools():
    from mythril_tpu.ops.batched_sat import reset_resident_pools as jax_rrp
    from mythril_tpu_torch.ops.batched_sat import reset_resident_pools

    for T, ctx_of, reset_ctx, mod, rrp in (
        (JT, jax_context, jax_reset, JWT, jax_rrp),
        (PT, port_context, port_reset, PWT, reset_resident_pools),
    ):
        ctx = ctx_of()
        x = T.var("gen", 256)
        nodes = [T.ult(x, T.const(4, 256)), T.ult(T.const(9, 256), x)]
        tier = mod.get_word_tier()
        assert tier.decide(ctx, [nodes])[0][0] is False
        assert len(tier._memo) == 1 and tier._programs
        assert ctx.unsat_memo_hit(tuple(sorted(n.id for n in nodes)))
        reset_ctx()  # a new context: a new generation drops the memo
        tier._sync_generation(ctx_of().generation)
        assert not tier._memo and not tier._programs
        tier.decide(ctx_of(), [[T.ult(x, T.const(3, 256))]])
        assert tier._memo
        rrp()
        assert not tier._memo and not tier._programs
        assert tier._memo_generation == -1


def test_check_uses_hints_without_changing_verdicts():
    """The CDCL tail's word rung: a hint-rich query the tier leaves open
    answers SAT on both sides with the same model."""
    out = {}
    for side, T, ctx_of in (("jax", JT, jax_context),
                            ("port", PT, port_context)):
        ctx = ctx_of()
        x = T.var("ch", 256)
        sel = T.eq(T.lshr(x, T.const(224, 256)), T.const(0xCAFE, 256))
        res = T.eq(T.bv_and(T.mul(x, T.const(3, 256)), T.const(0xFF, 256)),
                   T.const(0x99, 256))
        status, env = ctx.check([sel, res], timeout_s=30.0)
        value = env.variables[x.id]
        assert value >> 224 == 0xCAFE and (value * 3) & 0xFF == 0x99
        dead = ctx.check([T.ult(x, T.const(2, 256)),
                          T.ult(T.const(5, 256), x)])
        out[side] = (status, value, dead)
    assert out["port"] == out["jax"]
    assert out["port"][2] == (-1, None)


def test_bound_of_and_interval_implies_match_jax():
    out = {}
    for side, T, mod in (("jax", JT, JWT), ("port", PT, PWT)):
        x = T.var("ii", 256)
        c5, c10 = T.const(5, 256), T.const(10, 256)
        cases = [
            (T.eq(x, c5), T.ult(x, c10)), (T.ult(x, c10), T.eq(x, c5)),
            (T.ule(c5, x), T.ult(c5, x)), (T.bnot(T.ult(x, c10)),
                                           T.ule(c5, x)),
            (T.eq(x, c5), T.eq(x, c5)), (T.slt(x, c5), T.slt(x, c10)),
        ]
        out[side] = [(mod.interval_implies(a, b),
                      None if mod._bound_of(a) is None
                      else mod._bound_of(a)[1:]) for a, b in cases]
    assert out["port"] == out["jax"]
