"""The PyTorch port's copy of the SMT layer against the JAX package's.

Every later comparison between the two packages rests on this: the same
term recipe, blasted by both packages in the same order, must give the
same clause pool (``csr()`` arrays and ``num_vars``), the same defining
cones, and the same CDCL verdicts.  All comparisons are exact.
"""

import numpy as np
import pytest

import mythril_tpu.smt as JS
import mythril_tpu_torch.smt as PS
from mythril_tpu.smt.solver import get_blast_context as jax_context
from mythril_tpu.smt.solver import reset_blast_context as jax_reset
from mythril_tpu_torch import frontiers
from mythril_tpu_torch.native import SatSolver
from mythril_tpu_torch.smt.solver import get_blast_context as port_context
from mythril_tpu_torch.smt.solver import reset_blast_context as port_reset


@pytest.fixture(autouse=True)
def fresh_contexts(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", "0")
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT", "0")
    jax_reset()
    port_reset()
    yield
    jax_reset()
    port_reset()


def _mixed_recipe(S):
    """A few lanes over the blaster's whole fragment: arithmetic,
    division, shifts, comparisons, ite, extract/concat, arrays."""
    bv = S.symbol_factory.BitVecVal
    x = S.symbol_factory.BitVecSym("x", 16)
    y = S.symbol_factory.BitVecSym("y", 16)
    store = S.Array("store", 16, 16)
    store[x] = y + bv(3, 16)
    flag = S.symbol_factory.BoolSym("flag")
    return [
        [x * bv(7, 16) == bv(21, 16)],
        [S.ULT(x, bv(5, 16)), S.UGT(x, bv(10, 16))],
        [S.UDiv(x, y) == bv(3, 16), S.URem(x, y) == bv(1, 16)],
        [(x << bv(2, 16)) ^ S.LShR(y, bv(1, 16)) == bv(0x55, 16)],
        [S.Extract(7, 0, x) == bv(0x12, 8),
         S.Concat(S.Extract(3, 0, y), S.Extract(11, 0, x)) == bv(0xA012, 16)],
        [store[x] == bv(9, 16), S.If(flag, x, y) == bv(6, 16)],
        [S.SRem(x, y) == bv(0xFFFF, 16), x < y],
    ]


RECIPES = {
    "mixed": _mixed_recipe,
    "scale_mul": lambda S: frontiers.scale_mul_frontier(
        3, 8, smt=S, calldata="words")[0],
    "scale_mul_array": lambda S: frontiers.scale_mul_frontier(
        2, 8, smt=S)[0],
    "guard_chain": lambda S: frontiers.guard_chain_frontier(
        8, 8, 2, smt=S, calldata="words")[0],
}


def _blast(S, context, recipe):
    ctx = context()
    lanes = RECIPES[recipe](S)
    sets = [[ctx.blast_lit(c.raw) for c in lane] for lane in lanes]
    return ctx, lanes, sets


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_blast_gives_the_same_pool(recipe):
    jctx, _, jsets = _blast(JS, jax_context, recipe)
    pctx, _, psets = _blast(PS, port_context, recipe)
    assert jsets == psets
    assert jctx.solver.num_vars == pctx.solver.num_vars
    jl, ji = jctx.pool.csr()
    pl, pi = pctx.pool.csr()
    assert np.array_equal(jl, pl) and np.array_equal(ji, pi)
    for lits in jsets:
        jc, jv = jctx.cone(lits)
        pc, pv = pctx.cone(lits)
        assert np.array_equal(jc, pc) and np.array_equal(jv, pv)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_cdcl_verdicts_agree(recipe):
    jctx, jlanes, _ = _blast(JS, jax_context, recipe)
    pctx, planes, _ = _blast(PS, port_context, recipe)
    for jlane, plane in zip(jlanes, planes):
        jstatus, _ = jctx.check([c.raw for c in jlane])
        pstatus, env = pctx.check([c.raw for c in plane])
        assert jstatus == pstatus
        if pstatus == SatSolver.SAT:
            assert all(
                PS.terms.evaluate(c.raw, env) is True for c in plane
            )


def test_expected_verdicts_of_the_frontiers():
    """The frontier builders' known verdicts hold under the port's CDCL."""
    for build in (
        lambda: frontiers.scale_mul_frontier(3, 8, calldata="words"),
        lambda: frontiers.guard_chain_frontier(8, 8, 2, calldata="words"),
    ):
        port_reset()
        ctx = port_context()
        lanes, expected = build()
        got = [ctx.check([c.raw for c in lane])[0] == SatSolver.SAT
               for lane in lanes]
        assert got == expected
