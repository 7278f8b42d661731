"""Bit-blasting: term DAG -> CNF over the incremental native SAT solver.

The replacement for z3's internal rewriter+bit-blaster.  One
:class:`BlastContext` owns one native CDCL instance and grows a single
CNF pool for the whole analysis: every DAG node is translated once
(cached by node id), every path-feasibility query is just an assumption
set over already-blasted constraint literals, so learned clauses are
shared across the thousands of queries a contract analysis issues —
the CPU-side mirror of the batched-TPU design (see ops/batched_sat.py).

Theory lowering done here:
- arrays: store chains become mux chains at read sites; reads of a base
  array are Ackermannized (fresh bit variables + congruence clauses);
- uninterpreted functions (keccak modeling): Ackermann expansion over
  all applications of the same function.

Bit order convention: bits[0] is the LSB.  Literal 1 is constant TRUE
(anchored by a unit clause inside the native solver).

Own copy of ``mythril_tpu/smt/bitblast.py`` for the PyTorch port, with
the word tier, autopilot routing, proof logging, observability spans and
fault-injection hooks removed.  What stays behaves as the JAX package's
context does under ``MYTHRIL_TPU_WORD_TIER=0`` and
``MYTHRIL_TPU_AUTOPILOT=0``: the same native calls in the same order, so
the same constraints give the same clause pool.
"""

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mythril_tpu_torch.native import NativePool, SatSolver
from mythril_tpu_torch.smt import terms as T

log = logging.getLogger(__name__)

TRUE_LIT = 1
FALSE_LIT = -1

# probe-memo entry cap (SAT entries pin whole EvalEnvs; see
# probe_with_memo) — the least-recently-USED quarter is evicted when
# full (hits refresh recency, so live frontier entries survive long
# corpus runs).  Env-tunable: MYTHRIL_TPU_PROBE_MEMO_CAP.
PROBE_MEMO_CAP = 16384


def probe_memo_cap() -> int:
    """Effective memo cap: ``MYTHRIL_TPU_PROBE_MEMO_CAP`` when set (a
    soak run analyzing thousands of contracts wants a bigger live
    set; a memory-tight CI wants a smaller one), else the default.
    Floored so the eviction quarter never rounds to zero."""
    from mythril_tpu_torch.support.env import env_int

    return env_int("MYTHRIL_TPU_PROBE_MEMO_CAP", PROBE_MEMO_CAP,
                   floor=64)

# powers of two for vectorized bit packing (64-bit limbs)
_POW2_64 = np.uint64(1) << np.arange(64, dtype=np.uint64)


def pack_lit_words(lits_matrix: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Decode a [rows, bits] literal matrix against a var-indexed truth
    vector (>0 = true) into per-row uint64 limb words [rows, bits/64].

    Encodes the ``bit_of`` contract in one vector pass: literal 1 is
    constant TRUE, -1 constant FALSE, negative literals invert, and
    variables outside ``truth`` read as false.  Pad rows with FALSE_LIT
    (-1); padding decodes to 0 bits.
    """
    a = np.abs(lits_matrix)
    in_range = a < len(truth)
    vals = truth[np.minimum(a, len(truth) - 1)] > 0
    vals &= in_range
    vals |= a == 1  # constant TRUE/FALSE anchor: value true, sign decides
    bits = vals ^ (lits_matrix < 0)
    rows, nbits = bits.shape
    pad = (-nbits) % 64
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((rows, pad), dtype=bool)], axis=1
        )
    return bits.reshape(rows, -1, 64).astype(np.uint64) @ _POW2_64


def words_to_int(words: np.ndarray) -> int:
    value = 0
    for limb_index in range(len(words)):
        value |= int(words[limb_index]) << (64 * limb_index)
    return value


def _truth_bit(lit: int, truth: np.ndarray) -> bool:
    """Scalar ``bit_of``: literal 1/-1 are constants, out-of-range vars
    read false, negative literals invert."""
    if lit == TRUE_LIT:
        return True
    if lit == FALSE_LIT:
        return False
    var = abs(lit)
    value = bool(truth[var] > 0) if var < len(truth) else False
    return value if lit > 0 else not value


def _const_bits(value: int, width: int) -> List[int]:
    return [TRUE_LIT if (value >> i) & 1 else FALSE_LIT for i in range(width)]


_stats_singleton = None


def _solver_stats():
    """Cached SolverStatistics singleton (imported lazily once: the
    solver package imports this module at load, and check() is the
    hottest funnel — per-call import machinery measurably taxed it)."""
    global _stats_singleton
    if _stats_singleton is None:
        from mythril_tpu_torch.smt.solver import SolverStatistics

        _stats_singleton = SolverStatistics()
    return _stats_singleton


_CTX_GENERATION = 0


def next_generation() -> int:
    """Process-unique context id: caches keyed by it (the cone memo)
    can never serve one context's layout to another."""
    global _CTX_GENERATION
    _CTX_GENERATION += 1
    return _CTX_GENERATION


class BlastContext:
    def __init__(self):
        self.generation = next_generation()
        self.solver = SatSolver()
        # the clause pool (CSR store + gate caches + defining-cone index)
        # lives natively — see native/csrc/pool.cpp.  Every clause lands
        # in the CSR store AND the CDCL database in one native call, so
        # there is no host mirror and no flush step any more (round-3
        # profiling: the Python mirror + per-gate dict traffic cost 3x
        # the CDCL search itself on the corpus).
        self.pool = NativePool(self.solver)
        self.bits_cache: Dict[int, List[int]] = {}
        self.lit_cache: Dict[int, int] = {}
        self.var_bits: Dict[int, List[int]] = {}       # bv var node id -> bits
        self.bool_var_lits: Dict[int, int] = {}        # bool var node id -> lit
        self.array_reads: Dict[int, List[Tuple[T.Node, List[int]]]] = {}
        self.uf_apps: Dict[int, List[Tuple[Tuple[T.Node, ...], List[int]]]] = {}
        # recent satisfying assignments: paths grow one branch condition
        # at a time, so the previous model very often still satisfies the
        # extended constraint set — verifying a candidate is a term-DAG
        # walk, orders of magnitude cheaper than a CDCL search
        self.recent_models: List[T.EvalEnv] = []
        self._freevar_cache: Dict[int, frozenset] = {}
        # probe memo: constraint-set key -> EvalEnv (SAT verdicts are
        # permanent) or (False, model_version) (negative probes expire
        # when a new model lands in recent_models); shared by the batch
        # frontier pass and the per-query CDCL tail
        self.probe_memo: Dict[Tuple[int, ...], object] = {}
        # constraint-set key -> True for proven-UNSAT sets; sound
        # because the pool only ever gains definitional clauses, so an
        # assumption set can never turn SAT later (dict for FIFO-order
        # eviction, same cap policy as probe_memo)
        self.unsat_memo: Dict[Tuple[int, ...], bool] = {}
        self.model_version = 0
        # native model snapshot (int8, var-indexed) for the last SAT
        # verdict; lets model extraction run vectorized instead of one
        # ctypes call per bit
        self._model_arr: Optional[np.ndarray] = None
        # var_bits lowered to a padded literal matrix for vectorized
        # model extraction; rebuilt when var_bits grows
        self._var_matrix_cache = None
        # array-read/UF rows lowered likewise (see _reads_matrix), plus
        # a node-id cache for "contains a read/UF" nesting checks
        self._reads_matrix_cache = None
        self._theory_node_cache: Dict[int, bool] = {}

    # ------------------------------------------------------------------
    # pool facade (the store itself is native; see csrc/pool.cpp)
    # ------------------------------------------------------------------

    @property
    def pool_version(self) -> int:
        return self.pool.version

    def cone(self, root_lits: Sequence[int], need_clauses: bool = True):
        """(clause_indices, vars) of the defining cone of ``root_lits``,
        both sorted numpy int64 arrays.

        Walks defining clauses backward from the roots (natively, with a
        per-root memo): every variable's semantics (the gates computing
        it from the query's free inputs) is included; clauses merely
        *consuming* a cone variable for some unrelated constraint are
        not.  Propagation restricted to the cone is sound for UNSAT
        (every pool clause holds globally) and complete enough for model
        probing (free inputs are in the cone).  Device-learned nogoods
        covered by the cone's var set are appended per call."""
        return self.pool.cone(root_lits, need_clauses)

    def note_unsat(self, nodes: Sequence[T.Node]) -> None:
        """Memoize a (sound) UNSAT verdict for a constraint-node set —
        permanent, because the pool only ever gains implied/definitional
        clauses, so an assumption set can never turn SAT later."""
        key = tuple(sorted(n.id for n in nodes))
        cap = probe_memo_cap()
        if len(self.unsat_memo) >= cap:
            # recency order, not insertion order: hits re-insert at the
            # end (see unsat_memo_hit), so this drops the quarter the
            # frontier stopped asking about — long corpus runs keep
            # their live entries
            for stale in list(self.unsat_memo)[: cap // 4]:
                del self.unsat_memo[stale]
        self.unsat_memo[key] = True

    def unsat_memo_hit(self, key) -> bool:
        """Memo lookup that REFRESHES recency on a hit (dict preserves
        insertion order, so re-inserting moves the key to the evict-last
        end).  All memo readers go through here — a key that keeps
        deciding lanes must never be the one evicted."""
        if key in self.unsat_memo:
            del self.unsat_memo[key]
            self.unsat_memo[key] = True
            return True
        return False

    def learn_nogood(self, assumption_lits: Sequence[int]) -> None:
        """Record a device-refuted assumption set as a pool clause.

        If ``pool ∧ a1 ∧ … ∧ ak`` is UNSAT (proved by the device DPLL),
        then ``(¬a1 ∨ … ∨ ¬ak)`` is implied by the pool — adding it
        preserves equisatisfiability and lets both the native CDCL and
        later device dispatches refute related queries without
        re-searching.  The native side dedupes, rejects tautologies and
        wide nogoods, and registers the clause for the cone
        subset-append."""
        self.pool.nogood(list(assumption_lits))

    def new_lit(self) -> int:
        return self.pool.new_var()

    # ------------------------------------------------------------------
    # gates — all emission is native (csrc/pool.cpp): constant folding,
    # structural-sharing caches, and the Tseitin clauses happen behind
    # one ctypes crossing per gate
    # ------------------------------------------------------------------

    def g_and(self, a: int, b: int) -> int:
        return self.pool.g_and(a, b)

    def g_or(self, a: int, b: int) -> int:
        return self.pool.g_or(a, b)

    def g_xor(self, a: int, b: int) -> int:
        return self.pool.g_xor(a, b)

    def g_mux(self, s: int, a: int, b: int) -> int:
        """s ? a : b"""
        return self.pool.g_mux(s, a, b)

    def g_and_many(self, lits: Sequence[int]) -> int:
        """Wide conjunction as ONE gate var: n binary clauses (gate →
        each conjunct) plus one width-(n+1) closing clause.  The wide
        gate keeps cone/implication depth at 1 where a chained-2-AND
        encoding costs depth n.  (The wide closing clause is dropped by
        the gather device path's width cap, which only weakens
        propagation there — soundness holds.)"""
        return self.pool.g_and_many(list(lits))

    def g_or_many(self, lits: Sequence[int]) -> int:
        return -self.pool.g_and_many([-lit for lit in lits])

    def g_xor3(self, a: int, b: int, c: int) -> int:
        """Three-input parity as ONE gate var + 8 width-4 clauses (2
        vars / 14 clauses per adder bit with g_maj, vs 5 vars / ~17
        clauses for chained 2-XOR adders)."""
        return self.pool.g_xor3(a, b, c)

    def g_maj(self, a: int, b: int, c: int) -> int:
        """Three-input majority (the adder carry): one gate var + 6
        clauses."""
        return self.pool.g_maj(a, b, c)

    def full_adder(self, x: int, y: int, cin: int) -> Tuple[int, int]:
        return self.pool.g_xor3(x, y, cin), self.pool.g_maj(x, y, cin)

    # ------------------------------------------------------------------
    # word-level circuits — one native crossing per word op; the ripple
    # chains, multiplier rows, and divider iterations loop in C++
    # ------------------------------------------------------------------

    def add_bits(
        self, xs: List[int], ys: List[int], cin: int = FALSE_LIT
    ) -> Tuple[List[int], int]:
        return self.pool.add_bits(xs, ys, cin)

    def sub_bits(self, xs: List[int], ys: List[int]) -> Tuple[List[int], int]:
        """xs - ys; carry-out == 1 iff xs >= ys (no borrow)."""
        return self.pool.add_bits(xs, [-y for y in ys], TRUE_LIT)

    def neg_bits(self, xs: List[int]) -> List[int]:
        out, _ = self.pool.add_bits(
            [-x for x in xs], _const_bits(0, len(xs)), TRUE_LIT
        )
        return out

    def eq_lit(self, xs: List[int], ys: List[int]) -> int:
        return self.pool.eq_lit(xs, ys)

    def ult_lit(self, xs: List[int], ys: List[int]) -> int:
        # native carry-only comparator: the sum bits of the implied
        # subtraction are never materialized (6 clauses/bit, not 14)
        return self.pool.ult_lit(xs, ys)

    def ule_lit(self, xs: List[int], ys: List[int]) -> int:
        return -self.pool.ult_lit(ys, xs)

    def slt_lit(self, xs: List[int], ys: List[int]) -> int:
        sign_x, sign_y = xs[-1], ys[-1]
        return self.pool.g_mux(
            self.pool.g_xor(sign_x, sign_y), sign_x, self.pool.ult_lit(xs, ys)
        )

    def mux_bits(self, s: int, xs: List[int], ys: List[int]) -> List[int]:
        return self.pool.mux_bits(s, xs, ys)

    def mul_bits(self, xs: List[int], ys: List[int]) -> List[int]:
        return self.pool.mul_bits(xs, ys)

    def udivmod_bits(
        self, xs: List[int], ys: List[int]
    ) -> Tuple[List[int], List[int]]:
        """Restoring division; (quotient, remainder) with SMT-LIB zero
        semantics handled by the caller via a zero-divisor mux."""
        return self.pool.udivmod_bits(xs, ys)

    def shift_bits(self, xs: List[int], ys: List[int], mode: str) -> List[int]:
        """Barrel shifter; mode in {'shl','lshr','ashr'}.  Stays in
        Python: ~log2(width) mux_bits crossings per shift."""
        width = len(xs)
        fill = xs[-1] if mode == "ashr" else FALSE_LIT
        stages = max(1, (width - 1).bit_length())
        acc = list(xs)
        for stage in range(stages):
            amount = 1 << stage
            s = ys[stage] if stage < len(ys) else FALSE_LIT
            if s == FALSE_LIT:
                continue
            if mode == "shl":
                shifted = [FALSE_LIT] * min(amount, width) + acc[: max(0, width - amount)]
            else:
                shifted = acc[amount:] + [fill] * min(amount, width)
            acc = self.pool.mux_bits(s, shifted, acc)
        # any shift-amount bit >= stages forces the overflow fill
        overflow = self.g_or_many(ys[stages:])
        if overflow != FALSE_LIT:
            acc = self.pool.mux_bits(overflow, [fill] * width, acc)
        return acc

    # ------------------------------------------------------------------
    # node -> bits translation
    # ------------------------------------------------------------------

    def blast_bits(self, node: T.Node) -> List[int]:
        cached = self.bits_cache.get(node.id)
        if cached is not None:
            return cached
        bits = self._blast_bits(node)
        assert len(bits) == node.width, (node.op, node.width, len(bits))
        self.bits_cache[node.id] = bits
        return bits

    def _blast_bits(self, n: T.Node) -> List[int]:
        op = n.op
        if op == "const":
            return _const_bits(n.params[0], n.width)
        if op == "var":
            bits = [self.new_lit() for _ in range(n.width)]
            self.var_bits[n.id] = bits
            return bits
        if op == "ite":
            cond = self.blast_lit(n.args[0])
            return self.mux_bits(
                cond, self.blast_bits(n.args[1]), self.blast_bits(n.args[2])
            )
        if op == "select":
            return self._blast_select(n)
        if op == "apply":
            return self._blast_apply(n)

        if op in ("add", "sub", "mul", "udiv", "sdiv", "urem", "srem",
                  "and", "or", "xor", "shl", "lshr", "ashr"):
            xs = self.blast_bits(n.args[0])
            ys = self.blast_bits(n.args[1])
            if op == "add":
                return self.add_bits(xs, ys)[0]
            if op == "sub":
                return self.sub_bits(xs, ys)[0]
            if op == "mul":
                # prefer the operand with fewer symbolic bits as multiplier
                def sym_count(bs):
                    return sum(1 for b in bs if b not in (TRUE_LIT, FALSE_LIT))
                if sym_count(xs) < sym_count(ys):
                    xs, ys = ys, xs
                return self.mul_bits(xs, ys)
            if op == "and":
                return self.pool.map_bits(0, xs, ys)
            if op == "or":
                return self.pool.map_bits(1, xs, ys)
            if op == "xor":
                return self.pool.map_bits(2, xs, ys)
            if op in ("shl", "lshr", "ashr"):
                return self.shift_bits(xs, ys, op)
            if op in ("udiv", "urem"):
                q, r = self.udivmod_bits(xs, ys)
                is_zero = self.eq_lit(ys, _const_bits(0, len(ys)))
                if op == "udiv":  # x/0 = all-ones (SMT-LIB)
                    return self.mux_bits(is_zero, _const_bits((1 << len(xs)) - 1, len(xs)), q)
                return self.mux_bits(is_zero, xs, r)  # x%0 = x
            # signed div/rem via abs / unsigned / sign fixup
            sign_x, sign_y = xs[-1], ys[-1]
            ax = self.mux_bits(sign_x, self.neg_bits(xs), xs)
            ay = self.mux_bits(sign_y, self.neg_bits(ys), ys)
            q, r = self.udivmod_bits(ax, ay)
            is_zero = self.eq_lit(ys, _const_bits(0, len(ys)))
            if op == "sdiv":
                signed_q = self.mux_bits(self.g_xor(sign_x, sign_y), self.neg_bits(q), q)
                # SMT-LIB bvsdiv x/0: 1 if x<0 else -1
                zero_case = self.mux_bits(
                    sign_x,
                    _const_bits(1, len(xs)),
                    _const_bits((1 << len(xs)) - 1, len(xs)),
                )
                return self.mux_bits(is_zero, zero_case, signed_q)
            signed_r = self.mux_bits(sign_x, self.neg_bits(r), r)
            return self.mux_bits(is_zero, xs, signed_r)

        if op == "not":
            return [-b for b in self.blast_bits(n.args[0])]
        if op == "concat":
            bits: List[int] = []
            for part in reversed(n.args):  # last arg is least significant
                bits.extend(self.blast_bits(part))
            return bits
        if op == "extract":
            high, low = n.params
            return self.blast_bits(n.args[0])[low : high + 1]
        if op == "zext":
            return self.blast_bits(n.args[0]) + [FALSE_LIT] * n.params[0]
        if op == "sext":
            inner = self.blast_bits(n.args[0])
            return inner + [inner[-1]] * n.params[0]
        raise NotImplementedError(f"blast_bits: {op}")

    def _blast_select(self, n: T.Node) -> List[int]:
        arr, idx = n.args
        idx_bits = self.blast_bits(idx)
        # collect the store chain (outermost first)
        chain: List[Tuple[T.Node, T.Node]] = []
        base = arr
        while base.op == "store":
            chain.append((base.args[1], base.args[2]))
            base = base.args[0]
        if base.op == "constarr":
            result = self.blast_bits(base.args[0])
        elif base.op == "avar":
            result = self._base_array_read(base, idx, idx_bits)
        else:
            raise NotImplementedError(f"select base {base.op}")
        for sidx, sval in reversed(chain):
            hit = self.eq_lit(idx_bits, self.blast_bits(sidx))
            result = self.mux_bits(hit, self.blast_bits(sval), result)
        return result

    def _base_array_read(
        self, base: T.Node, idx: T.Node, idx_bits: List[int]
    ) -> List[int]:
        reads = self.array_reads.setdefault(base.id, [])
        for prev_idx, prev_bits in reads:
            if prev_idx is idx:
                return prev_bits
        rng = base.params[2]
        bits = [self.new_lit() for _ in range(rng)]
        for prev_idx, prev_bits in reads:
            same = self.eq_lit(idx_bits, self.blast_bits(prev_idx))
            self.pool.congruence(same, bits, prev_bits)
        reads.append((idx, bits))
        return bits

    def _blast_apply(self, n: T.Node) -> List[int]:
        func = n.args[0]
        args = n.args[1:]
        apps = self.uf_apps.setdefault(func.id, [])
        for prev_args, prev_bits in apps:
            if all(a is b for a, b in zip(prev_args, args)):
                return prev_bits
        ret_width = func.params[2]
        bits = [self.new_lit() for _ in range(ret_width)]
        arg_bits = [self.blast_bits(a) for a in args]
        for prev_args, prev_bits in apps:
            same = self.g_and_many(
                [
                    self.eq_lit(ab, self.blast_bits(pa))
                    for ab, pa in zip(arg_bits, prev_args)
                ]
            )
            self.pool.congruence(same, bits, prev_bits)
        apps.append((args, bits))
        return bits

    # ------------------------------------------------------------------
    # bool nodes -> single literal
    # ------------------------------------------------------------------

    def blast_lit(self, node: T.Node) -> int:
        cached = self.lit_cache.get(node.id)
        if cached is not None:
            return cached
        lit = self._blast_lit(node)
        self.lit_cache[node.id] = lit
        return lit

    def _blast_lit(self, n: T.Node) -> int:
        op = n.op
        if op == "bconst":
            return TRUE_LIT if n.params[0] else FALSE_LIT
        if op == "bvar":
            lit = self.new_lit()
            self.bool_var_lits[n.id] = lit
            return lit
        if op == "band":
            return self.g_and(self.blast_lit(n.args[0]), self.blast_lit(n.args[1]))
        if op == "bor":
            return self.g_or(self.blast_lit(n.args[0]), self.blast_lit(n.args[1]))
        if op == "bnot":
            return -self.blast_lit(n.args[0])
        if op == "bxor":
            return self.g_xor(self.blast_lit(n.args[0]), self.blast_lit(n.args[1]))
        if op == "eq":
            return self.eq_lit(self.blast_bits(n.args[0]), self.blast_bits(n.args[1]))
        if op == "ult":
            return self.ult_lit(self.blast_bits(n.args[0]), self.blast_bits(n.args[1]))
        if op == "ule":
            return self.ule_lit(self.blast_bits(n.args[0]), self.blast_bits(n.args[1]))
        if op == "slt":
            return self.slt_lit(self.blast_bits(n.args[0]), self.blast_bits(n.args[1]))
        if op == "sle":
            return -self.slt_lit(
                self.blast_bits(n.args[1]), self.blast_bits(n.args[0])
            )
        if op == "ite":  # bool-sorted ite
            cond = self.blast_lit(n.args[0])
            return self.g_mux(
                cond, self.blast_lit(n.args[1]), self.blast_lit(n.args[2])
            )
        raise NotImplementedError(f"blast_lit: {op}")

    # ------------------------------------------------------------------
    # solving + model extraction
    # ------------------------------------------------------------------

    def check(
        self,
        constraints: Sequence[T.Node],
        timeout_s: float = 0.0,
        conflict_budget: int = -1,
    ) -> Tuple[int, Optional[T.EvalEnv]]:
        """Returns (status, env) with status in SatSolver.{SAT,UNSAT,UNKNOWN}."""
        nodes = []
        for c in constraints:
            if c is T.FALSE:
                return SatSolver.UNSAT, None
            if c is T.TRUE:
                continue
            nodes.append(c)
        key = tuple(sorted(n.id for n in nodes))
        if self.unsat_memo_hit(key):
            return SatSolver.UNSAT, None
        from mythril_tpu_torch.support.support_args import args as _args

        stats = _solver_stats()
        if getattr(_args, "word_probing", True):
            started = time.perf_counter()
            env = self.probe_with_memo(nodes)
            stats.probe_s += time.perf_counter() - started
            if env is not None:
                return SatSolver.SAT, env
        started = time.perf_counter()
        assumptions = [self.blast_lit(c) for c in nodes]
        stats.blast_s += time.perf_counter() - started
        # restrict CDCL decisions to the query's cone: against a large
        # shared pool, VSIDS otherwise wanders into foreign gates and
        # pays full-pool propagation per irrelevant decision
        started = time.perf_counter()
        if getattr(_args, "cone_decisions", True):
            self.pool.relevant_cone(assumptions)
        else:
            # a stale restriction from an earlier query would be unsound
            self.solver.set_relevant([])
        stats.cone_s += time.perf_counter() - started
        started = time.perf_counter()
        status = self.solver.solve(assumptions, conflict_budget, timeout_s)
        stats.native_s += time.perf_counter() - started
        stats.native_calls += 1
        if status != SatSolver.SAT:
            if status == SatSolver.UNSAT:
                # permanent memo: frontier rounds repeat constraint sets
                # and this skips their re-probe and re-solve
                self.note_unsat(nodes)
            return status, None
        env = self._extract_model()
        # tag with the native truth snapshot: CDCL-tail models are the
        # primary warm-start seed for sibling device lanes
        self._remember_model(env, truth=self._model_arr)
        return status, env

    # ------------------------------------------------------------------
    # word-level candidate probing (pre-CDCL fast path)
    # ------------------------------------------------------------------

    def _free_vars(self, node: T.Node) -> frozenset:
        """Free var/bvar nodes of a DAG, cached by node id."""
        cached = self._freevar_cache.get(node.id)
        if cached is not None:
            return cached
        out = set()
        stack = [node]
        seen = set()
        while stack:
            n = stack.pop()
            if n.id in seen:
                continue
            seen.add(n.id)
            hit = self._freevar_cache.get(n.id)
            if hit is not None:
                out |= hit
                continue
            if n.op in ("var", "bvar"):
                out.add(n)
            stack.extend(n.args)
        result = frozenset(out)
        self._freevar_cache[node.id] = result
        return result

    @staticmethod
    def _equality_hints(nodes: Sequence[T.Node]) -> Dict[int, int]:
        """var node id -> candidate value from constraint structure:

        - top-level ``var == const`` conjuncts (function selectors,
          fixed callvalues, storage keys);
        - disjunctions whose arms pin a var: pick the first arm's value
          (the dominant shape is ``caller == CREATOR || caller ==
          ATTACKER || ...`` — under the plain zero candidate such an Or
          evaluates false and the probe misses for no reason);
        - one-sided bounds ``ULE(var, c)`` / ``ULE(c, var)``: the
          boundary value itself.

        Hints are guesses, not facts — every candidate model is fully
        verified by evaluation before being trusted."""
        hints: Dict[int, int] = {}
        work = list(nodes)
        while work:
            n = work.pop()
            if n.op == "band":
                work.extend(n.args)
                continue
            if n.op == "bvar":
                hints[n.id] = True
                continue
            if n.op == "bnot" and n.args[0].op == "bvar":
                hints[n.args[0].id] = False
                continue
            if n.op == "eq":
                a, b = n.args
                if a.op == "var" and b.op == "const":
                    hints.setdefault(a.id, b.params[0])
                elif b.op == "var" and a.op == "const":
                    hints.setdefault(b.id, a.params[0])
            elif n.op == "bor":
                # satisfy the disjunction through its first pinnable arm
                arms = list(n.args)
                while arms:
                    arm = arms.pop(0)
                    if arm.op == "bor":
                        arms = list(arm.args) + arms
                        continue
                    if arm.op == "eq":
                        a, b = arm.args
                        if a.op == "var" and b.op == "const":
                            hints.setdefault(a.id, b.params[0])
                            break
                        if b.op == "var" and a.op == "const":
                            hints.setdefault(b.id, a.params[0])
                            break
            elif n.op in ("ule", "ult"):
                a, b = n.args
                if a.op == "var" and b.op == "const":
                    bound = b.params[0] - (1 if n.op == "ult" else 0)
                    if bound >= 0:
                        hints.setdefault(a.id, bound)
                elif b.op == "var" and a.op == "const":
                    bound = a.params[0] + (1 if n.op == "ult" else 0)
                    hints.setdefault(b.id, bound)
        return hints

    @staticmethod
    def _push_target(x: T.Node, value: int, var_hints, cell_hints) -> None:
        """Backward-propagate the guess ``x == value`` through invertible
        structure into variable / array-cell hints.  This cracks the
        dominant probe-resistant shape — function-selector equations
        ``const == (concat(calldata[0..3]...) >> 224) & 0xffffffff`` —
        by writing the selector bytes into the calldata cells.  Hints
        are guesses only; candidates are verified by evaluation."""
        while True:
            op = x.op
            if op == "var":
                var_hints.setdefault(x.id, value)
                return
            if op == "select":
                base, idx = x.args
                if base.op == "avar" and idx.is_const:
                    cell_hints.setdefault(base.id, {}).setdefault(
                        idx.params[0], value
                    )
                return
            if op == "ite":
                # ite(cond, select(...), 0): aim for the then-branch
                x = x.args[1]
                continue
            if op == "and" and len(x.args) == 2:  # bitvector mask
                a, b = x.args
                if a.is_const and value & ~a.params[0] == 0:
                    x = b
                    continue
                if b.is_const and value & ~b.params[0] == 0:
                    x = a
                    continue
                return
            if op == "lshr" and x.args[1].is_const:
                shifted = value << x.args[1].params[0]
                if shifted >> x.width:
                    return
                x, value = x.args[0], shifted
                continue
            if op == "shl" and x.args[1].is_const:
                shift = x.args[1].params[0]
                if value & ((1 << shift) - 1):
                    return
                x, value = x.args[0], value >> shift
                continue
            if op in ("zext", "sext"):
                x = x.args[0]
                value &= T.mask(x.width)
                continue
            if op == "extract":
                high, low = x.params
                x, value = x.args[0], value << low
                continue
            if op == "concat":
                # first arg holds the highest bits
                remaining = sum(a.width for a in x.args)
                for part in x.args:
                    remaining -= part.width
                    BlastContext._push_target(
                        part,
                        (value >> remaining) & T.mask(part.width),
                        var_hints,
                        cell_hints,
                    )
                return
            return

    def _structure_hints(self, nodes: Sequence[T.Node]):
        """(var_hints, cell_hints) from ``const == X`` top-level
        conjuncts whose X decomposes bytewise."""
        var_hints: Dict[int, int] = {}
        cell_hints: Dict[int, Dict[int, int]] = {}
        work = list(nodes)
        while work:
            n = work.pop()
            if n.op == "band":
                work.extend(n.args)
            elif n.op == "eq":
                a, b = n.args
                if a.is_const and not b.is_const:
                    self._push_target(b, a.params[0], var_hints, cell_hints)
                elif b.is_const and not a.is_const:
                    self._push_target(a, b.params[0], var_hints, cell_hints)
        return var_hints, cell_hints

    def probe_with_memo(self, nodes: Sequence[T.Node]) -> Optional[T.EvalEnv]:
        """_probe_candidates behind the shared memo: SAT hits are
        permanent, failures expire when a new model lands.  Both the
        frontier batch pass and the per-query CDCL tail go through here
        so an undecided lane is probed once per round, not twice."""
        key = tuple(sorted(n.id for n in nodes))
        memo = self.probe_memo.get(key)
        if isinstance(memo, T.EvalEnv):
            # SAT is a permanent property of the set; refresh LRU order
            # so the hot frontier entries survive eviction
            self.probe_memo.pop(key)
            self.probe_memo[key] = memo
            return memo
        if memo is not None and memo[1] == self.model_version:
            # known-failed against the current model set: refresh the
            # entry's recency — a set the frontier keeps re-asking is
            # exactly the one whose negative verdict must stay cached
            del self.probe_memo[key]
            self.probe_memo[key] = memo
            return None
        env = self._probe_candidates(nodes)
        if key in self.probe_memo:
            del self.probe_memo[key]  # re-write moves the key to the end
        elif len(self.probe_memo) >= probe_memo_cap():
            # bounded: deep analyses generate an unbounded stream of
            # unique constraint-set keys, and SAT entries pin whole
            # EvalEnvs — evict least-recently-used (dict preserves
            # insertion order; hits/re-writes reinsert at the end)
            cap = probe_memo_cap()
            for stale_key in list(self.probe_memo)[: cap // 4]:
                del self.probe_memo[stale_key]
        self.probe_memo[key] = (
            env if env is not None else (False, self.model_version)
        )
        return env

    def _probe_candidates(
        self, nodes: Sequence[T.Node]
    ) -> Optional[T.EvalEnv]:
        """Try a handful of cheap structured assignments before paying
        for a CDCL search.  Any env for which every constraint evaluates
        to True is a genuine model (evaluation is total: missing
        variables/array cells/UF values default to 0)."""
        if not nodes:
            return T.EvalEnv()
        free: set = set()
        for n in nodes:
            free |= self._free_vars(n)
        hints = self._equality_hints(nodes)
        struct_vars, cell_hints = self._structure_hints(nodes)
        for var_id, value in struct_vars.items():
            hints.setdefault(var_id, value)
        bv = [n for n in free if n.op == "var"]

        def filled(base: Dict[int, int], fill) -> Dict[int, int]:
            out = dict(hints)
            out.update(base)
            for n in bv:
                if n.id not in out:
                    out[n.id] = fill(n)
            return out

        def cells() -> Dict[int, Dict[int, int]]:
            return {k: dict(v) for k, v in cell_hints.items()}

        candidates: List[T.EvalEnv] = [
            T.EvalEnv(variables=dict(hints), arrays=cells()),  # + zeros
            T.EvalEnv(
                variables=filled({}, lambda n: T.mask(n.width)),
                arrays=cells(),
            ),
            # hints + zero vars, but unwritten array cells read 0xFF:
            # satisfies "large word" constraints over symbolic calldata
            # (overflow conditions) while selector cells stay pinned
            T.EvalEnv(
                variables=dict(hints), arrays=cells(), array_default=0xFF
            ),
            T.EvalEnv(
                variables=filled({}, lambda n: 1 << (n.width - 1)),
                arrays=cells(),
            ),
        ]
        # screen the RAW recent models first with their persistent
        # per-env memos: a stored model is frozen, so each (model, node)
        # pair evaluates once EVER — queries share their path prefix, so
        # re-probing a grown constraint set only walks the new
        # constraint's subtree.  Hint-merged variants (below) get fresh
        # envs per query and cannot share memos.
        for env in self.recent_models:
            memo = getattr(env, "persistent_memo", None)
            if memo is None or len(memo) > (1 << 18):
                # bounded like every other cache here: a long-lived env
                # would otherwise accumulate one entry per interned
                # node ever screened against it
                memo = {}
                env.persistent_memo = memo
            try:
                if all(T.evaluate(n, env, memo) is True for n in nodes):
                    self._remember_model(env)
                    return env
            except Exception:  # noqa: BLE001 — probe failure is normal
                continue

        for env in self.recent_models:
            merged = dict(env.variables)
            merged.update(hints)
            arrays = {k: dict(v) for k, v in env.arrays.items()}
            for base_id, table in cell_hints.items():
                arrays.setdefault(base_id, {}).update(table)
            candidates.append(
                T.EvalEnv(
                    variables=merged,
                    arrays=arrays,
                    ufs=dict(env.ufs),
                )
            )
        for index, env in enumerate(candidates):
            cache: Dict[int, object] = {}
            try:
                if all(
                    T.evaluate(n, env, cache) is True for n in nodes
                ):
                    self._remember_model(env)
                    return env
            except Exception:  # noqa: BLE001 — probe failure is normal
                continue
            if index in (0, 4):  # zeros env + newest recent model
                repaired = self._repair(nodes, env)
                if repaired is not None:
                    self._remember_model(repaired)
                    return repaired
        return None

    # -- word-level local repair ---------------------------------------

    def _repair(
        self, nodes: Sequence[T.Node], env: T.EvalEnv, rounds: int = 3
    ) -> Optional[T.EvalEnv]:
        """Bounded local search: evaluate the candidate, and for each
        falsified constraint push concretely-known values across
        equalities into free variables / array cells of the other side
        (e.g. ``sender == owner_storage_slot`` repairs by writing the
        sender's value into the storage cell).  Sound by construction —
        the final env is only returned after full re-verification."""
        env = T.EvalEnv(
            variables=dict(env.variables),
            arrays={k: dict(v) for k, v in env.arrays.items()},
            ufs=dict(env.ufs),
        )
        for _ in range(rounds):
            cache: Dict[int, object] = {}
            try:
                failed = [
                    n for n in nodes if T.evaluate(n, env, cache) is not True
                ]
            except Exception:  # noqa: BLE001
                return None
            if not failed:
                return env
            progressed = False
            for n in failed:
                try:
                    progressed |= self._repair_one(n, env, cache, True)
                except Exception:  # noqa: BLE001
                    continue
            if not progressed:
                return None
        return None

    def _repair_one(
        self, n: T.Node, env: T.EvalEnv, cache, want: bool
    ) -> bool:
        """Try one structural adjustment making ``n`` evaluate ``want``;
        returns True if the env was changed."""
        op = n.op
        if op == "bnot":
            return self._repair_one(n.args[0], env, cache, not want)
        if op == "band" and want:
            changed = False
            for arm in n.args:
                if T.evaluate(arm, env, dict(cache)) is not True:
                    changed |= self._repair_one(arm, env, cache, True)
            return changed
        if op == "bor" and want:
            return self._repair_one(n.args[0], env, cache, True)
        if op == "eq":
            a, b = n.args
            va = T.evaluate(a, env, dict(cache))
            vb = T.evaluate(b, env, dict(cache))
            if want:
                if va == vb:
                    return False
                # bool-encoding bridge: const == ite(cond, c1, c0)
                for const_side, other in ((a, b), (b, a)):
                    if (
                        const_side.is_const
                        and other.op == "ite"
                        and other.args[1].is_const
                        and other.args[2].is_const
                    ):
                        target = const_side.params[0]
                        if other.args[1].params[0] == target:
                            return self._repair_one(
                                other.args[0], env, cache, True
                            )
                        if other.args[2].params[0] == target:
                            return self._repair_one(
                                other.args[0], env, cache, False
                            )
                # push the concretely-evaluated side into the other
                var_hints: Dict[int, int] = {}
                cell_hints: Dict[int, Dict[int, int]] = {}
                self._push_target(b, va, var_hints, cell_hints)
                if not var_hints and not cell_hints:
                    self._push_target(a, vb, var_hints, cell_hints)
                return self._apply_hints(env, var_hints, cell_hints)
            # want a disequality: nudge a directly-free side
            if va != vb:
                return False
            for side, other_val in ((a, vb), (b, va)):
                bump = (other_val + 1) & T.mask(side.width or 256)
                if side.op == "var":
                    env.variables[side.id] = bump
                    return True
                if (
                    side.op == "select"
                    and side.args[0].op == "avar"
                    and side.args[1].is_const
                ):
                    env.arrays.setdefault(side.args[0].id, {})[
                        side.args[1].params[0]
                    ] = bump
                    return True
            return False
        if op in ("ule", "ult") and want:
            a, b = n.args
            va = T.evaluate(a, env, dict(cache))
            var_hints, cell_hints = {}, {}
            # raise the upper side to meet the lower one
            self._push_target(
                b, min(va + (1 if op == "ult" else 0), T.mask(b.width)),
                var_hints, cell_hints,
            )
            if not var_hints and not cell_hints:
                # or lower the bounded side to zero
                self._push_target(a, 0, var_hints, cell_hints)
            return self._apply_hints(env, var_hints, cell_hints)
        if op == "ite":
            return self._repair_one(n.args[0], env, cache, want)
        return False

    @staticmethod
    def _apply_hints(env: T.EvalEnv, var_hints, cell_hints) -> bool:
        changed = False
        for var_id, value in var_hints.items():
            if env.variables.get(var_id) != value:
                env.variables[var_id] = value
                changed = True
        for base_id, table in cell_hints.items():
            cells = env.arrays.setdefault(base_id, {})
            for idx, value in table.items():
                if cells.get(idx) != value:
                    cells[idx] = value
                    changed = True
        return changed

    def _remember_model(
        self, env: T.EvalEnv, keep: int = 6, truth=None
    ) -> None:
        """Insert a verified model at the front of the recent-models
        channel.  ``truth`` (a var-indexed int8 assignment row — the
        native model snapshot or a host-verified device lane) tags the
        env for the warm-start plane: the newest tagged model seeds
        sibling lanes' decision phases (see :meth:`warm_phase_vector`).
        Word-level probe models carry no literal truth and stay
        untagged — they still serve the probe, just not warm starts."""
        if truth is not None:
            env.truth_snapshot = np.asarray(truth, dtype=np.int8)
        for index, known in enumerate(self.recent_models):
            if known is env:
                # re-hit of a stored model: move to front WITHOUT a
                # version bump — nothing new landed, so negative probe
                # memos stay valid and the list keeps its diversity
                if index:
                    del self.recent_models[index]
                    self.recent_models.insert(0, env)
                return
        self.recent_models.insert(0, env)
        del self.recent_models[keep:]
        self.model_version += 1  # expires negative batch-probe memos

    def warm_phase_vector(self, num_vars: int):
        """Decision-phase seed ``[num_vars + 1]`` int8 from the newest
        recent model that carries a literal-level truth snapshot, or
        None when no tagged model exists.

        Recency approximates tree proximity: paths fork one branch
        condition at a time, so the most recently remembered SAT model
        is almost always an ancestor or sibling of the lanes about to
        dispatch, and its phases satisfy their shared constraint
        prefix (phase saving across the fork tree).  The vector only
        biases which polarity a device decision tries first — it never
        pre-assigns anything, so UNSAT/SAT semantics are untouched."""
        for env in self.recent_models:
            truth = getattr(env, "truth_snapshot", None)
            if truth is None:
                continue
            out = np.zeros(num_vars + 1, dtype=np.int8)
            n = min(len(truth), num_vars + 1)
            out[:n] = np.sign(truth[:n]).astype(np.int8)
            out[0] = 0
            out[1] = 1  # constant-TRUE anchor
            return out
        return None

    def _var_matrix(self):
        """var_bits as (node_ids, FALSE_LIT-padded literal matrix);
        rebuilt only when var_bits has grown."""
        cached = self._var_matrix_cache
        if cached is not None and cached[0] == len(self.var_bits):
            return cached[1], cached[2]
        ids = list(self.var_bits.keys())
        width = max((len(b) for b in self.var_bits.values()), default=1)
        mat = np.full((len(ids), width), FALSE_LIT, dtype=np.int64)
        for row, node_id in enumerate(ids):
            bits = self.var_bits[node_id]
            mat[row, : len(bits)] = bits
        self._var_matrix_cache = (len(ids), ids, mat)
        return ids, mat

    def _reads_matrix(self):
        """Array reads + UF apps lowered to one padded literal matrix:
        (entries, matrix, rounds) where entries[i] describes matrix row
        i as ("read", base_id, idx_node) or ("app", func_id, args), and
        rounds is 1 when no index/arg expression nests another read or
        UF (the common case) else 3.  Rebuilt when registrations grow."""
        count = sum(len(r) for r in self.array_reads.values()) + sum(
            len(a) for a in self.uf_apps.values()
        )
        cached = getattr(self, "_reads_matrix_cache", None)
        if cached is not None and cached[0] == count:
            return cached[1], cached[2], cached[3]
        entries = []
        rows = []
        nested = False
        for base_id, reads in self.array_reads.items():
            for idx_node, bits in reads:
                entries.append(("read", base_id, idx_node))
                rows.append(bits)
                nested = nested or self._has_theory_node(idx_node)
        for func_id, apps in self.uf_apps.items():
            for args, bits in apps:
                entries.append(("app", func_id, args))
                rows.append(bits)
                nested = nested or any(
                    self._has_theory_node(a) for a in args
                )
        width = max((len(b) for b in rows), default=1)
        mat = np.full((len(rows), width), FALSE_LIT, dtype=np.int64)
        for row_index, bits in enumerate(rows):
            mat[row_index, : len(bits)] = bits
        rounds = 3 if nested else 1
        self._reads_matrix_cache = (count, entries, mat, rounds)
        return entries, mat, rounds

    def _has_theory_node(self, node: T.Node) -> bool:
        """True when the DAG under ``node`` contains an array read or a
        UF application (their valuation depends on the env tables, so
        dependents need extra fixed-point rounds).  Cached by node id."""
        cache = self._theory_node_cache
        hit = cache.get(node.id)
        if hit is not None:
            return hit
        stack = [node]
        seen = set()
        found = False
        while stack and not found:
            n = stack.pop()
            if n.id in seen:
                continue
            seen.add(n.id)
            sub = cache.get(n.id)
            if sub is not None:
                found = found or sub
                continue
            if n.op in ("select", "apply"):
                found = True
                break
            stack.extend(n.args)
        cache[node.id] = found
        return found

    def extract_env(self, truth: np.ndarray) -> T.EvalEnv:
        """EvalEnv from any var-indexed truth vector (>0 = true): the
        native model snapshot or a device assignment row.  Word
        variables and all read/UF result words decode in one vectorized
        pass each; the remaining per-entry work is only evaluating the
        index/arg expressions, iterated to a fixed point when those
        expressions nest other reads."""
        env = T.EvalEnv()
        ids, mat = self._var_matrix()
        if ids:
            words = pack_lit_words(mat, truth)
            for row, node_id in enumerate(ids):
                env.variables[node_id] = words_to_int(words[row])
        for node_id, lit in self.bool_var_lits.items():
            env.variables[node_id] = _truth_bit(lit, truth)
        entries, reads_mat, rounds = self._reads_matrix()
        if not entries:
            return env
        read_words = pack_lit_words(reads_mat, truth)
        values = [words_to_int(read_words[i]) for i in range(len(entries))]
        for _ in range(rounds):
            for (kind, owner_id, key_node), value in zip(entries, values):
                if kind == "read":
                    table = env.arrays.setdefault(owner_id, {})
                    table[T.evaluate(key_node, env)] = value
                else:
                    arg_vals = tuple(
                        T.evaluate(a, env) for a in key_node
                    )
                    env.ufs[(owner_id, arg_vals)] = value
        return env

    def _extract_model(self) -> T.EvalEnv:
        self._model_arr = self.solver.model_array()
        return self.extract_env(self._model_arr)
