"""Solver facade (own copy of the parts of ``mythril_tpu/smt/solver``
this slice uses): the shared blast context, the query statistics, and
the per-query :class:`Solver` the CDCL tail answers through.

Every Solver shares one process-wide :class:`BlastContext`, i.e. a
single incremental native CDCL instance holding the CNF pool; a
``check`` is an assumption query against that pool.  A whole frontier
goes through ``ops/batched_sat.batch_check_states`` instead, which
dispatches the dense tier before falling back to per-query checks here.
``Optimize`` implements minimize/maximize by SAT-guided binary search
over ULE bounds (``support/model.py`` minimizes call values with it).
"""

import logging
import time
from functools import wraps
from typing import List, Optional, Sequence

from mythril_tpu_torch.native import SatSolver
from mythril_tpu_torch.smt import terms as T
from mythril_tpu_torch.smt.bitblast import BlastContext
from mythril_tpu_torch.smt.model import Model

log = logging.getLogger(__name__)

class CheckResult:
    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name


sat = CheckResult("sat")
unsat = CheckResult("unsat")
unknown = CheckResult("unknown")


class SolverStatistics:
    """Process-wide query counter/timer singleton."""

    _instance: Optional["SolverStatistics"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.enabled = False
            cls._instance.reset()
        return cls._instance

    def reset(self) -> None:
        self.query_count = 0
        self.solver_time = 0.0
        # wall-clock split of the CDCL-tail funnel (BlastContext.check):
        # word-probe evaluation, bit-blasting, cone restriction, native
        # CDCL
        self.probe_s = 0.0
        self.blast_s = 0.0
        self.cone_s = 0.0
        self.native_s = 0.0
        self.native_calls = 0

    def split(self) -> dict:
        return {
            "probe_s": round(self.probe_s, 2),
            "blast_s": round(self.blast_s, 2),
            "cone_s": round(self.cone_s, 2),
            "native_s": round(self.native_s, 2),
        }

    def __repr__(self) -> str:
        return (
            f"Solver statistics: query count: {self.query_count}, "
            f"solver time: {self.solver_time}"
        )


def stat_smt_query(func):
    """Times a solver query when statistics collection is enabled."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        stats = SolverStatistics()
        if not stats.enabled:
            return func(*args, **kwargs)
        stats.query_count += 1
        begin = time.time()
        try:
            return func(*args, **kwargs)
        finally:
            stats.solver_time += time.time() - begin

    return wrapper


_context: Optional[BlastContext] = None


def get_blast_context() -> BlastContext:
    global _context
    if _context is None:
        _context = BlastContext()
    return _context


def reset_blast_context() -> None:
    """Drop the CNF pool and the term-interner table (used between
    unrelated analyses and in tests).  Callers must not retain Expression
    wrappers across a reset — the interner forgets old nodes, so stale
    wrappers would no longer compare identical to newly built terms."""
    global _context
    _context = None
    T.reset_interner()
    # the model cache is keyed by interner node ids, which restart here
    from mythril_tpu_torch.support.model import clear_model_cache

    clear_model_cache()
    # the autopilot's cost model is per-workload by contract: its
    # feature memo and signature statistics are keyed by the term
    # population this reset just discarded
    from mythril_tpu_torch.autopilot import reset_for_tests as _reset_autopilot

    _reset_autopilot()


class BaseSolver:
    def __init__(self):
        self.constraints: List = []  # Bool wrappers or raw nodes
        self.timeout_ms = 100000
        self.conflict_budget = -1

    def set_timeout(self, timeout_ms: int) -> None:
        self.timeout_ms = timeout_ms

    def add(self, *constraints) -> None:
        for c in constraints:
            if isinstance(c, (list, tuple)):
                self.constraints.extend(c)
            else:
                self.constraints.append(c)

    append = add

    def _nodes(self, extra=()) -> List[T.Node]:
        nodes = []
        for c in list(self.constraints) + list(extra):
            nodes.append(c.raw if hasattr(c, "raw") else c)
        return nodes

    @stat_smt_query
    def _check_nodes(self, nodes: Sequence[T.Node]):
        ctx = get_blast_context()
        status, env = ctx.check(
            nodes,
            timeout_s=self.timeout_ms / 1000.0,
            conflict_budget=self.conflict_budget,
        )
        if status == SatSolver.SAT:
            return sat, env
        if status == SatSolver.UNSAT:
            return unsat, None
        return unknown, None


class Solver(BaseSolver):
    def __init__(self):
        super().__init__()
        self._env: Optional[T.EvalEnv] = None

    def check(self, *extra) -> CheckResult:
        result, env = self._check_nodes(self._nodes(extra))
        self._env = env
        return result

    def model(self) -> Model:
        return Model([self._env]) if self._env is not None else Model()

    def reset(self) -> None:
        self.constraints = []
        self._env = None

    pop = reset


class Optimize(BaseSolver):
    """minimize/maximize via incremental bound search (max ~24 probes)."""

    MAX_PROBES = 24

    def __init__(self):
        super().__init__()
        self._minimize: List[T.Node] = []
        self._maximize: List[T.Node] = []
        self._env: Optional[T.EvalEnv] = None
        # False when a probe came back unknown / the probe budget ran
        # out: the model is valid but objective minimality is unproven
        self.exact = True

    def minimize(self, element) -> None:
        self._minimize.append(element.raw if hasattr(element, "raw") else element)

    def maximize(self, element) -> None:
        self._maximize.append(element.raw if hasattr(element, "raw") else element)

    def check(self, *extra) -> CheckResult:
        base = self._nodes(extra)
        result, env = self._check_nodes(base)
        if result is not sat:
            return result
        pinned: List[T.Node] = []
        for objective, direction in [(o, "min") for o in self._minimize] + [
            (o, "max") for o in self._maximize
        ]:
            env = self._tighten(base, pinned, objective, direction, env)
            best = T.evaluate(objective, env)
            if direction == "min":
                pinned.append(T.ule(objective, T.const(best, objective.width)))
            else:
                pinned.append(T.ule(T.const(best, objective.width), objective))
        self._env = env
        return sat

    def _tighten(self, base, pinned, objective, direction, env):
        """Binary-search the objective bound.  UNSAT is proof the bound
        is too tight; UNKNOWN (budget exhausted) is *not* — the search
        stops there and keeps the best verified model, flagging the
        result as possibly non-minimal (``self.exact``) rather than
        silently treating a timeout as an optimality proof (the
        reference's z3 Optimize is exact)."""
        width = objective.width
        best_env = env
        best = T.evaluate(objective, env)
        lo, hi = 0, best
        if direction == "max":
            lo, hi = best, T.mask(width)
        probes = 0
        while lo < hi and probes < self.MAX_PROBES:
            probes += 1
            mid = (lo + hi) // 2
            if direction == "min":
                bound = T.ule(objective, T.const(mid, width))
            else:
                bound = T.ule(T.const(mid + 1, width), objective)
            result, candidate = self._check_nodes(base + pinned + [bound])
            if result is sat:
                value = T.evaluate(objective, candidate)
                best_env = candidate
                if direction == "min":
                    hi = min(value, mid)
                else:
                    lo = max(value, mid + 1)
            elif result is unsat:
                if direction == "min":
                    lo = mid + 1
                else:
                    hi = mid
            else:  # unknown: inconclusive — stop, model stays valid
                self.exact = False
                log.debug(
                    "Optimize probe inconclusive (budget exhausted); "
                    "returning best verified bound %s for %s",
                    best, direction,
                )
                break
        if lo < hi and probes >= self.MAX_PROBES:
            self.exact = False
        return best_env

    def model(self) -> Model:
        return Model([self._env]) if self._env is not None else Model()
