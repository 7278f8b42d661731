"""Solver facade (own copy of the parts of ``mythril_tpu/smt/solver``
this slice uses): the shared blast context, the query statistics, and
the per-query :class:`Solver` the CDCL tail answers through.

Every Solver shares one process-wide :class:`BlastContext`, i.e. a
single incremental native CDCL instance holding the CNF pool; a
``check`` is an assumption query against that pool.  A whole frontier
goes through ``ops/batched_sat.batch_check_states`` instead, which
dispatches the dense tier before falling back to per-query checks here.
``Optimize`` and ``IndependenceSolver`` come with the LASER slice.
"""

import time
from functools import wraps
from typing import List, Optional, Sequence

from mythril_tpu_torch.native import SatSolver
from mythril_tpu_torch.smt import terms as T
from mythril_tpu_torch.smt.bitblast import BlastContext
from mythril_tpu_torch.smt.model import Model


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


class Solver:
    def __init__(self):
        self.constraints: List = []  # Bool wrappers or raw nodes
        self.timeout_ms = 100000
        self.conflict_budget = -1
        self._env: Optional[T.EvalEnv] = None

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
        return [
            c.raw if hasattr(c, "raw") else c
            for c in list(self.constraints) + list(extra)
        ]

    @stat_smt_query
    def _check_nodes(self, nodes: Sequence[T.Node]):
        status, env = get_blast_context().check(
            nodes,
            timeout_s=self.timeout_ms / 1000.0,
            conflict_budget=self.conflict_budget,
        )
        if status == SatSolver.SAT:
            return sat, env
        if status == SatSolver.UNSAT:
            return unsat, None
        return unknown, None

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
