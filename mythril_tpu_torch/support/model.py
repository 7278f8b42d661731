"""The solver funnel (reference: mythril/support/model.py).

Every sat/model request in the framework goes through :func:`get_model`:
memoized on the constraint tuple, budgeted against both the per-query
solver timeout and the remaining global execution time, raising
:class:`UnsatError` for unsat/unknown — the same control contract as the
reference so callers port over unchanged.

Differences from the reference worth noting:
- the memo is keyed by interned term-node ids (wrapper objects overload
  ``==``, so they can't be dict keys);
- unsat verdicts are memoized too (the reference's ``lru_cache`` cannot
  cache exceptions, so it re-paid Z3 for every repeated unsat query; our
  verdicts are deterministic for a fixed budget).
"""

import logging
from typing import Dict, Sequence, Tuple

from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
from mythril_tpu_torch.smt import Optimize, is_false
from mythril_tpu_torch.smt.solver import sat, unknown, unsat
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)

_UNSAT = object()
_cache: Dict[Tuple, object] = {}
_CACHE_LIMIT = 2**20


def clear_model_cache() -> None:
    _cache.clear()


def _key_of(expr) -> int:
    return expr.raw.id if hasattr(expr, "raw") else id(expr)


def _filter_and_key(constraints, minimize=(), maximize=(), solver_timeout=None):
    """(concrete_constraints, cache_key) or (None, None) when a
    constraint is literally false — the single construction point for
    the funnel's cache key, shared by get_model and the read-only
    peek so the two can never drift apart."""
    concrete = []
    for constraint in constraints:
        if isinstance(constraint, bool):
            if not constraint:
                return None, None
            continue  # literal True adds nothing
        if is_false(constraint):
            return None, None
        concrete.append(constraint)
    key = (
        tuple(sorted({_key_of(c) for c in concrete})),
        tuple(_key_of(m) for m in minimize),
        tuple(_key_of(m) for m in maximize),
        solver_timeout,
    )
    return concrete, key


def peek_model_verdict(constraints: Sequence):
    """True/False when this exact constraint set's sat verdict is
    already cached, None otherwise — a read-only probe for the batch
    frontier pass, so lanes whose per-query verdict the funnel has
    already paid for are not re-probed or re-blasted."""
    concrete, key = _filter_and_key(constraints)
    if concrete is None:
        return False  # literally-false constraint
    hit = _cache.get(key)
    if hit is _UNSAT:
        return False
    if hit is not None:
        return True
    return None


def get_model(
    constraints: Sequence,
    minimize: Tuple = (),
    maximize: Tuple = (),
    enforce_execution_time: bool = True,
    solver_timeout: int = None,
):
    """Return a Model for the constraints or raise UnsatError."""
    concrete, key = _filter_and_key(
        constraints, minimize, maximize, solver_timeout
    )
    if concrete is None:
        raise UnsatError
    hit = _cache.get(key)
    if hit is _UNSAT:
        raise UnsatError
    if hit is not None:
        return hit

    timeout = solver_timeout or args.solver_timeout
    if enforce_execution_time:
        timeout = min(timeout, time_handler.time_remaining() - 500)
        if timeout <= 0:
            raise UnsatError

    solver = Optimize()
    solver.set_timeout(timeout)
    solver.add(*concrete)
    for e in minimize:
        solver.minimize(e)
    for e in maximize:
        solver.maximize(e)

    if len(_cache) > _CACHE_LIMIT:
        _cache.clear()

    result = solver.check()
    if result is sat:
        model = solver.model()
        _cache[key] = model
        return model
    if result is unsat:
        _cache[key] = _UNSAT
        raise UnsatError
    log.debug("Timeout/budget exhausted when trying to solve a model.")
    raise UnsatError  # unknown: do not cache (a bigger budget may differ)
