"""Frontier feasibility funnel of the PyTorch port (counterpart of
``mythril_tpu/ops/batched_sat.py``, trimmed to this slice).

:func:`batch_check_states` takes a frontier of term-level path
constraint sets and returns one verdict per set.  It is the JAX funnel
under the slice's configuration (``MYTHRIL_TPU_RESIDENT_KERNEL=0``,
``MYTHRIL_TPU_WORD_TIER=0``, ``MYTHRIL_TPU_AUTOPILOT=0``):

1. structural fold: constraints that folded to literal False;
2. dense tier (``ops/dense_prop.py``) over the deduped open lanes, on
   the card unless the caller passes ``device="cpu"``;
3. host verification of every SAT candidate against the terms (device
   UNSAT verdicts become assumption nogoods in the pool);
4. the native CDCL tail for everything still undecided.

Left out of this slice: the host word-level probe phase before the
dispatch, the word tier, the autopilot router, the lane ledger, the
coalescer and async prefetch, the adaptive profit gate and fuse, and
the gather / resident / frontier solvers.
"""

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
from torch.profiler import record_function

#: union-cone gather tier caps of the JAX package (batched_sat.py:60-61);
#: the resident/gather solvers that read them come with a later slice
MAX_CONE_GATHER_CLAUSES = 16384
MAX_CONE_GATHER_VARS = 8192


def effective_min_lanes() -> int:
    """Structural lane floor of the funnel (same rule as the JAX
    package): the default knob relaxes to 4, an operator who raises
    ``device_min_lanes`` above 8 is honored verbatim."""
    from mythril_tpu_torch.support.support_args import args

    knob = getattr(args, "device_min_lanes", 8)
    if knob > 8:
        return knob
    return max(2, min(knob, 4))


class DispatchStats:
    """Device-dispatch telemetry of the funnel and the dense tier."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.dispatches = 0        # dense-tier dispatches that engaged
        self.lanes = 0             # lanes sent to the device
        self.unsat = 0             # lanes decided UNSAT on the device
        self.sat_verified = 0      # lanes whose device model verified
        self.undecided = 0         # device lanes handed to the CDCL tail
        self.tail_sat = 0          # CDCL-tail verdicts
        self.tail_unsat = 0
        self.device_sweeps = 0     # DPLL steps run (one sweep each)
        self.lane_sweeps_active = 0
        self.lane_sweeps_total = 0
        self.rounds = 0            # budgeted solve rounds executed
        self.repacks = 0           # survivor re-packs into smaller buckets
        self.lane_slots_filled = 0
        self.lane_slots_total = 0
        self.device_s = 0.0        # wall-clock inside dense dispatches
        self.tail_s = 0.0          # wall-clock inside the CDCL tail
        self.h2d_bytes = 0         # coordinates + assignment planes shipped
        self.device_dispatch_calls = 0
        self.warm_start_hits = 0
        self.cone_memo_hits = 0
        # per-lane tier that decided each lane of the last
        # batch_check_states call: "structural", "device", "tail" or
        # None (the tail answered UNKNOWN)
        self.last_tiers: List[Optional[str]] = []


dispatch_stats = DispatchStats()


def warm_pref_row(ctx, width: int, cone_vars=None, offset: int = 1,
                  lanes: int = 0, dtype=np.int8):
    """Warm-start decision-phase row for one dispatch, or None: the
    newest tagged SAT model's phases (BlastContext.warm_phase_vector),
    remapped onto compact cone columns (``cone_vars[i] -> column
    i + offset``).  Counts ``lanes`` into ``warm_start_hits`` when a
    usable row exists.  Honors ``MYTHRIL_TPU_WARM_START``."""
    from mythril_tpu_torch.ops.incremental import warm_start_enabled

    if not warm_start_enabled():
        return None
    warm = ctx.warm_phase_vector(ctx.solver.num_vars)
    if warm is None:
        return None
    row = np.zeros(width, dtype)
    if cone_vars is None:
        n = min(width, len(warm))
        row[:n] = warm[:n]
    else:
        cv = np.asarray(cone_vars, np.int64)
        vals = np.zeros(len(cv), np.int8)
        valid = cv < len(warm)
        vals[valid] = warm[cv[valid]]
        limit = max(0, min(len(cv), width - offset))
        row[offset:offset + limit] = vals[:limit]
    if not np.any(row):
        return None
    dispatch_stats.warm_start_hits += lanes
    return row


def _env_from_assignment(ctx, assignment: np.ndarray):
    """EvalEnv from a device assignment vector (BlastContext.extract_env)."""
    return ctx.extract_env(assignment)


def _holds(constraints, env) -> bool:
    from mythril_tpu_torch.smt import terms as T

    for c in constraints:
        node = c.raw if hasattr(c, "raw") else c
        if isinstance(node, bool):
            if not node:
                return False
            continue
        if T.evaluate(node, env) is not True:
            return False
    return True


def batch_check_states(constraint_sets, device=None) -> List[Optional[bool]]:
    """Feasibility verdicts for a frontier of constraint sets: True =
    SAT (model verified against the terms), False = UNSAT (sound),
    None = the CDCL tail answered UNKNOWN (budget).  The dense tier
    runs on ``cuda`` unless ``device="cpu"`` is passed."""
    from mythril_tpu_torch.ops.dense_prop import get_dense_backend
    from mythril_tpu_torch.smt import terms as T
    from mythril_tpu_torch.smt.solver import get_blast_context

    ctx = get_blast_context()
    node_sets: List[Optional[List]] = []
    decided: List[Optional[bool]] = [None] * len(constraint_sets)
    tiers: List[Optional[str]] = [None] * len(constraint_sets)
    dispatch_stats.last_tiers = tiers

    # 1. structural fold
    for i, constraints in enumerate(constraint_sets):
        nodes = []
        falsy = False
        for c in constraints:
            if isinstance(c, bool):
                if not c:
                    falsy = True
                    break
                continue
            node = c.raw if hasattr(c, "raw") else c
            if node is T.FALSE:
                falsy = True
                break
            if node is T.TRUE:
                continue
            nodes.append(node)
        if falsy:
            decided[i] = False
            tiers[i] = "structural"
            node_sets.append(None)
        else:
            node_sets.append(nodes)

    open_indices = [i for i, d in enumerate(decided) if d is None]
    backend = get_dense_backend(device)
    if len(open_indices) >= effective_min_lanes() and backend.available_for(
        ctx
    ):
        _dense_phase(ctx, backend, constraint_sets, node_sets, decided,
                     open_indices)
        for i in open_indices:
            if decided[i] is not None:
                tiers[i] = "device"

    # 4. CDCL tail
    started = time.perf_counter()
    with record_function("funnel.tail"):
        _tail(ctx, node_sets, decided, tiers)
    dispatch_stats.tail_s += time.perf_counter() - started
    return decided


def _tail(ctx, node_sets, decided, tiers):
    from mythril_tpu_torch.native import SatSolver

    for i, nodes in enumerate(node_sets):
        if decided[i] is not None or nodes is None:
            continue
        status, _env = ctx.check(nodes)
        if status == SatSolver.SAT:
            decided[i] = True
            tiers[i] = "tail"
            dispatch_stats.tail_sat += 1
        elif status == SatSolver.UNSAT:
            decided[i] = False
            tiers[i] = "tail"
            dispatch_stats.tail_unsat += 1


def _dense_phase(ctx, backend, constraint_sets, node_sets, decided,
                 open_indices):
    """2.-3.: blast the open lanes, dispatch the deduped assumption sets
    to the dense tier, fold its verdicts into ``decided``."""
    assumption_sets: List[Optional[List[int]]] = [None] * len(node_sets)
    with record_function("funnel.blast"):
        for i in list(open_indices):
            try:
                lits = [ctx.blast_lit(n) for n in node_sets[i]]
                assumption_sets[i] = list(dict.fromkeys(lits))
            except NotImplementedError:
                # a term outside the blaster's fragment: CDCL tail only
                open_indices.remove(i)
    if len(open_indices) < 2:
        return

    # dedupe identical assumption sets (sibling forks share most or all
    # of their constraints)
    unique: Dict[Tuple[int, ...], int] = {}
    rep_indices: List[int] = []
    lane_of: List[int] = []
    for i in open_indices:
        key = tuple(sorted(assumption_sets[i]))
        lane = unique.get(key)
        if lane is None:
            lane = unique[key] = len(rep_indices)
            rep_indices.append(i)
        lane_of.append(lane)
    rep_sets = [assumption_sets[i] for i in rep_indices]

    started = time.perf_counter()
    dense = backend.check_assumption_sets(ctx, rep_sets)
    dispatch_stats.device_s += time.perf_counter() - started
    if dense is None:
        return  # no layout fits the caps: every lane goes to the tail
    verdicts, assignments = dense
    dispatch_stats.dispatches += 1
    dispatch_stats.lanes += len(rep_indices)

    with record_function("funnel.verify"):
        _fold_verdicts(ctx, constraint_sets, node_sets, decided,
                       open_indices, assumption_sets, rep_indices, lane_of,
                       verdicts, assignments)


def _fold_verdicts(ctx, constraint_sets, node_sets, decided, open_indices,
                   assumption_sets, rep_indices, lane_of, verdicts,
                   assignments):
    """3.: device UNSAT -> memo + nogood; SAT candidates -> verified by
    evaluating the terms under the decoded model, else left open."""
    counted = set()
    for pos, i in enumerate(open_indices):
        lane = lane_of[pos]
        first = lane not in counted
        counted.add(lane)
        if verdicts[lane] is False:
            decided[i] = False
            # device UNSAT is permanent: memoize it and learn the
            # assumption nogood so the CDCL inherits the refutation
            ctx.note_unsat(node_sets[i])
            if first:
                ctx.learn_nogood(assumption_sets[rep_indices[lane]])
                dispatch_stats.unsat += 1
            continue
        env = _env_from_assignment(ctx, assignments[lane])
        ok = _holds(constraint_sets[i], env)
        decided[i] = True if ok else None
        if first:
            if ok:
                ctx._remember_model(env, truth=assignments[lane])
                dispatch_stats.sat_verified += 1
            else:
                dispatch_stats.undecided += 1
