"""Dense clause-incidence DPLL for batched SAT (PyTorch port of
``mythril_tpu/ops/pallas_prop.py``; the module is renamed because there
is no Pallas here).

Clause evaluation is reformulated over dense *clause-incidence planes*:

- ``P[c, v] = 1`` iff variable ``v`` occurs positively in clause ``c``
  (``N`` likewise for negative occurrences).
- With the assignment ``A[b, v] ∈ {-1, 0, +1}`` (f32) one sweep counts
  satisfied and falsified literals per (lane, clause), classifies each
  clause as conflicting / unit / open, and returns forced-literal votes
  and open-clause decision scores per (lane, variable).  The union
  layout keeps the planes' nonzero cells only, as clause rows
  (``ops/dense_sweep.py:SweepRows``: CSR row pointers and one cell a
  literal), and its sweep is the hand-written CUDA kernel
  ``csrc/dense_sweep.cu`` over them on the card; the per-lane layout
  keeps [B, C, V] float32 planes and sweeps with ``torch.bmm`` (the JAX
  package leaves that one to XLA's batched dots).

Around one sweep per step runs a batched DPLL search: per-lane trail
levels and an explicit decision stack, dynamic DLIS decisions (with
bulk top-K levels past a single-var window and the don't-care cascade),
chronological backtracking, and tiered hot/cold sweeping.  Each step is
the sweep and one DPLL step (``ops/dpll_step.py``: on the card the
hand-written kernel ``csrc/dpll_step.cu``, two launches a step); the
host reads the step's 4-byte live marker only every :data:`SYNC_EVERY`
steps (extra steps on a batch with no live lane are no-ops, and
``steps_used`` counts exactly the steps the JAX ``while_loop`` runs).

Soundness contract (unchanged from the JAX package): UNSAT only from a
BCP conflict with zero decisions or an exhausted untainted search, both
sound under clause subsets; SAT only after host-side verification of
the concrete model.  Undecided lanes fall back to the native CDCL.

Device tiers: on ``cpu`` the port uses the JAX package's interpret-tier
budgets and caps, so the CPU tests compare like with like against
``interpret=True``; on ``cuda`` it keeps the algorithmic budgets and
re-derives the size caps for an 80 GB card (see :data:`CUDA_TIER`).
With the resident solver on (the default), a frontier whose union cone
fits the cone-tier caps is delegated to the gather tiers
(``ops/batched_sat.py``).  The funnel runs the whole tier as one
supervised ``pallas`` dispatch (``resilience/watchdog.py``); between
budget rungs the round ladder checks the watchdog's cancellation
(``raise_if_cancelled``), stops on a drain request (the ``pallas.drain``
instant; survivors retire undecided) and passes the fault plane's
dispatch seam, and the tier's verdicts pass its garbage-lane seam.  The
round ladder is the span ``dense.rounds``; each round keeps its own
``record_function`` range, ``dense.round``.
"""

import logging
import os
import zlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mythril_tpu_torch.ops import default_device
from mythril_tpu_torch.ops.dense_sweep import (
    SweepRows, dense_sweep, planes_to_rows, rows_from_coords,
)
from mythril_tpu_torch.ops.dpll_step import dpll_step
from mythril_tpu_torch.support.env import env_flag, env_int

log = logging.getLogger(__name__)


class Tier(NamedTuple):
    """Size caps and budgets of one device tier.

    ``max_vars``/``max_clauses``/``max_cells`` cap the bucketed union
    pool (C, V and C x V); ``lane_cells`` caps the [B, V] state planes
    per chunk; ``batched_cost`` weighs a per-lane cell against a union
    cell when the two layouts compete."""

    name: str
    max_vars: int
    max_clauses: int
    max_cells: int
    lane_cells: int
    steps: int
    dpll_max_vars: int
    round_budgets: Tuple[int, ...]
    batched_cost: int


#: the JAX package's interpret tier (pallas_prop.py:87-89, :96, :108,
#: :111, :130): what the CPU runs, and what the CPU tests compare against
CPU_TIER = Tier("cpu", 4096, 1 << 15, 1 << 22, 1 << 18, 192, 2048,
                (48, 144), 1)
#: The card's tier.  The TPU caps (pallas_prop.py:90-92, :96) came from
#: HBM and VMEM; here the pool lives in the H100's 80 GB of device
#: memory and no [B, V] plane has to stay in on-chip memory:
#: - a union pool of up to 2^28 cells of C x V (the union layout holds
#:   its rows' literals only, so the cap bounds the search, not memory);
#:   C and V keep the TPU tier's power-of-two ceilings (the search itself
#:   is limited by DPLL_MAX_VARS anyway);
#: - [B, V] state planes up to 2^22 cells (16 MiB per f32 plane), so the
#:   lane chunk is MAX_LANES wide up to V = 65536;
#: - a per-lane cell costs 8 union cells when the layouts compete: the
#:   weight the union layout's first kernel set (float32 planes swept by
#:   four bmm passes of two planes against one pass of two bf16 planes,
#:   32 B vs 4 B a cell), kept so that the two layouts split frontiers
#:   as before.
#: The DPLL budgets are the algorithmic ones of pallas_prop.py:107-129.
CUDA_TIER = Tier("cuda", 1 << 14, 1 << 17, 1 << 28, 1 << 22, 4096, 8192,
                 (64, 256, 1024), 8)

MAX_LANES = 64               # per-chunk lane cap
MAX_DECISIONS = 1024
# tiered cone sweeping: the hot tier is swept every step, the cold
# remainder joins every TIER_PERIOD-th sweep (the verdict-bearing
# transitions are gated on full sweeps)
TIER_PERIOD = 8
HOT_WIDTH = 3  # clauses at most this wide are always hot (unit fuel)
#: the round loop reads the live marker back every SYNC_EVERY steps
SYNC_EVERY = 16


def _over_caps(C: int, V: int, cell_weight: int, tier: Tier) -> str:
    """The caps of ``tier`` that a bucketed C x V layout passes, each
    cell weighing ``cell_weight`` against ``max_cells`` (1 for the union
    pool, 2 for one lane of the per-lane layout: :meth:`DenseClausePool.fits_lane`)."""
    over = [name for name, past in (
        ("C", C > tier.max_clauses), ("V", V > tier.max_vars),
        ("cells", C * V * cell_weight > tier.max_cells)) if past]
    return "+".join(over) or "none"


def tier_for(device) -> Tier:
    return CPU_TIER if torch.device(device).type == "cpu" else CUDA_TIER


def dense_enabled() -> bool:
    """``MYTHRIL_TPU_PALLAS=0`` (or ``false``, ``off``: the JAX package's
    switch of its dense tier) switches the dense tier off, and so does
    its alias ``MYTHRIL_TPU_DENSE=0``; the funnel then goes straight to
    the gather tiers.  Any other value leaves the tier on: the port has
    no "on the TPU only" default."""
    if os.environ.get("MYTHRIL_TPU_PALLAS", "").lower() in ("0", "false",
                                                            "off"):
        return False
    return env_flag("MYTHRIL_TPU_DENSE", True)


def _bucket(n: int, floor: int = 128) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def _tier_period() -> int:
    """Cold-sweep period (``MYTHRIL_TPU_TIER_PERIOD``; <= 1 disables the
    tier split).  Without an operator pin the autopilot tuner may
    publish a bounded override (autopilot/tuner.py)."""
    if not os.environ.get("MYTHRIL_TPU_TIER_PERIOD", "").strip():
        from mythril_tpu_torch.autopilot import knob_override

        tuned = knob_override("tier_period")
        if tuned is not None:
            return max(1, tuned)
    return env_int("MYTHRIL_TPU_TIER_PERIOD", TIER_PERIOD, floor=1)


def _ladder_budgets(total_steps: int, tier: Tier) -> list:
    """Per-round step budgets covering ``total_steps`` from the tier's
    fixed geometric set (last entry repeats).
    ``MYTHRIL_TPU_ROUND_LADDER=0`` collapses the ladder to one round."""
    if not env_flag("MYTHRIL_TPU_ROUND_LADDER", True):
        return [total_steps]
    seq = tier.round_budgets
    budgets, spent, i = [], 0, 0
    while spent < total_steps:
        budgets.append(seq[min(i, len(seq) - 1)])
        spent += budgets[-1]
        i += 1
    return budgets


def _hot_row_mask(urow, ulit, width_arr, seed_cols) -> np.ndarray:
    """Hot-tier membership over clause rows: narrow clauses plus every
    row touching a seed column."""
    n_rows = len(width_arr)
    mask = (width_arr > 0) & (width_arr <= HOT_WIDTH)
    if len(urow) and len(seed_cols):
        hit = np.isin(np.abs(ulit.astype(np.int64)), seed_cols)
        touched = np.zeros(n_rows, dtype=bool)
        touched[np.unique(urow[hit])] = True
        mask = mask | touched
    return mask


def _hot_first_perm(hot_mask: np.ndarray):
    """Stable permutation packing hot rows to the row-axis prefix.
    Returns (order, new_pos): ``order[new] = old``, ``new_pos[old] =
    new``."""
    order = np.argsort(~hot_mask, kind="stable")
    new_pos = np.empty(len(hot_mask), np.int64)
    new_pos[order] = np.arange(len(hot_mask))
    return order, new_pos


def _tile_c(C: int, V: int, tier: Tier) -> int:
    """Granule of the hot prefix.  On the CPU tier it is the JAX
    package's Pallas clause tile (pallas_prop.py:427), so hot-tier
    growth matches ``interpret=True`` step for step.  The CUDA kernel
    has no tile rule (a thread a row and lane): its granule is the
    same power-of-two floor of 128 rows, never above C."""
    if tier.name == "cpu":
        return min(C, max(128, min(256, (1 << 19) // V)))
    return min(C, 128)


def _pad_coords(values, size: int) -> np.ndarray:
    """Pad a coordinate list to its bucket with zero writes — cell
    (0, 0) is row 0 x column 0, and column 0 is never a variable, so a
    spurious 1 there never changes counts in live lanes (A[:, 0] stays
    0; padding lanes, fully assigned, do count it) and forced
    votes/scores for column 0 are masked off by ``col > 1``.  The union
    pool's rows carry the same cell once for each padded sign
    (:meth:`DenseClausePool.refresh_coords`)."""
    arr = np.zeros(size, dtype=np.int64)
    arr[: len(values)] = values
    return arr


class DenseClausePool:
    """The union layout's clause pool over an explicit clause list: the
    rows' literals as :class:`~mythril_tpu_torch.ops.dense_sweep.SweepRows`
    (no [C, V] plane), on one device (``cuda`` unless the caller asks
    for another)."""

    def __init__(self, device=None):
        self.device = default_device(device)
        self.rows: Optional[SweepRows] = None  # indptr, cells, width
        self.num_vars = 0   # V - 1 usable ids (column == var id)
        self.C = 0
        self.V = 0

    @staticmethod
    def fits_lane(C: int, V: int, tier: Tier) -> bool:
        """Caps for ONE lane of the per-lane layout (bucketed shapes)."""
        return (
            C <= tier.max_clauses
            and V <= tier.max_vars
            and C * V * 8 <= tier.max_cells * 4
        )

    @staticmethod
    def fits(num_clauses: int, num_vars: int, tier: Tier) -> bool:
        C = _bucket(max(1, num_clauses))
        V = _bucket(num_vars + 1)
        return (
            C <= tier.max_clauses
            and V <= tier.max_vars
            and C * V <= tier.max_cells
        )

    def refresh(self, clauses_py: Sequence[Tuple[int, ...]], num_vars: int):
        """Tuple-list entry point (tests); the dispatch path uses
        :meth:`refresh_coords` with arrays from the native pool's CSR."""
        flat = [lit for clause in clauses_py for lit in clause]
        lits = np.fromiter(flat, dtype=np.int32, count=len(flat))
        lens = np.fromiter(
            (len(clause) for clause in clauses_py), dtype=np.int64,
            count=len(clauses_py),
        )
        indptr = np.concatenate([[0], np.cumsum(lens)])
        urow, ulit, width_arr = dedupe_clause_rows(lits, indptr)
        self.refresh_coords(
            urow, ulit, width_arr, len(clauses_py), num_vars
        )

    def refresh_coords(
        self, urow, ulit, width_arr, n_rows: int, num_vars: int
    ):
        """Build the pool's clause rows from (row, literal) coordinates
        in any row order (``grow_hot`` permutes the rows): sorted by row
        on the host, only the row pointers, cells and widths shipped.
        The JAX package's plane constructors pad each sign's coordinate
        list to its bucket with cell (0, 0) (``_pad_coords``); the rows
        carry that cell once for each sign whose list was padded, as the
        planes do."""
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        C = _bucket(max(1, n_rows))
        V = _bucket(num_vars + 1)
        width = np.zeros((1, C), dtype=np.float32)
        width[0, :n_rows] = width_arr
        lit = np.asarray(ulit, np.int64)
        negative = lit < 0
        pads = [sign for sign, n in ((False, int((~negative).sum())),
                                     (True, int(negative.sum())))
                if _bucket(max(1, n), floor=256) > n]
        self.rows = rows_from_coords(
            np.concatenate([np.asarray(urow, np.int64),
                            np.zeros(len(pads), np.int64)]),
            np.concatenate([np.abs(lit), np.zeros(len(pads), np.int64)]),
            np.concatenate([negative, np.array(pads, bool)]),
            width, V, self.device,
        )
        dispatch_stats.h2d_bytes += sum(int(t.numel()) * 4 for t in self.rows)
        self.num_vars = V - 1
        self.C, self.V = C, V


def _incidence(shape, coords, n_pad: int, dtype, device) -> torch.Tensor:
    """Zeroed plane with 1 at every coordinate tuple (padded to
    ``n_pad`` entries with zero coordinates, as the JAX builders do)."""
    plane = torch.zeros(shape, dtype=dtype, device=device)
    index = tuple(
        torch.from_numpy(_pad_coords(axis, n_pad)).to(device)
        for axis in coords
    )
    plane.index_put_(index, torch.ones((), dtype=dtype, device=device))
    return plane


def dedupe_clause_rows(lits: np.ndarray, indptr: np.ndarray):
    """Vectorized clause-row normalization for the incidence builds.

    Input is a CSR literal layout (row i = clause i).  Returns
    ``(urow, ulit, width)``: the unique (row, literal) coordinate pairs
    with tautologous rows removed entirely, and ``width[i]`` the count
    of UNIQUE literals of row i (0 for tautologies)."""
    n_rows = len(indptr) - 1
    if n_rows == 0 or len(lits) == 0:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty.astype(np.int32), np.zeros(n_rows, np.float32)
    row = np.repeat(
        np.arange(n_rows, dtype=np.int64), np.diff(indptr)
    )
    # unique (row, literal) pairs via a packed key (|lit| < 2**32)
    key = row << np.int64(34)
    key += lits.astype(np.int64) + (np.int64(1) << np.int64(33))
    _, first = np.unique(key, return_index=True)
    urow = row[first]
    ulit = lits[first]
    # tautology = some (row, var) present with both polarities
    vkey = (urow << np.int64(34)) + np.abs(ulit.astype(np.int64))
    vals, counts = np.unique(vkey, return_counts=True)
    width = np.zeros(n_rows, dtype=np.float32)
    if np.any(counts > 1):
        taut_rows = np.unique(vals[counts > 1] >> np.int64(34))
        keep = ~np.isin(urow, taut_rows)
        urow, ulit = urow[keep], ulit[keep]
    np.add.at(width, urow, 1.0)
    return urow, ulit.astype(np.int32), width


def remap_cone_csr(ctx, clause_ids, cone_vars):
    """Fetch the given pool clauses and remap variable ids onto dense
    columns: anchor var 1 -> column 1, ``cone_vars[i]`` (sorted) ->
    column ``i + 2``.  Returns the deduped coordinates of
    :func:`dedupe_clause_rows`."""
    lits, indptr = ctx.pool.subset_csr(clause_ids)
    av = np.abs(lits).astype(np.int64)
    col = np.where(av == 1, 1, np.searchsorted(cone_vars, av) + 2)
    remapped = np.where(lits < 0, -col, col).astype(np.int32)
    return dedupe_clause_rows(remapped, indptr)


def assumption_columns(cone_vars: np.ndarray, lits) -> np.ndarray:
    """Dense columns of assumption literals under the same remap;
    returns signed column ids (sign = literal polarity)."""
    arr = np.fromiter(lits, dtype=np.int64, count=len(lits))
    av = np.abs(arr)
    col = np.where(av == 1, 1, np.searchsorted(cone_vars, av) + 2)
    return np.where(arr < 0, -col, col)


#: field order of the resumable solver state (see _dpll_round_loop).
#: ``pref`` is the warm-start decision-phase plane ([B, V] f32, 0 = no
#: preference): never written by the loop, only biases which polarity a
#: decision tries first.
DPLL_STATE_FIELDS = (
    "A", "lvl", "dvar", "dphase", "dflip", "dbulk", "depth", "status",
    "taint", "active", "pref",
)
_STATUS_IDX = DPLL_STATE_FIELDS.index("status")
_ACTIVE_IDX = DPLL_STATE_FIELDS.index("active")


def _dpll_state0(A0: np.ndarray, D: int, n_real: int, device,
                 pref_row=None) -> list:
    """Zero state for a round ladder over ``A0 [B, V]``, on ``device``;
    rows past ``n_real`` are bucket padding, retired from step 0."""
    B, V = A0.shape
    pref = np.zeros((B, V), np.float32)
    if pref_row is not None:
        pref[:] = np.asarray(pref_row, np.float32)
    state = [
        A0.astype(np.float32, copy=True),
        np.zeros((B, V), np.int32),
        np.zeros((B, D), np.int32),
        np.zeros((B, D), np.float32),
        np.zeros((B, D), np.float32),
        np.zeros((B, D), np.float32),
        np.zeros((B, 1), np.int32),
        np.zeros((B, 1), np.int32),
        np.zeros((B, 1), np.float32),
        np.zeros((B, 1), np.int32),
        pref,
    ]
    state[_STATUS_IDX][n_real:] = 3
    return [torch.from_numpy(a).to(device) for a in state]


def _sweep_workspace(B: int, V: int, scores: bool, device) -> tuple:
    """Zeroed sweep outputs (fpos, fneg, conf[, spos, sneg]) for a round,
    views of one allocation: the sweep adds into them and the DPLL step
    zeroes them again after reading them."""
    planes = 4 if scores else 2
    flat = torch.zeros(planes * B * V + B, dtype=torch.float32,
                       device=device)
    views = [flat[i * B * V:(i + 1) * B * V].view(B, V)
             for i in range(planes)]
    conf = flat[planes * B * V:].view(B, 1)
    return (views[0], views[1], conf, *views[2:])


def _dpll_round_loop(sweep, B, V, budget, max_decisions, sweep_hot=None,
                     tier_period=1, workspace=False):
    """Resumable DPLL control loop around a sweep callable
    (``mythril_tpu/ops/pallas_prop.py:_dpll_round_loop``): each step is
    the sweep and one :func:`~mythril_tpu_torch.ops.dpll_step.dpll_step`.

    ``sweep(*pool, A, out)`` returns (fpos, fneg, conf[, spos, sneg])
    from the pool's three operands: the union layout's
    :class:`SweepRows` (indptr, cells, width) or the per-lane layout's
    planes (P, N, width).  With ``workspace`` the round allocates ``out``
    once (zeroed) and the step zeroes it again after each read, else
    ``out`` is None and the sweep returns fresh tensors.  Returns
    ``rounds(*pool, *state) -> (*state', steps_used)`` over the
    DPLL_STATE_FIELDS tuple; the state is updated in place.  Status is
    RAW: 0 live, 1 SAT candidate, 2 sound UNSAT, 3 retired-undecided
    (budget/taint bail); ``active`` counts per-lane live sweeps.

    ``sweep_hot`` (with ``tier_period > 1``) scans only the hot clause
    prefix on steps where ``step % tier_period != 0``; SAT completion,
    bulk decisions and the don't-care cascade are gated on full sweeps.
    Because the step number is a host integer here, the full/hot choice
    is made on the host (no device branch); ``dispatch_stats`` counts the
    hot-view steps.
    """
    decisions_on = max_decisions > 0
    tiered = sweep_hot is not None and tier_period > 1

    def rounds(*args):
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        pool, state = args[:3], list(args[3:])
        A, status = state[0], state[_STATUS_IDX]
        out = (_sweep_workspace(B, V, decisions_on, A.device)
               if workspace else None)
        # flags[0]: last step + 1 after which a lane was live; flags[1]:
        # steps in which a lane was live (the JAX loop's count)
        flags = torch.zeros(2, dtype=torch.int32, device=A.device)
        for step in range(budget):
            # the JAX loop tests any(status == 0) before every step; a
            # step on a batch with no live lane changes nothing, so the
            # marker is read back only every SYNC_EVERY steps
            if step % SYNC_EVERY == 0 and not (
                bool((status == 0).any()) if step == 0
                else int(flags[0]) >= step
            ):
                break
            full_view = (not tiered) or step % tier_period == 0
            if not full_view:
                dispatch_stats.hot_view_steps += 1
            outs = (sweep if full_view else sweep_hot)(*pool, A, out)
            dpll_step(state, outs, flags, step, full_view,
                      decisions_on and not full_view, out is not None)
        return (*state, int(flags[1]))

    return rounds


def _dpll_solve_loop(sweep, B, V, steps, max_decisions, workspace=False):
    """One-shot wrapper over :func:`_dpll_round_loop`
    (``pallas_prop.py:_dpll_solve_loop``): zero state in, mapped status
    out (3 = bailed becomes 0 = undecided).  Returns
    ``solve(*pool, A0) -> (A, status, steps_used)`` over the sweep's
    three pool operands; ``A0`` is not written."""
    rounds = _dpll_round_loop(sweep, B, V, steps, max_decisions,
                              workspace=workspace)
    D = max(1, min(max_decisions, V))

    def solve(*args):
        pool, A0 = args[:3], args[3]

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=A0.device)

        i32, f32 = torch.int32, torch.float32
        out = rounds(
            *pool, A0.clone(), z((B, V), i32), z((B, D), i32),
            z((B, D), f32), z((B, D), f32), z((B, D), f32),
            z((B, 1), i32), z((B, 1), i32), z((B, 1), f32),
            z((B, 1), i32),
            z((B, V), f32),  # no warm-start preference
        )
        A, status, steps_used = out[0], out[_STATUS_IDX], out[-1]
        status = torch.where(status == 3, 0, status)  # bailed = undecided
        return A, status, steps_used

    return solve


def make_dense_solve(C: int, V: int, B: int, steps: int,
                     max_decisions: int = MAX_DECISIONS):
    """One-shot DPLL over a shared pool (``pallas_prop.py:
    make_dense_solve``): fn(P[C,V] bf16, N[C,V] bf16, width[1,C] f32,
    A0[B,V] f32) -> (A[B,V] f32, status[B,1] i32, steps_used int) with
    status 2 = UNSAT, 1 = complete assignment for the device clause set
    (the host verifies it), 0 = undecided.  The planes become
    :class:`SweepRows` once, before the loop; its sweeps and steps are
    the kernels of the round loop on the card.  ``max_decisions=0`` runs
    BCP only."""
    scores = max_decisions > 0

    def sweep(indptr, cells, width, A, out):
        return dense_sweep(indptr, cells, width, A, scores, out=out)

    solve_rows = _dpll_solve_loop(sweep, B, V, steps, max_decisions,
                                  workspace=True)

    def solve(P, N, width, A0):
        return solve_rows(*planes_to_rows(P, N, width), A0)

    return solve


def make_batched_solve(C: int, V: int, B: int, steps: int,
                       max_decisions: int = MAX_DECISIONS):
    """One-shot DPLL over per-lane planes (``pallas_prop.py:
    make_batched_solve``): fn(P[B,C,V] f32, N[B,C,V] f32, width[B,C]
    f32, A0[B,V] f32) -> (A, status, steps_used) as
    :func:`make_dense_solve`."""
    sweep = _make_batched_sweep(max_decisions > 0)
    return _dpll_solve_loop(sweep, B, V, steps, max_decisions)


def make_dense_rounds(
    C: int, V: int, B: int, budget: int, tier: Tier,
    max_decisions: int = MAX_DECISIONS, hot_c: int = 0,
    tier_period: int = 1,
):
    """Round function of the union layout: fn(indptr, cells, width,
    *state) -> (*state', steps_used) with RAW status, over the pool's
    :class:`SweepRows`.  Its sweeps go through the CUDA kernel on the
    card.

    ``hot_c > 0`` adds the hot-tier sweep over only the first ``hot_c``
    clause rows (the hot tier packed to the row prefix by the caller)
    and sweeps the full pool every ``tier_period``-th step only."""
    TC = _tile_c(C, V, tier)
    scores = max_decisions > 0

    def sweep(indptr, cells, width, A, out):
        return dense_sweep(indptr, cells, width, A, scores, out=out)

    sweep_hot = None
    if hot_c and tier_period > 1 and TC <= hot_c < C:
        def sweep_hot(indptr, cells, width, A, out):  # noqa: F811
            return dense_sweep(indptr, cells, width, A, scores, rows=hot_c,
                               out=out)

    return _dpll_round_loop(
        sweep, B, V, budget, max_decisions, sweep_hot, tier_period,
        workspace=True,
    )


def make_batched_rounds(
    C: int, V: int, B: int, budget: int,
    max_decisions: int = MAX_DECISIONS, hot_c: int = 0,
    tier_period: int = 1,
):
    """Round function of the per-lane layout (same state contract as
    :func:`make_dense_rounds`).  ``hot_c`` slices the leading rows of
    each lane's plane for the hot-tier sweeps."""
    sweep = _make_batched_sweep(max_decisions > 0)
    sweep_hot = None
    if hot_c and tier_period > 1 and hot_c < C:
        base = sweep

        def sweep_hot(P, N, width, A, out=None):  # noqa: F811
            return base(P[:, :hot_c], N[:, :hot_c], width[:, :hot_c], A)

    return _dpll_round_loop(
        sweep, B, V, budget, max_decisions, sweep_hot, tier_period
    )


def _make_batched_sweep(decisions_on: bool):
    """One batched clause scan over per-lane float32 planes
    ``P/N [B, C, V]`` (``torch.bmm``, TF32 off: 0/1 products and integer
    sums are exact, like the JAX bf16-in/f32-out dots).  The sweep takes
    no workspace (``out`` is always None): its results are fresh."""

    def sweep(P, N, width, A, out=None):
        pos = A.clamp(min=0.0)[:, None, :]               # [B,1,V]
        neg = (-A).clamp(min=0.0)[:, None, :]
        Pt, Nt = P.transpose(1, 2), N.transpose(1, 2)    # [B,V,C]
        true_cnt = (torch.bmm(pos, Pt) + torch.bmm(neg, Nt))[:, 0]  # [B,C]
        false_cnt = (torch.bmm(neg, Pt) + torch.bmm(pos, Nt))[:, 0]
        real = width > 0.5
        all_false = real & (false_cnt > width - 0.5)
        unk_cnt = width - true_cnt - false_cnt
        unsat_yet = (true_cnt < 0.5) & real
        u = (unsat_yet & (unk_cnt > 0.5) & (unk_cnt < 1.5)).float()
        u = u[:, None, :]                                # [B,1,C]
        fpos = torch.bmm(u, P)[:, 0]
        fneg = torch.bmm(u, N)[:, 0]
        conf = all_false.any(dim=1, keepdim=True).float()
        if decisions_on:
            o = (unsat_yet & (unk_cnt > 1.5)).float()[:, None, :]
            return fpos, fneg, conf, torch.bmm(o, P)[:, 0], torch.bmm(o, N)[:, 0]
        return fpos, fneg, conf

    return sweep


def _lane_incidence(B, C, V, coords_pos, coords_neg, device):
    """Per-lane planes [B, C, V] (float32 for the bmm sweep) from
    (lane, row, col) coordinate triples; returns (P, N, n_pos, n_neg)."""
    n_pos = _bucket(max(1, len(coords_pos[0])), floor=256)
    n_neg = _bucket(max(1, len(coords_neg[0])), floor=256)
    P = _incidence((B, C, V), coords_pos, n_pos, torch.float32, device)
    N = _incidence((B, C, V), coords_neg, n_neg, torch.float32, device)
    return P, N, n_pos, n_neg


def _run_dense_ladder(
    round_fn,
    operands,
    A0: np.ndarray,
    n_real: int,
    max_decisions: int,
    steps_total: int,
    tier: Tier,
    device,
    hot_c: int = 0,
    lane_floor: int = 8,
    compact_planes=None,
    grow_hot=None,
    pref_row=None,
):
    """Host loop of the round ladder over a dense solve.

    Runs ``round_fn(B, budget, hot_c)`` for the geometric budget
    sequence; between rounds decided lanes are retired (their final
    assignment captured), survivors are compacted to the bucket prefix
    and re-packed into the smallest lane bucket that fits.

    - ``operands`` (the union pool's :class:`SweepRows`, or the
      per-lane planes) are passed to the round function verbatim;
      ``compact_planes(operands, idx)`` re-gathers per-lane planes on
      lane compaction (None for the lane-shared union pool).
    - ``grow_hot(live_A, hot_c) -> (operands, hot_c) | None`` folds the
      round's trail into the hot tier (union layout).

    Telemetry lands on DispatchStats: ``rounds``, ``repacks``,
    ``device_sweeps``, ``lane_sweeps_total`` and ``lane_sweeps_active``.

    Returns (status[n_real] int32 with bails mapped to 0, final
    A[n_real, V] float32).
    """
    from mythril_tpu_torch.observability import spans as obs
    from mythril_tpu_torch.ops.batched_sat import dispatch_stats
    from mythril_tpu_torch.resilience import faults
    from mythril_tpu_torch.resilience.checkpoint import drain_requested
    from mythril_tpu_torch.resilience.watchdog import raise_if_cancelled

    B, V = A0.shape
    D = max(1, min(max_decisions, V))
    state = _dpll_state0(A0, D, n_real, device, pref_row)
    dispatch_stats.h2d_bytes += int(A0.nbytes)
    statuses_out = np.zeros(n_real, np.int32)
    A_out = np.zeros((n_real, V), np.float32)
    live = np.arange(n_real)

    def commit(local_rows, st, act, A_host):
        total = 0
        for local in local_rows:
            statuses_out[live[local]] = st[local]
            A_out[live[local]] = A_host[local]
            total += int(act[local])
        return total

    for budget in _ladder_budgets(steps_total, tier):
        if live.size == 0:
            break
        # cooperative checkpoints: the ladder runs inside one supervised
        # dispatch, so an abandoned worker stops here before touching
        # shared state again, and a drain retires the survivors
        raise_if_cancelled()
        if drain_requested():
            obs.instant("pallas.drain", cat="sweep",
                        lanes=int(live.size), bucket=B)
            break
        faults.maybe_fault_dispatch()
        fn = round_fn(B, budget, hot_c)
        dispatch_stats.device_dispatch_calls += 1
        dispatch_stats.dense_round_budgets[budget] = (
            dispatch_stats.dense_round_budgets.get(budget, 0) + 1)
        with record_function("dense.round"):
            out = fn(*operands, *state)
        state, steps_used = list(out[:-1]), out[-1]
        dispatch_stats.rounds += 1
        dispatch_stats.device_sweeps += steps_used
        dispatch_stats.lane_sweeps_total += steps_used * B
        st = state[_STATUS_IDX][:, 0].cpu().numpy()
        done = st[: live.size] != 0
        if not done.any() and grow_hot is None:
            continue
        A_host = state[0].cpu().numpy()
        if done.any():
            act = state[_ACTIVE_IDX][:, 0].cpu().numpy()
            dispatch_stats.lane_sweeps_active += commit(
                np.nonzero(done)[0], st, act, A_host
            )
            keep = np.nonzero(~done)[0]
            if keep.size == 0:
                live = keep
                break
            live = live[keep]
            B_new = max(
                lane_floor, _bucket(int(keep.size), floor=lane_floor)
            )
            idx = np.concatenate(
                [keep, np.repeat(keep[:1], B_new - keep.size)]
            )
            index = torch.from_numpy(idx).to(device)
            new_state = [a.index_select(0, index) for a in state]
            new_state[_STATUS_IDX][keep.size:] = 3  # pads stay inert
            if B_new < B:
                dispatch_stats.repacks += 1
            B = B_new
            state = new_state
            if compact_planes is not None:
                operands = compact_planes(operands, index)
        else:
            keep = np.arange(live.size)
        if grow_hot is not None:
            grown = grow_hot(A_host[keep], hot_c)
            if grown is not None:
                operands, hot_c = grown
    if live.size:
        st = state[_STATUS_IDX][:, 0].cpu().numpy()
        act = state[_ACTIVE_IDX][:, 0].cpu().numpy()
        A_host = state[0].cpu().numpy()
        dispatch_stats.lane_sweeps_active += commit(
            range(live.size), st, act, A_host
        )
    return np.where(statuses_out == 3, 0, statuses_out), A_out


class DenseSatBackend:
    """Drives the dense tier over per-call cone problems (counterpart of
    ``PallasSatBackend``); verdict contract: False = sound UNSAT,
    None = the host verifies the returned assignment or falls back to
    the CDCL.  Runs on ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(self, device=None):
        self.device = default_device(device)
        self.tier = tier_for(self.device)
        #: layout and (C, V, B) shape of the last dispatch (telemetry)
        self.last_layout: Optional[str] = None
        self.last_shape: Optional[Tuple[int, int, int]] = None

    def available_for(self, ctx) -> bool:
        return dense_enabled()

    def check_assumption_sets(
        self, ctx, assumption_sets: List[List[int]]
    ) -> Optional[Tuple[List[Optional[bool]], np.ndarray]]:
        """None when no dense layout fits the tier's caps, or when the
        frontier is delegated to the resident solver (the caller tries
        the gather tiers next).

        Two layouts compete per dispatch, picked by estimated streamed
        cells: **union** (one [C, V] pool over the union cone, all lanes
        sweep it together — sibling forks of one path) and **per-lane**
        (each lane remapped into its own compact space, planes
        [B, C_max, V_max] — mostly disjoint cones).  Cones past the
        tier's decision-stack budget run BCP-only (sound UNSAT detection
        still on)."""
        from mythril_tpu_torch.ops.device_health import check_device

        check_device()
        if not assumption_sets:
            return [], np.zeros((0, ctx.solver.num_vars + 1), np.int8)
        from mythril_tpu_torch.ops.incremental import get_cone_memo

        tier = self.tier
        memo = get_cone_memo()
        with record_function("dense.cones"):
            lane_cones = [memo.cone(ctx, lits) for lits in assumption_sets]
        batch = len(assumption_sets)
        union_ci = np.unique(np.concatenate([ci for ci, _ in lane_cones]))
        union_cv = np.unique(np.concatenate([cv for _, cv in lane_cones]))
        union_C = _bucket(max(1, len(union_ci)))
        union_V = _bucket(len(union_cv) + 2)
        # with the resident solver on, a union cone within the cone-tier
        # caps goes to the gather tiers instead (the JAX package's
        # delegation, pallas_prop.py:1234-1247): its rows path drops
        # clauses wider than the width cap, which weakens BCP but never
        # a verdict; larger cones keep the dense ladder
        from mythril_tpu_torch.ops.batched_sat import (
            MAX_CONE_GATHER_CLAUSES, MAX_CONE_GATHER_VARS, dispatch_stats,
        )
        from mythril_tpu_torch.ops.resident import resident_kernel_enabled

        if (
            resident_kernel_enabled()
            and 0 < len(union_ci) <= MAX_CONE_GATHER_CLAUSES
            and len(union_cv) <= MAX_CONE_GATHER_VARS
        ):
            dispatch_stats.resident_delegations += 1
            return None
        max_C = _bucket(max(1, max(len(ci) for ci, _ in lane_cones)))
        max_V = _bucket(2 + max(len(cv) for _, cv in lane_cones))
        B_bucket = max(8, _bucket(batch, floor=8))

        union_chunks = -(-batch // max(
            1, min(MAX_LANES, tier.lane_cells // union_V)
        ))
        est_union = union_C * union_V * union_chunks
        est_batched = B_bucket * max_C * max_V * tier.batched_cost
        union_ok = DenseClausePool.fits(
            len(union_ci), len(union_cv) + 1, tier
        )
        batched_ok = DenseClausePool.fits_lane(max_C, max_V, tier)
        if not union_ok and not batched_ok:
            log.debug(
                "no dense layout fits (union %dx%d, per-lane %dx%d)",
                union_C, union_V, max_C, max_V,
            )
            dispatch_stats.dense_declines += 1
            caps = (f"union {_over_caps(union_C, union_V, 1, tier)}; "
                    f"per-lane {_over_caps(max_C, max_V, 2, tier)}")
            dispatch_stats.dense_decline_caps[caps] = (
                dispatch_stats.dense_decline_caps.get(caps, 0) + 1)
            return None

        use_batched = batched_ok and (
            not union_ok or est_batched < est_union
        )
        if use_batched:
            statuses, assignments = self._solve_batched(
                ctx, assumption_sets, lane_cones, max_C, max_V,
            )
        else:
            statuses, assignments = self._solve_union(
                ctx, assumption_sets, union_ci, union_cv,
            )
        from mythril_tpu_torch.resilience import faults

        statuses, assignments = faults.maybe_corrupt_lanes(statuses,
                                                           assignments)
        results: List[Optional[bool]] = [
            False if statuses[i] == 2 else None for i in range(batch)
        ]
        return results, assignments

    def _solve_union(self, ctx, assumption_sets, clause_idx, cone_vars):
        """Union-cone layout: one shared pool of C clause rows over V
        columns (:class:`SweepRows`), solved
        through the round ladder with tiered hot/cold sweeps: hot rows —
        narrow clauses plus rows touched by the assumption frontier,
        grown with each round's trail — are packed to the row prefix and
        swept every step; the cold remainder joins every TIER_PERIOD-th
        sweep.  The first round always sweeps the full cone."""
        from mythril_tpu_torch.ops.batched_sat import (
            dispatch_stats, tier_span, warm_pref_row,
        )
        from mythril_tpu_torch.ops.frontier import (
            LitAdjacency, frontier_enabled,
        )
        from mythril_tpu_torch.ops.incremental import get_cone_memo

        tier = self.tier
        num_cone_vars = len(cone_vars) + 1
        batch = len(assumption_sets)
        assignments = np.zeros((batch, ctx.solver.num_vars + 1), np.int8)
        assignments[:, 1] = 1

        digest = (int(clause_idx.size), zlib.crc32(clause_idx.tobytes()))
        with record_function("dense.remap"):
            urow, ulit, width_arr = get_cone_memo().get_or_build(
                ctx, ("union_remap", digest),
                lambda: remap_cone_csr(ctx, clause_idx, cone_vars),
            )
        n_rows = len(clause_idx)
        seed_lists = [
            np.abs(assumption_columns(cone_vars, lits))
            for lits in assumption_sets if lits
        ]
        seed_cols = (
            np.unique(np.concatenate(seed_lists))
            if seed_lists else np.empty(0, np.int64)
        )
        C = _bucket(max(1, n_rows))
        V = _bucket(num_cone_vars + 1)
        TC = _tile_c(C, V, tier)
        tier_period = _tier_period()
        tier_on = tier_period > 1
        hot_mask = (
            _hot_row_mask(urow, ulit, width_arr, seed_cols)
            if tier_on else np.zeros(len(width_arr), dtype=bool)
        )
        hot_c = 0  # engaged by grow_hot once a trail exists
        pool = DenseClausePool(self.device)
        with record_function("dense.rows"):
            pool.refresh_coords(urow, ulit, width_arr, n_rows, num_cone_vars)
        inverse = np.zeros(pool.V, dtype=np.int64)
        inverse[1] = 1
        inverse[2 : 2 + len(cone_vars)] = cone_vars

        V = pool.V
        statuses = np.zeros(batch, dtype=np.int32)
        chunk_lanes = max(8, min(MAX_LANES, tier.lane_cells // V))
        decisions = (
            MAX_DECISIONS if V <= tier.dpll_max_vars else 0
        )
        pref_row = (
            warm_pref_row(ctx, V, cone_vars=cone_vars, offset=2,
                          lanes=batch, dtype=np.float32)
            if decisions else None
        )

        def round_fn(Bc, round_budget, hot_rows):
            return make_dense_rounds(
                pool.C, V, Bc, round_budget, tier, decisions, hot_rows,
                tier_period,
            )

        self.last_layout = "union"
        for start in range(0, batch, chunk_lanes):
            chunk = assumption_sets[start : start + chunk_lanes]
            n = len(chunk)
            B = max(8, _bucket(n, floor=8))
            self.last_shape = (pool.C, V, B)
            A0 = np.zeros((B, V), dtype=np.float32)
            A0[:, 1] = 1.0  # constant-TRUE anchor
            # bucket-padding columns occur in no clause: preassigned
            A0[:, num_cone_vars + 1:] = 1.0
            A0[n:, :] = 1.0  # pad lanes fully assigned (and retired)
            for lane, lits in enumerate(chunk):
                cols = assumption_columns(cone_vars, lits)
                A0[lane, np.abs(cols)] = np.where(cols > 0, 1.0, -1.0)
            seeded = np.any(A0[:n] != 0.0, axis=0)
            # layout state the trail growth mutates (carried across
            # chunks); ``rowmap`` tracks original->current row ids for
            # the adjacency index, ``seen`` is the cross-round frontier
            layout = {"urow": urow, "width": width_arr, "hot": hot_mask,
                      "rowmap": np.arange(len(width_arr), dtype=np.int64),
                      "seen": seeded.copy()}
            adj_index = (
                LitAdjacency(urow, ulit, len(width_arr))
                if (tier_on and frontier_enabled() and len(ulit))
                else None
            )

            def grow_hot(live_A, hot_cur):
                """Fold the round trail (columns newly assigned by any
                survivor) into the hot tier, rebuilding the hot-first
                layout only when the hot bucket actually grows."""
                if not len(ulit):
                    return None
                mask = layout["hot"]
                if adj_index is not None:
                    fresh = np.nonzero(
                        np.any(np.abs(live_A) > 0.5, axis=0)
                        & ~layout["seen"]
                    )[0]
                    if fresh.size:
                        layout["seen"] = layout["seen"].copy()
                        layout["seen"][fresh] = True
                        touched = adj_index.rows_for_vars(fresh)
                        if touched.size:
                            mask = mask.copy()
                            mask[layout["rowmap"][touched]] = True
                            layout["hot"] = mask
                else:
                    trail = np.nonzero(
                        np.any(np.abs(live_A) > 0.5, axis=0) & ~seeded
                    )[0]
                    if trail.size:
                        hit = np.isin(
                            np.abs(ulit.astype(np.int64)), trail
                        )
                        mask = mask.copy()
                        mask[np.unique(layout["urow"][hit])] = True
                        layout["hot"] = mask
                new_hot_c = _bucket(max(1, int(mask.sum())), floor=TC)
                if new_hot_c <= hot_cur or new_hot_c * 2 > C:
                    return None
                order2, new_pos2 = _hot_first_perm(mask)
                layout["urow"] = new_pos2[layout["urow"]]
                layout["width"] = layout["width"][order2]
                layout["hot"] = mask[order2]
                layout["rowmap"] = new_pos2[layout["rowmap"]]
                pool.refresh_coords(
                    layout["urow"], ulit, layout["width"], n_rows,
                    num_cone_vars,
                )
                return pool.rows, new_hot_c

            with tier_span("dense_rounds", "dense.rounds"):
                st_out, A_host = _run_dense_ladder(
                    round_fn, pool.rows, A0,
                    n, decisions, tier.steps, tier, self.device,
                    hot_c=hot_c, lane_floor=8,
                    grow_hot=grow_hot if tier_on else None,
                    pref_row=pref_row,
                )
            urow, width_arr, hot_mask = (
                layout["urow"], layout["width"], layout["hot"]
            )
            dispatch_stats.lane_slots_filled += n
            dispatch_stats.lane_slots_total += B
            statuses[start : start + n] = st_out
            # map cone columns back to original variable ids
            signs = np.sign(A_host).astype(np.int8)
            for lane in range(n):
                assignments[start + lane, inverse[1:num_cone_vars + 1]] = (
                    signs[lane, 1 : num_cone_vars + 1]
                )
        return statuses, assignments

    def _solve_batched(self, ctx, assumption_sets, lane_cones, max_C, max_V):
        """Per-lane-cone layout: [B, C, V] planes, batched products,
        driven through the round ladder (lane retirement compacts the
        per-lane planes too).  No tier split here."""
        from mythril_tpu_torch.ops.batched_sat import (
            dispatch_stats, tier_span, warm_pref_row,
        )
        from mythril_tpu_torch.ops.incremental import get_cone_memo

        tier = self.tier
        batch = len(assumption_sets)
        assignments = np.zeros((batch, ctx.solver.num_vars + 1), np.int8)
        assignments[:, 1] = 1
        statuses = np.zeros(batch, dtype=np.int32)

        lanes_budget = max(1, 2 * tier.max_cells // (max_C * max_V))
        # floor to a power of two so the bucketed B never exceeds the
        # budget the chunk was sized for
        chunk_lanes = 1
        while chunk_lanes * 2 <= min(MAX_LANES, lanes_budget):
            chunk_lanes *= 2
        decisions = (
            MAX_DECISIONS if max_V <= tier.dpll_max_vars else 0
        )
        memo = get_cone_memo()
        self.last_layout = "per-lane"

        for start in range(0, batch, chunk_lanes):
            chunk = assumption_sets[start : start + chunk_lanes]
            chunk_cones = lane_cones[start : start + chunk_lanes]
            B = _bucket(len(chunk), floor=min(8, chunk_lanes))
            lane_floor = min(8, chunk_lanes)
            self.last_shape = (max_C, max_V, B)
            A0 = np.zeros((B, max_V), dtype=np.float32)
            A0[:, 1] = 1.0
            A0[len(chunk):, :] = 1.0  # pad lanes fully assigned
            width = np.zeros((B, max_C), dtype=np.float32)
            pref_plane = np.zeros((B, max_V), dtype=np.float32)
            pref_seeded = False
            pos_parts = ([], [], [])
            neg_parts = ([], [], [])
            inverses = []
            for lane, (lits, (ci, cv)) in enumerate(zip(chunk, chunk_cones)):
                inverse = np.zeros(len(cv) + 2, dtype=np.int64)
                inverse[1] = 1
                inverse[2:] = cv
                inverses.append(inverse)
                A0[lane, len(cv) + 2:] = 1.0  # per-lane padding cols
                if decisions:
                    row = warm_pref_row(
                        ctx, max_V, cone_vars=cv, offset=2, lanes=1,
                        dtype=np.float32,
                    )
                    if row is not None:
                        pref_plane[lane] = row
                        pref_seeded = True
                urow, ulit, width_arr = memo.get_or_build(
                    ctx, ("lane_remap", tuple(sorted(lits))),
                    lambda ci=ci, cv=cv: remap_cone_csr(ctx, ci, cv),
                )
                width[lane, : len(ci)] = width_arr
                pos = ulit > 0
                for parts, sel, sign in ((pos_parts, pos, 1),
                                         (neg_parts, ~pos, -1)):
                    parts[0].append(np.full(int(sel.sum()), lane, np.int64))
                    parts[1].append(urow[sel])
                    parts[2].append(sign * ulit[sel])
                cols = assumption_columns(cv, lits)
                A0[lane, np.abs(cols)] = np.where(cols > 0, 1.0, -1.0)
            coords_pos, coords_neg = (
                tuple(np.concatenate(axis) if axis else np.empty(0, np.int64)
                      for axis in parts)
                for parts in (pos_parts, neg_parts)
            )
            P, N, n_pos, n_neg = _lane_incidence(
                B, max_C, max_V, coords_pos, coords_neg, self.device
            )
            dispatch_stats.h2d_bytes += (
                4 * 3 * (n_pos + n_neg) + int(width.nbytes)
            )
            W = torch.from_numpy(width).to(self.device)

            def round_fn(Bc, round_budget, hot_rows):
                return make_batched_rounds(
                    max_C, max_V, Bc, round_budget, decisions,
                )

            def compact_planes(planes, index):
                return tuple(p.index_select(0, index) for p in planes)

            n = len(chunk)
            with tier_span("dense_rounds", "dense.rounds"):
                st_out, A_host = _run_dense_ladder(
                    round_fn, (P, N, W), A0, n, decisions, tier.steps, tier,
                    self.device, lane_floor=lane_floor,
                    compact_planes=compact_planes,
                    pref_row=pref_plane if pref_seeded else None,
                )
            dispatch_stats.lane_slots_filled += n
            dispatch_stats.lane_slots_total += B
            statuses[start : start + n] = st_out
            signs = np.sign(A_host).astype(np.int8)
            for lane in range(n):
                inverse = inverses[lane]
                assignments[start + lane, inverse[1:]] = (
                    signs[lane, 1 : len(inverse)]
                )
        return statuses, assignments


_backends = {}


def get_dense_backend(device=None) -> DenseSatBackend:
    """Process-wide backend per device."""
    dev = default_device(device)
    backend = _backends.get(dev)
    if backend is None:
        backend = _backends[dev] = DenseSatBackend(dev)
    return backend
