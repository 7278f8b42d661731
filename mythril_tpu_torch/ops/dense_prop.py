"""Dense clause-incidence DPLL for batched SAT (PyTorch port of
``mythril_tpu/ops/pallas_prop.py``; the module is renamed because there
is no Pallas here).

Clause evaluation is reformulated over dense *clause-incidence planes*:

- ``P[c, v] = 1`` iff variable ``v`` occurs positively in clause ``c``
  (``N`` likewise for negative occurrences), stored bf16.
- With the assignment ``A[b, v] ∈ {-1, 0, +1}`` (f32) one sweep counts
  satisfied and falsified literals per (lane, clause), classifies each
  clause as conflicting / unit / open, and returns forced-literal votes
  and open-clause decision scores per (lane, variable).  On the card the
  union layout's sweep is the hand-written CUDA kernel in
  ``ops/dense_sweep.py`` (``csrc/dense_sweep.cu``); the per-lane layout
  sweeps with float32 ``torch.bmm`` (the JAX package leaves that one to
  XLA's batched dots).

Around one sweep per step runs a batched DPLL search: per-lane trail
levels and an explicit decision stack, dynamic DLIS decisions (with
bulk top-K levels past a single-var window and the don't-care cascade),
chronological backtracking, and tiered hot/cold sweeping.  The control
loop is eager torch; it reads the "any lane live" flag back to the host
only every :data:`SYNC_EVERY` steps (extra steps on a batch with no live
lane are no-ops, and ``steps_used`` counts exactly the steps the JAX
``while_loop`` runs).

Soundness contract (unchanged from the JAX package): UNSAT only from a
BCP conflict with zero decisions or an exhausted untainted search, both
sound under clause subsets; SAT only after host-side verification of
the concrete model.  Undecided lanes fall back to the native CDCL.

Device tiers: on ``cpu`` the port uses the JAX package's interpret-tier
budgets and caps, so the CPU tests compare like with like against
``interpret=True``; on ``cuda`` it keeps the algorithmic budgets and
re-derives the size caps for an 80 GB card (see :data:`CUDA_TIER`).
Dropped from this slice: the resident-kernel delegation, the resilience
hooks (fault injection, watchdog supervision, cancellation and drain
checkpoints) and the observability spans.
"""

import logging
import zlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mythril_tpu_torch.ops import default_device
from mythril_tpu_torch.ops.dense_sweep import dense_sweep
from mythril_tpu_torch.support.env import env_flag, env_int

log = logging.getLogger(__name__)


class Tier(NamedTuple):
    """Size caps and budgets of one device tier.

    ``max_vars``/``max_clauses``/``max_cells`` cap the bucketed union
    planes; ``lane_cells`` caps the [B, V] state planes per chunk;
    ``batched_cost`` weighs a per-lane cell against a union cell when
    the two layouts compete (streamed bytes per cell and sweep)."""

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
#: HBM and VMEM; here the planes live in the H100's 80 GB of device
#: memory and no [B, V] plane has to stay in on-chip memory:
#: - union planes up to 2^28 cells: two bf16 planes of 1 GiB, so one
#:   sweep reads at most 1 GiB (≈ 0.32 ms at 3.35 TB/s) and a 4096-step
#:   search stays in seconds; C and V keep the TPU tier's power-of-two
#:   ceilings (the search itself is limited by DPLL_MAX_VARS anyway);
#: - [B, V] state planes up to 2^22 cells (16 MiB per f32 plane), so the
#:   lane chunk is MAX_LANES wide up to V = 65536;
#: - a per-lane cell costs 8 union cells: those planes are float32 (4 B)
#:   and swept by four bmm passes of two planes, against one pass of two
#:   bf16 planes in the union kernel (32 B vs 4 B per cell).
#: The DPLL budgets are the algorithmic ones of pallas_prop.py:107-129.
CUDA_TIER = Tier("cuda", 1 << 14, 1 << 17, 1 << 28, 1 << 22, 4096, 8192,
                 (64, 256, 1024), 8)

MAX_LANES = 64               # per-chunk lane cap
MAX_DECISIONS = 1024
# chunked decisions: after DPLL_SINGLE_WINDOW single-var levels, each
# level assigns the top-K scoring free vars at once (a conflict that
# backtracks into a bulk level taints the lane: its exhaustion is no
# longer a refutation)
DPLL_SINGLE_WINDOW = 8
DPLL_BULK_K = 16
# tiered cone sweeping: the hot tier is swept every step, the cold
# remainder joins every TIER_PERIOD-th sweep (the verdict-bearing
# transitions are gated on full sweeps)
TIER_PERIOD = 8
HOT_WIDTH = 3  # clauses at most this wide are always hot (unit fuel)
#: the eager loop reads the live flag back every SYNC_EVERY steps
SYNC_EVERY = 16


def tier_for(device) -> Tier:
    return CPU_TIER if torch.device(device).type == "cpu" else CUDA_TIER


def dense_enabled() -> bool:
    """``MYTHRIL_TPU_DENSE=0`` switches the dense tier off (the funnel
    then hands every lane to the CDCL tail)."""
    return env_flag("MYTHRIL_TPU_DENSE", True)


def _bucket(n: int, floor: int = 128) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def _tier_period() -> int:
    """Cold-sweep period (``MYTHRIL_TPU_TIER_PERIOD``; <= 1 disables the
    tier split)."""
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
    has no tile rule (one block per clause row): its granule is the
    same power-of-two floor of 128 rows, never above C."""
    if tier.name == "cpu":
        return min(C, max(128, min(256, (1 << 19) // V)))
    return min(C, 128)


def _pad_coords(values, size: int) -> np.ndarray:
    """Pad a coordinate list to its bucket with zero writes — cell
    (0, 0) is row 0 x column 0, and column 0 is never a variable, so a
    spurious 1 there never changes counts (A[:, 0] stays 0 in live
    lanes) and forced votes/scores for column 0 are masked off by
    ``col > 1``."""
    arr = np.zeros(size, dtype=np.int64)
    arr[: len(values)] = values
    return arr


class DenseClausePool:
    """Dense incidence planes over an explicit clause list, on one
    device."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.P = None       # [C, V] bf16
        self.N = None
        self.width = None   # [1, C] f32
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
        """Build the incidence planes from deduped (row, literal)
        coordinates: the host ships only the coordinates, the planes are
        scattered on the device (``index_put_`` into zeroed planes)."""
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        C = _bucket(max(1, n_rows))
        V = _bucket(num_vars + 1)
        width = np.zeros((1, C), dtype=np.float32)
        width[0, :n_rows] = width_arr
        pos = ulit > 0
        n_pos = _bucket(max(1, int(pos.sum())), floor=256)
        n_neg = _bucket(max(1, int((~pos).sum())), floor=256)
        dispatch_stats.h2d_bytes += 4 * 2 * (n_pos + n_neg) + int(width.nbytes)
        self.P = _incidence(
            (C, V), (urow[pos], ulit[pos]), n_pos, torch.bfloat16,
            self.device,
        )
        self.N = _incidence(
            (C, V), (urow[~pos], -ulit[~pos]), n_neg, torch.bfloat16,
            self.device,
        )
        self.width = torch.from_numpy(width).to(self.device)
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


def _top_k(score: torch.Tensor, k: int):
    """``lax.top_k`` semantics: the k largest per row, ties in ascending
    index order (a stable descending sort; ``torch.topk`` promises no tie
    order on the card)."""
    vals, idxs = torch.sort(score, dim=1, descending=True, stable=True)
    return vals[:, :k], idxs[:, :k]


def _dpll_round_loop(sweep, B, V, budget, max_decisions, sweep_hot=None,
                     tier_period=1):
    """Resumable DPLL control loop around a sweep callable
    (``mythril_tpu/ops/pallas_prop.py:_dpll_round_loop`` in eager
    torch).

    ``sweep(P, N, width, A)`` returns (fpos, fneg, conf[, spos, sneg]).
    Returns ``rounds(P, N, width, *state) -> (*state', steps_used)``
    over the DPLL_STATE_FIELDS tuple.  Status is RAW: 0 live, 1 SAT
    candidate, 2 sound UNSAT, 3 retired-undecided (budget/taint bail);
    ``active`` counts per-lane live sweeps.

    ``sweep_hot`` (with ``tier_period > 1``) scans only the hot clause
    prefix on steps where ``step % tier_period != 0``; SAT completion,
    bulk decisions and the don't-care cascade are gated on full sweeps.
    Because the step number is a host integer here, the full/hot choice
    is made on the host (no device branch).
    """
    decisions_on = max_decisions > 0
    D = max(1, min(max_decisions, V))
    tiered = sweep_hot is not None and tier_period > 1

    def rounds(P, N, width, A, lvl, dvar, dphase, dflip, dbulk, depth,
               status, taint, sweeps, pref):
        dev = A.device
        col = torch.arange(V, dtype=torch.int32, device=dev)[None, :]
        dcol = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
        krow = torch.arange(DPLL_BULK_K, device=dev)[None, :]
        steps_used = torch.zeros((), dtype=torch.int32, device=dev)
        step = 0
        while step < budget:
            # the JAX loop tests any(status == 0) before every step; a
            # step on a batch with no live lane changes nothing, so the
            # flag is read back only every SYNC_EVERY steps and
            # steps_used counts the live ones
            if step % SYNC_EVERY == 0 and not bool((status == 0).any()):
                break
            full_view = (not tiered) or step % tier_period == 0
            outs = (sweep if full_view else sweep_hot)(P, N, width, A)
            if decisions_on:
                fpos, fneg, conf, spos, sneg = outs
            else:
                fpos, fneg, conf = outs
            active = status == 0                           # [B,1]
            steps_used += active.any().to(torch.int32)
            free = (A == 0.0) & (col > 1)  # col 1 = constant-TRUE anchor
            force_pos = (fpos > 0.5) & free
            force_neg = (fneg > 0.5) & free
            contra = (force_pos & force_neg).any(dim=1, keepdim=True)
            conflict = (conf > 0.5) | contra
            has_force = (force_pos | force_neg).any(dim=1, keepdim=True)
            open_any = free.any(dim=1, keepdim=True)

            # --- conflict: backtrack to the deepest unflipped decision
            held = dcol < depth
            unflipped = held & (dflip < 0.5)
            Lm = torch.where(unflipped, dcol + 1, 0).amax(
                dim=1, keepdim=True
            )                                              # 0 = none
            unsat_now = active & conflict & (Lm == 0)
            do_bt = active & conflict & (Lm > 0)
            bslot = (Lm - 1).clamp(min=0).long()
            bvar = dvar.gather(1, bslot)
            bphase = -dphase.gather(1, bslot)
            A1 = torch.where(do_bt & (A != 0.0) & (lvl >= Lm), 0.0, A)
            at_bvar = do_bt & (col == bvar)
            A1 = torch.where(at_bvar, bphase, A1)
            lvl1 = torch.where(at_bvar, Lm, lvl)
            popped = do_bt & (dcol >= Lm)
            at_b = do_bt & (dcol == bslot)
            bulk_popped = (popped & (dbulk > 0.5)).any(
                dim=1, keepdim=True
            ) | (dbulk.gather(1, bslot) > 0.5)
            taint1 = torch.where(do_bt & bulk_popped, 1.0, taint)
            dvar1 = torch.where(popped, 0, dvar)
            dphase1 = torch.where(
                popped, 0.0, torch.where(at_b, bphase, dphase)
            )
            dflip1 = torch.where(popped, 0.0, torch.where(at_b, 1.0, dflip))
            dbulk1 = torch.where(popped | at_b, 0.0, dbulk)
            depth1 = torch.where(do_bt, Lm, depth)

            # --- no conflict, forced literals: assign at this level
            do_force = active & ~conflict & has_force
            forced = force_pos | force_neg
            assigned_now = do_force & forced & ~(force_pos & force_neg)
            delta = torch.where(force_pos, 1.0, -1.0)
            A2 = torch.where(assigned_now, delta, A1)
            lvl2 = torch.where(assigned_now, depth, lvl1)

            # --- decide at BCP quiescence (dynamic DLIS var + polarity)
            want = active & ~conflict & open_any & ~has_force
            if decisions_on and tiered and not full_view:
                # hot-quiescence gate: no open HOT clause to score means
                # waiting for the full-cone sweep
                want = want & (spos + sneg > 0.5).any(dim=1, keepdim=True)
            if decisions_on:
                can = depth < D
                in_bulk = (depth >= DPLL_SINGLE_WINDOW) & full_view
                do_dec = want & can
                bail = want & ~can
                score = torch.where(free & ~forced, spos + sneg + 1.0, -1.0)
                vals, idxs = _top_k(score, DPLL_BULK_K)     # [B,K]
                keep = (vals > 0.0) & ((krow == 0) | in_bulk)
                do_dec = do_dec & keep.any(dim=1, keepdim=True)
                # top-k indices are distinct per row, so the scatter
                # equals the JAX any-over-K membership test
                chosen = torch.zeros_like(free).scatter_(1, idxs, keep)
                ph_full = torch.where(
                    pref != 0.0, pref, torch.where(spos >= sneg, 1.0, -1.0)
                )
                primary = idxs[:, :1]
                phase = ph_full.gather(1, primary)
                real_keep = keep & (vals > 1.5)
                is_bulk = (
                    real_keep.to(torch.int32).sum(dim=1, keepdim=True) > 1
                ).to(torch.float32)
                ndepth = depth + 1
                # don't-care cascade (full-view sweeps only)
                dontcare = free & ~forced & (spos + sneg < 0.5) & full_view
                newly = do_dec & (dontcare | chosen)
                A3 = torch.where(
                    newly, torch.where(chosen, ph_full, 1.0), A2
                )
                lvl3 = torch.where(newly, ndepth, lvl2)
                at_new = do_dec & (dcol == depth)
                dvar2 = torch.where(at_new, primary.to(torch.int32), dvar1)
                dphase2 = torch.where(at_new, phase, dphase1)
                dflip2 = torch.where(at_new, 0.0, dflip1)
                dbulk2 = torch.where(at_new, is_bulk, dbulk1)
                depth2 = torch.where(do_dec, ndepth, depth1)
            else:
                bail = want
                A3, lvl3 = A2, lvl2
                dvar2, dphase2, dflip2, depth2 = dvar1, dphase1, dflip1, depth1
                dbulk2 = dbulk1

            # --- quiet and complete on a full view: SAT candidate
            done_sat = active & ~conflict & ~has_force & ~open_any \
                & full_view
            # tainted exhaustion is NOT a refutation — report undecided
            status1 = torch.where(
                unsat_now, 2 + (taint1 > 0.5).to(torch.int32), status
            )
            status1 = torch.where(done_sat, 1, status1)
            status1 = torch.where(bail, 3, status1)  # 3 = budget-bailed
            sweeps = sweeps + active.to(torch.int32)
            A, lvl, dvar, dphase, dflip, dbulk, depth = (
                A3, lvl3, dvar2, dphase2, dflip2, dbulk2, depth2
            )
            status, taint = status1, taint1
            step += 1
        return (A, lvl, dvar, dphase, dflip, dbulk, depth, status, taint,
                sweeps, pref, int(steps_used))

    return rounds


def make_dense_rounds(
    C: int, V: int, B: int, budget: int, tier: Tier,
    max_decisions: int = MAX_DECISIONS, hot_c: int = 0,
    tier_period: int = 1,
):
    """Round function of the union layout: fn(P, N, width, *state) ->
    (*state', steps_used) with RAW status.  Its sweeps go through the
    CUDA kernel on the card.

    ``hot_c > 0`` adds the hot-tier sweep over only the first ``hot_c``
    clause rows (the hot tier packed to the row prefix by the caller)
    and sweeps the full pool every ``tier_period``-th step only."""
    TC = _tile_c(C, V, tier)
    scores = max_decisions > 0

    def sweep(P, N, width, A):
        return dense_sweep(P, N, width, A, scores)

    sweep_hot = None
    if hot_c and tier_period > 1 and TC <= hot_c < C:
        def sweep_hot(P, N, width, A):  # noqa: F811 — tier closure
            return dense_sweep(P, N, width, A, scores, rows=hot_c)

    return _dpll_round_loop(
        sweep, B, V, budget, max_decisions, sweep_hot, tier_period
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

        def sweep_hot(P, N, width, A):  # noqa: F811 — tier closure
            return base(P[:, :hot_c], N[:, :hot_c], width[:, :hot_c], A)

    return _dpll_round_loop(
        sweep, B, V, budget, max_decisions, sweep_hot, tier_period
    )


def _make_batched_sweep(decisions_on: bool):
    """One batched clause scan over per-lane float32 planes
    ``P/N [B, C, V]`` (``torch.bmm``, TF32 off: 0/1 products and integer
    sums are exact, like the JAX bf16-in/f32-out dots)."""

    def sweep(P, N, width, A):
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
    planes,
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

    - ``planes`` are passed to the round function verbatim;
      ``compact_planes(planes, idx)`` re-gathers per-lane planes on
      lane compaction (None for lane-shared planes).
    - ``grow_hot(live_A, hot_c) -> (planes, hot_c) | None`` folds the
      round's trail into the hot tier (union layout).

    Telemetry lands on DispatchStats: ``rounds``, ``repacks``,
    ``device_sweeps``, ``lane_sweeps_total`` and ``lane_sweeps_active``.

    Returns (status[n_real] int32 with bails mapped to 0, final
    A[n_real, V] float32).
    """
    from mythril_tpu_torch.ops.batched_sat import dispatch_stats

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
        fn = round_fn(B, budget, hot_c)
        dispatch_stats.device_dispatch_calls += 1
        with record_function("dense.round"):
            out = fn(*planes, *state)
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
                planes = compact_planes(planes, index)
        else:
            keep = np.arange(live.size)
        if grow_hot is not None:
            grown = grow_hot(A_host[keep], hot_c)
            if grown is not None:
                planes, hot_c = grown
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
        """None when no dense layout fits the tier's caps (the caller
        hands the lanes to the CDCL tail).

        Two layouts compete per dispatch, picked by estimated streamed
        cells: **union** (one [C, V] pool over the union cone, all lanes
        sweep it together — sibling forks of one path) and **per-lane**
        (each lane remapped into its own compact space, planes
        [B, C_max, V_max] — mostly disjoint cones).  Cones past the
        tier's decision-stack budget run BCP-only (sound UNSAT detection
        still on)."""
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
        results: List[Optional[bool]] = [
            False if statuses[i] == 2 else None for i in range(batch)
        ]
        return results, assignments

    def _solve_union(self, ctx, assumption_sets, clause_idx, cone_vars):
        """Union-cone layout: one shared [C, V] incidence pool, solved
        through the round ladder with tiered hot/cold sweeps: hot rows —
        narrow clauses plus rows touched by the assumption frontier,
        grown with each round's trail — are packed to the row prefix and
        swept every step; the cold remainder joins every TIER_PERIOD-th
        sweep.  The first round always sweeps the full cone."""
        from mythril_tpu_torch.ops.batched_sat import (
            dispatch_stats, warm_pref_row,
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
        with record_function("dense.planes"):
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
                return (pool.P, pool.N, pool.width), new_hot_c

            st_out, A_host = _run_dense_ladder(
                round_fn, (pool.P, pool.N, pool.width), A0,
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
            dispatch_stats, warm_pref_row,
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
