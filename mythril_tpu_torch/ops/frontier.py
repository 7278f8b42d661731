"""Device-native propagation of the port (counterpart of
``mythril_tpu/ops/frontier.py``): the literal->clause-row adjacency,
the frontier solver state, the BCP row scan, the multi-dispatch frontier
round and the host harvest of device-learned clauses.

- **Adjacency index** (:func:`build_adjacency`): for each variable, up
  to ``deg`` clause rows it occurs in.  Built on the host once per pool
  upload and shipped beside the rows.
- **Frontier rounds** (:func:`frontier_round`): each lane carries a
  queue of recently assigned variables (``recent``) across iterations,
  rounds and bucket re-packs.  Most iterations scan only the rows
  adjacent to the ``fan`` largest queued variables (``fan`` x ``deg``
  rows); a full sweep of the pool runs every ``period``-th iteration or
  when no live lane has a queued variable.  Decisions, the don't-care
  cascade and SAT completion need the full view.
- **First-UIP learning**: on a conflict under decisions, the conflicting
  row is resolved against reason rows until one literal of the conflict
  level is left; the clause goes to a bounded per-lane buffer that the
  host harvests between rounds into the blast context's nogood channel
  (:func:`harvest_learned`).

One iteration is three hand-written kernels on the card (scan, lane
step, epilogue: ``ops/frontier_kernels.py``); :func:`scan_rows_plain`
is the JAX package's ``make_scan_rows`` in PyTorch, which the scan
kernel's plain version is built on.  ``MYTHRIL_TPU_FRONTIER=0`` runs
the gather tiers on the round lanes instead (``ops/round_lane.py``, as
the JAX package does) and makes the dense tier grow its hot rows
without the adjacency index.  Knobs (environment only):
``MYTHRIL_TPU_FRONTIER_PERIOD`` (default 8), ``MYTHRIL_TPU_FRONTIER_FAN``
(16), ``MYTHRIL_TPU_FRONTIER_DEG`` (32).
"""

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from mythril_tpu_torch.support.env import env_int

#: a gather step advances at most ``fan`` queued vars, so a round's
#: iteration budget is its sweep budget times this
FRONTIER_BUDGET_MULT = 4
#: per-lane learned-clause buffer of one round (harvested between rounds)
LEARN_CAP = 8
#: resolution-step bound of the first-UIP walk (a longer chain learns
#: nothing; learning is never load-bearing)
UIP_ITERS = 48
DEFAULT_PERIOD = 8
DEFAULT_FAN = 16
DEFAULT_DEG = 32


def frontier_enabled() -> bool:
    """``MYTHRIL_TPU_FRONTIER=0`` makes the dense tier's union layout
    grow its hot rows with an ``isin`` scan of the whole coordinate list
    instead of the adjacency index (same switch as the JAX package)."""
    return os.environ.get("MYTHRIL_TPU_FRONTIER", "1").lower() not in (
        "0", "off", "false",
    )


def _tuned_int(name: str, knob: str, default: int,
               floor: int = 1) -> int:
    """Env pin wins; otherwise the autopilot tuner may publish a
    bounded override (autopilot/tuner.py); otherwise the default."""
    if not os.environ.get(name, "").strip():
        from mythril_tpu_torch.autopilot import knob_override

        tuned = knob_override(knob)
        if tuned is not None:
            return max(floor, tuned)
    return env_int(name, default, floor=floor)


def frontier_period() -> int:
    return _tuned_int("MYTHRIL_TPU_FRONTIER_PERIOD", "frontier_period",
                      DEFAULT_PERIOD)


def frontier_fan() -> int:
    return _tuned_int("MYTHRIL_TPU_FRONTIER_FAN", "frontier_fan",
                      DEFAULT_FAN)


def frontier_deg() -> int:
    return env_int("MYTHRIL_TPU_FRONTIER_DEG", DEFAULT_DEG, floor=2)


# ---------------------------------------------------------------------------
# adjacency
# ---------------------------------------------------------------------------


def build_adjacency(rows: np.ndarray, v1: int,
                    deg: Optional[int] = None) -> np.ndarray:
    """``adj [v1, deg]`` int32 over clause rows ``rows [C, K]`` (signed
    literals, 0 = pad): for variable ``v`` the ascending row ids it
    occurs in (either polarity), padded with -1.  Degrees past the cap
    are truncated, which is sound: full sweeps see every row."""
    if deg is None:
        deg = frontier_deg()
    adj = np.full((v1, deg), -1, dtype=np.int32)
    if rows.size == 0:
        return adj
    rid, kpos = np.nonzero(rows)
    if rid.size == 0:
        return adj
    var = np.abs(rows[rid, kpos]).astype(np.int64)
    keep = var < v1
    rid, var = rid[keep], var[keep]
    # unique (var, row) pairs in (var, row) order: each var's rows come
    # out ascending and duplicates collapse
    key = var * np.int64(rows.shape[0] + 1) + rid
    ukey = np.unique(key)
    uvar = (ukey // np.int64(rows.shape[0] + 1)).astype(np.int64)
    urow = (ukey % np.int64(rows.shape[0] + 1)).astype(np.int32)
    first = np.searchsorted(uvar, uvar)
    slot = np.arange(len(uvar)) - first
    keep = slot < deg
    adj[uvar[keep], slot[keep]] = urow[keep]
    return adj


class LitAdjacency:
    """Host-side CSR adjacency over (row, literal) coordinates — the
    shared index behind the union layout's hot-tier growth (rows
    adjacent to a trail column in O(Σ deg) instead of an O(nnz)
    ``isin`` scan per round)."""

    def __init__(self, urow: np.ndarray, ulit: np.ndarray, n_rows: int):
        var = np.abs(ulit.astype(np.int64))
        order = np.argsort(var, kind="stable")
        self._rows = urow[order].astype(np.int64)
        svar = var[order]
        self.v1 = int(svar.max()) + 1 if svar.size else 1
        self._indptr = np.searchsorted(
            svar, np.arange(self.v1 + 1, dtype=np.int64)
        )
        self.n_rows = n_rows

    def rows_for_vars(self, cols: np.ndarray) -> np.ndarray:
        """Unique row ids (original-layout space) adjacent to any of
        ``cols``."""
        cols = np.asarray(cols, np.int64)
        cols = cols[(cols > 0) & (cols < self.v1)]
        if cols.size == 0:
            return np.empty(0, np.int64)
        starts = self._indptr[cols]
        stops = self._indptr[cols + 1]
        counts = stops - starts
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, np.int64)
        # vectorized multi-slice gather
        out = np.repeat(starts - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                        counts) + np.arange(total)
        return np.unique(self._rows[out])


# ---------------------------------------------------------------------------
# solver state and the BCP row scan
# ---------------------------------------------------------------------------

#: field order of the resumable frontier solver state; the round ladder
#: re-packs survivors along axis 0 of every entry
FRONTIER_STATE_FIELDS = (
    "assign", "lvl", "reason", "tpos", "dvar", "dphase", "dflip",
    "depth", "status", "stamp", "recent", "cspos", "csneg",
    "fullsw", "fsteps", "nlearn", "learned", "pref",
)


def frontier_state0(assign: np.ndarray, n_real: int, max_decisions: int,
                    learn_cap: int = LEARN_CAP, width: int = 8,
                    pref_row=None) -> dict:
    """Host-side zero state over the assumption-seeded ``assign [B, V1]``
    (int8); rows past ``n_real`` are bucket padding, retired (status 3)
    from the start.  Seed assignments live at level 0 with no reason and
    stamp 0."""
    B, V1 = assign.shape
    D = max(1, min(max_decisions, V1))
    state = {
        "assign": assign.astype(np.int8, copy=True),
        "lvl": np.zeros((B, V1), np.int32),
        "reason": np.full((B, V1), -1, np.int32),
        "tpos": np.zeros((B, V1), np.int32),
        "dvar": np.zeros((B, D), np.int32),
        "dphase": np.zeros((B, D), np.int8),
        "dflip": np.zeros((B, D), bool),
        "depth": np.zeros(B, np.int32),
        "status": np.zeros(B, np.int32),
        "stamp": np.zeros(B, np.int32),
        "recent": np.zeros((B, V1), bool),
        # DLIS scores of the last full sweep: a queue-drained lane
        # decides on them between full views
        "cspos": np.zeros((B, V1), np.int32),
        "csneg": np.zeros((B, V1), np.int32),
        "fullsw": np.zeros(B, np.int32),
        "fsteps": np.zeros(B, np.int32),
        "nlearn": np.zeros(B, np.int32),
        "learned": np.zeros((B, learn_cap, width), np.int32),
        "pref": np.zeros((B, V1), np.int8),
    }
    if pref_row is not None:
        state["pref"][:] = np.asarray(pref_row, np.int8)
    state["status"][n_real:] = 3
    return state


def scan_rows_plain(rows, row_ids, valid, assign, V1: int, scores: bool):
    """One BCP evaluation over gathered clause rows (the JAX package's
    ``make_scan_rows``).

    ``rows [B, G, K]`` int32 signed literals (0 pad), ``row_ids [B, G]``
    row indices, ``valid [B, G]`` bool, ``assign [B, V1]`` int8.
    Returns (fpos, fneg, rpos, rneg, conflict, conflict_row, spos, sneg):
    forced votes (scatter-max of 1), reason rows (max of row id + 1),
    the conflict flag and the largest conflicting row (-1 = none), and
    on ``scores`` the open-clause literal counts (zeros otherwise)."""
    B, G, K = rows.shape
    flat_var = rows.abs().long().reshape(B, G * K)
    vals = torch.sign(rows) * torch.gather(
        assign.to(torch.int32), 1, flat_var
    ).reshape(B, G, K)
    is_real = (rows != 0) & valid[:, :, None]
    real_row = is_real.any(dim=2)
    sat = ((vals > 0) & is_real).any(dim=2)
    unknown_here = (vals == 0) & is_real
    num_unknown = unknown_here.sum(dim=2)
    all_false = ((vals < 0) | ~is_real).all(dim=2) & real_row
    unsat_yet = ~sat & real_row
    unit = unsat_yet & (num_unknown == 1)
    forced_lit = torch.where(
        unit[:, :, None] & unknown_here, rows, torch.zeros_like(rows)
    ).sum(dim=2, dtype=torch.int32)                        # [B, G]
    pos = forced_lit > 0
    neg = forced_lit < 0
    pos_var = torch.where(pos, forced_lit, 0).long()
    neg_var = torch.where(neg, -forced_lit, 0).long()
    zeros = torch.zeros((B, V1), dtype=torch.int32, device=rows.device)
    ids1 = (row_ids + 1).to(torch.int32)
    fpos = zeros.scatter_reduce(1, pos_var, pos.to(torch.int32), "amax")
    fneg = zeros.scatter_reduce(1, neg_var, neg.to(torch.int32), "amax")
    rpos = zeros.scatter_reduce(
        1, pos_var, torch.where(pos, ids1, 0), "amax")
    rneg = zeros.scatter_reduce(
        1, neg_var, torch.where(neg, ids1, 0), "amax")
    conflict = all_false.any(dim=1)
    conflict_row = torch.where(all_false, ids1, 0).amax(dim=1) - 1
    if scores:
        open_unknown = (
            unknown_here & (unsat_yet & (num_unknown > 1))[:, :, None]
        ).reshape(B, G * K)
        flat_rows = rows.reshape(B, G * K)
        spos = zeros.scatter_add(
            1, flat_var, (open_unknown & (flat_rows > 0)).to(torch.int32))
        sneg = zeros.scatter_add(
            1, flat_var, (open_unknown & (flat_rows < 0)).to(torch.int32))
    else:
        spos = zeros
        sneg = zeros.clone()
    return (fpos, fneg, rpos, rneg, conflict, conflict_row.to(torch.int32),
            spos, sneg)


# ---------------------------------------------------------------------------
# the multi-dispatch frontier round
# ---------------------------------------------------------------------------


def frontier_round(lits: torch.Tensor, adj: torch.Tensor, state: dict,
                   budget: int) -> dict:
    """One frontier round (the JAX package's ``make_frontier_round_step``)
    over FRONTIER_STATE_FIELDS: at most ``budget * FRONTIER_BUDGET_MULT``
    iterations, stopping at the first one with no live lane.  ``state``
    holds numpy arrays; returns a new dict of numpy arrays.

    Status is raw: 0 live, 1 SAT candidate, 2 sound UNSAT, 3 retired
    undecided; ``fullsw``/``fsteps`` count each lane's active full
    sweeps / gather steps of this round."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    cfg = FK.StepConfig(
        fan=frontier_fan(), period=frontier_period(),
        limit=budget * FRONTIER_BUDGET_MULT, watchdog=0, extra_cap=0,
        learn_cap=state["learned"].shape[1], uip_iters=UIP_ITERS,
    )
    lane = FK.to_device(state, FRONTIER_STATE_FIELDS, lits.device)
    FK.run_iterations(lits, adj, lane, cfg)
    return FK.to_host(lane, FRONTIER_STATE_FIELDS)


# ---------------------------------------------------------------------------
# host harvest: device-learned clauses -> the blast context's pool
# ---------------------------------------------------------------------------


def harvest_learned(ctx, clause_rows: Sequence[np.ndarray],
                    col_to_var: Optional[np.ndarray] = None) -> int:
    """Feed first-UIP clauses of the frontier solvers into the blast
    context's nogood channel.  ``clause_rows`` are padded int32 literal
    rows in solver column space; ``col_to_var`` maps columns back to
    pool variables (None = identity, the full-pool tier).  Dedupes
    within the batch; the native side dedupes globally.  Returns how
    many clauses the pool accepted."""
    seen = set()
    accepted = 0
    for row in clause_rows:
        lits: List[int] = []
        ok = True
        for lit in row:
            lit = int(lit)
            if lit == 0:
                continue
            var = abs(lit)
            if col_to_var is not None:
                if var >= len(col_to_var):
                    ok = False
                    break
                var = int(col_to_var[var])
                if var <= 0:
                    ok = False
                    break
            lits.append(var if lit > 0 else -var)
        if not ok or not lits:
            continue
        key = tuple(sorted(lits))
        if key in seen:
            continue
        seen.add(key)
        accepted += ctx.harvest_device_clauses([lits])
    return accepted
