"""One iteration of the frontier solvers as three hand-written sm_90a
CUDA kernels (``csrc/frontier.cu``), with their plain PyTorch versions.

Counterpart of the loop bodies of the JAX package's frontier round
(``mythril_tpu/ops/frontier.py:453-596``) and resident solver
(``mythril_tpu/ops/resident.py:385-549``), which XLA runs as
``lax.while_loop``s (not Pallas kernels).  An iteration is:

1. :func:`scan_rows` — the BCP row scan (``make_scan_rows``) over the
   iteration's view: every pool row (full view, which also clears the
   lanes' queues) or the adjacency rows of the ``fan`` largest queued
   variables of each lane, popped from its queue (gather view); in
   resident mode also the shared block of learned rows (row ids offset
   by ``C``).  Writes the forced votes, reason rows, conflict flag and
   row and (full views) the decision scores.
2. :func:`lane_step` — per lane: first-UIP learning and chronological
   backtracking on a conflict, forcing with reasons and stamps, a DLIS
   decision (cached scores on gather views), SAT completion, bail, the
   per-round counters.  The don't-care cascade of a decision is left to
   the epilogue: in resident mode it must not touch a variable of the
   shared learned rows as they stand *after* this iteration's append,
   and the append needs every lane's learned row.
3. :func:`round_epilogue` — appends the iteration's learned rows to the
   shared pool (resident mode: lane order, dedup against the pool and
   earlier lanes, overflow dropped), applies the pending cascades, and
   computes the next iteration's batch-wide flags: ``it``, ``stall``,
   the full-view flag (period, or no live lane has a queued variable)
   and ``halt`` (the JAX loop condition failed).

The control words live on the device in ``ctl [2, NCTL]`` int32,
double-buffered by iteration parity: every kernel of iteration ``t``
reads row ``t % 2`` and only the epilogue writes row ``(t + 1) % 2``,
so no block reads a word another block of the same launch writes.  An
iteration that starts with ``halt`` set changes nothing, so the host
reads ``halt`` only every :data:`SYNC_EVERY` iterations and the state
it gets back is the state after the JAX loop's exact last iteration.

The tensors of one run are a :class:`Loop`.  Each wrapper takes its
plain version only when the loop's tensors are on the CPU; on the card
it launches its kernel or raises.  The kernels' argument struct is
checked and filled once per loop, at its first launch; a launch sets
only the iteration parity.  ``launch_counts`` adds one per real launch.
The library builds with ``nvcc`` at first use into
``mythril_tpu_torch/_build/``.
"""

import ctypes
import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "ops", "csrc", "frontier.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libfrontier.so")

#: control words (one row per iteration parity)
IT, HALT, FULL, STALL, NEXTRA = 0, 1, 2, 3, 4
NCTL = 8
#: lane-step flag bits
FLAG_PROGRESS, FLAG_QUEUED, FLAG_CASCADE = 1, 2, 4
#: iterations between two host reads of ``halt`` on the card
SYNC_EVERY = 16
#: the kernels assume clause rows of this width (MAX_CLAUSE_WIDTH)
WIDTH = 8
#: dynamic shared memory a block may take on sm_90: 227 KB, less 1 KB
#: for the kernels' static shared variables
MAX_DYNAMIC_SMEM = 232448 - 1024
#: the scan's and the lane step's clusters: at most 8 blocks a lane,
#: enough lanes x blocks for about every one of the card's 132 SMs
MAX_CLUSTER, CLUSTER_BLOCKS = 8, 128
#: the scan's pool tiles in flight: two of 512 rows
SCAN_TILES_BYTES = 2 * 512 * WIDTH * 4

#: kernel launches since the last reset, by kernel (each wrapper adds
#: one per launch and nowhere else)
launch_counts = {"scan_rows": 0, "lane_step": 0, "round_epilogue": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
#: (seconds, compiler output) of this process's build, when it built
build_info: Optional[tuple] = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class StepConfig(NamedTuple):
    """Knobs of one frontier round or resident solve.  ``limit`` is the
    iteration count at which the loop stops (the JAX ``it < limit``);
    ``resident`` adds the shared learned-row pool of ``extra_cap`` rows
    and the stall watchdog."""

    fan: int
    period: int
    limit: int
    watchdog: int
    extra_cap: int
    learn_cap: int
    uip_iters: int
    resident: bool = False


class Loop:
    """The tensors of one run of the iteration loop: the pool rows
    ``lits [C, K]``, their adjacency ``adj [V1, deg]``, the shared
    learned rows ``extra``, the control words ``ctl``, the lane state
    ``lane`` (FRONTIER_STATE_FIELDS) and the scratch ``buf``, all on one
    device.  ``args`` is the kernels' argument struct on the card and
    ``occ`` the pool's occurrence counts it points to."""

    def __init__(self, lits, adj, extra, ctl, lane: dict, buf: dict,
                 cfg: StepConfig):
        self.lits, self.adj, self.extra, self.ctl = lits, adj, extra, ctl
        self.lane, self.buf, self.cfg = lane, buf, cfg
        self.args = self.occ = None

    def to(self, device) -> "Loop":
        """A copy of every tensor on ``device``."""
        def copy(t):
            return t.detach().to(device, copy=True)

        return Loop(copy(self.lits), copy(self.adj), copy(self.extra),
                    copy(self.ctl),
                    {k: copy(v) for k, v in self.lane.items()},
                    {k: copy(v) for k, v in self.buf.items()}, self.cfg)


# ---------------------------------------------------------------------------
# the iteration loop
# ---------------------------------------------------------------------------


def to_device(state: dict, fields, device) -> dict:
    """numpy state -> contiguous tensors on ``device`` (bool stays bool)."""
    return {k: torch.from_numpy(np.ascontiguousarray(state[k])).to(device)
            for k in fields}


def to_host(lane: dict, fields) -> dict:
    return {k: lane[k].cpu().numpy().copy() for k in fields}


def make_buffers(B: int, V1: int, device) -> dict:
    """Scratch of one run: the scan's outputs and the lane step's
    per-lane results."""
    plane = lambda: torch.zeros((B, V1), dtype=torch.int32, device=device)  # noqa: E731
    vec = lambda: torch.zeros(B, dtype=torch.int32, device=device)  # noqa: E731
    return {
        "fpos": plane(), "fneg": plane(), "rpos": plane(), "rneg": plane(),
        "spos": plane(), "sneg": plane(), "conflict": vec(), "crow": vec(),
        "litrow": torch.zeros((B, WIDTH), dtype=torch.int32, device=device),
        "okl": vec(), "flags": vec(),
    }


def initial_ctl(lane: dict, cfg: StepConfig, it0: int = 0, stall0: int = 0,
                nextra0: int = 0) -> torch.Tensor:
    """Control words of the first iteration (row 0), from the state the
    loop starts with: the JAX loop condition and the first view."""
    active = lane["status"] == 0
    any_live = bool(active.any())
    queued = bool((lane["recent"] & active[:, None]).any())
    go = any_live and it0 < cfg.limit and (
        not cfg.resident or stall0 < cfg.watchdog)
    ctl = torch.zeros((2, NCTL), dtype=torch.int32)
    ctl[0, IT] = it0
    ctl[0, HALT] = 0 if go else 1
    ctl[0, FULL] = 1 if (it0 % cfg.period == 0 or not queued) else 0
    ctl[0, STALL] = stall0
    ctl[0, NEXTRA] = nextra0
    return ctl.to(lane["assign"].device)


def make_loop(lits, adj, lane: dict, cfg: StepConfig, extra=None,
              it0: int = 0, stall0: int = 0, nextra0: int = 0) -> Loop:
    """The loop over ``lane`` (tensors of FRONTIER_STATE_FIELDS on
    ``lits.device``) from the given counters; ``extra`` is the shared
    learned-row pool (resident mode)."""
    B, V1 = lane["assign"].shape
    if extra is None:
        extra = torch.zeros((1, WIDTH), dtype=torch.int32, device=lits.device)
    return Loop(lits, adj, extra, initial_ctl(lane, cfg, it0, stall0, nextra0),
                lane, make_buffers(B, V1, lits.device), cfg)


def run_iterations(lits, adj, lane: dict, cfg: StepConfig, extra=None,
                   it0: int = 0, stall0: int = 0, nextra0: int = 0):
    """Run the loop in place over ``lane`` and ``extra`` (see
    :func:`make_loop`) until ``halt``: one :func:`scan_rows`,
    :func:`lane_step`, :func:`round_epilogue` per iteration.  Returns
    the final control row as host ints (it, stall, nextra)."""
    loop = make_loop(lits, adj, lane, cfg, extra, it0, stall0, nextra0)
    ctl = loop.ctl
    sync_every = 1 if ctl.device.type == "cpu" else SYNC_EVERY
    max_iters = max(0, cfg.limit - it0)
    t = 0
    if not int(ctl[0, HALT]):
        while t < max_iters:
            parity = t & 1
            scan_rows(loop, parity)
            lane_step(loop, parity)
            round_epilogue(loop, parity)
            t += 1
            if (t % sync_every == 0 or t == max_iters) and int(
                ctl[t & 1, HALT]
            ):
                break
    final = ctl[t & 1].cpu()
    return int(final[IT]), int(final[STALL]), int(final[NEXTRA])


# ---------------------------------------------------------------------------
# plain versions (the wrappers take them for CPU tensors; they run on any
# device, which the chip check uses to time them on the card)
# ---------------------------------------------------------------------------


def _scan_rows_plain(loop: Loop, parity: int):
    from mythril_tpu_torch.ops.frontier import scan_rows_plain

    lits, adj, extra, cfg = loop.lits, loop.adj, loop.extra, loop.cfg
    lane, buf = loop.lane, loop.buf
    cur = loop.ctl[parity]
    if int(cur[HALT]):
        return
    A, recent = lane["assign"], lane["recent"]
    B, V1 = A.shape
    C, K = lits.shape
    dev = A.device
    if int(cur[FULL]):
        rows = lits[None].expand(B, C, K)
        row_ids = torch.arange(C, dtype=torch.int32, device=dev)[None].expand(
            B, C)
        res = scan_rows_plain(rows, row_ids,
                              torch.ones((B, C), dtype=bool, device=dev),
                              A, V1, True)
        recent.zero_()
    else:
        fan = max(1, min(cfg.fan, V1))
        col = torch.arange(V1, dtype=torch.int32, device=dev)
        pri = torch.where(recent, col, 0)
        picked_ids = pri.topk(fan, dim=1).values              # [B, fan]
        picked = picked_ids > 0
        clear = torch.zeros((B, V1), dtype=torch.uint8,
                            device=dev).scatter_reduce(
            1, picked_ids.long(), picked.to(torch.uint8), "amax").bool()
        recent &= ~clear
        rids = adj[picked_ids.long()]                          # [B, fan, deg]
        valid = (rids >= 0) & picked[:, :, None]
        deg = adj.shape[1]
        rids_flat = torch.where(valid, rids, 0).reshape(B, fan * deg)
        valid_flat = valid.reshape(B, fan * deg)
        rows = lits[rids_flat.long()] * valid_flat[:, :, None]
        res = scan_rows_plain(rows, rids_flat, valid_flat, A, V1, False)
    if cfg.resident:
        E = cfg.extra_cap
        erow = torch.arange(E, dtype=torch.int32, device=dev)
        rows = extra[None, :E].expand(B, E, K)
        row_ids = (C + erow)[None].expand(B, E)
        valid = (erow < int(cur[NEXTRA]))[None].expand(B, E)
        ex = scan_rows_plain(rows, row_ids, valid, A, V1, False)
        res = (torch.maximum(res[0], ex[0]), torch.maximum(res[1], ex[1]),
               torch.maximum(res[2], ex[2]), torch.maximum(res[3], ex[3]),
               res[4] | ex[4], torch.maximum(res[5], ex[5]), res[6], res[7])
    fpos, fneg, rpos, rneg, conflict, crow, spos, sneg = res
    buf["fpos"].copy_(fpos)
    buf["fneg"].copy_(fneg)
    buf["rpos"].copy_(rpos)
    buf["rneg"].copy_(rneg)
    buf["spos"].copy_(spos)
    buf["sneg"].copy_(sneg)
    buf["conflict"].copy_(conflict)
    buf["crow"].copy_(crow)


def _fetch_rows(lits, extra, r, resident: bool, extra_cap: int):
    """Clause row for each id of ``r``: pool rows, and in resident mode
    learned rows at ids >= C."""
    C = lits.shape[0]
    from_pool = lits[r.clamp(0, C - 1).long()]
    if not resident:
        return from_pool
    from_extra = extra[(r - C).clamp(0, extra_cap - 1).long()]
    return torch.where((r >= C)[:, None], from_extra, from_pool)


def _mark(B, V1, rows, on):
    """[B, V1] bool with the variables of ``rows [B, K]`` where ``on``."""
    return torch.zeros((B, V1), dtype=torch.uint8,
                       device=rows.device).scatter_reduce(
        1, rows.abs().long(), ((rows != 0) & on).to(torch.uint8), "amax"
    ).bool()


def _learn_plain(lits, extra, lane, do_learn, crow, cfg):
    """First-UIP resolution for every lane in ``do_learn``; writes the
    clause into the lane's learned buffer.  Returns (litrow, ok): the
    canonical clause row (zeros where not learned) and the emit flag."""
    A, lvl, reason, tpos = (lane["assign"], lane["lvl"], lane["reason"],
                            lane["tpos"])
    depth, nlearn, learned = lane["depth"], lane["nlearn"], lane["learned"]
    B, V1 = A.shape
    K = lits.shape[1]
    dev = A.device
    col = torch.arange(V1, device=dev)
    b1 = torch.arange(B, device=dev)
    crow_lits = _fetch_rows(lits, extra, crow, cfg.resident, cfg.extra_cap)
    marked = _mark(B, V1, crow_lits,
                   torch.ones((B, 1), dtype=bool, device=dev))
    marked[:, 0] = False
    ok = do_learn.clone()
    at_depth = lvl == depth[:, None]
    for _ in range(cfg.uip_iters):
        atlvl = marked & at_depth & (A != 0)
        need = ok & (atlvl.sum(dim=1) > 1)
        if not bool(need.any()):
            break  # every later iteration leaves the walk as it is
        key = torch.where(atlvl, tpos, -1)
        piv = key.argmax(dim=1)
        r = reason[b1, piv]
        ok = torch.where(need & (r < 0), False, ok)
        need = need & (r >= 0)
        prow = _fetch_rows(lits, extra, r, cfg.resident, cfg.extra_cap)
        add = _mark(B, V1, prow, need[:, None])
        m1 = (marked | add) & ~(need[:, None] & (col == piv[:, None]))
        m1[:, 0] = False
        marked = torch.where(need[:, None], m1, marked)
    ok = ok & ((marked & at_depth).sum(dim=1) <= 1)
    total = marked.sum(dim=1)
    ok = ok & (total >= 1) & (total <= K) & (nlearn < cfg.learn_cap)
    kk = min(K, V1)
    vsel = torch.where(marked, col, 0).topk(kk, dim=1).values
    sgn = torch.gather(A.to(torch.int32), 1, vsel.clamp(0, V1 - 1))
    litrow = torch.zeros((B, K), dtype=torch.int32, device=dev)
    litrow[:, :kk] = torch.where(vsel > 0, -sgn * vsel, 0).to(torch.int32)
    litrow = torch.where(ok[:, None], litrow, 0)
    slot = nlearn.clamp(0, cfg.learn_cap - 1).long()
    learned[b1, slot] = torch.where(ok[:, None], litrow, learned[b1, slot])
    nlearn += ok.to(torch.int32)
    return litrow, ok


def _lane_step_plain(loop: Loop, parity: int):
    lits, extra, cfg = loop.lits, loop.extra, loop.cfg
    lane, buf = loop.lane, loop.buf
    cur = loop.ctl[parity]
    if int(cur[HALT]):
        return
    do_full = bool(int(cur[FULL]))
    A = lane["assign"]
    lvl, reason, tpos = lane["lvl"], lane["reason"], lane["tpos"]
    dvar, dphase, dflip = lane["dvar"], lane["dphase"], lane["dflip"]
    depth, status, stamp = lane["depth"], lane["status"], lane["stamp"]
    recent, cspos, csneg = lane["recent"], lane["cspos"], lane["csneg"]
    pref = lane["pref"]
    B, V1 = A.shape
    D = dvar.shape[1]
    dev = A.device
    col = torch.arange(V1, device=dev)[None]
    dcol = torch.arange(D, device=dev)[None]
    b1 = torch.arange(B, device=dev)
    fpos, fneg, rpos, rneg = buf["fpos"], buf["fneg"], buf["rpos"], buf["rneg"]
    spos, sneg = buf["spos"], buf["sneg"]
    conflict = buf["conflict"] != 0
    crow = buf["crow"]

    active = status == 0
    free = (A == 0) & (col > 1)   # col 1 = the constant-TRUE anchor
    force_pos = (fpos > 0) & free
    force_neg = (fneg > 0) & free
    forced = force_pos | force_neg
    has_force = forced.any(dim=1)
    open_any = free.any(dim=1)
    # contradictory forcings are not flagged: the positive phase wins
    nstamp = stamp + active.to(torch.int32)

    # --- conflict: learn, then chronological backtrack
    unflipped = (dcol < depth[:, None]) & ~dflip
    Lm = torch.where(unflipped, dcol + 1, 0).amax(dim=1)
    unsat_now = active & conflict & (Lm == 0)
    do_bt = active & conflict & (Lm > 0)
    do_learn = do_bt & (crow >= 0) & (depth > 0)
    if bool(do_learn.any()):
        litrow, okl = _learn_plain(lits, extra, lane, do_learn, crow, cfg)
    else:
        litrow = torch.zeros((B, WIDTH), dtype=torch.int32, device=dev)
        okl = torch.zeros(B, dtype=bool, device=dev)
    buf["litrow"].copy_(litrow)
    buf["okl"].copy_(okl)
    qempty = ~recent.any(dim=1)     # the queue after this view's pop
    bslot = (Lm - 1).clamp(min=0)
    bvar = dvar[b1, bslot]
    bphase = -dphase[b1, bslot]
    popped_assign = do_bt[:, None] & (A != 0) & (lvl >= Lm[:, None])
    at_bvar = do_bt[:, None] & (col == bvar[:, None])
    A1 = torch.where(popped_assign, 0, A).to(torch.int8)
    A1 = torch.where(at_bvar, bphase[:, None], A1).to(torch.int8)
    lvl1 = torch.where(at_bvar, Lm[:, None], lvl)
    reason1 = torch.where(at_bvar, -1, reason)
    tpos1 = torch.where(at_bvar, nstamp[:, None], tpos)
    popped = do_bt[:, None] & (dcol >= Lm[:, None])
    at_b = do_bt[:, None] & (dcol == bslot[:, None])
    dvar1 = torch.where(popped, 0, dvar)
    dphase1 = torch.where(popped, 0, torch.where(at_b, bphase[:, None],
                                                 dphase)).to(torch.int8)
    dflip1 = torch.where(popped, False, torch.where(at_b, True, dflip))
    depth1 = torch.where(do_bt, Lm, depth)
    recent2 = (recent & ~popped_assign) | at_bvar

    # --- quiet + forced: assign every forced literal with its reason row
    do_force = active & ~conflict & has_force
    assigned_now = do_force[:, None] & forced
    A2 = torch.where(assigned_now, torch.where(force_pos, 1, -1),
                     A1).to(torch.int8)
    lvl2 = torch.where(assigned_now, depth[:, None], lvl1)
    reason2 = torch.where(
        assigned_now, torch.where(force_pos, rpos, rneg) - 1, reason1)
    tpos2 = torch.where(assigned_now, nstamp[:, None], tpos1)
    recent3 = recent2 | assigned_now

    # --- quiet + open: decide (DLIS with warm-start phases; cached
    # scores on a gather view); the cascade is the epilogue's
    want = active & ~conflict & ~has_force & open_any & (do_full | qempty)
    can = depth1 < D
    do_dec = want & can
    bail = want & ~can
    spos_eff = spos if do_full else cspos
    sneg_eff = sneg if do_full else csneg
    score = torch.where(free & ~forced, spos_eff + sneg_eff + 1, -1)
    var = score.argmax(dim=1)
    dlis = torch.where(spos_eff[b1, var] >= sneg_eff[b1, var], 1, -1)
    prefv = pref[b1, var]
    phase = torch.where(prefv != 0, prefv, dlis).to(torch.int8)
    ndepth = depth1 + 1
    at_var = do_dec[:, None] & (col == var[:, None])
    A3 = torch.where(at_var, phase[:, None], A2).to(torch.int8)
    lvl3 = torch.where(at_var, ndepth[:, None], lvl2)
    reason3 = torch.where(at_var, -1, reason2)
    tpos3 = torch.where(at_var, nstamp[:, None], tpos2)
    recent4 = recent3 | at_var
    at_new = do_dec[:, None] & (dcol == depth1[:, None])
    dvar2 = torch.where(at_new, var[:, None].to(torch.int32), dvar1)
    dphase2 = torch.where(at_new, phase[:, None], dphase1).to(torch.int8)
    dflip2 = torch.where(at_new, False, dflip1)
    depth2 = torch.where(do_dec, ndepth, depth1)

    # --- quiet + complete on a full view: SAT candidate
    done_sat = active & ~conflict & ~has_force & ~open_any & do_full
    status1 = torch.where(unsat_now, 2, status)
    status1 = torch.where(done_sat, 1, status1)
    status1 = torch.where(bail, 3, status1)
    progress = do_force | do_bt | do_dec | unsat_now | done_sat | bail
    flags = (progress.to(torch.int32) * FLAG_PROGRESS
             + recent4.any(dim=1).to(torch.int32) * FLAG_QUEUED
             + (do_dec & do_full).to(torch.int32) * FLAG_CASCADE)
    for name, value in (
        ("assign", A3), ("lvl", lvl3), ("reason", reason3), ("tpos", tpos3),
        ("dvar", dvar2), ("dphase", dphase2), ("dflip", dflip2),
        ("depth", depth2), ("status", status1), ("stamp", nstamp),
        ("recent", recent4), ("cspos", spos_eff.clone()),
        ("csneg", sneg_eff.clone()),
    ):
        lane[name].copy_(value)
    lane["fullsw"] += (active & do_full).to(torch.int32)
    lane["fsteps"] += (active & (not do_full)).to(torch.int32)
    buf["flags"].copy_(flags)


def _round_epilogue_plain(loop: Loop, parity: int):
    extra, cfg, lane, buf = loop.extra, loop.cfg, loop.lane, loop.buf
    cur, nxt = loop.ctl[parity], loop.ctl[1 - parity]
    if int(cur[HALT]):
        nxt.copy_(cur)
        return
    ne = int(cur[NEXTRA])
    ne1 = ne
    E = cfg.extra_cap
    if cfg.resident:
        litrow, okl = buf["litrow"], buf["okl"] != 0
        valid = torch.arange(E, device=extra.device) < ne
        dup = ((extra[None, :E] == litrow[:, None, :]).all(dim=2)
               & valid[None, :]).any(dim=1)
        same = (litrow[:, None, :] == litrow[None, :, :]).all(dim=2)
        earlier = (torch.tril(same, diagonal=-1) & okl[None, :]).any(dim=1)
        ok2 = okl & ~dup & ~earlier & (litrow != 0).any(dim=1)
        okn = ok2.to(torch.int32)
        offs = ne + torch.cumsum(okn, 0) - okn
        live_write = ok2 & (offs < E)
        extra[offs[live_write].long()] = litrow[live_write]
        ne1 = min(E, ne + int(okn.sum()))
    A = lane["assign"]
    B, V1 = A.shape
    pending = (buf["flags"] & FLAG_CASCADE) != 0
    if bool(pending.any()):
        # the don't-care cascade of this iteration's decisions: free
        # vars in no open clause of the full view, minus (resident) any
        # var of the shared learned rows after the append
        rows = extra[:ne1]
        in_extra = torch.zeros(V1, dtype=bool, device=A.device)
        in_extra[rows[rows != 0].abs().long()] = True
        in_extra[0] = False
        col = torch.arange(V1, device=A.device)[None]
        dontcare = (pending[:, None] & (A == 0) & (col > 1)
                    & (buf["spos"] + buf["sneg"] == 0) & ~in_extra[None])
        A[dontcare] = 1
        lane["lvl"].copy_(torch.where(dontcare, lane["depth"][:, None],
                                      lane["lvl"]))
        lane["reason"][dontcare] = -1
        lane["tpos"].copy_(torch.where(dontcare, lane["stamp"][:, None],
                                       lane["tpos"]))
    live = lane["status"] == 0
    flags = buf["flags"]
    any_live = bool(live.any())
    queued = bool((live & ((flags & FLAG_QUEUED) != 0)).any())
    progress = bool(((flags & FLAG_PROGRESS) != 0).any())
    it1 = int(cur[IT]) + 1
    stall1 = (0 if progress else int(cur[STALL]) + 1) if cfg.resident else 0
    go = any_live and it1 < cfg.limit and (
        not cfg.resident or stall1 < cfg.watchdog)
    nxt.zero_()
    nxt[IT] = it1
    nxt[HALT] = 0 if go else 1
    nxt[FULL] = 1 if (it1 % cfg.period == 0 or not queued) else 0
    nxt[STALL] = stall1
    nxt[NEXTRA] = ne1


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def scan_rows(loop: Loop, parity: int):
    """Iteration step 1 (see the module docstring), in place on
    ``lane['recent']`` and ``buf``."""
    if loop.ctl.device.type == "cpu":
        return _scan_rows_plain(loop, parity)
    _launch("scan_rows", loop, parity)


def lane_step(loop: Loop, parity: int):
    """Iteration step 2, in place on ``lane`` and ``buf``."""
    if loop.ctl.device.type == "cpu":
        return _lane_step_plain(loop, parity)
    _launch("lane_step", loop, parity)


def round_epilogue(loop: Loop, parity: int):
    """Iteration step 3, in place on ``extra``, ``ctl`` and ``lane``."""
    if loop.ctl.device.type == "cpu":
        return _round_epilogue_plain(loop, parity)
    _launch("round_epilogue", loop, parity)


PLAIN = {"scan_rows": _scan_rows_plain, "lane_step": _lane_step_plain,
         "round_epilogue": _round_epilogue_plain}


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

#: field order of ``struct FrontierArgs`` in csrc/frontier.cu
_PTR_FIELDS = (
    "lits", "adj", "occ", "extra", "ctl",
    "assign", "lvl", "reason", "tpos", "dvar", "dphase", "dflip",
    "depth", "status", "stamp", "recent", "cspos", "csneg",
    "fullsw", "fsteps", "nlearn", "learned", "pref",
    "fpos", "fneg", "rpos", "rneg", "spos", "sneg", "conflict", "crow",
    "litrow", "okl", "flags",
)
_INT_FIELDS = (
    "B", "V1", "C", "deg", "D", "learn_cap", "E", "fan", "period", "limit",
    "watchdog", "uip_iters", "resident", "parity",
)
#: kernel ids of ``frontier_smem_bytes``
KERNEL_IDS = {"scan_rows": 0, "lane_step": 1, "round_epilogue": 2}


class FrontierArgs(ctypes.Structure):
    _fields_ = ([(name, ctypes.c_void_p) for name in _PTR_FIELDS]
                + [(name, ctypes.c_int) for name in _INT_FIELDS])


#: dtype of every state field and scratch buffer the kernels take
_DTYPES = {
    "assign": torch.int8, "dphase": torch.int8, "pref": torch.int8,
    "dflip": torch.bool, "recent": torch.bool,
}
#: fields laid out [B, V1], [B, D] and [B]
_PLANES = ("assign", "lvl", "reason", "tpos", "recent", "cspos", "csneg",
           "pref", "fpos", "fneg", "rpos", "rneg", "spos", "sneg")
_DECISIONS = ("dvar", "dphase", "dflip")
_VECTORS = ("depth", "status", "stamp", "fullsw", "fsteps", "nlearn",
            "conflict", "crow", "okl", "flags")


def smem_layout(B: int, V1: int, fan: int, uip_iters: int,
                extra_cap: int = 0) -> dict:
    """Dynamic shared memory of each kernel's block in bytes, as
    ``csrc/frontier.cu`` lays it out, and the two cluster sizes.  Each
    lane's scan runs on a cluster of ``cluster`` blocks (a power of two up
    to 8, the smallest whose block fits and whose ``B x cluster`` blocks
    fill the card), each holding a ``1 / cluster`` slice of the four int32
    accumulation planes.  Each lane's lane step runs on a cluster of
    ``lane_cluster`` blocks (the smallest power of two whose ``B x
    lane_cluster`` blocks fill the card, up to 8), each passing over a
    ``1 / lane_cluster`` slice of the lane's vars; its block holds the
    first-UIP walk's list and two bitmaps over V1.  ``extra_cap`` is the
    resident pool's size (0 outside resident mode): the epilogue stages it
    with the lanes' learned rows.  Raises ValueError for shapes no layout
    fits."""
    def a16(n):
        return (n + 15) & ~15

    def scan(S):  # the planes' slice, pool tiles, assignment, queue, picks
        return (16 * ((-(-V1 // S) + 3) & ~3) + SCAN_TILES_BYTES
                + 2 * (a16(V1) + 16) + a16(4 * fan))

    cluster = next((S for S in (1, 2, 4, MAX_CLUSTER)
                    if scan(S) <= MAX_DYNAMIC_SMEM
                    and (B * S >= CLUSTER_BLOCKS or S == MAX_CLUSTER)), 0)
    staged = 4 * WIDTH * (extra_cap + B) + 12 * B if extra_cap else 0
    walk = WIDTH * (uip_iters + 1)  # listed vars: key, var, reason, flags
    lane_cluster = 1
    while lane_cluster < MAX_CLUSTER and B * lane_cluster < CLUSTER_BLOCKS:
        lane_cluster *= 2
    layout = {
        "scan_rows": scan(cluster or MAX_CLUSTER),
        "lane_step": 16 * walk + a16(2 * walk) + 2 * a16(4 * (-(-V1 // 32))),
        "round_epilogue": a16(V1) + staged,
    }
    for name, size in layout.items():
        if size > MAX_DYNAMIC_SMEM:
            raise ValueError(
                f"frontier {name}: B={B} V1={V1} fan={fan} "
                f"uip_iters={uip_iters} extra_cap={extra_cap} need {size} "
                f"bytes of shared memory; a block has {MAX_DYNAMIC_SMEM}")
    layout["cluster"] = cluster
    layout["lane_cluster"] = lane_cluster
    return layout


def build_library() -> str:
    """Compile ``csrc/frontier.cu`` into ``_build/`` when the library is
    missing or older than its source; returns the library path."""
    global build_info
    from mythril_tpu_torch.ops.dense_sweep import build_cuda_library

    info = build_cuda_library(SOURCE, LIBRARY)
    if info is not None:
        build_info = info
    return LIBRARY


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name in launch_counts:
                fn = getattr(lib, f"frontier_{name}_launch")
                fn.argtypes = [ctypes.POINTER(FrontierArgs), ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.frontier_smem_bytes.argtypes = [ctypes.POINTER(FrontierArgs),
                                                ctypes.c_int]
            lib.frontier_smem_bytes.restype = ctypes.c_int
            for name in ("frontier_scan_cluster", "frontier_lane_cluster"):
                getattr(lib, name).argtypes = [ctypes.POINTER(FrontierArgs)]
                getattr(lib, name).restype = ctypes.c_int
            lib.frontier_width.restype = ctypes.c_int
            if lib.frontier_width() != WIDTH:
                raise RuntimeError("frontier.cu: clause width mismatch")
            _lib = lib
    return _lib


def pool_occurrences(lits: torch.Tensor, V1: int) -> torch.Tensor:
    """[2, V1] int32: how often each var occurs positively (row 0) and
    negatively (row 1) in the pool rows ``lits``, vars clamped as the scan
    clamps them.  On a full view the scan kernel takes an unknown var's
    score from it, less the var's occurrences in closed rows."""
    flat = lits.reshape(-1)
    var = flat.abs().clamp(max=V1 - 1).long() + (flat < 0).long() * V1
    return torch.zeros(2 * V1, dtype=torch.int32, device=lits.device) \
        .index_add_(0, var, (flat != 0).to(torch.int32)).reshape(2, V1)


def _bind(loop: Loop) -> FrontierArgs:
    """Check the loop's tensors (device, contiguity, dtype, shape) and
    fill the kernels' argument struct; raises on anything the kernels
    do not take."""
    cfg = loop.cfg
    tensors = dict(loop.lane)
    tensors.update(loop.buf)
    tensors.update(lits=loop.lits, adj=loop.adj, extra=loop.extra,
                   ctl=loop.ctl)
    loop.occ = tensors["occ"] = pool_occurrences(
        loop.lits, loop.lane["assign"].shape[1])
    device = loop.ctl.device
    for key in _PTR_FIELDS:
        t = tensors[key]
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"frontier kernels: {key} must be a contiguous "
                             f"tensor on {device}")
        want = _DTYPES.get(key, torch.int32)
        if t.dtype != want:
            raise TypeError(f"frontier kernels: {key} is {t.dtype}, "
                            f"expected {want}")
    B, V1 = loop.lane["assign"].shape
    D = loop.lane["dvar"].shape[1]
    C, deg = loop.lits.shape[0], loop.adj.shape[1]
    shapes = {"lits": (C, WIDTH), "adj": (V1, deg), "ctl": (2, NCTL),
              "occ": (2, V1),
              "learned": (B, cfg.learn_cap, WIDTH), "litrow": (B, WIDTH)}
    shapes.update({k: (B, V1) for k in _PLANES})
    shapes.update({k: (B, D) for k in _DECISIONS})
    shapes.update({k: (B,) for k in _VECTORS})
    if cfg.resident:
        shapes["extra"] = (cfg.extra_cap + 1, WIDTH)
    for key, shape in shapes.items():
        if tuple(tensors[key].shape) != shape:
            raise ValueError(f"frontier kernels: {key} is "
                             f"{tuple(tensors[key].shape)}, expected {shape}")
    if min(B, C, deg, D, cfg.learn_cap, cfg.period) < 1 or V1 < 2 or not (
        0 <= cfg.uip_iters
    ):
        raise ValueError(f"frontier kernels: bad sizes B={B} V1={V1} C={C}")
    fan = max(1, min(cfg.fan, V1))
    E = cfg.extra_cap if cfg.resident else 0
    smem_layout(B, V1, fan, cfg.uip_iters, E)
    # the 16-byte loads and stores of rows and of [B, V1] planes
    for key in ("lits", "extra", "litrow") + _PLANES:
        if tensors[key].data_ptr() % 16:
            raise ValueError(f"frontier kernels: {key} is not 16-byte "
                             f"aligned")
    load_library()
    args = FrontierArgs()
    for key in _PTR_FIELDS:
        setattr(args, key, tensors[key].data_ptr())
    ints = {
        "B": B, "V1": V1, "C": C, "deg": deg, "D": D,
        "learn_cap": cfg.learn_cap,
        "E": E, "fan": fan,
        "period": cfg.period, "limit": cfg.limit, "watchdog": cfg.watchdog,
        "uip_iters": cfg.uip_iters, "resident": int(cfg.resident),
        "parity": 0,
    }
    for key, value in ints.items():
        setattr(args, key, int(value))
    return args


def _launch(name: str, loop: Loop, parity: int):
    if loop.args is None:
        loop.args = _bind(loop)
    args = loop.args
    args.parity = parity
    stream = torch.cuda.current_stream(loop.ctl.device).cuda_stream
    err = getattr(_lib, f"frontier_{name}_launch")(ctypes.byref(args), stream)
    if err:
        raise RuntimeError(f"frontier {name} kernel launch failed: "
                           f"cudaError {err}")
    launch_counts[name] += 1
