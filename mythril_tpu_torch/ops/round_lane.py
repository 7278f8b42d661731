"""The gather tiers' per-lane DPLL round: a hand-written sm_90a CUDA
kernel (``csrc/round_lane.cu``) and its plain PyTorch version.

Counterpart of ``mythril_tpu/ops/batched_sat.py`` ``build_round_lane`` /
``build_solve_lane`` and the vmapped ``make_round_step`` /
``make_solve_step`` (an XLA ``lax.while_loop``, not a Pallas kernel).
It runs under ``MYTHRIL_TPU_FRONTIER=0`` as the gather and cone tiers'
round ladder, and as the async prefetch's one-shot solve.

A lane's state is a dict of tensors, :data:`ROUND_STATE_FIELDS`:
``assign`` int8 [B, V1], ``lvl`` int32 [B, V1], ``dvar`` int32 [B, D],
``dphase`` int8 [B, D], ``dflip`` bool [B, D], ``depth`` / ``status`` /
``step`` int32 [B], ``pref`` int8 [B, V1] (read only; the warm-start
phase).  Status is raw: 0 live, 1 complete assignment of the clause
subset (the host verifies it), 2 sound UNSAT, 3 decision-stack bail.
A round advances each lane by at most ``budget`` sweeps and freezes it
once its own ``status != 0`` or ``step >= budget`` (the semantics of
the vmapped loop); ``step`` holds the lane's own sweeps.

:func:`round_lane` takes the plain version only for tensors that lie on
the CPU; for CUDA tensors it launches the kernel or raises.  The kernel
runs the whole loop of every lane in one launch, each lane on a
thread-block cluster of :func:`cluster_size` blocks; the library builds
with ``nvcc`` at first use into ``mythril_tpu_torch/_build/``, under a
lock (the async prefetch's worker thread may be the first caller).
:func:`skip_record_model` is the plain model of the kernel's record of
rows known satisfied, which the tests hold against the full scan.
"""

import ctypes
import os
import threading
from typing import Dict, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "ops", "csrc", "round_lane.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libround_lane.so")

#: the lane state, in the JAX tuple's order
ROUND_STATE_FIELDS = ("assign", "lvl", "dvar", "dphase", "dflip", "depth",
                      "status", "step", "pref")
_DTYPES = {"assign": torch.int8, "lvl": torch.int32, "dvar": torch.int32,
           "dphase": torch.int8, "dflip": torch.bool, "depth": torch.int32,
           "status": torch.int32, "step": torch.int32, "pref": torch.int8}
#: the kernel reads clause rows of this width (narrower rows are padded)
WIDTH = 8
#: dynamic shared memory a block may take on sm_90: 227 KB, less 4 KB
#: for the kernel's static shared variables
MAX_DYNAMIC_SMEM = 232448 - 4096
#: the kernel's cluster rule (mirrors ``csrc/round_lane.cu``): the
#: portable cluster size, and the blocks that fill the card (about one on
#: each of the 132 SMs)
MAX_CLUSTER = 8
CLUSTER_BLOCKS = 128
#: a row's record is a uint16: the level by which it was satisfied, plus
#: one (0 = none); a deeper level saturates here, and any backtrack voids
#: a saturated record
SATURATED = 0xFFFF

#: kernel launches since the last reset (the wrapper adds one per launch
#: and nowhere else; the prefetch worker launches too, hence the lock)
launch_count = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
#: (seconds, compiler output) of this process's build, when it built
build_info: Optional[tuple] = None


def reset_launch_count() -> None:
    global launch_count
    with _lock:
        launch_count = 0


def initial_state(assign: torch.Tensor, decisions: int,
                  pref: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """The zero state of ``build_solve_lane`` over ``assign [B, V1]``:
    no levels, an empty stack of ``min(decisions, V1)`` slots, every lane
    live, ``pref`` broadcast (zeros when None)."""
    B, V1 = assign.shape
    D = max(1, min(decisions, V1))
    dev = assign.device

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "assign": assign.to(torch.int8).contiguous(),
        "lvl": zeros(B, V1),
        "dvar": zeros(B, D),
        "dphase": zeros(B, D, dtype=torch.int8),
        "dflip": zeros(B, D, dtype=torch.bool),
        "depth": zeros(B),
        "status": zeros(B),
        "step": zeros(B),
        "pref": (zeros(B, V1, dtype=torch.int8) if pref is None
                 else pref.to(torch.int8).expand(B, V1).contiguous()),
    }


def round_lane_plain(lits: torch.Tensor, state: Dict[str, torch.Tensor],
                     budget: int) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version over all lanes at once: each iteration runs
    the loop body for every lane and keeps it where the lane's own
    condition held, until no lane's does.  Returns a new state dict."""
    st = {k: state[k] for k in ROUND_STATE_FIELDS}
    A, lvl = st["assign"], st["lvl"]
    dvar, dphase, dflip = st["dvar"], st["dphase"], st["dflip"]
    depth, status, step, pref = (st["depth"], st["status"], st["step"],
                                 st["pref"])
    B, V1 = A.shape
    D = dvar.shape[1]
    dev = A.device
    lits = lits.to(torch.int64)
    var_idx = lits.abs()                      # [C, K]
    sign = lits.sign()
    is_real = lits != 0
    real_row = is_real.any(dim=1)             # [C]
    flat_var = var_idx.reshape(1, -1).expand(B, -1)
    lit_pos = (lits > 0).reshape(1, -1)
    lit_neg = (lits < 0).reshape(1, -1)
    idx = torch.arange(V1, device=dev)
    didx = torch.arange(D, device=dev)
    lanes = torch.arange(B, device=dev)

    while True:
        run = (status == 0) & (step < budget)
        if not bool(run.any()):
            break
        # clause scan: +1 satisfied, -1 false, 0 unknown literal
        vals = sign * A.to(torch.int64)[:, var_idx]            # [B, C, K]
        sat = ((vals > 0) & is_real).any(dim=2)
        unknown = (vals == 0) & is_real
        n_unknown = unknown.sum(dim=2)
        all_false = ((vals < 0) | ~is_real).all(dim=2) & real_row
        conflict = all_false.any(dim=1)
        unsat_yet = ~sat & real_row
        unit = unsat_yet & (n_unknown == 1)
        open_c = unsat_yet & (n_unknown > 1)
        forced = torch.where(unit[:, :, None] & unknown, lits, 0).sum(dim=2)
        fpos = torch.zeros((B, V1), dtype=torch.int32, device=dev)
        fpos.scatter_add_(1, forced.clamp(min=0),
                          (forced > 0).to(torch.int32))
        fneg = torch.zeros((B, V1), dtype=torch.int32, device=dev)
        fneg.scatter_add_(1, (-forced).clamp(min=0),
                          (forced < 0).to(torch.int32))
        open_unknown = (unknown & open_c[:, :, None]).reshape(B, -1)
        spos = torch.zeros((B, V1), dtype=torch.int32, device=dev)
        spos.scatter_add_(1, flat_var, (open_unknown & lit_pos)
                          .to(torch.int32))
        sneg = torch.zeros((B, V1), dtype=torch.int32, device=dev)
        sneg.scatter_add_(1, flat_var, (open_unknown & lit_neg)
                          .to(torch.int32))

        free = (A == 0) & (idx > 1)
        force_pos = (fpos > 0) & free
        force_neg = (fneg > 0) & free
        conflict = conflict | (force_pos & force_neg).any(dim=1)
        has_force = (force_pos | force_neg).any(dim=1)
        open_any = free.any(dim=1)
        active = status == 0

        # conflict: backtrack to the deepest unflipped decision
        unflipped = (didx < depth[:, None]) & ~dflip
        Lm = torch.where(unflipped, didx + 1, 0).amax(dim=1)   # 0 = none
        unsat_now = active & conflict & (Lm == 0)
        do_bt = active & conflict & (Lm > 0)
        bslot = (Lm - 1).clamp(min=0)
        bvar = dvar[lanes, bslot]
        bphase = -dphase[lanes, bslot]
        at_bvar = do_bt[:, None] & (idx == bvar[:, None])
        A1 = torch.where(do_bt[:, None] & (A != 0) & (lvl >= Lm[:, None]),
                         0, A)
        A1 = torch.where(at_bvar, bphase[:, None], A1)
        lvl1 = torch.where(at_bvar, Lm[:, None], lvl)
        popped = do_bt[:, None] & (didx >= Lm[:, None])
        at_b = do_bt[:, None] & (didx == bslot[:, None])
        dvar1 = torch.where(popped, 0, dvar)
        dphase1 = torch.where(popped, 0, torch.where(at_b, bphase[:, None],
                                                     dphase))
        dflip1 = torch.where(popped, False, torch.where(at_b, True, dflip))
        depth1 = torch.where(do_bt, Lm, depth)

        # quiet + forced: assign every forced literal at this level
        do_force = active & ~conflict & has_force
        assigned_now = do_force[:, None] & (force_pos | force_neg)
        delta = torch.where(force_pos, 1, -1)
        A2 = torch.where(assigned_now, delta, A1)
        lvl2 = torch.where(assigned_now, depth[:, None], lvl1)

        # quiet + open: decide (DLIS var, pref phase where nonzero)
        want = active & ~conflict & ~has_force & open_any
        can = depth < D
        do_dec = want & can
        bail = want & ~can
        score = torch.where(free, spos + sneg + 1, -1)
        var = torch.argmax(score, dim=1)
        dlis = torch.where(spos[lanes, var] >= sneg[lanes, var], 1, -1)
        p = pref[lanes, var].to(torch.int64)
        phase = torch.where(p != 0, p, dlis)
        ndepth = depth + 1
        # don't-care cascade: free vars in no open clause take +1
        dontcare = free & (spos + sneg == 0)
        at_var = idx == var[:, None]
        newly = do_dec[:, None] & (dontcare | at_var)
        A3 = torch.where(newly, torch.where(at_var, phase[:, None], 1), A2)
        lvl3 = torch.where(newly, ndepth[:, None], lvl2)
        at_new = do_dec[:, None] & (didx == depth[:, None])
        dvar2 = torch.where(at_new, var[:, None], dvar1)
        dphase2 = torch.where(at_new, phase[:, None], dphase1)
        dflip2 = torch.where(at_new, False, dflip1)
        depth2 = torch.where(do_dec, ndepth, depth1)

        done_sat = active & ~conflict & ~has_force & ~open_any
        status1 = torch.where(unsat_now, 2, status)
        status1 = torch.where(done_sat, 1, status1)
        status1 = torch.where(bail, 3, status1)

        keep = run[:, None]
        A = torch.where(keep, A3, A).to(torch.int8)
        lvl = torch.where(keep, lvl3, lvl).to(torch.int32)
        dvar = torch.where(keep, dvar2, dvar).to(torch.int32)
        dphase = torch.where(keep, dphase2, dphase).to(torch.int8)
        dflip = torch.where(keep, dflip2, dflip)
        depth = torch.where(run, depth2, depth).to(torch.int32)
        status = torch.where(run, status1, status).to(torch.int32)
        step = torch.where(run, step + 1, step).to(torch.int32)

    return {"assign": A, "lvl": lvl, "dvar": dvar, "dphase": dphase,
            "dflip": dflip, "depth": depth, "status": status, "step": step,
            "pref": pref}


def round_lane(lits: torch.Tensor, state: Dict[str, torch.Tensor],
               budget: int) -> Dict[str, torch.Tensor]:
    """One round: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (same signature and results as :func:`round_lane_plain`;
    the input state is not written)."""
    if lits.device.type == "cpu":
        return round_lane_plain(lits, state, budget)
    return _launch(lits, state, budget)


def solve_lane(lits: torch.Tensor, assign: torch.Tensor,
               budget: Optional[int] = None,
               decisions: Optional[int] = None):
    """The one-shot solve (``make_solve_step``): one round of ``budget``
    sweeps (``GATHER_STEPS``) from the zero state over ``assign [B, V1]``,
    a bail mapped to undecided.  Returns (assign', status [B] int32)."""
    from mythril_tpu_torch.ops.batched_sat import (
        GATHER_DECISIONS, GATHER_STEPS,
    )

    state = initial_state(assign, GATHER_DECISIONS if decisions is None
                          else decisions)
    out = round_lane(lits, state, GATHER_STEPS if budget is None else budget)
    status = torch.where(out["status"] == 3, 0, out["status"])
    return out["assign"], status


def _pad16(n: int) -> int:
    return (n + 15) & ~15


def layout(C: int, V1: int, D: int, S: int) -> dict:
    """One cluster block's shared memory at cluster size ``S`` (mirrors
    ``layout`` in ``csrc/round_lane.cu``): whether the block's pool rows
    stay ``resident`` in shared memory as int16 literals (else they are
    read from global memory every sweep), and the dynamic ``bytes``: the
    scores, levels and vote bitmaps of the ``Ws`` vars it owns, the
    stack, the replicas of the assignment and the phase preference, the
    words of bitmaps every block sends (16 bytes for 32 vars), a record
    for each of its ``n`` rows, and the resident rows."""
    Ws = (-(-V1 // S) + 31) & ~31
    n = -(-C // S)
    dp = _pad16(D)
    head = 12 * Ws + 2 * _pad16(Ws // 8) + 4 * dp + 2 * S * Ws + 2 * dp \
        + S * Ws // 2 + _pad16(2 * n)
    resident = V1 <= 32768 and head + 16 * n <= MAX_DYNAMIC_SMEM
    return {"resident": resident,
            "bytes": head + (16 * n if resident else 0)}


def cluster_size(B: int, C: int, V1: int, D: int) -> int:
    """Blocks a lane: the smallest power of two ``S`` whose ``B x S``
    blocks fill the card (up to the portable 8) and whose block fits; 0
    when no block fits."""
    S = 1
    while S <= MAX_CLUSTER:
        if (B * S >= CLUSTER_BLOCKS or S == MAX_CLUSTER) \
                and layout(C, V1, D, S)["bytes"] <= MAX_DYNAMIC_SMEM:
            return S
        S *= 2
    return 0


def smem_bytes(C: int, V1: int, D: int, S: int) -> int:
    """The kernel's dynamic shared memory for a block at cluster size
    ``S``."""
    return layout(C, V1, D, S)["bytes"]


def _scan(lits, A, rows):
    """The loop body's clause scan for every lane over the pool rows
    where ``rows [B, C]`` holds (all rows when None): (conflict [B],
    unit votes fpos / fneg [B, V1] as 0/1, DLIS scores spos / sneg [B,
    V1])."""
    B, V1 = A.shape
    dev = A.device
    lits = lits.to(torch.int64)
    is_real = lits != 0
    vals = lits.sign() * A.to(torch.int64)[:, lits.abs()]      # [B, C, K]
    use = is_real.any(dim=1)[None, :].expand(B, -1)
    if rows is not None:
        use = use & rows
    sat = ((vals > 0) & is_real).any(dim=2)
    unknown = (vals == 0) & is_real
    n_unknown = unknown.sum(dim=2)
    conflict = (((vals < 0) | ~is_real).all(dim=2) & use).any(dim=1)
    unit = use & ~sat & (n_unknown == 1)
    open_c = use & ~sat & (n_unknown > 1)
    forced = torch.where(unit[:, :, None] & unknown, lits, 0).sum(dim=2)
    out = [conflict]
    for sign in (1, -1):
        votes = torch.zeros((B, V1), dtype=torch.int64, device=dev)
        votes.scatter_add_(1, (sign * forced).clamp(min=0),
                           (sign * forced > 0).to(torch.int64))
        out.append(votes > 0)
    flat = lits.abs().reshape(1, -1).expand(B, -1)
    for sign in (1, -1):
        cells = (unknown & open_c[:, :, None]
                 & (sign * lits > 0)[None]).reshape(B, -1)
        scores = torch.zeros((B, V1), dtype=torch.int64, device=dev)
        scores.scatter_add_(1, flat, cells.to(torch.int64))
        out.append(scores)
    return out


def skip_record_model(lits: torch.Tensor, state: Dict[str, torch.Tensor],
                      budget: int):
    """The kernel's record of rows known satisfied, on the plain version,
    one sweep at a time.  Before each sweep a lane's recorded rows are
    dropped from its scan, and the scan is held against the full one; a
    row found satisfied at depth ``d`` is recorded at ``max(d, lmax) +
    1`` (``lmax``: the deepest level of the initial assignment),
    saturating at :data:`SATURATED`; a backtrack to ``Lm`` voids the
    records above ``Lm``.  Where the lane decides (no conflict, no free
    var voted), each free var's scores are held against its occurrences
    in the pool less those in the recorded rows, which is how the kernel
    counts them.  Returns (final state, counts): ``records`` made, row
    scans ``skipped``, records ``invalidated``, ``differs`` (sweeps whose
    scan without the recorded rows differs from the full scan) and
    ``score_differs`` (deciding sweeps whose scores differ from the
    occurrence count); both 0 where the kernel's way is exact."""
    st = {k: state[k].clone() for k in ROUND_STATE_FIELDS}
    B, V1 = st["assign"].shape
    dev = st["assign"].device
    lanes = torch.arange(B, device=dev)
    idx = torch.arange(V1, device=dev)
    wide = lits.to(torch.int64)
    flat = wide.abs().reshape(-1)
    occ = [torch.zeros(V1, dtype=torch.int64, device=dev).scatter_add_(
        0, flat, (sign * wide > 0).reshape(-1).to(torch.int64))
        for sign in (1, -1)]
    lmax = torch.where(st["assign"] != 0, st["lvl"], 0).amax(dim=1) \
        .clamp(min=0)
    rec = torch.zeros((B, lits.shape[0]), dtype=torch.int64, device=dev)
    counts = {"records": 0, "skipped": 0, "invalidated": 0, "differs": 0,
              "score_differs": 0}
    while True:
        run = (st["status"] == 0) & (st["step"] < budget)
        if not bool(run.any()):
            break
        full = _scan(lits, st["assign"], None)
        kept = _scan(lits, st["assign"], rec == 0)
        for a, b in zip(full, kept):
            diff = (a != b).reshape(B, -1).any(dim=1)
            counts["differs"] += int((diff & run).sum())
        counts["skipped"] += int(((rec != 0) & run[:, None]).sum())
        vals = wide.sign() * st["assign"].to(torch.int64)[:, wide.abs()]
        sat = (vals > 0).any(dim=2)
        level = (torch.maximum(st["depth"].to(torch.int64), lmax) + 1) \
            .clamp(max=SATURATED)
        new = sat & (rec == 0) & run[:, None]
        rec = torch.where(new, level[:, None], rec)
        counts["records"] += int(new.sum())
        conflict, fpos, fneg, spos, sneg = full
        free = (st["assign"] == 0) & (idx > 1)
        deciding = run & ~conflict & ~(free & (fpos | fneg)).any(dim=1) \
            & free.any(dim=1)
        held = (rec != 0)[:, :, None].expand(-1, -1, wide.shape[1]) \
            .reshape(B, -1)
        for score, sign, total in ((spos, 1, occ[0]), (sneg, -1, occ[1])):
            cells = held & (sign * wide > 0).reshape(1, -1)
            left = total[None, :] - torch.zeros(
                (B, V1), dtype=torch.int64, device=dev).scatter_add_(
                1, flat[None, :].expand(B, -1), cells.to(torch.int64))
            bad = (free & (score != left)).any(dim=1) & deciding
            counts["score_differs"] += int(bad.sum())
        # one sweep of the running lanes; the others frozen
        frozen = dict(st, step=torch.zeros_like(st["step"]),
                      status=torch.where(run, st["status"], 9))
        out = round_lane_plain(lits, frozen, 1)
        out["step"] = torch.where(run, st["step"] + 1, st["step"])
        out["status"] = torch.where(run, out["status"], st["status"])
        slot = (out["depth"] - 1).clamp(min=0).to(torch.int64)
        backtracked = run & (out["depth"] >= 1) \
            & ~st["dflip"][lanes, slot] & out["dflip"][lanes, slot]
        undone = backtracked[:, None] & (rec > out["depth"][:, None])
        counts["invalidated"] += int(undone.sum())
        rec = torch.where(undone, 0, rec)
        st = out
    return st, counts


def build_library() -> str:
    """Compile ``csrc/round_lane.cu`` into ``_build/`` when the library
    is missing or older than its source; returns the library path."""
    global build_info
    from mythril_tpu_torch.ops.dense_sweep import build_cuda_library

    info = build_cuda_library(SOURCE, LIBRARY)
    if info is not None:
        build_info = info
    return LIBRARY


#: (B, C, V1, D) at which ``load_library`` holds the library's cluster
#: rule and layout against this module's: the tiers' largest pools at
#: every cluster size, rows resident and not, and small cone shapes
MIRROR_SHAPES = ((64, 16384, 8193, 256), (8, 16384, 8193, 256),
                 (256, 16384, 8193, 256), (32, 16384, 2049, 256),
                 (16, 32768, 8193, 256), (4, 256, 257, 256),
                 (128, 512, 42, 3))


def bind(path: str, check: bool = True) -> ctypes.CDLL:
    """The library at ``path`` with its launch typed; with ``check``, its
    clause width, cluster rule and layout held against this module's (a
    mismatch raises).  Without, any library of the same launch interface
    binds (a design variant, an earlier tree's kernel)."""
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.round_lane_launch.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, ptr,
    ]
    lib.round_lane_launch.restype = i32
    if not check:
        return lib
    for name in ("round_lane_smem_bytes", "round_lane_cluster",
                 "round_lane_resident"):
        getattr(lib, name).argtypes = [i32, i32, i32, i32]
        getattr(lib, name).restype = i32
    lib.round_lane_width.restype = i32
    if lib.round_lane_width() != WIDTH:
        raise RuntimeError("round_lane.cu: clause width mismatch")
    for B, C, V1, D in MIRROR_SHAPES:
        S = cluster_size(B, C, V1, D)
        if lib.round_lane_cluster(B, C, V1, D) != S:
            raise RuntimeError(f"round_lane.cu: cluster rule mismatch at "
                               f"B={B} C={C} V1={V1} D={D}")
        for s in (1, 2, 4, 8):
            want = layout(C, V1, D, s)
            if (lib.round_lane_smem_bytes(C, V1, D, s) != want["bytes"]
                    or bool(lib.round_lane_resident(C, V1, D, s))
                    != want["resident"]):
                raise RuntimeError(f"round_lane.cu: shared-memory layout "
                                   f"mismatch at C={C} V1={V1} D={D} S={s}")
    return lib


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = bind(build_library())
    return _lib


def _launch(lits, state, budget):
    global launch_count
    device = lits.device
    if not lits.is_cuda:
        raise ValueError("round_lane: expected CUDA tensors (or all CPU)")
    if lits.dtype != torch.int32 or lits.dim() != 2:
        raise TypeError("round_lane: lits must be int32 [C, K]")
    C, K = lits.shape
    if C < 1 or K > WIDTH:
        raise ValueError(f"round_lane: lits [{C}, {K}], the kernel takes "
                         f"1+ rows of at most {WIDTH} literals")
    if K < WIDTH:
        lits = torch.nn.functional.pad(lits, (0, WIDTH - K))
    lits = lits.contiguous()
    B, V1 = state["assign"].shape
    D = state["dvar"].shape[1]
    shapes = {"assign": (B, V1), "lvl": (B, V1), "pref": (B, V1),
              "dvar": (B, D), "dphase": (B, D), "dflip": (B, D),
              "depth": (B,), "status": (B,), "step": (B,)}
    for key, shape in shapes.items():
        t = state[key]
        if t.device != device or t.dtype != _DTYPES[key]:
            raise TypeError(f"round_lane: {key} must be {_DTYPES[key]} on "
                            f"{device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"round_lane: {key} is {tuple(t.shape)}, "
                             f"expected {shape}")
    if B < 1 or V1 < 2 or D < 1:
        raise ValueError(f"round_lane: bad sizes B={B} V1={V1} D={D}")
    if not cluster_size(B, C, V1, D):
        raise ValueError(f"round_lane: C={C} V1={V1} D={D} need "
                         f"{smem_bytes(C, V1, D, MAX_CLUSTER)} bytes of "
                         f"shared memory a block at the largest cluster; "
                         f"a block has {MAX_DYNAMIC_SMEM}")
    if lits.data_ptr() % 16:
        raise ValueError("round_lane: lits must be 16-byte aligned")
    if int(lits.abs().max()) >= V1:
        raise ValueError(f"round_lane: a literal's var is >= V1={V1}")
    lib = load_library()
    out = {k: state[k].contiguous().clone() for k in ROUND_STATE_FIELDS
           if k != "pref"}
    out["pref"] = state["pref"].contiguous()
    err = lib.round_lane_launch(
        lits.data_ptr(), C, out["assign"].data_ptr(), out["lvl"].data_ptr(),
        out["dvar"].data_ptr(), out["dphase"].data_ptr(),
        out["dflip"].data_ptr(), out["depth"].data_ptr(),
        out["status"].data_ptr(), out["step"].data_ptr(),
        out["pref"].data_ptr(), B, V1, D, int(budget),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"round_lane kernel launch failed: cudaError "
                           f"{err}")
    with _lock:
        launch_count += 1
    return out
