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
runs the whole loop of every lane in one launch; the library builds
with ``nvcc`` at first use into ``mythril_tpu_torch/_build/``, under a
lock (the async prefetch's worker thread may be the first caller).
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
#: dynamic shared memory a block may take on sm_90: 227 KB, less 1 KB
#: for the kernel's static shared variables
MAX_DYNAMIC_SMEM = 232448 - 1024

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


def smem_bytes(V1: int, D: int) -> int:
    """The kernel's dynamic shared memory for a lane (mirrors the
    layout in ``csrc/round_lane.cu``)."""
    def pad16(n):
        return (n + 15) & ~15

    return 4 * 3 * pad16(V1) + 4 * 2 * pad16((V1 + 31) // 32) \
        + 4 * pad16(D) + 2 * pad16(V1) + 2 * pad16(D)


def build_library() -> str:
    """Compile ``csrc/round_lane.cu`` into ``_build/`` when the library
    is missing or older than its source; returns the library path."""
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
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.round_lane_launch.argtypes = [
                ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                i32, i32, i32, i32, ptr,
            ]
            lib.round_lane_launch.restype = i32
            lib.round_lane_smem_bytes.argtypes = [i32, i32]
            lib.round_lane_smem_bytes.restype = i32
            lib.round_lane_width.restype = i32
            if lib.round_lane_width() != WIDTH:
                raise RuntimeError("round_lane.cu: clause width mismatch")
            if lib.round_lane_smem_bytes(8193, 256) != smem_bytes(8193, 256):
                raise RuntimeError("round_lane.cu: shared-memory layout "
                                   "mismatch")
            _lib = lib
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
    if smem_bytes(V1, D) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"round_lane: V1={V1} D={D} need "
                         f"{smem_bytes(V1, D)} bytes of shared memory; a "
                         f"block has {MAX_DYNAMIC_SMEM}")
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
