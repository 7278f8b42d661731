"""The dense tier's DPLL step: a hand-written sm_90a CUDA kernel
(``csrc/dpll_step.cu``) and its plain PyTorch version.

Counterpart of the body of the ``while_loop`` in
``mythril_tpu/ops/pallas_prop.py:_dpll_round_loop`` (``:649-800``):
everything one step of the round does after the clause sweep, for every
lane.  :func:`dpll_step` takes the plain version only for tensors that
lie on the CPU; for tensors on the card it launches the kernel or
raises.

Both update the state in place.  ``state`` is the ``DPLL_STATE_FIELDS``
list of ``ops/dense_prop.py`` (``A``, ``pref`` f32 ``[B, V]``; ``lvl``
i32 ``[B, V]``; ``dvar`` i32 and ``dphase``, ``dflip``, ``dbulk`` f32
``[B, D]``; ``depth``, ``status``, ``active`` i32 and ``taint`` f32
``[B, 1]``); ``outs`` is the sweep's ``(fpos, fneg, conf[, spos,
sneg])`` (five with decisions on), which the step zeroes after reading
them when ``clear`` is set (the round's sweep workspace); ``flags`` is
an int32 ``[2]``: ``flags[1]`` becomes at least ``step + 1`` when a lane
was live before the step (the JAX loop's step count), ``flags[0]`` when
a lane is live after it (the host's loop condition).  ``full_view`` and
``hot_gate`` are the step's host flags: the sweep saw every clause row;
decisions wait for a hot open clause.

The kernel builds with ``nvcc`` at first use into
``mythril_tpu_torch/_build/`` (a plain C entry point, loaded with
ctypes).
"""

import ctypes
import os
import threading
from typing import Dict, Optional, Sequence

import torch

from mythril_tpu_torch.ops.dense_sweep import BUILD_DIR, build_cuda_library

# chunked decisions: after DPLL_SINGLE_WINDOW single-var levels, each
# level assigns the top-K scoring free vars at once (a conflict that
# backtracks into a bulk level taints the lane: its exhaustion is no
# longer a refutation)
DPLL_SINGLE_WINDOW = 8
DPLL_BULK_K = 16

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "ops", "csrc", "dpll_step.cu")
LIBRARY = os.path.join(BUILD_DIR, "libdpll_step.so")
#: the kernel keeps a deciding lane's score row in shared memory
MAX_SCORE_COLS = 32768
#: pointers the C entry point takes, in this order
_POINTERS = 17

#: kernel launches since the last reset (the wrapper adds one per launch
#: and nowhere else)
launch_count = 0
#: (seconds, compiler output) of this process's build, when it built
build_info: Optional[tuple] = None
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _top_k(score: torch.Tensor, k: int):
    """``lax.top_k`` semantics: the k largest per row, ties in ascending
    index order (a stable descending sort; ``torch.topk`` promises no tie
    order on the card)."""
    vals, idxs = torch.sort(score, dim=1, descending=True, stable=True)
    return vals[:, :k], idxs[:, :k]


def _transition(state, outs, full_view: bool, hot_gate: bool):
    """The step's new state (A, lvl, dvar, dphase, dflip, dbulk, depth,
    status, taint), the lanes live before it, and the per-lane masks of
    the transitions it took (:data:`STEP_EVENTS`)."""
    A, lvl, dvar, dphase, dflip, dbulk, depth, status, taint, _, pref = state
    decisions_on = len(outs) == 5
    if decisions_on:
        fpos, fneg, conf, spos, sneg = outs
    else:
        fpos, fneg, conf = outs
    V, D = A.shape[1], dvar.shape[1]
    dev = A.device
    col = torch.arange(V, dtype=torch.int32, device=dev)[None, :]
    dcol = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    krow = torch.arange(DPLL_BULK_K, device=dev)[None, :]
    active = status == 0                           # [B,1]
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
    no_false = torch.zeros_like(active)
    gated = no_false
    if hot_gate:
        # hot-quiescence gate: no open HOT clause to score means
        # waiting for the full-cone sweep
        hot_open = (spos + sneg > 0.5).any(dim=1, keepdim=True)
        gated = want & ~hot_open
        want = want & hot_open
    events = {"single": no_false, "bulk": no_false, "tie": no_false,
              "warm": no_false, "dontcare": no_false,
              "bail at D": no_false, "bail, decisions off": no_false}
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
        n_keep = keep.sum(dim=1, keepdim=True)
        events.update({
            "single": do_dec & (n_keep == 1),
            "bulk": do_dec & (n_keep == DPLL_BULK_K),
            # a kept column whose score the next one ties: the column
            # order decides between them
            "tie": do_dec & (keep[:, :-1] & (vals[:, 1:] == vals[:, :-1]))
            .any(dim=1, keepdim=True),
            "warm": do_dec & (pref.gather(1, primary) != 0.0),
            "dontcare": do_dec & (dontcare & ~chosen).any(dim=1,
                                                           keepdim=True),
            "bail at D": bail,
        })
    else:
        bail = want
        A3, lvl3 = A2, lvl2
        dvar2, dphase2, dflip2, depth2 = dvar1, dphase1, dflip1, depth1
        dbulk2 = dbulk1
        events["bail, decisions off"] = bail

    # --- quiet and complete on a full view: SAT candidate
    done_sat = active & ~conflict & ~has_force & ~open_any \
        & full_view
    # tainted exhaustion is NOT a refutation — report undecided
    status1 = torch.where(
        unsat_now, 2 + (taint1 > 0.5).to(torch.int32), status
    )
    status1 = torch.where(done_sat, 1, status1)
    status1 = torch.where(bail, 3, status1)  # 3 = budget-bailed
    events.update({
        "backtrack": do_bt & ~bulk_popped,
        "bulk backtrack": do_bt & bulk_popped,
        "unsat": unsat_now & (taint1 <= 0.5),
        "tainted exhaustion": unsat_now & (taint1 > 0.5),
        "force": do_force,
        "contradiction": active & contra,
        "hot gate": gated,
        "sat": done_sat,
        "retired": ~active,
    })
    new = (A3, lvl3, dvar2, dphase2, dflip2, dbulk2, depth2, status1,
           taint1)
    return new, active, events


#: the transitions :func:`step_events` counts
STEP_EVENTS = (
    "backtrack", "bulk backtrack", "unsat", "tainted exhaustion", "force",
    "contradiction", "single", "bulk", "tie", "warm", "dontcare",
    "bail at D", "bail, decisions off", "hot gate", "sat", "retired",
)


def step_events(state, outs, full_view: bool, hot_gate: bool
                ) -> Dict[str, int]:
    """Lanes taking each transition of :data:`STEP_EVENTS` in the step
    from ``state`` (nothing is written): backtracks (into a bulk level:
    taint), UNSAT with no decision left, tainted exhaustion, forces,
    contradictions, single-var decisions, bulk decisions of the full K
    columns, decisions whose kept scores tie, warm-start phases,
    don't-care cascades, bails at the stack's depth and with decisions
    off, hot-gated lanes, SAT completions and retired lanes."""
    _, _, events = _transition(state, outs, full_view, hot_gate)
    return {name: int(events[name].sum()) for name in STEP_EVENTS}


def dpll_step_plain(state: Sequence[torch.Tensor], outs, flags, step: int,
                    full_view: bool, hot_gate: bool, clear: bool) -> None:
    """Plain version of :func:`dpll_step` (any device): the eager body of
    the round loop, written back in place."""
    new, active, _ = _transition(state, outs, full_view, hot_gate)
    for dst, src in zip(state[:9], new):
        dst.copy_(src)
    state[9].add_(active.to(torch.int32))
    live_after = (new[7] == 0).any().to(torch.int32)
    flags[1] = torch.maximum(flags[1], active.any().to(torch.int32)
                             * (step + 1))
    flags[0] = torch.maximum(flags[0], live_after * (step + 1))
    if clear:
        for out in outs:
            out.zero_()


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def bind(path: str) -> ctypes.CDLL:
    """Load a build of ``dpll_step.cu`` and declare its entry points
    (``dpll_step_launch`` in a CUDA build, ``dpll_step_host`` in a host
    C++ build)."""
    lib = ctypes.CDLL(path)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    ints = [c_int] * 8
    if hasattr(lib, "dpll_step_launch"):
        lib.dpll_step_launch.argtypes = [ptr, *ints, ptr]
        lib.dpll_step_launch.restype = c_int
    else:
        lib.dpll_step_host.argtypes = [ptr, *ints]
        lib.dpll_step_host.restype = c_int
    for name in ("dpll_step_threads", "dpll_step_bulk_k",
                 "dpll_step_single_window", "dpll_step_max_score_cols"):
        getattr(lib, name).restype = c_int
    if (lib.dpll_step_bulk_k(), lib.dpll_step_single_window(),
            lib.dpll_step_max_score_cols()) != (
            DPLL_BULK_K, DPLL_SINGLE_WINDOW, MAX_SCORE_COLS):
        raise RuntimeError("dpll_step: the kernel's constants differ from "
                           "the wrapper's")
    return lib


def load_library() -> ctypes.CDLL:
    global _lib, build_info
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            info = build_cuda_library(SOURCE, LIBRARY)
            lib = bind(LIBRARY)
            if info is not None:
                build_info = info
            _lib = lib
    return _lib


def step_args(state, outs, flags, step: int, full_view: bool,
              hot_gate: bool, clear: bool):
    """Check the step's tensors and give the C entry point's arguments
    after the stream: (pointer array, B, V, D, step, full_view, hot_gate,
    decisions, clear).  Raises on a dtype, shape, device or contiguity
    the kernel does not take."""
    if len(state) != 11 or len(outs) not in (3, 5):
        raise ValueError("dpll_step: 11 state fields and 3 or 5 sweep "
                         "outputs")
    A, lvl, dvar, dphase, dflip, dbulk, depth, status, taint, active, \
        pref = state
    decisions = len(outs) == 5
    B, V = A.shape
    D = dvar.shape[1]
    f32, i32 = torch.float32, torch.int32
    want = [(A, f32, (B, V)), (lvl, i32, (B, V)), (dvar, i32, (B, D)),
            (dphase, f32, (B, D)), (dflip, f32, (B, D)),
            (dbulk, f32, (B, D)), (depth, i32, (B, 1)),
            (status, i32, (B, 1)), (taint, f32, (B, 1)),
            (active, i32, (B, 1)), (pref, f32, (B, V)),
            (outs[0], f32, (B, V)), (outs[1], f32, (B, V)),
            (outs[2], f32, (B, 1))]
    if decisions:
        want += [(outs[3], f32, (B, V)), (outs[4], f32, (B, V))]
    want.append((flags, i32, (2,)))
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"dpll_step: a {t.dtype} {tuple(t.shape)} "
                            f"tensor where {dtype} {shape} is taken")
        if t.device != A.device or not t.is_contiguous():
            raise ValueError("dpll_step: every tensor contiguous, on one "
                             "device")
    if B < 1 or V < 2 or D < 1 or (decisions and V > MAX_SCORE_COLS):
        raise ValueError(f"dpll_step: B={B} V={V} D={D} (decisions "
                         f"{decisions}; at most {MAX_SCORE_COLS} columns "
                         f"with decisions)")
    if hot_gate and not decisions:
        raise ValueError("dpll_step: the hot gate needs the sweep's scores")
    ptrs = [t.data_ptr() for t in state] + [t.data_ptr() for t in outs[:3]]
    ptrs += ([outs[3].data_ptr(), outs[4].data_ptr()] if decisions
             else [None, None])
    ptrs.append(flags.data_ptr())
    assert len(ptrs) == _POINTERS
    return ((ctypes.c_void_p * _POINTERS)(*ptrs), B, V, D, int(step),
            int(bool(full_view)), int(bool(hot_gate)), int(decisions),
            int(bool(clear)))


def dpll_step(state: Sequence[torch.Tensor], outs, flags, step: int,
              full_view: bool, hot_gate: bool, clear: bool) -> None:
    """One DPLL step of every lane, in place: one launch of
    ``csrc/dpll_step.cu`` for tensors on the card, the plain version for
    tensors on the CPU."""
    global launch_count
    if state[0].device.type == "cpu":
        dpll_step_plain(state, outs, flags, step, full_view, hot_gate, clear)
        return
    args = step_args(state, outs, flags, step, full_view, hot_gate, clear)
    lib = load_library()
    err = lib.dpll_step_launch(
        *args, torch.cuda.current_stream(state[0].device).cuda_stream)
    if err:
        raise RuntimeError(f"dpll_step kernel launch failed: cudaError {err}")
    launch_count += 1
