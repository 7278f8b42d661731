"""The dense tier's clause sweep: a hand-written sm_90a CUDA kernel
(``csrc/dense_sweep.cu``) and its plain PyTorch version.

Counterpart of the Pallas kernel ``mythril_tpu/ops/pallas_prop.py``
``_make_dpll_sweep`` (the one ``pl.pallas_call`` of the JAX package).
:func:`dense_sweep` takes the plain version only for tensors that lie
on the CPU; for CUDA tensors it launches the kernel or raises.

The kernel is compiled with ``nvcc`` at first use into
``mythril_tpu_torch/_build/`` (a plain C entry point, loaded with
ctypes), so the first CUDA call of a process pays a few seconds of
build.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
import weakref
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "ops", "csrc", "dense_sweep.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libdense_sweep.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
#: counts are float32 sums of 0/1 terms: exact only below 2^24
MAX_ROWS = 1 << 24
#: the kernel keeps one row's nonzero cells in shared memory (kMaxNz =
#: 2048 in the source); a row holds its literals plus, in row 0, the
#: padding cell (0, 0), so clauses may have at most 2047 literals
MAX_ROW_LITERALS = 2047

#: kernel launches since the last reset (the wrapper adds one per
#: launch and nowhere else)
launch_count = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
#: (seconds, compiler output) of this process's build, when it built
build_info: Optional[tuple] = None
#: (weak reference, version) of the last width tensor found in range, so
#: a dispatch's sweeps read its widths back to the host once
_width_ok: tuple = (None, -1)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


#: toolkit roots searched for ``bin/nvcc`` before ``PATH``
CUDA_HOMES = (os.environ.get("CUDA_HOME"), "/usr/local/cuda")


def _nvcc() -> str:
    for home in CUDA_HOMES:
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the dense sweep kernel builds only where "
            "the CUDA toolkit is installed"
        )
    return found


def build_library() -> str:
    """Compile ``csrc/dense_sweep.cu`` into ``_build/`` when the library
    is missing or older than its source; returns the library path.  The
    build goes to a temporary name and is renamed into place, so
    concurrent first calls never load a half-written file."""
    global build_info
    if os.path.exists(LIBRARY) and (
        os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)
    ):
        return LIBRARY
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    started = time.perf_counter()
    try:
        done = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
            capture_output=True, text=True,
        )
        if done.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({done.returncode}):\n{done.stderr}"
            )
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info = (time.perf_counter() - started, done.stderr)
    return LIBRARY


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            ptr = ctypes.c_void_p
            lib.dense_sweep_launch.argtypes = [
                ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ptr,
            ]
            lib.dense_sweep_launch.restype = ctypes.c_int
            lib.dense_sweep_max_lanes.restype = ctypes.c_int
            lib.dense_sweep_max_row_cells.restype = ctypes.c_int
            if lib.dense_sweep_max_row_cells() != MAX_ROW_LITERALS + 1:
                raise RuntimeError("dense_sweep: row-cell cap mismatch")
            _lib = lib
    return _lib


def sweep_plain(P, N, width, A, scores: bool, rows: Optional[int] = None):
    """Plain PyTorch version of the sweep, in float32 (0/1 products and
    integer sums below 2^24 are exact, so it agrees with the kernel and
    with the JAX bf16-in/f32-accumulate dots bit for bit).

    ``P``/``N`` [C, V] 0/1 planes, ``width`` [1, C] f32, ``A`` [B, V]
    f32 in {-1, 0, +1}; ``rows`` restricts the scan to the leading rows
    (the hot tier).  Returns (fpos, fneg, conf[, spos, sneg])."""
    if rows is not None:
        P, N, width = P[:rows], N[:rows], width[:, :rows]
    Pf = P.float()
    Nf = N.float()
    pos = A.clamp(min=0.0)
    neg = (-A).clamp(min=0.0)
    true_cnt = pos @ Pf.T + neg @ Nf.T      # [B, C]
    false_cnt = neg @ Pf.T + pos @ Nf.T
    real = width > 0.5
    all_false = real & (false_cnt > width - 0.5)
    unk_cnt = width - true_cnt - false_cnt
    unsat_yet = (true_cnt < 0.5) & real
    unit = (unsat_yet & (unk_cnt > 0.5) & (unk_cnt < 1.5)).float()
    fpos = unit @ Pf
    fneg = unit @ Nf
    conf = all_false.any(dim=1, keepdim=True).float()
    if scores:
        open_c = (unsat_yet & (unk_cnt > 1.5)).float()
        return fpos, fneg, conf, open_c @ Pf, open_c @ Nf
    return fpos, fneg, conf


def dense_sweep(P, N, width, A, scores: bool, rows: Optional[int] = None):
    """One clause sweep: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (same signature and results as
    :func:`sweep_plain`)."""
    if P.device.type == "cpu":
        return sweep_plain(P, N, width, A, scores, rows)
    return _launch(P, N, width, A, scores, rows)


def _check_widths(width) -> None:
    """Refuse clauses wider than the kernel's shared-memory row list."""
    global _width_ok
    ref, version = _width_ok
    if ref is not None and ref() is width and width._version == version:
        return
    widest = float(width.max()) if width.numel() else 0.0
    if widest > MAX_ROW_LITERALS:
        raise ValueError(
            f"dense_sweep: a clause of {widest:.0f} literals; the kernel "
            f"takes at most {MAX_ROW_LITERALS}"
        )
    _width_ok = (weakref.ref(width), width._version)


def _launch(P, N, width, A, scores, rows):
    global launch_count
    tensors = (P, N, width, A)
    if any(not t.is_cuda for t in tensors):
        raise ValueError("dense_sweep: expected CUDA tensors (or all CPU)")
    C, V = P.shape
    B = A.shape[0]
    rows = C if rows is None else int(rows)
    if (
        P.dtype != torch.bfloat16 or N.dtype != torch.bfloat16
        or width.dtype != torch.float32 or A.dtype != torch.float32
    ):
        raise TypeError("dense_sweep: planes bf16, width/assignment f32")
    if (
        N.shape != (C, V) or width.shape != (1, C) or A.shape != (B, V)
        or not all(t.is_contiguous() for t in tensors)
    ):
        raise ValueError("dense_sweep: bad shapes or non-contiguous inputs")
    if not 0 <= rows <= C or C > MAX_ROWS or V % 8:
        raise ValueError(f"dense_sweep: rows={rows} C={C} V={V}")
    if P.data_ptr() % 16 or N.data_ptr() % 16:
        raise ValueError("dense_sweep: planes must be 16-byte aligned")
    _check_widths(width)
    lib = load_library()
    if not 1 <= B <= lib.dense_sweep_max_lanes():
        raise ValueError(f"dense_sweep: {B} lanes, kernel takes at most "
                         f"{lib.dense_sweep_max_lanes()}")
    out = [torch.zeros((B, V), dtype=torch.float32, device=P.device)
           for _ in range(4 if scores else 2)]
    conf = torch.zeros((B, 1), dtype=torch.float32, device=P.device)
    fpos, fneg = out[0], out[1]
    spos, sneg = (out[2], out[3]) if scores else (None, None)
    if rows == 0:   # nothing to scan: no launch, nothing counted
        return (fpos, fneg, conf, spos, sneg) if scores else (fpos, fneg, conf)
    err = lib.dense_sweep_launch(
        P.data_ptr(), N.data_ptr(), width.data_ptr(), A.data_ptr(),
        B, V, rows, fpos.data_ptr(), fneg.data_ptr(), conf.data_ptr(),
        spos.data_ptr() if scores else None,
        sneg.data_ptr() if scores else None,
        1 if scores else 0,
        torch.cuda.current_stream(P.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"dense_sweep kernel launch failed: cudaError {err}")
    launch_count += 1
    if scores:
        return fpos, fneg, conf, spos, sneg
    return fpos, fneg, conf
