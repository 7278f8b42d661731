"""The dense tier's clause sweep: a hand-written sm_90a CUDA kernel
(``csrc/dense_sweep.cu``) and its plain PyTorch versions.

Counterpart of the Pallas kernel ``mythril_tpu/ops/pallas_prop.py``
``_make_dpll_sweep`` (the one ``pl.pallas_call`` of the JAX package).
The JAX kernel streams two dense clause-incidence planes ``P, N [C, V]``;
the port's union layout keeps only the clause rows' literals
(:class:`SweepRows`: CSR row pointers and one cell a (row, column,
sign) incidence), and the kernel reads those.  :func:`dense_sweep` takes
the plain version over the rows (:func:`sweep_rows_plain`) only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises.  :func:`sweep_plain` over planes stays the reference both are
held against, with :func:`rows_to_planes` / :func:`planes_to_rows`
between the two forms.

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
from typing import NamedTuple, Optional

import numpy as np
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
#: a cell's sign bits: the literal is positive (a cell of P) or negative
#: (a cell of N); the column sits above them
CELL_P, CELL_N = 1, 2

#: kernel launches since the last reset (the wrapper adds one per
#: launch and nowhere else)
launch_count = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
#: (seconds, compiler output) of this process's build, when it built
build_info: Optional[tuple] = None


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


class SweepRows(NamedTuple):
    """A clause pool as the sweep reads it: ``indptr`` int32 [C + 1] (row
    ``r``'s cells are ``cells[indptr[r]:indptr[r + 1]]``), ``cells`` int32
    [nnz], each ``(column << 2) | sign`` with ``sign`` :data:`CELL_P` or
    :data:`CELL_N`, no cell twice, and ``width`` [1, C] f32 (a row's
    literal count; 0 for bucket padding).  The same function as the
    planes ``P[r, column] = 1`` for a :data:`CELL_P` cell and
    ``N[r, column] = 1`` for a :data:`CELL_N` cell."""

    indptr: torch.Tensor
    cells: torch.Tensor
    width: torch.Tensor


def rows_from_coords(row, col, negative, width: np.ndarray, num_cols: int,
                     device) -> SweepRows:
    """:class:`SweepRows` on ``device`` from host (row, column, sign)
    coordinates in any order, duplicates allowed (they count once, as
    repeated writes into a plane do).  ``width`` is the [1, C] host row
    of widths.  Sorted by row on the host; only the row pointers, cells
    and widths are shipped."""
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    C = width.shape[1]
    if row.size and (row.min() < 0 or row.max() >= C or col.min() < 0
                     or col.max() >= num_cols):
        raise ValueError(f"sweep rows: a coordinate outside [0, {C}) x "
                         f"[0, {num_cols})")
    cell = (col << 2) | np.where(np.asarray(negative, bool), CELL_N, CELL_P)
    key = np.unique((row << 32) | cell)  # by row, then cell; each once
    indptr = np.zeros(C + 1, np.int32)
    np.cumsum(np.bincount(key >> 32, minlength=C), out=indptr[1:])
    cells = (key & 0xFFFFFFFF).astype(np.int32)
    return SweepRows(torch.from_numpy(indptr).to(device),
                     torch.from_numpy(cells).to(device),
                     torch.from_numpy(np.ascontiguousarray(
                         width, np.float32)).to(device))


def rows_to_planes(rows: SweepRows, V: int):
    """The dense bf16 planes (P, N) [C, V] of ``rows``, on the rows'
    device: the form the JAX package and :func:`sweep_plain` read."""
    indptr, cells, width = rows
    C = width.shape[1]
    counts = (indptr[1:] - indptr[:-1]).long()
    row = torch.repeat_interleave(
        torch.arange(C, device=cells.device), counts)
    cell = cells.long()
    col = cell >> 2
    planes = []
    for sign in (CELL_P, CELL_N):
        hit = (cell & sign) != 0
        plane = torch.zeros((C, V), dtype=torch.bfloat16,
                            device=cells.device)
        plane[row[hit], col[hit]] = 1
        planes.append(plane)
    return tuple(planes)


def planes_to_rows(P, N, width) -> SweepRows:
    """:class:`SweepRows` of the planes ``P, N`` [C, V] (any nonzero cell
    counts as an incidence) and ``width`` [1, C], on the planes' device."""
    C, V = P.shape
    rows, cells = [], []
    for plane, sign in ((P, CELL_P), (N, CELL_N)):
        r, c = (plane != 0).nonzero(as_tuple=True)
        rows.append(r)
        cells.append((c << 2) | sign)
    row = torch.cat(rows)
    cell = torch.cat(cells)
    order = torch.argsort(row * (4 * V) + cell)
    indptr = torch.zeros(C + 1, dtype=torch.int64, device=P.device)
    indptr[1:] = torch.cumsum(torch.bincount(row, minlength=C), 0)
    return SweepRows(indptr.to(torch.int32), cell[order].to(torch.int32),
                     width.to(torch.float32).contiguous())


#: toolkit roots searched for ``bin/nvcc`` before ``PATH``
CUDA_HOMES = (os.environ.get("CUDA_HOME"), "/usr/local/cuda")


def _nvcc() -> str:
    for home in CUDA_HOMES:
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build only where "
            "the CUDA toolkit is installed"
        )
    return found


def build_cuda_library(source: str, library: str) -> Optional[tuple]:
    """Compile ``source`` into the shared library ``library`` when it is
    missing or older than its source.  The build goes to a temporary
    name and is renamed into place, so concurrent first calls never load
    a half-written file.  Returns (seconds, compiler output) when it
    built, None when the library was current."""
    if os.path.exists(library) and (
        os.path.getmtime(library) >= os.path.getmtime(source)
    ):
        return None
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(library), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
    os.close(fd)
    started = time.perf_counter()
    try:
        done = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, source],
            capture_output=True, text=True,
        )
        if done.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({done.returncode}):\n{done.stderr}"
            )
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - started, done.stderr


def build_library() -> str:
    """Compile ``csrc/dense_sweep.cu`` into ``_build/`` when the library
    is missing or older than its source; returns the library path."""
    global build_info
    info = build_cuda_library(SOURCE, LIBRARY)
    if info is not None:
        build_info = info
    return LIBRARY


def bind(path: str) -> ctypes.CDLL:
    """Load a build of ``dense_sweep.cu`` and declare its entry points
    (``dense_sweep_launch`` in a CUDA build, ``dense_sweep_host`` in a
    host C++ build): (indptr, cells, width, A, B, V, rows, fpos, fneg,
    conf, spos, sneg, scores[, stream])."""
    lib = ctypes.CDLL(path)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    args = [ptr] * 4 + [c_int] * 3 + [ptr] * 5 + [c_int]
    if hasattr(lib, "dense_sweep_launch"):
        lib.dense_sweep_launch.argtypes = [*args, ptr]
        lib.dense_sweep_launch.restype = c_int
    else:
        lib.dense_sweep_host.argtypes = args
        lib.dense_sweep_host.restype = c_int
    return lib


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = bind(build_library())
    return _lib


def _classify(true_cnt, false_cnt, width):
    """(conf [B, 1], unit [B, C], open [B, C]) of the sweep's counts."""
    real = width > 0.5
    all_false = real & (false_cnt > width - 0.5)
    unk_cnt = width - true_cnt - false_cnt
    unsat_yet = (true_cnt < 0.5) & real
    unit = (unsat_yet & (unk_cnt > 0.5) & (unk_cnt < 1.5)).float()
    open_c = (unsat_yet & (unk_cnt > 1.5)).float()
    return all_false.any(dim=1, keepdim=True).float(), unit, open_c


def sweep_plain(P, N, width, A, scores: bool, rows: Optional[int] = None):
    """Plain PyTorch version of the sweep over dense planes, in float32
    (0/1 products and integer sums below 2^24 are exact, so it agrees
    with the kernel and with the JAX bf16-in/f32-accumulate dots bit for
    bit): the reference the rows' versions are held against.

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
    conf, unit, open_c = _classify(true_cnt, false_cnt, width)
    fpos = unit @ Pf
    fneg = unit @ Nf
    if scores:
        return fpos, fneg, conf, open_c @ Pf, open_c @ Nf
    return fpos, fneg, conf


def sweep_rows_plain(indptr, cells, width, A, scores: bool,
                     rows: Optional[int] = None):
    """Plain PyTorch version of the sweep over :class:`SweepRows`: each
    cell's assignment gathered, counts summed into their rows and the
    unit / open memberships into their columns with ``index_add_`` (0/1
    terms, integer sums below 2^24: exact in any order, so equal to
    :func:`sweep_plain` on the same clauses bit for bit).  Same
    arguments and results as :func:`sweep_plain`, the planes given as
    rows."""
    B, V = A.shape
    R = width.shape[1] if rows is None else int(rows)
    dev = A.device
    counts = (indptr[1:R + 1] - indptr[:R]).long()
    row = torch.repeat_interleave(torch.arange(R, device=dev), counts)
    cell = cells[int(indptr[0]):int(indptr[R])].long()
    col = cell >> 2
    p = (cell & CELL_P).float()
    n = ((cell & CELL_N) >> 1).float()
    a = A[:, col]                             # [B, nnz]
    pos = (a > 0).float()
    neg = (a < 0).float()
    zeros = torch.zeros((B, R), dtype=torch.float32, device=dev)
    true_cnt = zeros.clone().index_add_(1, row, pos * p + neg * n)
    false_cnt = zeros.index_add_(1, row, neg * p + pos * n)
    conf, unit, open_c = _classify(true_cnt, false_cnt, width[:, :R])

    def scatter(member):
        at = member[:, row]                   # [B, nnz]
        return [torch.zeros((B, V), dtype=torch.float32,
                            device=dev).index_add_(1, col, at * sign)
                for sign in (p, n)]

    fpos, fneg = scatter(unit)
    if scores:
        return (fpos, fneg, conf, *scatter(open_c))
    return fpos, fneg, conf


def dense_sweep(indptr, cells, width, A, scores: bool,
                rows: Optional[int] = None, out=None):
    """One clause sweep over :class:`SweepRows` (``indptr``, ``cells``,
    ``width``): the CUDA kernel for CUDA tensors, the plain version over
    the rows for CPU tensors (results as :func:`sweep_plain`'s on the
    same clauses).

    ``out`` (fpos, fneg, conf[, spos, sneg]), zeroed, receives the
    results in place of fresh tensors and is returned: the round loop's
    sweep workspace, which the DPLL step zeroes again after reading it
    (``ops/dpll_step.py``).  The sweep adds its counts into it and
    stores 1.0 into ``conf`` where a lane has a conflict (on the CPU
    too, as the kernel does), so a workspace left dirty shows in the
    results."""
    if A.device.type == "cpu":
        got = sweep_rows_plain(indptr, cells, width, A, scores, rows)
        if out is None:
            return got
        for i, (dst, src) in enumerate(zip(out, got)):
            if i == 2:
                dst.masked_fill_(src > 0.5, 1.0)
            else:
                dst.add_(src)
        return tuple(out)
    return _launch(indptr, cells, width, A, scores, rows, out)


def _check_out(out, scores, B, V, device) -> None:
    """Refuse a workspace the kernel cannot write into."""
    shapes = [(B, V), (B, V), (B, 1)] + ([(B, V), (B, V)] if scores else [])
    if len(out) != len(shapes) or any(
        t.dtype != torch.float32 or tuple(t.shape) != shape
        or t.device != device or not t.is_contiguous()
        for t, shape in zip(out, shapes)
    ):
        raise ValueError("dense_sweep: the output workspace takes "
                         "contiguous f32 (fpos, fneg, conf[, spos, sneg])")


def _launch(indptr, cells, width, A, scores, rows, out=None):
    global launch_count
    tensors = (indptr, cells, width, A)
    if any(not t.is_cuda or t.device != A.device for t in tensors):
        raise ValueError("dense_sweep: expected CUDA tensors on one device "
                         "(or all CPU)")
    C = width.shape[1]
    B, V = A.shape
    rows = C if rows is None else int(rows)
    if (
        indptr.dtype != torch.int32 or cells.dtype != torch.int32
        or width.dtype != torch.float32 or A.dtype != torch.float32
    ):
        raise TypeError("dense_sweep: indptr/cells int32, width/assignment "
                        "f32")
    if (
        indptr.shape != (C + 1,) or cells.dim() != 1
        or width.shape != (1, C) or A.dim() != 2
        or not all(t.is_contiguous() for t in tensors)
    ):
        raise ValueError("dense_sweep: bad shapes or non-contiguous inputs")
    if not 0 <= rows <= C or C > MAX_ROWS or B < 1 or V < 1:
        raise ValueError(f"dense_sweep: rows={rows} C={C} B={B} V={V}")
    lib = load_library()
    if out is None:
        planes = [torch.zeros((B, V), dtype=torch.float32, device=A.device)
                  for _ in range(4 if scores else 2)]
        conf = torch.zeros((B, 1), dtype=torch.float32, device=A.device)
    else:
        _check_out(out, scores, B, V, A.device)
        planes = [out[0], out[1], *out[3:]]
        conf = out[2]
    fpos, fneg = planes[0], planes[1]
    spos, sneg = (planes[2], planes[3]) if scores else (None, None)
    if rows == 0:   # nothing to scan: no launch, nothing counted
        return (fpos, fneg, conf, spos, sneg) if scores else (fpos, fneg, conf)
    err = lib.dense_sweep_launch(
        indptr.data_ptr(), cells.data_ptr(), width.data_ptr(), A.data_ptr(),
        B, V, rows, fpos.data_ptr(), fneg.data_ptr(), conf.data_ptr(),
        spos.data_ptr() if scores else None,
        sneg.data_ptr() if scores else None,
        1 if scores else 0,
        torch.cuda.current_stream(A.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"dense_sweep kernel launch failed: cudaError {err}")
    launch_count += 1
    if scores:
        return fpos, fneg, conf, spos, sneg
    return fpos, fneg, conf
