"""Native components of the port: the CDCL SAT solver and the clause
pool / gate layer, built from C++ at first import.

Own copy of ``mythril_tpu/native`` (cdcl.cpp without the keccak helper,
pool.cpp unchanged), compiled into this package's own ``_native.so``.
The two libraries export the same C symbol names; ctypes loads each with
``RTLD_LOCAL``, so both packages can live in one process (the parity
tests rely on that).

The build writes to a temporary name and renames it into place, so
concurrent first imports (test workers) never load a half-written file.
"""

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence

log = logging.getLogger(__name__)

_SRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
_LIB_PATH = os.path.join(os.path.dirname(__file__), "_native.so")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> List[str]:
    return [
        os.path.join(_SRC_DIR, name)
        for name in sorted(os.listdir(_SRC_DIR))
        if name.endswith(".cpp")
    ]


def _build() -> None:
    fd, tmp = tempfile.mkstemp(
        suffix=".so", dir=os.path.dirname(_LIB_PATH)
    )
    os.close(fd)
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp]
    cmd += _sources()
    log.info("building native library: %s", " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        newest_src = max(os.path.getmtime(p) for p in _sources())
        if (
            not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < newest_src
        ):
            _build()
        lib = ctypes.CDLL(_LIB_PATH, mode=os.RTLD_LOCAL)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.cdcl_new.restype = ctypes.c_void_p
        lib.cdcl_free.argtypes = [ctypes.c_void_p]
        lib.cdcl_new_var.argtypes = [ctypes.c_void_p]
        lib.cdcl_new_var.restype = ctypes.c_int32
        lib.cdcl_add_clause.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int32]
        lib.cdcl_add_clause.restype = ctypes.c_int32
        lib.cdcl_solve.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_double,
        ]
        lib.cdcl_solve.restype = ctypes.c_int32
        lib.cdcl_model_into.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int8), ctypes.c_int32,
        ]
        lib.cdcl_set_relevant.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64]
        lib.cdcl_num_vars.argtypes = [ctypes.c_void_p]
        lib.cdcl_num_vars.restype = ctypes.c_int32
        lib.pool_new.argtypes = [ctypes.c_void_p]
        lib.pool_new.restype = ctypes.c_void_p
        lib.pool_free.argtypes = [ctypes.c_void_p]
        lib.pool_new_var.argtypes = [ctypes.c_void_p]
        lib.pool_new_var.restype = ctypes.c_int32
        for name in ("pool_and2", "pool_xor2"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
            fn.restype = ctypes.c_int32
        for name in ("pool_xor3", "pool_maj", "pool_mux"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32,
            ]
            fn.restype = ctypes.c_int32
        lib.pool_and_many.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64]
        lib.pool_and_many.restype = ctypes.c_int32
        lib.pool_add_bits.argtypes = [
            ctypes.c_void_p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
            i32p, i32p,
        ]
        for name in ("pool_ult_lit", "pool_eq_lit"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, i32p, i32p, ctypes.c_int32]
            fn.restype = ctypes.c_int32
        lib.pool_mux_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i32p, i32p, ctypes.c_int32, i32p,
        ]
        lib.pool_map_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i32p, i32p, ctypes.c_int32, i32p,
        ]
        lib.pool_mul_bits.argtypes = [
            ctypes.c_void_p, i32p, i32p, ctypes.c_int32, i32p,
        ]
        lib.pool_udivmod_bits.argtypes = [
            ctypes.c_void_p, i32p, i32p, ctypes.c_int32, i32p, i32p,
        ]
        lib.pool_congruence.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i32p, i32p, ctypes.c_int32,
        ]
        lib.pool_nogood.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int32]
        lib.pool_nogood.restype = ctypes.c_int32
        lib.pool_relevant_cone.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int64]
        lib.pool_cone.argtypes = [
            ctypes.c_void_p, i32p, ctypes.c_int64, ctypes.c_int32, i64p, i64p,
        ]
        lib.pool_cone_fetch.argtypes = [ctypes.c_void_p, i64p, i32p]
        for name in ("pool_num_clauses", "pool_lits_len", "pool_version"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int64
        lib.pool_csr_into.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, i32p, i64p,
        ]
        lib.pool_subset_sizes.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64]
        lib.pool_subset_sizes.restype = ctypes.c_int64
        lib.pool_subset_csr.argtypes = [
            ctypes.c_void_p, i64p, ctypes.c_int64, i32p, i64p,
        ]
        _lib = lib
        return lib


class SatSolver:
    """ctypes wrapper over the native CDCL instance.

    Incremental: variables/clauses persist across ``solve`` calls;
    per-query constraints are passed as assumptions.
    """

    SAT, UNSAT, UNKNOWN = 1, -1, 0

    def __init__(self):
        self._lib = load()
        self._handle = self._lib.cdcl_new()
        # var 1 is the constant-TRUE anchor allocated by the solver ctor
        self.true_var = 1

    def __del__(self):
        try:
            self._lib.cdcl_free(self._handle)
        except Exception:
            pass

    @property
    def num_vars(self) -> int:
        """Total variables allocated (vars are allocated both here and
        through the native pool's gate layer, so the count lives in C)."""
        return self._lib.cdcl_num_vars(self._handle)

    def new_var(self) -> int:
        return self._lib.cdcl_new_var(self._handle)

    def add_clause(self, lits: Sequence[int]) -> bool:
        """False when the clause makes the instance trivially UNSAT."""
        arr = (ctypes.c_int32 * len(lits))(*lits)
        return bool(
            self._lib.cdcl_add_clause(self._handle, arr, len(lits))
        )

    def solve(
        self,
        assumptions: Sequence[int] = (),
        conflict_budget: int = -1,
        time_budget_s: float = 0.0,
    ) -> int:
        arr = (ctypes.c_int32 * len(assumptions))(*assumptions)
        return self._lib.cdcl_solve(
            self._handle, arr, len(assumptions), conflict_budget, time_budget_s
        )

    def model_array(self, count: Optional[int] = None):
        """Whole model as an int8 numpy vector indexed by var (1 true /
        -1 false / 0 unset)."""
        import numpy as np

        n = (self.num_vars + 1) if count is None else count
        out = np.empty(n, dtype=np.int8)
        self._lib.cdcl_model_into(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            n,
        )
        return out

    def set_relevant(self, variables) -> None:
        """Restrict decisions to the given variables (the query's cone);
        pass an empty sequence to lift the restriction."""
        import numpy as np

        buf = np.ascontiguousarray(np.fromiter(variables, dtype=np.int32))
        self._lib.cdcl_set_relevant(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            buf.size,
        )


def _i32arr(xs):
    import numpy as np

    if isinstance(xs, np.ndarray):
        return np.ascontiguousarray(xs, dtype=np.int32)
    return np.fromiter(xs, dtype=np.int32, count=len(xs))


class NativePool:
    """ctypes wrapper over the native clause pool + gate layer
    (csrc/pool.cpp).  Every emitted clause lands in the CSR store AND
    the wrapped CDCL instance in the same native call."""

    def __init__(self, solver: SatSolver):
        self._lib = load()
        self.solver = solver  # keeps the CDCL handle alive
        self._handle = self._lib.pool_new(solver._handle)

    def __del__(self):
        try:
            self._lib.pool_free(self._handle)
        except Exception:
            pass

    def new_var(self) -> int:
        return self._lib.pool_new_var(self._handle)

    # ---- gates ----

    def g_and(self, a: int, b: int) -> int:
        return self._lib.pool_and2(self._handle, a, b)

    def g_or(self, a: int, b: int) -> int:
        return -self._lib.pool_and2(self._handle, -a, -b)

    def g_xor(self, a: int, b: int) -> int:
        return self._lib.pool_xor2(self._handle, a, b)

    def g_xor3(self, a: int, b: int, c: int) -> int:
        return self._lib.pool_xor3(self._handle, a, b, c)

    def g_maj(self, a: int, b: int, c: int) -> int:
        return self._lib.pool_maj(self._handle, a, b, c)

    def g_mux(self, s: int, a: int, b: int) -> int:
        return self._lib.pool_mux(self._handle, s, a, b)

    def g_and_many(self, lits) -> int:
        arr = (ctypes.c_int32 * len(lits))(*lits)
        return self._lib.pool_and_many(self._handle, arr, len(lits))

    # ---- word-level circuits (one crossing per word op) ----

    def add_bits(self, xs, ys, cin: int):
        n = len(xs)
        xa = (ctypes.c_int32 * n)(*xs)
        ya = (ctypes.c_int32 * n)(*ys)
        out = (ctypes.c_int32 * n)()
        carry = ctypes.c_int32()
        self._lib.pool_add_bits(
            self._handle, xa, ya, n, cin, out, ctypes.byref(carry)
        )
        return list(out), carry.value

    def ult_lit(self, xs, ys) -> int:
        n = len(xs)
        xa = (ctypes.c_int32 * n)(*xs)
        ya = (ctypes.c_int32 * n)(*ys)
        return self._lib.pool_ult_lit(self._handle, xa, ya, n)

    def eq_lit(self, xs, ys) -> int:
        n = len(xs)
        xa = (ctypes.c_int32 * n)(*xs)
        ya = (ctypes.c_int32 * n)(*ys)
        return self._lib.pool_eq_lit(self._handle, xa, ya, n)

    def mux_bits(self, s: int, xs, ys):
        n = len(xs)
        xa = (ctypes.c_int32 * n)(*xs)
        ya = (ctypes.c_int32 * n)(*ys)
        out = (ctypes.c_int32 * n)()
        self._lib.pool_mux_bits(self._handle, s, xa, ya, n, out)
        return list(out)

    def map_bits(self, mode: int, xs, ys):
        """mode 0 = and, 1 = or, 2 = xor, elementwise."""
        n = len(xs)
        xa = (ctypes.c_int32 * n)(*xs)
        ya = (ctypes.c_int32 * n)(*ys)
        out = (ctypes.c_int32 * n)()
        self._lib.pool_map_bits(self._handle, mode, xa, ya, n, out)
        return list(out)

    def mul_bits(self, xs, ys):
        n = len(xs)
        xa = (ctypes.c_int32 * n)(*xs)
        ya = (ctypes.c_int32 * n)(*ys)
        out = (ctypes.c_int32 * n)()
        self._lib.pool_mul_bits(self._handle, xa, ya, n, out)
        return list(out)

    def udivmod_bits(self, xs, ys):
        n = len(xs)
        xa = (ctypes.c_int32 * n)(*xs)
        ya = (ctypes.c_int32 * n)(*ys)
        q = (ctypes.c_int32 * n)()
        r = (ctypes.c_int32 * n)()
        self._lib.pool_udivmod_bits(self._handle, xa, ya, n, q, r)
        return list(q), list(r)

    def congruence(self, same: int, a_bits, b_bits) -> None:
        """Emit ``same -> (a_bits[i] == b_bits[i])`` clause pairs for
        every bit in one crossing (Ackermannized array reads / UF
        applications)."""
        n = len(a_bits)
        aa = (ctypes.c_int32 * n)(*a_bits)
        ba = (ctypes.c_int32 * n)(*b_bits)
        self._lib.pool_congruence(self._handle, same, aa, ba, n)

    # ---- nogoods ----

    def nogood(self, assumption_lits) -> bool:
        arr = (ctypes.c_int32 * len(assumption_lits))(*assumption_lits)
        return bool(
            self._lib.pool_nogood(self._handle, arr, len(assumption_lits))
        )

    # ---- cone of influence ----

    def relevant_cone(self, root_lits) -> None:
        """Install the CDCL decision restriction for a query (each
        root's memoized cone vars are marked natively)."""
        arr = (ctypes.c_int32 * len(root_lits))(*root_lits)
        self._lib.pool_relevant_cone(self._handle, arr, len(root_lits))

    def cone(self, root_lits, need_clauses: bool = True):
        """(clause indices int64, vars int64) of the defining cone of
        ``root_lits``, both sorted ascending (numpy arrays)."""
        import numpy as np

        roots = _i32arr(root_lits)
        n_clauses = ctypes.c_int64()
        n_vars = ctypes.c_int64()
        self._lib.pool_cone(
            self._handle,
            roots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            roots.size, 1 if need_clauses else 0,
            ctypes.byref(n_clauses), ctypes.byref(n_vars),
        )
        clauses = np.empty(n_clauses.value, dtype=np.int64)
        cone_vars = np.empty(n_vars.value, dtype=np.int32)
        self._lib.pool_cone_fetch(
            self._handle,
            clauses.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cone_vars.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return clauses, cone_vars.astype(np.int64)

    # ---- store accessors ----

    @property
    def num_clauses(self) -> int:
        return int(self._lib.pool_num_clauses(self._handle))

    @property
    def version(self) -> int:
        return int(self._lib.pool_version(self._handle))

    def csr(self):
        """(lits int32, indptr int64) copies of the whole clause store."""
        import numpy as np

        count = self.num_clauses
        if count <= 0:
            return np.empty(0, dtype=np.int32), np.zeros(1, dtype=np.int64)
        total = int(self._lib.pool_lits_len(self._handle))
        indptr = np.empty(count + 1, dtype=np.int64)
        lits = np.empty(total, dtype=np.int32)
        self._lib.pool_csr_into(
            self._handle, 0, count,
            lits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return lits[: indptr[-1]], indptr

    def subset_csr(self, clause_ids):
        """(lits int32, indptr int64) for an arbitrary clause-id list
        (cone extraction feeds the incidence builds from this)."""
        import numpy as np

        ids = np.ascontiguousarray(clause_ids, dtype=np.int64)
        total = int(
            self._lib.pool_subset_sizes(
                self._handle,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ids.size,
            )
        )
        lits = np.empty(total, dtype=np.int32)
        indptr = np.empty(ids.size + 1, dtype=np.int64)
        self._lib.pool_subset_csr(
            self._handle,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ids.size,
            lits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return lits, indptr
