"""Literal->row adjacency for the dense tier's hot-tier growth (own
copy of ``LitAdjacency`` and ``frontier_enabled`` from
``mythril_tpu/ops/frontier.py``; the frontier solver itself comes with
a later slice)."""

import os

import numpy as np


def frontier_enabled() -> bool:
    """``MYTHRIL_TPU_FRONTIER=0`` makes the union layout's hot-tier
    growth fall back to an ``isin`` scan of the whole coordinate list
    instead of the adjacency index (same switch as the JAX package)."""
    return os.environ.get("MYTHRIL_TPU_FRONTIER", "1").lower() not in (
        "0", "off", "false",
    )


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
