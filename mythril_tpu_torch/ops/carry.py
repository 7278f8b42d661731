"""Carry solver state across from the JAX package's numpy exports.

This system has no weights: its state is the clause pool and the
frontier.  :func:`frontier_from_numpy` wraps a clause pool exported as
CSR arrays (``ctx.pool.csr()`` of a ``mythril_tpu`` blast context) and
the per-lane defining cones (``ctx.cone(lits)``) in an object that
serves the context interface the dense tier reads — ``pool.cone``,
``pool.subset_csr``, ``solver.num_vars``, ``generation`` /
``pool_version`` for the cone memo, and an empty ``recent_models``
channel.  :func:`state_from_numpy` loads a ``DPLL_STATE_FIELDS`` state.
Each port module can then be tested on exactly the inputs its JAX twin
saw.
"""

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mythril_tpu_torch.smt.bitblast import next_generation


class CarriedPool:
    """Read-only clause store over CSR arrays plus the exported cones
    (the JAX ``NativePool`` exposes no clause owners, so the cones
    travel as arrays, keyed by their sorted root literals)."""

    version = 0

    def __init__(self, lits: np.ndarray, indptr: np.ndarray, cones: dict):
        self.lits = np.ascontiguousarray(lits, dtype=np.int32)
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self._cones = cones

    @property
    def num_clauses(self) -> int:
        return len(self.indptr) - 1

    def cone(self, root_lits, need_clauses: bool = True):
        return self._cones[tuple(sorted(int(x) for x in root_lits))]

    def subset_csr(self, clause_ids):
        ids = np.asarray(clause_ids, dtype=np.int64)
        starts = self.indptr[ids]
        lens = self.indptr[ids + 1] - starts
        indptr = np.zeros(ids.size + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        gather = np.repeat(starts - indptr[:-1], lens) + np.arange(
            indptr[-1]
        )
        return self.lits[gather], indptr


class CarriedSolver:
    def __init__(self, num_vars: int):
        self.num_vars = int(num_vars)


class CarriedFrontier:
    """The context interface of the dense tier over carried arrays."""

    def __init__(self, pool: CarriedPool, num_vars: int):
        self.generation = next_generation()
        self.pool = pool
        self.solver = CarriedSolver(num_vars)
        self.recent_models: List = []

    @property
    def pool_version(self) -> int:
        return self.pool.version

    def cone(self, root_lits: Sequence[int], need_clauses: bool = True,
             known_bits: Optional[Sequence[int]] = None):
        if known_bits:
            root_lits = list(dict.fromkeys(list(root_lits) + list(known_bits)))
        return self.pool.cone(root_lits, need_clauses)

    def warm_phase_vector(self, num_vars: int):
        return None  # no models carried: no warm start


def frontier_from_numpy(
    csr_lits: np.ndarray,
    csr_indptr: np.ndarray,
    num_vars: int,
    lane_cones: Iterable[Tuple[Sequence[int], np.ndarray, np.ndarray]],
) -> CarriedFrontier:
    """Frontier object from a pool's CSR export and ``(root_lits,
    clause_ids, cone_vars)`` per lane."""
    cones = {
        tuple(sorted(int(x) for x in lits)): (
            np.asarray(ci, dtype=np.int64), np.asarray(cv, dtype=np.int64)
        )
        for lits, ci, cv in lane_cones
    }
    return CarriedFrontier(CarriedPool(csr_lits, csr_indptr, cones), num_vars)


def state_from_numpy(state_list: Sequence[np.ndarray], device=None):
    """A ``DPLL_STATE_FIELDS`` state (numpy arrays, as the JAX
    ``_dpll_state0`` builds it) as torch tensors on ``device``: the card
    unless the caller passes ``device="cpu"`` (``ops.default_device``)."""
    from mythril_tpu_torch.ops import default_device

    dev = default_device(device)
    return [
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in state_list
    ]
