"""Resident solver of the port (counterpart of
``mythril_tpu/ops/resident.py``): the whole frontier round ladder in one
dispatch, with learned rows shared between lanes during the dispatch.

It runs the frontier solver's iteration (``ops/frontier_kernels.py``)
with three additions:

- the loop runs to ``MYTHRIL_TPU_RESIDENT_BUDGET`` iterations in all
  (default ``GATHER_STEPS`` x ``FRONTIER_BUDGET_MULT``, the effort of
  the multi-dispatch ladder) instead of per-round budgets;
- first-UIP clauses are appended to a shared pool ``extra [E+1, K]``
  (row ``E`` a sink that is never scanned) that every scan reads from
  the next iteration on, so a clause one lane learns prunes its
  siblings in the same dispatch; the don't-care cascade skips every
  variable of that pool;
- a stall counter of consecutive iterations in which no lane advanced;
  ``stall >= MYTHRIL_TPU_RESIDENT_WATCHDOG`` ends the dispatch.

Exits (:func:`exit_reason`): ``all_decided``, ``budget``, ``watchdog``;
survivors of the last two go to the CDCL tail.  On the card an
iteration is three kernel launches with no host sync, and the host reads
the device's ``halt`` flag every 16 iterations.

``MYTHRIL_TPU_RESIDENT_KERNEL=0`` restores the multi-dispatch frontier
ladder, as in the JAX package.  ``subset_matrix`` (veritesting) is not
part of the port.
"""

import numpy as np
import torch

from mythril_tpu_torch.ops.frontier import (
    FRONTIER_BUDGET_MULT, FRONTIER_STATE_FIELDS, LEARN_CAP, UIP_ITERS,
    frontier_enabled, frontier_fan, frontier_period, frontier_state0,
)
from mythril_tpu_torch.support.env import env_flag, env_int

#: per-lane solver state: the frontier ladder's layout
RESIDENT_LANE_FIELDS = FRONTIER_STATE_FIELDS
#: batch-shared state: the learned-row pool and the loop counters
RESIDENT_SHARED_FIELDS = ("extra", "nextra", "stall", "itc")
RESIDENT_STATE_FIELDS = RESIDENT_LANE_FIELDS + RESIDENT_SHARED_FIELDS

DEFAULT_WATCHDOG = 2048
DEFAULT_EXTRA = 64


def resident_kernel_enabled() -> bool:
    """``MYTHRIL_TPU_RESIDENT_KERNEL=0`` restores the multi-dispatch
    frontier ladder.  The resident solver runs on the frontier state,
    so ``MYTHRIL_TPU_FRONTIER=0`` switches it off too, as in the JAX
    package (the funnel refuses that flag: see ``batch_check_states``)."""
    return (env_flag("MYTHRIL_TPU_RESIDENT_KERNEL", True)
            and frontier_enabled())


def resident_budget() -> int:
    from mythril_tpu_torch.ops.batched_sat import GATHER_STEPS

    return env_int("MYTHRIL_TPU_RESIDENT_BUDGET",
                   GATHER_STEPS * FRONTIER_BUDGET_MULT, floor=1)


def resident_watchdog_limit() -> int:
    return env_int("MYTHRIL_TPU_RESIDENT_WATCHDOG", DEFAULT_WATCHDOG,
                   floor=1)


def resident_extra_cap() -> int:
    return env_int("MYTHRIL_TPU_RESIDENT_EXTRA", DEFAULT_EXTRA, floor=1)


def resident_shared0(extra_cap: int, width: int) -> dict:
    """Zero shared state: an empty pool (row ``extra_cap`` is the sink)
    and counters at zero."""
    return {
        "extra": np.zeros((extra_cap + 1, width), np.int32),
        "nextra": np.zeros(1, np.int32),
        "stall": np.zeros(1, np.int32),
        "itc": np.zeros(1, np.int32),
    }


def resident_state0(assign: np.ndarray, n_real: int, max_decisions: int,
                    learn_cap: int = LEARN_CAP, width: int = 8,
                    pref_row=None, extra_cap=None) -> dict:
    """Zero state over RESIDENT_STATE_FIELDS."""
    if extra_cap is None:
        extra_cap = resident_extra_cap()
    state = frontier_state0(assign, n_real, max_decisions,
                            learn_cap=learn_cap, width=width,
                            pref_row=pref_row)
    state.update(resident_shared0(extra_cap, width))
    return state


def exit_reason(status: np.ndarray, stall: int, itc: int,
                watchdog: int, budget: int) -> str:
    """Why a resident dispatch returned: ``all_decided`` | ``watchdog``
    | ``budget`` (bucket pads enter retired, so "no live lane" is the
    loop's own all-decided exit)."""
    if not np.any(np.asarray(status) == 0):
        return "all_decided"
    if stall >= watchdog:
        return "watchdog"
    return "budget"


def resident_solve(lits: torch.Tensor, adj: torch.Tensor,
                   state: dict) -> dict:
    """One resident dispatch (the JAX package's ``make_resident_step``)
    over RESIDENT_STATE_FIELDS, knobs from the environment.  ``state``
    holds numpy arrays; returns a new dict of numpy arrays."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    E = state["extra"].shape[0] - 1
    cfg = FK.StepConfig(
        fan=frontier_fan(), period=frontier_period(),
        limit=resident_budget(), watchdog=resident_watchdog_limit(),
        extra_cap=E, learn_cap=state["learned"].shape[1],
        uip_iters=UIP_ITERS, resident=True,
    )
    device = lits.device
    lane = FK.to_device(state, RESIDENT_LANE_FIELDS, device)
    extra = torch.from_numpy(np.ascontiguousarray(state["extra"])).to(device)
    it, stall, nextra = FK.run_iterations(
        lits, adj, lane, cfg, extra=extra, it0=int(state["itc"][0]),
        stall0=int(state["stall"][0]), nextra0=int(state["nextra"][0]),
    )
    out = FK.to_host(lane, RESIDENT_LANE_FIELDS)
    out["extra"] = extra.cpu().numpy().copy()
    out["nextra"] = np.array([nextra], np.int32)
    out["stall"] = np.array([stall], np.int32)
    out["itc"] = np.array([it], np.int32)
    return out
