"""Incremental dispatch policy + the cross-dispatch cone memo (own copy
of the parts of ``mythril_tpu/ops/incremental.py`` the solver tiers
read).

- **Resident clause pool** (``MYTHRIL_TPU_RESIDENT_POOL``, default on):
  the gather tier's ``DevicePool`` keeps the clause rows on the device
  and ships only appended rows between dispatches.
- **Parent-model warm starts** (``MYTHRIL_TPU_WARM_START``, default
  on): lanes seed their DPLL *decision phases* from the most recent
  SAT model in the blast context's recent-models channel.  Phase
  preference only biases search order, so verdicts are untouched.
- **Cone memo** (:class:`ConeMemo`): cone extraction + remap results
  cached by ``(generation, pool_version, device_learned_generation)``.
  The whole table is dropped the moment any component moves, so a hit
  is always exact.
"""

from typing import Callable, Dict, Optional, Tuple

from mythril_tpu_torch.support.env import env_flag

#: cone-memo entry cap; the least-recently-used quarter is evicted when
#: full (hits refresh recency)
CONE_MEMO_CAP = 128


def resident_pool_enabled() -> bool:
    """``MYTHRIL_TPU_RESIDENT_POOL=0`` forces a full clause-pool rebuild
    and upload on every gather-tier dispatch (the default keeps the pool
    on the device and appends the delta rows)."""
    return env_flag("MYTHRIL_TPU_RESIDENT_POOL", True)


def warm_start_enabled() -> bool:
    """``MYTHRIL_TPU_WARM_START=0`` disables parent-model phase
    seeding (lanes cold-start their decision phases from DLIS alone)."""
    return env_flag("MYTHRIL_TPU_WARM_START", True)


class ConeMemo:
    """Cross-dispatch memo for cone extraction / remap / device-row
    builds, scoped to one ``(blast generation, pool_version,
    device_learned_generation)``: any pool growth, learned-clause
    harvest or context reset drops the whole table, so a surviving entry
    describes exactly the pool the next dispatch will solve against."""

    def __init__(self):
        self._scope: Tuple[int, int, int] = (-1, -1, -1)
        self._table: Dict[tuple, object] = {}

    def _sync(self, ctx) -> None:
        scope = (ctx.generation, ctx.pool_version,
                 getattr(ctx, "device_learned_generation", 0))
        if scope != self._scope:
            self._scope = scope
            self._table.clear()

    def get_or_build(self, ctx, key: tuple, build: Callable[[], object]):
        """Return the cached value for ``key`` under the context's
        current scope, building (and caching) it on a miss."""
        self._sync(ctx)
        if key in self._table:
            value = self._table.pop(key)
            self._table[key] = value  # hit refreshes recency
            from mythril_tpu_torch.ops.batched_sat import dispatch_stats

            dispatch_stats.cone_memo_hits += 1
            return value
        value = build()
        if len(self._table) >= CONE_MEMO_CAP:
            for stale in list(self._table)[: CONE_MEMO_CAP // 4]:
                del self._table[stale]
        self._table[key] = value
        return value

    def cone(self, ctx, root_lits, known_bits=None) -> tuple:
        """Memoized ``ctx.cone(root_lits, known_bits=...)`` — the
        per-lane entry point (sibling lanes across batches repeat root
        sets).  ``known_bits`` (the word tier's tightening as unit
        literals) is part of the key as well as of the build, so a
        memoized untightened cone row never serves a tightened query, nor
        the other way round."""
        digest = tuple(sorted(known_bits)) if known_bits else ()
        key = ("cone", tuple(sorted(root_lits)), digest)
        return self.get_or_build(
            ctx, key,
            lambda: ctx.cone(list(root_lits), known_bits=known_bits),
        )

    def reset(self) -> None:
        self._scope = (-1, -1, -1)
        self._table.clear()

    def __len__(self) -> int:
        return len(self._table)


_cone_memo: Optional[ConeMemo] = None


def get_cone_memo() -> ConeMemo:
    global _cone_memo
    if _cone_memo is None:
        _cone_memo = ConeMemo()
    return _cone_memo


def reset_cone_memo() -> None:
    if _cone_memo is not None:
        _cone_memo.reset()
