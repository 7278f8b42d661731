"""Incrementally-updated per-workload cost model over ledger records
(own copy of ``mythril_tpu/autopilot/model.py``).

No external ML: per feature signature (features.feature_signature) the
model keeps, per terminal tier, a sample count, a decided count, and
two EWMAs — decide rate and per-lane wall share.  Updates arrive from
the lane ledger's batch observer (observability/ledger.py): every
settled lane that carries a feature vector contributes exactly one
observation at its terminal tier, so the model *is* the ledger data,
folded online, bounded, and cheap enough to consult per lane.

The EWMA recurrence (the JAX package's, held equal by the tests)::

    ewma_0 = x_0
    ewma_k = (1 - ALPHA) * ewma_{k-1} + ALPHA * x_k

Memory is bounded at MAX_SIGNATURES buckets; overflow evicts the
bucket with the fewest samples (a rare shape carries the least routing
signal).
"""

import threading
from typing import Dict, Optional

ALPHA = 0.2
MAX_SIGNATURES = 512


class TierStats:
    """Running statistics for one (signature, terminal tier) cell."""

    __slots__ = ("n", "decided_n", "decide_ewma", "wall_ewma")

    def __init__(self):
        self.n = 0
        self.decided_n = 0
        self.decide_ewma = 0.0
        self.wall_ewma = 0.0

    def observe(self, decided: bool, wall_s: float) -> None:
        x = 1.0 if decided else 0.0
        if self.n == 0:
            self.decide_ewma = x
            self.wall_ewma = wall_s
        else:
            self.decide_ewma = (1 - ALPHA) * self.decide_ewma + ALPHA * x
            self.wall_ewma = (1 - ALPHA) * self.wall_ewma + ALPHA * wall_s
        self.n += 1
        if decided:
            self.decided_n += 1

    def as_dict(self) -> dict:
        return {
            "n": self.n,
            "decided_n": self.decided_n,
            "decide_ewma": round(self.decide_ewma, 4),
            "wall_ewma_s": round(self.wall_ewma, 6),
        }


class CostModel:
    """signature -> {tier -> TierStats}, thread-safe, bounded."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[str, Dict[str, TierStats]] = {}
        self.observations = 0

    def observe(self, signature: str, tier: str, decided: bool,
                wall_s: float = 0.0) -> None:
        with self._lock:
            bucket = self._buckets.get(signature)
            if bucket is None:
                if len(self._buckets) >= MAX_SIGNATURES:
                    self._evict_locked()
                bucket = self._buckets[signature] = {}
            stats = bucket.get(tier)
            if stats is None:
                stats = bucket[tier] = TierStats()
            stats.observe(decided, wall_s)
            self.observations += 1

    def _evict_locked(self) -> None:
        victim = min(
            self._buckets,
            key=lambda s: sum(t.n for t in self._buckets[s].values()),
        )
        del self._buckets[victim]

    # -- queries the policy asks -------------------------------------

    def samples(self, signature: str) -> int:
        with self._lock:
            bucket = self._buckets.get(signature)
            return sum(t.n for t in bucket.values()) if bucket else 0

    def tier_count(self, signature: str, tier: str) -> int:
        with self._lock:
            bucket = self._buckets.get(signature)
            stats = bucket.get(tier) if bucket else None
            return stats.n if stats else 0

    def tier_decided(self, signature: str, tier: str) -> int:
        with self._lock:
            bucket = self._buckets.get(signature)
            stats = bucket.get(tier) if bucket else None
            return stats.decided_n if stats else 0

    def tail_share(self, signature: str) -> Optional[float]:
        """Fraction of this signature's lanes that ended on the host
        CDCL tail (None until anything was observed)."""
        with self._lock:
            bucket = self._buckets.get(signature)
            if not bucket:
                return None
            total = sum(t.n for t in bucket.values())
            if not total:
                return None
            tail = bucket.get("tail")
            return (tail.n if tail else 0) / total

    def decide_rate(self, signature: str, tier: str) -> Optional[float]:
        with self._lock:
            bucket = self._buckets.get(signature)
            stats = bucket.get(tier) if bucket else None
            return stats.decide_ewma if stats and stats.n else None

    def wall_share(self, signature: str, tier: str) -> Optional[float]:
        """Per-lane wall EWMA for one cell (None until observed) — the
        lockstep segment router compares this against its ceiling to
        steer incoherent frontiers around the tier."""
        with self._lock:
            bucket = self._buckets.get(signature)
            stats = bucket.get(tier) if bucket else None
            return stats.wall_ewma if stats and stats.n else None

    # -- persistence (persist/plane.py) -------------------------------

    def export_cells(self) -> dict:
        """Plain-data dump of every (signature, tier) cell for the
        knowledge store: ``{sig: {tier: (n, decided_n, decide_ewma,
        wall_ewma)}}`` — no class instances, so a pickle of it never
        version-skews with this module."""
        with self._lock:
            return {
                sig: {
                    tier: (st.n, st.decided_n, st.decide_ewma,
                           st.wall_ewma)
                    for tier, st in cells.items()
                }
                for sig, cells in self._buckets.items()
            }

    def merge_cells(self, cells: dict) -> int:
        """Merge an exported cell table into the live model; returns
        how many cells were taken.  Per cell the larger sample count
        wins — a restarted process adopts the store's richer history,
        while a store refreshed from a long-lived process keeps the
        live EWMAs.  Malformed entries are skipped (the payload may be
        a version-skewed store record), and the MAX_SIGNATURES bound
        holds throughout."""
        taken = 0
        with self._lock:
            for sig, tiers in cells.items():
                if not isinstance(tiers, dict):
                    continue
                bucket = self._buckets.get(sig)
                if bucket is None:
                    if len(self._buckets) >= MAX_SIGNATURES:
                        self._evict_locked()
                    bucket = self._buckets[sig] = {}
                for tier, cell in tiers.items():
                    try:
                        n, decided_n, decide_ewma, wall_ewma = cell
                        n, decided_n = int(n), int(decided_n)
                        decide_ewma = float(decide_ewma)
                        wall_ewma = float(wall_ewma)
                    except (TypeError, ValueError):
                        continue
                    live = bucket.get(tier)
                    if live is not None and live.n >= n:
                        continue
                    stats = TierStats()
                    stats.n, stats.decided_n = n, decided_n
                    stats.decide_ewma = decide_ewma
                    stats.wall_ewma = wall_ewma
                    bucket[tier] = stats
                    taken += 1
        return taken

    # -- introspection ------------------------------------------------

    def snapshot(self, top: int = 12) -> dict:
        """JSON-safe view: the ``top`` most-
        sampled signatures with their per-tier cells."""
        with self._lock:
            ranked = sorted(
                self._buckets.items(),
                key=lambda kv: -sum(t.n for t in kv[1].values()),
            )[:top]
            return {
                "signatures": len(self._buckets),
                "observations": self.observations,
                "top": {
                    sig: {tier: st.as_dict()
                          for tier, st in sorted(cells.items())}
                    for sig, cells in ranked
                },
            }
