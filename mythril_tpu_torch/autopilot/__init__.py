"""Autopilot: ledger-driven adaptive tier routing and online tuning
(own copy of ``mythril_tpu/autopilot``).

The lane ledger (``observability/ledger.py``) makes every lane's cost
attributable; this package is the feedback layer that consumes it.
Three parts:

- features + cost model (features.py, model.py): a cheap per-lane
  feature vector at funnel entry, folded into running per-tier
  decide-rate / wall EWMAs bucketed by feature signature — fed by a
  ledger batch observer;
- routing policy (policy.py): consulted by ``BlastContext.check`` and
  ``batch_check_states`` before each tier — skip the word tier for
  shapes it never decides, send predicted-tail lanes straight to the
  host CDCL instead of paying a doomed dispatch, bound the first CDCL
  rung for predicted-easy shapes.  Verdict-neutral by construction
  (tiers are only skipped/staged, verdict logic is untouched);
- online tuner + offline replay (tuner.py, replay.py): bounded-step
  adjustment of frontier FAN/PERIOD, tier period and coalesce window
  from the live tail share and queue depth, with automatic
  revert-on-regression; ``replay.py`` re-runs any recorded ledger
  artifact through any policy deterministically.

Kill switch: ``MYTHRIL_TPU_AUTOPILOT=0`` pins the exact static path —
every hook below returns the do-nothing answer before touching any
state.

Lifetime: the model is per-workload — it resets with the blast
context (``reset_blast_context``), because feature memos and the
statistics they key are only comparable within one analysis's term
population.
"""

import os
import threading
from typing import List, Optional

from mythril_tpu_torch.autopilot.features import (  # noqa: F401 (re-export)
    feature_signature, lane_features,
)
from mythril_tpu_torch.autopilot.model import CostModel
from mythril_tpu_torch.autopilot.policy import (  # noqa: F401 (re-export)
    RouteDecision, make_policy,
)
from mythril_tpu_torch.autopilot.tuner import OnlineTuner


def autopilot_enabled() -> bool:
    """``MYTHRIL_TPU_AUTOPILOT=0`` disables routing, tuning and model
    updates everywhere — the funnel runs the exact static path."""
    return os.environ.get("MYTHRIL_TPU_AUTOPILOT", "1").lower() not in (
        "0", "off", "false",
    )


class AutopilotCounters:
    """Plain counters threaded to the registry (``autopilot_*``
    series)."""

    __slots__ = ("lanes_seen", "lanes_routed", "word_skips",
                 "tail_routes", "ladder_solves", "ladder_decided",
                 "ladder_fallbacks", "segments_seen",
                 "segments_declined")

    def __init__(self):
        for field in self.__slots__:
            setattr(self, field, 0)

    def as_dict(self) -> dict:
        return {field: getattr(self, field) for field in self.__slots__}


class Autopilot:
    """Process-wide facade: model + policy + tuner + counters."""

    def __init__(self):
        self.model = CostModel()
        policy_name = os.environ.get(
            "MYTHRIL_TPU_AUTOPILOT_POLICY"
        ) or None
        self.policy = make_policy(policy_name)
        self.tuner = OnlineTuner()
        self.counters = AutopilotCounters()
        self._observer_attached = False

    # -- learning (ledger observer) ------------------------------------

    def attach(self) -> None:
        """Register the ledger batch observer once (idempotent)."""
        if self._observer_attached:
            return
        from mythril_tpu_torch.observability.ledger import add_batch_observer

        add_batch_observer(self._on_batch)
        self._observer_attached = True

    def _on_batch(self, batch) -> None:
        """Fold one settled LaneBatch into the cost model and feed the
        tuner.  Routed lanes do not update the model: their statistics
        would describe the routed funnel, not the static one the
        policy's thresholds are calibrated against."""
        if not autopilot_enabled():
            return
        tier_lane_counts = {}
        for tier in batch.tiers:
            tier_lane_counts[tier] = tier_lane_counts.get(tier, 0) + 1
        for index, features in enumerate(batch.features):
            if features is None or batch.routed[index] is not None:
                continue
            tier = batch.tiers[index]
            wall_share = (
                batch.walls.get(tier, 0.0) / tier_lane_counts[tier]
                if tier_lane_counts.get(tier) else 0.0
            )
            self.model.observe(
                feature_signature(features), tier,
                batch.verdicts[index] != "undecided", wall_share,
            )
        from mythril_tpu_torch.observability.ledger import get_ledger

        from mythril_tpu_torch.ops.coalesce import get_coalescer

        pct = get_ledger().tier_decided_pct()
        tail_pct = pct.get("tail") if pct else None
        self.tuner.observe(tail_pct, len(get_coalescer().queue))

    # -- routing --------------------------------------------------------

    def route(self, features: dict) -> RouteDecision:
        decision = self.policy.decide(features, self.model)
        self.counters.lanes_seen += 1
        if decision.routed_by:
            self.counters.lanes_routed += 1
            if decision.skip_word:
                self.counters.word_skips += 1
            if decision.skip_device:
                self.counters.tail_routes += 1
        return decision

    # -- introspection --------------------------------------------------

    def debug_state(self) -> dict:
        """Policy, counters, model and tuner state (JSON-safe)."""
        return {
            "enabled": autopilot_enabled(),
            "policy": self.policy.name,
            "counters": self.counters.as_dict(),
            "model": self.model.snapshot(),
            "tuner": self.tuner.debug_state(),
        }


_autopilot: Optional[Autopilot] = None
_autopilot_lock = threading.Lock()


def get_autopilot() -> Autopilot:
    global _autopilot
    if _autopilot is None:
        with _autopilot_lock:
            if _autopilot is None:
                pilot = Autopilot()
                pilot.attach()
                _autopilot = pilot
    return _autopilot


# -- funnel hooks (all no-ops behind the kill switch) ---------------------


def route_query(nodes: List, tx: Optional[int] = None
                ) -> Optional[RouteDecision]:
    """Per-query hook for ``BlastContext.check``.  Returns None on the
    static path (killed, or nothing routed) so the caller's fast path
    stays one truthiness test."""
    if not autopilot_enabled() or not nodes:
        return None
    pilot = get_autopilot()
    decision = pilot.route(lane_features(nodes, tx=tx))
    return decision if decision.routed_by else None


def route_lanes(node_sets: List[Optional[List]], lanes_led
                ) -> List[Optional[RouteDecision]]:
    """Per-lane hook for ``batch_check_states``: extract features for
    every open lane, stamp them (and any routing verdict) onto the
    ledger batch, and return the per-lane decisions."""
    routes: List[Optional[RouteDecision]] = [None] * len(node_sets)
    if not autopilot_enabled():
        return routes
    pilot = get_autopilot()
    from mythril_tpu_torch.observability.ledger import get_ledger

    tx = get_ledger().origin_tx
    for i, nodes in enumerate(node_sets):
        if not nodes:
            continue
        features = lane_features(nodes, tx=tx)
        lanes_led.set_features(i, features)
        decision = pilot.route(features)
        if decision.routed_by:
            lanes_led.set_routed(i, decision.routed_by)
            routes[i] = decision
    return routes


def knob_override(name: str) -> Optional[int]:
    """Tuner override consulted by the funnel knob getters (frontier
    FAN/PERIOD, tier period, coalesce window) when the operator has
    not pinned the env var.  None = use the static default."""
    if not autopilot_enabled():
        return None
    pilot = _autopilot  # never *create* state from a hot knob read
    if pilot is None:
        return None
    return pilot.tuner.override(name)


#: per-lane lockstep wall (seconds) above which a learned segment shape
#: is routed back to the serial interpreter; ceiling in milliseconds
#: via MYTHRIL_TPU_SEG_CEIL_MS
_SEG_CEIL_MS_DEFAULT = 50.0
#: observations of a segment signature required before the ceiling may
#: fire (threshold-fired like the policy rules, not learned)
_SEG_MIN_SAMPLES = 8


def route_segment(features: dict) -> bool:
    """Segment-shape hook for the symbolic lockstep tier: True = run
    the segment group in lockstep, False = decline (the group falls
    through to the per-state interpreter, verdict-neutral either way).
    Declines only when the cost model has seen this shape enough times
    AND its per-lane lockstep wall EWMA exceeds the ceiling — i.e. the
    tier demonstrably loses on this shape (incoherent frontiers whose
    term traffic defeats the shared-structure win)."""
    if not autopilot_enabled():
        return True
    pilot = get_autopilot()
    pilot.counters.segments_seen += 1
    signature = feature_signature(features)
    if pilot.model.tier_count(signature, "lockstep") < _SEG_MIN_SAMPLES:
        return True
    from mythril_tpu_torch.support.env import env_float

    ceil_s = env_float(
        "MYTHRIL_TPU_SEG_CEIL_MS", _SEG_CEIL_MS_DEFAULT, floor=0.0
    ) / 1e3
    wall = pilot.model.wall_share(signature, "lockstep")
    if wall is not None and wall > ceil_s:
        pilot.counters.segments_declined += 1
        return False
    return True


def note_segment(features: dict, lanes: int, wall_s: float) -> None:
    """Fold one executed segment group into the cost model under the
    ``lockstep`` tier key (per-lane wall share, always 'decided' — the
    tier never leaves a lane undecided, it hands it back)."""
    if not autopilot_enabled() or _autopilot is None or lanes <= 0:
        return
    _autopilot.model.observe(
        feature_signature(features), "lockstep", True, wall_s / lanes
    )


def note_ladder(decided_first_rung: bool) -> None:
    """Tail-ladder accounting from ``BlastContext.check``."""
    if _autopilot is None:
        return
    counters = _autopilot.counters
    counters.ladder_solves += 1
    if decided_first_rung:
        counters.ladder_decided += 1
    else:
        counters.ladder_fallbacks += 1


def counters_snapshot() -> dict:
    """Registry surface: the counters plus tuner activity (empty when
    the autopilot never engaged)."""
    if _autopilot is None:
        return {}
    snap = _autopilot.counters.as_dict()
    snap["tuner_adjustments"] = _autopilot.tuner.adjustments
    snap["tuner_reverts"] = _autopilot.tuner.reverts
    snap["model_signatures"] = _autopilot.model.snapshot(top=0)[
        "signatures"
    ]
    return snap


def _autopilot_collector():
    """Registry collector: ``mythril_tpu_autopilot_*`` series (hooked
    by observability/metrics.get_registry, like the ledger's)."""
    yield ("gauge", "mythril_tpu_autopilot_enabled",
           "1 while the autopilot may route lanes",
           int(autopilot_enabled()))
    snap = counters_snapshot()
    if not snap:
        return
    for field in ("lanes_seen", "lanes_routed", "word_skips",
                  "tail_routes", "ladder_solves", "ladder_decided",
                  "ladder_fallbacks", "segments_seen",
                  "segments_declined", "tuner_adjustments",
                  "tuner_reverts"):
        yield ("counter", f"mythril_tpu_autopilot_{field}",
               "autopilot routing/tuning activity", snap.get(field, 0))
    yield ("gauge", "mythril_tpu_autopilot_model_signatures",
           "feature-signature buckets held by the cost model",
           snap.get("model_signatures", 0))


def reset_for_tests() -> None:
    """Drop the singleton (the ledger observer list is reset by the
    ledger's own reset) and the feature memo.  Also called when the
    blast context resets — the model is per-workload by contract."""
    global _autopilot
    from mythril_tpu_torch.autopilot import features as _features

    if _autopilot is not None and _autopilot._observer_attached:
        from mythril_tpu_torch.observability.ledger import remove_batch_observer

        remove_batch_observer(_autopilot._on_batch)
    _autopilot = None
    _features.reset_for_tests()
