"""Routing policy: which tiers a lane should (not) pay for (own copy of
``mythril_tpu/autopilot/policy.py``).

Consulted by ``BlastContext.check`` (per query) and
``batch_check_states`` (per lane) before each tier.  Soundness-neutral
by construction: a decision can only *skip* a tier whose work another
sound tier would redo (the word tier and the device dispatch are pure
accelerators — everything they leave undecided falls to the host CDCL
tail, which answers with full budget either way), or *stage* the tail
solve as a bounded-then-unbounded ladder whose fallback is the exact
static call.  No verdict logic is touched anywhere.

Rules (the shipped ``ledger-v1`` policy; every threshold is a knob):

- **word-skip** — a signature observed >= MIN_SAMPLES times past the
  probe with the word tier deciding *none* of them: stop paying the
  abstract-propagation pass for that shape (PolySAT's negative case).
- **tail-direct** — a signature whose lanes end on the host CDCL tail
  >= TAIL_SHARE of the time: skip the doomed device dispatch and hand
  the lane straight to the tail (the "device hint" is everything the
  funnel already shares — warm models, learned nogoods, cone
  restriction — which the tail consumes regardless of routing).
- **ladder** — a signature that almost never tails (predicted easy):
  the tail solve runs a bounded first rung (LADDER conflicts) before
  the unbounded call — a decided first rung is the same sound verdict
  for a fraction of the conflicts; an UNKNOWN rung falls through to
  the exact static solve.

``StaticPolicy`` routes nothing (the MYTHRIL_TPU_AUTOPILOT=0 path and
the replay baseline).
"""

from typing import NamedTuple, Optional

from mythril_tpu_torch.autopilot.features import feature_signature
from mythril_tpu_torch.support.env import env_float, env_int


class RouteDecision(NamedTuple):
    """One lane's routing plan.  ``routed_by`` is None on the static
    path and names the rule otherwise (it lands on the ledger record
    and in the replay stream)."""

    skip_word: bool = False
    skip_device: bool = False
    ladder: Optional[int] = None  # first-rung conflict budget
    routed_by: Optional[str] = None


STATIC_DECISION = RouteDecision()


def min_samples() -> int:
    return env_int("MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES", 24, floor=1)


def ladder_budget() -> int:
    return env_int("MYTHRIL_TPU_AUTOPILOT_LADDER", 2000, floor=1)


def tail_share_threshold() -> float:
    return env_float("MYTHRIL_TPU_AUTOPILOT_TAIL_SHARE", 0.9,
                     floor=0.0, ceil=1.0)


class StaticPolicy:
    """Never routes: byte-for-byte the pre-autopilot funnel."""

    name = "static"

    def decide(self, features: dict, model) -> RouteDecision:
        return STATIC_DECISION


class LedgerPolicy:
    """The shipped default (see module docstring for the rules)."""

    name = "ledger-v1"

    def decide(self, features: dict, model) -> RouteDecision:
        signature = feature_signature(features)
        total = model.samples(signature)
        threshold = min_samples()
        if total < threshold:
            return STATIC_DECISION

        skip_word = False
        skip_device = False
        ladder = None
        rules = []

        # word-skip: enough lanes of this shape got PAST the probe for
        # the word tier to have had its chance, and it decided none
        early = (model.tier_count(signature, "structural")
                 + model.tier_count(signature, "probe"))
        reached_word = total - early
        if reached_word >= threshold and not model.tier_decided(
            signature, "word"
        ):
            skip_word = True
            rules.append("word-skip")

        tail = model.tail_share(signature)
        if tail is not None:
            if tail >= tail_share_threshold():
                skip_device = True
                rules.append("tail-direct")
            elif tail <= 1.0 - tail_share_threshold():
                # predicted easy: bound the first CDCL rung; the
                # unbounded fallback keeps verdicts identical
                ladder = ladder_budget()
                rules.append("ladder")

        if not rules:
            return STATIC_DECISION
        return RouteDecision(
            skip_word=skip_word, skip_device=skip_device, ladder=ladder,
            routed_by="+".join(rules),
        )


POLICIES = {
    StaticPolicy.name: StaticPolicy,
    LedgerPolicy.name: LedgerPolicy,
}
DEFAULT_POLICY = LedgerPolicy.name


def make_policy(name: Optional[str] = None):
    """Instantiate a policy by name (the replay tool's --policy and
    the MYTHRIL_TPU_AUTOPILOT_POLICY knob both resolve here)."""
    cls = POLICIES.get(name or DEFAULT_POLICY)
    if cls is None:
        raise ValueError(
            f"unknown autopilot policy {name!r} "
            f"(have: {', '.join(sorted(POLICIES))})"
        )
    return cls()
