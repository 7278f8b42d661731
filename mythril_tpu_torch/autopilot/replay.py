"""Offline policy replay over recorded ledger artifacts (own copy of
``mythril_tpu/autopilot/replay.py``).

A ``--lane-ledger-out`` artifact at schema ``mythril-tpu-lane-ledger/2``
carries, per record, the feature vector the autopilot saw and the
terminal tier/verdict the funnel produced — everything needed to
re-derive routing decisions without re-running any analysis.  Replay
streams the records in artifact order through a fresh cost model and a
policy, mirroring the live semantics exactly:

1. for each record with features, ask the policy first (model state =
   everything seen so far — the online decision);
2. then fold the record's observed outcome into the model, *unless*
   the replayed policy routed it (the live observer skips routed lanes
   for the same reason: their statistics describe the routed funnel).

Determinism is the contract: same artifact + same policy → identical
decision stream, pinned by the sha256 digest over the stream.

v1 artifacts (no feature vectors) replay trivially: every decision is
None/static — kept readable so old recordings don't error, they just
carry no routing signal.
"""

import hashlib
import json
from typing import List, Optional

from mythril_tpu_torch.autopilot.features import feature_signature
from mythril_tpu_torch.autopilot.model import CostModel
from mythril_tpu_torch.autopilot.policy import make_policy

SUPPORTED_SCHEMAS = (
    "mythril-tpu-lane-ledger/1",
    "mythril-tpu-lane-ledger/2",
)


def load_artifact(path: str) -> dict:
    with open(path) as fh:
        payload = json.load(fh)
    schema = payload.get("schema") if isinstance(payload, dict) else None
    if schema not in SUPPORTED_SCHEMAS:
        raise ValueError(
            f"{path}: schema {schema!r} not one of {SUPPORTED_SCHEMAS}"
        )
    return payload


def replay_records(records: List[dict],
                   policy: Optional[str] = None) -> dict:
    """Deterministic replay (see module docstring).  Returns the
    decision stream, per-rule counts, and the stream digest."""
    model = CostModel()
    pol = make_policy(policy)
    decisions: List[Optional[str]] = []
    rules = {}
    for record in records:
        features = record.get("features")
        if not isinstance(features, dict):
            decisions.append(None)
            continue
        decision = pol.decide(features, model)
        decisions.append(decision.routed_by)
        if decision.routed_by is not None:
            rules[decision.routed_by] = (
                rules.get(decision.routed_by, 0) + 1
            )
            continue
        model.observe(
            feature_signature(features),
            record.get("tier", "tail"),
            record.get("verdict") != "undecided",
        )
    digest = hashlib.sha256(
        json.dumps(decisions).encode("utf-8")
    ).hexdigest()
    return {
        "policy": pol.name,
        "records": len(records),
        "with_features": sum(
            1 for r in records if isinstance(r.get("features"), dict)
        ),
        "routed": sum(1 for d in decisions if d is not None),
        "rules": rules,
        "decisions": decisions,
        "digest": digest,
    }


def replay_artifact(path: str, policy: Optional[str] = None) -> dict:
    payload = load_artifact(path)
    result = replay_records(payload.get("records", []), policy=policy)
    result["schema"] = payload.get("schema")
    return result
