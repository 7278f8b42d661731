"""Routing features (own copy of the part of
``mythril_tpu/autopilot/features.py`` that the symbolic lockstep tier
reads)."""

#: version of the feature vectors (the JAX package's)
FEATURE_VERSION = 1


def segment_features(lanes: int, ops: int, coherence: float,
                     planes=()) -> dict:
    """Shape vector for one lockstep segment group (symbolic_lockstep):
    lane count, straight-line run length, and entry-stack coherence —
    the fraction of entry stack slots holding interned-shared or
    constant terms across the group (1.0 = fully coherent siblings,
    0.0 = unrelated states that happen to share a pc).  ``planes``
    names the data-plane kinds ("keccak"/"mem"/"storage") the run
    crosses: segments that gather/scatter memory or hash on-device
    cost differently per lane than pure stack traffic, so the cost
    model buckets them apart."""
    features = {
        "v": FEATURE_VERSION,
        "seg_lanes": int(lanes),
        "seg_ops": int(ops),
        "seg_coherence": round(float(coherence), 3),
    }
    if planes:
        # key present only when a plane op is in the run: plane-free
        # segments keep their pre-plane signatures
        features["seg_planes"] = tuple(sorted(planes))
    return features
