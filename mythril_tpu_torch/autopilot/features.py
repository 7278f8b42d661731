"""Cheap per-lane feature extraction at funnel entry (own copy of
``mythril_tpu/autopilot/features.py``).

The routing policy (autopilot/policy.py) needs to recognize a query's
*shape* before any tier has touched it, from nothing but the term DAG
— the same signal PolySAT (arxiv 2406.04696) keys word-level routing
on: some shapes the word tier decides instantly, others it can never
decide and the time is pure waste.  A feature vector here is one
bounded DAG walk (seen-set over interned node ids, so shared sub-DAGs
count once):

- ``constraints`` / ``nodes``      cone size (assertions, unique DAG
                                   nodes under them)
- ``vars``                         free bitvector/boolean/array vars
- ``ops``                          op-class histogram: ``arith``
                                   (add/mul/div/...), ``cmp`` (eq/ult/
                                   slt/...), ``bit`` (and/shl/extract/
                                   concat/...), ``bool`` (band/ite/...),
                                   ``mem`` (select/store/apply)
- ``max_width``                    widest bitvector in the cone
- ``tx``                           origin transaction depth (stamped by
                                   the caller from the ledger origin)

Feature vectors are JSON-safe (they ride on ledger v2 records so the
offline replay can re-derive routing decisions) and deterministic: the
same constraint set always yields the same vector and the same
:func:`feature_signature` bucket string, which is the cost model's key.

The walk is memoized per constraint-set key (bounded; cleared by
``reset_for_tests``) so frontier rounds that repeat constraint sets
pay it once.
"""

from typing import Dict, List, Optional

#: bump when the vector layout or signature bucketing changes — the
#: cost model and the replay tool refuse to mix versions
FEATURE_VERSION = 1

#: op -> feature class.  Anything unlisted counts as "other" (leaf
#: constants and variables are counted separately).
OP_CLASS = {
    "add": "arith", "sub": "arith", "mul": "arith",
    "udiv": "arith", "sdiv": "arith", "urem": "arith", "srem": "arith",
    "eq": "cmp", "ult": "cmp", "ule": "cmp", "slt": "cmp", "sle": "cmp",
    "and": "bit", "or": "bit", "xor": "bit", "not": "bit",
    "shl": "bit", "lshr": "bit", "ashr": "bit",
    "concat": "bit", "extract": "bit", "zext": "bit", "sext": "bit",
    "band": "bool", "bor": "bool", "bnot": "bool", "bxor": "bool",
    "ite": "bool",
    "select": "mem", "store": "mem", "apply": "mem",
    "constarr": "mem",
}
OP_CLASSES = ("arith", "cmp", "bit", "bool", "mem", "other")
_VAR_OPS = ("var", "bvar", "avar")
_CONST_OPS = ("const", "bconst")

_MEMO_CAP = 4096
_memo: Dict[tuple, dict] = {}


def lane_features(nodes: List, tx: Optional[int] = None) -> dict:
    """Feature vector for one constraint set (a list of term DAG
    roots).  One iterative walk, memoized by the interned node-id key
    the funnel already uses for its own memos."""
    key = tuple(sorted(n.id for n in nodes))
    cached = _memo.get(key)
    if cached is None:
        cached = _extract(nodes)
        if len(_memo) >= _MEMO_CAP:
            # drop the oldest quarter (insertion order ~ recency here:
            # frontier rounds re-insert nothing, they hit)
            for stale in list(_memo)[: _MEMO_CAP // 4]:
                del _memo[stale]
        _memo[key] = cached
    features = dict(cached)
    if tx is not None:
        features["tx"] = int(tx)
    return features


def _extract(nodes: List) -> dict:
    ops = {c: 0 for c in OP_CLASSES}
    seen = set()
    stack = list(nodes)
    n_vars = 0
    n_consts = 0
    max_width = 0
    while stack:
        node = stack.pop()
        if node.id in seen:
            continue
        seen.add(node.id)
        if node.width and node.width > max_width:
            max_width = node.width
        op = node.op
        if op in _VAR_OPS:
            n_vars += 1
        elif op in _CONST_OPS:
            n_consts += 1
        else:
            ops[OP_CLASS.get(op, "other")] += 1
        stack.extend(node.args)
    return {
        "v": FEATURE_VERSION,
        "constraints": len(nodes),
        "nodes": len(seen),
        "vars": n_vars,
        "consts": n_consts,
        "max_width": max_width,
        "ops": ops,
    }


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
    model buckets them apart.  Rides the same signature/cost-model
    machinery as the solver lanes under the ``lockstep`` tier key."""
    features = {
        "v": FEATURE_VERSION,
        "seg_lanes": int(lanes),
        "seg_ops": int(ops),
        "seg_coherence": round(float(coherence), 3),
    }
    if planes:
        # key present only when a plane op is in the run: plane-free
        # segments keep their pre-plane signatures (and ledger rows)
        features["seg_planes"] = tuple(sorted(planes))
    return features


def _bucket(n: int) -> int:
    """Power-of-two bucket (0, 1, 2, 4, 8, ...) — the signature must
    generalize across cones that differ by a node or two."""
    return 0 if n <= 0 else 1 << (int(n).bit_length() - 1)


def feature_signature(features: dict) -> str:
    """Deterministic bucket key for the cost model.  Buckets counts to
    powers of two so near-identical cones share statistics; keeps the
    op-class *mix* (which classes are present) rather than exact
    counts; carries the transaction depth verbatim (depth changes the
    workload shape wholesale — deeper txs mean wider storage cones)."""
    if "seg_lanes" in features:
        # segment-shape signature (lockstep tier): lane count and run
        # length bucket like cone counts; coherence in tenths — solver
        # signatures are untouched (no seg_* fields, no suffix)
        coh = int(round(features.get("seg_coherence", 0.0) * 10))
        planes = features.get("seg_planes") or ()
        # plane-kind suffix (k/m/s initials) only when the run crosses
        # a data plane — plane-free signatures stay byte-identical to
        # the pre-plane ledger
        suffix = ("." + "".join(sorted(k[:1] for k in planes))
                  if planes else "")
        return (
            f"f{features.get('v', 0)}"
            f".g{_bucket(features.get('seg_lanes', 0))}"
            f".o{_bucket(features.get('seg_ops', 0))}"
            f".h{coh}"
            f"{suffix}"
        )
    ops = features.get("ops") or {}
    mix = "".join(c[0] for c in OP_CLASSES if ops.get(c))
    return (
        f"f{features.get('v', 0)}"
        f".c{_bucket(features.get('constraints', 0))}"
        f".n{_bucket(features.get('nodes', 0))}"
        f".x{_bucket(features.get('vars', 0))}"
        f".w{_bucket(features.get('max_width', 0))}"
        f".t{features.get('tx', '-')}"
        f".{mix or 'none'}"
    )


def reset_for_tests() -> None:
    _memo.clear()
