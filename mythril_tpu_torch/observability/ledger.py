"""Per-lane attribution ledger (own copy of
``mythril_tpu/observability/ledger.py``): which lanes burn the budget,
and where.

The span plane (observability/spans.py) makes every *phase* of the
pipeline attributable; this module makes every *lane* attributable.
Every lane entering ``batch_check_states`` (and the prune-level lanes
that bypass it, ``laser/batch.py``) gets a lifecycle record:

- **origin** — contract name, transaction index, request scope and
  trace id (set via :func:`set_origin` by the analyzer loop and the svm
  transaction loop);
- **tier transitions** — the funnel path the lane walked, drawn from a
  fixed state machine (``LEGAL_NEXT``): ``opened`` →
  {``deferred`` | ``dispatched`` | ``opaque`` | a terminal tier}, with
  device lanes terminating in ``frontier`` (event-driven rounds) or
  ``sweep`` (dense full-batch rounds) and everything undecided
  demoting to the ``tail`` (host CDCL);
- **per-tier wall and sweep counts** at batch granularity, plus
  learned clauses contributed by the batch's dispatches.

Memory is bounded: at most ``MYTHRIL_TPU_LEDGER_CAP`` (default 4096)
full records are retained — beyond the cap only the aggregates update
(``records_dropped`` counts the overflow).  Aggregates feed the metrics
registry (``mythril_tpu_ledger_*`` series), the ``--lane-ledger-out
FILE`` JSON artifact (schema ``mythril-tpu-lane-ledger/2``, checked by
``scripts/trace_lint.py``, lane conservation included: every opened
lane terminates in exactly one tier; records carry the autopilot's
per-lane ``features`` and ``routed_by`` rule, which makes an artifact
replayable through any routing policy, ``autopilot/replay.py``), and
:meth:`LaneLedger.tier_decided_pct`.

Kill switch: ``MYTHRIL_TPU_LEDGER=0`` — ``begin_batch`` returns a
shared no-op singleton after one attribute check.
"""

import os
import threading
from typing import Dict, List, Optional

#: terminal tiers a lane can be decided at — the conservation invariant
#: is ``lanes_total == sum(decided[tier] for tier in TERMINAL_TIERS)``
TERMINAL_TIERS = ("structural", "probe", "word", "frontier", "sweep",
                  "tail")
#: non-terminal lifecycle states; ``lockstep`` counts interpreter lanes
#: stepped through batched segments (symbolic_lockstep.py) — recorded
#: via count_transition only, so the conservation invariant over solver
#: lanes is untouched (a segment lane is not a solver query)
#: ``merge`` / ``subsume`` count veritesting transitions
#: (laser/ethereum/veritest.py): interpreter lanes that left the
#: frontier by collapsing into a sibling (merge = ite-join at a
#: re-convergence point, subsume = retired under a sibling's weaker
#: constraint set) — aggregate-only like ``lockstep``, so solver-lane
#: conservation is untouched (a merged lane never became a query)
TRANSITIONS = ("opened", "deferred", "dispatched", "quarantined",
               "opaque", "dropped", "lockstep", "merge", "subsume")
#: tier-transition legality (validated by scripts/trace_lint.py):
#: state -> the set of states a lane may move to next
LEGAL_NEXT = {
    "opened": {"deferred", "dispatched", "opaque", "dropped", "lockstep",
               *TERMINAL_TIERS},
    "deferred": {"tail"},
    "dispatched": {"frontier", "sweep", "tail", "quarantined"},
    "quarantined": {"tail"},
    "opaque": {"tail"},
    "dropped": {"tail"},
    # a segment lane whose successors reach the solver funnel re-enters
    # as a fresh "opened" lane; within one path a lockstep step may only
    # hand off to the funnel's entry states
    "lockstep": {"deferred", "dispatched", "opaque", "dropped",
                 *TERMINAL_TIERS},
    # a merged/subsumed lane is gone — its survivor carries on as a
    # plain interpreter lane and re-enters the funnel as "opened"
    "merge": {"opened", "lockstep"},
    "subsume": {"opened", "lockstep"},
}
VERDICTS = ("sat", "unsat", "undecided")

LEDGER_CAP = 4096       # full records retained (aggregates unbounded)
MAX_CONTRACTS = 64      # per-contract aggregate keys retained
MAX_SCOPES = 32         # per-request-scope aggregate keys retained

SCHEMA = "mythril-tpu-lane-ledger/2"

_KEEP = object()  # set_origin sentinel: leave this field unchanged

#: batch observers: called with each LaneBatch right after it folds
#: into the aggregates (the autopilot's cost model feeds from here —
#: a callback keeps the ledger free of any autopilot import)
_batch_observers: List = []


def add_batch_observer(fn) -> None:
    if fn not in _batch_observers:
        _batch_observers.append(fn)


def remove_batch_observer(fn) -> None:
    try:
        _batch_observers.remove(fn)
    except ValueError:
        pass


def ledger_enabled() -> bool:
    return os.environ.get("MYTHRIL_TPU_LEDGER", "").lower() not in (
        "0", "off", "false",
    )


def _env_cap() -> int:
    from mythril_tpu_torch.support.env import env_int

    return env_int("MYTHRIL_TPU_LEDGER_CAP", LEDGER_CAP, floor=64)


class _NoopBatch:
    """Shared no-op batch: returned (never allocated) by every
    ``begin_batch`` call while the ``MYTHRIL_TPU_LEDGER=0`` kill switch
    holds — call sites stay unconditional."""

    __slots__ = ()

    def transition(self, index, state):
        pass

    def transition_open(self, indices, state):
        pass

    def decide(self, index, tier, verdict):
        pass

    def set_features(self, index, features):
        pass

    def set_routed(self, index, rule):
        pass

    def tier_wall(self, tier, seconds):
        pass

    def add_sweeps(self, tier, sweeps):
        pass

    def add_learned(self, count):
        pass

    def close(self):
        pass


_NOOP_BATCH = _NoopBatch()


class LaneBatch:
    """One batch of lanes moving through the funnel together.  All
    bookkeeping is local (no locks) until :meth:`close` folds it into
    the ledger's aggregates in one pass."""

    __slots__ = ("_ledger", "kind", "origin", "paths", "tiers",
                 "verdicts", "features", "routed", "walls", "sweeps",
                 "learned", "_closed")

    def __init__(self, ledger: "LaneLedger", kind: str, lanes: int,
                 origin: dict):
        self._ledger = ledger
        self.kind = kind
        self.origin = origin
        self.paths: List[List[str]] = [["opened"] for _ in range(lanes)]
        self.tiers: List[Optional[str]] = [None] * lanes
        self.verdicts: List[Optional[str]] = [None] * lanes
        self.features: List[Optional[dict]] = [None] * lanes
        self.routed: List[Optional[str]] = [None] * lanes
        self.walls: Dict[str, float] = {}
        self.sweeps: Dict[str, int] = {}
        self.learned = 0
        self._closed = False

    def transition(self, index: int, state: str) -> None:
        """Record a non-terminal lifecycle move (``deferred``,
        ``dispatched``, ``quarantined``, ``opaque``, ``dropped``)."""
        if self.tiers[index] is None:
            self.paths[index].append(state)

    def transition_open(self, indices, state: str) -> None:
        for index in indices:
            self.transition(index, state)

    def decide(self, index: int, tier: str, verdict: str) -> None:
        """Terminal: the lane was decided (or demoted) at ``tier``.
        First decision wins; later calls are ignored so callers never
        need to re-check settlement."""
        if self.tiers[index] is not None:
            return
        self.tiers[index] = tier
        self.verdicts[index] = verdict
        self.paths[index].append(tier)

    def set_features(self, index: int, features: Optional[dict]) -> None:
        """Attach the autopilot's feature vector (rides on the v2
        record so recorded artifacts are policy-replayable)."""
        self.features[index] = features

    def set_routed(self, index: int, rule: Optional[str]) -> None:
        """Name the routing rule that rerouted this lane (None = the
        static path; a record field, not a lifecycle state, so the
        LEGAL_NEXT machine is untouched)."""
        self.routed[index] = rule

    def tier_wall(self, tier: str, seconds: float) -> None:
        if seconds > 0:
            self.walls[tier] = self.walls.get(tier, 0.0) + seconds

    def add_sweeps(self, tier: str, sweeps: int) -> None:
        if sweeps > 0:
            self.sweeps[tier] = self.sweeps.get(tier, 0) + int(sweeps)

    def add_learned(self, count: int) -> None:
        self.learned += int(count)

    def close(self) -> None:
        """Settle every still-open lane as tail-demoted (the CDCL tail
        answers whatever the funnel left undecided — that IS the
        demotion the ledger exists to count) and fold the batch into
        the ledger."""
        if self._closed:
            return
        self._closed = True
        for index, tier in enumerate(self.tiers):
            if tier is None:
                self.decide(index, "tail", "undecided")
        self._ledger._absorb(self)


class LaneLedger:
    """Process-wide lane-lifecycle aggregator (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cap = _env_cap()
        self.enabled = ledger_enabled()
        self.records: List[dict] = []
        self.records_dropped = 0
        self.lanes_total = 0
        self.batches = 0
        self.by_kind: Dict[str, int] = {}
        self.decided: Dict[str, int] = {t: 0 for t in TERMINAL_TIERS}
        self.verdicts: Dict[str, int] = {}      # "tier:verdict" -> n
        self.transitions: Dict[str, int] = {}   # non-terminal states
        self.routed: Dict[str, int] = {}        # autopilot rule -> n
        self.tier_wall_s: Dict[str, float] = {}
        self.tier_sweeps: Dict[str, int] = {}
        self.learned_clauses = 0
        self.by_contract: Dict[str, Dict[str, int]] = {}
        self.by_scope: Dict[str, Dict[str, int]] = {}
        self._seq = 0
        # origin context (set by the analyzer and svm layers)
        self.origin_contract: Optional[str] = None
        self.origin_tx: Optional[int] = None
        self.origin_scope: Optional[str] = None
        self.origin_trace: Optional[str] = None

    # -- origin context -------------------------------------------------

    def set_origin(self, contract=_KEEP, tx_index=_KEEP, scope=_KEEP,
                   trace=_KEEP) -> None:
        with self._lock:
            if contract is not _KEEP:
                self.origin_contract = contract
            if tx_index is not _KEEP:
                self.origin_tx = tx_index
            if scope is not _KEEP:
                self.origin_scope = scope
            if trace is not _KEEP:
                self.origin_trace = trace

    def _origin(self) -> dict:
        return {
            "contract": self.origin_contract,
            "tx": self.origin_tx,
            "scope": self.origin_scope,
            "trace": self.origin_trace,
        }

    # -- recording ------------------------------------------------------

    def begin_batch(self, kind: str, lanes: int):
        """Open a lifecycle batch of ``lanes`` lanes; returns a
        :class:`LaneBatch` (or the shared no-op when the kill switch
        holds or the batch is empty)."""
        if not self.enabled or lanes <= 0:
            return _NOOP_BATCH
        return LaneBatch(self, kind, lanes, self._origin())

    def single(self, kind: str, tier: str, verdict: str) -> None:
        """One-lane shorthand for prune-level queries that bypass the
        batch funnel entirely."""
        if not self.enabled:
            return
        batch = LaneBatch(self, kind, 1, self._origin())
        batch.decide(0, tier, verdict)
        batch.close()

    def count_transition(self, state: str, n: int = 1) -> None:
        """Aggregate-only transition tally for events that cannot be
        mapped back to an individual lane record (e.g. quarantines deep
        inside the ladder's bisection)."""
        if not self.enabled or n <= 0:
            return
        with self._lock:
            self.transitions[state] = self.transitions.get(state, 0) + n

    def _absorb(self, batch: LaneBatch) -> None:
        lanes = len(batch.tiers)
        contract = batch.origin.get("contract") or "?"
        scope = batch.origin.get("scope")
        # batch-size histogram in the registry (Prometheus semantics):
        # the shape of funnel batches — many 1-lane prune queries vs a
        # few wide dispatch batches — is itself an attribution signal
        from mythril_tpu_torch.observability.metrics import get_registry

        get_registry().histogram(
            "mythril_tpu_ledger_batch_lanes",
            "lanes per ledgered funnel batch",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
        ).observe(lanes)
        with self._lock:
            self.batches += 1
            self.lanes_total += lanes
            self.by_kind[batch.kind] = (
                self.by_kind.get(batch.kind, 0) + lanes
            )
            per_contract = self.by_contract.get(contract)
            if per_contract is None and len(self.by_contract) < (
                MAX_CONTRACTS
            ):
                per_contract = self.by_contract[contract] = {}
            per_scope = None
            if scope is not None:
                per_scope = self.by_scope.get(scope)
                if per_scope is None and len(self.by_scope) < MAX_SCOPES:
                    per_scope = self.by_scope[scope] = {}
            for index, tier in enumerate(batch.tiers):
                self.decided[tier] = self.decided.get(tier, 0) + 1
                verdict_key = f"{tier}:{batch.verdicts[index]}"
                self.verdicts[verdict_key] = (
                    self.verdicts.get(verdict_key, 0) + 1
                )
                if per_contract is not None:
                    per_contract[tier] = per_contract.get(tier, 0) + 1
                if per_scope is not None:
                    per_scope[tier] = per_scope.get(tier, 0) + 1
                for state in batch.paths[index][1:-1]:
                    self.transitions[state] = (
                        self.transitions.get(state, 0) + 1
                    )
                rule = batch.routed[index]
                if rule is not None:
                    self.routed[rule] = self.routed.get(rule, 0) + 1
                if len(self.records) < self._cap:
                    self._seq += 1
                    self.records.append({
                        "id": self._seq,
                        "kind": batch.kind,
                        "origin": dict(batch.origin),
                        "path": list(batch.paths[index]),
                        "tier": tier,
                        "verdict": batch.verdicts[index],
                        "features": batch.features[index],
                        "routed_by": rule,
                    })
                else:
                    self.records_dropped += 1
            for tier, seconds in batch.walls.items():
                self.tier_wall_s[tier] = (
                    self.tier_wall_s.get(tier, 0.0) + seconds
                )
            for tier, sweeps in batch.sweeps.items():
                self.tier_sweeps[tier] = (
                    self.tier_sweeps.get(tier, 0) + sweeps
                )
            self.learned_clauses += batch.learned
        # observers run outside the lock: the autopilot's cost-model
        # fold calls back into ledger reads (tier_decided_pct).  Unlike
        # the JAX package, a failing observer is not swallowed.
        for observer in list(_batch_observers):
            observer(batch)

    # -- aggregation / export -------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe aggregate view (the artifact's ``aggregates``
        block)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "lanes_total": self.lanes_total,
                "batches": self.batches,
                "by_kind": dict(self.by_kind),
                "decided": dict(self.decided),
                "verdicts": dict(self.verdicts),
                "transitions": dict(self.transitions),
                "routed": dict(self.routed),
                "tier_wall_s": {
                    t: round(s, 4) for t, s in self.tier_wall_s.items()
                },
                "tier_sweeps": dict(self.tier_sweeps),
                "learned_clauses": self.learned_clauses,
                "by_contract": {
                    c: dict(t) for c, t in self.by_contract.items()
                },
                "by_scope": {
                    s: dict(t) for s, t in self.by_scope.items()
                },
                "records_kept": len(self.records),
                "records_dropped": self.records_dropped,
            }

    def scope_snapshot(self, scope: str) -> Dict[str, int]:
        """Lane counts by tier of one request scope (the serve plane's
        ``/debug/requests``)."""
        with self._lock:
            return dict(self.by_scope.get(scope, {}))

    def merge_snapshot(self, snap: Optional[dict]) -> int:
        """Fold another process's aggregate snapshot into this ledger (a
        fleet worker's lanes, riding its result).  The records stay in
        the worker (counted as dropped here), every aggregate comes, so
        that conservation still sums over the fleet.  Returns the lanes
        absorbed."""
        if not self.enabled or not isinstance(snap, dict):
            return 0
        lanes = int(snap.get("lanes_total", 0))
        if not lanes:
            return 0
        with self._lock:
            self.lanes_total += lanes
            self.batches += int(snap.get("batches", 0))
            self.records_dropped += lanes
            self.learned_clauses += int(snap.get("learned_clauses", 0))
            for field, cast in (("by_kind", int), ("decided", int),
                                ("verdicts", int), ("transitions", int),
                                ("routed", int), ("tier_sweeps", int),
                                ("tier_wall_s", float)):
                ours = getattr(self, field)
                for key, value in (snap.get(field) or {}).items():
                    ours[key] = ours.get(key, cast(0)) + cast(value)
            for outer, cap in (("by_contract", MAX_CONTRACTS),
                               ("by_scope", MAX_SCOPES)):
                ours = getattr(self, outer)
                for key, tiers in (snap.get(outer) or {}).items():
                    slot = ours.get(key)
                    if slot is None:
                        if len(ours) >= cap:
                            continue
                        slot = ours[key] = {}
                    for tier, count in tiers.items():
                        slot[tier] = slot.get(tier, 0) + int(count)
        return lanes

    def tier_decided_pct(self) -> Optional[dict]:
        """The word/frontier/full/tail split: percent
        of all ledgered lanes decided at each tier (None when nothing
        was ledgered).  ``full`` is the dense full-sweep tier
        (``sweep`` internally); structural/probe decisions make the
        four keys sum below 100 by design."""
        with self._lock:
            if not self.lanes_total:
                return None
            pct = lambda n: round(100.0 * n / self.lanes_total, 1)  # noqa: E731
            return {
                "word": pct(self.decided.get("word", 0)),
                "frontier": pct(self.decided.get("frontier", 0)),
                "full": pct(self.decided.get("sweep", 0)),
                "tail": pct(self.decided.get("tail", 0)),
            }

    def export_json(self, path: str) -> str:
        """Write the ``--lane-ledger-out`` artifact (atomic, like the
        trace/metrics dumps).  ``conservation`` restates the invariant
        ``scripts/trace_lint.py`` checks so a consumer can verify it
        without re-deriving the sum."""
        import json

        with self._lock:
            records = [dict(r) for r in self.records]
        aggregates = self.snapshot()
        payload = {
            "schema": SCHEMA,
            "cap": self._cap,
            "aggregates": aggregates,
            "records": records,
            "conservation": {
                "lanes_total": aggregates["lanes_total"],
                "decided_total": sum(aggregates["decided"].values()),
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1)
        os.replace(tmp, path)
        return path

    def reset(self) -> None:
        origin = (self.origin_contract, self.origin_tx,
                  self.origin_scope, self.origin_trace)
        self.__init__()
        (self.origin_contract, self.origin_tx,
         self.origin_scope, self.origin_trace) = origin


def _ledger_collector():
    """Registry collector: mirror the ledger aggregates as
    ``mythril_tpu_ledger_*`` series at render time.  Label values
    (contract names can be arbitrary source paths) go through the
    exposition escaper in observability/metrics.py."""
    from mythril_tpu_torch.observability.metrics import escape_label_value

    ledger = get_ledger()
    snap = ledger.snapshot()
    yield ("gauge", "mythril_tpu_ledger_enabled",
           "1 while the lane ledger is recording", int(snap["enabled"]))
    yield ("counter", "mythril_tpu_ledger_lanes_total",
           "lanes opened in the attribution ledger",
           snap["lanes_total"])
    yield ("counter", "mythril_tpu_ledger_records_dropped",
           "lane records dropped at MYTHRIL_TPU_LEDGER_CAP",
           snap["records_dropped"])
    yield ("counter", "mythril_tpu_ledger_learned_clauses",
           "learned clauses contributed by ledgered batches",
           snap["learned_clauses"])
    for tier in TERMINAL_TIERS:
        yield ("counter",
               f'mythril_tpu_ledger_decided_total{{tier="{tier}"}}',
               "lanes decided per funnel tier",
               snap["decided"].get(tier, 0))
    for state, count in sorted(snap["transitions"].items()):
        yield ("counter",
               f'mythril_tpu_ledger_transitions_total'
               f'{{state="{escape_label_value(state)}"}}',
               "non-terminal lane lifecycle transitions", count)
    for rule, count in sorted((snap.get("routed") or {}).items()):
        yield ("counter",
               f'mythril_tpu_ledger_routed_total'
               f'{{rule="{escape_label_value(rule)}"}}',
               "lanes rerouted by the autopilot, per rule", count)
    for tier, seconds in sorted(snap["tier_wall_s"].items()):
        yield ("counter",
               f'mythril_tpu_ledger_tier_wall_seconds'
               f'{{tier="{escape_label_value(tier)}"}}',
               "wall-clock attributed per funnel tier", seconds)
    for contract, tiers in sorted(snap["by_contract"].items()):
        yield ("counter",
               f'mythril_tpu_ledger_contract_lanes_total'
               f'{{contract="{escape_label_value(contract)}"}}',
               "lanes ledgered per contract", sum(tiers.values()))


_ledger: Optional[LaneLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> LaneLedger:
    # the registry hooks this module's collector itself
    # (metrics._ledger_collector), so creation here stays side-effect
    # free and test registry resets re-attach automatically
    global _ledger
    if _ledger is None:
        with _ledger_lock:
            if _ledger is None:
                _ledger = LaneLedger()
    return _ledger


def set_origin(contract=_KEEP, tx_index=_KEEP, scope=_KEEP,
               trace=_KEEP) -> None:
    """Module-level origin stamping (the analyzer loop and the svm
    transaction loop call this so every lane record carries where it
    came from)."""
    get_ledger().set_origin(contract=contract, tx_index=tx_index,
                            scope=scope, trace=trace)


def reset_for_tests() -> None:
    global _ledger
    _ledger = None
