"""Degradation telemetry counters (own copy of
``mythril_tpu/resilience/telemetry.py``): a thin layer over the port's
metrics registry (``observability/metrics.py``).

The counters keep the JAX package's API (``resilience_stats.demotions
+= 1``, ``reset()``, ``as_dict()``), but each field is stored as one
registry counter, ``mythril_tpu_resilience_<field>``: a Prometheus dump
(``--metrics-out``) and ``DispatchStats.as_dict`` read the same cell,
and no counter is counted twice.  They reset per analyzed contract with
``DispatchStats``.

The port keeps the JAX package's counters: the dispatch ladder
(watchdog, retry, bisection and quarantine, demotion), the fault plane,
the checkpoint plane, the request budget, the knowledge store
(``persist/store.py``), the governor and the RPC client and provider
pool (``ethereum/interface/rpc/client.py``).  The fleet's counters are kept beside
these, in ``parallel/fleet.py`` (``fleet_stats``,
``mythril_tpu_fleet_*``), and join ``DispatchStats.as_dict`` and the
jsonv2 ``meta.resilience`` block as ``fleet_<field>``.
"""

from mythril_tpu_torch.observability.metrics import get_registry

_PREFIX = "mythril_tpu_resilience_"

#: field -> help string, in the JAX package's ``as_dict`` order
_FIELDS = {
    "watchdog_trips": "dispatch deadlines exceeded",
    "dispatch_retries": "ladder retries spent (device + CDCL)",
    "demotions": (
        "contexts demoted to the native CDCL tail "
        "(or prefetch channel abandoned)"
    ),
    "rpc_retries": "transient RPC failures retried",
    "faults_fired": "injected faults actually fired",
    # poisoned-lane bisection (ops/batched_sat._dispatch_round): only
    # the offending lane(s) go to the CDCL tail, the context stays on
    # the card
    "quarantined_lanes": "lanes isolated to the CDCL tail",
    "bisect_dispatches": "re-dispatches spent isolating them",
    # checkpoint/resume plane (resilience/checkpoint.py)
    "checkpoints_written": "journal generations persisted",
    "resumes": "analyses rebuilt from a journal",
    "checkpoint_s": "wall-clock spent writing journals",
    # per-request deadline budgets (resilience/budget.py)
    "deadline_expiries": "request wall-clock budgets that expired",
    "checkpoint_corrupt_fallbacks": (
        "corrupt journal generations skipped at load"
    ),
    # knowledge store (persist/store.py): segments failing validation
    # are set aside and the process starts colder, never crashes
    "persist_corrupt_segments": "knowledge-store segments quarantined",
    "persist_flushes": "knowledge-store segments flushed",
    "persist_report_hits": "admission-edge report cache hits",
    # resource governor (resilience/governor.py): breach observations
    # and one counter per degradation rung
    "governor_breaches": "resource-budget breaches observed",
    "governor_shrink_frontier": "frontier-width halvings applied",
    "governor_disable_planes": "lockstep-plane shutoffs applied",
    "governor_cap_tx_depth": "transaction-depth caps applied",
    "governor_drain_partial": "governor-forced partial drains",
    # RPC provider pool (ethereum/interface/rpc/client.py): breaker
    # trips, 429/-32005 backoffs, failovers and code-cache hits
    "rpc_breaker_opens": "provider circuit breakers opened",
    "rpc_rate_limited": "rate-limit (429/-32005) backoffs taken",
    "rpc_provider_rotations": "failovers to another provider",
    "rpc_code_cache_hits": "on-disk code cache hits",
}


class ResilienceStats:
    """Process-wide degradation counters, reset per analyzed contract
    with ``DispatchStats``; attribute access reads and writes the
    registry's cells."""

    __slots__ = ()

    def __init__(self):
        self.reset()

    @staticmethod
    def _cell(field: str):
        return get_registry().counter(_PREFIX + field, _FIELDS[field])

    def reset(self):
        for field in _FIELDS:
            self._cell(field).set(0.0 if field == "checkpoint_s" else 0)

    def __getattr__(self, name):
        if name in _FIELDS:
            return self._cell(name).value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name not in _FIELDS:
            raise AttributeError(
                f"unknown resilience counter {name!r} "
                f"(registered: {tuple(_FIELDS)})"
            )
        self._cell(name).set(value)

    def as_dict(self):
        return {field: self._cell(field).value for field in _FIELDS}


resilience_stats = ResilienceStats()
