"""The resilience plane (own copy of ``mythril_tpu/resilience``): fault
injection, dispatch supervision, checkpoint and resume, drain, request
budgets, the resource governor, and their counters.

- :mod:`.faults`: a deterministic, env/API-configurable fault plane
  with named injection points at the partial-failure seams (device
  dispatch, health check, native CDCL, async prefetch, governor,
  veritesting merge);
- :mod:`.watchdog`: per-dispatch deadlines from the dispatch's latency
  EWMA and the escalation ladder (retry, then bisection in the funnel,
  then a re-probe of the card and the demotion of the context to the
  CDCL); it acts on injected faults and its own timeouts only;
- :mod:`.checkpoint`: the CRC-checked journal, ``--checkpoint-dir`` /
  ``--resume``, and the drain flag SIGTERM/SIGINT set;
- :mod:`.budget`: per-request wall-clock budgets, read as a drain;
- :mod:`.governor`: resource budgets and the degradation rungs;
- :mod:`.telemetry`: the ``mythril_tpu_resilience_*`` counters.

Degradation never changes findings, only who computes them: a demoted
context re-solves its in-flight lanes on the native CDCL tail, a
quarantined lane is re-solved there alone, and a resumed analysis
rebuilds its frontier from the journal.  A lost card is an error
(``ops/device_health.DeviceLost``), never a run on the CPU.
"""

from mythril_tpu_torch.resilience.telemetry import resilience_stats  # noqa: F401
