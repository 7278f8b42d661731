"""``myth top`` — one-screen live status of a running ``myth serve``
daemon or fleet coordinator (own copy of ``mythril_tpu/interfaces/top.py``;
it reads either package's server).

Polls the live introspection endpoints the observability plane exposes
(``/debug/requests``, ``/debug/lanes``, ``/debug/autopilot``,
``/debug/fleet``, and — on a serve instance — ``/readyz``) and renders
a compact terminal dashboard: server health, the in-flight request
(phase, deadline budget remaining, lane counts by tier), recent
requests, the serving fabric's seat table and per-tenant quota
consumption, the lane-attribution funnel split, and the autopilot's
routing/tuning activity.
Stdlib-only, read-only, and safe against a half-up server (connection
errors render as a status line, not a traceback).

Usage::

    python3 -m mythril_tpu_torch top              # http://127.0.0.1:8551
    python3 -m mythril_tpu_torch top --url http://host:port
                                      # a serve daemon or a fleet
                                      # coordinator's debug port
    python3 -m mythril_tpu_torch top --once
                                      # single snapshot (no clearing,
                                      # scripting/tests)
"""

import json
import sys
import time
import urllib.error
import urllib.request
from typing import Optional

POLL_TIMEOUT_S = 3.0


def _get_json(url: str) -> Optional[dict]:
    try:
        with urllib.request.urlopen(url, timeout=POLL_TIMEOUT_S) as rsp:
            return json.loads(rsp.read().decode("utf-8"))
    except (urllib.error.URLError, urllib.error.HTTPError, OSError,
            ValueError):
        return None


def _bar(fraction: float, width: int = 24) -> str:
    fraction = max(0.0, min(1.0, fraction))
    filled = int(round(fraction * width))
    return "#" * filled + "." * (width - filled)


def _render_lanes(lanes: Optional[dict], out) -> None:
    if not lanes or not lanes.get("lanes_total"):
        print("  lanes: none ledgered yet", file=out)
        return
    total = lanes["lanes_total"]
    decided = lanes.get("decided", {})
    print(f"  lanes: {total} total "
          f"({lanes.get('batches', 0)} batches, "
          f"{lanes.get('learned_clauses', 0)} learned clauses)",
          file=out)
    for tier in ("structural", "probe", "word", "frontier", "sweep",
                 "tail"):
        n = decided.get(tier, 0)
        if not n:
            continue
        print(f"    {tier:<10} {n:>7}  "
              f"[{_bar(n / total)}] {100.0 * n / total:5.1f}%",
              file=out)
    transitions = lanes.get("transitions") or {}
    if transitions:
        print("    transitions: " + ", ".join(
            f"{k}={v}" for k, v in sorted(transitions.items())
        ), file=out)


def _render_autopilot(pilot: Optional[dict], out) -> None:
    if not pilot:
        return  # endpoint absent (older server) — panel just drops out
    if not pilot.get("enabled"):
        print("  autopilot: off (MYTHRIL_TPU_AUTOPILOT=0)", file=out)
        return
    counters = pilot.get("counters") or {}
    print(f"  autopilot: policy={pilot.get('policy')}  "
          f"seen={counters.get('lanes_seen', 0)} "
          f"routed={counters.get('lanes_routed', 0)} "
          f"(word-skip={counters.get('word_skips', 0)}, "
          f"tail-direct={counters.get('tail_routes', 0)}, "
          f"ladder={counters.get('ladder_decided', 0)}/"
          f"{counters.get('ladder_solves', 0)})", file=out)
    tuner = pilot.get("tuner") or {}
    overrides = tuner.get("overrides") or {}
    line = (f"    tuner: tail-ewma={tuner.get('tail_ewma')} "
            f"queue-ewma={tuner.get('queue_ewma')} "
            f"adjust={tuner.get('adjustments', 0)} "
            f"revert={tuner.get('reverts', 0)}")
    if overrides:
        line += "  overrides: " + ", ".join(
            f"{k}={v}" for k, v in sorted(overrides.items())
        )
    print(line, file=out)
    model = pilot.get("model") or {}
    top_rows = model.get("top") or []
    if top_rows:
        print(f"    model: {model.get('signatures', 0)} signatures, "
              f"{model.get('observations', 0)} observations", file=out)


def _render_serve(ready: Optional[dict], requests: Optional[dict],
                  out) -> None:
    if ready is not None:
        state = "READY" if ready.get("ready") else (
            "DRAINING" if ready.get("draining") else "NOT-READY"
        )
        print(f"  server: {state}  mode={ready.get('mode', '?')}  "
              f"queues={ready.get('queue_depths')}", file=out)
    if requests is None:
        return
    flight = requests.get("in_flight")
    if flight:
        remaining = flight.get("budget_remaining_s")
        budget = flight.get("budget_s") or 0
        gauge = ""
        if remaining is not None and budget:
            gauge = f" [{_bar(remaining / budget, 16)}]"
        print(f"  in-flight: {flight.get('contract')} "
              f"({flight.get('request_id')}, "
              f"trace {flight.get('trace_id')})", file=out)
        print(f"    phase={flight.get('phase') or '-'}  "
              f"elapsed={flight.get('elapsed_s')}s  "
              f"budget-left={remaining}s{gauge}", file=out)
        tiers = flight.get("lanes_by_tier") or {}
        if tiers:
            print("    lanes so far: " + ", ".join(
                f"{k}={v}" for k, v in sorted(tiers.items())
            ), file=out)
    else:
        print("  in-flight: idle", file=out)
    done = requests.get("requests") or {}
    print(f"  totals: done={done.get('done', 0)} "
          f"failed={done.get('failed', 0)} "
          f"partial={done.get('partial', 0)}", file=out)
    recent = requests.get("recent") or []
    if recent:
        print("  recent:", file=out)
        for row in recent[:6]:
            flags = " partial" if row.get("partial") else ""
            print(f"    {row.get('status')} {row.get('contract'):<18} "
                  f"{row.get('analysis_s')}s "
                  f"trace={row.get('trace_id')}{flags}", file=out)


def _render_fabric(fleet_body: Optional[dict], out) -> None:
    """The serving-fabric panel: listen endpoint, routing counters,
    per-seat liveness, per-tenant quota consumption.  Absent fabric
    (no ``--fleet-listen``) drops the panel entirely."""
    if not fleet_body:
        return
    fabric = fleet_body.get("fabric")
    if not fabric:
        return
    auth = "auth" if fabric.get("authenticated") else "open"
    print(f"  fabric: {fabric.get('listen')} ({auth})  "
          f"seats={fabric.get('seats', 0)}  "
          f"routed={fabric.get('routed', 0)} "
          f"fallbacks={fabric.get('fallbacks', 0)} "
          f"revoked={fabric.get('revoked', 0)} "
          f"in-flight={fabric.get('jobs_in_flight', 0)}", file=out)
    coordinator = fabric.get("coordinator") or {}
    for seat in coordinator.get("seats", []):
        if seat.get("dead"):
            status = "dead"
        elif seat.get("lease"):
            status = "busy"
        else:
            status = "idle"
        where = "remote" if seat.get("remote") else "local"
        print(f"    seat {seat.get('worker_id'):<16} {status:<5} "
              f"{where}  lease={seat.get('lease') or '-'}", file=out)
    tenants = fleet_body.get("tenants") or {}
    if tenants:
        quota = fleet_body.get("tenant_quota_s") or 0
        cap = f"/{quota:g}s" if quota else "s"
        print("    tenants: " + ", ".join(
            f"{source}={spent}{cap}"
            for source, spent in sorted(tenants.items())
        ), file=out)


def _render_watch(watch_body: Optional[dict], out) -> None:
    """The live-chain ingestion panel: cursor/head/lag, exactly-once
    accounting, backlog depth, serve-side dedup attribution.  Absent
    endpoint (older server) or no watcher (inactive, no snapshot
    pushed) drops the panel entirely."""
    if not watch_body:
        return
    watch = watch_body.get("watch") or {}
    if not watch.get("active") and not watch.get("blocks_seen"):
        return
    state = "following" if watch.get("active") else "stopped"
    print(f"  watch: {state}  cursor={watch.get('cursor')} "
          f"head={watch.get('head')} "
          f"lag={watch.get('lag_blocks')} "
          f"(+{watch.get('confirmations', 0)} conf)  "
          f"reorgs={watch.get('reorgs', 0)}", file=out)
    print(f"    deployments={watch.get('deployments', 0)} "
          f"unique={watch.get('unique_submitted', 0)} "
          f"dedup-hits={watch.get('dedup_hits', 0)}  "
          f"analyzed={watch.get('analyzed', 0)} "
          f"cached={watch.get('cached', 0)} "
          f"errors={watch.get('errors', 0)}  "
          f"backlog={watch.get('backlog_depth', 0)}", file=out)
    cache_hits = watch_body.get("serve_cache_hits")
    spent = watch_body.get("watch_tenant_spent_s")
    if cache_hits or spent:
        print(f"    serve side: cache-hits={cache_hits or 0} "
              f"tenant-spend={spent or 0}s", file=out)


def _render_fleet(requests: dict, out) -> None:
    print(f"  coordinator trace: {requests.get('trace_id')}", file=out)
    for lease in requests.get("leases", []):
        running = (f" {lease['running_s']}s"
                   if lease.get("running_s") is not None else "")
        print(f"    {lease['lease_id']:<8} {lease['state']:<8} "
              f"epoch={lease['epoch']} attempts={lease['attempts']} "
              f"worker={lease.get('worker') or '-'}"
              f" states={lease['states']}{running}", file=out)
    for seat in requests.get("seats", []):
        status = "dead" if seat["dead"] else (
            "idle" if not seat.get("lease") else "busy"
        )
        print(f"    seat {seat['worker_id']:<4} {status}"
              f" lease={seat.get('lease') or '-'}", file=out)


def render_once(url: str, out=None) -> bool:
    """One dashboard frame; returns False when nothing answered (the
    caller decides whether that ends a --once run with an error)."""
    out = out or sys.stdout
    base = url.rstrip("/")
    requests = _get_json(base + "/debug/requests")
    lanes = _get_json(base + "/debug/lanes")
    pilot = _get_json(base + "/debug/autopilot")
    ready = _get_json(base + "/readyz")
    fleet_body = _get_json(base + "/debug/fleet")
    watch_body = _get_json(base + "/debug/watch")
    print(f"myth top — {base}  "
          f"({time.strftime('%H:%M:%S')})", file=out)
    if requests is None and lanes is None:
        print("  unreachable (is the server up? serve exposes "
              "/debug/* on its port; a fleet coordinator needs "
              "MYTHRIL_TPU_FLEET_DEBUG_PORT)", file=out)
        return False
    if requests is not None and requests.get("role") == "coordinator":
        _render_fleet(requests, out)
    else:
        _render_serve(ready, requests, out)
        _render_fabric(fleet_body, out)
        _render_watch(watch_body, out)
    _render_lanes(lanes, out)
    _render_autopilot(pilot, out)
    return True


def run_top(url: str, interval_s: float = 2.0,
            once: bool = False) -> int:
    """CLI entry (``myth top``).  Returns the process exit code."""
    if once:
        return 0 if render_once(url) else 1
    try:
        while True:
            # ANSI clear + home keeps it one-screen without curses
            sys.stdout.write("\x1b[2J\x1b[H")
            render_once(url)
            sys.stdout.flush()
            time.sleep(max(0.2, interval_s))
    except KeyboardInterrupt:
        return 0
