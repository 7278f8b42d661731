"""Deterministic fault-injection plane (own copy of
``mythril_tpu/resilience/faults.py``).

Every partial-failure seam consults this plane through a named injection
point, so every degradation path (watchdog trip, retry, bisection and
quarantine, context demotion, a lost card) is testable on a CPU-only
host with nothing really failing.

The port keeps the JAX package's whole :data:`FAULT_POINTS` tuple, so
one spec parses the same way in both packages, and wires the seams of
the planes it has:

==================  =====================================================
``dispatch_hang``    a device dispatch blocks for ``hang_s`` seconds and
                     then raises (a wedged launch; the watchdog must trip
                     first)
``dispatch_error``   a device dispatch raises (the retry rung)
``dispatch_garbage`` a device dispatch returns corrupted lanes: every
                     status claims SAT over a garbage assignment, which
                     host verification must reject
``probe_flap``       the card's health check answers dead mid-run; the
                     port raises :class:`ops.device_health.DeviceLost`
``cdcl_error``       the native CDCL raises on solve (the tail's own
                     retry rung)
``prefetch_error``   the async prefetch worker raises mid-flight (the
                     batch is dropped, never decided)
``lane_poison``      a device dispatch raises only while a designated
                     lane is aboard (the bisection's territory)
``frontier_stall``   a frontier-solver dispatch raises before launching
``governor_breach``  one governor poll observes a budget breach
``merge_abort``      one veritesting merge aborts mid-join
``persist_flush``    one knowledge-store flush fails before it writes
                     (its records stay staged for the next flush)
``worker_kill``      a fleet worker SIGKILLs itself at a transaction
                     boundary (preemption mid-lease: the coordinator must
                     see the death and lease the subtree again from the
                     worker's last journal boundary)
``gossip_drop``      the coordinator drops one knowledge message (a lossy
                     channel: findings must not change)
``lease_partition``  the coordinator ignores one worker heartbeat (a
                     partition: enough shots expire the lease, and the
                     worker becomes the zombie the epoch fence drops)
``remote_auth_fail`` one authenticated attach is refused at the handshake
``frame_corrupt``    the coordinator strikes one frame as corrupt
``serve_crash``      one served request raises inside its analysis scope
                     (``serve/engine.py``: that request fails alone)
``rpc_error``        the RPC transport raises a transient ``OSError``
``rpc_http_500``     the RPC transport answers HTTP 500
``rpc_flap``         the provider pool's current provider drops the
                     connection mid-call (rotation and breaker)
``rpc_code_cache``   one on-disk code-cache read answers as a miss (the
                     loader falls through to the network)
==================  =====================================================

Faults are armed through the API (:meth:`FaultPlane.arm`) or the
environment::

    MYTHRIL_TPU_FAULT="dispatch_hang:3:1,lane_poison:9:0:2"

Each comma-separated spec is ``point[:times[:skip[:lane]]]``: fire
``times`` shots (default 1) after letting ``skip`` clean hits through
(default 0; a skip is how a fault lands mid-analysis); ``lane`` names
the poisoned lane of ``lane_poison``.  A malformed spec raises
:class:`FaultSpecError`, so a chaos run configured to inject nothing
dies at startup.  ``MYTHRIL_TPU_FAULT_HANG_S`` sets the hang (default
30 s).  Firing is deterministic: a shot is consumed per hit, under a
lock, with no randomness.

Kill-resume hook: ``MYTHRIL_TPU_KILL_AT="point[:skip]"`` SIGKILLs the
process when the named point is reached (after ``skip`` clean hits),
armed or not: a killed run resumed with ``--resume`` must give the
uninterrupted run's findings.
"""

import logging
import os
import threading
import time
from typing import Dict, Optional

import numpy as np

from mythril_tpu_torch.resilience.telemetry import resilience_stats

log = logging.getLogger(__name__)

FAULT_POINTS = (
    "dispatch_hang",
    "dispatch_error",
    "dispatch_garbage",
    "probe_flap",
    "cdcl_error",
    "prefetch_error",
    "rpc_error",
    "rpc_http_500",
    "lane_poison",
    "frontier_stall",
    "serve_crash",
    "worker_kill",
    "gossip_drop",
    "lease_partition",
    "remote_auth_fail",
    "frame_corrupt",
    "persist_flush",
    "governor_breach",
    "rpc_flap",
    "rpc_code_cache",
    "merge_abort",
)

DEFAULT_HANG_S = 30.0


class FaultInjected(RuntimeError):
    """Raised by an armed error fault.  The dispatch ladder's retry,
    bisection and demotion rungs act on this and on the watchdog's own
    timeout only; any other exception propagates."""


class FaultSpecError(ValueError):
    """A malformed ``MYTHRIL_TPU_FAULT`` / ``MYTHRIL_TPU_KILL_AT`` spec,
    raised at plane construction."""


class FaultPlane:
    """Armed fault shots, keyed by injection point."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: Dict[str, dict] = {}
        self.fired: Dict[str, int] = {}
        self.hits: Dict[str, int] = {}
        self._kill_at: Optional[str] = None
        self._kill_skip = 0
        self._load_env()

    def arm(self, point: str, times: int = 1, skip: int = 0,
            hang_s: Optional[float] = None,
            lane: Optional[int] = None) -> None:
        """Arm ``times`` shots of ``point`` after ``skip`` clean hits.
        ``lane`` names the poisoned lane of ``lane_poison``: its shot
        fires (and its hit counts) only while that lane is aboard."""
        if point not in FAULT_POINTS:
            raise FaultSpecError(
                f"unknown fault point {point!r} (choose from {FAULT_POINTS})"
            )
        if point == "lane_poison" and lane is None:
            raise FaultSpecError(
                "lane_poison needs a lane (arm(..., lane=K) or the "
                "fourth spec field: lane_poison:times:skip:K)"
            )
        with self._lock:
            self._armed[point] = {
                "times": times, "skip": skip, "hang_s": hang_s,
                "lane": lane,
            }

    def clear(self) -> None:
        with self._lock:
            self._armed.clear()
            self.fired.clear()
            self.hits.clear()

    def _load_env(self) -> None:
        spec = os.environ.get("MYTHRIL_TPU_FAULT", "").strip()
        for part in spec.split(",") if spec else ():
            fields = part.strip().split(":")
            if not fields[0]:
                continue
            try:
                self.arm(
                    fields[0],
                    times=int(fields[1]) if len(fields) > 1 else 1,
                    skip=int(fields[2]) if len(fields) > 2 else 0,
                    lane=int(fields[3]) if len(fields) > 3 else None,
                )
            except FaultSpecError:
                raise
            except (ValueError, IndexError) as exc:
                raise FaultSpecError(
                    f"bad MYTHRIL_TPU_FAULT spec {part!r}: {exc}"
                ) from exc
        kill = os.environ.get("MYTHRIL_TPU_KILL_AT", "").strip()
        if kill:
            fields = kill.split(":")
            if fields[0] not in FAULT_POINTS:
                raise FaultSpecError(
                    f"MYTHRIL_TPU_KILL_AT names unknown point "
                    f"{fields[0]!r} (choose from {FAULT_POINTS})"
                )
            try:
                self._kill_skip = int(fields[1]) if len(fields) > 1 else 0
            except ValueError as exc:
                raise FaultSpecError(
                    f"bad MYTHRIL_TPU_KILL_AT spec {kill!r}: {exc}"
                ) from exc
            self._kill_at = fields[0]

    def fire(self, point: str, lane_ids=None) -> Optional[dict]:
        """Consume one hit of ``point``: the armed spec when a shot
        fires, else None (unarmed, or a skipped hit).  The caller
        applies the effect.  A ``lane_poison`` hit registers only while
        the armed lane is in ``lane_ids``.  The kill-at hook triggers on
        hits of its point whatever is armed."""
        kill_now = False
        with self._lock:
            spec = self._armed.get(point)
            if spec is not None and spec.get("lane") is not None and (
                lane_ids is None or spec["lane"] not in lane_ids
            ):
                spec = None
            self.hits[point] = self.hits.get(point, 0) + 1
            if point == self._kill_at:
                if self._kill_skip > 0:
                    self._kill_skip -= 1
                else:
                    kill_now = True
            if spec is not None:
                if spec["skip"] > 0:
                    spec["skip"] -= 1
                    spec = None
                elif spec["times"] <= 0:
                    spec = None
                else:
                    spec["times"] -= 1
                    self.fired[point] = self.fired.get(point, 0) + 1
                    resilience_stats.faults_fired += 1
        if kill_now:
            log.warning("fault plane: SIGKILL at injection point %s "
                        "(MYTHRIL_TPU_KILL_AT)", point)
            logging.shutdown()
            os.kill(os.getpid(), 9)  # SIGKILL: no cleanup, by design
        if spec is not None:
            from mythril_tpu_torch.observability import spans as obs

            obs.instant("fault.fired", cat="resilience", point=point)
            log.info("fault plane: firing %s", point)
        return spec


_plane: Optional[FaultPlane] = None


def get_fault_plane() -> FaultPlane:
    global _plane
    if _plane is None:
        _plane = FaultPlane()
    return _plane


def reset_for_tests() -> None:
    global _plane
    _plane = None


# ---------------------------------------------------------------------------
# seam helpers: each injection point's effect, applied where it fires
# ---------------------------------------------------------------------------


def _hang_s(spec: dict) -> float:
    if spec.get("hang_s") is not None:
        return float(spec["hang_s"])
    return float(os.environ.get("MYTHRIL_TPU_FAULT_HANG_S", DEFAULT_HANG_S))


def maybe_fault_dispatch(lane_ids=None) -> None:
    """Device-dispatch seam, inside the watchdog-supervised thunk: a
    hang sleeps and then raises (never falls through to the launch), an
    error raises, and an armed ``lane_poison`` raises only while its
    lane is among ``lane_ids`` (the ladder's batch positions)."""
    plane = get_fault_plane()
    spec = plane.fire("dispatch_hang")
    if spec is not None:
        time.sleep(_hang_s(spec))
        raise FaultInjected("injected dispatch hang expired")
    if plane.fire("dispatch_error") is not None:
        raise FaultInjected("injected device dispatch failure")
    if plane.fire("lane_poison", lane_ids=lane_ids) is not None:
        raise FaultInjected(
            "injected lane-dependent kernel abort (poisoned lane aboard)"
        )


def maybe_abort_merge() -> bool:
    """Veritesting merge seam (``laser/ethereum/veritest.py``): True when
    an armed ``merge_abort`` shot fires; the pair then forks on."""
    return get_fault_plane().fire("merge_abort") is not None


def maybe_fault_frontier() -> None:
    """Frontier-solver seam (``ops/batched_sat._dispatch_round``), inside
    the supervised thunk, so a stall walks the same ladder."""
    if get_fault_plane().fire("frontier_stall") is not None:
        raise FaultInjected("injected frontier-round stall")


def maybe_corrupt_lanes(status: np.ndarray, assign: np.ndarray):
    """Garbage-lane seam: when ``dispatch_garbage`` fires every lane
    claims a SAT candidate over a garbage assignment, which host model
    verification must reject."""
    if get_fault_plane().fire("dispatch_garbage") is None:
        return status, assign
    status = np.ones_like(status)
    garbage = np.ones_like(assign)
    garbage[..., ::2] = -1
    return status, garbage


def health_flap() -> bool:
    """Health-check seam (``ops/device_health.py``): True when
    ``probe_flap`` fires."""
    return get_fault_plane().fire("probe_flap") is not None


def maybe_fault_cdcl() -> None:
    """Native-CDCL seam (``smt/bitblast.py``): raises when armed."""
    if get_fault_plane().fire("cdcl_error") is not None:
        raise FaultInjected("injected native CDCL abort")


def maybe_fault_prefetch() -> None:
    """Async-prefetch seam (``ops/async_dispatch.py`` worker)."""
    if get_fault_plane().fire("prefetch_error") is not None:
        raise FaultInjected("injected prefetch worker failure")


def maybe_fault_request() -> None:
    """Served-request seam (the ``serve_crash`` point, fired inside the
    serve engine's analysis scope): raises when armed, so that a test
    can crash exactly one request and check that it fails alone."""
    if get_fault_plane().fire("serve_crash") is not None:
        raise FaultInjected("injected served-request crash")


def maybe_fault_worker_kill() -> None:
    """Fleet-worker seam (``parallel/fleet.py``, at each transaction
    boundary of a lease): SIGKILL this process when armed, with no
    cleanup, as a preempted machine gets none."""
    if get_fault_plane().fire("worker_kill") is not None:
        log.warning("fault plane: fleet worker self-SIGKILL (worker_kill)")
        logging.shutdown()
        os.kill(os.getpid(), 9)


def maybe_fault_governor() -> bool:
    """Governor seam (``governor.poll``): True when ``governor_breach``
    fires; that poll observes a breach and applies the next rung."""
    return get_fault_plane().fire("governor_breach") is not None


def maybe_fault_rpc() -> None:
    """RPC-transport seam (``ethereum/interface/rpc/client.py``): raises
    the exception types the real transport does, so the injected failure
    walks the client's own classification and retry path."""
    if get_fault_plane().fire("rpc_error") is not None:
        raise OSError("injected connection reset")
    if get_fault_plane().fire("rpc_http_500") is not None:
        import urllib.error

        raise urllib.error.HTTPError(
            "http://injected", 500, "injected server error", None, None
        )


def maybe_fault_rpc_flap() -> None:
    """Provider-pool seam (``ProviderPool._call``, per provider attempt):
    a transient connection drop against the current provider; the pool
    rotates and the provider's breaker counts it."""
    if get_fault_plane().fire("rpc_flap") is not None:
        raise OSError("injected provider flap")


def maybe_fault_code_cache() -> bool:
    """Code-cache seam (``ProviderPool.eth_getCode``'s cache read): True
    when ``rpc_code_cache`` fires; the read answers as a miss and the
    loader falls through to the network."""
    return get_fault_plane().fire("rpc_code_cache") is not None
