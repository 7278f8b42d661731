"""Per-dispatch watchdog and the escalation ladder (own copy of
``mythril_tpu/resilience/watchdog.py``).

Every supervised device dispatch runs its thunk on a worker thread,
joined with a deadline derived from the dispatch's own latency EWMA
(``min(cap, max(5 s, 8 x ewma))``, cap ``MYTHRIL_TPU_DISPATCH_TIMEOUT``;
a cold key gets the full cap).  A tripped deadline or an injected
failure walks the ladder: bounded retry with backoff and jitter
(:meth:`DispatchWatchdog.run_attempts`), then, in the funnel, the
poisoned-lane bisection over lane buckets (``ops/batched_sat.py``), then
:meth:`DispatchWatchdog.give_up`: a re-probe of the card in a killable
subprocess (``ops/device_health.py``) and the demotion of this analysis
context to the native CDCL tail (:class:`DispatchAbandoned`; the caller
returns every in-flight lane undecided and the tail re-solves it).

Where the port differs from the JAX package:

- **What the ladder catches.**  JAX retries any ``Exception``.  The
  port's retry, bisection and demotion rungs act only on the fault
  plane's ``FaultInjected`` and on this module's
  :class:`WatchdogTimeout`.  Anything else raised inside a supervised
  dispatch (a kernel build or launch error, a ``torch.cuda`` error, a
  ``KeccakKernelError``) propagates unchanged out of
  :meth:`DispatchWatchdog.supervised`, and the analysis fails: the
  ladder never carries on without a kernel.  Under injected faults both
  packages walk the same rungs.
- **No process demotion.**  A re-probe that answers demotes the
  context, as in JAX.  A re-probe that fails raises
  :class:`ops.device_health.DeviceLost`; the JAX package's
  ``mark_unhealthy`` and ``unhealthy_skips`` are not copied.  The
  re-probe is skipped for a CPU device (JAX skips it under
  ``JAX_PLATFORMS=cpu``).
- **Streams.**  The port's kernels launch on the calling thread's
  current CUDA stream.  The worker enters the caller's stream and
  synchronizes it before the thunk returns, so the host copy (the point
  where a wedged launch parks) stays under the deadline.
- **A trip on a CUDA stream is terminal.**  The tripped worker stays
  blocked in the stream's synchronize, and every later launch on that
  stream queues behind the stuck one, so a retry or a bisection
  sub-dispatch could only trip again.  A :class:`WatchdogTimeout` from a
  worker that ran on a CUDA stream skips the retry and the bisection
  (:attr:`DispatchFailed.terminal`) and goes straight to
  :meth:`DispatchWatchdog.give_up`.  Where no stream was entered (a CPU
  run, and every parity test) the ladder walks JAX's rungs.

What the ladder cannot do: recover a launch that never returns on a
card that still answers.  The re-probe runs in a process of its own, so
a kernel spinning on this process's stream does not fail it; the context
is demoted to the CDCL, but the unsupervised launches that follow (the
word tier, the lockstep interpreter, keccak) go onto the same stream and
block the host with no deadline.  A slow launch that ends does recover:
those launches wait for it and run.

A tripped worker is left parked: cooperative code it would run after
the runtime returns calls :func:`raise_if_cancelled` between chunks, so
an abandoned worker never races the host on shared state.

Env knobs: ``MYTHRIL_TPU_DISPATCH_TIMEOUT`` (deadline cap, default 120
s), ``MYTHRIL_TPU_DISPATCH_RETRIES`` (default 2),
``MYTHRIL_TPU_DISPATCH_BACKOFF_S`` (default 0.05).  The latency table
holds :data:`EWMA_CAP` keys, least recently used evicted.
"""

import logging
import os
import random
import threading
import time
from typing import Callable, Dict, Optional

from mythril_tpu_torch.observability import flight as obs_flight
from mythril_tpu_torch.observability import spans as obs
from mythril_tpu_torch.resilience.faults import FaultInjected
from mythril_tpu_torch.resilience.telemetry import resilience_stats

log = logging.getLogger(__name__)

DEADLINE_FLOOR_S = 5.0   # warm deadlines never drop below this
DEADLINE_MULT = 8.0      # deadline = EWMA x this
EWMA_ALPHA = 0.3
#: latency-table cap: round-ladder keys ("frontier:64", "cone:512")
#: multiply per bucket; the resident solver keeps one family a lane
#: bucket ("resident:8"); least recently used quarter evicted
EWMA_CAP = 64


class WatchdogTimeout(RuntimeError):
    """A supervised dispatch exceeded its deadline.  ``on_stream``: its
    worker ran on a CUDA stream, which may still hold the stuck
    launch."""

    def __init__(self, message: str, on_stream: bool = False):
        super().__init__(message)
        self.on_stream = on_stream


class DispatchFailed(RuntimeError):
    """The retry rung exhausted its attempts for one dispatch, or a trip
    on a CUDA stream ended them at once (``terminal``); raised by
    :meth:`DispatchWatchdog.run_attempts` without demoting anything (the
    caller bisects, unless ``terminal``, or escalates through
    ``give_up``)."""

    def __init__(self, message: str, last: Optional[BaseException] = None,
                 terminal: bool = False):
        super().__init__(message)
        self.last = last
        self.terminal = terminal


class WatchdogCancelled(RuntimeError):
    """Raised inside an abandoned worker at its next cancellation
    checkpoint (:func:`raise_if_cancelled`)."""


class DispatchAbandoned(RuntimeError):
    """The ladder gave up on this dispatch while the card still answers:
    the caller demotes its context and leaves every lane to the CDCL."""


#: what the retry, bisection and demotion rungs catch
LADDER_ERRORS = (FaultInjected, WatchdogTimeout)

_tls = threading.local()


def raise_if_cancelled() -> None:
    """Cooperative cancellation checkpoint for supervised thunks: after
    the watchdog abandoned the dispatch, the next checkpoint raises."""
    event = getattr(_tls, "cancel_event", None)
    if event is not None and event.is_set():
        raise WatchdogCancelled("dispatch abandoned by watchdog")


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _callers_stream():
    """The calling thread's current CUDA stream, or None where CUDA is
    not in use (a CPU run never initializes it)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    return torch.cuda.current_stream()


def _on_stream(stream, thunk: Callable):
    """``thunk`` run on ``stream`` (the caller's), the stream then
    synchronized; plainly where ``stream`` is None."""
    if stream is None:
        return thunk()
    import torch

    with torch.cuda.stream(stream):
        result = thunk()
        stream.synchronize()
    return result


class DispatchWatchdog:
    """Deadline supervision and the escalation ladder, with a per-key
    latency EWMA (keys name dispatch shapes: ``pallas``, ``resident:8``,
    ``frontier:64``, ``gather:256``, ``cone:512``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ewma: Dict[str, float] = {}
        #: supervised attempts run, and the host seconds their worker
        #: threads cost beyond the thunk (start until the thunk began,
        #: and from its end until the join returned)
        self.runs = 0
        self.thread_s = 0.0

    # -- deadline model ------------------------------------------------

    def deadline_for(self, key: str) -> float:
        cap = _env_f("MYTHRIL_TPU_DISPATCH_TIMEOUT", 120.0)
        with self._lock:
            ewma = self._ewma.get(key)
            if ewma is not None:
                # refresh recency: a shape still dispatching is never
                # the one evicted
                del self._ewma[key]
                self._ewma[key] = ewma
        if ewma is None:
            return cap
        return min(cap, max(DEADLINE_FLOOR_S, ewma * DEADLINE_MULT))

    def observe(self, key: str, elapsed_s: float) -> None:
        with self._lock:
            prev = self._ewma.pop(key, None)
            if prev is None:
                if len(self._ewma) >= EWMA_CAP:
                    for stale in list(self._ewma)[: EWMA_CAP // 4]:
                        del self._ewma[stale]
            self._ewma[key] = (
                elapsed_s if prev is None
                else prev + EWMA_ALPHA * (elapsed_s - prev)
            )

    # -- one supervised attempt ----------------------------------------

    def run(self, key: str, thunk: Callable):
        """One attempt of ``thunk`` on a worker thread, on the caller's
        CUDA stream, joined with the key's deadline.  Success records
        the latency; a deadline miss raises :class:`WatchdogTimeout`
        (the worker stays parked, flagged cancelled); a thunk exception
        re-raises here unchanged."""
        deadline = self.deadline_for(key)
        stream = _callers_stream()
        cancel = threading.Event()
        box: dict = {}

        def work():
            _tls.cancel_event = cancel
            box["began"] = time.perf_counter()
            try:
                box["result"] = _on_stream(stream, thunk)
            except BaseException as exc:  # noqa: BLE001 — re-raised here
                box["error"] = exc
            box["ended"] = time.perf_counter()

        thread = threading.Thread(
            target=work, daemon=True, name=f"dispatch-watchdog-{key}"
        )
        began = time.monotonic()
        started = time.perf_counter()
        thread.start()
        thread.join(deadline)
        if thread.is_alive():
            cancel.set()
            raise WatchdogTimeout(
                f"{key} dispatch exceeded its {deadline:.1f}s deadline",
                on_stream=stream is not None,
            )
        joined = time.perf_counter()
        with self._lock:
            self.runs += 1
            self.thread_s += ((box["began"] - started)
                              + (joined - box["ended"]))
        if "error" in box:
            raise box["error"]
        self.observe(key, time.monotonic() - began)
        return box["result"]

    # -- the escalation ladder -----------------------------------------

    def run_attempts(self, key: str, thunk: Callable,
                     retries: Optional[int] = None):
        """The retry rung alone: bounded attempts with exponential
        backoff and jitter over :data:`LADDER_ERRORS`.  Returns the
        thunk's result or raises :class:`DispatchFailed` (``terminal``
        after a trip on a CUDA stream, with no retry on it); any other
        exception propagates at once, unretried."""
        if retries is None:
            retries = int(_env_f("MYTHRIL_TPU_DISPATCH_RETRIES", 2))
        backoff = _env_f("MYTHRIL_TPU_DISPATCH_BACKOFF_S", 0.05)
        last: Optional[BaseException] = None
        for attempt in range(retries + 1):
            if attempt:
                resilience_stats.dispatch_retries += 1
                time.sleep(
                    backoff * (2 ** (attempt - 1)) * (1 + random.random())
                )
            try:
                return self.run(key, thunk)
            except WatchdogTimeout as exc:
                resilience_stats.watchdog_trips += 1
                obs.instant("watchdog.trip", cat="resilience", key=key,
                            attempt=attempt + 1)
                obs_flight.get_flight_recorder().dump("watchdog_trip")
                last = exc
                log.warning("%s (attempt %d/%d)", exc, attempt + 1,
                            retries + 1)
                if exc.on_stream:
                    raise DispatchFailed(
                        f"{key} dispatch tripped on its CUDA stream ({exc})",
                        last=exc, terminal=True,
                    )
            except FaultInjected as exc:
                last = exc
                log.warning(
                    "%s dispatch raised (%s) (attempt %d/%d)",
                    key, exc, attempt + 1, retries + 1,
                )
        raise DispatchFailed(
            f"{key} dispatch failed after {retries + 1} attempts ({last})",
            last=last,
        )

    def give_up(self, key: str, last: Optional[BaseException],
                device=None):
        """Terminal rung: re-probe the card (``device`` a CUDA device),
        count the demotion, dump the flight ring, nudge the checkpoint
        plane, and raise :class:`DispatchAbandoned` for the caller's
        context demotion.  A re-probe that fails raises
        :class:`ops.device_health.DeviceLost` instead."""
        self._reprobe(key, last, device)
        resilience_stats.demotions += 1
        obs.instant("ladder.demotion", cat="resilience", key=key)
        obs_flight.get_flight_recorder().dump("demotion")
        from mythril_tpu_torch.resilience.checkpoint import (
            get_checkpoint_plane,
        )

        get_checkpoint_plane().note_demotion()
        raise DispatchAbandoned(f"{key} dispatch abandoned ({last})")

    def supervised(self, key: str, thunk: Callable, device=None):
        """``thunk`` under the full ladder: its result, or
        :class:`DispatchAbandoned` after every rung failed."""
        try:
            return self.run_attempts(key, thunk)
        except DispatchFailed as exc:
            self.give_up(key, exc.last, device)

    @staticmethod
    def _reprobe(key: str, last, device) -> None:
        """Ask a killable subprocess whether the card still answers;
        raises :class:`DeviceLost` when it does not.  Skipped for a CPU
        device."""
        if device is None or getattr(device, "type", device) != "cuda":
            return
        from mythril_tpu_torch.ops.device_health import (
            DeviceLost, subprocess_probe_ok,
        )

        if subprocess_probe_ok():
            log.warning("card re-probe healthy after abandoned %s "
                        "dispatch; demoting this context only", key)
            return
        raise DeviceLost(
            f"card re-probe failed after abandoned {key} dispatch ({last})"
        )


_watchdog: Optional[DispatchWatchdog] = None


def get_watchdog() -> DispatchWatchdog:
    global _watchdog
    if _watchdog is None:
        _watchdog = DispatchWatchdog()
    return _watchdog


def reset_for_tests() -> None:
    global _watchdog
    _watchdog = None
