"""Crash-safe flight recorder (own copy of
``mythril_tpu/observability/flight.py``): a bounded ring of the most
recent span/instant events, dumped when something goes wrong.

The full trace buffer answers "where did the time go" for a *healthy*
run; the flight recorder answers "what was happening just before it
broke".  It keeps the last ``MYTHRIL_TPU_FLIGHT_EVENTS`` (default 512)
events the tracer produced — independent of the trace buffer's cap and
of whether a ``--trace-out`` file was requested — and writes them as a
small Perfetto-loadable JSON file when something goes wrong: a watchdog
trip (``watchdog_trip``, ``resilience/watchdog.py``), a ladder demotion
(``demotion``), a graceful drain (``drain``,
``resilience/checkpoint.request_drain``), and an unhandled exception
(:func:`install_excepthook`, hooked by the CLI when observability is
configured), as the JAX package's does.

Dump destination: :meth:`FlightRecorder.configure` >
``MYTHRIL_TPU_FLIGHT_DIR`` > the ``--trace-out`` directory > the system
temp dir.  Dumping is best-effort and never raises; an empty ring
(tracing off) dumps nothing, so untraced runs produce zero files.
"""

import json
import logging
import os
import sys
import tempfile
import threading
from collections import deque
from typing import Optional

log = logging.getLogger(__name__)

FLIGHT_EVENTS = 512


def _ring_size() -> int:
    try:
        return max(16, int(os.environ.get("MYTHRIL_TPU_FLIGHT_EVENTS",
                                          FLIGHT_EVENTS)))
    except ValueError:
        return FLIGHT_EVENTS


class FlightRecorder:
    """Bounded event ring + dump-on-trouble."""

    def __init__(self):
        self._ring = deque(maxlen=_ring_size())
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._seq = 0
        self.dumps_written = 0
        self.last_dump_path: Optional[str] = None

    def configure(self, directory: Optional[str]) -> None:
        self._dir = directory

    def record(self, event: dict) -> None:
        """Called by the tracer for every completed span/instant;
        deque.append is atomic so this stays lock-free on the hot
        path."""
        self._ring.append(event)

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    def _resolve_dir(self) -> str:
        if self._dir:
            return self._dir
        env = os.environ.get("MYTHRIL_TPU_FLIGHT_DIR")
        if env:
            return env
        from mythril_tpu_torch.support.support_args import args

        if args.trace_out:
            return os.path.dirname(os.path.abspath(args.trace_out))
        return tempfile.gettempdir()

    def dump(self, reason: str) -> Optional[str]:
        """Write the ring as Perfetto JSON; returns the path or None
        (nothing buffered / write failed).  Never raises."""
        try:
            with self._lock:
                events = list(self._ring)
                if not events:
                    return None
                self._seq += 1
                seq = self._seq
            directory = self._resolve_dir()
            os.makedirs(directory, exist_ok=True)
            # the monotonic sequence keeps back-to-back trips from
            # colliding within one recorder; the existence bump covers
            # a fresh recorder (tests, re-exec) or a recycled pid
            # landing on a predecessor's file — a dump must never
            # silently overwrite an earlier post-mortem
            while True:
                path = os.path.join(
                    directory,
                    f"mythril-flight-{os.getpid()}-{seq:03d}-"
                    f"{reason}.json",
                )
                if not os.path.exists(path):
                    break
                with self._lock:
                    self._seq += 1
                    seq = self._seq
            payload = {
                "traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {
                    "producer": "mythril-tpu flight recorder",
                    "reason": reason,
                    "events": len(events),
                },
            }
            with open(path, "w") as fh:
                json.dump(payload, fh)
            with self._lock:
                self.dumps_written += 1
                self.last_dump_path = path
            log.warning("flight recorder: dumped %d events to %s (%s)",
                        len(events), path, reason)
            return path
        except Exception as exc:  # noqa: BLE001 — dump is best-effort
            log.debug("flight recorder dump failed: %s", exc)
            return None


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()
_excepthook_installed = False


def get_flight_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def install_excepthook() -> None:
    """Chain a sys.excepthook that dumps the flight ring before the
    previous hook runs (idempotent)."""
    global _excepthook_installed
    if _excepthook_installed:
        return
    previous = sys.excepthook

    def _hook(exc_type, exc, tb):
        if exc_type not in (KeyboardInterrupt, SystemExit):
            get_flight_recorder().dump("unhandled_exception")
        previous(exc_type, exc, tb)

    sys.excepthook = _hook
    _excepthook_installed = True


def reset_for_tests() -> None:
    global _recorder
    _recorder = None
