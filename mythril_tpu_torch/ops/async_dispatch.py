"""Asynchronous device dispatch: overlap device solving with host
exploration (own copy of ``mythril_tpu/ops/async_dispatch.py``).

When the funnel's profit gate declines a frontier (the CDCL is
projected to clear it for less than a blocking dispatch costs), the
same prepared batch is solved WITHOUT blocking, on a worker thread, and
harvested on a later funnel call once it is done.  The device then only
has to beat idle time:

- device-refuted lanes land in the UNSAT memo and as pool nogoods, so
  when the frontier presents the same (or a superset) constraint set
  again the host skips the CDCL work;
- device models that verify against the terms enter ``recent_models``,
  feeding the host probes the same way CDCL models do.

On the card the worker launches on its own non-default stream (a new
thread's current stream would be the legacy default stream, which
serializes with the host thread's work) and marks the batch done only
after that stream is synchronized; the results come back as host
arrays.  The clause pool is solved from a snapshot taken on the calling
thread (``DevicePool.append`` writes the pool in place).

A batch whose worker hit an injected fault (the fault plane's
``prefetch_error``) is dropped, as the JAX package drops a failed batch.
Any other failure is kept and raised at the next harvest, or at the end
of the analysis (:meth:`AsyncDispatcher.finish`) for a batch no harvest
reaches: a kernel build or launch failure is never hidden.  A batch in
flight past the dispatch deadline (``MYTHRIL_TPU_DISPATCH_TIMEOUT``,
default 120 s) is abandoned at harvest, which counts a watchdog trip and
a demotion of the prefetch channel, as in the JAX package; the worker is
joined, bounded, at exit (``MYTHRIL_TPU_SHUTDOWN_JOIN_S``).
"""

import logging
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from mythril_tpu_torch.observability import spans as obs

log = logging.getLogger(__name__)


class AsyncStats:
    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = 0          # batches launched without blocking
        self.harvested = 0         # batches whose results were consumed
        self.unsat = 0             # lanes refuted (memoized + nogood)
        self.models = 0            # device models verified + remembered
        self.dropped = 0           # pending batches discarded unread
        self.launch_s = 0.0        # host time spent launching (non-block)
        self.harvest_s = 0.0       # host time spent harvesting
        self.abandoned = 0         # batches past the dispatch deadline


async_stats = AsyncStats()

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def side_stream(device: torch.device):
    """The prefetch worker's stream on ``device`` (None on the CPU)."""
    if device.type != "cuda":
        return None
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    return stream


def hand_to_worker(tensor: torch.Tensor) -> None:
    """Order the side stream after the calling thread's work so far (the
    tensor was written there) and tell the allocator the side stream
    uses ``tensor``."""
    stream = side_stream(tensor.device)
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(tensor.device))
        tensor.record_stream(stream)


class AsyncDispatcher:
    """One in-flight batch at a time, tied to a blast-context
    generation.  The caller is ``ops/batched_sat.batch_check_states``:
    ``harvest`` runs at every entry (a readiness check), ``launch`` runs
    when the profit gate declines a frontier the device could still
    prefetch."""

    def __init__(self):
        self.pending = None
        # the worker of the last launch, tracked apart from pending: a
        # dropped batch must still be joinable at exit
        self._live_thread: Optional[threading.Thread] = None

    def launch(self, backend, ctx, rep_assumption_sets, rep_node_sets,
               rep_constraint_sets) -> bool:
        """Prepare (on this thread, the only part that touches the blast
        context) and hand the solve to a worker thread.  Returns True
        when a batch went in flight."""
        if self.pending is not None:
            return False
        if self._live_thread is not None and self._live_thread.is_alive():
            # a dropped batch's worker is still on the device: never run
            # two prefetches at once
            return False
        began = time.monotonic()
        with obs.span("prefetch.prepare", cat="dispatch",
                      lanes=len(rep_assumption_sets)):
            runner = backend.prepare_gather(ctx, rep_assumption_sets)
        if runner is None:
            return False
        stream = side_stream(backend.device)
        pending = {
            "generation": ctx.generation,
            "status": None,
            "assign": None,
            "done": False,
            "began": time.monotonic(),
            "assumption_sets": list(rep_assumption_sets),
            "node_sets": list(rep_node_sets),
            "constraint_sets": list(rep_constraint_sets),
        }

        def work():
            from mythril_tpu_torch.resilience import faults

            try:
                faults.maybe_fault_prefetch()
                # on the worker thread's own span stack
                with obs.span("prefetch.solve", cat="dispatch",
                              lanes=len(rep_assumption_sets)):
                    if stream is None:
                        handle = runner()
                    else:
                        with torch.cuda.stream(stream):
                            handle = runner()
                            stream.synchronize()
                status = handle["status"].cpu().numpy()
                assign = handle["assign"].cpu().numpy()
                if "cone_vars" in handle:
                    # cone-tier runner: the compact assignment back to
                    # the full var space, so harvest decodes it unchanged
                    cone_vars = handle["cone_vars"]
                    full = np.zeros((assign.shape[0], handle["full_width"]),
                                    np.int8)
                    full[:, cone_vars] = assign[:, 1:cone_vars.size + 1]
                    assign = full
                pending["status"] = status
                pending["assign"] = assign
            except faults.FaultInjected as exc:
                log.debug("async prefetch dropped: %s", exc)
                pending["failed"] = True
            except Exception as exc:  # noqa: BLE001 — raised at harvest
                pending["error"] = exc
            pending["done"] = True

        thread = threading.Thread(target=work, daemon=True,
                                  name="mythril-prefetch")
        thread.start()
        self._live_thread = thread
        _register_shutdown_join()
        self.pending = pending
        async_stats.launches += 1
        async_stats.launch_s += time.monotonic() - began
        return True

    def harvest(self, ctx) -> None:
        """Consume a finished batch, if any.  Never blocks: a batch still
        in flight stays pending; a batch from a dead context is dropped;
        a batch whose worker failed raises its exception here."""
        if self.pending is None:
            return
        self._raise_failure()
        if self.pending["generation"] != ctx.generation or (
                self.pending.get("failed")):
            self.pending = None
            async_stats.dropped += 1
            return
        if not self.pending["done"]:
            if time.monotonic() - self.pending["began"] > _deadline():
                # the prefetch watchdog: the worker stays parked (it
                # blocks later launches through _live_thread: the
                # prefetch channel goes dark, the synchronous tiers are
                # untouched) and its lanes are never memoized
                from mythril_tpu_torch.resilience.telemetry import (
                    resilience_stats,
                )

                resilience_stats.watchdog_trips += 1
                resilience_stats.demotions += 1
                log.warning(
                    "async prefetch exceeded the %.0fs dispatch deadline; "
                    "abandoning the batch (prefetch channel demoted)",
                    _deadline())
                self.pending = None
                async_stats.dropped += 1
                async_stats.abandoned += 1
            return
        began = time.monotonic()
        pending, self.pending = self.pending, None
        from mythril_tpu_torch.ops.batched_sat import (
            _env_from_assignment, _holds,
        )

        status, assign = pending["status"], pending["assign"]
        obs.instant("prefetch.harvest", cat="dispatch",
                    lanes=len(pending["node_sets"]))
        from mythril_tpu_torch.support.support_args import args

        proof_log = args.proof_log
        for lane, node_set in enumerate(pending["node_sets"]):
            if status[lane] == 2:
                if proof_log and not ctx.confirm_unsat(
                        pending["assumption_sets"][lane],
                        conflict_budget=1000):
                    # later queries consume the memo without a fresh
                    # solve, so a refutation needs its certificate
                    # first; an unconfirmed prefetched lane is dropped,
                    # never decided
                    continue
                # sound UNSAT: permanent memo + pool nogood, so the CDCL
                # and later dispatches inherit the refutation
                ctx.note_unsat(node_set)
                ctx.learn_nogood(pending["assumption_sets"][lane],
                                 certified=proof_log)
                async_stats.unsat += 1
            elif status[lane] == 1:
                env = _env_from_assignment(ctx, assign[lane])
                if _holds(pending["constraint_sets"][lane], env):
                    # tagged with the device truth row so harvested
                    # models seed later dispatches' warm starts too
                    ctx._remember_model(env, truth=assign[lane])
                    async_stats.models += 1
        async_stats.harvested += 1
        async_stats.harvest_s += time.monotonic() - began

    def _raise_failure(self) -> None:
        """Raise the stored failure of a finished worker, dropping its
        batch."""
        if self.pending is not None and self.pending["done"] and (
            "error" in self.pending
        ):
            exc = self.pending.pop("error")
            self.pending = None
            raise RuntimeError(f"async prefetch failed: {exc}") from exc

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the live worker (tests and the chip check make the
        harvest deterministic this way)."""
        thread = self._live_thread
        if thread is not None:
            thread.join(timeout)

    def finish(self) -> None:
        """The end of an analysis: wait for the live worker (at most the
        dispatch deadline; past it the batch is abandoned) and raise its
        failure, which no later harvest would see."""
        thread = self._live_thread
        if thread is not None and thread.is_alive():
            thread.join(_deadline())
            if thread.is_alive() and self.pending is not None:
                log.warning("async prefetch still running at the end of "
                            "the analysis; abandoning the batch")
                self.pending = None
                async_stats.dropped += 1
                async_stats.abandoned += 1
        self._raise_failure()


def _deadline() -> float:
    return float(os.environ.get("MYTHRIL_TPU_DISPATCH_TIMEOUT", "120"))


_shutdown_join_registered = False


def join_pending_at_exit() -> None:
    """Join the in-flight worker with a bounded deadline
    (``MYTHRIL_TPU_SHUTDOWN_JOIN_S``, default 10 s); an abandoned
    dispatch is logged by name."""
    dispatcher = _dispatcher
    if dispatcher is None:
        return
    thread = dispatcher._live_thread
    if thread is None or not thread.is_alive():
        return
    try:
        deadline = float(os.environ.get("MYTHRIL_TPU_SHUTDOWN_JOIN_S", "10"))
    except ValueError:
        deadline = 10.0
    thread.join(timeout=deadline)
    if thread.is_alive():
        log.warning("abandoning in-flight async dispatch %r at exit (did "
                    "not finish within %.1fs)", thread.name, deadline)


def _register_shutdown_join() -> None:
    """Join the in-flight worker at exit, bounded: interpreter teardown
    kills daemon threads at arbitrary points, also inside a launch."""
    global _shutdown_join_registered
    if _shutdown_join_registered:
        return
    _shutdown_join_registered = True
    import atexit

    atexit.register(join_pending_at_exit)


_dispatcher: Optional[AsyncDispatcher] = None


def get_async_dispatcher() -> AsyncDispatcher:
    global _dispatcher
    if _dispatcher is None:
        _dispatcher = AsyncDispatcher()
    return _dispatcher


def reset_async_dispatch() -> None:
    """A new analysis in this process: wait for the live worker (so no
    prefetch of the last analysis is still on the device), forget its
    batch, and zero the statistics."""
    if _dispatcher is not None:
        _dispatcher.join()
        _dispatcher.pending = None
    async_stats.reset()
