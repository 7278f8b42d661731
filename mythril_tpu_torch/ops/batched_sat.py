"""Frontier feasibility funnel and solver tiers of the PyTorch port
(counterpart of ``mythril_tpu/ops/batched_sat.py``, trimmed to this
slice).

:func:`batch_check_states` takes a frontier of term-level path
constraint sets and returns one verdict per set.  It is the JAX funnel
under the slice's configuration:

0. harvest: a finished async prefetch (``ops/async_dispatch.py``)
   lands its UNSAT memos, nogoods and models first;
1. structural fold: constraints that folded to literal False; then the
   autopilot (``autopilot/``) extracts each open lane's features and
   routes it from its ledger-fed cost model: past the word tier
   (``skip_word``) or straight to the CDCL tail (``skip_device``);
2. the probe phase, lane by lane: the context's permanent UNSAT memo,
   the verdicts the per-query funnel (``support/model.py``) has cached,
   and (``word_probing``) the host word-level probe against recent
   models (``BlastContext.probe_with_memo``), whose hits are verified
   SAT verdicts;
3. the word tier (``smt/word_tier.py``) over the lanes still open:
   interval-UNSAT and constant-fold lanes retire before any CNF exists,
   and the others keep their per-variable known bits, which join their
   assumption sets as unit literals;
4. the solver tiers (:class:`BatchedSatBackend`) over the deduped open
   lanes, on the card unless the caller passes ``device="cpu"``, behind
   the JAX funnel's dispatch rungs: the profit gate (a frontier the
   CDCL is projected to clear for less than ``device_min_save_s`` is
   left to it, and launched as an async prefetch instead), the adaptive
   fuse and the coalescer (``ops/coalesce.py``: an underfilled batch
   waits in its queue, and queued lanes ride along with a later one):

   - the dense tier (``ops/dense_prop.py``), which delegates every
     frontier whose union cone fits the cone caps while the resident
     solver is on;
   - the full-pool gather tier (pools up to :data:`MAX_GATHER_VARS` /
     :data:`MAX_GATHER_CLAUSES`) and the union-cone tier
     (:meth:`BatchedSatBackend.check_cone_gather`), both solving on the
     frontier solvers: the resident solver (``ops/resident.py``) or,
     with ``MYTHRIL_TPU_RESIDENT_KERNEL=0``, the multi-dispatch frontier
     ladder (``ops/frontier.py``); with ``MYTHRIL_TPU_FRONTIER=0``, the
     round-lane ladder (``ops/round_lane.py``);

   then host verification of every SAT candidate against the terms
   (device UNSAT verdicts become assumption nogoods in the pool);
5. the native CDCL tail for everything still undecided (or None for
   the caller's own tail, ``tail=False``).

Every lane gets a lane-ledger record (``observability/ledger.py``): its
tier transitions, the tier that decided it (the device tiers count as
``frontier``, or ``sweep`` under ``MYTHRIL_TPU_FRONTIER=0``, as in the
JAX package), per-tier walls, sweeps and learned clauses; whatever the
funnel leaves open settles as ``tail`` when the batch closes, before the
tail runs.  The tiers' walls are spans (``observability/spans.py``)
with sinks in :data:`dispatch_stats` and ``record_function`` ranges of
the same names.

Every device dispatch of the tiers runs under the resilience plane's
watchdog (``resilience/watchdog.py``): the dense tier as one ``pallas``
dispatch, the resident solver as one ``resident:{bucket}`` dispatch, and
each round of the multi-dispatch ladders as ``frontier:{budget}``,
``gather:{budget}`` or ``cone:{budget}``.  An injected fault or a
tripped deadline is retried (a deadline tripped on the card's CUDA
stream is not: the ladder gives up at once, see ``watchdog.py``); a round that keeps failing is bisected over
lane buckets and the lanes that fail alone are quarantined to the CDCL
tail (the ledger's ``quarantined`` transitions); when every lane fails
alone, the re-probe of the card decides between demoting the context to
the CDCL (:meth:`BatchedSatBackend._abandon`) and
``ops/device_health.DeviceLost``.  A drain request stops the ladders at
their next round boundary.  Any other failure (a kernel's build or
launch, the word tier's kernel, the prefetch's worker) reaches the
caller unchanged.  Left out: the sharded mesh.
"""

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mythril_tpu_torch.observability import spans as obs
from mythril_tpu_torch.ops import round_lane as RL

log = logging.getLogger(__name__)

#: clause rows of the gather tiers are at most this wide (wider clauses
#: stay with the CDCL: BCP is weaker, verdicts stay sound)
MAX_CLAUSE_WIDTH = 8
#: the frontier ladder's sweep budget and decision-stack depth
GATHER_STEPS = 768
GATHER_DECISIONS = 256
#: per-round sweep budgets of the ladder (the last repeats until
#: GATHER_STEPS is covered)
GATHER_ROUND_BUDGETS = (64, 256, 512)
#: the full-pool gather tier takes pools up to these sizes ...
MAX_GATHER_CLAUSES = 8192
MAX_GATHER_VARS = 8192
#: ... and the union-cone tier union cones up to these
MAX_CONE_GATHER_CLAUSES = 16384
MAX_CONE_GATHER_VARS = 8192
#: absorbed CDCL learnts exempt from the gather tier's clause cap
MAX_LEARNT_EXEMPTION = 8192
#: the adaptive dispatch fuse of the JAX package (batched_sat.py:63-68)
FUTILE_DISPATCH_FUSE = 3
SLOW_DISPATCH_FUSE_S = 10.0
FUSE_RETRY_PERIOD = 8
MAX_FUSE_RETRIES = 3


def effective_min_lanes() -> int:
    """Structural lane floor of the funnel (same rule as the JAX
    package): the default knob relaxes to 4, an operator who raises
    ``device_min_lanes`` above 8 is honored verbatim."""
    from mythril_tpu_torch.support.support_args import args

    knob = getattr(args, "device_min_lanes", 8)
    if knob > 8:
        return knob
    return max(2, min(knob, 4))


class DispatchStats:
    """Device-dispatch telemetry of the funnel and the solver tiers."""

    def __init__(self):
        self._reset_own()

    def reset(self):
        """Zero the counters, the resilience and fleet counters and the
        coalescer's admission window with them (per-contract, as the JAX
        package resets them)."""
        from mythril_tpu_torch.ops.coalesce import reset_coalescer
        from mythril_tpu_torch.parallel.fleet import fleet_stats
        from mythril_tpu_torch.resilience.telemetry import resilience_stats

        self._reset_own()
        resilience_stats.reset()
        reset_coalescer()
        fleet_stats.reset()

    def as_dict(self):
        """The fields with the resilience counters and the fleet's
        (``fleet_<field>``) merged in, as the JAX package's
        ``DispatchStats.as_dict``."""
        from mythril_tpu_torch.parallel.fleet import fleet_stats
        from mythril_tpu_torch.resilience.telemetry import resilience_stats

        d = dict(self.__dict__)
        d.update(resilience_stats.as_dict())
        d.update({f"fleet_{key}": value
                  for key, value in fleet_stats.as_dict().items()})
        return d

    def _reset_own(self):
        self.dispatches = 0        # dispatches that engaged a device tier
        self.lanes = 0             # lanes sent to the device
        self.unsat = 0             # lanes decided UNSAT on the device
        self.sat_verified = 0      # lanes whose device model verified
        self.undecided = 0         # device lanes handed to the CDCL tail
        self.tail_sat = 0          # CDCL-tail verdicts
        self.tail_unsat = 0
        self.device_sweeps = 0     # full sweeps run (dense: DPLL steps)
        self.lane_sweeps_active = 0
        self.lane_sweeps_total = 0
        self.rounds = 0            # budgeted solve rounds executed
        self.fused = False         # the adaptive fuse is blown (or the
        #                            ladder demoted the context)
        self.repacks = 0           # survivor re-packs into smaller buckets
        self.lane_slots_filled = 0
        self.lane_slots_total = 0
        self.device_s = 0.0        # wall-clock inside the solver tiers
        self.tail_s = 0.0          # wall-clock inside the CDCL tail
        # wall-clock by tier (span sinks): the dense tier (cone walk,
        # rows, rounds) and the gather and cone tiers after it (pool
        # syncs, cone builds, their solves), which split device_s; of
        # the first its round ladders, of the second the resident
        # solves; and the funnel's word rung
        self.dense_s = 0.0
        self.dense_rounds_s = 0.0
        self.gather_s = 0.0
        self.resident_s = 0.0
        self.word_s = 0.0
        self.h2d_bytes = 0         # coordinates, rows, planes shipped
        self.device_dispatch_calls = 0
        self.warm_start_hits = 0
        self.cone_memo_hits = 0
        # persistent knowledge plane (persist/plane.py): analyses that
        # warm-started from a stored channel snapshot vs ones the store
        # had never seen (per-contract mirrors of the plane's counters)
        self.persist_warm_hits = 0
        self.persist_warm_misses = 0
        self.dense_declines = 0    # dispatches no dense layout could fit
        # of them, by the caps each layout passed ("union C+cells;
        # per-lane cells")
        self.dense_decline_caps = {}
        # frontier solvers (ops/frontier.py, ops/resident.py): gather
        # steps beside the full sweeps, first-UIP clauses the pool
        # accepted, full pool uploads vs delta appends, and dispatches
        # no gather tier took (pool too large; union cone too large)
        self.frontier_steps = 0
        self.learned_clauses = 0
        self.pool_uploads = 0
        self.delta_uploads = 0
        self.size_bailouts = 0
        self.cone_bailouts = 0
        # the dense tier's rounds by step budget, and the steps of those
        # rounds that swept only the hot clause prefix
        self.dense_round_budgets = {}
        self.hot_view_steps = 0
        # resident solves, their exits, and the dense dispatches that
        # delegated their frontier to it
        self.resident_dispatches = 0
        self.resident_exit_all_decided = 0
        self.resident_exit_budget = 0
        self.resident_exit_watchdog = 0
        self.resident_delegations = 0
        # dispatch rungs: frontiers the profit gate left to the CDCL,
        # dispatches that carried queued lanes and those lanes, and lanes
        # the coalescer deferred into its queue
        self.profit_skips = 0
        self.coalesced_dispatches = 0
        self.coalesced_lanes = 0
        self.coalesce_deferred = 0
        # the probe phase and the word tier (smt/word_tier.py): lanes the
        # host word-level probe decided SAT, lanes the word tier decided
        # UNSAT / SAT without CNF, variable bits it pinned (each a unit
        # assumption literal), and wall-clock inside its propagation
        self.host_probe_sat = 0
        self.word_decided_unsat = 0
        self.word_decided_sat = 0
        self.word_tightened_bits = 0
        self.word_prop_s = 0.0
        # word-tier decides of DEVICE_MIN_LANES or more on the card whose
        # program does not fit a block of the word kernel (run scalar)
        self.word_too_large_scalar = 0
        # states seeded at function entries by the dispatcher pre-split
        # (laser/ethereum/lockstep_dispatch.py)
        self.presplit_states = 0
        # symbolic lockstep tier (laser/ethereum/symbolic_lockstep.py):
        # interpreter (state, opcode) steps executed inside batched
        # segments and the wall-clock of those segments; known bits over
        # total bits across every shadowed stack push; lanes handed back
        # to the serial interpreter at a segment boundary, keyed by the
        # opcode that parked them ("cap" = op budget, "end-of-code" = fell
        # off the bytecode); lane-ops through the memory and storage
        # planes, and SHA3 results hashed by ops/keccak.py
        self.states_stepped = 0
        self.segment_s = 0.0
        self.plane_known_bits = 0
        self.plane_total_bits = 0
        self.needs_host_boundaries = 0
        self.boundary_causes = {}
        self.mem_plane_ops = 0
        self.storage_plane_ops = 0
        self.keccak_device_hashes = 0
        # veritesting tier (laser/ethereum/veritest.py): re-converged
        # sibling pairs collapsed to one lane (merges / merged_lanes),
        # If terms those joins minted (merge_ites, bounded per join by
        # MYTHRIL_TPU_MERGE_MAX_ITES), joins declined or degraded to
        # plain forking (merge_aborts), the frontier-subsumption sweeps
        # and the lanes they retired without reaching a solver, and the
        # wall-clock of the merge and subsumption passes
        self.merges = 0
        self.merged_lanes = 0
        self.merge_ites = 0
        self.merge_aborts = 0
        self.subsume_sweeps = 0
        self.subsumed_lanes = 0
        self.merge_span_s = 0.0
        # per-lane tier that decided each lane of the last
        # batch_check_states call: "structural", "memo", "word", "device",
        # "probe" (a host probe hit, or a zero assignment that verified
        # after no tier took the frontier), "tail" or None (left open,
        # or the tail answered UNKNOWN)
        self.last_tiers: List[Optional[str]] = []


dispatch_stats = DispatchStats()


def tier_span(tier: str, name: str):
    """The span ``name`` around a solver tier: its wall-clock adds to
    ``dispatch_stats.<tier>_s``, inside a ``record_function`` range of
    the same name."""
    return obs.span(name, sink=(dispatch_stats, f"{tier}_s"), cat="tier",
                    profile=True)


class DispatchFuse:
    """The JAX funnel's adaptive fuse (``batched_sat.py:2186-2212``,
    ``:2382-2432``): after :data:`FUTILE_DISPATCH_FUSE` consecutive
    dispatches that decide no lane (or one zero-decision dispatch slower
    than :data:`SLOW_DISPATCH_FUSE_S`), a context stops dispatching and
    sends its frontiers to the tail; every :data:`FUSE_RETRY_PERIOD`-th
    eligible frontier retries, at most :data:`MAX_FUSE_RETRIES` times,
    and a retry that decides a lane re-arms it.  Kept because it
    decides which lanes reach the CDCL, and so the CDCL's models."""

    def __init__(self):
        self.arm(-1)

    def arm(self, generation: int):
        self.generation = generation
        self.futile = 0
        self.fused_generation = -1
        self.skips = 0
        self.retries = 0
        self.was_slow = False
        self.retrying = False
        dispatch_stats.fused = False

    def demote(self, ctx):
        """The ladder gave up on a dispatch of this context: fuse it for
        good (a slow fuse takes no retries; each could wedge again)."""
        if self.generation != ctx.generation:
            self.arm(ctx.generation)
        self.fused_generation = ctx.generation
        self.was_slow = True
        dispatch_stats.fused = True

    def admit(self, ctx) -> bool:
        """Whether this frontier may dispatch."""
        if self.generation != ctx.generation:
            self.arm(ctx.generation)
        self.retrying = False
        if self.fused_generation != ctx.generation:
            return True
        self.skips += 1
        if (self.was_slow or self.retries >= MAX_FUSE_RETRIES
                or self.skips % FUSE_RETRY_PERIOD != 0):
            return False
        self.retries += 1
        self.retrying = True
        return True

    def refund(self):
        """A retry that reached no device tier was no retry."""
        if self.retrying:
            self.retries -= 1

    def settle(self, ctx, decided: int, elapsed_s: float,
               prefetch_inflight: bool = False):
        """Account one engaged dispatch that decided ``decided`` lanes.
        A prefetch in flight shares the device, so its queue time does
        not make a dispatch slow."""
        if decided:
            self.futile = 0
            if self.fused_generation == ctx.generation:
                self.fused_generation = -1
                self.skips = 0
                self.retries = 0
                dispatch_stats.fused = False
            return
        self.futile += 1
        if elapsed_s > SLOW_DISPATCH_FUSE_S and not prefetch_inflight:
            self.futile = FUTILE_DISPATCH_FUSE
            self.was_slow = True
        if self.futile >= FUTILE_DISPATCH_FUSE:
            self.fused_generation = ctx.generation
            dispatch_stats.fused = True


dispatch_fuse = DispatchFuse()


def warm_pref_row(ctx, width: int, cone_vars=None, offset: int = 1,
                  lanes: int = 0, dtype=np.int8):
    """Warm-start decision-phase row for one dispatch, or None: the
    newest tagged SAT model's phases (BlastContext.warm_phase_vector),
    remapped onto compact cone columns (``cone_vars[i] -> column
    i + offset``; None = the identity layout of the full-pool tier).
    Counts ``lanes`` into ``warm_start_hits`` when a usable row exists.
    Honors ``MYTHRIL_TPU_WARM_START``."""
    from mythril_tpu_torch.ops.incremental import warm_start_enabled

    if not warm_start_enabled():
        return None
    warm = ctx.warm_phase_vector(ctx.solver.num_vars)
    if warm is None:
        return None
    row = np.zeros(width, dtype)
    if cone_vars is None:
        n = min(width, len(warm))
        row[:n] = warm[:n]
    else:
        cv = np.asarray(cone_vars, np.int64)
        vals = np.zeros(len(cv), np.int8)
        valid = cv < len(warm)
        vals[valid] = warm[cv[valid]]
        limit = max(0, min(len(cv), width - offset))
        row[offset:offset + limit] = vals[:limit]
    if not np.any(row):
        return None
    dispatch_stats.warm_start_hits += lanes
    return row


def lane_bucket(n: int, floor: int = 4) -> int:
    """Power-of-two lane-bucket width of the frontier solvers."""
    size = floor
    while size < n:
        size *= 2
    return size


class DevicePool:
    """The clause pool as ``[C, K]`` int32 rows on one device (signed
    literals, 0 = pad), refreshed when the pool outgrows its buckets and
    otherwise extended in place by the delta rows."""

    def __init__(self, device):
        self.device = device
        self.version = -1
        self.lits: Optional[torch.Tensor] = None
        self.lits_np: Optional[np.ndarray] = None
        self.num_vars = 0
        self.num_clauses = 0
        self.consumed = 0       # pool clauses reflected on the device
        self.filled = 0         # non-pad rows in the bucket
        self.used = np.zeros(1, dtype=bool)
        # literal->row adjacency of the frontier solvers (host + device),
        # invalidated with the rows it indexes
        self._adj_np = None
        self._adj_dev = None

    @staticmethod
    def _bucket(n: int) -> int:
        """Power of two (floor 256), so shapes stay stable as the pool
        grows."""
        size = 256
        while size < n:
            size *= 2
        return size

    def refresh(self, ctx, num_vars: int):
        """Full rebuild from the native pool (one bulk padded-row fetch)."""
        total = ctx.pool.num_clauses
        rows, _dropped = ctx.pool.padded_rows(0, total, MAX_CLAUSE_WIDTH)
        real_rows = max(1, len(rows))  # keep one inert all-zero row
        target_c = self._bucket(real_rows)
        mat = np.zeros((target_c, MAX_CLAUSE_WIDTH), dtype=np.int32)
        if len(rows):
            mat[: len(rows)] = rows
        self.lits_np = mat
        with obs.span("upload.pool", cat="h2d", bytes=int(mat.nbytes),
                      rows=real_rows):
            self.lits = torch.from_numpy(mat).to(self.device)
        obs.counter("pool.rows", resident=real_rows, bucket=target_c)
        dispatch_stats.pool_uploads += 1
        dispatch_stats.h2d_bytes += int(mat.nbytes)
        self._adj_np = None
        self._adj_dev = None
        self.num_vars = self._bucket(num_vars)
        self.num_clauses = target_c
        self.consumed = total
        self.filled = real_rows
        # vars in no retained row (bucket padding, vars defined only by
        # wide clauses) are preassigned so the search never decides them
        self.used = np.zeros(self.num_vars + 1, dtype=bool)
        occurring = np.abs(self.lits_np[:real_rows]).ravel()
        self.used[occurring[occurring <= self.num_vars]] = True

    def append(self, ctx, num_vars: int) -> bool:
        """Write the pool delta since ``consumed`` over pad rows, on the
        host and on the device (an ``index_copy_`` of the delta rows),
        when it fits the existing buckets; False asks for a refresh."""
        if self.lits is None or self._bucket(num_vars) > self.num_vars:
            return False
        total = ctx.pool.num_clauses
        rows, _dropped = ctx.pool.padded_rows(
            self.consumed, total, MAX_CLAUSE_WIDTH
        )
        if self.filled + len(rows) > self.num_clauses:
            return False
        if len(rows):
            at = np.arange(self.filled, self.filled + len(rows))
            self.lits_np[at] = rows
            with obs.span("upload.delta", cat="h2d",
                          bytes=int(rows.nbytes), rows=len(rows)):
                self.lits.index_copy_(
                    0, torch.from_numpy(at).to(self.device),
                    torch.from_numpy(rows).to(self.device),
                )
            self.filled += len(rows)
            obs.counter("pool.rows", resident=self.filled,
                        bucket=self.num_clauses)
            occurring = np.abs(rows).ravel()
            self.used[occurring[occurring <= self.num_vars]] = True
            dispatch_stats.delta_uploads += 1
            dispatch_stats.h2d_bytes += int(rows.nbytes)
            self._adj_np = None
            self._adj_dev = None
        self.consumed = total
        return True

    def adjacency_dev(self) -> torch.Tensor:
        """Device copy of the adjacency over the resident rows, built at
        most once per refresh or append."""
        if self._adj_dev is not None:
            return self._adj_dev
        from mythril_tpu_torch.ops.frontier import build_adjacency

        if self._adj_np is None:
            self._adj_np = build_adjacency(
                self.lits_np[: self.filled], self.num_vars + 1
            )
        with obs.span("upload.adjacency", cat="h2d",
                      bytes=int(self._adj_np.nbytes)):
            self._adj_dev = torch.from_numpy(self._adj_np).to(self.device)
        dispatch_stats.h2d_bytes += int(self._adj_np.nbytes)
        return self._adj_dev


class BatchedSatBackend:
    """The solver tiers behind the funnel on one device (counterpart of
    the JAX package's ``BatchedSatBackend``, single device, happy path
    of its dispatch supervision)."""

    def __init__(self, device=None):
        from mythril_tpu_torch.ops import default_device

        self.device = default_device(device)
        self.pool = DevicePool(self.device)
        self.pool_generation = -1  # BlastContext.generation of the pool
        # True iff the last check_assumption_sets ran a device tier
        self.device_engaged = False
        self.last_assignments: Optional[np.ndarray] = None

    def check_assumption_sets(self, ctx, assumption_sets: List[List[int]]
                              ) -> List[Optional[bool]]:
        """Per assumption set: False (sound UNSAT) or None (the host
        verifies ``last_assignments[lane]``, else the CDCL decides).
        Routes dense tier -> full-pool gather tier -> union-cone tier
        (``batched_sat.py:799-944`` of the JAX package)."""
        from mythril_tpu_torch.ops.dense_prop import get_dense_backend
        from mythril_tpu_torch.resilience.watchdog import (
            DispatchAbandoned, get_watchdog,
        )

        self.device_engaged = False
        dense_backend = get_dense_backend(self.device)
        if dense_backend.available_for(ctx):
            # the whole dense tier is one supervised dispatch: its round
            # ladder checks raise_if_cancelled() before touching the
            # context again, so an abandoned worker never races the host
            load_kernels(self.device, "dense")
            try:
                with tier_span("dense", "tier.dense"):
                    dense = get_watchdog().supervised(
                        "pallas",
                        lambda: dense_backend.check_assumption_sets(
                            ctx, assumption_sets),
                        device=self.device,
                    )
            except DispatchAbandoned as exc:
                return self._abandon(ctx, exc, len(assumption_sets))
            if dense is not None:
                results, assignments = dense
                self.last_assignments = assignments
                self.device_engaged = True
                return results
        with tier_span("gather", "tier.gather"):
            return self._gather_tiers(ctx, assumption_sets)

    def _gather_tiers(self, ctx, assumption_sets: List[List[int]]
                      ) -> List[Optional[bool]]:
        """The full-pool gather tier, or past its caps the union-cone
        tier (:meth:`check_assumption_sets` after the dense tier)."""
        verdict, num_vars = self._gather_eligibility(ctx)
        if verdict is not None:
            # the pool is too big, but the batch's union cone may still
            # fit the cone tier
            cone_result = self.check_cone_gather(ctx, assumption_sets)
            if cone_result is not None:
                return cone_result
            dispatch_stats.cone_bailouts += 1
            dispatch_stats.size_bailouts += 1
            self.last_assignments = np.zeros(
                (len(assumption_sets), num_vars + 1), np.int8
            )
            return [None] * len(assumption_sets)

        from mythril_tpu_torch.ops.frontier import frontier_enabled
        from mythril_tpu_torch.resilience import faults
        from mythril_tpu_torch.resilience.watchdog import DispatchAbandoned

        assign = self._sync_pool_and_assign(ctx, assumption_sets, num_vars)
        batch = len(assumption_sets)
        self.device_engaged = True
        # column space is the pool's own variable space: learned clauses
        # harvest with no remap; MYTHRIL_TPU_FRONTIER=0 runs round lanes
        frontier = None
        if frontier_enabled():
            frontier = {"adj": self.pool.adjacency_dev(), "ctx": ctx,
                        "col_to_var": None}
        try:
            status, final_assign = self._solve_gather_ladder(
                "gather", self.pool.lits, assign,
                pref=warm_pref_row(ctx, assign.shape[1], lanes=batch),
                frontier=frontier,
            )
        except DispatchAbandoned as exc:
            return self._abandon(ctx, exc, batch)
        status, final_assign = faults.maybe_corrupt_lanes(status,
                                                          final_assign)
        self.last_assignments = final_assign
        return [False if status[lane] == 2 else None
                for lane in range(batch)]

    def _harvest_round_learnts(self, state, live, frontier) -> None:
        """Feed the round's first-UIP clauses to the blast context's
        nogood channel: they reach the CDCL at once and the device pool
        as delta rows on the next dispatch."""
        from mythril_tpu_torch.ops.frontier import harvest_learned

        counts = state["nlearn"][: live.size]
        if not counts.any():
            return
        rows = []
        for lane in np.nonzero(counts)[0]:
            rows.extend(state["learned"][lane, : int(counts[lane])])
        dispatch_stats.learned_clauses += harvest_learned(
            frontier["ctx"], rows, frontier.get("col_to_var")
        )

    def _abandon(self, ctx, exc, batch: int):
        """Terminal rung of the ladder, context scope: the watchdog gave
        up on this dispatch and the card still answers, so this context
        goes to the native CDCL tail for good (the adaptive fuse, blown
        with no retries).  Every in-flight lane returns undecided and the
        tail re-solves it: findings are unchanged, only the card's
        speed-up is lost."""
        self.device_engaged = False
        dispatch_fuse.demote(ctx)
        log.warning("%s; context demoted to the native CDCL tail "
                    "(results unchanged, device speed-up lost)", exc)
        self.last_assignments = np.zeros(
            (batch, ctx.solver.num_vars + 1), np.int8)
        return [None] * batch

    def _dispatch_round(self, key: str, step_fn, state: dict, order,
                        live: np.ndarray, frontier: bool = False):
        """One supervised ladder round over ``state`` (bucket-sized host
        arrays, rows below ``live.size`` live) with poisoned-lane
        bisection (the JAX package's ``_dispatch_round``).

        The happy path is the retry rung.  When it is exhausted, the live
        lanes are bisected: each half re-dispatches once (in the
        smallest lane bucket, pads inert at status 3), failing halves
        split again, and a lane that fails alone is quarantined
        (returned for the caller to retire to the CDCL tail).  When every
        lane fails alone the failure is no lane's, and the ladder gives
        up (re-probe, then :class:`DispatchAbandoned` or ``DeviceLost``).
        A trip on the card's stream gives up at once, unbisected: every
        sub-dispatch would queue behind the stuck launch.
        Returns (state', quarantined local positions)."""
        from mythril_tpu_torch.resilience import faults
        from mythril_tpu_torch.resilience.telemetry import resilience_stats
        from mythril_tpu_torch.resilience.watchdog import (
            DispatchFailed, get_watchdog,
        )

        dog = get_watchdog()

        def attempt(sub_state, sub_ids, retries=None):
            def _thunk():
                faults.maybe_fault_dispatch(lane_ids=sub_ids)
                if frontier:
                    faults.maybe_fault_frontier()
                dispatch_stats.device_dispatch_calls += 1
                out = step_fn(sub_state)
                # host copies: the ladder writes the state between rounds
                return {k: np.array(out[k]) for k in order}

            return dog.run_attempts(key, _thunk, retries=retries)

        batch_ids = [int(i) for i in live]
        try:
            return attempt(state, batch_ids), []
        except DispatchFailed as exc:
            last = exc.last
            if exc.terminal:
                dog.give_up(key, last, device=self.device)
        n = int(live.size)
        if n == 1:
            # one lane cannot be bisected: lane poison and a failing
            # device look alike
            dog.give_up(key, last, device=self.device)
        quarantined: List[int] = []

        def bisect(positions):
            resilience_stats.bisect_dispatches += 1
            B_sub = lane_bucket(len(positions))
            idx = np.concatenate(
                [positions, np.repeat(positions[:1], B_sub - len(positions))]
            )
            sub = {k: np.ascontiguousarray(state[k][idx]) for k in order}
            sub["status"][len(positions):] = 3  # pads stay inert
            try:
                out = attempt(sub, [int(live[p]) for p in positions],
                              retries=0)
            except DispatchFailed as exc:
                if exc.terminal:
                    raise
                if len(positions) == 1:
                    quarantined.append(int(positions[0]))
                    return
                half = len(positions) // 2
                bisect(positions[:half])
                bisect(positions[half:])
                return
            for j, p in enumerate(positions):
                for k in order:
                    state[k][p] = out[k][j]

        half = n // 2
        try:
            bisect(np.arange(half))
            bisect(np.arange(half, n))
        except DispatchFailed as exc:  # a trip on the card's stream
            dog.give_up(key, exc.last, device=self.device)
        if len(quarantined) == n:
            dog.give_up(key, last, device=self.device)
        resilience_stats.quarantined_lanes += len(quarantined)
        log.warning("poisoned-lane bisection on %s: quarantined %d/%d "
                    "lanes to the CDCL tail; context stays on the card",
                    key, len(quarantined), n)
        return state, quarantined

    @staticmethod
    def _pref_row(pref, V1: int):
        if pref is None:
            return None
        row = np.zeros(V1, np.int8)
        n = min(V1, len(pref))
        row[:n] = np.asarray(pref[:n], np.int8)
        return row

    def _account_sweeps(self, state, n_live: int, B: int) -> None:
        """Full sweeps count once per round (the slowest lane's), gather
        steps per lane; a round-lane state counts every step a sweep."""
        full_live = state["fullsw" if "fullsw" in state else "step"][:n_live]
        steps_used = int(full_live.max()) if n_live else 0
        dispatch_stats.device_sweeps += steps_used
        dispatch_stats.lane_sweeps_total += steps_used * B
        dispatch_stats.lane_sweeps_active += int(full_live.sum())
        if "fsteps" in state:
            dispatch_stats.frontier_steps += int(
                state["fsteps"][:n_live].sum())

    def _solve_resident(self, lits, assign, pref=None, frontier=None):
        """One resident dispatch (ops/resident.py) over the
        assumption-seeded ``assign [batch, V1]``, supervised under the
        ``resident:{bucket}`` key through :meth:`_dispatch_round` (only
        the per-lane fields ride a bisection; the shared learned-row
        pool and counters start empty on every attempt, always a sound
        start).  A drain requested before the launch returns every lane
        undecided.  Returns (status[batch] with bails mapped to
        undecided, final assign[batch, V1])."""
        from mythril_tpu_torch.observability.ledger import get_ledger
        from mythril_tpu_torch.ops import resident as RK
        from mythril_tpu_torch.resilience.checkpoint import drain_requested

        assign = np.asarray(assign, dtype=np.int8)
        batch, V1 = assign.shape
        B = lane_bucket(batch)
        dispatch_stats.lane_slots_filled += batch
        dispatch_stats.lane_slots_total += B
        if drain_requested():
            # one indivisible dispatch: the drain seam is its boundary
            obs.instant("dispatch.drain", cat="sweep", lanes=batch,
                        bucket=B)
            return np.zeros(batch, np.int32), np.array(assign, copy=True)
        seed = np.ones((B, V1), np.int8)
        seed[:batch] = assign
        state = RK.resident_state0(
            seed, batch, GATHER_DECISIONS, width=MAX_CLAUSE_WIDTH,
            pref_row=self._pref_row(pref, V1),
        )
        extra_cap = state["extra"].shape[0] - 1
        budget = RK.resident_budget()
        watchdog = RK.resident_watchdog_limit()

        def step_fn(lane_state):
            full = dict(lane_state)
            full.update(RK.resident_shared0(extra_cap, MAX_CLAUSE_WIDTH))
            out = RK.resident_solve(lits, frontier["adj"], full)
            reason = RK.exit_reason(out["status"], int(out["stall"][0]),
                                    int(out["itc"][0]), watchdog, budget)
            dispatch_stats.resident_dispatches += 1
            counter = f"resident_exit_{reason}"
            setattr(dispatch_stats, counter,
                    getattr(dispatch_stats, counter) + 1)
            return out

        live = np.arange(batch)
        lane_state = {k: state[k] for k in RK.RESIDENT_LANE_FIELDS}
        obs.counter("lanes.live", live=batch, bucket=B)
        load_kernels(self.device, "frontier")
        with obs.span("resident.solve", sink=(dispatch_stats, "resident_s"),
                      cat="sweep", profile=True, lanes=batch):
            lane_state, quarantined = self._dispatch_round(
                f"resident:{B}", step_fn, lane_state,
                RK.RESIDENT_LANE_FIELDS, live, frontier=True,
            )
        for local in quarantined:
            lane_state["status"][local] = 3  # undecided -> CDCL tail
        if quarantined:
            get_ledger().count_transition("quarantined", len(quarantined))
        dispatch_stats.rounds += 1
        self._account_sweeps(lane_state, batch, B)
        self._harvest_round_learnts(lane_state, live, frontier)
        statuses_out = lane_state["status"][:batch].astype(np.int32)
        assign_out = lane_state["assign"][:batch].astype(np.int8)
        return (np.where(statuses_out == 3, 0, statuses_out), assign_out)

    def _solve_gather_ladder(self, key_base: str, lits, assign, pref=None,
                             frontier=None):
        """The solve of a gather tier: the resident solver, or with
        ``MYTHRIL_TPU_RESIDENT_KERNEL=0`` the multi-dispatch frontier
        ladder, or with no ``frontier`` (``MYTHRIL_TPU_FRONTIER=0``) the
        round-lane ladder (budgeted rounds, decided lanes retired
        between rounds, survivors re-packed into the smallest lane
        bucket, their state riding the re-pack).  Each round is one
        supervised dispatch under ``{key_base}:{budget}`` (``frontier``
        for the frontier ladder) through :meth:`_dispatch_round`, and a
        drain request is honored between rounds: survivors retire
        undecided.  Returns (status[batch] with bails mapped to
        undecided, final assign[batch, V1] int8)."""
        from mythril_tpu_torch.observability.ledger import get_ledger
        from mythril_tpu_torch.ops import frontier as FR
        from mythril_tpu_torch.ops.resident import resident_kernel_enabled
        from mythril_tpu_torch.resilience.checkpoint import drain_requested

        if frontier is not None and resident_kernel_enabled():
            return self._solve_resident(lits, assign, pref=pref,
                                        frontier=frontier)
        assign = np.asarray(assign, dtype=np.int8)
        batch, V1 = assign.shape
        B = lane_bucket(batch)
        dispatch_stats.lane_slots_filled += batch
        dispatch_stats.lane_slots_total += B
        pref_row = self._pref_row(pref, V1)
        if frontier is not None:
            seed = np.ones((B, V1), np.int8)
            seed[:batch] = assign
            state = FR.frontier_state0(
                seed, batch, GATHER_DECISIONS, width=MAX_CLAUSE_WIDTH,
                pref_row=pref_row,
            )
            order = FR.FRONTIER_STATE_FIELDS
            round_keys = ("fullsw", "fsteps", "nlearn")
            key_base = "frontier"
            load_kernels(self.device, "frontier")
        else:
            # pads preassigned and retired at step 0, as the JAX ladder's
            seed = np.ones((B, V1), np.int8)
            seed[:batch] = assign
            state = {k: v.numpy() for k, v in RL.initial_state(
                torch.from_numpy(seed), GATHER_DECISIONS,
                None if pref_row is None else torch.from_numpy(pref_row),
            ).items()}
            state["status"][batch:] = 3
            order = RL.ROUND_STATE_FIELDS
            round_keys = ("step",)
            load_kernels(self.device, "round_lane")
        statuses_out = np.zeros(batch, np.int32)
        assign_out = np.array(assign, copy=True)
        live = np.arange(batch)

        budgets, spent, i = [], 0, 0
        while spent < GATHER_STEPS:
            budgets.append(
                GATHER_ROUND_BUDGETS[min(i, len(GATHER_ROUND_BUDGETS) - 1)]
            )
            spent += budgets[-1]
            i += 1

        for budget in budgets:
            if live.size == 0:
                break
            obs.counter("lanes.live", live=int(live.size), bucket=B)
            if drain_requested():
                # survivors retire undecided (the CDCL tail or the
                # resumed run finishes them)
                obs.instant("dispatch.drain", cat="sweep",
                            lanes=int(live.size), bucket=B)
                break
            for k in round_keys:  # per-round counters
                state[k][:] = 0
            key = f"{key_base}:{budget}"
            if frontier is not None:
                with obs.span("frontier.round", cat="sweep", profile=True,
                              key=key, budget=budget, lanes=int(live.size)):
                    state, quarantined = self._dispatch_round(
                        key,
                        lambda st, b=budget: FR.frontier_round(
                            lits, frontier["adj"], st, b),
                        state, order, live, frontier=True,
                    )
            else:
                with obs.span("dispatch.round", cat="sweep", profile=True,
                              key=key, budget=budget, lanes=int(live.size)):
                    state, quarantined = self._dispatch_round(
                        key,
                        lambda st, b=budget: _round_lane_np(lits, st, b),
                        state, order, live,
                    )
            for local in quarantined:
                state["status"][local] = 3  # undecided -> CDCL tail
            if quarantined:
                # bisection cannot name the batch's lane records from
                # here: an aggregate transition (the lanes settle as
                # tail-demoted when the batch closes)
                get_ledger().count_transition("quarantined",
                                              len(quarantined))
            dispatch_stats.rounds += 1
            self._account_sweeps(state, live.size, B)
            if frontier is not None:
                self._harvest_round_learnts(state, live, frontier)
            st = state["status"][: live.size]
            done = st != 0
            if not done.any():
                continue
            for local in np.nonzero(done)[0]:
                statuses_out[live[local]] = st[local]
                assign_out[live[local]] = state["assign"][local]
            keep = np.nonzero(~done)[0]
            live = live[keep]
            if live.size == 0:
                break
            B_new = lane_bucket(int(keep.size))
            idx = np.concatenate(
                [keep, np.repeat(keep[:1], B_new - keep.size)]
            )
            for k in order:
                state[k] = np.ascontiguousarray(state[k][idx])
            state["status"][keep.size:] = 3
            if B_new < B:
                dispatch_stats.repacks += 1
            B = B_new
        # budget spent: survivors stay undecided with their final partial
        # assignment
        for local in range(live.size):
            statuses_out[live[local]] = state["status"][local]
            assign_out[live[local]] = state["assign"][local]
        return np.where(statuses_out == 3, 0, statuses_out), assign_out

    def _build_cone_batch(self, ctx, assumption_sets):
        """Inputs of the union-cone tier: (rows [N, K] int32 over compact
        var ids, assign [batch, n+1] int8, cone_vars [n] int64, roots)
        or None when the union cone is past the tier's caps (or empty).
        The cone walk and remap go through the cone memo."""
        roots = tuple(
            sorted({lit for lane in assumption_sets for lit in lane})
        )
        if not roots:
            return None
        from mythril_tpu_torch.ops.incremental import get_cone_memo

        with obs.span("cone.build", cat="cone", roots=len(roots)):
            built = get_cone_memo().get_or_build(
                ctx, ("cone_rows", roots),
                lambda: self._build_cone_rows(ctx, roots),
            )
        if built is None:
            return None
        rows, cone_vars, anchor = built
        n = int(cone_vars.size)
        assign = np.zeros((len(assumption_sets), n + 1), np.int8)
        assign[:, anchor] = 1
        for lane, assumptions in enumerate(assumption_sets):
            for lit in assumptions:
                var = abs(lit)
                pos = int(np.searchsorted(cone_vars, var))
                if pos < n and cone_vars[pos] == var:
                    assign[lane, pos + 1] = 1 if lit > 0 else -1
        dispatch_stats.h2d_bytes += int(assign.nbytes)
        return rows, assign, cone_vars, roots

    def _build_cone_rows(self, ctx, roots):
        """Cone walk, row fetch, width filter, compact remap and the
        anchor row: (rows, cone_vars, anchor column) or None."""
        try:
            clause_ids, cone_vars = ctx.pool.cone(list(roots))
        except Exception:  # noqa: BLE001 — the JAX tier declines alike
            return None
        if (
            clause_ids.size == 0
            or clause_ids.size > MAX_CONE_GATHER_CLAUSES
            or cone_vars.size > MAX_CONE_GATHER_VARS
        ):
            return None
        lits, indptr = ctx.pool.subset_csr(clause_ids)
        cone_vars = np.union1d(
            np.asarray(cone_vars, dtype=np.int64), [1]
        )  # the TRUE anchor must be mappable (the synthetic row below)
        n = int(cone_vars.size)
        widths = np.diff(indptr)
        keep = widths <= MAX_CLAUSE_WIDTH
        kept_widths = widths[keep]
        row_count = DevicePool._bucket(int(keep.sum()) + 1)
        rows = np.zeros((row_count, MAX_CLAUSE_WIDTH), np.int32)
        if lits.size:
            mask = np.arange(MAX_CLAUSE_WIDTH)[None, :] < kept_widths[:, None]
            kept_lits = lits[np.repeat(keep, widths)]
            pos = np.searchsorted(
                cone_vars, np.abs(kept_lits).astype(np.int64)
            )
            if not np.all(cone_vars[np.minimum(pos, n - 1)]
                          == np.abs(kept_lits)):
                # a clause references a var outside the walked cone:
                # remapping it would be unsound, so decline
                return None
            compact = pos + 1
            rows[: len(kept_widths)][mask] = np.where(
                kept_lits < 0, -compact, compact
            ).astype(np.int32)
        # synthetic anchor unit {TRUE}: a lane asserting FALSE conflicts
        anchor = int(np.searchsorted(cone_vars, 1)) + 1
        rows[len(kept_widths), 0] = anchor
        return rows, cone_vars, anchor

    def check_cone_gather(self, ctx, assumption_sets):
        """Solve the batch against its union cone only (compact var
        ids).  Per-lane verdicts like check_assumption_sets, or None when
        the cone does not fit the tier."""
        from mythril_tpu_torch.ops.frontier import (
            build_adjacency, frontier_enabled,
        )
        from mythril_tpu_torch.ops.incremental import get_cone_memo
        from mythril_tpu_torch.resilience import faults
        from mythril_tpu_torch.resilience.watchdog import DispatchAbandoned

        built = self._build_cone_batch(ctx, assumption_sets)
        if built is None:
            return None
        rows, assign, cone_vars, roots = built
        n = int(cone_vars.size)
        self.device_engaged = True
        bucket = DevicePool._bucket(n)
        if bucket + 1 > assign.shape[1]:
            # padding vars preassigned true: never decided
            assign = np.concatenate(
                [assign, np.ones((assign.shape[0],
                                  bucket + 1 - assign.shape[1]), np.int8)],
                axis=1,
            )
        memo = get_cone_memo()

        def _upload_rows():
            dispatch_stats.h2d_bytes += int(rows.nbytes)
            with obs.span("upload.cone_rows", cat="h2d",
                          bytes=int(rows.nbytes)):
                return torch.from_numpy(rows).to(self.device)

        def _upload_adj():
            adj = build_adjacency(rows, assign.shape[1])
            dispatch_stats.h2d_bytes += int(adj.nbytes)
            with obs.span("upload.adjacency", cat="h2d",
                          bytes=int(adj.nbytes)):
                return torch.from_numpy(adj).to(self.device)

        rows_dev = memo.get_or_build(ctx, ("cone_dev", roots), _upload_rows)
        frontier = None
        if frontier_enabled():
            adj_dev = memo.get_or_build(ctx, ("cone_adj", roots),
                                        _upload_adj)
            col_to_var = np.zeros(n + 1, np.int64)
            col_to_var[1:] = cone_vars
            frontier = {"adj": adj_dev, "ctx": ctx,
                        "col_to_var": col_to_var}
        try:
            status, final_assign = self._solve_gather_ladder(
                "cone", rows_dev, assign,
                pref=warm_pref_row(ctx, assign.shape[1],
                                   cone_vars=cone_vars, offset=1,
                                   lanes=len(assumption_sets)),
                frontier=frontier,
            )
        except DispatchAbandoned as exc:
            return self._abandon(ctx, exc, len(assumption_sets))
        status, final_assign = faults.maybe_corrupt_lanes(status,
                                                          final_assign)
        # back to the full var space for the caller's model extraction
        full = np.zeros((len(assumption_sets), ctx.solver.num_vars + 1),
                        np.int8)
        full[:, cone_vars] = final_assign[:, 1:n + 1]
        self.last_assignments = full
        return [False if status[lane] == 2 else None
                for lane in range(len(assumption_sets))]

    def _gather_eligibility(self, ctx):
        """(None | "size_bailouts", num_vars): None means the full-pool
        tier takes the frontier.  CDCL learnts are absorbed into the
        pool BEFORE the size check (the JAX order: it grows the pool and
        its version), with a bounded exemption from the clause cap."""
        from mythril_tpu_torch.ops.device_health import check_device

        num_vars = ctx.solver.num_vars
        check_device()
        if num_vars > MAX_GATHER_VARS:
            return "size_bailouts", num_vars
        ctx.absorb_learnts(max_width=MAX_CLAUSE_WIDTH)
        absorbed = min(ctx.absorbed_learnt_count, MAX_LEARNT_EXEMPTION)
        if ctx.pool.num_clauses - absorbed > MAX_GATHER_CLAUSES:
            return "size_bailouts", num_vars
        return None, num_vars

    def _sync_pool_and_assign(self, ctx, assumption_sets, num_vars):
        """Reflect the pool on the device (refresh for a new context or
        a grown bucket, else the delta rows) and build the
        assumption-seeded assignment matrix."""
        from mythril_tpu_torch.ops.incremental import resident_pool_enabled

        if self.pool_generation != ctx.generation or (
            not resident_pool_enabled()
        ):
            self.pool.refresh(ctx, num_vars)
            self.pool.version = ctx.pool_version
            self.pool_generation = ctx.generation
        elif self.pool.version != ctx.pool_version or (
            self.pool.num_vars < num_vars
        ):
            if not self.pool.append(ctx, num_vars):
                self.pool.refresh(ctx, num_vars)
            self.pool.version = ctx.pool_version

        V1 = self.pool.num_vars + 1
        assign = np.zeros((len(assumption_sets), V1), dtype=np.int8)
        assign[:, ~self.pool.used] = 1
        assign[:, 1] = 1  # constant-TRUE anchor
        for lane, assumptions in enumerate(assumption_sets):
            for lit in assumptions:
                var = abs(lit)
                if var < V1:
                    assign[lane, var] = 1 if lit > 0 else -1
        dispatch_stats.h2d_bytes += int(assign.nbytes)
        return assign

    def prepare_gather(self, ctx, assumption_sets):
        """The async prefetch's preparation (``ops/async_dispatch.py``):
        the gather tiers' eligibility gates and inputs, built ON THE
        CALLING THREAD (everything that touches the blast context), then
        a zero-argument runner that solves them with the one-shot round
        lane (``make_solve_step`` of the JAX package) on the worker
        thread.  Past the gather caps it prepares a union-cone runner
        instead; None when neither tier takes the frontier.  The runner's
        dispatch and upload are counted here, on the calling thread (the
        JAX runner counts them on the worker; the totals are the same,
        and no counter is written from two threads)."""
        from mythril_tpu_torch.ops import async_dispatch

        if not assumption_sets:
            return None
        verdict, num_vars = self._gather_eligibility(ctx)
        device = self.device
        load_kernels(device, "round_lane")
        if verdict is not None:
            # the prefetch channel must not go dark where the pool is
            # past the caps (deep analyses live there): the cone tier
            built = self._build_cone_batch(ctx, assumption_sets)
            if built is None:
                return None
            rows, assign, cone_vars, _roots = built
            bucket = DevicePool._bucket(int(cone_vars.size))
            if bucket + 1 > assign.shape[1]:
                assign = np.concatenate(
                    [assign, np.ones((assign.shape[0],
                                      bucket + 1 - assign.shape[1]),
                                     np.int8)],
                    axis=1,
                )
            full_width = ctx.solver.num_vars + 1
            dispatch_stats.h2d_bytes += int(rows.nbytes)
            dispatch_stats.device_dispatch_calls += 1

            def run_cone():
                # uploaded here, on the worker's stream (never through
                # the shared cone memo, which the host may be changing)
                final, status = RL.solve_lane(
                    torch.from_numpy(rows).to(device),
                    torch.from_numpy(assign).to(device))
                return {"status": status, "assign": final,
                        "cone_vars": cone_vars, "full_width": full_width}

            return run_cone
        assign = self._sync_pool_and_assign(ctx, assumption_sets, num_vars)
        # a snapshot: DevicePool.append writes the pool rows in place
        lits = self.pool.lits.clone()
        async_dispatch.hand_to_worker(lits)
        dispatch_stats.device_dispatch_calls += 1

        def run():
            final, status = RL.solve_lane(
                lits, torch.from_numpy(assign).to(device))
            return {"status": status, "assign": final}

        return run


#: the kernel libraries each supervised dispatch family launches
_KERNEL_FAMILIES = {
    "dense": ("dense_sweep", "dpll_step"),
    "frontier": ("frontier_kernels",),
    "round_lane": ("round_lane",),
}


def load_kernels(device, family: str) -> None:
    """Build and load the CUDA libraries of a dispatch family on the
    calling thread, before its first supervised dispatch: ``nvcc`` at
    first use is a build, not a wedge, and must not run against a
    dispatch deadline.  A no-op on the CPU and once loaded."""
    if torch.device(device).type != "cuda":
        return
    import importlib

    for name in _KERNEL_FAMILIES[family]:
        importlib.import_module(
            f"mythril_tpu_torch.ops.{name}").load_library()


def _round_lane_np(lits, state: dict, budget: int) -> dict:
    """One round-lane round over the ladder's host-side state (the
    ladder re-packs it between rounds, as the JAX ladder does)."""
    out = RL.round_lane(lits, {
        k: torch.from_numpy(np.ascontiguousarray(state[k])).to(lits.device)
        for k in RL.ROUND_STATE_FIELDS
    }, budget)
    return {k: v.cpu().numpy() for k, v in out.items()}


_backends: Dict[torch.device, BatchedSatBackend] = {}


def reset_resident_pools() -> None:
    """Invalidate every process-global structure keyed on interned node
    ids or literal numbers: each backend's resident clause pool, the
    cross-dispatch cone memo and the word tier's programs and verdict
    memos, and the veritesting tier's join-point memo (a process that
    re-interns nodes and re-blasts literals must never be served what an
    earlier pool or program described)."""
    from mythril_tpu_torch.laser.ethereum.veritest import (
        reset_veritest_memos,
    )
    from mythril_tpu_torch.ops.incremental import reset_cone_memo
    from mythril_tpu_torch.smt.word_tier import reset_word_tier

    for backend in _backends.values():
        backend.pool = DevicePool(backend.device)
        backend.pool_generation = -1
    reset_cone_memo()
    reset_word_tier()
    reset_veritest_memos()


def get_backend(device=None) -> BatchedSatBackend:
    """Process-wide solver tiers per device (``cuda`` unless asked)."""
    from mythril_tpu_torch.ops import default_device

    dev = default_device(device)
    backend = _backends.get(dev)
    if backend is None:
        backend = _backends[dev] = BatchedSatBackend(dev)
    return backend


def _env_from_assignment(ctx, assignment: np.ndarray):
    """EvalEnv from a device assignment vector (BlastContext.extract_env)."""
    return ctx.extract_env(assignment)


def _holds(constraints, env) -> bool:
    from mythril_tpu_torch.smt import terms as T

    for c in constraints:
        node = c.raw if hasattr(c, "raw") else c
        if isinstance(node, bool):
            if not node:
                return False
            continue
        if T.evaluate(node, env) is not True:
            return False
    return True


def batch_check_states(constraint_sets, device=None,
                       tail: bool = True) -> List[Optional[bool]]:
    """Feasibility verdicts for a frontier of constraint sets: True =
    SAT (model verified against the terms), False = UNSAT (sound),
    None = undecided.  The solver tiers run on ``cuda`` unless
    ``device="cpu"`` is passed.  With ``tail=True`` the native CDCL
    answers every lane the funnel leaves open (None then means the CDCL
    answered UNKNOWN); ``tail=False`` returns them as None, for a caller
    that runs its own tail (``laser/batch.py``)."""
    from mythril_tpu_torch.observability.ledger import get_ledger
    from mythril_tpu_torch.ops.async_dispatch import get_async_dispatcher
    from mythril_tpu_torch.smt.solver import get_blast_context

    backend = get_backend(device)
    ctx = get_blast_context()
    # 0. a finished async prefetch first: its UNSAT memos and models
    # decide lanes of THIS frontier below for free
    get_async_dispatcher().harvest(ctx)
    tiers: List[Optional[str]] = [None] * len(constraint_sets)
    dispatch_stats.last_tiers = tiers
    # every lane gets a ledger record; the try/finally keeps the ledger's
    # conservation: whatever the funnel leaves open settles as
    # tail-demoted when the batch closes (before the tail runs, as the
    # JAX funnel's caller runs it)
    lanes_led = get_ledger().begin_batch("batch_check",
                                         len(constraint_sets))
    try:
        decided, node_sets = _funnel(ctx, backend, constraint_sets, tiers,
                                     lanes_led, device)
    finally:
        lanes_led.close()
    if tail:
        # 5. CDCL tail
        with obs.span("funnel.tail", sink=(dispatch_stats, "tail_s"),
                      cat="tail", profile=True):
            _tail(ctx, node_sets, decided, tiers)
    return decided


def _funnel(ctx, backend, constraint_sets, tiers, lanes_led, device):
    """1.-4. of :func:`batch_check_states`: (verdicts, node sets)."""
    from mythril_tpu_torch.autopilot import route_lanes
    from mythril_tpu_torch.smt import SolverStatistics
    from mythril_tpu_torch.smt import terms as T
    from mythril_tpu_torch.support.model import peek_model_verdict
    from mythril_tpu_torch.support.support_args import args

    node_sets: List[Optional[List]] = []
    decided: List[Optional[bool]] = [None] * len(constraint_sets)

    # 1. structural fold
    for i, constraints in enumerate(constraint_sets):
        nodes = []
        falsy = False
        for c in constraints:
            if isinstance(c, bool):
                if not c:
                    falsy = True
                    break
                continue
            node = c.raw if hasattr(c, "raw") else c
            if node is T.FALSE:
                falsy = True
                break
            if node is T.TRUE:
                continue
            nodes.append(node)
        if falsy:
            decided[i] = False
            tiers[i] = "structural"
            node_sets.append(None)
            lanes_led.decide(i, "structural", "unsat")
        else:
            node_sets.append(nodes)

    # the autopilot: per-lane features (stamped on the ledger records)
    # and routes from the ledger-fed cost model; a route only skips a
    # tier whose work the CDCL tail redoes soundly.  All None under
    # MYTHRIL_TPU_AUTOPILOT=0
    routes = route_lanes(node_sets, lanes_led)

    # 2. the probe phase, lane by lane: a permanent UNSAT verdict of the
    # context, a verdict the per-query funnel (support/model.py) already
    # paid for, or a hit of the host word-level probe against the recent
    # models (evaluation is a full verification: a sound SAT verdict;
    # memoized on the context and shared with the CDCL tail, so a model
    # found for one lane serves its siblings at once)
    with obs.span("solver.probe", sink=(SolverStatistics(), "probe_s"),
                  cat="solver", lanes=len(node_sets)) as probe_span:
        for i, nodes in enumerate(node_sets):
            if nodes is None:
                continue
            if ctx.unsat_memo_hit(tuple(sorted(n.id for n in nodes))):
                decided[i] = False
                tiers[i] = "memo"
                lanes_led.decide(i, "probe", "unsat")
                continue
            cached = peek_model_verdict(constraint_sets[i])
            if cached is not None:
                decided[i] = cached
                tiers[i] = "memo"
                lanes_led.decide(i, "probe", "sat" if cached else "unsat")
                continue
            if not args.word_probing:
                continue
            if ctx.probe_with_memo(nodes) is not None:
                decided[i] = True
                tiers[i] = "probe"
                dispatch_stats.host_probe_sat += 1
                lanes_led.decide(i, "probe", "sat")
    lanes_led.tier_wall("probe", probe_span.elapsed_s)

    # 3. the word tier over the open lanes: interval-UNSAT and
    # constant-fold lanes retire here; the others keep their known bits
    word_hints = _word_rung(ctx, node_sets, decided, tiers, device,
                            routes, lanes_led)

    # lanes routed straight to the tail skip the device phase; they keep
    # their routed_by stamp and settle as tail-demoted
    open_indices = [i for i, d in enumerate(decided)
                    if d is None and not (routes[i] is not None
                                          and routes[i].skip_device)]
    if len(open_indices) >= effective_min_lanes():
        _device_phase(ctx, backend, constraint_sets, node_sets, decided,
                      tiers, open_indices, word_hints, lanes_led)
    return decided, node_sets


def _word_rung(ctx, node_sets, decided, tiers, device, routes, lanes_led):
    """3.: one word-tier pass over the open lanes (less those the
    autopilot routed past it); folds its verdicts into ``decided`` (a
    verified word model joins the recent models, as a CDCL model would)
    and returns the open lanes' known-bits hints."""
    from mythril_tpu_torch.smt.word_tier import (
        get_word_tier, word_tier_enabled,
    )

    if not word_tier_enabled():
        return [None] * len(node_sets)
    open_sets = [nodes if decided[i] is None and not (
        routes[i] is not None and routes[i].skip_word) else None
        for i, nodes in enumerate(node_sets)]
    with tier_span("word", "funnel.word") as word_span:
        verdicts, hints, envs = get_word_tier().decide(ctx, open_sets,
                                                       device=device)
    lanes_led.tier_wall("word", word_span.elapsed_s)
    for i, verdict in enumerate(verdicts):
        if verdict is None or decided[i] is not None:
            continue
        decided[i] = verdict
        tiers[i] = "word"
        lanes_led.decide(i, "word", "sat" if verdict else "unsat")
        if verdict and envs[i] is not None:
            ctx._remember_model(envs[i])
    return hints


def _tail(ctx, node_sets, decided, tiers):
    from mythril_tpu_torch.native import SatSolver

    for i, nodes in enumerate(node_sets):
        if decided[i] is not None or nodes is None:
            continue
        status, _env = ctx.check(nodes)
        if status == SatSolver.SAT:
            decided[i] = True
            tiers[i] = "tail"
            dispatch_stats.tail_sat += 1
        elif status == SatSolver.UNSAT:
            decided[i] = False
            tiers[i] = "tail"
            dispatch_stats.tail_unsat += 1


def _device_phase(ctx, backend, constraint_sets, node_sets, decided, tiers,
                  open_indices, word_hints, lanes_led):
    """4.: blast the open lanes (each with its word-tier known bits as
    unit literals), then the dispatch rungs over the deduped assumption
    sets (profit gate with async prefetch, fuse, coalescer), dispatch to
    the solver tiers, fold their verdicts into ``decided``."""
    from mythril_tpu_torch.ops.async_dispatch import get_async_dispatcher
    from mythril_tpu_torch.ops.coalesce import get_coalescer
    from mythril_tpu_torch.ops.frontier import frontier_enabled
    from mythril_tpu_torch.smt.word_tier import hint_literals
    from mythril_tpu_torch.support.support_args import args

    assumption_sets: List[Optional[List[int]]] = [None] * len(node_sets)
    with obs.span("funnel.blast", cat="solver", profile=True,
                  lanes=len(open_indices)):
        for i in list(open_indices):
            try:
                lits = [ctx.blast_lit(n) for n in node_sets[i]]
                if word_hints[i]:
                    # implied by the lane's own constraints: the
                    # solvers start with the pinned bits assigned
                    lits.extend(hint_literals(ctx, word_hints[i]))
                assumption_sets[i] = list(dict.fromkeys(lits))
            except NotImplementedError:
                # a term outside the blaster's fragment: CDCL tail only,
                # marked opaque on its way there
                open_indices.remove(i)
                lanes_led.transition(i, "opaque")
    if len(open_indices) < 2:
        return

    # dedupe identical assumption sets (sibling forks share most or all
    # of their constraints)
    unique: Dict[Tuple[int, ...], int] = {}
    rep_indices: List[int] = []
    lane_of: List[int] = []
    for i in open_indices:
        key = tuple(sorted(assumption_sets[i]))
        lane = unique.get(key)
        if lane is None:
            lane = unique[key] = len(rep_indices)
            rep_indices.append(i)
        lane_of.append(lane)
    rep_sets = [assumption_sets[i] for i in rep_indices]
    rep_nodes = [node_sets[i] for i in rep_indices]
    rep_constraints = [constraint_sets[i] for i in rep_indices]

    if not args.device_force_dispatch and _profit_gate_declines(
            len(rep_indices)):
        # not worth blocking for, but the device is idle: prefetch the
        # batch (a fused context does not feed the device this way);
        # queued lanes ride along to fill its bucket
        dispatch_stats.profit_skips += 1
        if args.async_dispatch and (
            dispatch_fuse.fused_generation != ctx.generation
        ):
            extras = get_coalescer().drain(ctx)
            launched = get_async_dispatcher().launch(
                backend, ctx, rep_sets + [q.lits for q in extras],
                rep_nodes + [q.nodes for q in extras],
                rep_constraints + [q.constraints for q in extras],
            )
            if extras:
                if launched:
                    dispatch_stats.coalesced_dispatches += 1
                    dispatch_stats.coalesced_lanes += len(extras)
                else:
                    get_coalescer().requeue(ctx, extras)
        return

    if not dispatch_fuse.admit(ctx):
        return  # fused off for this context: every lane to the tail
    extras = get_coalescer().admit(ctx, rep_sets, rep_nodes,
                                   rep_constraints,
                                   force_now=dispatch_fuse.retrying)
    if extras is None:
        # the coalescing window: this batch waits in the queue and its
        # lanes go to the tail this round; a later merged dispatch pays
        # them back through the memo and nogood channels
        lanes_led.transition_open(open_indices, "deferred")
        return
    prefetch_inflight = get_async_dispatcher().pending is not None
    # the lanes enter a device tier: its family follows the frontier
    # kill switch, as the JAX ledger names it
    device_tier = "frontier" if frontier_enabled() else "sweep"
    lanes_led.transition_open(open_indices, "dispatched")
    sweeps_before = dispatch_stats.device_sweeps
    learned_before = dispatch_stats.learned_clauses
    with obs.span("dispatch.batch_check", sink=(dispatch_stats, "device_s"),
                  cat="dispatch",
                  lanes=len(rep_sets) + len(extras)) as dispatch_span:
        verdicts = backend.check_assumption_sets(
            ctx, rep_sets + [q.lits for q in extras])
    elapsed = dispatch_span.elapsed_s
    lanes_led.tier_wall(device_tier, elapsed)
    lanes_led.add_sweeps(device_tier,
                         dispatch_stats.device_sweeps - sweeps_before)
    lanes_led.add_learned(dispatch_stats.learned_clauses - learned_before)
    engaged = backend.device_engaged
    if engaged:
        dispatch_stats.dispatches += 1
        dispatch_stats.lanes += len(rep_indices) + len(extras)
        if extras:
            dispatch_stats.coalesced_dispatches += 1
            dispatch_stats.coalesced_lanes += len(extras)
    else:
        dispatch_fuse.refund()

    before = dispatch_stats.unsat + dispatch_stats.sat_verified
    with obs.span("funnel.verify", cat="solver", profile=True):
        _fold_verdicts(ctx, constraint_sets, node_sets, decided, tiers,
                       open_indices, assumption_sets, rep_indices, lane_of,
                       verdicts, backend.last_assignments, engaged,
                       lanes_led, device_tier)
        _fold_extras(ctx, extras, verdicts[len(rep_indices):],
                     backend.last_assignments[len(rep_indices):], engaged)
    if engaged:
        dispatch_fuse.settle(
            ctx, dispatch_stats.unsat + dispatch_stats.sat_verified - before,
            elapsed, prefetch_inflight,
        )


def _profit_gate_declines(n_lanes: int) -> bool:
    """The JAX funnel's profit gate: True when the residue's projected
    CDCL cost (``n_lanes`` times the analysis's own mean native solve,
    ``SolverStatistics().native_s / native_calls``) is below
    ``args.device_min_save_s``."""
    from mythril_tpu_torch.smt import SolverStatistics
    from mythril_tpu_torch.support.support_args import args

    stats = SolverStatistics()
    avg_native = (stats.native_s / stats.native_calls
                  if stats.native_calls else 0.0)
    return n_lanes * avg_native < args.device_min_save_s


def _fold_extras(ctx, extras, verdicts, assignments, engaged):
    """The coalesced lanes' verdicts: the CDCL tail already answered
    them in their own (deferred) round, so they land only in the memo,
    nogood and remembered-model channels; under ``--proof-log`` a
    refutation lands only once a bounded host solve confirmed it."""
    from mythril_tpu_torch.support.support_args import args

    proof_log = args.proof_log
    for pos, q in enumerate(extras):
        if verdicts[pos] is False:
            if proof_log and not ctx.confirm_unsat(q.lits):
                continue
            ctx.note_unsat(q.nodes)
            if engaged:
                ctx.learn_nogood(q.lits, certified=proof_log)
                dispatch_stats.unsat += 1
        elif engaged:
            env = _env_from_assignment(ctx, assignments[pos])
            if _holds(q.constraints, env):
                ctx._remember_model(env, truth=assignments[pos])
                dispatch_stats.sat_verified += 1


def _fold_verdicts(ctx, constraint_sets, node_sets, decided, tiers,
                   open_indices, assumption_sets, rep_indices, lane_of,
                   verdicts, assignments, engaged, lanes_led, device_tier):
    """3.: device UNSAT -> memo + nogood; SAT candidates -> verified by
    evaluating the terms under the decoded model, else left open.  When
    no tier took the frontier the assignment is all zeros, and a lane
    it satisfies is decided all the same (as the JAX funnel does), but
    counts as no device verdict (the ledger's ``probe``).  Under
    ``--proof-log`` a device UNSAT decides a state only after a bounded
    host solve of its cube confirmed it (one a deduped lane; the
    confirming solve records the proof event the checker replays); an
    unconfirmed lane is left to the CDCL tail."""
    from mythril_tpu_torch.support.support_args import args

    proof_log = args.proof_log
    confirmations = {}  # proof log: lane -> confirmed
    counted = set()
    for pos, i in enumerate(open_indices):
        lane = lane_of[pos]
        first = engaged and lane not in counted
        counted.add(lane)
        if verdicts[lane] is False:
            if proof_log:
                confirmed = confirmations.get(lane)
                if confirmed is None:
                    confirmed = confirmations[lane] = ctx.confirm_unsat(
                        assumption_sets[rep_indices[lane]])
                if not confirmed:
                    decided[i] = None  # the tail re-solves it in full
                    continue
            decided[i] = False
            tiers[i] = "device"
            lanes_led.decide(i, device_tier, "unsat")
            # device UNSAT is permanent: memoize it and learn the
            # assumption nogood so the CDCL inherits the refutation
            ctx.note_unsat(node_sets[i])
            if first:
                ctx.learn_nogood(assumption_sets[rep_indices[lane]],
                                 certified=proof_log)
                dispatch_stats.unsat += 1
            continue
        env = _env_from_assignment(ctx, assignments[lane])
        ok = _holds(constraint_sets[i], env)
        decided[i] = True if ok else None
        if ok:
            tiers[i] = "device" if engaged else "probe"
            lanes_led.decide(i, device_tier if engaged else "probe", "sat")
        if first:
            if ok:
                ctx._remember_model(env, truth=assignments[lane])
                dispatch_stats.sat_verified += 1
            else:
                dispatch_stats.undecided += 1
