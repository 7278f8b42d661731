#!/usr/bin/env python3
"""Chip check of the PyTorch port (``mythril_tpu_torch``) on one NVIDIA
H100: the quickest proof that the port still starts on the GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase catches its own
failure):

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: the native CDCL library (g++), the dense sweep kernel, the
   DPLL step, the frontier kernels, the round lane, the word fixpoint,
   the lockstep interpreter and the keccak sponge (nvcc, sm_90a), and
   the spin kernel the keccak phase times behind, all nine started
   together, with their build seconds and the
   ``-Xptxas -v`` register / shared-memory lines;
3. kernels vs plain: the hand-written sweep over clause rows
   (``SweepRows``: row pointers and cells) against ``sweep_plain`` over
   the planes built from the same coordinates, bit for bit, at the
   check's shape (C = 16384 clauses, V = 4096 variables, B = 64 lanes)
   and at the main path's (C = 32768, B = 16), CNF rows of 1-12 literals
   from a numpy seed, scores on and off and a 2048-row hot prefix; its
   device ms, its plain version's over the rows, ``sweep_plain``'s, the
   bound (row pointers, cells, widths and A read once, the outputs
   written once, against the operations the data needs; which of the two
   bounds it) and two yardsticks the port never uses: the 4 + 4 dense
   float32 ``torch.matmul`` products and the same products as
   ``torch.sparse.mm`` over CSR copies of the planes; the frontier
   kernels (``scan_rows``, ``lane_step``, ``round_epilogue``) against
   their plain versions,
   iteration by iteration, on ``frontiers.learning_problem`` at the
   resident solver's caps (C = 16384, K = 8, V1 = 8193, B = 64,
   fan x deg = 512, E = 64, 40 shared rows prefilled), until the
   compared launches held conflicts under decisions in several lanes and
   on a shared row, learned rows in several lanes, equal rows from twin
   lanes, a shared row learned again, a pool overflow and cascades (the
   phase fails if one is missing); then two iterations at V1 = 16385
   (the scan's planes split over a cluster of two blocks); then the
   three at the autopilot tuner's edge values (``fan`` 4, 24 and 64 at
   ``period`` 8, ``period`` 2 and 32 at ``fan`` 16: ``autopilot/tuner.py``
   steps the frontier solvers' knobs between 4 and 64 and 2 and 32),
   iterations of the learning problem, every launch equal bit for bit
   and the library's shared memory equal to ``smem_layout``'s; then
   ``lane_step`` at V1 in {2049, 8193, 16385} with B = 64 and at B = 8
   with V1 = 4097 (clusters of 2 and 8 blocks a lane), on the learning
   problem up to a launch in which 2+ lanes learn and on a case launch
   (``lane_case_loop``) on a full and a gather view, until it held a
   walk cut at ``uip_iters``, a walk whose pivot is a decision, a
   backtrack, a force, a decision, a bail and SAT completion at every
   shape (the phase fails if one is missing); then
   ``scan_rows`` (a gather and a full view) and ``round_epilogue`` on
   random data at B in {1, 7, 64, 256} by V1 in {2049, 8193, 16385}
   (clusters of 1 to 8 blocks, B x cluster below and above the 132 SMs)
   and the epilogue on its edge cases (an empty pool, a pool one row
   from full that overflows, every lane learning one row, a row of the
   live pool learned again, an ``okl`` lane with an all-zero row); every
   output equal bit for bit; times each kernel on the device, its plain
   version and the bound (the frontier kernels and the round lane have
   no library counterpart); the round
   lane (``round_lane``) against ``round_lane_plain`` on the learning
   problem at the full-pool shape (C = 16384, V1 = 8193, K = 8, B = 64),
   a union-cone shape (V1 = 2049) and the full pool at 8, 32 and 256
   lanes (clusters of 2, 8, 4 and 1 blocks a lane), budgets 64, 256, 512
   and 768, every field equal bit for bit, until lanes backtracked,
   bailed and went UNSAT and every cluster size held; and the plain model
   of the kernel's skip record on the full pool, until a backtrack
   cleared a record with every scan equal to the full one;
4. DPLL step: the ``dpll_step`` kernel against ``dpll_step_plain`` on
   the card, every state field, the zeroed sweep workspace and the
   flags bit for bit, on ``frontiers.dpll_step_problem``'s seeded states
   at the check's shape (B = 64, V = 4096, D = 1024), at V = 16384
   BCP-only, at V = 8192, at B = 1 and 7, and at B = 7, V = 16384 with
   decisions, on a full view, a hot view and a gated hot view, until
   every transition of ``STEP_EVENTS`` showed (the phase fails if one
   is missing), with each shape's blocks a lane (the cluster size)
   printed; whole rounds of ``make_dense_rounds`` (64 steps) on a
   planted CNF at C = 16384, V = 4096, B = 64, tiered and not (tier
   periods 8 and the tuner's edges 2 and 32), against the same round
   with the plain step on the card; the profiler's count
   of one round's device operations (two a step, plus the round's
   set-up and its live-marker reads); device ms (profiler), plain ms
   (CUDA events) and the bound at the check's shape and at the main
   path's most launched B = 16, V = 4096, D = 1024;
5. main path: frontiers through ``ops.batched_sat.batch_check_states``
   on ``cuda``, force-dispatched: the ``scale_mul`` frontier of
   ``bench.py`` (depth 6 / 16-bit guards, past the cone caps: dense
   tier), and 64 sibling forks sharing a 32-bit MUL guard chain, four
   times: as the default runs it (the dense tier delegates it to the
   resident solver), with ``MYTHRIL_TPU_RESIDENT_KERNEL=0`` (dense
   tier), with the dense tier off as well (the multi-dispatch frontier
   ladder), and with ``MYTHRIL_TPU_FRONTIER=0`` and the dense tier off
   (the round-lane ladder, every launch audited).  Each run holds every
   kernel it launches against its plain version on the run's own inputs
   (every frontier call that may learn, append or cascade, and a sample
   of the rest), checks the launch counts (the word tier's kernel once a
   run: both frontiers have 64 lanes, and the funnel's word rung takes
   the device executor from 16), every verdict against the known ones,
   every 1st, 2nd, 4th ... DPLL step of each shape against the plain
   step on clones of its inputs, and every device or word-tier UNSAT
   against the port's own CDCL; the word tier's launch of each default
   run is captured;
6. word fixpoint: the ``word_prop`` kernel against
   ``word_fixpoint_plain`` on the card, bit for bit, on seeded random
   term DAGs at 16, 64 and 256 lanes, on a DAG that holds every opcode
   of the kernel's table at widths 1, 8, 31, 33, 160 and 256, on a
   comparison whose push-down reaches depth 8 through concat and
   extract, on a program at the node cap (1024 nodes, 256 lanes: the
   largest block of shared memory), and on the two captured main-path
   programs; device ms (CUDA events around bare launches: the profiler
   loses records of these launches), plain ms (one run), bound; the plain
   walks of the three edge cases run on the CPU in one worker process
   that the check starts first, beside the builds and earlier phases;
7. prefetch: the guard chain with the profit gate always declining
   (``device_min_save_s`` 1e9): launched on the worker's stream, joined,
   harvested by the next call; checks a harvest, no drop, the memo's
   verdicts and the audited round-lane launches;
8. lockstep: the ``lockstep`` kernel against ``run_plain`` on the card,
   every state field, the visited bitmaps and the step count bit for
   bit: (a) the main path's own launches (the dispatcher pre-split's
   validation of every chip contract, of ``batchtoken`` and of a
   64-selector dispatcher, and the replay of a three-transaction
   ``batchtoken`` sequence, each launch held against the plain loop);
   device ms, plain ms and the bound on the ``vault_withdraw``
   validation (the kernels line's numbers); (b) the gauntlet
   (``contracts.lockstep_gauntlet``) at 4,096 lanes with the JAX
   arenas, calldata from a numpy seed: held against the plain loop on
   its first 1,024 lanes at a cap of 1,024 steps (the eager plain loop
   takes seconds a division step), every halt code and NEEDS_HOST cause
   required in both that batch and the 4,096 x 4,096 run, the kernel
   timed alone at both sizes;
9. analyze: ``myth analyze`` on the card through the port's analyzer
   (``mythril.MythrilAnalyzer``, as ``python3 -m mythril_tpu_torch
   analyze`` runs it) over the runs of ``contracts.CHIP_RUNS`` (the
   ``bench.py`` scale contract at -t 1 and -t 2, two vendored fixtures,
   killbilly, the constant-key mapping, the veritesting gauntlet),
   first in the JAX default
   configuration of the dispatch
   rungs (profit gate, async prefetch, coalescer: what the CLI runs),
   then force-dispatched; per run, checks the SWC set against the JAX
   package's, that no deadline cut the run, that no prefetch was
   dropped, abandoned or failed, that the force-dispatched scale runs
   reached a device tier, and that every audited kernel call equals its
   plain version; prints the wall, states, prune calls, dispatches,
   resident solves and their exits, delegations, lanes decided on the
   device and on the tail, kernel launches, learned clauses and the
   rungs' counters (profit skips, async launches, harvests, UNSAT lanes,
   models, drops, coalesced dispatches and lanes), the device seconds by
   tier (dense, of them its round ladders, gather and cone, of them
   resident, and the word rung: ``dispatch_stats.dense_s`` and the
   others), and the probe phase's
   and the word tier's (lanes the host probe and the word tier decided,
   bits pinned, ``word_prop_s``, decide calls on the kernel, the first
   held against its plain version when force-dispatched); the word tier
   and the host probe are on, as the CLI runs them; checks that some run
   went through the resident solver with all three frontier kernels;
   runs each scale contract (d6 -t 1, d4 -t 2) in the default rungs and
   with the batched path off (per-state CDCL only) in turns (default,
   CDCL only, CDCL only, default; no audits) and prints those four walls
   with their states and the card's name and power limit, and the
   audited walls side by side; then the
   ``MYTHRIL_TPU_RESIDENT_KERNEL=0`` yardstick at d4 -t 1.  The
   dispatcher pre-split and the concrete replay are on, as the CLI runs
   them: per run it prints the pre-split's seeded states, the lockstep
   launches (each held against the plain loop in the default rungs) and
   the issues' replay statuses, and fails where a run made no lockstep
   launch, left an issue unreplayed, or where the pre-split's seeding
   differs from the run's ``presplit`` flag.  The symbolic lockstep tier
   is on, as the CLI runs it: per run it prints the states stepped in
   segments, ``segment_s``, the host boundaries by cause, the plane
   density (known over total bits), the memory and storage plane ops,
   the keccak hashes and launches (every call held against the plain
   version), and fails where no segment ran, where hashes and launches
   disagree, or where the constant-key mapping made no keccak launch in
   the default rungs.  The veritesting tier is on, as the CLI runs it:
   per run it prints the merges, the lanes merged away, the ite terms,
   the aborted merges, the subsumption sweeps and the lanes they
   retired, and ``merge_span_s``, and fails where a run's merges are not
   the JAX package's recorded count (``ChipRun.merges``); the gauntlet
   runs once more force-dispatched under ``MYTHRIL_TPU_VERITEST=0``,
   which must give the same SWC set, no merge and more states stepped.
   The lane ledger and the autopilot are on, as the CLI runs them: per
   run it prints the ledger's lanes, decided lanes by tier,
   ``tier_decided_pct``, transitions and routes, the autopilot's
   counters (lanes routed, word skips, tail routes, ladder rungs and
   their outcomes, segments declined) and the tuner's overrides, steps
   and reverts, and fails unless ``lanes_total`` equals the sum of the
   decided lanes and every kept record's path is legal under the port's
   ``LEGAL_NEXT``; a force-dispatched dense run whose dispatches the
   autopilot routed away is audited again under an explicit
   ``MYTHRIL_TPU_AUTOPILOT=0`` (and the log says so); the two scale runs
   run once more with ``MYTHRIL_TPU_AUTOPILOT=0 MYTHRIL_TPU_LEDGER=0``
   beside their default-rungs walls; and one
   ``python3 -m mythril_tpu_torch analyze`` process on the card writes
   ``--trace-out``, ``--metrics-out`` and ``--lane-ledger-out`` into a
   temporary directory: the trace parses with ``traceEvents``, the
   Prometheus text parses, the ledger holds conservation and legality,
   the jsonv2 report has ``meta.observability``;
10. keccak: the ``keccak`` kernel against ``keccak256_batch_plain`` on
   the card, every digest byte for byte, and a sample of rows against
   the native ``keccak256``: the analyses' own calls, then 65,536 seeded
   rows at widths 32, 64, 136, 137 and 256 and 1,048,576 rows at 64;
   device ms on two stopwatches (CUDA events around each bare launch on
   an idle stream, and behind the spin kernel of
   ``chip_tools/lockstep_times.py``, built with the kernels: the
   device's time alone), plain ms, the bound (its 32-bit integer
   operations at the integer issue rate) and the share;
11. resilience: the force-dispatched ``scale_mul d6 -t 1`` once
   fault-free (its dispatch seam's hits recorded) and once with each
   fault armed through ``MYTHRIL_TPU_FAULT`` with a skip that lands it
   mid-analysis: ``dispatch_error`` once (the retry recovers; SWC set,
   states and tail lanes equal), ``lane_poison`` on a lane of a
   dispatch of two or more (exactly it quarantined, the ledger's
   ``quarantined`` transitions equal), ``dispatch_hang`` under a 2 s
   deadline and a 5 s hang (the watchdog trips, the flight ring is
   dumped on each trip and the demotion, the re-probe subprocess
   answers, the context goes to the CDCL), ``dispatch_garbage`` (no
   forged SAT verified), ``prefetch_error`` in the default rungs (a
   batch dropped) and ``governor_breach`` four times (the four rungs in
   order in ``meta.resilience.governor``), every faulted run with the
   fault-free SWC set and states; then the CLI killed by
   ``MYTHRIL_TPU_KILL_AT`` at a dispatch seam with ``--checkpoint-dir``
   and resumed with ``--resume`` (the uninterrupted SWC set,
   ``resumes`` 1), and ``scale_mul d4 -t 2`` drained by SIGTERM (a
   partial report) and resumed; and, in a process of its own, a resident
   dispatch whose round epilogue the card refuses (its shared memory
   past the block's limit, the port's own check lifted): the launch
   error leaves the ladder as a ``RuntimeError``, with no retry, no
   demotion and no ``DeviceLost``.  The analyze phase prints each run's
   supervised dispatch attempts and the host time of their worker
   threads' start and join; then the persist and proof phases;
12. fleet: ``python3 -m mythril_tpu_torch analyze`` (its ``main`` in
   this process, which is the coordinator) on ``scale_mul d4 -t 2`` with
   ``--workers 2`` under ``DETERMINISTIC``: the single-process SWC set,
   two leases or more, no worker death, no lease finished in-process,
   and two worker processes of their own (pids other than this
   script's) that ran their leases on the card (each result names the
   card and its allocator's peak bytes); ``nvidia-smi
   --query-compute-apps`` polled while the fleet runs (printed: where the
   machine's processes share one container it lists them as one entry,
   pid 1, so per-process memory comes from the workers' reports); walls single, then fleet
   (cut from single, fleet, fleet, single to keep the check within its
   time) with states, ``segments_declined``, leases and rebalances; once more
   force-dispatched with ``--lane-ledger-out``: the merged ledger holds
   device-tier lanes under the leases' scopes, from the workers'
   snapshots; then on ``erc20_transfer -t 2`` (the cheapest chip run
   whose frontier at transaction 1 holds two states)
   ``MYTHRIL_TPU_FAULT=worker_kill:1`` recovering with its SWC set, and a
   ``worker --connect`` seat with a secret file attached over loopback
   to a ``--workers 1`` coordinator whose own seat never dials; and full
   offload of killbilly -t 1 (``MYTHRIL_TPU_FLEET_MIN_STATES=1``: the
   coordinator steps no state, SWC-106 comes through the merge).  The
   workers' kernel launches are in their processes, not in the kernels
   line;
13. serve (PR 23), under ``DETERMINISTIC``: an in-process
   ``AnalysisServer`` on the card on port 0 (its launches, counted from
   0 just before its requests and read just after, go into the kernels
   line): ``scale_mul d6 -t 1`` cold, killbilly -t 1 (SWC-106), d6 warm
   four times (each SWC set the analyze phase's; each request's wall,
   states, ``segments_declined`` and ``torch.cuda.memory_allocated()``
   printed; the fourth warm request holds no more memory than the
   second), d6 force-dispatched on a cold context (the serve engine's
   ``MYTHRIL_TPU_SERVE_COLD`` path for that request: a warm context
   answers a repeated contract from its memos without a dispatch; its
   request scope in ``/debug/lanes`` holds lanes the device tiers
   decided), ``scale_mul d4 -t 2`` with a
   deadline too short (``partial: true``) and a whole request after it,
   an injected ``serve_crash`` failing one request alone (the next one's
   findings equal, the allocator back at or below its level before the
   crash) and, with a persist directory, a re-submission answered from
   the report cache with the same body; then ``python3 -m
   mythril_tpu_torch serve`` as a process (``/readyz`` with mode
   ``device``, one request, ``top --once`` against it, SIGTERM: exit 0
   and its ``--trace-out`` / ``--metrics-out`` files), and a server with
   ``fleet_listen`` on loopback and a secret file answering one request
   through an attached ``worker --connect`` seat (``mode: fabric``, the
   in-process server's findings);
14. statespace (PR 23): ``-g`` on ``scale_mul d6 -t 1`` and ``-j`` on
   ``vault_withdraw`` (``-j`` runs two transactions whatever ``-t`` says,
   as in the JAX CLI; on d6 that dump is 15 min of CPU and 244 MB) through
   the CLI on the card and with ``--device cpu``, each pair equal after
   the node uids are renumbered by first appearance, and
   ``--enable-coverage-strategy`` on d6 -t 1 with the default run's SWC
   set; the five processes run side by side;
15. on-chain loading and the watch, from chains the check serves
   itself on 127.0.0.1 (``contracts.onchain_chain`` and
   ``contracts.watch_chain`` through ``contracts.serve_chain``, a stdlib
   JSON-RPC server): ``load_from_address`` of CLONE2 (the scale contract
   at d6 g16 behind two EIP-1167 hops) and ``fire_lasers`` with the
   loader active at -t 1, in the default rungs and force-dispatched;
   ``vault_withdraw`` -t 2 at VAULT (its balance from the chain; its
   storage keys are the symbolic caller, so its storage is the loader's
   concrete one) and ``call_constant`` -t 1 at GATE (slot 0 and the code
   it calls read from the chain); the clone run again under
   ``MYTHRIL_TPU_FAULT=rpc_error`` (a retry, the same SWC set and
   states; its launches not counted); every run audited, its launches
   counted, its SWC set the JAX package's (``contracts.ONCHAIN_RUNS``);
   then the watch in process through ``WatchService`` and the port's
   ``EngineBackend`` on the card (six deployments, a reverted CREATE, a
   reorg of two blocks: four dedup hits, two analyses with the SWC sets
   of ``contracts.WATCH_FINDINGS``; its launches counted), and as
   processes side by side: ``analyze -a``, ``read-storage 0,2``,
   ``function-to-hash`` and ``watch`` (the in-process watch's summary and
   findings rows), then ``watch --resume`` from that journal, which
   submits nothing; the phase fails past 120 s;
16. inputs, under ``DETERMINISTIC`` with ``HOME`` and
   ``MYTHRIL_DIR`` in a temporary directory: the stand-in compiler
   (``contracts.write_solc_standin``: a stdlib script answering ``solc
   --standard-json`` from the fixtures of ``contracts.SOURCE_FIXTURES``,
   no compiler) first on ``PATH``; ``load_from_solidity`` of
   ``SCALE.sol:Scale`` (the scale contract at d6 g16 behind a creation
   stub, beside a second contract and an interface, importing
   ``ScaleBase.sol``) and ``fire_lasers`` at -t 1 with the loader active,
   in the default rungs and force-dispatched, every kernel call audited
   and the launches counted; each finding's SWC set and function names
   those of the JAX package (``contracts.SOURCE_RUNS``), its file, line
   and code those the plain decoding of the fixture's map gives;
   ``truffle -t 2`` through the CLI's ``main`` in this process on a
   project of killbilly, ``erc20_transfer`` and an interface (the JAX
   package's SWC sets, ``contracts.TRUFFLE_SWC``; its launches counted);
   a geth LevelDB of ``onchain_accounts`` and 1,000 generated contracts
   (``contracts.write_geth_db``: a table of snappy blocks and a
   write-ahead log tail) written, opened and indexed, and searched in
   process; then as processes side by side: ``analyze SCALE.sol:Scale``,
   ``analyze SCALE.sol:Helper --solv V --solc-json S -q`` (``solc-V``
   asked, the settings on its stdin, the function named ``retire()``
   from the fixture's ``methodIdentifiers``), ``leveldb-search`` and
   ``hash-to-address`` (the hits and IMPL's address), and ``pro`` against
   ``contracts.serve_analysis_api`` on 127.0.0.1 (the issues as the JAX
   package converts them, the sources submitted as text); the phase
   fails past 75 s;
17. the launches of the main path's configurations and, apart, of the
   ``MYTHRIL_TPU_RESIDENT_KERNEL=0`` runs; the histogram of the (B, V,
   D) shapes at which every audited run launched ``dpll_step``; the
   dense tier's rounds by step budget and their hot-view steps over
   every main-path and analyze run (each run's are on its own line);
   one JSON line per kernel (launches of the main path), the card line,
   then the result line.

Exits non-zero, printing no result, when no CUDA device is present.
"""

import contextlib
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

#: the sweep shape of the check (C clauses, V vars, B lanes), and the
#: main path's most launched one (the histogram at the end of the check)
SWEEP_C, SWEEP_V, SWEEP_B, HOT_ROWS = 16384, 4096, 64, 2048
MAIN_SWEEP_SHAPE = (32768, 4096, 16)
#: the frontier kernels' shape: the resident solver at the cone caps, its
#: shared pool prefilled with 40 rows (so 32 distinct learned rows overflow
#: it); and the union-cone tier's largest var bucket
FRONTIER_C, FRONTIER_V1, FRONTIER_B, FRONTIER_E = 16384, 8193, 64, 64
FRONTIER_PREFILL, FRONTIER_WIDE_V1 = 40, 16385
#: the scan's and the epilogue's geometries on random data: lanes (B x
#: cluster below and above the card's 132 SMs) by widths (V1 no multiple
#: of the cluster), over five 512-row pool tiles, the last one partial
GEOMETRY_B, GEOMETRY_V1 = (1, 7, 64, 256), (2049, 8193, 16385)
GEOMETRY_C = 2300
#: iterations the frontier kernel phase may take to see every case
FRONTIER_ITERS = 64
#: where the check runs its kernels (only ever "cuda" when run as a script)
DEVICE = "cuda"
#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): memory and
#: float32 outside the tensor cores (an FMA counted as two operations);
#: 32-bit integer add, logic and shift issue at 64 a clock an SM on
#: compute capability 9.0 (half the 128 float32 lanes), at 132 SMs and
#: the 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


class CheckFailed(RuntimeError):
    pass


def check(cond, message):
    if not cond:
        raise CheckFailed(message)


def log(message):
    print(message, flush=True)


@contextlib.contextmanager
def env(**values):
    """Environment knobs set for the block (None unsets one)."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _query_gpu(fields):
    done = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(done.returncode == 0, f"nvidia-smi failed: {done.stderr}")
    return done.stdout.strip().splitlines()[0]


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return _query_gpu("name,power.limit")


def card_uuid():
    """The card's UUID, which tells two readings on one card from
    readings on two."""
    return _query_gpu("uuid")


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_device_ms(fn, iters, kernel="dense_sweep_kernel", tries=10):
    """Device time of one launch of ``kernel``, from the profiler (the
    wrapper's host work and any copies around it are not in it): the
    mean over ``iters`` launches.  A profiled run whose records of the
    kernel are not exactly ``iters`` is logged and profiled again, up to
    ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        if len(hits) == 1 and hits[0].count == iters:
            return hits[0].self_device_time_total / iters / 1e3
        log(f"profiler: {kernel} records {[(e.key, e.count) for e in hits]} "
            f"of {iters} launches; profiling again")
    raise CheckFailed(f"profiler did not keep {iters} records of {kernel} "
                      f"in {tries} runs")


def build_all():
    """The nine builds, started together; returns their log lines."""
    from mythril_tpu_torch.native import load as load_native
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import dpll_step as DSTEP
    from mythril_tpu_torch.ops import frontier_kernels as FK
    from mythril_tpu_torch.ops import keccak as KC
    from mythril_tpu_torch.ops import lockstep as LS
    from mythril_tpu_torch.ops import round_lane as RL
    from mythril_tpu_torch.ops import word_fixpoint as WF

    jobs = {"native CDCL": load_native, "dense_sweep.cu": ds.load_library,
            "dpll_step.cu": DSTEP.load_library,
            "frontier.cu": FK.load_library, "round_lane.cu": RL.load_library,
            "word_prop.cu": WF.load_library, "lockstep.cu": LS.load_library,
            "keccak.cu": KC.load_library, "spin kernel": build_spin}
    seconds, errors = {}, {}

    def run(name, fn):
        started = time.perf_counter()
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — reported below
            errors[name] = exc
        seconds[name] = time.perf_counter() - started

    threads = [threading.Thread(target=run, args=item)
               for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, exc in errors.items():
        raise CheckFailed(f"build of {name} failed: {exc}")
    lines = [f"build: {name} {seconds[name]:.1f} s" for name in jobs]
    for name, info in (("dense_sweep.cu", ds.build_info),
                       ("dpll_step.cu", DSTEP.build_info),
                       ("frontier.cu", FK.build_info),
                       ("round_lane.cu", RL.build_info),
                       ("word_prop.cu", WF.build_info),
                       ("lockstep.cu", LS.build_info),
                       ("keccak.cu", KC.build_info)):
        if info is not None:
            lines.append(f"nvcc -Xptxas -v {name}: " + " | ".join(
                line.strip() for line in info[1].splitlines()
                if "registers" in line or "smem" in line
                or "spill" in line or "Function properties" in line))
    return lines


#: ``chip_tools/lockstep_times.py`` (its spin and empty kernels' source,
#: their cycles and its event timing) and the spin kernels' library, once
#: ``build_spin`` has built it
SPIN = {}


def build_spin():
    """Build and bind ``chip_tools/lockstep_times.py``'s spin kernels
    (its ``spin_library``) into ``SPIN``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "chip_tools", "lockstep_times.py")
    spec = importlib.util.spec_from_file_location("lockstep_times", path)
    times = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(times)
    SPIN.update(times=times, lib=times.spin_library())


def spin_ms(name, launch, iters):
    """Device ms of one bare launch behind a spin (the stream busy while
    the host enqueues it: the device's time alone), the mean of
    ``iters``."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    times, lib = SPIN["times"], SPIN["lib"]
    check(launch() == 0, f"{name} launch")
    readings = times.event_ms(launch, iters, lambda: lib.spin_launch(
        times.SPIN_CYCLES, stream))
    return sum(readings) / iters


def sweep_coords(C, V, seed=0):
    """CNF-like clause rows: each live row has 1-12 literals on distinct
    columns >= 2 with random signs; the last eighth of the rows is bucket
    padding (width 0).  Host (row, column, negative, width [1, C])."""
    rng = np.random.default_rng(seed)
    live = C - C // 8
    widths = rng.integers(1, 13, size=live)
    rows = np.repeat(np.arange(live), widths)
    cols = np.concatenate([
        rng.choice(np.arange(2, V), size=w, replace=False) for w in widths
    ])
    neg = rng.random(rows.size) < 0.5
    width = np.zeros((1, C), np.float32)
    width[0, :live] = widths
    return rows, cols, neg, width


def sweep_operands(row, col, negative, width, V):
    """The sweep's pool operands of host coordinates, on the card: the
    union pool's ``SweepRows`` (row pointers, cells, widths)."""
    from mythril_tpu_torch.ops import dense_sweep as ds

    return ds.rows_from_coords(row, col, negative, width, V, DEVICE)


def random_sweep_inputs(C, V, B, seed=0):
    """``sweep_coords``' clause rows as ``SweepRows`` on the card, the
    planes they expand to (``rows_to_planes``), and A: the anchor and
    random {-1, 0, +1}."""
    import torch

    from mythril_tpu_torch.ops import dense_sweep as ds

    rng = np.random.default_rng(seed + 1)
    rows = sweep_operands(*sweep_coords(C, V, seed), V)
    A = rng.choice([-1.0, 0.0, 1.0], size=(B, V)).astype(np.float32)
    A[:, 0] = 0.0
    A[:, 1] = 1.0
    return rows, ds.rows_to_planes(rows, V), torch.from_numpy(A).to(DEVICE)


def bound(bytes_moved, ops, ops_per_s=FP32_OPS_PER_S):
    """(least ms, what bounds it): the bytes at the HBM rate against
    the operations at ``ops_per_s`` (the float32 rate by default)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sweep_bound(rows, V, B, cells, outputs, scatter_adds):
    """Least time for one sweep over ``rows`` clause rows holding
    ``cells`` literals: the row pointers, cells, widths and the [B, V]
    assignment read once and each output written once at the HBM rate,
    against the operations this data needs (two counts a cell and lane,
    one add a scattered unit) at the 32-bit integer rate."""
    bytes_moved = 4 * (rows + 1) + 4 * cells + 4 * rows + 4 * B * V \
        + outputs * 4 * B * V + 4 * B
    return bound(bytes_moved, 2 * cells * B + scatter_adds, INT32_OPS_PER_S)


def sparse_library(planes, A, rows, scores):
    """The sweep's products as one PyTorch call each on CSR copies of the
    planes (``torch.sparse.mm``, float32: what a user writes for a sparse
    product; cuSPARSE), a yardstick the port never calls: returns a
    zero-argument function that runs them."""
    import torch

    P, N = (p[:rows].float() for p in planes)
    csr = [m.to_sparse_csr() for m in (P, N, P.T.contiguous(),
                                       N.T.contiguous())]
    pos_t = A.clamp(min=0.0).T.contiguous()
    neg_t = (-A).clamp(min=0.0).T.contiguous()
    member = torch.ones((rows, A.shape[0]), device=A.device)

    def run():
        for lhs, rhs in ((csr[0], pos_t), (csr[1], neg_t), (csr[0], neg_t),
                         (csr[1], pos_t)):
            torch.sparse.mm(lhs, rhs)               # [C, B] counts
        for lhs in ((csr[2], csr[3]) * (2 if scores else 1)):
            torch.sparse.mm(lhs, member)            # [V, B] scatters
    return run


def sweep_case(rows, planes, A, scores, hot):
    """The kernel over ``rows`` against ``sweep_plain`` over ``planes``,
    bit for bit, then its times beside the plain versions', the bound and
    both library yardsticks; returns the kernels-line entry's numbers."""
    import torch

    from mythril_tpu_torch.ops import dense_sweep as ds

    C = rows.width.shape[1]
    R = C if hot is None else hot
    B, V = A.shape
    got = ds.dense_sweep(*rows, A, scores, hot)
    torch.cuda.synchronize()
    want = ds.sweep_plain(*planes, rows.width, A, scores, hot)
    what = f"C={C} V={V} B={B} scores={scores} rows={R}"
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"sweep {what}: {g.shape} vs {w.shape}")
        check(torch.equal(g, w), f"sweep {what}: kernel != sweep_plain")
        err = max(err, float((g - w).abs().max()))
    check(float(got[0].sum()) > 0 and float(got[2].sum()) > 0,
          f"sweep {what}: vacuous inputs (no unit clause or no conflict)")
    cells = int(rows.indptr[R])

    def launch():
        return ds.dense_sweep(*rows, A, scores, hot)

    ms = kernel_device_ms(launch, 20)
    wrapper_ms = cuda_ms(launch, 20)
    plain_ms = cuda_ms(lambda: ds.sweep_rows_plain(*rows, A, scores, hot),
                       5, 1)
    planes_ms = cuda_ms(
        lambda: ds.sweep_plain(*planes, rows.width, A, scores, hot), 5, 1)
    Pf, Nf = (p[:R].float() for p in planes)
    pos, neg = A.clamp(min=0.0), (-A).clamp(min=0.0)
    mask = torch.ones((B, R), device=A.device)

    def dense_library():
        for lhs, rhs in ((pos, Pf), (neg, Nf), (neg, Pf), (pos, Nf)):
            torch.matmul(lhs, rhs.T)
        for rhs in ((Pf, Nf, Pf, Nf) if scores else (Pf, Nf)):
            torch.matmul(mask, rhs)

    dense_ms = cuda_ms(dense_library, 5, 1)
    del Pf, Nf
    sparse_ms = cuda_ms(sparse_library(planes, A, R, scores), 5, 1)
    outputs = 4 if scores else 2
    adds = int(sum(float(t.sum()) for t in got[:2] + got[3:]))
    bound_ms, bound_by = sweep_bound(R, V, B, cells, outputs, adds)
    log(f"sweep {what} cells={cells}: kernel {ms:.4f} ms (device; "
        f"{wrapper_ms:.4f} ms a call through the wrapper), plain over the "
        f"rows {plain_ms:.4f} ms, sweep_plain over planes {planes_ms:.4f} "
        f"ms, 4+{outputs} f32 matmuls {dense_ms:.4f} ms, 4+{outputs} "
        f"torch.sparse.mm on CSR {sparse_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms (bound by {bound_by}), "
        f"{100 * bound_ms / ms:.1f}% of it; equal to sweep_plain bit for "
        f"bit")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sparse_ms, "library_dense_ms": dense_ms}


def kernel_phase():
    """The sweep kernel over clause rows against ``sweep_plain`` over the
    planes of the same rows, at the check's shape and at the main path's,
    scores on and off and a hot prefix; returns the kernel's JSON entry
    (the check's shape, scores on, every row: the main path's
    configuration)."""
    import torch

    entry = None
    for C, V, B in ((SWEEP_C, SWEEP_V, SWEEP_B), MAIN_SWEEP_SHAPE):
        rows, planes, A = random_sweep_inputs(C, V, B)
        for scores, hot in ((True, None), (False, None), (True, HOT_ROWS)):
            numbers = sweep_case(rows, planes, A, scores, hot)
            if entry is None:
                entry = {
                    "name": "dense_sweep", "route": "cuda",
                    "source": "mythril_tpu_torch/ops/csrc/dense_sweep.cu",
                    "replaces": "mythril_tpu/ops/pallas_prop.py:435",
                    "launches": 0, **numbers,
                }
        del rows, planes, A
        torch.cuda.empty_cache()
    return entry


# ---------------------------------------------------------------------------
# the DPLL step
# ---------------------------------------------------------------------------

#: (B, V, D, decisions) of the step phase's seeded states: the check's
#: shape, the widest BCP-only cone (4 blocks a lane at B = 64), the widest
#: cone with decisions, narrow batches (8 blocks a lane), and B = 7 with
#: 16,384 columns (past 48 KiB of shared memory for a block-a-lane grid)
STEP_SHAPES = ((SWEEP_B, SWEEP_V, 1024, True), (SWEEP_B, 16384, 1, False),
               (SWEEP_B, 8192, 1024, True), (1, SWEEP_V, 1024, True),
               (7, SWEEP_V, 1024, True), (7, 16384, 1024, True))
#: (full_view, hot_gate): a full view, a hot view, a hot view under the gate
STEP_VIEWS = ((True, False), (False, False), (False, True))
#: steps of a whole round in the step phase
STEP_BUDGET = 64


def step_clones(state, outs, flags):
    return ([t.clone() for t in state], [t.clone() for t in outs],
            flags.clone())


def step_compare(what, got, want):
    """Every state field, sweep output and flag of two steps, bit for
    bit; returns the largest absolute difference (0.0)."""
    import torch

    from mythril_tpu_torch.ops.dense_prop import DPLL_STATE_FIELDS

    names = DPLL_STATE_FIELDS + ("fpos", "fneg", "conf", "spos", "sneg")
    (gs, go, gf), (ws, wo, wf) = got, want
    for name, g, w in zip(names, gs + go, ws + wo):
        check(torch.equal(g, w), f"{what}: {name} differs from the plain "
              f"version")
    check(torch.equal(gf, wf), f"{what}: flags {gf.tolist()} != "
          f"{wf.tolist()}")
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(gs + go, ws + wo))


def step_bound(pre, outs, post, decisions):
    """(least ms, what bounds it) of one step: every sweep row read (its
    nonzero cells are zeroed) and the live lanes' A, dflip and dbulk rows
    read once (and lvl where A changes), the scalars read; the cells that
    change and the nonzero sweep cells written once; against a dozen
    operations a live cell at the scalar rate."""
    B, V = pre[0].shape
    D = pre[2].shape[1]
    live = int((pre[7] == 0).sum())
    moved = int((pre[0] != post[0]).any(dim=1).sum())
    planes = 4 if decisions else 2
    read = B * V * planes + B + live * (V + 2 * D) + moved * V + 4 * B
    changed = sum(int((a != b).sum()) for a, b in zip(pre[:10], post[:10]))
    cleared = sum(int((o != 0).sum()) for o in outs)
    return bound(4 * (read + changed + cleared), 12 * live * (V + D))


def planted_round_inputs(C, V, B, seed=0):
    """A planted CNF at the check's sweep shape (rows of 2-8 literals on
    distinct columns >= 2, each satisfied by a hidden assignment; the last
    eighth of the rows bucket padding) and a round's start state: every
    lane assumes 6 random literals (some against the hidden assignment),
    a warm-start plane, the last 4 lanes retired pads.  The clauses come
    as ``sweep_operands`` gives them."""
    import torch

    from mythril_tpu_torch.ops import dense_prop

    rng = np.random.default_rng(seed)
    live = C - C // 8
    widths = rng.integers(2, 9, size=live)
    rows = np.repeat(np.arange(live), widths)
    cols = np.concatenate([
        rng.choice(np.arange(2, V), size=w, replace=False) for w in widths
    ])
    hidden = rng.choice([-1, 1], size=V)
    signs = rng.choice([-1, 1], size=rows.size)
    first = np.concatenate([[0], np.cumsum(widths)[:-1]])
    signs[first] = hidden[cols[first]]
    dev = torch.device(DEVICE)
    width = np.zeros((1, C), np.float32)
    width[0, :live] = widths
    operands = sweep_operands(rows, cols, signs < 0, width, V)
    A0 = np.zeros((B, V), np.float32)
    A0[:, 1] = 1.0
    for lane in range(B):
        picked = rng.choice(np.arange(2, V), size=6, replace=False)
        A0[lane, picked] = rng.choice([-1.0, 1.0], size=6)
    state = dense_prop._dpll_state0(A0, min(dense_prop.MAX_DECISIONS, V),
                                    B - 4, dev)
    state[-1].copy_(torch.from_numpy(
        rng.choice([-1.0, 0.0, 1.0], size=(B, V)).astype(np.float32)))
    return operands, state


def round_device_ops(fn, operands, state, tries=10):
    """Device operations of one round (``fn(*operands, *state)``), from the
    profiler: {name: count} of kernels, copies and fills, and the round's
    steps.  A profile whose sweep and step records differ from the steps
    run is taken again, up to ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import dpll_step as DSTEP

    for _ in range(tries):
        run = [t.clone() for t in state]
        torch.cuda.synchronize()
        ds.reset_launch_count()
        DSTEP.reset_launch_count()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*operands, *run)
            torch.cuda.synchronize()
        steps = DSTEP.launch_count
        ops = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        sweeps = sum(n for k, n in ops.items() if "dense_sweep_kernel" in k)
        kernel = sum(n for k, n in ops.items() if "dpll_step_kernel" in k)
        if sweeps == kernel == steps == ds.launch_count:
            return ops, steps
        log(f"profiler: {sweeps} sweep and {kernel} step records of "
            f"{steps} steps; profiling again")
    raise CheckFailed(f"profiler did not keep a round's records in {tries} "
                      f"runs")


#: the (B, V, D) at which the main path launches dpll_step most (the
#: histogram at the end of the check; the force-dispatched d4 -t 2 and
#: the RESIDENT_KERNEL=0 yardstick launch it there)
MAIN_STEP_SHAPE = (16, 4096, 1024)


def step_ms_at(B, V, D):
    """(device ms, bound ms) of one step on a full view from
    ``frontiers.dpll_step_problem``'s seeded state 0 at (B, V, D)."""
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import dpll_step as DSTEP

    dev = torch.device(DEVICE)
    state, outs = frontiers.dpll_step_problem(B, V, D, True, 0)
    state = [torch.from_numpy(a).to(dev) for a in state]
    outs = [torch.from_numpy(a).to(dev) for a in outs]
    flags = torch.tensor([4, 6], dtype=torch.int32, device=dev)
    work = step_clones(state, outs, flags)

    def launch():
        for dst, src in zip(work[0] + work[1] + [work[2]],
                            state + outs + [flags]):
            dst.copy_(src)
        DSTEP.dpll_step(*work, 9, True, False, True)

    ms = kernel_device_ms(launch, 20, kernel="dpll_step_kernel")
    launch()
    torch.cuda.synchronize()
    return ms, step_bound(state, outs, work[0], True)[0]


def dpll_step_phase():
    """The step kernel against ``dpll_step_plain`` on the card, bit for
    bit: seeded states (``frontiers.dpll_step_problem``) at the
    ``STEP_SHAPES``, on every view, until every transition of
    ``STEP_EVENTS`` showed; whole rounds
    of ``make_dense_rounds`` on a planted CNF at the check's sweep shape,
    tiered and not, against the same round with the plain step; the
    device operations of one round; device ms, plain ms and the bound at
    the check's shape.  Returns the kernel's JSON entry."""
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import dense_prop
    from mythril_tpu_torch.ops import dpll_step as DSTEP

    dev = torch.device(DEVICE)
    seen = dict.fromkeys(DSTEP.STEP_EVENTS, 0)
    err = 0.0
    timed = None
    for B, V, D, decisions in STEP_SHAPES:
        for seed in (0, 1):
            state, outs = frontiers.dpll_step_problem(B, V, D, decisions,
                                                      seed)
            state = [torch.from_numpy(a).to(dev) for a in state]
            outs = [torch.from_numpy(a).to(dev) for a in outs]
            for full_view, hot_gate in (STEP_VIEWS if decisions
                                        else STEP_VIEWS[:2]):
                flags = torch.tensor([4, 6], dtype=torch.int32, device=dev)
                for name, n in DSTEP.step_events(state, outs, full_view,
                                                 hot_gate).items():
                    seen[name] += n
                got = step_clones(state, outs, flags)
                want = step_clones(state, outs, flags)
                DSTEP.dpll_step(*got, 9, full_view, hot_gate, True)
                torch.cuda.synchronize()
                DSTEP.dpll_step_plain(*want, 9, full_view, hot_gate, True)
                err = max(err, step_compare(
                    f"dpll_step B={B} V={V} D={D} seed {seed} view "
                    f"{full_view}/{hot_gate}", got, want))
                if (B, V, D, seed, full_view) == (SWEEP_B, SWEEP_V, 1024, 0,
                                                  True):
                    timed = (state, outs, flags)
    clusters = {f"B={B} V={V}": DSTEP.cluster_size(B, V)
                for B, V, _, _ in STEP_SHAPES}
    log(f"dpll_step seeded states: {len(STEP_SHAPES)} shapes x 2 seeds x "
        f"views, every field equal bit for bit; blocks a lane {clusters}; "
        f"transitions {seen}")
    missing = [k for k, n in seen.items() if not n]
    check(not missing, f"dpll_step: no case showed {missing}")

    # whole rounds at the check's sweep shape, kernel step against plain
    operands, state0 = planted_round_inputs(SWEEP_C, SWEEP_V, SWEEP_B)
    # untiered, at the default tier period, and at the tuner's edges
    for hot_c, period in ((0, 1), (HOT_ROWS, 8), (HOT_ROWS, 2),
                          (HOT_ROWS, 32)):
        fn = dense_prop.make_dense_rounds(
            SWEEP_C, SWEEP_V, SWEEP_B, STEP_BUDGET, dense_prop.CUDA_TIER,
            dense_prop.MAX_DECISIONS, hot_c, period)
        got = fn(*operands, *[t.clone() for t in state0])
        real = dense_prop.dpll_step
        dense_prop.dpll_step = DSTEP.dpll_step_plain
        try:
            want = fn(*operands, *[t.clone() for t in state0])
        finally:
            dense_prop.dpll_step = real
        check(got[-1] == want[-1] > 0, f"round steps {got[-1]} vs "
              f"{want[-1]}")
        for name, g, w in zip(dense_prop.DPLL_STATE_FIELDS, got[:-1],
                              want[:-1]):
            check(torch.equal(g, w), f"round (hot_c={hot_c}): {name} "
                  f"differs from the plain step's round")
        st = got[dense_prop._STATUS_IDX][:, 0].tolist()
        log(f"dpll_step round C={SWEEP_C} V={SWEEP_V} B={SWEEP_B} hot rows "
            f"{hot_c or 'none'} period {period}: {got[-1]} steps, status "
            f"{ {k: st.count(k) for k in sorted(set(st))} }, depth max "
            f"{int(got[6].max())}, every field equal to the plain step's "
            f"round bit for bit")
        if not hot_c:
            ops, steps = round_device_ops(fn, operands, state0)
            total = sum(ops.values())
            other = total - 2 * steps
            others = "; ".join(
                f"{n} x {k[:90]}" for k, n in sorted(ops.items())
                if "dense_sweep_kernel" not in k
                and "dpll_step_kernel" not in k)
            log(f"dpll_step round device ops: {total} for {steps} steps "
                f"({steps} sweeps, {steps} steps, {other} others: "
                f"{others})")
            check(other <= 6 + steps // dense_prop.SYNC_EVERY,
                  f"a round's step is more than two device operations "
                  f"({other} others in {steps} steps)")

    # times at the check's shape: each launch from the same seeded state
    state, outs, flags = timed
    work = step_clones(state, outs, flags)

    def restore():
        for dst, src in zip(work[0] + work[1] + [work[2]],
                            state + outs + [flags]):
            dst.copy_(src)

    def launch():
        restore()
        DSTEP.dpll_step(*work, 9, True, False, True)

    ms = kernel_device_ms(launch, 20, kernel="dpll_step_kernel")
    main_ms = step_ms_at(*MAIN_STEP_SHAPE)
    plain_ms = 0.0
    for _ in range(5):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        DSTEP.dpll_step_plain(*work, 9, True, False, True)
        stop.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(stop) / 5
    restore()
    DSTEP.dpll_step(*work, 9, True, False, True)
    bound_ms, bound_by = step_bound(state, outs, work[0], True)
    log(f"dpll_step B={SWEEP_B} V={SWEEP_V} D=1024 full view: kernel "
        f"{ms:.4f} ms (device, {DSTEP.cluster_size(SWEEP_B, SWEEP_V)} "
        f"blocks a lane), plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}), {100 * bound_ms / ms:.1f}% of the bound; at the "
        f"main path's B, V, D = {MAIN_STEP_SHAPE}: kernel {main_ms[0]:.4f} "
        f"ms ({DSTEP.cluster_size(*MAIN_STEP_SHAPE[:2])} blocks a lane), "
        f"bound {main_ms[1]:.6f} ms, {100 * main_ms[1] / main_ms[0]:.1f}% "
        f"of the bound")
    return {
        "name": "dpll_step", "route": "cuda",
        "source": "mythril_tpu_torch/ops/csrc/dpll_step.cu",
        "replaces": "mythril_tpu/ops/pallas_prop.py:592",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


# ---------------------------------------------------------------------------
# the frontier kernels
# ---------------------------------------------------------------------------

#: what each frontier kernel replaces in the JAX package
FRONTIER_KERNELS = {
    "scan_rows": "mythril_tpu/ops/frontier.py:257",
    "lane_step": "mythril_tpu/ops/frontier.py:453",
    "round_epilogue": "mythril_tpu/ops/resident.py:355",
}
#: the calls the audit holds besides its sample, by kernel
AUDITED_CASES = {
    "lane_step": "with an active lane in conflict under decisions",
    "round_epilogue": "with learned rows or a pending cascade",
}


def _compare(name, key, gpu, cpu):
    """Every tensor the kernel may write, on the card against the plain
    run on the CPU copy."""
    import torch

    for group in ("lane", "buf"):
        for k, t in getattr(gpu, group).items():
            check(torch.equal(t.cpu(), getattr(cpu, group)[k]),
                  f"{name} {key}: {group}.{k} differs from the plain version")
    for k in ("extra", "ctl"):
        check(torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)),
              f"{name} {key}: {k} differs from the plain version")


def run_checked(name, loop, parity, wrapper):
    """One launch of kernel ``name`` through ``wrapper``, held against
    the plain version on a CPU copy of the loop (copied before the
    launch, which writes in place)."""
    import torch

    from mythril_tpu_torch.ops import frontier_kernels as FK

    cpu = loop.to("cpu")
    FK.PLAIN[name](cpu, parity)
    wrapper(loop, parity)
    torch.cuda.synchronize()
    _compare(name, (tuple(loop.lane["assign"].shape), parity), loop, cpu)


def in_conflict(loop):
    """[B] bool: the lanes that are active and in conflict under a
    decision (the lane step backtracks them and may learn), from the
    scan's outputs."""
    return ((loop.buf["conflict"] != 0) & (loop.lane["depth"] > 0)
            & (loop.lane["status"] == 0))


def audited_case(name, loop, parity):
    """Whether this call of ``name`` is one the audit always holds (see
    AUDITED_CASES); reads a few flags back from the card."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    if name not in AUDITED_CASES or int(loop.ctl[parity, FK.HALT]):
        return False
    if name == "lane_step":
        case = in_conflict(loop)
    else:
        case = ((loop.buf["okl"] != 0)
                | ((loop.buf["flags"] & FK.FLAG_CASCADE) != 0))
    return bool(case.any())


class FrontierAudit:
    """Stands in for the three frontier wrappers that
    ``frontier_kernels.run_iterations`` calls, and holds each kernel
    against its plain version on the main path's own inputs: on every
    call of AUDITED_CASES (a lane step that may learn, an epilogue that
    appends or cascades) and on the 1st, 2nd, 4th, 8th ... call of each
    (kernel, B, V1, C), it copies the loop to the CPU before the launch,
    runs the plain version there and compares every output.  It
    launches no kernel of its own."""

    def __init__(self):
        self.calls = {}
        self.checked = {}
        self.cases = {}
        self.seconds = 0.0
        self.real = {}

    def __enter__(self):
        from mythril_tpu_torch.ops import frontier_kernels as FK

        for name in FRONTIER_KERNELS:
            self.real[name] = getattr(FK, name)
            setattr(FK, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        from mythril_tpu_torch.ops import frontier_kernels as FK

        for name, fn in self.real.items():
            setattr(FK, name, fn)

    def _wrap(self, name):
        real = self.real[name]

        def audited(loop, parity):
            B, V1 = loop.lane["assign"].shape
            key = (name, B, V1, loop.lits.shape[0])
            n = self.calls[key] = self.calls.get(key, 0) + 1
            started = time.perf_counter()
            case = audited_case(name, loop, parity)
            if case or not n & (n - 1):
                run_checked(name, loop, parity, real)
                self.checked[key] = self.checked.get(key, 0) + 1
                self.cases[key] = self.cases.get(key, 0) + int(case)
            else:
                real(loop, parity)
            self.seconds += time.perf_counter() - started

        return audited

    def summary(self):
        parts = []
        for k in sorted(self.calls):
            line = (f"{k[0]} B={k[1]} V1={k[2]} rows={k[3]}: "
                    f"{self.checked.get(k, 0)} of {self.calls[k]} calls equal "
                    f"bit for bit")
            if k[0] in AUDITED_CASES:
                line += f" ({self.cases.get(k, 0)} {AUDITED_CASES[k[0]]})"
            parts.append(line)
        return "; ".join(parts)


def learning_loop(C, V1, B, E, prefill, fan=None, period=None):
    """``frontiers.learning_problem`` on the card as a resident loop at
    the default knobs (or ``fan`` / ``period``), its shared pool
    prefilled with ``prefill`` rows."""
    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import resident as RK

    rows, assign, extra = frontiers.learning_problem(C, V1, B, E,
                                                     prefill=prefill)
    state = RK.resident_state0(assign, B, 256, extra_cap=E)
    return resident_loop(rows, state, extra, prefill, fan, period)


def resident_loop(rows, state, extra, ne, fan=None, period=None):
    """A resident loop at the default knobs (or ``fan`` / ``period``) on
    the card: pool ``rows``, lane ``state`` (numpy), shared pool
    ``extra`` with ``ne`` live rows."""
    import torch

    from mythril_tpu_torch.ops import frontier as FR
    from mythril_tpu_torch.ops import frontier_kernels as FK
    from mythril_tpu_torch.ops import resident as RK

    dev = torch.device(DEVICE)
    V1 = state["assign"].shape[1]
    cfg = FK.StepConfig(fan=fan or FR.DEFAULT_FAN,
                        period=period or FR.DEFAULT_PERIOD,
                        limit=RK.resident_budget(),
                        watchdog=RK.resident_watchdog_limit(),
                        extra_cap=extra.shape[0] - 1, learn_cap=FR.LEARN_CAP,
                        uip_iters=FR.UIP_ITERS, resident=True)
    adj = FR.build_adjacency(rows, V1, deg=FR.DEFAULT_DEG)
    return FK.make_loop(torch.from_numpy(rows).to(dev),
                        torch.from_numpy(adj).to(dev),
                        FK.to_device(state, FR.FRONTIER_STATE_FIELDS, dev),
                        cfg, torch.from_numpy(extra).to(dev), nextra0=ne)


def digest(loop) -> str:
    """A digest of a loop's inputs: two launches from equal digests are
    the same launch."""
    h = hashlib.sha1()
    for group in (loop.lane, loop.buf):
        for k in sorted(group):
            h.update(group[k].cpu().numpy().tobytes())
    for t in (loop.extra, loop.ctl):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _restore(loop, snap):
    for group in ("lane", "buf"):
        for k, v in getattr(snap, group).items():
            getattr(loop, group)[k].copy_(v)
    for k in ("extra", "ctl"):
        getattr(loop, k).copy_(getattr(snap, k))


def _smem_check(loop):
    """The library's shared-memory sizes and the scan's and lane step's
    cluster sizes for the loop's launches equal
    ``frontier_kernels.smem_layout``'s (the Python side's limit check)."""
    import ctypes

    from mythril_tpu_torch.ops import frontier_kernels as FK

    B, V1 = loop.lane["assign"].shape
    layout = FK.smem_layout(B, V1, loop.args.fan, loop.cfg.uip_iters,
                            loop.args.E)
    args = ctypes.byref(loop.args)
    got = {name: FK._lib.frontier_smem_bytes(args, kid)
           for name, kid in FK.KERNEL_IDS.items()}
    got["cluster"] = FK._lib.frontier_scan_cluster(args)
    got["lane_cluster"] = FK._lib.frontier_lane_cluster(args)
    check(all(got[k] == layout[k] for k in got),
          f"shared memory: library {got} != smem_layout {layout}")
    return layout


def frontier_kernel_phase():
    """The three frontier kernels vs their plain versions, iteration by
    iteration, on ``frontiers.learning_problem`` at the resident
    solver's caps until every learning case has been held; then two
    iterations at the union-cone tier's largest V1.  Returns the
    kernels' JSON entries."""
    import torch

    from mythril_tpu_torch.ops import frontier as FR
    from mythril_tpu_torch.ops import frontier_kernels as FK

    check(FR.DEFAULT_FAN * FR.DEFAULT_DEG == 512, "fan x deg is not 512")
    dev = torch.device(DEVICE)
    loop = learning_loop(FRONTIER_C, FRONTIER_V1, FRONTIER_B, FRONTIER_E,
                         FRONTIER_PREFILL)
    C, E = FRONTIER_C, FRONTIER_E
    cases = dict.fromkeys((
        "conflicts under decisions in 2+ lanes", "a conflict on a shared row",
        "learned rows in 2+ lanes", "equal rows from twin lanes",
        "a shared row learned again", "a pool overflow", "a cascade",
        "learned rows and a cascade in one epilogue"), 0)
    # which call of each kernel is timed: (scan: view) or a case
    timing = {("scan_rows", "full"), ("scan_rows", "gather"),
              ("lane_step", "learned rows in 2+ lanes"),
              ("round_epilogue", "learned rows and a cascade in one epilogue")}
    entries = {}
    iterations = 0
    for it in range(FRONTIER_ITERS):
        parity = it & 1
        if int(loop.ctl[parity, FK.HALT]):
            break
        iterations += 1
        full = bool(int(loop.ctl[parity, FK.FULL]))
        ne = int(loop.ctl[parity, FK.NEXTRA])
        for name in FRONTIER_KERNELS:
            snap = loop.to(dev)
            run_checked(name, loop, parity, getattr(FK, name))
            lane, buf = loop.lane, loop.buf
            hit = set()
            if name == "scan_rows":
                conf = in_conflict(loop)
                if int(conf.sum()) >= 2:
                    hit.add("conflicts under decisions in 2+ lanes")
                if bool((conf & (buf["crow"] >= C)).any()):
                    hit.add("a conflict on a shared row")
                hit.add("full" if full else "gather")
            elif name == "lane_step":
                if int((buf["okl"] != 0).sum()) >= 2:
                    hit.add("learned rows in 2+ lanes")
            else:
                okl = snap.buf["okl"] != 0
                learned = [tuple(r) for r in snap.buf["litrow"][okl].tolist()]
                pool = {tuple(r) for r in snap.extra[:ne].tolist()}
                fresh = set(learned) - pool
                cascade = bool(((snap.buf["flags"] & FK.FLAG_CASCADE)
                                != 0).any())
                if len(set(learned)) < len(learned):
                    hit.add("equal rows from twin lanes")
                if set(learned) & pool:
                    hit.add("a shared row learned again")
                if ne + len(fresh) > E:
                    hit.add("a pool overflow")
                if cascade:
                    hit.add("a cascade")
                if learned and cascade:
                    hit.add("learned rows and a cascade in one epilogue")
            for case in hit & cases.keys():
                cases[case] += 1
            for what in sorted(hit):
                if (name, what) in timing:
                    timing.discard((name, what))
                    entry = time_frontier_kernel(name, what, loop, snap,
                                                 parity, full)
                    if name not in entries or what == "full":
                        entries[name] = entry
        if all(cases.values()) and not timing:
            break
    log(f"frontier kernels vs plain on the learning problem (C={C} "
        f"V1={FRONTIER_V1} B={FRONTIER_B} E={E}, {FRONTIER_PREFILL} rows "
        f"prefilled): {iterations} iterations, every launch equal bit for "
        f"bit; iterations with " + ", ".join(
            f"{case}: {n}" for case, n in cases.items()))
    check(all(cases.values()) and not timing,
          f"the learning problem missed a case: {cases}, untimed {timing}")
    layout = _smem_check(loop)
    check(layout["cluster"] == 2, f"V1=8193, B=64: cluster {layout}")

    wide = learning_loop(FRONTIER_C, FRONTIER_WIDE_V1, FRONTIER_B, E,
                         FRONTIER_PREFILL)
    views = []
    for it in range(2):
        views.append("full" if int(wide.ctl[it & 1, FK.FULL]) else "gather")
        for name in FRONTIER_KERNELS:
            run_checked(name, wide, it & 1, getattr(FK, name))
    layout = _smem_check(wide)
    check(layout["cluster"] == 2 and views == ["full", "gather"],
          f"V1={FRONTIER_WIDE_V1}: {layout}, views {views}")
    log(f"frontier kernels vs plain at V1={FRONTIER_WIDE_V1} (the scan's "
        f"planes split over a cluster of {layout['cluster']}; shared memory "
        f"{layout}): a full and a gather iteration, every launch equal bit "
        f"for bit")
    return [entries[name] for name in FRONTIER_KERNELS]


#: the frontier solvers' knobs at the autopilot tuner's edge values
#: (``autopilot/tuner.py`` KNOBS: fan 4..64, period 2..32), and the
#: iterations of the learning problem each is held for
TUNER_EDGES = ((4, 8), (24, 8), (64, 8), (16, 2), (16, 32))
TUNER_EDGE_ITERS = 8


def tuner_edges_phase():
    """The three frontier kernels vs their plain versions on the learning
    problem at each (fan, period) of ``TUNER_EDGES``, iteration by
    iteration, with the library's shared memory checked against
    ``smem_layout`` at each fan."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    held = []
    for fan, period in TUNER_EDGES:
        loop = learning_loop(FRONTIER_C, FRONTIER_V1, FRONTIER_B,
                             FRONTIER_E, FRONTIER_PREFILL, fan, period)
        views = {"full": 0, "gather": 0}
        iterations = 0
        for it in range(TUNER_EDGE_ITERS):
            parity = it & 1
            if int(loop.ctl[parity, FK.HALT]):
                break
            iterations += 1
            views["full" if int(loop.ctl[parity, FK.FULL])
                  else "gather"] += 1
            for name in FRONTIER_KERNELS:
                run_checked(name, loop, parity, getattr(FK, name))
        layout = _smem_check(loop)
        check(iterations > 1 and loop.cfg.fan == fan
              and loop.cfg.period == period,
              f"fan {fan} period {period}: {iterations} iterations, "
              f"launched at fan {loop.cfg.fan} period {loop.cfg.period}")
        held.append(f"fan {fan} period {period}: {iterations} iterations "
                    f"({views['full']} full, {views['gather']} gather "
                    f"views), scan block {layout['scan_rows']} B")
    log("frontier kernels vs plain at the tuner's edges (C="
        f"{FRONTIER_C} V1={FRONTIER_V1} B={FRONTIER_B}), every launch "
        "equal bit for bit: " + "; ".join(held))


#: the lane step's shapes on the learning problem: (V1, B) of the chip
#: check, the guard chain, the widest cone bucket, and the commonest of
#: scale_mul d6 -t 1
LANE_SHAPES = ((8193, 64), (2049, 64), (16385, 64), (4097, 8))
#: links of the chain whose first-UIP walk takes 2 N - 1 resolutions
CHAIN_LINKS = 30
#: the lane step's cases: on the learning problem, and on the case launch
LANE_CASES = ("learning in 2+ lanes", "a walk that reaches uip_iters",
              "a walk whose pivot is a decision", "a backtrack", "a force",
              "a decision", "a bail", "SAT completion")


def lane_case_loop(V1, B):
    """A lane-step launch on the learning problem after iteration 0's
    scan (a full view), its lanes 0-6 set up for the lane step's cases,
    with clause rows in the pool's zero padding at its end: lane 0 in
    conflict at depth 2 on a chain x_k, z_k of CHAIN_LINKS links at the
    depth (reason of x_k and z_k: (., -x_{k-1}, -z_{k-1}); the walk needs
    2 CHAIN_LINKS - 1 resolutions), lane 1 in conflict with its decision
    as the latest var at the depth (the pivot), lane 2 with one forced
    var, lane 3 quiet and open (a decision), lane 4 quiet at depth D (a
    bail), lane 5 with every var assigned (SAT on a full view), lane 6 in
    conflict at depth 0 (UNSAT).  Returns the loop."""
    import torch

    from mythril_tpu_torch.ops import frontier_kernels as FK

    loop = learning_loop(FRONTIER_C, V1, B, FRONTIER_E, FRONTIER_PREFILL)
    FK.scan_rows(loop, 0)
    lane = {k: v.cpu() for k, v in loop.lane.items()}
    buf = {k: v.cpu() for k, v in loop.buf.items()}
    lits = loop.lits.cpu()
    C = lits.shape[0]
    D = lane["dvar"].shape[1]
    next_row = [C - 1]

    def row(*literals):
        r = next_row[0]
        next_row[0] -= 1
        lits[r] = 0
        lits[r, :len(literals)] = torch.tensor(literals, dtype=torch.int32)
        return r

    def assign(b, v, value, level, reason, tpos):
        lane["assign"][b, v] = value
        lane["lvl"][b, v] = level
        lane["reason"][b, v] = reason
        lane["tpos"][b, v] = tpos

    def decide(b, slots):
        lane["depth"][b] = len(slots)
        lane["dvar"][b] = 0
        lane["dphase"][b] = 0
        lane["dflip"][b] = False
        for d, v in enumerate(slots):
            lane["dvar"][b, d] = v
            lane["dphase"][b, d] = 1
            assign(b, v, 1, d + 1, -1, d + 1)

    def quiet(b):
        for k in ("fpos", "fneg", "rpos", "rneg"):
            buf[k][b] = 0
        buf["conflict"][b] = 0
        buf["crow"][b] = -1

    top = V1 - 1
    # lane 0: the chain at depth 2 over y at depth 1
    y, n = top, CHAIN_LINKS
    x = [None] + [top - 2 * k for k in range(1, n + 1)]
    z = [None] + [top - 2 * k - 1 for k in range(1, n + 1)]
    decide(0, [top - 70, top - 71])
    assign(0, y, 1, 1, -1, 1)
    for k in range(1, n + 1):
        below = (-y,) if k == 1 else (-x[k - 1], -z[k - 1])
        assign(0, x[k], 1, 2, row(x[k], *below), 10 + 2 * k)
        assign(0, z[k], 1, 2, row(z[k], *below), 11 + 2 * k)
    buf["conflict"][0] = 1
    buf["crow"][0] = row(-x[n], -z[n])
    # lane 1: the decision p is the latest var at depth 1
    p, q = top - 80, top - 81
    decide(1, [p])
    lane["tpos"][1, p] = 20
    assign(1, q, 1, 1, 0, 5)
    buf["conflict"][1] = 1
    buf["crow"][1] = row(-p, -q)
    # lane 2: one forced var; lanes 3-5 quiet
    for b in (2, 3, 4, 5):
        quiet(b)
    f = top - 90
    lane["assign"][2, f] = 0
    buf["fpos"][2, f] = 1
    buf["rpos"][2, f] = 8
    lane["depth"][4] = D
    lane["assign"][5, 2:] = 1
    # lane 6: a conflict under no decision
    lane["depth"][6] = 0
    buf["conflict"][6] = 1
    buf["crow"][6] = 1
    lane["status"][:7] = 0
    dev = loop.ctl.device
    loop.lits.copy_(lits.to(dev))
    for k, v in lane.items():
        loop.lane[k].copy_(v.to(dev))
    for k, v in buf.items():
        loop.buf[k].copy_(v.to(dev))
    loop.args = None  # the pool's occurrence counts changed
    return loop


def lane_cases_seen(loop, snap, parity):
    """The cases of LANE_CASES that one lane-step launch held (``snap``
    before it, ``loop`` after), from its outputs: a walk cut at
    uip_iters is one that learns when the plain version may walk four
    times as far; a pivot that is a decision, from the conflict row's
    latest var at the depth."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    before = {k: v.cpu() for k, v in snap.lane.items()}
    after = {k: v.cpu() for k, v in loop.lane.items()}
    okl = loop.buf["okl"].cpu() != 0
    conflict = (snap.buf["conflict"].cpu() != 0) & (before["status"] == 0)
    learners = conflict & (before["depth"] > 0)
    seen = set()
    if int(okl.sum()) >= 2:
        seen.add("learning in 2+ lanes")
    if bool((after["dflip"] & ~before["dflip"]).any()):
        seen.add("a backtrack")  # a decision flipped
    if bool(((after["depth"] == before["depth"] + 1)
             & (before["status"] == 0)).any()):
        seen.add("a decision")
    forced = ((before["assign"] == 0) & (after["assign"] != 0)
              & (after["reason"] >= 0))
    if bool(forced.any()):
        seen.add("a force")
    started = before["status"] == 0
    if bool((started & (after["status"] == 3)).any()):
        seen.add("a bail")
    if bool((started & (after["status"] == 1)).any()):
        seen.add("SAT completion")
    cut = learners & ~okl
    if bool(cut.any()):
        longer = snap.to("cpu")
        longer.cfg = longer.cfg._replace(uip_iters=4 * longer.cfg.uip_iters)
        FK.PLAIN["lane_step"](longer, parity)
        if bool((cut & (longer.buf["okl"] != 0)).any()):
            seen.add("a walk that reaches uip_iters")
    lits, crow = snap.lits.cpu(), snap.buf["crow"].cpu()
    for b in cut.nonzero().flatten().tolist():
        vs = [abs(int(l)) for l in lits[int(crow[b])] if int(l)]
        depth = int(before["depth"][b])
        at = [v for v in vs if int(before["lvl"][b, v]) == depth
              and int(before["assign"][b, v]) != 0]
        if len(at) > 1:
            pivot = max(at, key=lambda v: (int(before["tpos"][b, v]), -v))
            if int(before["reason"][b, pivot]) < 0:
                seen.add("a walk whose pivot is a decision")
    return seen


def lane_step_phase():
    """``lane_step`` against its plain version, bit for bit, at every
    shape of LANE_SHAPES: the learning problem's launches with 2+ lanes
    in conflict under decisions, up to the first in which 2+ lanes learn
    (the others are held by the frontier kernel phase), then the case
    launch of
    :func:`lane_case_loop` on a full and on a gather view (the lanes that
    decide or bail there with an empty queue); fails if a case of
    LANE_CASES is missing at a shape, or a cluster size differs from
    ``smem_layout``'s."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    lines = []
    for V1, B in LANE_SHAPES:
        seen = set()
        loop = learning_loop(FRONTIER_C, V1, B, FRONTIER_E, FRONTIER_PREFILL)
        launches = 0
        for it in range(FRONTIER_ITERS):
            parity = it & 1
            if int(loop.ctl[parity, FK.HALT]) or (
                    "learning in 2+ lanes" in seen):
                break
            FK.scan_rows(loop, parity)
            if int(in_conflict(loop).sum()) >= 2:  # lanes that may learn
                snap = loop.to(loop.ctl.device)
                run_checked("lane_step", loop, parity, FK.lane_step)
                launches += 1
                seen |= lane_cases_seen(loop, snap, parity)
            else:
                FK.lane_step(loop, parity)
            FK.round_epilogue(loop, parity)
        for full in (1, 0):
            case = lane_case_loop(V1, B)
            case.ctl[0, FK.FULL] = full
            if not full:
                case.lane["recent"][3:5] = False
            snap = case.to(case.ctl.device)
            run_checked("lane_step", case, 0, FK.lane_step)
            launches += 1
            seen |= lane_cases_seen(case, snap, 0)
        layout = _smem_check(case)
        missing = [c for c in LANE_CASES if c not in seen]
        check(not missing, f"lane_step at V1={V1} B={B}: cases missing "
              f"{missing}")
        lines.append(f"V1={V1} B={B} (cluster of {layout['lane_cluster']}): "
                     f"{launches} launches")
    log("frontier lane_step vs plain on the learning problem and the case "
        "launch (C=16384), every launch equal bit for bit, every case held ("
        + ", ".join(LANE_CASES) + "): " + "; ".join(lines))


def synthetic_loop(B, V1, C, E, ne, seed):
    """A resident loop on random data from a numpy seed: 3-clause rows
    over vars 2 .. V1 - 1 (row 0 the TRUE anchor's unit, the last eighth
    padding), even lanes with a third of the vars assigned and odd lanes
    with two thirds (most rows open, and most rows closed),
    about one var in a hundred queued, ``ne`` live rows in a shared pool
    of ``E``.  Returns the loop and the generator, for more inputs."""
    from mythril_tpu_torch.ops import resident as RK

    rng = np.random.default_rng(seed)

    def clauses(n):
        return (rng.integers(2, V1, size=(n, 3))
                * rng.choice([-1, 1], size=(n, 3))).astype(np.int32)

    rows = np.zeros((C, 8), np.int32)
    rows[0, 0] = 1
    rows[1:C - C // 8, :3] = clauses(C - C // 8 - 1)
    dense = (np.arange(B) % 2 + 1)[:, None] / 3
    assign = np.where(rng.random((B, V1)) < dense,
                      rng.choice(np.array([-1, 1], np.int8), size=(B, V1)),
                      np.int8(0)).astype(np.int8)
    assign[:, 0] = 0
    assign[:, 1] = 1
    state = RK.resident_state0(assign, B, 256, extra_cap=E)
    state["recent"] = rng.random((B, V1)) < 0.01
    state["extra"][:ne, :3] = clauses(ne)
    return resident_loop(rows, state, state["extra"], ne), rng


def set_epilogue_inputs(loop, rng, learners, rows, cascades):
    """The lane step's outputs that the epilogue reads: lanes ``learners``
    emit ``rows`` (okl set), lanes ``cascades`` have a pending cascade,
    every lane random progress and queue bits, depth and stamp."""
    import torch

    from mythril_tpu_torch.ops import frontier_kernels as FK

    B = loop.lane["assign"].shape[0]
    dev = loop.ctl.device
    okl = torch.zeros(B, dtype=torch.int32)
    litrow = torch.zeros((B, FK.WIDTH), dtype=torch.int32)
    for j, row in zip(learners, rows):
        okl[j] = 1
        litrow[j] = torch.as_tensor(row, dtype=torch.int32)
    flags = torch.from_numpy(rng.integers(
        0, 4, size=B).astype(np.int32))
    flags[list(cascades)] |= FK.FLAG_CASCADE
    loop.buf["okl"].copy_(okl.to(dev))
    loop.buf["litrow"].copy_(litrow.to(dev))
    loop.buf["flags"].copy_(flags.to(dev))
    loop.lane["depth"].copy_(torch.from_numpy(
        rng.integers(0, 9, size=B).astype(np.int32)).to(dev))
    loop.lane["stamp"].copy_(torch.from_numpy(
        rng.integers(1, 99, size=B).astype(np.int32)).to(dev))


def learned_rows(rng, n, V1):
    """``n`` canonical learned rows: up to 8 distinct vars, descending,
    random signs, zero-padded."""
    out = []
    for _ in range(n):
        width = int(rng.integers(1, 9))
        vs = np.sort(rng.choice(np.arange(2, V1), size=width,
                                replace=False))[::-1]
        row = np.zeros(8, np.int32)
        row[:width] = vs * rng.choice([-1, 1], size=width)
        out.append(row)
    return out


def epilogue_cases(snap, parity, E):
    """The epilogue's edge cases an input holds (``snap`` before the
    launch)."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    ne = int(snap.ctl[parity, FK.NEXTRA])
    okl = snap.buf["okl"].cpu() != 0
    rows = snap.buf["litrow"].cpu()
    learned = [tuple(r) for r in rows[okl].tolist()]
    nonzero = {r for r in learned if any(r)}
    pool = {tuple(r) for r in snap.extra[:ne].tolist()}
    hit = set()
    if ne == 0 and len(nonzero) >= 2:
        hit.add("ne = 0")
    if ne == E - 1 and len(nonzero - pool) >= 2:
        hit.add("ne = E - 1 and an overflow")
    if len(learned) == okl.numel() and len(set(learned)) == 1:
        hit.add("every lane learning the same row")
    if nonzero & pool:
        hit.add("a learned row equal to a live pool row")
    if any(not any(r) for r in learned):
        hit.add("an okl lane with an all-zero row")
    return hit


def frontier_geometry_phase():
    """``scan_rows`` (a gather view, then a full view) and
    ``round_epilogue`` against their plain versions on random data at
    every lane count of GEOMETRY_B by every width of GEOMETRY_V1, and the
    epilogue on each of its edge cases; fails if a geometry or a case is
    missing."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    E = FRONTIER_E
    clusters = {}
    for B in GEOMETRY_B:
        for V1 in GEOMETRY_V1:
            loop, rng = synthetic_loop(B, V1, GEOMETRY_C, E,
                                       FRONTIER_PREFILL, seed=B * V1)
            for full in (0, 1):
                loop.ctl[0, FK.FULL] = full
                run_checked("scan_rows", loop, 0, FK.scan_rows)
            learners = list(range(0, B, 3))
            rows = learned_rows(rng, len(learners), V1)
            if len(rows) > 2:  # twins, and a row of the live pool
                rows[1] = rows[0]
                rows[2] = loop.extra[0].cpu().numpy()
            set_epilogue_inputs(loop, rng, learners, rows, range(0, B, 2))
            run_checked("round_epilogue", loop, 0, FK.round_epilogue)
            clusters[(B, V1)] = _smem_check(loop)["cluster"]
    blocks = [B * S for (B, _), S in clusters.items()]
    check(min(blocks) < 132 < max(blocks)
          and any(V1 % S for (_, V1), S in clusters.items()),
          f"the geometries miss a kind of cluster: {clusters}")

    # the epilogue's edge cases at the guard chain's width
    B, V1 = 64, 2049
    cases = dict.fromkeys((
        "ne = 0", "ne = E - 1 and an overflow",
        "every lane learning the same row",
        "a learned row equal to a live pool row",
        "an okl lane with an all-zero row"), 0)
    for seed, ne in enumerate((0, E - 1, 20, 20, 20)):
        loop, rng = synthetic_loop(B, V1, GEOMETRY_C, E, ne, seed=seed)
        loop.ctl[0, FK.FULL] = 1
        run_checked("scan_rows", loop, 0, FK.scan_rows)
        learners = list(range(0, B, 4))
        rows = learned_rows(rng, len(learners), V1)
        if seed == 2:
            learners = list(range(B))
            rows = [rows[0]] * B
        elif seed == 3:
            rows[3] = loop.extra[ne - 1].cpu().numpy()
        elif seed == 4:
            rows[5][:] = 0
        set_epilogue_inputs(loop, rng, learners, rows, range(1, B, 3))
        snap = loop.to(loop.ctl.device)
        run_checked("round_epilogue", loop, 0, FK.round_epilogue)
        for case in epilogue_cases(snap, 0, E):
            cases[case] += 1
    log(f"frontier scan_rows (gather and full view) and round_epilogue vs "
        f"plain on random data (C={GEOMETRY_C}, E={E}), every launch equal "
        f"bit for bit at B x V1 -> scan cluster: "
        + ", ".join(f"{B}x{V1}->{S}" for (B, V1), S in clusters.items())
        + "; epilogue edge cases at B=64 V1=2049: "
        + ", ".join(f"{case}: {n}" for case, n in cases.items()))
    check(all(cases.values()), f"an epilogue edge case is missing: {cases}")


def time_frontier_kernel(name, what, loop, snap, parity, full):
    """Device time of the launch just checked (replayed from ``snap``),
    its plain version's time on the card and the bound; leaves the loop
    as the checked launch left it.  Returns the kernel's JSON entry."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    after = loop.to(loop.ctl.device)
    wrapper = getattr(FK, name)
    plain = FK.PLAIN[name]

    def launch():
        _restore(loop, snap)
        wrapper(loop, parity)

    ms = kernel_device_ms(launch, 10, f"{name}_kernel")
    restore_ms = cuda_ms(lambda: _restore(loop, snap), 5, 1)
    plain_ms = cuda_ms(lambda: (_restore(loop, snap), plain(loop, parity)),
                       3, 1) - restore_ms
    _restore(loop, after)
    bytes_moved, ops, desc = frontier_work(name, full, snap, after, parity)
    bound_ms, bound_by = bound(bytes_moved, ops)
    B, V1 = loop.lane["assign"].shape
    log(f"frontier {name} ({what}; {'full' if full else 'gather'} view, "
        f"C={loop.lits.shape[0]} V1={V1} B={B} E={loop.cfg.extra_cap} "
        f"fan x deg=512; {desc}; inputs {digest(snap)}): kernel "
        f"{ms:.4f} ms (device), plain "
        f"{plain_ms:.4f} ms (eager torch on the card), bound "
        f"{bound_ms:.4f} ms ({bound_by}), equal bit for bit")
    return {
        "name": name, "route": "cuda",
        "source": "mythril_tpu_torch/ops/csrc/frontier.cu",
        "replaces": FRONTIER_KERNELS[name], "launches": 0,
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def frontier_work(name, full, snap, after, parity):
    """(bytes, integer operations, description) one launch needs on
    these inputs (``snap`` before it, ``after`` after it): each input
    read once and each output written once."""
    B, V1 = snap.lane["assign"].shape
    K = 8
    ne = int(snap.ctl[parity, 4])
    plane = B * V1
    if name == "scan_rows":
        if full:
            scanned = snap.lits.shape[0]
            row_bytes = snap.lits.numel() * 4
        else:
            per_lane = snap.lane["recent"][:, 1:].sum(dim=1).clamp(max=16)
            scanned_rows = int(per_lane.sum()) * snap.adj.shape[1]
            scanned = scanned_rows / B
            row_bytes = scanned_rows * (K * 4 + 4)
        # assignment read, queues read or cleared, six planes written
        bytes_moved = (row_bytes + ne * K * 4 + plane + plane
                       + 6 * plane * 4 + 2 * B * 4)
        ops = int(B * (scanned + ne) * K * 2)
        return bytes_moved, ops, f"{scanned:.0f} rows a lane + {ne} pool rows"
    flags = after.buf["flags"]
    if name == "lane_step":
        acting = int(((flags & 1) != 0).sum())
        learned = int((after.buf["okl"] != 0).sum())
        # reads: assign and recent of every var, the votes, scores and
        # pref of the open vars of quiet lanes (on a full view the scores
        # of every var, which it writes to cspos and csneg), the reason
        # rows of the forced vars, the decision stacks of the lanes in
        # conflict, the lane's scalars; writes: every entry it changes
        A = snap.lane["assign"]
        quiet = (snap.lane["status"] == 0) & (snap.buf["conflict"] == 0)
        free = (A == 0) & quiet[:, None]
        free[:, :2] = False
        forced = free & ((snap.buf["fpos"] > 0) | (snap.buf["fneg"] > 0))
        stacks = int((snap.buf["conflict"] != 0).sum()) * snap.lane[
            "dvar"].shape[1] * 6
        changed = sum(
            int((snap.lane[k] != after.lane[k]).sum())
            * snap.lane[k].element_size()
            for k in ("assign", "lvl", "reason", "tpos", "recent", "dvar",
                      "dphase", "dflip", "learned"))
        bytes_moved = (plane * 2 + int(free.sum()) * (4 + 4 + 1)
                       + (plane * 16 if full else int(free.sum()) * 8)
                       + int(forced.sum()) * 8 + stacks + B * 10 * 4
                       + changed + B * K * 4)
        before = (plane * (1 + 1 + 4 + 4 + 8) + (plane * 8 if full else 0)
                  + acting * V1 * (1 + 4 + 4 + 4 + 1 + 8) + B * 6 * 4)
        return bytes_moved, plane * 8, (
            f"{acting} lanes acting, {learned} learning; with every acting "
            f"lane's planes written, as counted before, the bound is "
            f"{bound(before, plane * 8)[0]:.4f} ms")
    pending = int(((flags & 4) != 0).sum())
    learned = int((snap.buf["okl"] != 0).sum())
    # reads: learned rows, okl, flags, status, the live pool, each pending
    # lane's assign, spos and sneg, the control row; writes: the settled
    # vars' assign, lvl, reason and tpos, the appended rows, the next row
    settled = int(((snap.lane["assign"] == 0)
                   & (after.lane["assign"] != 0)).sum())
    appended = int(after.ctl[1 - parity, 4]) - ne
    reads = (B * (K * 4 + 3 * 4) + ne * K * 4 + pending * V1 * (1 + 4 + 4)
             + 2 * 8 * 4)
    bytes_moved = reads + settled * (1 + 4 + 4 + 4) + appended * K * 4
    ops = B * (ne + B) * K + pending * V1 * 4
    uncounted, _ = bound(reads, ops)
    return bytes_moved, ops, \
        (f"{learned} learned rows, {appended} appended, {pending} cascades "
         f"settling {settled} vars; without their writes, as counted "
         f"before, the bound is {uncounted:.4f} ms")


# ---------------------------------------------------------------------------
# the round lane
# ---------------------------------------------------------------------------

#: the round lane's shapes (label, C, V1, B): the full-pool gather tier at
#: its caps (the prefetch's one-shot solve), a union-cone tier shape, and
#: the full pool at 8, 32 and 256 lanes (clusters of 8, 4 and 1 blocks a
#: lane beside the 2 of 64 lanes)
ROUND_SHAPES = (("full pool", 16384, 8193, 64), ("cone tier", 16384, 2049, 64),
                ("8 lanes", 16384, 8193, 8), ("32 lanes", 16384, 8193, 32),
                ("256 lanes", 16384, 8193, 256))
#: the ladder's round budgets and the one-shot solve's
ROUND_BUDGETS = (64, 256, 512, 768)
#: the budget at which the plain model of the skip record runs on the
#: full pool (it must see a backtrack clear a record)
SKIP_MODEL_BUDGET = 64


def round_lane_inputs(C, V1, B):
    """``frontiers.learning_problem`` as a round-lane state on the card:
    its lanes decide, conflict and backtrack, and at V1 = 8193 bail when
    the 256-slot stack fills; the last lane's anchor is false (UNSAT at
    zero decisions), the one before it a pad lane (status 3)."""
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import round_lane as RL
    from mythril_tpu_torch.ops.batched_sat import GATHER_DECISIONS

    rows, assign, _ = frontiers.learning_problem(C, V1, B, 64)
    assign[B - 1, 1] = -1
    assign[B - 2] = 1
    state = RL.initial_state(torch.from_numpy(assign).to(DEVICE),
                             GATHER_DECISIONS)
    state["status"][B - 2] = 3
    return torch.from_numpy(rows).to(DEVICE), state


def round_lane_work(C, V1, B, D, before, after):
    """(bytes, operations, description) of one round on these inputs:
    the pool read once and the state read and written once; one
    operation for each literal cell and each var of every sweep the
    lanes took (the loop rescans the pool every sweep)."""
    steps = int((after["step"] - before["step"]).sum())
    bytes_moved = C * 8 * 4 + B * V1 * (1 + 4) * 2 + B * V1 \
        + B * D * (4 + 1 + 1) * 2 + 3 * B * 4 * 2
    return bytes_moved, steps * (C * 8 + V1), f"{steps} lane sweeps"


def round_lane_phase():
    """The round-lane kernel against ``round_lane_plain`` at every shape
    of ROUND_SHAPES and budget of ROUND_BUDGETS, every field equal bit
    for bit; fails unless some lane backtracked, bailed, and went UNSAT,
    every cluster size of the shapes (1, 2, 4, 8 blocks a lane) ran
    bit-equal, and the plain model of the kernel's skip record
    (``round_lane.skip_record_model``) on the full pool saw a backtrack
    clear a record with every scan equal to the full one and every
    deciding sweep's scores equal to the occurrence count.  Returns the
    kernel's JSON entry (the full pool at the one-shot budget, the
    prefetch's solve)."""
    import torch

    from mythril_tpu_torch.ops import round_lane as RL

    entry = None
    seen = {"backtrack": 0, "bail": 0, "unsat": 0, "budget spent": 0,
            "cluster 1": 0, "cluster 2": 0, "cluster 4": 0, "cluster 8": 0}
    for label, C, V1, B in ROUND_SHAPES:
        lits, state = round_lane_inputs(C, V1, B)
        D = state["dvar"].shape[1]
        S = RL.cluster_size(B, C, V1, D)
        for budget in ROUND_BUDGETS:
            got = RL.round_lane(lits, state, budget)
            torch.cuda.synchronize()
            started = time.perf_counter()
            want = RL.round_lane_plain(lits, state, budget)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - started) * 1e3
            for k in RL.ROUND_STATE_FIELDS:
                check(torch.equal(got[k], want[k]),
                      f"round_lane {label} budget {budget}: {k} differs "
                      f"from the plain version")
            status = got["status"]
            seen["backtrack"] += int(got["dflip"].any(dim=1).sum())
            seen["bail"] += int((status == 3).sum()) - 1
            seen["unsat"] += int((status == 2).sum())
            seen["budget spent"] += int((got["step"] == budget).sum())
            seen[f"cluster {S}"] += 1

            def launch():
                return RL.round_lane(lits, state, budget)

            ms = kernel_device_ms(launch, 5, "round_lane_kernel")
            bytes_moved, ops, desc = round_lane_work(C, V1, B, D, state, got)
            bound_ms, bound_by = bound(bytes_moved, ops)
            slowest = int(got["step"].max())
            log(f"round_lane {label} C={C} V1={V1} B={B} budget {budget} "
                f"(cluster {S}; {desc}; status counts "
                f"{torch.bincount(status, minlength=4).tolist()}): kernel "
                f"{ms:.4f} ms (device; {ms * 1e3 / max(slowest, 1):.2f} us "
                f"a sweep of the slowest lane's {slowest}; "
                f"{bound_ms / ms:.2%} of the bound), plain {plain_ms:.4f} ms "
                f"(eager torch on the card, host clock), bound "
                f"{bound_ms:.4f} ms ({bound_by}), equal bit for bit")
            if label == "full pool" and budget == 768:
                entry = {
                    "name": "round_lane", "route": "cuda",
                    "source": "mythril_tpu_torch/ops/csrc/round_lane.cu",
                    "replaces": "mythril_tpu/ops/batched_sat.py:468",
                    "launches": 0, "max_abs_err": 0.0, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None,
                }
    lits, state = round_lane_inputs(*ROUND_SHAPES[0][1:])
    started = time.perf_counter()
    _, counts = RL.skip_record_model(lits, state, SKIP_MODEL_BUDGET)
    log(f"round_lane skip record (plain model, full pool, budget "
        f"{SKIP_MODEL_BUDGET}, {time.perf_counter() - started:.1f} s): "
        f"{counts}")
    seen["skip record cleared by a backtrack"] = counts["invalidated"]
    check(counts["differs"] == 0 and counts["score_differs"] == 0,
          f"round_lane: a scan without the recorded rows differs from the "
          f"full scan, or the scores from the occurrence count: {counts}")
    log(f"round_lane cases held: {seen}")
    check(all(seen.values()), f"round_lane: a case never held: {seen}")
    return entry


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def cdcl_unsat(build, lane_ids):
    """The port's own CDCL, in a fresh context, on the given lanes."""
    from mythril_tpu_torch.native import SatSolver
    from mythril_tpu_torch.smt.solver import (
        get_blast_context, reset_blast_context,
    )

    reset_blast_context()
    lanes, _ = build()
    ctx = get_blast_context()
    return [ctx.check([c.raw for c in lanes[i]])[0] == SatSolver.UNSAT
            for i in lane_ids]


class SweepAudit:
    """Stands in for the sweep that ``dense_prop`` calls and holds the
    kernel against ``sweep_plain`` on the main path's own inputs: after
    the 1st, 2nd, 4th, 8th ... call of each (C, V, B, rows, scores) it
    compares the kernel's outputs with the plain version over the planes
    the call's clause rows expand to, before the loop moves on; it fails
    where the union pool hands the sweep anything but int32 rows.  It
    launches no kernel of its own, so the launch count stays the main
    path's."""

    def __init__(self, sweep):
        self.sweep = sweep
        self.calls = {}
        self.checked = {}
        self.seconds = 0.0

    def __call__(self, indptr, cells, width, A, scores, rows=None,
                 out=None):
        import torch

        from mythril_tpu_torch.ops import dense_sweep as ds

        got = self.sweep(indptr, cells, width, A, scores, rows, out=out)
        C, V = width.shape[1], A.shape[1]
        check(indptr.dtype == cells.dtype == torch.int32
              and indptr.dim() == cells.dim() == 1,
              "the union pool's sweep was not handed clause rows")
        key = (C, V, A.shape[0], rows or C, bool(scores))
        n = self.calls[key] = self.calls.get(key, 0) + 1
        if n & (n - 1) == 0:
            started = time.perf_counter()
            torch.cuda.synchronize()
            planes = ds.rows_to_planes(ds.SweepRows(indptr, cells, width), V)
            want = ds.sweep_plain(*planes, width, A, scores, rows)
            del planes
            for g, w in zip(got, want):
                check(torch.equal(g, w),
                      f"main-path sweep {key}, call {n}: kernel != plain")
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - started
            self.checked[key] = self.checked.get(key, 0) + 1
        return got

    def hot_prefix_calls(self):
        """Calls that swept a hot row prefix (rows < C)."""
        return sum(n for k, n in self.calls.items() if k[3] < k[0])

    def summary(self):
        return "; ".join(
            f"C={k[0]} V={k[1]} B={k[2]} rows={k[3]} scores={k[4]}: "
            f"{self.checked[k]} of {self.calls[k]} calls equal bit for bit"
            for k in sorted(self.calls))


class StepAudit:
    """Stands in for the DPLL step that ``dense_prop``'s round loop calls
    and holds the kernel against ``dpll_step_plain`` on the main path's
    own inputs: on the 1st, 2nd, 4th, 8th ... call of each (B, V, D,
    decisions, view) it runs the plain step on clones of the inputs taken
    before the launch and compares every field, the zeroed workspace and
    the flags, before the loop moves on; the audited calls' transitions
    are counted.  It launches no kernel of its own."""

    def __init__(self, step):
        self.step = step
        self.calls = {}
        self.checked = {}
        self.events = {}
        self.seconds = 0.0

    def __call__(self, state, outs, flags, step, full_view, hot_gate, clear):
        import torch

        from mythril_tpu_torch.ops import dpll_step as DSTEP

        key = (state[0].shape[0], state[0].shape[1], state[2].shape[1],
               len(outs) == 5, bool(full_view), bool(hot_gate))
        n = self.calls[key] = self.calls.get(key, 0) + 1
        if n & (n - 1):
            return self.step(state, outs, flags, step, full_view, hot_gate,
                             clear)
        started = time.perf_counter()
        want = step_clones(state, outs, flags)
        for name, k in DSTEP.step_events(*want[:2], full_view,
                                         hot_gate).items():
            self.events[name] = self.events.get(name, 0) + k
        self.seconds += time.perf_counter() - started
        self.step(state, outs, flags, step, full_view, hot_gate, clear)
        started = time.perf_counter()
        torch.cuda.synchronize()
        DSTEP.dpll_step_plain(*want, step, full_view, hot_gate, clear)
        step_compare(f"main-path dpll_step {key}, call {n}",
                     (list(state), list(outs), flags), want)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - started
        self.checked[key] = self.checked.get(key, 0) + 1

    def summary(self):
        if not self.calls:
            return ""
        seen = ", ".join(f"{k} {v}" for k, v in self.events.items() if v)
        return "; ".join(
            f"dpll_step B={k[0]} V={k[1]} D={k[2]} "
            f"{'scores' if k[3] else 'bcp'} "
            f"{'full' if k[4] else 'hot'}{' gated' if k[5] else ''}: "
            f"{self.checked[k]} of {self.calls[k]} calls equal bit for bit"
            for k in sorted(self.calls)) + f" (transitions: {seen})"


class RoundLaneAudit:
    """Stands in for ``round_lane.round_lane`` (which the round-lane
    ladder and the prefetch's one-shot solve call) and holds the kernel
    against ``round_lane_plain`` on the path's own inputs: on every call
    (``mode`` "every"), on the 1st, 2nd, 4th, 8th ... call of each (C,
    V1, B, budget) ("sample"), or on none ("count": the prefetch's
    worker would run the plain version beside the host's own work, on
    the analyses whose walls the check reports).  Thread-safe: the
    prefetch's worker calls it too.  It launches no kernel of its own."""

    def __init__(self, real, mode):
        self.real = real
        self.mode = mode
        self.calls = {}
        self.checked = {}
        self.seconds = 0.0
        self.lock = threading.Lock()

    def __call__(self, lits, state, budget):
        import torch

        from mythril_tpu_torch.ops import round_lane as RL

        got = self.real(lits, state, budget)
        B, V1 = state["assign"].shape
        key = (lits.shape[0], V1, B, int(budget))
        with self.lock:
            n = self.calls[key] = self.calls.get(key, 0) + 1
        if self.mode == "every" or (self.mode == "sample"
                                    and not n & (n - 1)):
            started = time.perf_counter()
            torch.cuda.current_stream().synchronize()
            want = RL.round_lane_plain(lits, state, budget)
            for k in RL.ROUND_STATE_FIELDS:
                check(torch.equal(got[k], want[k]),
                      f"main-path round lane {key}, call {n}: {k} differs "
                      f"from the plain version")
            with self.lock:
                self.checked[key] = self.checked.get(key, 0) + 1
                self.seconds += time.perf_counter() - started
        return got

    def summary(self):
        return "; ".join(
            f"round_lane C={k[0]} V1={k[1]} B={k[2]} budget {k[3]}: "
            f"{self.checked.get(k, 0)} of {self.calls[k]} calls equal bit "
            f"for bit" for k in sorted(self.calls))


class WordAudit:
    """Stands in for ``word_fixpoint.word_fixpoint`` (which the word
    tier's device executor calls) and holds the kernel against
    ``word_fixpoint_plain`` on the path's own inputs (on the host): on
    the first call (``mode`` "first": the plain walk of a main-path
    program takes seconds on the host) or on none ("count").  Keeps the
    first call's inputs (on the host) in ``captured``.  It launches no
    kernel of its own."""

    def __init__(self, real, mode):
        self.real = real
        self.mode = mode
        self.calls = {}
        self.checked = {}
        self.seconds = 0.0
        self.captured = None

    def __call__(self, table, want0, rounds):
        import torch

        from mythril_tpu_torch.ops import word_fixpoint as WF

        got = self.real(table, want0, rounds)
        key = (table.n_bv + table.n_bool, want0.shape[1])
        n = self.calls[key] = self.calls.get(key, 0) + 1
        if self.captured is None:
            self.captured = (table.to("cpu"), want0.cpu(), rounds)
        if self.mode == "first" and not self.checked:
            started = time.perf_counter()
            torch.cuda.synchronize()
            want = WF.word_fixpoint_plain(table.to("cpu"), want0.cpu(),
                                          rounds)
            for name, g, w in zip(("planes", "tri", "conflict"), got, want):
                check(torch.equal(g.cpu(), w),
                      f"word_prop {key}, call {n}: {name} differs from the "
                      f"plain version")
            self.checked[key] = self.checked.get(key, 0) + 1
            self.seconds += time.perf_counter() - started
        return got

    def summary(self):
        return "; ".join(
            f"word_prop nodes={k[0]} B={k[1]}: {self.checked.get(k, 0)} of "
            f"{self.calls[k]} calls equal bit for bit"
            for k in sorted(self.calls))


def lockstep_equal(got, want, what):
    """Hold a lockstep launch's ``(state, visited, steps)`` against the
    plain loop's, every field bit for bit; returns the largest absolute
    difference (0)."""
    import torch

    from mythril_tpu_torch.ops import lockstep as LS

    for name, g, w in zip(LS.EVMState._fields, got[0], want[0]):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"lockstep {what}: {name} differs from the plain version")
    check(torch.equal(got[1], want[1]),
          f"lockstep {what}: visited differs from the plain version")
    check(got[2] == want[2], f"lockstep {what}: steps {got[2]} != {want[2]}")
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(list(got[0]) + [got[1]],
                               list(want[0]) + [want[1]]))


class LockstepAudit:
    """Stands in for ``lockstep.run_kernel`` (which ``run_batch`` calls for
    a state on the card) and holds every launch against ``run_plain`` on
    the card, on the path's own inputs (``mode`` "every"), or only counts
    them ("count").  It launches no kernel of its own."""

    def __init__(self, real, mode):
        self.real = real
        self.mode = mode
        self.calls = 0
        self.checked = 0
        self.seconds = 0.0
        self.shapes = {}
        #: the first launch's inputs of each program (by code length)
        self.captured = {}

    def __call__(self, program, state, max_steps, record_visited):
        import torch

        from mythril_tpu_torch.ops import lockstep as LS

        got = self.real(program, state, max_steps, record_visited)
        self.calls += 1
        self.captured.setdefault(program.length, (program, state, max_steps,
                                                  record_visited))
        key = (state.pc.shape[0], max_steps, record_visited)
        self.shapes[key] = self.shapes.get(key, 0) + 1
        if self.mode == "every":
            started = time.perf_counter()
            want = LS.run_plain(program, state, max_steps, record_visited)
            torch.cuda.synchronize()
            lockstep_equal(got, want, f"B={key[0]} max_steps={max_steps}")
            self.checked += 1
            self.seconds += time.perf_counter() - started
        return got

    def summary(self):
        shapes = ", ".join(f"B={b} steps<={n}{' visited' if v else ''} x{c}"
                           for (b, n, v), c in sorted(self.shapes.items()))
        return (f"lockstep {self.checked} of {self.calls} launches equal bit "
                f"for bit ({shapes})" if self.calls else "")


class KeccakAudit:
    """Stands in for ``keccak.keccak256_batch`` (which the symbolic
    lockstep tier calls for a SHA3 width group) and holds every launch
    against ``keccak256_batch_plain`` on the card, bit for bit, on the
    path's own rows (``mode`` "every"), or only counts them ("count");
    keeps each call's rows (the kernels line times them).  It launches no
    kernel of its own."""

    def __init__(self, real, mode):
        self.real = real
        self.mode = mode
        self.calls = 0
        self.checked = 0
        self.seconds = 0.0
        self.shapes = {}
        self.captured = []

    def __call__(self, data):
        import torch

        from mythril_tpu_torch.ops import keccak as KC

        got = self.real(data)
        self.calls += 1
        self.captured.append(data.clone())
        key = tuple(data.shape)
        self.shapes[key] = self.shapes.get(key, 0) + 1
        if self.mode == "every":
            started = time.perf_counter()
            want = KC.keccak256_batch_plain(data)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"keccak {key}: the kernel differs from the plain version")
            self.checked += 1
            self.seconds += time.perf_counter() - started
        return got

    def summary(self):
        shapes = ", ".join(f"{b} x {n} B x{c}"
                           for (b, n), c in sorted(self.shapes.items()))
        return (f"keccak {self.checked} of {self.calls} calls equal bit for "
                f"bit ({shapes})" if self.calls else "")


#: dpll_step launches by (B, V, D) over every audited run of the check
STEP_SHAPE_LAUNCHES = {}
#: dense-tier rounds by step budget, and their hot-view steps, over every
#: main-path and analyze run the check prints
DENSE_ROUNDS = {"budgets": {}, "hot_view_steps": 0}


def dense_rounds(stats):
    """The run's dense rounds by step budget and hot-view steps, as text,
    added to :data:`DENSE_ROUNDS`."""
    budgets = dict(sorted(stats.dense_round_budgets.items()))
    for budget, n in budgets.items():
        DENSE_ROUNDS["budgets"][budget] = (
            DENSE_ROUNDS["budgets"].get(budget, 0) + n)
    DENSE_ROUNDS["hot_view_steps"] += stats.hot_view_steps
    return (f"dense rounds by step budget {budgets}, "
            f"{stats.hot_view_steps} hot-view steps")


def reset_launches():
    """Every kernel wrapper's launch count set to 0."""
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import dpll_step as DSTEP
    from mythril_tpu_torch.ops import frontier_kernels as FK
    from mythril_tpu_torch.ops import keccak as KC
    from mythril_tpu_torch.ops import lockstep as LS
    from mythril_tpu_torch.ops import round_lane as RL
    from mythril_tpu_torch.ops import word_fixpoint as WF

    ds.reset_launch_count()
    DSTEP.reset_launch_count()
    FK.reset_launch_counts()
    RL.reset_launch_count()
    WF.reset_launch_count()
    LS.reset_launch_count()
    KC.reset_launch_count()


def read_launches():
    """Every kernel's launch count since :func:`reset_launches`."""
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import dpll_step as DSTEP
    from mythril_tpu_torch.ops import frontier_kernels as FK
    from mythril_tpu_torch.ops import keccak as KC
    from mythril_tpu_torch.ops import lockstep as LS
    from mythril_tpu_torch.ops import round_lane as RL
    from mythril_tpu_torch.ops import word_fixpoint as WF

    return {"dense_sweep": ds.launch_count,
            "dpll_step": DSTEP.launch_count,
            **FK.launch_counts,
            "round_lane": RL.launch_count,
            "word_prop": WF.launch_count,
            "lockstep": LS.launch_count,
            "keccak": KC.launch_count}


#: the dispatch watchdog's deadline floor while kernels are audited: an
#: audit holds a kernel against its plain version inside the supervised
#: dispatch, which is not the dispatch's own latency
AUDITED_DEADLINE_FLOOR_S = 3600.0


@contextlib.contextmanager
def audit_deadlines():
    """The watchdog's deadline floor raised for the block, where the
    tree has a watchdog (``chip_tools/analyze_times.py`` times older
    trees with this file)."""
    if importlib.util.find_spec("mythril_tpu_torch.resilience.watchdog") \
            is None:
        yield
        return
    from mythril_tpu_torch.resilience import watchdog

    floor = watchdog.DEADLINE_FLOOR_S
    watchdog.DEADLINE_FLOOR_S = AUDITED_DEADLINE_FLOOR_S
    try:
        with env(MYTHRIL_TPU_DISPATCH_TIMEOUT=str(AUDITED_DEADLINE_FLOOR_S)):
            yield
    finally:
        watchdog.DEADLINE_FLOOR_S = floor


@contextlib.contextmanager
def audited_kernels(round_lane="sample", word="first", lockstep="every",
                    keccak="every"):
    """Every kernel call of the block audited (the round lane's as
    ``round_lane`` says: "every", "sample" or "count"; the word
    fixpoint's as ``word`` says: "first" or "count"; the lockstep
    interpreter's and the keccak's as ``lockstep`` and ``keccak`` say:
    "every" or "count"); the launch counts zeroed just before and read
    into the yielded dict just after."""
    from mythril_tpu_torch.ops import dense_prop
    from mythril_tpu_torch.ops import dpll_step as DSTEP
    from mythril_tpu_torch.ops import keccak as KC
    from mythril_tpu_torch.ops import lockstep as LS
    from mythril_tpu_torch.ops import round_lane as RL
    from mythril_tpu_torch.ops import word_fixpoint as WF

    sweep = SweepAudit(dense_prop.dense_sweep)
    dense_prop.dense_sweep = sweep
    dpll = StepAudit(dense_prop.dpll_step)
    dense_prop.dpll_step = dpll
    lanes = RoundLaneAudit(RL.round_lane, round_lane)
    RL.round_lane = lanes
    word = WordAudit(WF.word_fixpoint, word)
    WF.word_fixpoint = word
    steps = LockstepAudit(LS.run_kernel, lockstep)
    LS.run_kernel = steps
    hashes = KeccakAudit(KC.keccak256_batch, keccak)
    KC.keccak256_batch = hashes
    out = {"sweep": sweep, "step": dpll, "round_lane": lanes, "word": word,
           "lockstep": steps, "keccak": hashes}
    try:
        with FrontierAudit() as frontier, audit_deadlines():
            out["frontier"] = frontier
            reset_launches()
            yield out
            for shape, n in DSTEP.launch_shapes.items():
                STEP_SHAPE_LAUNCHES[shape] = (
                    STEP_SHAPE_LAUNCHES.get(shape, 0) + n)
            out["launches"] = read_launches()
    finally:
        dense_prop.dense_sweep = sweep.sweep
        dense_prop.dpll_step = dpll.step
        RL.round_lane = lanes.real
        WF.word_fixpoint = word.real
        LS.run_kernel = steps.real
        KC.keccak256_batch = hashes.real
    out["seconds"] = (sweep.seconds + dpll.seconds + frontier.seconds
                      + lanes.seconds
                      + word.seconds + steps.seconds + hashes.seconds)


@contextlib.contextmanager
def rung_args(**values):
    """The funnel's rung arguments (``support_args.args``) set for the
    block."""
    from mythril_tpu_torch.support.support_args import args

    saved = {k: getattr(args, k) for k in values}
    try:
        for k, v in values.items():
            setattr(args, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(args, k, v)


def main_path_phase(name, build, expect, knobs):
    """One frontier through ``batch_check_states``, force-dispatched,
    with ``knobs`` set; ``expect`` names the tier that must answer it
    ("dense", "resident", "ladder" or "round lanes", the last with every
    round-lane launch audited).  Returns the run's kernel launches."""
    import torch

    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.ops.dense_prop import get_dense_backend
    from mythril_tpu_torch.smt.solver import reset_blast_context
    from mythril_tpu_torch.support.support_args import FORCE_DISPATCH_ARGS

    reset_blast_context()
    lanes, expected = build()
    # the word fixpoint's launch is captured here and held against its
    # plain version in the word phase
    with env(**knobs), rung_args(**FORCE_DISPATCH_ARGS), audited_kernels(
            "every" if expect == "round lanes" else "sample",
            "count") as audit:
        bs.dispatch_stats.reset()
        started = time.perf_counter()
        verdicts = bs.batch_check_states(lanes, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
    wall -= audit["seconds"]
    launches = audit["launches"]
    stats = bs.dispatch_stats
    tiers = list(stats.last_tiers)
    backend = get_dense_backend(DEVICE)
    on_device = [i for i, t in enumerate(tiers) if t == "device"]
    layout = (f"layout {backend.last_layout}, C x V x B = "
              f"{' x '.join(map(str, backend.last_shape or ()))}, "
              if expect == "dense" else "")
    log(f"main path {name} [{expect}]: {len(lanes)} lanes, {layout}"
        f"{stats.rounds} rounds, {stats.device_sweeps} full sweeps, "
        f"{dense_rounds(stats)}, "
        f"{stats.frontier_steps} gather steps, {stats.resident_dispatches} "
        f"resident solves ({stats.resident_exit_all_decided} all decided, "
        f"{stats.resident_exit_budget} budget, "
        f"{stats.resident_exit_watchdog} watchdog), "
        f"{stats.resident_delegations} delegations, "
        f"{stats.learned_clauses} learned clauses, launches {launches}, "
        f"decided on device {len(on_device)} ({stats.unsat} unsat, "
        f"{stats.sat_verified} sat), on the tail {tiers.count('tail')}, "
        f"wall {wall:.3f} s without the audits' {audit['seconds']:.3f} s "
        f"(device tiers {stats.device_s:.3f} s with them, tail "
        f"{stats.tail_s:.3f} s)")
    log(f"main path {name} [{expect}] word tier: "
        f"{tiers.count('probe')} lanes decided by the host probe, "
        f"{tiers.count('word')} by the word tier "
        f"({stats.word_decided_unsat} unsat, {stats.word_decided_sat} sat), "
        f"{stats.word_tightened_bits} bits pinned, word_prop "
        f"{launches['word_prop']} launches, {stats.word_prop_s:.3f} s "
        f"(with the audit)")
    log(f"main path {name} [{expect}] kernels vs plain: "
        f"{audit['sweep'].summary() or 'no sweep'}; "
        f"{audit['step'].summary() or 'no dpll_step'}; "
        f"{audit['frontier'].summary() or 'no frontier kernel'}; "
        f"{audit['round_lane'].summary() or 'no round lane'}; "
        f"{audit['word'].summary() or 'no word fixpoint'}")
    check(launches["word_prop"] == 1,
          f"{name}: the word tier ran its kernel {launches['word_prop']} "
          f"times, not once")
    if not knobs:
        WORD_CAPTURES[name] = audit["word"].captured
    check(stats.dispatches == 1, f"{name}: no device tier engaged")
    check(stats.rounds > 0, f"{name}: no round ran")
    if expect == "dense":
        check(audit["sweep"].checked and launches["dense_sweep"] > 0,
              f"{name}: no main-path sweep reached the kernel")
        check(audit["step"].checked
              and launches["dpll_step"] >= stats.device_sweeps > 0,
              f"{name}: {launches['dpll_step']} dpll_step launches for "
              f"{stats.device_sweeps} sweeps")
    elif expect == "round lanes":
        audit_lanes = audit["round_lane"]
        check(launches["round_lane"] > 0
              and sum(audit_lanes.calls.values()) == launches["round_lane"]
              and audit_lanes.checked == audit_lanes.calls,
              f"{name}: round-lane launches {launches['round_lane']}, "
              f"audited {audit_lanes.checked} of {audit_lanes.calls}")
        check(stats.resident_dispatches == 0 and stats.frontier_steps == 0
              and sum(launches[k] for k in FRONTIER_KERNELS) == 0,
              f"{name}: a frontier solver ran under MYTHRIL_TPU_FRONTIER=0")
    else:
        check(all(launches[k] > 0 for k in FRONTIER_KERNELS),
              f"{name}: a frontier kernel never launched: {launches}")
        check(len(audit["frontier"].checked) >= 3,
              f"{name}: a frontier kernel was not audited")
        check((stats.resident_dispatches > 0) == (expect == "resident"),
              f"{name}: resident solves {stats.resident_dispatches}")
    check(verdicts == expected,
          f"{name}: verdicts {verdicts} != known {expected}")
    device_unsat = [i for i in on_device if verdicts[i] is False]
    check(all(cdcl_unsat(build, device_unsat)),
          f"{name}: a device UNSAT disagrees with the CDCL")
    word_unsat = [i for i, t in enumerate(tiers)
                  if t == "word" and verdicts[i] is False]
    check(all(cdcl_unsat(build, word_unsat)),
          f"{name}: a word-tier UNSAT disagrees with the CDCL")
    check(all(expected[i] for i in on_device if verdicts[i] is True),
          f"{name}: a device SAT lane is known dead")
    return launches


def prefetch_phase(card):
    """The async prefetch on the card: the guard chain through
    ``batch_check_states`` with the profit gate always declining
    (``device_min_save_s`` 1e9), so the frontier is launched on the
    prefetch worker's stream; the worker is joined, and a second call
    harvests it (its UNSAT memos decide the dead lanes).  Every
    round-lane launch is audited.  Returns the run's kernel launches."""
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import async_dispatch as AD
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.smt.solver import reset_blast_context

    reset_blast_context()
    AD.reset_async_dispatch()
    bs.dispatch_stats.reset()
    lanes, expected = frontiers.guard_chain_frontier(64, 32)
    with rung_args(device_force_dispatch=False, async_dispatch=True,
                   device_coalesce=True, device_min_save_s=1e9), \
            audited_kernels("every", "count") as audit:
        started = time.perf_counter()
        first = bs.batch_check_states(lanes, device=DEVICE, tail=False)
        launched = time.perf_counter() - started
        AD.get_async_dispatcher().join()
        solved = time.perf_counter() - started
        second = bs.batch_check_states(lanes, device=DEVICE, tail=False)
        # the second call prefetches the lanes still open: joined here,
        # so its launch is audited and counted with the phase's
        AD.get_async_dispatcher().join()
        torch.cuda.synchronize()
    stats = AD.async_stats
    launches = audit["launches"]
    log(f"prefetch guard chain 64x32 [{card}]: first call {launched:.3f} s, "
        f"its worker done at {solved:.3f} s; over both calls "
        f"{bs.dispatch_stats.profit_skips} profit skips, {stats.launches} "
        f"launches, harvest: {stats.harvested} batches, {stats.unsat} UNSAT "
        f"lanes, "
        f"{stats.models} models, {stats.dropped} dropped, {stats.abandoned} "
        f"abandoned; decided from the memo on the second call "
        f"{sum(v is not None for v in second)}; launches {launches}; "
        f"{audit['round_lane'].summary()}")
    check(first == [None] * len(lanes), "prefetch: the gate did not decline")
    check(stats.harvested >= 1 and stats.dropped == 0
          and stats.abandoned == 0,
          f"prefetch: harvested {stats.harvested}, dropped {stats.dropped}")
    check(launches["round_lane"] >= 1
          and audit["round_lane"].checked == audit["round_lane"].calls,
          f"prefetch: round-lane launches {launches['round_lane']}")
    check(all(v is None or v == e for v, e in zip(second, expected))
          and any(v is False for v in second),
          f"prefetch: harvested verdicts {second} against {expected}")
    return launches


#: the word fixpoint's random DAGs (``frontiers.word_dag_lanes``): seed,
#: lanes, widths; each decides lanes both ways and leaves others open
WORD_DAGS = ((9, 16, (256, 64, 8)), (9, 64, (256, 64, 8)),
             (10, 256, (32, 8)))
#: the word kernel's edge cases: label, a function that makes its lanes
#: (``frontiers``): every opcode of the table at widths 1, 8, 31, 33, 160
#: and 256; a comparison whose push-down reaches depth 8 through concat and
#: extract; a program at the node cap (1024 nodes) over 256 lanes, the
#: largest shared-memory block
WORD_EDGE_CASES = (
    ("every opcode, widths 1/8/31/33/160/256, 64 lanes",
     lambda: _frontiers().word_opcode_lanes(3, 64)),
    ("push-down to depth 8, 64 lanes",
     lambda: _frontiers().word_deep_lanes(64)),
    ("node cap, 1024 nodes, 256 lanes",
     lambda: _frontiers().word_cap_lanes(5, 256)),
)
#: the main-path frontier whose captured program the kernels line times
WORD_ENTRY_CASE = "scale_mul d6 g16"


def _frontiers():
    from mythril_tpu_torch import frontiers

    return frontiers


def word_digest(table, want0) -> str:
    """A digest of one decide's inputs (table and wants)."""
    h = hashlib.sha256()
    for t in (table.entries, table.args, table.consts, want0):
        h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def edge_plain(index):
    """``word_fixpoint_plain`` of ``WORD_EDGE_CASES[index]`` on the CPU,
    in the worker process the check starts first (the edge cases' plain
    walks take seconds each, and run beside the builds and the earlier
    phases): the digest of its inputs, planes, tri-states and conflicts
    as numpy arrays, and its seconds."""
    import torch

    from mythril_tpu_torch.ops import word_fixpoint as WF
    from mythril_tpu_torch.smt.word_tier import WORD_ROUNDS

    torch.set_num_threads(1)
    table, want0, rounds = word_inputs(WORD_EDGE_CASES[index][1](),
                                       WORD_ROUNDS)
    started = time.perf_counter()
    planes, tri, conflict = WF.word_fixpoint_plain(table, want0, rounds)
    return (word_digest(table, want0), planes.numpy(), tri.numpy(),
            conflict.numpy(), time.perf_counter() - started)


def start_edge_plain():
    """One spawned worker process and its futures, one an edge case."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    return pool, [pool.submit(edge_plain, k)
                  for k in range(len(WORD_EDGE_CASES))]
#: (table, want0, rounds) on the host of the word tier's launch in each
#: main-path run of the default configuration, captured during the run
WORD_CAPTURES = {}


def word_inputs(lanes, rounds):
    """(table, want0, rounds) on the host of one device decide over
    ``lanes``, as the word tier builds them."""
    import torch

    from mythril_tpu_torch.ops import word_fixpoint as WF
    from mythril_tpu_torch.smt import word_tier as PWT

    roots = list({n.id: n for lane in lanes for n in lane}.values())
    prog = PWT._compile(roots, PWT.WORD_MAX_NODES)
    table = WF.lower_program(prog)
    want0 = np.zeros((table.n_bool, len(lanes)), dtype=np.int8)
    for k, lane in enumerate(lanes):
        for node in lane:
            want0[prog.bool_slot[node.id], k] = 1
    return table, torch.from_numpy(want0), rounds


def word_bound(table, B, rounds):
    """Least time of one fixpoint launch: the table and the wants read
    once and the planes, tri-states and conflicts written once, against
    a lower count of the operations (every bv node of every pass takes
    at least one refine-sized step, about 20 word operations of 8 limbs,
    every bool node about 10) at the float32 rate (the card has no
    published int32 rate)."""
    bytes_moved = (table.entries.numel() * 4 + table.args.numel() * 4
                   + table.consts.numel() * 4 + table.n_bool * B
                   + table.n_bv * 128 * B + table.n_bool * B + B)
    passes = 1 + 2 * rounds
    ops = B * passes * (160 * table.n_bv + 10 * table.n_bool)
    return bound(bytes_moved, ops)


def word_kernel_ms(table, want0, rounds, iters=10):
    """Device time of one ``word_prop`` launch: CUDA events around
    ``iters`` launches of the bare kernel on the wrapper's arguments
    (the profiler loses records of its multi-millisecond launches; the
    wrapper's checks, allocations and its widening of the planes stay
    outside the events)."""
    import torch

    from mythril_tpu_torch.ops import word_fixpoint as WF

    lib = WF.load_library()
    B = want0.shape[1]
    dev = want0.device
    consts = table.consts.to(torch.int32).contiguous()
    bv = torch.empty((max(table.n_bv, 1) * 32, B), dtype=torch.int32,
                     device=dev)
    tri = torch.empty((table.n_bool, B), dtype=torch.int8, device=dev)
    want = torch.empty_like(tri)
    conflict = torch.empty((B,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = lib.word_prop_launch(
            table.entries.data_ptr(), table.n_bv + table.n_bool,
            table.args.data_ptr(), consts.data_ptr(), want0.data_ptr(), B,
            table.n_bool, rounds, bv.data_ptr(), tri.data_ptr(),
            want.data_ptr(), conflict.data_ptr(), stream)
        check(err == 0, f"word_prop launch failed: cudaError {err}")

    return cuda_ms(launch, iters)


def word_prop_phase(card, edge_pool, edge_futures):
    """The word fixpoint kernel against ``word_fixpoint_plain`` on the
    card (the plain version timed once, its result compared bit for
    bit): seeded random DAGs at 16, 64 and 256 lanes, the edge cases of
    ``WORD_EDGE_CASES`` (every opcode; a push-down to depth 8; the node
    cap at 256 lanes; their plain walks come from ``edge_futures``, the
    CPU worker's, whose ``edge_pool`` is shut down once they are in),
    and the programs the main path's two frontiers handed
    the word tier, captured during their run.  Returns the kernels
    line's entry (the captured ``WORD_ENTRY_CASE`` program)."""
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import word_fixpoint as WF
    from mythril_tpu_torch.smt.word_tier import WORD_ROUNDS

    cases = [(f"random DAG seed {seed}, widths {widths}",
              word_inputs(frontiers.word_dag_lanes(seed, lanes, widths),
                          WORD_ROUNDS))
             for seed, lanes, widths in WORD_DAGS]
    from mythril_tpu_torch.smt.word_tier import WORD_MAX_NODES

    plain_of = {}  # label -> the worker's plain result
    for (label, build), future in zip(WORD_EDGE_CASES, edge_futures):
        table, want0, rounds = word_inputs(build(), WORD_ROUNDS)
        plain_of[label] = future.result()
        check(plain_of[label][0] == word_digest(table, want0),
              f"word_prop {label}: the worker held other inputs")
        if label.startswith("every opcode"):
            codes = set(table.entries[:, 0].tolist())
            check(codes == set(range(len(WF.OP_NAMES))),
                  f"word_prop {label}: opcodes {sorted(codes)}")
        if label.startswith("node cap"):
            check(table.n_bv + table.n_bool == WORD_MAX_NODES,
                  f"word_prop {label}: {table.n_bv + table.n_bool} nodes")
        cases.append((label, (table, want0, rounds)))
    edge_pool.shutdown(wait=True)
    for name in ("scale_mul d6 g16", "guard chain 64x32"):
        check(WORD_CAPTURES.get(name) is not None,
              f"word_prop: no program captured on the main path {name}")
        cases.append((f"main path {name}", WORD_CAPTURES[name]))
    entry = None
    for label, (table_host, want0_host, rounds) in cases:
        table = table_host.to(DEVICE)
        want0 = want0_host.to(DEVICE)
        B = want0.shape[1]
        got = WF.word_fixpoint(table, want0, rounds)
        torch.cuda.synchronize()
        if label in plain_of:  # the worker's plain walk, on the CPU
            _, *want, plain_s = plain_of[label]
            want = [torch.from_numpy(w).to(DEVICE) for w in want]
            plain_ms, plain_where = plain_s * 1e3, "the CPU worker"
        else:
            started = time.perf_counter()
            want = WF.word_fixpoint_plain(table, want0, rounds)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - started) * 1e3
            plain_where = "eager torch on the card"
        err = 0
        for name, g, w in zip(("planes", "tri", "conflict"), got, want):
            check(g.shape == w.shape and torch.equal(g, w),
                  f"word_prop {label}: {name} differs from the plain version")
            err = max(err, int((g.long() - w.long()).abs().max())
                      if g.numel() else 0)
        ms = word_kernel_ms(table, want0, rounds)
        bound_ms, bound_by = word_bound(table, B, rounds)
        conflicts = int(got[2].sum())
        roots_true = int((got[1] == 1).sum())
        log(f"word_prop {label} [{card}]: {table.n_bv + table.n_bool} nodes "
            f"({table.n_bv} bv, {table.n_bool} bool), {B} lanes, "
            f"{conflicts} lanes in conflict, {roots_true} must-true "
            f"tri-states; bit-equal to the plain version; device "
            f"{ms:.4f} ms, plain ({plain_where}) {plain_ms:.1f} "
            f"ms, bound {bound_ms:.5f} ms ({bound_by}, "
            f"{100 * bound_ms / ms:.2f}% of it)")
        if label == f"main path {WORD_ENTRY_CASE}":
            entry = {
                "name": "word_prop", "route": "cuda",
                "source": "mythril_tpu_torch/ops/csrc/word_prop.cu",
                "replaces": "mythril_tpu/smt/word_tier.py:402",
                "max_abs_err": err, "ms": round(ms, 4),
                "plain_ms": round(plain_ms, 4),
                "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
                "library_ms": None,
            }
    return entry


#: the lockstep phase's wide batch: the gauntlet at the JAX arenas,
#: with lanes and step cap of the concolic regime; the plain comparison
#: takes its first LOCKSTEP_PLAIN lanes at a cap of LOCKSTEP_PLAIN_STEPS
#: (the eager plain loop takes seconds a division step)
LOCKSTEP_LANES, LOCKSTEP_STEPS = 4096, 4096
LOCKSTEP_PLAIN, LOCKSTEP_PLAIN_STEPS = 1024, 1024
#: integer operations a lane of the lockstep kernel's work, by opcode
#: class (the bound's count): every step's fetch, decode and bookkeeping;
#: a word's limb arithmetic (8 limbs, about 4 operations each); a
#: multiply's 64 partial products and their sums; a division round (a
#: shift, a compare and a subtract over 8 limbs); a byte window; a
#: storage key compared a used slot
OPS_STEP, OPS_ALU, OPS_MUL, OPS_DIV_ROUND, OPS_WINDOW, OPS_SLOT = (
    16, 32, 256, 48, 40, 8)
_ALU_OPS = (0x01, 0x03, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17,
            0x18, 0x19, 0x1B, 0x1C, 0x1D)


def _bit_lengths(words):
    """Bit length of each [n, 8] limb word (int64 tensor, on the host)."""
    w = words.cpu().numpy()
    out = np.zeros(w.shape[0], dtype=np.int64)
    for k in range(8):
        nz = w[:, k] != 0
        out[nz] = 32 * k + np.floor(np.log2(w[nz, k])).astype(np.int64) + 1
    return out


class LockstepOps:
    """Counts the integer operations the lockstep kernel's work needs on
    a run's own data, from the plain loop's states (``run_plain``'s
    ``observe``): the executed opcodes by class, each division's rounds
    (the dividend's bit length, none for a zero divisor) and each
    exponent's multiplies (the exponent's bit length plus its set
    bits)."""

    def __init__(self, program):
        self.program = program
        self.ops = 0

    def __call__(self, state, code):
        import torch

        from mythril_tpu_torch.ops import lockstep as LS
        from mythril_tpu_torch.ops import u256

        running = state.halt == LS.RUNNING
        pc = state.pc.clamp(0, code.shape[0] - 1).long()
        op = torch.where(state.pc >= self.program.length, 0,
                         code[pc].long())
        hist = torch.bincount(op[running], minlength=256).cpu().numpy()
        ops = OPS_STEP * int(hist.sum()) + OPS_ALU * int(hist[list(
            _ALU_OPS)].sum()) + OPS_MUL * int(hist[0x02])
        ops += OPS_WINDOW * int(hist[[0x35, 0x51, 0x52, 0x53]].sum())
        ops += 8 * int(hist[0x5F:0xA0].sum() + hist[[0x33, 0x34, 0x58]].sum())
        rows = torch.arange(op.shape[0], device=op.device)
        top = state.stack[rows, (state.sp.long() - 1).clamp(0, 63)]
        second = state.stack[rows, (state.sp.long() - 2).clamp(0, 63)]
        divs = running & (op >= 0x04) & (op <= 0x07) & (state.sp >= 2)
        if bool(divs.any()):
            a, b = top[divs], second[divs]
            signed = ((op[divs] == 0x05) | (op[divs] == 0x07))[:, None]
            a = torch.where(signed & ((a[:, 7:] >> 31) == 1), u256.neg(a), a)
            live = ~u256.is_zero(b).cpu().numpy()
            ops += OPS_DIV_ROUND * int(_bit_lengths(a)[live].sum())
        exps = running & (op == 0x0A) & (state.sp >= 2)
        if bool(exps.any()):
            e = second[exps]
            bits = int(np.unpackbits(e.cpu().numpy().astype(">u4").view(
                np.uint8)).sum())
            ops += OPS_MUL * (int(_bit_lengths(e).sum()) + bits)
        slots = running & ((op == 0x54) | (op == 0x55))
        if bool(slots.any()):
            ops += OPS_SLOT * 8 * int(state.sused[slots].sum())
        self.ops += ops


def lockstep_bound(program, state, ops):
    """(least ms, what bounds it) of one launch: the lane state (stack,
    memory, storage, scalars) read once and written once, the calldata,
    value, caller and the program read once, the visited words written
    once, against ``ops`` integer operations at the scalar rate."""
    B, C = state.calldata.shape
    lane_state = 64 * 8 * 4 + 4096 + 2 * 32 * 8 * 4 + 32 + 7 * 4
    words = len(program.code) // 32 + 1
    bytes_moved = (2 * B * lane_state + B * (C + 4 + 2 * 8 * 4)
                   + 2 * len(program.code) + B * 4 * words)
    return bound(bytes_moved, ops)


def idle_stream_ms(name, launch, iters):
    """Device ms of one bare launch (``launch()`` returns the library's
    error code): CUDA events around each launch on an idle stream, after
    one warm-up launch."""
    import torch

    check(launch() == 0, f"{name} launch")
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        check(launch() == 0, f"{name} launch")
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def lockstep_kernel_ms(program, state, max_steps, record_visited, iters):
    """Device ms of one launch of the kernel alone, on an idle stream (a
    launch writes fresh outputs and leaves its input state as it was, so
    every launch runs the same work)."""
    import torch

    from mythril_tpu_torch.ops import lockstep as LS

    lib = LS.load_library()
    _out, _visited, _count, args = LS.launch_args(
        program, state, LS.check_state(state), max_steps, record_visited)
    stream = torch.cuda.current_stream().cuda_stream
    return idle_stream_ms(
        "lockstep", lambda: lib.lockstep_launch(*args, stream), iters)


def lockstep_case(name, program, state, max_steps, record_visited, iters):
    """One kernel call held against the plain loop on the card (every
    field bit for bit), with the kernel's and the plain loop's times and
    the bound on this data; returns (result, ms, plain ms, bound ms,
    bound by, max abs err)."""
    import torch

    from mythril_tpu_torch.ops import lockstep as LS

    before = [t.clone() for t in state]
    got = LS.run_kernel(program, state, max_steps, record_visited)
    for field, t, t0 in zip(LS.EVMState._fields, state, before):
        check(torch.equal(t, t0),
              f"lockstep {name}: the launch changed the input's {field}")
    counter = LockstepOps(program)
    torch.cuda.synchronize()
    started = time.perf_counter()
    want = LS.run_plain(program, state, max_steps, record_visited,
                        observe=counter)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - started) * 1e3
    err = lockstep_equal(got, want, name)
    ms = lockstep_kernel_ms(program, state, max_steps, record_visited, iters)
    bound_ms, bound_by = lockstep_bound(program, state, counter.ops)
    log(f"lockstep {name}: B={state.pc.shape[0]}, {got[2]} steps, "
        f"{counter.ops} integer operations; bit-equal to the plain loop; "
        f"kernel {ms:.4f} ms (plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.6f} ms by {bound_by})")
    return got, ms, plain_ms, bound_ms, bound_by, err


def batchtoken_sequence():
    """An issue stand-in whose concrete transaction sequence the replay
    runs on ``batchtoken``: approve, batchTransfer, transfer (three
    one-lane launches)."""
    from mythril_tpu_torch.support.signatures import selector_of

    caller = "0x" + "de" * 20

    class Sequence:
        address = -1
        transaction_sequence = {"steps": [
            {"address": "0x01", "origin": caller, "value": "0x0",
             "input": selector_of("approve(address,uint256)")
             + f"{0xDE:064x}{5:064x}"},
            {"address": "0x01", "origin": caller, "value": "0x0",
             "input": selector_of("batchTransfer(uint256,uint256)")
             + f"{3:064x}{0:064x}"},
            {"address": "0x01", "origin": caller, "value": "0x0",
             "input": selector_of("transfer(address,uint256)")
             + f"{7:064x}{1:064x}"},
        ]}

    return Sequence()


def lockstep_phase(card):
    """The lockstep kernel against the plain loop on the card: (a) the
    main path's own launches outside an analysis (the pre-split
    validations of the matching chip contracts, of ``batchtoken`` and of
    a 64-selector dispatcher, and replays of ``batchtoken`` transaction
    sequences), (b) the gauntlet at 4096 lanes; returns the kernel's
    JSON entry (times and bound of the ``vault_withdraw`` validation, a
    launch of the main path's shape)."""
    from mythril_tpu_torch import contracts
    from mythril_tpu_torch.analysis.concrete_replay import replay_issue
    from mythril_tpu_torch.disassembler.disassembly import Disassembly
    from mythril_tpu_torch.laser.ethereum import lockstep_dispatch as LD
    from mythril_tpu_torch.ops import lockstep as LS

    # (a) the pre-split's validations and replays, each launch audited
    plans = {run.name: (run.code, run.presplit) for run in contracts.CHIP_RUNS}
    plans["batchtoken"] = (contracts.batchtoken_contract, True)
    plans["wide dispatcher (64)"] = (contracts.wide_dispatcher, True)
    with rung_args(device=DEVICE), audited_kernels() as audit:
        for name, (code, matches) in plans.items():
            LD._plan_cache.clear()
            plan = LD.dispatcher_plan(Disassembly(code()))
            log(f"lockstep pre-split {name}: "
                + ("declined" if plan is None
                   else f"{len(plan.branches)} selectors validated"))
            check((plan is not None) == matches,
                  f"lockstep pre-split {name}: unexpected verdict")
        token = bytes.fromhex(contracts.batchtoken_contract())
        status = replay_issue(batchtoken_sequence(), token)
        log(f"lockstep replay of a batchtoken sequence: {status}")
        check(status == "executed", f"batchtoken replay: {status}")
    log(f"lockstep main-path launches vs plain: {audit['lockstep'].summary()}")
    check(audit["lockstep"].calls == audit["lockstep"].checked > 0,
          "lockstep: a main-path launch was not held against the plain loop")

    vault = bytes.fromhex(contracts.fixture("vault_withdraw"))
    program, state, max_steps, record = audit["lockstep"].captured[len(vault)]
    _got, ms, plain_ms, bound_ms, bound_by, err = lockstep_case(
        "vault_withdraw pre-split validation", program, state, max_steps,
        record, iters=20)
    entry = {
        "name": "lockstep", "route": "cuda",
        "source": "mythril_tpu_torch/ops/csrc/lockstep.cu",
        "replaces": "mythril_tpu/ops/lockstep.py:736",
        "max_abs_err": err, "ms": round(ms, 4),
        "plain_ms": round(plain_ms, 4), "bound_ms": round(bound_ms, 8),
        "bound_by": bound_by, "library_ms": None,
    }

    # (b) the wide batch
    program = LS.prepare_program(bytes.fromhex(contracts.lockstep_gauntlet()))
    rng = np.random.default_rng(2026)
    calldata = contracts.gauntlet_calldata(LOCKSTEP_LANES, 2026)
    value = rng.integers(0, 1 << 32, size=(LOCKSTEP_LANES, 8),
                         dtype=np.uint64)
    value[::2, 1:] = 0
    caller = rng.integers(0, 1 << 32, size=(LOCKSTEP_LANES, 8),
                          dtype=np.uint64)
    state = LS.init_state(LOCKSTEP_LANES, calldata,
                          np.full(LOCKSTEP_LANES, calldata.shape[1], np.int32),
                          value, caller, device=DEVICE)
    sub = LS.EVMState(*(t[:LOCKSTEP_PLAIN] for t in state))
    got, ms_sub, plain_sub, bound_sub, by_sub, _err = lockstep_case(
        f"gauntlet {LOCKSTEP_PLAIN} lanes x {LOCKSTEP_PLAIN_STEPS} steps",
        program, sub, LOCKSTEP_PLAIN_STEPS, True, iters=3)
    for final, what in ((got[0], "the compared batch"),
                        (LS.run_kernel(program, state, LOCKSTEP_STEPS,
                                       True)[0], "the wide batch")):
        halts = set(final.halt.tolist())
        causes = {LS.decode_cause(c)[0] for c in final.cause.tolist() if c}
        check(halts == set(range(6)), f"lockstep {what}: halts {halts}")
        check(causes == {"mem-arena-oob", "storage-arena-full",
                         "unsupported-op"}, f"lockstep {what}: {causes}")
        log(f"lockstep gauntlet, {what}: halts "
            f"{np.bincount(final.halt.cpu().numpy(), minlength=6).tolist()} "
            f"(running, stop, return, revert, error, needs host), causes "
            f"{LS.cause_histogram(final)}")
    ms_wide = lockstep_kernel_ms(program, state, LOCKSTEP_STEPS, True, 3)
    log(f"lockstep gauntlet {LOCKSTEP_LANES} lanes x {LOCKSTEP_STEPS} steps "
        f"[{card}]: kernel {ms_wide:.4f} ms; at {LOCKSTEP_PLAIN} x "
        f"{LOCKSTEP_PLAIN_STEPS}: kernel {ms_sub:.4f} ms, plain "
        f"{plain_sub:.1f} ms, bound {bound_sub:.6f} ms by {by_sub}")
    return entry


#: the keccak phase's batches: rows, and widths (a word, the mapping
#: slot's key and slot, the rate, one byte past it, the tier's cap); and
#: a batch of many more rows at the mapping slot's width
KECCAK_ROWS = 65536
KECCAK_WIDTHS = (32, 64, 136, 137, 256)
KECCAK_LARGE = (1 << 20, 64)
#: (rows, width, byte offset) of a batch viewed from a flat buffer at a
#: base off 8 bytes: every row's staging through raw words, the batch's
#: first and last words read byte by byte
KECCAK_UNALIGNED = (65536, 137, 3)
#: rows of each batch also held against the native keccak256
KECCAK_SAMPLE = 64
#: 32-bit integer operations one keccak-f[1600] round needs on the
#: 64-bit lanes' halves, with three-input logic (LOP3) fused: theta's
#: five column parities (two 3-input XORs a half), their 1-bit rotations
#: (two funnel shifts a lane) and each lane's XOR with two of them (one
#: 3-input XOR a half), 20 + 10 + 50; rho's 24 rotations, two funnel
#: shifts each, 48; chi's NOT-AND-XOR, one LOP3 a half, 50.  iota adds
#: one XOR for each nonzero half of the round's constant.
KECCAK_OPS_ROUND = 178


def keccak_bound(rows, width):
    """(least ms, what bounds it) of one launch over ``rows`` rows of
    ``width`` bytes: each row read once and its 32-byte digest written
    once, against the 32-bit integer operations of each of a row's
    ``width // 136 + 1`` blocks (24 rounds of :data:`KECCAK_OPS_ROUND`,
    iota's XORs of the round constants' nonzero halves, and after the
    first block the XOR of its 17 lanes into the state) at the integer
    issue rate (:data:`INT32_OPS_PER_S`)."""
    from mythril_tpu_torch.ops.keccak import _RC64, RATE_BYTES

    blocks = width // RATE_BYTES + 1
    iota = sum(((rc & 0xFFFFFFFF) != 0) + ((rc >> 32) != 0) for rc in _RC64)
    per_row = blocks * (24 * KECCAK_OPS_ROUND + iota) \
        + (blocks - 1) * 2 * (RATE_BYTES // 8)
    return bound(rows * (width + 32), per_row * rows, INT32_OPS_PER_S)


def keccak_kernel_ms(data, iters):
    """Device ms of one launch of the kernel alone: on an idle stream,
    and behind a spin."""
    import torch

    from mythril_tpu_torch.ops import keccak as KC

    lib = KC.load_library()
    out = torch.empty((data.shape[0], 32), dtype=torch.uint8,
                      device=data.device)
    args = (data.data_ptr(), out.data_ptr(), data.shape[0], data.shape[1],
            torch.cuda.current_stream().cuda_stream)
    launch = lambda: lib.keccak_launch(*args)  # noqa: E731
    return (idle_stream_ms("keccak", launch, iters),
            spin_ms("keccak", launch, iters))


def keccak_case(name, data, iters):
    """One kernel call on the card held against the plain version on the
    card (every digest byte for byte) and a sample of rows against the
    native ``keccak256``; returns (ms, ms behind a spin, plain ms, bound
    ms, bound by, max abs err)."""
    import torch

    from mythril_tpu_torch.native import keccak256 as native_keccak
    from mythril_tpu_torch.ops import keccak as KC

    data = data.contiguous()
    got = KC.keccak256_batch(data)
    torch.cuda.synchronize()
    started = time.perf_counter()
    want = KC.keccak256_batch_plain(data)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - started) * 1e3
    check(torch.equal(got, want),
          f"keccak {name}: the kernel differs from the plain version")
    rows = data[:KECCAK_SAMPLE].cpu().numpy()
    digests = got[:KECCAK_SAMPLE].cpu().numpy()
    for row, digest in zip(rows, digests):
        check(native_keccak(row.tobytes()) == digest.tobytes(),
              f"keccak {name}: a digest differs from the native keccak256")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    ms, busy_ms = keccak_kernel_ms(data, iters)
    bound_ms, bound_by = keccak_bound(data.shape[0], data.shape[1])
    log(f"keccak {name}: {data.shape[0]} rows x {data.shape[1]} B; "
        f"bit-equal to the plain version and, on {min(KECCAK_SAMPLE, len(rows))} "
        f"rows, to the native keccak256; kernel {ms:.4f} ms on an idle "
        f"stream, {busy_ms:.4f} ms behind a spin (plain {plain_ms:.1f} ms, "
        f"bound {bound_ms:.6f} ms by {bound_by}, {100 * bound_ms / ms:.1f}% "
        f"and {100 * bound_ms / busy_ms:.1f}% of it)")
    return ms, busy_ms, plain_ms, bound_ms, bound_by, err


def keccak_phase(card, captured):
    """The keccak kernel against its plain version on the card: (a) the
    analyses' own calls (``captured``: the rows of every call the
    symbolic lockstep tier made in the default rungs, each already held
    against the plain version as it ran), (b) batches of
    :data:`KECCAK_ROWS` seeded rows at each of :data:`KECCAK_WIDTHS` and
    one of :data:`KECCAK_LARGE`, and (c) a row view at a base off 8 bytes
    (:data:`KECCAK_UNALIGNED`); returns the kernel's JSON entry (times
    and bound of the first main-path call)."""
    import torch

    check(captured, "keccak: the analyses made no call to capture")
    entry = None
    for index, data in enumerate(captured):
        ms, busy_ms, plain_ms, bound_ms, bound_by, err = keccak_case(
            f"main-path call {index}", data, iters=20)
        if entry is None:
            entry = {
                "name": "keccak", "route": "cuda",
                "source": "mythril_tpu_torch/ops/csrc/keccak.cu",
                "replaces": "mythril_tpu/ops/keccak.py:139",
                "max_abs_err": err, "ms": round(ms, 4),
                "spin_ms": round(busy_ms, 4),
                "plain_ms": round(plain_ms, 4),
                "bound_ms": round(bound_ms, 10), "bound_by": bound_by,
                "library_ms": None,
            }
    rng = np.random.default_rng(2026)
    for rows, width in [(KECCAK_ROWS, w) for w in KECCAK_WIDTHS] + [
            KECCAK_LARGE]:
        data = torch.from_numpy(rng.integers(
            0, 256, size=(rows, width), dtype=np.uint8)).to(DEVICE)
        keccak_case(f"batch [{card}]", data, iters=20)
    rows, width, offset = KECCAK_UNALIGNED
    flat = torch.from_numpy(rng.integers(
        0, 256, size=rows * width + offset + 16, dtype=np.uint8)).to(DEVICE)
    view = flat[offset:offset + rows * width].view(rows, width)
    check(view.data_ptr() % 8 == offset, "keccak: the view's base offset")
    keccak_case(f"batch at base offset {offset} [{card}]", view, iters=20)
    return entry


#: wall-clock limit of one chip-check analysis (no run comes close)
ANALYZE_TIMEOUT_S = 600
#: the analyze phase's walls of each chip run (default rungs,
#: force-dispatched, CDCL-only), which the proof phase prints its
#: proof-logged walls beside
ANALYZE_WALLS = {}


def legal_path(path) -> bool:
    """A ledger record's path under the port's state machine: it opens,
    every move is in ``LEGAL_NEXT``, and it ends in a terminal tier."""
    from mythril_tpu_torch.observability.ledger import (
        LEGAL_NEXT, TERMINAL_TIERS,
    )

    return (len(path) >= 2 and path[0] == "opened"
            and path[-1] in TERMINAL_TIERS
            and all(b in LEGAL_NEXT.get(a, ()) for a, b in zip(path, path[1:])))


def check_ledger(agg, records, what):
    """Conservation and legality of a ledger's aggregates and records:
    ``lanes_total`` equals the sum of the decided lanes, and every kept
    record's path is legal."""
    decided = sum(agg["decided"].values())
    check(agg["lanes_total"] == decided,
          f"{what}: ledger conservation: {agg['lanes_total']} lanes, "
          f"{decided} decided")
    bad = [r["path"] for r in records if not legal_path(r["path"])]
    check(not bad, f"{what}: illegal ledger paths {bad[:3]}")
    return agg


def plane_line(name, label):
    """The lane ledger's and the autopilot's line for the analysis just
    run, with the ledger's checks; returns the autopilot's counters (with
    the tuner's steps and reverts)."""
    from mythril_tpu_torch import autopilot
    from mythril_tpu_torch.observability.ledger import get_ledger

    led = get_ledger()
    agg = check_ledger(led.snapshot(), led.records, name + label)
    counters = autopilot.counters_snapshot()
    pilot = autopilot._autopilot
    tuner = pilot.tuner.debug_state() if pilot is not None else {}
    log(f"analyze {name}{label} ledger: {agg['lanes_total']} lanes in "
        f"{agg['batches']} batches = decided {agg['decided']}, "
        f"tier_decided_pct {led.tier_decided_pct()}, transitions "
        f"{agg['transitions']}, routed {agg['routed']}, {len(led.records)} "
        f"records, every path legal; autopilot "
        f"{counters or 'never engaged'}, tuner overrides "
        f"{tuner.get('overrides', {})} ({tuner.get('adjustments', 0)} "
        f"steps, {tuner.get('reverts', 0)} reverts)")
    return counters


def segments_declined():
    """Segment shapes the autopilot declined on the wall clock in the
    analysis just run (``MYTHRIL_TPU_SEG_CEIL_MS``): a run that declined
    some steps other states than one that declined none, so its wall is
    compared only with walls at equal states."""
    from mythril_tpu_torch import autopilot

    return autopilot.counters_snapshot().get("segments_declined", 0)


def analyze_once(run, batched_solving=True, force=True, proof_log=False):
    """One chip run through the port's analyzer on ``cuda``, its rungs
    force-dispatched (``force``) or at the JAX defaults, with the proof
    log on a fresh blast context (``proof_log``): (report, analyzer,
    wall seconds)."""
    import torch

    from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.mythril.mythril_analyzer import (
        reset_analysis_state,
    )

    reset_analysis_state()
    disassembler = MythrilDisassembler()
    address, _ = disassembler.load_from_bytecode(run.code(), bin_runtime=True)
    # the chip runs are ``-f CODE --no-onchain-data`` (a tree from before
    # the on-chain loader takes no such argument: its loader is inactive)
    offline = ({"use_onchain_data": False} if "use_onchain_data" in
               inspect.signature(MythrilAnalyzer).parameters else {})
    analyzer = MythrilAnalyzer(
        disassembler, address=address, strategy="bfs", max_depth=128,
        execution_timeout=ANALYZE_TIMEOUT_S, create_timeout=10,
        loop_bound=3, batched_solving=batched_solving,
        device_force_dispatch=force, async_dispatch=not force, device=DEVICE,
        # only when asked: chip_tools/analyze_times.py drives trees from
        # before the proof log with this function
        **({"proof_log": True} if proof_log else {}), **offline,
    )
    started = time.perf_counter()
    with rung_args(device_coalesce=not force):
        report = analyzer.fire_lasers(
            transaction_count=run.transaction_count)
    torch.cuda.synchronize()
    return report, analyzer, time.perf_counter() - started


def supervision():
    """(supervised dispatch attempts, host seconds of their worker
    threads' start and join) so far, where the tree has a watchdog."""
    if importlib.util.find_spec("mythril_tpu_torch.resilience.watchdog") \
            is None:
        return (0, 0.0)
    from mythril_tpu_torch.resilience.watchdog import get_watchdog

    dog = get_watchdog()
    return (dog.runs, dog.thread_s)


def ladder_quiet(what, force=True):
    """Checks that the analysis just run, under the watchdog's real
    deadlines on a healthy card, tripped no deadline, retried no dispatch
    and demoted nothing, where the tree has a watchdog; force-dispatched,
    also that its adaptive fuse is armed (in the default rungs a futile
    context may blow it, which is no demotion).  Returns the line to log."""
    if importlib.util.find_spec("mythril_tpu_torch.resilience.telemetry") \
            is None:
        return "no resilience plane"
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.resilience.telemetry import resilience_stats

    counters = {k: getattr(resilience_stats, k) for k in LADDER_COUNTERS}
    fused = bs.dispatch_stats.fused
    check(not any(counters.values()) and not (force and fused),
          f"{what}: the ladder acted on a healthy card: {counters}, "
          f"adaptive fuse {'blown' if fused else 'armed'}")
    return (", ".join(f"{k} {v}" for k, v in counters.items())
            + f", adaptive fuse {'blown' if fused else 'armed'}")


def analyze_audited(run, card, label="", force=True):
    """One audited batched analysis, force-dispatched or (``force``
    False) at the JAX defaults of the rungs; logs its line and returns
    (launches, stats snapshot)."""
    from mythril_tpu_torch.laser.batch import prune_stats
    from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
    from mythril_tpu_torch.laser.ethereum.veritest import veritest_enabled
    from mythril_tpu_torch.ops import async_dispatch as AD
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.smt import SolverStatistics
    from mythril_tpu_torch.smt.solver import get_blast_context

    supervised = supervision()
    with audited_kernels("sample" if force else "count",
                         "first" if force else "count",
                         "count" if force else "every") as audit:
        report, analyzer, wall = analyze_once(run, force=force)
    supervised = [b - a for a, b in zip(supervised, supervision())]
    fused = bs.dispatch_fuse.fused_generation == get_blast_context().generation
    wall -= audit["seconds"]
    launches = audit["launches"]
    check(not report.exceptions,
          f"{run.name}: the analysis failed:\n" + "\n".join(report.exceptions))
    stats = bs.dispatch_stats
    laser = analyzer.last_sym.laser
    found = {issue.swc_id for issue in report.issues.values()}
    declined = segments_declined()
    log(f"analyze {run.name}{label} [{card}]: wall {wall:.3f} s without the "
        f"audits' {audit['seconds']:.3f} s (segments_declined {declined}), "
        f"{laser.total_states} states, "
        f"{prune_stats.calls} prune calls ({prune_stats.batched_calls} "
        f"through the funnel), {stats.dispatches} dispatches ({stats.lanes} "
        f"lanes; {stats.dense_declines} past the dense caps "
        f"{stats.dense_decline_caps}, "
        f"{stats.resident_delegations} delegated, {stats.size_bailouts} "
        f"past the gather caps), {stats.resident_dispatches} resident solves "
        f"({stats.resident_exit_all_decided} all decided, "
        f"{stats.resident_exit_budget} budget, {stats.resident_exit_watchdog} "
        f"watchdog), lanes decided on the device "
        f"{stats.unsat + stats.sat_verified} ({stats.unsat} unsat, "
        f"{stats.sat_verified} sat), on the tail {prune_stats.tail_states}, "
        f"{stats.rounds} rounds, {stats.device_sweeps} full sweeps, "
        f"{dense_rounds(stats)}, "
        f"{stats.frontier_steps} gather steps, {stats.learned_clauses} "
        f"learned clauses, adaptive fuse {'blown' if fused else 'armed'} "
        f"at the end, launches {launches}, device tiers "
        f"{stats.device_s:.3f} s (with the audits), native CDCL "
        f"{SolverStatistics().native_s:.3f} s, SWC {sorted(found)}")
    a = AD.async_stats
    log(f"analyze {run.name}{label} device tiers by tier (with the "
        f"audits): dense {stats.dense_s:.3f} s (of them rounds "
        f"{stats.dense_rounds_s:.3f} s), gather and cone "
        f"{stats.gather_s:.3f} s (of them resident {stats.resident_s:.3f} "
        f"s), of device_s {stats.device_s:.3f} s; word rung "
        f"{stats.word_s:.3f} s")
    log(f"analyze {run.name}{label} supervision: {supervised[0]} "
        f"supervised dispatch attempts, their worker threads' start and "
        f"join {supervised[1] * 1e3:.3f} ms of host time; "
        f"{ladder_quiet(run.name + label, force)}")
    log(f"analyze {run.name}{label} rungs: {stats.profit_skips} profit "
        f"skips, async {a.launches} launches, {a.harvested} harvested, "
        f"{a.unsat} UNSAT lanes, {a.models} models, {a.dropped} dropped, "
        f"{a.abandoned} abandoned; coalescer {stats.coalesced_dispatches} "
        f"dispatches with {stats.coalesced_lanes} queued lanes, "
        f"{stats.coalesce_deferred} lanes deferred")
    solver = SolverStatistics()
    log(f"analyze {run.name}{label} word tier: {stats.host_probe_sat} "
        f"lanes decided by the funnel's host probe, "
        f"{stats.word_decided_unsat} unsat and {stats.word_decided_sat} "
        f"sat by the word tier, {stats.word_tightened_bits} bits pinned, "
        f"word_prop {stats.word_prop_s:.3f} s (with the audit), "
        f"{launches['word_prop']} decide calls on the kernel; host probe "
        f"{solver.probe_s:.3f} s, blast {solver.blast_s:.3f} s, cone "
        f"{solver.cone_s:.3f} s, native CDCL {solver.native_s:.3f} s over "
        f"{solver.native_calls} calls")
    log(f"analyze {run.name}{label} kernels vs plain: "
        f"{audit['sweep'].summary() or 'no sweep'}; "
        f"{audit['step'].summary() or 'no dpll_step'}; hot-prefix sweeps "
        f"{audit['sweep'].hot_prefix_calls()}; "
        f"{audit['frontier'].summary() or 'no frontier kernel'}; "
        f"{audit['round_lane'].summary() or 'no round lane'}; "
        f"{audit['word'].summary() or 'no word fixpoint'}")
    replays = {}
    for issue in report.issues.values():
        status = getattr(issue, "concrete_replay", None)
        replays[status] = replays.get(status, 0) + 1
    log(f"analyze {run.name}{label} lockstep: {stats.presplit_states} "
        f"pre-split states, {launches['lockstep']} launches "
        f"({audit['lockstep'].summary() or 'none'}), replay statuses "
        f"{replays}")
    causes = ", ".join(f"{k} {v}" for k, v in sorted(
        stats.boundary_causes.items()))
    density = (stats.plane_known_bits / stats.plane_total_bits
               if stats.plane_total_bits else 0.0)
    log(f"analyze {run.name}{label} segments: {stats.states_stepped} states "
        f"stepped in segments, segment_s {stats.segment_s:.3f} s (with the "
        f"audits), {stats.needs_host_boundaries} host boundaries ({causes}), "
        f"plane density {stats.plane_known_bits}/{stats.plane_total_bits} "
        f"known bits ({density:.3f}), {stats.mem_plane_ops} memory and "
        f"{stats.storage_plane_ops} storage plane ops, "
        f"{stats.keccak_device_hashes} keccak hashes in "
        f"{launches['keccak']} launches "
        f"({audit['keccak'].summary() or 'none'})")
    log(f"analyze {run.name}{label} veritest: {stats.merges} merges "
        f"({stats.merged_lanes} lanes merged away, {stats.merge_ites} ite "
        f"terms, {stats.merge_aborts} aborted), {stats.subsume_sweeps} "
        f"subsumption sweeps retiring {stats.subsumed_lanes} lanes, "
        f"merge_span_s {stats.merge_span_s:.3f} s")
    pilot = plane_line(run.name, label)
    merges = run.merges if veritest_enabled() else 0
    check(stats.merges == merges,
          f"{run.name}: {stats.merges} merges, the JAX package makes "
          f"{merges}")
    check(None not in replays, f"{run.name}: an issue was not replayed")
    check(launches["lockstep"] > 0, f"{run.name}: no lockstep launch")
    check(stats.states_stepped > 0, f"{run.name}: no segment ran")
    check((launches["keccak"] > 0) == (stats.keccak_device_hashes > 0)
          and audit["keccak"].calls == launches["keccak"],
          f"{run.name}: {stats.keccak_device_hashes} keccak hashes in "
          f"{launches['keccak']} launches of {audit['keccak'].calls} calls")
    check((stats.presplit_states > 0) == run.presplit,
          f"{run.name}: {stats.presplit_states} pre-split states")
    check(found == run.swc_ids,
          f"{run.name}: SWC {sorted(found)} != {sorted(run.swc_ids)}")
    check(not laser.timed_out and time_handler.time_remaining() > 0,
          f"{run.name}: the execution deadline cut the run")
    check(a.dropped == 0 and a.abandoned == 0,
          f"{run.name}: {a.dropped} prefetches dropped, {a.abandoned} "
          f"abandoned")
    return launches, {"dispatches": stats.dispatches,
                      "resident": stats.resident_dispatches, "wall": wall,
                      "declined": declined, "states": laser.total_states,
                      "keccak": audit["keccak"].captured,
                      "states_stepped": stats.states_stepped,
                      "autopilot": pilot}


def alternated_walls(run, card):
    """``run`` in the default rungs and CDCL only (the batched path off)
    in turns, default, CDCL only, CDCL only, default, without audits:
    [(wall, states, segments_declined, batched)], logged with the card's
    name and power limit."""
    from mythril_tpu_torch.smt import SolverStatistics

    got = []
    for batched in (True, False, False, True):
        if batched:
            report, analyzer, wall = analyze_once(run, force=False)
        else:
            report, analyzer, wall = analyze_once(run, batched_solving=False)
        found = {issue.swc_id for issue in report.issues.values()}
        label = "default rungs" if batched else "CDCL only"
        check(not report.exceptions and found == run.swc_ids,
              f"{run.name} {label}: SWC {sorted(found)}")
        got.append((wall, analyzer.last_sym.laser.total_states,
                    segments_declined(), batched,
                    SolverStatistics().native_s))
    log(f"analyze walls {run.name} alternated [{card}] (wall, states, "
        f"segments_declined, native CDCL): " + ", ".join(
            f"{'default rungs' if batched else 'CDCL only'} {wall:.3f} s, "
            f"{states}, {declined}, {native:.3f} s"
            for wall, states, declined, batched, native in got))
    return got


def analyze_phase(card):
    """The chip runs through the port's analyzer on ``cuda``: each in the
    JAX default configuration of the rungs (what ``myth analyze`` runs),
    then force-dispatched (every kernel launched on its main path); the
    scale runs also CDCL-only; then the ``MYTHRIL_TPU_RESIDENT_KERNEL=0``
    yardstick and the veritesting run fork-only
    (``MYTHRIL_TPU_VERITEST=0``).  Returns the launches of every kernel
    over the batched runs in both configurations, those of the last two
    runs, and the keccak calls the analyses captured."""
    from mythril_tpu_torch.contracts import (
        CHIP_RUNS,
        VERITEST_RUN,
        YARDSTICK_RUN,
        constant_key_mapping,
    )

    total = {}
    walls = {}
    hashed = []
    for run in CHIP_RUNS:
        launches, stats = analyze_audited(run, card, " default rungs",
                                          force=False)
        walls[run.name] = [(stats["wall"], stats["states"],
                            stats["declined"])]
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        hashed += stats["keccak"]
        if run.code is constant_key_mapping:
            check(launches["keccak"] > 0,
                  f"{run.name}: no keccak launch in the default rungs")
    through_resident = False
    stepped = {}
    for run in CHIP_RUNS:
        launches, stats = analyze_audited(run, card, " force-dispatched")
        if run.dense and not stats["dispatches"] and stats["autopilot"].get(
                "tail_routes"):
            # the autopilot routed the run's lanes to the CDCL tail (the
            # JAX package routes them alike on the CPU): the kernel audit
            # runs again with the routing off
            log(f"analyze {run.name}: the autopilot routed "
                f"{stats['autopilot']['tail_routes']} lanes to the tail and "
                f"no dispatch ran; auditing the kernels again under "
                f"MYTHRIL_TPU_AUTOPILOT=0")
            with env(MYTHRIL_TPU_AUTOPILOT="0"):
                launches, stats = analyze_audited(
                    run, card, " force-dispatched, MYTHRIL_TPU_AUTOPILOT=0")
        stepped[run.name] = stats["states_stepped"]
        walls[run.name].append((stats["wall"], stats["states"],
                                stats["declined"]))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if stats["resident"] and all(launches[k] for k in FRONTIER_KERNELS):
            through_resident = True
        if run.dense:
            check(stats["dispatches"] >= 1,
                  f"{run.name}: no device dispatch")
            check(sum(launches.values()) > 0,
                  f"{run.name}: no kernel launched")
            alternated = alternated_walls(run, card)
            walls[run.name].append(next(w[:3] for w in alternated
                                        if not w[3]))
    check(through_resident, "no analysis went through the resident solver "
          "with all three frontier kernels")
    for name, w in walls.items():
        ANALYZE_WALLS[name] = [wall for wall, _states, _declined in w]
        log(f"analyze walls {name} [{card}] (wall, states, "
            f"segments_declined): " + ", ".join(
                f"{label} {wall:.3f} s, {states}, {declined}"
                for label, (wall, states, declined) in zip(
                    ("default rungs", "force-dispatched", "CDCL only"), w))
            + "; compare walls only at equal states")
    # the cost of the ledger and the autopilot: the scale runs in the
    # default rungs with both planes off, beside the default's walls
    for run in CHIP_RUNS:
        if not run.dense:
            continue
        with env(MYTHRIL_TPU_AUTOPILOT="0", MYTHRIL_TPU_LEDGER="0"):
            _l, stats = analyze_audited(
                run, card, " MYTHRIL_TPU_AUTOPILOT=0 MYTHRIL_TPU_LEDGER=0",
                force=False)
        wall, states, declined = walls[run.name][0]
        log(f"analyze planes cost {run.name} [{card}]: default rungs "
            f"{wall:.3f} s ({states} states, segments_declined "
            f"{declined}) with the ledger and the autopilot, "
            f"{stats['wall']:.3f} s ({stats['states']} states, "
            f"segments_declined {stats['declined']}) with both off")
    cli_phase(card)
    # the yardstick of the resident solver, force-dispatched on the dense
    # tier (cut to depth 4 to keep the check within its time)
    with env(MYTHRIL_TPU_RESIDENT_KERNEL="0"):
        launches, stats = analyze_audited(
            YARDSTICK_RUN, card, " MYTHRIL_TPU_RESIDENT_KERNEL=0")
    check(stats["resident"] == 0 and launches["dense_sweep"] > 0
          and launches["dpll_step"] > 0,
          "the RESIDENT_KERNEL=0 yardstick did not run the dense tier")
    # the veritesting run fork-only: the same findings, more states
    with env(MYTHRIL_TPU_VERITEST="0"):
        forked, stats = analyze_audited(
            VERITEST_RUN, card, " MYTHRIL_TPU_VERITEST=0")
    check(stats["states_stepped"] > stepped[VERITEST_RUN.name],
          f"{VERITEST_RUN.name}: {stats['states_stepped']} states stepped "
          f"fork-only, {stepped[VERITEST_RUN.name]} merged")
    _add(launches, forked)
    return total, launches, hashed


def cli_phase(card):
    """One ``python3 -m mythril_tpu_torch analyze`` process on the card
    with the observability plane's three artifacts written into a
    temporary directory: the trace parses with ``traceEvents``, the
    Prometheus text parses, the ledger holds conservation and legality,
    the jsonv2 report has ``meta.observability`` and the run's SWC set."""
    import tempfile

    from mythril_tpu_torch.contracts import killbilly

    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, k) for k in ("code.hex", "trace.json",
                                                   "metrics.prom",
                                                   "ledger.json")}
        with open(paths["code.hex"], "w") as fh:
            fh.write(killbilly())
        started = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
             paths["code.hex"], "--bin-runtime", "-t", "1",
             "--no-onchain-data", "-o", "jsonv2",
             "--trace-out", paths["trace.json"],
             "--metrics-out", paths["metrics.prom"],
             "--lane-ledger-out", paths["ledger.json"]],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - started
        check(run.returncode == 0,
              f"CLI: exit {run.returncode}: {run.stderr[-2000:]}")
        report = json.loads(run.stdout)[0]
        check("resilience" not in report["meta"],
              f"CLI: the ladder acted on a healthy card: meta.resilience "
              f"{report['meta'].get('resilience')}")
        meta = report["meta"].get("observability")
        check(meta and meta["trace_out"] == paths["trace.json"],
              f"CLI: meta.observability {meta}")
        found = {i["swcID"] for i in report["issues"]}
        with open(paths["trace.json"]) as fh:
            trace = json.load(fh)
        events = trace["traceEvents"]
        check(events and all("ph" in e and "name" in e for e in events),
              "CLI: the trace has no events")
        samples = {}
        with open(paths["metrics.prom"]) as fh:
            for line in fh.read().splitlines():
                if line.startswith("#"):
                    check(line.startswith(("# HELP ", "# TYPE ")),
                          f"CLI: metrics line {line!r}")
                    continue
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        with open(paths["ledger.json"]) as fh:
            payload = json.load(fh)
        agg = check_ledger(payload["aggregates"], payload["records"], "CLI")
        check(payload["conservation"]["decided_total"]
              == agg["lanes_total"], f"CLI: {payload['conservation']}")
    check(found == {"SWC-106"} and agg["lanes_total"] == meta["ledger_lanes"]
          == samples["mythril_tpu_ledger_lanes_total"],
          f"CLI: SWC {found}, ledger {agg['lanes_total']} lanes, meta "
          f"{meta['ledger_lanes']}, metrics "
          f"{samples.get('mythril_tpu_ledger_lanes_total')}")
    spans = sorted({e["name"] for e in events if e["ph"] == "X"})
    log(f"CLI analyze killbilly -t 1 with --trace-out --metrics-out "
        f"--lane-ledger-out [{card}]: exit 0 in {wall:.3f} s (process "
        f"included), SWC {sorted(found)}, {len(events)} trace events "
        f"({meta['span_events']} spans; names {spans}), {len(samples)} "
        f"metric samples, ledger {agg['lanes_total']} lanes = decided "
        f"{agg['decided']}, every path legal; meta.observability keys "
        f"{sorted(meta)}")


# ---------------------------------------------------------------------------
# the resilience plane: injected faults on the card, kill and resume, the
# drain, a real launch failure, the cost of supervision
# ---------------------------------------------------------------------------

#: the resilience phase's run (``contracts.CHIP_RUNS``), force-dispatched
RESILIENCE_RUN = "scale_mul d6 g16 -t 1"
#: the drain's run: long enough that a SIGTERM lands mid-analysis
DRAIN_RUN = "scale_mul d4 g16 -t 2"
#: the hang's deadline and sleep (a few seconds apart)
HANG_TIMEOUT_S = "2"
HANG_S = "5"
#: retries of the ladder (its default): attempts a dispatch gets
LADDER_ATTEMPTS = 3
#: the ladder's counters that a healthy card leaves at 0 under the
#: watchdog's real deadlines
LADDER_COUNTERS = ("watchdog_trips", "dispatch_retries", "demotions")
#: the phase's runs route on counts only (the segment ceiling is the one
#: wall-clock rule of the routing), so a fault lands where it was aimed
DETERMINISTIC = {"MYTHRIL_TPU_SEG_CEIL_MS": "1e9"}


def bisect_calls(n, position):
    """Sub-dispatches of the ladder's bisection over ``n`` lanes that
    carry the lane at ``position`` (``BatchedSatBackend._dispatch_round``
    splits at ``len // 2`` down to single lanes)."""
    lo, hi, calls = 0, n, 0
    while hi - lo > 1:
        half = (hi - lo) // 2
        lo, hi = (lo, lo + half) if position < lo + half else (lo + half, hi)
        calls += 1
    return calls


def resilience_run(run, fault="", force=True, record=None, **knobs):
    """One analysis of ``run`` with the fault plane armed from
    ``MYTHRIL_TPU_FAULT=fault`` (and ``knobs`` in the environment), the
    planes and counters fresh, its kernel launches counted; ``record``
    (a list) collects the lane ids of every dispatch-seam hit.  Returns
    what the phase checks."""
    from mythril_tpu_torch.laser.batch import prune_stats
    from mythril_tpu_torch.observability.ledger import get_ledger
    from mythril_tpu_torch.ops import async_dispatch as AD
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.resilience import checkpoint, faults, watchdog
    from mythril_tpu_torch.resilience.telemetry import resilience_stats

    with env(MYTHRIL_TPU_FAULT=fault or None, **DETERMINISTIC, **knobs):
        faults.reset_for_tests()
        watchdog.reset_for_tests()
        checkpoint.reset_for_tests()
        real = faults.maybe_fault_dispatch
        if record is not None:
            def recording(lane_ids=None):
                record.append(None if lane_ids is None else list(lane_ids))
                return real(lane_ids=lane_ids)

            faults.maybe_fault_dispatch = recording
        reset_launches()
        try:
            report, analyzer, wall = analyze_once(run_by_name(run),
                                                  force=force)
        finally:
            faults.maybe_fault_dispatch = real
        launches = read_launches()
        out = {
            "swc": {i.swc_id for i in report.issues.values()},
            "states": analyzer.last_sym.laser.total_states,
            "tail": prune_stats.tail_states,
            "dispatches": bs.dispatch_stats.dispatches,
            "sat_verified": bs.dispatch_stats.sat_verified,
            "fused": bs.dispatch_stats.fused,
            "resilience": resilience_stats.as_dict(),
            "transitions": dict(get_ledger().snapshot()["transitions"]),
            "dropped": AD.async_stats.dropped,
            "launches": launches, "wall": wall, "report": report,
            "fired": dict(faults.get_fault_plane().fired),
            "supervised": watchdog.get_watchdog().runs,
        }
        faults.reset_for_tests()
    check(not report.exceptions, f"resilience {fault or 'fault-free'}: "
          f"the analysis failed:\n" + "\n".join(report.exceptions))
    return out


def run_by_name(name):
    from mythril_tpu_torch.contracts import CHIP_RUNS

    return next(r for r in CHIP_RUNS if r.name == name)


def same_findings(what, got, base, tail=False):
    """The faulted run's SWC set and states are the fault-free run's
    (and its tail lanes, where the device still decides alike)."""
    check(got["swc"] == base["swc"] and got["states"] == base["states"],
          f"{what}: SWC {sorted(got['swc'])}, {got['states']} states; the "
          f"fault-free run {sorted(base['swc'])}, {base['states']}")
    if tail:
        check(got["tail"] == base["tail"],
              f"{what}: {got['tail']} tail lanes, fault-free {base['tail']}")


def resilience_line(what, card, got):
    counters = {k: v for k, v in got["resilience"].items() if v}
    log(f"resilience {what} [{card}]: wall {got['wall']:.3f} s, SWC "
        f"{sorted(got['swc'])}, {got['states']} states, {got['tail']} tail "
        f"lanes, {got['dispatches']} dispatches, {got['supervised']} "
        f"supervised attempts, faults fired {got['fired']}, counters "
        f"{counters}, ledger transitions {got['transitions']}, launches "
        f"{got['launches']}")


def resilience_phase(card):
    """The resilience plane on the card: the force-dispatched
    ``scale_mul d6 -t 1`` with one fault a run, each armed through
    ``MYTHRIL_TPU_FAULT`` with a skip that lands it mid-analysis (the
    fault-free run records the dispatch seam's hits to aim them), then
    kill and resume and a SIGTERM drain through the CLI, and a real
    launch failure.  Returns the launches of its runs."""
    from mythril_tpu_torch.observability import flight, spans
    from mythril_tpu_torch.ops import device_health
    from mythril_tpu_torch.resilience import checkpoint, governor

    total = {}
    hits = []
    base = resilience_run(RESILIENCE_RUN, record=hits)
    resilience_line("fault-free", card, base)
    _add(total, base["launches"])
    check(base["dispatches"] > 0 and len(hits) > 1,
          f"resilience: {base['dispatches']} dispatches, {len(hits)} "
          f"dispatch-seam hits")
    check(not any(base["resilience"].values()) and not base["fused"],
          f"resilience fault-free: counters {base['resilience']}, fuse "
          f"{'blown' if base['fused'] else 'armed'}")
    mid = len(hits) // 2

    # one injected error mid-analysis: the retry recovers it
    got = resilience_run(RESILIENCE_RUN, f"dispatch_error:1:{mid}")
    resilience_line(f"dispatch_error:1:{mid}", card, got)
    _add(total, got["launches"])
    same_findings("dispatch_error", got, base, tail=True)
    check(got["resilience"]["dispatch_retries"] >= 1
          and got["resilience"]["demotions"] == 0 and not got["fused"],
          f"dispatch_error: {got['resilience']}")

    # a poisoned lane of a dispatch that carries two or more: exactly it
    # is quarantined (3 attempts, then each bisection call it rides)
    k = next(i for i in list(range(mid, len(hits))) + list(range(mid))
             if hits[i] and len(hits[i]) >= 2)
    lane = hits[k][0]
    skip = sum(1 for h in hits[:k] if h and lane in h)
    shots = LADDER_ATTEMPTS + bisect_calls(len(hits[k]), 0)
    spec = f"lane_poison:{shots}:{skip}:{lane}"
    got = resilience_run(RESILIENCE_RUN, spec)
    resilience_line(spec, card, got)
    _add(total, got["launches"])
    same_findings("lane_poison", got, base)
    r = got["resilience"]
    check(r["quarantined_lanes"] == 1 and r["bisect_dispatches"] > 0
          and r["demotions"] == 0
          and got["transitions"].get("quarantined") == r["quarantined_lanes"],
          f"lane_poison: {r}, ledger {got['transitions']}")

    # a hang mid-analysis: the watchdog trips once on the card's stream
    # (terminal there: no retry, no bisection), the flight ring is
    # dumped, the re-probe answers and the context goes to the CDCL
    spec = f"dispatch_hang:1:{mid}"
    probes = []
    real_probe = device_health.subprocess_probe_ok

    def probe(timeout_s=None):
        probes.append(real_probe(timeout_s))
        return probes[-1]

    import tempfile

    tracer = spans.get_tracer()
    recorder = flight.get_flight_recorder()
    with tempfile.TemporaryDirectory() as tmp:
        recorder.configure(tmp)
        tracer.enable(record_events=True)
        device_health.subprocess_probe_ok = probe
        try:
            got = resilience_run(
                RESILIENCE_RUN, spec,
                MYTHRIL_TPU_DISPATCH_TIMEOUT=HANG_TIMEOUT_S,
                MYTHRIL_TPU_FAULT_HANG_S=HANG_S)
        finally:
            device_health.subprocess_probe_ok = real_probe
            tracer.disable()
            recorder.configure(None)
        dumps = sorted(os.listdir(tmp))
    resilience_line(f"{spec} (deadline {HANG_TIMEOUT_S} s, hang {HANG_S} s)",
                    card, got)
    log(f"resilience dispatch_hang: flight dumps {dumps}, re-probes "
        f"{probes}")
    _add(total, got["launches"])
    same_findings("dispatch_hang", got, base)
    r = got["resilience"]
    check(r["watchdog_trips"] == 1 and r["dispatch_retries"] == 0
          and r["bisect_dispatches"] == 0 and r["demotions"] == 1
          and got["fused"] and probes == [True]
          and any("watchdog_trip" in d for d in dumps)
          and any("demotion" in d for d in dumps),
          f"dispatch_hang: {r}, re-probes {probes}, dumps {dumps}")

    # garbage: host verification rejects every forged SAT
    got = resilience_run(RESILIENCE_RUN, "dispatch_garbage:1000000")
    resilience_line("dispatch_garbage:1000000", card, got)
    _add(total, got["launches"])
    same_findings("dispatch_garbage", got, base)
    check(got["sat_verified"] == 0 and got["fired"].get("dispatch_garbage"),
          f"dispatch_garbage: {got['sat_verified']} SAT verified, fired "
          f"{got['fired']}")

    # the prefetch in the default rungs: an injected failure drops a batch
    got = resilience_run(RESILIENCE_RUN, "prefetch_error:1", force=False)
    resilience_line("prefetch_error:1 (default rungs)", card, got)
    _add(total, got["launches"])
    same_findings("prefetch_error", got, base)
    check(got["dropped"] >= 1 and not any(
              got["resilience"][k] for k in LADDER_COUNTERS),
          f"prefetch_error: {got['dropped']} dropped, {got['resilience']}")

    # the governor's four rungs, in order, named in the report
    got = resilience_run(RESILIENCE_RUN, "governor_breach:4")
    meta = json.loads(got["report"].as_swc_standard_format())[0]["meta"]
    block = meta.get("resilience", {})
    resilience_line("governor_breach:4", card, got)
    log(f"resilience governor_breach:4 meta.resilience: {block}")
    _add(total, got["launches"])
    check(block.get("partial") is True
          and block.get("governor", {}).get("rungs") == list(governor.RUNGS)
          and got["swc"] <= base["swc"],
          f"governor_breach: meta.resilience {block}")
    checkpoint.reset_for_tests()

    cli_resilience(card, len(hits))
    launch_failure(card)
    return total


def cli_analyze(hexfile, *extra, env_extra=None, popen=False):
    argv = [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
            hexfile, "--bin-runtime", "--no-onchain-data", "-o", "jsonv2",
            *extra]
    environ = dict(os.environ, **DETERMINISTIC, **(env_extra or {}))
    root = os.path.dirname(os.path.abspath(__file__))
    if popen:
        return subprocess.Popen(argv, cwd=root, env=environ, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
    return subprocess.run(argv, cwd=root, env=environ, capture_output=True,
                          text=True, timeout=600)


def cli_report(what, done):
    check(done.returncode == 0,
          f"{what}: exit {done.returncode}: {done.stderr[-2000:]}")
    report = json.loads(done.stdout)[0]
    return ({i["swcID"].replace("SWC-", "") for i in report["issues"]},
            report["meta"].get("resilience", {}))


def cli_resilience(card, dispatch_hits):
    """Kill and resume, and a SIGTERM drain and resume, through the CLI
    on the card."""
    import signal
    import tempfile

    from mythril_tpu_torch.resilience.checkpoint import _generations

    kill = run_by_name(RESILIENCE_RUN)
    drain = run_by_name(DRAIN_RUN)
    with tempfile.TemporaryDirectory() as tmp:
        for run in (kill, drain):
            path = os.path.join(tmp, run.name.split()[1] + ".hex")
            with open(path, "w") as fh:
                fh.write(run.code())
        hexkill = os.path.join(tmp, kill.name.split()[1] + ".hex")
        hexdrain = os.path.join(tmp, drain.name.split()[1] + ".hex")
        # SIGKILL at a dispatch seam mid-analysis, then --resume
        journal = os.path.join(tmp, "kill")
        at = f"dispatch_error:{dispatch_hits // 2}"
        started = time.perf_counter()
        done = cli_analyze(hexkill, "-t", str(kill.transaction_count),
                           "--device-force-dispatch", "--no-async-dispatch",
                           "--checkpoint-dir", journal,
                           env_extra={"MYTHRIL_TPU_KILL_AT": at,
                                      "MYTHRIL_TPU_COALESCE": "0"})
        killed = time.perf_counter() - started
        generations = _generations(journal)
        check(done.returncode == -signal.SIGKILL and generations,
              f"CLI kill at {at}: exit {done.returncode}, journal "
              f"{generations}: {done.stderr[-2000:]}")
        started = time.perf_counter()
        found, block = cli_report("CLI --resume", cli_analyze(
            hexkill, "-t", str(kill.transaction_count),
            "--device-force-dispatch", "--no-async-dispatch",
            "--resume", journal, env_extra={"MYTHRIL_TPU_COALESCE": "0"}))
        resumed = time.perf_counter() - started
        check(found == kill.swc_ids and block.get("resumes") == 1,
              f"CLI resume after the kill: SWC {found}, meta.resilience "
              f"{block}")
        log(f"resilience CLI {kill.name} killed at {at} [{card}]: exit "
            f"{done.returncode} after {killed:.3f} s with {len(generations)} "
            f"journal generations kept; --resume exit 0 in {resumed:.3f} s, "
            f"SWC {sorted(found)}, meta.resilience {block}")
        # SIGTERM mid-analysis: a partial report, then --resume
        journal = os.path.join(tmp, "drain")
        args = ("-t", str(drain.transaction_count), "--checkpoint-dir",
                journal)
        started = time.perf_counter()
        proc = cli_analyze(hexdrain, *args, popen=True,
                           env_extra={"MYTHRIL_TPU_CHECKPOINT_PERIOD": "0"})
        while proc.poll() is None and not any(
                g >= 3 for g, _ in _generations(journal)):
            time.sleep(0.05)
        signalled = time.perf_counter() - started
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=600)
        drained = subprocess.CompletedProcess(proc.args, proc.returncode,
                                              out, err)
        partial, block = cli_report("CLI SIGTERM", drained)
        check(block.get("partial") is True,
              f"CLI SIGTERM after {signalled:.3f} s: meta.resilience {block}")
        started = time.perf_counter()
        found, resumed_block = cli_report(
            "CLI --resume after the drain",
            cli_analyze(hexdrain, "-t", str(drain.transaction_count),
                        "--resume", journal))
        resumed = time.perf_counter() - started
        check(found == drain.swc_ids and resumed_block.get("resumes") == 1
              and not resumed_block.get("partial"),
              f"CLI resume after the drain: SWC {found}, meta.resilience "
              f"{resumed_block}")
        log(f"resilience CLI {drain.name} SIGTERM after {signalled:.3f} s "
            f"[{card}]: exit 0, partial SWC {sorted(partial)}, "
            f"meta.resilience {block}; --resume exit 0 in {resumed:.3f} s, "
            f"SWC {sorted(found)}, meta.resilience {resumed_block}")


#: the real launch failure, in a process of its own: the resident pool
#: sized past what the round epilogue's block can stage, with the port's
#: own shared-memory check lifted, so that the card refuses the launch
LAUNCH_FAILURE = r"""
import json, sys
import numpy as np
from mythril_tpu_torch import frontiers
from mythril_tpu_torch.ops import frontier_kernels as FK
from mythril_tpu_torch.ops import batched_sat as bs
from mythril_tpu_torch.ops.device_health import DeviceLost
from mythril_tpu_torch.resilience.telemetry import resilience_stats as rs
from mythril_tpu_torch.support.support_args import FORCE_DISPATCH_ARGS, args
for name, value in FORCE_DISPATCH_ARGS.items():
    setattr(args, name, value)
FK.MAX_DYNAMIC_SMEM = 1 << 30
lanes, _ = frontiers.guard_chain_frontier(64, 32)
out = {"error": None}
try:
    bs.batch_check_states(lanes, device="cuda")
except DeviceLost as exc:
    out["error"] = "DeviceLost: " + str(exc)
except Exception as exc:
    out["error"] = type(exc).__name__ + ": " + str(exc)
out.update(retries=rs.dispatch_retries, demotions=rs.demotions,
           trips=rs.watchdog_trips, resident=bs.dispatch_stats.resident_dispatches,
           launches=dict(FK.launch_counts))
print(json.dumps(out))
"""


def launch_failure(card):
    """A supervised dispatch of a real kernel that the card refuses
    raises out of the ladder: no retry, no demotion, no ``DeviceLost``."""
    started = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-c", LAUNCH_FAILURE],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, MYTHRIL_TPU_RESIDENT_EXTRA="8192"),
        capture_output=True, text=True, timeout=600)
    check(done.returncode == 0,
          f"launch failure: exit {done.returncode}: {done.stderr[-2000:]}")
    out = json.loads(done.stdout.strip().splitlines()[-1])
    log(f"resilience real launch failure [{card}]: {out} in "
        f"{time.perf_counter() - started:.3f} s (process included)")
    check(out["error"] and out["error"].startswith("RuntimeError")
          and "cudaError" in out["error"] and out["retries"] == 0
          and out["demotions"] == 0 and out["trips"] == 0,
          f"launch failure: {out}")


#: the knowledge plane's and the proof log's run (the resilience phase's)
PERSIST_RUN = RESILIENCE_RUN
PROOF_RUN = RESILIENCE_RUN


def thaw_recorder():
    """The knowledge plane's ``apply_knowledge`` wrapped (in this
    script, not the package) to record what each warm start thawed:
    returns the list it appends to and the function that unwraps it."""
    from mythril_tpu_torch.parallel import gossip

    real, thawed = gossip.apply_knowledge, []

    def recording(ctx, body):
        applied = real(ctx, body)
        thawed.append(applied)
        return applied

    gossip.apply_knowledge = recording

    def restore():
        gossip.apply_knowledge = real

    return thawed, restore


def persist_run(run, force, what, card, thawed):
    """One analysis of ``run`` with the knowledge plane on (the caller
    sets its directory): what the phase checks, logged."""
    from mythril_tpu_torch.laser.batch import prune_stats
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.persist.plane import get_knowledge_plane
    from mythril_tpu_torch.resilience.telemetry import resilience_stats

    seen = len(thawed)
    reset_launches()
    report, analyzer, wall = analyze_once(run, force=force)
    launches = read_launches()
    check(not report.exceptions, f"persist {what}: the analysis failed:\n"
          + "\n".join(report.exceptions))
    stats = bs.dispatch_stats
    store = get_knowledge_plane().store
    got = {"swc": {i.swc_id for i in report.issues.values()},
           "states": analyzer.last_sym.laser.total_states,
           "tail": prune_stats.tail_states,
           "hits": stats.persist_warm_hits,
           "misses": stats.persist_warm_misses,
           "thawed": thawed[seen:],
           "flushes": resilience_stats.persist_flushes,
           "corrupt": resilience_stats.persist_corrupt_segments,
           "quarantined": sum(name.endswith(".quarantined")
                              for name in os.listdir(store.directory)),
           "dispatches": stats.dispatches, "launches": launches,
           "wall": wall, "declined": segments_declined()}
    thaws = ", ".join(f"+{t['unsat']} unsat, +{t['probe_sat']} probe, "
                      f"+{t['models']} models" for t in got["thawed"])
    log(f"persist {run.name} {what} [{card}]: wall {wall:.3f} s "
        f"(segments_declined {got['declined']}), SWC {sorted(got['swc'])}, "
        f"{got['states']} states, {got['tail']} tail lanes, "
        f"persist_warm_hits {got['hits']}, persist_warm_misses "
        f"{got['misses']}, thawed {thaws or 'nothing'}, persist_flushes "
        f"{got['flushes']}, persist_corrupt_segments {got['corrupt']} "
        f"({got['quarantined']} .quarantined files), {store.loaded_records} "
        f"records loaded, {got['dispatches']} dispatches, launches "
        f"{launches}")
    check(got["swc"] == run.swc_ids,
          f"persist {what}: SWC {sorted(got['swc'])} != "
          f"{sorted(run.swc_ids)}")
    return got


def persist_phase(card):
    """The knowledge plane on the card: ``scale_mul d6 -t 1`` in the
    default rungs and force-dispatched, each a cold run with the store
    in a fresh directory, a restart (``reset_for_tests``) warm from it,
    and a restart after every segment was bit-flipped (a cold run with
    the segments quarantined); then two CLI processes sharing a
    ``--persist-dir`` and one under ``MYTHRIL_TPU_PERSIST=0``.  Returns
    the launches of its analyses."""
    import tempfile

    from mythril_tpu_torch.contracts import killbilly
    from mythril_tpu_torch.persist import plane

    run = run_by_name(PERSIST_RUN)
    total = {}
    thawed, restore = thaw_recorder()
    try:
        for force in (False, True):
            label = "force-dispatched" if force else "default rungs"
            with tempfile.TemporaryDirectory() as tmp, env(
                    MYTHRIL_TPU_PERSIST_DIR=tmp,
                    MYTHRIL_TPU_PERSIST_FLUSH_S="0", **DETERMINISTIC):
                got = {}
                for what in ("cold", "warm", "corrupted"):
                    plane.reset_for_tests()  # a process restart
                    if what == "corrupted":
                        for name in os.listdir(tmp):
                            if name.startswith("seg-"):
                                path = os.path.join(tmp, name)
                                with open(path, "r+b") as fh:
                                    raw = bytearray(fh.read())
                                    raw[len(raw) // 2] ^= 0xFF
                                    fh.seek(0)
                                    fh.write(raw)
                    got[what] = persist_run(run, force, f"{label} {what}",
                                            card, thawed)
                    _add(total, got[what]["launches"])
                plane.reset_for_tests()
            states = {what: g["states"] for what, g in got.items()}
            check(len(set(states.values())) == 1,
                  f"persist {label}: states {states}")
            check(got["cold"]["misses"] == 1 and got["cold"]["flushes"] >= 1,
                  f"persist {label} cold: {got['cold']['misses']} misses, "
                  f"{got['cold']['flushes']} flushes")
            check(got["warm"]["hits"] >= 1 and got["warm"]["thawed"],
                  f"persist {label} warm: {got['warm']['hits']} hits")
            check(got["corrupted"]["hits"] == 0
                  and got["corrupted"]["corrupt"] >= 1
                  and got["corrupted"]["quarantined"] >= 1,
                  f"persist {label} corrupted: {got['corrupted']['hits']} "
                  f"hits, {got['corrupted']['corrupt']} corrupt segments")
            log(f"persist walls {run.name} {label} [{card}] (equal states "
                f"{states['cold']}): cold {got['cold']['wall']:.3f} s, warm "
                f"{got['warm']['wall']:.3f} s, corrupted "
                f"{got['corrupted']['wall']:.3f} s")
    finally:
        restore()
        plane.reset_for_tests()

    with tempfile.TemporaryDirectory() as tmp:
        hexfile = os.path.join(tmp, "killbilly.hex")
        with open(hexfile, "w") as fh:
            fh.write(killbilly())
        store = os.path.join(tmp, "store")
        blocks, walls = [], []
        for n in (1, 2):
            started = time.perf_counter()
            found, block = cli_report(f"persist CLI run {n}", cli_analyze(
                hexfile, "-t", "1", "--persist-dir", store))
            walls.append(time.perf_counter() - started)
            check(found == {"106"}, f"persist CLI run {n}: SWC {found}")
            blocks.append(block.get("persist", {}))
        check(blocks[0].get("warm_misses") == 1
              and blocks[1].get("warm_hits") == 1,
              f"persist CLI: meta.resilience.persist {blocks}")
        killed = os.path.join(tmp, "killed")
        found, block = cli_report("persist CLI, MYTHRIL_TPU_PERSIST=0",
                                  cli_analyze(hexfile, "-t", "1",
                                              "--persist-dir", killed,
                                              env_extra={
                                                  "MYTHRIL_TPU_PERSIST": "0"}))
        left = os.listdir(killed) if os.path.exists(killed) else []
        check(found == {"106"} and "persist" not in block and not left,
              f"persist CLI under MYTHRIL_TPU_PERSIST=0: SWC {found}, "
              f"meta.resilience {block}, files {left}")
        log(f"persist CLI [{card}]: two processes on one --persist-dir, "
            f"walls {walls[0]:.3f} s and {walls[1]:.3f} s, "
            f"meta.resilience.persist {blocks[0]} then {blocks[1]}; "
            f"MYTHRIL_TPU_PERSIST=0 left the directory empty")
    return total


def proof_run(run, force, card):
    """One analysis of ``run`` under ``proof_log`` on a fresh blast
    context, each host confirmation of a device refutation tallied by
    its answer (a wrapper of ``BlastContext.confirm_unsat`` that lives
    in this script): what the phase checks, logged."""
    from mythril_tpu_torch.native import SatSolver
    from mythril_tpu_torch.ops import async_dispatch as AD
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.smt.bitblast import BlastContext
    from mythril_tpu_torch.smt.solver import get_blast_context

    label = "force-dispatched" if force else "default rungs"
    answers = {SatSolver.UNSAT: "unsat", SatSolver.SAT: "sat"}
    tally = {"unsat": 0, "sat": 0, "budget": 0}
    real = BlastContext.confirm_unsat

    def tallied(self, lits, conflict_budget=4000):
        solve, statuses = self.solver.solve, []

        def recording(*args, **kwargs):
            statuses.append(solve(*args, **kwargs))
            return statuses[-1]

        self.solver.solve = recording
        try:
            return real(self, lits, conflict_budget=conflict_budget)
        finally:
            del self.solver.solve
            if statuses:
                tally[answers.get(statuses[-1], "budget")] += 1

    BlastContext.confirm_unsat = tallied
    supervised = supervision()[0]
    reset_launches()
    try:
        with env(**DETERMINISTIC):
            report, analyzer, wall = analyze_once(run, force=force,
                                                  proof_log=True)
    finally:
        BlastContext.confirm_unsat = real
    launches = read_launches()
    supervised = supervision()[0] - supervised
    check(not report.exceptions, f"proof {label}: the analysis failed "
          f"(a ProofError among them?):\n" + "\n".join(report.exceptions))
    ctx = get_blast_context()
    stats = bs.dispatch_stats
    got = {"swc": {i.swc_id for i in report.issues.values()},
           "states": analyzer.last_sym.laser.total_states,
           "tally": tally, "wall": wall, "supervised": supervised,
           "dispatches": stats.dispatches, "unsat": stats.unsat,
           "async_unsat": AD.async_stats.unsat,
           "harvested": ctx.device_learned, "learned": stats.learned_clauses,
           "launches": launches, "solver": ctx.solver,
           "declined": segments_declined()}
    log(f"proof {run.name} {label} [{card}]: wall {wall:.3f} s "
        f"(segments_declined {got['declined']}), SWC {sorted(got['swc'])}, "
        f"{got['states']} states, {supervised} supervised dispatch "
        f"attempts, {got['dispatches']} dispatches, device UNSAT lanes "
        f"{got['unsat']} (prefetch {got['async_unsat']}), host "
        f"confirmations by answer {tally}, device clauses harvested "
        f"{got['harvested']} (learned_clauses {got['learned']}), stream "
        f"{ctx.solver.fetch_proof().size} int32s, overflowed "
        f"{ctx.solver.proof_overflowed}, launches {launches}")
    check(ctx.solver.proof_enabled and not ctx.solver.proof_overflowed,
          f"proof {label}: stream recorded "
          f"{ctx.solver.proof_enabled}, overflowed "
          f"{ctx.solver.proof_overflowed} (buffer 2^24 int32s)")
    check(got["swc"] == run.swc_ids,
          f"proof {label}: SWC {sorted(got['swc'])} != {sorted(run.swc_ids)}")
    check(tally["sat"] == 0,
          f"proof {label}: the host answered SAT for {tally['sat']} "
          f"device-refuted cubes (a kernel soundness fault)")
    check(got["harvested"] == 0 and got["learned"] == 0,
          f"proof {label}: {got['harvested']} device clauses harvested")
    return got


def proof_phase(card):
    """The proof log on the card: ``scale_mul d6 -t 1`` force-dispatched
    and in the default rungs under ``proof_log``; the force-dispatched
    stream replayed by the checker (and once with a tampered ``LEARN``
    event, which it must refuse); then ``--proof-log`` through the CLI.
    Returns the launches of its analyses."""
    import tempfile

    import numpy as np

    from mythril_tpu_torch.contracts import killbilly
    from mythril_tpu_torch.smt import drat
    from mythril_tpu_torch.smt.solver import reset_blast_context

    run = run_by_name(PROOF_RUN)
    total = {}
    for force in (True, False):
        got = proof_run(run, force, card)
        _add(total, got["launches"])
        label = "force-dispatched" if force else "default rungs"
        if force:
            check(got["supervised"] > 0 and got["dispatches"] > 0,
                  f"proof {label}: {got['supervised']} supervised "
                  f"attempts, {got['dispatches']} dispatches")
            stream = got["solver"].fetch_proof()
            started = time.perf_counter()
            counts = drat.check_proof(stream)
            checker_s = time.perf_counter() - started
            check(counts["unsat_verdicts"] >= 1,
                  f"proof {label}: checker counts {counts}")
            events = drat.parse_events(stream)
            learned = [i for i, (marker, lits) in enumerate(events)
                       if marker == drat.LEARN]
            check(learned, f"proof {label}: no LEARN event to tamper")
            fresh = int(np.abs(stream).max()) + 1
            tampered = []
            for i, (marker, lits) in enumerate(events):
                if i == learned[len(learned) // 2]:
                    lits = (fresh,)  # a unit claim nothing implies
                tampered.extend([marker, *lits, 0])
            try:
                drat.check_proof(np.asarray(tampered, dtype=np.int32))
                refused = False
            except drat.ProofError:
                refused = True
            check(refused, f"proof {label}: a tampered LEARN event passed")
            log(f"proof {run.name} {label} [{card}]: check_proof "
                f"{checker_s:.3f} s over {stream.size} int32s: {counts}; "
                f"a tampered LEARN event (event {learned[len(learned) // 2]} "
                f"of {len(events)}) raised ProofError")
        unlogged = ANALYZE_WALLS.get(run.name, [None, None])[
            1 if force else 0]
        log(f"proof walls {run.name} {label} [{card}]: {got['wall']:.3f} s "
            f"with the proof log ({got['states']} states, "
            f"segments_declined {got['declined']}), "
            + (f"{unlogged:.3f} s without it (the analyze phase's, with "
               f"its kernel audits taken out)" if unlogged is not None
               else "no analyze-phase wall"))
        del got["solver"]
    reset_blast_context()
    with tempfile.TemporaryDirectory() as tmp:
        hexfile = os.path.join(tmp, "killbilly.hex")
        with open(hexfile, "w") as fh:
            fh.write(killbilly())
        started = time.perf_counter()
        found, _block = cli_report("proof CLI --proof-log", cli_analyze(
            hexfile, "-t", "1", "--proof-log"))
        check(found == {"106"}, f"proof CLI --proof-log: SWC {found}")
        log(f"proof CLI --proof-log [{card}]: exit 0, SWC {sorted(found)}, "
            f"wall {time.perf_counter() - started:.3f} s")
    return total


#: the fleet phase's runs: the full-size one, the cheapest chip run
#: whose frontier at transaction 1 holds two states, and full offload
FLEET_RUN = "scale_mul d4 g16 -t 2"
FLEET_SMALL_RUN = "erc20_transfer -t 2"
FLEET_OFFLOAD_RUN = "killbilly -t 1"
#: every fleet run: the JAX defaults (a 12 s heartbeat TTL among them),
#: but no straggler split, which drains a worker (a death) after 20 s of
#: a lease on a slower card and would make the deaths differ by run
FLEET_ENV = {"MYTHRIL_TPU_FLEET_SPLIT_AFTER_S": "0"}
#: the spawned seat of the remote-attach run: it never dials, so the
#: lease can only go to the remote seat
NEVER_DIALS = "#!/bin/sh\nexec sleep 600\n"


class ComputeApps(threading.Thread):
    """``nvidia-smi --query-compute-apps=pid,used_memory`` polled every
    0.25 s until :meth:`stop`: the most memory seen per pid."""

    def __init__(self):
        super().__init__(daemon=True)
        self.seen = {}
        self._halt = threading.Event()

    def run(self):
        while not self._halt.is_set():
            try:
                rows = subprocess.run(
                    ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                     "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=30).stdout
            except (OSError, subprocess.TimeoutExpired) as exc:
                self.seen["error"] = str(exc)
                return
            for row in rows.strip().splitlines():
                pid, _, mib = row.partition(",")
                mib = mib.strip().split()[0] if mib.strip() else "0"
                self.seen[pid.strip()] = max(self.seen.get(pid.strip(), 0),
                                             int(mib))
            self._halt.wait(0.25)

    def stop(self):
        self._halt.set()
        self.join()
        return self.seen


def fleet_cli(what, hexfile, *extra, env_extra=None):
    """One ``python3 -m mythril_tpu_torch analyze`` through the CLI's
    ``main`` in this process (the coordinator), the report captured,
    under ``DETERMINISTIC`` and :data:`FLEET_ENV`: its SWC set,
    ``meta.resilience``, wall, the coordinator's states and the fleet's
    coordinator (its leases' result headers)."""
    import io

    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.mythril import mythril_analyzer as MA
    from mythril_tpu_torch.parallel import coordinator as C
    from mythril_tpu_torch.resilience.checkpoint import (
        restore_signal_handlers,
    )
    from mythril_tpu_torch.support.support_args import args

    caught = {"coordinators": []}
    real_fire, real_shutdown = MA.MythrilAnalyzer.fire_lasers, \
        C.Coordinator.shutdown

    def firing(self, *a, **k):
        caught["analyzer"] = self
        return real_fire(self, *a, **k)

    def shutting(self):
        caught["coordinators"].append(self)
        return real_shutdown(self)

    MA.MythrilAnalyzer.fire_lasers = firing
    C.Coordinator.shutdown = shutting
    out, err = io.StringIO(), io.StringIO()
    MA.reset_analysis_state()
    started = time.perf_counter()
    try:
        with env(**DETERMINISTIC, **FLEET_ENV, **(env_extra or {})), \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                cli.main(["analyze", "-f", hexfile, "--bin-runtime",
                          "--no-onchain-data", "-o", "jsonv2", *extra])
                code = 0
            except SystemExit as done:
                code = done.code or 0
    finally:
        wall = time.perf_counter() - started
        MA.MythrilAnalyzer.fire_lasers = real_fire
        C.Coordinator.shutdown = real_shutdown
        restore_signal_handlers()
        args.fleet_workers = None
        args.lane_ledger_out = None
    check(code == 0, f"fleet {what}: exit {code}: {err.getvalue()[-3000:]}")
    report = json.loads(out.getvalue())[0]
    coordinators = caught["coordinators"]
    return {
        "swc": {i["swcID"].replace("SWC-", "") for i in report["issues"]},
        "block": report["meta"].get("resilience", {}),
        "wall": wall,
        "states": caught["analyzer"].last_sym.laser.total_states,
        "coordinator": coordinators[-1] if coordinators else None,
        "declined": segments_declined(),
    }


def fleet_results(got):
    """The result headers of the fleet's finished leases."""
    coordinator = got["coordinator"]
    if coordinator is None:
        return []
    return [lease.result for lease in coordinator.finished()]


def fleet_line(what, card, got):
    block = got["block"]
    results = fleet_results(got)
    worker_states = sum(r.get("states", 0) for r in results)
    log(f"fleet {what} [{card}]: wall {got['wall']:.3f} s, SWC "
        f"{sorted(got['swc'])}, states {got['states']} in this process + "
        f"{worker_states} in the workers, segments_declined "
        f"{got['declined']} (this process), leases "
        f"{block.get('fleet_leases', 0)}, rebalances "
        f"{block.get('fleet_rebalances', 0)}, worker deaths "
        f"{block.get('fleet_worker_deaths', 0)}, in-process "
        f"{block.get('fleet_inprocess_leases', 0)}, remote attaches "
        f"{block.get('fleet_remote_attaches', 0)}; leases by worker: "
        + (", ".join(f"{r.get('worker_id')} pid {r.get('pid')} "
                     f"{r.get('states')} states {r.get('wall_s')} s on "
                     f"{r.get('device')}" for r in results) or "none"))
    return worker_states


def fleet_phase(card, kind):
    """The fleet on the card, through the CLI (see the module
    docstring)."""
    import socket
    import tempfile

    from mythril_tpu_torch.contracts import killbilly

    run, small = run_by_name(FLEET_RUN), run_by_name(FLEET_SMALL_RUN)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, code in ((run.name, run.code), (small.name, small.code),
                           (FLEET_OFFLOAD_RUN, killbilly)):
            paths[name] = os.path.join(tmp, name.split()[0] + ".hex")
            with open(paths[name], "w") as fh:
                fh.write(code())
        tx = ("-t", str(run.transaction_count))

        # single, then fleet (cut from single, fleet, fleet, single to
        # keep the check within its time); the fleet run is checked
        walls = []
        for n, workers in enumerate((0, 2)):
            what = f"{run.name} --workers {workers}"
            apps = ComputeApps() if n == 1 else None
            if apps is not None:
                apps.start()
            try:
                got = fleet_cli(what, paths[run.name], *tx, "--workers",
                                str(workers))
            finally:
                seen = apps.stop() if apps is not None else None
            check(got["swc"] == run.swc_ids,
                  f"fleet {what}: SWC {sorted(got['swc'])}")
            worker_states = fleet_line(what, card, got)
            walls.append((workers, got, worker_states))
            if not workers:
                check(not any(k.startswith("fleet_") for k in got["block"]),
                      f"fleet {what}: meta.resilience {got['block']}")
                continue
            block = got["block"]
            check(block.get("fleet_leases", 0) >= 2
                  and not block.get("fleet_worker_deaths")
                  and not block.get("fleet_inprocess_leases"),
                  f"fleet {what}: meta.resilience {block}")
            if seen is None:
                continue
            results = fleet_results(got)
            pids = {r.get("pid") for r in results}
            on_card = [r for r in results
                       if (r.get("device") or {}).get("type") == "cuda"
                       and r["device"].get("name") == kind
                       and r["device"].get("peak_bytes", 0) > 0]
            log(f"fleet {what} nvidia-smi --query-compute-apps while the "
                f"fleet ran [{card}]: " + ", ".join(
                    f"pid {pid}: {mib} MiB" for pid, mib in seen.items())
                + f" (this script's pid {os.getpid()}); the workers' own "
                f"reports: " + ", ".join(
                    f"pid {r['pid']}: {r['device']['peak_bytes'] / 2**20:.1f}"
                    f" MiB allocator peak on {r['device']['name']}"
                    for r in on_card))
            check(len(pids) >= 2 and os.getpid() not in pids
                  and len(on_card) == len(results),
                  f"fleet {what}: leases ran in pids {pids} (this script "
                  f"{os.getpid()}), on the card: {len(on_card)} of "
                  f"{len(results)}")
        log(f"fleet walls {run.name} [{card}] (single, fleet; wall, states, segments_declined, leases, "
            f"rebalances): " + ", ".join(
                f"{'--workers ' + str(w) if w else 'single'} "
                f"{got['wall']:.3f} s, {got['states'] + ws}, "
                f"{got['declined']}, {got['block'].get('fleet_leases', 0)}, "
                f"{got['block'].get('fleet_rebalances', 0)}"
                for w, got, ws in walls)
            + "; measurements, not a claim")

        # force-dispatched: the merged ledger holds the workers' lanes
        ledger_path = os.path.join(tmp, "ledger.json")
        what = f"{run.name} --workers 2 force-dispatched"
        got = fleet_cli(what, paths[run.name], *tx, "--workers", "2",
                        "--device-force-dispatch", "--no-async-dispatch",
                        "--lane-ledger-out", ledger_path,
                        env_extra={"MYTHRIL_TPU_COALESCE": "0"})
        check(got["swc"] == run.swc_ids,
              f"fleet {what}: SWC {sorted(got['swc'])}")
        fleet_line(what, card, got)
        with open(ledger_path) as fh:
            ledger = json.load(fh)
        agg = check_ledger(ledger["aggregates"], ledger["records"], what)
        leases = {lease.lease_id for lease in got["coordinator"].finished()}
        scoped = {scope: tiers for scope, tiers in agg["by_scope"].items()
                  if scope in leases}
        device = sum(tiers.get(t, 0) for tiers in scoped.values()
                     for t in ("frontier", "sweep"))
        log(f"fleet {what} merged ledger [{card}]: {agg['lanes_total']} "
            f"lanes, decided {agg['decided']}, {agg['records_dropped']} "
            f"records left in the workers; by lease {scoped}")
        check(len(scoped) >= 2 and device > 0,
              f"fleet {what}: lanes decided on the card in the workers' "
              f"scopes {scoped}")

        # an injected preemption on the cheapest sharding run
        what = f"{small.name} --workers 2 worker_kill:1"
        got = fleet_cli(what, paths[small.name], "-t",
                        str(small.transaction_count), "--workers", "2",
                        env_extra={"MYTHRIL_TPU_FAULT": "worker_kill:1"})
        fleet_line(what, card, got)
        block = got["block"]
        check(got["swc"] == small.swc_ids
              and block.get("fleet_worker_deaths", 0) >= 1
              and block["fleet_leases"] > block["fleet_worker_deaths"]
              and not block.get("fleet_inprocess_leases"),
              f"fleet {what}: SWC {sorted(got['swc'])}, {block}")

        # a remote seat with a secret file
        secret = os.path.join(tmp, "secret")
        with open(secret, "w") as fh:
            fh.write(os.urandom(16).hex() + "\n")
        never = os.path.join(tmp, "never.sh")
        with open(never, "w") as fh:
            fh.write(NEVER_DIALS)
        os.chmod(never, 0o755)
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            listen = f"127.0.0.1:{probe.getsockname()[1]}"
        root = os.path.dirname(os.path.abspath(__file__))
        with open(os.path.join(tmp, "remote.err"), "w") as remote_err:
            remote = subprocess.Popen(
                [sys.executable, "-m", "mythril_tpu_torch", "worker",
                 "--connect", listen, "--secret-file", secret, "--id",
                 "remote-1", "--reconnect", "40"],
                cwd=root, env=dict(os.environ, **DETERMINISTIC, **FLEET_ENV),
                stdout=subprocess.DEVNULL, stderr=remote_err)
            what = f"{small.name} --workers 1 and a remote seat"
            try:
                got = fleet_cli(what, paths[small.name], "-t",
                                str(small.transaction_count), "--workers",
                                "1", env_extra={
                                    "MYTHRIL_TPU_FLEET_LISTEN": listen,
                                    "MYTHRIL_TPU_FLEET_SECRET_FILE": secret,
                                    "MYTHRIL_TPU_FLEET_PYTHON": never})
            finally:
                remote.terminate()
                remote.wait(timeout=60)
        fleet_line(what, card, got)
        block = got["block"]
        ran = [r.get("worker_id") for r in fleet_results(got)]
        check(got["swc"] == small.swc_ids
              and block.get("fleet_remote_attaches") == 1
              and ran == ["remote-1"] and remote.returncode == 0
              and not block.get("fleet_inprocess_leases"),
              f"fleet {what}: SWC {sorted(got['swc'])}, {block}, leases "
              f"run by {ran}, the remote seat's exit {remote.returncode}")

        # full offload: the coordinator steps no state
        what = f"{FLEET_OFFLOAD_RUN} --workers 1, MYTHRIL_TPU_FLEET_MIN_STATES=1"
        got = fleet_cli(what, paths[FLEET_OFFLOAD_RUN], "-t", "1",
                        "--workers", "1",
                        env_extra={"MYTHRIL_TPU_FLEET_MIN_STATES": "1"})
        fleet_line(what, card, got)
        results = fleet_results(got)
        check(got["swc"] == {"106"} and got["states"] == 0
              and [r.get("found_swcs") for r in results] == [["106"]]
              and got["block"].get("fleet_leases") == 1,
              f"fleet {what}: SWC {sorted(got['swc'])}, {got['states']} "
              f"states here, results {results}")


#: the serve phase's requests (PR 23)
SERVE_RUN = "scale_mul d6 g16 -t 1"
SERVE_DEADLINE_RUN = "scale_mul d4 g16 -t 2"
SERVE_SMALL_RUN = "killbilly -t 1"
#: the serve phase's deadline for the d4 -t 2 request: far below its
#: ~28 s wall (PERF.md section 5), so that it drains at a boundary
SERVE_SHORT_DEADLINE_S = 1.0


def free_listen() -> str:
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{probe.getsockname()[1]}"


def http_json(url, payload=None, timeout=900):
    """(status, JSON body) of a GET, or of a POST of ``payload``."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as rsp:
            return rsp.status, json.loads(rsp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class ServeRecorder:
    """The states of each analysis the serve engine runs (its
    ``SymExecWrapper`` wrapped for the block)."""

    def __init__(self):
        from mythril_tpu_torch.analysis import symbolic

        self.module, self.real = symbolic, symbolic.SymExecWrapper
        self.states = []
        recorder, real = self, self.real

        class Recording(real):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                recorder.states.append(self.laser.total_states)

        self.recording = Recording

    def __enter__(self):
        self.module.SymExecWrapper = self.recording
        return self

    def __exit__(self, *exc):
        self.module.SymExecWrapper = self.real


def serve_request(srv, what, run, card, recorder, **body):
    """One POST of ``run`` to the in-process server ``srv``: its status,
    body, wall, states, ``segments_declined`` and allocated bytes after
    it, logged."""
    import torch

    seen, declined = len(recorder.states), segments_declined()
    started = time.perf_counter()
    status, got = http_json(f"http://127.0.0.1:{srv.port}/analyze", {
        "code": run.code(), "name": run.name.split()[0],
        "tx_count": run.transaction_count, "source": "chip", **body})
    wall = time.perf_counter() - started
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    states = recorder.states[seen:]
    log(f"serve {what} [{card}]: status {status}, wall {wall:.3f} s, "
        f"states {states}, segments_declined "
        f"{segments_declined() - declined}, SWC "
        f"{got.get('findings_swc')}, partial {got.get('partial')}, "
        f"cached {got.get('cached', False)}, error "
        f"{(got.get('error') or {}).get('code')}, memory_allocated "
        f"{allocated} B")
    return {"status": status, "body": got, "wall": wall, "states": states,
            "allocated": allocated}


def serve_phase(card):
    """The serve plane on the card (see the module docstring).  Returns
    the launches of the in-process server's requests."""
    import tempfile

    from mythril_tpu_torch.persist import plane
    from mythril_tpu_torch.resilience import faults
    from mythril_tpu_torch.serve import AnalysisServer, ServeConfig

    run, small = run_by_name(SERVE_RUN), run_by_name(SERVE_SMALL_RUN)
    deadline_run = run_by_name(SERVE_DEADLINE_RUN)
    with env(**DETERMINISTIC), ServeRecorder() as recorder:
        srv = AnalysisServer(ServeConfig.from_env(port=0, device=DEVICE))
        srv.start()
        try:
            check(http_json(f"http://127.0.0.1:{srv.port}/readyz")[1]
                  ["mode"] == "device", "serve: /readyz mode")
            reset_launches()
            got = {"cold": serve_request(srv, f"{run.name} cold", run, card,
                                         recorder)}
            got["killbilly"] = serve_request(srv, small.name, small, card,
                                             recorder)
            for n in range(1, 5):
                got[n] = serve_request(srv, f"{run.name} warm {n}", run,
                                       card, recorder)
            # the warm context answers a repeated contract from its memo
            # channels without a dispatch: the forced request starts cold
            # (the engine's MYTHRIL_TPU_SERVE_COLD path for this request)
            srv.config.cold_per_request = True
            try:
                with rung_args(device_force_dispatch=True,
                               device_coalesce=False, async_dispatch=False):
                    got["forced"] = serve_request(
                        srv, f"{run.name} force-dispatched, cold", run, card,
                        recorder)
            finally:
                srv.config.cold_per_request = False
            got["short"] = serve_request(
                srv, f"{deadline_run.name} deadline "
                f"{SERVE_SHORT_DEADLINE_S} s", deadline_run, card, recorder,
                deadline_s=SERVE_SHORT_DEADLINE_S)
            got["after"] = serve_request(srv, f"{small.name} after it",
                                         small, card, recorder)
            faults.get_fault_plane().arm("serve_crash", times=1)
            try:
                got["crash"] = serve_request(
                    srv, f"{small.name} serve_crash:1", small, card,
                    recorder, source="crash")
            finally:
                faults.reset_for_tests()
            got["healed"] = serve_request(srv, f"{small.name} after the "
                                          "crash", small, card, recorder,
                                          source="crash")
            with tempfile.TemporaryDirectory() as tmp, env(
                    MYTHRIL_TPU_PERSIST_DIR=tmp,
                    MYTHRIL_TPU_PERSIST_FLUSH_S="0"):
                plane.reset_for_tests()
                try:
                    got["stored"] = serve_request(
                        srv, f"{small.name} persist", small, card, recorder)
                    got["cached"] = serve_request(
                        srv, f"{small.name} re-submitted", small, card,
                        recorder)
                finally:
                    plane.reset_for_tests()
            launches = read_launches()
            scoped = http_json(f"http://127.0.0.1:{srv.port}/debug/lanes"
                               )[1]["by_scope"]
        finally:
            srv.drain_and_stop("chip check")
    log(f"serve in-process launches [{card}]: {launches}")
    for what in ("cold", "killbilly", 1, 2, 3, 4, "forced", "after",
                 "healed", "stored", "cached"):
        want = small.swc_ids if what in (
            "killbilly", "after", "healed", "stored", "cached") \
            else run.swc_ids
        body = got[what]["body"]
        check(got[what]["status"] == 200 and set(body["findings_swc"]) == want
              and body["partial"] is False,
              f"serve {what}: status {got[what]['status']}, {body}")
    check(got[4]["allocated"] <= got[2]["allocated"],
          f"serve: allocated {got[2]['allocated']} B after the second warm "
          f"request, {got[4]['allocated']} B after the fourth")
    forced = scoped.get(got["forced"]["body"]["request_id"], {})
    check(forced.get("sweep", 0) + forced.get("frontier", 0) > 0,
          f"serve forced request: lanes by tier in its scope {forced}")
    log(f"serve forced request's scope in /debug/lanes: {forced}")
    short = got["short"]["body"]
    check(got["short"]["status"] == 200 and short["partial"] is True,
          f"serve deadline request: {short}")
    crash = got["crash"]
    check(crash["status"] == 500
          and crash["body"]["error"]["code"] == "analysis_failed"
          and crash["allocated"] <= got["after"]["allocated"],
          f"serve serve_crash: {crash['status']} {crash['body']}, "
          f"allocated {crash['allocated']} B after the decontamination, "
          f"{got['after']['allocated']} B before the crash")
    cached = got["cached"]["body"]
    check(cached.get("cached") is True
          and cached["issues"] == got["stored"]["body"]["issues"],
          f"serve report cache: {cached}")
    log(f"serve walls {run.name} [{card}]: cold {got['cold']['wall']:.3f} s "
        f"({got['cold']['states']} states), warm " + ", ".join(
            f"{got[n]['wall']:.3f} s ({got[n]['states']})"
            for n in range(1, 5)) + "; memory_allocated after warm 1-4: "
        + ", ".join(str(got[n]["allocated"]) for n in range(1, 5)) + " B")
    serve_process(card, small)
    serve_router(card, small, got["killbilly"]["body"]["findings_swc"])
    return launches


def serve_process(card, small):
    """``python3 -m mythril_tpu_torch serve`` as a process on the card:
    ready with mode ``device``, one request, ``top --once`` against it,
    SIGTERM to exit 0 with its trace and metrics files."""
    import signal
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    listen = free_listen()
    port = listen.rsplit(":", 1)[1]
    with tempfile.TemporaryDirectory() as tmp:
        trace, metrics = (os.path.join(tmp, "serve.trace.json"),
                          os.path.join(tmp, "serve.prom"))
        with open(os.path.join(tmp, "serve.err"), "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "mythril_tpu_torch", "serve",
                 "--port", port, "--trace-out", trace, "--metrics-out",
                 metrics],
                cwd=root, env=dict(os.environ, **DETERMINISTIC),
                stdout=subprocess.DEVNULL, stderr=err)
            started = time.perf_counter()
            try:
                url = f"http://127.0.0.1:{port}"
                ready = None
                while time.perf_counter() - started < 300:
                    check(proc.poll() is None, "serve process exited")
                    try:
                        ready = http_json(url + "/readyz", timeout=10)
                    except OSError:
                        ready = None
                    if ready and ready[0] == 200:
                        break
                    time.sleep(0.2)
                up = time.perf_counter() - started
                check(ready and ready[0] == 200
                      and ready[1]["mode"] == "device",
                      f"serve process /readyz: {ready}")
                status, body = http_json(url + "/analyze", {
                    "code": small.code(), "tx_count": small.transaction_count,
                    "name": "killbilly"})
                check(status == 200 and set(body["findings_swc"]) ==
                      small.swc_ids, f"serve process request: {body}")
                top = subprocess.run(
                    [sys.executable, "-m", "mythril_tpu_torch", "top",
                     "--once", "--url", url],
                    cwd=root, capture_output=True, text=True, timeout=120)
                check(top.returncode == 0 and "server: READY" in top.stdout
                      and "Traceback" not in top.stdout + top.stderr,
                      f"top --once: {top.returncode} {top.stdout} "
                      f"{top.stderr[-2000:]}")
                proc.send_signal(signal.SIGTERM)
                code = proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        with open(os.path.join(tmp, "serve.err")) as fh:
            tail = fh.read()[-2000:]
        check(code == 0, f"serve process: exit {code}: {tail}")
        with open(trace) as fh:
            events = len(json.load(fh)["traceEvents"])
        with open(metrics) as fh:
            prom = fh.read()
        check(events > 0 and "mythril_tpu_serve_requests_total" in prom,
              f"serve process artifacts: {events} events")
    log(f"serve process [{card}]: ready in {up:.1f} s with mode device, "
        f"SWC {body['findings_swc']} in {body['analysis_s']} s, top --once "
        f"rendered {len(top.stdout.splitlines())} lines, SIGTERM: exit 0, "
        f"{events} trace events, {len(prom.splitlines())} metrics lines")


def serve_router(card, small, want):
    """A server with ``fleet_listen`` on loopback and a secret file, one
    ``worker --connect`` seat attached: a request answered by the seat
    with the in-process server's findings."""
    import tempfile

    from mythril_tpu_torch.serve import AnalysisServer, ServeConfig

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        secret = os.path.join(tmp, "secret")
        with open(secret, "w") as fh:
            fh.write(os.urandom(16).hex() + "\n")
        listen = free_listen()
        srv = AnalysisServer(ServeConfig(
            port=0, fleet_listen=listen, fleet_secret_file=secret,
            device=DEVICE))
        srv.start()
        with open(os.path.join(tmp, "worker.err"), "w") as err:
            worker = subprocess.Popen(
                [sys.executable, "-m", "mythril_tpu_torch", "worker",
                 "--connect", listen, "--secret-file", secret, "--id",
                 "seat-1", "--reconnect", "0"],
                cwd=root, env=dict(os.environ, **DETERMINISTIC),
                stdout=subprocess.DEVNULL, stderr=err)
            try:
                started = time.perf_counter()
                while srv.router.seat_count() < 1:
                    check(worker.poll() is None
                          and time.perf_counter() - started < 300,
                          "serve router: the seat never attached")
                    time.sleep(0.1)
                status, body = http_json(
                    f"http://127.0.0.1:{srv.port}/analyze", {
                        "code": small.code(), "name": "killbilly",
                        "tx_count": small.transaction_count})
            finally:
                srv.drain_and_stop("chip check")
                try:
                    worker.wait(timeout=60)
                finally:
                    if worker.poll() is None:
                        worker.kill()
                        worker.wait()
    check(status == 200 and body["mode"] == "fabric"
          and body["findings_swc"] == want and worker.returncode == 0,
          f"serve router: {status} {body}, the seat's exit "
          f"{worker.returncode}")
    log(f"serve router [{card}]: SWC {body['findings_swc']} from "
        f"{body['worker']} in {body['analysis_s']} s (mode fabric), routed "
        f"{srv.router.routed}, fallbacks {srv.router.fallbacks}; the seat "
        f"exited 0")


#: the statespace phase's contracts: -g on the serve run, -j on a run
#: whose two-transaction dump stays small
STATESPACE_GRAPH_RUN = SERVE_RUN
STATESPACE_JSON_RUN = "vault_withdraw -t 2"


def renumber_uids(nodes, edges):
    """(nodes, edges) with node ids renumbered by first appearance."""
    ids = {}
    for node in nodes:
        ids.setdefault(node["id"], str(len(ids)))
    nodes = [dict(node, id=ids[node["id"]]) for node in nodes]
    edges = [dict(edge, **{"from": ids.get(edge["from"], edge["from"]),
                           "to": ids.get(edge["to"], edge["to"])})
             for edge in edges]
    return nodes, edges


def graph_data(html):
    """The node and edge lists a graph page embeds (``-g``)."""
    import ast

    nodes, edges = [
        ast.literal_eval(chunk.split(");", 1)[0])
        for chunk in html.split("new vis.DataSet(")[1:3]]
    return nodes, edges


def statespace_phase(card):
    """``-g``, ``-j`` and ``--enable-coverage-strategy`` through the CLI
    on the card and on the CPU (see the module docstring)."""
    import tempfile

    graph_run = run_by_name(STATESPACE_GRAPH_RUN)
    json_run = run_by_name(STATESPACE_JSON_RUN)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for run in (graph_run, json_run):
            paths[run.name] = os.path.join(tmp, run.name.split()[0] + ".hex")
            with open(paths[run.name], "w") as fh:
                fh.write(run.code())
        jobs = {}
        started = time.perf_counter()
        for device in ("cuda", "cpu"):
            out = os.path.join(tmp, f"graph.{device}.html")
            jobs[("g", device)] = (out, cli_analyze(
                paths[graph_run.name], "-t", str(graph_run.transaction_count),
                "--device", device, "-g", out, popen=True))
            out = os.path.join(tmp, f"space.{device}.json")
            jobs[("j", device)] = (out, cli_analyze(
                paths[json_run.name], "-t", str(json_run.transaction_count),
                "--device", device, "-j", out, popen=True))
        coverage = cli_analyze(paths[graph_run.name], "-t",
                               str(graph_run.transaction_count),
                               "--enable-coverage-strategy", popen=True)
        files = {}
        for key, (out, proc) in jobs.items():
            _stdout, stderr = proc.communicate(timeout=900)
            check(proc.returncode == 0,
                  f"statespace {key}: exit {proc.returncode}: "
                  f"{stderr[-2000:]}")
            with open(out) as fh:
                files[key] = fh.read()
        stdout, stderr = coverage.communicate(timeout=900)
        wall = time.perf_counter() - started
    found, _block = cli_report(
        "--enable-coverage-strategy", subprocess.CompletedProcess(
            coverage.args, coverage.returncode, stdout, stderr))
    check(found == graph_run.swc_ids,
          f"--enable-coverage-strategy: SWC {sorted(found)}")
    graphs = {d: renumber_uids(*graph_data(files[("g", d)]))
              for d in ("cuda", "cpu")}
    spaces = {d: json.loads(files[("j", d)]) for d in ("cuda", "cpu")}
    spaces = {d: renumber_uids(s["nodes"], s["edges"])
              for d, s in spaces.items()}
    check(graphs["cuda"] == graphs["cpu"] and graphs["cuda"][0],
          f"-g {graph_run.name}: the card's graph differs from the CPU's")
    check(spaces["cuda"] == spaces["cpu"] and spaces["cuda"][0],
          f"-j {json_run.name}: the card's statespace differs from the CPU's")
    log(f"statespace [{card}]: -g {graph_run.name} {len(graphs['cuda'][0])} "
        f"nodes, {len(graphs['cuda'][1])} edges, {len(files[('g', 'cuda')])} "
        f"bytes, equal on cuda and cpu; -j {json_run.name} "
        f"{len(spaces['cuda'][0])} nodes, {len(spaces['cuda'][1])} edges, "
        f"{len(files[('j', 'cuda')])} bytes, equal on cuda and cpu; "
        f"--enable-coverage-strategy {graph_run.name}: SWC {sorted(found)}; "
        f"five processes side by side in {wall:.1f} s")


#: the on-chain phase's limit on its own seconds
ONCHAIN_LIMIT_S = 120.0


@contextlib.contextmanager
def served(chain):
    """``chain`` answered over JSON-RPC on 127.0.0.1 for the block; yields
    ``HOST:PORT``."""
    from mythril_tpu_torch.contracts import serve_chain

    server = serve_chain(chain)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


def onchain_once(run, endpoint, force):
    """``-a`` in process: the run's account loaded from the chain at
    ``endpoint`` (``load_from_address``: triage, the proxy chain) and
    analyzed with the loader active, force-dispatched or in the default
    rungs.  Returns (report, analyzer, contract, wall seconds, the RPC
    client's retries while loading)."""
    import torch

    from mythril_tpu_torch.contracts import onchain_accounts
    from mythril_tpu_torch.mythril import (
        MythrilAnalyzer, MythrilConfig, MythrilDisassembler,
    )
    from mythril_tpu_torch.mythril.mythril_analyzer import (
        reset_analysis_state,
    )
    from mythril_tpu_torch.resilience.telemetry import resilience_stats

    reset_analysis_state()
    config = MythrilConfig()
    config.set_api_rpc(endpoint)
    disassembler = MythrilDisassembler(eth=config.eth)
    started = time.perf_counter()
    address, contract = disassembler.load_from_address(
        onchain_accounts()[run.account].address)
    retries = resilience_stats.rpc_retries
    analyzer = MythrilAnalyzer(
        disassembler, address=address, strategy="bfs", max_depth=128,
        execution_timeout=ANALYZE_TIMEOUT_S, create_timeout=10,
        loop_bound=3, device_force_dispatch=force, async_dispatch=not force,
        device=DEVICE, use_onchain_data=True)
    with rung_args(device_coalesce=not force):
        report = analyzer.fire_lasers(
            transaction_count=run.transaction_count)
    torch.cuda.synchronize()
    return report, analyzer, contract, time.perf_counter() - started, retries


def onchain_run(run, endpoint, chain, card, force, label="", audit=True):
    """One :func:`onchain_once` with every kernel call audited (the
    launches counted from 0 just before and read just after), logged
    with its reads of the chain; returns (launches, SWC set, states)."""
    from mythril_tpu_torch.laser.batch import prune_stats

    calls = dict(chain.calls)
    with audited_kernels("sample" if force else "count",
                         "first" if force else "count",
                         "count" if force else "every",
                         "every" if audit else "count") as audited:
        report, analyzer, contract, wall, retries = onchain_once(
            run, endpoint, force)
    wall -= audited["seconds"]
    reads = {k: chain.calls.get(k, 0) - calls.get(k, 0)
             for k in ("eth_getCode", "eth_getStorageAt", "eth_getBalance")}
    found = {issue.swc_id for issue in report.issues.values()}
    states = analyzer.last_sym.laser.total_states
    check(not report.exceptions,
          f"onchain {run.name}: the analysis failed:\n"
          + "\n".join(report.exceptions))
    log(f"onchain {run.name}{label} [{card}]: contract {contract.name}, "
        f"triage {contract.triage}, wall {wall:.3f} s without the audits' "
        f"{audited['seconds']:.3f} s, {states} states, "
        f"{prune_stats.tail_states} tail lanes, chain reads {reads}, rpc "
        f"retries {retries}, launches {audited['launches']}, SWC "
        f"{sorted(found)}; kernels vs plain: "
        f"{audited['sweep'].summary() or 'no sweep'}; "
        f"{audited['step'].summary() or 'no dpll_step'}; "
        f"{audited['frontier'].summary() or 'no frontier kernel'}; "
        f"{audited['round_lane'].summary() or 'no round lane'}; "
        f"{audited['word'].summary() or 'no word fixpoint'}; lockstep "
        f"{audited['lockstep'].summary() or 'none'}; keccak "
        f"{audited['keccak'].summary() or 'none'}")
    check(found == run.swc_ids,
          f"onchain {run.name}{label}: SWC {sorted(found)}, the JAX package "
          f"finds {sorted(run.swc_ids)}")
    check(reads["eth_getCode"] > 0,
          f"onchain {run.name}: the code was not read from the chain")
    if run.resolves_to is not None:
        check(" -> " in contract.name,
              f"onchain {run.name}: the proxy was not resolved "
              f"({contract.name})")
    return audited["launches"], found, states, retries


def watch_args(endpoint, journal, findings, *extra):
    return ["watch", "--rpc", endpoint, "--until-block", "8", "--tx-count",
            "1", "--confirmations", "0", "--poll-s", "0", "--journal",
            journal, "--findings-out", findings, *extra]


def watch_rows(path):
    """The findings rows of a watch by digest, without trace ids and
    walls."""
    rows = {}
    with open(path) as fh:
        for line in fh:
            row = json.loads(line)
            row.pop("trace_id", None)
            row.pop("analysis_s", None)
            rows.setdefault(row["digest"], []).append(row)
    return rows


def watch_check(what, summary, rows, want):
    """A full watch of :func:`contracts.watch_chain`: one reorg, six
    deployments, the reverted CREATE skipped, each unique digest analyzed
    once with the SWC set ``want`` gives it, nothing dropped."""
    analyzed = {d: [r for r in rs if r["status"] == "analyzed"]
                for d, rs in rows.items()}
    check(summary["reorgs"] == 1 and summary["deployments"] == 6
          and summary["dedup_hits"] == 4 and summary["analyzed"] == 2
          and summary["errors"] == 0 and summary["backlog_depth"] == 0
          and summary["cursor"] == 8,
          f"watch {what}: summary {summary}")
    check(set(analyzed) == set(want)
          and all(len(rs) == 1 for rs in analyzed.values())
          and all(set(analyzed[d][0]["findings_swc"]) == want[d]
                  and not analyzed[d][0]["partial"] for d in want),
          f"watch {what}: analyzed rows {analyzed}, want {want}")


def onchain_phase(card):
    """On-chain loading and the watch on the card (see the module
    docstring).  Returns the launches of its runs on the main path."""
    import tempfile

    from mythril_tpu_torch import contracts as C
    from mythril_tpu_torch.persist.plane import code_digest
    from mythril_tpu_torch.resilience import faults
    from mythril_tpu_torch.watch import build_client
    from mythril_tpu_torch.watch.stream import EngineBackend, WatchService

    started = time.perf_counter()
    runs = {r.account: r for r in C.ONCHAIN_RUNS}
    clone2, vault = runs["CLONE2"], runs["VAULT"]
    accounts = C.onchain_accounts()
    want = {code_digest(C.scale_contract(6, 16, "mul")):
            C.WATCH_FINDINGS["scale_mul d6 g16"],
            code_digest(C.killbilly()): C.WATCH_FINDINGS["killbilly"]}
    totals = {}
    root = os.path.dirname(os.path.abspath(__file__))
    chain = C.onchain_chain()
    with tempfile.TemporaryDirectory() as tmp, env(
            MYTHRIL_DIR=tmp, INFURA_ID=None, MYTHRIL_TPU_RPC_PROVIDERS=None,
            **DETERMINISTIC), served(chain) as endpoint:
        for force, label in ((False, " default rungs"),
                             (True, " force-dispatched")):
            launches, _found, states, _r = onchain_run(
                clone2, endpoint, chain, card, force, label)
            _add(totals, launches)
        check(launches["dense_sweep"] + launches["scan_rows"] > 0,
              f"onchain {clone2.name} force-dispatched: no device tier "
              f"({launches})")
        # vault_withdraw keys its storage by the (symbolic) caller, so
        # its reads are the loader's concrete storage and its balance the
        # chain's; call_constant reads slot 0 (set on the chain: its
        # SUICIDE is reachable only so) and loads the code it CALLs
        for run, what in ((vault, "eth_getBalance"),
                          (runs["GATE"], "eth_getStorageAt")):
            before = dict(chain.calls)
            launches, _found, _states, _r = onchain_run(
                run, endpoint, chain, card, False, " default rungs")
            _add(totals, launches)
            check(chain.calls.get(what, 0) > before.get(what, 0),
                  f"onchain {run.name}: no {what} from the chain")
        check(chain.calls["eth_getCode"] - before["eth_getCode"] >= 2,
              "onchain call_constant: the callee's code was not loaded")
        # the rpc_error fault: the first transport call fails and is
        # retried; the findings and states are the fault-free run's (its
        # launches stay out of the kernels line, as every faulted run's)
        faults.reset_for_tests()
        with env(MYTHRIL_TPU_FAULT="rpc_error"):
            faults.reset_for_tests()
            try:
                _l, found, faulted_states, retries = onchain_run(
                    clone2, endpoint, chain, card, True,
                    " force-dispatched, MYTHRIL_TPU_FAULT=rpc_error",
                    audit=False)
                fired = faults.get_fault_plane().fired
            finally:
                faults.reset_for_tests()
        check(retries >= 1 and found == clone2.swc_ids
              and faulted_states == states,
              f"onchain rpc_error: {retries} retries, SWC {sorted(found)}, "
              f"{faulted_states} states (fault-free {states}); fired "
              f"{fired}")
        # the watch in process, on the port's engine on the card, in the
        # default rungs (the serve engine builds no analyzer: the args bus
        # still holds the last forced run's rungs), as its CLI runs it
        watch = C.watch_chain()
        with served(watch) as wendpoint, rung_args(
                device_force_dispatch=False, async_dispatch=True,
                device_coalesce=True):
            reset_launches()
            wall = time.perf_counter()
            service = WatchService(
                build_client(wendpoint), EngineBackend(device=DEVICE),
                confirmations=0, poll_s=0, until_block=8, tx_count=1,
                journal_path=os.path.join(tmp, "inproc.jsonl"),
                findings_out=os.path.join(tmp, "inproc.findings.jsonl"))
            summary = service.run()
            wall = time.perf_counter() - wall
            _add(totals, read_launches())
        inproc_rows = watch_rows(os.path.join(tmp, "inproc.findings.jsonl"))
        watch_check("in process", summary, inproc_rows, want)
        log(f"onchain watch in process [{card}]: wall {wall:.3f} s, "
            f"summary {summary}, chain calls {watch.calls}")
        # the CLI: analyze -a, read-storage and function-to-hash beside a
        # watch process, then that watch resumed from its journal
        watch2 = C.watch_chain()
        with served(watch2) as wendpoint2:
            cli = [sys.executable, "-m", "mythril_tpu_torch"]
            journal = os.path.join(tmp, "cli.jsonl")
            findings = os.path.join(tmp, "cli.findings.jsonl")
            procs = {what: subprocess.Popen(
                cli + argv, cwd=root, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, env=dict(os.environ))
                for what, argv in (
                    ("analyze", ["analyze", "-a",
                                 accounts[clone2.account].address, "--rpc",
                                 endpoint, "-t", "1", "-o", "jsonv2"]),
                    ("read-storage", ["read-storage", "0,2",
                                      accounts["VAULT"].address, "--rpc",
                                      endpoint]),
                    ("function-to-hash", ["function-to-hash",
                                          "transfer(address,uint256)"]),
                    ("watch", watch_args(wendpoint2, journal, findings)))}
            done = {}
            for what, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=600)
                check(proc.returncode == 0,
                      f"onchain CLI {what}: exit {proc.returncode}: "
                      f"{stderr[-2000:]}")
                done[what] = stdout
            resumed = subprocess.run(
                cli + watch_args(wendpoint2, journal, findings, "--resume"),
                cwd=root, capture_output=True, text=True, timeout=600)
            check(resumed.returncode == 0,
                  f"onchain CLI watch --resume: {resumed.stderr[-2000:]}")
        cli_found = {i["swcID"].replace("SWC-", "")
                     for i in json.loads(done["analyze"])[0]["issues"]}
        check(cli_found == clone2.swc_ids,
              f"onchain CLI analyze -a: SWC {sorted(cli_found)}")
        storage = done["read-storage"].split()
        check(storage == ["0x0:", "0x" + format(0x2A, "064x"), "0x1:",
                          "0x" + format(0x1337, "064x")],
              f"onchain CLI read-storage: {done['read-storage']!r}")
        check(done["function-to-hash"].strip() == "0xa9059cbb",
              f"onchain CLI function-to-hash: {done['function-to-hash']!r}")
        cli_summary = json.loads(done["watch"].strip().splitlines()[-1])[
            "watch_summary"]
        cli_rows = watch_rows(findings)
        watch_check("CLI", cli_summary, cli_rows, want)
        volatile = ("wall_s", "cpm", "uptime_s")
        check({k: v for k, v in cli_summary.items() if k not in volatile}
              == {k: v for k, v in summary.items() if k not in volatile}
              and cli_rows == inproc_rows,
              f"onchain CLI watch: {cli_summary} and its rows differ from "
              f"the in-process watch's {summary}")
        again = json.loads(resumed.stdout.strip().splitlines()[-1])[
            "watch_summary"]
        check(again["analyzed"] == 0 and again["cached"] == 0
              and again["deployments"] == 0 and again["errors"] == 0
              and watch_rows(findings) == cli_rows,
              f"onchain CLI watch --resume submitted again: {again}")
        log(f"onchain CLI [{card}]: analyze -a SWC {sorted(cli_found)}, "
            f"read-storage {done['read-storage'].strip()!r}, "
            f"function-to-hash {done['function-to-hash'].strip()}, watch "
            f"summary {cli_summary}, --resume summary {again}")
    seconds = time.perf_counter() - started
    log(f"onchain phase [{card}]: {seconds:.1f} s (limit "
        f"{ONCHAIN_LIMIT_S:.0f} s), launches {totals}")
    check(seconds <= ONCHAIN_LIMIT_S,
          f"onchain phase took {seconds:.1f} s, past its "
          f"{ONCHAIN_LIMIT_S:.0f} s")
    return totals


#: the inputs phase's limit on its own seconds
INPUTS_LIMIT_S = 75.0
#: the settings ``--solc-json`` hands the stand-in compiler in the check
SOLC_SETTINGS = {"optimizer": {"enabled": True, "runs": 7},
                 "evmVersion": "paris"}


def sol_once(target, transaction_count, force):
    """``analyze TARGET`` in process (``FILE:NAME`` compiled by the
    stand-in on ``PATH``, the loader active as the CLI's default leaves
    it), force-dispatched or in the default rungs: (report, analyzer,
    wall seconds, the loaded contract)."""
    import torch

    from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.mythril.mythril_analyzer import (
        reset_analysis_state,
    )

    reset_analysis_state()
    started = time.perf_counter()
    disassembler = MythrilDisassembler()
    address, loaded = disassembler.load_from_solidity([target])
    analyzer = MythrilAnalyzer(
        disassembler, address=address, strategy="bfs", max_depth=128,
        execution_timeout=ANALYZE_TIMEOUT_S, create_timeout=10,
        loop_bound=3, device_force_dispatch=force, async_dispatch=not force,
        device=DEVICE, use_onchain_data=True)
    with rung_args(device_coalesce=not force):
        report = analyzer.fire_lasers(transaction_count=transaction_count)
    torch.cuda.synchronize()
    return report, analyzer, time.perf_counter() - started, loaded[0]


def source_findings(what, issues, run, src):
    """``issues`` (``(swc, address, function, filename, lineno, code)``)
    held to the run's JAX SWC set and function names and, each, to the
    plain decoding of the fixture's map."""
    from mythril_tpu_torch.contracts import plain_source_info

    found = {i[0] for i in issues}
    check(found == run.swc_ids,
          f"inputs {what}: SWC {sorted(found)}, the JAX package finds "
          f"{sorted(run.swc_ids)}")
    functions = {i[2] for i in issues}
    check(functions == run.functions,
          f"inputs {what}: functions {sorted(functions)}, want "
          f"{sorted(run.functions)}")
    for swc, address, _function, filename, lineno, code in issues:
        name, want_line, want_code = plain_source_info(
            run.file, run.contract, address)
        check((filename, lineno, code) == (os.path.join(src, name)
                                           if src else name,
                                           want_line, want_code),
              f"inputs {what}: SWC-{swc} at {address}: {filename}:{lineno} "
              f"{code!r}, the fixture's map gives {name}:{want_line} "
              f"{want_code!r}")


def sol_run(run, src, card, force, label):
    """One :func:`sol_once` of ``run`` with every kernel call audited
    (the launches counted from 0 just before and read just after);
    returns the launches."""
    from mythril_tpu_torch.laser.batch import prune_stats

    target = f"{os.path.join(src, run.file)}:{run.contract}"
    with audited_kernels("sample" if force else "count",
                         "first" if force else "count",
                         "count" if force else "every") as audited:
        report, analyzer, wall, contract = sol_once(
            target, run.transaction_count, force)
    wall -= audited["seconds"]
    check(not report.exceptions,
          f"inputs {run.name}{label}: the analysis failed:\n"
          + "\n".join(report.exceptions))
    issues = sorted((i.swc_id, i.address, i.function, i.filename, i.lineno,
                     i.code) for i in report.issues.values())
    states = analyzer.last_sym.laser.total_states
    log(f"inputs {run.name}{label} [{card}]: contract {contract.name} "
        f"({len(contract.code) // 2} runtime bytes, "
        f"{len(contract.creation_code) // 2} creation bytes, files "
        f"{[os.path.basename(f.filename) for f in contract.solidity_files]}"
        f"), wall {wall:.3f} s without the audits' "
        f"{audited['seconds']:.3f} s, {states} states, "
        f"{prune_stats.tail_states} tail lanes, segments_declined "
        f"{segments_declined()}, launches {audited['launches']}, findings "
        + ", ".join(f"SWC-{s} at {a} in {f} "
                    f"{os.path.basename(n or '')}:{n_}"
                    for s, a, f, n, n_, _c in issues)
        + f"; kernels vs plain: {audited['sweep'].summary() or 'no sweep'}; "
        f"{audited['step'].summary() or 'no dpll_step'}; "
        f"{audited['frontier'].summary() or 'no frontier kernel'}; "
        f"{audited['round_lane'].summary() or 'no round lane'}; "
        f"{audited['word'].summary() or 'no word fixpoint'}; lockstep "
        f"{audited['lockstep'].summary() or 'none'}; keccak "
        f"{audited['keccak'].summary() or 'none'}")
    source_findings(f"{run.name}{label}", issues, run, src)
    return audited["launches"]


def truffle_in_process(project):
    """``truffle -t N -o json`` through the CLI's ``main`` in this process,
    in ``project`` (the launches counted from 0 just before and read just
    after): (issues, launches, wall)."""
    import io

    from mythril_tpu_torch.contracts import TRUFFLE_TX_COUNT
    from mythril_tpu_torch.interfaces import cli
    from mythril_tpu_torch.mythril import mythril_analyzer as MA
    from mythril_tpu_torch.resilience.checkpoint import (
        restore_signal_handlers,
    )

    out, err = io.StringIO(), io.StringIO()
    MA.reset_analysis_state()
    here = os.getcwd()
    started = time.perf_counter()
    try:
        os.chdir(project)
        with audited_kernels("count", "count", "count", "count") as audited, \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                cli.main(["truffle", "-t", str(TRUFFLE_TX_COUNT), "-o",
                          "json"])
                code = 0
            except SystemExit as done:
                code = done.code or 0
    finally:
        os.chdir(here)
        restore_signal_handlers()
    wall = time.perf_counter() - started
    check(code == 0, f"inputs truffle: exit {code}: {err.getvalue()[-3000:]}")
    return json.loads(out.getvalue())["issues"], audited["launches"], wall


def inputs_phase(card):
    """Solidity input through the stand-in compiler, ``truffle``, the
    LevelDB commands and ``pro`` on the card (see the module docstring).
    Returns the launches of its in-process runs."""
    import io
    import tempfile

    from mythril_tpu_torch import contracts as C
    from mythril_tpu_torch.ethereum.interface.leveldb.client import (
        EthLevelDB,
    )
    from mythril_tpu_torch.mythril.mythril_leveldb import MythrilLevelDB
    from mythril_tpu_torch.support.crypto import keccak256

    started = time.perf_counter()
    runs = {r.contract: r for r in C.SOURCE_RUNS}
    scale, helper = runs["Scale"], runs["Helper"]
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        home = os.path.join(tmp, "home")
        bin_dir = C.write_solc_standin(os.path.join(tmp, "bin"))
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        for main_file in C.SOURCE_FIXTURES:
            C.write_sources(src, main_file)
        path = bin_dir + os.pathsep + os.environ.get("PATH", "")
        with env(HOME=home, MYTHRIL_DIR=os.path.join(home, ".mythril_tpu"),
                 INFURA_ID=None, MYTHRIL_TPU_RPC_PROVIDERS=None, PATH=path,
                 MYTHX_API_URL=None, **DETERMINISTIC):
            # SCALE.sol:Scale (d6 g16) in process, in both rungs
            for force, label in ((False, " default rungs"),
                                 (True, " force-dispatched")):
                launches = sol_run(scale, src, card, force, label)
                _add(totals, launches)
            check(launches["dense_sweep"] + launches["scan_rows"] > 0,
                  f"inputs {scale.name} force-dispatched: no device tier "
                  f"({launches})")
            compiled = C.standin_requests(bin_dir)
            check(len(compiled) == 2
                  and all(r["binary"] == "solc" for r in compiled),
                  f"inputs: the stand-in was asked {len(compiled)} times")
            # truffle in process: killbilly, erc20_transfer, an interface
            project = os.path.join(tmp, "truffle")
            C.write_truffle_project(project)
            issues, launches, wall = truffle_in_process(project)
            _add(totals, launches)
            found = {}
            for issue in issues:
                found.setdefault(issue["contract"], set()).add(
                    issue["swc-id"])
            log(f"inputs truffle -t {C.TRUFFLE_TX_COUNT} [{card}]: wall "
                f"{wall:.3f} s, findings {found}, launches {launches}")
            check(found == C.TRUFFLE_SWC,
                  f"inputs truffle: SWC by contract {found}, the JAX "
                  f"package finds {C.TRUFFLE_SWC}")
            # the geth database, written here, indexed once in process
            chaindata = os.path.join(tmp, "chaindata")
            wall = time.perf_counter()
            built = C.write_geth_db(chaindata)
            written = time.perf_counter() - wall
            files = {n: os.path.getsize(os.path.join(chaindata, n))
                     for n in sorted(os.listdir(chaindata))}
            wall = time.perf_counter()
            db = EthLevelDB(chaindata)
            indexed = time.perf_counter() - wall
            printed = io.StringIO()
            wall = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                MythrilLevelDB(db).search_db(C.GETH_SEARCH)
            searched = time.perf_counter() - wall
            want_hits = C.geth_search_hits()
            hits = {line.split()[1].rstrip(",")
                    for line in printed.getvalue().splitlines()}
            log(f"inputs LevelDB [{card}]: {len(built['accounts'])} "
                f"accounts ({C.GETH_GENERATED} generated), "
                f"{len(built['records'])} records in the table, "
                f"{len(built['tail'])} in the log tail, files {files}; "
                f"written in {written:.3f} s, opened and indexed in "
                f"{indexed:.3f} s, search {C.GETH_SEARCH!r} in process "
                f"{searched:.3f} s: {len(hits)} hits")
            check(hits == want_hits and len(built["accounts"]) >= 1000,
                  f"inputs LevelDB search: {len(hits)} hits, want "
                  f"{len(want_hits)}")
            impl = C.onchain_accounts()["IMPL"]
            code_hash = "0x" + keccak256(bytes.fromhex(impl.code)).hex()
            # the CLI's processes side by side, with the analysis API
            api = C.serve_analysis_api()
            server = threading.Thread(target=api.serve_forever, daemon=True)
            server.start()
            url = f"http://127.0.0.1:{api.server_address[1]}"
            cli = [sys.executable, "-m", "mythril_tpu_torch"]
            root = os.path.dirname(os.path.abspath(__file__))
            settings = json.dumps(SOLC_SETTINGS)
            commands = {
                "analyze": (["analyze", f"{scale.file}:{scale.contract}",
                             "-t", str(scale.transaction_count), "-o",
                             "json"], {}),
                "analyze --solv": (["analyze",
                                    f"{helper.file}:{helper.contract}",
                                    "--solv", C.SOLC_VERSION, "--solc-json",
                                    settings, "-q", "-t",
                                    str(helper.transaction_count), "-o",
                                    "json"], {}),
                "leveldb-search": (["leveldb-search", C.GETH_SEARCH,
                                    "--leveldb-dir", chaindata], {}),
                "hash-to-address": (["hash-to-address", code_hash,
                                     "--leveldb-dir", chaindata], {}),
                "pro": (["pro", f"{helper.file}:{helper.contract}", "-o",
                         "json"], {"MYTHX_API_URL": url}),
            }
            before = len(C.standin_requests(bin_dir))
            try:
                procs = {}
                for what, (argv, extra) in commands.items():
                    procs[what] = (time.perf_counter(), subprocess.Popen(
                        cli + argv, cwd=src, text=True,
                        env=dict(os.environ, PYTHONPATH=root, **extra),
                        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE))
                outs, walls = {}, {}

                def finish(what, began, proc):
                    outs[what] = proc.communicate(timeout=300)
                    walls[what] = time.perf_counter() - began

                waiters = [threading.Thread(target=finish, args=(w, b, p))
                           for w, (b, p) in procs.items()]
                for waiter in waiters:
                    waiter.start()
                for waiter in waiters:
                    waiter.join()
                done = {}
                for what, (_began, proc) in procs.items():
                    stdout, stderr = outs[what]
                    check(proc.returncode == 0,
                          f"inputs CLI {what}: exit {proc.returncode}: "
                          f"{stderr[-2000:]}")
                    done[what] = stdout
            finally:
                api.shutdown()
                api.server_close()
                server.join(10)
            requests = C.standin_requests(bin_dir)[before:]
            for what, run in (("analyze", scale), ("analyze --solv", helper)):
                issues = sorted(
                    (i["swc-id"], i["address"], i["function"],
                     i.get("filename"), i.get("lineno"), i.get("code"))
                    for i in json.loads(done[what])["issues"])
                source_findings(f"CLI {what} {run.name}", issues, run, None)
                log(f"inputs CLI {what} {run.name} [{card}]: process wall "
                    f"{walls[what]:.3f} s, findings " + ", ".join(
                        f"SWC-{s} at {a} in {f} {n}:{n_} {c!r}"
                        for s, a, f, n, n_, c in issues))
            solv = [r for r in requests
                    if r["binary"] == f"solc-{C.SOLC_VERSION}"]
            check(len(solv) == 1 and all(
                solv[0]["input"]["settings"].get(k) == v
                for k, v in SOLC_SETTINGS.items()),
                  f"inputs CLI --solv: the stand-in's requests {requests}")
            lines = done["leveldb-search"].splitlines()
            cli_hits = {line.split()[1].rstrip(",") for line in lines}
            check(cli_hits == want_hits and len(lines) == len(want_hits),
                  f"inputs CLI leveldb-search: {len(lines)} lines")
            check(done["hash-to-address"].strip() == impl.address,
                  f"inputs CLI hash-to-address: {done['hash-to-address']!r}")
            pro = sorted((i["swc-id"], i["address"], i["severity"],
                          i["title"], i["function"],
                          i["description"].split("\n")[0])
                         for i in json.loads(done["pro"])["issues"])
            submitted = api.submissions
            check(pro == sorted(C.PRO_EXPECTED) and len(submitted) == 1
                  and submitted[0]["contractName"] == helper.contract
                  and submitted[0]["sources"]["SCALE.sol"]["source"]
                  == C.solc_output("SCALE.sol")[0]["SCALE.sol"],
                  f"inputs CLI pro: issues {pro}, submitted "
                  f"{[s.get('contractName') for s in submitted]}")
            log(f"inputs CLI [{card}]: leveldb-search {len(lines)} hits in "
                f"{walls['leveldb-search']:.3f} s (process), hash-to-address "
                f"{done['hash-to-address'].strip()} in "
                f"{walls['hash-to-address']:.3f} s, pro {pro} in "
                f"{walls['pro']:.3f} s ({len(submitted)} submission, "
                f"sources {sorted(submitted[0]['sources'])}), --solv "
                f"{C.SOLC_VERSION}: binary {solv[0]['binary']}, settings "
                f"{ {k: solv[0]['input']['settings'][k] for k in SOLC_SETTINGS} }")
    seconds = time.perf_counter() - started
    log(f"inputs phase [{card}]: {seconds:.1f} s (limit "
        f"{INPUTS_LIMIT_S:.0f} s), launches {totals}")
    check(seconds <= INPUTS_LIMIT_S,
          f"inputs phase took {seconds:.1f} s, past its "
          f"{INPUTS_LIMIT_S:.0f} s")
    return totals


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import default_device

    pool, edge_futures = start_edge_plain()
    try:
        return _main(torch, frontiers, default_device, pool, edge_futures)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _main(torch, frontiers, default_device, edge_pool,
          edge_futures) -> int:
    started = last = time.perf_counter()
    seconds = {}

    def phase_done(name):
        nonlocal last
        now = time.perf_counter()
        seconds[name] = now - last
        last = now

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}, {card_uuid()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {kind}")
    default_device()
    for line in build_all():
        log(line)
    phase_done("card and build")

    sweep_entry = kernel_phase()
    phase_done("sweep kernel")
    step_entry = dpll_step_phase()
    phase_done("dpll step")
    frontier_entries = frontier_kernel_phase()
    phase_done("frontier kernels")
    lane_step_phase()
    phase_done("lane step")
    frontier_geometry_phase()
    phase_done("frontier geometries")
    tuner_edges_phase()
    phase_done("tuner edges")
    round_entry = round_lane_phase()
    phase_done("round lane")
    # launches of the default configuration (the kernels line) and of
    # the runs under the MYTHRIL_TPU_RESIDENT_KERNEL=0 kill switch
    totals, kill_switch = {}, {}
    guard = lambda: frontiers.guard_chain_frontier(64, 32)  # noqa: E731
    for name, build, expect, knobs in (
        ("scale_mul d6 g16", lambda: frontiers.scale_mul_frontier(6, 16),
         "dense", {}),
        ("guard chain 64x32", guard, "resident", {}),
        ("guard chain 64x32", guard, "dense",
         {"MYTHRIL_TPU_RESIDENT_KERNEL": "0"}),
        ("guard chain 64x32", guard, "ladder",
         {"MYTHRIL_TPU_RESIDENT_KERNEL": "0", "MYTHRIL_TPU_DENSE": "0"}),
        ("guard chain 64x32", guard, "round lanes",
         {"MYTHRIL_TPU_FRONTIER": "0", "MYTHRIL_TPU_DENSE": "0"}),
    ):
        launches = main_path_phase(name, build, expect, knobs)
        # the round lanes are the path of MYTHRIL_TPU_FRONTIER=0 (and of
        # the prefetch): their launches count with the main path's
        _add(totals if not knobs or expect == "round lanes" else kill_switch,
             launches)
    phase_done("main path")
    word_entry = word_prop_phase(card, edge_pool, edge_futures)
    phase_done("word fixpoint")
    _add(totals, prefetch_phase(card))
    phase_done("prefetch")
    lockstep_entry = lockstep_phase(card)
    phase_done("lockstep")
    default, yardstick, hashed = analyze_phase(card)
    phase_done("analyze")
    keccak_entry = keccak_phase(card, hashed)
    phase_done("keccak")
    faulted = resilience_phase(card)
    phase_done("resilience")
    _add(totals, persist_phase(card))
    phase_done("persist")
    _add(totals, proof_phase(card))
    phase_done("proof")
    fleet_phase(card, kind)
    phase_done("fleet")
    _add(totals, serve_phase(card))
    phase_done("serve")
    statespace_phase(card)
    phase_done("statespace")
    _add(totals, onchain_phase(card))
    phase_done("onchain")
    _add(totals, inputs_phase(card))
    phase_done("inputs")
    _add(totals, default)
    _add(kill_switch, yardstick)
    log(f"launches in the default configuration (the kernels line): "
        f"{totals}; in the MYTHRIL_TPU_RESIDENT_KERNEL=0 runs and the "
        f"MYTHRIL_TPU_VERITEST=0 run (not in it): {kill_switch}; in the "
        f"resilience phase's runs (not in it): {faulted}")
    log("dpll_step launches by (B, V, D) over every audited run, the most "
        "first: " + ", ".join(
            f"{shape}: {n}" for shape, n in sorted(
                STEP_SHAPE_LAUNCHES.items(), key=lambda item: -item[1])))
    log(f"dense rounds by step budget over every main-path and analyze "
        f"run: {dict(sorted(DENSE_ROUNDS['budgets'].items()))}; hot-view "
        f"steps {DENSE_ROUNDS['hot_view_steps']}")
    entries = [sweep_entry, step_entry] + frontier_entries + [
        round_entry, word_entry, lockstep_entry, keccak_entry]
    for entry in entries:
        entry["launches"] = totals.get(entry["name"], 0)
        check(entry["launches"] > 0, f"{entry['name']} never launched")
    log(f"chip check: {time.perf_counter() - started:.1f} s (" + ", ".join(
        f"{name} {t:.1f} s" for name, t in seconds.items()) + ")")

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
