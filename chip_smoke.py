#!/usr/bin/env python3
"""Chip check of the PyTorch port (``mythril_tpu_torch``) on one NVIDIA
H100: the quickest proof that the port still starts on the GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase catches its own
failure):

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: the native CDCL library (g++) and the dense sweep kernel
   (nvcc, sm_90a), with their build seconds;
3. kernel vs plain: the hand-written sweep against ``sweep_plain`` at the
   slice's shape (C = 16384 clauses, V = 4096 variables, B = 64 lanes,
   random sparse 0/1 planes from a numpy seed), scores on and off and a
   2048-row hot prefix; outputs must be equal bit for bit; times the
   kernel, the plain version, the same sweep as 4 + 4 float32
   ``torch.matmul`` calls (a yardstick the port never uses), and the
   bound;
4. main path: two EVM-shaped frontiers through
   ``ops.batched_sat.batch_check_states`` on ``cuda`` (the
   ``scale_mul`` frontier of ``bench.py``, depth 6 / 16-bit guards, and
   64 sibling forks sharing a 32-bit MUL guard chain); holds the kernel
   against ``sweep_plain`` on the main path's own sweeps (shapes and
   data); checks the kernel launch count, the ladder rounds, every
   verdict against the known ones, and every device UNSAT against the
   port's own CDCL;
5. analyze: ``myth analyze`` on the card through the port's analyzer
   (``mythril.MythrilAnalyzer``, as ``python3 -m mythril_tpu_torch
   analyze`` runs it) over the runs of ``contracts.CHIP_RUNS`` (the
   ``bench.py`` scale contract at -t 1 and -t 2, two vendored fixtures,
   killbilly); per run, checks the SWC set against the JAX package's,
   that no deadline cut the run, that the scale runs reached the dense
   tier and its kernel, and that every audited sweep equals
   ``sweep_plain`` bit for bit; prints the wall, states, prune calls,
   dense dispatches, lanes decided on the device and on the tail, and
   kernel launches; runs each scale contract once more with the batched
   path off (per-state CDCL only, the yardstick) and checks its SWC set
   too;
6. one JSON line per kernel, the card line, then the result line.

Exits non-zero, printing no result, when no CUDA device is present.
"""

import json
import subprocess
import sys
import time

import numpy as np

#: the sweep shape of the slice's main path (C clauses, V vars, B lanes)
SWEEP_C, SWEEP_V, SWEEP_B, HOT_ROWS = 16384, 4096, 64, 2048
#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


class CheckFailed(RuntimeError):
    pass


def check(cond, message):
    if not cond:
        raise CheckFailed(message)


def log(message):
    print(message, flush=True)


def card_line():
    done = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(done.returncode == 0, f"nvidia-smi failed: {done.stderr}")
    return done.stdout.strip().splitlines()[0]


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


def kernel_device_ms(fn, iters):
    """Device time of one launch of the sweep kernel, from the profiler
    (the wrapper's host work is not in it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and "dense_sweep_kernel" in e.key]
    check(len(hits) == 1 and hits[0].count == iters,
          "profiler did not see the sweep kernel")
    return hits[0].self_device_time_total / iters / 1e3


def random_sweep_inputs(C, V, B, seed=0):
    """CNF-like planes: each live row has 1-12 literals on distinct
    columns >= 2 with random signs; the last eighth of the rows is bucket
    padding (width 0).  A holds the anchor, and random {-1, 0, +1}."""
    import torch

    rng = np.random.default_rng(seed)
    live = C - C // 8
    widths = rng.integers(1, 13, size=live)
    rows = np.repeat(np.arange(live), widths)
    cols = np.concatenate([
        rng.choice(np.arange(2, V), size=w, replace=False) for w in widths
    ])
    neg = rng.random(rows.size) < 0.5
    dev = torch.device("cuda")
    P = torch.zeros((C, V), dtype=torch.bfloat16, device=dev)
    N = torch.zeros((C, V), dtype=torch.bfloat16, device=dev)
    P[torch.from_numpy(rows[~neg]).to(dev),
      torch.from_numpy(cols[~neg]).to(dev)] = 1
    N[torch.from_numpy(rows[neg]).to(dev),
      torch.from_numpy(cols[neg]).to(dev)] = 1
    width = np.zeros((1, C), np.float32)
    width[0, :live] = widths
    A = rng.choice([-1.0, 0.0, 1.0], size=(B, V)).astype(np.float32)
    A[:, 0] = 0.0
    A[:, 1] = 1.0
    return (P, N, torch.from_numpy(width).to(dev),
            torch.from_numpy(A).to(dev), int(rows.size))


def sweep_bound(C, V, B, nnz, outputs, scatter_adds):
    """Least time for one sweep: each input read once and each output
    written once at the HBM rate, against the operations this data needs
    (two counts per nonzero cell and lane, one add per output unit) at
    the float32 rate."""
    bytes_moved = 2 * C * V * 2 + 4 * C + 4 * B * V \
        + outputs * 4 * B * V + 4 * B
    ops = 2 * nnz * B + scatter_adds
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase():
    """Kernel vs plain at the slice's shape; returns the kernel's JSON
    entry (the scores-on full sweep, the main path's configuration)."""
    import torch

    from mythril_tpu_torch.ops import dense_sweep as ds

    P, N, width, A, nnz = random_sweep_inputs(SWEEP_C, SWEEP_V, SWEEP_B)
    entry = None
    for scores, rows in ((True, None), (False, None), (True, HOT_ROWS)):
        got = ds.dense_sweep(P, N, width, A, scores, rows)
        torch.cuda.synchronize()
        want = ds.sweep_plain(P, N, width, A, scores, rows)
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape, f"shape {g.shape} vs {w.shape}")
            check(torch.equal(g, w),
                  f"kernel != plain (scores={scores}, rows={rows})")
            err = max(err, float((g - w).abs().max()))
        check(float(got[0].sum()) > 0 and float(got[2].sum()) > 0,
              "vacuous sweep inputs (no unit clause or no conflict)")
        C = rows or SWEEP_C
        rows_nnz = nnz if rows is None else int(
            ((P[:rows] != 0).sum() + (N[:rows] != 0).sum()).item())

        def launch():
            return ds.dense_sweep(P, N, width, A, scores, rows)

        ms = kernel_device_ms(launch, 20)
        wrapper_ms = cuda_ms(launch, 20)
        plain_ms = cuda_ms(
            lambda: ds.sweep_plain(P, N, width, A, scores, rows), 5, 1)
        Pf = P[:C].float()
        Nf = N[:C].float()
        pos, neg = A.clamp(min=0.0), (-A).clamp(min=0.0)
        mask = torch.ones((SWEEP_B, C), device=A.device)

        def library():
            for lhs, rhs in ((pos, Pf), (neg, Nf), (neg, Pf), (pos, Nf)):
                torch.matmul(lhs, rhs.T)
            for rhs in ((Pf, Nf, Pf, Nf) if scores else (Pf, Nf)):
                torch.matmul(mask, rhs)

        library_ms = cuda_ms(library, 5, 1)
        del Pf, Nf
        outputs = 4 if scores else 2
        adds = int(sum(float(t.sum()) for t in got[:2] + got[3:]))
        bound_ms, bound_by = sweep_bound(C, SWEEP_V, SWEEP_B, rows_nnz,
                                         outputs, adds)
        log(f"sweep C={C} V={SWEEP_V} B={SWEEP_B} scores={scores} "
            f"nnz={rows_nnz}: kernel {ms:.4f} ms (device; {wrapper_ms:.4f} ms "
            f"a call through the wrapper), plain {plain_ms:.4f} ms, "
            f"4+{outputs} f32 matmuls {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), equal bit for bit")
        if entry is None:
            entry = {
                "name": "dense_sweep", "route": "cuda",
                "source": "mythril_tpu_torch/ops/csrc/dense_sweep.cu",
                "replaces": "mythril_tpu/ops/pallas_prop.py:435",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
            }
    return entry


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
    compares the kernel's outputs with the plain version on the same
    tensors, before the loop moves on.  It launches no kernel of its
    own, so the launch count stays the main path's."""

    def __init__(self, sweep):
        self.sweep = sweep
        self.calls = {}
        self.checked = {}
        self.seconds = 0.0

    def __call__(self, P, N, width, A, scores, rows=None):
        import torch

        from mythril_tpu_torch.ops import dense_sweep as ds

        got = self.sweep(P, N, width, A, scores, rows)
        key = (P.shape[0], P.shape[1], A.shape[0], rows or P.shape[0],
               bool(scores))
        n = self.calls[key] = self.calls.get(key, 0) + 1
        if n & (n - 1) == 0:
            started = time.perf_counter()
            torch.cuda.synchronize()
            want = ds.sweep_plain(P, N, width, A, scores, rows)
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


def main_path_phase(name, build, device="cuda"):
    """One frontier through ``batch_check_states``; returns its launches."""
    import torch

    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.ops import dense_prop
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops.dense_prop import get_dense_backend
    from mythril_tpu_torch.smt.solver import reset_blast_context

    reset_blast_context()
    lanes, expected = build()
    audit = SweepAudit(dense_prop.dense_sweep)
    dense_prop.dense_sweep = audit
    try:
        bs.dispatch_stats.reset()
        ds.reset_launch_count()
        started = time.perf_counter()
        verdicts = bs.batch_check_states(lanes, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - started - audit.seconds
        launches = ds.launch_count
    finally:
        dense_prop.dense_sweep = audit.sweep
    stats = bs.dispatch_stats
    tiers = list(stats.last_tiers)
    backend = get_dense_backend(device)
    on_device = [i for i, t in enumerate(tiers) if t == "device"]
    log(f"main path {name}: {len(lanes)} lanes, layout "
        f"{backend.last_layout}, C x V x B = "
        f"{' x '.join(map(str, backend.last_shape or ()))}, "
        f"{stats.rounds} rounds, {stats.device_sweeps} sweeps, "
        f"{launches} kernel launches, decided on device "
        f"{len(on_device)} ({stats.unsat} unsat, {stats.sat_verified} sat),"
        f" on the tail {tiers.count('tail')}, wall {wall:.3f} s "
        f"without the sweep audit's {audit.seconds:.3f} s (device tier "
        f"{stats.device_s:.3f} s with it, tail {stats.tail_s:.3f} s)")
    log(f"main path {name} sweeps vs plain: {audit.summary()}")
    check(audit.checked, f"{name}: no main-path sweep reached the kernel")
    check(stats.dispatches == 1, f"{name}: dense tier did not engage")
    check(stats.rounds > 0, f"{name}: no ladder round ran")
    check(verdicts == expected,
          f"{name}: verdicts {verdicts} != known {expected}")
    device_unsat = [i for i in on_device if verdicts[i] is False]
    check(all(cdcl_unsat(build, device_unsat)),
          f"{name}: a device UNSAT disagrees with the CDCL")
    check(all(expected[i] for i in on_device if verdicts[i] is True),
          f"{name}: a device SAT lane is known dead")
    return launches


#: wall-clock limit of one chip-check analysis (no run comes close)
ANALYZE_TIMEOUT_S = 600


def analyze_once(run, batched_solving=True):
    """One chip run through the port's analyzer on ``cuda``: (report,
    analyzer, wall seconds)."""
    import torch

    from mythril_tpu_torch.mythril import MythrilAnalyzer, MythrilDisassembler
    from mythril_tpu_torch.mythril.mythril_analyzer import (
        reset_analysis_state,
    )

    reset_analysis_state()
    disassembler = MythrilDisassembler()
    address, _ = disassembler.load_from_bytecode(run.code(), bin_runtime=True)
    analyzer = MythrilAnalyzer(
        disassembler, address=address, strategy="bfs", max_depth=128,
        execution_timeout=ANALYZE_TIMEOUT_S, create_timeout=10,
        loop_bound=3, batched_solving=batched_solving, device="cuda",
    )
    started = time.perf_counter()
    report = analyzer.fire_lasers(transaction_count=run.transaction_count)
    torch.cuda.synchronize()
    return report, analyzer, time.perf_counter() - started


def analyze_phase(card):
    """The chip runs through the port's analyzer on ``cuda``; returns
    the sweep-kernel launches of all runs."""
    from mythril_tpu_torch.contracts import CHIP_RUNS
    from mythril_tpu_torch.laser.batch import prune_stats
    from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.ops import dense_prop
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.smt import SolverStatistics

    launches = 0
    for run in CHIP_RUNS:
        audit = SweepAudit(dense_prop.dense_sweep)
        dense_prop.dense_sweep = audit
        try:
            ds.reset_launch_count()
            report, analyzer, wall = analyze_once(run)
            wall -= audit.seconds
            ran = ds.launch_count
        finally:
            dense_prop.dense_sweep = audit.sweep
        launches += ran
        check(not report.exceptions,
              f"{run.name}: the analysis failed:\n"
              + "\n".join(report.exceptions))
        stats = bs.dispatch_stats
        laser = analyzer.last_sym.laser
        found = {issue.swc_id for issue in report.issues.values()}
        log(f"analyze {run.name} [{card}]: wall {wall:.3f} s without the "
            f"sweep audit's {audit.seconds:.3f} s, {laser.total_states} "
            f"states, {prune_stats.calls} prune calls "
            f"({prune_stats.batched_calls} through the funnel), "
            f"{stats.dispatches} dense dispatches ({stats.lanes} lanes, "
            f"{stats.dense_declines} declined by the caps), lanes decided "
            f"on the device {stats.unsat + stats.sat_verified} "
            f"({stats.unsat} unsat, {stats.sat_verified} sat), on the "
            f"tail {prune_stats.tail_states}, {stats.rounds} rounds, "
            f"{stats.device_sweeps} sweeps, {ran} kernel launches, "
            f"dense tier {stats.device_s:.3f} s (with the audit), native "
            f"CDCL {SolverStatistics().native_s:.3f} s, SWC {sorted(found)}")
        log(f"analyze {run.name} sweeps vs plain: "
            f"{audit.summary() or 'no sweep'}; hot-prefix sweeps "
            f"{audit.hot_prefix_calls()}")
        check(found == run.swc_ids,
              f"{run.name}: SWC {sorted(found)} != {sorted(run.swc_ids)}")
        check(not laser.timed_out and time_handler.time_remaining() > 0,
              f"{run.name}: the execution deadline cut the run")
        if run.dense:
            check(stats.dispatches >= 1, f"{run.name}: no dense dispatch")
            check(ran > 0, f"{run.name}: the sweep kernel never launched")
            check(audit.checked, f"{run.name}: no sweep was audited")
            report, analyzer, wall = analyze_once(run, batched_solving=False)
            found = {issue.swc_id for issue in report.issues.values()}
            log(f"analyze {run.name} CDCL only [{card}]: wall {wall:.3f} s, "
                f"{analyzer.last_sym.laser.total_states} states, native "
                f"CDCL {SolverStatistics().native_s:.3f} s, "
                f"SWC {sorted(found)}")
            check(not report.exceptions and found == run.swc_ids,
                  f"{run.name} CDCL only: SWC {sorted(found)}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.native import load as load_native
    from mythril_tpu_torch.ops import default_device
    from mythril_tpu_torch.ops import dense_sweep as ds

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {kind}")
    default_device()

    started = time.perf_counter()
    load_native()
    log(f"build: native CDCL {time.perf_counter() - started:.1f} s")
    started = time.perf_counter()
    ds.load_library()
    log(f"build: dense_sweep.cu {time.perf_counter() - started:.1f} s")
    if ds.build_info is not None:
        log("nvcc -Xptxas -v: " + " | ".join(
            line.strip() for line in ds.build_info[1].splitlines()
            if "registers" in line or "smem" in line))

    entry = kernel_phase()
    launches = 0
    for name, build in (
        ("scale_mul d6 g16", lambda: frontiers.scale_mul_frontier(6, 16)),
        ("guard chain 64x32", lambda: frontiers.guard_chain_frontier(64, 32)),
    ):
        ran = main_path_phase(name, build)
        check(ran > 0, f"{name}: the sweep kernel never launched")
        launches += ran
    launches += analyze_phase(card)
    entry["launches"] = launches

    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
