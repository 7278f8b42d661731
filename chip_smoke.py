#!/usr/bin/env python3
"""Chip check of the PyTorch port (``mythril_tpu_torch``) on one NVIDIA
H100: the quickest proof that the port still starts on the GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase catches its own
failure):

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build: the native CDCL library (g++), the dense sweep kernel and the
   frontier kernels (nvcc, sm_90a), all three started together, with
   their build seconds and the ``-Xptxas -v`` register / shared-memory
   lines;
3. kernels vs plain: the hand-written sweep against ``sweep_plain`` at
   the slice's shape (C = 16384 clauses, V = 4096 variables, B = 64
   lanes, random sparse 0/1 planes from a numpy seed), scores on and off
   and a 2048-row hot prefix; the frontier kernels (``scan_rows``,
   ``lane_step``, ``round_epilogue``) against their plain versions,
   iteration by iteration, on ``frontiers.learning_problem`` at the
   resident solver's caps (C = 16384, K = 8, V1 = 8193, B = 64,
   fan x deg = 512, E = 64, 40 shared rows prefilled), until the
   compared launches held conflicts under decisions in several lanes and
   on a shared row, learned rows in several lanes, equal rows from twin
   lanes, a shared row learned again, a pool overflow and cascades (the
   phase fails if one is missing); then two iterations at V1 = 16385,
   where the scan's planes live in global memory; every output equal
   bit for bit; times each kernel on the device, its plain version and
   the bound (for the sweep also 4 + 4 float32 ``torch.matmul`` calls, a
   yardstick the port never uses; the frontier kernels have no library
   counterpart);
4. main path: frontiers through ``ops.batched_sat.batch_check_states``
   on ``cuda``: the ``scale_mul`` frontier of ``bench.py`` (depth 6 /
   16-bit guards, past the cone caps: dense tier), and 64 sibling forks
   sharing a 32-bit MUL guard chain, three times: as the default runs it
   (the dense tier delegates it to the resident solver), with
   ``MYTHRIL_TPU_RESIDENT_KERNEL=0`` (dense tier), and with the dense
   tier off as well (the multi-dispatch frontier ladder).  Each run
   holds every kernel it launches against its plain version on the
   run's own inputs (every frontier call that may learn, append or
   cascade, and a sample of the rest), checks the launch counts, every verdict against the
   known ones, and every device UNSAT against the port's own CDCL;
5. analyze: ``myth analyze`` on the card through the port's analyzer
   (``mythril.MythrilAnalyzer``, as ``python3 -m mythril_tpu_torch
   analyze`` runs it) over the runs of ``contracts.CHIP_RUNS`` (the
   ``bench.py`` scale contract at -t 1 and -t 2, two vendored fixtures,
   killbilly); per run, checks the SWC set against the JAX package's,
   that no deadline cut the run, that the scale runs reached a device
   tier, and that every audited kernel call equals its plain version;
   prints the wall, states, prune calls, dispatches, resident solves and
   their exits, delegations, lanes decided on the device and on the
   tail, kernel launches and learned clauses; checks that some run went
   through the resident solver with all three frontier kernels; repeats
   each scale contract with the batched path off (per-state CDCL only)
   and d6 -t 1 with ``MYTHRIL_TPU_RESIDENT_KERNEL=0``, the yardsticks;
6. the launches of the default configuration and, apart, of the
   ``MYTHRIL_TPU_RESIDENT_KERNEL=0`` runs; one JSON line per kernel
   (launches of the default configuration), the card line, then the
   result line.

Exits non-zero, printing no result, when no CUDA device is present.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

#: the sweep shape of the slice's main path (C clauses, V vars, B lanes)
SWEEP_C, SWEEP_V, SWEEP_B, HOT_ROWS = 16384, 4096, 64, 2048
#: the frontier kernels' shape: the resident solver at the cone caps, its
#: shared pool prefilled with 40 rows (so 32 distinct learned rows overflow
#: it); and the union-cone tier's largest var bucket
FRONTIER_C, FRONTIER_V1, FRONTIER_B, FRONTIER_E = 16384, 8193, 64, 64
FRONTIER_PREFILL, FRONTIER_WIDE_V1 = 40, 16385
#: iterations the frontier kernel phase may take to see every case
FRONTIER_ITERS = 64
#: where the check runs its kernels (only ever "cuda" when run as a script)
DEVICE = "cuda"
#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit); the table of
#: peaks has no int32 rate, so integer work is held against the float32
#: rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


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


def kernel_device_ms(fn, iters, kernel="dense_sweep_kernel"):
    """Device time of one launch of ``kernel``, from the profiler (the
    wrapper's host work and any copies around it are not in it)."""
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
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    check(len(hits) == 1 and hits[0].count == iters,
          f"profiler did not see {kernel}")
    return hits[0].self_device_time_total / iters / 1e3


def build_all():
    """The three builds, started together; returns their log lines."""
    from mythril_tpu_torch.native import load as load_native
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import frontier_kernels as FK

    jobs = {"native CDCL": load_native, "dense_sweep.cu": ds.load_library,
            "frontier.cu": FK.load_library}
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
                       ("frontier.cu", FK.build_info)):
        if info is not None:
            lines.append(f"nvcc -Xptxas -v {name}: " + " | ".join(
                line.strip() for line in info[1].splitlines()
                if "registers" in line or "smem" in line
                or "spill" in line or "Function properties" in line))
    return lines


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


def bound(bytes_moved, ops):
    """(least ms, what bounds it): the bytes at the HBM rate against
    the operations at the scalar rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sweep_bound(C, V, B, nnz, outputs, scatter_adds):
    """Least time for one sweep: each input read once and each output
    written once at the HBM rate, against the operations this data needs
    (two counts per nonzero cell and lane, one add per output unit) at
    the float32 rate."""
    bytes_moved = 2 * C * V * 2 + 4 * C + 4 * B * V \
        + outputs * 4 * B * V + 4 * B
    return bound(bytes_moved, 2 * nnz * B + scatter_adds)


def kernel_phase():
    """Sweep kernel vs plain at the slice's shape; returns the kernel's
    JSON entry (the scores-on full sweep, the main path's
    configuration)."""
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


def audited_case(name, loop, parity):
    """Whether this call of ``name`` is one the audit always holds (see
    AUDITED_CASES); reads a few flags back from the card."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    if name not in AUDITED_CASES or int(loop.ctl[parity, FK.HALT]):
        return False
    lane, buf = loop.lane, loop.buf
    if name == "lane_step":
        case = ((buf["conflict"] != 0) & (lane["depth"] > 0)
                & (lane["status"] == 0))
    else:
        case = (buf["okl"] != 0) | ((buf["flags"] & FK.FLAG_CASCADE) != 0)
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


def learning_loop(C, V1, B, E, prefill):
    """``frontiers.learning_problem`` on the card as a resident loop at
    the default knobs, its shared pool prefilled with ``prefill`` rows."""
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import frontier as FR
    from mythril_tpu_torch.ops import frontier_kernels as FK
    from mythril_tpu_torch.ops import resident as RK

    rows, assign, extra = frontiers.learning_problem(C, V1, B, E,
                                                     prefill=prefill)
    dev = torch.device(DEVICE)
    state = RK.resident_state0(assign, B, 256, extra_cap=E)
    lane = FK.to_device(state, FR.FRONTIER_STATE_FIELDS, dev)
    cfg = FK.StepConfig(fan=FR.DEFAULT_FAN, period=FR.DEFAULT_PERIOD,
                        limit=RK.resident_budget(),
                        watchdog=RK.resident_watchdog_limit(), extra_cap=E,
                        learn_cap=FR.LEARN_CAP, uip_iters=FR.UIP_ITERS,
                        resident=True)
    adj = FR.build_adjacency(rows, V1, deg=FR.DEFAULT_DEG)
    return FK.make_loop(torch.from_numpy(rows).to(dev),
                        torch.from_numpy(adj).to(dev), lane, cfg,
                        torch.from_numpy(extra).to(dev), nextra0=prefill)


def _restore(loop, snap):
    for group in ("lane", "buf"):
        for k, v in getattr(snap, group).items():
            getattr(loop, group)[k].copy_(v)
    for k in ("extra", "ctl"):
        getattr(loop, k).copy_(getattr(snap, k))


def _smem_check(loop):
    """The library's shared-memory sizes for the loop's launches equal
    ``frontier_kernels.smem_layout``'s (the Python side's limit check)."""
    import ctypes

    from mythril_tpu_torch.ops import frontier_kernels as FK

    B, V1 = loop.lane["assign"].shape
    layout = FK.smem_layout(B, V1, loop.args.fan, loop.cfg.uip_iters)
    got = {name: FK._lib.frontier_smem_bytes(ctypes.byref(loop.args), kid)
           for name, kid in FK.KERNEL_IDS.items()}
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
                conf = ((buf["conflict"] != 0) & (lane["depth"] > 0)
                        & (lane["status"] == 0))
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
    check(layout["planes_in_smem"], "V1=8193 should keep the planes in smem")

    wide = learning_loop(FRONTIER_C, FRONTIER_WIDE_V1, FRONTIER_B, E,
                         FRONTIER_PREFILL)
    views = []
    for it in range(2):
        views.append("full" if int(wide.ctl[it & 1, FK.FULL]) else "gather")
        for name in FRONTIER_KERNELS:
            run_checked(name, wide, it & 1, getattr(FK, name))
    layout = _smem_check(wide)
    check(not layout["planes_in_smem"] and views == ["full", "gather"],
          f"V1={FRONTIER_WIDE_V1}: {layout}, views {views}")
    log(f"frontier kernels vs plain at V1={FRONTIER_WIDE_V1} (the scan's "
        f"planes in global memory; shared memory {layout}): a full and a "
        f"gather iteration, every launch equal bit for bit")
    return [entries[name] for name in FRONTIER_KERNELS]


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
    log(f"frontier {name} ({what}; {'full' if full else 'gather'} view, "
        f"C={FRONTIER_C} V1={FRONTIER_V1} B={FRONTIER_B} E={FRONTIER_E} "
        f"fan x deg=512; {desc}): kernel {ms:.4f} ms (device), plain "
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
        bytes_moved = (plane * (1 + 1 + 4 + 4 + 8) + (plane * 8 if full else 0)
                       + acting * V1 * (1 + 4 + 4 + 4 + 1 + 8) + B * 6 * 4)
        return bytes_moved, plane * 8, \
            f"{acting} lanes acting, {learned} learning"
    pending = int(((flags & 4) != 0).sum())
    learned = int((snap.buf["okl"] != 0).sum())
    bytes_moved = (B * (K * 4 + 3 * 4) + ne * K * 4
                   + pending * V1 * (1 + 4 + 4) + 2 * 8 * 4)
    return bytes_moved, B * (ne + B) * K + pending * V1 * 4, \
        f"{learned} learned rows, {pending} cascades"


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


@contextlib.contextmanager
def audited_kernels():
    """Every kernel call of the block audited; the launch counts zeroed
    just before and read into the yielded dict just after."""
    from mythril_tpu_torch.ops import dense_prop
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import frontier_kernels as FK

    sweep = SweepAudit(dense_prop.dense_sweep)
    dense_prop.dense_sweep = sweep
    out = {"sweep": sweep}
    try:
        with FrontierAudit() as frontier:
            out["frontier"] = frontier
            ds.reset_launch_count()
            FK.reset_launch_counts()
            yield out
            out["launches"] = {"dense_sweep": ds.launch_count,
                               **FK.launch_counts}
    finally:
        dense_prop.dense_sweep = sweep.sweep
    out["seconds"] = sweep.seconds + frontier.seconds


def main_path_phase(name, build, expect, knobs):
    """One frontier through ``batch_check_states`` with ``knobs`` set;
    ``expect`` names the tier that must answer it ("dense", "resident"
    or "ladder").  Returns the run's kernel launches."""
    import torch

    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.ops.dense_prop import get_dense_backend
    from mythril_tpu_torch.smt.solver import reset_blast_context

    reset_blast_context()
    lanes, expected = build()
    with env(**knobs), audited_kernels() as audit:
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
    log(f"main path {name} [{expect}] kernels vs plain: "
        f"{audit['sweep'].summary() or 'no sweep'}; "
        f"{audit['frontier'].summary() or 'no frontier kernel'}")
    check(stats.dispatches == 1, f"{name}: no device tier engaged")
    check(stats.rounds > 0, f"{name}: no round ran")
    if expect == "dense":
        check(audit["sweep"].checked and launches["dense_sweep"] > 0,
              f"{name}: no main-path sweep reached the kernel")
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
        loop_bound=3, batched_solving=batched_solving, device=DEVICE,
    )
    started = time.perf_counter()
    report = analyzer.fire_lasers(transaction_count=run.transaction_count)
    torch.cuda.synchronize()
    return report, analyzer, time.perf_counter() - started


def analyze_audited(run, card, label=""):
    """One audited batched analysis; logs its line and returns
    (launches, stats snapshot)."""
    from mythril_tpu_torch.laser.batch import prune_stats
    from mythril_tpu_torch.laser.ethereum.time_handler import time_handler
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.smt import SolverStatistics
    from mythril_tpu_torch.smt.solver import get_blast_context

    with audited_kernels() as audit:
        report, analyzer, wall = analyze_once(run)
    fused = bs.dispatch_fuse.fused_generation == get_blast_context().generation
    wall -= audit["seconds"]
    launches = audit["launches"]
    check(not report.exceptions,
          f"{run.name}: the analysis failed:\n" + "\n".join(report.exceptions))
    stats = bs.dispatch_stats
    laser = analyzer.last_sym.laser
    found = {issue.swc_id for issue in report.issues.values()}
    log(f"analyze {run.name}{label} [{card}]: wall {wall:.3f} s without the "
        f"audits' {audit['seconds']:.3f} s, {laser.total_states} states, "
        f"{prune_stats.calls} prune calls ({prune_stats.batched_calls} "
        f"through the funnel), {stats.dispatches} dispatches ({stats.lanes} "
        f"lanes; {stats.dense_declines} past the dense caps, "
        f"{stats.resident_delegations} delegated, {stats.size_bailouts} "
        f"past the gather caps), {stats.resident_dispatches} resident solves "
        f"({stats.resident_exit_all_decided} all decided, "
        f"{stats.resident_exit_budget} budget, {stats.resident_exit_watchdog} "
        f"watchdog), lanes decided on the device "
        f"{stats.unsat + stats.sat_verified} ({stats.unsat} unsat, "
        f"{stats.sat_verified} sat), on the tail {prune_stats.tail_states}, "
        f"{stats.rounds} rounds, {stats.device_sweeps} full sweeps, "
        f"{stats.frontier_steps} gather steps, {stats.learned_clauses} "
        f"learned clauses, adaptive fuse {'blown' if fused else 'armed'} "
        f"at the end, launches {launches}, device tiers "
        f"{stats.device_s:.3f} s (with the audits), native CDCL "
        f"{SolverStatistics().native_s:.3f} s, SWC {sorted(found)}")
    log(f"analyze {run.name}{label} kernels vs plain: "
        f"{audit['sweep'].summary() or 'no sweep'}; hot-prefix sweeps "
        f"{audit['sweep'].hot_prefix_calls()}; "
        f"{audit['frontier'].summary() or 'no frontier kernel'}")
    check(found == run.swc_ids,
          f"{run.name}: SWC {sorted(found)} != {sorted(run.swc_ids)}")
    check(not laser.timed_out and time_handler.time_remaining() > 0,
          f"{run.name}: the execution deadline cut the run")
    return launches, {"dispatches": stats.dispatches,
                      "resident": stats.resident_dispatches}


def analyze_phase(card):
    """The chip runs through the port's analyzer on ``cuda``; returns
    the launches of every kernel over the batched runs in the default
    configuration, and those of the ``MYTHRIL_TPU_RESIDENT_KERNEL=0``
    yardstick."""
    from mythril_tpu_torch.contracts import CHIP_RUNS
    from mythril_tpu_torch.smt import SolverStatistics

    total = {}
    through_resident = False
    for run in CHIP_RUNS:
        launches, stats = analyze_audited(run, card)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if stats["resident"] and all(launches[k] for k in FRONTIER_KERNELS):
            through_resident = True
        if run.dense:
            check(stats["dispatches"] >= 1,
                  f"{run.name}: no device dispatch")
            check(sum(launches.values()) > 0,
                  f"{run.name}: no kernel launched")
            report, analyzer, wall = analyze_once(run, batched_solving=False)
            found = {issue.swc_id for issue in report.issues.values()}
            log(f"analyze {run.name} CDCL only [{card}]: wall {wall:.3f} s, "
                f"{analyzer.last_sym.laser.total_states} states, native "
                f"CDCL {SolverStatistics().native_s:.3f} s, "
                f"SWC {sorted(found)}")
            check(not report.exceptions and found == run.swc_ids,
                  f"{run.name} CDCL only: SWC {sorted(found)}")
    check(through_resident, "no analysis went through the resident solver "
          "with all three frontier kernels")
    # the yardstick of the resident solver: d6 -t 1 on the dense tier
    run = CHIP_RUNS[0]
    with env(MYTHRIL_TPU_RESIDENT_KERNEL="0"):
        launches, stats = analyze_audited(
            run, card, " MYTHRIL_TPU_RESIDENT_KERNEL=0")
    check(stats["resident"] == 0 and launches["dense_sweep"] > 0,
          "the RESIDENT_KERNEL=0 yardstick did not run the dense tier")
    return total, launches


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

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {kind}")
    default_device()
    for line in build_all():
        log(line)

    sweep_entry = kernel_phase()
    frontier_entries = frontier_kernel_phase()
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
    ):
        _add(kill_switch if knobs else totals,
             main_path_phase(name, build, expect, knobs))
    default, yardstick = analyze_phase(card)
    _add(totals, default)
    _add(kill_switch, yardstick)
    log(f"launches in the default configuration (the kernels line): "
        f"{totals}; in the MYTHRIL_TPU_RESIDENT_KERNEL=0 runs (not in it): "
        f"{kill_switch}")
    entries = [sweep_entry] + frontier_entries
    for entry in entries:
        entry["launches"] = totals.get(entry["name"], 0)
        check(entry["launches"] > 0, f"{entry['name']} never launched")

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
