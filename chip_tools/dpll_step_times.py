#!/usr/bin/env python3
"""Device times of the dense tier's DPLL step (``ops/csrc/dpll_step.cu``),
of its design variants and of another tree's, what a round of the dense
tier costs on the card, and what a CUDA graph of a round's 16-step window
would cost and save.

Run on the card from the repository root::

    python3 chip_tools/dpll_step_times.py [--parent DIR] [--iters N]

Each tree is measured in processes of its own (the tree's package first
on the path; inputs, bounds and timing code are this tree's
``chip_smoke.py``), in turns: parent, this tree, this tree, parent.  A
tree's process builds its ``dense_sweep.cu`` and ``dpll_step.cu`` as its
wrappers load them, then:

- the step: ``dpll_step`` on ``frontiers.dpll_step_problem``'s seeded
  state 0 on a full view, at the check's B, V, D = 64, 4,096, 1,024 and
  at the main path's most launched 16, 4,096, 1,024 (the shape
  ``chip_smoke.py``'s histogram gives); each launch from the same inputs,
  held bit for bit against ``dpll_step_plain`` first; device ms from the
  profiler (the mean of ``--iters`` launches), the bound;
- rounds: ``make_dense_rounds`` on the planted CNF of ``chip_smoke.py``
  (its pool in the tree's own form, ``tree_smoke``)
  (``ROUNDS``: the check's C, V, B = 16,384, 4,096, 64 and the main
  path's 32,768, 4,096, 16, untiered at the ladder's step budgets 64,
  256 and 1,024 and tiered with 2,048 hot rows, period 8): the round's
  host wall (the median of 11 runs ending in
  ``torch.cuda.synchronize()``), its device operations and busy time
  (the profiler, one more run), the device's idle share (1 - busy /
  wall), which bounds what any graph of the round's launches could save,
  and host µs a step;
- a window as a graph: the round's first 16 steps (a sweep and a step a
  step, as the round loop launches them on the same tensors), from the
  same start state each time, by plain launches and as one CUDA graph
  replayed (medians of 11, each ending in a synchronize), and the
  seconds a capture and its instantiation take.  The steps are the
  window's first, not a base on the device: a replay stands for any
  window's launches, not for a round.

This tree's process also builds the kept kernel's design variants, each
the source under named edits (``VARIANTS``: one block a lane at any B,
as the first design's grid; 256 threads a block, each keeping 16
columns; a warp's top-16 offers always sorted, or inserted one by one
up to 8), binds
each with this tree's wrapper and times the step at both shapes, held
bit for bit against the plain step first.  Prints the card line first;
one JSON line per measurement; exits non-zero without a card or when a
launch differs.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (B, V, D) of the timed steps: the check's, the main path's most launched
STEP_SHAPES = ((64, 4096, 1024), (16, 4096, 1024))
#: (C, V, B, hot rows, tier period, budget) of the timed rounds: the
#: check's sweep and the main path's most launched, untiered at the
#: ladder's budgets, and each tiered (chip_smoke.py counts the main
#: path's rounds by budget and its hot-view steps)
ROUNDS = ((16384, 4096, 64, 0, 1, 64), (32768, 4096, 16, 0, 1, 64),
          (32768, 4096, 16, 0, 1, 256), (32768, 4096, 16, 0, 1, 1024),
          (16384, 4096, 64, 2048, 8, 64), (32768, 4096, 16, 2048, 8, 256))

# Design variants of the kept kernel, each a list of (old, new) source
# edits, each old text found exactly once.
VARIANTS = {
    # one block a lane at any B (the first design's grid); a cluster
    # only where the lane's columns need the room
    "one block a lane": [
        ("  while (cs < kMaxCluster && 2 * cs * B <= kSms) cs *= 2;\n", ""),
    ],
    # 256 threads a block, each keeping 16 columns in registers
    "256 threads": [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
        ("constexpr int kGroups = 2; ", "constexpr int kGroups = 4; "),
    ],
    # every round of a warp's top 16 sorts its offers, however few
    "offers always sorted": [
        ("    if (popcount(offers) <= 4) {\n", "    if (0) {\n"),
    ],
    # up to 8 offers of a round inserted one by one
    "8 offers inserted": [
        ("    if (popcount(offers) <= 4) {\n",
         "    if (popcount(offers) <= 8) {\n"),
    ],
}


def edited(source, edits):
    for old, new in edits:
        if source.count(old) != 1:
            raise SystemExit(f"variant edit not found once: {old!r}")
        source = source.replace(old, new)
    return source


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def planes_operands(row, col, negative, width, V):
    """The sweep's pool operands as a tree of this repository from before
    the clause rows holds them: bf16 planes (P, N) and the widths."""
    import torch

    dev = torch.device("cuda")
    planes = []
    for sel in (~negative, negative):
        plane = torch.zeros((width.shape[1], V), dtype=torch.bfloat16,
                            device=dev)
        plane[torch.from_numpy(row[sel]).to(dev),
              torch.from_numpy(col[sel]).to(dev)] = 1
        planes.append(plane)
    return (*planes, torch.from_numpy(width).to(dev))


def tree_smoke():
    """This tree's ``chip_smoke``, its sweep operands in the form the
    imported tree's union pool holds (call it with that tree's package
    first on the path)."""
    smoke = load_smoke()
    from mythril_tpu_torch.ops import dense_sweep as ds

    if not hasattr(ds, "rows_from_coords"):
        smoke.sweep_operands = planes_operands
    return smoke


def emit(record):
    print(json.dumps(record), flush=True)


def step_case(smoke, launch, B, V, D, iters):
    """(device ms, bound ms, cluster) of ``launch(*work)`` on seeded
    state 0 at (B, V, D), held against the plain step first."""
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import dpll_step as DSTEP

    dev = torch.device("cuda")
    state, outs = frontiers.dpll_step_problem(B, V, D, True, 0)
    state = [torch.from_numpy(a).to(dev) for a in state]
    outs = [torch.from_numpy(a).to(dev) for a in outs]
    flags = torch.tensor([4, 6], dtype=torch.int32, device=dev)
    work = smoke.step_clones(state, outs, flags)
    want = smoke.step_clones(state, outs, flags)
    launch(*work)
    torch.cuda.synchronize()
    DSTEP.dpll_step_plain(*want, 9, True, False, True)
    smoke.step_compare(f"step B={B} V={V} D={D}", work, want)

    def timed():
        for dst, src in zip(work[0] + work[1] + [work[2]],
                            state + outs + [flags]):
            dst.copy_(src)
        launch(*work)

    ms = smoke.kernel_device_ms(timed, iters, kernel="dpll_step_kernel")
    return ms, smoke.step_bound(state, outs, want[0], True)[0]


def round_case(smoke, C, V, B, hot_c, period, budget):
    """Host wall, device ops, busy ms and idle share of one round by
    plain launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mythril_tpu_torch.ops import dense_prop

    operands, state0 = smoke.planted_round_inputs(C, V, B)
    fn = dense_prop.make_dense_rounds(C, V, B, budget, dense_prop.CUDA_TIER,
                                      dense_prop.MAX_DECISIONS, hot_c, period)
    fn(*operands, *[t.clone() for t in state0])  # warm
    walls, steps = [], 0
    for _ in range(11):
        run = [t.clone() for t in state0]
        torch.cuda.synchronize()
        started = time.perf_counter()
        out = fn(*operands, *run)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - started)
        steps = out[-1]
    run = [t.clone() for t in state0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*operands, *run)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = 1e3 * statistics.median(walls)
    return {"C": C, "V": V, "B": B, "hot_c": hot_c, "period": period,
            "budget": budget, "steps": steps, "wall_ms": wall_ms,
            "walls_ms": [1e3 * w for w in walls],
            "host_us_a_step": 1e3 * wall_ms / steps,
            "device_ops": sum(e.count for e in events),
            "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms}


def window_graph_case(smoke, C, V, B, hot_c, period):
    """A round's first 16-step window by plain launches and as one CUDA
    graph replayed, from the same start state each time: medians of the
    host wall (ms) of each and the capture's seconds."""
    import torch

    from mythril_tpu_torch.ops import dense_prop
    from mythril_tpu_torch.ops.dense_sweep import dense_sweep
    from mythril_tpu_torch.ops.dpll_step import dpll_step

    operands, state0 = smoke.planted_round_inputs(C, V, B)
    state = [t.clone() for t in state0]
    out = dense_prop._sweep_workspace(B, V, True, state[0].device)
    flags = torch.zeros(2, dtype=torch.int32, device=state[0].device)
    window = dense_prop.SYNC_EVERY

    def run_window():
        for step in range(window):
            full_view = period == 1 or step % period == 0
            outs = dense_sweep(*operands, state[0], True,
                               rows=None if full_view else hot_c, out=out)
            dpll_step(state, outs, flags, step, full_view, not full_view,
                      True)

    def restore():
        for dst, src in zip(state, state0):
            dst.copy_(src)
        flags.zero_()
        torch.cuda.synchronize()

    def timed(run):
        walls = []
        for _ in range(11):
            restore()
            started = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - started))
        return statistics.median(walls)

    restore()
    run_window()  # warm: builds, and sets the kernels' attributes
    plain_ms = timed(run_window)
    captures = []
    for _ in range(5):
        restore()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        started = time.perf_counter()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            run_window()
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        captures.append(1e3 * (time.perf_counter() - started))
    graph_ms = timed(graph.replay)
    return {"C": C, "V": V, "B": B, "hot_c": hot_c, "period": period,
            "window": window, "plain_ms": plain_ms, "graph_ms": graph_ms,
            "capture_ms": captures}


def worker(tree, label, iters):
    """One tree's measurements (its package first on the path)."""
    sys.path.insert(0, tree)
    smoke = tree_smoke()
    import torch

    import mythril_tpu_torch
    from mythril_tpu_torch.ops import dense_prop
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import dpll_step as DSTEP

    if os.path.dirname(os.path.dirname(mythril_tpu_torch.__file__)) != tree:
        raise SystemExit(f"imported {mythril_tpu_torch.__file__}, not {tree}")
    ds.load_library()
    DSTEP.load_library()
    if DSTEP.build_info:
        emit({"tree": label, "build": " | ".join(
            line.strip() for line in DSTEP.build_info[1].splitlines()
            if "registers" in line or "spill" in line)})
    for B, V, D in STEP_SHAPES:
        ms, bound = step_case(smoke, lambda *w: DSTEP.dpll_step(
            *w, 9, True, False, True), B, V, D, iters)
        emit({"tree": label, "step": [B, V, D], "ms": ms, "bound_ms": bound,
              "share": bound / ms})
    for C, V, B, hot_c, period, budget in ROUNDS:
        emit({"tree": label, "round": round_case(
            smoke, C, V, B, hot_c, period, budget)})
    for C, V, B, hot_c, period, budget in ROUNDS:
        if budget == 64 or hot_c:
            emit({"tree": label, "window graph": window_graph_case(
                smoke, C, V, B, hot_c, period)})


def variants(iters):
    """This tree's kernel under each of ``VARIANTS``, bound with this
    tree's wrapper."""
    sys.path.insert(0, ROOT)
    smoke = load_smoke()
    import torch

    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import dpll_step as DSTEP

    source = open(DSTEP.SOURCE).read()
    build = os.path.join(ds.BUILD_DIR, "variants")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(build, name.replace(" ", "_") + ".cu")
        with open(src, "w") as f:
            f.write(edited(source, edits))
        lib = src[:-3] + ".so"
        procs[name] = (lib, subprocess.Popen(
            [ds._nvcc(), *ds.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed:\n{out}")
        emit({"variant": name, "build": " | ".join(
            line.strip() for line in out.splitlines()
            if "registers" in line or "spill" in line)})
        bound = DSTEP.bind(lib)
        for B, V, D in STEP_SHAPES:
            def launch(*w, lib=bound):
                args = DSTEP.step_args(*w, 9, True, False, True)
                err = lib.dpll_step_launch(
                    *args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            ms, b = step_case(smoke, launch, B, V, D, iters)
            emit({"variant": name, "step": [B, V, D], "ms": ms,
                  "bound_ms": b, "share": b / ms,
                  "cluster": bound.dpll_step_cluster_size(B, V)})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another tree of this repository")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--label", help=argparse.SUPPRESS)
    parser.add_argument("--variants", action="store_true",
                        help=argparse.SUPPRESS)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dpll_step_times: no CUDA device", file=sys.stderr)
        return 2
    if opts.worker:
        worker(os.path.abspath(opts.worker), opts.label, opts.iters)
        return 0
    if opts.variants:
        variants(opts.iters)
        return 0
    smoke = load_smoke()
    print(smoke.card_line(), flush=True)
    trees = [("this tree", ROOT)]
    if opts.parent:
        parent = ("parent", os.path.abspath(opts.parent))
        trees = [parent, trees[0], trees[0], parent]
    runs = [[sys.executable, __file__, "--worker", tree, "--label", label,
             "--iters", str(opts.iters)] for label, tree in trees]
    runs.append([sys.executable, __file__, "--variants", "--iters",
                 str(opts.iters)])
    for argv in runs:
        done = subprocess.run(argv, cwd=ROOT)
        if done.returncode:
            return done.returncode
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
