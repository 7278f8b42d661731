#!/usr/bin/env python3
"""Device times of the dense tier's clause sweep (``ops/csrc/dense_sweep.cu``)
against another tree's, at the check's and the main path's shapes, and
what a 64-step dense round costs with each.

Run on the card from the repository root::

    python3 chip_tools/dense_sweep_times.py [--parent DIR] [--iters N]

Each tree is measured in a process of its own (the tree's package first
on the path; inputs, bounds and timing code are this tree's
``chip_smoke.py``), in turns: parent, this tree, this tree, parent.  A
tree's process builds its ``dense_sweep.cu`` as its wrapper loads it and
hands it the clause pool in the form the tree's union pool holds
(``chip_smoke.sweep_operands``' clause rows, or for a tree from before
the rows ``dpll_step_times.planes_operands``' dense bf16 planes), then:

- the sweep at the check's C, V, B = 16,384, 4,096, 64 and at the main
  path's 32,768, 4,096, 16 (``chip_smoke.sweep_coords``' CNF rows of
  1-12 literals), scores on and off and a 2,048-row hot prefix: held
  bit for bit against ``sweep_plain`` over the planes of the same
  coordinates first, then its device ms (the profiler, the mean of
  ``--iters`` launches) beside the bound of the data
  (``chip_smoke.sweep_bound``: the rows, A and the outputs moved once,
  the same for both designs) and the share;
- a 64-step round of ``make_dense_rounds`` at the main path's shape on
  ``chip_smoke.planted_round_inputs``' CNF, untiered
  (``chip_tools/dpll_step_times.round_case``: the round's host wall, the
  median of 11, its device operations, busy time and idle share).

This tree's process also builds the kept kernel's design variants, each
the source under named edits (``VARIANTS``: the grid row after row with
all B lanes of a row in one block, the first design over the rows),
binds each with this
tree's ``dense_sweep.bind`` and times the scores-on full sweep at both
shapes, held bit for bit against ``sweep_plain`` first.

Prints the card line first and last, one JSON line per measurement;
exits non-zero without a card or when a launch differs.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (C, V, B) of the timed sweeps: the check's, the main path's
SHAPES = ((16384, 4096, 64), (32768, 4096, 16))
#: (scores, hot rows) of each timed sweep
CASES = ((True, None), (False, None), (True, 2048))
#: (C, V, B, hot rows, period, budget) of the timed round
ROUND = (32768, 4096, 16, 0, 1, 64)

# Design variants of the kept kernel, each a list of (old, new) source
# edits, each old text found exactly once.
VARIANTS = {
    # every lane of a row in one block, the rows in order (at B = 64 four
    # rows a block): the gathers of the blocks on the card spread over
    # the whole of A
    "row-major grid": [
        ("DS_HD int lane_group(int B) { return B % kLaneGroup == 0 ? "
         "kLaneGroup : B; }", "DS_HD int lane_group(int B) { return B; }"),
    ],
}


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def emit(record):
    print(json.dumps(record), flush=True)


def sweep_case(smoke, C, V, B, scores, hot, iters, launch=None):
    """(device ms, bound ms) of the tree's sweep at (C, V, B), held
    against ``sweep_plain`` first; ``launch(operands, A, scores, hot)``
    stands in for the tree's ``dense_sweep``."""
    import numpy as np
    import torch

    from mythril_tpu_torch.ops import dense_sweep as ds

    row, col, negative, width = smoke.sweep_coords(C, V)
    operands = smoke.sweep_operands(row, col, negative, width, V)
    rng = np.random.default_rng(1)
    A = rng.choice([-1.0, 0.0, 1.0], size=(B, V)).astype(np.float32)
    A[:, 0] = 0.0
    A[:, 1] = 1.0
    A = torch.from_numpy(A).to("cuda")
    dev = A.device
    planes = []
    for sel in (~negative, negative):
        plane = torch.zeros((C, V), dtype=torch.bfloat16, device=dev)
        plane[torch.from_numpy(row[sel]).to(dev),
              torch.from_numpy(col[sel]).to(dev)] = 1
        planes.append(plane)
    width_t = torch.from_numpy(width).to(dev)
    if launch is None:
        def launch(operands, A, scores, hot):
            return ds.dense_sweep(*operands, A, scores, hot)
    got = launch(operands, A, scores, hot)
    torch.cuda.synchronize()
    want = ds.sweep_plain(*planes, width_t, A, scores, hot)
    for g, w in zip(got, want):
        smoke.check(torch.equal(g, w), f"sweep C={C} B={B} scores={scores} "
                    f"rows={hot}: the kernel differs from sweep_plain")
    R = C if hot is None else hot
    cells = int(np.count_nonzero(row < R))
    adds = int(sum(float(t.sum()) for t in got[:2] + got[3:]))
    bound_ms = smoke.sweep_bound(R, V, B, cells, 4 if scores else 2,
                                 adds)[0]
    ms = smoke.kernel_device_ms(lambda: launch(operands, A, scores, hot),
                                iters)
    return ms, bound_ms


def worker(tree, label, iters):
    """One tree's measurements (its package first on the path)."""
    sys.path.insert(0, tree)
    rounds = load("dpll_step_times",
                  os.path.join(ROOT, "chip_tools", "dpll_step_times.py"))
    smoke = rounds.tree_smoke()
    import mythril_tpu_torch
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import dpll_step as DSTEP

    if os.path.dirname(os.path.dirname(mythril_tpu_torch.__file__)) != tree:
        raise SystemExit(f"imported {mythril_tpu_torch.__file__}, not {tree}")
    ds.load_library()
    DSTEP.load_library()
    if ds.build_info:
        emit({"tree": label, "build": " | ".join(
            line.strip() for line in ds.build_info[1].splitlines()
            if "registers" in line or "spill" in line)})
    design = "rows" if hasattr(ds, "SweepRows") else "planes"
    for C, V, B in SHAPES:
        for scores, hot in CASES:
            ms, bound_ms = sweep_case(smoke, C, V, B, scores, hot, iters)
            emit({"tree": label, "design": design, "sweep": [C, V, B],
                  "scores": scores, "rows": hot or C, "ms": ms,
                  "bound_ms": bound_ms, "share": bound_ms / ms})
    emit({"tree": label, "design": design,
          "round": rounds.round_case(smoke, *ROUND)})


def edited(source, edits):
    for old, new in edits:
        if source.count(old) != 1:
            raise SystemExit(f"variant edit not found once: {old!r}")
        source = source.replace(old, new)
    return source


def variants(iters):
    """This tree's kernel under each of ``VARIANTS``, bound with this
    tree's ``dense_sweep.bind``."""
    sys.path.insert(0, ROOT)
    smoke = load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    import torch

    from mythril_tpu_torch.ops import dense_sweep as ds

    source = open(ds.SOURCE).read()
    build = os.path.join(ds.BUILD_DIR, "variants")
    os.makedirs(build, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = os.path.join(build, "sweep_" + name.replace(" ", "_") + ".cu")
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
        bound = ds.bind(lib)

        def launch(operands, A, scores, hot, lib=bound):
            B, V = A.shape
            outs = [torch.zeros((B, V), device=A.device)
                    for _ in range(4 if scores else 2)]
            conf = torch.zeros((B, 1), device=A.device)
            spos, sneg = (outs[2].data_ptr(), outs[3].data_ptr()) \
                if scores else (None, None)
            err = lib.dense_sweep_launch(
                *(t.data_ptr() for t in (*operands, A)), B, V,
                hot or operands.width.shape[1], outs[0].data_ptr(),
                outs[1].data_ptr(), conf.data_ptr(), spos, sneg,
                int(scores), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
            return (outs[0], outs[1], conf, *outs[2:])

        for C, V, B in SHAPES:
            ms, bound_ms = sweep_case(smoke, C, V, B, True, None, iters,
                                      launch)
            emit({"variant": name, "sweep": [C, V, B], "scores": True,
                  "rows": C, "ms": ms, "bound_ms": bound_ms,
                  "share": bound_ms / ms})


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
        print("dense_sweep_times: no CUDA device", file=sys.stderr)
        return 2
    if opts.worker:
        worker(os.path.abspath(opts.worker), opts.label, opts.iters)
        return 0
    if opts.variants:
        variants(opts.iters)
        return 0
    smoke = load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
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
