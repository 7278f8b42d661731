#!/usr/bin/env python3
"""Device times of the frontier kernels ``scan_rows`` (a full and a
gather view), ``lane_step`` (a learning launch: two or more lanes in
conflict under decisions; a quiet one: no lane in conflict) and
``round_epilogue`` (an iteration that appends learned rows and cascades)
on ``frontiers.learning_problem``, for comparing the kernels of two
trees of this repository on one card.

Run on the card, by path, with the root of the tree whose kernels are to
be timed (default: this file's tree); the timing code, inputs and bounds
are this file's tree's (``chip_smoke.py``)::

    python3 chip_tools/frontier_times.py [--tree DIR] \\
        [--shape C,V1,B ...]

Each shape runs the resident loop on the learning problem (shared pool
of 64 rows, 40 prefilled) with the tree's kernels until every case was
timed; each timed launch is first held against its plain version.
Prints the card line and the card's UUID, then one JSON line per timed
launch: device ms (profiler), plain ms (eager torch on the card), bound
ms and a digest of the launch's inputs; two trees timed the same launch
when their digests agree.  Exits non-zero without a card or when a case
is missing.
"""

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the learning problem's shapes of the chip check (full pool and widest
#: cone bucket), the guard chain's delegated frontier and the commonest
#: shape of scale_mul d6 -t 1
SHAPES = ("16384,8193,64", "16384,16385,64", "16384,2049,64",
          "16384,4097,8")
E, PREFILL, MAX_ITERS = 64, 40, 64


def time_shape(smoke, C, V1, B):
    """JSON records of the first launch of each case on the learning
    problem at this shape, and the cases not reached.  An epilogue with
    learned rows and a cascade stands in for itself; where the loop has
    none, the first epilogue with learned rows or a cascade is timed."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    loop = smoke.learning_loop(C, V1, B, E, PREFILL)
    dev = loop.ctl.device
    todo = {("scan_rows", "full"), ("scan_rows", "gather"),
            ("lane_step", "quiet"), ("lane_step", "learning"),
            ("round_epilogue", "learned rows and a cascade")}
    out = []
    fallback = None

    def timed(name, case, it, parity, full, snap):
        smoke.run_checked(name, loop, parity, getattr(FK, name))
        entry = smoke.time_frontier_kernel(name, case, loop, snap, parity,
                                           full)
        out.append({"C": C, "V1": V1, "B": B, "kernel": name, "case": case,
                    "iteration": it, "ms": entry["ms"],
                    "plain_ms": entry["plain_ms"],
                    "bound_ms": entry["bound_ms"],
                    "bound_by": entry["bound_by"],
                    "digest": smoke.digest(snap)})

    for it in range(MAX_ITERS):
        parity = it & 1
        if int(loop.ctl[parity, FK.HALT]) or not todo:
            break
        full = bool(int(loop.ctl[parity, FK.FULL]))
        for name in ("scan_rows", "lane_step", "round_epilogue"):
            wrapper = getattr(FK, name)
            if name == "scan_rows":
                case = "full" if full else "gather"
            elif name == "lane_step":
                conflicts = int(((loop.buf["conflict"] != 0)
                                 & (loop.lane["status"] == 0)).sum())
                case = ("learning" if int(smoke.in_conflict(loop).sum()) >= 2
                        else "quiet" if conflicts == 0 else None)
            else:
                learned = bool((loop.buf["okl"] != 0).any())
                cascade = bool(((loop.buf["flags"] & FK.FLAG_CASCADE)
                                != 0).any())
                case = ("learned rows and a cascade" if learned and cascade
                        else "learned rows" if learned
                        else "a cascade" if cascade else None)
                if case and fallback is None and name == "round_epilogue":
                    fallback = (case, it, parity, full, loop.to(dev))
            if (name, case) not in todo:
                wrapper(loop, parity)
                continue
            todo.discard((name, case))
            timed(name, case, it, parity, full, loop.to(dev))
    epilogue = ("round_epilogue", "learned rows and a cascade")
    if epilogue in todo and fallback is not None:
        case, it, parity, full, snap = fallback
        smoke._restore(loop, snap)
        todo.discard(epilogue)
        timed("round_epilogue", case, it, parity, full, snap)
    return out, todo


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--shape", action="append",
                        help="C,V1,B (repeatable; default: %s)"
                        % " ".join(SHAPES))
    opts = parser.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("frontier_times: no CUDA device", file=sys.stderr)
        return 2
    import mythril_tpu_torch

    if os.path.dirname(os.path.dirname(mythril_tpu_torch.__file__)) != tree:
        print(f"frontier_times: imported {mythril_tpu_torch.__file__}, "
              f"not the tree {tree}", file=sys.stderr)
        return 2
    print(smoke.card_line(), flush=True)
    print(f"card uuid: {smoke.card_uuid()}", flush=True)
    missing = []
    for shape in opts.shape or SHAPES:
        C, V1, B = (int(x) for x in shape.split(","))
        records, todo = time_shape(smoke, C, V1, B)
        for record in records:
            print(json.dumps({"tree": tree, **record}), flush=True)
        missing += [(shape, case) for case in sorted(todo)]
    if missing:
        print(f"frontier_times: cases not reached: {missing}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
