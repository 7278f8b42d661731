#!/usr/bin/env python3
"""Walls of one ``contracts.CHIP_RUNS`` analysis on the card, for
comparing the port of two trees of this repository on one card.

Run on the card, by path, with the root of the tree whose package is to
be timed (default: this file's tree); the timing code is this file's
tree's (``chip_smoke.analyze_audited`` and ``analyze_once``)::

    python3 chip_tools/analyze_times.py [--tree DIR] [--run NAME] \\
        [--repeat 3]

Runs the analysis ``--repeat`` times in the JAX default configuration of
the dispatch rungs (each run logs its wall without the audits' time, its
counters and the rungs' prefetch counts, and checks the SWC set and that
no prefetch was dropped), then once CDCL-only.  Prints the card line and
UUID first.  The first run of a process pays for warming it; to compare
two trees, alternate processes in one call (parent, change, change,
parent).
"""

import argparse
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--run", default="scale_mul d6 g16 -t 1",
                        help="a CHIP_RUNS name")
    parser.add_argument("--repeat", type=int, default=3)
    opts = parser.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("analyze_times: no CUDA device", file=sys.stderr)
        return 2
    import mythril_tpu_torch

    if os.path.dirname(os.path.dirname(mythril_tpu_torch.__file__)) != tree:
        print(f"analyze_times: imported {mythril_tpu_torch.__file__}, "
              f"not the tree {tree}", file=sys.stderr)
        return 2
    from mythril_tpu_torch.contracts import CHIP_RUNS
    from mythril_tpu_torch.smt import SolverStatistics

    card = smoke.card_line()
    print(card, flush=True)
    print(f"card uuid: {smoke.card_uuid()}", flush=True)
    for line in smoke.build_all():
        print(line, flush=True)
    run = next(r for r in CHIP_RUNS if r.name == opts.run)
    for _ in range(opts.repeat):
        smoke.analyze_audited(run, card, force=False)
    _, _, wall = smoke.analyze_once(run, batched_solving=False)
    print(f"analyze {run.name} CDCL only [{card}]: wall {wall:.3f} s, "
          f"native CDCL {SolverStatistics().native_s:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
