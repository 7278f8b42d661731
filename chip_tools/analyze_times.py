#!/usr/bin/env python3
"""Walls of ``contracts.CHIP_RUNS`` analyses on the card in the default
rungs and CDCL-only, in turns, for comparing the two and the port of two
trees of this repository on one card.

Run on the card, by path, with the root of the tree whose package is to
be timed (default: this file's tree); the timing code is this file's
tree's (``chip_smoke.analyze_audited``, ``alternated_walls`` and
``analyze_once``)::

    python3 chip_tools/analyze_times.py [--tree DIR] [--run NAME ...] \\
        [--repeat 1]

For each run (default: ``scale_mul d6 g16 -t 1`` and ``scale_mul d4 g16
-t 2``): one audited analysis in the JAX default configuration of the
rungs (it warms the process and logs its counters, checks the SWC set
and that no prefetch was dropped), then ``--repeat`` rounds of default
rungs, CDCL only, CDCL only, default rungs without audits, each wall
printed with its states, ``segments_declined`` and native CDCL seconds,
and the card's name and power limit.  Prints the card line and UUID
first.  To compare two trees, alternate processes in one call (parent,
change, change, parent).
"""

import argparse
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--run", action="append",
                        help="a CHIP_RUNS name (repeatable)")
    parser.add_argument("--repeat", type=int, default=1,
                        help="rounds of default, CDCL only, CDCL only, "
                        "default")
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

    card = smoke.card_line()
    print(card, flush=True)
    print(f"card uuid: {smoke.card_uuid()}", flush=True)
    for line in smoke.build_all():
        print(line, flush=True)
    for name in opts.run or ["scale_mul d6 g16 -t 1",
                             "scale_mul d4 g16 -t 2"]:
        run = next(r for r in CHIP_RUNS if r.name == name)
        smoke.analyze_audited(run, card, force=False)
        for _ in range(opts.repeat):
            smoke.alternated_walls(run, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
