#!/usr/bin/env python3
"""Walls of the default-rungs ``scale_mul d6 -t 1`` and ``d4 -t 2``
analyses on the card with one tree's package, for measuring what the
resilience plane's supervision costs against a tree without it.

Run on the card, by path, with the root of the tree whose package is to
be timed (default: this file's tree); the timing code is this file's
tree's (``chip_smoke.analyze_once``, no audits)::

    python3 chip_tools/supervision_times.py [--tree DIR] [--repeat 2]

Each run is timed ``--repeat`` times in the JAX default configuration of
the dispatch rungs, then once force-dispatched.  Where the tree has the
dispatch watchdog, each line also gives the supervised dispatch attempts
and the host seconds of their worker threads' start and join
(``DispatchWatchdog.runs`` / ``thread_s``), and fails unless the run,
under the watchdog's real deadlines, tripped, retried and demoted
nothing (``chip_smoke.ladder_quiet``).  Prints the card line and UUID first.  To compare two trees, alternate
processes in one call (parent, change, change, parent).
"""

import argparse
import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = ("scale_mul d6 g16 -t 1", "scale_mul d4 g16 -t 2")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--repeat", type=int, default=2)
    opts = parser.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("supervision_times: no CUDA device", file=sys.stderr)
        return 2
    import mythril_tpu_torch

    if os.path.dirname(os.path.dirname(mythril_tpu_torch.__file__)) != tree:
        print(f"supervision_times: imported {mythril_tpu_torch.__file__}, "
              f"not the tree {tree}", file=sys.stderr)
        return 2
    from mythril_tpu_torch.contracts import CHIP_RUNS

    card = smoke.card_line()
    print(card, flush=True)
    print(f"card uuid: {smoke.card_uuid()}", flush=True)
    for line in smoke.build_all():
        print(line, flush=True)
    for name in RUNS:
        run = next(r for r in CHIP_RUNS if r.name == name)
        for force in [False] * opts.repeat + [True]:
            before = smoke.supervision()
            report, analyzer, wall = smoke.analyze_once(run, force=force)
            runs, thread_s = (b - a for a, b in
                              zip(before, smoke.supervision()))
            found = {issue.swc_id for issue in report.issues.values()}
            smoke.check(not report.exceptions and found == run.swc_ids,
                        f"{name}: SWC {sorted(found)}")
            quiet = smoke.ladder_quiet(name, force)
            print(f"supervision {name} "
                  f"{'force-dispatched' if force else 'default rungs'} "
                  f"[{card}] tree {tree}: wall {wall:.3f} s, "
                  f"{analyzer.last_sym.laser.total_states} states, "
                  f"{runs} supervised dispatch attempts, worker threads' "
                  f"start and join {thread_s * 1e3:.3f} ms, {quiet}, SWC "
                  f"{sorted(found)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
