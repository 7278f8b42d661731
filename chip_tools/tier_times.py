#!/usr/bin/env python3
"""Where an analysis's device seconds go, by solver tier, for the port of
two trees of this repository on one card.

Run on the card from the repository root::

    python3 chip_tools/tier_times.py [--parent DIR]

Each tree runs in a process of its own (the tree's package first on the
path; the analysis code is this tree's ``chip_smoke.analyze_once``, no
audits), in turns: parent, this tree, this tree, parent.  A process runs
``contracts.CHIP_RUNS``' scale_mul d4 g16 -t 2 force-dispatched, then
the ``MYTHRIL_TPU_RESIDENT_KERNEL=0`` yardstick (``YARDSTICK_RUN``),
and times each tier at the same boundaries in every tree, by wrapping
them from here:

- dense: ``DenseSatBackend.check_assumption_sets`` (cone walk, pool
  build, rounds; a delegation's cone walk too);
- of it the rounds: ``dense_prop._run_dense_ladder``, and the cone
  walks: ``ConeMemo.cone`` called inside the dense tier;
- gather and cone: ``BatchedSatBackend.check_assumption_sets`` less the
  dense tier inside it (pool syncs, cone builds, their solves);
- of them resident: ``BatchedSatBackend._solve_resident``;
- word: the funnel's word rung (``batched_sat._word_rung``).

Per run it prints the wall, states, SWC set (checked against the run's),
``device_s``, the tiers' seconds, the dense rounds and steps, and, where
the tree counts them itself (``dispatch_stats.dense_s`` and the others),
the package's own counters.  Prints the card line first and last.
"""

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = "scale_mul d4 g16 -t 2"
TIERS = ("dense", "dense_rounds", "dense_cones", "gather", "resident",
         "word")


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def install_clocks(seconds):
    """Wrap the tiers' entry points of the imported package; their
    wall-clock adds into ``seconds`` by tier."""
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.ops import dense_prop
    from mythril_tpu_torch.ops.incremental import ConeMemo

    inside = {"dense": 0.0, "in_dense": 0}

    def clocked(fn, tier, only_in_dense=False):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if only_in_dense and not inside["in_dense"]:
                return fn(*args, **kwargs)
            started = time.perf_counter()
            inside["in_dense"] += tier == "dense"
            try:
                return fn(*args, **kwargs)
            finally:
                elapsed = time.perf_counter() - started
                seconds[tier] += elapsed
                if tier == "dense":
                    inside["dense"] += elapsed
                    inside["in_dense"] -= 1
        return run

    def tiers(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            started = time.perf_counter()
            dense_before = inside["dense"]
            try:
                return fn(*args, **kwargs)
            finally:
                seconds["gather"] += (time.perf_counter() - started
                                      - (inside["dense"] - dense_before))
        return run

    backend = dense_prop.DenseSatBackend
    backend.check_assumption_sets = clocked(backend.check_assumption_sets,
                                            "dense")
    batched = bs.BatchedSatBackend
    batched.check_assumption_sets = tiers(batched.check_assumption_sets)
    batched._solve_resident = clocked(batched._solve_resident, "resident")
    bs._word_rung = clocked(bs._word_rung, "word")
    dense_prop._run_dense_ladder = clocked(dense_prop._run_dense_ladder,
                                           "dense_rounds")
    ConeMemo.cone = clocked(ConeMemo.cone, "dense_cones", only_in_dense=True)


def worker(tree, label):
    sys.path.insert(0, tree)
    smoke = load_smoke()
    import mythril_tpu_torch

    if os.path.dirname(os.path.dirname(mythril_tpu_torch.__file__)) != tree:
        raise SystemExit(f"imported {mythril_tpu_torch.__file__}, not {tree}")
    from mythril_tpu_torch.contracts import CHIP_RUNS, YARDSTICK_RUN
    from mythril_tpu_torch.ops import batched_sat as bs

    smoke.build_all()
    seconds = dict.fromkeys(TIERS, 0.0)
    install_clocks(seconds)
    runs = [(next(r for r in CHIP_RUNS if r.name == RUN), {}),
            (YARDSTICK_RUN, {"MYTHRIL_TPU_RESIDENT_KERNEL": "0"})]
    for run, knobs in runs:
        for tier in TIERS:
            seconds[tier] = 0.0
        with smoke.env(**knobs):
            report, analyzer, wall = smoke.analyze_once(run, force=True)
        stats = bs.dispatch_stats
        found = {issue.swc_id for issue in report.issues.values()}
        smoke.check(not report.exceptions and found == run.swc_ids,
                    f"{label} {run.name}: SWC {sorted(found)}")
        own = {tier: getattr(stats, f"{tier}_s") for tier in TIERS
               if hasattr(stats, f"{tier}_s")}
        print(json.dumps({
            "tree": label, "run": run.name, "knobs": knobs, "wall_s": wall,
            "states": analyzer.last_sym.laser.total_states,
            "swc": sorted(found), "device_s": stats.device_s,
            "tiers_s": dict(seconds), "package_tiers_s": own or None,
            "rounds": stats.rounds, "dense_steps": stats.device_sweeps,
            "dense_round_budgets": dict(sorted(
                stats.dense_round_budgets.items())),
            "resident_solves": stats.resident_dispatches,
        }), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another tree of this repository")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--label", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tier_times: no CUDA device", file=sys.stderr)
        return 2
    if opts.worker:
        worker(os.path.abspath(opts.worker), opts.label)
        return 0
    smoke = load_smoke()
    print(smoke.card_line(), flush=True)
    trees = [("this tree", ROOT)]
    if opts.parent:
        parent = ("parent", os.path.abspath(opts.parent))
        trees = [parent, trees[0], trees[0], parent]
    for label, tree in trees:
        done = subprocess.run([sys.executable, __file__, "--worker", tree,
                               "--label", label], cwd=ROOT)
        if done.returncode:
            return done.returncode
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
