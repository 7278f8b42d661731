#!/usr/bin/env python3
"""Device times of variants of the ``lane_step`` kernel, for the design
record in PERF.md: each variant is the tree's ``ops/csrc/frontier.cu``
with named edits, built with the same ``nvcc`` flags into
``_build/variants/`` (``scan_variants.build``).  The edits of a variant
must each apply to the source exactly once, else the script stops.

Variants come in groups, one for each design of the kernel (one block
per lane; a cluster of blocks per lane); the script takes the group
whose edits apply to the tree's source.  In each group, "as built" is
held against the plain version before it is timed, and so are the
cluster group's other cluster sizes; every other variant leaves out one
part of the kernel (its outputs are then wrong, and only its time is
read).  The cluster group also times the fusion that the scan's
write-out could take over: the scan with a per-lane reduction of the
forcing and open flags and the DLIS key added to its write-out, beside
the lane step without its pass over the lane (both wrong, only timed).
Run on the card, by path::

    python3 chip_tools/lane_variants.py [--tree DIR] [--shape C,V1,B ...]
    python3 chip_tools/lane_variants.py --main-path [--per-shape 8]

The first form runs ``frontiers.learning_problem`` (E = 64, 40 rows
prefilled) at each shape and times every variant on two launches: the
first on which two or more lanes are in conflict under decisions (they
learn), and iteration 0, where no lane is in conflict (every lane
decides).  ``--main-path`` runs the guard-chain frontier and the
scale_mul analyses of ``contracts.CHIP_RUNS`` (d6 -t 1, d4 -t 2) on the
built kernel, keeps the inputs of up to ``--per-shape`` lane-step
launches with a lane in conflict under decisions and as many without,
drawn evenly from all of a shape's launches, and times every variant on
them.  Prints the card line and UUID, then one JSON line per variant
and launch, and per shape the sums.
"""

import argparse
import importlib.util
import json
import os
import sys

from scan_variants import build, use  # this directory's scan variants

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the learning problem's shapes: the chip check's, the widest cone
#: bucket, the guard chain's and the commonest of scale_mul d6 -t 1
SHAPES = ("16384,8193,64", "16384,16385,64", "16384,2049,64",
          "16384,4097,8")
E, PREFILL, MAX_ITERS = 64, 40, 64

#: the scan with the lane step's flags and DLIS key reduced in its
#: write-out, into the lane's ``litrow`` (wrong outputs, time only)
SCAN_REDUCES_LANE = [(
    "  const size_t g0 = off + v0;\n"
    "  const int head = min(nown, (int)((4 - (g0 & 3)) & 3));\n",
    "  {\n"
    "    unsigned long long best = 0;\n"
    "    int hf = 0, oa = 0;\n"
    "    for (int i = tid; i < nown; i += kThreads) {\n"
    "      const int v = v0 + i;\n"
    "      const bool fr = sA[v] == 0 && v > 1;\n"
    "      const bool fo = fr && (rp[i] > 0 || rn[i] > 0);\n"
    "      hf |= fo;\n"
    "      oa |= fr;\n"
    "      const int score = (fr && !fo) ? sp[i] + sn[i] + 1 : -1;\n"
    "      const unsigned long long key = arg_key(score + 1, v);\n"
    "      best = key > best ? key : best;\n"
    "    }\n"
    "    best = warp_max_u64(best);\n"
    "    hf = __syncthreads_or(hf);\n"
    "    oa = __syncthreads_or(oa);\n"
    "    if ((tid & 31) == 0)\n"
    "      atomicMax(reinterpret_cast<unsigned long long*>(\n"
    "                    a.litrow + (size_t)b * kK), best);\n"
    "    if (tid == 0)\n"
    "      atomicOr(a.litrow + (size_t)b * kK + 2, hf | (oa << 1));\n"
    "  }\n"
    "  const size_t g0 = off + v0;\n"
    "  const int head = min(nown, (int)((4 - (g0 & 3)) & 3));\n")]

#: group -> variant -> [(text of the source, replacement)]
GROUPS = {
    "one block per lane": {
        "as built": [],
        "no pass 1": [(
            "  for (int v = tid; v < V1; v += kThreads) {\n"
            "    const bool free = A[v] == 0 && v > 1;",
            "  for (int v = tid; v < 0; v += kThreads) {\n"
            "    const bool free = A[v] == 0 && v > 1;")],
        "no walk": [(
            "  if (do_learn) {\n    for (int v = tid; v < V1; v += kThreads)",
            "  if (false) {\n    for (int v = tid; v < V1; v += kThreads)")],
        "no backtrack or force writes": [
            ("  if (do_bt) {\n    const int bvar = s_bvar",
             "  if (false) {\n    const int bvar = s_bvar"),
            ("  } else if (do_force) {", "  } else if (false) {")],
    },
    "cluster per lane": {
        "as built": [],
        "no pass": [("  if (tid >= t0 && (!do_bt || full))\n",
                     "  if (false)\n")],
        "no walk": [("  if (walking && tid < 32)\n    ok = uip_walk(",
                     "  if (false)\n    ok = uip_walk(")],
        "no backtrack or force writes": [
            ("    for_slice(s, V1, tid, kThreads, [&](auto n, int v) {\n"
             "      lane_backtrack",
             "    if (false) for_slice(s, V1, tid, kThreads, "
             "[&](auto n, int v) {\n      lane_backtrack"),
            ("  if (!any_forced) return;", "  if (true) return;")],
        "one block per lane": [(
            "  while (S < kMaxLaneCluster && a.B * S < kClusterBlocks) "
            "S *= 2;",
            "  while (false) S *= 2;")],
        "clusters of up to 16 (non-portable)": [
            ("constexpr int kMaxLaneCluster = kMaxCluster;",
             "constexpr int kMaxLaneCluster = 16;"),
            ("  return cluster_launch(lane_step_kernel, lane_cluster(*a),",
             "  cudaFuncSetAttribute(lane_step_kernel,\n"
             "      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
             "  return cluster_launch(lane_step_kernel, lane_cluster(*a),")],
        "scan reduces the lane flags": SCAN_REDUCES_LANE,
    },
}
#: variants whose outputs are right, held against the plain version
HELD = ("as built", "one block per lane",
        "clusters of up to 16 (non-portable)")


def choose_group(source):
    """The group whose every edit applies to ``source`` exactly once."""
    for group, variants in GROUPS.items():
        if all(source.count(old) == 1 for edits in variants.values()
               for old, _ in edits):
            return group
    raise RuntimeError("no variant group applies to this frontier.cu")


def time_launch(smoke, name, loop, snap, parity, checked):
    """Device ms of kernel ``name`` launched from ``snap`` on ``loop``
    with the library in use; held against the plain version first if
    ``checked``."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    loop.args = None
    smoke._restore(loop, snap)
    if checked:
        smoke.run_checked(name, loop, parity, getattr(FK, name))

    def launch():
        smoke._restore(loop, snap)
        getattr(FK, name)(loop, parity)

    return smoke.kernel_device_ms(launch, 20, f"{name}_kernel")


def learning_launches(smoke, C, V1, B):
    """Snapshots before the scan and before the lane step of iteration
    0 (quiet) and of the first iteration with 2+ lanes in conflict under
    decisions (learning), with their parity."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    loop = smoke.learning_loop(C, V1, B, E, PREFILL)
    dev = loop.ctl.device
    picked = {}
    for it in range(MAX_ITERS):
        parity = it & 1
        if int(loop.ctl[parity, FK.HALT]) or len(picked) == 2:
            break
        before_scan = loop.to(dev)
        FK.scan_rows(loop, parity)
        case = ("learning" if int(smoke.in_conflict(loop).sum()) >= 2
                else "quiet" if it == 0 else None)
        if case and case not in picked:
            picked[case] = (before_scan, loop.to(dev), parity, it)
        FK.lane_step(loop, parity)
        FK.round_epilogue(loop, parity)
    if len(picked) != 2:
        raise RuntimeError(f"learning problem {C},{V1},{B}: launches "
                           f"{sorted(picked)} only")
    return loop, picked


def learning_problem_variants(smoke, group, libs, shapes):
    fused = "scan reduces the lane flags" in libs
    for shape in shapes:
        C, V1, B = (int(x) for x in shape.split(","))
        use(libs["as built"])
        loop, picked = learning_launches(smoke, C, V1, B)
        for name, path in libs.items():
            use(path)
            checked = name in HELD
            for case, (scan_snap, lane_snap, parity, it) in sorted(
                picked.items()
            ):
                record = {"group": group, "variant": name, "C": C,
                          "V1": V1, "B": B, "launch": case, "iteration": it,
                          "outputs_held": checked,
                          "digest": smoke.digest(lane_snap)}
                if name != "scan reduces the lane flags":
                    record["lane_step_ms"] = time_launch(
                        smoke, "lane_step", loop, lane_snap, parity, checked)
                if fused and name in ("as built", "no pass",
                                      "scan reduces the lane flags"):
                    record["scan_rows_ms"] = time_launch(
                        smoke, "scan_rows", loop, scan_snap, parity, checked)
                print(json.dumps(record), flush=True)


class LaneLaunches:
    """Stands in for ``frontier_kernels.lane_step``: keeps the inputs of
    up to ``keep`` launches with a lane in conflict under decisions and
    as many without, by (B, V1, C), drawn evenly from all launches
    (reservoir sampling from a fixed seed)."""

    def __init__(self, smoke, keep):
        import numpy as np

        self.smoke = smoke
        self.keep = keep
        self.rng = np.random.default_rng(0)
        self.seen = {}
        self.kept = {}
        self.real = None

    def __enter__(self):
        from mythril_tpu_torch.ops import frontier_kernels as FK

        self.real = FK.lane_step
        FK.lane_step = self
        return self

    def __exit__(self, *exc):
        from mythril_tpu_torch.ops import frontier_kernels as FK

        FK.lane_step = self.real

    def __call__(self, loop, parity):
        from mythril_tpu_torch.ops import frontier_kernels as FK

        if not int(loop.ctl[parity, FK.HALT]):
            B, V1 = loop.lane["assign"].shape
            key = (B, V1, loop.lits.shape[0],
                   "learning" if bool(self.smoke.in_conflict(loop).any())
                   else "quiet")
            n = self.seen[key] = self.seen.get(key, 0) + 1
            kept = self.kept.setdefault(key, [])
            slot = (len(kept) if len(kept) < self.keep
                    else int(self.rng.integers(n)))
            if slot < self.keep:
                entry = (loop.to(loop.ctl.device), parity)
                if slot == len(kept):
                    kept.append(entry)
                else:
                    kept[slot] = entry
        self.real(loop, parity)


def main_path_variants(smoke, group, libs, per_shape):
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.contracts import CHIP_RUNS
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.smt.solver import reset_blast_context

    use(libs["as built"])
    runs = []
    with LaneLaunches(smoke, per_shape) as launches:
        reset_blast_context()
        lanes, _ = frontiers.guard_chain_frontier(64, 32)
        bs.batch_check_states(lanes, device="cuda")
        torch.cuda.synchronize()
        runs.append("guard chain 64x32")
        for run in CHIP_RUNS[:2]:
            smoke.analyze_once(run)
            runs.append(run.name)
    for (B, V1, C, case), kept in sorted(launches.kept.items()):
        totals = {}
        for name, path in libs.items():
            if name == "scan reduces the lane flags":
                continue
            use(path)
            for i, (snap, parity) in enumerate(kept):
                loop = snap.to(snap.ctl.device)
                ms = time_launch(smoke, "lane_step", loop, snap, parity,
                                 name in HELD)
                totals[name] = totals.get(name, 0.0) + ms
                print(json.dumps({"group": group, "variant": name, "B": B,
                                  "V1": V1, "C": C, "launch": case,
                                  "sample": i, "lane_step_ms": ms}),
                      flush=True)
        print(json.dumps({
            "shape": {"B": B, "V1": V1, "C": C}, "launch": case,
            "runs": runs, "launches": launches.seen[(B, V1, C, case)],
            "timed": len(kept), "lane_step_ms_sum": totals}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=ROOT)
    parser.add_argument("--shape", action="append",
                        help="C,V1,B (repeatable; default: %s)"
                        % " ".join(SHAPES))
    parser.add_argument("--main-path", action="store_true")
    parser.add_argument("--per-shape", type=int, default=8)
    opts = parser.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("lane_variants: no CUDA device", file=sys.stderr)
        return 2
    import mythril_tpu_torch
    from mythril_tpu_torch.ops import default_device
    from mythril_tpu_torch.ops import frontier_kernels as FK

    if os.path.dirname(os.path.dirname(mythril_tpu_torch.__file__)) != tree:
        print(f"lane_variants: imported {mythril_tpu_torch.__file__}, "
              f"not the tree {tree}", file=sys.stderr)
        return 2
    print(smoke.card_line(), flush=True)
    print(f"card uuid: {smoke.card_uuid()}", flush=True)
    default_device()
    group = choose_group(open(FK.SOURCE).read())
    variants = dict(GROUPS[group])
    if opts.main_path:
        variants.pop("scan reduces the lane flags", None)
    libs = build(variants, os.path.join(FK.BUILD_DIR, "variants"))
    if opts.main_path:
        main_path_variants(smoke, group, libs, opts.per_shape)
    else:
        learning_problem_variants(smoke, group, libs,
                                  opts.shape or SHAPES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
