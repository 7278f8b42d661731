#!/usr/bin/env python3
"""Device times of variants of the ``scan_rows`` kernel, for the design
record in PERF.md: each variant is ``ops/csrc/frontier.cu`` with named
edits, built with the same ``nvcc`` flags into ``_build/variants/``.  An
edit that does not apply to the source exactly once stops the script.

Two kinds of variant: design alternatives, whose outputs are held
against the plain version before they are timed; and a breakdown, which
leaves out one part of the kernel (its outputs are then wrong, and only
its time is read).  Run on the card from the repository root::

    python3 chip_tools/scan_variants.py [--v1 8193 2049]
    python3 chip_tools/scan_variants.py --main-path [--per-shape 12]

The first form times every variant on the same launches of
``frontiers.learning_problem`` (C = 16384, B = 64, E = 64 with 40 rows
prefilled; iteration 0's full view and iteration 1's gather view) at
each width of ``--v1``.  ``--main-path`` runs the guard-chain frontier
and the scale_mul analyses of ``contracts.CHIP_RUNS`` (d6 -t 1, d4 -t 2)
on the built kernel, records every full-view scan they launch (each
lane's share of assigned vars) and keeps a copy of its inputs; then it
times the two ways of counting the scores on up to ``--per-shape`` of
those launches per shape, spread over their count of lanes at least half
assigned.  Prints the card line and UUID, then one JSON line per variant
and width, or per timed launch and per shape.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: design alternatives: name -> [(text of the source, replacement)]
DESIGNS = {
    "as built": [],
    "scores counted on open rows": [
        ("  if (scores && (sat || nunk == 1)) {",
         "  if (scores && !(sat || nunk == 1)) {"),
        ("  if (full) {  // an unknown var's score",
         "  if (false) {  // an unknown var's score")],
    "4 pool tiles in flight": [
        ("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "1024-row pool tiles": [
        ("constexpr int kTileRows = kThreads;",
         "constexpr int kTileRows = 2 * kThreads;")],
    "clusters for 256 blocks (two a SM)": [
        ("kClusterBlocks = 128;", "kClusterBlocks = 256;")],
    "queue popped by one warp": [
        ("    const int n = pop_queue(r_room, (int)((uintptr_t)recent & 15), "
         "recent,\n                            V1, a.fan, s_picked, red);\n"
         "    if (tid == 0) s_npicked = n;",
         """    if (tid < 32) {
      int count = 0;
      for (int base = V1 - 1; base >= 1 && count < a.fan; base -= 32) {
        const int v = base - tid;
        const bool q = v >= 1 && sR[v];
        const unsigned m = __ballot_sync(0xffffffffu, q);
        if (q) {
          const int rank = count + __popc(m & ((1u << tid) - 1u));
          if (rank < a.fan) {
            s_picked[rank] = v;
            recent[v] = 0;
          }
        }
        count += __popc(m);
      }
      if (tid == 0) s_npicked = min(count, a.fan);
    }""")],
}
#: breakdown: the kernel less one part (wrong outputs, time only)
BREAKDOWN = {
    "no row evaluation": [
        ("        eval_row(l, r + 1, true, V1, sA, pl, conf);",
         "        if (l[0] == INT_MIN) "
         "eval_row(l, r + 1, true, V1, sA, pl, conf);")],
    "no queue pop": [
        ("    const int n = pop_queue(r_room, (int)((uintptr_t)recent & 15), "
         "recent,\n                            V1, a.fan, s_picked, red);",
         "    const int n = 0;")],
    "no write-out": [
        ("  for (int q = tid; q < quads; q += kThreads) {\n"
         "    const int i = head + 4 * q;\n    const int4 p",
         "  for (int q = tid; q < 0; q += kThreads) {\n"
         "    const int i = head + 4 * q;\n    const int4 p"),
        ("  for (int j = tid; j < nown - 4 * quads; j += kThreads) {\n"
         "    const int i = j < head ? j : j + 4 * quads;\n"
         "    const size_t g = g0 + i;\n    a.fpos",
         "  for (int j = tid; j < 0; j += kThreads) {\n"
         "    const int i = j < head ? j : j + 4 * quads;\n"
         "    const size_t g = g0 + i;\n    a.fpos")],
}
#: the variants of --main-path: how the full view counts its scores (as
#: built: the pool's occurrences less those in closed rows)
SCORE_VARIANTS = ("as built", "scores counted on open rows")


def build(variants, build_dir):
    """Every variant's library, compiled together; name -> path."""
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import frontier_kernels as FK

    source = open(FK.SOURCE).read()
    os.makedirs(build_dir, exist_ok=True)
    jobs, libs = {}, {}
    for i, (name, edits) in enumerate(variants.items()):
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: edit not found")
            text = text.replace(old, new)
        src = os.path.join(build_dir, f"variant{i}.cu")
        libs[name] = os.path.join(build_dir, f"libvariant{i}.so")
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = subprocess.Popen(
            [ds._nvcc(), *ds.NVCC_FLAGS, "-o", libs[name], src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, job in jobs.items():
        out = job.communicate()[0]
        if job.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed:\n{out}")
    return libs


def use(path):
    from mythril_tpu_torch.ops import frontier_kernels as FK

    FK.LIBRARY, FK._lib = path, None
    FK.load_library()


def time_view(smoke, loop, snap, parity, checked):
    """Device ms of the scan launched from ``snap`` on ``loop`` with the
    library in use; held against the plain version first if
    ``checked``."""
    from mythril_tpu_torch.ops import frontier_kernels as FK

    loop.args = None
    smoke._restore(loop, snap)
    if checked:
        smoke.run_checked("scan_rows", loop, parity, FK.scan_rows)

    def launch():
        smoke._restore(loop, snap)
        FK.scan_rows(loop, parity)

    return smoke.kernel_device_ms(launch, 20, "scan_rows_kernel")


def learning_problem_variants(smoke, libs, widths):
    from mythril_tpu_torch.ops import frontier_kernels as FK

    for V1 in widths:
        use(libs["as built"])
        loop = smoke.learning_loop(16384, V1, 64, 64, 40)
        dev = loop.ctl.device
        views = {}
        for it in range(2):  # iteration 0 is a full view, 1 a gather view
            parity = it & 1
            full = bool(int(loop.ctl[parity, FK.FULL]))
            views["full" if full else "gather"] = (loop.to(dev), parity)
            for name in ("scan_rows", "lane_step", "round_epilogue"):
                getattr(FK, name)(loop, parity)
        for name, path in libs.items():
            use(path)
            record = {"variant": name, "V1": V1, "C": 16384, "B": 64,
                      "outputs_held": name in DESIGNS}
            for view, (snap, parity) in sorted(views.items()):
                record[f"{view}_ms"] = time_view(smoke, loop, snap, parity,
                                                 name in DESIGNS)
            print(json.dumps(record), flush=True)


class FullViews:
    """Stands in for ``frontier_kernels.scan_rows``: before each
    full-view launch it records each lane's count of assigned vars and
    keeps a copy of the loop's inputs, by (B, V1, C)."""

    def __init__(self, keep):
        self.keep = keep
        self.launches = {}
        self.real = None

    def __enter__(self):
        from mythril_tpu_torch.ops import frontier_kernels as FK

        self.real = FK.scan_rows
        FK.scan_rows = self
        return self

    def __exit__(self, *exc):
        from mythril_tpu_torch.ops import frontier_kernels as FK

        FK.scan_rows = self.real

    def __call__(self, loop, parity):
        from mythril_tpu_torch.ops import frontier_kernels as FK

        ctl = loop.ctl[parity].tolist()
        if not ctl[FK.HALT] and ctl[FK.FULL]:
            B, V1 = loop.lane["assign"].shape
            key = (B, V1, loop.lits.shape[0])
            assigned = (loop.lane["assign"] != 0).sum(dim=1).tolist()
            seen = self.launches.setdefault(key, [])
            snap = loop.to(loop.ctl.device) if len(seen) < self.keep else None
            seen.append((assigned, snap, parity))
        self.real(loop, parity)


def main_path_variants(smoke, libs, per_shape, keep=512):
    import numpy as np
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.contracts import CHIP_RUNS
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.smt.solver import reset_blast_context
    from mythril_tpu_torch.support.support_args import FORCE_DISPATCH_ARGS

    use(libs["as built"])
    runs = []
    with FullViews(keep) as views:
        reset_blast_context()
        lanes, _ = frontiers.guard_chain_frontier(64, 32)
        with smoke.rung_args(**FORCE_DISPATCH_ARGS):
            bs.batch_check_states(lanes, device="cuda")
        torch.cuda.synchronize()
        runs.append("guard chain 64x32")
        for run in CHIP_RUNS[:2]:
            smoke.analyze_once(run)
            runs.append(run.name)
    for (B, V1, C), seen in sorted(views.launches.items()):
        half = [sum(2 * a >= V1 for a in assigned)
                for assigned, _, _ in seen]
        shares = np.array([a / V1 for assigned, _, _ in seen
                           for a in assigned])
        kept = sorted((h, i) for i, (h, (_, snap, _)) in
                      enumerate(zip(half, seen)) if snap is not None)
        picks = sorted({kept[round(j * (len(kept) - 1) / max(per_shape - 1, 1))]
                        for j in range(min(per_shape, len(kept)))})
        totals = dict.fromkeys(SCORE_VARIANTS, 0.0)
        for h, i in picks:
            assigned, snap, parity = seen[i]
            loop = snap.to(snap.ctl.device)
            record = {"B": B, "V1": V1, "C": C, "launch": i,
                      "lanes_half_assigned": h,
                      "mean_share": sum(assigned) / (B * V1)}
            for name in SCORE_VARIANTS:
                use(libs[name])
                ms = time_view(smoke, loop, snap, parity, True)
                record[name] = ms
                totals[name] += ms
            print(json.dumps(record), flush=True)
        print(json.dumps({
            "shape": {"B": B, "V1": V1, "C": C}, "runs": runs,
            "full_views": len(seen),
            "lanes_half_assigned": int(sum(half)),
            "lane_views": int(shares.size),
            "share_quartiles": [float(q) for q in
                                np.quantile(shares, [0, .25, .5, .75, 1])],
            "timed": len(picks), "timed_ms_sum": totals}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--v1", type=int, nargs="+", default=[8193, 2049])
    parser.add_argument("--main-path", action="store_true")
    parser.add_argument("--per-shape", type=int, default=12)
    opts = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from mythril_tpu_torch.ops import default_device
    from mythril_tpu_torch.ops import frontier_kernels as FK

    print(smoke.card_line(), flush=True)
    print(f"card uuid: {smoke.card_uuid()}", flush=True)
    default_device()
    build_dir = os.path.join(FK.BUILD_DIR, "variants")
    if opts.main_path:
        libs = build({k: DESIGNS[k] for k in SCORE_VARIANTS}, build_dir)
        main_path_variants(smoke, libs, opts.per_shape)
    else:
        libs = build({**DESIGNS, **BREAKDOWN}, build_dir)
        learning_problem_variants(smoke, libs, opts.v1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
