#!/usr/bin/env python3
"""Device times of variants of the ``round_lane`` kernel, for the design
record in PERF.md: each variant is the tree's ``ops/csrc/round_lane.cu``
with named edits, built with the same ``nvcc`` flags into
``_build/variants/``; an edit that does not apply to the source exactly
once stops the script.  With ``--parent DIR`` the kernel of another tree
of this repository (its ``round_lane.cu`` as it is) is timed beside
them, in turns with "as built" (parent, change, change, parent).

Variants whose outputs should be right (every one but the breakdown's)
are held against ``round_lane_plain`` on the launch before they are
timed: the cluster at the rule's size and at 1, 2, 4 and 8 blocks a
lane; a contiguous slice of rows a block in place of every S-th; the rows
read from global memory a row ahead in registers, or streamed through
shared memory in cp.async.bulk tiles, in place of the int16 copy kept in
shared memory; every row's eight literal places visited (not only up to
the warp's widest row); blocks of 512 threads; no records (every sweep
counts every open row's unknown literals with atomics, as the one-block
kernel did).  A variant whose block does not fit at a shape is reported
as not launched.  Two variants leave part of the kernel out (wrong
outputs, read for their times only): "phase clocks" writes each lane's
cycles in each phase of a sweep over its stack, and "no row evaluation"
reads the rows and skips them unevaluated.  Run on the card, by path::

    python3 chip_tools/round_lane_variants.py [--parent DIR] \\
        [--shape C,V1,B ...] [--budget 768]
    python3 chip_tools/round_lane_variants.py --main-path [--parent DIR] \\
        [--per-shape 4]

The first form runs ``frontiers.learning_problem`` as the chip check
sets it up (``chip_smoke.round_lane_inputs``) at each shape, one launch
at ``--budget``.  ``--main-path`` runs the guard-chain frontier under
``MYTHRIL_TPU_FRONTIER=0`` (the round-lane ladder), the prefetch phase's
guard chain, and the scale_mul analyses of ``contracts.CHIP_RUNS`` (d6
-t 1, d4 -t 2) in the default rungs (the prefetch's one-shot solves);
it keeps the inputs of up to ``--per-shape`` launches of each (C, V1, B,
budget), drawn evenly from all of them, and times every variant on
them.  Prints the card line and UUID, then one JSON line per variant and
launch (device ms, the slowest lane's sweeps, a digest of the inputs),
and per shape the sums.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the chip check's shapes of the learning problem (C, V1, B)
SHAPES = ("16384,8193,64", "16384,2049,64", "16384,8193,8",
          "16384,8193,32", "16384,8193,256")

_CLUSTER_RULE = "    if ((B * S >= kClusterBlocks || S == kMaxCluster) &&"
_ROW_LOOP = (
    "      for (int base = 0; base < nrows; base += kThreads) {\n"
    "        const int i = base + tid;\n"
    "        const int4 ca = a, cb = b;\n"
    "        if (i + kThreads < nrows) {\n"
    "          a = rows[gap * (i + kThreads)];\n"
    "          b = rows[gap * (i + kThreads) + 1];\n"
    "        }\n"
    "        const bool live = i < nrows && !skip(i);\n"
    "        const int l[kWidth] = {ca.x, ca.y, ca.z, ca.w,\n"
    "                               cb.x, cb.y, cb.z, cb.w};\n"
    "        const int kw = widest(l, live);\n"
    "        if (live) visit(l, i, kw);\n"
    "      }\n")
#: the rows read from global memory every sweep, a row ahead in registers
_GLOBAL = ("  L.resident = V1 <= 32768 && L.rows + 16 * L.n <= "
           "kMaxDynamicSmem;", "  L.resident = false;")
#: a contiguous 1/S slice of the rows a block, in place of every S-th row
#: from row r (a bulk copy needs one)
_CONTIGUOUS = (
    "  const int nrows = max(0, (C - rank + S - 1) / S);\n"
    "  const int4* rows = lits + 2 * rank;\n"
    "  const int gap = 2 * S;\n",
    "  const int nrows = max(0, min(L.n, C - rank * L.n));\n"
    "  const int4* rows = lits + 2 * static_cast<size_t>(rank) * L.n;\n"
    "  const int gap = 2;\n")
_BYTES = "  L.bytes = L.rows + (L.resident ? 16 * L.n : 0);"
_BARRIER_DOC = ("// A cluster barrier: every thread of every block arrives and "
                "waits, from")
_CLEAR = ("  int clear = kSaturated;  // records above it are void: the last "
          "Lm\n")
_APPLIED = ("    __syncthreads();  // the replica is applied, every warp has "
            "its action\n")
#: the rows streamed through shared memory in 1,024-row tiles by
#: cp.async.bulk on mbarriers, two in flight (the scan_rows way)
_TILES = [
    _GLOBAL,
    _CONTIGUOUS,
    (_BYTES, _BYTES[:-1] + " + 2 * 1024 * 32;"),
    (_BARRIER_DOC, r"""constexpr int kTileRows = kThreads, kStages = 2;
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile("{\n.reg .pred done;\nWAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(phase)
               : "memory");
}

""" + _BARRIER_DOC),
    (_CLEAR, r"""  __shared__ uint64_t s_bar[kStages];
  int4* sTiles = reinterpret_cast<int4*>(smem + L.bytes - 2 * 1024 * 32);
  const int ntiles = (nrows + kTileRows - 1) / kTileRows;
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(&s_bar[k])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int k, int seq) {
    const int n = min(kTileRows, nrows - k * kTileRows);
    bulk_load(sTiles + (seq % kStages) * kTileRows * 2,
              rows + 2 * static_cast<size_t>(k) * kTileRows, n * 32,
              &s_bar[seq % kStages]);
  };
  int seq0 = 0;
  if (tid == 0 && runs)
    for (int k = 0; k < min(kStages, ntiles); ++k) issue(k, k);
""" + _CLEAR),
    (_ROW_LOOP, r"""      for (int k = 0; k < ntiles; ++k) {
        const int seq = seq0 + k, stage = seq % kStages;
        mbar_wait(&s_bar[stage], (seq / kStages) & 1);
        const int i = k * kTileRows + tid;
        const bool live = i < nrows && !skip(i);
        int4 x = make_int4(0, 0, 0, 0), y = x;
        if (live) {
          const int4* p = sTiles + (stage * kTileRows + tid) * 2;
          x = p[0];
          y = p[1];
        }
        const int l[kWidth] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
        const int kw = widest(l, live);
        if (live) visit(l, i, kw);
        __syncthreads();  // the stage is free for tile k + kStages
        if (tid == 0 && k + kStages < ntiles)
          issue(k + kStages, seq + kStages);
      }
      seq0 += ntiles;
"""),
    (_APPLIED, "    if (tid == 0 && status == 0 && step < budget)\n"
     "      for (int k = 0; k < min(kStages, ntiles); ++k) "
     "issue(k, seq0 + k);\n" + _APPLIED),
]
_LOOP_END = "      sDflip[dep] = 0;\n    }\n  }\n"
#: the breakdown: cycles of each phase of block 0 of each lane, summed over
#: its sweeps, in hundreds, over dvar[0:6] (scan, wait for the votes,
#: flags and words, wait for the partials, action and apply, stack)
_CLOCKS = [
    (_CLEAR, "  long long acc[6] = {0, 0, 0, 0, 0, 0};\n" + _CLEAR),
    ("    // 1. the clause scan over this block's rows",
     "    const long long c0 = clock64();\n"
     "    // 1. the clause scan over this block's rows"),
    ("    barrier();  // every vote and score has landed\n",
     "    const long long c1 = clock64();\n"
     "    barrier();  // every vote and score has landed\n"
     "    const long long c2 = clock64();\n"),
    ("    barrier();  // every partial and every word is in every block\n",
     "    const long long c3 = clock64();\n"
     "    barrier();  // every partial and every word is in every block\n"
     "    const long long c4 = clock64();\n"),
    (_APPLIED, _APPLIED + "    const long long c5 = clock64();\n"),
    (_LOOP_END,
     _LOOP_END[:-4] + "    const long long c6 = clock64();\n"
     "    acc[0] += c1 - c0; acc[1] += c2 - c1; acc[2] += c3 - c2;\n"
     "    acc[3] += c4 - c3; acc[4] += c5 - c4; acc[5] += c6 - c5;\n  }\n"),
    ("    if (tid == 0) {\n      depth_g[lane] = depth;",
     "    if (tid == 0)\n      for (int k = 0; k < 6 && k < D; ++k)\n"
     "        dvar[drow + k] = static_cast<int>(acc[k] / 100);\n"
     "    if (tid == 0) {\n      depth_g[lane] = depth;"),
]
PHASES = ("scan", "wait for votes", "flags and words", "wait for partials",
          "action and apply", "stack")

#: no records: every sweep scans every row and counts the unknown literals
#: of the open ones into the scores with atomics, zeroed after the flags
#: (the one-block kernel's way)
_NO_RECORDS = [
    ("      return sRec[i] != 0 && sRec[i] <= clear;", "      return false;"),
    ("""      const bool had = sRec[i] != 0;
      if (sat) {
        sRec[i] = static_cast<uint16_t>(level);
        if (!had) {
#pragma unroll
          for (int k = 0; k < kWidth; ++k)
            if (k < kw && l[k] != 0) bump(l[k], -1);
        }
        return;
      }
      if (had) {
        sRec[i] = 0;
#pragma unroll
        for (int k = 0; k < kWidth; ++k)
          if (k < kw && l[k] != 0) bump(l[k], 1);
      }
""", "      if (sat) return;\n"),
    ("""          atomicOr(cluster.map_shared_rank(word, owner), 1u << (j & 31));
      }
    };""", """          atomicOr(cluster.map_shared_rank(word, owner), 1u << (j & 31));
      } else {
#pragma unroll
        for (int k = 0; k < kWidth; ++k)
          if (k < kw && l[k] != 0 && sA[l[k] > 0 ? l[k] : -l[k]] == 0)
            bump(l[k], 1);
      }
    };"""),
    ("  if (runs)\n    for (int i = tid; i < nrows; i += kThreads) {",
     "  if (false)\n    for (int i = tid; i < nrows; i += kThreads) {"),
    ("        key = k > key ? k : key;\n      }\n",
     "        key = k > key ? k : key;\n      }\n"
     "      if (in) {\n        sPos[i] = 0;\n        sNeg[i] = 0;\n      }\n"),
]

#: variant -> [(text of the source, replacement)]
VARIANTS = {
    "as built": [],
    "cluster of 1": [(_CLUSTER_RULE, "    if (S == 1 &&")],
    "cluster of 2": [(_CLUSTER_RULE, "    if (S == 2 &&")],
    "cluster of 4": [(_CLUSTER_RULE, "    if (S == 4 &&")],
    "cluster of 8": [(_CLUSTER_RULE, "    if (S == 8 &&")],
    "contiguous row slices": [_CONTIGUOUS],
    "rows from global memory, a row ahead in registers": [_GLOBAL],
    "rows streamed in cp.async.bulk tiles": _TILES,
    "every row's 8 literals visited": [
        ("        if (k >= kw) break;  // uniform across the warp\n", "")],
    "512 threads a block": [
        ("constexpr int kThreads = 1024;  // threads a block",
         "constexpr int kThreads = 512;  // threads a block")],
    "no row evaluation (breakdown)": [
        ("        if (live) visit(l, i, kw);\n      }\n    } else {",
         "        if (live && kw < 0) visit(l, i, kw);\n"
         "      }\n    } else {")],
    "no records (open rows counted)": _NO_RECORDS,
    "phase clocks": _CLOCKS,
}
#: variants that leave out part of the kernel: wrong outputs, time only
BREAKDOWN = ("phase clocks", "no row evaluation (breakdown)")
PARENT = "one block per lane (parent)"


def build(variants, build_dir, parent=None):
    """Every variant's library (and the parent tree's kernel), compiled
    together; name -> path."""
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import round_lane as RL

    source = open(RL.SOURCE).read()
    os.makedirs(build_dir, exist_ok=True)
    sources = {}
    for name, edits in variants.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: edit not found")
            text = text.replace(old, new)
        sources[name] = text
    if parent:
        sources[PARENT] = open(os.path.join(
            parent, "mythril_tpu_torch", "ops", "csrc", "round_lane.cu")).read()
    jobs, libs = {}, {}
    for i, (name, text) in enumerate(sources.items()):
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
        print(json.dumps({"variant": name, "ptxas": " | ".join(
            line.strip() for line in out.splitlines()
            if "registers" in line or "spill" in line)}), flush=True)
    return libs


def use(path):
    from mythril_tpu_torch.ops import round_lane as RL

    RL._lib = RL.bind(path, check=False)


def digest(lits, state, budget) -> str:
    from mythril_tpu_torch.ops import round_lane as RL

    h = hashlib.sha256(str(budget).encode())
    for t in [lits] + [state[k] for k in RL.ROUND_STATE_FIELDS]:
        h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def time_variants(smoke, libs, lits, state, budget, record):
    """Every variant on one launch (parent and "as built" in turns):
    held against the plain version where its outputs should be right,
    then timed.  Prints one JSON line each; returns name -> ms."""
    import torch

    from mythril_tpu_torch.ops import round_lane as RL

    want = RL.round_lane_plain(lits, state, budget)
    order = list(libs)
    if PARENT in libs:
        order = [PARENT, "as built", "as built", PARENT] + [
            n for n in libs if n not in (PARENT, "as built")]
    times = {}
    for name in order:
        use(libs[name])
        try:
            got = RL.round_lane(lits, state, budget)
        except RuntimeError as exc:  # e.g. a block past shared memory
            print(json.dumps(dict(record, variant=name,
                                  not_launched=str(exc))), flush=True)
            continue
        torch.cuda.synchronize()
        held = name not in BREAKDOWN
        if held:
            for k in RL.ROUND_STATE_FIELDS:
                if not torch.equal(got[k], want[k]):
                    raise RuntimeError(f"variant {name!r}: {k} differs from "
                                       f"the plain version ({record})")
        ms = smoke.kernel_device_ms(
            lambda: RL.round_lane(lits, state, budget), 5, "round_lane_kernel")
        steps = int(got["step"].max())
        out = dict(record, variant=name, outputs_held=held, ms=ms,
                   slowest_lane_sweeps=steps,
                   us_per_sweep=ms * 1e3 / max(steps, 1))
        if name == "phase clocks":
            lane = int(got["step"].argmax())
            cyc = got["dvar"][lane, :6].to(torch.float64) * 100 / max(steps, 1)
            out["kcycles_per_sweep"] = dict(zip(
                PHASES, [round(float(c) / 1e3, 3) for c in cyc]))
        times.setdefault(name, []).append(ms)
        print(json.dumps(out), flush=True)
    return {name: sum(v) / len(v) for name, v in times.items()}


def learning_problem_variants(smoke, libs, shapes, budget):
    from mythril_tpu_torch.ops import round_lane as RL

    for shape in shapes:
        C, V1, B = (int(x) for x in shape.split(","))
        lits, state = smoke.round_lane_inputs(C, V1, B)
        D = state["dvar"].shape[1]
        S = RL.cluster_size(B, C, V1, D)
        time_variants(smoke, libs, lits, state, budget, {
            "C": C, "V1": V1, "B": B, "budget": budget, "cluster": S,
            "digest": digest(lits, state, budget)})


class RoundLaunches:
    """Stands in for ``round_lane.round_lane``: keeps copies of the inputs
    of up to ``keep`` launches of each (C, V1, B, budget), drawn evenly
    from all of them (reservoir sampling from a fixed seed), and counts
    them by the path that made them.  Thread-safe: the prefetch's worker
    calls it on its own stream."""

    def __init__(self, keep):
        import numpy as np

        self.keep = keep
        self.rng = np.random.default_rng(0)
        self.seen, self.kept, self.paths = {}, {}, {}
        self.path = None
        self.lock = threading.Lock()
        self.real = None

    def __enter__(self):
        from mythril_tpu_torch.ops import round_lane as RL

        self.real = RL.round_lane
        RL.round_lane = self
        return self

    def __exit__(self, *exc):
        from mythril_tpu_torch.ops import round_lane as RL

        RL.round_lane = self.real

    def __call__(self, lits, state, budget):
        B, V1 = state["assign"].shape
        key = (lits.shape[0], V1, B, int(budget))
        copy = (lits.clone(), {k: v.clone() for k, v in state.items()})
        with self.lock:
            n = self.seen[key] = self.seen.get(key, 0) + 1
            self.paths.setdefault(key, set()).add(self.path)
            kept = self.kept.setdefault(key, [])
            slot = (len(kept) if len(kept) < self.keep
                    else int(self.rng.integers(n)))
            if slot == len(kept):
                kept.append(copy)
            elif slot < self.keep:
                kept[slot] = copy
        return self.real(lits, state, budget)


def main_path_variants(smoke, libs, per_shape):
    import torch

    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.contracts import CHIP_RUNS
    from mythril_tpu_torch.ops import async_dispatch as AD
    from mythril_tpu_torch.ops import batched_sat as bs
    from mythril_tpu_torch.ops import round_lane as RL
    from mythril_tpu_torch.smt.solver import reset_blast_context
    from mythril_tpu_torch.support.support_args import FORCE_DISPATCH_ARGS

    use(libs["as built"])
    with RoundLaunches(per_shape) as launches:
        launches.path = "guard chain 64x32, MYTHRIL_TPU_FRONTIER=0"
        reset_blast_context()
        lanes, _ = frontiers.guard_chain_frontier(64, 32)
        with smoke.env(MYTHRIL_TPU_FRONTIER="0", MYTHRIL_TPU_DENSE="0"), \
                smoke.rung_args(**FORCE_DISPATCH_ARGS):
            bs.batch_check_states(lanes, device="cuda")
        launches.path = "prefetch, guard chain 64x32"
        reset_blast_context()
        AD.reset_async_dispatch()
        with smoke.rung_args(device_force_dispatch=False, async_dispatch=True,
                             device_coalesce=True, device_min_save_s=1e9):
            bs.batch_check_states(lanes, device="cuda", tail=False)
            AD.get_async_dispatcher().join()
        for run in CHIP_RUNS[:2]:
            launches.path = f"prefetch, {run.name} (default rungs)"
            smoke.analyze_once(run, force=False)
            AD.get_async_dispatcher().join()
        torch.cuda.synchronize()
    for key, kept in sorted(launches.kept.items()):
        C, V1, B, budget = key
        D = kept[0][1]["dvar"].shape[1]
        S = RL.cluster_size(B, C, V1, D)
        totals = {}
        for i, (lits, state) in enumerate(kept):
            ms = time_variants(smoke, libs, lits, state, budget, {
                "C": C, "V1": V1, "B": B, "budget": budget, "cluster": S,
                "sample": i, "digest": digest(lits, state, budget)})
            for name, t in ms.items():
                totals[name] = totals.get(name, 0.0) + t
        print(json.dumps({
            "shape": {"C": C, "V1": V1, "B": B, "budget": budget,
                      "cluster": S}, "paths": sorted(launches.paths[key]),
            "launches": launches.seen[key], "timed": len(kept),
            "ms_sum": totals}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="root of the tree whose kernel is "
                        "timed beside this tree's")
    parser.add_argument("--shape", action="append",
                        help="C,V1,B (repeatable; default: %s)"
                        % " ".join(SHAPES))
    parser.add_argument("--budget", type=int, default=768)
    parser.add_argument("--main-path", action="store_true")
    parser.add_argument("--per-shape", type=int, default=4)
    opts = parser.parse_args()
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("round_lane_variants: no CUDA device", file=sys.stderr)
        return 2
    from mythril_tpu_torch.ops import default_device
    from mythril_tpu_torch.ops import round_lane as RL

    print(smoke.card_line(), flush=True)
    print(f"card uuid: {smoke.card_uuid()}", flush=True)
    default_device()
    RL.load_library()  # this tree's library passes its layout check
    libs = build(VARIANTS, os.path.join(RL.BUILD_DIR, "variants"),
                 opts.parent and os.path.abspath(opts.parent))
    if opts.main_path:
        main_path_variants(smoke, libs, opts.per_shape)
    else:
        learning_problem_variants(smoke, libs, opts.shape or SHAPES,
                                  opts.budget)
    return 0


if __name__ == "__main__":
    sys.exit(main())
