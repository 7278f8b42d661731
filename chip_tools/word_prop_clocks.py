#!/usr/bin/env python3
"""Where the ``word_prop`` kernel's cycles go: an instrumented copy of
``ops/csrc/word_prop.cu`` (named source edits, each applied exactly once,
built into ``_build/variants/``) reads ``clock64()`` around every pass and
inside the backward pass, and sums each lane's cycles into a device
array.  Run on the card from the repository root::

    python3 chip_tools/word_prop_clocks.py

On the programs of the chip check's two main-path frontiers (scale_mul d6
and the guard chain, 64 lanes each) and the every-opcode DAG, prints one
JSON line a case with, per lane on average (SM cycles): the walk's wall
cycles, the forward passes' and the backward passes' wall cycles (thread
0 of the block, between the barriers), inside the backward pass the
cycles of the comparisons' refines and of the push-downs, and the
forward passes' work by opcode (summed over the block's warps).  The
instrumentation keeps its sums in local memory, so its own cost shows in
every number; its outputs are held against the plain version first, and
``ms`` is the instrumented launch's device time.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "chip_tools"))

#: clock slots: opcodes 0..31 (forward work), then these
FWD_WALL, BWD_WALL, REFINE, PUSH, WALK = 32, 33, 34, 35, 36
SLOTS = 40
EDITS = [
    ("namespace wp {\n",
     "__device__ unsigned long long wp_clk[40];\nnamespace wp {\n"),
    ("struct Lane {\n", "struct Lane {\n  long long clk[40];\n"),
    ("WP_FN void forward_node(Lane& L, int e, bool first) {\n"
     "  const int* E = L.E(e);\n",
     "WP_FN void forward_node_(Lane& L, int e, bool first);\n"
     "WP_FN void forward_node(Lane& L, int e, bool first) {\n"
     "  long long t0 = clock64();\n"
     "  forward_node_(L, e, first);\n"
     "  L.clk[L.E(e)[C_OP]] += clock64() - t0;\n"
     "}\n"
     "WP_FN void forward_node_(Lane& L, int e, bool first) {\n"
     "  const int* E = L.E(e);\n"),
    ("    refine_bv(L, first, w1, dead);\n"
     "    refine_bv(L, second, w2, dead);\n"
     "    for (int side = 0; side < 2; ++side) push_down(L, side ? eb : ea);\n",
     "    long long t1 = clock64();\n"
     "    refine_bv(L, first, w1, dead);\n"
     "    refine_bv(L, second, w2, dead);\n"
     "    long long t2 = clock64();\n"
     "    for (int side = 0; side < 2; ++side) push_down(L, side ? eb : ea);\n"
     "    L.clk[34] += t2 - t1;\n"
     "    L.clk[35] += clock64() - t2;\n"),
    ("  lw.conflict = false;\n  // forward passes",
     "  lw.conflict = false;\n"
     "  for (int i = 0; i < 40; ++i) lw.clk[i] = 0;\n"
     "  long long walk0 = clock64();\n"
     "  // forward passes"),
    ("  for (int pass = 0; pass <= 2 * rounds; ++pass) {\n"
     "    if (pass & 1) {\n"
     "      if (warp == 0 && worker) backward(lw, n, nbool);\n"
     "      __syncthreads();\n"
     "      continue;\n"
     "    }\n",
     "  for (int pass = 0; pass <= 2 * rounds; ++pass) {\n"
     "    long long p0 = clock64();\n"
     "    if (pass & 1) {\n"
     "      if (warp == 0 && worker) backward(lw, n, nbool);\n"
     "      __syncthreads();\n"
     "      lw.clk[33] += clock64() - p0;\n"
     "      continue;\n"
     "    }\n"),
    ("      __syncthreads();\n      k = end;\n    }\n  }\n",
     "      __syncthreads();\n      k = end;\n    }\n"
     "    lw.clk[32] += clock64() - p0;\n  }\n"
     "  lw.clk[36] = clock64() - walk0;\n"
     "  if (worker && (tid & 7) == 0)\n"
     "    for (int i = 0; i < 40; ++i)\n"
     "      if (i < 32 || i == 34 || i == 35 || tid == 0)\n"
     "        atomicAdd(&wp_clk[i], (unsigned long long)lw.clk[i]);\n"),
    ("int word_prop_op_count() { return wp::OP_COUNT; }",
     "int word_prop_op_count() { return wp::OP_COUNT; }\n"
     "int word_prop_clocks(unsigned long long* out) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, wp_clk, sizeof(wp_clk));\n"
     "  unsigned long long zero[40] = {0};\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(wp_clk, zero, sizeof(zero));\n"
     "  return (int)e;\n"
     "}"),
]


def build():
    from mythril_tpu_torch.ops import dense_sweep as ds

    import word_prop_times as W

    src = W.edited_source("clocks", EDITS)
    lib_path = os.path.join(os.path.dirname(src), "libword_prop_clocks.so")
    done = subprocess.run([ds._nvcc(), *ds.NVCC_FLAGS, "-o", lib_path, src],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stderr}")
    print(json.dumps({"ptxas": W.ptxas_lines(done.stdout + done.stderr)}),
          flush=True)
    lib = W.bind_bare(lib_path)
    lib.word_prop_clocks.argtypes = [ctypes.c_void_p]
    lib.word_prop_clocks.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("word_prop_clocks: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mythril_tpu_torch import frontiers
    from mythril_tpu_torch.ops import word_fixpoint as WF
    from mythril_tpu_torch.smt.word_tier import WORD_ROUNDS

    import word_prop_times as W

    card = cs.card_line()
    lib = build()

    def frontier(build_fn):
        lanes, _ = build_fn()
        return [[c.raw for c in lane] for lane in lanes]

    cases = [
        ("main path scale_mul d6 g16",
         frontier(lambda: frontiers.scale_mul_frontier(6, 16))),
        ("main path guard chain 64x32",
         frontier(lambda: frontiers.guard_chain_frontier(64, 32))),
        ("every opcode, 64 lanes", frontiers.word_opcode_lanes(3, 64)),
    ]
    for label, lanes in cases:
        table_host, want0_host, rounds = cs.word_inputs(lanes, WORD_ROUNDS)
        plain = WF.word_fixpoint_plain(table_host, want0_host, rounds)
        table, want0 = table_host.to("cuda"), want0_host.to("cuda")
        B = want0.shape[1]
        launch = W.Launch(lib, table, want0, rounds)
        buf = (ctypes.c_ulonglong * SLOTS)()
        if lib.word_prop_clocks(buf) or launch():
            print(f"{label}: launch failed", file=sys.stderr)
            return 1
        torch.cuda.synchronize()
        if lib.word_prop_clocks(buf):
            print(f"{label}: clocks not read", file=sys.stderr)
            return 1
        for part, g, w in zip(("planes", "tri", "conflict"),
                              launch.outputs(), plain):
            if not torch.equal(g, w):
                print(f"{label}: {part} differs from the plain version",
                      file=sys.stderr)
                return 1
        per = [v / B for v in buf]
        # per-lane slots were added by one thread a lane (the walls) or
        # by one thread a group and warp (the work): both are per lane
        print(json.dumps({
            "case": label, "lanes": B, "nodes": table.n_bv + table.n_bool,
            "walk": per[WALK], "forward wall": per[FWD_WALL],
            "backward wall": per[BWD_WALL],
            "backward refines": per[REFINE], "backward push-downs": per[PUSH],
            "forward work by op": {WF.OP_NAMES[k]: per[k] for k in range(32)
                                   if per[k]},
            "ms": cs.cuda_ms(launch, 5),
        }), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
