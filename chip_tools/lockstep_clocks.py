#!/usr/bin/env python3
"""Where the ``lockstep`` kernel's cycles go: an instrumented copy of
``ops/csrc/lockstep.cu`` (named source edits, each applied exactly once,
built into ``_build/variants/``) reads ``clock64()`` on the lane's
thread 0 around the prologue (kernel entry until the lane's state is in
shared memory), around each step of the step loop, and over the epilogue
(the loop's end until the kernel's), and sums them over the lanes into a
device array.  Run on the card from the repository root::

    python3 chip_tools/lockstep_clocks.py [--parent DIR]

With ``--parent DIR`` the ``lockstep.cu`` of another tree of this
repository is instrumented the same way (its own edits) and run beside
it.  On the ``vault_withdraw`` pre-split validation, the ``batchtoken``
replay's second transaction and the gauntlet at 1,024 lanes x 1,024
steps, prints one JSON line a case and tree with, per lane on average
(SM cycles): the prologue, the step loop's cycles by opcode class
(division: DIV, SDIV, MOD, SMOD; EXP; memory and storage: MLOAD, MSTORE,
MSTORE8, SLOAD, SSTORE, CALLDATALOAD; control: STOP, JUMP, JUMPI,
JUMPDEST, RETURN, REVERT; the rest) with the steps of each class, the
epilogue and the whole.  A step's cycles include its fetch, visited bit
and underflow check; the instrumentation's own reads and sums show in
every number.  Each launch is held against the plain version first, and
``ms`` is the instrumented launch's device time.
"""

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "chip_tools"))

#: clock slots: the prologue, the epilogue, the whole; from OPS each
#: opcode's step cycles, from COUNTS its steps
PROLOGUE, EPILOGUE, WHOLE, OPS, COUNTS, SLOTS = 0, 1, 2, 16, 272, 528
#: opcode classes of the breakdown
CLASSES = {
    "division": (0x04, 0x05, 0x06, 0x07),
    "exp": (0x0A,),
    "memory and storage": (0x51, 0x52, 0x53, 0x54, 0x55, 0x35),
    "control": (0x00, 0x56, 0x57, 0x5B, 0xF3, 0xFD),
}
NAMES = {0x01: "ADD", 0x02: "MUL", 0x03: "SUB", 0x04: "DIV", 0x05: "SDIV",
         0x06: "MOD", 0x07: "SMOD", 0x0A: "EXP", 0x10: "LT", 0x11: "GT",
         0x14: "EQ", 0x15: "ISZERO", 0x16: "AND", 0x1B: "SHL", 0x1C: "SHR",
         0x1D: "SAR", 0x35: "CALLDATALOAD", 0x50: "POP", 0x51: "MLOAD",
         0x52: "MSTORE", 0x54: "SLOAD", 0x55: "SSTORE", 0x56: "JUMP",
         0x57: "JUMPI", 0x5B: "JUMPDEST", 0x60: "PUSH1", 0x61: "PUSH2",
         0x63: "PUSH4", 0x7F: "PUSH32", 0x80: "DUP1", 0x81: "DUP2",
         0x90: "SWAP1", 0x91: "SWAP2"}

COUNTERS = """__device__ unsigned long long ls_clk[528];
"""

READER = """
extern "C" int lockstep_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ls_clk, sizeof(ls_clk));
  static unsigned long long zero[528];
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ls_clk, zero, sizeof(zero));
  return (int)e;
}
"""


def run_lane(fetch, pops, visit, fetch_first):
    """The step loop, timed a step on the group's thread 0, each step's
    cycles and count added to its opcode's slots (the tree's ``fetch`` of
    the opcode, its ``pops`` of the opcode, its ``visit`` guard of the
    visited bit, and whether it fetches before it sets the bit)."""
    visited = ("    if (%s)\n      L.visited[clampi(L.pc >> 5, 0, L.words - 1)]"
               " |= 1u << (L.pc & 31);\n" % visit)
    read = "    const int op = %s;\n" % fetch
    return """LS_FN void run_lane(Lane& L, const Prog& P, int max_steps) {
  while (L.halt == RUNNING && L.steps < max_steps) {
    const long long t0 = clock64();
%s    L.steps += 1;
    if (L.sp < %s) L.halt = ERROR;
    else step(L, P, op);
    if (threadIdx.x == 0) {
      atomicAdd(&ls_clk[16 + op], (unsigned long long)(clock64() - t0));
      atomicAdd(&ls_clk[272 + op], 1ull);
    }
  }
}
""" % ((read + visited) if fetch_first else (visited + read), pops)


#: this tree's source
EDITS = [
    ("namespace ls {\n\nconstexpr int kStack",
     COUNTERS + "namespace ls {\n\nconstexpr int kStack"),
    (("// the lane until it halts or has taken max_steps steps",
      "// The batch in the EVMState"),
     run_lane("code_byte(P, L.pc)", "L.pops[op]", "L.words && group_leader()",
              True) + "\n"),
    ("  const int t = threadIdx.x;\n\n  if (t == 0) load_bulk",
     "  const int t = threadIdx.x;\n  const long long ls_t0 = clock64();\n"
     "  long long ls_t1 = 0, ls_t2 = 0;\n\n  if (t == 0) load_bulk"),
    ("  if (t < 8) {\n    L.used = 0;",
     "  ls_t1 = clock64();\n  if (t < 8) {\n    L.used = 0;"),
    ("    run_lane(L, P, max_steps);\n    if (t == 0) {\n      close_lane",
     "    run_lane(L, P, max_steps);\n    ls_t2 = clock64();\n"
     "    if (t == 0) {\n      close_lane"),
    ("  if (t == 0) asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: \"memory\");\n}",
     "  if (t == 0) asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: \"memory\");\n"
     "  if (t == 0) {\n    const long long end = clock64();\n"
     "    atomicAdd(&ls_clk[0], (unsigned long long)(ls_t1 - ls_t0));\n"
     "    atomicAdd(&ls_clk[1], (unsigned long long)(end - ls_t2));\n"
     "    atomicAdd(&ls_clk[2], (unsigned long long)(end - ls_t0));\n  }\n}"),
]

#: the parent tree's source (a block of 8 threads, the state loaded four
#: bytes a thread)
PARENT_EDITS = [
    ("namespace ls {\n\nconstexpr int kStack",
     COUNTERS + "namespace ls {\n\nconstexpr int kStack"),
    (("// the lane until it halts or has taken max_steps steps",
      "// The batch's global layout"),
     run_lane("L.pc >= P.code_len ? 0 : P.code[clampi(L.pc, 0, P.bucket - 1)]",
              "pops(op)", "L.words && group_leader()", False) + "\n"),
    ("  const int t = threadIdx.x;  // the limb\n",
     "  const int t = threadIdx.x;  // the limb\n"
     "  const long long ls_t0 = clock64();\n"),
    ("  for (int k = t; k < kMemory / 4; k += kLimbs) mem_s[k] = mem_g[k];\n"
     "  __syncwarp(0xFFu);\n",
     "  for (int k = t; k < kMemory / 4; k += kLimbs) mem_s[k] = mem_g[k];\n"
     "  __syncwarp(0xFFu);\n  const long long ls_t1 = clock64();\n"),
    ("  run_lane(L, P, max_steps);\n  __syncwarp(0xFFu);\n",
     "  run_lane(L, P, max_steps);\n  const long long ls_t2 = clock64();\n"
     "  __syncwarp(0xFFu);\n"),
    ("    io.steps[lane] = L.steps;\n  }\n}",
     "    io.steps[lane] = L.steps;\n"
     "    const long long end = clock64();\n"
     "    atomicAdd(&ls_clk[0], (unsigned long long)(ls_t1 - ls_t0));\n"
     "    atomicAdd(&ls_clk[1], (unsigned long long)(end - ls_t2));\n"
     "    atomicAdd(&ls_clk[2], (unsigned long long)(end - ls_t0));\n  }\n}"),
]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="another tree of this repository "
                        "whose lockstep.cu is instrumented beside this one")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("lockstep_clocks: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mythril_tpu_torch.ops import lockstep as LS

    import lockstep_times as T

    card = cs.card_line()
    own = open(LS.SOURCE).read()
    jobs = {"this tree": T.variant_source(
        "clocks", T.apply_edits(own, EDITS) + READER)}
    parent = T.load_parent(opts.parent) if opts.parent else None
    if parent is not None:
        jobs[T.PARENT] = T.variant_source("clocks_parent", T.apply_edits(
            open(parent.SOURCE).read(), PARENT_EDITS) + READER)
    T.compile_all({name: (src, src[:-3] + ".so")
                   for name, src in jobs.items()}, required=tuple(jobs))
    libs = {}
    for name, src in jobs.items():
        lib = (parent.bind if name == T.PARENT else LS.bind)(src[:-3] + ".so")
        lib.lockstep_clocks.argtypes = [ctypes.c_void_p]
        lib.lockstep_clocks.restype = ctypes.c_int
        libs[name] = lib
    LS._lib = libs["this tree"]  # the capture's launches: counters reset below

    path = T.main_path_cases()
    cases = [next(c for c in path if c[0].startswith("vault_withdraw")),
             next(c for c in path if c[0].endswith("transaction 2")),
             T.gauntlet_case(1024, 1024)]
    for case in cases:
        label, program, state, max_steps, record = case
        want = LS.run_plain(program, state, max_steps, record)
        B = state.pc.shape[0]
        for name, lib in libs.items():
            if name == T.PARENT:
                parent._lib = lib
                launch = T.ParentLaunch(parent, case)
            else:
                launch = T.Launch(lib, case)
            buf = (ctypes.c_ulonglong * SLOTS)()
            if lib.lockstep_clocks(buf) or launch():
                print(f"{label}, {name}: launch failed", file=sys.stderr)
                return 1
            torch.cuda.synchronize()
            if lib.lockstep_clocks(buf):
                print(f"{label}, {name}: clocks not read", file=sys.stderr)
                return 1
            if not T.held(launch.outputs(), want):
                print(f"{label}, {name}: differs from the plain version",
                      file=sys.stderr)
                return 1
            per = [v / B for v in buf]
            cycles = per[OPS:OPS + 256]
            steps = per[COUNTS:COUNTS + 256]
            classes = {c: [sum(steps[o] for o in ops),
                           sum(cycles[o] for o in ops)]
                       for c, ops in CLASSES.items()}
            classed = {o for ops in CLASSES.values() for o in ops}
            classes["rest"] = [sum(steps[o] for o in range(256)
                                   if o not in classed),
                               sum(cycles[o] for o in range(256)
                                   if o not in classed)]
            top = sorted(range(256), key=lambda o: -cycles[o])[:14]
            if name == T.PARENT:
                launch.prepare(5)
            ms = T.event_ms(launch, 5)
            print(json.dumps({
                "case": label, "tree": name, "lanes": B, "steps": want[2],
                "prologue": per[PROLOGUE],
                "step loop by class [steps, cycles]": classes,
                "epilogue": per[EPILOGUE], "whole": per[WHOLE],
                "top opcodes [steps, cycles a step]": {
                    NAMES.get(o, f"0x{o:02x}"): [
                        steps[o], cycles[o] / steps[o] if steps[o] else 0]
                    for o in top if cycles[o]},
                "ms": sorted(ms)[len(ms) // 2],
            }), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
