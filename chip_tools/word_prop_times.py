#!/usr/bin/env python3
"""Device times of the word tier's fixpoint kernel (``word_prop``) and of
its design variants, on the word tier's own inputs: seeded random term
DAGs (``frontiers.word_dag_lanes``) at 16, 64 and 256 lanes, the
programs of the chip check's two main-path frontiers (the ``scale_mul``
d6 tree and the guard chain, 64 lanes each, lowered as the word tier
lowers them), a DAG with every opcode (``frontiers.word_opcode_lanes``),
a push-down to depth 8 (``frontiers.word_deep_lanes``) and a program at
the node cap of 1024 nodes over 256 lanes (``frontiers.word_cap_lanes``).

Run on the card from the repository root::

    python3 chip_tools/word_prop_times.py [--parent DIR]

Builds ``ops/csrc/word_prop.cu`` as the wrapper loads it and, beside it,
its design variants, each the source under named edits (``VARIANTS``: 1,
2, 4, 8 or 32 warps sharing a lane in place of 16; four lanes a block,
one a group of each warp, in place of one; the planes kept in global
memory in place of shared memory) and, with ``--parent DIR``, the
``word_prop.cu`` of another tree of this repository as it is, all with
the package's ``nvcc`` flags in parallel (``-Xptxas -v`` printed for
each).  Every library's launch is held bit
for bit (planes, tri-states, conflicts) against ``word_fixpoint_plain``,
run once a case on the host's CPU, before it is timed; a variant whose
block does not fit the card's shared memory is reported as not
launched.  Times are CUDA events around 10 bare launches, in turns:
parent, as built, the variants, as built, parent.  Prints the card line,
then one JSON line a case and library, and per library the sums over the
main-path programs.  Exits non-zero without a card or when a launch
differs.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BUILT = "as built"
PARENT = "parent tree"

# Design variants of the kept kernel, each a list of named source edits:
# (old, new) replaces text found exactly once; ((start, end), new)
# replaces the text from ``start`` up to ``end``, each found once.

def _warps(n):
    return [("constexpr int kWarps = 16;", f"constexpr int kWarps = {n};")]


#: the lane's planes in the global [slot][field][limb][lane] layout, read
#: and written in place (no shared-memory copy, no write-back)
GLOBAL_PLANES = [
    ("  const int8_t* want0;     // [nbool]\n  bool conflict;\n",
     "  const int8_t* want0;     // [nbool]\n  int B;\n  bool conflict;\n"),
    ("    uint4 q = reinterpret_cast<const uint4*>(bv)[E(e)[C_SLOT] * 8 "
     "+ limb_id()];\n    r.lo = q.x; r.hi = q.y; r.km = q.z; r.kv = q.w;\n",
     "    const uint32_t* p = bv + ((size_t)E(e)[C_SLOT] * 32 + limb_id()) "
     "* B;\n    r.lo = p[0]; r.hi = p[(size_t)8 * B];\n"
     "    r.km = p[(size_t)16 * B]; r.kv = p[(size_t)24 * B];\n"),
    ("    reinterpret_cast<uint4*>(bv)[E(e)[C_SLOT] * 8 + limb_id()] =\n"
     "        make_uint4(a.lo, a.hi, a.km, a.kv);\n",
     "    uint32_t* p = bv + ((size_t)E(e)[C_SLOT] * 32 + limb_id()) * B;\n"
     "    p[0] = a.lo; p[(size_t)8 * B] = a.hi;\n"
     "    p[(size_t)16 * B] = a.km; p[(size_t)24 * B] = a.kv;\n"),
    ("size_t lane = (size_t)(n - nbool) * 128 + 4 + 3 * (size_t)nbool;",
     "size_t lane = 4 + 3 * (size_t)nbool;"),
    ("int* table = (int*)(planes + (size_t)nbv * 32);",
     "int* table = (int*)planes;"),
    ("  lw.bv = planes;\n", "  lw.bv = bv + lane;\n  lw.B = B;\n"),
    (("  for (int row = tid; row < nbv * 32; row += kThreads) {",
      "  for (int s = tid; s < nbool; s += kThreads) {\n    tri["), ""),
]

#: four lanes a block, one a group of 8 threads of each warp (the warp's
#: four groups each walk their own lane)
FOUR_LANES = [
    ("  return lane + (size_t)n * C_COUNT * 4;",
     "  return 4 * lane + (size_t)n * C_COUNT * 4;"),
    ("word_prop_kernel<<<B, wp::kThreads,",
     "word_prop_kernel<<<(B + 3) / 4, wp::kThreads,"),
    (("  const bool worker = (tid & 31) < kLimbs;",
      "\nextern \"C\" {\n\n// Plain C entry point"),
     """  const int g = (tid >> 3) & 3;  // the warp's group, and its lane
  const int lane0 = blockIdx.x * 4;
  const int lanes_here = min(4, B - lane0);
  const bool worker = g < lanes_here;
  uint32_t* planes = smem;
  int* table = (int*)(planes + (size_t)4 * nbv * 32);
  int* conflict_s = table + n * C_COUNT;
  int8_t* tri_s = (int8_t*)(conflict_s + 4);
  int8_t* want_s = tri_s + 4 * nbool;
  int8_t* want0_s = want_s + 4 * nbool;

  for (int k = tid; k < n * C_COUNT; k += kThreads) table[k] = entries[k];
  for (int k = tid; k < 4 * nbool; k += kThreads) {
    int gl = k & 3, s = k >> 2;
    want0_s[gl * nbool + s] =
        gl < lanes_here ? want0[(size_t)s * B + lane0 + gl] : 0;
  }
  if (tid < 4) conflict_s[tid] = 0;
  __syncthreads();

  Lane lw;
  lw.entries = table;
  lw.args = args;
  lw.consts = consts;
  lw.bv = planes + (size_t)g * nbv * 32;
  lw.tri = tri_s + g * nbool;
  lw.want = want_s + g * nbool;
  lw.want0 = want0_s + g * nbool;
  lw.conflict = false;
  for (int pass = 0; pass <= 2 * rounds; ++pass) {
    if (pass & 1) {
      if (warp == 0 && worker) backward(lw, n, nbool);
      __syncthreads();
      continue;
    }
    for (int k = 0; k < n;) {
      const int end = table[k * C_COUNT + C_LEVEL_END];
      if (worker)
        for (int j = k + warp; j < end; j += kWarps)
          forward_node(lw, table[j * C_COUNT + C_SCHED], pass == 0);
      __syncthreads();
      k = end;
    }
  }
  if (worker && lw.conflict) conflict_s[g] = 1;
  __syncthreads();

  const size_t rows = (size_t)nbv * 32;
  for (size_t k = tid; k < rows * lanes_here; k += kThreads) {
    int gl = (int)(k % lanes_here);
    size_t row = k / lanes_here;  // (slot * 4 + field) * 8 + limb
    size_t slot = row >> 5;
    int field = (int)(row >> 3) & 3, limb = (int)row & 7;
    bv[row * B + lane0 + gl] =
        planes[((size_t)gl * nbv + slot) * 32 + limb * 4 + field];
  }
  for (int k = tid; k < nbool * lanes_here; k += kThreads) {
    int gl = k % lanes_here, s = k / lanes_here;
    tri[(size_t)s * B + lane0 + gl] = tri_s[gl * nbool + s];
    want[(size_t)s * B + lane0 + gl] = want_s[gl * nbool + s];
  }
  if (tid < lanes_here) conflict[lane0 + tid] = conflict_s[tid] ? 1 : 0;
}
"""),
]

#: design variants: name -> named edits of the tree's source
VARIANTS = {
    "one warp a lane": _warps(1),
    "two warps a lane": _warps(2),
    "four warps a lane": _warps(4),
    "eight warps a lane": _warps(8),
    "thirty-two warps a lane": _warps(32),
    "four lanes a block (a warp's four groups)": FOUR_LANES,
    "planes in global memory": GLOBAL_PLANES,
}


def apply_edits(text, edits):
    """``text`` under ``edits``; raises if an edit's text is not found
    exactly once."""
    for old, new in edits:
        if isinstance(old, tuple):
            start, end = old
            if text.count(start) != 1 or text.count(end) != 1:
                raise RuntimeError(f"edit span not found once: {start!r}")
            i, j = text.index(start), text.index(end)
            if j < i:
                raise RuntimeError(f"edit span reversed: {start!r}")
            text = text[:i] + new + text[j:]
        else:
            if text.count(old) != 1:
                raise RuntimeError(f"edit not found once: {old[:60]!r}")
            text = text.replace(old, new)
    return text


def edited_source(name, edits):
    """The tree's ``word_prop.cu`` under ``edits``, written into
    ``_build/variants/``; its path."""
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import word_fixpoint as WF

    out_dir = os.path.join(ds.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"word_prop_{name}.cu")
    with open(path, "w") as f:
        f.write(apply_edits(open(WF.SOURCE).read(), edits))
    return path


#: the cases summed per library: the main path's two programs
MAIN_PATH = ("main path scale_mul d6 g16", "main path guard chain 64x32")


def build(parent):
    """The variants' and the parent's libraries, compiled in parallel
    into ``_build/variants/``; name -> bound library."""
    from mythril_tpu_torch.ops import dense_sweep as ds

    out_dir = os.path.join(ds.BUILD_DIR, "variants")
    jobs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        jobs[name] = (edited_source(f"v{i}", edits),
                      os.path.join(out_dir, f"libword_prop_v{i}.so"))
    if parent:
        jobs[PARENT] = (os.path.join(parent, "mythril_tpu_torch", "ops",
                                     "csrc", "word_prop.cu"),
                        os.path.join(out_dir, "libword_prop_parent.so"))
    procs = {name: subprocess.Popen(
        [ds._nvcc(), *ds.NVCC_FLAGS, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, lib) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{text}")
        print(json.dumps({"library": name, "ptxas": ptxas_lines(text)}),
              flush=True)
        libs[name] = bind_bare(jobs[name][1])
    return libs


def ptxas_lines(text):
    return " | ".join(line.strip() for line in text.splitlines()
                      if "registers" in line or "spill" in line
                      or "smem" in line or "stack" in line)


def bind_bare(path):
    """``word_prop_launch`` and ``word_prop_entry_columns``: the entry
    points every tree's library has with the same arguments."""
    lib = ctypes.CDLL(path)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.word_prop_launch.argtypes = [ptr, c_int, ptr, ptr, ptr, c_int,
                                     c_int, c_int, ptr, ptr, ptr, ptr, ptr]
    lib.word_prop_launch.restype = c_int
    lib.word_prop_entry_columns.restype = c_int
    return lib


class Launch:
    """One case's bare launch with one library: the wrapper's arguments,
    its output buffers, and their reading in ``word_fixpoint``'s form."""

    def __init__(self, lib, table, want0, rounds):
        import torch

        self.lib, self.table, self.want0, self.rounds = (lib, table, want0,
                                                         rounds)
        self.B = want0.shape[1]
        dev = want0.device
        # a library reads as many columns of a row as its table has (a
        # parent tree's may have fewer)
        self.entries = table.entries[:, :lib.word_prop_entry_columns()]
        self.entries = self.entries.contiguous()
        self.consts = table.consts.to(torch.int32).contiguous()
        self.bv = torch.zeros((max(table.n_bv, 1) * 32, self.B),
                              dtype=torch.int32, device=dev)
        self.tri = torch.zeros((table.n_bool, self.B), dtype=torch.int8,
                               device=dev)
        self.want = torch.zeros_like(self.tri)
        self.conflict = torch.zeros((self.B,), dtype=torch.bool, device=dev)
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def __call__(self):
        t = self.table
        return self.lib.word_prop_launch(
            self.entries.data_ptr(), t.n_bv + t.n_bool, t.args.data_ptr(),
            self.consts.data_ptr(), self.want0.data_ptr(), self.B,
            t.n_bool, self.rounds, self.bv.data_ptr(), self.tri.data_ptr(),
            self.want.data_ptr(), self.conflict.data_ptr(), self.stream)

    def outputs(self):
        from mythril_tpu_torch.ops import u256

        n_bv = self.table.n_bv
        planes = (self.bv[: n_bv * 32].view(n_bv, 4, u256.NUM_LIMBS, self.B)
                  .permute(3, 0, 1, 2).to(u256.DTYPE)
                  & u256.MASK32)
        return planes.cpu(), self.tri.t().cpu(), self.conflict.cpu()


def cases():
    """(label, lanes) of every timed case."""
    import chip_smoke as cs
    from mythril_tpu_torch import frontiers

    def frontier(build_fn):
        lanes, _ = build_fn()
        return [[c.raw for c in lane] for lane in lanes]

    out = [(f"random DAG seed {seed}, {lanes} lanes, widths {widths}",
            frontiers.word_dag_lanes(seed, lanes, widths))
           for seed, lanes, widths in cs.WORD_DAGS]
    out += [
        ("main path scale_mul d6 g16",
         frontier(lambda: frontiers.scale_mul_frontier(6, 16))),
        ("main path guard chain 64x32",
         frontier(lambda: frontiers.guard_chain_frontier(64, 32))),
    ]
    out += [(label, build_fn()) for label, build_fn in cs.WORD_EDGE_CASES]
    return out


def main() -> int:
    import torch

    import chip_smoke as cs

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="another tree of this repository "
                        "whose word_prop.cu is timed beside this one")
    parser.add_argument("--iters", type=int, default=10)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("word_prop_times: no CUDA device", file=sys.stderr)
        return 2
    from mythril_tpu_torch.ops import word_fixpoint as WF
    from mythril_tpu_torch.smt.word_tier import WORD_ROUNDS

    card = cs.card_line()
    started = time.perf_counter()
    WF.load_library()
    print(f"build word_prop.cu {time.perf_counter() - started:.1f} s",
          flush=True)
    if WF.build_info is not None:
        print(json.dumps({"library": BUILT,
                          "ptxas": ptxas_lines(WF.build_info[1])}),
              flush=True)
    libs = {BUILT: WF.load_library()}
    libs.update(build(opts.parent))
    variants = [name for name in libs if name not in (BUILT, PARENT)]
    order = ([PARENT] if PARENT in libs else []) + [BUILT] + variants + \
        [BUILT] + ([PARENT] if PARENT in libs else [])
    sums = {}
    for label, lanes in cases():
        table_host, want0_host, rounds = cs.word_inputs(lanes, WORD_ROUNDS)
        t0 = time.perf_counter()
        plain = WF.word_fixpoint_plain(table_host, want0_host, rounds)
        plain_s = time.perf_counter() - t0
        table, want0 = table_host.to("cuda"), want0_host.to("cuda")
        bound_ms, bound_by = cs.word_bound(table, want0.shape[1], rounds)
        runs = {}
        for name in order:
            launch = Launch(libs[name], table, want0, rounds)
            if name not in runs:
                err = launch()
                torch.cuda.synchronize()
                if err:
                    runs[name] = None
                    print(json.dumps({"case": label, "library": name,
                                      "launched": False, "cudaError": err}),
                          flush=True)
                    continue
                for part, g, w in zip(("planes", "tri", "conflict"),
                                      launch.outputs(), plain):
                    if g.shape != w.shape or not torch.equal(g, w):
                        print(f"{label}, {name}: {part} differs from the "
                              f"plain version", file=sys.stderr)
                        return 1
                runs[name] = []
            if runs[name] is None:
                continue
            runs[name].append(cs.cuda_ms(launch, opts.iters))
        for name, times in runs.items():
            row = {"case": label, "library": name,
                   "nodes": table.n_bv + table.n_bool, "bv": table.n_bv,
                   "bool": table.n_bool, "lanes": want0.shape[1],
                   "conflicts": int(plain[2].sum()), "ms": times,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "plain_cpu_s": plain_s, "held": times is not None}
            print(json.dumps(row), flush=True)
            if label in MAIN_PATH and times:
                sums.setdefault(name, []).append(min(times))
    for name, times in sums.items():
        print(json.dumps({"library": name, "main path ms (sum of the "
                          "best of each program)": sum(times),
                          "programs": len(times)}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
