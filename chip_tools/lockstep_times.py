#!/usr/bin/env python3
"""Device times of the lockstep kernel (``ops/csrc/lockstep.cu``) and of
its design variants, on the main path's own launches and the gauntlet.

Run on the card from the repository root::

    python3 chip_tools/lockstep_times.py [--parent DIR] [--iters N]

Builds ``ops/csrc/lockstep.cu`` as the wrapper loads it and, beside it,
its design variants, each the source under named edits (``VARIANTS``:
the code and JUMPDEST bits read through the read-only path, never
staged in shared memory; the limbs narrowed to 32 bits in shared memory
by 16-byte loads and widened out by 16-byte stores; the division's
digit steps on the group of 8 threads; EXP by each thread on the whole
words; the visited bit set by every thread of the group; the bulk
stores awaited only until shared memory has been read; a block of 8
threads), with
``--parent DIR`` the ``lockstep.cu`` of another tree of this repository
with that tree's own wrapper (``ops/lockstep.py``), and an empty kernel,
all with the package's ``nvcc`` flags in parallel (``-Xptxas -v``
printed for each, and each library's blocks per SM from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at each case's shared
memory).

The cases: the main path's launches, captured as the path makes them
(the dispatcher pre-split's validation of ``vault_withdraw``, 2 lanes,
and of the 64-selector ``contracts.wide_dispatcher``, 64 lanes; each
transaction of the ``batchtoken`` replay of ``chip_smoke.py``, 1 lane),
and the gauntlet (``contracts.lockstep_gauntlet``) at 1,024 lanes x
1,024 steps and 4,096 x 4,096, calldata from a numpy seed.  Every
library's first launch of a case is held bit for bit (every state field,
the visited words, the loop count) against ``run_plain``, run once a
case on the card, before it is timed.  Times are CUDA events around each
of ``--iters`` bare launches, in turns: parent, as built, the variants,
as built, parent; once on an idle stream (the time then holds the
host's enqueue, as the main path meets it) and once with a spin kernel
ahead of each start event (the device's time alone); the parent's
launches each on a fresh copy of their inputs (its kernel updates the
state in place).  Beside them: an empty kernel on the same grid (the
launch floor, timed both ways), the host wall of one
``run_batch`` call ending in ``torch.cuda.synchronize()`` for this
tree's wrapper and the parent's, and the device operations the profiler
records in one such call.  Prints the card line last; exits non-zero
without a card or when a launch differs.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
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

#: the code and the JUMPDEST bits always read from global memory through
#: the read-only path, never staged in shared memory
READ_ONLY_CODE = [
    ("constexpr int kStagedBucket = 4096;", "constexpr int kStagedBucket = 0;"),
    ("// staged, else global\n#define LS_LDG(x) (x)",
     "// staged, else global\n#define LS_LDG(x) __ldg(&(x))"),
]

#: the limbs narrowed to 32 bits in shared memory (8.3 KB a lane): every
#: 16-byte load of the int64 rows issued before any is narrowed, and the
#: rows widened out by 16-byte stores, in place of their bulk copies
NARROW_LIMBS = [
    ("typedef uint64_t Limb;", "typedef uint32_t Limb;"),
    ("\"r\"(kLimbBytes + kMemory + C + kSlots", "\"r\"(kMemory + C + kSlots"),
    (("  bulk_in(S.stack, in.stack", "  bulk_in(S.mem, in.memory"), ""),
    (("  bulk_out(out.stack", "  bulk_out(out.memory"), ""),
    ("}  // namespace ls\n\n__global__", """// in (every thread): the int64 limbs, each 16-byte load issued before any
// is narrowed into the 32-bit limbs
LS_FN void load_limbs(const Smem& S, const State& in, int lane) {
  const int t = threadIdx.x;
  const ulonglong2* gs =
      reinterpret_cast<const ulonglong2*>(in.stack + (size_t)lane * kStack * kLimbs);
  const ulonglong2* gk =
      reinterpret_cast<const ulonglong2*>(in.skeys + (size_t)lane * kSlots * kLimbs);
  const ulonglong2* gv =
      reinterpret_cast<const ulonglong2*>(in.svals + (size_t)lane * kSlots * kLimbs);
  const ulonglong2* gw = reinterpret_cast<const ulonglong2*>(
      t < 4 ? in.callvalue + (size_t)lane * kLimbs + 2 * t
            : in.caller + (size_t)lane * kLimbs + 2 * (t & 3));
  constexpr int kS = kStack * kLimbs / 2 / kThreads;
  constexpr int kK = kSlots * kLimbs / 2 / kThreads;
  ulonglong2 s[kS], k[kK], v[kK], w;
#pragma unroll
  for (int r = 0; r < kS; ++r) s[r] = __ldg(gs + t + kThreads * r);
#pragma unroll
  for (int r = 0; r < kK; ++r) {
    k[r] = __ldg(gk + t + kThreads * r);
    v[r] = __ldg(gv + t + kThreads * r);
  }
  if (t < 8) w = __ldg(gw);
  uint2* ss = reinterpret_cast<uint2*>(S.stack);
  uint2* ks = reinterpret_cast<uint2*>(S.keys);
  uint2* vs = reinterpret_cast<uint2*>(S.vals);
#pragma unroll
  for (int r = 0; r < kS; ++r)
    ss[t + kThreads * r] = make_uint2((uint32_t)s[r].x, (uint32_t)s[r].y);
#pragma unroll
  for (int r = 0; r < kK; ++r) {
    ks[t + kThreads * r] = make_uint2((uint32_t)k[r].x, (uint32_t)k[r].y);
    vs[t + kThreads * r] = make_uint2((uint32_t)v[r].x, (uint32_t)v[r].y);
  }
  // the value's limbs, then the caller's
  if (t < 8) reinterpret_cast<uint2*>(S.value)[t] = make_uint2((uint32_t)w.x, (uint32_t)w.y);
}

// out (every thread): the 32-bit limbs widened, 16 bytes a store
LS_FN void store_limbs(const Smem& S, const Out& out, int lane) {
  const int t = threadIdx.x;
  ulonglong2* gs = reinterpret_cast<ulonglong2*>(out.stack + (size_t)lane * kStack * kLimbs);
  ulonglong2* gk = reinterpret_cast<ulonglong2*>(out.skeys + (size_t)lane * kSlots * kLimbs);
  ulonglong2* gv = reinterpret_cast<ulonglong2*>(out.svals + (size_t)lane * kSlots * kLimbs);
  const uint2* ss = reinterpret_cast<const uint2*>(S.stack);
  const uint2* ks = reinterpret_cast<const uint2*>(S.keys);
  const uint2* vs = reinterpret_cast<const uint2*>(S.vals);
#pragma unroll
  for (int r = 0; r < kStack * kLimbs / 2 / kThreads; ++r) {
    const uint2 x = ss[t + kThreads * r];
    gs[t + kThreads * r] = make_ulonglong2(x.x, x.y);
  }
#pragma unroll
  for (int r = 0; r < kSlots * kLimbs / 2 / kThreads; ++r) {
    const uint2 x = ks[t + kThreads * r], y = vs[t + kThreads * r];
    gk[t + kThreads * r] = make_ulonglong2(x.x, x.y);
    gv[t + kThreads * r] = make_ulonglong2(y.x, y.y);
  }
}

}  // namespace ls

__global__"""),
    ("  if (t == 0) load_bulk(S, in, P, lane, C);\n",
     "  if (t == 0) load_bulk(S, in, P, lane, C);\n  load_limbs(S, in, lane);\n"),
    ("  if (t == 0) store_bulk(S, out, lane);\n",
     "  if (t == 0) store_bulk(S, out, lane);\n  store_limbs(S, out, lane);\n"),
]

#: Algorithm D with the digit steps on the group of 8 (the window a limb a
#: thread, the multiply-subtract's borrows and the add-back's carries by
#: ballot) in place of each thread dividing the whole words; a one-limb
#: divisor keeps the short division
GROUP_DIVISION = [
    (("LS_COLD QR u_udivmod(U a, U b) {", "LS_FN U u_abs(U a, bool* negative) {"),
     """LS_FN U u_sub_out(U a, U b, uint32_t* borrow) {
  U d = a - b;
  unsigned c = carries(ballot(a < b), ballot(d == 0u));
  *borrow = (c >> 8) & 1u;
  return d - ((splat(c) >> limb_id()) & 1u);
}
LS_FN U u_add_out(U a, U b, uint32_t* carry) {
  U s = a + b;
  unsigned c = carries(ballot(s < a), ballot(s == 0xFFFFFFFFu));
  *carry = (c >> 8) & 1u;
  return s + ((splat(c) >> limb_id()) & 1u);
}
LS_COLD QR u_udivmod(U a, U b) {
  if (!u_any(b)) return QR{u_zero(), u_zero()};
  const int n = (u_bit_length(b) + 31) >> 5;
  if (n == 1) {
    uint32_t aw[8], bw[8], qw[8], rw[8];
    words_of(a, aw);
    words_of(b, bw);
    divmod_words(aw, bw, qw, rw);
    return QR{word_from(qw), word_from(rw)};
  }
  const U i = limb_id();
  const int k = 32 * (8 - n) + (int)clz32(uniform(shfl(b, splat((uint32_t)(n - 1)))));
  const U v = u_shl(b, k);
  U lo = u_shl(a, k), hi = k ? u_lshr(a, 256 - k) : u_zero();  // u[0..7], u[8..15]
  const uint32_t v7 = uniform(shfl(v, splat(7u))), v6 = uniform(shfl(v, splat(6u)));
  U q = u_zero();
  for (int j = 7; j >= 0; --j) {
    const U w = sel(i + (uint32_t)j < 8u, shfl(lo, (i + (uint32_t)j) & 7u),
                    shfl(hi, (i + (uint32_t)j) & 7u));  // u[j..j+7]
    const uint32_t top = uniform(shfl(hi, splat((uint32_t)j)));
    const uint32_t next = uniform(shfl(w, splat(7u))), next2 = uniform(shfl(w, splat(6u)));
    if (top == 0 && next < v7) continue;
    const uint64_t num = ((uint64_t)top << 32) | next;
    uint64_t qhat = num / v7, rhat = num - qhat * v7;
    while ((qhat >> 32) || qhat * v6 > ((rhat << 32) | next2)) {
      --qhat;
      rhat += v7;
      if (rhat >> 32) break;
    }
    const uint32_t ql = (uint32_t)qhat;
    const U plo = splat(ql) * v;
    const U phi = mul_hi(splat(ql), v) + ((qhat >> 32) ? v : u_zero());
    uint32_t b1, b2;
    U d = u_sub_out(w, plo, &b1);
    d = u_sub_out(d, sel(i >= 1u, shfl_up(phi, 1), u_zero()), &b2);
    const int64_t t = (int64_t)top - uniform(shfl(phi, splat(7u))) - b1 - b2;
    uint32_t ntop = (uint32_t)t;
    if (t < 0) {
      LS_HOST_COUNT(host_addbacks());
      --qhat;
      uint32_t c;
      d = u_add_out(d, v, &c);
      ntop += c;
    }
    lo = sel(i >= (uint32_t)j, shfl(d, (i - (uint32_t)j) & 7u), lo);
    hi = sel(i < (uint32_t)j, shfl(d, (i + 8u - (uint32_t)j) & 7u),
             sel(i == (uint32_t)j, splat(ntop), hi));
    q = sel(i == (uint32_t)j, splat((uint32_t)qhat), q);
  }
  return QR{q, u_lshr(lo, k)};
}
"""),
]

#: EXP by each thread of the group on the whole words in registers (a
#: schoolbook product by 32-bit limbs, no collective) in place of the
#: group's column products
SERIAL_EXP = [
    (("// a ** e mod 2^256, square-and-multiply up to e's top set bit",
      "// ---------------------------------------------------------------- words"),
     """// r = a * b mod 2^256 on whole words, by rows
LS_FN void mul_words(const uint32_t* a, const uint32_t* b, uint32_t* r) {
  uint32_t t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; i + j < 8; ++j) {
      const uint64_t p = (uint64_t)a[i] * b[j] + t[i + j] + carry;
      t[i + j] = (uint32_t)p;
      carry = p >> 32;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = t[k];
}
// a ** e mod 2^256, each thread of the group on the whole words
LS_COLD U u_exp(U a, U e) {
  uint32_t base[8], ew[8], result[8];
  words_of(a, base);
  words_of(e, ew);
  int top = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    result[k] = k == 0 ? 1u : 0u;
    top = ew[k] ? 32 * k + 32 - (int)clz32(ew[k]) : top;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t w = ew[k];
    for (int b = 0; b < 32 && 32 * k + b < top; ++b, w >>= 1) {
      if (w & 1u) mul_words(result, base, result);
      if (32 * k + b + 1 < top) mul_words(base, base, base);
    }
  }
  return word_from(result);
}

"""),
]

#: design variants: name -> (named edits of the tree's source, threads a
#: block)
VARIANTS = {
    "code and JUMPDEST bits through the read-only path": (READ_ONLY_CODE, 32),
    "32-bit limbs in shared memory, narrowed and widened by 16-byte loads "
    "and stores": (NARROW_LIMBS, 32),
    "division steps on the group of 8": (GROUP_DIVISION, 32),
    "EXP by each thread on whole words": (SERIAL_EXP, 32),
    "the visited bit set by every thread of the group": (
        [("    if (L.words && group_leader())\n      L.visited[",
          "    if (L.words)\n      L.visited[")], 32),
    "bulk stores awaited for their reads only": (
        [("cp.async.bulk.wait_group 0;", "cp.async.bulk.wait_group.read 0;")],
        32),
    "a block of 8 threads": (
        [("constexpr int kThreads = 32;", "constexpr int kThreads = 8;")], 8),
}

#: appended to every library: its blocks per SM at a block's threads and
#: dynamic shared memory
PROBE = """
extern "C" int lockstep_probe_blocks_per_sm(int threads, int bytes) {
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lockstep_kernel, threads,
                                                    bytes) != cudaSuccess)
    return -1;
  return n;
}
"""

#: an empty kernel (the launch floor) and a spin of one block (keeps the
#: stream busy while the host enqueues a timed launch)
EMPTY = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
__global__ void spin_kernel(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" int spin_launch(long long cycles, void* stream) {
  spin_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(cycles);
  return (int)cudaGetLastError();
}
"""
#: the spin ahead of a timed launch: about 100 us at the card's clock
SPIN_CYCLES = 200_000


def spin_library():
    """``EMPTY`` built beside the imported package's kernels
    (``_build/libspin.so``, rebuilt when the source changes) and bound:
    ``empty_launch(blocks, threads, stream)`` and ``spin_launch(cycles,
    stream)``."""
    from mythril_tpu_torch.ops import dense_sweep as ds

    os.makedirs(ds.BUILD_DIR, exist_ok=True)
    source = os.path.join(ds.BUILD_DIR, "spin.cu")
    written = None
    if os.path.exists(source):
        with open(source) as f:
            written = f.read()
    if written != EMPTY:  # rewritten only when changed: nvcc's mtime
        with open(source, "w") as f:
            f.write(EMPTY)
    library = os.path.join(ds.BUILD_DIR, "libspin.so")
    ds.build_cuda_library(source, library)
    lib = ctypes.CDLL(library)
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.spin_launch.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    return lib


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


def variant_source(name, text):
    """Write ``text`` as ``_build/variants/lockstep_<name>.cu``; its path."""
    from mythril_tpu_torch.ops import dense_sweep as ds

    out_dir = os.path.join(ds.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"lockstep_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def ptxas_lines(text):
    return " | ".join(line.strip() for line in text.splitlines()
                      if "registers" in line or "spill" in line
                      or "smem" in line or "stack" in line)


def compile_all(jobs, required=()):
    """nvcc of every ``name -> (source, library)`` in parallel; prints
    each one's ``-Xptxas -v`` lines; returns the names that built (raises
    when one of ``required`` did not)."""
    from mythril_tpu_torch.ops import dense_sweep as ds

    procs = {name: subprocess.Popen(
        [ds._nvcc(), *ds.NVCC_FLAGS, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, lib) in jobs.items()}
    built = []
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            if name in required:
                raise RuntimeError(f"{name}: nvcc failed:\n{text}")
            print(json.dumps({"library": name, "built": False,
                              "nvcc": text[-3000:]}), flush=True)
            continue
        built.append(name)
        print(json.dumps({"library": name, "ptxas": ptxas_lines(text)}),
              flush=True)
    return built


def load_parent(tree):
    """The other tree's wrapper module (``ops/lockstep.py``), its library
    path set beside the variants."""
    from mythril_tpu_torch.ops import dense_sweep as ds

    path = os.path.join(tree, "mythril_tpu_torch", "ops", "lockstep.py")
    spec = importlib.util.spec_from_file_location("parent_lockstep", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.LIBRARY = os.path.join(ds.BUILD_DIR, "variants",
                                  "liblockstep_parent.so")
    return module


def build(parent_module):
    """This tree's source, its variants and the parent's source,
    compiled in parallel, each with the probe, and the empty kernel
    (``spin_library``); name -> bound library (the parent's bound by its
    own wrapper, the empty kernel under ``"empty"``; a variant that does
    not build is left out)."""
    from mythril_tpu_torch.ops import lockstep as LS

    own = open(LS.SOURCE).read()
    jobs, texts = {}, {BUILT: own + PROBE}
    for name, (edits, _threads) in VARIANTS.items():
        texts[name] = apply_edits(own, edits) + PROBE
    for i, (name, text) in enumerate(texts.items()):
        src = variant_source(f"v{i}", text)
        jobs[name] = (src, src[:-3] + ".so")
    if parent_module is not None:
        text = open(parent_module.SOURCE).read() + PROBE
        src = variant_source("parent", text)
        jobs[PARENT] = (src, parent_module.LIBRARY)
    built = compile_all(jobs, required=(BUILT, PARENT))
    libs = {"empty": spin_library()}
    for name in built:
        lib_path = jobs[name][1]
        if name == PARENT:
            lib = parent_module.bind(lib_path)
            parent_module._lib = lib
        else:
            lib = LS.bind(lib_path)
        lib.lockstep_probe_blocks_per_sm.argtypes = [ctypes.c_int,
                                                     ctypes.c_int]
        libs[name] = lib
    return libs


class Launch:
    """One case's bare launch with one of this tree's libraries: the
    arguments once (the kernel leaves its inputs as they were)."""

    def __init__(self, lib, case):
        import torch

        from mythril_tpu_torch.ops import lockstep as LS

        label, program, state, max_steps, record = case
        self.lib = lib
        self.out, self.visited, self.count, self.args = LS.launch_args(
            program, state, LS.check_state(state), max_steps, record)
        self.stream = torch.cuda.current_stream().cuda_stream

    def __call__(self):
        return self.lib.lockstep_launch(*self.args, self.stream)

    def outputs(self):
        return self.out, self.visited, int(self.count.item())


class ParentLaunch:
    """One case's bare launches with the parent's library and wrapper:
    each on a fresh copy of the packed inputs (its kernel updates them in
    place), the copies made before the launches (``prepare``)."""

    def __init__(self, module, case):
        import torch

        self.module = module
        self.case = case
        self.stream = torch.cuda.current_stream().cuda_stream
        self.prepare(1)

    def prepare(self, copies):
        _label, program, state, max_steps, record = self.case
        self.runs = [self.module.launch_args(program, state, max_steps,
                                             record) for _ in range(copies)]
        self.next = 0

    def __call__(self):
        args = self.runs[self.next][3]
        self.next += 1
        return self.module._lib.lockstep_launch(*args, self.stream)

    def outputs(self):
        packed, visited, steps, _args = self.runs[0]
        return self.module.launch_results(packed, visited, steps)


def event_ms(launch, iters, spin=None):
    """CUDA events around each of ``iters`` bare launches: the per-launch
    times (ms).  Without ``spin`` each launch starts on an idle stream, so
    its time holds the host's enqueue (as the main path meets it); with
    ``spin`` (a launch of the spin kernel before each start event) the
    stream is busy while the host enqueues, and the time is the device's
    alone."""
    import torch

    events = []
    for _ in range(iters):
        if spin is not None:
            spin()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        err = launch()
        stop.record()
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        events.append((start, stop))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def main_path_cases():
    """The main path's lockstep launches, captured as the path makes them:
    (label, program, state, max_steps, record_visited) each, the state a
    copy of the launch's input."""
    import chip_smoke as cs
    from mythril_tpu_torch import contracts
    from mythril_tpu_torch.analysis.concrete_replay import replay_issue
    from mythril_tpu_torch.disassembler.disassembly import Disassembly
    from mythril_tpu_torch.laser.ethereum import lockstep_dispatch as LD
    from mythril_tpu_torch.ops import lockstep as LS

    cases, label = [], [""]
    real = LS.run_kernel

    def record(program, state, max_steps, record_visited):
        cases.append((label[0], program,
                      LS.EVMState(*(t.clone() for t in state)), max_steps,
                      record_visited))
        return real(program, state, max_steps, record_visited)

    LS.run_kernel = record
    try:
        with cs.rung_args(device=cs.DEVICE):
            for name, code in (
                    ("vault_withdraw", lambda: contracts.fixture(
                        "vault_withdraw")),
                    ("wide dispatcher (64)", contracts.wide_dispatcher)):
                label[0] = f"{name} pre-split validation"
                LD._plan_cache.clear()
                if LD.dispatcher_plan(Disassembly(code())) is None:
                    raise RuntimeError(f"{name}: the pre-split declined")
            label[0] = "batchtoken replay, transaction"
            status = replay_issue(cs.batchtoken_sequence(), bytes.fromhex(
                contracts.batchtoken_contract()))
            if status != "executed":
                raise RuntimeError(f"batchtoken replay: {status}")
    finally:
        LS.run_kernel = real
    labels = [c[0] for c in cases]  # a label of several launches numbered
    return [(f"{c[0]} {labels[:k].count(c[0]) + 1}"
             if labels.count(c[0]) > 1 else c[0], *c[1:])
            for k, c in enumerate(cases)]


def gauntlet_case(lanes, steps, seed=2026):
    """The gauntlet at ``lanes`` x ``steps``, as ``chip_smoke.py`` makes
    it."""
    import numpy as np

    import chip_smoke as cs
    from mythril_tpu_torch import contracts
    from mythril_tpu_torch.ops import lockstep as LS

    program = LS.prepare_program(bytes.fromhex(contracts.lockstep_gauntlet()))
    rng = np.random.default_rng(seed)
    calldata = contracts.gauntlet_calldata(lanes, seed)
    value = rng.integers(0, 1 << 32, size=(lanes, 8), dtype=np.uint64)
    value[::2, 1:] = 0
    caller = rng.integers(0, 1 << 32, size=(lanes, 8), dtype=np.uint64)
    state = LS.init_state(lanes, calldata,
                          np.full(lanes, calldata.shape[1], np.int32),
                          value, caller, device=cs.DEVICE)
    return (f"gauntlet {lanes} lanes x {steps} steps", program, state, steps,
            True)


def held(got, want):
    """Every field, the visited words and the loop count equal."""
    import torch

    return (all(g.dtype == w.dtype and torch.equal(g, w)
                for g, w in zip(got[0], want[0]))
            and torch.equal(got[1], want[1]) and got[2] == want[2])


def host_wall_ms(run, reps=30):
    """Median host ms of ``run()`` ending in ``torch.cuda.synchronize()``,
    after two warm-up calls."""
    import torch

    walls = []
    for k in range(reps + 2):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if k >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def device_ops(run):
    """The device operations (kernels, copies, fills) the profiler
    records in one ``run()``: {name: count}, or None when it records
    none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA}
    return ops or None


def main() -> int:
    import torch

    import chip_smoke as cs

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="another tree of this repository "
                        "whose lockstep.cu and wrapper are timed beside "
                        "this one")
    parser.add_argument("--iters", type=int, default=20)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("lockstep_times: no CUDA device", file=sys.stderr)
        return 2
    from mythril_tpu_torch.ops import lockstep as LS

    card = cs.card_line()
    parent = load_parent(opts.parent) if opts.parent else None
    started = time.perf_counter()
    libs = build(parent)
    print(f"builds {time.perf_counter() - started:.1f} s", flush=True)
    LS._lib = libs[BUILT]
    empty = libs.pop("empty")
    threads = {BUILT: 32, PARENT: 8,
               **{name: v[1] for name, v in VARIANTS.items()}}
    variants = [name for name in libs if name not in (BUILT, PARENT)]
    order = ([PARENT] if parent else []) + [BUILT] + variants + [BUILT] + \
        ([PARENT] if parent else [])

    cases = main_path_cases()
    cases += [gauntlet_case(1024, 1024), gauntlet_case(4096, 4096)]
    stream = torch.cuda.current_stream().cuda_stream

    def spin():
        return empty.spin_launch(SPIN_CYCLES, stream)

    for case in cases:
        label, program, state, max_steps, record = case
        t0 = time.perf_counter()
        want = LS.run_plain(program, state, max_steps, record)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        B, C = LS.check_state(state)
        words = len(program.code) // 32 + 1 if record else 0
        blocks = {}
        for name, lib in libs.items():
            smem = 0 if name == PARENT else lib.lockstep_smem_bytes(
                C, words, len(program.code))
            blocks[name] = lib.lockstep_probe_blocks_per_sm(threads[name],
                                                            smem)
        runs = {}
        for name in order:
            if name not in runs:
                if name == PARENT:
                    launch = ParentLaunch(parent, case)
                else:
                    launch = Launch(libs[name], case)
                err = launch()
                torch.cuda.synchronize()
                if err:
                    print(json.dumps({"case": label, "library": name,
                                      "launched": False, "cudaError": err}),
                          flush=True)
                    runs[name] = None
                    continue
                if not held(launch.outputs(), want):
                    print(f"{label}, {name}: differs from the plain version",
                          file=sys.stderr)
                    return 1
                runs[name] = (launch, ([], []))
            if runs[name] is None:
                continue
            launch, times = runs[name]
            if name == PARENT:
                launch.prepare(2 * opts.iters)
            times[0].extend(event_ms(launch, opts.iters))
            times[1].extend(event_ms(launch, opts.iters, spin))
        floor = [event_ms(lambda: empty.empty_launch(B, 32, stream),
                          opts.iters, s) for s in (None, spin)]
        for name, run in runs.items():
            if run is None:
                continue
            cold, busy = run[1]
            print(json.dumps({
                "case": label, "library": name, "lanes": B,
                "steps": want[2], "bucket": len(program.code),
                "blocks_per_sm": blocks[name],
                "device_ms_median": statistics.median(busy),
                "device_ms_min": min(busy), "device_ms_max": max(busy),
                "cold_ms_median": statistics.median(cold),
                "cold_ms_min": min(cold), "runs": len(busy),
                "empty_kernel_device_ms_median": statistics.median(floor[1]),
                "empty_kernel_cold_ms_median": statistics.median(floor[0]),
                "plain_s": plain_s}), flush=True)
        if B <= 64:  # the main path's launches: the wrapper's host wall
            code = bytes(program.code[: program.length])
            walls = {BUILT: host_wall_ms(lambda: LS.run_batch(
                code, state, max_steps, record))}
            ops = {BUILT: device_ops(lambda: LS.run_batch(
                code, state, max_steps, record))}
            if parent:
                walls[PARENT] = host_wall_ms(lambda: parent.run_batch(
                    code, state, max_steps, record))
                ops[PARENT] = device_ops(lambda: parent.run_batch(
                    code, state, max_steps, record))
            print(json.dumps({"case": label, "run_batch host ms (median)":
                              walls, "device ops in one call": ops}),
                  flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
