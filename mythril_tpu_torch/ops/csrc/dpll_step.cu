// One DPLL step of the dense tier, for every lane, for sm_90a.
//
// Replaces the body of the while_loop in mythril_tpu/ops/pallas_prop.py:592
// (_dpll_round_loop's `rounds`, :649-800): everything a step does after
// the clause sweep.  XLA compiles that body, its loop and the Pallas sweep
// into one device program; here a step is two launches, the sweep
// (csrc/dense_sweep.cu, or torch.bmm for the per-lane layout) and this
// kernel, and the host reads a 4-byte live marker every SYNC_EVERY steps.
// Same function as ops/dpll_step.py:dpll_step_plain, bit for bit:
//
//   masks      free = A == 0 and col > 1; force_pos/neg = f{pos,neg} > 0.5
//              on free; contra = a free column forced both ways;
//              conflict = conf > 0.5 or contra;
//   backtrack  to the deepest unflipped decision Lm (slot Lm - 1): unassign
//              every column assigned at level >= Lm, flip the decision var,
//              pop the slots above, taint the lane when a bulk level is
//              popped or flipped;  no such decision: UNSAT (status 2), or
//              undecided (3) when the lane is tainted;
//   force      forced literals assigned at the pre-step depth;
//   decide     at BCP quiescence: the DLIS score spos + sneg + 1 on free,
//              unforced columns; the top DPLL_BULK_K = 16 in lax.top_k's
//              order (equal scores in ascending column order); one column
//              inside the single-var window (depth < 8) or on a hot view,
//              every positive one of the 16 past it; the phase from the
//              warm-start plane, else the majority polarity; a bulk level
//              when two or more kept scores exceed 1.5; on a full view the
//              don't-care cascade assigns every free column of score 1;
//              the hot gate waits for the full view when no hot clause is
//              open; depth == D bails (3); with decisions off (no scores)
//              every would-be decision bails;
//   complete   quiet and fully assigned on a full view: SAT candidate (1).
//
// Every transition reads the pre-step state: the block reads and reduces
// its lane, then passes a barrier, then writes.  Values that cross threads
// are integer OR / max, or a 64-bit key max (score, then column), so the
// result does not depend on the order threads run in.  Steps on a lane
// that is not live (status != 0) change nothing but the sweep outputs'
// rows, which the kernel zeroes (with `clear`) so that the round's sweep
// workspace is zero for the next sweep.  flags[1] = max(step + 1) over
// lanes live before the step (the JAX loop's step count) and flags[0] =
// max(step + 1) over lanes live after it (the host's loop condition).
//
// Design.  One block of kThreads threads a lane; each thread owns the
// columns tid, tid + kThreads, ... of the lane's [V] rows and the slots
// tid, tid + kThreads, ... of its [D] rows.  Pass 1 reads A and the sweep
// outputs once, keeps the score row in shared memory (V floats, with
// decisions on) and reduces the lane's flags, Lm and its deepest bulk
// slot; thread 0 then decides the lane's transition.  A deciding lane
// takes its top-K by up to 16 block-wide maxima over the shared score row,
// each below the last winner's key; the kept columns are marked in the
// row.  Pass 2 re-reads the lane's rows (from L2) and writes only the
// cells that change, and zeroes the nonzero sweep cells.
//
// Bound at the check's shape (B = 64, V = 4096, D = 1024, decisions on):
// the [B, V] rows it must read (A and four sweep planes, 5.2 MiB) and the
// cells it writes; ~2 µs at 3.35 TB/s.  The work is a few operations a
// cell, so the step is memory-bound; the grid is only B blocks wide,
// which leaves SMs idle at B = 64 and is a matter for a later design.
//
// Compiled as host C++ (no __CUDACC__), the same phases run on an
// emulated block: each phase runs its threads one after another, and the
// phases follow each other as the barriers order them (dpll_step_host),
// so the CPU tests hold the kernel's own code against the plain version.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DS_FN __device__ __forceinline__
#else
#include <cstring>
#include <vector>
#define DS_FN static inline
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kBulkK = 16;          // DPLL_BULK_K
constexpr int kSingleWindow = 8;    // DPLL_SINGLE_WINDOW
constexpr int kMaxScoreCols = 32768;  // shared score row: 128 KiB
constexpr uint32_t kChosen = 0x7f800000u;  // +inf marks a kept column

struct Planes {
  float* A;
  int* lvl;
  int* dvar;
  float* dphase;
  float* dflip;
  float* dbulk;
  int* depth;
  int* status;
  float* taint;
  int* active;
  const float* pref;
  float* fpos;
  float* fneg;
  float* conf;
  float* spos;
  float* sneg;
  int* flags;
};

struct Config {
  int B, V, D, step, full_view, hot_gate, decisions, clear;
};

// the block's view of its lane (shared memory on the card)
struct Lane {
  int live, depth, status;
  float taint, conf;
  int contra, has_force, open_any, hot_open, Lm, maxbulk;
  int do_bt, do_force, want, bail, unsat_now, topk, in_bulk, bslot, bvar;
  float bphase, taint1;
  unsigned long long prev, best;
  int rounds, nwin, done;
  int win_col[kBulkK];
  float win_val[kBulkK];
  int do_dec, primary;
  float phase, is_bulk;
};

DS_FN uint32_t bits(float f) {
#ifdef __CUDACC__
  return __float_as_uint(f);
#else
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  return u;
#endif
}

DS_FN float from_bits(uint32_t u) {
#ifdef __CUDACC__
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, sizeof(f));
  return f;
#endif
}

// larger key = larger score, then smaller column (lax.top_k's order);
// every column's key is nonzero, so 0 means "none"
DS_FN unsigned long long score_key(float score, int col) {
  const uint32_t u = bits(score);
  const uint32_t ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ordered << 32) |
         (unsigned long long)(0xFFFFFFFFu - (uint32_t)col);
}

// block-wide reductions into the lane's shared fields: on the card a warp
// reduces first and one thread of it updates the field; on the host the
// emulated threads update it one after another
DS_FN void block_or(int* dst, int v) {
#ifdef __CUDACC__
  v = (int)__reduce_or_sync(0xffffffffu, (unsigned)v);
  if ((threadIdx.x & 31) == 0 && v) atomicOr(dst, v);
#else
  *dst |= v;
#endif
}

DS_FN void block_max(int* dst, int v) {
#ifdef __CUDACC__
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) atomicMax(dst, v);
#else
  if (v > *dst) *dst = v;
#endif
}

DS_FN void block_max64(unsigned long long* dst, unsigned long long v) {
#ifdef __CUDACC__
  for (int off = 16; off; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    if (o > v) v = o;
  }
  if ((threadIdx.x & 31) == 0 && v) atomicMax(dst, v);
#else
  if (v > *dst) *dst = v;
#endif
}

DS_FN void flag_max(int* flag, int v) {
#ifdef __CUDACC__
  atomicMax(flag, v);
#else
  if (v > *flag) *flag = v;
#endif
}

// zero a cell of a sweep output when it holds anything
DS_FN void clear_cell(float* p, size_t i) {
  if (bits(p[i])) p[i] = 0.0f;
}

// ---- phases (each runs on every thread; barriers between them) ---------

// thread 0 reads the lane's scalars
DS_FN void phase_load(const Planes& p, Lane& s, int b, int tid) {
  if (tid != 0) return;
  s.status = p.status[b];
  s.live = s.status == 0;
  s.depth = p.depth[b];
  s.taint = p.taint[b];
  s.conf = p.conf[b];
  s.contra = s.has_force = s.open_any = s.hot_open = 0;
  s.Lm = 0;
  s.maxbulk = -1;
  s.topk = 0;
  s.do_dec = 0;
}

// a lane that is not live: only its sweep rows are zeroed
DS_FN void phase_clear(const Planes& p, const Config& c, int b, int tid) {
  if (!c.clear) return;
  const size_t row = (size_t)b * (size_t)c.V;
  for (int v = tid; v < c.V; v += kThreads) {
    clear_cell(p.fpos, row + v);
    clear_cell(p.fneg, row + v);
    if (c.decisions) {
      clear_cell(p.spos, row + v);
      clear_cell(p.sneg, row + v);
    }
  }
  if (tid == 0) clear_cell(p.conf, b);
}

// pass 1: the lane's masks, its score row, Lm and the deepest bulk slot
DS_FN void phase_scan(const Planes& p, const Config& c, Lane& s,
                      float* score, int b, int tid) {
  const size_t row = (size_t)b * (size_t)c.V;
  int contra = 0, force = 0, open = 0, hot = 0;
  for (int v = tid; v < c.V; v += kThreads) {
    const bool is_free = p.A[row + v] == 0.0f && v > 1;
    const bool fp = p.fpos[row + v] > 0.5f && is_free;
    const bool fn = p.fneg[row + v] > 0.5f && is_free;
    contra |= fp && fn;
    force |= fp || fn;
    open |= is_free;
    if (c.decisions) {
      const float sp = p.spos[row + v], sn = p.sneg[row + v];
      hot |= sp + sn > 0.5f;
      score[v] = (is_free && !(fp || fn)) ? sp + sn + 1.0f : -1.0f;
    }
  }
  const size_t drow = (size_t)b * (size_t)c.D;
  const int held = s.depth < c.D ? s.depth : c.D;
  int lm = 0, mb = -1;
  for (int l = tid; l < c.D; l += kThreads) {
    if (l < held && p.dflip[drow + l] < 0.5f) lm = l + 1;
    if (p.dbulk[drow + l] > 0.5f) mb = l;
  }
  block_or(&s.contra, contra);
  block_or(&s.has_force, force);
  block_or(&s.open_any, open);
  block_or(&s.hot_open, hot);
  block_max(&s.Lm, lm);
  block_max(&s.maxbulk, mb);
}

// thread 0: the lane's transition
DS_FN void phase_lane(const Planes& p, const Config& c, Lane& s, int b,
                      int tid) {
  if (tid != 0) return;
  const bool conflict = s.conf > 0.5f || s.contra;
  s.unsat_now = conflict && s.Lm == 0;
  s.do_bt = conflict && s.Lm > 0;
  s.bslot = s.Lm > 0 ? s.Lm - 1 : 0;
  const size_t drow = (size_t)b * (size_t)c.D;
  s.bvar = p.dvar[drow + s.bslot];
  s.bphase = -p.dphase[drow + s.bslot];
  // a popped (>= Lm) or flipped (Lm - 1) bulk slot taints the lane
  const bool bulk_popped = s.maxbulk >= s.Lm - 1;
  s.taint1 = (s.do_bt && bulk_popped) ? 1.0f : s.taint;
  s.do_force = !conflict && s.has_force;
  bool want = !conflict && s.open_any && !s.has_force;
  if (c.hot_gate) want = want && s.hot_open;
  s.want = want;
  if (c.decisions) {
    const bool can = s.depth < c.D;
    s.in_bulk = s.depth >= kSingleWindow && c.full_view;
    s.bail = want && !can;
    s.topk = want && can;
  } else {
    s.bail = want;
  }
  s.prev = ~0ull;
  s.best = 0;
  s.nwin = 0;
  s.done = 0;
  s.rounds = s.in_bulk ? kBulkK : 1;
}

// one round of the top-K: the block's largest key below the last winner's
DS_FN void phase_topk_scan(const Config& c, Lane& s, const float* score,
                           int tid) {
  unsigned long long best = 0;
  for (int v = tid; v < c.V; v += kThreads) {
    const unsigned long long key = score_key(score[v], v);
    if (key < s.prev && key > best) best = key;
  }
  block_max64(&s.best, best);
}

DS_FN void phase_topk_pick(Lane& s, const float* score, int tid) {
  if (tid != 0) return;
  if (s.best == 0) {
    s.done = 1;
    return;
  }
  const int col = (int)(0xFFFFFFFFu - (uint32_t)(s.best & 0xFFFFFFFFull));
  const float val = score[col];
  s.win_col[s.nwin] = col;
  s.win_val[s.nwin] = val;
  s.nwin += 1;
  s.prev = s.best;
  s.best = 0;
  // past a non-positive score nothing more is kept
  s.done = s.nwin == s.rounds || !(val > 0.0f);
}

// thread 0: the decision, its phase, and the kept columns marked
DS_FN void phase_decide(const Planes& p, const Config& c, Lane& s,
                        float* score, int b, int tid) {
  if (tid != 0) return;
  int keep = 0, real = 0;
  for (int k = 0; k < s.nwin; ++k) {
    if (s.win_val[k] > 0.0f) {
      keep += 1;
      real += s.win_val[k] > 1.5f;
    }
  }
  s.do_dec = keep > 0;
  if (!s.do_dec) return;
  const size_t row = (size_t)b * (size_t)c.V;
  s.primary = s.win_col[0];
  const float pr = p.pref[row + s.primary];
  s.phase = pr != 0.0f ? pr
            : (p.spos[row + s.primary] >= p.sneg[row + s.primary] ? 1.0f
                                                                  : -1.0f);
  s.is_bulk = real > 1 ? 1.0f : 0.0f;
  for (int k = 0; k < keep; ++k) score[s.win_col[k]] = from_bits(kChosen);
}

// pass 2: the writes (only changed cells) and the sweep rows zeroed
DS_FN void phase_write(const Planes& p, const Config& c, const Lane& s,
                       const float* score, int b, int tid) {
  const size_t row = (size_t)b * (size_t)c.V;
  const bool change = s.do_bt || s.do_force || s.do_dec;
  for (int v = tid; v < c.V; v += kThreads) {
    const size_t i = row + v;
    const float fp_v = p.fpos[i], fn_v = p.fneg[i];
    const float sp_v = c.decisions ? p.spos[i] : 0.0f;
    const float sn_v = c.decisions ? p.sneg[i] : 0.0f;
    if (change) {
      const float a = p.A[i];
      const int l = p.lvl[i];
      float na = a;
      int nl = l;
      if (s.do_bt) {
        if (a != 0.0f && l >= s.Lm) na = 0.0f;
        if (v == s.bvar) {
          na = s.bphase;
          nl = s.Lm;
        }
      } else {
        const bool is_free = a == 0.0f && v > 1;
        const bool fp = fp_v > 0.5f && is_free;
        const bool fn = fn_v > 0.5f && is_free;
        if (s.do_force) {
          if ((fp || fn) && !(fp && fn)) {
            na = fp ? 1.0f : -1.0f;
            nl = s.depth;
          }
        } else {  // do_dec
          const bool chosen = bits(score[v]) == kChosen;
          const bool dontcare =
              is_free && !(fp || fn) && sp_v + sn_v < 0.5f && c.full_view;
          if (chosen) {
            const float pr = p.pref[i];
            na = pr != 0.0f ? pr : (sp_v >= sn_v ? 1.0f : -1.0f);
            nl = s.depth + 1;
          } else if (dontcare) {
            na = 1.0f;
            nl = s.depth + 1;
          }
        }
      }
      if (bits(na) != bits(a)) p.A[i] = na;
      if (nl != l) p.lvl[i] = nl;
    }
    if (c.clear) {
      if (bits(fp_v)) p.fpos[i] = 0.0f;
      if (bits(fn_v)) p.fneg[i] = 0.0f;
      if (bits(sp_v)) p.spos[i] = 0.0f;
      if (bits(sn_v)) p.sneg[i] = 0.0f;
    }
  }
  const size_t drow = (size_t)b * (size_t)c.D;
  if (s.do_bt) {
    for (int l = tid; l < c.D; l += kThreads) {
      const size_t j = drow + l;
      if (l >= s.Lm) {  // popped
        if (p.dvar[j]) p.dvar[j] = 0;
        if (bits(p.dphase[j])) p.dphase[j] = 0.0f;
        if (bits(p.dflip[j])) p.dflip[j] = 0.0f;
        if (bits(p.dbulk[j])) p.dbulk[j] = 0.0f;
      } else if (l == s.bslot) {  // flipped
        p.dphase[j] = s.bphase;
        p.dflip[j] = 1.0f;
        if (bits(p.dbulk[j])) p.dbulk[j] = 0.0f;
      }
    }
  } else if (s.do_dec && tid == s.depth % kThreads) {
    const size_t j = drow + s.depth;
    p.dvar[j] = s.primary;
    p.dphase[j] = s.phase;
    p.dflip[j] = 0.0f;
    p.dbulk[j] = s.is_bulk;
  }
  if (tid == 0) {
    int status = s.status;
    if (s.unsat_now) status = s.taint1 > 0.5f ? 3 : 2;
    const bool done_sat =
        !(s.conf > 0.5f || s.contra) && !s.has_force && !s.open_any &&
        c.full_view;
    if (done_sat) status = 1;
    if (s.bail) status = 3;
    p.depth[b] = s.do_dec ? s.depth + 1 : (s.do_bt ? s.Lm : s.depth);
    p.taint[b] = s.taint1;
    p.status[b] = status;
    p.active[b] += 1;
    flag_max(p.flags + 1, c.step + 1);
    if (status == 0) flag_max(p.flags, c.step + 1);
    if (c.clear) clear_cell(p.conf, b);
  }
}

Planes planes_of(void* const* ptrs) {
  Planes p;
  p.A = static_cast<float*>(ptrs[0]);
  p.lvl = static_cast<int*>(ptrs[1]);
  p.dvar = static_cast<int*>(ptrs[2]);
  p.dphase = static_cast<float*>(ptrs[3]);
  p.dflip = static_cast<float*>(ptrs[4]);
  p.dbulk = static_cast<float*>(ptrs[5]);
  p.depth = static_cast<int*>(ptrs[6]);
  p.status = static_cast<int*>(ptrs[7]);
  p.taint = static_cast<float*>(ptrs[8]);
  p.active = static_cast<int*>(ptrs[9]);
  p.pref = static_cast<const float*>(ptrs[10]);
  p.fpos = static_cast<float*>(ptrs[11]);
  p.fneg = static_cast<float*>(ptrs[12]);
  p.conf = static_cast<float*>(ptrs[13]);
  p.spos = static_cast<float*>(ptrs[14]);
  p.sneg = static_cast<float*>(ptrs[15]);
  p.flags = static_cast<int*>(ptrs[16]);
  return p;
}

bool bad_config(const Config& c) {
  return c.B < 1 || c.V < 2 || c.D < 1 ||
         (c.decisions && c.V > kMaxScoreCols) || (c.hot_gate && !c.decisions);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kThreads)
dpll_step_kernel(Planes p, Config c) {
  extern __shared__ float score[];
  __shared__ Lane s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  phase_load(p, s, b, tid);
  __syncthreads();
  if (!s.live) {
    phase_clear(p, c, b, tid);
    return;
  }
  phase_scan(p, c, s, score, b, tid);
  __syncthreads();
  phase_lane(p, c, s, b, tid);
  __syncthreads();
  if (s.topk) {
    for (;;) {
      phase_topk_scan(c, s, score, tid);
      __syncthreads();
      phase_topk_pick(s, score, tid);
      __syncthreads();
      if (s.done) break;
    }
    phase_decide(p, c, s, score, b, tid);
    __syncthreads();
  }
  phase_write(p, c, s, score, b, tid);
}

#endif  // __CUDACC__

}  // namespace

extern "C" {

int dpll_step_threads() { return kThreads; }

int dpll_step_bulk_k() { return kBulkK; }

int dpll_step_single_window() { return kSingleWindow; }

int dpll_step_max_score_cols() { return kMaxScoreCols; }

#ifdef __CUDACC__

// Plain C entry point (bound with ctypes): `ptrs` holds the 17 pointers of
// Planes in order.  Returns the cudaError_t of the launch; 0 means the
// kernel was queued on `stream`.
int dpll_step_launch(void* const* ptrs, int B, int V, int D, int step,
                     int full_view, int hot_gate, int decisions, int clear,
                     void* stream) {
  const Config c{B, V, D, step, full_view, hot_gate, decisions, clear};
  if (bad_config(c)) return (int)cudaErrorInvalidValue;
  const size_t smem = decisions ? (size_t)V * sizeof(float) : 0;
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dpll_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dpll_step_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      planes_of(ptrs), c);
  return (int)cudaGetLastError();
}

#else  // host C++

// The kernel's phases on the host, lane after lane, each phase over the
// block's emulated threads in turn (the barriers' order).
int dpll_step_host(void* const* ptrs, int B, int V, int D, int step,
                   int full_view, int hot_gate, int decisions, int clear) {
  const Config c{B, V, D, step, full_view, hot_gate, decisions, clear};
  if (bad_config(c)) return 1;
  const Planes p = planes_of(ptrs);
  std::vector<float> score(decisions ? V : 1);
  for (int b = 0; b < B; ++b) {
    Lane s;
    std::memset(&s, 0, sizeof(s));
    for (int t = 0; t < kThreads; ++t) phase_load(p, s, b, t);
    if (!s.live) {
      for (int t = 0; t < kThreads; ++t) phase_clear(p, c, b, t);
      continue;
    }
    for (int t = 0; t < kThreads; ++t) phase_scan(p, c, s, score.data(), b, t);
    for (int t = 0; t < kThreads; ++t) phase_lane(p, c, s, b, t);
    if (s.topk) {
      for (;;) {
        for (int t = 0; t < kThreads; ++t)
          phase_topk_scan(c, s, score.data(), t);
        for (int t = 0; t < kThreads; ++t)
          phase_topk_pick(s, score.data(), t);
        if (s.done) break;
      }
      for (int t = 0; t < kThreads; ++t)
        phase_decide(p, c, s, score.data(), b, t);
    }
    for (int t = 0; t < kThreads; ++t)
      phase_write(p, c, s, score.data(), b, t);
  }
  return 0;
}

#endif  // __CUDACC__

}  // extern "C"
