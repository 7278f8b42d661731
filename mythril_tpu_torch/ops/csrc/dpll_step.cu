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
// Every transition reads the pre-step state: every read of the lane's
// state comes before the cluster barrier after which the blocks write.
// Values that cross threads or blocks are integer OR / max, or a 64-bit
// key max (score, then column), so the result does not depend on the
// order threads run in.  Steps on a lane that is not live (status != 0)
// change nothing but the sweep outputs' rows, which the kernel zeroes
// (with `clear`) so that the round's sweep workspace is zero for the next
// sweep.  flags[1] = max(step + 1) over lanes live before the step (the
// JAX loop's step count) and flags[0] = max(step + 1) over lanes live
// after it (the host's loop condition), so a step on a batch with no
// live lane changes nothing.
//
// Design.  A thread-block cluster of `cs` blocks a lane (cluster_size: the
// smallest power of two up to 8 that keeps B x cs within the card's 132
// SMs and gives the lane's columns room); block `rank` owns a contiguous
// slice of the lane's V columns and of its D slots.  Each thread reads
// groups of 4 adjacent columns of A, the sweep rows and the warm-start
// plane at once, by 16-byte loads where V and the row bases allow, and
// keeps what the write needs in registers (the score, the value a
// decision would assign, and a byte of flags a column: forced each way,
// don't-care, assigned, which sweep cells are nonzero), so the [B, V]
// rows are read once; lvl is read only on assigned columns of a lane in
// conflict, ahead of the barriers.  A block reduces its flags, its Lm
// (with that slot's variable and phase) and deepest bulk slot, and its
// largest key (with its column's decision value); inside the bulk
// window, every warp keeps its 16 largest keys in one pass (each thread
// offers its best key not yet offered while it beats the warp's 16th;
// up to 4 offers are inserted one by one, more are sorted by a bitonic
// network and merged into the list),
// then the warps' lists merge pairwise (a half-warp a merge) into the
// block's, and the blocks' lists merge on rank 0.  Every block pushes
// its reductions into rank 0's shared memory; rank 0 decides the lane's
// transition, with no read of global memory, and pushes it into every
// block's; each block then writes only the cells that change and zeroes
// the nonzero sweep cells of its slice.
//
// Bound at the check's shape (B = 64, V = 4096, D = 1024, decisions on):
// the [B, V] rows it must read (A and four sweep planes, 5.2 MiB) and the
// cells it writes; ~2 µs at 3.35 TB/s, below the launch itself.  The work
// is a few operations a cell, so the step is memory-bound; the design
// spreads a lane over 2 SMs at B = 64 (8 at B <= 16) and issues its loads
// at once, and keeps the top-K to one pass.
//
// Compiled as host C++ (no __CUDACC__), the same phases run on emulated
// clusters: each phase runs its threads one after another (a warp's
// shuffles and votes over an array of its 32 lanes), and the phases follow
// each other as the block and cluster barriers order them
// (dpll_step_host), so the CPU tests hold the kernel's own code against
// the plain version at any cluster size.

#include <cstdint>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#define DS_FN __device__ __forceinline__
#else
#include <cstring>
#include <vector>
#define DS_FN static inline
#endif

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 2;                        // column groups a thread keeps
constexpr int kCells = 4 * kGroups;               // columns a thread keeps
constexpr int kBlockCols = kThreads * kCells;     // a block's slice, at most
constexpr int kMaxCluster = 8;                    // portable cluster size
constexpr int kMaxCols = kMaxCluster * kBlockCols;  // 32768
constexpr int kSms = 132;                         // H100 SXM
constexpr int kBulkK = 16;                        // DPLL_BULK_K
constexpr int kSingleWindow = 8;                  // DPLL_SINGLE_WINDOW

// a column's flags, kept from the read to the write
constexpr uint32_t kFpos = 1u, kFneg = 2u, kDontCare = 4u, kAssigned = 8u;
constexpr uint32_t kNzFpos = 16u, kNzFneg = 32u, kNzSpos = 64u,
                   kNzSneg = 128u;
// a thread's columns together
constexpr int kContra = 1, kForce = 2, kOpen = 4, kHot = 8;

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
  int cs;     // blocks a lane: the cluster
  int cols;   // columns of a block's slice (a multiple of 4)
  int slots;  // decision slots of a block's slice
  int vec;    // 16-byte loads and stores of the [B, V] rows
};

// a block's reductions, pushed into rank 0
struct Part {
  int contra, force, open, hot, lm, maxbulk;
  int bvar;      // the variable of the block's slot lm - 1
  float bphase;  // its phase, negated
  u64 best;      // the block's largest key
  float phase;   // the decision value of that key's column
};

// the lane's transition, decided on rank 0 and pushed into every block
enum {
  kDoBt, kDoForce, kDoDec, kLm, kBslot, kBvar, kBphase, kNkeep, kPrimary,
  kPhase, kIsBulk, kCol0, kDecWords = kCol0 + kBulkK
};

// a block's view of its lane (shared memory on the card)
struct Lane {
  int live, status, depth, rounds;
  float taint, conf;
  int contra, force, open, hot, lm, maxbulk;  // this block's reductions
  int bvar;
  float bphase;
  u64 best;
  float phase;
  // rank 0: every block's reductions and keys, and the lane's outcome
  Part part[kMaxCluster];
  u64 keys[kMaxCluster][kBulkK];
  u64 keys2[kMaxCluster / 2][kBulkK];
  int topk, unsat_now, bail, open_any, has_force, conflict;
  float taint1;
  int out[kDecWords];
  int dec[kDecWords];  // the lane's transition, in every block
};

// a thread's columns (cell k is column col0 + 4 * kThreads * (k / 4) +
// k % 4) and decision slots, kept in registers from the read to the write
struct Cells {
  float ph[kCells];     // a decision's value: pref, else the majority phase
  float score[kCells];  // spos + sneg + 1 on a free, unforced column, else -1
  int lv[kCells];       // lvl, read ahead for a lane in conflict
  uint32_t bits[kGroups];
  int col0;
  uint32_t used;        // cells already offered to the warp's top-K
  int flags;            // kContra | kForce | kOpen | kHot of the cells
  int has_lv;
  int lm, var;          // the deepest unflipped held slot's level, variable
  float vphase;         // and its phase, negated
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
// only positive scores get a key, and 0 means "none"
DS_FN u64 score_key(float score, int col) {
  if (!(score > 0.0f)) return 0;
  return ((u64)(bits(score) | 0x80000000u) << 32) |
         (u64)(0xFFFFFFFFu - (uint32_t)col);
}

DS_FN int key_col(u64 key) {
  return (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
}

DS_FN float key_score(u64 key) {
  return from_bits((uint32_t)(key >> 32) & 0x7FFFFFFFu);
}

DS_FN int cell_col(const Cells& t, int k) {
  return t.col0 + 4 * kThreads * (k >> 2) + (k & 3);
}

// ---- a warp's lanes: one value a thread on the card, 32 on the host ----

#ifdef __CUDACC__
template <class T>
using Lanes = T;
#define LANES for (int li = threadIdx.x & 31, once_ = 1; once_; once_ = 0)
#define AT(x) (x)
#define TL t
#define CELLS Cells&
DS_FN u64 lanes_xor(u64 x, int m) { return __shfl_xor_sync(0xffffffffu, x, m); }
DS_FN u64 lane_of(u64 x, int src) { return __shfl_sync(0xffffffffu, x, src); }
DS_FN u64 lanes_up(u64 x) { return __shfl_up_sync(0xffffffffu, x, 1); }
// inside LANES: the warp's vote (every lane of the warp runs it)
#define VOTE(m, p) ((m) = __ballot_sync(0xffffffffu, (p)))
DS_FN int lowest_lane(unsigned m) { return __ffs(m) - 1; }
DS_FN int popcount(unsigned m) { return __popc(m); }
#else
template <class T>
struct Lanes {
  T v[32];
};
#define LANES for (int li = 0; li < 32; ++li)
#define AT(x) ((x).v[li])
#define TL t[li]
#define CELLS Cells*
static inline Lanes<u64> lanes_xor(const Lanes<u64>& x, int m) {
  Lanes<u64> r;
  for (int i = 0; i < 32; ++i) r.v[i] = x.v[i ^ m];
  return r;
}
static inline u64 lane_of(const Lanes<u64>& x, int src) { return x.v[src]; }
static inline Lanes<u64> lanes_up(const Lanes<u64>& x) {
  Lanes<u64> r;
  for (int i = 0; i < 32; ++i) r.v[i] = x.v[i ? i - 1 : 0];
  return r;
}
#define VOTE(m, p) ((m) |= (p) ? 1u << li : 0u)
static inline int lowest_lane(unsigned m) { return __builtin_ctz(m); }
static inline int popcount(unsigned m) { return __builtin_popcount(m); }
#endif

DS_FN u64 max64(u64 a, u64 b) { return a > b ? a : b; }
DS_FN u64 min64(u64 a, u64 b) { return a < b ? a : b; }

// the warp's keys in descending order (a bitonic network of 15 stages)
DS_FN Lanes<u64> sort32(Lanes<u64> x) {
  for (int k = 2; k <= 32; k <<= 1) {
    for (int j = k >> 1; j; j >>= 1) {
      const Lanes<u64> y = lanes_xor(x, j);
      LANES {
        const bool keep_max = ((li & j) == 0) == ((li & k) == 0);
        AT(x) = keep_max ? max64(AT(x), AT(y)) : min64(AT(x), AT(y));
      }
    }
  }
  return x;
}

// each half-warp's bitonic 16 keys in descending order
DS_FN Lanes<u64> clean16(Lanes<u64> x) {
  for (int j = 8; j; j >>= 1) {
    const Lanes<u64> y = lanes_xor(x, j);
    LANES {
      AT(x) = (li & j) == 0 ? max64(AT(x), AT(y)) : min64(AT(x), AT(y));
    }
  }
  return x;
}

// a thread's largest key not yet offered (0: none), and its cell
DS_FN u64 best_open(const Cells& t, int* cell) {
  u64 best = 0;
  int at = 0;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const u64 key =
        (t.used >> k) & 1u ? 0 : score_key(t.score[k], cell_col(t, k));
    if (key > best) {
      best = key;
      at = k;
    }
  }
  *cell = at;
  return best;
}

// key inserted into the list of the warp's first 16 lanes (descending)
DS_FN Lanes<u64> insert16(Lanes<u64> list, u64 key) {
  const Lanes<u64> up = lanes_up(list);
  LANES {
    if (li < kBulkK && !(AT(list) > key))
      AT(list) = li == 0 || AT(up) > key ? key : AT(up);
  }
  return list;
}

// The warp's 16 largest keys into `out` (descending, zeros past the
// last), in one pass: each thread offers its best key not yet offered
// while some offer beats the list's 16th; a few offers are inserted one
// by one, more are sorted and the list keeps the top 16 of it and them
// (the list against the offers reversed, then a bitonic clean).  A
// thread that cannot beat the 16th never can again, so each round uses
// up one cell of every offering thread: at most kCells rounds.
DS_FN void warp_topk(CELLS t, u64* out) {
  Lanes<u64> list, offer, x;
  Lanes<int> cell;
  LANES { AT(list) = 0; }
  for (;;) {
    LANES { AT(offer) = best_open(TL, &AT(cell)); }
    const u64 last = lane_of(list, kBulkK - 1);
    unsigned offers = 0;
    LANES {
      const bool offered = AT(offer) > last;
      VOTE(offers, offered);
      AT(x) = offered ? AT(offer) : 0;
      if (offered) TL.used |= 1u << AT(cell);
    }
    if (!offers) break;
    if (popcount(offers) <= 4) {
      for (unsigned m = offers; m; m &= m - 1)
        list = insert16(list, lane_of(offer, lowest_lane(m)));
      continue;
    }
    x = sort32(x);
    const Lanes<u64> rev = lanes_xor(x, 15);
    LANES { AT(list) = li < kBulkK ? max64(AT(list), AT(rev)) : 0; }
    list = clean16(list);
  }
  LANES {
    if (li < kBulkK) out[li] = AT(list);
  }
}

// `n` descending lists of 16 keys -> n / 2: list m the top 16 of lists 2m
// and 2m + 1, on half-warp m (warp `warp` takes lists 2 warp, 2 warp + 1)
DS_FN void merge_level(u64 (*src)[kBulkK], u64 (*dst)[kBulkK], int n,
                       int warp) {
  if (4 * warp >= n) return;  // no merge for this warp (warp-uniform)
  Lanes<u64> x;
  LANES {
    const int m = 2 * warp + (li >> 4), e = li & 15;
    AT(x) = 0;
    if (2 * m < n) AT(x) = max64(src[2 * m][e], src[2 * m + 1][15 - e]);
  }
  x = clean16(x);
  LANES {
    const int m = 2 * warp + (li >> 4);
    if (2 * m < n) dst[m][li & 15] = AT(x);
  }
}

// ---- block and cluster primitives ---------------------------------------

// block-wide reductions into the block's shared fields: on the card a warp
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

DS_FN void block_max64(u64* dst, u64 v) {
#ifdef __CUDACC__
  for (int off = 16; off; off >>= 1) v = max64(v, lanes_xor(v, off));
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

// block `r` of the lane's cluster: its shared memory on the card (the
// block's own for r == its rank), the emulated block on the host
DS_FN Lane& peer(Lane& s, Lane* all, int r) {
#ifdef __CUDACC__
  (void)all;
  return *cooperative_groups::this_cluster().map_shared_rank(&s, r);
#else
  (void)s;
  return all[r];
#endif
}

#ifdef __CUDACC__
DS_FN void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
DS_FN void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
DS_FN void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
#endif

// 4 adjacent cells of a row from index i, n of them in the row (16-byte
// access when `vec` and the group is whole)
DS_FN void load4(const float* p, size_t i, int n, int vec, float* out) {
#ifdef __CUDACC__
  if (vec && n == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else
#endif
  {
    (void)vec;
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = e < n ? p[i + e] : 0.0f;
  }
}

DS_FN void load4i(const int* p, size_t i, int n, int vec, int* out) {
#ifdef __CUDACC__
  if (vec && n == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p + i);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else
#endif
  {
    (void)vec;
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = e < n ? p[i + e] : 0;
  }
}

DS_FN void store4(float* p, size_t i, int n, int vec, const float* v) {
#ifdef __CUDACC__
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else
#endif
  {
    (void)vec;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[i + e] = v[e];
  }
}

// the 4 cells of a sweep plane zeroed when any of them holds anything
DS_FN void clear4(float* p, size_t i, int n, int vec, uint32_t nonzero) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (nonzero) store4(p, i, n, vec, zero);
}

// columns of group j of thread tid in block `rank`: (first column, count)
DS_FN int group_col(const Config& c, int rank, int tid, int j) {
  return rank * c.cols + 4 * (tid + kThreads * j);
}

DS_FN int group_n(const Config& c, int rank, int col) {
  const int end = (rank + 1) * c.cols < c.V ? (rank + 1) * c.cols : c.V;
  const int n = end - col;
  return n < 0 ? 0 : (n > 4 ? 4 : n);
}

// ---- phases (each runs on every thread; barriers between them) ---------

// thread 0 reads the lane's scalars; every thread reads its columns of the
// [B, V] rows, at once: the cells' flags, scores and decision values
DS_FN void phase_read(const Planes& p, const Config& c, Lane& s, Cells& t,
                      int b, int rank, int tid) {
  if (tid == 0) {
    s.status = p.status[b];
    s.live = s.status == 0;
    s.depth = p.depth[b];
    s.taint = p.taint[b];
    s.conf = p.conf[b];
    s.rounds = c.decisions && s.depth >= kSingleWindow && c.full_view
                   ? kBulkK
                   : 1;
    s.contra = s.force = s.open = s.hot = 0;
    s.lm = 0;
    s.maxbulk = -1;
    s.bvar = 0;
    s.bphase = 0.0f;
    s.best = 0;
    s.phase = 0.0f;
  }
  const size_t row = (size_t)b * (size_t)c.V;
  t.col0 = group_col(c, rank, tid, 0);
  t.used = 0;
  t.has_lv = 0;
  int flags = 0;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int col = group_col(c, rank, tid, j);
    const int n = group_n(c, rank, col);
    float a[4], fp[4], fn[4], sp[4], sn[4], pr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[e] = fp[e] = fn[e] = sp[e] = sn[e] = pr[e] = 0.0f;
    if (n > 0) {  // a group past the slice reads nothing
      load4(p.A, row + col, n, c.vec, a);
      load4(p.fpos, row + col, n, c.vec, fp);
      load4(p.fneg, row + col, n, c.vec, fn);
      if (c.decisions) {
        load4(p.spos, row + col, n, c.vec, sp);
        load4(p.sneg, row + col, n, c.vec, sn);
        load4(p.pref, row + col, n, c.vec, pr);
      }
    }
    uint32_t cells = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool valid = e < n;
      const bool is_free = valid && a[e] == 0.0f && col + e > 1;
      const bool f_pos = fp[e] > 0.5f && is_free;
      const bool f_neg = fn[e] > 0.5f && is_free;
      const float sum = sp[e] + sn[e];
      const bool unforced = is_free && !(f_pos || f_neg);
      flags |= (f_pos && f_neg ? kContra : 0) | (f_pos || f_neg ? kForce : 0) |
               (is_free ? kOpen : 0) | (sum > 0.5f ? kHot : 0);
      const uint32_t f =
          (f_pos ? kFpos : 0u) | (f_neg ? kFneg : 0u) |
          (unforced && sum < 0.5f ? kDontCare : 0u) |
          (valid && a[e] != 0.0f ? kAssigned : 0u) |
          (bits(fp[e]) ? kNzFpos : 0u) | (bits(fn[e]) ? kNzFneg : 0u) |
          (bits(sp[e]) ? kNzSpos : 0u) | (bits(sn[e]) ? kNzSneg : 0u);
      cells |= f << (8 * e);
      t.score[4 * j + e] = c.decisions && unforced ? sum + 1.0f : -1.0f;
      t.ph[4 * j + e] =
          pr[e] != 0.0f ? pr[e] : (sp[e] >= sn[e] ? 1.0f : -1.0f);
    }
    t.bits[j] = cells;
  }
  t.flags = flags;
}

// a lane that is not live: only its sweep rows are zeroed
DS_FN void phase_clear(const Planes& p, const Config& c, const Lane& s,
                       const Cells& t, int b, int rank, int tid) {
  if (!c.clear) return;
  const size_t row = (size_t)b * (size_t)c.V;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int col = group_col(c, rank, tid, j);
    const int n = group_n(c, rank, col);
    if (n == 0) continue;
    const uint32_t f = t.bits[j];
    const uint32_t nz = f | f >> 8 | f >> 16 | f >> 24;
    clear4(p.fpos, row + col, n, c.vec, nz & kNzFpos);
    clear4(p.fneg, row + col, n, c.vec, nz & kNzFneg);
    if (c.decisions) {
      clear4(p.spos, row + col, n, c.vec, nz & kNzSpos);
      clear4(p.sneg, row + col, n, c.vec, nz & kNzSneg);
    }
  }
  if (rank == 0 && tid == 0 && bits(s.conf)) p.conf[b] = 0.0f;
}

// the block's masks, its deepest unflipped held slot (with the slot's
// variable and phase) and deepest bulk slot, its largest key; lvl read
// ahead when the lane is in conflict
DS_FN void phase_scan(const Planes& p, const Config& c, Lane& s, Cells& t,
                      int b, int rank, int tid) {
  block_or(&s.contra, t.flags & kContra);
  block_or(&s.force, t.flags & kForce);
  block_or(&s.open, t.flags & kOpen);
  block_or(&s.hot, t.flags & kHot);
  const size_t drow = (size_t)b * (size_t)c.D;
  const int held = s.depth < c.D ? s.depth : c.D;
  const int d0 = rank * c.slots;
  const int d1 = d0 + c.slots < c.D ? d0 + c.slots : c.D;
  int lm = 0, mb = -1, var = 0;
  float vphase = 0.0f;
  for (int l = d0 + tid; l < d1; l += kThreads) {
    const float flip = p.dflip[drow + l], bulk = p.dbulk[drow + l];
    const int dv = p.dvar[drow + l];
    const float dp = p.dphase[drow + l];
    if (l < held && flip < 0.5f) {
      lm = l + 1;
      var = dv;
      vphase = -dp;
    }
    if (bulk > 0.5f) mb = l;
  }
  t.lm = lm;
  t.var = var;
  t.vphase = vphase;
  block_max(&s.lm, lm);
  block_max(&s.maxbulk, mb);
  if (s.conf > 0.5f) {  // a backtrack reads the levels of assigned cells
    const size_t row = (size_t)b * (size_t)c.V;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int col = group_col(c, rank, tid, j);
      const int n = group_n(c, rank, col);
      const uint32_t f = t.bits[j];
      if (n > 0 && ((f | f >> 8 | f >> 16 | f >> 24) & kAssigned))
        load4i(p.lvl, row + col, n, c.vec, t.lv + 4 * j);
    }
    t.has_lv = 1;
  }
  u64 best = 0;
#pragma unroll
  for (int k = 0; k < kCells; ++k)
    best = max64(best, score_key(t.score[k], cell_col(t, k)));
  block_max64(&s.best, best);
}

// the threads that own the block's deepest unflipped slot and its
// largest key give their values
DS_FN void phase_owner(Lane& s, const Cells& t) {
  if (t.lm > 0 && t.lm == s.lm) {
    s.bvar = t.var;
    s.bphase = t.vphase;
  }
  if (!s.best) return;
#pragma unroll
  for (int k = 0; k < kCells; ++k)
    if (score_key(t.score[k], cell_col(t, k)) == s.best) s.phase = t.ph[k];
}

// whether the block ranks its keys: a lane whose block forces or
// contradicts, or that is in conflict or at the stack's depth, cannot
// decide (the block's view, read after the scan's barrier)
DS_FN bool ranks_keys(const Config& c, const Lane& s) {
  return c.decisions && !(s.conf > 0.5f) && s.depth < c.D && !s.contra &&
         !s.force;
}

// every block's reductions and keys into rank 0 (`list`: the block's 16
// keys inside the bulk window)
DS_FN void phase_push(Lane& s, Lane* all, const u64* list, bool ranked,
                      int rank, int tid) {
  Lane& root = peer(s, all, 0);
  if (tid < kBulkK) {
    u64 key = 0;
    if (ranked) key = s.rounds == kBulkK ? list[tid] : (tid == 0 ? s.best : 0);
    root.keys[rank][tid] = key;
  }
  if (tid == kBulkK) {
    root.part[rank] = Part{s.contra, s.force,  s.open, s.hot,
                           s.lm,     s.maxbulk, s.bvar, s.bphase,
                           ranked ? s.best : 0, s.phase};
  }
}

// rank 0, thread 0: the lane's transition up to the choice of columns
DS_FN void phase_lane(const Config& c, Lane& s, int tid) {
  if (tid != 0) return;
  int contra = 0, force = 0, open = 0, hot = 0, lm = 0, maxbulk = -1;
  int bvar = 0;
  float bphase = 0.0f, phase = 0.0f;
  u64 best = 0;
  for (int r = 0; r < c.cs; ++r) {
    const Part& q = s.part[r];
    contra |= q.contra;
    force |= q.force;
    open |= q.open;
    hot |= q.hot;
    if (q.lm > lm) {
      lm = q.lm;
      bvar = q.bvar;
      bphase = q.bphase;
    }
    maxbulk = q.maxbulk > maxbulk ? q.maxbulk : maxbulk;
    if (q.best > best) {
      best = q.best;
      phase = q.phase;
    }
  }
  const bool conflict = s.conf > 0.5f || contra;
  s.conflict = conflict;
  s.has_force = force;
  s.open_any = open;
  s.unsat_now = conflict && lm == 0;
  const int do_bt = conflict && lm > 0;
  // a popped (>= Lm) or flipped (Lm - 1) bulk slot taints the lane
  const bool bulk_popped = maxbulk >= lm - 1;
  s.taint1 = do_bt && bulk_popped ? 1.0f : s.taint;
  bool want = !conflict && open && !force;
  if (c.hot_gate) want = want && hot;
  const bool can = c.decisions && s.depth < c.D;
  s.bail = want && !can;
  s.topk = want && can;
  int* d = s.out;
  d[kDoBt] = do_bt;
  d[kDoForce] = !conflict && force;
  d[kDoDec] = 0;
  d[kLm] = lm;
  d[kBslot] = lm > 0 ? lm - 1 : 0;
  d[kBvar] = bvar;
  d[kBphase] = (int)bits(bphase);
  d[kNkeep] = 0;
  d[kPhase] = (int)bits(phase);  // the primary's: the lane's largest key
}

// rank 0, warp 0 (a lane a key): the kept columns (`list`: the lane's
// keys in descending order) and the decision
DS_FN void phase_decide(Lane& s, const u64* list, int warp) {
  if (warp != 0 || !s.topk) return;
  int* d = s.out;
  unsigned kept = 0, real = 0;
  LANES {
    const u64 key = li < s.rounds ? list[li] : 0;
    VOTE(kept, key != 0);
    VOTE(real, key != 0 && key_score(key) > 1.5f);
    if (key) d[kCol0 + li] = key_col(key);
  }
  LANES {
    if (li == 0) {
      const int keep = popcount(kept);
      d[kNkeep] = keep;
      d[kDoDec] = keep > 0;
      d[kPrimary] = d[kCol0];
      d[kIsBulk] = (int)bits(popcount(real) > 1 ? 1.0f : 0.0f);
    }
  }
}

// rank 0: the transition into every block's shared memory
DS_FN void phase_broadcast(const Config& c, Lane& s, Lane* all, int tid) {
  const int r = tid >> 5, w = tid & 31;
  if (r < c.cs && w < kDecWords) peer(s, all, r).dec[w] = s.out[w];
}

// the writes (only changed cells) and the sweep rows zeroed
DS_FN void phase_write(const Planes& p, const Config& c, const Lane& s,
                       const Cells& t, int b, int rank, int tid) {
  const size_t row = (size_t)b * (size_t)c.V;
  const int* d = s.dec;
  const bool do_bt = d[kDoBt], do_force = d[kDoForce], do_dec = d[kDoDec];
  const int Lm = d[kLm], bvar = d[kBvar];
  const float bphase = from_bits((uint32_t)d[kBphase]);
  uint32_t chosen = 0;  // the thread's cells among the kept columns
  if (do_dec) {
    for (int k = 0; k < d[kNkeep]; ++k) {
      const int off = d[kCol0 + k] - t.col0;
      if (off >= 0 && off < kBlockCols && off % (4 * kThreads) < 4)
        chosen |= 1u << (4 * (off / (4 * kThreads)) + off % 4);
    }
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int col = group_col(c, rank, tid, j);
    const int n = group_n(c, rank, col);
    if (n == 0) continue;
    const size_t i = row + col;
    const uint32_t flags = t.bits[j];
    const uint32_t any = flags | flags >> 8 | flags >> 16 | flags >> 24;
    if (do_bt || do_force || do_dec) {
      int l[4] = {0, 0, 0, 0};
      if (do_bt && (any & kAssigned)) {
        if (t.has_lv) {
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e] = t.lv[4 * j + e];
        } else {
          load4i(p.lvl, i, n, c.vec, l);
        }
      }
      float na[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      uint32_t written = 0;  // cells of the group that change
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= n) break;
        const uint32_t f = flags >> (8 * e);
        int nl = -1;  // lvl written, if any
        if (do_bt) {
          if ((f & kAssigned) && l[e] >= Lm) {
            na[e] = 0.0f;
            written |= 1u << e;
          }
          if (col + e == bvar) {
            na[e] = bphase;
            nl = Lm;
            written |= 1u << e;
          }
        } else if (do_force) {
          const bool fp = f & kFpos, fn = f & kFneg;
          if ((fp || fn) && !(fp && fn)) {
            na[e] = fp ? 1.0f : -1.0f;
            nl = s.depth;
            written |= 1u << e;
          }
        } else if ((chosen >> (4 * j + e)) & 1u) {
          na[e] = t.ph[4 * j + e];
          nl = s.depth + 1;
          written |= 1u << e;
        } else if ((f & kDontCare) && c.full_view) {
          na[e] = 1.0f;
          nl = s.depth + 1;
          written |= 1u << e;
        }
        if (nl >= 0) p.lvl[i + e] = nl;
      }
      if (written == 0xFu) {
        store4(p.A, i, n, c.vec, na);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((written >> e) & 1u) p.A[i + e] = na[e];
      }
    }
    if (c.clear) {
      clear4(p.fpos, i, n, c.vec, any & kNzFpos);
      clear4(p.fneg, i, n, c.vec, any & kNzFneg);
      if (c.decisions) {
        clear4(p.spos, i, n, c.vec, any & kNzSpos);
        clear4(p.sneg, i, n, c.vec, any & kNzSneg);
      }
    }
  }
  const size_t drow = (size_t)b * (size_t)c.D;
  const int d0 = rank * c.slots;
  const int d1 = d0 + c.slots < c.D ? d0 + c.slots : c.D;
  if (do_bt) {
    const int bslot = d[kBslot];
    for (int l = d0 + tid; l < d1; l += kThreads) {
      const size_t k = drow + l;
      if (l >= Lm) {  // popped
        if (p.dvar[k]) p.dvar[k] = 0;
        if (bits(p.dphase[k])) p.dphase[k] = 0.0f;
        if (bits(p.dflip[k])) p.dflip[k] = 0.0f;
        if (bits(p.dbulk[k])) p.dbulk[k] = 0.0f;
      } else if (l == bslot) {  // flipped
        p.dphase[k] = bphase;
        p.dflip[k] = 1.0f;
        if (bits(p.dbulk[k])) p.dbulk[k] = 0.0f;
      }
    }
  } else if (do_dec && s.depth >= d0 && s.depth < d1 &&
             tid == (s.depth - d0) % kThreads) {
    const size_t k = drow + s.depth;
    p.dvar[k] = d[kPrimary];
    p.dphase[k] = from_bits((uint32_t)d[kPhase]);
    p.dflip[k] = 0.0f;
    p.dbulk[k] = from_bits((uint32_t)d[kIsBulk]);
  }
  if (rank == 0 && tid == 0) {
    int status = s.status;
    if (s.unsat_now) status = s.taint1 > 0.5f ? 3 : 2;
    const bool done_sat =
        !s.conflict && !s.has_force && !s.open_any && c.full_view;
    if (done_sat) status = 1;
    if (s.bail) status = 3;
    p.depth[b] = do_dec ? s.depth + 1 : (do_bt ? Lm : s.depth);
    p.taint[b] = s.taint1;
    p.status[b] = status;
    p.active[b] += 1;
    flag_max(p.flags + 1, c.step + 1);
    if (status == 0) flag_max(p.flags, c.step + 1);
    if (c.clear && bits(s.conf)) p.conf[b] = 0.0f;
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

// blocks a lane: the smallest power of two up to kMaxCluster that keeps
// B x cs within the card's SMs, then large enough for the lane's columns
int cluster_size(int B, int V) {
  int cs = 1;
  while (cs < kMaxCluster && 2 * cs * B <= kSms) cs *= 2;
  while (cs < kMaxCluster && (long long)cs * kBlockCols < V) cs *= 2;
  return cs;
}

bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15u) == 0;
}

// `cluster` 0: cluster_size's choice
Config make_config(void* const* ptrs, int B, int V, int D, int step,
                   int full_view, int hot_gate, int decisions, int clear,
                   int cluster) {
  Config c{B, V, D, step, full_view, hot_gate, decisions, clear, 0, 0, 0, 0};
  if (B < 1 || V < 2 || D < 1) return c;
  c.cs = cluster ? cluster : cluster_size(B, V);
  c.cols = ((V + c.cs - 1) / c.cs + 3) & ~3;
  c.slots = (D + c.cs - 1) / c.cs;
  static const int rows[] = {0, 1, 10, 11, 12, 14, 15};  // the [B, V] rows
  bool vec = V % 4 == 0;
  for (int k : rows) vec = vec && aligned16(ptrs[k]);
  c.vec = vec;
  return c;
}

bool bad_config(const Config& c) {
  return c.B < 1 || c.V < 2 || c.D < 1 || c.V > kMaxCols ||
         (c.hot_gate && !c.decisions) ||
         (c.cs != 1 && c.cs != 2 && c.cs != 4 && c.cs != 8) ||
         c.cols > kBlockCols;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kThreads, 1)
dpll_step_kernel(Planes p, Config c) {
  __shared__ Lane s;
  __shared__ u64 lists[2][kWarps][kBulkK];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int b = blockIdx.x / c.cs;
  Cells t;
  phase_read(p, c, s, t, b, rank, tid);
  __syncthreads();
  if (!s.live) {  // the whole cluster: no shared memory crosses blocks
    phase_clear(p, c, s, t, b, rank, tid);
    return;
  }
  cluster_arrive();  // every block of the cluster has started
  phase_scan(p, c, s, t, b, rank, tid);
  __syncthreads();
  phase_owner(s, t);
  const bool ranked = ranks_keys(c, s);
  int top = 0;
  if (ranked && s.rounds == kBulkK) {
    warp_topk(t, lists[0][warp]);
    __syncthreads();
    for (int n = kWarps; n > 1; n >>= 1, top ^= 1) {
      merge_level(lists[top], lists[top ^ 1], n, warp);
      __syncthreads();
    }
  }
  __syncthreads();
  cluster_wait();
  phase_push(s, nullptr, lists[top][0], ranked, rank, tid);
  cluster_sync();
  if (rank == 0) {
    phase_lane(c, s, tid);
    __syncthreads();
    u64 best = 0;
    const u64* list = s.keys[0];
    if (s.topk && s.rounds == kBulkK) {
      u64(*src)[kBulkK] = s.keys;
      u64(*dst)[kBulkK] = s.keys2;
      for (int n = c.cs; n > 1; n >>= 1) {
        merge_level(src, dst, n, warp);
        __syncthreads();
        u64(*swap)[kBulkK] = src;
        src = dst;
        dst = swap;
      }
      list = src[0];
    } else if (s.topk) {
      for (int r = 0; r < c.cs; ++r) best = max64(best, s.keys[r][0]);
      list = &best;
    }
    phase_decide(s, list, warp);
    __syncthreads();
    phase_broadcast(c, s, nullptr, tid);
  }
  cluster_sync();
  phase_write(p, c, s, t, b, rank, tid);
}

#endif  // __CUDACC__

}  // namespace

extern "C" {

int dpll_step_threads() { return kThreads; }

int dpll_step_bulk_k() { return kBulkK; }

int dpll_step_single_window() { return kSingleWindow; }

int dpll_step_max_cols() { return kMaxCols; }

int dpll_step_cluster_size(int B, int V) { return cluster_size(B, V); }

#ifdef __CUDACC__

// Plain C entry point (bound with ctypes): `ptrs` holds the 17 pointers of
// Planes in order; `cluster` 0 takes cluster_size's choice.  Returns the cudaError_t of the launch; 0 means
// the kernel was queued on `stream`.
int dpll_step_launch(void* const* ptrs, int B, int V, int D, int step,
                     int full_view, int hot_gate, int decisions, int clear,
                     int cluster, void* stream) {
  const Config c = make_config(ptrs, B, V, D, step, full_view, hot_gate,
                               decisions, clear, cluster);
  if (bad_config(c)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * c.cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, dpll_step_kernel, planes_of(ptrs), c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#else  // host C++

// The kernel's phases on the host, lane after lane: each phase over every
// block of the lane's emulated cluster and each block's threads in turn
// (a warp's shuffles over its 32 lanes), in the order the block and
// cluster barriers give them.
int dpll_step_host(void* const* ptrs, int B, int V, int D, int step,
                   int full_view, int hot_gate, int decisions, int clear,
                   int cluster) {
  const Config c = make_config(ptrs, B, V, D, step, full_view, hot_gate,
                               decisions, clear, cluster);
  if (bad_config(c)) return 1;
  const Planes p = planes_of(ptrs);
  const int cs = c.cs;
  std::vector<Lane> lanes(cs);
  std::vector<Cells> cells((size_t)cs * kThreads);
  std::vector<u64> lists((size_t)cs * 2 * kWarps * kBulkK);
  auto list_of = [&](int r, int buf) {
    return reinterpret_cast<u64(*)[kBulkK]>(
        &lists[((size_t)r * 2 + buf) * kWarps * kBulkK]);
  };
  std::vector<int> ranked(cs), top(cs);
  for (int b = 0; b < B; ++b) {
    for (int r = 0; r < cs; ++r) {
      std::memset(&lanes[r], 0, sizeof(Lane));
      for (int t = 0; t < kThreads; ++t)
        phase_read(p, c, lanes[r], cells[(size_t)r * kThreads + t], b, r, t);
    }
    if (!lanes[0].live) {
      for (int r = 0; r < cs; ++r)
        for (int t = 0; t < kThreads; ++t)
          phase_clear(p, c, lanes[r], cells[(size_t)r * kThreads + t], b, r,
                      t);
      continue;
    }
    for (int r = 0; r < cs; ++r)
      for (int t = 0; t < kThreads; ++t)
        phase_scan(p, c, lanes[r], cells[(size_t)r * kThreads + t], b, r, t);
    for (int r = 0; r < cs; ++r) {
      Lane& s = lanes[r];
      Cells* mine = &cells[(size_t)r * kThreads];
      for (int t = 0; t < kThreads; ++t) phase_owner(s, mine[t]);
      ranked[r] = ranks_keys(c, s);
      top[r] = 0;
      if (!ranked[r] || s.rounds != kBulkK) continue;
      for (int w = 0; w < kWarps; ++w)
        warp_topk(mine + 32 * w, list_of(r, 0)[w]);
      for (int n = kWarps; n > 1; n >>= 1, top[r] ^= 1)
        for (int w = 0; w < kWarps; ++w)
          merge_level(list_of(r, top[r]), list_of(r, top[r] ^ 1), n, w);
    }
    for (int r = 0; r < cs; ++r)
      for (int t = 0; t < kThreads; ++t)
        phase_push(lanes[r], lanes.data(), list_of(r, top[r])[0], ranked[r],
                   r, t);
    Lane& root = lanes[0];
    for (int t = 0; t < kThreads; ++t) phase_lane(c, root, t);
    u64 best = 0;
    const u64* list = root.keys[0];
    if (root.topk && root.rounds == kBulkK) {
      u64(*src)[kBulkK] = root.keys;
      u64(*dst)[kBulkK] = root.keys2;
      for (int n = cs; n > 1; n >>= 1) {
        for (int w = 0; w < kWarps; ++w) merge_level(src, dst, n, w);
        u64(*swap)[kBulkK] = src;
        src = dst;
        dst = swap;
      }
      list = src[0];
    } else if (root.topk) {
      for (int r = 0; r < cs; ++r) best = max64(best, root.keys[r][0]);
      list = &best;
    }
    phase_decide(root, list, 0);
    for (int t = 0; t < kThreads; ++t)
      phase_broadcast(c, root, lanes.data(), t);
    for (int r = 0; r < cs; ++r)
      for (int t = 0; t < kThreads; ++t)
        phase_write(p, c, lanes[r], cells[(size_t)r * kThreads + t], b, r, t);
  }
  return 0;
}

#endif  // __CUDACC__

}  // extern "C"
