// One iteration of the frontier solvers as three kernels, for sm_90a.
//
// Replaces the loop bodies of the JAX package's frontier round
// (mythril_tpu/ops/frontier.py:453-596, with make_scan_rows at :257-329)
// and resident solver (mythril_tpu/ops/resident.py:385-549).  XLA runs
// those as lax.while_loops; here one loop iteration is three launches, with
// no host sync between iterations:
//
//   scan_rows_kernel       one block per lane: the BCP row scan over the
//                          iteration's view (all C pool rows, or the
//                          adjacency rows of the `fan` largest queued vars,
//                          popped from the lane's queue), plus in resident
//                          mode the shared learned rows (ids C + e).
//   lane_step_kernel       one block per lane: first-UIP learning and
//                          chronological backtrack, forcing, DLIS decision,
//                          SAT completion, bail, counters.
//   round_epilogue_kernel  block 0: append of the iteration's learned rows
//                          to the shared pool and the next iteration's
//                          batch-wide flags; block b: lane b's don't-care
//                          cascade (it must see the pool after the append).
//
// The control words ctl[2][kNctl] are double-buffered by iteration parity:
// every kernel of iteration t reads row t % 2, only the epilogue's block 0
// writes row (t + 1) % 2, so no block reads what another block of the same
// launch writes.  An iteration whose row has `halt` set changes nothing
// (the epilogue copies the row forward), so the host may read `halt` only
// every few iterations.  The plain PyTorch versions, which the card's
// results are held against bit for bit, are in ops/frontier_kernels.py.
//
// Everything is integer: scatter-max and scatter-add go through shared
// memory atomics on integers, whose result does not depend on the order.
// Ties follow jnp.argmax (first index): the keys pack (value, -index).
//
// Shared memory.  Every per-variable scratch array is dynamic shared
// memory sized by the launch (frontier_smem_bytes; the Python side's
// smem_layout mirrors it).  The scan keeps its four int32 accumulation
// planes there when they fit (V1 up to about 14,000) and otherwise
// accumulates in their output buffers with global atomics; the union-cone
// tier reaches V1 = 16385.
//
// Bound.  A full view reads the C x K int32 pool once per lane (512 KiB at
// C = 16384; all lanes share it through L2) and writes six [B, V1] int32
// planes; a gather view reads fan x deg rows.  The per-lane planes
// dominate the bytes: the kernels are memory-bound, and a design that
// kept the planes sparse or fused the three launches would move fewer
// bytes.  One block per lane leaves most SMs idle at B <= 64: a later
// change.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// Field order must match ops/frontier_kernels.py (_PTR_FIELDS, _INT_FIELDS).
struct FrontierArgs {
  const int32_t* lits;
  const int32_t* adj;
  int32_t* extra;
  int32_t* ctl;
  int8_t* assign;
  int32_t* lvl;
  int32_t* reason;
  int32_t* tpos;
  int32_t* dvar;
  int8_t* dphase;
  uint8_t* dflip;
  int32_t* depth;
  int32_t* status;
  int32_t* stamp;
  uint8_t* recent;
  int32_t* cspos;
  int32_t* csneg;
  int32_t* fullsw;
  int32_t* fsteps;
  int32_t* nlearn;
  int32_t* learned;
  const int8_t* pref;
  int32_t* fpos;
  int32_t* fneg;
  int32_t* rpos;
  int32_t* rneg;
  int32_t* spos;
  int32_t* sneg;
  int32_t* conflict;
  int32_t* crow;
  int32_t* litrow;
  int32_t* okl;
  int32_t* flags;
  int B, V1, C, deg, D, learn_cap, E, fan, period, limit, watchdog,
      uip_iters, resident, smem_planes, parity;
};

namespace {

constexpr int kK = 8;             // clause row width (MAX_CLAUSE_WIDTH)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
enum { kIt = 0, kHalt = 1, kFull = 2, kStall = 3, kNextra = 4, kNctl = 8 };
enum { kProgress = 1, kQueued = 2, kCascade = 4 };

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

enum { kScan = 0, kLane = 1, kEpilogue = 2 };

// Dynamic shared memory of each kernel: scan = [4 int32 planes if
// smem_planes] assignment bytes, queue bytes, popped vars; lane step =
// two marks, the UIP walk's list (each resolution adds at most kK vars);
// epilogue = the pool's var marks, each lane's append slot.
int smem_bytes(const FrontierArgs& a, int kernel) {
  if (kernel == kScan)
    return (a.smem_planes ? 16 * a.V1 : 0) + 2 * align16(a.V1) + 4 * a.fan;
  if (kernel == kLane)
    return 2 * align16(a.V1) + 4 * kK * (a.uip_iters + 1);
  return align16(a.V1) + 4 * a.B;
}

__device__ __forceinline__ void load_row(const int32_t* p, int (&l)[kK]) {
  const int4 x = reinterpret_cast<const int4*>(p)[0];
  const int4 y = reinterpret_cast<const int4*>(p)[1];
  l[0] = x.x; l[1] = x.y; l[2] = x.z; l[3] = x.w;
  l[4] = y.x; l[5] = y.y; l[6] = y.z; l[7] = y.w;
}

__device__ __forceinline__ int block_max(int v, int* red) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < kWarps ? red[threadIdx.x & 31] : INT_MIN;
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long block_max_u64(
    unsigned long long v, unsigned long long* red) {
  for (int o = 16; o; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < kWarps ? red[threadIdx.x & 31] : 0ull;
  for (int o = 16; o; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

// (value, -index) packed so that the maximum is the first maximal index.
__device__ __forceinline__ unsigned long long arg_key(int value_plus1, int v) {
  return ((unsigned long long)(unsigned)value_plus1 << 32) |
         (unsigned)(0x7fffffff - v);
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return 0x7fffffff - (int)(key & 0xffffffffu);
}

// One clause row against the lane's assignment (make_scan_rows): unit rows
// vote their literal (max of row id + 1), an all-false row is a conflict,
// open rows add their unknown literals to the scores.
__device__ __forceinline__ void eval_row(const int (&l)[kK], int id1,
                                         bool scores, int V1,
                                         const int8_t* sA, int* s_rpos,
                                         int* s_rneg, int* s_spos,
                                         int* s_sneg, int* s_conf) {
  int val[kK];
  int nunk = 0, unk = 0;
  bool real = false, sat = false, all_false = true;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    val[k] = 1;
    if (l[k] == 0) continue;
    real = true;
    const int v = min(abs(l[k]), V1 - 1);
    const int a = sA[v];
    const int s = l[k] > 0 ? a : -a;
    val[k] = s;
    if (s > 0) sat = true;
    if (s == 0) {
      ++nunk;
      unk = l[k];
    }
    if (s >= 0) all_false = false;
  }
  if (!real) return;
  if (all_false) atomicMax(s_conf, id1);
  if (sat) return;
  if (nunk == 1) {
    const int v = min(abs(unk), V1 - 1);
    atomicMax(unk > 0 ? s_rpos + v : s_rneg + v, id1);
  } else if (scores && nunk > 1) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      if (l[k] != 0 && val[k] == 0) {
        const int v = min(abs(l[k]), V1 - 1);
        atomicAdd(l[k] > 0 ? s_spos + v : s_sneg + v, 1);
      }
    }
  }
}

// kSmemPlanes: the reason-row and score planes accumulate in shared memory
// (else in the output buffers rpos/rneg/spos/sneg themselves).
template <bool kSmemPlanes>
__global__ void __launch_bounds__(kThreads) scan_rows_kernel(FrontierArgs a) {
  const int* ctl = a.ctl + a.parity * kNctl;
  if (ctl[kHalt]) return;
  extern __shared__ int4 smem4[];
  const int V1 = a.V1;
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t off = (size_t)b * V1;
  int *s_rpos, *s_rneg, *s_spos, *s_sneg;
  int8_t* sA;
  if (kSmemPlanes) {
    s_rpos = reinterpret_cast<int*>(smem4);
    s_rneg = s_rpos + V1;
    s_spos = s_rneg + V1;
    s_sneg = s_spos + V1;
    sA = reinterpret_cast<int8_t*>(s_sneg + V1);
  } else {
    s_rpos = a.rpos + off;
    s_rneg = a.rneg + off;
    s_spos = a.spos + off;
    s_sneg = a.sneg + off;
    sA = reinterpret_cast<int8_t*>(smem4);
  }
  uint8_t* sR = reinterpret_cast<uint8_t*>(sA + align16(V1));
  int* s_picked = reinterpret_cast<int*>(sR + align16(V1));
  __shared__ int s_conf;
  __shared__ int s_npicked;
  const bool full = ctl[kFull] != 0;
  uint8_t* recent = a.recent + off;
  for (int v = tid; v < V1; v += kThreads) {
    s_rpos[v] = 0;
    s_rneg[v] = 0;
    s_spos[v] = 0;
    s_sneg[v] = 0;
    sA[v] = a.assign[off + v];
    sR[v] = full ? 0 : recent[v];
  }
  if (tid == 0) {
    s_conf = 0;
    s_npicked = 0;
  }
  __syncthreads();

  if (full) {
    for (int v = tid; v < V1; v += kThreads) recent[v] = 0;
    for (int r = tid; r < a.C; r += kThreads) {
      int l[kK];
      load_row(a.lits + (size_t)r * kK, l);
      eval_row(l, r + 1, true, V1, sA, s_rpos, s_rneg, s_spos, s_sneg,
               &s_conf);
    }
  } else {
    // warp 0 pops the `fan` largest queued vars (lax.top_k over the ids)
    if (tid < 32) {
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
    }
    __syncthreads();
    const int n = s_npicked * a.deg;
    for (int i = tid; i < n; i += kThreads) {
      const int rid =
          a.adj[(size_t)s_picked[i / a.deg] * a.deg + (i % a.deg)];
      if (rid < 0) continue;
      int l[kK];
      load_row(a.lits + (size_t)rid * kK, l);
      eval_row(l, rid + 1, false, V1, sA, s_rpos, s_rneg, s_spos, s_sneg,
               &s_conf);
    }
  }
  if (a.resident) {
    const int ne = ctl[kNextra];
    for (int e = tid; e < ne; e += kThreads) {
      int l[kK];
      load_row(a.extra + (size_t)e * kK, l);
      eval_row(l, a.C + e + 1, false, V1, sA, s_rpos, s_rneg, s_spos, s_sneg,
               &s_conf);
    }
  }
  __syncthreads();
  for (int v = tid; v < V1; v += kThreads) {
    const int rp = s_rpos[v], rn = s_rneg[v];
    a.fpos[off + v] = rp > 0;
    a.fneg[off + v] = rn > 0;
    if (kSmemPlanes) {
      a.rpos[off + v] = rp;
      a.rneg[off + v] = rn;
      a.spos[off + v] = s_spos[v];
      a.sneg[off + v] = s_sneg[v];
    }
  }
  if (tid == 0) {
    a.conflict[b] = s_conf > 0;
    a.crow[b] = s_conf - 1;
  }
}

// Clause row `r`: a pool row, or in resident mode a shared learned row at
// ids >= C (clamped as jnp.clip does).
__device__ __forceinline__ const int32_t* fetch_row(const FrontierArgs& a,
                                                    int r) {
  if (a.resident && r >= a.C)
    return a.extra + (size_t)min(max(r - a.C, 0), a.E - 1) * kK;
  return a.lits + (size_t)min(max(r, 0), a.C - 1) * kK;
}

// Lane 0 of the walking warp: mark the vars of one row.
__device__ __forceinline__ void mark_row(const int32_t* row, int V1,
                                         uint8_t* marked, uint8_t* inlist,
                                         int* list, int* s_n) {
  int l[kK];
  load_row(row, l);
  int n = *s_n;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (l[k] == 0) continue;
    const int v = min(abs(l[k]), V1 - 1);
    marked[v] = 1;
    if (!inlist[v]) {
      inlist[v] = 1;
      list[n++] = v;
    }
  }
  *s_n = n;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// First-UIP walk of lane b, run by warp 0 (the frontier kernel's
// maybe_learn).  The marked set is kept as a list of the vars ever marked
// plus a bitmap, so each resolution step scans the list, not all of V1.
// Returns the emit flag; the canonical clause row goes to s_row.
__device__ int uip_walk(const FrontierArgs& a, int b, int depth, int crow,
                        int nlearn, uint8_t* marked, uint8_t* inlist,
                        int* list, int* s_n, int* s_row) {
  const int lane = threadIdx.x, V1 = a.V1;
  const size_t off = (size_t)b * V1;
  const int8_t* A = a.assign + off;
  const int32_t* lvl = a.lvl + off;
  const int32_t* reason = a.reason + off;
  const int32_t* tpos = a.tpos + off;
  if (lane == 0) mark_row(fetch_row(a, crow), V1, marked, inlist, list, s_n);
  __syncwarp();
  bool ok = true;
  for (int it = 0; it < a.uip_iters; ++it) {
    const int n = *(volatile int*)s_n;
    int cnt = 0;
    unsigned long long best = 0;
    for (int i = lane; i < n; i += 32) {
      const int v = list[i];
      if (marked[v] && lvl[v] == depth && A[v] != 0) {
        ++cnt;
        const unsigned long long key = arg_key(tpos[v] + 1, v);
        best = key > best ? key : best;
      }
    }
    cnt = warp_sum(cnt);
    for (int o = 16; o; o >>= 1) {
      const unsigned long long w = __shfl_xor_sync(0xffffffffu, best, o);
      best = w > best ? w : best;
    }
    if (cnt <= 1) break;  // no resolution left: later steps change nothing
    const int piv = key_index(best);
    const int r = reason[piv];
    if (r < 0) {  // a decision or assumption as pivot: drop the clause
      ok = false;
      break;
    }
    if (lane == 0) {
      mark_row(fetch_row(a, r), V1, marked, inlist, list, s_n);
      marked[piv] = 0;
    }
    __syncwarp();
  }
  __syncwarp();
  const int n = *(volatile int*)s_n;
  int total = 0, at_depth = 0;
  for (int i = lane; i < n; i += 32) {
    const int v = list[i];
    if (marked[v]) {
      ++total;
      at_depth += lvl[v] == depth;
    }
  }
  total = warp_sum(total);
  at_depth = warp_sum(at_depth);
  ok = ok && at_depth <= 1 && total >= 1 && total <= kK &&
       nlearn < a.learn_cap;
  if (lane == 0) {
    int sel[kK];
    int m = 0;
    if (ok) {
      for (int i = 0; i < n; ++i) {
        const int v = list[i];
        if (!marked[v]) continue;
        int j = m++;  // insertion, descending ids (lax.top_k order)
        while (j > 0 && sel[j - 1] < v) {
          sel[j] = sel[j - 1];
          --j;
        }
        sel[j] = v;
      }
    }
    for (int k = 0; k < kK; ++k)
      s_row[k] = k < m ? -(int)A[sel[k]] * sel[k] : 0;
  }
  __syncwarp();
  return ok;
}

__global__ void __launch_bounds__(kThreads) lane_step_kernel(FrontierArgs a) {
  const int* ctl = a.ctl + a.parity * kNctl;
  if (ctl[kHalt]) return;
  extern __shared__ int4 smem4[];
  const int V1 = a.V1, D = a.D;
  uint8_t* marked = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* inlist = marked + align16(V1);
  int* list = reinterpret_cast<int*>(inlist + align16(V1));
  __shared__ int red[kWarps];
  __shared__ unsigned long long redk[kWarps];
  __shared__ int s_n, s_ok, s_row[kK], s_bvar, s_bphase;

  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t off = (size_t)b * V1;
  int8_t* A = a.assign + off;
  int32_t* lvl = a.lvl + off;
  int32_t* reason = a.reason + off;
  int32_t* tpos = a.tpos + off;
  uint8_t* recent = a.recent + off;
  int32_t* cspos = a.cspos + off;
  int32_t* csneg = a.csneg + off;
  const int32_t* fpos = a.fpos + off;
  const int32_t* fneg = a.fneg + off;
  const int32_t* spos = a.spos + off;
  const int32_t* sneg = a.sneg + off;
  int32_t* dvar = a.dvar + (size_t)b * D;
  int8_t* dphase = a.dphase + (size_t)b * D;
  uint8_t* dflip = a.dflip + (size_t)b * D;
  const bool full = ctl[kFull] != 0;
  const int status = a.status[b], depth = a.depth[b], stamp = a.stamp[b];
  const bool active = status == 0;
  const bool conflict = a.conflict[b] != 0;
  const int crow = a.crow[b];
  const int nlearn = a.nlearn[b];

  // pass 1: forcing / open / queue flags, the DLIS argmax, the cached
  // scores (a full view refreshes them for every lane)
  int hf = 0, oa = 0, rq = 0;
  unsigned long long best = 0;
  for (int v = tid; v < V1; v += kThreads) {
    const bool free = A[v] == 0 && v > 1;  // col 1 = the TRUE anchor
    const bool forced = free && (fpos[v] > 0 || fneg[v] > 0);
    hf |= forced;
    oa |= free;
    rq |= recent[v];
    int sp, sn;
    if (full) {
      sp = spos[v];
      sn = sneg[v];
      cspos[v] = sp;
      csneg[v] = sn;
    } else {
      sp = cspos[v];
      sn = csneg[v];
    }
    const int score = (free && !forced) ? sp + sn + 1 : -1;
    const unsigned long long key = arg_key(score + 1, v);
    best = key > best ? key : best;
  }
  int lm = 0;
  for (int d = tid; d < D; d += kThreads)
    if (d < depth && !dflip[d]) lm = d + 1;
  const bool has_force = __syncthreads_or(hf);
  const bool open_any = __syncthreads_or(oa);
  const bool queued = __syncthreads_or(rq);
  best = block_max_u64(best, redk);
  const int Lm = block_max(lm, red);
  const int var = key_index(best);

  const int nstamp = stamp + (active ? 1 : 0);
  const bool unsat_now = active && conflict && Lm == 0;
  const bool do_bt = active && conflict && Lm > 0;
  const bool do_learn = do_bt && crow >= 0 && depth > 0;
  const bool do_force = active && !conflict && has_force;
  const bool want = active && !conflict && !has_force && open_any &&
                    (full || !queued);
  const bool do_dec = want && depth < D;
  const bool bail = want && depth >= D;
  const bool done_sat = active && !conflict && !has_force && !open_any && full;

  // --- conflict: learn, then chronological backtrack
  if (do_learn) {
    for (int v = tid; v < V1; v += kThreads) {
      marked[v] = 0;
      inlist[v] = 0;
    }
    if (tid == 0) s_n = 0;
    __syncthreads();
    if (tid < 32) {
      const int ok = uip_walk(a, b, depth, crow, nlearn, marked, inlist,
                              list, &s_n, s_row);
      if (tid == 0) s_ok = ok;
    }
  } else if (tid == 0) {
    s_ok = 0;
    for (int k = 0; k < kK; ++k) s_row[k] = 0;
  }
  if (do_bt && tid == 0) {
    const int bslot = max(Lm - 1, 0);
    s_bvar = dvar[bslot];
    s_bphase = -(int)dphase[bslot];
  }
  __syncthreads();
  if (tid < kK) {
    a.litrow[(size_t)b * kK + tid] = s_ok ? s_row[tid] : 0;
    if (s_ok) {
      const int slot = min(max(nlearn, 0), a.learn_cap - 1);
      a.learned[((size_t)b * a.learn_cap + slot) * kK + tid] = s_row[tid];
    }
  }
  int new_depth = depth;
  if (do_bt) {
    const int bvar = s_bvar, bphase = s_bphase, bslot = max(Lm - 1, 0);
    for (int v = tid; v < V1; v += kThreads) {
      if (v == bvar) {
        A[v] = (int8_t)bphase;
        lvl[v] = Lm;
        reason[v] = -1;
        tpos[v] = nstamp;
        recent[v] = 1;
      } else if (A[v] != 0 && lvl[v] >= Lm) {
        A[v] = 0;
        recent[v] = 0;
      }
    }
    for (int d = tid; d < D; d += kThreads) {
      if (d >= Lm) {
        dvar[d] = 0;
        dphase[d] = 0;
        dflip[d] = 0;
      } else if (d == bslot) {
        dphase[d] = (int8_t)bphase;
        dflip[d] = 1;
      }
    }
    new_depth = Lm;
  } else if (do_force) {
    // quiet + forced: every forced literal, with its reason row (the
    // positive phase wins a contradictory pair)
    for (int v = tid; v < V1; v += kThreads) {
      if (A[v] != 0 || v <= 1) continue;
      const bool fp = fpos[v] > 0;
      if (!fp && fneg[v] <= 0) continue;
      A[v] = fp ? 1 : -1;
      lvl[v] = depth;
      reason[v] = (fp ? a.rpos[off + v] : a.rneg[off + v]) - 1;
      tpos[v] = nstamp;
      recent[v] = 1;
    }
  } else if (do_dec) {
    // quiet + open: one DLIS decision (the cascade is the epilogue's)
    if (tid == 0) {
      const int sp = full ? spos[var] : cspos[var];
      const int sn = full ? sneg[var] : csneg[var];
      const int pv = a.pref[off + var];
      const int phase = pv != 0 ? pv : (sp >= sn ? 1 : -1);
      A[var] = (int8_t)phase;
      lvl[var] = depth + 1;
      reason[var] = -1;
      tpos[var] = nstamp;
      recent[var] = 1;
      dvar[depth] = var;
      dphase[depth] = (int8_t)phase;
      dflip[depth] = 0;
    }
    new_depth = depth + 1;
  }
  if (tid == 0) {
    int st = status;
    if (unsat_now) st = 2;
    if (done_sat) st = 1;
    if (bail) st = 3;
    a.status[b] = st;
    a.depth[b] = new_depth;
    a.stamp[b] = nstamp;
    a.nlearn[b] = nlearn + (s_ok ? 1 : 0);
    a.okl[b] = s_ok;
    if (active) {
      if (full)
        a.fullsw[b] += 1;
      else
        a.fsteps[b] += 1;
    }
    const bool progress =
        do_force || do_bt || do_dec || unsat_now || done_sat || bail;
    const bool still_queued = do_bt || do_force || do_dec || queued;
    a.flags[b] = (progress ? kProgress : 0) | (still_queued ? kQueued : 0) |
                 (do_dec && full ? kCascade : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
    round_epilogue_kernel(FrontierArgs a) {
  const int* cur = a.ctl + a.parity * kNctl;
  int* nxt = a.ctl + (1 - a.parity) * kNctl;
  const int b = blockIdx.x, tid = threadIdx.x, B = a.B, V1 = a.V1;
  if (cur[kHalt]) {
    if (b == 0 && tid < kNctl) nxt[tid] = cur[tid];
    return;
  }
  const bool lead = b == 0;
  const bool pending = (a.flags[b] & kCascade) != 0;
  if (!lead && !pending) return;
  extern __shared__ int4 smem4[];
  uint8_t* in_extra = reinterpret_cast<uint8_t*>(smem4);
  int* s_slot = reinterpret_cast<int*>(in_extra + align16(V1));  // -1 none
  __shared__ int s_ne1;
  const int ne = cur[kNextra];

  // the append (resident): lane order, dedup against the live pool and
  // against earlier lanes, consecutive slots, overflow dropped.  Every
  // block that needs it computes it; only block 0 writes the pool, and
  // only rows >= ne, which no other block reads.
  if (a.resident) {
    for (int j = tid; j < B; j += kThreads) {
      const int32_t* row = a.litrow + (size_t)j * kK;
      bool ok = a.okl[j] != 0;
      bool nz = false;
      for (int k = 0; k < kK; ++k) nz |= row[k] != 0;
      ok = ok && nz;
      for (int e = 0; ok && e < ne; ++e) {
        bool same = true;
        for (int k = 0; k < kK; ++k) same &= a.extra[(size_t)e * kK + k] == row[k];
        ok = !same;
      }
      for (int i = 0; ok && i < j; ++i) {
        if (!a.okl[i]) continue;
        bool same = true;
        for (int k = 0; k < kK; ++k) same &= a.litrow[(size_t)i * kK + k] == row[k];
        ok = !same;
      }
      s_slot[j] = ok;
    }
    __syncthreads();
    if (tid == 0) {
      int c = ne;
      for (int j = 0; j < B; ++j) {
        if (s_slot[j]) {
          s_slot[j] = c < a.E ? c : -1;
          ++c;
        } else {
          s_slot[j] = -1;
        }
      }
      s_ne1 = min(a.E, c);
    }
    __syncthreads();
    if (lead) {
      for (int i = tid; i < B * kK; i += kThreads) {
        const int slot = s_slot[i / kK];
        if (slot >= 0) a.extra[(size_t)slot * kK + i % kK] = a.litrow[i];
      }
    }
  } else if (tid == 0) {
    s_ne1 = ne;
  }
  __syncthreads();
  const int ne1 = s_ne1;

  if (pending) {
    // the don't-care cascade of lane b's decision on a full view: free
    // vars in no open clause, minus the vars of the pool after the append
    for (int v = tid; v < V1; v += kThreads) in_extra[v] = 0;
    __syncthreads();
    for (int i = tid; i < ne * kK; i += kThreads) {
      const int l = a.extra[i];
      if (l) in_extra[min(abs(l), V1 - 1)] = 1;
    }
    if (a.resident) {
      for (int i = tid; i < B * kK; i += kThreads) {
        const int l = a.litrow[i];
        if (l && s_slot[i / kK] >= 0) in_extra[min(abs(l), V1 - 1)] = 1;
      }
    }
    __syncthreads();
    const size_t off = (size_t)b * V1;
    const int depth = a.depth[b], stamp = a.stamp[b];
    for (int v = 2 + tid; v < V1; v += kThreads) {
      if (a.assign[off + v] == 0 && a.spos[off + v] + a.sneg[off + v] == 0 &&
          !in_extra[v]) {
        a.assign[off + v] = 1;
        a.lvl[off + v] = depth;
        a.reason[off + v] = -1;
        a.tpos[off + v] = stamp;
      }
    }
  }

  if (lead) {
    int live = 0, queued = 0, progress = 0;
    for (int j = tid; j < B; j += kThreads) {
      const int f = a.flags[j];
      const bool l = a.status[j] == 0;
      live |= l;
      queued |= l && (f & kQueued);
      progress |= (f & kProgress) != 0;
    }
    live = __syncthreads_or(live);
    queued = __syncthreads_or(queued);
    progress = __syncthreads_or(progress);
    if (tid == 0) {
      const int it1 = cur[kIt] + 1;
      const int stall1 = a.resident ? (progress ? 0 : cur[kStall] + 1) : 0;
      const bool go = live && it1 < a.limit &&
                      (!a.resident || stall1 < a.watchdog);
      for (int k = 0; k < kNctl; ++k) nxt[k] = 0;
      nxt[kIt] = it1;
      nxt[kHalt] = go ? 0 : 1;
      nxt[kFull] = (it1 % a.period == 0 || !queued) ? 1 : 0;
      nxt[kStall] = stall1;
      nxt[kNextra] = ne1;
    }
  }
}

int checked(const FrontierArgs* a) {
  if (a->B < 1 || a->V1 < 2 || a->C < 1 || a->deg < 1 || a->D < 1 ||
      a->fan < 1 || a->fan > a->V1 || a->uip_iters < 0 || a->period < 1 ||
      a->learn_cap < 1 || (a->resident && a->E < 1))
    return 0;
  return 1;
}

template <typename Kernel>
int launch(Kernel kernel, int smem, int* configured, const FrontierArgs* a,
           void* stream) {
  if (!checked(a)) return (int)cudaErrorInvalidValue;
  if (smem > *configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    *configured = smem;
  }
  kernel<<<a->B, kThreads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int scan_smem_configured = 0, scan_global_configured = 0;
int lane_configured = 0, epilogue_configured = 0;

}  // namespace

extern "C" {

// Plain C entry points (bound with ctypes).  Each returns the cudaError_t
// of its launch; 0 means the kernel was queued on `stream`.
int frontier_scan_rows_launch(const FrontierArgs* a, void* stream) {
  const int smem = smem_bytes(*a, kScan);
  if (a->smem_planes)
    return launch(scan_rows_kernel<true>, smem, &scan_smem_configured, a,
                  stream);
  return launch(scan_rows_kernel<false>, smem, &scan_global_configured, a,
                stream);
}

int frontier_lane_step_launch(const FrontierArgs* a, void* stream) {
  return launch(lane_step_kernel, smem_bytes(*a, kLane), &lane_configured, a,
                stream);
}

int frontier_round_epilogue_launch(const FrontierArgs* a, void* stream) {
  return launch(round_epilogue_kernel, smem_bytes(*a, kEpilogue),
                &epilogue_configured, a, stream);
}

int frontier_width() { return kK; }

// Dynamic shared memory of one kernel (0 scan, 1 lane step, 2 epilogue).
int frontier_smem_bytes(const FrontierArgs* a, int kernel) {
  return smem_bytes(*a, kernel);
}

}  // extern "C"
