// Per-lane chronological DPLL over the full clause pool, for sm_90a: the
// gather tiers' round lane and the async prefetch's one-shot solve.
//
// Replaces the XLA while_loop of mythril_tpu/ops/batched_sat.py:468-638
// (build_round_lane -> round_lane, vmapped by make_round_step and, through
// build_solve_lane, by make_solve_step at :641-720).  Same function, the
// whole loop of every lane inside one launch:
//
//   while status == 0 and step < budget:
//     scan every clause row lits[c, 0:8] under the lane's assignment
//     (padding literals 0 count as false): a row with every literal false
//     is a conflict; a unit row votes its unknown literal (scatter-max);
//     an open row (2+ unknown) adds its unknown literals to the DLIS
//     scores spos / sneg (scatter-add);
//     free = unassigned and v > 1 (column 1 is the TRUE anchor);
//     conflict |= a free var voted both ways;
//     conflict: backtrack to the deepest unflipped decision (unassign
//       every var with lvl >= Lm, flip that decision at level Lm, pop the
//       stack above it), or UNSAT (status 2) when there is none;
//     else forced vars: assign every vote at the current depth;
//     else open vars: decide argmax(spos + sneg + 1) (first index on a
//       tie), phase pref[v] where nonzero, else +1 iff spos >= sneg; the
//       free vars in no open row (don't-cares) get +1 at the new level;
//       bail (status 3) when the stack is full;
//     else SAT candidate (status 1);
//     step += 1.
//
// State per lane: assign int8 [V1], lvl int32 [V1], dvar int32 [D],
// dphase int8 [D], dflip bool [D], depth / status / step int32, pref int8
// [V1] (read only).  Every field is integer logic and every reduction an
// integer sum, OR or max, so the result equals the plain PyTorch version
// (ops/round_lane.py:round_lane_plain) and the JAX loop bit for bit.
//
// Bound: every sweep scans C x 8 literal cells and V1 vars, which the
// data needs (the algorithm rescans the pool each sweep); bytes are the
// pool once and the state in and out.  A launch is operation-bound.
//
// Design.  One block of 1,024 threads a lane left SMs idle below 132 lanes,
// waited on two L2 loads per pool row, sixteen rows a thread one after
// another, and counted every open row's unknown literals into the DLIS
// scores with shared-memory atomics, every sweep.  Now each lane runs on
// a thread-block cluster of S blocks (the smallest power of two whose B x
// S blocks fill the card, up to 8; round_lane_cluster):
//
//   - block r scans every S-th pool row from row r.  Where they fit, they
//     are copied once a launch into shared memory as int16 literals (16
//     bytes a row) and read from there every sweep; else they are read
//     from global memory every sweep (the pool, shared by every lane,
//     stays in L2) with the thread's next row in flight.  A warp visits a
//     row's literals only up to the widest of its 32 rows;
//   - every block keeps a replica of the lane's assignment (the scan reads
//     it at random) and of its phase preference and decision stack;
//   - block r owns the vars [r Ws, (r + 1) Ws): their levels, unit votes
//     (two bitmaps) and DLIS scores.  The scan's votes and scores go to
//     the owner through distributed shared memory (atomicOr / atomicAdd
//     on the mapped address);
//   - each warp reduces its vars' flags and argmax key ((score + 1) << 32
//     | (0x7fffffff - v) << 1 | dlis phase, so the first index wins a tie)
//     and writes them into every block, with a word of four bitmaps over
//     its 32 vars: the votes both ways, the don't-cares, and the vars a
//     backtrack to the deepest unflipped decision would unassign;
//   - every warp then picks the action from the S x 32 partials and the
//     stack, and every block applies it to its whole replica from the
//     words (and to its own levels): no block waits on another for it,
//     and no replica needs another block's writes;
//   - a row found satisfied records the level by which it was (the depth,
//     or the deepest level of the launch's initial assignment; saturated
//     records fall to any backtrack); it is skipped until a backtrack to
//     Lm <= that level voids the record: a satisfied row adds nothing to
//     a conflict, a vote or a score, and only a backtrack unassigns.
//     Each thread scans the same rows every sweep, so its records need
//     no barrier, and it clears a voided record when it next scans it;
//   - the scores count the other way, so an open row takes no atomic: a
//     var's score starts as its occurrences in the pool, a row leaves it
//     when recorded and comes back when its record is cleared.  Where a
//     decision reads the scores no free var has a vote, so no unit row
//     holds a free var, and a free var's count is that of the open rows.
//
// A sweep is two cluster barriers (votes landed, partials and words
// landed) and one block barrier (the replica applied).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWidth = 8;       // literals a clause row (MAX_CLAUSE_WIDTH)
constexpr int kThreads = 1024;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kClusterBlocks = 128;    // a block on about every one of 132 SMs
constexpr int kSaturated = 0xffff;  // records are uint16: level + 1
// dynamic shared memory a block may take on sm_90 (227 KB), less 4 KB for
// the kernel's static shared variables (ops/round_lane.py mirrors it)
constexpr int kMaxDynamicSmem = 232448 - 4096;

enum Action : int { kNone = 0, kBacktrack = 1, kForce = 2, kDecide = 3 };
enum Flag : int { kConflict = 1, kVote = 2, kOpen = 4 };

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// Vars a cluster block owns: whole words of the vote bitmaps.
__host__ __device__ inline int slice_width(int V1, int S) {
  return ((V1 + S - 1) / S + 31) & ~31;
}

// Byte offsets of one block's dynamic shared memory at cluster size S.
struct Layout {
  int Ws, n, pos, neg, lvl, fpos, fneg, dvar, assign, pref, dphase, dflip,
      words, rec, rows, resident, bytes;
};

__host__ __device__ inline Layout layout(int C, int V1, int D, int S) {
  Layout L;
  L.Ws = slice_width(V1, S);
  L.n = (C + S - 1) / S;  // pool rows of a block
  const int dp = pad16(D);
  const int replica = S * L.Ws;
  L.pos = 0;
  L.neg = L.pos + 4 * L.Ws;
  L.lvl = L.neg + 4 * L.Ws;
  L.fpos = L.lvl + 4 * L.Ws;
  L.fneg = L.fpos + pad16(L.Ws / 8);
  L.dvar = L.fneg + pad16(L.Ws / 8);
  L.assign = L.dvar + 4 * dp;
  L.pref = L.assign + replica;
  L.dphase = L.pref + replica;
  L.dflip = L.dphase + dp;
  L.words = L.dflip + dp;
  L.rec = L.words + replica / 2;  // an int4 of bitmaps a 32-var word
  L.rows = L.rec + pad16(2 * L.n);
  // the rows as int16 literals (|x| <= 32767) where they fit
  L.resident = V1 <= 32768 && L.rows + 16 * L.n <= kMaxDynamicSmem;
  L.bytes = L.rows + (L.resident ? 16 * L.n : 0);
  return L;
}

// The smallest power of two S whose B x S blocks fill the card (up to 8)
// and whose block fits; 0 when no block fits.
__host__ __device__ inline int cluster_size(int B, int C, int V1, int D) {
  for (int S = 1; S <= kMaxCluster; S *= 2)
    if ((B * S >= kClusterBlocks || S == kMaxCluster) &&
        layout(C, V1, D, S).bytes <= kMaxDynamicSmem)
      return S;
  return 0;
}

// A cluster barrier: every thread of every block arrives and waits, from
// code that is uniform across the cluster; the arrive releases what the
// thread wrote before it, the wait acquires what the others did.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The warp's largest 64-bit key: the high words' max, then the low words'
// among the lanes that hold it.
__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long x) {
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  const uint32_t top = __reduce_max_sync(0xffffffffu, hi);
  const uint32_t lo = __reduce_max_sync(
      0xffffffffu, hi == top ? static_cast<uint32_t>(x) : 0u);
  return (static_cast<unsigned long long>(top) << 32) | lo;
}

__device__ __forceinline__ int4 pack_row(int4 a, int4 b) {
  auto two = [](int lo, int hi) {
    return static_cast<int>((static_cast<uint32_t>(lo) & 0xffffu) |
                            (static_cast<uint32_t>(hi) << 16));
  };
  return make_int4(two(a.x, a.y), two(a.z, a.w), two(b.x, b.y),
                   two(b.z, b.w));
}

__device__ __forceinline__ void unpack_row(int4 w, int (&l)[kWidth]) {
  const int q[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    l[2 * j] = static_cast<int>(static_cast<int16_t>(q[j] & 0xffff));
    l[2 * j + 1] = q[j] >> 16;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
round_lane_kernel(const int4* __restrict__ lits, int C,
                  int8_t* __restrict__ assign, int32_t* __restrict__ lvl,
                  int32_t* __restrict__ dvar, int8_t* __restrict__ dphase,
                  uint8_t* __restrict__ dflip, int32_t* __restrict__ depth_g,
                  int32_t* __restrict__ status_g, int32_t* __restrict__ step_g,
                  const int8_t* __restrict__ pref, int V1, int D,
                  int budget) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / S;
  const int tid = threadIdx.x, wid = tid >> 5, lid = tid & 31;
  const Layout L = layout(C, V1, D, S);
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sPos = reinterpret_cast<int32_t*>(smem + L.pos);
  int32_t* sNeg = reinterpret_cast<int32_t*>(smem + L.neg);
  int32_t* sLvl = reinterpret_cast<int32_t*>(smem + L.lvl);
  uint32_t* sFpos = reinterpret_cast<uint32_t*>(smem + L.fpos);
  uint32_t* sFneg = reinterpret_cast<uint32_t*>(smem + L.fneg);
  int32_t* sDvar = reinterpret_cast<int32_t*>(smem + L.dvar);
  int8_t* sA = reinterpret_cast<int8_t*>(smem + L.assign);
  int8_t* sPref = reinterpret_cast<int8_t*>(smem + L.pref);
  int8_t* sDphase = reinterpret_cast<int8_t*>(smem + L.dphase);
  uint8_t* sDflip = smem + L.dflip;
  int4* sWords = reinterpret_cast<int4*>(smem + L.words);
  uint16_t* sRec = reinterpret_cast<uint16_t*>(smem + L.rec);
  int4* sRows = reinterpret_cast<int4*>(smem + L.rows);

  // each warp's flags and argmax key, by the block's rank and the warp
  __shared__ int s_pflags[kMaxCluster][kWarps];
  __shared__ unsigned long long s_pkey[kMaxCluster][kWarps];
  __shared__ int red[kWarps];

  const int Ws = L.Ws, v0 = rank * Ws;
  const int nown = max(0, min(Ws, V1 - v0));  // vars this block owns
  // this block's pool rows: rank, rank + S, ...; the i-th at rows[gap i]
  // (gap counts int4s, two a row)
  const int nrows = max(0, (C - rank + S - 1) / S);
  const int4* rows = lits + 2 * rank;
  const int gap = 2 * S;
  const size_t row = static_cast<size_t>(lane) * V1;
  const size_t drow = static_cast<size_t>(lane) * D;
  const int replica = S * Ws;

  // the lane's state: replicas, this block's slice, the stack
  int lmax = 0;  // the deepest level of the initial assignment
  for (int v = tid; v < replica; v += kThreads) {
    const int8_t a = v < V1 ? assign[row + v] : 0;
    sA[v] = a;
    sPref[v] = v < V1 ? pref[row + v] : 0;
    if (a != 0) lmax = max(lmax, lvl[row + v]);
  }
  for (int i = tid; i < nown; i += kThreads) {
    sLvl[i] = lvl[row + v0 + i];
    sPos[i] = 0;
    sNeg[i] = 0;
  }
  for (int w = tid; w < Ws / 32; w += kThreads) {
    sFpos[w] = 0u;
    sFneg[w] = 0u;
  }
  for (int d = tid; d < D; d += kThreads) {
    sDvar[d] = dvar[drow + d];
    sDphase[d] = dphase[drow + d];
    sDflip[d] = dflip[drow + d] ? 1 : 0;
  }
  for (int i = tid; i < nrows; i += kThreads) sRec[i] = 0;
  if (L.resident)
    for (int i = tid; i < nrows; i += kThreads)
      sRows[i] = pack_row(rows[gap * i], rows[gap * i + 1]);
  lmax = __reduce_max_sync(0xffffffffu, lmax);
  if (lid == 0) red[wid] = lmax;
  int depth = depth_g[lane], status = status_g[lane], step = step_g[lane];
  cluster.sync();  // every block has started and loaded its state
  auto barrier = [&] {  // uniform across the cluster
    if (S > 1)
      cluster_barrier();
    else
      __syncthreads();
  };
  lmax = __reduce_max_sync(0xffffffffu, lid < kWarps ? red[lid] : 0);

  // var |x|'s count of the literal x, at the block that owns the var
  auto bump = [&](int x, int delta) {
    const int v = x > 0 ? x : -x;
    const int owner = v / Ws, j = v - owner * Ws;
    int32_t* slot = (x > 0 ? sPos : sNeg) + j;
    if (owner == rank)
      atomicAdd(slot, delta);
    else
      atomicAdd(cluster.map_shared_rank(slot, owner), delta);
  };
  // the scores start as the pool's occurrences (only where the loop runs:
  // its barriers keep a block's shared memory live until they land)
  const bool runs = status == 0 && step < budget;
  if (runs)
    for (int i = tid; i < nrows; i += kThreads) {
      int l[kWidth];
      if (L.resident) {
        unpack_row(sRows[i], l);
      } else {
        const int4 a = rows[gap * i], b = rows[gap * i + 1];
        const int q[kWidth] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int k = 0; k < kWidth; ++k) l[k] = q[k];
      }
#pragma unroll
      for (int k = 0; k < kWidth; ++k)
        if (l[k] != 0) bump(l[k], 1);
    }

  int clear = kSaturated;  // records above it are void: the last Lm

  while (status == 0 && step < budget) {
    // 1. the clause scan over this block's rows: conflicts, votes to the
    //    owners of their vars; a row satisfied now is recorded (its
    //    literals leave the scores), a record a backtrack voided is
    //    cleared (they come back), a recorded row is skipped
    const int level = min(max(depth, lmax) + 1, kSaturated);
    int conflict = 0;
    // row i's literals l, of which those past kw (the warp's widest row)
    // are padding
    auto visit = [&](const int (&l)[kWidth], int i, int kw) {
      bool real = false, sat = false;
      int nunk = 0, usum = 0;
#pragma unroll
      for (int k = 0; k < kWidth; ++k) {
        if (k >= kw) break;  // uniform across the warp
        const int x = l[k];
        const int a = x != 0 ? sA[x > 0 ? x : -x] : 0;
        const int val = x > 0 ? a : -a;
        real |= x != 0;
        sat |= val > 0;
        if (x != 0 && val == 0) {
          ++nunk;
          usum += x;
        }
      }
      const bool had = sRec[i] != 0;
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
      if (!real) return;
      if (nunk == 0) {
        conflict = kConflict;
      } else if (nunk == 1) {
        const int v = usum > 0 ? usum : -usum;
        const int owner = v / Ws, j = v - owner * Ws;
        uint32_t* word = (usum > 0 ? sFpos : sFneg) + (j >> 5);
        if (owner == rank)
          atomicOr(word, 1u << (j & 31));
        else
          atomicOr(cluster.map_shared_rank(word, owner), 1u << (j & 31));
      }
    };
    // a row whose record stands: satisfied, adds nothing
    auto skip = [&](int i) {
      return sRec[i] != 0 && sRec[i] <= clear;
    };
    // the warp's widest row to visit (a row's width: its last nonzero
    // literal's place + 1)
    auto widest = [&](const int (&l)[kWidth], bool live) {
      int width = 0;
#pragma unroll
      for (int k = 0; k < kWidth; ++k)
        if (l[k] != 0) width = k + 1;
      return static_cast<int>(
          __reduce_max_sync(0xffffffffu, live ? width : 0));
    };
    if (L.resident) {
      for (int base = 0; base < nrows; base += kThreads) {
        const int i = base + tid;
        const bool live = i < nrows && !skip(i);
        int l[kWidth];
        unpack_row(live ? sRows[i] : make_int4(0, 0, 0, 0), l);
        const int kw = widest(l, live);
        if (live) visit(l, i, kw);
      }
    } else {  // from global memory (L2), the thread's next row in flight
      int4 a = make_int4(0, 0, 0, 0), b = a;
      if (tid < nrows) {
        a = rows[gap * tid];
        b = rows[gap * tid + 1];
      }
      for (int base = 0; base < nrows; base += kThreads) {
        const int i = base + tid;
        const int4 ca = a, cb = b;
        if (i + kThreads < nrows) {
          a = rows[gap * (i + kThreads)];
          b = rows[gap * (i + kThreads) + 1];
        }
        const bool live = i < nrows && !skip(i);
        const int l[kWidth] = {ca.x, ca.y, ca.z, ca.w,
                               cb.x, cb.y, cb.z, cb.w};
        const int kw = widest(l, live);
        if (live) visit(l, i, kw);
      }
    }
    barrier();  // every vote and score has landed

    // 2. this block's flags and argmax key, and the bitmaps of its
    //    vars' votes, don't-cares and of the vars a backtrack to Lm
    //    would unassign, into every block (Lm: the deepest unflipped
    //    decision's level, 0 when there is none)
    int Lm = 0;
    for (int base = (depth - 1) & ~31; base >= 0; base -= 32) {
      const int d = base + lid;
      const unsigned m = __ballot_sync(0xffffffffu, d < depth && !sDflip[d]);
      if (m) {
        Lm = base + 32 - __clz(m);
        break;
      }
    }
    int flags = conflict;
    unsigned long long key = 0ull;
    // the word of this warp's 32 vars from i0, its flags and key
    auto word = [&](int i0, uint32_t fpw, uint32_t fnw, int a, int lv, int sp,
                    int sn) {
      const int i = i0 + lid, v = v0 + i;
      const bool in = i < nown;
      const bool fp = in && (fpw >> lid & 1u), fn = in && (fnw >> lid & 1u);
      const bool free = in && a == 0 && v >= 2;
      if (free) {
        flags |= kOpen | (fp || fn ? kVote : 0) | (fp && fn ? kConflict : 0);
        const unsigned long long k =
            (static_cast<unsigned long long>(sp + sn + 1) << 32) |
            ((0x7fffffffu - static_cast<uint32_t>(v)) << 1) | (sp >= sn);
        key = k > key ? k : key;
      }
      return make_int4(
          static_cast<int>(__ballot_sync(0xffffffffu, fp)),
          static_cast<int>(__ballot_sync(0xffffffffu, fn)),
          static_cast<int>(__ballot_sync(0xffffffffu, free && sp + sn == 0)),
          static_cast<int>(__ballot_sync(0xffffffffu,
                                         in && a != 0 && Lm > 0 && lv >= Lm)));
    };
    // two words a warp at a time, every load of both issued first (the
    // slice's arrays hold Ws entries, so a var past nown reads padding)
    for (int i0 = wid * 32; i0 < nown; i0 += 2 * kThreads) {
      const int i1 = min(i0 + kThreads, Ws - 32);
      const bool two = i0 + kThreads < nown;
      const uint32_t fp0 = sFpos[i0 >> 5], fn0 = sFneg[i0 >> 5];
      const uint32_t fp1 = sFpos[i1 >> 5], fn1 = sFneg[i1 >> 5];
      const int a0 = sA[v0 + i0 + lid], a1 = sA[v0 + i1 + lid];
      const int l0 = sLvl[i0 + lid], l1 = sLvl[i1 + lid];
      const int p0 = sPos[i0 + lid], p1 = sPos[i1 + lid];
      const int n0 = sNeg[i0 + lid], n1 = sNeg[i1 + lid];
      const int4 w0 = word(i0, fp0, fn0, a0, l0, p0, n0);
      int4 w1 = w0;
      if (two) w1 = word(i1, fp1, fn1, a1, l1, p1, n1);
      if (lid == 0) {  // every lane has read the votes: clear them
        sFpos[i0 >> 5] = 0u;
        sFneg[i0 >> 5] = 0u;
        if (two) {
          sFpos[i1 >> 5] = 0u;
          sFneg[i1 >> 5] = 0u;
        }
      }
      if (lid < S) {  // lane j: the words into block j
        *cluster.map_shared_rank(sWords + ((v0 + i0) >> 5), lid) = w0;
        if (two)
          *cluster.map_shared_rank(sWords + ((v0 + i1) >> 5), lid) = w1;
      }
    }
    flags = static_cast<int>(__reduce_or_sync(0xffffffffu, flags));
    key = warp_max_u64(key);
    if (lid < S) {  // lane j: this warp's partial into block j
      *cluster.map_shared_rank(&s_pflags[rank][wid], lid) = flags;
      *cluster.map_shared_rank(&s_pkey[rank][wid], lid) = key;
    }
    barrier();  // every partial and every word is in every block

    // 3. the lane's action, picked by every warp from the partials
    int f = 0;
    unsigned long long best = 0ull;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < S && lid < kWarps) {
        f |= s_pflags[r][lid];
        best = s_pkey[r][lid] > best ? s_pkey[r][lid] : best;
      }
    }
    f = static_cast<int>(__reduce_or_sync(0xffffffffu, f));
    best = warp_max_u64(best);
    const int dep = depth;
    int act = kNone, bvar = -1, var = -1, phase = 0;
    if (f & kConflict) {
      if (Lm == 0) {
        status = 2;
      } else {
        act = kBacktrack;
        bvar = sDvar[Lm - 1];
        phase = -sDphase[Lm - 1];
        depth = Lm;
      }
    } else if (f & kVote) {
      act = kForce;
    } else if (f & kOpen) {
      if (dep < D) {
        act = kDecide;
        var = static_cast<int>(0x7fffffffu -
                               (static_cast<uint32_t>(best) >> 1));
        const int p = sPref[var];
        phase = p != 0 ? p : ((best & 1) ? 1 : -1);
        depth = dep + 1;
      } else {
        status = 3;
      }
    } else {
      status = 1;
    }
    ++step;

    // 4. apply it to the whole replica from the words (and to this
    //    block's levels), a word a warp; a word with none of the action's
    //    bits is skipped
    for (int w = wid; w < (V1 + 31) / 32; w += kWarps) {
      const int4 g = sWords[w];
      const int v = 32 * w + lid;
      const uint32_t bit = 1u << lid;
      uint32_t touch = 0u;  // the word's vars the action may change
      if (act == kBacktrack)
        touch = static_cast<uint32_t>(g.w) |
                (bvar >> 5 == w ? 1u << (bvar & 31) : 0u);
      else if (act == kForce)
        touch = static_cast<uint32_t>(g.x | g.y);
      else if (act == kDecide)
        touch = static_cast<uint32_t>(g.z) |
                (var >> 5 == w ? 1u << (var & 31) : 0u);
      if (!(touch & bit)) continue;
      const int a = sA[v];
      int na = a, nl = -1;
      if (act == kBacktrack) {
        if (v == bvar) {
          na = phase;
          nl = Lm;
        } else {  // a vote of the unassign word
          na = 0;
        }
      } else if (act == kForce) {
        if (v >= 2 && a == 0) {
          na = (g.x & bit) ? 1 : -1;
          nl = dep;
        }
      } else if (v >= 2) {  // a decision: the var, or a don't-care
        if (v == var) {
          na = phase;
          nl = depth;
        } else if (a == 0) {
          na = 1;
          nl = depth;
        }
      }
      if (na != a) sA[v] = static_cast<int8_t>(na);
      if (nl >= 0 && v >= v0 && v < v0 + nown) sLvl[v - v0] = nl;
    }
    clear = act == kBacktrack ? Lm : kSaturated;
    __syncthreads();  // the replica is applied, every warp has its action

    // 5. the stack
    if (act == kBacktrack) {
      for (int d = tid; d < D; d += kThreads) {
        if (d >= Lm) {
          sDvar[d] = 0;
          sDphase[d] = 0;
          sDflip[d] = 0;
        } else if (d == Lm - 1) {
          sDphase[d] = static_cast<int8_t>(phase);
          sDflip[d] = 1;
        }
      }
    } else if (act == kDecide && tid == 0) {
      sDvar[dep] = var;
      sDphase[dep] = static_cast<int8_t>(phase);
      sDflip[dep] = 0;
    }
  }

  for (int i = tid; i < nown; i += kThreads) {
    assign[row + v0 + i] = sA[v0 + i];
    lvl[row + v0 + i] = sLvl[i];
  }
  if (rank == 0) {
    for (int d = tid; d < D; d += kThreads) {
      dvar[drow + d] = sDvar[d];
      dphase[drow + d] = sDphase[d];
      dflip[drow + d] = sDflip[d];
    }
    if (tid == 0) {
      depth_g[lane] = depth;
      status_g[lane] = status;
      step_g[lane] = step;
    }
  }
}

}  // namespace

extern "C" {

int round_lane_width() { return kWidth; }

int round_lane_threads() { return kThreads; }

// Blocks a lane (0: no block of any cluster size fits).
int round_lane_cluster(int B, int C, int V1, int D) {
  return cluster_size(B, C, V1, D);
}

// Dynamic shared memory of one block at cluster size S.
int round_lane_smem_bytes(int C, int V1, int D, int S) {
  return layout(C, V1, D, S).bytes;
}

// 1 if a block at cluster size S keeps its pool rows in shared memory.
int round_lane_resident(int C, int V1, int D, int S) {
  return layout(C, V1, D, S).resident;
}

// One round over B lanes, in place on the state; lits [C, 8] int32,
// 16-byte aligned, every |literal| < V1.  Returns the CUDA error code of
// the launch (0 = launched).
int round_lane_launch(const void* lits, int C, void* assign, void* lvl,
                      void* dvar, void* dphase, void* dflip, void* depth,
                      void* status, void* step, const void* pref, int B,
                      int V1, int D, int budget, void* stream) {
  const int S = cluster_size(B, C, V1, D);
  if (B < 1 || C < 1 || V1 < 2 || D < 1 || !S ||
      (reinterpret_cast<uintptr_t>(lits) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  // the attribute once, at the most any launch takes (thread-safe)
  static const cudaError_t configured = cudaFuncSetAttribute(
      round_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * S);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = layout(C, V1, D, S).bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, round_lane_kernel, static_cast<const int4*>(lits), C,
      static_cast<int8_t*>(assign), static_cast<int32_t*>(lvl),
      static_cast<int32_t*>(dvar), static_cast<int8_t*>(dphase),
      static_cast<uint8_t*>(dflip), static_cast<int32_t*>(depth),
      static_cast<int32_t*>(status), static_cast<int32_t*>(step),
      static_cast<const int8_t*>(pref), V1, D, budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
