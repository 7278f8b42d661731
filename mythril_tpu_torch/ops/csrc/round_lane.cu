// Per-lane chronological DPLL over the full clause pool, for sm_90a: the
// gather tiers' round lane and the async prefetch's one-shot solve.
//
// Replaces the XLA while_loop of mythril_tpu/ops/batched_sat.py:468-638
// (build_round_lane -> round_lane, vmapped by make_round_step and, through
// build_solve_lane, by make_solve_step at :641-720).  Same function, one
// lane per block, the whole loop inside one launch:
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
// [V1] (read only).  Every field is integer logic, so the result equals
// the plain PyTorch version (ops/round_lane.py:round_lane_plain) and the
// JAX loop bit for bit.
//
// Design.  The loop's state is small and every step reads all of it, so a
// block keeps its lane's assignment, levels, phase preference, unit votes
// (two bitmaps), DLIS scores and decision stack in dynamic shared memory
// (about 116 KB at V1 = 8193, the largest pool the tiers take) and runs
// the lane's whole while_loop without leaving the block: one launch a
// round, not one a step.  A step is five barriers: zero the votes and
// scores; stride the clause rows (two 16-byte loads a row, the pool
// shared by every lane stays in L2) with shared-memory atomics; one pass
// over V1 for the conflict / forcing / open flags and the argmax key
// ((score + 1) << 32 | ~v, so the first index wins a tie), reduced by
// warp shuffles and one shared atomic each; thread 0 picks the action and
// finds Lm (a walk down the stack from depth); one pass over V1 applies
// it.
//
// Bound: every step scans C x 8 literal cells and V1 vars, which the
// data needs (the algorithm rescans the pool each step); bytes are the
// pool once and the state in and out.  A launch is operation-bound at the
// main path's shapes.  The block per lane leaves SMs idle below 132
// lanes, and the scan redoes rows that did not change: both are left to
// a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 8;       // literals a clause row (MAX_CLAUSE_WIDTH)
constexpr int kThreads = 1024;  // threads a block (one block a lane)
constexpr int kWarps = kThreads / 32;

enum Action : int { kNone = 0, kBacktrack = 1, kForce = 2, kDecide = 3 };

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

struct Layout {
  int spos, sneg, lvl, fpos, fneg, assign, pref, dvar, dphase, dflip, bytes;
};

__host__ __device__ inline Layout layout(int V1, int D) {
  const int vp = pad16(V1);
  const int words = pad16((V1 + 31) / 32);
  const int dp = pad16(D);
  Layout L;
  L.spos = 0;
  L.sneg = L.spos + 4 * vp;
  L.lvl = L.sneg + 4 * vp;
  L.fpos = L.lvl + 4 * vp;
  L.fneg = L.fpos + 4 * words;
  L.dvar = L.fneg + 4 * words;
  L.assign = L.dvar + 4 * dp;
  L.pref = L.assign + vp;
  L.dphase = L.pref + vp;
  L.dflip = L.dphase + dp;
  L.bytes = L.dflip + dp;
  return L;
}

__global__ void __launch_bounds__(kThreads)
round_lane_kernel(const int4* __restrict__ lits, int C,
                  int8_t* __restrict__ assign, int32_t* __restrict__ lvl,
                  int32_t* __restrict__ dvar, int8_t* __restrict__ dphase,
                  uint8_t* __restrict__ dflip, int32_t* __restrict__ depth,
                  int32_t* __restrict__ status, int32_t* __restrict__ step,
                  const int8_t* __restrict__ pref, int V1, int D,
                  int budget) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(V1, D);
  int32_t* sPos = reinterpret_cast<int32_t*>(smem + L.spos);
  int32_t* sNeg = reinterpret_cast<int32_t*>(smem + L.sneg);
  int32_t* sLvl = reinterpret_cast<int32_t*>(smem + L.lvl);
  uint32_t* sFpos = reinterpret_cast<uint32_t*>(smem + L.fpos);
  uint32_t* sFneg = reinterpret_cast<uint32_t*>(smem + L.fneg);
  int32_t* sDvar = reinterpret_cast<int32_t*>(smem + L.dvar);
  int8_t* sA = reinterpret_cast<int8_t*>(smem + L.assign);
  int8_t* sPref = reinterpret_cast<int8_t*>(smem + L.pref);
  int8_t* sDphase = reinterpret_cast<int8_t*>(smem + L.dphase);
  uint8_t* sDflip = smem + L.dflip;

  __shared__ int s_depth, s_status, s_step, s_flags;
  __shared__ unsigned long long s_best;
  __shared__ int s_act, s_Lm, s_bvar, s_phase, s_var;

  const int tid = threadIdx.x;
  const int lane = blockIdx.x;
  const int words = (V1 + 31) / 32;
  const size_t row = static_cast<size_t>(lane) * V1;
  const size_t drow = static_cast<size_t>(lane) * D;

  for (int v = tid; v < V1; v += kThreads) {
    sA[v] = assign[row + v];
    sLvl[v] = lvl[row + v];
    sPref[v] = pref[row + v];
  }
  for (int d = tid; d < D; d += kThreads) {
    sDvar[d] = dvar[drow + d];
    sDphase[d] = dphase[drow + d];
    sDflip[d] = dflip[drow + d] ? 1 : 0;
  }
  if (tid == 0) {
    s_depth = depth[lane];
    s_status = status[lane];
    s_step = step[lane];
  }
  __syncthreads();

  while (s_status == 0 && s_step < budget) {
    // 1. zero the votes and scores
    for (int v = tid; v < V1; v += kThreads) {
      sPos[v] = 0;
      sNeg[v] = 0;
    }
    for (int w = tid; w < words; w += kThreads) {
      sFpos[w] = 0u;
      sFneg[w] = 0u;
    }
    if (tid == 0) {
      s_flags = 0;
      s_best = 0ull;
    }
    __syncthreads();

    // 2. the clause scan
    int conflict = 0;
    for (int c = tid; c < C; c += kThreads) {
      const int4 a = lits[2 * c];
      const int4 b = lits[2 * c + 1];
      const int l[kWidth] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      bool real = false, sat = false;
      int unknown = 0, unknown_sum = 0;
#pragma unroll
      for (int k = 0; k < kWidth; ++k) {
        const int x = l[k];
        if (x == 0) continue;
        real = true;
        const int av = sA[x > 0 ? x : -x];
        const int val = x > 0 ? av : -av;
        if (val > 0) {
          sat = true;
        } else if (val == 0) {
          ++unknown;
          unknown_sum += x;
        }
      }
      if (!real || sat) continue;
      if (unknown == 0) {
        conflict = 1;
      } else if (unknown == 1) {
        const int v = unknown_sum > 0 ? unknown_sum : -unknown_sum;
        atomicOr(unknown_sum > 0 ? &sFpos[v >> 5] : &sFneg[v >> 5],
                 1u << (v & 31));
      } else {
#pragma unroll
        for (int k = 0; k < kWidth; ++k) {
          const int x = l[k];
          if (x == 0) continue;
          const int v = x > 0 ? x : -x;
          if (sA[v] == 0) atomicAdd(x > 0 ? &sPos[v] : &sNeg[v], 1);
        }
      }
    }
    const int scan_conflict = __syncthreads_or(conflict);

    // 3. flags and the argmax key over the free vars
    int flags = 0;  // 1 = a var voted both ways, 2 = a vote, 4 = open
    unsigned long long best = 0ull;
    for (int v = 2 + tid; v < V1; v += kThreads) {
      if (sA[v] != 0) continue;
      const uint32_t bit = 1u << (v & 31);
      const bool fp = sFpos[v >> 5] & bit;
      const bool fn = sFneg[v >> 5] & bit;
      flags |= 4 | (fp || fn ? 2 : 0) | (fp && fn ? 1 : 0);
      const unsigned long long key =
          (static_cast<unsigned long long>(sPos[v] + sNeg[v] + 1) << 32) |
          static_cast<uint32_t>(~static_cast<uint32_t>(v));
      best = key > best ? key : best;
    }
    flags = __reduce_or_sync(0xffffffffu, flags);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o > best ? o : best;
    }
    if ((tid & 31) == 0) {
      if (flags) atomicOr(&s_flags, flags);
      if (best) atomicMax(&s_best, best);
    }
    __syncthreads();

    // 4. the lane's action
    if (tid == 0) {
      const int dep = s_depth;
      const int f = s_flags;
      int act = kNone;
      if (scan_conflict || (f & 1)) {
        int Lm = 0;
        for (int d = dep - 1; d >= 0; --d) {
          if (!sDflip[d]) {
            Lm = d + 1;
            break;
          }
        }
        if (Lm == 0) {
          s_status = 2;
        } else {
          act = kBacktrack;
          s_Lm = Lm;
          s_bvar = sDvar[Lm - 1];
          s_phase = -sDphase[Lm - 1];
          s_depth = Lm;
        }
      } else if (f & 2) {
        act = kForce;
      } else if (f & 4) {
        if (dep < D) {
          act = kDecide;
          const int var = static_cast<int>(
              ~static_cast<uint32_t>(s_best & 0xffffffffull));
          const int p = sPref[var];
          s_var = var;
          s_phase = p != 0 ? p : (sPos[var] >= sNeg[var] ? 1 : -1);
          s_depth = dep + 1;
        } else {
          s_status = 3;
        }
      } else {
        s_status = 1;
      }
      s_act = act;
      s_step = s_step + 1;
    }
    __syncthreads();

    // 5. apply it
    const int act = s_act;
    if (act == kBacktrack) {
      const int Lm = s_Lm, bvar = s_bvar;
      const int8_t bphase = static_cast<int8_t>(s_phase);
      for (int v = tid; v < V1; v += kThreads) {
        if (v == bvar) {
          sA[v] = bphase;
          sLvl[v] = Lm;
        } else if (sA[v] != 0 && sLvl[v] >= Lm) {
          sA[v] = 0;
        }
      }
      for (int d = tid; d < D; d += kThreads) {
        if (d >= Lm) {
          sDvar[d] = 0;
          sDphase[d] = 0;
          sDflip[d] = 0;
        } else if (d == Lm - 1) {
          sDphase[d] = bphase;
          sDflip[d] = 1;
        }
      }
    } else if (act == kForce) {
      const int dep = s_depth;
      for (int v = 2 + tid; v < V1; v += kThreads) {
        if (sA[v] != 0) continue;
        const uint32_t bit = 1u << (v & 31);
        if (sFpos[v >> 5] & bit) {
          sA[v] = 1;
          sLvl[v] = dep;
        } else if (sFneg[v >> 5] & bit) {
          sA[v] = -1;
          sLvl[v] = dep;
        }
      }
    } else if (act == kDecide) {
      const int var = s_var, level = s_depth;
      for (int v = 2 + tid; v < V1; v += kThreads) {
        if (v == var) {
          sA[v] = static_cast<int8_t>(s_phase);
          sLvl[v] = level;
        } else if (sA[v] == 0 && sPos[v] + sNeg[v] == 0) {
          sA[v] = 1;
          sLvl[v] = level;
        }
      }
      if (tid == 0) {
        sDvar[level - 1] = var;
        sDphase[level - 1] = static_cast<int8_t>(s_phase);
        sDflip[level - 1] = 0;
      }
    }
    __syncthreads();
  }

  for (int v = tid; v < V1; v += kThreads) {
    assign[row + v] = sA[v];
    lvl[row + v] = sLvl[v];
  }
  for (int d = tid; d < D; d += kThreads) {
    dvar[drow + d] = sDvar[d];
    dphase[drow + d] = sDphase[d];
    dflip[drow + d] = sDflip[d];
  }
  if (tid == 0) {
    depth[lane] = s_depth;
    status[lane] = s_status;
    step[lane] = s_step;
  }
}

}  // namespace

extern "C" {

int round_lane_width() { return kWidth; }

int round_lane_threads() { return kThreads; }

int round_lane_smem_bytes(int V1, int D) { return layout(V1, D).bytes; }

// One round over B lanes, in place on the state; lits [C, 8] int32,
// 16-byte aligned, every |literal| < V1.  Returns the CUDA error code of
// the launch (0 = launched).
int round_lane_launch(const void* lits, int C, void* assign, void* lvl,
                      void* dvar, void* dphase, void* dflip, void* depth,
                      void* status, void* step, const void* pref, int B,
                      int V1, int D, int budget, void* stream) {
  const int smem = layout(V1, D).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      round_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  round_lane_kernel<<<B, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(lits), C, static_cast<int8_t*>(assign),
      static_cast<int32_t*>(lvl), static_cast<int32_t*>(dvar),
      static_cast<int8_t*>(dphase), static_cast<uint8_t*>(dflip),
      static_cast<int32_t*>(depth), static_cast<int32_t*>(status),
      static_cast<int32_t*>(step), static_cast<const int8_t*>(pref), V1, D,
      budget);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
