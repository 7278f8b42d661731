// One iteration of the frontier solvers as three kernels, for sm_90a.
//
// Replaces the loop bodies of the JAX package's frontier round
// (mythril_tpu/ops/frontier.py:453-596) and resident solver
// (mythril_tpu/ops/resident.py:385-549), which XLA runs as
// lax.while_loops.  Here one loop iteration is three launches, with no
// host sync between iterations:
//
//   scan_rows_kernel       the BCP row scan (make_scan_rows,
//                          frontier.py:257-329) over the iteration's view:
//                          all C pool rows, or the adjacency rows of the
//                          `fan` largest queued vars, popped from the
//                          lane's queue; in resident mode also the shared
//                          learned rows (ids C + e).
//   lane_step_kernel       per lane: first-UIP learning and chronological
//                          backtrack, forcing, DLIS decision, SAT
//                          completion, bail, counters.
//   round_epilogue_kernel  the append of the iteration's learned rows to
//                          the shared pool (resident.py:355-380), each
//                          pending lane's don't-care cascade, which must
//                          see the pool after the append
//                          (resident.py:495-505), and the next iteration's
//                          batch-wide flags.
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
// memory atomics on integers (also across a cluster, through distributed
// shared memory), whose result does not depend on the order.  Ties follow
// jnp.argmax (first index): the keys pack (value, -index).
//
// scan_rows.  Bound by bytes: it writes six [B, V1] int32 planes and
// reads the lanes' assignments (12.6 MB at B = 64, V1 = 8193: 3.8 us at
// the HBM rate); a full view also streams the C x K pool once per lane
// through L2.  One block per lane could not get near that: at B = 64 half
// the SMs idled, each block waited on two L2 loads per pool row, every
// open row cost a shared atomic per unknown literal, and past V1 of about
// 14,000 the planes left shared memory for global atomics.  Now each lane
// runs on a thread-block cluster of S blocks (a power of two up to 8: the
// smallest whose block fits and whose B x S blocks fill the card).  Block
// r owns the vars [r Ws, (r + 1) Ws) of the four accumulation planes in
// its shared memory and takes the other blocks' votes for them through
// distributed shared memory, so the cone tier's V1 = 16385 fits at S = 2;
// it keeps a full copy of the lane's assignment, scans every S-th tile of
// pool rows, streamed into shared memory by cp.async.bulk on mbarriers,
// two tiles in flight, and writes its slice of the six planes with
// 16-byte stores.  A full view counts the scores the other way round: an
// unknown var's score is its occurrences in the pool (counted once a solve)
// less those in satisfied and unit rows, so only those rows take atomics.
// Summed over the main path's own full views, that measured faster than
// counting the open rows, also on views where most vars are assigned
// (PERF.md, the scan's score ways).
//
// lane_step.  Bound by bytes: it reads each lane's assignment and queue,
// the votes and scores of its open vars (on a full view it copies the
// scores of every var), and writes what changes.  One 512-thread block a
// lane walked V1 with scalar loads three times, and its first-UIP walk
// ran on one warp that re-read the trail from global memory at every
// resolution step (PERF.md, the lane step's breakdown).  Now each lane
// runs on a cluster of S blocks (the smallest power of two whose B x S
// blocks fill the card, up to 8); block r makes one pass over a 1/S slice
// of the lane with 16-byte loads of the int32 planes, forces in place and
// leaves its flags and DLIS key in block 0's shared memory, which decides
// after one cluster barrier.  The walk runs on block 0's first warp while
// its other warps make the pass: each listed var's trail entry is read
// once into shared memory, so a resolution step is a warp max there.
//
// round_epilogue.  Bound by the pending lanes' cascades (assign, spos and
// sneg read, the settled vars written); the append is a few KB.  Each
// block that needs the append stages the learned rows and the live pool in
// shared memory, compares every pair on all 512 threads, and hands out the
// slots by a block-wide exclusive scan, in lane order as the JAX cumsum.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace cg = cooperative_groups;

// Field order must match ops/frontier_kernels.py (_PTR_FIELDS, _INT_FIELDS).
struct FrontierArgs {
  const int32_t* lits;
  const int32_t* adj;
  const int32_t* occ;  // [2][V1]: each var's positive, negative occurrences
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
      uip_iters, resident, parity;
};

namespace {

constexpr int kK = 8;             // clause row width (MAX_CLAUSE_WIDTH)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxLaneCluster = kMaxCluster;
constexpr int kClusterBlocks = 128;  // a block on about every one of 132 SMs
constexpr int kTileRows = kThreads;  // pool rows of a streamed tile
constexpr int kStages = 2;           // tiles in flight
// dynamic shared memory a block may take on sm_90 (227 KB), less 1 KB for
// the kernels' static shared variables (ops/frontier_kernels.py mirrors it)
constexpr int kMaxDynamicSmem = 232448 - 1024;
enum { kIt = 0, kHalt = 1, kFull = 2, kStall = 3, kNextra = 4, kNctl = 8 };
enum { kProgress = 1, kQueued = 2, kCascade = 4 };

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

// Vars of one cluster block's slice of the scan's planes (a multiple of 4).
__host__ __device__ inline int slice_width(int V1, int S) {
  return ((V1 + S - 1) / S + 3) & ~3;
}

enum { kScan = 0, kLane = 1, kEpilogue = 2 };

// Dynamic shared memory of one scan block at cluster size S: its slice of
// the four int32 planes, the pool tiles, the lane's assignment and queue
// (each with 16 bytes of room, to sit at its global address mod 16), the
// popped vars.
int scan_smem(const FrontierArgs& a, int S) {
  return 16 * slice_width(a.V1, S) + kStages * kTileRows * kK * 4 +
         2 * (align16(a.V1) + 16) + align16(4 * a.fan);
}

// The scan's cluster size: the smallest power of two whose block fits and
// whose B x S blocks fill the card (8 when none does); 0 when none fits.
int scan_cluster(const FrontierArgs& a) {
  for (int S = 1; S <= kMaxCluster; S *= 2)
    if (scan_smem(a, S) <= kMaxDynamicSmem &&
        (a.B * S >= kClusterBlocks || S == kMaxCluster))
      return S;
  return 0;
}

// The lane step's cluster size: the smallest power of two whose B x S
// blocks fill the card, up to the portable 8.
int lane_cluster(const FrontierArgs& a) {
  int S = 1;
  while (S < kMaxLaneCluster && a.B * S < kClusterBlocks) S *= 2;
  return S;
}

// Dynamic shared memory of each kernel: scan as above; lane step = the
// first-UIP walk's list (a key, var, reason, sign and at-depth flag for
// each of up to kK (uip_iters + 1) vars: each resolution adds at most kK)
// and two bitmaps over V1; epilogue = the pool's var marks and, in
// resident mode, the staged pool and learned rows (E + B rows), the
// learning lanes, their duplicate marks and each lane's slot.
int smem_bytes(const FrontierArgs& a, int kernel) {
  if (kernel == kScan) {
    const int S = scan_cluster(a);
    return scan_smem(a, S ? S : kMaxCluster);
  }
  if (kernel == kLane) {
    const int cap = kK * (a.uip_iters + 1);
    return 16 * cap + align16(2 * cap) +
           2 * align16(4 * ((a.V1 + 31) / 32));
  }
  return align16(a.V1) + (a.resident ? 4 * kK * (a.E + a.B) + 12 * a.B : 0);
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

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
  for (int o = 16; o; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ int warp_inclusive_sum(int x) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix sum of x over the block's threads in thread order (warp
// scans, then a scan over the kWarps warp totals); *total gets the sum.
// Every thread of the block calls it; red holds kWarps + 1 ints.
__device__ __forceinline__ int block_exclusive_sum(int x, int* red,
                                                   int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_sum(x);
  __syncthreads();  // red may still be read from the last call
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? red[lane] : 0;
    const int wi = warp_inclusive_sum(w);
    if (lane < kWarps) red[lane] = wi - w;
    if (lane == kWarps - 1) red[kWarps] = wi;
  }
  __syncthreads();
  *total = red[kWarps];
  return red[warp] + incl - x;
}

// (value, -index) packed so that the maximum is the first maximal index.
__device__ __forceinline__ unsigned long long arg_key(int value_plus1, int v) {
  return ((unsigned long long)(unsigned)value_plus1 << 32) |
         (unsigned)(0x7fffffff - v);
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return 0x7fffffff - (int)(key & 0xffffffffu);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies n bytes from global into shared memory that sits at the same
// address mod 16: a scalar head and tail around 16-byte copies.
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           int n) {
  const int head = min(n, (int)((16 - ((uintptr_t)src & 15)) & 15));
  const int body = (n - head) >> 4;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += kThreads) d4[i] = s4[i];
  for (int i = threadIdx.x; i < n - 16 * body; i += kThreads) {
    const int j = i < head ? i : i + 16 * body;
    dst[j] = src[j];
  }
}

// Zeroes n bytes of global memory with 16-byte stores between a scalar
// head and tail.
__device__ __forceinline__ void zero_bytes(uint8_t* dst, int n) {
  const int head = min(n, (int)((16 - ((uintptr_t)dst & 15)) & 15));
  const int body = (n - head) >> 4;
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += kThreads)
    d4[i] = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < n - 16 * body; i += kThreads)
    dst[i < head ? i : i + 16 * body] = 0;
}

// One bulk copy (cp.async.bulk) of `bytes`, a multiple of 16, from global
// into this block's shared memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// This block's slice of the scan's planes rpos, rneg, spos, sneg
// ([4][Ws] int32 in its shared memory) and its rank in the cluster.
struct Planes {
  int* s;
  int Ws, rank;
};

// Var v's entry of plane p (0 rpos, 1 rneg: max; 2 spos, 3 sneg: add) in
// the cluster block that owns v.
__device__ __forceinline__ void vote(const Planes& pl, int p, int v,
                                     int value) {
  const int owner = v / pl.Ws;
  int* slot = pl.s + p * pl.Ws + (v - owner * pl.Ws);
  if (owner == pl.rank) {
    if (p < 2) atomicMax(slot, value);
    else atomicAdd(slot, value);
  } else {
    int* remote = cg::this_cluster().map_shared_rank(slot, owner);
    if (p < 2) atomicMax(remote, value);
    else atomicAdd(remote, value);
  }
}

// One clause row against the lane's assignment (make_scan_rows): unit rows
// vote their literal (max of row id + 1), an all-false row is a conflict
// (max into `conf`, block 0's).  With `scores` the score planes count the
// unknown literals of satisfied and unit rows, which the write-out takes
// from the pool's occurrence counts to leave those of the open rows.
__device__ __forceinline__ void eval_row(const int (&l)[kK], int id1,
                                         bool scores, int V1,
                                         const int8_t* sA, const Planes& pl,
                                         int* conf) {
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
  if (all_false) atomicMax(conf, id1);
  if (!sat && nunk == 1) vote(pl, unk > 0 ? 0 : 1, min(abs(unk), V1 - 1), id1);
  if (scores && (sat || nunk == 1)) {
#pragma unroll
    for (int k = 0; k < kK; ++k)
      if (l[k] != 0 && val[k] == 0)
        vote(pl, l[k] > 0 ? 2 : 3, min(abs(l[k]), V1 - 1), 1);
  }
}

// Pops the `fan` largest queued vars of the lane (lax.top_k over the queued
// ids, frontier.py:270).  The queue's bytes sit in `room` at offset
// `shift`; each thread counts the queued vars of its run of 16-byte
// chunks, from the top chunk down, and an exclusive scan of the counts
// ranks them from the largest id down.  Clears the popped vars in
// `recent`; returns how many it popped.  Every thread of the block calls
// it.
__device__ int pop_queue(const uint8_t* room, int shift, uint8_t* recent,
                         int V1, int fan, int* picked, int* red) {
  const int nchunks = (shift + V1 + 15) >> 4;
  const int per = (nchunks + kThreads - 1) / kThreads;
  const int top = nchunks - 1 - (int)threadIdx.x * per;
  const int bottom = max(top - per + 1, 0);
  // bit j: byte 16 c + j holds a queued var (ids 1 .. V1 - 1)
  auto queued = [&](int c) {
    const int4 x = reinterpret_cast<const int4*>(room)[c];
    const unsigned w[4] = {__vcmpne4(x.x, 0u), __vcmpne4(x.y, 0u),
                           __vcmpne4(x.z, 0u), __vcmpne4(x.w, 0u)};
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      m |= (((w[q] >> 7) & 1u) | ((w[q] >> 14) & 2u) | ((w[q] >> 21) & 4u) |
            ((w[q] >> 28) & 8u)) << (4 * q);
    const int lo = max(0, shift + 1 - 16 * c), hi = min(16, shift + V1 - 16 * c);
    return hi > lo ? m & (((1u << hi) - 1u) & ~((1u << lo) - 1u)) : 0u;
  };
  int n = 0;
  for (int c = top; c >= bottom; --c) n += __popc(queued(c));
  int total;
  int rank = block_exclusive_sum(n, red, &total);
  for (int c = top; c >= bottom && rank < fan; --c) {
    for (unsigned m = queued(c); m && rank < fan;) {
      const int j = 31 - __clz(m);  // the largest id first
      m &= ~(1u << j);
      const int v = 16 * c + j - shift;
      picked[rank++] = v;
      recent[v] = 0;
    }
  }
  return min(total, fan);
}

__global__ void __launch_bounds__(kThreads) scan_rows_kernel(FrontierArgs a) {
  const int* ctl = a.ctl + a.parity * kNctl;
  if (ctl[kHalt]) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int V1 = a.V1, tid = threadIdx.x;
  const int b = blockIdx.x / S;
  const size_t off = (size_t)b * V1;
  const int Ws = slice_width(V1, S);
  const int v0 = rank * Ws, nown = max(0, min(Ws, V1 - v0));
  const bool full = ctl[kFull] != 0, lead = rank == 0;

  extern __shared__ int4 smem4[];
  int* s_planes = reinterpret_cast<int*>(smem4);
  int4* s_tiles = smem4 + Ws;  // after the 4 Ws plane ints
  uint8_t* a_room =
      reinterpret_cast<uint8_t*>(s_tiles + kStages * kTileRows * 2);
  uint8_t* r_room = a_room + align16(V1) + 16;
  int* s_picked = reinterpret_cast<int*>(r_room + align16(V1) + 16);
  const int8_t* gA = a.assign + off;
  uint8_t* recent = a.recent + off;
  int8_t* sA = reinterpret_cast<int8_t*>(a_room + ((uintptr_t)gA & 15));
  uint8_t* sR = r_room + ((uintptr_t)recent & 15);
  __shared__ int s_conf, s_npicked;
  __shared__ int red[kWarps + 1];
  __shared__ uint64_t s_bar[kStages];

  // this block's tiles of the pool on a full view: rank, rank + S, ...
  const int ntiles = (a.C + kTileRows - 1) / kTileRows;
  const int mytiles = full && rank < ntiles ? (ntiles - rank + S - 1) / S : 0;
  auto issue = [&](int k) {
    const int t = rank + k * S;
    const int rows = min(kTileRows, a.C - t * kTileRows);
    bulk_load(s_tiles + (k % kStages) * kTileRows * 2,
              a.lits + (size_t)t * kTileRows * kK, rows * kK * 4,
              &s_bar[k % kStages]);
  };
  if (tid == 0 && mytiles) {
    for (int k = 0; k < kStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&s_bar[k]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(kStages, mytiles); ++k) issue(k);
  }

  if (tid == 0) s_conf = 0;
  for (int i = tid; i < Ws; i += kThreads) smem4[i] = make_int4(0, 0, 0, 0);
  copy_bytes(reinterpret_cast<uint8_t*>(sA),
             reinterpret_cast<const uint8_t*>(gA), V1);
  if (full) {
    zero_bytes(recent + v0, nown);  // each block clears its slice
  } else if (lead) {
    copy_bytes(sR, recent, V1);
    __syncthreads();
    const int n = pop_queue(r_room, (int)((uintptr_t)recent & 15), recent,
                            V1, a.fan, s_picked, red);
    if (tid == 0) s_npicked = n;
  }
  cluster.sync();  // planes zeroed, barriers set up, queue popped

  const Planes pl{s_planes, Ws, rank};
  int* conf = cluster.map_shared_rank(&s_conf, 0);
  if (full) {
    for (int k = 0; k < mytiles; ++k) {
      const int stage = k % kStages;
      mbar_wait(&s_bar[stage], (k / kStages) & 1);
      for (int i = tid; i < kTileRows; i += kThreads) {
        const int r = (rank + k * S) * kTileRows + i;
        if (r >= a.C) break;
        int l[kK];
        load_row(reinterpret_cast<const int32_t*>(
                     s_tiles + (stage * kTileRows + i) * 2),
                 l);
        eval_row(l, r + 1, true, V1, sA, pl, conf);
      }
      __syncthreads();  // the stage is free for tile k + kStages
      if (tid == 0 && k + kStages < mytiles) issue(k + kStages);
    }
  } else {
    const int* picked = cluster.map_shared_rank(s_picked, 0);
    const int n = *cluster.map_shared_rank(&s_npicked, 0) * a.deg;
    for (int i = rank + S * tid; i < n; i += S * kThreads) {
      const int rid = a.adj[(size_t)picked[i / a.deg] * a.deg + (i % a.deg)];
      if (rid < 0) continue;
      int l[kK];
      load_row(a.lits + (size_t)rid * kK, l);
      eval_row(l, rid + 1, false, V1, sA, pl, conf);
    }
  }
  if (a.resident) {
    const int ne = ctl[kNextra];
    for (int e = rank + S * tid; e < ne; e += S * kThreads) {
      int l[kK];
      load_row(a.extra + (size_t)e * kK, l);
      eval_row(l, a.C + e + 1, false, V1, sA, pl, conf);
    }
  }
  cluster.sync();  // every vote has landed

  // this block's slice of the six planes: 16-byte stores where the lane's
  // row allows, scalars at the ends
  const int* rp = s_planes;
  const int* rn = rp + Ws;
  int* sp = s_planes + 2 * Ws;
  int* sn = sp + Ws;
  if (full) {  // an unknown var's score: its occurrences less the closed
    for (int i = tid; i < nown; i += kThreads) {
      const bool unknown = sA[v0 + i] == 0;
      sp[i] = unknown ? a.occ[v0 + i] - sp[i] : 0;
      sn[i] = unknown ? a.occ[V1 + v0 + i] - sn[i] : 0;
    }
    __syncthreads();
  }
  const size_t g0 = off + v0;
  const int head = min(nown, (int)((4 - (g0 & 3)) & 3));
  const int quads = (nown - head) >> 2;
  for (int q = tid; q < quads; q += kThreads) {
    const int i = head + 4 * q;
    const int4 p = make_int4(rp[i], rp[i + 1], rp[i + 2], rp[i + 3]);
    const int4 n = make_int4(rn[i], rn[i + 1], rn[i + 2], rn[i + 3]);
    const size_t g = g0 + i;
    *reinterpret_cast<int4*>(a.fpos + g) =
        make_int4(p.x > 0, p.y > 0, p.z > 0, p.w > 0);
    *reinterpret_cast<int4*>(a.fneg + g) =
        make_int4(n.x > 0, n.y > 0, n.z > 0, n.w > 0);
    *reinterpret_cast<int4*>(a.rpos + g) = p;
    *reinterpret_cast<int4*>(a.rneg + g) = n;
    *reinterpret_cast<int4*>(a.spos + g) =
        make_int4(sp[i], sp[i + 1], sp[i + 2], sp[i + 3]);
    *reinterpret_cast<int4*>(a.sneg + g) =
        make_int4(sn[i], sn[i + 1], sn[i + 2], sn[i + 3]);
  }
  for (int j = tid; j < nown - 4 * quads; j += kThreads) {
    const int i = j < head ? j : j + 4 * quads;
    const size_t g = g0 + i;
    a.fpos[g] = rp[i] > 0;
    a.fneg[g] = rn[i] > 0;
    a.rpos[g] = rp[i];
    a.rneg[g] = rn[i];
    a.spos[g] = sp[i];
    a.sneg[g] = sn[i];
  }
  if (lead && tid == 0) {
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

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The two halves of a cluster barrier.  Every thread of every block of
// the cluster arrives once and waits once per phase, from code that is
// uniform across the cluster; the arrive releases what the thread wrote
// (and read) before it, the wait acquires what the others did.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The first-UIP walk's list in shared memory: for each var that entered
// it, its id, the reason row, its sign and whether it sits at the lane's
// depth, and its pivot key: (tpos + 1, v) packed as arg_key for a var
// assigned at the depth, 0 for any other (never a pivot).  Two bitmaps
// over the lane's vars say which are listed and which are marked.  A
// var's trail entries do not change during the walk, so a resolution
// step reads only shared memory.
struct Walk {
  unsigned long long* key;
  int* var;
  int* reason;
  int8_t* sign;
  uint8_t* at_depth;
  unsigned* listed;
  unsigned* marked;
  int words16;  // int4 words of the two bitmaps together
};

__device__ __forceinline__ Walk walk_layout(const FrontierArgs& a,
                                            int4* smem) {
  const int cap = kK * (a.uip_iters + 1);
  const int bitmap = align16(4 * ((a.V1 + 31) / 32));
  uint8_t* p = reinterpret_cast<uint8_t*>(smem);
  Walk w;
  w.key = reinterpret_cast<unsigned long long*>(p);
  w.var = reinterpret_cast<int*>(p + 8 * cap);
  w.reason = w.var + cap;
  w.sign = reinterpret_cast<int8_t*>(p + 16 * cap);
  w.at_depth = p + 17 * cap;
  w.listed = reinterpret_cast<unsigned*>(p + 16 * cap + align16(2 * cap));
  w.marked = w.listed + bitmap / 4;
  w.words16 = 2 * bitmap / 16;
  return w;
}

// Marks the vars of clause row `row`, one literal a lane, and lists the
// vars not listed yet (the shared-memory atomics on `listed` pick one lane
// for a var that occurs twice), with their trail entries.  Returns the
// new list length.  Called by the whole warp.
__device__ __forceinline__ int walk_mark(const FrontierArgs& a,
                                         const Walk& w, const int32_t* row,
                                         int n, size_t off, int depth) {
  const int lane = threadIdx.x & 31;
  int v = 0;
  bool fresh = false;
  if (lane < kK) {
    const int l = row[lane];
    if (l != 0) {
      v = min(abs(l), a.V1 - 1);
      const unsigned bit = 1u << (v & 31);
      atomicOr(&w.marked[v >> 5], bit);
      fresh = !(atomicOr(&w.listed[v >> 5], bit) & bit);
    }
  }
  const unsigned m = __ballot_sync(0xffffffffu, fresh);
  if (fresh) {
    const int i = n + __popc(m & ((1u << lane) - 1u));
    const int s = a.assign[off + v];
    const int lv = a.lvl[off + v];
    const int tp = a.tpos[off + v];
    w.reason[i] = a.reason[off + v];
    w.var[i] = v;
    w.sign[i] = (int8_t)s;
    w.at_depth[i] = lv == depth;
    w.key[i] = lv == depth && s != 0 ? arg_key(tp + 1, v) : 0ull;
  }
  __syncwarp();
  return n + __popc(m);
}

__device__ __forceinline__ bool is_marked(const Walk& w, int v) {
  return (w.marked[v >> 5] >> (v & 31)) & 1u;
}

// First-UIP walk of the lane at row offset `off` (the frontier kernel's
// maybe_learn), run by one warp.  Each resolution step takes the marked
// var at the depth with the latest trail position (a warp max over the
// list) and marks its reason row.  The clause, at most kK vars by
// descending id, is picked by a ballot over the list and ranked by its
// kK lanes.  Returns the emit flag (to every lane); the canonical clause
// row goes to `row` (zeros when not emitted).
__device__ int uip_walk(const FrontierArgs& a, const Walk& w, size_t off,
                        int depth, int crow, int nlearn, int* row, int* sel,
                        int8_t* sel_sign) {
  const int lane = threadIdx.x & 31;
  const unsigned all = 0xffffffffu;
  int4* z = reinterpret_cast<int4*>(w.listed);
  for (int i = lane; i < w.words16; i += 32) z[i] = make_int4(0, 0, 0, 0);
  __syncwarp();
  int n = walk_mark(a, w, fetch_row(a, crow), 0, off, depth);
  bool ok = true;
  for (int it = 0; it < a.uip_iters; ++it) {
    int cnt = 0, at = -1;
    unsigned long long best = 0;
    for (int i = lane; i < n; i += 32) {
      const unsigned long long key = w.key[i];
      if (key && is_marked(w, w.var[i])) {
        ++cnt;
        if (key > best) {
          best = key;
          at = i;
        }
      }
    }
    cnt = warp_sum(cnt);
    const unsigned long long top = warp_max_u64(best);
    if (cnt <= 1) break;  // no resolution left: later steps change nothing
    const int src = __ffs(__ballot_sync(all, best == top)) - 1;
    const int pi = __shfl_sync(all, at, src);
    const int piv = w.var[pi], r = w.reason[pi];
    if (r < 0) {  // a decision or assumption as pivot: drop the clause
      ok = false;
      break;
    }
    n = walk_mark(a, w, fetch_row(a, r), n, off, depth);
    if (lane == 0) atomicAnd(&w.marked[piv >> 5], ~(1u << (piv & 31)));
    __syncwarp();
  }
  int total = 0, at_depth = 0;
  for (int i = lane; i < n; i += 32) {
    if (is_marked(w, w.var[i])) {
      ++total;
      at_depth += w.at_depth[i];
    }
  }
  total = warp_sum(total);
  at_depth = warp_sum(at_depth);
  ok = ok && at_depth <= 1 && total >= 1 && total <= kK &&
       nlearn < a.learn_cap;
  if (ok) {
    for (int base = 0, i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool m = i < n && is_marked(w, w.var[i]);
      const unsigned bits = __ballot_sync(all, m);
      if (m) {
        const int j = base + __popc(bits & ((1u << lane) - 1u));
        sel[j] = w.var[i];
        sel_sign[j] = w.sign[i];
      }
      base += __popc(bits);
    }
    __syncwarp();
    if (lane < total) {  // descending ids (lax.top_k order)
      const int v = sel[lane];
      int rank = 0;
      for (int j = 0; j < total; ++j) rank += sel[j] > v;
      row[rank] = -(int)sel_sign[lane] * v;
    }
  }
  if (lane < kK && lane >= (ok ? total : 0)) row[lane] = 0;
  __syncwarp();
  return ok;
}

// One lane's planes, and the lane step's constants of this launch.
struct Lane {
  int8_t* A;
  int32_t* lvl;
  int32_t* reason;
  int32_t* tpos;
  uint8_t* recent;
  int32_t* cspos;
  int32_t* csneg;
  const int32_t* fpos;
  const int32_t* fneg;
  const int32_t* rpos;
  const int32_t* rneg;
  const int32_t* spos;
  const int32_t* sneg;
  const int8_t* pref;
  int depth, nstamp;
  bool full, quiet;  // quiet: active and no conflict
};

// Bits of a block's partial flags, and the DLIS key: (score + 1, v)
// ordered as arg_key, with the var's phase in the lowest bit.
enum { kForcedVar = 1, kFreeVar = 2, kQueuedVar = 4 };

__device__ __forceinline__ unsigned long long dlis_key(int value, int v,
                                                       int phase) {
  return ((unsigned long long)(unsigned)value << 32) |
         ((unsigned)(0x7fffffff - v) << 1) | (unsigned)(phase > 0);
}
__device__ __forceinline__ int dlis_var(unsigned long long key) {
  return 0x7fffffff - (int)((key & 0xffffffffu) >> 1);
}

// N = 4 consecutive vars on the 16-byte grid of the int32 planes (one
// int4 a plane, four bytes of A, recent and pref), or N = 1.
template <int N>
__device__ __forceinline__ void load_ints(const int32_t* p, int (&x)[N]) {
  if constexpr (N == 4) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void store_ints(int32_t* p, const int (&x)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<int4*>(p) = make_int4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}
template <int N, typename T>
__device__ __forceinline__ void load_bytes(const T* p, int (&x)[N]) {
  if constexpr (N == 4) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = (T)(w >> (8 * k));
  } else {
    x[0] = *p;
  }
}
template <int N, typename T>
__device__ __forceinline__ void store_bytes(T* p, const int (&x)[N]) {
  if constexpr (N == 4) {
    unsigned w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) w |= (unsigned)(x[k] & 0xff) << (8 * k);
    *reinterpret_cast<unsigned*>(p) = w;
  } else {
    *p = (T)x[0];
  }
}

// The pass over vars v .. v + N - 1: the queue flag; on a full view the
// cached scores (cspos = spos); in a quiet lane the forcing and open
// flags, the DLIS key of each open var that is not forced, and every
// forced literal assigned with its reason row (the positive phase wins
// a contradictory pair): when a var is forced, the lane forces.
template <int N>
__device__ __forceinline__ void lane_pass(const Lane& L, int v, int& flags,
                                          unsigned long long& key) {
  int a[N], r[N], sp[N], sn[N];
  load_bytes<N>(L.A + v, a);
  load_bytes<N>(L.recent + v, r);
  bool any_free = false;
  bool fr[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (r[k]) flags |= kQueuedVar;
    fr[k] = L.quiet && a[k] == 0 && v + k > 1;  // col 1 = the TRUE anchor
    any_free |= fr[k];
  }
  if (L.full) {
    load_ints<N>(L.spos + v, sp);
    load_ints<N>(L.sneg + v, sn);
    store_ints<N>(L.cspos + v, sp);
    store_ints<N>(L.csneg + v, sn);
  }
  if (!any_free) return;
  int fp[N], fn[N], pf[N];
  load_ints<N>(L.fpos + v, fp);
  load_ints<N>(L.fneg + v, fn);
  load_bytes<N>(L.pref + v, pf);
  if (!L.full) {
    load_ints<N>(L.cspos + v, sp);
    load_ints<N>(L.csneg + v, sn);
  }
  bool any_forced = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (!fr[k]) continue;
    flags |= kFreeVar;
    if (fp[k] > 0 || fn[k] > 0) {
      flags |= kForcedVar;
      any_forced = true;
      continue;
    }
    const int phase = pf[k] != 0 ? pf[k] : (sp[k] >= sn[k] ? 1 : -1);
    const unsigned long long k2 = dlis_key(sp[k] + sn[k] + 2, v + k, phase);
    key = k2 > key ? k2 : key;
  }
  if (!any_forced) return;
  int rp[N], rn[N];
  load_ints<N>(L.rpos + v, rp);
  load_ints<N>(L.rneg + v, rn);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (!fr[k] || (fp[k] <= 0 && fn[k] <= 0)) continue;
    const bool pos = fp[k] > 0;
    a[k] = pos ? 1 : -1;
    r[k] = 1;
    L.lvl[v + k] = L.depth;
    L.reason[v + k] = (pos ? rp[k] : rn[k]) - 1;
    L.tpos[v + k] = L.nstamp;
  }
  store_bytes<N>(L.A + v, a);
  store_bytes<N>(L.recent + v, r);
}

// Chronological backtrack of vars v .. v + N - 1 to level Lm: the flipped
// decision var takes its new phase, every other var assigned at Lm or
// deeper is unassigned and leaves the queue.
template <int N>
__device__ __forceinline__ void lane_backtrack(const Lane& L, int v, int Lm,
                                               int bvar, int bphase) {
  int a[N], r[N], lv[N];
  load_bytes<N>(L.A + v, a);
  load_bytes<N>(L.recent + v, r);
  bool touch = bvar >= v && bvar < v + N;
#pragma unroll
  for (int k = 0; k < N; ++k) touch |= a[k] != 0;
  if (!touch) return;
  load_ints<N>(L.lvl + v, lv);
  bool changed = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (v + k == bvar) {
      a[k] = bphase;
      r[k] = 1;
      L.lvl[v + k] = Lm;
      L.reason[v + k] = -1;
      L.tpos[v + k] = L.nstamp;
      changed = true;
    } else if (a[k] != 0 && lv[k] >= Lm) {
      a[k] = 0;
      r[k] = 0;
      changed = true;
    }
  }
  if (changed) {
    store_bytes<N>(L.A + v, a);
    store_bytes<N>(L.recent + v, r);
  }
}

// This block's vars of the lane: the quads [q0, q1) of the lane row's
// 16-byte grid (the row starts at b * V1, so up to three vars sit before
// the grid: block 0 takes them, and the last block the ragged end).
// Calls f.template operator()<N>(v) from thread `t` of `threads`.
struct Slice {
  int head, nq, q0, q1;
  bool first, last;
};

template <typename F>
__device__ __forceinline__ void for_slice(const Slice& s, int V1, int t,
                                          int threads, F&& f) {
  for (int q = s.q0 + t; q < s.q1; q += threads)
    f(std::integral_constant<int, 4>(), s.head + 4 * q);
  if (s.first)
    for (int j = t; j < s.head; j += threads)
      f(std::integral_constant<int, 1>(), j);
  if (s.last)
    for (int j = s.head + 4 * s.nq + t; j < V1; j += threads)
      f(std::integral_constant<int, 1>(), j);
}

// One solver iteration's per-lane step (the loop bodies of
// frontier.py:453 and resident.py:385), on a cluster of S blocks per lane.
// Block r owns a 1/S slice of the lane's vars; its one pass over them
// reads A, recent and, for open vars, the votes and scores with 16-byte
// loads, forces in place, and leaves its flags and DLIS key in block 0
// (distributed shared memory) for the decision.  The backtrack target is
// computed by every block; the first-UIP walk runs on block 0's warp 0
// while its other warps make the pass, and the cluster barrier after it
// keeps the other blocks' backtrack from rewriting the trail it reads.
__global__ void __launch_bounds__(kThreads) lane_step_kernel(FrontierArgs a) {
  const int* ctl = a.ctl + a.parity * kNctl;
  if (ctl[kHalt]) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / S, tid = threadIdx.x, V1 = a.V1, D = a.D;
  const bool lead = rank == 0;
  extern __shared__ int4 smem4[];
  __shared__ int red[kWarps], redf[kWarps];
  __shared__ unsigned long long redk[kWarps];
  __shared__ int s_pflags[kMaxLaneCluster];  // block 0: each block's partial
  __shared__ unsigned long long s_pkey[kMaxLaneCluster];
  __shared__ int s_row[kK], s_sel[kK];
  __shared__ int8_t s_sel_sign[kK];

  const size_t off = (size_t)b * V1;
  const bool full = ctl[kFull] != 0;
  const int status = a.status[b], depth = a.depth[b], stamp = a.stamp[b];
  const bool active = status == 0, conflict = a.conflict[b] != 0;
  const int crow = a.crow[b], nlearn = a.nlearn[b];
  int32_t* dvar = a.dvar + (size_t)b * D;
  int8_t* dphase = a.dphase + (size_t)b * D;
  uint8_t* dflip = a.dflip + (size_t)b * D;
  const Lane L{a.assign + off, a.lvl + off, a.reason + off, a.tpos + off,
               a.recent + off, a.cspos + off, a.csneg + off, a.fpos + off,
               a.fneg + off, a.rpos + off, a.rneg + off, a.spos + off,
               a.sneg + off, a.pref + off, depth, stamp + (active ? 1 : 0),
               full, active && !conflict};

  // the backtrack target: the deepest unflipped decision
  int Lm = 0, bvar = -1, bphase = 0;
  if (active && conflict) {
    int lm = 0;
    for (int d = tid; d < min(D, depth); d += kThreads)
      if (!dflip[d]) lm = d + 1;
    Lm = block_max(lm, red);
    if (Lm > 0) {
      bvar = dvar[Lm - 1];
      bphase = -(int)dphase[Lm - 1];
    }
  }
  const bool do_bt = active && conflict && Lm > 0;
  const bool walking = lead && do_bt && crow >= 0 && depth > 0;

  Slice s;
  s.head = min(V1, (int)((4 - (off & 3)) & 3));
  s.nq = (V1 - s.head) >> 2;
  const int per = (s.nq + S - 1) / S;
  s.q0 = min(s.nq, rank * per);
  s.q1 = min(s.nq, s.q0 + per);
  s.first = lead;
  s.last = rank == S - 1;

  // the walk (block 0's warp 0) and the pass (every other warp); a lane
  // that backtracks needs the pass only for the full view's scores
  if (!walking) cluster_arrive();
  int ok = 0;
  if (walking && tid < 32)
    ok = uip_walk(a, walk_layout(a, smem4), off, depth, crow, nlearn, s_row,
                  s_sel, s_sel_sign);
  int flags = 0;
  unsigned long long key = 0;
  const int t0 = walking ? 32 : 0;
  if (tid >= t0 && (!do_bt || full))
    for_slice(s, V1, tid - t0, kThreads - t0, [&](auto n, int v) {
      lane_pass<decltype(n)::value>(L, v, flags, key);
    });
  if (walking) cluster_arrive();

  if (do_bt) {
    cluster_wait();  // the walk is done: rewrite the trail
    for_slice(s, V1, tid, kThreads, [&](auto n, int v) {
      lane_backtrack<decltype(n)::value>(L, v, Lm, bvar, bphase);
    });
    if (lead) {
      const int bslot = Lm - 1;
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
    }
  } else {
    // the block's flags and key, to block 0's slot `rank`
    flags = (int)__reduce_or_sync(0xffffffffu, (unsigned)flags);
    key = warp_max_u64(key);
    if ((tid & 31) == 0) {
      redf[tid >> 5] = flags;
      redk[tid >> 5] = key;
    }
    __syncthreads();
    if (tid < 32) {
      flags = (int)__reduce_or_sync(
          0xffffffffu, tid < kWarps ? (unsigned)redf[tid] : 0u);
      key = warp_max_u64(tid < kWarps ? redk[tid] : 0ull);
    }
    cluster_wait();  // every block has started: block 0's slots are live
    if (tid == 0) {
      *cluster.map_shared_rank(&s_pflags[rank], 0) = flags;
      *cluster.map_shared_rank(&s_pkey[rank], 0) = key;
    }
    cluster_arrive();
    cluster_wait();
  }
  if (!lead) return;

  // block 0: the learned row, the decision, the lane's counters
  if (tid < kK) {
    a.litrow[(size_t)b * kK + tid] = ok ? s_row[tid] : 0;
    if (ok) {
      const int slot = min(max(nlearn, 0), a.learn_cap - 1);
      a.learned[((size_t)b * a.learn_cap + slot) * kK + tid] = s_row[tid];
    }
  }
  if (tid != 0) return;
  flags = 0;
  key = 0;
  if (!do_bt)
    for (int r = 0; r < S; ++r) {
      flags |= s_pflags[r];
      key = s_pkey[r] > key ? s_pkey[r] : key;
    }
  const bool has_force = flags & kForcedVar, open_any = flags & kFreeVar;
  const bool queued = flags & kQueuedVar;
  const bool unsat_now = active && conflict && Lm == 0;
  const bool do_force = L.quiet && has_force;
  const bool want = L.quiet && !has_force && open_any && (full || !queued);
  const bool do_dec = want && depth < D;
  const bool bail = want && depth >= D;
  const bool done_sat = L.quiet && !has_force && !open_any && full;
  int new_depth = depth;
  if (do_bt) new_depth = Lm;
  if (do_dec) {  // quiet + open: one DLIS decision (the epilogue cascades)
    const int var = dlis_var(key), phase = (key & 1) ? 1 : -1;
    L.A[var] = (int8_t)phase;
    L.lvl[var] = depth + 1;
    L.reason[var] = -1;
    L.tpos[var] = L.nstamp;
    L.recent[var] = 1;
    dvar[depth] = var;
    dphase[depth] = (int8_t)phase;
    dflip[depth] = 0;
    new_depth = depth + 1;
  }
  int st = status;
  if (unsat_now) st = 2;
  if (done_sat) st = 1;
  if (bail) st = 3;
  a.status[b] = st;
  a.depth[b] = new_depth;
  a.stamp[b] = L.nstamp;
  a.nlearn[b] = nlearn + ok;
  a.okl[b] = ok;
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

__device__ __forceinline__ bool rows_equal(const int4* x, const int4* y) {
  const int4 a0 = x[0], a1 = x[1], b0 = y[0], b1 = y[1];
  return a0.x == b0.x && a0.y == b0.y && a0.z == b0.z && a0.w == b0.w &&
         a1.x == b1.x && a1.y == b1.y && a1.z == b1.z && a1.w == b1.w;
}

__global__ void __launch_bounds__(kThreads)
    round_epilogue_kernel(FrontierArgs a) {
  const int* cur = a.ctl + a.parity * kNctl;
  int* nxt = a.ctl + (1 - a.parity) * kNctl;
  const int b = blockIdx.x, tid = threadIdx.x, B = a.B, V1 = a.V1, E = a.E;
  if (cur[kHalt]) {
    if (b == 0 && tid < kNctl) nxt[tid] = cur[tid];
    return;
  }
  const bool lead = b == 0;
  const bool pending = (a.flags[b] & kCascade) != 0;
  if (!lead && !pending) return;
  extern __shared__ int4 smem4[];
  uint8_t* in_extra = reinterpret_cast<uint8_t*>(smem4);
  // resident: the live pool rows at 0.., the lanes' learned rows at E..
  // (two int4 a row), the learning lanes in lane order, their duplicate
  // marks, each lane's slot (-1: not appended)
  int4* s_rows = reinterpret_cast<int4*>(in_extra + align16(V1));
  int* s_list = reinterpret_cast<int*>(s_rows + 2 * (E + B));
  int* s_dup = s_list + B;
  int* s_slot = s_dup + B;
  __shared__ int red[kWarps + 1];
  const int ne = cur[kNextra];
  int ne1 = ne;

  // the append (resident): lane order, dedup against the live pool and
  // against earlier lanes, consecutive slots, overflow dropped.  Every
  // block that needs it computes it; only block 0 writes the pool, and
  // only rows >= ne, which no other block reads.
  if (a.resident) {
    const int4* gx = reinterpret_cast<const int4*>(a.extra);
    const int4* gl = reinterpret_cast<const int4*>(a.litrow);
    for (int i = tid; i < 2 * ne; i += kThreads) s_rows[i] = gx[i];
    for (int i = tid; i < 2 * B; i += kThreads) s_rows[2 * E + i] = gl[i];
    __syncthreads();
    int nl = 0;  // lanes that learned a nonzero row
    for (int base = 0; base < B; base += kThreads) {
      const int j = base + tid;
      bool ok = false;
      if (j < B) {
        s_slot[j] = -1;
        const int4 x = s_rows[2 * (E + j)], y = s_rows[2 * (E + j) + 1];
        ok = a.okl[j] != 0 &&
             (x.x | x.y | x.z | x.w | y.x | y.y | y.z | y.w) != 0;
      }
      int total;
      const int pos = block_exclusive_sum(ok, red, &total);
      if (ok) {
        s_list[nl + pos] = j;
        s_dup[nl + pos] = 0;
      }
      nl += total;
    }
    __syncthreads();
    // every pair (learning lane, live pool row or earlier learning lane);
    // an okl lane whose row is zero matches no nonzero row
    const int width = ne + nl;
    for (int p = tid; p < nl * width; p += kThreads) {
      const int i = p / width, m = p - i * width;
      if (m >= ne && m - ne >= i) continue;
      const int other = m < ne ? m : E + s_list[m - ne];
      if (rows_equal(s_rows + 2 * (E + s_list[i]), s_rows + 2 * other))
        s_dup[i] = 1;
    }
    __syncthreads();
    // consecutive slots from ne, by an exclusive scan in lane order
    int kept = 0;
    for (int base = 0; base < nl; base += kThreads) {
      const int i = base + tid;
      const bool keep = i < nl && !s_dup[i];
      int total;
      const int pos = block_exclusive_sum(keep, red, &total);
      if (keep) {
        const int slot = ne + kept + pos;
        s_slot[s_list[i]] = slot < E ? slot : -1;
      }
      kept += total;
    }
    ne1 = min(E, ne + kept);
    __syncthreads();
    if (lead) {
      int4* gxw = reinterpret_cast<int4*>(a.extra);
      for (int i = tid; i < 2 * B; i += kThreads) {
        const int slot = s_slot[i >> 1];
        if (slot >= 0) gxw[2 * slot + (i & 1)] = s_rows[2 * E + i];
      }
    }
  }

  if (pending) {
    // the don't-care cascade of lane b's decision on a full view: free
    // vars in no open clause, minus the vars of the pool after the append
    for (int i = tid; i < align16(V1) / 16; i += kThreads)
      smem4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    const int32_t* pool =
        a.resident ? reinterpret_cast<const int32_t*>(s_rows) : a.extra;
    for (int i = tid; i < ne * kK; i += kThreads) {
      const int l = pool[i];
      if (l) in_extra[min(abs(l), V1 - 1)] = 1;
    }
    if (a.resident) {
      const int32_t* lr = reinterpret_cast<const int32_t*>(s_rows + 2 * E);
      for (int i = tid; i < B * kK; i += kThreads) {
        const int l = lr[i];
        if (l && s_slot[i / kK] >= 0) in_extra[min(abs(l), V1 - 1)] = 1;
      }
    }
    __syncthreads();
    const size_t off = (size_t)b * V1;
    const int depth = a.depth[b], stamp = a.stamp[b];
    auto settle = [&](int v, int assigned, int score) {
      if (v >= 2 && !assigned && !score && !in_extra[v]) {
        a.assign[off + v] = 1;
        a.lvl[off + v] = depth;
        a.reason[off + v] = -1;
        a.tpos[off + v] = stamp;
      }
    };
    // assign (4 bytes), spos and sneg (16 bytes) of four vars a load where
    // the lane's row allows, scalars at the ends
    const int head = min(V1, (int)((4 - (off & 3)) & 3));
    const int quads = (V1 - head) >> 2;
    for (int q = tid; q < quads; q += kThreads) {
      const int v = head + 4 * q;
      const unsigned A4 = *reinterpret_cast<const unsigned*>(a.assign + off + v);
      const int4 p = *reinterpret_cast<const int4*>(a.spos + off + v);
      const int4 n = *reinterpret_cast<const int4*>(a.sneg + off + v);
      settle(v, A4 & 0xffu, p.x + n.x);
      settle(v + 1, A4 & 0xff00u, p.y + n.y);
      settle(v + 2, A4 & 0xff0000u, p.z + n.z);
      settle(v + 3, A4 & 0xff000000u, p.w + n.w);
    }
    for (int j = tid; j < V1 - 4 * quads; j += kThreads) {
      const int v = j < head ? j : j + 4 * quads;
      settle(v, a.assign[off + v], a.spos[off + v] + a.sneg[off + v]);
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
  // the 16-byte loads and bulk copies of pool, shared and learned rows
  if (((uintptr_t)a->lits | (uintptr_t)a->extra | (uintptr_t)a->litrow) & 15)
    return 0;
  return 1;
}

int configure(const void* kernel, int smem, int* configured) {
  if (smem > *configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    *configured = smem;
  }
  return 0;
}

// `kernel` on B clusters of S blocks (one cluster a lane).
int cluster_launch(void (*kernel)(FrontierArgs), int S, int smem,
                   int* configured, const FrontierArgs* a, void* stream) {
  if (!checked(a) || !S) return (int)cudaErrorInvalidValue;
  if (const int err = configure((const void*)kernel, smem, configured))
    return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a->B * S);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, *a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int scan_configured = 0, lane_configured = 0, epilogue_configured = 0;

}  // namespace

extern "C" {

// Plain C entry points (bound with ctypes).  Each returns the cudaError_t
// of its launch; 0 means the kernel was queued on `stream`.
int frontier_scan_rows_launch(const FrontierArgs* a, void* stream) {
  const int S = scan_cluster(*a);
  return cluster_launch(scan_rows_kernel, S, S ? scan_smem(*a, S) : 0,
                        &scan_configured, a, stream);
}

int frontier_lane_step_launch(const FrontierArgs* a, void* stream) {
  return cluster_launch(lane_step_kernel, lane_cluster(*a),
                        smem_bytes(*a, kLane), &lane_configured, a, stream);
}

int frontier_round_epilogue_launch(const FrontierArgs* a, void* stream) {
  if (!checked(a)) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(*a, kEpilogue);
  if (const int err = configure((const void*)round_epilogue_kernel, smem,
                                &epilogue_configured))
    return err;
  round_epilogue_kernel<<<a->B, kThreads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int frontier_width() { return kK; }

// Dynamic shared memory of one kernel (0 scan, 1 lane step, 2 epilogue).
int frontier_smem_bytes(const FrontierArgs* a, int kernel) {
  return smem_bytes(*a, kernel);
}

// Cluster size of the scan (0: no block fits).
int frontier_scan_cluster(const FrontierArgs* a) { return scan_cluster(*a); }

// Cluster size of the lane step.
int frontier_lane_cluster(const FrontierArgs* a) { return lane_cluster(*a); }

}  // extern "C"
