// One DPLL clause sweep over dense clause-incidence planes, for sm_90a.
//
// Replaces the Pallas TPU kernel mythril_tpu/ops/pallas_prop.py:435
// (_make_dpll_sweep, pl.pallas_call at :535).  Same function:
//
//   true[b,c]  = relu(A)[b]·P[c] + relu(-A)[b]·N[c]   (satisfied literals)
//   false[b,c] = relu(-A)[b]·P[c] + relu(A)[b]·N[c]   (falsified literals)
//   unit  = unsatisfied clause with exactly one unknown literal
//   open  = unsatisfied clause with two or more unknown literals
//   fpos = unit·P, fneg = unit·N, (spos = open·P, sneg = open·N),
//   conf[b] = any clause of lane b with every literal false.
//
// Inputs: P, N [C, V] bf16 holding 0/1 (any nonzero bit pattern counts as
// an incidence), width [1, C] f32, A [B, V] f32 in {-1, 0, +1}.  Outputs
// [B, V] / [B, 1] f32, zeroed by the caller.  Only the leading `rows`
// clause rows are scanned (the hot-tier sweep).  Every sum is a count of
// 0/1 terms below 2^24, so the float32 results are exact in any order
// and equal the plain PyTorch version (ops/dense_sweep.py:sweep_plain)
// bit for bit.
//
// Design.  The TPU kernel streams [TC, V] tiles through the MXU and
// carries [B, V] sums across a sequential grid.  CUDA blocks run in no
// order, and the planes are very sparse (a CNF clause has a handful of
// literals in a row of thousands of columns), so here one block owns one
// clause row and works on the row's nonzeros only:
//   1. the block streams the row of P and N once, 16 bytes per thread per
//      load, and collects its nonzero cells into shared memory;
//   2. thread b (one per lane) counts true/false literals of lane b over
//      that list and classifies the clause (unit / open / all-false);
//   3. the block scatters the unit/open memberships into the [B, V]
//      outputs with float atomics (integer-valued, so order-free).
// A row holds at most kMaxNz nonzero cells: the wrapper refuses wider
// clauses (ops/dense_sweep.py, MAX_ROW_LITERALS), and a row that still
// overflows traps rather than return a wrong count.
//
// Bound at the slice's shape (C = 16384, V = 4096, B = 64): the two bf16
// planes are 2·C·V·2 B = 256 MiB, read once: ≈ 80 µs at 3.35 TB/s.  The
// dense formulation's 8 products are ≈ 69 GFLOP, ≈ 70 µs at the bf16
// tensor-core rate, but this kernel does only the sparse work the data
// needs (nnz·B counts and scatters), so the sweep is memory-bound and
// this design reads the planes once.  The [B, V] assignment (1 MiB) and
// outputs stay in L2.  wgmma/TMA or bit-packed planes belong to a later
// change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads per block; also the lane cap
constexpr int kMaxNz = 2048;    // nonzero cells of one row kept in smem

__device__ __forceinline__ void count_cell(float a, int p, int n,
                                           int& t, int& f) {
  if (a > 0.0f) {
    t += p;
    f += n;
  } else if (a < 0.0f) {
    t += n;
    f += p;
  }
}

__device__ __forceinline__ void scatter_cell(int flag, int p, int n,
                                             float* fpos, float* fneg,
                                             float* spos, float* sneg,
                                             size_t at, int scores) {
  if (flag & 1) {
    if (p) atomicAdd(fpos + at, 1.0f);
    if (n) atomicAdd(fneg + at, 1.0f);
  }
  if ((flag & 2) && scores) {
    if (p) atomicAdd(spos + at, 1.0f);
    if (n) atomicAdd(sneg + at, 1.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
dense_sweep_kernel(const uint16_t* __restrict__ P,
                   const uint16_t* __restrict__ N,
                   const float* __restrict__ width,
                   const float* __restrict__ A,
                   int B, int V,
                   float* __restrict__ fpos, float* __restrict__ fneg,
                   float* __restrict__ conf,
                   float* __restrict__ spos, float* __restrict__ sneg,
                   int scores) {
  __shared__ int nz[kMaxNz];          // (column << 2) | n << 1 | p
  __shared__ int nz_count;
  __shared__ unsigned char lane_flag[kThreads];  // bit0 unit, bit1 open

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = (size_t)c * (size_t)V;
  if (tid == 0) nz_count = 0;
  __syncthreads();

  // 1. stream the row: 8 bf16 cells of each plane per 16-byte load
  const uint4* prow = reinterpret_cast<const uint4*>(P + row);
  const uint4* nrow = reinterpret_cast<const uint4*>(N + row);
  const int nvec = V / 8;
  for (int i = tid; i < nvec; i += kThreads) {
    const uint4 p4 = prow[i];
    const uint4 n4 = nrow[i];
    if ((p4.x | p4.y | p4.z | p4.w | n4.x | n4.y | n4.z | n4.w) == 0u)
      continue;
    const unsigned pw[4] = {p4.x, p4.y, p4.z, p4.w};
    const unsigned nw[4] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = ((pw[j >> 1] >> (16 * (j & 1))) & 0xffffu) != 0u;
      const int n = ((nw[j >> 1] >> (16 * (j & 1))) & 0xffffu) != 0u;
      if (p | n) {
        const int k = atomicAdd(&nz_count, 1);
        if (k < kMaxNz) nz[k] = ((i * 8 + j) << 2) | (n << 1) | p;
      }
    }
  }
  __syncthreads();
  const int total = nz_count;
  if (total > kMaxNz) __trap();

  // 2. per-lane literal counts and clause classification
  if (tid < B) {
    const float* a_row = A + (size_t)tid * (size_t)V;
    int t = 0, f = 0;
    for (int e = 0; e < total; ++e) {
      const int ent = nz[e];
      count_cell(a_row[ent >> 2], ent & 1, (ent >> 1) & 1, t, f);
    }
    const float w = width[c];
    const float tc = (float)t, fc = (float)f;
    const bool real = w > 0.5f;
    const float unk = w - tc - fc;
    const bool unsat_yet = (tc < 0.5f) && real;
    int flag = 0;
    if (unsat_yet && unk > 0.5f && unk < 1.5f) flag |= 1;
    if (unsat_yet && unk > 1.5f) flag |= 2;
    lane_flag[tid] = (unsigned char)flag;
    if (real && fc > w - 0.5f) conf[tid] = 1.0f;  // same value from any row
  }
  __syncthreads();

  // 3. scatter unit / open memberships into the [B, V] outputs
  for (int idx = tid; idx < total * B; idx += kThreads) {
    const int b = idx % B;
    const int flag = lane_flag[b];
    if (!flag) continue;
    const int ent = nz[idx / B];
    scatter_cell(flag, ent & 1, (ent >> 1) & 1, fpos, fneg, spos, sneg,
                 (size_t)b * V + (ent >> 2), scores);
  }
}

}  // namespace

extern "C" {

// Plain C entry point (bound with ctypes).  Returns the cudaError_t of the
// launch; 0 means the kernel was queued on `stream`.
int dense_sweep_launch(const void* P, const void* N, const float* width,
                       const float* A, int B, int V, int rows,
                       float* fpos, float* fneg, float* conf, float* spos,
                       float* sneg, int scores, void* stream) {
  if (B < 1 || B > kThreads || V < 8 || V % 8 != 0 || rows < 1)
    return (int)cudaErrorInvalidValue;
  dense_sweep_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(P), static_cast<const uint16_t*>(N),
      width, A, B, V, fpos, fneg, conf, spos, sneg, scores);
  return (int)cudaGetLastError();
}

int dense_sweep_max_lanes() { return kThreads; }

int dense_sweep_max_row_cells() { return kMaxNz; }

}  // extern "C"
