// One DPLL clause sweep over the clause rows' literals, for sm_90a.
//
// Replaces the Pallas TPU kernel mythril_tpu/ops/pallas_prop.py:435
// (_make_dpll_sweep, pl.pallas_call at :535).  Same function, as if over
// the dense clause-incidence planes P, N [C, V] of the JAX package:
//
//   true[b,c]  = relu(A)[b]·P[c] + relu(-A)[b]·N[c]   (satisfied literals)
//   false[b,c] = relu(-A)[b]·P[c] + relu(A)[b]·N[c]   (falsified literals)
//   unit  = unsatisfied clause with exactly one unknown literal
//   open  = unsatisfied clause with two or more unknown literals
//   fpos = unit·P, fneg = unit·N, (spos = open·P, sneg = open·N),
//   conf[b] = any clause of lane b with every literal false.
//
// Inputs: the rows in CSR form, indptr [C + 1] int32 and cells [nnz]
// int32, one cell a (row, column, sign) incidence coded
// (column << 2) | n << 1 | p (p for P, n for N; a row's cells in any
// order, no cell twice), width [1, C] f32, A [B, V] f32 in {-1, 0, +1}.
// Outputs [B, V] / [B, 1] f32, zeroed by the caller.  Only the leading
// `rows` clause rows are scanned (the hot-tier sweep).  Every sum is a
// count of 0/1 terms below 2^24, so the float32 results are exact in any
// order and equal the plain PyTorch versions (ops/dense_sweep.py:
// sweep_plain over planes, sweep_rows_plain over these rows) bit for
// bit.
//
// Design.  The TPU kernel streams [TC, V] tiles of the planes through the
// MXU and carries [B, V] sums across a sequential grid.  A CNF row holds
// a handful of literals among thousands of columns, so here the kernel
// reads the literals only: one thread a (row, lane) pair.  A block takes
// 256 / G rows for a group of G = 8 lanes (G = B where 8 does not divide
// B), the G threads of a row neighbours that read the row's cells at the
// same addresses (broadcast loads), and the grid runs lane group after
// lane group, so the blocks on the card at one time gather from the same
// G rows of A: 128 KiB at V = 4,096, which the SM's L1 holds, where the
// whole of A (0.25-1 MiB on the main path) would go to L2 for every
// gather.  Each thread
//   1. gathers A[b, column] of the row's cells and counts its true and
//      false literals;
//   2. classifies the clause for its lane (all false / unit / open);
//   3. walks the cells again and adds 1.0 into fpos/fneg (unit) or
//      spos/sneg (open, with scores) at its lane's columns, by float
//      atomics: integer-valued and below 2^24, so order-free.
// conf[b] is the same 1.0 stored from any row.  Rows of width 0 (bucket
// padding) count nothing and stop at once.  A row of any width loops
// over its cells: there is no per-row list to overflow.
//
// Bound at the check's shape (C = 16384, V = 4096, B = 64; about 93,000
// cells): the row pointers, cells and widths (about 0.5 MiB), A (1 MiB)
// and the four outputs (4 MiB) moved once, ≈ 5.5 MiB: ≈ 1.7 µs at
// 3.35 TB/s.  The operations (two counts a cell and lane, one add a
// scattered unit) are below that at the 32-bit integer rate.  What holds
// the kernel is the gathers of A, one a cell and lane (6 million at the
// check's shape), each to its own line: on an H100 at 700 W it runs at
// about 8 ns a thousand gathers at both main-path shapes
// (chip_tools/dense_sweep_times.py), far from HBM; no dense tile exists
// for wgmma or TMA to feed.
//
// Compiled as host C++ (no __CUDACC__), the same source emulates the
// grid (dense_sweep_host): block after block, each thread taking its
// (row, lane) pair as the kernel does, so the CPU tests hold the kernel's
// own mapping and pair function against the plain versions and the JAX
// package.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DS_FN __device__ __forceinline__
#define DS_HD __host__ __device__ __forceinline__
#else
#define DS_FN inline
#define DS_HD inline
#endif

namespace ds {

constexpr int kThreads = 256;   // threads a block
constexpr int kLaneGroup = 8;   // lanes a block's rows are swept for
constexpr long long kMaxPairs = 1LL << 30;   // (row, lane) pairs a launch

// Lanes of a block: kLaneGroup where it divides B, else all B (at most
// kThreads: the launch refuses more).
DS_HD int lane_group(int B) { return B % kLaneGroup == 0 ? kLaneGroup : B; }

// Blocks of a launch over `rows` rows and B lanes: every row block of
// one lane group, then the next group's.
DS_HD long long grid_blocks(int B, int rows) {
  const int G = lane_group(B);
  const int per = kThreads / G;
  return (long long)(B / G) * ((rows + per - 1) / per);
}

// The (row, lane) pair of thread t of block blk; false for a thread past
// the last row or past the block's rows.
DS_HD bool pair_of(int blk, int t, int B, int rows, int* r, int* b) {
  const int G = lane_group(B);
  const int per = kThreads / G;             // rows a block
  const int row_blocks = (rows + per - 1) / per;
  const int group = blk / row_blocks;
  const int k = t / G;
  if (k >= per) return false;
  *r = (blk - group * row_blocks) * per + k;
  *b = group * G + (t - k * G);
  return *r < rows;
}

// A launch's arguments the kernel takes (B lanes in groups of at most a
// block, the grid in int range).
DS_HD bool launch_ok(int B, int V, int rows) {
  return B >= 1 && V >= 1 && rows >= 1
      && (long long)rows * B <= kMaxPairs && lane_group(B) <= kThreads;
}

DS_FN void add_one(float* at) {
#ifdef __CUDACC__
  atomicAdd(at, 1.0f);
#else
  *at += 1.0f;
#endif
}

// Thread (row r, lane b): counts, classifies and scatters one clause row
// for one lane.
DS_FN void sweep_pair(const int* __restrict__ indptr,
                      const int* __restrict__ cells,
                      const float* __restrict__ width,
                      const float* __restrict__ A, int V, int r, int b,
                      float* __restrict__ fpos, float* __restrict__ fneg,
                      float* __restrict__ conf, float* __restrict__ spos,
                      float* __restrict__ sneg, int scores) {
  const float w = width[r];
  if (!(w > 0.5f)) return;           // bucket padding: counts nothing
  const int begin = indptr[r];
  const int end = indptr[r + 1];
  const float* a_row = A + (size_t)b * (size_t)V;

  // 1. true and false literals of lane b
  int t = 0, f = 0;
  for (int e = begin; e < end; ++e) {
    const int cell = cells[e];
    const float a = a_row[cell >> 2];
    const int p = cell & 1;
    const int n = (cell >> 1) & 1;
    if (a > 0.0f) {
      t += p;
      f += n;
    } else if (a < 0.0f) {
      t += n;
      f += p;
    }
  }

  // 2. classification (sweep_plain's float arithmetic, exact on counts)
  const float tc = (float)t, fc = (float)f;
  if (fc > w - 0.5f) conf[b] = 1.0f;   // same value from any row
  if (!(tc < 0.5f)) return;            // satisfied
  const float unk = w - tc - fc;
  const bool unit = unk > 0.5f && unk < 1.5f;
  const bool open = scores && unk > 1.5f;
  if (!unit && !open) return;

  // 3. the row's memberships at lane b's columns
  const size_t lane = (size_t)b * (size_t)V;
  float* out_p = (unit ? fpos : spos) + lane;
  float* out_n = (unit ? fneg : sneg) + lane;
  for (int e = begin; e < end; ++e) {
    const int cell = cells[e];
    if (cell & 1) add_one(out_p + (cell >> 2));
    if (cell & 2) add_one(out_n + (cell >> 2));
  }
}

}  // namespace ds

#ifdef __CUDACC__

__global__ void __launch_bounds__(ds::kThreads)
dense_sweep_kernel(const int* __restrict__ indptr,
                   const int* __restrict__ cells,
                   const float* __restrict__ width,
                   const float* __restrict__ A, int B, int V, int rows,
                   float* __restrict__ fpos, float* __restrict__ fneg,
                   float* __restrict__ conf, float* __restrict__ spos,
                   float* __restrict__ sneg, int scores) {
  int r, b;
  if (!ds::pair_of(blockIdx.x, threadIdx.x, B, rows, &r, &b)) return;
  ds::sweep_pair(indptr, cells, width, A, V, r, b, fpos, fneg, conf, spos,
                 sneg, scores);
}

extern "C" {

// Plain C entry point (bound with ctypes).  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for arguments launch_ok refuses); 0 means
// the kernel was queued on `stream`.
int dense_sweep_launch(const int* indptr, const int* cells,
                       const float* width, const float* A, int B, int V,
                       int rows, float* fpos, float* fneg, float* conf,
                       float* spos, float* sneg, int scores, void* stream) {
  if (!ds::launch_ok(B, V, rows)) return (int)cudaErrorInvalidValue;
  const int blocks = (int)ds::grid_blocks(B, rows);
  dense_sweep_kernel<<<blocks, ds::kThreads, 0, (cudaStream_t)stream>>>(
      indptr, cells, width, A, B, V, rows, fpos, fneg, conf, spos, sneg,
      scores);
  return (int)cudaGetLastError();
}

}  // extern "C"

#else  // host C++

extern "C" {

// The kernel's grid emulated: every block's threads one after another,
// each taking its (row, lane) pair as the kernel does.  Returns 0, or -1
// for arguments the launch refuses.
int dense_sweep_host(const int* indptr, const int* cells, const float* width,
                     const float* A, int B, int V, int rows, float* fpos,
                     float* fneg, float* conf, float* spos, float* sneg,
                     int scores) {
  if (!ds::launch_ok(B, V, rows)) return -1;
  const long long blocks = ds::grid_blocks(B, rows);
  for (long long blk = 0; blk < blocks; ++blk) {
    for (int t = 0; t < ds::kThreads; ++t) {
      int r, b;
      if (!ds::pair_of((int)blk, t, B, rows, &r, &b)) continue;
      ds::sweep_pair(indptr, cells, width, A, V, r, b, fpos, fneg, conf,
                     spos, sneg, scores);
    }
  }
  return 0;
}

}  // extern "C"

#endif  // __CUDACC__
