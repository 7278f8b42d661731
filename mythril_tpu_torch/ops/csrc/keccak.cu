// Batched Keccak-256, for sm_90a: one digest a row of a uint8 [B, L]
// batch, L the same for every row of a launch.
//
// Replaces the JAX package's batched sponge mythril_tpu/ops/keccak.py:
// keccak256_batch (:139) over keccak_f_batch (:91), which the symbolic
// lockstep tier runs on the concrete SHA3 windows of a segment group.  No
// Pallas kernel: on a TPU it is one XLA program whose 64-bit lanes are
// carried as (hi, lo) pairs of uint32 arrays, an XLA layout with no
// 64-bit integers.  Here a lane is a register.
//
// What it computes (the same as the plain PyTorch version,
// ops/keccak.py:keccak256_batch_plain, bit for bit): the original Keccak
// sponge of rate 136 bytes with pad10*1 and the domain byte 0x01 (not
// SHA3's 0x06): the row, then 0x01, zeros and a final 0x80 up to a
// multiple of 136 bytes (a single 0x81 when one byte is left; a full
// padding block when L is a multiple of 136), absorbed 136 bytes a
// block as 17 little-endian 64-bit lanes, each block followed by the 24
// rounds of Keccak-f[1600]; the digest is lanes 0 to 3, little-endian.
//
// Design: a block of kRows threads hashes a tile of kRows rows, one
// thread a row.  The 25 lanes of a row's state sit in the thread's
// registers as uint64_t and the 24 rounds are unrolled, so every index
// and every rotation is a constant (ptxas fuses chi's logic into
// three-input LOP3 and a rotation into two funnel shifts; theta's
// three-input XORs are written as LOP3 by hand, xor3).
//
// The message reaches the threads through shared memory.  For sponge
// block k the block's threads together stage the tile's padded messages:
// bytes [136k, min(136k + 136, L)) of each row, then the padding (0x01
// after the row's last byte, 0x80 in the last block's last byte, zeros
// between), as kRows rows of 17 64-bit words, a row at an odd stride of
// 17 words so that a thread's 64-bit reads of its own row fall on
// distinct banks across a half-warp.  Staging goes word by word,
// consecutive threads on consecutive words, so consecutive threads read
// consecutive 8-byte words of the batch (for L <= 136 the tile's rows are
// one contiguous span of kRows x L bytes), every copy an aligned 8-byte
// cp.async that holds no register.  Where the base and L are multiples of
// 8 a message word is one copy straight into the tile.  Elsewhere the
// copies land in raw words (a row's 136 bytes from any offset span 18
// aligned words), and after a barrier each tile word is funnel-shifted
// out of two of them, the words shared out among the threads as the
// copies are; only a word at the first or last bytes of the batch is read
// byte by byte.  A thread's absorb is then 17 64-bit shared loads and
// XORs into its state: no selects, no byte assembly and no branch on L a
// lane.  Block k + 1 is staged into the same tile after block k permutes.
// The digest leaves as two 16-byte stores a row.  Measured against this
// (chip_tools/keccak_times.py, NVIDIA H100 80GB HBM3 at 700 W): a second
// tile staged during the permutation was up to 4.5% slower; each thread
// shifting its own unaligned row took 80 registers, not 72, and was 3%
// faster at 137 B but 1% slower on aligned rows.
//
// Bound: operations.  A block needs 24 rounds of 178 32-bit integer
// operations on the lanes' halves with three-input logic (LOP3) fused
// (theta's column parities, 1-bit rotations and three-input XORs, 80;
// rho's 24 rotations as two funnel shifts each, 48; chi's NOT-AND-XOR,
// 50), plus iota's XOR of each nonzero half of the round constant,
// against 136 bytes read.  They issue at the integer rate of compute
// capability 9.0, 64 a clock an SM (about 16.7e12 a second at 132 SMs
// and 1.98 GHz), not at the float32 FMA rate.  The staging adds a
// dozen operations a tile word, the absorb 17 shared loads a block.
//
// Compiled as host C++ (no __CUDACC__), the same functions run the grid
// block by block (keccak_host): between two barriers every thread of the
// block runs in turn over a local tile, so the CPU tests hold the
// kernel's own staging, padding and row function against the plain
// version and the JAX package.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KC_FN __device__ __forceinline__
#define KC_HD __host__ __device__ __forceinline__
#else
#define KC_FN inline
#define KC_HD inline
#endif

namespace kc {

constexpr int kRate = 136;        // ops/keccak.py:RATE_BYTES
constexpr int kRateLanes = kRate / 8;  // 17: a tile row's words (its stride)
constexpr int kRows = 128;        // rows (threads) a block
constexpr int kTileWords = kRows * kRateLanes;
constexpr int kRawStride = 18;    // raw words a row: 136 bytes from any offset

#ifdef __CUDACC__
__constant__ uint64_t kRC[24] = {
#else
constexpr uint64_t kRC[24] = {
#endif
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// rotation offsets of lane x + 5 y (ops/keccak.py:_ROT[x][y])
constexpr int kRot[25] = {
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
};

template <int N>
KC_FN uint64_t rotl(uint64_t x) {
  return N == 0 ? x : (x << N) | (x >> ((64 - N) & 63));
}

// rho and pi: b[y + 5 ((2 x + 3 y) % 5)] = rotl(a[x + 5 y], kRot[x + 5 y])
template <int I>
KC_FN void rho_pi(const uint64_t* a, uint64_t* b) {
  constexpr int x = I % 5, y = I / 5;
  b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl<kRot[I]>(a[I]);
  if constexpr (I < 24) rho_pi<I + 1>(a, b);
}

// a ^ b ^ c, on the card one three-input LOP3 a 32-bit half: theta XORs
// both column parities into each lane at once (left to itself, ptxas
// computes d = c[x - 1] ^ rot(c[x + 1]) once a column and then a ^= d,
// ten more LOP3 a round)
KC_FN uint64_t xor3(uint64_t a, uint64_t b, uint64_t c) {
#ifdef __CUDACC__
  uint32_t lo, hi;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;"
      : "=r"(lo)
      : "r"((uint32_t)a), "r"((uint32_t)b), "r"((uint32_t)c));
  asm("lop3.b32 %0, %1, %2, %3, 0x96;"
      : "=r"(hi)
      : "r"((uint32_t)(a >> 32)), "r"((uint32_t)(b >> 32)),
        "r"((uint32_t)(c >> 32)));
  return (uint64_t)hi << 32 | lo;
#else
  return a ^ b ^ c;
#endif
}

KC_FN void keccak_f(uint64_t* a) {
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int x = 0; x < 5; ++x) {
      const uint64_t r = rotl<1>(c[(x + 1) % 5]);
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int y = 0; y < 25; y += 5)
        a[x + y] = xor3(a[x + y], c[(x + 4) % 5], r);
    }
    rho_pi<0>(a, b);
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int y = 0; y < 25; y += 5) {
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int x = 0; x < 5; ++x)
        a[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y] & b[(x + 2) % 5 + y]);
    }
    a[0] ^= kRC[round];
  }
}

// A launch's batch: rows x len bytes from data (addresses as integers).
struct Batch {
  uintptr_t data, end;  // [data, end): every byte of the batch
  int rows, len;
  int blocks;    // sponge blocks a row: len / kRate + 1
  bool aligned;  // data and len multiples of 8: a message word is one copy
};

KC_HD Batch make_batch(const uint8_t* data, int rows, int len) {
  Batch b;
  b.data = reinterpret_cast<uintptr_t>(data);
  b.end = b.data + (uintptr_t)rows * (uintptr_t)len;
  b.rows = rows;
  b.len = len;
  b.blocks = len / kRate + 1;
  b.aligned = b.data % 8 == 0 && len % 8 == 0;
  return b;
}

// the 64-bit words of shared memory a block uses: the tile, and where the
// rows are not aligned the raw words staging copies them into (35,840 B
// at most: no opt-in past 48 KiB)
KC_HD int smem_words(bool aligned) {
  return kTileWords + (aligned ? 0 : kRows * kRawStride);
}

// the first byte of the row's block k
KC_FN uintptr_t block_start(const Batch& b, int row, int k) {
  return b.data + (uintptr_t)row * (uintptr_t)b.len + (uintptr_t)(kRate * k);
}

// the row's bytes in block k (0 to 136: fewer only in the last block)
KC_FN int block_bytes(const Batch& b, int k) {
  const int rest = b.len - kRate * k;
  return rest < kRate ? rest : kRate;
}

// the 8 aligned bytes at src into the shared word dst, asynchronously on
// the card (copies_done waits for this thread's copies)
KC_FN void copy_word(uint64_t* dst, uintptr_t src) {
#ifdef __CUDACC__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  memcpy(dst, reinterpret_cast<const void*>(src), 8);
#endif
}

KC_FN void copies_done() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// the padding's bits in word j of a tile row whose block holds s bytes of
// the row: 0x01 after the row's last byte, 0x80 at the last block's end
KC_FN uint64_t padding(int s, int j, bool last) {
  const int d = s - 8 * j;
  uint64_t word = d >= 0 && d < 8 ? 1ull << (8 * d) : 0;
  if (last && j == kRateLanes - 1) word |= 0x80ull << 56;
  return word;
}

// Staging's first step, thread t's share, for sponge block k of the tile
// whose first row is row0.  Aligned rows: tile words t, t + kRows, ...
// (word w is lane w % 17 of tile row w / 17), each an 8-byte copy of the
// row or the padding (a row past the batch is padding alone).  Other
// rows: raw words t, t + kRows, ... (word w is the aligned word w % 18
// from the start of tile row w / 18's block), those that hold the row's
// bytes; only a word at the batch's first or last bytes is read byte by
// byte, its bytes outside the batch zero.
KC_FN void stage_copy(uint64_t* tile, uint64_t* raw, const Batch& b,
                      int row0, int k, int t) {
  const int s = block_bytes(b, k);
  if (b.aligned) {
    const bool last = k + 1 == b.blocks;
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int w = t; w < kTileWords; w += kRows) {
      const int r = w / kRateLanes, j = w - r * kRateLanes;
      if (8 * j < s && row0 + r < b.rows)
        copy_word(tile + w, block_start(b, row0 + r, k) + 8 * j);
      else
        tile[w] = padding(s, j, last);
    }
    return;
  }
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int w = t; w < kRows * kRawStride; w += kRows) {
    const int r = w / kRawStride, i = w - r * kRawStride;
    if (8 * i - 7 >= s || row0 + r >= b.rows) continue;
    const uintptr_t start = block_start(b, row0 + r, k);
    const uintptr_t p = (start & ~(uintptr_t)7) + 8 * i;
    if (p >= start + s) continue;
    if (p >= b.data && p + 8 <= b.end) {
      copy_word(raw + w, p);
      continue;
    }
    uint64_t v = 0;
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int n = 0; n < 8; ++n)
      if (p + n >= b.data && p + n < b.end)
        v |= (uint64_t)*reinterpret_cast<const uint8_t*>(p + n) << (8 * n);
    raw[w] = v;
  }
}

// Staging's second step where the rows are not aligned, thread t's share:
// tile words t, t + kRows, ..., each the row's 8 bytes funnel-shifted out
// of two raw words, the bytes past the row cut, and the padding.
KC_FN void stage_shift(uint64_t* tile, const uint64_t* raw, const Batch& b,
                       int row0, int k, int t) {
  const int s = block_bytes(b, k);
  const bool last = k + 1 == b.blocks;
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int w = t; w < kTileWords; w += kRows) {
    const int r = w / kRateLanes, j = w - r * kRateLanes;
    const int d = s - 8 * j;  // the row's bytes from this word on
    uint64_t word = padding(s, j, last);
    if (d > 0 && row0 + r < b.rows) {
      // (hi << (63 - shift)) << 1: hi's bytes above lo's, none at shift 0
      const int shift = 8 * (int)(block_start(b, row0 + r, k) & 7);
      const uint64_t* pair = raw + r * kRawStride + j;
      const uint64_t v = pair[0] >> shift | (pair[1] << (63 - shift)) << 1;
      word |= d < 8 ? v & ((1ull << (8 * d)) - 1) : v;
    }
    tile[w] = word;
  }
}

// the first block into a fresh state: its 17 words, the capacity zero
KC_FN void absorb_first(uint64_t* a, const uint64_t* row) {
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = 0; i < kRateLanes; ++i) a[i] = row[i];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = kRateLanes; i < 25; ++i) a[i] = 0;
}

KC_FN void absorb(uint64_t* a, const uint64_t* row) {
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = 0; i < kRateLanes; ++i) a[i] ^= row[i];
}

// lanes 0 to 3 into out[0:32]
KC_FN void store_digest(const uint64_t* a, uint8_t* out) {
#ifdef __CUDACC__
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    ulonglong2* v = reinterpret_cast<ulonglong2*>(out);
    v[0] = make_ulonglong2(a[0], a[1]);
    v[1] = make_ulonglong2(a[2], a[3]);
    return;
  }
  uint64_t* words = reinterpret_cast<uint64_t*>(out);
  for (int i = 0; i < 4; ++i) words[i] = a[i];
#else
  memcpy(out, a, 32);
#endif
}

}  // namespace kc

#ifdef __CUDACC__

__global__ void __launch_bounds__(kc::kRows)
keccak_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
              int rows, int len) {
  extern __shared__ uint64_t smem[];
  uint64_t* tile = smem;
  uint64_t* raw = smem + kc::kTileWords;
  const kc::Batch b = kc::make_batch(data, rows, len);
  const int row0 = blockIdx.x * kc::kRows;
  const int t = threadIdx.x;
  uint64_t a[25];
  kc::stage_copy(tile, raw, b, row0, 0, t);
  for (int k = 0;; ++k) {
    kc::copies_done();
    __syncthreads();
    if (!b.aligned) {
      kc::stage_shift(tile, raw, b, row0, k, t);
      __syncthreads();
    }
    if (k == 0)
      kc::absorb_first(a, tile + t * kc::kRateLanes);
    else
      kc::absorb(a, tile + t * kc::kRateLanes);
    kc::keccak_f(a);
    if (k + 1 == b.blocks) break;
    __syncthreads();  // every row absorbed before the tile is staged again
    kc::stage_copy(tile, raw, b, row0, k + 1, t);
  }
  if (row0 + t < rows) kc::store_digest(a, out + (size_t)(row0 + t) * 32);
}

extern "C" {

// One launch over rows x len bytes on `stream`; out holds rows x 32 bytes
// (8-byte aligned).  Returns the CUDA error of the launch (0 when it was
// taken).  rows must be positive: a grid of zero blocks is an error.
int keccak_launch(const uint8_t* data, uint8_t* out, int rows, int len,
                  void* stream) {
  const kc::Batch b = kc::make_batch(data, rows, len);
  const int bytes = 8 * kc::smem_words(b.aligned);
  const int blocks = (rows + kc::kRows - 1) / kc::kRows;
  keccak_kernel<<<blocks, kc::kRows, bytes, (cudaStream_t)stream>>>(
      data, out, rows, len);
  return (int)cudaGetLastError();
}

int keccak_rate_bytes() { return kc::kRate; }

}  // extern "C"

#else  // host C++

#include <vector>

extern "C" {

// The kernel's grid, block after block: between two of the kernel's
// barriers every thread of the block runs in turn, over a local copy of
// the block's shared memory.
int keccak_host(const uint8_t* data, uint8_t* out, int rows, int len) {
  using namespace kc;
  const Batch b = make_batch(data, rows, len);
  std::vector<uint64_t> smem(smem_words(b.aligned));
  std::vector<uint64_t> a(kRows * 25);
  uint64_t* tile = smem.data();
  uint64_t* raw = smem.data() + kTileWords;
  for (int row0 = 0; row0 < rows; row0 += kRows) {
    for (int t = 0; t < kRows; ++t) stage_copy(tile, raw, b, row0, 0, t);
    for (int k = 0;; ++k) {
      if (!b.aligned)
        for (int t = 0; t < kRows; ++t) stage_shift(tile, raw, b, row0, k, t);
      for (int t = 0; t < kRows; ++t) {
        if (k == 0)
          absorb_first(&a[25 * t], tile + t * kRateLanes);
        else
          absorb(&a[25 * t], tile + t * kRateLanes);
        keccak_f(&a[25 * t]);
      }
      if (k + 1 == b.blocks) break;
      for (int t = 0; t < kRows; ++t) stage_copy(tile, raw, b, row0, k + 1, t);
    }
    for (int t = 0; t < kRows && row0 + t < rows; ++t)
      store_digest(&a[25 * t], out + (size_t)(row0 + t) * 32);
  }
  return 0;
}

int keccak_rate_bytes() { return kc::kRate; }

}  // extern "C"

#endif  // __CUDACC__
