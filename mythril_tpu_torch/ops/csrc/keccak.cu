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
// Design: one thread a row.  The 25 lanes of the state sit in registers
// as uint64_t and the 24 rounds are unrolled, so every index and every
// rotation is a constant (a rotation compiles to funnel shifts on the
// 32-bit halves).  A lane of the message is eight byte loads (the row's
// start has no alignment), or one 8-byte load when the row is 8-byte
// aligned; bytes past the row are the padding.  The digest is written as
// four 8-byte stores.
//
// Bound: operations.  A block is 24 rounds of 310 32-bit integer
// operations (on 64-bit lanes: theta's 51 XORs and 5 rotations, rho's 24
// rotations, chi's 25 NOT-ANDs and 25 XORs, iota's XOR; two operations a
// half each, a rotation two funnel shifts) against 136 bytes read.  Neighbouring threads read rows L bytes apart, so the loads are
// not coalesced: a tile of rows staged through shared memory would be.
//
// Compiled as host C++ (no __CUDACC__), the same row function runs one
// row an iteration (keccak_host), so the CPU tests hold the kernel's own
// code against the plain version and the JAX package.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KC_FN __device__ __forceinline__
#else
#define KC_FN inline
#endif

namespace kc {

constexpr int kRate = 136;        // ops/keccak.py:RATE_BYTES
constexpr int kRateLanes = kRate / 8;
constexpr int kThreads = 128;     // rows a block

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
      const uint64_t d = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#ifdef __CUDACC__
#pragma unroll
#endif
      for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
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

// byte p of the padded message of a row of length len (total bytes in
// all, a multiple of kRate)
KC_FN uint64_t padded_byte(const uint8_t* row, int len, int total, int p) {
  uint64_t byte = p < len ? row[p] : 0;
  if (p == len) byte |= 0x01;
  if (p == total - 1) byte |= 0x80;
  return byte;
}

// an 8-byte aligned little-endian load
KC_FN uint64_t load64(const uint8_t* p) {
#ifdef __CUDACC__
  return *reinterpret_cast<const uint64_t*>(p);
#else
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
#endif
}

// the little-endian 64-bit lane at byte off of the padded message
KC_FN uint64_t message_lane(const uint8_t* row, int len, int total, int off,
                            bool aligned) {
  if (off + 8 <= len) {
    if (aligned) return load64(row + off);
    uint64_t lane = 0;
    for (int j = 0; j < 8; ++j) lane |= (uint64_t)row[off + j] << (8 * j);
    return lane;
  }
  uint64_t lane = 0;
  for (int j = 0; j < 8; ++j)
    lane |= padded_byte(row, len, total, off + j) << (8 * j);
  return lane;
}

// the digest of one row into out[0:32]
KC_FN void hash_row(const uint8_t* row, int len, uint8_t* out) {
  uint64_t a[25];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int i = 0; i < 25; ++i) a[i] = 0;
  const int total = len + (kRate - len % kRate);
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 7) == 0;
  for (int block = 0; block < total; block += kRate) {
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int i = 0; i < kRateLanes; ++i)
      a[i] ^= message_lane(row, len, total, block + 8 * i, aligned);
    keccak_f(a);
  }
#ifdef __CUDACC__
  uint64_t* words = reinterpret_cast<uint64_t*>(out);
  for (int i = 0; i < 4; ++i) words[i] = a[i];
#else
  memcpy(out, a, 32);
#endif
}

}  // namespace kc

#ifdef __CUDACC__

__global__ void __launch_bounds__(kc::kThreads)
keccak_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
              int rows, int len) {
  const int row = blockIdx.x * kc::kThreads + threadIdx.x;
  if (row >= rows) return;
  kc::hash_row(data + (size_t)row * len, len, out + (size_t)row * 32);
}

extern "C" {

// One launch over rows x len bytes on `stream`; out holds rows x 32 bytes
// (8-byte aligned).  Returns the CUDA error of the launch (0 when it was
// taken).  rows must be positive: a grid of zero blocks is an error.
int keccak_launch(const uint8_t* data, uint8_t* out, int rows, int len,
                  void* stream) {
  const int blocks = (rows + kc::kThreads - 1) / kc::kThreads;
  keccak_kernel<<<blocks, kc::kThreads, 0, (cudaStream_t)stream>>>(
      data, out, rows, len);
  return (int)cudaGetLastError();
}

int keccak_rate_bytes() { return kc::kRate; }

}  // extern "C"

#else  // host C++

extern "C" {

// The kernel's row function over every row, one row an iteration.
int keccak_host(const uint8_t* data, uint8_t* out, int rows, int len) {
  for (int row = 0; row < rows; ++row)
    kc::hash_row(data + (size_t)row * len, len, out + (size_t)row * 32);
  return 0;
}

int keccak_rate_bytes() { return kc::kRate; }

}  // extern "C"

#endif  // __CUDACC__
