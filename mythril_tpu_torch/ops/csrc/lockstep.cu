// The lockstep concrete EVM, for sm_90a: every lane of a batch run to a
// halt or the step cap in one launch.
//
// Replaces the JAX package's jitted interpreter loop: the lax.while_loop
// of mythril_tpu/ops/lockstep.py:_jit_run (:736-783), the step it runs
// (make_step, :290-716: about 25 opcode groups, each under lax.cond when
// some lane selects it) and, inside that step, the 256-round fori_loops
// of mythril_tpu/ops/u256.py:udivmod (:362-383) and exp (:411-426), with
// sdiv and smod on top.  No Pallas kernel: on a TPU each step is one XLA
// program over the whole batch.
//
// What it computes (the same as the plain PyTorch version,
// ops/lockstep.py:run_plain, bit for bit): the JAX step's semantics, lane
// by lane.  The JAX loop steps every lane while any lane runs; a halted
// lane is never touched again and every handler writes only its own
// lane's rows, so each lane here loops on its own until it halts or has
// taken max_steps steps, and the loop count the JAX package returns is
// the largest of the lanes' step counts.  Kept from the JAX step:
//   - the underflow check runs before dispatch; a pc at or past the code
//     length reads STOP; a push on a full stack is ERROR (the pc moves on);
//   - limb 0 read as int32 wraps (JUMP/JUMPI destinations, CALLDATALOAD
//     offsets, RETURN offset and length);
//   - windows clamp as dynamic_slice does: code and calldata windows to
//     their arena less 32, and CALLDATALOAD masks from the clamped offset;
//   - SLOAD takes the first matching slot, SSTORE the first matching or
//     free one; a full table with a new key parks STORAGE_FULL after
//     popping its operands and writes nothing;
//   - MLOAD and MSTORE park MEM_OOB past 4064, MSTORE8 past 4095, with
//     the packed cause (reason << 8) | opcode;
//   - a lane's visited bit is set before each step it runs, in
//     bucket / 32 + 1 words.
//
// Design.  A lane is a block of one warp.  Its 256-bit arithmetic runs on
// the warp's first 8 threads, a limb a thread, on the primitives of
// word_prop.cu (copied below: ballot carries, compares by ballot,
// shuffled shifts, column multiply).  The kernel reads the EVMState as
// it is (int64 limbs, bool, uint8 and int32 fields) and writes a fresh
// one:
//   - in: one thread issues Hopper bulk copies (cp.async.bulk, on an
//     mbarrier) of the lane's rows, whose global layout is their shared
//     one: the stack, storage keys and values, value and caller (int64
//     limbs, kept as int64), the memory, the calldata, the storage flags
//     and, for a bucket of 4,096 bytes or less, the code and its JUMPDEST
//     bits; meanwhile the warp zeroes the visited words and fills a table
//     of the items each opcode pops;
//   - the step loop makes no global round trip: all it reads and writes
//     is in shared memory (a larger program is read from global memory);
//     a PUSH immediate is two aligned words a thread and a byte permute;
//     PUSH, DUP and SWAP, most steps, go ahead of the opcode switch; the
//     heavy arithmetic (MUL, EXP, the division, the storage lookup) is
//     out of line, which keeps the loop's code small;
//   - out: the limbs and the memory by bulk stores, the storage flags and
//     scalars by the group, the visited words as int64, the loop count by
//     one atomicMax into the wrapper's zeroed int32.
// Division is Knuth's Algorithm D (TAOCP vol. 2, 4.3.1) by 32-bit
// digits, run by each thread of the group on the whole operands in
// registers: the divisor shifted left by whole limbs and bits until its
// top limb has its top bit set, at most eight digit steps, each a 64-bit
// estimate from the top limbs, a multiply and subtract, and an add-back
// when the estimate was one too large; a one-limb divisor uses short
// division.  EXP squares up to the exponent's top set bit, each squaring
// from half the partial products.
//
// Bound: the state is read once and written once (8.3 KB a lane at 32
// bits a limb, the count chip_smoke.py's bound keeps; 12.4 KB as the
// int64 limbs move); the operations are the executed opcodes' 32-bit
// integer work.  At the main path's batches (1 to 64 lanes) a launch is
// latency-bound: one lane's steps are a chain.
//
// Compiled as host C++ (no __CUDACC__), the same lane walk runs on an
// emulated group of 8 threads (lockstep_host), so the CPU tests hold the
// kernel's own step and division code against the plain version;
// lockstep_host_binop runs one binary opcode of the kernel on operand
// pairs and counts the division's add-back steps.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LS_FN __device__ __forceinline__
// the heavy arithmetic, kept out of line so that the step loop's code
// stays small
#define LS_COLD __device__ __noinline__
#define LS_HD __host__ __device__ inline
#else
#include <vector>
#define LS_FN inline
#define LS_COLD inline
#define LS_HD inline
#endif

namespace ls {

constexpr int kStack = 64;       // ops/lockstep.py:STACK_SLOTS
constexpr int kMemory = 4096;    // MEMORY_BYTES
constexpr int kSlots = 32;       // STORAGE_SLOTS
constexpr int kLimbs = 8;
constexpr int kThreads = 32;     // a block: one warp, the group its first 8
// a limb of the stack, storage, value or caller in shared memory: the
// state's own int64 (the low 32 bits used), so that those rows move by
// bulk copies as they are
typedef uint64_t Limb;

enum Halt : int { RUNNING = 0, STOPPED, RETURNED, REVERTED, ERROR, NEEDS_HOST };
enum Cause : int { CAUSE_MEM_OOB = 1, CAUSE_STORAGE_FULL = 2, CAUSE_UNSUPPORTED = 3 };

// ------------------------------------------------------------ the group
// (word_prop.cu's group.)  U: this thread's limb of a 256-bit word; M: a
// predicate a thread.  On the card a thread holds one of each; the host
// build holds the whole group's eight and runs them in step.

#ifdef __CUDACC__

typedef uint32_t U;
typedef bool M;

// the group is the block's first 8 threads
LS_FN U limb_id() { return threadIdx.x & 7u; }
LS_FN unsigned group_mask() { return 0xFFu; }
LS_FN U splat(uint32_t x) { return x; }
LS_FN U sel(M p, U a, U b) { return p ? a : b; }
LS_FN unsigned ballot(M p) { return __ballot_sync(0xFFu, p); }
LS_FN U shfl(U x, U src) { return __shfl_sync(group_mask(), x, (int)src, 8); }
LS_FN U shfl_up(U x, int d) { return __shfl_up_sync(group_mask(), x, d, 8); }
LS_FN uint32_t max_of(U x) { return __reduce_max_sync(group_mask(), x); }
LS_FN uint32_t and_of(U x) { return __reduce_and_sync(group_mask(), x); }
LS_FN U clz(U x) { return (U)__clz((int)x); }
LS_FN U mul_hi(U a, U b) { return __umulhi(a, b); }
LS_FN int ffs32(uint32_t x) { return __ffs((int)x); }
LS_FN uint32_t uniform(U x) { return x; }
LS_FN void sync_group() { __syncwarp(group_mask()); }
LS_FN bool group_leader() { return (threadIdx.x & 7u) == 0; }
// limb i of the group's word: a statement for this thread's limb
#define LS_EACH(i, stmt) { const int i = (int)limb_id(); stmt; }
#define LIMB(x, i) (x)
// a read of the program (code, JUMPDEST bits): shared memory when
// staged, else global
#define LS_LDG(x) (x)
LS_FN uint32_t byte_perm(uint32_t lo, uint32_t hi, uint32_t s) {
  return __byte_perm(lo, hi, s);
}
LS_FN uint32_t clz32(uint32_t x) { return (uint32_t)__clz((int)x); }
// (hi:lo << s) >> 32 and (hi:lo >> s) mod 2^32, s in [0, 31]
LS_FN uint32_t fsl(uint32_t lo, uint32_t hi, int s) { return __funnelshift_l(lo, hi, s); }
LS_FN uint32_t fsr(uint32_t lo, uint32_t hi, int s) { return __funnelshift_r(lo, hi, s); }
// the group's word as eight limbs in each of its threads, and back
LS_FN void words_of(U x, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = __shfl_sync(group_mask(), x, k, 8);
}
LS_FN U word_from(const uint32_t* w) {
  U r = w[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) r = limb_id() == (uint32_t)k ? w[k] : r;
  return r;
}
#define LS_HOST_COUNT(counter)

#else  // host: an emulated group of 8 threads

struct M {
  bool v[8];
};
struct U {
  uint32_t v[8];
};
#define LS_MAP(expr)                      \
  U r;                                    \
  for (int i = 0; i < 8; ++i) r.v[i] = (expr); \
  return r
#define LS_PRED(expr)                     \
  M r;                                    \
  for (int i = 0; i < 8; ++i) r.v[i] = (expr); \
  return r
inline U operator&(U a, U b) { LS_MAP(a.v[i] & b.v[i]); }
inline U operator|(U a, U b) { LS_MAP(a.v[i] | b.v[i]); }
inline U operator^(U a, U b) { LS_MAP(a.v[i] ^ b.v[i]); }
inline U operator+(U a, U b) { LS_MAP(a.v[i] + b.v[i]); }
inline U operator-(U a, U b) { LS_MAP(a.v[i] - b.v[i]); }
inline U operator*(U a, U b) { LS_MAP(a.v[i] * b.v[i]); }
inline U operator&(U a, uint32_t b) { LS_MAP(a.v[i] & b); }
inline U operator+(U a, uint32_t b) { LS_MAP(a.v[i] + b); }
inline U operator-(U a, uint32_t b) { LS_MAP(a.v[i] - b); }
inline U operator~(U a) { LS_MAP(~a.v[i]); }
// shifts as the card's shl / shr: an amount of 32 or more gives 0
inline uint32_t host_shl(uint32_t x, uint32_t s) { return s >= 32 ? 0u : x << s; }
inline uint32_t host_shr(uint32_t x, uint32_t s) { return s >= 32 ? 0u : x >> s; }
inline U operator<<(U a, U s) { LS_MAP(host_shl(a.v[i], s.v[i])); }
inline U operator>>(U a, U s) { LS_MAP(host_shr(a.v[i], s.v[i])); }
inline U operator<<(U a, uint32_t s) { LS_MAP(host_shl(a.v[i], s)); }
inline U operator>>(U a, uint32_t s) { LS_MAP(host_shr(a.v[i], s)); }
inline M operator<(U a, U b) { LS_PRED(a.v[i] < b.v[i]); }
inline M operator==(U a, U b) { LS_PRED(a.v[i] == b.v[i]); }
inline M operator!=(U a, U b) { LS_PRED(a.v[i] != b.v[i]); }
inline M operator<(U a, uint32_t b) { LS_PRED(a.v[i] < b); }
inline M operator>=(U a, uint32_t b) { LS_PRED(a.v[i] >= b); }
inline M operator==(U a, uint32_t b) { LS_PRED(a.v[i] == b); }
inline M operator!=(U a, uint32_t b) { LS_PRED(a.v[i] != b); }

// set when a value that should be uniform across the group is not
inline int& host_fault() {
  static thread_local int fault = 0;
  return fault;
}
// the division's add-back steps since the last reset
inline long& host_addbacks() {
  static thread_local long count = 0;
  return count;
}
inline U limb_id() { LS_MAP((uint32_t)i); }
inline U splat(uint32_t x) { LS_MAP(x); }
inline U sel(M p, U a, U b) { LS_MAP(p.v[i] ? a.v[i] : b.v[i]); }
inline unsigned ballot(M p) {
  unsigned r = 0;
  for (int i = 0; i < 8; ++i) r |= (unsigned)p.v[i] << i;
  return r;
}
inline U shfl(U x, U src) { LS_MAP(x.v[src.v[i] & 7u]); }
inline U shfl_up(U x, int d) { LS_MAP(i >= d ? x.v[i - d] : x.v[i]); }
inline uint32_t max_of(U x) {
  uint32_t m = 0;
  for (int i = 0; i < 8; ++i) m = x.v[i] > m ? x.v[i] : m;
  return m;
}
inline uint32_t and_of(U x) {
  uint32_t m = 0xFFFFFFFFu;
  for (int i = 0; i < 8; ++i) m &= x.v[i];
  return m;
}
inline U clz(U x) { LS_MAP(x.v[i] ? (uint32_t)__builtin_clz(x.v[i]) : 32u); }
inline U mul_hi(U a, U b) { LS_MAP((uint32_t)(((uint64_t)a.v[i] * b.v[i]) >> 32)); }
inline int ffs32(uint32_t x) { return __builtin_ffs((int)x); }
inline uint32_t uniform(U x) {
  for (int i = 1; i < 8; ++i)
    if (x.v[i] != x.v[0]) host_fault() = 1;
  return x.v[0];
}
inline void sync_group() {}
inline bool group_leader() { return true; }
#define LS_EACH(i, stmt) for (int i = 0; i < 8; ++i) { stmt; }
#define LIMB(x, i) ((x).v[i])
#define LS_LDG(x) (x)
// the card's __byte_perm: byte k of the result is byte (s >> 4k) & 7 of
// hi:lo
inline uint32_t byte_perm(uint32_t lo, uint32_t hi, uint32_t s) {
  const uint64_t x = ((uint64_t)hi << 32) | lo;
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) r |= (uint32_t)((x >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k);
  return r;
}
inline uint32_t clz32(uint32_t x) { return x ? (uint32_t)__builtin_clz(x) : 32u; }
inline uint32_t fsl(uint32_t lo, uint32_t hi, int s) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << s) >> 32);
}
inline uint32_t fsr(uint32_t lo, uint32_t hi, int s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> s);
}
inline void words_of(U x, uint32_t* w) {
  for (int k = 0; k < 8; ++k) w[k] = x.v[k];
}
inline U word_from(const uint32_t* w) { LS_MAP(w[i]); }
#define LS_HOST_COUNT(counter) ++(counter)
#undef LS_MAP
#undef LS_PRED

#endif  // __CUDACC__

// ---------------------------------------------------------------- u256
// (word_prop.cu's, and the lockstep's own: signed compare, arithmetic
// shift, division, remainder and exponent)

LS_FN U u_zero() { return splat(0u); }
LS_FN U u_ones() { return splat(0xFFFFFFFFu); }
LS_FN U u_one() { return sel(limb_id() == 0u, splat(1u), splat(0u)); }
LS_FN U u_flag(bool f) { return sel(limb_id() == 0u, splat(f ? 1u : 0u), splat(0u)); }
LS_FN bool u_any(U a) { return ballot(a != 0u) != 0; }
LS_FN bool u_eq(U a, U b) { return ballot(a != b) == 0; }
// the highest differing limb decides
LS_FN bool u_ult(U a, U b) { return ballot(a < b) > ballot(b < a); }
LS_FN bool u_sign(U a) { return (ballot((a >> 31u) != 0u) >> 7) & 1u; }
LS_FN bool u_slt(U a, U b) {
  bool sa = u_sign(a), sb = u_sign(b);
  return sa == sb ? u_ult(a, b) : sa;
}
// limb 0, the same in every thread
LS_FN uint32_t u_limb0(U a) { return uniform(shfl(a, u_zero())); }
// any limb above limb 0 set
LS_FN bool u_high(U a) { return (ballot(a != 0u) & 0xFEu) != 0; }
// the carry into each limb (bit i) and out of the top (bit 8), from the
// limbs that generate one and those that pass one on: the carries of
// (g | p) + g
LS_FN unsigned carries(unsigned g, unsigned p) {
  unsigned x = g | p;
  return (x + g) ^ x ^ g;
}
LS_FN U u_add(U a, U b) {
  U s = a + b;
  unsigned c = carries(ballot(s < a), ballot(s == 0xFFFFFFFFu));
  return s + ((splat(c) >> limb_id()) & 1u);
}
LS_FN U u_sub(U a, U b) {
  U d = a - b;
  unsigned c = carries(ballot(a < b), ballot(d == 0u));
  return d - ((splat(c) >> limb_id()) & 1u);
}
LS_FN U u_neg(U a) { return u_sub(u_zero(), a); }
// A thread's column of a product: the sums of its partial products' low
// and high halves (lo, hi) and the carries out of each (c_lo, c_hi); the
// column is lo + 2^32 (c_lo + hi) + 2^64 c_hi.
struct Column {
  U lo, hi, c_lo, c_hi;
};
LS_FN void add_product(Column& c, M on, U x, U y) {
  U p_lo = sel(on, x * y, u_zero());
  U p_hi = sel(on, mul_hi(x, y), u_zero());
  c.lo = c.lo + p_lo;
  c.c_lo = c.c_lo + sel(c.lo < p_lo, splat(1u), u_zero());
  c.hi = c.hi + p_hi;
  c.c_hi = c.c_hi + sel(c.hi < p_hi, splat(1u), u_zero());
}
// the word of the columns (column i at limb i), mod 2^256
LS_FN U columns_word(const Column& c) {
  U i = limb_id();
  U up1 = sel(i >= 1u, shfl_up(c.hi, 1), u_zero());
  U small = sel(i >= 1u, shfl_up(c.c_lo, 1), u_zero()) +
            sel(i >= 2u, shfl_up(c.c_hi, 2), u_zero());
  return u_add(u_add(c.lo, up1), small);
}
// a * b mod 2^256: each thread sums its column
LS_FN U mul_columns(U a, U b) {
  Column c{u_zero(), u_zero(), u_zero(), u_zero()};
  U i = limb_id();
  for (uint32_t j = 0; j < 8; ++j)
    add_product(c, i >= j, shfl(a, splat(j)), shfl(b, (i - j) & 7u));
  return columns_word(c);
}
LS_COLD U u_mul(U a, U b) { return mul_columns(a, b); }
// a * a mod 2^256 from half the partial products: column i sums a_j a_{i-j}
// once for each j < i - j, doubles the sum, and adds a_{i/2}^2 when i is
// even
LS_FN U sqr_columns(U a) {
  Column c{u_zero(), u_zero(), u_zero(), u_zero()};
  U i = limb_id();
  for (uint32_t j = 0; j < 4; ++j)
    add_product(c, splat(2u * j) < i, shfl(a, splat(j)), shfl(a, (i - j) & 7u));
  c.c_lo = (c.c_lo << 1u) + (c.lo >> 31u);
  c.lo = c.lo << 1u;
  c.c_hi = (c.c_hi << 1u) + (c.hi >> 31u);
  c.hi = c.hi << 1u;
  U d = shfl(a, i >> 1u);
  add_product(c, (i & 1u) == 0u, d, d);
  return columns_word(c);
}
// shifts by an amount >= 0; 256 and more give 0 (or the sign fill)
LS_FN U u_shift_right(U a, int amt, U fill) {
  if (amt >= 256) return fill;
  uint32_t word = (uint32_t)amt >> 5, bit = (uint32_t)amt & 31u;
  U i = limb_id();
  U x = sel(i + word < 8u, shfl(a, (i + word) & 7u), fill);
  U y = sel(i + word + 1u < 8u, shfl(a, (i + word + 1u) & 7u), fill);
  return bit ? (x >> bit) | (y << (32u - bit)) : x;
}
LS_FN U u_lshr(U a, int amt) { return u_shift_right(a, amt, u_zero()); }
LS_FN U u_sar(U a, int amt) {
  return u_shift_right(a, amt, u_sign(a) ? u_ones() : u_zero());
}
LS_FN U u_shl(U a, int amt) {
  if (amt >= 256) return u_zero();
  uint32_t word = (uint32_t)amt >> 5, bit = (uint32_t)amt & 31u;
  U i = limb_id();
  U x = sel(i >= word, shfl(a, (i - word) & 7u), u_zero());
  U y = sel(i >= word + 1u, shfl(a, (i - word - 1u) & 7u), u_zero());
  return bit ? (x << bit) | (y >> (32u - bit)) : x;
}
// the largest of the limbs' own bit lengths
LS_FN int u_bit_length(U x) {
  return (int)max_of(sel(x != 0u, (limb_id() << 5u) + 32u - clz(x), u_zero()));
}
// a shift amount from a word: any high limb makes it 257, the overflow
// representative
LS_FN int amount_of(U a) {
  if (u_high(a)) return 257;
  uint32_t a0 = u_limb0(a);
  return a0 > 257u ? 257 : (int)a0;
}

// x <<= 32 k limbs (k in [0, 7]) over N limbs, as three conditional moves
// so that every index stays a constant
template <int N>
LS_FN void shl_limbs(uint32_t* x, int k) {
#pragma unroll
  for (int step = 1; step < 8; step <<= 1) {
    if (k & step) {
#pragma unroll
      for (int i = N - 1; i >= 0; --i) x[i] = i >= step ? x[i - step] : 0u;
    }
  }
}
template <int N>
LS_FN void shr_limbs(uint32_t* x, int k) {
#pragma unroll
  for (int step = 1; step < 8; step <<= 1) {
    if (k & step) {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = i + step < N ? x[i + step] : 0u;
    }
  }
}

// (a / b, a % b) of eight-limb words, b != 0: Knuth's Algorithm D by
// 32-bit digits.  b is shifted left by 8 - n whole limbs (n: its
// significant limbs) and s bits, so that v[7] >= 2^31, and a by the same
// into u[0..16]; the quotient's digit j comes from the window u[j..j+8]
// (j from 7 down: digit 8 is 0, the quotient being below 2^256).  The
// remainder is u[0..7] shifted back.
LS_FN void divmod_words(const uint32_t* a, const uint32_t* b, uint32_t* q,
                        uint32_t* r) {
  int n = 0;
  uint32_t btop = 0;  // b's top significant limb
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    n = b[i] ? i + 1 : n;
    btop = b[i] ? b[i] : btop;
  }
  if (n == 1) {  // short division
    const uint32_t d = b[0];
    uint32_t rem = 0;
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      if (rem == 0) {
        q[i] = a[i] / d;
        rem = a[i] - q[i] * d;
      } else {
        const uint64_t cur = ((uint64_t)rem << 32) | a[i];
        const uint64_t qq = cur / d;
        q[i] = (uint32_t)qq;
        rem = (uint32_t)(cur - qq * d);
      }
      r[i] = 0;
    }
    r[0] = rem;
    return;
  }
  uint32_t v[8], u[17];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = b[i];
    u[i] = a[i];
    u[i + 8] = 0;
  }
  u[16] = 0;
  const int limbs = 8 - n, s = (int)clz32(btop);
  shl_limbs<8>(v, limbs);
  shl_limbs<17>(u, limbs);
#pragma unroll
  for (int i = 16; i > 0; --i) u[i] = fsl(u[i - 1], u[i], s);
  u[0] <<= s;
#pragma unroll
  for (int i = 7; i > 0; --i) v[i] = fsl(v[i - 1], v[i], s);
  v[0] <<= s;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    const uint32_t top = u[j + 8], next = u[j + 7];
    if (top == 0 && next < v[7]) {  // the digit is 0
      q[j] = 0;
      continue;
    }
    const uint64_t num = ((uint64_t)top << 32) | next;
    uint64_t qhat = num / v[7], rhat = num - qhat * v[7];
    while ((qhat >> 32) || qhat * v[6] > ((rhat << 32) | u[j + 6])) {
      --qhat;
      rhat += v[7];
      if (rhat >> 32) break;
    }
    // u[j..j+8] -= qhat * v
    uint64_t carry = 0;
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint64_t p = qhat * v[i] + carry;
      carry = p >> 32;
      const uint64_t t = (uint64_t)u[i + j] - (uint32_t)p - borrow;
      u[i + j] = (uint32_t)t;
      borrow = (uint32_t)(t >> 63);
    }
    const uint64_t t = (uint64_t)u[j + 8] - carry - borrow;
    u[j + 8] = (uint32_t)t;
    if (t >> 63) {  // the estimate was one too large: add v back
      LS_HOST_COUNT(host_addbacks());
      --qhat;
      uint64_t c = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint64_t sum = (uint64_t)u[i + j] + v[i] + c;
        u[i + j] = (uint32_t)sum;
        c = sum >> 32;
      }
      u[j + 8] += (uint32_t)c;
    }
    q[j] = (uint32_t)qhat;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = fsr(u[i], u[i + 1], s);
  shr_limbs<8>(r, limbs);
}
struct QR {
  U q, r;
};
// (a / b, a % b), both 0 when b is 0 (the EVM's rule): every thread of
// the group divides the whole words and keeps its own limbs
LS_COLD QR u_udivmod(U a, U b) {
  if (!u_any(b)) return QR{u_zero(), u_zero()};
  uint32_t aw[8], bw[8], qw[8], rw[8];
  words_of(a, aw);
  words_of(b, bw);
  divmod_words(aw, bw, qw, rw);
  return QR{word_from(qw), word_from(rw)};
}
LS_FN U u_abs(U a, bool* negative) {
  *negative = u_sign(a);
  return *negative ? u_neg(a) : a;
}
// EVM SDIV: truncated; x/0 = 0; MIN / -1 wraps to MIN
LS_FN U u_sdiv(U a, U b) {
  bool na, nb;
  const U q = u_udivmod(u_abs(a, &na), u_abs(b, &nb)).q;
  return na != nb ? u_neg(q) : q;
}
// EVM SMOD: the dividend's sign; x%0 = 0
LS_FN U u_smod(U a, U b) {
  bool na, nb;
  const U r = u_udivmod(u_abs(a, &na), u_abs(b, &nb)).r;
  return na ? u_neg(r) : r;
}
// a ** e mod 2^256, square-and-multiply up to e's top set bit, the
// exponent read a limb at a time (its products inline, the squarings by
// sqr_columns)
LS_COLD U u_exp(U a, U e) {
  U result = u_one(), base = a;
  const int top = u_bit_length(e);
  for (int k = 0; 32 * k < top; ++k) {
    uint32_t w = uniform(shfl(e, splat((uint32_t)k)));
    for (int i = 32 * k; i < top && i < 32 * k + 32; ++i, w >>= 1) {
      if (w & 1u) result = mul_columns(result, base);
      if (i + 1 < top) base = sqr_columns(base);
    }
  }
  return result;
}

// ---------------------------------------------------------------- words
// a word at w[0..7] (limb i at w[i]); each thread its own limb
LS_FN U ld_word(const Limb* w) {
  U r = u_zero();
  LS_EACH(i, LIMB(r, i) = (uint32_t)w[i]);
  return r;
}
LS_FN void st_word(Limb* w, U x) { LS_EACH(i, w[i] = LIMB(x, i)); }
// the byte permute that reads the four bytes at byte s of hi:lo big-endian
LS_FN uint32_t be_selector(int s) {
  return (uint32_t)((s + 3) | (s + 2) << 4 | (s + 1) << 8 | s << 12);
}
// 32 big-endian bytes at p[off..off+31] of a word-aligned buffer (each
// limb two aligned words and a byte permute); bytes at or past `limit`
// read 0.  The window lies inside the buffer.
LS_FN U bytes_word(const uint8_t* p, int off, int limit) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
  const int s = off & 3;
  U r = u_zero();
  LS_EACH(i, {
    const int b = off + 28 - 4 * i;
    const uint32_t x = byte_perm(w[b >> 2], s ? w[(b >> 2) + 1] : 0u, be_selector(s));
    const int valid = limit - b;
    LIMB(r, i) = valid >= 4 ? x : (valid <= 0 ? 0u : x & (0xFFFFFFFFu << (8 * (4 - valid))));
  });
  return r;
}
LS_FN void store_bytes(uint8_t* p, int off, U x) {
  LS_EACH(i, {
    const int b = off + 28 - 4 * i;
    const uint32_t v = LIMB(x, i);
    if ((off & 3) == 0) {
      reinterpret_cast<uint32_t*>(p)[b >> 2] = byte_perm(v, 0u, 0x0123u);
    } else {
      p[b] = (uint8_t)(v >> 24);
      p[b + 1] = (uint8_t)(v >> 16);
      p[b + 2] = (uint8_t)(v >> 8);
      p[b + 3] = (uint8_t)v;
    }
  });
}

LS_FN int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// stack items popped per opcode (ops/lockstep.py:_POPS_TABLE): DUPn n,
// SWAPn n + 1, RETURN and REVERT 2, below 0x80 two bitmaps
LS_FN int pops(int op) {
  if (op >= 0x80) {
    if (op < 0x90) return op - 0x80 + 1;
    if (op < 0xA0) return op - 0x90 + 2;
    return op == 0xF3 || op == 0xFD ? 2 : 0;
  }
  const uint64_t two = op < 64 ? 0x39df04feull : 0xac0000ull;
  const uint64_t one = op < 64 ? 0x20000002200000ull : 0x530000ull;
  const int bit = op & 63;
  return ((two >> bit) & 1) ? 2 : (int)((one >> bit) & 1);
}

struct Prog {
  const uint8_t* code;       // [bucket + 16], zero past the code
  const uint32_t* jumpdest;  // [bucket / 32]: bit p of word p >> 5
  int code_len, bucket;
};

LS_FN int code_byte(const Prog& P, int pc) {
  return pc >= P.code_len ? 0 : LS_LDG(P.code[clampi(pc, 0, P.bucket - 1)]);
}
// the PUSH window: 32 big-endian bytes at code[off..off+31]
LS_FN U code_word(const Prog& P, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(P.code);
  const int s = off & 3;
  U r = u_zero();
  LS_EACH(i, {
    const int b = off + 28 - 4 * i;
    LIMB(r, i) = byte_perm(LS_LDG(w[b >> 2]), s ? LS_LDG(w[(b >> 2) + 1]) : 0u,
                           be_selector(s));
  });
  return r;
}
LS_FN bool is_jumpdest(const Prog& P, int dest) {
  const int d = clampi(dest, 0, P.bucket - 1);
  return (LS_LDG(P.jumpdest[d >> 5]) >> (d & 31)) & 1u;
}

// One lane: its stack, memory, storage, calldata, value, caller and
// visited words (shared memory on the card), and its scalars (the same
// in every thread).
struct Lane {
  Limb* stack;               // [kStack][8]
  uint8_t* mem;              // [kMemory]
  Limb* skeys;               // [kSlots][8]
  Limb* svals;               // [kSlots][8]
  const uint8_t* calldata;   // [C]
  int C, cdsize;
  const Limb* callvalue;     // [8]
  const Limb* caller;        // [8]
  uint32_t* visited;         // [words]
  int words;                 // 0: not recorded
  const uint8_t* pops;       // [256]: the items each opcode pops
  int sp, pc, halt, cause, ret_off, ret_len, steps;
  uint32_t used;             // bit k: storage slot k in use
};

LS_FN Limb* slot(Lane& L, int idx) { return L.stack + clampi(idx, 0, kStack - 1) * kLimbs; }
LS_FN U peek(Lane& L, int depth) { return ld_word(slot(L, L.sp - 1 - depth)); }

LS_FN void park(Lane& L, int op, int reason) {
  L.halt = NEEDS_HOST;
  L.cause = (reason << 8) | op;
}

// push (a full stack is ERROR; the pc moves on either way)
LS_FN void push(Lane& L, U value, int next_pc) {
  if (L.sp >= kStack) {
    L.halt = ERROR;
  } else {
    st_word(slot(L, L.sp), value);
    L.sp += 1;
  }
  L.pc = next_pc;
}

LS_FN bool jump_valid(const Prog& P, U dest_word, int* dest) {
  *dest = (int)u_limb0(dest_word);  // int32 wrap
  return !u_high(dest_word) && *dest >= 0 && *dest < P.code_len &&
         is_jumpdest(P, *dest);
}

// the first used slot whose key equals `key`, or -1: each thread marks
// the keys whose limb matches its own, the group ANDs the marks
LS_COLD int find_slot(const Limb* skeys, uint32_t used, U key) {
  U hits = u_zero();
#pragma unroll 8
  for (int k = 0; k < kSlots; ++k)
    hits = hits | sel(ld_word(skeys + k * kLimbs) == key, splat(1u << k), u_zero());
  const uint32_t found = and_of(hits) & used;
  return found ? ffs32(found) - 1 : -1;
}

LS_FN U binop(int op, U a, U b) {
  switch (op) {
    case 0x01: return u_add(a, b);
    case 0x02: return u_mul(a, b);
    case 0x03: return u_sub(a, b);
    case 0x04: return u_udivmod(a, b).q;
    case 0x05: return u_sdiv(a, b);
    case 0x06: return u_udivmod(a, b).r;
    case 0x07: return u_smod(a, b);
    case 0x0A: return u_exp(a, b);
    case 0x10: return u_flag(u_ult(a, b));
    case 0x11: return u_flag(u_ult(b, a));
    case 0x12: return u_flag(u_slt(a, b));
    case 0x13: return u_flag(u_slt(b, a));
    case 0x14: return u_flag(u_eq(a, b));
    case 0x16: return a & b;
    case 0x17: return a | b;
    case 0x18: return a ^ b;
    case 0x1B: return u_shl(b, amount_of(a));  // a: the amount, b: the value
    case 0x1C: return u_lshr(b, amount_of(a));
    default: return u_sar(b, amount_of(a));    // 0x1D
  }
}

// one step of a running lane whose operands passed the underflow check
LS_FN void step(Lane& L, const Prog& P, int op) {
  if (op >= 0x5F && op <= 0x9F) {  // most steps: ahead of the switch
    if (op <= 0x7F) {  // PUSH0..PUSH32
      const int n = op - 0x5F;
      U word = code_word(P, clampi(L.pc + 1, 0, P.bucket - 32));
      push(L, u_lshr(word, (32 - n) * 8), L.pc + 1 + n);
    } else if (op <= 0x8F) {  // DUP1..DUP16
      push(L, peek(L, op - 0x80), L.pc + 1);
    } else {  // SWAP1..SWAP16
      const int k = op - 0x8F;
      U top = peek(L, 0), deep = peek(L, k);
      st_word(slot(L, L.sp - 1), deep);
      st_word(slot(L, L.sp - 1 - k), top);
      L.pc += 1;
    }
    return;
  }
  switch (op) {
    case 0x00:
      L.halt = STOPPED;
      return;
    case 0x01: case 0x02: case 0x03: case 0x04: case 0x05: case 0x06:
    case 0x07: case 0x0A: case 0x10: case 0x11: case 0x12: case 0x13:
    case 0x14: case 0x16: case 0x17: case 0x18: case 0x1B: case 0x1C:
    case 0x1D: {
      U r = binop(op, peek(L, 0), peek(L, 1));
      st_word(slot(L, L.sp - 2), r);
      L.sp -= 1;
      L.pc += 1;
      return;
    }
    case 0x15: case 0x19: {
      U a = peek(L, 0);
      st_word(slot(L, L.sp - 1), op == 0x15 ? u_flag(!u_any(a)) : ~a);
      L.pc += 1;
      return;
    }
    case 0x50:
      L.sp -= 1;
      L.pc += 1;
      return;
    case 0x51: case 0x52: case 0x53: {  // MLOAD, MSTORE, MSTORE8
      U w = peek(L, 0);
      const uint32_t limit = op == 0x53 ? kMemory - 1 : kMemory - 32;
      if (u_high(w) || u_limb0(w) > limit) {
        park(L, op, CAUSE_MEM_OOB);
        return;
      }
      const int off = (int)u_limb0(w);
      if (op == 0x51) {
        st_word(slot(L, L.sp - 1), bytes_word(L.mem, off, kMemory));
      } else {
        U v = peek(L, 1);
        if (op == 0x52) {
          store_bytes(L.mem, off, v);
        } else {
          const uint32_t byte = u_limb0(v) & 0xFFu;
          if (group_leader()) L.mem[off] = (uint8_t)byte;
        }
        sync_group();
        L.sp -= 2;
      }
      L.pc += 1;
      return;
    }
    case 0x54: {  // SLOAD
      const int k = find_slot(L.skeys, L.used, peek(L, 0));
      st_word(slot(L, L.sp - 1), k >= 0 ? ld_word(L.svals + k * kLimbs) : u_zero());
      L.pc += 1;
      return;
    }
    case 0x55: {  // SSTORE
      U key = peek(L, 0), value = peek(L, 1);
      int k = find_slot(L.skeys, L.used, key);
      const bool full = k < 0 && L.used == 0xFFFFFFFFu;
      if (k < 0 && !full) k = ffs32(~L.used) - 1;  // the first free slot
      if (!full) {
        st_word(L.skeys + k * kLimbs, key);
        st_word(L.svals + k * kLimbs, value);
        L.used |= 1u << k;
      }
      L.sp -= 2;
      L.pc += 1;
      if (full) park(L, op, CAUSE_STORAGE_FULL);
      return;
    }
    case 0x56: {  // JUMP
      int dest;
      const bool valid = jump_valid(P, peek(L, 0), &dest);
      L.sp -= 1;
      if (valid) L.pc = dest;
      else L.halt = ERROR;
      return;
    }
    case 0x57: {  // JUMPI
      int dest;
      const bool valid = jump_valid(P, peek(L, 0), &dest);
      const bool taken = u_any(peek(L, 1));
      L.sp -= 2;
      L.pc = taken && valid ? dest : L.pc + 1;
      if (taken && !valid) L.halt = ERROR;
      return;
    }
    case 0x58:  // PC
      push(L, sel(limb_id() == 0u, splat((uint32_t)L.pc), u_zero()), L.pc + 1);
      return;
    case 0x5B:
      L.pc += 1;
      return;
    case 0x33:
      push(L, ld_word(L.caller), L.pc + 1);
      return;
    case 0x34:
      push(L, ld_word(L.callvalue), L.pc + 1);
      return;
    case 0x36:
      push(L, sel(limb_id() == 0u, splat((uint32_t)L.cdsize), u_zero()), L.pc + 1);
      return;
    case 0x35: {  // CALLDATALOAD: a read at or past the size is zero
      U w = peek(L, 0);
      const uint32_t l0 = u_limb0(w);
      const bool beyond = u_high(w) || l0 >= (uint32_t)L.cdsize;
      const int off = clampi((int)l0, 0, L.C - 32);
      st_word(slot(L, L.sp - 1), beyond ? u_zero() : bytes_word(L.calldata, off, L.cdsize));
      L.pc += 1;
      return;
    }
    case 0xF3: case 0xFD:
      L.ret_off = (int)u_limb0(peek(L, 0));
      L.ret_len = (int)u_limb0(peek(L, 1));
      L.halt = op == 0xF3 ? RETURNED : REVERTED;
      return;
    default:
      park(L, op, CAUSE_UNSUPPORTED);
      return;
  }
}

// the lane until it halts or has taken max_steps steps (the opcode read
// ahead of the visited bit's store, which it need not wait for)
LS_FN void run_lane(Lane& L, const Prog& P, int max_steps) {
  while (L.halt == RUNNING && L.steps < max_steps) {
    const int op = code_byte(P, L.pc);
    if (L.words && group_leader())
      L.visited[clampi(L.pc >> 5, 0, L.words - 1)] |= 1u << (L.pc & 31);
    L.steps += 1;
    if (L.sp < L.pops[op]) {
      L.halt = ERROR;
      continue;
    }
    step(L, P, op);
  }
}

// The batch in the EVMState's own layout (ops/lockstep.py:EVMState):
// limbs int64 (the low 32 bits used), sused bool, memory and calldata
// uint8, scalars int32; one row a lane.  The kernel reads `in` and
// writes `out`, whose calldata, size, value and caller are the input's.
struct State {
  const int64_t* stack;      // [B][kStack][8]
  const int* sp;
  const int* pc;
  const uint8_t* memory;     // [B][kMemory]
  const int64_t* skeys;      // [B][kSlots][8]
  const int64_t* svals;
  const uint8_t* sused;      // [B][kSlots] (bool)
  const uint8_t* calldata;   // [B][C]
  const int* calldatasize;
  const int64_t* callvalue;  // [B][8]
  const int64_t* caller;
  const int* halt;
  const int* ret_off;
  const int* ret_len;
  const int* cause;
};
struct Out {
  int64_t* stack;
  int* sp;
  int* pc;
  uint8_t* memory;
  int64_t* skeys;
  int64_t* svals;
  uint8_t* sused;
  int* halt;
  int* ret_off;
  int* ret_len;
  int* cause;
  int64_t* visited;              // [B][max(words, 1)]
  int* count;                    // [1], zeroed: max over lanes of steps
};

// the lane's scalars from the batch (the visited words, the stack,
// storage and memory are staged by the caller)
LS_FN void open_lane(Lane& L, const State& in, int lane, int C, int words) {
  L.C = C;
  L.cdsize = in.calldatasize[lane];
  L.words = words;
  L.sp = in.sp[lane];
  L.pc = in.pc[lane];
  L.halt = in.halt[lane];
  L.cause = in.cause[lane];
  L.ret_off = in.ret_off[lane];
  L.ret_len = in.ret_len[lane];
  L.steps = 0;
}

// the lane's scalars and the storage flags into the batch
LS_FN void close_lane(const Lane& L, const Out& out, int lane) {
  out.sp[lane] = L.sp;
  out.pc[lane] = L.pc;
  out.halt[lane] = L.halt;
  out.cause[lane] = L.cause;
  out.ret_off[lane] = L.ret_off;
  out.ret_len[lane] = L.ret_len;
}

// A program of a bucket up to this many bytes is staged in shared memory
// with the state (its code and JUMPDEST bits); a larger one is read from
// global memory.
constexpr int kStagedBucket = 4096;
LS_HD bool stages_code(int bucket) { return bucket <= kStagedBucket; }

// shared memory a block: the bulk copies' mbarrier, the pops table, the
// stack, keys and values, value and caller (int64 limbs, as the state
// holds them), the storage flags, the memory, the calldata, the visited
// words (a multiple of 16 bytes) and, when staged, the code and its
// JUMPDEST bits
LS_HD int visited_words(int words) { return ((words > 0 ? words : 1) + 3) & ~3; }
constexpr int kLimbBytes =
    (int)sizeof(Limb) * (kStack * kLimbs + 2 * kSlots * kLimbs + 2 * kLimbs);
LS_HD int smem_bytes(int C, int words, int bucket) {
  return 16 + 256 + kLimbBytes + kSlots + kMemory + C + 4 * visited_words(words) +
         (stages_code(bucket) ? bucket + bucket / 8 : 0);
}

}  // namespace ls

extern "C" {

// The arenas the source is built for: stack slots, memory bytes, storage
// slots (ops/lockstep.py holds them against its own).
void lockstep_arenas(int* out) {
  out[0] = ls::kStack;
  out[1] = ls::kMemory;
  out[2] = ls::kSlots;
}

// Shared memory of a block of a batch with calldata arenas of C bytes,
// `words` visited words a lane (0: not recorded) and a program of
// `bucket` bytes.
int lockstep_smem_bytes(int C, int words, int bucket) {
  return ls::smem_bytes(C, words, bucket);
}

}  // extern "C"

#ifdef __CUDACC__

namespace ls {

LS_FN uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A block's shared memory (smem_bytes): the mbarrier of the bulk copies,
// the pops table, the stack, keys, values, value and caller limbs, the
// storage flags, the memory, the calldata, the visited words, the code
// and JUMPDEST bits.
struct Smem {
  uint64_t* bar;
  uint8_t* pops;
  Limb* stack;
  Limb* keys;
  Limb* vals;
  Limb* value;
  Limb* caller;
  uint8_t* sused;
  uint8_t* mem;
  uint8_t* cd;
  uint32_t* vis;
  uint8_t* code;
  uint32_t* jumpdest;
};

LS_FN Smem carve(uint8_t* smem, int C, int words, int bucket) {
  Smem S;
  S.bar = reinterpret_cast<uint64_t*>(smem);
  S.pops = smem + 16;
  S.stack = reinterpret_cast<Limb*>(smem + 16 + 256);
  S.keys = S.stack + kStack * kLimbs;
  S.vals = S.keys + kSlots * kLimbs;
  S.value = S.vals + kSlots * kLimbs;
  S.caller = S.value + kLimbs;
  S.sused = reinterpret_cast<uint8_t*>(S.caller + kLimbs);
  S.mem = S.sused + kSlots;
  S.cd = S.mem + kMemory;
  S.vis = reinterpret_cast<uint32_t*>(S.cd + C);
  S.code = reinterpret_cast<uint8_t*>(S.vis + visited_words(words));
  S.jumpdest = reinterpret_cast<uint32_t*>(S.code + bucket);
  return S;
}

LS_FN void bulk_in(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
LS_FN void bulk_out(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// in (thread 0): the bulk copies of the limbs, the memory, the calldata,
// the storage flags and a staged program, completing on the mbarrier
LS_FN void load_bulk(const Smem& S, const State& in, const Prog& P, int lane, int C) {
  const bool staged = stages_code(P.bucket);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(S.bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(S.bar)),
               "r"(kLimbBytes + kMemory + C + kSlots + (staged ? P.bucket + P.bucket / 8 : 0))
               : "memory");
  constexpr uint32_t kWord = kLimbs * sizeof(Limb);
  bulk_in(S.stack, in.stack + (size_t)lane * kStack * kLimbs, kStack * kWord, S.bar);
  bulk_in(S.keys, in.skeys + (size_t)lane * kSlots * kLimbs, kSlots * kWord, S.bar);
  bulk_in(S.vals, in.svals + (size_t)lane * kSlots * kLimbs, kSlots * kWord, S.bar);
  bulk_in(S.value, in.callvalue + (size_t)lane * kLimbs, kWord, S.bar);
  bulk_in(S.caller, in.caller + (size_t)lane * kLimbs, kWord, S.bar);
  bulk_in(S.mem, in.memory + (size_t)lane * kMemory, kMemory, S.bar);
  bulk_in(S.cd, in.calldata + (size_t)lane * C, C, S.bar);
  bulk_in(S.sused, in.sused + (size_t)lane * kSlots, kSlots, S.bar);
  if (staged) {
    bulk_in(S.code, P.code, P.bucket, S.bar);
    bulk_in(S.jumpdest, P.jumpdest, P.bucket / 8, S.bar);
  }
}

// out (thread 0): the limbs and the memory by bulk stores, committed
LS_FN void store_bulk(const Smem& S, const Out& out, int lane) {
  constexpr uint32_t kWord = kLimbs * sizeof(Limb);
  bulk_out(out.stack + (size_t)lane * kStack * kLimbs, S.stack, kStack * kWord);
  bulk_out(out.skeys + (size_t)lane * kSlots * kLimbs, S.keys, kSlots * kWord);
  bulk_out(out.svals + (size_t)lane * kSlots * kLimbs, S.vals, kSlots * kWord);
  bulk_out(out.memory + (size_t)lane * kMemory, S.mem, kMemory);
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

}  // namespace ls

__global__ void __launch_bounds__(ls::kThreads)
lockstep_kernel(ls::Prog P, ls::State in, ls::Out out, int C, int words,
                int max_steps) {
  using namespace ls;
  extern __shared__ __align__(16) uint8_t smem[];
  const Smem S = carve(smem, C, words, P.bucket);
  const int lane = blockIdx.x;
  const int t = threadIdx.x;

  if (t == 0) load_bulk(S, in, P, lane, C);
  if (stages_code(P.bucket)) {
    P.code = S.code;
    P.jumpdest = S.jumpdest;
  }
  for (int k = t; k < visited_words(words); k += kThreads) S.vis[k] = 0;
#pragma unroll
  for (int r = 0; r < 256 / kThreads; ++r) S.pops[t + kThreads * r] = (uint8_t)pops(t + kThreads * r);
  Lane L;
  L.stack = S.stack;
  L.mem = S.mem;
  L.skeys = S.keys;
  L.svals = S.vals;
  L.calldata = S.cd;
  L.callvalue = S.value;
  L.caller = S.caller;
  L.visited = S.vis;
  L.pops = S.pops;
  if (t < 8) open_lane(L, in, lane, C, words);
  __syncwarp();
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LS_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra LS_WAIT;\n"
      "}\n" ::"r"(smem_addr(S.bar))
      : "memory");

  if (t < 8) {
    L.used = 0;
    for (int k = 0; k < kSlots; ++k) L.used |= (uint32_t)(S.sused[k] != 0) << k;
    run_lane(L, P, max_steps);
    if (t == 0) {
      close_lane(L, out, lane);
      atomicMax(out.count, L.steps);
    }
    // the storage flags, four bytes a thread
    reinterpret_cast<uint32_t*>(out.sused + (size_t)lane * kSlots)[t] =
        ((L.used >> (4 * t)) & 1u) | ((L.used >> (4 * t + 1)) & 1u) << 8 |
        ((L.used >> (4 * t + 2)) & 1u) << 16 | ((L.used >> (4 * t + 3)) & 1u) << 24;
  }
  // the group's writes to shared memory made visible to the bulk store
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();

  if (t == 0) store_bulk(S, out, lane);
  const int ow = words > 0 ? words : 1;
  for (int k = t; k < ow; k += kThreads) out.visited[(size_t)lane * ow + k] = S.vis[k];
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

namespace {

constexpr int kDoesNotFit = 1000;  // ops/lockstep.py:DOES_NOT_FIT

// the card's opt-in shared memory a block, and the most this process has
// opted the kernel in to
int smem_limit() {
  static int limit = 0;
  if (!limit) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return limit;
}

}  // namespace

extern "C" {

// Plain C entry point (bound with ctypes): one block of one warp a lane.
// Reads the state in `in...` and writes `out...` (see ls::State, ls::Out);
// `code` is the program zero-padded to bucket + 16 bytes, `jumpdest` its
// JUMPDEST bits; `words` the visited bitmap's words a lane (0: not
// recorded, one zero word written); `count`, zeroed by the caller,
// receives the largest of the lanes' step counts.  The memory, calldata
// and flags rows, and every limb row, must be 16-byte aligned and C a
// multiple of 16.  Returns the cudaError_t of the launch (0: queued on
// `stream`), or kDoesNotFit when a block's shared memory is past the
// card's.
int lockstep_launch(const uint8_t* code, const uint32_t* jumpdest, int code_len,
                    int bucket, const int64_t* stack, const int* sp, const int* pc,
                    const uint8_t* memory, const int64_t* skeys, const int64_t* svals,
                    const uint8_t* sused, const uint8_t* calldata,
                    const int* calldatasize, const int64_t* callvalue,
                    const int64_t* caller, const int* halt, const int* ret_off,
                    const int* ret_len, const int* cause, int64_t* o_stack,
                    int* o_sp, int* o_pc, uint8_t* o_memory, int64_t* o_skeys,
                    int64_t* o_svals, uint8_t* o_sused, int* o_halt,
                    int* o_ret_off, int* o_ret_len, int* o_cause,
                    int64_t* visited, int* count, int B, int C, int max_steps,
                    int words, void* stream) {
  if (B < 1 || C < 32 || C % 16 || bucket < 32 || code_len < 0 ||
      code_len > bucket || max_steps < 0 || words < 0)
    return (int)cudaErrorInvalidValue;
  const int bytes = ls::smem_bytes(C, words, bucket);
  if (bytes > smem_limit()) return kDoesNotFit;
  static int opted = 48 * 1024;
  if (bytes > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        lockstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    opted = bytes;
  }
  ls::Prog P{code, jumpdest, code_len, bucket};
  ls::State in{stack, sp, pc, memory, skeys, svals, sused, calldata,
               calldatasize, callvalue, caller, halt, ret_off, ret_len, cause};
  ls::Out out{o_stack, o_sp, o_pc, o_memory, o_skeys, o_svals, o_sused,
              o_halt, o_ret_off, o_ret_len, o_cause, visited, count};
  lockstep_kernel<<<B, ls::kThreads, bytes, (cudaStream_t)stream>>>(
      P, in, out, C, words, max_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"

#else  // host build: the same lane walk on an emulated group

extern "C" {

// lockstep_launch's function (the same arguments, less the stream), one
// lane after another on the host, with the lane's state staged as the
// kernel stages it.  Returns 0, or 1 when a value the group should hold
// alike differed.
int lockstep_host(const uint8_t* code, const uint32_t* jumpdest, int code_len,
                  int bucket, const int64_t* stack, const int* sp, const int* pc,
                  const uint8_t* memory, const int64_t* skeys, const int64_t* svals,
                  const uint8_t* sused, const uint8_t* calldata,
                  const int* calldatasize, const int64_t* callvalue,
                  const int64_t* caller, const int* halt, const int* ret_off,
                  const int* ret_len, const int* cause, int64_t* o_stack,
                  int* o_sp, int* o_pc, uint8_t* o_memory, int64_t* o_skeys,
                  int64_t* o_svals, uint8_t* o_sused, int* o_halt,
                  int* o_ret_off, int* o_ret_len, int* o_cause,
                  int64_t* visited, int* count, int B, int C, int max_steps,
                  int words) {
  using namespace ls;
  Prog P{code, jumpdest, code_len, bucket};
  State in{stack, sp, pc, memory, skeys, svals, sused, calldata,
           calldatasize, callvalue, caller, halt, ret_off, ret_len, cause};
  Out out{o_stack, o_sp, o_pc, o_memory, o_skeys, o_svals, o_sused,
          o_halt, o_ret_off, o_ret_len, o_cause, visited, count};
  const int ow = words > 0 ? words : 1;
  std::vector<Limb> stack_s(kStack * kLimbs), keys_s(kSlots * kLimbs),
      vals_s(kSlots * kLimbs), value_s(kLimbs), caller_s(kLimbs);
  std::vector<uint32_t> vis_s(visited_words(words));
  std::vector<uint32_t> mem_w(kMemory / 4), cd_w(C / 4);  // word-aligned
  uint8_t* mem_s = reinterpret_cast<uint8_t*>(mem_w.data());
  uint8_t* cd_s = reinterpret_cast<uint8_t*>(cd_w.data());
  uint8_t pops_s[256];
  for (int k = 0; k < 256; ++k) pops_s[k] = (uint8_t)pops(k);
  host_fault() = 0;
  for (int lane = 0; lane < B; ++lane) {
    const size_t st = (size_t)lane * kStack * kLimbs, kv = (size_t)lane * kSlots * kLimbs;
    for (int k = 0; k < kStack * kLimbs; ++k) stack_s[k] = (Limb)in.stack[st + k];
    for (int k = 0; k < kSlots * kLimbs; ++k) {
      keys_s[k] = (Limb)in.skeys[kv + k];
      vals_s[k] = (Limb)in.svals[kv + k];
    }
    for (int k = 0; k < kLimbs; ++k) {
      value_s[k] = (Limb)in.callvalue[(size_t)lane * kLimbs + k];
      caller_s[k] = (Limb)in.caller[(size_t)lane * kLimbs + k];
    }
    for (int k = 0; k < kMemory; ++k) mem_s[k] = in.memory[(size_t)lane * kMemory + k];
    for (int k = 0; k < C; ++k) cd_s[k] = in.calldata[(size_t)lane * C + k];
    for (auto& x : vis_s) x = 0;
    Lane L;
    L.stack = stack_s.data();
    L.mem = mem_s;
    L.skeys = keys_s.data();
    L.svals = vals_s.data();
    L.calldata = cd_s;
    L.callvalue = value_s.data();
    L.caller = caller_s.data();
    L.visited = vis_s.data();
    L.pops = pops_s;
    open_lane(L, in, lane, C, words);
    L.used = 0;
    for (int k = 0; k < kSlots; ++k)
      L.used |= (uint32_t)(in.sused[(size_t)lane * kSlots + k] != 0) << k;
    run_lane(L, P, max_steps);
    close_lane(L, out, lane);
    if (L.steps > *out.count) *out.count = L.steps;
    for (int k = 0; k < kSlots; ++k)
      out.sused[(size_t)lane * kSlots + k] = (L.used >> k) & 1u;
    for (int k = 0; k < kStack * kLimbs; ++k) out.stack[st + k] = (int64_t)stack_s[k];
    for (int k = 0; k < kSlots * kLimbs; ++k) {
      out.skeys[kv + k] = (int64_t)keys_s[k];
      out.svals[kv + k] = (int64_t)vals_s[k];
    }
    for (int k = 0; k < kMemory; ++k) out.memory[(size_t)lane * kMemory + k] = mem_s[k];
    for (int k = 0; k < ow; ++k) out.visited[(size_t)lane * ow + k] = vis_s[k];
  }
  return host_fault();
}

// The kernel's binary opcode `op` (ls::binop: a the top of the stack, b
// the second) on n operand pairs of eight 32-bit limbs each, on the
// emulated group; out[k] the result.  Returns the division's add-back
// steps taken, or -1 when a value the group should hold alike differed.
long lockstep_host_binop(int op, const uint32_t* a, const uint32_t* b, int n,
                         uint32_t* out) {
  using namespace ls;
  host_fault() = 0;
  host_addbacks() = 0;
  for (int k = 0; k < n; ++k) {
    U r = binop(op, word_from(a + 8 * k), word_from(b + 8 * k));
    words_of(r, out + 8 * k);
  }
  return host_fault() ? -1 : host_addbacks();
}

}  // extern "C"

#endif  // __CUDACC__
