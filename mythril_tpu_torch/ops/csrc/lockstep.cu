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
// Design.  A lane's 256-bit arithmetic runs on a group of 8 threads, a
// limb a thread, on the primitives of word_prop.cu (copied below: ballot
// carries, compares by ballot, shuffled shifts, column multiply).  A
// block is one lane: 8 threads, one warp, because groups that diverge in
// one warp run one after another.  The lane's stack (2 KB), memory (4 KB)
// and storage keys and values (1 KB each) are staged in shared memory for
// the launch; a thread reads and writes only its own limb of a stack or
// storage word, so only memory writes need a __syncwarp.  Every branch
// depends on the program, the lane's scalars (sp, pc, halt) or a group
// vote, so a group never diverges.  Division is restoring long division
// from the dividend's top set bit (the rounds above it leave the
// quotient and remainder 0, so the result is the JAX loop's); EXP squares
// up to the exponent's top set bit.
//
// Bound: the state is read once and written once (about 8.3 KB a lane);
// the operations are the executed opcodes' 32-bit integer work, tens of
// operations a limb for most opcodes, some 7,000 for a division and up to
// 80,000 for a full-width EXP.  At the main path's batches (1 to 64
// lanes) a launch is latency-bound: one lane's steps are a chain.
//
// Compiled as host C++ (no __CUDACC__), the same lane walk runs on an
// emulated group of 8 threads (lockstep_host), so the CPU tests hold the
// kernel's own step and division code against the plain version.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LS_FN __device__ __forceinline__
#else
#include <vector>
#define LS_FN inline
#endif

namespace ls {

constexpr int kStack = 64;       // ops/lockstep.py:STACK_SLOTS
constexpr int kMemory = 4096;    // MEMORY_BYTES
constexpr int kSlots = 32;       // STORAGE_SLOTS
constexpr int kLimbs = 8;

enum Halt : int { RUNNING = 0, STOPPED, RETURNED, REVERTED, ERROR, NEEDS_HOST };
enum Cause : int { CAUSE_MEM_OOB = 1, CAUSE_STORAGE_FULL = 2, CAUSE_UNSUPPORTED = 3 };

// ------------------------------------------------------------ the group
// (word_prop.cu's group.)  U: this thread's limb of a 256-bit word; M: a
// predicate a thread.  On the card a thread holds one of each; the host
// build holds the whole group's eight and runs them in step.

#ifdef __CUDACC__

typedef uint32_t U;
typedef bool M;

LS_FN U limb_id() { return threadIdx.x & 7u; }
LS_FN unsigned group_mask() { return 0xFFu << (threadIdx.x & 24u); }
LS_FN U splat(uint32_t x) { return x; }
LS_FN U sel(M p, U a, U b) { return p ? a : b; }
LS_FN unsigned ballot(M p) {
  return (__ballot_sync(group_mask(), p) >> (threadIdx.x & 24u)) & 0xFFu;
}
LS_FN U shfl(U x, U src) { return __shfl_sync(group_mask(), x, (int)src, 8); }
LS_FN U shfl_up(U x, int d) { return __shfl_up_sync(group_mask(), x, d, 8); }
LS_FN uint32_t max_of(U x) { return __reduce_max_sync(group_mask(), x); }
LS_FN U clz(U x) { return (U)__clz((int)x); }
LS_FN U mul_hi(U a, U b) { return __umulhi(a, b); }
LS_FN int ffs32(uint32_t x) { return __ffs((int)x); }
LS_FN uint32_t uniform(U x) { return x; }
LS_FN void sync_group() { __syncwarp(group_mask()); }
LS_FN bool group_leader() { return (threadIdx.x & 7u) == 0; }
// limb i of the group's word: a statement for this thread's limb
#define LS_EACH(i, stmt) { const int i = (int)limb_id(); stmt; }
#define LIMB(x, i) (x)

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
LS_FN U u_mul(U a, U b) {  // mod 2^256: each thread sums its column
  U lo = u_zero(), hi = u_zero(), c_lo = u_zero(), c_hi = u_zero();
  U i = limb_id();
  for (uint32_t j = 0; j < 8; ++j) {
    U aj = shfl(a, splat(j));
    U bk = shfl(b, (i - j) & 7u);
    M on = i >= j;
    U p_lo = sel(on, aj * bk, u_zero());
    U p_hi = sel(on, mul_hi(aj, bk), u_zero());
    lo = lo + p_lo;
    c_lo = c_lo + sel(lo < p_lo, splat(1u), u_zero());
    hi = hi + p_hi;
    c_hi = c_hi + sel(hi < p_hi, splat(1u), u_zero());
  }
  // column i = lo + 2^32 (c_lo + hi) + 2^64 c_hi
  U up1 = sel(i >= 1u, shfl_up(hi, 1), u_zero());
  U small = sel(i >= 1u, shfl_up(c_lo, 1), u_zero()) +
            sel(i >= 2u, shfl_up(c_hi, 2), u_zero());
  return u_add(u_add(lo, up1), small);
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
LS_FN bool u_bit(U x, int index) {
  return (ballot(((x >> (uint32_t)(index & 31)) & 1u) != 0u) >> (index >> 5)) & 1u;
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
// (r << 1) | bit
LS_FN U u_shl1_with_bit(U r, bool bit) {
  U carry = sel(limb_id() == 0u, splat(bit ? 1u : 0u), shfl_up(r, 1) >> 31u);
  return (r << 1u) | carry;
}
// (a / b, a % b), both 0 when b is 0 (the EVM's rule): restoring long
// division from a's top set bit
LS_FN void u_udivmod(U a, U b, U* q_out, U* r_out) {
  U q = u_zero(), r = u_zero();
  if (u_any(b)) {
    for (int i = u_bit_length(a) - 1; i >= 0; --i) {
      U r2 = u_shl1_with_bit(r, u_bit(a, i));
      bool ge = !u_ult(r2, b);
      r = ge ? u_sub(r2, b) : r2;
      q = u_shl1_with_bit(q, ge);
    }
  }
  *q_out = q;
  *r_out = r;
}
LS_FN U u_abs(U a, bool* negative) {
  *negative = u_sign(a);
  return *negative ? u_neg(a) : a;
}
// EVM SDIV: truncated; x/0 = 0; MIN / -1 wraps to MIN
LS_FN U u_sdiv(U a, U b) {
  bool na, nb;
  U q, r;
  u_udivmod(u_abs(a, &na), u_abs(b, &nb), &q, &r);
  return na != nb ? u_neg(q) : q;
}
// EVM SMOD: the dividend's sign; x%0 = 0
LS_FN U u_smod(U a, U b) {
  bool na, nb;
  U q, r;
  u_udivmod(u_abs(a, &na), u_abs(b, &nb), &q, &r);
  return na ? u_neg(r) : r;
}
// a ** e mod 2^256, square-and-multiply up to e's top set bit
LS_FN U u_exp(U a, U e) {
  U result = u_one(), base = a;
  const int top = u_bit_length(e);
  for (int i = 0; i < top; ++i) {
    if (u_bit(e, i)) result = u_mul(result, base);
    if (i + 1 < top) base = u_mul(base, base);
  }
  return result;
}

// ---------------------------------------------------------------- words
// a word at w[0..7] (limb i at w[i]); each thread its own limb
LS_FN U ld_word(const uint32_t* w) {
  U r = u_zero();
  LS_EACH(i, LIMB(r, i) = w[i]);
  return r;
}
LS_FN void st_word(uint32_t* w, U x) { LS_EACH(i, w[i] = LIMB(x, i)); }
// 32 big-endian bytes at p[off..off+31]; bytes at or past `limit` read 0
LS_FN U bytes_word(const uint8_t* p, int off, int limit) {
  U r = u_zero();
  LS_EACH(i, {
    const int b = off + 28 - 4 * i;
    uint32_t x = 0;
    for (int k = 0; k < 4; ++k) x = (x << 8) | (b + k < limit ? p[b + k] : 0u);
    LIMB(r, i) = x;
  });
  return r;
}
LS_FN void store_bytes(uint8_t* p, int off, U x) {
  LS_EACH(i, {
    const int b = off + 28 - 4 * i;
    const uint32_t v = LIMB(x, i);
    p[b] = (uint8_t)(v >> 24);
    p[b + 1] = (uint8_t)(v >> 16);
    p[b + 2] = (uint8_t)(v >> 8);
    p[b + 3] = (uint8_t)v;
  });
}

LS_FN int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// stack items popped per opcode (ops/lockstep.py:_POPS_TABLE)
LS_FN int pops(int op) {
  if (op >= 0x80 && op <= 0x8F) return op - 0x80 + 1;
  if (op >= 0x90 && op <= 0x9F) return op - 0x90 + 2;
  switch (op) {
    case 0x01: case 0x02: case 0x03: case 0x04: case 0x05: case 0x06:
    case 0x07: case 0x0A: case 0x10: case 0x11: case 0x12: case 0x13:
    case 0x14: case 0x16: case 0x17: case 0x18: case 0x1B: case 0x1C:
    case 0x1D: case 0x52: case 0x53: case 0x55: case 0x57: case 0xF3:
    case 0xFD:
      return 2;
    case 0x15: case 0x19: case 0x35: case 0x50: case 0x51: case 0x54:
    case 0x56:
      return 1;
    default:
      return 0;
  }
}

struct Prog {
  const uint8_t* code;       // [bucket]
  const uint8_t* jumpdest;   // [bucket]
  int code_len, bucket;
};

// One lane: its stack, memory and storage (shared memory on the card),
// its read-only inputs, and its scalars (the same in every thread).
struct Lane {
  uint32_t* stack;           // [kStack][8]
  uint8_t* mem;              // [kMemory]
  uint32_t* skeys;           // [kSlots][8]
  uint32_t* svals;           // [kSlots][8]
  const uint8_t* calldata;   // [C]
  int C, cdsize;
  const uint32_t* callvalue; // [8]
  const uint32_t* caller;    // [8]
  uint32_t* visited;         // [words], or nullptr
  int words;
  int sp, pc, halt, cause, ret_off, ret_len, steps;
  uint32_t used;             // bit k: storage slot k in use
};

LS_FN uint32_t* slot(Lane& L, int idx) { return L.stack + clampi(idx, 0, kStack - 1) * kLimbs; }
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
         P.jumpdest[clampi(*dest, 0, P.bucket - 1)];
}

// the first used slot whose key equals `key`, or -1
LS_FN int find_slot(Lane& L, U key) {
  for (int k = 0; k < kSlots; ++k)
    if (((L.used >> k) & 1u) && u_eq(ld_word(L.skeys + k * kLimbs), key)) return k;
  return -1;
}

LS_FN U binop(int op, U a, U b) {
  U q, r;
  switch (op) {
    case 0x01: return u_add(a, b);
    case 0x02: return u_mul(a, b);
    case 0x03: return u_sub(a, b);
    case 0x04: u_udivmod(a, b, &q, &r); return q;
    case 0x05: return u_sdiv(a, b);
    case 0x06: u_udivmod(a, b, &q, &r); return r;
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
      const int k = find_slot(L, peek(L, 0));
      st_word(slot(L, L.sp - 1), k >= 0 ? ld_word(L.svals + k * kLimbs) : u_zero());
      L.pc += 1;
      return;
    }
    case 0x55: {  // SSTORE
      U key = peek(L, 0), value = peek(L, 1);
      int k = find_slot(L, key);
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
      if (op >= 0x5F && op <= 0x7F) {  // PUSH0..PUSH32
        const int n = op - 0x5F;
        U word = bytes_word(P.code, clampi(L.pc + 1, 0, P.bucket - 32), P.bucket);
        push(L, u_lshr(word, (32 - n) * 8), L.pc + 1 + n);
      } else if (op >= 0x80 && op <= 0x8F) {  // DUP1..DUP16
        push(L, peek(L, op - 0x80), L.pc + 1);
      } else if (op >= 0x90 && op <= 0x9F) {  // SWAP1..SWAP16
        const int k = op - 0x8F;
        U top = peek(L, 0), deep = peek(L, k);
        st_word(slot(L, L.sp - 1), deep);
        st_word(slot(L, L.sp - 1 - k), top);
        L.pc += 1;
      } else {
        park(L, op, CAUSE_UNSUPPORTED);
      }
      return;
  }
}

// the lane until it halts or has taken max_steps steps
LS_FN void run_lane(Lane& L, const Prog& P, int max_steps) {
  while (L.halt == RUNNING && L.steps < max_steps) {
    if (L.words && group_leader())
      L.visited[clampi(L.pc >> 5, 0, L.words - 1)] |= 1u << (L.pc & 31);
    L.steps += 1;
    const int op = L.pc >= P.code_len ? 0 : P.code[clampi(L.pc, 0, P.bucket - 1)];
    if (L.sp < pops(op)) {
      L.halt = ERROR;
      continue;
    }
    step(L, P, op);
  }
}

// The batch's global layout (ops/lockstep.py:pack_state): limbs as
// 32-bit words, one row a lane.
struct Io {
  const uint8_t* calldata;  // [B][C]
  const int* calldatasize;  // [B]
  uint32_t* stack;          // [B][kStack][8]
  int* sp;
  int* pc;
  uint8_t* memory;          // [B][kMemory]
  uint32_t* skeys;          // [B][kSlots][8]
  uint32_t* svals;
  uint8_t* sused;           // [B][kSlots]
  const uint32_t* callvalue;  // [B][8]
  const uint32_t* caller;
  int* halt;
  int* ret_off;
  int* ret_len;
  int* cause;
  uint32_t* visited;        // [B][words]
  int* steps;               // [B]
  int C, words;
};

// the lane's scalars and read-only rows from the batch
LS_FN void open_lane(Lane& L, const Io& io, int lane) {
  L.calldata = io.calldata + (size_t)lane * io.C;
  L.C = io.C;
  L.cdsize = io.calldatasize[lane];
  L.callvalue = io.callvalue + (size_t)lane * kLimbs;
  L.caller = io.caller + (size_t)lane * kLimbs;
  L.words = io.words;
  L.visited = io.words ? io.visited + (size_t)lane * io.words : nullptr;
  L.sp = io.sp[lane];
  L.pc = io.pc[lane];
  L.halt = io.halt[lane];
  L.cause = io.cause[lane];
  L.ret_off = io.ret_off[lane];
  L.ret_len = io.ret_len[lane];
  L.steps = 0;
  L.used = 0;
  for (int k = 0; k < kSlots; ++k)
    if (io.sused[(size_t)lane * kSlots + k]) L.used |= 1u << k;
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

}  // extern "C"

#ifdef __CUDACC__

__global__ void __launch_bounds__(8)
lockstep_kernel(ls::Prog P, ls::Io io, int max_steps) {
  using namespace ls;
  __shared__ uint32_t stack_s[kStack * kLimbs];
  __shared__ uint32_t keys_s[kSlots * kLimbs];
  __shared__ uint32_t vals_s[kSlots * kLimbs];
  __shared__ uint32_t mem_s[kMemory / 4];
  const int lane = blockIdx.x;
  const int t = threadIdx.x;  // the limb
  const uint32_t* mem_g = (const uint32_t*)(io.memory + (size_t)lane * kMemory);
  for (int k = t; k < kStack * kLimbs; k += kLimbs)
    stack_s[k] = io.stack[(size_t)lane * kStack * kLimbs + k];
  for (int k = t; k < kSlots * kLimbs; k += kLimbs) {
    keys_s[k] = io.skeys[(size_t)lane * kSlots * kLimbs + k];
    vals_s[k] = io.svals[(size_t)lane * kSlots * kLimbs + k];
  }
  for (int k = t; k < kMemory / 4; k += kLimbs) mem_s[k] = mem_g[k];
  __syncwarp(0xFFu);

  Lane L;
  L.stack = stack_s;
  L.mem = (uint8_t*)mem_s;
  L.skeys = keys_s;
  L.svals = vals_s;
  open_lane(L, io, lane);
  run_lane(L, P, max_steps);
  __syncwarp(0xFFu);

  for (int k = t; k < kStack * kLimbs; k += kLimbs)
    io.stack[(size_t)lane * kStack * kLimbs + k] = stack_s[k];
  for (int k = t; k < kSlots * kLimbs; k += kLimbs) {
    io.skeys[(size_t)lane * kSlots * kLimbs + k] = keys_s[k];
    io.svals[(size_t)lane * kSlots * kLimbs + k] = vals_s[k];
  }
  uint32_t* mem_out = (uint32_t*)(io.memory + (size_t)lane * kMemory);
  for (int k = t; k < kMemory / 4; k += kLimbs) mem_out[k] = mem_s[k];
  for (int k = t; k < kSlots; k += kLimbs)
    io.sused[(size_t)lane * kSlots + k] = (L.used >> k) & 1u;
  if (t == 0) {
    io.sp[lane] = L.sp;
    io.pc[lane] = L.pc;
    io.halt[lane] = L.halt;
    io.cause[lane] = L.cause;
    io.ret_off[lane] = L.ret_off;
    io.ret_len[lane] = L.ret_len;
    io.steps[lane] = L.steps;
  }
}

extern "C" {

// Plain C entry point (bound with ctypes): one block of 8 threads a lane,
// the batch's state updated in place.  `words` is the visited bitmap's
// words a lane (0: not recorded).  Returns the cudaError_t of the launch
// (0: the kernel was queued on `stream`).
int lockstep_launch(const uint8_t* code, const uint8_t* jumpdest,
                    const uint8_t* calldata, const int* calldatasize,
                    int code_len, int bucket, uint32_t* stack, int* sp,
                    int* pc, uint8_t* memory, uint32_t* skeys, uint32_t* svals,
                    uint8_t* sused, const uint32_t* callvalue,
                    const uint32_t* caller, int* halt, int* ret_off,
                    int* ret_len, int* cause, uint32_t* visited, int* steps,
                    int B, int C, int max_steps, int words, void* stream) {
  if (B < 1 || C < 32 || bucket < 32 || code_len < 0 || code_len > bucket ||
      max_steps < 0 || words < 0)
    return (int)cudaErrorInvalidValue;
  ls::Prog P{code, jumpdest, code_len, bucket};
  ls::Io io{calldata, calldatasize, stack, sp, pc, memory, skeys, svals,
            sused, callvalue, caller, halt, ret_off, ret_len, cause,
            visited, steps, C, words};
  lockstep_kernel<<<B, 8, 0, (cudaStream_t)stream>>>(P, io, max_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"

#else  // host build: the same lane walk on an emulated group

extern "C" {

// lockstep_launch's function, one lane after another on the host, with
// the lane's stack, memory and storage staged as the kernel stages them.
// Returns 0, or 1 when a value the group should hold alike differed.
int lockstep_host(const uint8_t* code, const uint8_t* jumpdest,
                  const uint8_t* calldata, const int* calldatasize,
                  int code_len, int bucket, uint32_t* stack, int* sp, int* pc,
                  uint8_t* memory, uint32_t* skeys, uint32_t* svals,
                  uint8_t* sused, const uint32_t* callvalue,
                  const uint32_t* caller, int* halt, int* ret_off,
                  int* ret_len, int* cause, uint32_t* visited, int* steps,
                  int B, int C, int max_steps, int words) {
  using namespace ls;
  Prog P{code, jumpdest, code_len, bucket};
  Io io{calldata, calldatasize, stack, sp, pc, memory, skeys, svals,
        sused, callvalue, caller, halt, ret_off, ret_len, cause,
        visited, steps, C, words};
  std::vector<uint32_t> stack_s(kStack * kLimbs), keys_s(kSlots * kLimbs),
      vals_s(kSlots * kLimbs);
  std::vector<uint8_t> mem_s(kMemory);
  host_fault() = 0;
  for (int lane = 0; lane < B; ++lane) {
    uint32_t* st = io.stack + (size_t)lane * kStack * kLimbs;
    uint32_t* ks = io.skeys + (size_t)lane * kSlots * kLimbs;
    uint32_t* vs = io.svals + (size_t)lane * kSlots * kLimbs;
    uint8_t* mg = io.memory + (size_t)lane * kMemory;
    stack_s.assign(st, st + kStack * kLimbs);
    keys_s.assign(ks, ks + kSlots * kLimbs);
    vals_s.assign(vs, vs + kSlots * kLimbs);
    mem_s.assign(mg, mg + kMemory);
    Lane L;
    L.stack = stack_s.data();
    L.mem = mem_s.data();
    L.skeys = keys_s.data();
    L.svals = vals_s.data();
    open_lane(L, io, lane);
    run_lane(L, P, max_steps);
    for (int k = 0; k < kStack * kLimbs; ++k) st[k] = stack_s[k];
    for (int k = 0; k < kSlots * kLimbs; ++k) {
      ks[k] = keys_s[k];
      vs[k] = vals_s[k];
    }
    for (int k = 0; k < kMemory; ++k) mg[k] = mem_s[k];
    for (int k = 0; k < kSlots; ++k)
      io.sused[(size_t)lane * kSlots + k] = (L.used >> k) & 1u;
    io.sp[lane] = L.sp;
    io.pc[lane] = L.pc;
    io.halt[lane] = L.halt;
    io.cause[lane] = L.cause;
    io.ret_off[lane] = L.ret_off;
    io.ret_len[lane] = L.ret_len;
    io.steps[lane] = L.steps;
  }
  return host_fault();
}

}  // extern "C"

#endif  // __CUDACC__
