// The word tier's batched fixpoint, for sm_90a: interval + known-bits
// propagation over a term DAG, for every lane of a decide in one launch.
//
// Replaces the eager jax.numpy executor of the JAX package's word tier:
// mythril_tpu/smt/word_tier.py:402 (WordTier._run -> _forward :888,
// _backward :1045, _push_bv_down :1182) over the limb-plane transfers of
// mythril_tpu/ops/word_prop.py:226-573 (f_*, p_*, b_ult_true) and the
// u256 limb primitives.  No Pallas kernel: on a TPU those are hundreds of
// array ops a node, each its own dispatch.
//
// What it computes (the same as the plain PyTorch version,
// ops/word_fixpoint.py:word_fixpoint_plain, bit for bit): one forward pass,
// then `rounds` x (backward pass, forward pass), over the packed node table
// of a compiled program:
//
//   forward, nodes in order: a bool node takes its tri-state (+1 must-true,
//     -1 must-false, 0 open) from its args and meets the previous one
//     (opposite decisions are a conflict); a bv node takes its abstract word
//     (lo, hi, km, kv: an unsigned interval and known bits, 8 x 32-bit limbs
//     each) from its args' words and meets the previous word (an empty word
//     is a conflict).  On the first pass nothing is met; opaque and var
//     nodes start at top and keep their word afterwards;
//   backward, nodes in reverse: the lane's constraints are wanted true; a
//     wanted bool node pushes wants into its args (bnot, band, bor, bxor,
//     ite) or, for a comparison, refines its operands' words (eq: the meet
//     of both; ult/ule and their negations: bound tightening) and pushes
//     the refinement down through the invertible bit structure (zext, not,
//     extract, concat, and/or/xor/add/sub with a constant side, shl/lshr
//     by a constant) to depth 8.
//
// Every transfer is integer logic on 32-bit limbs, so nothing rounds.
//
// Design.  One thread a lane walks the table; the lanes of a warp walk it
// in step, so a node's state, stored lane-fastest ([slot][field][limb]
// [lane]), is read and written as coalesced rows.  A word lives in
// registers while a transfer runs.  The push-down recursion is an explicit
// stack of (node, depth, next child, bit offset) frames; a frame re-reads
// its node's word, which none of its descendants can change.  Blocks of 32
// threads, so that 64 lanes use two SMs.
//
// Bound: the state planes (128 B a bv slot a lane) are written once and
// the table read once; the operations are a few hundred 32-bit integer
// operations a node a pass a lane.  At the main path's sizes (tens to a
// few hundred nodes, 16-256 lanes) a launch is latency-bound: each thread
// runs its lane's passes one node after another.
//
// The lane interpreter (word_lane) also compiles as host C++, with the
// __device__ qualifiers defined away.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WP_FN __device__ __forceinline__
#define WP_LANE __device__
#else
#define WP_FN inline
#define WP_LANE inline
#endif

namespace wp {

// opcodes: the order of ops/word_fixpoint.py:OP_NAMES
enum Op : int {
  OP_OPAQUE = 0, OP_CONST, OP_VAR, OP_ADD, OP_SUB, OP_MUL, OP_UDIV, OP_UREM,
  OP_AND, OP_OR, OP_XOR, OP_NOT, OP_SHL, OP_LSHR, OP_ASHR, OP_CONCAT,
  OP_EXTRACT, OP_ZEXT, OP_SEXT, OP_ITE, OP_BCONST, OP_BVAR, OP_BAND, OP_BOR,
  OP_BNOT, OP_BXOR, OP_EQ, OP_ULT, OP_ULE, OP_SLT, OP_SLE, OP_BITE,
  OP_COUNT
};
// entry columns: ops/word_fixpoint.py:ENTRY_COLUMNS
enum Col : int {
  C_OP = 0, C_WIDTH, C_SLOT, C_FLAGS, C_NARGS, C_ARGOFF, C_P0, C_P1,
  C_COUNT
};
constexpr int F_OPAQUE = 1;
constexpr int F_BOOL = 2;
constexpr int kPushDepth = 8;
constexpr int kThreads = 32;

struct U { uint32_t w[8]; };
struct AW { U lo, hi, km, kv; };

// ---------------------------------------------------------------- u256

WP_FN U u_zero() { U r; for (int i = 0; i < 8; ++i) r.w[i] = 0u; return r; }
WP_FN U u_ones() { U r; for (int i = 0; i < 8; ++i) r.w[i] = 0xFFFFFFFFu; return r; }
WP_FN U u_wmask(int width) {  // 2^width - 1, width in [0, 256]
  U r;
  for (int i = 0; i < 8; ++i) {
    int bits = width - 32 * i;
    r.w[i] = bits >= 32 ? 0xFFFFFFFFu : bits <= 0 ? 0u : ((1u << bits) - 1u);
  }
  return r;
}
WP_FN U u_not(const U& a) { U r; for (int i = 0; i < 8; ++i) r.w[i] = ~a.w[i]; return r; }
WP_FN U u_and(const U& a, const U& b) { U r; for (int i = 0; i < 8; ++i) r.w[i] = a.w[i] & b.w[i]; return r; }
WP_FN U u_or(const U& a, const U& b) { U r; for (int i = 0; i < 8; ++i) r.w[i] = a.w[i] | b.w[i]; return r; }
WP_FN U u_xor(const U& a, const U& b) { U r; for (int i = 0; i < 8; ++i) r.w[i] = a.w[i] ^ b.w[i]; return r; }
WP_FN bool u_any(const U& a) { uint32_t x = 0; for (int i = 0; i < 8; ++i) x |= a.w[i]; return x != 0u; }
WP_FN bool u_eq(const U& a, const U& b) { uint32_t x = 0; for (int i = 0; i < 8; ++i) x |= a.w[i] ^ b.w[i]; return x == 0u; }
WP_FN bool u_ult(const U& a, const U& b) {
  bool r = false;
  for (int i = 0; i < 8; ++i)
    if (a.w[i] != b.w[i]) r = a.w[i] < b.w[i];
  return r;
}
WP_FN bool u_ule(const U& a, const U& b) { return !u_ult(b, a); }
WP_FN U u_umin(const U& a, const U& b) { return u_ult(a, b) ? a : b; }
WP_FN U u_umax(const U& a, const U& b) { return u_ult(a, b) ? b : a; }
WP_FN U u_add_carry(const U& a, const U& b, bool* carry_out) {
  U r;
  uint64_t c = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t s = (uint64_t)a.w[i] + b.w[i] + c;
    r.w[i] = (uint32_t)s;
    c = s >> 32;
  }
  *carry_out = c != 0;
  return r;
}
WP_FN U u_add(const U& a, const U& b) { bool c; return u_add_carry(a, b, &c); }
WP_FN U u_sub(const U& a, const U& b) {
  U r;
  int64_t borrow = 0;
  for (int i = 0; i < 8; ++i) {
    int64_t d = (int64_t)a.w[i] - (int64_t)b.w[i] - borrow;
    r.w[i] = (uint32_t)d;
    borrow = d < 0 ? 1 : 0;
  }
  return r;
}
WP_FN U u_one() { U r = u_zero(); r.w[0] = 1u; return r; }
WP_FN U u_mul(const U& a, const U& b) {  // mod 2^256
  U r = u_zero();
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    for (int j = 0; i + j < 8; ++j) {
      uint64_t t = (uint64_t)a.w[i] * b.w[j] + r.w[i + j] + c;
      r.w[i + j] = (uint32_t)t;
      c = t >> 32;
    }
  }
  return r;
}
// shifts by an amount >= 0; 256 and more give 0
WP_FN U u_shl(const U& a, int amt) {
  U r = u_zero();
  if (amt >= 256) return r;
  int word = amt >> 5, bit = amt & 31;
  for (int i = 0; i < 8; ++i) {
    int s = i - word;
    uint32_t lo = s >= 0 ? a.w[s] : 0u;
    uint32_t hi = s - 1 >= 0 ? a.w[s - 1] : 0u;
    r.w[i] = bit ? ((lo << bit) | (hi >> (32 - bit))) : lo;
  }
  return r;
}
WP_FN U u_lshr(const U& a, int amt) {
  U r = u_zero();
  if (amt >= 256) return r;
  int word = amt >> 5, bit = amt & 31;
  for (int i = 0; i < 8; ++i) {
    int s = i + word;
    uint32_t lo = s < 8 ? a.w[s] : 0u;
    uint32_t hi = s + 1 < 8 ? a.w[s + 1] : 0u;
    r.w[i] = bit ? ((lo >> bit) | (hi << (32 - bit))) : lo;
  }
  return r;
}
WP_FN bool u_bit(const U& x, int index) { return (x.w[index >> 5] >> (index & 31)) & 1u; }
WP_FN int clz32(uint32_t x) {
#ifdef __CUDACC__
  return __clz(x);
#else
  return x ? __builtin_clz(x) : 32;
#endif
}
WP_FN int popc32(uint32_t x) {
#ifdef __CUDACC__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}
WP_FN int u_bit_length(const U& x) {
  for (int i = 7; i >= 0; --i)
    if (x.w[i]) return 32 * i + 32 - clz32(x.w[i]);
  return 0;
}
WP_FN int u_popcount(const U& x) { int n = 0; for (int i = 0; i < 8; ++i) n += popc32(x.w[i]); return n; }
// bits strictly above the most significant set bit (all ones for 0)
WP_FN U u_prefix_mask(const U& x) {
  int bl = u_bit_length(x);
  return u_not(u_wmask(bl));
}
// contiguous known bits from bit 0
WP_FN U u_trailing_known(const U& km) {
  U r = u_zero();
  for (int i = 0; i < 8; ++i) {
    uint32_t k = km.w[i];
    r.w[i] = k & ~(k + 1u);
    if (k != 0xFFFFFFFFu) break;
  }
  return r;
}
// a shift amount from a word: any high limb makes it 257, the overflow
// representative
WP_FN int amount_of(const U& a) {
  for (int i = 1; i < 8; ++i)
    if (a.w[i]) return 257;
  return a.w[0] > 257u ? 257 : (int)a.w[0];
}

// ---------------------------------------------------------------- domains

WP_FN AW top_word(int width) {
  AW t; U wm = u_wmask(width);
  t.lo = u_zero(); t.hi = wm; t.km = u_not(wm); t.kv = u_zero();
  return t;
}

WP_FN AW refine(U lo, U hi, U km, U kv, const U& wm, bool* empty) {
  kv = u_and(kv, km);
  U maxv = u_or(kv, u_and(u_not(km), wm));
  lo = u_umax(lo, kv);
  hi = u_umin(hi, maxv);
  U agree = u_prefix_mask(u_xor(lo, hi));
  bool conflict = u_any(u_and(u_and(km, agree), u_xor(kv, u_and(lo, agree))));
  km = u_or(km, agree);
  kv = u_and(u_or(kv, u_and(lo, agree)), km);
  *empty = u_ult(hi, lo) || conflict;
  AW r; r.lo = lo; r.hi = hi; r.km = km; r.kv = kv;
  return r;
}

WP_FN AW meet(const AW& a, const AW& b, const U& wm, bool* empty) {
  bool conflict = u_any(u_and(u_and(a.km, b.km), u_xor(a.kv, b.kv)));
  U km = u_or(a.km, b.km);
  AW r = refine(u_umax(a.lo, b.lo), u_umin(a.hi, b.hi), km,
                u_and(u_or(a.kv, b.kv), km), wm, empty);
  *empty = *empty || conflict;
  return r;
}

WP_FN AW join(const AW& a, const AW& b) {
  AW r;
  r.km = u_and(u_and(a.km, b.km), u_not(u_xor(a.kv, b.kv)));
  r.kv = u_and(a.kv, r.km);
  r.lo = u_umin(a.lo, b.lo);
  r.hi = u_umax(a.hi, b.hi);
  return r;
}

// ---------------------------------------------------------------- transfers

WP_FN AW f_add(const AW& a, const AW& b, int width, const U& wm, bool* e) {
  bool c_lo, c_hi;
  U s_lo = u_add_carry(a.lo, b.lo, &c_lo);
  U s_hi = u_add_carry(a.hi, b.hi, &c_hi);
  bool w_lo = width == 256 ? c_lo : u_bit(s_lo, width);
  bool w_hi = width == 256 ? c_hi : u_bit(s_hi, width);
  bool same = w_lo == w_hi;
  U lo = same ? u_and(s_lo, wm) : u_zero();
  U hi = same ? u_and(s_hi, wm) : wm;
  U tm = u_and(u_and(u_trailing_known(a.km), u_trailing_known(b.km)), wm);
  U km = u_or(tm, u_not(wm));
  U kv = u_and(u_add(a.kv, b.kv), tm);
  return refine(lo, hi, km, kv, wm, e);
}

WP_FN AW f_sub(const AW& a, const AW& b, const U& wm, bool* e) {
  bool same = u_ult(a.lo, b.hi) == u_ult(a.hi, b.lo);
  U lo = same ? u_and(u_sub(a.lo, b.hi), wm) : u_zero();
  U hi = same ? u_and(u_sub(a.hi, b.lo), wm) : wm;
  U tm = u_and(u_and(u_trailing_known(a.km), u_trailing_known(b.km)), wm);
  U km = u_or(tm, u_not(wm));
  U kv = u_and(u_sub(a.kv, b.kv), tm);
  return refine(lo, hi, km, kv, wm, e);
}

WP_FN AW f_mul(const AW& a, const AW& b, int width, const U& wm, bool* e) {
  U tm = u_and(u_and(u_trailing_known(a.km), u_trailing_known(b.km)), wm);
  U km = u_or(tm, u_not(wm));
  U kv = u_and(u_mul(a.kv, b.kv), tm);
  bool fits = u_bit_length(a.hi) + u_bit_length(b.hi) <= width;
  U lo = fits ? u_mul(a.lo, b.lo) : u_zero();
  U hi = fits ? u_mul(a.hi, b.hi) : wm;
  return refine(lo, hi, km, kv, wm, e);
}

WP_FN AW f_udiv(const AW& a, const AW& b, const U& wm, bool* e) {
  bool bz = !u_any(b.hi);
  bool nz = u_any(b.lo);
  int bl = u_bit_length(b.lo) - 1;
  int amt = bl > 0 ? bl : 0;
  U lo = bz ? wm : u_lshr(a.lo, u_bit_length(b.hi));
  U hi = nz ? u_lshr(a.hi, amt) : wm;
  bool pow2 = nz && u_eq(b.lo, b.hi) && u_popcount(b.lo) == 1;
  U km = u_not(wm), kv = u_zero();
  if (pow2) {
    km = u_or(u_or(u_lshr(a.km, amt), u_not(u_lshr(u_ones(), amt))), km);
    kv = u_and(u_and(u_lshr(a.kv, amt), km), wm);
    lo = u_lshr(a.lo, amt);
  }
  return refine(lo, hi, km, kv, wm, e);
}

WP_FN AW f_urem(const AW& a, const AW& b, const U& wm, bool* e) {
  U one = u_one();
  bool nz = u_any(b.lo);
  U hi = nz ? u_umin(a.hi, u_sub(b.hi, one)) : a.hi;
  U lo = u_zero();
  bool pow2 = nz && u_eq(b.lo, b.hi) && u_popcount(b.lo) == 1;
  U mask = u_sub(b.lo, one);
  U km = u_not(wm), kv = u_zero();
  if (pow2) {
    km = u_or(u_or(a.km, u_not(mask)), km);
    kv = u_and(u_and(u_and(a.kv, mask), km), wm);
    hi = u_umin(a.hi, mask);
  }
  if (!u_any(b.hi) || (nz && u_ult(a.hi, b.lo))) {
    lo = a.lo; hi = a.hi; km = a.km; kv = a.kv;
  }
  return refine(lo, hi, km, kv, wm, e);
}

WP_FN AW f_and(const AW& a, const AW& b, const U& wm, bool* e) {
  U k0 = u_or(u_and(a.km, u_not(a.kv)), u_and(b.km, u_not(b.kv)));
  U k1 = u_and(u_and(a.km, a.kv), u_and(b.km, b.kv));
  return refine(u_zero(), u_umin(a.hi, b.hi), u_or(k0, k1), k1, wm, e);
}

WP_FN AW f_or(const AW& a, const AW& b, const U& wm, bool* e) {
  U k1 = u_or(u_and(a.km, a.kv), u_and(b.km, b.kv));
  U k0 = u_and(u_and(a.km, u_not(a.kv)), u_and(b.km, u_not(b.kv)));
  return refine(u_umax(a.lo, b.lo), wm, u_or(k0, k1), k1, wm, e);
}

WP_FN AW f_xor(const AW& a, const AW& b, const U& wm, bool* e) {
  U km = u_and(a.km, b.km);
  return refine(u_zero(), wm, km, u_and(u_xor(a.kv, b.kv), km), wm, e);
}

WP_FN AW f_not(const AW& a, const U& wm, bool* e) {
  U km = u_or(u_and(a.km, wm), u_not(wm));
  U kv = u_and(u_and(u_not(a.kv), a.km), wm);
  return refine(u_sub(wm, a.hi), u_sub(wm, a.lo), km, kv, wm, e);
}

WP_FN AW f_shl(const AW& a, const AW& b, int width, const U& wm, bool* e) {
  bool known = u_eq(b.lo, b.hi);
  int amt = amount_of(b.lo);
  U km_s = u_or(u_shl(a.km, amt), u_not(u_shl(u_ones(), amt)));
  U km = u_or(known ? u_and(km_s, wm) : u_zero(), u_not(wm));
  U kv = u_and(u_and(known ? u_shl(a.kv, amt) : u_zero(), km), wm);
  bool fits = known && u_bit_length(a.hi) + amt <= width;
  U lo = fits ? u_shl(a.lo, amt) : u_zero();
  U hi = fits ? u_shl(a.hi, amt) : wm;
  return refine(lo, hi, km, kv, wm, e);
}

WP_FN AW f_lshr(const AW& a, const AW& b, const U& wm, bool* e) {
  bool known = u_eq(b.lo, b.hi);
  int amt = amount_of(b.lo);
  U km_s = u_or(u_lshr(a.km, amt), u_not(u_lshr(u_ones(), amt)));
  U km = u_or(known ? km_s : u_zero(), u_not(wm));
  U kv = u_and(u_and(known ? u_lshr(a.kv, amt) : u_zero(), km), wm);
  U lo = known ? u_lshr(a.lo, amt) : u_zero();
  U hi = known ? u_lshr(a.hi, amt) : a.hi;
  return refine(lo, hi, km, kv, wm, e);
}

WP_FN AW f_ashr(const AW& a, const AW& b, int width, const U& wm, bool* e) {
  bool sign_known0 = u_bit(a.km, width - 1) && !u_bit(a.kv, width - 1);
  AW r = f_lshr(a, b, wm, e);
  if (!sign_known0) r = top_word(width);
  *e = *e && sign_known0;
  return r;
}

WP_FN AW f_extract(const AW& a, int high, int low, const U& wm_new, bool* e) {
  U km = u_or(u_and(u_lshr(a.km, low), wm_new), u_not(wm_new));
  U kv = u_and(u_and(u_lshr(a.kv, low), wm_new), km);
  bool keep = u_ule(a.hi, u_wmask(high + 1));
  U lo = keep ? u_lshr(a.lo, low) : u_zero();
  U hi = keep ? u_lshr(a.hi, low) : wm_new;
  return refine(lo, hi, km, kv, wm_new, e);
}

WP_FN AW f_sext(const AW& a, int old_width, int new_width, const U& wm_new,
                bool* e) {
  U wm_old = u_wmask(old_width);
  U hmask = u_and(u_wmask(new_width), u_not(wm_old));
  bool sign_known = u_bit(a.km, old_width - 1);
  bool sign_val = u_bit(a.kv, old_width - 1);
  U lo, hi, km, kv;
  if (sign_known && sign_val) {
    km = u_or(a.km, hmask); kv = u_or(u_and(a.kv, wm_old), hmask);
    lo = u_or(a.lo, hmask); hi = u_or(a.hi, hmask);
  } else if (sign_known) {
    km = u_or(a.km, hmask); kv = u_and(a.kv, wm_old); lo = a.lo; hi = a.hi;
  } else {
    km = u_or(u_and(a.km, wm_old), u_not(wm_new)); kv = u_and(a.kv, wm_old);
    lo = u_zero(); hi = wm_new;
  }
  return refine(lo, hi, u_or(u_and(km, wm_new), u_not(wm_new)),
                u_and(kv, wm_new), wm_new, e);
}

WP_FN int8_t tri_of(bool must, bool never) { return must ? 1 : never ? -1 : 0; }

WP_FN int8_t p_eq(const AW& a, const AW& b) {
  bool single = u_eq(a.lo, a.hi) && u_eq(b.lo, b.hi) && u_eq(a.lo, b.lo);
  bool apart = u_ult(a.hi, b.lo) || u_ult(b.hi, a.lo) ||
               u_any(u_and(u_and(a.km, b.km), u_xor(a.kv, b.kv)));
  return tri_of(single, apart);
}
WP_FN int8_t p_ult(const AW& a, const AW& b) { return tri_of(u_ult(a.hi, b.lo), u_ule(b.hi, a.lo)); }
WP_FN int8_t p_ule(const AW& a, const AW& b) { return tri_of(u_ule(a.hi, b.lo), u_ult(b.hi, a.lo)); }
WP_FN int8_t p_signed(const AW& a, const AW& b, int width, int8_t unsigned_tri) {
  bool ka = u_bit(a.km, width - 1), sa = u_bit(a.kv, width - 1);
  bool kb = u_bit(b.km, width - 1), sb = u_bit(b.kv, width - 1);
  if (!(ka && kb)) return 0;
  if (sa && !sb) return 1;
  if (!sa && sb) return -1;
  return unsigned_tri;
}

// assert a < b (a <= b unless strict): returns dead | empty
WP_FN bool b_ult_true(const AW& a, const AW& b, const U& wm, bool strict,
                      AW* a2, AW* b2) {
  bool dead = false;
  U new_hi_a, new_lo_b;
  if (strict) {
    U one = u_one();
    dead = !u_any(b.hi) || u_eq(a.lo, wm);
    new_hi_a = u_umin(a.hi, u_sub(b.hi, one));
    new_lo_b = u_umax(b.lo, u_add(a.lo, one));
  } else {
    new_hi_a = u_umin(a.hi, b.hi);
    new_lo_b = u_umax(b.lo, a.lo);
  }
  bool ea, eb;
  *a2 = refine(a.lo, new_hi_a, a.km, a.kv, wm, &ea);
  *b2 = refine(new_lo_b, b.hi, b.km, b.kv, wm, &eb);
  return dead || ea || eb;
}

// ---------------------------------------------------------------- program

struct Lane {
  const int* entries;   // [n][C_COUNT]
  const int* args;
  const uint32_t* consts;  // [nc][8]
  uint32_t* bv;         // [nbv][4][8][B]
  int8_t* tri;          // [nbool][B]
  int8_t* want;         // [nbool][B]
  int lane, B;
  bool conflict;

  WP_FN const int* E(int e) const { return entries + (size_t)e * C_COUNT; }
  WP_FN int arg(int e, int k) const { return args[E(e)[C_ARGOFF] + k]; }
  WP_FN int width(int e) const { return E(e)[C_WIDTH]; }
  WP_FN bool is_const(int e) const { return E(e)[C_OP] == OP_CONST; }
  WP_FN U const_value(int e) const {
    U r; const uint32_t* c = consts + (size_t)E(e)[C_P0] * 8;
    for (int i = 0; i < 8; ++i) r.w[i] = c[i];
    return r;
  }
  WP_FN AW load(int e) const {
    const uint32_t* p = bv + (size_t)E(e)[C_SLOT] * 32 * B + lane;
    AW r;
    for (int i = 0; i < 8; ++i) {
      r.lo.w[i] = p[(size_t)(0 + i) * B];
      r.hi.w[i] = p[(size_t)(8 + i) * B];
      r.km.w[i] = p[(size_t)(16 + i) * B];
      r.kv.w[i] = p[(size_t)(24 + i) * B];
    }
    return r;
  }
  WP_FN void store(int e, const AW& a) {
    uint32_t* p = bv + (size_t)E(e)[C_SLOT] * 32 * B + lane;
    for (int i = 0; i < 8; ++i) {
      p[(size_t)(0 + i) * B] = a.lo.w[i];
      p[(size_t)(8 + i) * B] = a.hi.w[i];
      p[(size_t)(16 + i) * B] = a.km.w[i];
      p[(size_t)(24 + i) * B] = a.kv.w[i];
    }
  }
  WP_FN int8_t& tri_at(int e) { return tri[(size_t)E(e)[C_SLOT] * B + lane]; }
  WP_FN int8_t& want_at(int e) { return want[(size_t)E(e)[C_SLOT] * B + lane]; }
};

WP_LANE AW forward_bv(Lane& L, int e, bool* empty) {
  const int* E = L.E(e);
  int op = E[C_OP], width = E[C_WIDTH];
  U wm = u_wmask(width);
  *empty = false;
  switch (op) {
    case OP_CONST: {
      U v = u_and(L.const_value(e), wm);
      AW r; r.lo = v; r.hi = v; r.km = u_ones(); r.kv = v;
      return r;
    }
    case OP_ZEXT: return L.load(L.arg(e, 0));
    case OP_NOT: return f_not(L.load(L.arg(e, 0)), wm, empty);
    case OP_EXTRACT: return f_extract(L.load(L.arg(e, 0)), E[C_P0], E[C_P1], wm, empty);
    case OP_SEXT: return f_sext(L.load(L.arg(e, 0)), L.width(L.arg(e, 0)), width, wm, empty);
    case OP_CONCAT: {
      U lo = u_zero(), hi = u_zero(), km = u_not(wm), kv = u_zero();
      int off = 0;
      for (int k = E[C_NARGS] - 1; k >= 0; --k) {
        int part = L.arg(e, k);
        int w = L.width(part);
        AW p = L.load(part);
        U pwm = u_wmask(w);
        lo = u_or(lo, u_shl(p.lo, off));
        hi = u_or(hi, u_shl(p.hi, off));
        km = u_or(km, u_shl(u_and(p.km, pwm), off));
        kv = u_or(kv, u_shl(u_and(p.kv, pwm), off));
        off += w;
      }
      return refine(lo, hi, km, kv, wm, empty);
    }
    case OP_ITE: {
      int8_t c = L.tri_at(L.arg(e, 0));
      AW t = L.load(L.arg(e, 1));
      AW f = L.load(L.arg(e, 2));
      return c == 1 ? t : c == -1 ? f : join(t, f);
    }
    default: break;
  }
  AW a = L.load(L.arg(e, 0));
  AW b = L.load(L.arg(e, 1));
  switch (op) {
    case OP_ADD: return f_add(a, b, width, wm, empty);
    case OP_SUB: return f_sub(a, b, wm, empty);
    case OP_MUL: return f_mul(a, b, width, wm, empty);
    case OP_UDIV: return f_udiv(a, b, wm, empty);
    case OP_UREM: return f_urem(a, b, wm, empty);
    case OP_AND: return f_and(a, b, wm, empty);
    case OP_OR: return f_or(a, b, wm, empty);
    case OP_XOR: return f_xor(a, b, wm, empty);
    case OP_SHL: return f_shl(a, b, width, wm, empty);
    case OP_LSHR: return f_lshr(a, b, wm, empty);
    default: return f_ashr(a, b, width, wm, empty);  // OP_ASHR
  }
}

WP_LANE int8_t forward_bool(Lane& L, int e) {
  const int* E = L.E(e);
  int op = E[C_OP];
  if ((E[C_FLAGS] & F_OPAQUE) || op == OP_BVAR) return 0;
  if (op == OP_BCONST) return E[C_P0] ? 1 : -1;
  if (op >= OP_EQ && op <= OP_SLE) {
    int ea = L.arg(e, 0);
    AW a = L.load(ea), b = L.load(L.arg(e, 1));
    switch (op) {
      case OP_EQ: return p_eq(a, b);
      case OP_ULT: return p_ult(a, b);
      case OP_ULE: return p_ule(a, b);
      case OP_SLT: return p_signed(a, b, L.width(ea), p_ult(a, b));
      default: return p_signed(a, b, L.width(ea), p_ule(a, b));
    }
  }
  int8_t a = L.tri_at(L.arg(e, 0));
  if (op == OP_BNOT) return (int8_t)-a;
  int8_t b = L.tri_at(L.arg(e, 1));
  switch (op) {
    case OP_BAND: return (a == -1 || b == -1) ? -1 : (a == 1 && b == 1) ? 1 : 0;
    case OP_BOR: return (a == 1 || b == 1) ? 1 : (a == -1 && b == -1) ? -1 : 0;
    case OP_BXOR: return (a != 0 && b != 0) ? (a == b ? -1 : 1) : 0;
    default: {  // OP_BITE: (cond, then, else)
      int8_t c = a, t = b, f = L.tri_at(L.arg(e, 2));
      return c == 1 ? t : c == -1 ? f : (t == f ? t : 0);
    }
  }
}

WP_LANE void forward(Lane& L, int n, bool first) {
  for (int e = 0; e < n; ++e) {
    const int* E = L.E(e);
    if (E[C_FLAGS] & F_BOOL) {
      int8_t v = forward_bool(L, e);
      int8_t& t = L.tri_at(e);
      if (first) {
        t = v;
      } else {
        if (t != 0 && v != 0 && t != v) L.conflict = true;
        if (t == 0) t = v;
      }
      continue;
    }
    if ((E[C_FLAGS] & F_OPAQUE) || E[C_OP] == OP_VAR) {
      if (first) L.store(e, top_word(E[C_WIDTH] < 256 ? E[C_WIDTH] : 256));
      continue;
    }
    bool empty;
    AW w = forward_bv(L, e, &empty);
    if (!first) {
      bool e2;
      w = meet(w, L.load(e), u_wmask(E[C_WIDTH]), &e2);
      empty = empty || e2;
    }
    L.store(e, w);
    L.conflict = L.conflict || empty;
  }
}

WP_FN bool pushable(const Lane& L, int e) {
  const int* E = L.E(e);
  if (E[C_FLAGS] & F_OPAQUE) return false;
  switch (E[C_OP]) {
    case OP_ZEXT: case OP_EXTRACT: case OP_NOT: case OP_AND: case OP_OR:
    case OP_XOR: case OP_ADD: case OP_SUB: case OP_SHL: case OP_LSHR:
    case OP_CONCAT:
      return true;
    default:
      return false;
  }
}

struct Frame { int e, depth, k, off; };

// the word that frame f pushes into its next child; false when f is done
WP_LANE bool next_child(const Lane& L, Frame& f, int* child, AW* word) {
  const int* E = L.E(f.e);
  int op = E[C_OP], width = E[C_WIDTH];
  AW s = L.load(f.e);
  if (op == OP_CONCAT) {
    if (f.k >= E[C_NARGS]) return false;
    int part = L.arg(f.e, E[C_NARGS] - 1 - f.k);
    U pm = u_wmask(L.width(part));
    word->lo = u_zero(); word->hi = pm;
    word->km = u_and(u_lshr(s.km, f.off), pm);
    word->kv = u_and(u_lshr(s.kv, f.off), pm);
    *child = part;
    f.k += 1;
    f.off += L.width(part);
    return true;
  }
  if (f.k > 0) return false;
  f.k = 1;
  if (op == OP_ZEXT || op == OP_NOT || op == OP_EXTRACT) {
    int c = L.arg(f.e, 0);
    U wm_c = u_wmask(L.width(c));
    *child = c;
    if (op == OP_ZEXT) {
      word->lo = s.lo; word->hi = u_umin(s.hi, wm_c);
      word->km = s.km; word->kv = u_and(s.kv, wm_c);
    } else if (op == OP_NOT) {
      bool unused;
      *word = f_not(s, wm_c, &unused);
    } else {
      U wm_n = u_wmask(width);
      int low = E[C_P1];
      word->lo = u_zero(); word->hi = wm_c;
      word->km = u_shl(u_and(s.km, wm_n), low);
      word->kv = u_shl(u_and(s.kv, wm_n), low);
    }
    return true;
  }
  // binary ops with one constant side
  int a = L.arg(f.e, 0), b = L.arg(f.e, 1);
  int cn = L.is_const(a) ? a : b;
  int fr = L.is_const(a) ? b : a;
  if (!L.is_const(cn)) return false;
  U c = u_and(L.const_value(cn), u_wmask(width));
  U wm_f = u_wmask(L.width(fr));
  word->lo = u_zero(); word->hi = wm_f;
  *child = fr;
  switch (op) {
    case OP_AND: {
      U km_f = u_and(s.km, c);
      word->km = km_f; word->kv = u_and(s.kv, km_f);
      return true;
    }
    case OP_OR: {
      U km_f = u_and(s.km, u_and(u_not(c), wm_f));
      word->km = km_f; word->kv = u_and(s.kv, km_f);
      return true;
    }
    case OP_XOR:
      word->km = s.km; word->kv = u_and(u_xor(s.kv, c), s.km);
      return true;
    case OP_ADD: case OP_SUB: {
      U tm = u_and(u_trailing_known(s.km), wm_f);
      U inv = op == OP_ADD ? u_sub(s.kv, c)
              : fr == a ? u_add(s.kv, c) : u_sub(c, s.kv);
      word->km = tm; word->kv = u_and(inv, tm);
      return true;
    }
    default: {  // OP_SHL, OP_LSHR: only x op const
      if (fr != a) return false;
      int amt = amount_of(c);
      if (amt >= width) return false;
      U km_f, kv_f;
      if (op == OP_SHL) {
        km_f = u_and(u_lshr(s.km, amt), u_wmask(width - amt));
        kv_f = u_and(u_lshr(s.kv, amt), km_f);
      } else {
        km_f = u_and(u_shl(s.km, amt), wm_f);
        kv_f = u_and(u_shl(s.kv, amt), km_f);
      }
      word->km = km_f; word->kv = kv_f;
      return true;
    }
  }
}

WP_LANE void push_down(Lane& L, int root) {
  if (!pushable(L, root)) return;
  Frame stack[kPushDepth + 1];
  int sp = 0;
  stack[sp++] = Frame{root, kPushDepth, 0, 0};
  while (sp > 0) {
    Frame& f = stack[sp - 1];
    int child;
    AW word;
    if (!next_child(L, f, &child, &word)) {
      --sp;
      continue;
    }
    bool empty;
    AW met = meet(word, L.load(child), u_wmask(L.width(child)), &empty);
    if (empty) {
      L.conflict = true;
      continue;
    }
    L.store(child, met);
    if (f.depth - 1 > 0 && pushable(L, child))
      stack[sp++] = Frame{child, f.depth - 1, 0, 0};
  }
}

WP_FN void push_want(Lane& L, int e, int8_t value) {
  int8_t& cur = L.want_at(e);
  if (cur != 0 && cur != value) L.conflict = true;
  if (cur == 0) cur = value;
}

WP_FN void refine_bv(Lane& L, int e, const AW& word, bool empty) {
  bool e2;
  AW met = meet(word, L.load(e), u_wmask(L.width(e)), &e2);
  L.store(e, met);
  L.conflict = L.conflict || empty || e2;
}

WP_LANE void backward(Lane& L, int n, int nbool, const int8_t* want0) {
  for (int s = 0; s < nbool; ++s)
    L.want[(size_t)s * L.B + L.lane] = want0[(size_t)s * L.B + L.lane];
  for (int e = n - 1; e >= 0; --e) {
    const int* E = L.E(e);
    if (!(E[C_FLAGS] & F_BOOL)) continue;
    int8_t w = L.want_at(e), t = L.tri_at(e);
    if ((w == 1 && t == -1) || (w == -1 && t == 1)) L.conflict = true;
    int op = E[C_OP];
    if ((E[C_FLAGS] & F_OPAQUE) || op == OP_BCONST || op == OP_BVAR) continue;
    if (w == 0) continue;  // every push below is masked by w != 0
    if (op == OP_BNOT) {
      push_want(L, L.arg(e, 0), (int8_t)-w);
      continue;
    }
    if (op == OP_BAND || op == OP_BOR) {
      int a = L.arg(e, 0), b = L.arg(e, 1);
      int8_t whole = op == OP_BAND ? 1 : -1;  // the want that splits
      if (w == whole) {
        push_want(L, a, whole);
        push_want(L, b, whole);
      } else {
        int8_t ta = L.tri_at(a), tb = L.tri_at(b);
        if (ta == whole) push_want(L, b, (int8_t)-whole);
        if (tb == whole) push_want(L, a, (int8_t)-whole);
      }
      continue;
    }
    if (op == OP_BXOR) {
      int a = L.arg(e, 0), b = L.arg(e, 1);
      int8_t ta = L.tri_at(a), tb = L.tri_at(b);
      if (tb != 0) push_want(L, a, w == 1 ? (int8_t)-tb : tb);
      if (ta != 0) push_want(L, b, w == 1 ? (int8_t)-ta : ta);
      continue;
    }
    if (op == OP_BITE) {
      int8_t c = L.tri_at(L.arg(e, 0));
      if (c == 1) push_want(L, L.arg(e, 1), w);
      else if (c == -1) push_want(L, L.arg(e, 2), w);
      continue;
    }
    int ea = L.arg(e, 0), eb = L.arg(e, 1);
    AW a = L.load(ea), b = L.load(eb);
    U wm = u_wmask(L.width(ea));
    if (op == OP_EQ) {
      if (w != 1) continue;
      bool empty;
      AW met = meet(a, b, wm, &empty);
      refine_bv(L, ea, met, empty);
      refine_bv(L, eb, met, empty);
      push_down(L, ea);
      push_down(L, eb);
      continue;
    }
    if (op == OP_ULT || op == OP_ULE) {
      bool strict = op == OP_ULT;
      AW a2, b2;
      if (w == 1) {
        bool dead = b_ult_true(a, b, wm, strict, &a2, &b2);
        refine_bv(L, ea, a2, dead);
        refine_bv(L, eb, b2, dead);
      } else {  // !(a < b) == b <= a
        bool dead = b_ult_true(b, a, wm, !strict, &b2, &a2);
        refine_bv(L, eb, b2, dead);
        refine_bv(L, ea, a2, dead);
      }
      push_down(L, ea);
      push_down(L, eb);
    }
    // slt / sle: no backward transfer
  }
}

WP_LANE void word_lane(const int* entries, int n, const int* args,
                       const uint32_t* consts, const int8_t* want0, int B,
                       int nbool, int rounds, int lane, uint32_t* bv,
                       int8_t* tri, int8_t* want, uint8_t* conflict) {
  Lane L{entries, args, consts, bv, tri, want, lane, B, false};
  forward(L, n, true);
  for (int r = 0; r < rounds; ++r) {
    backward(L, n, nbool, want0);
    forward(L, n, false);
  }
  conflict[lane] = L.conflict ? 1 : 0;
}

}  // namespace wp

#ifdef __CUDACC__

__global__ void __launch_bounds__(wp::kThreads)
word_prop_kernel(const int* entries, int n, const int* args,
                 const uint32_t* consts, const int8_t* want0, int B,
                 int nbool, int rounds, uint32_t* bv, int8_t* tri,
                 int8_t* want, uint8_t* conflict) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  wp::word_lane(entries, n, args, consts, want0, B, nbool, rounds, lane, bv,
                tri, want, conflict);
}

extern "C" {

// Plain C entry point (bound with ctypes).  Returns the cudaError_t of the
// launch; 0 means the kernel was queued on `stream`.
int word_prop_launch(const int* entries, int n, const int* args,
                     const uint32_t* consts, const int8_t* want0, int B,
                     int nbool, int rounds, uint32_t* bv, int8_t* tri,
                     int8_t* want, uint8_t* conflict, void* stream) {
  if (B < 1 || n < 1 || nbool < 1 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  int blocks = (B + wp::kThreads - 1) / wp::kThreads;
  word_prop_kernel<<<blocks, wp::kThreads, 0, (cudaStream_t)stream>>>(
      entries, n, args, consts, want0, B, nbool, rounds, bv, tri, want,
      conflict);
  return (int)cudaGetLastError();
}

int word_prop_op_count() { return wp::OP_COUNT; }

int word_prop_entry_columns() { return wp::C_COUNT; }

}  // extern "C"

#endif  // __CUDACC__
