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
// Design.  A lane's arithmetic runs on a group of 8 threads, a limb a
// thread: thread i of the group holds limb i of every 256-bit word, so an
// abstract word is four registers a thread (its lo, hi, km and kv limb).
// Bitwise work is one instruction; comparisons, carries and reductions
// across the limbs are warp votes, shuffles and reductions within the
// group: ult compares the ballots of a < b and a > b (the highest
// differing limb wins), add and sub resolve their carries from the
// ballots of the limbs that generate and propagate one, mul sums each
// thread's column of partial products from shuffled operands, a shift
// takes its source limbs by shuffle, bit length is a max-reduction.
// Every branch depends only on the table or on such a group-wide vote, so
// a group never diverges.
//
// A block is one lane and 16 warps, the first group of each warp
// working.  The forward passes go level by level (the table's schedule: a
// node's level is one more than its args' highest); a level's nodes are
// independent, so the warps take them side by side, with a barrier
// between levels.  The backward pass runs on warp 0 alone, in the table's
// reverse order, as the batched walk does.  A walk is latency bound (each
// node a chain of dependent votes), and groups of one warp that diverge
// run one after another, so the parallel workers are whole warps, not the
// warp's other groups.
//
// The lane's state lives in shared memory for the whole launch: its bv
// planes ([slot][limb][lo, hi, km, kv], 128 B a slot), its tri-states,
// wants and starting wants (a byte a bool slot), beside the node table
// (40 B a node) that the block reads.  A thread reads and writes only its
// own limb of a word, as one 16-byte access; a bool slot is written by the
// group's first thread between two __syncwarp.  The argument list and the
// constants are read through the read-only path.  The planes go out to
// the global [slot][field][limb][lane] layout once, at the end.  At the
// node cap of 1024 a lane needs at most 128 KB of planes and 40 KB of
// table, so one lane always fits a block's 227 KB; word_prop_smem_bytes is
// the rule, and word_prop_launch refuses a program whose block does not
// fit the card before it launches.
//
// The push-down recursion is a stack of (node, depth, next child, bit
// offset) frames: the top frame in uniform registers, the frames under it
// one a thread of the group, restored by shuffle.  A frame re-reads its
// node's word, which none of its descendants can change.
//
// Bound: the state planes (128 B a bv slot a lane) are written once and
// the table read once; the operations are a few hundred 32-bit integer
// operations a node a pass a lane.  At the main path's sizes (tens to a
// few hundred nodes, 16-256 lanes) a launch is latency-bound: each group
// runs its share of the lane's nodes one after another, so the design
// keeps every step of that chain in registers and shared memory.
//
// Compiled as host C++ (no __CUDACC__), the same lane walk runs on an
// emulated group of 8 threads (word_prop_host), so the CPU tests hold the
// kernel's own arithmetic against the plain version.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WP_FN __device__ __forceinline__
#else
#include <vector>
#define WP_FN inline
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
// entry columns: ops/word_fixpoint.py:ENTRY_COLUMNS.  The last two are
// the level schedule, by position k (not by node): C_SCHED the row at
// position k of the nodes ordered by level (a node's level is one more
// than its args' highest), C_LEVEL_END the first position past that
// node's level.
enum Col : int {
  C_OP = 0, C_WIDTH, C_SLOT, C_FLAGS, C_NARGS, C_ARGOFF, C_P0, C_P1,
  C_SCHED, C_LEVEL_END,
  C_COUNT
};
constexpr int F_OPAQUE = 1;
constexpr int F_BOOL = 2;
constexpr int kPushDepth = 8;
constexpr int kLimbs = 8;                 // threads a lane
constexpr int kWarps = 16;                // warps that share a lane's block
constexpr int kThreads = 32 * kWarps;
constexpr int kDoesNotFit = -1;           // word_prop_launch: no room

// ------------------------------------------------------------ the group
// U: this thread's limb of a 256-bit word (a 32-bit value a thread);
// M: a predicate a thread.  On the card a thread holds one of each; the
// host build holds the whole group's eight and runs them in step.

#ifdef __CUDACC__

typedef uint32_t U;
typedef bool M;

WP_FN U limb_id() { return threadIdx.x & 7u; }
WP_FN unsigned group_mask() { return 0xFFu << (threadIdx.x & 24u); }
WP_FN U splat(uint32_t x) { return x; }
WP_FN U sel(M p, U a, U b) { return p ? a : b; }
WP_FN unsigned ballot(M p) {
  return (__ballot_sync(group_mask(), p) >> (threadIdx.x & 24u)) & 0xFFu;
}
// limb `src` (per thread, 0..7) of x
WP_FN U shfl(U x, U src) { return __shfl_sync(group_mask(), x, (int)src, 8); }
WP_FN U shfl_up(U x, int d) { return __shfl_up_sync(group_mask(), x, d, 8); }
WP_FN uint32_t sum_of(U x) { return __reduce_add_sync(group_mask(), x); }
WP_FN uint32_t max_of(U x) { return __reduce_max_sync(group_mask(), x); }
WP_FN U clz(U x) { return (U)__clz((int)x); }
WP_FN U mul_hi(U a, U b) { return __umulhi(a, b); }
WP_FN U popc(U x) { return (U)__popc(x); }
WP_FN int clz32(uint32_t x) { return __clz((int)x); }
WP_FN int ffs32(uint32_t x) { return __ffs((int)x); }
// a value the whole group holds alike
WP_FN uint32_t uniform(U x) { return x; }
WP_FN void sync_group() { __syncwarp(group_mask()); }
WP_FN bool group_leader() { return (threadIdx.x & 7u) == 0; }
// one limb of eight consecutive words (p[limb])
WP_FN U load_limb(const uint32_t* p) { return __ldg(p + limb_id()); }
WP_FN int load_arg(const int* p) { return __ldg(p); }

#else  // host: an emulated group of 8 threads

struct M {
  bool v[8];
};
struct U {
  uint32_t v[8];
};
#define WP_MAP(expr)                      \
  U r;                                    \
  for (int i = 0; i < 8; ++i) r.v[i] = (expr); \
  return r
#define WP_PRED(expr)                     \
  M r;                                    \
  for (int i = 0; i < 8; ++i) r.v[i] = (expr); \
  return r
inline U operator&(U a, U b) { WP_MAP(a.v[i] & b.v[i]); }
inline U operator|(U a, U b) { WP_MAP(a.v[i] | b.v[i]); }
inline U operator^(U a, U b) { WP_MAP(a.v[i] ^ b.v[i]); }
inline U operator+(U a, U b) { WP_MAP(a.v[i] + b.v[i]); }
inline U operator-(U a, U b) { WP_MAP(a.v[i] - b.v[i]); }
inline U operator*(U a, U b) { WP_MAP(a.v[i] * b.v[i]); }
inline U operator&(U a, uint32_t b) { WP_MAP(a.v[i] & b); }
inline U operator+(U a, uint32_t b) { WP_MAP(a.v[i] + b); }
inline U operator-(U a, uint32_t b) { WP_MAP(a.v[i] - b); }
inline U operator~(U a) { WP_MAP(~a.v[i]); }
// shifts as the card's shl / shr: an amount of 32 or more gives 0
inline uint32_t host_shl(uint32_t x, uint32_t s) { return s >= 32 ? 0u : x << s; }
inline uint32_t host_shr(uint32_t x, uint32_t s) { return s >= 32 ? 0u : x >> s; }
inline U operator<<(U a, U s) { WP_MAP(host_shl(a.v[i], s.v[i])); }
inline U operator>>(U a, U s) { WP_MAP(host_shr(a.v[i], s.v[i])); }
inline U operator<<(U a, uint32_t s) { WP_MAP(host_shl(a.v[i], s)); }
inline U operator>>(U a, uint32_t s) { WP_MAP(host_shr(a.v[i], s)); }
inline M operator<(U a, U b) { WP_PRED(a.v[i] < b.v[i]); }
inline M operator<=(U a, U b) { WP_PRED(a.v[i] <= b.v[i]); }
inline M operator==(U a, U b) { WP_PRED(a.v[i] == b.v[i]); }
inline M operator!=(U a, U b) { WP_PRED(a.v[i] != b.v[i]); }
inline M operator<(U a, uint32_t b) { WP_PRED(a.v[i] < b); }
inline M operator>=(U a, uint32_t b) { WP_PRED(a.v[i] >= b); }
inline M operator==(U a, uint32_t b) { WP_PRED(a.v[i] == b); }
inline M operator!=(U a, uint32_t b) { WP_PRED(a.v[i] != b); }
inline M operator&(M a, M b) { WP_PRED(a.v[i] && b.v[i]); }

// set when a value that should be uniform across the group is not
inline int& host_fault() {
  static thread_local int fault = 0;
  return fault;
}
inline U limb_id() { WP_MAP((uint32_t)i); }
inline U splat(uint32_t x) { WP_MAP(x); }
inline U sel(M p, U a, U b) { WP_MAP(p.v[i] ? a.v[i] : b.v[i]); }
inline unsigned ballot(M p) {
  unsigned r = 0;
  for (int i = 0; i < 8; ++i) r |= (unsigned)p.v[i] << i;
  return r;
}
inline U shfl(U x, U src) { WP_MAP(x.v[src.v[i] & 7u]); }
inline U shfl_up(U x, int d) { WP_MAP(i >= d ? x.v[i - d] : x.v[i]); }
inline uint32_t sum_of(U x) {
  uint32_t s = 0;
  for (int i = 0; i < 8; ++i) s += x.v[i];
  return s;
}
inline uint32_t max_of(U x) {
  uint32_t m = 0;
  for (int i = 0; i < 8; ++i) m = x.v[i] > m ? x.v[i] : m;
  return m;
}
inline U clz(U x) { WP_MAP(x.v[i] ? (uint32_t)__builtin_clz(x.v[i]) : 32u); }
inline U mul_hi(U a, U b) { WP_MAP((uint32_t)(((uint64_t)a.v[i] * b.v[i]) >> 32)); }
inline U popc(U x) { WP_MAP((uint32_t)__builtin_popcount(x.v[i])); }
inline int clz32(uint32_t x) { return x ? __builtin_clz(x) : 32; }
inline int ffs32(uint32_t x) { return __builtin_ffs((int)x); }
inline uint32_t uniform(U x) {
  for (int i = 1; i < 8; ++i)
    if (x.v[i] != x.v[0]) host_fault() = 1;
  return x.v[0];
}
inline void sync_group() {}
inline bool group_leader() { return true; }
inline U load_limb(const uint32_t* p) { WP_MAP(p[i]); }
inline int load_arg(const int* p) { return *p; }
#undef WP_MAP
#undef WP_PRED

#endif  // __CUDACC__

WP_FN bool any_of(M p) { return ballot(p) != 0; }

struct AW { U lo, hi, km, kv; };

// ---------------------------------------------------------------- u256

WP_FN U u_zero() { return splat(0u); }
WP_FN U u_ones() { return splat(0xFFFFFFFFu); }
WP_FN U u_one() { return sel(limb_id() == 0u, splat(1u), splat(0u)); }
WP_FN U u_wmask(int width) {  // 2^width - 1, width in [0, 256]
  U low = limb_id() << 5u;  // the limb's first bit
  U w = splat((uint32_t)width);
  U part = (splat(1u) << ((w - low) & 31u)) - 1u;
  return sel(low + 32u <= w, u_ones(), sel(w <= low, u_zero(), part));
}
WP_FN bool u_any(U a) { return any_of(a != 0u); }
WP_FN bool u_eq(U a, U b) { return !any_of(a != b); }
// the highest differing limb decides
WP_FN bool u_ult(U a, U b) { return ballot(a < b) > ballot(b < a); }
WP_FN bool u_ule(U a, U b) { return !u_ult(b, a); }
WP_FN U u_umin(U a, U b) { return u_ult(a, b) ? a : b; }
WP_FN U u_umax(U a, U b) { return u_ult(a, b) ? b : a; }
// the carry into each limb (bit i) and out of the top (bit 8), from the
// limbs that generate one and those that pass one on: the carries of
// (g | p) + g
WP_FN unsigned carries(unsigned g, unsigned p) {
  unsigned x = g | p;
  return (x + g) ^ x ^ g;
}
WP_FN U u_add_carry(U a, U b, bool* carry_out) {
  U s = a + b;
  unsigned c = carries(ballot(s < a), ballot(s == 0xFFFFFFFFu));
  *carry_out = (c >> 8) & 1u;
  return s + ((splat(c) >> limb_id()) & 1u);
}
WP_FN U u_add(U a, U b) { bool c; return u_add_carry(a, b, &c); }
WP_FN U u_sub(U a, U b) {
  U d = a - b;
  unsigned c = carries(ballot(a < b), ballot(d == 0u));
  return d - ((splat(c) >> limb_id()) & 1u);
}
WP_FN U u_mul(U a, U b) {  // mod 2^256: each thread sums its column
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
// shifts by an amount >= 0; 256 and more give 0
WP_FN U u_shl(U a, int amt) {
  if (amt >= 256) return u_zero();
  uint32_t word = (uint32_t)amt >> 5, bit = (uint32_t)amt & 31u;
  U i = limb_id();
  U x = sel(i >= word, shfl(a, (i - word) & 7u), u_zero());
  U y = sel(i >= word + 1u, shfl(a, (i - word - 1u) & 7u), u_zero());
  return bit ? (x << bit) | (y >> (32u - bit)) : x;
}
WP_FN U u_lshr(U a, int amt) {
  if (amt >= 256) return u_zero();
  uint32_t word = (uint32_t)amt >> 5, bit = (uint32_t)amt & 31u;
  U i = limb_id();
  U x = sel(i + word < 8u, shfl(a, (i + word) & 7u), u_zero());
  U y = sel(i + word + 1u < 8u, shfl(a, (i + word + 1u) & 7u), u_zero());
  return bit ? (x >> bit) | (y << (32u - bit)) : x;
}
WP_FN bool u_bit(U x, int index) {
  return (ballot(((x >> (uint32_t)(index & 31)) & 1u) != 0u) >> (index >> 5)) & 1u;
}
// the largest of the limbs' own bit lengths
WP_FN int u_bit_length(U x) {
  return (int)max_of(sel(x != 0u, (limb_id() << 5u) + 32u - clz(x), u_zero()));
}
WP_FN int u_popcount(U x) { return (int)sum_of(popc(x)); }
// bits strictly above the most significant set bit (all ones for 0):
// ones above the highest nonzero limb h, the bits above its top bit in h
WP_FN U u_prefix_mask(U x) {
  uint32_t above_h = 32u - (uint32_t)clz32(ballot(x != 0u));  // h + 1
  U i = limb_id();
  U in_h = splat(0xFFFFFFFEu) << ((splat(31u) - clz(x)) & 31u);
  return sel(i >= above_h, u_ones(), sel(i + 1u == splat(above_h), in_h, u_zero()));
}
// contiguous known bits from bit 0
WP_FN U u_trailing_known(U km) {
  unsigned open = ballot(km != 0xFFFFFFFFu);
  uint32_t j = open ? (uint32_t)(ffs32(open) - 1) : 8u;
  U i = limb_id();
  return sel(i < j, u_ones(), sel(i == j, km & ~(km + 1u), u_zero()));
}
// a shift amount from a word: any high limb makes it 257, the overflow
// representative
WP_FN int amount_of(U a) {
  if (ballot(a != 0u) & 0xFEu) return 257;
  uint32_t a0 = uniform(shfl(a, u_zero()));
  return a0 > 257u ? 257 : (int)a0;
}

// ---------------------------------------------------------------- domains

WP_FN AW top_word(int width) {
  AW t; U wm = u_wmask(width);
  t.lo = u_zero(); t.hi = wm; t.km = ~wm; t.kv = u_zero();
  return t;
}

WP_FN AW refine(U lo, U hi, U km, U kv, U wm, bool* empty) {
  kv = kv & km;
  U maxv = kv | (~km & wm);
  lo = u_umax(lo, kv);
  hi = u_umin(hi, maxv);
  U agree = u_prefix_mask(lo ^ hi);
  bool conflict = u_any(km & agree & (kv ^ (lo & agree)));
  km = km | agree;
  kv = (kv | (lo & agree)) & km;
  *empty = u_ult(hi, lo) | conflict;
  AW r; r.lo = lo; r.hi = hi; r.km = km; r.kv = kv;
  return r;
}

WP_FN AW meet(const AW& a, const AW& b, U wm, bool* empty) {
  bool conflict = u_any(a.km & b.km & (a.kv ^ b.kv));
  U km = a.km | b.km;
  AW r = refine(u_umax(a.lo, b.lo), u_umin(a.hi, b.hi), km,
                (a.kv | b.kv) & km, wm, empty);
  *empty = *empty | conflict;
  return r;
}

WP_FN AW join(const AW& a, const AW& b) {
  AW r;
  r.km = a.km & b.km & ~(a.kv ^ b.kv);
  r.kv = a.kv & r.km;
  r.lo = u_umin(a.lo, b.lo);
  r.hi = u_umax(a.hi, b.hi);
  return r;
}

// ---------------------------------------------------------------- transfers
// Each forward transfer returns its word before the refine that every one
// of them ends in; forward_bv refines once, so the refine's code is one
// copy, not one a transfer.

WP_FN AW raw(U lo, U hi, U km, U kv) { AW r; r.lo = lo; r.hi = hi; r.km = km; r.kv = kv; return r; }

WP_FN AW f_add(const AW& a, const AW& b, int width, U wm) {
  bool c_lo, c_hi;
  U s_lo = u_add_carry(a.lo, b.lo, &c_lo);
  U s_hi = u_add_carry(a.hi, b.hi, &c_hi);
  bool w_lo = width == 256 ? c_lo : u_bit(s_lo, width);
  bool w_hi = width == 256 ? c_hi : u_bit(s_hi, width);
  bool same = w_lo == w_hi;
  U tm = u_trailing_known(a.km) & u_trailing_known(b.km) & wm;
  return raw(same ? s_lo & wm : u_zero(), same ? s_hi & wm : wm, tm | ~wm,
             u_add(a.kv, b.kv) & tm);
}

WP_FN AW f_sub(const AW& a, const AW& b, U wm) {
  bool same = u_ult(a.lo, b.hi) == u_ult(a.hi, b.lo);
  U tm = u_trailing_known(a.km) & u_trailing_known(b.km) & wm;
  return raw(same ? u_sub(a.lo, b.hi) & wm : u_zero(),
             same ? u_sub(a.hi, b.lo) & wm : wm, tm | ~wm,
             u_sub(a.kv, b.kv) & tm);
}

WP_FN AW f_mul(const AW& a, const AW& b, int width, U wm) {
  U tm = u_trailing_known(a.km) & u_trailing_known(b.km) & wm;
  AW r = raw(u_zero(), wm, tm | ~wm, u_mul(a.kv, b.kv) & tm);
  if (u_bit_length(a.hi) + u_bit_length(b.hi) <= width) {  // fits
    r.lo = u_mul(a.lo, b.lo);
    r.hi = u_mul(a.hi, b.hi);
  }
  return r;
}

WP_FN AW f_udiv(const AW& a, const AW& b, U wm) {
  bool bz = !u_any(b.hi);
  bool nz = u_any(b.lo);
  int bl = u_bit_length(b.lo) - 1;
  int amt = bl > 0 ? bl : 0;
  U lo = bz ? wm : u_lshr(a.lo, u_bit_length(b.hi));
  U hi = nz ? u_lshr(a.hi, amt) : wm;
  bool pow2 = nz & u_eq(b.lo, b.hi) & (u_popcount(b.lo) == 1);
  U km = ~wm, kv = u_zero();
  if (pow2) {
    km = u_lshr(a.km, amt) | ~u_lshr(u_ones(), amt) | km;
    kv = u_lshr(a.kv, amt) & km & wm;
    lo = u_lshr(a.lo, amt);
  }
  return raw(lo, hi, km, kv);
}

WP_FN AW f_urem(const AW& a, const AW& b, U wm) {
  U one = u_one();
  bool nz = u_any(b.lo);
  bool pow2 = nz & u_eq(b.lo, b.hi) & (u_popcount(b.lo) == 1);
  if ((!u_any(b.hi)) | (nz & u_ult(a.hi, b.lo))) return a;
  U mask = u_sub(b.lo, one);
  if (pow2) {
    U km = a.km | ~mask | ~wm;
    return raw(u_zero(), u_umin(a.hi, mask), km, a.kv & mask & km & wm);
  }
  return raw(u_zero(), nz ? u_umin(a.hi, u_sub(b.hi, one)) : a.hi, ~wm,
             u_zero());
}

WP_FN AW f_and(const AW& a, const AW& b) {
  U k0 = (a.km & ~a.kv) | (b.km & ~b.kv);
  U k1 = a.km & a.kv & b.km & b.kv;
  return raw(u_zero(), u_umin(a.hi, b.hi), k0 | k1, k1);
}

WP_FN AW f_or(const AW& a, const AW& b, U wm) {
  U k1 = (a.km & a.kv) | (b.km & b.kv);
  U k0 = a.km & ~a.kv & b.km & ~b.kv;
  return raw(u_umax(a.lo, b.lo), wm, k0 | k1, k1);
}

WP_FN AW f_xor(const AW& a, const AW& b, U wm) {
  U km = a.km & b.km;
  return raw(u_zero(), wm, km, (a.kv ^ b.kv) & km);
}

WP_FN AW f_not(const AW& a, U wm) {
  return raw(u_sub(wm, a.hi), u_sub(wm, a.lo), (a.km & wm) | ~wm,
             ~a.kv & a.km & wm);
}

WP_FN AW f_shl(const AW& a, const AW& b, int width, U wm) {
  AW r = raw(u_zero(), wm, ~wm, u_zero());
  if (u_eq(b.lo, b.hi)) {  // a known amount
    int amt = amount_of(b.lo);
    U km_s = u_shl(a.km, amt) | ~u_shl(u_ones(), amt);
    r.km = (km_s & wm) | ~wm;
    r.kv = u_shl(a.kv, amt) & r.km & wm;
    if (u_bit_length(a.hi) + amt <= width) {
      r.lo = u_shl(a.lo, amt);
      r.hi = u_shl(a.hi, amt);
    }
  }
  return r;
}

WP_FN AW f_lshr(const AW& a, const AW& b, U wm) {
  AW r = raw(u_zero(), a.hi, ~wm, u_zero());
  if (u_eq(b.lo, b.hi)) {  // a known amount
    int amt = amount_of(b.lo);
    r.km = u_lshr(a.km, amt) | ~u_lshr(u_ones(), amt) | ~wm;
    r.kv = u_lshr(a.kv, amt) & r.km & wm;
    r.lo = u_lshr(a.lo, amt);
    r.hi = u_lshr(a.hi, amt);
  }
  return r;
}

WP_FN AW f_extract(const AW& a, int high, int low, U wm_new) {
  U km = (u_lshr(a.km, low) & wm_new) | ~wm_new;
  U kv = u_lshr(a.kv, low) & wm_new & km;
  bool keep = u_ule(a.hi, u_wmask(high + 1));
  return raw(keep ? u_lshr(a.lo, low) : u_zero(),
             keep ? u_lshr(a.hi, low) : wm_new, km, kv);
}

WP_FN AW f_sext(const AW& a, int old_width, int new_width, U wm_new) {
  U wm_old = u_wmask(old_width);
  U hmask = u_wmask(new_width) & ~wm_old;
  bool sign_known = u_bit(a.km, old_width - 1);
  bool sign_val = u_bit(a.kv, old_width - 1);
  U lo, hi, km, kv;
  if (sign_known & sign_val) {
    km = a.km | hmask; kv = (a.kv & wm_old) | hmask;
    lo = a.lo | hmask; hi = a.hi | hmask;
  } else if (sign_known) {
    km = a.km | hmask; kv = a.kv & wm_old; lo = a.lo; hi = a.hi;
  } else {
    km = (a.km & wm_old) | ~wm_new; kv = a.kv & wm_old;
    lo = u_zero(); hi = wm_new;
  }
  return raw(lo, hi, (km & wm_new) | ~wm_new, kv & wm_new);
}

WP_FN int tri_of(bool must, bool never) { return must ? 1 : never ? -1 : 0; }

WP_FN int p_eq(const AW& a, const AW& b) {
  bool single = u_eq(a.lo, a.hi) & u_eq(b.lo, b.hi) & u_eq(a.lo, b.lo);
  bool apart = u_ult(a.hi, b.lo) | u_ult(b.hi, a.lo) |
               u_any(a.km & b.km & (a.kv ^ b.kv));
  return tri_of(single, apart);
}
WP_FN int p_ult(const AW& a, const AW& b) { return tri_of(u_ult(a.hi, b.lo), u_ule(b.hi, a.lo)); }
WP_FN int p_ule(const AW& a, const AW& b) { return tri_of(u_ule(a.hi, b.lo), u_ult(b.hi, a.lo)); }
WP_FN int p_signed(const AW& a, const AW& b, int width, int unsigned_tri) {
  bool ka = u_bit(a.km, width - 1), sa = u_bit(a.kv, width - 1);
  bool kb = u_bit(b.km, width - 1), sb = u_bit(b.kv, width - 1);
  if (!(ka && kb)) return 0;
  if (sa && !sb) return 1;
  if (!sa && sb) return -1;
  return unsigned_tri;
}

// assert a < b (a <= b unless strict): returns dead | empty
WP_FN bool b_ult_true(const AW& a, const AW& b, U wm, bool strict,
                      AW* a2, AW* b2) {
  bool dead = false;
  U new_hi_a, new_lo_b;
  if (strict) {
    U one = u_one();
    dead = (!u_any(b.hi)) | u_eq(a.lo, wm);
    new_hi_a = u_umin(a.hi, u_sub(b.hi, one));
    new_lo_b = u_umax(b.lo, u_add(a.lo, one));
  } else {
    new_hi_a = u_umin(a.hi, b.hi);
    new_lo_b = u_umax(b.lo, a.lo);
  }
  bool ea, eb;
  *a2 = refine(a.lo, new_hi_a, a.km, a.kv, wm, &ea);
  *b2 = refine(new_lo_b, b.hi, b.km, b.kv, wm, &eb);
  return dead | ea | eb;
}

// ---------------------------------------------------------------- program

// One lane's view: the table (shared by the block) and the lane's state.
struct Lane {
  const int* entries;      // [n][C_COUNT], shared memory
  const int* args;         // global, read-only
  const uint32_t* consts;  // [nc][8], global, read-only
  uint32_t* bv;            // shared: [nbv][8 limbs][4 fields] of this lane
  int8_t* tri;             // [nbool] of this lane
  int8_t* want;            // [nbool]
  const int8_t* want0;     // [nbool]
  bool conflict;

  WP_FN const int* E(int e) const { return entries + e * C_COUNT; }
  WP_FN int arg(int e, int k) const { return load_arg(args + E(e)[C_ARGOFF] + k); }
  WP_FN int width(int e) const { return E(e)[C_WIDTH]; }
  WP_FN bool is_const(int e) const { return E(e)[C_OP] == OP_CONST; }
  WP_FN U const_value(int e) const {
    return load_limb(consts + (size_t)E(e)[C_P0] * 8);
  }
  WP_FN AW load(int e) const {
    AW r;
#ifdef __CUDACC__
    uint4 q = reinterpret_cast<const uint4*>(bv)[E(e)[C_SLOT] * 8 + limb_id()];
    r.lo = q.x; r.hi = q.y; r.km = q.z; r.kv = q.w;
#else
    const uint32_t* p = bv + E(e)[C_SLOT] * 32;
    for (int i = 0; i < 8; ++i) {
      r.lo.v[i] = p[4 * i]; r.hi.v[i] = p[4 * i + 1];
      r.km.v[i] = p[4 * i + 2]; r.kv.v[i] = p[4 * i + 3];
    }
#endif
    return r;
  }
  WP_FN void store(int e, const AW& a) {
#ifdef __CUDACC__
    reinterpret_cast<uint4*>(bv)[E(e)[C_SLOT] * 8 + limb_id()] =
        make_uint4(a.lo, a.hi, a.km, a.kv);
#else
    uint32_t* p = bv + E(e)[C_SLOT] * 32;
    for (int i = 0; i < 8; ++i) {
      p[4 * i] = a.lo.v[i]; p[4 * i + 1] = a.hi.v[i];
      p[4 * i + 2] = a.km.v[i]; p[4 * i + 3] = a.kv.v[i];
    }
#endif
  }
  WP_FN int tri_at(int e) const { return tri[E(e)[C_SLOT]]; }
  WP_FN int want_at(int e) const { return want[E(e)[C_SLOT]]; }
  // a bool slot is written by the group's first thread, after every
  // thread's earlier reads and before any later one
  WP_FN void put(int8_t* p, int v) const {
    sync_group();
    if (group_leader()) *p = (int8_t)v;
    sync_group();
  }
  WP_FN void set_tri(int e, int v) { put(tri + E(e)[C_SLOT], v); }
  WP_FN void set_want(int e, int v) { put(want + E(e)[C_SLOT], v); }
};

WP_FN AW forward_bv(Lane& L, int e, bool* empty) {
  const int* E = L.E(e);
  int op = E[C_OP], width = E[C_WIDTH];
  U wm = u_wmask(width);
  *empty = false;
  AW w;
  switch (op) {
    case OP_CONST: {
      U v = L.const_value(e) & wm;
      return raw(v, v, u_ones(), v);
    }
    case OP_ZEXT: return L.load(L.arg(e, 0));
    case OP_ITE: {
      int c = L.tri_at(L.arg(e, 0));
      AW t = L.load(L.arg(e, 1));
      AW f = L.load(L.arg(e, 2));
      return c == 1 ? t : c == -1 ? f : join(t, f);
    }
    case OP_NOT: w = f_not(L.load(L.arg(e, 0)), wm); break;
    case OP_EXTRACT: w = f_extract(L.load(L.arg(e, 0)), E[C_P0], E[C_P1], wm); break;
    case OP_SEXT: w = f_sext(L.load(L.arg(e, 0)), L.width(L.arg(e, 0)), width, wm); break;
    case OP_CONCAT: {
      w = raw(u_zero(), u_zero(), ~wm, u_zero());
      int off = 0;
      for (int k = E[C_NARGS] - 1; k >= 0; --k) {
        int part = L.arg(e, k);
        int pw = L.width(part);
        AW p = L.load(part);
        U pwm = u_wmask(pw);
        w.lo = w.lo | u_shl(p.lo, off);
        w.hi = w.hi | u_shl(p.hi, off);
        w.km = w.km | u_shl(p.km & pwm, off);
        w.kv = w.kv | u_shl(p.kv & pwm, off);
        off += pw;
      }
      break;
    }
    default: {
      AW a = L.load(L.arg(e, 0));
      AW b = L.load(L.arg(e, 1));
      switch (op) {
        case OP_ADD: w = f_add(a, b, width, wm); break;
        case OP_SUB: w = f_sub(a, b, wm); break;
        case OP_MUL: w = f_mul(a, b, width, wm); break;
        case OP_UDIV: w = f_udiv(a, b, wm); break;
        case OP_UREM: w = f_urem(a, b, wm); break;
        case OP_AND: w = f_and(a, b); break;
        case OP_OR: w = f_or(a, b, wm); break;
        case OP_XOR: w = f_xor(a, b, wm); break;
        case OP_SHL: w = f_shl(a, b, width, wm); break;
        case OP_LSHR: w = f_lshr(a, b, wm); break;
        default: {  // OP_ASHR: lshr when the sign is known 0, else top
          if (!(u_bit(a.km, width - 1) & !u_bit(a.kv, width - 1)))
            return top_word(width);
          w = f_lshr(a, b, wm);
        }
      }
    }
  }
  return refine(w.lo, w.hi, w.km, w.kv, wm, empty);
}

WP_FN int forward_bool(Lane& L, int e) {
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
  int a = L.tri_at(L.arg(e, 0));
  if (op == OP_BNOT) return -a;
  int b = L.tri_at(L.arg(e, 1));
  switch (op) {
    case OP_BAND: return (a == -1 || b == -1) ? -1 : (a == 1 && b == 1) ? 1 : 0;
    case OP_BOR: return (a == 1 || b == 1) ? 1 : (a == -1 && b == -1) ? -1 : 0;
    case OP_BXOR: return (a != 0 && b != 0) ? (a == b ? -1 : 1) : 0;
    default: {  // OP_BITE: (cond, then, else)
      int c = a, t = b, f = L.tri_at(L.arg(e, 2));
      return c == 1 ? t : c == -1 ? f : (t == f ? t : 0);
    }
  }
}

// One node of a forward pass.  A node reads its args' state of this pass
// and its own of the last, and writes only its own slot, so a pass gives
// the same planes in any order that puts args first: the level schedule
// lets the warps of a block take a level's nodes side by side.
WP_FN void forward_node(Lane& L, int e, bool first) {
  const int* E = L.E(e);
  if (E[C_FLAGS] & F_BOOL) {
    int v = forward_bool(L, e);
    int t = L.tri_at(e);
    if (first) {
      L.set_tri(e, v);
    } else {
      if (t != 0 && v != 0 && t != v) L.conflict = true;
      if (t == 0 && v != 0) L.set_tri(e, v);
    }
    return;
  }
  if ((E[C_FLAGS] & F_OPAQUE) || E[C_OP] == OP_VAR) {
    if (first) L.store(e, top_word(E[C_WIDTH] < 256 ? E[C_WIDTH] : 256));
    return;
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
WP_FN bool next_child(const Lane& L, Frame& f, int* child, AW* word) {
  const int* E = L.E(f.e);
  int op = E[C_OP], width = E[C_WIDTH];
  AW s = L.load(f.e);
  if (op == OP_CONCAT) {
    if (f.k >= E[C_NARGS]) return false;
    int part = L.arg(f.e, E[C_NARGS] - 1 - f.k);
    U pm = u_wmask(L.width(part));
    word->lo = u_zero(); word->hi = pm;
    word->km = u_lshr(s.km, f.off) & pm;
    word->kv = u_lshr(s.kv, f.off) & pm;
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
      word->km = s.km; word->kv = s.kv & wm_c;
    } else if (op == OP_NOT) {
      AW r = f_not(s, wm_c);
      bool unused;
      *word = refine(r.lo, r.hi, r.km, r.kv, wm_c, &unused);
    } else {
      U wm_n = u_wmask(width);
      int low = E[C_P1];
      word->lo = u_zero(); word->hi = wm_c;
      word->km = u_shl(s.km & wm_n, low);
      word->kv = u_shl(s.kv & wm_n, low);
    }
    return true;
  }
  // binary ops with one constant side
  int a = L.arg(f.e, 0), b = L.arg(f.e, 1);
  int cn = L.is_const(a) ? a : b;
  int fr = L.is_const(a) ? b : a;
  if (!L.is_const(cn)) return false;
  U c = L.const_value(cn) & u_wmask(width);
  U wm_f = u_wmask(L.width(fr));
  word->lo = u_zero(); word->hi = wm_f;
  *child = fr;
  switch (op) {
    case OP_AND: {
      U km_f = s.km & c;
      word->km = km_f; word->kv = s.kv & km_f;
      return true;
    }
    case OP_OR: {
      U km_f = s.km & ~c & wm_f;
      word->km = km_f; word->kv = s.kv & km_f;
      return true;
    }
    case OP_XOR:
      word->km = s.km; word->kv = (s.kv ^ c) & s.km;
      return true;
    case OP_ADD: case OP_SUB: {
      U tm = u_trailing_known(s.km) & wm_f;
      U inv = op == OP_ADD ? u_sub(s.kv, c)
              : fr == a ? u_add(s.kv, c) : u_sub(c, s.kv);
      word->km = tm; word->kv = inv & tm;
      return true;
    }
    default: {  // OP_SHL, OP_LSHR: only x op const
      if (fr != a) return false;
      int amt = amount_of(c);
      if (amt >= width) return false;
      U km_f, kv_f;
      if (op == OP_SHL) {
        km_f = u_lshr(s.km, amt) & u_wmask(width - amt);
        kv_f = u_lshr(s.kv, amt) & km_f;
      } else {
        km_f = u_shl(s.km, amt) & wm_f;
        kv_f = u_shl(s.kv, amt) & km_f;
      }
      word->km = km_f; word->kv = kv_f;
      return true;
    }
  }
}

// The frames under the top one, one a thread of the group: thread j holds
// frame j (at most kPushDepth - 1 of them, since depths run from
// kPushDepth down to 1).
struct Saved {
  U e, depth, k, off;
  WP_FN void put(int j, const Frame& f) {
    M here = limb_id() == (uint32_t)j;
    e = sel(here, splat((uint32_t)f.e), e);
    depth = sel(here, splat((uint32_t)f.depth), depth);
    k = sel(here, splat((uint32_t)f.k), k);
    off = sel(here, splat((uint32_t)f.off), off);
  }
  WP_FN Frame get(int j) const {
    U src = splat((uint32_t)j);
    Frame f;
    f.e = (int)uniform(shfl(e, src));
    f.depth = (int)uniform(shfl(depth, src));
    f.k = (int)uniform(shfl(k, src));
    f.off = (int)uniform(shfl(off, src));
    return f;
  }
};

WP_FN void push_down(Lane& L, int root) {
  if (!pushable(L, root)) return;
  Saved saved{u_zero(), u_zero(), u_zero(), u_zero()};
  Frame top{root, kPushDepth, 0, 0};
  int sp = 1;  // frames on the stack, the top one included
  while (sp > 0) {
    int child;
    AW word;
    if (!next_child(L, top, &child, &word)) {
      if (--sp > 0) top = saved.get(sp - 1);
      continue;
    }
    bool empty;
    AW met = meet(word, L.load(child), u_wmask(L.width(child)), &empty);
    if (empty) {
      L.conflict = true;
      continue;
    }
    L.store(child, met);
    if (top.depth - 1 > 0 && pushable(L, child)) {
      saved.put(sp - 1, top);
      top = Frame{child, top.depth - 1, 0, 0};
      ++sp;
    }
  }
}

WP_FN void push_want(Lane& L, int e, int value) {
  int cur = L.want_at(e);
  if (cur != 0 && cur != value) L.conflict = true;
  if (cur == 0) L.set_want(e, value);
}

WP_FN void refine_bv(Lane& L, int e, const AW& word, bool empty) {
  bool e2;
  AW met = meet(word, L.load(e), u_wmask(L.width(e)), &e2);
  L.store(e, met);
  L.conflict = L.conflict || empty || e2;
}

WP_FN void backward(Lane& L, int n, int nbool) {
  sync_group();
#ifdef __CUDACC__
  for (int s = (int)limb_id(); s < nbool; s += kLimbs) L.want[s] = L.want0[s];
#else
  for (int s = 0; s < nbool; ++s) L.want[s] = L.want0[s];
#endif
  sync_group();
  for (int e = n - 1; e >= 0; --e) {
    const int* E = L.E(e);
    if (!(E[C_FLAGS] & F_BOOL)) continue;
    int w = L.want_at(e), t = L.tri_at(e);
    if ((w == 1 && t == -1) || (w == -1 && t == 1)) L.conflict = true;
    int op = E[C_OP];
    if ((E[C_FLAGS] & F_OPAQUE) || op == OP_BCONST || op == OP_BVAR) continue;
    if (w == 0) continue;  // every push below is masked by w != 0
    if (op == OP_BNOT) {
      push_want(L, L.arg(e, 0), -w);
      continue;
    }
    if (op == OP_BAND || op == OP_BOR) {
      int a = L.arg(e, 0), b = L.arg(e, 1);
      int whole = op == OP_BAND ? 1 : -1;  // the want that splits
      if (w == whole) {
        push_want(L, a, whole);
        push_want(L, b, whole);
      } else {
        int ta = L.tri_at(a), tb = L.tri_at(b);
        if (ta == whole) push_want(L, b, -whole);
        if (tb == whole) push_want(L, a, -whole);
      }
      continue;
    }
    if (op == OP_BXOR) {
      int a = L.arg(e, 0), b = L.arg(e, 1);
      int ta = L.tri_at(a), tb = L.tri_at(b);
      if (tb != 0) push_want(L, a, w == 1 ? -tb : tb);
      if (ta != 0) push_want(L, b, w == 1 ? -ta : ta);
      continue;
    }
    if (op == OP_BITE) {
      int c = L.tri_at(L.arg(e, 0));
      if (c == 1) push_want(L, L.arg(e, 1), w);
      else if (c == -1) push_want(L, L.arg(e, 2), w);
      continue;
    }
    if (op == OP_SLT || op == OP_SLE) continue;  // no backward transfer
    if (op == OP_EQ && w != 1) continue;
    int ea = L.arg(e, 0), eb = L.arg(e, 1);
    AW a = L.load(ea), b = L.load(eb);
    U wm = u_wmask(L.width(ea));
    // the two refined words, in the order they are met into the planes
    int first = ea, second = eb;
    AW w1, w2;
    bool dead;
    if (op == OP_EQ) {
      w1 = meet(a, b, wm, &dead);
      w2 = w1;
    } else {
      bool strict = op == OP_ULT;
      if (w == 1) {
        dead = b_ult_true(a, b, wm, strict, &w1, &w2);
      } else {  // !(a < b) == b <= a
        dead = b_ult_true(b, a, wm, !strict, &w1, &w2);
        first = eb;
        second = ea;
      }
    }
    refine_bv(L, first, w1, dead);
    refine_bv(L, second, w2, dead);
    for (int side = 0; side < 2; ++side) push_down(L, side ? eb : ea);
  }
}

// Shared memory of a block: the lane's planes (128 B a bv slot), its
// conflict flag and three bytes a bool slot (tri-states, wants, starting
// wants), and the node table (40 B a row).
inline size_t smem_bytes(int n, int nbool) {
  size_t lane = (size_t)(n - nbool) * 128 + 4 + 3 * (size_t)nbool;
  return lane + (size_t)n * C_COUNT * 4;
}

}  // namespace wp

extern "C" {

// Bytes of dynamic shared memory of one block of a program of n nodes
// (nbool of them bool): the rule word_prop_launch holds against the card.
int word_prop_smem_bytes(int n, int nbool) {
  return (int)wp::smem_bytes(n, nbool);
}

}  // extern "C"

#ifdef __CUDACC__

__global__ void __launch_bounds__(wp::kThreads, 1)
word_prop_kernel(const int* __restrict__ entries, int n,
                 const int* __restrict__ args,
                 const uint32_t* __restrict__ consts,
                 const int8_t* __restrict__ want0, int B, int nbool,
                 int rounds, uint32_t* bv, int8_t* tri, int8_t* want,
                 uint8_t* conflict) {
  using namespace wp;
  extern __shared__ __align__(16) uint32_t smem[];
  const int nbv = n - nbool;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const bool worker = (tid & 31) < kLimbs;  // the warp's first group
  const int lane = blockIdx.x;
  uint32_t* planes = smem;
  int* table = (int*)(planes + (size_t)nbv * 32);
  int* conflict_s = table + n * C_COUNT;
  int8_t* tri_s = (int8_t*)(conflict_s + 1);
  int8_t* want_s = tri_s + nbool;
  int8_t* want0_s = want_s + nbool;

  for (int k = tid; k < n * C_COUNT; k += kThreads) table[k] = entries[k];
  for (int s = tid; s < nbool; s += kThreads)
    want0_s[s] = want0[(size_t)s * B + lane];
  if (tid == 0) *conflict_s = 0;
  __syncthreads();

  Lane lw;
  lw.entries = table;
  lw.args = args;
  lw.consts = consts;
  lw.bv = planes;
  lw.tri = tri_s;
  lw.want = want_s;
  lw.want0 = want0_s;
  lw.conflict = false;
  // forward passes level by level, each warp a share of a level's nodes
  // (every thread of the block meets every barrier); backward passes on
  // warp 0, in the table's reverse order
  for (int pass = 0; pass <= 2 * rounds; ++pass) {
    if (pass & 1) {
      if (warp == 0 && worker) backward(lw, n, nbool);
      __syncthreads();
      continue;
    }
    for (int k = 0; k < n;) {
      const int end = table[k * C_COUNT + C_LEVEL_END];
      if (worker)
        for (int j = k + warp; j < end; j += kWarps)
          forward_node(lw, table[j * C_COUNT + C_SCHED], pass == 0);
      __syncthreads();
      k = end;
    }
  }
  if (worker && lw.conflict) *conflict_s = 1;
  __syncthreads();

  // results out to [slot][field][limb][lane]
  for (int row = tid; row < nbv * 32; row += kThreads) {
    int slot = row >> 5, field = (row >> 3) & 3, limb = row & 7;
    bv[(size_t)row * B + lane] = planes[slot * 32 + limb * 4 + field];
  }
  for (int s = tid; s < nbool; s += kThreads) {
    tri[(size_t)s * B + lane] = tri_s[s];
    want[(size_t)s * B + lane] = want_s[s];
  }
  if (tid == 0) conflict[lane] = *conflict_s ? 1 : 0;
}

extern "C" {

// Plain C entry point (bound with ctypes): one block a lane.  Returns the
// cudaError_t of the launch (0: the kernel was queued on `stream`), or
// wp::kDoesNotFit, before any launch, when the block's shared memory
// passes the card's opt-in maximum.
int word_prop_launch(const int* entries, int n, const int* args,
                     const uint32_t* consts, const int8_t* want0, int B,
                     int nbool, int rounds, uint32_t* bv, int8_t* tri,
                     int8_t* want, uint8_t* conflict, void* stream) {
  if (rounds < 0 || B < 1 || n < 1 || nbool < 1 || nbool > n)
    return (int)cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = wp::smem_bytes(n, nbool);
  if (smem > (size_t)limit) return wp::kDoesNotFit;
  e = cudaFuncSetAttribute(word_prop_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  word_prop_kernel<<<B, wp::kThreads, smem, (cudaStream_t)stream>>>(
      entries, n, args, consts, want0, B, nbool, rounds, bv, tri, want,
      conflict);
  return (int)cudaGetLastError();
}

int word_prop_op_count() { return wp::OP_COUNT; }

int word_prop_entry_columns() { return wp::C_COUNT; }

}  // extern "C"

#else  // host build: the same lane walk on an emulated group

extern "C" {

// word_prop_launch's function, one lane after another on the host (the
// planes in shared memory's layout, copied out as the kernel does).
// Returns 0, or 1 when a value the group should hold alike differed.
int word_prop_host(const int* entries, int n, const int* args,
                   const uint32_t* consts, const int8_t* want0, int B,
                   int nbool, int rounds, uint32_t* bv, int8_t* tri,
                   int8_t* want, uint8_t* conflict) {
  using namespace wp;
  const int nbv = n - nbool;
  std::vector<uint32_t> planes((size_t)(nbv > 0 ? nbv : 1) * 32);
  std::vector<int8_t> tri_s(nbool), want_s(nbool), want0_s(nbool);
  host_fault() = 0;
  for (int lane = 0; lane < B; ++lane) {
    for (int s = 0; s < nbool; ++s) want0_s[s] = want0[(size_t)s * B + lane];
    Lane lw;
    lw.entries = entries;
    lw.args = args;
    lw.consts = consts;
    lw.bv = planes.data();
    lw.tri = tri_s.data();
    lw.want = want_s.data();
    lw.want0 = want0_s.data();
    lw.conflict = false;
    for (int pass = 0; pass <= 2 * rounds; ++pass) {
      if (pass & 1)
        backward(lw, n, nbool);
      else
        for (int k = 0; k < n; ++k)
          forward_node(lw, entries[k * C_COUNT + C_SCHED], pass == 0);
    }
    conflict[lane] = lw.conflict ? 1 : 0;
    for (size_t row = 0; row < (size_t)nbv * 32; ++row) {
      size_t slot = row >> 5;
      int field = (int)(row >> 3) & 3, limb = (int)row & 7;
      bv[row * B + lane] = planes[slot * 32 + limb * 4 + field];
    }
    for (int s = 0; s < nbool; ++s) {
      tri[(size_t)s * B + lane] = tri_s[s];
      want[(size_t)s * B + lane] = want_s[s];
    }
  }
  return host_fault();
}

}  // extern "C"

#endif  // __CUDACC__
