// Native clause pool + gate layer for the bit-blaster.
//
// The reference framework leans on Z3's native AST/solver for all of this
// (mythril/laser/smt/solver/solver.py:47-57 drives z3 directly); this build
// replaces it with its own CNF pipeline, and round-3 profiling showed the
// Python half of that pipeline (clause bookkeeping at ~1e6 clauses per
// contract, per-gate dict traffic, the cone-of-influence BFS) costing 3x
// the actual CDCL search.  This file moves the clause store and the whole
// gate/word-circuit emission layer behind one ctypes boundary:
//
//   * CSR clause store (flat literals + row offsets) — the single source
//     of truth the device pools, the cone walker, and debug accessors all
//     read; every emitted clause is also forwarded to the CDCL instance
//     (cdcl.cpp) in the same call, so no flush step exists anymore.
//   * Tseitin gate emitters (AND/XOR/XOR3/MAJ/MUX/AND-many) with the same
//     constant folding + structural-sharing cache the Python layer had,
//     now hash maps over packed keys.
//   * Word-level circuits (adders, comparators, multiplier, divider,
//     equality) that loop entirely natively — one crossing per word op
//     instead of one per bit or per clause.
//   * The defining-cone index and BFS (per-root memoized) used both for
//     CDCL decision restriction and device-dispatch cone extraction.
//
// Literal conventions match the blaster: DIMACS-style +v/-v, var 1 is the
// constant-TRUE anchor (so +1 is literal TRUE, -1 is FALSE).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <iterator>
#include <unordered_map>
#include <vector>

extern "C" {
// cdcl.cpp, linked into the same shared object
int32_t cdcl_new_var(void* s);
int32_t cdcl_add_clause(void* s, const int32_t* lits, int32_t n);
int64_t cdcl_learnt_clauses(void* s, int32_t max_width, int64_t from,
                            int32_t* out, int64_t cap, int64_t* next);
void cdcl_set_relevant(void* s, const int32_t* vars, int64_t n);
void cdcl_relevant_begin(void* s);
void cdcl_relevant_mark(void* s, const int32_t* vars, int64_t n);
}

namespace {

using std::vector;

constexpr int32_t TRUE_LIT = 1;
constexpr int32_t FALSE_LIT = -1;

struct GateKey {
  int32_t tag, x, y, z;
  bool operator==(const GateKey& o) const {
    return tag == o.tag && x == o.x && y == o.y && z == o.z;
  }
};

struct GateKeyHash {
  size_t operator()(const GateKey& k) const {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t part : {(uint64_t)(uint32_t)k.tag, (uint64_t)(uint32_t)k.x,
                          (uint64_t)(uint32_t)k.y, (uint64_t)(uint32_t)k.z}) {
      h ^= part;
      h *= 1099511628211ull;
    }
    return (size_t)h;
  }
};

struct VecHash {
  size_t operator()(const vector<int32_t>& v) const {
    uint64_t h = 1469598103934665603ull;
    for (int32_t x : v) {
      h ^= (uint64_t)(uint32_t)x;
      h *= 1099511628211ull;
    }
    return (size_t)h;
  }
};

enum GateTag { TAG_AND = 1, TAG_XOR = 2, TAG_XOR3 = 3, TAG_MAJ = 4,
               TAG_MUX = 5 };

struct ConeEntry {
  vector<int64_t> clauses;  // sorted unique
  vector<int32_t> vars;     // sorted unique
};

class Pool {
 public:
  explicit Pool(void* solver) : solver_(solver) { indptr_.push_back(0); }

  // ---- clause store ----

  int32_t new_var() {
    int32_t v = cdcl_new_var(solver_);
    if ((size_t)v >= def_head_.size()) def_head_.resize(v + 1, -1);
    return v;
  }

  void ensure_var(int32_t v) {
    if (v > 0 && (size_t)v >= def_head_.size()) def_head_.resize(v + 1, -1);
  }

  void def_link(int32_t var, int64_t clause_idx) {
    ensure_var(var);
    def_next_.push_back(def_head_[var]);
    def_clause_.push_back(clause_idx);
    def_head_[var] = (int32_t)(def_next_.size() - 1);
  }

  // Raw emission: records the clause in the CSR mirror, indexes its
  // owner(s) for cone walks, and forwards it to the CDCL database.
  // owner == 0 means "derive as max |lit|" (the freshly defined gate
  // var is always the newest, hence the max).
  void clause(const int32_t* lits, int32_t n, int32_t owner,
              const int32_t* extras, int32_t n_extras,
              bool forward_to_solver = true) {
    int64_t idx = (int64_t)indptr_.size() - 1;
    lits_.insert(lits_.end(), lits, lits + n);
    indptr_.push_back((int64_t)lits_.size());
    if (owner == 0) {
      for (int32_t i = 0; i < n; ++i)
        owner = std::max(owner, lits[i] < 0 ? -lits[i] : lits[i]);
    }
    if (owner > 1) def_link(owner, idx);
    for (int32_t i = 0; i < n_extras; ++i) {
      int32_t e = extras[i] < 0 ? -extras[i] : extras[i];
      if (e > 1 && e != owner) def_link(e, idx);
    }
    ++version_;
    if (forward_to_solver) cdcl_add_clause(solver_, lits, n);
  }

  void c2(int32_t a, int32_t b, int32_t owner) {
    int32_t l[2] = {a, b};
    clause(l, 2, owner, nullptr, 0);
  }
  void c3(int32_t a, int32_t b, int32_t c, int32_t owner) {
    int32_t l[3] = {a, b, c};
    clause(l, 3, owner, nullptr, 0);
  }
  void c4(int32_t a, int32_t b, int32_t c, int32_t d, int32_t owner) {
    int32_t l[4] = {a, b, c, d};
    clause(l, 4, owner, nullptr, 0);
  }

  // ---- gates (constant folding + structural sharing, as the Python
  //      layer did; the cache makes repeated sub-circuits free) ----

  int32_t g_and(int32_t a, int32_t b) {
    if (a == FALSE_LIT || b == FALSE_LIT || a == -b) return FALSE_LIT;
    if (a == TRUE_LIT) return b;
    if (b == TRUE_LIT || a == b) return a;
    GateKey key{TAG_AND, std::min(a, b), std::max(a, b), 0};
    auto it = gates_.find(key);
    if (it != gates_.end()) return it->second;
    int32_t lit = new_var();
    c2(-lit, a, lit);
    c2(-lit, b, lit);
    c3(lit, -a, -b, lit);
    gates_.emplace(key, lit);
    return lit;
  }

  int32_t g_or(int32_t a, int32_t b) { return -g_and(-a, -b); }

  int32_t g_xor(int32_t a, int32_t b) {
    if (a == TRUE_LIT) return -b;
    if (a == FALSE_LIT) return b;
    if (b == TRUE_LIT) return -a;
    if (b == FALSE_LIT) return a;
    if (a == b) return FALSE_LIT;
    if (a == -b) return TRUE_LIT;
    bool flip = (a < 0) != (b < 0);
    int32_t va = a < 0 ? -a : a, vb = b < 0 ? -b : b;
    if (va > vb) std::swap(va, vb);
    GateKey key{TAG_XOR, va, vb, 0};
    auto it = gates_.find(key);
    int32_t lit;
    if (it != gates_.end()) {
      lit = it->second;
    } else {
      lit = new_var();
      c3(-lit, va, vb, lit);
      c3(-lit, -va, -vb, lit);
      c3(lit, -va, vb, lit);
      c3(lit, va, -vb, lit);
      gates_.emplace(key, lit);
    }
    return flip ? -lit : lit;
  }

  int32_t g_mux(int32_t s, int32_t a, int32_t b) {
    if (s == TRUE_LIT) return a;
    if (s == FALSE_LIT) return b;
    if (a == b) return a;
    if (a == TRUE_LIT && b == FALSE_LIT) return s;
    if (a == FALSE_LIT && b == TRUE_LIT) return -s;
    GateKey key{TAG_MUX, s, a, b};
    auto it = gates_.find(key);
    if (it != gates_.end()) return it->second;
    int32_t lit = new_var();
    c3(-s, -a, lit, lit);
    c3(-s, a, -lit, lit);
    c3(s, -b, lit, lit);
    c3(s, b, -lit, lit);
    if (a != TRUE_LIT && a != FALSE_LIT && b != TRUE_LIT && b != FALSE_LIT) {
      c3(-a, -b, lit, lit);  // redundant, aids propagation
      c3(a, b, -lit, lit);
    }
    gates_.emplace(key, lit);
    return lit;
  }

  int32_t g_xor3(int32_t a, int32_t b, int32_t c) {
    if (a == TRUE_LIT) return -g_xor(b, c);
    if (a == FALSE_LIT) return g_xor(b, c);
    if (b == TRUE_LIT) return -g_xor(a, c);
    if (b == FALSE_LIT) return g_xor(a, c);
    if (c == TRUE_LIT) return -g_xor(a, b);
    if (c == FALSE_LIT) return g_xor(a, b);
    if (a == b) return c;
    if (a == -b) return -c;
    if (b == c) return a;
    if (b == -c) return -a;
    if (a == c) return b;
    if (a == -c) return -b;
    bool flip = ((a < 0) != (b < 0)) != (c < 0);
    int32_t v[3] = {a < 0 ? -a : a, b < 0 ? -b : b, c < 0 ? -c : c};
    std::sort(v, v + 3);
    GateKey key{TAG_XOR3, v[0], v[1], v[2]};
    auto it = gates_.find(key);
    int32_t lit;
    if (it != gates_.end()) {
      lit = it->second;
    } else {
      lit = new_var();
      c4(-lit, v[0], v[1], v[2], lit);
      c4(-lit, -v[0], -v[1], v[2], lit);
      c4(-lit, -v[0], v[1], -v[2], lit);
      c4(-lit, v[0], -v[1], -v[2], lit);
      c4(lit, -v[0], v[1], v[2], lit);
      c4(lit, v[0], -v[1], v[2], lit);
      c4(lit, v[0], v[1], -v[2], lit);
      c4(lit, -v[0], -v[1], -v[2], lit);
      gates_.emplace(key, lit);
    }
    return flip ? -lit : lit;
  }

  int32_t g_maj(int32_t a, int32_t b, int32_t c) {
    if (a == TRUE_LIT) return g_or(b, c);
    if (a == FALSE_LIT) return g_and(b, c);
    if (b == TRUE_LIT) return g_or(a, c);
    if (b == FALSE_LIT) return g_and(a, c);
    if (c == TRUE_LIT) return g_or(a, b);
    if (c == FALSE_LIT) return g_and(a, b);
    if (a == b || a == c) return a;
    if (b == c) return b;
    if (a == -b) return c;
    if (a == -c) return b;
    if (b == -c) return a;
    int32_t l[3] = {a, b, c};
    std::sort(l, l + 3, [](int32_t p, int32_t q) {
      int32_t ap = p < 0 ? -p : p, aq = q < 0 ? -q : q;
      return ap < aq;
    });
    bool flip = l[0] < 0;
    if (flip) { l[0] = -l[0]; l[1] = -l[1]; l[2] = -l[2]; }
    GateKey key{TAG_MAJ, l[0], l[1], l[2]};
    auto it = gates_.find(key);
    int32_t lit;
    if (it != gates_.end()) {
      lit = it->second;
    } else {
      lit = new_var();
      c3(-lit, l[0], l[1], lit);
      c3(-lit, l[0], l[2], lit);
      c3(-lit, l[1], l[2], lit);
      c3(lit, -l[0], -l[1], lit);
      c3(lit, -l[0], -l[2], lit);
      c3(lit, -l[1], -l[2], lit);
      gates_.emplace(key, lit);
    }
    return flip ? -lit : lit;
  }

  int32_t g_and_many(const int32_t* in, int64_t n) {
    vector<int32_t> xs(in, in + n);
    // sort by (|lit|, sign) so duplicates AND complements are adjacent:
    // dedup/contradiction detection in one linear pass (the old linear
    // scan per element was O(n^2) — every 256-bit equality paid it)
    std::sort(xs.begin(), xs.end(), [](int32_t a, int32_t b) {
      int32_t aa = a < 0 ? -a : a, ab = b < 0 ? -b : b;
      return aa != ab ? aa < ab : a < b;
    });
    size_t out = 0;
    for (size_t i = 0; i < xs.size(); ++i) {
      int32_t lit = xs[i];
      if (lit == FALSE_LIT) return FALSE_LIT;
      if (lit == TRUE_LIT) continue;
      if (out > 0 && xs[out - 1] == lit) continue;       // duplicate
      if (out > 0 && xs[out - 1] == -lit) return FALSE_LIT;  // a ∧ ¬a
      xs[out++] = lit;
    }
    xs.resize(out);
    if (xs.empty()) return TRUE_LIT;
    if (xs.size() == 1) return xs[0];
    if (xs.size() == 2) return g_and(xs[0], xs[1]);
    auto it = wide_gates_.find(xs);
    if (it != wide_gates_.end()) return it->second;
    int32_t lit = new_var();
    for (int32_t x : xs) c2(-lit, x, lit);
    vector<int32_t> closing;
    closing.reserve(xs.size() + 1);
    closing.push_back(lit);
    for (int32_t x : xs) closing.push_back(-x);
    clause(closing.data(), (int32_t)closing.size(), lit, nullptr, 0);
    wide_gates_.emplace(std::move(xs), lit);
    return lit;
  }

  // ---- word-level circuits ----

  void add_bits(const int32_t* xs, const int32_t* ys, int32_t n,
                int32_t cin, int32_t* sum_out, int32_t* carry_out) {
    int32_t carry = cin;
    for (int32_t i = 0; i < n; ++i) {
      sum_out[i] = g_xor3(xs[i], ys[i], carry);
      carry = g_maj(xs[i], ys[i], carry);
    }
    *carry_out = carry;
  }

  // xs < ys unsigned == NOT carry-out of xs + ~ys + 1.  Only the carry
  // (majority) chain is materialized — comparisons don't need the sum
  // bits, which halves the clauses per comparator vs a full subtractor.
  int32_t ult_lit(const int32_t* xs, const int32_t* ys, int32_t n) {
    int32_t carry = TRUE_LIT;
    for (int32_t i = 0; i < n; ++i) carry = g_maj(xs[i], -ys[i], carry);
    return -carry;
  }

  int32_t eq_lit(const int32_t* xs, const int32_t* ys, int32_t n) {
    vector<int32_t> conj(n);
    for (int32_t i = 0; i < n; ++i) conj[i] = -g_xor(xs[i], ys[i]);
    return g_and_many(conj.data(), n);
  }

  void mux_bits(int32_t s, const int32_t* xs, const int32_t* ys, int32_t n,
                int32_t* out) {
    for (int32_t i = 0; i < n; ++i) out[i] = g_mux(s, xs[i], ys[i]);
  }

  // mode 0 = and, 1 = or, 2 = xor
  void map_bits(int32_t mode, const int32_t* xs, const int32_t* ys,
                int32_t n, int32_t* out) {
    for (int32_t i = 0; i < n; ++i) {
      if (mode == 0) out[i] = g_and(xs[i], ys[i]);
      else if (mode == 1) out[i] = g_or(xs[i], ys[i]);
      else out[i] = g_xor(xs[i], ys[i]);
    }
  }

  void mul_bits(const int32_t* xs, const int32_t* ys, int32_t n,
                int32_t* out) {
    vector<int32_t> acc(n, FALSE_LIT);
    vector<int32_t> partial(n);
    vector<int32_t> next(n);
    for (int32_t i = 0; i < n; ++i) {
      if (ys[i] == FALSE_LIT) continue;
      for (int32_t j = 0; j < i; ++j) partial[j] = FALSE_LIT;
      for (int32_t j = i; j < n; ++j) partial[j] = g_and(xs[j - i], ys[i]);
      int32_t carry;
      add_bits(acc.data(), partial.data(), n, FALSE_LIT, next.data(), &carry);
      acc.swap(next);
    }
    std::memcpy(out, acc.data(), n * sizeof(int32_t));
  }

  // Restoring division; quotient/remainder with the zero-divisor mux
  // left to the caller (SMT-LIB semantics live in the Python layer).
  void udivmod_bits(const int32_t* xs, const int32_t* ys, int32_t n,
                    int32_t* q_out, int32_t* r_out) {
    // remainder runs one bit wider: after the shift-in it can reach
    // 2*divisor-1 which needs n+1 bits when the divisor is large
    vector<int32_t> ys_wide(ys, ys + n);
    ys_wide.push_back(FALSE_LIT);
    vector<int32_t> rem(n + 1, FALSE_LIT);
    vector<int32_t> shifted(n + 1), diff(n + 1), muxed(n + 1);
    for (int32_t i = n - 1; i >= 0; --i) {
      shifted[0] = xs[i];  // shift left, bring down bit
      for (int32_t j = 0; j < n; ++j) shifted[j + 1] = rem[j];
      // diff = shifted - ys_wide (add of complement, cin = 1);
      // carry-out == no borrow == shifted >= ys_wide
      int32_t carry = TRUE_LIT;
      for (int32_t j = 0; j < n + 1; ++j) {
        diff[j] = g_xor3(shifted[j], -ys_wide[j], carry);
        carry = g_maj(shifted[j], -ys_wide[j], carry);
      }
      q_out[i] = carry;
      mux_bits(carry, diff.data(), shifted.data(), n + 1, muxed.data());
      rem.swap(muxed);
    }
    std::memcpy(r_out, rem.data(), n * sizeof(int32_t));
  }

  // Ackermann congruence rows: same -> (a_bits[i] == b_bits[i]) for
  // every bit, each clause pair owned by a_bits[i] (plus the derived
  // max-|lit| owner) so cone walks reach the linked read.
  void congruence(int32_t same, const int32_t* a_bits,
                  const int32_t* b_bits, int32_t n) {
    for (int32_t i = 0; i < n; ++i) {
      int32_t a = a_bits[i], b = b_bits[i];
      int32_t extra[1] = {a};
      int32_t l1[3] = {-same, -a, b};
      int32_t l2[3] = {-same, a, -b};
      clause(l1, 3, 0, extra, 1);
      clause(l2, 3, 0, extra, 1);
    }
  }

  // ---- learned-clause absorption + nogoods ----

  int64_t absorb_learnts(int32_t max_width) {
    const int64_t cap = 1 << 18;
    vector<int32_t> buf(cap);
    int64_t next = learnt_cursor_;
    int64_t written = cdcl_learnt_clauses(solver_, max_width, learnt_cursor_,
                                          buf.data(), cap, &next);
    learnt_cursor_ = next;
    int64_t added = 0;
    int64_t start = 0;
    for (int64_t i = 0; i < written; ++i) {
      if (buf[i] != 0) continue;
      // already in the CDCL database — mirror only
      clause(buf.data() + start, (int32_t)(i - start), 0, nullptr, 0,
             /*forward_to_solver=*/false);
      start = i + 1;
      ++added;
    }
    absorbed_ += added;
    return added;
  }

  // Device-refuted assumption set -> implied pool clause (see the
  // Python-side docstring that used to live on learn_nogood).
  int32_t nogood(const int32_t* in, int32_t n) {
    if (n == 0 || n > 12) return 0;
    vector<int32_t> lits(n);
    for (int32_t i = 0; i < n; ++i) lits[i] = -in[i];
    std::sort(lits.begin(), lits.end());
    lits.erase(std::unique(lits.begin(), lits.end()), lits.end());
    for (int32_t l : lits)
      if (std::binary_search(lits.begin(), lits.end(), -l))
        return 0;  // tautological
    for (int32_t l : lits)
      if (l == TRUE_LIT) return 0;  // trivially satisfied
    if (!nogood_seen_.emplace(lits, 1).second) return 0;
    int64_t idx = (int64_t)indptr_.size() - 1;
    clause(lits.data(), (int32_t)lits.size(), 0, nullptr, 0);
    vector<int32_t> vars;
    vars.reserve(lits.size());
    for (int32_t l : lits) vars.push_back(l < 0 ? -l : l);
    std::sort(vars.begin(), vars.end());
    vars.erase(std::unique(vars.begin(), vars.end()), vars.end());
    nogoods_.push_back({idx, std::move(vars)});
    ++absorbed_;
    return 1;
  }

  // ---- cone of influence ----

  const ConeEntry& cone_of_var(int32_t root) {
    auto hit = cone_cache_.find(root);
    if (hit != cone_cache_.end()) return hit->second;
    ++var_epoch_counter_;
    ++clause_epoch_counter_;
    if (var_epoch_.size() < def_head_.size())
      var_epoch_.resize(def_head_.size(), 0);
    int64_t num_clauses = (int64_t)indptr_.size() - 1;
    if ((int64_t)clause_epoch_.size() < num_clauses)
      clause_epoch_.resize(num_clauses, 0);

    ConeEntry out;
    vector<int32_t> frontier{root};
    vector<int32_t> next;
    while (!frontier.empty()) {
      next.clear();
      for (int32_t var : frontier) {
        if ((size_t)var >= var_epoch_.size() ||
            var_epoch_[var] == var_epoch_counter_)
          continue;
        var_epoch_[var] = var_epoch_counter_;
        auto sub = cone_cache_.find(var);
        if (sub != cone_cache_.end()) {
          // absorb the memoized sub-cone: clauses append, vars mark
          const ConeEntry& e = sub->second;
          out.clauses.insert(out.clauses.end(), e.clauses.begin(),
                             e.clauses.end());
          for (int32_t v : e.vars) {
            if ((size_t)v < var_epoch_.size() &&
                var_epoch_[v] != var_epoch_counter_) {
              var_epoch_[v] = var_epoch_counter_;
              out.vars.push_back(v);
            }
          }
          out.vars.push_back(var);  // var itself (already marked)
          continue;
        }
        out.vars.push_back(var);
        for (int32_t e = def_head_[var]; e != -1; e = def_next_[e]) {
          int64_t ci = def_clause_[e];
          if (clause_epoch_[ci] == clause_epoch_counter_) continue;
          clause_epoch_[ci] = clause_epoch_counter_;
          out.clauses.push_back(ci);
          for (int64_t k = indptr_[ci]; k < indptr_[ci + 1]; ++k) {
            int32_t v = lits_[k] < 0 ? -lits_[k] : lits_[k];
            if (v > 1 && (size_t)v < var_epoch_.size() &&
                var_epoch_[v] != var_epoch_counter_)
              next.push_back(v);
          }
        }
      }
      frontier.swap(next);
    }
    std::sort(out.clauses.begin(), out.clauses.end());
    out.clauses.erase(std::unique(out.clauses.begin(), out.clauses.end()),
                      out.clauses.end());
    std::sort(out.vars.begin(), out.vars.end());
    out.vars.erase(std::unique(out.vars.begin(), out.vars.end()),
                   out.vars.end());
    auto ins = cone_cache_.emplace(root, std::move(out));
    return ins.first->second;
  }

  // Decision-restriction fast path: mark each root's memoized cone
  // vars straight into the CDCL's relevance bitmap — no union vector.
  // A sorted/unique union at deep-analysis scale (hundreds of
  // thousands of vars, re-built or copied per query) cost more than
  // the searches it was restricting; bitmap marking is one sequential
  // pass over the per-root cones (overlap between sibling roots just
  // re-marks the same bytes).
  void relevant_cone(const int32_t* roots, int64_t n) {
    bool any = false;
    for (int64_t i = 0; i < n; ++i) {
      int32_t var = roots[i] < 0 ? -roots[i] : roots[i];
      if (var <= 1) continue;
      if (!any) {
        cdcl_relevant_begin(solver_);
        any = true;
      }
      const ConeEntry& e = cone_of_var(var);
      cdcl_relevant_mark(solver_, e.vars.data(), (int64_t)e.vars.size());
      cdcl_relevant_mark(solver_, &var, 1);
    }
    if (!any)
      // no real roots (empty / all-constant query): lift the
      // restriction — an empty bitmap would fake-SAT with a
      // default-valued model instead of searching the full pool
      cdcl_set_relevant(solver_, nullptr, 0);
  }

  // Union of per-root cones + covered nogoods; result parked in
  // last_cone_* for the two-phase ctypes fetch.
  void cone(const int32_t* roots, int64_t n, bool need_clauses) {
    last_cone_clauses_.clear();
    last_cone_vars_.clear();
    for (int64_t i = 0; i < n; ++i) {
      int32_t var = roots[i] < 0 ? -roots[i] : roots[i];
      if (var <= 1) continue;
      const ConeEntry& e = cone_of_var(var);
      if (need_clauses)
        last_cone_clauses_.insert(last_cone_clauses_.end(),
                                  e.clauses.begin(), e.clauses.end());
      last_cone_vars_.insert(last_cone_vars_.end(), e.vars.begin(),
                             e.vars.end());
    }
    std::sort(last_cone_vars_.begin(), last_cone_vars_.end());
    last_cone_vars_.erase(
        std::unique(last_cone_vars_.begin(), last_cone_vars_.end()),
        last_cone_vars_.end());
    if (!need_clauses) return;
    std::sort(last_cone_clauses_.begin(), last_cone_clauses_.end());
    last_cone_clauses_.erase(
        std::unique(last_cone_clauses_.begin(), last_cone_clauses_.end()),
        last_cone_clauses_.end());
    if (!nogoods_.empty() && !last_cone_vars_.empty()) {
      // nogoods whose var set the cone covers prune it; cached cones
      // never re-walk, so they are appended per call
      vector<int64_t> extra;
      for (const auto& ng : nogoods_) {
        bool covered = true;
        for (int32_t v : ng.second) {
          if (!std::binary_search(last_cone_vars_.begin(),
                                  last_cone_vars_.end(), v)) {
            covered = false;
            break;
          }
        }
        if (covered) extra.push_back(ng.first);
      }
      if (!extra.empty()) {
        last_cone_clauses_.insert(last_cone_clauses_.end(), extra.begin(),
                                  extra.end());
        std::sort(last_cone_clauses_.begin(), last_cone_clauses_.end());
        last_cone_clauses_.erase(
            std::unique(last_cone_clauses_.begin(), last_cone_clauses_.end()),
            last_cone_clauses_.end());
      }
    }
  }

  // ---- accessors ----

  int64_t num_clauses() const { return (int64_t)indptr_.size() - 1; }
  int64_t lits_len() const { return (int64_t)lits_.size(); }
  int64_t version() const { return version_; }
  int64_t absorbed() const { return absorbed_; }

  void csr_into(int64_t from_c, int64_t to_c, int32_t* lits_out,
                int64_t* indptr_out) const {
    int64_t base = indptr_[from_c];
    std::memcpy(lits_out, lits_.data() + base,
                (indptr_[to_c] - base) * sizeof(int32_t));
    for (int64_t i = from_c; i <= to_c; ++i)
      indptr_out[i - from_c] = indptr_[i] - base;
  }

  // Compacted padded rows for the dense device pools: clauses wider
  // than K are skipped (counted in *dropped).  Returns rows written.
  int64_t padded_rows(int64_t from_c, int64_t to_c, int32_t K,
                      int32_t* out, int64_t* dropped) const {
    int64_t rows = 0, skip = 0;
    for (int64_t ci = from_c; ci < to_c; ++ci) {
      int64_t len = indptr_[ci + 1] - indptr_[ci];
      if (len > K) { ++skip; continue; }
      int32_t* row = out + rows * K;
      std::memcpy(row, lits_.data() + indptr_[ci], len * sizeof(int32_t));
      std::memset(row + len, 0, (K - len) * sizeof(int32_t));
      ++rows;
    }
    if (dropped) *dropped = skip;
    return rows;
  }

  int64_t subset_sizes(const int64_t* ids, int64_t n) const {
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i)
      total += indptr_[ids[i] + 1] - indptr_[ids[i]];
    return total;
  }

  void subset_csr(const int64_t* ids, int64_t n, int32_t* lits_out,
                  int64_t* indptr_out) const {
    int64_t cursor = 0;
    indptr_out[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
      int64_t ci = ids[i];
      int64_t len = indptr_[ci + 1] - indptr_[ci];
      std::memcpy(lits_out + cursor, lits_.data() + indptr_[ci],
                  len * sizeof(int32_t));
      cursor += len;
      indptr_out[i + 1] = cursor;
    }
  }

  vector<int64_t> last_cone_clauses_;
  vector<int32_t> last_cone_vars_;

 private:
  void* solver_;
  vector<int32_t> lits_;
  vector<int64_t> indptr_;
  vector<int32_t> def_head_;   // var -> entry or -1
  vector<int32_t> def_next_;   // entry -> next entry
  vector<int64_t> def_clause_; // entry -> clause idx
  std::unordered_map<GateKey, int32_t, GateKeyHash> gates_;
  std::unordered_map<vector<int32_t>, int32_t, VecHash> wide_gates_;
  std::unordered_map<vector<int32_t>, int8_t, VecHash> nogood_seen_;
  std::unordered_map<int32_t, ConeEntry> cone_cache_;
  vector<std::pair<int64_t, vector<int32_t>>> nogoods_;
  vector<int64_t> var_epoch_;
  vector<int64_t> clause_epoch_;
  int64_t var_epoch_counter_ = 0;
  int64_t clause_epoch_counter_ = 0;
  int64_t version_ = 0;
  int64_t absorbed_ = 0;
  int64_t learnt_cursor_ = 0;
};

}  // namespace

extern "C" {

void* pool_new(void* solver) { return new Pool(solver); }
void pool_free(void* p) { delete (Pool*)p; }

int32_t pool_new_var(void* p) { return ((Pool*)p)->new_var(); }

void pool_clause(void* p, const int32_t* lits, int32_t n, int32_t owner,
                 const int32_t* extras, int32_t n_extras) {
  ((Pool*)p)->clause(lits, n, owner, extras, n_extras);
}

int32_t pool_and2(void* p, int32_t a, int32_t b) {
  return ((Pool*)p)->g_and(a, b);
}
int32_t pool_xor2(void* p, int32_t a, int32_t b) {
  return ((Pool*)p)->g_xor(a, b);
}
int32_t pool_xor3(void* p, int32_t a, int32_t b, int32_t c) {
  return ((Pool*)p)->g_xor3(a, b, c);
}
int32_t pool_maj(void* p, int32_t a, int32_t b, int32_t c) {
  return ((Pool*)p)->g_maj(a, b, c);
}
int32_t pool_mux(void* p, int32_t s, int32_t a, int32_t b) {
  return ((Pool*)p)->g_mux(s, a, b);
}
int32_t pool_and_many(void* p, const int32_t* lits, int64_t n) {
  return ((Pool*)p)->g_and_many(lits, n);
}

void pool_add_bits(void* p, const int32_t* xs, const int32_t* ys, int32_t n,
                   int32_t cin, int32_t* sum_out, int32_t* carry_out) {
  ((Pool*)p)->add_bits(xs, ys, n, cin, sum_out, carry_out);
}
int32_t pool_ult_lit(void* p, const int32_t* xs, const int32_t* ys,
                     int32_t n) {
  return ((Pool*)p)->ult_lit(xs, ys, n);
}
int32_t pool_eq_lit(void* p, const int32_t* xs, const int32_t* ys,
                    int32_t n) {
  return ((Pool*)p)->eq_lit(xs, ys, n);
}
void pool_mux_bits(void* p, int32_t s, const int32_t* xs, const int32_t* ys,
                   int32_t n, int32_t* out) {
  ((Pool*)p)->mux_bits(s, xs, ys, n, out);
}
void pool_map_bits(void* p, int32_t mode, const int32_t* xs,
                   const int32_t* ys, int32_t n, int32_t* out) {
  ((Pool*)p)->map_bits(mode, xs, ys, n, out);
}
void pool_mul_bits(void* p, const int32_t* xs, const int32_t* ys, int32_t n,
                   int32_t* out) {
  ((Pool*)p)->mul_bits(xs, ys, n, out);
}
void pool_udivmod_bits(void* p, const int32_t* xs, const int32_t* ys,
                       int32_t n, int32_t* q_out, int32_t* r_out) {
  ((Pool*)p)->udivmod_bits(xs, ys, n, q_out, r_out);
}

void pool_congruence(void* p, int32_t same, const int32_t* a_bits,
                     const int32_t* b_bits, int32_t n) {
  ((Pool*)p)->congruence(same, a_bits, b_bits, n);
}

int64_t pool_absorb_learnts(void* p, int32_t max_width) {
  return ((Pool*)p)->absorb_learnts(max_width);
}
int32_t pool_nogood(void* p, const int32_t* lits, int32_t n) {
  return ((Pool*)p)->nogood(lits, n);
}

void pool_relevant_cone(void* p, const int32_t* roots, int64_t n) {
  ((Pool*)p)->relevant_cone(roots, n);
}

void pool_cone(void* p, const int32_t* roots, int64_t n,
               int32_t need_clauses, int64_t* n_clauses, int64_t* n_vars) {
  Pool* pool = (Pool*)p;
  pool->cone(roots, n, need_clauses != 0);
  *n_clauses = (int64_t)pool->last_cone_clauses_.size();
  *n_vars = (int64_t)pool->last_cone_vars_.size();
}
void pool_cone_fetch(void* p, int64_t* clauses_out, int32_t* vars_out) {
  Pool* pool = (Pool*)p;
  if (clauses_out)
    std::memcpy(clauses_out, pool->last_cone_clauses_.data(),
                pool->last_cone_clauses_.size() * sizeof(int64_t));
  if (vars_out)
    std::memcpy(vars_out, pool->last_cone_vars_.data(),
                pool->last_cone_vars_.size() * sizeof(int32_t));
}

int64_t pool_num_clauses(void* p) { return ((Pool*)p)->num_clauses(); }
int64_t pool_lits_len(void* p) { return ((Pool*)p)->lits_len(); }
int64_t pool_version(void* p) { return ((Pool*)p)->version(); }
int64_t pool_absorbed_count(void* p) { return ((Pool*)p)->absorbed(); }

void pool_csr_into(void* p, int64_t from_c, int64_t to_c, int32_t* lits_out,
                   int64_t* indptr_out) {
  ((Pool*)p)->csr_into(from_c, to_c, lits_out, indptr_out);
}
int64_t pool_padded_rows(void* p, int64_t from_c, int64_t to_c, int32_t K,
                         int32_t* out, int64_t* dropped) {
  return ((Pool*)p)->padded_rows(from_c, to_c, K, out, dropped);
}
int64_t pool_subset_sizes(void* p, const int64_t* ids, int64_t n) {
  return ((Pool*)p)->subset_sizes(ids, n);
}
void pool_subset_csr(void* p, const int64_t* ids, int64_t n,
                     int32_t* lits_out, int64_t* indptr_out) {
  ((Pool*)p)->subset_csr(ids, n, lits_out, indptr_out);
}

}  // extern "C"
