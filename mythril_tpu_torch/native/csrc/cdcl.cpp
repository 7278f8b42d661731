// Native CDCL SAT solver for mythril_tpu.
//
// The reference framework rides on Z3 (a native C++ SMT solver) for every
// path-feasibility and exploit-concretization query; this build has no Z3,
// so this file is the authoritative decision procedure the bit-blaster
// targets.  Classic minisat-style architecture: two-literal watches, VSIDS
// with a binary heap, phase saving, 1UIP clause learning with recursive
// minimization, Luby restarts, activity-based learned-clause reduction,
// and incremental solving under assumptions (each symbolic-execution
// query activates a subset of the persistent clause pool, so learned
// clauses are shared across the thousands of queries one contract
// analysis issues).
//
// Exposed through a tiny C API consumed via ctypes (no pybind11 in the
// image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

using std::vector;

typedef int32_t Lit;   // DIMACS-style: +v / -v, v >= 1
typedef int32_t Var;

static inline int lit_index(Lit l) {  // 2v / 2v+1 encoding for watch lists
  Var v = l > 0 ? l : -l;
  return (v << 1) | (l < 0);
}

struct Clause {
  float activity = 0.0f;
  int32_t lbd = 0;  // glue level: distinct decision levels at learn time
  bool learned = false;
  bool deleted = false;
  // learned-clause tier (CaDiCaL-style three-tier management):
  //   0 = core  (lbd <= 2): kept forever — glue clauses connect few
  //       search levels and keep paying propagation indefinitely.
  //       Bounded: past kCoreCap immortal clauses, fresh glue lands in
  //       tier2 instead (memory stays bounded on glue-heavy runs);
  //   1 = tier2 (lbd <= 6): kept while used; a clause that sat out one
  //       whole reduce round demotes to local (with one round's grace
  //       before it becomes a deletion candidate);
  //   2 = local: activity-sorted, weakest half deleted each reduce.
  uint8_t tier = 2;
  uint8_t used = 0;      // touched in conflict analysis since last reduce
  uint8_t vivified = 0;  // already probed by vivify(): skip next rounds
  // literals live in the solver's shared arena (cache-dense BCP; the
  // per-clause heap vector this replaces cost a pointer chase per
  // clause touch and >40 bytes of overhead per clause on 23M-clause
  // pools).  size == 0 marks a deleted clause; its arena span becomes
  // a dead hole until the bounded compaction pass (see compact_arena,
  // triggered from reduceDB) rewrites live offsets.
  int64_t offset = 0;
  int32_t size = 0;
};

struct Watcher {
  int clause;
  Lit blocker;
};

class Solver {
 public:
  Solver() {
    // Opt-in experiments, env-gated, DEFAULT OFF.  Round-5 bisection on
    // batchtoken -t3 (docs/measurements_r5.md): each of these perturbs
    // which model the solver returns, and the analysis pipeline's
    // recent-model probe is so load-bearing that a ~20% probe hit-rate
    // drop (444 -> 319 SAT probes) swamps any in-solver win.  The
    // tiered clause DB + lazy reduce below are kept on: they preserve
    // search dynamics and measured 458.9s -> 415.6s.
    const char* e = getenv("MYTHRIL_CDCL_CONE_PROP");
    cone_prop_ = e && e[0] == '1';
    e = getenv("MYTHRIL_CDCL_VIVIFY");
    vivify_enabled_ = e && e[0] == '1';
    e = getenv("MYTHRIL_CDCL_ADAPTIVE_RESTART");
    adaptive_restart_ = e && e[0] == '1';
    new_var();  // var 1 is the constant-true anchor used by the blaster
    vector<Lit> unit{1};
    add_clause(unit);
  }

  Var new_var() {
    Var v = (Var)assigns_.size() ? (Var)(assigns_.size()) : 1;
    // assigns_ is indexed by var; index 0 unused.
    if (assigns_.empty()) assigns_.push_back(0);
    assigns_.push_back(0);
    level_.resize(assigns_.size(), 0);
    reason_.resize(assigns_.size(), -1);
    activity_.resize(assigns_.size(), 0.0);
    polarity_.resize(assigns_.size(), 0);
    seen_.resize(assigns_.size(), 0);
    heap_pos_.resize(assigns_.size(), -1);
    watches_.resize(assigns_.size() * 2 + 2);
    bin_watches_.resize(assigns_.size() * 2 + 2);
    heap_insert(v);
    return v;
  }

  // Returns false if the database became trivially UNSAT.
  bool add_clause(vector<Lit>& lits) {
    if (!ok_) return false;
    // Normalize: sort, dedupe, drop tautologies and false lits @ level 0.
    std::sort(lits.begin(), lits.end(), [](Lit a, Lit b) {
      return std::abs(a) != std::abs(b) ? std::abs(a) < std::abs(b) : a < b;
    });
    vector<Lit> out;
    for (size_t i = 0; i < lits.size(); ++i) {
      Lit l = lits[i];
      if (i + 1 < lits.size() && lits[i + 1] == -l) return true;  // tautology
      if (i > 0 && lits[i - 1] == l) continue;                    // duplicate
      int v = value(l);
      if (v == 1 && level_of(l) == 0) return true;   // already satisfied
      if (v == -1 && level_of(l) == 0) continue;     // already false forever
      out.push_back(l);
    }
    proof_event(3, out.data(), out.size());
    if (out.empty()) { ok_ = false; return false; }
    if (out.size() == 1) {
      // global unit: belongs at level 0 (kills any saved trail — rare)
      if (decision_level() > 0) { cancelUntil(0); prev_assumptions_.clear(); }
      if (value(out[0]) == -1) { ok_ = false; return false; }
      if (value(out[0]) == 0) {
        uncheckedEnqueue(out[0], -1);
        if (propagate() != -1) { ok_ = false; return false; }
      }
      return true;
    }
    if (decision_level() > 0) {
      // Clause addition invalidates the saved assumption trail (the
      // clause may be falsified by kept assignments).  Mid-trail
      // attachment was tried and lost badly: under a kept trail most
      // fresh Tseitin clauses are unit, turning every blast into a
      // propagation storm.  Queries interleave blasting and solving,
      // so prefix reuse only pays off for blast-free repeats.
      cancelUntil(0);
      prev_assumptions_.clear();
    }
    attach(out, false);
    return true;
  }

  // 1 sat, -1 unsat, 0 unknown (budget exhausted)
  // Restrict decisions to a relevant-variable set (the assumption
  // cone).  Sound: the shared pool holds only definitional (Tseitin)
  // and implied (learned) clauses, which are satisfiable under ANY
  // assignment of their inputs, so once every relevant var is assigned
  // without conflict a completion of the foreign gates exists;
  // UNSAT verdicts come from conflicts over real clauses and are
  // unaffected by decision policy.  n == 0 lifts the restriction.
  void set_relevant(const int32_t* vars, int64_t n) {
    restricted_ = n > 0;
    if (!restricted_) return;
    relevant_begin();
    relevant_mark(vars, n);
  }

  // Incremental variant: the pool marks per-root cone var sets
  // directly (no union materialization — at deep-analysis scale the
  // sorted union vectors cost more than the whole CDCL search).
  // Epoch-stamped: starting a new cone bumps the epoch instead of
  // clearing the bitmap (O(1), not O(num_vars)).
  void relevant_begin() {
    restricted_ = true;
    ++relevant_epoch_;
    if (relevant_.size() < assigns_.size()) relevant_.resize(assigns_.size(), 0);
    if (relevant_.size() > 1) relevant_[1] = relevant_epoch_;  // TRUE anchor
  }
  void relevant_mark(const int32_t* vars, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      int32_t v = vars[i];
      if (v > 0 && (size_t)v < relevant_.size()) relevant_[v] = relevant_epoch_;
    }
  }
  bool is_relevant(Var v) const {
    return (size_t)v < relevant_.size() && relevant_[v] == relevant_epoch_;
  }

  int solve(const Lit* assumps, int n_assumps, int64_t conflict_budget,
            double time_budget_s) {
    conflict_core_.clear();
    if (!ok_) { proof_event(5, nullptr, 0); return -1; }
    // inprocessing on a conflict cadence: strengthening runs at level 0,
    // so it forfeits this call's assumption-prefix reuse — acceptable
    // every ~20k conflicts (a query stack that hot repeats few prefixes)
    if (vivify_enabled_ && total_conflicts_ >= next_viv_at_ && !learnts_.empty()) {
      cancelUntil(0);
      prev_assumptions_.clear();
      // vivification derives GLOBAL strengthenings: run unrestricted
      bool was_restricted = restricted_;
      restricted_ = false;
      vivify();
      restricted_ = was_restricted;
      next_viv_at_ = total_conflicts_ + kVivInterval;
      if (!ok_) { proof_event(5, nullptr, 0); return -1; }
    }
    // Assumption-prefix trail reuse: queries arrive as incrementally
    // growing path-constraint sets, so consecutive calls usually share
    // a long assumption prefix.  Decision level i+1 always holds
    // assumptions_[i] (search() re-decides them in order after any
    // backjump), so keeping the first k matching levels skips
    // re-propagating the shared cone — the dominant cost of a query
    // against a large clause pool.
    size_t k = 0;
    size_t max_k = std::min(prev_assumptions_.size(), (size_t)n_assumps);
    if ((int)max_k > decision_level()) max_k = (size_t)decision_level();
    while (k < max_k && prev_assumptions_[k] == assumps[k]) ++k;
    cancelUntil((int)k);
    assumptions_.assign(assumps, assumps + n_assumps);
    prev_assumptions_ = assumptions_;
    budget_conflicts_ = conflict_budget;
    deadline_ = time_budget_s > 0 ? now() + time_budget_s : -1.0;
    conflicts_this_call_ = 0;
    model_.clear();

    int restart = 0;
    int status = 0;
    while (status == 0) {
      // Luby restarts drive the search; x1024 base is the schedule the
      // adopted round-5 configuration was measured under (assumption-
      // incremental queries keep their prefix across restarts, so slow
      // restarts lose little and re-propagation is the real cost).
      // When the env-gated adaptive (glucose) policy is on it fires
      // first and Luby is only a backstop.
      int64_t luby_len = 1024 * luby(restart++);
      status = search(luby_len);
      if (budget_conflicts_ >= 0 && conflicts_this_call_ >= budget_conflicts_)
        { if (status == 0) break; }
      if (deadline_ > 0 && now() > deadline_)
        { if (status == 0) break; }
    }
    if (status == 1) {
      model_.assign(assigns_.begin(), assigns_.end());
    }
    // irrelevant vars stashed out of the decision heap during this
    // query go back so later (differently-coned) queries see them
    for (Var v : stash_) {
      if (heap_pos_[v] == -1) heap_insert(v);
    }
    stash_.clear();
    // the decision restriction is one-shot: callers issue set_relevant
    // immediately before each solve; letting it persist would silently
    // run later direct solves under a stale foreign query's cone (and
    // its early all-relevant-assigned SAT return would be unsound for
    // them)
    restricted_ = false;
    if (status == -1) {
      // certify the verdict: DB-level UNSAT (5) is checkable by unit
      // propagation alone; assumption UNSAT (4) by propagating the
      // assumption cube over the live clause set
      if (!ok_) proof_event(5, nullptr, 0);
      else proof_event(4, assumptions_.data(), assumptions_.size());
    }
    // keep the trail: the next call reuses the matching prefix
    return status;
  }

  int model_value(Var v) const {
    if (v < 0 || (size_t)v >= model_.size()) return 0;
    return model_[v];
  }

  int64_t conflicts() const { return total_conflicts_; }
  int64_t num_clauses() const { return (int64_t)clauses_.size(); }
  int32_t num_vars() const { return (int32_t)assigns_.size() - 1; }
  int64_t propagations() const { return propagations_; }
  int64_t decisions() const { return decisions_; }
  int64_t restarts() const { return restarts_; }
  int64_t reduces() const { return reduces_; }
  int64_t vivified_lits() const { return vivified_lits_; }

  // ---- proof logging (wrong-UNSAT defense, SURVEY §4) ----
  //
  // A DRAT-style event stream: every ORIGINAL clause (as normalized and
  // attached), every LEARNED clause (each must have the RUP property
  // against the clauses live at that point), every deletion, and a
  // final conflict event for each UNSAT verdict.  An independent
  // checker (mythril_tpu/smt/drat.py) replays the stream with its own
  // propagator: a corrupted learned clause fails its RUP check, so a
  // wrong UNSAT cannot ship silently.  Encoding: int32 records
  // [marker, lits..., 0] with markers ORIG=3, LEARN=1, DELETE=2,
  // ASSUMPTION_CONFLICT=4 (lits = the assumption set), DB_CONFLICT=5.
  void proof_enable() {
    proof_enabled_ = true;
    // the constructor's constant-TRUE anchor unit {1} predates any
    // proof_enable() call; without it the checker cannot certify
    // verdicts involving the FALSE_LIT (-1) assumption
    Lit anchor = 1;
    proof_event(3, &anchor, 1);
  }
  bool proof_enabled() const { return proof_enabled_; }
  bool proof_overflowed() const { return proof_overflow_; }
  int64_t proof_size() const { return (int64_t)proof_.size(); }
  int64_t proof_fetch(int32_t* out, int64_t cap) const {
    int64_t n = std::min(cap, (int64_t)proof_.size());
    std::memcpy(out, proof_.data(), n * sizeof(int32_t));
    return n;
  }
  void proof_clear() { proof_.clear(); proof_overflow_ = false; }
  int core_size() const { return (int)conflict_core_.size(); }
  const Lit* core() const { return conflict_core_.data(); }

  // Export live learned clauses of width <= max_width, flattened with a
  // 0 terminator per clause, starting at clause index `from` (so callers
  // pull only clauses learned since their last sync).  Returns the
  // number of int32 slots written; *next is the clause index to resume
  // from on the next call.
  int64_t collect_learnts(int32_t max_width, int64_t from, Lit* out,
                          int64_t cap, int64_t* next) const {
    int64_t written = 0;
    int64_t idx = from < 0 ? 0 : from;
    for (; idx < (int64_t)clauses_.size(); ++idx) {
      const Clause& c = clauses_[idx];
      if (!c.learned || c.deleted) continue;
      int32_t n = c.size;
      if (n == 0 || n > max_width) continue;
      if (written + n + 1 > cap) break;
      const Lit* ls = clause_lits(c);
      for (int32_t k = 0; k < n; ++k) out[written++] = ls[k];
      out[written++] = 0;
    }
    if (next) *next = idx;
    return written;
  }

 private:
  // ---- state ----
  bool ok_ = true;
  vector<Clause> clauses_;
  vector<Lit> arena_;  // all clause literals, contiguous (see Clause)
  int64_t arena_dead_ = 0;  // dead literal slots (deleted-clause holes)

  inline Lit* clause_lits(Clause& c) { return arena_.data() + c.offset; }
  inline const Lit* clause_lits(const Clause& c) const {
    return arena_.data() + c.offset;
  }

  // Compact the arena when dead holes outweigh live literals: clause
  // INDICES are the only references watchers, reasons and learnts_
  // hold, so compaction just rewrites each live clause's offset.
  // Callers must not hold clause_lits pointers across this (reduceDB's
  // call site holds none).
  void compact_arena() {
    if (arena_dead_ < (int64_t)1 << 20 ||
        arena_dead_ < (int64_t)arena_.size() / 2)
      return;
    vector<Lit> fresh;
    fresh.reserve(arena_.size() - arena_dead_);
    for (Clause& c : clauses_) {
      if (c.deleted || c.size == 0) continue;
      int64_t at = (int64_t)fresh.size();
      fresh.insert(fresh.end(), arena_.begin() + c.offset,
                   arena_.begin() + c.offset + c.size);
      c.offset = at;
    }
    arena_.swap(fresh);
    arena_.shrink_to_fit();
    arena_dead_ = 0;
  }
  vector<vector<Watcher>> watches_;   // indexed by lit_index
  vector<vector<Watcher>> bin_watches_;  // binary-clause implications
  vector<int8_t> assigns_;            // var -> 0/1/-1
  vector<int> level_;
  vector<int> reason_;                // var -> clause idx or -1
  vector<Lit> trail_;
  vector<int> trail_lim_;
  size_t qhead_ = 0;
  vector<double> activity_;
  double var_inc_ = 1.0;
  double cla_inc_ = 1.0;
  vector<int8_t> polarity_;
  vector<int8_t> seen_;
  vector<Var> heap_;
  vector<int> heap_pos_;
  vector<Lit> assumptions_;
  vector<Lit> prev_assumptions_;  // for assumption-prefix trail reuse
  // decision restriction (see set_relevant): epoch-stamped so installing
  // a new cone is O(cone), not O(num_vars) — at deep-analysis scale the
  // per-query memset over millions of vars costs more than small solves
  vector<int64_t> relevant_;
  int64_t relevant_epoch_ = 0;
  bool restricted_ = false;
  bool cone_prop_ = true;
  bool vivify_enabled_ = true;
  bool adaptive_restart_ = true;
  vector<Var> stash_;             // irrelevant vars parked during a solve
  vector<Lit> conflict_core_;
  vector<int8_t> model_;
  int64_t budget_conflicts_ = -1;
  int64_t conflicts_this_call_ = 0;
  int64_t total_conflicts_ = 0;
  int64_t propagations_ = 0;
  int64_t decisions_ = 0;
  int64_t restarts_ = 0;
  int64_t reduces_ = 0;
  int64_t vivified_lits_ = 0;
  double deadline_ = -1.0;
  int64_t max_local_ = 8192;      // local-tier budget (see reduceDB)
  vector<int> learnts_;           // indices of tier1/tier2 learned clauses
  // glucose-style adaptive restarts: restart when the recent learnt-LBD
  // EMA runs above the long-run EMA (search is thrashing), blocked when
  // the trail is much deeper than usual (likely closing in on SAT)
  double lbd_ema_fast_ = 0.0;
  double lbd_ema_slow_ = 0.0;
  double trail_ema_ = 0.0;
  int64_t conflicts_since_restart_ = 0;
  vector<int64_t> lbd_stamp_;
  int64_t lbd_stamp_counter_ = 0;
  int64_t next_reduce_at_ = kReduceInterval;
  static constexpr int64_t kReduceInterval = 4096;
  int64_t next_viv_at_ = kVivInterval;
  static constexpr int64_t kVivInterval = 20000;
  int64_t core_count_ = 0;
  // Bounds immortal-glue memory without forfeiting its pruning power:
  // capping at 64k measured 3x the conflicts of the unbounded tier on
  // batchtoken -t3 (599.9k vs 204.8k — glue re-derivation), while 1M
  // core clauses cost only ~40 MB in the arena representation.
  static constexpr int64_t kCoreCap = 1 << 20;
  bool proof_enabled_ = false;
  bool proof_overflow_ = false;
  vector<int32_t> proof_;
  static constexpr int64_t kProofCap = (int64_t)1 << 24;  // 64 MB of int32

  void proof_event(int32_t marker, const Lit* lits, size_t n) {
    if (!proof_enabled_ || proof_overflow_) return;
    if ((int64_t)proof_.size() + (int64_t)n + 2 > kProofCap) {
      proof_overflow_ = true;
      return;
    }
    proof_.push_back(marker);
    proof_.insert(proof_.end(), lits, lits + n);
    proof_.push_back(0);
  }

  static double now() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
  }

  // Glucose-style adaptive restart: fire when the recent learnt-LBD
  // EMA runs well above the long-run average (the current search
  // region is producing weak clauses), blocked while the trail is much
  // deeper than usual (deep consistent trails suggest an imminent SAT
  // answer a restart would throw away).
  bool restart_now(int32_t /*learnt_lbd*/) const {
    if (!adaptive_restart_) return false;
    if (conflicts_since_restart_ < 64) return false;
    if (lbd_ema_fast_ * 0.8 <= lbd_ema_slow_) return false;
    // trail blocker only once its EMA has warmed up — cold (near-zero)
    // trail_ema_ would otherwise block every restart for the first few
    // thousand conflicts, inverting the policy
    if (total_conflicts_ > 4096 &&
        (double)trail_.size() > 1.4 * trail_ema_) return false;  // blocked
    return true;
  }

  static int64_t luby(int x) {
    // Canonical Luby sequence 1 1 2 1 1 2 4 ... (base 2)
    int size = 1, seq = 0;
    while (size < x + 1) { ++seq; size = 2 * size + 1; }
    while (size - 1 != x) { size = (size - 1) >> 1; --seq; x = x % size; }
    return (int64_t)1 << seq;
  }

  int value(Lit l) const {
    int8_t a = assigns_[std::abs(l)];
    return l > 0 ? a : -a;
  }
  int level_of(Lit l) const { return level_[std::abs(l)]; }
  int decision_level() const { return (int)trail_lim_.size(); }

  // ---- heap (max-heap on activity) ----
  bool heap_less(Var a, Var b) const { return activity_[a] > activity_[b]; }
  void heap_insert(Var v) {
    if (heap_pos_[v] != -1) return;
    heap_pos_[v] = (int)heap_.size();
    heap_.push_back(v);
    heap_up(heap_pos_[v]);
  }
  void heap_up(int i) {
    Var x = heap_[i];
    while (i > 0) {
      int p = (i - 1) >> 1;
      if (!heap_less(x, heap_[p])) break;
      heap_[i] = heap_[p]; heap_pos_[heap_[i]] = i; i = p;
    }
    heap_[i] = x; heap_pos_[x] = i;
  }
  void heap_down(int i) {
    Var x = heap_[i];
    int n = (int)heap_.size();
    while (true) {
      int c = 2 * i + 1;
      if (c >= n) break;
      if (c + 1 < n && heap_less(heap_[c + 1], heap_[c])) ++c;
      if (!heap_less(heap_[c], x)) break;
      heap_[i] = heap_[c]; heap_pos_[heap_[i]] = i; i = c;
    }
    heap_[i] = x; heap_pos_[x] = i;
  }
  Var heap_pop() {
    Var top = heap_[0];
    heap_pos_[top] = -1;
    heap_[0] = heap_.back();
    heap_.pop_back();
    if (!heap_.empty()) { heap_pos_[heap_[0]] = 0; heap_down(0); }
    return top;
  }

  void var_bump(Var v) {
    activity_[v] += var_inc_;
    if (activity_[v] > 1e100) {
      for (size_t i = 1; i < activity_.size(); ++i) activity_[i] *= 1e-100;
      var_inc_ *= 1e-100;
    }
    if (heap_pos_[v] != -1) heap_up(heap_pos_[v]);
  }
  void var_decay() { var_inc_ /= 0.95; }

  // ---- clause attachment ----

  // Binary clauses live in dedicated implication lists: propagation
  // reads the implied literal directly instead of touching the Clause
  // object (most of the pool is 2-lit Tseitin gate clauses, so this is
  // the hot path of every BCP pass).  Shared by attach() and the
  // reduceDB watch rebuild so the routing rule cannot drift.
  void attach_watchers(int idx, const Lit* lits, int32_t n) {
    auto& target = n == 2 ? bin_watches_ : watches_;
    target[lit_index(-lits[0])].push_back({idx, lits[1]});
    target[lit_index(-lits[1])].push_back({idx, lits[0]});
  }

  int attach(const vector<Lit>& lits, bool learned) {
    int idx = (int)clauses_.size();
    Clause c;
    c.activity = (float)cla_inc_;
    c.learned = learned;
    c.offset = (int64_t)arena_.size();
    c.size = (int32_t)lits.size();
    arena_.insert(arena_.end(), lits.begin(), lits.end());
    clauses_.push_back(c);
    attach_watchers(idx, clause_lits(clauses_[idx]), c.size);
    return idx;
  }

  void uncheckedEnqueue(Lit l, int reason_clause) {
    Var v = std::abs(l);
    assigns_[v] = l > 0 ? 1 : -1;
    level_[v] = decision_level();
    reason_[v] = reason_clause;
    trail_.push_back(l);
  }

  // returns conflicting clause idx or -1
  int propagate() {
    while (qhead_ < trail_.size()) {
      Lit p = trail_[qhead_++];
      ++propagations_;
      // binary implications first: p true forces w.blocker for every
      // entry; no watch moving, no Clause access
      auto& bws = bin_watches_[lit_index(p)];
      for (const Watcher& w : bws) {
        int v = value(w.blocker);
        if (v == -1) return w.clause;  // conflict
        if (v == 0) {
          // cone-restricted propagation: an implication into a variable
          // outside the query's cone is skipped, so cascades die at the
          // cone boundary instead of flooding the shared pool's entire
          // downstream circuit.  Soundness mirrors the decision
          // restriction (see set_relevant): the skipped variable stays
          // unassigned for the whole query, so its clauses can never be
          // fully falsified — no conflict can be missed, and the
          // definitional-completion argument for early SAT still holds.
          if (cone_prop_ && restricted_ && !is_relevant(std::abs(w.blocker)))
            continue;
          uncheckedEnqueue(w.blocker, w.clause);
        }
      }
      auto& ws = watches_[lit_index(p)];
      size_t i = 0, j = 0;
      while (i < ws.size()) {
        Watcher w = ws[i];
        if (value(w.blocker) == 1) { ws[j++] = ws[i++]; continue; }
        Clause& c = clauses_[w.clause];
        if (c.deleted) { ++i; continue; }
        Lit* cl = clause_lits(c);
        // ensure cl[1] is the false literal (-p)
        if (cl[0] == -p) std::swap(cl[0], cl[1]);
        Lit first = cl[0];
        if (value(first) == 1) { ws[j++] = {w.clause, first}; ++i; continue; }
        bool moved = false;
        for (int32_t k = 2; k < c.size; ++k) {
          if (value(cl[k]) != -1) {
            std::swap(cl[1], cl[k]);
            watches_[lit_index(-cl[1])].push_back({w.clause, first});
            moved = true;
            break;
          }
        }
        if (moved) { ++i; continue; }
        if (value(first) == -1) {
          // conflict: restore remaining watchers
          while (i < ws.size()) ws[j++] = ws[i++];
          ws.resize(j);
          return w.clause;
        }
        // cone-restricted propagation (see the binary path above): a
        // unit implication into an out-of-cone variable stays dormant.
        // The watcher is kept; if the variable is ever falsified later
        // (a different query's cone) the normal watch machinery still
        // sees it, so conflicts cannot be missed.
        if (cone_prop_ && restricted_ && !is_relevant(std::abs(first))) {
          ws[j++] = {w.clause, first};
          ++i;
          continue;
        }
        uncheckedEnqueue(first, w.clause);
        ws[j++] = {w.clause, first};
        ++i;
      }
      ws.resize(j);
    }
    return -1;
  }

  void cancelUntil(int target_level) {
    if (decision_level() <= target_level) return;
    for (int i = (int)trail_.size() - 1; i >= trail_lim_[target_level]; --i) {
      Var v = std::abs(trail_[i]);
      polarity_[v] = assigns_[v] > 0 ? 1 : 0;
      assigns_[v] = 0;
      reason_[v] = -1;
      heap_insert(v);
    }
    trail_.resize(trail_lim_[target_level]);
    trail_lim_.resize(target_level);
    qhead_ = trail_.size();
  }

  void cla_bump(int ci) {
    Clause& c = clauses_[ci];
    c.activity += (float)cla_inc_;
    if (c.activity > 1e20f) {
      for (auto& cl : clauses_) if (cl.learned) cl.activity *= 1e-20f;
      cla_inc_ *= 1e-20;
    }
  }

  // 1UIP learning; fills out_learnt, returns backtrack level
  int analyze(int confl, vector<Lit>& out_learnt) {
    out_learnt.clear();
    out_learnt.push_back(0);  // placeholder for the asserting literal
    int path_count = 0;
    Lit p = 0;
    int index = (int)trail_.size() - 1;
    int c = confl;
    do {
      Clause& cl = clauses_[c];
      if (cl.learned) {
        cla_bump(c);
        cl.used = 1;
        // LBD refresh on use (glucose): a clause whose literals now sit
        // on fewer distinct levels than at learn time has become
        // stronger — keep the lower value and promote across tiers
        if (cl.lbd > 2 && cl.size > 2) {
          int32_t fresh = clause_lbd(clause_lits(cl), cl.size);
          if (fresh < cl.lbd) {
            cl.lbd = fresh;
            if (fresh <= 2 && core_count_ < kCoreCap) {
              cl.tier = 0;  // now core: kept forever (bounded by cap)
              ++core_count_;
            } else if (fresh <= 6 && cl.tier == 2) {
              cl.tier = 1;
            }
          }
        }
      }
      const Lit* cls = clause_lits(cl);
      for (int32_t k = 0; k < cl.size; ++k) {
        Lit q = cls[k];
        // skip the implied literal by identity, not position: binary
        // implications enqueue the watcher's blocker, which need not
        // be lits[0]
        if (p != 0 && q == p) continue;
        Var v = std::abs(q);
        if (!seen_[v] && level_[v] > 0) {
          seen_[v] = 1;
          var_bump(v);
          if (level_[v] >= decision_level()) ++path_count;
          else out_learnt.push_back(q);
        }
      }
      while (!seen_[std::abs(trail_[index])]) --index;
      p = trail_[index];
      c = reason_[std::abs(p)];
      seen_[std::abs(p)] = 0;
      --path_count;
      --index;
      if (p != 0 && c == -1 && path_count > 0) {
        // should not happen (decision var reached with paths left)
        break;
      }
    } while (path_count > 0);
    out_learnt[0] = -p;

    // local minimization (conservative: drop lits whose reason clause is
    // subsumed by the remaining learnt literals)
    vector<Lit> to_clear(out_learnt);
    vector<Lit> minimized;
    minimized.push_back(out_learnt[0]);
    for (size_t i = 1; i < out_learnt.size(); ++i) {
      Var v = std::abs(out_learnt[i]);
      int r = reason_[v];
      bool redundant = false;
      if (r != -1) {
        redundant = true;
        const Clause& rc = clauses_[r];
        const Lit* rls = clause_lits(rc);
        for (int32_t k = 0; k < rc.size; ++k) {
          Var qv = std::abs(rls[k]);
          if (qv == v) continue;
          if (!seen_[qv] && level_[qv] > 0) { redundant = false; break; }
        }
      }
      if (!redundant) minimized.push_back(out_learnt[i]);
    }
    out_learnt.swap(minimized);
    for (Lit q : to_clear) seen_[std::abs(q)] = 0;

    if (out_learnt.size() == 1) return 0;
    // find second-highest level
    int max_i = 1;
    for (size_t i = 2; i < out_learnt.size(); ++i)
      if (level_of(out_learnt[i]) > level_of(out_learnt[max_i])) max_i = (int)i;
    std::swap(out_learnt[1], out_learnt[max_i]);
    return level_of(out_learnt[1]);
  }

  // UNSAT-under-assumptions core from a failing assumption literal.
  void analyzeFinal(Lit p) {
    conflict_core_.clear();
    conflict_core_.push_back(p);
    if (decision_level() == 0) return;
    seen_[std::abs(p)] = 1;
    for (int i = (int)trail_.size() - 1; i >= trail_lim_[0]; --i) {
      Var v = std::abs(trail_[i]);
      if (!seen_[v]) continue;
      if (reason_[v] == -1) {
        if (level_[v] > 0) conflict_core_.push_back(-trail_[i]);
      } else {
        const Clause& rc = clauses_[reason_[v]];
        const Lit* rls = clause_lits(rc);
        for (int32_t k = 0; k < rc.size; ++k)
          if (level_of(rls[k]) > 0) seen_[std::abs(rls[k])] = 1;
      }
      seen_[v] = 0;
    }
    seen_[std::abs(p)] = 0;
  }

  // distinct decision levels among a clause's literals (glucose LBD):
  // low-LBD ("glue") clauses connect few search levels and keep paying
  // propagation long after their activity decays
  int32_t clause_lbd(const vector<Lit>& lits) {
    return clause_lbd(lits.data(), (int32_t)lits.size());
  }
  int32_t clause_lbd(const Lit* lits, int32_t n) {
    ++lbd_stamp_counter_;
    if (lbd_stamp_.size() < (size_t)decision_level() + 2)
      lbd_stamp_.resize(decision_level() + 2, 0);
    int32_t distinct = 0;
    for (int32_t li = 0; li < n; ++li) {
      Lit l = lits[li];
      int lv = level_of(l);
      if (lv >= 0 && (size_t)lv < lbd_stamp_.size() &&
          lbd_stamp_[lv] != lbd_stamp_counter_) {
        lbd_stamp_[lv] = lbd_stamp_counter_;
        ++distinct;
      }
    }
    return distinct;
  }

  // A clause is locked while it is the reason of its asserting literal.
  // Propagation always enqueues lits[0] with the clause as reason (the
  // watch code swaps the implied literal into slot 0 for >2-lit
  // clauses), so the check is O(1) — no O(pool) locked bitmap.
  bool is_locked(int ci) const {
    const Clause& c = clauses_[ci];
    if (c.size == 0) return false;
    Var v = std::abs(clause_lits(c)[0]);
    return assigns_[v] != 0 && reason_[v] == ci;
  }

  void delete_clause(int ci) {
    Clause& c = clauses_[ci];
    c.deleted = true;
    proof_event(2, clause_lits(c), c.size);
    arena_dead_ += c.size;
    c.size = 0;  // the hole is reclaimed by compact_arena on cadence
  }

  // Tiered reduction (CaDiCaL-style): core (lbd <= 2) is never touched,
  // tier2 clauses unused for two consecutive reduce rounds demote to
  // local, and the weakest (lbd, activity) half of local dies.  Deleted
  // clauses are purged from watch lists lazily during propagation — the
  // old full watch rebuild was an O(pool) scan per reduce, which at the
  // 4.6M-clause pools of -t3 analyses dwarfed the search it served.
  void reduceDB() {
    ++reduces_;
    vector<int> local_idx;
    size_t keep = 0;
    for (int ci : learnts_) {
      Clause& c = clauses_[ci];
      if (c.deleted) continue;   // compact out
      if (c.tier == 0) continue; // promoted to core: leaves the pool
      if (c.tier == 1) {
        if (!c.used) {
          // demoted after a full unused round, with one more round of
          // grace before it can be killed (not a candidate this round)
          c.tier = 2;
          learnts_[keep++] = ci;
          continue;
        }
        c.used = 0;
        learnts_[keep++] = ci;
        continue;
      }
      c.used = 0;
      local_idx.push_back(ci);
      learnts_[keep++] = ci;
    }
    learnts_.resize(keep);
    if ((int64_t)local_idx.size() < max_local_) return;
    std::sort(local_idx.begin(), local_idx.end(), [&](int a, int b) {
      if (clauses_[a].lbd != clauses_[b].lbd)
        return clauses_[a].lbd > clauses_[b].lbd;
      return clauses_[a].activity < clauses_[b].activity;
    });
    size_t kill = local_idx.size() / 2;
    size_t killed = 0;
    for (size_t i = 0; i < kill; ++i) {
      int ci = local_idx[i];
      if (is_locked(ci)) continue;
      delete_clause(ci);
      ++killed;
    }
    if (killed) {
      keep = 0;
      for (int ci : learnts_)
        if (!clauses_[ci].deleted) learnts_[keep++] = ci;
      learnts_.resize(keep);
    }
    max_local_ += max_local_ / 20;
    compact_arena();
  }

  // Clause vivification (inprocessing): for a learned clause
  // (l1 ∨ … ∨ lk), assert ¬l1, ¬l2, … one decision level at a time and
  // propagate.  A conflict after i decisions proves (l1 ∨ … ∨ li) — a
  // strict strengthening; a literal already false under the prefix is
  // redundant and drops; a literal already true ends the clause there.
  // Every result (even an unchanged clause) is re-attached as a FRESH
  // clause and the original deleted: the original's watchers may have
  // been lazily dropped while it was masked during the probe, and
  // re-attaching fresh is the only state that cannot leave a clause
  // silently unwatched.  Proof order: LEARN new (RUP — it was derived
  // by unit propagation over the live DB), then DELETE old.
  // Precondition: decision level 0, propagation at fixpoint.
  void vivify() {
    int64_t prop_budget = 3000000;
    int64_t scanned = 0;
    size_t bound = learnts_.size();  // snapshot: re-attached copies are
                                     // appended and must not be re-walked
    for (size_t i = 0; i < bound && prop_budget > 0 && scanned < 4000; ++i) {
      int ci = learnts_[i];
      if (clauses_[ci].deleted || clauses_[ci].vivified) continue;
      if (clauses_[ci].size < 3 || clauses_[ci].size > 32)
        continue;
      if (is_locked(ci)) continue;
      ++scanned;
      // copy out of the arena: attach below appends to it
      vector<Lit> lits(clause_lits(clauses_[ci]),
                       clause_lits(clauses_[ci]) + clauses_[ci].size);
      clauses_[ci].deleted = true;  // mask from its own derivation
      vector<Lit> kept;
      bool satisfied = false, conflicted = false;
      for (size_t li = 0; li < lits.size(); ++li) {
        Lit l = lits[li];
        int v = value(l);
        if (v == 1) { kept.push_back(l); satisfied = true; break; }
        if (v == -1) continue;  // ¬prefix ⊨ ¬l: drop
        kept.push_back(l);
        trail_lim_.push_back((int)trail_.size());
        uncheckedEnqueue(-l, -1);
        int64_t before = propagations_;
        int confl = propagate();
        prop_budget -= (propagations_ - before);
        if (confl != -1) { conflicted = true; break; }
        if (prop_budget <= 0) {
          // out of budget mid-clause: the unexamined tail has NOT been
          // proven redundant — keep it verbatim (v==-1 drops above
          // remain sound on their own)
          kept.insert(kept.end(), lits.begin() + li + 1, lits.end());
          break;
        }
      }
      cancelUntil(0);
      if (satisfied && kept.size() == 1 && value(kept[0]) == 1 &&
          level_of(kept[0]) == 0) {
        // satisfied at level 0 forever: drop the clause outright
        proof_event(2, lits.data(), lits.size());
        arena_dead_ += (int64_t)lits.size();
        clauses_[ci].size = 0;
        vivified_lits_ += (int64_t)lits.size();
        continue;
      }
      if (!conflicted && !satisfied && kept.size() == lits.size()) {
        // walked off the end (or out of budget) with nothing learned:
        // re-attach an identical fresh copy (see comment above)
        clauses_[ci].deleted = false;
        int fresh = attach(lits, true);
        Clause& fc = clauses_[fresh];
        fc.lbd = clauses_[ci].lbd;
        fc.tier = clauses_[ci].tier;
        fc.vivified = 1;
        if (fc.tier > 0) learnts_.push_back(fresh);
        clauses_[ci].deleted = true;
        arena_dead_ += (int64_t)lits.size();
        clauses_[ci].size = 0;
        continue;
      }
      vivified_lits_ += (int64_t)(lits.size() - kept.size());
      proof_event(1, kept.data(), kept.size());
      if (kept.size() == 1) {
        clauses_[ci].deleted = false;  // keep live for the unit's RUP
        if (value(kept[0]) == 0) {
          uncheckedEnqueue(kept[0], -1);
          if (propagate() != -1) ok_ = false;
        } else if (value(kept[0]) == -1) {
          ok_ = false;
        }
        clauses_[ci].deleted = true;
        proof_event(2, lits.data(), lits.size());
        arena_dead_ += (int64_t)lits.size();
        clauses_[ci].size = 0;
        if (!ok_) return;
        continue;
      }
      int fresh = attach(kept, true);
      Clause& fc = clauses_[fresh];
      int32_t lbd = clauses_[ci].lbd;
      fc.lbd = std::min<int32_t>(lbd, (int32_t)kept.size() - 1);
      fc.vivified = 1;
      if (kept.size() > 2) {
        if (fc.lbd <= 2 && core_count_ < kCoreCap) {
          fc.tier = 0;
          ++core_count_;
        } else {
          fc.tier = fc.lbd <= 6 ? 1 : 2;
        }
        if (fc.tier > 0) learnts_.push_back(fresh);
      } else {
        fc.tier = 0;  // binary: permanent (binary watches skip `deleted`)
      }
      proof_event(2, lits.data(), lits.size());
      arena_dead_ += (int64_t)lits.size();
      clauses_[ci].size = 0;
    }
  }

  // returns 1 sat / -1 unsat / 0 keep going (restart or budget)
  int search(int64_t conflicts_allowed) {
    int64_t local_conflicts = 0;
    vector<Lit> learnt;
    while (true) {
      int confl = propagate();
      if (confl != -1) {
        ++local_conflicts; ++conflicts_this_call_; ++total_conflicts_;
        ++conflicts_since_restart_;
        if (decision_level() == 0) { ok_ = false; return -1; }
        if (decision_level() <= (int)assumptions_.size()) {
          // Conflict with only assumption decisions on the trail: the
          // assumption set is jointly UNSAT with the clause DB.  (Core
          // extraction intentionally omitted — no consumer yet; see
          // analyzeFinal for the per-literal path.)
          //
          // Backtrack below the conflicting level before returning.
          // The conflict clause always has >=1 literal assigned at the
          // current level (each level is fully propagated before the
          // next assumption is decided), so undoing one level leaves no
          // falsified clause fully assigned on the kept trail.  Without
          // this, a later solve() reusing the assumption prefix would
          // inherit the conflicting assignments with qhead_ already
          // past them and could answer SAT against a falsified clause.
          conflict_core_.clear();
          cancelUntil(decision_level() - 1);
          return -1;
        }
        int back_level = analyze(confl, learnt);
        // LBD must be measured BEFORE the backjump: cancelUntil clears
        // assignments but leaves stale level_ entries behind
        int32_t learnt_lbd = clause_lbd(learnt);
        // adaptive-restart signals (glucose): recent-vs-long-run learnt
        // LBD, and the trail depth at conflict time for the SAT blocker
        lbd_ema_fast_ += (1.0 / 32.0) * ((double)learnt_lbd - lbd_ema_fast_);
        lbd_ema_slow_ += (1.0 / 8192.0) * ((double)learnt_lbd - lbd_ema_slow_);
        trail_ema_ += (1.0 / 4096.0) * ((double)trail_.size() - trail_ema_);
        proof_event(1, learnt.data(), learnt.size());
        cancelUntil(std::max(back_level, 0));
        if (learnt.size() == 1) {
          if (value(learnt[0]) == 0) uncheckedEnqueue(learnt[0], -1);
          else if (value(learnt[0]) == -1) {
            // analyze() returns back_level 0 for unit learnts, so after
            // cancelUntil above we are at level 0 and a false unit means
            // the DB itself is UNSAT.  (The >0 return is defensive and
            // unreachable; it still honors the trail-hygiene contract of
            // the assumption-conflict path above.)
            if (decision_level() == 0) { ok_ = false; return -1; }
            cancelUntil(decision_level() - 1);
            return -1;
          }
        } else {
          int ci = attach(learnt, true);
          Clause& lc = clauses_[ci];
          lc.lbd = learnt_lbd;
          // tier at learn time; binary learnts stay out of learnts_ —
          // the binary-watch fast path never checks `deleted`, so
          // binary clauses must be permanent (they are glue anyway)
          if (learnt.size() > 2) {
            if (learnt_lbd <= 2 && core_count_ < kCoreCap) {
              lc.tier = 0;
              ++core_count_;
            } else {
              lc.tier = learnt_lbd <= 6 ? 1 : 2;
            }
            if (lc.tier > 0) learnts_.push_back(ci);
          } else {
            lc.tier = 0;  // binary: permanent regardless (watch scheme)
          }
          uncheckedEnqueue(learnt[0], ci);
        }
        var_decay();
        cla_inc_ *= 1.001;
        if (total_conflicts_ >= next_reduce_at_) {
          reduceDB();
          next_reduce_at_ = total_conflicts_ + kReduceInterval;
        }
        if (budget_conflicts_ >= 0 && conflicts_this_call_ >= budget_conflicts_)
          return 0;
        if (deadline_ > 0 && (conflicts_this_call_ & 255) == 0 &&
            now() > deadline_)
          return 0;
        if (local_conflicts >= conflicts_allowed ||
            restart_now(learnt_lbd)) {
          // restart: undo search decisions but keep the assumption
          // levels — re-propagating a large assumption cone on every
          // restart dwarfs the restart's benefit
          ++restarts_;
          conflicts_since_restart_ = 0;
          cancelUntil(std::min(decision_level(),
                               (int)assumptions_.size()));
          return 0;  // restart
        }
      } else {
        // assumption decisions first
        if (decision_level() < (int)assumptions_.size()) {
          Lit a = assumptions_[decision_level()];
          int v = value(a);
          if (v == 1) {
            trail_lim_.push_back((int)trail_.size());
            // re-assert as pseudo-decision so level bookkeeping is stable:
            // nothing to enqueue; continue to next level
            continue;
          }
          if (v == -1) { analyzeFinal(-a); return -1; }
          trail_lim_.push_back((int)trail_.size());
          uncheckedEnqueue(a, -1);
          continue;
        }
        // normal decision (restricted to the assumption cone when set)
        ++decisions_;
        Var next = 0;
        while (!heap_.empty()) {
          Var cand = heap_pop();
          if (assigns_[cand] != 0) continue;
          if (restricted_ && !is_relevant(cand)) {
            stash_.push_back(cand);
            continue;
          }
          next = cand;
          break;
        }
        if (next == 0) return 1;  // every relevant var assigned: SAT
        trail_lim_.push_back((int)trail_.size());
        Lit decision = polarity_[next] ? next : -next;
        uncheckedEnqueue(decision, -1);
      }
    }
  }
};

}  // namespace

extern "C" {

void* cdcl_new() { return new Solver(); }
void cdcl_free(void* s) { delete (Solver*)s; }
int32_t cdcl_new_var(void* s) { return ((Solver*)s)->new_var(); }
int32_t cdcl_add_clause(void* s, const int32_t* lits, int32_t n) {
  vector<Lit> v(lits, lits + n);
  return ((Solver*)s)->add_clause(v) ? 1 : 0;
}
int32_t cdcl_solve(void* s, const int32_t* assumps, int32_t n,
                   int64_t conflict_budget, double time_budget_s) {
  return ((Solver*)s)->solve(assumps, n, conflict_budget, time_budget_s);
}
// Bulk clause load: `flat` holds clauses separated by 0 terminators.
// Returns the number of clauses consumed; negative if any clause made
// the database trivially UNSAT (magnitude still counts consumed).
int64_t cdcl_add_clauses(void* s, const int32_t* flat, int64_t n) {
  Solver* sv = (Solver*)s;
  vector<Lit> cur;
  int64_t added = 0;
  bool ok = true;
  for (int64_t i = 0; i < n; ++i) {
    int32_t l = flat[i];
    if (l == 0) {
      if (!sv->add_clause(cur)) ok = false;
      cur.clear();
      ++added;
    } else {
      cur.push_back(l);
    }
  }
  if (!cur.empty()) {
    if (!sv->add_clause(cur)) ok = false;
    ++added;
  }
  return ok ? added : -added;
}
// Bulk model read: out[v] = truth of var v (1 true / -1 false / 0 unset)
// for v in [0, n).  One call replaces n ctypes round-trips.
void cdcl_model_into(void* s, int8_t* out, int32_t n) {
  Solver* sv = (Solver*)s;
  for (int32_t v = 0; v < n; ++v) out[v] = (int8_t)sv->model_value(v);
}
int32_t cdcl_model_value(void* s, int32_t var) {
  return ((Solver*)s)->model_value(var);
}
int64_t cdcl_conflicts(void* s) { return ((Solver*)s)->conflicts(); }
int64_t cdcl_propagations(void* s) { return ((Solver*)s)->propagations(); }
int64_t cdcl_decisions(void* s) { return ((Solver*)s)->decisions(); }
int64_t cdcl_restarts(void* s) { return ((Solver*)s)->restarts(); }
int64_t cdcl_reduces(void* s) { return ((Solver*)s)->reduces(); }
int64_t cdcl_vivified_lits(void* s) { return ((Solver*)s)->vivified_lits(); }
int64_t cdcl_num_clauses(void* s) { return ((Solver*)s)->num_clauses(); }
int32_t cdcl_num_vars(void* s) { return ((Solver*)s)->num_vars(); }
int64_t cdcl_learnt_clauses(void* s, int32_t max_width, int64_t from,
                            int32_t* out, int64_t cap, int64_t* next) {
  return ((Solver*)s)->collect_learnts(max_width, from, out, cap, next);
}
void cdcl_set_relevant(void* s, const int32_t* vars, int64_t n) {
  ((Solver*)s)->set_relevant(vars, n);
}
void cdcl_relevant_begin(void* s) { ((Solver*)s)->relevant_begin(); }
void cdcl_relevant_mark(void* s, const int32_t* vars, int64_t n) {
  ((Solver*)s)->relevant_mark(vars, n);
}
void cdcl_proof_enable(void* s) { ((Solver*)s)->proof_enable(); }
int32_t cdcl_proof_enabled(void* s) {
  return ((Solver*)s)->proof_enabled() ? 1 : 0;
}
int32_t cdcl_proof_overflowed(void* s) {
  return ((Solver*)s)->proof_overflowed() ? 1 : 0;
}
int64_t cdcl_proof_size(void* s) { return ((Solver*)s)->proof_size(); }
int64_t cdcl_proof_fetch(void* s, int32_t* out, int64_t cap) {
  return ((Solver*)s)->proof_fetch(out, cap);
}
void cdcl_proof_clear(void* s) { ((Solver*)s)->proof_clear(); }

}  // extern "C"
