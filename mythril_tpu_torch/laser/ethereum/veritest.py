"""Veritesting tier: state merging at re-convergence and frontier
subsumption (own copy of ``mythril_tpu/laser/ethereum/veritest.py``).

The lockstep tier (symbolic_lockstep.py) makes sibling states cheap to
step; this module makes them fewer.  Two transitions run on the
scheduler's work list between rounds:

- **Merge at re-convergence.**  Sibling lanes that re-converge at the
  same ``(bytecode, pc)`` after a branch diamond (both arms of a JUMPI
  surviving and jumping back to the same JUMPDEST) collapse into one
  lane.  Machine words that agree (by term node identity or equal
  constants) are kept verbatim; words that disagree become
  ``If(cond_a, a, b)`` terms under the diverging path condition, and
  the two constraint suffixes join as a disjunction over the shared
  prefix.  The carried limb planes take the word-tier meet (known bits
  both lanes agree on survive; ``ops/lockstep.join_known_bits``).
  Where the join lattice has no sound element (diverged storage arrays:
  smt ``If`` has no Array sort; mismatched annotations; mixed sorts)
  the merge aborts and plain forking continues: a missed merge costs
  only path count, never soundness.
- **Frontier subsumption.**  A lane whose constraint set syntactically
  implies a sibling's at the same ``(bytecode, pc, storage digest)``
  (every constraint of the survivor present by node id, or
  interval-implied at word level: ``smt/word_tier.interval_implies``)
  retires without reaching a solver: its models are a subset of the
  survivor's and the machine states are identical, so every path and
  every finding the retired lane could reach is reachable from the
  survivor.  The set-inclusion test over a site's lanes is one bitset
  pass on the host (``ops/resident.subset_matrix``).

Merges are attempted only at static re-convergence points
(:meth:`SegmentPlan.join_pcs`: JUMPDESTs with two or more inbound
edges); each side's diverging constraint suffix is bounded by
``MYTHRIL_TPU_MERGE_WINDOW`` and the number of ``If`` terms one join may
mint by ``MYTHRIL_TPU_MERGE_MAX_ITES``.

Kill switch: ``MYTHRIL_TPU_VERITEST=0`` pins the fork-only path (the
engine is never made and the work list never touched).  The tier also
declines under statespace recording, gas tracking and
CREATE-transactions, whose consumers need per-fork states.

Telemetry: ``merges`` / ``merged_lanes`` / ``merge_ites`` /
``merge_aborts`` / ``subsume_sweeps`` / ``subsumed_lanes`` on
DispatchStats, and the wall-clock of both passes (the ``svm.merge`` and
``svm.subsume`` spans) in ``merge_span_s``.  Merged and retired lanes
count as the lane ledger's ``merge`` / ``subsume`` transitions
(``observability/ledger.py``).  Fault seam: an armed ``merge_abort``
shot (``resilience/faults.py``) aborts one merge mid-join, and the pair
forks on.
"""

import logging
from copy import copy
from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints
from mythril_tpu_torch.observability import spans as obs
from mythril_tpu_torch.smt import And, If, Or, symbol_factory
from mythril_tpu_torch.support.env import env_flag, env_int

log = logging.getLogger(__name__)

#: default caps (env-overridable; registered in support/env.py)
MERGE_MAX_ITES = 16     # If terms one join may mint
MERGE_WINDOW = 8        # max diverging constraint suffix per side
SUBSUME_PERIOD = 4      # scheduler rounds between subsumption sweeps

#: annotation-normalizer recursion cap — anything deeper is opaque and
#: the states holding it simply never merge
_ANN_DEPTH = 6


def veritest_enabled() -> bool:
    """``MYTHRIL_TPU_VERITEST=0`` pins the exact fork-only path."""
    return env_flag("MYTHRIL_TPU_VERITEST", True)


# ---------------------------------------------------------------------------
# join-point memo (reset via ops/batched_sat.reset_resident_pools)
# ---------------------------------------------------------------------------

#: bytecode string -> frozenset of re-convergence pcs (instruction
#: indices); bounded LRU, quarter eviction like the segment plan cache
_join_memo: Dict[str, frozenset] = {}
_JOIN_MEMO_CAP = 64


def reset_veritest_memos() -> None:
    """Drop the merge/subsumption memo state.  Wired into
    ``ops/batched_sat.reset_resident_pools`` so checkpoint resume and
    blast-context resets invalidate it with everything else."""
    _join_memo.clear()


def _join_pcs_for(code) -> frozenset:
    key = getattr(code, "bytecode", None)
    if not isinstance(key, str):
        return frozenset()
    hit = _join_memo.get(key)
    if hit is not None:
        return hit
    from mythril_tpu_torch.laser.ethereum.symbolic_lockstep import plan_for

    plan = plan_for(code)
    pcs = plan.join_pcs() if plan is not None else frozenset()
    if len(_join_memo) >= _JOIN_MEMO_CAP:
        for stale in list(_join_memo)[: _JOIN_MEMO_CAP // 4]:
            del _join_memo[stale]
    _join_memo[key] = pcs
    return pcs


# ---------------------------------------------------------------------------
# state signatures: what "the same machine state" means, by node id
# ---------------------------------------------------------------------------


class _Unmergeable(Exception):
    """Internal control flow: this pair cannot merge/subsume.  Always
    caught — the outcome is plain forking, never a user-visible error."""


def _value_token(item):
    """Identity token of one machine word: constants by value,
    symbolic terms by interned node id (hash-consed, so equal terms
    share ids), anything else opaque."""
    if isinstance(item, int):
        return ("c", item)
    node = getattr(item, "node", None)
    if node is None:
        raise _Unmergeable
    if node.is_const:
        return ("c", node.value) if node.sort == "bv" else (
            "cb", bool(node.value)
        )
    return ("t", node.id)


def _ann_token(value, depth: int = _ANN_DEPTH):
    """Canonical token of one annotation field value.  Terms compare
    by node id (fork copies share interned terms, so equal-content
    annotations tokenize equal); unknown object graphs raise — the
    states simply never merge."""
    if depth <= 0:
        raise _Unmergeable
    node = getattr(value, "node", None)
    if node is not None and hasattr(node, "id") and hasattr(node, "op"):
        # an smt Expression wrapping an interned term — NOT the CFG's
        # basic-block Node (uid, no op), which falls through to the
        # generic object walk below
        return ("n", node.id)
    if isinstance(value, (int, str, bool, float, bytes, type(None))):
        return ("v", value)
    if isinstance(value, (list, tuple)):
        return ("l", tuple(_ann_token(v, depth - 1) for v in value))
    if isinstance(value, (set, frozenset)):
        return ("s", tuple(sorted(
            (_ann_token(v, depth - 1) for v in value), key=repr
        )))
    if isinstance(value, dict):
        return ("d", tuple(sorted(
            ((_ann_token(k, depth - 1), _ann_token(v, depth - 1))
             for k, v in value.items()), key=repr,
        )))
    if callable(value):
        # callables compare by identity: plugin-level hooks are shared
        # across fork copies (equal), per-state closures are not (the
        # pair simply never merges)
        return ("id", id(value))
    fields = _obj_fields(value)
    if getattr(type(value), "veritest_path_local", False):
        # nested path-local annotations (e.g. the dependency tracer's
        # per-tx records stacked on the world state) compare by
        # presence, like at the top level
        return ("o", type(value).__module__, type(value).__qualname__)
    return ("o", type(value).__module__, type(value).__qualname__,
            _ann_token(fields, depth - 1))


def _obj_fields(obj) -> dict:
    try:
        return vars(obj)
    except TypeError:
        fields = {}
        for klass in type(obj).__mro__:
            for name in getattr(klass, "__slots__", ()):
                if hasattr(obj, name):
                    fields[name] = getattr(obj, name)
        return fields


def _annotations_token(annotations) -> tuple:
    """Annotations declaring ``veritest_path_local`` (search-bounding
    state like the loop tracer's JUMPDEST trace) compare by presence
    only — they bound exploration, they never feed a finding — and
    are re-joined at commit via the class's ``veritest_join``."""
    return tuple(
        (type(a).__module__, type(a).__qualname__,
         None if getattr(type(a), "veritest_path_local", False)
         else _ann_token(_obj_fields(a)))
        for a in annotations
    )


def _join_path_local_annotations(merged, b) -> None:
    """Replace the merged lane's path-local annotations (copied from
    lane a) with each class's declared join of the two arms'."""
    anns = merged.annotations
    for index, ann in enumerate(anns):
        cls = type(ann)
        if not getattr(cls, "veritest_path_local", False):
            continue
        join = getattr(cls, "veritest_join", None)
        other = next(
            (x for x in b.annotations if type(x) is cls), None
        )
        if join is not None and other is not None:
            anns[index] = copy(join(ann, other))


def _storage_digest(state) -> tuple:
    """Node-identity digest of the world state's array plane: per-
    account storage array node + nonce, plus the balance arrays.
    Fork copies preserve array node identity until a write diverges
    them (Storage.__deepcopy__ re-pins ``.node``), so equal digests
    mean byte-identical persistent state."""
    ws = state.world_state
    accounts = []
    for addr in sorted(ws.accounts):
        acc = ws.accounts[addr]
        accounts.append((
            addr, acc.nonce, acc.storage._standard_storage.node.id,
            tuple(sorted(acc.storage.storage_keys_loaded)),
        ))
    return (tuple(accounts), ws.balances.node.id,
            ws.starting_balances.node.id)


def _environment_token(state) -> tuple:
    env = state.environment
    return (
        id(env.code), _value_token(env.address), _value_token(env.sender),
        id(env.calldata), _value_token(env.gasprice),
        _value_token(env.origin), _value_token(env.callvalue),
        bool(env.static), env.active_function_name,
        _value_token(env.block_number), _value_token(env.chainid),
    )


def _frame_token(state) -> tuple:
    """Everything two lanes must share before their machine words are
    even comparable: transaction lineage, environment, call depth
    shape.  Cheap to build, used as the grouping key refinement."""
    ws = state.world_state
    return (
        tuple(id(entry) for entry in state.transaction_stack),
        tuple(id(entry) for entry in ws.transaction_sequence),
        _environment_token(state),
        len(state.mstate.stack), len(state.mstate.subroutine_stack),
        state.mstate.gas_limit,
        _annotations_token(state.annotations),
        _annotations_token(ws.annotations),
        tuple(
            _ann_token(v) for v in (state.last_return_data or ())
        ),
    )


def _printable_storage_token(state) -> tuple:
    out = []
    for addr in sorted(state.world_state.accounts):
        storage = state.world_state.accounts[addr].storage
        out.append((addr, tuple(sorted(
            (k.node.id, _value_token(v))
            for k, v in storage.printable_storage.items()
        ))))
    return tuple(out)


def _constraint_ids(state) -> List[int]:
    return [c.node.id for c in state.world_state.constraints]


# ---------------------------------------------------------------------------
# the merge transition
# ---------------------------------------------------------------------------


def _suffix_condition(suffix):
    cond = suffix[0]
    for term in suffix[1:]:
        cond = And(cond, term)
    return cond


def _join_word(cond_a, a, b, width: int):
    """``If(cond_a, a, b)`` over one diverging machine word, promoting
    raw ints to constants of the container's width."""
    if isinstance(a, int) and isinstance(b, int):
        a = symbol_factory.BitVecVal(a, width)
    if isinstance(a, int):
        a = symbol_factory.BitVecVal(a, b.size)
    if isinstance(b, int):
        b = symbol_factory.BitVecVal(b, a.size)
    return If(cond_a, a, b)


def _merge_planes(a, b, pc: int):
    """Word-tier meet of the two lanes' carried limb planes: known bits
    both lanes agree on survive into the merged lane's plane row;
    disagreements drop to unknown (a plane is concrete knowledge: it
    cannot carry an ite).  Returns an attachable ``_seg_planes`` ref, or
    None when either lane carries none.  The planes are host tensors
    (int64 limbs holding 32 bits each); the meet of two storage values
    runs through ``ops/lockstep.join_known_bits`` on numpy ``uint32``
    and comes back masked to 32 bits.  The joined planes are not shared:
    the next segment that adopts them writes in place."""
    ref_a = a.__dict__.get("_seg_planes")
    ref_b = b.__dict__.get("_seg_planes")
    if (ref_a is None or ref_b is None
            or ref_a[2] != pc or ref_b[2] != pc):
        return None
    pa, ra, _ = ref_a
    pb, rb, _ = ref_b
    if (pa.mem_kv.shape[1] != pb.mem_kv.shape[1]
            or pa.skeys.shape[1] != pb.skeys.shape[1]):
        return None
    import numpy as np
    import torch

    from mythril_tpu_torch.laser.ethereum.symbolic_lockstep import _LanePlanes
    from mythril_tpu_torch.ops.lockstep import join_known_bits

    def limbs(plane):
        return torch.from_numpy(plane.astype(np.int64))

    joined = _LanePlanes(1, pa.mem_kv.shape[1], pa.skeys.shape[1])
    agree = (pa.mem_km[ra] & pb.mem_km[rb]
             & (pa.mem_kv[ra] == pb.mem_kv[rb]))
    joined.mem_km[0] = agree
    joined.mem_kv[0] = torch.where(agree, pa.mem_kv[ra],
                                   torch.zeros_like(pa.mem_kv[ra]))
    # storage slots survive only where both lanes hold the same key
    # with bit-identical interval planes; the known-bit planes take
    # the meet (shared knowledge only)
    row = 0
    for i in range(pa.skeys.shape[1]):
        if not bool(pa.sused[ra, i]):
            continue
        hit = ((pb.skeys[rb] == pa.skeys[ra, i]).all(-1)
               & pb.sused[rb])
        if not bool(hit.any()):
            continue
        j = int(hit.nonzero()[0, 0])
        if not (torch.equal(pa.slo[ra, i], pb.slo[rb, j])
                and torch.equal(pa.shi[ra, i], pb.shi[rb, j])):
            continue
        kv, km, _ = join_known_bits(
            pa.skv[ra, i].numpy(), pa.skm[ra, i].numpy(),
            pb.skv[rb, j].numpy(), pb.skm[rb, j].numpy(),
        )
        joined.skeys[0, row] = pa.skeys[ra, i]
        joined.slo[0, row] = pa.slo[ra, i]
        joined.shi[0, row] = pa.shi[ra, i]
        joined.skv[0, row] = limbs(kv)
        joined.skm[0, row] = limbs(km)
        joined.sused[0, row] = True
        row += 1
    return (joined, 0, pc)


class VeritestEngine:
    """Per-``exec()`` merge + subsumption driver over the work list."""

    def __init__(self, svm):
        self.svm = svm
        self.max_ites = env_int(
            "MYTHRIL_TPU_MERGE_MAX_ITES", MERGE_MAX_ITES, floor=0
        )
        self.window = env_int(
            "MYTHRIL_TPU_MERGE_WINDOW", MERGE_WINDOW, floor=1
        )
        self.subsume_period = env_int(
            "MYTHRIL_TPU_SUBSUME_PERIOD", SUBSUME_PERIOD, floor=1
        )
        self.rounds = 0

    # -- scheduler hook -------------------------------------------------

    def round_tick(self, work_list: List) -> None:
        """Called between scheduler rounds: merge re-converged lanes
        every round, sweep subsumed lanes every ``subsume_period``-th.
        Mutates ``work_list`` in place (the strategy holds the same
        list object)."""
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        self.rounds += 1
        if len(work_list) > 1:
            with obs.span("svm.merge", cat="svm",
                          sink=(dispatch_stats, "merge_span_s"),
                          lanes=len(work_list)):
                self._merge_pass(work_list)
        if len(work_list) > 1 and self.rounds % self.subsume_period == 0:
            with obs.span("svm.subsume", cat="svm",
                          sink=(dispatch_stats, "merge_span_s"),
                          lanes=len(work_list)):
                self._subsume_pass(work_list)

    # -- merge ----------------------------------------------------------

    def _merge_pass(self, work_list: List) -> None:
        groups: Dict[Tuple[int, int], List[int]] = {}
        for index, state in enumerate(work_list):
            pc = state.mstate.pc
            code = state.environment.code
            if pc in _join_pcs_for(code):
                groups.setdefault((id(code), pc), []).append(index)
        dropped = set()
        for (_, pc), members in groups.items():
            if len(members) < 2:
                continue
            self._merge_group(work_list, members, pc, dropped)
        if dropped:
            work_list[:] = [
                s for i, s in enumerate(work_list) if i not in dropped
            ]

    def _merge_group(self, work_list, members, pc, dropped) -> None:
        from mythril_tpu_torch.observability.ledger import get_ledger
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        live = [i for i in members if i not in dropped]
        changed = True
        while changed and len(live) > 1:
            changed = False
            for ai in range(len(live)):
                for bi in range(ai + 1, len(live)):
                    ia, ib = live[ai], live[bi]
                    merged = self._try_merge(
                        work_list[ia], work_list[ib], pc
                    )
                    if merged is None:
                        continue
                    work_list[ia] = merged
                    dropped.add(ib)
                    live.pop(bi)
                    dispatch_stats.merges += 1
                    dispatch_stats.merged_lanes += 1
                    get_ledger().count_transition("merge", 1)
                    changed = True
                    break
                if changed:
                    break

    def _try_merge(self, a, b, pc: int):
        try:
            return self._merge_pair(a, b, pc)
        except _Unmergeable:
            return None
        except Exception:  # noqa: BLE001 — a failed join must degrade
            # to plain forking, never break the analysis
            log.debug("veritest merge failed; forking", exc_info=True)
            from mythril_tpu_torch.ops.batched_sat import dispatch_stats

            dispatch_stats.merge_aborts += 1
            return None

    def _merge_pair(self, a, b, pc: int):
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        if _frame_token(a) != _frame_token(b):
            raise _Unmergeable
        # the array plane cannot be ite-joined (smt If has no Array
        # sort): diverged storage/balances abort the merge outright
        if (_storage_digest(a) != _storage_digest(b)
                or _printable_storage_token(a)
                != _printable_storage_token(b)):
            dispatch_stats.merge_aborts += 1
            return None
        ids_a, ids_b = _constraint_ids(a), _constraint_ids(b)
        split = 0
        while (split < len(ids_a) and split < len(ids_b)
               and ids_a[split] == ids_b[split]):
            split += 1
        suffix_a = list(a.world_state.constraints)[split:]
        suffix_b = list(b.world_state.constraints)[split:]
        if not suffix_a or not suffix_b:
            # one side's constraints are a prefix of the other's: that
            # is a subsumption shape, not a diamond — leave it to the
            # sweep (merging here would just re-derive the weaker lane)
            raise _Unmergeable
        if len(suffix_a) > self.window or len(suffix_b) > self.window:
            dispatch_stats.merge_aborts += 1
            return None
        ms_a, ms_b = a.mstate, b.mstate
        stack_diffs = []
        for slot in range(len(ms_a.stack)):
            if _value_token(ms_a.stack[slot]) != _value_token(
                ms_b.stack[slot]
            ):
                stack_diffs.append(slot)
        mem_a, mem_b = ms_a.memory._memory, ms_b.memory._memory
        mem_len = max(len(mem_a), len(mem_b))
        mem_diffs = []
        for offset in range(mem_len):
            va = mem_a[offset] if offset < len(mem_a) else 0
            vb = mem_b[offset] if offset < len(mem_b) else 0
            if _value_token(va) != _value_token(vb):
                mem_diffs.append(offset)
        if len(stack_diffs) + len(mem_diffs) > self.max_ites:
            dispatch_stats.merge_aborts += 1
            return None
        # fault seam: an aborted mid-join degrades to plain forking
        from mythril_tpu_torch.resilience.faults import maybe_abort_merge

        if maybe_abort_merge():
            dispatch_stats.merge_aborts += 1
            return None
        cond_a = _suffix_condition(suffix_a)
        cond_b = _suffix_condition(suffix_b)
        merged = copy(a)
        ms = merged.mstate
        for slot in stack_diffs:
            ms.stack[slot] = _join_word(
                cond_a, ms_a.stack[slot], ms_b.stack[slot], 256
            )
        if mem_diffs:
            if len(ms.memory._memory) < mem_len:
                ms.memory.extend(mem_len - len(ms.memory._memory))
            for offset in mem_diffs:
                va = mem_a[offset] if offset < len(mem_a) else 0
                vb = mem_b[offset] if offset < len(mem_b) else 0
                ms.memory._memory[offset] = _join_word(
                    cond_a, va, vb, 8
                )
        # gas interval union; depth takes the deeper lane so the
        # strategy's max_depth cutoff can only fire sooner, never later
        ms.min_gas_used = min(ms_a.min_gas_used, ms_b.min_gas_used)
        ms.max_gas_used = max(ms_a.max_gas_used, ms_b.max_gas_used)
        ms.depth = max(ms_a.depth, ms_b.depth)
        joined = Constraints(list(a.world_state.constraints)[:split])
        joined.append(Or(cond_a, cond_b))
        merged.world_state.constraints = joined
        _join_path_local_annotations(merged, b)
        planes_ref = _merge_planes(a, b, pc)
        if planes_ref is not None:
            merged.__dict__["_seg_planes"] = planes_ref
        dispatch_stats.merge_ites += len(stack_diffs) + len(mem_diffs)
        return merged

    # -- subsumption ----------------------------------------------------

    def _subsume_pass(self, work_list: List) -> None:
        from mythril_tpu_torch.observability.ledger import get_ledger
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        dispatch_stats.subsume_sweeps += 1
        groups: Dict[tuple, List[int]] = {}
        for index, state in enumerate(work_list):
            try:
                key = (
                    id(state.environment.code), state.mstate.pc,
                    _storage_digest(state), _frame_token(state),
                    self._machine_token(state),
                )
            except Exception:  # noqa: BLE001 — an untokenizable lane
                # just stays out of the sweep; never break the analysis
                continue
            groups.setdefault(key, []).append(index)
        retired = set()
        for members in groups.values():
            if len(members) > 1:
                self._subsume_group(work_list, members, retired)
        if retired:
            dispatch_stats.subsumed_lanes += len(retired)
            get_ledger().count_transition("subsume", len(retired))
            work_list[:] = [
                s for i, s in enumerate(work_list) if i not in retired
            ]

    @staticmethod
    def _machine_token(state) -> tuple:
        ms = state.mstate
        stack = tuple(_value_token(v) for v in ms.stack)
        # memory sparsified by offset (zero bytes are the common case
        # and OOB reads return 0, so dropping them loses nothing)
        memory = tuple(
            (offset, _value_token(v))
            for offset, v in enumerate(ms.memory._memory)
            if not (isinstance(v, int) and v == 0)
        )
        return (stack, memory,
                ms.min_gas_used, ms.max_gas_used,
                _printable_storage_token(state))

    def _subsume_group(self, work_list, members, retired) -> None:
        """Within one identical-machine-state site: lane X retires
        against survivor Y when every constraint of Y is present in X
        (node id) or interval-implied by one of X's — models(X) is a
        subset of models(Y), so Y's exploration covers X's."""
        from mythril_tpu_torch.ops.resident import subset_matrix
        from mythril_tpu_torch.smt.word_tier import interval_implies

        id_sets = [
            frozenset(_constraint_ids(work_list[i])) for i in members
        ]
        superset = subset_matrix(id_sets)  # [x, y]: ids[y] <= ids[x]
        for xi, x_index in enumerate(members):
            if x_index in retired:
                continue
            for yi, y_index in enumerate(members):
                if xi == yi or y_index in retired:
                    continue
                if superset[xi, yi]:
                    # equal sets retire the later lane only (one must
                    # survive); a proper superset retires the stronger
                    if id_sets[xi] == id_sets[yi] and xi < yi:
                        continue
                    retired.add(x_index)
                    break
                residue = [
                    c for c in work_list[y_index].world_state.constraints
                    if c.node.id not in id_sets[xi]
                ]
                if 0 < len(residue) <= 2 and all(
                    any(
                        interval_implies(d.node, c.node)
                        for d in work_list[x_index].world_state.constraints
                    )
                    for c in residue
                ):
                    retired.add(x_index)
                    break


def engine_for(svm, create: bool, track_gas: bool
               ) -> Optional[VeritestEngine]:
    """The tier's single gate: one engine per ``exec()`` call, or None
    when merging must not run — statespace consumers, gas tracking,
    and CREATE need per-fork states, and ``MYTHRIL_TPU_VERITEST=0``
    pins the exact fork-only path."""
    if create or track_gas or svm.requires_statespace:
        return None
    if not veritest_enabled():
        return None
    return VeritestEngine(svm)
