"""Batched frontier feasibility checking (own copy of
``mythril_tpu/laser/batch.py``): the seam where a whole step's
successor states go through one ``batch_check_states`` pass instead of
one solver call per state.

``prune_infeasible`` receives the successor states produced in one VM
round and returns the feasible subset:

1. structural triage: constraints that folded to literal False are
   dropped without any solver work;
2. the frontier funnel (``ops/batched_sat.batch_check_states``): memo
   hits and host probes, the word tier, then the solver tiers and their
   kernels on the card, over the deduped lanes;
3. the word tier (``smt/word_tier.py``) over whatever the funnel left
   open, or over the whole frontier when the funnel did not run (narrow
   frontiers): one batched interval / known-bits pass decides the
   interval-UNSAT and constant-fold states before any CDCL query;
4. CDCL tail: lanes still open go through ``Constraints.is_possible``
   (the memoized ``support.model`` funnel).

The lane ledger (``observability/ledger.py``) counts every structurally
false state, and every state of a round that did not go through the
funnel, as a prune-level lane of its own (kind ``prune``); the funnel
records its own lanes.

Unlike the JAX package, a failure of the funnel (a solver tier, the
word tier or a kernel) propagates to the caller: there is no fallback
that hands the frontier to the CDCL and hides a broken kernel.  The
resilience plane's seams are the JAX package's: while a drain is
requested (``resilience/checkpoint.drain_requested``) no new device
dispatch starts, and once a request's wall-clock budget expired
(``resilience/budget.py``) undecided states are dropped instead of
solved (the ledger's ``dropped`` transition; the report is partial).
"""

from typing import List

from mythril_tpu_torch.observability import spans as obs
from mythril_tpu_torch.observability.ledger import get_ledger
from mythril_tpu_torch.support.support_args import args


def _structurally_false(constraints) -> bool:
    for c in constraints:
        if isinstance(c, bool):
            if not c:
                return True
            continue
        if getattr(c, "is_false", False):
            return True
    return False


class PruneStats:
    """Per-analysis counts of the prune calls and of the states they
    decided."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = 0
        self.batched_calls = 0   # calls that went through the funnel
        self.tail_states = 0     # states the CDCL tail decided here


prune_stats = PruneStats()


def prune_infeasible(states: List) -> List:
    """Return the subset of states whose path constraints are satisfiable."""
    with obs.span("batch.prune", cat="batch", states=len(states)):
        return _prune_infeasible(states)


def _prune_infeasible(states: List) -> List:
    ledger = get_ledger()
    undecided = []
    feasible = []
    for state in states:
        if _structurally_false(state.world_state.constraints):
            ledger.single("prune", "structural", "unsat")
            continue
        undecided.append(state)

    from mythril_tpu_torch.ops.batched_sat import effective_min_lanes
    from mythril_tpu_torch.resilience.budget import budget_expired
    from mythril_tpu_torch.resilience.checkpoint import drain_requested

    min_lanes = effective_min_lanes()
    use_batch = args.batched_solving and len(undecided) >= min_lanes
    if drain_requested():
        # a drain starts no device dispatch: the memo-backed CDCL tail
        # below decides (verdicts unchanged) while the svm winds down
        use_batch = False
    if use_batch:
        # gate on the number of *unique* constraint sets: sibling forks
        # often share identical constraints (terms are interned, so node
        # identity is a sound dedupe key)
        unique_sets = {
            frozenset(
                id(c.raw) if hasattr(c, "raw") else id(c)
                for c in s.world_state.constraints
                if not isinstance(c, bool)
            )
            for s in undecided
        }
        use_batch = len(unique_sets) >= min_lanes
    if use_batch:
        from mythril_tpu_torch.ops.batched_sat import batch_check_states

        verdicts = batch_check_states(
            [s.world_state.constraints for s in undecided],
            device=args.device, tail=False,
        )
        prune_stats.batched_calls += 1
    else:
        verdicts = [None] * len(undecided)

    # the word tier over what the funnel left open (memoized on the
    # blast context, so lanes the funnel already consulted cost a dict
    # hit here)
    open_positions = [k for k, v in enumerate(verdicts) if v is None]
    word_decided_here = set()
    if open_positions:
        verdicts = _consult_word_tier(undecided, verdicts, open_positions)
        word_decided_here = {k for k in open_positions
                             if verdicts[k] is not None}

    for k, (state, verdict) in enumerate(zip(undecided, verdicts)):
        # the funnel ledgered its own lanes (tail demotions included):
        # only the decisions of a round without it are lanes here
        if verdict is True:
            feasible.append(state)
            if not use_batch and k in word_decided_here:
                ledger.single("prune", "word", "sat")
        elif verdict is False:
            if not use_batch and k in word_decided_here:
                ledger.single("prune", "word", "unsat")
        else:
            # undecided by the funnel: authoritative CDCL check, unless
            # the request's budget is spent (never the signal drain,
            # whose resume needs the tail): dropping an undecided state
            # can only narrow the partial report, never add a finding
            if budget_expired():
                if not use_batch:
                    ledger.count_transition("dropped")
                    ledger.single("prune", "tail", "undecided")
                continue
            prune_stats.tail_states += 1
            possible = state.world_state.constraints.is_possible
            if not use_batch:
                ledger.single("prune", "tail",
                              "sat" if possible else "unsat")
            if possible:
                feasible.append(state)
    prune_stats.calls += 1
    return feasible


def _consult_word_tier(undecided, verdicts, open_positions):
    """Run the word tier over the open states' constraint sets and fold
    its sound verdicts into ``verdicts`` (True = feasible, False =
    prune, None = leave to the CDCL tail)."""
    from mythril_tpu_torch.smt import terms as T
    from mythril_tpu_torch.smt.solver import get_blast_context
    from mythril_tpu_torch.smt.word_tier import (
        get_word_tier, word_tier_enabled,
    )

    if not word_tier_enabled():
        return verdicts
    ctx = get_blast_context()
    node_sets = []
    for k in open_positions:
        nodes = []
        falsy = False
        for c in undecided[k].world_state.constraints:
            if isinstance(c, bool):
                if not c:
                    falsy = True
                    break
                continue
            node = c.raw if hasattr(c, "raw") else c
            if node is T.FALSE:
                falsy = True
                break
            if node is T.TRUE:
                continue
            nodes.append(node)
        if falsy:
            verdicts[k] = False
            node_sets.append(None)
        else:
            node_sets.append(nodes)
    word_verdicts, _hints, word_envs = get_word_tier().decide(
        ctx, node_sets, device=args.device
    )
    for pos, k in enumerate(open_positions):
        if verdicts[k] is None and word_verdicts[pos] is not None:
            verdicts[k] = word_verdicts[pos]
            if word_verdicts[pos] and word_envs[pos] is not None:
                ctx._remember_model(word_envs[pos])
    return verdicts
