"""Batched frontier feasibility checking (own copy of
``mythril_tpu/laser/batch.py``): the seam where a whole step's
successor states go through one ``batch_check_states`` pass instead of
one solver call per state.

``prune_infeasible`` receives the successor states produced in one VM
round and returns the feasible subset:

1. structural triage: constraints that folded to literal False are
   dropped without any solver work;
2. the frontier funnel (``ops/batched_sat.batch_check_states``): memo
   hits, then the dense tier and its sweep kernel on the card, over the
   deduped lanes;
3. CDCL tail: lanes the funnel left open go through
   ``Constraints.is_possible`` (the memoized ``support.model`` funnel).

Unlike the JAX package, a failure of the funnel (the dense tier or the
sweep kernel) propagates to the caller: there is no fallback that
hands the frontier to the CDCL and hides a broken kernel.  The word
tier, the lane ledger and the drain/budget hooks are not part of the
port.
"""

from typing import List

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
    undecided = []
    feasible = []
    for state in states:
        if _structurally_false(state.world_state.constraints):
            continue
        undecided.append(state)

    from mythril_tpu_torch.ops.batched_sat import effective_min_lanes

    min_lanes = effective_min_lanes()
    use_batch = args.batched_solving and len(undecided) >= min_lanes
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

    for state, verdict in zip(undecided, verdicts):
        if verdict is True:
            feasible.append(state)
        elif verdict is None:
            # undecided by the funnel: authoritative CDCL check
            prune_stats.tail_states += 1
            if state.world_state.constraints.is_possible:
                feasible.append(state)
    prune_stats.calls += 1
    return feasible
