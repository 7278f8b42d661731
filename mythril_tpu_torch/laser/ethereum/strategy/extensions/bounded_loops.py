"""Loop bounding as a frontier mask.

Capability parity target: reference
laser/ethereum/strategy/extensions/bounded_loops.py (drop states whose
innermost loop iterated past ``--loop-bound``; creation transactions
get ``max(8, bound)`` so constructor loops finish).

Design: the decorator draws whole wavefronts from the wrapped scheduler
and masks them (``pop_batch``), which is the shape the batched VM
consumes — a state is admitted iff the trailing cycle of its JUMPDEST
trace has not tiled more than ``bound`` times.  Cycle counting is a
direct slice-tiling comparison over the trace tail (no rolling hash):
the cycle is the span between the two most recent occurrences of the
final (pc, pc) pair, and the count is how many times that span tiles
the trace backwards contiguously.
"""

import logging
from copy import copy
from typing import Dict, List, Sequence

from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.strategy import BasicSearchStrategy
from mythril_tpu_torch.laser.ethereum.transaction import ContractCreationTransaction

log = logging.getLogger(__name__)

# constructors run loops to completion up to this floor regardless of
# the user bound (matches the reference's creation-tx special case)
CREATION_LOOP_FLOOR = 8


class JumpdestCountAnnotation(StateAnnotation):
    """Per-path JUMPDEST trace, copied on fork."""

    #: veritesting policy (laser/ethereum/veritest.py): the trace is
    #: path-local search state (it bounds exploration and never feeds a
    #: finding), so two lanes differing only here may still merge; the
    #: joined lane keeps the longer trace (cycle counting over a
    #: superset trace can only cut sooner, never later)
    veritest_path_local = True

    def __init__(self) -> None:
        self._reached_count: Dict[int, int] = {}
        self.trace: List[int] = []

    def __copy__(self):
        clone = JumpdestCountAnnotation()
        clone._reached_count = copy(self._reached_count)
        clone.trace = copy(self.trace)
        return clone

    @staticmethod
    def veritest_join(ann_a, ann_b):
        """Pick the joined lane's annotation of a merged pair."""
        return ann_a if len(ann_a.trace) >= len(ann_b.trace) else ann_b


def trailing_cycle_count(trace: Sequence[int]) -> int:
    """How many times does the trace's trailing cycle tile backwards?

    The cycle is delimited by the two most recent occurrences of the
    final two-entry pair; returns 0 when no earlier occurrence exists.
    Counting includes the defining occurrence, so a loop seen twice
    reports 2.
    """
    n = len(trace)
    if n < 4:
        return 0
    pair = (trace[-2], trace[-1])
    start = -1
    for i in range(n - 3, 0, -1):
        if trace[i] == pair[0] and trace[i + 1] == pair[1]:
            start = i
            break
    if start < 0:
        return 0
    size = n - 2 - start
    segment = list(trace[n - 1 - size : n - 1])
    count = 1
    j = n - 1 - size
    while j >= 0 and list(trace[j : j + size]) == segment:
        count += 1
        j -= size
    return count


class BoundedLoopsStrategy(BasicSearchStrategy):
    """Scheduler decorator: masks looping states out of the wavefront."""

    def __init__(self, super_strategy: BasicSearchStrategy, *args) -> None:
        self.super_strategy = super_strategy
        self.bound = args[0][0]
        log.info(
            "Loaded search strategy extension: Loop bounds (limit = %d)",
            self.bound,
        )
        super().__init__(super_strategy.work_list, super_strategy.max_depth)

    # -- admission test -------------------------------------------------

    def _admit(self, state: GlobalState) -> bool:
        """Record the state's position in its trace and decide whether
        it stays in the frontier."""
        found = list(state.get_annotations(JumpdestCountAnnotation))
        if found:
            annotation = found[0]
        else:
            annotation = JumpdestCountAnnotation()
            state.annotate(annotation)

        instruction = state.get_current_instruction()
        annotation.trace.append(instruction["address"])

        if instruction["opcode"].upper() != "JUMPDEST":
            return True

        cycles = trailing_cycle_count(annotation.trace)
        if isinstance(
            state.current_transaction, ContractCreationTransaction
        ) and cycles < max(CREATION_LOOP_FLOOR, self.bound):
            return True
        if cycles > self.bound:
            log.debug("Loop bound reached, skipping state")
            return False
        return True

    # -- scheduling surface ---------------------------------------------

    def get_strategic_global_state(self) -> GlobalState:
        while True:
            state = self.super_strategy.get_strategic_global_state()
            if self._admit(state):
                return state

    def pop_batch(self, max_lanes: int) -> List[GlobalState]:
        """Draw from the wrapped scheduler and mask, refilling until the
        wavefront is full or the frontier is exhausted."""
        batch: List[GlobalState] = []
        while len(batch) < max_lanes:
            drawn = self.super_strategy.pop_batch(max_lanes - len(batch))
            if not drawn:
                break
            batch.extend(s for s in drawn if self._admit(s))
        return batch
