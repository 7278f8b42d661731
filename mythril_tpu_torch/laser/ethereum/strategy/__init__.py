"""Search strategies = frontier schedulers (reference:
laser/ethereum/strategy/__init__.py).

A strategy iterates over the shared work list, deciding which state to
step next.  It is also where frontier *batches* are drawn from: the VM
steps up to ``batch_width`` states per round and checks the union of
their successors in one ``laser/batch.py`` pass.
"""

from abc import ABC, abstractmethod
from typing import List

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState


class BasicSearchStrategy(ABC):
    def __init__(self, work_list: List[GlobalState], max_depth: int, **kwargs):
        self.work_list = work_list
        self.max_depth = max_depth

    def __iter__(self):
        return self

    @abstractmethod
    def get_strategic_global_state(self) -> GlobalState:
        raise NotImplementedError

    def run_check(self) -> bool:
        return True

    def __next__(self) -> GlobalState:
        while True:
            if len(self.work_list) == 0:
                raise StopIteration
            global_state = self.get_strategic_global_state()
            if global_state.mstate.depth < self.max_depth:
                return global_state
            # beyond max depth: drop and pick another

    def pop_batch(self, max_lanes: int) -> List[GlobalState]:
        """Draw up to ``max_lanes`` states for one VM round.

        This is the batch-selection policy surface: the
        VM steps a whole wavefront per round and feasibility-checks the
        union of its successors in one device pass.  The default draws
        repeatedly through ``__next__`` so every strategy's ordering
        (and any decorator's filtering) applies unchanged; a strategy
        may override it to pick lanes jointly instead of sequentially.
        """
        batch: List[GlobalState] = []
        while len(batch) < max_lanes:
            try:
                batch.append(next(self))
            except (StopIteration, IndexError):
                break
        return batch
