"""Concrete search strategies (reference: laser/ethereum/strategy/basic.py)."""

from random import choices, randrange
from typing import List

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.strategy import BasicSearchStrategy


class DepthFirstSearchStrategy(BasicSearchStrategy):
    """LIFO: follow one path to the bottom before backtracking."""

    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop()


class BreadthFirstSearchStrategy(BasicSearchStrategy):
    """FIFO: explore all paths in lockstep depth order (the default)."""

    def get_strategic_global_state(self) -> GlobalState:
        return self.work_list.pop(0)


class ReturnRandomNaivelyStrategy(BasicSearchStrategy):
    """Uniformly random frontier pick."""

    def get_strategic_global_state(self) -> GlobalState:
        if len(self.work_list) > 0:
            return self.work_list.pop(randrange(len(self.work_list)))
        raise IndexError

    def __next__(self) -> GlobalState:  # keep IndexError semantics
        return BasicSearchStrategy.__next__(self)


class ReturnWeightedRandomStrategy(BasicSearchStrategy):
    """Random pick weighted 1/(depth+1): favors shallow states."""

    def get_strategic_global_state(self) -> GlobalState:
        probability_distribution = [
            1 / (global_state.mstate.depth + 1)
            for global_state in self.work_list
        ]
        index = choices(
            range(len(self.work_list)), probability_distribution
        )[0]
        return self.work_list.pop(index)
