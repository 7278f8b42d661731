"""Path-constraint container (reference: laser/ethereum/state/constraints.py).

A list of Bools.  ``is_possible`` funnels through support.model.get_model
so results are memoized and telemetry is counted, exactly like the
reference; batched feasibility for whole frontiers lives in
laser/batch.py instead.
"""

from copy import copy
from typing import Iterable, List, Optional

from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.smt import Bool, simplify, symbol_factory


class Constraints(list):
    def __init__(self, constraint_list: Optional[Iterable[Bool]] = None):
        super().__init__(constraint_list or [])

    @property
    def is_possible(self) -> bool:
        from mythril_tpu_torch.support.model import get_model

        try:
            get_model(tuple(self), enforce_execution_time=False)
        except UnsatError:
            return False
        return True

    def append(self, constraint) -> None:
        if isinstance(constraint, bool):
            constraint = symbol_factory.BoolVal(constraint)
        super().append(simplify(constraint))

    def pop(self, index: int = -1):
        return super().pop(index)

    def __copy__(self) -> "Constraints":
        return Constraints(super().copy())

    def copy(self) -> "Constraints":
        return self.__copy__()

    def __deepcopy__(self, memo) -> "Constraints":
        # Bools are immutable interned terms; sharing them is safe.
        return self.__copy__()

    def __add__(self, other) -> "Constraints":
        result = Constraints(super().copy())
        for c in other:
            result.append(c)
        return result

    def __iadd__(self, other) -> "Constraints":
        for c in other:
            self.append(c)
        return self

    def __hash__(self):  # type: ignore[override]
        return hash(tuple(c.node.id for c in self))
