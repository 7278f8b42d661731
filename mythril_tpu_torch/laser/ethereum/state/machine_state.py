"""Machine-level state: stack, memory, pc, gas (reference:
laser/ethereum/state/machine_state.py)."""

from copy import copy
from typing import Any, List, Union

from mythril_tpu_torch.laser.ethereum.evm_exceptions import (
    OutOfGasException,
    StackOverflowException,
    StackUnderflowException,
)
from mythril_tpu_torch.laser.ethereum.state.memory import Memory
from mythril_tpu_torch.smt import BitVec
from mythril_tpu_torch.support.opcodes import GMEMORY, GQUADRATICMEMDENOM, ceil32

# the real EVM allows 1024 stack items (the reference uses 1023,
# machine_state.py:18 — an off-by-one its own skip list works around:
# VMTests loop_stacklimit_1020 requires the full 1024)
STACK_LIMIT = 1024


class MachineStack(list):
    """EVM stack with the 1024-deep limit and typed faults."""

    def __init__(self, default_list=None):
        super().__init__(default_list or [])

    def append(self, element: Union[int, BitVec]) -> None:
        if super().__len__() >= STACK_LIMIT:
            raise StackOverflowException(
                f"Reached the EVM stack limit of {STACK_LIMIT}"
            )
        super().append(element)

    def pop(self, index: int = -1) -> Union[int, BitVec]:
        try:
            return super().pop(index)
        except IndexError:
            raise StackUnderflowException("Trying to pop from an empty stack")

    def __getitem__(self, item):
        try:
            return super().__getitem__(item)
        except IndexError:
            raise StackUnderflowException(
                "Trying to access a stack element that doesn't exist"
            )

    def __add__(self, other):
        raise NotImplementedError("Implement this if needed")

    def __iadd__(self, other):
        raise NotImplementedError("Implement this if needed")


class MachineState:
    """pc / stack / memory / gas accounting for one call frame."""

    def __init__(
        self,
        gas_limit: int,
        pc: int = 0,
        stack=None,
        subroutine_stack=None,
        memory: Memory = None,
        constraints=None,
        depth: int = 0,
        max_gas_used: int = 0,
        min_gas_used: int = 0,
    ):
        self.pc = pc
        self.stack = MachineStack(stack)
        self.subroutine_stack = MachineStack(subroutine_stack)
        self.memory = memory or Memory()
        self.gas_limit = gas_limit
        self.min_gas_used = min_gas_used
        self.max_gas_used = max_gas_used
        self.depth = depth

    def calculate_extension_size(self, start: int, size: int) -> int:
        if self.memory_size > start + size:
            return 0
        new_size = ceil32(start + size) // 32
        old_size = self.memory_size // 32
        return (new_size - old_size) * 32

    def calculate_memory_gas(self, start: int, size: int) -> int:
        if size == 0:
            return 0
        new_size = ceil32(start + size) // 32
        old_size = self.memory_size // 32
        old_total = old_size * GMEMORY + old_size**2 // GQUADRATICMEMDENOM
        new_total = new_size * GMEMORY + new_size**2 // GQUADRATICMEMDENOM
        return new_total - old_total

    def check_gas(self) -> None:
        if self.min_gas_used > self.gas_limit:
            raise OutOfGasException()

    def mem_extend(self, start: Union[int, BitVec], size: Union[int, BitVec]) -> None:
        """Extend memory (concrete indices only) and charge expansion gas."""
        if isinstance(start, BitVec):
            if start.value is None:
                return
            start = start.value
        if isinstance(size, BitVec):
            if size.value is None:
                return
            size = size.value
        if size == 0:
            return
        extension_gas = self.calculate_memory_gas(start, size)
        self.min_gas_used += extension_gas
        self.max_gas_used += extension_gas
        self.check_gas()
        extend_amount = self.calculate_extension_size(start, size)
        if extend_amount > 0:
            self.memory.extend(extend_amount)

    def pop(self, amount: int = 1) -> Union[Any, List]:
        """Pop one value (amount=1) or a list of ``amount`` values."""
        if amount == 1:
            return self.stack.pop()
        if amount > len(self.stack):
            raise StackUnderflowException
        values = self.stack[-amount:][::-1]
        del self.stack[-amount:]
        return values

    @property
    def memory_size(self) -> int:
        return self.memory.size

    def __deepcopy__(self, memo):
        return self.__copy__()

    def __copy__(self) -> "MachineState":
        return MachineState(
            gas_limit=self.gas_limit,
            pc=self.pc,
            stack=list(self.stack),
            subroutine_stack=list(self.subroutine_stack),
            memory=copy(self.memory),
            depth=self.depth,
            max_gas_used=self.max_gas_used,
            min_gas_used=self.min_gas_used,
        )

    def __str__(self):
        return f"MachineState(pc={self.pc}, stack_size={len(self.stack)})"

    @property
    def as_dict(self) -> dict:
        return {
            "pc": self.pc,
            "stack": [str(s) for s in self.stack],
            "memory_size": self.memory_size,
            "memsize": self.memory_size,
            "gas": f"{self.min_gas_used}-{self.max_gas_used}",
        }
