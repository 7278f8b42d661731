"""GlobalState: one point in the exploration frontier (reference:
laser/ethereum/state/global_state.py).

``__copy__`` is the fork operation: shallow-copies world state and
environment, deep-copies the machine state, and rebinds the active
account into the copied world state so mutations stay per-fork.
"""

from copy import copy, deepcopy
from typing import Dict, Iterable, List, Optional, Union

from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.environment import Environment
from mythril_tpu_torch.laser.ethereum.state.machine_state import MachineState
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.smt import BitVec, symbol_factory


class GlobalState:
    def __init__(
        self,
        world_state: WorldState,
        environment: Environment,
        node,
        machine_state: Optional[MachineState] = None,
        transaction_stack: Optional[List] = None,
        last_return_data: Optional[List] = None,
        annotations: Optional[List[StateAnnotation]] = None,
    ):
        self.node = node
        self.world_state = world_state
        self.environment = environment
        self.mstate = (
            machine_state if machine_state else MachineState(gas_limit=1000000000)
        )
        self.transaction_stack = transaction_stack if transaction_stack else []
        self.op_code = ""
        self.last_return_data = last_return_data
        self._annotations = annotations or []

    def add_annotations(self, annotations: List[StateAnnotation]) -> None:
        self._annotations += annotations

    def __copy__(self) -> "GlobalState":
        world_state = copy(self.world_state)
        environment = copy(self.environment)
        mstate = deepcopy(self.mstate)
        transaction_stack = copy(self.transaction_stack)
        environment.active_account = world_state[environment.active_account.address]
        new_state = GlobalState(
            world_state,
            environment,
            self.node,
            mstate,
            transaction_stack=transaction_stack,
            last_return_data=self.last_return_data,
            annotations=[copy(a) for a in self._annotations],
        )
        new_state.op_code = self.op_code
        return new_state

    @property
    def accounts(self) -> Dict:
        return self.world_state.accounts

    def get_current_instruction(self) -> Dict:
        instructions = self.environment.code.instruction_list
        if self.mstate.pc >= len(instructions):
            return {"address": self.mstate.pc, "opcode": "STOP"}
        instr = instructions[self.mstate.pc]
        result = {"address": instr.address, "opcode": instr.op_code}
        if instr.argument is not None:
            result["argument"] = "0x" + instr.argument.hex()
        return result

    @property
    def current_transaction(self):
        try:
            return self.transaction_stack[-1][0]
        except IndexError:
            return None

    @property
    def instruction(self) -> Dict:
        return self.get_current_instruction()

    def new_bitvec(self, name: str, size: int = 256, annotations=None) -> BitVec:
        transaction_id = self.current_transaction.id
        return symbol_factory.BitVecSym(
            f"{transaction_id}_{name}", size, annotations
        )

    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)
        if annotation.persist_to_world_state:
            self.world_state.annotate(annotation)

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def get_annotations(self, annotation_type: type) -> Iterable:
        return filter(lambda x: isinstance(x, annotation_type), self._annotations)
