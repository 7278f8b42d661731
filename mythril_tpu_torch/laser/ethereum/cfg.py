"""Statespace CFG recording (reference: laser/ethereum/cfg.py)."""

from enum import Enum
from typing import Dict, List

gbl_next_uid = 0  # node uids


class JumpType(Enum):
    CONDITIONAL = 1
    UNCONDITIONAL = 2
    CALL = 3
    RETURN = 4
    Transaction = 5


class NodeFlags:
    FUNC_ENTRY = 1
    CALL_RETURN = 2


class Node:
    """A basic-block node in the recorded statespace."""

    def __init__(
        self, contract_name: str, start_addr: int = 0, constraints=None, function_name: str = "unknown"
    ):
        global gbl_next_uid
        self.contract_name = contract_name
        self.start_addr = start_addr
        self.states: List = []
        self.constraints = constraints if constraints is not None else []
        self.function_name = function_name
        self.flags = 0
        self.uid = gbl_next_uid
        gbl_next_uid += 1

    def get_cfg_dict(self) -> Dict:
        code_lines = []
        for state in self.states:
            instruction = state.get_current_instruction()
            code_lines.append(
                f"{instruction['address']} {instruction['opcode']}"
                + (
                    " " + instruction["argument"]
                    if "argument" in instruction
                    else ""
                )
            )
        return dict(
            contract_name=self.contract_name,
            start_addr=self.start_addr,
            function_name=self.function_name,
            code="\\n".join(code_lines),
        )


class Edge:
    def __init__(
        self,
        node_from: int,
        node_to: int,
        edge_type: JumpType = JumpType.UNCONDITIONAL,
        condition=None,
    ):
        self.node_from = node_from
        self.node_to = node_to
        self.type = edge_type
        self.condition = condition

    def __str__(self) -> str:
        return str(self.as_dict)

    @property
    def as_dict(self) -> Dict[str, int]:
        return {"from": self.node_from, "to": self.node_to}
