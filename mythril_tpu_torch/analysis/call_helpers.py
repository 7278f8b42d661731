"""Call extraction helper (reference: mythril/analysis/call_helpers.py)."""

from typing import Optional

from mythril_tpu_torch.analysis.ops import Call, VarType, get_variable
from mythril_tpu_torch.laser.ethereum.natives import PRECOMPILE_COUNT
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState


def get_call_from_state(state: GlobalState) -> Optional[Call]:
    instruction = state.get_current_instruction()
    op = instruction["opcode"]
    stack = state.mstate.stack

    if op in ("CALL", "CALLCODE"):
        gas, to, value, meminstart, meminsz = (
            get_variable(stack[-1]),
            get_variable(stack[-2]),
            get_variable(stack[-3]),
            get_variable(stack[-4]),
            get_variable(stack[-5]),
        )
        if to.type == VarType.CONCRETE and 0 < to.val <= PRECOMPILE_COUNT:
            return None
        if meminstart.type == VarType.CONCRETE and meminsz.type == VarType.CONCRETE:
            return Call(
                state.node,
                state,
                None,
                op,
                to,
                gas,
                value,
                state.mstate.memory[
                    meminstart.val : meminsz.val + meminstart.val
                ],
            )
        return Call(state.node, state, None, op, to, gas, value)

    gas, to = get_variable(stack[-1]), get_variable(stack[-2])
    if to.type == VarType.CONCRETE and 0 < to.val <= PRECOMPILE_COUNT:
        return None
    return Call(state.node, state, None, op, to, gas)
