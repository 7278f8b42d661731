"""SWC-101: integer overflow/underflow (reference: modules/integer.py).

Taint-based: ADD/SUB/MUL/EXP annotate their result with the overflow
condition; the taint flows through SSTORE/JUMPI/CALL/RETURN into a state
annotation; at transaction end each recorded overflow is checked for
satisfiability (with memoized per-ostate verdicts) and concretized.
"""

import logging
from copy import copy
from math import ceil, log2
from typing import List, Set, cast

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import INTEGER_OVERFLOW_AND_UNDERFLOW
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.smt import (
    And,
    BitVec,
    Bool,
    BVAddNoOverflow,
    BVMulNoOverflow,
    BVSubNoUnderflow,
    Expression,
    If,
    Not,
    symbol_factory,
)

log = logging.getLogger(__name__)


class OverUnderflowAnnotation:
    """Attached to a BitVec that may have wrapped."""

    def __init__(
        self, overflowing_state: GlobalState, operator: str, constraint: Bool
    ) -> None:
        self.overflowing_state = overflowing_state
        self.operator = operator
        self.constraint = constraint

    def __deepcopy__(self, memodict={}):
        return copy(self)


class OverUnderflowStateAnnotation(StateAnnotation):
    """Collects overflow taints that reached a sink on this path."""

    def __init__(self) -> None:
        self.overflowing_state_annotations: Set[OverUnderflowAnnotation] = set()

    def __copy__(self):
        new_annotation = OverUnderflowStateAnnotation()
        new_annotation.overflowing_state_annotations = copy(
            self.overflowing_state_annotations
        )
        return new_annotation


class IntegerArithmetics(DetectionModule):
    name = "Integer overflow or underflow"
    swc_id = INTEGER_OVERFLOW_AND_UNDERFLOW
    description = (
        "For every SUB instruction, check if there's a possible state where "
        "op1 > op0. For every ADD, MUL instruction, check if there's a "
        "possible state where op1 + op0 > 2^256 - 1"
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = [
        "ADD", "MUL", "EXP", "SUB", "SSTORE", "JUMPI", "STOP", "RETURN", "CALL",
    ]

    def __init__(self) -> None:
        super().__init__()
        self._ostates_satisfiable: Set[GlobalState] = set()
        self._ostates_unsatisfiable: Set[GlobalState] = set()

    def reset_module(self) -> None:
        super().reset_module()
        self._ostates_satisfiable = set()
        self._ostates_unsatisfiable = set()

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        opcode = state.get_current_instruction()["opcode"]
        handlers = {
            "ADD": [self._handle_add],
            "SUB": [self._handle_sub],
            "MUL": [self._handle_mul],
            "EXP": [self._handle_exp],
            "SSTORE": [self._handle_sstore],
            "JUMPI": [self._handle_jumpi],
            "CALL": [self._handle_call],
            "RETURN": [self._handle_return, self._handle_transaction_end],
            "STOP": [self._handle_transaction_end],
        }
        for handler in handlers[opcode]:
            handler(state)

    @staticmethod
    def _make_bitvec_if_not(stack, index):
        value = stack[index]
        if isinstance(value, BitVec):
            return value
        if isinstance(value, Bool):
            return If(value, 1, 0)
        stack[index] = symbol_factory.BitVecVal(value, 256)
        return stack[index]

    def _get_args(self, state):
        stack = state.mstate.stack
        return (
            self._make_bitvec_if_not(stack, -1),
            self._make_bitvec_if_not(stack, -2),
        )

    def _handle_add(self, state):
        op0, op1 = self._get_args(state)
        condition = Not(BVAddNoOverflow(op0, op1, False))
        op0.annotate(OverUnderflowAnnotation(state, "addition", condition))

    def _handle_sub(self, state):
        op0, op1 = self._get_args(state)
        condition = Not(BVSubNoUnderflow(op0, op1, False))
        op0.annotate(OverUnderflowAnnotation(state, "subtraction", condition))

    def _handle_mul(self, state):
        op0, op1 = self._get_args(state)
        condition = Not(BVMulNoOverflow(op0, op1, False))
        op0.annotate(
            OverUnderflowAnnotation(state, "multiplication", condition)
        )

    def _handle_exp(self, state):
        op0, op1 = self._get_args(state)
        if op0.symbolic and op1.symbolic:
            constraint = And(
                op1 > symbol_factory.BitVecVal(256, 256),
                op0 > symbol_factory.BitVecVal(1, 256),
            )
        elif op1.symbolic:
            if op0.value < 2:
                return
            constraint = op1 >= symbol_factory.BitVecVal(
                ceil(256 / log2(op0.value)), 256
            )
        elif op0.symbolic:
            if op1.value == 0:
                return
            constraint = op0 >= symbol_factory.BitVecVal(
                2 ** ceil(256 / op1.value), 256
            )
        else:
            constraint = symbol_factory.BoolVal(
                op0.value**op1.value >= 2**256
            )
        op0.annotate(
            OverUnderflowAnnotation(state, "exponentiation", constraint)
        )

    @staticmethod
    def _record_taint(state: GlobalState, value) -> None:
        if not isinstance(value, Expression):
            return
        state_annotation = _get_overflowunderflow_state_annotation(state)
        for annotation in value.annotations:
            if isinstance(annotation, OverUnderflowAnnotation):
                state_annotation.overflowing_state_annotations.add(annotation)

    def _handle_sstore(self, state: GlobalState) -> None:
        self._record_taint(state, state.mstate.stack[-2])

    def _handle_jumpi(self, state: GlobalState) -> None:
        self._record_taint(state, state.mstate.stack[-2])

    def _handle_call(self, state: GlobalState) -> None:
        self._record_taint(state, state.mstate.stack[-3])

    def _handle_return(self, state: GlobalState) -> None:
        stack = state.mstate.stack
        offset, length = stack[-1], stack[-2]
        try:
            for element in state.mstate.memory[offset : offset + length]:
                self._record_taint(state, element)
        except TypeError:
            pass

    def _handle_transaction_end(self, state: GlobalState) -> None:
        state_annotation = _get_overflowunderflow_state_annotation(state)
        for annotation in state_annotation.overflowing_state_annotations:
            ostate = annotation.overflowing_state
            if ostate in self._ostates_unsatisfiable:
                continue
            if ostate not in self._ostates_satisfiable:
                try:
                    solver.get_model(
                        tuple(
                            ostate.world_state.constraints
                            + [annotation.constraint]
                        )
                    )
                    self._ostates_satisfiable.add(ostate)
                except UnsatError:
                    self._ostates_unsatisfiable.add(ostate)
                    continue
            try:
                constraints = state.world_state.constraints + [
                    annotation.constraint
                ]
                transaction_sequence = solver.get_transaction_sequence(
                    state, constraints
                )
            except UnsatError:
                continue
            issue = Issue(
                contract=ostate.environment.active_account.contract_name,
                function_name=ostate.environment.active_function_name,
                address=ostate.get_current_instruction()["address"],
                swc_id=INTEGER_OVERFLOW_AND_UNDERFLOW,
                bytecode=ostate.environment.code.bytecode,
                title="Integer Arithmetic Bugs",
                severity="High",
                description_head=(
                    "The arithmetic operator can {}.".format(
                        "underflow"
                        if annotation.operator == "subtraction"
                        else "overflow"
                    )
                ),
                description_tail=(
                    "It is possible to cause an integer overflow or "
                    "underflow in the arithmetic operation. Prevent this by "
                    "constraining inputs using the require() statement or "
                    "use the OpenZeppelin SafeMath library for integer "
                    "arithmetic operations. Refer to the transaction trace "
                    "generated for this issue to reproduce the issue."
                ),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
            self.cache.add(ostate.get_current_instruction()["address"])
            self.issues.append(issue)


def _get_overflowunderflow_state_annotation(
    state: GlobalState,
) -> OverUnderflowStateAnnotation:
    state_annotations = cast(
        List[OverUnderflowStateAnnotation],
        list(state.get_annotations(OverUnderflowStateAnnotation)),
    )
    if len(state_annotations) == 0:
        state_annotation = OverUnderflowStateAnnotation()
        state.annotate(state_annotation)
        return state_annotation
    return state_annotations[0]


detector = IntegerArithmetics()
