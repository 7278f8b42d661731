"""SWC-107: state access after external call (reference:
modules/state_change_external_calls.py)."""

import logging
from copy import copy
from typing import List, Optional, cast

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.smt import UGT, BitVec, Bool, Or, symbol_factory

log = logging.getLogger(__name__)

CALL_LIST = ["CALL", "DELEGATECALL", "CALLCODE"]
STATE_READ_WRITE_LIST = ["SSTORE", "SLOAD", "CREATE", "CREATE2"]


def _reentrant_call_conditions(call_state: GlobalState) -> List[Bool]:
    """Conditions under which the recorded CALL can re-enter: enough gas
    forwarded for the callee to do state writes (> 2300, the stipend), and a
    target that is not one of the precompile addresses 1..16 (address 0 is
    allowed — it behaves like an empty account, not a precompile)."""
    forwarded_gas = call_state.mstate.stack[-1]
    callee = call_state.mstate.stack[-2]
    stipend = symbol_factory.BitVecVal(2300, 256)
    last_precompile = symbol_factory.BitVecVal(16, 256)
    zero = symbol_factory.BitVecVal(0, 256)
    return [
        UGT(forwarded_gas, stipend),
        Or(callee > last_precompile, callee == zero),
    ]


class StateChangeCallsAnnotation(StateAnnotation):
    """Rides on world-states downstream of an external call, accumulating any
    storage accesses observed after it."""

    def __init__(self, call_state: GlobalState, user_defined_address: bool):
        self.call_state = call_state
        self.state_change_states: List[GlobalState] = []
        self.user_defined_address = user_defined_address

    def __copy__(self):
        clone = StateChangeCallsAnnotation(
            self.call_state, self.user_defined_address
        )
        clone.state_change_states = list(self.state_change_states)
        return clone

    def get_issue(
        self, global_state: GlobalState, detector: DetectionModule
    ) -> Optional[PotentialIssue]:
        if not self.state_change_states:
            return None
        constraints = Constraints()
        constraints += _reentrant_call_conditions(self.call_state)
        if self.user_defined_address:
            callee = self.call_state.mstate.stack[-2]
            constraints += [callee == ACTORS.attacker]
        try:
            solver.get_transaction_sequence(
                global_state, constraints + global_state.world_state.constraints
            )
        except UnsatError:
            return None

        severity = "Medium" if self.user_defined_address else "Low"
        address = global_state.get_current_instruction()["address"]
        read_or_write = (
            "Read of"
            if global_state.get_current_instruction()["opcode"] == "SLOAD"
            else "Write to"
        )
        address_type = (
            "user defined" if self.user_defined_address else "fixed"
        )
        return PotentialIssue(
            contract=global_state.environment.active_account.contract_name,
            function_name=global_state.environment.active_function_name,
            address=address,
            title="State access after external call",
            severity=severity,
            description_head=(
                f"{read_or_write} persistent state following external call"
            ),
            description_tail=(
                "The contract account state is accessed after an external "
                f"call to a {address_type} address. To prevent reentrancy "
                "issues, consider accessing the state only before the call, "
                "especially if the callee is untrusted. Alternatively, a "
                "reentrancy lock can be used to prevent untrusted callees "
                "from re-entering the contract in an intermediate state."
            ),
            swc_id=REENTRANCY,
            bytecode=global_state.environment.code.bytecode,
            constraints=constraints,
            detector=detector,
        )


class StateChangeAfterCall(DetectionModule):
    name = "State change after an external call"
    swc_id = REENTRANCY
    description = (
        "Check whether the account state is accessed after the execution of "
        "an external call"
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = CALL_LIST + STATE_READ_WRITE_LIST

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        issues = self._analyze_state(state)
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(issues)

    @staticmethod
    def _add_external_call(global_state: GlobalState) -> None:
        to = global_state.mstate.stack[-2]
        try:
            constraints = copy(global_state.world_state.constraints)
            solver.get_model(
                tuple(constraints + _reentrant_call_conditions(global_state))
            )
            try:
                constraints += [to == ACTORS.attacker]
                solver.get_model(tuple(constraints))
                global_state.annotate(
                    StateChangeCallsAnnotation(global_state, True)
                )
            except UnsatError:
                global_state.annotate(
                    StateChangeCallsAnnotation(global_state, False)
                )
        except UnsatError:
            pass

    @staticmethod
    def _balance_change(value, global_state: GlobalState) -> bool:
        if isinstance(value, int):
            return value > 0
        if not isinstance(value, BitVec):
            return False
        if not value.symbolic:
            return value.value > 0
        constraints = copy(global_state.world_state.constraints)
        try:
            solver.get_model(
                tuple(constraints + [value > symbol_factory.BitVecVal(0, 256)])
            )
            return True
        except UnsatError:
            return False

    def _analyze_state(self, global_state: GlobalState) -> List[PotentialIssue]:
        annotations = cast(
            List[StateChangeCallsAnnotation],
            list(global_state.get_annotations(StateChangeCallsAnnotation)),
        )
        op_code = global_state.get_current_instruction()["opcode"]

        if len(annotations) == 0 and op_code in STATE_READ_WRITE_LIST:
            return []
        if op_code in STATE_READ_WRITE_LIST:
            for annotation in annotations:
                annotation.state_change_states.append(global_state)

        if op_code in CALL_LIST:
            value = global_state.mstate.stack[-3]
            if self._balance_change(value, global_state):
                for annotation in annotations:
                    annotation.state_change_states.append(global_state)
            self._add_external_call(global_state)

        vulnerabilities = []
        for annotation in annotations:
            if not annotation.state_change_states:
                continue
            issue = annotation.get_issue(global_state, self)
            if issue:
                vulnerabilities.append(issue)
        return vulnerabilities


detector = StateChangeAfterCall()
