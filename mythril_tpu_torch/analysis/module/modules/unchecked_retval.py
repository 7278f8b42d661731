"""SWC-104: unchecked call return value (reference:
modules/unchecked_retval.py)."""

import logging
from copy import copy
from typing import Dict, List, Union, cast

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import UNCHECKED_RET_VAL
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.smt import BitVec

log = logging.getLogger(__name__)


class UncheckedRetvalAnnotation(StateAnnotation):
    def __init__(self) -> None:
        self.retvals: List[Dict[str, Union[int, BitVec]]] = []

    def __copy__(self):
        result = UncheckedRetvalAnnotation()
        result.retvals = copy(self.retvals)
        return result


class UncheckedRetval(DetectionModule):
    name = "Return value of an external call is not checked"
    swc_id = UNCHECKED_RET_VAL
    description = (
        "Test whether CALL return value is checked. For direct calls, the "
        "Solidity compiler auto-generates this check; for low-level calls "
        "it is omitted."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["STOP", "RETURN"]
    post_hooks = ["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"]

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        issues = self._analyze_state(state)
        self.update_cache(issues)
        self.issues.extend(issues)

    def _analyze_state(self, state: GlobalState) -> list:
        instruction = state.get_current_instruction()

        annotations = cast(
            List[UncheckedRetvalAnnotation],
            list(state.get_annotations(UncheckedRetvalAnnotation)),
        )
        if len(annotations) == 0:
            state.annotate(UncheckedRetvalAnnotation())
            annotations = cast(
                List[UncheckedRetvalAnnotation],
                list(state.get_annotations(UncheckedRetvalAnnotation)),
            )
        retvals = annotations[0].retvals

        if instruction["opcode"] in ("STOP", "RETURN"):
            issues = []
            for retval in retvals:
                try:
                    transaction_sequence = solver.get_transaction_sequence(
                        state,
                        state.world_state.constraints + [retval["retval"] == 0],
                    )
                except UnsatError:
                    continue
                issues.append(
                    Issue(
                        contract=state.environment.active_account.contract_name,
                        function_name=state.environment.active_function_name,
                        address=retval["address"],
                        bytecode=state.environment.code.bytecode,
                        title="Unchecked return value from external call.",
                        swc_id=UNCHECKED_RET_VAL,
                        severity="Medium",
                        description_head=(
                            "The return value of a message call is not "
                            "checked."
                        ),
                        description_tail=(
                            "External calls return a boolean value. If the "
                            "callee halts with an exception, 'false' is "
                            "returned and execution continues in the caller. "
                            "The caller should check whether an exception "
                            "happened and react accordingly to avoid "
                            "unexpected behavior. For example it is often "
                            "desirable to wrap external calls in require() so "
                            "the transaction is reverted if the call fails."
                        ),
                        gas_used=(
                            state.mstate.min_gas_used,
                            state.mstate.max_gas_used,
                        ),
                        transaction_sequence=transaction_sequence,
                    )
                )
            return issues

        # post-hook of a call op: record its return value
        assert state.environment.code.instruction_list[
            state.mstate.pc - 1
        ].op_code in ("CALL", "DELEGATECALL", "STATICCALL", "CALLCODE")
        return_value = state.mstate.stack[-1]
        retvals.append(
            {"address": state.instruction["address"] - 1, "retval": return_value}
        )
        return []


detector = UncheckedRetval()
