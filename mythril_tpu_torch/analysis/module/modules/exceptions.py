"""SWC-110: reachable assertion violation (reference:
modules/exceptions.py)."""

import logging

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)


class Exceptions(DetectionModule):
    name = "Assertion violation"
    swc_id = ASSERT_VIOLATION
    description = "Checks whether any exception states are reachable."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["ASSERT_FAIL"]

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        issues = self._analyze_state(state)
        self.update_cache(issues)
        self.issues.extend(issues)

    @staticmethod
    def _analyze_state(state: GlobalState) -> list:
        log.debug(
            "ASSERT_FAIL in function %s", state.environment.active_function_name
        )
        try:
            transaction_sequence = solver.get_transaction_sequence(
                state, state.world_state.constraints
            )
        except UnsatError:
            log.debug("no model found")
            return []
        return [
            Issue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=state.get_current_instruction()["address"],
                swc_id=ASSERT_VIOLATION,
                title="Exception State",
                severity="Medium",
                description_head="An assertion violation was triggered.",
                description_tail=(
                    "It is possible to trigger an assertion violation. Note "
                    "that Solidity assert() statements should only be used to "
                    "check invariants. Review the transaction trace generated "
                    "for this issue and either make sure your program logic "
                    "is correct, or use require() instead of assert() if your "
                    "goal is to constrain user inputs or enforce "
                    "preconditions. Remember to validate inputs from both "
                    "callers (for instance, via passed arguments) and callees "
                    "(for instance, via return values)."
                ),
                bytecode=state.environment.code.bytecode,
                transaction_sequence=transaction_sequence,
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            )
        ]


detector = Exceptions()
