"""SWC-127: jump to caller-controlled destination (reference:
modules/arbitrary_jump.py)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import ARBITRARY_JUMP
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)


class ArbitraryJump(DetectionModule):
    name = "Caller can redirect execution to arbitrary bytecode locations"
    swc_id = ARBITRARY_JUMP
    description = "Search for jumps to arbitrary locations in the bytecode"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMP", "JUMPI"]

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        issues = self._analyze_state(state)
        self.update_cache(issues)
        self.issues.extend(issues)

    @staticmethod
    def _analyze_state(state: GlobalState):
        jump_dest = state.mstate.stack[-1]
        if not getattr(jump_dest, "symbolic", False):
            return []
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except UnsatError:
            return []
        return [
            Issue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=state.get_current_instruction()["address"],
                swc_id=ARBITRARY_JUMP,
                title="Jump to an arbitrary instruction",
                severity="High",
                bytecode=state.environment.code.bytecode,
                description_head=(
                    "The caller can redirect execution to arbitrary bytecode "
                    "locations."
                ),
                description_tail=(
                    "It is possible to redirect the control flow to arbitrary "
                    "locations in the code. This may allow an attacker to "
                    "bypass security controls or manipulate the business logic "
                    "of the smart contract. Avoid using low-level-operations "
                    "and assembly to prevent this issue."
                ),
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
                transaction_sequence=transaction_sequence,
            )
        ]


detector = ArbitraryJump()
