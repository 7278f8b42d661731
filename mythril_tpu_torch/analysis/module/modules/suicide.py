"""SWC-106: unprotected SELFDESTRUCT (reference: modules/suicide.py)."""

import logging

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_SELFDESTRUCT
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.smt import And

log = logging.getLogger(__name__)


class AccidentallyKillable(DetectionModule):
    """Can anyone kill the contract (and direct the balance to
    themselves)?"""

    name = "Contract can be accidentally killed by anyone"
    swc_id = UNPROTECTED_SELFDESTRUCT
    description = (
        "Check if the contract can be 'accidentally' killed by anyone; for "
        "killable contracts, check whether the balance can be sent to the "
        "attacker."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SUICIDE"]

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        issues = self._analyze_state(state)
        self.update_cache(issues)
        self.issues.extend(issues)

    @staticmethod
    def _analyze_state(state: GlobalState):
        log.debug(
            "SUICIDE in function %s", state.environment.active_function_name
        )
        instruction = state.get_current_instruction()
        to = state.mstate.stack[-1]

        attacker_constraints = []
        for tx in state.world_state.transaction_sequence:
            if not isinstance(tx, ContractCreationTransaction):
                attacker_constraints.append(
                    And(tx.caller == ACTORS.attacker, tx.caller == tx.origin)
                )
        try:
            try:
                transaction_sequence = solver.get_transaction_sequence(
                    state,
                    state.world_state.constraints
                    + attacker_constraints
                    + [to == ACTORS.attacker],
                )
                description_tail = (
                    "Any sender can trigger execution of the SELFDESTRUCT "
                    "instruction to destroy this contract account and "
                    "withdraw its balance to an arbitrary address. Review the "
                    "transaction trace generated for this issue and make sure "
                    "that appropriate security controls are in place to "
                    "prevent unrestricted access."
                )
            except UnsatError:
                transaction_sequence = solver.get_transaction_sequence(
                    state, state.world_state.constraints + attacker_constraints
                )
                description_tail = (
                    "Any sender can trigger execution of the SELFDESTRUCT "
                    "instruction to destroy this contract account. Review the "
                    "transaction trace generated for this issue and make sure "
                    "that appropriate security controls are in place to "
                    "prevent unrestricted access."
                )
            return [
                Issue(
                    contract=state.environment.active_account.contract_name,
                    function_name=state.environment.active_function_name,
                    address=instruction["address"],
                    swc_id=UNPROTECTED_SELFDESTRUCT,
                    bytecode=state.environment.code.bytecode,
                    title="Unprotected Selfdestruct",
                    severity="High",
                    description_head=(
                        "Any sender can cause the contract to self-destruct."
                    ),
                    description_tail=description_tail,
                    transaction_sequence=transaction_sequence,
                    gas_used=(
                        state.mstate.min_gas_used,
                        state.mstate.max_gas_used,
                    ),
                )
            ]
        except UnsatError:
            log.debug("No model found")
        return []


detector = AccidentallyKillable()
