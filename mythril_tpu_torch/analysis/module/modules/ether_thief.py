"""SWC-105: unprotected ether withdrawal (reference:
modules/ether_thief.py)."""

import logging
from copy import copy

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import UNPROTECTED_ETHER_WITHDRAWAL
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import UGT

log = logging.getLogger(__name__)


class EtherThief(DetectionModule):
    """Reports valid end states where the attacker's balance increased."""

    name = "Any sender can withdraw ETH from the contract account"
    swc_id = UNPROTECTED_ETHER_WITHDRAWAL
    description = (
        "Search for cases where Ether can be withdrawn to a user-specified "
        "address."
    )
    entry_point = EntryPoint.CALLBACK
    post_hooks = ["CALL", "STATICCALL"]

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(self._analyze_state(state))

    def _analyze_state(self, state: GlobalState):
        state = copy(state)
        instruction = state.get_current_instruction()
        constraints = copy(state.world_state.constraints)
        constraints += [
            UGT(
                state.world_state.balances[ACTORS.attacker],
                state.world_state.starting_balances[ACTORS.attacker],
            ),
            state.environment.sender == ACTORS.attacker,
            state.current_transaction.caller == state.current_transaction.origin,
        ]
        try:
            # pre-solve: only record if the attacker profit is reachable
            solver.get_model(tuple(constraints))
        except UnsatError:
            return []
        return [
            PotentialIssue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                # post-hook: report the offset of the CALL itself
                address=instruction["address"] - 1,
                swc_id=UNPROTECTED_ETHER_WITHDRAWAL,
                title="Unprotected Ether Withdrawal",
                severity="High",
                bytecode=state.environment.code.bytecode,
                description_head=(
                    "Any sender can withdraw Ether from the contract account."
                ),
                description_tail=(
                    "Arbitrary senders other than the contract creator can "
                    "profitably extract Ether from the contract account. "
                    "Verify the business logic carefully and make sure that "
                    "appropriate security controls are in place to prevent "
                    "unexpected loss of funds."
                ),
                detector=self,
                constraints=constraints,
            )
        ]


detector = EtherThief()
