"""SWC-112: delegatecall to user-supplied address (reference:
modules/delegatecall.py)."""

import logging
from typing import List

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import DELEGATECALL_TO_UNTRUSTED_CONTRACT
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.smt import UGT, symbol_factory

log = logging.getLogger(__name__)


class ArbitraryDelegateCall(DetectionModule):
    name = "Delegatecall to a user-specified address"
    swc_id = DELEGATECALL_TO_UNTRUSTED_CONTRACT
    description = "Check for invocations of delegatecall to a user-supplied address."
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["DELEGATECALL"]

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(self._analyze_state(state))

    def _analyze_state(self, state: GlobalState) -> List[PotentialIssue]:
        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]
        address = state.get_current_instruction()["address"]

        constraints = [
            to == ACTORS.attacker,
            UGT(gas, symbol_factory.BitVecVal(2300, 256)),
            state.new_bitvec(f"retval_{address}", 256) == 1,
        ]
        for tx in state.world_state.transaction_sequence:
            if not isinstance(tx, ContractCreationTransaction):
                constraints.append(tx.caller == ACTORS.attacker)

        return [
            PotentialIssue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=address,
                swc_id=DELEGATECALL_TO_UNTRUSTED_CONTRACT,
                bytecode=state.environment.code.bytecode,
                title="Delegatecall to user-supplied address",
                severity="High",
                description_head=(
                    "The contract delegates execution to another contract "
                    "with a user-supplied address."
                ),
                description_tail=(
                    "The smart contract delegates execution to a "
                    "user-supplied address. This could allow an attacker to "
                    "execute arbitrary code in the context of this contract "
                    "account and manipulate the state of the contract account "
                    "or execute actions on its behalf."
                ),
                constraints=constraints,
                detector=self,
            )
        ]


detector = ArbitraryDelegateCall()
