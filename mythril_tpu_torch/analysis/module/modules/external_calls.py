"""SWC-107: external call to user-supplied address with gas (reference:
modules/external_calls.py)."""

import logging
from copy import copy

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import REENTRANCY
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.natives import PRECOMPILE_COUNT
from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import ACTORS
from mythril_tpu_torch.smt import UGT, Or, symbol_factory

log = logging.getLogger(__name__)


def _is_precompile_call(global_state: GlobalState) -> bool:
    to = global_state.mstate.stack[-2]
    constraints = copy(global_state.world_state.constraints)
    constraints += [
        Or(
            to < symbol_factory.BitVecVal(1, 256),
            to > symbol_factory.BitVecVal(PRECOMPILE_COUNT, 256),
        )
    ]
    try:
        solver.get_model(tuple(constraints))
        return False
    except UnsatError:
        return True


class ExternalCalls(DetectionModule):
    name = "External call to another contract"
    swc_id = REENTRANCY
    description = (
        "Search for external calls with unrestricted gas to a user-specified "
        "address."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["CALL"]

    def _execute(self, state: GlobalState) -> None:
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(self._analyze_state(state))

    def _analyze_state(self, state: GlobalState):
        gas = state.mstate.stack[-1]
        to = state.mstate.stack[-2]
        address = state.get_current_instruction()["address"]
        try:
            constraints = Constraints(
                [
                    UGT(gas, symbol_factory.BitVecVal(2300, 256)),
                    to == ACTORS.attacker,
                ]
            )
            solver.get_transaction_sequence(
                state, constraints + state.world_state.constraints
            )
        except UnsatError:
            log.debug("[EXTERNAL_CALLS] No model found.")
            return []
        return [
            PotentialIssue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=address,
                swc_id=REENTRANCY,
                title="External Call To User-Supplied Address",
                bytecode=state.environment.code.bytecode,
                severity="Low",
                description_head=(
                    "A call to a user-supplied address is executed."
                ),
                description_tail=(
                    "An external message call to an address specified by the "
                    "caller is executed. Note that the callee account might "
                    "contain arbitrary code and could re-enter any function "
                    "within this contract. Reentering the contract in an "
                    "intermediate state may lead to unexpected behaviour. "
                    "Make sure that no state modifications are executed after "
                    "this call and/or reentrancy guards are in place."
                ),
                constraints=constraints,
                detector=self,
            )
        ]


detector = ExternalCalls()
