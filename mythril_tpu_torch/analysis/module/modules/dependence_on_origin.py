"""SWC-115: control flow depends on tx.origin (reference:
modules/dependence_on_origin.py)."""

import logging
from copy import copy

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import TX_ORIGIN_USAGE
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)


class TxOriginAnnotation:
    """Taints values initialized from the ORIGIN instruction."""


class TxOrigin(DetectionModule):
    name = "Control flow depends on tx.origin"
    swc_id = TX_ORIGIN_USAGE
    description = "Check whether control flow decisions are influenced by tx.origin"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI"]
    post_hooks = ["ORIGIN"]

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        issues = self._analyze_state(state)
        self.update_cache(issues)
        self.issues.extend(issues)

    @staticmethod
    def _analyze_state(state: GlobalState) -> list:
        issues = []
        if state.get_current_instruction()["opcode"] == "JUMPI":
            # JUMPI pre-hook: check the branch condition for origin taint
            for annotation in state.mstate.stack[-2].annotations:
                if not isinstance(annotation, TxOriginAnnotation):
                    continue
                constraints = copy(state.world_state.constraints)
                try:
                    transaction_sequence = solver.get_transaction_sequence(
                        state, constraints
                    )
                except UnsatError:
                    continue
                issues.append(
                    Issue(
                        contract=state.environment.active_account.contract_name,
                        function_name=state.environment.active_function_name,
                        address=state.get_current_instruction()["address"],
                        swc_id=TX_ORIGIN_USAGE,
                        bytecode=state.environment.code.bytecode,
                        title="Dependence on tx.origin",
                        severity="Low",
                        description_head=(
                            "Use of tx.origin as a part of authorization "
                            "control."
                        ),
                        description_tail=(
                            "The tx.origin environment variable has been "
                            "found to influence a control flow decision. Note "
                            "that using tx.origin as a security control might "
                            "cause a situation where a user inadvertently "
                            "authorizes a smart contract to perform an action "
                            "on their behalf. It is recommended to use "
                            "msg.sender instead."
                        ),
                        gas_used=(
                            state.mstate.min_gas_used,
                            state.mstate.max_gas_used,
                        ),
                        transaction_sequence=transaction_sequence,
                    )
                )
        else:
            # ORIGIN post-hook: taint the pushed value
            state.mstate.stack[-1].annotate(TxOriginAnnotation())
        return issues


detector = TxOrigin()
