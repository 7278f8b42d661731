"""SWC-124: write to arbitrary storage slot (reference:
modules/arbitrary_write.py)."""

import logging

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.potential_issues import (
    PotentialIssue,
    get_potential_issues_annotation,
)
from mythril_tpu_torch.analysis.swc_data import WRITE_TO_ARBITRARY_STORAGE
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.smt import symbol_factory

log = logging.getLogger(__name__)

# An arbitrary probe slot: if the caller can force a write here, the
# write target is attacker-controlled.
_PROBE_SLOT = 324345425435


class ArbitraryStorage(DetectionModule):
    name = "Caller can write to arbitrary storage locations"
    swc_id = WRITE_TO_ARBITRARY_STORAGE
    description = "Search for any writes to an arbitrary storage slot"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["SSTORE"]

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        annotation = get_potential_issues_annotation(state)
        annotation.potential_issues.extend(self._analyze_state(state))

    def _analyze_state(self, state: GlobalState):
        write_slot = state.mstate.stack[-1]
        constraints = state.world_state.constraints + [
            write_slot == symbol_factory.BitVecVal(_PROBE_SLOT, 256)
        ]
        return [
            PotentialIssue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=state.get_current_instruction()["address"],
                swc_id=WRITE_TO_ARBITRARY_STORAGE,
                title="Write to an arbitrary storage location",
                severity="High",
                bytecode=state.environment.code.bytecode,
                description_head=(
                    "The caller can write to arbitrary storage locations."
                ),
                description_tail=(
                    "It is possible to write to arbitrary storage locations. "
                    "By modifying the values of storage variables, attackers "
                    "may bypass security controls or manipulate the business "
                    "logic of the smart contract."
                ),
                detector=self,
                constraints=constraints,
            )
        ]


detector = ArbitraryStorage()
