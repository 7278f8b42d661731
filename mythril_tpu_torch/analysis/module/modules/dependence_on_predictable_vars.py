"""SWC-116/120: control flow depends on predictable block variables
(reference: modules/dependence_on_predictable_vars.py)."""

import logging
from typing import List, cast

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.module.module_helpers import is_prehook
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import TIMESTAMP_DEPENDENCE, WEAK_RANDOMNESS
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.smt import ULT, symbol_factory

log = logging.getLogger(__name__)

predictable_ops = ["COINBASE", "GASLIMIT", "TIMESTAMP", "NUMBER"]


class PredictableValueAnnotation:
    def __init__(self, operation: str) -> None:
        self.operation = operation


class OldBlockNumberUsedAnnotation(StateAnnotation):
    pass


class PredictableVariables(DetectionModule):
    name = "Control flow depends on a predictable environment variable"
    swc_id = f"{TIMESTAMP_DEPENDENCE} {WEAK_RANDOMNESS}"
    description = (
        "Check whether control flow decisions are influenced by "
        "block.coinbase, block.gaslimit, block.timestamp or block.number."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["JUMPI", "BLOCKHASH"]
    post_hooks = ["BLOCKHASH"] + predictable_ops

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        issues = self._analyze_state(state)
        self.update_cache(issues)
        self.issues.extend(issues)

    @staticmethod
    def _analyze_state(state: GlobalState) -> list:
        issues = []
        if is_prehook():
            opcode = state.get_current_instruction()["opcode"]
            if opcode == "JUMPI":
                for annotation in state.mstate.stack[-2].annotations:
                    if not isinstance(annotation, PredictableValueAnnotation):
                        continue
                    try:
                        transaction_sequence = solver.get_transaction_sequence(
                            state, state.world_state.constraints
                        )
                    except UnsatError:
                        continue
                    swc_id = (
                        TIMESTAMP_DEPENDENCE
                        if "timestamp" in annotation.operation
                        else WEAK_RANDOMNESS
                    )
                    description = (
                        annotation.operation
                        + " is used to determine a control flow decision. "
                        "Note that the values of variables like coinbase, "
                        "gaslimit, block number and timestamp are predictable "
                        "and can be manipulated by a malicious miner. Also "
                        "keep in mind that attackers know hashes of earlier "
                        "blocks. Don't use any of those environment variables "
                        "as sources of randomness and be aware that use of "
                        "these variables introduces a certain level of trust "
                        "into miners."
                    )
                    issues.append(
                        Issue(
                            contract=state.environment.active_account.contract_name,
                            function_name=state.environment.active_function_name,
                            address=state.get_current_instruction()["address"],
                            swc_id=swc_id,
                            bytecode=state.environment.code.bytecode,
                            title="Dependence on predictable environment variable",
                            severity="Low",
                            description_head=(
                                "A control flow decision is made based on "
                                f"{annotation.operation}."
                            ),
                            description_tail=description,
                            gas_used=(
                                state.mstate.min_gas_used,
                                state.mstate.max_gas_used,
                            ),
                            transaction_sequence=transaction_sequence,
                        )
                    )
            elif opcode == "BLOCKHASH":
                param = state.mstate.stack[-1]
                constraint = [
                    ULT(param, state.environment.block_number),
                    ULT(
                        state.environment.block_number,
                        symbol_factory.BitVecVal(2**255, 256),
                    ),
                ]
                try:
                    solver.get_model(
                        tuple(state.world_state.constraints + constraint)
                    )
                    state.annotate(OldBlockNumberUsedAnnotation())
                except UnsatError:
                    pass
        else:
            # post-hook
            opcode = state.environment.code.instruction_list[
                state.mstate.pc - 1
            ].op_code
            if opcode == "BLOCKHASH":
                annotations = cast(
                    List[OldBlockNumberUsedAnnotation],
                    list(state.get_annotations(OldBlockNumberUsedAnnotation)),
                )
                if len(annotations):
                    state.mstate.stack[-1].annotate(
                        PredictableValueAnnotation(
                            "The block hash of a previous block"
                        )
                    )
            else:
                state.mstate.stack[-1].annotate(
                    PredictableValueAnnotation(
                        f"The block.{opcode.lower()} environment variable"
                    )
                )
        return issues


detector = PredictableVariables()
