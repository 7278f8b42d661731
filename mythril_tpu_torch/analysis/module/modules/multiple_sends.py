"""SWC-113: several external calls chained into one transaction.

A path that performs a second external call after a first one can be
wedged forever by a malicious first callee, so the detector tracks the
call sites a path has crossed (fork-surviving state annotation) and
reports at transaction end when two or more happened and the path is
feasible.

Reference counterpart: mythril/analysis/module/modules/multiple_sends.py
(same hooks and SWC id; the track/report split and single feasibility
check are this implementation's shape — the reference re-checks the
identical constraint set once per extra call site, which cannot change
the verdict).
"""

import logging
from copy import copy
from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.solver import get_transaction_sequence
from mythril_tpu_torch.analysis.swc_data import MULTIPLE_SENDS
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState

log = logging.getLogger(__name__)

_CALL_OPS = frozenset(["CALL", "DELEGATECALL", "STATICCALL", "CALLCODE"])

_DESCRIPTION_TAIL = (
    "This call is executed following another call within the same "
    "transaction. It is possible that the call never gets executed if "
    "a prior call fails permanently. This might be caused "
    "intentionally by a malicious callee. If possible, refactor the "
    "code such that each transaction only executes one external call "
    "or make sure that all callees can be trusted (i.e. they're part "
    "of your own codebase)."
)


class MultipleSendsAnnotation(StateAnnotation):
    """Call sites this path has crossed, carried across forks."""

    def __init__(self) -> None:
        self.call_offsets: List[int] = []

    def __copy__(self):
        fork = MultipleSendsAnnotation()
        fork.call_offsets = copy(self.call_offsets)
        return fork


def _path_calls(state: GlobalState) -> MultipleSendsAnnotation:
    for annotation in state.get_annotations(MultipleSendsAnnotation):
        return annotation
    fresh = MultipleSendsAnnotation()
    state.annotate(fresh)
    return fresh


class MultipleSends(DetectionModule):
    name = "Multiple external calls in the same transaction"
    swc_id = MULTIPLE_SENDS
    description = "Check for multiple sends in a single transaction"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = list(_CALL_OPS) + ["RETURN", "STOP"]

    def _execute(self, state: GlobalState) -> None:
        if state.get_current_instruction()["address"] in self.cache:
            return
        issue = self._inspect(state)
        if issue is not None:
            self.update_cache([issue])
            self.issues.append(issue)

    def _inspect(self, state: GlobalState) -> Optional[Issue]:
        """Track on call opcodes; judge on transaction end."""
        instruction = state.get_current_instruction()
        tracked = _path_calls(state).call_offsets
        if instruction["opcode"] in _CALL_OPS:
            tracked.append(instruction["address"])
            return None
        # RETURN/STOP: a chain needs at least two call sites, and the
        # path must be realizable (one check — the constraint set does
        # not depend on which chained call we anchor the issue to)
        if len(tracked) < 2:
            return None
        try:
            transaction_sequence = get_transaction_sequence(
                state, state.world_state.constraints
            )
        except UnsatError:
            return None
        environment = state.environment
        return Issue(
            contract=environment.active_account.contract_name,
            function_name=environment.active_function_name,
            address=tracked[1],  # the first *chained* call
            swc_id=MULTIPLE_SENDS,
            bytecode=environment.code.bytecode,
            title="Multiple Calls in a Single Transaction",
            severity="Low",
            description_head=(
                "Multiple calls are executed in the same transaction."
            ),
            description_tail=_DESCRIPTION_TAIL,
            gas_used=(
                state.mstate.min_gas_used,
                state.mstate.max_gas_used,
            ),
            transaction_sequence=transaction_sequence,
        )


detector = MultipleSends()
