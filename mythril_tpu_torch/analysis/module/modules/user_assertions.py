"""SWC-110: user-defined assertion failures — emit AssertionFailed(string)
or the mstore marker pattern (reference: modules/user_assertions.py)."""

import logging

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.report import Issue
from mythril_tpu_torch.analysis.swc_data import ASSERT_VIOLATION
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.smt import Extract

log = logging.getLogger(__name__)

assertion_failed_hash = (
    0xB42604CB105A16C8F6DB8A41E6B00C0C1B4826465E8BC504B3EB3E88B3E6A4A0
)

mstore_pattern = "0xcafecafecafecafecafecafecafecafecafecafecafecafecafecafecafe"


def _decode_abi_string(data: bytes) -> str:
    """Minimal ABI decode of a single dynamic string (head offset,
    length, payload) — replaces the reference's eth_abi dependency."""
    if len(data) < 64:
        raise ValueError("short ABI payload")
    offset = int.from_bytes(data[:32], "big")
    length = int.from_bytes(data[offset : offset + 32], "big")
    payload = data[offset + 32 : offset + 32 + length]
    return payload.decode("utf8")


class UserAssertions(DetectionModule):
    name = "A user-defined assertion has been triggered"
    swc_id = ASSERT_VIOLATION
    description = (
        "Search for reachable user-supplied exceptions: emit "
        "AssertionFailed(string)."
    )
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["LOG1", "MSTORE"]

    def _execute(self, state: GlobalState) -> None:
        issues = self._analyze_state(state)
        self.update_cache(issues)
        self.issues.extend(issues)

    def _analyze_state(self, state: GlobalState):
        opcode = state.get_current_instruction()["opcode"]
        message = None
        if opcode == "MSTORE":
            value = state.mstate.stack[-2]
            if not hasattr(value, "symbolic") or value.symbolic:
                return []
            if mstore_pattern not in hex(value.value)[:126]:
                return []
            message = f"Failed property id {Extract(15, 0, value).value}"
        else:
            topic, size, mem_start = state.mstate.stack[-3:]
            if topic.symbolic or topic.value != assertion_failed_hash:
                return []
            if not mem_start.symbolic and not size.symbolic:
                try:
                    raw = bytes(
                        b if isinstance(b, int) else (b.value or 0)
                        for b in state.mstate.memory[
                            mem_start.value + 32 : mem_start.value + size.value
                        ]
                    )
                    message = _decode_abi_string(raw)
                except Exception:
                    pass
        try:
            transaction_sequence = solver.get_transaction_sequence(
                state, state.world_state.constraints
            )
        except UnsatError:
            log.debug("no model found")
            return []
        description_tail = (
            f"A user-provided assertion failed with the message '{message}'"
            if message
            else "A user-provided assertion failed."
        )
        return [
            Issue(
                contract=state.environment.active_account.contract_name,
                function_name=state.environment.active_function_name,
                address=state.get_current_instruction()["address"],
                swc_id=ASSERT_VIOLATION,
                title="Exception State",
                severity="Medium",
                description_head="A user-provided assertion failed.",
                description_tail=description_tail,
                bytecode=state.environment.code.bytecode,
                transaction_sequence=transaction_sequence,
                gas_used=(state.mstate.min_gas_used, state.mstate.max_gas_used),
            )
        ]


detector = UserAssertions()
