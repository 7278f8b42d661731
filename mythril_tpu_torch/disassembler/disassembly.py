"""Disassembly: instruction list + function-entry discovery.

Reference counterpart: mythril/disassembler/disassembly.py — decodes
bytecode, then recognizes the Solidity dispatcher idiom
``DUP1; PUSH4 <selector>; EQ; PUSH<n> <entry>; JUMPI`` to build the
selector->entry-point maps used for report function names and CFG
labels.  Names resolve through :class:`SignatureDB`.
"""

import logging
from typing import Dict, List

from mythril_tpu_torch.disassembler import asm
from mythril_tpu_torch.support.crypto import keccak256
from mythril_tpu_torch.support.signatures import SignatureDB

log = logging.getLogger(__name__)

# The dispatcher comparison site.  The selector push is PUSH1..PUSH4:
# solc's optimizer strips leading zero bytes from selectors (reference
# handles this by zero-padding, disassembly.py:41,85).  The entry push
# may be 1-4 bytes wide.
_SELECTOR_PUSHES = ["PUSH1", "PUSH2", "PUSH3", "PUSH4"]
_DISPATCHER_PATTERN = [
    _SELECTOR_PUSHES,
    ["EQ"],
    _SELECTOR_PUSHES,
    ["JUMPI"],
]


class Disassembly:
    """Decoded bytecode plus selector/function metadata."""

    def __init__(self, code: str, enable_online_lookup: bool = False):
        if isinstance(code, (bytes, bytearray)):
            code = "0x" + bytes(code).hex()
        self.bytecode = code
        try:
            self.raw_bytecode = bytes.fromhex(code.removeprefix("0x"))
        except ValueError:
            # wild input (odd nibble, whitespace, 0X prefix): the
            # triage normalizer repairs what it can and raises the
            # typed BytecodeInputError — a CriticalError the CLI maps
            # to a one-line exit 2 — for genuinely non-hex input
            from mythril_tpu_torch.disassembler.triage import normalize_hex

            self.raw_bytecode = normalize_hex(code)
            self.bytecode = "0x" + self.raw_bytecode.hex()
        self.instruction_list: List[asm.EvmInstruction] = asm.disassemble(
            self.raw_bytecode
        )
        self.func_hashes: List[str] = []
        self.function_name_to_address: Dict[str, int] = {}
        self.address_to_function_name: Dict[int, str] = {}
        self.enable_online_lookup = enable_online_lookup
        signature_db = SignatureDB(enable_online_lookup=enable_online_lookup)

        for index in asm.find_op_code_sequence(
            _DISPATCHER_PATTERN, self.instruction_list
        ):
            selector_instr = self.instruction_list[index]
            entry_instr = self.instruction_list[index + 2]
            assert selector_instr.argument is not None
            assert entry_instr.argument is not None
            selector = "0x" + selector_instr.argument.hex().rjust(8, "0")
            entry = int.from_bytes(entry_instr.argument, "big")
            matches = signature_db.get(selector)
            if matches:
                name = matches[0]
                if len(matches) > 1:
                    log.debug("Ambiguous signature for %s: %s", selector, matches)
            else:
                name = f"_function_{selector}"
            self.func_hashes.append(selector)
            self.function_name_to_address[name] = entry
            self.address_to_function_name[entry] = name

    def get_easm(self) -> str:
        return asm.instruction_list_to_easm(self.instruction_list)

    def assign_bytecode(self, bytecode) -> None:
        """Replace the code (used when a creation tx returns runtime code)."""
        self.__init__(bytecode, enable_online_lookup=self.enable_online_lookup)

    def __len__(self) -> int:
        return len(self.raw_bytecode)


def get_code_hash(code) -> str:
    """keccak256 of the (hex or raw) bytecode, 0x-prefixed."""
    if isinstance(code, str):
        code = bytes.fromhex(code.removeprefix("0x"))
    return "0x" + keccak256(bytes(code)).hex()
