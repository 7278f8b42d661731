"""Linear-sweep EVM disassembler.

Behavioral parity with reference mythril/disassembler/asm.py: linear
sweep over the opcode table, PUSH-argument extraction, truncated-PUSH
tolerance, and skipping the Solidity metadata ("swarm hash") tail so
data bytes are not disassembled as garbage instructions.
"""

from typing import Dict, List, Optional

from mythril_tpu_torch.support.opcodes import OPCODES, OpInfo

# CBOR metadata markers emitted by solc at the end of deployed bytecode.
_METADATA_MARKERS = (
    bytes.fromhex("a165627a7a72"),  # 0xa1 0x65 'bzzr'  (solc < 0.6)
    bytes.fromhex("a26469706673"),  # 0xa2 0x64 'ipfs'  (solc >= 0.6)
)


class EvmInstruction:
    """One decoded instruction: byte offset, mnemonic, optional PUSH arg."""

    __slots__ = ("address", "op_code", "argument")

    def __init__(self, address: int, op_code: str, argument: Optional[bytes] = None):
        self.address = address
        self.op_code = op_code
        self.argument = argument

    def to_dict(self) -> Dict:
        result = {"address": self.address, "opcode": self.op_code}
        if self.argument is not None:
            result["argument"] = "0x" + self.argument.hex()
        return result

    def __repr__(self) -> str:
        if self.argument is not None:
            return f"{self.address} {self.op_code} 0x{self.argument.hex()}"
        return f"{self.address} {self.op_code}"


def _metadata_start(bytecode: bytes) -> int:
    """Byte offset where the solc metadata tail begins (len(code) if none)."""
    best = len(bytecode)
    for marker in _METADATA_MARKERS:
        idx = bytecode.rfind(marker)
        if idx == -1:
            continue
        # The final two bytes encode the metadata length; sanity-check that
        # the marker really sits at the start of a tail of that size.
        if len(bytecode) >= 2:
            declared = int.from_bytes(bytecode[-2:], "big")
            if idx == len(bytecode) - 2 - declared:
                best = min(best, idx)
    return best


def disassemble(bytecode: bytes) -> List[EvmInstruction]:
    """Decode bytecode into an instruction list (data tail excluded)."""
    if isinstance(bytecode, str):
        bytecode = bytes.fromhex(bytecode.removeprefix("0x"))
    end = _metadata_start(bytes(bytecode))
    instructions: List[EvmInstruction] = []
    pc = 0
    while pc < end:
        byte = bytecode[pc]
        info: Optional[OpInfo] = OPCODES.get(byte)
        if info is None:
            instructions.append(EvmInstruction(pc, "INVALID"))
            pc += 1
            continue
        if info.name.startswith("PUSH"):
            width = byte - 0x5F
            argument = bytes(bytecode[pc + 1 : pc + 1 + width])
            # Tolerate truncated PUSH at end-of-code (zero-padded per spec).
            argument = argument + b"\x00" * (width - len(argument))
            instructions.append(EvmInstruction(pc, info.name, argument))
            pc += 1 + width
        else:
            instructions.append(EvmInstruction(pc, info.name))
            pc += 1
    return instructions


def instruction_list_to_easm(instructions: List[EvmInstruction]) -> str:
    """Render instructions in the reference's text disassembly format."""
    lines = []
    for instr in instructions:
        if instr.argument is not None:
            lines.append(f"{instr.address} {instr.op_code} 0x{instr.argument.hex()}")
        else:
            lines.append(f"{instr.address} {instr.op_code}")
    return "\n".join(lines) + "\n"


def find_op_code_sequence(pattern: List[List[str]], instructions: List[EvmInstruction]):
    """Yield start indices where the instruction stream matches ``pattern``.

    ``pattern`` is a list of positions, each a list of acceptable opcode
    names (reference: asm.py:61 search DSL).
    """
    for start in range(len(instructions) - len(pattern) + 1):
        if all(
            instructions[start + i].op_code in alternatives
            for i, alternatives in enumerate(pattern)
        ):
            yield start
