"""Laser helpers (reference: laser/ethereum/util.py)."""

import re
from typing import List, Union

from mythril_tpu_torch.smt import BitVec, Bool, Concat, Extract, If, simplify, symbol_factory

TT256 = 2**256
TT256M1 = 2**256 - 1
TT255 = 2**255


def safe_decode(hex_encoded_string: str) -> bytes:
    if hex_encoded_string.startswith("0x"):
        hex_encoded_string = hex_encoded_string[2:]
    return bytes.fromhex(hex_encoded_string)


def to_signed(i: int) -> int:
    return i if i < TT255 else i - TT256


def get_instruction_index(instruction_list: List, address: int) -> Union[int, None]:
    index = 0
    for instr in instruction_list:
        if instr.address >= address:
            return index
        index += 1
    return None


def get_concrete_int(item: Union[int, BitVec]) -> int:
    """Concrete value of item, or TypeError if symbolic (callers catch)."""
    if isinstance(item, int):
        return item
    if isinstance(item, BitVec):
        if item.value is None:
            raise TypeError("Got a symbolic BitVec")
        return item.value
    if isinstance(item, Bool):
        value = item.value
        if value is None:
            raise TypeError("Got a symbolic Bool")
        return int(value)
    raise TypeError(f"cannot concretize {type(item)}")


def to_bitvec(item, size: int = 256) -> BitVec:
    """Coerce an int/Bool/BitVec to a BitVec (Bool becomes If(b,1,0))."""
    if isinstance(item, Bool):
        return If(
            item,
            symbol_factory.BitVecVal(1, size),
            symbol_factory.BitVecVal(0, size),
        )
    if isinstance(item, int):
        return symbol_factory.BitVecVal(item, size)
    return item


def pop_bitvec(state) -> BitVec:
    """Pop one stack element, coercing Bool/int to a 256-bit BitVec."""
    return to_bitvec(state.stack.pop())


def concrete_int_from_bytes(data: Union[bytes, List], start_index: int) -> int:
    """Big-endian word read from a byte list that may contain BitVecs."""
    out = 0
    for i in range(32):
        byte = data[start_index + i] if start_index + i < len(data) else 0
        if isinstance(byte, BitVec):
            byte = get_concrete_int(byte)
        out = (out << 8) | byte
    return out


def concrete_int_to_bytes(value: Union[int, BitVec]) -> bytes:
    if isinstance(value, BitVec):
        value = get_concrete_int(value)
    return value.to_bytes(32, "big")


def int_overflow(value: int) -> int:
    return value & TT256M1


def extract_copy(data: bytearray, mem: bytearray, memstart, datastart, size):
    for i in range(size):
        if datastart + i < len(data):
            mem[memstart + i] = data[datastart + i]
        else:
            mem[memstart + i] = 0


def extract32(data: bytearray, i: int) -> int:
    if i >= len(data):
        return 0
    chunk = data[i : i + 32]
    chunk = chunk + b"\x00" * (32 - len(chunk))
    return int.from_bytes(chunk, "big")
