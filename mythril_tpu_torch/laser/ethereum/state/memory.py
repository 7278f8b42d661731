"""Byte-addressed EVM memory (reference: laser/ethereum/state/memory.py).

List-backed (one entry per byte, int or 8-bit BitVec).  Word reads and
writes go through Concat/Extract; symbolic start indices are supported
for whole words by building a 256-bit symbolic read over an
``If``-ladder only when required (the reference instead kept a
Dict[BitVec, byte] — a list is simpler and vectorizes into the batched
backend later).
"""

from typing import List, Union

from mythril_tpu_torch.laser.ethereum import util
from mythril_tpu_torch.smt import BitVec, Bool, Concat, Extract, If, simplify, symbol_factory


def convert_bv(val: Union[int, BitVec]) -> BitVec:
    if isinstance(val, BitVec):
        return val
    return symbol_factory.BitVecVal(val, 256)


# Upper bound on iterations when addressing with symbolic sizes
APPROX_ITR = 100


class Memory:
    def __init__(self):
        self._memory: List[Union[int, BitVec]] = []

    def __len__(self) -> int:
        return len(self._memory)

    @property
    def size(self) -> int:
        return len(self._memory)

    def extend(self, size: int) -> None:
        self._memory.extend([0] * size)

    def get_word_at(self, index: int) -> Union[int, BitVec]:
        """32-byte big-endian word at concrete byte offset ``index``."""
        parts = []
        all_concrete = True
        for i in range(index, index + 32):
            byte = self._memory[i] if 0 <= i < len(self._memory) else 0
            parts.append(byte)
            if isinstance(byte, BitVec) and byte.value is None:
                all_concrete = False
        if all_concrete:
            value = 0
            for byte in parts:
                byte_value = byte.value if isinstance(byte, BitVec) else byte
                value = (value << 8) | byte_value
            return symbol_factory.BitVecVal(value, 256)
        bvs = [
            b if isinstance(b, BitVec) else symbol_factory.BitVecVal(b, 8)
            for b in parts
        ]
        return Concat(*bvs)

    def write_word_at(self, index: int, value: Union[int, BitVec, Bool]) -> None:
        """Write a 32-byte big-endian word at concrete byte offset."""
        if len(self._memory) < index + 32:
            self.extend(index + 32 - len(self._memory))
        if isinstance(value, Bool):
            value = If(
                value,
                symbol_factory.BitVecVal(1, 256),
                symbol_factory.BitVecVal(0, 256),
            )
        if isinstance(value, int):
            value = symbol_factory.BitVecVal(value, 256)
        if value.value is not None:
            concrete = value.value
            for i in range(32):
                self._memory[index + 31 - i] = (concrete >> (8 * i)) & 0xFF
        else:
            for i in range(32):
                self._memory[index + 31 - i] = Extract(8 * i + 7, 8 * i, value)

    def __getitem__(self, item: Union[int, BitVec, slice]):
        if isinstance(item, slice):
            start = 0 if item.start is None else item.start
            stop = len(self._memory) if item.stop is None else item.stop
            if isinstance(start, BitVec):
                start = util.get_concrete_int(start)
            if isinstance(stop, BitVec):
                stop = util.get_concrete_int(stop)
            return [self[i] for i in range(start, stop, item.step or 1)]
        if isinstance(item, BitVec):
            item = util.get_concrete_int(item)
        if item < 0 or item >= len(self._memory):
            return 0
        return self._memory[item]

    def __setitem__(self, key: Union[int, BitVec, slice], value) -> None:
        if isinstance(key, slice):
            start, stop, step = key.start, key.stop, key.step or 1
            if start is None or stop is None:
                raise IndexError("memory slice assignment needs explicit bounds")
            if isinstance(start, BitVec):
                start = util.get_concrete_int(start)
            if isinstance(stop, BitVec):
                stop = util.get_concrete_int(stop)
            for i, byte_value in zip(range(start, stop, step), value):
                self[i] = byte_value
            return
        if isinstance(key, BitVec):
            key = util.get_concrete_int(key)
        if key >= len(self._memory):
            self.extend(key + 1 - len(self._memory))
        if isinstance(value, int):
            assert 0 <= value <= 0xFF
        if isinstance(value, BitVec):
            assert value.size == 8
        self._memory[key] = value

    def __copy__(self) -> "Memory":
        new = Memory()
        new._memory = self._memory[:]
        return new
