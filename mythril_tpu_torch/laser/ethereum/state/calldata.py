"""Calldata models (reference: laser/ethereum/state/calldata.py).

- ConcreteCalldata: fixed byte list, backed by a constant array with
  stores so symbolic indexing still works.
- SymbolicCalldata: unconstrained content + symbolic calldatasize;
  out-of-bounds reads yield 0 via If(i < size, data[i], 0).
- Basic* variants avoid array terms (used by the concolic/VMTests path).

``concrete(model)`` materializes exploit transaction data from a model.
"""

from typing import Any, List, Optional, Union

from mythril_tpu_torch.laser.ethereum.util import get_concrete_int
from mythril_tpu_torch.smt import (
    Array,
    BitVec,
    Concat,
    Extract,
    If,
    K,
    simplify,
    symbol_factory,
)


class BaseCalldata:
    def __init__(self, tx_id: str):
        self.tx_id = tx_id

    @property
    def calldatasize(self) -> BitVec:
        result = self.size
        if isinstance(result, int):
            return symbol_factory.BitVecVal(result, 256)
        return result

    def get_word_at(self, offset: Union[int, BitVec]) -> BitVec:
        # Read byte-wise rather than via a slice: a huge offset makes
        # offset+32 wrap mod 2^256 and a slice would come out empty,
        # whereas the EVM semantics is 32 zero-padded reads.
        if isinstance(offset, BitVec) and offset.value is not None:
            offset = offset.value
        if isinstance(offset, int):
            # indices are unbounded in the spec; anything beyond any
            # realizable calldata size reads as zero (and must NOT wrap
            # through the 256-bit masking of the term layer)
            parts = [
                symbol_factory.BitVecVal(0, 8)
                if offset + i >= 2**64
                else self._load(offset + i)
                for i in range(32)
            ]
        else:
            parts = [self._load(simplify(offset + i)) for i in range(32)]
        return simplify(Concat(parts))

    def __getitem__(self, item: Union[int, slice, BitVec]) -> Any:
        if isinstance(item, int) or (isinstance(item, BitVec) and not item.symbolic):
            return self._load(item)
        if isinstance(item, slice):
            start = 0 if item.start is None else item.start
            step = 1 if item.step is None else item.step
            stop = self.size if item.stop is None else item.stop
            try:
                current_index = (
                    start
                    if isinstance(start, BitVec)
                    else symbol_factory.BitVecVal(start, 256)
                )
                parts = []
                if isinstance(stop, BitVec) and stop.symbolic:
                    stop = get_concrete_int(stop)  # raises TypeError
                else:
                    stop = stop.value if isinstance(stop, BitVec) else stop
                size = stop - (
                    current_index.value
                    if current_index.value is not None
                    else start
                )
                for i in range(0, size, step):
                    parts.append(self._load(current_index))
                    current_index = simplify(current_index + step)
            except TypeError:
                raise ValueError("Invalid calldata slice")
            return parts
        if isinstance(item, BitVec):
            return self._load(item)
        raise ValueError(f"invalid calldata index {item}")

    def _load(self, item: Union[int, BitVec]) -> Any:
        raise NotImplementedError

    @property
    def size(self) -> Union[BitVec, int]:
        raise NotImplementedError

    def concrete(self, model) -> list:
        raise NotImplementedError


class ConcreteCalldata(BaseCalldata):
    def __init__(self, tx_id: str, calldata: list):
        self._concrete_calldata = [
            b if isinstance(b, int) else b for b in calldata
        ]
        self._calldata = K(256, 8, 0)
        for i, element in enumerate(calldata):
            element = (
                symbol_factory.BitVecVal(element, 8)
                if isinstance(element, int)
                else element
            )
            self._calldata[symbol_factory.BitVecVal(i, 256)] = element
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> BitVec:
        if isinstance(item, int):
            # calldata offsets are naturals in the yellow paper (μs[1]+i
            # does NOT wrap at 2^256): an out-of-range read is zero.
            # Converting through BitVecVal first would truncate mod
            # 2^256 and alias huge offsets back onto real data
            # (calldatacopy_DataIndexTooHigh reads d[2^256-6 .. +249]
            # and must see zeros, not a wrapped copy of the calldata).
            if item >= len(self._concrete_calldata):
                return symbol_factory.BitVecVal(0, 8)
            item = symbol_factory.BitVecVal(item, 256)
        return simplify(self._calldata[item])

    @property
    def size(self) -> int:
        return len(self._concrete_calldata)

    def concrete(self, model) -> list:
        result = []
        for b in self._concrete_calldata:
            if isinstance(b, int):
                result.append(b)
            elif b.value is not None:
                result.append(b.value)
            elif model is not None:
                result.append(model.eval(b, model_completion=True).as_long())
            else:
                result.append(b)  # symbolic, no model: pass through
        return result


class BasicConcreteCalldata(BaseCalldata):
    def __init__(self, tx_id: str, calldata: list):
        self._calldata = list(calldata)
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> Any:
        if isinstance(item, int):
            try:
                return self._calldata[item]
            except IndexError:
                return 0
        value = symbol_factory.BitVecVal(0x0, 8)
        for i in range(self.size):
            value = If(
                item == i,
                self._calldata[i]
                if isinstance(self._calldata[i], BitVec)
                else symbol_factory.BitVecVal(self._calldata[i], 8),
                value,
            )
        return value

    @property
    def size(self) -> int:
        return len(self._calldata)

    def concrete(self, model) -> list:
        return list(self._calldata)


class SymbolicCalldata(BaseCalldata):
    def __init__(self, tx_id: str):
        self._size = symbol_factory.BitVecSym(f"{tx_id}_calldatasize", 256)
        self._calldata = Array(f"{tx_id}_calldata", 256, 8)
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec]) -> Any:
        item = (
            symbol_factory.BitVecVal(item, 256) if isinstance(item, int) else item
        )
        return simplify(
            If(
                item < self._size,
                simplify(self._calldata[item]),
                symbol_factory.BitVecVal(0, 8),
            )
        )

    @property
    def size(self) -> BitVec:
        return self._size

    def concrete(self, model) -> list:
        concrete_length = model.eval(self.size, model_completion=True).as_long()
        result = []
        for i in range(concrete_length):
            value = self._load(i)
            c_value = model.eval(value, model_completion=True).as_long()
            result.append(c_value)
        return result


class BasicSymbolicCalldata(BaseCalldata):
    def __init__(self, tx_id: str):
        self._reads: List = []
        self._size = symbol_factory.BitVecSym(f"{tx_id}_calldatasize", 256)
        super().__init__(tx_id)

    def _load(self, item: Union[int, BitVec], clean: bool = False) -> Any:
        expr_item = (
            symbol_factory.BitVecVal(item, 256) if isinstance(item, int) else item
        )
        symbolic_base_value = If(
            expr_item >= self._size,
            symbol_factory.BitVecVal(0, 8),
            symbol_factory.BitVecSym(
                f"{self.tx_id}_calldata_{str(item)}", 8
            ),
        )
        return_value = symbolic_base_value
        for stored_item, stored_value in self._reads:
            return_value = If(stored_item == expr_item, stored_value, return_value)
        if not clean:
            self._reads.append((expr_item, symbolic_base_value))
        return simplify(return_value)

    @property
    def size(self) -> BitVec:
        return self._size

    def concrete(self, model) -> list:
        concrete_length = model.eval(self.size, model_completion=True).as_long()
        return [
            model.eval(self._load(i, clean=True), model_completion=True).as_long()
            for i in range(concrete_length)
        ]
