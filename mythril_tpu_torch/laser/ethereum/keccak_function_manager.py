"""Keccak modeling via uninterpreted function pairs (reference:
laser/ethereum/keccak_function_manager.py — semantics replicated so
finding parity holds; see the VerX paper for the interval relaxation).

keccak over a w-bit input is an uninterpreted function keccak256_w whose
range is confined to a per-width disjoint interval, spread to multiples
of 64 (array-slot hashing needs gaps), one-to-one via an explicit
inverse function.  Concrete inputs produce the real hash plus a
consistency condition tying the UF to it.  This keeps path constraints
inside QF_BV+UF, which our blaster Ackermannizes — no keccak circuit is
ever bit-blasted.
"""

from typing import Dict, List, Optional, Tuple

from mythril_tpu_torch.smt import (
    And,
    BitVec,
    Bool,
    Function,
    Or,
    ULE,
    ULT,
    URem,
    symbol_factory,
)
from mythril_tpu_torch.support.crypto import keccak256

TOTAL_PARTS = 10**40
PART = (2**256 - 1) // TOTAL_PARTS
INTERVAL_DIFFERENCE = 10**30
hash_matcher = "fffffff"  # concretized hashes carry this prefix in output


class KeccakFunctionManager:
    def __init__(self):
        self.store_function: Dict[int, Tuple[Function, Function]] = {}
        self.interval_hook_for_size: Dict[int, int] = {}
        self._index_counter = TOTAL_PARTS - 34534
        self.hash_result_store: Dict[int, List[BitVec]] = {}
        self.quick_inverse: Dict[BitVec, BitVec] = {}  # for the VMTests path
        self.concrete_hashes: Dict[BitVec, BitVec] = {}

    def reset(self) -> None:
        self.__init__()

    @staticmethod
    def find_concrete_keccak(data: BitVec) -> BitVec:
        digest = keccak256(data.value.to_bytes(data.size // 8, "big"))
        return symbol_factory.BitVecVal(int.from_bytes(digest, "big"), 256)

    def get_function(self, length: int) -> Tuple[Function, Function]:
        try:
            func, inverse = self.store_function[length]
        except KeyError:
            func = Function(f"keccak256_{length}", length, 256)
            inverse = Function(f"keccak256_{length}-1", 256, length)
            self.store_function[length] = (func, inverse)
            self.hash_result_store[length] = []
        return func, inverse

    @staticmethod
    def get_empty_keccak_hash() -> BitVec:
        return symbol_factory.BitVecVal(
            int.from_bytes(keccak256(b""), "big"), 256
        )

    def create_keccak(self, data: BitVec) -> Tuple[BitVec, Bool]:
        length = data.size
        func, inverse = self.get_function(length)
        if not data.symbolic:
            concrete_hash = self.find_concrete_keccak(data)
            self.concrete_hashes[data] = concrete_hash
            condition = And(
                func(data) == concrete_hash, inverse(func(data)) == data
            )
            return concrete_hash, condition
        condition = self._create_condition(func_input=data)
        self.hash_result_store[length].append(func(data))
        return func(data), condition

    def get_concrete_hash_data(self, model) -> Dict[int, List[Optional[int]]]:
        concrete_hashes: Dict[int, List[Optional[int]]] = {}
        for size, hashes in self.hash_result_store.items():
            concrete_hashes[size] = []
            for val in hashes:
                try:
                    concrete_hashes[size].append(
                        model.eval(val.raw, model_completion=True).as_long()
                    )
                except AttributeError:
                    continue
        return concrete_hashes

    def _create_condition(self, func_input: BitVec) -> Bool:
        length = func_input.size
        func, inv = self.get_function(length)
        try:
            index = self.interval_hook_for_size[length]
        except KeyError:
            self.interval_hook_for_size[length] = self._index_counter
            index = self._index_counter
            self._index_counter -= INTERVAL_DIFFERENCE

        lower_bound = index * PART
        upper_bound = lower_bound + PART

        application = func(func_input)
        cond = And(
            inv(application) == func_input,
            ULE(symbol_factory.BitVecVal(lower_bound, 256), application),
            ULT(application, symbol_factory.BitVecVal(upper_bound, 256)),
            URem(application, symbol_factory.BitVecVal(64, 256)) == 0,
        )
        concrete_cond = symbol_factory.BoolVal(False)
        for key, keccak in self.concrete_hashes.items():
            concrete_cond = Or(
                concrete_cond, And(application == keccak, key == func_input)
            )
        return And(inv(application) == func_input, Or(cond, concrete_cond))


keccak_function_manager = KeccakFunctionManager()
