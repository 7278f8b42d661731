"""Accounts and storage (reference: laser/ethereum/state/account.py).

Storage defaults: contracts created during analysis get fully-concrete
zero storage (K array); pre-existing contracts get an unconstrained
symbolic Array.  Concrete key reads may be served lazily from the chain
through a DynLoader when on-chain data is enabled; ``printable_storage``
mirrors accesses for report output.
"""

import logging
from copy import copy, deepcopy
from typing import Any, Dict, Union

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.smt import Array, BitVec, K, simplify, symbol_factory
from mythril_tpu_torch.support.support_args import args

log = logging.getLogger(__name__)


class Storage:
    def __init__(
        self, concrete: bool = False, address: BitVec = None, dynamic_loader=None
    ):
        if concrete:
            self._standard_storage = K(256, 256, 0)
        else:
            self._standard_storage = Array(f"Storage{address}", 256, 256)
        self._concrete = concrete
        self.printable_storage: Dict[BitVec, BitVec] = {}
        self.dynld = dynamic_loader
        self.storage_keys_loaded = set()
        self.address = address

    def __getitem__(self, item: BitVec) -> BitVec:
        storage = self._standard_storage
        if (
            self.address is not None
            and self.address.value is not None
            and self.address.value != 0
            and item.value is not None
            and (self.dynld and self.dynld.active)
            and item.value not in self.storage_keys_loaded
            and not args.unconstrained_storage
        ):
            try:
                onchain = self.dynld.read_storage(
                    contract_address="0x{:040x}".format(self.address.value),
                    index=item.value,
                )
                value = symbol_factory.BitVecVal(int(onchain, 16), 256)
                storage[item] = value
                self.storage_keys_loaded.add(item.value)
                self.printable_storage[item] = value
            except ValueError as e:
                log.debug("Couldn't read storage at %s: %s", item, e)
        return simplify(storage[item])

    def __setitem__(self, key: BitVec, value: Any) -> None:
        self.printable_storage[key] = value
        self._standard_storage[key] = value
        if key.value is not None:
            self.storage_keys_loaded.add(key.value)

    def __deepcopy__(self, memo) -> "Storage":
        concrete = isinstance(self._standard_storage, K)
        storage = Storage(
            concrete=concrete, address=self.address, dynamic_loader=self.dynld
        )
        storage._standard_storage = copy(self._standard_storage)
        storage._standard_storage.node = self._standard_storage.node
        storage.printable_storage = copy(self.printable_storage)
        storage.storage_keys_loaded = copy(self.storage_keys_loaded)
        return storage

    def __str__(self) -> str:
        return str(self.printable_storage)


class Account:
    """Contract or EOA state: nonce, code, storage, balance-closure."""

    def __init__(
        self,
        address: Union[BitVec, str],
        code: Disassembly = None,
        contract_name: str = None,
        balances: Array = None,
        concrete_storage: bool = False,
        dynamic_loader=None,
        nonce: int = 0,
    ):
        self.nonce = nonce
        self.code = code or Disassembly("")
        self.address = (
            address
            if isinstance(address, BitVec)
            else symbol_factory.BitVecVal(int(address, 16), 256)
        )
        self.storage = Storage(
            concrete_storage, address=self.address, dynamic_loader=dynamic_loader
        )
        self.contract_name = contract_name or "Unknown"
        self.deleted = False
        self._balances = balances
        self.balance = lambda: self._balances[self.address]

    def __str__(self) -> str:
        return str(self.as_dict)

    def set_balance(self, balance: Union[int, BitVec]) -> None:
        balance = (
            symbol_factory.BitVecVal(balance, 256)
            if isinstance(balance, int)
            else balance
        )
        assert self._balances is not None
        self._balances[self.address] = balance

    def add_balance(self, balance: Union[int, BitVec]) -> None:
        balance = (
            symbol_factory.BitVecVal(balance, 256)
            if isinstance(balance, int)
            else balance
        )
        self._balances[self.address] = self._balances[self.address] + balance

    @property
    def serialised_code(self) -> str:
        return self.code.bytecode

    @property
    def as_dict(self) -> Dict:
        return {
            "nonce": self.nonce,
            "code": self.code,
            "balance": self.balance(),
            "storage": self.storage,
        }

    def __copy__(self, memodict={}):
        new_account = Account(
            address=self.address,
            code=self.code,
            contract_name=self.contract_name,
            balances=self._balances,
            nonce=self.nonce,
        )
        new_account.storage = deepcopy(self.storage)
        new_account.code = self.code
        new_account.deleted = self.deleted
        return new_account
