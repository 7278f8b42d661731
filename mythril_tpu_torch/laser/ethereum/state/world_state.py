"""World state: accounts, balances, inter-transaction frontier node
(reference: laser/ethereum/state/world_state.py)."""

from copy import copy
from random import randint
from typing import Any, Dict, List, Optional, Union

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints
from mythril_tpu_torch.smt import Array, BitVec, symbol_factory


class WorldState:
    def __init__(
        self,
        transaction_sequence: Optional[List] = None,
        annotations: Optional[List[StateAnnotation]] = None,
    ):
        self._accounts: Dict[int, Account] = {}
        self.balances = Array("balance", 256, 256)
        self.starting_balances = copy(self.balances)
        self.constraints = Constraints()
        self.node = None  # CFG node of the end of the producing transaction
        self.transaction_sequence = transaction_sequence or []
        self._annotations = annotations or []

    @property
    def accounts(self) -> Dict[int, Account]:
        return self._accounts

    def __getitem__(self, item: BitVec) -> Account:
        """Accessing a non-existent account auto-creates it (the
        reference does the same so symbolic callees always resolve)."""
        try:
            return self._accounts[item.value]
        except KeyError:
            new_account = Account(
                address=item, code=None, balances=self.balances
            )
            self.put_account(new_account)
            return new_account

    def __copy__(self) -> "WorldState":
        new_annotations = [copy(a) for a in self._annotations]
        new_world_state = WorldState(
            transaction_sequence=self.transaction_sequence[:],
            annotations=new_annotations,
        )
        new_world_state.balances = copy(self.balances)
        new_world_state.starting_balances = copy(self.starting_balances)
        for account in self._accounts.values():
            new_account = copy(account)
            new_account._balances = new_world_state.balances
            new_account.balance = lambda acc=new_account: acc._balances[acc.address]
            new_world_state.put_account(new_account)
        new_world_state.constraints = copy(self.constraints)
        new_world_state.node = self.node
        return new_world_state

    def accounts_exist_or_load(self, addr: str, dynamic_loader) -> Account:
        """Load an account from chain data on first touch (reference
        world_state.py:76)."""
        addr_bitvec = symbol_factory.BitVecVal(int(addr, 16), 256)
        if addr_bitvec.value in self._accounts:
            return self._accounts[addr_bitvec.value]
        if dynamic_loader is None or not getattr(dynamic_loader, "active", False):
            return self[addr_bitvec]
        balance = None
        try:
            balance = dynamic_loader.read_balance(addr)
        except ValueError:
            pass
        code = None
        try:
            code = dynamic_loader.dynld(addr)
        except ValueError:
            pass
        account = self.create_account(
            balance=0,
            address=addr_bitvec.value,
            dynamic_loader=dynamic_loader,
            code=code,
        )
        if balance is not None:
            account.set_balance(symbol_factory.BitVecVal(balance, 256))
        return account

    def create_account(
        self,
        balance: Union[int, BitVec] = 0,
        address: Optional[int] = None,
        concrete_storage: bool = False,
        dynamic_loader=None,
        creator: Optional[int] = None,
        code: Optional[Disassembly] = None,
        nonce: int = 0,
    ) -> Account:
        address = (
            symbol_factory.BitVecVal(address, 256)
            if address is not None
            else self._generate_new_address(creator)
        )
        new_account = Account(
            address=address,
            balances=self.balances,
            dynamic_loader=dynamic_loader,
            concrete_storage=concrete_storage,
            code=code,
            nonce=nonce,
        )
        if balance is not None:
            new_account.set_balance(balance)
        self.put_account(new_account)
        return new_account

    def put_account(self, account: Account) -> None:
        assert account.address.value is not None
        self._accounts[account.address.value] = account
        account._balances = self.balances

    def _generate_new_address(self, creator: Optional[int] = None) -> BitVec:
        if creator is not None:
            # mk_contract_address without RLP precision: hash(creator||nonce)
            from mythril_tpu_torch.support.crypto import keccak256

            nonce = self._accounts[creator].nonce if creator in self._accounts else 0
            payload = creator.to_bytes(20, "big") + nonce.to_bytes(8, "big")
            address = int.from_bytes(keccak256(payload)[12:], "big")
            return symbol_factory.BitVecVal(address, 256)
        while True:
            address = randint(0, 2**160 - 1)
            if address not in self._accounts:
                return symbol_factory.BitVecVal(address, 256)

    def annotate(self, annotation: StateAnnotation) -> None:
        self._annotations.append(annotation)

    @property
    def annotations(self) -> List[StateAnnotation]:
        return self._annotations

    def get_annotations(self, annotation_type: type):
        return filter(
            lambda x: isinstance(x, annotation_type), self._annotations
        )
