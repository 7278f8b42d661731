"""Transaction models and VM control signals.

Capability parity target: reference
laser/ethereum/transaction/transaction_models.py (tx objects carrying
caller/calldata/value, signals for frame start/end, creation-code
assignment on RETURN).  The design here is spec-table driven rather
than a field-by-field port: every per-transaction symbol a transaction
may need is declared once in ``_SYMBOLIC_FIELDS`` and materialized
lazily per transaction id, which keeps symbol naming uniform with the
batched solver's term interning (one ``{name}{txid}`` variable per
lane, shared across forked states).
"""

import itertools
import logging
from copy import deepcopy
from typing import Optional

from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.calldata import (
    BaseCalldata,
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.laser.ethereum.state.environment import Environment
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.smt import UGE, BitVec, symbol_factory

log = logging.getLogger(__name__)

_tx_counter = itertools.count(1)


def get_next_transaction_id() -> str:
    return str(next(_tx_counter))


def reset_transaction_ids() -> None:
    global _tx_counter
    _tx_counter = itertools.count(1)


# per-transaction symbols, created only when the caller didn't pin one
_SYMBOLIC_FIELDS = {
    "gas_price": "gasprice",
    "origin": "origin",
    "call_value": "call_value",
}


class TransactionStartSignal(Exception):
    """A CALL/CREATE family opcode opened a nested frame; the VM driver
    (svm.execute_state) pushes the callee onto the transaction stack."""

    def __init__(self, transaction, op_code: str, global_state: GlobalState):
        self.transaction = transaction
        self.op_code = op_code
        self.global_state = global_state


class TransactionEndSignal(Exception):
    """The active frame halted (STOP/RETURN/REVERT/fault); ``revert``
    tells the driver whether world-state effects roll back."""

    def __init__(self, global_state: GlobalState, revert: bool = False):
        self.global_state = global_state
        self.revert = revert


class BaseTransaction:
    """Shared shape of message calls and creations.

    Fields left as ``None`` default to fresh per-tx symbols (see
    ``_SYMBOLIC_FIELDS``); calldata defaults to fully symbolic unless
    ``init_call_data`` is disabled (CREATE-family frames pass the
    in-memory bytes instead)."""

    def __init__(
        self,
        world_state: WorldState,
        callee_account: Optional[Account] = None,
        caller: Optional[BitVec] = None,
        call_data: Optional[BaseCalldata] = None,
        identifier: Optional[str] = None,
        gas_price=None,
        gas_limit=None,
        origin=None,
        code=None,
        call_value=None,
        init_call_data: bool = True,
        static: bool = False,
        base_fee=None,
    ):
        assert isinstance(world_state, WorldState)
        self.world_state = world_state
        self.id = identifier or get_next_transaction_id()
        self.caller = caller
        self.callee_account = callee_account
        self.gas_limit = gas_limit
        self.code = code
        self.static = static
        self.return_data: Optional[str] = None

        pinned = {
            "gas_price": gas_price,
            "origin": origin,
            "call_value": call_value,
        }
        for field, stem in _SYMBOLIC_FIELDS.items():
            value = pinned[field]
            if value is None:
                value = symbol_factory.BitVecSym(f"{stem}{self.id}", 256)
            setattr(self, field, value)

        if isinstance(call_data, BaseCalldata):
            self.call_data: BaseCalldata = call_data
        elif init_call_data and call_data is None:
            self.call_data = SymbolicCalldata(self.id)
        else:
            self.call_data = ConcreteCalldata(self.id, [])

    # -- frame setup ----------------------------------------------------

    def _frame_environment(self) -> Environment:
        raise NotImplementedError

    def _entry_function(self) -> str:
        raise NotImplementedError

    def initial_global_state(self) -> GlobalState:
        """Build the frame's entry state and settle the value transfer
        against the shared balances array (UGE guard on the sender, the
        same shape the batched prune sees for every lane)."""
        env = self._frame_environment()
        state = GlobalState(self.world_state, env, None, transaction_stack=[])
        state.environment.active_function_name = self._entry_function()

        value = env.callvalue
        if not isinstance(value, BitVec):
            value = symbol_factory.BitVecVal(value, 256)
        balances = state.world_state.balances
        state.world_state.constraints.append(
            UGE(balances[env.sender], value)
        )
        balances[env.active_account.address] += value
        balances[env.sender] -= value
        return state

    def __str__(self) -> str:
        return (
            f"{type(self).__name__}(id={self.id}, caller={self.caller}, "
            f"callee={self.callee_account})"
        )


class MessageCallTransaction(BaseTransaction):
    """A call into an existing account's runtime code."""

    def _frame_environment(self) -> Environment:
        return Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            code=self.code or self.callee_account.code,
            static=self.static,
        )

    def _entry_function(self) -> str:
        return "fallback"

    def end(self, global_state: GlobalState, return_data=None, revert=False) -> None:
        self.return_data = return_data
        raise TransactionEndSignal(global_state, revert)


class ContractCreationTransaction(BaseTransaction):
    """Runs creation bytecode; RETURN's payload becomes the runtime
    code of the account created in the (snapshotted) world state."""

    def __init__(
        self,
        world_state: WorldState,
        caller: Optional[BitVec] = None,
        call_data: Optional[BaseCalldata] = None,
        identifier: Optional[str] = None,
        gas_price=None,
        gas_limit=None,
        origin=None,
        code=None,
        call_value=None,
        contract_name=None,
        contract_address=None,
    ):
        # snapshot for post-pass inspection (what the world looked like
        # before this deployment)
        self.prev_world_state = deepcopy(world_state)
        new_account = world_state.create_account(
            0,
            concrete_storage=True,
            creator=caller.value,
            address=contract_address
            if isinstance(contract_address, int)
            else None,
        )
        if contract_name:
            new_account.contract_name = contract_name
        # Constructor arguments ride as symbolic calldata spliced past
        # the end of the init code by codecopy/codesize/calldatasize
        # (same modeling as the reference, transaction_models.py:208).
        super().__init__(
            world_state=world_state,
            callee_account=new_account,
            caller=caller,
            call_data=call_data,
            identifier=identifier,
            gas_price=gas_price,
            gas_limit=gas_limit,
            origin=origin,
            code=code,
            call_value=call_value,
            init_call_data=True,
        )

    def _frame_environment(self) -> Environment:
        return Environment(
            self.callee_account,
            self.caller,
            self.call_data,
            self.gas_price,
            self.call_value,
            self.origin,
            self.code,
        )

    def _entry_function(self) -> str:
        return "constructor"

    def end(self, global_state: GlobalState, return_data=None, revert=False):
        deployed = None
        if return_data:
            try:
                deployed = bytes(return_data)
            except (TypeError, ValueError):
                deployed = None
        if deployed is None:
            self.return_data = None
            raise TransactionEndSignal(global_state, revert)

        account = global_state.environment.active_account
        account.code.assign_bytecode(deployed)
        assert account.code.instruction_list != []
        self.return_data = str(account.address)
        raise TransactionEndSignal(global_state, revert)
