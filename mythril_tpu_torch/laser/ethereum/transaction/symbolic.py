"""Symbolic transaction setup (reference: laser/ethereum/transaction/symbolic.py;
own copy of the JAX package's, without the dispatcher pre-split).

ACTORS defines the canonical creator/attacker/bystander addresses used
by the detection modules; each analysis transaction constrains the
symbolic sender to that set.
"""

import logging
from typing import Optional

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.ethereum.cfg import Node, Edge, JumpType
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.calldata import SymbolicCalldata
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    BaseTransaction,
    ContractCreationTransaction,
    MessageCallTransaction,
    get_next_transaction_id,
)
from mythril_tpu_torch.smt import BitVec, Or, symbol_factory
from mythril_tpu_torch.support.support_utils import Singleton

log = logging.getLogger(__name__)

CREATOR_ADDRESS = 0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE
ATTACKER_ADDRESS = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
SOMEGUY_ADDRESS = 0xAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA


class Actors(object, metaclass=Singleton):
    def __init__(
        self,
        creator=CREATOR_ADDRESS,
        attacker=ATTACKER_ADDRESS,
        someguy=SOMEGUY_ADDRESS,
    ):
        self.addresses = {
            "CREATOR": symbol_factory.BitVecVal(creator, 256),
            "ATTACKER": symbol_factory.BitVecVal(attacker, 256),
            "SOMEGUY": symbol_factory.BitVecVal(someguy, 256),
        }

    def __setitem__(self, actor: str, value: int):
        self.addresses[actor] = symbol_factory.BitVecVal(value, 256)

    def __getitem__(self, actor: str) -> BitVec:
        return self.addresses[actor]

    @property
    def creator(self) -> BitVec:
        return self.addresses["CREATOR"]

    @property
    def attacker(self) -> BitVec:
        return self.addresses["ATTACKER"]

    def __len__(self):
        return len(self.addresses)


ACTORS = Actors()


def generate_function_constraints(calldata, func_hashes):
    """Constrain calldata[0:4] to the analyzed function selectors."""
    if len(func_hashes) == 0:
        return []
    constraints = []
    from mythril_tpu_torch.smt import And, Concat

    selector = Concat(
        calldata[0], calldata[1], calldata[2], calldata[3]
    )
    condition = None
    for func_hash in func_hashes:
        if func_hash == -1:  # fallback function: calldata shorter than 4
            from mythril_tpu_torch.smt import ULT

            clause = ULT(calldata.calldatasize, 4)
        else:
            clause = selector == symbol_factory.BitVecVal(func_hash, 32)
        condition = clause if condition is None else Or(condition, clause)
    return [condition]


def execute_message_call(laser_evm, callee_address: BitVec) -> None:
    """Drain open states; fire a fresh symbolic transaction at each
    (reference symbolic.py:70)."""
    if isinstance(callee_address, int):
        callee_address = symbol_factory.BitVecVal(callee_address, 256)
    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]

    for open_world_state in open_states:
        if open_world_state[callee_address].deleted:
            log.debug("Can not execute dead contract, skipping.")
            continue

        next_transaction_id = get_next_transaction_id()
        external_sender = symbol_factory.BitVecSym(
            f"sender_{next_transaction_id}", 256
        )
        calldata = SymbolicCalldata(next_transaction_id)
        transaction = MessageCallTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=symbol_factory.BitVecSym(
                f"gas_price{next_transaction_id}", 256
            ),
            gas_limit=8_000_000,  # block gas limit
            origin=external_sender,
            caller=external_sender,
            callee_account=open_world_state[callee_address],
            call_data=calldata,
            call_value=symbol_factory.BitVecSym(
                f"call_value{next_transaction_id}", 256
            ),
        )
        _setup_global_state_for_execution(laser_evm, transaction)

    laser_evm.exec()


def _setup_global_state_for_execution(
    laser_evm, transaction: BaseTransaction
) -> None:
    """Seed the worklist with the transaction's initial state
    (reference symbolic.py:155)."""
    global_state = transaction.initial_global_state()
    global_state.transaction_stack.append((transaction, None))
    global_state.world_state.transaction_sequence.append(transaction)
    global_state.world_state.constraints.append(
        Or(*[transaction.caller == actor for actor in ACTORS.addresses.values()])
    )

    new_node = Node(
        global_state.environment.active_account.contract_name,
        function_name=global_state.environment.active_function_name,
    )
    if laser_evm.requires_statespace:
        laser_evm.nodes[new_node.uid] = new_node
    if transaction.world_state.node:
        if laser_evm.requires_statespace:
            laser_evm.edges.append(
                Edge(
                    transaction.world_state.node.uid,
                    new_node.uid,
                    edge_type=JumpType.Transaction,
                    condition=None,
                )
            )
        global_state.mstate.constraints = global_state.world_state.constraints
    new_node.states.append(global_state)
    global_state.node = new_node
    new_node.constraints = global_state.world_state.constraints

    # concrete-prefix dispatch (laser/ethereum/lockstep_dispatch.py): a
    # validated dispatcher prefix replaces the seed by per-selector states
    # positioned at the function entries
    split = None
    if isinstance(transaction, MessageCallTransaction) and isinstance(
        transaction.call_data, SymbolicCalldata
    ):
        from mythril_tpu_torch.laser.ethereum.lockstep_dispatch import (
            presplit_states,
        )

        split = presplit_states(global_state)
    if split:
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        for state, condition in split:
            laser_evm._new_node_state(state, JumpType.CONDITIONAL, condition)
            laser_evm.work_list.append(state)
        dispatch_stats.presplit_states += len(split)
    else:
        laser_evm.work_list.append(global_state)


def execute_contract_creation(
    laser_evm,
    contract_initialization_code,
    contract_name=None,
    world_state=None,
) -> Account:
    """Build and run the creation transaction (reference symbolic.py:111)."""
    world_state = world_state or WorldState()
    open_states = [world_state]
    del laser_evm.open_states[:]
    new_account = None
    for open_world_state in open_states:
        next_transaction_id = get_next_transaction_id()
        # constructor args are symbolic: code tail past the init code
        transaction = ContractCreationTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=symbol_factory.BitVecSym(
                f"gas_price{next_transaction_id}", 256
            ),
            gas_limit=8_000_000,
            origin=ACTORS["CREATOR"],
            code=Disassembly(contract_initialization_code),
            caller=ACTORS["CREATOR"],
            contract_name=contract_name,
            call_data=None,
            call_value=symbol_factory.BitVecSym(
                f"call_value{next_transaction_id}", 256
            ),
        )
        _setup_global_state_for_execution(laser_evm, transaction)
        new_account = new_account or transaction.callee_account
    laser_evm.exec(True)
    return new_account
