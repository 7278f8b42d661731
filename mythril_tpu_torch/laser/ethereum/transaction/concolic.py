"""Concolic (concrete-calldata) execution path, used by the VMTests
conformance harness (reference: laser/ethereum/transaction/concolic.py)."""

from typing import List, Union

from mythril_tpu_torch.laser.ethereum.cfg import Edge, JumpType, Node
from mythril_tpu_torch.laser.ethereum.state.calldata import ConcreteCalldata
from mythril_tpu_torch.laser.ethereum.state.world_state import WorldState
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    MessageCallTransaction,
    get_next_transaction_id,
)
from mythril_tpu_torch.smt import symbol_factory


def execute_message_call(
    laser_evm,
    callee_address,
    caller_address,
    origin_address,
    code,
    data,
    gas_limit,
    gas_price,
    value,
    track_gas: bool = False,
    block_number: Union[int, None] = None,
):
    """Run one concrete message call (the conformance oracle entry).

    ``block_number`` concretizes NUMBER for this call: conformance
    vectors (ethereum/tests VMTests ``env.currentNumber``) compute jump
    targets from it, which a symbolic block number cannot resolve —
    the reference harness skips those tests
    (reference evm_test.py:33-60); with this hook they pass.
    """
    from mythril_tpu_torch.support.support_args import args as _args

    open_states = laser_evm.open_states[:]
    del laser_evm.open_states[:]
    for open_world_state in open_states:
        next_transaction_id = get_next_transaction_id()
        transaction = MessageCallTransaction(
            world_state=open_world_state,
            identifier=next_transaction_id,
            gas_price=gas_price,
            gas_limit=gas_limit,
            origin=origin_address,
            code=code,
            caller=caller_address,
            callee_account=open_world_state[callee_address],
            call_data=ConcreteCalldata(next_transaction_id, data),
            call_value=value,
        )
        _setup_global_state_for_execution(
            laser_evm, transaction, block_number=block_number
        )
    # exact-gas mode lets the GAS opcode concretize while the metering
    # interval is tight (gas0/gas1 conformance); scoped with try/finally
    # so a symbolic analysis later in the same process never sees it
    prior = getattr(_args, "exact_gas_tracking", False)
    _args.exact_gas_tracking = bool(track_gas)
    try:
        return laser_evm.exec(track_gas=track_gas)
    finally:
        _args.exact_gas_tracking = prior


def _setup_global_state_for_execution(
    laser_evm, transaction, block_number=None
) -> None:
    global_state = transaction.initial_global_state()
    if block_number is not None:
        global_state.environment.block_number = symbol_factory.BitVecVal(
            block_number, 256
        )
    global_state.transaction_stack.append((transaction, None))
    global_state.world_state.transaction_sequence.append(transaction)
    new_node = Node(global_state.environment.active_account.contract_name)
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
    global_state.node = new_node
    new_node.states.append(global_state)
    laser_evm.work_list.append(global_state)
