"""Call-parameter extraction for CALL-family opcodes (reference:
laser/ethereum/call.py).

One behavioral upgrade over the reference: symbolic callee addresses
that are reads of the active account's own storage are recognized
*structurally* on the term DAG (the reference regex-matched
``Storage[(\\d+)]`` against the z3 string representation, call.py:103).
"""

import logging
from typing import List, Optional, Union

from mythril_tpu_torch.laser.ethereum import natives, util
from mythril_tpu_torch.laser.ethereum.state.account import Account
from mythril_tpu_torch.laser.ethereum.state.calldata import (
    BaseCalldata,
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.smt import BitVec, Expression, If, simplify, symbol_factory
from mythril_tpu_torch.smt import terms as T
from mythril_tpu_torch.support.opcodes import GSTIPEND, calculate_native_gas

log = logging.getLogger(__name__)

SYMBOLIC_CALLDATA_SIZE = 320  # bytes copied when calldata size is symbolic


def get_call_parameters(
    global_state: GlobalState, dynamic_loader, with_value: bool = False
):
    """Pop and resolve the 6/7 stack arguments of a CALL-family opcode."""
    gas, to = global_state.mstate.pop(2)
    value = global_state.mstate.pop() if with_value else 0
    (
        memory_input_offset,
        memory_input_size,
        memory_out_offset,
        memory_out_size,
    ) = global_state.mstate.pop(4)

    callee_address = get_callee_address(global_state, dynamic_loader, to)

    callee_account = None
    call_data = get_call_data(global_state, memory_input_offset, memory_input_size)
    if isinstance(callee_address, BitVec) or (
        isinstance(callee_address, str)
        and (
            int(callee_address, 16) > natives.PRECOMPILE_COUNT
            or int(callee_address, 16) == 0
        )
    ):
        callee_account = get_callee_account(
            global_state, callee_address, dynamic_loader
        )

    gas = util.to_bitvec(gas)
    gas = gas + If(
        util.to_bitvec(value) > 0,
        symbol_factory.BitVecVal(GSTIPEND, gas.size),
        symbol_factory.BitVecVal(0, gas.size),
    )
    return (
        callee_address,
        callee_account,
        call_data,
        value,
        gas,
        memory_out_offset,
        memory_out_size,
    )


def _storage_index_of(global_state: GlobalState, address: BitVec) -> Optional[int]:
    """If ``address`` is Storage[<const>] of the active account, return
    the constant index."""
    node = address.raw
    if node.op != "select":
        return None
    base, idx = node.args
    while base.op == "store":
        base = base.args[0]
    if base.op != "avar" or not base.params[0].startswith("Storage"):
        return None
    return idx.value  # None if symbolic


def get_callee_address(
    global_state: GlobalState, dynamic_loader, symbolic_to_address: Expression
):
    environment = global_state.environment
    try:
        return "0x{:040x}".format(util.get_concrete_int(symbolic_to_address))
    except TypeError:
        log.debug("Symbolic call encountered")

    index = _storage_index_of(global_state, simplify(symbolic_to_address))
    if index is None or dynamic_loader is None:
        return symbolic_to_address
    log.debug("Dynamic contract address at storage index %d", index)
    try:
        callee_address = dynamic_loader.read_storage(
            "0x{:040x}".format(environment.active_account.address.value), index
        )
    except Exception:
        return symbolic_to_address
    if len(callee_address) > 42:
        callee_address = "0x" + callee_address[-40:]
    return callee_address


def get_callee_account(
    global_state: GlobalState,
    callee_address: Union[str, BitVec],
    dynamic_loader,
) -> Account:
    if isinstance(callee_address, BitVec):
        if callee_address.symbolic:
            return Account(
                callee_address, balances=global_state.world_state.balances
            )
        callee_address = "0x{:040x}".format(callee_address.value)
    return global_state.world_state.accounts_exist_or_load(
        callee_address, dynamic_loader
    )


def get_call_data(
    global_state: GlobalState,
    memory_start: Union[int, BitVec],
    memory_size: Union[int, BitVec],
) -> BaseCalldata:
    state = global_state.mstate
    transaction_id = f"{global_state.current_transaction.id}_internalcall"

    if isinstance(memory_size, BitVec) and memory_size.symbolic:
        memory_size = SYMBOLIC_CALLDATA_SIZE
    try:
        start = util.get_concrete_int(memory_start)
        size = util.get_concrete_int(memory_size)
        calldata_from_mem = state.memory[start : start + size]
        return ConcreteCalldata(transaction_id, calldata_from_mem)
    except TypeError:
        log.debug(
            "Unsupported symbolic memory offset %s size %s",
            memory_start,
            memory_size,
        )
        return SymbolicCalldata(transaction_id)


def insert_ret_val(global_state: GlobalState) -> None:
    retval = global_state.new_bitvec(
        "retval_" + str(global_state.get_current_instruction()["address"]), 256
    )
    global_state.mstate.stack.append(retval)
    global_state.world_state.constraints.append(retval == 1)


def transfer_ether(
    global_state: GlobalState,
    sender: BitVec,
    receiver: BitVec,
    value: Union[int, BitVec],
) -> None:
    """Moves value with a feasibility constraint on the sender balance
    (reference: instructions.py transfer_ether)."""
    value = (
        value
        if isinstance(value, BitVec)
        else symbol_factory.BitVecVal(value, 256)
    )
    from mythril_tpu_torch.smt import UGE

    global_state.world_state.constraints.append(
        UGE(global_state.world_state.balances[sender], value)
    )
    global_state.world_state.balances[receiver] += value
    global_state.world_state.balances[sender] -= value


def native_call(
    global_state: GlobalState,
    callee_address: Union[str, BitVec],
    call_data: BaseCalldata,
    memory_out_offset: Union[int, Expression],
    memory_out_size: Union[int, Expression],
) -> Optional[List[GlobalState]]:
    if (
        isinstance(callee_address, BitVec)
        or not 0 < int(callee_address, 16) <= natives.PRECOMPILE_COUNT
    ):
        return None

    log.debug("Native contract called: %s", callee_address)
    try:
        mem_out_start = util.get_concrete_int(memory_out_offset)
        mem_out_sz = util.get_concrete_int(memory_out_size)
    except TypeError:
        log.debug("CALL with symbolic out offset/size not supported")
        return [global_state]

    contract_index = int(callee_address, 16)
    contract_name = natives.PRECOMPILE_FUNCTIONS[contract_index - 1].__name__
    gas_min, gas_max = calculate_native_gas(
        global_state.mstate.calculate_extension_size(mem_out_start, mem_out_sz),
        contract_name,
    )
    global_state.mstate.min_gas_used += gas_min
    global_state.mstate.max_gas_used += gas_max
    global_state.mstate.mem_extend(mem_out_start, mem_out_sz)

    try:
        data = natives.native_contracts(contract_index, call_data)
    except natives.NativeContractException:
        for i in range(mem_out_sz):
            global_state.mstate.memory[
                mem_out_start + i
            ] = global_state.new_bitvec(
                f"{contract_name}({call_data.tx_id})_{i}", 8
            )
        insert_ret_val(global_state)
        return [global_state]

    for i in range(min(len(data), mem_out_sz)):
        global_state.mstate.memory[mem_out_start + i] = data[i]
    insert_ret_val(global_state)
    return [global_state]
