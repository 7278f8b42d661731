"""Exploit concretization: path constraints -> concrete transaction
sequence (reference: mythril/analysis/solver.py).

``get_transaction_sequence`` adds minimization objectives (calldata
size, call value) and balance-sanity bounds, obtains a model through the
memoized solver funnel, materializes per-transaction concrete inputs,
and post-processes interval-relaxed keccak placeholders back into real
hashes so printed exploits are replayable.
"""

import logging
from typing import Dict, List, Tuple, Union

from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.keccak_function_manager import (
    hash_matcher,
    keccak_function_manager,
)
from mythril_tpu_torch.laser.ethereum.state.constraints import Constraints
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction import BaseTransaction
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.smt import UGE, symbol_factory
from mythril_tpu_torch.support.model import get_model  # noqa: F401  (re-exported)

log = logging.getLogger(__name__)


def pretty_print_model(model) -> str:
    env = model._merged()
    lines = []
    for node_id, value in sorted(env.variables.items()):
        lines.append(f"v{node_id}: {hex(value) if isinstance(value, int) else value}")
    return "\n".join(lines)


def get_transaction_sequence(
    global_state: GlobalState, constraints: Constraints
) -> Dict:
    """Generate a concrete transaction sequence or raise UnsatError."""
    transaction_sequence = global_state.world_state.transaction_sequence

    tx_constraints, minimize = _set_minimisation_constraints(
        transaction_sequence,
        constraints.copy(),
        [],
        5000,
        global_state.world_state,
    )
    model = get_model(tuple(tx_constraints), minimize=tuple(minimize))

    concrete_transactions = []
    for transaction in transaction_sequence:
        concrete_transactions.append(_get_concrete_transaction(model, transaction))

    initial_world_state = transaction_sequence[0].world_state
    initial_accounts = initial_world_state.accounts
    min_price_dict: Dict[int, int] = {}
    for address in initial_accounts.keys():
        min_price_dict[address] = model.eval(
            initial_world_state.starting_balances[
                symbol_factory.BitVecVal(address, 256)
            ],
            model_completion=True,
        ).as_long()

    concrete_initial_state = _get_concrete_state(initial_accounts, min_price_dict)
    if isinstance(transaction_sequence[0], ContractCreationTransaction):
        code = transaction_sequence[0].code
        _replace_with_actual_sha(concrete_transactions, model, code)
    else:
        _replace_with_actual_sha(concrete_transactions, model)
    _add_calldata_placeholder(concrete_transactions, transaction_sequence)
    return {"initialState": concrete_initial_state, "steps": concrete_transactions}


def _add_calldata_placeholder(
    concrete_transactions: List[Dict[str, str]],
    transaction_sequence: List[BaseTransaction],
) -> None:
    for tx in concrete_transactions:
        tx["calldata"] = tx["input"]
    if not isinstance(transaction_sequence[0], ContractCreationTransaction):
        return
    code_len = len(transaction_sequence[0].code.bytecode.removeprefix("0x"))
    concrete_transactions[0]["calldata"] = concrete_transactions[0]["input"][
        code_len + 2 :
    ]


def _replace_with_actual_sha(
    concrete_transactions: List[Dict[str, str]], model, code=None
) -> None:
    """Rewrite interval-placeholder hashes (prefix 'fffffff') in tx input
    back to the true keccak of the model's preimage."""
    concrete_hashes = keccak_function_manager.get_concrete_hash_data(model)
    for tx in concrete_transactions:
        if hash_matcher not in tx["input"]:
            continue
        if code is not None and code.bytecode in tx["input"]:
            s_index = len(code.bytecode) + 2
        else:
            s_index = 10
        for i in range(s_index, len(tx["input"])):
            data_slice = tx["input"][i : i + 64]
            if hash_matcher not in data_slice or len(data_slice) != 64:
                continue
            find_input = symbol_factory.BitVecVal(int(data_slice, 16), 256)
            input_ = None
            for size in concrete_hashes:
                if find_input.value not in concrete_hashes[size]:
                    continue
                _, inverse = keccak_function_manager.store_function[size]
                input_ = symbol_factory.BitVecVal(
                    model.eval(inverse(find_input), model_completion=True).as_long(),
                    size,
                )
            if input_ is None:
                continue
            keccak = keccak_function_manager.find_concrete_keccak(input_)
            hex_keccak = f"{keccak.value:064x}"
            tx["input"] = tx["input"][:s_index] + tx["input"][s_index:].replace(
                tx["input"][i : 64 + i], hex_keccak
            )


def _get_concrete_state(
    initial_accounts: Dict, min_price_dict: Dict[int, int]
) -> Dict:
    accounts = {}
    for address, account in initial_accounts.items():
        accounts[hex(address)] = {
            "nonce": account.nonce,
            "code": account.code.bytecode,
            "storage": str(account.storage),
            "balance": hex(min_price_dict.get(address, 0)),
        }
    return {"accounts": accounts}


def _get_concrete_transaction(model, transaction: BaseTransaction) -> Dict[str, str]:
    address = hex(transaction.callee_account.address.value)
    value = model.eval(transaction.call_value, model_completion=True).as_long()
    caller = "0x" + "{:x}".format(
        model.eval(transaction.caller, model_completion=True).as_long()
    ).zfill(40)

    input_ = ""
    if isinstance(transaction, ContractCreationTransaction):
        address = ""
        input_ += transaction.code.bytecode.removeprefix("0x")
    input_ += "".join(
        f"{b:02x}" for b in transaction.call_data.concrete(model)
    )

    return {
        "input": "0x" + input_,
        "value": "0x%x" % value,
        "origin": caller,
        "address": address,
    }


def _set_minimisation_constraints(
    transaction_sequence, constraints, minimize, max_size, world_state
) -> Tuple[Constraints, tuple]:
    """Bound calldata sizes and balances, and mark calldata size +
    callvalue of every transaction for minimization."""
    for transaction in transaction_sequence:
        max_calldata_size = symbol_factory.BitVecVal(max_size, 256)
        constraints.append(
            UGE(max_calldata_size, transaction.call_data.calldatasize)
        )
        minimize.append(transaction.call_data.calldatasize)
        minimize.append(transaction.call_value)
        constraints.append(
            UGE(
                symbol_factory.BitVecVal(1000000000000000000000, 256),
                world_state.starting_balances[transaction.caller],
            )
        )
    for account in world_state.accounts.values():
        constraints.append(
            UGE(
                symbol_factory.BitVecVal(100000000000000000000, 256),
                world_state.starting_balances[account.address],
            )
        )
    return constraints, tuple(minimize)
