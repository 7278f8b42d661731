"""EVM instruction semantics over symbolic state (reference:
laser/ethereum/instructions.py, ~80 mutators).

Each opcode maps to a ``<name>_`` method on :class:`Instruction`;
``evaluate`` copies the incoming state (fork safety), runs plugin
pre-hooks, the mutator, then post-hooks.  CALL/CREATE raise
TransactionStartSignal; STOP/RETURN/REVERT/SUICIDE raise
TransactionEndSignal via the transaction object; ``<name>_post``
variants resume the caller frame after a nested call returns.
"""

import logging
from copy import copy, deepcopy
from typing import Callable, List, Optional, Union

from mythril_tpu_torch.disassembler.disassembly import Disassembly
from mythril_tpu_torch.laser.ethereum import util
from mythril_tpu_torch.laser.ethereum.call import (
    SYMBOLIC_CALLDATA_SIZE,
    get_call_data,
    get_call_parameters,
    insert_ret_val,
    native_call,
    transfer_ether,
)
from mythril_tpu_torch.laser.ethereum.evm_exceptions import (
    InvalidInstruction,
    InvalidJumpDestination,
    OutOfGasException,
    StackUnderflowException,
    VmException,
    WriteProtection,
)
from mythril_tpu_torch.laser.ethereum.keccak_function_manager import (
    keccak_function_manager,
)
from mythril_tpu_torch.laser.ethereum.state.calldata import (
    ConcreteCalldata,
    SymbolicCalldata,
)
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionStartSignal,
    get_next_transaction_id,
)
from mythril_tpu_torch.smt import (
    UGT,
    ULT,
    BitVec,
    Bool,
    Concat,
    Expression,
    Extract,
    If,
    LShR,
    Not,
    UDiv,
    URem,
    SRem,
    is_false,
    is_true,
    simplify,
    symbol_factory,
)
from mythril_tpu_torch.support.opcodes import (
    _LOG_DATA_MAX,
    calculate_sha3_gas,
    get_opcode_gas,
)
from mythril_tpu_torch.support.support_utils import get_code_hash

log = logging.getLogger(__name__)

TT256 = 2**256
TT256M1 = 2**256 - 1


class StateTransition:
    """Decorator: copy state, charge gas, enforce static-context write
    protection, auto-increment pc (reference: instructions.py:95)."""

    def __init__(
        self,
        increment_pc: bool = True,
        enable_gas: bool = True,
        is_state_mutation_instruction: bool = False,
    ):
        self.increment_pc = increment_pc
        self.enable_gas = enable_gas
        self.is_state_mutation_instruction = is_state_mutation_instruction

    @staticmethod
    def check_gas_usage_limit(global_state: GlobalState) -> None:
        global_state.mstate.check_gas()
        gas_limit = global_state.current_transaction.gas_limit
        if isinstance(gas_limit, BitVec):
            if gas_limit.value is None:
                return
            global_state.current_transaction.gas_limit = gas_limit.value
            gas_limit = gas_limit.value
        if gas_limit is not None and global_state.mstate.min_gas_used >= gas_limit:
            raise OutOfGasException()

    def accumulate_gas(self, global_state: GlobalState) -> GlobalState:
        if not self.enable_gas:
            return global_state
        opcode = global_state.instruction["opcode"]
        min_gas, max_gas = get_opcode_gas(opcode)
        global_state.mstate.min_gas_used += min_gas
        global_state.mstate.max_gas_used += max_gas
        self.check_gas_usage_limit(global_state)
        return global_state

    def __call__(self, func: Callable) -> Callable:
        def wrapper(
            func_obj: "Instruction", global_state: GlobalState
        ) -> List[GlobalState]:
            if (
                self.is_state_mutation_instruction
                and global_state.environment.static
            ):
                raise WriteProtection(
                    f"The function {func.__name__[:-1]} cannot be executed "
                    "in a static call"
                )
            new_global_states = func(func_obj, copy(global_state))
            new_global_states = [
                self.accumulate_gas(state) for state in new_global_states
            ]
            if self.increment_pc:
                for state in new_global_states:
                    state.mstate.pc += 1
            return new_global_states

        wrapper.__name__ = func.__name__
        # the symbolic lockstep tier (laser/ethereum/symbolic_lockstep)
        # drives the raw mutator itself — one state copy per SEGMENT
        # instead of one per opcode — and replays the decorator's
        # gas/pc bookkeeping from these attributes, so the two paths
        # can never drift
        wrapper.mutator = func
        wrapper.transition = self
        return wrapper


class Instruction:
    """Mutates a GlobalState according to one opcode."""

    def __init__(
        self,
        op_code: str,
        dynamic_loader,
        pre_hooks: Optional[List[Callable]] = None,
        post_hooks: Optional[List[Callable]] = None,
    ):
        self.dynamic_loader = dynamic_loader
        self.op_code = op_code.upper()
        self.pre_hook = pre_hooks or []
        self.post_hook = post_hooks or []

    def evaluate(self, global_state: GlobalState, post: bool = False) -> List[GlobalState]:
        op = self.op_code.lower()
        for prefix in ("push", "dup", "swap", "log"):
            if op.startswith(prefix):
                op = prefix
                break
        mutator = getattr(self, op + ("_post" if post else "_"), None)
        if mutator is None:
            raise NotImplementedError(self.op_code)
        for hook in self.pre_hook:
            hook(global_state)
        result = mutator(global_state)
        for hook in self.post_hook:
            for state in result:
                hook(state)
        return result

    # ------------------------------------------------------------------
    # stack / constants
    # ------------------------------------------------------------------

    @StateTransition()
    def push_(self, global_state: GlobalState) -> List[GlobalState]:
        instruction = global_state.get_current_instruction()
        push_value = int(instruction.get("argument", "0x0"), 16)
        length_of_value = 2 * int(self.op_code[4:])
        global_state.mstate.stack.append(
            symbol_factory.BitVecVal(push_value, 256)
        )
        return [global_state]

    @StateTransition()
    def dup_(self, global_state: GlobalState) -> List[GlobalState]:
        depth = int(self.op_code[3:])
        global_state.mstate.stack.append(global_state.mstate.stack[-depth])
        return [global_state]

    @StateTransition()
    def swap_(self, global_state: GlobalState) -> List[GlobalState]:
        depth = int(self.op_code[4:])
        stack = global_state.mstate.stack
        stack[-depth - 1], stack[-1] = stack[-1], stack[-depth - 1]
        return [global_state]

    @StateTransition()
    def pop_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.pop()
        return [global_state]

    # ------------------------------------------------------------------
    # arithmetic
    # ------------------------------------------------------------------

    @StateTransition()
    def add_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(util.pop_bitvec(s) + util.pop_bitvec(s))
        return [global_state]

    @StateTransition()
    def sub_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(util.pop_bitvec(s) - util.pop_bitvec(s))
        return [global_state]

    @StateTransition()
    def mul_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(util.pop_bitvec(s) * util.pop_bitvec(s))
        return [global_state]

    @StateTransition()
    def div_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        op0, op1 = util.pop_bitvec(s), util.pop_bitvec(s)
        if op1.value == 0:
            s.stack.append(symbol_factory.BitVecVal(0, 256))
        elif op1.value is not None:
            s.stack.append(UDiv(op0, op1))
        else:
            s.stack.append(
                If(op1 == 0, symbol_factory.BitVecVal(0, 256), UDiv(op0, op1))
            )
        return [global_state]

    @StateTransition()
    def sdiv_(self, global_state: GlobalState) -> List[GlobalState]:
        from mythril_tpu_torch.smt import SDiv

        s = global_state.mstate
        op0, op1 = util.pop_bitvec(s), util.pop_bitvec(s)
        if op1.value == 0:
            s.stack.append(symbol_factory.BitVecVal(0, 256))
        elif op1.value is not None:
            s.stack.append(SDiv(op0, op1))
        else:
            s.stack.append(
                If(op1 == 0, symbol_factory.BitVecVal(0, 256), SDiv(op0, op1))
            )
        return [global_state]

    @StateTransition()
    def mod_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        op0, op1 = util.pop_bitvec(s), util.pop_bitvec(s)
        if op1.value == 0:
            s.stack.append(symbol_factory.BitVecVal(0, 256))
        elif op1.value is not None:
            s.stack.append(URem(op0, op1))
        else:
            s.stack.append(
                If(op1 == 0, symbol_factory.BitVecVal(0, 256), URem(op0, op1))
            )
        return [global_state]

    @StateTransition()
    def smod_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        op0, op1 = util.pop_bitvec(s), util.pop_bitvec(s)
        if op1.value == 0:
            s.stack.append(symbol_factory.BitVecVal(0, 256))
        elif op1.value is not None:
            s.stack.append(SRem(op0, op1))
        else:
            s.stack.append(
                If(op1 == 0, symbol_factory.BitVecVal(0, 256), SRem(op0, op1))
            )
        return [global_state]

    @StateTransition()
    def addmod_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s0, s1, s2 = (
            util.pop_bitvec(s),
            util.pop_bitvec(s),
            util.pop_bitvec(s),
        )
        if s2.value == 0:
            s.stack.append(symbol_factory.BitVecVal(0, 256))
        elif None not in (s0.value, s1.value, s2.value):
            s.stack.append(
                symbol_factory.BitVecVal((s0.value + s1.value) % s2.value, 256)
            )
        else:
            result = URem(URem(s0, s2) + URem(s1, s2), s2)
            if s2.value is None:
                result = If(s2 == 0, symbol_factory.BitVecVal(0, 256), result)
            s.stack.append(result)
        return [global_state]

    @StateTransition()
    def mulmod_(self, global_state: GlobalState) -> List[GlobalState]:
        from mythril_tpu_torch.smt import Extract as _Extract, ZeroExt

        s = global_state.mstate
        s0, s1, s2 = (
            util.pop_bitvec(s),
            util.pop_bitvec(s),
            util.pop_bitvec(s),
        )
        if s2.value == 0:
            s.stack.append(symbol_factory.BitVecVal(0, 256))
        elif None not in (s0.value, s1.value, s2.value):
            s.stack.append(
                symbol_factory.BitVecVal((s0.value * s1.value) % s2.value, 256)
            )
        else:
            # full 512-bit product so the mod is exact
            wide = URem(ZeroExt(256, s0) * ZeroExt(256, s1), ZeroExt(256, s2))
            result = _Extract(255, 0, wide)
            if s2.value is None:
                result = If(s2 == 0, symbol_factory.BitVecVal(0, 256), result)
            s.stack.append(result)
        return [global_state]

    @StateTransition()
    def exp_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        base, exponent = util.pop_bitvec(state), util.pop_bitvec(state)
        if base.symbolic or exponent.symbolic:
            state.stack.append(
                global_state.new_bitvec(
                    f"invhash({hash(simplify(base))})**"
                    f"invhash({hash(simplify(exponent))})",
                    256,
                    base.annotations.union(exponent.annotations),
                )
            )
        else:
            state.stack.append(
                symbol_factory.BitVecVal(
                    pow(base.value, exponent.value, TT256),
                    256,
                    annotations=base.annotations.union(exponent.annotations),
                )
            )
        return [global_state]

    @StateTransition()
    def signextend_(self, global_state: GlobalState) -> List[GlobalState]:
        mstate = global_state.mstate
        s0, s1 = mstate.stack.pop(), mstate.stack.pop()
        try:
            s0 = util.get_concrete_int(s0)
        except TypeError:
            mstate.stack.append(
                global_state.new_bitvec(
                    f"SIGNEXTEND({hash(s0)},{hash(s1)})", 256
                )
            )
            return [global_state]
        s1 = util.to_bitvec(s1)
        if s0 <= 31:
            testbit = s0 * 8 + 7
            set_mask = symbol_factory.BitVecVal(TT256 - (1 << testbit), 256)
            clear_mask = symbol_factory.BitVecVal((1 << testbit) - 1, 256)
            if is_true(
                simplify(
                    (s1 & symbol_factory.BitVecVal(1 << testbit, 256)) == 0
                )
            ):
                mstate.stack.append(s1 & clear_mask)
            elif is_false(
                simplify(
                    (s1 & symbol_factory.BitVecVal(1 << testbit, 256)) == 0
                )
            ):
                mstate.stack.append(s1 | set_mask)
            else:
                mstate.stack.append(
                    If(
                        (s1 & symbol_factory.BitVecVal(1 << testbit, 256)) == 0,
                        s1 & clear_mask,
                        s1 | set_mask,
                    )
                )
        else:
            mstate.stack.append(s1)
        return [global_state]

    # ------------------------------------------------------------------
    # comparison & bitwise
    # ------------------------------------------------------------------

    @StateTransition()
    def lt_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(ULT(util.pop_bitvec(s), util.pop_bitvec(s)))
        return [global_state]

    @StateTransition()
    def gt_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(UGT(util.pop_bitvec(s), util.pop_bitvec(s)))
        return [global_state]

    @StateTransition()
    def slt_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(util.pop_bitvec(s) < util.pop_bitvec(s))
        return [global_state]

    @StateTransition()
    def sgt_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(util.pop_bitvec(s) > util.pop_bitvec(s))
        return [global_state]

    @StateTransition()
    def eq_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        op1, op2 = util.to_bitvec(s.stack.pop()), util.to_bitvec(s.stack.pop())
        s.stack.append(op1 == op2)
        return [global_state]

    @StateTransition()
    def iszero_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        val = s.stack.pop()
        exp = Not(val) if isinstance(val, Bool) else util.to_bitvec(val) == 0
        s.stack.append(
            simplify(
                If(
                    exp,
                    symbol_factory.BitVecVal(1, 256),
                    symbol_factory.BitVecVal(0, 256),
                )
            )
        )
        return [global_state]

    @StateTransition()
    def and_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(util.pop_bitvec(s) & util.pop_bitvec(s))
        return [global_state]

    @StateTransition()
    def or_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(util.pop_bitvec(s) | util.pop_bitvec(s))
        return [global_state]

    @StateTransition()
    def xor_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(util.pop_bitvec(s) ^ util.pop_bitvec(s))
        return [global_state]

    @StateTransition()
    def not_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        s.stack.append(TT256M1 - util.pop_bitvec(s))
        return [global_state]

    @StateTransition()
    def byte_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        op0, op1 = s.stack.pop(), s.stack.pop()
        if not isinstance(op1, Expression):
            op1 = symbol_factory.BitVecVal(op1, 256)
        try:
            index = util.get_concrete_int(op0)
            if index >= 32:
                s.stack.append(symbol_factory.BitVecVal(0, 256))
            else:
                offset = (31 - index) * 8
                s.stack.append(
                    Concat(
                        symbol_factory.BitVecVal(0, 248),
                        Extract(offset + 7, offset, op1),
                    )
                )
        except TypeError:
            s.stack.append(
                global_state.new_bitvec(
                    f"BYTE({hash(op0)},{hash(op1)})", 256
                )
            )
        return [global_state]

    @StateTransition()
    def shl_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        shift, value = util.pop_bitvec(s), util.pop_bitvec(s)
        s.stack.append(value << shift)
        return [global_state]

    @StateTransition()
    def shr_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        shift, value = util.pop_bitvec(s), util.pop_bitvec(s)
        s.stack.append(LShR(value, shift))
        return [global_state]

    @StateTransition()
    def sar_(self, global_state: GlobalState) -> List[GlobalState]:
        s = global_state.mstate
        shift, value = util.pop_bitvec(s), util.pop_bitvec(s)
        s.stack.append(value >> shift)
        return [global_state]

    # ------------------------------------------------------------------
    # sha3
    # ------------------------------------------------------------------

    @staticmethod
    def _sha3_gas_helper(global_state: GlobalState, length: int) -> GlobalState:
        min_gas, max_gas = calculate_sha3_gas(length)
        global_state.mstate.min_gas_used += min_gas
        global_state.mstate.max_gas_used += max_gas
        StateTransition.check_gas_usage_limit(global_state)
        return global_state

    @StateTransition(enable_gas=False)
    def sha3_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        index, op1 = state.stack.pop(), state.stack.pop()
        try:
            length = util.get_concrete_int(op1)
        except TypeError:
            # symbolic length: constrain it to a memorable constant
            length = 64
            global_state.world_state.constraints.append(
                util.to_bitvec(op1) == length
            )
        Instruction._sha3_gas_helper(global_state, length)
        state.mem_extend(index, length)
        data_list = [
            b if isinstance(b, BitVec) else symbol_factory.BitVecVal(b, 8)
            for b in state.memory[index : index + length]
        ]
        if len(data_list) > 1:
            data = simplify(Concat(data_list))
        elif len(data_list) == 1:
            data = data_list[0]
        else:
            state.stack.append(keccak_function_manager.get_empty_keccak_hash())
            return [global_state]
        result, condition = keccak_function_manager.create_keccak(data)
        state.stack.append(result)
        global_state.world_state.constraints.append(condition)
        return [global_state]

    # ------------------------------------------------------------------
    # environment
    # ------------------------------------------------------------------

    @StateTransition()
    def address_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.address)
        return [global_state]

    @StateTransition()
    def balance_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        address = util.pop_bitvec(state)
        if address.value is not None:
            balance = global_state.world_state.accounts_exist_or_load(
                "0x{:040x}".format(address.value), self.dynamic_loader
            ).balance()
        else:
            balance = symbol_factory.BitVecVal(0, 256)
            for account in global_state.world_state.accounts.values():
                balance = If(
                    address == account.address, account.balance(), balance
                )
        state.stack.append(balance)
        return [global_state]

    @StateTransition()
    def origin_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.origin)
        return [global_state]

    @StateTransition()
    def caller_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.sender)
        return [global_state]

    @StateTransition()
    def callvalue_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.callvalue)
        return [global_state]

    @StateTransition()
    def gasprice_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.gasprice)
        return [global_state]

    @StateTransition()
    def chainid_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.chainid)
        return [global_state]

    @StateTransition()
    def selfbalance_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.environment.active_account.balance()
        )
        return [global_state]

    @StateTransition()
    def calldataload_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        op0 = state.stack.pop()
        state.stack.append(
            global_state.environment.calldata.get_word_at(op0)
        )
        return [global_state]

    @StateTransition()
    def calldatasize_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        if isinstance(
            global_state.current_transaction, ContractCreationTransaction
        ):
            state.stack.append(0)
        else:
            state.stack.append(
                global_state.environment.calldata.calldatasize
            )
        return [global_state]

    @staticmethod
    def _calldata_copy_helper(global_state, mstate, mstart, dstart, size):
        environment = global_state.environment
        try:
            mstart = util.get_concrete_int(mstart)
        except TypeError:
            log.debug("Unsupported symbolic memory offset in CALLDATACOPY")
            return [global_state]
        try:
            dstart = util.get_concrete_int(dstart)
        except TypeError:
            dstart = simplify(util.to_bitvec(dstart))
        try:
            size = util.get_concrete_int(size)
        except TypeError:
            size = SYMBOLIC_CALLDATA_SIZE
        if size > 0:
            try:
                mstate.mem_extend(mstart, size)
            except TypeError:
                mstate.mem_extend(mstart, 1)
                mstate.memory[mstart] = global_state.new_bitvec(
                    f"calldata_{environment.active_account.contract_name}"
                    f"[{dstart}:+{size}]",
                    8,
                )
                return [global_state]
            try:
                index = dstart
                new_memory = []
                for i in range(size):
                    new_memory.append(environment.calldata[index])
                    index = (
                        index + 1
                        if isinstance(index, int)
                        else simplify(index + 1)
                    )
                for i, byte in enumerate(new_memory):
                    mstate.memory[mstart + i] = byte
            except (IndexError, ValueError):
                mstate.memory[mstart] = global_state.new_bitvec(
                    f"calldata_{environment.active_account.contract_name}"
                    f"[{dstart}:+{size}]",
                    8,
                )
        return [global_state]

    @StateTransition()
    def calldatacopy_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        op0, op1, op2 = state.stack.pop(), state.stack.pop(), state.stack.pop()
        if isinstance(
            global_state.current_transaction, ContractCreationTransaction
        ):
            log.debug("CALLDATACOPY in creation transaction not supported")
            return [global_state]
        return self._calldata_copy_helper(global_state, state, op0, op1, op2)

    @StateTransition()
    def codesize_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        environment = global_state.environment
        disassembly = environment.code
        calldata = environment.calldata
        no_of_bytes = len(disassembly.bytecode.removeprefix("0x")) // 2
        if isinstance(
            global_state.current_transaction, ContractCreationTransaction
        ):
            # creation code is followed by constructor arguments
            if isinstance(calldata, ConcreteCalldata):
                no_of_bytes += calldata.size
            else:
                no_of_bytes += 0x200  # space for 16 32-byte args
                global_state.world_state.constraints.append(
                    calldata.calldatasize == no_of_bytes
                )
        state.stack.append(no_of_bytes)
        return [global_state]

    @staticmethod
    def _code_copy_helper(
        code, memory_offset, code_offset, size, op, global_state
    ) -> List[GlobalState]:
        try:
            concrete_memory_offset = util.get_concrete_int(memory_offset)
        except TypeError:
            log.debug("Unsupported symbolic memory offset in %s", op)
            return [global_state]
        try:
            concrete_size = util.get_concrete_int(size)
            global_state.mstate.mem_extend(
                concrete_memory_offset, concrete_size
            )
        except TypeError:
            # except both attribute error and Exception
            global_state.mstate.mem_extend(concrete_memory_offset, 1)
            global_state.mstate.memory[
                concrete_memory_offset
            ] = global_state.new_bitvec(
                f"code({get_code_hash(code)[2:10]})", 8
            )
            return [global_state]
        try:
            concrete_code_offset = util.get_concrete_int(code_offset)
        except TypeError:
            log.debug("Unsupported symbolic code offset in %s", op)
            global_state.mstate.mem_extend(concrete_memory_offset, concrete_size)
            for i in range(concrete_size):
                global_state.mstate.memory[
                    concrete_memory_offset + i
                ] = global_state.new_bitvec(
                    f"code({get_code_hash(code)[2:10]})_{i}", 8
                )
            return [global_state]

        code_bytes = bytes.fromhex(code.removeprefix("0x"))
        for i in range(concrete_size):
            src = concrete_code_offset + i
            byte = code_bytes[src] if src < len(code_bytes) else 0
            global_state.mstate.memory[concrete_memory_offset + i] = byte
        return [global_state]

    @StateTransition()
    def codecopy_(self, global_state: GlobalState) -> List[GlobalState]:
        memory_offset, code_offset, size = (
            global_state.mstate.stack.pop(),
            global_state.mstate.stack.pop(),
            global_state.mstate.stack.pop(),
        )
        code = global_state.environment.code.bytecode.removeprefix("0x")
        code_size = len(code) // 2
        if isinstance(
            global_state.current_transaction, ContractCreationTransaction
        ):
            # Bytes past the creation code are constructor calldata
            mstate = global_state.mstate
            if isinstance(global_state.environment.calldata, SymbolicCalldata):
                try:
                    concrete_code_offset = util.get_concrete_int(code_offset)
                except TypeError:
                    concrete_code_offset = None
                if (
                    concrete_code_offset is not None
                    and concrete_code_offset >= code_size
                ):
                    return self._calldata_copy_helper(
                        global_state,
                        mstate,
                        memory_offset,
                        concrete_code_offset - code_size,
                        size,
                    )
            else:
                try:
                    concrete_code_offset = util.get_concrete_int(code_offset)
                    concrete_size = util.get_concrete_int(size)
                except TypeError:
                    concrete_code_offset, concrete_size = None, None
                if concrete_code_offset is not None:
                    code_copy_offset = concrete_code_offset
                    code_copy_size = max(
                        0,
                        min(
                            concrete_size,
                            code_size - concrete_code_offset,
                        ),
                    )
                    calldata_copy_offset = max(
                        0, concrete_code_offset - code_size
                    )
                    calldata_copy_size = max(
                        0, concrete_code_offset + concrete_size - code_size
                    )
                    [global_state] = self._code_copy_helper(
                        code=global_state.environment.code.bytecode,
                        memory_offset=memory_offset,
                        code_offset=code_copy_offset,
                        size=code_copy_size,
                        op="CODECOPY",
                        global_state=global_state,
                    )
                    return self._calldata_copy_helper(
                        global_state=global_state,
                        mstate=mstate,
                        mstart=memory_offset + code_copy_size,
                        dstart=calldata_copy_offset,
                        size=calldata_copy_size,
                    )
        return self._code_copy_helper(
            code=global_state.environment.code.bytecode,
            memory_offset=memory_offset,
            code_offset=code_offset,
            size=size,
            op="CODECOPY",
            global_state=global_state,
        )

    @StateTransition()
    def extcodesize_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        addr = state.stack.pop()
        try:
            addr = hex(util.get_concrete_int(addr))
        except TypeError:
            state.stack.append(
                global_state.new_bitvec(f"extcodesize_{addr}", 256)
            )
            return [global_state]
        try:
            code = global_state.world_state.accounts_exist_or_load(
                addr, self.dynamic_loader
            ).code.bytecode
        except (ValueError, AttributeError) as e:
            log.debug("error accessing contract storage due to: %s", e)
            state.stack.append(
                global_state.new_bitvec(f"extcodesize_{addr}", 256)
            )
            return [global_state]
        state.stack.append(len(code.removeprefix("0x")) // 2)
        return [global_state]

    @StateTransition()
    def extcodecopy_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        addr, memory_offset, code_offset, size = (
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
        )
        try:
            concrete_addr = hex(util.get_concrete_int(addr))
            code = global_state.world_state.accounts_exist_or_load(
                concrete_addr, self.dynamic_loader
            ).code.bytecode
        except (TypeError, ValueError, AttributeError) as e:
            log.debug("error in EXTCODECOPY: %s", e)
            try:
                concrete_memory_offset = util.get_concrete_int(memory_offset)
                concrete_size = util.get_concrete_int(size)
                state.mem_extend(concrete_memory_offset, concrete_size)
                for i in range(concrete_size):
                    state.memory[
                        concrete_memory_offset + i
                    ] = global_state.new_bitvec(f"extcode({addr})_{i}", 8)
            except TypeError:
                pass
            return [global_state]
        return self._code_copy_helper(
            code=code,
            memory_offset=memory_offset,
            code_offset=code_offset,
            size=size,
            op="EXTCODECOPY",
            global_state=global_state,
        )

    @StateTransition()
    def extcodehash_(self, global_state: GlobalState) -> List[GlobalState]:
        world_state = global_state.world_state
        stack = global_state.mstate.stack
        address = Extract(159, 0, util.to_bitvec(stack.pop()))
        if address.symbolic:
            stack.append(
                global_state.new_bitvec(f"extcodehash_{address}", 256)
            )
            return [global_state]
        if address.value not in world_state.accounts:
            stack.append(symbol_factory.BitVecVal(0, 256))
        else:
            code = world_state.accounts[address.value].code.bytecode
            stack.append(
                symbol_factory.BitVecVal(int(get_code_hash(code), 16), 256)
            )
        return [global_state]

    @StateTransition()
    def returndatasize_(self, global_state: GlobalState) -> List[GlobalState]:
        if global_state.last_return_data is None:
            global_state.mstate.stack.append(
                global_state.new_bitvec("returndatasize", 256)
            )
        else:
            global_state.mstate.stack.append(
                len(global_state.last_return_data)
            )
        return [global_state]

    @StateTransition()
    def returndatacopy_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        memory_offset, return_offset, size = (
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
        )
        if global_state.last_return_data is None:
            return [global_state]
        try:
            memory_offset = util.get_concrete_int(memory_offset)
            return_offset = util.get_concrete_int(return_offset)
            size = util.get_concrete_int(size)
        except TypeError:
            log.debug("Symbolic RETURNDATACOPY args not supported")
            return [global_state]
        state.mem_extend(memory_offset, size)
        for i in range(size):
            src = return_offset + i
            if src < len(global_state.last_return_data):
                state.memory[memory_offset + i] = global_state.last_return_data[
                    src
                ]
            else:
                state.memory[memory_offset + i] = 0
        return [global_state]

    # ------------------------------------------------------------------
    # block info
    # ------------------------------------------------------------------

    @StateTransition()
    def blockhash_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        blocknumber = state.stack.pop()
        state.stack.append(
            global_state.new_bitvec(f"blockhash_block_{blocknumber}", 256)
        )
        return [global_state]

    @StateTransition()
    def coinbase_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.new_bitvec("coinbase", 256)
        )
        return [global_state]

    @StateTransition()
    def timestamp_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.new_bitvec("timestamp", 256)
        )
        return [global_state]

    @StateTransition()
    def number_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.block_number)
        return [global_state]

    @StateTransition()
    def difficulty_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.new_bitvec("block_difficulty", 256)
        )
        return [global_state]

    @StateTransition()
    def gaslimit_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.mstate.gas_limit)
        return [global_state]

    # ------------------------------------------------------------------
    # memory / storage / flow
    # ------------------------------------------------------------------

    @staticmethod
    def _charge_memory_op(global_state, opcode: str, concrete: bool) -> None:
        """Exact-when-concrete gas for MLOAD/MSTORE/MSTORE8: with a
        concrete offset the expansion cost was already metered exactly by
        mem_extend, so the op itself costs its flat 3 (keeping the
        min==max interval tight — the GAS opcode concretizes only while
        the interval is tight, see gas_); a symbolic offset falls back to
        the table's bracketed upper bound."""
        state = global_state.mstate
        if concrete:
            state.min_gas_used += 3
            state.max_gas_used += 3
        else:
            min_gas, max_gas = get_opcode_gas(opcode)
            state.min_gas_used += min_gas
            state.max_gas_used += max_gas
        StateTransition.check_gas_usage_limit(global_state)

    @StateTransition(enable_gas=False)
    def mload_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        offset = state.stack.pop()
        state.mem_extend(offset, 32)
        try:
            concrete_offset = util.get_concrete_int(offset)
        except TypeError:
            self._charge_memory_op(global_state, "MLOAD", concrete=False)
            state.stack.append(
                global_state.new_bitvec(f"mload_{hash(offset)}", 256)
            )
            return [global_state]
        self._charge_memory_op(global_state, "MLOAD", concrete=True)
        state.stack.append(state.memory.get_word_at(concrete_offset))
        return [global_state]

    @StateTransition(enable_gas=False)
    def mstore_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        mstart, value = state.stack.pop(), state.stack.pop()
        try:
            state.mem_extend(mstart, 32)
            concrete_start = util.get_concrete_int(mstart)
        except TypeError:
            self._charge_memory_op(global_state, "MSTORE", concrete=False)
            log.debug("MSTORE with symbolic offset not supported")
            return [global_state]
        self._charge_memory_op(global_state, "MSTORE", concrete=True)
        state.memory.write_word_at(concrete_start, value)
        return [global_state]

    @StateTransition(enable_gas=False)
    def mstore8_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        offset, value = state.stack.pop(), state.stack.pop()
        try:
            state.mem_extend(offset, 1)
            concrete_offset = util.get_concrete_int(offset)
        except TypeError:
            self._charge_memory_op(global_state, "MSTORE8", concrete=False)
            log.debug("MSTORE8 with symbolic offset not supported")
            return [global_state]
        self._charge_memory_op(global_state, "MSTORE8", concrete=True)
        try:
            value_to_write = util.get_concrete_int(value) % 256
        except TypeError:
            value_to_write = Extract(7, 0, util.to_bitvec(value))
        state.memory[concrete_offset] = value_to_write
        return [global_state]

    @StateTransition(enable_gas=False)
    def sload_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        index = util.pop_bitvec(state)
        # Under exact gas tracking the conformance vectors are
        # frontier-era, where SLOAD costs 50 (it grew to 200/800/2100 in
        # later forks); the min bound must not exceed the era's actual
        # charge or the min<=used oracle fails.  Symbolic analyses keep
        # the table's Istanbul-era constant.
        from mythril_tpu_torch.support.support_args import args as _args

        min_gas, max_gas = get_opcode_gas("SLOAD")
        if getattr(_args, "exact_gas_tracking", False):
            min_gas = 50
        state.min_gas_used += min_gas
        state.max_gas_used += max_gas
        StateTransition.check_gas_usage_limit(global_state)
        state.stack.append(
            global_state.environment.active_account.storage[index]
        )
        return [global_state]

    @StateTransition(is_state_mutation_instruction=True, enable_gas=False)
    def sstore_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        index, value = util.pop_bitvec(state), state.stack.pop()
        storage = global_state.environment.active_account.storage
        new_value = util.to_bitvec(value)
        # Exact-when-known minimum: a zero -> nonzero write costs at
        # least SSTORE_SET (20000) in every fork from Frontier through
        # Berlin, so when the old and new values are both concrete the
        # 5000 table minimum is provably too low.  This is what makes
        # the out-of-gas VMTests (sstore_load_2 and friends) terminate
        # where the yellow paper says they must; the 25000 table maximum
        # stays as the symbolic-case bracket.
        min_gas, max_gas = get_opcode_gas("SSTORE")
        if index.value is not None and new_value.value is not None:
            old_value = storage[index]
            if (
                getattr(old_value, "value", None) is not None
                and old_value.value == 0
                and new_value.value != 0
            ):
                min_gas = 20000
        state.min_gas_used += min_gas
        state.max_gas_used += max_gas
        StateTransition.check_gas_usage_limit(global_state)
        storage[index] = new_value
        return [global_state]

    @StateTransition(increment_pc=False, enable_gas=False)
    def jump_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        disassembly = global_state.environment.code
        try:
            jump_addr = util.get_concrete_int(state.stack.pop())
        except TypeError:
            raise InvalidJumpDestination(
                "Invalid jump argument (symbolic address)"
            )
        index = util.get_instruction_index(
            disassembly.instruction_list, jump_addr
        )
        if index is None:
            raise InvalidJumpDestination("JUMP to invalid address")
        instr = disassembly.instruction_list[index]
        if instr.op_code != "JUMPDEST" or instr.address != jump_addr:
            raise InvalidJumpDestination(
                f"Skipping JUMP to invalid destination: {jump_addr}"
            )
        new_state = copy(global_state)
        min_gas, max_gas = get_opcode_gas("JUMP")
        new_state.mstate.min_gas_used += min_gas
        new_state.mstate.max_gas_used += max_gas
        new_state.mstate.pc = index
        new_state.mstate.depth += 1
        return [new_state]

    @StateTransition(increment_pc=False, enable_gas=False)
    def jumpi_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        disassembly = global_state.environment.code
        min_gas, max_gas = get_opcode_gas("JUMPI")
        states = []

        op0, condition = state.stack.pop(), state.stack.pop()
        try:
            jump_addr = util.get_concrete_int(op0)
        except TypeError:
            log.debug("Skipping JUMPI to invalid destination.")
            global_state.mstate.pc += 1
            global_state.mstate.min_gas_used += min_gas
            global_state.mstate.max_gas_used += max_gas
            return [global_state]

        if isinstance(condition, Bool):
            positive = simplify(condition)
            negated = simplify(Not(condition))
        else:
            condition_bv = util.to_bitvec(condition)
            positive = simplify(condition_bv != 0)
            negated = simplify(condition_bv == 0)

        if not is_false(negated):
            new_state = copy(global_state)
            new_state.mstate.min_gas_used += min_gas
            new_state.mstate.max_gas_used += max_gas
            new_state.mstate.depth += 1
            new_state.mstate.pc += 1
            new_state.world_state.constraints.append(negated)
            states.append(new_state)
        else:
            log.debug("Pruned unreachable false-branch state.")

        index = util.get_instruction_index(
            disassembly.instruction_list, jump_addr
        )
        if index is None:
            log.debug("Invalid jump destination: %s", jump_addr)
            return states
        dest = disassembly.instruction_list[index]
        if dest.op_code == "JUMPDEST" and dest.address == jump_addr:
            if not is_false(positive):
                new_state = copy(global_state)
                new_state.mstate.min_gas_used += min_gas
                new_state.mstate.max_gas_used += max_gas
                new_state.mstate.pc = index
                new_state.mstate.depth += 1
                new_state.world_state.constraints.append(positive)
                states.append(new_state)
            else:
                log.debug("Pruned unreachable true-branch state.")
        return states

    @StateTransition()
    def jumpdest_(self, global_state: GlobalState) -> List[GlobalState]:
        return [global_state]

    @StateTransition()
    def pc_(self, global_state: GlobalState) -> List[GlobalState]:
        index = global_state.mstate.pc
        program_counter = global_state.environment.code.instruction_list[
            index
        ].address
        global_state.mstate.stack.append(program_counter)
        return [global_state]

    @StateTransition()
    def msize_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.mstate.memory_size)
        return [global_state]

    @StateTransition()
    def gas_(self, global_state: GlobalState) -> List[GlobalState]:
        # Under exact gas tracking (concolic conformance runs — see
        # transaction/concolic.py) the remaining gas is exactly known
        # whenever the min/max interval is still tight: push the
        # concrete value (GAS itself costs 2, charged by the decorator
        # after this handler).  Symbolic analyses keep the fresh symbol
        # the reference pushes (evm_test gas0/gas1 are the consumers).
        state = global_state.mstate
        from mythril_tpu_torch.support.support_args import args as _args

        tx_gas_limit = global_state.current_transaction.gas_limit
        if isinstance(tx_gas_limit, BitVec):
            tx_gas_limit = tx_gas_limit.value
        if (
            getattr(_args, "exact_gas_tracking", False)
            and state.min_gas_used == state.max_gas_used
            and isinstance(tx_gas_limit, int)
        ):
            remaining = tx_gas_limit - state.min_gas_used - 2
            if remaining >= 0:
                state.stack.append(
                    symbol_factory.BitVecVal(remaining, 256)
                )
                return [global_state]
        state.stack.append(global_state.new_bitvec("gas", 256))
        return [global_state]

    @StateTransition(is_state_mutation_instruction=True)
    def log_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        topic_count = int(self.op_code[3:])
        offset = state.stack.pop()
        size = state.stack.pop()
        for _ in range(topic_count):
            state.stack.pop()
        # event logs are not modeled, but the memory expansion and the
        # per-byte data gas are real: LOG with a huge offset must halt
        # out-of-gas (VMTests log1MemExp, skipped by the reference)
        state.mem_extend(offset, size)
        size_value = size.value if hasattr(size, "value") else size
        if size_value is not None:
            # the opcode table's LOG max already brackets data gas with
            # an 8*32 stand-in (opcodes.py _LOG_DATA_MAX); replace it
            # with the exact amount rather than stacking on top
            state.min_gas_used += 8 * size_value
            state.max_gas_used += 8 * size_value - _LOG_DATA_MAX
            state.check_gas()
        return [global_state]

    # ------------------------------------------------------------------
    # create
    # ------------------------------------------------------------------

    def _create_transaction_helper(
        self, global_state, call_value, mem_offset, mem_size, create2_salt=None
    ) -> List[GlobalState]:
        mstate = global_state.mstate
        environment = global_state.environment
        world_state = global_state.world_state

        call_data = get_call_data(global_state, mem_offset, mem_offset + mem_size)

        code_raw = []
        code_end = call_data.size
        size = call_data.size
        if isinstance(size, BitVec):
            size = 10**5 if size.symbolic else size.value
        for i in range(size):
            if call_data[i].symbolic:
                code_end = i
                break
            code_raw.append(call_data[i].value)

        if len(code_raw) < 1:
            global_state.mstate.stack.append(1)
            log.debug("No code found for the create-type instruction.")
            return [global_state]

        code_str = bytes(code_raw).hex()
        next_transaction_id = get_next_transaction_id()
        constructor_arguments = ConcreteCalldata(
            next_transaction_id, call_data[code_end:]
        )
        code = Disassembly(code_str)

        caller = environment.active_account.address
        gas_price = environment.gasprice
        origin = environment.origin

        contract_address: Union[int, None] = None
        Instruction._sha3_gas_helper(global_state, len(code_str) // 2)

        if create2_salt is not None:
            create2_salt = util.to_bitvec(create2_salt)
            if create2_salt.symbolic:
                if create2_salt.size != 256:
                    pad = symbol_factory.BitVecVal(
                        0, 256 - create2_salt.size
                    )
                    create2_salt = Concat(pad, create2_salt)
                address, constraint = keccak_function_manager.create_keccak(
                    Concat(
                        symbol_factory.BitVecVal(255, 8),
                        caller,
                        create2_salt,
                        symbol_factory.BitVecVal(
                            int(get_code_hash(code_str), 16), 256
                        ),
                    )
                )
                # CREATE2 address = low 160 bits of the hash
                global_state.world_state.constraints.append(constraint)
                contract_address = None  # symbolic address unsupported: fresh
            else:
                salt = f"{create2_salt.value:064x}"
                addr = f"{caller.value:040x}"
                contract_address = int(
                    get_code_hash(
                        "0xff" + addr + salt + get_code_hash(code_str)[2:]
                    )[26:],
                    16,
                )
        transaction = ContractCreationTransaction(
            world_state=world_state,
            caller=caller,
            code=code,
            call_data=constructor_arguments,
            gas_price=gas_price,
            gas_limit=mstate.gas_limit,
            origin=origin,
            call_value=call_value,
            contract_address=contract_address,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition(is_state_mutation_instruction=True)
    def create_(self, global_state: GlobalState) -> List[GlobalState]:
        call_value, mem_offset, mem_size = global_state.mstate.pop(3)
        return self._create_transaction_helper(
            global_state, call_value, mem_offset, mem_size
        )

    @StateTransition()
    def create_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._handle_create_type_post(global_state)

    @StateTransition(is_state_mutation_instruction=True)
    def create2_(self, global_state: GlobalState) -> List[GlobalState]:
        call_value, mem_offset, mem_size, salt = global_state.mstate.pop(4)
        return self._create_transaction_helper(
            global_state, call_value, mem_offset, mem_size, salt
        )

    @StateTransition()
    def create2_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._handle_create_type_post(global_state, opcode="create2")

    @staticmethod
    def _handle_create_type_post(global_state, opcode="create"):
        if opcode == "create2":
            global_state.mstate.pop(4)
        else:
            global_state.mstate.pop(3)
        if global_state.last_return_data:
            return_val = symbol_factory.BitVecVal(
                int(global_state.last_return_data, 16), 256
            )
        else:
            return_val = symbol_factory.BitVecVal(0, 256)
        global_state.mstate.stack.append(return_val)
        return [global_state]

    # ------------------------------------------------------------------
    # halting
    # ------------------------------------------------------------------

    @StateTransition()
    def return_(self, global_state: GlobalState):
        state = global_state.mstate
        offset, length = state.stack.pop(), state.stack.pop()
        if isinstance(length, BitVec) and length.symbolic:
            return_data = [global_state.new_bitvec("return_data", 8)]
            log.debug("Return with symbolic length or offset not supported")
        else:
            state.mem_extend(offset, length)
            StateTransition.check_gas_usage_limit(global_state)
            length_value = (
                length.value if isinstance(length, BitVec) else length
            )
            try:
                offset_value = util.get_concrete_int(offset)
                return_data = state.memory[
                    offset_value : offset_value + length_value
                ]
            except TypeError:
                return_data = [global_state.new_bitvec("return_data", 8)]
        global_state.current_transaction.end(global_state, return_data)

    @StateTransition(is_state_mutation_instruction=True)
    def suicide_(self, global_state: GlobalState):
        target = util.pop_bitvec(global_state.mstate)
        transfer_amount = global_state.environment.active_account.balance()
        global_state.world_state.balances[target] += transfer_amount
        global_state.environment.active_account = deepcopy(
            global_state.environment.active_account
        )
        global_state.accounts[
            global_state.environment.active_account.address.value
        ] = global_state.environment.active_account
        global_state.environment.active_account.set_balance(0)
        global_state.environment.active_account.deleted = True
        global_state.current_transaction.end(global_state)

    @StateTransition()
    def revert_(self, global_state: GlobalState) -> None:
        state = global_state.mstate
        offset, length = state.stack.pop(), state.stack.pop()
        return_data = [global_state.new_bitvec("return_data", 8)]
        try:
            start = util.get_concrete_int(offset)
            size = util.get_concrete_int(length)
            return_data = state.memory[start : start + size]
        except TypeError:
            log.debug("Revert with symbolic length or offset not supported")
        global_state.current_transaction.end(
            global_state, return_data=return_data, revert=True
        )

    @StateTransition()
    def assert_fail_(self, global_state: GlobalState):
        raise InvalidInstruction

    @StateTransition()
    def invalid_(self, global_state: GlobalState):
        raise InvalidInstruction

    @StateTransition()
    def stop_(self, global_state: GlobalState):
        global_state.current_transaction.end(global_state)

    # ------------------------------------------------------------------
    # calls
    # ------------------------------------------------------------------

    @staticmethod
    def _write_symbolic_returndata(
        global_state: GlobalState, memory_out_offset, memory_out_size
    ) -> None:
        memory_out_offset = util.to_bitvec(memory_out_offset)
        memory_out_size = util.to_bitvec(memory_out_size)
        if memory_out_offset.symbolic or memory_out_size.symbolic:
            return
        for i in range(memory_out_size.value):
            global_state.mstate.memory[
                memory_out_offset.value + i
            ] = global_state.new_bitvec(
                f"call_output_var({memory_out_offset.value + i})"
                f"_{global_state.mstate.pc}",
                8,
            )

    def _append_fresh_retval(self, global_state: GlobalState) -> None:
        instr = global_state.get_current_instruction()
        global_state.mstate.stack.append(
            global_state.new_bitvec("retval_" + str(instr["address"]), 256)
        )

    @StateTransition()
    def call_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        environment = global_state.environment
        memory_out_size, memory_out_offset = global_state.mstate.stack[-7:-5]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(global_state, self.dynamic_loader, True)

            if (
                callee_account is not None
                and callee_account.code.bytecode in ("", "0x")
            ):
                log.debug("plain ether transfer between accounts")
                transfer_ether(
                    global_state,
                    environment.active_account.address,
                    callee_account.address,
                    value,
                )
                self._append_fresh_retval(global_state)
                return [global_state]
        except ValueError as e:
            log.debug("Could not determine call parameters: %s", e)
            self._write_symbolic_returndata(
                global_state, memory_out_offset, memory_out_size
            )
            self._append_fresh_retval(global_state)
            return [global_state]

        if environment.static:
            if isinstance(value, int) and value > 0:
                raise WriteProtection(
                    "Cannot call with non zero value in a static call"
                )
            if isinstance(value, BitVec):
                if value.symbolic:
                    global_state.world_state.constraints.append(
                        value == symbol_factory.BitVecVal(0, 256)
                    )
                elif value.value > 0:
                    raise WriteProtection(
                        "Cannot call with non zero value in a static call"
                    )

        native_result = native_call(
            global_state,
            callee_address,
            call_data,
            memory_out_offset,
            memory_out_size,
        )
        if native_result:
            return native_result

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            caller=environment.active_account.address,
            callee_account=callee_account,
            call_data=call_data,
            call_value=value,
            static=environment.static,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition()
    def call_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="call")

    @StateTransition()
    def callcode_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        environment = global_state.environment
        memory_out_size, memory_out_offset = global_state.mstate.stack[-7:-5]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                _,
                _,
            ) = get_call_parameters(global_state, self.dynamic_loader, True)
            if (
                callee_account is not None
                and callee_account.code.bytecode in ("", "0x")
            ):
                transfer_ether(
                    global_state,
                    environment.active_account.address,
                    callee_account.address,
                    value,
                )
                self._append_fresh_retval(global_state)
                return [global_state]
        except ValueError as e:
            log.debug("Could not determine call parameters: %s", e)
            self._write_symbolic_returndata(
                global_state, memory_out_offset, memory_out_size
            )
            self._append_fresh_retval(global_state)
            return [global_state]

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            code=callee_account.code,
            caller=environment.address,
            callee_account=environment.active_account,
            call_data=call_data,
            call_value=value,
            static=environment.static,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition()
    def callcode_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="callcode")

    @StateTransition()
    def delegatecall_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        environment = global_state.environment
        memory_out_size, memory_out_offset = global_state.mstate.stack[-6:-4]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                _,
                gas,
                _,
                _,
            ) = get_call_parameters(global_state, self.dynamic_loader)
            if (
                callee_account is not None
                and callee_account.code.bytecode in ("", "0x")
            ):
                self._append_fresh_retval(global_state)
                return [global_state]
        except ValueError as e:
            log.debug("Could not determine call parameters: %s", e)
            self._write_symbolic_returndata(
                global_state, memory_out_offset, memory_out_size
            )
            self._append_fresh_retval(global_state)
            return [global_state]

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            code=callee_account.code,
            caller=environment.sender,
            callee_account=environment.active_account,
            call_data=call_data,
            call_value=environment.callvalue,
            static=environment.static,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition()
    def delegatecall_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="delegatecall")

    @StateTransition()
    def staticcall_(self, global_state: GlobalState) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        environment = global_state.environment
        memory_out_size, memory_out_offset = global_state.mstate.stack[-6:-4]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(global_state, self.dynamic_loader)
            if (
                callee_account is not None
                and callee_account.code.bytecode in ("", "0x")
            ):
                self._append_fresh_retval(global_state)
                return [global_state]
        except ValueError as e:
            log.debug("Could not determine call parameters: %s", e)
            self._write_symbolic_returndata(
                global_state, memory_out_offset, memory_out_size
            )
            self._append_fresh_retval(global_state)
            return [global_state]

        native_result = native_call(
            global_state,
            callee_address,
            call_data,
            memory_out_offset,
            memory_out_size,
        )
        if native_result:
            return native_result

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            code=callee_account.code,
            caller=environment.address,
            callee_account=callee_account,
            call_data=call_data,
            call_value=0,
            static=True,
        )
        raise TransactionStartSignal(transaction, self.op_code, global_state)

    @StateTransition()
    def staticcall_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="staticcall")

    def post_handler(self, global_state, function_name: str) -> List[GlobalState]:
        instr = global_state.get_current_instruction()
        with_value = function_name not in ("staticcall", "delegatecall")
        try:
            (
                callee_address,
                _,
                _,
                value,
                _,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(
                global_state, self.dynamic_loader, with_value
            )
        except ValueError as e:
            log.debug("Could not determine call parameters (post): %s", e)
            self._append_fresh_retval(global_state)
            return [global_state]

        if global_state.last_return_data is None:
            return_value = global_state.new_bitvec(
                "retval_" + str(instr["address"]), 256
            )
            global_state.mstate.stack.append(return_value)
            self._write_symbolic_returndata(
                global_state, memory_out_offset, memory_out_size
            )
            global_state.world_state.constraints.append(return_value == 0)
            return [global_state]

        try:
            memory_out_offset = util.get_concrete_int(memory_out_offset)
            memory_out_size = util.get_concrete_int(memory_out_size)
        except TypeError:
            self._append_fresh_retval(global_state)
            return [global_state]

        copy_size = min(memory_out_size, len(global_state.last_return_data))
        global_state.mstate.mem_extend(memory_out_offset, copy_size)
        for i in range(copy_size):
            global_state.mstate.memory[
                i + memory_out_offset
            ] = global_state.last_return_data[i]

        return_value = global_state.new_bitvec(
            "retval_" + str(instr["address"]), 256
        )
        global_state.mstate.stack.append(return_value)
        global_state.world_state.constraints.append(return_value == 1)
        return [global_state]
