"""Concrete-prefix dispatcher pre-split (own copy of
``mythril_tpu/laser/ethereum/lockstep_dispatch.py``).

The dispatcher prefix of a canonical contract is pure calldata logic, so
its branch structure is the same for every open state and every
transaction: one selector a function entry, plus a fallback.  Before
symbolic execution starts, each transaction seed is split by selector:

1. **match**: the instruction list against the canonical shape
   (``PUSH 0; CALLDATALOAD; PUSH 0xE0; SHR``, then ``DUP1; PUSH4 h; EQ;
   PUSH entry; JUMPI`` a function); anything else declines;
2. **validate**: the lockstep interpreter (``ops/lockstep.py``) runs one
   concrete lane a selector, and each mapped entry's visited-pc bit must
   be set (cached per bytecode);
3. **split**: one state a selector, positioned at its function entry
   with the dispatcher's machine effects reproduced symbolically, plus
   the fallback state behind the negated selector disjunction.

The validation runs on the analysis's device (``args.device``): on the
card one launch of the lockstep kernel.  Unlike the JAX package, which
skips it on an unhealthy device and swallows any error, the port lets a
kernel or device failure propagate; the declines on the input (hex that
does not parse, no match, a visited bit not set) are explicit checks.
"""

from typing import Dict, List, NamedTuple, Optional

import numpy as np

MAX_SELECTORS = 64
# validation probes must cover the longest prefix (4 + 5*MAX_SELECTORS
# steps to the deepest entry) plus a margin; the visited bit lands on
# the loop iteration AFTER the jump executes
VALIDATE_STEPS = 4 + 5 * MAX_SELECTORS + 64


class DispatcherPlan(NamedTuple):
    """A validated dispatch prefix, cached per bytecode."""

    # selector -> (entry byte addr, entry instr index, gas_min,
    #              gas_max, depth_delta): depth counts jumps, as jumpi_
    #              does
    branches: Dict[int, tuple]
    # fallback: (instr index after last JUMPI, gas_min, gas_max,
    #            depth_delta)
    fallback: tuple


_plan_cache: Dict[str, Optional[DispatcherPlan]] = {}


def _push_value(instr) -> Optional[int]:
    if not instr.op_code.startswith("PUSH") or instr.argument is None:
        return None
    return int.from_bytes(instr.argument, "big")


def _match_dispatcher(disassembly) -> Optional[DispatcherPlan]:
    """Static shape match; the plan or None (decline)."""
    from mythril_tpu_torch.support.opcodes import get_opcode_gas

    instrs = disassembly.instruction_list
    if len(instrs) < 9:
        return None
    # prelude: PUSH 0; CALLDATALOAD; PUSH 0xE0; SHR
    if not (
        _push_value(instrs[0]) == 0
        and instrs[1].op_code == "CALLDATALOAD"
        and _push_value(instrs[2]) == 0xE0
        and instrs[3].op_code == "SHR"
    ):
        return None
    gas_min = gas_max = 0
    for instr in instrs[:4]:
        lo, hi = get_opcode_gas(instr.op_code)
        gas_min += lo
        gas_max += hi
    branches: Dict[int, tuple] = {}
    index = 4
    blocks = 0
    while (
        index + 4 < len(instrs)
        and instrs[index].op_code == "DUP1"
        and instrs[index + 1].op_code == "PUSH4"
        and instrs[index + 2].op_code == "EQ"
        and instrs[index + 3].op_code.startswith("PUSH")
        and instrs[index + 4].op_code == "JUMPI"
    ):
        selector = _push_value(instrs[index + 1])
        entry = _push_value(instrs[index + 3])
        if selector is None or entry is None or selector in branches:
            return None
        for instr in instrs[index: index + 5]:
            lo, hi = get_opcode_gas(instr.op_code)
            gas_min += lo
            gas_max += hi
        blocks += 1
        entry_index = getattr(disassembly, "address_to_index", {}).get(entry)
        if entry_index is None:
            entry_index = next(
                (i for i, ins in enumerate(instrs) if ins.address == entry),
                None,
            )
        if entry_index is None or instrs[entry_index].op_code != "JUMPDEST":
            return None
        # a branch taken at block i passed i untaken JUMPIs plus its own
        # taken one
        branches[selector] = (entry, entry_index, gas_min, gas_max, blocks)
        index += 5
    if not branches or len(branches) > MAX_SELECTORS:
        return None
    return DispatcherPlan(branches=branches,
                          fallback=(index, gas_min, gas_max, blocks))


def _validate_on_lockstep(code: bytes, plan: DispatcherPlan) -> bool:
    """One concrete lane a selector through the lockstep interpreter, on
    the analysis's device; True when every lane's mapped entry has its
    visited-pc bit set."""
    from mythril_tpu_torch.ops import lockstep
    from mythril_tpu_torch.ops.device_health import check_device
    from mythril_tpu_torch.support.support_args import args

    check_device()
    selectors = sorted(plan.branches)
    batch = len(selectors)
    calldata = np.zeros((batch, 36), np.uint8)
    for lane, selector in enumerate(selectors):
        calldata[lane, :4] = list(selector.to_bytes(4, "big"))
    state = lockstep.init_state(batch, calldata, np.full(batch, 36, np.int32),
                                device=args.device)
    _final, visited, _steps = lockstep.run_batch(
        code, state, max_steps=VALIDATE_STEPS, record_visited=True)
    visited = visited.cpu()
    return all(lockstep.pc_visited(visited, lane, plan.branches[sel][0])
               for lane, sel in enumerate(selectors))


def dispatcher_plan(disassembly) -> Optional[DispatcherPlan]:
    """Matched and lockstep-validated plan for this bytecode, or None."""
    code_hex = disassembly.bytecode if isinstance(
        disassembly.bytecode, str) else ""
    if not code_hex:
        return None
    cached = _plan_cache.get(code_hex, False)
    if cached is not False:
        return cached
    plan = _match_dispatcher(disassembly)
    if plan is not None:
        try:
            code = bytes.fromhex(code_hex.removeprefix("0x"))
        except ValueError:
            return None  # not cached, as the JAX package's decline
        if not _validate_on_lockstep(code, plan):
            plan = None
    if len(_plan_cache) > 64:
        _plan_cache.clear()
    _plan_cache[code_hex] = plan
    return plan


def presplit_states(global_state) -> Optional[List]:
    """Per-selector copies of a transaction seed, positioned at the
    validated function entries; None when the pre-split declines."""
    from mythril_tpu_torch.smt import And, LShR, symbol_factory
    from mythril_tpu_torch.support.support_args import args

    if not getattr(args, "lockstep_dispatch", False):
        return None
    environment = global_state.environment
    if global_state.mstate.pc != 0 or global_state.mstate.stack:
        return None
    plan = dispatcher_plan(environment.code)
    if plan is None:
        return None

    # the dispatcher's own selector computation, built with the same
    # primitives the symbolic instructions would use
    word = environment.calldata.get_word_at(symbol_factory.BitVecVal(0, 256))
    selector_word = LShR(word, symbol_factory.BitVecVal(0xE0, 256))

    split = []
    for selector, (entry, entry_index, gmin, gmax, depth_delta) in sorted(
        plan.branches.items()
    ):
        state = global_state.__copy__()
        condition = selector_word == symbol_factory.BitVecVal(selector, 256)
        state.world_state.constraints.append(condition)
        state.mstate.pc = entry_index
        state.mstate.stack.append(selector_word)
        state.mstate.min_gas_used += gmin
        state.mstate.max_gas_used += gmax
        state.mstate.depth += depth_delta
        split.append((state, condition))
    # fallback: no selector matched; execution continues after the chain
    fb_index, gmin, gmax, depth_delta = plan.fallback
    state = global_state.__copy__()
    condition = None
    for selector in plan.branches:
        clause = selector_word != symbol_factory.BitVecVal(selector, 256)
        condition = clause if condition is None else And(condition, clause)
    state.world_state.constraints.append(condition)
    state.mstate.pc = fb_index
    state.mstate.stack.append(selector_word)
    state.mstate.min_gas_used += gmin
    state.mstate.max_gas_used += gmax
    state.mstate.depth += depth_delta
    split.append((state, condition))
    return split
