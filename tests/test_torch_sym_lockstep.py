"""The symbolic lockstep tier of the port against the JAX package's, on
the CPU (``mythril_tpu_torch/laser/ethereum/symbolic_lockstep.py`` against
``mythril_tpu/laser/ethereum/symbolic_lockstep.py``).

Every case of ``tests/test_sym_lockstep.py`` runs here on both packages
with the same stacks (built from the same seeded specs), bytecode,
memory and gas: the lockstep pass's serial remainder, its round records
(the executed lane, the opcode, every successor's pc, depth, min/max
gas, stack as ints or term strings, constraints, memory and storage,
and whether the lane is its own successor) and every segment counter
of ``DispatchStats`` (``states_stepped``, ``needs_host_boundaries``,
``boundary_causes``, ``plane_known_bits``, ``plane_total_bits``,
``mem_plane_ops``, ``storage_plane_ops``, ``keccak_device_hashes``)
must be exactly equal.  The port's SHA3 windows hash on
``device="cpu"`` (the keccak kernel's plain version); one case gives it
a stand-in card whose keccak library refuses every launch, which must
raise and not quietly kill the shadow.
"""

import contextlib
import random
import types
from datetime import datetime

import pytest
import torch

import bench
import mythril_tpu.disassembler.disassembly as j_disassembly
import mythril_tpu.laser.ethereum.state.calldata as j_calldata
import mythril_tpu.laser.ethereum.state.environment as j_environment
import mythril_tpu.laser.ethereum.state.global_state as j_global_state
import mythril_tpu.laser.ethereum.state.machine_state as j_machine_state
import mythril_tpu.laser.ethereum.state.world_state as j_world_state
import mythril_tpu.laser.ethereum.svm as j_svm
import mythril_tpu.laser.ethereum.symbolic_lockstep as j_sl
import mythril_tpu.laser.ethereum.transaction.transaction_models as j_tx
import mythril_tpu.ops.batched_sat as j_bs
import mythril_tpu.smt as j_smt
import mythril_tpu_torch.disassembler.disassembly as p_disassembly
import mythril_tpu_torch.laser.ethereum.state.calldata as p_calldata
import mythril_tpu_torch.laser.ethereum.state.environment as p_environment
import mythril_tpu_torch.laser.ethereum.state.global_state as p_global_state
import mythril_tpu_torch.laser.ethereum.state.machine_state as p_machine_state
import mythril_tpu_torch.laser.ethereum.state.world_state as p_world_state
import mythril_tpu_torch.laser.ethereum.svm as p_svm
import mythril_tpu_torch.laser.ethereum.symbolic_lockstep as p_sl
import mythril_tpu_torch.laser.ethereum.transaction.transaction_models as p_tx
import mythril_tpu_torch.ops.batched_sat as p_bs
import mythril_tpu_torch.smt as p_smt
from mythril_tpu.support.opcodes import BY_NAME
from mythril_tpu_torch.ops import keccak as PK
from mythril_tpu_torch.support.support_args import (
    SLICE_PINS_CPU_ENV,
    SLICE_PINS_ENV,
)
from mythril_tpu_torch.support.support_args import args as port_args
from test_torch_analyze import DETERMINISTIC_ENV, fresh_planes, kept_deadlines

pytestmark = pytest.mark.lockstep


def _side(disassembly, calldata, environment, global_state, machine_state,
          world_state, svm, sl, tx, bs, smt):
    return types.SimpleNamespace(
        Disassembly=disassembly.Disassembly,
        ConcreteCalldata=calldata.ConcreteCalldata,
        Environment=environment.Environment,
        GlobalState=global_state.GlobalState,
        MachineState=machine_state.MachineState,
        WorldState=world_state.WorldState, LaserEVM=svm.LaserEVM, sl=sl,
        MessageCallTransaction=tx.MessageCallTransaction,
        stats=lambda: bs.dispatch_stats, smt=smt)


SIDES = {
    "jax": _side(j_disassembly, j_calldata, j_environment, j_global_state,
                 j_machine_state, j_world_state, j_svm, j_sl, j_tx, j_bs,
                 j_smt),
    "port": _side(p_disassembly, p_calldata, p_environment, p_global_state,
                  p_machine_state, p_world_state, p_svm, p_sl, p_tx, p_bs,
                  p_smt),
}

#: the segment counters of ``DispatchStats``, compared exactly
SEGMENT_COUNTERS = (
    "states_stepped", "needs_host_boundaries", "boundary_causes",
    "plane_known_bits", "plane_total_bits", "mem_plane_ops",
    "storage_plane_ops", "keccak_device_hashes",
)
#: the knobs the tier reads, unset for every case
SEGMENT_KNOBS = tuple(f"MYTHRIL_TPU_{name}" for name in (
    "SYM_LOCKSTEP", "SEG_PLANES", "SEG_PLANES_MEM", "SEG_MAX_OPS",
    "SEG_MIN_LANES", "SEG_MEM_WORDS", "SEG_STORAGE_SLOTS",
    "SEG_KECCAK_MAX_BYTES"))


@contextlib.contextmanager
def slice_pins(monkeypatch):
    """The slice pins on both sides (the tier itself on), the port's
    solver tiers and keccak on the CPU, fresh plan caches, the segment
    ceiling of the autopilot out of reach (``DETERMINISTIC_ENV``).  Each
    package's lane ledger and autopilot, which a segment group asks for,
    are made afresh inside the pins and forgotten when they go
    (``fresh_planes``); so is each package's execution deadline, which
    the hook-parity runs arm."""
    for name in SEGMENT_KNOBS:
        monkeypatch.delenv(name, raising=False)
    for name, value in {**SLICE_PINS_ENV, **SLICE_PINS_CPU_ENV,
                        **DETERMINISTIC_ENV}.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(port_args, "device", "cpu")
    for side in SIDES.values():
        side.sl.reset_for_tests()
    with fresh_planes(), kept_deadlines():
        yield


@pytest.fixture(autouse=True)
def pins(monkeypatch):
    with slice_pins(monkeypatch):
        yield


# ---------------------------------------------------------------------------
# harness: one spec, two packages
# ---------------------------------------------------------------------------


def _item(side, spec):
    """A stack or memory item of ``side`` from a spec: an int (a 256-bit
    constant on the stack, a raw byte in memory), ``("s", name)`` a
    256-bit symbol, ``("t", name, k)`` a symbol plus a constant, ``("b",
    name)`` an 8-bit symbol."""
    f = side.smt.symbol_factory
    if isinstance(spec, int):
        return f.BitVecVal(spec, 256)
    kind, name = spec[0], spec[1]
    if kind == "s":
        return f.BitVecSym(name, 256)
    if kind == "t":
        return f.BitVecSym(name, 256) + f.BitVecVal(spec[2], 256)
    return f.BitVecSym(name, 8)


def make_state(side, code_hex, stack=(), pc=0, gas_limit=8_000_000,
               memory=None, static=False):
    """The JAX test's state (``tests/test_sym_lockstep.py:make_state``) in
    ``side``'s package."""
    f = side.smt.symbol_factory
    world_state = side.WorldState()
    account = world_state.create_account(
        balance=10, address=0x0A, concrete_storage=True,
        code=side.Disassembly(code_hex),
    )
    environment = side.Environment(
        account,
        sender=f.BitVecVal(0xB0B, 256),
        calldata=side.ConcreteCalldata("1", []),
        gasprice=f.BitVecVal(1, 256),
        callvalue=f.BitVecVal(0, 256),
        origin=f.BitVecVal(0xB0B, 256),
    )
    state = side.GlobalState(world_state, environment, None,
                             side.MachineState(gas_limit))
    state.transaction_stack.append((
        side.MessageCallTransaction(
            world_state=world_state, callee_account=account,
            caller=environment.sender, gas_limit=8_000_000,
        ),
        None,
    ))
    state.mstate.pc = pc
    for spec in stack:
        state.mstate.stack.append(_item(side, spec))
    if memory:
        state.mstate.memory.extend(len(memory))
        for i, spec in enumerate(memory):
            state.mstate.memory[i] = (spec if isinstance(spec, int)
                                      else _item(side, spec))
    state.environment.static = static
    return state


def make_svm(side):
    svm = side.LaserEVM(requires_statespace=False, execution_timeout=600)
    svm.time = datetime.now()
    return svm


def fingerprint(state):
    """Everything an opcode step can legally change, stringified (the
    JAX test's fingerprint; the term strings of the two packages are the
    same)."""
    storage = state.environment.active_account.storage
    return (
        state.mstate.pc,
        state.mstate.depth,
        state.mstate.min_gas_used,
        state.mstate.max_gas_used,
        tuple(str(x) for x in state.mstate.stack),
        tuple(str(c) for c in state.world_state.constraints),
        tuple(str(b) for b in state.mstate.memory[0:len(state.mstate.memory)]),
        tuple(sorted((str(k), str(v))
                     for k, v in storage.printable_storage.items())),
    )


def counters(side):
    stats = side.stats()
    return {name: (dict(getattr(stats, name)) if name == "boundary_causes"
                   else getattr(stats, name)) for name in SEGMENT_COUNTERS}


def lockstep_pass(side, states, svm=None, create=False, track_gas=False):
    """One scheduler round's lockstep pass over ``states`` on ``side``:
    (serial remainder as input indices, round records, segment counters
    of the pass)."""
    side.stats().reset()
    svm = svm or make_svm(side)
    rounds = []
    serial, timed_out = side.sl.run_lockstep(svm, list(states), rounds,
                                             create, track_gas)
    assert timed_out is None
    index = {id(s): i for i, s in enumerate(states)}
    records = [
        (index.get(id(lane)), op,
         sorted(fingerprint(s) for s in succ),
         [s is lane for s in succ])
        for lane, op, succ in rounds
    ]
    return [index[id(s)] for s in serial], records, counters(side), rounds


def both(build, max_ops=None, monkeypatch=None, **kw):
    """``build(side)`` -> states, on both packages, through one lockstep
    pass each (at most ``max_ops`` ops a segment): the serial remainder,
    the round records and the segment counters must be equal.  Returns
    ``{side: (states, pass result)}``."""
    if max_ops is not None:
        monkeypatch.setenv("MYTHRIL_TPU_SEG_MAX_OPS", str(max_ops))
    out = {}
    for name, side in SIDES.items():
        states = build(side)
        out[name] = (states, lockstep_pass(side, states, **kw))
    jax, port = out["jax"][1], out["port"][1]
    assert port[0] == jax[0], "serial remainder"
    assert port[1] == jax[1], "round records"
    assert port[2] == jax[2], "segment counters"
    return out


def one_op(code_hex, stack, monkeypatch, **kw):
    """One opcode (``MYTHRIL_TPU_SEG_MAX_OPS=1``) on both packages."""
    return both(lambda side: [make_state(side, code_hex, stack, **kw)],
                max_ops=1, monkeypatch=monkeypatch)


# ---------------------------------------------------------------------------
# per-opcode differential fuzz
# ---------------------------------------------------------------------------

FUZZ_OPS = [
    "POP", "ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD",
    "ADDMOD", "MULMOD", "EXP", "SIGNEXTEND",
    "LT", "GT", "SLT", "SGT", "EQ", "ISZERO",
    "AND", "OR", "XOR", "NOT", "BYTE", "SHL", "SHR", "SAR",
    "JUMPDEST", "PC", "MSIZE", "GAS",
    "ADDRESS", "ORIGIN", "CALLER", "CALLVALUE", "GASPRICE",
    "CHAINID", "CALLDATASIZE", "CALLDATALOAD",
    "PUSH1", "PUSH2", "PUSH32",
    "DUP1", "DUP2", "DUP16",
    "SWAP1", "SWAP2", "SWAP16",
]

_INTERESTING = (0, 1, 2, 3, 31, 32, 255, 256, 0xFFFF, 2**128,
                2**255, 2**256 - 1, 0x6D2B)


def _random_stack(rng, depth):
    stack = []
    for i in range(depth):
        kind = rng.random()
        if kind < 0.45:
            stack.append(rng.choice(_INTERESTING))
        elif kind < 0.8:
            stack.append(("s", f"s{i}_{rng.randrange(9999)}"))
        else:
            stack.append(("t", f"t{i}_{rng.randrange(9999)}",
                          rng.choice(_INTERESTING)))
    return stack


def _code_for(op, rng):
    info = BY_NAME[op]
    code = f"{info.byte:02x}"
    if op.startswith("PUSH"):
        n = int(op[4:])
        code += "".join(f"{rng.randrange(256):02x}" for _ in range(n))
    return code


@pytest.mark.parametrize("op", FUZZ_OPS)
def test_differential_fuzz_per_opcode(monkeypatch, op):
    """Eleven seeded symbolic stacks an opcode (the first short enough to
    underflow): the same records and counters on both packages, the
    shadow's known bits included."""
    rng = random.Random(f"lockstep {op}")
    pops = BY_NAME[op].pops
    for trial in range(11):
        depth = (max(pops - 1, 0) if trial == 0
                 else rng.randrange(0, max(pops + 3, 4)))
        one_op(_code_for(op, rng), _random_stack(rng, depth), monkeypatch)


@pytest.mark.parametrize("op", ["JUMP", "JUMPI"])
def test_differential_fuzz_jumps(monkeypatch, op):
    """JUMP/JUMPI: valid, invalid and symbolic destinations, concrete and
    symbolic conditions, the underflow arm."""
    rng = random.Random(f"jumps {op}")
    code = f"{BY_NAME[op].byte:02x}" + "5b" * 4
    extra = 2 if op == "JUMPI" else 1
    for trial in range(12):
        dest = rng.choice([1, 2, 3, 4, 0, 9, 2**200, ("s", f"d{trial}")])
        cond = rng.choice([0, 1, ("s", f"c{trial}")])
        stack = [cond, dest] if op == "JUMPI" else [dest]
        if trial == 0:
            stack = stack[:extra - 1]
        one_op(code, stack, monkeypatch)


# ---------------------------------------------------------------------------
# fault ordering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["PUSH1", "DUP1"])
def test_stack_overflow_parity(monkeypatch, op):
    one_op(_code_for(op, random.Random(1)), [7] * 1024, monkeypatch)


@pytest.mark.parametrize("gas_limit", [0, 2, 3])
def test_out_of_gas_parity(monkeypatch, gas_limit):
    one_op("01", [3, 4], monkeypatch, gas_limit=gas_limit)


# ---------------------------------------------------------------------------
# segment seams
# ---------------------------------------------------------------------------

# PUSH1 1; PUSH1 2; ADD; PUSH1 0; BALANCE: four interior ops, then a
# NEEDS_HOST boundary
_SEG_CODE = "6001600201600031"


def test_needs_host_mid_segment_bailout(monkeypatch):
    out = both(lambda side: [make_state(side, _SEG_CODE)])
    _serial, records, stats, _rounds = out["port"][1]
    assert records[0][1] == "PUSH1" and records[0][3] == [True]
    assert records[0][2][0][0] == 4  # parked ON the BALANCE
    assert stats["boundary_causes"] == {"BALANCE": 1}
    assert stats["states_stepped"] == 4


@pytest.mark.parametrize("stack,pc", [([("s", "resume")], 1), ([3, 4], 2)])
def test_mid_block_entry_resume(monkeypatch, stack, pc):
    one_op(_SEG_CODE, stack, monkeypatch, pc=pc)


def test_jumpi_fork_mask_split(monkeypatch):
    out = both(lambda side: [make_state(side, "600457005b00", [("s", c)])
                             for c in ("fork0", "fork1")])
    _serial, records, _stats, _rounds = out["port"][1]
    assert [r[1] for r in records] == ["JUMPI", "JUMPI"]
    assert all(len(r[2]) == 2 for r in records)


def test_sibling_group_batches(monkeypatch):
    """Three siblings at one pc run as one lane batch (the batched
    ``f_*`` shadow) through a concrete-key SSTORE."""
    stacks = ([("s", "a")], [("s", "b"), 5], [0xFFFF])
    out = both(lambda side: [make_state(side, "6001600201600055", s)
                             for s in stacks])
    stats = out["port"][1][2]
    assert stats["states_stepped"] == 15
    assert stats["storage_plane_ops"] == 3
    assert stats["plane_known_bits"] > 0


# ---------------------------------------------------------------------------
# kill switches and gates
# ---------------------------------------------------------------------------


def test_kill_switch_leaves_batch_untouched(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_SYM_LOCKSTEP", "0")
    out = both(lambda side: [make_state(side, "6001600201")])
    assert out["port"][1][:2] == ([0], [])


@pytest.mark.parametrize("gate", ["statespace", "track_gas", "create"])
def test_statespace_and_gas_rounds_stay_serial(gate):
    for name, side in SIDES.items():
        svm = make_svm(side)
        svm.requires_statespace = gate == "statespace"
        serial, records, _stats, _rounds = lockstep_pass(
            side, [make_state(side, "6001600201")], svm,
            create=gate == "create", track_gas=gate == "track_gas")
        assert (serial, records) == ([0], []), name


def test_unsupported_entry_pc_falls_through():
    out = both(lambda side: [make_state(side, _SEG_CODE, [1, 0], pc=4)])
    assert out["port"][1][:2] == ([0], [])


def test_mem_planes_kill_switch_restores_boundary(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_SEG_PLANES_MEM", "0")
    out = both(lambda side: [make_state(side, "6001600201600055", [1, 0],
                                        pc=4)])
    assert out["port"][1][:2] == ([0], [])
    out = both(lambda side: [make_state(side, "6001600201600055")])
    _serial, records, stats, _rounds = out["port"][1]
    assert records[0][2][0][0] == 4 and stats["boundary_causes"] == {
        "SSTORE": 1}


def test_shadow_kill_switch(monkeypatch):
    """``MYTHRIL_TPU_SEG_PLANES=0``: no shadow, the same records."""
    monkeypatch.setenv("MYTHRIL_TPU_SEG_PLANES", "0")
    out = both(lambda side: [make_state(side, "6001600201600055", s)
                             for s in ([("s", "a")], [7])])
    assert out["port"][1][2]["plane_total_bits"] == 0


# ---------------------------------------------------------------------------
# memory/storage/keccak planes
# ---------------------------------------------------------------------------

PLANE_FUZZ_OPS = ("MLOAD", "MSTORE", "MSTORE8", "SLOAD", "SSTORE", "SHA3")


@pytest.mark.parametrize("op", PLANE_FUZZ_OPS)
def test_plane_differential_fuzz(monkeypatch, op):
    """Concrete and symbolic offsets, keys, values, SHA3 lengths and
    window bytes: the same records (a parked SHA3 lane as the serial
    remainder) and counters on both packages."""
    rng = random.Random(f"planes {op}")
    offsets = [0, 1, 31, 32, 96, 4095, 4096, 8192, 2**200]
    code = f"{BY_NAME[op].byte:02x}"
    outcomes = set()
    for trial in range(14):
        sym = ("s", f"p{op}_{trial}")
        off = sym if trial % 3 == 2 else rng.choice(offsets)
        val = rng.choice([rng.choice(_INTERESTING),
                          ("s", f"v{op}_{trial}")])
        memory = None
        if op == "SHA3":
            length = rng.choice([0, 1, 32, 64, 136, 256, 300])
            if trial % 3 == 2:
                length = sym
            stack = [length, rng.choice([0, 32, 4096])]
            memory = [rng.randrange(256) for _ in range(128)]
            if trial % 5 == 4:
                memory[7] = ("b", f"m{trial}")
        elif op == "MLOAD":
            stack = [off]
            memory = [rng.randrange(256) for _ in range(64)]
        elif op in ("MSTORE", "MSTORE8", "SSTORE"):
            stack = [val, off]
        else:
            stack = [off]
        if trial == 0:
            stack = stack[:-1] or []
        out = one_op(code, stack, monkeypatch, memory=memory)
        outcomes.add("parked" if out["port"][1][0] else "executed")
    assert "executed" in outcomes
    assert ("parked" in outcomes) == (op == "SHA3")


ROUNDTRIP = (
    "7f" + "11" * 32       # PUSH32 0x1111..11
    + "600052"             # PUSH1 0; MSTORE
    + "6020600020"         # PUSH1 32; PUSH1 0; SHA3
    + "600555"             # PUSH1 5; SSTORE
    + "600554"             # PUSH1 5; SLOAD
    + "600051"             # PUSH1 0; MLOAD
)


def test_plane_segment_memory_storage_keccak_roundtrip():
    out = both(lambda side: [make_state(side, ROUNDTRIP),
                             make_state(side, ROUNDTRIP)])
    stats = out["port"][1][2]
    assert (stats["mem_plane_ops"], stats["storage_plane_ops"],
            stats["keccak_device_hashes"]) == (4, 4, 2)


def test_plane_roundtrip_single_lane():
    """The scalar shadow (one lane) over the same segment."""
    out = both(lambda side: [make_state(side, ROUNDTRIP)])
    assert out["port"][1][2]["keccak_device_hashes"] == 1


def test_plane_fork_split_parity():
    """MSTORE before a symbolic JUMPI, SHA3 after: the successors carry
    the planes copy-on-write, and the taken branch's next segment adopts
    them on both packages alike."""
    code = "6042600052" + "600957" + "00" + "5b6020600020" + "00"
    out = both(lambda side: [make_state(side, code, [("s", "fork_c")])])
    taken = {}
    for name in SIDES:
        rounds = out[name][1][3]
        (_lane, op, succ), = rounds
        assert op == "JUMPI" and len(succ) == 2
        assert all("_seg_planes" in s.__dict__ for s in succ)
        taken[name] = [s for s in succ if s.mstate.pc == 6]
    results = {}
    for name, side in SIDES.items():
        results[name] = lockstep_pass(side, taken[name])
    assert results["port"][:3] == results["jax"][:3]
    (lane, op, succ), = results["port"][3]
    assert op == "SHA3" and succ == [lane] and lane.mstate.pc == 10
    assert results["port"][2]["keccak_device_hashes"] == 1
    assert "_seg_planes" not in lane.__dict__


#: a plane op whose word feeds a later transfer (the word's interval
#: planes reach it, so an unmasked complement in them shows)
PLANE_FEEDS = {
    "MLOAD, ADD, AND": "600052" + "600051" + "600101" + "60ff16" + "00",
    "MLOAD, MUL": "600052" + "600051" + "600302" + "00",
    "MLOAD, LT": "600052" + "600051" + "600510" + "00",
    "SLOAD, ADD": "600055" + "600054" + "600101" + "00",
    "SHA3, ADD": "600052" + "6020600020" + "600101" + "00",
}


@pytest.mark.parametrize("name", sorted(PLANE_FEEDS))
@pytest.mark.parametrize("lanes", [1, 3])
def test_plane_words_feed_later_transfers(name, lanes):
    """The word a plane op pushes (the meet of the plane's and the live
    term's) is an operand of the next transfer: the same known bits on
    both packages, on the scalar shadow and on the batched one."""
    stacks = [[("s", "a")], [7], [("t", "b", 5)]][:lanes]
    out = both(lambda side: [make_state(side, PLANE_FEEDS[name], s)
                             for s in stacks])
    assert out["port"][1][2]["plane_known_bits"] > 0


#: three partly known words stored under keys 1, 2, 3 and read back
STORAGE_SLOTS_CODE = (
    "8060ff16600155"        # DUP1; PUSH1 0xff; AND; PUSH1 1; SSTORE
    + "8061ffff16600255"    # DUP1; PUSH2 0xffff; AND; PUSH1 2; SSTORE
    + "62ffffff16600355"    # PUSH3 0xffffff; AND; PUSH1 3; SSTORE
    + "600154600254600354"  # SLOAD 1; SLOAD 2; SLOAD 3
    + "00"
)
#: a partly known word stored inside a 32-byte arena, read back, then one
#: stored across its edge (the overlapped tail forgotten), read back
MEMORY_EDGE_CODE = (
    "8060ff16600052"        # DUP1; PUSH1 0xff; AND; PUSH1 0; MSTORE
    + "600051"              # PUSH1 0; MLOAD
    + "8161ffff16601052"    # DUP2; PUSH2 0xffff; AND; PUSH1 16; MSTORE
    + "600051601051"        # MLOAD 0; MLOAD 16
    + "00"
)


@pytest.mark.parametrize("slots", ["32", "2"])
@pytest.mark.parametrize("lanes", [1, 3])
def test_storage_plane_slots(monkeypatch, slots, lanes):
    """Distinct keys take the first free slots and are found again; with
    ``MYTHRIL_TPU_SEG_STORAGE_SLOTS=2`` the third key finds the lane full
    and is dropped, so its load misses back to the live term."""
    monkeypatch.setenv("MYTHRIL_TPU_SEG_STORAGE_SLOTS", slots)
    stacks = [[("s", "a")], [("s", "b")], [("t", "c", 5)]][:lanes]
    out = both(lambda side: [make_state(side, STORAGE_SLOTS_CODE, s)
                             for s in stacks])
    assert out["port"][1][2]["storage_plane_ops"] == 6 * lanes


@pytest.mark.parametrize("lanes", [1, 3])
def test_memory_plane_arena_edge(monkeypatch, lanes):
    """``MYTHRIL_TPU_SEG_MEM_WORDS=1``: a store inside the 32-byte arena
    is read back; one that straddles its edge forgets the overlapped
    tail, and a load past the edge reads unknown."""
    monkeypatch.setenv("MYTHRIL_TPU_SEG_MEM_WORDS", "1")
    stacks = [[("s", "a")], [("s", "b")], [("t", "c", 5)]][:lanes]
    out = both(lambda side: [make_state(side, MEMORY_EDGE_CODE, s)
                             for s in stacks])
    assert out["port"][1][2]["mem_plane_ops"] == 5 * lanes


@pytest.mark.parametrize("gas_limit",
                         [0, 2, 3, 5, 30, 42, 5000, 19999, 20000])
def test_plane_gas_parity(monkeypatch, gas_limit):
    rng = random.Random(gas_limit)
    one_op("52", [7, 0], monkeypatch, gas_limit=gas_limit)
    one_op("51", [0], monkeypatch, gas_limit=gas_limit)
    one_op("55", [rng.choice([0, 9]), 1], monkeypatch, gas_limit=gas_limit)
    one_op("54", [1], monkeypatch, gas_limit=gas_limit)
    one_op("20", [64, 0], monkeypatch, gas_limit=gas_limit)


def test_sstore_static_context_write_protection_parity(monkeypatch):
    out = one_op("55", [3, 1], monkeypatch, static=True)
    assert out["port"][1][0] == [] and out["port"][1][1][0][1] == "SSTORE"


def test_keccak_kernel_refusal_raises(monkeypatch):
    """A stand-in card whose keccak library refuses every launch: the
    segment's SHA3 raises :class:`KeccakKernelError` out of the tier
    (the shadow's guards let it through), and nothing is counted as
    launched.  Without a card at all the same error names the card."""
    refusing = types.SimpleNamespace(keccak_launch=lambda *args: 700)
    monkeypatch.setattr(PK, "load_library", lambda: refusing)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(port_args, "device", "meta")
    side = SIDES["port"]
    PK.reset_launch_count()
    with pytest.raises(PK.KeccakKernelError, match="cudaError 700"):
        lockstep_pass(side, [make_state(side, ROUNDTRIP)])
    assert PK.launch_count == 0
    monkeypatch.setattr(port_args, "device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PK.KeccakKernelError, match="CUDA device"):
        lockstep_pass(side, [make_state(side, ROUNDTRIP)])


# ---------------------------------------------------------------------------
# hook parity on the chaos tree
# ---------------------------------------------------------------------------


def _hook_calls(side, lockstep, monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_SYM_LOCKSTEP", "1" if lockstep else "0")
    code = bench.chaos_tree_contract()
    hooked_ops = ("AND", "MUL", "JUMPI", "JUMPDEST", "PUSH2")
    calls = {"state": [], "pre": [], "post": [], "ipre": [], "ipost": []}
    svm = side.LaserEVM(requires_statespace=False, execution_timeout=120,
                        transaction_count=1)
    svm.register_laser_hooks(
        "execute_state", lambda gs: calls["state"].append(gs.mstate.pc))
    for op in hooked_ops:
        svm.pre_hooks[op].append(
            lambda gs, op=op: calls["pre"].append((op, gs.mstate.pc)))
        svm.post_hooks[op].append(
            lambda gs, op=op: calls["post"].append((op, gs.mstate.pc)))
        svm.instr_pre_hook[op].append(
            lambda gs, op=op: calls["ipre"].append((op, gs.mstate.pc)))
        svm.instr_post_hook[op].append(
            lambda gs, op=op: calls["ipost"].append((op, gs.mstate.pc)))
    world_state = side.WorldState()
    world_state.create_account(balance=10, address=0xABCD,
                               concrete_storage=True,
                               code=side.Disassembly(code))
    side.stats().reset()
    svm.sym_exec(world_state=world_state, target_address=0xABCD)
    return {k: sorted(v) for k, v in calls.items()}, counters(side)


def test_hook_parity_on_chaos_tree(monkeypatch):
    """Every hook fires with the same (opcode, pc) arguments on the port
    with the tier on as on its serial path, and as on the JAX package
    with the tier on; the segment counters of the run are the JAX
    package's."""
    port_serial, _ = _hook_calls(SIDES["port"], False, monkeypatch)
    port_on, port_stats = _hook_calls(SIDES["port"], True, monkeypatch)
    jax_on, jax_stats = _hook_calls(SIDES["jax"], True, monkeypatch)
    assert sum(len(v) for v in port_serial.values()) > 0
    assert port_on == port_serial
    assert port_on == jax_on
    assert port_stats == jax_stats and port_stats["states_stepped"] > 0
