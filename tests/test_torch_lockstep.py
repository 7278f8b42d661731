"""The lockstep interpreter of the port against the JAX package, on the CPU.

- ``ops/u256.py``'s division, remainder, exponent and byte conversions
  against ``mythril_tpu.ops.u256`` on edge and seeded random operands;
- ``ops/lockstep.run_batch`` (the plain loop on CPU tensors) against
  ``mythril_tpu.ops.lockstep.run_batch`` on seeded random programs and on
  the gauntlet (``contracts.lockstep_gauntlet``): every ``EVMState``
  field, the visited bitmaps, the loop count and the cause histogram;
- ``ops/csrc/lockstep.cu`` built as host C++ with g++ (``lockstep_host``:
  the kernel's own step, division and exponent on an emulated group of 8
  threads) against the plain loop on the same cases;
- the dispatcher pre-split's plans against the JAX package's.

Every comparison is exact (bit-equal): the interpreter is integer logic
on 32-bit limbs.  The random programs fit one code bucket (256), so the
JAX runners compile a few times only.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from mythril_tpu.ops import lockstep as JL
from mythril_tpu.ops import u256 as JU
from mythril_tpu_torch import contracts
from mythril_tpu_torch.ops import lockstep as PL
from mythril_tpu_torch.ops import u256 as PU

MIN = 1 << 255
MAX = (1 << 256) - 1
EDGES = [0, 1, 2, 3, MIN, MIN + 1, MAX, MAX - 1, MIN - 1, 255, 256,
         1 << 32, (1 << 32) - 1, 1 << 128, 7]


def _words(values):
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in values], dtype=np.uint32)


def _operands(seed=11, n_random=48):
    """All pairs of edge operands, then seeded random pairs (random
    words, and random words of random bit lengths)."""
    rng = np.random.default_rng(seed)
    a = [x for x in EDGES for _ in EDGES]
    b = [y for _ in EDGES for y in EDGES]
    for _ in range(n_random):
        bits = [int(rng.integers(1, 257)) for _ in range(2)]
        a.append(int.from_bytes(rng.bytes(32), "big") >> (256 - bits[0]))
        b.append(int.from_bytes(rng.bytes(32), "big") >> (256 - bits[1]))
    return _words(a), _words(b)


U256_CASES = {
    "udiv": (lambda a, b: JU.udivmod(a, b)[0],
             lambda a, b: PU.udivmod(a, b)[0]),
    "umod": (lambda a, b: JU.udivmod(a, b)[1],
             lambda a, b: PU.udivmod(a, b)[1]),
    "sdiv": (JU.sdiv, PU.sdiv),
    "smod": (JU.smod, PU.smod),
    "exp": (JU.exp, PU.exp),
}


@pytest.mark.parametrize("name", sorted(U256_CASES))
def test_u256_division_and_exp_match_jax(name):
    import jax.numpy as jnp

    jax_fn, port_fn = U256_CASES[name]
    a, b = _operands()
    want = np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b)))
    got = port_fn(torch.from_numpy(a.astype(np.int64)),
                  torch.from_numpy(b.astype(np.int64)))
    assert got.dtype == PU.DTYPE
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_u256_edge_rules():
    """The EVM's rules the division keeps: x/0 = 0, x%0 = 0, MIN / -1
    wraps, SMOD takes the dividend's sign, 0 ** 0 = 1."""
    def word(v):
        return torch.from_numpy(_words([v]).astype(np.int64))

    def val(t):
        return PU.to_int(t[0])

    assert val(PU.udivmod(word(7), word(0))[0]) == 0
    assert val(PU.udivmod(word(7), word(0))[1]) == 0
    assert val(PU.sdiv(word(MIN), word(MAX))) == MIN
    assert val(PU.smod(word(MAX - 6), word(3))) == MAX  # -7 % 3 = -1
    assert val(PU.smod(word(7), word(MAX - 2))) == 1    # 7 % -3 = 1
    assert val(PU.exp(word(0), word(0))) == 1
    assert val(PU.exp(word(2), word(255))) == MIN


def test_byte_conversions_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(64, 32), dtype=np.uint8)
    limbs = PU.bytes_to_limbs(torch.from_numpy(data))
    want = np.asarray(JU.bytes_to_limbs(jnp.asarray(data)))
    np.testing.assert_array_equal(limbs.numpy(), want.astype(np.int64))
    back = PU.limbs_to_bytes(limbs)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JU.limbs_to_bytes(jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy(), data)


# ------------------------------------------------------------ programs

#: opcodes the random programs draw from: every handled one, plus a few
#: the interpreter hands to the host
_ARITH = [0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x0A, 0x10, 0x11, 0x12,
          0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x1B, 0x1C, 0x1D]
_OTHER = ([0x33, 0x34, 0x36, 0x35, 0x50, 0x58, 0x5B, 0x5F, 0x8F, 0x9F]
          + [0x80, 0x81, 0x82, 0x83, 0x90, 0x91, 0x92] * 3)
_HOST = [0x20, 0x31, 0x1A, 0xFE, 0x42, 0xA0, 0xF1]


def random_program(seed: int, size: int = 200) -> bytes:
    """A seeded program of at most ``size`` bytes (one code bucket): a
    prologue that loads the calldata words and a few constants, then
    random opcodes with immediates, branches on calldata bits, memory and
    storage accesses at edge offsets and keys, jumps to its JUMPDESTs and
    now and then to bad targets, and an exit."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for k in range(4):
        out += bytes([0x60, 32 * k, 0x35])  # PUSH1 32k; CALLDATALOAD
    for k in range(6):
        out += bytes([0x60, int(rng.integers(0, 256))])
    jumps = []
    dests = []

    def jump(op):
        jumps.append(len(out))
        out.extend([0x61, 0, 0, op])

    while len(out) < size - 40:
        r = rng.random()
        if r < 0.25:
            width = int(rng.choice([1, 1, 2, 4, 32]))
            value = int(rng.choice([0, 1, 255, 256, MIN >> (256 - 8 * width),
                                    int.from_bytes(rng.bytes(width), "big")]))
            value &= (1 << (8 * width)) - 1
            out += bytes([0x5F + width]) + value.to_bytes(width, "big")
        elif r < 0.33:
            dests.append(len(out))
            out.append(0x5B)
        elif r < 0.4:  # a branch on a calldata bit
            out += bytes([0x60, 32 * int(rng.integers(0, 3)), 0x35, 0x60,
                          1 << int(rng.integers(0, 8)), 0x16])
            jump(0x57)
        elif r < 0.43:
            jump(int(rng.choice([0x56, 0x57])))
        elif r < 0.5:
            op = int(rng.choice([0x51, 0x52, 0x53]))
            if rng.random() < 0.5:  # an offset from calldata, up to 4095
                out += bytes([0x80, 0x60, 32 * int(rng.integers(0, 3)), 0x35,
                              0x61, 0x0F, 0xFF, 0x16, op])
            else:
                off = int(rng.choice([0, 31, 64, 1000, 4064, 4095, 70000]))
                out += bytes([0x80, 0x62]) + off.to_bytes(3, "big") \
                    + bytes([op])
        elif r < 0.57:
            key = int(rng.integers(0, 40))
            out += bytes([0x80, 0x60, key, int(rng.choice([0x54, 0x55]))])
        elif r < 0.59:
            out.append(int(rng.choice(_HOST)))
        elif r < 0.78:
            out.append(int(rng.choice(_ARITH)))
        else:
            out.append(int(rng.choice(_OTHER)))
    for at in jumps:
        target = int(rng.choice(dests)) if dests and rng.random() < 0.9 \
            else int(rng.integers(0, len(out) + 8))
        out[at + 1:at + 3] = target.to_bytes(2, "big")
    out += bytes([0x60, 0x20, 0x60, 0x00, int(rng.choice([0xF3, 0xFD, 0x00]))])
    assert len(out) <= 223
    return bytes(out)


def _inputs(n_lanes: int, seed: int, size: int = 100):
    rng = np.random.default_rng(seed)
    calldata = contracts.gauntlet_calldata(n_lanes, seed)[:, :size]
    sizes = rng.integers(size - 8, size + 1, size=n_lanes).astype(np.int32)
    value = rng.integers(0, 1 << 32, size=(n_lanes, 8), dtype=np.uint64)
    caller = rng.integers(0, 1 << 32, size=(n_lanes, 8), dtype=np.uint64)
    value[::2, 1:] = 0
    keys = rng.integers(0, 4, size=(n_lanes, 3, 8), dtype=np.uint64)
    vals = rng.integers(0, 1 << 32, size=(n_lanes, 3, 8), dtype=np.uint64)
    return (calldata, sizes, value.astype(np.uint32), caller.astype(np.uint32),
            keys.astype(np.uint32), vals.astype(np.uint32))


def _run_both(code, inputs, max_steps):
    calldata, sizes, value, caller, keys, vals = inputs
    B = calldata.shape[0]
    jax_state = JL.init_state(B, calldata, sizes, value, caller, keys, vals)
    jax_out = JL.run_batch(code, jax_state, max_steps, record_visited=True)
    port_state = PL.init_state(B, calldata, sizes, value, caller, keys, vals,
                               device="cpu")
    port_out = PL.run_batch(code, port_state, max_steps, record_visited=True)
    return jax_out, port_out, port_state


def _assert_states_equal(want, got):
    for name in PL.EVMState._fields:
        w = np.asarray(getattr(want, name)).astype(np.int64)
        g = getattr(got, name).numpy().astype(np.int64)
        assert w.shape == g.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


PROGRAM_CASES = {
    **{f"random program {seed}": (lambda seed=seed: random_program(seed), 128)
       for seed in (2, 4, 8, 10)},
    "gauntlet": (lambda: bytes.fromhex(contracts.lockstep_gauntlet()), 1024),
}


@pytest.mark.parametrize("name", sorted(PROGRAM_CASES))
def test_run_batch_matches_jax(name):
    make, max_steps = PROGRAM_CASES[name]
    code = make()
    lanes = 96 if name == "gauntlet" else 32
    inputs = _inputs(lanes, seed=len(name))
    (jf, jv, jn), (pf, pv, pn), _ = _run_both(code, inputs, max_steps)
    _assert_states_equal(jf, pf)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv).astype(np.int64))
    assert pn == int(jn)
    assert PL.cause_histogram(pf) == JL.cause_histogram(jf)
    halts = set(pf.halt.tolist())
    if name == "gauntlet":
        # every halt code, and every NEEDS_HOST cause
        assert halts == set(range(6)), halts
        causes = {PL.decode_cause(c)[0] for c in pf.cause.tolist() if c}
        assert causes == {"mem-arena-oob", "storage-arena-full",
                          "unsupported-op"}
    else:
        assert len(halts) >= 2, halts


# ------------------------------------------------- the kernel's source


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``lockstep.cu`` built as host C++ (``lockstep_host``: the kernel's
    lane walk on an emulated group of 8 threads), bound with ctypes."""
    lib_path = tmp_path_factory.mktemp("lockstep") / "liblockstep_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-x", "c++", "-shared",
                    "-fPIC", "-o", str(lib_path), PL.SOURCE],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.lockstep_host.argtypes = [ptr] * 4 + [c_int] * 2 + [ptr] * 15 + [
        c_int] * 4
    lib.lockstep_host.restype = c_int
    arenas = (ctypes.c_int * 3)()
    lib.lockstep_arenas(arenas)
    assert tuple(arenas) == (PL.STACK_SLOTS, PL.MEMORY_BYTES,
                             PL.STORAGE_SLOTS)
    return lib


def _run_host(lib, code, state, max_steps, record_visited=True):
    program = PL.prepare_program(code)
    packed, visited, steps, args = PL.launch_args(program, state, max_steps,
                                                  record_visited)
    fault = lib.lockstep_host(*args)
    assert fault == 0, "a group-uniform value differed across the limbs"
    return PL.launch_results(packed, visited, steps)


HOST_CASES = {
    **PROGRAM_CASES,
    "gauntlet, 2048 steps": (
        lambda: bytes.fromhex(contracts.lockstep_gauntlet()), 2048),
    "gauntlet, step cap 64": (
        lambda: bytes.fromhex(contracts.lockstep_gauntlet()), 64),
    "batchtoken": (lambda: bytes.fromhex(contracts.batchtoken_contract()),
                   388),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_kernel_source_matches_the_plain_loop(name, host_kernel):
    make, max_steps = HOST_CASES[name]
    code = make()
    lanes = 48
    calldata, sizes, value, caller, keys, vals = _inputs(lanes, seed=len(name))
    state = PL.init_state(lanes, calldata, sizes, value, caller, keys, vals,
                          device="cpu")
    want = PL.run_plain(PL.prepare_program(code), state, max_steps, True)
    got = _run_host(host_kernel, code, state, max_steps)
    for name_, w, g in zip(PL.EVMState._fields, want[0], got[0]):
        assert w.dtype == g.dtype and torch.equal(w, g), name_
    assert torch.equal(want[1], got[1])
    assert want[2] == got[2]
    unrecorded = _run_host(host_kernel, code, state, max_steps, False)
    assert torch.equal(unrecorded[0].halt, got[0].halt)
    assert unrecorded[2] == got[2]


def test_kernel_wrapper_raises_without_a_card(monkeypatch):
    """A state on the card goes to the kernel and nowhere else: with no
    library to load, ``run_batch`` raises rather than run the plain loop
    (the card is a stand-in: a device type of ``cuda``)."""
    state = PL.init_state(2, np.zeros((2, 4), np.uint8), [4, 4],
                          device="cpu")

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(PL, "load_library", no_library)
    monkeypatch.setattr(PL, "run_plain", None)
    fake = state._replace(pc=torch.zeros(2, dtype=torch.int32,
                                         device="meta"))
    PL.reset_launch_count()
    with pytest.raises(RuntimeError, match="nvcc"):
        PL.run_batch(b"\x00", fake)
    assert PL.launch_count == 0


# ------------------------------------------------- dispatcher pre-split

PLAN_CONTRACTS = {
    **{run.name: run.code for run in contracts.CHIP_RUNS},
    "batchtoken": contracts.batchtoken_contract,
}


@pytest.mark.parametrize("name", sorted(PLAN_CONTRACTS))
def test_dispatcher_plan_matches_jax(monkeypatch, name):
    from mythril_tpu.disassembler.disassembly import Disassembly as JD
    from mythril_tpu.laser.ethereum import lockstep_dispatch as JLD
    from mythril_tpu_torch.disassembler.disassembly import Disassembly as PD
    from mythril_tpu_torch.laser.ethereum import lockstep_dispatch as PLD
    from mythril_tpu_torch.support.support_args import args

    monkeypatch.setattr(args, "device", "cpu")
    monkeypatch.setattr(JLD, "_plan_cache", {})
    monkeypatch.setattr(PLD, "_plan_cache", {})
    code = PLAN_CONTRACTS[name]()
    want = JLD.dispatcher_plan(JD(code))
    got = PLD.dispatcher_plan(PD(code))
    assert (got is None) == (want is None)
    if want is not None:
        assert got.branches == want.branches
        assert got.fallback == want.fallback
    matching = {"erc20_transfer -t 2", "vault_withdraw -t 2",
                "killbilly -t 1", "batchtoken"}
    assert (got is not None) == (name in matching)


def test_wide_dispatcher_plan_validates_every_selector(monkeypatch):
    """The pre-split's cap: a canonical dispatcher of MAX_SELECTORS
    functions matches, and every one of its lanes reaches its entry
    within VALIDATE_STEPS."""
    from mythril_tpu_torch.disassembler.disassembly import Disassembly
    from mythril_tpu_torch.laser.ethereum import lockstep_dispatch as PLD
    from mythril_tpu_torch.support.support_args import args

    monkeypatch.setattr(args, "device", "cpu")
    monkeypatch.setattr(PLD, "_plan_cache", {})
    plan = PLD.dispatcher_plan(Disassembly(contracts.wide_dispatcher()))
    assert plan is not None and len(plan.branches) == PLD.MAX_SELECTORS
    assert PLD.dispatcher_plan(Disassembly(contracts.wide_dispatcher(
        PLD.MAX_SELECTORS + 1))) is None


def test_dispatcher_plan_declines_a_selector_the_interpreter_misses(
        monkeypatch):
    """The validation, not the shape match, declines a plan whose mapped
    entry the concrete run never executes (here the entry moved to the
    fallback's REVERT, which the selector's lane jumps over)."""
    from mythril_tpu_torch.disassembler.disassembly import Disassembly
    from mythril_tpu_torch.laser.ethereum import lockstep_dispatch as PLD
    from mythril_tpu_torch.support.assembler import asm
    from mythril_tpu_torch.support.support_args import args

    monkeypatch.setattr(args, "device", "cpu")
    monkeypatch.setattr(PLD, "_plan_cache", {})
    code = asm("""
        PUSH 0; CALLDATALOAD; PUSH 0xe0; SHR
        DUP1; PUSH4 0x11111111; EQ; PUSH @a; JUMPI
        PUSH 0; PUSH 0; REVERT
      a:
        JUMPDEST; STOP
    """)
    plan = PLD._match_dispatcher(Disassembly(code))
    assert plan is not None
    selector, (entry, *_rest) = next(iter(plan.branches.items()))
    revert = bytes.fromhex(code).index(0xFD)
    broken = plan._replace(branches={selector: (revert, *_rest)})
    assert not PLD._validate_on_lockstep(bytes.fromhex(code), broken)
    assert PLD._validate_on_lockstep(bytes.fromhex(code), plan)
