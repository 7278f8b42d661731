"""The lockstep interpreter of the port against the JAX package, on the CPU.

- ``ops/u256.py``'s division, remainder, exponent and byte conversions
  against ``mythril_tpu.ops.u256`` on edge and seeded random operands;
- ``ops/lockstep.run_batch`` (the plain loop on CPU tensors) against
  ``mythril_tpu.ops.lockstep.run_batch`` on seeded random programs and on
  the gauntlet (``contracts.lockstep_gauntlet``): every ``EVMState``
  field, the visited bitmaps, the loop count and the cause histogram;
- ``ops/csrc/lockstep.cu`` built as host C++ with g++ (``lockstep_host``:
  the kernel's own step, division and exponent on an emulated group of 8
  threads) against the plain loop on the same cases, through the
  wrapper's own arguments (``check_state``, ``launch_args``); its
  division by 32-bit digits and its exponent (``lockstep_host_binop``)
  against ``mythril_tpu.ops.u256`` on edge, random and add-back operands;
- the wrapper's checks, which raise before any library is loaded;
- the dispatcher pre-split's plans against the JAX package's.

Every comparison is exact (bit-equal): the interpreter is integer logic
on 32-bit limbs.  The random programs fit one code bucket (256), so the
JAX runners compile a few times only.
"""

import ctypes
import importlib.util
import os
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


def build_host(source: str, lib_path) -> ctypes.CDLL:
    """``source`` (``lockstep.cu`` or a variant of it) built as host C++
    (``lockstep_host``: the kernel's lane walk on an emulated group of 8
    threads), bound with ctypes."""
    subprocess.run(["g++", "-O2", "-std=c++17", "-x", "c++", "-shared",
                    "-fPIC", "-o", str(lib_path), source],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.lockstep_host.argtypes = [ptr, ptr, c_int, c_int] + [ptr] * (
        len(PL.EVMState._fields) + len(PL.OUT_FIELDS) + 2) + [c_int] * 4
    lib.lockstep_host.restype = c_int
    lib.lockstep_host_binop.argtypes = [c_int, ptr, ptr, c_int, ptr]
    lib.lockstep_host_binop.restype = ctypes.c_long
    lib.lockstep_smem_bytes.argtypes = [c_int] * 3
    lib.lockstep_smem_bytes.restype = c_int
    arenas = (ctypes.c_int * 3)()
    lib.lockstep_arenas(arenas)
    assert tuple(arenas) == (PL.STACK_SLOTS, PL.MEMORY_BYTES,
                             PL.STORAGE_SLOTS)
    return lib


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``lockstep.cu`` built as host C++."""
    return build_host(PL.SOURCE, tmp_path_factory.mktemp("lockstep")
                      / "liblockstep_host.so")


def _run_host(lib, code, state, max_steps, record_visited=True):
    """The host build's launch on ``state`` through the wrapper's own
    checks and arguments."""
    program = PL.prepare_program(code)
    out, visited, count, args = PL.launch_args(
        program, state, PL.check_state(state), max_steps, record_visited)
    fault = lib.lockstep_host(*args)
    assert fault == 0, "a group-uniform value differed across the limbs"
    return out, visited, int(count.item())


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


def test_shared_memory_rule_stages_programs_of_4096_bytes_or_less(
        host_kernel):
    """A block's shared memory (``lockstep_smem_bytes``, held against the
    card before each launch): the state at int64 limbs with the pops
    table (12,720 B), the calldata arena and the visited words in fours; a
    program whose bucket
    is 4,096 bytes or less is staged with its JUMPDEST bits (bucket +
    bucket / 8), a larger one, as the oversized fixture's, is read from
    global memory."""
    smem = host_kernel.lockstep_smem_bytes
    state = 12720
    assert smem(64, 0, 256) == state + 64 + 16 + 256 + 32
    assert smem(256, 65, 2048) == state + 256 + 4 * 68 + 2048 + 256
    assert smem(128, 129, 4096) == state + 128 + 4 * 132 + 4096 + 512
    assert smem(128, 257, 8192) == state + 128 + 4 * 260
    oversized = PL.prepare_program(bytes.fromhex(contracts.fixture(
        "oversized")))
    bucket = len(oversized.code)
    words = PL._visited_words(bucket)
    assert bucket == 131072
    assert smem(64, words, bucket) == state + 64 + 4 * ((words + 3) & ~3)


def test_kernel_wrapper_raises_without_a_card(monkeypatch):
    """A state on the card goes to the kernel and nowhere else: with no
    library to load, ``run_batch`` raises rather than run the plain loop
    (the card is a stand-in: the state on the ``meta`` device, which
    passes the wrapper's layout checks)."""
    state = PL.init_state(2, np.zeros((2, 4), np.uint8), [4, 4],
                          device="cpu")

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(PL, "load_library", no_library)
    monkeypatch.setattr(PL, "run_plain", None)
    fake = PL.EVMState(*(t.to("meta") for t in state))
    PL.reset_launch_count()
    with pytest.raises(RuntimeError, match="nvcc"):
        PL.run_batch(b"\x00", fake)
    assert PL.launch_count == 0


# ------------------------------------- the kernel's division and exponent

MASK32 = (1 << 32) - 1


def _limbs_of(x, n=8):
    return [(x >> (32 * i)) & MASK32 for i in range(n)]


def knuth_divide(a: int, b: int) -> tuple:
    """``(a // b, a % b, add-back steps)`` by Knuth's Algorithm D with
    32-bit digits (TAOCP vol. 2, 4.3.1; the kernel's division, whose
    whole limb shift leaves every estimate and add-back as they are
    here), for 256-bit ``a`` and ``b`` of two limbs or more."""
    limbs = _limbs_of(b)
    n = max(i + 1 for i in range(8) if limbs[i])
    s = 32 - limbs[n - 1].bit_length()
    vn, un, v = _limbs_of(b << s, n), _limbs_of(a << s, 9), b << s
    count, q = 0, 0
    for j in range(8 - n, -1, -1):
        qhat, rhat = divmod((un[j + n] << 32) | un[j + n - 1], vn[n - 1])
        while qhat > MASK32 or qhat * vn[n - 2] > (rhat << 32) + un[j + n - 2]:
            qhat, rhat = qhat - 1, rhat + vn[n - 1]
            if rhat > MASK32:
                break
        window = sum(un[j + i] << (32 * i) for i in range(n + 1))
        if window < qhat * v:
            count, qhat = count + 1, qhat - 1
        window -= qhat * v
        un[j:j + n + 1] = _limbs_of(window, n + 1)
        q |= qhat << (32 * j)
    r = sum(un[i] << (32 * i) for i in range(n)) >> s
    return q, r, count


def knuth_addbacks(a: int, b: int) -> int:
    """The add-back steps of the kernel's division of ``a`` by ``b`` (none
    for a zero or one-limb divisor: short division)."""
    return knuth_divide(a, b)[2] if b >> 32 else 0


def addback_operands(seed=7, want=6, tries=20000):
    """Seeded operand pairs on which the division adds back, ``want`` of
    each kind: divisors of 2 to 8 limbs, and divisors of 8 limbs whose
    top limb is below 2^31 (the add-back's carry then reaches the
    remainder through the normalisation shift).  Their words' limbs are
    drawn mostly from the digit edges: random operands reach the step
    about 2 in 2^32 times."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, 2, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, MASK32 - 1,
             MASK32]

    def word(n):
        return sum((edges[int(rng.integers(len(edges)))]
                    if rng.random() < 0.7 else int(rng.integers(0, 1 << 32)))
                   << (32 * i) for i in range(n))

    def short_top():
        top = int(rng.choice([1, 2, (1 << 31) - 1, 0]))
        return top or int(rng.integers(1, 1 << 31))

    out = []
    for kind in range(2):
        found = 0
        for _ in range(tries):
            a = word(8)
            b = (word(int(rng.integers(2, 9))) if kind == 0
                 else word(7) | short_top() << 224)
            if b and knuth_addbacks(a, b):
                out.append((a, b))
                found += 1
                if found == want:
                    break
    return out


def division_operands(seed=13):
    """The division's cases: every pair of ``EDGES``; seeded random words
    of random bit lengths; divisors whose top limb needs a normalisation
    shift of 0 and of 31 bits; one-limb divisors; divisors longer than
    the dividend; and the add-back pairs."""
    rng = np.random.default_rng(seed)

    def rand(bits):
        return int.from_bytes(rng.bytes(32), "big") >> (256 - bits)

    pairs = [(x, y) for x in EDGES for y in EDGES]
    for _ in range(64):
        pairs.append((rand(int(rng.integers(1, 257))),
                      rand(int(rng.integers(1, 257)))))
    for limbs in range(1, 9):
        top = 32 * (limbs - 1)
        pairs += [(rand(256), (1 << (top + 31)) | rand(top)),  # shift 0
                  (rand(256), (1 << top) | rand(top)),         # shift 31
                  (rand(32 * limbs - 16), rand(32 * limbs))]   # divisor longer
    pairs += [(rand(256), int(rng.integers(1, 1 << 32))) for _ in range(8)]
    pairs += addback_operands()
    return pairs


BINOPS = {
    "udiv": (0x04, lambda a, b: JU.udivmod(a, b)[0]),
    "umod": (0x06, lambda a, b: JU.udivmod(a, b)[1]),
    "sdiv": (0x05, JU.sdiv),
    "smod": (0x07, JU.smod),
    "exp": (0x0A, JU.exp),
}


def test_addback_operands_reach_the_addback_step():
    """The Python model finds add-back pairs, and divides right: its
    quotient and remainder are Python's on every pair of the division's
    cases."""
    pairs = addback_operands()
    assert len(pairs) == 12
    assert all(knuth_addbacks(a, b) >= 1 for a, b in pairs)
    for a, b in division_operands():
        if b >> 32:
            assert knuth_divide(a, b)[:2] == (a // b, a % b)


@pytest.mark.parametrize("name", sorted(BINOPS))
def test_kernel_division_and_exp_match_jax(name, host_kernel):
    """The kernel's own DIV, MOD, SDIV, SMOD (Algorithm D by 32-bit
    digits) and EXP, run by the host build on the emulated group, equal
    the JAX package's u256 bit for bit; the division takes the add-back
    step on the pairs built to reach it."""
    import jax.numpy as jnp

    op, jax_fn = BINOPS[name]
    pairs = division_operands()
    if name == "exp":
        pairs = pairs[: len(EDGES) ** 2 + 64]  # every bit length once
    a = _words([p[0] for p in pairs])
    b = _words([p[1] for p in pairs])
    want = np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b))).astype(np.uint32)
    got = np.zeros_like(a)
    addbacks = host_kernel.lockstep_host_binop(
        op, a.ctypes.data, b.ctypes.data, len(pairs), got.ctypes.data)
    assert addbacks >= 0, "a group-uniform value differed across the limbs"
    np.testing.assert_array_equal(got, want)
    if name != "exp":
        assert addbacks >= 1
    if name in ("udiv", "umod"):
        assert addbacks == sum(knuth_addbacks(x, y) for x, y in pairs)


def test_host_build_leaves_the_input_state_unchanged(host_kernel):
    """The kernel writes fresh tensors: after a launch the input state
    holds what it held before, and the output's read-only fields are the
    input's own tensors, as ``run_plain``'s are."""
    code = bytes.fromhex(contracts.lockstep_gauntlet())
    calldata, sizes, value, caller, keys, vals = _inputs(16, seed=3)
    state = PL.init_state(16, calldata, sizes, value, caller, keys, vals,
                          device="cpu")
    before = [t.clone() for t in state]
    out, _visited, steps = _run_host(host_kernel, code, state, 512)
    assert steps > 0
    for name, t, t0 in zip(PL.EVMState._fields, state, before):
        assert torch.equal(t, t0), name
    for name in PL.EVMState._fields:
        shared = getattr(out, name) is getattr(state, name)
        assert shared == (name not in PL.OUT_FIELDS), name
    assert not torch.equal(out.stack, state.stack)


def _bad_states():
    state = PL.init_state(4, np.zeros((4, 36), np.uint8), [36] * 4,
                          device="cpu")
    wide = torch.zeros((4, STORAGE_COLUMNS), dtype=torch.bool)
    return {
        "stack int32": state._replace(stack=state.stack.to(torch.int32)),
        "sused uint8": state._replace(sused=state.sused.to(torch.uint8)),
        "memory int64": state._replace(memory=state.memory.long()),
        "pc int64": state._replace(pc=state.pc.long()),
        "stack transposed": state._replace(
            stack=state.stack.transpose(1, 2).contiguous().transpose(1, 2)),
        "sused a column view": state._replace(sused=wide[:, ::2]),
        "skeys misaligned": state._replace(
            skeys=torch.zeros(4 * 32 * 8 + 1, dtype=torch.int64)[1:].view(
                4, 32, 8)),
        "calldata arena of 40": state._replace(
            calldata=torch.zeros((4, 40), dtype=torch.uint8)),
        "caller of 4 lanes short": state._replace(caller=state.caller[:2]),
    }


STORAGE_COLUMNS = 2 * PL.STORAGE_SLOTS


@pytest.mark.parametrize("name", sorted(_bad_states()))
def test_kernel_checks_raise_before_loading(name, monkeypatch):
    """``run_kernel`` raises ValueError on a field of another dtype, shape
    or layout than the kernel takes, before it loads the library."""
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(PL, "load_library", no_load)
    bad = _bad_states()[name]
    with pytest.raises(ValueError, match="lockstep"):
        PL.run_kernel(PL.prepare_program(b"\x00"), bad, 16, True)


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


# ------------------------- the design variants of chip_tools/lockstep_times.py


def _timing_script():
    spec = importlib.util.spec_from_file_location(
        "lockstep_times", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_tools", "lockstep_times.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(_timing_script().VARIANTS))
def test_chip_tool_variants_apply_to_the_source(name):
    """Each design variant ``chip_tools/lockstep_times.py`` times on the
    card (the source under named edits) applies to the source as it is:
    every edit's text is found once and its replacement lands (that
    script holds each variant's launches against the plain loop on the
    card before it times them)."""
    script = _timing_script()
    edits, threads = script.VARIANTS[name]
    source = open(PL.SOURCE).read()
    variant = script.apply_edits(source, edits)
    assert variant != source
    for _old, new in edits:
        assert new in variant
    assert threads in (8, 32)
    with pytest.raises(RuntimeError, match="not found once"):
        script.apply_edits(variant, [(edits[0][1] + "\n#missing", "")])
