"""The lockstep batched EVM interpreter: whole lane batches of concrete
EVM state stepped together (own copy of ``mythril_tpu/ops/lockstep.py``).

Machine state is struct-of-arrays over a lane batch, in the JAX
package's layout, with each 32-bit limb held in ``u256.DTYPE`` (int64):

- ``stack``:  int64[B, 64, 8]  (256-bit words, 8 limbs, LSW first)
- ``sp/pc``:  int32[B]
- ``memory``: uint8[B, 4096]   (byte-addressed, fixed arena)
- ``storage``: associative key/val int64[B, 32, 8] + bool[B, 32] used
- ``halt``:   int32[B]         (0 run, 1 stop, 2 return, 3 revert,
                                4 exception, 5 needs-host)

:func:`run_batch` runs every lane to a halt or the step cap.  On the
card it is one launch of the hand-written sm_90a kernel
``csrc/lockstep.cu`` (each lane loops on its own: lanes are
independent), which reads the state's tensors as they are and writes a
fresh state, and one read of the loop count; for CPU tensors it runs
:func:`plain_step` in a loop, the JAX package's ``make_step`` in eager
torch.  Ops that need host services
(KECCAK, calls, logs, ...) and arena limits halt a lane NEEDS_HOST with
a packed ``(reason << 8) | opcode`` cause.
"""

import ctypes
import functools
import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from mythril_tpu_torch.ops import default_device, u256
from mythril_tpu_torch.ops.dense_sweep import BUILD_DIR, build_cuda_library

STACK_SLOTS = 64
MEMORY_BYTES = 4096
STORAGE_SLOTS = 32

RUNNING, STOPPED, RETURNED, REVERTED, ERROR, NEEDS_HOST = 0, 1, 2, 3, 4, 5

# why a lane halted NEEDS_HOST, packed per lane as (reason << 8) | opcode:
# an arena limit (fixable by sizing) or an unsupported opcode
CAUSE_NONE, CAUSE_MEM_OOB, CAUSE_STORAGE_FULL, CAUSE_UNSUPPORTED = 0, 1, 2, 3

_CAUSE_NAMES = {
    CAUSE_NONE: "none",
    CAUSE_MEM_OOB: "mem-arena-oob",
    CAUSE_STORAGE_FULL: "storage-arena-full",
    CAUSE_UNSUPPORTED: "unsupported-op",
}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "ops", "csrc", "lockstep.cu")
LIBRARY = os.path.join(BUILD_DIR, "liblockstep.so")

#: kernel launches since the last reset (the wrapper adds one per launch
#: and nowhere else)
launch_count = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
#: (seconds, compiler output) of this process's build, when it built
build_info: Optional[tuple] = None


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def decode_cause(value) -> tuple:
    """One packed per-lane boundary cause -> (reason name, opcode)."""
    value = int(value)
    return _CAUSE_NAMES.get(value >> 8, "none"), value & 0xFF


def cause_histogram(state) -> dict:
    """NEEDS_HOST lanes bucketed by decoded cause:
    {"mem-arena-oob@0x51": count, ...}."""
    halt = state.halt.cpu().numpy()
    cause = state.cause.cpu().numpy()
    out: dict = {}
    for lane in np.nonzero(halt == NEEDS_HOST)[0]:
        reason, opcode = decode_cause(cause[lane])
        key = f"{reason}@0x{opcode:02x}"
        out[key] = out.get(key, 0) + 1
    return out


class Program(NamedTuple):
    """Host-prepared shared bytecode: code zero-padded to a power-of-two
    bucket, and JUMPDEST validity."""

    code: np.ndarray        # uint8[bucket]
    jumpdest: np.ndarray    # bool[bucket]
    length: int


def _bucket_len(n: int) -> int:
    size = 256
    while size < n:
        size *= 2
    return size


@functools.lru_cache(maxsize=64)
def prepare_program(code: bytes) -> Program:
    arr = np.frombuffer(code, dtype=np.uint8)
    bucket = _bucket_len(len(arr) + 33)
    valid = np.zeros(bucket, dtype=bool)
    i = 0
    while i < len(arr):
        op = int(arr[i])
        if op == 0x5B:
            valid[i] = True
        i += 33 - 32 + (op - 0x5F) if 0x60 <= op <= 0x7F else 1
    padded = np.zeros(bucket, dtype=np.uint8)
    padded[: len(arr)] = arr
    return Program(padded, valid, len(arr))


class EVMState(NamedTuple):
    stack: torch.Tensor         # int64[B, S, 8]
    sp: torch.Tensor            # int32[B]
    pc: torch.Tensor            # int32[B]
    memory: torch.Tensor        # uint8[B, M]
    skeys: torch.Tensor         # int64[B, K, 8]
    svals: torch.Tensor         # int64[B, K, 8]
    sused: torch.Tensor         # bool[B, K]
    calldata: torch.Tensor      # uint8[B, C]
    calldatasize: torch.Tensor  # int32[B]
    callvalue: torch.Tensor     # int64[B, 8]
    caller: torch.Tensor        # int64[B, 8]
    halt: torch.Tensor          # int32[B]
    ret_off: torch.Tensor       # int32[B]
    ret_len: torch.Tensor       # int32[B]
    cause: torch.Tensor         # int32[B] ((reason << 8) | opcode)


def _limb_tensor(value, batch: int, dev) -> torch.Tensor:
    if value is None:
        return torch.zeros((batch, u256.NUM_LIMBS), dtype=u256.DTYPE,
                           device=dev)
    if isinstance(value, torch.Tensor):
        return value.to(dev, u256.DTYPE)
    return torch.from_numpy(np.asarray(value).astype(np.int64)).to(dev)


def init_state(batch: int, calldata, calldatasize, callvalue=None,
               caller=None, storage_keys=None, storage_vals=None,
               device=None) -> EVMState:
    """Fresh state of ``batch`` lanes on ``device`` (the card when None);
    ``calldata`` uint8[B, C], padded to a power-of-two arena of at least
    C + 32 bytes (so a 32-byte window at any in-size offset stays inside
    it); ``callvalue``/``caller`` [B, 8] limbs; ``storage_keys`` /
    ``storage_vals`` [B, n, 8] limbs of preloaded slots."""
    dev = default_device(device)
    B = batch
    calldata = np.asarray(calldata, np.uint8)
    arena = 64
    while arena < calldata.shape[1] + 32:
        arena *= 2
    calldata = np.concatenate(
        [calldata, np.zeros((B, arena - calldata.shape[1]), np.uint8)],
        axis=1)
    skeys = np.zeros((B, STORAGE_SLOTS, 8), np.int64)
    svals = np.zeros((B, STORAGE_SLOTS, 8), np.int64)
    sused = np.zeros((B, STORAGE_SLOTS), bool)
    if storage_keys is not None:
        n = storage_keys.shape[1]
        skeys[:, :n] = np.asarray(storage_keys)
        svals[:, :n] = np.asarray(storage_vals)
        sused[:, :n] = True

    def i32(x):
        return torch.zeros(B, dtype=torch.int32, device=dev) if x is None \
            else torch.as_tensor(np.asarray(x, np.int32), device=dev)

    return EVMState(
        stack=torch.zeros((B, STACK_SLOTS, 8), dtype=u256.DTYPE, device=dev),
        sp=i32(None),
        pc=i32(None),
        memory=torch.zeros((B, MEMORY_BYTES), dtype=torch.uint8, device=dev),
        skeys=torch.from_numpy(skeys).to(dev),
        svals=torch.from_numpy(svals).to(dev),
        sused=torch.from_numpy(sused).to(dev),
        calldata=torch.from_numpy(calldata).to(dev),
        calldatasize=i32(calldatasize),
        callvalue=_limb_tensor(callvalue, B, dev),
        caller=_limb_tensor(caller, B, dev),
        halt=i32(None),
        ret_off=i32(None),
        ret_len=i32(None),
        cause=i32(None),
    )


# stack items popped per opcode (0 where not meaningful): the underflow
# guard
_POPS_TABLE = np.zeros(256, dtype=np.int32)
for _oc, _n in {
    0x01: 2, 0x02: 2, 0x03: 2, 0x04: 2, 0x05: 2, 0x06: 2, 0x07: 2,
    0x0A: 2, 0x10: 2, 0x11: 2, 0x12: 2, 0x13: 2, 0x14: 2, 0x15: 1,
    0x16: 2, 0x17: 2, 0x18: 2, 0x19: 1, 0x1B: 2, 0x1C: 2, 0x1D: 2,
    0x35: 1, 0x50: 1, 0x51: 1, 0x52: 2, 0x53: 2, 0x54: 1, 0x55: 2,
    0x56: 1, 0x57: 2, 0xF3: 2, 0xFD: 2,
}.items():
    _POPS_TABLE[_oc] = _n
for _k in range(16):
    _POPS_TABLE[0x80 + _k] = _k + 1   # DUPn needs n items
    _POPS_TABLE[0x90 + _k] = _k + 2   # SWAPn needs n+1 items


# ---------------------------------------------------------------------------
# the plain step (the JAX package's make_step, in eager torch)
# ---------------------------------------------------------------------------


def _i32(limb):
    """A limb read as int32, as ``astype(int32)`` does: two's-complement
    wrap (2^31 and more turn negative)."""
    return torch.where(limb >= 1 << 31, limb - (1 << 32), limb)


def _high(word):
    """Any limb above limb 0 set."""
    return torch.any(word[..., 1:] != 0, dim=-1)


def _word_exceeds(word, limit: int):
    """The 256-bit word exceeds ``limit`` (< 2^32)."""
    return _high(word) | (word[..., 0] > limit)


def _cmp_to_word(flag):
    word = torch.zeros(flag.shape + (8,), dtype=u256.DTYPE,
                       device=flag.device)
    word[..., 0] = flag.to(u256.DTYPE)
    return word


def _gather32(arena, offset):
    """32 bytes a lane at byte offsets clamped to the arena."""
    offset = offset.clamp(0, arena.shape[1] - 32).long()
    idx = offset[:, None] + torch.arange(32, device=arena.device)
    return torch.gather(arena, 1, idx)


def _scatter32(arena, offset, data, mask):
    offset = offset.clamp(0, arena.shape[1] - 32).long()
    idx = offset[:, None] + torch.arange(32, device=arena.device)
    new = torch.where(mask[:, None], data, torch.gather(arena, 1, idx))
    return arena.scatter(1, idx, new)


class _Step:
    """One step's view of the batch: the opcode a lane, the program, and
    the masked update helpers every handler shares."""

    def __init__(self, op, rows, code, jumpdest, code_len):
        self.op = op
        self.rows = rows
        self.code = code
        self.jumpdest = jumpdest
        self.code_len = code_len

    def peek(self, s, depth):
        idx = (s.sp.long() - 1 - depth).clamp(0, STACK_SLOTS - 1)
        return s.stack[self.rows, idx]

    def set_at(self, stack, idx, value, mask):
        idx = idx.long().clamp(0, STACK_SLOTS - 1)
        old = stack[self.rows, idx]
        return stack.index_put((self.rows, idx),
                               torch.where(mask[:, None], value, old))

    def park(self, s, newly, reason):
        """Halt ``newly`` lanes NEEDS_HOST with the packed cause."""
        return s._replace(
            halt=torch.where(newly, NEEDS_HOST, s.halt),
            cause=torch.where(newly, (reason << 8) | self.op, s.cause),
        )

    def binop(self, s, mask, fn):
        """pop a, b; push fn(a, b)."""
        result = fn(self.peek(s, 0), self.peek(s, 1))
        return s._replace(
            stack=self.set_at(s.stack, s.sp - 2, result, mask),
            sp=torch.where(mask, s.sp - 1, s.sp),
            pc=torch.where(mask, s.pc + 1, s.pc),
        )

    def push(self, s, mask, value, pc_next):
        """push ``value`` (stack overflow is an ERROR; pc moves on
        either way)."""
        overflow = s.sp >= STACK_SLOTS
        ok = mask & ~overflow
        return s._replace(
            stack=self.set_at(s.stack, s.sp, value, ok),
            sp=torch.where(ok, s.sp + 1, s.sp),
            pc=torch.where(mask, pc_next, s.pc),
            halt=torch.where(mask & overflow, ERROR, s.halt),
        )


    def jump_valid(self, dest_word):
        dest = _i32(dest_word[..., 0])
        valid = (~_high(dest_word) & (dest >= 0) & (dest < self.code_len)
                 & self.jumpdest[dest.clamp(0, self.jumpdest.shape[0] - 1)])
        return dest.to(torch.int32), valid


def h_stop(x, s, mask, present):
    return s._replace(halt=torch.where(mask, STOPPED, s.halt))


_ARITH = (
    (0x01, u256.add), (0x03, u256.sub), (0x16, u256.bit_and),
    (0x17, u256.bit_or), (0x18, u256.bit_xor),
    (0x10, lambda a, b: _cmp_to_word(u256.ult(a, b))),
    (0x11, lambda a, b: _cmp_to_word(u256.ult(b, a))),
    (0x12, lambda a, b: _cmp_to_word(u256.slt(a, b))),
    (0x13, lambda a, b: _cmp_to_word(u256.slt(b, a))),
    (0x14, lambda a, b: _cmp_to_word(u256.eq(a, b))),
)
_DIV = (
    (0x04, lambda a, b: u256.udivmod(a, b)[0]),
    (0x05, u256.sdiv),
    (0x06, lambda a, b: u256.udivmod(a, b)[1]),
    (0x07, u256.smod),
)


def _sub_ops(table):
    def handler(x, s, mask, present):
        for oc, fn in table:
            if present[oc]:
                s = x.binop(s, mask & (x.op == oc), fn)
        return s
    return handler


h_arith = _sub_ops(_ARITH)
h_div = _sub_ops(_DIV)


def h_mul(x, s, mask, present):
    return x.binop(s, mask, u256.mul)


def h_exp(x, s, mask, present):
    return x.binop(s, mask, u256.exp)


def h_shift(x, s, mask, present):
    def shift_fn(a, b):
        # top = the shift amount (a whole word), second = the value
        return torch.where(
            (x.op == 0x1B)[:, None], u256.shl_wide(b, a),
            torch.where((x.op == 0x1C)[:, None], u256.lshr_wide(b, a),
                        u256.sar_wide(b, a)))
    return x.binop(s, mask, shift_fn)


def h_unary(x, s, mask, present):
    a = x.peek(s, 0)
    result = torch.where((x.op == 0x15)[:, None],
                         _cmp_to_word(u256.is_zero(a)), u256.bit_not(a))
    return s._replace(stack=x.set_at(s.stack, s.sp - 1, result, mask),
                      pc=torch.where(mask, s.pc + 1, s.pc))


def h_push(x, s, mask, present):
    n = (x.op - 0x5F).clamp(0, 32)
    start = (s.pc + 1).clamp(0, x.code.shape[0] - 32).long()
    window = x.code[start[:, None] + torch.arange(32, device=x.code.device)]
    value = u256.lshr(u256.bytes_to_limbs(window), ((32 - n) * 8).long())
    return x.push(s, mask, value, s.pc + 1 + n)


def h_dup(x, s, mask, present):
    k = (x.op - 0x80).clamp(0, 15)
    return x.push(s, mask, x.peek(s, k), s.pc + 1)


def h_swap(x, s, mask, present):
    k = (x.op - 0x8F).clamp(1, 16)
    top = x.peek(s, 0)
    deep = x.peek(s, k)
    stack = x.set_at(s.stack, s.sp - 1, deep, mask)
    stack = x.set_at(stack, s.sp - 1 - k, top, mask)
    return s._replace(stack=stack, pc=torch.where(mask, s.pc + 1, s.pc))


def h_pop(x, s, mask, present):
    return s._replace(sp=torch.where(mask, s.sp - 1, s.sp),
                      pc=torch.where(mask, s.pc + 1, s.pc))


def h_jump(x, s, mask, present):
    dest, valid = x.jump_valid(x.peek(s, 0))
    return s._replace(
        sp=torch.where(mask, s.sp - 1, s.sp),
        pc=torch.where(mask & valid, dest, s.pc),
        halt=torch.where(mask & ~valid, ERROR, s.halt),
    )


def h_jumpi(x, s, mask, present):
    dest, valid = x.jump_valid(x.peek(s, 0))
    taken = ~u256.is_zero(x.peek(s, 1))
    return s._replace(
        sp=torch.where(mask, s.sp - 2, s.sp),
        pc=torch.where(mask & taken & valid, dest,
                       torch.where(mask, s.pc + 1, s.pc)),
        halt=torch.where(mask & taken & ~valid, ERROR, s.halt),
    )


def h_jumpdest(x, s, mask, present):
    return s._replace(pc=torch.where(mask, s.pc + 1, s.pc))


def h_pc_op(x, s, mask, present):
    return x.push(s, mask, _cmp_to_word(s.pc.to(u256.DTYPE)), s.pc + 1)


def h_mload(x, s, mask, present):
    word = x.peek(s, 0)
    oob = _word_exceeds(word, MEMORY_BYTES - 32)
    ok = mask & ~oob
    value = u256.bytes_to_limbs(_gather32(s.memory, _i32(word[..., 0])))
    s = s._replace(stack=x.set_at(s.stack, s.sp - 1, value, ok),
                   pc=torch.where(ok, s.pc + 1, s.pc))
    return x.park(s, mask & oob, CAUSE_MEM_OOB)


def h_mstore(x, s, mask, present):
    word = x.peek(s, 0)
    oob = _word_exceeds(word, MEMORY_BYTES - 32)
    ok = mask & ~oob
    data = u256.limbs_to_bytes(x.peek(s, 1))
    s = s._replace(
        memory=_scatter32(s.memory, _i32(word[..., 0]), data, ok),
        sp=torch.where(ok, s.sp - 2, s.sp),
        pc=torch.where(ok, s.pc + 1, s.pc),
    )
    return x.park(s, mask & oob, CAUSE_MEM_OOB)


def h_mstore8(x, s, mask, present):
    word = x.peek(s, 0)
    oob = _word_exceeds(word, MEMORY_BYTES - 1)
    ok = mask & ~oob
    off = _i32(word[..., 0]).clamp(0, MEMORY_BYTES - 1)
    value = (x.peek(s, 1)[..., 0] & 0xFF).to(torch.uint8)
    old = s.memory[x.rows, off]
    s = s._replace(
        memory=s.memory.index_put((x.rows, off),
                                  torch.where(ok, value, old)),
        sp=torch.where(ok, s.sp - 2, s.sp),
        pc=torch.where(ok, s.pc + 1, s.pc),
    )
    return x.park(s, mask & oob, CAUSE_MEM_OOB)


def _hits(s, key):
    return torch.all(s.skeys == key[:, None, :], dim=-1) & s.sused


def _first(flags):
    """Index of the first True a row (0 when none), as ``argmax``."""
    return torch.argmax(flags.to(torch.int8), dim=-1)


def h_sload(x, s, mask, present):
    hits = _hits(s, x.peek(s, 0))
    found = torch.any(hits, dim=-1)
    value = torch.where(found[:, None], s.svals[x.rows, _first(hits)], 0)
    return s._replace(stack=x.set_at(s.stack, s.sp - 1, value, mask),
                      pc=torch.where(mask, s.pc + 1, s.pc))


def h_sstore(x, s, mask, present):
    key = x.peek(s, 0)
    value = x.peek(s, 1)
    hits = _hits(s, key)
    found = torch.any(hits, dim=-1)
    full = torch.all(s.sused, dim=-1) & ~found
    idx = torch.where(found, _first(hits), _first(~s.sused))
    write = mask & ~full
    at = (x.rows, idx)
    s = s._replace(
        skeys=s.skeys.index_put(
            at, torch.where(write[:, None], key, s.skeys[at])),
        svals=s.svals.index_put(
            at, torch.where(write[:, None], value, s.svals[at])),
        sused=s.sused.index_put(at, write | s.sused[at]),
        sp=torch.where(mask, s.sp - 2, s.sp),
        pc=torch.where(mask, s.pc + 1, s.pc),
    )
    return x.park(s, mask & full, CAUSE_STORAGE_FULL)


def h_env(x, s, mask, present):
    value = torch.where(
        (x.op == 0x33)[:, None], s.caller,
        torch.where((x.op == 0x34)[:, None], s.callvalue, 0))
    size_word = _cmp_to_word(s.calldatasize.to(u256.DTYPE) & u256.MASK32)
    value = torch.where((x.op == 0x36)[:, None], size_word, value)
    return x.push(s, mask, value, s.pc + 1)


def h_calldataload(x, s, mask, present):
    word = x.peek(s, 0)
    size = s.calldatasize.to(u256.DTYPE)
    # any read at or past calldatasize yields zero, high limbs included
    beyond = _high(word) | (word[..., 0] >= (size & u256.MASK32))
    off = _i32(word[..., 0])
    window = _gather32(s.calldata, off)
    positions = (off.clamp(0, s.calldata.shape[1] - 32)[:, None]
                 + torch.arange(32, device=off.device))
    in_range = (positions < size[:, None]) & ~beyond[:, None]
    value = u256.bytes_to_limbs(torch.where(in_range, window, 0))
    return s._replace(stack=x.set_at(s.stack, s.sp - 1, value, mask),
                      pc=torch.where(mask, s.pc + 1, s.pc))


def h_return(x, s, mask, present):
    off = _i32(x.peek(s, 0)[..., 0]).to(torch.int32)
    length = _i32(x.peek(s, 1)[..., 0]).to(torch.int32)
    code = torch.where(x.op == 0xF3, RETURNED, REVERTED).to(torch.int32)
    return s._replace(
        halt=torch.where(mask, code, s.halt),
        ret_off=torch.where(mask, off, s.ret_off),
        ret_len=torch.where(mask, length, s.ret_len),
    )


#: the handler groups, in the JAX step's order: (opcodes, handler)
GROUPS = (
    ((0x00,), h_stop),
    ((0x01, 0x03, 0x10, 0x11, 0x12, 0x13, 0x14, 0x16, 0x17, 0x18), h_arith),
    ((0x02,), h_mul),
    ((0x04, 0x05, 0x06, 0x07), h_div),
    ((0x0A,), h_exp),
    ((0x1B, 0x1C, 0x1D), h_shift),
    ((0x15, 0x19), h_unary),
    (tuple(range(0x5F, 0x80)), h_push),
    (tuple(range(0x80, 0x90)), h_dup),
    (tuple(range(0x90, 0xA0)), h_swap),
    ((0x50,), h_pop),
    ((0x56,), h_jump),
    ((0x57,), h_jumpi),
    ((0x5B,), h_jumpdest),
    ((0x58,), h_pc_op),
    ((0x51,), h_mload),
    ((0x52,), h_mstore),
    ((0x53,), h_mstore8),
    ((0x54,), h_sload),
    ((0x55,), h_sstore),
    ((0x33, 0x34, 0x36), h_env),
    ((0x35,), h_calldataload),
    ((0xF3, 0xFD), h_return),
)
_GROUP_OF = np.full(256, -1, dtype=np.int64)
for _g, (_ops, _h) in enumerate(GROUPS):
    _GROUP_OF[list(_ops)] = _g
#: opcode -> its group (len(GROUPS): no handler, parks UNSUPPORTED)
_GROUP_OF[_GROUP_OF < 0] = len(GROUPS)

_TABLES = {}


def _tables(dev):
    """The pops and group tables on ``dev``."""
    tables = _TABLES.get(dev)
    if tables is None:
        tables = _TABLES[dev] = (torch.from_numpy(_POPS_TABLE).to(dev),
                                 torch.from_numpy(_GROUP_OF).to(dev))
    return tables


def plain_step(state: EVMState, code, jumpdest, code_len: int) -> EVMState:
    """One step of every running lane (the JAX package's ``make_step``):
    ``code`` uint8[bucket] and ``jumpdest`` bool[bucket] on the state's
    device.  A handler group runs only when some lane selects it."""
    pops, group_of = _tables(code.device)
    rows = torch.arange(state.sp.shape[0], device=code.device)
    pc = state.pc.clamp(0, code.shape[0] - 1).long()
    op = torch.where(state.pc >= code_len, 0, code[pc].to(torch.int32))
    # the stack-underflow check runs before dispatch
    bad = (state.halt == RUNNING) & (state.sp < pops[op.long()])
    state = state._replace(halt=torch.where(bad, ERROR, state.halt))
    live = state.halt == RUNNING
    present = torch.bincount(op[live].long(), minlength=256).cpu().numpy()
    groups_present = np.bincount(_GROUP_OF, weights=present,
                                 minlength=len(GROUPS) + 1)
    x = _Step(op, rows, code, jumpdest, code_len)
    group = group_of[op.long()]
    for g, (_ops, handler) in enumerate(GROUPS):
        if groups_present[g]:
            state = handler(x, state, live & (group == g), present)
    if groups_present[len(GROUPS)]:
        state = x.park(state, live & (group == len(GROUPS)),
                       CAUSE_UNSUPPORTED)
    return state


def _visited_words(bucket: int) -> int:
    return bucket // 32 + 1


def run_plain(program: Program, state: EVMState, max_steps: int,
              record_visited: bool, observe=None):
    """The plain version of the kernel: :func:`plain_step` until no lane
    runs or ``max_steps``.  Returns ``(state, visited, steps)``:
    ``visited`` int64[B, bucket/32 + 1] (or [B, 1] unrecorded) bitmaps
    of the pcs each lane executed, ``steps`` the loop count.
    ``observe(state, code)``, when given, sees the state before each
    step (the chip check counts the executed opcodes with it)."""
    dev = state.pc.device
    code = torch.from_numpy(program.code).to(dev)
    jumpdest = torch.from_numpy(program.jumpdest).to(dev)
    B = state.pc.shape[0]
    words = _visited_words(len(program.code)) if record_visited else 1
    visited = torch.zeros((B, words), dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    steps = 0
    while steps < max_steps and bool((state.halt == RUNNING).any()):
        if record_visited:
            # the pc is recorded before the step, for running lanes
            word = (state.pc >> 5).clamp(0, words - 1).long()
            bit = torch.where(state.halt == RUNNING,
                              1 << (state.pc.long() & 31), 0)
            visited = visited.index_put((rows, word), visited[rows, word] | bit)
        if observe is not None:
            observe(state, code)
        state = plain_step(state, code, jumpdest, program.length)
        steps += 1
    return state, visited, steps


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


#: ``lockstep_launch``'s return when a block's shared memory is past the
#: card's (``lockstep_smem_bytes``)
DOES_NOT_FIT = 1000


def bind(path: str) -> ctypes.CDLL:
    """Load a build of ``lockstep.cu`` and declare its entry points."""
    lib = ctypes.CDLL(path)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.lockstep_launch.argtypes = [ptr, ptr, c_int, c_int] + [ptr] * (
        len(EVMState._fields) + len(OUT_FIELDS) + 2) + [c_int] * 4 + [ptr]
    lib.lockstep_launch.restype = c_int
    lib.lockstep_smem_bytes.argtypes = [c_int, c_int, c_int]
    lib.lockstep_smem_bytes.restype = c_int
    lib.lockstep_arenas.argtypes = [ptr]
    lib.lockstep_arenas.restype = None
    arenas = (ctypes.c_int * 3)()
    lib.lockstep_arenas(arenas)
    if tuple(arenas) != (STACK_SLOTS, MEMORY_BYTES, STORAGE_SLOTS):
        raise RuntimeError("lockstep: arena layout mismatch")
    return lib


def load_library() -> ctypes.CDLL:
    global _lib, build_info
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            info = build_cuda_library(SOURCE, LIBRARY)
            if info is not None:
                build_info = info
            _lib = bind(LIBRARY)
    return _lib


#: the fields the kernel writes; its output state takes the calldata, its
#: size, the value and the caller from the input, as ``run_plain`` does
OUT_FIELDS = ("stack", "sp", "pc", "memory", "skeys", "svals", "sused",
              "halt", "ret_off", "ret_len", "cause")
#: the fields whose rows the kernel moves by bulk copies
_ALIGNED = ("stack", "memory", "skeys", "svals", "sused", "calldata",
            "callvalue", "caller")


def _layout(B: int, C: int) -> dict:
    """The dtype and shape of each field of a state the kernel takes."""
    limbs, i32 = u256.DTYPE, torch.int32
    return {
        "stack": (limbs, (B, STACK_SLOTS, 8)), "sp": (i32, (B,)),
        "pc": (i32, (B,)), "memory": (torch.uint8, (B, MEMORY_BYTES)),
        "skeys": (limbs, (B, STORAGE_SLOTS, 8)),
        "svals": (limbs, (B, STORAGE_SLOTS, 8)),
        "sused": (torch.bool, (B, STORAGE_SLOTS)),
        "calldata": (torch.uint8, (B, C)), "calldatasize": (i32, (B,)),
        "callvalue": (limbs, (B, 8)), "caller": (limbs, (B, 8)),
        "halt": (i32, (B,)), "ret_off": (i32, (B,)), "ret_len": (i32, (B,)),
        "cause": (i32, (B,)),
    }


def check_state(state: EVMState) -> tuple:
    """``(B, C)`` of a state the kernel takes as it is: every field of the
    dtype and shape of :func:`init_state`'s, on one device, contiguous,
    the rows the kernel moves 16 bytes at a time 16-byte aligned, and a
    calldata arena that is a multiple of 16 bytes.  Raises ValueError on
    anything else."""
    B = state.pc.shape[0] if state.pc.dim() == 1 else 0
    calldata = state.calldata
    C = calldata.shape[1] if calldata.dim() == 2 else 0
    if B < 1 or C < 32 or C % 16:
        raise ValueError(f"lockstep: pc {tuple(state.pc.shape)}, calldata "
                         f"{tuple(calldata.shape)} (want B >= 1 lanes and an "
                         f"arena of 32 or more bytes, a multiple of 16)")
    dev = state.pc.device
    for name, (dtype, shape) in _layout(B, C).items():
        t = getattr(state, name)
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"lockstep: {name} {t.dtype} "
                             f"{tuple(t.shape)}, want {dtype} {shape}")
        if t.device != dev:
            raise ValueError(f"lockstep: {name} on {t.device}, pc on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"lockstep: {name} is not contiguous")
        if name in _ALIGNED and t.data_ptr() % 16:
            raise ValueError(f"lockstep: {name} is not 16-byte aligned")
    return B, C


_PROGRAMS = {}


def _program_tensors(program: Program, dev):
    """The program on ``dev`` as the kernel reads it: the code zero-padded
    by 16 bytes (a PUSH window's aligned words stay inside), and the
    JUMPDEST flags as int32 words of 32 bits."""
    key = (program.code.tobytes(), program.length, dev)
    tensors = _PROGRAMS.get(key)
    if tensors is None:
        if len(_PROGRAMS) > 64:
            _PROGRAMS.clear()
        code = np.zeros(len(program.code) + 16, np.uint8)
        code[: len(program.code)] = program.code
        bits = (program.jumpdest.reshape(-1, 32).astype(np.uint64)
                << np.arange(32, dtype=np.uint64)).sum(axis=1)
        tensors = _PROGRAMS[key] = (
            torch.from_numpy(code).to(dev),
            torch.from_numpy(bits.astype(np.uint32).view(np.int32)).to(dev))
    return tensors


def launch_args(program: Program, state: EVMState, dims: tuple,
                max_steps: int, record_visited: bool):
    """The kernel's arguments for ``state`` (``lockstep_launch``'s, less
    the stream; ``lockstep_host`` of the host build takes the same), with
    ``dims`` from :func:`check_state`: ``(out, visited, count, args)``,
    the output state, visited words and loop count (int32[1], zeroed:
    the launch's lanes write their step counts into it by max) the launch
    writes, fresh tensors (the input state is left as it was)."""
    if max_steps < 0:
        raise ValueError(f"lockstep: max_steps {max_steps}")
    B, C = dims
    dev = state.pc.device
    code, jumpdest = _program_tensors(program, dev)
    bucket = len(program.code)
    words = _visited_words(bucket) if record_visited else 0
    out = state._replace(**{name: torch.empty_like(getattr(state, name))
                            for name in OUT_FIELDS})
    visited = torch.empty((B, max(words, 1)), dtype=torch.int64, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (
        code.data_ptr(), jumpdest.data_ptr(), program.length, bucket,
        *(t.data_ptr() for t in state),
        *(getattr(out, name).data_ptr() for name in OUT_FIELDS),
        visited.data_ptr(), count.data_ptr(), B, C, max_steps, words,
    )
    return out, visited, count, args


def run_kernel(program: Program, state: EVMState, max_steps: int,
               record_visited: bool):
    """:func:`run_plain`'s function as one launch of ``lockstep.cu`` on
    the state's card (same signature and results): the state's checks,
    then the launch and one read of the count."""
    global launch_count
    dims = check_state(state)
    lib = load_library()
    dev = state.pc.device
    out, visited, count, args = launch_args(program, state, dims, max_steps,
                                            record_visited)
    err = lib.lockstep_launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err == DOES_NOT_FIT:
        bucket = len(program.code)
        need = lib.lockstep_smem_bytes(dims[1], args[-1], bucket)
        raise ValueError(
            f"lockstep: a block needs {need} B of shared memory "
            f"(calldata arena {dims[1]} B, bucket {bucket}), more than "
            f"the card has")
    if err:
        raise RuntimeError(f"lockstep kernel launch failed: cudaError {err}")
    launch_count += 1
    return out, visited, int(count.item())


def run_batch(code: bytes, state: EVMState, max_steps: int = 4096,
              record_visited: bool = False):
    """Run every lane to a halt (or the step cap): one kernel launch for a
    state on the card, the plain loop for a state on the CPU.  Returns
    ``(state, steps)``, or ``(state, visited, steps)`` with the
    visited-pc bitmaps when ``record_visited``."""
    program = prepare_program(bytes(code))
    if state.pc.device.type == "cpu":
        out = run_plain(program, state, max_steps, record_visited)
    else:
        out = run_kernel(program, state, max_steps, record_visited)
    state, visited, steps = out
    if record_visited:
        return state, visited, steps
    return state, steps


def pc_visited(visited, lane: int, pc: int) -> bool:
    """Did ``lane`` execute the instruction at byte offset ``pc``?"""
    word = int(visited[lane, pc >> 5])
    return bool((word >> (pc & 31)) & 1)


def join_known_bits(kv_a, km_a, kv_b, km_b):
    """Word-tier meet of two known-bits limb planes (the veritesting join
    lattice): a bit survives only when both lanes know it and agree on
    it, ``km = km_a & km_b & ~(kv_a ^ kv_b)``, and the joined value is
    masked to the surviving knowledge.  Returns ``(kv, km,
    disagreements)``, the last the count of bits both knew but
    disagreed on."""
    kv_a = np.asarray(kv_a, dtype=np.uint32)
    kv_b = np.asarray(kv_b, dtype=np.uint32)
    km_a = np.asarray(km_a, dtype=np.uint32)
    km_b = np.asarray(km_b, dtype=np.uint32)
    both = km_a & km_b
    differ = kv_a ^ kv_b
    km = both & ~differ
    kv = kv_a & km
    disagreements = int(np.unpackbits((both & differ).view(np.uint8)).sum())
    return kv, km, disagreements
