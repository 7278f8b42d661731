"""The word tier's batched fixpoint on the card: the packed node table, the
hand-written sm_90a kernel (``csrc/word_prop.cu``) and its plain PyTorch
version.

Counterpart of the JAX package's ``jax.numpy`` word executor
(``mythril_tpu/smt/word_tier.py:402``, ``_forward`` / ``_backward`` /
``_push_bv_down`` over ``ops/word_prop.py``'s limb-plane transfers),
which the JAX package takes for a batch of 16 or more lanes on a TPU.

- :func:`lower_program` packs a compiled ``smt/word_tier._Program`` once
  into a :class:`NodeTable`: one int32 row a node (opcode, width, state
  slot, flags, argument count and offset into the argument list, two
  parameters, and by position the level schedule the kernel's forward
  passes follow), the argument list (node rows) and the constant words;
- :func:`word_fixpoint` runs the whole fixpoint (one forward pass, then
  ``rounds`` x (backward, forward)) over every lane in one kernel
  launch for CUDA tensors, and :func:`word_fixpoint_plain` for CPU
  tensors: it decodes the table and runs the word tier's own batched
  walk (``WordTier.fixpoint``) with the ported transfers, so the CPU
  tests hold the encoding against the JAX package;
- :func:`run_program` is what ``WordTier`` calls.

The kernel builds with ``nvcc`` at first use into
``mythril_tpu_torch/_build/libword_prop.so`` and is bound with ctypes.
A block holds one lane, its state in shared memory beside the node
table, and its warps share each level of a forward pass.  The library
holds the block's shared memory (``word_prop_smem_bytes``) against the
card's before it launches and refuses a program that does not fit, which
the wrapper raises; every program within the word tier's default node cap
fits, and the word tier holds a larger one against the same rule
(:func:`fits_a_block`) and runs it scalar.
"""

import ctypes
import os
import threading
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.ops.dense_sweep import BUILD_DIR, build_cuda_library

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "ops", "csrc", "word_prop.cu")
LIBRARY = os.path.join(BUILD_DIR, "libword_prop.so")

#: opcode -> op name (the order of ``enum Op`` in the source); "bite" is
#: the bool-sorted ite, "opaque" any op outside the tier's fragment
OP_NAMES = (
    "opaque", "const", "var", "add", "sub", "mul", "udiv", "urem", "and",
    "or", "xor", "not", "shl", "lshr", "ashr", "concat", "extract", "zext",
    "sext", "ite", "bconst", "bvar", "band", "bor", "bnot", "bxor", "eq",
    "ult", "ule", "slt", "sle", "bite",
)
_OP_CODE = {name: code for code, name in enumerate(OP_NAMES)}
#: the columns of a table row (``enum Col`` in the source); "sched" and
#: "level_end" are by position k: the row at position k of the nodes
#: ordered by level (a node's level is one more than its args' highest),
#: and the first position past that node's level
ENTRY_COLUMNS = ("op", "width", "slot", "flags", "nargs", "argoff", "p0",
                 "p1", "sched", "level_end")
F_OPAQUE = 1
F_BOOL = 2
#: ``word_prop_launch``'s refusal of a block that does not fit the card's
#: shared memory (``wp::kDoesNotFit``)
DOES_NOT_FIT = -1

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


class NodeTable(NamedTuple):
    """A program packed for the kernel: ``entries`` int32 [N, 8] (one
    row a node, in program order, columns :data:`ENTRY_COLUMNS`),
    ``args`` int32 [A] (row indices), ``consts`` int64 [NC, 8] (limbs),
    and the slot counts."""

    entries: torch.Tensor
    args: torch.Tensor
    consts: torch.Tensor
    n_bv: int
    n_bool: int

    def to(self, device) -> "NodeTable":
        return self._replace(entries=self.entries.to(device),
                             args=self.args.to(device),
                             consts=self.consts.to(device))


def lower_program(prog) -> NodeTable:
    """Pack a compiled word-tier program (``smt/word_tier._Program``)."""
    row_of = {node.id: k for k, node in enumerate(prog.order)}
    entries = np.zeros((max(len(prog.order), 1), len(ENTRY_COLUMNS)),
                       dtype=np.int32)
    args: List[int] = []
    consts: List[int] = []
    for k, node in enumerate(prog.order):
        row = entries[k]
        opaque = node.id in prog.opaque
        is_bool = node.sort == "bool"
        name = "bite" if is_bool and node.op == "ite" else node.op
        row[0] = _OP_CODE.get(name, 0)
        row[1] = 0 if is_bool else node.width
        row[2] = prog.bool_slot[node.id] if is_bool else prog.bv_slot[node.id]
        row[3] = (F_OPAQUE if opaque else 0) | (F_BOOL if is_bool else 0)
        if not opaque:
            row[4] = len(node.args)
            row[5] = len(args)
            args.extend(row_of[a.id] for a in node.args)
        if node.op == "const" and not is_bool:
            row[6] = len(consts)
            consts.append(node.params[0] & ((1 << 256) - 1))
        elif node.op == "extract":
            row[6], row[7] = node.params
        elif node.op == "bconst":
            row[6] = 1 if node.params[0] else 0
    _level_schedule(entries, np.asarray(args, dtype=np.int64), len(prog.order))
    const_limbs = np.zeros((max(len(consts), 1), u256.NUM_LIMBS),
                           dtype=np.int64)
    for k, value in enumerate(consts):
        const_limbs[k] = [(value >> (32 * i)) & u256.MASK32
                          for i in range(u256.NUM_LIMBS)]
    return NodeTable(
        torch.from_numpy(entries),
        torch.from_numpy(np.asarray(args or [0], dtype=np.int32)),
        torch.from_numpy(const_limbs),
        len(prog.bv_slot), len(prog.bool_slot),
    )


def _level_schedule(entries, args, n: int) -> None:
    """Fill the schedule columns: the rows ordered by level (stable), and
    for each position the end of its level."""
    level = np.zeros(max(n, 1), dtype=np.int64)
    for k in range(n):
        nargs, argoff = entries[k, 4], entries[k, 5]
        if nargs:
            level[k] = 1 + level[args[argoff:argoff + nargs]].max()
    order = np.argsort(level[:n], kind="stable")
    entries[:n, 8] = order
    ends = np.searchsorted(level[order], level[order], side="right")
    entries[:n, 9] = ends
    if n == 0:
        entries[0, 9] = 0


class _Entry:
    """A decoded table row, with the attributes of a term node that the
    word tier's walk reads."""

    __slots__ = ("id", "op", "sort", "width", "args", "params")

    @property
    def is_const(self) -> bool:
        return self.op in ("const", "bconst")


def decode_table(table: NodeTable):
    """The word-tier program a table encodes (node ids = row indices)."""
    from mythril_tpu_torch.smt.word_tier import _Program

    entries = table.entries.cpu().numpy()
    args = table.args.cpu().numpy()
    consts = table.consts.cpu().numpy()
    prog = _Program()
    for k, row in enumerate(entries[: _rows(table)]):
        code, width, slot, flags, nargs, argoff, p0, p1 = (
            int(x) for x in row[:8])
        e = _Entry()
        e.id = k
        name = OP_NAMES[code]
        e.sort = "bool" if flags & F_BOOL else "bv"
        e.op = "ite" if name == "bite" else name
        e.width = width
        e.args = tuple(prog.order[int(a)] for a in args[argoff:argoff + nargs])
        if e.op == "const" and e.sort == "bv":
            e.params = (u256.to_int(consts[p0]), width)
        elif e.op == "extract":
            e.params = (p0, p1)
        elif e.op == "bconst":
            e.params = (bool(p0),)
        else:
            e.params = ()
        prog.order.append(e)
        if flags & F_OPAQUE:
            prog.opaque.add(k)
        if e.sort == "bool":
            prog.bool_slot[k] = slot
        else:
            prog.bv_slot[k] = slot
    return prog


def _rows(table: NodeTable) -> int:
    return table.n_bv + table.n_bool


def _pack(bv, tri, conflict):
    """The walk's per-slot results as the kernel's outputs: int64 [B,
    n_bv, 4, 8] planes, int8 [B, n_bool] tri-states, bool [B]."""
    batch = conflict.shape[0]
    if bv:
        planes = torch.stack([torch.stack(word, dim=1) for word in bv], dim=1)
    else:
        planes = torch.zeros((batch, 0, 4, u256.NUM_LIMBS), dtype=u256.DTYPE,
                             device=conflict.device)
    return planes, torch.stack(tri, dim=1), conflict


def fits_a_block(n_rows: int, n_bool: int, dev) -> bool:
    """The library's fit rule (``word_prop_smem_bytes``): does a block of
    a program of ``n_rows`` nodes, ``n_bool`` of them bool, fit the
    shared memory a block of ``dev``'s card may opt in to?"""
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    return load_library().word_prop_smem_bytes(n_rows, n_bool) <= limit


def word_fixpoint_plain(table: NodeTable, want0: torch.Tensor, rounds: int):
    """Plain PyTorch version of the kernel: decode ``table`` and run the
    word tier's batched walk over it on ``want0``'s device.  ``want0``
    int8 [n_bool, B] is 1 where a lane asserts that bool slot.  Returns
    ``(planes, tri, conflict)``: int64 [B, n_bv, 4, 8] (lo, hi, km, kv
    limbs), int8 [B, n_bool], bool [B]."""
    from mythril_tpu_torch.smt.word_tier import WordTier

    prog = decode_table(table)
    dev = want0.device
    batch = want0.shape[1]
    wanted = want0.cpu().numpy() != 0
    root_mask = {
        k: wanted[slot] for k, slot in prog.bool_slot.items()
        if wanted[slot].any()
    }
    bv, tri, conflict = WordTier().fixpoint(prog, root_mask, batch, rounds,
                                            dev)
    return _pack(bv, tri, conflict)


def word_fixpoint(table: NodeTable, want0: torch.Tensor, rounds: int):
    """The fixpoint over every lane: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors (same signature and results as
    :func:`word_fixpoint_plain`)."""
    if want0.device.type == "cpu":
        return word_fixpoint_plain(table, want0, rounds)
    return _launch(table, want0, rounds)


def bind(path: str) -> ctypes.CDLL:
    """Load a build of ``word_prop.cu``, declare its entry points, and
    hold its table layout against this module's."""
    lib = ctypes.CDLL(path)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.word_prop_launch.argtypes = [
        ptr, c_int, ptr, ptr, ptr, c_int, c_int, c_int, ptr, ptr,
        ptr, ptr, ptr,
    ]
    lib.word_prop_launch.restype = c_int
    lib.word_prop_smem_bytes.argtypes = [c_int, c_int]
    lib.word_prop_smem_bytes.restype = c_int
    lib.word_prop_op_count.restype = c_int
    lib.word_prop_entry_columns.restype = c_int
    if (lib.word_prop_op_count() != len(OP_NAMES)
            or lib.word_prop_entry_columns() != len(ENTRY_COLUMNS)):
        raise RuntimeError("word_prop: table layout mismatch")
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


def _launch(table: NodeTable, want0: torch.Tensor, rounds: int):
    global launch_count
    dev = want0.device
    tensors = (table.entries, table.args, table.consts, want0)
    if any(t.device != dev for t in tensors):
        raise ValueError("word_fixpoint: table and want0 on different "
                         "devices")
    n_rows = _rows(table)
    batch = want0.shape[1]
    if (table.entries.dtype != torch.int32 or table.args.dtype != torch.int32
            or table.consts.dtype != torch.int64
            or want0.dtype != torch.int8):
        raise TypeError("word_fixpoint: int32 table, int64 constants, "
                        "int8 wants")
    if (table.entries.shape[0] < n_rows or want0.shape[0] != table.n_bool
            or batch < 1 or table.n_bool < 1 or rounds < 0):
        raise ValueError(f"word_fixpoint: {n_rows} rows, want0 "
                         f"{tuple(want0.shape)}, rounds {rounds}")
    lib = load_library()
    entries = table.entries.contiguous()
    args = table.args.contiguous()
    consts = table.consts.to(torch.int32).contiguous()  # limbs, mod 2^32
    want0 = want0.contiguous()
    bv = torch.empty((max(table.n_bv, 1) * 32, batch), dtype=torch.int32,
                     device=dev)
    tri = torch.empty((table.n_bool, batch), dtype=torch.int8, device=dev)
    want = torch.empty_like(tri)
    conflict = torch.empty((batch,), dtype=torch.bool, device=dev)
    err = lib.word_prop_launch(
        entries.data_ptr(), n_rows, args.data_ptr(), consts.data_ptr(),
        want0.data_ptr(), batch, table.n_bool, rounds, bv.data_ptr(),
        tri.data_ptr(), want.data_ptr(), conflict.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == DOES_NOT_FIT:
        raise ValueError(
            f"word_prop: a program of {n_rows} nodes ({table.n_bv} bv) needs "
            f"{lib.word_prop_smem_bytes(n_rows, table.n_bool)} B of shared "
            f"memory a block, more than the card has")
    if err:
        raise RuntimeError(f"word_prop kernel launch failed: cudaError {err}")
    launch_count += 1
    planes = (bv[: table.n_bv * 32].view(table.n_bv, 4, u256.NUM_LIMBS, batch)
              .permute(3, 0, 1, 2).to(u256.DTYPE) & u256.MASK32)
    return planes, tri.t(), conflict


def run_program(prog, root_mask, batch: int, rounds: int, dev):
    """What the word tier's device executor runs: ``prog`` over
    ``batch`` lanes on ``dev``, ``root_mask`` mapping a root's node id
    to the bool[batch] lanes asserting it.  The table is lowered once a
    program and copied once to each device (``prog.tables``).  Returns
    the walk's ``(bv, tri, conflict)`` form: per bv slot a (lo, hi, km,
    kv) tuple of [batch, 8] planes, per bool slot an int8[batch]
    tri-state (on the host), the bool[batch] conflicts (on the host)."""
    table = prog.tables.get(dev)
    if table is None:
        host = prog.tables.get(torch.device("cpu")) or lower_program(prog)
        prog.tables[torch.device("cpu")] = host
        table = prog.tables[dev] = host.to(dev)
    want0 = np.zeros((table.n_bool, batch), dtype=np.int8)
    for rid, mask in root_mask.items():
        slot = prog.bool_slot.get(rid)
        if slot is not None:
            want0[slot] |= np.asarray(mask, dtype=np.int8)
    planes, tri, conflict = word_fixpoint(
        table, torch.from_numpy(want0).to(dev), rounds)
    bv = [tuple(planes[:, s, f] for f in range(4))
          for s in range(table.n_bv)]
    tri = tri.cpu()
    return bv, [tri[:, s] for s in range(table.n_bool)], conflict.cpu()
