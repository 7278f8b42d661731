"""Symbolic lockstep tier: batch the LASER interpreter over sibling
states (own copy of ``mythril_tpu/laser/ethereum/symbolic_lockstep.py``).

``LaserEVM._exec_round`` draws a batch of GlobalStates per scheduler
round; without this module each one walks the per-state Python
interpreter (``execute_state``) one opcode at a time, re-entering the
scheduler after every instruction.  Sibling states — forks of the same
contract exploring different path conditions — overwhelmingly sit at
the *same* code offset, about to execute the *same* straight-line run
of opcodes up to the next branch point.  This tier exploits that:

- **frontier grouping** — eligible lanes are grouped by (bytecode,
  pc); each group executes one *segment* (the straight-line opcode run
  from the shared pc up to JUMP/JUMPI, an unsupported opcode, or the
  ``MYTHRIL_TPU_SEG_MAX_OPS`` cap) in lockstep, advancing all lanes op
  by op;
- **raw-mutator execution** — each supported opcode's undecorated
  mutator (``Instruction.<op>_.mutator``, stashed by the
  ``StateTransition`` decorator) runs on the live lane, and the
  decorator's gas/pc bookkeeping is replayed from the same
  ``StateTransition`` instance, so the per-opcode state copy the serial
  path pays disappears while the semantics cannot drift;
- **fault prechecks** — stack underflow/overflow and out-of-gas are
  checked *before* the mutator runs (the serial path discovers them on
  a throwaway copy); a faulting lane leaves the segment through the
  exact ``execute_state`` exception arms, so hook traffic and successor
  shapes match the serial path call for call;
- **fork handoff** — JUMP/JUMPI terminate the segment through the real
  (decorated) semantics on a defensive copy; every successor's path
  constraint flows into the round's single ``prune_infeasible`` pass,
  which hands the whole frontier's fork masks to ``batch_check_states``
  in one dispatch (laser/batch.py);
- **memory/storage/keccak planes** — concrete-offset
  MLOAD/MSTORE/MSTORE8 and concrete-key SLOAD/SSTORE execute
  in-segment as scatter/gather over batched per-lane byte and limb
  planes (the fixed-arena layout prototyped in ``ops/lockstep.py``),
  and SHA3 over a fully concrete memory window hashes on the card
  through ``ops/keccak.py`` (one launch of ``csrc/keccak.cu`` a width
  group), the result word re-entering the stack plane.  The exact serial gas charges are preflighted stage for
  stage, SSTORE's static-context ``WriteProtection`` is raised at the
  serial point in the hook order, and a lane whose offset, key, or
  hashed content is symbolic parks at a host boundary exactly as
  before the planes landed (``MYTHRIL_TPU_SEG_PLANES_MEM=0`` restores
  that boundary for every lane);
- **NEEDS_HOST boundary** — any opcode outside the supported set
  (CALL/CREATE, new transactions, host services — the same philosophy
  as ``ops/lockstep.py``'s NEEDS_HOST set) ends the segment *before*
  the opcode: the lane returns to the scheduler as its own successor
  with identical machine state and the serial interpreter takes over.
  Every parked lane is counted in ``DispatchStats`` with the opcode
  that parked it (``needs_host_boundaries`` / ``boundary_causes``);
- **limb-plane carriage** — while a segment runs, a top-relative
  shadow of the group's stack slots is carried as ops/word_prop
  abstract words: batched ``f_*`` kernels over a lane axis when the
  group has 2+ lanes, scalar ``s_*`` twins otherwise
  (``MYTHRIL_TPU_SEG_PLANES=0`` disables).  The shadow is telemetry —
  known-bit density feeds ``DispatchStats`` — and never influences
  execution.  JUMPI fork successors inherit a copy-on-write reference
  to the segment's data planes: the fork itself copies nothing, the
  next segment's shadow adopts the lane's row in place, and the first
  post-fork write splits the backing arrays;
- **autopilot routing** — each group's shape (lanes, run length, entry
  coherence) is scored by ``autopilot.route_segment``; shapes the cost
  model has learned to be slower per lane than
  ``MYTHRIL_TPU_SEG_CEIL_MS`` fall back to the serial interpreter.

The shadow (the stack words and the data planes) lives on the host, as
the JAX package keeps it (numpy there, CPU tensors here): each opcode's
transfer is a few ``[lanes, 8]`` operations whose known bits are read
back at once, so on the card it would cost a synchronisation an opcode
a group.  Only the hash goes to the card.  The shadow is telemetry: a
failure inside it kills the shadow and never the segment, except a
failure of the keccak kernel or of the card (:class:`KeccakKernelError`),
which propagates.

Each group that runs counts its lanes as ``lockstep`` transitions in the
lane ledger (``observability/ledger.py``), and its per-lane wall feeds
the autopilot's cost model under the ``lockstep`` tier key; the
``svm.segment`` span times it into ``dispatch_stats.segment_s``.  The
resource governor's ``disable_planes`` rung (``resilience/governor.py``)
turns the tier and its planes off for the rest of an analysis.

Kill switch: ``MYTHRIL_TPU_SYM_LOCKSTEP=0`` restores the exact
per-state path (``run_lockstep`` returns the batch untouched).  The
tier also declines whole rounds under create transactions, gas-focused
runs (``track_gas``) and ``requires_statespace`` — those paths consume
per-opcode round records the segment compression elides.
"""

import logging
import time
from copy import copy
from datetime import datetime, timedelta
from typing import Dict, List, Optional, Tuple

import torch

from mythril_tpu_torch.laser.ethereum.evm_exceptions import (
    VmException,
    WriteProtection,
)
from mythril_tpu_torch.laser.ethereum.instructions import Instruction
from mythril_tpu_torch.laser.ethereum.state.machine_state import STACK_LIMIT
from mythril_tpu_torch.laser.plugin.signals import (
    PluginSkipState,
    PluginSkipWorldState,
)
from mythril_tpu_torch.observability import spans as obs
from mythril_tpu_torch.ops import default_device, u256
from mythril_tpu_torch.ops import keccak as keccak_kernel
from mythril_tpu_torch.ops import word_prop as W
from mythril_tpu_torch.ops.batched_sat import dispatch_stats
from mythril_tpu_torch.ops.keccak import KeccakKernelError
from mythril_tpu_torch.smt import BitVec, symbol_factory
from mythril_tpu_torch.support.env import env_flag, env_int
from mythril_tpu_torch.support.opcodes import BY_NAME, calculate_sha3_gas

log = logging.getLogger(__name__)

#: straight-line opcodes the tier executes in-segment: pure stack/term
#: traffic with no host services, no new transactions, no state forks.
#: Everything else is a NEEDS_HOST boundary.
INTERIOR_OPS = frozenset(
    ["POP", "ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD",
     "ADDMOD", "MULMOD", "EXP", "SIGNEXTEND",
     "LT", "GT", "SLT", "SGT", "EQ", "ISZERO",
     "AND", "OR", "XOR", "NOT", "BYTE", "SHL", "SHR", "SAR",
     "JUMPDEST", "PC", "MSIZE", "GAS",
     "ADDRESS", "ORIGIN", "CALLER", "CALLVALUE", "GASPRICE",
     "CHAINID", "CALLDATASIZE", "CALLDATALOAD"]
    + [f"PUSH{i}" for i in range(1, 33)]
    + [f"DUP{i}" for i in range(1, 17)]
    + [f"SWAP{i}" for i in range(1, 17)]
)

#: branch points: executed in-segment (they end it) through the real
#: decorated semantics on a defensive copy
TERMINATORS = frozenset(("JUMP", "JUMPI"))

#: data-plane opcodes, mapped to the plane that carries them: these
#: execute in-segment through their raw mutators when every lane's
#: offset/key (and, for SHA3, the whole hashed window) is concrete;
#: a lane with a symbolic shape parks at a host boundary instead
PLANE_OPS = {
    "MLOAD": "mem", "MSTORE": "mem", "MSTORE8": "mem",
    "SLOAD": "storage", "SSTORE": "storage", "SHA3": "keccak",
}

_SEG_MAX_OPS_DEFAULT = 64
_SEG_MEM_WORDS_DEFAULT = 128      # 4096-byte arena = ops/lockstep.py
_SEG_STORAGE_SLOTS_DEFAULT = 32   # associative slots = ops/lockstep.py
_SEG_KECCAK_MAX_DEFAULT = 256     # device-hash width cap, bytes


def lockstep_enabled() -> bool:
    """``MYTHRIL_TPU_SYM_LOCKSTEP=0`` pins the exact per-state
    interpreter path.  The resource governor's ``disable_planes`` rung
    (resilience/governor.py) turns the tier off mid-analysis the same
    way: the serial interpreter allocates no per-lane arenas, which is
    the point of the rung."""
    from mythril_tpu_torch.resilience.governor import planes_disabled

    return env_flag("MYTHRIL_TPU_SYM_LOCKSTEP", True) and not (
        planes_disabled()
    )


def mem_planes_enabled() -> bool:
    """``MYTHRIL_TPU_SEG_PLANES_MEM=0`` restores the pre-plane
    NEEDS_HOST boundary at every memory/storage/keccak opcode; the
    governor's ``disable_planes`` rung does the same mid-analysis."""
    from mythril_tpu_torch.resilience.governor import planes_disabled

    return env_flag("MYTHRIL_TPU_SEG_PLANES_MEM", True) and not (
        planes_disabled()
    )


def _fold(op_code: str) -> str:
    op = op_code.lower()
    for prefix in ("push", "dup", "swap"):
        if op.startswith(prefix):
            return prefix
    return op


class _OpPlan:
    """Everything one segment step needs about one instruction."""

    __slots__ = ("op", "pops", "pushes", "terminator", "mutator",
                 "transition", "instr_obj", "address", "plane", "mutation")

    def __init__(self, op, pops, pushes, terminator, mutator, transition,
                 instr_obj, address, plane=None, mutation=False):
        self.op = op
        self.pops = pops
        self.pushes = pushes
        self.terminator = terminator
        self.mutator = mutator
        self.transition = transition
        self.instr_obj = instr_obj
        self.address = address
        self.plane = plane          # "mem" | "storage" | "keccak" | None
        self.mutation = mutation    # SSTORE: decorator's static guard


class SegmentPlan:
    """Per-bytecode segment metadata, cached like lockstep_dispatch's
    DispatcherPlan: for every instruction index, either an
    :class:`_OpPlan` (the tier can execute it) or None (NEEDS_HOST
    boundary).  Entry at *any* pc is supported — a state resumed
    mid-basic-block (checkpointed frontier, fleet handoff) groups
    exactly like a fresh fork."""

    __slots__ = ("info", "ops", "_instrs", "_joins")

    def __init__(self, code):
        self.info: List[Optional[_OpPlan]] = []
        self.ops: List[str] = []
        self._instrs = list(code.instruction_list)
        self._joins: Optional[frozenset] = None
        instr_objs: Dict[str, Instruction] = {}
        for instr in self._instrs:
            self.ops.append(instr.op_code)
            self.info.append(self._plan_op(instr, instr_objs))

    @staticmethod
    def _plan_op(instr, instr_objs) -> Optional[_OpPlan]:
        op = instr.op_code
        terminator = op in TERMINATORS
        plane = PLANE_OPS.get(op)
        if not terminator and plane is None and op not in INTERIOR_OPS:
            return None
        table = BY_NAME.get(op)
        wrapped = getattr(Instruction, _fold(op) + "_", None)
        mutator = getattr(wrapped, "mutator", None)
        transition = getattr(wrapped, "transition", None)
        if table is None or mutator is None or transition is None:
            return None
        mutation = bool(transition.is_state_mutation_instruction)
        if mutation and plane is None:
            return None  # pragma: no cover — SSTORE is the only one
        if not terminator and not transition.increment_pc:
            return None  # pragma: no cover — defensive
        if not terminator and plane is None and not transition.enable_gas:
            return None  # pragma: no cover — plane ops charge inside
        obj = instr_objs.get(op)
        if obj is None:
            # hook-free Instruction solely as the mutator's self (push_
            # /dup_/swap_ read self.op_code); svm-level hooks are fired
            # by the segment loop from the svm's own tables
            obj = instr_objs[op] = Instruction(op, None)
        return _OpPlan(op, table.pops, table.pushes, terminator, mutator,
                       transition, obj, instr.address, plane, mutation)

    def supported_at(self, pc: int) -> bool:
        return 0 <= pc < len(self.info) and self.info[pc] is not None

    def op_at(self, pc: int) -> Optional[str]:
        """Raw opcode name at ``pc`` — names the boundary cause even
        when the op has no plan entry."""
        if 0 <= pc < len(self.ops):
            return self.ops[pc]
        return None

    def run_length(self, pc: int, cap: int, planes: bool = True) -> int:
        """Planned ops from ``pc`` to the segment end (inclusive of a
        terminator), capped.  With ``planes`` off, data-plane opcodes
        bound the run like any other NEEDS_HOST boundary."""
        n = 0
        while n < cap and self.supported_at(pc + n):
            info = self.info[pc + n]
            if not planes and info.plane is not None:
                break
            n += 1
            if info.terminator:
                break
        return n

    def join_pcs(self) -> frozenset:
        """Static re-convergence points (instruction indices): the
        JUMPDESTs where distinct control paths can meet again — ≥2
        statically-resolvable jump in-edges, or one jump in-edge plus
        fallthrough from a non-terminating predecessor.  Only
        ``PUSHn addr; JUMP/JUMPI`` edges are resolvable; computed
        jumps stay invisible, which only costs missed merges (the
        veritesting tier degrades to plain forking there)."""
        if self._joins is not None:
            return self._joins
        addr_to_pc = {
            instr.address: pc for pc, instr in enumerate(self._instrs)
        }
        in_edges: Dict[int, int] = {}
        fallthrough: Dict[int, bool] = {}
        prev = None
        for pc, instr in enumerate(self._instrs):
            op = instr.op_code
            if op in ("JUMP", "JUMPI") and prev is not None:
                p_op, p_arg = prev
                if p_op.startswith("PUSH") and p_arg:
                    target = addr_to_pc.get(int.from_bytes(p_arg, "big"))
                    if target is not None:
                        in_edges[target] = in_edges.get(target, 0) + 1
            if op == "JUMPDEST" and pc > 0:
                before = self._instrs[pc - 1].op_code
                fallthrough[pc] = before not in (
                    "JUMP", "STOP", "RETURN", "REVERT", "INVALID",
                    "SELFDESTRUCT",
                )
            prev = (op, instr.argument)
        self._joins = frozenset(
            pc for pc, instr in enumerate(self._instrs)
            if instr.op_code == "JUMPDEST" and (
                in_edges.get(pc, 0) >= 2
                or (in_edges.get(pc, 0) >= 1 and fallthrough.get(pc))
            )
        )
        return self._joins

    def plane_kinds(self, pc: int, cap: int) -> Tuple[str, ...]:
        """Sorted plane kinds ("keccak"/"mem"/"storage") the segment
        starting at ``pc`` would cross — an autopilot routing feature."""
        kinds = set()
        n = 0
        while n < cap and self.supported_at(pc + n):
            info = self.info[pc + n]
            if info.plane is not None:
                kinds.add(info.plane)
            n += 1
            if info.terminator:
                break
        return tuple(sorted(kinds))


_plan_cache: Dict[str, Optional[SegmentPlan]] = {}
_PLAN_CACHE_CAP = 64


def plan_for(code) -> Optional[SegmentPlan]:
    """Cached per-bytecode plan (keyed by the bytecode string, same
    idiom as lockstep_dispatch's plan cache)."""
    key = getattr(code, "bytecode", None)
    if not isinstance(key, str):
        return None
    plan = _plan_cache.get(key)
    if plan is None and key not in _plan_cache:
        try:
            plan = SegmentPlan(code)
        except Exception:  # noqa: BLE001 — decline, never break the run
            log.debug("segment plan build failed", exc_info=True)
            plan = None
        if len(_plan_cache) >= _PLAN_CACHE_CAP:
            for stale in list(_plan_cache)[: _PLAN_CACHE_CAP // 4]:
                del _plan_cache[stale]
        _plan_cache[key] = plan
    return plan


def reset_for_tests() -> None:
    _plan_cache.clear()


# ---------------------------------------------------------------------------
# limb-plane shadow (telemetry only)
# ---------------------------------------------------------------------------

_WM = W.FULL
#: where the shadow's words and planes live: the host (see the module's
#: docstring; a card would synchronise on every opcode's known bits)
_HOST = torch.device("cpu")
_LIMBS = u256.NUM_LIMBS
_MASK32 = u256.MASK32


def _term_sword(item):
    """Scalar abstract word for one stack slot: concrete values (raw
    ints or constant BitVecs) become singletons, symbolic terms top."""
    if isinstance(item, int):
        return W.s_const(item, _WM)
    value = getattr(item, "value", None)
    if value is not None:
        return W.s_const(value, _WM)
    return W.s_top(_WM)


def _conc(item) -> Optional[int]:
    """Concrete value of a stack slot (raw int or constant BitVec), or
    None for a symbolic term."""
    if isinstance(item, int):
        return item
    return getattr(item, "value", None)


def _limbs_of(values) -> torch.Tensor:
    """Python ints (mod 2^256) -> int64[len(values), 8] limb words on the
    host (``u256.from_int`` a row, in one tensor)."""
    return torch.tensor(
        [[(v >> (32 * k)) & _MASK32 for k in range(_LIMBS)]
         for v in values],
        dtype=u256.DTYPE, device=_HOST,
    ).reshape(len(values), _LIMBS)


_EMPTY_KECCAK: Optional[int] = None


def _empty_keccak_int() -> int:
    global _EMPTY_KECCAK
    if _EMPTY_KECCAK is None:
        from mythril_tpu_torch.support.crypto import keccak256

        _EMPTY_KECCAK = int.from_bytes(keccak256(b""), "big")
    return _EMPTY_KECCAK


def _hash_on_card(data):
    """keccak-256 of the host rows ``data`` (uint8 [rows, L]) on the
    analysis' device (``support_args.args.device``: the card unless the
    caller asked for the CPU), back on the host.  Whatever fails on the
    way (no card, the kernel's build or launch, the card) raises
    :class:`KeccakKernelError`."""
    from mythril_tpu_torch.support.support_args import args

    try:
        device = default_device(args.device)
        return keccak_kernel.keccak256_batch(data.to(device)).cpu()
    except KeccakKernelError:
        raise
    except Exception as exc:
        raise KeccakKernelError(f"keccak on {args.device or 'cuda'}: "
                                f"{exc}") from exc


def _first_true(mask):
    """Index of the first True along the last axis (0 when none): argmax
    over an integer copy, which keeps the first of equal maxima."""
    return mask.to(torch.int32).argmax(-1)


class _LanePlanes:
    """Batched memory and storage planes for one segment group: [lane,
    ...] host tensors in the fixed-arena layout of ``ops/lockstep.py``
    (byte plane + known-byte mask for memory, associative limb-keyed
    slots for storage, each value carried as the four word_prop limb
    planes).  Copy-on-write: JUMPI fork successors share a reference,
    the fork itself copies nothing, and the first write after adoption
    splits the backing tensors."""

    __slots__ = ("mem_kv", "mem_km", "skeys", "slo", "shi", "skm",
                 "skv", "sused", "shared")

    _ARRAYS = ("mem_kv", "mem_km", "skeys", "slo", "shi", "skm",
               "skv", "sused")

    def __init__(self, lanes: int, mem_bytes: int, storage_slots: int):
        self.mem_kv = torch.zeros((lanes, mem_bytes), dtype=torch.uint8,
                                  device=_HOST)
        self.mem_km = torch.zeros((lanes, mem_bytes), dtype=torch.bool,
                                  device=_HOST)
        shape = (lanes, storage_slots, _LIMBS)
        self.skeys = torch.zeros(shape, dtype=u256.DTYPE, device=_HOST)
        self.slo = torch.zeros(shape, dtype=u256.DTYPE, device=_HOST)
        self.shi = torch.zeros(shape, dtype=u256.DTYPE, device=_HOST)
        self.skm = torch.zeros(shape, dtype=u256.DTYPE, device=_HOST)
        self.skv = torch.zeros(shape, dtype=u256.DTYPE, device=_HOST)
        self.sused = torch.zeros((lanes, storage_slots), dtype=torch.bool,
                                 device=_HOST)
        self.shared = False

    def mark_shared(self) -> None:
        self.shared = True

    def _own(self) -> None:
        if self.shared:
            for name in self._ARRAYS:
                setattr(self, name, getattr(self, name).clone())
            self.shared = False

    def seed_row(self, row: int, src: "_LanePlanes", src_row: int) -> None:
        """Adopt one lane's planes from a forked-off segment (arena
        shapes must match — a knob change between segments drops the
        carry instead of mixing layouts)."""
        if (src.mem_kv.shape[1] != self.mem_kv.shape[1]
                or src.skeys.shape[1] != self.skeys.shape[1]):
            return
        for name in self._ARRAYS:
            getattr(self, name)[row] = getattr(src, name)[src_row]

    # -- memory ---------------------------------------------------------

    def mem_store(self, offsets, kv_bytes, km_bytes) -> None:
        """Batched scatter of same-width byte windows, one per lane.
        ``offsets`` int64[L] pre-clamped to the arena size; rows fully
        in-arena scatter, rows straddling the arena edge invalidate the
        overlapped tail (unknown beats stale)."""
        self._own()
        size = self.mem_kv.shape[1]
        width = kv_bytes.shape[1]
        in_arena = offsets + width <= size
        rows = torch.nonzero(in_arena).flatten()
        if rows.numel():
            idx = offsets[rows, None] + torch.arange(width, device=_HOST)
            self.mem_kv[rows[:, None], idx] = torch.where(
                km_bytes[rows], kv_bytes[rows], 0
            )
            self.mem_km[rows[:, None], idx] = km_bytes[rows]
        for row in torch.nonzero(~in_arena & (offsets < size)).flatten():
            self.mem_kv[row, int(offsets[row]):] = 0
            self.mem_km[row, int(offsets[row]):] = False

    def mem_load(self, offsets, width: int):
        """Batched gather: (kv, km) uint8/bool [L, width]; rows outside
        the arena read back fully unknown."""
        in_arena = offsets + width <= self.mem_kv.shape[1]
        safe = torch.where(in_arena, offsets, 0)
        idx = safe[:, None] + torch.arange(width, device=_HOST)
        lane = torch.arange(self.mem_kv.shape[0], device=_HOST)[:, None]
        km = self.mem_km[lane, idx] & in_arena[:, None]
        return torch.where(km, self.mem_kv[lane, idx], 0), km

    def mem_invalidate(self, rows) -> None:
        """Wipe whole lanes' memory knowledge (a symbolic-offset write
        could have landed anywhere — unknown beats stale)."""
        if len(rows):
            self._own()
            self.mem_kv[rows] = 0
            self.mem_km[rows] = False

    # -- storage --------------------------------------------------------

    def storage_store(self, keys, lo, hi, km, kv, valid=None) -> None:
        """Associative scatter (same scan as ops/lockstep h_sstore):
        a key hit updates its slot, a miss takes the first free slot, a
        full lane drops the new key — later loads of it miss back to
        the live term, same-key hits stay exact.  ``valid`` masks lanes
        out of the scatter entirely (symbolic keys)."""
        self._own()
        hits = (self.skeys == keys[:, None, :]).all(-1) & self.sused
        found = hits.any(-1)
        full = self.sused.all(-1) & ~found
        idx = torch.where(found, _first_true(hits), _first_true(~self.sused))
        keep = ~full if valid is None else (~full & valid)
        rows = torch.nonzero(keep).flatten()
        if rows.numel():
            at = idx[rows]
            self.skeys[rows, at] = keys[rows]
            self.slo[rows, at] = lo[rows]
            self.shi[rows, at] = hi[rows]
            self.skm[rows, at] = km[rows]
            self.skv[rows, at] = kv[rows]
            self.sused[rows, at] = True

    def storage_invalidate(self, rows) -> None:
        """Wipe whole lanes' storage knowledge (a symbolic-key write
        could have hit any slot — unknown beats stale)."""
        if len(rows):
            self._own()
            self.sused[rows] = False

    def storage_load(self, keys):
        """Associative gather: (found bool[L], lo, hi, km, kv
        int64[L, 8]) — missed lanes carry garbage limbs behind a False
        ``found``."""
        hits = (self.skeys == keys[:, None, :]).all(-1) & self.sused
        found = hits.any(-1)
        idx = _first_true(hits)
        lane = torch.arange(keys.shape[0], device=_HOST)
        return (found, self.slo[lane, idx], self.shi[lane, idx],
                self.skm[lane, idx], self.skv[lane, idx])


def _slot_key(item):
    """Coherence identity of a stack slot: constants compare by value,
    symbolic terms by object identity (shared sub-DAG)."""
    if isinstance(item, int):
        return ("c", item)
    value = getattr(item, "value", None)
    if value is not None:
        return ("c", value)
    return ("t", id(getattr(item, "raw", item)))


def entry_coherence(states, depth: int = 4) -> float:
    """Fraction of the top ``depth`` entry stack slots whose term is
    shared (or an equal constant) across every lane of the group —
    1.0 for a single lane or fully coherent siblings."""
    if len(states) < 2:
        return 1.0
    slots = min(depth, *(len(s.mstate.stack) for s in states))
    if slots == 0:
        return 1.0
    shared = 0
    for d in range(1, slots + 1):
        keys = {_slot_key(s.mstate.stack[-d]) for s in states}
        if len(keys) == 1:
            shared += 1
    return shared / slots


class _PlaneShadow:
    """Top-relative abstract-word shadow of the group's machine stacks.

    ``words[0]`` shadows the stack top; slots below the materialized
    window derive lazily from the live terms.  Batched ``f_*`` transfers
    carry the whole group in one [lanes, 8] limb plane per bound; a
    single-lane group uses the scalar ``s_*`` twins.  Purely
    observational: known-bit density accumulates into DispatchStats and
    the shadow dies (rather than resyncing) when a lane faults out
    mid-segment."""

    def __init__(self, states):
        self.states = states
        self.scalar = len(states) < 2
        self.words: List = []
        self.dead = False
        self.known_bits = 0
        self.total_bits = 0
        self.planes: Optional[_LanePlanes] = None
        self.mem_ops = 0
        self.storage_ops = 0
        self.keccak_hashes = 0
        self._plane_args: Optional[List] = None
        # COW adoption: a JUMPI fork attached a shared plane reference
        # to this lane; valid only while nothing executed since (the
        # attribute dies on any state copy, and the pc must still match)
        self._seed_refs: List[Tuple[int, "_LanePlanes", int]] = []
        for row, s in enumerate(states):
            ref = s.__dict__.pop("_seg_planes", None)
            if ref is not None and ref[2] == s.mstate.pc:
                self._seed_refs.append((row, ref[0], ref[1]))
        if not self.scalar:
            shape = (len(states),)
            self._wm = W.width_mask(256, shape, _HOST)
            self._one = W.const_word(1, 256, shape, _HOST)
            self._zero = W.const_word(0, 256, shape, _HOST)
            bit0 = W.width_mask(1, shape, _HOST)
            self._unk_bool = (W.zeros_plane(shape, _HOST), bit0,
                              u256.bit_not(bit0), W.zeros_plane(shape, _HOST))

    # -- slot plumbing --------------------------------------------------

    def _materialize(self, depth: int) -> None:
        while len(self.words) <= depth:
            d = len(self.words)
            if self.scalar:
                self.words.append(
                    _term_sword(self.states[0].mstate.stack[-1 - d])
                )
            else:
                sws = [_term_sword(s.mstate.stack[-1 - d])
                       for s in self.states]
                self.words.append(self._lift(sws))

    @staticmethod
    def _lift(sws):
        return tuple(_limbs_of([w[k] for w in sws]) for k in range(4))

    def _operands(self, n: int):
        self._materialize(n - 1)
        taken, self.words = self.words[:n], self.words[n:]
        return taken

    def _note(self, word) -> None:
        km = word[2]
        if self.scalar:
            self.known_bits += bin(km & _WM).count("1")
            self.total_bits += 256
        else:
            self.known_bits += int(W.popcount(km).sum())
            self.total_bits += 256 * len(self.states)

    def _push(self, word) -> None:
        self.words.insert(0, word)
        self._note(word)

    def _bool_word(self, tri):
        if self.scalar:
            if tri > 0:
                return W.s_const(1, _WM)
            if tri < 0:
                return W.s_const(0, _WM)
            return (0, 1, W.FULL ^ 1, 0)  # unknown bool: bit 0 free
        return W.select_word(
            tri == 1, self._one,
            W.select_word(tri == -1, self._zero, self._unk_bool),
        )

    def _zero_divisor_fold(self, word, b):
        """EVM DIV/MOD push 0 when the divisor is 0 — fold that branch
        into the SMT-LIB transfer result wherever it stays feasible."""
        lo_b = b[0]
        if self.scalar:
            if lo_b == 0:
                return W.s_join(word, W.s_const(0, _WM))
            return word
        maybe_zero = ~W.any_bit(lo_b)
        joined = W.join(word, self._zero, self._wm)
        return W.select_word(maybe_zero, joined, word)

    # -- per-op update ---------------------------------------------------

    def prepare(self, info: "_OpPlan") -> None:
        """Materialize the op's operand slots from the live terms —
        must run *before* the mutators, while the stacks are still
        pre-op (DUPn pops n, SWAPn pops n+1, so ``info.pops`` is
        exactly the operand depth for every supported op)."""
        self._plane_args = None
        if self.dead or not info.pops:
            return
        if any(len(s.mstate.stack) < info.pops for s in self.states):
            self.dead = True  # a lane is about to underflow out
            return
        try:
            self._materialize(info.pops - 1)
            if info.plane is not None:
                self._plane_args = self._capture_plane_args(info)
        except KeccakKernelError:
            raise
        except Exception:  # noqa: BLE001 — telemetry must never raise
            log.debug("plane shadow materialize failed", exc_info=True)
            self.dead = True

    def step(self, info: "_OpPlan", survivors: int) -> None:
        """Advance the shadow past one executed interior op.  Stacks of
        the surviving lanes have already been mutated."""
        if self.dead:
            return
        if survivors != len(self.states):
            self.dead = True  # lane left mid-segment; shadow is stale
            return
        op = info.op
        try:
            self._transfer(op, info)
        except KeccakKernelError:
            raise  # the kernel or the card failed: not telemetry's to hide
        except Exception:  # noqa: BLE001 — telemetry must never raise
            log.debug("plane shadow transfer failed on %s", op,
                      exc_info=True)
            self.dead = True

    def _transfer(self, op: str, info: "_OpPlan") -> None:
        sc = self.scalar
        if info.plane is not None and self._plane_args is not None:
            self._transfer_plane(op, info)
            return
        if op.startswith("PUSH"):
            item = self.states[0].mstate.stack[-1]
            if sc:
                self._push(_term_sword(item))
            else:
                self._push(self._lift(
                    [_term_sword(s.mstate.stack[-1]) for s in self.states]
                ))
            return
        if op == "POP":
            self._operands(1)
            return
        if op.startswith("DUP"):
            n = int(op[3:])
            self._materialize(n - 1)
            self._push(self.words[n - 1])
            return
        if op.startswith("SWAP"):
            n = int(op[4:])
            self._materialize(n)
            self.words[0], self.words[n] = self.words[n], self.words[0]
            return
        binops = {
            "ADD": (W.s_add, W.f_add), "SUB": (W.s_sub, W.f_sub),
            "MUL": (W.s_mul, W.f_mul), "DIV": (W.s_udiv, W.f_udiv),
            "MOD": (W.s_urem, W.f_urem),
        }
        if op in binops:
            a, b = self._operands(2)
            s_fn, f_fn = binops[op]
            word = (s_fn(a, b, 256, _WM)[0] if sc
                    else f_fn(a, b, 256, self._wm)[0])
            if op in ("DIV", "MOD"):
                word = self._zero_divisor_fold(word, b)
            self._push(word)
            return
        if op in ("AND", "OR", "XOR"):
            a, b = self._operands(2)
            fn = {"AND": (W.s_and, W.f_and), "OR": (W.s_or, W.f_or),
                  "XOR": (W.s_xor, W.f_xor)}[op]
            word = fn[0](a, b, _WM)[0] if sc else fn[1](a, b, self._wm)[0]
            self._push(word)
            return
        if op == "NOT":
            (a,) = self._operands(1)
            word = (W.s_not(a, 256, _WM)[0] if sc
                    else W.f_not(a, 256, self._wm)[0])
            self._push(word)
            return
        if op in ("SHL", "SHR", "SAR"):
            # EVM pops the shift amount first, then the value
            amt, val = self._operands(2)
            fn = {"SHL": (W.s_shl, W.f_shl),
                  "SHR": (W.s_lshr, W.f_lshr),
                  "SAR": (W.s_ashr, W.f_ashr)}[op]
            word = (fn[0](val, amt, 256, _WM)[0] if sc
                    else fn[1](val, amt, 256, self._wm)[0])
            self._push(word)
            return
        if op in ("LT", "GT", "SLT", "SGT", "EQ", "ISZERO"):
            if op == "ISZERO":
                (a,) = self._operands(1)
                b = W.s_const(0, _WM) if sc else self._zero
            else:
                a, b = self._operands(2)
            if op in ("GT", "SGT"):
                a, b = b, a
            if op in ("LT", "GT"):
                tri = W.s_p_ult(a, b) if sc else W.p_ult(a, b)
            elif op in ("SLT", "SGT"):
                tri = (W.s_p_slt(a, b, 256) if sc
                       else W.p_slt(a, b, 256))
            else:
                tri = W.s_p_eq(a, b) if sc else W.p_eq(a, b)
            self._push(self._bool_word(tri))
            return
        # generic supported op (EXP, BYTE, env reads, ...): pop the
        # consumed slots, derive the pushed slot from the live terms
        if info.pops:
            self._operands(info.pops)
        if info.pushes:
            if sc:
                self._push(_term_sword(self.states[0].mstate.stack[-1]))
            else:
                self._push(self._lift(
                    [_term_sword(s.mstate.stack[-1]) for s in self.states]
                ))

    # -- memory/storage/keccak planes -----------------------------------

    def _ensure_planes(self) -> _LanePlanes:
        if self.planes is None:
            mem_bytes = env_int("MYTHRIL_TPU_SEG_MEM_WORDS",
                                _SEG_MEM_WORDS_DEFAULT, floor=1) * 32
            slots = env_int("MYTHRIL_TPU_SEG_STORAGE_SLOTS",
                            _SEG_STORAGE_SLOTS_DEFAULT, floor=1)
            self.planes = _LanePlanes(len(self.states), mem_bytes, slots)
            for row, src, src_row in self._seed_refs:
                self.planes.seed_row(row, src, src_row)
        return self.planes

    def _capture_plane_args(self, info: "_OpPlan") -> List:
        """Per-lane concrete plane arguments, read from the live stacks
        *before* the mutators pop them.  SHA3 shapes are concrete by
        the segment gate; the other plane ops may carry symbolic
        operands (None here) — the transfer skips or invalidates those
        lanes while the live mutators run their deterministic symbolic
        paths in-segment."""
        op = info.op
        args: List = []
        for s in self.states:
            stack = s.mstate.stack
            if op == "SHA3":
                index = _conc(stack[-1])
                length = _conc(stack[-2])
                window = None
                if index is not None and length is not None and length >= 0:
                    data = []
                    for b in s.mstate.memory[index:index + length]:
                        v = b if isinstance(b, int) else _conc(b)
                        if v is None:
                            data = None
                            break
                        data.append(v & 0xFF)
                    if data is not None:
                        # pre-extension slice may fall short: the
                        # mutator hashes the zero-extended window
                        data.extend([0] * (length - len(data)))
                        window = data
                args.append((index, length, window))
            else:
                args.append(_conc(stack[-1]))
        return args

    def _word_planes(self, word):
        """Shadow word → four int64[L, 8] limb planes (lifts scalar)."""
        if self.scalar:
            return tuple(_limbs_of([word[k]]) for k in range(4))
        return word

    def _from_planes(self, lo, hi, km, kv):
        """Four int64[L, 8] limb planes → shadow word (folds scalar)."""
        if self.scalar:
            return tuple(int(u256.to_int(c[0])) for c in (lo, hi, km, kv))
        return (lo, hi, km, kv)

    def _top_word(self):
        """Term-derived word of the live stack tops (post-mutation —
        the authoritative result the planes are measured against)."""
        if self.scalar:
            return _term_sword(self.states[0].mstate.stack[-1])
        return self._lift(
            [_term_sword(s.mstate.stack[-1]) for s in self.states]
        )

    def _meet_words(self, a, b):
        """Both words soundly abstract the same concrete value; keep
        the union of their known bits."""
        _alo, _ahi, a_km, a_kv = self._word_planes(a)
        _blo, _bhi, b_km, b_kv = self._word_planes(b)
        km = a_km | b_km
        kv = (a_kv & a_km) | (b_kv & b_km)
        return self._from_planes(kv, kv | u256.bit_not(km), km, kv)

    def _word_bytes(self, word, width: int):
        """Value word → (kv, km) byte windows [L, width]: the low
        ``width`` bytes in big-endian memory order, a byte known iff
        all 8 of its bits are."""
        _lo, _hi, km, kv = self._word_planes(word)
        kv_b = u256.limbs_to_bytes(kv)
        km_b = u256.limbs_to_bytes(km) == 0xFF
        return kv_b[:, -width:], km_b[:, -width:]

    def _bytes_word(self, kv_b, km_b):
        """(kv, km) byte windows [L, 32] → shadow word planes."""
        kv = u256.bytes_to_limbs(torch.where(km_b, kv_b, 0))
        km = u256.bytes_to_limbs(torch.where(km_b, 0xFF, 0))
        return self._from_planes(kv, kv | u256.bit_not(km), km, kv)

    def _clamped_offsets(self, args, size: int):
        """Per-lane offsets clamped into int64 range: ``size`` stands
        in for every unusable (huge or missing) offset — it reads and
        writes as out-of-arena."""
        return torch.tensor(
            [min(a, size) if isinstance(a, int) and a >= 0 else size
             for a in args],
            dtype=torch.int64, device=_HOST,
        )

    def _keys_plane(self, args):
        return _limbs_of([a if isinstance(a, int) else 0 for a in args])

    def _transfer_plane(self, op: str, info: "_OpPlan") -> None:
        """Advance the data planes past one memory/storage/keccak op.
        Stacks are already mutated; the live terms stay authoritative —
        a plane miss falls back to the term-derived word, so the planes
        can only add known bits, never invent them."""
        args = self._plane_args
        planes = self._ensure_planes()
        size = planes.mem_kv.shape[1]
        valid = torch.tensor([isinstance(a, int) for a in args],
                             dtype=torch.bool, device=_HOST) \
            if op != "SHA3" else None
        if op in ("MSTORE", "MSTORE8"):
            _off, val = self._operands(2)
            width = 1 if op == "MSTORE8" else 32
            kv_b, km_b = self._word_bytes(val, width)
            planes.mem_store(self._clamped_offsets(args, size), kv_b, km_b)
            # a symbolic-offset store could have landed anywhere in the
            # lane's memory — drop that lane's whole plane
            planes.mem_invalidate(torch.nonzero(~valid).flatten())
            self.mem_ops += int(valid.sum())
            return
        if op == "MLOAD":
            self._operands(1)
            kv_b, km_b = planes.mem_load(
                self._clamped_offsets(args, size), 32
            )
            self._push(self._meet_words(self._bytes_word(kv_b, km_b),
                                        self._top_word()))
            self.mem_ops += int(valid.sum())
            return
        if op == "SLOAD":
            self._operands(1)
            found, lo, hi, km, kv = planes.storage_load(
                self._keys_plane(args)
            )
            # symbolic key: _keys_plane aliased it to 0 — treat as miss
            found = found & valid
            km = torch.where(found[:, None], km, 0)
            kv = torch.where(found[:, None], kv & km, 0)
            plane_word = self._from_planes(kv, kv | u256.bit_not(km), km, kv)
            self._push(self._meet_words(plane_word, self._top_word()))
            self.storage_ops += int(valid.sum())
            return
        if op == "SSTORE":
            _key, val = self._operands(2)
            lo, hi, km, kv = self._word_planes(val)
            planes.storage_store(self._keys_plane(args), lo, hi, km, kv,
                                 valid=valid)
            # a symbolic-key store could have hit any slot — drop that
            # lane's whole storage plane
            planes.storage_invalidate(torch.nonzero(~valid).flatten())
            self.storage_ops += int(valid.sum())
            return
        if op == "SHA3":
            self._operands(2)
            self._push(self._device_hash(args))
            return
        raise ValueError(f"unplanned plane op {op}")  # pragma: no cover

    def _device_hash(self, args):
        """Batched keccak over the lanes' concrete windows, grouped by
        width (the kernel batches same-width rows): one launch of
        ``csrc/keccak.cu`` a width on the analysis' card (the plain
        version under ``device="cpu"``) and one copy of its digests
        back; the result word is fully known and re-enters the stack
        plane."""
        lanes = len(self.states)
        by_len: Dict[int, List[int]] = {}
        for row, (_index, _length, window) in enumerate(args):
            if window is not None:
                by_len.setdefault(len(window), []).append(row)
        kv = torch.zeros((lanes, _LIMBS), dtype=u256.DTYPE, device=_HOST)
        km = torch.zeros((lanes, _LIMBS), dtype=u256.DTYPE, device=_HOST)
        for length, group_rows in by_len.items():
            if length == 0:
                # constant, not a device hash: keccak256(b"")
                kv[group_rows] = _limbs_of([_empty_keccak_int()])
                km[group_rows] = _MASK32
                continue
            data = torch.tensor([args[row][2] for row in group_rows],
                                dtype=torch.uint8, device=_HOST)
            kv[group_rows] = keccak_kernel.digest_to_word(_hash_on_card(data))
            km[group_rows] = _MASK32
            self.keccak_hashes += len(group_rows)
        plane_word = self._from_planes(kv, kv | u256.bit_not(km), km, kv)
        return self._meet_words(plane_word, self._top_word())

    def flush(self) -> None:
        dispatch_stats.plane_known_bits += self.known_bits
        dispatch_stats.plane_total_bits += self.total_bits
        dispatch_stats.mem_plane_ops += self.mem_ops
        dispatch_stats.storage_plane_ops += self.storage_ops
        dispatch_stats.keccak_device_hashes += self.keccak_hashes


# ---------------------------------------------------------------------------
# per-lane, per-op pipeline (execute_state's exact fault/hook ordering)
# ---------------------------------------------------------------------------


def _vm_exception_path(svm, lane, op_code: str, msg: str):
    """execute_state's VmException arm, verbatim: transaction-end hooks
    with a None return state, the VM-exception unwind, the final laser
    post hook."""
    for hook in svm._transaction_end_hooks:
        hook(lane, lane.current_transaction, None, False)
    new_states = svm.handle_vm_exception(lane, op_code, msg)
    svm._execute_post_hook(op_code, new_states)
    return new_states


def _would_out_of_gas(lane, gas_min: int) -> bool:
    """Preflight of StateTransition.check_gas_usage_limit with the gas
    interval already advanced by this opcode's minimum — including the
    decorator's concrete-gas-limit unwrap side effect, which the serial
    path also persists on the shared transaction object."""
    mstate = lane.mstate
    prospective = mstate.min_gas_used + gas_min
    if prospective > mstate.gas_limit:
        return True
    tx = lane.current_transaction
    gas_limit = tx.gas_limit
    if isinstance(gas_limit, BitVec):
        if gas_limit.value is None:
            return False
        tx.gas_limit = gas_limit.value
        gas_limit = gas_limit.value
    return gas_limit is not None and prospective >= gas_limit


def _plane_out_of_gas(lane, info: _OpPlan) -> bool:
    """Preflight for the data-plane ops, which charge gas *inside*
    their mutators (``enable_gas=False``) after popping — replayed
    stage for stage so the live lane faults exactly where the serial
    copy would.  The memory ops' mem-extend stage checks only the
    machine interval (strict >) and its failure is subsumed by the
    final combined check; SHA3's word-gas stage checks the transaction
    limit too, so it is replayed separately."""
    mstate = lane.mstate
    stack = mstate.stack
    op = info.op
    if op in ("MLOAD", "MSTORE", "MSTORE8"):
        offset = _conc(stack[-1])
        if offset is None:
            # symbolic offset: mem_extend no-ops and the mutator
            # charges the opcode-table minimum instead
            return _would_out_of_gas(lane, BY_NAME[op].gas_min)
        size = 1 if op == "MSTORE8" else 32
        return _would_out_of_gas(
            lane, mstate.calculate_memory_gas(offset, size) + 3
        )
    if op == "SLOAD":
        from mythril_tpu_torch.support.support_args import args as _args

        min_gas = BY_NAME["SLOAD"].gas_min
        if getattr(_args, "exact_gas_tracking", False):
            min_gas = 50
        return _would_out_of_gas(lane, min_gas)
    if op == "SSTORE":
        min_gas = BY_NAME["SSTORE"].gas_min
        index = _conc(stack[-1])
        value = _conc(stack[-2])
        if index is not None and value is not None:
            storage = lane.environment.active_account.storage
            old_value = storage[symbol_factory.BitVecVal(index, 256)]
            if (getattr(old_value, "value", None) is not None
                    and old_value.value == 0 and value != 0):
                min_gas = 20000
        return _would_out_of_gas(lane, min_gas)
    if op == "SHA3":
        index = _conc(stack[-1])
        length = _conc(stack[-2])
        if index is None or length is None:  # pragma: no cover — gated
            return False
        sha3_min = calculate_sha3_gas(length)[0]
        if _would_out_of_gas(lane, sha3_min):
            return True
        if length:
            ext = mstate.calculate_memory_gas(index, length)
            return mstate.min_gas_used + sha3_min + ext > mstate.gas_limit
        return False
    return False  # pragma: no cover — exhaustive over PLANE_OPS


def _step_lane(svm, lane, info: _OpPlan):
    """Execute one supported opcode on one lane with the exact fault
    ordering, hook traffic and successor shapes of
    ``LaserEVM.execute_state``.  Returns ``None`` while the lane stays
    in the segment, else the ``(op_code, successors)`` round record."""
    op_code = info.op
    mstate = lane.mstate

    # 1. stack underflow — execute_state checks this before any hook
    if len(mstate.stack) < info.pops:
        msg = (
            f"Stack Underflow Exception due to insufficient stack elements "
            f"for the address {info.address}"
        )
        new_states = svm.handle_vm_exception(lane, op_code, msg)
        svm._execute_post_hook(op_code, new_states)
        return op_code, new_states

    # 2. stack overflow — the mutator's append would raise it before
    #    the decorator's gas accounting, on an unmutated-state copy;
    #    with no copy we must fault before mutating
    if (info.pushes
            and len(mstate.stack) - info.pops + info.pushes > STACK_LIMIT):
        return op_code, _vm_exception_path(
            svm, lane, op_code,
            f"Reached the EVM stack limit of {STACK_LIMIT}",
        )

    # 3. out of gas — the decorator raises it after the mutator ran on
    #    the discarded copy; preflight it so the live lane stays clean.
    #    Terminators skip the preflight: they run on a defensive copy
    #    anyway, and accumulate_gas reads the opcode at the *post-jump*
    #    pc, which this table lookup cannot know
    if (not info.terminator and info.transition.enable_gas
            and _would_out_of_gas(lane, BY_NAME[op_code].gas_min)):
        return op_code, _vm_exception_path(svm, lane, op_code, "")
    # (static-context mutations raise WriteProtection before the
    # mutator's gas charges run serially — skip the preflight so the
    # same exception wins here)
    if (info.plane is not None
            and not (info.mutation and lane.environment.static)
            and _plane_out_of_gas(lane, info)):
        return op_code, _vm_exception_path(svm, lane, op_code, "")

    # 4. laser-level pre hook + state hooks
    try:
        svm._execute_pre_hook(op_code, lane)
    except PluginSkipState:
        svm._add_world_state(lane)
        return None, []
    except PluginSkipWorldState:
        return None, []
    for hook in svm._execute_state_hooks:
        hook(lane)

    # 5. instruction hooks around the raw mutator, plus the decorator's
    #    gas/pc bookkeeping replayed from its own StateTransition —
    #    terminators get the defensive copy the decorator would make
    #    (JUMP pops before it can raise InvalidJumpDestination)
    try:
        for hook in svm.instr_pre_hook[op_code]:
            hook(lane)
        if info.mutation and lane.environment.static:
            # the StateTransition decorator's static-context guard,
            # raised at its serial point in the order (after the
            # instruction pre hooks, before the mutator) with its
            # exact message — WriteProtection is a VmException, so the
            # arm below routes it through the serial unwind
            raise WriteProtection(
                f"The function {op_code.lower()} cannot be executed "
                "in a static call"
            )
        target = copy(lane) if info.terminator else lane
        result = info.mutator(info.instr_obj, target)
        for state in result:
            info.transition.accumulate_gas(state)
        if info.transition.increment_pc:
            for state in result:
                state.mstate.pc += 1
        for hook in svm.instr_post_hook[op_code]:
            for state in result:
                hook(state)
    except VmException as e:
        return op_code, _vm_exception_path(svm, lane, op_code, str(e))

    svm._execute_post_hook(op_code, result)
    if not info.terminator and len(result) == 1 and result[0] is lane:
        return None  # still in the segment
    return op_code, result


# ---------------------------------------------------------------------------
# frontier grouping + segment scheduler
# ---------------------------------------------------------------------------


class _Group:
    __slots__ = ("plan", "pc", "states")

    def __init__(self, plan, pc):
        self.plan = plan
        self.pc = pc
        self.states: List = []


def _plane_lane_ok(lane, info: _OpPlan, keccak_max: int) -> bool:
    """Per-lane gate for the data-plane ops.  Only SHA3 still parks: a
    symbolic index or length, an over-cap width, or any symbolic byte
    in the hashed window means no device hash (and a symbolic index is
    a serial crash path through Memory.__getitem__).  The other plane
    ops run their deterministic single-successor symbolic paths
    in-segment — the transfer skips or invalidates those lanes."""
    if info.op != "SHA3":
        return True
    stack = lane.mstate.stack
    if len(stack) < info.pops:
        return True  # underflows in-segment through the serial arm
    top = _conc(stack[-1])
    if top is None:
        return False
    length = _conc(stack[-2])
    if length is None or length < 0 or length > keccak_max:
        return False
    for b in lane.mstate.memory[top:top + length]:
        if not isinstance(b, int) and getattr(b, "value", None) is None:
            return False
    return True


def _note_boundary(op: Optional[str], lanes: int) -> None:
    """Count lanes handed back to the serial interpreter, keyed by the
    opcode that parked them ("cap" when the op budget ran out with
    supported code ahead)."""
    dispatch_stats.needs_host_boundaries += lanes
    key = op or "end-of-code"
    causes = dispatch_stats.boundary_causes
    causes[key] = causes.get(key, 0) + lanes


def _attach_planes(shadow, active, term_succs) -> None:
    """COW fork handoff: every JUMPI/JUMP successor inherits a shared
    reference to the segment's data planes — the fork itself copies
    nothing; the next segment's shadow adopts the lane's row in place
    and the first post-fork write splits the backing arrays.
    Staleness-safe because ``GlobalState.__copy__`` drops the
    attribute (any serial execution copies) and adoption re-checks the
    pc."""
    if (shadow is None or shadow.dead or shadow.planes is None
            or len(active) != len(shadow.states)):
        return
    shadow.planes.mark_shared()
    for row, succs in term_succs:
        for succ in succs:
            succ.__dict__["_seg_planes"] = (
                shadow.planes, row, succ.mstate.pc
            )


def _run_group(svm, group: _Group, rounds, max_ops: int,
               planes_on: bool, keccak_max: int) -> int:
    """Execute one segment group in lockstep.  Appends one round record
    per lane outcome to ``rounds`` and returns the number of (state,
    opcode) interpreter steps executed."""
    plan = group.plan
    pc = group.pc
    active = list(group.states)
    shadow = (_PlaneShadow(active)
              if env_flag("MYTHRIL_TPU_SEG_PLANES", True) else None)
    stepped = 0
    last_op: Optional[str] = None
    boundary_op: Optional[str] = None
    for _ in range(max_ops):
        info = plan.info[pc] if 0 <= pc < len(plan.info) else None
        if info is None:
            # NEEDS_HOST boundary: hand the lanes back below
            boundary_op = plan.op_at(pc)
            break
        if info.plane is not None:
            if not planes_on:
                boundary_op = info.op  # kill switch: pre-plane boundary
                break
            kept = []
            for lane in active:
                if _plane_lane_ok(lane, info, keccak_max):
                    kept.append(lane)
                else:
                    # symbolic SHA3 shape: this lane parks exactly as
                    # every lane did before the planes landed (the
                    # entry gate guarantees last_op is set here)
                    rounds.append((lane, last_op, [lane]))
                    _note_boundary(info.op, 1)
            if len(kept) != len(active):
                if shadow is not None:
                    shadow.dead = True  # lane set changed under it
                active = kept
                if not active:
                    break
        if shadow is not None and not info.terminator:
            shadow.prepare(info)
        survivors = []
        term_succs: List[Tuple[int, List]] = []
        for row, lane in enumerate(active):
            try:
                outcome = _step_lane(svm, lane, info)
            except NotImplementedError:
                # serial _exec_round drops the lane with no round
                # record; match it
                log.debug("Encountered unimplemented instruction")
                continue
            if outcome is None:
                survivors.append(lane)
            else:
                rounds.append((lane, outcome[0], outcome[1]))
                if info.terminator:
                    term_succs.append((row, outcome[1]))
        stepped += len(active)
        last_op = info.op
        if shadow is not None and not info.terminator:
            shadow.step(info, len(survivors))
        if info.terminator:
            _attach_planes(shadow, active, term_succs)
            active = []
            break
        active = survivors
        if not active:
            break
        pc += 1
    else:
        # op budget exhausted; name the boundary for the cause ledger
        boundary_op = "cap" if plan.supported_at(pc) else plan.op_at(pc)
    # lanes still live at a boundary (unsupported opcode, symbolic
    # plane shape, kill switch, or the op cap) return to the scheduler
    # as their own successor: identical machine state, serial
    # interpreter next round
    for lane in active:
        rounds.append((lane, last_op, [lane]))
    if active:
        _note_boundary(boundary_op, len(active))
    if shadow is not None:
        shadow.flush()
    return stepped


def run_lockstep(svm, batch, rounds, create: bool, track_gas: bool):
    """Partition one scheduler round's batch into lockstep segment
    groups and a serial remainder, execute the groups, and return
    ``(serial_batch, timed_out)`` for ``LaserEVM._exec_round`` to
    finish.  Declines (whole batch stays serial) behind the kill
    switch and for create/track_gas/statespace rounds."""
    if (not batch or create or track_gas or svm.requires_statespace
            or not lockstep_enabled()):
        return batch, None

    planes_on = mem_planes_enabled()
    keccak_max = env_int("MYTHRIL_TPU_SEG_KECCAK_MAX_BYTES",
                         _SEG_KECCAK_MAX_DEFAULT, floor=0)

    serial: List = []
    groups: Dict[Tuple[int, int], _Group] = {}
    order: List[_Group] = []
    for state in batch:
        plan = plan_for(state.environment.code)
        pc = state.mstate.pc
        if plan is None or not plan.supported_at(pc):
            serial.append(state)
            continue
        entry = plan.info[pc]
        if entry.plane is not None and (
                not planes_on
                or not _plane_lane_ok(state, entry, keccak_max)):
            # a symbolic SHA3 shape (or the kill switch) at the entry
            # pc: the serial interpreter takes the opcode directly
            _note_boundary(entry.op, 1)
            serial.append(state)
            continue
        key = (id(plan), pc)
        group = groups.get(key)
        if group is None:
            group = groups[key] = _Group(plan, pc)
            order.append(group)
        group.states.append(state)
    if not order:
        return serial, None

    from mythril_tpu_torch import autopilot
    from mythril_tpu_torch.autopilot.features import segment_features
    from mythril_tpu_torch.observability.ledger import get_ledger

    min_lanes = env_int("MYTHRIL_TPU_SEG_MIN_LANES", 1, floor=1)
    max_ops = env_int("MYTHRIL_TPU_SEG_MAX_OPS", _SEG_MAX_OPS_DEFAULT,
                      floor=1)
    deadline = svm.execution_timeout
    ledger = get_ledger()

    for index, group in enumerate(order):
        if (deadline
                and svm.time + timedelta(seconds=deadline)
                <= datetime.now()):
            # _exec_round's timeout contract: the state at the cursor
            # unwinds the run, everything not yet executed returns to
            # the work list
            log.debug("Hit execution timeout inside lockstep round.")
            leftover = group.states[1:]
            for later in order[index + 1:]:
                leftover += later.states
            svm.work_list += leftover + serial
            return [], group.states[0]
        if len(group.states) < min_lanes:
            serial.extend(group.states)
            continue
        features = segment_features(
            len(group.states),
            group.plan.run_length(group.pc, max_ops, planes_on),
            entry_coherence(group.states),
            group.plan.plane_kinds(group.pc, max_ops) if planes_on
            else (),
        )
        if not autopilot.route_segment(features):
            serial.extend(group.states)
            continue
        ledger.count_transition("lockstep", len(group.states))
        began = time.monotonic()
        with obs.span("svm.segment", cat="svm", profile=True,
                      sink=(dispatch_stats, "segment_s"),
                      lanes=len(group.states), pc=group.pc):
            stepped = _run_group(svm, group, rounds, max_ops,
                                 planes_on, keccak_max)
        dispatch_stats.states_stepped += stepped
        autopilot.note_segment(features, len(group.states),
                               time.monotonic() - began)
    return serial, None
