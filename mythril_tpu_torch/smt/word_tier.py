"""Word-level reasoning tier: the first rung of the solver funnel (own
copy of ``mythril_tpu/smt/word_tier.py`` for the PyTorch port).

Before any constraint set reaches the bit-blaster, this tier runs
batched **interval + known-bits abstract propagation** over the term
DAG (``ops/word_prop.py`` holds the limb-plane transfers) and tries to
decide the query at word level:

- **UNSAT without CNF**: asserting the lane's path constraints drives
  some term's abstraction empty (disjoint intervals, contradictory
  known bits);
- **SAT without CNF**: every asserted constraint propagates to
  must-true, or the pinned variable bits are themselves a model; the
  candidate is checked by concrete evaluation before it decides
  anything;
- **tightened residue**: open lanes export per-variable known bits,
  which :func:`hint_literals` lowers to unit assumption literals.

The fixpoint is one forward pass (bottom-up transfer, met with the
prior state), then ``MYTHRIL_TPU_WORD_ROUNDS`` (default 2) rounds of
backward (assertion pushing) and forward passes.  Three executors run
it, all with the same results:

- ``"scalar"``: per-lane Python ints over word_prop's ``s_*`` twins
  (the CDCL tail's one-query batches, and every batch that does not go
  to the card);
- ``"host"``: the batched walk below over limb planes on the CPU
  (``MYTHRIL_TPU_WORD_XP=np|numpy|host``);
- ``"device"``: the program lowered once into a packed node table
  (``ops/word_fixpoint.py``) and run by the hand-written sm_90a kernel
  ``ops/csrc/word_prop.cu`` in one launch for all lanes, on the card;
  with ``device="cpu"`` the kernel's plain version interprets the same
  table.  The funnel takes it for a batch of :data:`DEVICE_MIN_LANES`
  or more when its device is ``cuda`` and the program fits a block of
  the card (``word_fixpoint.fits_a_block``), as the JAX package takes its
  ``jax.numpy`` executor on a TPU; ``MYTHRIL_TPU_WORD_XP=jax|jnp|device``
  forces it.  A program past the fit runs scalar, as the JAX package
  runs off a TPU (``dispatch_stats.word_too_large_scalar`` counts it).

Everything is scoped to the blast-context generation and keyed by
interned node ids (``reset_word_tier``, which
``ops/batched_sat.reset_resident_pools`` calls).  Kill switch:
``MYTHRIL_TPU_WORD_TIER=0``.  ``MYTHRIL_TPU_WORD_MAX_NODES`` (default
1024) caps the program size.
"""

import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mythril_tpu_torch.observability import spans as obs
from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.ops import word_prop as W
from mythril_tpu_torch.smt import terms as T

#: default fixpoint iterations (one iteration = backward + forward; the
#: initial forward pass always runs)
WORD_ROUNDS = 2
#: programs beyond this many DAG nodes decline the tier
WORD_MAX_NODES = 1024
#: memo cap for per-constraint-set verdicts (LRU quarter eviction)
WORD_MEMO_CAP = 8192
#: compiled-program cache entries (frontier rounds repeat root sets)
PROGRAM_CACHE_CAP = 64
#: batches of at least this many lanes take the device executor when
#: the funnel runs on the card
DEVICE_MIN_LANES = 16

_BV_OPS = frozenset((
    "const", "var", "add", "sub", "mul", "udiv", "urem", "and", "or",
    "xor", "not", "shl", "lshr", "ashr", "concat", "extract", "zext",
    "sext", "ite",
))
_BOOL_OPS = frozenset((
    "bconst", "bvar", "band", "bor", "bnot", "bxor",
    "eq", "ult", "ule", "slt", "sle", "ite",
))
_CMP_OPS = frozenset(("eq", "ult", "ule", "slt", "sle"))
#: ops whose refined abstraction _push_bv_down carries into the children
_PUSH_OPS = frozenset(("zext", "extract", "not", "and", "or", "xor",
                       "add", "sub", "shl", "lshr", "concat"))


def word_tier_enabled() -> bool:
    """``MYTHRIL_TPU_WORD_TIER=0`` disables the tier everywhere."""
    return os.environ.get("MYTHRIL_TPU_WORD_TIER", "1").lower() not in (
        "0", "off", "false",
    )


def _env_int(name: str, default: int) -> int:
    from mythril_tpu_torch.support.env import env_int

    return env_int(name, default, floor=1)


def tightening_digest(hints: Optional[Dict[int, Tuple[int, int]]]) -> int:
    """Stable digest of a per-variable known-bits hint set."""
    if not hints:
        return 0
    payload = ";".join(
        f"{node_id}:{mask:x}:{val:x}"
        for node_id, (mask, val) in sorted(hints.items())
    )
    return zlib.crc32(payload.encode())


def hint_literals(ctx, hints: Optional[Dict[int, Tuple[int, int]]]) -> List[int]:
    """Lower per-variable known bits to unit assumption literals over
    the blast context's variable bit vectors.  Sound to assume: every
    model of the lane's constraints fixes these bits."""
    if not hints:
        return []
    lits: List[int] = []
    for node_id, (mask, val) in hints.items():
        bits = ctx.var_bits.get(node_id)
        if not bits:
            continue
        m = mask
        while m:
            b = (m & -m).bit_length() - 1
            m &= m - 1
            if b < len(bits):
                lit = bits[b]
                if lit in (1, -1):  # already a constant in the pool
                    continue
                lits.append(lit if (val >> b) & 1 else -lit)
    return lits


class _Program:
    """One compiled term-DAG program: a topologically ordered node list
    with slot assignments for bitvector and boolean state, and (once the
    device executor has run it) its packed node table on each device."""

    __slots__ = ("order", "bv_slot", "bool_slot", "opaque",
                 "var_entries", "tables")

    def __init__(self):
        self.order: List[T.Node] = []       # post-order, args first
        self.bv_slot: Dict[int, int] = {}   # node id -> bv state index
        self.bool_slot: Dict[int, int] = {}  # node id -> tri index
        self.opaque: set = set()            # node ids treated as top
        self.var_entries: List[Tuple[int, int, int]] = []  # (id, slot, w)
        self.tables: Dict = {}  # device -> ops/word_fixpoint.NodeTable


def _is_supported_bv(node: T.Node) -> bool:
    return (node.sort == "bv" and node.op in _BV_OPS
            and 0 < node.width <= 256)


def _compile(roots: Sequence[T.Node], cap: int) -> Optional[_Program]:
    """Post-order program over the supported fragment; unsupported
    subterms become opaque leaves (top).  None past the node cap."""
    prog = _Program()
    seen: Dict[int, bool] = {}
    stack: List[Tuple[T.Node, bool]] = [(r, False) for r in reversed(roots)]
    while stack:
        node, expanded = stack.pop()
        if node.id in seen and not expanded:
            continue
        if not expanded:
            seen[node.id] = True
            if len(seen) > cap:
                return None
            kids: Tuple[T.Node, ...] = ()
            if node.sort == "bool" and node.op in _BOOL_OPS:
                if node.op in _CMP_OPS:
                    if all(a.sort == "bv" and a.width <= 256
                           for a in node.args):
                        kids = node.args
                    else:
                        prog.opaque.add(node.id)
                elif node.op not in ("bconst", "bvar"):
                    kids = node.args
            elif _is_supported_bv(node):
                if any(a.sort == "bv" and a.width > 256
                       for a in node.args):
                    # a >256-bit subterm has no faithful limb-plane
                    # abstraction (the planes wrap at 256, and EVM
                    # overflow checks read exactly those carry bits), so
                    # every consumer of one is opaque as well
                    prog.opaque.add(node.id)
                elif node.op not in ("const", "var"):
                    kids = node.args
            else:
                prog.opaque.add(node.id)
            stack.append((node, True))
            for kid in reversed(kids):
                if kid.id not in seen:
                    stack.append((kid, False))
            continue
        if node.sort == "bool":
            if node.id not in prog.bool_slot:
                prog.bool_slot[node.id] = len(prog.bool_slot)
                prog.order.append(node)
        elif node.sort == "bv":
            if node.id not in prog.bv_slot:
                slot = len(prog.bv_slot)
                prog.bv_slot[node.id] = slot
                prog.order.append(node)
                if node.op == "var" and node.id not in prog.opaque:
                    prog.var_entries.append((node.id, slot, node.width))
        else:  # arrays / ufs never reach here (opaque above)
            prog.opaque.add(node.id)
    return prog


class WordTier:
    """Process-wide word-tier engine: program cache + verdict memo."""

    def __init__(self):
        self._programs: Dict[tuple, _Program] = {}
        self._memo: Dict[tuple, object] = {}
        self._memo_generation = -1
        self._wm_cache: Dict[tuple, object] = {}
        #: executor of the last fresh batch ("scalar", "host", "device")
        self.last_executor: Optional[str] = None

    # -- lifecycle -----------------------------------------------------

    def reset(self) -> None:
        """Drop programs, memos and cached planes (node ids are
        re-interned after a context reset)."""
        self._programs.clear()
        self._memo.clear()
        self._memo_generation = -1
        self._wm_cache.clear()

    def _sync_generation(self, generation: int) -> None:
        if generation != self._memo_generation:
            self._memo.clear()
            self._programs.clear()
            self._memo_generation = generation

    # -- memo ----------------------------------------------------------

    def _memo_get(self, key):
        hit = self._memo.get(key)
        if hit is not None:
            del self._memo[key]
            self._memo[key] = hit  # refresh recency
        return hit

    def _memo_put(self, key, value) -> None:
        if key in self._memo:
            del self._memo[key]
        elif len(self._memo) >= WORD_MEMO_CAP:
            for stale in list(self._memo)[: WORD_MEMO_CAP // 4]:
                del self._memo[stale]
        self._memo[key] = value

    # -- public entry point --------------------------------------------

    def decide(
        self, ctx, node_sets: Sequence[Optional[Sequence[T.Node]]],
        device=None,
    ) -> Tuple[List[Optional[bool]], List[Optional[Dict[int, Tuple[int, int]]]],
               List[Optional[T.EvalEnv]]]:
        """Batched word-level pass over a frontier of constraint sets.

        Returns ``(verdicts, hints, envs)`` aligned with ``node_sets``:
        True = SAT (``envs`` holds the evaluation-verified model), False
        = sound UNSAT, None = open; hints maps var node id ->
        ``(known_mask, known_val)`` for open lanes.  ``None`` entries are
        skipped.  ``device`` is the caller's device (None = the card):
        the batched executors run there."""
        verdicts: List[Optional[bool]] = [None] * len(node_sets)
        hints: List[Optional[Dict[int, Tuple[int, int]]]] = (
            [None] * len(node_sets)
        )
        envs: List[Optional[T.EvalEnv]] = [None] * len(node_sets)
        if not word_tier_enabled():
            return verdicts, hints, envs
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        self._sync_generation(ctx.generation)
        filtered: List[Optional[List[T.Node]]] = [None] * len(node_sets)
        fresh: Dict[tuple, List[int]] = {}
        for i, nodes in enumerate(node_sets):
            if nodes is None:
                continue
            nodes = [
                n for n in nodes
                if not isinstance(n, bool) and n is not T.TRUE
            ]
            if any(n is T.FALSE for n in nodes):
                verdicts[i] = False
                continue
            if not nodes:
                verdicts[i] = True
                continue
            filtered[i] = nodes
            key = tuple(sorted(n.id for n in nodes))
            hit = self._memo_get(key)
            if hit is not None:
                kind, payload = hit
                if kind == "unsat":
                    verdicts[i] = False
                elif kind == "sat":
                    verdicts[i] = True
                    envs[i] = payload
                else:  # open (+ hints)
                    hints[i] = payload or None
                continue
            fresh.setdefault(key, []).append(i)
        if not fresh:
            return verdicts, hints, envs

        lane_nodes = [
            filtered[indices[0]] for indices in fresh.values()
        ]
        with obs.span("word.prop", sink=(dispatch_stats, "word_prop_s"),
                      cat="word", profile=True, lanes=len(lane_nodes)):
            outcomes = self._run(lane_nodes, device)
        with obs.span("word.decide", cat="word", lanes=len(lane_nodes)):
            for (key, indices), outcome in zip(fresh.items(), outcomes):
                kind, payload = outcome
                self._memo_put(key, outcome)
                for i in indices:
                    if kind == "unsat":
                        verdicts[i] = False
                        dispatch_stats.word_decided_unsat += 1
                        ctx.note_unsat(filtered[i])
                    elif kind == "sat":
                        verdicts[i] = True
                        envs[i] = payload
                        dispatch_stats.word_decided_sat += 1
                    else:
                        hints[i] = payload or None
        return verdicts, hints, envs

    # -- execution -----------------------------------------------------

    def _program_for(self, roots: Sequence[T.Node]) -> Optional[_Program]:
        key = tuple(sorted({r.id for r in roots}))
        prog = self._programs.get(key)
        if prog is None and key not in self._programs:
            prog = _compile(
                list({r.id: r for r in roots}.values()),
                _env_int("MYTHRIL_TPU_WORD_MAX_NODES", WORD_MAX_NODES),
            )
            if len(self._programs) >= PROGRAM_CACHE_CAP:
                for stale in list(self._programs)[: PROGRAM_CACHE_CAP // 4]:
                    del self._programs[stale]
            self._programs[key] = prog
        return prog

    def _executor(self, batch: int, device, prog=None) -> str:
        """``"scalar"``, ``"host"`` or ``"device"`` for this batch:
        ``MYTHRIL_TPU_WORD_XP=scalar|int``, ``np|numpy|host`` or
        ``jax|jnp|device`` forces one; otherwise a batch of
        :data:`DEVICE_MIN_LANES` or more lanes goes to the kernel when
        ``device`` is the card and ``prog`` fits one of its blocks (the
        library's rule, held before any launch), and every other batch
        runs scalar."""
        forced = os.environ.get("MYTHRIL_TPU_WORD_XP", "").lower()
        if forced in ("scalar", "int"):
            return "scalar"
        if forced in ("np", "numpy", "host"):
            return "host"
        if forced in ("jax", "jnp", "device"):
            return "device"
        on_card = torch.device(
            "cuda" if device is None else device).type == "cuda"
        if batch < DEVICE_MIN_LANES or not on_card:
            return "scalar"
        from mythril_tpu_torch.ops import default_device
        from mythril_tpu_torch.ops.word_fixpoint import fits_a_block

        if prog is not None and not fits_a_block(
                len(prog.bv_slot) + len(prog.bool_slot),
                len(prog.bool_slot), default_device(device)):
            from mythril_tpu_torch.ops.batched_sat import dispatch_stats

            dispatch_stats.word_too_large_scalar += 1
            return "scalar"
        return "device"

    def _wm(self, width: int, batch: int, dev):
        key = (width, batch, dev, u256.DTYPE)
        wm = self._wm_cache.get(key)
        if wm is None:
            wm = W.width_mask(width, (batch,), dev)
            if len(self._wm_cache) > 64:
                self._wm_cache.clear()
            self._wm_cache[key] = wm
        return wm

    def _run(self, lane_nodes: List[List[T.Node]], device=None) -> List[tuple]:
        """Execute one abstract-propagation pass; returns one
        ('unsat' | 'sat' | 'open', hints-or-env) outcome per lane."""
        batch = len(lane_nodes)
        roots: Dict[int, T.Node] = {}
        for nodes in lane_nodes:
            for n in nodes:
                roots.setdefault(n.id, n)
        prog = self._program_for(list(roots.values()))
        if prog is None:
            return [("open", None)] * batch
        kind = self._executor(batch, device, prog)
        self.last_executor = kind
        rounds = _env_int("MYTHRIL_TPU_WORD_ROUNDS", WORD_ROUNDS)
        if kind == "scalar":
            return [
                self._run_lane_scalar(prog, nodes, rounds)
                for nodes in lane_nodes
            ]

        # per-root lane assertion masks
        root_mask: Dict[int, np.ndarray] = {}
        for rid in roots:
            mask = np.zeros((batch,), dtype=bool)
            for lane, nodes in enumerate(lane_nodes):
                if any(n.id == rid for n in nodes):
                    mask[lane] = True
            root_mask[rid] = mask
        if kind == "host":
            bv, tri, conflict = self.fixpoint(
                prog, root_mask, batch, rounds, torch.device("cpu"))
        else:
            from mythril_tpu_torch.ops import default_device
            from mythril_tpu_torch.ops.word_fixpoint import run_program

            bv, tri, conflict = run_program(
                prog, root_mask, batch, rounds, default_device(device))

        conflict_np = conflict.cpu().numpy()
        outcomes: List[tuple] = []
        tri_np = {
            rid: tri[prog.bool_slot[rid]].cpu().numpy()
            if rid in prog.bool_slot else None
            for rid in roots
        }
        var_planes = self._var_planes(prog, bv)
        for lane, nodes in enumerate(lane_nodes):
            if conflict_np[lane]:
                outcomes.append(("unsat", None))
                continue
            lane_tris = [tri_np.get(n.id) for n in nodes]
            all_valid = lane_tris and all(
                t is not None and t[lane] == 1 for t in lane_tris
            )
            lane_hints = self._lane_hints(prog, var_planes, lane)
            # SAT-by-model: every constraint folded must-true, or the
            # pinned variable bits are themselves a model; verified by
            # concrete evaluation before it decides anything
            env = T.EvalEnv(
                variables={nid: val for nid, (_m, val) in lane_hints.items()}
            )
            if all_valid or lane_hints:
                try:
                    if all(T.evaluate(n, env) is True for n in nodes):
                        outcomes.append(("sat", env))
                        continue
                except Exception:  # noqa: BLE001 — fall through to open
                    pass
            outcomes.append(("open", lane_hints))
        return outcomes

    def fixpoint(self, prog, root_mask, batch: int, rounds: int, dev):
        """The batched fixpoint over limb planes on ``dev``: one forward
        pass, then ``rounds`` x (backward, forward).  ``root_mask`` maps
        a root's node id to the bool[batch] lanes that assert it.
        Returns ``(bv, tri, conflict)``: per bv slot a (lo, hi, km, kv)
        tuple of int64[batch, 8] planes, per bool slot an int8[batch]
        tri-state, and the bool[batch] conflict flags."""
        bv: List[Optional[tuple]] = [None] * len(prog.bv_slot)
        tri: List[object] = [None] * len(prog.bool_slot)
        conflict = torch.zeros((batch,), dtype=torch.bool, device=dev)
        masks = {rid: torch.from_numpy(np.asarray(m, dtype=bool)).to(dev)
                 for rid, m in root_mask.items()}
        conflict = self._forward(prog, bv, tri, conflict, batch, dev)
        for _ in range(rounds):
            conflict = self._backward(prog, bv, tri, conflict, masks,
                                      batch, dev)
            conflict = self._forward(prog, bv, tri, conflict, batch, dev)
        return bv, tri, conflict

    # -- scalar executor (per-lane Python ints) ------------------------

    def _run_lane_scalar(self, prog, nodes, rounds) -> tuple:
        """One lane through the scalar twin of the batched engine:
        identical transfer semantics (word_prop's ``s_*`` functions),
        plain-int states, no lane masks."""
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        bv: List[Optional[tuple]] = [None] * len(prog.bv_slot)
        tri: List[int] = [0] * len(prog.bool_slot)
        state = {"conflict": False}

        def wm_of(w):
            return (1 << w) - 1

        def forward():
            for node in prog.order:
                if state["conflict"]:
                    return
                if node.sort == "bool":
                    slot = prog.bool_slot[node.id]
                    value = self._s_forward_bool(prog, node, bv, tri)
                    prev = tri[slot]
                    if prev != 0 and value != 0 and prev != value:
                        state["conflict"] = True
                    tri[slot] = prev if prev != 0 else value
                    continue
                slot = prog.bv_slot[node.id]
                if node.id in prog.opaque or node.op == "var":
                    if bv[slot] is None:
                        # opaque >256-bit terms clamp to a 256-bit top
                        # (their consumers are opaque too)
                        bv[slot] = W.s_top(wm_of(min(node.width, 256)))
                    continue
                word, empty = self._s_forward_bv(prog, node, bv, tri)
                prev = bv[slot]
                if prev is not None:
                    word, empty2 = W.s_meet(word, prev, wm_of(node.width))
                    empty = empty or empty2
                bv[slot] = word
                state["conflict"] = state["conflict"] or empty

        def backward():
            want = [0] * len(prog.bool_slot)
            for n in nodes:
                slot = prog.bool_slot.get(n.id)
                if slot is not None:
                    want[slot] = 1

            def push_want(nd, v):
                slot = prog.bool_slot.get(nd.id)
                if slot is None:
                    return
                if want[slot] == 0:
                    want[slot] = v
                elif want[slot] != v:
                    state["conflict"] = True

            def refine_bv(nd, word, empty):
                if empty:
                    state["conflict"] = True
                    return
                slot = prog.bv_slot[nd.id]
                met, empty2 = W.s_meet(word, bv[slot], wm_of(nd.width))
                if empty2:
                    state["conflict"] = True
                    return
                bv[slot] = met

            for node in reversed(prog.order):
                if state["conflict"]:
                    return
                if node.sort != "bool":
                    continue
                slot = prog.bool_slot[node.id]
                w = want[slot]
                t = tri[slot]
                if w != 0 and t == -w:
                    state["conflict"] = True
                    return
                op = node.op
                if (w == 0 or node.id in prog.opaque
                        or op in ("bconst", "bvar")):
                    continue
                if op == "bnot":
                    push_want(node.args[0], -w)
                    continue
                if op == "band":
                    a, b = node.args
                    if w == 1:
                        push_want(a, 1)
                        push_want(b, 1)
                    else:
                        if tri[prog.bool_slot[a.id]] == 1:
                            push_want(b, -1)
                        if tri[prog.bool_slot[b.id]] == 1:
                            push_want(a, -1)
                    continue
                if op == "bor":
                    a, b = node.args
                    if w == -1:
                        push_want(a, -1)
                        push_want(b, -1)
                    else:
                        if tri[prog.bool_slot[a.id]] == -1:
                            push_want(b, 1)
                        if tri[prog.bool_slot[b.id]] == -1:
                            push_want(a, 1)
                    continue
                if op == "bxor":
                    a, b = node.args
                    ta = tri[prog.bool_slot[a.id]]
                    tb = tri[prog.bool_slot[b.id]]
                    if tb != 0:
                        push_want(a, -tb if w == 1 else tb)
                    if ta != 0:
                        push_want(b, -ta if w == 1 else ta)
                    continue
                if op == "ite":
                    c = tri[prog.bool_slot[node.args[0].id]]
                    if c == 1:
                        push_want(node.args[1], w)
                    elif c == -1:
                        push_want(node.args[2], w)
                    continue
                # comparisons
                a_node, b_node = node.args
                a = bv[prog.bv_slot[a_node.id]]
                b = bv[prog.bv_slot[b_node.id]]
                wm = wm_of(a_node.width)
                if op == "eq":
                    if w == 1:
                        met, empty = W.s_meet(a, b, wm)
                        refine_bv(a_node, met, empty)
                        refine_bv(b_node, met, empty)
                        self._s_push_bv_down(prog, bv, a_node, state)
                        self._s_push_bv_down(prog, bv, b_node, state)
                    continue
                if op in ("ult", "ule"):
                    strict = op == "ult"
                    if w == 1:
                        a2, b2, dead = W.s_b_ult_true(a, b, wm,
                                                      strict=strict)
                    else:
                        b2, a2, dead = W.s_b_ult_true(b, a, wm,
                                                      strict=not strict)
                    if dead:
                        state["conflict"] = True
                        return
                    refine_bv(a_node, a2, False)
                    refine_bv(b_node, b2, False)
                    self._s_push_bv_down(prog, bv, a_node, state)
                    self._s_push_bv_down(prog, bv, b_node, state)
                # slt/sle: no backward transfer (as the batched engine)

        forward()
        for _ in range(rounds):
            if state["conflict"]:
                break
            backward()
            if state["conflict"]:
                break
            forward()

        if state["conflict"]:
            return ("unsat", None)
        all_valid = bool(nodes) and all(
            prog.bool_slot.get(n.id) is not None
            and tri[prog.bool_slot[n.id]] == 1
            for n in nodes
        )
        hints: Dict[int, Tuple[int, int]] = {}
        for node_id, slot, width in prog.var_entries:
            st = bv[slot]
            if st is None:
                continue
            _lo, _hi, km, kv = st
            mask = km & wm_of(width)
            if mask:
                hints[node_id] = (mask, kv & mask)
                dispatch_stats.word_tightened_bits += mask.bit_count()
        env = T.EvalEnv(
            variables={nid: val for nid, (_m, val) in hints.items()}
        )
        if all_valid or hints:
            try:
                if all(T.evaluate(n, env) is True for n in nodes):
                    return ("sat", env)
            except Exception:  # noqa: BLE001 — fall through to open
                pass
        return ("open", hints)

    def _s_forward_bv(self, prog, node, bv, tri):
        op = node.op
        wm = (1 << node.width) - 1
        if op == "const":
            return W.s_const(node.params[0], wm), False
        args = [
            bv[prog.bv_slot[a.id]] if a.sort == "bv" else None
            for a in node.args
        ]
        if op == "add":
            return W.s_add(args[0], args[1], node.width, wm)
        if op == "sub":
            return W.s_sub(args[0], args[1], node.width, wm)
        if op == "mul":
            return W.s_mul(args[0], args[1], node.width, wm)
        if op == "udiv":
            return W.s_udiv(args[0], args[1], node.width, wm)
        if op == "urem":
            return W.s_urem(args[0], args[1], node.width, wm)
        if op == "and":
            return W.s_and(args[0], args[1], wm)
        if op == "or":
            return W.s_or(args[0], args[1], wm)
        if op == "xor":
            return W.s_xor(args[0], args[1], wm)
        if op == "not":
            return W.s_not(args[0], node.width, wm)
        if op == "shl":
            return W.s_shl(args[0], args[1], node.width, wm)
        if op == "lshr":
            return W.s_lshr(args[0], args[1], node.width, wm)
        if op == "ashr":
            return W.s_ashr(args[0], args[1], node.width, wm)
        if op == "extract":
            high, low = node.params
            return W.s_extract(args[0], high, low, wm)
        if op == "zext":
            return args[0], False
        if op == "sext":
            return W.s_sext(args[0], node.args[0].width, node.width, wm)
        if op == "concat":
            offsets, widths, parts = [], [], []
            offset = 0
            for part, st in zip(reversed(node.args), reversed(args)):
                offsets.append(offset)
                widths.append(part.width)
                parts.append(st)
                offset += part.width
            return W.s_concat(parts, offsets, widths, wm)
        if op == "ite":
            cond = tri[prog.bool_slot[node.args[0].id]]
            return W.s_ite(cond, args[1], args[2]), False
        raise AssertionError(f"unreachable word op {op}")  # pragma: no cover

    def _s_forward_bool(self, prog, node, bv, tri) -> int:
        op = node.op
        if node.id in prog.opaque:
            return 0
        if op == "bconst":
            return 1 if node.params[0] else -1
        if op == "bvar":
            return 0
        if op in _CMP_OPS:
            a = bv[prog.bv_slot[node.args[0].id]]
            b = bv[prog.bv_slot[node.args[1].id]]
            width = node.args[0].width
            if op == "eq":
                return W.s_p_eq(a, b)
            if op == "ult":
                return W.s_p_ult(a, b)
            if op == "ule":
                return W.s_p_ule(a, b)
            if op == "slt":
                return W.s_p_slt(a, b, width)
            return W.s_p_sle(a, b, width)
        kids = [tri[prog.bool_slot[a.id]] for a in node.args]
        if op == "bnot":
            return -kids[0]
        if op == "band":
            a, b = kids
            if a == -1 or b == -1:
                return -1
            return 1 if (a == 1 and b == 1) else 0
        if op == "bor":
            a, b = kids
            if a == 1 or b == 1:
                return 1
            return -1 if (a == -1 and b == -1) else 0
        if op == "bxor":
            a, b = kids
            if a != 0 and b != 0:
                return -1 if a == b else 1
            return 0
        if op == "ite":
            c, a, b = kids
            if c == 1:
                return a
            if c == -1:
                return b
            return a if a == b else 0
        raise AssertionError(f"unreachable bool op {op}")  # pragma: no cover

    def _s_push_bv_down(self, prog, bv, node, state, depth: int = 8):
        """Scalar twin of :meth:`_push_bv_down`."""
        if depth <= 0 or node.id in prog.opaque or state["conflict"]:
            return
        op = node.op
        if op not in _PUSH_OPS:
            return
        slot = prog.bv_slot[node.id]
        st = bv[slot]
        if st is None:
            return
        lo, hi, km, kv = st

        def meet_child(child, word):
            child_slot = prog.bv_slot[child.id]
            wm_c = (1 << child.width) - 1
            met, empty = W.s_meet(word, bv[child_slot], wm_c)
            if empty:
                state["conflict"] = True
                return
            bv[child_slot] = met
            self._s_push_bv_down(prog, bv, child, state, depth - 1)

        if op == "zext":
            child = node.args[0]
            wm_c = (1 << child.width) - 1
            meet_child(child, (lo, min(hi, wm_c), km, kv & wm_c))
            return
        if op == "not":
            child = node.args[0]
            wm_c = (1 << child.width) - 1
            meet_child(child, W.s_not((lo, hi, km, kv), child.width,
                                      wm_c)[0])
            return
        if op == "extract":
            high, low = node.params
            child = node.args[0]
            wm_n = (1 << node.width) - 1
            t = W.s_top((1 << child.width) - 1)
            meet_child(child, (t[0], t[1], (km & wm_n) << low,
                               (kv & wm_n) << low))
            return
        if op == "concat":
            offset = 0
            for part in reversed(node.args):
                pm = (1 << part.width) - 1
                t = W.s_top(pm)
                meet_child(part, (t[0], t[1], (km >> offset) & pm,
                                  (kv >> offset) & pm))
                if state["conflict"]:
                    return
                offset += part.width
            return
        a_node, b_node = node.args
        const_node, free_node = (
            (a_node, b_node) if a_node.is_const else (b_node, a_node)
        )
        if not const_node.is_const:
            return
        c = const_node.params[0]
        wm_f = (1 << free_node.width) - 1
        t = W.s_top(wm_f)
        if op == "and":
            km_f = km & c
            meet_child(free_node, (t[0], t[1], km_f, kv & km_f))
            return
        if op == "or":
            km_f = km & ~c & wm_f
            meet_child(free_node, (t[0], t[1], km_f, kv & km_f))
            return
        if op == "xor":
            meet_child(free_node, (t[0], t[1], km, (kv ^ c) & km))
            return
        if op in ("add", "sub"):
            tm = W.s_trailing_known(km) & wm_f
            if op == "add":
                inv = kv - c
            elif free_node is a_node:
                inv = kv + c
            else:
                inv = c - kv
            meet_child(free_node, (t[0], t[1], tm, inv & tm))
            return
        if op in ("shl", "lshr") and free_node is a_node:
            amt = int(const_node.params[0])
            if amt >= node.width:
                return
            if op == "shl":
                km_f = (km >> amt) & ((1 << (node.width - amt)) - 1)
                kv_f = (kv >> amt) & km_f
            else:
                km_f = (km << amt) & wm_f
                kv_f = (kv << amt) & km_f
            meet_child(free_node, (t[0], t[1], km_f, kv_f))

    def _var_planes(self, prog, bv):
        """The var slots' (km, kv) planes as host numpy arrays, read once
        (one copy from the device for the whole batch)."""
        if not prog.var_entries:
            return {}
        slots = [slot for _nid, slot, _w in prog.var_entries
                 if bv[slot] is not None]
        if not slots:
            return {}
        km = torch.stack([bv[s][2] for s in slots]).cpu().numpy()
        kv = torch.stack([bv[s][3] for s in slots]).cpu().numpy()
        return {s: (km[k], kv[k]) for k, s in enumerate(slots)}

    def _lane_hints(self, prog, var_planes, lane):
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        hints: Dict[int, Tuple[int, int]] = {}
        for node_id, slot, width in prog.var_entries:
            planes = var_planes.get(slot)
            if planes is None:
                continue
            km, kv = planes
            wm_int = (1 << width) - 1
            mask = u256.to_int(km[lane]) & wm_int
            if not mask:
                continue
            val = u256.to_int(kv[lane]) & mask
            hints[node_id] = (mask, val)
            dispatch_stats.word_tightened_bits += mask.bit_count()
        return hints

    # -- forward pass --------------------------------------------------

    def _forward(self, prog, bv, tri, conflict, batch, dev):
        shape = (batch,)
        for node in prog.order:
            if node.sort == "bool":
                slot = prog.bool_slot[node.id]
                value = self._forward_bool(prog, node, bv, tri, batch, dev)
                prev = tri[slot]
                if prev is None:
                    tri[slot] = value
                else:
                    # meet of tri-states: a decided value sticks, a new
                    # decision joins, opposite decisions -> conflict
                    conflict = conflict | (
                        (prev != 0) & (value != 0) & (prev != value)
                    )
                    tri[slot] = torch.where(prev != 0, prev, value)
                continue
            slot = prog.bv_slot[node.id]
            if node.id in prog.opaque or node.op == "var":
                if bv[slot] is None:
                    # opaque >256-bit terms clamp to a 256-bit top
                    bv[slot] = W.top(min(node.width, 256), shape, dev)
                continue
            word, empty = self._forward_bv(prog, node, bv, tri, batch, dev)
            prev = bv[slot]
            if prev is not None:
                word, empty2 = W.meet(
                    word, prev, self._wm(node.width, batch, dev)
                )
                empty = empty | empty2
            bv[slot] = word
            conflict = conflict | empty
        return conflict

    def _forward_bv(self, prog, node, bv, tri, batch, dev):
        op = node.op
        wm = self._wm(node.width, batch, dev)
        shape = (batch,)
        no_empty = torch.zeros(shape, dtype=torch.bool, device=dev)
        if op == "const":
            return W.const_word(node.params[0], node.width, shape, dev), (
                no_empty)
        args = [
            bv[prog.bv_slot[a.id]] if a.sort == "bv" else None
            for a in node.args
        ]
        if op == "add":
            return W.f_add(args[0], args[1], node.width, wm)
        if op == "sub":
            return W.f_sub(args[0], args[1], node.width, wm)
        if op == "mul":
            return W.f_mul(args[0], args[1], node.width, wm)
        if op == "udiv":
            return W.f_udiv(args[0], args[1], node.width, wm)
        if op == "urem":
            return W.f_urem(args[0], args[1], node.width, wm)
        if op == "and":
            return W.f_and(args[0], args[1], wm)
        if op == "or":
            return W.f_or(args[0], args[1], wm)
        if op == "xor":
            return W.f_xor(args[0], args[1], wm)
        if op == "not":
            return W.f_not(args[0], node.width, wm)
        if op == "shl":
            return W.f_shl(args[0], args[1], node.width, wm)
        if op == "lshr":
            return W.f_lshr(args[0], args[1], node.width, wm)
        if op == "ashr":
            return W.f_ashr(args[0], args[1], node.width, wm)
        if op == "extract":
            high, low = node.params
            return W.f_extract(args[0], high, low, wm)
        if op == "zext":
            # numerically identity; above-width bits were already known
            # zero in the narrower plane
            return tuple(args[0]), no_empty
        if op == "sext":
            inner = node.args[0]
            return W.f_sext(args[0], inner.width, node.width, wm)
        if op == "concat":
            # last arg is least significant (terms.py convention)
            offsets, widths, parts = [], [], []
            offset = 0
            for part, st in zip(reversed(node.args), reversed(args)):
                offsets.append(offset)
                widths.append(part.width)
                parts.append(st)
                offset += part.width
            return W.f_concat(parts, offsets, widths, node.width, wm)
        if op == "ite":
            cond = tri[prog.bool_slot[node.args[0].id]]
            then_w, else_w = args[1], args[2]
            joined = W.join(then_w, else_w, wm)
            picked = W.select_word(
                cond == 1, then_w,
                W.select_word(cond == -1, else_w, joined),
            )
            return picked, no_empty
        raise AssertionError(f"unreachable word op {op}")  # pragma: no cover

    def _forward_bool(self, prog, node, bv, tri, batch, dev):
        op = node.op
        zeros = torch.zeros((batch,), dtype=torch.int8, device=dev)
        if node.id in prog.opaque or op == "bvar":
            return zeros
        if op == "bconst":
            return zeros + (1 if node.params[0] else -1)
        if op in _CMP_OPS:
            a = bv[prog.bv_slot[node.args[0].id]]
            b = bv[prog.bv_slot[node.args[1].id]]
            width = node.args[0].width
            if op == "eq":
                return W.p_eq(a, b)
            if op == "ult":
                return W.p_ult(a, b)
            if op == "ule":
                return W.p_ule(a, b)
            if op == "slt":
                return W.p_slt(a, b, width)
            return W.p_sle(a, b, width)
        kids = [tri[prog.bool_slot[a.id]] for a in node.args]
        if op == "bnot":
            return (-kids[0]).to(torch.int8)
        if op == "band":
            a, b = kids
            out = torch.where((a == -1) | (b == -1), -1,
                              torch.where((a == 1) & (b == 1), 1, 0))
        elif op == "bor":
            a, b = kids
            out = torch.where((a == 1) | (b == 1), 1,
                              torch.where((a == -1) & (b == -1), -1, 0))
        elif op == "bxor":
            a, b = kids
            out = torch.where((a != 0) & (b != 0),
                              torch.where(a == b, -1, 1), 0)
        elif op == "ite":
            c, a, b = kids
            out = torch.where(
                c == 1, a,
                torch.where(c == -1, b, torch.where(a == b, a, zeros)))
        else:  # pragma: no cover
            raise AssertionError(f"unreachable bool op {op}")
        return out.to(torch.int8)

    # -- backward pass -------------------------------------------------

    def _backward(self, prog, bv, tri, conflict, root_mask, batch, dev):
        int8 = torch.int8
        want: List[object] = [
            torch.zeros((batch,), dtype=int8, device=dev)
            for _ in prog.bool_slot
        ]
        for rid, mask in root_mask.items():
            slot = prog.bool_slot.get(rid)
            if slot is not None:
                want[slot] = torch.where(mask, 1, want[slot]).to(int8)
        no_conflict = torch.zeros((batch,), dtype=torch.bool, device=dev)

        def push_want(node, value, mask):
            slot = prog.bool_slot.get(node.id)
            if slot is None:
                return no_conflict
            cur = want[slot]
            clash = mask & (cur != 0) & (cur != value)
            want[slot] = torch.where(mask & (cur == 0), value, cur).to(int8)
            return clash

        def refine_bv(node, new_word, empty, mask):
            """Apply a masked refinement to a bv slot."""
            nonlocal conflict
            slot = prog.bv_slot[node.id]
            met, empty2 = W.meet(
                new_word, bv[slot], self._wm(node.width, batch, dev)
            )
            bv[slot] = W.select_word(mask, met, bv[slot])
            conflict = conflict | (mask & (empty | empty2))

        for node in reversed(prog.order):
            if node.sort != "bool":
                # bv refinements cascade through _push_bv_down at their
                # comparison entry points
                continue
            slot = prog.bool_slot[node.id]
            w = want[slot]
            t = tri[slot]
            conflict = conflict | ((w == 1) & (t == -1)) | (
                (w == -1) & (t == 1)
            )
            active_t = w == 1
            active_f = w == -1
            op = node.op
            if node.id in prog.opaque or op in ("bconst", "bvar"):
                continue
            if op == "bnot":
                conflict = conflict | push_want(node.args[0], -w, w != 0)
                continue
            if op == "band":
                a, b = node.args
                conflict = conflict | push_want(a, 1, active_t)
                conflict = conflict | push_want(b, 1, active_t)
                ta = tri[prog.bool_slot[a.id]]
                tb = tri[prog.bool_slot[b.id]]
                conflict = conflict | push_want(b, -1, active_f & (ta == 1))
                conflict = conflict | push_want(a, -1, active_f & (tb == 1))
                continue
            if op == "bor":
                a, b = node.args
                conflict = conflict | push_want(a, -1, active_f)
                conflict = conflict | push_want(b, -1, active_f)
                ta = tri[prog.bool_slot[a.id]]
                tb = tri[prog.bool_slot[b.id]]
                conflict = conflict | push_want(b, 1, active_t & (ta == -1))
                conflict = conflict | push_want(a, 1, active_t & (tb == -1))
                continue
            if op == "bxor":
                a, b = node.args
                ta = tri[prog.bool_slot[a.id]]
                tb = tri[prog.bool_slot[b.id]]
                for x, tx in ((a, tb), (b, ta)):
                    dec = tx != 0
                    value = torch.where(w == 1, -tx, tx)
                    # push only one concrete polarity at a time
                    for v in (1, -1):
                        conflict = conflict | push_want(
                            x, v, (w != 0) & dec & (value == v)
                        )
                continue
            if op == "ite":
                c = tri[prog.bool_slot[node.args[0].id]]
                for v, branch in ((1, node.args[1]), (-1, node.args[2])):
                    for wv in (1, -1):
                        conflict = conflict | push_want(
                            branch, wv, (w == wv) & (c == v)
                        )
                continue
            # comparisons: bound tightening on the bv operands
            a_node, b_node = node.args
            a = bv[prog.bv_slot[a_node.id]]
            b = bv[prog.bv_slot[b_node.id]]
            wm = self._wm(a_node.width, batch, dev)
            if op == "eq":
                met, empty = W.meet(a, b, wm)
                refine_bv(a_node, met, empty, active_t)
                refine_bv(b_node, met, empty, active_t)
                conflict = conflict | self._push_bv_down(
                    prog, bv, a_node, active_t, batch, dev
                )
                conflict = conflict | self._push_bv_down(
                    prog, bv, b_node, active_t, batch, dev
                )
                continue
            if op in ("ult", "ule"):
                strict = op == "ult"
                a2, b2, dead = W.b_ult_true(a, b, wm, strict=strict)
                refine_bv(a_node, a2, dead, active_t)
                refine_bv(b_node, b2, dead, active_t)
                # want-false flips the comparison: !(a < b) == b <= a
                b3, a3, dead_f = W.b_ult_true(b, a, wm, strict=not strict)
                refine_bv(b_node, b3, dead_f, active_f)
                refine_bv(a_node, a3, dead_f, active_f)
                conflict = conflict | self._push_bv_down(
                    prog, bv, a_node, active_t | active_f, batch, dev
                )
                conflict = conflict | self._push_bv_down(
                    prog, bv, b_node, active_t | active_f, batch, dev
                )
                continue
            # slt/sle: no backward transfer (forward still decides the
            # sign-known cases)
        return conflict

    def _push_bv_down(self, prog, bv, node, mask, batch, dev,
                      depth: int = 8):
        """Inverse transfer through the invertible bit structure: push a
        refined node abstraction into its children, masked per lane, to
        a bounded depth.  Returns the per-lane conflict flags raised
        along the way."""
        no_conflict = torch.zeros((batch,), dtype=torch.bool, device=dev)
        if depth <= 0 or node.id in prog.opaque:
            return no_conflict
        op = node.op
        if op not in _PUSH_OPS:
            return no_conflict
        slot = prog.bv_slot[node.id]
        state = bv[slot]
        if state is None:
            return no_conflict
        lo, hi, km, kv = state
        conflict_holder = [no_conflict]

        def meet_child(child, word):
            child_slot = prog.bv_slot[child.id]
            wm_c = self._wm(child.width, batch, dev)
            met, empty = W.meet(word, bv[child_slot], wm_c)
            conflict_holder[0] = conflict_holder[0] | (mask & empty)
            bv[child_slot] = W.select_word(mask & ~empty, met,
                                           bv[child_slot])
            conflict_holder[0] = conflict_holder[0] | self._push_bv_down(
                prog, bv, child, mask & ~empty, batch, dev, depth - 1
            )

        shape = (batch,)
        if op == "zext":
            child = node.args[0]
            wm_c = self._wm(child.width, batch, dev)
            meet_child(child, (lo, W.umin(hi, wm_c), km, kv & wm_c))
            return conflict_holder[0]
        if op == "not":
            child = node.args[0]
            wm_c = self._wm(child.width, batch, dev)
            word = W.f_not((lo, hi, km, kv), child.width, wm_c)[0]
            meet_child(child, word)
            return conflict_holder[0]
        if op == "extract":
            high, low = node.params
            child = node.args[0]
            t = W.top(child.width, shape, dev)
            km_c = u256.shl(km & self._wm(node.width, batch, dev), low)
            kv_c = u256.shl(kv & self._wm(node.width, batch, dev), low)
            meet_child(child, (t[0], t[1], km_c, kv_c))
            return conflict_holder[0]
        if op == "concat":
            offset = 0
            for part in reversed(node.args):
                pm = self._wm(part.width, batch, dev)
                km_c = u256.lshr(km, offset) & pm
                kv_c = u256.lshr(kv, offset) & pm
                t = W.top(part.width, shape, dev)
                meet_child(part, (t[0], t[1], km_c, kv_c))
                offset += part.width
            return conflict_holder[0]
        # binary ops with one constant side
        a_node, b_node = node.args
        const_node, free_node = (
            (a_node, b_node) if a_node.is_const else (b_node, a_node)
        )
        if not const_node.is_const:
            return conflict_holder[0]
        c = W.const_word(const_node.params[0], node.width, shape, dev)
        wm_f = self._wm(free_node.width, batch, dev)
        floor = W.zeros_plane(shape, dev)
        if op == "and":
            # bits where the mask is 1 pass through
            km_f = km & c[3]
            meet_child(free_node, (floor, wm_f, km_f, kv & km_f))
            return conflict_holder[0]
        if op == "or":
            not_c = u256.bit_not(c[3]) & wm_f
            km_f = km & not_c
            meet_child(free_node, (floor, wm_f, km_f, kv & km_f))
            return conflict_holder[0]
        if op == "xor":
            meet_child(free_node, (floor, wm_f, km, (kv ^ c[3]) & km))
            return conflict_holder[0]
        if op in ("add", "sub"):
            # x + c == r  =>  x == r - c (a bijection mod 2^w): the
            # trailing known region of r is exactly known in x
            tm = W.trailing_known_mask(km) & wm_f
            if op == "add" or free_node is a_node:
                inv = (u256.sub(kv, c[3]) if op == "add"
                       else u256.add(kv, c[3]))
            else:  # c - x == r => x == c - r
                inv = u256.sub(c[3], kv)
            meet_child(free_node, (floor, wm_f, tm, inv & tm))
            return conflict_holder[0]
        if op in ("shl", "lshr") and free_node is a_node:
            amt = int(const_node.params[0])
            if amt >= node.width:
                return conflict_holder[0]
            if op == "shl":
                # r = x << amt drops x's top `amt` bits: only bits below
                # width - amt are recoverable
                recover = self._wm(node.width - amt, batch, dev)
                km_f = u256.lshr(km, amt) & recover
                kv_f = u256.lshr(kv, amt) & km_f
            else:
                # r = x >> amt drops x's low `amt` bits
                km_f = u256.shl(km, amt) & wm_f
                kv_f = u256.shl(kv, amt) & km_f
            meet_child(free_node, (floor, wm_f, km_f, kv_f))
        return conflict_holder[0]


_tier: Optional[WordTier] = None


def get_word_tier() -> WordTier:
    global _tier
    if _tier is None:
        _tier = WordTier()
    return _tier


def reset_word_tier() -> None:
    """Invalidate all word-tier state (programs, memos): called on
    blast-context resets, where interned node ids are reborn."""
    if _tier is not None:
        _tier.reset()


# ---------------------------------------------------------------------------
# interval implication (the JAX package's veritesting subsumption reads it)
# ---------------------------------------------------------------------------


def _bound_of(node):
    """Normalize one constraint node to an unsigned interval claim
    ``(subject id, lo, hi)``, or None when it is not a one-sided / point
    comparison against a constant."""
    op = node.op
    if op == "bnot":
        inner = _bound_of(node.args[0])
        if inner is None:
            return None
        subject, lo, hi = inner
        top = (1 << _subject_width(node.args[0])) - 1
        # the complement of a one-sided interval is one-sided again; a
        # punctured range (NOT eq) is not an interval
        if lo == 0 and hi < top:
            return (subject, hi + 1, top)
        if hi == top and lo > 0:
            return (subject, 0, lo - 1)
        return None
    if op not in ("eq", "ult", "ule"):
        return None
    left, right = node.args
    if left.sort != "bv":
        return None
    top = (1 << left.width) - 1
    if right.is_const and not left.is_const:
        c = right.value
        if op == "eq":
            return (left.id, c, c)
        if op == "ult":
            return (left.id, 0, c - 1) if c > 0 else None
        return (left.id, 0, c)  # ule
    if left.is_const and not right.is_const:
        c = left.value
        if op == "eq":
            return (right.id, c, c)
        if op == "ult":
            return (right.id, c + 1, top) if c < top else None
        return (right.id, c, top)  # ule
    return None


def _subject_width(cmp_node):
    for arg in cmp_node.args:
        if arg.sort == "bv":
            return arg.width
    return 256


def interval_implies(strong, weak) -> bool:
    """Does constraint node ``strong`` imply ``weak`` at word level?
    True only when both are interval claims about the same subject term
    and strong's interval lies inside weak's.  False (never raises) on
    anything it cannot normalize."""
    if strong.id == weak.id:
        return True
    try:
        sb, wb = _bound_of(strong), _bound_of(weak)
    except Exception:  # noqa: BLE001 — an odd node shape declines
        return False
    if sb is None or wb is None or sb[0] != wb[0]:
        return False
    return wb[1] <= sb[1] and sb[2] <= wb[2]
