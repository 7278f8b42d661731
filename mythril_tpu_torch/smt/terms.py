"""Hash-consed expression DAG for QF_ABV + uninterpreted functions.

This is the internal representation behind the public ``mythril_tpu_torch.smt``
wrapper API (the reference's seam is mythril/laser/smt/, which wraps z3
ASTs; here there is no z3 — nodes are lowered to CNF by
``smt/bitblast.py`` and decided by our own solvers).

Design:
- Immutable interned nodes (one global table) so structural equality is
  pointer equality and sub-DAG CNF can be cached per node id.
- Aggressive constant folding at construction time: concrete EVM
  execution must stay concrete without ever reaching a solver.
- Sorts: bitvectors of arbitrary width, booleans, arrays (bv -> bv), and
  uninterpreted functions (used for keccak modeling).
"""

from typing import Dict, Iterable, List, Optional, Tuple, Union

_MASKS: Dict[int, int] = {}


def mask(width: int) -> int:
    m = _MASKS.get(width)
    if m is None:
        m = (1 << width) - 1
        _MASKS[width] = m
    return m


def to_signed(value: int, width: int) -> int:
    if value >= 1 << (width - 1):
        return value - (1 << width)
    return value


def to_unsigned(value: int, width: int) -> int:
    return value & mask(width)


class Node:
    """One interned DAG node.

    sort: 'bv' (width > 0), 'bool', 'array' (params=(dom,rng)),
    'uf' (params=(name, argwidths, retwidth)).
    """

    __slots__ = ("id", "op", "args", "params", "width", "sort", "_hash")

    def __init__(self, nid, op, args, params, width, sort):
        self.id = nid
        self.op = op
        self.args = args
        self.params = params
        self.width = width
        self.sort = sort
        self._hash = hash((op, tuple(a.id for a in args), params))

    def __hash__(self):
        return self._hash

    def __repr__(self):
        if self.op in ("const", "bconst"):
            return f"{self.params[0]}"
        if self.op in ("var", "bvar", "avar"):
            return f"{self.params[0]}"
        inner = ", ".join(repr(a) for a in self.args)
        if self.params:
            inner += f" {self.params}"
        return f"({self.op} {inner})"

    @property
    def is_const(self) -> bool:
        return self.op in ("const", "bconst")

    @property
    def value(self) -> Optional[int]:
        return self.params[0] if self.is_const else None


class _Interner:
    def __init__(self):
        self.table: Dict[Tuple, Node] = {}
        self.next_id = 0

    def get(self, op, args=(), params=(), width=0, sort="bv") -> Node:
        key = (op, tuple(a.id for a in args), params)
        node = self.table.get(key)
        if node is None:
            node = Node(self.next_id, op, tuple(args), params, width, sort)
            self.next_id += 1
            self.table[key] = node
        return node


_I = _Interner()


def reset_interner() -> None:
    """Forget all interned nodes except the canonical TRUE/FALSE (whose
    identity module-level code depends on).  Node ids are never reused,
    so caches keyed by id in old BlastContexts simply go stale-but-safe."""
    _I.table.clear()
    _I.table[("bconst", (), (True,))] = TRUE
    _I.table[("bconst", (), (False,))] = FALSE

# ---------------------------------------------------------------------------
# Leaf constructors
# ---------------------------------------------------------------------------


def const(value: int, width: int) -> Node:
    return _I.get("const", (), (value & mask(width), width), width)


def var(name: str, width: int) -> Node:
    return _I.get("var", (), (name, width), width)


def bconst(value: bool) -> Node:
    return _I.get("bconst", (), (bool(value),), 0, "bool")


TRUE = bconst(True)
FALSE = bconst(False)


def bvar(name: str) -> Node:
    return _I.get("bvar", (), (name,), 0, "bool")


def avar(name: str, dom: int, rng: int) -> Node:
    return _I.get("avar", (), (name, dom, rng), 0, "array")


def const_array(dom: int, rng: int, value: Node) -> Node:
    return _I.get("constarr", (value,), (dom, rng), 0, "array")


def uf(name: str, arg_widths: Tuple[int, ...], ret_width: int) -> Node:
    return _I.get("uf", (), (name, tuple(arg_widths), ret_width), 0, "uf")


# ---------------------------------------------------------------------------
# Bitvector operations (with constant folding / identity rewrites)
# ---------------------------------------------------------------------------


def _bin(op: str, a: Node, b: Node) -> Node:
    assert a.width == b.width, f"{op}: width mismatch {a.width} vs {b.width}"
    return _I.get(op, (a, b), (), a.width)


def add(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return const(a.value + b.value, a.width)
    if a.is_const and a.value == 0:
        return b
    if b.is_const and b.value == 0:
        return a
    if a.is_const:  # canonical: const on the right
        a, b = b, a
    return _bin("add", a, b)


def sub(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return const(a.value - b.value, a.width)
    if b.is_const and b.value == 0:
        return a
    if a is b:
        return const(0, a.width)
    return _bin("sub", a, b)


def mul(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return const(a.value * b.value, a.width)
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return const(0, a.width)
            if x.value == 1:
                return y
            if (x.value & (x.value - 1)) == 0:
                # multiplication by 2^k is a left shift (constant shifts
                # lower to rewiring in the bit-blaster)
                return shl(y, const(x.value.bit_length() - 1, a.width))
    if a.is_const:
        a, b = b, a
    return _bin("mul", a, b)


def udiv(a: Node, b: Node) -> Node:
    if b.is_const and a.is_const:
        if b.value == 0:
            return const(mask(a.width), a.width)  # SMT-LIB bvudiv total def
        return const(a.value // b.value, a.width)
    if b.is_const and b.value == 1:
        return a
    if b.is_const and b.value and (b.value & (b.value - 1)) == 0:
        # division by 2^k is a right shift; the bit-blaster lowers a
        # constant shift to rewiring, while a udiv circuit is ~W^2
        # gates — solc's selector dispatch (PUSH29 2^224; DIV) hits
        # this on every function entry
        return lshr(a, const(b.value.bit_length() - 1, a.width))
    return _bin("udiv", a, b)


def sdiv(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        if b.value == 0:
            # SMT-LIB bvsdiv: x/0 = 1 if x<0 else -1
            return const(1 if to_signed(a.value, a.width) < 0 else -1, a.width)
        sa, sb = to_signed(a.value, a.width), to_signed(b.value, b.width)
        q = abs(sa) // abs(sb)
        if (sa < 0) != (sb < 0):
            q = -q
        return const(q, a.width)
    if b.is_const and b.value == 1:
        return a
    return _bin("sdiv", a, b)


def urem(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        if b.value == 0:
            return a
        return const(a.value % b.value, a.width)
    if b.is_const and b.value and (b.value & (b.value - 1)) == 0:
        # x % 2^k == x & (2^k - 1): bitwise AND instead of a divider
        return bv_and(a, const(b.value - 1, a.width))
    return _bin("urem", a, b)


def srem(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        if b.value == 0:
            return a
        sa, sb = to_signed(a.value, a.width), to_signed(b.value, b.width)
        r = abs(sa) % abs(sb)
        if sa < 0:
            r = -r
        return const(r, a.width)
    return _bin("srem", a, b)


def bv_and(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return const(a.value & b.value, a.width)
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return const(0, a.width)
            if x.value == mask(a.width):
                return y
    if a is b:
        return a
    if a.is_const:
        a, b = b, a
    return _bin("and", a, b)


def bv_or(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return const(a.value | b.value, a.width)
    for x, y in ((a, b), (b, a)):
        if x.is_const:
            if x.value == 0:
                return y
            if x.value == mask(a.width):
                return const(mask(a.width), a.width)
    if a is b:
        return a
    if a.is_const:
        a, b = b, a
    return _bin("or", a, b)


def bv_xor(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return const(a.value ^ b.value, a.width)
    if a is b:
        return const(0, a.width)
    for x, y in ((a, b), (b, a)):
        if x.is_const and x.value == 0:
            return y
    if a.is_const:
        a, b = b, a
    return _bin("xor", a, b)


def bv_not(a: Node) -> Node:
    if a.is_const:
        return const(~a.value, a.width)
    if a.op == "not":
        return a.args[0]
    return _I.get("not", (a,), (), a.width)


def shl(a: Node, b: Node) -> Node:
    if b.is_const:
        if b.value >= a.width:
            return const(0, a.width)
        if a.is_const:
            return const(a.value << b.value, a.width)
        if b.value == 0:
            return a
    return _bin("shl", a, b)


def lshr(a: Node, b: Node) -> Node:
    if b.is_const:
        if b.value >= a.width:
            return const(0, a.width)
        if a.is_const:
            return const(a.value >> b.value, a.width)
        if b.value == 0:
            return a
    return _bin("lshr", a, b)


def ashr(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        sa = to_signed(a.value, a.width)
        shift = min(b.value, a.width - 1)
        return const(sa >> shift, a.width)
    if b.is_const and b.value == 0:
        return a
    return _bin("ashr", a, b)


def concat(parts: List[Node]) -> Node:
    assert parts
    flat: List[Node] = []
    for p in parts:
        if p.op == "concat":
            flat.extend(p.args)
        else:
            flat.append(p)
    # merge adjacent constants
    merged: List[Node] = []
    for p in flat:
        if merged and merged[-1].is_const and p.is_const:
            prev = merged.pop()
            merged.append(
                const((prev.value << p.width) | p.value, prev.width + p.width)
            )
        else:
            merged.append(p)
    if len(merged) == 1:
        return merged[0]
    # concat of contiguous extracts over one base collapses back into a
    # single extract (mstore/mload word roundtrips hit this constantly)
    if all(p.op == "extract" for p in merged):
        base = merged[0].args[0]
        if all(p.args[0] is base for p in merged):
            contiguous = all(
                merged[i].params[1] == merged[i + 1].params[0] + 1
                for i in range(len(merged) - 1)
            )
            if contiguous:
                return extract(merged[0].params[0], merged[-1].params[1], base)
    width = sum(p.width for p in merged)
    return _I.get("concat", tuple(merged), (), width)


def extract(high: int, low: int, a: Node) -> Node:
    width = high - low + 1
    assert 0 <= low <= high < a.width
    if width == a.width:
        return a
    if a.is_const:
        return const(a.value >> low, width)
    if a.op == "concat":
        # narrow into the covered parts when the cut lines up
        offset = 0
        covered: List[Tuple[Node, int]] = []  # (part, low offset of part)
        for part in reversed(a.args):  # last arg = least significant
            covered.append((part, offset))
            offset += part.width
        for part, part_low in covered:
            if low >= part_low and high < part_low + part.width:
                return extract(high - part_low, low - part_low, part)
    if a.op in ("zext", "sext") and high < a.args[0].width:
        return extract(high, low, a.args[0])
    return _I.get("extract", (a,), (high, low), width)


def zext(extra: int, a: Node) -> Node:
    if extra == 0:
        return a
    if a.is_const:
        return const(a.value, a.width + extra)
    return _I.get("zext", (a,), (extra,), a.width + extra)


def sext(extra: int, a: Node) -> Node:
    if extra == 0:
        return a
    if a.is_const:
        return const(to_signed(a.value, a.width), a.width + extra)
    return _I.get("sext", (a,), (extra,), a.width + extra)


def ite(cond: Node, a: Node, b: Node) -> Node:
    assert cond.sort == "bool" and a.width == b.width and a.sort == b.sort
    if cond.is_const:
        return a if cond.value else b
    if a is b:
        return a
    return _I.get("ite", (cond, a, b), (), a.width, a.sort)


# ---------------------------------------------------------------------------
# Predicates -> bool nodes
# ---------------------------------------------------------------------------


def _cmp(op: str, a: Node, b: Node) -> Node:
    assert a.width == b.width
    return _I.get(op, (a, b), (), 0, "bool")


def eq(a: Node, b: Node) -> Node:
    if a is b:
        return TRUE
    if a.sort == "bool":
        return biff(a, b)
    if a.is_const and b.is_const:
        return bconst(a.value == b.value)
    if b.is_const:  # canonical: const on the left for eq
        a, b = b, a
    return _cmp("eq", a, b)


def ult(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return bconst(a.value < b.value)
    if b.is_const and b.value == 0:
        return FALSE
    if a.is_const and a.value == mask(a.width):
        return FALSE
    if a is b:
        return FALSE
    return _cmp("ult", a, b)


def ule(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return bconst(a.value <= b.value)
    if a.is_const and a.value == 0:
        return TRUE
    if b.is_const and b.value == mask(b.width):
        return TRUE
    if a is b:
        return TRUE
    return _cmp("ule", a, b)


def slt(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return bconst(to_signed(a.value, a.width) < to_signed(b.value, b.width))
    if a is b:
        return FALSE
    return _cmp("slt", a, b)


def sle(a: Node, b: Node) -> Node:
    if a.is_const and b.is_const:
        return bconst(to_signed(a.value, a.width) <= to_signed(b.value, b.width))
    if a is b:
        return TRUE
    return _cmp("sle", a, b)


# ---------------------------------------------------------------------------
# Boolean connectives
# ---------------------------------------------------------------------------


def band(a: Node, b: Node) -> Node:
    if a.is_const:
        return b if a.value else FALSE
    if b.is_const:
        return a if b.value else FALSE
    if a is b:
        return a
    if (a.op == "bnot" and a.args[0] is b) or (b.op == "bnot" and b.args[0] is a):
        return FALSE
    return _I.get("band", (a, b), (), 0, "bool")


def bor(a: Node, b: Node) -> Node:
    if a.is_const:
        return TRUE if a.value else b
    if b.is_const:
        return TRUE if b.value else a
    if a is b:
        return a
    if (a.op == "bnot" and a.args[0] is b) or (b.op == "bnot" and b.args[0] is a):
        return TRUE
    return _I.get("bor", (a, b), (), 0, "bool")


def bnot(a: Node) -> Node:
    if a.is_const:
        return bconst(not a.value)
    if a.op == "bnot":
        return a.args[0]
    # push negation through comparisons (keeps DAGs small & foldable)
    if a.op == "ult":
        return ule(a.args[1], a.args[0])
    if a.op == "ule":
        return ult(a.args[1], a.args[0])
    if a.op == "slt":
        return sle(a.args[1], a.args[0])
    if a.op == "sle":
        return slt(a.args[1], a.args[0])
    return _I.get("bnot", (a,), (), 0, "bool")


def bxor(a: Node, b: Node) -> Node:
    if a.is_const:
        return bnot(b) if a.value else b
    if b.is_const:
        return bnot(a) if b.value else a
    if a is b:
        return FALSE
    return _I.get("bxor", (a, b), (), 0, "bool")


def biff(a: Node, b: Node) -> Node:
    return bnot(bxor(a, b))


def implies(a: Node, b: Node) -> Node:
    return bor(bnot(a), b)


# ---------------------------------------------------------------------------
# Arrays & uninterpreted functions
# ---------------------------------------------------------------------------


def store(arr: Node, idx: Node, val: Node) -> Node:
    assert arr.sort == "array"
    dom, rng = array_sort(arr)
    assert idx.width == dom and val.width == rng
    if idx.is_const:
        # overwrite a previous store at the same concrete index
        if arr.op == "store" and arr.args[1].is_const:
            if arr.args[1].value == idx.value:
                return store(arr.args[0], idx, val)
    return _I.get("store", (arr, idx, val), (), 0, "array")


def select(arr: Node, idx: Node) -> Node:
    assert arr.sort == "array"
    dom, rng = array_sort(arr)
    assert idx.width == dom
    probe = arr
    while probe.op == "store":
        base, sidx, sval = probe.args
        if sidx is idx:
            return sval
        if sidx.is_const and idx.is_const:
            if sidx.value == idx.value:
                return sval
            probe = base  # definitely distinct index: skip this store
            continue
        break  # can't decide equality statically
    if probe.op == "constarr":
        return probe.args[0]
    # select over the pruned chain (skipped stores had concrete indices
    # provably distinct from a concrete idx)
    return _I.get("select", (probe, idx), (), rng)


def array_sort(arr: Node) -> Tuple[int, int]:
    probe = arr
    while probe.op in ("store", "ite"):
        probe = probe.args[0] if probe.op == "store" else probe.args[1]
    if probe.op == "avar":
        return probe.params[1], probe.params[2]
    if probe.op == "constarr":
        return probe.params[0], probe.params[1]
    raise TypeError(f"not an array root: {probe.op}")


def apply_uf(func: Node, args: Iterable[Node]) -> Node:
    assert func.sort == "uf"
    name, arg_widths, ret_width = func.params
    args = tuple(args)
    assert tuple(a.width for a in args) == tuple(arg_widths)
    return _I.get("apply", (func,) + args, (), ret_width)


# ---------------------------------------------------------------------------
# Evaluation under an environment (model completion / testing oracle)
# ---------------------------------------------------------------------------


class DefaultTable(dict):
    """Array cell table carrying its own unwritten-cell default.

    ``_eval_select`` falls back to the env-global ``array_default`` for
    cells missing from a plain table; when envs from independently
    solved constraint buckets are merged into one model, each bucket's
    default must travel with its tables (IndependenceSolver._restrict).
    """

    _MISSING = object()

    def __init__(self, data, default):
        super().__init__(data)
        self.default = default

    def get(self, key, default=_MISSING):
        # the table's own default applies only when the caller did not
        # pass one — plain dict.get semantics must not be shadowed for
        # callers that supply an explicit fallback
        if default is DefaultTable._MISSING:
            default = self.default
        return super().get(key, default)


class EvalEnv:
    """Environment for concrete evaluation.

    vars: node.id -> int (bitvec) / bool; arrays: node.id of the *root*
    avar -> dict {index: value} with .get default; ufs: (uf id, arg tuple)
    -> value.  Missing entries default to 0 / False / empty.
    """

    def __init__(self, variables=None, arrays=None, ufs=None,
                 array_default: int = 0):
        self.variables = variables or {}
        self.arrays = arrays or {}
        self.ufs = ufs or {}
        # value an unwritten cell of a symbolic array reads as — probe
        # candidates use 0xFF to satisfy "large input" constraints
        # (e.g. overflow conditions over calldata words)
        self.array_default = array_default


def evaluate(node: Node, env: EvalEnv, cache: Optional[dict] = None):
    if cache is None:
        cache = {}
    return _eval(node, env, cache)


def _eval(n: Node, env: EvalEnv, memo: dict):
    hit = memo.get(n.id)
    if hit is not None:
        return hit
    op = n.op
    if op == "const":
        result: Union[int, bool] = n.params[0]
    elif op == "bconst":
        result = n.params[0]
    elif op in ("var", "bvar"):
        result = env.variables.get(n.id, 0 if op == "var" else False)
    elif op == "ite":
        result = _eval(n.args[1] if _eval(n.args[0], env, memo) else n.args[2], env, memo)
    elif op == "select":
        result = _eval_select(n.args[0], _eval(n.args[1], env, memo), env, memo)
    elif op == "apply":
        func = n.args[0]
        argv = tuple(_eval(a, env, memo) for a in n.args[1:])
        result = env.ufs.get((func.id, argv), 0)
    else:
        argv = [_eval(a, env, memo) for a in n.args]
        w = n.width
        if op == "add":
            result = (argv[0] + argv[1]) & mask(w)
        elif op == "sub":
            result = (argv[0] - argv[1]) & mask(w)
        elif op == "mul":
            result = (argv[0] * argv[1]) & mask(w)
        elif op == "udiv":
            result = mask(w) if argv[1] == 0 else argv[0] // argv[1]
        elif op == "sdiv":
            if argv[1] == 0:
                result = (1 if to_signed(argv[0], w) < 0 else -1) & mask(w)
            else:
                sa, sb = to_signed(argv[0], w), to_signed(argv[1], w)
                q = abs(sa) // abs(sb)
                result = (-q if (sa < 0) != (sb < 0) else q) & mask(w)
        elif op == "urem":
            result = argv[0] if argv[1] == 0 else argv[0] % argv[1]
        elif op == "srem":
            if argv[1] == 0:
                result = argv[0]
            else:
                sa, sb = to_signed(argv[0], w), to_signed(argv[1], w)
                r = abs(sa) % abs(sb)
                result = (-r if sa < 0 else r) & mask(w)
        elif op == "and":
            result = argv[0] & argv[1]
        elif op == "or":
            result = argv[0] | argv[1]
        elif op == "xor":
            result = argv[0] ^ argv[1]
        elif op == "not":
            result = (~argv[0]) & mask(w)
        elif op == "shl":
            result = (argv[0] << argv[1]) & mask(w) if argv[1] < w else 0
        elif op == "lshr":
            result = argv[0] >> argv[1] if argv[1] < w else 0
        elif op == "ashr":
            result = to_signed(argv[0], w) >> min(argv[1], w - 1) & mask(w)
            result &= mask(w)
        elif op == "concat":
            acc = 0
            for a, v in zip(n.args, argv):
                acc = (acc << a.width) | v
            result = acc
        elif op == "extract":
            high, low = n.params
            result = (argv[0] >> low) & mask(high - low + 1)
        elif op == "zext":
            result = argv[0]
        elif op == "sext":
            result = to_signed(argv[0], n.args[0].width) & mask(w)
        elif op == "eq":
            result = argv[0] == argv[1]
        elif op == "ult":
            result = argv[0] < argv[1]
        elif op == "ule":
            result = argv[0] <= argv[1]
        elif op == "slt":
            aw = n.args[0].width
            result = to_signed(argv[0], aw) < to_signed(argv[1], aw)
        elif op == "sle":
            aw = n.args[0].width
            result = to_signed(argv[0], aw) <= to_signed(argv[1], aw)
        elif op == "band":
            result = argv[0] and argv[1]
        elif op == "bor":
            result = argv[0] or argv[1]
        elif op == "bnot":
            result = not argv[0]
        elif op == "bxor":
            result = bool(argv[0]) != bool(argv[1])
        else:
            raise NotImplementedError(f"eval: {op}")
    memo[n.id] = result
    return result


def _eval_select(arr: Node, idx_val: int, env: EvalEnv, memo: dict):
    while True:
        if arr.op == "store":
            if _eval(arr.args[1], env, memo) == idx_val:
                return _eval(arr.args[2], env, memo)
            arr = arr.args[0]
        elif arr.op == "ite":
            arr = arr.args[1] if _eval(arr.args[0], env, memo) else arr.args[2]
        elif arr.op == "constarr":
            return _eval(arr.args[0], env, memo)
        elif arr.op == "avar":
            return env.arrays.get(arr.id, {}).get(idx_val, env.array_default)
        else:
            raise NotImplementedError(f"select base: {arr.op}")


def collect_leaves(roots: Iterable[Node]):
    """All distinct var/bvar/avar/uf leaves and applications under roots."""
    seen = set()
    variables: List[Node] = []
    arrays: List[Node] = []
    applications: List[Node] = []
    selects: List[Node] = []
    stack = list(roots)
    while stack:
        n = stack.pop()
        if n.id in seen:
            continue
        seen.add(n.id)
        if n.op in ("var", "bvar"):
            variables.append(n)
        elif n.op == "avar":
            arrays.append(n)
        elif n.op == "apply":
            applications.append(n)
        elif n.op == "select":
            selects.append(n)
        stack.extend(n.args)
    return variables, arrays, applications, selects
