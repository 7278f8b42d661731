"""Public SMT API — the seam between the symbolic VM and the solvers.

Own copy of ``mythril_tpu/smt/__init__.py`` for the PyTorch port.
Mirrors the surface of the reference's mythril/laser/smt/__init__.py
(symbol_factory, BitVec, Bool, Array, K, Function, helpers, Solver,
Optimize, Model) so everything above L0 reads the
same, but the implementation wraps our own interned term DAG
(``smt/terms.py``) instead of z3 ASTs, and satisfiability is decided by
the native CDCL and the dense device tier (``smt/solver/``,
``ops/``).

Semantics follow z3's operator conventions where the reference relied on
them: ``/`` and ``%`` are unsigned (the EVM layer requests signed ops
explicitly), ``<`` ``>`` are signed comparisons, ``>>`` is arithmetic.
"""

from typing import Iterable, List, Optional, Set, Union

from mythril_tpu_torch.smt import terms as T

Annotations = Set


class Expression:
    """Wrapper pairing a DAG node with an annotation set.

    Annotations propagate through every operator (union of operands) —
    the taint mechanism detection modules rely on (reference:
    laser/smt/expression.py).
    """

    __slots__ = ("node", "_annotations")

    def __init__(self, node: T.Node, annotations: Optional[Iterable] = None):
        self.node = node
        self._annotations = set(annotations) if annotations else set()

    @property
    def raw(self) -> T.Node:
        return self.node

    @property
    def annotations(self) -> Set:
        return self._annotations

    def annotate(self, annotation) -> None:
        self._annotations.add(annotation)

    def get_annotations(self, annotation_type):
        return [a for a in self._annotations if isinstance(a, annotation_type)]

    def simplify(self) -> None:
        pass  # construction-time simplification keeps nodes canonical

    def __hash__(self) -> int:
        return hash(self.node.id)

    def __repr__(self) -> str:
        return repr(self.node)

    @property
    def size(self) -> int:
        return self.node.width


def _anns(*xs) -> Set:
    out: Set = set()
    for x in xs:
        if isinstance(x, Expression):
            out |= x._annotations
    return out


class Bool(Expression):
    __slots__ = ("_py_truth",)

    @property
    def is_false(self) -> bool:
        return self.node is T.FALSE

    @property
    def is_true(self) -> bool:
        return self.node is T.TRUE

    @property
    def value(self) -> Optional[bool]:
        return self.node.value if self.node.is_const else None

    def __bool__(self) -> bool:
        if self.node.is_const:
            return bool(self.node.value)
        # z3py convention: bool() of a non-constant ==/!= expression
        # answers *structural* equality of its operands (z3 ExprRef
        # __bool__).  The answer is recorded at construction time by
        # __eq__/__ne__ — inferring it from node shape is unsound because
        # constant folding collapses e.g. biff(eq, FALSE) into bnot(eq).
        truth = getattr(self, "_py_truth", None)
        if truth is not None:
            return truth
        raise TypeError("truth value of a symbolic Bool is undefined")

    def __eq__(self, other) -> "Bool":  # type: ignore[override]
        other = _to_bool(other)
        result = Bool(T.biff(self.node, other.node), _anns(self, other))
        result._py_truth = self.node is other.node
        return result

    def __ne__(self, other) -> "Bool":  # type: ignore[override]
        other = _to_bool(other)
        result = Bool(T.bxor(self.node, other.node), _anns(self, other))
        result._py_truth = self.node is not other.node
        return result

    def __and__(self, other) -> "Bool":
        return And(self, _to_bool(other))

    def __or__(self, other) -> "Bool":
        return Or(self, _to_bool(other))

    def __invert__(self) -> "Bool":
        return Not(self)

    def __hash__(self) -> int:
        return hash(self.node.id)

    def substitute(self, original, new):
        raise NotImplementedError("substitution is not used by this build")


class BitVec(Expression):
    def __init__(self, node: T.Node, annotations: Optional[Iterable] = None):
        assert node.sort == "bv", node
        super().__init__(node, annotations)

    @property
    def symbolic(self) -> bool:
        return not self.node.is_const

    @property
    def value(self) -> Optional[int]:
        return self.node.value

    def __bool__(self) -> bool:
        if self.node.is_const:
            return self.node.value != 0
        raise TypeError("truth value of a symbolic BitVec is undefined")

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.add(a.node, b.node), _anns(a, b))

    __radd__ = __add__

    def __sub__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.sub(a.node, b.node), _anns(a, b))

    def __rsub__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.sub(b.node, a.node), _anns(a, b))

    def __mul__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.mul(a.node, b.node), _anns(a, b))

    __rmul__ = __mul__

    def __truediv__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.udiv(a.node, b.node), _anns(a, b))

    def __mod__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.urem(a.node, b.node), _anns(a, b))

    def __neg__(self) -> "BitVec":
        return BitVec(T.sub(T.const(0, self.size), self.node), _anns(self))

    # -- bitwise ---------------------------------------------------------
    def __and__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.bv_and(a.node, b.node), _anns(a, b))

    __rand__ = __and__

    def __or__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.bv_or(a.node, b.node), _anns(a, b))

    __ror__ = __or__

    def __xor__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.bv_xor(a.node, b.node), _anns(a, b))

    __rxor__ = __xor__

    def __invert__(self) -> "BitVec":
        return BitVec(T.bv_not(self.node), _anns(self))

    def __lshift__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.shl(a.node, b.node), _anns(a, b))

    def __rshift__(self, other) -> "BitVec":
        a, b = _pad(self, other)
        return BitVec(T.ashr(a.node, b.node), _anns(a, b))

    # -- comparisons (signed, z3 convention) -----------------------------
    def __lt__(self, other) -> Bool:
        a, b = _pad(self, other)
        return Bool(T.slt(a.node, b.node), _anns(a, b))

    def __gt__(self, other) -> Bool:
        a, b = _pad(self, other)
        return Bool(T.slt(b.node, a.node), _anns(a, b))

    def __le__(self, other) -> Bool:
        a, b = _pad(self, other)
        return Bool(T.sle(a.node, b.node), _anns(a, b))

    def __ge__(self, other) -> Bool:
        a, b = _pad(self, other)
        return Bool(T.sle(b.node, a.node), _anns(a, b))

    def __eq__(self, other) -> Bool:  # type: ignore[override]
        if other is None:
            return Bool(T.FALSE)
        a, b = _pad(self, other)
        result = Bool(T.eq(a.node, b.node), _anns(a, b))
        result._py_truth = a.node is b.node
        return result

    def __ne__(self, other) -> Bool:  # type: ignore[override]
        if other is None:
            return Bool(T.TRUE)
        a, b = _pad(self, other)
        result = Bool(T.bnot(T.eq(a.node, b.node)), _anns(a, b))
        result._py_truth = a.node is not b.node
        return result

    def __hash__(self) -> int:
        return hash(self.node.id)


class BitVecFunc(BitVec):
    """A bitvector produced by an uninterpreted-function application.

    Carries ``func_name`` and ``input_`` so the keccak manager and
    analysis code can recognize and invert hash applications (reference:
    laser/smt/bitvecfunc.py).
    """

    __slots__ = ("func_name", "input_", "nested_functions")

    def __init__(self, node, func_name, input_=None, annotations=None, nested=None):
        super().__init__(node, annotations)
        self.func_name = func_name
        self.input_ = input_
        self.nested_functions = list(nested or [])

    def __hash__(self) -> int:
        return hash(self.node.id)


# ---------------------------------------------------------------------------
# Coercion helpers
# ---------------------------------------------------------------------------


def _to_bv(x, width: int) -> BitVec:
    if isinstance(x, BitVec):
        return x
    if isinstance(x, bool):
        raise TypeError("bool where BitVec expected")
    if isinstance(x, int):
        return BitVec(T.const(x, width))
    raise TypeError(f"cannot coerce {type(x)} to BitVec")


def _to_bool(x) -> Bool:
    if isinstance(x, Bool):
        return x
    if isinstance(x, bool):
        return Bool(T.bconst(x))
    raise TypeError(f"cannot coerce {type(x)} to Bool")


def _pad(a, b):
    """Coerce + zero-pad to a common width (reference: _padded_operation)."""
    if isinstance(a, BitVec) and not isinstance(b, BitVec):
        b = _to_bv(b, a.size)
    elif isinstance(b, BitVec) and not isinstance(a, BitVec):
        a = _to_bv(a, b.size)
    if a.size == b.size:
        return a, b
    if a.size < b.size:
        a = BitVec(T.zext(b.size - a.size, a.node), a.annotations)
    else:
        b = BitVec(T.zext(a.size - b.size, b.node), b.annotations)
    return a, b


# ---------------------------------------------------------------------------
# Arrays and functions
# ---------------------------------------------------------------------------


class BaseArray:
    """Mutable wrapper over an array-sorted node (z3-style Store/Select)."""

    __slots__ = ("node",)

    def __init__(self, node: T.Node):
        self.node = node

    @property
    def raw(self) -> T.Node:
        return self.node

    def __getitem__(self, item: BitVec) -> BitVec:
        dom, _ = T.array_sort(self.node)
        item = _to_bv(item, dom)
        return BitVec(T.select(self.node, item.node), set(item.annotations))

    def __setitem__(self, key: BitVec, value) -> None:
        dom, rng = T.array_sort(self.node)
        key = _to_bv(key, dom)
        value = _to_bv(value, rng)
        self.node = T.store(self.node, key.node, value.node)

    def substitute(self, original, new):
        raise NotImplementedError


class Array(BaseArray):
    def __init__(self, name: str, domain: int, value_range: int):
        super().__init__(T.avar(name, domain, value_range))


class K(BaseArray):
    def __init__(self, domain: int, value_range: int, value: int):
        super().__init__(
            T.const_array(domain, value_range, T.const(value, value_range))
        )


class Function:
    """Uninterpreted function (keccak modeling; reference smt/function.py)."""

    __slots__ = ("node", "name", "domain", "value_range")

    def __init__(self, name: str, domain, value_range: int):
        if isinstance(domain, int):
            domain = [domain]
        self.name = name
        self.domain = tuple(domain)
        self.value_range = value_range
        self.node = T.uf(name, self.domain, value_range)

    def __call__(self, *args) -> BitVecFunc:
        bv_args = [_to_bv(a, w) for a, w in zip(args, self.domain)]
        node = T.apply_uf(self.node, [a.node for a in bv_args])
        input_ = bv_args[0] if len(bv_args) == 1 else None
        return BitVecFunc(node, self.name, input_, _anns(*bv_args))

    def __eq__(self, other) -> bool:
        return isinstance(other, Function) and self.node is other.node

    def __hash__(self) -> int:
        return hash(self.node.id)


# ---------------------------------------------------------------------------
# Free helpers (reference: laser/smt/bitvec_helper.py, bool.py)
# ---------------------------------------------------------------------------


def If(cond, then_value, else_value):
    if isinstance(cond, bool):
        cond = Bool(T.bconst(cond))
    # promote ints using the other branch's width
    if isinstance(then_value, int) and isinstance(else_value, BitVec):
        then_value = _to_bv(then_value, else_value.size)
    if isinstance(else_value, int) and isinstance(then_value, BitVec):
        else_value = _to_bv(else_value, then_value.size)
    if isinstance(then_value, BitVec) and isinstance(else_value, BitVec):
        a, b = _pad(then_value, else_value)
        return BitVec(
            T.ite(cond.node, a.node, b.node), _anns(cond, a, b)
        )
    if isinstance(then_value, Bool) and isinstance(else_value, Bool):
        return Bool(
            T.bor(
                T.band(cond.node, then_value.node),
                T.band(T.bnot(cond.node), else_value.node),
            ),
            _anns(cond, then_value, else_value),
        )
    raise TypeError("If branches must both be BitVec or Bool")


def UGT(a: BitVec, b: BitVec) -> Bool:
    a, b = _pad(a, b)
    return Bool(T.ult(b.node, a.node), _anns(a, b))


def UGE(a: BitVec, b: BitVec) -> Bool:
    a, b = _pad(a, b)
    return Bool(T.ule(b.node, a.node), _anns(a, b))


def ULT(a: BitVec, b: BitVec) -> Bool:
    a, b = _pad(a, b)
    return Bool(T.ult(a.node, b.node), _anns(a, b))


def ULE(a: BitVec, b: BitVec) -> Bool:
    a, b = _pad(a, b)
    return Bool(T.ule(a.node, b.node), _anns(a, b))


def SLT(a: BitVec, b: BitVec) -> Bool:
    a, b = _pad(a, b)
    return Bool(T.slt(a.node, b.node), _anns(a, b))


def SGT(a: BitVec, b: BitVec) -> Bool:
    a, b = _pad(a, b)
    return Bool(T.slt(b.node, a.node), _anns(a, b))


def UDiv(a: BitVec, b: BitVec) -> BitVec:
    a, b = _pad(a, b)
    return BitVec(T.udiv(a.node, b.node), _anns(a, b))


def SDiv(a: BitVec, b: BitVec) -> BitVec:
    a, b = _pad(a, b)
    return BitVec(T.sdiv(a.node, b.node), _anns(a, b))


def URem(a: BitVec, b: BitVec) -> BitVec:
    a, b = _pad(a, b)
    return BitVec(T.urem(a.node, b.node), _anns(a, b))


def SRem(a: BitVec, b: BitVec) -> BitVec:
    a, b = _pad(a, b)
    return BitVec(T.srem(a.node, b.node), _anns(a, b))


def LShR(a: BitVec, b: BitVec) -> BitVec:
    a, b = _pad(a, b)
    return BitVec(T.lshr(a.node, b.node), _anns(a, b))


def Concat(*args) -> BitVec:
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    bvs = [a if isinstance(a, BitVec) else _to_bv(a, 8) for a in args]
    return BitVec(T.concat([a.node for a in bvs]), _anns(*bvs))


def Extract(high: int, low: int, bv: BitVec) -> BitVec:
    return BitVec(T.extract(high, low, bv.node), _anns(bv))


def ZeroExt(extra: int, bv: BitVec) -> BitVec:
    return BitVec(T.zext(extra, bv.node), _anns(bv))


def SignExt(extra: int, bv: BitVec) -> BitVec:
    return BitVec(T.sext(extra, bv.node), _anns(bv))


def Sum(*args) -> BitVec:
    total = args[0]
    for a in args[1:]:
        total = total + a
    return total


def BVAddNoOverflow(a, b, signed: bool) -> Bool:
    a, b = _pad(a, b)
    w = a.size
    if signed:
        ea, eb = SignExt(1, a), SignExt(1, b)
        total = ea + eb
        lo = BitVec(T.const(-(1 << (w - 1)), w + 1))
        hi = BitVec(T.const((1 << (w - 1)) - 1, w + 1))
        return And(total >= lo, total <= hi)
    ea, eb = ZeroExt(1, a), ZeroExt(1, b)
    return Bool(T.eq(T.extract(w, w, (ea + eb).node), T.const(0, 1)), _anns(a, b))


def BVMulNoOverflow(a, b, signed: bool) -> Bool:
    a, b = _pad(a, b)
    w = a.size
    if signed:
        product = SignExt(w, a) * SignExt(w, b)
        lo = BitVec(T.const(-(1 << (w - 1)), 2 * w))
        hi = BitVec(T.const((1 << (w - 1)) - 1, 2 * w))
        return And(product >= lo, product <= hi)
    product = ZeroExt(w, a) * ZeroExt(w, b)
    return Bool(
        T.eq(T.extract(2 * w - 1, w, product.node), T.const(0, w)), _anns(a, b)
    )


def BVSubNoUnderflow(a, b, signed: bool) -> Bool:
    a, b = _pad(a, b)
    w = a.size
    if signed:
        diff = SignExt(1, a) - SignExt(1, b)
        lo = BitVec(T.const(-(1 << (w - 1)), w + 1))
        hi = BitVec(T.const((1 << (w - 1)) - 1, w + 1))
        return And(diff >= lo, diff <= hi)
    return UGE(a, b)


def And(*args) -> Bool:
    bools = [_to_bool(a) for a in args]
    node = T.TRUE
    for b in bools:
        node = T.band(node, b.node)
    return Bool(node, _anns(*bools))


def Or(*args) -> Bool:
    bools = [_to_bool(a) for a in args]
    node = T.FALSE
    for b in bools:
        node = T.bor(node, b.node)
    return Bool(node, _anns(*bools))


def Not(a: Bool) -> Bool:
    a = _to_bool(a)
    return Bool(T.bnot(a.node), _anns(a))


def Xor(a: Bool, b: Bool) -> Bool:
    a, b = _to_bool(a), _to_bool(b)
    return Bool(T.bxor(a.node, b.node), _anns(a, b))


def Implies(a: Bool, b: Bool) -> Bool:
    a, b = _to_bool(a), _to_bool(b)
    return Bool(T.implies(a.node, b.node), _anns(a, b))


def is_true(a: Bool) -> bool:
    return isinstance(a, Bool) and a.is_true


def is_false(a: Bool) -> bool:
    return isinstance(a, Bool) and a.is_false


def simplify(expression: Expression) -> Expression:
    return expression  # nodes are canonical by construction


# ---------------------------------------------------------------------------
# Symbol factory (the single construction point for symbols)
# ---------------------------------------------------------------------------


class SymbolFactory:
    @staticmethod
    def BitVecVal(value: int, size: int, annotations=None) -> BitVec:
        return BitVec(T.const(value, size), annotations)

    @staticmethod
    def BitVecSym(name: str, size: int, annotations=None) -> BitVec:
        return BitVec(T.var(name, size), annotations)

    @staticmethod
    def BoolVal(value: bool, annotations=None) -> Bool:
        return Bool(T.bconst(value), annotations)

    @staticmethod
    def BoolSym(name: str, annotations=None) -> Bool:
        return Bool(T.bvar(name), annotations)


symbol_factory = SymbolFactory()

from mythril_tpu_torch.smt.model import Model  # noqa: E402  (re-export)
from mythril_tpu_torch.smt.solver import (  # noqa: E402
    Optimize,
    Solver,
    SolverStatistics,
)

__all__ = [
    "Expression", "BitVec", "BitVecFunc", "Bool", "Array", "K", "BaseArray",
    "Function", "If", "UGT", "UGE", "ULT", "ULE", "SLT", "SGT", "UDiv",
    "SDiv", "URem", "SRem", "LShR", "Concat", "Extract", "ZeroExt", "SignExt",
    "Sum", "BVAddNoOverflow", "BVMulNoOverflow", "BVSubNoUnderflow", "And",
    "Or", "Not", "Xor", "Implies", "is_true", "is_false", "simplify",
    "symbol_factory", "Model", "Solver", "Optimize", "SolverStatistics",
]
