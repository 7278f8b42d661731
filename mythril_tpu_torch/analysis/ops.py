"""Concrete-or-symbolic value tagging for the statespace post-pass.

The POST-entrypoint detection modules walk recorded states and need a
uniform answer to "is this stack operand a number I can use, or still
an expression?".  :func:`get_variable` classifies an operand once and
the wrappers carry that tag alongside the payload.

Reference counterpart: mythril/analysis/ops.py (VarType/Variable/Call
surface; the classification itself rides on our term DAG's
``symbolic`` flag instead of z3 AST probing).
"""

from enum import Enum

from mythril_tpu_torch.smt import BitVec, Bool, simplify


class VarType(Enum):
    SYMBOLIC = 1
    CONCRETE = 2


class Variable:
    """A stack operand tagged with its concreteness."""

    __slots__ = ("val", "type")

    def __init__(self, val, _type):
        self.val = val
        self.type = _type

    @classmethod
    def concrete(cls, value: int) -> "Variable":
        return cls(value, VarType.CONCRETE)

    @classmethod
    def symbolic(cls, expression) -> "Variable":
        return cls(simplify(expression), VarType.SYMBOLIC)

    @property
    def is_concrete(self) -> bool:
        return self.type == VarType.CONCRETE

    def __str__(self):
        return str(self.val)

    def __repr__(self):
        tag = "concrete" if self.is_concrete else "symbolic"
        return f"<Variable {tag} {self.val}>"


def get_variable(operand) -> Variable:
    """Classify one operand: ints, constant bitvectors, and constant
    bools come back CONCRETE with a Python int payload; anything still
    containing free symbols comes back SYMBOLIC with a simplified
    expression payload."""
    if isinstance(operand, int):
        return Variable.concrete(operand)
    if isinstance(operand, BitVec) and not operand.symbolic:
        return Variable.concrete(operand.value)
    if isinstance(operand, Bool) and operand.value is not None:
        return Variable.concrete(int(operand.value))
    return Variable.symbolic(operand)


class Op:
    """A recorded operation: where in the statespace it happened."""

    __slots__ = ("node", "state", "state_index")

    def __init__(self, node, state, state_index):
        self.node = node
        self.state = state
        self.state_index = state_index


class Call(Op):
    """A message call captured by the post-pass, with its classified
    operands (consumed by the POST modules via SymExecWrapper.calls)."""

    __slots__ = ("to", "gas", "type", "value", "data")

    def __init__(self, node, state, state_index, _type, to, gas,
                 value=None, data=None):
        super().__init__(node, state, state_index)
        self.to = to
        self.gas = gas
        self.type = _type
        self.value = value if value is not None else Variable.concrete(0)
        self.data = data

    def __repr__(self):
        return f"<Call {self.type} to={self.to} value={self.value}>"
