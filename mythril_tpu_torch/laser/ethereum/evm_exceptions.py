"""VM-level exceptions: semantic path-termination events, not crashes.

The worklist loop catches :class:`VmException` and ends or reverts the
offending path (``svm.handle_vm_exception``); detection semantics hang
off which event fired (e.g. SWC-110 anchors on paths that die at an
invalid instruction).  The taxonomy is pinned by EVM semantics;
reference counterpart: laser/ethereum/evm_exceptions.py.
"""


class VmException(Exception):
    """Base for all EVM-semantics failures."""


class StackUnderflowException(IndexError, VmException):
    """An opcode popped more operands than the stack holds.

    Doubles as ``IndexError`` so raw ``stack.pop()`` calls inside
    instruction mutators surface as the semantic event without a
    wrapper at every pop site."""


class StackOverflowException(VmException):
    """A push would exceed the 1023-item machine-stack limit."""


class InvalidJumpDestination(VmException):
    """JUMP/JUMPI resolved to a target that is not a JUMPDEST."""


class InvalidInstruction(VmException):
    """The opcode byte does not decode to any known instruction."""


class OutOfGasException(VmException):
    """The path's minimum gas use exceeds the transaction gas limit."""


class WriteProtection(VmException):
    """Mutating opcode executed inside a STATICCALL context."""
