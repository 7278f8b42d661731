"""Bytecode input normalization (own copy of the part of
``mythril_tpu/disassembler/triage.py`` that bytecode input crosses: the
metadata, size-cap, opcode-census and proxy passes serve on-chain
loading, which the port does not have).

``0x`` prefix, surrounding whitespace and a trailing odd nibble
(truncated copy/paste) are repaired, never raised on; non-hex input is
the only rejection, and it raises the typed :class:`BytecodeInputError`
the CLI maps to a one-line exit 2.
"""

from typing import Union

from mythril_tpu_torch.exceptions import BytecodeInputError


def normalize_hex(code: Union[str, bytes, bytearray]) -> bytes:
    """Hex-or-bytes input to bytes.  Tolerates the ``0x`` prefix,
    whitespace (including interior newlines from wrapped paste buffers),
    and a trailing odd nibble; anything non-hex raises
    :class:`BytecodeInputError` with the offending character."""
    if isinstance(code, (bytes, bytearray)):
        return bytes(code)
    text = "".join(code.split())
    text = text.removeprefix("0x").removeprefix("0X")
    if len(text) % 2:
        # a truncated copy/paste loses half a byte, not the contract:
        # drop the dangling nibble
        text = text[:-1]
    try:
        return bytes.fromhex(text)
    except ValueError as exc:
        raise BytecodeInputError(
            f"input is not hex-encoded bytecode: {exc}"
        ) from None
