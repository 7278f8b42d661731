"""A tiny EVM assembler.

The environment has no ``solc`` binary, so test fixtures and benchmark
contracts are authored directly in EVM assembly.  This module has no
counterpart in the reference (which shells out to solc,
mythril/ethereum/util.py:31); it exists so the framework is
self-contained.

Syntax: one instruction per line (or ``;``-separated), ``#`` comments.
``PUSH`` without a size picks the smallest fitting width.  Labels are
written ``label:`` and referenced as ``@label`` (assembled as a PUSH2 of
the label's byte offset, patched in a second pass).

Example::

    asm('''
        CALLVALUE; ISZERO; PUSH @ok; JUMPI
        PUSH 0; PUSH 0; REVERT
      ok:
        JUMPDEST; STOP
    ''')
"""

from typing import Dict, List, Tuple, Union

from mythril_tpu_torch.support.opcodes import BY_NAME


def _push_width(value: int) -> int:
    return max(1, (value.bit_length() + 7) // 8)


def assemble(source: str) -> bytes:
    """Assemble mnemonic source into EVM bytecode."""
    tokens: List[Union[Tuple[str, object], Tuple[str, str]]] = []
    for raw_line in source.replace(";", "\n").splitlines():
        line = raw_line.split("#")[0].strip()
        if not line:
            continue
        if line.endswith(":") and " " not in line:
            tokens.append(("label", line[:-1]))
            continue
        parts = line.split()
        mnem = parts[0].upper()
        arg = parts[1] if len(parts) > 1 else None
        tokens.append(("op", (mnem, arg)))

    # Pass 1: lay out and record label offsets.  Label refs always use
    # PUSH2 so offsets are stable across passes.
    labels: Dict[str, int] = {}
    offset = 0
    layout: List[Tuple[str, object, int]] = []
    for kind, payload in tokens:
        if kind == "label":
            labels[payload] = offset  # type: ignore[index]
            continue
        mnem, arg = payload  # type: ignore[misc]
        if mnem == "PUSH" and arg is not None and arg.startswith("@"):
            layout.append(("pushlabel", arg[1:], offset))
            offset += 3
        elif mnem == "PUSH" and arg is not None:
            value = int(arg, 0)
            width = _push_width(value)
            layout.append(("push", (width, value), offset))
            offset += 1 + width
        elif mnem.startswith("PUSH") and mnem != "PUSH0" and arg is not None:
            width = int(mnem[4:])
            value = int(arg, 0)
            layout.append(("push", (width, value), offset))
            offset += 1 + width
        else:
            if mnem not in BY_NAME:
                raise ValueError(f"unknown mnemonic {mnem!r}")
            layout.append(("plain", mnem, offset))
            offset += 1

    # Pass 2: emit bytes.
    out = bytearray()
    for kind, payload, _ in layout:
        if kind == "plain":
            out.append(BY_NAME[payload].byte)  # type: ignore[index]
        elif kind == "push":
            width, value = payload  # type: ignore[misc]
            out.append(BY_NAME[f"PUSH{width}"].byte)
            out += value.to_bytes(width, "big")
        else:  # pushlabel
            name = payload
            if name not in labels:
                raise ValueError(f"undefined label {name!r}")
            out.append(BY_NAME["PUSH2"].byte)
            out += labels[name].to_bytes(2, "big")  # type: ignore[index]
    return bytes(out)


def asm(source: str) -> str:
    """Assemble to a hex string (no 0x prefix)."""
    return assemble(source).hex()
