"""Hostile-bytecode triage (own copy of
``mythril_tpu/disassembler/triage.py``): normalize anything ``eth_getCode`` (or an
operator's paste buffer) can return into bytes the pipeline is safe to
disassemble, and record every repair in a structured report.

Real deployed bytecode is adversarial by default: odd-length hex, CBOR
metadata tails that decode as garbage instructions, invalid/undefined
opcodes, EIP-170-busting blobs from networks with other limits, and
EIP-1167 minimal proxies whose 45 bytes say nothing about the code that
actually runs.  The triage pass is the single funnel every wild input
crosses before :class:`~mythril_tpu_torch.disassembler.disassembly.Disassembly`
sees it:

- **hex normalization** — ``0x`` prefix, surrounding whitespace, and a
  trailing odd nibble (truncated copy/paste) are repaired, never raised
  on; non-hex input is the only rejection, and it raises the typed
  :class:`BytecodeInputError` the CLI maps to a one-line exit 2.
- **metadata stripping** — the solc CBOR tail (bzzr/ipfs markers, same
  validation as ``asm._metadata_start``) is removed so downstream byte
  counts, code digests and size buckets describe *code*, not metadata.
- **size cap** — code longer than ``MYTHRIL_TPU_TRIAGE_MAX_CODE``
  bytes (default 4x the EIP-170 limit) is truncated with a note; the
  tail of a multi-megabyte blob is data, and unbounded input is how a
  never-crash envelope dies of OOM before the governor can help.
- **opcode census** — invalid/undefined bytes are *counted*, not
  raised on: the interpreter already treats them as terminating
  boundaries (``instructions.invalid_`` ends the path like the real
  EVM), so triage only classifies.
- **proxy fingerprinting** — the EIP-1167 minimal-proxy runtime is
  recognized exactly and its 20-byte delegate target extracted, so the
  loader can resolve the implementation through DynLoader instead of
  reporting on 45 bytes of trampoline.

``triage()`` never raises on bytes input; only str input with non-hex
characters raises :class:`BytecodeInputError`.
"""

from typing import List, Optional, Tuple, Union

from mythril_tpu_torch.disassembler import asm
from mythril_tpu_torch.exceptions import BytecodeInputError
from mythril_tpu_torch.support.env import env_int
from mythril_tpu_torch.support.opcodes import OPCODES

#: EIP-170 runtime-code ceiling; the triage cap defaults to 4x this so
#: chains with raised limits still pass while megabyte garbage doesn't
EIP170_MAX_CODE = 24576
DEFAULT_MAX_CODE = 4 * EIP170_MAX_CODE

# EIP-1167 minimal proxy runtime: push-calldata preamble, PUSH20
# <implementation>, DELEGATECALL postamble.  The fingerprint is exact
# (the standard fixes every byte outside the target) — a near-miss is
# some other trampoline and must not be chased.
_EIP1167_PRE = bytes.fromhex("363d3d373d3d3d363d73")
_EIP1167_POST = bytes.fromhex("5af43d82803e903d91602b57fd5bf3")


class TriageReport:
    """What triage did to one input: every repair is a field, so the
    loader, the sweep report, and ``meta.resilience`` can say *why* a
    contract's analyzed bytes differ from what arrived."""

    __slots__ = (
        "input_len", "code_len", "odd_nibble_dropped",
        "metadata_tail_len", "truncated_to", "invalid_ops",
        "push_truncated", "proxy_target", "notes",
    )

    def __init__(self):
        self.input_len = 0              # bytes that arrived (post-hex)
        self.code_len = 0               # bytes handed to analysis
        self.odd_nibble_dropped = False
        self.metadata_tail_len = 0      # stripped CBOR tail, in bytes
        self.truncated_to = None        # Optional[int]: size-cap cut
        self.invalid_ops = 0            # undefined bytes in code body
        self.push_truncated = False     # PUSH runs off end-of-code
        self.proxy_target = None        # Optional[str]: EIP-1167 impl
        self.notes: List[str] = []

    @property
    def repaired(self) -> bool:
        """True when triage changed or flagged anything — the signal
        that this contract deserves a triage block in its report."""
        return bool(
            self.odd_nibble_dropped or self.metadata_tail_len
            or self.truncated_to is not None or self.invalid_ops
            or self.push_truncated or self.proxy_target or self.notes
        )

    def as_dict(self) -> dict:
        out = {"input_len": self.input_len, "code_len": self.code_len}
        if self.odd_nibble_dropped:
            out["odd_nibble_dropped"] = True
        if self.metadata_tail_len:
            out["metadata_tail_len"] = self.metadata_tail_len
        if self.truncated_to is not None:
            out["truncated_to"] = self.truncated_to
        if self.invalid_ops:
            out["invalid_ops"] = self.invalid_ops
        if self.push_truncated:
            out["push_truncated"] = True
        if self.proxy_target:
            out["proxy_target"] = self.proxy_target
        if self.notes:
            out["notes"] = list(self.notes)
        return out


def normalize_hex(code: Union[str, bytes, bytearray],
                  report: Optional[TriageReport] = None) -> bytes:
    """Hex-or-bytes input to bytes.  Tolerates the ``0x`` prefix,
    whitespace (including interior newlines from wrapped paste buffers),
    and a trailing odd nibble; anything non-hex raises
    :class:`BytecodeInputError` with the offending character."""
    if isinstance(code, (bytes, bytearray)):
        out = bytes(code)
        if report is not None:
            report.input_len = len(out)
        return out
    text = "".join(code.split())
    text = text.removeprefix("0x").removeprefix("0X")
    if len(text) % 2:
        # a truncated copy/paste loses half a byte, not the contract:
        # drop the dangling nibble and say so
        text = text[:-1]
        if report is not None:
            report.odd_nibble_dropped = True
    try:
        out = bytes.fromhex(text)
    except ValueError as exc:
        raise BytecodeInputError(
            f"input is not hex-encoded bytecode: {exc}"
        ) from None
    if report is not None:
        report.input_len = len(out)
    return out


def metadata_tail_length(code: bytes) -> int:
    """Length in bytes of the solc CBOR metadata tail (0 when none).
    Same validation as the disassembler: the marker must sit exactly at
    ``len - 2 - declared``, where the final two bytes declare the CBOR
    payload length."""
    start = asm._metadata_start(bytes(code))
    return len(code) - start


def eip1167_target(code: bytes) -> Optional[str]:
    """The 0x-prefixed delegate address when ``code`` is an exact
    EIP-1167 minimal proxy runtime, else None."""
    expected = len(_EIP1167_PRE) + 20 + len(_EIP1167_POST)
    if len(code) != expected:
        return None
    if not code.startswith(_EIP1167_PRE):
        return None
    if not code.endswith(_EIP1167_POST):
        return None
    return "0x" + code[len(_EIP1167_PRE):len(_EIP1167_PRE) + 20].hex()


def _opcode_census(code: bytes, report: TriageReport) -> None:
    """Linear sweep counting undefined bytes and a PUSH that runs past
    end-of-code.  Classification only: the interpreter already treats
    both as terminating boundaries (INVALID ends the path, truncated
    PUSH arguments zero-pad per spec)."""
    pc = 0
    end = len(code)
    while pc < end:
        info = OPCODES.get(code[pc])
        if info is None:
            report.invalid_ops += 1
            pc += 1
            continue
        if info.name.startswith("PUSH"):
            width = code[pc] - 0x5F
            if pc + 1 + width > end:
                report.push_truncated = True
            pc += 1 + width
        else:
            pc += 1


def max_code_bytes() -> int:
    return env_int("MYTHRIL_TPU_TRIAGE_MAX_CODE", DEFAULT_MAX_CODE,
                   floor=1)


def triage(code: Union[str, bytes, bytearray],
           max_code: Optional[int] = None,
           strip_metadata: bool = True) -> Tuple[bytes, TriageReport]:
    """The full triage pass: returns ``(clean_code, report)``.

    ``clean_code`` is what analysis should run on — hex-normalized,
    metadata-stripped, size-capped.  ``report`` records every repair
    plus the opcode census and (when the input is an exact EIP-1167
    trampoline) the proxy's delegate target.  Raises only
    :class:`BytecodeInputError`, and only for non-hex string input.
    """
    report = TriageReport()
    raw = normalize_hex(code, report)
    clean = raw
    if strip_metadata:
        tail = metadata_tail_length(clean)
        if tail:
            report.metadata_tail_len = tail
            clean = clean[:-tail]
    # proxy fingerprint runs after the tail strip: the canonical
    # EIP-1167 runtime carries no metadata, but factory variants do
    # append one, and the trampoline underneath is still byte-exact
    report.proxy_target = eip1167_target(raw) or eip1167_target(clean)
    cap = max_code if max_code is not None else max_code_bytes()
    if len(clean) > cap:
        report.truncated_to = cap
        report.notes.append(
            f"code truncated from {len(clean)} to {cap} bytes "
            "(MYTHRIL_TPU_TRIAGE_MAX_CODE)"
        )
        clean = clean[:cap]
    _opcode_census(clean, report)
    report.code_len = len(clean)
    return clean, report
