"""EVM opcode table: byte -> OpInfo(name, pops, pushes, gas bounds).

Behavioral spec mirrors the reference's table (mythril/support/opcodes.py
and mythril/laser/ethereum/instruction_data.py) — Istanbul-era opcode set
including CHAINID / SELFBALANCE / CREATE2 / EXTCODEHASH / SHL / SHR / SAR,
plus the synthetic ASSERT_FAIL opcode at 0xFE used by Solidity's
``assert`` failure path.  Gas is tracked as a (min, max) interval per
opcode because symbolic execution cannot always know dynamic costs; the
intervals match the reference's so the VMTests gas oracle and issue gas
estimates stay comparable.
"""

from typing import Dict, NamedTuple, Optional, Tuple


class OpInfo(NamedTuple):
    byte: int
    name: str
    pops: int
    pushes: int
    gas_min: int
    gas_max: int


# Rough upper bound for a copy op's dynamic cost: 3 gas per word over a
# generous 768-word region (same bound the reference assumes).
_COPY_MAX = 3 * 768
# Memory expansion upper bounds assumed for single-word r/w (1KB region).
_MLOAD_MAX, _MSTORE_MAX = 96, 98
_LOG_DATA_MAX = 8 * 32
_CALL_MAX_EXTRA = 9000 + 25000  # value transfer + new-account stipend


def _table() -> Dict[int, OpInfo]:
    t: Dict[int, OpInfo] = {}

    def op(byte: int, name: str, pops: int, pushes: int, gas, gas_max=None):
        lo, hi = (gas, gas) if gas_max is None else (gas, gas_max)
        t[byte] = OpInfo(byte, name, pops, pushes, lo, hi)

    # 0x00s: stop & arithmetic
    op(0x00, "STOP", 0, 0, 0)
    op(0x01, "ADD", 2, 1, 3)
    op(0x02, "MUL", 2, 1, 5)
    op(0x03, "SUB", 2, 1, 3)
    op(0x04, "DIV", 2, 1, 5)
    op(0x05, "SDIV", 2, 1, 5)
    op(0x06, "MOD", 2, 1, 5)
    op(0x07, "SMOD", 2, 1, 5)
    op(0x08, "ADDMOD", 3, 1, 8)
    op(0x09, "MULMOD", 3, 1, 8)
    op(0x0A, "EXP", 2, 1, 10, 340)  # dynamic: 10 + 50/exponent-byte (≤2^32 assumed)
    op(0x0B, "SIGNEXTEND", 2, 1, 5)
    # 0x10s: comparison & bitwise
    op(0x10, "LT", 2, 1, 3)
    op(0x11, "GT", 2, 1, 3)
    op(0x12, "SLT", 2, 1, 3)
    op(0x13, "SGT", 2, 1, 3)
    op(0x14, "EQ", 2, 1, 3)
    op(0x15, "ISZERO", 1, 1, 3)
    op(0x16, "AND", 2, 1, 3)
    op(0x17, "OR", 2, 1, 3)
    op(0x18, "XOR", 2, 1, 3)
    op(0x19, "NOT", 1, 1, 3)
    op(0x1A, "BYTE", 2, 1, 3)
    op(0x1B, "SHL", 2, 1, 3)
    op(0x1C, "SHR", 2, 1, 3)
    op(0x1D, "SAR", 2, 1, 3)
    # 0x20s
    op(0x20, "SHA3", 2, 1, 30, 30 + 6 * 8)  # dynamic: 30 + 6/word; 8-word bound
    # 0x30s: environment
    op(0x30, "ADDRESS", 0, 1, 2)
    op(0x31, "BALANCE", 1, 1, 700)
    op(0x32, "ORIGIN", 0, 1, 2)
    op(0x33, "CALLER", 0, 1, 2)
    op(0x34, "CALLVALUE", 0, 1, 2)
    op(0x35, "CALLDATALOAD", 1, 1, 3)
    op(0x36, "CALLDATASIZE", 0, 1, 2)
    op(0x37, "CALLDATACOPY", 3, 0, 2, 2 + _COPY_MAX)
    op(0x38, "CODESIZE", 0, 1, 2)
    op(0x39, "CODECOPY", 3, 0, 2, 2 + _COPY_MAX)
    op(0x3A, "GASPRICE", 0, 1, 2)
    op(0x3B, "EXTCODESIZE", 1, 1, 700)
    op(0x3C, "EXTCODECOPY", 4, 0, 700, 700 + _COPY_MAX)
    op(0x3D, "RETURNDATASIZE", 0, 1, 2)
    op(0x3E, "RETURNDATACOPY", 3, 0, 3)
    op(0x3F, "EXTCODEHASH", 1, 1, 700)
    # 0x40s: block
    op(0x40, "BLOCKHASH", 1, 1, 20)
    op(0x41, "COINBASE", 0, 1, 2)
    op(0x42, "TIMESTAMP", 0, 1, 2)
    op(0x43, "NUMBER", 0, 1, 2)
    op(0x44, "DIFFICULTY", 0, 1, 2)
    op(0x45, "GASLIMIT", 0, 1, 2)
    op(0x46, "CHAINID", 0, 1, 2)
    op(0x47, "SELFBALANCE", 0, 1, 5)
    # 0x50s: stack/memory/storage/flow
    op(0x50, "POP", 1, 0, 2)
    op(0x51, "MLOAD", 1, 1, 3, _MLOAD_MAX)
    op(0x52, "MSTORE", 2, 0, 3, _MSTORE_MAX)
    op(0x53, "MSTORE8", 2, 0, 3, _MSTORE_MAX)
    op(0x54, "SLOAD", 1, 1, 800)
    op(0x55, "SSTORE", 2, 0, 5000, 25000)
    op(0x56, "JUMP", 1, 0, 8)
    op(0x57, "JUMPI", 2, 0, 10)
    op(0x58, "PC", 0, 1, 2)
    op(0x59, "MSIZE", 0, 1, 2)
    op(0x5A, "GAS", 0, 1, 2)
    op(0x5B, "JUMPDEST", 0, 0, 1)
    # 0x60-0x7f: PUSH1..PUSH32
    for i in range(1, 33):
        op(0x5F + i, f"PUSH{i}", 0, 1, 3)
    # 0x80-0x8f: DUP1..DUP16
    for i in range(1, 17):
        op(0x7F + i, f"DUP{i}", i, i + 1, 3)
    # 0x90-0x9f: SWAP1..SWAP16
    for i in range(1, 17):
        op(0x8F + i, f"SWAP{i}", i + 1, i + 1, 3)
    # 0xa0s: logging
    for i in range(5):
        op(0xA0 + i, f"LOG{i}", i + 2, 0, (i + 1) * 375, (i + 1) * 375 + _LOG_DATA_MAX)
    # 0xf0s: system
    op(0xF0, "CREATE", 3, 1, 32000)
    op(0xF1, "CALL", 7, 1, 700, 700 + _CALL_MAX_EXTRA)
    op(0xF2, "CALLCODE", 7, 1, 700, 700 + _CALL_MAX_EXTRA)
    op(0xF3, "RETURN", 2, 0, 0)
    op(0xF4, "DELEGATECALL", 6, 1, 700, 700 + _CALL_MAX_EXTRA)
    op(0xF5, "CREATE2", 4, 1, 32000)
    op(0xFA, "STATICCALL", 6, 1, 700, 700 + _CALL_MAX_EXTRA)
    op(0xFD, "REVERT", 2, 0, 0)
    # Synthetic: Solidity emits INVALID (0xfe) for failed assert()s; the
    # reference disassembles it as ASSERT_FAIL and hooks SWC-110 on it.
    op(0xFE, "ASSERT_FAIL", 0, 0, 0)
    op(0xFF, "SUICIDE", 1, 0, 5000, 30000)
    return t


OPCODES: Dict[int, OpInfo] = _table()
BY_NAME: Dict[str, OpInfo] = {info.name: info for info in OPCODES.values()}

# Word-size gas constants for dynamic costs (yellow-paper names).
GSHA3WORD = 6
GCOPY = 3
GMEMORY = 3
GQUADRATICMEMDENOM = 512
GECRECOVER = 3000
GSHA256BASE, GSHA256WORD = 60, 12
GRIPEMD160BASE, GRIPEMD160WORD = 600, 120
GIDENTITYBASE, GIDENTITYWORD = 15, 3
GSTIPEND = 2300
BLOCK_GAS_LIMIT = 8_000_000


def ceil32(n: int) -> int:
    return (n + 31) & ~31


def get_info(byte: int) -> Optional[OpInfo]:
    return OPCODES.get(byte)


def get_opcode_gas(name: str) -> Tuple[int, int]:
    info = BY_NAME[name]
    return info.gas_min, info.gas_max


def get_required_stack_elements(name: str) -> int:
    return BY_NAME[name].pops


def calculate_sha3_gas(length: int) -> Tuple[int, int]:
    g = 30 + GSHA3WORD * (ceil32(length) // 32)
    return g, g


def calculate_native_gas(size: int, contract: str) -> Tuple[int, int]:
    words = ceil32(size) // 32
    g = {
        "ecrecover": GECRECOVER,
        "sha256": GSHA256BASE + words * GSHA256WORD,
        "ripemd160": GRIPEMD160BASE + words * GRIPEMD160WORD,
        "identity": GIDENTITYBASE + words * GIDENTITYWORD,
    }.get(contract, 0)
    return g, g
