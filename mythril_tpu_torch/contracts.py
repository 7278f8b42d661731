"""Test contracts of the port, built with its own assembler
(``support/assembler.py``; no solc is needed).

Byte-for-byte the contracts of the repository's ``bench.py``
(``_corpus``, ``scale_contract`` and ``batchtoken_contract``), which build
them with the JAX package's assembler; ``tests/test_torch_analyze.py``
holds the two against each other.  :data:`CHIP_RUNS` are the analyses
the chip check runs on the card, each with the SWC set the JAX package
finds; :func:`constant_key_mapping` is the one whose SHA3 windows are
concrete, :data:`VERITEST_RUN` the one in which the veritesting tier
merges lanes, and :func:`diamond`, :func:`nested_diamond` and
:func:`loop_exit` the branch shapes its tests merge on.  :func:`lockstep_gauntlet` and :func:`wide_dispatcher` are the
lockstep interpreter's test programs.  :data:`ONCHAIN_RUNS` are the
analyses of on-chain loading (``-a``): the accounts of
:func:`onchain_accounts` and the watch's blocks (:func:`watch_chain`)
live in an :class:`OnchainChain`, which :func:`serve_chain` answers over
JSON-RPC on the loopback interface; :func:`call_constant` is the
contract whose findings depend on whether the loader is active.
:data:`SOURCE_RUNS` are the analyses of Solidity input, through the
stand-in compiler :func:`write_solc_standin` writes (a stdlib script that
answers ``solc --standard-json`` from :data:`SOURCE_FIXTURES`: no
compiler); :func:`write_truffle_project` writes a truffle project,
:func:`write_geth_db` a geth LevelDB, and :func:`serve_analysis_api`
answers ``pro``'s analysis API on the loopback interface.
"""

import functools
import hashlib
import json
import os
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np

from mythril_tpu_torch.support.assembler import asm
from mythril_tpu_torch.support.signatures import selector_of


def killbilly() -> str:
    kill_sel = selector_of("kill()")
    return asm(
        f"""
        PUSH 0; CALLDATALOAD; PUSH 0xe0; SHR
        DUP1; PUSH4 {kill_sel}; EQ; PUSH @kill; JUMPI
        PUSH 0; PUSH 0; REVERT
      kill:
        JUMPDEST; CALLER; SUICIDE
        """
    )


def overflow_token() -> str:
    add_sel = selector_of("add(uint256)")
    return asm(
        f"""
        PUSH 0; CALLDATALOAD; PUSH 0xe0; SHR
        DUP1; PUSH4 {add_sel}; EQ; PUSH @add; JUMPI
        PUSH 0; PUSH 0; REVERT
      add:
        JUMPDEST
        PUSH 4; CALLDATALOAD          # amount
        PUSH 0; SLOAD                 # balance
        ADD                           # may overflow
        PUSH 0; SSTORE
        STOP
        """
    )


def origin_gate() -> str:
    return asm(
        """
        ORIGIN; PUSH 0x42; EQ; PUSH @ok; JUMPI
        PUSH 0; PUSH 0; REVERT
      ok:
        JUMPDEST; CALLER; SUICIDE
        """
    )


def veritest_gauntlet() -> str:
    """Four balanced branch diamonds over calldata bits, then a
    symbolic-add overflow tail (SWC-101)."""
    diamonds = []
    for i in range(4):
        bit = 1 << i
        a, b = 0x11 * (i + 1), 0x23 * (i + 1)
        diamonds.append(
            f"""
        DUP2; PUSH {bit}; AND; PUSH @t{i}; JUMPI
        PUSH {a}; ADD; PUSH @j{i}; JUMP
      t{i}:
        JUMPDEST; PUSH {b}; ADD; PUSH @j{i}; JUMP
      j{i}:
        JUMPDEST
            """
        )
    return asm(
        """
        PUSH 4; CALLDATALOAD
        PUSH 0
        """
        + "".join(diamonds)
        + """
        DUP2; ADD
        PUSH 0; SLOAD; ADD
        PUSH 0; SSTORE
        STOP
        """
    )


# The three branch shapes of the veritesting tier's merged-versus-forked
# runs: each ends in a symbolic-add SSTORE tail, so that fork-only
# exploration pays one world state per path and merging one per join.


def diamond() -> str:
    return asm("""
        PUSH 4; CALLDATALOAD
        PUSH 0
        DUP2; PUSH 1; AND; PUSH @t; JUMPI
        PUSH 17; ADD; PUSH @j; JUMP
      t:
        JUMPDEST; PUSH 35; ADD; PUSH @j; JUMP
      j:
        JUMPDEST
        DUP2; ADD
        PUSH 0; SSTORE
        STOP
    """)


def nested_diamond() -> str:
    return asm("""
        PUSH 4; CALLDATALOAD
        PUSH 0
        DUP2; PUSH 1; AND; PUSH @outer_t; JUMPI
        DUP2; PUSH 2; AND; PUSH @inner_t; JUMPI
        PUSH 17; ADD; PUSH @inner_j; JUMP
      inner_t:
        JUMPDEST; PUSH 35; ADD; PUSH @inner_j; JUMP
      inner_j:
        JUMPDEST
        PUSH @outer_j; JUMP
      outer_t:
        JUMPDEST; PUSH 70; ADD; PUSH @outer_j; JUMP
      outer_j:
        JUMPDEST
        DUP2; ADD
        PUSH 0; SSTORE
        STOP
    """)


def loop_exit() -> str:
    # stack: [x, acc, i]; three iterations, each with a branch diamond
    # over a calldata bit re-converging at @j before the counter step
    return asm("""
        PUSH 4; CALLDATALOAD
        PUSH 0
        PUSH 0
      loop:
        JUMPDEST
        DUP3; PUSH 1; AND; PUSH @t; JUMPI
        SWAP1; PUSH 3; ADD; SWAP1; PUSH @j; JUMP
      t:
        JUMPDEST
        SWAP1; PUSH 5; ADD; SWAP1; PUSH @j; JUMP
      j:
        JUMPDEST
        PUSH 1; ADD
        PUSH 3; DUP2; LT; PUSH @loop; JUMPI
        POP
        ADD
        PUSH 0; SSTORE
        STOP
    """)


def corpus() -> List[Tuple[str, str, int, set]]:
    """(name, runtime hex, transaction count, SWC ids found) of
    ``bench._corpus``."""
    return [
        ("killbilly", killbilly(), 1, {"106"}),
        ("overflow_token", overflow_token(), 2, {"101"}),
        ("origin_gate", origin_gate(), 1, {"115"}),
        ("veritest_gauntlet", veritest_gauntlet(), 1, {"101"}),
    ]


def scale_contract(
    depth: int = 6, guard_bits: int = 16, guard: str = "add"
) -> str:
    """Wide-frontier stressor of ``bench.scale_contract``: a binary
    selector-bit dispatch tree whose live frontier doubles per level
    (2**depth leaves), then per-leaf guards fork again.  Leaves mix
    BCP-decidable dead paths, ADD or MUL guards over a masked calldata
    word, and SWC-106 suicide leaves (every 16th leaf from the 7th)."""
    mask = (1 << guard_bits) - 1
    lines = ["PUSH 0; CALLDATALOAD; PUSH 0xe0; SHR", "PUSH @nE; JUMP"]

    def node_label(prefix):
        return "n" + (prefix or "E")

    prefixes = [""]
    for level in range(depth):
        grown = []
        for prefix in prefixes:
            lines.append(f"{node_label(prefix)}:")
            lines.append("JUMPDEST")
            lines.append(
                f"DUP1; PUSH {1 << level}; AND; "
                f"PUSH @{node_label(prefix + '1')}; JUMPI"
            )
            lines.append(f"PUSH @{node_label(prefix + '0')}; JUMP")
            grown += [prefix + "0", prefix + "1"]
        prefixes = grown
    for i, prefix in enumerate(prefixes):
        value = int(prefix[::-1], 2)
        lines.append(f"{node_label(prefix)}:")
        lines.append("JUMPDEST")
        if i % 4 == 1:
            # dead path: low-2-bit equality contradicting the tree bits
            wrong = ((value & 3) + 1) & 3
            lines.append(
                f"DUP1; PUSH 3; AND; PUSH {wrong}; EQ; PUSH @ok{i}; JUMPI"
            )
            lines.append("PUSH 0; PUSH 0; REVERT")
            lines.append(f"ok{i}:")
            lines.append("JUMPDEST; PUSH 1; PUSH 0; SSTORE; STOP")
        else:
            addend = (0x1234 + 7919 * i) & mask
            target = (0x6D2B + 104729 * i) & mask
            if guard == "mul":
                # multiplier-circuit guards (odd factor, so always
                # satisfiable mod 2^guard_bits)
                odd = (0x6D2B + 2 * 7919 * i) & mask | 1
                lines.append(
                    f"PUSH 4; CALLDATALOAD; PUSH {mask}; AND; "
                    f"PUSH {odd}; MUL; PUSH {mask}; AND; "
                    f"PUSH {target}; EQ; PUSH @ok{i}; JUMPI"
                )
            else:
                lines.append(
                    f"PUSH 4; CALLDATALOAD; PUSH {mask}; AND; "
                    f"PUSH {addend}; ADD; PUSH {mask}; AND; "
                    f"PUSH {target}; EQ; PUSH @ok{i}; JUMPI"
                )
            lines.append("PUSH 0; PUSH 0; REVERT")
            lines.append(f"ok{i}:")
            if i % 16 == 6:
                lines.append("JUMPDEST; CALLER; SUICIDE")
            else:
                lines.append(f"JUMPDEST; PUSH 1; PUSH {i}; SSTORE; STOP")
    return asm("\n".join(lines))


def batchtoken_contract() -> str:
    """BECToken-shaped token of ``bench.batchtoken_contract``: three
    dispatched functions, storage-keyed balances, a bounded batch loop,
    and the ``cnt * value`` multiplication overflow (SWC-101)."""
    t_sel = selector_of("transfer(address,uint256)")
    b_sel = selector_of("batchTransfer(uint256,uint256)")
    a_sel = selector_of("approve(address,uint256)")
    return asm(
        f"""
        PUSH 0; CALLDATALOAD; PUSH 0xe0; SHR
        DUP1; PUSH4 {t_sel}; EQ; PUSH @transfer; JUMPI
        DUP1; PUSH4 {b_sel}; EQ; PUSH @batch; JUMPI
        DUP1; PUSH4 {a_sel}; EQ; PUSH @approve; JUMPI
        PUSH 0; PUSH 0; REVERT
      transfer:
        JUMPDEST
        PUSH 0x24; CALLDATALOAD
        CALLER; SLOAD
        DUP1; DUP3; GT; PUSH @fail; JUMPI
        DUP2; DUP2; SUB
        CALLER; SSTORE
        POP
        PUSH 4; CALLDATALOAD
        DUP1; SLOAD
        DUP3; ADD
        SWAP1; SSTORE
        STOP
      batch:
        JUMPDEST
        PUSH 4; CALLDATALOAD
        PUSH 0x24; CALLDATALOAD
        DUP2; DUP2; MUL
        CALLER; SLOAD
        DUP2; DUP2; LT; PUSH @fail; JUMPI
        SUB
        CALLER; SSTORE
        PUSH 0
      bloop:
        JUMPDEST
        DUP3; DUP2; LT; ISZERO; PUSH @bdone; JUMPI
        DUP1; PUSH 0x1000; ADD
        DUP1; SLOAD
        DUP4; ADD
        SWAP1; SSTORE
        PUSH 1; ADD
        PUSH @bloop; JUMP
      bdone:
        JUMPDEST; STOP
      approve:
        JUMPDEST
        PUSH 0x24; CALLDATALOAD
        PUSH 4; CALLDATALOAD
        CALLER; ADD
        SSTORE
        STOP
      fail:
        JUMPDEST; PUSH 0; PUSH 0; REVERT
        """
    )


def constant_key_mapping() -> str:
    """A ledger of one account: ``balances[0x1234]`` of a Solidity
    ``mapping(uint256 => uint256)`` at slot 1, its address the keccak of
    64 concrete bytes (the key, then the slot), read before the
    dispatcher; ``deposit(uint256)`` adds the argument to it (the
    addition may overflow: SWC-101) and ``withdraw(uint256)`` subtracts
    it (may underflow).  The key is a constant, so every path hashes a
    concrete window: the symbolic lockstep tier hashes it on the card."""
    dep_sel = selector_of("deposit(uint256)")
    wd_sel = selector_of("withdraw(uint256)")
    return asm(
        f"""
        PUSH 0x1234; PUSH 0; MSTORE
        PUSH 1; PUSH 0x20; MSTORE
        PUSH 0x40; PUSH 0; SHA3       # the slot of balances[0x1234]
        DUP1; SLOAD                   # slot, balance
        PUSH 0; CALLDATALOAD; PUSH 0xe0; SHR
        DUP1; PUSH4 {dep_sel}; EQ; PUSH @deposit; JUMPI
        DUP1; PUSH4 {wd_sel}; EQ; PUSH @withdraw; JUMPI
        PUSH 0; PUSH 0; REVERT
      deposit:
        JUMPDEST; POP
        PUSH 4; CALLDATALOAD; ADD     # balance + amount
        SWAP1; SSTORE
        STOP
      withdraw:
        JUMPDEST; POP
        PUSH 4; CALLDATALOAD; SWAP1; SUB   # balance - amount
        SWAP1; SSTORE
        STOP
        """
    )


def wide_dispatcher(n_selectors: int = 64) -> str:
    """A canonical dispatcher of ``n_selectors`` functions (the pre-split's
    cap is 64), each a JUMPDEST that stores its index and stops."""
    lines = ["PUSH 0; CALLDATALOAD; PUSH 0xe0; SHR"]
    for i in range(n_selectors):
        lines.append(f"DUP1; PUSH4 {selector_of(f'f{i}(uint256)')}; EQ; "
                     f"PUSH @f{i}; JUMPI")
    lines.append("PUSH 0; PUSH 0; REVERT")
    for i in range(n_selectors):
        lines.append(f"f{i}:")
        lines.append(f"JUMPDEST; PUSH {i}; PUSH 4; CALLDATALOAD; SSTORE; STOP")
    return asm("\n".join(lines))


MIN_WORD = 1 << 255
MAX_WORD = (1 << 256) - 1


def lockstep_gauntlet() -> str:
    """A program for the lockstep interpreter that runs every handled
    opcode group on the operands ``x = calldata[0:32]`` and ``y =
    calldata[32:64]`` and on fixed edge operands (x/0, MIN / -1, signed
    remainders, 2^255, exponents of 0 and of 2^256 - 1, shifts by 0, 255,
    256 and 2^255, reads past the calldata), keeps results in memory and
    storage, then leaves by the route ``calldata[64:96] % 16``: STOP,
    RETURN, REVERT, a bad JUMP and a bad JUMPI (ERROR), SHA3 and
    ASSERT_FAIL (unsupported), storage past its 32 slots, MSTORE, MSTORE8
    and MLOAD past the arena, stack overflow and underflow (ERROR),
    RETURN at offsets that wrap as int32, or a loop of ``x % 1024``
    rounds that outlasts short step caps."""
    binops = ["ADD", "SUB", "MUL", "DIV", "SDIV", "MOD", "SMOD", "EXP",
              "LT", "GT", "SLT", "SGT", "EQ", "AND", "OR", "XOR", "SHL",
              "SHR", "SAR"]
    lines = ["PUSH 0; CALLDATALOAD", "PUSH 32; CALLDATALOAD"]  # y x
    for k, op in enumerate(binops):
        # a = y, b = x, and the other way round
        lines.append(f"DUP2; DUP2; {op}; PUSH {0x20 * k}; MSTORE")
        lines.append(f"DUP1; DUP3; {op}; PUSH {0x20 * k + 0x400}; SSTORE")
    edges = [
        (5, 0, "DIV"), (5, 0, "MOD"), (5, 0, "SDIV"), (5, 0, "SMOD"),
        (MIN_WORD, MAX_WORD, "SDIV"), (MIN_WORD, MAX_WORD, "SMOD"),
        (MAX_WORD - 6, 3, "SMOD"), (7, MAX_WORD - 2, "SMOD"),
        (MAX_WORD - 6, 3, "SDIV"), (MAX_WORD, MAX_WORD, "DIV"),
        (2, 255, "EXP"), (3, MAX_WORD, "EXP"), (0, 0, "EXP"),
        (MAX_WORD, 2, "EXP"), (MIN_WORD, 1, "EXP"),
        (255, MIN_WORD, "SHL"), (256, 1, "SHL"), (MIN_WORD, MAX_WORD, "SHR"),
        (300, MIN_WORD, "SAR"), (0, MIN_WORD + 1, "SAR"), (255, MIN_WORD, "SAR"),
        (MIN_WORD, 1, "SLT"), (MIN_WORD, 1, "LT"),
    ]
    for k, (a, b, op) in enumerate(edges):
        lines.append(f"PUSH {b}; PUSH {a}; {op}; PUSH {0x800 + 0x20 * k}; "
                     "MSTORE")
    lines += [
        "DUP1; ISZERO; PUSH 0x700; MSTORE; DUP1; NOT; PUSH 0x720; MSTORE",
        "PUSH 0; ISZERO; POP",
        # reads past the calldata: a partial window, beyond, high limbs
        "CALLDATASIZE; PUSH 3; SWAP1; SUB; CALLDATALOAD; PUSH 0x740; MSTORE",
        "PUSH 0x100000000; CALLDATALOAD; PUSH 0x760; MSTORE",
        f"PUSH {MIN_WORD + 4}; CALLDATALOAD; PUSH 0x780; MSTORE",
        "CALLER; CALLVALUE; CALLDATASIZE; PC; PUSH 0x7a0; MSTORE8",
        "PUSH 0x7c0; MSTORE; PUSH 0x7e0; MSTORE; PUSH 0xfe0; MSTORE",
        "PUSH 0x7e0; MLOAD; PUSH 0x1234; SSTORE; PUSH 0x1234; SLOAD; POP",
        "PUSH 0x4321; SLOAD; PUSH 0xfff; MSTORE8",
        "PUSH 0x0; MLOAD; PUSH 0xfe0; MLOAD; ADD; PUSH 0xfc0; MSTORE",
        # a taken and an untaken JUMPI, SWAP and DUP depths
        "PUSH 1; PUSH @j1; JUMPI; ASSERT_FAIL",
        "j1:", "JUMPDEST; PUSH 0; PUSH @j1; JUMPI",
        "PUSH 1; PUSH 2; PUSH 3; PUSH 4; PUSH 5; PUSH 6; PUSH 7; PUSH 8",
        "PUSH 9; PUSH 10; PUSH 11; PUSH 12; PUSH 13; PUSH 14; PUSH 15",
        "DUP16; DUP16; SWAP16; SWAP15; SWAP1; DUP3; SWAP3",
        "POP; POP; POP; POP; POP; POP; POP; POP; POP; POP; POP; POP",
        "POP; POP; POP; POP; POP",
        # the route
        "PUSH 64; CALLDATALOAD; PUSH 15; AND",
    ]
    routes = {
        1: "PUSH 0x40; PUSH 0x20; RETURN",
        2: "PUSH 0x20; PUSH 0; REVERT",
        3: "PUSH 3; JUMP",
        4: "PUSH 1; PUSH 0x10000; JUMPI",
        5: "PUSH 0x20; PUSH 0; SHA3",
        6: "ASSERT_FAIL",
        7: "PUSH 0\nr7l:\nJUMPDEST; DUP1; DUP1; PUSH 0x10000; ADD; SSTORE; "
           "PUSH 1; ADD; PUSH @r7l; JUMP",
        8: "DUP3; PUSH 0xff; AND; PUSH 4000; ADD; DUP1; DUP1; MSTORE; MLOAD; "
           "STOP",
        9: "r9l:\nJUMPDEST; PC; PUSH @r9l; JUMP",
        10: "r10l:\nJUMPDEST; POP; PUSH @r10l; JUMP",
        11: "DUP3; PUSH 1023; AND\nr11l:\nJUMPDEST; DUP1; ISZERO; "
            "PUSH @r11d; JUMPI; PUSH 1; SWAP1; SUB; PUSH @r11l; JUMP\n"
            "r11d:\nJUMPDEST; STOP",
        12: f"PUSH {0xFFFFFFF0}; PUSH {(1 << 40) + 0x80000000}; RETURN",
        13: "PUSH 1; PUSH 4095; MSTORE8; PUSH 1; PUSH 4096; MSTORE8; STOP",
        14: "PUSH 4064; MLOAD; PUSH 4065; MLOAD; STOP",
    }
    for r in routes:
        lines.append(f"DUP1; PUSH {r}; EQ; PUSH @r{r}; JUMPI")
    lines.append("STOP")
    for r, body in routes.items():
        lines.append(f"r{r}:")
        lines.append("JUMPDEST; " + body)
    return asm("\n".join(lines))


def gauntlet_calldata(n_lanes: int, seed: int) -> np.ndarray:
    """uint8[n_lanes, 100] calldata for :func:`lockstep_gauntlet`: ``x``
    and ``y`` each an edge operand (0, 1, 2, MIN, MIN + 1, -1, -2, 2^255 -
    1, 255, 256) or a random word, the route a random word, from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, 2, MIN_WORD, MIN_WORD + 1, MAX_WORD, MAX_WORD - 1,
             MIN_WORD - 1, 255, 256]
    out = rng.integers(0, 256, size=(n_lanes, 100), dtype=np.uint8)
    for lane in range(n_lanes):
        for word in range(2):
            if rng.random() < 0.6:
                value = edges[int(rng.integers(len(edges)))]
                out[lane, 32 * word:32 * word + 32] = list(
                    value.to_bytes(32, "big"))
    return out


FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures", "mainnet",
)


def fixture(name: str) -> str:
    """Runtime hex of a vendored fixture, read as a data file."""
    with open(os.path.join(FIXTURES, name + ".hex")) as handle:
        return handle.read().strip()


class ChipRun(NamedTuple):
    name: str
    code: Callable[[], str]
    transaction_count: int
    #: the SWC ids the JAX package finds on the CPU under the slice pins
    #: (re-derived by tests/test_torch_analyze.py)
    swc_ids: Set[str]
    #: whether the run, force-dispatched, must engage a device tier and
    #: launch its kernels (the JAX package does on the CPU exactly on
    #: these runs, with the word tier and the host probe on; re-derived by
    #: tests/test_torch_analyze.py).  The word tier decides enough scale
    #: lanes that the dense tier now delegates every such frontier
    dense: bool
    #: whether the dispatcher pre-split matches and seeds the run's
    #: transactions (re-derived by tests/test_torch_analyze.py)
    presplit: bool
    #: the merges the veritesting tier makes in the run (the JAX
    #: package's count on the CPU; re-derived by
    #: tests/test_torch_analyze.py)
    merges: int


#: The chip check's analyses.  The two-transaction scale run is cut from
#: depth 6 to depth 4: its second transaction re-explores the whole tree
#: from every state the first one left open, so the work grows with the
#: square of the leaf count, and at depth 6 (16 times depth 4's) it
#: would not fit the chip check's time limit.
#: The one chip run in which the veritesting tier merges lanes (four
#: branch diamonds that re-converge); the chip check runs it once more
#: fork-only (``MYTHRIL_TPU_VERITEST=0``).
VERITEST_RUN = ChipRun("veritest_gauntlet -t 1", veritest_gauntlet, 1,
                       {"101"}, False, False, 4)
CHIP_RUNS: Tuple[ChipRun, ...] = (
    ChipRun("scale_mul d6 g16 -t 1", lambda: scale_contract(6, 16, "mul"),
            1, {"106"}, True, False, 0),
    ChipRun("scale_mul d4 g16 -t 2", lambda: scale_contract(4, 16, "mul"),
            2, {"106"}, True, False, 0),
    ChipRun("erc20_transfer -t 2", lambda: fixture("erc20_transfer"), 2,
            {"101"}, False, True, 0),
    ChipRun("vault_withdraw -t 2", lambda: fixture("vault_withdraw"), 2,
            {"101", "104", "105", "107"}, False, True, 0),
    ChipRun("killbilly -t 1", killbilly, 1, {"106"}, False, True, 0),
    # the one run whose SHA3 windows are concrete: the symbolic lockstep
    # tier hashes them with the keccak kernel
    ChipRun("constant_key_mapping -t 2", constant_key_mapping, 2, {"101"},
            False, False, 0),
    VERITEST_RUN,
)
#: The chip check's yardstick of the resident solver: the scale run under
#: ``MYTHRIL_TPU_RESIDENT_KERNEL=0`` (the dense tier keeps the frontiers),
#: cut from depth 6 to depth 4 so that the chip check keeps to its time
#: (at depth 6 it took 129-188 s of it).
YARDSTICK_RUN = ChipRun("scale_mul d4 g16 -t 1",
                        lambda: scale_contract(4, 16, "mul"), 1, {"106"},
                        True, False, 0)


# ---------------------------------------------------------------------------
# on-chain loading: a chain served on the loopback interface
# ---------------------------------------------------------------------------

#: the EIP-1167 minimal-proxy runtime: PRE + the 20-byte target + POST
EIP1167_PRE = "363d3d373d3d3d363d73"
EIP1167_POST = "5af43d82803e903d91602b57fd5bf3"

#: the constant address :func:`call_constant` calls
CALLEE = "0x00000000000000000000000000000000000ca11e"


def eip1167_clone(target: str) -> str:
    """Runtime hex of an EIP-1167 minimal proxy delegating to ``target``."""
    return EIP1167_PRE + target[2:].lower() + EIP1167_POST


def call_constant() -> str:
    """CALLs the constant address :data:`CALLEE`, then reads storage slot
    0 and, when it is set, lets anyone destroy the contract (SWC-106).
    With the loader active (``myth analyze`` without
    ``--no-onchain-data``) the callee is loaded from the chain and the
    target's storage is concrete: slot 0 reads the chain's value (0 when
    no chain answers, and the SUICIDE is unreachable); with the loader
    inactive slot 0 is symbolic."""
    return asm(
        f"""
        PUSH 0; PUSH 0; PUSH 0; PUSH 0; PUSH 0
        PUSH20 {int(CALLEE, 16)}; GAS; CALL; POP
        PUSH 0; SLOAD; ISZERO; PUSH @done; JUMPI
        CALLER; SUICIDE
      done:
        JUMPDEST; STOP
        """
    )


class ChainAccount(NamedTuple):
    address: str
    #: runtime hex without ``0x``
    code: str
    balance: int = 0
    #: slot -> value
    storage: Dict[int, int] = {}


def _address(n: int) -> str:
    return "0x" + format(0xC0DE0000 + n, "040x")


_ATTACKER = 0xDEADBEEFDEADBEEFDEADBEEFDEADBEEFDEADBEEF
_CREATOR = 0xAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFEAFFE


def onchain_accounts() -> Dict[str, ChainAccount]:
    """The accounts of the on-chain runs, by name: IMPL holds the scale
    contract at the main path's full width (d6 g16), CLONE is an EIP-1167
    clone of IMPL and CLONE2 a clone of CLONE (a chain of two hops); VAULT
    holds ``vault_withdraw`` with a balance, the creator's and the
    attacker's deposits in its storage and two words in slots 0 and 1
    (which its code never reads: ``read-storage 0,2`` reads them); KILL holds killbilly behind
    KILL_CLONE; GATE holds :func:`call_constant` with slot 0 set on the
    chain, and CALLEE, the address it calls, holds killbilly."""
    impl, clone, clone2 = _address(1), _address(2), _address(3)
    kill = _address(5)
    accounts = [
        ("IMPL", ChainAccount(impl, scale_contract(6, 16, "mul"))),
        ("CLONE", ChainAccount(clone, eip1167_clone(impl))),
        ("CLONE2", ChainAccount(clone2, eip1167_clone(clone))),
        ("VAULT", ChainAccount(
            _address(4), fixture("vault_withdraw"), balance=3 * 10**18,
            storage={0: 0x2A, 1: 0x1337, _CREATOR: 2 * 10**18,
                     _ATTACKER: 10**18})),
        ("KILL", ChainAccount(kill, killbilly())),
        ("KILL_CLONE", ChainAccount(_address(6), eip1167_clone(kill))),
        ("GATE", ChainAccount(_address(7), call_constant(), storage={0: 1})),
        ("CALLEE", ChainAccount(CALLEE, killbilly(), balance=5)),
    ]
    return dict(accounts)


class OnchainRun(NamedTuple):
    name: str
    #: the account analyzed (``-a``), a name of :func:`onchain_accounts`
    account: str
    transaction_count: int
    #: the SWC ids the JAX package finds on the same chain, on the CPU
    #: (held by tests/test_torch_rpc.py; the full-width run's by the
    #: command in :data:`ONCHAIN_JAX_COMMAND`)
    swc_ids: Set[str]
    #: the account a proxy chain resolves to (None: no proxy)
    resolves_to: Optional[str]
    #: small enough for the CPU tests to run on both packages
    small: bool


ONCHAIN_RUNS: Tuple[OnchainRun, ...] = (
    OnchainRun("scale_mul d6 g16 via two clones -t 1", "CLONE2", 1,
               {"106"}, "IMPL", False),
    OnchainRun("vault_withdraw on chain -t 2", "VAULT", 2,
               {"104", "107"}, None, True),
    OnchainRun("killbilly via a clone -t 1", "KILL_CLONE", 1, {"106"},
               "KILL", True),
    OnchainRun("call_constant on chain -t 1", "GATE", 1, {"106", "107"}, None,
               True),
)

#: how the full-width run's JAX SWC set was taken (``CHAIN`` is a served
#: :func:`onchain_chain`, ``CLONE2`` its address)
ONCHAIN_JAX_COMMAND = ("JAX_PLATFORMS=cpu python3 myth analyze -a CLONE2 "
                       "--rpc CHAIN -t 1 -o jsonv2")


def _hash32(*parts) -> str:
    return "0x" + hashlib.sha256(
        ":".join(str(p) for p in parts).encode()).hexdigest()


class OnchainChain:
    """Accounts, transaction receipts and blocks on two branches, as a
    node would answer them.  ``heads`` are the heights ``eth_blockNumber``
    answers, one a poll (the last repeats); from poll ``switch_poll`` on,
    branch B is canonical above height ``fork``.  Thread-safe: the server
    answers from handler threads."""

    def __init__(self, accounts: Dict[str, ChainAccount],
                 blocks_a: Dict[int, List[str]],
                 blocks_b: Optional[Dict[int, List[str]]] = None,
                 receipts: Optional[Dict[str, dict]] = None,
                 heads: Tuple[int, ...] = (0,), fork: Optional[int] = None,
                 switch_poll: Optional[int] = None):
        self.accounts = {a.address.lower(): a for a in accounts.values()}
        self.receipts = dict(receipts or {})
        self.heads = tuple(heads)
        self.fork = fork
        self.switch_poll = switch_poll
        self.polls = 0
        self.calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._branch_a = self._build("A", blocks_a, 0, "0x" + "00" * 32)
        self._branch_b = {}
        if blocks_b is not None:
            self._branch_b = self._build(
                "B", blocks_b, fork + 1, self._branch_a[fork]["hash"])

    @staticmethod
    def _build(branch, txs, start, parent):
        out = {}
        for height in range(start, max(txs, default=start) + 1):
            block_hash = _hash32(branch, height)
            out[height] = {"number": hex(height), "hash": block_hash,
                           "parentHash": parent,
                           "transactions": list(txs.get(height, ()))}
            parent = block_hash
        return out

    @property
    def switched(self) -> bool:
        return self.switch_poll is not None and self.polls > self.switch_poll

    def head(self) -> int:
        """One ``eth_blockNumber`` poll."""
        with self._lock:
            head = self.heads[min(self.polls, len(self.heads) - 1)]
            self.polls += 1
            return head

    def block(self, height: int) -> Optional[dict]:
        with self._lock:
            seen = self.heads[min(max(self.polls - 1, 0),
                                  len(self.heads) - 1)]
            if height < 0 or height > seen:
                return None
            if self.switched and height > self.fork:
                return self._branch_b.get(height)
            return self._branch_a.get(height)

    def answer(self, method: str, params: list):
        """The JSON-RPC ``result`` of one call (raises ValueError for a
        method the chain does not serve)."""
        with self._lock:
            self.calls[method] = self.calls.get(method, 0) + 1
        if method == "eth_blockNumber":
            return hex(self.head())
        if method == "eth_getBlockByNumber":
            return self.block(int(params[0], 16))
        if method == "eth_getTransactionReceipt":
            return self.receipts.get(params[0])
        account = self.accounts.get(str(params[0]).lower())
        if method == "eth_getCode":
            return "0x" + account.code if account else "0x"
        if method == "eth_getBalance":
            return hex(account.balance if account else 0)
        if method == "eth_getStorageAt":
            value = account.storage.get(int(params[1], 16), 0) \
                if account else 0
            return "0x" + format(value, "064x")
        raise ValueError(f"unsupported method {method}")


def onchain_chain() -> OnchainChain:
    """The accounts of :func:`onchain_accounts` on a chain of one block."""
    return OnchainChain(onchain_accounts(), {0: []})


def watch_chain() -> OnchainChain:
    """The watch's chain of 9 blocks: IMPL (the scale contract, d6 g16)
    deployed at height 1 beside a reverted CREATE, a clone of IMPL at 2, a
    byte-identical redeploy of IMPL at 3, a transfer at 4, killbilly at
    6; then a reorg of 2 blocks: branch B replaces heights 6 and 7 (its 6
    deploys the same killbilly again, its 7 a clone of it, height 7 of
    branch A a transfer).  The head answers 4, 7, then 8 (the switch)."""
    impl = scale_contract(6, 16, "mul")
    kill = killbilly()
    accounts = {}
    receipts = {}
    blocks_a: Dict[int, List[str]] = {h: [] for h in range(9)}
    blocks_b: Dict[int, List[str]] = {h: [] for h in range(6, 9)}

    def deploy(name, height, code, branches, status="0x1"):
        address = _address(0x100 + len(receipts))
        tx = _hash32("tx", name)
        if code is not None:
            accounts[name] = ChainAccount(address, code)
        receipts[tx] = {"transactionHash": tx, "blockNumber": hex(height),
                        "contractAddress": address, "status": status}
        for branch, blocks in (("A", blocks_a), ("B", blocks_b)):
            if branch in branches:
                blocks[height].append(tx)
        return address

    impl_address = deploy("W_IMPL", 1, impl, "A")
    deploy("W_FAILED", 1, None, "A", status="0x0")
    deploy("W_CLONE", 2, eip1167_clone(impl_address), "A")
    deploy("W_DUP", 3, impl, "A")
    kill_address = deploy("W_KILL", 6, kill, "AB")
    deploy("W_KILL_CLONE", 7, eip1167_clone(kill_address), "B")
    for height, blocks in ((4, blocks_a), (7, blocks_a)):
        tx = _hash32("transfer", height)
        receipts[tx] = {"transactionHash": tx, "blockNumber": hex(height),
                        "contractAddress": None, "status": "0x1"}
        blocks[height].append(tx)
    return OnchainChain(accounts, blocks_a, blocks_b, receipts,
                        heads=(4, 7, 8), fork=5, switch_poll=2)


#: the watch chain's unique runtimes (what is analyzed, once each) and
#: their SWC sets at one transaction: the chip runs' sets for the same
#: contracts (:data:`CHIP_RUNS`, held by tests/test_torch_analyze.py)
WATCH_FINDINGS = {"scale_mul d6 g16": {"106"}, "killbilly": {"106"}}


def serve_chain(chain: OnchainChain):
    """A ``ThreadingHTTPServer`` on ``127.0.0.1:0`` answering JSON-RPC
    POSTs from ``chain`` (an unsupported method is a JSON-RPC error);
    the caller runs ``serve_forever`` and shuts it down."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: A002 — stdlib name
            pass

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            request = {}
            try:
                request = json.loads(self.rfile.read(length))
                body = {"jsonrpc": "2.0", "id": request.get("id"),
                        "result": chain.answer(request.get("method"),
                                               request.get("params") or [])}
            except (ValueError, TypeError, KeyError, IndexError) as exc:
                body = {"jsonrpc": "2.0", "id": request.get("id"),
                        "error": {"code": -32000, "message": str(exc)}}
            payload = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    return server


# ---------------------------------------------------------------------------
# Solidity input: source fixtures and a stand-in for solc
# ---------------------------------------------------------------------------
#
# Neither the tests' machine nor the card's has a solc, and nothing may be
# downloaded.  So the Solidity path is driven by a stand-in: a stdlib
# script that answers ``solc --standard-json`` from a JSON file written
# beside it.  It is no compiler: each fixture pairs bytecode this module
# already builds with a source text written for it and a source map in
# solc's compressed format, so what it tests is the port's own code (the
# standard-json exchange, the map's decoding, contract selection, the
# signature store, the source lines of the reports).

#: the compiler version the fixtures claim (``--solv SOLC_VERSION`` picks
#: the stand-in's ``solc-SOLC_VERSION``)
SOLC_VERSION = "0.8.19"

_HEADER = f"// SPDX-License-Identifier: MIT\npragma solidity ^{SOLC_VERSION};\n"


class _Text:
    """A source file written piece by piece, with the byte spans of its
    named snippets (the texts are ASCII, so characters are bytes)."""

    def __init__(self):
        self.parts: List[str] = []
        self.size = 0
        self.spans: Dict[object, Tuple[int, int]] = {}
        self._open: Dict[object, int] = {}

    def add(self, text: str) -> "_Text":
        assert text.isascii()
        self.parts.append(text)
        self.size += len(text)
        return self

    def snip(self, text: str, spans: Dict[object, str]) -> "_Text":
        """Append ``text``; each key of ``spans`` names the span of its
        substring of ``text``."""
        for key, inner in spans.items():
            self.spans[key] = (self.size + text.index(inner), len(inner))
        return self.add(text)

    def begin(self, key) -> None:
        self._open[key] = self.size

    def end(self, key) -> None:
        start = self._open.pop(key)
        self.spans[key] = (start, self.size - start - 1)  # without "\n"

    @property
    def text(self) -> str:
        return "".join(self.parts)


def _ops(code_hex: str) -> List[Tuple[int, str]]:
    """(address, mnemonic) of each instruction of ``code_hex``: a plain
    scan, PUSHn skipping its n bytes."""
    from mythril_tpu_torch.support.opcodes import OPCODES

    code = bytes.fromhex(code_hex.removeprefix("0x"))
    out, pc = [], 0
    while pc < len(code):
        byte = code[pc]
        info = OPCODES.get(byte)
        out.append((pc, info.name if info else "INVALID"))
        pc += 1 + (byte - 0x5F if 0x60 <= byte <= 0x7F else 0)
    return out


def _source_map(code_hex: str, entries) -> str:
    """solc's compressed source map of ``entries`` (one (mnemonic,
    (offset, length, file index, jump)) an instruction, held against
    the code's own instructions): a field equal to the previous entry's
    is left empty, trailing empty fields dropped, the modifier depth 0
    written once."""
    ops = _ops(code_hex)
    assert len(entries) <= len(ops), (len(entries), len(ops))
    out, prev = [], None
    for (want, span), (_, got) in zip(entries, ops):
        assert got == want or (want == "PUSH" and got.startswith("PUSH")), (
            f"source map expects {want}, the code has {got}")
        entry = tuple(span) + (0,)
        fields = [str(v) if prev is None or v != p else ""
                  for v, p in zip(entry, prev or entry)]
        while fields and fields[-1] == "":
            fields.pop()
        out.append(":".join(fields))
        prev = entry
    return ";".join(out)


def _span(text: _Text, file: int, key, jump: str = "-"):
    offset, length = text.spans[key]
    return (offset, length, file, jump)


#: the span of code solc generates with no source (its file index -1)
_GENERATED = (-1, -1, -1, "-")


def _selector_contract(sig: str, body: str) -> str:
    """A one-function contract: dispatch on ``sig``'s selector, else
    revert; the function's body is ``body`` (after its JUMPDEST)."""
    return asm(f"""
        PUSH 0; CALLDATALOAD; PUSH 0xe0; SHR
        DUP1; PUSH4 {selector_of(sig)}; EQ; PUSH @fn; JUMPI
        PUSH 0; PUSH 0; REVERT
      fn:
        JUMPDEST; {body}
        """)


def _dispatch_entries(text, file, contract_key, n_selectors=1):
    """The map of a selector dispatcher (the contract's span, its revert
    generated code)."""
    whole = _span(text, file, contract_key)
    entries = [(op, whole) for op in ("PUSH", "CALLDATALOAD", "PUSH",
                                      "SHR")]
    for _ in range(n_selectors):
        entries += [(op, whole) for op in ("DUP1", "PUSH", "EQ", "PUSH")]
        entries.append(("JUMPI", whole[:3] + ("i",)))
    entries += [("PUSH", _GENERATED), ("PUSH", _GENERATED),
                ("REVERT", _GENERATED)]
    return entries


def _suicide_entries(text, file, key):
    """JUMPDEST; CALLER; SUICIDE of the function ``key``."""
    return [("JUMPDEST", _span(text, file, ("fn", key))),
            ("CALLER", _span(text, file, ("caller", key))),
            ("SUICIDE", _span(text, file, ("suicide", key), "o"))]


def _creation(runtime: str, text: _Text, file: int, contract_key):
    """solc's creation code shape for ``runtime`` (the free memory
    pointer, the non-payable check, the copy of the runtime out) and its
    map: (creation hex, map)."""
    def stub(offset):
        return asm(f"""
            PUSH 0x80; PUSH 0x40; MSTORE
            CALLVALUE; DUP1; ISZERO; PUSH @deploy; JUMPI
            PUSH 0; DUP1; REVERT
          deploy:
            JUMPDEST; POP
            PUSH2 {len(runtime) // 2}; DUP1; PUSH2 {offset}; PUSH 0
            CODECOPY; PUSH 0; RETURN
            """)

    # the runtime follows the stub and one INVALID byte
    head = stub(len(stub(0)) // 2 + 1)
    whole = _span(text, file, contract_key)
    entries = [(op, whole) for op in ("PUSH", "PUSH", "MSTORE", "CALLVALUE",
                                      "DUP1", "ISZERO", "PUSH", "JUMPI")]
    entries += [("PUSH", _GENERATED), ("DUP1", _GENERATED),
                ("REVERT", _GENERATED)]
    entries += [(op, whole) for op in ("JUMPDEST", "POP", "PUSH", "DUP1",
                                       "PUSH", "PUSH", "CODECOPY", "PUSH")]
    entries.append(("RETURN", whole[:3] + ("o",)))
    code = head + "fe" + runtime
    return code, _source_map(code, entries)


def _killer(text: _Text, name: str, sig: str):
    """``contract NAME { function SIG external { selfdestruct(...) } }``
    appended to ``text`` (spans under ``name``)."""
    text.begin(("contract", name))
    text.add(f"contract {name} {{\n")
    text.begin(("fn", name))
    text.add(f"    function {sig} external {{\n")
    text.snip("        selfdestruct(payable(msg.sender));\n",
              {("suicide", name): "selfdestruct(payable(msg.sender))",
               ("caller", name): "msg.sender"})
    text.add("    }\n")
    text.end(("fn", name))
    text.add("}\n")
    text.end(("contract", name))


def _compiled(runtime: str, runtime_entries, text, file, name,
              signatures=()) -> dict:
    """One contract of solc's standard-json output."""
    creation, creation_map = _creation(runtime, text, file,
                                       ("contract", name))
    return {"abi": [], "evm": {
        "bytecode": {"object": creation, "sourceMap": creation_map},
        "deployedBytecode": {"object": runtime,
                             "sourceMap": _source_map(runtime,
                                                      runtime_entries)},
        "methodIdentifiers": {s: selector_of(s)[2:] for s in signatures}}}


def _codeless(signatures=()) -> dict:
    """An interface or abstract contract: no code."""
    return {"abi": [], "evm": {
        "bytecode": {"object": "", "sourceMap": ""},
        "deployedBytecode": {"object": "", "sourceMap": ""},
        "methodIdentifiers": {s: selector_of(s)[2:] for s in signatures}}}


#: the signature of :func:`scale_sources`' second contract, which the
#: built-in signature table does not hold: a report names its function
#: only through the fixture's ``methodIdentifiers``
HELPER_SIGNATURE = "retire()"


def scale_sources(depth: int = 6, guard_bits: int = 16):
    """``SCALE.sol`` (importing ``ScaleBase.sol``): ``Helper`` (a
    killbilly over :data:`HELPER_SIGNATURE`), the interface ``IScale``
    and ``Scale``, whose runtime is ``scale_contract(depth, guard_bits,
    "mul")``; ``ScaleBase.sol`` holds the abstract ``ScaleBase`` whose
    guard the leaves' instructions map into.  Returns ({file: text},
    {file: {contract: output}})."""
    mask = (1 << guard_bits) - 1
    base = _Text().add(_HEADER + "\n")
    base.add("/// The guards of the scale contract's leaves, over a masked "
             "calldata word.\n")
    base.begin(("contract", "ScaleBase"))
    base.add("abstract contract ScaleBase {\n")
    base.add(f"    uint256 internal constant MASK = {hex(mask)};\n\n")
    base.add("    function amount() internal pure returns (uint256) {\n")
    base.snip("        return uint256(bytes32(msg.data[4:36])) & MASK;\n",
              {"load": "bytes32(msg.data[4:36])",
               "masked": "uint256(bytes32(msg.data[4:36])) & MASK"})
    base.add("    }\n\n")
    base.add("    function mulGuard(uint256 odd, uint256 target) internal "
             "pure returns (bool) {\n")
    base.snip("        return (amount() * odd) & MASK == target;\n",
              {"mul": "amount() * odd", "mul_mask": "(amount() * odd) & MASK",
               "guard": "(amount() * odd) & MASK == target"})
    base.add("    }\n}\n")
    base.end(("contract", "ScaleBase"))

    main = _Text().add(_HEADER + "\n" + 'import "./ScaleBase.sol";\n\n')
    main.add("interface IScale {\n    function poke(uint256 value) "
             "external;\n}\n\n")
    _killer(main, "Helper", HELPER_SIGNATURE)
    main.add("\n/// A selector-bit dispatch tree of "
             f"2**{depth} guarded leaves.\n")
    main.begin(("contract", "Scale"))
    main.add("contract Scale is ScaleBase {\n    uint256 internal flag;\n"
             "    mapping(uint256 => uint256) internal marks;\n\n")
    main.add("    fallback() external {\n")
    main.snip("        uint256 s = uint32(msg.sig);\n",
              {"sig": "uint32(msg.sig)"})

    def tree(prefix, indent):
        pad = " " * indent
        if len(prefix) == depth:
            i = int(prefix, 2)
            main.snip(f"{pad}leaf{i}(s);\n", {("call", prefix): f"leaf{i}(s)"})
            return
        bit = hex(1 << len(prefix))
        main.snip(f"{pad}if (s & {bit} != 0) {{\n",
                  {("node", prefix): f"s & {bit} != 0",
                   ("bit", prefix): f"s & {bit}"})
        tree(prefix + "1", indent + 4)
        main.add(f"{pad}}} else {{\n")
        tree(prefix + "0", indent + 4)
        main.add(f"{pad}}}\n")

    tree("", 8)
    main.add("    }\n")
    prefixes = [format(i, f"0{depth}b") for i in range(1 << depth)]
    for i, prefix in enumerate(prefixes):
        value = int(prefix[::-1], 2)
        main.add("\n")
        main.begin(("fn", i))
        main.add(f"    function leaf{i}(uint256 s) internal {{\n")
        if i % 4 == 1:
            wrong = ((value & 3) + 1) & 3
            main.snip(f"        require(s & 3 == {wrong});\n",
                      {("require", i): f"require(s & 3 == {wrong})",
                       ("cond", i): f"s & 3 == {wrong}",
                       ("low", i): "s & 3"})
            main.snip("        flag = 1;\n", {("store", i): "flag = 1"})
        else:
            odd = (0x6D2B + 2 * 7919 * i) & mask | 1
            target = (0x6D2B + 104729 * i) & mask
            call = f"mulGuard({hex(odd)}, {hex(target)})"
            main.snip(f"        require({call});\n",
                      {("require", i): f"require({call})",
                       ("cond", i): call})
            if i % 16 == 6:
                main.snip("        selfdestruct(payable(msg.sender));\n",
                          {("suicide", i): "selfdestruct(payable(msg.sender))",
                           ("caller", i): "msg.sender"})
            else:
                main.snip(f"        marks[{i}] = 1;\n",
                          {("store", i): f"marks[{i}] = 1"})
        main.add("    }\n")
        main.end(("fn", i))
    main.add("}\n")
    main.end(("contract", "Scale"))

    # the runtime's map, in the order scale_contract lays its code out
    S = lambda key, jump="-": _span(main, 0, key, jump)  # noqa: E731
    B = lambda key, jump="-": _span(base, 1, key, jump)  # noqa: E731
    entries = [(op, S("sig")) for op in ("PUSH", "CALLDATALOAD", "PUSH",
                                         "SHR")]
    entries += [("PUSH", S(("node", ""))), ("JUMP", S(("node", "")))]
    level_prefixes = [""]
    for level in range(depth):
        into = "i" if level == depth - 1 else "-"
        for prefix in level_prefixes:
            node, bit = S(("node", prefix)), S(("bit", prefix))
            entries += [("JUMPDEST", node), ("DUP1", bit), ("PUSH", bit),
                        ("AND", bit), ("PUSH", node),
                        ("JUMPI", node[:3] + (into,)), ("PUSH", node),
                        ("JUMP", node[:3] + (into,))]
        level_prefixes = [p + c for p in level_prefixes for c in "01"]
    for i in range(len(prefixes)):
        entries.append(("JUMPDEST", S(("fn", i))))
        if i % 4 == 1:
            low, cond = S(("low", i)), S(("cond", i))
            entries += [("DUP1", low), ("PUSH", low), ("AND", low),
                        ("PUSH", cond), ("EQ", cond),
                        ("PUSH", S(("require", i))),
                        ("JUMPI", S(("require", i)))]
        else:
            entries += [("PUSH", B("load", "i")), ("CALLDATALOAD", B("load")),
                        ("PUSH", B("masked")), ("AND", B("masked")),
                        ("PUSH", B("mul")), ("MUL", B("mul")),
                        ("PUSH", B("mul_mask")), ("AND", B("mul_mask")),
                        ("PUSH", B("guard")), ("EQ", B("guard", "o")),
                        ("PUSH", S(("require", i))),
                        ("JUMPI", S(("require", i)))]
        entries += [("PUSH", _GENERATED), ("PUSH", _GENERATED),
                    ("REVERT", _GENERATED)]
        if i % 4 != 1 and i % 16 == 6:
            entries += [("JUMPDEST", S(("suicide", i))),
                        ("CALLER", S(("caller", i))),
                        ("SUICIDE", S(("suicide", i), "o"))]
        else:
            store = S(("store", i))
            entries += [(op, store) for op in ("JUMPDEST", "PUSH", "PUSH",
                                               "SSTORE")]
            entries.append(("STOP", S(("fn", i), "o")))
    helper = _selector_contract(HELPER_SIGNATURE, "CALLER; SUICIDE")
    contracts = {
        "SCALE.sol": {
            "Helper": _compiled(
                helper, _dispatch_entries(main, 0, ("contract", "Helper"))
                + _suicide_entries(main, 0, "Helper"), main, 0, "Helper",
                [HELPER_SIGNATURE]),
            "IScale": _codeless(["poke(uint256)"]),
            "Scale": _compiled(scale_contract(depth, guard_bits, "mul"),
                               entries, main, 0, "Scale"),
        },
        "ScaleBase.sol": {"ScaleBase": _codeless()},
    }
    return ({"SCALE.sol": main.text, "ScaleBase.sol": base.text},
            contracts)


def killbilly_sources():
    """``KillBilly.sol``: killbilly (:func:`killbilly`) as a contract."""
    text = _Text().add(_HEADER + "\n")
    _killer(text, "KillBilly", "kill()")
    entries = (_dispatch_entries(text, 0, ("contract", "KillBilly"))
               + _suicide_entries(text, 0, "KillBilly"))
    return ({"KillBilly.sol": text.text}, {"KillBilly.sol": {
        "KillBilly": _compiled(killbilly(), entries, text, 0, "KillBilly",
                               ["kill()"])}})


def token_sources():
    """``Token.sol``: the ``erc20_transfer`` fixture's bytecode as a
    contract (its ``transfer`` debits the first argument's word from the
    caller, unchecked: SWC-101)."""
    text = _Text().add(_HEADER + "\n")
    text.begin(("contract", "Token"))
    text.add("contract Token {\n    mapping(address => uint256) internal "
             "balances;\n\n")
    text.add("    /// Debits the first argument's word from the caller; the "
             "credit side is left out.\n")
    text.begin("transfer")
    text.add("    function transfer(address to, uint256) external returns "
             "(bool) {\n        unchecked {\n")
    text.snip("            balances[msg.sender] = balances[msg.sender] - "
              "uint160(to);\n",
              {"assign": "balances[msg.sender] = balances[msg.sender] - "
                         "uint160(to)",
               "sub": "balances[msg.sender] - uint160(to)",
               "arg": "uint160(to)"})
    # the debited balance (the right-hand side's read)
    offset, _ = text.spans["sub"]
    text.spans["read"] = (offset, len("balances[msg.sender]"))
    text.add("        }\n")
    text.snip("        return true;\n", {"true": "return true"})
    text.add("    }\n")
    text.end("transfer")
    text.add("\n")
    text.begin("balanceOf")
    text.add("    function balanceOf(address owner) external view returns "
             "(uint256) {\n")
    text.snip("        return balances[owner];\n",
              {"ret": "return balances[owner]", "owner": "owner",
               "lookup": "balances[owner]"})
    text.add("    }\n")
    text.end("balanceOf")
    text.add("}\n")
    text.end(("contract", "Token"))
    T = lambda key, jump="-": _span(text, 0, key, jump)  # noqa: E731
    entries = _dispatch_entries(text, 0, ("contract", "Token"), 2)
    entries += [("JUMPDEST", T("transfer")), ("CALLER", T("read")),
                ("SLOAD", T("read")), ("PUSH", T("arg")),
                ("CALLDATALOAD", T("arg")), ("DUP2", T("sub")),
                ("SUB", T("sub")), ("CALLER", T("assign")),
                ("SSTORE", T("assign"))]
    entries += [(op, T("true")) for op in ("PUSH", "PUSH", "MSTORE", "PUSH",
                                           "PUSH")]
    entries.append(("RETURN", T("true", "o")))
    entries += [("JUMPDEST", T("balanceOf")), ("PUSH", T("owner")),
                ("CALLDATALOAD", T("owner")), ("SLOAD", T("lookup"))]
    entries += [(op, T("ret")) for op in ("PUSH", "MSTORE", "PUSH", "PUSH")]
    entries.append(("RETURN", T("ret", "o")))
    return ({"Token.sol": text.text}, {"Token.sol": {
        "Token": _compiled(fixture("erc20_transfer"), entries, text, 0,
                           "Token", ["transfer(address,uint256)",
                                     "balanceOf(address)"])}})


#: the source fixtures by main file
SOURCE_FIXTURES: Dict[str, Callable] = {
    "SCALE.sol": scale_sources,
    "KillBilly.sol": killbilly_sources,
    "Token.sol": token_sources,
}


def solc_output(main_file: str) -> Tuple[Dict[str, str], dict]:
    """({file: source text}, the standard-json output) of a fixture, its
    files named as solc names them when given ``main_file`` alone: the
    sources with ids in the order of their names, an AST stub each, the
    contracts and one warning."""
    import copy

    return copy.deepcopy(_solc_output(main_file))


@functools.lru_cache(maxsize=None)
def _solc_output(main_file: str) -> Tuple[Dict[str, str], dict]:
    texts, contracts = SOURCE_FIXTURES[main_file]()
    sources = {}
    for index, name in enumerate(sorted(texts)):
        size = len(texts[name])
        sources[name] = {"id": index, "ast": {
            "absolutePath": name, "id": index, "nodeType": "SourceUnit",
            "nodes": [], "src": f"0:{size}:{index}"}}
    warning = (f"Warning: fixture of the stand-in compiler (no compiler "
               f"ran)\n --> {main_file}\n")
    return texts, {"sources": sources, "contracts": contracts, "errors": [
        {"severity": "warning", "type": "Warning", "component": "general",
         "message": "fixture of the stand-in compiler",
         "formattedMessage": warning}]}


class SourceRun(NamedTuple):
    name: str
    #: the fixture's main file (a key of :data:`SOURCE_FIXTURES`)
    file: str
    #: the contract analyzed (``FILE:CONTRACT``)
    contract: str
    transaction_count: int
    #: the SWC ids the JAX package finds through the same stand-in on the
    #: CPU (held by tests/test_torch_solidity.py; the full-width run's by
    #: the command in :data:`SOURCE_JAX_COMMAND`)
    swc_ids: Set[str]
    #: the function names of those findings: the fixture's
    #: ``methodIdentifiers`` where the code has a selector dispatcher (the
    #: scale contract has none: its entries are named by the guards'
    #: compares, ``_function_0x...``)
    functions: Set[str]
    #: small enough for the CPU tests to run on both packages
    small: bool


#: The analyses of Solidity input: the scale contract at the main path's
#: full width (d6 g16, ``CHIP_RUNS[0]``'s runtime behind its creation
#: code), the helper beside it in the same source, killbilly and the
#: ``erc20_transfer`` fixture.
SOURCE_RUNS: Tuple[SourceRun, ...] = (
    SourceRun("SCALE.sol:Scale d6 g16 -t 1", "SCALE.sol", "Scale", 1,
              {"106"}, {"_function_0x000003c1", "_function_0x00009551",
                        "_function_0x000026e1", "_function_0x0000b871"},
              False),
    SourceRun("SCALE.sol:Helper -t 1", "SCALE.sol", "Helper", 1, {"106"},
              {HELPER_SIGNATURE}, True),
    SourceRun("KillBilly.sol -t 1", "KillBilly.sol", "KillBilly", 1,
              {"106"}, {"kill()"}, True),
    SourceRun("Token.sol -t 2", "Token.sol", "Token", 2, {"101"},
              {"transfer(address,uint256)"}, True),
)

#: how the full-width run's JAX SWC set and function names were taken:
#: the JAX package in process through the stand-in, its source files read
#: by name (its CLI cannot read a two-file source: ROADMAP Queue C)
SOURCE_JAX_COMMAND = ("JAX_PLATFORMS=cpu python -m pytest "
                      "tests/test_torch_solidity.py -k "
                      "test_full_width_source_run_set_is_jax_s")


def write_sources(directory: str, main_file: str) -> str:
    """Write a fixture's source files into ``directory``; returns the
    main file's path."""
    texts, _ = solc_output(main_file)
    os.makedirs(directory, exist_ok=True)
    for name, text in texts.items():
        with open(os.path.join(directory, name), "w") as handle:
            handle.write(text)
    return os.path.join(directory, main_file)


#: the stand-in's file of fixtures and its record of what it was asked
STANDIN_FIXTURES = "solc-fixtures.json"
STANDIN_RECORD = "solc-stdin.jsonl"

_STANDIN = '''\
"""A stand-in for solc --standard-json: NOT a compiler.  It answers a
request from the fixtures in {fixtures} beside it (by the file names of
the request's sources; an imported file is named as solc names a
relative import) and appends what it received to {record}."""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    name = os.path.basename(sys.argv[0])
    if "--version" in sys.argv:
        print("solc, the solidity compiler commandline interface")
        print("Version: {version}+stand-in (no compiler)")
        return 0
    if "--standard-json" not in sys.argv:
        print(name + ": this stand-in answers --standard-json only",
              file=sys.stderr)
        return 1
    raw = sys.stdin.read()
    request = json.loads(raw)
    with open(os.path.join(HERE, "{record}"), "a") as handle:
        handle.write(json.dumps({{"binary": name, "argv": sys.argv[1:],
                                  "cwd": os.getcwd(), "input": request}})
                     + "\\n")
    with open(os.path.join(HERE, "{fixtures}")) as handle:
        fixtures = json.load(handle)
    out = {{"sources": {{}}, "contracts": {{}}, "errors": []}}
    for unit in request.get("sources", {{}}):
        base = os.path.basename(unit)
        prefix = unit[:len(unit) - len(base)]
        fixture = fixtures.get(base)
        if fixture is None:
            out["errors"].append({{
                "severity": "error", "type": "ParserError",
                "formattedMessage": "ParserError: Source \\"" + unit
                + "\\" not found: the stand-in has no fixture for it"}})
            continue
        for key, source in fixture["sources"].items():
            out["sources"][prefix + key] = source
        for key, contracts in fixture["contracts"].items():
            out["contracts"][prefix + key] = contracts
        out["errors"] += fixture["errors"]
    print(json.dumps(out))
    return 0


sys.exit(main())
'''


def write_solc_standin(directory: str,
                       versions: Tuple[str, ...] = (SOLC_VERSION,)) -> str:
    """Write the stand-in compiler into ``directory``: executables
    ``solc`` and ``solc-VERSION`` for each of ``versions`` (one script,
    run by this Python), the fixtures of every main file in
    :data:`STANDIN_FIXTURES`, and an empty :data:`STANDIN_RECORD`.
    Returns ``directory``, for the front of ``PATH``."""
    import sys

    os.makedirs(directory, exist_ok=True)
    fixtures = {}
    for main_file in SOURCE_FIXTURES:
        _, output = solc_output(main_file)
        fixtures[main_file] = output
    with open(os.path.join(directory, STANDIN_FIXTURES), "w") as handle:
        json.dump(fixtures, handle)
    open(os.path.join(directory, STANDIN_RECORD), "w").close()
    script = f"#!{sys.executable}\n" + _STANDIN.format(
        fixtures=STANDIN_FIXTURES, record=STANDIN_RECORD,
        version=SOLC_VERSION)
    for name in ["solc"] + [f"solc-{v}" for v in versions]:
        path = os.path.join(directory, name)
        with open(path, "w") as handle:
            handle.write(script)
        os.chmod(path, 0o755)
    return directory


def standin_requests(directory: str) -> List[dict]:
    """What the stand-in in ``directory`` was asked, in order: {binary,
    argv, cwd, input} each."""
    with open(os.path.join(directory, STANDIN_RECORD)) as handle:
        return [json.loads(line) for line in handle if line.strip()]


def decode_source_map(source_map: str) -> List[Tuple[int, int, int]]:
    """(offset, length, file index) of each entry of a compressed map:
    an empty field repeats the previous entry's."""
    out, entry = [], [0, 0, 0]
    for item in source_map.split(";") if source_map else []:
        for k, field in enumerate(item.split(":")[:3]):
            if field:
                entry[k] = int(field)
        out.append(tuple(entry))
    return out


def plain_source_info(main_file: str, contract: str, address: int,
                      constructor: bool = False):
    """The (file, line, code) a report gives the instruction at
    ``address`` of a fixture contract's runtime (its creation code with
    ``constructor``), decoded plainly from the fixture; None where the
    map has no entry or the file index is -1.  ``file`` is the fixture's
    name of the file (the report's is the path solc was given for it)."""
    texts, output = _solc_output(main_file)
    names = {s["id"]: n for n, s in output["sources"].items()}
    evm = output["contracts"][main_file][contract]["evm"]
    part = evm["bytecode" if constructor else "deployedBytecode"]
    index = [a for a, _ in _ops(part["object"])].index(address)
    entries = decode_source_map(part["sourceMap"])
    if index >= len(entries) or entries[index][2] not in names:
        return None
    offset, length, file = entries[index]
    data = texts[names[file]].encode()
    return (names[file], data[:offset].count(b"\n") + 1,
            data[offset:offset + length].decode())


# ---------------------------------------------------------------------------
# a truffle project
# ---------------------------------------------------------------------------


def write_truffle_project(directory: str) -> List[str]:
    """A truffle project's ``build/contracts`` with three artifacts:
    ``KillBilly`` (killbilly), ``Token`` (``erc20_transfer``) and the
    interface ``IToken`` (empty ``deployedBytecode``), plus a file that
    is not JSON; returns the names of the contracts with code."""
    build = os.path.join(directory, "build", "contracts")
    os.makedirs(build, exist_ok=True)
    artifacts = {"KillBilly": killbilly(), "Token": fixture("erc20_transfer"),
                 "IToken": ""}
    for name, runtime in artifacts.items():
        with open(os.path.join(build, name + ".json"), "w") as handle:
            json.dump({"contractName": name,
                       "bytecode": "0x" + runtime,
                       "deployedBytecode": "0x" + runtime,
                       "sourceMap": "", "deployedSourceMap": ""}, handle)
    with open(os.path.join(build, "Broken.json"), "w") as handle:
        handle.write("{not json")
    return sorted(n for n, code in artifacts.items() if code)


#: the truffle run's transactions and the SWC ids the JAX package finds
#: on the project of :func:`write_truffle_project` (held by
#: tests/test_torch_solidity.py)
TRUFFLE_TX_COUNT = 2
TRUFFLE_SWC = {"KillBilly": {"106"}, "Token": {"101"}}


# ---------------------------------------------------------------------------
# a geth chain database
# ---------------------------------------------------------------------------

#: the generated contract accounts of :func:`write_geth_db`
GETH_GENERATED = 1000


def _generated_code(i: int) -> str:
    """Generated account ``i``'s runtime: every tenth a killbilly (a
    ``kill()`` dispatcher), the rest a setter of storage slot ``i``."""
    if i % 10 == 0:
        return killbilly()
    return _selector_contract(f"set{i}(uint256)",
                              f"PUSH 4; CALLDATALOAD; PUSH {i}; SSTORE; STOP")


def geth_accounts(n_generated: int = GETH_GENERATED) -> List[ChainAccount]:
    """The accounts of :func:`write_geth_db`: :func:`onchain_accounts`'
    and ``n_generated`` generated contracts."""
    accounts = list(onchain_accounts().values())
    for i in range(n_generated):
        accounts.append(ChainAccount(_address(0x10000 + i),
                                     _generated_code(i), balance=1000 * i))
    return accounts


#: ``leveldb-search``'s expression in the chip check and the tests
GETH_SEARCH = "func#kill()#"


def geth_search_hits(n_generated: int = GETH_GENERATED) -> Set[str]:
    """The addresses :data:`GETH_SEARCH` finds: the accounts whose code
    holds killbilly's dispatcher (a plain scan for its ``PUSH4 selector;
    EQ``)."""
    needle = "63" + selector_of("kill()")[2:] + "14"
    return {a.address for a in geth_accounts(n_generated)
            if needle in a.code}


def _header(number: int, parent: bytes, state_root: bytes) -> list:
    from mythril_tpu_torch.support import rlp

    return [parent, b"\x00" * 32, b"\x00" * 20, state_root, b"\x00" * 32,
            b"\x00" * 32, b"\x00" * 256, rlp.encode_int(1),
            rlp.encode_int(number), rlp.encode_int(8000000),
            rlp.encode_int(0), rlp.encode_int(1438269988 + number), b"",
            b"\x00" * 32, b"\x00" * 8]


def write_geth_db(path: str, n_generated: int = GETH_GENERATED) -> dict:
    """A geth-schema LevelDB at ``path`` holding :func:`geth_accounts`:
    the state and storage tries, the codes, blocks 0 and 1 (block 1's
    receipts create every contract, so the hash-to-address index finds
    each address) in a table of snappy blocks (``write_fixture_db``), and
    block 2 (a call to KILL) with the new head in the write-ahead log's
    tail.  Returns {accounts, state_root, records, tail}."""
    from mythril_tpu_torch.ethereum.interface.leveldb.storage import (
        TYPE_VALUE, build_write_batch, write_fixture_db, write_log_records,
    )
    from mythril_tpu_torch.ethereum.interface.leveldb.trie import (
        EMPTY_ROOT, TrieBuilder,
    )
    from mythril_tpu_torch.support import rlp
    from mythril_tpu_torch.support.crypto import keccak256

    accounts = geth_accounts(n_generated)
    records: Dict[bytes, bytes] = {}
    state = TrieBuilder(secure=True)
    for account in accounts:
        storage_root = EMPTY_ROOT
        if account.storage:
            trie = TrieBuilder(secure=True)
            for slot, value in account.storage.items():
                trie.put(slot.to_bytes(32, "big"),
                         rlp.encode(rlp.encode_int(value)))
            storage_root = trie.commit()
            records.update(trie.nodes)
        code = bytes.fromhex(account.code)
        records[keccak256(code)] = code
        state.put(bytes.fromhex(account.address[2:]), rlp.encode([
            rlp.encode_int(1), rlp.encode_int(account.balance),
            storage_root, keccak256(code)]))
    state_root = state.commit()
    records.update(state.nodes)

    def num8(n):
        return n.to_bytes(8, "big")

    def block(number, parent, txs, receipts, into):
        header = rlp.encode(_header(number, parent, state_root))
        block_hash = keccak256(header)
        into[b"h" + num8(number) + block_hash] = header
        into[b"h" + num8(number) + b"n"] = block_hash
        into[b"H" + block_hash] = num8(number)
        into[b"b" + num8(number) + block_hash] = rlp.encode([txs, []])
        into[b"r" + num8(number) + block_hash] = rlp.encode(receipts)
        into[b"LastBlock"] = block_hash
        return block_hash

    def receipt(address):
        return [b"\x01", rlp.encode_int(21000), b"\x00" * 256, b"\x00" * 32,
                bytes.fromhex(address[2:]), [], rlp.encode_int(21000)]

    def call(nonce, to):
        return [rlp.encode_int(nonce), rlp.encode_int(1),
                rlp.encode_int(21000), bytes.fromhex(to[2:]),
                rlp.encode_int(0), b"", rlp.encode_int(27), b"\x01",
                b"\x02"]

    genesis = block(0, b"\x00" * 32, [], [], records)
    head = block(1, genesis, [], [receipt(a.address) for a in accounts],
                 records)
    tail: Dict[bytes, bytes] = {}
    kill = onchain_accounts()["KILL"].address
    block(2, head, [call(0, kill)], [], tail)
    write_fixture_db(path, records)
    batch = build_write_batch(len(records) + 2, [
        (TYPE_VALUE, k, v) for k, v in sorted(tail.items())])
    with open(os.path.join(path, "000006.log"), "wb") as handle:
        handle.write(write_log_records([batch]))
    return {"accounts": accounts, "state_root": state_root,
            "records": records, "tail": tail}


# ---------------------------------------------------------------------------
# an analysis API on the loopback interface (``pro``)
# ---------------------------------------------------------------------------

#: what the stand-in analysis API answers for every submission (its
#: ``contract`` field set to the submitted ``contractName``): a full issue
#: and a sparse one
PRO_ISSUES = [{"issues": [
    {"swcID": "SWC-106", "swcTitle": "Unprotected SELFDESTRUCT",
     "severity": "High",
     "description": {"head": "Anyone can kill this contract.",
                     "tail": "The SELFDESTRUCT is reachable by any caller."},
     "locations": [{"sourceMap": "24:1:0"}], "function": "kill()"},
    {"swcID": "SWC-101", "description": "An arithmetic operation can wrap."},
]}]

#: the issues :data:`PRO_ISSUES` becomes, as the JAX package's
#: ``mythx.issues_from_response`` converts it (held by
#: tests/test_torch_mythx.py): (swc id, address, severity, title,
#: function, description head) each
PRO_EXPECTED = [
    ("106", 24, "High", "Unprotected SELFDESTRUCT", "kill()",
     "Anyone can kill this contract."),
    ("101", 0, "Unknown", "", "", "An arithmetic operation can wrap."),
]


def serve_analysis_api():
    """A ``ThreadingHTTPServer`` on ``127.0.0.1:0`` that answers the
    analysis API's login, submission, status and issues (every analysis
    finished at once, its issues :data:`PRO_ISSUES`); a submission
    without the login's bearer token is refused with 401.  The server's
    ``submissions`` list holds what was submitted; the caller runs
    ``serve_forever`` and shuts it down."""
    import copy
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    token = "stand-in-token"

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: A002 — stdlib name
            pass

        def _answer(self, status, body):
            payload = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _authorized(self):
            return self.headers.get("Authorization") == f"Bearer {token}"

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/v1/auth/login":
                return self._answer(200, {"jwt": {"access": token}})
            if self.path == "/v1/analyses" and self._authorized():
                with server.lock:
                    server.submissions.append(body)
                    uuid = f"analysis-{len(server.submissions)}"
                return self._answer(200, {"uuid": uuid})
            return self._answer(401, {"error": "unauthorized"})

        def do_GET(self):
            parts = self.path.strip("/").split("/")
            if (len(parts) < 3 or parts[:2] != ["v1", "analyses"]
                    or not self._authorized()):
                return self._answer(404, {"error": "not found"})
            number = int(parts[2].rsplit("-", 1)[1])
            if len(parts) == 3:
                return self._answer(200, {"status": "Finished"})
            issues = copy.deepcopy(PRO_ISSUES)
            for issue in issues[0]["issues"]:
                issue["contract"] = server.submissions[number - 1][
                    "contractName"]
            return self._answer(200, issues)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    server.submissions = []
    server.lock = threading.Lock()
    return server
