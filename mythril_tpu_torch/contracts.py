"""Test contracts of the port, built with its own assembler
(``support/assembler.py``; no solc is needed).

Byte-for-byte the contracts of the repository's ``bench.py``
(``_corpus`` and ``scale_contract``), which build them with the JAX
package's assembler; ``tests/test_torch_analyze.py`` holds the two
against each other.  :data:`CHIP_RUNS` are the analyses the chip check
runs on the card, each with the SWC set the JAX package finds.
"""

import os
from typing import Callable, List, NamedTuple, Set, Tuple

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


#: The chip check's analyses.  The two-transaction scale run is cut from
#: depth 6 to depth 4: its second transaction re-explores the whole tree
#: from every state the first one left open, so the work grows with the
#: square of the leaf count, and at depth 6 (16 times depth 4's) it
#: would not fit the chip check's time limit.
CHIP_RUNS: Tuple[ChipRun, ...] = (
    ChipRun("scale_mul d6 g16 -t 1", lambda: scale_contract(6, 16, "mul"),
            1, {"106"}, True),
    ChipRun("scale_mul d4 g16 -t 2", lambda: scale_contract(4, 16, "mul"),
            2, {"106"}, True),
    ChipRun("erc20_transfer -t 2", lambda: fixture("erc20_transfer"), 2,
            {"101"}, False),
    ChipRun("vault_withdraw -t 2", lambda: fixture("vault_withdraw"), 2,
            {"101", "104", "105", "107"}, False),
    ChipRun("killbilly -t 1", killbilly, 1, {"106"}, False),
)
#: The chip check's yardstick of the resident solver: the scale run under
#: ``MYTHRIL_TPU_RESIDENT_KERNEL=0`` (the dense tier keeps the frontiers),
#: cut from depth 6 to depth 4 so that the chip check keeps to its time
#: (at depth 6 it took 129-188 s of it).
YARDSTICK_RUN = ChipRun("scale_mul d4 g16 -t 1",
                        lambda: scale_contract(4, 16, "mul"), 1, {"106"},
                        True)
