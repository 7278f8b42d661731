#!/usr/bin/env python3
"""What the built Keccak kernel (``ops/csrc/keccak.cu``) issues, against
the operations the function needs.

Run on the card's machine from the repository root::

    python3 chip_tools/keccak_sass.py

Builds the kernel as its wrapper loads it, disassembles the library with
the toolkit's ``cuobjdump -sass`` and counts the kernel's static
instructions by opcode.  The 24 rounds are unrolled and a row's blocks
run one loop, so the kernel's static count is close to what one block
issues.  Prints the card line, then one JSON line: the instructions in
all, by opcode, the three-input logic (``LOP3``) and funnel shifts
(``SHF``) among them beside the global and shared loads (``LDG``,
``LDS``, the tile's copies ``LDGSTS``) and the compares and selects
(``ISETP``, ``SEL``) of the message path, the 32-bit integer operations
a block needs (``chip_smoke.keccak_bound``'s count), and the kernel's
registers, spill and static shared memory (``cuobjdump
--dump-resource-usage``).  Exits non-zero where the toolkit or the
kernel is missing.
"""

import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: an instruction line of ``cuobjdump -sass``: its address, an optional
#: predicate, then the opcode
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def kernel_opcodes(sass, kernel):
    """Opcode counts of the function whose name holds ``kernel``."""
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            match = INSTRUCTION.search(line)
            if match:
                counts[match.group(1)] += 1
    return counts


#: a kernel's line of ``cuobjdump --dump-resource-usage``
RESOURCES = re.compile(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)")


def kernel_resources(text, kernel):
    """{registers, stack, shared, local} of the function whose name holds
    ``kernel`` (local memory is spill), or None."""
    inside = False
    for line in text.splitlines():
        if "Function" in line:
            inside = kernel in line
        if inside:
            match = RESOURCES.search(line)
            if match:
                return dict(zip(("registers", "stack", "shared_bytes",
                                 "local_bytes"), map(int, match.groups())))
    return None


def main() -> int:
    import chip_smoke as smoke
    from mythril_tpu_torch.ops import dense_sweep as ds
    from mythril_tpu_torch.ops import keccak as KC

    print(smoke.card_line(), flush=True)
    KC.load_library()
    cuobjdump = os.path.join(os.path.dirname(ds._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", KC.LIBRARY], check=True,
                          capture_output=True, text=True).stdout
    counts = kernel_opcodes(sass, "keccak_kernel")
    if not counts:
        raise SystemExit("keccak_kernel not found in the disassembly")
    usage = subprocess.run([cuobjdump, "--dump-resource-usage", KC.LIBRARY],
                           check=True, capture_output=True, text=True).stdout
    needed = smoke.keccak_bound(1, 64)[0] * 1e-3 * smoke.INT32_OPS_PER_S
    print(json.dumps({
        "kernel": "keccak_kernel", "instructions": sum(counts.values()),
        "needed_a_block": round(needed),
        **{op.lower(): counts[op] for op in ("LOP3", "SHF", "LDG", "LDS",
                                             "LDGSTS", "ISETP", "SEL")},
        "resources": kernel_resources(usage, "keccak_kernel"),
        "ptxas": (" | ".join(line.strip() for line in KC.build_info[1]
                             .splitlines() if "registers" in line
                             or "spill" in line or "smem" in line)
                  if KC.build_info else None),
        "by_opcode": dict(counts.most_common()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
