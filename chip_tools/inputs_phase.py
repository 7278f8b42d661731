#!/usr/bin/env python3
"""``chip_smoke.py``'s inputs phase alone on the card: the kernels'
build, then ``inputs_phase`` (``SCALE.sol:Scale`` at d6 g16 through the
stand-in compiler in the default rungs and force-dispatched, ``truffle``
on a project of three artifacts, a geth LevelDB of 1,008 accounts
written, indexed and searched, and the CLI's ``analyze X.sol``,
``analyze --solv --solc-json -q``, ``leveldb-search``, ``hash-to-address``
and ``pro`` against a loopback analysis API as processes side by side),
with the phase's launches and the card's name and power limit::

    python3 chip_tools/inputs_phase.py
"""

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        print("inputs_phase: no CUDA device", file=sys.stderr)
        return 2
    from mythril_tpu_torch.ops import default_device

    card = smoke.card_line()
    smoke.log(f"card: {card}, {smoke.card_uuid()}; torch {torch.__version__}")
    default_device()
    for line in smoke.build_all():
        smoke.log(line)
    launches = smoke.inputs_phase(card)
    smoke.log(f"inputs launches: {launches}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
