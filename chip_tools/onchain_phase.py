#!/usr/bin/env python3
"""``chip_smoke.py``'s on-chain phase alone on the card: the kernels'
build, then ``onchain_phase`` (``-a`` through a two-hop clone at d6 g16
in the default rungs and force-dispatched, ``vault_withdraw`` and
``call_constant`` on the chain, the ``rpc_error`` fault, the CLI's
``analyze -a``, ``read-storage``, ``function-to-hash`` and ``watch``, the
watch in process and resumed), with the phase's launches and the card's
name and power limit::

    python3 chip_tools/onchain_phase.py
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
        print("onchain_phase: no CUDA device", file=sys.stderr)
        return 2
    from mythril_tpu_torch.ops import default_device

    card = smoke.card_line()
    smoke.log(f"card: {card}, {smoke.card_uuid()}; torch {torch.__version__}")
    default_device()
    for line in smoke.build_all():
        smoke.log(line)
    launches = smoke.onchain_phase(card)
    smoke.log(f"onchain launches: {launches}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
