"""``python3 -m mythril_tpu_torch``: the port's command-line interface
(``interfaces/cli.py``)."""

from mythril_tpu_torch.interfaces.cli import main

main()
