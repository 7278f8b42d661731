"""Backend naming for the PyTorch port (counterpart of
``mythril_tpu/ops/device_health.py``).

The JAX side probes the accelerator in a killable subprocess and
quietly demotes a sick device to the CDCL.  The port does not: on this
path a missing or failing card is an error, raised where it happens
(``ops.default_device`` and the kernel launches)."""

import torch


def backend_name(device) -> str:
    """``"cuda"`` or ``"cpu"`` for the device a caller chose."""
    return torch.device(device).type
