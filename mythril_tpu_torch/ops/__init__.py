"""Device plane of the PyTorch port (counterpart of ``mythril_tpu/ops``).

:func:`default_device` replaces ``configure_jax``: it resolves the
device an entry point runs on.  The port runs on ``cuda`` unless the
caller asks for the CPU (the tests do); a missing card is an error,
never a silent fall back to the CPU.
"""

import torch

_configured = False


def configure_torch() -> None:
    """One-time numeric setup: float32 products stay full float32 (the
    sweeps count 0/1 incidences in float32 and must stay exact)."""
    global _configured
    if _configured:
        return
    _configured = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """``torch.device`` for an entry point: ``cuda`` when ``device`` is
    None, else the one asked for.  Raises when CUDA is asked for (or
    defaulted to) and no card is present."""
    configure_torch()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mythril_tpu_torch needs a CUDA device; pass device='cpu' "
            "to run on the CPU"
        )
    return dev
