"""The card's health (counterpart of ``mythril_tpu/ops/device_health.py``).

The JAX package probes its accelerator and, when the device dies
mid-run, demotes the whole process to the native CDCL
(``mark_unhealthy``; every later device path is skipped).  The port
does not: a missing or lost card is an error.

- :func:`check_device` is the port's ``device_ok()`` seam, called where
  the JAX package asks for its verdict (the dense tier, the gather
  tiers' eligibility, the dispatcher pre-split's validation, the
  concrete replay).  It raises :class:`DeviceLost` when the fault
  plane's ``probe_flap`` fires.
- :func:`subprocess_probe_ok` is the watchdog's re-probe
  (``resilience/watchdog.py``): a killable subprocess that launches one
  tiny CUDA operation.  A dispatch the ladder gave up on demotes its
  context to the CDCL when the re-probe answers; when it does not, the
  watchdog raises :class:`DeviceLost`.  The re-probe is skipped for a
  CPU device, and bounded by :data:`REPROBE_TIMEOUT_S`.
"""

import logging
import subprocess
import sys
from typing import Optional

import torch

log = logging.getLogger(__name__)

#: seconds the re-probe's subprocess gets (start, CUDA context, one sum)
REPROBE_TIMEOUT_S = 20.0

#: what the re-probe's subprocess runs: the sum of 0..127 on the card
_PROBE_CODE = (
    "import torch\n"
    "x = torch.arange(128, dtype=torch.int32, device='cuda')\n"
    "print(int(x.sum().item()))\n"
)


class DeviceLost(RuntimeError):
    """The card stopped answering (a failed re-probe after the dispatch
    ladder gave up, or an injected ``probe_flap``).  The analysis
    fails; nothing carries on on the CPU."""


def backend_name(device) -> str:
    """``"cuda"`` or ``"cpu"`` for the device a caller chose."""
    return torch.device(device).type


def check_device() -> None:
    """The health seam of the device paths: raises :class:`DeviceLost`
    when an armed ``probe_flap`` shot fires."""
    from mythril_tpu_torch.resilience import faults

    if faults.health_flap():
        raise DeviceLost("injected probe flap: the card's health check "
                         "answered dead")


def subprocess_probe_ok(timeout_s: Optional[float] = None) -> bool:
    """One tiny CUDA operation in a killable subprocess: True when it
    answers within ``timeout_s`` (default :data:`REPROBE_TIMEOUT_S`)
    with the right sum."""
    if timeout_s is None:
        timeout_s = REPROBE_TIMEOUT_S
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_CODE], capture_output=True,
            text=True, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        log.warning("card re-probe did not answer within %.0fs", timeout_s)
        return False
    except OSError as exc:
        log.warning("card re-probe failed to start (%s)", exc)
        return False
    if proc.returncode != 0:
        tail = proc.stderr.strip().splitlines()[-1:]
        log.warning("card re-probe exited %d (%s)", proc.returncode,
                    tail[0] if tail else "")
        return False
    return proc.stdout.split()[-1:] == ["8128"]
