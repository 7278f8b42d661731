"""``MYTHRIL_TPU_*`` knobs of the port (own copy of the part of
``mythril_tpu/support/env.py`` for the knobs the port reads): the
lenient readers ``env_int`` / ``env_flag``, which the solver calls on
hot paths (malformed -> default), and the startup gate
:func:`validate_env`, which the CLI calls before a command so that a
typo'd value exits 2 instead of running a default."""

import os
from typing import Dict, Optional, Tuple


class EnvSpecError(RuntimeError):
    """A malformed ``MYTHRIL_TPU_*`` value, raised by :func:`validate_env`
    at CLI startup (exit code 2)."""


#: name -> (kind, floor, ceil), kind "int" or "flag": the JAX package's
#: entries (``KNOWN_SPECS``) for the knobs this port reads.  The port
#: also reads MYTHRIL_TPU_FRONTIER, MYTHRIL_TPU_PALLAS,
#: MYTHRIL_TPU_ROUND_LADDER and its own alias MYTHRIL_TPU_DENSE, which
#: that table does not hold: like the JAX package, the gate takes any
#: value of theirs.
KNOWN_SPECS: Dict[str, Tuple[str, Optional[float], Optional[float]]] = {
    "MYTHRIL_TPU_FRONTIER_PERIOD": ("int", 1, None),
    "MYTHRIL_TPU_FRONTIER_FAN": ("int", 1, None),
    "MYTHRIL_TPU_FRONTIER_DEG": ("int", 2, None),
    "MYTHRIL_TPU_TIER_PERIOD": ("int", 1, None),
    "MYTHRIL_TPU_PROBE_MEMO_CAP": ("int", 1, None),
    "MYTHRIL_TPU_RESIDENT_KERNEL": ("flag", None, None),
    "MYTHRIL_TPU_RESIDENT_BUDGET": ("int", 1, None),
    "MYTHRIL_TPU_RESIDENT_WATCHDOG": ("int", 1, None),
    "MYTHRIL_TPU_RESIDENT_EXTRA": ("int", 1, None),
    "MYTHRIL_TPU_RESIDENT_POOL": ("flag", None, None),
    "MYTHRIL_TPU_WARM_START": ("flag", None, None),
}

#: raw values :func:`env_flag` understands; anything else on a "flag"
#: knob is a typo that would run the default
FLAG_VALUES = ("0", "off", "false", "1", "on", "true", "force")


def _clamp(value, floor, ceil):
    if floor is not None and value < floor:
        value = type(value)(floor)
    if ceil is not None and value > ceil:
        value = type(value)(ceil)
    return value


def env_int(name: str, default: int, floor: Optional[int] = None,
            ceil: Optional[int] = None) -> int:
    """Integer knob read: unset/blank/malformed -> ``default``,
    out-of-range values clamp to [floor, ceil]."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return _clamp(int(raw), floor, ceil)
    except ValueError:
        return default


def env_flag(name: str, default: bool = True) -> bool:
    """Kill-switch style boolean: ``0``/``off``/``false`` disable,
    ``1``/``on``/``true``/``force`` enable, anything else (including
    unset) keeps the default."""
    raw = os.environ.get(name, "").lower()
    if raw in ("0", "off", "false"):
        return False
    if raw in ("1", "on", "true", "force"):
        return True
    return default


def validate_env(environ=None) -> None:
    """Strict startup pass over :data:`KNOWN_SPECS`: raises
    :class:`EnvSpecError` on the first malformed or out-of-range value
    set in the environment.  Unset and blank knobs pass."""
    environ = os.environ if environ is None else environ
    for name in sorted(KNOWN_SPECS):
        raw = environ.get(name)
        if raw is None or raw.strip() == "":
            continue
        kind, floor, ceil = KNOWN_SPECS[name]
        if kind == "flag":
            if raw.strip().lower() not in FLAG_VALUES:
                raise EnvSpecError(
                    f"{name}={raw!r}: not a flag "
                    f"(expected one of {'/'.join(FLAG_VALUES)})")
            continue
        try:
            value = int(raw)
        except ValueError:
            raise EnvSpecError(f"{name}={raw!r}: not an integer") from None
        if floor is not None and value < floor:
            raise EnvSpecError(f"{name}={value}: must be >= {floor}")
        if ceil is not None and value > ceil:
            raise EnvSpecError(f"{name}={value}: must be <= {ceil}")
