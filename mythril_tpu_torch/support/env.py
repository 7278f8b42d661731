"""Lenient ``MYTHRIL_TPU_*`` knob readers (own copy of the
``env_int``/``env_flag`` part of ``mythril_tpu/support/env.py``; the
startup validator is not part of this slice)."""

import os
from typing import Optional


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
