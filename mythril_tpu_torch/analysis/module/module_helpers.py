"""Hook-phase context (reference: analysis/module/module_helpers.py).

The reference determines pre/post hook phase by inspecting the Python
traceback ("one of Bernhard's trademark hacks"); here the hook wrappers
installed by analysis.module.util set an explicit context flag.
"""

from contextvars import ContextVar

_hook_phase: ContextVar[str] = ContextVar("detection_hook_phase", default="pre")


def set_hook_phase(phase: str) -> None:
    _hook_phase.set(phase)


def is_prehook() -> bool:
    return _hook_phase.get() == "pre"


def is_posthook() -> bool:
    return _hook_phase.get() == "post"
