"""Hook wiring for detection modules (reference: analysis/module/util.py)."""

import logging
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from mythril_tpu_torch.analysis.module.base import DetectionModule, EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.analysis.module.module_helpers import set_hook_phase
from mythril_tpu_torch.support.opcodes import OPCODES

log = logging.getLogger(__name__)

OP_CODE_LIST = [info.name for info in OPCODES.values()]


def _phased(execute: Callable, phase: str) -> Callable:
    def hook(global_state):
        set_hook_phase(phase)
        return execute(global_state)

    return hook


def get_detection_module_hooks(
    modules: List[DetectionModule], hook_type: str = "pre"
) -> Dict[str, List[Callable]]:
    """opcode -> bound module.execute callbacks; 'PREFIX*' entries hook
    every opcode with that prefix."""
    hook_dict: Dict[str, List[Callable]] = defaultdict(list)
    for module in modules:
        hooks = module.pre_hooks if hook_type == "pre" else module.post_hooks
        for op_code in (h.upper() for h in hooks):
            if op_code in OP_CODE_LIST:
                hook_dict[op_code].append(_phased(module.execute, hook_type))
            elif op_code.endswith("*"):
                for actual in (
                    name for name in OP_CODE_LIST if name.startswith(op_code[:-1])
                ):
                    hook_dict[actual].append(_phased(module.execute, hook_type))
            else:
                log.error(
                    "Invalid hook opcode %s in module %s", op_code, module.name
                )
    return dict(hook_dict)


def reset_callback_modules(module_names: Optional[List[str]] = None) -> None:
    for module in ModuleLoader().get_detection_modules(
        EntryPoint.CALLBACK, module_names
    ):
        module.reset_module()
