"""Per-opcode wall-time profiler (reference:
laser/plugin/plugins/instruction_profiler.py — which carries a
plugin_name collision bug, "dependency-pruner", at :35; fixed here)."""

import logging
import time
from collections import namedtuple
from datetime import datetime
from typing import Dict, List, Tuple

from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin

log = logging.getLogger(__name__)

_InstrExecRecord = namedtuple(
    "InstrExecRecord", ["op_code", "total_time", "count", "min_time", "max_time"]
)


class InstructionProfilerBuilder(PluginBuilder):
    plugin_name = "instruction-profiler"

    def __call__(self, *args, **kwargs):
        return InstructionProfiler()


class InstructionProfiler(LaserPlugin):
    def __init__(self):
        self.records: Dict[str, List[float]] = {}
        self._pending: Dict[int, Tuple[str, float]] = {}
        self.start_time = None

    def initialize(self, symbolic_vm) -> None:
        self.records = {}
        self.start_time = datetime.now()

        def pre_hook(op_code: str):
            def hook(global_state):
                self._pending[id(global_state)] = (op_code, time.time())

            return hook

        def post_hook(op_code: str):
            def hook(global_state):
                pending = self._pending.pop(id(global_state), None)
                if pending is None:
                    return
                _, begin = pending
                self.records.setdefault(op_code, []).append(
                    time.time() - begin
                )

            return hook

        symbolic_vm.register_instr_hooks("pre", "", pre_hook)
        symbolic_vm.register_instr_hooks("post", "", post_hook)

        @symbolic_vm.laser_hook("stop_sym_exec")
        def stop_sym_exec_hook():
            lines = []
            total = 0.0
            for op, times in sorted(
                self.records.items(), key=lambda kv: -sum(kv[1])
            ):
                subtotal = sum(times)
                total += subtotal
                lines.append(
                    f"[{op:12}] {subtotal:.4f}s ({len(times)} executions, "
                    f"avg {subtotal / len(times) * 1e6:.1f}us)"
                )
            log.info(
                "Instruction profile (total %.4fs):\n%s", total, "\n".join(lines)
            )
