"""Instruction-coverage tracking per analyzed bytecode.

A boolean hit-vector per bytecode, flipped in the ``execute_state``
hook; the coverage strategy reads `is_instruction_covered` to
prioritize states whose next instruction is fresh, and the stop hook
logs final percentages (observability parity with the reference:
laser/plugin/plugins/coverage/coverage_plugin.py).
"""

import logging
from typing import Dict, List, Tuple

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin

log = logging.getLogger(__name__)


class CoveragePluginBuilder(PluginBuilder):
    plugin_name = "coverage"

    def __call__(self, *args, **kwargs):
        return InstructionCoveragePlugin()


class InstructionCoveragePlugin(LaserPlugin):
    """Percent-of-instructions-stepped per bytecode, plus per-tx deltas."""

    def __init__(self):
        self.coverage: Dict[str, Tuple[int, List[bool]]] = {}
        self.initial_coverage = 0
        self.tx_id = 0

    def initialize(self, symbolic_vm) -> None:
        self.coverage = {}
        self.initial_coverage = 0
        self.tx_id = 0
        symbolic_vm.register_laser_hooks("execute_state", self._mark)
        symbolic_vm.register_laser_hooks("stop_sym_exec", self._report)
        symbolic_vm.register_laser_hooks(
            "start_sym_trans", self._snapshot_tx_start
        )
        symbolic_vm.register_laser_hooks(
            "stop_sym_trans", self._report_tx_delta
        )

    # -- hooks ---------------------------------------------------------

    def _mark(self, global_state: GlobalState) -> None:
        code = global_state.environment.code.bytecode
        entry = self.coverage.get(code)
        if entry is None:
            size = len(global_state.environment.code.instruction_list)
            entry = (size, [False] * size)
            self.coverage[code] = entry
        hits = entry[1]
        if global_state.mstate.pc < len(hits):
            hits[global_state.mstate.pc] = True

    def _report(self) -> None:
        for code, (total, hits) in self.coverage.items():
            if total:
                log.info(
                    "Achieved %.2f%% coverage for code: %s",
                    sum(hits) / float(total) * 100,
                    code,
                )

    def _snapshot_tx_start(self) -> None:
        self.initial_coverage = self._get_covered_instructions()

    def _report_tx_delta(self) -> None:
        log.info(
            "Number of new instructions covered in tx %d: %d",
            self.tx_id,
            self._get_covered_instructions() - self.initial_coverage,
        )
        self.tx_id += 1

    # -- queries (read by the coverage strategy) -----------------------

    def _get_covered_instructions(self) -> int:
        return sum(sum(hits) for _total, hits in self.coverage.values())

    def is_instruction_covered(self, bytecode, index) -> bool:
        entry = self.coverage.get(bytecode)
        if entry is None:
            return False
        hits = entry[1]
        return index < len(hits) and hits[index]
