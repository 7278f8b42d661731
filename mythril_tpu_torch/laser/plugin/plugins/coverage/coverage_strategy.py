"""Coverage-guided search strategy for ``--enable-coverage-strategy``
(own copy of
``mythril_tpu/laser/plugin/plugins/coverage/coverage_strategy.py``;
reference: laser/plugin/plugins/coverage/coverage_strategy.py): prefer
states whose next instruction has not been covered yet."""

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.strategy import BasicSearchStrategy
from mythril_tpu_torch.laser.plugin.plugins.coverage.coverage_plugin import (
    InstructionCoveragePlugin,
)


class CoverageStrategy(BasicSearchStrategy):
    """Decorator strategy; instantiated via LaserEVM.extend_strategy,
    whose convention passes constructor extras as one args tuple
    (args[0] = the live InstructionCoveragePlugin)."""

    def __init__(self, super_strategy: BasicSearchStrategy, args):
        self.super_strategy = super_strategy
        self.coverage_plugin: InstructionCoveragePlugin = args[0]
        super().__init__(super_strategy.work_list, super_strategy.max_depth)

    def get_strategic_global_state(self) -> GlobalState:
        for state in self.work_list:
            if not self._is_covered(state):
                self.work_list.remove(state)
                return state
        return self.super_strategy.get_strategic_global_state()

    def _is_covered(self, global_state: GlobalState) -> bool:
        bytecode = global_state.environment.code.bytecode
        index = global_state.mstate.pc
        return self.coverage_plugin.is_instruction_covered(bytecode, index)
