"""Call-depth limiter (reference: laser/plugin/plugins/call_depth_limiter.py)."""

from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState


class CallDepthLimitBuilder(PluginBuilder):
    plugin_name = "call-depth-limit"

    def __call__(self, *args, **kwargs):
        return CallDepthLimit(kwargs["call_depth_limit"])


class CallDepthLimit(LaserPlugin):
    def __init__(self, call_depth_limit: int):
        self.call_depth_limit = call_depth_limit

    def initialize(self, symbolic_vm) -> None:
        @symbolic_vm.pre_hook("CALL")
        def call_depth_hook(global_state: GlobalState):
            # The reference raises PluginSkipWorldState here
            # (call_depth_limiter.py:30) which its pre-hook handler never
            # catches; the intended behavior is to stop descending, which
            # PluginSkipState does cleanly (state committed, not executed).
            if (
                len(global_state.transaction_stack) - 1
                == self.call_depth_limit
            ):
                raise PluginSkipState
