"""Mutation pruner (reference: laser/plugin/plugins/mutation_pruner.py).

A transaction that provably mutated nothing (no SSTORE/CALL reached,
callvalue constrained to zero) yields a world state equivalent to its
parent; committing it would only clone the frontier.  Raises
PluginSkipWorldState at add_world_state for such states.
"""

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin
from mythril_tpu_torch.laser.plugin.plugins.plugin_annotations import MutationAnnotation
from mythril_tpu_torch.laser.plugin.signals import PluginSkipWorldState
from mythril_tpu_torch.smt import UGT, symbol_factory


class MutationPrunerBuilder(PluginBuilder):
    plugin_name = "mutation-pruner"

    def __call__(self, *args, **kwargs):
        return MutationPruner()


class MutationPruner(LaserPlugin):
    def initialize(self, symbolic_vm) -> None:
        @symbolic_vm.pre_hook("SSTORE")
        def sstore_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        @symbolic_vm.pre_hook("CALL")
        def call_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        @symbolic_vm.pre_hook("STATICCALL")
        def staticcall_mutator_hook(global_state: GlobalState):
            global_state.annotate(MutationAnnotation())

        @symbolic_vm.laser_hook("add_world_state")
        def world_state_filter_hook(global_state: GlobalState):
            if isinstance(
                global_state.current_transaction, ContractCreationTransaction
            ):
                return
            callvalue = global_state.environment.callvalue
            if isinstance(callvalue, int):
                callvalue = symbol_factory.BitVecVal(callvalue, 256)
            try:
                constraints = global_state.world_state.constraints + [
                    UGT(callvalue, symbol_factory.BitVecVal(0, 256))
                ]
                solver.get_model(tuple(constraints))
                return  # value transfer possible: the state mutated balances
            except UnsatError:
                pass
            if len(list(global_state.get_annotations(MutationAnnotation))) == 0:
                raise PluginSkipWorldState


detector = None  # not a detection module; kept for symmetry with modules
