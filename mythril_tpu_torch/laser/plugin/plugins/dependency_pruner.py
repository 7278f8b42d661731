"""Dependency pruner (reference: laser/plugin/plugins/dependency_pruner.py).

Per basic block, tracks which storage locations are read along paths
containing the block.  From transaction 2 onward, a block (and the state
entering it) is skipped unless a location written in the previous
transaction may alias a location its paths read — each alias check is a
tiny equality query that hits the memoized solver funnel.
"""

import logging
from typing import Dict, List, Set, cast

from mythril_tpu_torch.analysis import solver
from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.global_state import GlobalState
from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (
    ContractCreationTransaction,
)
from mythril_tpu_torch.laser.plugin.builder import PluginBuilder
from mythril_tpu_torch.laser.plugin.interface import LaserPlugin
from mythril_tpu_torch.laser.plugin.plugins.plugin_annotations import (
    DependencyAnnotation,
    WSDependencyAnnotation,
)
from mythril_tpu_torch.laser.plugin.signals import PluginSkipState

log = logging.getLogger(__name__)


def get_dependency_annotation(state: GlobalState) -> DependencyAnnotation:
    annotations = cast(
        List[DependencyAnnotation],
        list(state.get_annotations(DependencyAnnotation)),
    )
    if len(annotations) == 0:
        # carry over the annotation pushed by the previous transaction's
        # STOP/RETURN state (stack discipline matches BFS ordering)
        try:
            world_state_annotation = get_ws_dependency_annotation(state)
            annotation = world_state_annotation.annotations_stack.pop()
        except IndexError:
            annotation = DependencyAnnotation()
        state.annotate(annotation)
        return annotation
    return annotations[0]


def get_ws_dependency_annotation(state: GlobalState) -> WSDependencyAnnotation:
    annotations = cast(
        List[WSDependencyAnnotation],
        list(state.world_state.get_annotations(WSDependencyAnnotation)),
    )
    if len(annotations) == 0:
        annotation = WSDependencyAnnotation()
        state.world_state.annotate(annotation)
        return annotation
    return annotations[0]


class DependencyPrunerBuilder(PluginBuilder):
    plugin_name = "dependency-pruner"

    def __call__(self, *args, **kwargs):
        return DependencyPruner()


class DependencyPruner(LaserPlugin):
    def __init__(self):
        self._reset()

    def _reset(self):
        self.iteration = 0
        self.calls_on_path: Dict[int, bool] = {}
        self.sloads_on_path: Dict[int, List] = {}
        self.sstores_on_path: Dict[int, List] = {}
        self.storage_accessed_global: Set = set()

    def update_sloads(self, path: List[int], target_location) -> None:
        for address in path:
            locations = self.sloads_on_path.setdefault(address, [])
            if target_location not in locations:
                locations.append(target_location)

    def update_sstores(self, path: List[int], target_location) -> None:
        for address in path:
            locations = self.sstores_on_path.setdefault(address, [])
            if target_location not in locations:
                locations.append(target_location)

    def update_calls(self, path: List[int]) -> None:
        for address in path:
            if address in self.sstores_on_path:
                self.calls_on_path[address] = True

    def _may_alias(self, a, b) -> bool:
        try:
            solver.get_model((a == b,))
            return True
        except UnsatError:
            return False

    def wanna_execute(self, address: int, annotation: DependencyAnnotation) -> bool:
        storage_write_cache = annotation.get_storage_write_cache(
            self.iteration - 1
        )
        if address in self.calls_on_path:
            return True
        # "pure" block: no reads below it -> nothing a write can influence
        if address not in self.sloads_on_path:
            return False
        if address in self.storage_accessed_global:
            for location in self.sstores_on_path:
                if self._may_alias(location, address):
                    return True
        dependencies = self.sloads_on_path[address]
        for location in storage_write_cache:
            for dependency in dependencies:
                if self._may_alias(location, dependency):
                    return True
            for dependency in annotation.storage_loaded:
                if self._may_alias(location, dependency):
                    return True
        return False

    def initialize(self, symbolic_vm) -> None:
        self._reset()

        @symbolic_vm.laser_hook("start_sym_trans")
        def start_sym_trans_hook():
            self.iteration += 1

        def _check_basic_block(address: int, annotation: DependencyAnnotation):
            if self.iteration < 2:
                return
            if address not in annotation.blocks_seen:
                annotation.blocks_seen.add(address)
                return
            if self.wanna_execute(address, annotation):
                return
            log.debug(
                "Skipping state: storage slots %s not read in block at %d",
                annotation.get_storage_write_cache(self.iteration - 1),
                address,
            )
            raise PluginSkipState

        @symbolic_vm.post_hook("JUMP")
        def jump_hook(state: GlobalState):
            try:
                address = state.get_current_instruction()["address"]
            except IndexError:
                raise PluginSkipState
            annotation = get_dependency_annotation(state)
            annotation.path.append(address)
            _check_basic_block(address, annotation)

        @symbolic_vm.post_hook("JUMPI")
        def jumpi_hook(state: GlobalState):
            try:
                address = state.get_current_instruction()["address"]
            except IndexError:
                raise PluginSkipState
            annotation = get_dependency_annotation(state)
            annotation.path.append(address)
            _check_basic_block(address, annotation)

        @symbolic_vm.pre_hook("SSTORE")
        def sstore_hook(state: GlobalState):
            annotation = get_dependency_annotation(state)
            location = state.mstate.stack[-1]
            self.update_sstores(annotation.path, location)
            annotation.extend_storage_write_cache(self.iteration, location)

        @symbolic_vm.pre_hook("SLOAD")
        def sload_hook(state: GlobalState):
            annotation = get_dependency_annotation(state)
            location = state.mstate.stack[-1]
            if location not in annotation.storage_loaded:
                annotation.storage_loaded.append(location)
            # backwards-annotate: execution may never reach STOP/RETURN
            self.update_sloads(annotation.path, location)
            self.storage_accessed_global.add(location)

        @symbolic_vm.pre_hook("CALL")
        def call_hook(state: GlobalState):
            annotation = get_dependency_annotation(state)
            self.update_calls(annotation.path)
            annotation.has_call = True

        @symbolic_vm.pre_hook("STATICCALL")
        def staticcall_hook(state: GlobalState):
            annotation = get_dependency_annotation(state)
            self.update_calls(annotation.path)
            annotation.has_call = True

        def _transaction_end(state: GlobalState) -> None:
            annotation = get_dependency_annotation(state)
            for index in annotation.storage_loaded:
                self.update_sloads(annotation.path, index)
            for index in annotation.storage_written:
                self.update_sstores(annotation.path, index)
            if annotation.has_call:
                self.update_calls(annotation.path)

        @symbolic_vm.pre_hook("STOP")
        def stop_hook(state: GlobalState):
            _transaction_end(state)

        @symbolic_vm.pre_hook("RETURN")
        def return_hook(state: GlobalState):
            _transaction_end(state)

        @symbolic_vm.laser_hook("add_world_state")
        def world_state_filter_hook(state: GlobalState):
            if isinstance(
                state.current_transaction, ContractCreationTransaction
            ):
                self.iteration = 0
                return
            world_state_annotation = get_ws_dependency_annotation(state)
            annotation = get_dependency_annotation(state)
            # reset per-tx fields; storage_written carries over
            annotation.path = [0]
            annotation.storage_loaded = []
            world_state_annotation.annotations_stack.append(annotation)
