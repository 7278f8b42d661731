"""Annotations used by the pruning plugins (reference:
laser/plugin/plugins/plugin_annotations.py)."""

from copy import copy
from typing import Dict, List, Set

from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation


class MutationAnnotation(StateAnnotation):
    """Records that the transaction mutated persistent state."""

    @property
    def persist_over_calls(self) -> bool:
        return True


class DependencyAnnotation(StateAnnotation):
    """Tracks storage reads/writes along the current path."""

    def __init__(self):
        self.storage_loaded: List = []
        self.storage_written: Dict[int, List] = {}
        self.has_call: bool = False
        self.path: List = [0]
        self.blocks_seen: Set[int] = set()

    def __copy__(self):
        result = DependencyAnnotation()
        result.storage_loaded = copy(self.storage_loaded)
        result.storage_written = copy(self.storage_written)
        result.has_call = self.has_call
        result.path = copy(self.path)
        result.blocks_seen = copy(self.blocks_seen)
        return result

    def get_storage_write_cache(self, iteration: int):
        return self.storage_written.setdefault(iteration, [])

    def extend_storage_write_cache(self, iteration: int, value) -> None:
        cache = self.storage_written.setdefault(iteration, [])
        if value not in cache:
            cache.append(value)


class WSDependencyAnnotation(StateAnnotation):
    """World-state annotation carrying a stack of DependencyAnnotations
    across transactions."""

    def __init__(self):
        self.annotations_stack: List = []

    def __copy__(self):
        result = WSDependencyAnnotation()
        result.annotations_stack = copy(self.annotations_stack)
        return result
