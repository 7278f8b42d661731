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

    #: veritesting policy (laser/ethereum/veritest.py): two lanes
    #: differing only in their dependency traces may merge; the join
    #: below unions every field the pruner consults in the direction
    #: that can only reduce pruning (more blocks, reads and writes on
    #: record make wanna_execute say yes more often), so a merged lane
    #: never skips a block either arm would have executed
    veritest_path_local = True

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

    @staticmethod
    def veritest_join(ann_a, ann_b):
        """Union of the two arms' dependency records (see the class
        comment for the soundness direction); ``blocks_seen`` takes the
        intersection, so that the skip gate fires only for blocks both
        arms had already visited."""
        joined = copy(ann_a)
        for location in ann_b.storage_loaded:
            if location not in joined.storage_loaded:
                joined.storage_loaded.append(location)
        for iteration, cache in ann_b.storage_written.items():
            for location in cache:
                joined.extend_storage_write_cache(iteration, location)
        for address in ann_b.path:
            if address not in joined.path:
                joined.path.append(address)
        joined.has_call = ann_a.has_call or ann_b.has_call
        joined.blocks_seen = ann_a.blocks_seen & ann_b.blocks_seen
        return joined

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
