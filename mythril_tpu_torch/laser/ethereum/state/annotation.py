"""State annotations: the data-attachment mechanism that survives forks
(reference: laser/ethereum/state/annotation.py).

Detection modules and pruners subclass StateAnnotation; each fork copies
annotations, and the persist flags control whether they ride along onto
committed world states / across message calls.
"""


class StateAnnotation:
    @property
    def persist_to_world_state(self) -> bool:
        """Keep the annotation on the WorldState after the transaction
        commits (so it is seen by all following transactions)."""
        return False

    @property
    def persist_over_calls(self) -> bool:
        """Propagate the annotation into child message-call frames."""
        return False

    @property
    def search_importance(self) -> int:
        """Priority hint for search strategies (higher = sooner)."""
        return 1


class MergeableStateAnnotation(StateAnnotation):
    """Annotation supporting state merging (kept for API parity)."""

    def check_merge_annotation(self, annotation) -> bool:
        raise NotImplementedError

    def merge_annotation(self, annotation):
        raise NotImplementedError
