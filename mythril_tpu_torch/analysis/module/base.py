"""Detection-module interface (reference: mythril/analysis/module/base.py).

A DetectionModule declares an entry point (CALLBACK = opcode hooks fired
during execution; POST = runs over the recorded statespace afterwards),
the opcodes it hooks, and accumulates Issues.  ``cache`` holds
already-reported instruction addresses so each weakness is reported
once.
"""

import logging
from abc import ABC, abstractmethod
from enum import Enum
from typing import List, Optional, Set

from mythril_tpu_torch.analysis.report import Issue

log = logging.getLogger(__name__)


class EntryPoint(Enum):
    POST = 1
    CALLBACK = 2


class DetectionModule(ABC):
    name = "Detection Module Name / Title"
    swc_id = "SWC-000"
    description = "Detection module description"
    entry_point: EntryPoint = EntryPoint.CALLBACK
    pre_hooks: List[str] = []
    post_hooks: List[str] = []

    def __init__(self) -> None:
        self.issues: List[Issue] = []
        self.cache: Set[int] = set()

    def reset_module(self) -> None:
        self.issues = []

    def update_cache(self, issues: Optional[List[Issue]] = None) -> None:
        issues = issues if issues is not None else self.issues
        for issue in issues:
            self.cache.add(issue.address)

    def execute(self, target) -> Optional[List[Issue]]:
        log.debug("Entering analysis module: %s", type(self).__name__)
        result = self._execute(target)
        log.debug("Exiting analysis module: %s", type(self).__name__)
        return result

    @abstractmethod
    def _execute(self, target) -> Optional[List[Issue]]:
        """Module main method (override)."""

    def __repr__(self) -> str:
        return (
            f"<DetectionModule name={self.name} swc_id={self.swc_id} "
            f"pre_hooks={self.pre_hooks} post_hooks={self.post_hooks}>"
        )
