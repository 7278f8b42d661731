"""Wall-clock budget singleton for the active analysis.

``start_execution`` stamps the deadline when symbolic execution
begins; ``time_remaining`` is read from deep inside the solver funnel
(support/model.py) to cap per-query solver timeouts, so the global
``--execution-timeout`` holds even when a single query would otherwise
run long.  Reference counterpart: laser/ethereum/time_handler.py.
"""

import time

from mythril_tpu_torch.support.support_utils import Singleton

_UNBOUNDED_MS = 10**10  # effectively "no budget armed"


class TimeHandler(object, metaclass=Singleton):
    def __init__(self):
        self._deadline_ms = None

    def start_execution(self, execution_time: float) -> None:
        """Arm the budget: ``execution_time`` seconds from now."""
        self._deadline_ms = time.time() * 1000 + execution_time * 1000

    def time_remaining(self) -> int:
        """Milliseconds left in the execution budget (negative once
        the deadline passed; huge when no budget was armed)."""
        if self._deadline_ms is None:
            return _UNBOUNDED_MS
        return int(self._deadline_ms - time.time() * 1000)


time_handler = TimeHandler()
