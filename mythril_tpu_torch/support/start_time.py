"""Analysis start-time singleton (reference: mythril/support/start_time.py)."""

import time

from mythril_tpu_torch.support.support_utils import Singleton


class StartTime(object, metaclass=Singleton):
    def __init__(self):
        self.global_start_time = time.time()
