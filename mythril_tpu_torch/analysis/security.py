"""Fire detection modules at an analyzed statespace (reference:
mythril/analysis/security.py; own copy of the JAX package's, without
the proof-log certification)."""

import logging
from typing import List, Optional

from mythril_tpu_torch.analysis.module.base import EntryPoint
from mythril_tpu_torch.analysis.module.loader import ModuleLoader
from mythril_tpu_torch.analysis.module.util import reset_callback_modules
from mythril_tpu_torch.analysis.report import Issue

log = logging.getLogger(__name__)


def retrieve_callback_issues(
    white_list: Optional[List[str]] = None,
) -> List[Issue]:
    """Collect (and reset) the issues found by callback modules."""
    issues: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.CALLBACK, white_list=white_list
    ):
        log.debug("Retrieving results for %s", module.name)
        issues += module.issues
    reset_callback_modules(module_names=white_list)
    return issues


def fire_lasers(statespace, white_list: Optional[List[str]] = None) -> List[Issue]:
    """Run POST modules over the statespace, then collect CALLBACK issues."""
    log.info("Starting analysis")
    issues: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.POST, white_list=white_list
    ):
        log.info("Executing %s", module.name)
        issues += module.execute(statespace)
    issues += retrieve_callback_issues(white_list)
    return issues
