"""Fire detection modules at an analyzed statespace (reference:
mythril/analysis/security.py; own copy of the JAX package's, with its
proof-log certification)."""

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
    _certify_unsat_verdicts()
    return issues


def _certify_unsat_verdicts() -> None:
    """Under ``--proof-log``, replay the solver's recorded proof stream
    through the independent checker (smt/drat.py) before the report
    ships: a wrong UNSAT erases findings silently, so it must fail
    loudly instead (``ProofError``)."""
    from mythril_tpu_torch.support.support_args import args

    if not args.proof_log:
        return
    from mythril_tpu_torch.smt.drat import IncrementalChecker
    from mythril_tpu_torch.smt.solver import get_blast_context

    ctx = get_blast_context()
    solver = ctx.solver
    if not solver.proof_enabled:
        # proof_log was set after the solver was created: nothing was
        # recorded, so a "passed" line here would be a rubber stamp
        log.warning(
            "proof_log is set but the active solver never recorded a "
            "stream (the flag was enabled after the blast context was "
            "created) — UNSAT verdicts of this run are NOT certified; "
            "call reset_blast_context() after setting the flag"
        )
        return
    if solver.proof_overflowed:
        log.warning(
            "proof stream overflowed its buffer; UNSAT verdicts of this "
            "run are NOT certified"
        )
        return
    checker = getattr(ctx, "_proof_checker", None)
    if checker is None:
        checker = ctx._proof_checker = IncrementalChecker()
    stats = checker.feed(solver.fetch_proof())
    log.info(
        "proof check passed: %d original clauses, %d learned, "
        "%d UNSAT verdicts certified",
        stats["orig"], stats["learned"], stats["unsat_verdicts"],
    )
