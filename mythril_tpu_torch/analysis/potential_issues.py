"""Deferred-verification issue mechanism (reference:
mythril/analysis/potential_issues.py).

EtherThief/StateChangeAfterCall record PotentialIssues in a state
annotation during execution; check_potential_issues verifies them with a
solver call at transaction end (hooked from svm.execute_state).
"""

from mythril_tpu_torch.exceptions import UnsatError
from mythril_tpu_torch.laser.ethereum.state.annotation import StateAnnotation
from mythril_tpu_torch.support.model import get_model


class PotentialIssue:
    def __init__(
        self,
        contract,
        function_name,
        address,
        swc_id,
        title,
        bytecode,
        detector,
        severity,
        description_head,
        description_tail,
        constraints=None,
    ):
        self.title = title
        self.contract = contract
        self.function_name = function_name
        self.address = address
        self.description_head = description_head
        self.description_tail = description_tail
        self.severity = severity
        self.swc_id = swc_id
        self.bytecode = bytecode
        self.constraints = constraints or []
        self.detector = detector


class PotentialIssuesAnnotation(StateAnnotation):
    def __init__(self):
        self.potential_issues = []

    @property
    def search_importance(self):
        return 10 * len(self.potential_issues)


def get_potential_issues_annotation(global_state) -> PotentialIssuesAnnotation:
    for annotation in global_state.annotations:
        if isinstance(annotation, PotentialIssuesAnnotation):
            return annotation
    annotation = PotentialIssuesAnnotation()
    global_state.annotate(annotation)
    return annotation


def check_potential_issues(global_state) -> None:
    """Called at transaction end: verify deferred issues, report the ones
    that remain satisfiable (reference potential_issues.py:73)."""
    annotation = get_potential_issues_annotation(global_state)
    unsat_potential_issues = []
    for potential_issue in annotation.potential_issues:
        try:
            transaction_sequence = get_transaction_sequence(
                global_state,
                global_state.world_state.constraints
                + potential_issue.constraints,
            )
        except UnsatError:
            unsat_potential_issues.append(potential_issue)
            continue
        potential_issue.detector.cache.add(potential_issue.address)
        from mythril_tpu_torch.analysis.report import Issue

        issue = Issue(
            contract=potential_issue.contract,
            function_name=potential_issue.function_name,
            address=potential_issue.address,
            title=potential_issue.title,
            bytecode=potential_issue.bytecode,
            swc_id=potential_issue.swc_id,
            severity=potential_issue.severity,
            description_head=potential_issue.description_head,
            description_tail=potential_issue.description_tail,
            transaction_sequence=transaction_sequence,
        )
        potential_issue.detector.issues.append(issue)
        potential_issue.detector.update_cache([issue])
    annotation.potential_issues = unsat_potential_issues


def get_transaction_sequence(global_state, constraints):
    from mythril_tpu_torch.analysis.solver import get_transaction_sequence as impl

    return impl(global_state, constraints)
