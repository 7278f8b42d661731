"""Issues and reports (reference: mythril/analysis/report.py).

Own copy of ``mythril_tpu/analysis/report.py``; the jsonv2 meta block
carries the exception log, the resilience block (``meta.resilience``:
every nonzero degradation counter, ``partial`` after a drain or a
governor-capped run, ``governor`` when a budget tripped and ``persist``
when the knowledge plane is on, and the nonzero fleet counters as
``fleet_<field>``; absent when all are empty) and the observability
block (``meta.observability``).

Renders text / markdown / json / jsonv2 (SWC standard format).  Layout
follows the reference's report shape (section per issue, SWC id,
severity, function, PC address, gas estimate, transaction sequence) so
downstream consumers can migrate; rendering is plain Python instead of
Jinja2 templates.
"""

import json
import logging
import time
from typing import Any, Dict, List, Optional

from mythril_tpu_torch.analysis.swc_data import SWC_TO_TITLE
from mythril_tpu_torch.support.source_support import Source
from mythril_tpu_torch.support.start_time import StartTime
from mythril_tpu_torch.support.support_utils import get_code_hash

log = logging.getLogger(__name__)


class Issue:
    def __init__(
        self,
        contract: str,
        function_name: str,
        address: int,
        swc_id: str,
        title: str,
        bytecode: str,
        gas_used=(None, None),
        severity: str = "Unknown",
        description_head: str = "",
        description_tail: str = "",
        transaction_sequence: Optional[Dict] = None,
        source_location: Optional[str] = None,
    ):
        self.title = title
        self.contract = contract
        self.function = function_name
        self.address = address
        self.description_head = description_head
        self.description_tail = description_tail
        self.description = f"{description_head}\n{description_tail}".strip()
        self.severity = severity
        self.swc_id = swc_id
        self.min_gas_used, self.max_gas_used = gas_used
        self.filename = None
        self.code = None
        self.lineno = None
        self.source_mapping = None
        self.discovery_time = time.time() - StartTime().global_start_time
        self.bytecode_hash = get_code_hash(bytecode) if bytecode else ""
        self.transaction_sequence = transaction_sequence
        self.source_location = source_location

    @property
    def transaction_sequence_users(self):
        """Readable exploit steps (concrete tx sequence) or None."""
        return self.transaction_sequence

    @property
    def transaction_sequence_jsonv2(self):
        return self.transaction_sequence

    @property
    def as_dict(self) -> Dict:
        issue = {
            "title": self.title,
            "swc-id": self.swc_id,
            "contract": self.contract,
            "description": self.description,
            "function": self.function,
            "severity": self.severity,
            "address": self.address,
            "tx_sequence": self.transaction_sequence,
            "min_gas_used": self.min_gas_used,
            "max_gas_used": self.max_gas_used,
            "sourceMap": self.source_mapping,
        }
        if self.filename and self.lineno:
            issue["filename"] = self.filename
            issue["lineno"] = self.lineno
        if self.code:
            issue["code"] = self.code
        return issue

    def add_code_info(self, contract) -> None:
        """Attach source filename/line/code via the contract's source
        maps (reference report.py add_code_info)."""
        if self.address is None or not hasattr(contract, "get_source_info"):
            return
        codeinfo = contract.get_source_info(
            self.address, constructor=(self.function == "constructor")
        )
        if codeinfo is None:
            self.source_mapping = self.address
            return
        self.filename = codeinfo.filename
        self.code = codeinfo.code
        self.lineno = codeinfo.lineno
        self.source_mapping = codeinfo.solc_mapping

    def resolve_function_name(self, contract) -> None:
        if not self.function or self.function.startswith("_function_0x"):
            selector = (
                self.function[len("_function_") :] if self.function else None
            )
            if selector is None:
                return
            from mythril_tpu_torch.support.signatures import SignatureDB

            matches = SignatureDB().get(selector)
            if matches:
                self.function = matches[0]


class Report:
    """Collection of issues + renderers."""

    environment: Dict[str, Any] = {}

    def __init__(
        self,
        contracts=None,
        exceptions=None,
        execution_info=None,
    ):
        self.issues: Dict = {}
        self.solc_version = ""
        self.meta: Dict[str, Any] = {}
        self.source = Source()
        self.source.get_source_from_contracts_list(contracts or [])
        self.exceptions = exceptions or []
        self.execution_info = execution_info or []

    def sorted_issues(self) -> List[Dict]:
        issue_list = [issue.as_dict for issue in self.issues.values()]
        return sorted(issue_list, key=lambda k: (k["address"], k["title"]))

    def append_issue(self, issue: Issue, extra_message: str = "") -> None:
        key = (issue.address, issue.title, issue.function)
        self.issues[key] = issue

    # ------------------------------------------------------------------
    # renderers
    # ------------------------------------------------------------------

    def as_text(self) -> str:
        if not self.issues:
            return "The analysis was completed successfully. No issues were detected.\n"
        blocks = []
        for issue in self._sorted_issue_objects():
            lines = [
                f"==== {issue.title} ====",
                f"SWC ID: {issue.swc_id}",
                f"Severity: {issue.severity}",
                f"Contract: {issue.contract}",
                f"Function name: {issue.function}",
                f"PC address: {issue.address}",
                f"Estimated Gas Usage: {issue.min_gas_used} - {issue.max_gas_used}",
                issue.description,
            ]
            if issue.filename and issue.lineno is not None:
                lines.append("--------------------")
                lines.append(f"In file: {issue.filename}:{issue.lineno}")
                if issue.code:
                    lines.append("")
                    lines.append(issue.code)
            if issue.transaction_sequence:
                lines.append("--------------------")
                lines.append("Initial State:")
                lines.append(
                    self._render_initial_state(issue.transaction_sequence)
                )
                lines.append("")
                lines.append("Transaction Sequence:")
                lines.append(
                    self._render_transaction_sequence(issue.transaction_sequence)
                )
            blocks.append("\n".join(lines))
        return "\n\n".join(blocks) + "\n\n"

    def as_markdown(self) -> str:
        if not self.issues:
            return (
                "# Analysis results\n\nThe analysis was completed "
                "successfully. No issues were detected.\n"
            )
        blocks = ["# Analysis results"]
        for issue in self._sorted_issue_objects():
            lines = [
                f"## {issue.title}",
                f"- SWC ID: {issue.swc_id}",
                f"- Severity: {issue.severity}",
                f"- Contract: {issue.contract}",
                f"- Function name: `{issue.function}`",
                f"- PC address: {issue.address}",
                f"- Estimated Gas Usage: {issue.min_gas_used} - {issue.max_gas_used}",
                "",
                "### Description",
                issue.description,
            ]
            if issue.filename and issue.lineno is not None:
                lines.append(f"\nIn file: {issue.filename}:{issue.lineno}")
                if issue.code:
                    lines.append(f"\n```\n{issue.code}\n```")
            blocks.append("\n".join(lines))
        return "\n\n".join(blocks) + "\n"

    def as_json(self) -> str:
        result = {
            "success": True,
            "error": None,
            "issues": self.sorted_issues(),
        }
        return json.dumps(result, sort_keys=True)

    def as_swc_standard_format(self) -> str:
        """jsonv2 / MythX-style output (reference as_swc_standard_format)."""
        issues = []
        for issue in self._sorted_issue_objects():
            idx = self.source.get_source_index(issue.bytecode_hash)
            issues.append(
                {
                    "swcID": "SWC-" + issue.swc_id if issue.swc_id else "",
                    "swcTitle": SWC_TO_TITLE.get(issue.swc_id, ""),
                    "description": {
                        "head": issue.description_head,
                        "tail": issue.description_tail,
                    },
                    "severity": issue.severity,
                    "locations": [
                        {
                            "sourceMap": f"{issue.address}:1:{idx}",
                        }
                    ],
                    "extra": {
                        "discoveryTime": int(issue.discovery_time * 10**9),
                        "testCases": [issue.transaction_sequence]
                        if issue.transaction_sequence
                        else [],
                    },
                }
            )
        meta = self._get_exception_data()
        resilience = resilience_meta()
        if resilience:
            meta["resilience"] = resilience
        # stable observability section: artifact paths and event counts,
        # every key always present
        from mythril_tpu_torch.observability import observability_meta

        meta["observability"] = observability_meta()
        result = [
            {
                "issues": issues,
                "sourceType": self.source.source_type,
                "sourceFormat": self.source.source_format,
                "sourceList": self.source.source_list,
                "meta": meta,
            }
        ]
        return json.dumps(result, sort_keys=True)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _sorted_issue_objects(self) -> List[Issue]:
        return sorted(
            self.issues.values(), key=lambda i: (i.address or 0, i.title)
        )

    def _get_exception_data(self) -> Dict:
        if not self.exceptions:
            return {}
        return {"logs": [{"level": "error", "hidden": True, "msg": e} for e in self.exceptions]}

    @staticmethod
    def _render_initial_state(tx_sequence: Dict) -> str:
        accounts = tx_sequence.get("initialState", {}).get("accounts", {})
        lines = []
        for address, data in accounts.items():
            lines.append(
                f"Account: [{address}], balance: {data.get('balance')}, "
                f"nonce:{data.get('nonce')}, storage:{data.get('storage')}"
            )
        return "\n".join(lines)

    @staticmethod
    def _render_transaction_sequence(tx_sequence: Dict) -> str:
        lines = []
        for i, step in enumerate(tx_sequence.get("steps", [])):
            header = f"Caller: [{step.get('origin')}], "
            if step.get("address") == "":
                header += "calldata: , "  # creation tx
            else:
                header += f"calldata: {step.get('calldata')}, "
            header += f"value: {step.get('value')}"
            lines.append(header)
        return "\n".join(lines)


def resilience_meta() -> dict:
    """The jsonv2 ``meta.resilience`` block: the nonzero degradation
    counters (a demoted run's findings are the same, but its wall-clock
    lost the card's speed-up) and fleet counters, ``partial`` when a
    drain stopped the run or the governor capped it, the governor's
    budgets and rungs when one tripped, and the knowledge plane's block
    when it is on.  Empty when there is nothing to say."""
    from mythril_tpu_torch.parallel.fleet import fleet_stats
    from mythril_tpu_torch.persist.plane import get_knowledge_plane
    from mythril_tpu_torch.resilience.checkpoint import (
        drain_requested, get_checkpoint_plane,
    )
    from mythril_tpu_torch.resilience.governor import governor_meta
    from mythril_tpu_torch.resilience.telemetry import resilience_stats

    degraded = {k: v for k, v in resilience_stats.as_dict().items() if v}
    # a sharded run says so: worker deaths and rebalances explain its
    # wall, a stale-gossip drop records the epoch fence firing
    degraded.update({f"fleet_{k}": v
                     for k, v in fleet_stats.as_dict().items() if v})
    if drain_requested() or get_checkpoint_plane().partial:
        degraded["partial"] = True
    governor_block = governor_meta()
    if governor_block is not None:
        degraded["governor"] = governor_block
    # the knowledge plane's warm/cold provenance of this run (absent
    # when persistence is off)
    persist_block = get_knowledge_plane().persist_meta()
    if persist_block is not None:
        degraded["persist"] = persist_block
    return degraded
