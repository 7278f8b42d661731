"""Cloud analysis submission — the `myth pro` backend.

Reference counterpart: mythril/mythx/__init__.py submits contracts to
the MythX API through the `pythx` client and converts detected issues
into the local Report format.  This build speaks the same wire shape
with stdlib HTTP only (no pythx/mythx_models dependency):

- ``build_request_payload``: contract sources + creation bytecode in
  the analysis-submission shape (mythril/mythx/__init__.py:50-76).
- ``analyze``: login -> submit -> poll -> fetch issues -> Report
  (:78-111).  The endpoint comes from MYTHX_API_URL; without it (or
  in an egress-less environment) a MythXApiError explains the
  situation instead of hanging.

The response->Issue conversion is exercised by unit tests with a mocked
transport; live submission requires network access.

Own copy of the JAX package's ``mythril_tpu/mythx/__init__.py``.
"""

import json
import logging
import os
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from mythril_tpu_torch.analysis.report import Issue, Report

log = logging.getLogger(__name__)

TRIAL_ETH_ADDRESS = "0x0000000000000000000000000000000000000000"
TRIAL_PASSWORD = "trial"
DEFAULT_TIMEOUT_S = 10.0
POLL_INTERVAL_S = 3.0
# overall per-analysis deadline for the status poll (overridable via
# MYTHX_POLL_TIMEOUT seconds); a stuck remote queue must not hang the CLI
POLL_DEADLINE_S = 300.0


class MythXApiError(Exception):
    """Submission failed (no endpoint, auth failure, or HTTP error)."""


def api_url() -> Optional[str]:
    return os.environ.get("MYTHX_API_URL")


def build_request_payload(contract) -> Dict[str, Any]:
    """Analysis-submission payload for one contract (sources, solc AST
    when available, creation bytecode + source maps)."""
    sources: Dict[str, Any] = {}
    source_list: List[str] = []
    main_source = getattr(contract, "input_file", None)
    solc_json = getattr(contract, "solc_json", None) or {}
    for solidity_file in getattr(contract, "solidity_files", []) or []:
        source_list.append(solidity_file.filename)
        entry: Dict[str, Any] = {}
        if solidity_file.data:
            # the text, where the JAX package's copy puts the file's bytes
            # (which its transport cannot serialize)
            entry["source"] = solidity_file.code
        ast = (
            solc_json.get("sources", {})
            .get(solidity_file.filename, {})
            .get("ast")
        )
        if ast is not None:
            entry["ast"] = ast
        sources[solidity_file.filename] = entry

    creation = getattr(contract, "creation_code", "") or ""
    deployed = getattr(contract, "code", "") or ""
    return {
        "contractName": getattr(contract, "name", None),
        "bytecode": creation or None,
        "deployedBytecode": deployed or None,
        "mainSource": str(main_source) if main_source else None,
        "sources": sources or None,
        "sourceList": source_list or None,
        "analysisMode": "quick",
    }


class _Transport:
    """Tiny JSON-over-HTTP layer, separable for tests."""

    def __init__(self, base_url: str, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.token: Optional[str] = None

    def post(self, path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self._request("POST", path, payload)

    def get(self, path: str) -> Any:
        return self._request("GET", path, None)

    def _request(self, method: str, path: str, payload) -> Any:
        url = f"{self.base_url}{path}"
        data = json.dumps(payload).encode() if payload is not None else None
        request = urllib.request.Request(url, data=data, method=method)
        request.add_header("Content-Type", "application/json")
        if self.token:
            request.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(request, timeout=self.timeout_s) as r:
                return json.loads(r.read().decode())
        except urllib.error.URLError as e:
            raise MythXApiError(f"{method} {url} failed: {e}") from e


def issues_from_response(
    detected: List[Dict[str, Any]], bytecode: str = ""
) -> List[Issue]:
    """Detected-issue JSON -> local Issue objects (shape follows the
    reference's conversion, mythril/mythx/__init__.py:93-108)."""
    issues = []
    for group in detected:
        for issue in group.get("issues", []):
            location = (issue.get("locations") or [{}])[0]
            source_map = location.get("sourceMap", "0:0:0")
            try:
                address = int(str(source_map).split(":")[0])
            except ValueError:
                address = 0
            issues.append(
                Issue(
                    contract=issue.get("contract", ""),
                    function_name=issue.get("function", ""),
                    address=address,
                    swc_id=str(issue.get("swcID", "")).replace("SWC-", ""),
                    title=issue.get("swcTitle", issue.get("title", "")),
                    bytecode=bytecode,
                    severity=issue.get("severity", "Unknown"),
                    description_head=issue.get("description", {}).get(
                        "head", ""
                    )
                    if isinstance(issue.get("description"), dict)
                    else str(issue.get("description", "")),
                    description_tail=issue.get("description", {}).get(
                        "tail", ""
                    )
                    if isinstance(issue.get("description"), dict)
                    else "",
                )
            )
    return issues


def analyze(
    contracts,
    analysis_mode: str = "quick",
    transport: Optional[_Transport] = None,
) -> Report:
    """Submit contracts for cloud analysis and collect a Report.

    Flow (mirrors the reference): authenticate -> submit one analysis
    per contract -> poll status until Finished -> fetch issues.
    """
    assert analysis_mode in ("quick", "full")
    if transport is None:
        url = api_url()
        if not url:
            raise MythXApiError(
                "No analysis endpoint configured: set MYTHX_API_URL "
                "(this environment has no network egress, so the 'pro' "
                "command requires an explicitly configured local or "
                "proxied endpoint)."
            )
        transport = _Transport(url)

    auth = transport.post(
        "/v1/auth/login",
        {
            "ethAddress": os.environ.get(
                "MYTHX_ETH_ADDRESS", TRIAL_ETH_ADDRESS
            ),
            "password": os.environ.get("MYTHX_PASSWORD", TRIAL_PASSWORD),
        },
    )
    transport.token = auth.get("jwt", {}).get("access") or auth.get("access")

    report = Report()
    for contract in contracts:
        payload = build_request_payload(contract)
        payload["analysisMode"] = analysis_mode
        submission = transport.post("/v1/analyses", payload)
        uuid = submission.get("uuid")
        if not uuid:
            raise MythXApiError(f"submission rejected: {submission}")
        deadline = time.monotonic() + float(
            os.environ.get("MYTHX_POLL_TIMEOUT", POLL_DEADLINE_S)
        )
        while True:
            status = transport.get(f"/v1/analyses/{uuid}")
            if status.get("status") in ("Finished", "Error"):
                break
            if time.monotonic() > deadline:
                raise MythXApiError(
                    f"analysis {uuid} did not finish before the poll "
                    f"deadline (last status: {status.get('status')!r})"
                )
            time.sleep(POLL_INTERVAL_S)
        if status.get("status") == "Error":
            raise MythXApiError(f"analysis {uuid} failed: {status}")
        detected = transport.get(f"/v1/analyses/{uuid}/issues")
        for issue in issues_from_response(
            detected, bytecode=payload.get("deployedBytecode") or ""
        ):
            report.append_issue(issue)
    return report
