"""Request/response protocol for the analysis daemon: parsing,
validation, and structured errors (own copy of
``mythril_tpu/serve/protocol.py``).

Input hardening is the whole job of this module: every malformed body —
broken JSON, non-hex bytecode, an oversized payload, invalid solc
settings, out-of-range knobs — maps to a structured 4xx with a stable
machine-readable ``error.code``, never a traceback.  The same
fail-at-the-edge posture as the fault plane's ``FaultSpecError``
startup validation: garbage dies at the boundary it arrived on, not
three layers deep inside the executor where its stack trace would leak
internals and its partial effects would contaminate the pool.

``POST /analyze`` body (JSON)::

    {
      "code": "6080...",            hex runtime bytecode (0x prefix ok)
      "name": "token",              optional contract label
      "tx_count": 2,                optional, 1..4 (default 2)
      "deadline_s": 30.0,           optional wall-clock budget
      "priority": "interactive",    or "batch" (the admission class)
      "source": "team-abc",         optional caller id (breaker key)
      "max_depth": 128,             optional, 1..1024
      "modules": ["SuicideModule"], optional detector allow-list
      "trace_id": "a1b2...",        optional caller-minted trace id
                                    (hex/alnum, <= 64 chars) — the
                                    server mints one otherwise; either
                                    way it threads the whole request
                                    (spans, ledger, fleet workers) and
                                    comes back in the response
      "solc_json": {...}            optional solc settings (validated,
                                    reserved for source-level inputs)
    }
"""

import binascii
import json
from dataclasses import dataclass, field
from typing import List, Optional

PRIORITIES = ("interactive", "batch")

MAX_TX_COUNT = 4
MAX_DEPTH = 1024
MAX_SOURCE_LEN = 128


class RequestError(Exception):
    """A rejected request: ``code`` is the stable machine-readable
    error code, ``status`` the HTTP status to answer with."""

    def __init__(self, code: str, message: str, status: int = 400,
                 **extra):
        super().__init__(message)
        self.code = code
        self.status = status
        self.extra = dict(extra)

    def payload(self) -> dict:
        body = {"error": {"code": self.code, "message": str(self)}}
        body["error"].update(self.extra)
        return body


@dataclass
class AnalyzeRequest:
    """One validated analysis request."""

    code: str
    name: str = "contract"
    tx_count: int = 2
    deadline_s: Optional[float] = None  # None = server default
    priority: str = "interactive"
    source: str = "anonymous"
    max_depth: int = 128
    modules: Optional[List[str]] = None
    trace_id: Optional[str] = None
    solc_json: Optional[dict] = field(default=None, repr=False)


def _require_hex_bytecode(value) -> str:
    if not isinstance(value, str) or not value.strip():
        raise RequestError(
            "bad_bytecode",
            "'code' must be a non-empty hex string of EVM runtime "
            "bytecode",
        )
    code = value.strip()
    if code.startswith(("0x", "0X")):
        code = code[2:]
    if len(code) % 2:
        raise RequestError(
            "bad_bytecode", "'code' has an odd number of hex digits"
        )
    try:
        binascii.unhexlify(code)
    except (binascii.Error, ValueError) as exc:
        raise RequestError(
            "bad_bytecode", f"'code' is not valid hex: {exc}"
        ) from exc
    return code


def _bounded_int(body, key, default, lo, hi) -> int:
    value = body.get(key, default)
    if isinstance(value, bool) or not isinstance(value, int):
        raise RequestError(
            f"bad_{key}", f"'{key}' must be an integer in [{lo}, {hi}]"
        )
    if not lo <= value <= hi:
        raise RequestError(
            f"bad_{key}", f"'{key}'={value} out of range [{lo}, {hi}]"
        )
    return value


def parse_analyze_request(raw: bytes, config) -> AnalyzeRequest:
    """Validate one ``POST /analyze`` body.  Raises
    :class:`RequestError` (a 4xx with a stable code) on anything
    malformed; the caller has already bounded ``raw`` to
    ``config.max_body_bytes``."""
    if len(raw) > config.max_body_bytes:
        raise RequestError(
            "body_too_large",
            f"request body exceeds MYTHRIL_TPU_SERVE_MAX_BODY "
            f"({config.max_body_bytes} bytes)",
            status=413,
            limit_bytes=config.max_body_bytes,
        )
    try:
        body = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise RequestError(
            "bad_json", f"request body is not valid JSON: {exc}"
        ) from exc
    if not isinstance(body, dict):
        raise RequestError(
            "bad_request", "request body must be a JSON object"
        )

    code = _require_hex_bytecode(body.get("code"))

    name = body.get("name", "contract")
    if not isinstance(name, str) or len(name) > MAX_SOURCE_LEN:
        raise RequestError(
            "bad_name",
            f"'name' must be a string of at most {MAX_SOURCE_LEN} chars",
        )

    priority = body.get("priority", "interactive")
    if priority not in PRIORITIES:
        raise RequestError(
            "bad_class",
            f"'priority' must be one of {PRIORITIES}",
        )

    source = body.get("source", "anonymous")
    if not isinstance(source, str) or not source or (
        len(source) > MAX_SOURCE_LEN
    ):
        raise RequestError(
            "bad_source",
            f"'source' must be a non-empty string of at most "
            f"{MAX_SOURCE_LEN} chars",
        )

    deadline_s = body.get("deadline_s")
    if deadline_s is not None:
        if isinstance(deadline_s, bool) or not isinstance(
            deadline_s, (int, float)
        ):
            raise RequestError(
                "bad_deadline", "'deadline_s' must be a number"
            )
        if not 0 < deadline_s <= config.max_deadline_s:
            raise RequestError(
                "bad_deadline",
                f"'deadline_s'={deadline_s} out of range "
                f"(0, {config.max_deadline_s}]",
                max_deadline_s=config.max_deadline_s,
            )
        deadline_s = float(deadline_s)

    modules = body.get("modules")
    if modules is not None:
        if not isinstance(modules, list) or not all(
            isinstance(m, str) and m for m in modules
        ):
            raise RequestError(
                "bad_modules",
                "'modules' must be a list of detector names",
            )

    trace_id = body.get("trace_id")
    if trace_id is not None:
        # a trace id crosses process boundaries and lands in Perfetto
        # metadata and Prometheus-adjacent artifacts: keep the alphabet
        # boring at the edge rather than escaping it everywhere inside
        if not isinstance(trace_id, str) or not trace_id or (
            len(trace_id) > 64
        ) or not all(c.isalnum() or c in "-_" for c in trace_id):
            raise RequestError(
                "bad_trace_id",
                "'trace_id' must be 1-64 chars of [A-Za-z0-9_-]",
            )

    solc_json = body.get("solc_json")
    if solc_json is not None:
        # accept an object or a JSON string of one; anything else is
        # the classic invalid-solc-settings failure and must be a
        # structured 400, not a compile-time traceback
        if isinstance(solc_json, str):
            try:
                solc_json = json.loads(solc_json)
            except json.JSONDecodeError as exc:
                raise RequestError(
                    "bad_solc_json",
                    f"'solc_json' is not valid JSON: {exc}",
                ) from exc
        if not isinstance(solc_json, dict):
            raise RequestError(
                "bad_solc_json", "'solc_json' must be a JSON object"
            )

    return AnalyzeRequest(
        code=code,
        name=name,
        tx_count=_bounded_int(body, "tx_count", 2, 1, MAX_TX_COUNT),
        deadline_s=deadline_s,
        priority=priority,
        source=source,
        max_depth=_bounded_int(body, "max_depth", 128, 1, MAX_DEPTH),
        modules=modules,
        trace_id=trace_id,
        solc_json=solc_json,
    )
