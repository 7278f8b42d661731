"""solc invocation helpers (own copy of ``mythril_tpu/ethereum/util.py``;
reference: mythril/ethereum/util.py).

The environment may have no solc binary; callers get a CompilerError
they can surface to the user.  Unlike the JAX package's copy, a missing
binary (``solc_binary`` None: no ``solc`` on ``PATH``) is that
CompilerError too, not a TypeError out of ``shutil.which``.
"""

import json
import logging
import os
import shutil
import subprocess
from typing import Optional

from mythril_tpu_torch.exceptions import CompilerError

log = logging.getLogger(__name__)


def solc_exists(version_or_binary: Optional[str] = "solc") -> Optional[str]:
    """The path of ``version_or_binary`` on ``PATH`` (None for none)."""
    if not version_or_binary:
        return None
    return shutil.which(version_or_binary)


def get_solc_json(file: str, solc_binary: Optional[str] = "solc",
                  solc_settings_json=None) -> dict:
    """Compile a solidity file via solc --standard-json."""
    if not solc_exists(solc_binary):
        raise CompilerError(
            f"Compiler not found: {solc_binary or 'solc'!r}. Install solc or pass "
            "--bin runtime bytecode / a -c hex string instead."
        )
    try:
        settings = json.loads(solc_settings_json) if solc_settings_json else {}
    except json.JSONDecodeError as e:
        raise CompilerError(f"--solc-json is not valid JSON: {e}")
    settings.setdefault("optimizer", {"enabled": True})
    settings["outputSelection"] = {
        "*": {
            "*": [
                "metadata", "evm.bytecode", "evm.deployedBytecode",
                "evm.methodIdentifiers",
            ],
            "": ["ast"],
        }
    }
    input_json = json.dumps(
        {
            "language": "Solidity",
            "sources": {file: {"urls": [file]}},
            "settings": settings,
        }
    )
    try:
        result = subprocess.run(
            [solc_binary, "--standard-json", "--allow-paths", "."],
            input=input_json.encode(),
            capture_output=True,
            check=False,
            cwd=os.path.dirname(os.path.abspath(file)) or ".",
        )
    except OSError as e:
        raise CompilerError(f"Compiler exception: {e}")
    try:
        output = json.loads(result.stdout)
    except json.JSONDecodeError:
        raise CompilerError(
            f"solc returned invalid output: {result.stdout[:300]!r} "
            f"{result.stderr[:300]!r}"
        )
    for error in output.get("errors", []):
        if error.get("severity") == "error":
            raise CompilerError(
                "Solc experienced a fatal error:\n"
                + error.get("formattedMessage", str(error))
            )
    return output
