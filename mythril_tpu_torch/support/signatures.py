"""Function-signature database: 4-byte selector -> human-readable signature.

Own copy of the JAX package's ``mythril_tpu/support/signatures.py``.
Reference counterpart: mythril/support/signatures.py (sqlite at
~/.mythril/signatures.db seeded from a bundled asset, plus online
4byte.directory lookup).  This build keeps the same API but is
offline-first: a built-in dictionary of common signatures, an optional
sqlite store under ``~/.mythril_tpu/`` (the JAX package's file: both
packages read one store), and signature import from Solidity source
text (regex scan, no solc needed).
"""

import os
import re
import sqlite3
from typing import List, Optional

from mythril_tpu_torch.support.crypto import keccak256


def selector_of(signature: str) -> str:
    """'transfer(address,uint256)' -> '0xa9059cbb'."""
    return "0x" + keccak256(signature.encode()).hex()[:8]


_BUILTIN_SIGNATURES = [
    "transfer(address,uint256)",
    "transferFrom(address,address,uint256)",
    "approve(address,uint256)",
    "balanceOf(address)",
    "allowance(address,address)",
    "totalSupply()",
    "owner()",
    "name()",
    "symbol()",
    "decimals()",
    "mint(address,uint256)",
    "burn(uint256)",
    "withdraw()",
    "withdraw(uint256)",
    "deposit()",
    "kill()",
    "destroy()",
    "close()",
    "initialize()",
    "init()",
    "fallback()",
    "pay()",
    "collect(uint256)",
    "sendToWinner()",
    "claimOwnership()",
    "transferOwnership(address)",
    "batchTransfer(address[],uint256)",
]

_builtin_cache: Optional[dict] = None


def _builtin_table() -> dict:
    global _builtin_cache
    if _builtin_cache is None:
        _builtin_cache = {selector_of(s): [s] for s in _BUILTIN_SIGNATURES}
    return _builtin_cache


class SignatureDB:
    """Selector->signature store; safe to use without any database file."""

    def __init__(self, enable_online_lookup: bool = False, path: Optional[str] = None):
        # Online lookup is accepted for CLI compat but is a no-op: this
        # environment has no network egress.
        self.enable_online_lookup = enable_online_lookup
        self._mem = {k: list(v) for k, v in _builtin_table().items()}
        self.path = path or os.path.join(
            os.path.expanduser("~"), ".mythril_tpu", "signatures.db"
        )
        self._conn: Optional[sqlite3.Connection] = None

    def _db(self) -> Optional[sqlite3.Connection]:
        if self._conn is None:
            try:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._conn = sqlite3.connect(self.path)
                self._conn.execute(
                    "CREATE TABLE IF NOT EXISTS signatures"
                    " (byte_sig VARCHAR(10), text_sig VARCHAR(255),"
                    "  PRIMARY KEY (byte_sig, text_sig))"
                )
            except (OSError, sqlite3.Error):
                return None
        return self._conn

    def add(self, byte_sig: str, text_sig: str) -> None:
        self._mem.setdefault(byte_sig, [])
        if text_sig not in self._mem[byte_sig]:
            self._mem[byte_sig].append(text_sig)
        db = self._db()
        if db is not None:
            try:
                with db:
                    db.execute(
                        "INSERT OR IGNORE INTO signatures VALUES (?, ?)",
                        (byte_sig, text_sig),
                    )
            except sqlite3.Error:
                pass

    def get(self, byte_sig: str) -> List[str]:
        if not byte_sig.startswith("0x"):
            byte_sig = "0x" + byte_sig
        found = list(self._mem.get(byte_sig, []))
        db = self._db()
        if db is not None:
            try:
                rows = db.execute(
                    "SELECT text_sig FROM signatures WHERE byte_sig = ?",
                    (byte_sig,),
                ).fetchall()
            except sqlite3.Error:
                rows = []
            for (text_sig,) in rows:
                if text_sig not in found:
                    found.append(text_sig)
        return found

    __getitem__ = get

    def import_solidity_file(self, file_path: str) -> None:
        """Regex-scan a .sol file for function declarations and index them.

        The reference extracts signatures via solc's ABI output
        (signatures.py, "solidity-file sig extraction via solc"); without
        solc we parse declarations textually, which covers the common
        elementary-type cases.
        """
        try:
            source = open(file_path, encoding="utf-8").read()
        except OSError:
            return
        for match in re.finditer(r"function\s+(\w+)\s*\(([^)]*)\)", source):
            name, params = match.group(1), match.group(2).strip()
            types = []
            ok = True
            for param in filter(None, [p.strip() for p in params.split(",")]):
                ptype = param.split()[0]
                ptype = {"uint": "uint256", "int": "int256", "byte": "bytes1"}.get(
                    ptype, ptype
                )
                if not re.fullmatch(r"[a-z0-9\[\]]+", ptype):
                    ok = False  # user-defined type: canonical form unknown
                    break
                types.append(ptype)
            if ok:
                sig = f"{name}({','.join(types)})"
                self.add(selector_of(sig), sig)
