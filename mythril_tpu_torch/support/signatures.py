"""Function-signature database: 4-byte selector -> human-readable signature.

Reference counterpart: mythril/support/signatures.py (sqlite at
~/.mythril/signatures.db seeded from a bundled asset, plus online
4byte.directory lookup).  Own copy of the JAX package's, trimmed to
its built-in dictionary of common signatures: the port reads and writes
no signature store and takes no Solidity source.
"""

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
    """Selector->signature lookup over the built-in table."""

    def __init__(self, enable_online_lookup: bool = False):
        # accepted for API compatibility; there is no online lookup
        self.enable_online_lookup = enable_online_lookup
        self._mem = _builtin_table()

    def get(self, byte_sig: str) -> List[str]:
        if not byte_sig.startswith("0x"):
            byte_sig = "0x" + byte_sig
        return list(self._mem.get(byte_sig, []))

    __getitem__ = get
