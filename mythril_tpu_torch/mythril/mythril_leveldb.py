"""LevelDB search facade (own copy of
``mythril_tpu/mythril/mythril_leveldb.py``; reference:
mythril/mythril/mythril_leveldb.py).

Wraps EthLevelDB for the two CLI operations: code search and
code-hash→address lookup.
"""

import re

from mythril_tpu_torch.exceptions import CriticalError


class MythrilLevelDB:
    def __init__(self, leveldb):
        self.leveldb = leveldb

    def search_db(self, search: str) -> None:
        """Print address + balance of every contract matching the
        search expression (code~/func# DSL, see EVMContract)."""

        def search_callback(_, address, balance):
            print(f"Address: {address}, balance: {balance}")

        try:
            self.leveldb.search(search, search_callback)
        except SyntaxError:
            raise CriticalError("Syntax error in search expression.")

    def contract_hash_to_address(self, contract_hash: str) -> None:
        """Print the address holding code whose keccak256 matches."""
        if not re.fullmatch(r"0x[a-fA-F0-9]{64}", contract_hash):
            raise CriticalError(
                "Invalid address hash. Expected format is '0x...'."
            )
        print(
            self.leveldb.contract_hash_to_address(
                bytes.fromhex(contract_hash[2:])
            )
        )
