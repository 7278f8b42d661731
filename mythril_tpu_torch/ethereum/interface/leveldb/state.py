"""World-state access over a geth database: accounts + storage through
the state trie.

Reference counterpart: reference state.py (Account/State over the
external ``ethereum.trie``); same API shape, in-repo trie.

Own copy of the JAX package's ``mythril_tpu/ethereum/interface/leveldb/state.py``.
"""

from typing import Dict, Iterator, Optional

from mythril_tpu_torch.ethereum.interface.leveldb.trie import TrieReader
from mythril_tpu_torch.support import rlp
from mythril_tpu_torch.support.crypto import keccak256

BLANK_CODE_HASH = keccak256(b"")


class Account:
    """Decoded state-trie account: [nonce, balance, storage_root,
    code_hash]."""

    def __init__(
        self, nonce: int, balance: int, storage_root: bytes,
        code_hash: bytes, db, address: Optional[bytes] = None,
    ):
        self.nonce = nonce
        self.balance = balance
        self.storage_root = storage_root
        self.code_hash = code_hash
        self.db = db
        self.address = address
        self.storage_cache: Dict[int, int] = {}

    @classmethod
    def from_rlp(cls, data: bytes, db, address=None) -> "Account":
        nonce, balance, storage_root, code_hash = rlp.decode(data)
        return cls(
            rlp.decode_int(nonce), rlp.decode_int(balance),
            bytes(storage_root), bytes(code_hash), db, address,
        )

    @classmethod
    def blank_account(cls, db, address, initial_nonce: int = 0) -> "Account":
        from mythril_tpu_torch.ethereum.interface.leveldb.trie import EMPTY_ROOT

        return cls(initial_nonce, 0, EMPTY_ROOT, BLANK_CODE_HASH, db, address)

    @property
    def code(self) -> bytes:
        if self.code_hash == BLANK_CODE_HASH:
            return b""
        return self.db.get(self.code_hash) or b""

    def get_storage_data(self, key: int) -> int:
        if key in self.storage_cache:
            return self.storage_cache[key]
        trie = TrieReader(self.db, self.storage_root, secure=True)
        raw = trie.get(key.to_bytes(32, "big"))
        value = rlp.decode_int(rlp.decode(raw)) if raw else 0
        self.storage_cache[key] = value
        return value

    @property
    def is_blank(self) -> bool:
        return (
            self.nonce == 0
            and self.balance == 0
            and self.code_hash == BLANK_CODE_HASH
        )


class State:
    """The world state at a given root."""

    def __init__(self, db, root: bytes):
        self.db = db
        self.trie = TrieReader(db, root, secure=True)
        self.secure_account_cache: Dict[bytes, Account] = {}

    def get_and_cache_account(self, address: bytes) -> Account:
        """Account by 20-byte address (keyed keccak(address) in the
        secure trie)."""
        hashed = keccak256(address)
        cached = self.secure_account_cache.get(hashed)
        if cached is not None:
            return cached
        raw = self.trie.get(address)
        if raw is None:
            account = Account.blank_account(self.db, address)
        else:
            account = Account.from_rlp(raw, self.db, address)
        self.secure_account_cache[hashed] = account
        return account

    def get_all_accounts(self) -> Iterator[Account]:
        """Every account in the trie.  Addresses are unknown here
        (secure trie stores hashes); the caller resolves them through
        the hash→address index when needed."""
        for _, value in self.trie.items():
            yield Account.from_rlp(value, self.db)
