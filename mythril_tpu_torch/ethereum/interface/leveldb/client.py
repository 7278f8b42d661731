"""geth chain-database client: block headers, bodies, receipts, state,
contract enumeration and search — the offline twin of the RPC client.

Reference counterpart: reference client.py (EthLevelDB over plyvel +
the external ``ethereum`` package).  Key schema (public geth layout):

- ``h`` + num(8BE) + hash -> header RLP
- ``h`` + num(8BE) + ``n`` -> canonical hash
- ``H`` + hash             -> block number (8BE)
- ``b`` + num(8BE) + hash  -> body RLP
- ``r`` + num(8BE) + hash  -> receipts RLP
- ``LastBlock``            -> head block hash
plus the custom index (``AM`` + keccak(address) -> address,
``accountMapping`` -> last indexed number) maintained by
accountindexing.py.

Own copy of the JAX package's ``mythril_tpu/ethereum/interface/leveldb/client.py``.
"""

import logging
import struct
from typing import Callable, Iterator, Optional, Tuple

from mythril_tpu_torch.ethereum.interface.leveldb import accountindexing
from mythril_tpu_torch.ethereum.interface.leveldb.eth_db import ETH_DB
from mythril_tpu_torch.ethereum.interface.leveldb.state import State
from mythril_tpu_torch.support import rlp
from mythril_tpu_torch.support.crypto import keccak256

log = logging.getLogger(__name__)

HEADER_PREFIX = b"h"
BODY_PREFIX = b"b"
NUM_SUFFIX = b"n"
BLOCK_HASH_PREFIX = b"H"
BLOCK_RECEIPTS_PREFIX = b"r"
HEAD_HEADER_KEY = b"LastBlock"


def _format_block_number(number: int) -> bytes:
    return struct.pack(">Q", number)


def _encode_hex(value: bytes) -> str:
    return "0x" + value.hex()


class BlockHeader:
    """Decoded geth block header (the field subset the analyzer uses)."""

    FIELDS = (
        "prevhash", "uncles_hash", "coinbase", "state_root", "tx_list_root",
        "receipts_root", "bloom", "difficulty", "number", "gas_limit",
        "gas_used", "timestamp", "extra_data", "mixhash", "nonce",
    )

    def __init__(self, items):
        for name, value in zip(self.FIELDS, items):
            setattr(self, name, bytes(value))

    @classmethod
    def from_rlp(cls, data: bytes) -> "BlockHeader":
        return cls(rlp.decode(data))

    def to_dict(self) -> dict:
        return {
            name: _encode_hex(getattr(self, name)) for name in self.FIELDS
        }


class LevelDBReader:
    """Low-level read access (schema keys -> decoded values)."""

    def __init__(self, db: ETH_DB):
        self.db = db
        self.head_block_header: Optional[BlockHeader] = None
        self.head_state: Optional[State] = None

    def _get_head_state(self) -> State:
        if self.head_state is None:
            head = self._get_head_block()
            if head is None:
                from mythril_tpu_torch.exceptions import CriticalError

                raise CriticalError(
                    "Database has no head block (LastBlock key) — not a "
                    "geth chain database?"
                )
            self.head_state = State(self.db, head.state_root)
        return self.head_state

    def _get_account(self, address: bytes):
        return self._get_head_state().get_and_cache_account(address)

    def _get_block_hash(self, number: int) -> Optional[bytes]:
        key = HEADER_PREFIX + _format_block_number(number) + NUM_SUFFIX
        return self.db.get(key)

    def _get_head_block(self) -> Optional[BlockHeader]:
        if self.head_block_header is None:
            block_hash = self.db.get(HEAD_HEADER_KEY)
            if block_hash is None:
                return None
            number = self._get_block_number(block_hash)
            header = self._get_block_header(block_hash, number)
            # fast-synced chains may lack early state roots: walk back
            # to the most recent block whose state is present
            while (
                header is not None
                and self.db.get(header.state_root) is None
                and header.prevhash
                and any(header.prevhash)
            ):
                block_hash = header.prevhash
                number = self._get_block_number(block_hash)
                header = self._get_block_header(block_hash, number)
            self.head_block_header = header
        return self.head_block_header

    def _get_block_number(self, block_hash: bytes) -> Optional[bytes]:
        return self.db.get(BLOCK_HASH_PREFIX + block_hash)

    def _get_block_header(
        self, block_hash: bytes, number: bytes
    ) -> Optional[BlockHeader]:
        if number is None:
            return None
        raw = self.db.get(HEADER_PREFIX + number + block_hash)
        return BlockHeader.from_rlp(raw) if raw else None

    def _get_block_body(self, block_hash: bytes, number: int):
        raw = self.db.get(
            BODY_PREFIX + _format_block_number(number) + block_hash
        )
        return rlp.decode(raw) if raw else None

    def _get_block_receipts(self, block_hash: bytes, number: int):
        raw = self.db.get(
            BLOCK_RECEIPTS_PREFIX + _format_block_number(number) + block_hash
        )
        return rlp.decode(raw) if raw else None

    def _get_address_by_hash(self, address_hash: bytes) -> Optional[bytes]:
        return self.db.get(accountindexing.ADDRESS_PREFIX + address_hash)

    def _get_last_indexed_number(self) -> Optional[int]:
        # fixed-width so block 0 round-trips (rlp.encode_int(0) == b"")
        raw = self.db.get(accountindexing.ADDRESS_MAPPING_HEAD)
        return int.from_bytes(raw, "big") if raw is not None else None


class LevelDBWriter:
    """Index writes (overlay only — the chain db is never mutated)."""

    def __init__(self, db: ETH_DB):
        self.db = db

    def _set_last_indexed_number(self, number: int) -> None:
        self.db.put(
            accountindexing.ADDRESS_MAPPING_HEAD,
            number.to_bytes(8, "big"),
        )

    def _start_writing(self):
        return self.db.write_batch()

    def _commit_batch(self) -> None:
        self.db.commit()

    def _store_account_address(self, address: bytes) -> None:
        self.db.put(
            accountindexing.ADDRESS_PREFIX + keccak256(address), address
        )


class EthLevelDB:
    """Top-level geth database access (the object the facade holds)."""

    def __init__(self, path: str):
        self.path = path
        self.db = ETH_DB(path)
        self.reader = LevelDBReader(self.db)
        self.writer = LevelDBWriter(self.db)
        self.accountIndexer = accountindexing.AccountIndexer(self)

    def get_contracts(self) -> Iterator[Tuple[object, bytes, int]]:
        """Yield (EVMContract, address_hash, balance) for every account
        with code."""
        from mythril_tpu_torch.solidity.evmcontract import EVMContract

        state = self.reader._get_head_state()
        for nibbles, value in state.trie.items():
            from mythril_tpu_torch.ethereum.interface.leveldb.state import Account

            account = Account.from_rlp(value, self.db)
            code = account.code
            if not code:
                continue
            address_hash = bytes(
                (nibbles[i] << 4) | nibbles[i + 1]
                for i in range(0, len(nibbles), 2)
            )
            yield (
                EVMContract(code.hex(), enable_online_lookup=False),
                address_hash,
                account.balance,
            )

    def search(
        self, expression: str, callback_func: Callable
    ) -> None:
        """Search all contract bytecode; callback(contract, address,
        balance) per match.  Address resolves through the hash index
        (None when the preimage was never seen on-chain)."""
        count = 0
        for contract, address_hash, balance in self.get_contracts():
            if contract.matches_expression(expression):
                address = self.reader._get_address_by_hash(address_hash)
                callback_func(
                    contract,
                    _encode_hex(address) if address else address_hash.hex(),
                    balance,
                )
            count += 1
            if count % 1000 == 0:
                log.info("searched %d contracts", count)

    def contract_hash_to_address(self, contract_hash: bytes) -> str:
        """Find the address of the contract whose code hashes to
        ``contract_hash`` — compared against the code_hash field each
        trie account already stores (no code fetch or re-hashing)."""
        from mythril_tpu_torch.ethereum.interface.leveldb.state import Account

        state = self.reader._get_head_state()
        for nibbles, value in state.trie.items():
            account = Account.from_rlp(value, self.db)
            if account.code_hash == contract_hash:
                address_hash = bytes(
                    (nibbles[i] << 4) | nibbles[i + 1]
                    for i in range(0, len(nibbles), 2)
                )
                address = self.reader._get_address_by_hash(address_hash)
                return (
                    _encode_hex(address) if address else address_hash.hex()
                )
        return "Not found"

    def eth_getBlockHeaderByNumber(self, number: int) -> Optional[BlockHeader]:
        block_hash = self.reader._get_block_hash(number)
        if block_hash is None:
            return None
        return self.reader._get_block_header(
            block_hash, _format_block_number(number)
        )

    def eth_getBlockByNumber(self, number: int):
        block_hash = self.reader._get_block_hash(number)
        if block_hash is None:
            return None
        header = self.reader._get_block_header(
            block_hash, _format_block_number(number)
        )
        body = self.reader._get_block_body(block_hash, number)
        return {"header": header, "body": body}

    def eth_getCode(self, address: bytes) -> str:
        return _encode_hex(self.reader._get_account(address).code)

    def eth_getBalance(self, address: bytes) -> int:
        return self.reader._get_account(address).balance

    def eth_getStorageAt(self, address: bytes, position: int) -> str:
        value = self.reader._get_account(address).get_storage_data(position)
        return _encode_hex(value.to_bytes(32, "big"))
