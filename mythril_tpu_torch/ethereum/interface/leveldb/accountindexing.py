"""Hash→address index over a geth database.

The state trie keys accounts by keccak(address), so enumerating
contracts yields hashes with no addresses.  Like the reference
(reference accountindexing.py:69-150), this walks block bodies and
receipts to recover address preimages and stores the mapping under a
custom prefix; unlike the reference it writes to the non-destructive
overlay (see eth_db.py) instead of into the chain database.

Own copy of the JAX package's ``mythril_tpu/ethereum/interface/leveldb/accountindexing.py``.
"""

import logging
from typing import Optional

from mythril_tpu_torch.support import rlp
from mythril_tpu_torch.support.crypto import keccak256

log = logging.getLogger(__name__)

ADDRESS_PREFIX = b"AM"                    # AM + hash -> address
ADDRESS_MAPPING_HEAD = b"accountMapping"  # last indexed block number
BATCH_SIZE = 8 * 4096


class AccountIndexer:
    def __init__(self, eth_db):
        self.db = eth_db
        self.lastBlock: Optional[int] = None
        self.lastProcessedBlock: Optional[int] = None
        self.updateIfNeeded()

    def get_contract_by_hash(self, contract_hash: bytes) -> Optional[bytes]:
        return self.db.reader._get_address_by_hash(contract_hash)

    def _process(self, startblock: int) -> None:
        """Index a batch of blocks: every address seen in transactions
        (sender is unrecoverable without signature handling, but `to`
        and created-contract addresses cover contract accounts)."""
        for number in range(
            startblock, min(startblock + BATCH_SIZE, self.lastBlock + 1)
        ):
            block_hash = self.db.reader._get_block_hash(number)
            if block_hash is None:
                continue
            for address in self._addresses_in_block(block_hash, number):
                self.db.writer._store_account_address(address)
        self.db.writer._set_last_indexed_number(
            min(startblock + BATCH_SIZE - 1, self.lastBlock)
        )

    def _addresses_in_block(self, block_hash: bytes, number: int):
        addresses = set()
        body = self.db.reader._get_block_body(block_hash, number)
        if body is not None:
            transactions = body[0] if body else []
            for tx in transactions:
                if isinstance(tx, list) and len(tx) >= 6:
                    to = bytes(tx[3])
                    if len(to) == 20:
                        addresses.add(to)
        receipts = self.db.reader._get_block_receipts(block_hash, number)
        for receipt in receipts or []:
            if isinstance(receipt, list) and len(receipt) >= 5:
                contract_address = bytes(receipt[4])
                if len(contract_address) == 20:
                    addresses.add(contract_address)
        return addresses

    def updateIfNeeded(self) -> None:
        """Catch the index up to the current chain head."""
        head_block = self.db.reader._get_head_block()
        if head_block is None:
            return
        self.lastBlock = rlp.decode_int(head_block.number)
        self.lastProcessedBlock = self.db.reader._get_last_indexed_number()
        start = 0
        if self.lastProcessedBlock is not None:
            if self.lastBlock == self.lastProcessedBlock:
                return
            start = self.lastProcessedBlock + 1
            log.info(
                "Updating hash-to-address index from block %d", start
            )
        else:
            log.info("Starting hash-to-address index")
        while start <= self.lastBlock:
            self._process(start)
            start += BATCH_SIZE
        self.db.writer._commit_batch()
        log.info("Finished indexing")
        self.lastProcessedBlock = self.lastBlock
