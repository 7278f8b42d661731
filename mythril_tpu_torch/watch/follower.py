"""Reorg-tolerant head cursor over a JSON-RPC provider (pool); own copy
of ``mythril_tpu/watch/follower.py``.

The follower owns three pieces of state and one invariant:

- **cursor** — the last block height fully handed to the dispatcher;
- **hash window** — the block hashes of the most recent
  :data:`HASH_WINDOW` processed heights, the chain-link evidence a
  parent check is made against;
- **journal** — an fsynced JSONL file (the checkpoint journal's idiom: one
  ``sort_keys`` row per event, flushed and fsynced before the cursor
  moves), so a SIGKILL at any byte loses at most the block being
  processed — never a processed one, never a pending submission.

The invariant: the cursor only advances over a hash-linked chain.
When the next block's ``parentHash`` does not match the recorded hash
at the cursor, the node reorged underneath us — the follower walks the
cursor DOWN until the recorded hash matches the now-canonical block,
journals the rewind, and re-follows from there.  Digests seen on the
orphaned blocks stay in the seen-set, so re-processing the replacement
blocks never double-submits (the exactly-once contract).

Confirmation lag (``MYTHRIL_TPU_WATCH_CONFIRMATIONS``) trades reorg
frequency against latency: the follower never processes heights above
``head - confirmations``, so a depth-N reorg with confirmations >= N
is invisible to it.

Journal rows::

    {"block": 7, "hash": "0x…", "digests": ["…"]}   processed block
    {"reorg": 4, "at": 7}                           rewind 7 -> 4
    {"pending": {…}}  /  {"done": "…digest…"}       dispatcher rows
                                                    (stream.py writes
                                                    these through
                                                    :meth:`append`)
"""

import json
import logging
import os
from typing import Dict, List, Optional, Set

log = logging.getLogger(__name__)

#: processed-block hashes kept for the parent check — a reorg deeper
#: than this window rewinds to the window floor (and a real chain
#: reorganizing >128 blocks has bigger problems than this follower)
HASH_WINDOW = 128


class CursorJournal:
    """Append-only fsynced JSONL journal + its replay."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def open(self) -> "CursorJournal":
        parent = os.path.dirname(os.path.abspath(self.path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        return self

    def append(self, row: dict) -> None:
        assert self._fh is not None, "journal not open"
        self._fh.write(json.dumps(row, sort_keys=True) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def replay(self):
        """Yield every intact row in order; a torn tail (the row being
        written when the process died) is skipped, not fatal."""
        if not os.path.exists(self.path):
            return
        with open(self.path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue


class ChainFollower:
    """The hash-linked cursor.  Drive it with :meth:`next_block` /
    :meth:`mark_processed`; everything else is bookkeeping."""

    def __init__(self, client, confirmations: int = 0,
                 journal: Optional[CursorJournal] = None,
                 from_block: int = 0, resume: bool = False):
        self.client = client
        self.confirmations = max(0, confirmations)
        self.journal = journal
        self.from_block = max(0, from_block)
        self.cursor = self.from_block - 1
        self.hashes: Dict[int, str] = {}
        self.seen_digests: Set[str] = set()
        self.pending_rows: List[dict] = []
        self.reorgs = 0
        self.head = -1
        if resume and journal is not None:
            self._replay()

    # -- resume ----------------------------------------------------------

    def _replay(self) -> None:
        done: Set[str] = set()
        pending: Dict[str, dict] = {}
        for row in self.journal.replay():
            if "block" in row:
                height = int(row["block"])
                self.cursor = height
                self.hashes[height] = row.get("hash", "")
                self.seen_digests.update(row.get("digests") or ())
            elif "reorg" in row:
                rewind_to = int(row["reorg"])
                self.cursor = rewind_to
                for h in [h for h in self.hashes if h > rewind_to]:
                    del self.hashes[h]
            elif "pending" in row:
                item = row["pending"]
                pending[item.get("digest", "")] = item
            elif "done" in row:
                pending.pop(row["done"], None)
                done.add(row["done"])
        self._prune()
        # a pending submission whose completion never journaled is
        # restored for the dispatcher — its digest is already in the
        # seen-set (its block row carried it), so nothing re-extracts
        # it, and restoring it here is what keeps it from being LOST
        self.pending_rows = [
            item for digest, item in sorted(pending.items())
            if digest not in done
        ]
        log.info(
            "watch: resumed at cursor %d (%d seen digests, %d pending "
            "submissions, %d hashes in window)",
            self.cursor, len(self.seen_digests),
            len(self.pending_rows), len(self.hashes),
        )

    # -- following -------------------------------------------------------

    def poll_head(self) -> int:
        """One ``eth_blockNumber`` round trip; remembers the answer so
        lag is computable without another call."""
        self.head = self.client.eth_blockNumber()
        return self.head

    def lag_blocks(self) -> int:
        return max(0, self.head - self.cursor) if self.head >= 0 else 0

    def next_block(self) -> Optional[dict]:
        """The next confirmed block to process, or None when caught
        up (or the node does not know the height yet).  Detects and
        performs the reorg rewind as a side effect."""
        target = self.head - self.confirmations
        if self.cursor >= target:
            return None
        block = self.client.eth_getBlockByNumber(self.cursor + 1,
                                                 False)
        if block is None:
            return None
        recorded = self.hashes.get(self.cursor)
        if recorded is not None and block["parentHash"] != recorded:
            self._rewind()
            return None  # caller re-polls; the cursor moved down
        return block

    def _rewind(self) -> None:
        """The recorded chain and the node's canonical chain diverged:
        walk down until the recorded hash matches the canonical block
        at that height, journal the rewind, drop orphaned hashes."""
        old_cursor = self.cursor
        floor = min(self.hashes) if self.hashes else self.from_block
        rewind_to = floor - 1
        for height in range(self.cursor, floor - 1, -1):
            canonical = self.client.eth_getBlockByNumber(height, False)
            if canonical is not None and \
                    canonical["hash"] == self.hashes.get(height):
                rewind_to = height
                break
        self.cursor = max(rewind_to, self.from_block - 1)
        for height in [h for h in self.hashes if h > self.cursor]:
            del self.hashes[height]
        self.reorgs += 1
        if self.journal is not None:
            self.journal.append({"reorg": self.cursor, "at": old_cursor})
        log.warning("watch: reorg detected — cursor rewound %d -> %d",
                    old_cursor, self.cursor)

    def mark_processed(self, block: dict, digests) -> None:
        """Advance the cursor over one fully-dispatched block.  The
        journal row lands (fsynced) BEFORE the cursor moves: a kill
        between the two re-processes the block, which the seen-set and
        the serve report cache absorb — the safe direction."""
        height = int(block["number"], 16)
        digests = sorted(set(digests))
        if self.journal is not None:
            self.journal.append({
                "block": height, "hash": block["hash"],
                "digests": digests,
            })
        self.cursor = height
        self.hashes[height] = block["hash"]
        self.seen_digests.update(digests)
        self._prune()

    def _prune(self) -> None:
        while len(self.hashes) > HASH_WINDOW:
            del self.hashes[min(self.hashes)]
