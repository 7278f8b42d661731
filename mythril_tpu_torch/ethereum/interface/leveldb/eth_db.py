"""Database handle used by the geth chain reader.

Reference counterpart: reference eth_db.py wraps ``plyvel`` with
get/put/write_batch.  Here reads go through the in-repo LevelDB
implementation (storage.py); writes (only the hash→address index uses
them, accountindexing.py) land in an overlay that persists as a
sidecar file in the database directory — the chain database itself is
never mutated.

Own copy of the JAX package's ``mythril_tpu/ethereum/interface/leveldb/eth_db.py``.
"""

import json
import os
from typing import Optional

from mythril_tpu_torch.ethereum.interface.leveldb.storage import LevelDB

#: the JAX package's file name and format: the database is the user's
#: data, and each package reads an index the other wrote
_SIDECAR = "mythril_tpu_index.json"


class ETH_DB:
    def __init__(self, path: str):
        self.path = path
        self.db = LevelDB(path)
        self._overlay = {}
        self._sidecar_path = os.path.join(path, _SIDECAR)
        if os.path.exists(self._sidecar_path):
            with open(self._sidecar_path) as f:
                self._overlay = {
                    bytes.fromhex(k): bytes.fromhex(v)
                    for k, v in json.load(f).items()
                }

    def get(self, key: bytes) -> Optional[bytes]:
        if key in self._overlay:
            return self._overlay[key]
        return self.db.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        self._overlay[key] = value

    def write_batch(self) -> "ETH_DB":
        return self  # overlay writes are already batched in memory

    def commit(self) -> None:
        with open(self._sidecar_path, "w") as f:
            json.dump(
                {k.hex(): v.hex() for k, v in self._overlay.items()}, f
            )
