"""Read-only LevelDB storage-format implementation (plus a minimal
writer used by test fixtures).

The reference reads geth chain databases through the native ``plyvel``
binding (reference mythril/ethereum/interface/leveldb/eth_db.py:1-24).
This environment ships no native LevelDB, so the on-disk format is
implemented here directly:

- CURRENT -> MANIFEST-NNNNNN (VersionEdit records in log format) gives
  the live table files and the active write-ahead log number;
- .log write-ahead files replay into a memtable (latest sequence wins);
- .ldb/.sst table files: block-based, shared-prefix key compression
  with restart points, optional snappy blocks, index block + fixed
  48-byte footer with the LevelDB magic;
- keys inside tables/memtable are *internal keys*:
  user_key . uint64le(sequence << 8 | type).

Lookup precedence is memtable, then level-0 files newest-first, then
higher levels by key range — the same shadowing rule the native
implementation applies.

Own copy of the JAX package's ``mythril_tpu/ethereum/interface/leveldb/storage.py``.
"""

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

from mythril_tpu_torch.ethereum.interface.leveldb import snappy

MAGIC = 0xDB4775248B80FB57
BLOCK_SIZE = 32768  # log-format block size
TYPE_DELETION = 0
TYPE_VALUE = 1
MAX_SEQUENCE = (1 << 56) - 1


class CorruptionError(ValueError):
    pass


# ---------------------------------------------------------------------------
# crc32c (Castagnoli), with LevelDB's mask
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_crc_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_crc_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - 0xA282EAD8) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


def put_uvarint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def get_uvarint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if pos >= len(data):
            raise CorruptionError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise CorruptionError("varint too long")


def internal_key(user_key: bytes, sequence: int, kind: int) -> bytes:
    return user_key + struct.pack("<Q", (sequence << 8) | kind)


def parse_internal_key(ikey: bytes) -> Tuple[bytes, int, int]:
    if len(ikey) < 8:
        raise CorruptionError("internal key too short")
    trailer = struct.unpack("<Q", ikey[-8:])[0]
    return ikey[:-8], trailer >> 8, trailer & 0xFF


# ---------------------------------------------------------------------------
# log format (WAL + MANIFEST records)
# ---------------------------------------------------------------------------

_FULL, _FIRST, _MIDDLE, _LAST = 1, 2, 3, 4


def read_log_records(data: bytes) -> Iterator[bytes]:
    """Yield complete records, reassembling fragments across blocks."""
    pos = 0
    pending = b""
    n = len(data)
    while pos < n:
        block_left = BLOCK_SIZE - (pos % BLOCK_SIZE)
        if block_left < 7:  # trailer padding
            pos += block_left
            continue
        if pos + 7 > n:
            break
        crc, length, rtype = struct.unpack_from("<IHB", data, pos)
        if rtype == 0 and length == 0 and crc == 0:
            break  # preallocated zero region
        payload = data[pos + 7 : pos + 7 + length]
        if len(payload) < length:
            raise CorruptionError("truncated log record")
        expect = mask_crc(crc32c(bytes([rtype]) + payload))
        if crc != expect:
            raise CorruptionError("log record crc mismatch")
        pos += 7 + length
        if rtype == _FULL:
            pending = b""
            yield payload
        elif rtype == _FIRST:
            pending = payload
        elif rtype == _MIDDLE:
            pending += payload
        elif rtype == _LAST:
            yield pending + payload
            pending = b""
        else:
            raise CorruptionError(f"bad log record type {rtype}")


def write_log_records(records: List[bytes]) -> bytes:
    """Serialize records into log format (fragmenting across blocks)."""
    out = bytearray()
    for record in records:
        first = True
        remaining = record
        while True:
            block_left = BLOCK_SIZE - (len(out) % BLOCK_SIZE)
            if block_left < 7:
                out += b"\x00" * block_left
                block_left = BLOCK_SIZE
            avail = block_left - 7
            frag = remaining[:avail]
            remaining = remaining[avail:]
            if first and not remaining:
                rtype = _FULL
            elif first:
                rtype = _FIRST
            elif remaining:
                rtype = _MIDDLE
            else:
                rtype = _LAST
            crc = mask_crc(crc32c(bytes([rtype]) + frag))
            out += struct.pack("<IHB", crc, len(frag), rtype)
            out += frag
            first = False
            if not remaining:
                break
    return bytes(out)


def parse_write_batch(record: bytes) -> Iterator[Tuple[int, int, bytes, bytes]]:
    """Yield (sequence, kind, key, value) from a WriteBatch record."""
    if len(record) < 12:
        raise CorruptionError("short write batch")
    sequence = struct.unpack_from("<Q", record, 0)[0]
    count = struct.unpack_from("<I", record, 8)[0]
    pos = 12
    for i in range(count):
        kind = record[pos]
        pos += 1
        klen, pos = get_uvarint(record, pos)
        key = record[pos : pos + klen]
        pos += klen
        value = b""
        if kind == TYPE_VALUE:
            vlen, pos = get_uvarint(record, pos)
            value = record[pos : pos + vlen]
            pos += vlen
        elif kind != TYPE_DELETION:
            raise CorruptionError(f"bad batch entry kind {kind}")
        yield sequence + i, kind, key, value


def build_write_batch(
    sequence: int, ops: List[Tuple[int, bytes, bytes]]
) -> bytes:
    out = bytearray(struct.pack("<QI", sequence, len(ops)))
    for kind, key, value in ops:
        out.append(kind)
        out += put_uvarint(len(key)) + key
        if kind == TYPE_VALUE:
            out += put_uvarint(len(value)) + value
    return bytes(out)


# ---------------------------------------------------------------------------
# table (SST) format
# ---------------------------------------------------------------------------


def _decode_block(block: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode a data/index block into (key, value) pairs."""
    if len(block) < 4:
        raise CorruptionError("short block")
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    if data_end < 0:
        raise CorruptionError("bad restart array")
    entries = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = get_uvarint(block, pos)
        non_shared, pos = get_uvarint(block, pos)
        value_len, pos = get_uvarint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _encode_block(
    entries: List[Tuple[bytes, bytes]], restart_interval: int = 16
) -> bytes:
    out = bytearray()
    restarts = []
    prev = b""
    for i, (key, value) in enumerate(entries):
        if i % restart_interval == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            limit = min(len(prev), len(key))
            while shared < limit and prev[shared] == key[shared]:
                shared += 1
        out += put_uvarint(shared)
        out += put_uvarint(len(key) - shared)
        out += put_uvarint(len(value))
        out += key[shared:]
        out += value
        prev = key
    if not restarts:
        restarts.append(0)
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


class BlockHandle:
    def __init__(self, offset: int, size: int):
        self.offset = offset
        self.size = size

    def encode(self) -> bytes:
        return put_uvarint(self.offset) + put_uvarint(self.size)

    @classmethod
    def decode(cls, data: bytes, pos: int = 0) -> Tuple["BlockHandle", int]:
        offset, pos = get_uvarint(data, pos)
        size, pos = get_uvarint(data, pos)
        return cls(offset, size), pos


class Table:
    """A single sorted table file, lazily decoded."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 48:
            raise CorruptionError("table too small")
        footer = data[-48:]
        magic = struct.unpack("<Q", footer[40:48])[0]
        if magic != MAGIC:
            raise CorruptionError("bad table magic")
        _, pos = BlockHandle.decode(footer, 0)  # metaindex (unused)
        index_handle, _ = BlockHandle.decode(footer, pos)
        self.index = _decode_block(self._read_block(index_handle))

    def _read_block(self, handle: BlockHandle) -> bytes:
        raw = self.data[handle.offset : handle.offset + handle.size]
        if len(raw) < handle.size:
            raise CorruptionError("truncated block")
        trailer = self.data[
            handle.offset + handle.size : handle.offset + handle.size + 5
        ]
        if len(trailer) == 5:
            compression = trailer[0]
            crc = struct.unpack("<I", trailer[1:5])[0]
            if crc != mask_crc(crc32c(raw + trailer[:1])):
                raise CorruptionError("block crc mismatch")
        else:
            compression = 0
        if compression == 1:
            return snappy.decompress(raw)
        if compression != 0:
            raise CorruptionError(f"unknown compression {compression}")
        return raw

    def entries(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (internal_key, value) pairs in order."""
        for _, handle_bytes in self.index:
            handle, _ = BlockHandle.decode(handle_bytes)
            yield from _decode_block(self._read_block(handle))

    def get(self, user_key: bytes) -> Optional[Tuple[int, int, bytes]]:
        """Newest (sequence, kind, value) for user_key, if present.

        The search target carries an all-zero trailer: bytewise it
        sorts <= every internal key with this user key under both the
        bytewise and the seq-descending internal comparator, so the
        index binary search lands on the first block that can contain
        the key.  (A same-key run spanning a block boundary could hide
        a newer sequence in the next block — irrelevant for chain
        databases, where user keys are unique.)
        """
        target = user_key + b"\x00" * 8
        # binary search the index: first block whose last key >= target
        lo, hi = 0, len(self.index) - 1
        pos = len(self.index)
        while lo <= hi:
            mid = (lo + hi) // 2
            if self.index[mid][0] >= target:
                pos = mid
                hi = mid - 1
            else:
                lo = mid + 1
        if pos == len(self.index):
            return None
        handle, _ = BlockHandle.decode(self.index[pos][1])
        best = None
        for ikey, value in _decode_block(self._read_block(handle)):
            ukey, seq, kind = parse_internal_key(ikey)
            if ukey == user_key:
                if best is None or seq > best[0]:
                    best = (seq, kind, value)
            elif ukey > user_key:
                break
        return best


class TableBuilder:
    """Writes a table file (no filter block; metaindex left empty)."""

    def __init__(self, block_size: int = 4096, compress: bool = True):
        self.block_size = block_size
        self.compress = compress
        self.out = bytearray()
        self.index_entries: List[Tuple[bytes, bytes]] = []
        self.pending: List[Tuple[bytes, bytes]] = []
        self.pending_bytes = 0

    def add(self, ikey: bytes, value: bytes) -> None:
        self.pending.append((ikey, value))
        self.pending_bytes += len(ikey) + len(value)
        if self.pending_bytes >= self.block_size:
            self._flush_block()

    def _write_block(self, content: bytes) -> BlockHandle:
        compression = 0
        if self.compress:
            packed = snappy.compress(content)
            if len(packed) < len(content):
                content, compression = packed, 1
        handle = BlockHandle(len(self.out), len(content))
        trailer_type = bytes([compression])
        crc = mask_crc(crc32c(content + trailer_type))
        self.out += content
        self.out += trailer_type + struct.pack("<I", crc)
        return handle

    def _flush_block(self) -> None:
        if not self.pending:
            return
        handle = self._write_block(_encode_block(self.pending))
        last_key = self.pending[-1][0]
        self.index_entries.append((last_key, handle.encode()))
        self.pending = []
        self.pending_bytes = 0

    def finish(self) -> bytes:
        self._flush_block()
        meta_handle = self._write_block(_encode_block([]))
        index_handle = self._write_block(_encode_block(self.index_entries))
        footer = meta_handle.encode() + index_handle.encode()
        footer += b"\x00" * (40 - len(footer))
        footer += struct.pack("<Q", MAGIC)
        self.out += footer
        return bytes(self.out)


# ---------------------------------------------------------------------------
# MANIFEST (VersionEdit)
# ---------------------------------------------------------------------------

_TAG_COMPARATOR = 1
_TAG_LOG_NUMBER = 2
_TAG_NEXT_FILE = 3
_TAG_LAST_SEQUENCE = 4
_TAG_COMPACT_POINTER = 5
_TAG_DELETED_FILE = 6
_TAG_NEW_FILE = 7
_TAG_PREV_LOG_NUMBER = 9


class VersionState:
    """Accumulated result of replaying a MANIFEST."""

    def __init__(self):
        self.comparator = None
        self.log_number = 0
        self.last_sequence = 0
        self.files: Dict[int, Dict[int, Tuple[int, bytes, bytes]]] = {}
        # level -> {file_number: (size, smallest_ikey, largest_ikey)}

    def apply_edit(self, record: bytes) -> None:
        pos = 0
        n = len(record)
        while pos < n:
            tag, pos = get_uvarint(record, pos)
            if tag == _TAG_COMPARATOR:
                length, pos = get_uvarint(record, pos)
                self.comparator = record[pos : pos + length].decode()
                pos += length
            elif tag in (_TAG_LOG_NUMBER, _TAG_PREV_LOG_NUMBER):
                value, pos = get_uvarint(record, pos)
                if tag == _TAG_LOG_NUMBER:
                    self.log_number = value
            elif tag == _TAG_NEXT_FILE:
                _, pos = get_uvarint(record, pos)
            elif tag == _TAG_LAST_SEQUENCE:
                self.last_sequence, pos = get_uvarint(record, pos)
            elif tag == _TAG_COMPACT_POINTER:
                _, pos = get_uvarint(record, pos)  # level
                length, pos = get_uvarint(record, pos)
                pos += length
            elif tag == _TAG_DELETED_FILE:
                level, pos = get_uvarint(record, pos)
                number, pos = get_uvarint(record, pos)
                self.files.get(level, {}).pop(number, None)
            elif tag == _TAG_NEW_FILE:
                level, pos = get_uvarint(record, pos)
                number, pos = get_uvarint(record, pos)
                size, pos = get_uvarint(record, pos)
                length, pos = get_uvarint(record, pos)
                smallest = record[pos : pos + length]
                pos += length
                length, pos = get_uvarint(record, pos)
                largest = record[pos : pos + length]
                pos += length
                self.files.setdefault(level, {})[number] = (
                    size, smallest, largest,
                )
            else:
                raise CorruptionError(f"unknown VersionEdit tag {tag}")


def encode_version_edit(
    comparator: Optional[str] = None,
    log_number: Optional[int] = None,
    next_file: Optional[int] = None,
    last_sequence: Optional[int] = None,
    new_files: Optional[List[Tuple[int, int, int, bytes, bytes]]] = None,
) -> bytes:
    out = bytearray()
    if comparator is not None:
        encoded = comparator.encode()
        out += put_uvarint(_TAG_COMPARATOR)
        out += put_uvarint(len(encoded)) + encoded
    if log_number is not None:
        out += put_uvarint(_TAG_LOG_NUMBER) + put_uvarint(log_number)
    if next_file is not None:
        out += put_uvarint(_TAG_NEXT_FILE) + put_uvarint(next_file)
    if last_sequence is not None:
        out += put_uvarint(_TAG_LAST_SEQUENCE) + put_uvarint(last_sequence)
    for level, number, size, smallest, largest in new_files or []:
        out += put_uvarint(_TAG_NEW_FILE)
        out += put_uvarint(level) + put_uvarint(number) + put_uvarint(size)
        out += put_uvarint(len(smallest)) + smallest
        out += put_uvarint(len(largest)) + largest
    return bytes(out)


# ---------------------------------------------------------------------------
# the database
# ---------------------------------------------------------------------------


class LevelDB:
    """Read-only LevelDB opened from a directory."""

    def __init__(self, path: str):
        self.path = path
        current = os.path.join(path, "CURRENT")
        if not os.path.exists(current):
            raise CorruptionError(f"no CURRENT file in {path}")
        with open(current, "rb") as f:
            manifest_name = f.read().decode().strip()
        manifest_path = os.path.join(path, manifest_name)
        self.version = VersionState()
        with open(manifest_path, "rb") as f:
            for record in read_log_records(f.read()):
                self.version.apply_edit(record)

        # replay live write-ahead logs into the memtable
        self.memtable: Dict[bytes, Tuple[int, int, bytes]] = {}
        for name in sorted(os.listdir(path)):
            if not name.endswith(".log"):
                continue
            number = int(name.split(".")[0])
            if number < self.version.log_number:
                continue  # already compacted into tables
            with open(os.path.join(path, name), "rb") as f:
                for record in read_log_records(f.read()):
                    for seq, kind, key, value in parse_write_batch(record):
                        prior = self.memtable.get(key)
                        if prior is None or seq >= prior[0]:
                            self.memtable[key] = (seq, kind, value)

        self._tables: Dict[int, Table] = {}

    def _table(self, number: int) -> Table:
        table = self._tables.get(number)
        if table is None:
            for ext in (".ldb", ".sst"):
                file_path = os.path.join(self.path, f"{number:06d}{ext}")
                if os.path.exists(file_path):
                    with open(file_path, "rb") as f:
                        table = Table(f.read())
                    break
            if table is None:
                raise CorruptionError(f"missing table file {number}")
            self._tables[number] = table
        return table

    def get(self, key: bytes) -> Optional[bytes]:
        entry = self.memtable.get(key)
        if entry is not None:
            _, kind, value = entry
            return value if kind == TYPE_VALUE else None
        # level 0: newest file first (files may overlap)
        for number in sorted(
            self.version.files.get(0, {}).keys(), reverse=True
        ):
            found = self._table(number).get(key)
            if found is not None:
                _, kind, value = found
                return value if kind == TYPE_VALUE else None
        for level in sorted(k for k in self.version.files if k > 0):
            for number, (_, smallest, largest) in sorted(
                self.version.files[level].items()
            ):
                if smallest[:-8] <= key <= largest[:-8]:
                    found = self._table(number).get(key)
                    if found is not None:
                        _, kind, value = found
                        return value if kind == TYPE_VALUE else None
        return None

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """Merged live view (memtable shadows tables; newest file wins)."""
        merged: Dict[bytes, Tuple[int, int, bytes]] = {}
        for level, files in self.version.files.items():
            for number in sorted(files):
                for ikey, value in self._table(number).entries():
                    ukey, seq, kind = parse_internal_key(ikey)
                    prior = merged.get(ukey)
                    if prior is None or seq >= prior[0]:
                        merged[ukey] = (seq, kind, value)
        merged.update(self.memtable)
        for key in sorted(merged):
            seq, kind, value = merged[key]
            if kind == TYPE_VALUE:
                yield key, value


def write_fixture_db(
    path: str, records: Dict[bytes, bytes], via_log: bool = False
) -> None:
    """Write a minimal valid LevelDB directory holding ``records``.

    ``via_log=True`` leaves everything in the write-ahead log (tests the
    memtable replay path); otherwise one level-0 table file is built
    (tests the table search path).  Fixture/test support — a real
    application never writes through this.
    """
    os.makedirs(path, exist_ok=True)
    if via_log:
        ops = [(TYPE_VALUE, k, v) for k, v in sorted(records.items())]
        log_data = write_log_records([build_write_batch(1, ops)])
        with open(os.path.join(path, "000003.log"), "wb") as f:
            f.write(log_data)
        edit = encode_version_edit(
            comparator="leveldb.BytewiseComparator",
            log_number=3,
            next_file=4,
            last_sequence=len(records) + 1,
        )
    else:
        builder = TableBuilder()
        items = sorted(records.items())
        for seq, (key, value) in enumerate(items, start=1):
            builder.add(internal_key(key, seq, TYPE_VALUE), value)
        table_data = builder.finish()
        with open(os.path.join(path, "000005.ldb"), "wb") as f:
            f.write(table_data)
        smallest = internal_key(items[0][0], 1, TYPE_VALUE)
        largest = internal_key(items[-1][0], len(items), TYPE_VALUE)
        edit = encode_version_edit(
            comparator="leveldb.BytewiseComparator",
            log_number=6,
            next_file=7,
            last_sequence=len(records) + 1,
            new_files=[(0, 5, len(table_data), smallest, largest)],
        )
        with open(os.path.join(path, "000006.log"), "wb") as f:
            f.write(b"")
    with open(os.path.join(path, "MANIFEST-000002"), "wb") as f:
        f.write(write_log_records([edit]))
    with open(os.path.join(path, "CURRENT"), "wb") as f:
        f.write(b"MANIFEST-000002\n")
