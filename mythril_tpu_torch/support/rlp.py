"""Minimal RLP (Recursive Length Prefix) codec (own copy of
``mythril_tpu/support/rlp.py``).

Ethereum's wire/storage serialization, needed by the LevelDB chain
reader (block headers, bodies, receipts, trie nodes, accounts).  The
reference pulled in the external ``rlp`` package
(reference setup.py:24); this framework is self-contained.

Items are ``bytes`` or (recursively) lists of items.  Integers are
encoded big-endian with no leading zeros (the Ethereum convention).
"""

from typing import List, Tuple, Union

Item = Union[bytes, List["Item"]]


class RLPError(ValueError):
    pass


def encode_int(value: int) -> bytes:
    if value == 0:
        return b""
    return value.to_bytes((value.bit_length() + 7) // 8, "big")


def decode_int(data: bytes) -> int:
    return int.from_bytes(data, "big") if data else 0


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    blen = encode_int(length)
    return bytes([offset + 55 + len(blen)]) + blen


def encode(item: Item) -> bytes:
    if isinstance(item, int):
        item = encode_int(item)
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _encode_length(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(sub) for sub in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise RLPError(f"cannot RLP-encode {type(item)}")


def _decode_at(data: bytes, pos: int) -> Tuple[Item, int]:
    if pos >= len(data):
        raise RLPError("truncated RLP")
    prefix = data[pos]
    if prefix < 0x80:  # single byte
        return data[pos : pos + 1], pos + 1
    if prefix < 0xB8:  # short string
        length = prefix - 0x80
        end = pos + 1 + length
        if end > len(data):
            raise RLPError("truncated string")
        if length == 1 and data[pos + 1] < 0x80:
            raise RLPError("non-canonical single byte")
        return data[pos + 1 : end], end
    if prefix < 0xC0:  # long string
        lenlen = prefix - 0xB7
        length = decode_int(data[pos + 1 : pos + 1 + lenlen])
        if length < 56:
            raise RLPError("non-canonical length")
        start = pos + 1 + lenlen
        end = start + length
        if end > len(data):
            raise RLPError("truncated string")
        return data[start:end], end
    # lists
    if prefix < 0xF8:
        length = prefix - 0xC0
        start = pos + 1
    else:
        lenlen = prefix - 0xF7
        length = decode_int(data[pos + 1 : pos + 1 + lenlen])
        if length < 56:
            raise RLPError("non-canonical list length")
        start = pos + 1 + lenlen
    end = start + length
    if end > len(data):
        raise RLPError("truncated list")
    items: List[Item] = []
    cursor = start
    while cursor < end:
        sub, cursor = _decode_at(data, cursor)
        items.append(sub)
    if cursor != end:
        raise RLPError("list payload overrun")
    return items, end


def decode(data: bytes) -> Item:
    item, end = _decode_at(bytes(data), 0)
    if end != len(data):
        raise RLPError("trailing bytes after RLP item")
    return item
