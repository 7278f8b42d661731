"""Pure-Python Snappy codec (raw/block format).

LevelDB compresses table blocks with Snappy; geth databases are written
that way, so the chain reader needs a decompressor.  The compressor
(greedy 4-byte hash matching, the reference algorithm's structure) is
used by the test fixture writer and keeps the codec round-trippable.
No external ``python-snappy``/``cramjam`` in this environment.

Format: uvarint uncompressed length, then tagged elements —
tag & 3: 0 literal, 1 copy with 1-byte offset-extension, 2 copy with
2-byte little-endian offset, 3 copy with 4-byte offset.

Own copy of the JAX package's ``mythril_tpu/ethereum/interface/leveldb/snappy.py``.
"""


class SnappyError(ValueError):
    pass


def _read_uvarint(data: bytes, pos: int):
    shift = 0
    result = 0
    while True:
        if pos >= len(data):
            raise SnappyError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise SnappyError("varint too long")


def _write_uvarint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def decompress(data: bytes) -> bytes:
    data = bytes(data)
    expected, pos = _read_uvarint(data, 0)
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > len(data):
                    raise SnappyError("truncated literal length")
                length = (
                    int.from_bytes(data[pos : pos + extra], "little") + 1
                )
                pos += extra
            if pos + length > len(data):
                raise SnappyError("truncated literal")
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 1:
            length = ((tag >> 2) & 0x7) + 4
            if pos >= len(data):
                raise SnappyError("truncated copy1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            length = (tag >> 2) + 1
            if pos + 2 > len(data):
                raise SnappyError("truncated copy2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:
            length = (tag >> 2) + 1
            if pos + 4 > len(data):
                raise SnappyError("truncated copy4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise SnappyError("bad copy offset")
        # overlapping copies are byte-at-a-time by definition
        start = len(out) - offset
        for i in range(length):
            out.append(out[start + i])
    if len(out) != expected:
        raise SnappyError(
            f"length mismatch: got {len(out)}, expected {expected}"
        )
    return bytes(out)


def _emit_literal(out: bytearray, chunk: bytes) -> None:
    n = len(chunk) - 1
    if n < 60:
        out.append(n << 2)
    elif n < (1 << 8):
        out.append(60 << 2)
        out += n.to_bytes(1, "little")
    elif n < (1 << 16):
        out.append(61 << 2)
        out += n.to_bytes(2, "little")
    elif n < (1 << 24):
        out.append(62 << 2)
        out += n.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += n.to_bytes(4, "little")
    out += chunk


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    while length >= 68:
        _emit_copy_upto64(out, offset, 64)
        length -= 64
    if length > 64:
        _emit_copy_upto64(out, offset, 60)
        length -= 60
    _emit_copy_upto64(out, offset, length)


def _emit_copy_upto64(out: bytearray, offset: int, length: int) -> None:
    if 4 <= length <= 11 and offset < 2048:
        out.append(1 | ((length - 4) << 2) | ((offset >> 8) << 5))
        out.append(offset & 0xFF)
    else:
        out.append(2 | ((length - 1) << 2))
        out += offset.to_bytes(2, "little")


def compress(data: bytes) -> bytes:
    data = bytes(data)
    out = bytearray(_write_uvarint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)
    table = {}
    pos = 0
    literal_start = 0
    while pos + 4 <= n:
        key = data[pos : pos + 4]
        candidate = table.get(key)
        table[key] = pos
        if candidate is not None and pos - candidate <= 0xFFFF:
            # extend the match forward
            length = 4
            while (
                pos + length < n
                and data[candidate + length] == data[pos + length]
                and length < 64
            ):
                length += 1
            if literal_start < pos:
                _emit_literal(out, data[literal_start:pos])
            _emit_copy(out, pos - candidate, length)
            pos += length
            literal_start = pos
        else:
            pos += 1
    if literal_start < n:
        _emit_literal(out, data[literal_start:])
    return bytes(out)
