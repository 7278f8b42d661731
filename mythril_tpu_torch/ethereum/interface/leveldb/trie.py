"""Merkle Patricia Trie: reader (walks geth state/storage tries out of
the database) and builder (constructs node sets for test fixtures).

Node encoding (yellow-paper / geth):
- branch: 17-item RLP list (16 child refs + value);
- leaf / extension: 2-item list [hex-prefix path, value-or-ref];
- a child ref is the node's RLP inline when < 32 bytes, else its
  keccak256 hash resolved through the database;
- "secure" tries (geth state + storage) key entries by
  keccak256(raw key).

Reference counterpart: reference state.py leaned on the external
``ethereum.trie`` package; here the trie is part of the framework.

Own copy of the JAX package's ``mythril_tpu/ethereum/interface/leveldb/trie.py``.
"""

from typing import Dict, Iterator, List, Optional, Tuple

from mythril_tpu_torch.support import rlp
from mythril_tpu_torch.support.crypto import keccak256

EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)  # keccak256(rlp(b""))


def bytes_to_nibbles(data: bytes) -> Tuple[int, ...]:
    out = []
    for byte in data:
        out.append(byte >> 4)
        out.append(byte & 0xF)
    return tuple(out)


def hp_encode(nibbles: Tuple[int, ...], is_leaf: bool) -> bytes:
    flag = 2 if is_leaf else 0
    if len(nibbles) % 2:
        prefixed = (flag + 1,) + nibbles
    else:
        prefixed = (flag, 0) + nibbles
    return bytes(
        (prefixed[i] << 4) | prefixed[i + 1]
        for i in range(0, len(prefixed), 2)
    )


def hp_decode(data: bytes) -> Tuple[Tuple[int, ...], bool]:
    nibbles = bytes_to_nibbles(data)
    flag = nibbles[0]
    is_leaf = bool(flag & 2)
    offset = 1 if flag & 1 else 2
    return nibbles[offset:], is_leaf


class TrieReader:
    """Walks a trie whose nodes live in a key-value database
    (``db.get(node_hash) -> node_rlp``)."""

    def __init__(self, db, root: bytes, secure: bool = True):
        self.db = db
        self.root = root
        self.secure = secure

    def _resolve(self, ref) -> Optional[list]:
        if isinstance(ref, list):
            return ref  # inlined node
        if ref == b"":
            return None
        node_rlp = self.db.get(bytes(ref))
        if node_rlp is None:
            return None
        return rlp.decode(node_rlp)

    def get(self, key: bytes) -> Optional[bytes]:
        if self.root in (b"", EMPTY_ROOT):
            return None
        if self.secure:
            key = keccak256(key)
        nibbles = bytes_to_nibbles(key)
        node = self._resolve(self.root)
        while node is not None:
            if len(node) == 17:
                if not nibbles:
                    return bytes(node[16]) or None
                node = self._resolve(node[nibbles[0]])
                nibbles = nibbles[1:]
            elif len(node) == 2:
                path, is_leaf = hp_decode(bytes(node[0]))
                if is_leaf:
                    return bytes(node[1]) if nibbles == path else None
                if nibbles[: len(path)] != path:
                    return None
                nibbles = nibbles[len(path) :]
                node = self._resolve(node[1])
            else:
                return None
        return None

    def items(self) -> Iterator[Tuple[Tuple[int, ...], bytes]]:
        """All (key_nibbles, value) leaves.  For secure tries the
        nibbles are of the hashed key (the preimage is unrecoverable —
        callers use an address index, see accountindexing.py)."""
        if self.root in (b"", EMPTY_ROOT):
            return
        yield from self._walk(self._resolve(self.root), ())

    def _walk(self, node, prefix):
        if node is None:
            return
        if len(node) == 17:
            if node[16]:
                yield prefix, bytes(node[16])
            for i in range(16):
                if node[i] != b"":
                    yield from self._walk(
                        self._resolve(node[i]), prefix + (i,)
                    )
        elif len(node) == 2:
            path, is_leaf = hp_decode(bytes(node[0]))
            if is_leaf:
                yield prefix + path, bytes(node[1])
            else:
                yield from self._walk(
                    self._resolve(node[1]), prefix + path
                )


class TrieBuilder:
    """Builds the node set for a set of key/value pairs (fixtures)."""

    def __init__(self, secure: bool = True):
        self.secure = secure
        self.entries: Dict[bytes, bytes] = {}
        self.nodes: Dict[bytes, bytes] = {}

    def put(self, key: bytes, value: bytes) -> None:
        if self.secure:
            key = keccak256(key)
        self.entries[key] = value

    def commit(self) -> bytes:
        """Returns the root hash; ``self.nodes`` maps hash -> node RLP."""
        self.nodes = {}
        items = [
            (bytes_to_nibbles(k), v) for k, v in sorted(self.entries.items())
        ]
        if not items:
            return EMPTY_ROOT
        root_node = self._build(items)
        encoded = rlp.encode(root_node)
        root_hash = keccak256(encoded)
        self.nodes[root_hash] = encoded
        return root_hash

    def _ref(self, node) -> rlp.Item:
        encoded = rlp.encode(node)
        if len(encoded) < 32:
            return node  # inline
        node_hash = keccak256(encoded)
        self.nodes[node_hash] = encoded
        return node_hash

    def _build(self, items: List[Tuple[Tuple[int, ...], bytes]]):
        if len(items) == 1:
            path, value = items[0]
            return [hp_encode(path, True), value]
        # longest common prefix
        first = items[0][0]
        lcp = len(first)
        for path, _ in items[1:]:
            i = 0
            while i < lcp and i < len(path) and path[i] == first[i]:
                i += 1
            lcp = i
        if lcp > 0:
            stripped = [(path[lcp:], v) for path, v in items]
            child = self._build(stripped)
            return [hp_encode(first[:lcp], False), self._ref(child)]
        # branch on the first nibble
        branch: List[rlp.Item] = [b""] * 17
        for nibble in range(16):
            group = [
                (path[1:], v) for path, v in items
                if path and path[0] == nibble
            ]
            if group:
                branch[nibble] = self._ref(self._build(group))
        terminals = [v for path, v in items if not path]
        if terminals:
            branch[16] = terminals[0]
        return branch
