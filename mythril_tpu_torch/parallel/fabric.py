"""Authenticated transport of the fleet, the "fabric" (own copy of
``mythril_tpu/parallel/fabric.py``).

A coordinator's listener is reachable by anything that can route a
packet to it, and a pickle body executes code the moment it is loaded.
This module is the boundary that makes a remote attach safe, in three
layers, each byte for byte the JAX package's:

1. **Shared-secret handshake**: the coordinator opens every accepted
   connection with a ``challenge`` frame holding a fresh nonce; the
   worker answers with a ``hello`` whose MAC is
   ``HMAC-SHA256(secret, "hello" | challenge | worker nonce | worker id)``,
   and the coordinator replies with a ``welcome`` MAC over the same
   nonces, so the authentication is mutual.  Handshake frames carry no
   body: nothing is unpickled from a peer that has not authenticated.
2. **Per-frame MACs and sequence numbers**: both sides derive a session
   key from the nonces and MAC every later frame (direction label,
   sequence number, canonical header, body).  The sequence number must
   rise in each direction, so a recorded frame cannot be replayed and a
   frame cannot be reflected back to its sender.
3. **The frame cap first**: ``gossip.recv_frame`` holds both length
   prefixes to ``MYTHRIL_TPU_FLEET_MAX_FRAME`` before any allocation,
   authenticated or not.

A remote worker shares no filesystem with the coordinator, so a lease
grant carries the frozen journal generations as its body
(:func:`pack_journal`) and the worker ships its boundary journals back
the same way (:func:`unpack_journal`).

The port's worker adds :data:`IMPL` to its hello; a port coordinator
refuses a hello without it (a JAX worker could not read the port's
lease journals, whose reducers name this package's functions).
"""

import hashlib
import hmac
import ipaddress
import json
import logging
import os
import pickle
import secrets
import threading
from typing import Optional, Tuple

from mythril_tpu_torch.parallel.gossip import (
    FrameError,
    max_frame_bytes,
    recv_frame,
    send_frame,
)

log = logging.getLogger(__name__)

NONCE_BYTES = 16

#: the implementation tag of the port's hello (``coordinator.py`` refuses
#: a hello without it with the reject code ``foreign_peer``)
IMPL = "mythril_tpu_torch"

__all__ = [
    "FleetAuthError", "AuthedChannel", "load_secret", "parse_listen",
    "is_loopback", "hello_mac", "welcome_mac", "session_key",
    "client_handshake", "pack_journal", "unpack_journal",
    "max_frame_bytes",
]


class FleetAuthError(FrameError):
    """An authentication failure at the fabric boundary: a bad handshake
    MAC, a replayed hello, a tampered frame or a sequence regression (a
    :class:`FrameError`: the connection is unusable after it)."""


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def load_secret(path: str) -> bytes:
    """The shared secret, stripped of surrounding whitespace; raises
    :class:`FleetAuthError` when the file is missing or empty (an empty
    secret would authenticate everyone)."""
    try:
        with open(path, "rb") as fh:
            secret = fh.read().strip()
    except OSError as exc:
        raise FleetAuthError(f"cannot read secret file {path!r}: {exc}")
    if not secret:
        raise FleetAuthError(f"secret file {path!r} is empty")
    return secret


def resolve_secret() -> Optional[bytes]:
    """The secret of ``MYTHRIL_TPU_FLEET_SECRET_FILE``, or None when the
    knob is unset."""
    path = os.environ.get("MYTHRIL_TPU_FLEET_SECRET_FILE", "").strip()
    return load_secret(path) if path else None


def parse_listen(spec: str) -> Tuple[str, int]:
    """``HOST:PORT`` -> ``(host, port)``; raises ``ValueError`` on
    anything else (``support/env.py:validate_env`` applies it at
    startup)."""
    host, sep, port = str(spec).strip().rpartition(":")
    if not sep or not host:
        raise ValueError(f"expected HOST:PORT, got {spec!r}")
    try:
        port_num = int(port)
    except ValueError:
        raise ValueError(f"port {port!r} is not an integer") from None
    if not 0 <= port_num <= 65535:
        raise ValueError(f"port {port_num} out of range")
    return host, port_num


def is_loopback(host: str) -> bool:
    if host in ("localhost", ""):
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False  # a host name is assumed routable


# ---------------------------------------------------------------------------
# handshake MACs and the session key
# ---------------------------------------------------------------------------


def _mac(secret: bytes, *parts: bytes) -> str:
    return hmac.new(secret, b"|".join(parts), hashlib.sha256).hexdigest()


def hello_mac(secret: bytes, challenge: str, nonce: str,
              worker_id: str) -> str:
    return _mac(secret, b"hello", challenge.encode(), nonce.encode(),
                worker_id.encode())


def welcome_mac(secret: bytes, challenge: str, nonce: str) -> str:
    return _mac(secret, b"welcome", challenge.encode(), nonce.encode())


def session_key(secret: bytes, challenge: str, nonce: str) -> bytes:
    return hmac.new(
        secret, b"|".join((b"session", challenge.encode(), nonce.encode())),
        hashlib.sha256,
    ).digest()


def frame_mac(key: bytes, label: str, seq: int, header: dict,
              body: bytes) -> str:
    """MAC over (direction label, sequence number, the header without
    its ``mac`` in canonical JSON, body).  The label keeps a
    coordinator-to-worker frame from being reflected back as a
    worker-to-coordinator one."""
    scrubbed = {k: v for k, v in header.items() if k != "mac"}
    message = b"|".join((
        label.encode(), str(int(seq)).encode(),
        json.dumps(scrubbed, sort_keys=True).encode("utf-8"), body,
    ))
    return hmac.new(key, message, hashlib.sha256).hexdigest()


class AuthedChannel:
    """A direction-labelled, sequence-numbered, MAC'd frame stream over
    a connected socket.  With ``key=None`` it is the plain framing of a
    coordinator's own spawned workers on loopback (the frame cap still
    holds)."""

    def __init__(self, sock, key: Optional[bytes],
                 send_label: str = "peer", recv_label: str = "peer"):
        self.sock = sock
        self.key = key
        self.send_label = send_label
        self.recv_label = recv_label
        self._send_seq = 0
        self._recv_seq = 0
        self._send_lock = threading.Lock()

    def send(self, header: dict, body: bytes = b"") -> None:
        with self._send_lock:
            if self.key is None:
                send_frame(self.sock, header, body)
                return
            self._send_seq += 1
            stamped = dict(header)
            stamped["seq"] = self._send_seq
            stamped["mac"] = frame_mac(self.key, self.send_label,
                                       self._send_seq, stamped, body)
            send_frame(self.sock, stamped, body)

    def recv(self):
        header, body = recv_frame(self.sock)
        if self.key is None:
            return header, body
        seq = header.get("seq")
        if not isinstance(seq, int) or seq <= self._recv_seq:
            raise FleetAuthError(
                f"frame sequence {seq!r} not after {self._recv_seq} "
                "(replay or reorder)")
        expected = frame_mac(self.key, self.recv_label, seq, header, body)
        if not hmac.compare_digest(str(header.get("mac", "")), expected):
            raise FleetAuthError("frame MAC mismatch (tampered frame)")
        self._recv_seq = seq
        return header, body


def client_handshake(conn, secret: Optional[bytes],
                     worker_id: str) -> AuthedChannel:
    """The worker's half of the attach handshake: without a secret the
    bare hello; with one challenge, MAC'd hello, MAC'd welcome, and the
    returned channel MACs every later frame.  Raises
    :class:`FleetAuthError` on a reject or a coordinator that fails the
    mutual authentication."""
    if secret is None:
        channel = AuthedChannel(conn, None)
        channel.send({"type": "hello", "worker_id": worker_id,
                      "pid": os.getpid(), "impl": IMPL})
        return channel
    header, _body = recv_frame(conn)
    if header.get("type") == "reject":
        raise FleetAuthError(
            f"coordinator rejected attach: {header.get('code', '?')}")
    if header.get("type") != "challenge":
        raise FleetAuthError(
            "coordinator did not challenge (secret configured here but "
            "not there?)")
    challenge = str(header.get("nonce", ""))
    nonce = secrets.token_hex(NONCE_BYTES)
    send_frame(conn, {
        "type": "hello", "worker_id": worker_id, "pid": os.getpid(),
        "impl": IMPL, "nonce": nonce,
        "mac": hello_mac(secret, challenge, nonce, worker_id),
    })
    answer, _body = recv_frame(conn)
    if answer.get("type") == "reject":
        raise FleetAuthError(
            f"coordinator rejected attach: {answer.get('code', '?')}")
    if answer.get("type") != "welcome" or not hmac.compare_digest(
            str(answer.get("mac", "")), welcome_mac(secret, challenge, nonce)):
        raise FleetAuthError("coordinator failed mutual authentication")
    return AuthedChannel(conn, session_key(secret, challenge, nonce),
                         send_label="w", recv_label="c")


# ---------------------------------------------------------------------------
# journals over the wire
# ---------------------------------------------------------------------------


def pack_journal(journal_dir: Optional[str], keep: int = 2) -> bytes:
    """The newest ``keep`` journal generations as one pickled
    ``{basename: bytes}`` mapping (the generation numbers are in the
    names).  An empty or missing directory packs to an empty mapping."""
    from mythril_tpu_torch.resilience.checkpoint import _generations

    files = {}
    if journal_dir and os.path.isdir(journal_dir):
        for _gen, path in _generations(journal_dir)[-keep:]:
            try:
                with open(path, "rb") as fh:
                    files[os.path.basename(path)] = fh.read()
            except OSError:
                continue
    return pickle.dumps(files, protocol=4)


class _JournalUnpickler(pickle.Unpickler):
    """A packed journal is a dict of names to bytes: no global is
    resolved."""

    def find_class(self, module, name):
        raise FrameError(f"packed journal names {module}.{name}")


def unpack_journal(blob: bytes, directory: str) -> int:
    """Write a packed journal into ``directory`` (each file atomically,
    under its base name only: no path traversal); returns the file
    count."""
    import io

    if not blob:
        return 0
    files = _JournalUnpickler(io.BytesIO(blob)).load()
    if not isinstance(files, dict):
        raise FrameError("packed journal is not a mapping")
    os.makedirs(directory, exist_ok=True)
    count = 0
    for name, data in files.items():
        name = os.path.basename(str(name))
        if not name or not isinstance(data, (bytes, bytearray)):
            continue
        tmp = os.path.join(directory, f".{name}.tmp")
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, os.path.join(directory, name))
        count += 1
    return count
