"""The port's fabric and frames (``mythril_tpu_torch/parallel/fabric.py``
and the frames of ``gossip.py``) against the JAX package's, on the CPU.

- **Wire parity**: for the same header and body the port's
  ``send_frame`` writes the JAX package's bytes, and each package's
  ``recv_frame`` reads the other's frames; ``hello_mac``,
  ``welcome_mac``, ``session_key`` and ``frame_mac`` are equal on seeded
  inputs, and an ``AuthedChannel`` of one package talks to the other's;
  ``Stamp`` round trips across the packages; ``pack_journal`` keeps the
  JAX package's names and bytes and ``unpack_journal`` sanitises them as
  it does.
- **The fabric's cases of ``tests/test_fabric.py``**, on a live
  listener of each package: the mutual handshake, a wrong secret, an
  unauthenticated hello, a replayed nonce, a tampered frame, fuzz
  followed by a good connection; the channel's round trip, tamper and
  reflection, and the frame cap held before any allocation.  A JAX
  worker's hello is refused by a port coordinator (``foreign_peer``):
  it could not read the port's lease journals.
- **A remote seat end to end**: a ``worker --connect`` process with a
  secret file attached to a ``--workers 1`` coordinator, on each
  package, gives the findings of one process (``remote_attaches`` 1).
"""

import hashlib
import os
import pickle
import secrets
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

import bench
from test_torch_fleet import (  # noqa: F401 — the autouse fixture
    ROOT,
    SIDES,
    STEADY_ENV,
    cli,
    executable,
    finished_ok,
    fleet_hygiene,
    hexfile,
    package,
)

pytestmark = pytest.mark.fleet

SECRET = b"fabric-test-secret-0123456789abcdef"


def _wait(predicate, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def _raw_frame(pkg, header, body=b""):
    """The bytes ``pkg.send_frame`` writes for (header, body)."""
    a, b = socket.socketpair()
    try:
        pkg.gossip.send_frame(a, header, body)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# wire parity
# ---------------------------------------------------------------------------


FRAMES = [
    ({"type": "hello", "worker_id": "w1", "pid": 4242}, b""),
    ({"type": "lease", "lease_id": "lease3",
      "stamp": {"generation": 0, "pool_version": 0, "lease_epoch": 2},
      "journal_dir": "/tmp/x", "tx_index": 1, "heartbeat_s": 0.5,
      "payload": {"name": "t", "args": {"device": "cpu"}}}, b"\x00" * 17),
    ({"type": "gossip", "text": "café ☃"}, bytes(range(256)) * 9),
]


@pytest.mark.parametrize("index", range(len(FRAMES)))
def test_frames_are_the_jax_bytes_and_cross_read(index):
    header, body = FRAMES[index]
    jax, port = package("jax"), package("port")
    assert _raw_frame(port, header, body) == _raw_frame(jax, header, body)
    for writer, reader in ((port, jax), (jax, port)):
        a, b = socket.socketpair()
        try:
            writer.gossip.send_frame(a, header, body)
            assert reader.gossip.recv_frame(b) == (header, body)
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("seed", range(4))
def test_macs_and_session_key_equal_jax(seed):
    rng = np.random.default_rng(seed)
    secret = rng.bytes(32)
    challenge, nonce = rng.bytes(16).hex(), rng.bytes(16).hex()
    worker_id = f"w{int(rng.integers(1 << 30))}"
    jax, port = package("jax").fabric, package("port").fabric
    assert port.hello_mac(secret, challenge, nonce, worker_id) == \
        jax.hello_mac(secret, challenge, nonce, worker_id)
    assert port.welcome_mac(secret, challenge, nonce) == \
        jax.welcome_mac(secret, challenge, nonce)
    key = port.session_key(secret, challenge, nonce)
    assert key == jax.session_key(secret, challenge, nonce)
    header = {"type": "heartbeat", "lease_id": "lease1",
              "stamp": {"lease_epoch": int(rng.integers(9))},
              "seq": int(rng.integers(1, 99)), "mac": "ignored"}
    body = rng.bytes(int(rng.integers(0, 64)))
    for label in ("w", "c"):
        assert port.frame_mac(key, label, header["seq"], header, body) == \
            jax.frame_mac(key, label, header["seq"], header, body)


@pytest.mark.parametrize("writer_side", sorted(SIDES))
def test_authed_channels_talk_across_packages(writer_side):
    """A channel of one package, the session key shared, is read by the
    other's (sequence numbers and MACs are the same)."""
    reader_side = "port" if writer_side == "jax" else "jax"
    writer, reader = package(writer_side), package(reader_side)
    key = hashlib.sha256(b"cross").digest()
    a, b = socket.socketpair()
    try:
        sender = writer.fabric.AuthedChannel(a, key, send_label="w",
                                             recv_label="c")
        receiver = reader.fabric.AuthedChannel(b, key, send_label="c",
                                               recv_label="w")
        for n in range(3):
            sender.send({"type": "x", "n": n}, bytes([n]) * n)
            header, body = receiver.recv()
            assert header["n"] == n and header["seq"] == n + 1
            assert body == bytes([n]) * n
    finally:
        a.close()
        b.close()


def test_stamps_round_trip_across_packages():
    jax, port = package("jax").gossip, package("port").gossip
    for fields in ({}, {"generation": 3, "pool_version": 7,
                        "lease_epoch": 2}):
        for a, b in ((jax, port), (port, jax)):
            stamp = a.Stamp(**fields)
            got = b.Stamp.from_header({"stamp": stamp.as_dict()})
            assert got.as_dict() == stamp.as_dict()
    assert port.Stamp.from_header({}) == port.Stamp()

    class Ctx:
        generation, pool_version = 5, 11

    assert port.stamp_for(Ctx(), 4).as_dict() == \
        jax.stamp_for(Ctx(), 4).as_dict()


def test_pack_journal_keeps_the_jax_names_and_bytes(tmp_path):
    """A port lease journal (three generations written, two kept) packs
    to the same blob through either package, and unpacks through either
    into a journal the port loads."""
    port, jax = package("port"), package("jax")
    source = str(tmp_path / "src")
    for _ in range(3):
        port.fleet._write_lease_journal(source, address=0xABC, tx_index=1,
                                        transaction_count=2,
                                        states=[port.WorldState(),
                                                port.WorldState()])
    blob = port.fabric.pack_journal(source)
    assert blob == jax.fabric.pack_journal(source)
    assert sorted(pickle.loads(blob)) == ["ckpt-00000002.bin",
                                          "ckpt-00000003.bin"]
    for side in SIDES:
        target = str(tmp_path / f"dst-{side}")
        assert package(side).fabric.unpack_journal(blob, target) == 2
        payload = port.checkpoint.load_journal(target)
        assert payload["tx_index"] == 1
        assert len(payload["open_states"]) == 2
    for side in SIDES:
        fabric = package(side).fabric
        assert fabric.unpack_journal(fabric.pack_journal(
            str(tmp_path / "nowhere")), str(tmp_path / "fresh")) == 0


@pytest.mark.parametrize("side", sorted(SIDES))
def test_unpack_journal_sanitizes_names(side, tmp_path):
    fabric = package(side).fabric
    target = tmp_path / "jail"
    blob = pickle.dumps({"../escape.bin": b"evil", "ok.bin": b"fine",
                         "": b"dropped", "notbytes": "dropped too"})
    assert fabric.unpack_journal(blob, str(target)) == 2
    assert sorted(p.name for p in target.iterdir()) == ["escape.bin",
                                                        "ok.bin"]
    assert not (tmp_path / "escape.bin").exists()
    with pytest.raises(fabric.FrameError):
        fabric.unpack_journal(pickle.dumps([1, 2]), str(target))


def test_port_unpack_journal_resolves_no_global(tmp_path):
    """A packed journal is names and bytes: a blob that would build an
    object is refused before it is built."""
    fabric = package("port").fabric
    with pytest.raises(fabric.FrameError, match="names builtins.eval"):
        fabric.unpack_journal(pickle.dumps({"x": eval}), str(tmp_path))


# ---------------------------------------------------------------------------
# configuration primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", sorted(SIDES))
def test_parse_listen_and_loopback(side):
    fabric = package(side).fabric
    assert fabric.parse_listen("10.0.0.1:4900") == ("10.0.0.1", 4900)
    assert fabric.parse_listen("[::1]:80") == ("[::1]", 80)
    for bad in ("nocolon", ":4900", "h:notaport", "h:70000"):
        with pytest.raises(ValueError):
            fabric.parse_listen(bad)
    assert fabric.is_loopback("127.0.0.1") and fabric.is_loopback("localhost")
    assert not fabric.is_loopback("10.1.2.3")
    assert not fabric.is_loopback("fleet.internal")


@pytest.mark.parametrize("side", sorted(SIDES))
def test_load_secret_rules(side, tmp_path):
    fabric = package(side).fabric
    with pytest.raises(fabric.FleetAuthError):
        fabric.load_secret(str(tmp_path / "missing"))
    empty = tmp_path / "empty"
    empty.write_bytes(b"  \n")
    with pytest.raises(fabric.FleetAuthError):
        fabric.load_secret(str(empty))
    good = tmp_path / "good"
    good.write_bytes(b"  s3cret\n")
    assert fabric.load_secret(str(good)) == b"s3cret"


@pytest.mark.parametrize("side", sorted(SIDES))
def test_non_loopback_listen_refused_without_secret(side):
    pkg = package(side)
    coordinator = pkg.coordinator.Coordinator(
        pkg.coordinator.FleetConfig(workers=0, listen_host="203.0.113.7",
                                    listen_port=0, secret=None),
        {"name": "t"}, spawner=lambda *a, **k: None)
    with pytest.raises(pkg.fabric.FleetAuthError):
        coordinator.open_listener()


# ---------------------------------------------------------------------------
# the handshake against a live listener of each package
# ---------------------------------------------------------------------------


@pytest.fixture(params=sorted(SIDES))
def listening(request):
    """A coordinator listener of one package on loopback with the test
    secret: ``(package, coordinator, port)``."""
    pkg = package(request.param)
    coordinator = pkg.coordinator.Coordinator(
        pkg.coordinator.FleetConfig(workers=0, listen_host="127.0.0.1",
                                    listen_port=0, secret=SECRET,
                                    connect_timeout_s=5.0),
        {"name": "fabric-test"}, spawner=lambda *a, **k: None)
    port = coordinator.open_listener()
    yield pkg, coordinator, port
    coordinator.close_listener()
    for seat in coordinator.seats.values():
        seat.handle.close()


def _dial(port):
    conn = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    conn.settimeout(5.0)
    return conn


def _stats(pkg):
    return pkg.fleet.fleet_stats


def test_handshake_mutual_auth_attaches_remote_seat(listening):
    pkg, coordinator, port = listening
    conn = _dial(port)
    try:
        channel = pkg.fabric.client_handshake(conn, SECRET, "remote-w1")
        assert channel.key is not None
        assert _wait(lambda: "remote-w1" in coordinator.seats)
        assert _stats(pkg).remote_attaches == 1
        assert _stats(pkg).auth_rejects == 0
    finally:
        conn.close()


def test_wrong_secret_rejected(listening):
    pkg, coordinator, port = listening
    conn = _dial(port)
    try:
        with pytest.raises(pkg.fabric.FleetAuthError):
            pkg.fabric.client_handshake(conn, b"the-wrong-secret", "intruder")
    finally:
        conn.close()
    assert _wait(lambda: _stats(pkg).auth_rejects == 1)
    assert "intruder" not in coordinator.seats


def test_unauthenticated_hello_rejected(listening):
    pkg, coordinator, port = listening
    conn = _dial(port)
    try:
        pkg.fabric.client_handshake(conn, None, "legacy")
        assert _wait(lambda: _stats(pkg).auth_rejects == 1)
    finally:
        conn.close()
    assert "legacy" not in coordinator.seats


def test_replayed_hello_nonce_rejected(listening):
    pkg, coordinator, port = listening
    nonce = secrets.token_hex(pkg.fabric.NONCE_BYTES)
    hello = {"type": "hello", "nonce": nonce, "impl": "mythril_tpu_torch"}
    conn = _dial(port)
    try:
        header, _ = pkg.gossip.recv_frame(conn)
        assert header["type"] == "challenge"
        pkg.gossip.send_frame(conn, dict(hello, worker_id="w1", mac=(
            pkg.fabric.hello_mac(SECRET, header["nonce"], nonce, "w1"))))
        assert pkg.gossip.recv_frame(conn)[0]["type"] == "welcome"
    finally:
        conn.close()
    conn = _dial(port)
    try:
        header, _ = pkg.gossip.recv_frame(conn)
        pkg.gossip.send_frame(conn, dict(hello, worker_id="w2", mac=(
            pkg.fabric.hello_mac(SECRET, header["nonce"], nonce, "w2"))))
        answer, _ = pkg.gossip.recv_frame(conn)
        assert answer == {"type": "reject", "code": "auth_failed"}
    finally:
        conn.close()
    assert _wait(lambda: _stats(pkg).auth_rejects == 1)
    assert "w2" not in coordinator.seats


def test_tampered_frame_strikes_seat(listening):
    pkg, coordinator, port = listening
    conn = _dial(port)
    try:
        pkg.fabric.client_handshake(conn, SECRET, "w-tamper")
        assert _wait(lambda: "w-tamper" in coordinator.seats)
        pkg.gossip.send_frame(conn, {"type": "heartbeat", "seq": 1,
                                     "mac": "deadbeef"})
        assert _wait(lambda: _stats(pkg).frame_rejects >= 1)
        assert _wait(lambda: any(
            h.get("type") == "disconnect"
            for _w, h, _b in list(coordinator.inbox.queue)))
    finally:
        conn.close()


def test_frame_fuzz_then_good_connection(listening):
    pkg, coordinator, port = listening
    for payload in (b"\x00" * 64, b"GET / HTTP/1.1\r\nHost: x\r\n\r\n",
                    struct.pack("!I", 1 << 28)):
        conn = _dial(port)
        try:
            pkg.gossip.recv_frame(conn)  # the challenge
            conn.sendall(payload)
            try:
                conn.shutdown(socket.SHUT_WR)
                pkg.gossip.recv_frame(conn)
            except (pkg.gossip.FrameError, OSError):
                pass  # the peer may have struck and closed already
        finally:
            conn.close()
    assert _wait(lambda: (_stats(pkg).frame_rejects
                          + _stats(pkg).auth_rejects) >= 3)
    conn = _dial(port)
    try:
        pkg.fabric.client_handshake(conn, SECRET, "w-after-fuzz")
        assert _wait(lambda: "w-after-fuzz" in coordinator.seats)
    finally:
        conn.close()


@pytest.mark.parametrize("secret", [SECRET, None], ids=["secret", "bare"])
def test_port_coordinator_refuses_a_jax_worker(secret):
    """A JAX worker's hello (no ``impl`` tag) gets the reject code
    ``foreign_peer`` and no seat, with a secret (after the MAC verified)
    and without one; a port worker on the same listener attaches."""
    jax, port = package("jax"), package("port")
    coordinator = port.coordinator.Coordinator(
        port.coordinator.FleetConfig(workers=0, secret=secret,
                                     connect_timeout_s=5.0),
        {"name": "t"}, spawner=lambda *a, **k: None)
    listen = coordinator.open_listener()
    try:
        conn = _dial(listen)
        try:
            if secret is None:
                jax.fabric.client_handshake(conn, None, "jax-w")
                answer, _ = port.gossip.recv_frame(conn)
                assert answer == {"type": "reject", "code": "foreign_peer"}
            else:
                with pytest.raises(jax.fabric.FleetAuthError,
                                   match="foreign_peer"):
                    jax.fabric.client_handshake(conn, secret, "jax-w")
        finally:
            conn.close()
        assert _wait(lambda: port.fleet.fleet_stats.auth_rejects == 1)
        assert "jax-w" not in coordinator.seats
        if secret is not None:
            conn = _dial(listen)
            try:
                port.fabric.client_handshake(conn, secret, "port-w")
                assert _wait(lambda: "port-w" in coordinator.seats)
            finally:
                conn.close()
    finally:
        coordinator.close_listener()
        for seat in coordinator.seats.values():
            seat.handle.close()


# ---------------------------------------------------------------------------
# the channel and the frame cap
# ---------------------------------------------------------------------------


def _channel_pair(pkg):
    a, b = socket.socketpair()
    key = hashlib.sha256(b"chan").digest()
    sender = pkg.fabric.AuthedChannel(a, key, send_label="w",
                                      recv_label="c")
    receiver = pkg.fabric.AuthedChannel(b, key, send_label="c",
                                        recv_label="w")
    return a, b, key, sender, receiver


@pytest.mark.parametrize("side", sorted(SIDES))
def test_authed_channel_roundtrip_and_replay(side):
    pkg = package(side)
    a, b, key, sender, receiver = _channel_pair(pkg)
    try:
        sender.send({"type": "x"}, b"body")
        header, body = receiver.recv()
        assert header["type"] == "x" and body == b"body"
        replay = {"type": "x", "seq": 1}
        replay["mac"] = pkg.fabric.frame_mac(key, "w", 1, replay, b"body")
        pkg.gossip.send_frame(a, replay, b"body")
        with pytest.raises(pkg.fabric.FleetAuthError):
            receiver.recv()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_authed_channel_rejects_tamper_and_reflection(side):
    pkg = package(side)
    a, b, key, sender, receiver = _channel_pair(pkg)
    try:
        forged = {"type": "x", "seq": 1}
        forged["mac"] = pkg.fabric.frame_mac(key, "w", 1, forged, b"good")
        pkg.gossip.send_frame(a, forged, b"evil")
        with pytest.raises(pkg.fabric.FleetAuthError):
            receiver.recv()
    finally:
        a.close()
        b.close()
    a, b, key, sender, receiver = _channel_pair(pkg)
    try:
        reflected = {"type": "x", "seq": 1}
        reflected["mac"] = pkg.fabric.frame_mac(key, "c", 1, reflected, b"")
        pkg.gossip.send_frame(a, reflected)
        with pytest.raises(pkg.fabric.FleetAuthError):
            receiver.recv()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_max_frame_cap_enforced_before_allocation(side, monkeypatch):
    pkg = package(side)
    monkeypatch.setenv("MYTHRIL_TPU_FLEET_MAX_FRAME", "4096")
    a, b = socket.socketpair()
    try:
        head = b'{"type": "x"}'
        a.sendall(struct.pack("!I", len(head)) + head
                  + struct.pack("!Q", 10_000_000))
        with pytest.raises(pkg.gossip.FrameError, match="MAX_FRAME"):
            pkg.gossip.recv_frame(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack("!I", 1 << 28))
        with pytest.raises(pkg.gossip.FrameError, match="header length"):
            pkg.gossip.recv_frame(b)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        with pytest.raises(pkg.gossip.FrameError, match="MAX_FRAME"):
            pkg.gossip.send_frame(a, {"type": "x"}, b"\x00" * 5000)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# a remote seat end to end, on each package
# ---------------------------------------------------------------------------


#: the spawned seat's interpreter in the remote-seat test: it never
#: dials, so the lease can only go to the remote seat
NEVER_DIALS = "#!/bin/sh\nexec sleep 600\n"


def free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def worker_process(side, listen, secret_file, worker_id, log):
    """``worker --connect`` of ``side``'s CLI, redialing until the
    coordinator's listener is up, its stderr into the file ``log``."""
    argv = ([sys.executable, "myth", "worker"] if side == "jax" else
            [sys.executable, "-m", "mythril_tpu_torch", "worker"])
    argv += ["--connect", listen, "--secret-file", secret_file, "--id",
             worker_id, "--reconnect", "40"]
    environ = dict(os.environ, **STEADY_ENV)
    if side == "jax":
        environ.update(JAX_PLATFORMS="cpu", XLA_FLAGS="",
                       MYTHRIL_TPU_PALLAS="force")
    return subprocess.Popen(argv, cwd=ROOT, env=environ,
                            stdout=subprocess.DEVNULL, stderr=log)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_remote_seat_with_a_secret_runs_the_lease(side, tmp_path):
    """A ``--workers 1`` coordinator listening on a fixed loopback port
    with a secret file, its own spawned seat one that never dials, and a
    ``worker --connect --secret-file`` process: the remote seat attaches
    and runs the lease; the findings are those of one process."""
    path = hexfile(tmp_path, "chaos_tree", bench.chaos_tree_contract())
    secret_file = tmp_path / "secret"
    secret_file.write_text(secrets.token_hex(16) + "\n")
    listen = f"127.0.0.1:{free_port()}"
    log = open(tmp_path / "remote.err", "w")
    remote = worker_process(side, listen, str(secret_file), "remote-1", log)
    try:
        coordinator = cli(side, path, "-t", "2", "--workers", "1", env={
            "MYTHRIL_TPU_FLEET_LISTEN": listen,
            "MYTHRIL_TPU_FLEET_SECRET_FILE": str(secret_file),
            "MYTHRIL_TPU_FLEET_PYTHON": executable(tmp_path, "never.sh",
                                                   NEVER_DIALS),
        })
        swcs, block = finished_ok(coordinator)
    finally:
        remote.terminate()
        remote.wait(timeout=60)
        log.close()
    assert swcs == {"SWC-106"}
    assert block.get("fleet_remote_attaches") == 1, block
    assert block.get("fleet_leases") == 1, block
    assert not block.get("fleet_worker_deaths"), block
    assert not block.get("fleet_inprocess_leases"), block
    assert remote.returncode == 0, (tmp_path / "remote.err").read_text()
