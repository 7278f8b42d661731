"""Fleet coordinator: subtree leases, heartbeat failure detection,
straggler rebalancing and epoch-fenced gossip routing (own copy of
``mythril_tpu/parallel/coordinator.py``).

The coordinator owns the authoritative copy of every subtree: each lease
is a journal directory of the checkpoint plane that the coordinator
wrote (frontier world states at a transaction boundary), and a worker
runs a lease by resuming from it (``checkpoint.restore_transactions``),
journaling its progress back into the same directory.  That gives the
failure matrix:

- **worker death** (missed heartbeats past the lease TTL, a broken
  connection): the journal is copied into a fresh directory (picking up
  the last boundary the dead worker wrote), the lease epoch is bumped
  and the lease granted again.  Exploration is idempotent (findings
  dedup by the modules' caches), so a kill after the last journal write
  costs repeated work, never lost or invented findings.
- **straggler** (a lease running past ``split_after_s`` while a seat
  idles): the slow worker is drained (SIGTERM, or a ``drain`` frame for
  a remote seat: a final journal at the interrupted transaction's start
  boundary), its frontier split in two and both halves leased.
- **partition / zombie**: a worker whose heartbeats stop is declared
  dead and its subtree leased again under a bumped epoch; if it was only
  partitioned, every message it sends later carries the old epoch and is
  dropped (``gossip_dropped_stale``).
- **total loss**: with every worker dead and the respawn budget spent,
  :meth:`run` returns with the unfinished leases (each a valid journal)
  and the caller finishes them in-process, on its own device.

One rung differs from the JAX package by decision: a worker's ``error``
frame carries the exception's type, and only an injected one
(``FaultInjected``, or the watchdog's ``WatchdogTimeout``) is taken back
and leased again.  Any other (a kernel's build or launch error, a CUDA
error, ``DeviceLost``) raises :class:`FleetWorkerError` out of
:meth:`run`, which fails the analysis: a fault of the card is not
papered over by running the lease again or in-process.

Workers are separate processes speaking the frames of ``gossip.py``:
children spawned on loopback (``python -m
mythril_tpu_torch.parallel.fleet``, never forked: the coordinator holds
a CUDA context a forked child could not use), or workers started
elsewhere (``python3 -m mythril_tpu_torch worker --connect``) that
attach through the authenticated fabric (``fabric.py``).  A peer that
fails the handshake or sends a malformed frame gets a structured reject
and a strike, never a traceback and never an unpickle; a peer of the
JAX package (a hello without ``fabric.IMPL``) is rejected with the code
``foreign_peer``, since it could not read this package's journals.
"""

import hmac
import logging
import os
import queue
import secrets
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from mythril_tpu_torch.parallel import fabric
from mythril_tpu_torch.parallel.fabric import AuthedChannel, FleetAuthError
from mythril_tpu_torch.parallel.gossip import (
    FrameError,
    Stamp,
    recv_frame,
    send_frame,
)
from mythril_tpu_torch.support.env import env_float, env_int

log = logging.getLogger(__name__)

# lease lifecycle: PENDING -> RUNNING -> (DONE | back to PENDING on a
# death or split | FAILED past the retry budget, finished in-process)
PENDING, RUNNING, DONE, FAILED = "pending", "running", "done", "failed"

#: how much of a dead worker's stderr survives into the post-mortem
STDERR_TAIL_BYTES = 4096

#: the error types a worker reports that the fleet takes back and leases
#: again (the resilience plane's rule: only these walk a ladder)
INJECTED_ERRORS = ("FaultInjected", "WatchdogTimeout")


class FleetWorkerError(RuntimeError):
    """A worker failed a lease with an error the fleet did not inject;
    the analysis fails with it."""


class ForeignPeer(FleetAuthError):
    """A hello from another implementation of the fleet (the JAX
    package's worker)."""


@dataclass
class FleetConfig:
    """Coordinator tuning, resolved once per fleet run from the
    ``MYTHRIL_TPU_FLEET_*`` knobs."""

    workers: int = 2
    heartbeat_s: float = 0.5       # worker send cadence
    lease_ttl_s: float = 12.0      # missed-heartbeat window => death
    split_after_s: float = 20.0    # straggler threshold (0 = never)
    lease_retries: int = 2         # re-leases per lease before FAILED
    spawn_retries: int = 2         # extra spawn attempts per seat
    connect_timeout_s: float = 120.0
    hard_cap_s: float = 900.0      # absolute lease wall cap
    checkpoint_period_s: str = "5"  # worker journal refresh cadence
    listen_host: str = "127.0.0.1"  # non-loopback requires a secret
    listen_port: int = 0           # 0 = ephemeral
    secret: Optional[bytes] = None  # shared fabric secret, or None

    @classmethod
    def from_env(cls, workers: int) -> "FleetConfig":
        listen_host, listen_port = "127.0.0.1", 0
        raw_listen = os.environ.get("MYTHRIL_TPU_FLEET_LISTEN", "").strip()
        if raw_listen:
            try:
                listen_host, listen_port = fabric.parse_listen(raw_listen)
            except ValueError as exc:
                # the CLI's knob gate refuses it at startup; a read
                # mid-run stays lenient
                log.warning("fleet: bad MYTHRIL_TPU_FLEET_LISTEN (%s); "
                            "listening on loopback", exc)
        secret = None
        try:
            secret = fabric.resolve_secret()
        except FleetAuthError as exc:
            log.warning("fleet: %s; remote attach disabled", exc)
        return cls(
            workers=max(1, workers),
            heartbeat_s=env_float("MYTHRIL_TPU_FLEET_HEARTBEAT_S", 0.5,
                                  floor=0.05),
            lease_ttl_s=env_float("MYTHRIL_TPU_FLEET_LEASE_TTL_S", 12.0,
                                  floor=0.1),
            split_after_s=env_float("MYTHRIL_TPU_FLEET_SPLIT_AFTER_S", 20.0,
                                    floor=0.0),
            lease_retries=env_int("MYTHRIL_TPU_FLEET_LEASE_RETRIES", 2,
                                  floor=0),
            spawn_retries=env_int("MYTHRIL_TPU_FLEET_SPAWN_RETRIES", 2,
                                  floor=0),
            connect_timeout_s=env_float(
                "MYTHRIL_TPU_FLEET_CONNECT_TIMEOUT_S", 120.0, floor=0.1),
            hard_cap_s=env_float("MYTHRIL_TPU_FLEET_HARD_CAP_S", 900.0,
                                 floor=0.1),
            checkpoint_period_s=os.environ.get(
                "MYTHRIL_TPU_FLEET_CHECKPOINT_PERIOD", "5"),
            listen_host=listen_host,
            listen_port=listen_port,
            secret=secret,
        )


@dataclass
class Lease:
    """One subtree lease; ``journal_dir`` always holds a valid journal
    (generation 1 written at grant time, the worker's after it)."""

    lease_id: str
    journal_dir: str
    tx_index: int
    n_states: int
    epoch: int = 0
    state: str = PENDING
    worker_id: Optional[str] = None
    granted_at: float = 0.0
    first_granted_at: float = 0.0
    last_heartbeat: float = 0.0
    attempts: int = 0
    splitting: bool = False
    result: Optional[dict] = None
    result_body: Optional[bytes] = None
    #: a per-lease payload (None = the coordinator's)
    payload: Optional[dict] = None


@dataclass
class WorkerSeat:
    """One worker slot (its handle injected by the tests)."""

    worker_id: str
    handle: object = None          # WorkerProcess, remote handle, fake
    lease_id: Optional[str] = None
    dead: bool = False
    spawned_at: float = 0.0


class WorkerProcess:
    """A spawned worker process and its connected socket."""

    remote = False

    def __init__(self, worker_id: str, proc: subprocess.Popen,
                 stderr_path: Optional[str] = None):
        self.worker_id = worker_id
        self.proc = proc
        self.conn: Optional[socket.socket] = None
        self.channel: Optional[AuthedChannel] = None
        self.stderr_path = stderr_path
        self._send_lock = threading.Lock()

    def attach(self, conn: socket.socket, channel=None) -> None:
        self.conn = conn
        self.channel = channel

    def alive(self) -> bool:
        return self.proc.poll() is None

    def send(self, header: dict, body: bytes = b"") -> bool:
        if self.conn is None:
            return False
        try:
            with self._send_lock:
                if self.channel is not None:
                    self.channel.send(header, body)
                else:
                    send_frame(self.conn, header, body)
            return True
        except (FrameError, OSError):
            return False

    def drain(self) -> None:
        """SIGTERM: the worker journals its boundary and reports a
        partial result (the split path)."""
        try:
            self.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            log.warning("fleet: worker %s outlived SIGKILL by 10 s",
                        self.worker_id)
        self.close()

    def close(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def read_stderr_tail(self, limit: int = STDERR_TAIL_BYTES) -> bytes:
        """The last ``limit`` bytes the worker wrote to stderr."""
        if not self.stderr_path:
            return b""
        try:
            with open(self.stderr_path, "rb") as fh:
                fh.seek(0, os.SEEK_END)
                size = fh.tell()
                fh.seek(max(0, size - limit))
                return fh.read()
        except OSError:
            return b""

    def discard_stderr(self) -> None:
        if self.stderr_path:
            try:
                os.unlink(self.stderr_path)
            except OSError:
                pass
            self.stderr_path = None


class RemoteWorkerHandle:
    """A worker started elsewhere (``python3 -m mythril_tpu_torch worker
    --connect``): no process to signal or reap; drain travels as a frame
    and death is whatever closes the socket."""

    remote = True

    def __init__(self, worker_id: str):
        self.worker_id = worker_id
        self.conn: Optional[socket.socket] = None
        self.channel: Optional[AuthedChannel] = None

    def attach(self, conn: socket.socket, channel=None) -> None:
        self.conn = conn
        self.channel = channel

    def alive(self) -> bool:
        return self.conn is not None

    def send(self, header: dict, body: bytes = b"") -> bool:
        if self.conn is None:
            return False
        try:
            if self.channel is not None:
                self.channel.send(header, body)
            else:
                send_frame(self.conn, header, body)
            return True
        except (FrameError, OSError):
            return False

    def drain(self) -> None:
        self.send({"type": "drain"})

    def kill(self) -> None:
        self.close()

    def close(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None


class Coordinator:
    """The lease state machine and its socket plumbing.

    The state machine (message handling, expiry sweeps, splitting,
    assignment) is plain method calls over :class:`Lease` and
    :class:`WorkerSeat` under an injectable clock, which the tests drive
    with fake handles; the plumbing (listener, reader threads, spawning)
    only feeds the inbox."""

    # a remote host that keeps failing the handshake or the framing is
    # dropped before the handshake for a cooldown; loopback never is
    _STRIKE_LIMIT = 3
    _STRIKE_COOLDOWN_S = 30.0

    def __init__(self, config: FleetConfig, lease_payload: dict,
                 spawner=None, clock=time.monotonic):
        from mythril_tpu_torch.parallel.fleet import fleet_stats

        self.config = config
        #: what every lease grant ships (bytecode, address, transaction
        #: count, the args snapshot ...)
        self.lease_payload = lease_payload
        self.clock = clock
        self.stats = fleet_stats
        self.leases: Dict[str, Lease] = {}
        self.seats: Dict[str, WorkerSeat] = {}
        self.inbox: "queue.Queue" = queue.Queue()
        self._spawner = spawner if spawner is not None else self._spawn
        self._listener: Optional[socket.socket] = None
        self._lease_seq = 0
        self._seat_seq = 0
        self._spawn_failures = 0
        self._drained = False
        self.port: Optional[int] = None
        #: peer host -> (strikes, monotonic time of the last)
        self._strikes: Dict[str, tuple] = {}
        #: hello nonces seen (on top of the challenge's freshness)
        self._hello_nonces: set = set()

    # ------------------------------------------------------------------
    # socket plumbing
    # ------------------------------------------------------------------

    def open_listener(self) -> int:
        host = self.config.listen_host
        if self.config.secret is None and not fabric.is_loopback(host):
            # a routable listener without a secret would hand an
            # unpickle to the whole network
            raise FleetAuthError(
                f"refusing non-loopback fleet listen on {host!r} "
                "without MYTHRIL_TPU_FLEET_SECRET_FILE")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, self.config.listen_port))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, name="fleet-accept",
                         daemon=True).start()
        return self.port

    def connect_address(self) -> str:
        """The address spawned workers dial: loopback for a loopback or
        wildcard listener, the bound address otherwise."""
        host = self.config.listen_host
        if host in ("0.0.0.0", "::", "") or fabric.is_loopback(host):
            return "127.0.0.1"
        return host

    def close_listener(self) -> None:
        """Stop listening: the shutdown wakes the accept thread, whose
        blocked ``accept`` would otherwise keep the port accepting
        connections nobody answers for as long as this process lives."""
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
            self._listener = None

    def _accept_loop(self) -> None:
        listener = self._listener
        while listener is not None and listener.fileno() >= 0:
            try:
                conn, addr = listener.accept()
            except OSError:
                return
            threading.Thread(target=self._register_conn, args=(conn, addr),
                             name="fleet-hello", daemon=True).start()

    def _strike(self, peer: str) -> None:
        count, _when = self._strikes.get(peer, (0, 0.0))
        self._strikes[peer] = (count + 1, time.monotonic())

    def _peer_blocked(self, peer: str) -> bool:
        if peer == "local" or fabric.is_loopback(peer):
            return False
        count, when = self._strikes.get(peer, (0, 0.0))
        if count < self._STRIKE_LIMIT:
            return False
        if time.monotonic() - when > self._STRIKE_COOLDOWN_S:
            self._strikes.pop(peer, None)
            return False
        return True

    @staticmethod
    def _reject(conn: socket.socket, code: str) -> None:
        """The one frame an unauthenticated peer ever gets back."""
        try:
            send_frame(conn, {"type": "reject", "code": code})
        except (FrameError, OSError):
            pass
        try:
            conn.close()
        except OSError:
            pass

    @staticmethod
    def _check_impl(header: dict) -> None:
        if header.get("impl") != fabric.IMPL:
            raise ForeignPeer(
                f"hello from a {header.get('impl') or 'mythril_tpu'} "
                f"worker; this coordinator leases {fabric.IMPL} journals")

    def _handshake(self, conn: socket.socket):
        """Nothing a peer sends reaches an unpickler before this returns.
        Without a secret the bare hello (loopback only, by
        :meth:`open_listener`); with one, challenge, MAC'd hello, MAC'd
        welcome, and every later frame on the session key."""
        from mythril_tpu_torch.resilience.faults import get_fault_plane

        secret = self.config.secret
        if secret is None:
            header, _body = recv_frame(conn)
            if header.get("type") != "hello":
                raise FrameError("first frame was not hello")
            self._check_impl(header)
            return (str(header.get("worker_id", "")),
                    AuthedChannel(conn, None), header)
        challenge = secrets.token_hex(fabric.NONCE_BYTES)
        send_frame(conn, {"type": "challenge", "nonce": challenge})
        header, _body = recv_frame(conn)
        if header.get("type") != "hello":
            raise FleetAuthError("first frame was not hello")
        worker_id = str(header.get("worker_id", ""))
        nonce = str(header.get("nonce", ""))
        if get_fault_plane().fire("remote_auth_fail") is not None:
            raise FleetAuthError("injected remote auth failure")
        if not nonce or nonce in self._hello_nonces:
            raise FleetAuthError("replayed or missing hello nonce")
        expected = fabric.hello_mac(secret, challenge, nonce, worker_id)
        if not hmac.compare_digest(str(header.get("mac", "")), expected):
            raise FleetAuthError("hello MAC mismatch")
        self._hello_nonces.add(nonce)
        while len(self._hello_nonces) > 4096:
            self._hello_nonces.pop()
        self._check_impl(header)
        send_frame(conn, {"type": "welcome",
                          "mac": fabric.welcome_mac(secret, challenge, nonce)})
        channel = AuthedChannel(conn,
                                fabric.session_key(secret, challenge, nonce),
                                send_label="c", recv_label="w")
        return worker_id, channel, header

    def _register_conn(self, conn: socket.socket, addr=None) -> None:
        """First contact: authenticate, then attach a seat this
        coordinator spawned or, for an authenticated worker id it never
        spawned, a new remote seat; then read the connection into the
        inbox."""
        peer = addr[0] if addr else "local"
        if self._peer_blocked(peer):
            self._reject(conn, "peer_blocked")
            return
        try:
            conn.settimeout(self.config.connect_timeout_s)
            worker_id, channel, header = self._handshake(conn)
            seat = self.seats.get(worker_id)
            if seat is None or seat.handle is None:
                if channel.key is None:
                    raise FrameError(
                        f"hello from unknown worker {worker_id!r}")
                seat = self._attach_remote(worker_id, peer)
            elif seat.dead and getattr(seat.handle, "remote", False):
                # a remote worker back after it was declared dead gets a
                # fresh seat; the old one stays a tombstone
                seat = self._attach_remote(worker_id, peer)
            conn.settimeout(None)
            seat.handle.attach(conn, channel)
            self.inbox.put((seat.worker_id, header, b""))
            self._reader_loop(seat.worker_id, conn, channel)
        except ForeignPeer as exc:
            self.stats.auth_rejects += 1
            self._strike(peer)
            log.warning("fleet: attach from %s rejected (%s)", peer, exc)
            self._reject(conn, "foreign_peer")
        except FleetAuthError as exc:
            self.stats.auth_rejects += 1
            self._strike(peer)
            log.warning("fleet: attach from %s rejected (%s)", peer, exc)
            self._reject(conn, "auth_failed")
        except (FrameError, OSError) as exc:
            self.stats.frame_rejects += 1
            self._strike(peer)
            log.debug("fleet: connection rejected (%s)", exc)
            self._reject(conn, "bad_frame")

    def _attach_remote(self, worker_id: str, peer: str) -> WorkerSeat:
        from mythril_tpu_torch.observability import spans as obs

        self.stats.remote_attaches += 1
        seat = WorkerSeat(worker_id=worker_id,
                          handle=RemoteWorkerHandle(worker_id),
                          spawned_at=self.clock())
        self.seats[worker_id] = seat
        obs.instant("fleet.remote_attach", cat="fleet", worker=worker_id,
                    peer=peer)
        log.info("fleet: remote worker %s attached from %s", worker_id,
                 peer)
        return seat

    def _reader_loop(self, worker_id: str, conn: socket.socket,
                     channel=None) -> None:
        from mythril_tpu_torch.resilience.faults import get_fault_plane

        while True:
            try:
                if get_fault_plane().fire("frame_corrupt") is not None:
                    recv_frame(conn)  # consume, then strike
                    raise FrameError("injected corrupt frame")
                if channel is not None:
                    header, body = channel.recv()
                else:
                    header, body = recv_frame(conn)
            except FleetAuthError as exc:
                self.stats.frame_rejects += 1
                self.inbox.put((worker_id, {
                    "type": "disconnect",
                    "reason": f"tampered frame: {exc}",
                }, b""))
                return
            except (FrameError, OSError) as exc:
                if (isinstance(exc, FrameError)
                        and "peer closed" not in str(exc)):
                    self.stats.frame_rejects += 1
                self.inbox.put((worker_id, {"type": "disconnect"}, b""))
                return
            self.inbox.put((worker_id, header, body))

    # ------------------------------------------------------------------
    # spawning
    # ------------------------------------------------------------------

    def _spawn(self, worker_id: str, respawn: bool):
        """Start a worker process that dials this coordinator (spawned,
        never forked); returns a :class:`WorkerProcess`, or None when the
        process could not start."""
        import mythril_tpu_torch

        python = os.environ.get("MYTHRIL_TPU_FLEET_PYTHON", sys.executable)
        env = dict(os.environ)
        env["MYTHRIL_TPU_FLEET_ROLE"] = "worker"
        env["MYTHRIL_TPU_CHECKPOINT_PERIOD"] = self.config.checkpoint_period_s
        repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(mythril_tpu_torch.__file__)))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        if respawn and env.get("MYTHRIL_TPU_FAULT"):
            # an armed worker_kill would fell every replacement at its
            # first boundary too: one armed shot is one death
            specs = [part for part in env["MYTHRIL_TPU_FAULT"].split(",")
                     if part.strip() and not part.strip().startswith(
                         "worker_kill")]
            if specs:
                env["MYTHRIL_TPU_FAULT"] = ",".join(specs)
            else:
                env.pop("MYTHRIL_TPU_FAULT", None)
        debug = os.environ.get("MYTHRIL_TPU_FLEET_DEBUG") == "1"
        stderr_fd = stderr_path = None
        if not debug:
            # stderr goes to a scratch file: its tail is the post-mortem
            stderr_fd, stderr_path = tempfile.mkstemp(
                prefix=f"mtpu-{worker_id}-", suffix=".stderr")
        try:
            proc = subprocess.Popen(
                [python, "-m", "mythril_tpu_torch.parallel.fleet",
                 "--worker", "--connect",
                 f"{self.connect_address()}:{self.port}", "--id", worker_id],
                env=env, cwd=repo_root,
                stdout=None if debug else subprocess.DEVNULL,
                stderr=None if debug else stderr_fd,
            )
        except OSError as exc:
            log.warning("fleet: worker spawn failed: %s", exc)
            if stderr_path is not None:
                os.unlink(stderr_path)
            return None
        finally:
            if stderr_fd is not None:
                os.close(stderr_fd)
        return WorkerProcess(worker_id, proc, stderr_path=stderr_path)

    def _new_seat(self, respawn: bool = False) -> Optional[WorkerSeat]:
        self._seat_seq += 1
        worker_id = f"w{self._seat_seq}"
        handle = self._spawner(worker_id, respawn)
        if handle is None:
            self._spawn_failures += 1
            return None
        seat = WorkerSeat(worker_id=worker_id, handle=handle,
                          spawned_at=self.clock())
        self.seats[worker_id] = seat
        return seat

    @staticmethod
    def _connected(seat: WorkerSeat) -> bool:
        """True once the worker's hello attached a connection (a test's
        fake handle without ``conn`` counts as connected)."""
        return getattr(seat.handle, "conn", True) is not None

    # ------------------------------------------------------------------
    # lease staging
    # ------------------------------------------------------------------

    def add_lease(self, journal_dir: str, tx_index: int,
                  n_states: int) -> Lease:
        self._lease_seq += 1
        lease = Lease(lease_id=f"lease{self._lease_seq}",
                      journal_dir=journal_dir, tx_index=tx_index,
                      n_states=n_states)
        lease.first_granted_at = self.clock()
        self.leases[lease.lease_id] = lease
        return lease

    def _restage(self, lease: Lease) -> None:
        """Copy the lease's newest journal generations into a fresh
        directory before leasing it again: the previous holder may still
        be writing into the old one."""
        from mythril_tpu_torch.resilience.checkpoint import _generations

        fresh = lease.journal_dir.rstrip(os.sep) + f".e{lease.epoch + 1}"
        os.makedirs(fresh, exist_ok=True)
        for _gen, path in _generations(lease.journal_dir)[-2:]:
            shutil.copy2(path, os.path.join(fresh, os.path.basename(path)))
        lease.journal_dir = fresh

    # ------------------------------------------------------------------
    # state machine: messages
    # ------------------------------------------------------------------

    def handle_message(self, worker_id: str, header: dict,
                       body: bytes) -> None:
        kind = header.get("type")
        seat = self.seats.get(worker_id)
        if seat is None:
            return
        if kind == "hello":
            return  # registration already attached the handle
        if kind == "disconnect":
            if not seat.dead:
                self._declare_dead(seat,
                                   header.get("reason", "connection lost"))
            return
        if kind == "heartbeat":
            self._on_heartbeat(seat, header, body)
        elif kind == "gossip":
            self._on_gossip(seat, header, body)
        elif kind == "checkpoint":
            self._on_checkpoint(seat, header, body)
        elif kind == "result":
            self._on_result(seat, header, body)
        elif kind == "error":
            self._on_error(seat, header)

    def _lease_of(self, seat: WorkerSeat) -> Optional[Lease]:
        return self.leases.get(seat.lease_id) if seat.lease_id else None

    @staticmethod
    def _stale(lease: Optional[Lease], header: dict) -> bool:
        """The epoch fence: a message stamped before the lease's current
        epoch, or naming a lease its sender no longer holds, is a
        zombie's."""
        if lease is None or header.get("lease_id") != lease.lease_id:
            return True
        return Stamp.from_header(header).lease_epoch != lease.epoch

    def _on_heartbeat(self, seat: WorkerSeat, header: dict,
                      body: bytes = b"") -> None:
        from mythril_tpu_torch.resilience.faults import get_fault_plane

        if get_fault_plane().fire("lease_partition") is not None:
            # an injected partition: the heartbeat never arrives, the TTL
            # sweep declares the worker dead, and the worker runs on as
            # the zombie the fence must reject
            return
        lease = self._lease_of(seat)
        if self._stale(lease, header):
            if body and header.get("persist"):
                self.stats.gossip_dropped_stale += 1
            return
        lease.last_heartbeat = self.clock()
        if body and header.get("persist"):
            # a knowledge delta rode the heartbeat (persist/plane.py):
            # routed like gossip (re-stamped for each recipient), then
            # made durable here
            if get_fault_plane().fire("gossip_drop") is not None:
                return
            self.stats.persist_deltas_applied += 1
            self.route_gossip(seat.worker_id, header, body)
            self._persist_absorb_gossip()

    def _on_gossip(self, seat: WorkerSeat, header: dict,
                   body: bytes) -> None:
        from mythril_tpu_torch.observability import spans as obs
        from mythril_tpu_torch.resilience.faults import get_fault_plane

        lease = self._lease_of(seat)
        if self._stale(lease, header):
            self.stats.gossip_dropped_stale += 1
            obs.instant("fleet.gossip_stale", cat="fleet",
                        worker=seat.worker_id)
            return
        lease.last_heartbeat = self.clock()
        if get_fault_plane().fire("gossip_drop") is not None:
            return  # an injected lossy channel: knowledge is optional
        self.route_gossip(seat.worker_id, header, body)

    def route_gossip(self, origin_id: str, header: dict,
                     body: bytes) -> None:
        """Apply to the coordinator's own context (it finishes leases
        in-process after a total loss) and forward to every other live
        leased worker, stamped with the recipient's lease epoch."""
        from mythril_tpu_torch.parallel import fleet as fleet_mod

        self.stats.gossip_sent += 1
        fleet_mod.apply_gossip_local(body)
        for seat in self.seats.values():
            if seat.worker_id == origin_id or seat.dead:
                continue
            lease = self._lease_of(seat)
            if lease is None or lease.state != RUNNING:
                continue
            seat.handle.send({
                "type": "gossip",
                "lease_id": lease.lease_id,
                "stamp": Stamp(lease_epoch=lease.epoch).as_dict(),
                "origin": origin_id,
            }, body)

    def _persist_absorb_gossip(self) -> None:
        """Re-freeze the merged blast context under the digest of the
        analysis this process last touched (a no-op when the knowledge
        plane is inert)."""
        from mythril_tpu_torch.parallel.gossip import ForeignKnowledge
        from mythril_tpu_torch.persist.plane import get_knowledge_plane
        from mythril_tpu_torch.smt.solver import get_blast_context

        plane = get_knowledge_plane()
        if not plane.active:
            return
        try:
            plane.absorb_gossip(plane.last_digest, get_blast_context())
        except (OSError, ForeignKnowledge) as exc:
            log.debug("fleet: persist absorb of routed gossip failed: %s",
                      exc)

    def _seed_gossip(self, lease: Lease, seat: WorkerSeat) -> None:
        """Warm a freshly granted seat with what the coordinator knows:
        one gossip frame behind the grant, under the lease's epoch
        (skipped when the body would not fit a frame or the knowledge
        plane's gossip is off)."""
        from mythril_tpu_torch.parallel.gossip import (
            freeze_knowledge,
            max_frame_bytes,
        )
        from mythril_tpu_torch.persist.plane import (
            get_knowledge_plane,
            gossip_enabled,
        )
        from mythril_tpu_torch.smt.solver import get_blast_context

        plane = get_knowledge_plane()
        if not (plane.active and gossip_enabled()):
            return
        body = freeze_knowledge(get_blast_context())
        if len(body) >= max_frame_bytes():
            return
        seat.handle.send({
            "type": "gossip",
            "lease_id": lease.lease_id,
            "stamp": Stamp(lease_epoch=lease.epoch).as_dict(),
            "origin": "coordinator",
        }, body)

    def _on_checkpoint(self, seat: WorkerSeat, header: dict,
                       body: bytes) -> None:
        """A remote worker shipped its boundary journal back: unpacked
        into the lease's directory, so that a re-lease resumes from this
        boundary."""
        lease = self._lease_of(seat)
        if self._stale(lease, header):
            self.stats.gossip_dropped_stale += 1
            return
        lease.last_heartbeat = self.clock()
        try:
            fabric.unpack_journal(body, lease.journal_dir)
        except (FrameError, OSError) as exc:
            log.warning("fleet: bad checkpoint from %s: %s",
                        seat.worker_id, exc)

    def _on_result(self, seat: WorkerSeat, header: dict,
                   body: bytes) -> None:
        lease = self._lease_of(seat)
        if self._stale(lease, header):
            # a zombie's late result: the new holder's is the one
            self.stats.gossip_dropped_stale += 1
            if (lease is None or lease.state != RUNNING
                    or lease.worker_id != seat.worker_id):
                seat.lease_id = None
            return
        if header.get("partial") and lease.splitting:
            # the drained straggler landed its boundary journal
            self._finish_split(seat, lease)
            return
        lease.state = DONE
        lease.result = header
        lease.result_body = body
        lease.worker_id = None
        seat.lease_id = None

    def _on_error(self, seat: WorkerSeat, header: dict) -> None:
        """A worker failed its lease.  An injected error
        (:data:`INJECTED_ERRORS`) takes the lease back, as the JAX
        package does for any error; any other raises
        :class:`FleetWorkerError`."""
        lease = self._lease_of(seat)
        if self._stale(lease, header):
            return
        message = header.get("message", "")
        if header.get("error_type") not in INJECTED_ERRORS:
            raise FleetWorkerError(
                f"worker {seat.worker_id} failed lease {lease.lease_id}: "
                f"{message}")
        log.warning("fleet: worker %s failed lease %s: %s",
                    seat.worker_id, lease.lease_id, message)
        self._revoke(lease, reason="worker error")
        seat.lease_id = None

    # ------------------------------------------------------------------
    # state machine: sweeps (expiry, stragglers, assignment)
    # ------------------------------------------------------------------

    def _declare_dead(self, seat: WorkerSeat, reason: str,
                      reap: bool = True) -> None:
        from mythril_tpu_torch.observability import spans as obs

        seat.dead = True
        self.stats.worker_deaths += 1
        obs.instant("fleet.worker_death", cat="fleet",
                    worker=seat.worker_id, reason=reason)
        log.warning("fleet: worker %s declared dead (%s)", seat.worker_id,
                    reason)
        lease = self._lease_of(seat)
        if reap and seat.handle is not None:
            seat.handle.kill()
        self._capture_postmortem(seat, lease, reason)
        if lease is not None and lease.state == RUNNING:
            self._revoke(lease, reason=reason)
        seat.lease_id = None

    def _capture_postmortem(self, seat: WorkerSeat, lease: Optional[Lease],
                            reason: str) -> None:
        """The last 4 KB of a dead worker's stderr, into the flight
        recorder and beside the journal it died at."""
        handle = seat.handle
        if handle is None or not hasattr(handle, "read_stderr_tail"):
            return
        tail = handle.read_stderr_tail()
        handle.discard_stderr()
        if not tail:
            return
        text = tail.decode("utf-8", "replace")
        from mythril_tpu_torch.observability.flight import get_flight_recorder

        get_flight_recorder().record({
            "kind": "worker_postmortem",
            "worker": seat.worker_id,
            "reason": reason,
            "stderr_tail": text[-2048:],
        })
        if lease is not None and os.path.isdir(lease.journal_dir):
            path = os.path.join(lease.journal_dir,
                                f"postmortem-{seat.worker_id}.txt")
            try:
                with open(path, "w", encoding="utf-8") as fh:
                    fh.write(f"worker {seat.worker_id} declared dead: "
                             f"{reason}\n\n{text}")
            except OSError:
                pass

    def _revoke(self, lease: Lease, reason: str) -> None:
        """Take a lease back: bump the epoch (fencing the old holder),
        re-stage the journal and queue it again, or fail it past the
        retry budget."""
        lease.attempts += 1
        lease.splitting = False
        self._restage(lease)
        lease.epoch += 1
        lease.worker_id = None
        if lease.attempts > self.config.lease_retries:
            lease.state = FAILED
            log.warning("fleet: lease %s failed after %d attempts (%s); "
                        "the coordinator finishes it in-process",
                        lease.lease_id, lease.attempts, reason)
        else:
            lease.state = PENDING

    def sweep(self, now: Optional[float] = None) -> None:
        """One pass of the failure detectors: heartbeat TTL expiry, the
        hard wall cap, straggler splitting."""
        now = self.clock() if now is None else now
        for seat in list(self.seats.values()):
            if seat.dead:
                continue
            lease = self._lease_of(seat)
            if lease is None or lease.state != RUNNING:
                if not self._connected(seat) and (
                        now - seat.spawned_at > self.config.connect_timeout_s):
                    self._declare_dead(seat, "never connected")
                continue
            quiet_s = now - max(lease.last_heartbeat, lease.granted_at)
            if quiet_s > self.config.lease_ttl_s:
                # unreachable, not provably dead: across a partition
                # there is no process to kill; the seat is fenced and
                # the worker, if alive, reaped at shutdown
                self._declare_dead(
                    seat, f"lease TTL expired ({quiet_s:.1f}s quiet)",
                    reap=False)
            elif now - lease.granted_at > self.config.hard_cap_s:
                self._declare_dead(seat, "lease hard cap exceeded")
        self._maybe_split(now)

    def _idle_seats(self) -> List[WorkerSeat]:
        return [seat for seat in self.seats.values()
                if not seat.dead and seat.lease_id is None
                and self._connected(seat)]

    def _maybe_split(self, now: float) -> None:
        """While a seat idles, drain a multi-state lease that runs past
        the split threshold: its boundary journal becomes two leases."""
        if not self.config.split_after_s or not self._idle_seats():
            return
        for lease in self.leases.values():
            if (lease.state == RUNNING and not lease.splitting
                    and lease.n_states >= 2
                    and now - lease.granted_at > self.config.split_after_s):
                seat = self.seats.get(lease.worker_id)
                if seat is None or seat.dead:
                    continue
                log.info("fleet: splitting straggler lease %s (worker %s)",
                         lease.lease_id, seat.worker_id)
                lease.splitting = True
                seat.handle.drain()
                return  # one split per sweep

    def _finish_split(self, seat: WorkerSeat, lease: Lease) -> None:
        """The drained straggler reported partial: carve its journaled
        frontier into two new leases."""
        from mythril_tpu_torch.parallel import fleet as fleet_mod

        halves = fleet_mod.split_lease_journal(lease.journal_dir)
        seat.lease_id = None
        if halves is None:
            # nothing to carve (one state left): an ordinary re-lease;
            # the drained worker exits (its drain flag is sticky)
            self._revoke(lease, reason="split found nothing to carve")
            self._declare_dead(seat, "drained for split")
            return
        lease.state = DONE
        lease.result = {"type": "result", "split": True,
                        "lease_id": lease.lease_id,
                        "found_swcs": [], "partial": False}
        lease.result_body = None
        for journal_dir, tx_index, n_states in halves:
            self.add_lease(journal_dir, tx_index, n_states)
        self.stats.rebalances += 1
        self.stats.leases += len(halves)
        self._declare_dead(seat, "drained for split")

    def assign(self) -> None:
        """Grant pending leases to idle seats; spawn replacements while
        the spawn budget allows."""
        pending = [lease for lease in self.leases.values()
                   if lease.state == PENDING]
        if not pending:
            return
        idle = self._idle_seats()
        for lease in pending:
            if not idle:
                # a replacement is grantable once its hello attaches
                self._maybe_respawn()
                return
            self._grant(lease, idle.pop(0))

    def _maybe_respawn(self) -> Optional[WorkerSeat]:
        live = [s for s in self.seats.values() if not s.dead]
        if len(live) >= self.config.workers:
            return None
        budget = self.config.workers * (1 + self.config.spawn_retries)
        if len(self.seats) + self._spawn_failures >= budget:
            return None
        return self._new_seat(respawn=bool(self.seats))

    def _grant(self, lease: Lease, seat: WorkerSeat) -> None:
        from mythril_tpu_torch.observability import spans as obs

        now = self.clock()
        lease.state = RUNNING
        lease.worker_id = seat.worker_id
        lease.granted_at = now
        lease.last_heartbeat = now
        if not lease.first_granted_at:
            lease.first_granted_at = now
        seat.lease_id = lease.lease_id
        self.stats.leases += 1
        obs.instant("fleet.lease_grant", cat="fleet", lease=lease.lease_id,
                    worker=seat.worker_id, epoch=lease.epoch,
                    states=lease.n_states)
        header = {
            "type": "lease",
            "lease_id": lease.lease_id,
            "stamp": Stamp(lease_epoch=lease.epoch).as_dict(),
            "journal_dir": lease.journal_dir,
            "tx_index": lease.tx_index,
            "payload": (lease.payload if lease.payload is not None
                        else self.lease_payload),
            "heartbeat_s": self.config.heartbeat_s,
        }
        body = b""
        if getattr(seat.handle, "remote", False):
            # no shared filesystem: the grant carries the journal
            header["journal_wire"] = True
            body = fabric.pack_journal(lease.journal_dir)
        if not seat.handle.send(header, body):
            # the connection died between attach and grant
            self._declare_dead(seat, "grant send failed")
            return
        self._seed_gossip(lease, seat)

    def cancel_lease(self, lease_id: str, reason: str = "cancelled") -> bool:
        """Revoke a lease for good: fence its epoch, tell the holder to
        stop at its next boundary, and retire it as DONE with a
        cancelled marker."""
        from mythril_tpu_torch.observability import spans as obs

        lease = self.leases.get(lease_id)
        if lease is None or lease.state in (DONE, FAILED):
            return False
        holder = self.seats.get(lease.worker_id) if lease.worker_id else None
        if holder is not None and holder.handle is not None:
            holder.handle.send({
                "type": "revoke",
                "lease_id": lease.lease_id,
                "stamp": Stamp(lease_epoch=lease.epoch).as_dict(),
                "reason": reason,
            })
            holder.lease_id = None
        lease.epoch += 1
        lease.worker_id = None
        lease.state = DONE
        lease.result = {"type": "result", "lease_id": lease.lease_id,
                        "cancelled": True, "found_swcs": [],
                        "partial": True}
        lease.result_body = None
        obs.instant("fleet.lease_cancel", cat="fleet", lease=lease.lease_id,
                    reason=reason)
        return True

    # ------------------------------------------------------------------
    # live introspection
    # ------------------------------------------------------------------

    def debug_status(self) -> dict:
        """Every lease's state, epoch, attempts and holder, every seat's
        liveness, and the run's trace id."""
        from mythril_tpu_torch.observability import get_trace_id

        now = self.clock()
        return {
            "role": "coordinator",
            "trace_id": get_trace_id(),
            "leases": [
                {
                    "lease_id": lease.lease_id,
                    "state": lease.state,
                    "epoch": lease.epoch,
                    "attempts": lease.attempts,
                    "worker": lease.worker_id,
                    "states": lease.n_states,
                    "tx_index": lease.tx_index,
                    "running_s": (round(now - lease.granted_at, 1)
                                  if lease.state == RUNNING else None),
                }
                for lease in sorted(self.leases.values(),
                                    key=lambda l: l.lease_id)
            ],
            "seats": [
                {
                    "worker_id": seat.worker_id,
                    "dead": seat.dead,
                    "lease": seat.lease_id,
                    "connected": self._connected(seat),
                    "remote": bool(getattr(seat.handle, "remote", False)),
                }
                for seat in sorted(self.seats.values(),
                                   key=lambda s: s.worker_id)
            ],
            "listen": f"{self.config.listen_host}:{self.port or 0}",
            "authenticated": self.config.secret is not None,
            "struck_peers": len(self._strikes),
        }

    def open_debug_listener(self) -> Optional[int]:
        """The localhost HTTP debug plane (``MYTHRIL_TPU_FLEET_DEBUG_PORT``;
        0 = ephemeral): ``/debug/requests`` (:meth:`debug_status`) and
        ``/debug/lanes`` (this process's ledger aggregates).  Returns the
        bound port, or None when the knob is unset."""
        import json as _json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        port_env = os.environ.get("MYTHRIL_TPU_FLEET_DEBUG_PORT")
        if port_env is None:
            return None
        try:
            port = int(port_env)
        except ValueError:
            return None
        coordinator = self

        class _DebugHandler(BaseHTTPRequestHandler):
            def log_message(self, format, *args):  # noqa: A002
                pass

            def do_GET(self):
                from mythril_tpu_torch.observability.ledger import get_ledger

                path = self.path.split("?", 1)[0]
                if path == "/debug/requests":
                    body = coordinator.debug_status()
                elif path == "/debug/lanes":
                    body = get_ledger().snapshot()
                else:
                    body = {"error": {"code": "not_found"}}
                payload = _json.dumps(body).encode("utf-8")
                self.send_response(404 if "error" in body else 200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._debug_httpd = ThreadingHTTPServer(("127.0.0.1", port),
                                                _DebugHandler)
        self._debug_httpd.daemon_threads = True
        threading.Thread(target=self._debug_httpd.serve_forever,
                         name="fleet-debug-http", daemon=True).start()
        return self._debug_httpd.server_address[1]

    def close_debug_listener(self) -> None:
        httpd = getattr(self, "_debug_httpd", None)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            self._debug_httpd = None

    # ------------------------------------------------------------------
    # the run loop
    # ------------------------------------------------------------------

    def unfinished(self) -> List[Lease]:
        return [lease for lease in self.leases.values()
                if lease.state != DONE]

    def finished(self) -> List[Lease]:
        return [lease for lease in self.leases.values()
                if lease.state == DONE and lease.result is not None]

    def _alive_possible(self) -> bool:
        """False once no seat lives and none can be spawned."""
        if any(not seat.dead for seat in self.seats.values()):
            return True
        return len(self.seats) + self._spawn_failures < (
            self.config.workers * (1 + self.config.spawn_retries))

    def run(self) -> None:
        """Drive the leases to DONE or FAILED (the caller finishes a
        FAILED one in-process); returns when none is open or the fleet
        cannot make progress.  Raises :class:`FleetWorkerError` when a
        worker reports an error the fleet did not inject."""
        from mythril_tpu_torch.resilience.checkpoint import drain_requested

        for _ in range(min(self.config.workers, max(1, len(self.leases)))):
            self._new_seat(respawn=False)
        while True:
            if not any(lease.state in (PENDING, RUNNING)
                       for lease in self.leases.values()):
                return
            if drain_requested() and not self._drained:
                # forwarded: workers journal and report partial results
                self._drained = True
                for seat in self.seats.values():
                    if not seat.dead and seat.handle is not None:
                        seat.handle.drain()
            self.assign()
            if not any(lease.state == RUNNING
                       for lease in self.leases.values()) \
                    and not self._alive_possible():
                log.warning("fleet: no live workers and spawn budget "
                            "exhausted; finishing in-process")
                return
            try:
                worker_id, header, body = self.inbox.get(
                    timeout=min(0.25, self.config.heartbeat_s))
            except queue.Empty:
                self.sweep()
                continue
            self.handle_message(worker_id, header, body)
            self.sweep()

    def shutdown(self) -> None:
        """Close the listeners, tell every seat to stop, and reap every
        spawned process (SIGKILL after 5 s)."""
        self.close_listener()
        self.close_debug_listener()
        for seat in self.seats.values():
            if seat.handle is not None:
                seat.handle.send({"type": "shutdown"})
        deadline = time.monotonic() + 5.0
        for seat in self.seats.values():
            handle = seat.handle
            if handle is None:
                continue
            proc = getattr(handle, "proc", None)
            if proc is not None:
                try:
                    proc.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
            handle.kill()
            if hasattr(handle, "discard_stderr"):
                handle.discard_stderr()
