"""Frames, epoch stamps and knowledge for the fleet (own copy of
``mythril_tpu/parallel/gossip.py``).

1. **Framing**: one socket message is a length-prefixed JSON header and
   a length-prefixed binary body (a pickle, or empty), byte for byte the
   JAX package's frame.  Both length prefixes are checked against the
   ``MYTHRIL_TPU_FLEET_MAX_FRAME`` cap before anything is allocated; an
   oversized or malformed frame raises :class:`FrameError` at the
   boundary it arrived on.
2. **Stamps**: every knowledge and result message carries the sender's
   ``(generation, pool_version, lease_epoch)``.  The coordinator bumps
   ``lease_epoch`` on every re-lease, so a zombie worker's late messages
   carry a stale epoch and are dropped (``coordinator.py``).
3. **Knowledge freeze and monotone apply**: the globally valid solver
   channels of a blast context (the permanent UNSAT memo, the SAT half
   of the probe memo, the recent models) cross processes in the
   checkpoint plane's journal form (``resilience/checkpoint.py``:
   :func:`freeze_channels` with node objects for node ids, pickled by
   :func:`dumps`, re-interned on load), and are applied MONOTONICALLY:
   an apply only adds memo entries and models, so a knowledge body can
   widen what a context knows but never invalidate it.  Literal-level
   state (CNF pool rows, device nogoods, a model's truth row) never
   crosses: literal numbering is an artifact of each process's blast
   order.

A knowledge body is unpickled by :class:`KnowledgeUnpickler`, which
resolves only the globals the port's own freeze writes.  A body written
by the JAX package (whose reducers name ``mythril_tpu`` functions), by
another format, or anything else is refused with
:class:`ForeignKnowledge` before any of it is built; the knowledge plane
counts that as a thaw error and starts cold.  A tensor in a body (the
journal reducers store one as host numpy with its device type) is
rebuilt only on the device type of the run that reads it: a body written
on the card never moves its tensors to the CPU, nor the reverse.
"""

import io
import json
import pickle
import struct
from dataclasses import dataclass

#: frame caps: a header is routing metadata, a body at most a frontier
#: snapshot or a channel freeze; past these the peer is garbage or
#: hostile
MAX_HEADER_BYTES = 1 << 20
MAX_BODY_BYTES = 1 << 30

#: default of ``MYTHRIL_TPU_FLEET_MAX_FRAME``: the cap a receiver holds
#: a length prefix to before it allocates or unpickles anything (the
#: prefix comes from a peer that may not have authenticated)
DEFAULT_MAX_FRAME = 1 << 27

_HEADER_LEN = struct.Struct("!I")
_BODY_LEN = struct.Struct("!Q")


def max_frame_bytes() -> int:
    """The receive cap (``MYTHRIL_TPU_FLEET_MAX_FRAME``, floor 4096 so
    that the knob cannot refuse the control frames)."""
    from mythril_tpu_torch.support.env import env_int

    return env_int("MYTHRIL_TPU_FLEET_MAX_FRAME", DEFAULT_MAX_FRAME,
                   floor=4096)


class FrameError(RuntimeError):
    """A malformed or oversized frame, or a peer that hung up mid-frame;
    the connection is unusable after it."""


@dataclass(frozen=True)
class Stamp:
    """The epoch fence every gossip and result message carries."""

    generation: int = 0
    pool_version: int = 0
    lease_epoch: int = 0

    def as_dict(self) -> dict:
        return {
            "generation": int(self.generation),
            "pool_version": int(self.pool_version),
            "lease_epoch": int(self.lease_epoch),
        }

    @classmethod
    def from_header(cls, header: dict) -> "Stamp":
        stamp = header.get("stamp") or {}
        return cls(
            generation=int(stamp.get("generation", 0)),
            pool_version=int(stamp.get("pool_version", 0)),
            lease_epoch=int(stamp.get("lease_epoch", 0)),
        )


def stamp_for(ctx, lease_epoch: int) -> Stamp:
    """The current stamp of a blast context under a lease."""
    return Stamp(
        generation=getattr(ctx, "generation", 0),
        pool_version=getattr(ctx, "pool_version", 0),
        lease_epoch=lease_epoch,
    )


def send_frame(sock, header: dict, body: bytes = b"") -> None:
    """Write one frame (the caller serialises concurrent senders).  The
    sender holds the receiver's cap too, so an oversized body fails here
    and names the knob."""
    cap = min(MAX_BODY_BYTES, max_frame_bytes())
    head = json.dumps(header).encode("utf-8")
    if len(head) > MAX_HEADER_BYTES:
        raise FrameError(f"header too large ({len(head)} bytes)")
    if len(body) > cap:
        raise FrameError(
            f"body too large ({len(body)} bytes; "
            f"MYTHRIL_TPU_FLEET_MAX_FRAME is {cap})")
    sock.sendall(_HEADER_LEN.pack(len(head)) + head
                 + _BODY_LEN.pack(len(body)) + body)


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise FrameError("peer closed mid-frame")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock, max_frame: int = None):
    """Read one frame: ``(header dict, body bytes)``.  Raises
    :class:`FrameError` on a truncation, a length past the cap (checked
    before any allocation) or a header that is not a JSON object with a
    ``type``."""
    cap = max_frame_bytes() if max_frame is None else max_frame
    (head_len,) = _HEADER_LEN.unpack(_recv_exact(sock, _HEADER_LEN.size))
    if head_len > min(MAX_HEADER_BYTES, cap):
        raise FrameError(f"header length {head_len} exceeds cap")
    head = _recv_exact(sock, head_len)
    try:
        header = json.loads(head.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise FrameError(f"bad frame header: {exc}") from exc
    if not isinstance(header, dict) or "type" not in header:
        raise FrameError("frame header must be an object with a 'type'")
    (body_len,) = _BODY_LEN.unpack(_recv_exact(sock, _BODY_LEN.size))
    if body_len > min(MAX_BODY_BYTES, cap):
        raise FrameError(
            f"body length {body_len} exceeds cap "
            f"(MYTHRIL_TPU_FLEET_MAX_FRAME={cap})")
    body = _recv_exact(sock, body_len) if body_len else b""
    return header, body


#: the tag of this package's knowledge bodies
KNOWLEDGE_FORMAT = "mythril_tpu_torch.knowledge/1"


class ForeignKnowledge(pickle.UnpicklingError):
    """A knowledge body this package did not write (or not for this
    run's device type)."""


def _run_device_type() -> str:
    """``"cuda"`` or ``"cpu"``: where this run's solver tiers are
    (``args.device``; the card unless the caller asked for the CPU)."""
    from mythril_tpu_torch.support.support_args import args

    return "cpu" if str(args.device or "cuda").startswith("cpu") else "cuda"


class KnowledgeUnpickler(pickle.Unpickler):
    """Unpickler of knowledge bodies: resolves the journal's node and
    tensor reducers of this package and the builtins and numpy scalars
    a frozen channel holds, nothing else; rebuilds a tensor only on
    ``device_type``."""

    _BUILTINS = frozenset(("set", "frozenset", "complex", "bytearray"))
    _NUMPY = frozenset((
        ("numpy", "dtype"), ("numpy", "ndarray"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
    ))

    def __init__(self, file, device_type: str):
        super().__init__(file)
        self.device_type = device_type

    def find_class(self, module, name):
        from mythril_tpu_torch.resilience import checkpoint

        if module == checkpoint.__name__:
            if name == "_reintern_node":
                return checkpoint._reintern_node
            if name == "_tensor_from_host":
                return self._tensor_on_run_device
        elif module == "builtins" and name in self._BUILTINS:
            return super().find_class(module, name)
        elif (module, name) in self._NUMPY:
            return super().find_class(module, name)
        raise ForeignKnowledge(
            f"knowledge body names {module}.{name}: not a body of this "
            f"package")

    def _tensor_on_run_device(self, array, device_type):
        from mythril_tpu_torch.resilience.checkpoint import (
            _tensor_from_host,
        )

        if device_type != self.device_type:
            raise ForeignKnowledge(
                f"knowledge body holds a {device_type} tensor; this run "
                f"is on {self.device_type}")
        return _tensor_from_host(array, device_type)


def freeze_knowledge(ctx) -> bytes:
    """Snapshot the globally valid channels of ``ctx`` in journal form
    (node-object keys, re-interned on load)."""
    from mythril_tpu_torch.resilience.checkpoint import (
        dumps, freeze_channels,
    )

    return dumps({"format": KNOWLEDGE_FORMAT,
                  "channels": freeze_channels(ctx)})


def thaw_knowledge(body: bytes) -> dict:
    """The frozen channels of a body this package wrote; raises
    :class:`ForeignKnowledge` (an ``UnpicklingError``) for any other."""
    payload = KnowledgeUnpickler(io.BytesIO(body),
                                 _run_device_type()).load()
    if not isinstance(payload, dict) or payload.get(
            "format") != KNOWLEDGE_FORMAT:
        raise ForeignKnowledge("knowledge body without this package's "
                               "format tag")
    return payload["channels"]


def apply_knowledge(ctx, body: bytes) -> dict:
    """Monotonically merge a frozen channel snapshot into ``ctx``: UNSAT
    memo entries and SAT probe memos are added if absent, models extend
    the recent set (newest-first insertion, the existing cap kept).
    Never removes or overwrites, so findings do not depend on what was
    applied.  Returns counts for telemetry."""
    from mythril_tpu_torch.resilience.checkpoint import _thaw_env

    channels = thaw_knowledge(body)
    added_unsat = added_probe = added_models = 0
    for nodes in channels.get("unsat_sets", ()):
        key = tuple(sorted(n.id for n in nodes))
        if key not in ctx.unsat_memo:
            ctx.note_unsat(nodes)
            added_unsat += 1
    for nodes, frozen in channels.get("probe_sat", ()):
        key = tuple(sorted(n.id for n in nodes))
        if key not in ctx.probe_memo:
            ctx.probe_memo[key] = _thaw_env(frozen)
            added_probe += 1
    for frozen in channels.get("models", ()):
        env = _thaw_env(frozen)
        before = len(ctx.recent_models)
        ctx._remember_model(env)
        if len(ctx.recent_models) >= before:
            added_models += 1
    return {
        "unsat": added_unsat,
        "probe_sat": added_probe,
        "models": added_models,
    }
