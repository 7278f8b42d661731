"""Disk-backed, append-only knowledge segments (own copy of
``mythril_tpu/persist/store.py``; the segment format is the JAX
package's byte for byte, so either package reads the other's store).

The store is a directory of immutable segment files::

    seg-<epoch 8d>-<seq 8d>.bin          one flush each, atomic
    writer.lock                          flock'd for the writer's life
    *.quarantined                        corrupt segments, set aside

Each segment is ``MAGIC | version u32 | epoch u64`` followed by
records; each record is ``crc32 u32 | meta_len u32 | payload_len u64``
over a JSON meta object (``{"kind": ..., "key": ...}``) and an opaque
payload (the plane pickles through the checkpoint reducers, but the
store never unpickles — payload bytes stay opaque so a version-skewed
body can only fail at apply time, where the plane degrades it to a
miss, never at load).

Durability and integrity posture, in order of severity:

- **Atomic flush**: a flush writes ONE new segment via tmp + fsync +
  rename.  A SIGKILL mid-flush leaves a ``.seg.tmp`` that no loader
  ever reads; the previous segments are untouched.
- **Quarantine, never crash**: a segment failing ANY validation (bad
  magic, version skew, truncated or CRC-mismatched record) is renamed
  to ``<name>.quarantined`` and contributes nothing — the
  ``persist_corrupt_segments`` counter is the only evidence, and the
  process simply starts colder.  A quarantine rename that itself fails
  (read-only dir) degrades to skipping the segment in memory.
- **Single writer**: an exclusive ``flock`` on ``writer.lock`` held for
  the process lifetime.  A second process sharing the dir loads
  read-only (warm starts still work; its learnings just aren't
  persisted) — two writers can never interleave segments.
- **Epoch fencing**: each writer stamps segments with
  ``max(existing epochs) + 1``.  Load order is (epoch, seq) ascending
  with last-record-wins, so a restarted writer's segments supersede
  its predecessor's even if sequence numbers collide.
- **Compaction**: when live segments exceed the cap
  (``MYTHRIL_TPU_PERSIST_CAP_MB``), the live table is rewritten as one
  fresh segment and the old generation is unlinked — the append-only
  journal stays generation-capped like the checkpoint plane's.
"""

import json
import logging
import os
import struct
import threading
import zlib
from typing import Dict, Optional, Tuple

log = logging.getLogger(__name__)

MAGIC = b"MTPUKNOW"
STORE_VERSION = 1
_SEG_HEADER = struct.Struct("<IQ")    # version u32 | epoch u64
_REC_HEADER = struct.Struct("<IIQ")   # crc32 u32 | meta_len u32 | payload_len u64

#: flush cap default: segments past this total rewrite into one
DEFAULT_CAP_MB = 64.0


class StoreCorrupt(RuntimeError):
    """One segment failed validation.  Internal to :meth:`_read_segment`
    — load() converts every instance into a quarantine, never a raise
    past the store boundary."""


def cap_bytes() -> int:
    from mythril_tpu_torch.support.env import env_float

    return int(
        env_float("MYTHRIL_TPU_PERSIST_CAP_MB", DEFAULT_CAP_MB, floor=1.0)
        * (1 << 20)
    )


class SegmentStore:
    """The on-disk half of the knowledge plane: a (kind, key) ->
    payload-bytes table backed by append-only segments.  Thread-safe:
    an analysis's absorb and the exit-time flush may meet."""

    def __init__(self, directory: str):
        self.directory = directory
        self._lock = threading.Lock()
        self._table: Dict[Tuple[str, str], bytes] = {}
        self._dirty: Dict[Tuple[str, str], bytes] = {}
        self._lock_fh = None
        self.read_only = False
        self.epoch = 0
        self._seq = 0
        self.corrupt_segments = 0
        self.flushes = 0
        self.loaded_records = 0

    # -- writer lock + epoch -------------------------------------------

    def open(self) -> "SegmentStore":
        """Create the directory, take the writer lock (or degrade to
        read-only), establish this writer's epoch, and load every valid
        segment.  Never raises: an unusable directory just yields an
        empty, read-only store (a cold start)."""
        try:
            os.makedirs(self.directory, exist_ok=True)
        except OSError as exc:
            log.warning("persist: cannot create %s (%s); running "
                        "without a store", self.directory, exc)
            self.read_only = True
            return self
        self._acquire_writer_lock()
        self.load()
        self.epoch = 1 + max(
            (e for e, _, _ in self._segments()), default=self.epoch
        )
        return self

    def _acquire_writer_lock(self) -> None:
        path = os.path.join(self.directory, "writer.lock")
        try:
            import fcntl

            fh = open(path, "a+b")
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            self._lock_fh = fh  # held (and the fd pinned) for process life
        except OSError as exc:
            log.warning(
                "persist: %s is locked by another writer (%s); "
                "loading read-only — this process's learnings will "
                "not be persisted", self.directory, exc,
            )
            self.read_only = True

    def close(self) -> None:
        with self._lock:
            if self._lock_fh is not None:
                try:
                    self._lock_fh.close()
                except OSError:
                    pass
                self._lock_fh = None

    # -- segment enumeration -------------------------------------------

    def _segments(self):
        """[(epoch, seq, path)] ascending — the load/supersede order."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("seg-") and name.endswith(".bin")):
                continue
            parts = name[4:-4].split("-")
            try:
                out.append((int(parts[0]), int(parts[1]),
                            os.path.join(self.directory, name)))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    # -- load + quarantine ---------------------------------------------

    @staticmethod
    def _read_segment(path: str):
        """[(kind, key, payload)] of one segment, validated end to end
        BEFORE anything merges — a segment is all-or-nothing, so a
        corrupt tail can never leak its valid prefix into the table."""
        with open(path, "rb") as fh:
            raw = fh.read()
        if raw[: len(MAGIC)] != MAGIC:
            raise StoreCorrupt(f"{path}: bad magic")
        off = len(MAGIC)
        if len(raw) < off + _SEG_HEADER.size:
            raise StoreCorrupt(f"{path}: truncated header")
        version, _epoch = _SEG_HEADER.unpack_from(raw, off)
        if version != STORE_VERSION:
            raise StoreCorrupt(
                f"{path}: store version {version} != {STORE_VERSION}"
            )
        off += _SEG_HEADER.size
        records = []
        while off < len(raw):
            if len(raw) - off < _REC_HEADER.size:
                raise StoreCorrupt(f"{path}: truncated record header")
            crc, meta_len, payload_len = _REC_HEADER.unpack_from(raw, off)
            off += _REC_HEADER.size
            end = off + meta_len + payload_len
            if end > len(raw):
                raise StoreCorrupt(f"{path}: truncated record body")
            body = raw[off:end]
            if zlib.crc32(body) != crc:
                raise StoreCorrupt(f"{path}: record CRC mismatch")
            try:
                meta = json.loads(body[:meta_len].decode("utf-8"))
                kind, key = meta["kind"], meta["key"]
            except (ValueError, KeyError, TypeError) as exc:
                # the meta is untrusted: anything but a JSON object with
                # both keys is a corrupt record
                raise StoreCorrupt(f"{path}: bad record meta ({exc})")
            records.append((str(kind), str(key), body[meta_len:]))
            off = end
        return records

    def _quarantine(self, path: str, why: str) -> None:
        from mythril_tpu_torch.resilience.telemetry import resilience_stats

        self.corrupt_segments += 1
        resilience_stats.persist_corrupt_segments += 1
        log.warning("persist: quarantining corrupt segment (%s)", why)
        try:
            os.rename(path, path + ".quarantined")
        except OSError:
            pass  # read-only dir: skipping in memory is the degrade

    def load(self) -> int:
        """(Re)build the live table from disk; returns the number of
        live records.  Corrupt segments quarantine; nothing raises."""
        with self._lock:
            self._table.clear()
            for _epoch, _seq, path in self._segments():
                try:
                    records = self._read_segment(path)
                except StoreCorrupt as exc:
                    self._quarantine(path, str(exc))
                    continue
                except OSError as exc:
                    log.warning("persist: unreadable segment %s (%s)",
                                path, exc)
                    continue
                for kind, key, payload in records:
                    self._table[(kind, key)] = payload
            self.loaded_records = len(self._table)
            return self.loaded_records

    # -- the table ------------------------------------------------------

    def get(self, kind: str, key: str) -> Optional[bytes]:
        with self._lock:
            return self._table.get((kind, key))

    def put(self, kind: str, key: str, payload: bytes) -> None:
        """Stage one record; durable at the next :meth:`flush`.  A
        re-put of identical bytes is dropped (heartbeat-cadence absorbs
        would otherwise grow segments with no-op records)."""
        with self._lock:
            slot = (kind, key)
            if self._table.get(slot) == payload:
                return
            self._table[slot] = payload
            self._dirty[slot] = payload

    def keys(self, kind: str):
        with self._lock:
            return [k for (kd, k) in self._table if kd == kind]

    @property
    def dirty(self) -> bool:
        return bool(self._dirty)

    def __len__(self) -> int:
        return len(self._table)

    # -- flush + compaction ---------------------------------------------

    @staticmethod
    def _encode(records) -> bytes:
        chunks = []
        for (kind, key), payload in records:
            meta = json.dumps({"kind": kind, "key": key}).encode("utf-8")
            body = meta + payload
            chunks.append(
                _REC_HEADER.pack(zlib.crc32(body), len(meta), len(payload))
            )
            chunks.append(body)
        return b"".join(chunks)

    def _write_segment(self, records) -> str:
        self._seq += 1
        final = os.path.join(
            self.directory, f"seg-{self.epoch:08d}-{self._seq:08d}.bin"
        )
        tmp = os.path.join(self.directory, ".seg.tmp")
        blob = (MAGIC + _SEG_HEADER.pack(STORE_VERSION, self.epoch)
                + self._encode(records))
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.rename(tmp, final)
        return final

    def flush(self) -> bool:
        """Persist staged records as one new segment; True when a
        segment was written.  A failure (full disk, injected fault)
        keeps the records staged for the next flush — losing warm
        state is always preferable to losing the analysis."""
        with self._lock:
            if not self._dirty or self.read_only:
                return False
            from mythril_tpu_torch.resilience.faults import (
                FaultInjected, get_fault_plane,
            )

            try:
                if get_fault_plane().fire("persist_flush") is not None:
                    raise FaultInjected("injected persist_flush failure")
                self._write_segment(sorted(self._dirty.items()))
            except (FaultInjected, OSError) as exc:
                log.warning("persist: flush failed (%s); records stay "
                            "staged", exc)
                return False
            self._dirty.clear()
            self.flushes += 1
            self._maybe_compact_locked()
            return True

    def _maybe_compact_locked(self) -> None:
        segments = self._segments()
        total = 0
        for _, _, path in segments:
            try:
                total += os.path.getsize(path)
            except OSError:
                continue
        if total <= cap_bytes() or len(segments) <= 1:
            return
        try:
            fresh = self._write_segment(sorted(self._table.items()))
        except OSError as exc:
            log.warning("persist: compaction write failed (%s)", exc)
            return
        for _, _, path in segments:
            if path == fresh:
                continue
            try:
                os.unlink(path)
            except OSError:
                pass
        log.info("persist: compacted %d segments (%d bytes) into %s",
                 len(segments), total, os.path.basename(fresh))
