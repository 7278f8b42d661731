"""Process-level orchestration of the knowledge store (own copy of
``mythril_tpu/persist/plane.py``).

One :class:`KnowledgePlane` per process mediates between the segment
store (:mod:`mythril_tpu_torch.persist.store`) and the live solver state:

- **Warm start / absorb** — ``analysis/symbolic.SymExecWrapper`` calls
  :meth:`warm_start` before ``sym_exec`` and :meth:`absorb` after, so
  every entry path (the CLI, ``MythrilAnalyzer``) shares one seam.
  Channel snapshots are keyed by the bytecode digest and stored in the
  checkpoint plane's frozen form (node objects; re-interned on thaw),
  which subsumes per-``pc`` keying: memo entries inside a snapshot are
  constraint-set-keyed, so a near-identical clone of a seen contract
  still hits on every shared cone.  Application is MONOTONE
  (``parallel/gossip.apply_knowledge``): a thaw only ever widens what
  the context knows, so verdicts cannot depend on what was persisted.
- **Autopilot EWMAs** — the cost model's cells ride along under the
  ``autopilot`` kind, merged cell-wise (largest sample count wins).
- **Report cache** — finished, non-partial responses are stored
  under a key derived from (bytecode digest, tx_count, max_depth,
  module set, tool version), so that an exact re-submission can be
  answered without analysis, and any module-set or version change
  misses by key construction (its callers: the serve engine stores a
  finished request's body, ``serve/admission.py`` answers an exact
  re-submission from it at the admission edge).
- **Flush cadence** — dirty records flush on an operator timer
  (``MYTHRIL_TPU_PERSIST_FLUSH_S``) and at process exit (atexit), each
  flush one atomic segment.
- **Gossip** — :meth:`encode_heartbeat_delta` /
  :meth:`absorb_gossip` let fleet heartbeats carry knowledge deltas
  between seats (``MYTHRIL_TPU_PERSIST_GOSSIP``): a worker's heartbeat
  carries a delta when its channels changed (``fleet_persist_deltas_sent``),
  and the coordinator applies it, routes it to the other seats and
  absorbs it under :attr:`KnowledgePlane.last_digest`
  (``fleet_persist_deltas_applied``; ``parallel/coordinator.py``).

A channel body is this package's own (``parallel/gossip.py``): a body
written by the JAX package, or one that would rebuild a tensor on
another device type than the run's, is a thaw error and the analysis
starts cold (``thaw_errors``).

Gating: the plane is inert unless a directory is configured
(``MYTHRIL_TPU_PERSIST_DIR`` / ``--persist-dir``) AND the
``MYTHRIL_TPU_PERSIST`` kill switch is on.  Inert means every hook
returns immediately — the in-memory-only code path is unchanged.
"""

import atexit
import hashlib
import io
import json
import logging
import os
import pickle
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)

DEFAULT_FLUSH_S = 30.0

#: record kinds in the segment store
KIND_CHANNELS = "channels"    # key: bytecode digest -> frozen solver channels
KIND_AUTOPILOT = "autopilot"  # key: "cells"         -> cost-model cell export
KIND_REPORT = "report"        # key: request digest  -> finished response body


class _PlainUnpickler(pickle.Unpickler):
    """Unpickler of plain data (the autopilot's cell export): any
    global is refused, so a record can build no object."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"plain-data record names {module}.{name}")


def _load_plain(body: bytes):
    return _PlainUnpickler(io.BytesIO(body)).load()


def persist_enabled() -> bool:
    """``MYTHRIL_TPU_PERSIST=0`` is the plane-wide kill switch; the
    plane additionally needs a directory to be active at all."""
    from mythril_tpu_torch.support.env import env_flag

    return env_flag("MYTHRIL_TPU_PERSIST", True)


def flush_period_s() -> float:
    from mythril_tpu_torch.support.env import env_float

    return env_float("MYTHRIL_TPU_PERSIST_FLUSH_S", DEFAULT_FLUSH_S,
                     floor=0.0)


def gossip_enabled() -> bool:
    from mythril_tpu_torch.support.env import env_flag

    return env_flag("MYTHRIL_TPU_PERSIST_GOSSIP", True)


def code_digest(code: Optional[str]) -> Optional[str]:
    """Content address of one bytecode blob: sha256 over the
    normalized (0x-stripped, lowercased) hex, so every spelling of one
    contract shares a digest (the JAX package's digest too)."""
    if not code:
        return None
    text = code[2:] if code.startswith(("0x", "0X")) else code
    return hashlib.sha256(text.strip().lower().encode("ascii",
                                                      "replace")).hexdigest()


class KnowledgePlane:
    """Per-process persistence orchestration (inert unless configured;
    see module docstring)."""

    def __init__(self):
        self._store = None
        self._store_lock = threading.Lock()
        self._last_flush = 0.0
        self._last_gossip_sig = None
        self._atexit_registered = False
        # process-lifetime counters (the per-contract mirrors in
        # DispatchStats and the resilience counters reset per contract;
        # these feed persist_meta)
        self.warm_hits = 0
        self.warm_misses = 0
        self.thaw_errors = 0
        self.report_hits = 0
        self.report_misses = 0
        self.gossip_sent = 0
        self.gossip_applied = 0
        # the digest of the analysis this process last touched: the
        # fleet's coordinator absorbs routed knowledge under it
        self.last_digest: Optional[str] = None

    # -- configuration --------------------------------------------------

    @staticmethod
    def _directory() -> Optional[str]:
        # --persist-dir reaches here through the environment (the CLI
        # writes the knob)
        return os.environ.get("MYTHRIL_TPU_PERSIST_DIR") or None

    @property
    def active(self) -> bool:
        return persist_enabled() and self._directory() is not None

    @property
    def store(self):
        """The open segment store, or None when the plane is inert.
        First access opens + loads it and registers the atexit flush
        (the CLI's one-shot analyze has no drain boundary)."""
        if not self.active:
            return None
        with self._store_lock:
            if self._store is None:
                from mythril_tpu_torch.persist.store import SegmentStore

                self._store = SegmentStore(self._directory()).open()
                self._last_flush = time.monotonic()
                log.info(
                    "persist: store %s opened (%d records, %d corrupt "
                    "segments quarantined%s)", self._directory(),
                    len(self._store), self._store.corrupt_segments,
                    ", read-only" if self._store.read_only else "",
                )
                if not self._atexit_registered:
                    atexit.register(self._atexit_flush)
                    self._atexit_registered = True
            return self._store

    def _atexit_flush(self) -> None:
        try:
            self.flush()
        except Exception:  # noqa: BLE001 — never fail interpreter exit
            log.debug("persist: atexit flush failed", exc_info=True)

    # -- warm start / absorb --------------------------------------------

    def warm_start(self, digest: Optional[str], ctx) -> bool:
        """Seed ``ctx`` (and the autopilot model) from the store before
        an analysis; True on a channel hit.  Any unpickle/apply failure
        (version-skewed payload) degrades to a cold start."""
        store = self.store
        if store is None or digest is None:
            return False
        self.last_digest = digest
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats

        hit = False
        body = store.get(KIND_CHANNELS, digest)
        if body is not None:
            try:
                from mythril_tpu_torch.parallel.gossip import apply_knowledge

                applied = apply_knowledge(ctx, body)
                hit = True
                log.info("persist: warm start %s (+%d unsat, +%d probe, "
                         "+%d models)", digest[:12], applied["unsat"],
                         applied["probe_sat"], applied["models"])
            except Exception as exc:  # noqa: BLE001 — skewed payload
                self.thaw_errors += 1
                log.warning("persist: stored channels for %s are "
                            "unusable (%s); cold start", digest[:12], exc)
        cells = store.get(KIND_AUTOPILOT, "cells")
        if cells is not None:
            try:
                from mythril_tpu_torch.autopilot import get_autopilot

                get_autopilot().model.merge_cells(_load_plain(cells))
            except Exception as exc:  # noqa: BLE001
                self.thaw_errors += 1
                log.warning("persist: stored autopilot cells unusable "
                            "(%s)", exc)
        if hit:
            self.warm_hits += 1
            dispatch_stats.persist_warm_hits += 1
        else:
            self.warm_misses += 1
            dispatch_stats.persist_warm_misses += 1
        return hit

    def absorb(self, digest: Optional[str], ctx) -> None:
        """Stage ``ctx``'s current knowledge after an analysis.  The
        snapshot is the full current channel set — a superset of
        whatever warm_start thawed, so last-record-wins stays monotone
        across process generations."""
        store = self.store
        if store is None or digest is None:
            return
        self.last_digest = digest
        try:
            from mythril_tpu_torch.parallel.gossip import freeze_knowledge

            store.put(KIND_CHANNELS, digest, freeze_knowledge(ctx))
        except Exception as exc:  # noqa: BLE001 — absorb is best-effort
            log.warning("persist: absorb of %s failed (%s)",
                        digest[:12], exc)
        try:
            import mythril_tpu_torch.autopilot as autopilot_mod

            pilot = autopilot_mod._autopilot  # never CREATE from absorb
            if pilot is not None and pilot.model.observations:
                store.put(
                    KIND_AUTOPILOT, "cells",
                    pickle.dumps(pilot.model.export_cells(), protocol=4),
                )
        except Exception as exc:  # noqa: BLE001
            log.debug("persist: autopilot export failed (%s)", exc)
        self.maybe_flush()

    # -- flush cadence --------------------------------------------------

    def flush(self) -> bool:
        """Persist everything staged now (one segment)."""
        with self._store_lock:
            store = self._store
        if store is None:
            return False
        wrote = store.flush()
        if wrote:
            from mythril_tpu_torch.resilience.telemetry import (
                resilience_stats,
            )

            self._last_flush = time.monotonic()
            resilience_stats.persist_flushes += 1
        return wrote

    def maybe_flush(self) -> bool:
        """Timer-gated flush (``MYTHRIL_TPU_PERSIST_FLUSH_S``; 0 means
        every call — tests and the chaos soak use that)."""
        with self._store_lock:
            store = self._store
        if store is None or not store.dirty:
            return False
        if time.monotonic() - self._last_flush < flush_period_s():
            return False
        return self.flush()

    # -- report cache ---------------------------------------------------

    @staticmethod
    def report_key(digest: str, tx_count: int, max_depth: int,
                   modules) -> str:
        """Cache key for one finished analysis: anything that can
        change findings participates, so module-set or tool-version
        changes invalidate by construction."""
        from mythril_tpu_torch.__version__ import __version__

        blob = json.dumps(
            [digest, int(tx_count), int(max_depth),
             sorted(modules or ()), __version__],
            separators=(",", ":"),
        )
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()

    def report_cache_get(self, digest: Optional[str], tx_count: int,
                         max_depth: int, modules) -> Optional[dict]:
        store = self.store
        if store is None or digest is None:
            return None
        raw = store.get(
            KIND_REPORT, self.report_key(digest, tx_count, max_depth,
                                         modules)
        )
        if raw is None:
            self.report_misses += 1
            return None
        try:
            body = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self.report_misses += 1
            return None
        from mythril_tpu_torch.resilience.telemetry import resilience_stats

        self.report_hits += 1
        resilience_stats.persist_report_hits += 1
        return body

    def report_cache_put(self, digest: Optional[str], tx_count: int,
                         max_depth: int, modules, body: dict) -> None:
        store = self.store
        if store is None or digest is None:
            return
        if body.get("partial"):
            return  # a degraded verdict must never answer a future ask
        try:
            raw = json.dumps(body).encode("utf-8")
        except (TypeError, ValueError):
            return
        store.put(
            KIND_REPORT,
            self.report_key(digest, tx_count, max_depth, modules), raw,
        )
        self.maybe_flush()

    # -- heartbeat gossip ------------------------------------------------

    def encode_heartbeat_delta(self, ctx) -> Optional[bytes]:
        """The knowledge body a worker heartbeat should carry, or None
        when gossip is off or nothing changed since the last send.  The
        body is the plain ``freeze_knowledge`` pickle — identical to a
        tx-boundary gossip body, so the coordinator's monotone apply
        and fan-out paths need no new decoding."""
        if not (self.active and gossip_enabled()):
            return None
        sig = ctx.knowledge_signature()
        if sig == self._last_gossip_sig:
            return None
        from mythril_tpu_torch.parallel.gossip import freeze_knowledge

        body = freeze_knowledge(ctx)
        self._last_gossip_sig = sig
        self.gossip_sent += 1
        return body

    def absorb_gossip(self, digest: Optional[str], ctx) -> None:
        """Store-side of a received knowledge body: the caller has
        already applied it monotonically to ``ctx``; re-freezing the
        merged context keeps the stored record a superset."""
        self.gossip_applied += 1
        if digest is not None:
            self.absorb(digest, ctx)


    # -- introspection ---------------------------------------------------

    def persist_meta(self) -> Optional[dict]:
        """The jsonv2 ``meta.resilience.persist`` block (None when the
        plane is inert — the block is simply absent, preserving the
        pre-persist report byte-for-byte)."""
        if not self.active:
            return None
        with self._store_lock:
            store = self._store
        meta = {
            "dir": self._directory(),
            "warm_hits": self.warm_hits,
            "warm_misses": self.warm_misses,
            "report_hits": self.report_hits,
            "gossip_sent": self.gossip_sent,
            "gossip_applied": self.gossip_applied,
        }
        if store is not None:
            meta.update(
                records=len(store),
                flushes=store.flushes,
                corrupt_segments=store.corrupt_segments,
                read_only=store.read_only,
                epoch=store.epoch,
            )
        if self.thaw_errors:
            meta["thaw_errors"] = self.thaw_errors
        return meta


_plane: Optional[KnowledgePlane] = None
_plane_lock = threading.Lock()


def get_knowledge_plane() -> KnowledgePlane:
    global _plane
    if _plane is None:
        with _plane_lock:
            if _plane is None:
                _plane = KnowledgePlane()
    return _plane


def reset_for_tests() -> None:
    """Forget the open store and counters (the directory config is
    env-driven, so a reset followed by first use is exactly a process
    restart against the same directory)."""
    global _plane
    with _plane_lock:
        if _plane is not None:
            with _plane._store_lock:
                if _plane._store is not None:
                    _plane._store.close()
        _plane = None
