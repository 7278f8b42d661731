"""Persistent knowledge plane (own copy of ``mythril_tpu/persist``):
crash-safe warm state that survives the process.

Everything the system learns while analyzing — UNSAT/probe memos,
recent SAT models, autopilot cost-model EWMAs, finished reports — used
to die with the process.  This package makes that state durable and
shared:

- :mod:`mythril_tpu_torch.persist.store` — the on-disk segment store:
  append-only, CRC-checked, atomically written, quarantine-on-corrupt,
  single-writer-locked, epoch-stamped, compacting.
- :mod:`mythril_tpu_torch.persist.plane` — the process-level orchestration:
  env-gated warm-start/absorb seams around each analysis, flush
  cadence, the report cache, and heartbeat gossip encode/apply
  helpers.

The whole plane is OFF unless ``MYTHRIL_TPU_PERSIST_DIR`` (or
``--persist-dir``) names a directory, and ``MYTHRIL_TPU_PERSIST=0``
kills it even then — the in-memory-only path is the exact pre-persist
code path, byte for byte.
"""

from mythril_tpu_torch.persist.plane import (  # noqa: F401
    KnowledgePlane,
    get_knowledge_plane,
    persist_enabled,
    reset_for_tests,
)
from mythril_tpu_torch.persist.store import SegmentStore, StoreCorrupt  # noqa: F401

__all__ = [
    "KnowledgePlane",
    "SegmentStore",
    "StoreCorrupt",
    "get_knowledge_plane",
    "persist_enabled",
    "reset_for_tests",
]
