"""Live-chain ingestion's status surface (own copy of the status half of
``mythril_tpu/watch/__init__.py``).

The JAX package's ``myth watch`` follows a chain over RPC and streams
every new deployment through the serve plane.  The port has no RPC
client yet, so this module holds only what the serve plane reads: the
process's active watcher (none, until the watch slice brings the
follower, the extractor and the stream with ``build_client`` and
``run_watch``) and the ``GET /debug/watch`` body built from it.
"""

from typing import Optional

#: the live watch service in this process (the last started one wins:
#: one watcher a process)
_active_service: Optional[object] = None


def _set_active_service(service) -> None:
    global _active_service
    _active_service = service


def debug_status() -> dict:
    """The ``/debug/watch`` body of an in-process watcher; the inactive
    shape when no watcher runs here."""
    service = _active_service
    if service is None:
        return {"active": False}
    return service.status()
