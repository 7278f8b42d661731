"""`myth watch` — live-chain ingestion (own copy of
``mythril_tpu/watch/__init__.py``): follow new blocks and stream every
newly deployed contract through the serve plane.

The three stages, one module each:

- :mod:`mythril_tpu_torch.watch.follower` — reorg-tolerant head cursor
  over the ``ProviderPool`` with an fsynced resume journal;
- :mod:`mythril_tpu_torch.watch.extract` — per-block deployment
  extraction (receipts -> runtime code -> triage -> analysis digest,
  EIP-1167 proxies collapsed onto their implementation);
- :mod:`mythril_tpu_torch.watch.stream` — exactly-once dispatch into the
  serve admission edge (the in-process engine on the card of
  ``--device``, or ``--serve URL``) as the dedicated ``watch`` batch
  tenant, with a bounded never-drop backpressure backlog and a JSONL
  findings sink.

This module holds the CLI entry (:func:`run_watch`) and the status
surface the ``/debug/watch`` route and ``top`` panel read.
"""

import json
import logging
import sys
from typing import Optional

from mythril_tpu_torch.watch.extract import Deployment, extract_deployments
from mythril_tpu_torch.watch.follower import ChainFollower, CursorJournal
from mythril_tpu_torch.watch.stream import (
    Backpressure, EngineBackend, ServeBackend, StreamDispatcher,
    WatchMetrics, WatchService,
)

__all__ = [
    "Backpressure", "ChainFollower", "CursorJournal", "Deployment",
    "EngineBackend", "ServeBackend", "StreamDispatcher",
    "WatchMetrics", "WatchService", "debug_status",
    "extract_deployments", "run_watch",
]

log = logging.getLogger(__name__)

#: the live watch service in this process (the last started one wins:
#: one watcher a process)
_active_service: Optional[WatchService] = None


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


def build_client(rpc_spec: str):
    """The provider pool behind the follower: the ``--rpc`` vocabulary is
    exactly :meth:`ProviderPool.from_spec`'s (comma-separated
    ``URL|HOST[:PORT]``)."""
    from mythril_tpu_torch.ethereum.interface.rpc.client import ProviderPool

    return ProviderPool.from_spec(rpc_spec)


def run_watch(args) -> int:
    """CLI entry for ``watch``: wire knobs, follow until drained (or
    ``--until-block``), print the one-line summary.  Exit 2 without a
    provider, and, with the in-process engine, without the card of
    ``--device`` (before any RPC traffic); exit 1 when the card is lost
    mid-watch.  Typed provider exhaustion propagates: the CLI maps it to
    a structured exit 2."""
    from mythril_tpu_torch.ops.device_health import DeviceLost
    from mythril_tpu_torch.support.env import env_float, env_int

    rpc_spec = getattr(args, "rpc", None)
    if not rpc_spec:
        import os

        rpc_spec = os.environ.get("MYTHRIL_TPU_RPC_PROVIDERS", "")
    if not rpc_spec:
        print("myth watch: no RPC provider (--rpc or "
              "MYTHRIL_TPU_RPC_PROVIDERS)", file=sys.stderr)
        return 2
    serve_url = getattr(args, "serve", None)
    device = getattr(args, "device", None) or "cuda"
    if not serve_url:
        from mythril_tpu_torch.ops import default_device

        try:
            default_device(device)
        except RuntimeError as e:
            print(f"myth watch: {e} (use --device cpu)", file=sys.stderr)
            return 2
    client = build_client(rpc_spec)

    confirmations = getattr(args, "confirmations", None)
    if confirmations is None:
        confirmations = env_int(
            "MYTHRIL_TPU_WATCH_CONFIRMATIONS", 2, floor=0
        )
    poll_s = getattr(args, "poll_s", None)
    if poll_s is None:
        poll_s = env_float("MYTHRIL_TPU_WATCH_POLL_S", 2.0, floor=0.0)
    from_block = getattr(args, "from_block", None)
    if from_block is None:
        from_block = env_int("MYTHRIL_TPU_WATCH_FROM_BLOCK", 0,
                             floor=0)
    backlog_cap = env_int("MYTHRIL_TPU_WATCH_BACKLOG", 256, floor=1)

    from mythril_tpu_torch.observability import finalize_outputs

    try:
        backend = ServeBackend(serve_url) if serve_url \
            else EngineBackend(device=device)
        service = WatchService(
            client, backend,
            confirmations=confirmations,
            poll_s=poll_s,
            journal_path=getattr(args, "journal", None),
            resume=bool(getattr(args, "resume", False)),
            from_block=from_block,
            until_block=getattr(args, "until_block", None),
            findings_out=getattr(args, "findings_out", None),
            backlog_cap=backlog_cap,
            tx_count=getattr(args, "tx_count", None) or 2,
            deadline_s=getattr(args, "deadline_s", None),
            max_depth=getattr(args, "max_depth", None) or 128,
        )
        try:
            summary = service.run()
        except KeyboardInterrupt:
            service.stop()
            summary = service.summary()
    except DeviceLost as e:
        print(f"myth watch: device lost: {e}", file=sys.stderr)
        return 1
    finally:
        # --trace-out / --metrics-out artifacts flush exactly like the
        # end of a CLI analysis (never raises)
        finalize_outputs()
    print(json.dumps({"watch_summary": summary}, sort_keys=True))
    return 0
