"""Streaming dispatcher (own copy of ``mythril_tpu/watch/stream.py``):
unique deployments into the serve admission edge, with backpressure that
never drops.

Two backends share one ``analyze(request) -> body`` face:

- :class:`EngineBackend` — the in-process daemon (AdmissionQueue +
  AnalysisEngine, no HTTP), for ``myth watch`` standing alone, on the
  card of ``device`` (``cuda`` unless ``cpu`` is asked for): the engine
  makes it current and builds every kernel library before its first
  request.  The admission-edge report cache is consulted first, exactly
  like the HTTP handler does, so a re-submission after a crash answers
  ``cached: true`` instead of re-analyzing.  A lost card ends the
  engine, and :meth:`EngineBackend.analyze` raises
  :class:`~mythril_tpu_torch.ops.device_health.DeviceLost` (the JAX
  package's engine demotes to its host CDCL instead): the watch ends
  with exit 1, and the block in flight, never journaled as processed,
  is read again by ``--resume``.  Closing the backend takes the
  coalescer out of serve mode, as a drained port server does.
- :class:`ServeBackend` — ``--serve URL`` fabric tenancy: POSTs to a
  running daemon's ``/analyze`` and pushes the watch status snapshot
  to its ``/debug/watch`` route for ``myth top``.

Both convert a shed (HTTP 503/429, or the queue's ``RequestError``)
into :class:`Backpressure` carrying the server's Retry-After hint.
The dispatcher's contract on backpressure: the deployment goes into a
bounded backlog (``MYTHRIL_TPU_WATCH_BACKLOG``) journaled as a
``pending`` row, and when the backlog is full the dispatcher BLOCKS
retrying the oldest entry — admission pressure propagates back up the
follow loop (the poll slows down); nothing is ever dropped silently.
Every submission outcome lands as one JSONL row in the findings sink.

Watch submissions ride the batch admission class under the dedicated
``watch`` tenant source, so interactive callers sharing the daemon
keep their fair-share priority and the per-tenant quota meters the
stream's spend.
"""

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Optional

from mythril_tpu_torch.serve.protocol import AnalyzeRequest, RequestError
from mythril_tpu_torch.watch.extract import Deployment, extract_deployments
from mythril_tpu_torch.watch.follower import ChainFollower, CursorJournal

log = logging.getLogger(__name__)

#: the dedicated tenant every watch submission is accounted under
WATCH_SOURCE = "watch"

#: consecutive failed follow iterations before the loop gives up and
#: lets the error surface (the CLI maps ProviderExhaustedError to a
#: structured exit 2) — below this, errors back off and retry
MAX_CONSECUTIVE_FAILURES = 10


class Backpressure(Exception):
    """The admission edge shed the submission; retry after a delay."""

    def __init__(self, retry_after_s: float = 1.0):
        super().__init__(f"admission shed (retry after {retry_after_s}s)")
        self.retry_after_s = max(0.05, float(retry_after_s or 1.0))


class WatchMetrics:
    """The ``mythril_tpu_watch_*`` registry instruments."""

    def __init__(self, registry):
        self.blocks_seen = registry.counter(
            "mythril_tpu_watch_blocks_seen",
            "blocks fetched and scanned for deployments",
        )
        self.reorgs = registry.counter(
            "mythril_tpu_watch_reorgs",
            "chain reorganizations the cursor rewound over",
        )
        self.deployments = registry.counter(
            "mythril_tpu_watch_deployments",
            "contract deployments extracted from followed blocks",
        )
        self.dedup_hits = registry.counter(
            "mythril_tpu_watch_dedup_hits",
            "deployments skipped because their runtime digest was "
            "already analyzed (clones, factory re-deploys, reorg "
            "replays)",
        )
        self.backlog_depth = registry.gauge(
            "mythril_tpu_watch_backlog_depth",
            "submissions parked by admission backpressure",
        )
        self.lag_blocks = registry.gauge(
            "mythril_tpu_watch_lag_blocks",
            "blocks between the chain head and the processed cursor",
        )


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class EngineBackend:
    """In-process admission queue + engine — ``myth serve`` without
    the listener, on the card of ``device`` (``ServeConfig.device``)."""

    def __init__(self, config=None, device: Optional[str] = None):
        from mythril_tpu_torch.serve.admission import AdmissionQueue
        from mythril_tpu_torch.serve.config import ServeConfig
        from mythril_tpu_torch.serve.engine import AnalysisEngine

        self.config = config or ServeConfig.from_env(
            host="127.0.0.1", port=0, device=device
        )
        self.queue = AdmissionQueue(self.config)
        self.engine = AnalysisEngine(self.queue, self.config)
        self.engine.start()
        if self.engine.device_lost is not None:
            # no card, no engine: nothing is followed
            self.close()
            self._raise_device_lost()

    def _raise_device_lost(self):
        from mythril_tpu_torch.ops.device_health import DeviceLost

        exc = self.engine.device_lost
        raise DeviceLost(
            f"the watch engine's device was lost: "
            f"{type(exc).__name__}: {exc}"
        ) from exc

    def analyze(self, request: AnalyzeRequest) -> dict:
        if self.engine.device_lost is not None:
            self._raise_device_lost()
        cached = self.queue.cached_response(request)
        if cached is not None:
            return cached
        try:
            ticket = self.queue.submit(request)
        except RequestError as exc:
            if exc.status in (503, 429):
                raise Backpressure(
                    exc.extra.get("retry_after_s") or 1.0
                ) from exc
            raise
        deadline_s = (request.deadline_s
                      or self.config.default_deadline_s)
        if not ticket.done.wait(deadline_s + 60.0):
            ticket.abandoned.set()
            return {"error": {"code": "engine_timeout",
                              "message": "engine did not answer"}}
        body = ticket.response if isinstance(ticket.response, dict) \
            else {"error": {"code": "internal", "message": "no body"}}
        if self.engine.device_lost is not None:
            # the 503 of a lost card is no shed: retrying cannot help
            self._raise_device_lost()
        if ticket.status in (503, 429):
            raise Backpressure(
                (body.get("error") or {}).get("retry_after_s") or 1.0
            )
        return body

    def push_status(self, snapshot: dict) -> None:
        pass  # no remote daemon to inform

    def close(self) -> None:
        from mythril_tpu_torch.ops.coalesce import set_serve_mode

        for ticket in self.queue.close():
            ticket.resolve(503, {"error": {
                "code": "draining",
                "message": "watch engine shutting down",
            }})
        self.engine.join(timeout=self.config.max_deadline_s)
        set_serve_mode(False)


class ServeBackend:
    """Fabric tenancy: a running ``myth serve`` daemon at ``url``."""

    def __init__(self, url: str, timeout_s: float = 600.0):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    def _post(self, path: str, payload: dict):
        data = json.dumps(payload).encode("utf-8")
        request = urllib.request.Request(
            self.url + path, data=data,
            headers={"Content-Type": "application/json"},
        )
        return urllib.request.urlopen(request, timeout=self.timeout_s)

    def analyze(self, request: AnalyzeRequest) -> dict:
        payload = {
            "code": request.code, "name": request.name,
            "tx_count": request.tx_count, "priority": request.priority,
            "source": request.source, "max_depth": request.max_depth,
        }
        if request.deadline_s is not None:
            payload["deadline_s"] = request.deadline_s
        if request.modules is not None:
            payload["modules"] = request.modules
        if request.trace_id is not None:
            payload["trace_id"] = request.trace_id
        try:
            with self._post("/analyze", payload) as response:
                return json.loads(response.read().decode("utf-8"))
        except urllib.error.HTTPError as exc:
            if exc.code in (503, 429):
                retry_after = 1.0
                try:
                    retry_after = float(
                        (exc.headers or {}).get("Retry-After", 1) or 1
                    )
                except (TypeError, ValueError):
                    pass
                raise Backpressure(retry_after) from exc
            try:
                return json.loads(exc.read().decode("utf-8"))
            except Exception:  # noqa: BLE001 — keep the HTTP error
                return {"error": {"code": f"http_{exc.code}",
                                  "message": str(exc)}}

    def push_status(self, snapshot: dict) -> None:
        """Best-effort: the daemon's ``/debug/watch`` route stores the
        latest snapshot for ``myth top``; a failed push never slows
        the follow loop."""
        try:
            with self._post("/debug/watch", snapshot):
                pass
        except Exception:  # noqa: BLE001 — status push is advisory
            log.debug("watch: status push failed", exc_info=True)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


class StreamDispatcher:
    """Dedup + submit + backpressure backlog + findings sink."""

    def __init__(self, backend, metrics: WatchMetrics,
                 seen_digests: set, journal: Optional[CursorJournal],
                 findings_path: Optional[str] = None,
                 backlog_cap: int = 256, tx_count: int = 2,
                 deadline_s: Optional[float] = None,
                 max_depth: int = 128):
        self.backend = backend
        self.metrics = metrics
        self.seen = seen_digests
        self.journal = journal
        self.backlog = deque()
        self.backlog_cap = max(1, backlog_cap)
        self.tx_count = tx_count
        self.deadline_s = deadline_s
        self.max_depth = max_depth
        self.analyzed = 0
        self.cached = 0
        self.errors = 0
        self._findings_fh = None
        if findings_path:
            parent = os.path.dirname(os.path.abspath(findings_path))
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._findings_fh = open(findings_path, "a",
                                     encoding="utf-8")

    # -- findings sink ---------------------------------------------------

    def _sink(self, row: dict) -> None:
        if self._findings_fh is not None:
            self._findings_fh.write(
                json.dumps(row, sort_keys=True) + "\n"
            )
            self._findings_fh.flush()

    # -- submission ------------------------------------------------------

    def _request(self, deployment: Deployment) -> AnalyzeRequest:
        return AnalyzeRequest(
            code=deployment.code[2:]
            if deployment.code.startswith("0x") else deployment.code,
            name=deployment.name(), tx_count=self.tx_count,
            deadline_s=self.deadline_s, priority="batch",
            source=WATCH_SOURCE, max_depth=self.max_depth,
        )

    def _record(self, deployment: Deployment, body: dict) -> None:
        error = body.get("error")
        if error:
            self.errors += 1
        elif body.get("cached"):
            self.cached += 1
        else:
            self.analyzed += 1
        self._sink({
            "digest": deployment.digest,
            "address": deployment.address,
            "block": deployment.block,
            "name": deployment.name(),
            "proxy_target": deployment.proxy_target,
            "status": "error" if error else "analyzed",
            "cached": bool(body.get("cached")),
            "trace_id": body.get("trace_id"),
            "findings_swc": body.get("findings_swc"),
            "partial": bool(body.get("partial")),
            "analysis_s": body.get("analysis_s"),
            "error": error,
        })

    def submit(self, deployment: Deployment) -> None:
        """One deployment through dedup and the admission edge."""
        from mythril_tpu_torch.observability import spans as obs

        self.metrics.deployments.inc()
        if deployment.digest in self.seen:
            self.metrics.dedup_hits.inc()
            self._sink({
                "digest": deployment.digest,
                "address": deployment.address,
                "block": deployment.block,
                "status": "duplicate",
            })
            return
        self.seen.add(deployment.digest)
        with obs.span("watch.submit", cat="watch",
                      digest=deployment.digest[:12],
                      block=deployment.block):
            try:
                body = self.backend.analyze(self._request(deployment))
            except Backpressure as bp:
                self._park(deployment, bp)
                return
        self._record(deployment, body)

    # -- the backlog -----------------------------------------------------

    def _park(self, deployment: Deployment, bp: Backpressure) -> None:
        """Shed submission into the bounded backlog; journal it as
        pending so a SIGKILL cannot lose it.  A full backlog BLOCKS on
        draining the oldest entry — backpressure propagates, nothing
        drops."""
        if self.journal is not None:
            self.journal.append({"pending": {
                "digest": deployment.digest,
                "address": deployment.address,
                "block": deployment.block,
                "tx_hash": deployment.tx_hash,
                "code": deployment.code,
                "proxy_target": deployment.proxy_target,
            }})
        while len(self.backlog) >= self.backlog_cap:
            time.sleep(bp.retry_after_s)
            self.drain(blocking=True, max_items=1)
        self.backlog.append(deployment)
        self.metrics.backlog_depth.set(len(self.backlog))
        log.info("watch: backlogged %s (depth %d, retry in %.1fs)",
                 deployment.digest[:12], len(self.backlog),
                 bp.retry_after_s)

    def restore_pending(self, rows) -> None:
        """Re-seed the backlog from journal ``pending`` rows on
        ``--resume`` (their digests are already in the seen-set)."""
        for item in rows:
            self.backlog.append(Deployment(
                address=item.get("address", "0x0"),
                tx_hash=item.get("tx_hash", ""),
                block=int(item.get("block", 0)),
                code=item.get("code", "0x"),
                digest=item.get("digest", ""),
                proxy_target=item.get("proxy_target"),
            ))
        self.metrics.backlog_depth.set(len(self.backlog))

    def drain(self, blocking: bool = False,
              max_items: Optional[int] = None) -> int:
        """Retry backlogged submissions oldest-first.  Non-blocking:
        one pass, stop at the first re-shed.  Blocking: keep retrying
        (honoring Retry-After) until drained or ``max_items`` done."""
        drained = 0
        while self.backlog and (max_items is None
                                or drained < max_items):
            deployment = self.backlog.popleft()
            try:
                body = self.backend.analyze(self._request(deployment))
            except Backpressure as bp:
                self.backlog.appendleft(deployment)
                if not blocking:
                    break
                time.sleep(bp.retry_after_s)
                continue
            if self.journal is not None:
                self.journal.append({"done": deployment.digest})
            self._record(deployment, body)
            drained += 1
        self.metrics.backlog_depth.set(len(self.backlog))
        return drained

    def close(self) -> None:
        if self._findings_fh is not None:
            self._findings_fh.close()
            self._findings_fh = None


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


class WatchService:
    """follow -> extract -> dispatch, plus the status surface."""

    def __init__(self, client, backend, *, confirmations: int = 0,
                 poll_s: float = 2.0,
                 journal_path: Optional[str] = None,
                 resume: bool = False, from_block: int = 0,
                 until_block: Optional[int] = None,
                 findings_out: Optional[str] = None,
                 backlog_cap: int = 256, tx_count: int = 2,
                 deadline_s: Optional[float] = None,
                 max_depth: int = 128):
        from mythril_tpu_torch.observability.metrics import get_registry

        self.backend = backend
        self.poll_s = max(0.0, poll_s)
        self.until_block = until_block
        self.metrics = WatchMetrics(get_registry())
        self.journal = None
        if journal_path:
            self.journal = CursorJournal(journal_path).open()
        self.follower = ChainFollower(
            client, confirmations=confirmations, journal=self.journal,
            from_block=from_block, resume=resume,
        )
        self.dispatcher = StreamDispatcher(
            backend, self.metrics, self.follower.seen_digests,
            self.journal, findings_path=findings_out,
            backlog_cap=backlog_cap, tx_count=tx_count,
            deadline_s=deadline_s, max_depth=max_depth,
        )
        if resume and self.follower.pending_rows:
            self.dispatcher.restore_pending(self.follower.pending_rows)
        self.started_at = time.time()
        self._stop = threading.Event()

    # -- status ----------------------------------------------------------

    def status(self) -> dict:
        return {
            "active": not self._stop.is_set(),
            "cursor": self.follower.cursor,
            "head": self.follower.head,
            "lag_blocks": self.follower.lag_blocks(),
            "confirmations": self.follower.confirmations,
            "blocks_seen": self.metrics.blocks_seen.value,
            "reorgs": self.follower.reorgs,
            "deployments": self.metrics.deployments.value,
            "unique_submitted": len(self.follower.seen_digests),
            "dedup_hits": self.metrics.dedup_hits.value,
            "backlog_depth": len(self.dispatcher.backlog),
            "analyzed": self.dispatcher.analyzed,
            "cached": self.dispatcher.cached,
            "errors": self.dispatcher.errors,
            "uptime_s": round(time.time() - self.started_at, 1),
        }

    def stop(self) -> None:
        self._stop.set()

    # -- the loop --------------------------------------------------------

    def _process_block(self, block: dict) -> None:
        from mythril_tpu_torch.observability import spans as obs

        height = int(block["number"], 16)
        with obs.span("watch.block", cat="watch", height=height):
            with obs.span("watch.extract", cat="watch", height=height):
                deployments = extract_deployments(
                    self.follower.client, block
                )
            for deployment in deployments:
                self.dispatcher.submit(deployment)
        # the block is processed only once every deployment is either
        # answered or journaled pending — now the cursor may move
        self.follower.mark_processed(
            block, [d.digest for d in deployments]
        )
        self.metrics.blocks_seen.inc()

    def _advance(self) -> int:
        """Process every confirmed block the head allows; returns how
        many blocks were consumed this round."""
        from mythril_tpu_torch.observability import spans as obs

        with obs.span("watch.poll", cat="watch"):
            self.follower.poll_head()
        processed = 0
        reorgs_before = self.follower.reorgs
        while not self._drained():
            block = self.follower.next_block()
            if block is None:
                break
            self._process_block(block)
            processed += 1
        if self.follower.reorgs > reorgs_before:
            for _ in range(self.follower.reorgs - reorgs_before):
                self.metrics.reorgs.inc()
        self.metrics.lag_blocks.set(self.follower.lag_blocks())
        return processed

    def _drained(self) -> bool:
        from mythril_tpu_torch.resilience.checkpoint import _drain_event

        return self._stop.is_set() or _drain_event.is_set()

    def _done(self) -> bool:
        return (self.until_block is not None
                and self.follower.cursor >= self.until_block
                and not self.dispatcher.backlog)

    def run(self) -> dict:
        """The foreground loop; returns the final summary dict (also
        printed by the CLI as one JSON line)."""
        from mythril_tpu_torch.exceptions import ProviderExhaustedError
        from mythril_tpu_torch.ethereum.interface.rpc.client import ClientError
        from mythril_tpu_torch.watch import _set_active_service

        _set_active_service(self)
        consecutive_failures = 0
        try:
            while not self._drained() and not self._done():
                try:
                    self._advance()
                    self.dispatcher.drain(blocking=False)
                    consecutive_failures = 0
                except (ClientError, ProviderExhaustedError) as exc:
                    consecutive_failures += 1
                    if consecutive_failures >= MAX_CONSECUTIVE_FAILURES:
                        raise
                    backoff = min(5.0, 0.1 * (2 ** consecutive_failures))
                    log.warning(
                        "watch: follow iteration failed (%s); retrying "
                        "in %.1fs (%d/%d)", exc, backoff,
                        consecutive_failures, MAX_CONSECUTIVE_FAILURES,
                    )
                    time.sleep(backoff)
                self.backend.push_status(self.status())
                if self._done():
                    break
                if self.follower.head >= 0 and \
                        self.follower.cursor >= (
                            self.follower.head
                            - self.follower.confirmations
                        ) and not self.dispatcher.backlog:
                    # caught up: idle until the next poll tick
                    self._wait(self.poll_s)
        finally:
            # drain boundary: the backlog empties through blocking
            # retries (unless the process is being torn down hard),
            # artifacts flush, the status surface goes inactive
            try:
                if self.dispatcher.backlog:
                    self.dispatcher.drain(blocking=True)
            finally:
                self._stop.set()
                self.backend.push_status(self.status())
                self.dispatcher.close()
                if self.journal is not None:
                    self.journal.close()
                self.backend.close()
                _set_active_service(None)
        return self.summary()

    def _wait(self, seconds: float) -> None:
        from mythril_tpu_torch.resilience.checkpoint import _drain_event

        if seconds <= 0:
            return
        _drain_event.wait(seconds)

    def summary(self) -> dict:
        status = self.status()
        status.pop("active", None)
        wall_s = max(1e-9, time.time() - self.started_at)
        status["wall_s"] = round(wall_s, 3)
        # contracts/min over unique submissions actually answered
        status["cpm"] = round(
            60.0 * (self.dispatcher.analyzed + self.dispatcher.cached)
            / wall_s, 2,
        )
        return status
