"""JSON-RPC client + provider pool for on-chain data (own copy of
``mythril_tpu/ethereum/interface/rpc/client.py``; reference:
mythril/ethereum/interface/rpc/client.py).

Only the read methods the analyzer and the watch need.  Uses urllib
from the stdlib; all errors surface as ClientError so DynLoader degrades
gracefully when no node is reachable.  This is chain I/O, not the
device: its failures degrade exactly as in the JAX package.

Transient failures — dropped connections (``OSError``) and HTTP 5xx —
are retried up to :data:`RPC_MAX_ATTEMPTS` times with exponential
backoff + jitter before the error surfaces; non-transient errors (4xx,
bad JSON, missing ``result``) fail immediately.  The transport consults
the resilience fault plane (``rpc_error`` / ``rpc_http_500`` injection
points), so the whole retry path is testable without a network, and
retries land in the ``rpc_retries`` degradation counter.

Wild-corpus hardening adds three layers on top of the single client:

- **rate-limit classification** — HTTP 429 and JSON-RPC error
  ``-32005`` ("limit exceeded", the Infura/Alchemy vocabulary) raise
  :class:`RateLimitError` instead of generic failures, carrying any
  ``Retry-After`` hint, so callers back off instead of hammering.
- **response-shape validation** — ``eth_getCode`` / ``eth_getStorageAt``
  results must be 0x-prefixed hex strings (code byte-aligned); a
  provider answering garbage raises :class:`BadResponseError` and, in
  a pool, costs that provider a breaker strike.
- **ProviderPool** — N providers with per-provider circuit breakers
  (``MYTHRIL_TPU_RPC_BREAKER_FAILS`` consecutive strikes open a
  breaker for ``MYTHRIL_TPU_RPC_BREAKER_COOLDOWN_S``), rate-limit
  aware backoff + rotation, and a digest-keyed on-disk code cache
  riding the persist SegmentStore (``MYTHRIL_TPU_RPC_CACHE_DIR``).
  When every breaker is open the pool raises the typed
  :class:`~mythril_tpu_torch.exceptions.ProviderExhaustedError`, which the
  CLI maps to a one-line structured exit 2.
"""

import hashlib
import json
import logging
import random
import time
import urllib.error
import urllib.request
from typing import Any, List, Optional

log = logging.getLogger(__name__)

JSON_MEDIA_TYPE = "application/json"
RPC_MAX_ATTEMPTS = 3        # total tries per call (1 + 2 retries)
RPC_BACKOFF_BASE_S = 0.05   # sleep = base * 2^attempt * (1 + jitter)
RPC_TIMEOUT_S = 10.0
#: JSON-RPC error code most providers use for "rate limit exceeded"
RATE_LIMIT_RPC_CODE = -32005


class ClientError(Exception):
    pass


class BadStatusCodeError(ClientError):
    pass


class BadJsonError(ClientError):
    pass


class BadResponseError(ClientError):
    pass


class ConnectionError_(ClientError):
    pass


class RateLimitError(ClientError):
    """The provider is shedding load (HTTP 429 or JSON-RPC -32005).
    Not a failure of the request — a demand to slow down; the pool
    backs off and rotates instead of striking the breaker."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


def validate_hex_result(result, what: str = "result",
                        byte_aligned: bool = False) -> str:
    """Shape-check one RPC result that must be 0x-prefixed hex (the
    eth_getCode / eth_getStorageAt contract).  A provider answering
    anything else is broken or lying; surfacing it as
    :class:`BadResponseError` keeps garbage out of the disassembler
    and (in a pool) counts against that provider's breaker."""
    if not isinstance(result, str) or not result.startswith("0x"):
        raise BadResponseError(
            f"{what}: expected 0x-prefixed hex, got {result!r:.80}"
        )
    body = result[2:]
    try:
        int(body, 16) if body else 0
    except ValueError:
        raise BadResponseError(
            f"{what}: non-hex characters in {result!r:.80}"
        ) from None
    if byte_aligned and len(body) % 2:
        raise BadResponseError(
            f"{what}: odd-length hex ({len(body)} nibbles)"
        )
    return result


def validate_block_result(result, what: str = "eth_getBlockByNumber"):
    """Shape-check one block object (``None`` passes through — the node
    does not know the block yet, which is a normal answer near the
    head, not provider garbage).  A block the watch follower can use
    must carry hex ``number``/``hash``/``parentHash`` and a list of
    transactions; anything else raises :class:`BadResponseError` and,
    in a pool, strikes the provider's breaker."""
    if result is None:
        return None
    if not isinstance(result, dict):
        raise BadResponseError(
            f"{what}: expected block object or null, got {result!r:.80}"
        )
    for field in ("number", "hash", "parentHash"):
        validate_hex_result(result.get(field), what=f"{what}.{field}")
    if not isinstance(result.get("transactions"), list):
        raise BadResponseError(
            f"{what}.transactions: expected list, got "
            f"{result.get('transactions')!r:.80}"
        )
    return result


def validate_receipt_result(result, what: str = "eth_getTransactionReceipt"):
    """Shape-check one receipt object (``None`` passes through — an
    unknown/pending tx hash).  Only the fields the deployment
    extractor reads are pinned: ``contractAddress`` must be hex when
    present (a CREATE/CREATE2 deployment), and the object itself must
    be a dict."""
    if result is None:
        return None
    if not isinstance(result, dict):
        raise BadResponseError(
            f"{what}: expected receipt object or null, got {result!r:.80}"
        )
    address = result.get("contractAddress")
    if address is not None:
        validate_hex_result(address, what=f"{what}.contractAddress")
    return result


class BaseClient:
    def eth_getCode(self, address: str, default_block: str = "latest") -> str:
        # not byte_aligned: real nodes answer "0x0" for empty code, and
        # the disassembler triage pass repairs odd nibbles anyway — the
        # validator only has to keep non-hex garbage out
        return validate_hex_result(
            self._call("eth_getCode", [address, default_block]),
            what="eth_getCode",
        )

    def eth_getStorageAt(
        self, address: str, position: int, block: str = "latest"
    ) -> str:
        return validate_hex_result(
            self._call("eth_getStorageAt", [address, hex(position), block]),
            what="eth_getStorageAt",
        )

    def eth_getBalance(self, address: str, block: str = "latest") -> int:
        return int(self._call("eth_getBalance", [address, block]), 16)

    def eth_blockNumber(self) -> int:
        """Current head height as an int (the watch follower's poll)."""
        return int(validate_hex_result(
            self._call("eth_blockNumber"), what="eth_blockNumber",
        ), 16)

    def eth_getBlockByNumber(self, block, full: bool = True):
        """Block object (validated shape) or ``None`` for an unknown
        height.  ``block`` may be an int height, a hex string, or a
        tag like ``"latest"``."""
        if isinstance(block, int):
            block = hex(block)
        return validate_block_result(
            self._call("eth_getBlockByNumber", [block, full])
        )

    def eth_getTransactionReceipt(self, tx_hash: str):
        return validate_receipt_result(
            self._call("eth_getTransactionReceipt", [tx_hash])
        )

    def _call(self, method: str, params: Optional[List[Any]] = None):
        raise NotImplementedError


class EthJsonRpc(BaseClient):
    """JSON-RPC over HTTP(S)."""

    def __init__(self, host: str = "localhost", port: int = 8545, tls: bool = False):
        self.host = host
        self.port = port
        self.tls = tls
        self._id = 0

    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        if self.host.startswith(("http://", "https://")):
            return self.host
        netloc = f"{self.host}:{self.port}" if self.port else self.host
        return f"{scheme}://{netloc}"

    def _call(self, method: str, params: Optional[List[Any]] = None):
        self._id += 1
        payload = json.dumps(
            {
                "jsonrpc": "2.0",
                "method": method,
                "params": params or [],
                "id": self._id,
            }
        ).encode()
        request = urllib.request.Request(
            self.url,
            data=payload,
            headers={"Content-Type": JSON_MEDIA_TYPE},
        )
        body = self._transport(request)
        try:
            decoded = json.loads(body)
        except json.JSONDecodeError:
            raise BadJsonError(body[:200])
        if not isinstance(decoded, dict) or "result" not in decoded:
            error = (
                decoded.get("error") if isinstance(decoded, dict) else decoded
            )
            if isinstance(error, dict) and error.get(
                "code"
            ) == RATE_LIMIT_RPC_CODE:
                raise RateLimitError(str(error.get("message", error)))
            raise BadResponseError(error)
        return decoded["result"]

    def _transport(self, request) -> bytes:
        """One HTTP round trip with bounded retries for transient
        failures.  5xx and connection-level OSErrors are transient (a
        node restarting, a flapping LB); 4xx means the request itself is
        wrong and a retry would just repeat it."""
        last: Optional[Exception] = None
        for attempt in range(RPC_MAX_ATTEMPTS):
            if attempt:
                from mythril_tpu_torch.resilience.telemetry import resilience_stats

                resilience_stats.rpc_retries += 1
                time.sleep(
                    RPC_BACKOFF_BASE_S
                    * (2 ** (attempt - 1))
                    * (1 + random.random())
                )
            try:
                from mythril_tpu_torch.resilience import faults

                faults.maybe_fault_rpc()
                with urllib.request.urlopen(
                    request, timeout=RPC_TIMEOUT_S
                ) as response:
                    if response.status != 200:
                        raise BadStatusCodeError(str(response.status))
                    return response.read()
            except urllib.error.HTTPError as e:
                # urlopen raises (rather than returns) non-2xx
                # responses; without this branch an HTTP 500 would
                # misclassify as a connection failure (HTTPError
                # subclasses OSError)
                if e.code == 429:
                    # rate limiting is a demand, not a failure: carry
                    # the Retry-After hint up to the backoff logic
                    # (pool rotation or caller sleep), don't retry the
                    # same provider in a tight loop
                    retry_after = 0.0
                    try:
                        retry_after = float(
                            (e.headers or {}).get("Retry-After", 0) or 0
                        )
                    except (TypeError, ValueError):
                        pass
                    raise RateLimitError(
                        "HTTP 429", retry_after_s=retry_after
                    )
                if e.code < 500:
                    raise BadStatusCodeError(str(e.code))
                last = BadStatusCodeError(str(e.code))
                log.debug("transient HTTP %s from %s (attempt %d/%d)",
                          e.code, request.full_url, attempt + 1,
                          RPC_MAX_ATTEMPTS)
            except OSError as e:
                last = ConnectionError_(str(e))
                log.debug("transient transport error %s (attempt %d/%d)",
                          e, attempt + 1, RPC_MAX_ATTEMPTS)
        assert last is not None
        raise last


# ---------------------------------------------------------------------------
# provider pool: breakers, rate-limit rotation, on-disk code cache
# ---------------------------------------------------------------------------


class _ProviderSlot:
    """One pooled provider plus its circuit-breaker state."""

    __slots__ = ("client", "fails", "open_until")

    def __init__(self, client: BaseClient):
        self.client = client
        self.fails = 0          # consecutive strikes
        self.open_until = 0.0   # monotonic time the breaker re-closes

    def usable(self, now: float) -> bool:
        return now >= self.open_until


class ProviderPool(BaseClient):
    """N JSON-RPC providers behind one BaseClient face.

    Every call walks the pool round-robin: a provider failure (drop,
    5xx after the client's own retries, garbage shape) is a breaker
    strike and a rotation; ``MYTHRIL_TPU_RPC_BREAKER_FAILS``
    consecutive strikes open that provider's breaker for
    ``MYTHRIL_TPU_RPC_BREAKER_COOLDOWN_S`` seconds (half-open after:
    one success fully closes it, one failure re-opens it).  A
    rate-limit answer (HTTP 429 / JSON-RPC -32005) is not a strike —
    the pool honors any Retry-After hint (capped by
    ``MYTHRIL_TPU_RPC_BACKOFF_CAP_S``), rotates, and moves on.  When
    every breaker is open, :class:`ProviderExhaustedError` surfaces
    with the per-provider detail.

    ``eth_getCode`` additionally rides a digest-keyed on-disk cache
    (persist SegmentStore under ``MYTHRIL_TPU_RPC_CACHE_DIR``):
    deployed code is immutable, so a corpus sweep hits the network
    once per contract ever, survives SIGKILL, and replays offline.
    """

    def __init__(self, providers: List[BaseClient],
                 breaker_fails: Optional[int] = None,
                 breaker_cooldown_s: Optional[float] = None,
                 cache_dir: Optional[str] = None):
        import os

        from mythril_tpu_torch.support.env import env_flag, env_float, env_int

        if not providers:
            raise ValueError("ProviderPool needs at least one provider")
        self.slots = [_ProviderSlot(p) for p in providers]
        self.breaker_fails = breaker_fails if breaker_fails is not None \
            else env_int("MYTHRIL_TPU_RPC_BREAKER_FAILS", 3, floor=1)
        self.breaker_cooldown_s = breaker_cooldown_s \
            if breaker_cooldown_s is not None else env_float(
                "MYTHRIL_TPU_RPC_BREAKER_COOLDOWN_S", 30.0, floor=0.0)
        self.backoff_cap_s = env_float(
            "MYTHRIL_TPU_RPC_BACKOFF_CAP_S", 2.0, floor=0.0)
        self.max_attempts = env_int(
            "MYTHRIL_TPU_RPC_POOL_ATTEMPTS",
            max(RPC_MAX_ATTEMPTS, 2 * len(self.slots)), floor=1)
        self._index = 0
        self._store = None
        self._cache_dir = None
        if env_flag("MYTHRIL_TPU_RPC_CACHE", True):
            self._cache_dir = cache_dir or os.environ.get(
                "MYTHRIL_TPU_RPC_CACHE_DIR"
            ) or None

    @classmethod
    def from_spec(cls, spec: str, tls: bool = False,
                  **kwargs) -> "ProviderPool":
        """Build a pool from a comma-separated provider spec — each
        entry a URL or HOST[:PORT] (the --rpc vocabulary, pluralized).
        """
        providers: List[BaseClient] = []
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith(("http://", "https://")):
                providers.append(EthJsonRpc(entry, None, entry.startswith("https")))
            else:
                host, port = (entry.split(":") + ["8545"])[:2]
                providers.append(EthJsonRpc(host, int(port), tls))
        return cls(providers, **kwargs)

    # -- breaker bookkeeping -------------------------------------------

    def _pick(self) -> Optional[_ProviderSlot]:
        """Next usable slot round-robin; None when every breaker is
        open (the exhaustion case)."""
        now = time.monotonic()
        for offset in range(len(self.slots)):
            slot = self.slots[(self._index + offset) % len(self.slots)]
            if slot.usable(now):
                self._index = (self._index + offset) % len(self.slots)
                return slot
        return None

    def _rotate(self) -> None:
        from mythril_tpu_torch.resilience.telemetry import resilience_stats

        resilience_stats.rpc_provider_rotations += 1
        self._index = (self._index + 1) % len(self.slots)

    def _strike(self, slot: _ProviderSlot) -> None:
        from mythril_tpu_torch.resilience.telemetry import resilience_stats

        slot.fails += 1
        if slot.fails >= self.breaker_fails:
            already_open = slot.open_until > time.monotonic()
            slot.open_until = time.monotonic() + self.breaker_cooldown_s
            # half-open relapse keeps the breaker hot without
            # recounting the open (fails stays saturated)
            slot.fails = self.breaker_fails
            if not already_open:
                resilience_stats.rpc_breaker_opens += 1
                log.warning(
                    "rpc pool: breaker OPEN for %s (%d consecutive "
                    "failures; cooling %.1fs)",
                    getattr(slot.client, "url", slot.client),
                    self.breaker_fails, self.breaker_cooldown_s,
                )

    def _exhausted(self, last: Optional[Exception]):
        from mythril_tpu_torch.exceptions import ProviderExhaustedError

        detail = ", ".join(
            f"{getattr(s.client, 'url', s.client)}: breaker open"
            for s in self.slots
        )
        raise ProviderExhaustedError(
            f"all {len(self.slots)} RPC providers unavailable "
            f"({detail}); last error: {last}"
        )

    # -- the pooled call -----------------------------------------------

    def _call(self, method: str, params: Optional[List[Any]] = None):
        from mythril_tpu_torch.resilience import faults
        from mythril_tpu_torch.resilience.telemetry import resilience_stats

        last: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            slot = self._pick()
            if slot is None:
                self._exhausted(last)
            try:
                faults.maybe_fault_rpc_flap()
                result = slot.client._call(method, params)
            except RateLimitError as e:
                # shedding, not failure: no breaker strike — honor the
                # hint (capped), rotate to a provider with headroom
                resilience_stats.rpc_rate_limited += 1
                sleep_s = min(
                    self.backoff_cap_s,
                    e.retry_after_s
                    or RPC_BACKOFF_BASE_S * (2 ** attempt),
                )
                log.debug("rpc pool: rate limited (%s); backing off "
                          "%.2fs and rotating", e, sleep_s)
                time.sleep(sleep_s)
                self._rotate()
                last = e
                continue
            except (ClientError, OSError) as e:
                self._strike(slot)
                self._rotate()
                last = e
                continue
            slot.fails = 0
            return result
        assert last is not None
        raise last

    # -- digest-keyed code cache ---------------------------------------

    def _cache(self):
        """The SegmentStore, opened lazily (never raises: an unusable
        directory degrades to a read-only/empty store)."""
        if self._store is None and self._cache_dir:
            from mythril_tpu_torch.persist.store import SegmentStore

            self._store = SegmentStore(self._cache_dir).open()
        return self._store

    @staticmethod
    def _code_key(address: str, block: str) -> str:
        return hashlib.sha256(
            f"{address.lower()}@{block}".encode()
        ).hexdigest()

    def eth_getCode(self, address: str, default_block: str = "latest") -> str:
        from mythril_tpu_torch.resilience import faults
        from mythril_tpu_torch.resilience.telemetry import resilience_stats

        store = self._cache()
        key = self._code_key(address, default_block)
        if store is not None and not faults.maybe_fault_code_cache():
            cached = store.get("rpc_code", key)
            if cached is not None:
                resilience_stats.rpc_code_cache_hits += 1
                return cached.decode("ascii")
        code = super().eth_getCode(address, default_block)
        if store is not None:
            store.put("rpc_code", key, code.encode("ascii"))
            store.flush()
        return code
