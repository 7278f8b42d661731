"""Serve-plane configuration: every admission / deadline / breaker knob
in one validated-at-startup dataclass (own copy of
``mythril_tpu/serve/config.py``, with the port's ``device``).

All knobs come from the environment (``MYTHRIL_TPU_SERVE_*``) with the
CLI supplying only host/port, the fabric's listener and secret, and the
device (``--device``: the card unless ``cpu`` is asked for; a request
cannot choose it), so a fleet rollout tunes the daemon
without touching command lines.  Validation mirrors the fault plane's
``FaultSpecError`` startup contract: a malformed value raises
:class:`ServeConfigError` at ``myth serve`` startup (exit code 2) —
a typo'd watermark must never be discovered as an un-shed OOM at
3 a.m.

Knobs::

    MYTHRIL_TPU_SERVE_MAX_BODY        request body cap in bytes (413
                                      beyond it; default 1 MiB)
    MYTHRIL_TPU_SERVE_QUEUE           bounded batch-class queue depth
                                      (default 64)
    MYTHRIL_TPU_SERVE_QUEUE_INTERACTIVE
                                      bounded interactive-class queue
                                      depth (default 16)
    MYTHRIL_TPU_SERVE_RSS_MB          resident-set watermark; admissions
                                      shed with Retry-After above it
                                      (0 = off, the default)
    MYTHRIL_TPU_SERVE_DEADLINE        default per-request wall-clock
                                      budget in seconds (default 60)
    MYTHRIL_TPU_SERVE_MAX_DEADLINE    largest budget a request may ask
                                      for (default 600)
    MYTHRIL_TPU_SERVE_RETRY_AFTER     Retry-After seconds on a shed
                                      (default 5)
    MYTHRIL_TPU_SERVE_BREAKER         consecutive failures from one
                                      source that open its circuit
                                      breaker (default 3; 0 disables)
    MYTHRIL_TPU_SERVE_BREAKER_COOLDOWN
                                      seconds an open breaker holds
                                      before a half-open probe
                                      (default 30)
    MYTHRIL_TPU_SERVE_COLD            1 = reset the blast context per
                                      request (parity debugging; the
                                      warm amortization is the point of
                                      the daemon, so default 0)
    MYTHRIL_TPU_SERVE_TENANT_QUOTA    analysis-seconds one source may
                                      consume per rolling 60s window
                                      (429 beyond it; 0 = off, the
                                      default)
    MYTHRIL_TPU_FLEET_LISTEN          HOST:PORT the serving fabric's
                                      coordinator listens on for
                                      worker attach (``--fleet-listen``
                                      wins; unset = no fabric)
    MYTHRIL_TPU_FLEET_SECRET_FILE     shared-secret file for the
                                      fabric handshake (required for a
                                      non-loopback listen)
"""

import os
from dataclasses import dataclass
from typing import Optional

DEFAULT_PORT = 8551


class ServeConfigError(RuntimeError):
    """A malformed ``MYTHRIL_TPU_SERVE_*`` value.  Raised at server
    startup so a fleet misconfiguration dies loudly (exit 2), mirroring
    the fault plane's ``FaultSpecError`` contract."""


def _env_int(name: str, default: int, minimum: int = 0) -> int:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        value = int(raw)
    except ValueError as exc:
        raise ServeConfigError(f"{name}={raw!r}: not an integer") from exc
    if value < minimum:
        raise ServeConfigError(f"{name}={value}: must be >= {minimum}")
    return value


def _env_float(name: str, default: float, minimum: float = 0.0) -> float:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        value = float(raw)
    except ValueError as exc:
        raise ServeConfigError(f"{name}={raw!r}: not a number") from exc
    if value < minimum:
        raise ServeConfigError(f"{name}={value}: must be >= {minimum}")
    return value


@dataclass
class ServeConfig:
    """Resolved serve-plane knobs (one instance per server)."""

    host: str = "127.0.0.1"
    port: int = DEFAULT_PORT
    max_body_bytes: int = 1 << 20
    queue_cap_batch: int = 64
    queue_cap_interactive: int = 16
    rss_watermark_mb: int = 0
    default_deadline_s: float = 60.0
    max_deadline_s: float = 600.0
    retry_after_s: int = 5
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    cold_per_request: bool = False
    tenant_quota_s: float = 0.0
    fleet_listen: Optional[str] = None
    fleet_secret_file: Optional[str] = None
    device: str = "cuda"

    @classmethod
    def from_env(cls, host=None, port=None, fleet_listen=None,
                 secret_file=None, device=None) -> "ServeConfig":
        config = cls(
            device=device or "cuda",
            host=host or "127.0.0.1",
            port=DEFAULT_PORT if port is None else int(port),
            max_body_bytes=_env_int(
                "MYTHRIL_TPU_SERVE_MAX_BODY", 1 << 20, minimum=1
            ),
            queue_cap_batch=_env_int(
                "MYTHRIL_TPU_SERVE_QUEUE", 64, minimum=1
            ),
            queue_cap_interactive=_env_int(
                "MYTHRIL_TPU_SERVE_QUEUE_INTERACTIVE", 16, minimum=1
            ),
            rss_watermark_mb=_env_int("MYTHRIL_TPU_SERVE_RSS_MB", 0),
            default_deadline_s=_env_float(
                "MYTHRIL_TPU_SERVE_DEADLINE", 60.0, minimum=0.001
            ),
            max_deadline_s=_env_float(
                "MYTHRIL_TPU_SERVE_MAX_DEADLINE", 600.0, minimum=0.001
            ),
            retry_after_s=_env_int("MYTHRIL_TPU_SERVE_RETRY_AFTER", 5),
            breaker_threshold=_env_int("MYTHRIL_TPU_SERVE_BREAKER", 3),
            breaker_cooldown_s=_env_float(
                "MYTHRIL_TPU_SERVE_BREAKER_COOLDOWN", 30.0
            ),
            cold_per_request=os.environ.get(
                "MYTHRIL_TPU_SERVE_COLD", ""
            ).lower() in ("1", "on", "true"),
            tenant_quota_s=_env_float(
                "MYTHRIL_TPU_SERVE_TENANT_QUOTA", 0.0
            ),
            fleet_listen=(
                fleet_listen
                or os.environ.get("MYTHRIL_TPU_FLEET_LISTEN",
                                  "").strip() or None
            ),
            fleet_secret_file=(
                secret_file
                or os.environ.get("MYTHRIL_TPU_FLEET_SECRET_FILE",
                                  "").strip() or None
            ),
        )
        if config.default_deadline_s > config.max_deadline_s:
            raise ServeConfigError(
                "MYTHRIL_TPU_SERVE_DEADLINE "
                f"({config.default_deadline_s}) exceeds "
                f"MYTHRIL_TPU_SERVE_MAX_DEADLINE ({config.max_deadline_s})"
            )
        config._validate_fabric()
        return config

    def _validate_fabric(self) -> None:
        """The serving fabric's startup contract: a parseable listen
        spec, a readable non-empty secret, and never a routable
        listener without one (secure-by-default) — all exit 2, before
        a socket is bound."""
        from mythril_tpu_torch.parallel import fabric

        if self.fleet_listen is not None:
            try:
                host, _port = fabric.parse_listen(self.fleet_listen)
            except ValueError as exc:
                raise ServeConfigError(
                    f"--fleet-listen/MYTHRIL_TPU_FLEET_LISTEN: {exc}"
                ) from None
            if (self.fleet_secret_file is None
                    and not fabric.is_loopback(host)):
                raise ServeConfigError(
                    f"fleet listen {self.fleet_listen!r} is not "
                    "loopback: a secret file is required "
                    "(--secret-file / MYTHRIL_TPU_FLEET_SECRET_FILE)"
                )
        if self.fleet_secret_file is not None:
            try:
                fabric.load_secret(self.fleet_secret_file)
            except fabric.FleetAuthError as exc:
                raise ServeConfigError(str(exc)) from None


def current_rss_mb() -> float:
    """Resident set size of this process in MiB.  Reads
    ``/proc/self/statm`` (current RSS — what an overload shed must key
    on); falls back to ``ru_maxrss`` (peak) on non-proc platforms."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1 << 20)
    except Exception:  # noqa: BLE001 — non-Linux fallback
        try:
            import resource

            return resource.getrusage(
                resource.RUSAGE_SELF
            ).ru_maxrss / 1024.0
        except Exception:  # noqa: BLE001
            return 0.0
