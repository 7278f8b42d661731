"""``MYTHRIL_TPU_*`` knobs of the port (own copy of the part of
``mythril_tpu/support/env.py`` for the knobs the port reads): the
lenient readers ``env_int`` / ``env_float`` / ``env_flag``, which the
solver calls on hot paths (malformed -> default), and the startup gate
:func:`validate_env`, which the CLI calls before a command so that a
typo'd value exits 2 instead of running a default."""

import os
from typing import Dict, Optional, Tuple


class EnvSpecError(RuntimeError):
    """A malformed ``MYTHRIL_TPU_*`` value, raised by :func:`validate_env`
    at CLI startup (exit code 2)."""


#: name -> (kind, floor, ceil), kind "int", "float", "flag", "dir" (a
#: usable directory path: created on demand by its owner, so it only has
#: not to be an existing non-directory), "listen" (a ``HOST:PORT``),
#: "file" (an existing non-empty file), "providers" (a comma-separated
#: list of RPC endpoints, a URL or ``HOST[:PORT]`` each) or "policy" (a
#: name :func:`autopilot.policy.make_policy` knows): the JAX package's
#: entries (``KNOWN_SPECS``) for the knobs this port reads, and the
#: tracer's, the ledger's and the autopilot's kill switches and policy
#: name, which the JAX package reads without checking them.  The port
#: also reads MYTHRIL_TPU_FRONTIER, MYTHRIL_TPU_PALLAS,
#: MYTHRIL_TPU_ROUND_LADDER, MYTHRIL_TPU_WORD_TIER, MYTHRIL_TPU_WORD_XP,
#: MYTHRIL_TPU_SYM_LOCKSTEP, MYTHRIL_TPU_SEG_PLANES and its own alias
#: MYTHRIL_TPU_DENSE, which that table does not hold: like the JAX
#: package, the gate takes any value of theirs.
KNOWN_SPECS: Dict[str, Tuple[str, Optional[float], Optional[float]]] = {
    "MYTHRIL_TPU_FRONTIER_PERIOD": ("int", 1, None),
    "MYTHRIL_TPU_FRONTIER_FAN": ("int", 1, None),
    "MYTHRIL_TPU_FRONTIER_DEG": ("int", 2, None),
    "MYTHRIL_TPU_TIER_PERIOD": ("int", 1, None),
    "MYTHRIL_TPU_COALESCE_WINDOW": ("int", 0, None),
    "MYTHRIL_TPU_COALESCE_FILL": ("float", 0.0, None),
    "MYTHRIL_TPU_PROBE_MEMO_CAP": ("int", 1, None),
    "MYTHRIL_TPU_WORD_ROUNDS": ("int", 1, None),
    "MYTHRIL_TPU_WORD_MAX_NODES": ("int", 1, None),
    "MYTHRIL_TPU_RESIDENT_KERNEL": ("flag", None, None),
    "MYTHRIL_TPU_RESIDENT_BUDGET": ("int", 1, None),
    "MYTHRIL_TPU_RESIDENT_WATCHDOG": ("int", 1, None),
    "MYTHRIL_TPU_RESIDENT_EXTRA": ("int", 1, None),
    "MYTHRIL_TPU_RESIDENT_POOL": ("flag", None, None),
    "MYTHRIL_TPU_WARM_START": ("flag", None, None),
    "MYTHRIL_TPU_SEG_MIN_LANES": ("int", 1, None),
    "MYTHRIL_TPU_SEG_MAX_OPS": ("int", 1, None),
    "MYTHRIL_TPU_SEG_CEIL_MS": ("float", 0.0, None),
    # lockstep memory/storage/keccak planes (symbolic_lockstep.py):
    # kill switch, per-lane arena sizes, and the concrete-width cap
    # past which SHA3 parks to the host keccak path
    "MYTHRIL_TPU_SEG_PLANES_MEM": ("flag", None, None),
    "MYTHRIL_TPU_SEG_MEM_WORDS": ("int", 1, None),
    "MYTHRIL_TPU_SEG_STORAGE_SLOTS": ("int", 1, None),
    "MYTHRIL_TPU_SEG_KECCAK_MAX_BYTES": ("int", 0, None),
    # veritesting tier (laser/ethereum/veritest.py): kill switch, the
    # If-term budget one join may mint, the diverging-constraint
    # window per side, and the subsumption sweep cadence in rounds
    "MYTHRIL_TPU_VERITEST": ("flag", None, None),
    "MYTHRIL_TPU_MERGE_MAX_ITES": ("int", 0, None),
    "MYTHRIL_TPU_MERGE_WINDOW": ("int", 1, None),
    "MYTHRIL_TPU_SUBSUME_PERIOD": ("int", 1, None),
    # observability plane (observability/): the tracer's kill switch and
    # event cap, the lane ledger's kill switch and record cap
    "MYTHRIL_TPU_TRACE": ("flag", None, None),
    "MYTHRIL_TPU_TRACE_CAP": ("int", 1, None),
    "MYTHRIL_TPU_LEDGER": ("flag", None, None),
    "MYTHRIL_TPU_LEDGER_CAP": ("int", 1, None),
    # autopilot (autopilot/): kill switch, routing policy, the policy's
    # sample floor, first-rung conflict budget and tail-share threshold,
    # and the tuner's evaluation window in ledgered batches
    "MYTHRIL_TPU_AUTOPILOT": ("flag", None, None),
    "MYTHRIL_TPU_AUTOPILOT_POLICY": ("policy", None, None),
    "MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES": ("int", 1, None),
    "MYTHRIL_TPU_AUTOPILOT_LADDER": ("int", 1, None),
    "MYTHRIL_TPU_AUTOPILOT_TAIL_SHARE": ("float", 0.0, 1.0),
    "MYTHRIL_TPU_AUTOPILOT_EVAL_EVERY": ("int", 1, None),
    # resource governor (resilience/governor.py): kill switch and the
    # per-analysis budgets (0 = that budget unlimited)
    "MYTHRIL_TPU_GOVERNOR": ("flag", None, None),
    "MYTHRIL_TPU_GOVERNOR_STATES": ("int", 0, None),
    "MYTHRIL_TPU_GOVERNOR_TERMS": ("int", 0, None),
    "MYTHRIL_TPU_GOVERNOR_LANES": ("int", 0, None),
    "MYTHRIL_TPU_GOVERNOR_RSS_MB": ("int", 0, None),
    # persistent knowledge plane (persist/): kill switch, store
    # directory, flush cadence, compaction cap, heartbeat gossip
    "MYTHRIL_TPU_PERSIST": ("flag", None, None),
    "MYTHRIL_TPU_PERSIST_DIR": ("dir", None, None),
    "MYTHRIL_TPU_PERSIST_FLUSH_S": ("float", 0.0, None),
    "MYTHRIL_TPU_PERSIST_CAP_MB": ("float", 1.0, None),
    "MYTHRIL_TPU_PERSIST_GOSSIP": ("flag", None, None),
    # the fleet (parallel/): heartbeat cadence, lease TTL, straggler
    # threshold, retry and spawn budgets, timeouts, the frame cap, a
    # remote seat's redial budget, the listener and the shared secret
    "MYTHRIL_TPU_FLEET_HEARTBEAT_S": ("float", 0.05, None),
    "MYTHRIL_TPU_FLEET_LEASE_TTL_S": ("float", 0.1, None),
    "MYTHRIL_TPU_FLEET_SPLIT_AFTER_S": ("float", 0.0, None),
    "MYTHRIL_TPU_FLEET_LEASE_RETRIES": ("int", 0, None),
    "MYTHRIL_TPU_FLEET_SPAWN_RETRIES": ("int", 0, None),
    "MYTHRIL_TPU_FLEET_CONNECT_TIMEOUT_S": ("float", 0.1, None),
    "MYTHRIL_TPU_FLEET_HARD_CAP_S": ("float", 0.1, None),
    "MYTHRIL_TPU_FLEET_MAX_FRAME": ("int", 4096, None),
    "MYTHRIL_TPU_FLEET_RECONNECT": ("int", 0, None),
    "MYTHRIL_TPU_FLEET_LISTEN": ("listen", None, None),
    "MYTHRIL_TPU_FLEET_SECRET_FILE": ("file", None, None),
    # the serve plane (serve/): a source's analysis-seconds in a rolling
    # 60 s window (the other MYTHRIL_TPU_SERVE_* knobs are checked by
    # serve/config.py when the server starts)
    "MYTHRIL_TPU_SERVE_TENANT_QUOTA": ("float", 0.0, None),
    # wild-bytecode triage (disassembler/triage.py): code-size cap and
    # the proxy-chain resolution depth through DynLoader
    "MYTHRIL_TPU_TRIAGE_MAX_CODE": ("int", 1, None),
    "MYTHRIL_TPU_PROXY_DEPTH": ("int", 0, None),
    # RPC provider pool (ethereum/interface/rpc/client.py): provider
    # list, per-provider circuit breaker, rate-limit backoff cap, and
    # the digest-keyed on-disk code cache
    "MYTHRIL_TPU_RPC_PROVIDERS": ("providers", None, None),
    "MYTHRIL_TPU_RPC_BREAKER_FAILS": ("int", 1, None),
    "MYTHRIL_TPU_RPC_BREAKER_COOLDOWN_S": ("float", 0.0, None),
    "MYTHRIL_TPU_RPC_BACKOFF_CAP_S": ("float", 0.0, None),
    "MYTHRIL_TPU_RPC_POOL_ATTEMPTS": ("int", 1, None),
    "MYTHRIL_TPU_RPC_CACHE": ("flag", None, None),
    "MYTHRIL_TPU_RPC_CACHE_DIR": ("dir", None, None),
    # live-chain ingestion (watch/): confirmation-depth lag behind the
    # head, poll cadence, the bounded backpressure backlog, and the
    # backfill start height (--from-block's env twin)
    "MYTHRIL_TPU_WATCH_CONFIRMATIONS": ("int", 0, None),
    "MYTHRIL_TPU_WATCH_POLL_S": ("float", 0.0, None),
    "MYTHRIL_TPU_WATCH_BACKLOG": ("int", 1, None),
    "MYTHRIL_TPU_WATCH_FROM_BLOCK": ("int", 0, None),
}

#: raw values :func:`env_flag` understands; anything else on a "flag"
#: knob is a typo that would run the default
FLAG_VALUES = ("0", "off", "false", "1", "on", "true", "force")


def _clamp(value, floor, ceil):
    if floor is not None and value < floor:
        value = type(value)(floor)
    if ceil is not None and value > ceil:
        value = type(value)(ceil)
    return value


def env_int(name: str, default: int, floor: Optional[int] = None,
            ceil: Optional[int] = None) -> int:
    """Integer knob read: unset/blank/malformed -> ``default``,
    out-of-range values clamp to [floor, ceil]."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return _clamp(int(raw), floor, ceil)
    except ValueError:
        return default


def env_float(name: str, default: float, floor: Optional[float] = None,
              ceil: Optional[float] = None) -> float:
    """Float twin of :func:`env_int`."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return _clamp(float(raw), floor, ceil)
    except ValueError:
        return default


def env_flag(name: str, default: bool = True) -> bool:
    """Kill-switch style boolean: ``0``/``off``/``false`` disable,
    ``1``/``on``/``true``/``force`` enable, anything else (including
    unset) keeps the default."""
    raw = os.environ.get(name, "").lower()
    if raw in ("0", "off", "false"):
        return False
    if raw in ("1", "on", "true", "force"):
        return True
    return default


def validate_env(environ=None) -> None:
    """Strict startup pass over :data:`KNOWN_SPECS`: raises
    :class:`EnvSpecError` on the first malformed or out-of-range value
    set in the environment.  Unset and blank knobs pass."""
    environ = os.environ if environ is None else environ
    for name in sorted(KNOWN_SPECS):
        raw = environ.get(name)
        if raw is None or raw.strip() == "":
            continue
        kind, floor, ceil = KNOWN_SPECS[name]
        if kind == "listen":
            from mythril_tpu_torch.parallel.fabric import parse_listen

            try:
                parse_listen(raw)
            except ValueError as exc:
                raise EnvSpecError(f"{name}={raw!r}: {exc}") from None
            continue
        if kind == "file":
            if not os.path.isfile(raw):
                raise EnvSpecError(f"{name}={raw!r}: file does not exist")
            if os.path.getsize(raw) == 0:
                raise EnvSpecError(f"{name}={raw!r}: file is empty")
            continue
        if kind == "flag":
            if raw.strip().lower() not in FLAG_VALUES:
                raise EnvSpecError(
                    f"{name}={raw!r}: not a flag "
                    f"(expected one of {'/'.join(FLAG_VALUES)})")
            continue
        if kind == "dir":
            if os.path.exists(raw) and not os.path.isdir(raw):
                raise EnvSpecError(
                    f"{name}={raw!r}: exists and is not a directory")
            continue
        if kind == "providers":
            entries = [e.strip() for e in raw.split(",") if e.strip()]
            if not entries:
                raise EnvSpecError(f"{name}={raw!r}: no provider endpoints")
            for entry in entries:
                if entry.startswith(("http://", "https://")):
                    continue
                host, _, port = entry.partition(":")
                if not host or (port and not port.isdigit()):
                    raise EnvSpecError(
                        f"{name}: bad provider entry {entry!r} "
                        "(expected URL or HOST[:PORT])")
            continue
        if kind == "policy":
            from mythril_tpu_torch.autopilot.policy import POLICIES

            if raw not in POLICIES:
                raise EnvSpecError(
                    f"{name}={raw!r}: not a policy "
                    f"(expected one of {'/'.join(sorted(POLICIES))})")
            continue
        try:
            value = int(raw) if kind == "int" else float(raw)
        except ValueError:
            raise EnvSpecError(
                f"{name}={raw!r}: not "
                f"{'an integer' if kind == 'int' else 'a number'}") from None
        if floor is not None and value < floor:
            raise EnvSpecError(f"{name}={value}: must be >= {floor}")
        if ceil is not None and value > ceil:
            raise EnvSpecError(f"{name}={value}: must be <= {ceil}")
