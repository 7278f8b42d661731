"""Durable checkpoint/resume plane and graceful drain (own copy of
``mythril_tpu/resilience/checkpoint.py``).

- **Journal**: an atomic, versioned, CRC-checked snapshot under
  ``--checkpoint-dir`` (tmp + fsync + rename; the last two generations
  are kept, and a corrupt newest one falls back to the older).  Each
  generation holds the exploration frontier (the open world states at
  the last transaction boundary and the transaction index), the
  detection modules' confirmed findings, the verdict-preserving solver
  channels of ``smt/bitblast.py`` (the permanent UNSAT memo, the SAT
  probe memo, recent models) and the dispatch and resilience counters.
  It holds no device tensor: a tensor reached from the frontier is
  written as host numpy and rebuilt on its device at load.
- **Cadence**: a boundary snapshot before every transaction of
  ``LaserEVM._execute_transactions``; between boundaries a refresh every
  ``MYTHRIL_TPU_CHECKPOINT_PERIOD`` seconds (default 30; 0 = every
  scheduler round) and after every ladder demotion.
- **Resume**: ``--resume DIR`` (``args.resume_from``) rebuilds the
  frontier from the newest valid generation and continues from the
  interrupted transaction; the restored channels re-decide the explored
  prefix from memo hits, so a killed and resumed run gives the
  uninterrupted run's findings.  A journal of another target (address
  or transaction count) is not grafted: the run starts fresh.
- **Drain**: SIGTERM/SIGINT set a cooperative drain flag that every
  long loop polls (the svm's scheduler rounds and transaction loop, the
  dispatch gate, the round ladders of ``ops/batched_sat.py`` and
  ``ops/dense_prop.py``); a final generation is written, and the report
  carries ``meta.resilience.partial``.  A second signal force-exits.

World states and findings pickle through reducers of a private
dispatch table: term nodes re-intern on load (fresh ids), accounts'
balance closures are rebuilt, storages drop their loader.  Channels
keyed by node id are frozen to node objects before pickling and thawed
to the resumed process's ids.
"""

import copyreg
import io
import logging
import os
import pickle
import signal
import struct
import threading
import time
import zlib
from copy import copy
from typing import Dict, Optional

import numpy as np

from mythril_tpu_torch.resilience.telemetry import resilience_stats

log = logging.getLogger(__name__)

JOURNAL_MAGIC = b"MTPUCKPT"
JOURNAL_VERSION = 1
JOURNAL_KEEP = 2          # generations retained
DEFAULT_PERIOD_S = 30.0


class JournalCorrupt(RuntimeError):
    """Every retained journal generation failed validation (bad magic,
    version mismatch, CRC mismatch, or truncated body)."""


def checkpoint_period_s() -> float:
    """Journal refresh cadence: ``MYTHRIL_TPU_CHECKPOINT_PERIOD``
    seconds (0 = every scheduler round), default 30."""
    try:
        return max(
            0.0,
            float(os.environ.get("MYTHRIL_TPU_CHECKPOINT_PERIOD",
                                 DEFAULT_PERIOD_S)),
        )
    except ValueError:
        return DEFAULT_PERIOD_S


# ---------------------------------------------------------------------------
# reducers: term nodes re-intern, balance closures rebuild, tensors go
# to the host
# ---------------------------------------------------------------------------


def _reintern_node(op, args, params, width, sort):
    from mythril_tpu_torch.smt import terms as T

    return T._I.get(op, args, params, width, sort)


def _reduce_node(node):
    # args unpickle (and re-intern) before the outer call runs, so
    # structural sharing and TRUE/FALSE identity survive the process
    # boundary; ids are reassigned by the resumed interner
    return _reintern_node, (
        node.op, node.args, node.params, node.width, node.sort,
    )


def _rebuild_account(state):
    from mythril_tpu_torch.laser.ethereum.state.account import Account

    account = Account.__new__(Account)
    account.__dict__.update(state)
    account.balance = lambda: account._balances[account.address]
    return account


def _reduce_account(account):
    state = dict(account.__dict__)
    state.pop("balance", None)  # per-instance closure: rebuilt on load
    return _rebuild_account, (state,)


def _rebuild_storage(state):
    from mythril_tpu_torch.laser.ethereum.state.account import Storage

    storage = Storage.__new__(Storage)
    storage.__dict__.update(state)
    storage.dynld = None  # a live loader never crosses the journal
    return storage


def _reduce_storage(storage):
    state = dict(storage.__dict__)
    state["dynld"] = None
    return _rebuild_storage, (state,)


def _tensor_from_host(array, device_type):
    import torch

    tensor = torch.from_numpy(array)
    if device_type == "cuda":
        tensor = tensor.to("cuda")
    return tensor


def _reduce_tensor(tensor):
    return _tensor_from_host, (
        np.ascontiguousarray(tensor.detach().cpu().numpy()),
        tensor.device.type,
    )


def _dispatch_table() -> dict:
    """copyreg's table plus the journal's reducers (a private table:
    pickling and copying elsewhere in the process are unaffected)."""
    import torch

    from mythril_tpu_torch.laser.ethereum.state.account import (
        Account, Storage,
    )
    from mythril_tpu_torch.smt import terms as T

    table = dict(copyreg.dispatch_table)
    table[T.Node] = _reduce_node
    table[Account] = _reduce_account
    table[Storage] = _reduce_storage
    table[torch.Tensor] = _reduce_tensor
    return table


def dumps(payload) -> bytes:
    """Pickle ``payload`` with the journal's reducers."""
    buffer = io.BytesIO()
    pickler = pickle.Pickler(buffer, protocol=4)
    pickler.dispatch_table = _dispatch_table()
    pickler.dump(payload)
    return buffer.getvalue()


# ---------------------------------------------------------------------------
# channel freeze/thaw: node-id keys -> node objects -> resumed ids
# ---------------------------------------------------------------------------


def _id_to_node() -> Dict[int, object]:
    from mythril_tpu_torch.smt import terms as T

    return {node.id: node for node in T._I.table.values()}


def _freeze_env(env, id2node):
    """EvalEnv -> journal form with node-object keys (drops the
    id-keyed persistent evaluation memo — it is a cache and its keys
    would be stale in the resumed process)."""
    variables = [
        (id2node[k], v) for k, v in env.variables.items() if k in id2node
    ]
    arrays = [
        (id2node[k], dict(v)) for k, v in env.arrays.items() if k in id2node
    ]
    ufs = [
        (id2node[fid], argvals, v)
        for (fid, argvals), v in env.ufs.items()
        if fid in id2node
    ]
    return {
        "variables": variables,
        "arrays": arrays,
        "ufs": ufs,
        "array_default": env.array_default,
    }


def _thaw_env(frozen):
    from mythril_tpu_torch.smt import terms as T

    return T.EvalEnv(
        variables={n.id: v for n, v in frozen["variables"]},
        arrays={n.id: dict(v) for n, v in frozen["arrays"]},
        ufs={(n.id, argvals): v for n, argvals, v in frozen["ufs"]},
        array_default=frozen["array_default"],
    )


def freeze_channels(ctx) -> dict:
    """Capture the verdict-preserving solver channels of a
    BlastContext in journal form: the permanent UNSAT memo, the SAT
    half of the probe memo (negative probes are model-version-scoped
    and would be stale), and the recent-model set.  Literal-level state
    (CNF pool, device nogoods) is derived and deliberately NOT
    journaled — literal numbering is an artifact of blast order; the
    resumed analysis re-derives it and re-learns nogoods as the memo
    hits re-refute."""
    from mythril_tpu_torch.smt import terms as T

    id2node = _id_to_node()

    def nodes_of(key):
        nodes = tuple(id2node.get(i) for i in key)
        return None if any(n is None for n in nodes) else nodes

    unsat_sets = [
        nodes for key in ctx.unsat_memo for nodes in (nodes_of(key),)
        if nodes is not None
    ]
    probe_sat = [
        (nodes, _freeze_env(env, id2node))
        for key, env in ctx.probe_memo.items()
        if isinstance(env, T.EvalEnv)
        for nodes in (nodes_of(key),)
        if nodes is not None
    ]
    models = [_freeze_env(env, id2node) for env in ctx.recent_models]
    return {"unsat_sets": unsat_sets, "probe_sat": probe_sat,
            "models": models}


def thaw_channels(ctx, channels: dict) -> None:
    """Seed a fresh BlastContext with journaled channels (keys rebuilt
    from the re-interned nodes' new ids)."""
    for nodes in channels.get("unsat_sets", ()):
        ctx.unsat_memo[tuple(sorted(n.id for n in nodes))] = True
    for nodes, frozen in channels.get("probe_sat", ()):
        ctx.probe_memo[
            tuple(sorted(n.id for n in nodes))
        ] = _thaw_env(frozen)
    ctx.recent_models = [
        _thaw_env(frozen) for frozen in channels.get("models", ())
    ]
    if ctx.recent_models:
        ctx.model_version += 1


# ---------------------------------------------------------------------------
# journal file format: MAGIC | version u32 | crc32 u32 | len u64 | body
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# journal file format: MAGIC | version u32 | crc32 u32 | len u64 | body
# ---------------------------------------------------------------------------

_HEADER = struct.Struct("<II Q")


def write_journal(directory: str, payload: dict) -> str:
    """Atomically persist one journal generation; returns its path.
    tmp + fsync + rename, then prune to the last JOURNAL_KEEP
    generations (never the one just written)."""
    os.makedirs(directory, exist_ok=True)
    body = dumps(payload)
    header = JOURNAL_MAGIC + _HEADER.pack(
        JOURNAL_VERSION, zlib.crc32(body), len(body)
    )
    generation = 1 + max(
        (g for g, _ in _generations(directory)), default=0
    )
    final = os.path.join(directory, f"ckpt-{generation:08d}.bin")
    tmp = os.path.join(directory, ".journal.tmp")
    with open(tmp, "wb") as fh:
        fh.write(header)
        fh.write(body)
        fh.flush()
        os.fsync(fh.fileno())
    os.rename(tmp, final)
    for _, stale in _generations(directory)[:-JOURNAL_KEEP]:
        try:
            os.unlink(stale)
        except OSError:
            pass
    return final


def _generations(directory: str):
    """[(generation, path)] ascending."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if name.startswith("ckpt-") and name.endswith(".bin"):
            try:
                out.append((int(name[5:-4]), os.path.join(directory, name)))
            except ValueError:
                continue
    return sorted(out)


def _read_one(path: str) -> dict:
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[: len(JOURNAL_MAGIC)] != JOURNAL_MAGIC:
        raise JournalCorrupt(f"{path}: bad magic")
    version, crc, length = _HEADER.unpack_from(raw, len(JOURNAL_MAGIC))
    if version != JOURNAL_VERSION:
        raise JournalCorrupt(
            f"{path}: journal version {version} != {JOURNAL_VERSION}"
        )
    body = raw[len(JOURNAL_MAGIC) + _HEADER.size:]
    if len(body) != length:
        raise JournalCorrupt(f"{path}: truncated body "
                             f"({len(body)} != {length})")
    if zlib.crc32(body) != crc:
        raise JournalCorrupt(f"{path}: CRC mismatch")
    return pickle.loads(body)


def load_journal(directory: str) -> Optional[dict]:
    """Newest valid journal generation, or None when the directory
    holds none (a kill before the first boundary).  Falls back one
    generation on corruption (that is what the second retained
    generation is for); raises :class:`JournalCorrupt` only when every
    generation failed validation — resuming from garbage must be loud,
    not silently fresh."""
    generations = _generations(directory)
    if not generations:
        return None
    errors = []
    for _, path in reversed(generations):
        try:
            payload = _read_one(path)
        except JournalCorrupt as exc:
            errors.append(str(exc))
            _note_corrupt_fallback(path, str(exc))
        except Exception as exc:  # noqa: BLE001 — unpickle failure
            errors.append(f"{path}: {exc}")
            _note_corrupt_fallback(path, str(exc))
        else:
            if errors:
                log.warning(
                    "checkpoint: resumed from an OLDER generation after "
                    "%d corrupt one(s) — up to one cadence window of "
                    "work will be re-executed", len(errors),
                )
            return payload
    raise JournalCorrupt("; ".join(errors))


def _note_corrupt_fallback(path: str, why: str) -> None:
    """One skipped-as-corrupt journal generation: loud, structured,
    counted.  The run survives on an older generation (that is what
    retention is for), but a silently rotting journal directory is an
    operator problem, not a log-greppable footnote."""
    resilience_stats.checkpoint_corrupt_fallbacks += 1
    log.warning("checkpoint: skipping corrupt journal %s (%s)", path, why)
    try:
        from mythril_tpu_torch.observability import spans as obs

        obs.instant("checkpoint.corrupt_fallback", cat="resilience",
                    path=os.path.basename(path), error=why)
    except Exception:  # noqa: BLE001 — telemetry never blocks a resume
        pass




# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

_drain_event = threading.Event()
_handlers_installed = False
_saved_handlers: Dict[int, object] = {}


def drain_requested() -> bool:
    """True when the run should wind down at the next cooperative
    boundary: the drain flag is set (SIGTERM / SIGINT), the request's
    wall-clock budget expired (``resilience/budget.py``), or the
    governor applied its terminal ``drain_partial`` rung
    (``resilience/governor.py``)."""
    if _drain_event.is_set():
        return True
    from mythril_tpu_torch.resilience.budget import budget_expired

    if budget_expired():
        return True
    from mythril_tpu_torch.resilience.governor import drain_rung_active

    return drain_rung_active()


def request_drain(reason: str = "signal") -> None:
    """Set the drain flag; the first request also fires a
    ``drain.requested`` instant, dumps the flight ring and flushes the
    ``--trace-out`` / ``--metrics-out`` / ``--lane-ledger-out``
    artifacts (the end of the run rewrites them whole)."""
    if not _drain_event.is_set():
        log.warning(
            "drain requested (%s): finishing in-flight rounds, writing a "
            "final checkpoint, and emitting a partial report", reason,
        )
        from mythril_tpu_torch.observability import flight as obs_flight
        from mythril_tpu_torch.observability import spans as obs

        obs.instant("drain.requested", cat="resilience", reason=reason)
        obs_flight.get_flight_recorder().dump("drain")
        try:
            from mythril_tpu_torch.observability import finalize_outputs

            finalize_outputs()
        except Exception:  # noqa: BLE001 — flushing must not stall drain
            log.debug("drain-time artifact flush failed", exc_info=True)
    _drain_event.set()


def install_signal_handlers() -> None:
    """SIGTERM/SIGINT -> cooperative drain; a second signal restores the
    default disposition and re-raises it, so a wedged drain can still be
    killed.  Main thread only; safe to call twice
    (:func:`restore_signal_handlers` undoes it)."""
    global _handlers_installed
    if _handlers_installed:
        return
    if threading.current_thread() is not threading.main_thread():
        return

    def _on_signal(signum, frame):
        # only the signal-driven flag counts as a first signal: an
        # expired budget also makes drain_requested() true
        if _drain_event.is_set():
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        request_drain(signal.Signals(signum).name)

    for signum in (signal.SIGTERM, signal.SIGINT):
        _saved_handlers[signum] = signal.getsignal(signum)
        signal.signal(signum, _on_signal)
    _handlers_installed = True


def restore_signal_handlers() -> None:
    """Put back the dispositions :func:`install_signal_handlers`
    replaced (main thread only)."""
    global _handlers_installed
    if threading.current_thread() is not threading.main_thread():
        return
    for signum, handler in _saved_handlers.items():
        signal.signal(signum, handler)
    _saved_handlers.clear()
    _handlers_installed = False


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


class CheckpointPlane:
    """Per-process checkpoint orchestration.

    ``_execute_transactions`` calls :meth:`restore_transactions` once
    and :meth:`transaction_boundary` per transaction; the scheduler
    round loop calls :meth:`tick`.  Everything is a no-op unless a
    checkpoint directory is configured (explicitly or through
    ``args.checkpoint_dir`` / ``args.resume_from``)."""

    def __init__(self):
        self._dir: Optional[str] = None
        self._resume = False
        self._restored: Optional[dict] = None
        self._restore_consumed = False
        self._boundary: Optional[dict] = None
        self._last_write = 0.0
        self._demotion_pending = False
        self.partial = False

    def configure(self, directory: Optional[str],
                  resume: bool = False) -> None:
        self._dir = directory
        self._resume = resume
        self._restored = None
        self._restore_consumed = False

    def _pull_args(self) -> None:
        """Late-bind to the args bus: the CLI and the analyzer set
        ``checkpoint_dir`` / ``resume_from`` there before LASER runs."""
        if self._dir is not None:
            return
        from mythril_tpu_torch.support.support_args import args

        resume_from = getattr(args, "resume_from", None)
        directory = getattr(args, "checkpoint_dir", None) or resume_from
        if directory:
            self.configure(directory, resume=bool(resume_from))

    @property
    def active(self) -> bool:
        self._pull_args()
        return self._dir is not None

    @staticmethod
    def _frontier_snapshot(open_states) -> list:
        """Private copies of the open world states, CFG references
        stripped (detection modules are callbacks, so findings do not
        depend on the statespace of completed transactions)."""
        snapshot = []
        for world_state in open_states:
            ws = copy(world_state)
            ws.node = None
            snapshot.append(ws)
        return snapshot

    @staticmethod
    def _findings_snapshot() -> dict:
        from mythril_tpu_torch.analysis.module.loader import ModuleLoader

        findings, caches = {}, {}
        for module in ModuleLoader().get_detection_modules():
            name = type(module).__name__
            findings[name] = list(module.issues)
            caches[name] = set(module.cache)
        return {"issues": findings, "caches": caches}

    def _payload(self) -> dict:
        from mythril_tpu_torch.ops.batched_sat import dispatch_stats
        from mythril_tpu_torch.smt.solver import get_blast_context

        payload = dict(self._boundary)
        payload["channels"] = freeze_channels(get_blast_context())
        payload["stats"] = {
            "dispatch": {
                k: v for k, v in dispatch_stats.__dict__.items()
                if isinstance(v, (int, float, bool))
            },
            "resilience": resilience_stats.as_dict(),
        }
        payload["partial"] = self.partial
        return payload

    def _write(self) -> None:
        began = time.monotonic()
        try:
            write_journal(self._dir, self._payload())
        except Exception as exc:  # noqa: BLE001 — a full disk must not
            #                       kill the analysis it exists to save
            log.error("checkpoint write failed: %s", exc)
            return
        elapsed = time.monotonic() - began
        resilience_stats.checkpoints_written += 1
        resilience_stats.checkpoint_s += elapsed
        from mythril_tpu_torch.observability import spans as obs

        obs.instant("checkpoint.write", cat="resilience",
                    elapsed_ms=round(elapsed * 1e3, 3))
        self._last_write = time.monotonic()
        self._demotion_pending = False

    def transaction_boundary(self, laser, address: int,
                             tx_index: int) -> None:
        """Snapshot the boundary (transactions before ``tx_index`` are
        complete; ``open_states`` is the pruned frontier ``tx_index``
        runs from) and write a journal generation."""
        if not self.active:
            return
        self._boundary = {
            "kind": "mythril-tpu-checkpoint",
            "address": int(address),
            "tx_index": int(tx_index),
            "transaction_count": int(laser.transaction_count),
            "open_states": self._frontier_snapshot(laser.open_states),
            "findings": self._findings_snapshot(),
        }
        self._write()

    def tick(self) -> None:
        """Refresh from the scheduler round loop (same boundary, fresh
        channels and counters): on the cadence, or at once after a
        demotion flagged by :meth:`note_demotion`."""
        if not self.active or self._boundary is None:
            return
        if not self._demotion_pending and (
            time.monotonic() - self._last_write < checkpoint_period_s()
        ):
            return
        self._write()

    def note_demotion(self) -> None:
        """Called by the ladder on every demotion: the next tick writes
        a generation whatever the cadence."""
        self._demotion_pending = True

    def finalize(self, partial: bool = False) -> None:
        """Last journal of the run (drain or completion)."""
        self.partial = self.partial or partial
        if self.active and self._boundary is not None:
            self._write()

    def restore_transactions(self, laser, address: int) -> int:
        """When resuming: rebuild the frontier and findings from the
        journal and return the transaction index to continue from; 0
        (a fresh start) when not resuming, when the directory holds no
        journal, or when the journal describes another target."""
        if not self.active or not self._resume or self._restore_consumed:
            return 0
        self._restore_consumed = True
        payload = load_journal(self._dir)
        if payload is None:
            log.warning("checkpoint: --resume with an empty journal "
                        "directory; starting fresh")
            return 0
        if payload.get("address") != int(address) or (
            payload.get("transaction_count") != laser.transaction_count
        ):
            log.warning(
                "checkpoint: journal targets address %s / %s txs, not "
                "%s / %s; starting fresh",
                payload.get("address"), payload.get("transaction_count"),
                int(address), laser.transaction_count,
            )
            return 0
        from mythril_tpu_torch.analysis.module.loader import ModuleLoader
        from mythril_tpu_torch.ops.batched_sat import reset_resident_pools
        from mythril_tpu_torch.smt.solver import get_blast_context

        laser.open_states = list(payload["open_states"])
        findings = payload.get("findings", {})
        for module in ModuleLoader().get_detection_modules():
            name = type(module).__name__
            if name in findings.get("issues", {}):
                module.issues = list(findings["issues"][name])
            if name in findings.get("caches", {}):
                module.cache = set(findings["caches"][name])
        thaw_channels(get_blast_context(), payload.get("channels", {}))
        # a pool, cone layout or word program uploaded before the journal
        # describes literals and node ids the resumed process renumbered
        reset_resident_pools()
        for key, value in payload.get("stats", {}).get(
                "resilience", {}).items():
            if hasattr(resilience_stats, key):
                setattr(resilience_stats, key, value)
        resilience_stats.resumes += 1
        # the restored boundary is this run's refresh template
        self._boundary = {
            k: payload[k]
            for k in ("kind", "address", "tx_index", "transaction_count",
                      "open_states", "findings")
        }
        log.info(
            "checkpoint: resumed at transaction %d/%d with %d open "
            "states, %d memoized UNSAT sets",
            payload["tx_index"], payload["transaction_count"],
            len(laser.open_states),
            len(payload.get("channels", {}).get("unsat_sets", ())),
        )
        return int(payload["tx_index"])


_plane: Optional[CheckpointPlane] = None


def get_checkpoint_plane() -> CheckpointPlane:
    global _plane
    if _plane is None:
        _plane = CheckpointPlane()
    return _plane


def reset_for_tests() -> None:
    global _plane
    _plane = None
    _drain_event.clear()
