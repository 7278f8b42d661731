"""The port's fleet (``mythril_tpu_torch/parallel/fleet.py`` and
``coordinator.py``) against the JAX package's, on the CPU.

- **The coordinator's state machine**, driven on both packages with the
  fake clock and worker handles of ``tests/test_fleet.py`` by the same
  event script: grant and result, heartbeat expiry and re-lease from the
  journal, zombie fencing, gossip routing and the ``gossip_drop`` fault,
  the straggler split, total loss, the lease retry budget and a
  cancelled lease.  After each script the leases (state, epoch,
  attempts, holder, journal), the seats, the frames each handle was sent
  and the JAX package's counters are equal between the packages.
- **The pieces around it** on both packages: ``split_lease_journal``,
  the merge's dedup, the kill switch and roles, a worker's spans
  absorbed and its ledger snapshot merged (equal tracers and ledgers),
  the error frames (an injected error leased again on both; any other
  raising ``FleetWorkerError`` on the port only, the decided
  divergence).
- **End to end over loopback**, each package's CLI in processes of its
  own (``--device cpu`` on the port, ``MYTHRIL_TPU_PALLAS=force`` on the
  JAX side): ``chaos_tree -t 2`` with ``--workers 2`` against
  ``--workers 0``, full offload of killbilly (SWC-106 arrives only
  through the merge), ``worker_kill:1`` recovering, and a worker that
  raises a ``RuntimeError`` no fault plane injected (the port exits 1
  naming the worker, the JAX package leases it again and finishes).

Every end-to-end run pins the heartbeat TTL high, the straggler split
off, the connect timeout long and one intra-op thread a process
(:data:`STEADY_ENV`), so that a loaded host turns no slow worker into a
death or a split; :func:`fleet_hygiene`
fails a test that leaves a spawned process or a fleet temp dir behind.
"""

import importlib
import json
import os
import stat
import subprocess
import sys
import tempfile
import time
import uuid
from types import SimpleNamespace

import pytest

import bench

pytestmark = pytest.mark.fleet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}

#: the JAX package's counters (the port adds ``inprocess_leases``)
JAX_COUNTERS = ("leases", "rebalances", "worker_deaths", "gossip_sent",
                "gossip_dropped_stale", "auth_rejects", "frame_rejects",
                "remote_attaches", "persist_deltas_sent",
                "persist_deltas_applied")

#: the knobs of every end-to-end run: a loaded host must not turn a
#: slow worker into a death or a split, and the routes do not depend on
#: the clock
STEADY_ENV = {
    "MYTHRIL_TPU_FLEET_LEASE_TTL_S": "120",
    "MYTHRIL_TPU_FLEET_SPLIT_AFTER_S": "0",
    "MYTHRIL_TPU_FLEET_CONNECT_TIMEOUT_S": "300",
    "MYTHRIL_TPU_SEG_CEIL_MS": "1e9",
    "MYTHRIL_TPU_DISPATCH_TIMEOUT": "3600",
    # one intra-op thread a process: a run is a coordinator and its
    # workers, beside the other test files' processes, on a few cores
    "OMP_NUM_THREADS": "1",
}
E2E_TIMEOUT_S = 600


def package(side):
    """The fleet's modules of one package."""
    name = SIDES[side]
    mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
    return SimpleNamespace(
        side=side,
        fleet=mod("parallel.fleet"),
        coordinator=mod("parallel.coordinator"),
        gossip=mod("parallel.gossip"),
        fabric=mod("parallel.fabric"),
        checkpoint=mod("resilience.checkpoint"),
        faults=mod("resilience.faults"),
        args=mod("support.support_args").args,
        WorldState=mod("laser.ethereum.state.world_state").WorldState,
    )


# ---------------------------------------------------------------------------
# hygiene: no spawned process and no fleet temp dir outlives a test
# ---------------------------------------------------------------------------


def _tagged_pids(tag: str):
    """The processes (other than this one) whose environment holds the
    test's tag: every process a test started, and every process they
    started, reparented or not."""
    want = f"MTPU_FLEET_TEST_TAG={tag}".encode()
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as fh:
                environ = fh.read().split(b"\0")
        except OSError:
            continue
        if want in environ:
            pids.append(int(name))
    return pids


@pytest.fixture(autouse=True)
def fleet_hygiene(monkeypatch, tmp_path):
    """Both packages' fault planes and fleet counters reset around the
    test; a tag in the environment of every process it starts and a temp
    dir of its own.  Afterwards no tagged process may live (10 s of
    grace) and no ``mtpu-`` fleet file may remain in the temp dir."""
    for side in SIDES:
        pkg = package(side)
        pkg.faults.reset_for_tests()
        pkg.fleet.reset_fleet_for_tests()
    tag = uuid.uuid4().hex
    monkeypatch.setenv("MTPU_FLEET_TEST_TAG", tag)
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setenv("TMPDIR", str(scratch))
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    yield scratch
    for side in SIDES:
        pkg = package(side)
        pkg.faults.reset_for_tests()
        pkg.fleet.reset_fleet_for_tests()
    deadline = time.monotonic() + 10.0
    while _tagged_pids(tag) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _tagged_pids(tag), "a spawned process outlived its test"
    left = [name for name in os.listdir(scratch) if name.startswith("mtpu-")]
    assert not left, f"fleet temp files left behind: {left}"


# ---------------------------------------------------------------------------
# the state machine on both packages
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


class FakeHandle:
    """A worker handle that records sends, drains and kills; with no
    ``conn`` it counts as connected."""

    def __init__(self):
        self.sent = []
        self.drained = 0
        self.killed = 0

    def send(self, header, body=b""):
        self.sent.append((header, body))
        return True

    def drain(self):
        self.drained += 1

    def kill(self):
        self.killed += 1


class Machine:
    """One package's coordinator under a fake clock, its leases staged
    in ``base``."""

    def __init__(self, pkg, base, workers=2, spawner=None, **config):
        self.pkg = pkg
        self.base = str(base)
        self.clock = FakeClock()
        self.handles = {}

        def spawn(worker_id, respawn):
            self.handles[worker_id] = FakeHandle()
            return self.handles[worker_id]

        self.c = pkg.coordinator.Coordinator(
            pkg.coordinator.FleetConfig(workers=workers, **config),
            {"name": "test"}, spawner=spawner or spawn, clock=self.clock)

    def stage(self, n_states=2, tx_index=1, tag="l0"):
        directory = os.path.join(self.base, tag)
        self.pkg.fleet._write_lease_journal(
            directory, address=0xABC, tx_index=tx_index,
            transaction_count=2,
            states=[self.pkg.WorldState() for _ in range(n_states)])
        return self.c.add_lease(directory, tx_index, n_states)

    def grant_all(self):
        for _ in range(self.c.config.workers):
            self.c._new_seat()
        self.c.assign()

    def send(self, worker_id, lease, kind, epoch=None, body=b"", **extra):
        header = {"type": kind, "lease_id": lease.lease_id,
                  "stamp": {"lease_epoch": lease.epoch if epoch is None
                            else epoch}, **extra}
        self.c.handle_message(worker_id, header, body)

    def counters(self):
        stats = self.pkg.fleet.fleet_stats.as_dict()
        return {name: stats[name] for name in JAX_COUNTERS}

    def state(self):
        """Everything a script may leave different: leases, seats, the
        frames sent, the counters."""
        rel = lambda path: os.path.relpath(path, self.base)  # noqa: E731

        def frame(header):
            kept = {k: v for k, v in header.items()
                    if k not in ("payload", "journal_dir")}
            if "journal_dir" in header:
                kept["journal_dir"] = rel(header["journal_dir"])
            return kept

        return {
            "leases": {
                lid: (l.state, l.epoch, l.attempts, l.worker_id, l.n_states,
                      l.tx_index, l.splitting, rel(l.journal_dir),
                      None if l.result is None else sorted(l.result))
                for lid, l in self.c.leases.items()},
            "seats": {wid: (s.dead, s.lease_id)
                      for wid, s in self.c.seats.items()},
            "sent": {wid: [frame(h) for h, _ in handle.sent]
                     for wid, handle in self.handles.items()},
            "drained": {wid: h.drained for wid, h in self.handles.items()},
            "counters": self.counters(),
        }


def script_grant_and_result(m):
    lease = m.stage()
    m.grant_all()
    assert lease.state == "running" and m.counters()["leases"] == 1
    granted = [h for h, _ in m.c.seats[lease.worker_id].handle.sent
               if h["type"] == "lease"]
    assert granted[0]["journal_dir"] == lease.journal_dir
    m.send(lease.worker_id, lease, "result", found_swcs=[])
    assert lease.state == "done" and not m.c.unfinished()


def script_heartbeat_expiry_releases_from_journal(m):
    m.c.config.lease_ttl_s = 5.0
    lease = m.stage()
    m.grant_all()
    first, old_dir = lease.worker_id, lease.journal_dir
    m.clock.advance(4.0)
    m.send(first, lease, "heartbeat")
    m.c.sweep()
    assert lease.state == "running"
    m.clock.advance(6.0)
    m.c.sweep()
    assert m.c.seats[first].dead and lease.state == "pending"
    assert lease.epoch == 1 and lease.journal_dir != old_dir
    payload = m.pkg.checkpoint.load_journal(lease.journal_dir)
    assert payload["tx_index"] == 1 and len(payload["open_states"]) == 2
    m.c.assign()
    assert lease.state == "running" and lease.worker_id != first


def script_zombie_messages_are_fenced(m):
    m.c.config.lease_ttl_s = 5.0
    lease = m.stage()
    m.grant_all()
    zombie = lease.worker_id
    m.clock.advance(10.0)
    m.c.sweep()
    m.c.assign()
    replacement = lease.worker_id
    m.send(zombie, lease, "gossip", epoch=0, body=b"junk")
    m.send(zombie, lease, "result", epoch=0, found_swcs=["999"])
    assert lease.state == "running"
    assert m.counters()["gossip_dropped_stale"] == 2
    m.send(replacement, lease, "result", epoch=1, found_swcs=[])
    assert lease.state == "done"


def script_gossip_routes_to_other_workers(m):
    from importlib import import_module

    solver = import_module(f"{SIDES[m.pkg.side]}.smt.solver")
    a = m.stage(tag="la")
    b = m.stage(tag="lb")
    m.grant_all()
    body = m.pkg.gossip.freeze_knowledge(solver.get_blast_context())
    m.send(a.worker_id, a, "gossip", body=body)
    assert m.counters()["gossip_sent"] == 1
    forwarded = [h for h, _ in m.c.seats[b.worker_id].handle.sent
                 if h["type"] == "gossip"]
    assert forwarded[0]["stamp"]["lease_epoch"] == b.epoch
    assert not [h for h, _ in m.c.seats[a.worker_id].handle.sent
                if h["type"] == "gossip"]


def script_gossip_drop_fault(m):
    lease = m.stage()
    m.grant_all()
    m.pkg.faults.get_fault_plane().arm("gossip_drop", times=1)
    m.send(lease.worker_id, lease, "gossip", body=b"x")
    assert m.counters()["gossip_sent"] == 0
    assert m.counters()["gossip_dropped_stale"] == 0


def script_straggler_split(m):
    m.c.config.split_after_s = 10.0
    m.c.config.lease_ttl_s = 300.0
    lease = m.stage(n_states=4)
    m.grant_all()
    worker = lease.worker_id
    assert m.c._idle_seats()
    m.clock.advance(11.0)
    m.send(worker, lease, "heartbeat")
    m.c.sweep()
    assert lease.splitting and m.c.seats[worker].handle.drained == 1
    m.send(worker, lease, "result", partial=True, found_swcs=[])
    assert lease.state == "done" and lease.result.get("split")
    halves = [l for l in m.c.leases.values() if l is not lease]
    assert sorted(h.n_states for h in halves) == [2, 2]
    for half in halves:
        payload = m.pkg.checkpoint.load_journal(half.journal_dir)
        assert len(payload["open_states"]) == half.n_states


def script_lease_retry_budget(m):
    m.c.config.workers = 1
    m.c.config.lease_ttl_s = 5.0
    m.c.config.lease_retries = 1
    lease = m.stage()
    for _ in range(2):
        m.grant_all()
        assert lease.state == "running"
        m.clock.advance(10.0)
        m.c.sweep()
    assert lease.state == "failed" and lease.attempts == 2


def script_cancel_lease_fences_epoch(m):
    m.c.config.workers = 1
    lease = m.stage(n_states=1, tx_index=0)
    m.c._new_seat()
    m.c.assign()
    holder = lease.worker_id
    assert m.c.cancel_lease(lease.lease_id, reason="client abandoned")
    assert lease.state == "done" and lease.result["cancelled"]
    assert m.c.seats[holder].lease_id is None
    m.send(holder, lease, "result", epoch=0, found_swcs=["999"])
    assert lease.result["found_swcs"] == []
    assert m.counters()["gossip_dropped_stale"] == 1
    assert not m.c.cancel_lease(lease.lease_id)


def script_injected_error_leases_again(m):
    lease = m.stage()
    m.grant_all()
    first = lease.worker_id
    m.send(first, lease, "error", error_type="FaultInjected",
           injected=True, message="FaultInjected: injected")
    assert lease.state == "pending" and lease.epoch == 1
    m.c.assign()
    assert lease.state == "running" and lease.attempts == 1


SCRIPTS = {
    "grant_and_result": script_grant_and_result,
    "heartbeat_expiry": script_heartbeat_expiry_releases_from_journal,
    "zombie_fenced": script_zombie_messages_are_fenced,
    "gossip_routing": script_gossip_routes_to_other_workers,
    "gossip_drop": script_gossip_drop_fault,
    "straggler_split": script_straggler_split,
    "retry_budget": script_lease_retry_budget,
    "cancel_lease": script_cancel_lease_fences_epoch,
    "injected_error": script_injected_error_leases_again,
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_state_machine_matches_jax(name, tmp_path):
    """One event script on both packages' coordinators: the same
    leases, seats, frames and counters afterwards."""
    states = {}
    for side in SIDES:
        machine = Machine(package(side), tmp_path / side)
        SCRIPTS[name](machine)
        states[side] = machine.state()
        package(side).faults.reset_for_tests()
    assert states["port"] == states["jax"]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_total_loss_degrades(side, tmp_path):
    """No seat can spawn: ``run`` returns with the lease still pending,
    for the caller to finish in-process."""
    pkg = package(side)
    machine = Machine(pkg, tmp_path, spawner=lambda wid, respawn: None,
                      spawn_retries=0)
    lease = machine.stage()
    machine.c.run()
    assert lease.state == "pending"
    assert machine.c.unfinished() and not machine.c.finished()


def test_port_error_not_injected_is_fatal(tmp_path):
    """The decided divergence, in the state machine: an error frame of a
    type no fault plane injects raises ``FleetWorkerError`` on the port
    (naming the worker and the error); the JAX package takes the lease
    back."""
    machines = {side: Machine(package(side), tmp_path / side)
                for side in SIDES}
    leases = {}
    for side, machine in machines.items():
        leases[side] = machine.stage()
        machine.grant_all()
    header = dict(error_type="RuntimeError", injected=False,
                  message="RuntimeError: CUDA error: an illegal memory "
                          "access was encountered")
    machines["jax"].send(leases["jax"].worker_id, leases["jax"], "error",
                         **header)
    assert leases["jax"].state == "pending" and leases["jax"].epoch == 1
    port = package("port")
    with pytest.raises(port.coordinator.FleetWorkerError,
                       match=r"worker w\d failed lease lease1: RuntimeError"):
        machines["port"].send(leases["port"].worker_id, leases["port"],
                              "error", **header)
    assert leases["port"].state == "running"


# ---------------------------------------------------------------------------
# journals, the merge, knobs and roles, on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", sorted(SIDES))
def test_split_lease_journal_roundtrip(side, tmp_path):
    pkg = package(side)
    directory = str(tmp_path / "lease")
    pkg.fleet._write_lease_journal(directory, address=1, tx_index=1,
                                   transaction_count=3,
                                   states=[pkg.WorldState()
                                           for _ in range(5)])
    halves = pkg.fleet.split_lease_journal(directory)
    assert sorted(n for _, _, n in halves) == [2, 3]
    assert [os.path.basename(d) for d, _, _ in halves] == [
        "lease.split-a", "lease.split-b"]
    solo = str(tmp_path / "solo")
    pkg.fleet._write_lease_journal(solo, address=1, tx_index=0,
                                   transaction_count=2,
                                   states=[pkg.WorldState()])
    assert pkg.fleet.split_lease_journal(solo) is None


@pytest.mark.parametrize("side", sorted(SIDES))
def test_merge_findings_dedup_roundtrip(side):
    """A worker's findings merge under the modules' address dedup; the
    same snapshot again (a re-explored subtree) adds nothing.  The port's
    snapshot crosses through its result body and its unpickler."""
    name = SIDES[side]
    loader = importlib.import_module(f"{name}.analysis.module.loader")
    report = importlib.import_module(f"{name}.analysis.report")
    fleet = package(side).fleet
    module = loader.ModuleLoader().get_detection_modules()[0]
    module.reset_module()
    module.cache.clear()
    cls = type(module).__name__
    issue = report.Issue(contract="c", function_name="f", address=42,
                         swc_id="106", title="t", bytecode="00")
    snapshot = {"issues": {cls: [issue]}, "caches": {cls: {42}}}
    if side == "port":
        import io

        body = fleet._result_dumps({"findings": snapshot})
        snapshot = fleet.ResultUnpickler(io.BytesIO(body)).load()["findings"]
    try:
        assert fleet._merge_findings(snapshot) == 1
        assert len(module.issues) == 1 and 42 in module.cache
        assert fleet._merge_findings(snapshot) == 0
        assert len(module.issues) == 1
    finally:
        module.reset_module()
        module.cache.clear()


def test_result_unpickler_refuses_a_jax_body():
    """A result body naming the JAX package's classes is refused before
    anything is built (the port never imports the JAX package)."""
    import io
    import pickle

    from mythril_tpu.analysis.report import Issue as JaxIssue

    port = package("port").fleet
    body = pickle.dumps({"findings": {"issues": {"M": [JaxIssue(
        contract="c", function_name="f", address=1, swc_id="106",
        title="t", bytecode="00")]}}}, protocol=4)
    with pytest.raises(port.ForeignResult, match="mythril_tpu.analysis"):
        port.ResultUnpickler(io.BytesIO(body)).load()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_kill_switch_and_roles(side, monkeypatch):
    pkg = package(side)
    monkeypatch.setattr(pkg.args, "fleet_workers", 2)
    assert pkg.fleet.seam_enabled()
    monkeypatch.setenv("MYTHRIL_TPU_FLEET", "0")
    assert not pkg.fleet.seam_enabled()
    assert pkg.fleet.effective_workers() == 0
    monkeypatch.delenv("MYTHRIL_TPU_FLEET")
    monkeypatch.setattr(pkg.args, "fleet_workers", 0)
    assert not pkg.fleet.seam_enabled()
    monkeypatch.setattr(pkg.args, "fleet_workers", None)
    monkeypatch.setenv("MYTHRIL_TPU_FLEET_WORKERS", "3")
    assert pkg.fleet.effective_workers() == 3
    monkeypatch.setenv("MYTHRIL_TPU_FLEET_ROLE", "worker")
    assert pkg.fleet.seam_enabled()
    assert not pkg.fleet.should_delegate(object())


def test_port_args_snapshot_carries_the_device(monkeypatch):
    """The worker's device travels in the lease payload as a plain
    string; the per-process paths do not."""
    pkg = package("port")
    monkeypatch.setattr(pkg.args, "device", "cpu")
    monkeypatch.setattr(pkg.args, "checkpoint_dir", "/nowhere")
    monkeypatch.setattr(pkg.args, "lane_ledger_out", "/nowhere.json")
    snap = pkg.fleet._args_snapshot()
    assert snap["device"] == "cpu"
    assert "checkpoint_dir" not in snap and "lane_ledger_out" not in snap
    assert "fleet_workers" not in snap
    json.dumps(snap)


def test_port_worker_error_frame_names_the_type():
    """The ``error`` frame carries the exception's type and whether the
    fleet injected it."""
    from mythril_tpu_torch.resilience.faults import FaultInjected
    from mythril_tpu_torch.resilience.watchdog import WatchdogTimeout

    fleet = package("port").fleet
    session = SimpleNamespace(worker_id="w7")
    header = {"lease_id": "lease3", "stamp": {"lease_epoch": 2}}
    for exc, injected in ((FaultInjected("x"), True),
                          (WatchdogTimeout("y"), True),
                          (RuntimeError("CUDA error"), False)):
        frame = fleet._error_frame(session, header, exc)
        assert frame["error_type"] == type(exc).__name__
        assert frame["injected"] is injected
        assert frame["stamp"] == {"lease_epoch": 2}


WORKER_EVENTS = [
    {"name": "svm.transaction", "ph": "X", "ts": 1.0, "dur": 5.0,
     "pid": 4242, "tid": 7, "args": {"tx": 1}},
    {"name": "fleet.lease_grant", "ph": "i", "ts": 2.0, "pid": 4242,
     "tid": 7},
    {"name": "process_name", "ph": "M", "pid": 4242, "tid": 0,
     "args": {"name": "worker"}},
    {"not": "an event"},
]


@pytest.mark.parametrize("cap", [64, 3])
def test_absorbed_worker_events_match_jax(cap, monkeypatch):
    """A worker's span stream absorbed by both packages' tracers: the
    same events (a synthetic pid a worker, re-parented under the trace
    id, a ``process_name`` label), counts and drops, at a cap that holds
    them all and at one that does not; per-name totals only from
    ``add_external_total``."""
    got = {}
    for side, name in SIDES.items():
        spans = importlib.import_module(f"{name}.observability.spans")
        monkeypatch.setenv("MYTHRIL_TPU_TRACE_CAP", str(cap))
        tracer = spans.Tracer()
        tracer.enable(record_events=True)
        counts = [tracer.absorb_events(WORKER_EVENTS, worker=w,
                                       trace_id="t-1")
                  for w in ("w1", "w2", "w1")]
        tracer.add_external_total("fleet.worker:w1", 2.5)
        got[side] = (counts, tracer.events(), tracer.span_count,
                     tracer.instant_count, tracer.dropped,
                     tracer.totals_snapshot(), tracer.counts_snapshot())
    assert got["port"] == got["jax"]
    assert {e["pid"] for e in got["port"][1]} <= {1_000_001, 1_000_002}


def test_merged_worker_ledgers_match_jax():
    """Worker snapshots folded into both packages' ledgers give the same
    aggregates; conservation holds over the merge."""
    snaps = [
        {"lanes_total": 5, "batches": 2, "learned_clauses": 3,
         "by_kind": {"prune": 5}, "decided": {"tail": 3, "frontier": 2},
         "verdicts": {"tail:sat": 3, "frontier:unsat": 2},
         "transitions": {"dispatched": 2}, "routed": {"tail": 1},
         "tier_sweeps": {"frontier": 4}, "tier_wall_s": {"tail": 0.5},
         "by_contract": {"fleet-target": {"tail": 3, "frontier": 2}},
         "by_scope": {"lease1": {"tail": 3, "frontier": 2}}},
        {"lanes_total": 0},
        None,
        {"lanes_total": 2, "decided": {"word": 2},
         "by_scope": {"lease2": {"word": 2}}},
    ]
    got = {}
    for side, name in SIDES.items():
        ledger_mod = importlib.import_module(f"{name}.observability.ledger")
        ledger = ledger_mod.LaneLedger()
        absorbed = [ledger.merge_snapshot(snap) for snap in snaps]
        got[side] = (absorbed, ledger.snapshot())
    assert got["port"] == got["jax"]
    absorbed, snap = got["port"]
    assert absorbed == [5, 0, 0, 2]
    assert snap["lanes_total"] == sum(snap["decided"].values()) == 7
    assert snap["records_dropped"] == 7


# ---------------------------------------------------------------------------
# end to end over loopback, each package's CLI
# ---------------------------------------------------------------------------


def hexfile(tmp_path, name, code):
    path = tmp_path / f"{name}.hex"
    path.write_text(code)
    return str(path)


def cli(side, path, *extra, env=None):
    """Start one ``analyze`` of ``path`` by ``side``'s CLI (jsonv2), in a
    process of its own; :func:`finish` collects it."""
    if side == "jax":
        argv = [sys.executable, "myth", "analyze"]
    else:
        argv = [sys.executable, "-m", "mythril_tpu_torch", "analyze",
                "--device", "cpu"]
    argv += ["-f", path, "--bin-runtime", "--no-onchain-data", "-o",
             "jsonv2", *extra]
    environ = dict(os.environ, **STEADY_ENV, **(env or {}))
    if side == "jax":
        # one CPU device in the coordinator and its workers alike
        environ.update(JAX_PLATFORMS="cpu", XLA_FLAGS="",
                       MYTHRIL_TPU_PALLAS="force")
    return subprocess.Popen(argv, cwd=ROOT, env=environ, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish(proc):
    """(exit code, SWC ids, ``meta.resilience``, stderr) of a run."""
    try:
        out, err = proc.communicate(timeout=E2E_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{proc.args}: timed out: {err[-2000:]}")
    if proc.returncode != 0:
        return proc.returncode, None, None, err
    report = json.loads(out)[0]
    return (0, {i["swcID"] for i in report["issues"]},
            report["meta"].get("resilience", {}), err)


def finished_ok(proc):
    code, swcs, block, err = finish(proc)
    assert code == 0, err[-3000:]
    return swcs, block


def test_chaos_tree_two_workers_match_one_process_and_jax(tmp_path):
    """``chaos_tree -t 2 --workers 2``: the findings of one process, on
    both packages; two leases or more, the same count on both; no
    death."""
    path = hexfile(tmp_path, "chaos_tree", bench.chaos_tree_contract())
    procs = {(side, workers): cli(side, path, "-t", "2", "--workers",
                                  str(workers))
             for side in SIDES for workers in (0, 2)}
    got = {key: finished_ok(proc) for key, proc in procs.items()}
    for side in SIDES:
        single, fleet = got[(side, 0)], got[(side, 2)]
        assert fleet[0] == single[0] == {"SWC-106"}
        assert not any(k.startswith("fleet_") for k in single[1])
        assert fleet[1].get("fleet_leases", 0) >= 2
        assert not fleet[1].get("fleet_worker_deaths")
        assert not fleet[1].get("fleet_inprocess_leases")
    assert got[("port", 2)][1]["fleet_leases"] == \
        got[("jax", 2)][1]["fleet_leases"]


def test_full_offload_findings_come_through_the_merge(tmp_path):
    """``MYTHRIL_TPU_FLEET_MIN_STATES=1 --workers 1`` on killbilly: the
    whole analysis is one lease at the first boundary, so SWC-106 can
    only arrive through the worker's result."""
    path = hexfile(tmp_path, "killbilly", bench._corpus()[0][1])
    env = {"MYTHRIL_TPU_FLEET_MIN_STATES": "1"}
    procs = {side: cli(side, path, "-t", "1", "--workers", "1", env=env)
             for side in SIDES}
    for side, proc in procs.items():
        swcs, block = finished_ok(proc)
        assert swcs == {"SWC-106"}, side
        assert block.get("fleet_leases") == 1, (side, block)
        assert not block.get("fleet_inprocess_leases"), (side, block)


def test_worker_kill_recovers(tmp_path):
    """``MYTHRIL_TPU_FAULT=worker_kill:1``: each first-generation worker
    SIGKILLs itself at its first boundary; the coordinator sees the
    deaths, leases the journals again and the findings are equal."""
    path = hexfile(tmp_path, "chaos_tree", bench.chaos_tree_contract())
    env = {"MYTHRIL_TPU_FAULT": "worker_kill:1"}
    procs = {side: cli(side, path, "-t", "2", "--workers", "2", env=env)
             for side in SIDES}
    for side, proc in procs.items():
        swcs, block = finished_ok(proc)
        assert swcs == {"SWC-106"}, side
        assert block.get("fleet_worker_deaths", 0) >= 1, (side, block)
        assert block["fleet_leases"] > block["fleet_worker_deaths"]


#: the worker interpreter of the divergence test: the package's worker
#: module, with the symbolic executor replaced by one that raises a
#: RuntimeError (argv: this file, "-m", the worker module, its args)
BROKEN_WORKER = """#!{python}
import importlib, runpy, sys

module = sys.argv[2]
symbolic = importlib.import_module(
    module.split(".")[0] + ".analysis.symbolic")


def broken(*args, **kwargs):
    raise RuntimeError("a fault no fault plane injected")


symbolic.SymExecWrapper = broken
sys.argv = [module] + sys.argv[3:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def executable(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_worker_error_fails_the_port_and_leases_again_in_jax(tmp_path):
    """A worker whose analysis raises a ``RuntimeError`` that no fault
    plane injected (``MYTHRIL_TPU_FLEET_PYTHON`` runs the worker with a
    broken executor): the port's analysis exits 1 naming the worker and
    the error; the JAX package leases it again until its retry budget is
    spent and finishes it in-process."""
    path = hexfile(tmp_path, "killbilly", bench._corpus()[0][1])
    python = executable(tmp_path, "broken_worker.py",
                        BROKEN_WORKER.format(python=sys.executable))
    env = {"MYTHRIL_TPU_FLEET_MIN_STATES": "1",
           "MYTHRIL_TPU_FLEET_PYTHON": python}
    procs = {side: cli(side, path, "-t", "1", "--workers", "1", env=env)
             for side in SIDES}
    code, _swcs, _block, err = finish(procs["port"])
    assert code == 1, err[-3000:]
    assert "worker w1 failed lease lease1: RuntimeError: a fault no fault " \
        "plane injected" in err
    swcs, block = finished_ok(procs["jax"])
    assert swcs == {"SWC-106"}
    assert block["fleet_leases"] == 3  # the first grant and two retries
