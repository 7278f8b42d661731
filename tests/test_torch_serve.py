"""The port's serve plane (``mythril_tpu_torch/serve/``) against the JAX
package's, on the CPU.

The cases of ``tests/test_serve.py`` and the serve-plane cases of
``tests/test_fabric.py`` run on both packages.  Each package gets one
module-scoped in-process ``AnalysisServer`` on port 0 (the port's with
``device="cpu"``, the JAX package's under the pins the other parity
tests use: ``MYTHRIL_TPU_PALLAS=force`` and one device); the same
requests go to both, and the status codes, error codes, ``findings_swc``
and ``partial`` must be equal (the bodies are compared without request
ids, trace ids and walls).  Unit-level cases drive both packages'
classes with the same inputs.

Beyond the JAX cases:

- a remote seat behind the router, on each package: a server with
  ``fleet_listen`` on loopback and a secret file, one ``worker
  --connect`` process of the same package, and a request answered by
  the seat with the findings of a server without a fabric;
- the ``DeviceLost`` divergence: on the port a lost card answers the
  request in flight with 503 (``device_lost``), ``/readyz`` answers
  503, and ``run_server`` returns 1, where the JAX server demotes to its
  host CDCL and goes on serving;
- ``serve`` as a process on each package: ``/readyz``, one request,
  ``top --once`` against it, and SIGTERM draining it to exit 0 with its
  ``--trace-out`` and ``--metrics-out`` files.

Hygiene: after every test no server thread other than the shared
servers' is alive, no process the test started is running, each
package's coalescer is in serve mode only while its shared server runs,
and both drain events are clear.  The breaker and cooldown knobs are
pinned as the JAX file pins them, so that a loaded host does not turn
slow requests into breaker trips.
"""

import importlib
import io
import json
import os
import re
import secrets
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
from types import SimpleNamespace

import pytest

import bench
from test_torch_fleet import STEADY_ENV, _tagged_pids

pytestmark = pytest.mark.serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}

#: the JAX file's fast breaker, and the parity runs' steady knobs
SERVE_ENV = {
    "MYTHRIL_TPU_SERVE_BREAKER": "2",
    "MYTHRIL_TPU_SERVE_BREAKER_COOLDOWN": "0.5",
    "MYTHRIL_TPU_PALLAS": "force",
    **STEADY_ENV,
}


def package(side):
    """The serve plane's modules of one package."""
    name = SIDES[side]
    mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
    return SimpleNamespace(
        side=side,
        admission=mod("serve.admission"),
        config=mod("serve.config"),
        protocol=mod("serve.protocol"),
        http=mod("serve.http"),
        fabric=mod("serve.fabric"),
        coordinator=mod("parallel.coordinator"),
        coalesce=mod("ops.coalesce"),
        async_dispatch=mod("ops.async_dispatch"),
        batched_sat=mod("ops.batched_sat"),
        budget=mod("resilience.budget"),
        faults=mod("resilience.faults"),
        watchdog=mod("resilience.watchdog"),
        checkpoint=mod("resilience.checkpoint"),
        telemetry=mod("resilience.telemetry"),
        solver=mod("smt.solver"),
        plane=mod("persist.plane"),
        metrics=mod("observability.metrics"),
        env=mod("support.env"),
        top=importlib.import_module("mythril_tpu_torch.interfaces.top"),
    )


def clean_process_state(side):
    """The JAX file's ``_clean_process_state`` on one package."""
    pkg = package(side)
    pkg.budget.reset_for_tests()
    pkg.faults.reset_for_tests()
    pkg.watchdog.reset_for_tests()
    pkg.checkpoint.reset_for_tests()
    pkg.coalesce.set_serve_mode(False)
    pkg.coalesce.set_request_scope(None)
    pkg.coalesce.reset_coalescer(hard=True)
    if side == "jax":
        pkg.async_dispatch.get_async_dispatcher().drop()
    else:
        pkg.async_dispatch.reset_async_dispatch()
    pkg.batched_sat.dispatch_stats.reset()
    pkg.solver.reset_blast_context()


def make_config(side, **fields):
    """A ``ServeConfig`` of ``side`` (the port's on the CPU)."""
    if side == "port":
        fields.setdefault("device", "cpu")
    return package(side).config.ServeConfig(**fields)


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------


#: the shared servers while they run, by side
SHARED = {}


def _serve_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("mythril-serve") and t.is_alive()}


def _server_threads(srv):
    threads = {srv.engine._thread, srv._http_thread}
    if srv.router is not None:
        threads.add(srv.router._thread)
    return threads


def _time_handlers():
    return [importlib.import_module(
        f"{name}.laser.ethereum.time_handler").time_handler
        for name in SIDES.values()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain CPU tiers on one intra-op thread, as in
    ``tests/test_torch_persist.py``: beside the other test files' busy
    processes, torch's pool of threads slows them all."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def serve_hygiene(monkeypatch):
    """A tag in the environment of every process the test starts; each
    package's execution deadline put back after the test (every served
    request arms it, and one left armed would expire under a later test
    in this process); after the test: no serve thread but the shared
    servers', no tagged process alive (10 s of grace), serve mode on only
    while the package's shared server runs, both drain events clear."""
    tag = uuid.uuid4().hex
    monkeypatch.setenv("MTPU_FLEET_TEST_TAG", tag)
    handlers = _time_handlers()
    deadlines = [handler._deadline_ms for handler in handlers]
    yield
    for handler, deadline in zip(handlers, deadlines):
        handler._deadline_ms = deadline
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and (
            _tagged_pids(tag) or _stray_threads()):
        time.sleep(0.1)
    assert not _tagged_pids(tag), "a process outlived its test"
    assert not _stray_threads(), "a server thread outlived its test"
    for side in SIDES:
        pkg = package(side)
        assert pkg.coalesce.serve_mode() == (side in SHARED), side
        assert not pkg.checkpoint._drain_event.is_set(), side


def _stray_threads():
    allowed = set()
    for srv in SHARED.values():
        allowed |= _server_threads(srv)
    return _serve_threads() - allowed


@pytest.fixture(scope="module")
def servers():
    """One live server of each package for the module, started under
    :data:`SERVE_ENV`, with both packages' dispatch deadlines out of
    reach and the JAX package on one device."""
    import jax

    patch = pytest.MonkeyPatch()
    for name, value in SERVE_ENV.items():
        patch.setenv(name, value)
    devices = jax.devices
    patch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    for side in SIDES:
        patch.setattr(package(side).watchdog, "DEADLINE_FLOOR_S", 3600.0)
        clean_process_state(side)
    for side in SIDES:
        srv = package(side).http.AnalysisServer(
            package(side).config.ServeConfig.from_env(
                port=0, **({"device": "cpu"} if side == "port" else {})))
        srv.start()
        SHARED[side] = srv
    yield dict(SHARED)
    for side in list(SHARED):
        SHARED.pop(side).drain_and_stop("tests done")
    patch.undo()
    for side in SIDES:
        clean_process_state(side)
    assert not _serve_threads()
    for side in SIDES:
        assert not package(side).coalesce.serve_mode()


# ---------------------------------------------------------------------------
# HTTP helpers and the compared view of a response
# ---------------------------------------------------------------------------


def _post(port, payload, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/analyze",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _get(port, path):
    try:
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=60)
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


#: what differs between two runs of one request: ids, walls, the device
VOLATILE = ("request_id", "trace_id", "analysis_s", "budget_s",
            "budget_remaining_s", "mode", "meta", "worker")


def view(status, body):
    """What the parity compares of a response: the status, the error
    code, the findings, ``partial``, the issues without their discovery
    walls, and the body's keys."""
    out = {"status": status, "keys": sorted(set(body) - set(VOLATILE))}
    if "error" in body:
        out["code"] = body["error"]["code"]
    for key in ("findings_swc", "partial", "cached", "aborted_at_tx"):
        if key in body:
            out[key] = body[key]
    if "issues" in body:
        out["issues"] = [
            {k: v for k, v in issue.items() if k != "extra"}
            for issue in body["issues"]
        ]
    return out


def both(servers, payload):
    """POST ``payload`` to the JAX server, then to the port's; returns
    {side: (status, body, headers)} after checking the views equal."""
    out = {side: _post(servers[side].port, payload)
           for side in ("jax", "port")}
    assert view(*out["port"][:2]) == view(*out["jax"][:2])
    return out


def _killbilly():
    return bench._corpus()[0][1]


def _kb(source, **extra):
    return {"code": _killbilly(), "name": "killbilly", "tx_count": 1,
            "source": source, **extra}


# ---------------------------------------------------------------------------
# unit level: protocol, config, admission, breakers (both packages)
# ---------------------------------------------------------------------------


MALFORMED = [
    ({"code": "zz80"}, "bad_bytecode"),
    ({"code": "608"}, "bad_bytecode"),
    ({"code": ""}, "bad_bytecode"),
    ({}, "bad_bytecode"),
    ({"code": "6080", "priority": "urgent"}, "bad_class"),
    ({"code": "6080", "deadline_s": -2}, "bad_deadline"),
    ({"code": "6080", "deadline_s": 1e9}, "bad_deadline"),
    ({"code": "6080", "tx_count": 99}, "bad_tx_count"),
    ({"code": "6080", "tx_count": "two"}, "bad_tx_count"),
    ({"code": "6080", "solc_json": "{not json"}, "bad_solc_json"),
    ({"code": "6080", "solc_json": [1]}, "bad_solc_json"),
    ({"code": "6080", "modules": "Suicide"}, "bad_modules"),
    ({"code": "6080", "source": ""}, "bad_source"),
    ({"code": "6080", "trace_id": "a b"}, "bad_trace_id"),
]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_oversized_body_is_413_with_limit(side):
    pkg = package(side)
    with pytest.raises(pkg.protocol.RequestError) as exc:
        pkg.protocol.parse_analyze_request(
            b"x" * 65, make_config(side, max_body_bytes=64))
    assert exc.value.status == 413
    assert exc.value.code == "body_too_large"
    assert exc.value.extra["limit_bytes"] == 64


def test_valid_request_parses_as_jax():
    raw = json.dumps({"code": "0x6080", "deadline_s": 5,
                      "modules": ["SuicideModule"]}).encode()
    parsed = {side: package(side).protocol.parse_analyze_request(
        raw, make_config(side)) for side in SIDES}
    assert vars(parsed["port"]) == vars(parsed["jax"])
    assert parsed["port"].code == "6080"
    assert parsed["port"].tx_count == 2
    assert parsed["port"].priority == "interactive"
    assert parsed["port"].deadline_s == 5.0


@pytest.mark.parametrize("env,value", [
    ("MYTHRIL_TPU_SERVE_MAX_BODY", "a-lot"),
    ("MYTHRIL_TPU_SERVE_QUEUE", "-1"),
    ("MYTHRIL_TPU_SERVE_BREAKER_COOLDOWN", "soon"),
])
def test_bad_knob_dies_at_startup(monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    for side in SIDES:
        pkg = package(side)
        with pytest.raises(pkg.config.ServeConfigError):
            pkg.config.ServeConfig.from_env()


def test_contradictory_deadlines_die_at_startup(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_SERVE_DEADLINE", "120")
    monkeypatch.setenv("MYTHRIL_TPU_SERVE_MAX_DEADLINE", "60")
    for side in SIDES:
        pkg = package(side)
        with pytest.raises(pkg.config.ServeConfigError):
            pkg.config.ServeConfig.from_env()


def test_serve_config_defaults_are_jax_and_the_device_is_the_card():
    jax_cfg = package("jax").config.ServeConfig.from_env()
    port_cfg = package("port").config.ServeConfig.from_env()
    port_fields = vars(port_cfg)
    assert port_fields.pop("device") == "cuda"
    assert port_fields == vars(jax_cfg)


def _request(side, source="unit", priority="interactive"):
    return package(side).protocol.AnalyzeRequest(
        code="6080", source=source, priority=priority)


def _shed(side, queue, request):
    """The shed's (status, code, retry_after) or None when admitted."""
    try:
        queue.submit(request)
    except package(side).protocol.RequestError as exc:
        return exc.status, exc.code, exc.extra.get("retry_after_s")
    return None


@pytest.mark.parametrize("side", sorted(SIDES))
def test_queue_full_sheds_with_retry_after(side):
    queue = package(side).admission.AdmissionQueue(make_config(
        side, queue_cap_interactive=2, queue_cap_batch=1, retry_after_s=7))
    outcomes = [_shed(side, queue, _request(side)) for _ in range(3)]
    outcomes += [_shed(side, queue, _request(side, priority="batch"))
                 for _ in range(2)]
    assert outcomes == [None, None, (503, "queue_full", 7),
                        None, (503, "queue_full", 7)]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_interactive_class_pops_first(side):
    queue = package(side).admission.AdmissionQueue(make_config(side))
    queue.submit(_request(side, source="b", priority="batch"))
    queue.submit(_request(side, source="i", priority="interactive"))
    assert queue.pop(timeout=0).request.source == "i"
    assert queue.pop(timeout=0).request.source == "b"


@pytest.mark.parametrize("side", sorted(SIDES))
def test_rss_watermark_sheds(side):
    pkg = package(side)
    assert pkg.config.current_rss_mb() > 1
    queue = pkg.admission.AdmissionQueue(make_config(side,
                                                     rss_watermark_mb=1))
    assert _shed(side, queue, _request(side)) == (503, "overloaded_rss", 5)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_draining_queue_sheds_and_returns_pending(side):
    queue = package(side).admission.AdmissionQueue(make_config(side))
    queue.submit(_request(side))
    assert len(queue.close()) == 1
    assert _shed(side, queue, _request(side))[:2] == (503, "draining")
    assert queue.pop(timeout=0) is None


@pytest.mark.parametrize("side", sorted(SIDES))
def test_breaker_opens_after_threshold_and_recovers(side):
    breaker = package(side).admission.CircuitBreaker(threshold=3,
                                                     cooldown_s=0.2)
    for _ in range(2):
        breaker.record_failure()
    assert breaker.state == "closed" and breaker.allow()
    breaker.record_failure()
    assert breaker.state == "open" and not breaker.allow()
    assert breaker.retry_after_s() >= 1
    time.sleep(0.25)
    assert breaker.state == "half-open"
    assert breaker.allow()
    assert not breaker.allow()
    breaker.record_success()
    assert breaker.state == "closed" and breaker.failures == 0


@pytest.mark.parametrize("side", sorted(SIDES))
def test_failed_half_open_probe_reopens(side):
    breaker = package(side).admission.CircuitBreaker(threshold=1,
                                                     cooldown_s=0.2)
    breaker.record_failure()
    assert breaker.state == "open"
    time.sleep(0.25)
    assert breaker.allow()
    breaker.record_failure()
    assert breaker.state == "open" and not breaker.allow()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_queue_breaker_sheds_per_source(side):
    queue = package(side).admission.AdmissionQueue(make_config(
        side, breaker_threshold=2, breaker_cooldown_s=60.0))
    for _ in range(2):
        queue.record_outcome("toxic", ok=False)
    status, code, retry = _shed(side, queue, _request(side, source="toxic"))
    assert (status, code) == (503, "breaker_open") and retry >= 1
    assert _shed(side, queue, _request(side, source="innocent")) is None
    assert queue.breaker_states() == {"toxic": "open"}


# ---------------------------------------------------------------------------
# the serving fabric's admission-edge cases (tests/test_fabric.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", sorted(SIDES))
def test_fair_share_pop_interleaves_tenants(side):
    queue = package(side).admission.AdmissionQueue(make_config(side))
    for source in ("A", "A", "A", "B"):
        queue.submit(_request(side, source=source))
    order = [queue.pop(timeout=0).request.source for _ in range(4)]
    assert order == ["A", "B", "A", "A"]
    tickets = [queue.submit(_request(side, source="solo")) for _ in range(3)]
    assert [queue.pop(timeout=0) for _ in range(3)] == tickets


@pytest.mark.parametrize("side", sorted(SIDES))
def test_tenant_quota_sheds_429(side):
    queue = package(side).admission.AdmissionQueue(make_config(
        side, tenant_quota_s=1.0))
    queue.note_usage("greedy", 5.0)
    assert _shed(side, queue, _request(side, source="greedy")) == (
        429, "tenant_quota", 60)
    assert _shed(side, queue, _request(side, source="modest")) is None
    assert queue.tenant_usage()["greedy"] == pytest.approx(5.0)


def test_serve_config_fabric_validation(tmp_path, monkeypatch):
    monkeypatch.delenv("MYTHRIL_TPU_FLEET_SECRET_FILE", raising=False)
    monkeypatch.delenv("MYTHRIL_TPU_FLEET_LISTEN", raising=False)
    empty = tmp_path / "empty"
    empty.write_bytes(b"")
    good = tmp_path / "secret"
    good.write_bytes(b"s3cret\n")
    for side in SIDES:
        cfg = package(side).config
        for kwargs in ({"fleet_listen": "203.0.113.7:4900"},
                       {"fleet_listen": "not-a-spec"},
                       {"fleet_listen": "127.0.0.1:0",
                        "secret_file": str(empty)}):
            with pytest.raises(cfg.ServeConfigError):
                cfg.ServeConfig.from_env(**kwargs)
        config = cfg.ServeConfig.from_env(fleet_listen="203.0.113.7:4900",
                                          secret_file=str(good))
        assert config.fleet_listen == "203.0.113.7:4900"


@pytest.mark.parametrize("value,rejected", [
    ("30", False), ("0", False), ("-1", True), ("lots", True)])
def test_tenant_quota_knob_is_validated_as_jax(monkeypatch, value,
                                               rejected):
    for side in SIDES:
        env = package(side).env
        monkeypatch.setenv("MYTHRIL_TPU_SERVE_TENANT_QUOTA", value)
        if rejected:
            with pytest.raises(env.EnvSpecError):
                env.validate_env()
        else:
            env.validate_env()


def test_bad_tenant_quota_exits_2_from_the_cli():
    env = dict(os.environ, MYTHRIL_TPU_SERVE_TENANT_QUOTA="lots")
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "serve", "--port", "0",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 2
    assert "MYTHRIL_TPU_SERVE_TENANT_QUOTA" in run.stderr


@pytest.mark.parametrize("side", sorted(SIDES))
def test_serve_kill_switch_disables_fabric(side, tmp_path, monkeypatch):
    secret = tmp_path / "secret"
    secret.write_bytes(b"s3cret\n")
    config = make_config(side, host="127.0.0.1", port=0,
                         fleet_listen="127.0.0.1:0",
                         fleet_secret_file=str(secret))
    http = package(side).http
    monkeypatch.setenv("MYTHRIL_TPU_FLEET", "0")
    server = http.AnalysisServer(config)
    try:
        assert server.router is None and server.engine.router is None
    finally:
        server._httpd.server_close()
    monkeypatch.delenv("MYTHRIL_TPU_FLEET")
    server = http.AnalysisServer(config)
    try:
        assert server.router is not None
        assert server.engine.router is server.router
        server.router.start()
        assert server.router.seat_count() == 0
    finally:
        server.router.shutdown()
        server._httpd.server_close()


def _staged_job(side):
    """A router of ``side`` (its loop not started) with one request
    staged as a lease: (router, job)."""
    pkg = package(side)
    router = pkg.fabric.FleetRouter(make_config(
        side, fleet_listen="127.0.0.1:0"))
    request = pkg.protocol.AnalyzeRequest(code="6080", name="t",
                                          tx_count=1, max_depth=64)
    job = pkg.fabric._FabricJob(pkg.admission.Ticket(request), request,
                                "rid1", "trace1", 30.0)
    router._stage(job)
    return router, job


def _drop_router(router):
    import shutil

    router.coordinator.shutdown()
    shutil.rmtree(router._base_dir, ignore_errors=True)


def test_router_stages_the_request_as_the_leases_payload():
    """One request, one lease whose per-lease payload carries the
    bytecode and knobs: the JAX package's fields, the port's args
    snapshot with the server's device."""
    payloads = {}
    for side in SIDES:
        router, job = _staged_job(side)
        try:
            payload = dict(job.lease.payload)
            payloads[side] = (payload.pop("args"), payload)
        finally:
            _drop_router(router)
    assert payloads["port"][1] == payloads["jax"][1]
    assert payloads["port"][1]["code"] == "6080"
    assert payloads["port"][1]["execution_timeout"] == 30
    assert "device" in payloads["port"][0]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_router_revokes_an_abandoned_request(side):
    """A client hangup cancels the request's lease: settled, marked
    cancelled, its job released, on both packages."""
    router, job = _staged_job(side)
    try:
        lease = job.lease
        router._cancel(job)
        assert job.cancelled
        assert lease.state == package(side).coordinator.DONE
        assert lease.result["cancelled"]
        router._settle()
        assert job.done.is_set() and not router._jobs
    finally:
        _drop_router(router)


# ---------------------------------------------------------------------------
# deadline budgets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", sorted(SIDES))
def test_budget_expiry_flows_into_drain_requested(side):
    pkg = package(side)
    stats = pkg.telemetry.resilience_stats
    pkg.budget.reset_for_tests()
    base = stats.deadline_expiries
    assert not pkg.checkpoint.drain_requested()
    pkg.budget.install_budget(60.0)
    assert not pkg.checkpoint.drain_requested()
    pkg.budget.install_budget(0.0)
    time.sleep(0.01)
    assert pkg.checkpoint.drain_requested()
    assert pkg.checkpoint.drain_requested()
    assert stats.deadline_expiries == base + 1
    pkg.budget.clear_budget()
    assert not pkg.checkpoint.drain_requested()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_expired_budget_does_not_trip_second_signal_path(side):
    pkg = package(side)
    pkg.budget.install_budget(0.0)
    time.sleep(0.01)
    try:
        assert pkg.checkpoint.drain_requested()
        assert not pkg.checkpoint._drain_event.is_set()
    finally:
        pkg.budget.clear_budget()


def _armed_kill(side):
    """The JAX file's two-stage kill switch (tx 1 arms storage[0], tx 2's
    SUICIDE sits behind it), as (runtime, creation) code."""
    support = importlib.import_module(f"{SIDES[side]}.support.assembler")
    signatures = importlib.import_module(f"{SIDES[side]}.support.signatures")
    arm_sel = signatures.selector_of("arm()")
    kill_sel = signatures.selector_of("kill()")
    runtime = support.asm(f"""
        PUSH 0; CALLDATALOAD; PUSH 0xe0; SHR
        DUP1; PUSH4 {arm_sel}; EQ; PUSH @arm; JUMPI
        DUP1; PUSH4 {kill_sel}; EQ; PUSH @kill; JUMPI
        PUSH 0; PUSH 0; REVERT
      arm:
        JUMPDEST; PUSH 1; PUSH 0; SSTORE; STOP
      kill:
        JUMPDEST; PUSH 0; SLOAD; PUSH @doit; JUMPI
        PUSH 0; PUSH 0; REVERT
      doit:
        JUMPDEST; CALLER; SUICIDE
    """)
    rt_len = len(runtime) // 2
    creation = (f"61{rt_len:04x}61000f600039"
                f"61{rt_len:04x}6000f3{runtime}")
    return runtime, creation


def _drained_run(side, monkeypatch, tx_count, poison_after_first_tx=False):
    """The JAX file's deadline-drain analysis on ``side``: (SWC set,
    aborted_at_tx, partial)."""
    name = SIDES[side]
    mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
    pkg = package(side)
    tx_mod = mod("laser.ethereum.transaction")
    runtime, creation = _armed_kill(side)
    pkg.solver.reset_blast_context()
    mod("support.model").clear_model_cache()
    for module in mod("analysis.module.loader").ModuleLoader() \
            .get_detection_modules():
        module.reset_module()
        module.cache.clear()
    plane = pkg.checkpoint.get_checkpoint_plane()
    plane.partial = False
    real = tx_mod.execute_message_call
    calls = []

    def instrumented(laser, address):
        result = real(laser, address)
        calls.append(address)
        if poison_after_first_tx and len(calls) == 1:
            pkg.budget.install_budget(0.0)
        return result

    monkeypatch.setattr(tx_mod, "execute_message_call", instrumented)
    mod("laser.ethereum.time_handler").time_handler.start_execution(120)
    try:
        sym = mod("analysis.symbolic").SymExecWrapper(
            mod("solidity.evmcontract").EVMContract(
                code=runtime, creation_code=creation, name="armed_kill"),
            address=0x901D12EBE1B195E5AA8748E62BD7734AE19B51F,
            strategy="bfs", max_depth=128, execution_timeout=120,
            create_timeout=10, transaction_count=tx_count,
        )
        issues = mod("analysis.security").fire_lasers(sym)
    finally:
        monkeypatch.setattr(tx_mod, "execute_message_call", real)
        pkg.budget.clear_budget()
    return ({i.swc_id for i in issues}, sym.laser.aborted_at_tx,
            bool(plane.partial))


def test_deadline_drains_at_transaction_start_boundary(monkeypatch):
    """A budget that expires when transaction 0 completes drains at
    transaction 1's start boundary, the report is partial, and its
    findings are the tx_count=1 run's; a full run afterwards is
    untouched.  Equal on both packages."""
    monkeypatch.setattr(importlib.import_module(
        "mythril_tpu_torch.support.support_args").args, "device", "cpu")
    results = {}
    for side in SIDES:
        clean_process_state(side)
        prefix, _, _ = _drained_run(side, monkeypatch, 1)
        full, _, _ = _drained_run(side, monkeypatch, 2)
        drained, aborted_at, partial = _drained_run(
            side, monkeypatch, 2, poison_after_first_tx=True)
        again, _, _ = _drained_run(side, monkeypatch, 2)
        results[side] = (prefix, full, drained, aborted_at, partial, again)
        assert "106" in full and full - prefix
        assert (drained, aborted_at, partial) == (prefix, 1, True)
        assert again == full
        clean_process_state(side)
    assert results["port"] == results["jax"]


# ---------------------------------------------------------------------------
# the coalescer's request scopes and the report cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", sorted(SIDES))
def test_coalescer_scope_stamp_and_purge(side):
    coalesce = package(side).coalesce
    clean_process_state(side)
    coalesce.set_serve_mode(True)
    try:
        co = coalesce.get_coalescer()
        coalesce.set_request_scope("req-a")
        co.queue[(1,)] = coalesce.QueuedLane((1,), [1], None, None, "req-a")
        coalesce.set_request_scope("req-b")
        co.queue[(2,)] = coalesce.QueuedLane((2,), [2], None, None, "req-b")
        assert coalesce.purge_scope("req-a") == 1
        assert list(co.queue) == [(2,)]
        co.dispatched = 3
        coalesce.reset_coalescer()
        assert list(co.queue) == [(2,)] and co.dispatched == 3
        assert coalesce._window() == coalesce.SERVE_WINDOW == 4
        coalesce.reset_coalescer(hard=True)
        assert not co.queue and co.dispatched == 0
    finally:
        clean_process_state(side)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_coalescer_cli_mode_reset_still_drops_everything(side):
    coalesce = package(side).coalesce
    clean_process_state(side)
    co = coalesce.get_coalescer()
    co.queue[(9,)] = coalesce.QueuedLane((9,), [9], None, None)
    co.dispatched = 2
    coalesce.reset_coalescer()
    assert not co.queue and co.dispatched == 0
    assert coalesce._window() == coalesce.COALESCE_WINDOW


@pytest.mark.parametrize("side", sorted(SIDES))
def test_report_cache_hit_mints_trace_and_counts(side, tmp_path,
                                                 monkeypatch):
    pkg = package(side)
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_FLUSH_S", "0")
    pkg.plane.reset_for_tests()
    pkg.metrics.reset_for_tests()
    try:
        plane = pkg.plane.get_knowledge_plane()
        code = "6001600101"
        plane.report_cache_put(pkg.plane.code_digest(code), 2, 128, None,
                               {"findings_swc": ["106"], "partial": False})
        queue = pkg.admission.AdmissionQueue(make_config(side))
        request = pkg.protocol.AnalyzeRequest
        hit = queue.cached_response(request(code=code))
        assert hit["cached"] is True and hit["findings_swc"] == ["106"]
        assert hit["trace_id"]
        echoed = queue.cached_response(request(code=code, trace_id="tr-e"))
        assert echoed["trace_id"] == "tr-e"
        assert queue._m_cache_hits.value == 2
        assert queue.cached_response(request(code="6002600201")) is None
        assert queue._m_cache_hits.value == 2
    finally:
        pkg.plane.reset_for_tests()
        pkg.metrics.reset_for_tests()


# ---------------------------------------------------------------------------
# the port's divergence: a lost card ends the server
# ---------------------------------------------------------------------------


def test_device_lost_answers_503_unreadies_and_exits_1(monkeypatch):
    """A ``DeviceLost`` raised inside a request (through a monkeypatched
    dispatch): the request gets 503 ``device_lost``, ``/readyz`` answers
    503, the queue drains and ``run_server`` returns 1.  (The JAX
    package demotes to its host CDCL instead:
    ``test_jax_demotion_degrades_but_serves`` below.)"""
    pkg = package("port")
    svm = importlib.import_module("mythril_tpu_torch.laser.ethereum.svm")
    DeviceLost = importlib.import_module(
        "mythril_tpu_torch.ops.device_health").DeviceLost

    def lost(states):
        raise DeviceLost("the card stopped answering (test)")

    monkeypatch.setattr(svm, "prune_infeasible", lost)
    for name, value in SERVE_ENV.items():
        monkeypatch.setenv(name, value)
    made, release = [], threading.Event()

    class Recorded(pkg.http.AnalysisServer):
        def __init__(self, config):
            super().__init__(config)
            made.append(self)

        def drain_and_stop(self, reason="shutdown"):
            release.wait(120)  # until the test has read /readyz
            super().drain_and_stop(reason)

    monkeypatch.setattr(pkg.http, "AnalysisServer", Recorded)
    clean_process_state("port")
    code = []
    runner = threading.Thread(target=lambda: code.append(
        pkg.http.run_server("127.0.0.1", 0, device="cpu")))
    runner.start()
    try:
        deadline = time.monotonic() + 60
        while not (made and made[0].engine._prepared.is_set()):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        srv = made[0]
        while _get(srv.port, "/readyz")[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        status, body, _ = _post(srv.port, _kb("lost"))
        assert status == 503, body
        assert body["error"]["code"] == "device_lost"
        assert "Traceback" not in json.dumps(body)
        srv.engine.join(60)
        status, raw = _get(srv.port, "/readyz")
        ready = json.loads(raw)
        assert status == 503
        assert ready["ready"] is False and ready["engine_alive"] is False
        assert ready["degraded"] is True and ready["mode"] == "cpu"
    finally:
        release.set()
        runner.join(120)
    assert code == [1]
    assert not pkg.coalesce.serve_mode()
    clean_process_state("port")


def test_a_server_without_a_card_is_refused_before_it_binds():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    port = _free_port()
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "serve", "--port",
         str(port)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 2
    assert "CUDA" in run.stderr and "--device cpu" in run.stderr


# ---------------------------------------------------------------------------
# serve as a process: readiness, a request, top, SIGTERM drain
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _serve_argv(side):
    return ([sys.executable, "myth", "serve"] if side == "jax" else
            [sys.executable, "-m", "mythril_tpu_torch", "serve",
             "--device", "cpu"])


def _serve_env(side):
    environ = dict(os.environ, **SERVE_ENV)
    if side == "jax":
        environ.update(JAX_PLATFORMS="cpu", XLA_FLAGS="")
    return environ


def _wait_ready(port, proc, timeout_s=180):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, "the server exited"
        try:
            if _get(port, "/readyz")[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError("the server did not become ready")


@pytest.mark.parametrize("side", sorted(SIDES))
def test_serve_process_answers_renders_top_and_drains(side, tmp_path):
    port = _free_port()
    trace, metrics = tmp_path / "t.json", tmp_path / "m.prom"
    log = open(tmp_path / "serve.err", "w")
    proc = subprocess.Popen(
        _serve_argv(side) + ["--port", str(port), "--trace-out", str(trace),
                             "--metrics-out", str(metrics)],
        cwd=ROOT, env=_serve_env(side), stdout=subprocess.DEVNULL,
        stderr=log)
    try:
        _wait_ready(port, proc)
        ready = json.loads(_get(port, "/readyz")[1])
        assert ready["mode"] == ("cpu" if side == "port" else "device")
        status, body, _ = _post(port, _kb("proc"))
        assert status == 200 and "106" in body["findings_swc"], body
        top = subprocess.run(
            [sys.executable, "-m", "mythril_tpu_torch", "top", "--once",
             "--url", f"http://127.0.0.1:{port}"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert top.returncode == 0, top.stderr
        assert "server: READY" in top.stdout and "Traceback" not in (
            top.stdout + top.stderr)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert json.loads(trace.read_text())["traceEvents"]
    assert "mythril_tpu_serve_requests_total" in metrics.read_text()


def test_epic_version_goes_through_the_pager():
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "--epic", "version"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "version" in run.stdout


def test_epic_pager_colours_a_terminal_only():
    epic = importlib.import_module("mythril_tpu_torch.interfaces.epic")
    jax_epic = importlib.import_module("mythril_tpu.interfaces.epic")
    text = "line one\n  two"
    assert epic.colorize(text) == jax_epic.colorize(text)
    assert "\x1b[38;5;" in epic.colorize(text)


# ---------------------------------------------------------------------------
# a remote seat behind the router, on each package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", sorted(SIDES))
def test_router_answers_through_a_remote_seat(side, tmp_path, monkeypatch):
    """A server listening for seats on loopback with a secret file, one
    ``worker --connect`` process of the same package: the request is
    answered by the seat (``mode: fabric``) with SWC-106, the findings of
    a server without a fabric; the seat, told not to redial, ends with
    exit 0 when the drain closes the fabric."""
    for name, value in SERVE_ENV.items():
        monkeypatch.setenv(name, value)
    secret = tmp_path / "secret"
    secret.write_text(secrets.token_hex(16) + "\n")
    listen = f"127.0.0.1:{_free_port()}"
    clean_process_state(side)
    srv = package(side).http.AnalysisServer(make_config(
        side, port=0, fleet_listen=listen, fleet_secret_file=str(secret)))
    srv.start()
    argv = ([sys.executable, "myth", "worker"] if side == "jax" else
            [sys.executable, "-m", "mythril_tpu_torch", "worker"])
    log = open(tmp_path / "worker.err", "w")
    worker = subprocess.Popen(
        argv + ["--connect", listen, "--secret-file", str(secret), "--id",
                "seat-1", "--reconnect", "0"],
        cwd=ROOT, env=_serve_env(side), stdout=subprocess.DEVNULL,
        stderr=log)
    try:
        deadline = time.monotonic() + 180
        while srv.router.seat_count() < 1:
            assert worker.poll() is None, (tmp_path / "worker.err").read_text()
            assert time.monotonic() < deadline, "the seat never attached"
            time.sleep(0.1)
        status, body, _ = _post(srv.port, _kb("fabric"))
        assert status == 200, body
        assert body["mode"] == "fabric" and body["worker"] == "seat-1"
        assert body["findings_swc"] == ["106"] and body["partial"] is False
        assert srv.router.routed == 1 and srv.router.fallbacks == 0
        fleet = json.loads(_get(srv.port, "/debug/fleet")[1])
        assert fleet["fabric"]["seats"] == 1
    finally:
        srv.drain_and_stop("test done")
        try:
            worker.wait(timeout=60)
        finally:
            if worker.poll() is None:
                worker.kill()
                worker.wait()
            log.close()
        clean_process_state(side)
    assert worker.returncode == 0, (tmp_path / "worker.err").read_text()


# ---------------------------------------------------------------------------
# the shared servers: the JAX file's end-to-end cases on both packages
# ---------------------------------------------------------------------------


def test_server_smoke_cold_then_warm(servers):
    first = both(servers, _kb("smoke"))
    for side in SIDES:
        status, body, _ = first[side]
        assert status == 200 and "106" in body["findings_swc"], body
        assert body["partial"] is False
    assert first["port"][1]["mode"] == "cpu"
    second = both(servers, _kb("smoke"))
    assert second["port"][1]["findings_swc"] == \
        first["port"][1]["findings_swc"]


def test_health_ready_metrics_surfaces(servers):
    for side, srv in servers.items():
        status, raw = _get(srv.port, "/healthz")
        health = json.loads(raw)
        assert status == 200 and health["ok"] is True
        assert health["rss_mb"] > 0
        status, raw = _get(srv.port, "/readyz")
        ready = json.loads(raw)
        assert status == 200 and ready["ready"] is True
        assert set(ready["queue_depths"]) == {"interactive", "batch"}
        status, raw = _get(srv.port, "/metrics")
        text = raw.decode()
        assert status == 200
        for name in ("mythril_tpu_serve_requests_total",
                     "mythril_tpu_serve_queue_depth_interactive",
                     "mythril_tpu_resilience_watchdog_trips"):
            assert name in text, (side, name)
        assert _get(srv.port, "/nope")[0] == 404
    bodies = {side: json.loads(_get(srv.port, "/readyz")[1])
              for side, srv in servers.items()}
    assert sorted(bodies["port"]) == sorted(bodies["jax"])
    for path in ("/debug/requests", "/debug/lanes", "/debug/autopilot",
                 "/debug/fleet", "/debug/watch"):
        got = {side: _get(srv.port, path) for side, srv in servers.items()}
        assert got["port"][0] == got["jax"][0] == 200, path
        assert sorted(json.loads(got["port"][1])) == \
            sorted(json.loads(got["jax"][1])), path


@pytest.mark.parametrize("payload,code", MALFORMED)
def test_malformed_bodies_are_structured_4xx(servers, payload, code):
    out = both(servers, payload)
    for side in SIDES:
        status, body, _ = out[side]
        assert 400 <= status < 500, body
        assert body["error"]["code"] == code
        assert "Traceback" not in json.dumps(body)


@pytest.mark.parametrize("data,length,status,code", [
    (b"{this is not json", None, 400, "bad_json"),
    # the length alone is over the cap: the server answers from the
    # header, before any of the body arrives
    (b"", (1 << 20) + 1, 413, "body_too_large"),
], ids=["bad_json", "body_too_large"])
def test_broken_and_oversized_bodies(servers, data, length, status, code):
    import http.client

    for side, srv in servers.items():
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        try:
            conn.putrequest("POST", "/analyze")
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length",
                           str(len(data) if length is None else length))
            conn.endheaders(data)
            rsp = conn.getresponse()
            assert rsp.status == status, side
            assert json.loads(rsp.read())["error"]["code"] == code, side
        finally:
            conn.close()


def test_deadline_over_http_partial_then_unaffected(servers):
    tree = bench.chaos_tree_contract()
    out = both(servers, {"code": tree, "name": "tree", "tx_count": 2,
                         "deadline_s": 0.05, "source": "deadline"})
    after = both(servers, {"code": tree, "name": "tree", "tx_count": 1,
                           "deadline_s": 300, "source": "deadline"})
    for side in SIDES:
        status, body, _ = out[side]
        assert status == 200, body
        assert body["partial"] is True
        assert body["meta"]["resilience"]["partial"] is True
        assert body["meta"]["resilience"]["deadline_expiries"] >= 1
        status, whole, _ = after[side]
        assert status == 200 and whole["partial"] is False
        assert "106" in whole["findings_swc"]
        assert set(body["findings_swc"]) <= set(whole["findings_swc"])


def test_poisoned_request_fails_alone_with_parity(servers):
    reference = both(servers, _kb("clean"))
    for side in SIDES:
        package(side).faults.get_fault_plane().arm("serve_crash", times=1)
    try:
        poisoned = both(servers, _kb("poison-iso"))
    finally:
        for side in SIDES:
            package(side).faults.reset_for_tests()
    after = both(servers, _kb("clean"))
    for side, srv in servers.items():
        status, body, _ = poisoned[side]
        assert status == 500 and body["error"]["code"] == "analysis_failed"
        assert "Traceback" not in json.dumps(body)
        status, raw = _get(srv.port, "/readyz")
        assert status == 200 and json.loads(raw)["ready"] is True
        assert after[side][1]["findings_swc"] == \
            reference[side][1]["findings_swc"]


def test_repeated_poison_trips_breaker_then_recovers(servers):
    payload = _kb("toxic-http")
    for side in SIDES:
        package(side).faults.get_fault_plane().arm("serve_crash", times=2)
    try:
        for _ in range(2):
            for side, (status, body, _) in both(servers, payload).items():
                assert status == 500, body
        for side, (status, body, headers) in both(servers, payload).items():
            assert status == 503 and body["error"]["code"] == "breaker_open"
            assert int(headers["Retry-After"]) >= 1
    finally:
        for side in SIDES:
            package(side).faults.reset_for_tests()
    time.sleep(0.6)
    for side, (status, body, _) in both(servers, payload).items():
        assert status == 200, body
    for srv in servers.values():
        status, raw = _get(srv.port, "/readyz")
        assert json.loads(raw)["breakers"].get("toxic-http") == "closed"


def test_jax_demotion_degrades_but_serves(servers):
    """The JAX half of the divergence, on the shared JAX server: a
    demoted device degrades, stays ready and serves from its host
    CDCL."""
    device_health = importlib.import_module("mythril_tpu.ops.device_health")
    srv = servers["jax"]
    try:
        device_health.mark_unhealthy("test demotion")
        status, raw = _get(srv.port, "/readyz")
        ready = json.loads(raw)
        assert status == 200 and ready["ready"] is True
        assert ready["degraded"] is True and ready["mode"] == "host-cdcl"
        status, body, _ = _post(srv.port, _kb("degraded"))
        assert status == 200 and "106" in body["findings_swc"]
        assert body["mode"] == "host-cdcl"
    finally:
        device_health.reset_for_tests()


def test_requests_and_lanes_are_scoped_and_top_renders(servers):
    """``/debug/requests`` lists the request under its trace id, its
    lanes are attributed to its scope in ``/debug/lanes``, and the
    port's ``top`` renders both servers, as does the JAX package's."""
    jax_top = importlib.import_module("mythril_tpu.interfaces.top")
    for side, srv in servers.items():
        status, body, _ = _post(srv.port, _kb("scoped", trace_id="tr-" + side))
        assert status == 200 and body["trace_id"] == "tr-" + side
        recent = json.loads(_get(srv.port, "/debug/requests")[1])["recent"]
        assert recent[0]["trace_id"] == "tr-" + side
        lanes = json.loads(_get(srv.port, "/debug/lanes")[1])
        assert body["request_id"] in lanes["by_scope"]
        for top in (package("port").top, jax_top):
            out = io.StringIO()
            assert top.render_once(f"http://127.0.0.1:{srv.port}", out=out)
            assert "server: READY" in out.getvalue()


def test_report_cache_hit_over_http(servers, tmp_path, monkeypatch):
    """With a persist directory, a re-submission is answered from the
    report cache at the admission edge with the first body's
    findings.  Each package's store in a directory of its own (a store
    has one writer)."""
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_FLUSH_S", "0")
    for side in SIDES:
        monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path / side))
        package(side).plane.reset_for_tests()
        assert not package(side).plane.get_knowledge_plane().store.read_only
    try:
        first = both(servers, _kb("cache"))
        again = both(servers, _kb("cache"))
        for side in SIDES:
            assert first[side][1].get("cached") is None
            assert again[side][1]["cached"] is True
            assert again[side][1]["findings_swc"] == \
                first[side][1]["findings_swc"] == ["106"]
            assert again[side][1]["issues"] == first[side][1]["issues"]
    finally:
        for side in SIDES:
            package(side).plane.reset_for_tests()


def test_steady_state_after_the_shared_cases(servers):
    """The coalescer is in serve mode while the shared servers run, its
    window the serve window; no request is in flight."""
    for side, srv in servers.items():
        coalesce = package(side).coalesce
        assert coalesce.serve_mode()
        assert srv.engine.in_flight is None
        assert re.fullmatch(r"[0-9a-f]{12}",
                            srv.engine.recent_requests[0]["request_id"])
