"""The port's ``myth watch`` (``mythril_tpu_torch/watch/``) against the
JAX package's, on the CPU.

The ten cases of ``tests/test_watch.py`` run on both packages (``side``)
over ``scripts/mock_chain.py``'s seeded chain: the reorg rewind, the
resume from the journal, a provider flap, clone and redeploy dedup with
the findings sink, the bounded backlog, pending rows, the knobs, the
confirmation lag, ``debug_status`` and exit 2 without a provider.  The
mock chain's in-process client speaks the JAX client's classes, so the
port's pool gets it through a thin adapter of the port's ``BaseClient``.
Where a case is deterministic its observations are compared between the
packages too.

End to end, each package's ``EngineBackend`` (the port's on
``device="cpu"``) follows the mock chain served over HTTP
(``make_server``) through a reorg: the ``watch_summary`` (walls aside),
the findings rows by digest and the journal are equal.  The chip check's
watch chain (``contracts.watch_chain``, served by
``contracts.serve_chain``) is followed with a recording backend, no
analysis: one reorg of two blocks, two unique digests, nothing dropped.
The port's divergence: a lost card ends its watch with exit 1, and
``--resume`` from the journal analyzes the block it was in.

After each case both packages' coalescer serve mode, request scope and
execution deadlines are put back (the JAX engine turns serve mode on and
leaves it on), and the port runs on one intra-op torch thread, as the
persist and serve files do.
"""

import argparse
import importlib
import json
import os
import sys
import threading

import pytest

from mythril_tpu_torch import contracts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from mock_chain import MockChain, MockChainClient, make_server  # noqa: E402

SIDES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}
both = pytest.mark.parametrize("side", sorted(SIDES))


def mod(side, path):
    return importlib.import_module(f"{SIDES[side]}.{path}")


def code_digest(code):
    return mod("port", "persist.plane").code_digest(code)


def clean_process_state(side):
    """Serve mode off, no request scope, a hard-reset coalescer, no
    request budget: what a watch's engine leaves behind, put back."""
    coalesce = mod(side, "ops.coalesce")
    coalesce.set_serve_mode(False)
    coalesce.set_request_scope(None)
    coalesce.reset_coalescer(hard=True)
    mod(side, "resilience.budget").reset_for_tests()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_state():
    handlers = [mod(side, "laser.ethereum.time_handler").time_handler
                for side in SIDES]
    deadlines = [h._deadline_ms for h in handlers]
    for side in SIDES:
        mod(side, "observability.metrics").reset_for_tests()
    yield
    for side in SIDES:
        mod(side, "observability.metrics").reset_for_tests()
        clean_process_state(side)
        assert not mod(side, "ops.coalesce").serve_mode()
    for handler, deadline in zip(handlers, deadlines):
        handler._deadline_ms = deadline


# ---------------------------------------------------------------------------
# fakes
# ---------------------------------------------------------------------------


def chain_client(side, chain, name):
    """The mock chain's in-process client for ``side``'s pool."""
    if side == "jax":
        return MockChainClient(chain, name)
    from mythril_tpu.ethereum.interface.rpc import client as jax_client
    from mythril_tpu_torch.ethereum.interface.rpc import client as port_client

    class PortMockChainClient(port_client.BaseClient):
        def __init__(self):
            self.inner = MockChainClient(chain, name)
            self.url = self.inner.url

        @property
        def calls(self):
            return self.inner.calls

        def fail_next(self, n):
            self.inner.fail_next(n)

        def _call(self, method, params=None):
            try:
                return self.inner._call(method, params)
            except jax_client.ConnectionError_ as exc:
                raise port_client.ConnectionError_(str(exc)) from None
            except jax_client.BadResponseError as exc:
                raise port_client.BadResponseError(str(exc)) from None

    return PortMockChainClient()


class _FakeBackend:
    """Records every analyze; sheds the first ``sheds`` calls."""

    def __init__(self, side, sheds: int = 0):
        self.backpressure = mod(side, "watch.stream").Backpressure
        self.sheds = sheds
        self.requests = []
        self.pushes = 0

    def analyze(self, request):
        if self.sheds > 0:
            self.sheds -= 1
            raise self.backpressure(0.0)
        self.requests.append(request)
        return {"request_id": f"r{len(self.requests)}", "name": request.name,
                "issues": [], "findings_swc": [], "analysis_s": 0.001,
                "trace_id": f"t{len(self.requests)}"}

    def analyzed_digests(self):
        return [code_digest(r.code) for r in self.requests]

    def push_status(self, snapshot):
        self.pushes += 1

    def close(self):
        pass


def _dep(side, i, code=None):
    code = code or ("0x60%02x60%02x0160005500" % (i % 256, i // 256))
    return mod(side, "watch.extract").Deployment(
        address="0x%040x" % i, tx_hash="0x%064x" % i, block=i, code=code,
        digest=code_digest(code))


def _service(side, chain, backend, **kwargs):
    pool = mod(side, "ethereum.interface.rpc.client").ProviderPool(
        [chain_client(side, chain, "a"), chain_client(side, chain, "b")])
    kwargs.setdefault("confirmations", 0)
    kwargs.setdefault("poll_s", 0)
    kwargs.setdefault("until_block", chain.blocks)
    return pool, mod(side, "watch.stream").WatchService(pool, backend,
                                                         **kwargs)


WALLS = ("wall_s", "cpm", "uptime_s")


def _summary(summary):
    return {k: v for k, v in summary.items() if k not in WALLS}


# ---------------------------------------------------------------------------
# the exactly-once spine (tests/test_watch.py)
# ---------------------------------------------------------------------------


def _reorg_case(side, tmp_path):
    chain = MockChain(seed=1, blocks=60, deployments=120,
                      reorg_at=30, reorg_depth=3, head_step=3)
    backend = _FakeBackend(side)
    _pool, service = _service(
        side, chain, backend, journal_path=str(tmp_path / "cursor.jsonl"),
        findings_out=str(tmp_path / "findings.jsonl"))
    summary = service.run()
    assert summary["reorgs"] == 1
    assert summary["cursor"] == 60
    assert summary["errors"] == 0
    digests = backend.analyzed_digests()
    assert len(digests) == len(set(digests))
    assert set(digests) == chain.expected_unique_digests()
    assert code_digest(chain.reorg_extra.code) in set(digests)
    assert summary["dedup_hits"] > 0
    assert summary["deployments"] == len(set(digests)) + summary[
        "dedup_hits"]
    journal = [json.loads(line) for line in open(tmp_path / "cursor.jsonl")]
    return _summary(summary), digests, journal


@both
def test_reorg_rewinds_and_never_double_submits(side, tmp_path):
    _reorg_case(side, tmp_path)


def test_reorg_summaries_digests_and_journals_agree(tmp_path):
    got = {side: _reorg_case(side, tmp_path / side) for side in SIDES}
    assert got["port"] == got["jax"]


@both
def test_resume_from_journal_loses_no_block(side, tmp_path):
    journal = str(tmp_path / "cursor.jsonl")
    chain = MockChain(seed=3, blocks=60, deployments=120,
                      reorg_at=30, reorg_depth=3, head_step=3)
    first = _FakeBackend(side)
    _pool, service = _service(side, chain, first, journal_path=journal,
                              until_block=20)
    service.run()
    assert 20 <= service.follower.cursor < 30
    with open(journal, "a", encoding="utf-8") as fh:
        fh.write("this-is-not-json\n")
    second = _FakeBackend(side)
    _pool, resumed = _service(side, chain, second, journal_path=journal,
                              resume=True)
    summary = resumed.run()
    assert resumed.follower.cursor == 60
    assert summary["reorgs"] == 1
    d1, d2 = set(first.analyzed_digests()), set(second.analyzed_digests())
    assert not d1 & d2
    assert d1 | d2 == chain.expected_unique_digests()


@both
def test_provider_flap_rotates_and_stays_exactly_once(side):
    chain = MockChain(seed=5, blocks=40, deployments=80, head_step=4)
    backend = _FakeBackend(side)
    pool, service = _service(side, chain, backend)
    pool.slots[0].client.fail_next(4)
    summary = service.run()
    assert set(backend.analyzed_digests()) == chain.expected_unique_digests()
    assert summary["errors"] == 0
    assert pool.slots[1].client.calls > 0


@both
def test_clone_and_dup_dedup_with_findings_sink(side, tmp_path):
    findings = str(tmp_path / "findings.jsonl")
    chain = MockChain(seed=7, blocks=30, deployments=60, head_step=5)
    backend = _FakeBackend(side)
    _pool, service = _service(side, chain, backend, findings_out=findings)
    summary = service.run()
    rows = [json.loads(line) for line in open(findings, encoding="utf-8")]
    analyzed = [r for r in rows if r["status"] == "analyzed"]
    duplicates = [r for r in rows if r["status"] == "duplicate"]
    assert summary["dedup_hits"] == len(duplicates) > 0
    assert {r["digest"] for r in analyzed} == chain.expected_unique_digests()
    assert any(r.get("proxy_target") for r in analyzed) or duplicates
    assert all(r["trace_id"] for r in analyzed)


# ---------------------------------------------------------------------------
# the backpressure backlog
# ---------------------------------------------------------------------------


def _registry(side):
    return mod(side, "observability.metrics").get_registry()


@both
def test_backlog_bounded_and_nothing_dropped(side, tmp_path):
    stream = mod(side, "watch.stream")
    follower = mod(side, "watch.follower")
    journal = follower.CursorJournal(str(tmp_path / "j.jsonl")).open()
    backend = _FakeBackend(side, sheds=9)
    metrics = stream.WatchMetrics(_registry(side))
    dispatcher = stream.StreamDispatcher(backend, metrics, set(), journal,
                                         backlog_cap=2)
    deployments = [_dep(side, i) for i in range(5)]
    for deployment in deployments:
        dispatcher.submit(deployment)
        assert len(dispatcher.backlog) <= 2
    dispatcher.drain(blocking=True)
    journal.close()
    assert not dispatcher.backlog
    assert set(backend.analyzed_digests()) == {d.digest for d in deployments}
    rows = list(follower.CursorJournal(journal.path).replay())
    pending = [r["pending"]["digest"] for r in rows if "pending" in r]
    done = [r["done"] for r in rows if "done" in r]
    assert pending and sorted(pending) == sorted(done)


@both
def test_pending_rows_restored_on_resume(side, tmp_path):
    stream = mod(side, "watch.stream")
    follower_mod = mod(side, "watch.follower")
    path = str(tmp_path / "j.jsonl")
    lost, finished = _dep(side, 1), _dep(side, 2)
    journal = follower_mod.CursorJournal(path).open()
    journal.append({"block": 5, "hash": "0xabc",
                    "digests": [lost.digest, finished.digest]})
    for deployment in (lost, finished):
        journal.append({"pending": {
            "digest": deployment.digest, "address": deployment.address,
            "block": deployment.block, "tx_hash": deployment.tx_hash,
            "code": deployment.code, "proxy_target": None}})
    journal.append({"done": finished.digest})
    journal.close()
    follower = follower_mod.ChainFollower(
        None, journal=follower_mod.CursorJournal(path), resume=True)
    assert follower.cursor == 5
    assert follower.seen_digests == {lost.digest, finished.digest}
    assert [row["digest"] for row in follower.pending_rows] == [lost.digest]
    backend = _FakeBackend(side)
    dispatcher = stream.StreamDispatcher(
        backend, stream.WatchMetrics(_registry(side)),
        follower.seen_digests, None)
    dispatcher.restore_pending(follower.pending_rows)
    dispatcher.drain(blocking=True)
    assert backend.analyzed_digests() == [lost.digest]


# ---------------------------------------------------------------------------
# knobs and the status surface
# ---------------------------------------------------------------------------


@both
def test_watch_env_knobs_are_registered(side, monkeypatch):
    env = mod(side, "support.env")
    monkeypatch.setenv("MYTHRIL_TPU_WATCH_CONFIRMATIONS", "abc")
    with pytest.raises(env.EnvSpecError):
        env.validate_env()
    monkeypatch.setenv("MYTHRIL_TPU_WATCH_CONFIRMATIONS", "2")
    monkeypatch.setenv("MYTHRIL_TPU_WATCH_POLL_S", "0.5")
    monkeypatch.setenv("MYTHRIL_TPU_WATCH_BACKLOG", "16")
    monkeypatch.setenv("MYTHRIL_TPU_WATCH_FROM_BLOCK", "0")
    env.validate_env()
    monkeypatch.setenv("MYTHRIL_TPU_WATCH_BACKLOG", "0")
    with pytest.raises(env.EnvSpecError):
        env.validate_env()


@both
def test_confirmation_lag_holds_cursor_back(side):
    chain = MockChain(seed=9, blocks=20, deployments=10, head_start=20,
                      head_step=1)
    backend = _FakeBackend(side)
    _pool, service = _service(side, chain, backend, confirmations=5,
                              until_block=None)
    service.follower.poll_head()
    while True:
        block = service.follower.next_block()
        if block is None:
            break
        service._process_block(block)
    assert service.follower.cursor == 20 - 5
    assert service.follower.lag_blocks() == 5


@both
def test_debug_status_inactive_without_watcher(side):
    assert mod(side, "watch").debug_status() == {"active": False}


@both
def test_run_watch_without_provider_exits_2(side, capsys, monkeypatch):
    monkeypatch.delenv("MYTHRIL_TPU_RPC_PROVIDERS", raising=False)
    assert mod(side, "watch").run_watch(argparse.Namespace(rpc=None)) == 2
    assert "no RPC provider" in capsys.readouterr().err


def test_status_while_running_is_the_jax_shape():
    """The ``/debug/watch`` body of a running watcher has the JAX keys."""
    keys = {}
    for side in SIDES:
        chain = MockChain(seed=11, blocks=6, deployments=4, head_step=6)
        seen = {}

        class Peek(_FakeBackend):
            def push_status(self, snapshot, _seen=seen, _side=side):
                _seen.setdefault("status", mod(_side, "watch")
                                 .debug_status())

        _pool, service = _service(side, chain, Peek(side))
        service.run()
        keys[side] = sorted(seen["status"])
        assert seen["status"]["active"]
        assert mod(side, "watch").debug_status() == {"active": False}
    assert keys["port"] == keys["jax"]


# ---------------------------------------------------------------------------
# end to end: the engines over a served chain
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_pins(monkeypatch):
    """The JAX engine on one CPU device with the dense tier forced, as the
    serve parity tests run it; both dispatch deadlines out of reach."""
    import jax

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.setenv("MYTHRIL_TPU_PALLAS", "force")
    for side in SIDES:
        monkeypatch.setattr(mod(side, "resilience.watchdog"),
                            "DEADLINE_FLOOR_S", 3600.0)
        clean_process_state(side)


def _serve(chain, server_factory):
    server = server_factory(chain)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"127.0.0.1:{server.server_address[1]}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(10)


def _engine_watch(side, tmp_path):
    """One side's ``WatchService`` with its ``EngineBackend`` over a
    served mock chain with a reorg: (summary, findings rows by digest,
    journal rows)."""
    chain = MockChain(seed=21, blocks=12, deployments=10, reorg_at=8,
                      reorg_depth=2, head_step=3)
    server, thread, endpoint = _serve(chain, make_server)
    try:
        stream = mod(side, "watch.stream")
        kwargs = {"device": "cpu"} if side == "port" else {}
        backend = stream.EngineBackend(**kwargs)
        service = stream.WatchService(
            mod(side, "watch").build_client(endpoint), backend,
            confirmations=0, poll_s=0, until_block=chain.blocks,
            journal_path=str(tmp_path / f"{side}.jsonl"),
            findings_out=str(tmp_path / f"{side}.findings.jsonl"),
            tx_count=1)
        summary = service.run()
    finally:
        _stop(server, thread)
    rows = {}
    for line in open(tmp_path / f"{side}.findings.jsonl"):
        row = json.loads(line)
        row.pop("trace_id", None)
        row.pop("analysis_s", None)
        rows.setdefault(row["digest"], []).append(row)
    journal = [json.loads(line) for line in open(tmp_path / f"{side}.jsonl")]
    assert set(rows) == chain.expected_unique_digests()
    return _summary(summary), rows, journal


def test_engine_backends_follow_a_reorg_alike(jax_pins, tmp_path):
    """Both packages' in-process engines (the port's on ``device="cpu"``)
    behind the watch over a served mock chain with a reorg of two
    blocks: equal summaries (walls aside), findings rows by digest and
    journals; every unique digest analyzed once, nothing dropped."""
    got = {side: _engine_watch(side, tmp_path) for side in ("jax", "port")}
    assert got["port"] == got["jax"]
    summary, rows, journal = got["port"]
    assert summary["reorgs"] == 1 and summary["errors"] == 0
    assert summary["analyzed"] == len(rows) and summary["backlog_depth"] == 0
    assert sum(1 for r in journal if "reorg" in r) == 1


def test_watch_chain_of_the_chip_check(tmp_path):
    """``contracts.watch_chain`` served on loopback and followed with a
    recording backend on both packages: one reorg of two blocks, the
    reverted CREATE skipped, six deployments, two unique digests (the
    scale contract and killbilly), four dedup hits, equal journals."""
    got = {}
    for side in SIDES:
        chain = contracts.watch_chain()
        server, thread, endpoint = _serve(chain, contracts.serve_chain)
        try:
            backend = _FakeBackend(side)
            service = mod(side, "watch.stream").WatchService(
                mod(side, "watch").build_client(endpoint), backend,
                confirmations=0, poll_s=0, until_block=8,
                journal_path=str(tmp_path / f"{side}.jsonl"))
            summary = service.run()
        finally:
            _stop(server, thread)
        journal = [json.loads(line)
                   for line in open(tmp_path / f"{side}.jsonl")]
        got[side] = (_summary(summary), backend.analyzed_digests(), journal)
    assert got["port"] == got["jax"]
    summary, digests, journal = got["port"]
    assert digests == [code_digest(contracts.scale_contract(6, 16, "mul")),
                       code_digest(contracts.killbilly())]
    assert (summary["reorgs"], summary["deployments"],
            summary["dedup_hits"], summary["cursor"]) == (1, 6, 4, 8)
    assert [r for r in journal if "reorg" in r] == [{"reorg": 5, "at": 7}]
    assert set(contracts.WATCH_FINDINGS) == {"scale_mul d6 g16",
                                             "killbilly"}


def test_lost_card_ends_the_port_watch_and_resume_loses_nothing(
        tmp_path, capsys, monkeypatch):
    """The port's divergence: the engine's device is lost on the second
    analysis; ``run_watch`` prints the error and returns 1, the journal
    ends at the block before, and ``--resume`` analyzes what was left,
    every unique digest once over the two runs (the JAX engine demotes
    to its host CDCL and goes on)."""
    from mythril_tpu_torch.ops.device_health import DeviceLost
    from mythril_tpu_torch.serve import engine as port_engine
    from mythril_tpu_torch.watch import run_watch

    chain = MockChain(seed=23, blocks=8, deployments=6, head_step=8)
    server, thread, endpoint = _serve(chain, make_server)
    journal = str(tmp_path / "cursor.jsonl")
    findings = str(tmp_path / "findings.jsonl")
    real_fire = port_engine.AnalysisEngine._fire
    fired = []

    def fire(self, request, rid, budget_s):
        fired.append(request.code)
        if len(fired) == 2:
            raise DeviceLost("the card stopped answering")
        return real_fire(self, request, rid, budget_s)

    monkeypatch.setattr(port_engine.AnalysisEngine, "_fire", fire)

    def args(**extra):
        return argparse.Namespace(
            rpc=endpoint, serve=None, device="cpu", confirmations=0,
            poll_s=0, from_block=None, until_block=chain.blocks,
            journal=journal, findings_out=findings, tx_count=1,
            deadline_s=None, max_depth=None, **extra)

    try:
        assert run_watch(args(resume=False)) == 1
        err = capsys.readouterr().err
        assert "device lost" in err and "DeviceLost" in err
        rows = [json.loads(line) for line in open(journal)]
        processed = [r["block"] for r in rows if "block" in r]
        lost_block = max(processed) + 1
        monkeypatch.setattr(port_engine.AnalysisEngine, "_fire", real_fire)
        assert run_watch(args(resume=True)) == 0
        summary = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])["watch_summary"]
    finally:
        _stop(server, thread)
    assert summary["cursor"] == chain.blocks and summary["errors"] == 0
    analyzed = [json.loads(line) for line in open(findings)]
    analyzed = [r for r in analyzed if r["status"] == "analyzed"]
    assert sorted(r["digest"] for r in analyzed) == sorted(
        chain.expected_unique_digests())
    assert any(r["block"] >= lost_block for r in analyzed)
