"""The port's checkpoint and resume plane, drain, and poisoned-lane
quarantine (``mythril_tpu_torch/resilience/checkpoint.py`` and the
ladder in ``ops/batched_sat.py``) against the JAX package's, on the CPU.

The port's counterparts of ``tests/test_checkpoint.py``: the journal's
format (atomic writes, retention, CRC and version rejection, the
fallback to an older generation), the plane's write policy (boundary,
cadence, the demotion nudge, the target check), the solver channels'
freeze and thaw, the drain (SIGTERM, the partial report) and the
bisection that isolates exactly the poisoned lane.  The drain-and-resume
case runs the chaos contract on both packages with the same drain point
and resumes both: findings equal to the uninterrupted run's, and equal
checkpoint and resume counters.  The port's journal holds no device
tensor (a tensor is written as host numpy).

The end-to-end harness and the resets of both packages' resilience
singletons are ``test_torch_resilience``'s (``chaos_env``).
"""

import importlib
import json
import os
import pickle
import signal as signal_module
import struct
import time

import numpy as np
import pytest
import torch

from mythril_tpu.resilience import checkpoint as jax_cp
from mythril_tpu.resilience.telemetry import resilience_stats as jax_stats
from mythril_tpu_torch.resilience import checkpoint as cp
from mythril_tpu_torch.resilience import faults as port_faults
from mythril_tpu_torch.resilience import watchdog as port_watchdog
from mythril_tpu_torch.resilience.telemetry import (
    resilience_stats as port_stats,
)
from mythril_tpu_torch.support.support_args import args as port_args
from test_torch_analyze import _run, jax_args
from test_torch_resilience import (  # noqa: F401 — the autouse fixture
    CHAOS, PACKAGES, baseline, chaos_env, frontier_check, resilience_row,
    swcs,
)

pytestmark = pytest.mark.faults


# ---------------------------------------------------------------------------
# the journal's format
# ---------------------------------------------------------------------------


def test_journal_round_trip_and_retention(tmp_path):
    d = str(tmp_path)
    for n in range(3):
        cp.write_journal(d, {"generation_payload": n})
    assert len(cp._generations(d)) == cp.JOURNAL_KEEP
    assert cp.load_journal(d) == {"generation_payload": 2}
    assert not os.path.exists(os.path.join(d, ".journal.tmp"))


def test_journal_header_is_the_jax_packages(tmp_path):
    """Same magic, version and header layout: a journal's framing reads
    the same in both packages."""
    path = cp.write_journal(str(tmp_path), {"n": 1})
    with open(path, "rb") as fh:
        raw = fh.read()
    assert raw[:len(jax_cp.JOURNAL_MAGIC)] == jax_cp.JOURNAL_MAGIC
    version, _crc, length = jax_cp._HEADER.unpack_from(
        raw, len(jax_cp.JOURNAL_MAGIC))
    assert version == jax_cp.JOURNAL_VERSION == cp.JOURNAL_VERSION
    assert length == len(raw) - len(cp.JOURNAL_MAGIC) - cp._HEADER.size


def test_corrupt_newest_falls_back_one_generation(tmp_path):
    d = str(tmp_path)
    cp.write_journal(d, {"n": 1})
    newest = cp.write_journal(d, {"n": 2})
    with open(newest, "r+b") as fh:
        fh.seek(-1, os.SEEK_END)
        fh.write(b"\xff")
    assert cp.load_journal(d) == {"n": 1}


def test_corrupt_fallback_is_counted_and_warned(tmp_path, caplog):
    import logging

    d = str(tmp_path)
    cp.write_journal(d, {"n": 1})
    newest = cp.write_journal(d, {"n": 2})
    with open(newest, "r+b") as fh:
        fh.seek(-1, os.SEEK_END)
        fh.write(b"\xff")
    before = port_stats.checkpoint_corrupt_fallbacks
    with caplog.at_level(logging.WARNING,
                         logger="mythril_tpu_torch.resilience.checkpoint"):
        assert cp.load_journal(d) == {"n": 1}
    assert port_stats.checkpoint_corrupt_fallbacks == before + 1
    messages = [r.getMessage() for r in caplog.records]
    assert any("corrupt journal" in m for m in messages), messages
    assert any("OLDER generation" in m for m in messages), messages


def test_every_generation_corrupt_raises_loudly(tmp_path):
    d = str(tmp_path)
    for n in range(2):
        cp.write_journal(d, {"n": n})
    for _, path in cp._generations(d):
        with open(path, "r+b") as fh:
            fh.seek(-1, os.SEEK_END)
            fh.write(b"\xff")
    with pytest.raises(cp.JournalCorrupt):
        cp.load_journal(d)


def test_stale_version_is_rejected(tmp_path):
    d = str(tmp_path)
    path = cp.write_journal(d, {"n": 0})
    with open(path, "r+b") as fh:
        fh.seek(len(cp.JOURNAL_MAGIC))
        fh.write(struct.pack("<I", cp.JOURNAL_VERSION + 1))
    with pytest.raises(cp.JournalCorrupt, match="version"):
        cp.load_journal(d)


def test_truncated_body_is_rejected(tmp_path):
    d = str(tmp_path)
    path = cp.write_journal(d, {"payload": list(range(100))})
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size - 7)
    with pytest.raises(cp.JournalCorrupt, match="truncated|CRC"):
        cp.load_journal(d)


def test_empty_directory_loads_none(tmp_path):
    assert cp.load_journal(str(tmp_path)) is None


def test_the_journal_holds_no_device_tensor(tmp_path):
    """A tensor reached from the payload is written as host numpy (no
    torch storage in the pickle stream) and comes back as a tensor of
    the same values on its device type."""
    tensor = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    blob = cp.dumps({"t": tensor})
    assert b"torch._utils" not in blob and b"_tensor_from_host" in blob
    cp.write_journal(str(tmp_path), {"t": tensor})
    back = cp.load_journal(str(tmp_path))["t"]
    assert isinstance(back, torch.Tensor) and back.device.type == "cpu"
    assert torch.equal(back, tensor)
    # the journal's table is private: pickling elsewhere is unaffected
    assert b"_rebuild_tensor" in pickle.dumps(tensor)


# ---------------------------------------------------------------------------
# the plane's write policy and the target check
# ---------------------------------------------------------------------------


class _FakeLaser:
    def __init__(self, transaction_count=1):
        self.open_states = []
        self.transaction_count = transaction_count


def test_plane_cadence_and_demotion_nudge(tmp_path, monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_CHECKPOINT_PERIOD", "9999")
    plane = cp.get_checkpoint_plane()
    plane.configure(str(tmp_path))
    plane.transaction_boundary(_FakeLaser(), 0xABC, 0)
    assert len(cp._generations(str(tmp_path))) == 1
    plane.tick()  # inside the cadence window: no write
    assert len(cp._generations(str(tmp_path))) == 1
    plane.note_demotion()  # a demotion forces the next tick to write
    plane.tick()
    assert len(cp._generations(str(tmp_path))) == 2
    assert port_stats.checkpoints_written == 2
    assert port_stats.checkpoint_s >= 0.0


def test_a_ladder_demotion_nudges_the_plane(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "0.2")
    plane = cp.get_checkpoint_plane()
    with pytest.raises(port_watchdog.DispatchAbandoned):
        port_watchdog.DispatchWatchdog().supervised(
            "k", lambda: time.sleep(1))
    assert plane._demotion_pending


def test_resume_rejects_mismatched_target(tmp_path):
    plane = cp.get_checkpoint_plane()
    plane.configure(str(tmp_path))
    plane.transaction_boundary(_FakeLaser(transaction_count=1), 0xABC, 0)
    cp.reset_for_tests()
    plane = cp.get_checkpoint_plane()
    plane.configure(str(tmp_path), resume=True)
    other = _FakeLaser(transaction_count=3)
    assert plane.restore_transactions(other, 0xDEF) == 0
    assert port_stats.resumes == 0


def test_checkpoint_period_env_parsing(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_CHECKPOINT_PERIOD", "0")
    assert cp.checkpoint_period_s() == 0.0
    monkeypatch.setenv("MYTHRIL_TPU_CHECKPOINT_PERIOD", "bogus")
    assert cp.checkpoint_period_s() == cp.DEFAULT_PERIOD_S
    monkeypatch.delenv("MYTHRIL_TPU_CHECKPOINT_PERIOD")
    assert cp.checkpoint_period_s() == cp.DEFAULT_PERIOD_S


# ---------------------------------------------------------------------------
# the solver channels' freeze and thaw
# ---------------------------------------------------------------------------


def test_channel_freeze_thaw_survives_pickling():
    from mythril_tpu_torch.smt import UGT, ULT, symbol_factory
    from mythril_tpu_torch.smt import terms as T
    from mythril_tpu_torch.smt.solver import (
        get_blast_context, reset_blast_context,
    )

    reset_blast_context()
    ctx = get_blast_context()
    x = symbol_factory.BitVecSym("ckch0", 16)
    lo = ULT(x, symbol_factory.BitVecVal(2, 16)).raw
    hi = UGT(x, symbol_factory.BitVecVal(9, 16)).raw
    ctx.unsat_memo[tuple(sorted((lo.id, hi.id)))] = True
    env = T.EvalEnv(variables={x.raw.id: 5}, arrays={}, ufs={},
                    array_default=0)
    ctx.probe_memo[(lo.id,)] = env
    ctx.recent_models = [env]
    blob = cp.dumps(cp.freeze_channels(ctx))
    # a fresh process: the interner forgets everything, the journal
    # unpickles first (nodes re-intern with fresh ids), and the
    # analysis's constraints then intern to those same nodes
    reset_blast_context()
    ctx2 = get_blast_context()
    cp.thaw_channels(ctx2, pickle.loads(blob))
    x2 = symbol_factory.BitVecSym("ckch0", 16)
    lo2 = ULT(x2, symbol_factory.BitVecVal(2, 16)).raw
    hi2 = UGT(x2, symbol_factory.BitVecVal(9, 16)).raw
    assert tuple(sorted((lo2.id, hi2.id))) in ctx2.unsat_memo
    assert (lo2.id,) in ctx2.probe_memo
    assert ctx2.probe_memo[(lo2.id,)].variables[x2.raw.id] == 5
    assert len(ctx2.recent_models) == 1
    reset_blast_context()


# ---------------------------------------------------------------------------
# the drain: signal -> flag -> partial report -> resumable journal
# ---------------------------------------------------------------------------


def test_sigterm_sets_the_drain_flag():
    cp.install_signal_handlers()
    assert not cp.drain_requested()
    os.kill(os.getpid(), signal_module.SIGTERM)
    deadline = time.monotonic() + 5.0
    while not cp.drain_requested():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    cp.restore_signal_handlers()
    assert signal_module.getsignal(signal_module.SIGTERM) is not None
    assert not cp._handlers_installed


def test_drained_report_flags_partial():
    from mythril_tpu_torch.analysis.report import Report

    cp.request_drain("test")
    payload = json.loads(Report().as_swc_standard_format())
    assert payload[0]["meta"]["resilience"]["partial"] is True
    cp.reset_for_tests()
    payload = json.loads(Report().as_swc_standard_format())
    assert "resilience" not in payload[0]["meta"]


def test_an_expired_budget_reads_as_a_drain():
    from mythril_tpu_torch.resilience import budget

    assert not cp.drain_requested()
    budget.install_budget(0.0, label="request")
    assert cp.drain_requested()
    assert port_stats.deadline_expiries == 1
    budget.clear_budget()
    assert not cp.drain_requested()


def test_drain_mid_analysis_then_resume_restores_findings(
        tmp_path, monkeypatch):
    """The drain and resume contract on both packages: a drain at the
    third scheduler round stops the analysis with a final journal at the
    interrupted transaction's start boundary and a partial report; the
    resumed run re-executes it to the uninterrupted findings.  The
    checkpoint and resume counters are equal on both sides."""
    base, _ = baseline()
    from mythril_tpu.analysis.report import Report as JaxReport
    from mythril_tpu_torch.analysis.report import Report

    monkeypatch.setenv("MYTHRIL_TPU_CHECKPOINT_PERIOD", "0")
    rows = {}
    for package, module, args, stats, report in (
            ("mythril_tpu", jax_cp, jax_args, jax_stats, JaxReport),
            ("mythril_tpu_torch", cp, port_args, port_stats, Report)):
        directory = str(tmp_path / package)
        monkeypatch.setattr(args, "checkpoint_dir", directory)
        monkeypatch.setattr(args, "resume_from", None)
        plane = module.get_checkpoint_plane()
        tick, ticks = plane.tick, []

        def tick_then_drain(tick=tick, ticks=ticks, module=module):
            tick()
            ticks.append(1)
            if len(ticks) == 3:  # mid-first-transaction
                module.request_drain("test")

        monkeypatch.setattr(plane, "tick", tick_then_drain)
        side = "jax" if package == "mythril_tpu" else "port"
        drained = _run(side, CHAOS, 1)
        assert module.drain_requested()
        assert plane.partial is True
        assert module.load_journal(directory)["tx_index"] == 0
        meta = json.loads(report().as_swc_standard_format())[0]["meta"]
        assert meta["resilience"]["partial"] is True
        drained_row = resilience_row(stats)
        module.reset_for_tests()  # a fresh plane, the drain flag cleared
        monkeypatch.setattr(args, "resume_from", directory)
        resumed = _run(side, CHAOS, 1)
        resumed_row = resilience_row(stats)
        rows[package] = (swcs(drained), swcs(resumed), drained_row,
                         resumed_row, len(module._generations(directory)))
        module.reset_for_tests()
    assert rows["mythril_tpu_torch"][1] == swcs(base)
    assert rows["mythril_tpu_torch"][3]["resumes"] == 1
    assert rows["mythril_tpu_torch"] == rows["mythril_tpu"]


def test_kill_at_spec_validated_at_startup(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_KILL_AT", "not_a_point")
    port_faults.reset_for_tests()
    with pytest.raises(port_faults.FaultSpecError):
        port_faults.get_fault_plane()
    monkeypatch.setenv("MYTHRIL_TPU_KILL_AT", "dispatch_error:x")
    port_faults.reset_for_tests()
    with pytest.raises(port_faults.FaultSpecError):
        port_faults.get_fault_plane()
    monkeypatch.setenv("MYTHRIL_TPU_KILL_AT", "dispatch_error:2")
    port_faults.reset_for_tests()
    plane = port_faults.get_fault_plane()
    assert (plane._kill_at, plane._kill_skip) == ("dispatch_error", 2)


# ---------------------------------------------------------------------------
# poisoned-lane bisection: one lane quarantined, the context kept
# ---------------------------------------------------------------------------


def _arm_both(point, **kwargs):
    for package in PACKAGES:
        importlib.import_module(
            f"{package}.resilience.faults").get_fault_plane().arm(
                point, **kwargs)


def test_bisection_quarantines_exactly_the_poisoned_lane():
    """A lane-dependent repeatable failure costs one lane (to the CDCL
    tail), not the context, on both sides alike: one quarantined lane,
    no demotion, no verdict flipped, and a later batch still dispatches;
    the ledger counts the quarantine."""
    from mythril_tpu_torch.observability.ledger import get_ledger

    out = {}
    for package in PACKAGES:
        clean, stats = frontier_check(package, "bq")
        assert stats.dispatches > 0
        stats_module = jax_stats if package == "mythril_tpu" else port_stats
        importlib.import_module(
            f"{package}.resilience.faults").get_fault_plane().arm(
                "lane_poison", times=99, lane=2)
        poisoned, stats = frontier_check(package, "bp")
        row = (stats_module.quarantined_lanes, stats_module.bisect_dispatches,
               stats_module.demotions, stats.fused)
        for i, verdict in enumerate(poisoned):
            if verdict is not None:
                assert verdict == clean[i]
        importlib.import_module(
            f"{package}.resilience.faults").reset_for_tests()
        _later, stats = frontier_check(package, "bz")
        out[package] = (poisoned, row, stats.dispatches)
    assert out["mythril_tpu_torch"] == out["mythril_tpu"]
    assert out["mythril_tpu_torch"][1][:1] == (1,)
    assert out["mythril_tpu_torch"][1][2:] == (0, False)
    assert out["mythril_tpu_torch"][2] > 0
    assert get_ledger().snapshot()["transitions"]["quarantined"] == 1


def test_lane_poison_requires_a_lane():
    with pytest.raises(port_faults.FaultSpecError):
        port_faults.get_fault_plane().arm("lane_poison", times=1)


def test_non_lane_failure_still_escalates_to_demotion(monkeypatch):
    """When every lane fails alone the failure is no lane's: the ladder
    demotes the context instead of quarantining the batch lane by lane,
    on both sides alike."""
    monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", "0")
    out = {}
    for package in PACKAGES:
        stats_module = jax_stats if package == "mythril_tpu" else port_stats
        importlib.import_module(
            f"{package}.resilience.faults").get_fault_plane().arm(
                "dispatch_error", times=999)
        verdicts, stats = frontier_check(package, "de")
        out[package] = (verdicts, stats.fused, stats_module.demotions,
                        stats_module.quarantined_lanes)
    assert out["mythril_tpu_torch"] == out["mythril_tpu"]
    verdicts, fused, demotions, quarantined = out["mythril_tpu_torch"]
    assert all(v is None for v in verdicts)
    assert fused is True and demotions >= 1 and quarantined == 0


# ---------------------------------------------------------------------------
# the watchdog's latency table
# ---------------------------------------------------------------------------


def test_ewma_table_is_bounded_with_lru_eviction():
    cap = port_watchdog.EWMA_CAP
    dog = port_watchdog.DispatchWatchdog()
    for i in range(4 * cap):
        dog.observe(f"gather:{i}", 0.1)
    assert cap - cap // 4 <= len(dog._ewma) <= cap
    dog.observe("hot", 0.2)
    for i in range(4 * cap, 8 * cap):
        dog.deadline_for("hot")
        dog.observe(f"gather:{i}", 0.1)
    assert "hot" in dog._ewma
    assert len(dog._ewma) <= cap
    # the oldest quarter went first: the newest keys are all kept
    assert all(f"gather:{i}" in dog._ewma
               for i in range(8 * cap - cap // 2, 8 * cap))


def test_ewma_table_covers_resident_key_family(monkeypatch):
    monkeypatch.setattr(port_watchdog, "DEADLINE_FLOOR_S", 5.0)
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "120")
    cap = port_watchdog.EWMA_CAP
    dog = port_watchdog.DispatchWatchdog()
    for bucket in (4, 8, 16, 32, 64, 128):
        dog.observe(f"resident:{bucket}", 0.5)
    assert len(dog._ewma) == 6
    for i in range(4 * cap):
        dog.deadline_for("resident:8")
        dog.observe(f"frontier:{i}", 0.1)
    assert "resident:8" in dog._ewma
    assert len(dog._ewma) <= cap
    assert dog.deadline_for("resident:8") < dog.deadline_for("resident:256")


def test_the_resident_solver_dispatches_under_its_bucket_key():
    """The analysis's resident solves are supervised under one
    ``resident:{bucket}`` key a lane bucket, and the frontier solver
    reaches its own fault seam, as in JAX."""
    base, port = baseline()
    keys = set(port_watchdog.get_watchdog()._ewma)
    _run("port", CHAOS, 1)
    keys = set(port_watchdog.get_watchdog()._ewma) - keys
    assert keys and all(k.startswith(("resident:", "pallas")) for k in keys)
    assert any(k.startswith("resident:") for k in keys)
    assert port_faults.get_fault_plane().hits["frontier_stall"] > 0
