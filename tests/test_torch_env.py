"""The port's ``MYTHRIL_TPU_*`` knobs against the JAX package's, on the
CPU: ``MYTHRIL_TPU_FRONTIER=0`` (the resident solver off on both sides,
the gather tiers on round lanes: the funnel and the CLI match the JAX
package's), ``MYTHRIL_TPU_PALLAS=0`` (the dense tier off on both sides),
the word tier's kill switch (``MYTHRIL_TPU_WORD_TIER``, both ways on
both sides) and the startup validator (the same verdict on every tabled
value, the word tier's ``MYTHRIL_TPU_WORD_ROUNDS`` and
``MYTHRIL_TPU_WORD_MAX_NODES`` included; the port's CLI exits 2)."""

import json
import os
import subprocess
import sys

import pytest

import mythril_tpu.smt as JS
from mythril_tpu.ops import batched_sat as jax_bs
from mythril_tpu.ops import pallas_prop as jax_pallas
from mythril_tpu.ops import resident as jax_resident
from mythril_tpu.smt.solver import get_blast_context as jax_context
from mythril_tpu.smt.solver import reset_blast_context as jax_reset
from mythril_tpu.support import env as jax_env
from mythril_tpu_torch import contracts, frontiers
from mythril_tpu_torch.interfaces import cli as port_cli
from mythril_tpu_torch.ops import batched_sat as port_bs
from mythril_tpu_torch.ops import dense_prop as port_dense
from mythril_tpu_torch.ops import resident as port_resident
from mythril_tpu_torch.smt.solver import get_blast_context as port_context
from mythril_tpu_torch.smt.solver import reset_blast_context as port_reset
from mythril_tpu_torch.support import env as port_env
from mythril_tpu_torch.support.support_args import (
    FORCE_DISPATCH_ARGS,
    SLICE_PINS_ARGS,
    SLICE_PINS_ENV,
)
from mythril_tpu_torch.support.support_args import args as port_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the knobs the port reads
KNOBS = tuple(f"MYTHRIL_TPU_{name}" for name in (
    "COALESCE_FILL", "COALESCE_WINDOW",
    "DENSE", "FRONTIER", "FRONTIER_DEG", "FRONTIER_FAN", "FRONTIER_PERIOD",
    "PROBE_MEMO_CAP", "RESIDENT_BUDGET", "RESIDENT_EXTRA", "RESIDENT_KERNEL",
    "RESIDENT_POOL", "RESIDENT_WATCHDOG", "ROUND_LADDER", "TIER_PERIOD",
    "WARM_START", "PALLAS", "WORD_MAX_NODES", "WORD_ROUNDS", "WORD_TIER",
    "WORD_XP", "SYM_LOCKSTEP", "SEG_MIN_LANES", "SEG_MAX_OPS", "SEG_CEIL_MS",
    "SEG_PLANES", "SEG_PLANES_MEM", "SEG_MEM_WORDS", "SEG_STORAGE_SLOTS",
    "SEG_KECCAK_MAX_BYTES", "VERITEST", "MERGE_MAX_ITES", "MERGE_WINDOW",
    "SUBSUME_PERIOD", "TRACE", "TRACE_CAP", "LEDGER", "LEDGER_CAP",
    "AUTOPILOT", "AUTOPILOT_POLICY", "AUTOPILOT_MIN_SAMPLES",
    "AUTOPILOT_LADDER", "AUTOPILOT_TAIL_SHARE", "AUTOPILOT_EVAL_EVERY",
    "GOVERNOR", "GOVERNOR_STATES", "GOVERNOR_TERMS", "GOVERNOR_LANES",
    "GOVERNOR_RSS_MB", "PERSIST", "PERSIST_DIR", "PERSIST_FLUSH_S",
    "PERSIST_CAP_MB", "PERSIST_GOSSIP", "FLEET_HEARTBEAT_S",
    "FLEET_LEASE_TTL_S", "FLEET_SPLIT_AFTER_S", "FLEET_LEASE_RETRIES",
    "FLEET_SPAWN_RETRIES", "FLEET_CONNECT_TIMEOUT_S", "FLEET_HARD_CAP_S",
    "FLEET_MAX_FRAME", "FLEET_RECONNECT", "FLEET_LISTEN",
    "FLEET_SECRET_FILE", "SERVE_TENANT_QUOTA", "TRIAGE_MAX_CODE",
    "PROXY_DEPTH", "RPC_PROVIDERS", "RPC_BREAKER_FAILS",
    "RPC_BREAKER_COOLDOWN_S", "RPC_BACKOFF_CAP_S", "RPC_POOL_ATTEMPTS",
    "RPC_CACHE", "RPC_CACHE_DIR", "WATCH_CONFIRMATIONS", "WATCH_POLL_S",
    "WATCH_BACKLOG", "WATCH_FROM_BLOCK"))
#: the port's entries for knobs the JAX package reads without a static
#: entry (it checks none of them at startup but the tail share, which its
#: policy registers when first read): the kill switches of the tracer,
#: the ledger and the autopilot, the tracer's cap, the policy's name and
#: its tail-share threshold
PORT_ONLY_SPECS = {
    "MYTHRIL_TPU_TRACE": ("flag", None, None),
    "MYTHRIL_TPU_TRACE_CAP": ("int", 1, None),
    "MYTHRIL_TPU_LEDGER": ("flag", None, None),
    "MYTHRIL_TPU_AUTOPILOT": ("flag", None, None),
    "MYTHRIL_TPU_AUTOPILOT_POLICY": ("policy", None, None),
    "MYTHRIL_TPU_AUTOPILOT_TAIL_SHARE": ("float", 0.0, 1.0),
}


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    yield


def _analyze(capsys, extra=()):
    """The port's CLI on a one-byte contract on the CPU, with ``extra``
    options: (exit code, stderr)."""
    from test_torch_analyze import kept_deadlines

    with kept_deadlines(), pytest.raises(SystemExit) as done:
        port_cli.main(["analyze", "-c", "0x00", "--bin-runtime",
                       "--no-onchain-data", "--device", "cpu", *extra])
    return done.value.code, capsys.readouterr().err


# ------------------------------------------------ MYTHRIL_TPU_FRONTIER=0


@pytest.mark.parametrize("value", ["0", "off", "false"])
def test_frontier_off_disables_the_resident_solver_on_both_sides(
        monkeypatch, value):
    monkeypatch.setenv("MYTHRIL_TPU_FRONTIER", value)
    assert jax_resident.resident_kernel_enabled() is False
    assert port_resident.resident_kernel_enabled() is False
    monkeypatch.setenv("MYTHRIL_TPU_FRONTIER", "1")
    assert jax_resident.resident_kernel_enabled() is True
    assert port_resident.resident_kernel_enabled() is True


def _one_jax_device(monkeypatch):
    """The JAX package on one device, as the port (no sharded mesh), with
    its dispatch watchdog out of reach of a cold jit."""
    import jax

    from mythril_tpu.resilience import watchdog
    from mythril_tpu_torch.resilience import watchdog as port_watchdog

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.setattr(watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setattr(port_watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "3600")


#: dispatch counters both funnels keep, compared exactly
FUNNEL_COUNTERS = ("dispatches", "lanes", "unsat", "sat_verified",
                   "undecided", "rounds", "repacks", "device_sweeps",
                   "lane_sweeps_active", "lane_sweeps_total",
                   "frontier_steps", "resident_dispatches", "size_bailouts",
                   "cone_bailouts", "pool_uploads")


@pytest.fixture
def fresh_ledger():
    from test_torch_analyze import fresh_planes

    with fresh_planes():
        yield


@pytest.mark.parametrize("build", ["guard_chain", "scale_mul"])
def test_frontier_off_funnel_matches_jax(monkeypatch, fresh_ledger, build):
    """``MYTHRIL_TPU_FRONTIER=0`` with ``MYTHRIL_TPU_PALLAS=0``: one
    frontier through both funnels, force-dispatched, goes to the gather
    tiers' round-lane ladder on both sides (no resident solve, no
    frontier step) with the same verdicts and the same rounds, sweeps
    and re-packs."""
    from mythril_tpu.support.support_args import args as jax_args

    _one_jax_device(monkeypatch)
    monkeypatch.setenv("MYTHRIL_TPU_FRONTIER", "0")
    monkeypatch.setenv("MYTHRIL_TPU_PALLAS", "0")
    for name, value in {**SLICE_PINS_ENV}.items():
        monkeypatch.setenv(name, value)
    for name, value in {**SLICE_PINS_ARGS, **FORCE_DISPATCH_ARGS}.items():
        monkeypatch.setattr(jax_args, name, value)
    for name, value in FORCE_DISPATCH_ARGS.items():
        monkeypatch.setattr(port_args, name, value)
    recipe = {
        "guard_chain": lambda S: frontiers.guard_chain_frontier(
            12, 8, 2, smt=S),
        "scale_mul": lambda S: frontiers.scale_mul_frontier(
            3, 8, smt=S, calldata="words"),
    }[build]
    out = {}
    try:
        for side, S, reset, bs, kwargs in (
            ("jax", JS, jax_reset, jax_bs, {}),
            ("port", None, port_reset, port_bs, {"device": "cpu"}),
        ):
            reset()
            bs.dispatch_stats.reset()
            lanes, expected = recipe(S)
            verdicts = bs.batch_check_states(lanes, **kwargs)
            if side == "jax":  # the CDCL tail the JAX caller runs
                ctx = jax_context()
                verdicts = [
                    v if v is not None else {1: True, -1: False}.get(
                        ctx.check([c.raw for c in lane])[0])
                    for v, lane in zip(verdicts, lanes)]
            stats = bs.dispatch_stats
            out[side] = (verdicts, {k: getattr(stats, k)
                                    for k in FUNNEL_COUNTERS})
    finally:
        jax_reset()
        port_reset()
    assert out["port"] == out["jax"]
    verdicts, counters = out["port"]
    assert verdicts == expected
    assert counters["dispatches"] == 1 and counters["rounds"] >= 1
    assert counters["device_sweeps"] > 0
    assert counters["resident_dispatches"] == counters["frontier_steps"] == 0


#: ``python3 myth analyze`` with the slice pins that have no CLI flag, on
#: one JAX device
JAX_MYTH = """
import json, runpy, sys
import jax
devices = jax.devices
jax.devices = lambda *a, **k: devices(*a, **k)[:1]  # one device, as the port
pins = json.loads(sys.argv.pop(1))
from mythril_tpu.support.support_args import args
for name, value in pins["args"].items():
    setattr(args, name, value)
sys.argv[0] = "myth"
runpy.run_path("myth", run_name="__main__")
"""


def test_frontier_off_cli_matches_jax_cli():
    """``python -m mythril_tpu_torch analyze`` under
    ``MYTHRIL_TPU_FRONTIER=0`` (force-dispatched, so that the round
    lanes answer every frontier the caps allow) exits 0 and reports the
    JAX package's ``myth analyze`` issues under the same knobs."""
    hexfile = os.path.join(ROOT, "tests", "fixtures", "mainnet",
                           "origin_check.hex")
    common = ["-f", hexfile, "--bin-runtime", "-t", "1",
              "--no-onchain-data", "-o", "jsonv2",
              "--device-force-dispatch", "--no-async-dispatch"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", MYTHRIL_TPU_COALESCE="0",
               MYTHRIL_TPU_FRONTIER="0", MYTHRIL_TPU_PALLAS="0",
               **{k: v for k, v in SLICE_PINS_ENV.items()})
    pins = json.dumps({"args": {**SLICE_PINS_ARGS, **FORCE_DISPATCH_ARGS}})
    runs = {}
    for side, argv in (
        ("jax", [sys.executable, "-c", JAX_MYTH, pins, "analyze", *common,
                 "--workers", "0"]),
        ("port", [sys.executable, "-m", "mythril_tpu_torch", "analyze",
                  *common, "--device", "cpu"]),
    ):
        run = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        assert run.returncode == 0, (side, run.stderr[-2000:])
        issues = json.loads(run.stdout)[0]["issues"]
        for issue in issues:
            issue["extra"].pop("discoveryTime")
        runs[side] = issues
    assert runs["port"] == runs["jax"]
    assert [i["swcID"] for i in runs["jax"]] == ["SWC-115"]


# -------------------------------------------------- MYTHRIL_TPU_PALLAS=0


@pytest.mark.parametrize("value,on", [
    ("0", False), ("false", False), ("off", False), ("OFF", False),
    ("1", True), ("force", True), ("", True)])
def test_pallas_switch_gates_both_dense_tiers(monkeypatch, value, on):
    monkeypatch.setenv("MYTHRIL_TPU_PALLAS", value)
    assert jax_pallas.get_pallas_backend().available_for(None) is on
    assert port_dense.get_dense_backend("cpu").available_for(None) is on


def test_dense_alias_still_switches_the_port_tier_off(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_DENSE", "0")
    assert port_dense.get_dense_backend("cpu").available_for(None) is False


def test_pallas_off_routes_no_frontier_to_a_dense_tier(monkeypatch):
    """One frontier through each side's tier routing under
    ``MYTHRIL_TPU_PALLAS=0``: neither dense tier is asked, both gather
    tiers answer with the same verdicts."""
    import jax

    from mythril_tpu.resilience import watchdog
    from mythril_tpu_torch.resilience import watchdog as port_watchdog

    devices = jax.devices  # one device, as the port (no sharded mesh)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.setattr(watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setattr(port_watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "3600")
    monkeypatch.setenv("MYTHRIL_TPU_PALLAS", "0")
    asked = []

    def dense(self, ctx, sets, *args, **kwargs):
        asked.append(type(self).__module__)
        raise AssertionError("a dense tier was asked")

    monkeypatch.setattr(jax_pallas.PallasSatBackend, "check_assumption_sets",
                        dense)
    monkeypatch.setattr(port_dense.DenseSatBackend, "check_assumption_sets",
                        dense)
    verdicts = {}
    try:
        for side, S, reset, context, backend in (
            ("jax", JS, jax_reset, jax_context, jax_bs.BatchedSatBackend),
            ("port", None, port_reset, port_context,
             lambda: port_bs.BatchedSatBackend("cpu")),
        ):
            reset()
            lanes, _ = frontiers.guard_chain_frontier(8, 8, smt=S)
            ctx = context()
            sets = [list(dict.fromkeys(ctx.blast_lit(c.raw) for c in lane))
                    for lane in lanes]
            solver = backend()
            verdicts[side] = solver.check_assumption_sets(ctx, sets)
            assert solver.device_engaged, side
    finally:
        jax_reset()
        port_reset()
    assert not asked
    assert verdicts["port"] == verdicts["jax"]
    assert False in verdicts["port"]


# ----------------------------------------------------- the startup gate

#: (knob, value, rejected) on both sides
TABLE = [
    ("MYTHRIL_TPU_RESIDENT_BUDGET", "abc", True),
    ("MYTHRIL_TPU_RESIDENT_BUDGET", "0", True),
    ("MYTHRIL_TPU_RESIDENT_BUDGET", "-4", True),
    ("MYTHRIL_TPU_RESIDENT_BUDGET", "1.5", True),
    ("MYTHRIL_TPU_RESIDENT_BUDGET", "3072", False),
    ("MYTHRIL_TPU_RESIDENT_BUDGET", " 12 ", False),
    ("MYTHRIL_TPU_RESIDENT_BUDGET", "", False),
    ("MYTHRIL_TPU_RESIDENT_BUDGET", "   ", False),
    ("MYTHRIL_TPU_RESIDENT_WATCHDOG", "0", True),
    ("MYTHRIL_TPU_RESIDENT_EXTRA", "64", False),
    ("MYTHRIL_TPU_RESIDENT_EXTRA", "0x40", True),
    ("MYTHRIL_TPU_FRONTIER_DEG", "1", True),
    ("MYTHRIL_TPU_FRONTIER_DEG", "2", False),
    ("MYTHRIL_TPU_FRONTIER_FAN", "1b", True),
    ("MYTHRIL_TPU_FRONTIER_PERIOD", "0", True),
    ("MYTHRIL_TPU_TIER_PERIOD", "8", False),
    ("MYTHRIL_TPU_PROBE_MEMO_CAP", "0", True),
    ("MYTHRIL_TPU_RESIDENT_KERNEL", "0", False),
    ("MYTHRIL_TPU_RESIDENT_KERNEL", " Off ", False),
    ("MYTHRIL_TPU_RESIDENT_KERNEL", "FORCE", False),
    ("MYTHRIL_TPU_RESIDENT_KERNEL", "yes", True),
    ("MYTHRIL_TPU_RESIDENT_POOL", "2", True),
    ("MYTHRIL_TPU_WARM_START", "true", False),
    ("MYTHRIL_TPU_COALESCE_WINDOW", "4", False),
    ("MYTHRIL_TPU_COALESCE_WINDOW", "0", False),
    ("MYTHRIL_TPU_COALESCE_WINDOW", "-1", True),
    ("MYTHRIL_TPU_COALESCE_WINDOW", "2.5", True),
    ("MYTHRIL_TPU_COALESCE_FILL", "0.5", False),
    ("MYTHRIL_TPU_COALESCE_FILL", "1", False),
    ("MYTHRIL_TPU_COALESCE_FILL", "-0.25", True),
    ("MYTHRIL_TPU_COALESCE_FILL", "full", True),
    ("MYTHRIL_TPU_WORD_ROUNDS", "3", False),
    ("MYTHRIL_TPU_WORD_ROUNDS", "0", True),
    ("MYTHRIL_TPU_WORD_ROUNDS", "two", True),
    ("MYTHRIL_TPU_WORD_MAX_NODES", "64", False),
    ("MYTHRIL_TPU_WORD_MAX_NODES", "-5", True),
    ("MYTHRIL_TPU_WORD_MAX_NODES", "1e3", True),
    ("MYTHRIL_TPU_VERITEST", "0", False),
    ("MYTHRIL_TPU_VERITEST", "On", False),
    ("MYTHRIL_TPU_VERITEST", "merge", True),
    ("MYTHRIL_TPU_MERGE_MAX_ITES", "0", False),
    ("MYTHRIL_TPU_MERGE_MAX_ITES", "-1", True),
    ("MYTHRIL_TPU_MERGE_MAX_ITES", "sixteen", True),
    ("MYTHRIL_TPU_MERGE_WINDOW", "1", False),
    ("MYTHRIL_TPU_MERGE_WINDOW", "0", True),
    ("MYTHRIL_TPU_SUBSUME_PERIOD", "4", False),
    ("MYTHRIL_TPU_SUBSUME_PERIOD", "0", True),
    ("MYTHRIL_TPU_SUBSUME_PERIOD", "2.0", True),
    ("MYTHRIL_TPU_PERSIST", "off", False),
    ("MYTHRIL_TPU_PERSIST", "never", True),
    ("MYTHRIL_TPU_PERSIST_DIR", os.devnull, True),
    ("MYTHRIL_TPU_PERSIST_DIR", os.path.join(ROOT, "no-such-store"), False),
    ("MYTHRIL_TPU_PERSIST_FLUSH_S", "0", False),
    ("MYTHRIL_TPU_PERSIST_FLUSH_S", "-2", True),
    ("MYTHRIL_TPU_PERSIST_CAP_MB", "1", False),
    ("MYTHRIL_TPU_PERSIST_CAP_MB", "big", True),
    ("MYTHRIL_TPU_PERSIST_GOSSIP", "1", False),
    ("MYTHRIL_TPU_FLEET_HEARTBEAT_S", "0.25", False),
    ("MYTHRIL_TPU_FLEET_HEARTBEAT_S", "0.01", True),
    ("MYTHRIL_TPU_FLEET_LEASE_TTL_S", "120", False),
    ("MYTHRIL_TPU_FLEET_LEASE_TTL_S", "soon", True),
    ("MYTHRIL_TPU_FLEET_SPLIT_AFTER_S", "0", False),
    ("MYTHRIL_TPU_FLEET_SPLIT_AFTER_S", "-1", True),
    ("MYTHRIL_TPU_FLEET_LEASE_RETRIES", "0", False),
    ("MYTHRIL_TPU_FLEET_LEASE_RETRIES", "1.5", True),
    ("MYTHRIL_TPU_FLEET_SPAWN_RETRIES", "-1", True),
    ("MYTHRIL_TPU_FLEET_CONNECT_TIMEOUT_S", "300", False),
    ("MYTHRIL_TPU_FLEET_CONNECT_TIMEOUT_S", "0", True),
    ("MYTHRIL_TPU_FLEET_HARD_CAP_S", "900", False),
    ("MYTHRIL_TPU_FLEET_MAX_FRAME", "4096", False),
    ("MYTHRIL_TPU_FLEET_MAX_FRAME", "1024", True),
    ("MYTHRIL_TPU_FLEET_RECONNECT", "5", False),
    ("MYTHRIL_TPU_FLEET_RECONNECT", "always", True),
    ("MYTHRIL_TPU_FLEET_LISTEN", "127.0.0.1:4900", False),
    ("MYTHRIL_TPU_FLEET_LISTEN", "nocolon", True),
    ("MYTHRIL_TPU_FLEET_LISTEN", "h:70000", True),
    ("MYTHRIL_TPU_FLEET_SECRET_FILE", os.path.join(ROOT, "pyproject.toml"),
     False),
    ("MYTHRIL_TPU_FLEET_SECRET_FILE", os.path.join(ROOT, "no-such-secret"),
     True),
    ("MYTHRIL_TPU_SERVE_TENANT_QUOTA", "30", False),
    ("MYTHRIL_TPU_SERVE_TENANT_QUOTA", "-1", True),
    ("MYTHRIL_TPU_SERVE_TENANT_QUOTA", "lots", True),
    # no entry in the JAX table: any value passes on both sides
    ("MYTHRIL_TPU_WORD_TIER", "bogus", False),
    ("MYTHRIL_TPU_WORD_XP", "gpu", False),
    ("MYTHRIL_TPU_FRONTIER", "bogus", False),
    ("MYTHRIL_TPU_PALLAS", "auto", False),
    ("MYTHRIL_TPU_ROUND_LADDER", "maybe", False),
]


def _rejects(validate, error, environ):
    try:
        validate(environ)
    except error:
        return True
    return False


@pytest.mark.parametrize("knob,value,rejected", TABLE)
def test_validator_matches_jax(knob, value, rejected):
    environ = {knob: value}
    assert _rejects(jax_env.validate_env, jax_env.EnvSpecError,
                    environ) is rejected
    assert _rejects(port_env.validate_env, port_env.EnvSpecError,
                    environ) is rejected


def test_port_table_is_the_jax_table_for_its_knobs():
    want = {k: v for k, v in jax_env.KNOWN_SPECS.items() if k in KNOBS}
    assert not set(want) & set(PORT_ONLY_SPECS)
    assert port_env.KNOWN_SPECS == {**want, **PORT_ONLY_SPECS}
    assert port_env.FLAG_VALUES == jax_env.FLAG_VALUES


def test_malformed_knob_exits_2_from_the_cli(monkeypatch, capsys):
    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_BUDGET", "abc")
    assert port_resident.resident_budget() == 3072  # the lenient read
    code, err = _analyze(capsys)
    assert code == 2
    assert err.startswith("bad environment knob: MYTHRIL_TPU_RESIDENT_BUDGET")


@pytest.mark.parametrize("knob,value", [
    ("MYTHRIL_TPU_TRACE", "verbose"), ("MYTHRIL_TPU_TRACE_CAP", "lots"),
    ("MYTHRIL_TPU_LEDGER", "maybe"), ("MYTHRIL_TPU_LEDGER_CAP", "0"),
    ("MYTHRIL_TPU_AUTOPILOT", "auto"),
    ("MYTHRIL_TPU_AUTOPILOT_POLICY", "ledger-v9"),
    ("MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES", "0"),
    ("MYTHRIL_TPU_AUTOPILOT_LADDER", "2k"),
    ("MYTHRIL_TPU_AUTOPILOT_TAIL_SHARE", "1.5"),
    ("MYTHRIL_TPU_AUTOPILOT_EVAL_EVERY", "-8"),
    ("MYTHRIL_TPU_SEG_CEIL_MS", "-1")])
def test_malformed_plane_knob_exits_2_from_the_cli(monkeypatch, capsys,
                                                   knob, value):
    """The knobs of the tracer, the ledger and the autopilot go through
    the CLI's knob gate: a malformed value exits 2 before any
    analysis."""
    monkeypatch.setenv(knob, value)
    code, err = _analyze(capsys)
    assert code == 2
    assert err.startswith(f"bad environment knob: {knob}")


@pytest.mark.parametrize("option", ["--persist-dir", "--proof-log"])
def test_persist_dir_and_proof_log_run_from_the_cli(tmp_path, monkeypatch,
                                                     capsys, option):
    """``--persist-dir`` and ``--proof-log`` are no longer refused: the
    analysis runs to exit 0, with its knowledge in the store or its
    UNSAT verdicts certified; ``-q`` runs, and ``--solv`` without its
    binary ends with the JAX CLI's message."""
    from mythril_tpu_torch.persist import plane
    from mythril_tpu_torch.smt.drat import check_proof
    from mythril_tpu_torch.smt.solver import (
        get_blast_context, reset_blast_context,
    )

    # what the CLI sets for the analysis, put back after the test; the
    # blast context made afresh, as a CLI process makes it
    monkeypatch.setattr(port_args, "proof_log", False)
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path / "unused"))
    plane.reset_for_tests()
    reset_blast_context()
    extra = ([option, str(tmp_path / "store")] if option == "--persist-dir"
             else [option])
    try:
        code, err = _analyze(capsys, extra)
        assert code == 0, err
        if option == "--persist-dir":
            assert plane.get_knowledge_plane().warm_misses == 1
            assert plane.get_knowledge_plane().flush()
            assert any(n.startswith("seg-")
                       for n in os.listdir(tmp_path / "store"))
        else:
            solver = get_blast_context().solver
            assert solver.proof_enabled
            assert check_proof(solver.fetch_proof())["orig"] > 0
    finally:
        plane.reset_for_tests()
        reset_blast_context()
    # -q is taken and runs (the online lookup it asks for does nothing,
    # as in the JAX package); --solv without a matching solc binary ends
    # with the JAX CLI's message
    code, err = _analyze(capsys, ["-q"])
    assert code == 0, err
    code, err = _analyze(capsys, ["--solv", "0.8.0"])
    assert code == 1
    assert "No matching solc binary found for version 0.8.0" in err


def test_workers_runs_from_the_cli(monkeypatch, capsys):
    """``--workers 2`` is taken: a one-byte contract leaves no frontier
    to shard, and the analysis exits 0 on the CPU (the flag it sets put
    back after)."""
    monkeypatch.setattr(port_args, "fleet_workers", None)
    code, err = _analyze(capsys, ["--workers", "2"])
    assert port_args.fleet_workers == 2
    assert code == 0, err
    assert "not supported" not in err


@pytest.mark.parametrize("knob,value", [
    ("MYTHRIL_TPU_FLEET_LEASE_TTL_S", "soon"),
    ("MYTHRIL_TPU_FLEET_LISTEN", "nocolon"),
    ("MYTHRIL_TPU_FLEET_SECRET_FILE", "/no/such/secret")])
def test_malformed_fleet_knob_exits_2_from_the_cli(monkeypatch, capsys,
                                                   knob, value):
    monkeypatch.setenv(knob, value)
    code, err = _analyze(capsys, ["--workers", "2"])
    assert code == 2
    assert err.startswith(f"bad environment knob: {knob}")


def test_policy_knob_names_a_policy(monkeypatch, capsys):
    """``MYTHRIL_TPU_AUTOPILOT_POLICY=static`` passes the gate and the
    analysis runs."""
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_POLICY", "static")
    code, err = _analyze(capsys)
    assert code == 0, err


@pytest.mark.parametrize("knob", ["MYTHRIL_TPU_WORD_ROUNDS",
                                  "MYTHRIL_TPU_WORD_MAX_NODES"])
def test_malformed_word_knob_exits_2_from_the_cli(monkeypatch, capsys, knob):
    """The word tier's two numeric knobs go through the CLI's knob gate:
    a malformed value exits 2 before any analysis, a good one runs."""
    monkeypatch.setenv(knob, "zero")
    code, err = _analyze(capsys)
    assert code == 2
    assert err.startswith(f"bad environment knob: {knob}")
    monkeypatch.setenv(knob, "7")
    code, err = _analyze(capsys)
    assert code == 0, err


@pytest.mark.parametrize("value,enabled", [
    ("0", False), ("off", False), ("false", False), ("1", True),
    ("", True), ("on", True)])
def test_word_tier_kill_switch_matches_jax(monkeypatch, value, enabled):
    from mythril_tpu.smt import word_tier as jax_word
    from mythril_tpu_torch.smt import word_tier as port_word

    monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", value)
    assert jax_word.word_tier_enabled() is enabled
    assert port_word.word_tier_enabled() is enabled


def test_sym_lockstep_pins_leave_the_jax_ledger_on(monkeypatch):
    """The symbolic-lockstep tests' pins around one segment group on
    each package: both lane ledgers are on under them (the ledger is no
    slice pin) and count the group's lanes as the same ``lockstep``
    transitions.  Once the pins are gone, the ledger the next caller
    gets in each package is a fresh one, on and empty: the ledgers the
    pins made did not outlive them (a ledger made disabled under the
    old pins used to, and the JAX package's ledger tests that ran later
    in the same process read zeros)."""
    import test_torch_sym_lockstep as tsl
    from mythril_tpu.observability import ledger as jax_ledger
    from mythril_tpu_torch.observability import ledger as port_ledger

    monkeypatch.delenv("MYTHRIL_TPU_LEDGER", raising=False)
    counted = {}
    with pytest.MonkeyPatch.context() as pinned:
        with tsl.slice_pins(pinned):
            for name, module in (("jax", jax_ledger),
                                 ("port", port_ledger)):
                side = tsl.SIDES[name]
                tsl.lockstep_pass(side, [
                    tsl.make_state(side, "6001600201600055", stack)
                    for stack in ([("s", "a")], [("s", "b"), 5],
                                  [0xFFFF])])
                made = module._ledger
                assert made is not None and made.enabled
                counted[name] = dict(made.transitions)
    assert counted["port"] == counted["jax"]
    assert counted["jax"].get("lockstep", 0) > 0
    assert "MYTHRIL_TPU_LEDGER" not in os.environ
    for module in (jax_ledger, port_ledger):
        led = module.get_ledger()
        assert led.enabled and not led.transitions
        led.count_transition("quarantined")
        assert led.transitions == {"quarantined": 1}
        module.reset_for_tests()


@pytest.mark.parametrize("before", ["unarmed", "armed"])
def test_analysis_runs_leave_both_deadlines_as_they_were(monkeypatch,
                                                         before):
    """The execution deadline is a process-wide singleton in each
    package, and an analysis arms it.  After ``test_torch_analyze._run``
    on each side (killbilly, -t 1), both packages' deadlines are what
    they were before the run: unarmed, or a far one set here.  (They used
    to stay armed 600 s ahead, and a later test in the same process that
    asked the JAX package for a model read the expired deadline and got
    UNSAT.)"""
    import time

    import test_torch_analyze as tta
    from mythril_tpu.laser.ethereum.time_handler import (
        time_handler as jax_deadline,
    )
    from mythril_tpu_torch.laser.ethereum.time_handler import (
        time_handler as port_deadline,
    )

    want = None if before == "unarmed" else time.time() * 1000 + 1e9
    with tta.kept_deadlines(), tta.analysis_pins(monkeypatch):
        for handler in (jax_deadline, port_deadline):
            handler._deadline_ms = want
        for side in ("jax", "port"):
            found = tta._run(side, contracts.killbilly(), 1)
            assert {i["swc_id"] for i in found["issues"]} == {"106"}
        assert [jax_deadline._deadline_ms,
                port_deadline._deadline_ms] == [want, want]
