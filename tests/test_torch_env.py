"""The port's ``MYTHRIL_TPU_*`` knobs against the JAX package's, on the
CPU: ``MYTHRIL_TPU_FRONTIER=0`` (the resident solver off on both sides;
the port's CLI and funnel refuse it), ``MYTHRIL_TPU_PALLAS=0`` (the
dense tier off on both sides) and the startup validator (the same
verdict on every tabled value; the port's CLI exits 2)."""

import pytest

import mythril_tpu.smt as JS
from mythril_tpu.ops import batched_sat as jax_bs
from mythril_tpu.ops import pallas_prop as jax_pallas
from mythril_tpu.ops import resident as jax_resident
from mythril_tpu.smt.solver import get_blast_context as jax_context
from mythril_tpu.smt.solver import reset_blast_context as jax_reset
from mythril_tpu.support import env as jax_env
from mythril_tpu_torch import frontiers
from mythril_tpu_torch.interfaces import cli as port_cli
from mythril_tpu_torch.ops import batched_sat as port_bs
from mythril_tpu_torch.ops import dense_prop as port_dense
from mythril_tpu_torch.ops import resident as port_resident
from mythril_tpu_torch.smt.solver import get_blast_context as port_context
from mythril_tpu_torch.smt.solver import reset_blast_context as port_reset
from mythril_tpu_torch.support import env as port_env

#: the knobs the port reads
KNOBS = tuple(f"MYTHRIL_TPU_{name}" for name in (
    "DENSE", "FRONTIER", "FRONTIER_DEG", "FRONTIER_FAN", "FRONTIER_PERIOD",
    "PROBE_MEMO_CAP", "RESIDENT_BUDGET", "RESIDENT_EXTRA", "RESIDENT_KERNEL",
    "RESIDENT_POOL", "RESIDENT_WATCHDOG", "ROUND_LADDER", "TIER_PERIOD",
    "WARM_START", "PALLAS"))


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    yield


def _analyze(capsys):
    """The port's CLI on a one-byte contract on the CPU: (exit code,
    stderr)."""
    with pytest.raises(SystemExit) as done:
        port_cli.main(["analyze", "-c", "0x00", "--bin-runtime",
                       "--no-onchain-data", "--device", "cpu"])
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


def test_frontier_off_exits_2_from_the_cli(monkeypatch, capsys):
    monkeypatch.setenv("MYTHRIL_TPU_FRONTIER", "0")
    code, err = _analyze(capsys)
    assert code == 2
    assert "MYTHRIL_TPU_FRONTIER=0" in err and len(err.splitlines()) == 1


def test_frontier_off_is_refused_by_the_funnel(monkeypatch):
    lanes, _ = frontiers.guard_chain_frontier(4, 8)
    monkeypatch.setenv("MYTHRIL_TPU_FRONTIER", "0")
    try:
        with pytest.raises(RuntimeError, match="MYTHRIL_TPU_FRONTIER=0"):
            port_bs.batch_check_states(lanes, device="cpu")
    finally:
        port_reset()


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

    devices = jax.devices  # one device, as the port (no sharded mesh)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.setattr(watchdog, "DEADLINE_FLOOR_S", 3600.0)
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
    # no entry in the JAX table: any value passes on both sides
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
    assert port_env.KNOWN_SPECS == want
    assert port_env.FLAG_VALUES == jax_env.FLAG_VALUES


def test_malformed_knob_exits_2_from_the_cli(monkeypatch, capsys):
    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_BUDGET", "abc")
    assert port_resident.resident_budget() == 3072  # the lenient read
    code, err = _analyze(capsys)
    assert code == 2
    assert err.startswith("bad environment knob: MYTHRIL_TPU_RESIDENT_BUDGET")
