"""The port's slice as a whole: the frontier funnel against the JAX
package's, the no-fallback rule of the kernel wrapper, the chip check's
refusal to run without a card, and the import boundary of the port."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import mythril_tpu.smt as JS
from mythril_tpu.ops import batched_sat as jax_bs
from mythril_tpu.smt.solver import get_blast_context as jax_context
from mythril_tpu.smt.solver import reset_blast_context as jax_reset
from mythril_tpu.support.support_args import args as jax_args
from mythril_tpu_torch import frontiers
from mythril_tpu_torch.ops import batched_sat as port_bs
from mythril_tpu_torch.ops import dense_sweep
from mythril_tpu_torch.ops.incremental import reset_cone_memo
from mythril_tpu_torch.smt.solver import reset_blast_context as port_reset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def slice_config(monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_PALLAS", "force")
    monkeypatch.setenv("MYTHRIL_TPU_RESIDENT_KERNEL", "0")
    monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", "0")
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT", "0")
    # the JAX funnel under the port's phases: no probe before the
    # dispatch, no profit gate, no coalescing window
    monkeypatch.setattr(jax_args, "word_probing", False)
    monkeypatch.setattr(jax_args, "device_force_dispatch", True)
    monkeypatch.setattr(jax_args, "device_coalesce", False)
    jax_reset()
    port_reset()
    reset_cone_memo()
    yield
    jax_reset()
    port_reset()


def _jax_final_verdicts(lanes):
    """JAX funnel, then the CDCL tail its caller (laser/batch.py) runs
    for every lane it leaves undecided."""
    verdicts = jax_bs.batch_check_states(lanes)
    ctx = jax_context()
    out = []
    for lane, verdict in zip(lanes, verdicts):
        if verdict is None:
            status, _ = ctx.check([c.raw for c in lane])
            verdict = {1: True, -1: False}.get(status)
        out.append(verdict)
    return out


@pytest.mark.parametrize("build", ["scale_mul", "guard_chain"])
def test_funnel_matches_jax_funnel(build):
    """Same frontier through both ``batch_check_states``: identical final
    verdicts (the known ones), the dense tier engaged on both sides, and
    the same device-level decisions."""
    recipe = {
        "scale_mul": lambda S: frontiers.scale_mul_frontier(
            3, 8, smt=S, calldata="words"),
        "guard_chain": lambda S: frontiers.guard_chain_frontier(
            8, 8, 2, smt=S, calldata="words"),
    }[build]
    jlanes, expected = recipe(JS)
    stats = jax_bs.dispatch_stats
    before = (stats.dispatches, stats.unsat, stats.sat_verified,
              stats.rounds, stats.device_sweeps)
    jax_final = _jax_final_verdicts(jlanes)
    jax_delta = [now - was for now, was in zip(
        (stats.dispatches, stats.unsat, stats.sat_verified, stats.rounds,
         stats.device_sweeps), before)]

    plan, _ = recipe(None)
    port_bs.dispatch_stats.reset()
    port_final = port_bs.batch_check_states(plan, device="cpu")
    ps = port_bs.dispatch_stats
    assert port_final == jax_final == expected
    assert ps.dispatches == jax_delta[0] == 1
    assert [ps.unsat, ps.sat_verified, ps.rounds, ps.device_sweeps] \
        == jax_delta[1:]
    assert ps.unsat > 0 and ps.rounds > 0


def test_structural_false_and_tail(monkeypatch):
    """Folded-False lanes never reach a solver; below the lane floor the
    funnel goes straight to the CDCL tail."""
    import mythril_tpu_torch.smt as PS

    x = PS.symbol_factory.BitVecSym("tail_x", 8)
    lanes = [[False], [x == 3], [PS.ULT(x, 2), PS.UGT(x, 5)]]
    port_bs.dispatch_stats.reset()
    assert port_bs.batch_check_states(lanes, device="cpu") == [
        False, True, False
    ]
    assert port_bs.dispatch_stats.dispatches == 0
    assert port_bs.dispatch_stats.tail_sat == 1
    assert port_bs.dispatch_stats.tail_unsat == 1


def test_wrapper_never_falls_back_for_device_tensors(monkeypatch):
    """A tensor off the CPU goes to the kernel path or raises: the plain
    version is never taken for it."""
    def no_plain(*_args, **_kwargs):
        raise AssertionError("plain version taken for a device tensor")

    monkeypatch.setattr(dense_sweep, "sweep_plain", no_plain)
    P = torch.zeros((128, 128), dtype=torch.bfloat16, device="meta")
    W = torch.zeros((1, 128), device="meta")
    A = torch.zeros((8, 128), device="meta")
    before = dense_sweep.launch_count
    with pytest.raises(ValueError):
        dense_sweep.dense_sweep(P, P, W, A, True)
    assert dense_sweep.launch_count == before


def test_wrapper_refuses_clauses_wider_than_the_kernel_row_list():
    """The kernel keeps one row's cells in shared memory: the wrapper's
    width check passes MAX_ROW_LITERALS and refuses one more, also when a
    checked width tensor is later written in place."""
    width = torch.zeros((1, 256))
    width[0, 3] = dense_sweep.MAX_ROW_LITERALS
    dense_sweep._check_widths(width)
    width[0, 4] = dense_sweep.MAX_ROW_LITERALS + 1
    with pytest.raises(ValueError, match="literals"):
        dense_sweep._check_widths(width)


def test_kernel_build_raises_without_toolkit(monkeypatch, tmp_path):
    monkeypatch.setattr(dense_sweep, "CUDA_HOMES", (str(tmp_path),))
    monkeypatch.setattr(dense_sweep.shutil, "which", lambda _name: None)
    monkeypatch.setattr(dense_sweep, "LIBRARY", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="nvcc"):
        dense_sweep.build_library()


def test_entry_points_refuse_missing_card(monkeypatch):
    from mythril_tpu_torch.ops import default_device
    from mythril_tpu_torch.ops.dense_prop import DenseSatBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseSatBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_bs.batch_check_states([[True]])
    assert default_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_card(tmp_path):
    """Without a card the chip check exits non-zero and prints no result
    line; alone in a directory it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    run = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout


def _port_sources():
    pkg = os.path.join(ROOT, "mythril_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "mythril_tpu"):
                    offenders.append(f"{path}: {name}")
    assert not offenders, offenders
    assert len(list(_port_sources())) > 10  # vacuity: the walk found code
