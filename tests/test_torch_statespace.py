"""The port's statespace outputs against the JAX package's, on the CPU:
``-j/--statespace-json`` (``analysis/traceexplore.py``), ``-g/--graph``
(``analysis/callgraph.py``), the coverage search strategy
(``laser/plugin/plugins/coverage/coverage_strategy.py``) and the
benchmark plugin (``laser/plugin/plugins/benchmark.py``).

Each in-process case runs the JAX package and the port one after the
other under the parity pins of ``tests/test_torch_analyze.py``
(``analysis_pins``: ``MYTHRIL_TPU_PALLAS=force`` and one device on the
JAX side, the port on ``device="cpu"``).  Node uids come from a counter
of each package's ``laser/ethereum/cfg.py``; both counters are reset to
0 before each compared run, so the uids compare as they are.  The CLI
files come from two fresh processes and are compared after renumbering
the uids by first appearance.  Edge conditions and stack items are
compared as the two ``smt`` packages print them: a difference is a
parity fault, not a tolerance.
"""

import importlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import bench
from test_torch_analyze import (
    ADDRESS,
    FIXTURES,
    ROOT,
    _cli_issues,
    _reset_jax,
    analysis_pins,
)

SIDES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}
SUICIDE = os.path.join(FIXTURES, "suicide_anyone.hex")
EXEC_TIMEOUT = 600


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
def pins(monkeypatch):
    with analysis_pins(monkeypatch):
        yield


def mod(side, path):
    return importlib.import_module(f"{SIDES[side]}.{path}")


def _code(name):
    if name == "suicide_anyone":
        with open(SUICIDE) as fh:
            return "".join(line.strip() for line in fh)
    return bench.chaos_tree_contract()


def _reset(side, monkeypatch):
    """A fresh analysis state on ``side``, its node uids from 0."""
    if side == "jax":
        _reset_jax()
    else:
        mod("port", "mythril.mythril_analyzer").reset_analysis_state()
    monkeypatch.setattr(mod(side, "laser.ethereum.cfg"), "gbl_next_uid", 0)


def _analyzer(side, code, **kwargs):
    """The ``MythrilAnalyzer`` the CLI would build for ``code`` (bytecode
    of the runtime), with the CLI's defaults."""
    disassembler = mod(side, "mythril").MythrilDisassembler()
    disassembler.load_from_bytecode(code, True)
    extra = {"use_onchain_data": False}
    if side == "port":
        extra["device"] = "cpu"
    return mod(side, "mythril").MythrilAnalyzer(
        disassembler=disassembler, strategy="bfs", address=hex(ADDRESS),
        max_depth=128, execution_timeout=EXEC_TIMEOUT, loop_bound=3,
        create_timeout=10, **extra, **kwargs)


def _deadline(side):
    return mod(side, "laser.ethereum.time_handler").time_handler


@pytest.fixture
def kept_deadline():
    """Each package's execution deadline put back after the test."""
    handlers = [_deadline(side) for side in SIDES]
    saved = [h._deadline_ms for h in handlers]
    yield
    for handler, value in zip(handlers, saved):
        handler._deadline_ms = value


# ---------------------------------------------------------------------------
# -j: the statespace dump
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["suicide_anyone", "chaos_tree"])
def test_statespace_dump_matches_jax(name, monkeypatch, kept_deadline):
    dumps = {}
    for side in SIDES:
        _reset(side, monkeypatch)
        analyzer = _analyzer(side, _code(name))
        dumps[side] = json.loads(json.dumps(
            analyzer.dump_statespace(contract=analyzer.contracts[0])))
    assert dumps["port"] == dumps["jax"]
    assert dumps["port"]["nodes"] and dumps["port"]["edges"]
    assert [n["id"] for n in dumps["port"]["nodes"]] == [
        str(i) for i in range(len(dumps["port"]["nodes"]))]


# ---------------------------------------------------------------------------
# -g: the call graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("physics", [False, True])
def test_graph_html_is_byte_equal_to_jax(physics, monkeypatch,
                                         kept_deadline):
    pages = {}
    for side in SIDES:
        _reset(side, monkeypatch)
        analyzer = _analyzer(side, _code("suicide_anyone"))
        pages[side] = analyzer.graph_html(
            contract=analyzer.contracts[0], enable_physics=physics,
            transaction_count=1)
    assert pages["port"] == pages["jax"]
    assert f"physics: {{enabled: {str(physics).lower()}," in pages["port"]
    assert "{{" not in pages["port"]


def _fake_statespace(label):
    """A statespace of two nodes and one edge whose strings are ``label``
    (what the template fill must leave as it is)."""
    instruction = {"address": 7, "opcode": "PUSH1", "argument": label}
    state = SimpleNamespace(get_current_instruction=lambda: instruction)
    nodes = {
        uid: SimpleNamespace(uid=uid, function_name=label, states=[state])
        for uid in (0, 1)
    }
    edge = SimpleNamespace(condition=label + " 1234567",
                           as_dict={"from": 0, "to": 1})
    return SimpleNamespace(nodes=nodes, edges=[edge])


@pytest.mark.parametrize("label", [
    "plain", "{{ edges }}", "{{ nodes }} {% raw %}", "quote ' \" <b>&",
    "ünïcode ☃ \\n", "{#x#}",
])
@pytest.mark.parametrize("physics", [False, True])
def test_template_fill_is_jinjas_render(label, physics):
    """The port fills the template without ``jinja2``; on any label the
    page is the JAX package's (rendered by ``jinja2``) byte for byte."""
    space = _fake_statespace(label)
    port = mod("port", "analysis.callgraph").generate_graph(space, physics)
    jax = mod("jax", "analysis.callgraph").generate_graph(space, physics)
    assert port == jax


def test_callgraph_imports_no_jinja2():
    source = open(os.path.join(
        ROOT, "mythril_tpu_torch", "analysis", "callgraph.py")).read()
    assert "jinja2" not in source.split('"""', 2)[2]


# ---------------------------------------------------------------------------
# the CLI's -j and -g files
# ---------------------------------------------------------------------------


def renumbered(statespace: dict) -> dict:
    """The statespace with node ids renumbered by first appearance."""
    ids = {}
    for node in statespace["nodes"]:
        ids.setdefault(node["id"], str(len(ids)))
    out = json.loads(json.dumps(statespace))
    for node in out["nodes"]:
        node["id"] = ids[node["id"]]
    for edge in out["edges"]:
        edge["from"] = ids.get(edge["from"], edge["from"])
        edge["to"] = ids.get(edge["to"], edge["to"])
    return out


def _cli(side, *extra):
    argv = ([sys.executable, "myth", "analyze"] if side == "jax" else
            [sys.executable, "-m", "mythril_tpu_torch", "analyze",
             "--device", "cpu"])
    # one intra-op thread: beside the other test files' processes, a CLI
    # that takes every core slows them all (tests/test_torch_fleet.py)
    env = dict(os.environ, JAX_PLATFORMS="cpu", MYTHRIL_TPU_PALLAS="force",
               XLA_FLAGS="", OMP_NUM_THREADS="1")
    run = subprocess.run(
        argv + ["-f", SUICIDE, "--bin-runtime", "-t", "1",
                "--no-onchain-data", *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    return run


def test_cli_statespace_and_graph_files_equal_jax(tmp_path):
    for side in SIDES:
        _cli(side, "-j", str(tmp_path / f"{side}.json"))
        _cli(side, "-g", str(tmp_path / f"{side}.html"), "--enable-physics",
             "--phrack")
    spaces = {side: json.loads((tmp_path / f"{side}.json").read_text())
              for side in SIDES}
    assert renumbered(spaces["port"]) == renumbered(spaces["jax"])
    assert spaces["port"]["nodes"]
    assert (tmp_path / "port.html").read_bytes() == \
        (tmp_path / "jax.html").read_bytes()


def test_cli_takes_the_coverage_strategy_and_parallel_solving():
    jax, port = _cli_issues(["--enable-coverage-strategy",
                             "--parallel-solving"])
    assert jax and [i["swcID"] for i in jax] == ["SWC-106"]
    assert port == jax


# ---------------------------------------------------------------------------
# the coverage strategy
# ---------------------------------------------------------------------------


def _coverage_run(side, monkeypatch, code, tx_count):
    """An analysis with the coverage strategy: (SWC set, the states in
    the order they left the work list, as (pc, depth, constraints))."""
    _reset(side, monkeypatch)
    strategy = mod(side, "laser.plugin.plugins.coverage.coverage_strategy")
    order = []
    real = strategy.CoverageStrategy.get_strategic_global_state

    def recording(self):
        state = real(self)
        order.append((state.mstate.pc, state.mstate.depth,
                      len(state.world_state.constraints)))
        return state

    monkeypatch.setattr(strategy.CoverageStrategy,
                        "get_strategic_global_state", recording)
    _deadline(side).start_execution(EXEC_TIMEOUT)
    sym = mod(side, "analysis.symbolic").SymExecWrapper(
        mod(side, "solidity.evmcontract").EVMContract(code=code, name="MAIN"),
        address=ADDRESS, strategy="bfs", max_depth=128,
        execution_timeout=EXEC_TIMEOUT, create_timeout=10,
        transaction_count=tx_count, compulsory_statespace=False,
        enable_coverage_strategy=True,
    )
    assert type(sym.laser.strategy).__name__ == "CoverageStrategy"
    issues = mod(side, "analysis.security").fire_lasers(sym)
    return {i.swc_id for i in issues}, order


def test_coverage_strategy_order_and_findings_match_jax(monkeypatch,
                                                        kept_deadline):
    runs = {side: _coverage_run(side, monkeypatch, _code("chaos_tree"), 2)
            for side in SIDES}
    assert runs["port"][1] == runs["jax"][1]
    assert len(runs["port"][1]) > 10
    assert runs["port"][0] == runs["jax"][0] and "106" in runs["port"][0]


def test_analyzer_passes_the_coverage_strategy(monkeypatch, kept_deadline):
    """``MythrilAnalyzer(enable_coverage_strategy=True)`` runs the
    strategy; ``parallel_solving`` lands on the args bus, as in JAX."""
    seen = []
    strategy = mod("port", "laser.plugin.plugins.coverage.coverage_strategy")
    real = strategy.CoverageStrategy.__init__

    def recording(self, *args, **kwargs):
        seen.append(True)
        real(self, *args, **kwargs)

    monkeypatch.setattr(strategy.CoverageStrategy, "__init__", recording)
    _reset("port", monkeypatch)
    analyzer = _analyzer("port", _code("suicide_anyone"),
                         enable_coverage_strategy=True,
                         parallel_solving=True)
    report = analyzer.fire_lasers(transaction_count=1)
    assert seen == [True]
    assert mod("port", "support.support_args").args.parallel_solving is True
    assert [i.swc_id for i in report.issues.values()] == ["106"]


# ---------------------------------------------------------------------------
# the benchmark plugin
# ---------------------------------------------------------------------------


def _benchmark_run(side, monkeypatch, code):
    """A run with the benchmark plugin loaded through the laser plugin
    loader; returns the plugin."""
    _reset(side, monkeypatch)
    plugins = mod(side, "laser.plugin.plugins")
    loader = mod(side, "laser.plugin.loader").LaserPluginLoader()
    made = []

    class Capturing(plugins.BenchmarkPluginBuilder):
        def __call__(self, *args, **kwargs):
            made.append(super().__call__(*args, **kwargs))
            return made[-1]

    loader.load(Capturing())
    try:
        _deadline(side).start_execution(EXEC_TIMEOUT)
        mod(side, "analysis.symbolic").SymExecWrapper(
            mod(side, "solidity.evmcontract").EVMContract(code=code,
                                                          name="MAIN"),
            address=ADDRESS, strategy="bfs", max_depth=128,
            execution_timeout=EXEC_TIMEOUT, create_timeout=10,
            transaction_count=1, compulsory_statespace=False,
        )
    finally:
        del loader._builders["benchmark"]
    assert len(made) == 1
    return made[0]


def test_benchmark_plugin_counts_as_jax_and_writes_nothing_without_matplotlib(
        monkeypatch, tmp_path, kept_deadline):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    plugins = {side: _benchmark_run(side, monkeypatch,
                                    _code("suicide_anyone"))
               for side in SIDES}
    port, jax = plugins["port"], plugins["jax"]
    assert port.nr_of_executed_insns == jax.nr_of_executed_insns > 0
    series = list(port.coverage_series.items())
    assert series == sorted(series)
    assert [v for _t, v in series] == sorted(v for _t, v in series)
    assert series[-1][1] == port.nr_of_executed_insns
    assert port.end is not None and port.states_per_second > 0
    assert os.listdir(tmp_path) == []
