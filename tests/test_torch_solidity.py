"""Solidity input of the port (``ethereum/util.py``,
``solidity/soliditycontract.py``, ``load_from_solidity``, ``--solv``,
``--solc-json``, the signature store and ``truffle``) held against the
JAX package on the same inputs.

There is no solc here: ``contracts.write_solc_standin`` writes a stand-in
that answers ``--standard-json`` from the fixtures of
``contracts.SOURCE_FIXTURES`` (bytecode this repository builds, a source
text written for it, a source map in solc's compressed format).  It is no
compiler; what these cases test is the packages' own code.

The JAX package's ``SolidityContract`` iterates the keys of its
``solc_indices`` (the sources' integer ids) where it means the file
names, and opens the ids as file descriptors: a one-file source reads
stdin and closes it, a two-file source ends in ``OSError: Bad file
descriptor``.  The port reads the files by name.  So the parity cases
give the JAX side, in this process only, an index that iterates its
names (:class:`ByName`); :func:`test_jax_opens_the_source_ids_as_files`
shows the fault itself.  No case lets the JAX package open a descriptor
of the test process.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest

from mythril_tpu_torch import contracts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}

#: (main file, contract) of every fixture contract with code
CODED = [(f, c) for f in contracts.SOURCE_FIXTURES
         for c, out in contracts.solc_output(f)[1]["contracts"][f].items()
         if out["evm"]["deployedBytecode"]["object"]]


def mod(side, path):
    return importlib.import_module(f"{SIDES[side]}.{path}")


@pytest.fixture(scope="module", autouse=True)
def _unarmed_jax_deadline():
    """The JAX package's execution deadline unarmed before and after this
    file, as in a fresh process: pre-port tests leave it armed (ROADMAP
    Queue C), and once it has passed a later ``get_model`` of that
    package answers UNSAT."""
    from mythril_tpu.laser.ethereum.time_handler import time_handler

    time_handler._deadline_ms = None
    yield
    time_handler._deadline_ms = None


class ByName(dict):
    """``solc_indices`` iterated by their file names (the values): what
    the JAX package's ``SolidityContract`` needs to read its sources."""

    def __iter__(self):
        return iter(self.values())


@pytest.fixture(autouse=True)
def jax_reads_files_by_name(monkeypatch):
    cls = mod("jax", "solidity.soliditycontract").SolidityContract
    indices = cls.get_solc_indices
    monkeypatch.setattr(cls, "get_solc_indices",
                        staticmethod(lambda data: ByName(indices(data))))


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The stand-in compiler and every fixture's sources, once."""
    root = tmp_path_factory.mktemp("solc")
    bin_dir = contracts.write_solc_standin(str(root / "bin"))
    src = root / "src"
    src.mkdir()
    for main_file in contracts.SOURCE_FIXTURES:
        contracts.write_sources(str(src), main_file)
    (src / "Other.sol").write_text("contract Other {}\n")
    return {"bin": bin_dir, "src": str(src)}


@pytest.fixture(autouse=True)
def _environment(standin, tmp_path, monkeypatch):
    """``HOME`` and ``MYTHRIL_DIR`` in a temporary directory (the
    signature store lives there), the stand-in first on ``PATH``, the
    sources' directory the working directory."""
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("MYTHRIL_DIR", str(home / ".mythril_tpu"))
    monkeypatch.delenv("INFURA_ID", raising=False)
    monkeypatch.setenv("PATH", standin["bin"] + os.pathsep
                       + os.environ.get("PATH", ""))
    monkeypatch.chdir(standin["src"])


def _info(info):
    return None if info is None else (info.filename, info.lineno, info.code,
                                      info.solc_mapping)


def _addresses(code):
    return [a for a, _ in contracts._ops(code)]


# ---------------------------------------------------------------------------
# the fixtures and the decoder
# ---------------------------------------------------------------------------


def test_fixture_maps_exercise_every_branch_of_the_decoder():
    """The fixtures' maps hold inherited (empty) fields, whole empty
    entries, file index -1, both files of a two-file source and jump
    fields; ``decode_source_map`` inherits the way solc means it."""
    maps = []
    for main_file, name in CODED:
        evm = contracts.solc_output(main_file)[1]["contracts"][main_file][
            name]["evm"]
        maps += [evm["bytecode"]["sourceMap"],
                 evm["deployedBytecode"]["sourceMap"]]
    entries = [e for m in maps for e in m.split(";")]
    assert "" in entries
    assert any(e.startswith(":") and e.strip(":") for e in entries)
    assert any(e.startswith("-1:-1:-1") for e in entries)
    assert any(e.endswith(":i") for e in entries)
    assert any(e.endswith(":o") for e in entries)
    scale = contracts.solc_output("SCALE.sol")[1]["contracts"]["SCALE.sol"][
        "Scale"]["evm"]["deployedBytecode"]["sourceMap"]
    assert {f for _, _, f in contracts.decode_source_map(scale)} == {-1, 0, 1}
    assert contracts.decode_source_map("1:2:0:-:0;;:5;7::1:i;-1:-1:-1") == [
        (1, 2, 0), (1, 2, 0), (1, 5, 0), (7, 5, 1), (-1, -1, -1)]


@pytest.mark.parametrize("main_file,name", CODED,
                         ids=[f"{f}:{c}" for f, c in CODED])
def test_solc_indices_and_source_maps_match_jax(main_file, name):
    """From the same standard-json output: the indices, the runtime's and
    the constructor's mappings field by field, and the source info at
    every address of both codes, equal on both sides and to the plain
    decoding of the fixture."""
    _, output = contracts.solc_output(main_file)
    got = {}
    for side in SIDES:
        cls = mod(side, "solidity.soliditycontract").SolidityContract
        contract = cls(input_file=main_file, name=name, solc_data=output)
        fields = lambda ms: [(m.solidity_file_idx, m.offset, m.length,  # noqa: E731
                              m.lineno, m.solc_mapping) for m in ms]
        infos = {}
        for constructor, code in ((False, contract.code),
                                  (True, contract.creation_code)):
            for address in _addresses(code):
                infos[(constructor, address)] = _info(
                    contract.get_source_info(address,
                                             constructor=constructor))
        got[side] = (dict(cls.get_solc_indices(output)),
                     fields(contract.mappings),
                     fields(contract.constructor_mappings), infos,
                     [f.filename for f in contract.solidity_files],
                     contract.name)
    assert got["port"] == got["jax"]
    infos = got["port"][3]
    assert any(info is not None for info in infos.values())
    for (constructor, address), info in infos.items():
        plain = contracts.plain_source_info(main_file, name, address,
                                            constructor)
        assert (info and info[:3]) == plain, (constructor, address)


@pytest.mark.parametrize("main_file", sorted(contracts.SOURCE_FIXTURES))
def test_get_contracts_from_file_matches_jax(main_file):
    """Every contract of the main file with runtime code, by name, through
    the stand-in on ``PATH``; interfaces and abstract contracts left
    out."""
    got = {}
    for side in SIDES:
        found = mod(side, "solidity.soliditycontract").get_contracts_from_file(
            main_file, solc_binary="solc")
        got[side] = [(c.name, c.code, c.creation_code, c.input_file)
                     for c in found]
    assert got["port"] == got["jax"]
    assert [g[0] for g in got["port"]] == sorted(
        c for f, c in CODED if f == main_file)


def test_named_default_and_missing_contracts_match_jax():
    """``FILE:NAME`` takes the named contract, no name the last one with
    code; an interface or an unknown name has no contract."""
    for side in SIDES:
        sc = mod(side, "solidity.soliditycontract")
        exc = mod(side, "exceptions")
        assert sc.SolidityContract("SCALE.sol").name == "Scale"
        assert sc.SolidityContract("SCALE.sol", name="Helper").name == "Helper"
        for name in ("IScale", "Nope"):
            with pytest.raises(exc.NoContractFoundError):
                sc.SolidityContract("SCALE.sol", name=name)


@pytest.mark.parametrize("targets,want", [
    (["SCALE.sol:Helper"], ["Helper"]),
    (["SCALE.sol"], ["Helper", "Scale"]),
    (["KillBilly.sol", "Token.sol:Token"], ["KillBilly", "Token"]),
    (["missing.sol"], "Input file not found: missing.sol"),
    (["missing.sol:Helper"], "Input file not found: missing.sol:Helper"),
    (["Other.sol"], "Solc experienced a fatal error"),
])
def test_load_from_solidity_matches_jax(targets, want):
    got = {}
    for side in SIDES:
        disassembler = mod(side, "mythril").MythrilDisassembler()
        try:
            address, loaded = disassembler.load_from_solidity(targets)
            got[side] = (address, [c.name for c in loaded],
                         [c.name for c in disassembler.contracts])
        except mod(side, "exceptions").CriticalError as e:
            got[side] = str(e)
    assert got["port"] == got["jax"]
    if isinstance(want, list):
        assert got["port"] == ("0x" + "0" * 40, want, want)
    else:
        assert want in got["port"]


@pytest.fixture
def versioned_only(tmp_path, standin, monkeypatch):
    """``PATH`` with ``solc-SOLC_VERSION`` and no plain ``solc``."""
    only = tmp_path / "versioned"
    only.mkdir()
    name = f"solc-{contracts.SOLC_VERSION}"
    os.symlink(os.path.join(standin["bin"], name), only / name)
    monkeypatch.setenv("PATH", str(only))
    return str(only)


@pytest.mark.parametrize("version,want", [
    (None, "solc"), (contracts.SOLC_VERSION, f"solc-{contracts.SOLC_VERSION}"),
    ("v" + contracts.SOLC_VERSION, f"solc-{contracts.SOLC_VERSION}"),
    ("0.7.6", "solc")])
def test_solv_picks_the_binary_as_jax(version, want, standin):
    """``--solv V`` takes ``solc-V``, ``solcV`` or ``solc`` from ``PATH``,
    whichever comes first; no version takes ``solc``."""
    got = {side: mod(side, "mythril").MythrilDisassembler(
        solc_version=version).solc_binary for side in SIDES}
    assert got["port"] == got["jax"] == os.path.join(standin["bin"], want)


def test_solv_without_a_matching_binary_matches_jax(versioned_only):
    got = {}
    for side in SIDES:
        dis = mod(side, "mythril").MythrilDisassembler
        assert dis(solc_version=contracts.SOLC_VERSION).solc_binary == (
            os.path.join(versioned_only, f"solc-{contracts.SOLC_VERSION}"))
        assert dis().solc_binary is None
        with pytest.raises(mod(side, "exceptions").CriticalError) as e:
            dis(solc_version="0.7.6")
        got[side] = str(e.value)
    assert got["port"] == got["jax"] == (
        "No matching solc binary found for version 0.7.6")


def test_solc_json_settings_reach_the_compiler(standin):
    """``--solc-json``'s settings go into the standard-json request of the
    binary ``--solv`` picked, beside the output selection both packages
    set; the request and the answer are the same on both sides."""
    settings = {"optimizer": {"enabled": False, "runs": 7},
                "evmVersion": "paris"}
    binary = os.path.join(standin["bin"], f"solc-{contracts.SOLC_VERSION}")
    got = {}
    for side in SIDES:
        before = len(contracts.standin_requests(standin["bin"]))
        output = mod(side, "ethereum.util").get_solc_json(
            "KillBilly.sol", solc_binary=binary,
            solc_settings_json=json.dumps(settings))
        requests = contracts.standin_requests(standin["bin"])[before:]
        assert len(requests) == 1
        got[side] = (output, requests[0])
    assert got["port"] == got["jax"]
    request = got["port"][1]
    assert request["binary"] == f"solc-{contracts.SOLC_VERSION}"
    assert request["argv"] == ["--standard-json", "--allow-paths", "."]
    sent = request["input"]["settings"]
    assert {k: sent[k] for k in settings} == settings
    assert "evm.methodIdentifiers" in sent["outputSelection"]["*"]["*"]
    assert request["input"]["sources"] == {
        "KillBilly.sol": {"urls": ["KillBilly.sol"]}}


def test_malformed_solc_json_is_a_compiler_error_in_the_port():
    """A ``--solc-json`` that is not JSON: the JAX package raises the
    parser's ``JSONDecodeError`` (its CLI prints a traceback), the port a
    ``CompilerError`` that names the option."""
    with pytest.raises(json.JSONDecodeError):
        mod("jax", "ethereum.util").get_solc_json(
            "KillBilly.sol", solc_settings_json="{not json")
    port = mod("port", "ethereum.util")
    with pytest.raises(mod("port", "exceptions").CompilerError,
                       match="--solc-json is not valid JSON"):
        port.get_solc_json("KillBilly.sol", solc_settings_json="{not json")


# ---------------------------------------------------------------------------
# the signature store
# ---------------------------------------------------------------------------


def _rows(path):
    import sqlite3

    with sqlite3.connect(path) as db:
        return sorted(db.execute("SELECT byte_sig, text_sig FROM signatures"))


def test_import_solidity_file_matches_jax(tmp_path):
    """``import_solidity_file`` of the two-file fixture into a store each:
    the same rows; the helper's function and a leaf are found."""
    rows = {}
    for side in SIDES:
        path = str(tmp_path / f"{side}.db")
        db = mod(side, "support.signatures").SignatureDB(path=path)
        db.import_solidity_file("SCALE.sol")
        db.import_solidity_file("ScaleBase.sol")
        db.import_solidity_file("missing.sol")
        rows[side] = _rows(path)
    assert rows["port"] == rows["jax"]
    selector_of = mod("port", "support.signatures").selector_of
    for sig in (contracts.HELPER_SIGNATURE, "leaf6(uint256)",
                "mulGuard(uint256,uint256)"):
        assert (selector_of(sig), sig) in rows["port"]


def test_method_identifiers_name_the_functions_through_the_store():
    """Without the store the helper's entry is ``_function_0x...``; a
    ``SolidityContract`` registers its file's ``methodIdentifiers``, and
    from then on both packages name it by its signature (one store, the
    JAX package's file under ``HOME``)."""
    selector = mod("port", "support.signatures").selector_of(
        contracts.HELPER_SIGNATURE)
    _, output = contracts.solc_output("SCALE.sol")
    runtime = output["contracts"]["SCALE.sol"]["Helper"]["evm"][
        "deployedBytecode"]["object"]
    for side in SIDES:
        names = mod(side, "solidity.evmcontract").EVMContract(
            runtime).disassembly.address_to_function_name
        assert list(names.values()) == [f"_function_{selector}"]
    mod("port", "solidity.soliditycontract").SolidityContract(
        "SCALE.sol", name="Helper", solc_data=output)
    store = os.path.join(os.environ["HOME"], ".mythril_tpu", "signatures.db")
    assert (selector, contracts.HELPER_SIGNATURE) in _rows(store)
    for side in SIDES:
        names = mod(side, "solidity.evmcontract").EVMContract(
            runtime).disassembly.address_to_function_name
        assert list(names.values()) == [contracts.HELPER_SIGNATURE]


# ---------------------------------------------------------------------------
# faults of the JAX package
# ---------------------------------------------------------------------------


def test_jax_opens_the_source_ids_as_files(monkeypatch):
    """The JAX package's ``SolidityContract`` opens ``SolcSource(0)`` and
    ``SolcSource(1)`` (stdin and stdout) for a two-file source; the port
    reads ``SCALE.sol`` and ``ScaleBase.sol``.  (The JAX side's sources
    are recorded here, never opened.)"""
    opened = []

    class Recorded:
        def __init__(self, filename):
            opened.append(filename)
            self.filename, self.data, self.code = filename, b"", ""

    jax_sc = mod("jax", "solidity.soliditycontract")
    monkeypatch.setattr(jax_sc, "SolcSource", Recorded)
    monkeypatch.setattr(jax_sc.SolidityContract, "get_solc_indices",
                        staticmethod(lambda data: {0: "SCALE.sol",
                                                   1: "ScaleBase.sol"}))
    _, output = contracts.solc_output("SCALE.sol")
    jax_sc.SolidityContract("SCALE.sol", name="Helper", solc_data=output)
    assert opened == [0, 1]
    port = mod("port", "solidity.soliditycontract").SolidityContract(
        "SCALE.sol", name="Helper", solc_data=output)
    assert [f.filename for f in port.solidity_files] == [
        "SCALE.sol", "ScaleBase.sol"]
    assert port.solidity_files[1].code == contracts.solc_output(
        "SCALE.sol")[0]["ScaleBase.sol"]


def test_no_solc_is_a_type_error_in_jax_and_a_one_line_error_in_the_port(
        tmp_path, monkeypatch):
    """With no solc on ``PATH`` the JAX package passes ``None`` on to
    ``shutil.which`` (a ``TypeError``, which its CLI prints as a
    traceback); the port raises its ``CompilerError`` as a
    ``CriticalError``, and its CLI ends with that one line, exit 1."""
    empty = tmp_path / "no-solc"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    jax_dis = mod("jax", "mythril").MythrilDisassembler()
    assert jax_dis.solc_binary is None
    with pytest.raises(TypeError, match="expected str, bytes or os.PathLike"):
        jax_dis.load_from_solidity(["KillBilly.sol"])
    port_dis = mod("port", "mythril").MythrilDisassembler()
    with pytest.raises(mod("port", "exceptions").CriticalError,
                       match="Compiler not found: 'solc'"):
        port_dis.load_from_solidity(["KillBilly.sol"])
    done = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "analyze",
         "KillBilly.sol", "-t", "1", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300, stdin=subprocess.DEVNULL)
    assert done.returncode == 1
    assert done.stderr.strip().splitlines() == [
        "Compiler not found: 'solc'. Install solc or pass --bin runtime "
        "bytecode / a -c hex string instead."]
    assert done.stdout == ""


# ---------------------------------------------------------------------------
# analysis through the stand-in
# ---------------------------------------------------------------------------


def _strip_walls(rendered):
    """jsonv2's issues, sources and source list without discovery walls."""
    report = json.loads(rendered)[0]
    for issue in report["issues"]:
        issue["extra"].pop("discoveryTime", None)
    return {k: report[k] for k in ("issues", "sourceList", "sourceType",
                                   "sourceFormat")}


def _analyze_sol(side, target, tx_count):
    """``analyze TARGET -t N`` in this process, as the CLI builds it:
    (report, the loaded contracts)."""
    from test_torch_analyze import EXEC_TIMEOUT, _reset_jax

    if side == "jax":
        _reset_jax()
    else:
        mod("port", "mythril.mythril_analyzer").reset_analysis_state()
    disassembler = mod(side, "mythril").MythrilDisassembler()
    address, loaded = disassembler.load_from_solidity([target])
    extra = {"device": "cpu"} if side == "port" else {}
    analyzer = mod(side, "mythril").MythrilAnalyzer(
        disassembler=disassembler, strategy="bfs", address=address,
        max_depth=128, execution_timeout=EXEC_TIMEOUT, loop_bound=3,
        create_timeout=10, use_onchain_data=False, **extra)
    return analyzer.fire_lasers(transaction_count=tx_count), loaded


def _renders(report):
    return {"text": report.as_text(), "markdown": report.as_markdown(),
            "json": json.loads(report.as_json()),
            "jsonv2": _strip_walls(report.as_swc_standard_format())}


SMALL = [r for r in contracts.SOURCE_RUNS if r.small]


@pytest.mark.parametrize("run", SMALL, ids=[r.name for r in SMALL])
def test_sol_analysis_matches_jax_in_every_format(run, monkeypatch):
    """``analyze FILE:NAME`` in process on both sides: the reports equal in
    text, markdown, json and jsonv2 (``sourceList``, each ``sourceMap``);
    each finding's file, line and code the plain decoding of the
    fixture's map; the function names from the fixture's
    ``methodIdentifiers``; the SWC set of ``SOURCE_RUNS``."""
    from test_torch_analyze import analysis_pins, kept_deadlines

    got = {}
    with analysis_pins(monkeypatch), kept_deadlines():
        for side in SIDES:
            report, loaded = _analyze_sol(
                side, f"{run.file}:{run.contract}", run.transaction_count)
            assert not report.exceptions, report.exceptions
            got[side] = (_renders(report), sorted(
                (i.swc_id, i.address, i.function, i.filename, i.lineno,
                 i.code) for i in report.issues.values()))
    assert got["port"] == got["jax"]
    renders, issues = got["port"]
    assert {i[0] for i in issues} == run.swc_ids
    evm = contracts.solc_output(run.file)[1]["contracts"][run.file][
        run.contract]["evm"]
    assert {i[2] for i in issues} == run.functions
    assert run.functions <= set(evm["methodIdentifiers"])
    for swc, address, function, filename, lineno, code in issues:
        want = contracts.plain_source_info(run.file, run.contract, address)
        assert (filename, lineno, code) == want
    assert renders["jsonv2"]["sourceList"] == sorted(
        contracts.solc_output(run.file)[0])
    assert f"In file: {issues[0][3]}:{issues[0][4]}" in renders["text"]


def test_full_width_source_run_set_is_jax_s(monkeypatch):
    """``SCALE.sol:Scale -t 1`` (the scale contract at d6 g16 behind its
    creation code) on the JAX package: the SWC set ``SOURCE_RUNS``
    records for the chip check, each finding at a ``selfdestruct`` line
    of the fixture."""
    from test_torch_analyze import analysis_pins, kept_deadlines

    run = contracts.SOURCE_RUNS[0]
    assert not run.small and run.contract == "Scale"
    with analysis_pins(monkeypatch), kept_deadlines():
        report, _ = _analyze_sol("jax", f"{run.file}:{run.contract}",
                                 run.transaction_count)
    issues = list(report.issues.values())
    assert {i.swc_id for i in issues} == run.swc_ids
    assert {i.function for i in issues} == run.functions
    assert len(issues) == 4
    for issue in issues:
        assert (issue.filename, issue.lineno, issue.code) == (
            contracts.plain_source_info(run.file, run.contract,
                                        issue.address))
        assert issue.code == "selfdestruct(payable(msg.sender))"


def _cli(side, *args, cwd, env_extra=None):
    argv = ([sys.executable, os.path.join(ROOT, "myth")] if side == "jax"
            else [sys.executable, "-m", "mythril_tpu_torch"])
    env = dict(os.environ, JAX_PLATFORMS="cpu", MYTHRIL_TPU_PALLAS="force",
               XLA_FLAGS="", OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
               **(env_extra or {}))
    extra = ["--device", "cpu"] if side == "port" else []
    return subprocess.Popen(argv + list(args) + extra, cwd=cwd, env=env,
                            text=True, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_sol_cli_matches_jax_cli(standin):
    """``analyze KillBilly.sol -o jsonv2`` through both CLIs: the same
    issues; the JAX CLI's source list is ``[0]`` (its source read from
    stdin, which is empty here), the port's the file."""
    procs = {side: _cli(side, "analyze", "KillBilly.sol", "-t", "1", "-o",
                        "jsonv2", cwd=standin["src"]) for side in SIDES}
    out = {}
    for side, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (side, stderr[-2000:])
        out[side] = _strip_walls(stdout)
    assert out["port"]["issues"] == out["jax"]["issues"]
    assert [i["swcID"] for i in out["port"]["issues"]] == ["SWC-106"]
    assert out["jax"]["sourceList"] == [0]
    assert out["port"]["sourceList"] == ["KillBilly.sol"]


def _jax_main(monkeypatch, capsys, *argv):
    """The JAX CLI's ``main`` in this process: (exit code, stdout,
    stderr)."""
    monkeypatch.setattr(sys, "argv", ["myth", *argv])
    code = None
    try:
        mod("jax", "interfaces.cli").main()
    except SystemExit as done:
        code = done.code
    out = capsys.readouterr()
    return code, out.out, out.err


def _port_main(capsys, *argv):
    with pytest.raises(SystemExit) as done:
        mod("port", "interfaces.cli").main(list(argv))
    out = capsys.readouterr()
    return done.value.code, out.out, out.err


@pytest.mark.parametrize("target", ["SCALE.sol", "Token.sol:Token"])
def test_disassemble_sol_matches_jax(target, monkeypatch, capsys):
    """``disassemble FILE[:NAME]``: the first contract's runtime and
    creation listings, no card needed."""
    code, jax_out, _ = _jax_main(monkeypatch, capsys, "disassemble", target)
    port_code, port_out, err = _port_main(capsys, "disassemble", target)
    assert port_code == 0, err
    assert port_out == jax_out
    assert port_out.startswith("Runtime Disassembly: \n0 PUSH1 0x00\n")
    assert "Disassembly: \n0 PUSH1 0x80\n" in port_out


def test_sol_needs_the_card_before_it_compiles(standin, capsys):
    """``analyze X.sol`` on ``cuda`` without a card exits 2 before the
    compiler is asked."""
    before = len(contracts.standin_requests(standin["bin"]))
    code, out, err = _port_main(capsys, "analyze", "KillBilly.sol")
    assert code == 2 and "CUDA" in err and "--device cpu" in err
    assert len(contracts.standin_requests(standin["bin"])) == before


def test_solv_and_solc_json_through_the_cli(standin, monkeypatch, capsys):
    """``analyze SCALE.sol:Helper --solv V --solc-json S -q`` runs through
    ``solc-V`` with the settings on its stdin and names the function
    ``retire()``."""
    settings = '{"optimizer": {"enabled": true, "runs": 3}}'
    before = len(contracts.standin_requests(standin["bin"]))
    code, out, err = _port_main(
        capsys, "analyze", "SCALE.sol:Helper", "--solv",
        contracts.SOLC_VERSION, "--solc-json", settings, "-q", "-t", "1",
        "--device", "cpu", "--no-onchain-data", "-o", "json")
    assert code == 0, err
    requests = contracts.standin_requests(standin["bin"])[before:]
    assert [r["binary"] for r in requests] == [
        f"solc-{contracts.SOLC_VERSION}"]
    assert requests[0]["input"]["settings"]["optimizer"] == {
        "enabled": True, "runs": 3}
    issues = json.loads(out)["issues"]
    assert [(i["swc-id"], i["function"], i["filename"], i["code"])
            for i in issues] == [
        ("106", contracts.HELPER_SIGNATURE, "SCALE.sol",
         "selfdestruct(payable(msg.sender))")]


# ---------------------------------------------------------------------------
# truffle
# ---------------------------------------------------------------------------


def test_truffle_matches_jax_cli(tmp_path):
    """``truffle`` in a project with killbilly, ``erc20_transfer``, an
    interface and a file that is not JSON: the same issues on both CLIs,
    the SWC sets of ``TRUFFLE_SWC`` by contract name."""
    names = contracts.write_truffle_project(str(tmp_path))
    assert names == sorted(contracts.TRUFFLE_SWC)
    procs = {side: _cli(side, "truffle", "-t",
                        str(contracts.TRUFFLE_TX_COUNT), "-o", "json",
                        cwd=str(tmp_path)) for side in SIDES}
    out = {}
    for side, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (side, stderr[-2000:])
        out[side] = json.loads(stdout)
    assert out["port"] == out["jax"]
    found = {}
    for issue in out["port"]["issues"]:
        found.setdefault(issue["contract"], set()).add(issue["swc-id"])
    assert found == contracts.TRUFFLE_SWC


def test_truffle_without_a_build_directory_matches_jax(tmp_path, monkeypatch,
                                                       capsys, caplog):
    """No ``build/contracts``: the JAX CLI's message (which it logs), exit 1
    from the port's CLI."""
    monkeypatch.chdir(tmp_path)
    _jax_main(monkeypatch, capsys, "truffle")
    port_code, out, port_err = _port_main(capsys, "truffle", "--device",
                                          "cpu")
    assert "No build/contracts directory here" in port_err
    assert port_err.strip() in caplog.text
    assert port_code == 1 and out == ""


def test_truffle_checks_the_card_before_any_analysis(tmp_path, monkeypatch,
                                                     capsys):
    contracts.write_truffle_project(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    code, out, err = _port_main(capsys, "truffle")
    assert code == 2 and "CUDA" in err and out == ""


# ---------------------------------------------------------------------------
# the whole CLI
# ---------------------------------------------------------------------------


def _options(parser):
    """{subcommand: its option strings and positionals}."""
    import argparse

    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out[name] = {o for a in sub._actions
                             for o in (a.option_strings or [a.dest])}
    return out


def test_the_port_cli_takes_every_jax_option(monkeypatch):
    """Every subcommand of the JAX CLI, with every option and positional
    it takes, is the port's too; the port adds only ``--device`` to the
    commands that run on the card (and ``-v`` to ``worker``)."""
    import argparse

    class Built(Exception):
        pass

    def capture(self, *args, **kwargs):
        raise Built(self)

    with monkeypatch.context() as patched, pytest.raises(Built) as built:
        patched.setattr(sys, "argv", ["myth", "version"])
        patched.setattr(argparse.ArgumentParser, "parse_args", capture)
        mod("jax", "interfaces.cli").main()
    jax = _options(built.value.args[0])
    port = _options(mod("port", "interfaces.cli").build_parser())
    assert set(port) == set(jax)
    for name, options in jax.items():
        assert options <= port[name], (name, options - port[name])
        extra = port[name] - options
        assert extra <= {"--device", "-v"}, (name, extra)
    for name in ("analyze", "truffle", "serve", "watch"):
        assert "--device" in port[name]
    for name in ("pro", "leveldb-search", "hash-to-address", "disassemble"):
        assert "--device" not in port[name]
