"""The port's ``mythx`` module and ``pro`` command held against the JAX
package's: the submission payload, the login -> submit -> poll -> issues
flow and the Report it converts, through ``tests/test_mythx.py``'s fake
transport and through ``contracts.serve_analysis_api`` on the loopback
interface.
"""

import importlib
import json
import os
import subprocess
import sys
import threading

import pytest

from mythril_tpu_torch import contracts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}
both = pytest.mark.parametrize("side", sorted(SIDES))


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


class FakeTransport:
    """``tests/test_mythx.py``'s transport: login, one analysis, ``polls``
    statuses before it is finished."""

    def __init__(self, issues, queued=0, status="Finished"):
        self.token = None
        self.requests = []
        self.issues = issues
        self.queued = queued
        self.status = status

    def post(self, path, payload):
        self.requests.append(("POST", path, payload))
        if path == "/v1/auth/login":
            return {"jwt": {"access": "tok"}}
        if path == "/v1/analyses":
            return {"uuid": "abc-123"}
        raise AssertionError(path)

    def get(self, path):
        self.requests.append(("GET", path, None))
        if path == "/v1/analyses/abc-123":
            if self.queued:
                self.queued -= 1
                return {"status": "Queued"}
            return {"status": self.status}
        if path == "/v1/analyses/abc-123/issues":
            return self.issues
        raise AssertionError(path)


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "home" / ".mythril_tpu"))
    monkeypatch.delenv("MYTHX_API_URL", raising=False)
    for side in SIDES:
        monkeypatch.setattr(mod(side, "mythx").time, "sleep", lambda s: None)


def _report_view(report):
    return json.loads(report.as_json()), report.as_text()


def _contract(side, **kwargs):
    return mod(side, "solidity.evmcontract").EVMContract(**kwargs)


@pytest.mark.parametrize("kwargs", [
    {"code": "0x6001600101", "name": "MAIN"},
    {"code": "0x6001", "creation_code": "0x6002", "name": "Tok"},
    {"creation_code": "0x6002"}], ids=["runtime", "both", "creation"])
def test_payload_matches_jax(kwargs):
    got = {side: contracts_payload(side, kwargs) for side in SIDES}
    assert got["port"] == got["jax"]
    assert got["port"]["analysisMode"] == "quick"


def contracts_payload(side, kwargs):
    return mod(side, "mythx").build_request_payload(_contract(side, **kwargs))


def test_solidity_payload_sends_the_source_text(tmp_path, monkeypatch):
    """A Solidity contract's payload: the port sends each file's text
    where the JAX package puts its bytes (which its transport cannot
    serialize); the rest is the JAX package's."""
    bin_dir = contracts.write_solc_standin(str(tmp_path / "bin"))
    monkeypatch.setenv("PATH", bin_dir + os.pathsep + os.environ["PATH"])
    monkeypatch.chdir(tmp_path)
    contracts.write_sources(str(tmp_path), "SCALE.sol")
    _, output = contracts.solc_output("SCALE.sol")
    contract = mod("port", "solidity.soliditycontract").SolidityContract(
        "SCALE.sol", name="Helper", solc_data=output)
    payloads = {side: mod(side, "mythx").build_request_payload(contract)
                for side in SIDES}
    jax, port = payloads["jax"], payloads["port"]
    texts = contracts.solc_output("SCALE.sol")[0]
    assert port["sources"]["SCALE.sol"]["source"] == texts["SCALE.sol"]
    assert jax["sources"]["SCALE.sol"]["source"] == texts["SCALE.sol"].encode()
    with pytest.raises(TypeError, match="bytes is not JSON serializable"):
        mod("jax", "mythx")._Transport("http://127.0.0.1:9").post(
            "/v1/analyses", jax)
    json.dumps(port)
    for name in jax["sources"]:
        jax["sources"][name]["source"] = jax["sources"][name][
            "source"].decode()
    assert port == jax
    assert port["sourceList"] == ["SCALE.sol", "ScaleBase.sol"]
    assert port["mainSource"] == "SCALE.sol"
    assert port["sources"]["SCALE.sol"]["ast"]["nodeType"] == "SourceUnit"


@pytest.mark.parametrize("queued", [0, 2], ids=["finished", "queued-twice"])
def test_fake_transport_flow_and_report_match_jax(queued):
    """Login, then one submission, status polls until ``Finished``, the
    issues; the same requests and the same Report on both sides."""
    got = {}
    for side in SIDES:
        transport = FakeTransport(contracts.PRO_ISSUES, queued=queued)
        report = mod(side, "mythx").analyze(
            [_contract(side, code="0x6001600101", name="MAIN")],
            transport=transport)
        got[side] = (_report_view(report), transport.requests,
                     transport.token)
    assert got["port"] == got["jax"]
    (view, _text), requests, token = got["port"]
    assert token == "tok" and requests[0][1] == "/v1/auth/login"
    polls = [r for r in requests if r[1] == "/v1/analyses/abc-123"]
    assert len(polls) == queued + 1


def test_conversion_is_the_jax_conversion():
    """``PRO_EXPECTED`` (what the chip check holds the port's ``pro``
    against) is the JAX package's conversion of ``PRO_ISSUES``."""
    response = json.loads(json.dumps(contracts.PRO_ISSUES))
    for issue in response[0]["issues"]:
        issue["contract"] = "MAIN"
    got = {}
    for side in SIDES:
        got[side] = [(i.swc_id, i.address, i.severity, i.title,
                      i.function, i.description_head, i.contract)
                     for i in mod(side, "mythx").issues_from_response(
                         response, bytecode="0x6001")]
    assert got["port"] == got["jax"]
    assert [g[:6] for g in got["port"]] == contracts.PRO_EXPECTED


@pytest.mark.parametrize("status", ["Error", "Queued"])
def test_failed_and_stuck_analyses_raise_alike(status, monkeypatch):
    """An analysis in ``Error``, or still queued at the poll deadline
    (``MYTHX_POLL_TIMEOUT``), raises ``MythXApiError`` on both sides."""
    monkeypatch.setenv("MYTHX_POLL_TIMEOUT", "0")
    for side in SIDES:
        transport = FakeTransport([], queued=10**6 if status == "Queued"
                                  else 0, status=status)
        with pytest.raises(mod(side, "mythx").MythXApiError,
                           match="failed" if status == "Error"
                           else "poll deadline"):
            mod(side, "mythx").analyze(
                [_contract(side, code="0x6001")], transport=transport)


@both
def test_without_an_endpoint_analyze_raises(side):
    assert mod(side, "mythx").api_url() is None
    with pytest.raises(mod(side, "mythx").MythXApiError,
                       match="MYTHX_API_URL"):
        mod(side, "mythx").analyze([_contract(side, code="0x6001")])


@pytest.fixture
def api():
    server = contracts.serve_analysis_api()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(10)


def test_loopback_api_report_matches_jax(api, monkeypatch):
    """Both packages' ``analyze`` over HTTP against the stand-in API: the
    same submissions and Report; a request without the token is
    refused."""
    server, url = api
    monkeypatch.setenv("MYTHX_API_URL", url)
    got = {}
    for side in SIDES:
        before = len(server.submissions)
        report = mod(side, "mythx").analyze([_contract(
            side, code=contracts.killbilly(), name="KillBilly")])
        got[side] = (_report_view(report), server.submissions[before:])
    assert got["port"] == got["jax"]
    issues = got["port"][0][0]["issues"]
    assert sorted((i["swc-id"], i["address"], i["contract"])
                  for i in issues) == [("101", 0, "KillBilly"),
                                       ("106", 24, "KillBilly")]
    transport = mod("port", "mythx")._Transport(url)
    with pytest.raises(mod("port", "mythx").MythXApiError, match="401"):
        transport.post("/v1/analyses", {})


def _pro(*args, env_extra=None, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MYTHX_API_URL", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "mythril_tpu_torch", "pro",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300, stdin=subprocess.DEVNULL)


def test_pro_cli_against_the_loopback_api(api, tmp_path):
    """``pro -f CODE --bin-runtime -o json`` and ``pro X.sol -o text`` as
    the port's processes: the converted issues, and the Solidity
    contract's sources submitted as text."""
    server, url = api
    hexfile = tmp_path / "killbilly.hex"
    hexfile.write_text(contracts.killbilly())
    done = _pro("-f", str(hexfile), "--bin-runtime", "-o", "json",
                env_extra={"MYTHX_API_URL": url})
    assert done.returncode == 0, done.stderr[-2000:]
    issues = json.loads(done.stdout)["issues"]
    assert sorted((i["swc-id"], i["address"], i["severity"], i["title"],
                   i["function"], i["description"].split("\n")[0])
                  for i in issues) == sorted(contracts.PRO_EXPECTED)
    bin_dir = contracts.write_solc_standin(str(tmp_path / "bin"))
    contracts.write_sources(str(tmp_path), "KillBilly.sol")
    done = _pro("KillBilly.sol", env_extra={
        "MYTHX_API_URL": url, "HOME": str(tmp_path / "home"),
        "PATH": bin_dir + os.pathsep + os.environ["PATH"]}, cwd=str(tmp_path))
    assert done.returncode == 0, done.stderr[-2000:]
    assert "Contract: KillBilly" in done.stdout
    submitted = server.submissions[-1]
    assert submitted["contractName"] == "KillBilly"
    assert submitted["sources"]["KillBilly.sol"]["source"] == (
        contracts.solc_output("KillBilly.sol")[0]["KillBilly.sol"])


def test_pro_without_an_endpoint_exits_with_the_jax_message(monkeypatch,
                                                            capsys, caplog):
    """No ``MYTHX_API_URL``: the JAX CLI's message before any loading
    (which the JAX CLI logs), exit 1 from the port's."""
    done = _pro("-c", "0x6001")
    assert done.returncode == 1 and done.stdout == ""
    assert "set MYTHX_API_URL to use it" in done.stderr
    monkeypatch.setattr(sys, "argv", ["myth", "pro", "-c", "0x6001"])
    with pytest.raises(SystemExit):
        mod("jax", "interfaces.cli").main()
    assert done.stderr.strip() in caplog.text
