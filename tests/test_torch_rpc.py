"""The port's RPC client, provider pool, triage, on-chain loader and
``-a`` / ``read-storage`` / ``function-to-hash`` against the JAX
package's, on the CPU.

The cases of ``tests/test_rpc.py`` and the triage, loader and pool cases
of ``tests/test_wild_bytecode.py`` run on both packages (``side``), with
the same mocked ``urllib`` transport and the same scripted providers:
request shapes and ids, TLS URLs, error mapping, retries, the ``rpc_*``
fault points, breakers, rate limits, the on-disk code cache, spec and
knob parsing, the validators, proxy chains and the typed loader errors.
Parity cases hold the two packages' outputs equal: triage of every
vendored mainnet fixture (bytes and report dicts), a seeded mutation
fuzz (outcome types), and the counters a pool leaves.

End to end, the chain of ``mythril_tpu_torch/contracts.py`` is served on
the loopback interface (``serve_chain``), and the port's CLI is held
against the JAX package's ``myth`` on the small ``ONCHAIN_RUNS``: the
same issues, the same ``read-storage`` and ``function-to-hash`` output.
The full-width run's JAX SWC set is taken here too, JAX side only (the
port's plain CPU tiers take minutes on it; the chip check runs it on the
card).  The on-chain default: without ``--no-onchain-data`` both
packages build an active loader with no client (``config.ini`` names
Infura, ``INFURA_ID`` is unset), so the target's storage is concrete
and a CALL to a constant address makes a fresh account; the parent of
this port built the loader inactive and found SWC-106 on
``call_constant``, which the JAX package does not.
"""

import argparse
import email.message
import importlib
import io
import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.error
from contextlib import contextmanager
from unittest import mock

import pytest

from mythril_tpu_torch import contracts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "mainnet")
SIDES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}

BZZR_TAIL = bytes.fromhex("a165627a7a72305820" + "8d" * 32 + "0029")
IPFS_TAIL = bytes.fromhex(
    "a2646970667358221220" + "4e" * 32 + "64736f6c6343000812" + "0033")
PROXY = bytes.fromhex(
    "363d3d373d3d3d363d73" + "ab" * 20 + "5af43d82803e903d91602b57fd5bf3")


def mod(side, path):
    return importlib.import_module(f"{SIDES[side]}.{path}")


def client_mod(side):
    return mod(side, "ethereum.interface.rpc.client")


def stats(side):
    return mod(side, "resilience.telemetry").resilience_stats


def faults(side):
    return mod(side, "resilience.faults")


@pytest.fixture(autouse=True)
def _clean_planes(monkeypatch):
    """Fast client backoff and fresh fault planes and counters on both
    packages around every case."""
    for side in SIDES:
        monkeypatch.setattr(client_mod(side), "RPC_BACKOFF_BASE_S", 0.001)
        faults(side).reset_for_tests()
        stats(side).reset()
    yield
    for side in SIDES:
        faults(side).reset_for_tests()
        stats(side).reset()


both = pytest.mark.parametrize("side", sorted(SIDES))


# ---------------------------------------------------------------------------
# the mocked transport (tests/test_rpc.py's)
# ---------------------------------------------------------------------------


class _Response(io.BytesIO):
    status = 200

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@contextmanager
def _transport(result=None, raw=None, error=None):
    """Mock urlopen; captures the request for assertions."""
    captured = {}

    def fake_urlopen(request, timeout=None):
        captured["url"] = request.full_url
        captured["payload"] = json.loads(request.data)
        captured["content_type"] = request.headers.get("Content-type")
        if raw is not None:
            return _Response(raw)
        if error is not None:
            return _Response(json.dumps({"error": error}).encode())
        return _Response(json.dumps(
            {"jsonrpc": "2.0", "id": 1, "result": result}).encode())

    with mock.patch("urllib.request.urlopen", side_effect=fake_urlopen):
        yield captured


# ---------------------------------------------------------------------------
# the client (tests/test_rpc.py)
# ---------------------------------------------------------------------------


@both
def test_get_code_request_shape_and_result(side):
    client = client_mod(side).EthJsonRpc(host="node.example", port=8545)
    with _transport(result="0x6001") as captured:
        code = client.eth_getCode("0x" + "11" * 20)
    assert code == "0x6001"
    assert captured["url"] == "http://node.example:8545"
    assert captured["content_type"] == "application/json"
    body = captured["payload"]
    assert body["method"] == "eth_getCode"
    assert body["params"] == ["0x" + "11" * 20, "latest"]
    assert body["jsonrpc"] == "2.0"


@both
def test_get_balance_and_storage_encodings(side):
    client = client_mod(side).EthJsonRpc()
    with _transport(result="0xde0b6b3a7640000"):
        assert client.eth_getBalance("0x" + "22" * 20) == 10**18
    with _transport(result="0x" + "00" * 32) as captured:
        client.eth_getStorageAt("0x" + "33" * 20, position=5)
    assert captured["payload"]["params"][1] == "0x5"


@both
def test_tls_and_prefixed_host_url_forms(side):
    rpc = client_mod(side).EthJsonRpc
    assert rpc(host="n", port=443, tls=True).url == "https://n:443"
    assert rpc(host="https://infura.example/v3/key",
               port=None).url == "https://infura.example/v3/key"


@both
def test_error_paths_surface_as_client_errors(side):
    c = client_mod(side)
    client = c.EthJsonRpc()
    with _transport(raw=b"not json"):
        with pytest.raises(c.BadJsonError):
            client.eth_getCode("0x" + "44" * 20)
    with _transport(error={"code": -32000, "message": "nope"}):
        with pytest.raises(c.BadResponseError):
            client.eth_getCode("0x" + "44" * 20)
    with mock.patch("urllib.request.urlopen",
                    side_effect=OSError("refused")):
        with pytest.raises(c.ConnectionError_):
            client.eth_getCode("0x" + "44" * 20)
    with mock.patch("urllib.request.urlopen",
                    side_effect=urllib.error.HTTPError(
                        "http://n", 500, "boom", None, None)):
        with pytest.raises(c.BadStatusCodeError):
            client.eth_getCode("0x" + "44" * 20)
    assert issubclass(c.ConnectionError_, c.ClientError)


@both
def test_request_ids_increment(side):
    client = client_mod(side).EthJsonRpc()
    ids = []
    for _ in range(3):
        with _transport(result="0x0") as captured:
            client.eth_getCode("0x" + "55" * 20)
        ids.append(captured["payload"]["id"])
    assert ids == [1, 2, 3]


@both
def test_transient_oserror_is_retried_to_success(side):
    client = client_mod(side).EthJsonRpc()
    calls = {"n": 0}
    good = json.dumps({"jsonrpc": "2.0", "id": 1,
                       "result": "0x6001"}).encode()

    def flaky_urlopen(request, timeout=None):
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("connection reset by peer")
        return _Response(good)

    with mock.patch("urllib.request.urlopen", side_effect=flaky_urlopen):
        assert client.eth_getCode("0x" + "66" * 20) == "0x6001"
    assert calls["n"] == 3
    assert stats(side).rpc_retries == 2


@both
def test_persistent_5xx_exhausts_and_4xx_fails_at_once(side):
    c = client_mod(side)
    calls = {"n": 0}

    def failing(code):
        def urlopen(request, timeout=None):
            calls["n"] += 1
            raise urllib.error.HTTPError("http://n", code, "x", None, None)
        return urlopen

    with mock.patch("urllib.request.urlopen", side_effect=failing(500)):
        with pytest.raises(c.BadStatusCodeError):
            c.EthJsonRpc().eth_getCode("0x" + "66" * 20)
    assert calls["n"] == c.RPC_MAX_ATTEMPTS
    calls["n"] = 0
    with mock.patch("urllib.request.urlopen", side_effect=failing(404)):
        with pytest.raises(c.BadStatusCodeError):
            c.EthJsonRpc().eth_getCode("0x" + "66" * 20)
    assert calls["n"] == 1, "4xx is not transient"


@both
def test_fault_plane_injects_transient_failures_without_a_network(side):
    plane = faults(side).get_fault_plane()
    plane.arm("rpc_error", times=1)
    client = client_mod(side).EthJsonRpc()
    with _transport(result="0xabc") as captured:
        assert client.eth_getCode("0x" + "77" * 20) == "0xabc"
    assert captured["payload"]["method"] == "eth_getCode"
    assert stats(side).rpc_retries == 1
    plane.arm("rpc_http_500", times=1)
    with _transport(result="0xdef"):
        assert client.eth_getCode("0x" + "77" * 20) == "0xdef"
    assert stats(side).rpc_retries == 2
    assert stats(side).faults_fired == 2


@both
def test_block_number_and_block_by_number(side):
    c = client_mod(side)
    client = c.EthJsonRpc()
    with _transport(result="0x10") as captured:
        assert client.eth_blockNumber() == 16
    assert captured["payload"]["method"] == "eth_blockNumber"
    with _transport(result={"not": "hex"}):
        with pytest.raises(c.BadResponseError):
            client.eth_blockNumber()
    block = {"number": "0x2", "hash": "0x" + "aa" * 32,
             "parentHash": "0x" + "bb" * 32, "transactions": []}
    with _transport(result=block) as captured:
        assert client.eth_getBlockByNumber(2, False) == block
    assert captured["payload"]["params"] == ["0x2", False]
    with _transport(result=block) as captured:
        client.eth_getBlockByNumber("latest")
    assert captured["payload"]["params"] == ["latest", True]


@both
def test_block_and_receipt_validators_shape_check(side):
    c = client_mod(side)
    assert c.validate_block_result(None) is None
    assert c.validate_receipt_result(None) is None
    good = {"number": "0x1", "hash": "0x" + "cc" * 32,
            "parentHash": "0x" + "dd" * 32, "transactions": ["0xe1"]}
    assert c.validate_block_result(good) is good
    for broken in ("0xdeadbeef", {**good, "number": "latest"},
                   {**good, "parentHash": None},
                   {**good, "transactions": "0xe1"}):
        with pytest.raises(c.BadResponseError):
            c.validate_block_result(broken)
    receipt = {"contractAddress": "0x" + "11" * 20, "status": "0x1"}
    assert c.validate_receipt_result(receipt) is receipt
    assert c.validate_receipt_result(
        {"contractAddress": None})["contractAddress"] is None
    for broken in (["not", "a", "receipt"], {"contractAddress": "garbage"}):
        with pytest.raises(c.BadResponseError):
            c.validate_receipt_result(broken)


@both
def test_hex_result_validation(side):
    c = client_mod(side)
    c.validate_hex_result("0x6001", byte_aligned=True)
    for bad in (None, 42, "6001", "0xzz", []):
        with pytest.raises(c.BadResponseError):
            c.validate_hex_result(bad)
    with pytest.raises(c.BadResponseError):
        c.validate_hex_result("0x600", "code", byte_aligned=True)


def test_validators_agree_on_a_table_of_results():
    """Each validator's verdict (the value, or the error's type and
    message) on one table of inputs, equal on both packages."""
    table = [None, 7, "0x", "0x0", "0x600", "0x6001", "0xZZ", "6001",
             {"number": "0x1", "hash": "0x1", "parentHash": "0x2",
              "transactions": []},
             {"number": "0x1", "hash": "0x1", "parentHash": "0x2"},
             {"contractAddress": "0x" + "ab" * 20},
             {"contractAddress": 5}]

    def verdicts(side):
        c = client_mod(side)
        out = []
        for fn in (lambda v: c.validate_hex_result(v),
                   lambda v: c.validate_hex_result(v, byte_aligned=True),
                   c.validate_block_result, c.validate_receipt_result):
            for value in table:
                try:
                    out.append(("ok", repr(fn(value))))
                except c.ClientError as exc:
                    out.append((type(exc).__name__, str(exc)))
        return out

    assert verdicts("port") == verdicts("jax")


# ---------------------------------------------------------------------------
# triage (tests/test_wild_bytecode.py)
# ---------------------------------------------------------------------------


def triage_mod(side):
    return mod(side, "disassembler.triage")


@both
def test_normalize_hex_repairs_and_rejects(side):
    t = triage_mod(side)
    assert t.normalize_hex("0x6001") == b"\x60\x01"
    assert t.normalize_hex("0X6001") == b"\x60\x01"
    assert t.normalize_hex("  60\n01\t") == b"\x60\x01"
    assert t.normalize_hex("60015") == b"\x60\x01"
    with pytest.raises(mod(side, "exceptions").BytecodeInputError) as info:
        t.normalize_hex("0xzzzz")
    assert json.loads(info.value.to_line())["error"] == "bad_bytecode"


@both
def test_bzzr_and_ipfs_tails_strip_and_round_trip(side):
    t = triage_mod(side)
    body = bytes.fromhex("6001600101")
    for tail in (BZZR_TAIL, IPFS_TAIL):
        blob = body + tail
        assert t.metadata_tail_length(blob) == len(tail)
        code, report = t.triage(blob)
        assert code == body
        assert report.metadata_tail_len == len(tail)
        assert report.repaired
        assert report.input_len == len(blob)
        assert report.code_len + report.metadata_tail_len == len(blob)


@both
def test_malformed_and_tail_only_inputs(side):
    t = triage_mod(side)
    fake = bytes.fromhex("6001600101a165627a7a72" + "00" * 32 + "0029")
    assert t.metadata_tail_length(fake) == 0
    code, report = t.triage(fake)
    assert code == fake and report.metadata_tail_len == 0
    code, report = t.triage(BZZR_TAIL)
    assert code == b"" and report.metadata_tail_len == len(BZZR_TAIL)


@both
def test_invalid_opcodes_truncated_push_and_size_cap(side, monkeypatch):
    t = triage_mod(side)
    blob = bytes.fromhex("6001" + "212223242c2d2e2f" + "00")
    code, report = t.triage(blob)
    assert code == blob and report.invalid_ops == 8
    names = [i.op_code for i in mod(side, "disassembler.asm").disassemble(
        bytes.fromhex("60012100"))]
    assert names == ["PUSH1", "INVALID", "STOP"]
    _, report = t.triage(bytes.fromhex("6001" + "7f" + "aa" * 7))
    assert report.push_truncated
    monkeypatch.setenv("MYTHRIL_TPU_TRIAGE_MAX_CODE", "64")
    code, report = t.triage(b"\x5b" * 200)
    assert len(code) == 64 and report.truncated_to == 64
    assert report.repaired
    assert report.as_dict()["notes"]


@both
def test_eip1167_fingerprint_exact_and_near_miss(side):
    t = triage_mod(side)
    assert t.eip1167_target(PROXY) == "0x" + "ab" * 20
    _, report = t.triage(PROXY)
    assert report.proxy_target == "0x" + "ab" * 20
    assert t.eip1167_target(PROXY + b"\x00") is None
    assert t.eip1167_target(PROXY[:-1]) is None
    mangled = bytearray(PROXY)
    mangled[0] ^= 0xFF
    assert t.eip1167_target(bytes(mangled)) is None
    # a factory clone with a metadata tail is still the trampoline
    _, report = t.triage(PROXY + BZZR_TAIL)
    assert report.proxy_target == "0x" + "ab" * 20


def _fixtures():
    return [(fn, open(os.path.join(FIXTURE_DIR, fn)).read().strip())
            for fn in sorted(os.listdir(FIXTURE_DIR)) if fn.endswith(".hex")]


def test_every_fixture_triages_alike():
    """Every vendored mainnet fixture: equal bytes and report dicts, and
    the port's disassembly of the clean bytes takes them."""
    from mythril_tpu_torch.disassembler.disassembly import Disassembly

    fixtures = _fixtures()
    assert len(fixtures) >= 20
    for name, code in fixtures:
        want = triage_mod("jax").triage(code)
        got = triage_mod("port").triage(code)
        assert got[0] == want[0], name
        assert got[1].as_dict() == want[1].as_dict(), name
        assert got[1].repaired == want[1].repaired, name
        Disassembly("0x" + got[0].hex())


def test_mutation_fuzz_outcomes_agree():
    """200 seeded mutations of the fixtures (``scripts/corpus_sweep.py``'s)
    through each package's triage and disassembly: the same outcome (the
    bytes and report, or the typed rejection) on both."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import corpus_sweep

    rng = random.Random(1167)
    base = _fixtures()

    def outcome(side, mutated):
        try:
            clean, report = triage_mod(side).triage(mutated)
            mod(side, "disassembler.disassembly").Disassembly(
                "0x" + clean.hex())
            return ("ok", clean, report.as_dict())
        except mod(side, "exceptions").BytecodeInputError as exc:
            return ("BytecodeInputError", str(exc))

    for _ in range(200):
        _name, code = base[rng.randrange(len(base))]
        mutated = rng.choice(corpus_sweep.MUTATIONS)(rng, code)
        assert outcome("port", mutated) == outcome("jax", mutated)


# ---------------------------------------------------------------------------
# the loader (tests/test_wild_bytecode.py)
# ---------------------------------------------------------------------------


class _FakeEth:
    """eth_getCode from a dict; counts calls."""

    def __init__(self, codes):
        self.codes = codes
        self.calls = []

    def eth_getCode(self, address, default_block="latest"):
        self.calls.append(address)
        return self.codes.get(address.lower(), "0x")


def loader(side):
    return mod(side, "support.loader").DynLoader


@both
def test_dynloader_resolves_proxy_chain_to_implementation(side):
    impl = "0x" + "ab" * 20
    eth = _FakeEth({"0x" + "11" * 20: "0x" + PROXY.hex(),
                    impl: "0x6001600101"})
    assert loader(side)(eth).fetch_code("0x" + "11" * 20) == bytes.fromhex(
        "6001600101")
    assert eth.calls == ["0x" + "11" * 20, impl]


@both
def test_dynloader_bounds_cyclic_proxy_chains(side, monkeypatch):
    monkeypatch.setenv("MYTHRIL_TPU_PROXY_DEPTH", "2")
    eth = _FakeEth({"0x" + "ab" * 20: "0x" + PROXY.hex()})
    assert loader(side)(eth).fetch_code("0x" + "ab" * 20) == PROXY
    assert len(eth.calls) == 3  # 1 + 2 hops


@both
def test_dynloader_rpc_death_mid_chain_degrades_to_last_code(side):
    class _DyingEth:
        def __init__(self):
            self.calls = 0

        def eth_getCode(self, address, default_block="latest"):
            self.calls += 1
            if self.calls > 1:
                raise OSError("provider died")
            return "0x" + PROXY.hex()

    assert loader(side)(_DyingEth()).fetch_code("0x" + "11" * 20) == PROXY


@both
def test_dynloader_inactive_or_without_client_raises_value_error(side):
    for dyn in (loader(side)(None, active=True),
                loader(side)(_FakeEth({}), active=False)):
        for call in (lambda: dyn.read_storage("0x" + "11" * 20, 0),
                     lambda: dyn.read_balance("0x" + "11" * 20),
                     lambda: dyn.dynld("0x" + "11" * 20)):
            with pytest.raises(ValueError):
                call()


@both
def test_dynloader_degrades_rpc_failures_to_value_error(side):
    class _DeadEth:
        def eth_getStorageAt(self, *a, **k):
            raise OSError("down")

        def eth_getBalance(self, *a, **k):
            raise client_mod(side).ConnectionError_("down")

    dyn = loader(side)(_DeadEth())
    with pytest.raises(ValueError, match="storage read failed"):
        dyn.read_storage("0x" + "11" * 20, 3)
    with pytest.raises(ValueError, match="balance read failed"):
        dyn.read_balance("0x" + "11" * 20)


def disassembler(side):
    return mod(side, "mythril.mythril_disassembler").MythrilDisassembler


@both
def test_address_shape_and_checksum_validation(side):
    check = disassembler(side).check_address
    bad_address = mod(side, "exceptions").BadAddressError
    assert check("0x" + "ab" * 20)
    assert check("0x" + "AB" * 20)
    assert check("0xd8dA6BF26964aF9D7eEd9e03E53415D37aA96045")
    with pytest.raises(bad_address):
        check("0xD8dA6BF26964aF9D7eEd9e03E53415D37aA96045")
    for bad in ("0xdeadbeef", "abc", "", None, "0x" + "zz" * 20):
        with pytest.raises(bad_address):
            check(bad)


def test_check_address_messages_agree():
    for address in ("0xD8dA6BF26964aF9D7eEd9e03E53415D37aA96045",
                    "0xdeadbeef", None):
        errors = []
        for side in ("jax", "port"):
            with pytest.raises(mod(side, "exceptions").BadAddressError) as e:
                disassembler(side).check_address(address)
            errors.append(e.value.to_line())
        assert errors[0] == errors[1]


@both
def test_load_from_address_empty_code_is_typed(side):
    with pytest.raises(mod(side, "exceptions").EmptyCodeError) as info:
        disassembler(side)(eth=_FakeEth({})).load_from_address(
            "0x" + "11" * 20)
    assert json.loads(info.value.to_line())["error"] == "empty_code"
    with pytest.raises(mod(side, "exceptions").CriticalError):
        disassembler(side)(eth=None).load_from_address("0x" + "11" * 20)


@both
def test_load_from_address_triages_and_resolves_proxy(side):
    impl = "0x" + "ab" * 20
    eth = _FakeEth({"0x" + "11" * 20: "0x" + (PROXY + BZZR_TAIL).hex(),
                    impl: "0x6001600101" + BZZR_TAIL.hex()})
    _, contract = disassembler(side)(eth=eth).load_from_address(
        "0x" + "11" * 20)
    assert contract.triage["metadata_tail_len"] == len(BZZR_TAIL)
    assert contract.triage["proxy_target"] == impl
    assert contract.name == f"0x{'11' * 20} -> {impl}"
    assert contract.disassembly.raw_bytecode == bytes.fromhex("6001600101")


@both
def test_loader_errors_are_critical_but_carry_codes(side):
    e = mod(side, "exceptions")
    assert issubclass(e.LoaderError, e.CriticalError)
    assert not issubclass(e.AddressNotFoundError, e.CriticalError)
    for cls, code in ((e.BadAddressError, "bad_address"),
                      (e.EmptyCodeError, "empty_code"),
                      (e.BytecodeInputError, "bad_bytecode"),
                      (e.ProviderExhaustedError, "provider_exhausted")):
        assert json.loads(cls("detail").to_line()) == {
            "detail": "detail", "error": code}
        assert cls.code == code


@both
def test_load_from_bytecode_repairs_odd_nibble(side):
    _, contract = disassembler(side)(eth=None).load_from_bytecode(
        "0x6001600101a", bin_runtime=True)
    assert contract.disassembly.raw_bytecode == bytes.fromhex("6001600101")


@both
def test_state_variable_reads_slots_counts_and_mappings(side):
    class _StorageEth:
        def __init__(self):
            self.slots = []

        def eth_getStorageAt(self, address, position, block="latest"):
            self.slots.append(position)
            return "0x" + format(position % 7, "064x")

    eth = _StorageEth()
    dis = disassembler(side)(eth=eth)
    out = [dis.get_state_variable_from_storage("0x" + "11" * 20, params)
           for params in (["3"], ["0", "2"], ["mapping", "1", "k1", "k2"])]
    assert out[0] == "0x3: 0x" + format(3, "064x")
    assert len(out[1].splitlines()) == 2
    assert len(out[2].splitlines()) == 2
    critical = mod(side, "exceptions").CriticalError
    with pytest.raises(critical):
        dis.get_state_variable_from_storage("0x" + "11" * 20, ["x"])
    with pytest.raises(critical):
        disassembler(side)(eth=None).get_state_variable_from_storage(
            "0x" + "11" * 20, ["0"])


def test_state_variable_reads_agree():
    class _StorageEth:
        def eth_getStorageAt(self, address, position, block="latest"):
            return "0x" + format(position % 977, "064x")

    for params in (["3"], ["0", "4"], ["mapping", "1", "alice", "bob"]):
        got = [disassembler(side)(eth=_StorageEth())
               .get_state_variable_from_storage("0x" + "11" * 20, params)
               for side in ("jax", "port")]
        assert got[0] == got[1], params


# ---------------------------------------------------------------------------
# the provider pool (tests/test_wild_bytecode.py)
# ---------------------------------------------------------------------------


def _pool(side, scripts, **kwargs):
    c = client_mod(side)

    class _ScriptedClient(c.EthJsonRpc):
        """A provider whose _call pops scripted outcomes (an Exception
        raises; anything else returns)."""

        def __init__(self, name, script):
            super().__init__(host=name)
            self.script = list(script)
            self.calls = 0

        def _call(self, method, params=None):
            self.calls += 1
            outcome = self.script.pop(0) if self.script else "0x6001"
            if isinstance(outcome, Exception):
                raise outcome
            return outcome

    kwargs.setdefault("breaker_fails", 2)
    kwargs.setdefault("breaker_cooldown_s", 60.0)
    return c.ProviderPool(
        [_ScriptedClient(f"p{i}", s) for i, s in enumerate(scripts)],
        **kwargs)


@both
def test_pool_rotates_on_failure_and_opens_breaker(side):
    pool = _pool(side, [[OSError("down"), OSError("down")],
                        ["0xaa", OSError("blip"), "0xbb"]])
    assert pool._call("eth_getCode", []) == "0xaa"
    assert pool._call("eth_getCode", []) == "0xbb"
    assert stats(side).rpc_breaker_opens == 1
    assert stats(side).rpc_provider_rotations >= 3
    assert not pool.slots[0].usable(time.monotonic())


@both
def test_pool_exhaustion_raises_typed_error(side):
    pool = _pool(side, [[OSError("down")] * 9], breaker_cooldown_s=600.0)
    with pytest.raises(mod(side, "exceptions").ProviderExhaustedError) as e:
        pool._call("eth_getCode", [])
    assert json.loads(e.value.to_line())["error"] == "provider_exhausted"
    assert e.value.code == "provider_exhausted"


@both
def test_rate_limit_rotates_without_breaker_strike(side, monkeypatch):
    naps = []
    monkeypatch.setattr(client_mod(side).time, "sleep", naps.append)
    pool = _pool(side, [[client_mod(side).RateLimitError(
        "429", retry_after_s=0.5)], ["0xbb"]])
    assert pool._call("eth_getCode", []) == "0xbb"
    assert stats(side).rpc_rate_limited == 1
    assert stats(side).rpc_breaker_opens == 0
    assert pool.slots[0].fails == 0
    assert naps == [0.5]


@both
def test_rate_limit_retry_after_is_capped(side, monkeypatch):
    naps = []
    monkeypatch.setattr(client_mod(side).time, "sleep", naps.append)
    monkeypatch.setenv("MYTHRIL_TPU_RPC_BACKOFF_CAP_S", "1.5")
    pool = _pool(side, [[client_mod(side).RateLimitError(
        "429", retry_after_s=3600.0)], ["0xcc"]])
    assert pool._call("eth_getCode", []) == "0xcc"
    assert naps == [1.5]


@both
def test_http_429_and_32005_map_to_rate_limit_error(side):
    c = client_mod(side)
    headers = email.message.Message()
    headers["Retry-After"] = "7"
    with mock.patch("urllib.request.urlopen",
                    side_effect=urllib.error.HTTPError(
                        "http://n", 429, "slow down", headers,
                        io.BytesIO(b""))):
        with pytest.raises(c.RateLimitError) as info:
            c.EthJsonRpc().eth_getCode("0x" + "44" * 20)
    assert info.value.retry_after_s == 7.0
    with _transport(error={"code": -32005, "message": "rate limited"}):
        with pytest.raises(c.RateLimitError):
            c.EthJsonRpc().eth_getCode("0x" + "44" * 20)


@both
def test_code_cache_hits_disk_and_honors_fault_point(side, tmp_path):
    pool = _pool(side, [["0xdd", "0xdd", "0xdd"]], cache_dir=str(tmp_path))
    addr = "0x" + "99" * 20
    assert pool.eth_getCode(addr) == "0xdd"
    assert pool.eth_getCode(addr) == "0xdd"
    assert stats(side).rpc_code_cache_hits == 1
    assert pool.slots[0].client.calls == 1
    faults(side).get_fault_plane().arm("rpc_code_cache", times=1)
    assert pool.eth_getCode(addr) == "0xdd"
    assert pool.slots[0].client.calls == 2
    pool2 = _pool(side, [["0xunreachable"]], cache_dir=str(tmp_path))
    assert pool2.eth_getCode(addr) == "0xdd"
    assert pool2.slots[0].client.calls == 0


def test_code_cache_is_shared_between_the_packages(tmp_path):
    """The cache rides the persist segment format, which both packages
    write byte for byte: a store the JAX pool wrote answers the port's."""
    jax_pool = _pool("jax", [["0xfeed"]], cache_dir=str(tmp_path / "jax"))
    addr = "0x" + "98" * 20
    assert jax_pool.eth_getCode(addr) == "0xfeed"
    port_pool = _pool("port", [["0xunreachable"]],
                      cache_dir=str(tmp_path / "jax"))
    assert port_pool.eth_getCode(addr) == "0xfeed"
    assert port_pool.slots[0].client.calls == 0


@both
def test_rpc_flap_fault_point_strikes_the_pool(side):
    faults(side).get_fault_plane().arm("rpc_flap", times=1)
    pool = _pool(side, [["0xee"], ["0xff"]])
    assert pool._call("eth_getCode", []) in ("0xee", "0xff")
    assert pool.slots[0].fails + pool.slots[1].fails == 1


@both
def test_pool_spec_parsing_and_env_knob_validation(side, monkeypatch):
    pool = client_mod(side).ProviderPool.from_spec(
        "localhost:8545, https://rpc.example/v3/key ,node2")
    assert [s.client.url for s in pool.slots] == [
        "http://localhost:8545", "https://rpc.example/v3/key",
        "http://node2:8545"]
    env = mod(side, "support.env")
    monkeypatch.setenv("MYTHRIL_TPU_RPC_PROVIDERS",
                       "localhost:8545,https://x.example")
    env.validate_env()
    for bad in ("host:notaport", " , "):
        monkeypatch.setenv("MYTHRIL_TPU_RPC_PROVIDERS", bad)
        with pytest.raises(env.EnvSpecError):
            env.validate_env()


@pytest.mark.parametrize("knob,value,rejected", [
    ("MYTHRIL_TPU_RPC_BREAKER_FAILS", "0", True),
    ("MYTHRIL_TPU_RPC_BREAKER_FAILS", "2", False),
    ("MYTHRIL_TPU_RPC_BREAKER_COOLDOWN_S", "-1", True),
    ("MYTHRIL_TPU_RPC_BACKOFF_CAP_S", "x", True),
    ("MYTHRIL_TPU_RPC_POOL_ATTEMPTS", "0", True),
    ("MYTHRIL_TPU_RPC_CACHE", "maybe", True),
    ("MYTHRIL_TPU_RPC_CACHE", "0", False),
    ("MYTHRIL_TPU_TRIAGE_MAX_CODE", "0", True),
    ("MYTHRIL_TPU_PROXY_DEPTH", "-1", True),
    ("MYTHRIL_TPU_PROXY_DEPTH", "0", False),
])
def test_rpc_knobs_validate_alike(knob, value, rejected):
    for side in SIDES:
        env = mod(side, "support.env")
        try:
            env.validate_env({knob: value})
            got = False
        except env.EnvSpecError:
            got = True
        assert got is rejected, side


def test_a_faulted_pool_leaves_equal_counters():
    """One schedule of flaps, rate limits, failures and a cache miss on
    each package's pool: the same answers and the same ``rpc_*``
    counters."""
    rows = {}
    for side in SIDES:
        c = client_mod(side)
        with mock.patch.object(c.time, "sleep", lambda s: None):
            faults(side).get_fault_plane().arm("rpc_flap", times=2, skip=1)
            pool = _pool(side, [
                [OSError("a"), c.RateLimitError("r", 0.1), "0x01", "0x02"],
                [c.BadResponseError("garbage"), "0x03", OSError("b"),
                 "0x04", "0x05"],
            ])
            answers = []
            for _ in range(5):
                try:
                    answers.append(pool._call("eth_getCode", []))
                except Exception as exc:  # noqa: BLE001 — compared
                    answers.append(type(exc).__name__)
        rows[side] = (answers, {k: v for k, v in stats(side).as_dict()
                                .items() if k.startswith("rpc_")
                                or k == "faults_fired"},
                      [s.fails for s in pool.slots])
    assert rows["port"] == rows["jax"]


# ---------------------------------------------------------------------------
# config: config.ini, --rpc vocabulary
# ---------------------------------------------------------------------------


@both
def test_config_rpc_vocabulary(side, tmp_path, monkeypatch):
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / side))
    monkeypatch.delenv("MYTHRIL_TPU_RPC_PROVIDERS", raising=False)
    monkeypatch.delenv("INFURA_ID", raising=False)
    c = client_mod(side)
    config = mod(side, "mythril.mythril_config").MythrilConfig()
    assert os.path.isfile(os.path.join(str(tmp_path / side), "config.ini"))
    config.set_api_rpc("ganache")
    assert config.eth.url == "http://localhost:8545"
    config.set_api_rpc("node.example:9000", True)
    assert config.eth.url == "https://node.example:9000"
    config.set_api_rpc("a:1,b:2")
    assert isinstance(config.eth, c.ProviderPool)
    assert len(config.eth.slots) == 2
    with pytest.raises(mod(side, "exceptions").CriticalError):
        config.set_api_rpc("infura-mainnet")
    monkeypatch.setenv("INFURA_ID", "abc")
    config.set_api_rpc("infura-sepolia")
    assert config.eth.url == "https://sepolia.infura.io/v3/abc"
    monkeypatch.delenv("INFURA_ID")
    config.eth = None
    config.set_api_from_config_path()
    assert config.eth is None  # infura without INFURA_ID: no client
    monkeypatch.setenv("MYTHRIL_TPU_RPC_PROVIDERS", "x:1,y:2,z:3")
    config.set_api_rpc()
    assert len(config.eth.slots) == 3


def test_port_config_refuses_leveldb_by_name(tmp_path, monkeypatch):
    """A directory that is no LevelDB is refused by both packages'
    ``set_api_leveldb`` with the same error; a geth database opens."""
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path))
    errors = {}
    for side in SIDES:
        config = mod(side, "mythril.mythril_config").MythrilConfig()
        with pytest.raises(Exception) as refused:
            config.set_api_leveldb(str(tmp_path))
        errors[side] = (type(refused.value).__name__, str(refused.value))
        assert config.eth_db is None
    assert errors["port"] == errors["jax"]
    assert errors["port"][0] == "CorruptionError"
    chaindata = str(tmp_path / "chaindata")
    contracts.write_geth_db(chaindata, n_generated=4)
    config = mod("port", "mythril.mythril_config").MythrilConfig()
    config.set_api_leveldb(chaindata)
    impl = contracts.onchain_accounts()["IMPL"]
    assert config.eth_db.eth_getCode(bytes.fromhex(impl.address[2:])) == (
        "0x" + impl.code)


# ---------------------------------------------------------------------------
# end to end: the CLIs against a chain on the loopback interface
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain():
    """The on-chain runs' chain (``contracts.onchain_chain``), served on
    127.0.0.1 for the module."""
    model = contracts.onchain_chain()
    server = contracts.serve_chain(model)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"127.0.0.1:{server.server_address[1]}", model
    server.shutdown()
    server.server_close()
    thread.join(10)


def _cli_env(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu", MYTHRIL_TPU_PALLAS="force",
               XLA_FLAGS="", OMP_NUM_THREADS="1", MYTHRIL_DIR=str(tmp))
    env.pop("INFURA_ID", None)
    env.pop("MYTHRIL_TPU_RPC_PROVIDERS", None)
    return env


def _argv(side, *args):
    if side == "jax":
        return [sys.executable, "myth", *args]
    return [sys.executable, "-m", "mythril_tpu_torch", *args]


def _issues(stdout):
    """The jsonv2 issues without their discovery walls, in a stable
    order (the overflow module orders its findings by object address)."""
    issues = json.loads(stdout)[0]["issues"]
    for issue in issues:
        issue["extra"].pop("discoveryTime", None)
    return sorted(issues, key=lambda i: json.dumps(i, sort_keys=True))


@pytest.fixture(scope="module")
def onchain_reports(chain, tmp_path_factory):
    """Each small on-chain run through both CLIs (``-a ADDR --rpc
    CHAIN``), the two processes of a run side by side: {(run name,
    side): CompletedProcess}."""
    endpoint, _model = chain
    tmp = tmp_path_factory.mktemp("mythril_dir")
    accounts = contracts.onchain_accounts()
    out = {}
    for run in contracts.ONCHAIN_RUNS:
        if not run.small:
            continue
        procs = {}
        for side in SIDES:
            extra = ["--device", "cpu"] if side == "port" else []
            procs[side] = subprocess.Popen(
                _argv(side, "analyze", "-a", accounts[run.account].address,
                      "--rpc", endpoint, "-t", str(run.transaction_count),
                      "-o", "jsonv2", *extra),
                cwd=ROOT, env=_cli_env(tmp), text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for side, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            out[(run.name, side)] = subprocess.CompletedProcess(
                proc.args, proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("run", [r for r in contracts.ONCHAIN_RUNS
                                 if r.small], ids=lambda r: r.account)
def test_analyze_address_matches_jax_cli(run, onchain_reports):
    """``analyze -a ADDR --rpc CHAIN``: the same issues on both CLIs,
    and the SWC set of ``ONCHAIN_RUNS``; a proxy chain names the
    contract ``ADDR -> TARGET``."""
    jax = onchain_reports[(run.name, "jax")]
    port = onchain_reports[(run.name, "port")]
    assert jax.returncode == 0, jax.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    want = _issues(jax.stdout)
    assert _issues(port.stdout) == want
    assert {i["swcID"][4:] for i in want} == run.swc_ids


def test_full_width_run_set_is_jax_s(chain, tmp_path):
    """The full-width on-chain run (d6 g16 behind two clones): the JAX
    CLI's SWC set is the one ``ONCHAIN_RUNS`` records for the chip
    check, and the chain answered the two hops."""
    endpoint, model = chain
    run = contracts.ONCHAIN_RUNS[0]
    assert not run.small and run.account == "CLONE2"
    address = contracts.onchain_accounts()[run.account].address
    done = subprocess.run(
        _argv("jax", "analyze", "-a", address, "--rpc", endpoint, "-t",
              str(run.transaction_count), "-o", "jsonv2"),
        cwd=ROOT, env=_cli_env(tmp_path), capture_output=True, text=True,
        timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    assert {i["swcID"][4:] for i in _issues(done.stdout)} == run.swc_ids


def test_port_loads_the_two_hop_clone_as_jax(chain):
    """``load_from_address`` of CLONE2 on both packages over the served
    chain: the implementation's bytes, the name and the triage report."""
    endpoint, _model = chain
    accounts = contracts.onchain_accounts()
    got = {}
    for side in SIDES:
        host, port = endpoint.split(":")
        eth = client_mod(side).EthJsonRpc(host, int(port))
        _, contract = disassembler(side)(eth=eth).load_from_address(
            accounts["CLONE2"].address)
        got[side] = (contract.name, contract.code, contract.triage)
    assert got["port"] == got["jax"]
    assert got["port"][1].removeprefix("0x") == accounts["IMPL"].code
    assert got["port"][0] == (f"{accounts['CLONE2'].address} -> "
                              f"{accounts['CLONE'].address}")


def test_read_storage_and_function_to_hash_match_jax_cli(chain, tmp_path):
    endpoint, _model = chain
    vault = contracts.onchain_accounts()["VAULT"]
    slots = sorted(vault.storage)
    commands = [
        ("read-storage", f"{slots[0]},2", vault.address, "--rpc", endpoint),
        ("read-storage", "mapping,1,alice", vault.address, "--rpc",
         endpoint),
        ("function-to-hash", "transfer(address,uint256)"),
    ]
    for args in commands:
        runs = {side: subprocess.run(
            _argv(side, *args), cwd=ROOT, env=_cli_env(tmp_path),
            capture_output=True, text=True, timeout=300) for side in SIDES}
        for side, done in runs.items():
            assert done.returncode == 0, (side, done.stderr[-2000:])
        assert runs["port"].stdout == runs["jax"].stdout, args
    assert runs["port"].stdout.strip() == "0xa9059cbb"
    first = subprocess.run(
        _argv("port", *commands[0]), cwd=ROOT, env=_cli_env(tmp_path),
        capture_output=True, text=True, timeout=300).stdout.splitlines()
    assert first[0] == (f"{hex(slots[0])}: 0x"
                        + format(vault.storage[slots[0]], "064x"))


def test_disassemble_address_matches_jax_cli(chain, tmp_path):
    """``disassemble -a`` of a clone: the implementation's listing, the
    same on both CLIs (no card needed)."""
    endpoint, _model = chain
    address = contracts.onchain_accounts()["KILL_CLONE"].address
    runs = {side: subprocess.run(
        _argv(side, "disassemble", "-a", address, "--rpc", endpoint),
        cwd=ROOT, env=dict(_cli_env(tmp_path), CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300) for side in SIDES}
    for side, done in runs.items():
        assert done.returncode == 0, (side, done.stderr[-2000:])
    assert runs["port"].stdout == runs["jax"].stdout
    assert "SUICIDE" in runs["port"].stdout


def test_cli_exits_2_without_a_card_before_any_rpc_traffic(chain, tmp_path):
    """``analyze -a`` and ``watch`` on ``cuda`` with no card: exit 2 and
    the chain sees no call; a malformed address and an empty account
    exit 2 with the typed one-line error."""
    endpoint, model = chain
    env = dict(_cli_env(tmp_path), CUDA_VISIBLE_DEVICES="")
    before = dict(model.calls)
    address = contracts.onchain_accounts()["KILL"].address
    for args in (("analyze", "-a", address, "--rpc", endpoint),
                 ("watch", "--rpc", endpoint, "--until-block", "1")):
        done = subprocess.run(_argv("port", *args), cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=300)
        assert done.returncode == 2, done.stderr[-2000:]
        assert "CUDA" in done.stderr and "--device cpu" in done.stderr
    assert model.calls == before
    for address, code in (("0xdeadbeef", "bad_address"),
                          ("0x" + "12" * 20, "empty_code")):
        done = subprocess.run(
            _argv("port", "analyze", "-a", address, "--rpc", endpoint,
                  "--device", "cpu"),
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert done.returncode == 2, done.stderr[-2000:]
        assert json.loads(done.stderr.strip().splitlines()[-1])[
            "error"] == code


# ---------------------------------------------------------------------------
# the on-chain default (--no-onchain-data left out)
# ---------------------------------------------------------------------------


def _gate_reports(tmp_path, flag):
    hexfile = tmp_path / "call_constant.hex"
    hexfile.write_text(contracts.call_constant())
    procs = {}
    for side in SIDES:
        extra = ["--device", "cpu"] if side == "port" else []
        procs[side] = subprocess.Popen(
            _argv(side, "analyze", "-f", str(hexfile), "--bin-runtime",
                  "-t", "1", "-o", "jsonv2", *flag, *extra),
            cwd=ROOT, env=_cli_env(tmp_path), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    for side, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (side, stderr[-2000:])
        out[side] = _issues(stdout)
    return out


@pytest.mark.parametrize("flag", [(), ("--no-onchain-data",)],
                         ids=["onchain-default", "no-onchain-data"])
def test_cli_on_chain_default_matches_jax(flag, tmp_path):
    """``call_constant`` through both CLIs, with no chain
    (``MYTHRIL_DIR`` a fresh directory, ``INFURA_ID`` unset): without the
    flag both load slot 0 as the chain's zero, so the SUICIDE is
    unreachable (SWC-104 and SWC-107 only); with it slot 0 is symbolic
    and SWC-106 is found too.  The parent of this port gave SWC-106 in
    both cases."""
    got = _gate_reports(tmp_path, flag)
    assert got["port"] == got["jax"]
    swc = {i["swcID"] for i in got["jax"]}
    assert ("SWC-106" in swc) == bool(flag)
    assert {"SWC-104", "SWC-107"} <= swc


@pytest.mark.parametrize("onchain", [True, False],
                         ids=["onchain-default", "no-onchain-data"])
def test_on_chain_default_states_and_loaded_accounts_agree(onchain,
                                                           monkeypatch,
                                                           tmp_path):
    """In this process, each package's CLI configuration
    (``set_config``) and analyzer on ``call_constant`` with and without
    ``--no-onchain-data``: no client either way; the loader's activity,
    the issues, the state count and every ``accounts_exist_or_load``
    outcome (the address, its code, its balance if concrete, the loader's
    activity, its storage's kind) are equal."""
    from test_torch_analyze import (
        ADDRESS, EXEC_TIMEOUT, _reset_jax, analysis_pins, kept_deadlines,
    )

    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path))
    monkeypatch.delenv("INFURA_ID", raising=False)
    code = contracts.call_constant()
    got = {}
    with analysis_pins(monkeypatch), kept_deadlines():
        for side in ("jax", "port"):
            outcomes, syms = [], []
            world = mod(side, "laser.ethereum.state.world_state").WorldState
            real = world.accounts_exist_or_load

            def record(self, addr, dynamic_loader, _real=real,
                       _out=outcomes):
                account = _real(self, addr, dynamic_loader)
                _out.append((
                    addr, account.code.bytecode,
                    account.balance().value,
                    bool(dynamic_loader is not None
                         and dynamic_loader.active),
                    type(account.storage._standard_storage).__name__))
                return account

            monkeypatch.setattr(world, "accounts_exist_or_load", record)
            analyzer_mod = mod(side, "mythril.mythril_analyzer")
            wrapper = analyzer_mod.SymExecWrapper

            class Recorded(wrapper):
                def __init__(self, *args, **kwargs):
                    super().__init__(*args, **kwargs)
                    syms.append(self)

            monkeypatch.setattr(analyzer_mod, "SymExecWrapper", Recorded)
            if side == "port":
                analyzer_mod.reset_analysis_state()
            else:
                _reset_jax()
            args = argparse.Namespace(rpc=None, rpctls=False,
                                      no_onchain_data=not onchain)
            config = mod(side, "interfaces.cli").set_config(args)
            assert config.eth is None
            dis = mod(side, "mythril").MythrilDisassembler(eth=config.eth)
            dis.load_from_bytecode(code, True)
            extra = {"device": "cpu"} if side == "port" else {}
            analyzer = mod(side, "mythril").MythrilAnalyzer(
                disassembler=dis, strategy="bfs", address=hex(ADDRESS),
                max_depth=128, execution_timeout=EXEC_TIMEOUT, loop_bound=3,
                create_timeout=10, use_onchain_data=onchain, **extra)
            report = analyzer.fire_lasers(transaction_count=1)
            issues = sorted((i.swc_id, i.address, i.title)
                            for i in report.issues.values())
            dynloader = syms[-1].laser.dynamic_loader
            got[side] = (issues, syms[-1].laser.total_states,
                         sorted(set(outcomes)),
                         (dynloader.eth, dynloader.active))
    assert got["port"] == got["jax"]
    issues, _states, outcomes, (eth, active) = got["port"]
    assert eth is None and active is onchain
    assert outcomes and all(o[0] == contracts.CALLEE for o in outcomes)
    assert ("106" in {i[0] for i in issues}) is not onchain
