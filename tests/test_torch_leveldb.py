"""The port's LevelDB plane (``support/rlp.py``,
``ethereum/interface/leveldb/``, ``mythril/mythril_leveldb.py``, the
LevelDB half of ``mythril_config.py``, ``leveldb-search`` and
``hash-to-address``) held against the JAX package's: the same bytes from
both writers, each reader on what the other wrote, and the same answers
on ``tests/test_leveldb.py``'s geth fixture rebuilt by each side and on
``contracts.write_geth_db``'s chain.
"""

import importlib
import json
import os
import random
import subprocess
import sys

import pytest

from mythril_tpu_torch import contracts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}
PAIRS = [(w, r) for w in sorted(SIDES) for r in sorted(SIDES)]
both = pytest.mark.parametrize("side", sorted(SIDES))
written_read = pytest.mark.parametrize("writer,reader", PAIRS,
                                       ids=[f"{w}-to-{r}" for w, r in PAIRS])


def mod(side, path):
    return importlib.import_module(f"{SIDES[side]}.{path}")


def leveldb(side, name):
    return mod(side, f"ethereum.interface.leveldb.{name}")


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


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("MYTHRIL_DIR", str(tmp_path / "home" / ".mythril_tpu"))


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

_RNG = random.Random(11)
SNAPPY_CASES = [b"", b"a", b"abcabcabcabcabcabcabc" * 50,
                bytes(_RNG.randrange(256) for _ in range(5000)),
                b"\x00" * 100000,
                bytes.fromhex(contracts.scale_contract(6, 16, "mul"))]


@written_read
def test_snappy_blocks_cross_read(writer, reader):
    """Each side's compressed blocks, byte for byte the same, decompress
    on the other; garbage is refused alike."""
    for data in SNAPPY_CASES:
        packed = leveldb(writer, "snappy").compress(data)
        assert packed == leveldb("port", "snappy").compress(data)
        assert leveldb(reader, "snappy").decompress(packed) == data
    with pytest.raises(leveldb(reader, "snappy").SnappyError):
        leveldb(reader, "snappy").decompress(b"\xff\xff\xff\xff\xff")


RLP_ITEMS = [b"", b"\x01", b"\x7f", b"\x80", b"hello world", b"x" * 100, [],
             [b"a", [b"b", [b"c"]], b""], [b"k" * 60, [b"v" * 1000]]]


@written_read
def test_rlp_cross_decodes(writer, reader):
    for item in RLP_ITEMS:
        encoded = mod(writer, "support.rlp").encode(item)
        assert encoded == mod("jax", "support.rlp").encode(item)
        assert mod(reader, "support.rlp").decode(encoded) == item
    for value in (0, 1, 127, 128, 256, 2**64, 2**255):
        encoded = mod(writer, "support.rlp").encode_int(value)
        assert mod(reader, "support.rlp").decode_int(encoded) == value


@pytest.mark.parametrize("data", [b"\x81\x01", b"\xb8\x01a", b"\x82a",
                                  b"\xc1", b"\x80\x80"],
                         ids=["short-single", "long-short", "truncated",
                              "list-truncated", "trailing"])
def test_rlp_rejects_non_canonical_input_alike(data):
    errors = {}
    for s in SIDES:
        with pytest.raises(mod(s, "support.rlp").RLPError) as e:
            mod(s, "support.rlp").decode(data)
        errors[s] = str(e.value)
    assert errors["port"] == errors["jax"]


# ---------------------------------------------------------------------------
# the storage format
# ---------------------------------------------------------------------------


@written_read
def test_log_records_and_write_batches_cross_read(writer, reader):
    records = [b"small", b"x" * 100000, b"tail"]  # FIRST / MIDDLE / LAST
    data = leveldb(writer, "storage").write_log_records(records)
    assert data == leveldb("jax", "storage").write_log_records(records)
    assert list(leveldb(reader, "storage").read_log_records(data)) == records
    value = leveldb(writer, "storage").TYPE_VALUE
    ops = [(value, b"key%d" % i, b"val%d" % i) for i in range(5)]
    batch = leveldb(writer, "storage").build_write_batch(42, ops)
    parsed = list(leveldb(reader, "storage").parse_write_batch(batch))
    assert [(s, k, v) for s, _, k, v in parsed] == [
        (42 + i, b"key%d" % i, b"val%d" % i) for i in range(5)]


@written_read
def test_tables_cross_read(writer, reader):
    """A table of 500 records in 512-byte blocks, snappy and plain: the
    same bytes from both builders, every key found by the other side."""
    rng = random.Random(3)
    records = {b"key-%06d" % i: bytes(rng.randrange(4) for _ in range(50))
               for i in range(500)}
    wmod, rmod = leveldb(writer, "storage"), leveldb(reader, "storage")
    for compress in (True, False):
        builder = wmod.TableBuilder(block_size=512, compress=compress)
        for seq, (key, value) in enumerate(sorted(records.items()), 1):
            builder.add(wmod.internal_key(key, seq, wmod.TYPE_VALUE), value)
        data = builder.finish()
        twin = leveldb("jax", "storage").TableBuilder(block_size=512,
                                                      compress=compress)
        for seq, (key, value) in enumerate(sorted(records.items()), 1):
            twin.add(wmod.internal_key(key, seq, wmod.TYPE_VALUE), value)
        assert data == twin.finish()
        table = rmod.Table(data)
        for key, value in records.items():
            assert table.get(key)[2] == value
        assert table.get(b"missing") is None
        assert len(list(table.entries())) == 500


@written_read
def test_manifest_edits_cross_read(writer, reader):
    wmod, rmod = leveldb(writer, "storage"), leveldb(reader, "storage")
    small = wmod.internal_key(b"a", 1, wmod.TYPE_VALUE)
    large = wmod.internal_key(b"z", 9, wmod.TYPE_VALUE)
    edit = wmod.encode_version_edit(
        comparator="leveldb.BytewiseComparator", log_number=6, next_file=7,
        last_sequence=10, new_files=[(0, 5, 1234, small, large)])
    assert edit == leveldb("jax", "storage").encode_version_edit(
        comparator="leveldb.BytewiseComparator", log_number=6, next_file=7,
        last_sequence=10, new_files=[(0, 5, 1234, small, large)])
    state = rmod.VersionState()
    state.apply_edit(edit)
    assert state.log_number == 6
    assert state.files[0][5] == (1234, small, large)


@written_read
@pytest.mark.parametrize("via_log", [True, False], ids=["log", "table"])
def test_fixture_databases_cross_open(writer, reader, via_log, tmp_path):
    records = {b"k%03d" % i: b"v%d" % (i * i) for i in range(200)}
    path = str(tmp_path / "db")
    leveldb(writer, "storage").write_fixture_db(path, records,
                                                via_log=via_log)
    db = leveldb(reader, "storage").LevelDB(path)
    for key, value in records.items():
        assert db.get(key) == value
    assert db.get(b"nope") is None
    assert dict(db.items()) == records


def test_trie_roots_and_nodes_equal():
    """The same entries give the same root and nodes on both sides, and
    each reader reads the other's trie, secure and plain."""
    entries = {b"acct-%d" % i: mod("port", "support.rlp").encode(
        [b"\x01", b"%d" % i]) for i in range(300)}
    built = {}
    for side in SIDES:
        for secure in (True, False):
            builder = leveldb(side, "trie").TrieBuilder(secure=secure)
            for key, value in entries.items():
                builder.put(key, value)
            built[(side, secure)] = (builder.commit(), builder.nodes)
    for secure in (True, False):
        root, nodes = built[("port", secure)]
        assert (root, nodes) == built[("jax", secure)]
        for side in SIDES:
            reader = leveldb(side, "trie").TrieReader(nodes, root,
                                                      secure=secure)
            for key, value in entries.items():
                assert reader.get(key) == value
            assert reader.get(b"missing-key") is None
            assert len(list(reader.items())) == len(entries)
    assert built[("port", True)][0] != built[("port", False)][0]
    empty = leveldb("port", "trie").TrieBuilder().commit()
    assert empty == leveldb("jax", "trie").TrieBuilder().commit()
    assert empty == leveldb("port", "trie").EMPTY_ROOT


# ---------------------------------------------------------------------------
# the geth schema
# ---------------------------------------------------------------------------

CONTRACT_ADDRESS = bytes.fromhex("a" * 40)
EOA_ADDRESS = bytes.fromhex("b" * 40)
CONTRACT_CODE = bytes.fromhex("600035330158ff")


def build_geth_fixture(side, path):
    """``tests/test_leveldb.py``'s two-block chain (a contract account
    with storage, an EOA, a transaction to the contract), built with
    ``side``'s modules."""
    rlp = mod(side, "support.rlp")
    keccak256 = mod(side, "support.crypto").keccak256
    trie = leveldb(side, "trie")
    records = {}
    storage = trie.TrieBuilder(secure=True)
    storage.put((0).to_bytes(32, "big"), rlp.encode(rlp.encode_int(0x2A)))
    storage.put((3).to_bytes(32, "big"), rlp.encode(rlp.encode_int(0xBEEF)))
    storage_root = storage.commit()
    records.update(storage.nodes)
    code_hash = keccak256(CONTRACT_CODE)
    records[code_hash] = CONTRACT_CODE
    state = trie.TrieBuilder(secure=True)
    state.put(CONTRACT_ADDRESS, rlp.encode([
        rlp.encode_int(1), rlp.encode_int(1000), storage_root, code_hash]))
    state.put(EOA_ADDRESS, rlp.encode([
        rlp.encode_int(7), rlp.encode_int(5), trie.EMPTY_ROOT,
        leveldb(side, "state").BLANK_CODE_HASH]))
    state_root = state.commit()
    records.update(state.nodes)

    def header(number, parent):
        return [parent, b"\x00" * 32, b"\x00" * 20, state_root, b"\x00" * 32,
                b"\x00" * 32, b"\x00" * 256, rlp.encode_int(1),
                rlp.encode_int(number), rlp.encode_int(8000000),
                rlp.encode_int(0), rlp.encode_int(1438269988 + number), b"",
                b"\x00" * 32, b"\x00" * 8]

    def num8(n):
        return n.to_bytes(8, "big")

    genesis_rlp = rlp.encode(header(0, b"\x00" * 32))
    genesis_hash = keccak256(genesis_rlp)
    head_rlp = rlp.encode(header(1, genesis_hash))
    head_hash = keccak256(head_rlp)
    records[b"h" + num8(0) + genesis_hash] = genesis_rlp
    records[b"h" + num8(1) + head_hash] = head_rlp
    records[b"h" + num8(0) + b"n"] = genesis_hash
    records[b"h" + num8(1) + b"n"] = head_hash
    records[b"H" + genesis_hash] = num8(0)
    records[b"H" + head_hash] = num8(1)
    records[b"LastBlock"] = head_hash
    tx = [rlp.encode_int(0), rlp.encode_int(1), rlp.encode_int(21000),
          CONTRACT_ADDRESS, rlp.encode_int(0), b"", rlp.encode_int(27),
          b"\x01", b"\x02"]
    records[b"b" + num8(1) + head_hash] = rlp.encode([[tx], []])
    receipt = [b"\x01", rlp.encode_int(21000), b"\x00" * 256, b"\x00" * 32,
               CONTRACT_ADDRESS, [], rlp.encode_int(21000)]
    records[b"r" + num8(1) + head_hash] = rlp.encode([receipt])
    leveldb(side, "storage").write_fixture_db(path, records, via_log=False)
    return state_root


def _readings(side, path):
    """Everything ``side``'s ``EthLevelDB`` reads from the geth fixture."""
    rlp = mod(side, "support.rlp")
    db = leveldb(side, "client").EthLevelDB(path)
    header = db.eth_getBlockHeaderByNumber(1)
    block = db.eth_getBlockByNumber(1)
    contracts_found = [(c.code, h, b) for c, h, b in db.get_contracts()]
    keccak256 = mod(side, "support.crypto").keccak256
    return {
        "code": db.eth_getCode(CONTRACT_ADDRESS),
        "balances": (db.eth_getBalance(CONTRACT_ADDRESS),
                     db.eth_getBalance(EOA_ADDRESS)),
        "storage": [db.eth_getStorageAt(CONTRACT_ADDRESS, p)
                    for p in (0, 3, 9)],
        "header": header.to_dict(), "number": rlp.decode_int(header.number),
        "missing": db.eth_getBlockHeaderByNumber(7),
        "body": block["body"], "contracts": contracts_found,
        "resolved": db.reader._get_address_by_hash(
            keccak256(CONTRACT_ADDRESS)),
        "indexed": db.reader._get_last_indexed_number(),
        "hash_to_address": db.contract_hash_to_address(
            keccak256(CONTRACT_CODE)),
        "unknown_hash": db.contract_hash_to_address(b"\x00" * 32),
    }


@written_read
def test_geth_fixture_reads_alike(writer, reader, tmp_path):
    """The fixture built by ``writer``, read by ``reader``: what the JAX
    package reads from its own build; the builds' state roots equal."""
    roots = {}
    for side in SIDES:
        roots[side] = build_geth_fixture(side, str(tmp_path / side))
    assert roots["port"] == roots["jax"]
    got = _readings(reader, str(tmp_path / writer))
    want = _readings("jax", str(tmp_path / "jax"))
    assert got == want
    assert got["code"] == "0x" + CONTRACT_CODE.hex()
    assert got["balances"] == (1000, 5) and got["indexed"] == 1
    assert got["resolved"] == CONTRACT_ADDRESS
    assert got["hash_to_address"] == "0x" + CONTRACT_ADDRESS.hex()


@pytest.mark.parametrize("first", sorted(SIDES))
def test_sidecar_index_is_shared(first, tmp_path):
    """The first package to open the database writes the hash-to-address
    index beside it (``mythril_tpu_index.json``, the JAX format); the
    other reads it and indexes nothing again."""
    path = str(tmp_path / "chaindata")
    build_geth_fixture(first, path)
    leveldb(first, "client").EthLevelDB(path)
    sidecar = os.path.join(path, "mythril_tpu_index.json")
    with open(sidecar) as handle:
        written = json.load(handle)
    other = "jax" if first == "port" else "port"
    indexer = leveldb(other, "accountindexing").AccountIndexer
    calls = []
    real = indexer._process
    indexer._process = lambda self, start: calls.append(start) or real(
        self, start)
    try:
        db = leveldb(other, "client").EthLevelDB(path)
    finally:
        indexer._process = real
    assert calls == []
    assert db.reader._get_last_indexed_number() == 1
    with open(sidecar) as handle:
        assert json.load(handle) == written


@both
def test_search_and_hash_to_address_print_alike(side, tmp_path, capsys):
    """``MythrilLevelDB``'s two operations on the fixture: the lines the
    JAX package prints, and its refusals."""
    path = str(tmp_path / "chaindata")
    build_geth_fixture(side, path)
    printed = {}
    for s in SIDES:
        facade = mod(s, "mythril.mythril_leveldb").MythrilLevelDB(
            leveldb(s, "client").EthLevelDB(path))
        facade.search_db("code#PUSH1#")
        facade.search_db("func#kill()#")
        facade.contract_hash_to_address(
            "0x" + mod(s, "support.crypto").keccak256(CONTRACT_CODE).hex())
        errors = []
        for bad in (("search_db", "code#PUSH1# and ("),
                    ("contract_hash_to_address", "0x1234")):
            with pytest.raises(mod(s, "exceptions").CriticalError) as e:
                getattr(facade, bad[0])(bad[1])
            errors.append(str(e.value))
        printed[s] = (capsys.readouterr().out, errors)
    assert printed["port"] == printed["jax"]
    out = printed["port"][0].splitlines()
    assert out == [f"Address: 0x{CONTRACT_ADDRESS.hex()}, balance: 1000",
                   f"0x{CONTRACT_ADDRESS.hex()}"]


# ---------------------------------------------------------------------------
# contracts.write_geth_db: snappy tables, a log tail, generated accounts
# ---------------------------------------------------------------------------

N_SMALL = 40


@pytest.fixture(scope="module")
def geth_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("geth") / "chaindata")
    built = contracts.write_geth_db(path, N_SMALL)
    return path, built


def test_write_geth_db_has_snappy_tables_and_a_log_tail(geth_db):
    """The database's records sit in a table of snappy blocks and the
    head block in the write-ahead log, which shadows the table's older
    head; each package reads it whole."""
    path, built = geth_db
    names = sorted(os.listdir(path))
    assert [n for n in names if n.endswith(".ldb")] == ["000005.ldb"]
    storage = leveldb("port", "storage")
    with open(os.path.join(path, "000005.ldb"), "rb") as handle:
        table = storage.Table(handle.read())
    assert len(list(table.entries())) == len(built["records"])
    with open(os.path.join(path, "000005.ldb"), "rb") as handle:
        data = handle.read()
    compressed = storage.TableBuilder(compress=False)
    for seq, (key, value) in enumerate(sorted(built["records"].items()), 1):
        compressed.add(storage.internal_key(key, seq, storage.TYPE_VALUE),
                       value)
    assert len(data) < len(compressed.finish())  # snappy blocks
    with open(os.path.join(path, "000006.log"), "rb") as handle:
        tail = list(storage.read_log_records(handle.read()))
    assert len(tail) == 1
    assert {k for _, _, k, _ in storage.parse_write_batch(tail[0])} == set(
        built["tail"])
    for side in SIDES:
        db = leveldb(side, "storage").LevelDB(path)
        assert db.get(b"LastBlock") == built["tail"][b"LastBlock"]
        assert db.get(b"LastBlock") != built["records"][b"LastBlock"]
        merged = dict(db.items())
        assert merged == {**built["records"], **built["tail"]}


def test_write_geth_db_search_and_hash_to_address_match_jax(geth_db,
                                                              capsys):
    """On ``contracts.write_geth_db``'s chain both packages find the
    killbilly accounts (``geth_search_hits``) and resolve the scale
    contract's code hash to IMPL; the head is block 2, from the log."""
    path, built = geth_db
    impl = contracts.onchain_accounts()["IMPL"]
    code_hash = "0x" + mod("port", "support.crypto").keccak256(
        bytes.fromhex(impl.code)).hex()
    printed = {}
    for side in SIDES:
        db = leveldb(side, "client").EthLevelDB(path)
        assert mod(side, "support.rlp").decode_int(
            db.reader._get_head_block().number) == 2
        facade = mod(side, "mythril.mythril_leveldb").MythrilLevelDB(db)
        facade.search_db(contracts.GETH_SEARCH)
        facade.contract_hash_to_address(code_hash)
        printed[side] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    lines = printed["port"].splitlines()
    hits = {line.split()[1].rstrip(",") for line in lines[:-1]}
    assert hits == contracts.geth_search_hits(N_SMALL)
    assert lines[-1] == impl.address
    balances = {a.address: a.balance for a in built["accounts"]}
    for line in lines[:-1]:
        address = line.split()[1].rstrip(",")
        assert line == f"Address: {address}, balance: {balances[address]}"


def _port_cli(*args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", *args], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300, stdin=subprocess.DEVNULL)


def _jax_main(monkeypatch, capsys, *argv):
    monkeypatch.setattr(sys, "argv", ["myth", *argv])
    code = None
    try:
        mod("jax", "interfaces.cli").main()
    except SystemExit as done:
        code = done.code
    return code, capsys.readouterr().out


def test_leveldb_commands_match_the_jax_cli(geth_db, monkeypatch, capsys):
    """``leveldb-search EXPR --leveldb-dir D`` and ``hash-to-address HASH
    --leveldb-dir D`` as the port's CLI processes (no card, no
    ``--device``): the JAX CLI's output; without ``--leveldb-dir`` the
    config's directory, which is no database here."""
    path, _built = geth_db
    impl = contracts.onchain_accounts()["IMPL"]
    code_hash = "0x" + mod("port", "support.crypto").keccak256(
        bytes.fromhex(impl.code)).hex()
    for argv in (("leveldb-search", contracts.GETH_SEARCH, "--leveldb-dir",
                  path),
                 ("hash-to-address", code_hash, "--leveldb-dir", path),
                 ("hash-to-address", "0x" + "00" * 32, "--leveldb-dir",
                  path)):
        done = _port_cli(*argv)
        assert done.returncode == 0, done.stderr[-2000:]
        _code, jax_out = _jax_main(monkeypatch, capsys, *argv)
        assert done.stdout == jax_out, argv
    assert "Not found" in done.stdout
    help_text = _port_cli("hash-to-address", "--help").stdout
    assert "--leveldb-dir" in help_text and "--device" not in help_text


def test_unreadable_leveldb_exits_with_the_jax_message(tmp_path, monkeypatch,
                                                       capsys, caplog):
    """A directory that is no database: the JAX CLI's one-line message
    (which it logs), exit 1 from the port's CLI."""
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    done = _port_cli("leveldb-search", "code#PUSH1#", "--leveldb-dir", empty)
    assert done.returncode == 1 and done.stdout == ""
    assert done.stderr.startswith(f"Cannot open LevelDB at {empty}: ")
    _jax_main(monkeypatch, capsys, "leveldb-search", "code#PUSH1#",
              "--leveldb-dir", empty)
    assert done.stderr.strip() in caplog.text
