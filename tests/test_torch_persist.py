"""The port's persistent knowledge plane (``mythril_tpu_torch/persist``
and the knowledge half of ``parallel/gossip.py``) against the JAX
package's, on the CPU.

The port's counterparts of ``tests/test_persist.py``:

- **The segment store**, case by case over both packages' stores on the
  same records (each case a parameter per package): round trip, last
  record wins across segments and writers, an identical re-put stays
  clean, an injected ``persist_flush`` keeps the records staged,
  compaction under the cap, truncation and bit-flip fuzz quarantining
  without an exception, version skew, a corrupt sibling, a second
  writer degrading to read-only; and a segment written by either
  package's store reads back, byte for byte the same, through the
  other's.
- **The plane**: the kill switch, a garbage or foreign channel body
  (the JAX package's own, or one that would move a tensor to another
  device) degrading to a cold start, the report cache's key and its
  refusal of partial verdicts, the heartbeat delta's gating, and the
  knobs' startup checks (exit 2 from the CLI).
- **End to end**, under the slice pins and force-dispatched (the
  parity harness of ``test_torch_analyze``): a cold run, a restart
  (``reset_for_tests``) warm from the store, and a restart after every
  segment was bit-flipped, of killbilly, and the cold and warm runs of
  scale_mul d4 -t 1, on both packages.  Issues, states, prune verdicts, solver counters, ledgers
  and autopilots are equal between the packages in every run, the
  findings and states equal across the three runs, and the warm hits
  and thaw counts (+unsat, +probe, +models) equal between the packages.
"""

import importlib
import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import bench
from mythril_tpu_torch.interfaces import cli as port_cli
from mythril_tpu_torch.support.support_args import args as port_args
from test_torch_analyze import (
    ROOT,
    _run,
    analysis_pins,
    kept_deadlines,
)

pytestmark = pytest.mark.persist

PACKAGES = ("mythril_tpu", "mythril_tpu_torch")
SIDES = {"mythril_tpu": "jax", "mythril_tpu_torch": "port"}
PERSIST_KNOBS = ("MYTHRIL_TPU_PERSIST", "MYTHRIL_TPU_PERSIST_DIR",
                 "MYTHRIL_TPU_PERSIST_FLUSH_S", "MYTHRIL_TPU_PERSIST_CAP_MB",
                 "MYTHRIL_TPU_PERSIST_GOSSIP")


def module(package, name):
    return importlib.import_module(f"{package}.{name}")


def reset_knowledge_planes():
    for package in PACKAGES:
        module(package, "persist.plane").reset_for_tests()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's plain CPU tiers on one intra-op thread: beside the other
    test files' busy processes, torch's pool of threads made the d4
    parity runs several times slower (575 s against 71-102 s alone, as
    test_torch_keccak.py found for its plain version); the runs compute
    the same."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_persist(monkeypatch):
    """Every test starts with both packages' knowledge planes inert and
    no persist knob set, and leaves them so."""
    for name in PERSIST_KNOBS:
        monkeypatch.delenv(name, raising=False)
    reset_knowledge_planes()
    yield
    reset_knowledge_planes()


def segments_of(directory):
    return sorted(name for name in os.listdir(directory)
                  if name.startswith("seg-") and name.endswith(".bin"))


def populated_store(package, directory, records=None):
    store = module(package, "persist.store").SegmentStore(directory).open()
    for kind, key, payload in records or [
        ("channels", "d" * 64, b"payload-one"),
        ("report", "r" * 64, b'{"ok": true}'),
    ]:
        store.put(kind, key, payload)
    assert store.flush()
    store.close()
    return segments_of(directory)


def open_store(package, directory):
    return module(package, "persist.store").SegmentStore(directory).open()


# ---------------------------------------------------------------------------
# the segment store, case by case on both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("package", PACKAGES)
def test_store_round_trip_survives_reopen(tmp_path, package):
    populated_store(package, str(tmp_path))
    assert not os.path.exists(tmp_path / ".seg.tmp")
    store = open_store(package, str(tmp_path))
    assert store.get("channels", "d" * 64) == b"payload-one"
    assert store.get("report", "r" * 64) == b'{"ok": true}'
    assert (store.loaded_records, store.corrupt_segments) == (2, 0)
    store.close()


@pytest.mark.parametrize("package", PACKAGES)
def test_last_record_wins_across_segments_and_writers(tmp_path, package):
    store = open_store(package, str(tmp_path))
    store.put("channels", "k", b"v1")
    store.flush()
    store.put("channels", "k", b"v2")
    store.flush()
    store.close()
    store = open_store(package, str(tmp_path))  # a new writer: epoch + 1
    assert store.get("channels", "k") == b"v2"
    assert store.epoch == 2
    store.put("channels", "k", b"v3")
    store.flush()
    store.close()
    store = open_store(package, str(tmp_path))
    assert store.get("channels", "k") == b"v3"
    store.close()


@pytest.mark.parametrize("package", PACKAGES)
def test_identical_reput_stays_clean(tmp_path, package):
    store = open_store(package, str(tmp_path))
    store.put("channels", "k", b"same")
    assert store.flush()
    store.put("channels", "k", b"same")
    assert not store.dirty
    assert store.flush() is False
    store.close()


@pytest.mark.parametrize("package", PACKAGES)
def test_injected_flush_fault_keeps_records_staged(tmp_path, package):
    faults = module(package, "resilience.faults")
    stats = module(package, "resilience.telemetry").resilience_stats
    store = open_store(package, str(tmp_path))
    store.put("channels", "k", b"v")
    faults.reset_for_tests()
    fired = stats.faults_fired
    faults.get_fault_plane().arm("persist_flush", times=1)
    try:
        assert store.flush() is False  # aborted, never raises
        assert store.dirty
        assert not segments_of(str(tmp_path))
        assert faults.get_fault_plane().fired == {"persist_flush": 1}
        assert stats.faults_fired == fired + 1
        assert store.flush()  # the shot is spent: the next one lands
    finally:
        faults.reset_for_tests()
        store.close()


@pytest.mark.parametrize("package", PACKAGES)
def test_compaction_respects_cap(tmp_path, monkeypatch, package):
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_CAP_MB", "1")
    store = open_store(package, str(tmp_path))
    blob = np.random.default_rng(21).bytes(300_000)
    for n in range(6):  # ~1.8 MB over 6 segments, past the 1 MB cap
        store.put("channels", f"k{n}", blob + bytes([n]))
        store.flush()
    assert len(segments_of(str(tmp_path))) == 1
    store.close()
    store = open_store(package, str(tmp_path))
    assert store.loaded_records == 6
    assert store.get("channels", "k5") == blob + bytes([5])
    store.close()


def _backup(tmp_path):
    backup = tmp_path / "_backup.bin"
    if not backup.exists():
        backup.write_bytes((tmp_path / segments_of(str(tmp_path))[0])
                           .read_bytes())
    return backup.read_bytes()


def _restore(tmp_path, name):
    for stray in os.listdir(str(tmp_path)):
        if stray.endswith(".quarantined"):
            os.unlink(os.path.join(str(tmp_path), stray))
    (tmp_path / name).write_bytes(_backup(tmp_path))


@pytest.mark.parametrize("package", PACKAGES)
def test_truncation_fuzz_quarantines_never_raises(tmp_path, package):
    from mythril_tpu_torch.persist.store import MAGIC

    name = populated_store(package, str(tmp_path))[0]
    original = _backup(tmp_path)
    stats = module(package, "resilience.telemetry").resilience_stats
    for keep in (0, 3, len(MAGIC), len(MAGIC) + 4, len(original) // 2,
                 len(original) - 1):
        (tmp_path / name).write_bytes(original[:keep])
        before = stats.persist_corrupt_segments
        store = open_store(package, str(tmp_path))
        assert store.get("channels", "d" * 64) is None
        assert store.corrupt_segments == 1
        assert stats.persist_corrupt_segments == before + 1
        store.close()
        _restore(tmp_path, name)


@pytest.mark.parametrize("package", PACKAGES)
def test_bit_flip_fuzz_quarantines_never_raises(tmp_path, package):
    from mythril_tpu_torch.persist.store import MAGIC

    name = populated_store(package, str(tmp_path))[0]
    original = _backup(tmp_path)
    for offset in (0, len(MAGIC) + 1, len(MAGIC) + 14, len(original) // 2,
                   len(original) - 1):
        corrupted = bytearray(original)
        corrupted[offset] ^= 0xFF
        (tmp_path / name).write_bytes(bytes(corrupted))
        store = open_store(package, str(tmp_path))
        assert store.get("channels", "d" * 64) is None
        assert store.corrupt_segments == 1
        assert os.path.exists(tmp_path / (name + ".quarantined"))
        store.close()
        _restore(tmp_path, name)


@pytest.mark.parametrize("package", PACKAGES)
def test_version_skew_quarantines(tmp_path, package):
    from mythril_tpu_torch.persist.store import MAGIC, STORE_VERSION

    name = populated_store(package, str(tmp_path))[0]
    original = _backup(tmp_path)
    (tmp_path / name).write_bytes(
        original[:len(MAGIC)] + struct.pack("<I", STORE_VERSION + 7)
        + original[len(MAGIC) + 4:])
    store = open_store(package, str(tmp_path))
    assert (store.loaded_records, store.corrupt_segments) == (0, 1)
    store.close()


@pytest.mark.parametrize("package", PACKAGES)
def test_valid_segments_survive_a_corrupt_sibling(tmp_path, package):
    store = open_store(package, str(tmp_path))
    store.put("channels", "good", b"kept")
    store.flush()
    store.put("channels", "doomed", b"lost")
    store.flush()
    store.close()
    doomed = tmp_path / segments_of(str(tmp_path))[-1]
    raw = bytearray(doomed.read_bytes())
    raw[-1] ^= 0xFF
    doomed.write_bytes(bytes(raw))
    store = open_store(package, str(tmp_path))
    assert store.get("channels", "good") == b"kept"
    assert store.get("channels", "doomed") is None
    assert store.corrupt_segments == 1
    store.close()


@pytest.mark.parametrize("package", PACKAGES)
def test_second_writer_degrades_read_only(tmp_path, package):
    first = open_store(package, str(tmp_path))
    first.put("channels", "k", b"v")
    first.flush()
    second = open_store(package, str(tmp_path))
    try:
        assert second.read_only and not first.read_only
        assert second.get("channels", "k") == b"v"
        second.put("channels", "x", b"y")
        assert second.flush() is False
        assert len(segments_of(str(tmp_path))) == 1
    finally:
        second.close()
        first.close()


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]])
def test_a_segment_reads_back_through_the_other_packages_store(
        tmp_path, writer, reader):
    """The same records flushed by both stores give the same bytes, and
    a segment of either package's store loads in the other's."""
    records = [("channels", "d" * 64, bytes(range(256))),
               ("autopilot", "cells", b"\x80\x04}\x94."),
               ("report", "r" * 64, json.dumps({"swc": ["106"]}).encode())]
    written = {}
    for package in PACKAGES:
        directory = str(tmp_path / package)
        name = populated_store(package, directory, records)[0]
        written[package] = (tmp_path / package / name).read_bytes()
    assert written[writer] == written[reader]
    store = open_store(reader, str(tmp_path / writer))
    assert store.corrupt_segments == 0 and store.loaded_records == 3
    for kind, key, payload in records:
        assert store.get(kind, key) == payload
    assert store.epoch == 2
    store.close()


# ---------------------------------------------------------------------------
# the plane: gating, degradation, report cache, gossip
# ---------------------------------------------------------------------------


def plane_of(package):
    return module(package, "persist.plane").get_knowledge_plane()


def context_of(package):
    return module(package, "smt.solver").get_blast_context()


@pytest.mark.parametrize("package", PACKAGES)
def test_plane_inert_without_a_directory(package):
    plane = plane_of(package)
    assert not plane.active and plane.store is None
    assert plane.warm_start("d" * 64, object()) is False
    assert plane.report_cache_get("d" * 64, 1, 22, None) is None
    assert plane.persist_meta() is None


@pytest.mark.parametrize("package", PACKAGES)
def test_kill_switch_inerts_the_plane_both_ways(tmp_path, monkeypatch,
                                                package):
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST", "0")
    plane = plane_of(package)
    assert not plane.active and plane.store is None
    assert not os.listdir(str(tmp_path))
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST", "1")
    reset_knowledge_planes()
    plane = plane_of(package)
    assert plane.active and plane.store is not None


@pytest.mark.parametrize("package", PACKAGES)
def test_garbage_channel_payload_degrades_to_cold(tmp_path, monkeypatch,
                                                  package):
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    monkeypatch.setattr(port_args, "device", "cpu")
    plane = plane_of(package)
    digest = "a" * 64
    plane.store.put("channels", digest, b"\x80\x05garbage")
    assert plane.warm_start(digest, context_of(package)) is False
    assert (plane.thaw_errors, plane.warm_misses) == (1, 1)


def _jax_knowledge_body():
    """A knowledge body of the JAX package: its UNSAT memo holds one set
    and its recent models one model."""
    from mythril_tpu.parallel.gossip import freeze_knowledge
    from mythril_tpu.smt import UGT, ULT, symbol_factory, terms
    from mythril_tpu.smt.solver import reset_blast_context

    reset_blast_context()
    try:
        ctx = context_of("mythril_tpu")
        x = symbol_factory.BitVecSym("foreign_x", 16)
        nodes = (ULT(x, symbol_factory.BitVecVal(2, 16)).raw,
                 UGT(x, symbol_factory.BitVecVal(9, 16)).raw)
        ctx.note_unsat(nodes)
        ctx._remember_model(terms.EvalEnv(variables={x.raw.id: 5}))
        return freeze_knowledge(ctx)
    finally:
        reset_blast_context()


def test_a_jax_written_channel_body_degrades_the_port_to_cold(
        tmp_path, monkeypatch):
    """A channel record the JAX package wrote (its reducers name
    ``mythril_tpu`` functions) is refused by the port's thaw before
    anything of it is built: a cold start, one thaw error, no
    exception, and no memo entry or model of the JAX package's."""
    from mythril_tpu_torch.parallel import gossip
    from mythril_tpu_torch.smt.solver import reset_blast_context

    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    monkeypatch.setattr(port_args, "device", "cpu")
    body = _jax_knowledge_body()
    with pytest.raises(gossip.ForeignKnowledge, match="mythril_tpu"):
        gossip.thaw_knowledge(body)
    plane = plane_of("mythril_tpu_torch")
    plane.store.put("channels", "f" * 64, body)
    reset_blast_context()
    ctx = context_of("mythril_tpu_torch")
    assert plane.warm_start("f" * 64, ctx) is False
    assert plane.thaw_errors == 1
    assert not ctx.unsat_memo and not ctx.recent_models
    reset_blast_context()
    # a body of this package without its format tag is refused too
    from mythril_tpu_torch.resilience.checkpoint import dumps

    with pytest.raises(gossip.ForeignKnowledge, match="format"):
        gossip.thaw_knowledge(dumps({"unsat_sets": []}))


class _RowsOn:
    """Pickles as a tensor row of the journal's reducer, stored on
    ``device_type`` (the reducer the port's freeze would write)."""

    def __init__(self, array, device_type):
        self.array, self.device_type = array, device_type

    def __reduce__(self):
        from mythril_tpu_torch.resilience import checkpoint

        return checkpoint._tensor_from_host, (self.array, self.device_type)


def test_a_cpu_written_store_thaws_its_model_rows_on_the_cpu(
        tmp_path, monkeypatch):
    """Knowledge written by a CPU run warms a CPU run: its model comes
    back, its truth row stays behind (literal numbering belongs to the
    process that blasted it), and a tensor in a body is rebuilt on the
    CPU.  A body whose tensor was stored from the card is refused on
    the CPU (no silent move): a cold start."""
    import torch

    from mythril_tpu_torch.parallel import gossip
    from mythril_tpu_torch.resilience.checkpoint import dumps
    from mythril_tpu_torch.smt import symbol_factory, terms
    from mythril_tpu_torch.smt.solver import reset_blast_context

    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_FLUSH_S", "0")
    monkeypatch.setattr(port_args, "device", "cpu")
    reset_blast_context()
    ctx = context_of("mythril_tpu_torch")
    x = symbol_factory.BitVecSym("rows_x", 16)
    ctx._remember_model(terms.EvalEnv(variables={x.raw.id: 7}),
                        truth=np.array([0, 1, -1, 1], dtype=np.int8))
    plane = plane_of("mythril_tpu_torch")
    plane.absorb("c" * 64, ctx)
    assert segments_of(str(tmp_path))
    reset_knowledge_planes()
    reset_blast_context()
    ctx = context_of("mythril_tpu_torch")
    plane = plane_of("mythril_tpu_torch")
    assert plane.warm_start("c" * 64, ctx) is True
    x = symbol_factory.BitVecSym("rows_x", 16)
    (model,) = ctx.recent_models
    assert model.variables == {x.raw.id: 7}
    assert getattr(model, "truth_snapshot", None) is None
    rows = np.arange(6, dtype=np.int8)
    body = dumps({"format": gossip.KNOWLEDGE_FORMAT, "channels": {},
                  "rows": torch.from_numpy(rows)})
    back = gossip.KnowledgeUnpickler(io.BytesIO(body), "cpu").load()["rows"]
    assert back.device.type == "cpu" and back.tolist() == rows.tolist()
    card_body = dumps({"format": gossip.KNOWLEDGE_FORMAT, "channels": {},
                       "rows": _RowsOn(rows, "cuda")})
    with pytest.raises(gossip.ForeignKnowledge, match="cuda tensor"):
        gossip.thaw_knowledge(card_body)
    plane.store.put("channels", "e" * 64, card_body)
    assert plane.warm_start("e" * 64, ctx) is False
    assert plane.thaw_errors == 1
    reset_blast_context()


@pytest.mark.parametrize("package", PACKAGES)
def test_report_cache_key_includes_everything_that_changes_findings(
        tmp_path, monkeypatch, package):
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    plane = plane_of(package)
    digest = "b" * 64
    plane.report_cache_put(digest, 2, 128, ["suicide"],
                           {"findings_swc": ["106"], "partial": False})
    hit = plane.report_cache_get(digest, 2, 128, ["suicide"])
    assert hit and hit["findings_swc"] == ["106"]
    assert plane.report_cache_get(digest, 3, 128, ["suicide"]) is None
    assert plane.report_cache_get(digest, 2, 64, ["suicide"]) is None
    assert plane.report_cache_get(digest, 2, 128, ["ether_thief"]) is None
    assert plane.report_cache_get("c" * 64, 2, 128, ["suicide"]) is None
    stats = module(package, "resilience.telemetry").resilience_stats
    assert (plane.report_hits, plane.report_misses) == (1, 4)
    assert stats.persist_report_hits == 1


def test_report_cache_keys_are_the_same_in_both_packages():
    from mythril_tpu.persist.plane import KnowledgePlane as JaxPlane
    from mythril_tpu_torch.persist.plane import KnowledgePlane

    for args in (("b" * 64, 2, 128, ["suicide", "ether_thief"]),
                 ("c" * 64, 1, 22, None)):
        assert KnowledgePlane.report_key(*args) == JaxPlane.report_key(*args)


@pytest.mark.parametrize("package", PACKAGES)
def test_report_cache_refuses_partial_verdicts(tmp_path, monkeypatch,
                                               package):
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    plane = plane_of(package)
    plane.report_cache_put("d" * 64, 1, 22, None,
                           {"findings_swc": [], "partial": True})
    assert plane.report_cache_get("d" * 64, 1, 22, None) is None


@pytest.mark.parametrize("package", PACKAGES)
def test_heartbeat_delta_gating(tmp_path, monkeypatch, package):
    """The delta is sent once per change of the knowledge signature, on
    a fresh context (its made-up memo entry must not outlive the
    test)."""
    reset = module(package, "smt.solver").reset_blast_context
    monkeypatch.setattr(port_args, "device", "cpu")
    reset()
    ctx = context_of(package)
    assert plane_of(package).encode_heartbeat_delta(ctx) is None  # inert
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    reset_knowledge_planes()
    plane = plane_of(package)
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_GOSSIP", "0")
    assert plane.encode_heartbeat_delta(ctx) is None  # gossip off
    monkeypatch.delenv("MYTHRIL_TPU_PERSIST_GOSSIP")
    first = plane.encode_heartbeat_delta(ctx)
    assert isinstance(first, bytes) and first
    assert plane.encode_heartbeat_delta(ctx) is None  # nothing changed
    ctx.unsat_memo[(1, 2, 3)] = True
    assert plane.encode_heartbeat_delta(ctx)  # the signature moved
    assert plane.gossip_sent == 2
    reset()


def test_port_heartbeat_delta_applies_to_a_fresh_context(tmp_path,
                                                         monkeypatch):
    """The port's delta body is its freeze: applied to a fresh context
    it adds exactly the sender's memo entries and models, once."""
    from mythril_tpu_torch.parallel.gossip import apply_knowledge
    from mythril_tpu_torch.smt import UGT, ULT, symbol_factory, terms
    from mythril_tpu_torch.smt.solver import reset_blast_context

    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    monkeypatch.setattr(port_args, "device", "cpu")
    reset_blast_context()
    ctx = context_of("mythril_tpu_torch")
    x = symbol_factory.BitVecSym("delta_x", 16)
    lo = ULT(x, symbol_factory.BitVecVal(2, 16)).raw
    ctx.note_unsat((lo, UGT(x, symbol_factory.BitVecVal(9, 16)).raw))
    ctx.probe_memo[(lo.id,)] = terms.EvalEnv(variables={x.raw.id: 1})
    ctx._remember_model(terms.EvalEnv(variables={x.raw.id: 1}))
    body = plane_of("mythril_tpu_torch").encode_heartbeat_delta(ctx)
    reset_blast_context()
    fresh = context_of("mythril_tpu_torch")
    assert apply_knowledge(fresh, body) == {"unsat": 1, "probe_sat": 1,
                                            "models": 1}
    assert apply_knowledge(fresh, body)["unsat"] == 0  # monotone, once
    reset_blast_context()


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knob,value,rejected", [
    ("MYTHRIL_TPU_PERSIST_FLUSH_S", "-1", True),
    ("MYTHRIL_TPU_PERSIST_FLUSH_S", "abc", True),
    ("MYTHRIL_TPU_PERSIST_FLUSH_S", "0", False),
    ("MYTHRIL_TPU_PERSIST_CAP_MB", "0.5", True),
    ("MYTHRIL_TPU_PERSIST_CAP_MB", "64", False),
    ("MYTHRIL_TPU_PERSIST", "maybe", True),
    ("MYTHRIL_TPU_PERSIST", "0", False),
    ("MYTHRIL_TPU_PERSIST_GOSSIP", "often", True),
    ("MYTHRIL_TPU_PERSIST_GOSSIP", "off", False),
])
def test_persist_knobs_validate_as_in_jax(knob, value, rejected):
    from mythril_tpu.support import env as jax_env
    from mythril_tpu_torch.support import env as port_env

    for env in (jax_env, port_env):
        try:
            env.validate_env({knob: value})
        except env.EnvSpecError:
            assert rejected, (env.__name__, knob, value)
        else:
            assert not rejected, (env.__name__, knob, value)


def test_persist_dir_knob_rejects_a_non_directory(tmp_path):
    from mythril_tpu.support import env as jax_env
    from mythril_tpu_torch.support import env as port_env

    file_path = tmp_path / "not-a-dir"
    file_path.write_text("x")
    for env in (jax_env, port_env):
        with pytest.raises(env.EnvSpecError, match="not a directory"):
            env.validate_env({"MYTHRIL_TPU_PERSIST_DIR": str(file_path)})
        env.validate_env({"MYTHRIL_TPU_PERSIST_DIR": str(tmp_path / "x")})
        env.validate_env({"MYTHRIL_TPU_PERSIST_DIR": str(tmp_path)})


@pytest.mark.parametrize("knob,value", [
    ("MYTHRIL_TPU_PERSIST_FLUSH_S", "never"),
    ("MYTHRIL_TPU_PERSIST_CAP_MB", "0"),
    ("MYTHRIL_TPU_PERSIST", "maybe"),
])
def test_a_bad_persist_knob_exits_2_from_the_cli(monkeypatch, capsys, knob,
                                                 value):
    monkeypatch.setenv(knob, value)
    with kept_deadlines(), pytest.raises(SystemExit) as done:
        port_cli.main(["analyze", "-c", "0x00", "--bin-runtime",
                       "--no-onchain-data", "--device", "cpu"])
    assert done.value.code == 2
    assert capsys.readouterr().err.startswith(
        f"bad environment knob: {knob}")


# ---------------------------------------------------------------------------
# end to end: cold, warm and corrupted-cold on both packages
# ---------------------------------------------------------------------------


@pytest.fixture
def pins(monkeypatch):
    with analysis_pins(monkeypatch):
        yield


def recorded_thaws(monkeypatch):
    """Both packages' ``apply_knowledge`` wrapped to record what each
    warm start thawed (+unsat, +probe, +models)."""
    thaws = {package: [] for package in PACKAGES}
    for package in PACKAGES:
        gossip = module(package, "parallel.gossip")

        def recording(ctx, body, _apply=gossip.apply_knowledge,
                      _out=thaws[package]):
            applied = _apply(ctx, body)
            _out.append(applied)
            return applied

        monkeypatch.setattr(gossip, "apply_knowledge", recording)
    return thaws


def persisted_run(monkeypatch, package, directory, code, tx_count):
    """One analysis of ``code`` on ``package`` with its store in
    ``directory`` (flushed at the end); what the parity compares, with
    the plane's and the funnel's persist counters."""
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", directory)
    out = _run(SIDES[package], code, tx_count)
    plane = plane_of(package)
    stats = module(package, "ops.batched_sat").dispatch_stats
    out["persist"] = {
        "warm_hits": plane.warm_hits, "warm_misses": plane.warm_misses,
        "thaw_errors": plane.thaw_errors,
        "stats": (stats.persist_warm_hits, stats.persist_warm_misses),
        "corrupt_segments": plane.store.corrupt_segments,
    }
    return out


def bit_flip_every_segment(directory):
    for name in segments_of(directory):
        path = os.path.join(directory, name)
        with open(path, "rb") as fh:
            raw = bytearray(fh.read())
        raw[len(raw) // 2] ^= 0xFF
        with open(path, "wb") as fh:
            fh.write(bytes(raw))


PARITY_KEYS = ("issues", "total_states", "presplit_states", "prunes",
               "dispatches", "sweeps", "counters", "ledger", "autopilot",
               "persist")


#: (contract, transactions, runs): killbilly cold, warm and
#: corrupted-cold; scale_mul d4 -t 1 (about 16 s a run here on each
#: side) cold and warm, so that the file keeps under two minutes
END_TO_END = {
    "killbilly": (bench._corpus()[0][1], 1, ("cold", "warm", "corrupt")),
    "scale_mul d4 -t 1": (bench.scale_contract(4, 16, "mul"), 1,
                          ("cold", "warm")),
}


@pytest.mark.parametrize("name", sorted(END_TO_END))
def test_cold_warm_and_corrupted_runs_match_jax(tmp_path, monkeypatch,
                                                pins, name):
    code, tx_count, phases = END_TO_END[name]
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_FLUSH_S", "0")
    thaws = recorded_thaws(monkeypatch)
    runs = {package: {} for package in PACKAGES}
    for phase in phases:
        reset_knowledge_planes()  # a process restart on the same store
        for package in PACKAGES:
            directory = str(tmp_path / package)
            if phase == "corrupt":
                bit_flip_every_segment(directory)
            runs[package][phase] = persisted_run(
                monkeypatch, package, directory, code, tx_count)
            if phase == "cold":
                assert segments_of(directory), (package, "nothing flushed")
        got = runs["mythril_tpu_torch"][phase]
        want = runs["mythril_tpu"][phase]
        for key in PARITY_KEYS:
            assert got[key] == want[key], (phase, key)
    port = runs["mythril_tpu_torch"]
    for phase in phases:
        assert {i["swc_id"] for i in port[phase]["issues"]} == {"106"}
        assert port[phase]["issues"] == port["cold"]["issues"]
        assert port[phase]["total_states"] == port["cold"]["total_states"]
    assert port["cold"]["persist"]["warm_misses"] == 1
    assert port["warm"]["persist"]["warm_hits"] == 1
    assert port["warm"]["persist"]["stats"] == (1, 0)
    if "corrupt" in port:
        corrupt = port["corrupt"]["persist"]
        assert corrupt["warm_hits"] == 0
        assert corrupt["corrupt_segments"] >= 1
    assert thaws["mythril_tpu_torch"] == thaws["mythril_tpu"]
    assert len(thaws["mythril_tpu_torch"]) == 1
    assert thaws["mythril_tpu_torch"][0]["models"] > 0


@pytest.mark.parametrize("package", PACKAGES)
def test_kill_switch_with_a_directory_leaves_it_empty(tmp_path, monkeypatch,
                                                      pins, package):
    """``MYTHRIL_TPU_PERSIST=0`` with a directory named runs the
    in-memory path: the findings of a run without a directory, and not
    a file in the directory."""
    code = bench._corpus()[0][1]
    baseline = _run(SIDES[package], code, 1)
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST", "0")
    monkeypatch.setenv("MYTHRIL_TPU_PERSIST_DIR", str(tmp_path))
    reset_knowledge_planes()
    killed = _run(SIDES[package], code, 1)
    assert killed["issues"] == baseline["issues"]
    assert killed["total_states"] == baseline["total_states"]
    assert not os.listdir(str(tmp_path))
    plane = plane_of(package)
    assert plane.warm_hits == plane.warm_misses == 0


def test_two_cli_processes_share_the_store(tmp_path):
    """Two ``python3 -m mythril_tpu_torch analyze --persist-dir D``
    processes: the second's jsonv2 carries ``meta.resilience.persist``
    with its warm hit, and both report SWC-106."""
    hexfile = tmp_path / "killbilly.hex"
    hexfile.write_text(bench._corpus()[0][1])
    store = tmp_path / "store"
    env = dict(os.environ)
    for name in PERSIST_KNOBS:
        env.pop(name, None)
    metas = []
    for _ in range(2):
        run = subprocess.run(
            [sys.executable, "-m", "mythril_tpu_torch", "analyze", "-f",
             str(hexfile), "--bin-runtime", "-t", "1", "--no-onchain-data",
             "--device", "cpu", "-o", "jsonv2", "--persist-dir",
             str(store)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        report = json.loads(run.stdout)[0]
        assert [i["swcID"] for i in report["issues"]] == ["SWC-106"]
        metas.append(report["meta"]["resilience"]["persist"])
    assert (metas[0]["warm_hits"], metas[0]["warm_misses"]) == (0, 1)
    assert (metas[1]["warm_hits"], metas[1]["warm_misses"]) == (1, 0)
    assert metas[1]["dir"] == str(store) and metas[1]["epoch"] == 2
    assert len(segments_of(str(store))) == 2  # each process flushed once
