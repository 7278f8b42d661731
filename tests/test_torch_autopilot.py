"""The port's autopilot (``mythril_tpu_torch/autopilot``) against the JAX
package's (``mythril_tpu/autopilot``), on the CPU.

Each case feeds both packages the same inputs and holds the outputs
equal: the feature vectors and signatures of constraint sets built from
a numpy seed through each package's own smt, the cost model's cells
after one observation stream, the policy's decisions, the tuner's
overrides, steps and reverts, the segment router's answers to the same
walls, the offline replay of a recorded artifact, the routes, ladder
rungs and ledger records of the funnel and of ``BlastContext.check``,
and one analysis at a low sample floor.
Then the port alone: the tuner's overrides reach the four knob getters
(an env pin wins, the kill switch restores the defaults), and the
autopilot resets with the blast context.
"""

import importlib
import os

import numpy as np
import pytest

from test_torch_analyze import _parity, analysis_pins, fresh_planes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "lane_ledger_v2.json")
PACKAGES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}

#: every knob the autopilot and the knob getters read, unset per case
KNOB_VARS = (
    "MYTHRIL_TPU_AUTOPILOT", "MYTHRIL_TPU_AUTOPILOT_POLICY",
    "MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES", "MYTHRIL_TPU_AUTOPILOT_LADDER",
    "MYTHRIL_TPU_AUTOPILOT_TAIL_SHARE", "MYTHRIL_TPU_AUTOPILOT_EVAL_EVERY",
    "MYTHRIL_TPU_LEDGER", "MYTHRIL_TPU_FRONTIER_FAN",
    "MYTHRIL_TPU_FRONTIER_PERIOD", "MYTHRIL_TPU_TIER_PERIOD",
    "MYTHRIL_TPU_COALESCE_WINDOW", "MYTHRIL_TPU_SEG_CEIL_MS",
)


def mod(side, name):
    """Module ``name`` of ``side``'s package."""
    return importlib.import_module(f"{PACKAGES[side]}.{name}")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """No autopilot knob set; both packages' autopilots, ledgers and
    tracers made afresh before the case and dropped after it."""
    for var in KNOB_VARS:
        monkeypatch.delenv(var, raising=False)
    with fresh_planes():
        yield


# ---------------------------------------------------------------------------
# constraint sets from a seed, realized in either package
# ---------------------------------------------------------------------------

#: term shapes of :func:`random_specs` (binary op of two operands)
OPS = ("add", "sub", "mul", "and", "or", "xor", "ite", "udiv", "shl",
       "concat")
RELS = ("eq", "ult", "ugt", "ne", "slt")


def random_specs(seed, lanes=24):
    """Constraint-set specs drawn from ``seed`` (pure numpy): per lane, a
    width, its variable names and a few (op, rel, operand) picks."""
    rng = np.random.default_rng(seed)
    specs = []
    for lane in range(lanes):
        width = int(rng.choice([8, 16, 64, 256]))
        names = [f"s{seed}l{lane}v{j}" for j in range(int(rng.integers(1, 4)))]
        cons = []
        for _ in range(int(rng.integers(1, 5))):
            cons.append((OPS[int(rng.integers(len(OPS)))],
                         RELS[int(rng.integers(len(RELS)))],
                         int(rng.integers(len(names))),
                         int(rng.integers(len(names))),
                         int(rng.integers(0, 1 << 30))))
        specs.append((width, names, cons))
    return specs


def realize(side, specs):
    """The specs as lists of raw term nodes of ``side``'s smt."""
    smt = mod(side, "smt")
    f = smt.symbol_factory
    sets = []
    for width, names, cons in specs:
        xs = [f.BitVecSym(n, width) for n in names]
        nodes = []
        for op, rel, ia, ib, k in cons:
            a, b = xs[ia], xs[ib]
            v = f.BitVecVal(k % (1 << width), width)
            term = {
                "add": lambda: a + v, "sub": lambda: a - b,
                "mul": lambda: a * b, "and": lambda: a & v,
                "or": lambda: a | b, "xor": lambda: a ^ v,
                "ite": lambda: smt.If(smt.ULT(a, v), b, v),
                "udiv": lambda: smt.UDiv(a, v + 1),
                "shl": lambda: a << (v & 7),
                "concat": lambda: smt.Extract(
                    width - 1, 0, smt.Concat(a, b)),
            }[op]()
            constraint = {
                "eq": lambda: term == v, "ult": lambda: smt.ULT(term, v),
                "ugt": lambda: smt.UGT(term, b), "ne": lambda: term != b,
                "slt": lambda: smt.SLT(term, v),
            }[rel]()
            nodes.append(constraint.raw)
        sets.append(nodes)
    return sets


@pytest.fixture
def contexts():
    """Both packages' blast contexts (and term interners) made afresh
    for the case and dropped after it."""
    for side in PACKAGES:
        mod(side, "smt.solver").reset_blast_context()
    yield
    for side in PACKAGES:
        mod(side, "smt.solver").reset_blast_context()


# ---------------------------------------------------------------------------
# the modules, one input stream each
# ---------------------------------------------------------------------------


def test_constants_and_tables_match_jax():
    """The port's features, model, policy and tuner tables are the JAX
    package's: op classes, feature version, EWMA constants, signature
    cap, knob table, tuner constants and policy names."""
    for name, attrs in (
        ("autopilot.features", ("FEATURE_VERSION", "OP_CLASS", "OP_CLASSES",
                                "_VAR_OPS", "_CONST_OPS", "_MEMO_CAP")),
        ("autopilot.model", ("ALPHA", "MAX_SIGNATURES")),
        ("autopilot.tuner", ("ALPHA", "REVERT_TOL", "COOLDOWN_WINDOWS",
                             "QUEUE_DEEP")),
        ("autopilot.policy", ("DEFAULT_POLICY",)),
        ("autopilot", ("_SEG_CEIL_MS_DEFAULT", "_SEG_MIN_SAMPLES")),
        ("autopilot.replay", ("SUPPORTED_SCHEMAS",)),
    ):
        for attr in attrs:
            assert (getattr(mod("port", name), attr)
                    == getattr(mod("jax", name), attr)), (name, attr)
    assert ({k: tuple(v) for k, v in mod("port", "autopilot.tuner")
             .KNOBS.items()}
            == {k: tuple(v) for k, v in mod("jax", "autopilot.tuner")
                .KNOBS.items()})
    assert (sorted(mod("port", "autopilot.policy").POLICIES)
            == sorted(mod("jax", "autopilot.policy").POLICIES))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_features_match_jax(contexts, seed):
    """Constraint sets built from a seed through each package's smt give
    equal feature vectors (with and without a transaction depth) and
    equal signatures, memoized per set on both sides."""
    specs = random_specs(seed)
    vectors = {}
    for side in PACKAGES:
        feat = mod(side, "autopilot.features")
        sets = realize(side, specs)
        vectors[side] = [(feat.lane_features(nodes),
                          feat.lane_features(nodes, tx=seed),
                          feat.feature_signature(
                              feat.lane_features(nodes, tx=seed)))
                         for nodes in sets]
        assert len(feat._memo) == len({tuple(sorted(n.id for n in nodes))
                                       for nodes in sets})
    assert vectors["port"] == vectors["jax"]
    classes = {c for plain, _t, _s in vectors["jax"]
               for c, n in plain["ops"].items() if n}
    assert {"arith", "cmp", "bit", "bool"} <= classes


def test_segment_features_and_signatures_match_jax():
    rng = np.random.default_rng(7)
    for _ in range(64):
        args = (int(rng.integers(1, 300)), int(rng.integers(0, 200)),
                float(rng.random()),
                tuple(k for k in ("keccak", "mem", "storage")
                      if rng.random() < 0.4))
        got = [mod(s, "autopilot.features").segment_features(*args)
               for s in PACKAGES]
        assert got[0] == got[1]
        assert (mod("port", "autopilot.features").feature_signature(got[1])
                == mod("jax", "autopilot.features").feature_signature(
                    got[0]))


def observation_stream(seed, n=400):
    """(signature, tier, decided, wall) observations from a seed."""
    rng = np.random.default_rng(seed)
    tiers = ("structural", "probe", "word", "frontier", "sweep", "tail",
             "lockstep")
    return [(f"sig{int(rng.integers(0, 40))}",
             tiers[int(rng.integers(len(tiers)))], bool(rng.random() < 0.6),
             float(rng.random()) * 1e-3) for _ in range(n)]


def test_cost_model_matches_jax():
    """One observation stream into both cost models: equal cells (counts
    and EWMAs), tail shares, decide rates and wall shares; past
    ``MAX_SIGNATURES`` both evict the same buckets."""
    models = {s: mod(s, "autopilot.model").CostModel() for s in PACKAGES}
    stream = observation_stream(3)
    stream += [(f"bulk{i}", "word", True, 0.0) for i in range(
        mod("jax", "autopilot.model").MAX_SIGNATURES)]
    for obs in stream:
        for model in models.values():
            model.observe(*obs)
    snaps = {s: m.snapshot(top=10_000) for s, m in models.items()}
    assert snaps["port"] == snaps["jax"]
    for sig in sorted({o[0] for o in stream})[:50]:
        for query in ("tail_share", "samples"):
            assert (getattr(models["port"], query)(sig)
                    == getattr(models["jax"], query)(sig))
        for tier in ("word", "tail", "lockstep"):
            for query in ("decide_rate", "wall_share", "tier_count",
                          "tier_decided"):
                assert (getattr(models["port"], query)(sig, tier)
                        == getattr(models["jax"], query)(sig, tier))


@pytest.mark.parametrize("min_samples", ["4", "24"])
def test_policy_decisions_match_jax(monkeypatch, min_samples):
    """The shipped policy on both sides over one stream of lanes (each
    decision asked before its observation is folded, as the live funnel
    and the replay do): the same decisions, every rule among them."""
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES", min_samples)
    rng = np.random.default_rng(11)
    tiers = ("structural", "probe", "word", "frontier", "tail")
    lanes = []
    for _ in range(600):
        shape = int(rng.integers(0, 6))
        features = {"v": 1, "constraints": shape + 1, "nodes": 4 << shape,
                    "vars": 1, "max_width": 16,
                    "ops": {"cmp": 1, "arith": shape % 2}}
        # shapes 0-1 always tail, 2-3 decide early, the rest mix
        tier = ("tail" if shape < 2 else "probe" if shape < 4
                else tiers[int(rng.integers(len(tiers)))])
        lanes.append((features, tier))
    decisions = {}
    for side in PACKAGES:
        policy = mod(side, "autopilot.policy").make_policy(None)
        model = mod(side, "autopilot.model").CostModel()
        signature = mod(side, "autopilot.features").feature_signature
        out = []
        for features, tier in lanes:
            out.append(tuple(policy.decide(features, model)))
            model.observe(signature(features), tier, tier != "tail")
        decisions[side] = out
        static = mod(side, "autopilot.policy").make_policy("static")
        assert static.decide(lanes[0][0], model).routed_by is None
        with pytest.raises(ValueError):
            mod(side, "autopilot.policy").make_policy("no-such-policy")
    assert decisions["port"] == decisions["jax"]
    rules = {d[3] for d in decisions["jax"] if d[3]}
    assert {"word-skip+tail-direct", "ladder"} <= rules


@pytest.mark.parametrize("pins", [(), ("MYTHRIL_TPU_FRONTIER_FAN",),
                                  ("MYTHRIL_TPU_FRONTIER_FAN",
                                   "MYTHRIL_TPU_FRONTIER_PERIOD",
                                   "MYTHRIL_TPU_TIER_PERIOD")])
def test_tuner_matches_jax(monkeypatch, pins):
    """One stream of (tail share, queue depth) observations into both
    tuners: after every observation the same overrides, steps, reverts,
    pending knob and cooldowns; steps happen (and reverts, unless only
    the coalesce window is free), and a pinned knob is never stepped."""
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_EVAL_EVERY", "2")
    for pin in pins:
        monkeypatch.setenv(pin, "8")
    rng = np.random.default_rng(5)
    stream = []
    tail = 40.0
    for _ in range(240):
        tail = min(100.0, max(0.0, tail + float(rng.normal(0, 6))))
        stream.append((None if rng.random() < 0.03 else tail,
                       int(rng.integers(0, 20))))
    tuners = {s: mod(s, "autopilot.tuner").OnlineTuner() for s in PACKAGES}
    for tail_pct, depth in stream:
        for tuner in tuners.values():
            tuner.observe(tail_pct, depth)
        assert (tuners["port"].debug_state()
                == tuners["jax"].debug_state())
    state = tuners["jax"].debug_state()
    assert state["adjustments"] > 0
    assert state["reverts"] > 0 or len(pins) == 3  # the window only
    knobs = mod("jax", "autopilot.tuner").KNOBS
    stepped = set(state["overrides"]) | set(state["cooldown"])
    assert not stepped & {n for n, k in knobs.items() if k.env in pins}


def test_segment_router_matches_jax(monkeypatch):
    """``route_segment`` / ``note_segment`` on both sides fed the same
    shapes and walls: the same answers and counters, declines among them
    once a shape's per-lane wall passes ``MYTHRIL_TPU_SEG_CEIL_MS``."""
    monkeypatch.setenv("MYTHRIL_TPU_SEG_CEIL_MS", "5")
    rng = np.random.default_rng(9)
    answers = {s: [] for s in PACKAGES}
    for _ in range(200):
        # four shapes, two of them slow per lane, with a little jitter
        shape = int(rng.integers(0, 4))
        lanes, ops = ((2, 8), (2, 16), (4, 8), (4, 16))[shape]
        args = (lanes, ops, 0.5)
        wall = (0.02 if shape % 2 else 0.001) * lanes * (
            0.5 + float(rng.random()))
        for side in PACKAGES:
            pilot = mod(side, "autopilot")
            features = mod(side, "autopilot.features").segment_features(*args)
            answers[side].append(pilot.route_segment(features))
            pilot.note_segment(features, lanes, wall)
    assert answers["port"] == answers["jax"]
    counters = [mod(s, "autopilot").counters_snapshot() for s in PACKAGES]
    assert counters[0] == counters[1]
    assert counters[0]["segments_declined"] > 0
    assert counters[0]["segments_seen"] == 200


@pytest.mark.parametrize("policy", [None, "static"])
def test_fixture_replays_alike(policy):
    """The recorded artifact of the JAX package's tests replays through
    both ``replay.py`` modules to the same decision stream (the same
    digest), run twice on each side."""
    results = [mod(s, "autopilot.replay").replay_artifact(FIXTURE, policy)
               for s in PACKAGES for _ in range(2)]
    assert all(r == results[0] for r in results)
    assert results[0]["records"] == results[0]["with_features"] > 0


def test_replay_of_seeded_records_matches_jax(monkeypatch, tmp_path):
    """Seeded records (features, tiers, verdicts) replay alike through
    both modules at a low sample floor, with routes among the decisions;
    an unknown schema is refused by both."""
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES", "3")
    rng = np.random.default_rng(13)
    records = []
    for i in range(300):
        shape = int(rng.integers(0, 5))
        tier = ("tail" if shape == 0 else "probe" if shape == 1
                else str(rng.choice(["word", "tail", "frontier"])))
        records.append({
            "id": i, "tier": tier,
            "verdict": "undecided" if tier == "tail" else "sat",
            "features": None if rng.random() < 0.05 else {
                "v": 1, "constraints": shape + 1, "nodes": 3 << shape,
                "vars": 1, "consts": 1, "max_width": 16,
                "ops": {"cmp": 1, "arith": 0, "bit": shape % 2,
                        "bool": 0, "mem": 0, "other": 0}, "tx": 1}})
    got = [mod(s, "autopilot.replay").replay_records(records)
           for s in PACKAGES]
    assert got[0] == got[1] and got[0]["routed"] > 0
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": "nope", "records": []}')
    for side in PACKAGES:
        with pytest.raises(ValueError):
            mod(side, "autopilot.replay").load_artifact(str(bad))


# ---------------------------------------------------------------------------
# through the funnel and the CDCL tail
# ---------------------------------------------------------------------------


@pytest.fixture
def funnels(monkeypatch, contexts):
    """Both funnels force-dispatched, the JAX dense tier off and the
    port's tiers on the CPU; the JAX package on one device."""
    import jax

    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.support.support_args import (
        FORCE_DISPATCH_ARGS, SLICE_PINS_ARGS,
    )
    from mythril_tpu_torch.support.support_args import args as port_args

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.setenv("MYTHRIL_TPU_PALLAS", "0")
    for name, value in {**SLICE_PINS_ARGS, **FORCE_DISPATCH_ARGS}.items():
        monkeypatch.setattr(jax_args, name, value)
    for name, value in FORCE_DISPATCH_ARGS.items():
        monkeypatch.setattr(port_args, name, value)
    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "device_min_lanes", 2)
    monkeypatch.setattr(port_args, "device", "cpu")
    for side in PACKAGES:
        mod(side, "ops.batched_sat").dispatch_stats.reset()
        mod(side, "smt").SolverStatistics().reset()
    yield


def funnel_run(side, sets, rounds):
    """``rounds`` passes of ``batch_check_states`` over ``sets`` on
    ``side`` (the port's on the CPU, without its tail, as the JAX funnel
    runs), then every set through ``BlastContext.check``: the verdicts,
    the ledger records (ids aside) and aggregates (walls aside), and the
    autopilot's counters."""
    bs = mod(side, "ops.batched_sat")
    ctx = mod(side, "smt.solver").get_blast_context()
    kwargs = {"device": "cpu", "tail": False} if side == "port" else {}
    verdicts = [bs.batch_check_states(sets, **kwargs) for _ in range(rounds)]
    statuses = [ctx.check(nodes)[0] for nodes in sets]
    led = mod(side, "observability.ledger").get_ledger()
    snap = led.snapshot()
    snap.pop("tier_wall_s")
    records = [{k: v for k, v in r.items() if k != "id"} for r in led.records]
    return (verdicts, statuses, snap, records,
            mod(side, "autopilot").counters_snapshot())


def test_funnel_routes_and_ladder_match_jax(funnels, monkeypatch):
    """Seeded frontiers through both funnels and both CDCL tails with a
    low sample floor: the same verdicts, the same ledger (records with
    their features and routes, aggregates) and the same autopilot
    counters; the JAX side routes lanes and runs ladder rungs."""
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES", "2")
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_EVAL_EVERY", "2")
    specs = random_specs(21, lanes=12)
    got = {}
    for side in PACKAGES:
        got[side] = funnel_run(side, realize(side, specs), 4)
    assert got["port"] == got["jax"]
    counters = got["jax"][4]
    assert counters["lanes_routed"] > 0
    assert counters["tuner_adjustments"] > 0
    assert got["jax"][2]["routed"]


@pytest.mark.parametrize("tx", [None, 1])
def test_tail_ladder_matches_jax(funnels, monkeypatch, tx):
    """With the probe and the word tier off the funnel's device tiers
    decide the seeded lanes; their shapes, predicted easy, take the
    bounded first rung in ``BlastContext.check`` on both sides alike
    (the query's features carry no transaction depth, as in the JAX
    package: under ``set_origin(tx_index=1)`` the funnel's cells differ
    from the query's, and no rung runs)."""
    from mythril_tpu.support.support_args import args as jax_args
    from mythril_tpu_torch.support.support_args import args as port_args

    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES", "2")
    monkeypatch.setenv("MYTHRIL_TPU_WORD_TIER", "0")
    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "word_probing", False)
    specs = random_specs(22, lanes=12)
    got = {}
    for side in PACKAGES:
        mod(side, "observability.ledger").set_origin(tx_index=tx)
        got[side] = funnel_run(side, realize(side, specs), 3)
    assert got["port"] == got["jax"]
    counters = got["jax"][4]
    assert (counters.get("ladder_solves", 0) > 0) == (tx is None)
    assert all(r["features"].get("tx") == tx for r in got["jax"][3]
               if r["features"])


def test_kill_switch_pins_the_static_funnel(funnels, monkeypatch):
    """``MYTHRIL_TPU_AUTOPILOT=0`` on both sides: no features, no route,
    no ladder, no counters; the same verdicts as the routed runs."""
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES", "2")
    specs = random_specs(21, lanes=12)
    routed = {}
    for side in PACKAGES:
        routed[side] = funnel_run(side, realize(side, specs), 2)
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT", "0")
    for side in PACKAGES:
        mod(side, "smt.solver").reset_blast_context()
        mod(side, "observability.ledger").reset_for_tests()
        static = funnel_run(side, realize(side, specs), 2)
        assert static[0] == routed[side][0]
        assert static[4] == {}
        assert all(r["features"] is None and r["routed_by"] is None
                   for r in static[3])


def test_autopilot_routes_alike_at_a_low_sample_floor(monkeypatch):
    """The autopilot's policy and tuner at a sample floor of 4 and an
    evaluation window of 2 batches, on both sides (the JAX defaults, 24
    and 8, route little on contracts this small): on the scale contract
    the JAX package routes lanes past the word tier and steps the tuner
    (and reverts); ``_parity`` holds the findings, the ledgers (routes
    included), the autopilot's counters and the tuner's overrides equal.
    No ladder rung runs on this path in either package: the funnel's
    cells carry the transaction depth (``set_origin`` in ``svm``) and
    ``BlastContext.check``'s query features do not, so its routes never
    find samples (:func:`test_tail_ladder_matches_jax` runs the rung)."""
    import bench

    with analysis_pins(monkeypatch):
        monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_MIN_SAMPLES", "4")
        monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT_EVAL_EVERY", "2")
        jax, _port = _parity(
            bench.scale_contract(depth=3, guard_bits=16, guard="mul"), 1)
    counters = jax["autopilot"]["counters"]
    assert counters["tuner_adjustments"] > 0 and counters["tuner_reverts"] > 0
    assert counters["ladder_solves"] == 0
    assert counters["lanes_routed"] == counters["word_skips"] > 0
    assert jax["ledger"]["aggregates"]["routed"]


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def test_tuner_override_reaches_the_four_knob_getters(monkeypatch):
    """``knob_override`` reaches the frontier solvers' fan and period,
    the dense round's tier period and the coalescer's window, read
    afresh on every call; an env pin wins; the kill switch restores
    every static default."""
    from mythril_tpu_torch import autopilot
    from mythril_tpu_torch.ops.coalesce import COALESCE_WINDOW, _window
    from mythril_tpu_torch.ops.dense_prop import TIER_PERIOD, _tier_period
    from mythril_tpu_torch.ops.frontier import (
        DEFAULT_FAN, DEFAULT_PERIOD, frontier_fan, frontier_period,
    )

    getters = {"frontier_fan": frontier_fan,
               "frontier_period": frontier_period,
               "tier_period": _tier_period, "coalesce_window": _window}
    defaults = {"frontier_fan": DEFAULT_FAN,
                "frontier_period": DEFAULT_PERIOD,
                "tier_period": TIER_PERIOD,
                "coalesce_window": COALESCE_WINDOW}
    assert {k: g() for k, g in getters.items()} == defaults
    tuned = {"frontier_fan": 24, "frontier_period": 6, "tier_period": 4,
             "coalesce_window": 1}
    autopilot.get_autopilot().tuner._overrides.update(tuned)
    assert {k: g() for k, g in getters.items()} == tuned
    monkeypatch.setenv("MYTHRIL_TPU_FRONTIER_FAN", "12")
    monkeypatch.setenv("MYTHRIL_TPU_COALESCE_WINDOW", "3")
    assert frontier_fan() == 12 and _window() == 3
    assert frontier_period() == 6 and _tier_period() == 4
    monkeypatch.delenv("MYTHRIL_TPU_FRONTIER_FAN")
    monkeypatch.delenv("MYTHRIL_TPU_COALESCE_WINDOW")
    monkeypatch.setenv("MYTHRIL_TPU_AUTOPILOT", "0")
    assert {k: g() for k, g in getters.items()} == defaults


def test_solves_read_the_tuned_knobs(monkeypatch):
    """The frontier round and the resident solve build their kernel
    configuration from the getters on every call: a tuner override
    lands in the next solve's ``StepConfig``."""
    from mythril_tpu_torch import autopilot
    from mythril_tpu_torch.ops import frontier as FR
    from mythril_tpu_torch.ops import frontier_kernels as FK
    from mythril_tpu_torch.ops import resident as RK

    seen = []

    def config(**kw):
        seen.append((kw["fan"], kw["period"]))
        raise StopIteration

    monkeypatch.setattr(FK, "StepConfig", config)
    state = {"learned": np.zeros((1, 2, 8), np.int32),
             "extra": np.zeros((3, 8), np.int32)}
    pilot = autopilot.get_autopilot()
    for fan, period in ((16, 8), (24, 6)):
        pilot.tuner._overrides.update(frontier_fan=fan,
                                      frontier_period=period)
        for solve in (lambda: FR.frontier_round(None, None, state, 64),
                      lambda: RK.resident_solve(None, None, state)):
            with pytest.raises(StopIteration):
                solve()
    assert seen == [(16, 8), (16, 8), (24, 6), (24, 6)]


def test_autopilot_resets_with_the_blast_context():
    """The cost model is per workload, as in the JAX package: resetting
    the blast context drops the autopilot and its feature memo on both
    sides."""
    for side in PACKAGES:
        pilot_mod = mod(side, "autopilot")
        pilot = pilot_mod.get_autopilot()
        pilot.model.observe("sig", "tail", False)
        mod(side, "autopilot.features")._memo[(1,)] = {}
        mod(side, "smt.solver").reset_blast_context()
        assert pilot_mod._autopilot is None
        assert not mod(side, "autopilot.features")._memo
        ledger = mod(side, "observability.ledger")
        assert pilot._on_batch not in ledger._batch_observers
