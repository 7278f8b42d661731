"""The funnel's default dispatch rungs of the port (the profit gate, the
async prefetch of ``ops/async_dispatch.py`` and the coalescer of
``ops/coalesce.py``) against the JAX package's, on the CPU.

The timing seams are pinned on both sides, never by editing the JAX
package: the gate's ``device_min_save_s`` is 0 (it never declines) or
1e9 (it always declines), the coalescer's queue age is out of reach
(or, for the stale case, always past), the slow-dispatch fuse and the
JAX dispatch watchdog are out of reach, and a fixture joins each side's
prefetch worker right after ``launch``, so every harvest finds its
batch done.  The JAX side sees one device, as the port runs on one."""

import numpy as np
import pytest
import torch

import mythril_tpu.smt as JS
import mythril_tpu_torch.smt as PS
from mythril_tpu.ops import async_dispatch as jax_ad
from mythril_tpu.ops import batched_sat as jax_bs
from mythril_tpu.ops import coalesce as jax_co
from mythril_tpu.smt.solver import get_blast_context as jax_context
from mythril_tpu.smt.solver import reset_blast_context as jax_reset
from mythril_tpu.support.support_args import args as jax_args
from mythril_tpu_torch import frontiers
from mythril_tpu_torch.ops import async_dispatch as port_ad
from mythril_tpu_torch.ops import batched_sat as port_bs
from mythril_tpu_torch.ops import coalesce as port_co
from mythril_tpu_torch.ops import round_lane as port_rl
from mythril_tpu_torch.smt.solver import get_blast_context as port_context
from mythril_tpu_torch.smt.solver import reset_blast_context as port_reset
from mythril_tpu_torch.support.support_args import (
    SLICE_PINS_ARGS,
    SLICE_PINS_CPU_ENV,
    SLICE_PINS_ENV,
)
from mythril_tpu_torch.support.support_args import args as port_args
from test_torch_analyze import DETERMINISTIC_ENV, fresh_planes, kept_deadlines

#: the async counters both packages keep
ASYNC_FIELDS = ("launches", "harvested", "unsat", "models", "dropped")
#: the rungs' dispatch counters both packages keep
RUNG_FIELDS = ("dispatches", "lanes", "unsat", "sat_verified", "undecided",
               "profit_skips", "coalesced_dispatches", "coalesced_lanes",
               "coalesce_deferred")

SIDES = {
    "jax": dict(S=JS, bs=jax_bs, ad=jax_ad, reset=jax_reset,
                context=jax_context, args=jax_args, kwargs={}),
    "port": dict(S=None, bs=port_bs, ad=port_ad, reset=port_reset,
                 context=port_context, args=port_args,
                 kwargs={"device": "cpu", "tail": False}),
}


def _joined(launch):
    def launch_and_join(self, *args, **kwargs):
        launched = launch(self, *args, **kwargs)
        if self._live_thread is not None:
            self._live_thread.join()
        return launched

    return launch_and_join


def _reset_rungs():
    for side in SIDES.values():
        dispatcher = side["ad"].get_async_dispatcher()
        if dispatcher._live_thread is not None:
            dispatcher._live_thread.join()
        dispatcher.pending = None
        side["ad"].async_stats.reset()
        side["bs"].dispatch_stats.reset()
        side["reset"]()
    jax_co.reset_coalescer(hard=True)
    port_co.reset_coalescer()


@pytest.fixture(autouse=True)
def rungs(monkeypatch):
    """The JAX default rungs on both sides, their timing seams pinned;
    each package's execution deadline put back after the test."""
    import jax

    from mythril_tpu.resilience import watchdog
    from mythril_tpu_torch.resilience import watchdog as port_watchdog

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    monkeypatch.setattr(watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setattr(port_watchdog, "DEADLINE_FLOOR_S", 3600.0)
    monkeypatch.setenv("MYTHRIL_TPU_DISPATCH_TIMEOUT", "3600")
    for name, value in {**SLICE_PINS_ENV, **SLICE_PINS_CPU_ENV}.items():
        monkeypatch.setenv(name, value)
    for name in ("MYTHRIL_TPU_COALESCE", "MYTHRIL_TPU_COALESCE_FILL",
                 "MYTHRIL_TPU_FRONTIER", "MYTHRIL_TPU_RESIDENT_KERNEL"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MYTHRIL_TPU_COALESCE_WINDOW", "2")
    for name, value in DETERMINISTIC_ENV.items():
        monkeypatch.setenv(name, value)
    for name, value in SLICE_PINS_ARGS.items():
        monkeypatch.setattr(jax_args, name, value)
    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "device_force_dispatch", False)
        monkeypatch.setattr(args, "device_coalesce", True)
        monkeypatch.setattr(args, "async_dispatch", True)
        monkeypatch.setattr(args, "device_min_save_s", 0.0)
    for bs in (jax_bs, port_bs):
        monkeypatch.setattr(bs, "SLOW_DISPATCH_FUSE_S", float("inf"))
    for co in (jax_co, port_co):
        monkeypatch.setattr(co, "COALESCE_MAX_AGE_S", 1e9)
    for ad in (jax_ad, port_ad):
        monkeypatch.setattr(ad.AsyncDispatcher, "launch",
                            _joined(ad.AsyncDispatcher.launch))
    _reset_rungs()
    with fresh_planes(), kept_deadlines():
        yield
    _reset_rungs()


def _set_min_save(monkeypatch, seconds):
    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "device_min_save_s", seconds)


def _channels(ctx):
    """What a harvest or a merged dispatch leaves behind in the blast
    context: the UNSAT memo's entries (by size: node ids depend on what
    the process interned before), the pool's clause count (nogoods), and
    the remembered models' truth rows."""
    return (sorted(len(key) for key in ctx.unsat_memo), ctx.pool.num_clauses,
            [np.asarray(env.truth_snapshot).tolist()
             for env in ctx.recent_models
             if getattr(env, "truth_snapshot", None) is not None])


def _snapshot(side, verdicts):
    s = SIDES[side]
    stats = s["bs"].dispatch_stats
    return {
        "verdicts": verdicts,
        "rungs": {k: getattr(stats, k) for k in RUNG_FIELDS},
        "async": {k: getattr(s["ad"].async_stats, k) for k in ASYNC_FIELDS},
        "channels": _channels(s["context"]()),
    }


#: the tier that decided each lane, per call of the port's last
#: ``_run_calls`` (the JAX funnel keeps no such record)
PORT_TIERS = []


def _run_calls(side, builds):
    """Each of ``builds`` through ``side``'s funnel in one blast context
    (the JAX funnel leaves its open lanes to its caller, so the port's
    runs with ``tail=False``); a snapshot after every call."""
    s = SIDES[side]
    s["reset"]()
    out = []
    if side == "port":
        PORT_TIERS.clear()
    for build in builds:
        lanes, _ = build(s["S"])
        verdicts = s["bs"].batch_check_states(lanes, **s["kwargs"])
        out.append(_snapshot(side, verdicts))
        if side == "port":
            PORT_TIERS.append(list(s["bs"].dispatch_stats.last_tiers))
    return out


def _parity(builds):
    jax = _run_calls("jax", builds)
    _reset_rungs()
    port = _run_calls("port", builds)
    assert len(port) == len(jax)
    for call, (got, want) in enumerate(zip(port, jax)):
        for key in want:
            assert got[key] == want[key], (call, key)
    return port


def small_words(S):
    """Eight lanes over two 16-bit words: a pool of about 900 clauses,
    within the full-pool tier's caps (the guard chains' and the scale
    tree's pools are past them, so the union-cone tier takes those).
    Lanes ``i % 4 == 1`` contradict their bound (dead)."""
    S = S or PS
    bv = S.symbol_factory.BitVecVal
    x = S.symbol_factory.BitVecSym("rung_x", 16)
    y = S.symbol_factory.BitVecSym("rung_y", 16)
    lanes, expected = [], []
    for i in range(8):
        lane = [S.ULT(x, bv(1000 + i, 16)),
                (x * bv(3, 16) + y) == bv((i * 4099) & 0xFFFF, 16)]
        if i % 4 == 1:
            lane.append(x == bv(2000 + i, 16))
        lanes.append(lane)
        expected.append(i % 4 != 1)
    return lanes, expected


FRONTIERS = {
    "small_words": small_words,
    "guard_chain": lambda S: frontiers.guard_chain_frontier(8, 8, 2, smt=S),
    "scale_mul": lambda S: frontiers.scale_mul_frontier(
        3, 8, smt=S, calldata="words"),
}


@pytest.mark.parametrize("name", sorted(FRONTIERS))
def test_gate_declines_and_the_prefetch_harvest_matches_jax(
        monkeypatch, name):
    """With the gate always declining, the first call leaves every lane
    that the host probe and the word tier do not decide open, and
    prefetches the batch; the second call harvests it first (UNSAT memo,
    nogoods, models) and decides lanes from them (the UNSAT memo, and
    the host probe against the harvested models), then prefetches what
    is left."""
    _set_min_save(monkeypatch, 1e9)
    build = FRONTIERS[name]
    first, second = _parity([build, build])
    assert None in first["verdicts"]
    assert all(tier in ("probe", "word")
               for v, tier in zip(first["verdicts"], PORT_TIERS[0])
               if v is not None)
    assert first["rungs"]["profit_skips"] == 1
    assert first["rungs"]["dispatches"] == 0
    assert first["async"]["launches"] == 1
    assert second["async"]["harvested"] == 1
    assert second["async"]["unsat"] + second["async"]["models"] > 0
    assert second["async"]["dropped"] == 0
    tiers = PORT_TIERS[1]
    decided = [i for i, v in enumerate(second["verdicts"]) if v is not None]
    opened = [i for i, v in enumerate(first["verdicts"]) if v is None]
    assert any(second["verdicts"][i] is not None for i in opened)
    assert all(tiers[i] in ("memo", "probe", "word") for i in decided)


@pytest.mark.parametrize("name", sorted(FRONTIERS))
def test_gate_at_zero_dispatches_like_jax(monkeypatch, name):
    """With ``device_min_save_s = 0`` the gate never declines: the
    frontier dispatches at once on both sides, nothing is prefetched."""
    _set_min_save(monkeypatch, 0.0)
    (only,) = _parity([FRONTIERS[name]])
    assert only["rungs"]["profit_skips"] == 0
    assert only["rungs"]["dispatches"] == 1
    assert only["async"]["launches"] == 0


def _small_guard(bits):
    return lambda S: frontiers.guard_chain_frontier(4, bits, 1, smt=S)


def test_coalescer_defers_and_merges_in_the_funnel_like_jax(monkeypatch):
    """Four-lane frontiers in one context: the first dispatches (the
    first-batch rule), the second waits in the queue (its lanes left
    open), the third merges it (a full bucket of eight); the merged
    lanes' verdicts land in the memo and model channels."""
    _set_min_save(monkeypatch, 0.0)
    calls = _parity([_small_guard(8), _small_guard(12), _small_guard(16)])
    assert [c["rungs"]["dispatches"] for c in calls] == [1, 1, 2]
    assert calls[1]["verdicts"] == [None] * 4
    assert calls[1]["rungs"]["coalesce_deferred"] == 4
    assert calls[2]["rungs"]["coalesced_dispatches"] == 1
    assert calls[2]["rungs"]["coalesced_lanes"] == 4
    assert calls[2]["channels"] != calls[1]["channels"]


def test_prefetch_carries_the_coalescer_queue_like_jax(monkeypatch):
    """A deferred batch rides along with the next prefetch: the gate at
    zero lets the first two frontiers reach the coalescer (dispatch,
    then defer), then the gate declines the third, whose prefetch drains
    the queue."""
    lanes_seen = []

    def build(bits, min_save):
        def make(S):
            _set_min_save(monkeypatch, min_save)
            lanes_seen.append(bits)
            return _small_guard(bits)(S)
        return make

    calls = _parity([build(8, 0.0), build(12, 0.0), build(16, 1e9),
                     build(16, 1e9)])
    assert calls[2]["rungs"]["profit_skips"] == 1
    assert calls[2]["async"]["launches"] == 1
    assert calls[2]["rungs"]["coalesced_dispatches"] == 1
    assert calls[2]["rungs"]["coalesced_lanes"] == 4
    assert calls[3]["async"]["harvested"] == 1


def test_cone_tier_prefetch_on_an_oversized_pool_matches_jax(monkeypatch):
    """A pool past the full-pool tier's clause cap: the prefetch takes
    the union-cone tier's runner on both sides, and its compact
    assignment comes back in the full var space."""
    _set_min_save(monkeypatch, 1e9)
    for bs in (jax_bs, port_bs):
        monkeypatch.setattr(bs, "MAX_GATHER_CLAUSES", 64)
    build = FRONTIERS["scale_mul"]
    calls = {}
    for side in ("jax", "port"):
        _reset_rungs()
        s = SIDES[side]
        s["reset"]()
        lanes, _ = build(s["S"])
        ctx = s["context"]()
        first = s["bs"].batch_check_states(lanes, **s["kwargs"])
        assert ctx.pool.num_clauses > 64, side  # the cap is passed
        second = s["bs"].batch_check_states(lanes, **s["kwargs"])
        calls[side] = (_snapshot(side, first), _snapshot(side, second))
    assert calls["port"] == calls["jax"]
    second = calls["port"][1]
    assert second["async"]["harvested"] == 1
    assert second["async"]["unsat"] + second["async"]["models"] > 0


def test_a_stale_generation_is_dropped_like_jax(monkeypatch):
    """A batch launched in one blast context and harvested in the next
    is dropped unread on both sides."""
    _set_min_save(monkeypatch, 1e9)
    out = {}
    for side in ("jax", "port"):
        s = SIDES[side]
        s["reset"]()
        lanes, _ = FRONTIERS["guard_chain"](s["S"])
        s["bs"].batch_check_states(lanes, **s["kwargs"])
        s["reset"]()   # a new analysis: a new generation
        s["ad"].get_async_dispatcher().harvest(s["context"]())
        out[side] = {k: getattr(s["ad"].async_stats, k)
                     for k in ASYNC_FIELDS}
    assert out["port"] == out["jax"]
    assert out["port"]["launches"] == out["port"]["dropped"] == 1
    assert out["port"]["harvested"] == 0


def test_no_async_dispatch_launches_nothing_like_jax(monkeypatch):
    """``async_dispatch`` off: the gate still declines, nothing is
    prefetched, and the lanes stay open on both sides."""
    _set_min_save(monkeypatch, 1e9)
    for args in (jax_args, port_args):
        monkeypatch.setattr(args, "async_dispatch", False)
    build = FRONTIERS["guard_chain"]
    first, second = _parity([build, build])
    assert second["rungs"]["profit_skips"] == 2
    assert second["async"]["launches"] == 0
    assert second["verdicts"] == [None] * len(second["verdicts"])


def test_cli_flags_set_the_rung_arguments(monkeypatch, capsys):
    """``--device-force-dispatch`` and ``--no-async-dispatch`` reach the
    funnel's arguments through the analyzer, as in the JAX CLI; without
    them the analyzer runs the JAX defaults."""
    from mythril_tpu_torch.interfaces import cli as port_cli

    base = ["analyze", "-c", "0x00", "--bin-runtime", "--no-onchain-data",
            "--device", "cpu"]
    for extra, force, prefetch in (
        ([], False, True),
        (["--device-force-dispatch"], True, True),
        (["--no-async-dispatch"], False, False),
    ):
        with pytest.raises(SystemExit) as done:
            port_cli.main(base + extra)
        assert done.value.code == 0, capsys.readouterr().err
        assert port_args.device_force_dispatch is force
        assert port_args.async_dispatch is prefetch
    capsys.readouterr()


def test_a_worker_failure_is_raised_at_the_next_harvest(monkeypatch):
    """Deviation from the JAX package, on purpose: its worker swallows
    every exception and the harvest drops the batch
    (``mythril_tpu/ops/async_dispatch.py:121-124``), which would hide a
    kernel that fails to build or launch.  The port keeps the exception
    and raises it at the next harvest.  Both sides see the same failing
    solve here; the JAX side counts a drop, the port's funnel raises."""
    _set_min_save(monkeypatch, 1e9)

    def broken(*_args, **_kwargs):
        raise RuntimeError("round_lane kernel launch failed")

    monkeypatch.setattr(jax_bs, "make_solve_step", lambda *_a: broken)
    monkeypatch.setattr(port_rl, "solve_lane", broken)
    build = FRONTIERS["guard_chain"]
    steps = jax_bs.get_backend()._step_cache
    steps.clear()
    try:
        jax_first, jax_second = _run_calls("jax", [build, build])
    finally:
        steps.clear()   # the broken step must not serve a later test
    assert jax_first["async"]["launches"] == 1
    assert jax_second["async"]["dropped"] == 1
    _reset_rungs()
    port_reset()
    lanes, _ = build(None)
    port_bs.batch_check_states(lanes, device="cpu", tail=False)
    assert port_ad.async_stats.launches == 1
    with pytest.raises(RuntimeError, match="async prefetch failed"):
        port_bs.batch_check_states(lanes, device="cpu", tail=False)
    assert port_ad.get_async_dispatcher().pending is None


def test_a_worker_failure_no_harvest_reaches_ends_the_analysis(
        monkeypatch):
    """A prefetch launched by an analysis's last funnel call is never
    harvested: the analyzer's ``finish()`` waits for it and raises its
    failure, so the analysis reports it (the JAX package drops it)."""
    from mythril_tpu_torch.mythril.mythril_analyzer import MythrilAnalyzer

    _set_min_save(monkeypatch, 1e9)

    def broken(*_args, **_kwargs):
        raise RuntimeError("round_lane kernel launch failed")

    monkeypatch.setattr(port_rl, "solve_lane", broken)
    port_reset()
    lanes, _ = small_words(None)
    port_bs.batch_check_states(lanes, device="cpu", tail=False)
    dispatcher = port_ad.get_async_dispatcher()
    assert dispatcher.pending is not None and dispatcher.pending["done"]
    with pytest.raises(RuntimeError, match="async prefetch failed"):
        dispatcher.finish()
    assert dispatcher.pending is None
    dispatcher.finish()   # nothing left: a no-op
    # the analyzer calls it after each contract's executors
    assert "finish" in MythrilAnalyzer._analyze_contract.__code__.co_names


# --------------------------------------------- the coalescer's admission


class _Ctx:
    def __init__(self, generation):
        self.generation = generation


def _lanes(start, n):
    """``n`` distinct assumption sets."""
    return [[start + i, -(start + i + 1)] for i in range(n)]


def _script(co, name):
    """A scripted sequence of admissions on one coalescer module; the
    trace of decisions (None = deferred, else the merged keys) and the
    queue after each step."""
    coalescer = co.get_coalescer()
    coalescer.reset()
    ctx = _Ctx(1)
    trace = []

    def admit(sets, force_now=False, context=None):
        got = coalescer.admit(context or ctx, sets, [None] * len(sets),
                              [None] * len(sets), force_now=force_now)
        trace.append(("admit", None if got is None
                      else sorted(q.key for q in got),
                      sorted(coalescer.queue), coalescer.deferrals,
                      coalescer.dispatched))

    if name == "first_batch":
        admit(_lanes(10, 2))            # the first batch never waits
        admit(_lanes(20, 2))
    elif name == "window":
        admit(_lanes(10, 8))
        for k in range(4):              # at most two deferrals in a row
            admit(_lanes(20 + 10 * k, 1))
    elif name == "fill":
        admit(_lanes(10, 8))
        admit(_lanes(20, 5))            # 5 of 8: under 0.75
        admit(_lanes(30, 1))            # 6 of 8 with the queue: dispatch
        admit(_lanes(40, 6))            # 6 of 8 alone: dispatch
    elif name == "queue_cap":
        admit(_lanes(10, 1))
        admit(_lanes(20, 3))            # 3 <= cap 4: deferred
        admit(_lanes(30, 2))            # 3 + 2 > cap 4: dispatch
    elif name == "drain_requeue":
        admit(_lanes(10, 1))
        admit(_lanes(20, 2))
        drained = coalescer.drain(ctx, exclude={(20, -21)})
        trace.append(("drain", sorted(q.key for q in drained),
                      sorted(coalescer.queue)))
        coalescer.requeue(ctx, drained)
        trace.append(("requeue", sorted(coalescer.queue)))
        admit(_lanes(20, 2), force_now=True)   # a fuse retry never waits
    elif name == "generation_reset":
        admit(_lanes(10, 1))
        admit(_lanes(20, 2))
        admit(_lanes(30, 1), context=_Ctx(2))  # a new context: reset
        admit(_lanes(40, 1), context=_Ctx(2))
    elif name == "stale":
        admit(_lanes(10, 1))
        admit(_lanes(20, 2))            # deferred, queue now "old"
        admit(_lanes(30, 1))            # a stale queue stops deferring
    return trace


SCRIPTS = ("first_batch", "window", "fill", "queue_cap", "drain_requeue",
           "generation_reset", "stale")


@pytest.mark.parametrize("name", SCRIPTS)
def test_coalescer_admission_matches_jax(monkeypatch, name):
    if name == "queue_cap":
        for co in (jax_co, port_co):
            monkeypatch.setattr(co, "COALESCE_QUEUE_CAP", 4)
    if name == "stale":
        for co in (jax_co, port_co):
            monkeypatch.setattr(co, "COALESCE_MAX_AGE_S", -1.0)
    traces = {}
    for side, co, bs in (("jax", jax_co, jax_bs), ("port", port_co, port_bs)):
        bs.dispatch_stats.reset()
        traces[side] = (_script(co, name),
                        bs.dispatch_stats.coalesce_deferred)
    assert traces["port"] == traces["jax"]
    decisions = [step[1] for step in traces["port"][0] if step[0] == "admit"]
    assert any(d is None for d in decisions) or name == "first_batch"
    assert decisions[0] == []           # a context's first batch


def test_coalescer_switch_and_window_knobs_match_jax(monkeypatch):
    """``MYTHRIL_TPU_COALESCE=0`` and ``device_coalesce`` off never
    defer; ``MYTHRIL_TPU_COALESCE_WINDOW=0`` neither."""
    for setting in ({"MYTHRIL_TPU_COALESCE": "0"},
                    {"MYTHRIL_TPU_COALESCE_WINDOW": "0"}, "args"):
        with monkeypatch.context() as m:
            if setting == "args":
                for args in (jax_args, port_args):
                    m.setattr(args, "device_coalesce", False)
            else:
                for k, v in setting.items():
                    m.setenv(k, v)
            traces = [_script(co, "window") for co in (jax_co, port_co)]
        assert traces[0] == traces[1]
        assert all(step[1] is not None for step in traces[1])


def test_stats_reset_resets_the_coalescer():
    """``dispatch_stats.reset()`` clears the admission window, as the
    JAX package's does."""
    coalescer = port_co.get_coalescer()
    ctx = _Ctx(5)
    coalescer.admit(ctx, _lanes(10, 1), [None], [None])
    coalescer.admit(ctx, _lanes(20, 1), [None], [None])
    assert coalescer.queue and coalescer.dispatched == 1
    port_bs.dispatch_stats.reset()
    assert not coalescer.queue and coalescer.dispatched == 0


def test_prefetch_solves_a_snapshot_of_the_pool(monkeypatch):
    """The worker solves the pool rows as they stood at launch: an
    in-place append after the launch does not reach it."""
    seen = {}
    real = port_rl.solve_lane

    def spy(lits, assign, *args, **kwargs):
        seen["lits"] = lits
        return real(lits, assign, *args, **kwargs)

    monkeypatch.setattr(port_rl, "solve_lane", spy)
    _set_min_save(monkeypatch, 1e9)
    port_reset()
    lanes, _ = small_words(None)
    port_bs.batch_check_states(lanes, device="cpu", tail=False)
    pool = port_bs.get_backend("cpu").pool
    assert port_ad.async_stats.launches == 1
    assert seen["lits"] is not pool.lits
    assert torch.equal(seen["lits"], pool.lits)
    assert seen["lits"].data_ptr() != pool.lits.data_ptr()
