"""The port's word-tier transfers (``mythril_tpu_torch/ops/word_prop.py``)
against the JAX package's ``ops/word_prop.py``, on the CPU.

Every limb-plane function (``f_*`` forward transfers, ``p_*``
predicates, ``b_ult_true``, ``refine`` / ``meet`` / ``join`` and the bit
helpers) runs on the same abstract words, made from a seeded numpy
generator at widths 8, 64, 255 and 256 (consistent words, singletons,
tops and some empty ones), on the port's ``int64`` limbs and on JAX's
numpy ``uint32`` limbs; every ``s_*`` scalar twin runs on the same
Python ints on both sides.  Equality is exact.

The word fixpoint kernel's own source (``ops/csrc/word_prop.cu``), built
as host C++ with its group of 8 limb threads emulated, runs the lane walk
with the kernel's vote, shuffle and carry arithmetic; it must equal
``word_fixpoint_plain`` bit for bit on random DAGs, a DAG with every
opcode, a depth-8 push-down and a program at the node cap.  The same
build's shared-memory rule (``word_prop_smem_bytes``) is pinned against
the H100's 227 KB a block."""

import ctypes
import subprocess
import types

import numpy as np
import pytest
import torch

from mythril_tpu.ops import word_prop as JW
from mythril_tpu_torch import frontiers
from mythril_tpu_torch.ops import word_fixpoint as WF
from mythril_tpu_torch.ops import word_prop as PW
from mythril_tpu_torch.smt import word_tier as PWT

WIDTHS = (8, 64, 255, 256)
LANES = 48


def _rand_words(rng, width, n=LANES):
    """(lo, hi, km, kv) ints: mostly consistent abstractions of a random
    value, with singletons, tops and a few contradictory ones."""
    wm = (1 << width) - 1
    full = (1 << 256) - 1
    out = []
    for k in range(n):
        x = int.from_bytes(rng.bytes(32), "little") & wm
        x >>= int(rng.integers(0, width + 1)) if rng.random() < 0.3 else 0
        kind = k % 6
        if kind == 0:  # singleton
            out.append((x, x, full, x))
            continue
        if kind == 1:  # top
            out.append((0, wm, full ^ wm, 0))
            continue
        spread = int.from_bytes(rng.bytes(32), "little") & wm
        spread >>= int(rng.integers(0, width + 1))
        lo = max(0, x - spread)
        hi = min(wm, x + (spread >> int(rng.integers(0, 4))))
        km = (int.from_bytes(rng.bytes(32), "little") & wm) | (full ^ wm)
        if kind == 2:
            km &= ~((1 << int(rng.integers(0, width))) - 1)
        kv = x & km
        if kind == 5 and rng.random() < 0.5:  # contradictory
            kv ^= 1 << int(rng.integers(0, width))
            kv &= km
            lo, hi = hi, lo
        out.append((lo, hi, km & full, kv))
    return out


def _limbs(value):
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _planes(words):
    """The same words as JAX numpy uint32 planes and port int64 planes."""
    cols = [np.array([_limbs(w[f]) for w in words], dtype=np.uint32)
            for f in range(4)]
    return (tuple(cols),
            tuple(torch.from_numpy(c.astype(np.int64)) for c in cols))


def _eq(want, got):
    """JAX result (arrays, tuples, (word, empty) pairs) == port result."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(want) == len(got)
        return all(_eq(w, g) for w, g in zip(want, got))
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype == bool or want.dtype == np.int8:
        return np.array_equal(want, got)
    return np.array_equal(want.astype(np.int64), got.astype(np.int64))


def _setup(seed, width):
    rng = np.random.default_rng(seed * 1000 + width)
    a = _rand_words(rng, width)
    b = _rand_words(rng, width)
    if width > 8:  # shift amounts: small singletons in most lanes
        b = [((k % (width + 3)),) * 2 + ((1 << 256) - 1, k % (width + 3))
             if k % 3 else w for k, w in enumerate(b)]
    ja, pa = _planes(a)
    jb, pb = _planes(b)
    jwm = JW.width_mask(width, (LANES,), np)
    pwm = PW.width_mask(width, (LANES,), "cpu")
    return (a, b), (ja, jb, jwm), (pa, pb, pwm)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", [
    "f_add", "f_sub", "f_mul", "f_udiv", "f_urem", "f_shl", "f_lshr",
    "f_ashr"])
def test_width_transfers_match_jax(name, width):
    for seed in range(2):
        _, (ja, jb, jwm), (pa, pb, pwm) = _setup(seed, width)
        want = getattr(JW, name)(ja, jb, width, jwm, np)
        got = getattr(PW, name)(pa, pb, width, pwm)
        assert _eq(want, got), (name, width, seed)


@pytest.mark.parametrize("width", WIDTHS)
def test_bitwise_transfers_and_lattice_match_jax(width):
    for seed in range(2):
        _, (ja, jb, jwm), (pa, pb, pwm) = _setup(seed, width)
        for name in ("f_and", "f_or", "f_xor", "meet", "join"):
            assert _eq(getattr(JW, name)(ja, jb, jwm, np),
                       getattr(PW, name)(pa, pb, pwm)), name
        assert _eq(JW.f_not(ja, width, jwm, np), PW.f_not(pa, width, pwm))
        assert _eq(JW.refine(*ja, jwm, np), PW.refine(*pa, pwm))
        mask = np.arange(LANES) % 3 == 0
        assert _eq(JW.select_word(mask, ja, jb, np),
                   PW.select_word(torch.from_numpy(mask), pa, pb))
        for strict in (True, False):
            assert _eq(JW.b_ult_true(ja, jb, jwm, np, strict=strict),
                       PW.b_ult_true(pa, pb, pwm, strict=strict)), strict


@pytest.mark.parametrize("width", WIDTHS)
def test_predicates_match_jax(width):
    for seed in range(2):
        _, (ja, jb, _jwm), (pa, pb, _pwm) = _setup(seed, width)
        for name in ("p_eq", "p_ult", "p_ule"):
            assert _eq(getattr(JW, name)(ja, jb, np),
                       getattr(PW, name)(pa, pb)), name
        for name in ("p_slt", "p_sle"):
            assert _eq(getattr(JW, name)(ja, jb, width, np),
                       getattr(PW, name)(pa, pb, width)), name
        # a word against itself: singletons decide
        assert _eq(JW.p_eq(ja, ja, np), PW.p_eq(pa, pa))


@pytest.mark.parametrize("high,low", [(7, 0), (63, 8), (255, 0), (200, 130),
                                      (31, 31)])
def test_extract_matches_jax(high, low):
    _, (ja, _jb, _), (pa, _pb, _) = _setup(3, 256)
    nw = high - low + 1
    assert _eq(JW.f_extract(ja, high, low, JW.width_mask(nw, (LANES,), np),
                            np),
               PW.f_extract(pa, high, low,
                            PW.width_mask(nw, (LANES,), "cpu")))


@pytest.mark.parametrize("old,new", [(8, 64), (8, 256), (64, 256),
                                     (255, 256)])
def test_sext_matches_jax(old, new):
    _, (ja, _jb, _), (pa, _pb, _) = _setup(4, old)
    assert _eq(JW.f_sext(ja, old, new, JW.width_mask(new, (LANES,), np), np),
               PW.f_sext(pa, old, new, PW.width_mask(new, (LANES,), "cpu")))


def test_concat_matches_jax():
    rng = np.random.default_rng(5)
    widths = [8, 64, 16, 8]
    parts = [_planes(_rand_words(rng, w)) for w in widths]
    offsets = np.cumsum([0] + widths[:-1]).tolist()
    total = sum(widths)
    want = JW.f_concat([p[0] for p in parts], offsets, widths, total,
                       JW.width_mask(total, (LANES,), np), np)
    got = PW.f_concat([p[1] for p in parts], offsets, widths, total,
                      PW.width_mask(total, (LANES,), "cpu"))
    assert _eq(want, got)


def test_bit_helpers_match_jax():
    rng = np.random.default_rng(6)
    words = [w[2] for w in _rand_words(rng, 256, 64)]
    words += [0, 1, (1 << 256) - 1, 1 << 255, (1 << 32) - 1, 1 << 32]
    jx = np.array([_limbs(v) for v in words], dtype=np.uint32)
    px = torch.from_numpy(jx.astype(np.int64))
    for name in ("smear_down", "prefix_mask", "trailing_known_mask",
                 "popcount", "bit_length", "any_bit"):
        assert _eq(getattr(JW, name)(jx, np), getattr(PW, name)(px)), name
    for index in (0, 31, 32, 200, 255):
        assert _eq(JW.get_bit(jx, index, np), PW.get_bit(px, index))
    assert _eq(JW.umin(jx, jx[::-1], np), PW.umin(px, px.flip(0)))
    assert _eq(JW.umax(jx, jx[::-1], np), PW.umax(px, px.flip(0)))
    for width in WIDTHS:
        assert _eq(JW.top(width, (3,), np), PW.top(width, (3,), "cpu"))
        assert _eq(JW.const_word(12345 << 40, width, (3,), np),
                   PW.const_word(12345 << 40, width, (3,), "cpu"))


#: the constructors, each as (JAX twin, port function) on one argument list
CONSTRUCTORS = {
    "ones_plane": (lambda xp: JW.ones_plane((3,), xp),
                   lambda *dev: PW.ones_plane((3,), *dev)),
    "zeros_plane": (lambda xp: JW.zeros_plane((3,), xp),
                    lambda *dev: PW.zeros_plane((3,), *dev)),
    "width_mask": (lambda xp: JW.width_mask(33, (3,), xp),
                   lambda *dev: PW.width_mask(33, (3,), *dev)),
    "top": (lambda xp: JW.top(160, (3,), xp),
            lambda *dev: PW.top(160, (3,), *dev)),
    "const_word": (lambda xp: JW.const_word(12345 << 40, 64, (3,), xp),
                   lambda *dev: PW.const_word(12345 << 40, 64, (3,), *dev)),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """The plane constructors resolve their device as every entry point
    of the port does: the card unless the caller passes ``device="cpu"``
    (then equal to the JAX twins' numpy planes), and no silent CPU fall
    back without one."""
    jax_fn, port_fn = CONSTRUCTORS[name]
    on_cpu = port_fn("cpu")
    planes = on_cpu if isinstance(on_cpu, tuple) else (on_cpu,)
    assert all(p.device.type == "cpu" for p in planes)
    assert _eq(jax_fn(np), on_cpu)
    if torch.cuda.is_available():
        on_card = port_fn()
        planes = on_card if isinstance(on_card, tuple) else (on_card,)
        assert all(p.is_cuda for p in planes)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port_fn()


@pytest.mark.parametrize("width", WIDTHS)
def test_scalar_twins_match_jax(width):
    rng = np.random.default_rng(7 + width)
    wm = (1 << width) - 1
    a_words = _rand_words(rng, width)
    b_words = _rand_words(rng, width)
    for a, b in zip(a_words, b_words):
        for name in ("s_add", "s_sub", "s_mul", "s_udiv", "s_urem", "s_shl",
                     "s_lshr", "s_ashr"):
            assert getattr(JW, name)(a, b, width, wm) == \
                getattr(PW, name)(a, b, width, wm), name
        for name in ("s_and", "s_or", "s_xor", "s_meet"):
            assert getattr(JW, name)(a, b, wm) == getattr(PW, name)(a, b, wm)
        assert JW.s_join(a, b) == PW.s_join(a, b)
        assert JW.s_not(a, width, wm) == PW.s_not(a, width, wm)
        assert JW.s_refine(*a, wm) == PW.s_refine(*a, wm)
        for cond in (1, -1, 0):
            assert JW.s_ite(cond, a, b) == PW.s_ite(cond, a, b)
        for name in ("s_p_eq", "s_p_ult", "s_p_ule"):
            assert getattr(JW, name)(a, b) == getattr(PW, name)(a, b)
        for name in ("s_p_slt", "s_p_sle"):
            assert getattr(JW, name)(a, b, width) == \
                getattr(PW, name)(a, b, width)
        for strict in (True, False):
            assert JW.s_b_ult_true(a, b, wm, strict) == \
                PW.s_b_ult_true(a, b, wm, strict)
        if width > 8:
            assert JW.s_extract(a, width - 2, 3, (1 << (width - 4)) - 1) == \
                PW.s_extract(a, width - 2, 3, (1 << (width - 4)) - 1)
        if width < 256:
            assert JW.s_sext(a, width, 256, (1 << 256) - 1) == \
                PW.s_sext(a, width, 256, (1 << 256) - 1)
        assert JW.s_trailing_known(a[2]) == PW.s_trailing_known(a[2])
    assert JW.s_top(wm) == PW.s_top(wm)
    assert JW.s_const(12345, wm) == PW.s_const(12345, wm)
    parts = [a_words[0], b_words[1]]
    assert JW.s_concat(parts, [0, width], [width, width], (1 << 256) - 1) \
        == PW.s_concat(parts, [0, width], [width, width], (1 << 256) - 1)


def test_scalar_twins_agree_with_planes():
    """The port's two executors' transfers agree: each ``s_*`` twin on
    one lane's ints equals the plane transfer's lane."""
    width = 64
    (a_words, b_words), _, (pa, pb, pwm) = _setup(8, width)
    wm = (1 << width) - 1
    for name in ("add", "sub", "mul", "udiv", "urem", "shl", "lshr"):
        word, empty = getattr(PW, "f_" + name)(pa, pb, width, pwm)
        for lane in range(LANES):
            s_word, s_empty = getattr(PW, "s_" + name)(
                a_words[lane], b_words[lane], width, wm)
            if s_empty:
                assert bool(empty[lane])
                continue
            assert not bool(empty[lane])
            assert PW.to_ints(word, lane) == s_word, (name, lane)


# ------------------------------------------- the word fixpoint kernel's source


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``word_prop.cu`` built as host C++ (``word_prop_host``: the kernel's
    lane walk on an emulated group of 8 threads), bound with ctypes."""
    lib_path = tmp_path_factory.mktemp("word_prop") / "libword_prop_host.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-x", "c++", "-shared",
                    "-fPIC", "-o", str(lib_path), WF.SOURCE],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.word_prop_host.argtypes = [ptr, c_int, ptr, ptr, ptr, c_int, c_int,
                                   c_int, ptr, ptr, ptr, ptr]
    lib.word_prop_host.restype = c_int
    lib.word_prop_smem_bytes.argtypes = [c_int, c_int]
    lib.word_prop_smem_bytes.restype = c_int
    return lib


def _word_inputs(lanes):
    """(table, want0) of one decide over ``lanes``, as the word tier
    builds them."""
    roots = list({n.id: n for lane in lanes for n in lane}.values())
    prog = PWT._compile(roots, PWT.WORD_MAX_NODES)
    table = WF.lower_program(prog)
    want0 = np.zeros((table.n_bool, len(lanes)), dtype=np.int8)
    for k, lane in enumerate(lanes):
        for node in lane:
            want0[prog.bool_slot[node.id], k] = 1
    return table, torch.from_numpy(want0)


def _run_host(lib, table, want0, rounds):
    """The kernel's outputs, in ``word_fixpoint``'s form."""
    batch = want0.shape[1]
    consts = table.consts.to(torch.int32).contiguous()
    bv = torch.zeros((max(table.n_bv, 1) * 32, batch), dtype=torch.int32)
    tri = torch.zeros((table.n_bool, batch), dtype=torch.int8)
    want = torch.zeros_like(tri)
    conflict = torch.zeros((batch,), dtype=torch.bool)
    fault = lib.word_prop_host(
        table.entries.data_ptr(), table.n_bv + table.n_bool,
        table.args.data_ptr(), consts.data_ptr(),
        want0.contiguous().data_ptr(), batch, table.n_bool, rounds,
        bv.data_ptr(), tri.data_ptr(), want.data_ptr(), conflict.data_ptr())
    assert fault == 0, "a group-uniform value differed across the limbs"
    planes = (bv[: table.n_bv * 32].view(table.n_bv, 4, 8, batch)
              .permute(3, 0, 1, 2).to(torch.int64) & 0xFFFFFFFF)
    return planes, tri.t(), conflict


HOST_CASES = {
    "random DAG, widths 256/64/8": lambda: frontiers.word_dag_lanes(
        9, 16, (256, 64, 8)),
    "random DAG, widths 32/8": lambda: frontiers.word_dag_lanes(
        10, 16, (32, 8)),
    "every opcode, widths 1/8/31/33/160/256": lambda:
        frontiers.word_opcode_lanes(3, 24),
    "push-down to depth 8": lambda: frontiers.word_deep_lanes(24),
    "the node cap": lambda: frontiers.word_cap_lanes(5, 4),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_kernel_source_matches_the_plain_fixpoint(name, host_kernel):
    table, want0 = _word_inputs(HOST_CASES[name]())
    if name.startswith("every opcode"):
        ops = {WF.OP_NAMES[int(row[0])] for row in table.entries}
        assert ops == set(WF.OP_NAMES)
    if name == "the node cap":
        assert table.n_bv + table.n_bool == PWT.WORD_MAX_NODES
    rounds = 3 if name.startswith("random") else 2
    got = _run_host(host_kernel, table, want0, rounds)
    want = WF.word_fixpoint_plain(table, want0, rounds)
    for part, g, w in zip(("planes", "tri", "conflict"), got, want):
        assert g.shape == w.shape and torch.equal(g, w), part
    if name != "the node cap":  # four lanes share its 300 constraints
        assert bool(got[2].any()) and not bool(got[2].all())


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_level_schedule_puts_every_arg_in_an_earlier_level(name):
    """The table's schedule columns: a permutation of the rows, ordered
    by level, each position's level end past it, and every arg of a
    scheduled node in an earlier level (so the kernel's warps may take a
    level's nodes in any order)."""
    table, _ = _word_inputs(HOST_CASES[name]())
    entries = table.entries.numpy()
    args = table.args.numpy()
    n = table.n_bv + table.n_bool
    sched, ends = entries[:n, 8], entries[:n, 9]
    assert sorted(sched.tolist()) == list(range(n))
    position = {int(row): k for k, row in enumerate(sched)}
    start = 0
    for k in range(n):
        if k == start or ends[k] != ends[k - 1]:
            start = k
        assert k < ends[k] <= n and ends[start] == ends[k]
        row = entries[sched[k]]
        for a in args[row[5]:row[5] + row[4]]:
            assert position[int(a)] < start


#: dynamic shared memory a block may opt in to on an H100 (sm_90: 227 KB)
H100_SMEM_OPTIN = 232448


def test_every_program_within_the_node_cap_fits_a_block(monkeypatch,
                                                        host_kernel):
    """A block of the word kernel holds one lane's planes in shared
    memory beside the table; by the kernel's own rule every split of bv
    and bool nodes within the word tier's node cap fits an H100's block,
    and twice the cap does not.  The library refuses such a program
    before it launches; the wrapper raises that refusal (a ValueError,
    never a fall back)."""
    cap = PWT.WORD_MAX_NODES
    smem = host_kernel.word_prop_smem_bytes
    for n_rows in (1, 45, 468, cap):
        for n_bool in sorted({1, max(1, n_rows // 2), n_rows}):
            assert smem(n_rows, n_bool) <= H100_SMEM_OPTIN
    assert smem(cap, 1) == (cap - 1) * 128 + 4 + 3 + cap * 40
    assert smem(2 * cap, 1) > H100_SMEM_OPTIN
    rows = 2 * cap
    table = WF.NodeTable(torch.zeros((rows, len(WF.ENTRY_COLUMNS)),
                                     dtype=torch.int32),
                         torch.zeros((1,), dtype=torch.int32),
                         torch.zeros((1, 8), dtype=torch.int64),
                         rows - 1, 1)
    refusing = types.SimpleNamespace(
        word_prop_launch=lambda *args: WF.DOES_NOT_FIT,
        word_prop_smem_bytes=smem)
    monkeypatch.setattr(WF, "load_library", lambda: refusing)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    WF.reset_launch_count()
    with pytest.raises(ValueError, match=f"{smem(rows, 1)} B of shared"):
        WF._launch(table, torch.zeros((1, 64), dtype=torch.int8), 2)
    assert WF.launch_count == 0
