"""The port's word-tier transfers (``mythril_tpu_torch/ops/word_prop.py``)
against the JAX package's ``ops/word_prop.py``, on the CPU.

Every limb-plane function (``f_*`` forward transfers, ``p_*``
predicates, ``b_ult_true``, ``refine`` / ``meet`` / ``join`` and the bit
helpers) runs on the same abstract words, made from a seeded numpy
generator at widths 8, 64, 255 and 256 (consistent words, singletons,
tops and some empty ones), on the port's ``int64`` limbs and on JAX's
numpy ``uint32`` limbs; every ``s_*`` scalar twin runs on the same
Python ints on both sides.  Equality is exact."""

import numpy as np
import pytest
import torch

from mythril_tpu.ops import word_prop as JW
from mythril_tpu_torch.ops import word_prop as PW

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
    pwm = PW.width_mask(width, (LANES,))
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
               PW.f_extract(pa, high, low, PW.width_mask(nw, (LANES,))))


@pytest.mark.parametrize("old,new", [(8, 64), (8, 256), (64, 256),
                                     (255, 256)])
def test_sext_matches_jax(old, new):
    _, (ja, _jb, _), (pa, _pb, _) = _setup(4, old)
    assert _eq(JW.f_sext(ja, old, new, JW.width_mask(new, (LANES,), np), np),
               PW.f_sext(pa, old, new, PW.width_mask(new, (LANES,))))


def test_concat_matches_jax():
    rng = np.random.default_rng(5)
    widths = [8, 64, 16, 8]
    parts = [_planes(_rand_words(rng, w)) for w in widths]
    offsets = np.cumsum([0] + widths[:-1]).tolist()
    total = sum(widths)
    want = JW.f_concat([p[0] for p in parts], offsets, widths, total,
                       JW.width_mask(total, (LANES,), np), np)
    got = PW.f_concat([p[1] for p in parts], offsets, widths, total,
                      PW.width_mask(total, (LANES,)))
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
        assert _eq(JW.top(width, (3,), np), PW.top(width, (3,)))
        assert _eq(JW.const_word(12345 << 40, width, (3,), np),
                   PW.const_word(12345 << 40, width, (3,)))


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
