"""The port's 256-bit limb primitives (``mythril_tpu_torch/ops/u256.py``,
32-bit limbs held in ``int64``) against the JAX package's ``u256`` over
numpy ``uint32`` limbs, on the CPU.  Random words from a seeded numpy
generator plus the edge words (0, 1, 2^255, 2^256 - 1 and single bits);
shifts by 0, 1, 31, 32, 255, 256 and huge amounts, static and per lane.
Every result must be equal limb for limb."""

import numpy as np
import pytest
import torch

from mythril_tpu.ops import u256 as J
from mythril_tpu_torch.ops import u256 as P

EDGES = [0, 1, 2, 1 << 31, 1 << 32, 1 << 255, (1 << 256) - 1,
         (1 << 255) - 1, (1 << 128) + 7]
SHIFTS = [0, 1, 7, 31, 32, 33, 63, 200, 255, 256, 257, 1000, (1 << 31) + 5]


def _words(seed, n=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        value = int.from_bytes(rng.bytes(32), "little")
        out.append(value >> int(rng.integers(0, 257)))
    return out + EDGES


def _pair(values):
    jw = np.stack([J.from_int(v) for v in values])
    return jw, torch.from_numpy(jw.astype(np.int64))


def _same(jax_out, port_out):
    want = np.asarray(jax_out)
    got = port_out.numpy()
    if want.dtype == bool:
        return np.array_equal(want, got)
    return np.array_equal(want.astype(np.int64), got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arithmetic_and_compare_match_jax(seed):
    a_vals = _words(seed)
    b_vals = list(reversed(_words(seed + 100)))
    ja, pa = _pair(a_vals)
    jb, pb = _pair(b_vals)
    js, jc = J.add_carry(ja, jb, np)
    ps, pc = P.add_carry(pa, pb)
    assert _same(js, ps) and _same(jc, pc)
    for name in ("add", "sub", "mul", "ult", "ule", "slt", "eq"):
        assert _same(getattr(J, name)(ja, jb, np), getattr(P, name)(pa, pb)), \
            name
    for name in ("neg", "bit_not", "is_zero"):
        assert _same(getattr(J, name)(ja, np), getattr(P, name)(pa)), name
    # against Python ints too
    for k, (x, y) in enumerate(zip(a_vals, b_vals)):
        assert P.to_int(P.mul(pa, pb)[k]) == (x * y) % (1 << 256)
        assert P.to_int(P.sub(pa, pb)[k]) == (x - y) % (1 << 256)


def test_from_int_to_int_round_trip():
    for value in _words(7, 16):
        limbs = P.from_int(value, (3,), "cpu")
        assert limbs.shape == (3, 8) and limbs.dtype == torch.int64
        assert np.array_equal(limbs[1].numpy(), J.from_int(value))
        assert P.to_int(limbs[2]) == value == J.to_int(J.from_int(value))


@pytest.mark.parametrize("name", ["shl", "lshr", "sar"])
def test_shifts_match_jax(name):
    ja, pa = _pair(_words(3, 40))
    jf, pf = getattr(J, name), getattr(P, name)
    for amount in SHIFTS:
        assert _same(jf(ja, np.uint32(amount), np), pf(pa, amount)), amount
    rng = np.random.default_rng(11)
    per_lane = rng.integers(0, 300, size=ja.shape[0])
    per_lane[:len(SHIFTS)] = SHIFTS
    assert _same(jf(ja, per_lane.astype(np.uint32), np),
                 pf(pa, torch.from_numpy(per_lane)))


@pytest.mark.parametrize("name", ["shl_wide", "lshr_wide", "sar_wide"])
def test_wide_shifts_match_jax(name):
    ja, pa = _pair(_words(5, 40))
    amounts = SHIFTS + [1 << 40, 1 << 255, (1 << 256) - 1]
    amounts = (amounts * 8)[:ja.shape[0]]
    jm, pm = _pair(amounts)
    assert _same(getattr(J, name)(ja, jm, np), getattr(P, name)(pa, pm))


def test_limb_select_and_norm_amount_match_jax():
    ja, pa = _pair(_words(9, 12))
    idx = np.array([-3, -1, 0, 1, 5, 7, 8, 12, 3, 2, 6, 4, -9, 9, 0, 7,
                    1, 2, 3, 4, 5])[:ja.shape[0]]
    fill = np.uint32(0xDEADBEEF)
    want = J._limb_select(ja, idx, fill, np)
    got = P._limb_select(pa, torch.from_numpy(idx), torch.tensor(0xDEADBEEF))
    assert _same(want, got)
    assert _same(J._norm_amount(300, (4,), np),
                 P._norm_amount(300, (4,), "cpu"))
    assert _same(J._norm_amount(np.array([0, 5, 256, 9999]), (4,), np),
                 P._norm_amount(torch.tensor([0, 5, 256, 9999]), (4,), "cpu"))


def test_from_int_defaults_to_the_card():
    """``from_int`` resolves its device as every entry point of the port
    does: the card unless the caller passes ``device="cpu"``, and no
    silent CPU fall back without one."""
    value = (1 << 200) + 12345
    on_cpu = P.from_int(value, (3,), device="cpu")
    assert on_cpu.device.type == "cpu"
    assert _same(J.from_int(value, (3,)), on_cpu)
    if torch.cuda.is_available():
        assert P.from_int(value, (3,)).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            P.from_int(value, (3,))
