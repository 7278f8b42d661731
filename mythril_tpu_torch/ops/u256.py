"""256-bit words as 8 little-endian 32-bit limbs, in PyTorch (own copy of
the part of ``mythril_tpu/ops/u256.py`` that the word tier reads).

The JAX package keeps words as ``uint32[..., 8]`` and threads its array
namespace (``xp``) through every primitive.  PyTorch's CPU build raises
on ``uint32`` add, shifts, compares, ``maximum`` and compare-``where``,
so the port holds each 32-bit limb in an ``int64`` and masks: a limb is
always in ``[0, 2^32)``, every result is reduced back into that range,
and the values equal the JAX package's limb for limb.  All functions
broadcast over leading batch dimensions and take tensors on any device.

A shift amount is either a Python int (a static shift) or an integer
tensor over the batch (a per-lane shift); amounts of 256 and more give
0 (``shl``/``lshr``) or the sign fill (``sar``), as the EVM does.

``udivmod``, ``sdiv``, ``smod`` and ``exp`` (``lax.fori_loop`` loops that
only the lockstep stepper uses) are not here: the word tier's
``f_udiv``/``f_urem`` are division-free.
"""

from typing import Tuple, Union

import numpy as np
import torch

NUM_LIMBS = 8
MASK32 = 0xFFFFFFFF
DTYPE = torch.int64

Amount = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# host <-> tensor conversion
# ---------------------------------------------------------------------------


def from_int(value: int, batch_shape: Tuple[int, ...] = (),
             device="cpu") -> torch.Tensor:
    """Python int -> int64[*batch_shape, 8] limbs (value broadcast)."""
    value &= (1 << 256) - 1
    limbs = torch.tensor(
        [(value >> (32 * i)) & MASK32 for i in range(NUM_LIMBS)],
        dtype=DTYPE, device=device,
    )
    return limbs.expand(tuple(batch_shape) + (NUM_LIMBS,)).clone()


def to_int(limbs) -> int:
    """One word's limbs (tensor or array of 8) -> Python int."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs).astype(np.uint64)
    assert arr.shape[-1] == NUM_LIMBS
    value = 0
    for i in range(NUM_LIMBS - 1, -1, -1):
        value = (value << 32) | int(arr[..., i])
    return value


# ---------------------------------------------------------------------------
# add / sub / neg
# ---------------------------------------------------------------------------


def add_carry(a, b):
    """((a + b) mod 2^256, carry_out) over leading batch dims; carry_out
    is int64 in {0, 1} (the 2^256 overflow bit)."""
    out = []
    carry = torch.zeros(a.shape[:-1], dtype=DTYPE, device=a.device)
    for i in range(NUM_LIMBS):
        s = a[..., i] + b[..., i] + carry
        out.append(s & MASK32)
        carry = s >> 32
    return torch.stack(out, dim=-1), carry


def add(a, b):
    """(a + b) mod 2^256."""
    return add_carry(a, b)[0]


def bit_not(a):
    return a ^ MASK32


def neg(a):
    """Two's complement negate mod 2^256."""
    one = torch.zeros_like(a)
    one[..., 0] = 1
    return add(bit_not(a), one)


def sub(a, b):
    """(a - b) mod 2^256."""
    return add(a, neg(b))


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def eq(a, b):
    return torch.all(a == b, dim=-1)


def is_zero(a):
    return torch.all(a == 0, dim=-1)


def ult(a, b):
    """Unsigned a < b: the comparison at the most significant differing
    limb (False when the words are equal)."""
    a, b = torch.broadcast_tensors(a, b)
    out = torch.zeros(a.shape[:-1], dtype=torch.bool, device=a.device)
    for i in range(NUM_LIMBS):
        out = torch.where(a[..., i] != b[..., i], a[..., i] < b[..., i], out)
    return out


def ule(a, b):
    return ~ult(b, a)


def slt(a, b):
    """Signed a < b (two's complement)."""
    sign_a = (a[..., -1] >> 31) == 1
    sign_b = (b[..., -1] >> 31) == 1
    return torch.where(sign_a == sign_b, ult(a, b), sign_a)


# ---------------------------------------------------------------------------
# shifts
# ---------------------------------------------------------------------------


def _limb_select(a, idx, fill):
    """a[..., idx] with an out-of-range idx -> fill (idx may be negative);
    ``idx`` is an int64 tensor over the batch, ``fill`` one broadcastable
    to it."""
    valid = (idx >= 0) & (idx < NUM_LIMBS)
    safe = idx.clamp(0, NUM_LIMBS - 1)
    gathered = torch.gather(a, -1, safe[..., None])[..., 0]
    return torch.where(valid, gathered, fill)


def _norm_amount(amount, batch_shape, device):
    """A per-lane shift amount as int64[batch_shape], clamped to 257 (the
    overflow representative every shift takes to 0 / the sign fill)."""
    if not isinstance(amount, torch.Tensor):
        amount = torch.tensor(amount, dtype=DTYPE, device=device)
    amount = amount.to(DTYPE)
    if amount.dim() == 0:
        amount = amount.expand(batch_shape)
    return amount.clamp(0, 257)


def _static_shift(a, amount: int, left: bool, fill=None):
    """Shift by a Python int: limb moves by slicing, no gathers."""
    batch = a.shape[:-1]
    if fill is None:
        fill = torch.zeros(batch, dtype=DTYPE, device=a.device)
    amount = min(max(int(amount), 0), 257)
    if amount >= 256:
        return fill[..., None].expand(a.shape).clone()
    word, bit = divmod(amount, 32)
    fills = fill[..., None].expand(batch + (word + 1,))
    if left:
        # limb i takes a[i - word] (low part) and a[i - word - 1] (high)
        padded = torch.cat([fills, a], dim=-1)
        lo = padded[..., 1:1 + NUM_LIMBS]
        hi = padded[..., 0:NUM_LIMBS]
        if bit == 0:
            return lo.clone()
        return ((lo << bit) & MASK32) | (hi >> (32 - bit))
    padded = torch.cat([a, fills], dim=-1)
    lo = padded[..., word:word + NUM_LIMBS]
    hi = padded[..., word + 1:word + 1 + NUM_LIMBS]
    if bit == 0:
        return lo.clone()
    return (lo >> bit) | ((hi << (32 - bit)) & MASK32)


def _lane_shift(a, amount, left: bool, fill):
    """Shift by an int64 tensor over the batch (0..257)."""
    word = amount // 32
    bit = amount % 32
    out = []
    for i in range(NUM_LIMBS):
        if left:
            lo = _limb_select(a, i - word, fill)
            hi = _limb_select(a, i - word - 1, fill)
            # a shift by 32 - 0 = 32 leaves nothing of a 32-bit limb
            out.append(((lo << bit) & MASK32) | (hi >> (32 - bit)))
        else:
            lo = _limb_select(a, i + word, fill)
            hi = _limb_select(a, i + word + 1, fill)
            out.append((lo >> bit) | ((hi << (32 - bit)) & MASK32))
    result = torch.stack(out, dim=-1)
    return torch.where((amount >= 256)[..., None], fill[..., None], result)


def shl(a, amount: Amount):
    """a << amount mod 2^256."""
    if not isinstance(amount, torch.Tensor):
        return _static_shift(a, amount, left=True)
    amount = _norm_amount(amount, a.shape[:-1], a.device)
    zero = torch.zeros(a.shape[:-1], dtype=DTYPE, device=a.device)
    return _lane_shift(a, amount, True, zero)


def lshr(a, amount: Amount):
    """Logical a >> amount."""
    if not isinstance(amount, torch.Tensor):
        return _static_shift(a, amount, left=False)
    amount = _norm_amount(amount, a.shape[:-1], a.device)
    zero = torch.zeros(a.shape[:-1], dtype=DTYPE, device=a.device)
    return _lane_shift(a, amount, False, zero)


def sar(a, amount: Amount):
    """Arithmetic a >> amount (EVM SAR: fill with the sign bit)."""
    fill = torch.where((a[..., -1] >> 31) == 1, MASK32, 0).to(DTYPE)
    if not isinstance(amount, torch.Tensor):
        return _static_shift(a, amount, left=False, fill=fill)
    amount = _norm_amount(amount, a.shape[:-1], a.device)
    return _lane_shift(a, amount, False, fill)


def _wide_amount(amount_limbs):
    """An 8-limb shift amount as a narrow one: any nonzero high limb (or
    a low limb of 257 or more) becomes 257."""
    high = torch.any(amount_limbs[..., 1:] != 0, dim=-1)
    low = amount_limbs[..., 0].clamp(max=257)
    return torch.where(high, 257, low)


def shl_wide(a, amount_limbs):
    """a << amount where the amount is itself a word (EVM SHL)."""
    return shl(a, _wide_amount(amount_limbs))


def lshr_wide(a, amount_limbs):
    """Logical a >> amount with a word amount (EVM SHR)."""
    return lshr(a, _wide_amount(amount_limbs))


def sar_wide(a, amount_limbs):
    """Arithmetic a >> amount with a word amount (EVM SAR)."""
    return sar(a, _wide_amount(amount_limbs))


# ---------------------------------------------------------------------------
# multiplication
# ---------------------------------------------------------------------------

_COLUMN_MASKS = {}


def _column_mask(device):
    """[16, 16, 16] 0/1: column k gathers the half-limb products i + j = k."""
    mask = _COLUMN_MASKS.get(device)
    if mask is None:
        i = torch.arange(16)
        mask = ((i[None, :, None] + i[None, None, :]) == i[:, None, None])
        mask = _COLUMN_MASKS[device] = mask.to(DTYPE).to(device)
    return mask


def mul(a, b):
    """(a * b) mod 2^256, by 16-bit half-limbs as the JAX package does:
    every half-limb product is below 2^32 and a column of them below
    2^36, so int64 holds the schoolbook sums exactly."""
    a, b = torch.broadcast_tensors(a, b)
    ah = torch.stack([a & 0xFFFF, a >> 16], dim=-1).flatten(-2)  # [..., 16]
    bh = torch.stack([b & 0xFFFF, b >> 16], dim=-1).flatten(-2)
    prod = ah[..., :, None] * bh[..., None, :]  # [..., 16, 16]
    cols = (prod[..., None, :, :] * _column_mask(a.device)).sum((-1, -2))
    carry = torch.zeros(a.shape[:-1], dtype=DTYPE, device=a.device)
    halves = []
    for k in range(16):
        total = cols[..., k] + carry
        halves.append(total & 0xFFFF)
        carry = total >> 16
    return torch.stack(
        [halves[2 * i] | (halves[2 * i + 1] << 16) for i in range(NUM_LIMBS)],
        dim=-1,
    )
