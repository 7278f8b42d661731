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

``udivmod``, ``sdiv``, ``smod`` and ``exp`` are the JAX package's
256-round ``lax.fori_loop`` loops written as eager loops.  Only the
lockstep interpreter's plain step (``ops/lockstep.py``) calls them; its
kernel (``csrc/lockstep.cu``) has them as device functions.
"""

from typing import Tuple, Union

import numpy as np
import torch

from mythril_tpu_torch.ops import default_device

NUM_LIMBS = 8
MASK32 = 0xFFFFFFFF
DTYPE = torch.int64

Amount = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# host <-> tensor conversion
# ---------------------------------------------------------------------------


def from_int(value: int, batch_shape: Tuple[int, ...] = (),
             device=None) -> torch.Tensor:
    """Python int -> int64[*batch_shape, 8] limbs (value broadcast), on
    ``device`` (the card when None, as ``ops.default_device`` resolves
    it)."""
    value &= (1 << 256) - 1
    limbs = torch.tensor(
        [(value >> (32 * i)) & MASK32 for i in range(NUM_LIMBS)],
        dtype=DTYPE, device=default_device(device),
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


def bytes_to_limbs(data):
    """uint8[..., 32] big-endian byte windows -> int64[..., 8] limb words
    (``from_int(int.from_bytes(row, "big"))`` a row)."""
    data = data.to(DTYPE)
    limbs = []
    for limb in range(NUM_LIMBS):
        # limb k covers big-endian bytes [32-4k-4, 32-4k)
        base = 32 - 4 * limb - 4
        limbs.append((data[..., base] << 24) | (data[..., base + 1] << 16)
                     | (data[..., base + 2] << 8) | data[..., base + 3])
    return torch.stack(limbs, dim=-1)


def limbs_to_bytes(word):
    """int64[..., 8] limb words -> uint8[..., 32] big-endian byte windows
    (inverse of :func:`bytes_to_limbs`)."""
    cols = []
    for limb in range(NUM_LIMBS - 1, -1, -1):
        for shift in (24, 16, 8, 0):
            cols.append((word[..., limb] >> shift) & 0xFF)
    return torch.stack(cols, dim=-1).to(torch.uint8)


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


def bit_and(a, b):
    return a & b


def bit_or(a, b):
    return a | b


def bit_xor(a, b):
    return a ^ b


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

_COLUMNS = {}


def _columns(device):
    """The half-limb products that fall below 2^256, as flat indices into
    the [16 x 16] product table, and the column (i + j) each adds to."""
    cols = _COLUMNS.get(device)
    if cols is None:
        pairs = [(i, j) for i in range(16) for j in range(16 - i)]
        cols = _COLUMNS[device] = (
            torch.tensor([16 * i + j for i, j in pairs], device=device),
            torch.tensor([i + j for i, j in pairs], device=device))
    return cols


def mul(a, b):
    """(a * b) mod 2^256, by 16-bit half-limbs as the JAX package does:
    every half-limb product is below 2^32 and a column of them below
    2^36, so int64 holds the schoolbook sums exactly."""
    a, b = torch.broadcast_tensors(a, b)
    ah = torch.stack([a & 0xFFFF, a >> 16], dim=-1).flatten(-2)  # [..., 16]
    bh = torch.stack([b & 0xFFFF, b >> 16], dim=-1).flatten(-2)
    prod = (ah[..., :, None] * bh[..., None, :]).flatten(-2)  # [..., 256]
    pair, column = _columns(a.device)
    cols = torch.zeros(a.shape[:-1] + (16,), dtype=DTYPE, device=a.device)
    cols = cols.index_add(-1, column, prod.index_select(-1, pair))
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


# ---------------------------------------------------------------------------
# division / modulo / exponentiation
# ---------------------------------------------------------------------------


def _shl1_with_bit(r, bit):
    """(r << 1) | bit, ``bit`` an int64 0/1 tensor over the batch."""
    carry_in = torch.cat([bit[..., None].to(DTYPE), r[..., :-1] >> 31],
                         dim=-1)
    return ((r << 1) & MASK32) | carry_in


def _bit_at(a, index: int):
    """Bit ``index`` (0 = LSB) of each word, as int64 0/1."""
    return (a[..., index // 32] >> (index % 32)) & 1


def _max_bit_length(a) -> int:
    """The largest bit length of the batch's words."""
    used = torch.nonzero((a != 0).reshape(-1, NUM_LIMBS).any(0))
    if used.numel() == 0:
        return 0
    top = int(used.max())
    return 32 * top + int(a[..., top].max()).bit_length()


def _sub_borrow(a, b):
    """((a - b) mod 2^256, a < b): the difference and its borrow out."""
    out = []
    borrow = torch.zeros(a.shape[:-1], dtype=DTYPE, device=a.device)
    for i in range(NUM_LIMBS):
        t = a[..., i] - b[..., i] - borrow
        borrow = (t < 0).to(DTYPE)
        out.append(t & MASK32)
    return torch.stack(out, dim=-1), borrow == 1


def udivmod(a, b):
    """(a // b, a % b) with the EVM's x/0 = 0 and x%0 = 0: restoring long
    division, the JAX package's 256-round ``fori_loop``.  The rounds
    above the batch's highest dividend bit leave every quotient and
    remainder 0 (or zeroed with a zero divisor), so they are skipped."""
    a, b = torch.broadcast_tensors(a, b)
    q = torch.zeros_like(a)
    r = torch.zeros_like(a)
    for i in range(_max_bit_length(a) - 1, -1, -1):
        r2 = _shl1_with_bit(r, _bit_at(a, i))
        diff, below = _sub_borrow(r2, b)  # below: r2 < b
        r = torch.where(below[..., None], r2, diff)
        q = _shl1_with_bit(q, (~below).to(DTYPE))
    div_zero = is_zero(b)[..., None]
    return (torch.where(div_zero, 0, q), torch.where(div_zero, 0, r))


def _abs_signed(a):
    negative = (a[..., -1] >> 31) == 1
    return torch.where(negative[..., None], neg(a), a), negative


def sdiv(a, b):
    """EVM SDIV: truncated signed division, x/0 = 0 (MIN / -1 wraps)."""
    aa, na = _abs_signed(a)
    ab, nb = _abs_signed(b)
    q, _ = udivmod(aa, ab)
    return torch.where((na ^ nb)[..., None], neg(q), q)


def smod(a, b):
    """EVM SMOD: the result takes the dividend's sign, x%0 = 0."""
    aa, na = _abs_signed(a)
    ab, _ = _abs_signed(b)
    _, r = udivmod(aa, ab)
    return torch.where(na[..., None], neg(r), r)


def exp(a, e):
    """a ** e mod 2^256 by square-and-multiply, the JAX package's
    256-round ``fori_loop``; the rounds above the batch's highest
    exponent bit multiply nothing in, so they are skipped."""
    a, e = torch.broadcast_tensors(a, e)
    result = torch.zeros_like(a)
    result[..., 0] = 1
    base = a
    for i in range(_max_bit_length(e)):
        bit = _bit_at(e, i) == 1
        result = torch.where(bit[..., None], mul(result, base), result)
        base = mul(base, base)
    return result
