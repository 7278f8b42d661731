"""Limb-plane abstract domains of the word tier, in PyTorch (own copy of
``mythril_tpu/ops/word_prop.py``).

Every term value of width up to 256 is abstracted by two domains at
once, both as 8 x 32-bit little-endian limb planes (``ops/u256.py``'s
``int64``-held limbs):

- an unsigned **interval** ``[lo, hi]``;
- **known bits** ``(km, kv)``: ``km`` has a 1 where the bit is the same
  in every feasible assignment, ``kv`` holds those values
  (``kv & ~km == 0``).

Widths below 256 embed in the low bits: every bit at or above the width
is known zero and ``hi <= 2^width - 1``.  Every plane function
broadcasts over a leading lane axis and takes tensors on any device;
the values equal the JAX package's limb for limb.  Every transfer
over-approximates, so an empty abstraction (``lo > hi`` after the
cross-refinement, or conflicting known bits) proves that no assignment
exists.

The ``s_*`` functions at the end are the same transfers over Python
ints, one lane at a time: the word tier's scalar executor, which the
CDCL tail's one-query batches take.
"""

from typing import Tuple

import torch

from mythril_tpu_torch.ops import default_device, u256
from mythril_tpu_torch.ops.u256 import DTYPE, MASK32, NUM_LIMBS

#: AbstractWord = (lo, hi, km, kv), each int64[..., NUM_LIMBS]
Word = Tuple


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


# Each constructor runs on ``device``, which resolves as every entry point
# of the port does (``ops.default_device``): the card when it is None.


def ones_plane(batch_shape, device=None):
    return torch.full(tuple(batch_shape) + (NUM_LIMBS,), MASK32,
                      dtype=DTYPE, device=default_device(device))


def zeros_plane(batch_shape, device=None):
    return torch.zeros(tuple(batch_shape) + (NUM_LIMBS,), dtype=DTYPE,
                       device=default_device(device))


def width_mask(width: int, batch_shape, device=None):
    """2^width - 1 as a limb plane (width in [0, 256])."""
    return u256.from_int((1 << width) - 1, tuple(batch_shape), device)


def top(width: int, batch_shape, device=None) -> Word:
    """No information beyond the width bound."""
    device = default_device(device)
    wm = width_mask(width, batch_shape, device)
    return (zeros_plane(batch_shape, device), wm, u256.bit_not(wm),
            zeros_plane(batch_shape, device))


def const_word(value: int, width: int, batch_shape, device=None) -> Word:
    device = default_device(device)
    v = u256.from_int(value & ((1 << width) - 1), tuple(batch_shape), device)
    return (v, v, ones_plane(batch_shape, device), v)


def to_ints(word: Word, lane) -> Tuple[int, int, int, int]:
    """One lane's (lo, hi, km, kv) as Python ints."""
    return tuple(u256.to_int(plane[lane]) for plane in word)


# ---------------------------------------------------------------------------
# limb-plane bit machinery
# ---------------------------------------------------------------------------


def any_bit(x):
    """[...] bool: any bit set in the plane."""
    return torch.any(x != 0, dim=-1)


def get_bit(x, index: int):
    """Static bit ``index`` of each plane -> bool[...]"""
    return ((x[..., index // 32] >> (index % 32)) & 1) != 0


def umin(a, b):
    return torch.where(u256.ult(a, b)[..., None], a, b)


def umax(a, b):
    return torch.where(u256.ult(a, b)[..., None], b, a)


def smear_down(x):
    """Propagate every set bit into all lower positions: a limb-local
    shift-or cascade, then all-ones for every limb below a nonzero
    one."""
    for shift in (1, 2, 4, 8, 16):
        x = x | (x >> shift)
    nz = (x != 0).to(DTYPE)
    rev = torch.flip(nz, [-1])
    cum = torch.cumsum(rev, dim=-1)
    above = torch.flip((cum - rev) > 0, [-1])
    return torch.where(above, MASK32, x)


def prefix_mask(x):
    """Mask of the bits strictly above the most significant set bit of
    ``x`` (all ones when x == 0)."""
    return u256.bit_not(smear_down(x))


def trailing_known_mask(km):
    """Mask of the contiguous known bits starting at bit 0."""
    limb_trail = km & (((km + 1) & MASK32) ^ MASK32)  # trailing ones
    nf = (km != MASK32).to(DTYPE)
    cum = torch.cumsum(nf, dim=-1)
    lower_all_full = (cum - nf) == 0  # every lower limb is all ones
    return torch.where(lower_all_full, limb_trail, 0)


def popcount(x):
    """int64[...] population count of the whole 256-bit plane."""
    v = x - ((x >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    per_limb = ((v * 0x01010101) >> 24) & 0xFF
    return per_limb.sum(dim=-1)


def bit_length(x):
    """int64[...]: position of the MSB + 1 (0 for x == 0)."""
    return popcount(smear_down(x))


# ---------------------------------------------------------------------------
# refinement / meet
# ---------------------------------------------------------------------------


def refine(lo, hi, km, kv, wm):
    """Cross-refine interval <-> known bits and detect emptiness; returns
    ``((lo, hi, km, kv), empty)``."""
    kv = kv & km
    minv = kv
    maxv = kv | (u256.bit_not(km) & wm)
    lo = umax(lo, minv)
    hi = umin(hi, maxv)
    agree = prefix_mask(lo ^ hi)
    conflict = any_bit(km & agree & (kv ^ (lo & agree)))
    km = km | agree
    kv = (kv | (lo & agree)) & km
    empty = u256.ult(hi, lo) | conflict
    return (lo, hi, km, kv), empty


def meet(a: Word, b: Word, wm):
    """Greatest lower bound of two abstractions of the same value;
    returns ``(word, empty)``."""
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    conflict = any_bit(km_a & km_b & (kv_a ^ kv_b))
    word, empty = refine(
        umax(lo_a, lo_b), umin(hi_a, hi_b),
        km_a | km_b, (kv_a | kv_b) & (km_a | km_b), wm,
    )
    return word, empty | conflict


def join(a: Word, b: Word, wm):
    """Least upper bound (either value possible: the ite merge)."""
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    km = km_a & km_b & u256.bit_not(kv_a ^ kv_b)
    return (umin(lo_a, lo_b), umax(hi_a, hi_b), km, kv_a & km)


def select_word(mask, a: Word, b: Word):
    """Per-lane select: ``a`` where mask else ``b`` (mask is [...])."""
    m = mask[..., None]
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# forward transfer functions (each closes with refine())
# ---------------------------------------------------------------------------


def f_add(a: Word, b: Word, width: int, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    s_lo, c_lo = u256.add_carry(lo_a, lo_b)
    s_hi, c_hi = u256.add_carry(hi_a, hi_b)
    if width == 256:
        w_lo, w_hi = c_lo != 0, c_hi != 0
    else:
        # operands < 2^width, width < 256: the wrap bit is bit `width`
        w_lo, w_hi = get_bit(s_lo, width), get_bit(s_hi, width)
    same = (w_lo == w_hi)[..., None]
    lo = torch.where(same, s_lo & wm, 0)
    hi = torch.where(same, s_hi & wm, wm)
    tm = trailing_known_mask(km_a) & trailing_known_mask(km_b) & wm
    km = tm | u256.bit_not(wm)
    kv = u256.add(kv_a, kv_b) & tm
    return refine(lo, hi, km, kv, wm)


def f_sub(a: Word, b: Word, width: int, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    b_lo = u256.ult(lo_a, hi_b)
    b_hi = u256.ult(hi_a, lo_b)
    same = (b_lo == b_hi)[..., None]
    lo = torch.where(same, u256.sub(lo_a, hi_b) & wm, 0)
    hi = torch.where(same, u256.sub(hi_a, lo_b) & wm, wm)
    tm = trailing_known_mask(km_a) & trailing_known_mask(km_b) & wm
    km = tm | u256.bit_not(wm)
    kv = u256.sub(kv_a, kv_b) & tm
    return refine(lo, hi, km, kv, wm)


def f_mul(a: Word, b: Word, width: int, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    tm = trailing_known_mask(km_a) & trailing_known_mask(km_b) & wm
    km = tm | u256.bit_not(wm)
    kv = u256.mul(kv_a, kv_b) & tm
    fits = ((bit_length(hi_a) + bit_length(hi_b)) <= width)[..., None]
    lo = torch.where(fits, u256.mul(lo_a, lo_b), 0)
    hi = torch.where(fits, u256.mul(hi_a, hi_b), wm)
    return refine(lo, hi, km, kv, wm)


def f_udiv(a: Word, b: Word, width: int, wm):
    """SMT-LIB bvudiv (a / 0 = 2^width - 1), division-free: bounds from
    the divisor's bit lengths, exact for a singleton power of two."""
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, _km_b, _kv_b = b
    batch = lo_a.shape[:-1]
    bz = ~any_bit(hi_b)  # divisor identically zero
    nz = any_bit(lo_b)   # divisor never zero
    amt = (bit_length(lo_b) - 1).clamp(min=0)
    lo = u256.lshr(lo_a, bit_length(hi_b))
    lo = torch.where(bz[..., None], wm, lo)
    hi = torch.where(nz[..., None], u256.lshr(hi_a, amt), wm)
    pow2 = nz & u256.eq(lo_b, hi_b) & (popcount(lo_b) == 1)
    vacated = u256.bit_not(u256.lshr(ones_plane(batch, lo_a.device), amt))
    km_s = u256.lshr(km_a, amt) | vacated
    km = torch.where(pow2[..., None], km_s, 0) | u256.bit_not(wm)
    kv = torch.where(pow2[..., None], u256.lshr(kv_a, amt), 0) & km & wm
    lo = torch.where(pow2[..., None], u256.lshr(lo_a, amt), lo)
    return refine(lo, hi, km, kv, wm)


def f_urem(a: Word, b: Word, width: int, wm):
    """SMT-LIB bvurem (a mod 0 = a), division-free like :func:`f_udiv`."""
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, _km_b, _kv_b = b
    batch = lo_a.shape[:-1]
    one = width_mask(1, batch, lo_a.device)
    nz = any_bit(lo_b)
    bound = umin(hi_a, u256.sub(hi_b, one))
    hi = torch.where(nz[..., None], bound, hi_a)
    lo = zeros_plane(batch, lo_a.device)
    pow2 = nz & u256.eq(lo_b, hi_b) & (popcount(lo_b) == 1)
    mask = u256.sub(lo_b, one)
    km = (torch.where(pow2[..., None], km_a | u256.bit_not(mask), 0)
          | u256.bit_not(wm))
    kv = torch.where(pow2[..., None], kv_a & mask, 0) & km & wm
    hi = torch.where(pow2[..., None], umin(hi_a, mask), hi)
    ident = ~any_bit(hi_b) | (nz & u256.ult(hi_a, lo_b))
    m = ident[..., None]
    lo = torch.where(m, lo_a, lo)
    hi = torch.where(m, hi_a, hi)
    km = torch.where(m, km_a, km)
    kv = torch.where(m, kv_a, kv)
    return refine(lo, hi, km, kv, wm)


def f_and(a: Word, b: Word, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    k0 = (km_a & u256.bit_not(kv_a)) | (km_b & u256.bit_not(kv_b))
    k1 = (km_a & kv_a) & (km_b & kv_b)
    hi = umin(hi_a, hi_b)  # a & b <= min(a, b)
    return refine(zeros_plane(lo_a.shape[:-1], lo_a.device), hi, k0 | k1,
                  k1, wm)


def f_or(a: Word, b: Word, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    k1 = (km_a & kv_a) | (km_b & kv_b)
    k0 = (km_a & u256.bit_not(kv_a)) & (km_b & u256.bit_not(kv_b))
    lo = umax(lo_a, lo_b)  # a | b >= max(a, b)
    return refine(lo, wm.expand_as(lo), k0 | k1, k1, wm)


def f_xor(a: Word, b: Word, wm):
    lo_a, _hi_a, km_a, kv_a = a
    _lo_b, _hi_b, km_b, kv_b = b
    km = km_a & km_b
    kv = (kv_a ^ kv_b) & km
    return refine(zeros_plane(lo_a.shape[:-1], lo_a.device),
                  wm.expand_as(lo_a), km, kv, wm)


def f_not(a: Word, width: int, wm):
    lo_a, hi_a, km_a, kv_a = a
    # (~a) & wm == wm - a: exact and monotone-decreasing
    lo = u256.sub(wm, hi_a)
    hi = u256.sub(wm, lo_a)
    km = (km_a & wm) | u256.bit_not(wm)
    kv = u256.bit_not(kv_a) & km_a & wm
    return refine(lo, hi, km, kv, wm)


def _known_amount(b: Word):
    """(amount_known[...], amount int64[...]) from the shift operand: a
    singleton interval pins the amount; any nonzero high limb is the
    overflow representative 257."""
    lo_b, hi_b, _km, _kv = b
    known = u256.eq(lo_b, hi_b)
    high = torch.any(lo_b[..., 1:] != 0, dim=-1)
    small = torch.where(high, 257, lo_b[..., 0].clamp(max=257))
    return known, small


def f_shl(a: Word, b: Word, width: int, wm):
    lo_a, hi_a, km_a, kv_a = a
    known, amt = _known_amount(b)
    shifted_ones = u256.shl(ones_plane(lo_a.shape[:-1], lo_a.device), amt)
    km_s = u256.shl(km_a, amt) | u256.bit_not(shifted_ones)
    kv_s = u256.shl(kv_a, amt)
    km = torch.where(known[..., None], km_s & wm, 0) | u256.bit_not(wm)
    kv = torch.where(known[..., None], kv_s, 0) & km & wm
    fits = known & ((bit_length(hi_a) + amt) <= width)
    lo = torch.where(fits[..., None], u256.shl(lo_a, amt), 0)
    hi = torch.where(fits[..., None], u256.shl(hi_a, amt), wm)
    return refine(lo, hi, km, kv, wm)


def f_lshr(a: Word, b: Word, width: int, wm):
    lo_a, hi_a, km_a, kv_a = a
    known, amt = _known_amount(b)
    shifted_ones = u256.lshr(ones_plane(lo_a.shape[:-1], lo_a.device), amt)
    km_s = u256.lshr(km_a, amt) | u256.bit_not(shifted_ones)
    kv_s = u256.lshr(kv_a, amt)
    km = torch.where(known[..., None], km_s, 0) | u256.bit_not(wm)
    kv = torch.where(known[..., None], kv_s, 0) & km & wm
    # right shift never increases the value
    lo = torch.where(known[..., None], u256.lshr(lo_a, amt), 0)
    hi = torch.where(known[..., None], u256.lshr(hi_a, amt), hi_a)
    return refine(lo, hi, km, kv, wm)


def f_ashr(a: Word, b: Word, width: int, wm):
    """terms.ashr: exact (it is lshr) when the sign bit is known zero,
    top otherwise."""
    lo_a, _hi_a, km_a, kv_a = a
    sign_known0 = get_bit(km_a, width - 1) & ~get_bit(kv_a, width - 1)
    shifted, empty = f_lshr(a, b, width, wm)
    t = top(width, lo_a.shape[:-1], lo_a.device)
    word = select_word(sign_known0, shifted, t)
    return word, empty & sign_known0


def f_extract(a: Word, high: int, low: int, wm_new):
    lo_a, hi_a, km_a, kv_a = a
    km = (u256.lshr(km_a, low) & wm_new) | u256.bit_not(wm_new)
    kv = u256.lshr(kv_a, low) & wm_new & km
    # the interval shifts down exactly when no feasible value has bits
    # above `high`
    batch = lo_a.shape[:-1]
    keep = u256.ule(hi_a, width_mask(high + 1, batch, lo_a.device))[..., None]
    lo = torch.where(keep, u256.lshr(lo_a, low), 0)
    hi = torch.where(keep, u256.lshr(hi_a, low), wm_new)
    return refine(lo, hi, km, kv, wm_new)


def f_sext(a: Word, old_width: int, new_width: int, wm_new):
    lo_a, hi_a, km_a, kv_a = a
    batch = lo_a.shape[:-1]
    dev = lo_a.device
    hmask = width_mask(new_width, batch, dev) & u256.bit_not(
        width_mask(old_width, batch, dev))
    sign_known = get_bit(km_a, old_width - 1)
    sign_val = get_bit(kv_a, old_width - 1)
    wm_old = width_mask(old_width, batch, dev)
    # negative branch: v -> v | hmask (monotone on the all-negative set)
    neg = ((km_a | hmask), ((kv_a & wm_old) | hmask),
           (lo_a | hmask), (hi_a | hmask))
    pos = (km_a | hmask, kv_a & wm_old, lo_a, hi_a)
    unk = ((km_a & wm_old) | u256.bit_not(wm_new), kv_a & wm_old,
           zeros_plane(batch, dev), wm_new.expand_as(lo_a))
    pick_neg = (sign_known & sign_val)[..., None]
    pick_pos = (sign_known & ~sign_val)[..., None]
    km, kv, lo, hi = (
        torch.where(pick_neg, n, torch.where(pick_pos, p, u))
        for n, p, u in zip(neg, pos, unk)
    )
    return refine(lo, hi, km & wm_new | u256.bit_not(wm_new),
                  kv & wm_new, wm_new)


def f_concat(parts, offsets, widths, total_width: int, wm):
    """Parts occupy disjoint bit ranges [off, off + w): ORs of shifted
    planes are exact for the bits and valid for the bounds."""
    lo_0 = parts[0][0]
    batch, dev = lo_0.shape[:-1], lo_0.device
    lo = zeros_plane(batch, dev)
    hi = zeros_plane(batch, dev)
    km = u256.bit_not(wm).expand_as(lo)
    kv = zeros_plane(batch, dev)
    for (p_lo, p_hi, p_km, p_kv), off, w in zip(parts, offsets, widths):
        pwm = width_mask(w, batch, dev)
        lo = lo | u256.shl(p_lo, off)
        hi = hi | u256.shl(p_hi, off)
        km = km | u256.shl(p_km & pwm, off)
        kv = kv | u256.shl(p_kv & pwm, off)
    return refine(lo, hi, km, kv, wm)


# ---------------------------------------------------------------------------
# predicates -> tri-state int8[...] (+1 must-true, -1 must-false, 0 open)
# ---------------------------------------------------------------------------


def _tri(must, never):
    return torch.where(must, 1, torch.where(never, -1, 0)).to(torch.int8)


def p_eq(a: Word, b: Word):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    single = (u256.eq(lo_a, hi_a) & u256.eq(lo_b, hi_b)
              & u256.eq(lo_a, lo_b))
    apart = (u256.ult(hi_a, lo_b) | u256.ult(hi_b, lo_a)
             | any_bit(km_a & km_b & (kv_a ^ kv_b)))
    return _tri(single, apart)


def p_ult(a: Word, b: Word):
    return _tri(u256.ult(a[1], b[0]), u256.ule(b[1], a[0]))


def p_ule(a: Word, b: Word):
    return _tri(u256.ule(a[1], b[0]), u256.ult(b[1], a[0]))


def _signs(a: Word, width: int):
    _, _, km, kv = a
    return get_bit(km, width - 1), get_bit(kv, width - 1)


def _signed(a: Word, b: Word, width: int, unsigned):
    ka, sa = _signs(a, width)
    kb, sb = _signs(b, width)
    both = ka & kb
    # same sign: two's-complement order == unsigned order; mixed signs:
    # the negative side is smaller
    out = torch.where(
        both & (sa & ~sb), 1,
        torch.where(both & (~sa & sb), -1,
                    torch.where(both, unsigned.to(DTYPE), 0)),
    )
    return out.to(torch.int8)


def p_slt(a: Word, b: Word, width: int):
    return _signed(a, b, width, p_ult(a, b))


def p_sle(a: Word, b: Word, width: int):
    return _signed(a, b, width, p_ule(a, b))


# ---------------------------------------------------------------------------
# backward (assertion) refinements
# ---------------------------------------------------------------------------


def b_ult_true(a: Word, b: Word, wm, strict: bool = True):
    """Assert a < b (a <= b with strict=False): shrink a's upper bound to
    b's reach and raise b's floor past a's.  Returns ``(a', b',
    empty)``."""
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    batch = lo_a.shape[:-1]
    if strict:
        one = u256.from_int(1, tuple(batch), lo_a.device)
        # a < b needs b >= 1 and a <= wm - 1
        dead = u256.is_zero(hi_b) | u256.eq(lo_a, wm)
        new_hi_a = umin(hi_a, u256.sub(hi_b, one))
        new_lo_b = umax(lo_b, u256.add(lo_a, one))
    else:
        dead = torch.zeros(tuple(batch), dtype=torch.bool,
                           device=lo_a.device)
        new_hi_a = umin(hi_a, hi_b)
        new_lo_b = umax(lo_b, lo_a)
    a2, empty_a = refine(lo_a, new_hi_a, km_a, kv_a, wm)
    b2, empty_b = refine(new_lo_b, hi_b, km_b, kv_b, wm)
    return a2, b2, dead | empty_a | empty_b


# ---------------------------------------------------------------------------
# scalar twins (Python ints, one lane at a time): the word tier's scalar
# executor.  Scalar words are (lo, hi, km, kv); wm = 2^width - 1.
# ---------------------------------------------------------------------------

FULL = (1 << 256) - 1


def s_top(wm: int):
    return (0, wm, FULL ^ wm, 0)


def s_const(value: int, wm: int):
    v = value & wm
    return (v, v, FULL, v)


def s_trailing_known(km: int) -> int:
    """Mask of the contiguous known bits from bit 0 (256-bit view)."""
    return (((km + 1) & ~km) - 1) & FULL


def s_refine(lo, hi, km, kv, wm):
    """Scalar twin of :func:`refine`."""
    kv &= km
    lo = max(lo, kv)
    hi = min(hi, kv | (~km & wm))
    x = lo ^ hi
    pm = FULL ^ ((1 << x.bit_length()) - 1)
    conflict = bool(km & pm & (kv ^ (lo & pm)))
    km |= pm
    kv = (kv | (lo & pm)) & km
    return (lo, hi, km, kv), hi < lo or conflict


def s_meet(a, b, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    conflict = bool(km_a & km_b & (kv_a ^ kv_b))
    word, empty = s_refine(
        max(lo_a, lo_b), min(hi_a, hi_b),
        km_a | km_b, (kv_a | kv_b) & (km_a | km_b), wm,
    )
    return word, empty or conflict


def s_join(a, b):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    km = km_a & km_b & ~(kv_a ^ kv_b) & FULL
    return (min(lo_a, lo_b), max(hi_a, hi_b), km, kv_a & km)


def s_add(a, b, width, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    s_lo, s_hi = lo_a + lo_b, hi_a + hi_b
    if (s_lo > wm) == (s_hi > wm):
        lo, hi = s_lo & wm, s_hi & wm
    else:
        lo, hi = 0, wm
    tm = s_trailing_known(km_a) & s_trailing_known(km_b) & wm
    km = tm | (FULL ^ wm)
    kv = (kv_a + kv_b) & tm
    return s_refine(lo, hi, km, kv, wm)


def s_sub(a, b, width, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    if (lo_a < hi_b) == (hi_a < lo_b):
        lo, hi = (lo_a - hi_b) & wm, (hi_a - lo_b) & wm
    else:
        lo, hi = 0, wm
    tm = s_trailing_known(km_a) & s_trailing_known(km_b) & wm
    km = tm | (FULL ^ wm)
    kv = (kv_a - kv_b) & tm
    return s_refine(lo, hi, km, kv, wm)


def s_mul(a, b, width, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    tm = s_trailing_known(km_a) & s_trailing_known(km_b) & wm
    km = tm | (FULL ^ wm)
    kv = (kv_a * kv_b) & tm
    if hi_a.bit_length() + hi_b.bit_length() <= width:
        lo, hi = lo_a * lo_b, hi_a * hi_b
    else:
        lo, hi = 0, wm
    return s_refine(lo, hi, km, kv, wm)


def s_udiv(a, b, width, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, _km_b, _kv_b = b
    km, kv = FULL ^ wm, 0
    if hi_b == 0:  # b == 0: SMT-LIB total definition, a / 0 = wm
        lo = hi = wm
    else:
        lo = lo_a >> hi_b.bit_length()  # b < 2^bl(hi_b)
        if lo_b == 0:  # a zero divisor stays feasible: wm reachable
            hi = wm
        else:
            amt = lo_b.bit_length() - 1  # b >= 2^amt
            hi = hi_a >> amt
            if lo_b == hi_b and lo_b & (lo_b - 1) == 0:
                vacated = FULL ^ (FULL >> amt)
                km = (km_a >> amt) | vacated | (FULL ^ wm)
                kv = (kv_a >> amt) & km & wm
                lo = lo_a >> amt
    return s_refine(lo, hi, km, kv, wm)


def s_urem(a, b, width, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, _km_b, _kv_b = b
    if hi_b == 0 or (lo_b and hi_a < lo_b):
        # b == 0 (SMT-LIB: a mod 0 = a) or a provably < b: identity
        return s_refine(lo_a, hi_a, km_a, kv_a, wm)
    hi = min(hi_a, hi_b - 1) if lo_b else hi_a
    km, kv = FULL ^ wm, 0
    if lo_b and lo_b == hi_b and lo_b & (lo_b - 1) == 0:
        mask = lo_b - 1
        km = km_a | (FULL ^ mask)
        kv = kv_a & mask & km
        hi = min(hi_a, mask)
    return s_refine(0, hi, km, kv, wm)


def s_and(a, b, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    k0 = (km_a & ~kv_a) | (km_b & ~kv_b)
    k1 = km_a & kv_a & km_b & kv_b
    return s_refine(0, min(hi_a, hi_b), (k0 | k1) & FULL, k1, wm)


def s_or(a, b, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    k1 = (km_a & kv_a) | (km_b & kv_b)
    k0 = km_a & ~kv_a & km_b & ~kv_b
    return s_refine(max(lo_a, lo_b), wm, (k0 | k1) & FULL, k1, wm)


def s_xor(a, b, wm):
    _lo_a, _hi_a, km_a, kv_a = a
    _lo_b, _hi_b, km_b, kv_b = b
    km = km_a & km_b
    return s_refine(0, wm, km, (kv_a ^ kv_b) & km, wm)


def s_not(a, width, wm):
    lo_a, hi_a, km_a, kv_a = a
    km = (km_a & wm) | (FULL ^ wm)
    kv = ~kv_a & km_a & wm
    return s_refine(wm - hi_a, wm - lo_a, km, kv, wm)


def s_shl(a, b, width, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, _km_b, _kv_b = b
    if lo_b != hi_b:
        return s_refine(0, wm, FULL ^ wm, 0, wm)
    amt = min(lo_b, 257)
    km = ((km_a << amt) | ((1 << amt) - 1)) & wm | (FULL ^ wm)
    kv = (kv_a << amt) & km & wm
    if hi_a.bit_length() + amt <= width:
        lo, hi = lo_a << amt, hi_a << amt
    else:
        lo, hi = 0, wm
    return s_refine(lo, hi, km, kv, wm)


def s_lshr(a, b, width, wm):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, _km_b, _kv_b = b
    if lo_b != hi_b:
        return s_refine(0, hi_a, FULL ^ wm, 0, wm)
    amt = min(lo_b, 257)
    shifted_in = FULL ^ (FULL >> amt)  # bits vacated by the shift
    km = ((km_a >> amt) | shifted_in) & FULL | (FULL ^ wm)
    kv = (kv_a >> amt) & km & wm
    return s_refine(lo_a >> amt, hi_a >> amt, km, kv, wm)


def s_ashr(a, b, width, wm):
    lo_a, hi_a, km_a, kv_a = a
    sign_bit = 1 << (width - 1)
    if (km_a & sign_bit) and not (kv_a & sign_bit):
        return s_lshr(a, b, width, wm)
    return s_refine(0, wm, FULL ^ wm, 0, wm)


def s_extract(a, high, low, wm_new):
    lo_a, hi_a, km_a, kv_a = a
    km = ((km_a >> low) & wm_new) | (FULL ^ wm_new)
    kv = (kv_a >> low) & wm_new & km
    if hi_a <= (1 << (high + 1)) - 1:
        lo, hi = lo_a >> low, hi_a >> low
    else:
        lo, hi = 0, wm_new
    return s_refine(lo, hi, km, kv, wm_new)


def s_sext(a, old_width, new_width, wm_new):
    lo_a, hi_a, km_a, kv_a = a
    wm_old = (1 << old_width) - 1
    hmask = wm_new ^ wm_old
    sign_bit = 1 << (old_width - 1)
    if km_a & sign_bit:
        if kv_a & sign_bit:
            return s_refine(lo_a | hmask, hi_a | hmask,
                            km_a | hmask, (kv_a & wm_old) | hmask, wm_new)
        return s_refine(lo_a, hi_a, km_a | hmask, kv_a & wm_old, wm_new)
    return s_refine(0, wm_new, (km_a & wm_old) | (FULL ^ wm_new),
                    kv_a & wm_old, wm_new)


def s_concat(parts, offsets, widths, wm):
    lo = hi = kv = 0
    km = FULL ^ wm
    for (p_lo, p_hi, p_km, p_kv), off, w in zip(parts, offsets, widths):
        pwm = (1 << w) - 1
        lo |= p_lo << off
        hi |= p_hi << off
        km |= (p_km & pwm) << off
        kv |= (p_kv & pwm) << off
    return s_refine(lo, hi, km, kv, wm)


def s_ite(cond_tri, a, b):
    if cond_tri == 1:
        return a
    if cond_tri == -1:
        return b
    return s_join(a, b)


def s_p_eq(a, b):
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    if lo_a == hi_a == lo_b == hi_b:
        return 1
    if hi_a < lo_b or hi_b < lo_a or (km_a & km_b & (kv_a ^ kv_b)):
        return -1
    return 0


def s_p_ult(a, b):
    if a[1] < b[0]:
        return 1
    if b[1] <= a[0]:
        return -1
    return 0


def s_p_ule(a, b):
    if a[1] <= b[0]:
        return 1
    if b[1] < a[0]:
        return -1
    return 0


def _s_sign(a, width):
    _lo, _hi, km, kv = a
    sign_bit = 1 << (width - 1)
    if km & sign_bit:
        return bool(kv & sign_bit)
    return None


def s_p_slt(a, b, width):
    sa, sb = _s_sign(a, width), _s_sign(b, width)
    if sa is None or sb is None:
        return 0
    if sa != sb:
        return 1 if sa else -1
    return s_p_ult(a, b)


def s_p_sle(a, b, width):
    sa, sb = _s_sign(a, width), _s_sign(b, width)
    if sa is None or sb is None:
        return 0
    if sa != sb:
        return 1 if sa else -1
    return s_p_ule(a, b)


def s_b_ult_true(a, b, wm, strict=True):
    """Scalar twin of :func:`b_ult_true`; returns (a', b', empty)."""
    lo_a, hi_a, km_a, kv_a = a
    lo_b, hi_b, km_b, kv_b = b
    if strict:
        if hi_b == 0 or lo_a == wm:
            return a, b, True
        new_hi_a = min(hi_a, hi_b - 1)
        new_lo_b = max(lo_b, lo_a + 1)
    else:
        new_hi_a = min(hi_a, hi_b)
        new_lo_b = max(lo_b, lo_a)
    a2, empty_a = s_refine(lo_a, new_hi_a, km_a, kv_a, wm)
    b2, empty_b = s_refine(new_lo_b, hi_b, km_b, kv_b, wm)
    return a2, b2, empty_a or empty_b
