"""Self-contained crypto primitives.

The reference leans on native wheels (`_pysha3` for keccak, `py_ecc` for
bn128, `coincurve`-style ecrecover — mythril/laser/ethereum/natives.py);
none are available here, so the primitives the EVM needs are implemented
from the public specs:

- keccak-256 (original Keccak padding, as Ethereum uses) — pure Python
  sponge over keccak-f[1600].  Hot-path callers should go through
  :func:`keccak256`, which transparently uses the native C implementation
  from ``mythril_tpu_torch/native`` when it has been built.
- secp256k1 public-key recovery for the ECRECOVER precompile.
- alt_bn128 (BN254) G1 point add / scalar mul for precompiles 6 and 7.
- blake2b F compression (EIP-152) for precompile 9.
"""

import hashlib
from typing import List, Optional, Tuple

# --------------------------------------------------------------------------
# keccak-256
# --------------------------------------------------------------------------

_MASK = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets indexed [x][y].
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl(value: int, shift: int) -> int:
    return ((value << shift) | (value >> (64 - shift))) & _MASK


def _keccak_f(lanes: List[List[int]]) -> None:
    for rc in _RC:
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(lanes[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK)
        # iota
        lanes[0][0] ^= rc


def _keccak256_py(data: bytes) -> bytes:
    rate = 136
    # Original Keccak pad10*1 with domain byte 0x01 (NOT the SHA3 0x06).
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    lanes = [[0] * 5 for _ in range(5)]
    for block_start in range(0, len(padded), rate):
        block = padded[block_start : block_start + rate]
        for i in range(rate // 8):
            x, y = i % 5, i // 5
            lanes[x][y] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        _keccak_f(lanes)
    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes
        x, y = i % 5, i // 5
        out += lanes[x][y].to_bytes(8, "little")
    return bytes(out)


_native_keccak = None


def _load_native():
    global _native_keccak
    if _native_keccak is None:
        try:
            from mythril_tpu_torch.native import keccak256 as nk  # noqa: WPS433

            _native_keccak = nk
        except Exception:
            _native_keccak = _keccak256_py
    return _native_keccak


def keccak256(data: bytes) -> bytes:
    return _load_native()(bytes(data))


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def ripemd160(data: bytes) -> bytes:
    h = hashlib.new("ripemd160")
    h.update(data)
    return h.digest()


# --------------------------------------------------------------------------
# secp256k1 recovery (ECRECOVER precompile)
# --------------------------------------------------------------------------

_P = 2**256 - 2**32 - 977
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

Point = Optional[Tuple[int, int]]  # None = point at infinity


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _ec_add(p: Point, q: Point) -> Point:
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0] and (p[1] + q[1]) % _P == 0:
        return None
    if p == q:
        lam = (3 * p[0] * p[0]) * _inv(2 * p[1], _P) % _P
    else:
        lam = (q[1] - p[1]) * _inv(q[0] - p[0], _P) % _P
    x = (lam * lam - p[0] - q[0]) % _P
    y = (lam * (p[0] - x) - p[1]) % _P
    return (x, y)


def _ec_mul(p: Point, k: int) -> Point:
    result: Point = None
    addend = p
    while k:
        if k & 1:
            result = _ec_add(result, addend)
        addend = _ec_add(addend, addend)
        k >>= 1
    return result


def ecrecover_pubkey(msg_hash: bytes, v: int, r: int, s: int) -> Optional[bytes]:
    """Recover the 64-byte uncompressed public key, or None if invalid."""
    if v not in (27, 28) or not (1 <= r < _N) or not (1 <= s < _N):
        return None
    x = r
    # y^2 = x^3 + 7 mod p
    y_sq = (pow(x, 3, _P) + 7) % _P
    y = pow(y_sq, (_P + 1) // 4, _P)
    if y * y % _P != y_sq:
        return None
    if (y % 2) != ((v - 27) % 2):
        y = _P - y
    point_r: Point = (x, y)
    e = int.from_bytes(msg_hash, "big") % _N
    r_inv = _inv(r, _N)
    # Q = r^-1 (s*R - e*G)
    s_r = _ec_mul(point_r, s)
    e_g = _ec_mul((_GX, _GY), (_N - e) % _N)
    q = _ec_mul(_ec_add(s_r, e_g), r_inv)
    if q is None:
        return None
    return q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")


def ecrecover_address(msg_hash: bytes, v: int, r: int, s: int) -> Optional[bytes]:
    """Recover the 20-byte Ethereum address for the ECRECOVER precompile."""
    pubkey = ecrecover_pubkey(msg_hash, v, r, s)
    if pubkey is None:
        return None
    return keccak256(pubkey)[12:]


# --------------------------------------------------------------------------
# alt_bn128 (BN254) G1 — precompiles 0x06 (add) and 0x07 (mul)
# --------------------------------------------------------------------------

BN128_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN128_N = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _bn_on_curve(p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 3) % BN128_P == 0


def bn128_add(p: Point, q: Point) -> Point:
    if not (_bn_on_curve(p) and _bn_on_curve(q)):
        raise ValueError("point not on alt_bn128")
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0] and (p[1] + q[1]) % BN128_P == 0:
        return None
    if p == q:
        lam = (3 * p[0] * p[0]) * _inv(2 * p[1], BN128_P) % BN128_P
    else:
        lam = (q[1] - p[1]) * _inv(q[0] - p[0], BN128_P) % BN128_P
    x = (lam * lam - p[0] - q[0]) % BN128_P
    y = (lam * (p[0] - x) - p[1]) % BN128_P
    return (x, y)


def bn128_mul(p: Point, k: int) -> Point:
    if not _bn_on_curve(p):
        raise ValueError("point not on alt_bn128")
    result: Point = None
    addend = p
    k %= BN128_N
    while k:
        if k & 1:
            result = bn128_add(result, addend)
        addend = bn128_add(addend, addend)
        k >>= 1
    return result


# --------------------------------------------------------------------------
# blake2b F compression (EIP-152) — precompile 0x09
# --------------------------------------------------------------------------

_B2B_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

_B2B_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _rotr64(value: int, shift: int) -> int:
    return ((value >> shift) | (value << (64 - shift))) & _MASK


def blake2b_compress(
    rounds: int, h: List[int], m: List[int], t: Tuple[int, int], final: bool
) -> List[int]:
    v = h[:8] + _B2B_IV[:8]
    v[12] ^= t[0]
    v[13] ^= t[1]
    if final:
        v[14] ^= _MASK

    def mix(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _MASK
        v[d] = _rotr64(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _MASK
        v[b] = _rotr64(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & _MASK
        v[d] = _rotr64(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _MASK
        v[b] = _rotr64(v[b] ^ v[c], 63)

    for round_index in range(rounds):
        s = _B2B_SIGMA[round_index % 10]
        mix(0, 4, 8, 12, m[s[0]], m[s[1]])
        mix(1, 5, 9, 13, m[s[2]], m[s[3]])
        mix(2, 6, 10, 14, m[s[4]], m[s[5]])
        mix(3, 7, 11, 15, m[s[6]], m[s[7]])
        mix(0, 5, 10, 15, m[s[8]], m[s[9]])
        mix(1, 6, 11, 12, m[s[10]], m[s[11]])
        mix(2, 7, 8, 13, m[s[12]], m[s[13]])
        mix(3, 4, 9, 14, m[s[14]], m[s[15]])
    return [(h[i] ^ v[i] ^ v[i + 8]) & _MASK for i in range(8)]


# --------------------------------------------------------------------------
# alt_bn128 (BN254) pairing — precompile 0x08 (EIP-197)
#
# Tower: Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3 - xi), xi = 9 + u;
# Fp12 = Fp6[w]/(w^2 - v).  G2 lives on the D-twist y^2 = x^3 + 3/xi
# over Fp2; points embed into E(Fp12): psi(x, y) = (x w^2, y w^3).
# Optimal ate: Miller loop over 6t+2 (t = 4965661367192848881) with the
# two Frobenius correction steps, then the full final exponentiation
# (p^12-1)/n by square-and-multiply (exactness over speed: precompile
# calls are rare in analysis).
# Reference behavioral contract: mythril/laser/ethereum/natives.py:164-196
# (word order imag-first, [] on invalid input, G2 subgroup check).
# --------------------------------------------------------------------------

_BN_T = 4965661367192848881                  # BN parameter
_ATE_LOOP_COUNT = 6 * _BN_T + 2


class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % BN128_P
        self.c1 = c1 % BN128_P

    def __eq__(self, other):
        return self.c0 == other.c0 and self.c1 == other.c1

    def __add__(self, other):
        return Fp2(self.c0 + other.c0, self.c1 + other.c1)

    def __sub__(self, other):
        return Fp2(self.c0 - other.c0, self.c1 - other.c1)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, other):
        if isinstance(other, int):
            return Fp2(self.c0 * other, self.c1 * other)
        a0, a1, b0, b1 = self.c0, self.c1, other.c0, other.c1
        return Fp2(a0 * b0 - a1 * b1, a0 * b1 + a1 * b0)

    def conj(self):
        return Fp2(self.c0, -self.c1)

    def inv(self):
        norm = _inv(self.c0 * self.c0 + self.c1 * self.c1, BN128_P)
        return Fp2(self.c0 * norm, -self.c1 * norm)

    def pow(self, e: int) -> "Fp2":
        result, base = Fp2(1, 0), self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def is_zero(self):
        return self.c0 == 0 and self.c1 == 0


_XI = Fp2(9, 1)                               # v^3 = xi
_B2 = _XI.inv() * 3                           # twisted-curve b = 3/xi


class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fp6(Fp2(0, 0), Fp2(0, 0), Fp2(0, 0))

    @staticmethod
    def one():
        return Fp6(Fp2(1, 0), Fp2(0, 0), Fp2(0, 0))

    def __eq__(self, other):
        return (
            self.c0 == other.c0 and self.c1 == other.c1 and self.c2 == other.c2
        )

    def __add__(self, other):
        return Fp6(self.c0 + other.c0, self.c1 + other.c1, self.c2 + other.c2)

    def __sub__(self, other):
        return Fp6(self.c0 - other.c0, self.c1 - other.c1, self.c2 - other.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, other):
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = other.c0, other.c1, other.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + _XI * ((a1 + a2) * (b1 + b2) - t1 - t2)
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + _XI * t2
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def mul_by_v(self):
        """v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2."""
        return Fp6(_XI * self.c2, self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        c0 = a0 * a0 - _XI * (a1 * a2)
        c1 = _XI * (a2 * a2) - a0 * a1
        c2 = a1 * a1 - a0 * a2
        t = (a0 * c0 + _XI * (a2 * c1 + a1 * c2)).inv()
        return Fp6(c0 * t, c1 * t, c2 * t)


class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one():
        return Fp12(Fp6.one(), Fp6.zero())

    def __eq__(self, other):
        return self.c0 == other.c0 and self.c1 == other.c1

    def __add__(self, other):
        return Fp12(self.c0 + other.c0, self.c1 + other.c1)

    def __sub__(self, other):
        return Fp12(self.c0 - other.c0, self.c1 - other.c1)

    def __mul__(self, other):
        a0, a1, b0, b1 = self.c0, self.c1, other.c0, other.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fp12(
            t0 + t1.mul_by_v(),
            (a0 + a1) * (b0 + b1) - t0 - t1,
        )

    def inv(self):
        t = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()).inv()
        return Fp12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int) -> "Fp12":
        result, base = Fp12.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result


def _fp12_scalar(value: int) -> Fp12:
    return Fp12(
        Fp6(Fp2(value, 0), Fp2(0, 0), Fp2(0, 0)), Fp6.zero()
    )


def _embed_g2(x: Fp2, y: Fp2):
    """psi: twist point -> E(Fp12) on y^2 = x^3 + 3 (see header)."""
    zero2 = Fp2(0, 0)
    xw2 = Fp12(Fp6(zero2, x, zero2), Fp6.zero())           # x * w^2 = x * v
    yw3 = Fp12(Fp6.zero(), Fp6(zero2, y, zero2))           # y * w^3 = y * v w
    return (xw2, yw3)


def _embed_g1(p: Point):
    return (_fp12_scalar(p[0]), _fp12_scalar(p[1]))


# Frobenius on the twist: pi(x, y) = (conj(x) gx, conj(y) gy)
_FROB_GX = _XI.pow((BN128_P - 1) // 3)
_FROB_GY = _XI.pow((BN128_P - 1) // 2)


def _g2_frobenius(x: Fp2, y: Fp2):
    return (x.conj() * _FROB_GX, y.conj() * _FROB_GY)


def _g2_add(p, q):
    """Affine addition on the twisted curve over Fp2 (None = infinity)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        slope = (x1 * x1 * 3) * (y1 * 2).inv()
    else:
        slope = (y2 - y1) * (x2 - x1).inv()
    x3 = slope * slope - x1 - x2
    y3 = slope * (x1 - x3) - y1
    return (x3, y3)


def _g2_mul(p, k: int):
    result = None
    addend = p
    while k:
        if k & 1:
            result = _g2_add(result, addend)
        addend = _g2_add(addend, addend)
        k >>= 1
    return result


def _g2_on_curve(x: Fp2, y: Fp2) -> bool:
    return y * y - x * x * x == _B2


def _line_eval(t, q, p):
    """Chord/tangent line through embedded points t, q evaluated at
    embedded p; returns (value, t+q).  All coordinates in Fp12."""
    x1, y1 = t
    x2, y2 = q
    xp, yp = p
    if x1 == x2 and y1 == y2:
        slope = (x1 * x1 * _fp12_scalar(3)) * (y1 + y1).inv()
    elif x1 == x2:
        return (xp - x1), None  # vertical line; sum is infinity
    else:
        slope = (y2 - y1) * (x2 - x1).inv()
    value = slope * (xp - x1) - (yp - y1)
    x3 = slope * slope - x1 - x2
    y3 = slope * (x1 - x3) - y1
    return value, (x3, y3)


def bn128_miller_loop(g2_point, g1_point: Point) -> Fp12:
    """Optimal-ate Miller loop (no final exponentiation); g2_point is an
    affine twist point (Fp2 pair) or None, g1_point an affine G1 pair."""
    if g2_point is None or g1_point is None:
        return Fp12.one()
    p = _embed_g1(g1_point)
    q = _embed_g2(*g2_point)
    t = q
    f = Fp12.one()
    for bit_index in range(_ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        value, t = _line_eval(t, t, p)
        f = f * f * value
        if (_ATE_LOOP_COUNT >> bit_index) & 1:
            value, t = _line_eval(t, q, p)
            f = f * value
    q1 = _g2_frobenius(*g2_point)
    q2 = _g2_frobenius(*q1)
    value, t = _line_eval(t, _embed_g2(*q1), p)
    f = f * value
    value, t = _line_eval(t, _embed_g2(q2[0], -q2[1]), p)
    f = f * value
    return f


_FINAL_EXP = (BN128_P ** 12 - 1) // BN128_N


def bn128_final_exponentiate(f: Fp12) -> Fp12:
    return f.pow(_FINAL_EXP)


def bn128_pairing_check(pairs) -> bool:
    """Product of pairings == 1?  pairs = [(g1_point, g2_point), ...]
    with None for the point at infinity on either side."""
    acc = Fp12.one()
    for g1_point, g2_point in pairs:
        acc = acc * bn128_miller_loop(g2_point, g1_point)
    return bn128_final_exponentiate(acc) == Fp12.one()
