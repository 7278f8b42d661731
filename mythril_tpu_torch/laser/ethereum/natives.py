"""Precompiled contracts (reference: laser/ethereum/natives.py).

Pure functions over concrete byte lists; symbolic input raises
NativeContractException and the caller writes symbolic returndata
instead.  All crypto comes from our self-contained support.crypto.
"""

import logging
from typing import List, Union

from mythril_tpu_torch.laser.ethereum.state.calldata import BaseCalldata, ConcreteCalldata
from mythril_tpu_torch.laser.ethereum.util import extract32, extract_copy
from mythril_tpu_torch.smt import BitVec
from mythril_tpu_torch.support.crypto import (
    BN128_N,
    BN128_P,
    blake2b_compress,
    bn128_add as _bn128_add,
    bn128_mul as _bn128_mul,
    ecrecover_address,
    ripemd160 as _ripemd160,
    sha256 as _sha256,
)

log = logging.getLogger(__name__)


class NativeContractException(Exception):
    """Symbolic input (or bad input) reached a precompile."""


def _to_bytes(data: Union[List[int], BaseCalldata]) -> bytearray:
    if isinstance(data, BaseCalldata):
        data = data[:]
    out = bytearray()
    for item in data:
        if isinstance(item, BitVec):
            if item.value is None:
                raise NativeContractException
            out.append(item.value)
        else:
            out.append(item)
    return out


def ecrecover(data: List[int]) -> List[int]:
    payload = _to_bytes(data)
    payload += b"\x00" * max(0, 128 - len(payload))
    msg_hash = bytes(payload[:32])
    v = extract32(payload, 32)
    r = extract32(payload, 64)
    s = extract32(payload, 96)
    if not (27 <= v <= 28):
        return []
    try:
        address = ecrecover_address(msg_hash, v, r, s)
    except Exception:
        return []
    if address is None:
        return []
    return list(b"\x00" * 12 + address)


def sha256(data: List[int]) -> List[int]:
    return list(_sha256(bytes(_to_bytes(data))))


def ripemd160(data: List[int]) -> List[int]:
    return list(b"\x00" * 12 + _ripemd160(bytes(_to_bytes(data))))


def identity(data: List[int]) -> List[int]:
    # Copy may receive BitVec elements; identity passes them through.
    if isinstance(data, BaseCalldata):
        return data[:]
    return list(data)


def mod_exp(data: List[int]) -> List[int]:
    payload = _to_bytes(data)
    base_length = extract32(payload, 0)
    exponent_length = extract32(payload, 32)
    modulus_length = extract32(payload, 64)
    if base_length == 0:
        return [0] * modulus_length
    if modulus_length == 0:
        return []
    first_exp_bytes = extract32(payload, 96 + base_length) >> (
        8 * max(32 - exponent_length, 0)
    )
    if base_length > 1024 or exponent_length > 1024 or modulus_length > 1024:
        raise NativeContractException  # unreasonable sizes
    base = int.from_bytes(
        bytes(payload[96 : 96 + base_length]).ljust(base_length, b"\x00"), "big"
    )
    exponent = int.from_bytes(
        bytes(
            payload[96 + base_length : 96 + base_length + exponent_length]
        ).ljust(exponent_length, b"\x00"),
        "big",
    )
    modulus = int.from_bytes(
        bytes(
            payload[
                96
                + base_length
                + exponent_length : 96
                + base_length
                + exponent_length
                + modulus_length
            ]
        ).ljust(modulus_length, b"\x00"),
        "big",
    )
    if modulus == 0:
        return [0] * modulus_length
    return list(pow(base, exponent, modulus).to_bytes(modulus_length, "big"))


def ec_add(data: List[int]) -> List[int]:
    payload = _to_bytes(data)
    payload += b"\x00" * max(0, 128 - len(payload))
    x1, y1 = extract32(payload, 0), extract32(payload, 32)
    x2, y2 = extract32(payload, 64), extract32(payload, 96)
    try:
        p1 = None if (x1 == 0 and y1 == 0) else (x1 % BN128_P, y1 % BN128_P)
        p2 = None if (x2 == 0 and y2 == 0) else (x2 % BN128_P, y2 % BN128_P)
        result = _bn128_add(p1, p2)
    except ValueError:
        return []
    if result is None:
        return [0] * 64
    return list(result[0].to_bytes(32, "big") + result[1].to_bytes(32, "big"))


def ec_mul(data: List[int]) -> List[int]:
    payload = _to_bytes(data)
    payload += b"\x00" * max(0, 96 - len(payload))
    x, y = extract32(payload, 0), extract32(payload, 32)
    scalar = extract32(payload, 64)
    try:
        point = None if (x == 0 and y == 0) else (x % BN128_P, y % BN128_P)
        result = _bn128_mul(point, scalar)
    except ValueError:
        return []
    if result is None:
        return [0] * 64
    return list(result[0].to_bytes(32, "big") + result[1].to_bytes(32, "big"))


def ec_pair(data: List[int]) -> List[int]:
    """EIP-197 pairing check (reference natives.py:164-196 behavioral
    contract: 192-byte groups, G2 words imaginary-part first, [] on any
    invalid point/subgroup failure, output 0/1 in 32 bytes)."""
    from mythril_tpu_torch.support.crypto import (
        BN128_N,
        BN128_P,
        Fp2,
        _g2_mul,
        _g2_on_curve,
        bn128_pairing_check,
    )

    if len(data) % 192:
        return []
    payload = _to_bytes(data)
    pairs = []
    for i in range(0, len(payload), 192):
        words = [
            int.from_bytes(payload[i + 32 * j : i + 32 * (j + 1)], "big")
            for j in range(6)
        ]
        x1, y1, x2_i, x2_r, y2_i, y2_r = words
        if any(v >= BN128_P for v in words):
            return []
        if (x1, y1) == (0, 0):
            g1_point = None
        else:
            if (y1 * y1 - x1 * x1 * x1 - 3) % BN128_P:
                return []
            g1_point = (x1, y1)
        g2_x = Fp2(x2_r, x2_i)
        g2_y = Fp2(y2_r, y2_i)
        if g2_x.is_zero() and g2_y.is_zero():
            g2_point = None
        else:
            if not _g2_on_curve(g2_x, g2_y):
                return []
            g2_point = (g2_x, g2_y)
            if _g2_mul(g2_point, BN128_N) is not None:
                return []
        pairs.append((g1_point, g2_point))
    result = bn128_pairing_check(pairs)
    return [0] * 31 + [1 if result else 0]


def blake2b_fcompress(data: List[int]) -> List[int]:
    payload = _to_bytes(data)
    if len(payload) != 213 or payload[212] not in (0, 1):
        return []
    rounds = int.from_bytes(payload[0:4], "big")
    h = [
        int.from_bytes(payload[4 + 8 * i : 12 + 8 * i], "little") for i in range(8)
    ]
    m = [
        int.from_bytes(payload[68 + 8 * i : 76 + 8 * i], "little")
        for i in range(16)
    ]
    t = (
        int.from_bytes(payload[196:204], "little"),
        int.from_bytes(payload[204:212], "little"),
    )
    final = payload[212] == 1
    out = blake2b_compress(rounds, h, m, t, final)
    result = bytearray()
    for word in out:
        result += word.to_bytes(8, "little")
    return list(result)


PRECOMPILE_FUNCTIONS = (
    ecrecover,
    sha256,
    ripemd160,
    identity,
    mod_exp,
    ec_add,
    ec_mul,
    ec_pair,
    blake2b_fcompress,
)
PRECOMPILE_COUNT = len(PRECOMPILE_FUNCTIONS)


def native_contracts(address: int, data: BaseCalldata) -> List[int]:
    """Dispatch to precompile #address (1-based)."""
    if not isinstance(data, ConcreteCalldata):
        raise NativeContractException
    concrete_data = data.concrete(None)
    try:
        return PRECOMPILE_FUNCTIONS[address - 1](concrete_data)
    except TypeError:
        raise NativeContractException
