"""Small cross-cutting utilities (reference: mythril/support/support_utils.py)."""

from typing import Dict

from mythril_tpu_torch.support.crypto import keccak256


class Singleton(type):
    """Metaclass-based singleton."""

    _instances: Dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super(Singleton, cls).__call__(*args, **kwargs)
        return cls._instances[cls]


def get_code_hash(code) -> str:
    """keccak256 of (hex or raw) bytecode, 0x-prefixed."""
    if isinstance(code, str):
        code = bytes.fromhex(code.removeprefix("0x"))
    return "0x" + keccak256(bytes(code)).hex()


def sha3(data) -> bytes:
    if isinstance(data, str):
        data = data.encode()
    return keccak256(bytes(data))


def zpad(data: bytes, length: int) -> bytes:
    return data.rjust(length, b"\x00")
