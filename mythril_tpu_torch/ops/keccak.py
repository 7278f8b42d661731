"""Batched Keccak-256, in PyTorch (own copy of ``mythril_tpu/ops/keccak.py``).

The symbolic lockstep tier (``laser/ethereum/symbolic_lockstep.py``)
hashes the concrete SHA3 windows of a segment group here: one digest a
lane, every row of a call the same byte width, the result word
re-entering the stack plane.  The host reference
(``support/crypto.keccak256``) hashes one buffer at a time.

:func:`keccak256_batch` takes a uint8 ``[B, L]`` tensor and gives the
uint8 ``[B, 32]`` digests.  On the card it is one launch of the
hand-written sm_90a kernel ``csrc/keccak.cu`` (one thread a row, the
state's 25 lanes in registers); for a tensor on the CPU it is the plain
version, :func:`keccak256_batch_plain`.  The plain version carries each
64-bit lane as (hi, lo) halves, as the JAX package does, held in
``int64`` in [0, 2^32) and masked after every shift (``>>`` on int64
is arithmetic, so a half never holds a bit above 31); the 25 lanes are
a ``[25, B]`` tensor a half, so a round is a few dozen operations.

The kernel builds with ``nvcc`` at first use into
``mythril_tpu_torch/_build/``.  A failure to build or launch it raises
:class:`KeccakKernelError`, which the lockstep tier lets through its
telemetry guards.
"""

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import torch

from mythril_tpu_torch.ops import u256
from mythril_tpu_torch.ops.dense_sweep import BUILD_DIR, build_cuda_library

__all__ = [
    "RATE_BYTES", "keccak_f_batch", "keccak256_batch",
    "keccak256_batch_plain", "digest_to_word", "mapping_slot_batch",
]

#: sponge rate of keccak-256: 136 bytes = 17 64-bit lanes per block
RATE_BYTES = 136
_RATE_LANES = RATE_BYTES // 8
_MASK32 = 0xFFFFFFFF

#: round constants (keccak-f[1600] has 24 rounds; the values of
#: support/crypto.py)
_RC64 = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

#: rotation offsets indexed [x][y] (the table of support/crypto.py)
_ROT = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "ops", "csrc", "keccak.cu")
LIBRARY = os.path.join(BUILD_DIR, "libkeccak.so")

#: kernel launches since the last reset (the wrapper adds one per launch
#: and nowhere else)
launch_count = 0
#: (seconds, compiler output) of this process's build, when it built
build_info: Optional[tuple] = None
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class KeccakKernelError(RuntimeError):
    """The keccak kernel could not be built or launched, or the card
    failed around its launch."""


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


_TABLES = {}


def _tables(device):
    """Per flat lane i = x + 5 y: the rotation's whole-half swap and its
    shift below 32 ([25, 1] each); rho-pi's source lane of each
    destination; chi's lanes x + 1 and x + 2 of the row; and the round
    constants' (hi, lo) halves."""
    tables = _TABLES.get(device)
    if tables is None:
        rot = [_ROT[i % 5][i // 5] for i in range(25)]
        source = [0] * 25
        for i in range(25):
            x, y = i % 5, i // 5
            source[y + 5 * ((2 * x + 3 * y) % 5)] = i
        lanes = [(i - i % 5 + (i + 1) % 5, i - i % 5 + (i + 2) % 5)
                 for i in range(25)]

        def tensor(values, dtype=torch.int64):
            return torch.tensor(values, dtype=dtype, device=device)

        tables = _TABLES[device] = (
            tensor([[r >= 32] for r in rot], torch.bool),
            tensor([[r % 32] for r in rot]), tensor(source),
            tensor([a for a, _ in lanes]), tensor([b for _, b in lanes]),
            tensor([[rc >> 32, rc & _MASK32] for rc in _RC64]),
        )
    return tables


def _rotl(hi, lo, swap, shift):
    """Rotate (hi, lo) halves left by ``32 * swap + shift`` (``shift`` in
    [0, 32), broadcast over the halves)."""
    hi, lo = torch.where(swap, lo, hi), torch.where(swap, hi, lo)
    new_hi = ((hi << shift) & _MASK32) | (lo >> (32 - shift))
    new_lo = ((lo << shift) & _MASK32) | (hi >> (32 - shift))
    return new_hi, new_lo


def _keccak_f(hi, lo):
    """keccak-f[1600] over int64 ``[25, B]`` halves (lane x + 5 y)."""
    swap, shift, source, chi1, chi2, rc = _tables(hi.device)
    no_swap = torch.zeros((1, 1), dtype=torch.bool, device=hi.device)
    one = torch.ones((1, 1), dtype=torch.int64, device=hi.device)
    for r in range(24):
        # theta
        c_hi = hi.view(5, 5, -1)
        c_lo = lo.view(5, 5, -1)
        c_hi = c_hi[0] ^ c_hi[1] ^ c_hi[2] ^ c_hi[3] ^ c_hi[4]
        c_lo = c_lo[0] ^ c_lo[1] ^ c_lo[2] ^ c_lo[3] ^ c_lo[4]
        r_hi, r_lo = _rotl(c_hi.roll(-1, 0), c_lo.roll(-1, 0), no_swap, one)
        d_hi = c_hi.roll(1, 0) ^ r_hi
        d_lo = c_lo.roll(1, 0) ^ r_lo
        hi = (hi.view(5, 5, -1) ^ d_hi).view(25, -1)
        lo = (lo.view(5, 5, -1) ^ d_lo).view(25, -1)
        # rho + pi
        b_hi, b_lo = _rotl(hi, lo, swap, shift)
        b_hi, b_lo = b_hi[source], b_lo[source]
        # chi
        hi = b_hi ^ ((b_hi[chi1] ^ _MASK32) & b_hi[chi2])
        lo = b_lo ^ ((b_lo[chi1] ^ _MASK32) & b_lo[chi2])
        # iota
        hi[0] ^= rc[r, 0]
        lo[0] ^= rc[r, 1]
    return hi, lo


def keccak_f_batch(hi: List, lo: List) -> Tuple[List, List]:
    """One keccak-f[1600] permutation over a batch: ``hi``/``lo`` are
    length-25 lists of int64 ``[B]`` halves in [0, 2^32) (flat lane index
    ``i = x + 5*y``).  Returns new lists; the inputs are not changed."""
    out_hi, out_lo = _keccak_f(torch.stack(list(hi)), torch.stack(list(lo)))
    return list(out_hi.unbind(0)), list(out_lo.unbind(0))


def _check(data) -> Tuple[int, int]:
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"keccak: data {data.dtype} "
                         f"{tuple(data.shape)}, want uint8 [B, L]")
    return data.shape[0], data.shape[1]


def keccak256_batch_plain(data):
    """Plain version of :func:`keccak256_batch` (any device)."""
    batch, length = _check(data)
    dev = data.device
    # original Keccak pad10*1 with domain byte 0x01 (not SHA3's 0x06)
    pad_len = RATE_BYTES - length % RATE_BYTES
    tail = torch.zeros(pad_len, dtype=torch.int64, device=dev)
    tail[0] |= 0x01
    tail[-1] |= 0x80
    padded = torch.cat([data.to(torch.int64),
                        tail.expand(batch, pad_len)], dim=1)
    blocks = padded.view(batch, padded.shape[1] // RATE_BYTES, _RATE_LANES,
                         2, 4)
    weights = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=dev)
    words = (blocks << weights).sum(-1)  # [B, blocks, 17, (lo, hi)]
    hi = torch.zeros((25, batch), dtype=torch.int64, device=dev)
    lo = torch.zeros((25, batch), dtype=torch.int64, device=dev)
    for block in range(words.shape[1]):
        lo[:_RATE_LANES] ^= words[:, block, :, 0].T
        hi[:_RATE_LANES] ^= words[:, block, :, 1].T
        hi, lo = _keccak_f(hi, lo)
    # squeeze: 32 bytes = lanes 0..3, little-endian per lane
    halves = torch.stack([lo[:4], hi[:4]], dim=1).permute(2, 0, 1)
    halves = halves.reshape(batch, 8, 1)
    return ((halves >> weights) & 0xFF).reshape(batch, 32).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def bind(path: str) -> ctypes.CDLL:
    """Load a build of ``keccak.cu`` and declare its entry points."""
    lib = ctypes.CDLL(path)
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.keccak_launch.argtypes = [ptr, ptr, c_int, c_int, ptr]
    lib.keccak_launch.restype = c_int
    lib.keccak_rate_bytes.restype = c_int
    if lib.keccak_rate_bytes() != RATE_BYTES:
        raise KeccakKernelError("keccak: rate mismatch")
    return lib


def load_library() -> ctypes.CDLL:
    global _lib, build_info
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            try:
                info = build_cuda_library(SOURCE, LIBRARY)
                lib = bind(LIBRARY)
            except KeccakKernelError:
                raise
            except Exception as exc:
                raise KeccakKernelError(
                    f"keccak: the kernel did not build: {exc}") from exc
            if info is not None:
                build_info = info
            _lib = lib
    return _lib


def keccak256_batch(data):
    """keccak-256 of every row of a uint8 ``[B, L]`` tensor (rows of the
    same width), as uint8 ``[B, 32]`` digests on the tensor's device,
    byte for byte ``support.crypto.keccak256`` of each row.  One launch
    of ``csrc/keccak.cu`` for a tensor on the card (none when B is 0), the
    plain version for one on the CPU."""
    global launch_count
    batch, length = _check(data)
    if data.device.type == "cpu":
        return keccak256_batch_plain(data)
    out = torch.empty((batch, 32), dtype=torch.uint8, device=data.device)
    if batch == 0:
        return out
    data = data.contiguous()
    lib = load_library()
    err = lib.keccak_launch(data.data_ptr(), out.data_ptr(), batch, length,
                            torch.cuda.current_stream(data.device).cuda_stream)
    if err:
        raise KeccakKernelError(
            f"keccak kernel launch failed: cudaError {err}")
    launch_count += 1
    return out


def digest_to_word(digest):
    """uint8 ``[B, 32]`` big-endian digests -> int64 ``[B, 8]`` limb words
    (the ``ops/u256.py`` layout the stack plane carries), i.e.
    ``u256.from_int(int.from_bytes(row, "big"))`` a row."""
    return u256.bytes_to_limbs(digest)


def mapping_slot_batch(keys, slots):
    """The dominant SHA3 shape: ``keccak256(key ++ slot)`` a lane.

    ``keys``/``slots``: int64 ``[B, 8]`` limb words.  Returns int64
    ``[B, 8]`` limb words of the 64-byte-concat hash, the Solidity
    mapping-slot address for ``mapping(... => ...)`` at ``slot``."""
    data = torch.cat([u256.limbs_to_bytes(keys), u256.limbs_to_bytes(slots)],
                     dim=1)
    return digest_to_word(keccak256_batch(data))
