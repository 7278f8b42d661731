"""Batched Keccak-256 of the port against the JAX package, on the CPU.

- ``ops/keccak.py:keccak256_batch_plain`` (what ``keccak256_batch`` runs
  for a tensor on the CPU) and ``ops/csrc/keccak.cu`` built as host C++
  with g++ (``keccak_host``: the kernel's own row function, one row an
  iteration) against ``mythril_tpu.ops.keccak.keccak256_batch(xp=np)``
  and the port's native ``keccak256`` (``native/csrc``), at widths 0 to
  300 across the block edges (135, 136, 137, 271, 272, 273), rows from a
  numpy seed, and at B = 0;
- ``keccak_f_batch``, ``digest_to_word`` and ``mapping_slot_batch``
  against the JAX package's;
- the wrapper: no plain version for a tensor off the CPU, no launch at
  B = 0, and a refused launch or a failed build raise
  ``KeccakKernelError`` without counting a launch.

Every comparison is exact (bit-equal).
"""

import ctypes
import subprocess
import types

import numpy as np
import pytest
import torch

from mythril_tpu.ops import keccak as JK
from mythril_tpu.ops import u256 as JU
from mythril_tpu_torch.native import keccak256 as native_keccak
from mythril_tpu_torch.ops import keccak as PK
from mythril_tpu_torch.ops import u256 as PU

WIDTHS = [0, 1, 31, 32, 33, 64, 135, 136, 137, 271, 272, 273, 300]
ROWS = 9


def _rows(width, rows=ROWS, seed=0):
    rng = np.random.default_rng(1000 * seed + width)
    return rng.integers(0, 256, size=(rows, width), dtype=np.uint8)


def _native(rows):
    return np.stack([np.frombuffer(native_keccak(r.tobytes()), np.uint8)
                     for r in rows]).reshape(len(rows), 32)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``keccak.cu`` built as host C++."""
    path = tmp_path_factory.mktemp("keccak") / "libkeccak_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-x", "c++", "-shared",
                    "-fPIC", "-o", str(path), PK.SOURCE],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(path))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.keccak_host.argtypes = [ptr, ptr, c_int, c_int]
    lib.keccak_host.restype = c_int
    assert lib.keccak_rate_bytes() == PK.RATE_BYTES
    return lib


def _host(lib, rows):
    data = np.ascontiguousarray(rows)
    out = np.zeros((len(data), 32), np.uint8)
    assert lib.keccak_host(data.ctypes.data, out.ctypes.data, len(data),
                           data.shape[1]) == 0
    return out


@pytest.mark.parametrize("width", WIDTHS)
def test_plain_matches_jax_and_native(width):
    rows = _rows(width)
    got = PK.keccak256_batch(torch.from_numpy(rows))
    assert got.dtype == torch.uint8 and got.shape == (ROWS, 32)
    want = np.asarray(JK.keccak256_batch(rows, xp=np))
    np.testing.assert_array_equal(want, _native(rows))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_host_build_matches_jax_and_native(host_kernel, width):
    rows = _rows(width, seed=1)
    want = np.asarray(JK.keccak256_batch(rows, xp=np))
    np.testing.assert_array_equal(_host(host_kernel, rows), want)
    np.testing.assert_array_equal(want, _native(rows))
    # a row that starts off an 8-byte boundary takes the byte loads
    odd = np.zeros((ROWS, width + 1), np.uint8)[:, 1:]
    odd[:] = rows
    np.testing.assert_array_equal(_host(host_kernel, odd), want)


def test_empty_batch(host_kernel):
    rows = np.zeros((0, 64), np.uint8)
    got = PK.keccak256_batch(torch.from_numpy(rows))
    assert got.shape == (0, 32) and got.dtype == torch.uint8
    assert _host(host_kernel, rows).shape == (0, 32)


def test_keccak_f_matches_jax():
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 1 << 32, size=(25, 7), dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, size=(25, 7), dtype=np.uint64)
    want_hi, want_lo = JK.keccak_f_batch(list(hi.astype(np.uint32)),
                                         list(lo.astype(np.uint32)), xp=np)
    got_hi, got_lo = PK.keccak_f_batch(
        list(torch.from_numpy(hi.astype(np.int64))),
        list(torch.from_numpy(lo.astype(np.int64))))
    np.testing.assert_array_equal(torch.stack(got_hi).numpy(),
                                  np.stack(want_hi).astype(np.int64))
    np.testing.assert_array_equal(torch.stack(got_lo).numpy(),
                                  np.stack(want_lo).astype(np.int64))


def test_digest_to_word_matches_jax():
    digests = _rows(32, rows=16, seed=2)
    want = np.asarray(JK.digest_to_word(digests, xp=np))
    got = PK.digest_to_word(torch.from_numpy(digests))
    assert got.dtype == PU.DTYPE
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_mapping_slot_matches_jax():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 32, size=(12, 8), dtype=np.uint64)
    keys[0] = 0
    keys[1] = 0xFFFFFFFF
    slots = np.zeros((12, 8), np.uint64)
    slots[:, 0] = np.arange(12)
    want = np.asarray(JK.mapping_slot_batch(keys.astype(np.uint32),
                                            slots.astype(np.uint32), xp=np))
    got = PK.mapping_slot_batch(torch.from_numpy(keys.astype(np.int64)),
                                torch.from_numpy(slots.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for lane in range(12):
        data = (JU.to_int(keys[lane].astype(np.uint32)).to_bytes(32, "big")
                + int(slots[lane, 0]).to_bytes(32, "big"))
        assert PU.to_int(got[lane]) == int.from_bytes(native_keccak(data),
                                                      "big")


def _stand_in_card(monkeypatch, launch):
    """A card for the wrapper: a library whose launch is ``launch``, a
    stream, and the ``meta`` device for the data."""
    lib = types.SimpleNamespace(keccak_launch=launch)
    monkeypatch.setattr(PK, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))


def test_wrapper_launches_once_and_never_takes_the_plain_version(
        monkeypatch):
    calls = []
    _stand_in_card(monkeypatch, lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(PK, "keccak256_batch_plain", lambda data: (
        pytest.fail("plain version taken for a device tensor")))
    PK.reset_launch_count()
    out = PK.keccak256_batch(torch.zeros((5, 64), dtype=torch.uint8,
                                         device="meta"))
    assert out.shape == (5, 32) and out.device.type == "meta"
    assert len(calls) == 1 and calls[0][2:4] == (5, 64)
    assert PK.launch_count == 1
    # B = 0: no launch (a grid of zero blocks is an error)
    out = PK.keccak256_batch(torch.zeros((0, 64), dtype=torch.uint8,
                                         device="meta"))
    assert out.shape == (0, 32) and len(calls) == 1
    assert PK.launch_count == 1


def test_refused_launch_raises(monkeypatch):
    _stand_in_card(monkeypatch, lambda *args: 700)
    PK.reset_launch_count()
    with pytest.raises(PK.KeccakKernelError, match="cudaError 700"):
        PK.keccak256_batch(torch.zeros((3, 64), dtype=torch.uint8,
                                       device="meta"))
    assert PK.launch_count == 0


def test_failed_build_raises(monkeypatch):
    def no_toolkit(source, library):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(PK, "_lib", None)
    monkeypatch.setattr(PK, "build_cuda_library", no_toolkit)
    with pytest.raises(PK.KeccakKernelError, match="nvcc not found"):
        PK.load_library()


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="uint8"):
        PK.keccak256_batch(torch.zeros((2, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="uint8"):
        PK.keccak256_batch(torch.zeros(8, dtype=torch.uint8))
