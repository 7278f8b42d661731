"""Batched Keccak-256 of the port against the JAX package, on the CPU.

- ``ops/keccak.py:keccak256_batch_plain`` (what ``keccak256_batch`` runs
  for a tensor on the CPU) and ``ops/csrc/keccak.cu`` built as host C++
  with g++ (``keccak_host``: the kernel's grid, its staging and row
  function) against ``mythril_tpu.ops.keccak.keccak256_batch(xp=np)``
  and the port's native ``keccak256`` (``native/csrc``), at widths 0 to
  300 across the block edges (135, 136, 137, 271, 272, 273), rows from a
  numpy seed, and at B = 0;
- the host build's tile staging (``keccak_host`` runs the grid block by
  block, the threads of each staging step and of the row function in
  turn over a local copy of shared memory): every width at 1, 2, a tile
  less one, a tile, a tile and one and 300 rows, rows viewed from a flat
  buffer at base offsets 0, 1, 3, 4, 8 and 15 bytes, batches between
  two unreadable pages, one case per staging path, the source built with
  ``-Wall -Wextra -Werror``, and the edits of the design variants
  ``chip_tools/keccak_times.py`` times on the card;
- ``keccak_f_batch``, ``digest_to_word`` and ``mapping_slot_batch``
  against the JAX package's;
- the wrapper: no plain version for a tensor off the CPU, no launch at
  B = 0, and a refused launch or a failed build raise
  ``KeccakKernelError`` without counting a launch.

Every comparison is exact (bit-equal).
"""

import ctypes
import functools
import importlib.util
import os
import re
import subprocess
import sys
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
#: rows a block of the kernel (its tile)
TILE = int(re.search(r"constexpr int kRows = (\d+);",
                     open(PK.SOURCE).read()).group(1))
#: row counts around the tile's edges
TILE_ROWS = [1, 2, TILE - 1, TILE, TILE + 1, 300]
#: base offsets of a row view into a flat buffer
OFFSETS = [0, 1, 3, 4, 8, 15]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's many small integer ops on one intra-op thread:
    beside other busy processes, torch's pool of threads makes them a
    hundred times slower (the digests are the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(width, rows=ROWS, seed=0):
    rng = np.random.default_rng(1000 * seed + width)
    return rng.integers(0, 256, size=(rows, width), dtype=np.uint8)


def _native(rows):
    return np.stack([np.frombuffer(native_keccak(r.tobytes()), np.uint8)
                     for r in rows]).reshape(len(rows), 32)


def _build_host(source, path, flags=("-O2",)):
    """``source`` built as host C++ with g++ into ``path``, bound."""
    subprocess.run(["g++", *flags, "-std=c++17", "-x", "c++", "-shared",
                    "-fPIC", "-o", str(path), str(source)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(path))
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    lib.keccak_host.argtypes = [ptr, ptr, c_int, c_int]
    lib.keccak_host.restype = c_int
    assert lib.keccak_rate_bytes() == PK.RATE_BYTES
    return lib


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``keccak.cu`` built as host C++."""
    path = tmp_path_factory.mktemp("keccak") / "libkeccak_host.so"
    return _build_host(PK.SOURCE, path)


def _host(lib, rows):
    data = np.ascontiguousarray(rows)
    out = np.zeros((len(data), 32), np.uint8)
    assert lib.keccak_host(data.ctypes.data, out.ctypes.data, len(data),
                           data.shape[1]) == 0
    return out


def _host_view(lib, rows, offset):
    """The host build over ``rows`` copied into a flat buffer at byte
    ``offset`` (and followed by bytes the kernel must not read into a
    digest), the batch's base pointer ``offset`` bytes past the
    buffer's."""
    batch, width = rows.shape
    flat = np.full(batch * width + offset + 16, 0xA5, np.uint8)
    view = flat[offset:offset + batch * width].reshape(batch, width)
    view[:] = rows
    out = np.zeros((batch, 32), np.uint8)
    assert lib.keccak_host(flat.ctypes.data + offset, out.ctypes.data, batch,
                           width) == 0
    return out


@functools.lru_cache(maxsize=None)
def _want(width, rows, seed):
    """The JAX package's digests of ``_rows(width, rows, seed)``, held
    against the native ``keccak256``."""
    data = _rows(width, rows=rows, seed=seed)
    want = np.asarray(JK.keccak256_batch(data, xp=np))
    np.testing.assert_array_equal(want, _native(data))
    return want


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
    # a row that starts off an 8-byte boundary takes the raw words
    odd = np.zeros((ROWS, width + 1), np.uint8)[:, 1:]
    odd[:] = rows
    np.testing.assert_array_equal(_host(host_kernel, odd), want)


@pytest.mark.parametrize("rows", TILE_ROWS)
@pytest.mark.parametrize("width", WIDTHS)
def test_host_build_tiles(host_kernel, width, rows):
    """Batches of one row to past two tiles, the last tile partial: the
    host build, the plain version, JAX and the native keccak256 agree."""
    data = _rows(width, rows=rows, seed=4)
    want = _want(width, rows, 4)
    np.testing.assert_array_equal(_host(host_kernel, data), want)
    plain = PK.keccak256_batch_plain(torch.from_numpy(data))
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("width", WIDTHS)
def test_host_build_any_base(host_kernel, width, offset):
    """A row view whose base is ``offset`` bytes into a flat buffer: the
    staging's copies take only aligned words, and bytes past the batch
    never reach a digest."""
    rows = TILE + 3
    data = _rows(width, rows=rows, seed=5)
    np.testing.assert_array_equal(_host_view(host_kernel, data, offset),
                                  _want(width, rows, 5))


#: (offset, width, rows) of each staging path: aligned rows copied
#: straight into the tile; rows off 8 bytes by their base, and by their
#: width, through raw words; a batch whose first and last words hold
#: bytes outside it (read byte by byte); rows of two and three sponge
#: blocks; the padding block alone
STAGING_PATHS = {
    "aligned copies": (0, 64, TILE + 1),
    "raw words, base off 8 bytes": (5, 64, TILE + 1),
    "raw words, width off 8 bytes": (0, 137, TILE + 1),
    "the batch's edges byte by byte": (1, 5, 3),
    "two sponge blocks": (0, 200, TILE + 1),
    "three sponge blocks, unaligned": (3, 300, 2 * TILE + 1),
    "padding alone": (0, 0, TILE + 1),
}


@pytest.mark.parametrize("path", sorted(STAGING_PATHS))
def test_host_build_staging_paths(host_kernel, path):
    offset, width, rows = STAGING_PATHS[path]
    data = _rows(width, rows=rows, seed=6)
    want = np.asarray(JK.keccak256_batch(data, xp=np))
    np.testing.assert_array_equal(want, _native(data))
    np.testing.assert_array_equal(_host_view(host_kernel, data, offset),
                                  want)


#: a child process that runs the host build over a batch between two
#: pages it may not touch, the batch's first byte ``lead`` bytes past the
#: first and its last byte ``tail`` bytes before the second, and prints
#: the digests
GUARDED = """
import ctypes, mmap, sys
import numpy as np
path, rows, width, lead, tail = sys.argv[1], *map(int, sys.argv[2:])
lib = ctypes.CDLL(path)
lib.keccak_host.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
libc = ctypes.CDLL(None)
libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
page, inner = mmap.PAGESIZE, 8
data = np.frombuffer(bytes.fromhex(sys.stdin.read()), np.uint8)
for first in (True, False):
    buf = mmap.mmap(-1, (inner + 2) * page)
    base = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    start = (base + page + lead if first
             else base + (inner + 1) * page - tail - data.size)
    ctypes.memmove(start, data.ctypes.data, data.size)
    assert libc.mprotect(base, page, 0) == 0
    assert libc.mprotect(base + (inner + 1) * page, page, 0) == 0
    out = np.zeros((rows, 32), np.uint8)
    lib.keccak_host(start, out.ctypes.data, rows, width)
    print(out.tobytes().hex())
"""

#: (rows, width, lead, tail) of the guarded batches
GUARDED_CASES = [(TILE + 1, 64, 0, 0), (TILE + 1, 64, 3, 5),
                 (TILE + 1, 137, 1, 0), (9, 300, 7, 3), (3, 5, 1, 3)]


@pytest.mark.parametrize("case", GUARDED_CASES)
def test_host_build_reads_only_the_batch(host_kernel, case):
    """The staging reads no word outside the batch: with the pages before
    and after it unreadable the host build still runs (in a child
    process, where a read past either end is a crash) and gives JAX's
    digests."""
    rows, width, lead, tail = case
    data = _rows(width, rows=rows, seed=8)
    done = subprocess.run(
        [sys.executable, "-c", GUARDED, host_kernel._name, str(rows),
         str(width), str(lead), str(tail)], input=data.tobytes().hex(),
        capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    want = np.asarray(JK.keccak256_batch(data, xp=np))
    for line in done.stdout.split():
        got = np.frombuffer(bytes.fromhex(line), np.uint8).reshape(rows, 32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", ["-O0", "-O2"])
def test_source_builds_with_warnings_as_errors(tmp_path, level):
    """The kernel's source is clean host C++ (every warning an error), and
    its rate is still 136 bytes."""
    lib = _build_host(PK.SOURCE, tmp_path / "libkeccak_strict.so",
                      (level, "-Wall", "-Wextra", "-Werror"))
    assert lib.keccak_rate_bytes() == 136
    data = _rows(64, rows=3, seed=7)
    np.testing.assert_array_equal(_host(lib, data), _want(64, 3, 7))


# ------------------------- the design variants of chip_tools/keccak_times.py


def test_chip_tool_variants_apply_to_the_source():
    """Each variant ``chip_tools/keccak_times.py`` times on the card (the
    source under named edits, held there bit for bit) applies to the
    source as it is: every edit's text is found once and its replacement
    lands."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scripts = {}
    for name in ("lockstep_times", "keccak_times"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, "chip_tools", f"{name}.py"))
        scripts[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(scripts[name])
    source = open(PK.SOURCE).read()
    for edits in scripts["keccak_times"].VARIANTS.values():
        variant = scripts["lockstep_times"].apply_edits(source, edits)
        assert variant != source
        for _old, new in edits:
            assert new in variant


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
