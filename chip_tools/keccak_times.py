#!/usr/bin/env python3
"""Device times of the Keccak kernel (``ops/csrc/keccak.cu``) against
another tree's, and of its design variants, on two stopwatches.

Run on the card from the repository root::

    python3 chip_tools/keccak_times.py [--parent DIR] [--iters N]

Each tree is measured in a process of its own (the tree's package first
on the path; inputs, bounds and timing code are this tree's), in turns:
parent, this tree, this tree, parent.  A tree's process builds its
``keccak.cu`` as its wrapper loads it (the build's ``-Xptxas -v`` line
printed) and times its ``keccak_launch`` at the main path's shapes (1
and 2 rows of 64 B) and at the five widths of ``chip_smoke.py``'s
batches (32, 64, 136, 137, 256 B) at 65,536 and 1,048,576 rows, the
rows made on the card from a torch seed.  Every library's first launch
of a case is held bit for bit against ``keccak256_batch_plain`` before
it is timed.  Each case gets two stopwatches, CUDA events around each of
``--iters`` bare launches (``chip_tools/lockstep_times.py``'s
``event_ms``): on an idle stream (the time then holds the host's
enqueue, as the main path meets it) and behind a spin kernel (that
script's ``spin_launch``: the device's time alone), with an empty kernel
on the same grid timed both ways beside them.  Each reading is printed
with ``chip_smoke.keccak_bound`` and its share.

Before the timings this tree's wrapper is held bit for bit against the
plain version at every width of ``CHECK_WIDTHS`` (0 to 409 B), row count
of ``CHECK_ROWS`` (1 to 65,536) and base offset of ``CHECK_OFFSETS`` (0
to 15 bytes), a sample against the native ``keccak256``.

This tree's processes also build and time the kernel's design variants,
each the source under named edits (``VARIANTS``): the permutation alone
on a state seeded from the row index (no loads, only the digest stored:
held against ``keccak_f``'s plain version over the same seeds), a second
tile staged during the permutation (the double buffer), blocks of 64
rows, theta's XORs as ptxas compiles them from plain C++, the unaligned
rows' shift step by each thread on its own row, the staging loops
unrolled, and the round constants as immediates (the last six held
against the plain version).

Prints the card line first and last, one JSON line per reading; exits
non-zero without a card or when a launch differs.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (rows, width) of the timed launches: the main path's, then the batches
CASES = ((1, 64), (2, 64)) + tuple(
    (rows, width) for rows in (65536, 1 << 20)
    for width in (32, 64, 136, 137, 256))
#: the check's widths (every edge of a word and of a sponge block, up to
#: three blocks), row counts (around a 64- and a 128-row tile) and base
#: offsets of the row view
CHECK_WIDTHS = (0, 1, 7, 8, 9, 31, 32, 33, 64, 127, 128, 135, 136, 137, 143,
                144, 255, 256, 271, 272, 273, 300, 409)
CHECK_ROWS = (1, 2, 63, 64, 65, 127, 128, 129, 300, 65536)
CHECK_OFFSETS = (0, 1, 3, 4, 8, 15)
#: the variant whose digests are keccak-f of a seeded state, not hashes
PERMUTATION_ALONE = "permutation alone"


def round_constants():
    """Keccak-f[1600]'s 24 round constants as C++ literals, from the
    specification's LFSR (x^8 + x^6 + x^5 + x^4 + 1, state 1)."""
    literals, state = [], 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            if state & 1:
                rc |= 1 << ((1 << j) - 1)
            state = ((state << 1) ^ (0x71 if state & 0x80 else 0)) & 0xFF
        literals.append(f"0x{rc:016X}ull")
    return literals


#: the own-row shift variant's staging step
OWN_ROW_SHIFT = """\
// Staging's second step where the rows are not aligned: thread t moves
// its own tile row out of its raw words, each tile word funnel-shifted out
// of two of them, the bytes past the row cut and the padding added.  s is
// the same for every row, so each branch on it is the whole block's; a
// row past the batch is left as its raw words make it (its digest is not
// stored).
KC_FN void stage_shift(uint64_t* tile, const uint64_t* raw, const Batch& b,
                       int row0, int k, int t) {
  const int s = block_bytes(b, k);
  const bool last = k + 1 == b.blocks;
  const uint64_t* words = raw + t * kRawStride;
  uint64_t* row = tile + t * kRateLanes;
  const int shift = 8 * (int)(block_start(b, row0 + t, k) & 7);
  uint64_t lo = words[0];
#ifdef __CUDACC__
#pragma unroll
#endif
  for (int j = 0; j < kRateLanes; ++j) {
    const int d = s - 8 * j;  // the row's bytes from this word on
    uint64_t word = padding(s, j, last);
    if (d > 0) {
      // (hi << (63 - shift)) << 1: hi's bytes above lo's, none at shift 0
      const uint64_t hi = words[j + 1];
      const uint64_t v = lo >> shift | (hi << (63 - shift)) << 1;
      word |= d < 8 ? v & ((1ull << (8 * d)) - 1) : v;
      lo = hi;
    }
    row[j] = word;
  }
}

"""

#: the double-buffer variant's kernel: block k + 1 staged into the other
#: tile right after block k is absorbed, its copies in flight during the
#: permutation
DOUBLE_BUFFER = """\
  extern __shared__ uint64_t smem[];
  uint64_t* raw = smem + 2 * kc::kTileWords;
  const kc::Batch b = kc::make_batch(data, rows, len);
  const int row0 = blockIdx.x * kc::kRows;
  const int t = threadIdx.x;
  uint64_t a[25];
  kc::stage_copy(smem, raw, b, row0, 0, t);
  for (int k = 0;; ++k) {
    uint64_t* tile = smem + (k & 1) * kc::kTileWords;
    kc::copies_done();
    __syncthreads();
    if (!b.aligned) {
      kc::stage_shift(tile, raw, b, row0, k, t);
      __syncthreads();
    }
    if (k == 0)
      kc::absorb_first(a, tile + t * kc::kRateLanes);
    else
      kc::absorb(a, tile + t * kc::kRateLanes);
    const bool more = k + 1 < b.blocks;
    if (more)
      kc::stage_copy(smem + ((k + 1) & 1) * kc::kTileWords, raw, b, row0,
                     k + 1, t);
    kc::keccak_f(a);
    if (!more) break;
  }
"""

# Design variants of the kernel, each a list of (old, new) source edits,
# each old text found exactly once (lockstep_times.apply_edits).
VARIANTS = {
    # no message: a[i] = i << 32 | row, keccak-f once a sponge block, the
    # digest stored; the ceiling of the permutation as compiled
    PERMUTATION_ALONE: [
        ("kc::absorb_first(a, tile + t * kc::kRateLanes);",
         "for (int i = 0; i < 25; ++i)\n"
         "        a[i] = (uint64_t)i << 32 | (uint64_t)(row0 + t);"),
        ("kc::absorb(a, tile + t * kc::kRateLanes);", ";"),
        ("const Batch& b,\n                      int row0, int k, int t) {\n",
         "const Batch& b,\n                      int row0, int k, int t) {\n"
         "  if (t >= 0) return;\n"),
        ("const Batch& b,\n                       int row0, int k, int t) {\n",
         "const Batch& b,\n                       int row0, int k, int t) {\n"
         "  if (t >= 0) return;\n"),
    ],
    # two tiles: block k + 1 staged into the other before block k
    # permutes, its copies in flight during the permutation, one barrier a
    # block where the rows are aligned
    "double buffer": [
        ("  return kTileWords + (aligned", "  return 2 * kTileWords + (aligned"),
        (("  extern __shared__ uint64_t smem[];",
          "  if (row0 + t < rows) kc::store_digest"), DOUBLE_BUFFER),
        # two tiles and the raw words pass 48 KiB: the opt-in
        ("  const int blocks = (rows + kc::kRows - 1) / kc::kRows;\n",
         "  static const cudaError_t raised = cudaFuncSetAttribute(\n"
         "      keccak_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "      8 * kc::smem_words(false));\n"
         "  if (raised != cudaSuccess) return (int)raised;\n"
         "  const int blocks = (rows + kc::kRows - 1) / kc::kRows;\n"),
    ],
    # 64 rows a block: a 65,536-row grid of 1,024 blocks over 132 SMs
    "64-row blocks": [
        ("constexpr int kRows = 128;", "constexpr int kRows = 64;"),
    ],
    # theta as ptxas compiles it from plain C++: d = c[x - 1] ^ rot(c[x + 1])
    # once a column, then a ^= d (ten more LOP3 a round than xor3)
    "theta as compiled": [
        ("const uint64_t r = rotl<1>(c[(x + 1) % 5]);",
         "const uint64_t d = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);"),
        ("a[x + y] = xor3(a[x + y], c[(x + 4) % 5], r);", "a[x + y] ^= d;"),
    ],
    # the unaligned rows' shift step by each thread on its own row (raw
    # rows at an odd stride), no barrier before the absorb, not shared out
    # word by word as the copies are
    "own-row shift": [
        ("constexpr int kRawStride = 18;", "constexpr int kRawStride = 19;"),
        (("// Staging's second step where the rows are not aligned",
          "// the first block into a fresh state"), OWN_ROW_SHIFT),
        ("    if (!b.aligned) {\n"
         "      kc::stage_shift(tile, raw, b, row0, k, t);\n"
         "      __syncthreads();\n"
         "    }\n",
         "    if (!b.aligned) kc::stage_shift(tile, raw, b, row0, k, t);\n"),
        # the host build's emulation: each thread's shift and absorb in turn
        ("      if (!b.aligned)\n"
         "        for (int t = 0; t < kRows; ++t) stage_shift(tile, raw, b, "
         "row0, k, t);\n"
         "      for (int t = 0; t < kRows; ++t) {\n",
         "      for (int t = 0; t < kRows; ++t) {\n"
         "        if (!b.aligned) stage_shift(tile, raw, b, row0, k, t);\n"),
    ],
    # the staging's loops over tile and raw words unrolled (17 and 18
    # iterations a thread): more static code, the loop counters and some
    # index arithmetic folded
    "staging unrolled": [
        ("#pragma unroll 1\n#endif\n    for (int w = t; w < kTileWords; "
         "w += kRows) {",
         "#pragma unroll\n#endif\n    for (int w = t; w < kTileWords; "
         "w += kRows) {"),
        ("#pragma unroll 1\n#endif\n  for (int w = t; w < kRows * "
         "kRawStride; w += kRows) {",
         "#pragma unroll\n#endif\n  for (int w = t; w < kRows * "
         "kRawStride; w += kRows) {"),
        ("#pragma unroll 1\n#endif\n  for (int w = t; w < kTileWords; "
         "w += kRows) {",
         "#pragma unroll\n#endif\n  for (int w = t; w < kTileWords; "
         "w += kRows) {"),
    ],
    # iota's round constants as immediates of the unrolled rounds (a
    # constant table local to keccak_f), not loads from constant memory:
    # the XORs of zero halves fold away
    "round constants as immediates": [
        ("KC_FN void keccak_f(uint64_t* a) {\n",
         "KC_FN void keccak_f(uint64_t* a) {\n"
         "  constexpr uint64_t kRound[24] = {" + ", ".join(round_constants())
         + "};\n"),
        ("a[0] ^= kRC[round];", "a[0] ^= kRound[round];"),
    ],
}


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def timing():
    return load("lockstep_times",
                os.path.join(ROOT, "chip_tools", "lockstep_times.py"))


def emit(record):
    print(json.dumps(record), flush=True)


def variant_paths(name):
    """(source, library) of a variant, under this tree's build folder."""
    stem = os.path.join(ROOT, "mythril_tpu_torch", "_build", "variants",
                        "keccak_" + name.replace(" ", "_").replace("-", "_"))
    return stem + ".cu", stem + ".so"


def build_variants():
    """This tree's kernel under each of ``VARIANTS``, compiled in
    parallel; each build's ``-Xptxas -v`` lines printed."""
    sys.path.insert(0, ROOT)
    times = timing()
    from mythril_tpu_torch.ops import keccak as KC

    with open(KC.SOURCE) as f:
        source = f.read()
    texts = {name: times.apply_edits(source, edits)
             for name, edits in VARIANTS.items()}
    jobs = {}
    for name, text in texts.items():
        src, lib = variant_paths(name)
        os.makedirs(os.path.dirname(src), exist_ok=True)
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, lib)
    times.compile_all(jobs, required=tuple(jobs))


def seeded_digests(rows, blocks, device):
    """What the permutation-alone variant writes: keccak-f ``blocks``
    times over lanes i << 32 | row, lanes 0-3 little-endian."""
    import torch

    from mythril_tpu_torch.ops import keccak as KC

    lo = torch.arange(rows, dtype=torch.int64, device=device).expand(25, rows)
    hi = torch.arange(25, dtype=torch.int64, device=device)[:, None].expand(
        25, rows)
    hi, lo = hi.clone(), lo.clone()
    for _ in range(blocks):
        hi, lo = KC._keccak_f(hi, lo)
    halves = torch.stack([lo[:4], hi[:4]], dim=1).permute(2, 0, 1)
    weights = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=device)
    return ((halves.reshape(rows, 8, 1) >> weights) & 0xFF).reshape(
        rows, 32).to(torch.uint8)


def check():
    """This tree's ``keccak256_batch`` on the card against the plain
    version at every width, row count and base offset of the check, the
    rows viewed from a flat buffer; a sample of rows also against the
    native ``keccak256``.  Returns the number of cases; exits at the
    first that differs."""
    import torch

    from mythril_tpu_torch.native import keccak256 as native_keccak
    from mythril_tpu_torch.ops import keccak as KC

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cases = 0
    for width in CHECK_WIDTHS:
        for rows in CHECK_ROWS:
            for offset in CHECK_OFFSETS:
                flat = torch.randint(0, 256, (rows * width + offset + 16,),
                                     dtype=torch.uint8, device="cuda",
                                     generator=gen)
                view = flat[offset:offset + rows * width].view(rows, width)
                got = KC.keccak256_batch(view)
                if not torch.equal(got, KC.keccak256_batch_plain(view)):
                    raise SystemExit(f"check: {rows} x {width} B at offset "
                                     f"{offset} differs from the plain "
                                     "version")
                cases += 1
        for row, digest in zip(view[:4].cpu().numpy(), got[:4].cpu()):
            if native_keccak(row.tobytes()) != bytes(digest.tolist()):
                raise SystemExit(f"check: {width} B differs from the "
                                 "native keccak256")
    return cases


def worker(tree, label, iters, variants):
    """One tree's readings (its package first on the path); with
    ``variants`` this tree's design variants' too."""
    times = timing()
    smoke = load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    sys.path.insert(0, tree)
    import torch

    import mythril_tpu_torch
    from mythril_tpu_torch.ops import keccak as KC

    if os.path.dirname(os.path.dirname(mythril_tpu_torch.__file__)) != tree:
        raise SystemExit(f"imported {mythril_tpu_torch.__file__}, not {tree}")
    libs = {"as built": KC.load_library()}
    if KC.build_info:
        emit({"tree": label, "build": times.ptxas_lines(KC.build_info[1])})
    if variants:
        for name in VARIANTS:
            libs[name] = KC.bind(variant_paths(name)[1])
    spin_lib = times.spin_library()
    stream = torch.cuda.current_stream().cuda_stream

    def spin():
        return spin_lib.spin_launch(times.SPIN_CYCLES, stream)

    gen = torch.Generator(device="cuda")
    for rows, width in CASES:
        gen.manual_seed(2026 + width)
        data = torch.randint(0, 256, (rows, width), dtype=torch.uint8,
                             device="cuda", generator=gen)
        want = KC.keccak256_batch_plain(data)
        blocks = width // KC.RATE_BYTES + 1
        bound_ms, bound_by = smoke.keccak_bound(rows, width)
        floor = [statistics.median(times.event_ms(
            lambda: spin_lib.empty_launch((rows + 127) // 128, 128, stream),
            iters, s)) for s in (None, spin)]
        for name, lib in libs.items():
            out = torch.empty((rows, 32), dtype=torch.uint8, device="cuda")
            args = (data.data_ptr(), out.data_ptr(), rows, width, stream)
            err = lib.keccak_launch(*args)
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"{label} {name}: cudaError {err}")
            expect = (seeded_digests(rows, blocks, "cuda")
                      if name == PERMUTATION_ALONE else want)
            if not torch.equal(out, expect):
                raise SystemExit(f"{label} {name} {rows} x {width}: the "
                                 "kernel differs from its plain version")
            idle = times.event_ms(lambda: lib.keccak_launch(*args), iters)
            busy = times.event_ms(lambda: lib.keccak_launch(*args), iters,
                                  spin)
            emit({"tree": label, "library": name, "rows": rows,
                  "width": width, "idle_ms": statistics.median(idle),
                  "idle_ms_min": min(idle), "spin_ms": statistics.median(busy),
                  "spin_ms_min": min(busy), "bound_ms": bound_ms,
                  "bound_by": bound_by,
                  "idle_share": bound_ms / statistics.median(idle),
                  "spin_share": bound_ms / statistics.median(busy),
                  "empty_idle_ms": floor[0], "empty_spin_ms": floor[1]})
        del data, want


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="another tree of this repository")
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--label", help=argparse.SUPPRESS)
    parser.add_argument("--variants", action="store_true",
                        help=argparse.SUPPRESS)
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("keccak_times: no CUDA device", file=sys.stderr)
        return 2
    if opts.worker:
        worker(os.path.abspath(opts.worker), opts.label, opts.iters,
               opts.variants)
        return 0
    smoke = load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    print(smoke.card_line(), flush=True)
    build_variants()
    emit({"check": check(), "differ": 0})
    this = ("this tree", ROOT, True)
    trees = [this]
    if opts.parent:
        parent = ("parent", os.path.abspath(opts.parent), False)
        trees = [parent, this, this, parent]
    for label, tree, variants in trees:
        argv = [sys.executable, __file__, "--worker", tree, "--label", label,
                "--iters", str(opts.iters)] + (["--variants"] * variants)
        done = subprocess.run(argv, cwd=ROOT)
        if done.returncode:
            return done.returncode
    print(smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
