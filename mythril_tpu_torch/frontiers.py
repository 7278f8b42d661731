"""EVM-shaped path-constraint frontiers for the chip check and the tests.

The constraints are the ones LASER collects on the paths of
``bench.py:scale_contract`` (a selector-bit dispatch tree over
``calldata[0:32] >> 0xe0`` whose leaves guard on a masked calldata
word), built directly with the SMT API: ``CALLDATALOAD`` is a
big-endian ``Concat`` of 32 calldata bytes, ``EQ`` is
``If(a == b, 1, 0)`` on 256-bit words, and a taken ``JUMPI`` adds
``cond != 0`` (``cond == 0`` on the fall-through).

Every builder takes the SMT package to build with (the port's by
default), so the tests can feed the same recipe to the JAX package.
Each returns ``(lanes, expected)``: one constraint list per lane, and
the lane's known verdict (True = feasible).
"""


def _smt(smt):
    if smt is None:
        import mythril_tpu_torch.smt as smt
    return smt


class _Calldata:
    """``CALLDATALOAD`` source.  ``"array"`` is LASER's model: one
    symbolic byte array, a load is a big-endian ``Concat`` of 32 reads
    (the blaster Ackermannizes every pair of reads, which dominates the
    cones).  ``"words"`` gives each loaded offset its own free 256-bit
    word: the same guards over far smaller cones, for CPU-sized tests."""

    def __init__(self, S, model: str):
        if model not in ("array", "words"):
            raise ValueError(f"calldata model {model!r}")
        self.S = S
        self.array = S.Array("calldata", 256, 8) if model == "array" else None

    def load(self, offset: int):
        S = self.S
        if self.array is None:
            return S.symbol_factory.BitVecSym(f"calldata_{offset}", 256)
        return S.Concat(*[
            self.array[S.symbol_factory.BitVecVal(offset + k, 256)]
            for k in range(32)
        ])


def _taken(S, cond):
    return cond != S.symbol_factory.BitVecVal(0, 256)


def _eq_word(S, a, b):
    one = S.symbol_factory.BitVecVal(1, 256)
    zero = S.symbol_factory.BitVecVal(0, 256)
    return S.If(a == b, one, zero)


def _selector_path(S, selector, depth: int, leaf: int):
    """Constraints of the dispatch-tree path to ``leaf``: level ``l``
    tests bit ``l`` of the selector (``bench.py:scale_contract``)."""
    prefix = format(leaf, f"0{depth}b")
    out = []
    for level, bit in enumerate(prefix):
        cond = selector & S.symbol_factory.BitVecVal(1 << level, 256)
        out.append(_taken(S, cond) if bit == "1"
                   else cond == S.symbol_factory.BitVecVal(0, 256))
    return out, int(prefix[::-1], 2)


def scale_mul_frontier(depth: int = 6, guard_bits: int = 16, smt=None,
                       calldata: str = "array"):
    """The ``scale_mul`` frontier: one lane per leaf of the depth-``depth``
    tree (``2**depth`` lanes).  Leaves ``i % 4 == 1`` take the dead-path
    branch (a low-2-bit equality contradicting the tree bits,
    ``bench.py:357-363``); the others take the MUL guard
    ``((w & mask) * odd_i & mask) == target_i`` (``bench.py:369-379``,
    odd factor: always satisfiable)."""
    S = _smt(smt)
    bv = S.symbol_factory.BitVecVal
    source = _Calldata(S, calldata)
    selector = S.LShR(source.load(0), bv(0xE0, 256))
    word = source.load(4)
    mask = (1 << guard_bits) - 1
    lanes, expected = [], []
    for i in range(1 << depth):
        path, value = _selector_path(S, selector, depth, i)
        if i % 4 == 1:
            wrong = ((value & 3) + 1) & 3
            guard = _eq_word(S, selector & bv(3, 256), bv(wrong, 256))
            expected.append(False)
        else:
            odd = (0x6D2B + 2 * 7919 * i) & mask | 1
            target = (0x6D2B + 104729 * i) & mask
            product = ((word & bv(mask, 256)) * bv(odd, 256)) & bv(mask, 256)
            guard = _eq_word(S, product, bv(target, 256))
            expected.append(True)
        lanes.append(path + [_taken(S, guard)])
    return lanes, expected


def guard_chain_frontier(lanes: int = 64, guard_bits: int = 32,
                         guards: int = 3, smt=None, calldata: str = "array"):
    """``lanes`` sibling forks sharing one guard chain on a masked
    256-bit calldata word ``m = w & mask``: ``guards`` MUL guards
    ``(m * odd_j) & mask == (x0 * odd_j) & mask`` (odd factors, so each
    pins ``m`` to ``x0``), then a per-lane test of one bit of ``m``.
    Lanes ``i % 4 == 1`` test the bit against the wrong value (dead);
    the others agree with ``x0`` (feasible).  The shared chain makes the
    lanes' cones one union cone, so the dispatch runs the union layout."""
    S = _smt(smt)
    bv = S.symbol_factory.BitVecVal
    word = _Calldata(S, calldata).load(4)
    mask = (1 << guard_bits) - 1
    x0 = 0x9E3779B97F4A7C15 & mask
    m = word & bv(mask, 256)
    chain = []
    for j in range(guards):
        odd = (0x6D2B + 2 * 7919 * (j + 1) * 0x10001) & mask | 1
        product = (m * bv(odd, 256)) & bv(mask, 256)
        chain.append(_taken(S, _eq_word(S, product, bv(x0 * odd & mask, 256))))
    def bit_test(bit, flip):
        probe = S.LShR(m, bv(bit, 256)) & bv(1, 256)
        return probe == bv(((x0 >> bit) & 1) ^ flip, 256)

    out, expected = [], []
    for i in range(lanes):
        # lanes past the first guard_bits also test the next bit, so
        # every lane is a distinct query (the funnel dedupes equal sets)
        dead = i % 4 == 1
        tests = [bit_test(i % guard_bits, dead)]
        if i >= guard_bits:
            tests.append(bit_test((i + 1) % guard_bits, False))
        out.append(chain + tests)
        expected.append(not dead)
    return out, expected
