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


def learning_problem(C: int, V1: int, B: int, E: int, seed: int = 1,
                     prefill: int = 0):
    """A clause-row problem on which the frontier solvers learn from the
    first iterations on, for holding the frontier kernels against their
    plain versions where learning and the shared pool matter.

    ``C`` rows of width 8 over ``V1 - 1`` variables (row 0 the unit of
    the TRUE anchor, var 1), ``B`` lanes (a multiple of 4).  Gadget
    ``g`` has a selector ``s``, a decision variable ``x`` and ``a``,
    ``b``, ``c`` with rows ``(-s, -x, a)``, ``(-s, -x, b)``,
    ``(-a, -b, c)``, ``(-a, -b, -c)``, placed first so that ``x``'s
    adjacency holds them, and boosters ``(x, p, q)`` over filler
    variables that make DLIS decide ``x = +1`` early.  A lane assumes
    its gadget's selector true and every other false, so deciding its
    ``x`` forces ``a`` and ``b``, then ``c`` both ways, then conflicts
    at depth >= 1: the first-UIP walk resolves three rows and learns
    ``(-x, -s)``.  Lanes ``4i`` and ``4i + 1`` are twins (they learn an
    equal row in one iteration), lane ``4i + 2`` shares their gadget but
    first decides a delay variable (it conflicts on the shared row they
    appended and learns it again), lane ``4i + 3`` has a gadget of its
    own.  An eighth of the variables occur in no pool row (the don't-care
    cascade assigns them); the rest of the rows are random 3-clauses
    over the filler variables.  ``prefill`` random rows over unused and
    filler variables start the shared pool, so ``B / 2`` distinct
    learned rows overflow a pool of ``E`` rows when ``prefill + B / 2 >
    E``.

    Returns ``(rows [C, 8] int32, assign [B, V1] int8, extra [E + 1, 8]
    int32)``; ``extra``'s first ``prefill`` rows are live."""
    import numpy as np

    if B % 4 or B < 4:
        raise ValueError("learning_problem: B must be a positive multiple "
                         "of 4")
    rng = np.random.default_rng(seed)
    G = B // 2
    delay = 2
    gadget0 = 3
    first_free = gadget0 + 5 * G
    n_unused = (V1 - first_free) // 8
    unused = np.arange(V1 - n_unused, V1)
    filler = np.arange(first_free, V1 - n_unused)
    boosts = [40 + (G - g) for g in range(G)]
    if first_free >= V1 - n_unused - 8 or (
        1 + 4 * G + 64 + sum(boosts) >= C
    ):
        raise ValueError("learning_problem: C or V1 too small for B")
    rows = np.zeros((C, 8), np.int32)
    rows[0, 0] = 1
    n = 1
    for g in range(G):
        s, x, a, b, c = gadget0 + 5 * g + np.arange(5)
        for row in ((-s, -x, a), (-s, -x, b), (-a, -b, c), (-a, -b, -c)):
            rows[n, :3] = row
            n += 1

    def pq():
        return rng.choice(filler, size=2, replace=False) * rng.choice(
            [1, -1], size=2)

    for _ in range(64):
        rows[n, 0] = delay
        rows[n, 1:3] = pq()
        n += 1
    for g in range(G):
        x = gadget0 + 5 * g + 1
        for _ in range(boosts[g]):
            rows[n, 0] = x
            rows[n, 1:3] = pq()
            n += 1
    live = C - C // 16
    for i in range(n, live):
        rows[i, :3] = rng.choice(filler, size=3, replace=False) * rng.choice(
            [1, -1], size=3)
    assign = np.zeros((B, V1), np.int8)
    assign[:, 1] = 1
    selectors = gadget0 + 5 * np.arange(G)
    assign[:, selectors] = -1
    for lane in range(B):
        group, role = divmod(lane, 4)
        gadget = 2 * group + (1 if role == 3 else 0)
        assign[lane, selectors[gadget]] = 1
        if role != 2:
            assign[lane, delay] = 1
    extra = np.zeros((E + 1, 8), np.int32)
    for e in range(min(prefill, E)):
        vs = np.concatenate([rng.choice(unused, size=2, replace=False),
                             rng.choice(filler, size=2, replace=False)])
        extra[e, :4] = vs * rng.choice([1, -1], size=4)
    return rows, assign, extra


def _word_dag(T, seed, widths, n_vars=2, n_nodes=30, n_cons=12):
    """Seeded random term DAG over every op of the word tier's fragment;
    returns its constraint nodes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = {}

    def rand_int(width):
        return int.from_bytes(rng.bytes(32), "little") & ((1 << width) - 1)

    def pick(width):
        cands = pool.get(width) or []
        if cands and rng.random() < 0.85:
            return cands[int(rng.integers(len(cands)))]
        if rng.random() < 0.5:
            return T.var(f"v{width}_{int(rng.integers(n_vars))}", width)
        r = rng.random()
        if r < 0.3:
            return T.const(int(rng.integers(0, 4)), width)
        if r < 0.6:
            return T.const(1 << int(rng.integers(0, width)), width)
        return T.const(rand_int(width), width)

    for w in widths:
        for i in range(n_vars):
            pool.setdefault(w, []).append(T.var(f"v{w}_{i}", w))
    bin_ops = ("add", "sub", "mul", "udiv", "urem", "bv_and", "bv_or",
               "bv_xor", "shl", "lshr", "ashr")
    for _ in range(n_nodes):
        w = widths[int(rng.integers(len(widths)))]
        r = rng.random()
        a = pick(w)
        if r < 0.55:
            op = bin_ops[int(rng.integers(len(bin_ops)))]
            b = pick(w)
            if op in ("shl", "lshr", "ashr") and rng.random() < 0.7:
                b = T.const(int(rng.integers(0, w + 3)), w)
            if op in ("bv_and", "bv_or", "bv_xor", "add", "sub") \
                    and rng.random() < 0.4:
                b = T.const(rand_int(w), w)
            n = getattr(T, op)(a, b)
        elif r < 0.62:
            n = T.bv_not(a)
        elif r < 0.72 and w > 8:
            lo = int(rng.integers(0, w - 1))
            n = T.extract(int(rng.integers(lo, w)), lo, a)
        elif r < 0.8:
            wider = [x for x in widths if x > w]
            if not wider:
                continue
            nw = wider[int(rng.integers(len(wider)))]
            n = (T.zext if rng.random() < 0.5 else T.sext)(nw - w, a)
        elif r < 0.88:
            n = T.concat([pick(8) for _ in range(int(rng.integers(2, 5)))])
        else:
            n = T.ite(T.ult(pick(w), pick(w)), a, pick(w))
        if n.sort == "bv" and n.width <= 256:
            pool.setdefault(n.width, []).append(n)
    cons = []
    cmps = ("eq", "ult", "ule", "slt", "sle")
    for _ in range(n_cons):
        w = widths[int(rng.integers(len(widths)))]
        c = getattr(T, cmps[int(rng.integers(len(cmps)))])(pick(w), pick(w))
        r = rng.random()
        if r < 0.15:
            c = T.bnot(c)
        elif r < 0.25 and cons:
            c = T.band(c, cons[int(rng.integers(len(cons)))])
        elif r < 0.35 and cons:
            c = T.bor(c, cons[int(rng.integers(len(cons)))])
        elif r < 0.4 and cons:
            c = T.bxor(c, cons[int(rng.integers(len(cons)))])
        if c.sort == "bool" and not c.is_const:
            cons.append(c)
    return cons


def word_dag_lanes(seed: int, n_lanes: int, widths=(256, 64, 8), terms=None):
    """``n_lanes`` constraint sets over one seeded random term DAG (every
    op of the word tier's fragment at ``widths``), each 1-5 of its
    constraints: the word tier's inputs for the chip check and the
    tests.  ``terms`` is the terms module to build with (the port's by
    default), so a test can build the same DAG in the JAX package."""
    if terms is None:
        from mythril_tpu_torch.smt import terms
    T = terms
    cons = _word_dag(T, seed, widths)
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    lanes = []
    for _ in range(n_lanes):
        k = int(rng.integers(1, min(5, len(cons)) + 1))
        pick = sorted(rng.choice(len(cons), size=k, replace=False).tolist())
        lanes.append([cons[i] for i in pick])
    return lanes


def _spread_lanes(rng, cons, n_lanes, extra=2):
    """``n_lanes`` constraint lists that together hold every constraint
    of ``cons`` (lane k takes every ``n_lanes``-th one from k), each with
    up to ``extra`` more drawn at random."""
    lanes = []
    for k in range(n_lanes):
        own = set(range(k, len(cons), n_lanes))
        more = int(rng.integers(0, extra + 1))
        own.update(rng.choice(len(cons), size=min(more, len(cons)),
                              replace=False).tolist())
        lanes.append([cons[i] for i in sorted(own)])
    return lanes


def word_opcode_lanes(seed: int, n_lanes: int,
                      widths=(1, 8, 31, 33, 160, 256), terms=None):
    """Constraint sets whose word-tier program holds every opcode of the
    word kernel's table (``ops/word_fixpoint.OP_NAMES``): a seeded random
    DAG at ``widths`` and, at each width, one term of every bv op of the
    fragment under a comparison, the bool connectives, bool constants,
    bool vars and bool-sorted ite, and an opaque subterm (``sdiv``)."""
    if terms is None:
        from mythril_tpu_torch.smt import terms
    T = terms
    import numpy as np

    rng = np.random.default_rng(seed)

    def rand_int(width):
        return int.from_bytes(rng.bytes(32), "little") & ((1 << width) - 1)

    cons = list(_word_dag(T, seed, widths))
    cmps = ("eq", "ult", "ule", "slt", "sle")
    made = []
    for w in widths:
        a, b = T.var(f"a{w}", w), T.var(f"b{w}", w)
        k = T.const(rand_int(w), w)
        amount = T.const(int(rng.integers(0, w + 2)), w)
        made += [T.add(a, b), T.sub(a, k), T.mul(a, b), T.udiv(a, b),
                 T.urem(a, k), T.bv_and(a, k), T.bv_or(a, b),
                 T.bv_xor(a, k), T.bv_not(a), T.shl(a, amount),
                 T.lshr(a, b), T.ashr(a, amount),
                 T.ite(T.ult(a, b), a, k)]
        if w > 1:
            made.append(T.extract(w - 1, w // 2, a))
        wider = [x for x in widths if x > w]
        if wider:
            made += [T.zext(wider[0] - w, a), T.sext(wider[-1] - w, b)]
        if 2 * w <= 256:
            made.append(T.concat([a, b]))
    for i, node in enumerate(made):
        other = T.const(rand_int(node.width), node.width)
        if rng.random() < 0.5:
            other = T.var(f"o{node.width}_{i % 3}", node.width)
        cons.append(getattr(T, cmps[i % len(cmps)])(node, other))
    p, q = T.bvar("p"), T.bvar("q")
    base = [c for c in cons if c.sort == "bool" and not c.is_const]
    x, y = T.var("sx", 33), T.var("sy", 33)
    cons += [T.band(base[0], base[1]), T.bor(base[2], base[3]),
             T.bxor(base[4], base[5]), T.bnot(T.band(p, base[6])),
             T.ite(p, base[7], q), T.ite(q, T.bconst(True), base[8]),
             T.eq(T.sdiv(x, y), x)]
    cons = [c for c in cons if c.sort == "bool" and not c.is_const]
    return _spread_lanes(rng, cons, n_lanes)


def word_deep_lanes(n_lanes: int, levels: int = 10, terms=None):
    """Constraint sets over a 64-bit word built ``levels`` deep from
    ``concat`` and ``extract`` (each level a fresh byte on top of the
    previous level's low 56 bits), so that a comparison on the top word
    pushes its refinement down the word tier's full depth of 8 (two
    levels a frame pair) and stops there.  Each lane compares the top
    word (or one of its levels) with its own constant; some lanes pin a
    byte to a value that contradicts another, for conflicts met during
    the push-down."""
    if terms is None:
        from mythril_tpu_torch.smt import terms
    T = terms
    import numpy as np

    rng = np.random.default_rng(levels)
    chain = [T.var("deep", 64)]
    for k in range(levels):
        chain.append(T.concat([T.var(f"d{k}", 8),
                               T.extract(55, 0, chain[-1])]))
    top = chain[-1]
    lanes = []
    for lane in range(n_lanes):
        value = int.from_bytes(rng.bytes(8), "little")
        cons = [T.eq(top, T.const(value, 64))]
        if lane % 3 == 1:
            cons.append(T.ult(chain[levels // 2], T.const(value >> 8, 64)))
        if lane % 4 == 2:  # the low byte two ways: a conflict
            cons.append(T.eq(T.extract(7, 0, chain[0]),
                             T.const((value & 0xFF) ^ 1, 8)))
        if lane % 5 == 3:
            cons = [T.ule(T.const(value, 64), top)]
        lanes.append(cons)
    return lanes


def word_cap_lanes(seed: int, n_lanes: int, cap: int = 1024, terms=None,
                   n_nodes: int = 1400):
    """Constraint sets over one seeded random term DAG of ``n_nodes``
    nodes whose lanes together reach as close to ``cap`` term nodes as
    the constraints allow without passing it (the word tier's node cap):
    the largest program the word kernel takes."""
    if terms is None:
        from mythril_tpu_torch.smt import terms
    T = terms
    import numpy as np

    cons = _word_dag(T, seed, (256, 64, 8), n_vars=4, n_nodes=n_nodes,
                     n_cons=400)
    seen = set()
    kept = []
    for c in cons:
        cone, stack = set(), [c]
        while stack:
            node = stack.pop()
            if node.id in seen or node.id in cone:
                continue
            cone.add(node.id)
            stack.extend(node.args)
        if len(seen) + len(cone) <= cap:
            seen |= cone
            kept.append(c)
    return _spread_lanes(np.random.default_rng(seed + 1), kept, n_lanes)
