"""The dense tier's clause sweep over clause rows (``mythril_tpu_torch/
ops/dense_sweep.py`` and ``ops/csrc/dense_sweep.cu``) against the plain
versions and the JAX package's Pallas sweep, on the CPU.

- The kernel's own source built as host C++ with g++
  (``dense_sweep_host``: the kernel's grid emulated block after block,
  each thread taking its (row, lane) pair as on the card) and the plain
  version over the rows (``sweep_rows_plain``,
  what the wrapper runs for CPU tensors) against ``sweep_plain`` over the
  planes the same rows expand to, and all against
  ``_make_dpll_sweep(..., interpret=True)``: seeded CNF rows of 1-12
  literals (the chip check's inputs at a small size, the last eighth
  bucket padding) at B in {8, 16, 64} (lane groups of 8) and 7 (one
  group of all lanes), scores on and off, hot prefixes
  of 0, 128 and all rows;
- the traps: the pool's pad cell (0, 0), carried once for each padded
  sign and counted by the padding lanes; a tautology row (one column in
  both planes); width-0 rows that hold cells; rows wider than a row's
  group of threads, up to 3,000 literals; a dirty workspace;
- the pool: ``DenseClausePool.refresh_coords`` gives rows whose planes
  equal the JAX pool's, also after ``grow_hot``'s hot-first permutation,
  and ships only the row pointers, cells and widths; rows and planes
  convert both ways.

Every comparison is exact (tolerance 0): the counts are integers below
2^24 in float32.
"""

import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mythril_tpu.ops import pallas_prop as jax_pp
from mythril_tpu_torch.ops import dense_prop as port_dp
from mythril_tpu_torch.ops import dense_sweep as DS

#: the random rows' shape (C clause rows over V columns)
C, V = 512, 256


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``dense_sweep.cu`` built as host C++, bound by the wrapper's own
    ``bind``."""
    path = tmp_path_factory.mktemp("dense_sweep") / "libdense_sweep_host.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-x", "c++", "-shared",
                    "-fPIC", "-o", str(path), DS.SOURCE],
                   check=True, capture_output=True)
    return DS.bind(str(path))


def _outputs(B, width, scores):
    shapes = [(B, width), (B, width), (B, 1)]
    shapes += [(B, width)] * 2 if scores else []
    return [torch.zeros(shape) for shape in shapes]


def _host_sweep(lib, rows, A, scores, hot=None, out=None):
    """The host build over ``rows`` for ``A``, adding into ``out`` (fresh
    zeros by default), as the wrapper launches the kernel: no launch for
    a hot prefix of 0 rows."""
    indptr, cells, width = rows
    B, cols = A.shape
    R = width.shape[1] if hot is None else hot
    out = _outputs(B, cols, scores) if out is None else out
    if R:
        spos, sneg = (out[3].data_ptr(), out[4].data_ptr()) if scores \
            else (None, None)
        assert lib.dense_sweep_host(
            indptr.data_ptr(), cells.data_ptr(), width.data_ptr(),
            A.data_ptr(), B, cols, R, out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), spos, sneg, int(scores)) == 0
    return tuple(out)


def _jax_sweep(P, N, width, A, scores, hot=None):
    """JAX's Pallas sweep in interpret mode over the leading ``hot`` rows
    (all by default), with a clause tile that divides them."""
    rows, cols = P.shape
    R = rows if hot is None else hot
    tile = min(jax_pp._tile_c(rows, cols), R)
    call = jax_pp._make_dpll_sweep(R, cols, A.shape[0], tile, True, scores)
    out = call(jnp.asarray(P.float().numpy(), jnp.bfloat16),
               jnp.asarray(N.float().numpy(), jnp.bfloat16),
               jnp.asarray(width.numpy()), jnp.asarray(A.numpy()))
    return [np.asarray(o) for o in out]


def _cnf_coords(rng, rows, cols):
    """``chip_smoke.random_sweep_inputs``' rows: 1-12 literals on distinct
    columns >= 2 with random signs, the last eighth of the rows bucket
    padding (width 0).  Returns (row, column, negative, width [1, rows])."""
    live = rows - rows // 8
    widths = rng.integers(1, 13, size=live)
    row = np.repeat(np.arange(live), widths)
    col = np.concatenate([
        rng.choice(np.arange(2, cols), size=w, replace=False) for w in widths
    ])
    negative = rng.random(row.size) < 0.5
    width = np.zeros((1, rows), np.float32)
    width[0, :live] = widths
    return row, col, negative, width


def _assignment(rng, B, cols):
    A = rng.choice([-1.0, 0.0, 1.0], size=(B, cols)).astype(np.float32)
    A[:, 0] = 0.0
    A[:, 1] = 1.0
    return torch.from_numpy(A)


def _all_equal(rows, P, N, A, scores, hot, host_kernel, jax_too=True):
    """The host build, the rows' plain version and the wrapper on the CPU
    against ``sweep_plain`` on the planes (and JAX's sweep when the
    prefix is not empty), bit for bit; returns ``sweep_plain``'s."""
    want = DS.sweep_plain(P, N, rows.width, A, scores, hot)
    assert len(want) == (5 if scores else 3)
    for got in (_host_sweep(host_kernel, rows, A, scores, hot),
                DS.sweep_rows_plain(*rows, A, scores, hot),
                DS.dense_sweep(*rows, A, scores, hot)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and torch.equal(g, w)
    if jax_too and hot != 0:
        for w, j in zip(want, _jax_sweep(P, N, rows.width, A, scores, hot)):
            assert np.array_equal(w.numpy(), j)
    return want


@pytest.mark.parametrize("hot", [None, 128, 0])
@pytest.mark.parametrize("scores", [True, False])
@pytest.mark.parametrize("B", [7, 8, 16, 64])
def test_sweep_over_rows_matches_plain_and_jax(host_kernel, B, scores, hot):
    """Seeded CNF rows at the chip check's density: every output of the
    kernel's host build and of the rows' plain version equals
    ``sweep_plain`` and JAX's Pallas sweep, full and over hot prefixes."""
    rng = np.random.default_rng(100 + B)
    row, col, negative, width = _cnf_coords(rng, C, V)
    rows = DS.rows_from_coords(row, col, negative, width, V, "cpu")
    P, N = DS.rows_to_planes(rows, V)
    A = _assignment(rng, B, V)
    want = _all_equal(rows, P, N, A, scores, hot, host_kernel)
    if hot == 0:
        assert not any(w.any() for w in want)
    else:
        # vacuity: unit clauses, a conflict, and open clauses with scores
        assert want[0].any() and want[1].any() and want[2].any()
        assert not scores or want[3].any()


def _pool_with_pads(clauses, num_vars):
    """The port's pool and the JAX pool of ``clauses``."""
    jpool = jax_pp.DenseClausePool()
    jpool.refresh(clauses, num_vars + 1)
    ppool = port_dp.DenseClausePool("cpu")
    ppool.refresh(clauses, num_vars + 1)
    return jpool, ppool


def _row_cells(rows, r):
    indptr, cells, _ = rows
    return cells[int(indptr[r]):int(indptr[r + 1])].tolist()


@pytest.mark.parametrize("n_pos", [255, 256])
def test_pad_cell_carried_once_a_padded_sign(host_kernel, n_pos):
    """The JAX package's plane constructors pad each sign's coordinate
    list to its bucket with cell (0, 0): the rows carry it once for each
    padded sign (here both
    at 255 positive literals, only the negative one at exactly 256), and
    the padding lanes, fully assigned as the backend seeds them, count it
    in row 0: bit-equal to JAX's sweep over its own pool's planes."""
    rng = np.random.default_rng(n_pos)
    num_vars = 60
    lits = [int(v) for v in rng.integers(2, num_vars + 2, size=n_pos)]
    lits += [-int(v) for v in rng.integers(2, num_vars + 2, size=100)]
    rng.shuffle(lits)
    clauses = [(2,)] + [tuple(lits[i:i + 4]) for i in range(0, len(lits), 4)]
    jpool, ppool = _pool_with_pads(clauses, num_vars)
    pos = sum(1 for clause in set(map(frozenset, clauses)) for lit in clause
              if lit > 0)
    head = _row_cells(ppool.rows, 0)
    padded_p = pos < 256 or pos & (pos - 1)
    assert head.count(DS.CELL_P) == (1 if padded_p else 0)
    assert head.count(DS.CELL_N) == 1
    assert float(np.asarray(jpool.P)[0, 0]) == (1.0 if padded_p else 0.0)
    P, N = DS.rows_to_planes(ppool.rows, ppool.V)
    for jplane, plane in ((jpool.P, P), (jpool.N, N)):
        assert np.array_equal(np.asarray(jplane, np.float32),
                              plane.float().numpy())
    B = 8
    A0 = _assignment(rng, B, ppool.V)
    A0[:, num_vars + 2:] = 1.0
    A0[5:, :] = 1.0            # padding lanes: every column, column 0 too
    for scores in (True, False):
        want = _all_equal(ppool.rows, P, N, A0, scores, None, host_kernel)
        # row 0 (x2, width 1) holds the N pad: a padding lane counts one
        # false literal there and flags a conflict
        assert want[2][5:].all()


def test_tautology_row(host_kernel):
    """A row holding one column in both planes (x or not x, as raw
    coordinates carry it) counts one true and one false literal in any
    assigned lane, as the planes do."""
    rng = np.random.default_rng(3)
    row, col, negative, width = _cnf_coords(rng, C, V)
    taut = np.array([0, 0, 7, 7, 7])
    tcol = np.array([9, 9, 11, 11, 12])
    tneg = np.array([False, True, False, True, False])
    width[0, 0], width[0, 7] = 2.0, 3.0
    keep = (row != 0) & (row != 7)
    rows = DS.rows_from_coords(np.concatenate([row[keep], taut]),
                               np.concatenate([col[keep], tcol]),
                               np.concatenate([negative[keep], tneg]),
                               width, V, "cpu")
    assert sorted(_row_cells(rows, 0)) == [9 << 2 | DS.CELL_P,
                                           9 << 2 | DS.CELL_N]
    P, N = DS.rows_to_planes(rows, V)
    assert P[0, 9] == N[0, 9] == 1
    A = _assignment(rng, 16, V)
    A[:, 12] = 0.0
    A[:4, 11] = 0.0            # row 7 open there, unit where 11 is set
    for scores in (True, False):
        _all_equal(rows, P, N, A, scores, None, host_kernel)


def test_width_zero_rows_count_nothing(host_kernel):
    """Rows of width 0 (bucket padding) count nothing, even when cells
    sit in them (the pad cell of a pool whose row 0 was a dropped
    tautology): no vote, no score, no conflict."""
    rng = np.random.default_rng(4)
    row, col, negative, width = _cnf_coords(rng, C, V)
    width[0, :3] = 0.0             # rows 0-2 keep their cells
    rows = DS.rows_from_coords(row, col, negative, width, V, "cpu")
    P, N = DS.rows_to_planes(rows, V)
    A = torch.ones((8, V))         # every literal set: rows 0-2 would count
    A[:, 0] = 0.0
    A[:, 5:40] = -1.0
    for scores in (True, False):
        want = _all_equal(rows, P, N, A, scores, None, host_kernel)
        alone = DS.rows_from_coords(row[row < 3], col[row < 3],
                                    negative[row < 3], width, V, "cpu")
        assert not any(t.any() for t in DS.sweep_rows_plain(
            *alone, A, scores))
        assert want[2].any()


@pytest.mark.parametrize("literals", [40, 2047, 2048, 3000])
def test_a_wide_clause_sweeps_equal_to_sweep_plain(host_kernel, literals):
    """A row wider than its group of threads (B = 16), up to and past the
    first design's 2,047-literal row list: the kernel loops over the
    row's cells, and a 3,000-literal clause sweeps equal to
    ``sweep_plain`` and to JAX's sweep, unit (one literal left open) and
    open (two left)."""
    cols = 4096
    rng = np.random.default_rng(literals)
    row, col, negative, width = _cnf_coords(rng, 128, cols)
    wide = rng.choice(np.arange(2, cols), size=literals, replace=False)
    wneg = rng.random(literals) < 0.5
    keep = row != 5
    width[0, 5] = literals
    rows = DS.rows_from_coords(np.concatenate([row[keep],
                                               np.full(literals, 5)]),
                               np.concatenate([col[keep], wide]),
                               np.concatenate([negative[keep], wneg]),
                               width, cols, "cpu")
    assert len(_row_cells(rows, 5)) == literals
    P, N = DS.rows_to_planes(rows, cols)
    A = _assignment(rng, 16, cols)
    # lanes 0-7 falsify the wide clause but for one (unit) or two (open)
    # literals, lane 8 falsifies it whole
    falsify = np.where(wneg, 1.0, -1.0).astype(np.float32)
    for lane in range(9):
        A[lane, wide] = torch.from_numpy(falsify)
        A[lane, wide[:(1 if lane < 4 else 2 if lane < 8 else 0)]] = 0.0
    for scores in (True, False):
        want = _all_equal(rows, P, N, A, scores, None, host_kernel)
        assert want[0][0, wide[0]] + want[1][0, wide[0]] >= 1
        assert want[2][8, 0] == 1.0
        if scores:
            assert want[3][4, wide[0]] + want[4][4, wide[0]] >= 1


def test_dirty_workspace_shows_in_the_results(host_kernel):
    """The sweep adds its counts into the workspace it is given and
    stores 1.0 into ``conf`` where a lane has a conflict, in the host
    build and through the wrapper on the CPU: a workspace left dirty
    shows."""
    rng = np.random.default_rng(6)
    row, col, negative, width = _cnf_coords(rng, C, V)
    rows = DS.rows_from_coords(row, col, negative, width, V, "cpu")
    A = _assignment(rng, 16, V)
    A[8:, 2:] = 0.0                # no literal false: no conflict there
    fresh = DS.sweep_rows_plain(*rows, A, True)
    dirt = [torch.from_numpy(rng.integers(0, 3, size=t.shape)
                             .astype(np.float32)) for t in fresh]
    for sweep in (
        lambda out: _host_sweep(host_kernel, rows, A, True, out=out),
        lambda out: DS.dense_sweep(*rows, A, True, out=out),
    ):
        out = [t.clone() for t in dirt]
        got = sweep(out)
        assert all(g is o for g, o in zip(got, out))
        want = [f + d for f, d in zip(fresh, dirt)]
        want[2] = torch.where(fresh[2] > 0.5, fresh[2], dirt[2])
        assert fresh[2].any() and not fresh[2].all()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert any(not torch.equal(g, f) for g, f in zip(got, fresh))


def _planted(rng, num_vars, n):
    clauses = []
    for _ in range(n):
        picks = rng.choice(np.arange(2, num_vars + 2), rng.integers(1, 6),
                           replace=False)
        clauses.append(tuple(int(v) if rng.random() < 0.5 else -int(v)
                             for v in picks))
    return clauses


def test_refresh_coords_rows_expand_to_the_jax_planes():
    """``refresh_coords`` over deduped coordinates, then again over the
    hot-first permutation ``grow_hot`` applies: the rows are sorted by
    row, hold each cell once, expand to the JAX pool's planes and widths,
    and only the row pointers, cells and widths were shipped."""
    from mythril_tpu_torch.ops.batched_sat import dispatch_stats

    rng = np.random.default_rng(8)
    num_vars = 200
    clauses = _planted(rng, num_vars, 700) + [(5, -5, 9)]  # a tautology
    lits = np.array([lit for c in clauses for lit in c], np.int32)
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in clauses])])
    urow, ulit, width = port_dp.dedupe_clause_rows(lits, indptr)
    mask = port_dp._hot_row_mask(urow, ulit, width, np.array([3, 17, 40]))
    order, new_pos = port_dp._hot_first_perm(mask)
    assert mask.sum() and not np.array_equal(order, np.arange(len(order)))
    for coords in ((urow, ulit, width),
                   (new_pos[urow], ulit, width[order])):
        jpool = jax_pp.DenseClausePool()
        jpool.refresh_coords(*coords, len(clauses), num_vars + 1)
        pool = port_dp.DenseClausePool("cpu")
        dispatch_stats.reset()
        pool.refresh_coords(*coords, len(clauses), num_vars + 1)
        assert (pool.C, pool.V) == (jpool.C, jpool.V)
        indptr_t, cells, w = pool.rows
        assert indptr_t.dtype == cells.dtype == torch.int32
        assert dispatch_stats.h2d_bytes == 4 * (
            pool.C + 1 + cells.numel() + pool.C)
        assert bool((indptr_t[1:] >= indptr_t[:-1]).all())
        for r in range(pool.C):
            row_cells = _row_cells(pool.rows, r)
            assert len(set(row_cells)) == len(row_cells)
        assert np.array_equal(np.asarray(jpool.width), w.numpy())
        for jplane, plane in zip((jpool.P, jpool.N),
                                 DS.rows_to_planes(pool.rows, pool.V)):
            assert np.array_equal(np.asarray(jplane, np.float32),
                                  plane.float().numpy())


def test_rows_and_planes_convert_both_ways():
    """``planes_to_rows`` of the planes ``rows_to_planes`` gives is the
    same rows, cell for cell."""
    rng = np.random.default_rng(9)
    row, col, negative, width = _cnf_coords(rng, C, V)
    rows = DS.rows_from_coords(row, col, negative, width, V, "cpu")
    again = DS.planes_to_rows(*DS.rows_to_planes(rows, V), rows.width)
    for a, b in zip(rows, again):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="coordinate"):
        DS.rows_from_coords(row, col + V, negative, width, V, "cpu")


def test_host_build_refuses_what_the_launch_refuses(host_kernel):
    """The entry point's argument check (``launch_ok``, shared by the
    launch and the host build): no lanes or no rows, and a lane count
    that neither a group of 8 divides nor one block holds, are refused;
    264 lanes (33 groups of 8) are taken."""
    rng = np.random.default_rng(10)
    row, col, negative, width = _cnf_coords(rng, 128, 64)
    rows = DS.rows_from_coords(row, col, negative, width, 64, "cpu")
    for B, R, ok in ((0, 128, False), (8, 0, False), (300, 128, False),
                     (264, 128, True)):
        A = _assignment(rng, max(B, 1), 64)
        out = _outputs(max(B, 1), 64, False)
        got = host_kernel.dense_sweep_host(
            rows.indptr.data_ptr(), rows.cells.data_ptr(),
            rows.width.data_ptr(), A.data_ptr(), B, 64, R,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), None,
            None, 0)
        assert got == (0 if ok else -1), (B, R)
        if ok:
            want = DS.sweep_plain(*DS.rows_to_planes(rows, 64), rows.width,
                                  A, False)
            assert all(torch.equal(o, w) for o, w in zip(out, want))
