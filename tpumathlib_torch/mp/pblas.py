"""Distributed PBLAS-style ops over row-sharded operands — the cuBLASMp op
breadth beyond matmul (cuBLASMp/README.md:9-31: trsm, trmm, syrk, syr2k,
syrkx, symm, geadd, tradd; gemm and gemr2d live in mp.matmul).

Counterpart of ``tpumathlib/mp/pblas.py``, which has no kernel. Operands are
row-sharded over the grid's one axis ((axis, None), the 1-block-per-rank
case of the 2D block-cyclic layout); each rank's work is a loop iteration
here. A rank's triangle mask comes from its global row offset. Cross-rank
terms ride one all-gather (``mp.matmul._all_gather``), except trsm, which
runs the block forward (lower) or backward (upper) substitution over the
ranks: each step solves the diagonal block on its rank with
``torch.linalg.solve_triangular`` and copies the solved block to every rank,
which subtracts its product from its own right-hand side. The products are
``torch.matmul`` in f32 and the solve is torch's, the vendor path that the
reference's ``jnp.matmul`` and ``jax.scipy.linalg.solve_triangular`` stand
for. Operands may be numpy arrays, tensors or ``Sharded``; results are
``Sharded`` (axis, None).
"""

from __future__ import annotations

import torch

from tpumathlib_torch.fft.kernels import _f32_products  # noqa: F401  (C16: patched by name)
from tpumathlib_torch.mp.grid import Grid, Sharded
from tpumathlib_torch.mp.matmul import _all_gather

F32 = torch.float32


def _mm(a, b):
    with _f32_products():
        return torch.matmul(a.to(F32), b.to(F32))


def _rows(blk, rank: int):
    """Global row indices (mloc, 1) of rank ``rank``'s block."""
    mloc = blk.shape[0]
    return rank * mloc + torch.arange(mloc, device=blk.device)[:, None]


def _rowmask_tri(blk, rank: int, uplo: str, diag_offset: int = 0):
    """Triangle mask for a row-sharded block: global row index vs column."""
    rows = _rows(blk, rank)
    cols = torch.arange(blk.shape[1], device=blk.device)[None, :]
    if uplo == "lower":
        return rows + diag_offset >= cols
    return rows <= cols + diag_offset


def _tri(blk, rank: int, uplo: str, unit: bool):
    out = torch.where(_rowmask_tri(blk, rank, uplo), blk, 0.0)
    if unit:
        diag = _rows(blk, rank) == torch.arange(blk.shape[1], device=blk.device)[None, :]
        out = torch.where(diag, 1.0, out)
    return out


def _row_sharded(grid: Grid, axis, *xs):
    axis = grid.axis(axis)
    return axis, [grid.shard(x, (axis, None)) for x in xs]


def _result(grid, axis, pieces, like: Sharded) -> Sharded:
    return Sharded(grid, pieces, (axis, None), like.shape)


def _my_rows_of_transpose(full, rank: int, mloc: int, ncols: int):
    """Rows [rank·mloc, (rank+1)·mloc) of fullᵀ, its first ``ncols`` columns."""
    return full.mT[rank * mloc:(rank + 1) * mloc, :ncols]


def mp_syrk(a, c, grid: Grid, alpha=1.0, beta=0.0, uplo: str = "lower",
            axis: str | None = None) -> Sharded:
    """C := alpha·A·Aᵀ + beta·C on the uplo triangle (≙ cublasMpSyrk).
    A: (axis, None) (m_loc, k), C: (axis, None) (m_loc, m)."""
    axis, (a, c) = _row_sharded(grid, axis, a, c)
    outs = []
    for r, (a_blk, a_full, c_blk) in enumerate(zip(a.pieces, _all_gather(a), c.pieces)):
        new = alpha * _mm(a_blk, a_full.mT) + beta * c_blk
        outs.append(torch.where(_rowmask_tri(c_blk, r, uplo), new, c_blk).to(c_blk.dtype))
    return _result(grid, axis, outs, c)


def mp_syr2k(a, b, c, grid: Grid, alpha=1.0, beta=0.0, uplo: str = "lower",
             axis: str | None = None) -> Sharded:
    """C := alpha·(A·Bᵀ + B·Aᵀ) + beta·C on the uplo triangle
    (≙ cublasMpSyr2k)."""
    axis, (a, b, c) = _row_sharded(grid, axis, a, b, c)
    outs = []
    for r, (a_blk, b_blk, a_full, b_full, c_blk) in enumerate(
            zip(a.pieces, b.pieces, _all_gather(a), _all_gather(b), c.pieces)):
        new = alpha * (_mm(a_blk, b_full.mT) + _mm(b_blk, a_full.mT)) + beta * c_blk
        outs.append(torch.where(_rowmask_tri(c_blk, r, uplo), new, c_blk).to(c_blk.dtype))
    return _result(grid, axis, outs, c)


def mp_syrkx(a, b, c, grid: Grid, alpha=1.0, beta=0.0, uplo: str = "lower",
             axis: str | None = None) -> Sharded:
    """C := alpha·A·Bᵀ + beta·C on the uplo triangle (≙ cublasMpSyrkx)."""
    axis, (a, b, c) = _row_sharded(grid, axis, a, b, c)
    outs = []
    for r, (a_blk, b_full, c_blk) in enumerate(zip(a.pieces, _all_gather(b), c.pieces)):
        new = alpha * _mm(a_blk, b_full.mT) + beta * c_blk
        outs.append(torch.where(_rowmask_tri(c_blk, r, uplo), new, c_blk).to(c_blk.dtype))
    return _result(grid, axis, outs, c)


def mp_symm(a, b, c, grid: Grid, alpha=1.0, beta=0.0, uplo: str = "lower",
            axis: str | None = None) -> Sharded:
    """C := alpha·sym(A)·B + beta·C, A symmetric stored in its uplo triangle
    (left side; ≙ cublasMpSymm). All operands (axis, None)."""
    axis, (a, b, c) = _row_sharded(grid, axis, a, b, c)
    outs = []
    for r, (a_full, b_full, c_blk) in enumerate(zip(_all_gather(a), _all_gather(b), c.pieces)):
        m, mloc = a_full.shape[0], c_blk.shape[0]
        rows = torch.arange(m, device=a_full.device)[:, None]
        cols = torch.arange(m, device=a_full.device)[None, :]
        keep = rows >= cols if uplo == "lower" else rows <= cols
        my_rows = torch.where(keep, a_full, a_full.mT)[r * mloc:(r + 1) * mloc]
        outs.append((alpha * _mm(my_rows, b_full) + beta * c_blk).to(c_blk.dtype))
    return _result(grid, axis, outs, c)


def mp_trmm(a, b, grid: Grid, alpha=1.0, uplo: str = "lower",
            trans: bool = False, unit: bool = False,
            axis: str | None = None) -> Sharded:
    """B := alpha·op(tri(A))·B, left side (≙ cublasMpTrmm).
    A: (axis, None) (m_loc, m), B: (axis, None) (m_loc, n)."""
    axis, (a, b) = _row_sharded(grid, axis, a, b)
    tris = Sharded(grid, [_tri(blk, r, uplo, unit) for r, blk in enumerate(a.pieces)],
                   (axis, None), a.shape)
    tri_full = _all_gather(tris) if trans else [None] * grid.size
    outs = []
    for r, (t_blk, t_full, b_full, b_blk) in enumerate(
            zip(tris.pieces, tri_full, _all_gather(b), b.pieces)):
        op_rows = _my_rows_of_transpose(t_full, r, t_blk.shape[0], t_full.shape[0]) \
            if trans else t_blk
        outs.append((alpha * _mm(op_rows, b_full)).to(b_blk.dtype))
    return _result(grid, axis, outs, b)


def mp_trsm(a, b, grid: Grid, alpha=1.0, uplo: str = "lower",
            unit: bool = False, axis: str | None = None) -> Sharded:
    """Solve tri(A)·X = alpha·B, left side (≙ cublasMpTrsm): block forward
    (lower) / backward (upper) substitution across ranks — one
    diagonal-block solve and one broadcast a rank step, trailing updates as
    products.

    A: (axis, None) (m_loc, m), B: (axis, None) (m_loc, n) → X the same."""
    axis, (a, b) = _row_sharded(grid, axis, a, b)
    nr = grid.size
    ats = [_tri(blk, r, uplo, unit) for r, blk in enumerate(a.pieces)]
    accs = [alpha * blk.to(F32) for blk in b.pieces]
    xs = [None] * nr
    order = range(nr) if uplo == "lower" else range(nr - 1, -1, -1)
    for r in order:
        mloc = ats[r].shape[0]
        diag = ats[r][:, r * mloc:(r + 1) * mloc].to(F32)
        x_r = torch.linalg.solve_triangular(diag, accs[r], upper=uplo != "lower",
                                            unitriangular=unit)
        xs[r] = x_r
        # trailing update for the ranks not yet solved (their block in
        # column r lies wholly inside the triangle); x_r is copied to each
        for q in range(nr):
            if (q > r) if uplo == "lower" else (q < r):
                x_q = x_r.to(grid.devices[q])
                # not pinned: TF32 kept it within 2.5e-7 of float64 (ROADMAP C16)
                accs[q] = accs[q] - torch.matmul(ats[q][:, r * mloc:(r + 1) * mloc].to(F32), x_q)
    outs = [x.to(blk.dtype) for x, blk in zip(xs, b.pieces)]
    return _result(grid, axis, outs, b)


def _op_rows(a: Sharded, r: int, trans: bool, a_full, ncols: int):
    if not trans:
        return a.pieces[r]
    return _my_rows_of_transpose(a_full, r, a.pieces[r].shape[0], ncols)


def mp_geadd(a, c, grid: Grid, alpha=1.0, beta=0.0, trans: bool = False,
             axis: str | None = None) -> Sharded:
    """C := alpha·op(A) + beta·C (≙ cublasMpGeadd). With trans=True the
    transpose redistribution rides one all-gather."""
    axis, (a, c) = _row_sharded(grid, axis, a, c)
    fulls = _all_gather(a) if trans else [None] * grid.size
    outs = [(alpha * _op_rows(a, r, trans, fulls[r], c_blk.shape[1]) + beta * c_blk
             ).to(c_blk.dtype) for r, c_blk in enumerate(c.pieces)]
    return _result(grid, axis, outs, c)


def mp_tradd(a, c, grid: Grid, alpha=1.0, beta=0.0, uplo: str = "lower",
             trans: bool = False, axis: str | None = None) -> Sharded:
    """C := alpha·op(A) + beta·C on the uplo triangle only
    (≙ cublasMpTradd); entries outside the triangle are left unchanged."""
    axis, (a, c) = _row_sharded(grid, axis, a, c)
    fulls = _all_gather(a) if trans else [None] * grid.size
    outs = []
    for r, c_blk in enumerate(c.pieces):
        new = alpha * _op_rows(a, r, trans, fulls[r], c_blk.shape[1]) + beta * c_blk
        outs.append(torch.where(_rowmask_tri(c_blk, r, uplo), new, c_blk).to(c_blk.dtype))
    return _result(grid, axis, outs, c)
