"""Jacobi eigen/SVD solvers with round-robin parallel ordering.

Counterpart of ``tpumathlib/solver/jacobi.py``: cuSOLVER gesvdj/syevj/sygvj
(+Batched) with tolerance / max-sweeps parameters and the residual and
sweep-count queries (cusolverDnXgesvdjSetTolerance/MaxSweeps/GetResidual/
GetSweeps), with the reference's names, arguments and return tuples.

A sweep is n−1 rounds of the round-robin tournament schedule; each round
rotates ⌊n/2⌋ disjoint pairs, which together form one orthogonal matrix J
(identity with 2×2 blocks at the pairs), so
  one-sided (gesvdj):  A ← A·J,  V ← V·J
  two-sided (syevj):   A ← Jᵀ·A·J, V ← V·J
as products (``torch.matmul``, as the reference leaves them to XLA, with
f32 products pinned by ``fft.kernels._f32_products`` so that a caller's
TF32 setting does not reach them: ROADMAP C16). It runs no kernel of the
repository, on the input's device, in its dtype (f32 or f64).

The reference vmaps a ``while_loop`` over a batch, so each matrix stops at
its own sweep count. Here the whole batch runs sweep by sweep, and a mask
freezes each matrix once it has converged or reached ``max_sweeps``: it is
not rotated again, so ``sweeps``, ``residual`` and the result of each matrix
are those it would have alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx.solver import _rot_t
from tpumathlib_torch.fft.kernels import _f32_products


@functools.lru_cache(maxsize=32)
def _round_robin(n: int) -> np.ndarray:
    """Tournament schedule: (m−1) rounds × (m/2) disjoint pairs covering all
    C(m, 2) pairs of m = n rounded up to even."""
    m = n + (n % 2)
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        rounds.append([(players[i], players[m - 1 - i]) for i in range(m // 2)])
        players = [players[0]] + [players[-1]] + players[1:-1]
    out = np.array(rounds)  # (m-1, m/2, 2)
    out.flags.writeable = False
    return out


def _rotation_matrix(n, p, q, c, s):
    """Orthogonal J for each matrix of a batch: identity with [c s; −s c]
    blocks at the disjoint pairs (p, q); c and s are (B, k)."""
    j = torch.eye(n, dtype=c.dtype, device=c.device).repeat(c.shape[0], 1, 1)
    j[:, p, p] = c
    j[:, q, q] = c
    j[:, p, q] = s
    j[:, q, p] = -s
    return j


def _sym_schur(app, aqq, apq):
    """2×2 symmetric Schur rotation (c, s) zeroing apq, from the dx
    kernels' ``_rot_t``; c by 1/sqrt, as the reference's ``_sym_schur``,
    so that the stopping test sees the reference's last bits."""
    t = _rot_t(app, aqq, apq)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _sweeps(mat, v, sched, one_round, measure, res, going, max_sweeps):
    """Run sweeps over a batch while ``going(res)`` and fewer than
    ``max_sweeps`` sweeps hold for a matrix, as the reference's
    ``while_loop``; a matrix for which they no longer hold is not rotated
    again. ``res`` starts as the reference's loop state and takes
    ``measure`` after each sweep. Returns (mat, v, res, sweeps)."""
    sweeps = torch.zeros(mat.shape[0], dtype=torch.int32, device=mat.device)
    while True:
        idx = (going(res) & (sweeps < max_sweeps)).nonzero()[:, 0]
        if idx.numel() == 0:
            return mat, v, res, sweeps
        m, w = mat[idx], v[idx]
        for pairs in sched:
            m, w = one_round(m, w, pairs[:, 0], pairs[:, 1])
        mat[idx], v[idx] = m, w
        res[idx] = measure(m)
        sweeps[idx] += 1


def _sum_in_order(x):
    """Sum over all but the batch dim, element after element in row-major
    order, as XLA's CPU reduction sums (a sequential scan on the CPU). The
    residuals below are a full sum less the diagonal's: summed in order,
    off-diagonal terms below the last bit of the running sum vanish in both,
    so a converged matrix gives exactly 0, as in the reference. A pairwise
    sum leaves a rounding difference there (about 1e-7·‖A‖ in f64), which
    can keep a matrix sweeping to ``max_sweeps`` where the reference stops."""
    return x.flatten(1).cumsum(1)[:, -1]


def _batch(a):
    return a.reshape((-1,) + a.shape[-2:])


def _unbatch(bs, *outs):
    return tuple(o.reshape(bs + o.shape[1:]) for o in outs)


def _syevj_batched(a, tol, max_sweeps):
    """syevj over a (B, n, n) batch of symmetric matrices."""
    n = a.shape[-1]
    m = n + (n % 2)
    if m != n:
        # zero-pad: the pad row/col stays exactly zero (rotations touching it
        # see apq=0 → identity), so it decouples with eigenvalue 0
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    sched = torch.tensor(_round_robin(n), device=a.device)
    norm = torch.linalg.matrix_norm(a)

    def off(mat):
        diag = torch.diagonal(mat, dim1=-2, dim2=-1)
        return torch.sqrt(torch.clamp(_sum_in_order(mat * mat) - _sum_in_order(diag * diag),
                                      min=0.0))

    def one_round(mat, v, p, q):
        c, s = _sym_schur(mat[:, p, p], mat[:, q, q], mat[:, p, q])
        j = _rotation_matrix(m, p, q, c, s)
        with _f32_products():
            return j.mT @ mat @ j, v @ j

    v0 = torch.eye(m, dtype=a.dtype, device=a.device).repeat(a.shape[0], 1, 1)
    mat, v, res, sweeps = _sweeps(a.clone(), v0, sched, one_round, off,
                                  off(a) + tol * norm + 1.0, lambda r: r > tol * norm, max_sweeps)
    w = torch.diagonal(mat, dim1=-2, dim2=-1)[:, :n]
    v = v[:, :n, :n]
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.take_along_dim(w, order, -1), torch.take_along_dim(v, order[:, None, :], -1),
            res, sweeps)


def syevj(a, tol: float = 1e-7, max_sweeps: int = 20):
    """Jacobi symmetric eigensolver. Returns (w, v, residual, sweeps) —
    residual/sweeps ≙ cusolverDnXsyevjGetResidual/GetSweeps; w ascending,
    sweeps int32, one of each per matrix of a batch."""
    a = (a + a.mT) / 2
    w, v, res, sweeps = _syevj_batched(_batch(a), tol, max_sweeps)
    if a.ndim == 2:
        return w[0], v[0], res[0], sweeps[0]
    return _unbatch(a.shape[:-2], w, v, res, sweeps)


def syevj_batched(a, tol: float = 1e-7, max_sweeps: int = 20):
    """≙ cusolverDnSsyevjBatched."""
    return syevj(a, tol, max_sweeps)


def sygvj(a, b, tol: float = 1e-7, max_sweeps: int = 20):
    """Generalized Jacobi eigensolver (≙ sygvj): Cholesky reduction + syevj."""
    l = torch.linalg.cholesky(b)
    la = torch.linalg.solve_triangular(l, a, upper=False)
    c = torch.linalg.solve_triangular(l, la.mT, upper=False)
    w, y, res, sweeps = syevj(c, tol, max_sweeps)
    x = torch.linalg.solve_triangular(l.mT, y, upper=True)
    return w, x, res, sweeps


def _gesvdj_batched(a, tol, max_sweeps):
    """One-sided (Hestenes) Jacobi SVD of a (B, m, n) batch: orthogonalize
    the columns by right-rotations; S = column norms, U = normalized
    columns, V = product of rotations."""
    mrows, n0 = a.shape[-2:]
    check(mrows >= n0, "gesvdj expects m >= n (tall); pass aᵀ and swap u/v")
    n = n0 + (n0 % 2)
    if n != n0:
        # zero column decouples (gamma=0 → identity rotation), σ=0 at the end
        a = torch.nn.functional.pad(a, (0, 1))
    sched = torch.tensor(_round_robin(n0), device=a.device)
    norm = torch.linalg.matrix_norm(a)

    def one_round(mat, v, p, q):
        ap, aq = mat[:, :, p], mat[:, :, q]
        c, s = _sym_schur((ap * ap).sum(1), (aq * aq).sum(1), (ap * aq).sum(1))
        j = _rotation_matrix(n, p, q, c, s)
        with _f32_products():
            return mat @ j, v @ j

    def offdiag(mat):
        with _f32_products():
            g = mat.mT @ mat
        diag = torch.diagonal(g, dim1=-2, dim2=-1)
        return torch.sqrt(torch.clamp(_sum_in_order(g * g) - _sum_in_order(diag * diag), min=0.0))

    v0 = torch.eye(n, dtype=a.dtype, device=a.device).repeat(a.shape[0], 1, 1)
    mat, v, res, sweeps = _sweeps(a.clone(), v0, sched, one_round, offdiag,
                                  torch.full_like(norm, float("inf")),
                                  lambda r: r > (tol * norm) ** 2, max_sweeps)
    mat = mat[:, :, :n0]
    v = v[:, :n0, :n0]
    s = torch.linalg.vector_norm(mat, dim=1)
    order = torch.argsort(-s, dim=-1, stable=True)
    s = torch.take_along_dim(s, order, -1)
    u = torch.take_along_dim(mat, order[:, None, :], -1) / torch.clamp(s, min=1e-30)[:, None, :]
    v = torch.take_along_dim(v, order[:, None, :], -1)
    return u, s, v, torch.sqrt(res), sweeps


def gesvdj(a, tol: float = 1e-7, max_sweeps: int = 20):
    """One-sided Jacobi SVD (≙ cusolverDnXgesvdj). Returns
    (u, s, v, residual, sweeps); A = U diag(S) Vᵀ."""
    u, s, v, res, sweeps = _gesvdj_batched(_batch(a), tol, max_sweeps)
    if a.ndim == 2:
        return u[0], s[0], v[0], res[0], sweeps[0]
    return _unbatch(a.shape[:-2], u, s, v, res, sweeps)


def gesvdj_batched(a, tol: float = 1e-7, max_sweeps: int = 20):
    """≙ cusolverDnSgesvdjBatched."""
    return gesvdj(a, tol, max_sweeps)


def gesvda_strided_batched(a, rank: int | None = None, tol: float = 1e-7,
                           max_sweeps: int = 20):
    """≙ cusolverDnXgesvdaStridedBatched (approximate batched SVD): same
    engine, optionally truncated to ``rank``."""
    u, s, v, res, sweeps = gesvdj(a, tol, max_sweeps)
    if rank is not None:
        u, s, v = u[..., :, :rank], s[..., :rank], v[..., :, :rank]
    return u, s, v, res, sweeps
