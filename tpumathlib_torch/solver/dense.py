"""Dense Cholesky, LU, QR and triangular inverse — the cuSOLVER 64-bit X-API.

Counterpart of the Cholesky/LU/QR part of ``tpumathlib/solver/dense.py``:

  cusolverDnXpotrf/potrs      → xpotrf / xpotrs
  cusolverDnXgetrf (+no-pivot)→ xgetrf(pivot=True/False) / xgetrs
  cusolverDnXgeqrf + orgqr/ormqr → xgeqrf / xorgqr / xormqr
  cusolverDnXtrtri            → xtrtri
  cusolverDnpotrfBatched      → potrf_batched

Every driver returns ``info`` as the reference does (0 = success; > 0 =
1-based index of the first non-finite diagonal entry or row).

Routing: a square 2-D f32 CUDA matrix with 2048 ≤ n ≤ 12288 and
n % 256 == 0 goes through the repository's kernels
(``solver.onelaunch``; for ``xgeqrf`` only up to n = 8192,
``solver.qr_onelaunch``), as the reference routes it to its Pallas kernels
on the TPU. Anything else takes torch's vendor path where the reference takes
XLA's, and the reference's unpivoted elimination for ``pivot=False``.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.solver.onelaunch import getrf_onelaunch, potrf_onelaunch
from tpumathlib_torch.solver.qr_onelaunch import qr_onelaunch


def _finite_info(x, diag_only: bool = False) -> torch.Tensor:
    """info=0 when the result is finite, else the 1-based index of the first
    bad row (or diagonal entry), as int32 (≙ d_info)."""
    if diag_only:
        bad = ~torch.isfinite(torch.diagonal(x, dim1=-2, dim2=-1))
    else:
        bad = ~torch.isfinite(x).all(dim=-1)
    first = bad.to(torch.int32).argmax(dim=-1) + 1
    return torch.where(bad.any(dim=-1), first, 0).to(torch.int32)


def _use_onelaunch(a) -> bool:
    """Large single f32 factors of a CUDA tensor take the kernel route."""
    return (a.is_cuda and a.ndim == 2
            and a.dtype == torch.float32 and a.shape[0] == a.shape[1]
            and 2048 <= a.shape[0] <= 12288
            and a.shape[0] % 256 == 0)


def _cholesky(a):
    """Lower Cholesky factor; a matrix that is not SPD gives NaN on and below
    the diagonal, as XLA's cholesky does (torch.linalg.cholesky would raise)."""
    l, info = torch.linalg.cholesky_ex(a)
    failed = (info > 0)[..., None, None]
    return torch.where(failed, torch.full_like(l, float("nan")).tril(), l)


def xpotrf(a, uplo: str = "L"):
    """Cholesky: A = L Lᴴ (uplo=L) or Uᴴ U. Returns (factor, info)."""
    if _use_onelaunch(a):
        f = potrf_onelaunch(a)
        if uplo.upper() == "U":
            f = f.mT
        return f, _finite_info(f, diag_only=True)
    if uplo.upper() == "U":
        f = _cholesky(a.mT.conj()).mT.conj()
    else:
        f = _cholesky(a)
    return f, _finite_info(f, diag_only=True)


def _solve_triangular(t, b, lower: bool, unit: bool = False):
    vec = b.ndim == t.ndim - 1
    x = torch.linalg.solve_triangular(t, b[..., None] if vec else b, upper=not lower,
                                      unitriangular=unit)
    return x[..., 0] if vec else x


def xpotrs(factor, b, uplo: str = "L"):
    """Solve A X = B from the Cholesky factor."""
    if uplo.upper() == "L":
        y = _solve_triangular(factor, b, lower=True)
        return _solve_triangular(factor.mT.conj(), y, lower=False)
    y = _solve_triangular(factor.mT.conj(), b, lower=True)
    return _solve_triangular(factor, y, lower=False)


def potrf_batched(a, uplo: str = "L"):
    """≙ cusolverDnpotrfBatched — leading batch dims."""
    return xpotrf(a, uplo)


def _getrf_nopivot(a):
    """Unpivoted right-looking elimination (the reference's ``lax.scan``
    body), over any leading batch dims."""
    lu = a.clone()
    for k in range(a.shape[-1]):
        m = lu[..., k + 1:, k] / lu[..., k, k, None]
        lu[..., k + 1:, k + 1:] -= m[..., :, None] * lu[..., k, None, k + 1:]
        lu[..., k + 1:, k] = m
    return lu


def xgetrf(a, pivot: bool = True):
    """LU factorization. Returns (lu, piv, info); piv are 0-based LAPACK
    ipiv-style row swaps (P A = L U). pivot=False runs unpivoted
    elimination (valid for diagonally dominant input)."""
    n = a.shape[-1]
    if pivot:
        lu, piv, _ = torch.linalg.lu_factor_ex(a)
        return lu, piv - 1, _finite_info(lu, diag_only=True)
    lu = getrf_onelaunch(a) if _use_onelaunch(a) else _getrf_nopivot(a)
    piv = torch.arange(n, dtype=torch.int32, device=a.device).expand(a.shape[:-2] + (n,))
    return lu, piv, _finite_info(lu, diag_only=True)


def xgetrs(lu, piv, b):
    """Solve A X = B from xgetrf's output (0-based pivots)."""
    vec = b.ndim == lu.ndim - 1
    x = torch.linalg.lu_solve(lu, (piv + 1).to(torch.int32), b[..., None] if vec else b)
    return x[..., 0] if vec else x


def _use_qr_onelaunch(a) -> bool:
    """The QR route is the factorizations' route up to n = 8192."""
    return _use_onelaunch(a) and a.shape[0] <= 8192


def xgeqrf(a):
    """QR: returns (q, r, info) with Q explicit, as the reference does. On
    the kernel route a block with f32 condition above about 4e3 degrades R
    (finite); info flags only a non-finite diagonal of R, as in the
    reference, with no fallback."""
    if _use_qr_onelaunch(a):
        q, r = qr_onelaunch(a)
    else:
        q, r = torch.linalg.qr(a, mode="reduced")
    return q, r, _finite_info(r, diag_only=True)


def xorgqr(q, r=None):
    """≙ cusolverDnXorgqr: materialize Q (already explicit here)."""
    return q


def xormqr(q, c, side: str = "L", trans: str = "N"):
    """Apply Q (or Qᴴ) to C (≙ cusolverDnXormqr)."""
    qt = q.mT.conj() if trans.upper() in ("T", "C") else q
    return qt @ c if side.upper() == "L" else c @ qt


def xtrtri(a, uplo: str = "L", diag: str = "N"):
    """Triangular inverse. Returns (inv, info)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    inv = _solve_triangular(a, eye, lower=uplo.upper() == "L", unit=diag.upper() == "U")
    return inv, _finite_info(inv)
