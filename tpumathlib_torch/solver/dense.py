"""Dense factorizations and eigen/SVD drivers — the cuSOLVER 64-bit X-API.

Counterpart of ``tpumathlib/solver/dense.py`` apart from ``xgesvdp``,
``xgesvdr`` and ``xgeev``:

  cusolverDnXpotrf/potrs      → xpotrf / xpotrs
  cusolverDnXgetrf (+no-pivot)→ xgetrf(pivot=True/False) / xgetrs
  cusolverDnXgeqrf + orgqr/ormqr → xgeqrf / xorgqr / xormqr
  cusolverDnXtrtri            → xtrtri
  cusolverDnXsyevd/syevdx     → xsyevd / xsyevdx (index & value ranges)
  cusolverDnXsygvd            → xsygvd (A x = λ B x via Cholesky reduction)
  cusolverDnXgesvd            → xgesvd
  cusolverDnpotrfBatched      → potrf_batched

Every driver returns ``info`` as the reference does (0 = success; > 0 =
1-based index of the first non-finite diagonal entry or row).

Routing: a square 2-D f32 CUDA matrix with 2048 ≤ n ≤ 12288 and
n % 256 == 0 goes through the repository's kernels
(``solver.onelaunch``; for ``xgeqrf`` only up to n = 8192,
``solver.qr_onelaunch``), as the reference routes it to its Pallas kernels
on the TPU. Anything else takes torch's vendor path where the reference takes
XLA's, and the reference's unpivoted elimination for ``pivot=False``. The
eigen and SVD drivers are vendor paths in both packages (``torch.linalg``'s
eigh, eigvalsh, svd, svdvals and solve_triangular here; ``xgesvd`` asks
for cuSOLVER's gesvd driver on the card).
"""

from __future__ import annotations

import math

import torch

from tpumathlib_torch.blas.level2 import herm_full, sym_full
from tpumathlib_torch.core.errors import check
from tpumathlib_torch.fft.kernels import _f32_products
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
    """Apply Q (or Qᴴ) to C (≙ cusolverDnXormqr), f32 products pinned
    (ROADMAP C16)."""
    qt = q.mT.conj() if trans.upper() in ("T", "C") else q
    with _f32_products():
        return qt @ c if side.upper() == "L" else c @ qt


def xtrtri(a, uplo: str = "L", diag: str = "N"):
    """Triangular inverse. Returns (inv, info)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    inv = _solve_triangular(a, eye, lower=uplo.upper() == "L", unit=diag.upper() == "U")
    return inv, _finite_info(inv)


# ---------------- symmetric eigen ----------------

def _nan_where_not_finite(a, decompose, nan_outs):
    """``decompose(a)`` with the outputs flagged in ``nan_outs`` set to NaN for
    each matrix that holds a non-finite entry (which torch.linalg refuses,
    for the whole batch, where XLA returns NaN and the drivers' ``info``
    reports it). Such a matrix is decomposed as the identity."""
    bad = ~torch.isfinite(a).flatten(-2).all(-1)
    if not bool(bad.any()):
        return decompose(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    outs = decompose(torch.where(bad[..., None, None], eye, a))
    return tuple(torch.where(bad.reshape(bad.shape + (1,) * (o.ndim - bad.ndim)), math.nan, o)
                 if flag else o for o, flag in zip(outs, nan_outs))


def xsyevd(a, uplo: str = "L", vectors: bool = True):
    """Symmetric/Hermitian eigendecomposition (values ascending) from the
    ``uplo`` triangle. Returns (w, v, info); v=None when vectors=False
    (jobz=N). A matrix with a non-finite entry gets NaN values (its vectors
    stay finite) and info > 0."""
    af = (herm_full if a.is_complex() else sym_full)(a, uplo)
    if vectors:
        w, v = _nan_where_not_finite(af, torch.linalg.eigh, (True, False))
        return w, v, _finite_info(w[..., None])
    (w,) = _nan_where_not_finite(af, lambda m: (torch.linalg.eigvalsh(m),), (True,))
    return w, None, _finite_info(w[..., None])


def xsyevdx(a, uplo: str = "L", range_: str = "A",
            il: int = 0, iu: int | None = None,
            vl: float = -math.inf, vu: float = math.inf):
    """≙ cusolverDnXsyevdx: eigenvalue subset by index range (range_='I',
    0-based [il, iu]) or value interval (range_='V', (vl, vu]).

    Returns (w, v, n_found, info). For 'V', w/v are padded to n with NaN/0
    beyond n_found (static shapes, as the reference)."""
    w, v, info = xsyevd(a, uplo, vectors=True)
    if range_.upper() == "A":
        return w, v, w.shape[-1], info
    if range_.upper() == "I":
        iu = iu if iu is not None else w.shape[-1] - 1
        return w[..., il:iu + 1], v[..., :, il:iu + 1], iu - il + 1, info
    mask = (w > vl) & (w <= vu)
    n_found = mask.sum(-1)
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)  # found ones first
    w_sorted = torch.take_along_dim(torch.where(mask, w, math.nan), order, -1)
    v_sorted = torch.take_along_dim(v, order[..., None, :], -1)
    v_sorted = torch.where(w_sorted.isnan()[..., None, :], 0.0, v_sorted)
    return w_sorted, v_sorted, n_found, info


def xsygvd(a, b, uplo: str = "L", itype: int = 1):
    """Generalized symmetric-definite eigenproblem via Cholesky reduction
    (≙ cusolverDnXsygvd / sygvd sample). itype=1: A x = λ B x."""
    check(itype == 1, "itype 2/3 not implemented")
    l, info_b = xpotrf(b, uplo="L")
    # C = L⁻¹ A L⁻ᴴ
    la = _solve_triangular(l, a, lower=True)
    c = _solve_triangular(l, la.mT.conj(), lower=True)
    c = (c + c.mT.conj()) / 2
    w, y, info = xsyevd(c, uplo="L")
    # x = L⁻ᴴ y
    x = _solve_triangular(l.mT.conj(), y, lower=False)
    return w, x, info + info_b


# ---------------- SVD ----------------

def xgesvd(a, full_matrices: bool = False, vectors: bool = True):
    """SVD (≙ cusolverDnXgesvd). Returns (u, s, vh, info). A matrix with a
    non-finite entry gets NaN in all three and info > 0.

    On the card it asks for cuSOLVER's gesvd driver: torch's default there
    is gesvdj, which stops short at large n in f32 (a 4096² Gaussian matrix
    on an H100: s 5.0e-4 of the largest from float64 and U, V 2.3e-3 from
    orthogonal, where gesvd gives 3.0e-5 and 8.4e-5; ``chip_smoke.py``
    phase 22)."""
    driver = "gesvd" if a.is_cuda else None
    if vectors:
        u, s, vh = _nan_where_not_finite(
            a, lambda m: torch.linalg.svd(m, full_matrices=full_matrices, driver=driver),
            (True, True, True))
        return u, s, vh, _finite_info(s[..., None])
    (s,) = _nan_where_not_finite(a, lambda m: (torch.linalg.svdvals(m, driver=driver),), (True,))
    return None, s, None, _finite_info(s[..., None])
