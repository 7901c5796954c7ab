"""Blocked left-looking Cholesky and no-pivot LU of one large f32 matrix.

Counterpart of ``tpumathlib/solver/onelaunch.py``: ``potrf_onelaunch``
(kernel B2, ``_onelaunch_kernel`` ``:108``) and ``getrf_onelaunch`` (kernel
B3, ``_getrf_kernel`` ``:343``), with the reference's names and output
contract. The name "onelaunch" is kept so that call sites port one for one.

On the TPU each is one kernel that keeps an (n, 256) f32 column strip in
VMEM and walks the 256-wide panels as a sequential grid. That strip is 4 MB
at n=4096 and does not fit in an H100 block's 227 KB of shared memory, so
here the grid becomes a host loop over the panels, the strip stays in device
memory, and each step is a kernel of the repository:

- every matrix product (the left-looking update of the strip, the trsm by
  the block inverse, the in-panel update, getrf's U rows) is
  ``dx.gemm.pallas_matmul`` (B1, ``csrc/gemm_epilogue.cu``) with
  ``alpha=-1, beta=1, c=...`` and strided or transposed views;
- each 128×128 diagonal block is one launch of ``csrc/dense_block.cu``:
  ``tml_chol_inv_block`` (``blocked._chol_inv128``) or ``tml_lu_inv_block``
  (``_lu_inv128``).

``_inv_upper128`` (``tml_inv_upper_block``, ``csrc/qr_block.cu``) is the
standalone upper-triangular inverse that ``solver.qr_onelaunch`` uses.

CPU tensors take the plain versions beside them (``_potrf_onelaunch_plain``,
``_getrf_onelaunch_plain``): the same blocked algorithm with the sweeps as
torch loops and the products as ``torch.matmul``. CUDA tensors launch the
kernels or raise.
"""

from __future__ import annotations

import functools

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import _pallas_matmul_plain, pallas_matmul
from tpumathlib_torch.solver.blocked import (_check_block, _chol_inv128, _chol_inv128_plain,
                                             _launch_block)

_NB = 128     # diagonal block of a sweep
_P = 256      # panel width

_mm_plain = functools.partial(_pallas_matmul_plain, out_dtype=torch.float32)


def _check_square(a) -> int:
    n = a.shape[0]
    check(a.shape == (n, n) and n % _P == 0,
          f"a square matrix with n % {_P} == 0, not {tuple(a.shape)}")
    return n


def _potrf(a, mm, chol_inv):
    """Left-looking blocked Cholesky; ``mm(a, b, c, alpha=, beta=)`` is the
    product and ``chol_inv`` the 128×128 sweep."""
    n = a.shape[0]
    out = a.to(torch.float32).clone(memory_format=torch.contiguous_format)
    for s0 in range(0, n, _P):
        p1 = s0 + _P
        if s0:   # A[s0:, strip] -= L[s0:, :s0] · L[strip, :s0]^T
            out[s0:, s0:p1] = mm(out[s0:, :s0], out[s0:p1, :s0].mT, out[s0:, s0:p1],
                                 alpha=-1.0, beta=1.0)
        for j0 in (s0, s0 + _NB):
            j1 = j0 + _NB
            l, w = chol_inv(out[j0:j1, j0:j1])
            out[j0:j1, j0:j1] = l
            if j1 < n:   # trsm: L21 = A21 · inv(L11)^T
                out[j1:, j0:j1] = mm(out[j1:, j0:j1], w.mT)
            if j1 < p1:  # in-panel update of the strip's second block column
                out[j0:j1, j1:p1] = 0.0
                out[j1:, j1:p1] = mm(out[j1:, j0:j1], out[j1:p1, j0:j1].mT, out[j1:, j1:p1],
                                     alpha=-1.0, beta=1.0)
        out[:s0, s0:p1] = 0.0
    return out


def _potrf_onelaunch_plain(a):
    return _potrf(a, _mm_plain, _chol_inv128_plain)


def potrf_onelaunch(a):
    """Cholesky factor (lower; strict upper triangle exactly 0) of one large
    f32 SPD matrix, read whole (both triangles). n must be a multiple of
    256. A non-SPD input gives a non-finite diagonal from the failing block
    on."""
    _check_square(a)
    if not on_cuda(a):
        return _potrf_onelaunch_plain(a)
    out = _potrf(a, pallas_matmul, _chol_inv128)
    potrf_onelaunch.launches += 1
    return out


potrf_onelaunch.launches = 0


# ---------------------------------------------------------------------------
# No-pivot LU: the 128×128 sweeps of the reference, then the blocked driver.

def _lu128(d):
    """No-pivot LU of a (128, 128) tile -> compact L\\U (multipliers below
    the diagonal, U on and above)."""
    d = d.to(torch.float32).clone()
    for j in range(d.shape[0]):
        m = d[j + 1:, j] / d[j, j]
        d[j + 1:, j + 1:] -= m[:, None] * d[j, j + 1:]
        d[j + 1:, j] = m
    return d


def _inv_unit_lower128(lu):
    """inv(unit-lower(lu)): W <- (I - m_k e_k^T) W in ASCENDING k (the
    descending order gives 2I - L)."""
    nb = lu.shape[0]
    w = torch.eye(nb, dtype=lu.dtype, device=lu.device)
    for k in range(nb - 1):
        w[k + 1:, :k + 1] -= lu[k + 1:, k:k + 1] * w[k, :k + 1]
    return w


def _inv_upper128_plain(u):
    """inv(upper(u)): column-scaled elementary factors, then the rows
    scaled by 1/U[k, k]. The strict lower part of u is not read."""
    nb = u.shape[0]
    dinv = 1.0 / torch.diagonal(u)
    w = torch.eye(nb, dtype=u.dtype, device=u.device)
    for k in range(nb - 1, 0, -1):
        w[:k, k:] -= (u[:k, k] * dinv[k])[:, None] * w[k, k:]
    return w * dinv[:, None]


def _inv_upper128(u):
    """inv(upper(u)) of a (128, 128) f32 block; its strict lower triangle is
    exactly 0, and a zero diagonal entry turns its row non-finite, as in the
    reference."""
    _check_block(u)
    if not on_cuda(u):
        return _inv_upper128_plain(u)
    (w,) = _launch_block("tml_inv_upper_block", u, 1)
    _inv_upper128.launches += 1
    return w


_inv_upper128.launches = 0


def _lu_inv128_plain(d):
    lu = _lu128(d)
    return lu, _inv_unit_lower128(lu), _inv_upper128_plain(lu)


def _lu_inv128(d):
    """(L\\U, inv(L), inv(U)) of a (128, 128) f32 block by no-pivot LU."""
    _check_block(d)
    if not on_cuda(d):
        return _lu_inv128_plain(d)
    lu, wl, wu = _launch_block("tml_lu_inv_block", d, 3)
    _lu_inv128.launches += 1
    return lu, wl, wu


_lu_inv128.launches = 0


def _getrf(a, mm, lu_inv):
    """Left-looking blocked no-pivot LU with a side buffer of per-panel
    inv(L) of the 256×256 diagonal block; products by ``mm``, sweeps by
    ``lu_inv``."""
    n = a.shape[0]
    out = a.to(torch.float32).clone(memory_format=torch.contiguous_format)
    inv = torch.empty((n, _P), dtype=torch.float32, device=a.device)
    for s0 in range(0, n, _P):
        p1 = s0 + _P
        for k0 in range(0, s0, _P):
            k1 = k0 + _P
            u = mm(inv[k0:k1], out[k0:k1, s0:p1])        # U rows of panel k
            out[k0:k1, s0:p1] = u
            out[k1:, s0:p1] = mm(out[k1:, k0:k1], u, out[k1:, s0:p1], alpha=-1.0, beta=1.0)
        wls = []
        for j0 in (s0, s0 + _NB):
            j1 = j0 + _NB
            lu, wl, wu = lu_inv(out[j0:j1, j0:j1])
            out[j0:j1, j0:j1] = lu
            wls.append(wl)
            if j1 < n:   # L21 = A21 · inv(U11)
                out[j1:, j0:j1] = mm(out[j1:, j0:j1], wu)
            if j1 < p1:  # U12 = inv(L11) · A12, then the in-panel update
                u12 = mm(wl, out[j0:j1, j1:p1])
                out[j0:j1, j1:p1] = u12
                out[j1:, j1:p1] = mm(out[j1:, j0:j1], u12, out[j1:, j1:p1],
                                     alpha=-1.0, beta=1.0)
        if p1 < n:   # inv of the unit-lower diagonal block: [[W1, 0], [-W2 L21 W1, W2]]
            w1, w2 = wls
            m1 = s0 + _NB
            inv[s0:m1, :_NB] = w1
            inv[s0:m1, _NB:] = 0.0
            inv[m1:p1, :_NB] = mm(w2, mm(out[m1:p1, s0:m1], w1), alpha=-1.0)
            inv[m1:p1, _NB:] = w2
    return out


def _getrf_onelaunch_plain(a):
    return _getrf(a, _mm_plain, _lu_inv128_plain)


def getrf_onelaunch(a):
    """No-pivot LU (compact L\\U, unit-lower L) of one large f32 matrix.
    n must be a multiple of 256. The caller owns the no-pivot validity
    contract (diagonal dominance), as in the reference."""
    _check_square(a)
    if not on_cuda(a):
        return _getrf_onelaunch_plain(a)
    out = _getrf(a, pallas_matmul, _lu_inv128)
    getrf_onelaunch.launches += 1
    return out


getrf_onelaunch.launches = 0
