"""Blocked Householder QR (geqrf) and its explicit Q (orgqr) of one large f32
matrix.

Counterpart of ``tpumathlib/solver/qr_onelaunch.py``: ``geqrf_onelaunch``
(kernel B4a, ``_geqrf_kernel`` ``:174``) and ``orgqr_onelaunch`` (kernel
B4b, ``_orgqr_kernel`` ``:345``), with the reference's names and output
contract: ``vr`` packs D·R on and above the diagonal over the Householder
vectors (unit diagonal implicit), ``t`` holds one (256, 256) compact-WY T
per 256-wide panel, and Q = H_0 H_1 ··· H_{K-1} with H = I − V T Vᵀ.

Each 128-column block is factored as the reference does it: CholeskyQR2
(G = BᵀB with a small relative ridge, two Cholesky + inverse sweeps), then
the Householder reconstruction E1 − Q·D = V·M (Ballard et al., IPDPS 2014),
then T from T⁻¹ = strict_upper(VᵀV) + diag(VᵀV)/2.

On the TPU each of geqrf and orgqr is one kernel that keeps an (n, 256)
strip and an (n, 128) workspace in VMEM and walks the panels left-looking,
because only one strip fits there. On the card the strip stays in device
memory, the panel grid is a host loop, and the loop order is right-looking:
after panel s is factored, the trailing matrix takes its update once,
C −= V·(Tᵀ·(Vᵀ·C)); orgqr builds Q on trailing blocks as LAPACK's sorgqr
does, Q[k0:, k0:] = H_kb·Q[k0:, k0:] for kb from the last panel down. Every
column meets the same reflectors in the same order as in the reference;
only the sums run in another order. Each step is a kernel of the
repository:

- every matrix product is ``dx.gemm.pallas_matmul`` (B1,
  ``csrc/gemm_epilogue.cu``), over the rows j0: of a block only, with
  transposed views and ``alpha=-1, beta=1, c=...`` where it subtracts.
  The products that contract over the rows (BᵀB, VᵀV, Vᵀ·C, up to 4096
  long) run as one batched launch over 128-row chunks whose partial
  products are summed afterwards (``_mm_tn``): B1 sums each output in one
  f32 register along K, which at K = 4096 is an order of magnitude less
  accurate than a blocked sum, and through the Gram matrices and T that
  put rel(Q·R − A) at n=4096 near the reference test's bound of 5e-5;
- the 128-step sweeps are ``tml_chol_inv_block`` (``blocked._chol_inv128``),
  ``tml_hh_recon_block`` (``_hh_recon128``: reconstruction and inv(M)) and
  ``tml_inv_upper_block`` (``onelaunch._inv_upper128``, for T).

CPU tensors take the plain versions (``_geqrf_onelaunch_plain``,
``_orgqr_onelaunch_plain``): the same schedule, with the sweeps as torch
loops and the products as ``torch.matmul``. CUDA tensors launch the kernels
or raise.

As in the reference, the panel basis is orthonormal to f32 precision only
while a block's condition number stays below about 4e3; above it R degrades
while staying finite, and ``info`` (``dense.xgeqrf``) flags only a
non-finite R.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import pallas_matmul
from tpumathlib_torch.solver.blocked import (_NB, _check_block, _chol_inv128,
                                             _chol_inv128_plain, _launch_block)
from tpumathlib_torch.solver.onelaunch import (_P, _check_square, _inv_upper128,
                                               _inv_upper128_plain, _mm_plain)

_RIDGE = 3e-6   # G += (_RIDGE / 128 · tr(G) + 1e-30)·I before the first Cholesky
_CHUNK = 128    # rows per partial product of _mm_tn


class _Ops(NamedTuple):
    """The product and the three sweeps one route runs."""
    mm: Callable
    chol_inv: Callable
    hh_recon: Callable
    inv_upper: Callable


def _ops(x) -> _Ops:
    """The kernels for a CUDA tensor, the plain versions for a CPU tensor
    (looked up at call time)."""
    if on_cuda(x):
        return _Ops(pallas_matmul, _chol_inv128, _hh_recon128, _inv_upper128)
    return _plain_ops()


def _plain_ops() -> _Ops:
    return _Ops(_mm_plain, _chol_inv128_plain, _hh_recon128_plain, _inv_upper128_plain)


def _mm_tn(ops: _Ops, x, y):
    """xᵀ·y for x (k, m) and y (k, n) with k a multiple of 128: one batched
    product of the 128-row chunks, then the sum of the partial products."""
    chunks = (x.shape[0] // _CHUNK, _CHUNK)
    return ops.mm(x.unflatten(0, chunks).mT, y.unflatten(0, chunks)).sum(dim=0)


# ---------------------------------------------------------------------------
# The 128×128 reconstruction sweep

def _hh_recon128_plain(qtop):
    """(v1, d, inv(M)) from rows j0 .. j0+127 of an orthonormal panel basis:
    the reference's elimination of E1 − Q·D (``qr_onelaunch.py:137-153``),
    restricted to the entries that later steps read, then the inverse of
    M = upper(Ea − Qa·D). v1 holds the multipliers below the diagonal and
    exact zeros elsewhere; d the 128 signs."""
    nb = qtop.shape[0]
    ea = torch.eye(nb, dtype=torch.float32, device=qtop.device)
    qa = qtop.to(torch.float32).clone()
    v1 = torch.zeros_like(ea)
    d = torch.empty(nb, dtype=torch.float32, device=qtop.device)
    for j in range(nb):
        dj = torch.where(ea[j, j] * qa[j, j] > 0, -1.0, 1.0)
        mult = (ea[j + 1:, j] - dj * qa[j + 1:, j]) / (ea[j, j] - dj * qa[j, j])
        ea[j + 1:, j + 1:] -= mult[:, None] * ea[j, j + 1:]
        qa[j + 1:, j + 1:] -= mult[:, None] * qa[j, j + 1:]
        v1[j + 1:, j] = mult
        d[j] = dj
    return v1, d, _inv_upper128_plain(torch.triu(ea - qa * d))


def _hh_recon128(qtop):
    """Householder reconstruction of one (128, 128) f32 block of a panel
    basis: (v1, d, inv(M)); see ``_hh_recon128_plain``."""
    _check_block(qtop)
    if not on_cuda(qtop):
        return _hh_recon128_plain(qtop)
    d = torch.empty(_NB, dtype=torch.float32, device=qtop.device)
    v1, minv = _launch_block("tml_hh_recon_block", qtop, 2, extra=(d,))
    _hh_recon128.launches += 1
    return v1, d, minv


_hh_recon128.launches = 0


# ---------------------------------------------------------------------------
# One panel block, and T

def _qr_block(bm, j0: int, ops: _Ops):
    b = bm[j0:]
    g = _mm_tn(ops, b, b)                        # G = BᵀB, then the ridge
    g.diagonal().add_((_RIDGE / _NB) * g.diagonal().sum() + 1e-30)
    l1, w1 = ops.chol_inv(g)                     # G = L1 L1ᵀ, w1 = inv(L1)
    q1 = ops.mm(b, w1.mT)                        # Q1 = B inv(R1)
    l2, w2 = ops.chol_inv(_mm_tn(ops, q1, q1))
    q = ops.mm(q1, w2.mT)                        # the orthonormal panel basis
    r = ops.mm(l2.mT, l1.mT)                     # R = R2 R1
    v1, d, minv = ops.hh_recon(q[:_NB])
    x = q * -d                                   # E1 − Q·D
    x[:_NB].diagonal().add_(1.0)
    v = ops.mm(x, minv)                          # V = (E1 − Q·D)·inv(M)
    if j0:
        v = torch.cat((v.new_zeros((j0, _NB)), v))
    return v, v1, r * d[:, None]


def _qr_block128(bm, j0: int):
    """CholeskyQR2 + Householder reconstruction of one (m, 128) panel block
    whose diagonal block starts at row j0, with m − j0 a multiple of 128
    (rows above j0 are not read; the reference takes the mask ``e1mask`` in
    place of j0). Every product runs over the rows j0: only.

    Returns (v, v1, rd) as the reference does: v (m, 128), the Householder
    vectors (zero above j0; its top block is overwritten by the caller's
    packing), v1 the exact (128, 128) multipliers of the reconstruction, and
    rd the upper-triangular D·R rows."""
    return _qr_block(bm, j0, _ops(bm))


def _qr_block128_plain(bm, j0: int):
    return _qr_block(bm, j0, _plain_ops())


def _t_from_v(vm, ops: _Ops | None = None):
    """Compact-WY T of a masked V (unit diagonal, zeros above it) from the
    orthogonality identity T⁻¹ = strict_upper(S) + diag(S)/2, S = VᵀV."""
    ops = ops or _ops(vm)
    s = _mm_tn(ops, vm, vm)
    s.diagonal().mul_(0.5)
    return ops.inv_upper(s)


def _unit_lower(v):
    """A copy of v whose top (w, w) block, w = v.shape[1], is made unit lower
    triangular: the masked V of a block or a panel."""
    w = v.shape[1]
    out = v.clone()
    top = out[:w]
    top.copy_(torch.tril(top, -1))
    top.diagonal().fill_(1.0)
    return out


# ---------------------------------------------------------------------------
# The drivers

def _geqrf(a, ops: _Ops):
    """Right-looking blocked Householder QR over 256-wide panels of two
    128-blocks; returns (vr, t)."""
    n = a.shape[0]
    out = a.to(torch.float32).clone(memory_format=torch.contiguous_format)
    t = torch.zeros((n, _P), dtype=torch.float32, device=a.device)
    for s0 in range(0, n, _P):
        p1 = s0 + _P
        vms, ts = [], []
        for j0 in (s0, s0 + _NB):
            j1 = j0 + _NB
            if vms:   # block 0's reflectors (Hᵀ) on rows s0: of block 1; rows s0..j0-1 become R01
                blk = out[s0:, j0:j1]
                w = ops.mm(ts[0].mT, _mm_tn(ops, vms[0], blk))
                out[s0:, j0:j1] = ops.mm(vms[0], w, blk, alpha=-1.0, beta=1.0)
            v, v1, rd = _qr_block(out[j0:, j0:j1], 0, ops)
            vm = _unit_lower(v)                  # T and the in-panel update use v
            vms.append(vm)
            ts.append(_t_from_v(vm, ops))
            out[j0:j1, j0:j1] = torch.tril(v1, -1) + torch.triu(rd)   # the stored top is v1
            out[j1:, j0:j1] = v[_NB:]
        # panel T = [[T0, t01], [0, T1]], t01 = −T0·(V0ᵀV1)·T1 (V1 is zero above row s0+128)
        t0, t1 = ts
        v0v1 = _mm_tn(ops, vms[0][_NB:], vms[1])
        t[s0:s0 + _NB, :_NB] = t0
        t[s0:s0 + _NB, _NB:] = ops.mm(t0, ops.mm(v0v1, t1), alpha=-1.0)
        t[s0 + _NB:p1, _NB:] = t1
        if p1 < n:   # the trailing matrix, with V as later panels read it from storage
            vp = _unit_lower(out[s0:, s0:p1])
            c = out[s0:, p1:]
            w = ops.mm(t[s0:p1].mT, _mm_tn(ops, vp, c))
            out[s0:, p1:] = ops.mm(vp, w, c, alpha=-1.0, beta=1.0)
    return out, t


def _orgqr(vr, t, ops: _Ops):
    """Q = H_0 ··· H_{K-1}·I on trailing blocks: H_kb touches rows and
    columns k0: only, since the columns left of k0 are still unit vectors
    there."""
    n = vr.shape[0]
    q = torch.eye(n, dtype=torch.float32, device=vr.device)
    for k0 in range(n - _P, -1, -_P):
        vp = _unit_lower(vr[k0:, k0:k0 + _P])
        c = q[k0:, k0:]
        w = ops.mm(t[k0:k0 + _P], _mm_tn(ops, vp, c))
        q[k0:, k0:] = ops.mm(vp, w, c, alpha=-1.0, beta=1.0)
    return q


def _geqrf_onelaunch_plain(a):
    return _geqrf(a, _plain_ops())


def _orgqr_onelaunch_plain(vr, t):
    return _orgqr(vr, t, _plain_ops())


def geqrf_onelaunch(a):
    """Compact V\\R Householder QR of one large f32 square matrix; returns
    (vr, t): vr packs R with sign-adjusted rows on and above the diagonal
    over the Householder vectors (unit diagonal implicit), t the per-panel
    (256, 256) compact-WY T blocks. n must be a multiple of 256."""
    _check_square(a)
    if not on_cuda(a):
        return _geqrf_onelaunch_plain(a)
    out = _geqrf(a, _ops(a))
    geqrf_onelaunch.launches += 1
    return out


geqrf_onelaunch.launches = 0


def orgqr_onelaunch(vr, t):
    """The full square Q from geqrf_onelaunch's output."""
    n = _check_square(vr)
    check(tuple(t.shape) == (n, _P), f"t of shape ({n}, {_P}), not {tuple(t.shape)}")
    if not on_cuda(vr):
        return _orgqr_onelaunch_plain(vr, t)
    q = _orgqr(vr, t, _ops(vr))
    orgqr_onelaunch.launches += 1
    return q


orgqr_onelaunch.launches = 0


def qr_onelaunch(a):
    """(Q, R) of one large f32 square matrix through geqrf + orgqr."""
    vr, t = geqrf_onelaunch(a)
    return orgqr_onelaunch(vr, t), torch.triu(vr)
