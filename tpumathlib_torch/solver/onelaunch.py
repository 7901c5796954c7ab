"""Blocked right-looking Cholesky and no-pivot LU of one large f32 matrix.

Counterpart of ``tpumathlib/solver/onelaunch.py``: ``potrf_onelaunch``
(kernel B2, ``_onelaunch_kernel`` ``:108``) and ``getrf_onelaunch`` (kernel
B3, ``_getrf_kernel`` ``:343``), with the reference's names and output
contract. The name "onelaunch" is kept so that call sites port one for one.

On the TPU each is one kernel that keeps an (n, 256) f32 column strip in
VMEM and walks the panels left-looking as a sequential grid, which saves
HBM traffic there. That strip is 4 MB at n=4096 and does not fit in an H100
block's 227 KB of shared memory, and left-looking products are narrow (a
256-column strip) or short (K = 256): they leave most of the 132 SMs idle.
So here the schedule is right-looking in 128-wide steps, a host loop whose
big products span the trailing matrix. Step j, with the diagonal block
A11, the column below it A21, the row right of it A12 and the trailing
block A22:

- one launch of ``csrc/dense_block.cu`` factors A11 and inverts its
  factors: ``tml_lu_inv_block`` ((L\\U, inv(L), inv(U)), ``_lu_inv128``) or
  ``tml_chol_inv_block`` ((L, inv(L)), ``blocked._chol_inv128``);
- B1 (its f32 route launched by ``dx.gemm._Into``: the 3xTF32 kernel of
  ``csrc/gemm_tf32x3.cu``, or SIMT for the small products) forms L21 =
  A21·inv(U11) (getrf) or A21·inv(L11)ᵀ (potrf), getrf's U12 =
  inv(L11)·A12, then block column j + 1 of A22 -= L21·U12 (L21·L21ᵀ), and
  only then the rest of A22 (potrf: the 3/4 of it that holds its lower
  triangle, in two products). The block that the updates read as B
  (potrf's L21, getrf's U12) is split into its TF32 planes once, when the
  first 3xTF32 product reads it (``blocked._KernelOps.split``).
- Look-ahead: the diagonal block of step j + 1 factors on a second stream
  while the rest of step j's update runs (``blocked._KernelOps``): the
  sweep is one block on one SM and the product fills the others.

The Cholesky is ``blocked._potrf``, the blocked factorizations' shared
schedule, at a panel of 128 (``potrf_blocked`` runs it at its own panel);
the ops (``_PlainOps``, ``_KernelOps``) live there too.

Every product writes straight into its place: the factor is built in
``out`` while the updates run in ``work``, a copy of A, so no product
reads the block it writes apart from the update's own C. At n = 4096 that
is 32 sweeps, 123 (getrf) or 121 (potrf) B1 launches (25 / 41 of them on
3xTF32) and 25 / 22 TF32 splits a call, with no copy between them and the
planes allocated once a call, all on raw addresses so that the host keeps
up with the card. The potrf's right-looking order beats the
left-looking one on the card (PERF.md §6).

``_inv_upper128`` (``tml_inv_upper_block``, ``csrc/qr_block.cu``) is the
standalone upper-triangular inverse that ``solver.qr_onelaunch`` uses.

CPU tensors take the plain versions beside them (``_potrf_onelaunch_plain``,
``_getrf_onelaunch_plain``): the same schedule with the reference's sweeps
as torch loops and the products as ``torch.matmul``, in order. CUDA
tensors launch the kernels or raise.
"""

from __future__ import annotations

import functools

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import _pallas_matmul_plain
from tpumathlib_torch.solver.blocked import (_buffers, _check_block, _chol_inv128,
                                             _chol_inv128_plain, _KernelOps, _launch_block,
                                             _PlainOps, _potrf)

_NB = 128     # diagonal block, and the width of a step
_P = 256      # n must be a multiple of the reference's panel


_mm_plain = functools.partial(_pallas_matmul_plain, out_dtype=torch.float32)


def _check_square(a) -> int:
    n = a.shape[0]
    check(a.shape == (n, n) and n % _P == 0,
          f"a square matrix with n % {_P} == 0, not {tuple(a.shape)}")
    return n


def _potrf_onelaunch_plain(a):
    return _potrf(a, _PlainOps(_chol_inv128_plain))


def potrf_onelaunch(a):
    """Cholesky factor (lower; strict upper triangle exactly 0) of one large
    f32 SPD matrix, read whole (both triangles). n must be a multiple of
    256. A non-SPD input gives a non-finite diagonal from the failing block
    on."""
    _check_square(a)
    if not on_cuda(a):
        return _potrf_onelaunch_plain(a)
    ops = _KernelOps(a.device, "tml_chol_inv_block", _chol_inv128)
    with torch.cuda.device(a.device):
        out = _potrf(a, ops)
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


def _getrf(a, ops):
    """Right-looking blocked no-pivot LU in 128-wide steps on ``ops``, as
    ``_potrf``: L21 = A21 · inv(U11), U12 = inv(L11) · A12, block column
    j + 1 -= L21 · U12[:, :128], its diagonal block to the sweep, then the
    rest of the trailing matrix -= L21 · U12[:, 128:]."""
    n = a.shape[0]
    work, out, wl0, wu0, wl1, wu1 = _buffers(a, 4, zero=False)
    inv = ((wl0, wu0), (wl1, wu1))

    def blk(t, r, c, rows, cols):
        return (t, r, c, rows, cols, False)

    def sq(t):
        return blk(t, 0, 0, _NB, _NB)

    ops.block(sq(work), (sq(out), sq(wl0), sq(wu0)))
    for step, j0 in enumerate(range(0, n - _NB, _NB)):
        j1, j2, t = j0 + _NB, j0 + 2 * _NB, n - j0 - _NB
        (wl, wu), (wl_n, wu_n) = inv[step % 2], inv[(step + 1) % 2]
        l21, u12 = blk(out, j1, j0, t, _NB), blk(out, j0, j1, _NB, t)
        ops.join()
        ops.mm(l21, blk(work, j1, j0, t, _NB), sq(wu))
        ops.mm(u12, sq(wl), blk(work, j0, j1, _NB, t))
        ops.split(u12)                         # U12, as the updates read it
        nxt = blk(work, j1, j1, t, _NB)
        ops.mm(nxt, l21, blk(out, j0, j1, _NB, _NB), nxt, alpha=-1.0, beta=1.0)
        ops.block(blk(work, j1, j1, _NB, _NB), (blk(out, j1, j1, _NB, _NB), sq(wl_n), sq(wu_n)))
        if j2 < n:
            rest = blk(work, j1, j2, t, t - _NB)
            ops.mm(rest, l21, blk(out, j0, j2, _NB, t - _NB), rest, alpha=-1.0, beta=1.0)
    ops.join()
    return out


def _getrf_onelaunch_plain(a):
    return _getrf(a, _PlainOps(_lu_inv128_plain))


def getrf_onelaunch(a):
    """No-pivot LU (compact L\\U, unit-lower L) of one large f32 matrix.
    n must be a multiple of 256. The caller owns the no-pivot validity
    contract (diagonal dominance), as in the reference."""
    _check_square(a)
    if not on_cuda(a):
        return _getrf_onelaunch_plain(a)
    ops = _KernelOps(a.device, "tml_lu_inv_block", _lu_inv128)
    with torch.cuda.device(a.device):
        out = _getrf(a, ops)
    getrf_onelaunch.launches += 1
    return out


getrf_onelaunch.launches = 0
