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
- B1 (``csrc/gemm_epilogue.cu``, launched by ``dx.gemm._Into``) forms
  L21 = A21·inv(U11) (getrf) or A21·inv(L11)ᵀ (potrf), getrf's
  U12 = inv(L11)·A12, then block column j + 1 of A22 -= L21·U12 (L21·L21ᵀ),
  and only then the rest of A22 (potrf: the 3/4 of it that holds its lower
  triangle, in two products).
- Look-ahead: the diagonal block of step j + 1 factors on a second stream
  while the rest of step j's update runs (``_KernelOps``): the sweep is one
  block on one SM and the product fills the others.

Every product writes straight into its place: the factor is built in
``out`` while the updates run in ``work``, a copy of A, so no product
reads the block it writes apart from the update's own C. At n = 4096 that
is 32 sweeps and 123 (getrf) or 121 (potrf) B1 launches a call, with no
allocation or copy between them, all on raw addresses so that the host
keeps ahead of the card. The potrf's right-looking order beats the
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
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import _Into, _matmul_into_plain, _pallas_matmul_plain
from tpumathlib_torch.solver.blocked import (_check_block, _chol_inv128, _chol_inv128_plain,
                                             _launch_block)

_NB = 128     # diagonal block, and the width of a step
_P = 256      # n must be a multiple of the reference's panel


_mm_plain = functools.partial(_pallas_matmul_plain, out_dtype=torch.float32)


def _check_square(a) -> int:
    n = a.shape[0]
    check(a.shape == (n, n) and n % _P == 0,
          f"a square matrix with n % {_P} == 0, not {tuple(a.shape)}")
    return n


# An operand of the drivers' schedule: (t, r, c, rows, cols, transposed),
# the (rows, cols) block t[r:r + rows, c:c + cols] of a row-major f32
# matrix t, or with `transposed` the transpose of t[r:r + cols, c:c + rows].

def _view(op):
    t, r, c, rows, cols, transposed = op
    return t[r:r + cols, c:c + rows].mT if transposed else t[r:r + rows, c:c + cols]


class _PlainOps:
    """The plain route: views, ``torch.matmul`` and the plain sweep, each
    block where it stands in the schedule."""

    def __init__(self, sweep):
        self.sweep = sweep

    def mm(self, d, a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
        _matmul_into_plain(_view(d), _view(a), _view(b), None if c is None else _view(c),
                           alpha=alpha, beta=beta)

    def block(self, src, outs):
        for o, t in zip(outs, self.sweep(_view(src))):
            _view(o).copy_(t)

    def join(self):
        pass


class _KernelOps:
    """The kernel route: B1 (``dx.gemm._Into``) on the caller's stream and
    the block sweep ``entry`` (counted on ``wrapper``) on a second one, both
    on raw addresses into the call's buffers: a call makes some 125
    launches, and each view or stream lookup costs microseconds of host
    time. ``block`` runs after everything enqueued so far, so a diagonal
    block factors on one SM while the rest of the trailing update runs on
    the others (look-ahead); ``join`` makes the caller's stream wait for
    it. Without ``ahead`` the blocks run in order on the caller's stream.
    """

    def __init__(self, device, entry: str, wrapper, ahead: bool = True):
        self.gemm = _Into()
        self.sweep = getattr(self.gemm.lib, entry)
        self.entry, self.wrapper = entry, wrapper
        self.main = torch.cuda.current_stream(device)
        self.side = torch.cuda.Stream(device) if ahead else self.main
        self.main_h, self.side_h = self.main.cuda_stream, self.side.cuda_stream
        self.ready, self.done = torch.cuda.Event(), torch.cuda.Event()

    @staticmethod
    def _operand(op):
        t, r, c, _, _, transposed = op
        ld = t.stride(0)
        return t.data_ptr() + 4 * (r * ld + c), *((1, ld) if transposed else (ld, 1))

    def mm(self, d, a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
        # m, n, k: A's rows, B's columns, A's columns
        self.gemm(self.main_h, a[3], b[4], a[4], self._operand(d), self._operand(a),
                  self._operand(b), None if c is None else self._operand(c),
                  alpha=alpha, beta=beta)

    def block(self, src, outs):
        self.ready.record(self.main)
        self.side.wait_event(self.ready)
        args = [x for op in (src, *outs) for x in self._operand(op)[:2]]
        rc = self.sweep(*args, self.side_h)
        cuda_utils.check_launch(self.gemm.lib, rc, self.entry)
        self.wrapper.launches += 1
        self.done.record(self.side)

    def join(self):
        self.main.wait_event(self.done)


def _buffers(a, blocks: int, zero: bool):
    """The factorization's f32 copy of a (updated in place), the factor it
    builds (zeroed where ``zero``), and ``blocks`` (128, 128) scratch blocks
    for the inverses."""
    work = a.to(torch.float32).clone(memory_format=torch.contiguous_format)
    out = torch.zeros_like(work) if zero else torch.empty_like(work)
    return (work, out, *torch.empty((blocks, _NB, _NB), dtype=torch.float32, device=a.device))


def _potrf(a, ops):
    """Right-looking blocked Cholesky in 128-wide steps on ``ops``
    (``_PlainOps`` or ``_KernelOps``). Step j forms L21 = A21 · inv(L11)^T,
    updates block column j + 1 by L21 · L21[:128]^T, hands its diagonal
    block to the sweep, and only then updates the rest of the trailing
    matrix's lower part (3/4 of the square), so that the sweep can run
    beside those products. The factor's strict upper triangle stays 0."""
    n = a.shape[0]
    work, out, w0, w1 = _buffers(a, 2, zero=True)
    w = (w0, w1)

    def blk(t, r, c, rows, cols, tr=False):
        return (t, r, c, rows, cols, tr)

    ops.block(blk(work, 0, 0, _NB, _NB), (blk(out, 0, 0, _NB, _NB), blk(w0, 0, 0, _NB, _NB)))
    for step, j0 in enumerate(range(0, n - _NB, _NB)):
        j1, j2, t = j0 + _NB, j0 + 2 * _NB, n - j0 - _NB
        wj, wn = w[step % 2], w[(step + 1) % 2]
        l21 = blk(out, j1, j0, t, _NB)
        ops.join()
        ops.mm(l21, blk(work, j1, j0, t, _NB), blk(wj, 0, 0, _NB, _NB, True))
        ops.mm(blk(work, j1, j1, t, _NB), l21, blk(out, j1, j0, _NB, _NB, True),
               blk(work, j1, j1, t, _NB), alpha=-1.0, beta=1.0)
        ops.block(blk(work, j1, j1, _NB, _NB),
                  (blk(out, j1, j1, _NB, _NB), blk(wn, 0, 0, _NB, _NB)))
        # the rest of the trailing matrix's lower part, in two products: the
        # lower rows across its width, then the corner above them (the
        # block right of that corner is strictly upper and never read)
        t2 = t - _NB
        h = t2 // (2 * _NB) * _NB
        for r0, rows, cols in ((j2 + h, t2 - h, t2), (j2, h, h)):
            if rows:
                rest = blk(work, r0, j2, rows, cols)
                ops.mm(rest, blk(out, r0, j0, rows, _NB), blk(out, j2, j0, _NB, cols, True),
                       rest, alpha=-1.0, beta=1.0)
    ops.join()
    return out


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
