"""The blocked-panel Cholesky (kernel B4c), the fused 128×128 Cholesky +
inverse sweep, and the right-looking schedule that the blocked
factorizations share.

Counterpart of ``tpumathlib/solver/blocked.py``: ``_chol_inv128`` (``:96``)
and ``potrf_blocked`` (``:203``, panel kernel ``_panel_kernel`` ``:128``).
On CUDA tensors ``_chol_inv128`` launches ``tml_chol_inv_block``
(``csrc/dense_block.cu``, which reaches the same factors in its own order);
on CPU tensors it takes ``_chol_inv128_plain``, the reference's sweep as a
torch loop.

The reference's panel kernel holds an (m, p) panel in VMEM and does, per
128-column block, the sweep, the trsm ``L21 = A21·inv(L11)ᵀ`` and the
in-panel update; between panels an XLA syrk in a 3-pass bf16 split updates
the trailing matrix. The panel is 4 MB at n = 4096 and does not fit in a
block's 227 KB of shared memory, so here the panel stays in device memory
and ``_potrf`` runs the same steps as a host loop of kernels: the sweep is
``tml_chol_inv_block`` and every product (trsm, in-panel update, trailing
syrk over the panel's K) is B1's f32 route launched on raw addresses
(``dx.gemm._Into``: the 3xTF32 tensor-core kernel, or SIMT for the small
ones), each written in place, the syrk on the lower part only; a block
column of L21 is split into its TF32 planes once, when the first 3xTF32
product reads it, and every later one takes those planes
(``_KernelOps.split``); the next diagonal block's sweep runs on a second
stream beside the products that do not need it (look-ahead). The bf16 split is a TPU
workaround, not part of the contract; B1 reads no TF32 setting (its 3xTF32
sum is the f32 product within f32's error whatever torch's flag says). With
``panel`` = 128 the same schedule is ``potrf_onelaunch``'s (kernel B2).
"""

from __future__ import annotations

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import _Into, _matmul_into_plain
from tpumathlib_torch.dx.tf32x3 import planes

_NB = 128


def _check_block(d) -> None:
    check(d.shape == (_NB, _NB) and d.dtype == torch.float32,
          f"a ({_NB}, {_NB}) f32 block, not {tuple(d.shape)} {d.dtype}")


def _chol_inv128_plain(d):
    """(L, W = inv(L)) of an SPD (128, 128) block: the reference's sweep in torch.

    Step j scales by rs = 1/sqrt(d[j, j]) (NaN for a negative pivot), updates
    the trailing block, and carries the inverse in ``r`` (W[i] = r[i]·rs_i).
    The rows of ``d`` hold L's columns, as the reference's U storage does."""
    d = d.to(torch.float32).clone()
    nb = d.shape[0]
    r = torch.eye(nb, dtype=d.dtype, device=d.device)
    rs = torch.empty(nb, dtype=d.dtype, device=d.device)
    for j in range(nb):
        s = 1.0 / torch.sqrt(d[j, j])
        rs[j] = s
        vc = (d[j + 1:, j] * s)[:, None]
        d[j + 1:, j + 1:] -= vc * (d[j, j + 1:] * s)
        r[j + 1:, :j + 1] -= vc * (r[j, :j + 1] * s)
    return torch.tril(d.T * rs), torch.tril(r * rs[:, None])


def _launch_block(entry: str, a, outs: int, extra=()) -> list:
    """Launch one 128×128 sweep of the kernel library on the current stream:
    ``entry(a, lda, out_1, ld_1, ..., out_outs, ld_outs, *extra, stream)``,
    with fresh (128, 128) f32 outputs, which it returns. Raises on a failed
    build, load or launch."""
    lib = cuda_utils.load_kernels()
    check(a.stride(-1) == 1, "the block needs unit column stride")
    res = [torch.empty((_NB, _NB), dtype=torch.float32, device=a.device) for _ in range(outs)]
    args = [a.data_ptr(), a.stride(0)]
    for t in res:
        args += [t.data_ptr(), t.stride(0)]
    with torch.cuda.device(a.device):
        rc = getattr(lib, entry)(*args, *(t.data_ptr() for t in extra),
                                 torch.cuda.current_stream(a.device).cuda_stream)
    cuda_utils.check_launch(lib, rc, entry)
    return res


def _chol_inv128(d):
    """Fused Cholesky + inverse of a (128, 128) f32 SPD block: (L, inv(L)),
    L lower with its strict upper triangle exactly 0. ``d`` is symmetric:
    the kernel reads its lower triangle, the plain version both."""
    _check_block(d)
    if not on_cuda(d):
        return _chol_inv128_plain(d)
    l, w = _launch_block("tml_chol_inv_block", d, 2)
    _chol_inv128.launches += 1
    return l, w


_chol_inv128.launches = 0


# ---------------------------------------------------------------------------
# The right-looking schedule of the blocked factorizations (this module's
# Cholesky; solver.onelaunch's Cholesky and no-pivot LU).
#
# An operand of the schedule: (t, r, c, rows, cols, transposed), the
# (rows, cols) block t[r:r + rows, c:c + cols] of a row-major f32 matrix t,
# or with `transposed` the transpose of t[r:r + cols, c:c + rows].

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

    def split(self, op):
        pass

    def block(self, src, outs):
        for o, t in zip(outs, self.sweep(_view(src))):
            _view(o).copy_(t)

    def join(self):
        pass


class _KernelOps:
    """The kernel route: B1 (``dx.gemm._Into``, the 3xTF32 kernel) on the
    caller's stream and the block sweep ``entry`` (counted on ``wrapper``)
    on a second one, both on raw addresses into the call's buffers: a call
    makes some 150 to 250 launches, and each view or stream lookup costs
    microseconds of host time. ``block`` runs after everything enqueued so
    far, so a diagonal block factors on one SM while the rest of the
    trailing update runs on the others (look-ahead); ``join`` makes the
    caller's stream wait for it. Without ``ahead`` the blocks run in order
    on the caller's stream.

    ``split`` declares a block that later products read as B: its TF32
    planes (the planes of their Bᵀ) go into planes of its whole matrix,
    made at the matrix's first split and kept for the call, when the first
    product on the 3xTF32 route reads it (the small ones take the SIMT
    route, ``dx.gemm._into_route``, and read B as it lies), once; a product
    whose B lies in a matrix with planes reads them there (the declared
    blocks must cover it, each starting where the one before ends, as the
    schedules' block columns do), any other B is split by ``_Into`` at its
    launch.
    """

    def __init__(self, device, entry: str, wrapper, ahead: bool = True):
        self.gemm = _Into(device)
        self.sweep = getattr(self.gemm.lib, entry)
        self.entry, self.wrapper = entry, wrapper
        self.main = torch.cuda.current_stream(device)
        self.side = torch.cuda.Stream(device) if ahead else self.main
        self.main_h, self.side_h = self.main.cuda_stream, self.side.cuda_stream
        self.ready, self.done = torch.cuda.Event(), torch.cuda.Event()
        self.bases = {}   # id of a matrix -> (address, row stride, the matrix kept alive)
        # (matrix address, transposed) -> (its planes, the declared blocks by
        # the first column of Bᵀ they hold in the planes: [first row, end row,
        # end column, the op, whether split])
        self.planes = {}

    def _operand(self, op):
        t, r, c, _, _, transposed = op
        base = self.bases.get(id(t))
        if base is None:   # the call's few matrices, looked up once
            base = self.bases[id(t)] = (t.data_ptr(), t.stride(0), t)
        ptr, ld, _ = base
        return ptr + 4 * (r * ld + c), *((1, ld) if transposed else (ld, 1))

    @staticmethod
    def _bt_region(op):
        """Bᵀ's (row, column, rows, columns) in the planes of op's matrix:
        the matrix's own coordinates for a transposed op (Bᵀ is a block of
        it), else its transpose's."""
        _, r, c, rows, cols, transposed = op
        return (r, c, cols, rows) if transposed else (c, r, cols, rows)

    def split(self, op):
        t = op[0]
        key = (t.data_ptr(), op[5])
        if key not in self.planes:
            shape = t.shape if op[5] else t.shape[::-1]
            self.planes[key] = (planes(*shape, t.device), {})
        r, c, rows, cols = self._bt_region(op)
        self.planes[key][1][c] = [r, r + rows, c + cols, op, False]

    def _bt(self, op):
        """Bᵀ's planes (hi, lo, row stride) where op's matrix has them, after
        splitting the declared blocks they lie in that are not split yet;
        else None."""
        found = self.planes.get((op[0].data_ptr(), op[5]))
        if found is None:
            return None
        p, blocks = found
        ld = p.stride(1)
        r, c, rows, cols = self._bt_region(op)
        col = c
        while col < c + cols:   # the declared blocks cover Bᵀ, one after another
            blk = blocks.get(col)
            check(blk is not None and blk[0] <= r and r + rows <= blk[1],
                  "B must lie in blocks declared by split")
            if not blk[4]:
                hi = p[0].data_ptr() + 4 * (blk[0] * ld + col)
                src = blk[3]
                self.gemm.split_bt(self.main_h, src[3], src[4], self._operand(src), hi,
                                   hi + 4 * p.stride(0), ld)
                blk[4] = True
            col = blk[2]
        hi = p[0].data_ptr() + 4 * (r * ld + c)
        return hi, hi + 4 * p.stride(0), ld

    def mm(self, d, a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
        # m, n, k: A's rows, B's columns, A's columns
        self.gemm(self.main_h, a[3], b[4], a[4], self._operand(d), self._operand(a),
                  self._operand(b), None if c is None else self._operand(c),
                  alpha=alpha, beta=beta, bt=lambda: self._bt(b))

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


def _potrf(a, ops, panel: int = _NB):
    """Right-looking blocked Cholesky on ``ops`` (``_PlainOps`` or
    ``_KernelOps``) by panels of ``panel`` columns (a multiple of 128; the
    last may be shorter), the factor built in ``out`` while the updates run
    in ``work``, a copy of A. Block j of a panel: its sweep gives L11 and W =
    inv(L11); L21 = A21 · Wᵀ; and, while the panel goes on, the next block
    column -= L21 · L21[:128]ᵀ, that block's sweep, then the panel's other
    columns. After a panel, the trailing syrk A22 -= L21 · L21ᵀ over the
    panel's width, on the lower part only: the next panel's first block
    column, its sweep (which runs beside what follows), the rest of the next
    panel's columns, then the columns past it in two products (the lower
    rows across their width, then the corner above them; the block right of
    that corner is strictly upper and never read). A next panel of more than
    one block takes the lower rows' product after its own second sweep, so
    that sweep too runs beside a product. With ``panel`` = 128 this is
    ``potrf_onelaunch``'s schedule, launch for launch. The factor's strict
    upper triangle stays 0."""
    n = a.shape[0]
    work, out, w0, w1 = _buffers(a, 2, zero=True)
    inv = (w0, w1)

    def blk(t, r, c, rows, cols, tr=False):
        return (t, r, c, rows, cols, tr)

    def w(j):   # the inverse of diagonal block j's factor, in turns
        return inv[j // _NB % 2]

    def sweep(j):
        ops.block(blk(work, j, j, _NB, _NB), (blk(out, j, j, _NB, _NB), blk(w(j), 0, 0, _NB, _NB)))

    def update(r0, c0, rows, cols, k0, width):
        """work[r0:r0 + rows, c0:c0 + cols] -= L[r0:, k0:k0 + width] · L[c0:, k0:k0 + width]ᵀ."""
        if rows and cols:
            d = blk(work, r0, c0, rows, cols)
            ops.mm(d, blk(out, r0, k0, rows, width), blk(out, c0, k0, width, cols, True), d,
                   alpha=-1.0, beta=1.0)

    sweep(0)
    deferred = None
    for s in range(0, n, panel):
        e = min(s + panel, n)                  # this panel's columns [s, e)
        for j in range(s, e, _NB):
            j1 = j + _NB
            if j1 == n:
                break
            ops.join()
            ops.mm(blk(out, j1, j, n - j1, _NB), blk(work, j1, j, n - j1, _NB),
                   blk(w(j), 0, 0, _NB, _NB, True))          # L21 = A21 · inv(L11)ᵀ
            ops.split(blk(out, j1, j, _NB, n - j1, True))     # L21ᵀ, as the updates read it
            if j1 < e:                         # in-panel update
                update(j1, j1, n - j1, _NB, j, _NB)
                sweep(j1)
                update(j1 + _NB, j1 + _NB, n - j1 - _NB, e - j1 - _NB, j, _NB)
                if deferred:
                    update(*deferred)
                    deferred = None
        if e < n:                              # trailing syrk over the panel's width
            e2 = min(e + panel, n)             # the next panel's columns [e, e2)
            update(e, e, n - e, _NB, s, e - s)
            sweep(e)
            update(e + _NB, e + _NB, n - e - _NB, e2 - e - _NB, s, e - s)
            t2 = n - e2
            h = t2 // (2 * _NB) * _NB
            lower = (e2 + h, e2, t2 - h, t2, s, e - s)
            if e2 - e > _NB:
                deferred = lower
            else:
                update(*lower)
            update(e2, e2, h, h, s, e - s)
    ops.join()
    return out


def _potrf_blocked_plain(a, panel: int = 256):
    return _potrf(a, _PlainOps(_chol_inv128_plain), panel)


def potrf_blocked(a, panel: int = 256):
    """Cholesky factor (lower; strict upper triangle exactly 0) of one large
    f32 SPD matrix, read whole (both triangles), by panels of ``panel``
    columns (the last may be shorter). n and ``panel`` must be multiples of
    128: the reference sweeps only whole 128-column blocks of a panel and
    leaves the rest of a panel of another width unfactored, with no error
    (ROADMAP C19), so the port refuses it. A non-SPD input gives non-finite
    values from the failing block on; there is no ``info``.

    On CUDA tensors (``_potrf`` on ``_KernelOps``) every 128-block sweep is
    one ``tml_chol_inv_block`` and every product one B1 launch into its
    place: at n = 4096, panel 256, 32 sweeps and 105 products."""
    n = a.shape[0]
    check(a.ndim == 2 and a.shape == (n, n) and n % _NB == 0,
          f"a square matrix with n % {_NB} == 0, not {tuple(a.shape)}")
    check(panel > 0 and panel % _NB == 0,
          f"panel must be a positive multiple of {_NB}, not {panel}")
    if not on_cuda(a):
        return _potrf_blocked_plain(a, panel)
    ops = _KernelOps(a.device, "tml_chol_inv_block", _chol_inv128)
    with torch.cuda.device(a.device):
        out = _potrf(a, ops, panel)
    potrf_blocked.launches += 1
    return out


potrf_blocked.launches = 0
