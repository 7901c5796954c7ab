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
only the sums run in another order. The kernels:

- the products that contract over the rows (BᵀB, Q1ᵀQ1, VᵀV, V0ᵀV1, Vᵀ·C,
  up to 4096 long) are ``tml_gram_tn`` (``csrc/qr_gram.cu``), which sums
  each output over 128-row chunks, a fresh f32 register a chunk, then the
  chunk sums in order, with K split across blocks where the output has
  few tiles: one f32 register along K = 4096 is an order of magnitude less
  accurate, and through the Gram matrices and T that put rel(Q·R − A) at
  n=4096 near the reference test's bound of 5e-5; its plain version
  (``_gram_tn_plain``) is a batched ``torch.matmul`` of the chunks and the
  sum of the partial products;
- orgqr's trailing product C −= V·W is the 3xTF32 tensor-core kernel
  (``csrc/gemm_tf32x3.cu``, ``dx/tf32x3.py``: V and Wᵀ split into TF32
  planes by ``tml_split_tf32``);
- every other product is B1's f32 SIMT kernel (``csrc/gemm_epilogue.cu``);
- the 128-step sweeps are ``tml_chol_inv_block`` (``blocked._chol_inv128``),
  ``tml_hh_recon_block`` (``_hh_recon128``: reconstruction and inv(M)) and
  ``tml_inv_upper_block`` (``onelaunch._inv_upper128``, for T).

``geqrf_onelaunch`` on CUDA tensors runs ``_DeviceQr``: every buffer
allocated once a call, every kernel launched on raw addresses into its
place (B1 through ``dx.gemm._Into``), the ridge and T's halved diagonal as
options of the Gram kernel; the unit-lower tops of V sit in scratch while
the rows below them are read from the output. The chain of sweeps and the
products they wait for run on one stream; the products that can wait run
on two others, started beside the sweeps (a sweep holds one SM, and they
run on the others). ``orgqr_onelaunch`` on CUDA tensors runs
``_DeviceOrgqr``: Q allocated once as the identity, one scratch allocation,
one split pass a call, four launches a panel on raw addresses (five where
W = T·G takes B1's 3xTF32 route and splits G) and no eager op in a panel.
The
block API (``_qr_block128``, ``_t_from_v``) takes the same kernels through
allocating wrappers (``dx.gemm.pallas_matmul``, ``_gram_tn``).

CPU tensors take the plain versions (``_geqrf_onelaunch_plain``,
``_orgqr_onelaunch_plain``): the same steps, with the sweeps as torch loops
and the products as ``torch.matmul``. CUDA tensors launch the kernels or
raise.

As in the reference, the panel basis is orthonormal to f32 precision only
while a block's condition number stays below about 4e3; above it R degrades
while staying finite, and ``info`` (``dense.xgeqrf``) flags only a
non-finite R.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils, tf32x3
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import _Into, pallas_matmul
from tpumathlib_torch.solver.blocked import (_NB, _check_block, _chol_inv128,
                                             _chol_inv128_plain, _launch_block)
from tpumathlib_torch.solver.onelaunch import (_P, _check_square, _inv_upper128,
                                               _inv_upper128_plain, _mm_plain)

F32 = torch.float32
_RIDGE = 3e-6   # G += (_RIDGE / 128 · tr(G) + 1e-30)·I before the first Cholesky
_CHUNK = 128    # rows of a partial product of the Gram products
_TILE = 64      # tml_gram_tn's output tile edge
_WORK_TILES = 264   # (64, 64) partial tiles a Gram work space holds: 2 blocks an SM
_HALF_DIAG, _ADD_RIDGE = 1, 2   # tml_gram_tn's flags


class _Ops(NamedTuple):
    """The products and the three sweeps one route runs."""
    mm: Callable
    gram: Callable
    chol_inv: Callable
    hh_recon: Callable
    inv_upper: Callable


def _ops(x) -> _Ops:
    """The kernels for a CUDA tensor, the plain versions for a CPU tensor
    (looked up at call time)."""
    if on_cuda(x):
        return _Ops(pallas_matmul, _gram_tn, _chol_inv128, _hh_recon128, _inv_upper128)
    return _plain_ops()


def _plain_ops() -> _Ops:
    return _Ops(_mm_plain, _gram_tn_plain, _chol_inv128_plain, _hh_recon128_plain,
                _inv_upper128_plain)


# ---------------------------------------------------------------------------
# The Gram product

def _gram_tn_plain(x, y):
    """xᵀ·y for x (k, m) and y (k, n) with k a multiple of 128: one batched
    product of the 128-row chunks, then the sum of the partial products."""
    chunks = (x.shape[0] // _CHUNK, _CHUNK)
    return _mm_plain(x.unflatten(0, chunks).mT, y.unflatten(0, chunks)).sum(dim=0)


def _split(top, rest, rows: int):
    """A Gram operand whose first ``rows`` rows are ``top`` (address, row
    stride) and whose later rows are those of ``rest`` (the address of its
    row 0, row stride): the C entry's (x, ldx, xtop, ldxt, xtop_rows)."""
    return (*rest, *top, rows)


class _Gram:
    """Launches of ``tml_gram_tn`` on one stream, with that stream's work
    space (``_WORK_TILES`` partial tiles) and tile counters (zero between
    launches: each launch's last blocks reset them), so that two streams'
    Gram products never share them. Operands are (address, row stride), or
    ``_split`` ones; ``d`` is written, never read unless it is ``c``."""

    def __init__(self, device, stream: int, tiles: int, work=None, counters=None):
        self.lib = cuda_utils.load_kernels()
        self.work = (torch.empty((_WORK_TILES, _TILE, _TILE), dtype=F32, device=device)
                     if work is None else work)
        self.counters = (torch.zeros(tiles + 1, dtype=torch.int32, device=device)
                         if counters is None else counters)
        self.args = (self.work.data_ptr(), _WORK_TILES, self.counters.data_ptr(), tiles + 1,
                     stream)

    def __call__(self, d, x, y, k: int, m: int, n: int, *, flags: int = 0, c=None,
                 alpha: float = 1.0, beta: float = 0.0):
        x = x if len(x) == 5 else (*x, None, 0, 0)
        y = y if len(y) == 5 else (*y, None, 0, 0)
        rc = self.lib.tml_gram_tn(*x, *y, *(c or (None, 0)), *d, k, m, n, alpha, beta,
                                  _RIDGE / _NB, flags, *self.args)
        cuda_utils.check_launch(self.lib, rc, "tml_gram_tn")
        _gram_tn.launches += 1


def _gram_layout(t):
    """t, or a copy of it, in the layout tml_gram_tn reads: unit column
    stride, a row stride of a multiple of 4 and a 16-byte aligned start."""
    if t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _gram_tn(x, y):
    """xᵀ·y in f32 for x (k, m) and y (k, n), k a multiple of 128, m and n
    of 64: one launch of ``tml_gram_tn`` (``_gram_tn_plain`` on CPU
    tensors)."""
    if not on_cuda(x, y):
        return _gram_tn_plain(x, y)
    (k, m), n = x.shape, y.shape[1]
    check(x.dtype == y.dtype == F32 and y.shape[0] == k and k % _CHUNK == 0 and k > 0
          and m % _TILE == 0 and n % _TILE == 0 and m and n,
          f"f32 operands (k, m) and (k, n) with k % {_CHUNK} == 0 and m, n % {_TILE} == 0, "
          f"not {tuple(x.shape)} {x.dtype} and {tuple(y.shape)} {y.dtype}")
    cuda_utils.load_kernels()   # a failed build raises before any stream lookup
    x, y = _gram_layout(x), _gram_layout(y)
    d = torch.empty((m, n), dtype=F32, device=x.device)
    with torch.cuda.device(x.device):
        gram = _Gram(x.device, torch.cuda.current_stream(x.device).cuda_stream,
                     (m // _TILE) * (n // _TILE))
        gram((d.data_ptr(), n), (x.data_ptr(), x.stride(0)), (y.data_ptr(), y.stride(0)),
             k, m, n)
    return d


_gram_tn.launches = 0


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
    g = ops.gram(b, b)                        # G = BᵀB, then the ridge
    g.diagonal().add_((_RIDGE / _NB) * g.diagonal().sum() + 1e-30)
    l1, w1 = ops.chol_inv(g)                     # G = L1 L1ᵀ, w1 = inv(L1)
    q1 = ops.mm(b, w1.mT)                        # Q1 = B inv(R1)
    l2, w2 = ops.chol_inv(ops.gram(q1, q1))
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
    s = ops.gram(vm, vm)
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
    128-blocks, each product and sweep allocating its result; returns (vr,
    t). The plain route's schedule; ``_DeviceQr`` takes the same steps on
    the card."""
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
                w = ops.mm(ts[0].mT, ops.gram(vms[0], blk))
                out[s0:, j0:j1] = ops.mm(vms[0], w, blk, alpha=-1.0, beta=1.0)
            v, v1, rd = _qr_block(out[j0:, j0:j1], 0, ops)
            vm = _unit_lower(v)                  # T and the in-panel update use v
            vms.append(vm)
            ts.append(_t_from_v(vm, ops))
            out[j0:j1, j0:j1] = torch.tril(v1, -1) + torch.triu(rd)   # the stored top is v1
            out[j1:, j0:j1] = v[_NB:]
        # panel T = [[T0, t01], [0, T1]], t01 = −T0·(V0ᵀV1)·T1 (V1 is zero above row s0+128)
        t0, t1 = ts
        v0v1 = ops.gram(vms[0][_NB:], vms[1])
        t[s0:s0 + _NB, :_NB] = t0
        t[s0:s0 + _NB, _NB:] = ops.mm(t0, ops.mm(v0v1, t1), alpha=-1.0)
        t[s0 + _NB:p1, _NB:] = t1
        if p1 < n:   # the trailing matrix, with V as later panels read it from storage
            vp = _unit_lower(out[s0:, s0:p1])
            c = out[s0:, p1:]
            w = ops.mm(t[s0:p1].mT, ops.gram(vp, c))
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
        w = ops.mm(t[k0:k0 + _P], ops.gram(vp, c))
        q[k0:, k0:] = ops.mm(vp, w, c, alpha=-1.0, beta=1.0)
    return q


def _n(op):
    """A row-major (address, row stride) as a B1 operand (address, row
    stride, column stride)."""
    return (*op, 1)


def _t(op):
    """The transpose of a row-major (address, row stride), as a B1 operand."""
    return op[0], 1, op[1]


class _Mat:
    """A row-major f32 matrix by its address and row stride."""

    __slots__ = ("ptr", "ld")

    def __init__(self, t):
        self.ptr, self.ld = t.data_ptr(), t.stride(0)

    def at(self, r: int = 0, c: int = 0):
        """(address, row stride) of element (r, c)."""
        return self.ptr + 4 * (r * self.ld + c), self.ld


# The scratch of a call: name -> shape (n for the order); one zeroed
# allocation, carved in this order. vtop: the unit-lower tops of a panel's two
# block V's (T and block 1's update read them); vptop: each panel's unit-lower
# 256 × 256 top of V, by panel parity (the side stream may still read the
# previous panel's); gb, g01, ga: the Gram products that the aux stream forms
# beside a T (block 1's update, t01, the next panel's update); wa: W = Tᵀ·G of
# the next panel's columns; gs, ws: the side stream's G and W.
_SCRATCH = {"g": (_NB, _NB), "l1": (_NB, _NB), "w1": (_NB, _NB), "l2": (_NB, _NB),
            "w2": (_NB, _NB), "l2d": (_NB, _NB), "minv": (_NB, _NB), "d": (_NB,),
            "gb": (_NB, _NB), "wb": (_NB, _NB), "g01": (_NB, _NB), "tmp": (_NB, _NB),
            "eye": (_NB, _NB), "vtop": (2 * _NB, _NB), "vptop": (2, _P, _P),
            "q1": ("n", _NB), "q": ("n", _NB), "x": ("n", _NB), "e1": ("n", _NB),
            "ga": (_P, _P), "wa": (_P, _P), "gs": (_P, "n"), "ws": (_P, "n")}


class _Lane:
    """A stream of ``_DeviceQr`` with its own Gram work space: B1 (``mm``)
    and Gram (``gram``) launches on it, and ``done``, an event re-recorded
    each time another lane waits for it."""

    def __init__(self, device, priority: int, tiles: int, scratch: int):
        self.stream = torch.cuda.Stream(device, priority=priority)
        self.h = self.stream.cuda_stream
        self.gemm = _Into(device, scratch)   # its own: B1's splits use its scratch
        self.gram = _Gram(device, self.h, tiles)
        self.done = torch.cuda.Event()

    def mm(self, *args, **kw):
        """One B1 launch: (m, n, k, d, a, b, c)."""
        self.gemm(self.h, *args, **kw)

    def waits_for(self, other: "_Lane | torch.cuda.Stream") -> None:
        """This lane waits for everything enqueued on ``other`` so far."""
        done = getattr(other, "done", None) or torch.cuda.Event()
        done.record(getattr(other, "stream", other))
        self.stream.wait_event(done)


class _DeviceQr:
    """``geqrf_onelaunch``'s kernel route: ``_geqrf``'s steps on one card,
    the same math per element, on raw addresses into buffers allocated once
    a call (the output, t and ``_SCRATCH``): B1 (``_Into``), the Gram
    product (``_Gram``) and the three sweeps, and three eager ops a block
    and two a panel (E1 − Q·D, the unit-lower top of V, L2·D; the panel's
    unit-lower V top). A block writes V straight into the output, whose top
    128 rows then take D·R over V1 (``hh_recon`` writes V1 into the panel's
    V top, and B1 adds it as C: D·R is exactly 0 below the diagonal and V1
    exactly 0 on and above it). The ridge and T's halved diagonal are
    options of the Gram kernel.

    Three streams. The chain (of high priority; the caller's stream waits
    for it at the end) runs every step that the next one waits for: each
    block's CholeskyQR2, reconstruction, V and T, block 1's update, t01, and
    the update of the next panel's first 128 columns. The aux stream (as
    high) forms the Gram products that do not need the T being built beside
    them (V0ᵀ·C of block 1's columns beside T0; V0ᵀV1 and Vᵀ·C of the next
    panel's columns beside T1). What the next panel does not need at once
    goes ``beside`` its sweeps (``plan``): the update of its second 128
    columns (aux) beside its first Cholesky sweep, and that of the columns
    past it (the side stream; look-ahead) in four pieces beside its two
    reconstructions and block 1's Cholesky sweeps, done before the panel
    after reads them. A sweep takes an SM's whole register file, so a wide
    product running when a sweep is launched holds it back; launched with
    the sweep, the product runs on the SMs the sweep leaves idle."""

    def __init__(self, a):
        lib = self.lib = cuda_utils.load_kernels()   # first: a failed build raises here
        n = self.n = a.shape[0]
        dev = a.device
        self.out = a.to(F32).clone(memory_format=torch.contiguous_format)
        self.t = torch.zeros((n, _P), dtype=F32, device=dev)
        shapes = {k: tuple(n if d == "n" else d for d in v) for k, v in _SCRATCH.items()}
        flat = torch.zeros(sum(torch.Size(s).numel() for s in shapes.values()), dtype=F32,
                           device=dev)
        self.s = dict(zip(shapes, (t.view(s) for t, s in zip(
            flat.split([torch.Size(s).numel() for s in shapes.values()]), shapes.values()))))
        s = self.s
        s["eye"].fill_diagonal_(1.0)
        s["e1"].fill_diagonal_(1.0)
        self.lower = torch.ones((_NB, _NB), dtype=torch.bool, device=dev).tril_(-1)
        self.vp_diag = [s["vptop"][i].diagonal() for i in range(2)]
        self.m = {k: _Mat(v.view(-1, v.shape[-1]) if v.ndim > 1 else v.view(1, -1))
                  for k, v in s.items()}
        self.vp = [_Mat(s["vptop"][i]) for i in range(2)]
        self.o, self.tm = _Mat(self.out), _Mat(self.t)
        self.caller = torch.cuda.current_stream(dev)
        # B1's largest split a lane: the planes of a (_P, n) B and of a 128 x 128 A
        scratch = 2 * (n + _NB) * _P
        self.chain = _Lane(dev, -1, (_P // _TILE) ** 2, scratch)
        self.aux = _Lane(dev, -1, (_P // _TILE) ** 2, scratch)
        self.side = _Lane(dev, 0, (_P // _TILE) * (n // _TILE), scratch)
        self.sweeps = {name: (getattr(lib, f"tml_{name}_block"), wrapper) for name, wrapper in (
            ("chol_inv", _chol_inv128), ("hh_recon", _hh_recon128), ("inv_upper", _inv_upper128))}

    def sweep(self, name: str, *ops, extra=(), beside: str = ""):
        """One 128 × 128 sweep on the chain, and the work that ``plan`` puts
        ``beside`` it: each piece's lane waits for the chain up to the
        sweep's launch, so that it starts with the sweep and runs on the SMs
        that the sweep leaves idle (a piece that ran into a sweep's launch
        would hold the SMs it needs: a sweep takes an SM's whole register
        file)."""
        for lane, work in self.plan.pop(beside, ()):
            lane.waits_for(self.chain)
            work()
        fn, wrapper = self.sweeps[name]
        rc = fn(*(x for op in ops for x in op), *extra, self.chain.h)
        cuda_utils.check_launch(self.lib, rc, f"tml_{name}_block")
        wrapper.launches += 1

    def block_v(self, s0: int, kb: int, par: int) -> None:
        """``_qr_block`` of block kb of the panel at s0: V into the output,
        its unit-lower top into ``vtop``, D·R over V1 on the output's top."""
        m_, s, o, chain = self.m, self.s, self.o, self.chain
        j0 = s0 + kb * _NB
        rows = self.n - j0
        b = o.at(j0, j0)
        g = m_["g"].at()
        chain.gram(g, b, b, rows, _NB, _NB, flags=_ADD_RIDGE)   # G = BᵀB + the ridge
        self.sweep("chol_inv", g, m_["l1"].at(), m_["w1"].at(), beside=f"{kb} chol 1")
        chain.mm(rows, _NB, _NB, _n(m_["q1"].at()), _n(b), _t(m_["w1"].at()))   # Q1 = B inv(R1)
        chain.gram(g, m_["q1"].at(), m_["q1"].at(), rows, _NB, _NB)
        self.sweep("chol_inv", g, m_["l2"].at(), m_["w2"].at(), beside=f"{kb} chol 2")
        chain.mm(rows, _NB, _NB, _n(m_["q"].at()), _n(m_["q1"].at()), _t(m_["w2"].at()))   # Q
        v1 = self.vp[par].at(kb * _NB, kb * _NB)
        self.sweep("hh_recon", m_["q"].at(), v1, m_["minv"].at(), extra=(m_["d"].ptr,),
                   beside=f"{kb} recon")
        torch.addcmul(s["e1"][:rows], s["q"][:rows], s["d"], value=-1.0,
                      out=s["x"][:rows])                                      # E1 − Q·D
        chain.mm(rows, _NB, _NB, _n(b), _n(m_["x"].at()), _n(m_["minv"].at()))   # V
        top = s["vtop"][kb * _NB:(kb + 1) * _NB]
        torch.where(self.lower, self.out[j0:j0 + _NB, j0:j0 + _NB], s["eye"], out=top)
        torch.mul(s["l2"], s["d"], out=s["l2d"])
        chain.mm(_NB, _NB, _NB, _n(b), _t(m_["l2d"].at()), _t(m_["l1"].at()), _n(v1),
                 beta=1.0)                                                    # D·R2·R1 + V1

    def block_t(self, s0: int, kb: int) -> None:
        """``_t_from_v`` of block kb: T⁻¹ from VᵀV, then T into t."""
        j0 = s0 + kb * _NB
        g, vm = self.m["g"].at(), _split(self.m["vtop"].at(kb * _NB), self.o.at(j0, j0), _NB)
        self.chain.gram(g, vm, vm, self.n - j0, _NB, _NB, flags=_HALF_DIAG)
        self.sweep("inv_upper", g, self.tm.at(j0, kb * _NB))

    def update_block1(self, s0: int) -> None:
        """Block 0's reflectors (Hᵀ) on rows s0: of block 1, from V0ᵀ·C (``gb``,
        formed on the aux stream beside T0)."""
        m_, o, chain = self.m, self.o, self.chain
        j0, rows = s0 + _NB, self.n - s0
        blk, below, wb = o.at(s0, j0), o.at(j0, j0), m_["wb"].at()
        chain.mm(_NB, _NB, _NB, _n(wb), _t(self.tm.at(s0)), _n(m_["gb"].at()))   # T0ᵀ·(V0ᵀ·C)
        chain.mm(_NB, _NB, _NB, _n(blk), _n(m_["vtop"].at()), _n(wb), _n(blk), alpha=-1.0,
                 beta=1.0)
        chain.mm(rows - _NB, _NB, _NB, _n(below), _n(o.at(j0, s0)), _n(wb), _n(below),
                 alpha=-1.0, beta=1.0)

    def gram_c(self, lane: _Lane, g, s0: int, par: int, c0: int, cols: int) -> None:
        """g = Vᵀ·out[s0:, c0:c0 + cols], V the panel's as later panels read
        it from storage: its unit-lower top in ``vptop``, its rows below in
        the output."""
        vp = _split(self.vp[par].at(), self.o.at(s0, s0), _P)
        lane.gram(g, vp, self.o.at(s0, c0), self.n - s0, _P, cols)

    def update_top(self, lane: _Lane, s0: int, par: int, c0: int, cols: int, w) -> None:
        """out[s0:s0 + 256, c0:c0 + cols] −= Vtop·W, Vtop the panel's
        unit-lower V top, ``w`` the (address, row stride) of W's first
        column."""
        c = self.o.at(s0, c0)
        lane.mm(_P, cols, _P, _n(c), _n(self.vp[par].at()), _n(w), _n(c), alpha=-1.0, beta=1.0)

    def update_below(self, lane: _Lane, s0: int, c0: int, cols: int, w) -> None:
        """out[s0 + 256:, c0:c0 + cols] −= V_below·W, V's rows below its top
        as the output holds them."""
        o, p1 = self.o, s0 + _P
        below = o.at(p1, c0)
        lane.mm(self.n - p1, cols, _P, _n(below), _n(o.at(p1, s0)), _n(w), _n(below),
                alpha=-1.0, beta=1.0)

    def run(self):
        self.chain.waits_for(self.caller)   # the input and the buffers
        with torch.cuda.stream(self.chain.stream):
            self.panels()
        for lane in (self.aux, self.side):
            self.chain.waits_for(lane)
        self.chain.done.record(self.chain.stream)
        self.caller.wait_event(self.chain.done)
        return self.out, self.t

    def panels(self) -> None:
        n, s, m_, o, tm = self.n, self.s, self.m, self.o, self.tm
        chain, aux, side = self.chain, self.aux, self.side
        self.plan = {}   # the next panel's work beside its sweeps: key -> [(lane, work)]
        for s0 in range(0, n, _P):
            par, p1, j1 = s0 // _P % 2, s0 + _P, s0 + _NB
            self.block_v(s0, 0, par)
            aux.waits_for(chain)   # V0ᵀ·C of block 1's columns, beside T0
            aux.gram(m_["gb"].at(), _split(m_["vtop"].at(), o.at(s0, s0), _NB), o.at(s0, j1),
                     n - s0, _NB, _NB)
            self.block_t(s0, 0)
            chain.waits_for(aux)
            self.update_block1(s0)
            self.block_v(s0, 1, par)
            # the panel's unit-lower V top: V1's in place (hh_recon), V0's rows below its top
            s["vptop"][par][_NB:, :_NB].copy_(self.out[j1:p1, s0:j1])
            self.vp_diag[par].fill_(1.0)
            aux.waits_for(chain)   # V0ᵀV1 and, once the side is done with them, Vᵀ·C of
            aux.gram(m_["g01"].at(), o.at(j1, s0),   # the next panel's columns, beside T1
                     _split(m_["vtop"].at(_NB), o.at(j1, j1), _NB), n - j1, _NB, _NB)
            if p1 < n:
                aux.waits_for(side)
                self.gram_c(aux, m_["ga"].at(), s0, par, p1, _P)
            self.block_t(s0, 1)
            chain.waits_for(aux)
            chain.mm(_NB, _NB, _NB, _n(m_["tmp"].at()), _n(m_["g01"].at()),
                     _n(tm.at(j1, _NB)))                                      # t01 = −T0·(V0ᵀV1)·T1
            chain.mm(_NB, _NB, _NB, _n(tm.at(s0, _NB)), _n(tm.at(s0)), _n(m_["tmp"].at()),
                     alpha=-1.0)
            if p1 == n:
                break
            # the next panel's columns: the first 128 now, the second beside the next
            # panel's first sweep (the aux stream); the columns past them on the side
            # stream, beside the next panel's sweeps, done before its Vᵀ·C
            wa = m_["wa"].at()
            chain.mm(_P, _P, _P, _n(wa), _t(tm.at(s0)), _n(m_["ga"].at()))   # W
            self.update_top(chain, s0, par, p1, _NB, wa)
            self.update_below(chain, s0, p1, _NB, wa)
            wa2 = m_["wa"].at(0, _NB)
            self.plan = {"0 chol 1": [(aux, partial(self.update_top, aux, s0, par, p1 + _NB,
                                                    _NB, wa2)),
                                      (aux, partial(self.update_below, aux, s0, p1 + _NB, _NB,
                                                    wa2))]}
            c0, cols = p1 + _P, n - p1 - _P
            if cols:
                ws = m_["ws"].at()
                self.plan |= {
                    "0 recon": [(side, partial(self.gram_c, side, m_["gs"].at(), s0, par, c0,
                                               cols))],
                    "1 chol 1": [(side, partial(side.mm, _P, cols, _P, _n(ws), _t(tm.at(s0)),
                                                _n(m_["gs"].at())))],
                    "1 chol 2": [(side, partial(self.update_top, side, s0, par, c0, cols, ws))],
                    "1 recon": [(side, partial(self.update_below, side, s0, c0, cols, ws))]}


class _DeviceOrgqr:
    """``orgqr_onelaunch``'s kernel route: ``_orgqr``'s steps on the
    caller's stream, device-paced: every launch on raw addresses into Q
    (allocated once, as the identity) and one scratch allocation a call.
    First, per call, one split pass writes the TF32 planes of all of vr read
    as unit lower triangular (``tml_split_tf32``): for the panel at k0 the
    planes' rows k0: of its 256 columns are Vp's, its top unit lower, with
    no copy; and two ops write every panel's unit-lower 256 × 256 top in f32
    into scratch (vr's diagonal blocks below their diagonal, then a unit
    diagonal). Then a panel k0 (from the last down), C = Q[k0:, k0:], is
    four launches (five with G's split) and no eager op:
    - G = Vpᵀ·C (``tml_gram_tn``: Vp's top from scratch, its rows below from
      vr, the split operand);
    - W = T·G (B1, ``_Into``: SIMT for the small panels by its size rule,
      else 3xTF32 after a split of G into its scratch);
    - the TF32 planes of Wᵀ (``tml_split_tf32``, transposed);
    - C −= Vp·W in place (``tml_gemm_tf32x3``, α = −1, β = 1, C = D).
    Each panel reads the last one's C, so the chain runs in order on one
    stream; its products span the trailing matrix and fill the card but in
    the first, small panels, where the host's launches set the pace."""

    def __init__(self, vr, t):
        n = self.n = vr.shape[0]
        dev = vr.device
        # loads the kernels first: a failed build raises here; its scratch
        # holds the planes of W = T·G's B, G (_P, n)
        self.gemm = _Into(dev, 2 * n * _P)
        self.tf32 = tf32x3.Tf32x3()
        # the launches read both as contiguous f32, as geqrf_onelaunch writes them
        self.vr = vr.to(F32).contiguous()
        self.t = t.to(F32).contiguous()
        self.q = torch.eye(n, dtype=F32, device=dev)
        tiles = (_P // _TILE) * (n // _TILE)
        sizes = {"v": (2, n, n), "tops": (n // _P, _P, _P), "g": (_P, n), "w": (_P, n),
                 "wt": (2, n, _P), "work": (_WORK_TILES, _TILE, _TILE), "counters": (tiles + 1,)}
        # every piece is written before it is read but the Gram's counters,
        # which start at zero
        flat = torch.empty(sum(torch.Size(v).numel() for v in sizes.values()), dtype=F32,
                           device=dev)
        self.s = dict(zip(sizes, (piece.view(shape) for piece, shape in zip(
            flat.split([torch.Size(v).numel() for v in sizes.values()]), sizes.values()))))
        self.s["counters"].zero_()
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.gram = _Gram(dev, self.stream, tiles, work=self.s["work"],
                          counters=self.s["counters"].view(torch.int32))

    def run(self):
        n, s, stream = self.n, self.s, self.stream
        q, vr, t = _Mat(self.q), _Mat(self.vr), _Mat(self.t)
        v, wt = s["v"], s["wt"]
        vh, vl = _Mat(v[0]), _Mat(v[1])
        self.tf32.split(stream, vr.at(), vh.ptr, vl.ptr, n, n, n, tf32x3.UNIT_LOWER)
        # every panel's diagonal block of vr, made unit lower triangular
        blocks = self.vr.as_strided((n // _P, _P, _P), (_P * (n + 1), n, 1))
        torch.tril(blocks, -1, out=s["tops"])
        s["tops"].diagonal(dim1=1, dim2=2).fill_(1.0)
        g, w = _Mat(s["g"]), _Mat(s["w"])
        wt_planes = (wt[0].data_ptr(), wt[1].data_ptr(), _P)
        for kb in range(n // _P - 1, -1, -1):
            k0 = kb * _P
            rows = n - k0
            c = q.at(k0, k0)
            vps = _split(_Mat(s["tops"][kb]).at(), vr.at(k0, k0), _P)
            self.gram(g.at(), vps, c, rows, _P, rows)                          # G = Vpᵀ·C
            self.gemm(stream, _P, rows, _P, _n(w.at()), _n(t.at(k0)), _n(g.at()))   # W = T·G
            self.tf32.split(stream, w.at(), *wt_planes, _P, rows, tf32x3.TRANSPOSE)
            vp_planes = (vh.at(k0, k0)[0], vl.at(k0, k0)[0], n)
            self.tf32.gemm(stream, rows, rows, _P, c, vp_planes, wt_planes, c, alpha=-1.0,
                           beta=1.0)                                           # C −= Vp·W
        return self.q


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
    route = _DeviceQr(a)
    with torch.cuda.device(a.device):
        out = route.run()
    geqrf_onelaunch.launches += 1
    return out


geqrf_onelaunch.launches = 0


def orgqr_onelaunch(vr, t):
    """The full square Q from geqrf_onelaunch's output."""
    n = _check_square(vr)
    check(tuple(t.shape) == (n, _P), f"t of shape ({n}, {_P}), not {tuple(t.shape)}")
    if not on_cuda(vr):
        return _orgqr_onelaunch_plain(vr, t)
    check(t.device == vr.device, f"t on {t.device}, vr on {vr.device}")
    route = _DeviceOrgqr(vr, t)
    with torch.cuda.device(vr.device):
        q = route.run()
    orgqr_onelaunch.launches += 1
    return q


orgqr_onelaunch.launches = 0


def qr_onelaunch(a):
    """(Q, R) of one large f32 square matrix through geqrf + orgqr."""
    vr, t = geqrf_onelaunch(a)
    return orgqr_onelaunch(vr, t), torch.triu(vr)
