"""3xTF32 products of f32 matrices on the tensor cores (``csrc/gemm_tf32x3.cu``).

The card's tensor cores take f32 operands only as TF32 (10 mantissa bits),
some 1e-4 off an f32 product at K = 4096. Split into two TF32 planes, hi =
rna(x) and lo = rna(x − hi), an operand is carried to about 2⁻²² of
itself, and hi·hi + hi·lo + lo·hi summed in f32 is the f32 product within
f32's own error (the dropped lo·lo is 2⁻²² of it). Two kernels:

- ``tml_split_tf32`` writes the planes of an f32 matrix (``split_tf32``),
  optionally transposed, optionally with the matrix's top square block
  read as unit lower triangular (a masked V of Householder vectors);
- ``tml_gemm_tf32x3`` computes D = α·A·B + β·C from the planes of Bᵀ (n,
  k) and either the planes of A (m, k) or, where TMA reads A in place
  (``tma_ready``), A itself in f32, split in the kernel's registers; all
  K-major (wgmma reads TF32 operands only so); on B1's TMA + wgmma ring,
  128 × 128 tiles, each stage's products summed apart and then added in
  f32 (the tensor cores' own additions do not round to nearest); C and D
  f32, C may be D (``gemm_tf32x3``).

They replace no TPU kernel: they are the f32 product of the Mp ring GEMM
(B12a, B12b; ``mp/overlap.py``) and of B4b's trailing update
(``solver/qr_onelaunch.py::_DeviceOrgqr``). Host loops launch them on raw
addresses through ``Tf32x3``; ``split_tf32`` and ``gemm_tf32x3`` are the
tensor-level wrappers. On CPU tensors they take the plain versions
(``_split_tf32_plain``: the rounding by integer bit operations, bit-equal
to ``cvt.rna.tf32.f32``; ``_gemm_tf32x3_plain``: the three products in f32);
on CUDA tensors they launch or raise. Counts: ``split_tf32.launches`` and
``gemm_tf32x3.launches``, one a launch whoever launches.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.core.dtypes import cdiv
from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda

F32 = torch.float32
TRANSPOSE, UNIT_LOWER = 1, 2   # tml_split_tf32's flags


def _rna_tf32(x):
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as f32 words: half a TF32 unit added to the magnitude's
    bits, then the low 13 bits cleared (the sign bit is apart, so this
    rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def _unit_lower_top(x):
    """A copy of x whose top (w, w) block, w = x.shape[1], is unit lower
    triangular."""
    w = x.shape[1]
    out = x.clone()
    top = out[:w]
    top.copy_(torch.tril(top, -1))
    top.diagonal().fill_(1.0)
    return out


def _split_tf32_plain(x, *, transpose: bool = False, unit_lower: bool = False):
    """(hi, lo) of f32 x (its transpose with ``transpose``; its top square
    block made unit lower first with ``unit_lower``): hi = rna(x), lo =
    rna(x − hi), x − hi exact in f32."""
    x = x.to(F32)
    if unit_lower:
        x = _unit_lower_top(x)
    if transpose:
        x = x.mT
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def _gemm_tf32x3_plain(a_hi, a_lo, bt_hi, bt_lo, c=None, *, alpha: float = 1.0,
                       beta: float = 0.0):
    """The kernel's sum by torch.matmul in f32 (TF32 off): α·(lo·hi + hi·lo +
    hi·hi) + β·C, A's planes (m, k), Bᵀ's (n, k)."""
    from tpumathlib_torch.fft.kernels import _f32_products   # fft imports dx, and dx.gemm this

    with _f32_products():
        acc = a_lo @ bt_hi.mT + a_hi @ bt_lo.mT + a_hi @ bt_hi.mT
    acc = alpha * acc
    return acc if c is None else acc + beta * c


def tma_ready(t) -> bool:
    """Whether the kernel reads the f32 matrix ``t`` (rows, cols) in place
    as A, splitting it in registers: unit column stride, a row stride of a
    multiple of 4 (16 bytes) that covers a row, and a 16-byte aligned
    base."""
    return (t.stride(1) == 1 and t.stride(0) % 4 == 0 and t.stride(0) >= t.shape[1]
            and t.data_ptr() % 16 == 0)


def planes(rows: int, cols: int, device):
    """Two f32 planes (2, rows, cols) in one allocation, their row stride
    rounded up to 4 (16 bytes, TMA's pitch)."""
    return torch.empty((2, rows, cdiv(max(cols, 1), 4) * 4), dtype=F32, device=device)[..., :cols]


class Tf32x3:
    """Launches of ``tml_split_tf32`` and ``tml_gemm_tf32x3`` on raw
    addresses for host loops: a launch allocates nothing. Matrices are
    (address, row stride) in elements; plane pairs (hi, lo, row stride)."""

    def __init__(self):
        self.lib = cuda_utils.load_kernels()

    def split(self, stream: int, x, hi: int, lo: int, ldo: int, rows: int, cols: int,
              flags: int = 0) -> None:
        """hi, lo = the planes of x (rows, cols); (cols, rows) with TRANSPOSE."""
        rc = self.lib.tml_split_tf32(x[0], x[1], hi, lo, ldo, rows, cols, flags, stream)
        cuda_utils.check_launch(self.lib, rc, "tml_split_tf32")
        split_tf32.launches += 1

    def gemm(self, stream: int, m: int, n: int, k: int, d, a, bt, c=None, *,
             alpha: float = 1.0, beta: float = 0.0) -> None:
        """d (m, n) = α·A·B + β·C, ``a`` A's planes (m, k) or (address, None,
        row stride) of A in f32, ``bt`` Bᵀ's planes (n, k)."""
        rc = self.lib.tml_gemm_tf32x3(*a, *bt, *(c or (None, 0)), *d, m, n, k, alpha, beta,
                                      stream)
        cuda_utils.check_launch(self.lib, rc, "tml_gemm_tf32x3")
        gemm_tf32x3.launches += 1


def plane_pair(p):
    """(hi, lo, row stride) of a planes tensor; (address, None, row stride)
    of a 2-D f32 matrix that the kernel splits itself."""
    if p.ndim == 2:
        return p.data_ptr(), None, p.stride(0)
    return p[0].data_ptr(), p[1].data_ptr(), p.stride(1)


def split_tf32(x, *, transpose: bool = False, unit_lower: bool = False):
    """The TF32 planes of f32 ``x`` (rows, cols) as a (2, rows, cols) tensor
    (``planes``), hi then lo ((2, cols, rows) with ``transpose``); one
    launch of ``tml_split_tf32``."""
    if not on_cuda(x):
        return torch.stack(_split_tf32_plain(x, transpose=transpose, unit_lower=unit_lower))
    launcher = Tf32x3()   # a failed build raises before any device lookup
    with torch.cuda.device(x.device):
        return _split_launch(launcher, torch.cuda.current_stream(x.device).cuda_stream, x,
                             transpose=transpose, unit_lower=unit_lower)


split_tf32.launches = 0


def _split_launch(launcher: "Tf32x3", stream: int, x, *, transpose: bool = False,
                  unit_lower: bool = False):
    """``split_tf32``'s CUDA branch on ``stream`` of x's device, for routes
    that have chosen the card (``dx.gemm``'s f32 route, B10b): planes with
    row strides TMA reads."""
    rows, cols = x.shape
    check(x.dtype == F32, "split_tf32 takes f32")
    x = x if x.stride(1) == 1 or cols <= 1 else x.contiguous()
    out = planes(cols, rows, x.device) if transpose else planes(rows, cols, x.device)
    flags = (TRANSPOSE if transpose else 0) | (UNIT_LOWER if unit_lower else 0)
    launcher.split(stream, (x.data_ptr(), x.stride(0)), out[0].data_ptr(), out[1].data_ptr(),
                   out.stride(1), rows, cols, flags)
    return out


def gemm_tf32x3(a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
    """D = α·A·B + β·C in 3xTF32 for f32 A (m, k) and B (k, n), C f32 (m,
    n) or None, D f32: Bᵀ's planes and, where ``tma_ready`` refuses A, A's
    (``split_tf32``), then one launch of ``tml_gemm_tf32x3``."""
    (m, k), n = a.shape, b.shape[1]
    check(b.shape[0] == k and (c is None or tuple(c.shape) == (m, n)),
          f"{tuple(a.shape)} @ {tuple(b.shape)} with C {None if c is None else tuple(c.shape)}")
    pb = split_tf32(b, transpose=True)
    if not on_cuda(a, b, c):
        return _gemm_tf32x3_plain(*_split_tf32_plain(a), pb[0], pb[1], c, alpha=alpha,
                                  beta=beta)
    pa = a if a.dtype == F32 and tma_ready(a) else split_tf32(a)
    check(c is None or c.dtype == F32, "an f32 C")
    d = torch.empty((m, n), dtype=F32, device=a.device)
    c = None if c is None else (c if c.stride(1) == 1 else c.contiguous())
    with torch.cuda.device(a.device):
        Tf32x3().gemm(torch.cuda.current_stream(a.device).cuda_stream, m, n, k,
                      (d.data_ptr(), n), plane_pair(pa), plane_pair(pb),
                      None if c is None else (c.data_ptr(), c.stride(0)), alpha=alpha,
                      beta=beta)
    return d


gemm_tf32x3.launches = 0
