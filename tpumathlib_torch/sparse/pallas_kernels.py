"""Blocked-ELL SpMM and SpMV on the card: kernels B6a and B6b/B6c.

Counterpart of ``tpumathlib/sparse/pallas_kernels.py``. The names
``bell_spmm_pallas``, ``bell_spmv_pallas`` and ``SpmvPlan`` are kept for
parity, so that a reader finds the counterpart; the kernels themselves are
CUDA C++ in ``csrc/bell_sparse.cu``, not Pallas:

- ``tml_bell_spmm`` (B6a, for ``bell_spmm_pallas``): Y = alpha·A@B with A
  Blocked-ELL (mb, ellw, bs, bs) and B dense (n, k), f32 accumulation,
  output in B's dtype. Operands in f32, bf16 or f16; bs % 128 == 0.
- ``tml_bell_spmv`` (B6b and B6c, for ``SpmvPlan.execute``): y = alpha·A@x
  in f32 throughout; bs % 8 == 0. The reference's two execute kernels
  differ only in TPU workarounds (bf16 hi/lo planes standing in for f32
  MXU products, and a transposed "row form" with an 8-sublane interleave),
  so one f32 kernel computes what both compute. ``SpmvPlan.rowform`` keeps
  the reference's value for callers and parity tests; it selects nothing.

Pad slots (block-column id -1) contribute nothing on every route, whatever
their data holds: the kernels skip them and the plain versions mask them.
(The reference clamps pad ids to block 0 and trusts that their data is
zero.)

On CPU tensors each wrapper takes its plain PyTorch version
(``_bell_spmm_plain``, ``_bell_spmv_plain``: a gather of the B tiles or x
blocks, a mask and an f32 einsum); on CUDA tensors it launches its kernel
or raises. ``bell_spmm_pallas.launches`` and ``_bell_spmv.launches`` count
the launches.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.core.errors import NotSupportedError, check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.sparse.containers import BlockedELL

# operand dtype codes, as csrc/bell_sparse.cu reads them
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_bell(cols, data, shape, bs: int) -> tuple[int, int]:
    mb, ellw = cols.shape
    check(tuple(data.shape) == (mb, ellw, bs, bs),
          f"data must be (mb, ellw, bs, bs) = {(mb, ellw, bs, bs)}, not {tuple(data.shape)}")
    check(shape[0] <= mb * bs, f"{shape[0]} rows exceed mb·bs = {mb * bs}")
    return mb, ellw


def _bell_product(cols, data, b, shape, dtype) -> torch.Tensor:
    """A@B in ``dtype`` for A = (cols, data) Blocked-ELL of ``shape`` and B
    (n, k): gather the B rows that every slot names (rows past n read as
    zero), zero the pad slots' data and rows, one einsum per block row.
    Returns (m, k)."""
    m, n = shape
    mb, bs, k = cols.shape[0], data.shape[-1], b.shape[-1]
    nb = -(-n // bs)
    b = b.to(dtype)
    if nb * bs != n:
        b = torch.cat([b, b.new_zeros((nb * bs - n, k))])
    valid = (cols >= 0)[..., None, None]
    tiles = torch.where(valid, b.reshape(nb, bs, k)[cols.clamp(min=0).long()], 0.0)
    data = torch.where(valid, data.to(dtype), 0.0)
    return torch.einsum("mert,metk->mrk", data, tiles).reshape(mb * bs, k)[:m]


def _bell_spmm_plain(a: BlockedELL, b, alpha=1.0):
    """alpha·A@B in f32, cast to B's dtype (``_bell_product``)."""
    _check_bell(a.cols, a.data, a.shape, a.blocksize)
    return (alpha * _bell_product(a.cols, a.data, b, a.shape, torch.float32)).to(b.dtype)


def bell_spmm_pallas(a: BlockedELL, b, alpha=1.0, tk: int = 256):
    """C = alpha·A@B with A Blocked-ELL, B dense (n, k), in B's dtype.

    ``tk`` is the reference's column-tile width; it is validated and only
    tunes the TPU kernel: ``tml_bell_spmm`` tiles k by 128 whatever it
    says, and the result does not depend on it. On CUDA the kernel takes
    f32, bf16 and f16 operands and bs % 128 == 0 (the only block sizes
    ``spmm`` routes here); anything else raises NotSupportedError."""
    m, n = a.shape
    bs = a.blocksize
    check(b.ndim == 2 and b.shape[0] == n, f"B must be ({n}, k), not {tuple(b.shape)}")
    check(isinstance(tk, int) and tk >= 1, f"tk must be a positive int, not {tk!r}")
    mb, ellw = _check_bell(a.cols, a.data, a.shape, bs)
    if not on_cuda(a.cols, a.data, b):
        return _bell_spmm_plain(a, b, alpha)
    for what, t in (("A", a.data), ("B", b)):
        if t.dtype not in _DTYPE_CODE:
            raise NotSupportedError(f"tml_bell_spmm takes f32, bf16 or f16 operands, not {what} "
                                    f"in {t.dtype}")
    check(bs % 128 == 0, f"tml_bell_spmm takes bs % 128 == 0, not {bs}", NotSupportedError)
    check(a.cols.device == a.data.device == b.device, "A and B on one device")
    k = b.shape[1]
    y = torch.empty((m, k), dtype=b.dtype, device=b.device)
    if m == 0 or k == 0:
        return y
    cols, data, bc = a.cols.to(torch.int32).contiguous(), _aligned(a.data), _aligned(b)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(b.device):
        rc = lib.tml_bell_spmm(cols.data_ptr(), data.data_ptr(), bc.data_ptr(), y.data_ptr(),
                               mb, ellw, bs, m, n, k, float(alpha),
                               _DTYPE_CODE[data.dtype], _DTYPE_CODE[bc.dtype],
                               torch.cuda.current_stream(b.device).cuda_stream)
    cuda_utils.check_launch(lib, rc, "tml_bell_spmm")
    bell_spmm_pallas.launches += 1
    return y


bell_spmm_pallas.launches = 0


def bell_spmv_pallas(a: BlockedELL, x, alpha=1.0):
    """y = alpha·A@x with A Blocked-ELL: the SpMM kernel with one column.
    For repeated products use SpmvPlan, whose kernel is made for one
    column."""
    check(x.ndim == 1, f"x must be a vector, not {tuple(x.shape)}")
    return bell_spmm_pallas(a, x[:, None], alpha=alpha)[:, 0]


def _bell_spmv_plain(cols, data, x, shape, alpha=1.0):
    """alpha·A@x in f32 (``_bell_product`` with one column)."""
    _check_bell(cols, data, shape, data.shape[-1])
    return alpha * _bell_product(cols, data, x[:, None], shape, torch.float32)[:, 0]


def _bell_spmv(cols, data, x, shape, alpha=1.0):
    """The SpMV of SpmvPlan.execute: ``tml_bell_spmv`` on CUDA tensors,
    ``_bell_spmv_plain`` on CPU tensors. data f32 (mb, ellw, bs, bs), x f32
    (n,); returns y f32 (m,)."""
    m, n = shape
    bs = data.shape[-1]
    mb, ellw = _check_bell(cols, data, shape, bs)
    check(tuple(x.shape) == (n,), f"x must be ({n},), not {tuple(x.shape)}")
    if not on_cuda(cols, data, x):
        return _bell_spmv_plain(cols, data, x, shape, alpha)
    check(data.dtype == x.dtype == torch.float32, "tml_bell_spmv takes f32 data and x",
          NotSupportedError)
    check(cols.device == data.device == x.device, "plan and x on one device")
    y = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    cols, data, xc = cols.to(torch.int32).contiguous(), _aligned(data), _aligned(x)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(x.device):
        rc = lib.tml_bell_spmv(cols.data_ptr(), data.data_ptr(), xc.data_ptr(), y.data_ptr(),
                               mb, ellw, bs, m, n, float(alpha),
                               torch.cuda.current_stream(x.device).cuda_stream)
    cuda_utils.check_launch(lib, rc, "tml_bell_spmv")
    _bell_spmv.launches += 1
    return y


_bell_spmv.launches = 0


class SpmvPlan:
    """cuSPARSE SpMV descriptor lifecycle for Blocked-ELL (≙ cusparseSpMV's
    create/analyze/execute split, cuSPARSE/spmv_csr/spmv_csr_example.c):
    the analysis stores A once as f32 blocks (``.data``, untransposed, the
    caller's tensor itself when it already is f32 and contiguous), and
    every ``execute`` streams them once through ``tml_bell_spmv``."""

    def __init__(self, a: BlockedELL):
        check(a.blocksize % 8 == 0, "blocksize must be a multiple of 8")
        self.bs = a.blocksize
        self.mb, self.ellw = a.cols.shape
        self.shape = tuple(a.shape)
        self.cols = a.cols.to(torch.int32).contiguous()
        self.data = a.data.to(torch.float32).contiguous()
        _check_bell(self.cols, self.data, self.shape, self.bs)
        # the reference's choice of its transposed-block kernel (B6c);
        # kept for callers and parity, it selects nothing here
        self.rowform = self.shape[1] % self.bs == 0 and self.bs % 128 == 0

    @classmethod
    def from_parts(cls, cols, ah, al, shape, bs):
        """Rebuild from analysis products: the reference's bf16 (hi, lo)
        planes, whose blocks are transposed where its ``rowform`` holds, or
        ``al=None`` with ``ah`` the port's own f32 ``.data``. The f32
        blocks are ``ah + al``, which carries 16 of f32's 24 mantissa bits:
        a plan rebuilt from the reference's planes agrees with a fresh
        analysis to about 1e-5, as the reference's own execute does."""
        check(bs % 8 == 0, "blocksize must be a multiple of 8")
        p = object.__new__(cls)
        p.bs = bs
        p.mb, p.ellw = cols.shape
        p.shape = tuple(shape)
        p.cols = cols.to(torch.int32).contiguous()
        p.rowform = p.shape[1] % bs == 0 and bs % 128 == 0
        if al is None:
            data = ah.to(torch.float32)
        else:
            data = ah.float() + al.float()
            if p.rowform:
                data = data.transpose(-1, -2)
        p.data = data.contiguous()
        _check_bell(p.cols, p.data, p.shape, bs)
        return p

    def execute(self, x, alpha=1.0):
        """y = alpha·A@x, f32 (m,); x (n,) is taken as f32."""
        return _bell_spmv(self.cols, self.data, x.to(torch.float32), self.shape, alpha)
