"""Blocked-ELL SpMM and SpMV on the card: kernels B6a and B6b/B6c.

Counterpart of ``tpumathlib/sparse/pallas_kernels.py``. The names
``bell_spmm_pallas``, ``bell_spmv_pallas`` and ``SpmvPlan`` are kept for
parity, so that a reader finds the counterpart; the kernels themselves are
CUDA C++ in ``csrc/bell_sparse.cu`` and ``csrc/bell_wgmma.cu``, not Pallas:

- B6a, for ``bell_spmm_pallas``: Y = alpha·A@B with A Blocked-ELL (mb,
  ellw, bs, bs) and B dense (n, k), f32 accumulation, output in B's dtype;
  bs % 128 == 0. Two tensor-core kernels in ``csrc/bell_wgmma.cu``, one
  rule between them (``_spmm_route``): ``tml_bell_spmm_wgmma`` (TMA +
  wgmma) for bf16 x bf16 and f16 x f16, B read in place where its rows are
  16-byte multiples apart and from a copy with padded rows where they are
  not; ``tml_bell_spmm_tf32x3`` (3xTF32 on the ring of
  ``csrc/gemm_tf32x3.cu``) for f32 and mixed pairs, with Bᵀ split into its
  TF32 planes once a call (``dx.tf32x3``'s split, counted on
  ``tf32x3.split_tf32.launches``) and A passed in its own dtype (the
  kernel widens a 16-bit A in registers); two TF32 products a k8 step where
  one operand is 16-bit (its lo plane is 0), one where both are. The result agrees with float64 to f32's 1e-5 whatever torch's TF32
  setting. ``_bell_spmm_wgmma.launches`` and ``_bell_spmm_tf32x3.launches``
  count each, ``bell_spmm_pallas.launches`` both.
- ``tml_bell_spmv`` (B6b and B6c, for ``SpmvPlan.execute``, and for
  ``bell_spmv_pallas`` and ``sparse.spmv`` on f32 A and x): y = alpha·A@x
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
or raises: no route gives way to another. ``_bell_spmv.launches`` counts
the SpMV kernel's launches.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.core.errors import NotSupportedError, check
from tpumathlib_torch.dx import cuda_utils, tf32x3
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.sparse.containers import BlockedELL

F32 = torch.float32

# operand dtype codes, as csrc/bell_wgmma.cu reads them
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# operand pairs of the 16-bit SpMM: both bf16 or both f16
_TC_DTYPES = (torch.bfloat16, torch.float16)


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


def _spmm_route(a_dtype, b_dtype) -> str:
    """The SpMM kernel a launch takes, both in csrc/bell_wgmma.cu: "wgmma"
    for a bf16 x bf16 or f16 x f16 pair, "tf32x3" for every other pair the
    kernels take (f32 x f32, and mixed: one operand f32, or bf16 with f16)."""
    return "wgmma" if a_dtype == b_dtype and a_dtype in _TC_DTYPES else "tf32x3"


def _tma_rows(b):
    """(B, its row stride in elements) as the tensor-core kernel reads it:
    unit column stride, rows a multiple of 8 elements (16 bytes, TMA's row
    pitch) apart, a 16-byte aligned base. B itself where it lies so; else
    a copy whose rows are padded to a multiple of 8 (a ragged k, as a
    batched spmm's folded B may have)."""
    n, k = b.shape
    ld = b.stride(0)
    if b.stride(1) == 1 and ld % 8 == 0 and ld >= k and b.data_ptr() % 16 == 0:
        return b, ld
    ld = -(-k // 8) * 8
    rows = torch.empty((n, ld), dtype=b.dtype, device=b.device)
    rows[:, :k] = b
    return rows, ld


def bell_spmm_pallas(a: BlockedELL, b, alpha=1.0, tk: int = 256):
    """C = alpha·A@B with A Blocked-ELL, B dense (n, k), in B's dtype.

    ``tk`` is the reference's column-tile width; it is validated and only
    tunes the TPU kernel: the kernels tile k their own way, and the result
    does not depend on it. On CUDA the kernels take f32, bf16 and f16
    operands (``_spmm_route`` picks the kernel) and bs % 128 == 0 (the only
    block sizes ``spmm`` routes here); anything else raises
    NotSupportedError."""
    m, n = a.shape
    bs = a.blocksize
    check(b.ndim == 2 and b.shape[0] == n, f"B must be ({n}, k), not {tuple(b.shape)}")
    check(isinstance(tk, int) and tk >= 1, f"tk must be a positive int, not {tk!r}")
    mb, ellw = _check_bell(a.cols, a.data, a.shape, bs)
    if not on_cuda(a.cols, a.data, b):
        return _bell_spmm_plain(a, b, alpha)
    for what, t in (("A", a.data), ("B", b)):
        if t.dtype not in _DTYPE_CODE:
            raise NotSupportedError(f"the SpMM kernels take f32, bf16 or f16 operands, not "
                                    f"{what} in {t.dtype}")
    check(bs % 128 == 0, f"the SpMM kernels take bs % 128 == 0, not {bs}", NotSupportedError)
    check(a.cols.device == a.data.device == b.device, "A and B on one device")
    k = b.shape[1]
    y = torch.empty((m, k), dtype=b.dtype, device=b.device)
    if m == 0 or k == 0:
        return y
    cols, data = a.cols.to(torch.int32).contiguous(), _aligned(a.data)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        if _spmm_route(data.dtype, b.dtype) == "wgmma":
            bc, ldb = _tma_rows(b)
            _bell_spmm_wgmma(lib, cols.data_ptr(), data.data_ptr(), bc.data_ptr(), y.data_ptr(),
                             mb, ellw, bs, m, n, k, ldb, float(alpha), _DTYPE_CODE[b.dtype],
                             stream)
        else:
            bt, b_exact = _tf32x3_planes(b, stream)
            _bell_spmm_tf32x3(lib, cols.data_ptr(), data.data_ptr(), bt[0].data_ptr(),
                              None if b_exact else bt[1].data_ptr(), bt.stride(1), y.data_ptr(),
                              mb, ellw, bs, m, n, k, float(alpha), _DTYPE_CODE[data.dtype],
                              _DTYPE_CODE[b.dtype], stream)
    return y


bell_spmm_pallas.launches = 0


def _tf32x3_planes(b, stream: int):
    """B as ``tml_bell_spmm_tf32x3`` reads it: Bᵀ's TF32 planes (2, k, n)
    from one split of B (a 16-bit B widened first), with whether B is exact
    in TF32 (its lo plane 0, not read). A goes as it lies, in its own dtype:
    the kernel widens a 16-bit A in registers."""
    bt = tf32x3._split_launch(tf32x3.Tf32x3(), stream, b.to(F32), transpose=True)
    return bt, b.dtype != F32


def _bell_spmm_wgmma(lib, *args):
    """One launch of the 16-bit SpMM, csrc/bell_wgmma.cu."""
    cuda_utils.check_launch(lib, lib.tml_bell_spmm_wgmma(*args), "tml_bell_spmm_wgmma")
    _bell_spmm_wgmma.launches += 1
    bell_spmm_pallas.launches += 1


def _bell_spmm_tf32x3(lib, *args):
    """One launch of the 3xTF32 SpMM of f32 and mixed pairs, csrc/bell_wgmma.cu."""
    cuda_utils.check_launch(lib, lib.tml_bell_spmm_tf32x3(*args), "tml_bell_spmm_tf32x3")
    _bell_spmm_tf32x3.launches += 1
    bell_spmm_pallas.launches += 1


_bell_spmm_wgmma.launches = 0
_bell_spmm_tf32x3.launches = 0


def _spmv_takes(a: BlockedELL, x) -> bool:
    """Whether the SpMV kernel (``_bell_spmv``) computes alpha·A@x: f32 A
    and x, bs % 8 == 0. Its result is f32, the dtype the SpMM route gives
    such operands."""
    return a.data.dtype == x.dtype == torch.float32 and a.blocksize % 8 == 0


def bell_spmv_pallas(a: BlockedELL, x, alpha=1.0):
    """y = alpha·A@x with A Blocked-ELL, in x's dtype: the SpMV kernel for
    f32 A and x, the SpMM kernels with one column for other dtypes. For
    repeated products use SpmvPlan, which keeps A as f32 blocks."""
    check(x.ndim == 1, f"x must be a vector, not {tuple(x.shape)}")
    if _spmv_takes(a, x):
        return _bell_spmv(a.cols, a.data, x, a.shape, alpha)
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
