"""Sparse BLAS ops: SpMV / SpMM / SDDMM + the sparse vector ops.

Counterpart of ``tpumathlib/sparse/ops.py``. Parity (cuSPARSE generic API):
  cusparseSpMV  (csr/coo/sell/bsr/blockedell)    → spmv
  cusparseSpMM  (csr/coo/blockedell, batched)    → spmm
  cusparseSDDMM (csr/coo; bsr)                   → sddmm, sddmm_bsr
  axpby / gather / scatter / rot / spvv          → axpby / sp_* / spvv
  custom-operator variants (spmvop)              → the ``combine`` hook

CSR/COO lower to a gather of x by column, the products, and a sum by row
with ``index_add_`` (the reference's is an XLA segment sum; its
scatter-free cumsum-and-difference row sum is a TPU workaround and is not
ported). SELL and BSR are gathers and dense row or block reductions.
Blocked-ELL with bs % 128 == 0 goes to ``bell_spmm_pallas`` (kernel B6a on
the card); any other block size to a masked einsum. ``spmv`` on an f32
Blocked-ELL and f32 x takes the SpMV kernel (``tml_bell_spmv``, as
``SpmvPlan`` does) where bs % 8 == 0. ``sddmm_bsr`` pins
f32 products (``fft.kernels._f32_products``), so a caller's TF32 setting
does not reach them; ``_bsr_spmv``'s block products are matrix-vector
products, which TF32 did not reach on the card (ROADMAP C16).
"""

from __future__ import annotations

from typing import Callable

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.fft.kernels import _f32_products
from tpumathlib_torch.sparse.containers import BSR, COO, CSR, SELL, BlockedELL
from tpumathlib_torch.sparse.pallas_kernels import (_bell_product, _bell_spmv, _spmv_takes,
                                                    bell_spmm_pallas)


def _row_ids(a):
    if isinstance(a, COO):
        return a.row
    return a.row_ids()


def _segment_sum(vals, seg, m: int):
    out = torch.zeros((m,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg.long(), vals)


def _sell_spmv(a: SELL, x, alpha):
    """SELL SpMV (≙ cusparseSpMV over sliced-ELL): per-slice dense gather +
    row reduction."""
    m, _ = a.shape
    rowsum = (a.data * x[a.cols.long()]).sum(-1)        # (ns, sh)
    return alpha * rowsum.reshape(-1)[:m]


def _with_y(out, y, beta):
    return out if y is None else out + beta * y


def spmv(a, x, y=None, alpha=1.0, beta=0.0, combine: Callable | None = None,
         transpose: bool = False):
    """y = alpha·op(A)x + beta·y for CSR/COO/SELL/BSR/Blocked-ELL A.

    ``combine(a_val, x_val)`` replaces the product on CSR/COO, the
    custom-operator hook (≙ cuSPARSE spmvop_csr sample)."""
    if isinstance(a, SELL):
        return _with_y(_sell_spmv(a, x, alpha), y, beta)
    if isinstance(a, BlockedELL):
        check(not transpose, "blocked-ELL transpose not supported")
        if _spmv_takes(a, x):   # f32: the SpMV kernel, not the SpMM one with one column
            return _with_y(_bell_spmv(a.cols, a.data, x, a.shape, alpha), y, beta)
        return _with_y(_spmm_bell(a, x[:, None], alpha)[:, 0], y, beta)
    if isinstance(a, BSR):
        return _with_y(_bsr_spmv(a, x, alpha), y, beta)
    m, n = a.shape
    cols = a.indices if isinstance(a, CSR) else a.col
    rows = _row_ids(a)
    if transpose:
        rows, cols = cols, rows
        m, n = n, m
    xv = x[cols.long()]
    prod = combine(a.data, xv) if combine is not None else a.data * xv
    return _with_y(alpha * _segment_sum(prod, rows, m), y, beta)


def _spmm_csrcoo(a, b, alpha, transpose):
    m, n = a.shape
    cols = a.indices if isinstance(a, CSR) else a.col
    rows = _row_ids(a)
    if transpose:
        rows, cols = cols, rows
        m, n = n, m
    prod = a.data[:, None] * b[cols.long(), :]          # (nnz, k)
    return alpha * _segment_sum(prod, rows, m)


def _spmm_bell(a: BlockedELL, b, alpha):
    if a.blocksize % 128 == 0:
        return bell_spmm_pallas(a, b, alpha=alpha)
    # the masked einsum, at least f32 (XLA's einsum in the reference)
    wide = torch.promote_types(torch.promote_types(a.data.dtype, b.dtype), torch.float32)
    return (alpha * _bell_product(a.cols, a.data, b, a.shape, wide)).to(b.dtype)


def _bsr_spmv(a: BSR, x, alpha):
    """BSR SpMV: per-block dense (bs×bs)@(bs,) products + block-row sum
    (≙ cusparseSpMV over BSR)."""
    bs = a.blocksize
    mb = len(a.indptr) - 1
    pos = torch.arange(a.nnzb, dtype=a.indptr.dtype, device=a.indptr.device)
    block_rows = torch.searchsorted(a.indptr, pos, right=True) - 1
    xblk = x.reshape(-1, bs)[a.indices.long()]          # (nnzb, bs)
    prod = torch.einsum("nij,nj->ni", a.data, xblk)     # (nnzb, bs)
    return alpha * _segment_sum(prod, block_rows, mb).reshape(-1)[: a.shape[0]]


def sddmm_bsr(a, b, pattern: BSR, alpha=1.0, beta=0.0):
    """SDDMM with a BSR sampling pattern (≙ cuSPARSE sddmm_bsr): compute
    only the sampled (bs×bs) blocks of A@B."""
    bs = pattern.blocksize
    pos = torch.arange(pattern.nnzb, dtype=pattern.indptr.dtype, device=pattern.indptr.device)
    block_rows = torch.searchsorted(pattern.indptr, pos, right=True) - 1
    arows = a.reshape(-1, bs, a.shape[-1])[block_rows.long()]          # (nnzb, bs, k)
    bcols = b.transpose(0, 1).reshape(-1, bs, b.shape[0])[pattern.indices.long()]
    with _f32_products():
        vals = alpha * torch.einsum("nik,njk->nij", arows, bcols) + beta * pattern.data
    return BSR(pattern.indptr, pattern.indices, vals.to(pattern.data.dtype), pattern.shape, bs)


def _fold_batch(b):
    """(batch, n, k) → (n, batch·k): the batch as more columns."""
    batch, n, k = b.shape
    return b.permute(1, 0, 2).reshape(n, batch * k)


def _unfold_batch(out, batch: int):
    m = out.shape[0]
    return out.reshape(m, batch, -1).permute(1, 0, 2)


def spmm(a, b, c=None, alpha=1.0, beta=0.0, transpose_a: bool = False):
    """C = alpha·op(A)B + beta·C; A sparse (CSR/COO/BlockedELL), B dense.

    B with a leading batch dimension gives the batched variant
    (≙ cusparseSpMM_batched): the batch is folded into B's columns, so a
    Blocked-ELL A takes one kernel launch for the whole batch."""
    batch = b.shape[0] if b.ndim == 3 else None
    bb = _fold_batch(b) if batch is not None else b
    if isinstance(a, BlockedELL):
        check(not transpose_a, "blocked-ELL transpose not supported")
        out = _spmm_bell(a, bb, alpha)
    else:
        out = _spmm_csrcoo(a, bb, alpha, transpose_a)
    if batch is not None:
        out = _unfold_batch(out, batch)
    if c is not None:
        out = out + beta * c
    return out.to(b.dtype)


def sddmm(a, b, pattern, alpha=1.0, beta=0.0):
    """Sampled dense-dense matmul (≙ cusparseSDDMM): C = alpha·(A@B)∘spy(S)
    + beta·S, returning a sparse matrix with S's pattern.

    Only the sampled dot products are computed: per-nnz gather of A-rows and
    B-cols + contraction (no dense m×n intermediate)."""
    rows = _row_ids(pattern).long()
    cols = (pattern.indices if isinstance(pattern, CSR) else pattern.col).long()
    vals = alpha * (a[rows, :] * b[:, cols].T).sum(-1) + beta * pattern.data
    if isinstance(pattern, CSR):
        return CSR(pattern.indptr, pattern.indices, vals.to(pattern.dtype), pattern.shape)
    return COO(pattern.row, pattern.col, vals.to(pattern.dtype), pattern.shape)


# ---------------- sparse vector ops (≙ cusparseAxpby/Gather/Scatter/Rot/SpVV) ----------------

def axpby(alpha, x_vals, x_idx, beta, y):
    """y = alpha·X + beta·y with X sparse (values, indices); a new tensor."""
    return (beta * y).index_add_(0, x_idx.long(), alpha * x_vals)


def sp_gather(y, x_idx):
    """Xval = y[idx] (cusparseGather)."""
    return y[x_idx.long()]


def sp_scatter(x_vals, x_idx, y):
    """y[idx] = Xval (cusparseScatter); a new tensor, y is left as it was."""
    return y.index_put((x_idx.long(),), x_vals)


def sp_rot(x_vals, x_idx, y, c, s):
    """Givens rotation between sparse X and dense y (cusparseRot); new tensors."""
    idx = x_idx.long()
    yg = y[idx]
    x_new = c * x_vals + s * yg
    return x_new, y.index_put((idx,), -s * x_vals + c * yg)


def spvv(x_vals, x_idx, y):
    """Sparse-dense dot product (cusparseSpVV)."""
    return (x_vals * y[x_idx.long()]).sum()
