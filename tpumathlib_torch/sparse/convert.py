"""Format conversions (≙ cuSPARSE dense2sparse_csr/dense2sparse_blockedell,
sparse2dense, compression, coosort samples).

Counterpart of ``tpumathlib/sparse/convert.py``. Construction from a dense
matrix runs on the host in numpy, as in the reference; the result lands on
the input tensor's device, or on ``default_device()`` for a host array.
Expansion to dense and the COO passes run on the tensors' device in torch:
``index_put_(accumulate=True)`` stands for ``.at[].add`` and a stable
argsort of the int64 (row, col) key for ``coo_sort``. ``nnz_cap`` realizes
the static-capacity contract (pad with zero values / clamped indices).
"""

from __future__ import annotations

import numpy as np
import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.core.interop import from_numpy, to_numpy
from tpumathlib_torch.sparse.containers import COO, CSR, BlockedELL, default_device


def _host(a):
    """(numpy array, target device) of a dense input; a bf16 tensor comes
    to the host as f32, which holds its values exactly."""
    if isinstance(a, torch.Tensor):
        return to_numpy(a), a.device
    return np.asarray(a), default_device()


def _like(t: torch.Tensor, a) -> torch.Tensor:
    """``t`` in the dtype of the dense input ``a`` when that is a tensor."""
    return t.to(a.dtype) if isinstance(a, torch.Tensor) else t


def dense_to_csr(a, nnz_cap: int | None = None) -> CSR:
    an, dev = _host(a)
    m, n = an.shape
    rows, cols = np.nonzero(an)
    vals = an[rows, cols]
    nnz = len(vals)
    cap = nnz_cap or nnz
    check(cap >= nnz, f"nnz_cap {cap} < nnz {nnz}")
    indptr = np.zeros(m + 1, np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    pad = cap - nnz
    cols_p = np.concatenate([cols, np.full(pad, max(n - 1, 0))]).astype(np.int32)
    vals_p = np.concatenate([vals, np.zeros(pad, an.dtype)])
    # padded entries belong to the last row: indptr stays valid for rows,
    # row_ids() maps them to m-1 with zero contribution
    indptr[-1] = cap
    return CSR(from_numpy(indptr, dev), from_numpy(cols_p, dev),
               _like(from_numpy(vals_p, dev), a), (m, n))


def dense_to_coo(a, nnz_cap: int | None = None) -> COO:
    an, dev = _host(a)
    m, n = an.shape
    rows, cols = np.nonzero(an)
    vals = an[rows, cols]
    cap = nnz_cap or len(vals)
    check(cap >= len(vals), "nnz_cap too small")
    pad = cap - len(vals)
    return COO(
        from_numpy(np.concatenate([rows, np.full(pad, m - 1)]).astype(np.int32), dev),
        from_numpy(np.concatenate([cols, np.full(pad, n - 1)]).astype(np.int32), dev),
        _like(from_numpy(np.concatenate([vals, np.zeros(pad, an.dtype)]), dev), a),
        (m, n),
    )


def _scatter_add(shape, idx, vals):
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    return out.index_put_(tuple(i.long() for i in idx), vals, accumulate=True)


def csr_to_dense(a: CSR):
    return _scatter_add(a.shape, (a.row_ids(), a.indices), a.data)


def coo_to_dense(a: COO):
    return _scatter_add(a.shape, (a.row, a.col), a.data)


def csr_to_coo(a: CSR) -> COO:
    return COO(a.row_ids().to(torch.int32), a.indices, a.data, a.shape)


def coo_to_csr(a: COO) -> CSR:
    """Requires row-sorted COO (run coo_sort first)."""
    m = a.shape[0]
    counts = torch.bincount(a.row.long(), minlength=m)
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=a.row.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return CSR(indptr, a.col, a.data, a.shape)


def coo_sort(a: COO) -> COO:
    """Sort by (row, col) (≙ cusparseXcoosort + gathered values)."""
    key = a.row.long() * a.shape[1] + a.col.long()
    order = torch.argsort(key, stable=True)
    return COO(a.row[order], a.col[order], a.data[order], a.shape)


def dense_to_blocked_ell(a, blocksize: int, ellwidth: int | None = None) -> BlockedELL:
    """Dense → Blocked-ELL: keep nonzero (bs×bs) tiles, ``ellwidth`` block
    columns per block row (pad id −1, pad data 0) (≙ dense2sparse_blockedell)."""
    an, dev = _host(a)
    m, n = an.shape
    bs = blocksize
    check(m % bs == 0 and n % bs == 0, "shape must be divisible by blocksize")
    mb, nb = m // bs, n // bs
    tiles = an.reshape(mb, bs, nb, bs).transpose(0, 2, 1, 3)
    nz = np.abs(tiles).sum(axis=(2, 3)) > 0
    width = ellwidth or max(int(nz.sum(axis=1).max()), 1)
    cols = np.full((mb, width), -1, np.int32)
    data = np.zeros((mb, width, bs, bs), an.dtype)
    for i in range(mb):
        js = np.nonzero(nz[i])[0][:width]
        cols[i, : len(js)] = js
        data[i, : len(js)] = tiles[i, js]
    return BlockedELL(from_numpy(cols, dev), _like(from_numpy(data, dev), a), (m, n), bs)


def blocked_ell_to_dense(a: BlockedELL):
    """The dense matrix of the stored blocks; pad slots are masked."""
    mb, w = a.cols.shape
    bs = a.blocksize
    m, n = a.shape
    nb = n // bs
    valid = (a.cols >= 0).reshape(-1)
    rows = torch.arange(mb, device=a.cols.device).repeat_interleave(w)[valid]
    blocks = a.data.reshape(-1, bs, bs)[valid]
    out = _scatter_add((mb, nb, bs, bs), (rows, a.cols.reshape(-1)[valid]), blocks)
    return out.transpose(1, 2).reshape(m, n)


def csr_to_blocked_ell(a: CSR, blocksize: int = 128, max_fill: float = 32.0) -> BlockedELL:
    """CSR → Blocked-ELL without densifying the whole matrix (tiles are
    scattered per block-row from the CSR triples, on the host). When a CSR
    matrix has block STRUCTURE (fill expansion ≤ ``max_fill``: stored tile
    bytes / csr value bytes), converting once and running the Blocked-ELL
    kernels wins after a handful of products. Raises when the pattern would
    expand more than ``max_fill``× (truly unstructured: stay on CSR)."""
    m, n = a.shape
    bs = blocksize
    check(m % bs == 0 and n % bs == 0, "shape must be divisible by blocksize")
    indptr = a.indptr.cpu().numpy().astype(np.int64)
    indices = a.indices.cpu().numpy().astype(np.int64)
    data = to_numpy(a.data)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    keep = data != 0
    rows, cols_, vals = rows[keep], indices[keep], data[keep]
    nnz = len(vals)
    br, bc = rows // bs, cols_ // bs
    # distinct tiles per block-row
    key = br * (n // bs) + bc
    uniq = np.unique(key)
    width = int(np.bincount(uniq // (n // bs), minlength=m // bs).max()) if len(uniq) else 1
    width = max(width, 1)
    mb = m // bs
    fill = (mb * width * bs * bs) / max(nnz, 1)
    check(fill <= max_fill,
          f"pattern too unstructured for Blocked-ELL: fill {fill:.1f}x "
          f"> {max_fill}x — keep CSR (gather-bound) or raise max_fill")
    cols = np.full((mb, width), -1, np.int32)
    datat = np.zeros((mb, width, bs, bs), vals.dtype)
    tile_of = np.searchsorted(uniq, key)          # tile index per entry
    # slot of each tile within its block-row (uniq sorted by block-row)
    ubr = uniq // (n // bs)
    slot = np.arange(len(uniq)) - np.searchsorted(ubr, ubr, side="left")
    cols[ubr, slot] = (uniq % (n // bs)).astype(np.int32)
    datat[ubr[tile_of], slot[tile_of], rows % bs, cols_ % bs] = vals
    dev = a.data.device
    return BlockedELL(from_numpy(cols, dev), from_numpy(datat, dev).to(a.data.dtype), (m, n), bs)


def prune_dense(a, threshold: float = 0.0):
    """Zero entries with |a| <= threshold (≙ cusparseDpruneDense2csr's
    pruning step); pair with dense_to_csr for the full sample flow."""
    return torch.where(a.abs() > threshold, a, torch.zeros((), dtype=a.dtype, device=a.device))
