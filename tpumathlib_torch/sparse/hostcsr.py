"""Host-side CSR toolkit (pure NumPy, vectorized) — the bookkeeping layer
the reference implements with host C++ helpers (cuDSS ANALYSIS-phase matrix
plumbing, cuSOLVERSp host paths). Product code uses this instead of scipy;
scipy remains a test oracle only.

The port's own copy of ``tpumathlib/sparse/hostcsr.py`` (the port imports
nothing of the JAX package); the functions are the same."""

from __future__ import annotations

import numpy as np


def row_ids(indptr: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(indptr) - 1),
                     np.diff(indptr.astype(np.int64)))


def coo_to_csr(m: int, n: int, rows, cols, vals, sum_dups: bool = True):
    """COO → CSR (sorted columns; duplicate entries summed)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_dups and len(rows):
        new = np.ones(len(rows), bool)
        new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        grp = np.cumsum(new) - 1
        mvals = np.zeros(grp[-1] + 1, vals.dtype)
        np.add.at(mvals, grp, vals)
        rows, cols, vals = rows[new], cols[new], mvals
    indptr = np.zeros(m + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols, vals


def transpose(m: int, n: int, indptr, indices, data):
    """CSR transpose via counting sort."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    data = np.asarray(data)
    rows = row_ids(indptr)
    order = np.lexsort((rows, indices))
    tp = np.zeros(n + 1, np.int64)
    np.add.at(tp, indices + 1, 1)
    return np.cumsum(tp), rows[order].astype(np.int64), data[order]


def sym_pattern(indptr, indices, n: int):
    """Structure of A + Aᵀ (pattern only) → (indptr, indices)."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    rows = row_ids(indptr)
    r = np.concatenate([rows, indices])
    c = np.concatenate([indices, rows])
    ip, ii, _ = coo_to_csr(n, n, r, c, np.ones(len(r)), sum_dups=True)
    return ip, ii


def permute_sym(indptr, indices, data, perm):
    """PAPᵀ for permutation perm (new index i = old index perm[i])."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    n = len(indptr) - 1
    inv = np.empty(n, np.int64)
    inv[np.asarray(perm, np.int64)] = np.arange(n)
    rows = inv[row_ids(indptr)]
    cols = inv[indices]
    return coo_to_csr(n, n, rows, cols, np.asarray(data), sum_dups=False)


def to_dense(m: int, n: int, indptr, indices, data):
    out = np.zeros((m, n), np.asarray(data).dtype)
    out[row_ids(np.asarray(indptr, np.int64)),
        np.asarray(indices, np.int64)] = np.asarray(data)
    return out


def spmv(indptr, indices, data, x):
    """Host CSR SpMV; x (n,) or (n, k)."""
    indptr = np.asarray(indptr, np.int64)
    rows = row_ids(indptr)
    data = np.asarray(data)
    x = np.asarray(x)
    xi = x[np.asarray(indices, np.int64)]
    prod = data[:, None] * xi if x.ndim > 1 else data * xi
    y = np.zeros((len(indptr) - 1,) + x.shape[1:], prod.dtype)
    np.add.at(y, rows, prod)
    return y


def vstack(parts):
    """Stack CSR triples [(indptr, indices, data, ncols), ...] by rows."""
    ips, iis, dxs = [], [], []
    off = 0
    base = np.zeros(1, np.int64)
    out_ip = [np.zeros(1, np.int64)]
    for ip, ii, dx in parts:
        ip = np.asarray(ip, np.int64)
        out_ip.append(ip[1:] + off)
        off += ip[-1]
        iis.append(np.asarray(ii, np.int64))
        dxs.append(np.asarray(dx))
    return (np.concatenate(out_ip), np.concatenate(iis),
            np.concatenate(dxs))
