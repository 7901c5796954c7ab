"""Level-scheduled sparse triangular solve (SpSV / SpSM).

Counterpart of ``tpumathlib/sparse/spsv.py``. Parity:
cusparseSpSV_bufferSize/analysis/solve (spsv_csr sample) and cusparseSpSM
(spsm_csr). The analysis phase is a host-side **level-set computation** in
numpy: rows are grouped into dependency levels, and all rows of a level
solve at once. The solve is a Python loop over the levels in torch, each
level one gather, one row sum (``index_add_``) and one scatter, under the
port's ``sanitize``. It runs no kernel of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.core.interop import from_numpy, to_numpy
from tpumathlib_torch.core.sanitize import sanitize
from tpumathlib_torch.sparse.containers import CSR


@dataclasses.dataclass
class SpSvPlan:
    """≙ cusparseSpSV_analysis output, cached for repeated solves."""

    csr: CSR
    lower: bool
    unit_diag: bool
    levels: tuple          # tuple of index tensors, one per level
    diag_pos: Any          # (m,) position of the diagonal entry in data

    def solve(self, b, alpha=1.0):
        # TPUMATHLIB_CHECKIFY=1 surfaces NaN/Inf in the solution and
        # out-of-range column ids instead of propagating them silently
        return sanitize(_spsv_execute, indices=_spsv_indices)(self, b, alpha)


def _spsv_indices(plan: SpSvPlan, b, alpha):
    yield "column index", plan.csr.indices, plan.csr.shape[1]


def spsv_plan(a: CSR, lower: bool = True, unit_diag: bool = False) -> SpSvPlan:
    indptr = to_numpy(a.indptr)
    indices = to_numpy(a.indices)
    data = to_numpy(a.data)
    m = a.shape[0]
    level = np.zeros(m, np.int64)
    diag_pos = np.zeros(m, np.int64)
    rows = range(m) if lower else range(m - 1, -1, -1)
    for i in rows:
        lv = 0
        found_diag = False
        for p in range(indptr[i], indptr[i + 1]):
            j = indices[p]
            if j == i:
                diag_pos[i] = p
                found_diag = True
            elif data[p] != 0 and ((lower and j < i) or (not lower and j > i)):
                lv = max(lv, level[j] + 1)
        if not found_diag:
            check(unit_diag, f"missing diagonal in row {i}")
        level[i] = lv
    nlev = int(level.max()) + 1 if m else 0
    dev = a.data.device
    levels = tuple(from_numpy(np.nonzero(level == lv)[0], dev) for lv in range(nlev))
    return SpSvPlan(a, lower, unit_diag, levels, from_numpy(diag_pos, dev))


def _spsv_execute(plan: SpSvPlan, b, alpha):
    a = plan.csr
    m = a.shape[0]
    rows_all = a.row_ids().long()
    cols = a.indices.long()
    matrix_rhs = b.ndim > 1
    x = torch.zeros((m,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
    rhs = alpha * b

    def bcast(v):  # lift (nnz,)/(L,) values over RHS columns
        return v[:, None] if matrix_rhs else v

    offdiag_mask = bcast(cols == rows_all)
    for lv_rows in plan.levels:
        # contribution of already-solved x to these rows:
        # sum_j a[i,j]·x[j] over off-diagonal entries
        offdiag = torch.where(offdiag_mask, torch.zeros((), dtype=x.dtype, device=x.device),
                              x[cols])
        seg = torch.zeros_like(x).index_add_(0, rows_all, bcast(a.data) * offdiag)
        xi = rhs[lv_rows] - seg[lv_rows]
        if not plan.unit_diag:
            xi = xi / bcast(a.data[plan.diag_pos[lv_rows]])
        x = x.index_copy(0, lv_rows, xi)
    return x


def spsv(a: CSR, b, alpha=1.0, lower: bool = True, unit_diag: bool = False):
    """Solve op(A) x = alpha·b, A sparse triangular (one-shot plan+solve)."""
    return spsv_plan(a, lower, unit_diag).solve(b, alpha)


def spsm(a: CSR, b, alpha=1.0, lower: bool = True, unit_diag: bool = False):
    """Sparse triangular solve with matrix RHS (≙ cusparseSpSM)."""
    return spsv_plan(a, lower, unit_diag).solve(b, alpha)
