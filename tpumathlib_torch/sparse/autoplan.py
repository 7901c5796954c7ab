"""Plan-time CSR pattern analysis + automatic repack to the fastest SpMV
engine (≙ cusparseSpMV_preprocess, the analysis step of the descriptor
lifecycle, cuSPARSE/spmv_csr/spmv_csr_example.c:88-112).

Counterpart of ``tpumathlib/sparse/autoplan.py``, with the same analysis,
``engine`` choice and ``stats`` keys. Many "CSR" matrices carry latent
block structure (FEM, multi-dof graphs, banded systems); the analysis
detects it on the host at plan time and repacks:

  engine="blockedell": nnz covered by (bs x bs) tiles with acceptable
      padding -> repack into f32 Blocked-ELL + ``SpmvPlan`` (kernel
      ``tml_bell_spmv`` on the card).
  engine="sell": row lengths regular enough that sliced-ELL padding is
      small -> SELL, in the input's dtype, through ``spmv``.
  engine="csr": the rest -> ``spmv`` on the CSR itself.

Two divergences from the reference, on purpose: duplicate (row, col)
entries are summed by the Blocked-ELL repack (the reference keeps one of
them), and the SELL engine keeps the input's dtype (the reference builds
f32). The Blocked-ELL engine is f32, as ``SpmvPlan`` is.
"""

from __future__ import annotations

import numpy as np

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.core.interop import from_numpy, to_numpy
from tpumathlib_torch.sparse.containers import COO, CSR, SELL, BlockedELL
from tpumathlib_torch.sparse.ops import spmv
from tpumathlib_torch.sparse.pallas_kernels import SpmvPlan


def _csr_host(a):
    """(indptr, indices, data, shape) of a CSR or COO on the host; a COO's
    duplicates are summed (scipy's tocsr, as in the reference)."""
    if isinstance(a, COO):
        import scipy.sparse as sp

        m = sp.coo_matrix((to_numpy(a.data), (to_numpy(a.row), to_numpy(a.col))),
                          shape=a.shape).tocsr()
        return m.indptr, m.indices, m.data, a.shape
    check(isinstance(a, CSR), f"spmv_auto_plan needs CSR/COO, got {type(a)}")
    return to_numpy(a.indptr), to_numpy(a.indices), to_numpy(a.data), a.shape


class SpmvAutoPlan:
    """Analyze-once / execute-many SpMV plan over an arbitrary CSR/COO.

    ``plan.engine`` reports the chosen path; ``plan.stats`` the analysis
    metrics (block fill, padding ratios). execute(x) returns alpha*A@x.
    """

    def __init__(self, a, bs: int = 128, max_blowup: float = 32.0,
                 max_bytes: int = 1 << 31, sell_slice: int = 8,
                 sell_max_pad: float = 1.5):
        indptr, indices, data, (m, n) = _csr_host(a)
        dev = a.data.device
        nnz = int(indptr[-1])
        self.shape = (m, n)
        self.stats = {}
        rowlen = np.diff(indptr)
        self._csr = a if isinstance(a, CSR) else None

        engine = "csr"
        if nnz:
            mb = -(-m // bs)
            nbc = -(-n // bs)
            rows = np.repeat(np.arange(m, dtype=np.int64), rowlen)
            key = (rows // bs) * nbc + (indices.astype(np.int64) // bs)
            uk, inv = np.unique(key, return_inverse=True)
            ukrb = (uk // nbc).astype(np.int64)
            per_rb = np.bincount(ukrb, minlength=mb)
            ellw = int(per_rb.max()) if len(uk) else 0
            stored = float(mb) * max(ellw, 1) * bs * bs
            blowup = stored / nnz
            self.stats.update(block_fill=nnz / max(float(len(uk)) * bs * bs, 1.0),
                              bell_blowup=blowup, bell_ellw=ellw, nnz=nnz, bs=bs)
            # 4 bytes per stored slot (the reference's bf16 hi+lo planes,
            # the port's f32 blocks)
            if ellw and blowup <= max_blowup and stored * 4 <= max_bytes:
                engine = "blockedell"
            else:
                ns = -(-m // sell_slice)
                wmax = np.zeros(ns, np.int64)
                np.maximum.at(wmax, np.arange(m) // sell_slice, rowlen)
                sell_pad = float((wmax * sell_slice).sum()) / nnz
                self.stats["sell_pad"] = sell_pad
                self.stats["pad_rows"] = ns * sell_slice
                if sell_pad <= sell_max_pad:
                    engine = "sell"
        self.engine = engine

        if engine == "blockedell":
            first = np.zeros(mb + 1, np.int64)
            np.add.at(first, ukrb + 1, 1)
            first = np.cumsum(first)
            slot_uk = np.arange(len(uk), dtype=np.int64) - first[ukrb]
            cols_arr = np.full((mb, ellw), -1, np.int32)
            cols_arr[ukrb, slot_uk] = (uk % nbc).astype(np.int32)
            # flat position of each entry in (mb, ellw, bs, bs); bincount
            # sums duplicate (row, col) entries
            flat = (((rows // bs) * ellw + slot_uk[inv]) * bs + rows % bs) * bs \
                + indices.astype(np.int64) % bs
            dense = np.bincount(flat, weights=data.astype(np.float64),
                                minlength=mb * ellw * bs * bs)
            blocks = from_numpy(dense.astype(np.float32).reshape(mb, ellw, bs, bs), dev)
            # a ragged m or n needs no padding: the SpMV reads x rows at or
            # past n as zero and writes m rows
            self._bell = SpmvPlan(BlockedELL(from_numpy(cols_arr, dev), blocks, (m, n), bs))
        elif engine == "sell":
            width = int(wmax.max() or 1)
            pos = np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1].astype(np.int64), rowlen)
            cols = np.zeros((ns, sell_slice, width), np.int32)
            vals = np.zeros((ns, sell_slice, width), data.dtype)
            cols[rows // sell_slice, rows % sell_slice, pos] = indices
            vals[rows // sell_slice, rows % sell_slice, pos] = data
            self._sell = SELL(from_numpy(cols, dev), from_numpy(vals, dev).to(a.data.dtype),
                              from_numpy(wmax.astype(np.int32), dev), (m, n), sell_slice)
        elif self._csr is None:
            self._csr = CSR(from_numpy(indptr.astype(np.int32), dev),
                            from_numpy(indices.astype(np.int32), dev),
                            from_numpy(data, dev), (m, n))

    def execute(self, x, alpha=1.0):
        if self.engine == "blockedell":
            return self._bell.execute(x, alpha)
        if self.engine == "sell":
            return spmv(self._sell, x, alpha=alpha)
        return spmv(self._csr, x, alpha=alpha)
