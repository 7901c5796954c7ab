"""Sparse matrix containers (≙ cusparseCreateCsr/CreateCoo/CreateBlockedEll
descriptors, cuSPARSE/spmv_csr/spmv_csr_example.c:88-112).

Counterpart of ``tpumathlib/sparse/containers.py``: the same fields and
properties, as dataclasses of tensors.

Static-shape contract, kept from the reference: ``nnz`` is a capacity.
Padding entries hold value 0 with row/col indices clamped to the last valid
position, so every operation can ignore padding arithmetically (0-valued
contributions). Blocked-ELL pad slots carry block-column id -1; the port's
Blocked-ELL routes mask them, whatever their data holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpumathlib_torch.core import device as _device


def default_device() -> torch.device:
    """The device of tensors built from host arrays: the port's default,
    ``core.device.default_device()``, the CUDA card (the reference puts them
    on its default device)."""
    return _device.default_device()


@dataclasses.dataclass
class CSR:
    """Compressed sparse row. indptr: (m+1,), indices/data: (nnz,)."""

    indptr: Any
    indices: Any
    data: Any
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[-1]

    @property
    def dtype(self):
        return self.data.dtype

    def row_ids(self):
        """Expand indptr to per-entry row ids (the segment ids of the
        row reductions)."""
        pos = torch.arange(self.nnz, dtype=self.indptr.dtype, device=self.indptr.device)
        return torch.searchsorted(self.indptr, pos, right=True) - 1


@dataclasses.dataclass
class COO:
    """Coordinate format. row/col/data: (nnz,). Rows assumed sorted unless
    stated (coo_sort provides the ordering pass ≙ cusparseXcoosort)."""

    row: Any
    col: Any
    data: Any
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[-1]

    @property
    def dtype(self):
        return self.data.dtype


@dataclasses.dataclass
class BSR:
    """Block CSR: indptr (mb+1,), indices (nnzb,), data (nnzb, bs, bs)."""

    indptr: Any
    indices: Any
    data: Any
    shape: tuple[int, int]
    blocksize: int

    @property
    def nnzb(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class BlockedELL:
    """Blocked-ELL (≙ cusparseCreateBlockedEll): fixed number of column
    blocks per block-row. cols: (mb, ellw) block-column ids (-1 = pad),
    data: (mb, ellw, bs, bs); every stored block is a dense tile."""

    cols: Any
    data: Any
    shape: tuple[int, int]
    blocksize: int

    @property
    def ellwidth(self) -> int:
        return self.cols.shape[1]


@dataclasses.dataclass
class SELL:
    """Sliced-ELLPACK (≙ cusparseCreateSlicedEll, spmv_sell/spsv_sell):
    rows grouped in slices of ``slice_height``; each slice padded to its own
    max row length. data/cols: (nslices, slice_height, width_max) with
    per-slice valid width in ``widths`` (padding: col clamped, val 0)."""

    cols: Any          # (nslices, sh, wmax) int32
    data: Any          # (nslices, sh, wmax)
    widths: Any        # (nslices,) int32: valid width per slice
    shape: tuple[int, int]
    slice_height: int

    @classmethod
    def from_dense(cls, a, slice_height: int = 8):
        """Built on the host; lands on ``a``'s device when it is a tensor,
        else on ``default_device()``."""
        dev = default_device()
        if isinstance(a, torch.Tensor):
            dev = a.device
            a = a.detach().cpu().numpy()
        an = np.asarray(a)
        m, n = an.shape
        sh = slice_height
        nslices = -(-m // sh)
        row_nnz = (an != 0).sum(axis=1)
        wmax = max(int(row_nnz.max()), 1)
        cols = np.full((nslices, sh, wmax), n - 1, np.int32)
        data = np.zeros((nslices, sh, wmax), an.dtype)
        widths = np.zeros(nslices, np.int32)
        for s in range(nslices):
            rows = range(s * sh, min((s + 1) * sh, m))
            widths[s] = max(max((int(row_nnz[r]) for r in rows), default=1), 1)
            for li, r in enumerate(rows):
                js = np.nonzero(an[r])[0]
                cols[s, li, :len(js)] = js
                data[s, li, :len(js)] = an[r, js]
        return cls(torch.from_numpy(cols).to(dev), torch.from_numpy(data).to(dev),
                   torch.from_numpy(widths).to(dev), (m, n), sh)
