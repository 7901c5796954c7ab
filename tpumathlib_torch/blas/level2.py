"""cuBLAS Level-2 helpers that Level-3 needs.

Counterpart of the storage helpers of ``tpumathlib/blas/level2.py``
(``sym_full``, ``herm_full``, ``tri_full``, ``_op``): symmetric, Hermitian
and triangular ops only *reference* one triangle, and these rebuild the
implied full matrix so that a dense product can follow. The rest of
Level-2 is still to be ported.
"""

from __future__ import annotations

import torch


def sym_full(a, uplo: str = "L"):
    """Full symmetric matrix from the referenced triangle."""
    if uplo.upper() == "L":
        return torch.tril(a) + torch.tril(a, -1).mT
    return torch.triu(a) + torch.triu(a, 1).mT


def herm_full(a, uplo: str = "L"):
    """Full Hermitian matrix from the referenced triangle (diag imag dropped)."""
    if uplo.upper() == "L":
        t = torch.tril(a, -1)
    else:
        t = torch.triu(a, 1).conj().mT  # make t strictly lower
        a = a.conj().mT
    d = torch.diag_embed(torch.diagonal(a, dim1=-2, dim2=-1).real.to(a.dtype))
    return t + d + t.conj().mT


def tri_full(a, uplo: str = "L", diag: str = "N"):
    """Referenced triangle of a triangular matrix; unit diagonal if diag='U'."""
    t = torch.tril(a) if uplo.upper() == "L" else torch.triu(a)
    if diag.upper() == "U":
        n = a.shape[-1]
        t = t - torch.diag_embed(torch.diagonal(t, dim1=-2, dim2=-1)) \
            + torch.eye(n, dtype=a.dtype, device=a.device)
    return t


def _op(a, trans: str):
    trans = trans.upper()
    if trans == "N":
        return a
    if trans == "T":
        return a.mT
    if trans == "C":
        return a.mH
    raise ValueError(f"bad trans {trans}")
