"""Numerical verification helpers, on tensors or arrays.

Counterpart of ``tpumathlib/core/check.py``:
- ``allclose_host`` with max_abs/max_rel reporting (cuBLASMp/helpers.h:1300-1362)
- relative L2/Linf error checks (cuFFTMp/samples/common/error_checks.hpp:43-69)

Tensors are copied to the host first; the comparison itself is numpy, in
f64 (or c128), so a check never depends on the device's arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumathlib_torch.core.dtypes import default_rtol
from tpumathlib_torch.core.interop import to_numpy, torch_dtype


def _wide(got, want):
    g, w = to_numpy(got), to_numpy(want)
    dt = np.complex128 if np.iscomplexobj(w) or np.iscomplexobj(g) else np.float64
    return g.astype(dt), w.astype(dt)


def max_abs_rel(got, want) -> tuple[float, float]:
    """(max_abs_diff, max_rel_diff) — the report printed by allclose_host
    (cuBLASMp/helpers.h:1340-1361)."""
    g, w = _wide(got, want)
    diff = np.abs(g - w)
    denom = np.maximum(np.abs(w), 1e-30)
    return float(diff.max(initial=0.0)), float((diff / denom).max(initial=0.0))


def max_scaled_err(got, want) -> float:
    """max|got - want| / max(max|want|, 1): the quantity ``allclose`` holds
    under ``rtol``."""
    g, w = _wide(got, want)
    scale = max(np.abs(w).max(initial=0.0), 1.0)
    return float(np.abs(g - w).max(initial=0.0) / scale)


def rel_l2(got, want) -> float:
    """Relative L2 error (≙ error_checks.hpp:61-69)."""
    g, w = _wide(got, want)
    nw = np.linalg.norm(w.ravel())
    return float(np.linalg.norm((g - w).ravel()) / max(nw, 1e-300))


def rel_linf(got, want) -> float:
    g, w = _wide(got, want)
    mw = np.abs(w).max(initial=0.0)
    return float(np.abs(g - w).max(initial=0.0) / max(mw, 1e-300))


def _default_rtol(got) -> float:
    dt = got.dtype if isinstance(got, torch.Tensor) else torch_dtype(np.asarray(got).dtype)
    return default_rtol(dt)


def allclose(got, want, rtol: float | None = None, atol: float = 0.0) -> bool:
    """Max-scaled closeness: every |got - want| <= atol + rtol·max(max|want|, 1)."""
    if rtol is None:
        rtol = _default_rtol(got)
    g, w = _wide(got, want)
    scale = max(np.abs(w).max(initial=0.0), 1.0)
    return bool(np.all(np.abs(g - w) <= atol + rtol * scale))


def assert_allclose(got, want, rtol: float | None = None, atol: float = 0.0, msg: str = ""):
    """Assert with the allclose_host-style max_abs/max_rel report."""
    if rtol is None:
        rtol = _default_rtol(got)
    if not allclose(got, want, rtol=rtol, atol=atol):
        ma, mr = max_abs_rel(got, want)
        raise AssertionError(
            f"{msg} FAILED: max_abs={ma:.3e} max_rel={mr:.3e} rtol={rtol:.1e} atol={atol:.1e}"
        )
