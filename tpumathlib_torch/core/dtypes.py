"""Dtype traits for the port, keyed by torch dtypes.

Counterpart of ``tpumathlib/core/dtypes.py``: the ``traits<T>`` structs of
cuBLAS/utils/cublas_utils.h and the dtype-dependent verification rtol of
cuBLASMp/matmul.h:579 (``matmul_default_rtol``). The same rtol table; the
reference's TPU tiling table (``min_tile``) and its bf16 hi/lo split have
no counterpart on the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class DtypeTraits:
    dtype: Any
    name: str
    is_complex: bool
    is_float: bool
    itemsize: int
    # dtype-dependent verification tolerance (≙ matmul_default_rtol,
    # cuBLASMp/matmul.h:579): half/bf16 ~1e-2, fp8 ~1e-1, f32 ~1e-5, f64 ~1e-12.
    rtol: float
    # accumulation dtype of a product over this dtype
    acc_dtype: Any


_TRAITS: dict[torch.dtype, DtypeTraits] = {}


def _reg(dtype: torch.dtype, name: str, rtol: float, acc=torch.float32):
    _TRAITS[dtype] = DtypeTraits(
        dtype=dtype,
        name=name,
        is_complex=dtype.is_complex,
        is_float=dtype.is_floating_point,
        itemsize=dtype.itemsize,
        rtol=rtol,
        acc_dtype=acc,
    )


_reg(torch.float64, "f64", 1e-12, torch.float64)
_reg(torch.float32, "f32", 1e-5)
_reg(torch.bfloat16, "bf16", 1e-2)
_reg(torch.float16, "f16", 1e-2)
_reg(torch.float8_e4m3fn, "e4m3", 1.25e-1)
_reg(torch.float8_e5m2, "e5m2", 2.5e-1)
_reg(torch.int8, "i8", 0.0, torch.int32)
_reg(torch.int32, "i32", 0.0, torch.int32)
_reg(torch.complex64, "c64", 1e-5)
_reg(torch.complex128, "c128", 1e-12, torch.complex128)


def traits(dtype: torch.dtype) -> DtypeTraits:
    if dtype not in _TRAITS:
        _reg(dtype, str(dtype).removeprefix("torch."), 1e-5)
    return _TRAITS[dtype]


def default_rtol(*dtypes) -> float:
    """Verification rtol for an op over the given operand dtypes — the loosest
    operand wins (≙ cuBLASMp/matmul.h:579 keyed on A/B/C types)."""
    return max(traits(d).rtol for d in dtypes) or 1e-5


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Real counterpart of a complex dtype (c64→f32, c128→f64)."""
    if dtype == torch.complex64:
        return torch.float32
    if dtype == torch.complex128:
        return torch.float64
    return dtype


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def random_array(gen: torch.Generator, shape, dtype: torch.dtype,
                 kind: str = "uniform"):
    """Test-data generator (≙ generate_random_vector / diagonally-dominant
    matrix gen, cublas_utils.h:269-306). ``kind``: uniform | normal | posdef |
    diagdom. Drawn on ``gen``'s device."""
    shape = tuple(shape)
    dev = gen.device

    def draw(f, dt=torch.float32):
        return f(shape, generator=gen, dtype=dt, device=dev)

    if kind == "posdef":
        n = shape[-1]
        a = draw(torch.randn)
        m = a @ a.mT / n + 2.0 * torch.eye(n, device=dev)
        return m.to(dtype)
    if kind == "diagdom":
        n = shape[-1]
        return (draw(torch.rand) + n * torch.eye(n, device=dev)).to(dtype)
    f = torch.randn if kind == "normal" else torch.rand
    if dtype.is_complex:
        rdt = real_dtype(dtype)
        return torch.complex(draw(f, rdt), draw(f, rdt)).to(dtype)
    if not dtype.is_floating_point:
        return torch.randint(-4, 5, shape, generator=gen, device=dev).to(dtype)
    return draw(f).to(dtype)
