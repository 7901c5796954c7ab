"""Fused device-side compositions (≙ the MathDx fusion examples): kernel B9.

Counterpart of ``tpumathlib/dx/fused.py``. ``gemm_fft`` is one kernel
launch on the card (``csrc/dx_fused.cu``): it computes the product of a tile
of A's rows with B, applies the epilogue, and transforms each row of the
tile by in-block Stockham radix passes (``csrc/stockham_passes.cuh``, the
FFT's own 5·n·log2 n flop a row), so the product C never reaches device
memory. Two routes by one size rule, ``_gemm_fft_route``: n ≤ 256 takes
``tml_gemm_fft`` (64 rows a block, the product in 3xTF32 on the tensor
cores from A in f32 and the TF32 planes of Bᵀ, which the same C call
splits first); a wider n ``tml_gemm_fft_simt`` (16 rows a block,
the product in f32 FMA). Both read the table of the n roots
(``fft.kernels._roots_on``) and the plan of ``_gemm_fft_plan``. The other
four functions compose separate kernels, as in the reference:
``gemm_fft_composed`` and ``gemm_gemm`` go through B1 (``pallas_matmul``),
``fft_convolution`` and ``fft_convolution_nd`` through the planar FFT engines
(B5, ``dif_fft``, for power-of-two axes of 256 or more).

``gemm_fft`` keeps a fault of the reference for parity (ROADMAP C14): only
the strings ``"relu"`` and ``"gelu"`` select an epilogue; any other string,
``"gelu_bias"`` included, silently selects none, while
``gemm_fft_composed`` hands the same string to ``pallas_matmul``.

On CPU tensors ``gemm_fft``'s wrapper takes ``_gemm_fft_plain`` (the
reference's DFT products, three products with f32 pinned,
``fft.kernels._mm``); on CUDA tensors it launches a kernel or raises.
``_gemm_fft.launches`` counts the launches, ``.tc_launches`` and
``.simt_launches`` each route's. ``bm`` sizes the reference's VMEM tile and
changes nothing here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpumathlib_torch.core.dtypes import cdiv
from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils, tf32x3
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import pallas_matmul
from tpumathlib_torch.fft.kernels import (
    FOUR_STEP_POINTS_POW2, FourStepLaunch, _dft_on, _fft_planar, _mm, _radix_passes, _roots_on,
    fftn_planar, irfft_planar, rfft_planar)

F32 = torch.float32
# epilogue codes of csrc/dx_fused.cu; any other string is none (C14)
_ACT_CODE = {"relu": 1, "gelu": 2}
GEMM_FFT_TC_MAX_N = 256       # the tensor-core route's widest n: 64 rows of n in shared memory
GEMM_FFT_POINTS_MIXED = 32    # points a thread for n not a power of two >= 4 (168 registers)


def _epilogue(c, epilogue: str):
    """The reference's epilogue of gemm_fft: exact strings only."""
    if epilogue == "relu":
        return torch.clamp_min(c, 0.0)
    if epilogue == "gelu":
        k0, k1 = 0.7978845608028654, 0.044715
        return 0.5 * c * (1.0 + torch.tanh(k0 * (c + k1 * c * c * c)))
    return c


def _gemm_fft_plain(a, b, wr, wi, epilogue: str):
    """B9's plain version: C = epilogue(A @ B), then (C @ Wr, C @ Wi), f32
    products."""
    c = _epilogue(_mm(a, b), epilogue)
    return _mm(c, wr), _mm(c, wi)


class GemmFftPlan(NamedTuple):
    launch: FourStepLaunch     # the passes of one row, as fft.kernels's four-step plans them
    words: ctypes.Array        # (n, threads, points, npasses, radices...), int32


@functools.lru_cache(maxsize=64)
def _gemm_fft_plan(n: int) -> GemmFftPlan:
    """The row FFT's plan for ``csrc/dx_fused.cu``: ``_radix_passes(n)``, 16
    points a thread for a power-of-two n ≥ 4 and 32 for any other n, n /
    points threads a row (the kernels take rows a group at a time, so
    ``rows`` is 1 here)."""
    pow2 = n >= 4 and n & (n - 1) == 0
    points = FOUR_STEP_POINTS_POW2 if pow2 else GEMM_FFT_POINTS_MIXED
    launch = FourStepLaunch(n, 1, cdiv(n, points), 1, points, _radix_passes(n))
    words = [n, launch.threads, points, len(launch.radices), *launch.radices]
    return GemmFftPlan(launch, (ctypes.c_int32 * len(words))(*words))


def _gemm_fft_route(n: int) -> str:
    """The size rule: "tc" (``tml_gemm_fft``) where 64 rows of n fit the
    ring's shared memory as the passes read them, n ≤ 256; else "simt"
    (``tml_gemm_fft_simt``, 16 rows a block). m and k do not enter: A and Bᵀ
    stream through the ring."""
    return "tc" if n <= GEMM_FFT_TC_MAX_N else "simt"


def _gemm_fft(a, b, epilogue: str, route: str = None):
    """B9 on f32 A (m, k) and B (k, n): planar (yr, yi), (m, n) f32. CUDA
    tensors launch the route of ``_gemm_fft_route`` (or ``route``, which
    chip_smoke.py uses to run every shape on the SIMT route): "tc" has the C
    side split Bᵀ into its TF32 planes (``tml_split_tf32``, counted on
    ``tf32x3.split_tf32.launches``) in a scratch allocated here, then launch
    the kernel in the same call, and reads A in place where TMA can
    (``tf32x3.tma_ready``), else a copy with a row stride of a multiple of
    4."""
    m, k = a.shape
    n = b.shape[1]
    if not on_cuda(a, b):
        return _gemm_fft_plain(a, b, *_dft_on(n, False, a.device), epilogue)
    check(b.device == a.device, "A and B on one device")
    route = route or _gemm_fft_route(n)
    check(route in ("tc", "simt") and (route == "simt" or n <= GEMM_FFT_TC_MAX_N),
          f"no gemm_fft route {route!r} at n = {n}")
    yr, yi = torch.empty((2, m, n), dtype=F32, device=a.device)
    if m and n:
        lib = cuda_utils.load_kernels()
        plan = _gemm_fft_plan(n)
        act = _ACT_CODE.get(epilogue, 0)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            roots = _roots_on(n, False, a.device)
            if route == "tc":
                b = b.contiguous()
                bt = tf32x3.planes(n, k, a.device)   # the C side writes Bᵀ's planes here
                if not tf32x3.tma_ready(a):
                    a = torch.empty((m, cdiv(max(k, 1), 4) * 4), dtype=F32,
                                    device=a.device)[:, :k].copy_(a)
                rc = lib.tml_gemm_fft(a.data_ptr(), a.stride(0), b.data_ptr(), bt[0].data_ptr(),
                                      bt[1].data_ptr(), bt.stride(1), roots.data_ptr(),
                                      plan.words, len(plan.words), yr.data_ptr(), yi.data_ptr(),
                                      m, k, n, act, stream)
            else:
                a, b = a.contiguous(), b.contiguous()
                rc = lib.tml_gemm_fft_simt(a.data_ptr(), b.data_ptr(), roots.data_ptr(),
                                           plan.words, len(plan.words), yr.data_ptr(),
                                           yi.data_ptr(), m, k, n, act, stream)
        name = "tml_gemm_fft" if route == "tc" else "tml_gemm_fft_simt"
        cuda_utils.check_launch(lib, rc, name)
        _gemm_fft.launches += 1
        if route == "tc":
            _gemm_fft.tc_launches += 1
            tf32x3.split_tf32.launches += int(k > 0)
        else:
            _gemm_fft.simt_launches += 1
    return yr, yi


_gemm_fft.launches = 0
_gemm_fft.tc_launches = 0
_gemm_fft.simt_launches = 0


def gemm_fft(a, b, epilogue: str = "default", bm: int = 256):
    """FFT(epilogue(A@B)) along the output rows in one kernel (≙ cuBLASDx
    13_gemm_fft): the product tile stays in shared memory through the
    epilogue and the row FFT's radix passes. Returns planar (re, im), f32
    (m, n).

    n and k must be at most 1024, as in the reference, whose kernel holds B
    and the two n×n DFT matrices in VMEM; use ``gemm_fft_composed``
    beyond."""
    m, k = a.shape
    k2, n = b.shape
    check(k == k2, "inner dims must match")
    check(n <= 1024 and k <= 1024,
          "fused gemm_fft holds B and the DFT matrices in VMEM: n, k <= "
          "1024 (use gemm_fft_composed beyond)")
    return _gemm_fft(a.to(F32), b.to(F32), epilogue)


def gemm_fft_composed(a, b, epilogue: str = "default"):
    """GEMM → row FFT as a composition of separate kernels (the product
    round-trips device memory between them). Returns planar (re, im)."""
    c = pallas_matmul(a, b, epilogue=epilogue, out_dtype=F32)
    return _fft_planar(c, torch.zeros_like(c), inverse=False)


def gemm_gemm(a, b, c):
    """(A@B)@C (≙ 14_gemm_fused): two GEMM kernels, the intermediate product
    in device memory between them."""
    return pallas_matmul(pallas_matmul(a, b, out_dtype=F32), c, out_dtype=F32)


def fft_convolution(x, kernel):
    """Circular convolution along the last axis by rFFT → pointwise product →
    irFFT (≙ cuFFTDx 06_convolution). Real inputs, real output; the kernel
    broadcasts over the batch."""
    n = x.shape[-1]
    xr, xi = rfft_planar(x)
    kr, ki = rfft_planar(kernel)
    yr = xr * kr - xi * ki
    yi = xr * ki + xi * kr
    # irfft_planar is unnormalized (cuFFT convention): divide by n
    return irfft_planar(yr, yi, n) / n


def fft_convolution_nd(x, kernel, naxes: int = 3):
    """Circular convolution over the trailing ``naxes`` axes by planar C2C
    FFTs (≙ cuFFTDx 07_convolution_3d). Real inputs and output; leading axes
    of ``x`` beyond ``kernel``'s rank broadcast as batch."""
    shape = tuple(x.shape[-naxes:])
    check(tuple(kernel.shape[-naxes:]) == shape, "kernel trailing dims must match x")
    x32, k32 = x.to(F32), kernel.to(F32)
    xr, xi = fftn_planar(x32, torch.zeros_like(x32), naxes)
    kr, ki = fftn_planar(k32, torch.zeros_like(k32), naxes)
    yr = xr * kr - xi * ki
    yi = xr * ki + xi * kr
    out_r, _ = fftn_planar(yr, yi, naxes, inverse=True)
    scale = 1.0
    for d in shape:
        scale *= d
    return out_r / scale
