"""Fused device-side compositions (≙ the MathDx fusion examples): kernel B9.

Counterpart of ``tpumathlib/dx/fused.py``. ``gemm_fft`` is one kernel,
``tml_gemm_fft`` in ``csrc/dx_fused.cu``: it computes the product of a tile
of A's rows with B, applies the epilogue, and transforms each row of the
tile by two DFT products, so the product C never reaches device memory. The
other four functions compose separate kernels, as in the reference:
``gemm_fft_composed`` and ``gemm_gemm`` go through B1 (``pallas_matmul``),
``fft_convolution`` and ``fft_convolution_nd`` through the planar FFT engines
(B5, ``dif_fft``, for power-of-two axes of 256 or more).

``gemm_fft`` keeps a fault of the reference for parity (ROADMAP C14): only
the strings ``"relu"`` and ``"gelu"`` select an epilogue; any other string,
``"gelu_bias"`` included, silently selects none, while
``gemm_fft_composed`` hands the same string to ``pallas_matmul``.

On CPU tensors ``gemm_fft``'s wrapper takes ``_gemm_fft_plain`` (three
products with f32 pinned, ``fft.kernels._mm``); on CUDA tensors it launches
the kernel or raises, and ``_gemm_fft.launches`` counts the launches. ``bm``
sizes the reference's VMEM tile and changes nothing here.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import pallas_matmul
from tpumathlib_torch.fft.kernels import (
    _dft_on, _fft_planar, _mm, fftn_planar, irfft_planar, rfft_planar)

F32 = torch.float32
# epilogue codes of csrc/dx_fused.cu; any other string is none (C14)
_ACT_CODE = {"relu": 1, "gelu": 2}


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


def _gemm_fft(a, b, wr, wi, epilogue: str):
    """B9 through ``tml_gemm_fft`` on f32 A (m, k), B (k, n) and the DFT
    matrices (n, n): planar (yr, yi), (m, n) f32."""
    if not on_cuda(a, b):
        return _gemm_fft_plain(a, b, wr, wi, epilogue)
    check(b.device == a.device, "A and B on one device")
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    yr = torch.empty((m, n), dtype=F32, device=a.device)
    yi = torch.empty_like(yr)
    if m and n:
        lib = cuda_utils.load_kernels()
        with torch.cuda.device(a.device):
            rc = lib.tml_gemm_fft(a.data_ptr(), b.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                                  yr.data_ptr(), yi.data_ptr(), m, k, n,
                                  _ACT_CODE.get(epilogue, 0),
                                  torch.cuda.current_stream(a.device).cuda_stream)
        cuda_utils.check_launch(lib, rc, "tml_gemm_fft")
        _gemm_fft.launches += 1
    return yr, yi


_gemm_fft.launches = 0


def gemm_fft(a, b, epilogue: str = "default", bm: int = 256):
    """FFT(epilogue(A@B)) along the output rows in one kernel (≙ cuBLASDx
    13_gemm_fft): the product tile stays in shared memory through the
    epilogue and both DFT products. Returns planar (re, im), f32 (m, n).

    n and k must be at most 1024, as in the reference, whose kernel holds B
    and the two n×n DFT matrices in VMEM; use ``gemm_fft_composed``
    beyond."""
    m, k = a.shape
    k2, n = b.shape
    check(k == k2, "inner dims must match")
    check(n <= 1024 and k <= 1024,
          "fused gemm_fft holds B and the DFT matrices in VMEM: n, k <= "
          "1024 (use gemm_fft_composed beyond)")
    wr, wi = _dft_on(n, False, a.device)
    return _gemm_fft(a.to(F32), b.to(F32), wr, wi, epilogue)


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
