"""Planar C2C FFT over the last axis for power-of-two N ≥ 256 (kernel B5).

Counterpart of ``tpumathlib/fft/stockham.py::dif_fft``, with its signature,
output contract and tables. On CUDA tensors ``dif_fft`` launches
``tml_dif_fft`` (``csrc/fft_dif.cu``: radix-2 decimation in frequency, one
thread block per row in shared memory, the output written straight into the
order asked for); on CPU tensors it takes ``_dif_fft_plain``, the reference's
arithmetic in torch. Unnormalised in both directions, as cuFFT is.

The output orders:
- ``reorder=True``: natural frequency order;
- ``reorder=False``: the reference's raw order. Its radix-2 stages stop at
  groups of L = 128·collapse, each transformed by one L-point DFT, so
  frequency f = p·G + r (G = N/L) sits at bitrev_s(r)·L + p, s = log2 G
  (``shuffle_perm``). The raw order depends on ``collapse``; pointwise
  spectral work composes in it.

``exact`` and ``tile`` are accepted and have no effect here: the kernel and
the plain version compute in f32 throughout (the reference's default
bf16x2 product is a TPU workaround), and ``tile`` sizes the TPU's VMEM
chunks. ``halfplanes=True`` takes and returns bf16 planes, with f32 inside.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda

_LANES = 128
_SEGMENT = 16384   # the longest row the kernel transforms in one block's shared memory


@functools.lru_cache(maxsize=32)
def _rowstage_twiddles(n: int, inverse: bool):
    """(nstages, n) re/im twiddles for the cross-row DIF stages (row
    distances M0/2 .. 1), indexed by the flat position j = m·128 + l."""
    m0 = n // _LANES
    j = np.arange(n)
    m, l = j // _LANES, j % _LANES
    sign = 2.0 if inverse else -2.0
    ws = []
    d = m0 // 2
    while d >= 1:
        ncur = 2 * d * _LANES
        ws.append(np.exp(sign * 1j * np.pi * ((m & (d - 1)) * _LANES + l) / ncur))
        d //= 2
    w = np.stack(ws) if ws else np.zeros((0, n), complex)
    return (np.ascontiguousarray(w.real.astype(np.float32)),
            np.ascontiguousarray(w.imag.astype(np.float32)))


@functools.lru_cache(maxsize=8)
def _dft_tables(size: int, inverse: bool):
    """f32 (size, size) DFT matrix parts for the 3M complex matmul:
    Wr, Wi, and Ws = Wr + Wi."""
    sign = 2.0 if inverse else -2.0
    jk = np.outer(np.arange(size), np.arange(size))
    w = np.exp(sign * 1j * np.pi * jk / size)
    wr = w.real.astype(np.float32)
    wi = w.imag.astype(np.float32)
    return wr, wi, (wr + wi).astype(np.float32)


def _dft128_tables(inverse: bool):
    return _dft_tables(_LANES, inverse)


@functools.lru_cache(maxsize=32)
def _bitrev(nbits: int) -> np.ndarray:
    p = np.arange(1 << nbits)
    out = np.zeros(1 << nbits, np.int32)
    for i in range(nbits):
        out |= ((p >> i) & 1) << (nbits - 1 - i)
    return out


@functools.lru_cache(maxsize=32)
def shuffle_perm(n: int, collapse: int = 1) -> np.ndarray:
    """perm with natural_order = raw_kernel_order[perm]: natural frequency
    f = p·G + r (G = M0/collapse groups, p the position inside the final
    length-128·collapse DFT) lives at raw position bitrev(r)·L + p."""
    m0 = n // _LANES
    g = m0 // collapse
    L = collapse * _LANES
    s = int(math.log2(g)) if g > 1 else 0
    j = np.arange(n)
    r = j % g
    p_ = j // g
    return (_bitrev(s)[r] * L + p_).astype(np.int32)


# retained for callers of the classic full-bitrev DIF order
@functools.lru_cache(maxsize=32)
def _bitrev_perm(n: int) -> np.ndarray:
    return _bitrev(int(math.log2(n)))


def _check_args(xr, xi, collapse: int) -> int:
    n = xr.shape[-1]
    check(n >= 2 * _LANES and (n & (n - 1)) == 0, f"N must be a power of two >= 256, not {n}")
    check(collapse >= 1 and (collapse & (collapse - 1)) == 0 and collapse <= n // _LANES,
          f"collapse must be a power of two in [1, N/128], not {collapse}")
    check(tuple(xr.shape) == tuple(xi.shape),
          f"planes of one shape, not {tuple(xr.shape)} and {tuple(xi.shape)}")
    check(xr.device == xi.device, "both planes on one device")
    return n


def _planes(xr, xi, n: int, halfplanes: bool):
    """Both planes as contiguous (rows, n) tensors of the plane type (fresh
    copies wherever a cast or a layout change is needed)."""
    dt = torch.bfloat16 if halfplanes else torch.float32
    return (xr.reshape(-1, n).to(dt).contiguous(), xi.reshape(-1, n).to(dt).contiguous())


def _dif_fft_plain(xr, xi, inverse: bool = False, reorder: bool = True, tile: int = 128,
                   exact: bool = False, collapse: int = 1, halfplanes: bool = False):
    """The reference's arithmetic in torch: stage A as roll/where butterflies
    over ``_rowstage_twiddles``, stage B as one f32 3M complex product per
    group of 128·collapse with ``_dft_tables``, then the ``shuffle_perm``
    gather when ``reorder``. Never calls ``torch.fft``."""
    n = _check_args(xr, xi, collapse)
    batch_shape = tuple(xr.shape[:-1])
    pr, pi = _planes(xr, xi, n, halfplanes)
    dev = pr.device
    vr, vi = pr.float(), pi.float()
    m0 = n // _LANES
    m_idx = torch.arange(n, device=dev) >> 7
    wr_all, wi_all = _rowstage_twiddles(n, inverse)
    d = m0 // 2
    for stage in range(int(math.log2(m0 // collapse))):
        bit = (m_idx & d) != 0
        s = d * _LANES
        wr = torch.from_numpy(wr_all[stage]).to(dev)
        wi = torch.from_numpy(wi_all[stage]).to(dev)
        dr = torch.roll(vr, s, dims=-1) - vr
        di = torch.roll(vi, s, dims=-1) - vi
        vr, vi = (torch.where(bit, dr * wr - di * wi, vr + torch.roll(vr, -s, dims=-1)),
                  torch.where(bit, dr * wi + di * wr, vi + torch.roll(vi, -s, dims=-1)))
        d //= 2
    size = _LANES * collapse
    dwr, dwi, dws = (torch.from_numpy(t).to(dev) for t in _dft_tables(size, inverse))
    ar = vr.reshape(-1, n // size, size)
    ai = vi.reshape(-1, n // size, size)
    p1 = torch.matmul(ar, dwr)
    p2 = torch.matmul(ai, dwi)
    p3 = torch.matmul(ar + ai, dws)
    yr = (p1 - p2).reshape(-1, n).to(pr.dtype)
    yi = (p3 - p1 - p2).reshape(-1, n).to(pr.dtype)
    if reorder:
        perm = torch.from_numpy(shuffle_perm(n, collapse).astype(np.int64)).to(dev)
        yr, yi = yr[:, perm], yi[:, perm]
    return yr.reshape(batch_shape + (n,)), yi.reshape(batch_shape + (n,))


@functools.lru_cache(maxsize=32)
def _kernel_twiddles(n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """(n/2, 2) f32 exp(∓2πik/n), k < n/2, built in float64 and rounded
    once; cached on the device per (n, inverse)."""
    ang = (2.0 if inverse else -2.0) * np.pi * np.arange(n // 2, dtype=np.float64) / n
    host = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(host).to(device)


def dif_fft(xr, xi, inverse: bool = False, reorder: bool = True, tile: int = 128,
            exact: bool = False, collapse: int = 1, halfplanes: bool = False):
    """Planar C2C FFT over the last axis; N = power of two ≥ 256.

    Unnormalised in both directions. ``reorder=False`` returns the raw order
    of ``shuffle_perm(N, collapse)``. The planes are cast to f32, or to bf16
    with ``halfplanes=True``, and come back in that type with the input's
    shape. The caller's tensors are never written."""
    n = _check_args(xr, xi, collapse)
    if not on_cuda(xr, xi):
        return _dif_fft_plain(xr, xi, inverse, reorder, tile, exact, collapse, halfplanes)
    batch_shape = tuple(xr.shape[:-1])
    pr, pi = _planes(xr, xi, n, halfplanes)
    rows = pr.shape[0]
    check(rows * max(1, n // _SEGMENT) < 2**31, f"{rows} rows of {n} exceed one launch's grid")
    yr, yi = torch.empty_like(pr), torch.empty_like(pi)
    scratch = (torch.empty((rows, n, 2), dtype=torch.float32, device=pr.device)
               if n > _SEGMENT else None)
    tw = _kernel_twiddles(n, inverse, pr.device)
    log_l = int(math.log2(n if reorder else _LANES * collapse))
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(pr.device):
        rc = lib.tml_dif_fft(pr.data_ptr(), pi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
                             0 if scratch is None else scratch.data_ptr(), tw.data_ptr(),
                             rows, int(math.log2(n)), log_l, int(halfplanes),
                             torch.cuda.current_stream(pr.device).cuda_stream)
    cuda_utils.check_launch(lib, rc, "tml_dif_fft")
    dif_fft.launches += 1
    return yr.reshape(batch_shape + (n,)), yi.reshape(batch_shape + (n,))


dif_fft.launches = 0
