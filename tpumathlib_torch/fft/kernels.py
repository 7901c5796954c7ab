"""FFT engines over the last axis, and the planar (re, im) transforms the
plans run.

Counterpart of ``tpumathlib/fft/kernels.py``:
- the four-step (Bailey) factorisation with its DFT stages as matrix
  products (``_fft_planar``; N = N1·N2, stage 1 over N1, twiddle, stage 2
  over N2, index transpose; recursion above 128). These are plain products
  in the reference too (XLA-level, HIGHEST precision), so here they are
  ``torch.matmul`` with f32 products pinned for the call (``_mm``), so a
  caller's TF32 setting does not reach them;
- ``mxu_fft``/``mxu_fftn``/``mxu_rfft``/``mxu_irfft`` on complex tensors;
- the planar engines: ``fft_axis_planar`` sends power-of-two N ≥ 256 to
  ``stockham.dif_fft`` (kernel B5, ``csrc/fft_dif.cu`` on the card) and any
  other N to ``_fft_planar``; ``rfft_planar``/``irfft_planar`` carry two
  real rows in one complex row for even batches; ``fftn_planar``,
  ``rfftn_planar`` and ``irfftn_planar`` walk the trailing axes.

- ``pallas_fft`` (kernel B5b), the same transform in one launch of
  ``tml_four_step_fft`` (``csrc/fft_four_step.cu``, mode 1) on CUDA tensors,
  with ``_four_step_plain`` (the reference's DFT products) beside it;
  ``fft/pallas_split.py::pallas_fft2`` (B5c) runs the kernel's mode 2, cut
  at the reference's stage boundary. The kernel runs Stockham radix passes
  in registers, exchanged through shared memory, on the plan of
  ``_four_step_plan``; every twiddle comes from one device table of the N
  roots ω_N^j (``_roots_on``).

Every table reaches the device once, cached by (n, inverse, device)
(``_dft_on``, ``_twiddle_on``, ``_roots_on``), so no call copies from the
host.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.fft import stockham

F32 = torch.float32
FOUR_STEP_MAX_N = 16384   # the largest N of the four-step kernel (the reference's range)


def _best_split(n: int) -> tuple[int, int]:
    """Factor n = n1·n2 with n1, n2 as close to sqrt(n) (MXU-tile friendly)."""
    best = None
    for n1 in range(int(math.isqrt(n)), 0, -1):
        if n % n1 == 0:
            best = (n1, n // n1)
            break
    return best


@functools.lru_cache(maxsize=64)
def _dft_mats(n: int, inverse: bool):
    """(re, im) of the n×n DFT matrix as numpy f32 (cached host-side)."""
    k = np.arange(n)
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * np.outer(k, k) / n)
    return np.ascontiguousarray(w.real.astype(np.float32)), np.ascontiguousarray(w.imag.astype(np.float32))


@functools.lru_cache(maxsize=64)
def _twiddle(n1: int, n2: int, inverse: bool):
    k1 = np.arange(n1)
    n2r = np.arange(n2)
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * np.outer(k1, n2r) / (n1 * n2))
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _roots(n: int, inverse: bool):
    """ω_N^j for j < n, (n, 2) f32 interleaved (re, im), built in float64."""
    sign = 2.0 if inverse else -2.0
    w = np.exp(sign * 1j * np.pi * np.arange(n) / n)
    return np.ascontiguousarray(np.stack([w.real, w.imag], axis=-1).astype(np.float32))


@functools.lru_cache(maxsize=64)
def _dft_on(n: int, inverse: bool, device: torch.device):
    """(re, im) of the n×n DFT matrix on the device, copied once."""
    return tuple(torch.from_numpy(t).to(device) for t in _dft_mats(n, inverse))


@functools.lru_cache(maxsize=64)
def _twiddle_on(n1: int, n2: int, inverse: bool, device: torch.device):
    """(re, im) of the (n1, n2) twiddle ω_N^{k1·n2} on the device, copied once."""
    return tuple(torch.from_numpy(t).to(device) for t in _twiddle(n1, n2, inverse))


@functools.lru_cache(maxsize=64)
def _roots_on(n: int, inverse: bool, device: torch.device):
    """The (n, 2) root table of ``_roots`` on the device, copied once."""
    return torch.from_numpy(_roots(n, inverse)).to(device)


@contextlib.contextmanager
def _f32_products():
    """Full f32 matmul products inside, whatever the caller set (the
    reference pins HIGHEST); the caller's TF32 settings come back after.
    A caller who mixed torch's legacy and new precision APIs cannot have
    its float32 matmul precision read back, so then only ``allow_tf32`` is
    pinned: that alone decides cuBLAS's TF32."""
    matmul = torch.backends.cuda.matmul
    tf32 = matmul.allow_tf32
    try:
        precision = torch.get_float32_matmul_precision()
    except RuntimeError:
        precision = None
    if precision is not None:
        torch.set_float32_matmul_precision("highest")
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        if precision is not None:
            torch.set_float32_matmul_precision(precision)
        matmul.allow_tf32 = tf32


def _mm(a, b):
    """a @ b with full f32 products. The guard sets process-wide flags, so
    it is not thread-safe: a matmul in another thread during the call sees
    TF32 off, and a setting another thread makes meanwhile is overwritten
    when the caller's comes back."""
    with _f32_products():
        return torch.matmul(a, b)


def _cmatmul(ar, ai, br, bi):
    """Planar complex matmul with 3 real products (Karatsuba)."""
    t1 = _mm(ar, br)
    t2 = _mm(ai, bi)
    t3 = _mm(ar + ai, br + bi)
    return t1 - t2, t3 - t1 - t2


def _fft_planar(xr, xi, inverse: bool):
    """Planar-complex FFT over the last axis; any composite N."""
    n = xr.shape[-1]
    if n <= 128 or _best_split(n)[0] == 1:
        # direct DFT-as-matmul (or prime size): x @ Wᵀ; W symmetric so W==Wᵀ
        return _cmatmul(xr, xi, *_dft_on(n, inverse, xr.device))
    n1, n2 = _best_split(n)
    batch = tuple(xr.shape[:-1])
    ar = xr.reshape(batch + (n1, n2))
    ai = xi.reshape(batch + (n1, n2))
    # stage 1: DFT over n1 → B[k1, n2] = Σ_n1 W1[k1,n1] A[n1,n2]
    if n1 <= 128:
        br, bi = _cmatmul(*_dft_on(n1, inverse, xr.device), ar, ai)
    else:
        # recurse along n1: transpose to (..., n2, n1), fft, transpose back
        rr, ri = _fft_planar(ar.transpose(-1, -2), ai.transpose(-1, -2), inverse)
        br, bi = rr.transpose(-1, -2), ri.transpose(-1, -2)
    # twiddle: C[k1, n2] = B[k1, n2] · ω^{k1·n2}
    twr, twi = _twiddle_on(n1, n2, inverse, xr.device)
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    # stage 2: DFT over n2 → D[k1, k2] = Σ_n2 C[k1,n2] W2[n2,k2]
    if n2 <= 128:
        dr, di = _cmatmul(cr, ci, *_dft_on(n2, inverse, xr.device))
    else:
        dr, di = _fft_planar(cr, ci, inverse)
    # output index k = k2·n1 + k1 → transpose (k1,k2) → (k2,k1) then flatten
    dr = dr.transpose(-1, -2).reshape(batch + (n,))
    di = di.transpose(-1, -2).reshape(batch + (n,))
    return dr, di


# ---------------- the four-step in one or two launches (B5b, B5c) ----------------

def _four_step_plain(xr, xi, inverse: bool):
    """B5b's and B5c's plain version: the reference's stage order with f32
    products. Stage 1 over n1 as Aᵀ·W1 in (n2, k1) layout, the twiddle, stage
    2 over n2 as W2·Cᵀ, whose (k2, k1) rows flatten to k = k2·n1 + k1. Any
    leading batch; f32 planes out."""
    check(xi.shape == xr.shape, "xr and xi must have one shape")
    n = xr.shape[-1]
    n1, n2 = _best_split(n)
    dev = xr.device
    rows = math.prod(xr.shape[:-1])
    ar = xr.to(F32).reshape(rows, n1, n2).mT
    ai = xi.to(F32).reshape(rows, n1, n2).mT
    br, bi = _cmatmul(ar, ai, *_dft_on(n1, inverse, dev))
    twr, twi = (t.mT for t in _twiddle_on(n1, n2, inverse, dev))
    cr, ci = br * twr - bi * twi, br * twi + bi * twr
    dr, di = _cmatmul(*_dft_on(n2, inverse, dev), cr, ci)
    return dr.reshape(xr.shape), di.reshape(xr.shape)


# The kernel's two families (csrc/fft_four_step.cu): points a thread for a
# power-of-two N >= 4 (radices 2, 4, 8, 16) and for any other N (also 3, 5,
# direct passes and the copy that N = 1 and mode 2's n1 = 1 need).
FOUR_STEP_POINTS_POW2 = 16
FOUR_STEP_POINTS_MIXED = 64
FOUR_STEP_BLOCK = 256              # rows share a block up to this many threads
FOUR_STEP_SMEM = 232448            # shared memory a block may use on the H100
REGISTER_RADICES = (2, 3, 4, 5, 8, 16)


class FourStepLaunch(NamedTuple):
    """One launch of the four-step kernel: ``lanes`` interleaved transforms
    of ``length`` points a row (point p of lane v at p·lanes + v)."""
    length: int
    lanes: int
    threads: int      # a row's threads
    rows: int         # rows a block
    points: int       # points a thread; picks the kernel family
    radices: tuple    # the passes, in order; product == length


class FourStepPlan(NamedTuple):
    mode: int
    n1: int
    n2: int
    launches: tuple            # FourStepLaunch, one a kernel launch
    words: ctypes.Array        # the plan as the C entry point reads it (int32)


def _radix_passes(length: int) -> tuple[int, ...]:
    """Radices whose product is ``length``: as many 16s as divide it, the
    power of two left (8, 4 or 2), then 3s and 5s (radix passes held in
    registers), then each other prime factor once a pass (a direct pass:
    one sum of that many terms an output)."""
    out, m = [], length
    while m % 16 == 0:
        out.append(16)
        m //= 16
    for r in (8, 4, 2):
        if m % r == 0:
            out.append(r)
            m //= r
            break
    for r in (3, 5):
        while m % r == 0:
            out.append(r)
            m //= r
    p = 7
    while m > 1:
        if p * p > m:
            p = m
        while m % p == 0:
            out.append(p)
            m //= p
        p += 2
    return tuple(out)


def _four_step_plane_floats(n: int, lanes: int, to_scratch: bool) -> int:
    """Floats of one plane of a row in the kernel's shared memory (as the C
    side sizes it): the row with one float of padding after every 32, or
    mode 2's first launch's Cᵀ with rows of n1 + 1; a multiple of 32."""
    return -(-max(n + n // 32 + 1, n + (lanes if to_scratch else 0)) // 32) * 32


def _four_step_launch(length: int, lanes: int, to_scratch: bool) -> FourStepLaunch:
    n = length * lanes
    points = FOUR_STEP_POINTS_POW2 if n >= 4 and n & (n - 1) == 0 else FOUR_STEP_POINTS_MIXED
    threads = -(-n // points)
    row_bytes = 4 * (2 * _four_step_plane_floats(n, lanes, to_scratch) + 1)
    rows = max(1, min(FOUR_STEP_BLOCK // threads, FOUR_STEP_SMEM // row_bytes))
    return FourStepLaunch(length, lanes, threads, rows, points, _radix_passes(length))


@functools.lru_cache(maxsize=128)
def _four_step_plan(n: int, mode: int) -> FourStepPlan:
    """The kernel's plan for rows of n points. Mode 1: one launch, the whole
    length-n transform. Mode 2: two launches cut at (n1, n2) =
    ``_best_split(n)``: the length-n1 transforms of the n2 columns with the
    twiddle ω_N^{k1·n2}, then the length-n2 transforms of the n1 rows."""
    check(n >= 1 and mode in (1, 2), f"no four-step plan for n = {n}, mode {mode}")
    n1, n2 = _best_split(n)
    launches = ((_four_step_launch(n, 1, False),) if mode == 1 else
                (_four_step_launch(n1, n2, True), _four_step_launch(n2, n1, False)))
    words = [mode, n1, n2]
    for lp in launches:
        words += [lp.length, lp.lanes, lp.threads, lp.rows, lp.points, len(lp.radices),
                  *lp.radices]
    return FourStepPlan(mode, n1, n2, launches, (ctypes.c_int32 * len(words))(*words))


def _four_step_cuda(xr, xi, inverse: bool, mode: int, counter):
    """``tml_four_step_fft`` on CUDA planes, on the plan of
    ``_four_step_plan(N, mode)``: mode 1 is one launch, mode 2 two through a
    device scratch of 2·b·N f32. The forward root table serves both
    directions (the kernel conjugates in and out for the inverse).
    ``counter.launches`` grows by the launches made. Raises for N above
    ``FOUR_STEP_MAX_N`` and on a failed launch."""
    n = xr.shape[-1]
    check(xi.shape == xr.shape and xi.device == xr.device,
          "xr and xi must have one shape and one device")
    check(1 <= n <= FOUR_STEP_MAX_N,
          f"the four-step kernel takes 1 <= N <= {FOUR_STEP_MAX_N}, not N = {n}; "
          "fft_axis_planar transforms any N")
    dev = xr.device
    xr32, xi32 = xr.to(F32).contiguous(), xi.to(F32).contiguous()
    y = torch.empty((2,) + tuple(xr.shape), dtype=F32, device=dev)
    rows = y[0].numel() // n
    if rows:
        plan = _four_step_plan(n, mode)
        scratch = torch.empty(2 * rows * n, dtype=F32, device=dev) if mode == 2 else None
        lib = cuda_utils.load_kernels()
        with torch.cuda.device(dev):
            rc = lib.tml_four_step_fft(
                xr32.data_ptr(), xi32.data_ptr(), y[0].data_ptr(), y[1].data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                _roots_on(n, False, dev).data_ptr(), rows, plan.n1, plan.n2, mode,
                int(inverse), plan.words, len(plan.words),
                torch.cuda.current_stream(dev).cuda_stream)
        cuda_utils.check_launch(lib, rc, "tml_four_step_fft")
        counter.launches += mode
    return y[0], y[1]


def pallas_fft(xr, xi, inverse: bool = False, tile: int = 32):
    """Fused planar-complex FFT over the last axis (kernel B5b): the
    unnormalised DFT (and inverse) in natural order. Planes are cast to f32,
    any leading batch. On CUDA tensors one launch of ``tml_four_step_fft``
    (the radix passes of ``_four_step_plan(N, 1)``) for N ≤ 16384 (the
    reference's documented range; larger N raises); CPU tensors take
    ``_four_step_plain``, the reference's four-step with N = n1·n2 =
    ``_best_split(N)``, at any N. ``tile`` sizes the reference's VMEM block
    and changes nothing here."""
    if not on_cuda(xr, xi):
        return _four_step_plain(xr, xi, inverse)
    return _four_step_cuda(xr, xi, inverse, 1, pallas_fft)


pallas_fft.launches = 0


def mxu_fft(x, inverse: bool = False):
    """Unnormalized C2C FFT over the last axis via matmul stages.

    complex64 in/out; matches cuFFT forward/inverse (no 1/N on inverse).
    """
    x = x.to(torch.complex64)
    yr, yi = _fft_planar(x.real, x.imag, inverse)
    return torch.complex(yr, yi)


def mxu_fftn(x, axes=None, inverse: bool = False):
    """N-D C2C via per-axis FFTs (trailing axes by default)."""
    if axes is None:
        axes_len = x.ndim
    else:
        axes = sorted(a % x.ndim for a in axes)
        check(axes == list(range(x.ndim - len(axes), x.ndim)), "mxu_fftn transforms trailing axes")
        axes_len = len(axes)
    for ax in range(x.ndim - 1, x.ndim - 1 - axes_len, -1):
        x = mxu_fft(torch.movedim(x, ax, -1), inverse=inverse).movedim(-1, ax)
    return x


def mxu_rfft(x):
    """R2C via full complex transform, truncated spectrum."""
    n = x.shape[-1]
    return mxu_fft(x)[..., : n // 2 + 1]


def mxu_irfft(y, n: int):
    """C2R inverse (unnormalized)."""
    # rebuild the Hermitian-symmetric full spectrum
    tail = torch.conj(torch.flip(y[..., 1: (n + 1) // 2], dims=(-1,)))
    full = torch.cat([y[..., : n // 2 + 1], tail], dim=-1)
    return mxu_fft(full, inverse=True).real


# ---------------- planar (re, im) engines ----------------

def _pow2_engine(n: int) -> bool:
    return n >= 256 and (n & (n - 1)) == 0


def fft_axis_planar(xr, xi, inverse: bool = False, half: bool = False):
    """Planar C2C over the LAST axis; routes to the fastest engine.

    ``half=True`` selects the bf16-plane mode of ``dif_fft`` (half the
    plane bytes; f32 inside; ~4e-3 rel-L2). Non-pow2 shapes ignore it."""
    n = xr.shape[-1]
    if _pow2_engine(n):
        return stockham.dif_fft(xr, xi, inverse=inverse, halfplanes=half)
    return _fft_planar(xr, xi, inverse)


def fftn_planar(xr, xi, naxes: int, inverse: bool = False, half: bool = False):
    """Planar C2C over the trailing ``naxes`` axes. Every axis but the last
    is moved last for its transform, so ``dif_fft`` copies its rows into a
    contiguous layout first."""
    for ax in range(-1, -naxes - 1, -1):
        yr, yi = fft_axis_planar(torch.movedim(xr, ax, -1), torch.movedim(xi, ax, -1),
                                 inverse, half=half)
        xr = torch.movedim(yr, -1, ax)
        xi = torch.movedim(yi, -1, ax)
    return xr, xi


def _reversed_spectrum(z):
    """z[..., (-k) mod n] for every k: z[0], then z[n-1], ..., z[1]."""
    return torch.cat([z[..., :1], torch.flip(z[..., 1:], dims=(-1,))], dim=-1)


def rfft_planar(x, half: bool = False):
    """R2C over the last axis: real f32 → planar half spectrum
    (..., n//2+1). Unnormalized forward (cuFFT convention).
    ``half=True`` runs the internal C2C on bf16 planes (~4e-3 rel-L2); the
    untangle math stays f32.

    Even batches (pow2 N ≥ 256) use the two-for-one packing: row i and row
    i + batch/2 ride one complex row (z = a + i·b, A = (Z + Z̄rev)/2,
    B = (Z − Z̄rev)/2i); the public row order is unchanged."""
    n = x.shape[-1]
    x = x.float()
    h = n // 2 + 1
    if x.ndim >= 2 and x.shape[-2] % 2 == 0 and _pow2_engine(n):
        bh = x.shape[-2] // 2
        zr, zi = fft_axis_planar(x[..., :bh, :], x[..., bh:, :], half=half)
        # half mode: bf16 planes out of the C2C; the untangle runs in f32
        dt = zr.dtype
        zr_rev = _reversed_spectrum(zr)[..., :h].float()
        zi_rev = _reversed_spectrum(zi)[..., :h].float()
        zr = zr[..., :h].float()
        zi = zi[..., :h].float()
        ar = (0.5 * (zr + zr_rev)).to(dt)
        ai = (0.5 * (zi - zi_rev)).to(dt)
        br = (0.5 * (zi + zi_rev)).to(dt)
        bi = (0.5 * (zr_rev - zr)).to(dt)
        return torch.cat([ar, br], dim=-2), torch.cat([ai, bi], dim=-2)
    yr, yi = fft_axis_planar(x, torch.zeros_like(x), half=half)
    return yr[..., :h].float(), yi[..., :h].float()


def _hermitian_full(yr, yi, n: int):
    """Half spectrum (..., n//2+1) → full (..., n) by conj symmetry."""
    tr = torch.flip(yr[..., 1:(n + 1) // 2], dims=(-1,))
    ti = -torch.flip(yi[..., 1:(n + 1) // 2], dims=(-1,))
    return (torch.cat([yr[..., :n // 2 + 1], tr], dim=-1),
            torch.cat([yi[..., :n // 2 + 1], ti], dim=-1))


def irfft_planar(yr, yi, n: int, half: bool = False):
    """C2R over the last axis: planar half spectrum (..., n//2+1) → real
    f32 (..., n). Unnormalized inverse (ifft(fft(x)) == N·x). ``half=True``
    runs the internal C2C on bf16 planes.

    Even batches (pow2 N ≥ 256) use the two-for-one inverse: Z = A_full +
    i·B_full, z = IFFT(Z), a = Re z, b = Im z."""
    if yr.ndim >= 2 and yr.shape[-2] % 2 == 0 and _pow2_engine(n):
        bh = yr.shape[-2] // 2
        ar, ai = _hermitian_full(yr[..., :bh, :], yi[..., :bh, :], n)
        br, bi = _hermitian_full(yr[..., bh:, :], yi[..., bh:, :], n)
        dt = yr.dtype
        pr = (ar.float() - bi.float()).to(dt)
        pi = (ai.float() + br.float()).to(dt)
        zr, zi = fft_axis_planar(pr, pi, inverse=True, half=half)
        return torch.cat([zr, zi], dim=-2).float()
    fr, fi = _hermitian_full(yr, yi, n)
    zr, _ = fft_axis_planar(fr, fi, inverse=True, half=half)
    return zr.float()


def rfftn_planar(x, naxes: int, half: bool = False):
    """N-D R2C (trailing axes; last axis halved) — planar output."""
    yr, yi = rfft_planar(x, half=half)
    if naxes > 1:
        yr2, yi2 = fftn_planar(torch.movedim(yr, -1, 0), torch.movedim(yi, -1, 0),
                               naxes - 1, half=half)
        yr, yi = torch.movedim(yr2, 0, -1), torch.movedim(yi2, 0, -1)
    return yr, yi


def irfftn_planar(yr, yi, shape: tuple, half: bool = False):
    """N-D C2R inverse of rfftn_planar (unnormalized)."""
    naxes = len(shape)
    if naxes > 1:
        yr2, yi2 = fftn_planar(torch.movedim(yr, -1, 0), torch.movedim(yi, -1, 0),
                               naxes - 1, inverse=True, half=half)
        yr, yi = torch.movedim(yr2, 0, -1), torch.movedim(yi2, 0, -1)
    return irfft_planar(yr, yi, shape[-1], half=half)
