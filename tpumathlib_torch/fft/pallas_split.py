"""The four-step FFT in two kernels (B5c): stage 1 with the twiddle, then
stage 2 with the digit reversal.

Counterpart of ``tpumathlib/fft/pallas_split.py``. The reference runs two
pallas_calls whose intermediate C (b, n2, k1) round-trips device memory; here
the same two stages are the two launches of ``tml_four_step_fft`` in mode 2
(``csrc/fft_four_step.cu``): the radix passes of n1 over the n2 columns with
the twiddle, then those of n2, with Cᵀ in a device scratch of 2·b·N f32. The
plan, the root table and the plain version are those of ``fft/kernels.py``.
"""

from __future__ import annotations

from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.fft.kernels import _four_step_cuda, _four_step_plain


def pallas_fft2(xr, xi, inverse: bool = False, tile: int = 256):
    """Planar C2C FFT over the last axis, N = n1·n2 ≤ 16384, in two launches
    on CUDA tensors (``pallas_fft2.launches`` grows by 2); CPU tensors take
    ``_four_step_plain``. Unnormalised inverse, natural order, f32 planes.
    ``tile`` sizes the reference's VMEM block and changes nothing here."""
    if not on_cuda(xr, xi):
        return _four_step_plain(xr, xi, inverse)
    return _four_step_cuda(xr, xi, inverse, 2, pallas_fft2)


pallas_fft2.launches = 0
