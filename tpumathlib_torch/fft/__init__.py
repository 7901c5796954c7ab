"""fft — the cuFFT capability surface on the card.

Counterpart of ``tpumathlib/fft``:
- plan:     cuFFT-style plan/exec lifecycle (plan_1d/2d/3d/many, C2C/R2C/
            C2R, batched, fwd/inv) with plan cache and load/store callbacks
- kernels:  the planar engines and the matmul four-step
- stockham: ``dif_fft``, kernel B5 (``csrc/fft_dif.cu``)

The distributed decompositions (``fft/distributed.py``) are not ported yet.
"""

from tpumathlib_torch.fft.plan import (  # noqa: F401
    Direction,
    FftDescriptor,
    FftPlan,
    FftType,
    fft,
    ifft,
    irfft,
    plan_1d,
    plan_2d,
    plan_3d,
    plan_many,
    rfft,
)
from tpumathlib_torch.fft.stockham import dif_fft  # noqa: F401
