"""tpumathlib_torch — the port of tpumathlib to PyTorch and CUDA on an
NVIDIA H100 (sm_90a).

The JAX package ``tpumathlib`` stays the reference; this package mirrors its
module paths and public names, imports ``torch`` and never ``jax``. Each
TPU kernel of the reference becomes a kernel written by hand for Hopper
(``csrc/``), with its plain PyTorch version beside it for CPU tensors.

Ported so far (the GEMM slice, the Cholesky / no-pivot LU slice, the QR
slice, the FFT slice, the Blocked-ELL sparse slice, the cuSolverDx tier, the
nvCOMPDx tier, the fused GEMM → FFT, the cuRAND tier with the in-kernel RNG,
the VV10 pair kernels, and the Mp tier's tensor-parallel matmul):
- ``tpumathlib_torch.core``       — errors, dtype traits, checks, timer,
                                    plans, autotune cache, interop, and the
                                    one default device (the card)
- ``tpumathlib_torch.dx``         — the tiled GEMM with fused epilogues, the
                                    batched small solvers (B7a–B7i), the
                                    cascaded codec (B8a–B8c) and, in
                                    ``dx.fused``, ``gemm_fft`` (B9); in
                                    ``dx.rng`` the in-kernel uniforms and
                                    dropout matmul (B10a, B10b); in
                                    ``dx.vv10`` the VV10 pair sweeps (B11)
- ``tpumathlib_torch.rand``       — the cuRAND generators (Philox, threefry,
                                    xorwow, MRG32k3a, MT19937, MTGP32,
                                    Sobol) and distributions, bit for bit
                                    the reference's
- ``tpumathlib_torch.comp``       — the device-resident cascaded and lossy
                                    codecs (the host codecs are not ported)
- ``tpumathlib_torch.blas``       — Level-3, the Lt descriptor engine, and the
                                    Level-2 helpers they need
- ``tpumathlib_torch.heuristics`` — roofline model + discovery
- ``tpumathlib_torch.entry``      — the entry points: the main path's GEMM
                                    and ``dryrun_multichip``
- ``tpumathlib_torch.mp``         — process grids of ranks (several may
                                    share a card), the TP matmul and its
                                    collectives, gemr2d, the row-sharded
                                    PBLAS ops; in ``mp.overlap`` the
                                    ring-overlapped AG+GEMM and GEMM+RS
                                    (B12a, B12b)
- ``tpumathlib_torch.solver``     — xpotrf/xgetrf/xgeqrf/xtrtri drivers and
                                    the blocked factorizations they route
                                    to on the card (kernels B2, B3, B4a,
                                    B4b)
- ``tpumathlib_torch.fft``        — cuFFT-style plans (C2C/R2C/C2R, planar
                                    and complex), the planar engines and
                                    ``dif_fft`` (kernel B5)
- ``tpumathlib_torch.sparse``     — sparse containers and conversions,
                                    SpMV/SpMM/SDDMM, ``SpmvPlan`` and the
                                    CSR auto-plan, SpSV; the Blocked-ELL
                                    SpMM and SpMV (kernels B6a, B6b/B6c)
"""

__version__ = "0.1.0"

from tpumathlib_torch.core import errors, dtypes  # noqa: F401
from tpumathlib_torch import fft  # noqa: F401
from tpumathlib_torch import sparse  # noqa: F401
