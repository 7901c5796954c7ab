"""dx — the port's kernel library (counterpart of ``tpumathlib/dx``).

Each TPU kernel of the reference becomes a kernel written by hand for
Hopper, under ``tpumathlib_torch/csrc``, with its plain PyTorch version
beside it. This package holds the tiled GEMM with fused epilogues
(``dx.gemm``) and the cuSolverDx tier's batched small factorizations and
solves (``dx.solver``: potrf, getrf, geqrf, gesv and posv over a batch of
small matrices, one thread block a matrix, and the blocked Cholesky that
composes them with the GEMM) and the nvCOMPDx tier's cascaded codec
(``dx.comp``: encode, decode, and decode fused with a product).
``dx.fused`` (the fused GEMM → FFT and its compositions), ``dx.rng`` (the
in-kernel Philox uniforms and the matmul with in-kernel dropout) and
``dx.vv10`` (the VV10 pairwise energy and its hand-derived gradient) are
not exported here, as in the reference.
"""

from tpumathlib_torch.dx.gemm import pallas_matmul, MatmulConfig  # noqa: F401
from tpumathlib_torch.dx.solver import (  # noqa: F401
    geqrf_batched,
    gesv_batched,
    getrf_batched,
    posv_batched,
    potrf_batched,
    potrf_blocked,
)
from tpumathlib_torch.dx.comp import (  # noqa: F401
    dx_compress,
    dx_decompress,
    dx_decompress_dot,
    dx_required_bits,
)
