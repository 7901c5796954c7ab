"""dx — the port's kernel library (counterpart of ``tpumathlib/dx``).

Each TPU kernel of the reference becomes a kernel written by hand for
Hopper, under ``tpumathlib_torch/csrc``, with its plain PyTorch version
beside it. This slice holds the tiled GEMM with fused epilogues.
"""

from tpumathlib_torch.dx.gemm import pallas_matmul, MatmulConfig  # noqa: F401
