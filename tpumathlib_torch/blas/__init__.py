"""blas — cuBLAS-class surface of the port: the Level-2 helpers that Level-3
needs, Level-3, and the Lt descriptor engine (counterpart of
``tpumathlib/blas``)."""

from tpumathlib_torch.blas import level2, level3, lt  # noqa: F401
