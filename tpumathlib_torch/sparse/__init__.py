"""sparse — the cuSPARSE capability surface on PyTorch + CUDA.

Counterpart of ``tpumathlib/sparse``, the part of it that is ported:
- containers: CSR / COO / BSR / Blocked-ELL / SELL with **static nnz
  capacity** (padding entries carry zero values and clamped indices)
- ops:      SpMV, SpMM (+batched), SDDMM, axpby/gather/scatter/rot/spvv
- pallas_kernels: the Blocked-ELL SpMM (kernel B6a, ``csrc/bell_wgmma.cu``)
  and ``SpmvPlan``, whose execute runs the Blocked-ELL SpMV (kernel B6b/B6c,
  ``csrc/bell_sparse.cu``)
- autoplan: ``SpmvAutoPlan``, the CSR pattern analysis that repacks into
  Blocked-ELL or SELL
- spsv:     level-scheduled sparse triangular solve + SpSM
- convert:  dense↔CSR/COO/Blocked-ELL, CSR→Blocked-ELL, prune, coosort
- hostcsr:  the host-side numpy CSR toolkit

Not ported yet (native-backed in the reference): spgemm, tridiag, the
preconditioned solvers (cg/bicgstab/ic0/ilu0), lsq and sparselt.
"""

from tpumathlib_torch.sparse.containers import CSR, COO, BSR, BlockedELL, SELL  # noqa: F401
from tpumathlib_torch.sparse.ops import (  # noqa: F401
    spmv, spmm, sddmm, sddmm_bsr, axpby, sp_gather, sp_scatter, sp_rot, spvv,
)
from tpumathlib_torch.sparse.pallas_kernels import (  # noqa: F401
    SpmvPlan, bell_spmm_pallas, bell_spmv_pallas,
)
from tpumathlib_torch.sparse.autoplan import SpmvAutoPlan  # noqa: F401
from tpumathlib_torch.sparse.spsv import SpSvPlan, spsv, spsv_plan, spsm  # noqa: F401
from tpumathlib_torch.sparse.convert import (  # noqa: F401
    dense_to_csr, dense_to_coo, csr_to_dense, coo_to_dense, coo_sort,
    dense_to_blocked_ell, blocked_ell_to_dense, csr_to_blocked_ell, csr_to_coo,
    coo_to_csr, prune_dense,
)
