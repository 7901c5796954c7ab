"""mp — the distributed tier (≙ cuBLASMp), counterpart of ``tpumathlib/mp``.

One process drives every rank of a ``Grid``, as the reference's single
controller drives every device of its mesh; a card may hold several ranks.
Collectives are copies between the ranks' pieces.

- grid:    process grids, ``Sharded`` operands, block-cyclic helpers
           (≙ cublasMpGridCreate, numroc)
- matmul:  TP matmul — AllGather+GEMM, GEMM+ReduceScatter, GEMM+AllReduce,
           the TP-MLP cycle, gemr2d (≙ tp_matmul.cu / matmul_ag / _rs / _ar)
- overlap: the ring-overlapped AllGather+GEMM and GEMM+ReduceScatter
           (kernels B12a, B12b; not exported here, as in the reference)
- pblas:   the row-sharded PBLAS ops

``mp.cyclic`` (2D block-cyclic: BlockCyclic, gemr2d_12/_21, summa_gemm,
syrk_2d, potrf_2d, getrf_2d, syevd_2d) and ``mp.solver`` are not ported yet.
"""

from tpumathlib_torch.mp.grid import Grid, block_cyclic_spec, numroc  # noqa: F401
from tpumathlib_torch.mp.matmul import (  # noqa: F401
    matmul_ag,
    matmul_allreduce,
    matmul_rs,
    tp_matmul,
)
from tpumathlib_torch.mp.pblas import (  # noqa: F401
    mp_geadd,
    mp_symm,
    mp_syr2k,
    mp_syrk,
    mp_syrkx,
    mp_tradd,
    mp_trmm,
    mp_trsm,
)
