"""solver — the cuSOLVER capability surface of the port (counterpart of
``tpumathlib/solver``).

Ported so far: the drivers of ``dense`` apart from xgesvdp, xgesvdr and
xgeev; the blocked factorizations they route to on the card
(``onelaunch``, kernels B2 and B3, with the sweep of ``blocked``;
``qr_onelaunch``, kernels B4a and B4b); the opt-in blocked-panel Cholesky
``potrf_blocked`` (B4c, ``blocked``); and ``jacobi`` (one-sided gesvdj and
two-sided syevj/sygvj, batched variants included).
"""

from tpumathlib_torch.solver import dense, jacobi  # noqa: F401
from tpumathlib_torch.solver.blocked import potrf_blocked  # noqa: F401
from tpumathlib_torch.solver.dense import (  # noqa: F401
    potrf_batched, xgeqrf, xgesvd, xgetrf, xgetrs, xorgqr, xormqr, xpotrf, xpotrs, xsyevd,
    xsyevdx, xsygvd, xtrtri,
)
from tpumathlib_torch.solver.jacobi import (  # noqa: F401
    gesvdj, gesvdj_batched, syevj, syevj_batched, sygvj,
)
from tpumathlib_torch.solver.onelaunch import getrf_onelaunch, potrf_onelaunch  # noqa: F401
from tpumathlib_torch.solver.qr_onelaunch import (  # noqa: F401
    geqrf_onelaunch, orgqr_onelaunch, qr_onelaunch,
)
