"""solver — the cuSOLVER capability surface of the port (counterpart of
``tpumathlib/solver``).

Ported so far: the Cholesky / LU / QR / triangular-inverse drivers of
``dense`` and the blocked factorizations they route to on the card
(``onelaunch``, kernels B2 and B3, with the sweep of ``blocked``;
``qr_onelaunch``, kernels B4a and B4b).
"""

from tpumathlib_torch.solver import dense  # noqa: F401
from tpumathlib_torch.solver.dense import (  # noqa: F401
    potrf_batched, xgeqrf, xgetrf, xgetrs, xorgqr, xormqr, xpotrf, xpotrs, xtrtri,
)
from tpumathlib_torch.solver.onelaunch import getrf_onelaunch, potrf_onelaunch  # noqa: F401
from tpumathlib_torch.solver.qr_onelaunch import (  # noqa: F401
    geqrf_onelaunch, orgqr_onelaunch, qr_onelaunch,
)
