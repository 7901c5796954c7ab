"""solver — the cuSOLVER capability surface of the port (counterpart of
``tpumathlib/solver``).

Ported so far: the Cholesky / LU / triangular-inverse drivers of ``dense``
and the blocked one-launch factorizations they route to on the card
(``onelaunch``, kernels B2 and B3, with the sweep of ``blocked``).
"""

from tpumathlib_torch.solver import dense  # noqa: F401
from tpumathlib_torch.solver.dense import (  # noqa: F401
    potrf_batched, xgetrf, xgetrs, xpotrf, xpotrs, xtrtri,
)
from tpumathlib_torch.solver.onelaunch import getrf_onelaunch, potrf_onelaunch  # noqa: F401
