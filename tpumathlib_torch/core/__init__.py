"""Core plumbing: error types, dtype traits, plan/handle objects, verification
helpers, the numeric sanitizer, bench timers, the autotune cache, and data
exchange with the JAX package (counterpart of ``tpumathlib/core``)."""

from tpumathlib_torch.core.errors import (  # noqa: F401
    Status,
    TpuMathError,
    InvalidValueError,
    NotSupportedError,
    ExecutionError,
    check,
)
from tpumathlib_torch.core.dtypes import traits, default_rtol  # noqa: F401
from tpumathlib_torch.core.check import (  # noqa: F401
    allclose,
    max_abs_rel,
    max_scaled_err,
    rel_l2,
    rel_linf,
    assert_allclose,
)
from tpumathlib_torch.core.sanitize import sanitize, sanitizing  # noqa: F401
from tpumathlib_torch.core.timer import benchmark  # noqa: F401
from tpumathlib_torch.core.plan import Handle, Plan, PlanCache  # noqa: F401
from tpumathlib_torch.core.tuning import AutotuneCache  # noqa: F401
from tpumathlib_torch.core.interop import from_numpy, from_reference, to_numpy  # noqa: F401
