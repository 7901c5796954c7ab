"""Status codes and error types.

Counterpart of ``tpumathlib/core/errors.py``, with the same semantics: the
CHECK macro family (CUDA_CHECK / CUBLAS_CHECK, cuBLAS/utils/cublas_utils.h)
becomes a small exception hierarchy plus a ``check`` helper used by
descriptor validation throughout the package.
"""

from __future__ import annotations

import enum


class Status(enum.Enum):
    """Library status codes (≙ CUBLAS_STATUS_* / CUSPARSE_STATUS_*)."""

    SUCCESS = 0
    NOT_INITIALIZED = 1
    INVALID_VALUE = 2
    NOT_SUPPORTED = 3
    EXECUTION_FAILED = 4
    INTERNAL_ERROR = 5
    ALLOC_FAILED = 6


class TpuMathError(Exception):
    """Base error for the suite."""

    status = Status.INTERNAL_ERROR


class InvalidValueError(TpuMathError, ValueError):
    status = Status.INVALID_VALUE


class NotSupportedError(TpuMathError, NotImplementedError):
    status = Status.NOT_SUPPORTED


class ExecutionError(TpuMathError, RuntimeError):
    status = Status.EXECUTION_FAILED


def check(cond: bool, msg: str, err: type = InvalidValueError) -> None:
    """Validate a descriptor/argument invariant (≙ CHECK macros)."""
    if not cond:
        raise err(msg)
