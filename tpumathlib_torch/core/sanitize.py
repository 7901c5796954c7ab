"""Numeric sanitizer layer.

Counterpart of ``tpumathlib/core/sanitize.py``: surface NaN/Inf production
and out-of-bounds indexing as errors instead of silent garbage, the
memcheck/initcheck analogue. The reference instruments the function with
``jax.experimental.checkify``; here the checks are plain torch reductions
on what goes in and comes out:

- after the call, every floating-point tensor of the output (a tensor, or
  a tuple/list/dict of them) must be finite;
- before the call, every index tensor that the wrapper names, with its
  bound, must lie in ``[0, bound)``.

Either failure raises ``ExecutionError``. ``sanitize(fn)`` is a no-op
unless ``TPUMATHLIB_CHECKIFY=1`` is set (or ``force=True``), so production
paths pay nothing; when on, each check reads one scalar back from the
device.
"""

from __future__ import annotations

import functools
import os

import torch

from tpumathlib_torch.core.errors import ExecutionError


def sanitizing() -> bool:
    return os.environ.get("TPUMATHLIB_CHECKIFY", "0") == "1"


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


def check_finite(out, what: str = "output") -> None:
    """Raise ExecutionError when a floating-point tensor in ``out`` holds a
    NaN or an Inf."""
    for t in _tensors(out):
        if (t.is_floating_point() or t.is_complex()) and not bool(torch.isfinite(t).all()):
            raise ExecutionError(f"sanitize: non-finite value in the {what}")


def check_indices(idx: torch.Tensor, bound: int, what: str = "index") -> None:
    """Raise ExecutionError when an entry of ``idx`` lies outside [0, bound)."""
    if idx.numel() and not bool(((idx >= 0) & (idx < bound)).all()):
        raise ExecutionError(f"sanitize: {what} outside [0, {bound})")


def sanitize(fn=None, *, force: bool = False, indices=None):
    """Decorator: check ``fn``'s output (and the index tensors that
    ``indices(*args, **kwargs)`` yields as ``(what, tensor, bound)``) when
    sanitizing() or force."""

    def wrap(f):
        @functools.wraps(f)
        def run(*args, **kwargs):
            if not (force or sanitizing()):
                return f(*args, **kwargs)
            if indices is not None:
                for what, idx, bound in indices(*args, **kwargs):
                    check_indices(idx, bound, what)
            out = f(*args, **kwargs)
            check_finite(out, f"output of {f.__name__}")
            return out

        return run

    return wrap(fn) if fn is not None else wrap
