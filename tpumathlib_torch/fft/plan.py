"""cuFFT-style plan/exec lifecycle.

Counterpart of ``tpumathlib/fft/plan.py`` (≙ cufftPlan1d/2d/3d/Many and
cufftExecC2C/R2C/C2R):
- the planar (re, im) path runs ``fft.kernels``' planar engines, which send
  every power-of-two axis of length ≥ 256 to ``dif_fft`` (kernel B5);
- the complex-dtype path is the vendor path, ``torch.fft``, as ``jnp.fft``
  is in the reference.
``pre``/``post`` callbacks (≙ cuFFT load/store callbacks) are composed
around the transform. Normalisation follows cuFFT: unnormalised forward AND
inverse (ifft(fft(x)) == N·x); ``norm`` lets callers opt into NumPy
semantics. PyTorch runs eagerly, so a plan holds plain callables.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Sequence

import torch

from tpumathlib_torch.core.errors import NotSupportedError, check
from tpumathlib_torch.core.plan import PlanCache
from tpumathlib_torch.fft import kernels


class FftType(enum.Enum):
    C2C = "c2c"
    R2C = "r2c"
    C2R = "c2r"
    # double-precision aliases (Z2Z/D2Z/Z2D) select via dtype argument


class Direction(enum.Enum):
    FORWARD = -1
    INVERSE = 1


_plan_cache = PlanCache(maxsize=128)


@dataclasses.dataclass(frozen=True)
class FftDescriptor:
    shape: tuple[int, ...]      # transform dims (fastest-varying last)
    fft_type: FftType
    batch: int = 1
    norm: str | None = None     # None = cuFFT unnormalized; "ortho"|"backward"
    # "f32" (default) or "bf16": bf16 planes on the planar engines (half the
    # plane bytes, ~4e-3 rel-L2; ≙ cuFFT half-precision plans); the
    # butterflies accumulate in f32
    precision: str = "f32"


class FftPlan:
    """An FFT plan (≙ cufftHandle after cufftMakePlan*).

    Call with ``plan(x)`` or ``plan(x, Direction.INVERSE)``."""

    def __init__(self, desc: FftDescriptor,
                 pre: Callable | None = None, post: Callable | None = None):
        self.desc = desc
        self.pre = pre
        self.post = post
        self._fwd = self._build(Direction.FORWARD)
        self._inv = self._build(Direction.INVERSE)
        self._fwd_planar = self._build_planar(Direction.FORWARD)
        self._inv_planar = self._build_planar(Direction.INVERSE)

    def _build_planar(self, direction: Direction):
        """Planar-complex (re, im) path on the planar engines: C2C (planar
        pair in/out), R2C (real in → planar half spectrum), and C2R (planar
        half spectrum in → real out)."""
        desc, pre, post = self.desc, self.pre, self.post
        naxes = len(desc.shape)
        inverse = direction == Direction.INVERSE
        half = desc.precision == "bf16"

        def _norm_scale():
            # the planar engines are unnormalized in BOTH directions
            # (cuFFT convention):
            #   ortho    → 1/√N each direction
            #   backward → NumPy semantics: 1/N on the inverse only
            if desc.norm is None:
                return 1.0
            ntot = float(math.prod(desc.shape))
            if desc.norm == "ortho":
                return ntot ** -0.5
            if desc.norm == "backward":
                return 1.0 / ntot if inverse else 1.0
            raise NotSupportedError(f"unknown norm {desc.norm!r}")

        if desc.fft_type == FftType.R2C:
            def run_r2c(x):
                check(direction == Direction.FORWARD, "R2C is forward-only")
                if pre is not None:
                    x = pre(x)
                yr, yi = kernels.rfftn_planar(x, naxes, half=half)
                s = _norm_scale()
                if s != 1.0:
                    yr, yi = yr * s, yi * s
                if post is not None:
                    yr, yi = post((yr, yi))
                return yr, yi

            return run_r2c

        if desc.fft_type == FftType.C2R:
            def run_c2r(xr, xi):
                check(direction == Direction.INVERSE, "C2R is inverse-only")
                if pre is not None:
                    xr, xi = pre((xr, xi))
                y = kernels.irfftn_planar(xr, xi, desc.shape, half=half)
                s = _norm_scale()
                if s != 1.0:
                    y = y * s
                if post is not None:
                    y = post(y)
                return y

            return run_c2r

        def run(xr, xi):
            if pre is not None:
                xr, xi = pre((xr, xi))
            xr, xi = kernels.fftn_planar(xr, xi, naxes, inverse, half=half)
            s = _norm_scale()
            if s != 1.0:
                xr, xi = xr * s, xi * s
            if post is not None:
                xr, xi = post((xr, xi))
            return xr, xi

        return run

    def _build(self, direction: Direction):
        desc, pre, post = self.desc, self.pre, self.post
        axes = tuple(range(-len(desc.shape), 0))

        def run(x):
            if pre is not None:
                x = pre(x)
            inv_norm = "forward" if desc.norm is None else None
            if desc.fft_type == FftType.C2C:
                y = (torch.fft.fftn(x, dim=axes) if direction == Direction.FORWARD
                     else torch.fft.ifftn(x, dim=axes, norm=inv_norm))
            elif desc.fft_type == FftType.R2C:
                check(direction == Direction.FORWARD, "R2C is forward-only")
                y = torch.fft.rfftn(x, dim=axes)
            else:  # C2R
                check(direction == Direction.INVERSE, "C2R is inverse-only")
                y = torch.fft.irfftn(x, s=desc.shape, dim=axes, norm=inv_norm)
            if desc.norm == "ortho":
                n = float(math.prod(desc.shape))
                y = y * (n ** (-0.5) if direction == Direction.FORWARD else n ** 0.5)
            if post is not None:
                y = post(y)
            return y

        return run

    def __call__(self, x, direction: Direction = Direction.FORWARD,
                 planar: bool = False):
        """Execute the plan.

        Planar spellings:
        - C2C: pass ``x`` as a (re, im) tuple → returns (re, im).
        - C2R: pass the half spectrum as a (re, im) tuple → returns real.
        - R2C: pass the real tensor with ``planar=True`` → returns (re, im)
          of the half spectrum.
        Otherwise the complex-dtype path (``torch.fft``) runs.
        """
        if isinstance(x, (tuple, list)):  # planar (re, im) input
            check(self.desc.fft_type in (FftType.C2C, FftType.C2R),
                  "planar tuple input is C2C or C2R")
            f = self._fwd_planar if direction == Direction.FORWARD else self._inv_planar
            return f(*x)
        if planar:
            check(self.desc.fft_type == FftType.R2C,
                  "planar single-array input is the R2C spelling")
            return self._fwd_planar(x)
        return self._fwd(x) if direction == Direction.FORWARD else self._inv(x)

    # cufftExec* aliases
    def forward(self, x):
        return self._fwd(x)

    def inverse(self, x):
        return self._inv(x)


def _make_plan(shape, fft_type, batch=1, norm=None, pre=None, post=None,
               precision="f32") -> FftPlan:
    check(precision in ("f32", "bf16"), f"unknown precision {precision!r}")
    desc = FftDescriptor(tuple(shape), fft_type, batch, norm, precision)
    if pre is None and post is None:
        return _plan_cache.get_or_build((desc,), lambda: FftPlan(desc))
    return FftPlan(desc, pre, post)


def plan_1d(n: int, fft_type: FftType = FftType.C2C, batch: int = 1, **kw) -> FftPlan:
    """≙ cufftPlan1d(&plan, n, CUFFT_C2C, batch)."""
    return _make_plan((n,), fft_type, batch, **kw)


def plan_2d(nx: int, ny: int, fft_type: FftType = FftType.C2C, **kw) -> FftPlan:
    return _make_plan((nx, ny), fft_type, 1, **kw)


def plan_3d(nx: int, ny: int, nz: int, fft_type: FftType = FftType.C2C, **kw) -> FftPlan:
    return _make_plan((nx, ny, nz), fft_type, 1, **kw)


def plan_many(shape: Sequence[int], fft_type: FftType = FftType.C2C,
              batch: int = 1, **kw) -> FftPlan:
    """≙ cufftPlanMany (advanced layout collapses to batched leading dims)."""
    return _make_plan(tuple(shape), fft_type, batch, **kw)


# ---- convenience one-shots (plan-cached) ----

def fft(x, axes=None):
    axes = axes if axes is not None else (x.ndim - 1,)
    shape = tuple(x.shape[a] for a in axes)
    return plan_many(shape, FftType.C2C)(x)


def ifft(x, axes=None):
    axes = axes if axes is not None else (x.ndim - 1,)
    shape = tuple(x.shape[a] for a in axes)
    return plan_many(shape, FftType.C2C)(x, Direction.INVERSE)


def rfft(x, axes=None):
    axes = axes if axes is not None else (x.ndim - 1,)
    shape = tuple(x.shape[a] for a in axes)
    return plan_many(shape, FftType.R2C)(x)


def irfft(x, shape, axes=None):
    return plan_many(tuple(shape), FftType.C2R)(x, Direction.INVERSE)
