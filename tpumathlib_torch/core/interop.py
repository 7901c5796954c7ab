"""Moving data and descriptors between the JAX package and the port.

- ``from_numpy``: numpy arrays to tensors, including the bf16 and fp8
  arrays whose dtypes come from ``ml_dtypes`` (``torch.from_numpy`` refuses
  those, so they travel as their raw bits).
- ``to_numpy``: tensors back to numpy; 16- and 8-bit floats widen to f32,
  which holds every one of their values exactly.
- ``from_reference``: a reference ``MatmulDesc``, ``Algo``,
  ``MatmulConfig``, ``MatrixLayout``, ``FftDescriptor``, ``FftType``,
  ``Direction``, sparse container (``CSR``, ``COO``, ``BSR``,
  ``BlockedELL``, ``SELL``) or ``SpmvPlan`` to the port's object. It reads
  attributes by name, enum ``.value``s and arrays through ``np.asarray``
  (bf16 arrays travel as bits), and never imports the reference. Carried
  arrays land on ``core.device.default_device()``, the card, as the
  reference's sit on its default device. A carried ``SpmvPlan`` is rebuilt
  from the reference's bf16 (hi, lo) planes with ``SpmvPlan.from_parts``.
  A carried ``rand`` generator is the port's of the same class, seed and
  offset (and ``nstreams`` for MTGP32; for Sobol the dimensions, bits,
  scrambling and the reference's digital shift), so it draws the same next
  words, on the default device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumathlib_torch.core import device as _device

# numpy/ml_dtypes dtype name → (bit-carrier numpy dtype, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of the same name as a numpy, ml_dtypes or JAX dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def from_numpy(x, device=None) -> torch.Tensor:
    x = np.asarray(x)
    view = _BIT_VIEWS.get(x.dtype.name)
    if view is not None:
        carrier, tdt = view
        t = torch.from_numpy(np.ascontiguousarray(x).view(carrier)).view(tdt)
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device) if device is not None else t


def to_numpy(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu().resolve_conj()
    if x.dtype.is_floating_point and x.dtype.itemsize < 4:
        x = x.float()
    return x.numpy()


_SPARSE_FIELDS = {   # container → (array fields, static fields), in constructor order
    "CSR": (("indptr", "indices", "data"), ("shape",)),
    "COO": (("row", "col", "data"), ("shape",)),
    "BSR": (("indptr", "indices", "data"), ("shape", "blocksize")),
    "BlockedELL": (("cols", "data"), ("shape", "blocksize")),
    "SELL": (("cols", "data", "widths"), ("shape", "slice_height")),
}


_RAND_GENERATORS = ("PhiloxGenerator", "ThreefryGenerator", "XorwowGenerator",
                    "Mrg32k3aGenerator", "Mt19937Generator", "Mtgp32Generator", "SobolGenerator")


def from_reference(obj):
    """The port's counterpart of a reference descriptor, sparse container,
    ``SpmvPlan`` or ``rand`` generator; arrays land on
    ``core.device.default_device()``."""
    from tpumathlib_torch import rand, sparse
    from tpumathlib_torch.blas import lt
    from tpumathlib_torch.dx.gemm import MatmulConfig
    from tpumathlib_torch.fft import plan as fft_plan

    def copy(v):   # the reference's buffers are read-only: the port gets its own
        return from_numpy(np.array(v), _device.default_device())

    kind = type(obj).__name__
    if kind in _SPARSE_FIELDS:
        arrays, static = _SPARSE_FIELDS[kind]
        return getattr(sparse, kind)(*(copy(getattr(obj, f)) for f in arrays),
                                     *(tuple(obj.shape) if f == "shape" else getattr(obj, f)
                                       for f in static))
    if kind == "SpmvPlan":
        return sparse.SpmvPlan.from_parts(copy(obj.cols), copy(obj.ah), copy(obj.al),
                                          tuple(obj.shape), obj.bs)
    if kind == "Mtgp32Generator":
        return rand.Mtgp32Generator(obj.seed, obj.nstreams).set_offset(obj.offset)
    if kind == "SobolGenerator":
        gen = rand.SobolGenerator(obj.dim, obj.scrambled, bits=obj.bits)
        gen._shift_np = np.array(obj._shift_np, np.uint64)
        return gen.set_offset(obj.offset)
    if kind in _RAND_GENERATORS:
        return getattr(rand, kind)(obj.seed).set_offset(obj.offset)
    if kind in ("FftType", "Direction"):
        return getattr(fft_plan, kind)(obj.value)
    if kind == "FftDescriptor":
        return fft_plan.FftDescriptor(tuple(obj.shape), fft_plan.FftType(obj.fft_type.value),
                                      obj.batch, obj.norm, obj.precision)
    if kind == "MatmulConfig":
        return MatmulConfig(obj.bm, obj.bn, obj.bk)
    if kind == "Algo":
        cfg = None if obj.config is None else from_reference(obj.config)
        return lt.Algo(obj.backend, cfg)
    if kind == "MatrixLayout":
        return lt.MatrixLayout(torch_dtype(obj.dtype), obj.rows, obj.cols,
                               obj.batch)
    if kind == "MatmulDesc":
        return lt.MatmulDesc(
            compute_dtype=torch_dtype(obj.compute_dtype),
            transa=obj.transa,
            transb=obj.transb,
            epilogue=lt.Epilogue(obj.epilogue.value),
            a_scale_mode=lt.ScaleMode(obj.a_scale_mode.value),
            b_scale_mode=lt.ScaleMode(obj.b_scale_mode.value),
            d_scale_mode=lt.ScaleMode(obj.d_scale_mode.value),
            amax_d=obj.amax_d,
        )
    raise TypeError(f"no port counterpart for {kind}")
