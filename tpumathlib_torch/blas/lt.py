"""blas.lt — the descriptor matmul engine (≙ cuBLASLt).

Counterpart of ``tpumathlib/blas/lt.py``, with the same names, descriptor
values and return tuples. Flow (cuBLASLt/LtSgemm/sample_cublasLt_LtSgemm.cu:54-84):
  MatmulDesc + MatrixLayout(+Preference) → heuristic/search → matmul.

Backends on this card:
- ``Algo("pallas")``: the repository's own hand-written kernel
  (``dx.gemm.pallas_matmul`` → ``csrc/gemm_epilogue.cu``), epilogue fused.
- ``Algo("xla")``: the vendor path, ``torch.matmul`` (cuBLAS), with the
  epilogue applied by PyTorch after it. 16-bit float operands multiply in
  their own dtype there, so the product is rounded to that dtype once
  before the f32 epilogue.
- ``Algo("auto")``: what the default heuristic returns first, which is the
  vendor path, as in the reference; ``matmul_autotune`` times both.

Scale-tensor layouts are natural (not swizzled): per-tensor = scalar;
1×32/1×16 block scales along K: A (M, K/bs), B (K/bs, N); 128×128: A
(⌈M/128⌉, ⌈K/128⌉), B (⌈K/128⌉, ⌈N/128⌉) — ≙ getScaleTensorSize,
cuBLASLt/Common/helpers.h:77-111.

Not yet ported: the emulated f64 path (LtDgemmEmulated, compute f64 with the
default epilogue), which waits for blas/emulation; it raises
NotSupportedError.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from tpumathlib_torch.core.dtypes import cdiv, traits
from tpumathlib_torch.core.errors import NotSupportedError, check
from tpumathlib_torch.core.tuning import global_autotune_cache
from tpumathlib_torch.dx.gemm import MatmulConfig, apply_epilogue, default_configs, pallas_matmul


class Epilogue(enum.Enum):
    DEFAULT = "default"
    RELU = "relu"
    GELU = "gelu"
    BIAS = "bias"
    RELU_BIAS = "relu_bias"
    GELU_BIAS = "gelu_bias"
    RELU_AUX = "relu_aux"
    GELU_AUX = "gelu_aux"
    RELU_AUX_BIAS = "relu_aux_bias"
    GELU_AUX_BIAS = "gelu_aux_bias"
    # backward-pass epilogues (CUBLASLT_EPILOGUE_{DRELU,DGELU,BGRADB})
    DRELU = "drelu"
    DGELU = "dgelu"
    BGRADB = "bgradb"


class ScaleMode(enum.Enum):
    """≙ CUBLASLT_MATMUL_MATRIX_SCALE_* (LtMxfp8Matmul…cu:71-75)."""

    TENSOR = "tensor"            # per-tensor f32 scalar
    VEC32_UE8M0 = "vec32_ue8m0"  # 1×32 blocks, power-of-two (MXFP8)
    VEC16_E4M3 = "vec16_e4m3"    # 1×16 blocks, e4m3 scales (NVFP4)
    BLK128_F32 = "blk128_f32"    # 128×128 blocks, f32 (DeepSeek-style)

    @property
    def block(self) -> int | None:
        return {"tensor": None, "vec32_ue8m0": 32, "vec16_e4m3": 16,
                "blk128_f32": 128}[self.value]


@dataclasses.dataclass(frozen=True)
class MatrixLayout:
    """≙ cublasLtMatrixLayout_t (row-major)."""

    dtype: Any
    rows: int
    cols: int
    batch: int = 1

    def shape(self):
        return (self.batch, self.rows, self.cols) if self.batch > 1 else (self.rows, self.cols)


@dataclasses.dataclass(frozen=True)
class MatmulDesc:
    """≙ cublasLtMatmulDesc_t + its Set/GetAttribute surface."""

    compute_dtype: Any = torch.float32
    transa: str = "N"
    transb: str = "N"
    epilogue: Epilogue = Epilogue.DEFAULT
    a_scale_mode: ScaleMode = ScaleMode.TENSOR
    b_scale_mode: ScaleMode = ScaleMode.TENSOR
    d_scale_mode: ScaleMode = ScaleMode.TENSOR
    amax_d: bool = False  # request D-amax output (D_AMAX_POINTER)


@dataclasses.dataclass(frozen=True)
class Algo:
    """≙ cublasLtMatmulAlgo_t: a fully-specified execution recipe."""

    backend: str = "auto"  # "pallas" | "xla" | "auto"
    config: MatmulConfig | None = None


@dataclasses.dataclass(frozen=True)
class MatmulPreference:
    """≙ cublasLtMatmulPreference_t. PyTorch's allocator owns memory, so the
    workspace ceiling is kept for API parity only."""

    max_workspace_bytes: int = 128 * 1024 * 1024


def scale_tensor_shape(mode: ScaleMode, rows: int, cols: int, operand: str):
    """≙ getScaleTensorSize (cuBLASLt/Common/helpers.h:77-111): shape of the
    scale tensor for an (rows, cols) operand. ``operand``: 'a'|'b'|'d'."""
    if mode == ScaleMode.TENSOR:
        return ()
    bs = mode.block
    if mode == ScaleMode.BLK128_F32:
        return (cdiv(rows, 128), cdiv(cols, 128))
    # vector modes scale along the contraction dim (cols of A, rows of B)
    if operand == "a":
        return (rows, cdiv(cols, bs))
    if operand == "b":
        return (cdiv(rows, bs), cols)
    return (rows, cdiv(cols, bs))


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def _expand_scale(x_shape, scale, mode: ScaleMode, operand: str):
    """Broadcast a scale tensor to elementwise over the operand."""
    if scale is None:
        return None
    scale = _f32(scale)
    if mode == ScaleMode.TENSOR:
        return scale.reshape(())
    r, c = x_shape[-2], x_shape[-1]
    if mode == ScaleMode.BLK128_F32:
        rows = torch.repeat_interleave(scale, 128, dim=-2)[..., :r, :]
        return torch.repeat_interleave(rows, 128, dim=-1)[..., :c]
    bs = mode.block
    if operand == "a":  # (r, c/bs) → (r, c)
        return torch.repeat_interleave(scale, bs, dim=-1)[..., :c]
    return torch.repeat_interleave(scale, bs, dim=-2)[..., :r, :]  # b: (r/bs, c) → (r, c)


def _dequant(x, scale, mode: ScaleMode, operand: str, compute_dtype):
    xs = x.to(torch.float32 if traits(x.dtype).itemsize <= 2 else compute_dtype)
    s = _expand_scale(x.shape, scale, mode, operand)
    if s is not None:
        xs = xs * s.to(xs.device)
    return xs.to(compute_dtype)


def matmul_algo_candidates(desc: MatmulDesc, a_layout: MatrixLayout,
                           b_layout: MatrixLayout) -> Sequence[Algo]:
    """≙ AlgoGetIds + AlgoInit sweep: every algo worth timing."""
    cands = [Algo("xla"), Algo("pallas", None)]
    cands += [Algo("pallas", cfg) for cfg in default_configs(a_layout.dtype)]
    return cands


def matmul_algo_get_heuristic(desc: MatmulDesc, a_layout: MatrixLayout,
                              b_layout: MatrixLayout,
                              pref: MatmulPreference | None = None,
                              n: int = 1) -> list[Algo]:
    """≙ cublasLtMatmulAlgoGetHeuristic: model-based pick, no timing.

    The vendor path first and the repository's kernel second, as in the
    reference; ``matmul_autotune`` measures both, so the faster one wins
    where it is timed."""
    return [Algo("xla"), Algo("pallas")][:n]


def matmul(
    desc: MatmulDesc,
    a,
    b,
    c=None,
    *,
    alpha: float = 1.0,
    beta: float = 0.0,
    bias=None,
    a_scale=None,
    b_scale=None,
    d_scale=None,
    out_dtype=None,
    aux=None,
    algo: Algo | None = None,
):
    """≙ cublasLtMatmul: D = scale_d(epilogue(alpha·op(A)s_a @ op(B)s_b +
    beta·C + bias)).

    Returns D, or a tuple growing with requested outputs:
    (D[, aux][, amax]) — aux for *_AUX epilogues, amax when desc.amax_d.
    For DRELU/DGELU epilogues, ``aux`` is the forward pre-activation input.
    """
    # NVFP4 packed-e2m1 operands: decode to f32 values (exact — every e2m1
    # level is f32-representable); block scales apply on the normal
    # VEC16_E4M3 dequant path below (≙ LtNvfp4Matmul)
    if isinstance(a, PackedFp4):
        a = fp4_dequantize(a)
    if isinstance(b, PackedFp4):
        b = fp4_dequantize(b)

    if algo is None:
        algo = matmul_algo_get_heuristic(
            desc,
            MatrixLayout(a.dtype, a.shape[-2], a.shape[-1]),
            MatrixLayout(b.dtype, b.shape[-2], b.shape[-1]),
        )[0]

    if desc.transa.upper() != "N":
        a = a.mH if desc.transa.upper() == "C" else a.mT
    if desc.transb.upper() != "N":
        b = b.mH if desc.transb.upper() == "C" else b.mT

    compute_dtype = desc.compute_dtype
    out_dtype = out_dtype if out_dtype is not None else (
        c.dtype if c is not None else a.dtype
    )

    epi = desc.epilogue
    if epi in (Epilogue.DRELU, Epilogue.DGELU, Epilogue.BGRADB):
        return _backward_epilogue_matmul(desc, a, b, c, alpha, beta, aux, out_dtype)

    if (a.dtype == torch.float64 and compute_dtype == torch.float64
            and epi == Epilogue.DEFAULT):
        raise NotSupportedError(
            "f64 matmul with the default epilogue is the emulated dgemm path "
            "(LtDgemmEmulated), not yet ported (ROADMAP A2)")

    if (compute_dtype == torch.int32 and a.dtype == torch.int8
            and b.dtype == torch.int8):
        # ≙ LtIgemmTensor (cuBLASLt/LtIgemmTensor/sample_cublasLt_LtIgemmTensor.cu:19-35):
        # CUBLAS_COMPUTE_32I semantics — integer-exact int8×int8→int32.
        # torch.matmul has no int8 product on CUDA, so the product runs in
        # f64, exact while K·127² < 2^53. alpha/beta must be integers.
        check(epi == Epilogue.DEFAULT,
              "32I matmul supports only the default epilogue")
        check(a_scale is None and b_scale is None and d_scale is None,
              "32I matmul is integer-exact: scale tensors don't apply")
        for name, v in (("alpha", alpha), ("beta", beta)):
            check(not isinstance(v, float) or float(v).is_integer(),
                  f"32I matmul requires integer {name}")
        acc = torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)
        d = int(alpha) * acc if isinstance(alpha, (int, float)) \
            else torch.as_tensor(alpha).to(torch.int32) * acc
        if c is not None:
            d = d + int(beta) * c.to(torch.int32)
        # default output is int32 (the reference's D layout is CUDA_R_32I);
        # an inherited int8 default from A's dtype is not meaningful here
        iout = torch.int32 if out_dtype == torch.int8 else out_dtype
        d = d.to(iout)
        if desc.amax_d:
            return d, d.abs().max().to(torch.float32)
        return d

    narrow = traits(a.dtype).itemsize < 2 or traits(b.dtype).itemsize < 2
    scaled = (
        a_scale is not None or b_scale is not None
        or desc.a_scale_mode != ScaleMode.TENSOR
        or desc.b_scale_mode != ScaleMode.TENSOR
    )

    if scaled or narrow:
        # Dequantize-to-compute-dtype path. Per-tensor scales fold into
        # alpha; block scales expand to elementwise.
        if (desc.a_scale_mode == ScaleMode.TENSOR
                and desc.b_scale_mode == ScaleMode.TENSOR):
            av = a.to(compute_dtype)
            bv = b.to(compute_dtype)
            if a_scale is not None:
                alpha = alpha * _f32(a_scale)
            if b_scale is not None:
                alpha = alpha * _f32(b_scale)
        else:
            av = _dequant(a, a_scale, desc.a_scale_mode, "a", compute_dtype)
            bv = _dequant(b, b_scale, desc.b_scale_mode, "b", compute_dtype)
    else:
        av, bv = a, b

    want_aux = "aux" in epi.value
    static_alpha = isinstance(alpha, (int, float))

    if algo.backend == "pallas" and not av.dtype.is_complex:
        if static_alpha:
            r = pallas_matmul(
                av, bv, c=c, bias=bias, config=algo.config,
                out_dtype=torch.float32, epilogue=epi.value,
                alpha=float(alpha), beta=float(beta), return_aux=want_aux,
            )
        else:
            # tensor alpha (from scale tensors): apply scaling outside
            r = pallas_matmul(
                av, bv, c=None, bias=None, config=algo.config,
                out_dtype=torch.float32, epilogue="default",
            )
            acc = alpha.to(r.device) * r
            if c is not None:
                acc = acc + beta * c.to(torch.float32)
            bb = bias.to(torch.float32) if bias is not None else None
            d, auxv = apply_epilogue(acc, epi.value, bb)
            r = (d, auxv) if want_aux else d
    else:
        prod = torch.matmul(av, bv)
        if not prod.dtype.is_complex:
            prod = prod.to(torch.float32)
        acc = (alpha.to(prod.device) if isinstance(alpha, torch.Tensor) else alpha) * prod
        if c is not None:
            acc = acc + beta * c.to(acc.dtype)
        bb = bias.to(acc.dtype) if bias is not None else None
        d, auxv = apply_epilogue(acc, epi.value, bb)
        r = (d, auxv) if want_aux else d

    d = r[0] if want_aux else r
    outs = []
    if desc.amax_d:
        amax = d.abs().max().to(torch.float32)
    if d_scale is not None:
        d = d * _f32(d_scale).to(d.device)
    d = d.to(out_dtype)
    outs.append(d)
    if want_aux:
        outs.append(r[1])
    if desc.amax_d:
        outs.append(amax)
    return tuple(outs) if len(outs) > 1 else outs[0]


def _backward_epilogue_matmul(desc, a, b, c, alpha, beta, aux, out_dtype):
    """CUBLASLT_EPILOGUE_{DRELU, DGELU, BGRADB} semantics.

    DRELU/DGELU: D = act'(aux) ⊙ (alpha·A@B + beta·C); BGRADB: returns
    (D, bgrad) with bgrad = column-sums of B (bias gradient)."""
    acc = alpha * torch.matmul(a.to(torch.float32), b.to(torch.float32))
    if c is not None:
        acc = acc + beta * c.to(torch.float32)
    if desc.epilogue == Epilogue.BGRADB:
        bgrad = torch.sum(b.to(torch.float32), dim=-2)
        return acc.to(out_dtype), bgrad
    check(aux is not None, f"{desc.epilogue} requires aux (forward pre-activation)")
    x = aux.to(torch.float32)
    if desc.epilogue == Epilogue.DRELU:
        dact = (x > 0).to(torch.float32)
    else:  # DGELU (tanh approx derivative)
        k0, k1 = 0.7978845608028654, 0.044715
        u = k0 * (x + k1 * x**3)
        t = torch.tanh(u)
        dact = 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t**2) * k0 * (1.0 + 3 * k1 * x**2)
    return (acc * dact).to(out_dtype)


def matmul_autotune(
    desc: MatmulDesc,
    a,
    b,
    *,
    candidates: Sequence[Algo] | None = None,
    **kwargs,
) -> Algo:
    """≙ LtMatmulCustomFind / GemmExAutoTuning: timed sweep over the algo
    space, cached on disk keyed by (problem, device)."""
    if candidates is None:
        candidates = matmul_algo_candidates(
            desc,
            MatrixLayout(a.dtype, a.shape[-2], a.shape[-1]),
            MatrixLayout(b.dtype, b.shape[-2], b.shape[-1]),
        )
    problem = (
        tuple(a.shape), tuple(b.shape), str(a.dtype), str(b.dtype), desc.epilogue.value,
        desc.a_scale_mode.value, desc.b_scale_mode.value,
    )
    cache = global_autotune_cache()

    def build(algo: Algo):
        return lambda: matmul(desc, a, b, algo=algo, **kwargs)

    cfgs = {repr(al): al for al in candidates}
    win = cache.tune("lt_matmul", tuple(map(str, problem)), list(cfgs.keys()),
                     lambda k: build(cfgs[k]))
    return cfgs[win]


class Matmul:
    """Plan object: descriptor + chosen algo → callable (≙ holding a
    heuristic result and reusing it across cublasLtMatmul calls)."""

    def __init__(self, desc: MatmulDesc, algo: Algo | None = None, **defaults):
        self.desc = desc
        self.algo = algo
        self.defaults = defaults

    def __call__(self, a, b, c=None, **kwargs):
        kw = dict(self.defaults)
        kw.update(kwargs)
        return matmul(self.desc, a, b, c, algo=self.algo, **kw)


def _mm32(x, y):
    return torch.matmul(x.to(torch.float32), y.to(torch.float32))


def matmul_planar(ar, ai, br, bi, *, alpha=1.0, use_3m: bool = True):
    """Planar-complex matmul (≙ cuBLASLt LtPlanarComplex): separate re/im
    operands, f32 products. 3-multiplication Karatsuba by default.

    Returns (dr, di)."""
    if use_3m:
        t1 = _mm32(ar, br)
        t2 = _mm32(ai, bi)
        t3 = _mm32(ar + ai, br + bi)
        dr, di = t1 - t2, t3 - t1 - t2
    else:
        dr = _mm32(ar, br) - _mm32(ai, bi)
        di = _mm32(ar, bi) + _mm32(ai, br)
    return alpha * dr, alpha * di


# ---------- NVFP4: packed e2m1 storage (≙ LtNvfp4Matmul) ----------

# e2m1 magnitudes by code 0..7 (1 sign, 2 exponent, 1 mantissa; bias 1)
_E2M1_LEVELS = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
# nearest-level decision boundaries (midpoints)
_E2M1_BOUNDS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)


@dataclasses.dataclass
class PackedFp4:
    """fp4 e2m1 operand storage: two 4-bit codes per uint8, low nibble =
    even column (≙ the fp4 value tensor of
    LtNvfp4Matmul/sample_cublasLt_LtNvfp4Matmul.cu:73-79); the container
    carries the logical shape."""

    data: object          # uint8 (..., r, c//2)
    shape: tuple          # logical (..., r, c)

    @property
    def dtype(self):
        return torch.uint8


def fp4_encode(x):
    """f32 → e2m1 codes (uint8 in [0,16), nearest-level rounding)."""
    xf = _f32(x)
    mag = xf.abs()
    idx = torch.zeros(xf.shape, dtype=torch.uint8, device=xf.device)
    for bound in _E2M1_BOUNDS:
        idx += (mag > bound).to(torch.uint8)
    sign = (xf < 0).to(torch.uint8)
    return sign * 8 + idx


def fp4_decode(codes):
    """e2m1 codes → f32 values."""
    idx = codes & 7
    levels = torch.tensor(_E2M1_LEVELS, dtype=torch.float32, device=codes.device)
    mag = levels[idx.long()]
    return torch.where(codes >= 8, -mag, mag)


def fp4_pack(codes):
    """(..., c) codes → (..., c//2) uint8, low nibble = even column."""
    check(codes.shape[-1] % 2 == 0, "fp4 pack needs even trailing dim")
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8)


def fp4_unpack(packed):
    """(..., c//2) uint8 → (..., c) codes."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        tuple(packed.shape[:-1]) + (packed.shape[-1] * 2,))


def _block_amax(xf, bs: int, operand: str):
    """Per-block max |x| along the contraction dim (cols of A, rows of B),
    zero-padding the ragged block."""
    r, c = xf.shape[-2], xf.shape[-1]
    if operand == "a":
        pc = cdiv(c, bs) * bs
        xp = F.pad(xf, (0, pc - c))
        return xp.reshape(tuple(xp.shape[:-1]) + (pc // bs, bs)).abs().amax(dim=-1)
    pr = cdiv(r, bs) * bs
    xp = F.pad(xf, (0, 0, 0, pr - r))
    return xp.reshape(tuple(xp.shape[:-2]) + (pr // bs, bs, c)).abs().amax(dim=-2)


def fp4_quantize(x, mode: ScaleMode = None, operand: str = "a"):
    """Quantize to NVFP4: packed e2m1 values + 1×16 e4m3 block scales
    (amax/6 per block, ≙ sample_cublasLt_LtNvfp4Matmul.cu:73-79).
    Returns (PackedFp4, scales)."""
    mode = mode or ScaleMode.VEC16_E4M3
    check(mode == ScaleMode.VEC16_E4M3, "NVFP4 uses 1x16 e4m3 scales")
    xf = _f32(x)
    amax = _block_amax(xf, mode.block, operand)
    scale = torch.clamp_min(amax / 6.0, 1e-12)
    scale = scale.to(torch.float8_e4m3fn).to(torch.float32)
    sexp = _expand_scale(xf.shape, scale, mode, operand)
    codes = fp4_encode(xf / sexp)
    return (PackedFp4(fp4_pack(codes), tuple(xf.shape)),
            scale.to(torch.float8_e4m3fn))


def fp4_dequantize(p: PackedFp4, scales=None,
                   mode: ScaleMode = None, operand: str = "a"):
    """PackedFp4 (+ optional block scales) → f32."""
    vals = fp4_decode(fp4_unpack(p.data))[..., :p.shape[-1]]
    if scales is not None:
        mode = mode or ScaleMode.VEC16_E4M3
        vals = vals * _expand_scale(p.shape, scales, mode, operand).to(vals.device)
    return vals


# ---------- quantization helpers ----------

_FINFO_MAX = {
    torch.float8_e4m3fn: 448.0,
    torch.float8_e5m2: 57344.0,
    torch.int8: 127.0,
}


def quantize(x, dtype, mode: ScaleMode = ScaleMode.TENSOR, operand: str = "a"):
    """Quantize x to a narrow dtype with the given scale mode; returns
    (values, scales). Scales are chosen so values fill the target range
    (amax-based, ≙ the reference samples' scale setup). ``dtype`` is a torch
    dtype, or one of "fp4" / "e2m1" / "fp4_e2m1" / "nvfp4" for packed NVFP4."""
    if isinstance(dtype, str) and dtype in ("fp4", "e2m1", "fp4_e2m1",
                                            "nvfp4"):
        return fp4_quantize(x, mode if mode != ScaleMode.TENSOR else None,
                            operand)
    finfo_max = _FINFO_MAX.get(dtype)
    if finfo_max is None:
        if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
            raise NotSupportedError(f"quantize to {dtype}")
        finfo_max = float(torch.finfo(dtype).max)
    xf = _f32(x)
    if mode == ScaleMode.TENSOR:
        amax = xf.abs().max()
        scale = torch.clamp_min(amax / finfo_max, 1e-12)
        return (xf / scale).to(dtype), scale
    r, c = xf.shape[-2], xf.shape[-1]
    if mode == ScaleMode.BLK128_F32:
        pr, pc = cdiv(r, 128) * 128, cdiv(c, 128) * 128
        xp = F.pad(xf, (0, pc - c, 0, pr - r))
        blocks = xp.reshape(pr // 128, 128, pc // 128, 128)
        amax = blocks.abs().amax(dim=(1, 3))
        scale = torch.clamp_min(amax / finfo_max, 1e-12)
        full = torch.repeat_interleave(torch.repeat_interleave(scale, 128, 0), 128, 1)
        q = (xp / full).to(dtype)
        return q[:r, :c], scale
    amax = _block_amax(xf, mode.block, operand)
    scale = torch.clamp_min(amax / finfo_max, 1e-12)
    if mode == ScaleMode.VEC32_UE8M0:
        # UE8M0: power-of-two scales (exponent-only), rounded up
        scale = torch.exp2(torch.ceil(torch.log2(scale)))
    elif mode == ScaleMode.VEC16_E4M3:
        scale = scale.to(torch.float8_e4m3fn).to(torch.float32)
    sexp = _expand_scale(xf.shape, scale, mode, operand)
    return (xf / sexp).to(dtype), scale
