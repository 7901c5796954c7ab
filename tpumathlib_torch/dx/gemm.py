"""Tiled GEMM with fused epilogues — the engine under blas.level3 / blas.lt.

Counterpart of ``tpumathlib/dx/gemm.py``. The name ``pallas_matmul`` is
kept so that every call site ports one for one; on this card it means the
repository's own hand-written CUDA kernel, ``csrc/gemm_epilogue.cu``
(SIMT f32 FMA, one thread block per output tile, K loop inside the block).

Shape convention is row-major math: ``D = epilogue(alpha * A @ B + beta * C +
bias)`` with A (..., M, K), B (..., K, N); leading dims are batch. Every
operand reaches the kernel with its own strides, so transposed views and
broadcast (stride-0) batches need no copy.

Dispatch: tensors on the CPU take ``_pallas_matmul_plain``; CUDA tensors
launch the kernel or raise — there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from tpumathlib_torch.core.dtypes import cdiv
from tpumathlib_torch.core.errors import (
    InvalidValueError, NotSupportedError, check)
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda

_EPILOGUES = (
    "default",
    "relu",
    "gelu",
    "bias",
    "relu_bias",
    "gelu_bias",
    "relu_aux",
    "gelu_aux",
    "relu_aux_bias",
    "gelu_aux_bias",
)

# dtype codes of csrc/gemm_epilogue.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_ACT_CODE = {"relu": 1, "gelu": 2}

# shared memory a block may use on sm_90 (227 KB)
SMEM_LIMIT = 232_448
# streaming multiprocessors of an H100 SXM: fewer tiles than this leave SMs idle
_NUM_SMS = 132


@dataclasses.dataclass(frozen=True)
class MatmulConfig:
    """One point in the Lt "algo" space: the kernel's (BM, BN, BK) tile.
    Only the compiled configs (``default_configs()``) launch."""

    bm: int = 128
    bn: int = 128
    bk: int = 16

    def smem_bytes(self) -> int:
        # A and B tiles, staged as f32 (csrc/simt_gemm.cuh)
        return 4 * self.bk * (self.bm + self.bn)


# the configs compiled into csrc/gemm_epilogue.cu (kConfigs), in id order
_CONFIGS = (MatmulConfig(128, 128, 16), MatmulConfig(128, 64, 16),
            MatmulConfig(64, 64, 16))


def default_configs(dtype=None) -> Sequence[MatmulConfig]:
    """Candidate sweep for the autotuner (≙ AlgoGetIds/CapGetAttribute sweep,
    cuBLASLt/Common/LtMatmulCustomFind.h:189-274): exactly the compiled set.
    The tiles are staged as f32 whatever the dtype, so it is one set for all."""
    return _CONFIGS


def _pick_config(m, n, k, a_dtype=None, b_dtype=None, out_dtype=None,
                 batch: int = 1) -> MatmulConfig:
    """Heuristic default (≙ cublasLtMatmulAlgoGetHeuristic): the largest tile
    that fits in shared memory and still gives every SM a tile."""
    for cfg in _CONFIGS:
        if (cfg.smem_bytes() <= SMEM_LIMIT
                and batch * cdiv(m, cfg.bm) * cdiv(n, cfg.bn) >= _NUM_SMS):
            return cfg
    return _CONFIGS[-1]


def apply_epilogue(acc, epilogue: str, bias=None):
    """(d, aux) in accumulate dtype. ``aux`` is the pre-activation input
    (CUBLASLT_EPILOGUE_{RELU,GELU}_AUX semantics — saved for backward)."""
    if "bias" in epilogue and bias is not None:
        acc = acc + bias
    aux = acc
    if epilogue.startswith("relu"):
        acc = torch.clamp_min(acc, 0.0)
    elif epilogue.startswith("gelu"):
        # tanh-approx GELU, matching CUBLASLT_EPILOGUE_GELU
        acc = 0.5 * acc * (1.0 + torch.tanh(0.7978845608028654 * (acc + 0.044715 * acc**3)))
    return acc, aux


def _pallas_matmul_plain(a, b, c=None, bias=None, *, out_dtype, epilogue: str = "default",
                         alpha: float = 1.0, beta: float = 0.0, return_aux: bool = False):
    """The kernel's plain PyTorch version: the same f32 math, by torch.matmul."""
    acc = alpha * torch.matmul(a.float(), b.float())
    if c is not None:
        acc = acc + beta * c.float()
    bb = bias.float().reshape(-1) if bias is not None else None
    d, aux = apply_epilogue(acc, epilogue, bb)
    d = d.to(out_dtype)
    return (d, aux) if return_aux else d


def _matmul_into_plain(d, a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
    """``_matmul_into``'s plain version: the same f32 math by torch.matmul."""
    return d.copy_(_pallas_matmul_plain(a, b, c, out_dtype=torch.float32, alpha=alpha,
                                        beta=beta))


@functools.lru_cache(maxsize=None)
def _config_id(m: int, n: int, k: int) -> int:
    return _CONFIGS.index(_pick_config(m, n, k))


class _Into:
    """Launches of the kernel with D = alpha·A@B + beta·C written in place,
    all f32, the operands given as (address, row stride, column stride) in
    elements: for host loops that issue many products into one matrix (the
    blocked factorizations of ``solver.onelaunch``, some 120 a call), so a
    launch allocates nothing and looks up the library, its stride array and
    the tile config once. D needs unit column stride; C may be D itself,
    since the thread that writes an element of D is the one that read it
    from C; A and B must not overlap D."""

    def __init__(self):
        self.lib = cuda_utils.load_kernels()
        self.strides = (ctypes.c_int64 * 11)()   # read by the entry point before it returns

    def __call__(self, stream: int, m: int, n: int, k: int, d, a, b, c=None, *,
                 alpha: float = 1.0, beta: float = 0.0):
        st = self.strides
        st[1], st[2], st[4], st[5], st[10] = a[1], a[2], b[1], b[2], d[1]
        st[7], st[8] = (c[1], c[2]) if c is not None else (0, 0)
        rc = self.lib.tml_gemm_epilogue(
            a[0], b[0], None if c is None else c[0], None, d[0], None, 1, m, n, k, st,
            alpha, beta, 0, 0, 0, 0, _config_id(m, n, k), stream)
        cuda_utils.check_launch(self.lib, rc, "gemm_epilogue")
        pallas_matmul.launches += 1


def _operand(t):
    return t.data_ptr(), t.stride(0), t.stride(1)


def _matmul_into(d, a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
    """D = alpha·A@B + beta·C in f32, written into ``d`` (a 2-D f32 view
    with unit column stride) by one launch of the kernel, with no allocation
    and no copy; A, B and C are 2-D f32 tensors, and aliasing is as for
    ``_Into``."""
    if not on_cuda(d, a, b, c):
        return _matmul_into_plain(d, a, b, c, alpha=alpha, beta=beta)
    m, k = a.shape
    n = b.shape[1]
    f32 = torch.float32
    check(d.dtype == a.dtype == b.dtype == f32 and (c is None or c.dtype == f32)
          and b.shape[0] == k and d.shape == (m, n) and d.stride(1) == 1
          and (c is None or c.shape == (m, n)),
          f"f32 operands {tuple(a.shape)} @ {tuple(b.shape)} into {tuple(d.shape)} "
          f"with unit column stride")
    with torch.cuda.device(d.device):
        _Into()(torch.cuda.current_stream(d.device).cuda_stream, m, n, k, _operand(d),
                _operand(a), _operand(b), None if c is None else _operand(c),
                alpha=alpha, beta=beta)
    return d


def pallas_matmul(
    a,
    b,
    c=None,
    bias=None,
    *,
    config: MatmulConfig | None = None,
    out_dtype=None,
    epilogue: str = "default",
    alpha: float = 1.0,
    beta: float = 0.0,
    return_aux: bool = False,
):
    """D = epilogue(alpha·A@B + beta·C + bias). A: (..., M, K), B: (..., K, N);
    leading dims are batch (≙ gemmStridedBatched when contiguous).

    Returns D, or (D, aux) when ``return_aux`` (aux = pre-activation, f32).
    On CUDA tensors, A and B of f32/bf16/f16/int8 and D of f32/bf16/f16 are
    supported; anything else raises NotSupportedError.
    """
    check(epilogue in _EPILOGUES, f"unknown epilogue {epilogue!r}")
    if out_dtype is None:
        out_dtype = a.dtype
    m, k = a.shape[-2], a.shape[-1]
    k2, n = b.shape[-2], b.shape[-1]
    check(k == k2, f"inner dims differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    batch_shape = tuple(a.shape[:-2])
    check(tuple(b.shape[:-2]) == batch_shape,
          f"batch dims differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    if config is not None and config not in _CONFIGS:
        raise NotSupportedError(f"{config} is not a compiled config; have {_CONFIGS}")
    common = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(common), b.to(common)

    kw = dict(out_dtype=out_dtype, epilogue=epilogue, alpha=alpha, beta=beta,
              return_aux=return_aux)
    if not on_cuda(a, b, c, bias):
        return _pallas_matmul_plain(a, b, c, bias, **kw)
    return _pallas_matmul_cuda(a, b, c, bias, config=config, **kw)


pallas_matmul.launches = 0


def _pallas_matmul_cuda(a, b, c, bias, *, config, out_dtype, epilogue, alpha, beta,
                        return_aux):
    lib = cuda_utils.load_kernels()
    dev = a.device
    for name, t in (("b", b), ("c", c), ("bias", bias)):
        if t is not None and t.device != dev:
            raise InvalidValueError(f"{name} is on {t.device}, a on {dev}")
    if a.dtype not in _DTYPE_CODE:
        raise NotSupportedError(f"kernel operands of {a.dtype}; supported: {list(_DTYPE_CODE)}")
    if out_dtype not in _OUT_DTYPES:
        raise NotSupportedError(f"kernel output of {out_dtype}; supported: {list(_OUT_DTYPES)}")

    batch_shape = tuple(a.shape[:-2])
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    a3 = a.reshape(-1, m, k)
    b3 = b.reshape(-1, k, n)
    nb = a3.shape[0]
    if config is None:
        config = _pick_config(m, n, k, a.dtype, b.dtype, out_dtype, batch=nb)

    d = torch.empty((nb, m, n), dtype=out_dtype, device=dev)
    aux = torch.empty((nb, m, n), dtype=torch.float32, device=dev) if return_aux else None
    if c is not None:
        if c.dtype not in _DTYPE_CODE:
            c = c.to(torch.float32)
        c3 = c.expand(batch_shape + (m, n)).reshape(-1, m, n)
        c_strides = c3.stride()
    else:
        c3, c_strides = None, (0, 0, 0)
    bias32 = None
    if bias is not None and "bias" in epilogue:
        bias32 = bias.to(torch.float32).reshape(-1).contiguous()
        check(bias32.numel() == n, f"bias has {bias32.numel()} values for N={n}")

    strides = (ctypes.c_int64 * 11)(*a3.stride(), *b3.stride(), *c_strides,
                                    d.stride(0), d.stride(1))

    def ptr(t):
        return None if t is None else t.data_ptr()

    if nb and m and n:
        with torch.cuda.device(dev):
            rc = lib.tml_gemm_epilogue(
                ptr(a3), ptr(b3), ptr(c3), ptr(bias32), ptr(d), ptr(aux),
                nb, m, n, k, strides, float(alpha), float(beta),
                _ACT_CODE.get(epilogue.split("_")[0], 0), _DTYPE_CODE[a.dtype],
                _DTYPE_CODE[c3.dtype] if c3 is not None else 0,
                _DTYPE_CODE[out_dtype], _CONFIGS.index(config),
                torch.cuda.current_stream(dev).cuda_stream)
        cuda_utils.check_launch(lib, rc, "gemm_epilogue")
        pallas_matmul.launches += 1

    d = d.reshape(batch_shape + (m, n))
    if return_aux:
        return d, aux.reshape(batch_shape + (m, n))
    return d
