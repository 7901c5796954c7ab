"""Tiled GEMM with fused epilogues — the engine under blas.level3 / blas.lt.

Counterpart of ``tpumathlib/dx/gemm.py``. The name ``pallas_matmul`` is
kept so that every call site ports one for one; on this card it means one
of the repository's three hand-written CUDA kernels:

- ``csrc/gemm_wgmma.cu``, the tensor-core route (TMA loads into a ring of
  stages, wgmma, the epilogue staged through shared memory), for bf16 and
  f16 A and B whose layout ``_tc_layout`` takes;
- ``csrc/gemm_tf32x3.cu``, the 3xTF32 route for f32 A and B
  (``tml_gemm_tf32x3_epilogue``: the same ring and epilogue, each operand
  carried as two TF32 planes, three tensor-core products a k8 step summed
  in f32; ``dx/tf32x3.py``): A read in place where TMA takes it, else its
  planes; B as the planes of Bᵀ, split once a call;
- ``csrc/gemm_epilogue.cu``, the SIMT route (f32 FMA, one thread block per
  output tile, K loop inside the block), for int8 operands, 16-bit ones in
  a layout the tensor-core route refuses, and f32 only under an explicit
  SIMT ``config=``.

``_route`` is the one rule between them, as cuBLASLt's heuristic picks a
kernel; a ``config=`` from ``default_configs`` chooses the route that
compiled it. A failure of any kernel raises: no route gives way to
another. ``pallas_matmul.launches`` counts them all; ``_gemm_wgmma``,
``_gemm_tf32x3`` and ``_gemm_simt`` each its own.

Shape convention is row-major math: ``D = epilogue(alpha * A @ B + beta * C +
bias)`` with A (..., M, K), B (..., K, N); leading dims are batch. Every
operand reaches the kernel with its own strides, so transposed views and
broadcast (stride-0) batches need no copy (on the 3xTF32 route a batch of
distinct B, or of A that TMA cannot read, is copied into stacked rows
first: the split pass takes one matrix).

Dispatch: tensors on the CPU take ``_pallas_matmul_plain``; CUDA tensors
launch the kernel or raise — there is no fallback. A call whose batch or
row tiles pass a grid's 65535 blocks is launched in pieces
(``_grid_pieces``); every other call is one launch.
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
from tpumathlib_torch.dx.tf32x3 import TRANSPOSE, Tf32x3, _split_launch, tma_ready

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

# dtype codes of csrc/gemm_epilogue.cu, csrc/gemm_wgmma.cu and csrc/gemm_tf32x3.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3}
_OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_ACT_CODE = {"relu": 1, "gelu": 2}
# operand dtypes the tensor-core route takes
_TC_DTYPES = (torch.bfloat16, torch.float16)

# shared memory a block may use on sm_90 (227 KB)
SMEM_LIMIT = 232_448
# streaming multiprocessors of an H100 SXM: fewer tiles than this leave SMs idle
_NUM_SMS = 132
# blocks a launch's grid takes along y (row tiles) and z (batch)
_GRID_MAX = 65535


@dataclasses.dataclass(frozen=True)
class MatmulConfig:
    """One point in the Lt "algo" space: a kernel's (BM, BN, BK) tile, the
    route that compiled it ("simt": csrc/gemm_epilogue.cu, "wgmma":
    csrc/gemm_wgmma.cu, "tf32x3": csrc/gemm_tf32x3.cu) and, for the
    tensor-core routes, its ring's stages. Only the compiled configs
    (``default_configs()``) launch."""

    bm: int = 128
    bn: int = 128
    bk: int = 16
    route: str = "simt"
    stages: int = 1

    def smem_bytes(self) -> int:
        if self.route == "wgmma":
            # 16-bit A and B tiles a stage, and the ring's 1024-byte alignment
            return self.stages * 2 * self.bk * (self.bm + self.bn) + 1024
        if self.route == "tf32x3":
            # two f32 planes of A and B a stage (A in f32 and B's planes: 4
            # stages of the same bytes), and the alignment
            return self.stages * 2 * 4 * self.bk * (self.bm + self.bn) + 1024
        # A and B tiles, staged as f32 (csrc/simt_gemm.cuh)
        return 4 * self.bk * (self.bm + self.bn)


# the configs compiled into csrc/gemm_epilogue.cu (kConfigs), in id order
_CONFIGS = (MatmulConfig(128, 128, 16), MatmulConfig(128, 64, 16),
            MatmulConfig(64, 64, 16))
# the configs compiled into csrc/gemm_wgmma.cu (kConfigs), in id order
_TC_CONFIGS = (MatmulConfig(128, 256, 64, "wgmma", 4), MatmulConfig(128, 128, 64, "wgmma", 6))
# the one tile of csrc/gemm_tf32x3.cu (kBN, kStagesPlanes)
_TF32X3_CONFIGS = (MatmulConfig(128, 128, 32, "tf32x3", 3),)


def _table(dtype):
    """The compiled configs of the route that ``dtype`` operands take."""
    if dtype in _TC_DTYPES:
        return _TC_CONFIGS
    return _TF32X3_CONFIGS if dtype == torch.float32 else _CONFIGS


def default_configs(dtype=None) -> Sequence[MatmulConfig]:
    """Candidate sweep for the autotuner (≙ AlgoGetIds/CapGetAttribute sweep,
    cuBLASLt/Common/LtMatmulCustomFind.h:189-274): exactly the compiled set
    of the route that ``dtype`` operands take — the tensor-core route's for
    bf16 and f16, the 3xTF32 route's for f32, the SIMT route's for the
    rest; with no dtype, every compiled config."""
    if dtype is None:
        return _CONFIGS + _TC_CONFIGS + _TF32X3_CONFIGS
    return _table(dtype)


def _pick(table, m, n, k, batch: int) -> MatmulConfig:
    """The first config of ``table`` whose tile fits in shared memory and
    still gives every SM a tile, else its last."""
    for cfg in table:
        if (cfg.smem_bytes() <= SMEM_LIMIT
                and batch * cdiv(m, cfg.bm) * cdiv(n, cfg.bn) >= _NUM_SMS):
            return cfg
    return table[-1]


def _pick_config(m, n, k, a_dtype=None, b_dtype=None, out_dtype=None,
                 batch: int = 1) -> MatmulConfig:
    """Heuristic default (≙ cublasLtMatmulAlgoGetHeuristic): the largest tile
    of the route ``a_dtype`` operands take (the SIMT route's with no dtype)
    that fits in shared memory and still gives every SM a tile."""
    return _pick(_CONFIGS if a_dtype is None else _table(a_dtype), m, n, k, batch)


def _tc_layout(t) -> bool:
    """Whether the tensor-core route takes the (batch, rows, cols) operand
    ``t`` as it lies: unit stride along rows or along cols, the other stride
    a multiple of 8 elements (16 bytes) that covers its dimension, a batch
    stride of 0 or a multiple of 8 past one matrix (any, for one matrix),
    and a 16-byte aligned base. csrc/gemm_wgmma.cu (``major_of``) checks the
    same: TMA reads the operand in place, so a transposed view needs no
    copy."""
    nb, rows, cols = t.shape
    sb, sr, sc = t.stride()
    if t.data_ptr() % 16:
        return False
    if sc == 1 and sr % 8 == 0 and sr >= max(cols, 1):
        extent = rows * sr
    elif sr == 1 and sc % 8 == 0 and sc >= max(rows, 1):
        extent = cols * sc
    else:
        return False
    return nb == 1 or sb == 0 or (sb % 8 == 0 and sb >= extent)


def _route(a3, b3, config) -> str:
    """The kernel a launch takes: the route of an explicit ``config``, else
    "wgmma" for bf16/f16 operands that ``_tc_layout`` takes, "tf32x3" for
    f32 operands, "simt" for the rest. A tensor-core config for operands its
    route does not take raises."""
    takes = a3.dtype in _TC_DTYPES and _tc_layout(a3) and _tc_layout(b3)
    if config is None:
        if takes:
            return "wgmma"
        return "tf32x3" if a3.dtype == torch.float32 else "simt"
    if config.route == "wgmma" and not takes:
        raise NotSupportedError(
            f"{config} is a tensor-core config: it takes bf16/f16 operands with a unit "
            f"stride, 16-byte strides and a 16-byte aligned base, not {a3.dtype} "
            f"{tuple(a3.stride())} @ {tuple(b3.stride())}")
    if config.route == "tf32x3" and a3.dtype != torch.float32:
        raise NotSupportedError(f"{config} is the 3xTF32 config: it takes f32 operands, "
                                f"not {a3.dtype}")
    return config.route


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


@functools.lru_cache(maxsize=None)
def _tc_config_id(m: int, n: int, k: int) -> int:
    return _TC_CONFIGS.index(_pick(_TC_CONFIGS, m, n, k, 1))


def _tc_reads(t) -> bool:
    """Whether the tensor-core route reads the 2-D operand ``t`` in place
    (``_tc_layout``)."""
    return _tc_layout(t[None])


def _into_route(m: int, n: int, k: int) -> str:
    """The kernel of an f32 ``_Into`` launch: the 3xTF32 route, but for
    products of K ≤ 256 whose output the SIMT kernel covers in one wave of
    its 64 × 64 tiles (≤ ``_NUM_SMS``), which take the SIMT route. There a
    tile's prologue and epilogue set both kernels' time (on the card at K =
    128 the same 16 µs, at K = 256 25 µs against the 3xTF32 route's 20 and
    its split's 3; PERF.md §6, B1), and the 3xTF32 route would add the
    split's launch to host loops whose host time is near their device
    time. Past one wave the SIMT kernel's time grows by waves (45 µs at
    132 tiles of 128 × 128 and K = 128, against 17 µs)."""
    if k <= 256 and cdiv(m, 64) * cdiv(n, 64) <= _NUM_SMS:
        return "simt"
    return "tf32x3"


def _a_planes_needed(a, k: int) -> bool:
    """Whether the 3xTF32 kernel cannot read the f32 operand ``a`` (address,
    row stride, column stride) in place as A (``tf32x3.tma_ready``'s rule)."""
    return not (a[2] == 1 and a[1] % 4 == 0 and a[1] >= k and a[0] % 16 == 0)


class _Into:
    """Launches of B1 with D = alpha·A@B + beta·C written in place, all f32,
    the operands given as (address, row stride, column stride) in elements:
    for host loops that issue many products into one matrix (the blocked
    factorizations of ``solver.blocked``, ``solver.onelaunch`` and
    ``solver.qr_onelaunch``, some 100 to 350 a call), so a launch allocates
    nothing and looks up the library and its stride array once. Always one
    launch: its operands are single matrices, far inside a grid's limits.
    D needs unit column stride; C may be D itself, since the thread that
    writes an element of D is the one that read it from C; A and B must not
    overlap D.

    The route is ``_into_route``'s: the 3xTF32 kernel
    (``tml_gemm_tf32x3_epilogue``, no activation), or for small products
    at K ≤ 256 the SIMT kernel. On the 3xTF32 route A is read in place
    where TMA takes it, else split into this launcher's scratch (transposed
    where A is a transposed view); B as the planes of Bᵀ, either ``bt`` =
    (hi, lo, row stride) that the caller split (a panel's factor, split
    once and read by every product after it; a callable giving them where
    the caller splits only when a product needs them) or split here into
    the scratch (where B is a transposed view, Bᵀ lies row-major and its
    split is the plain one). The scratch is made at the first split and
    reused: one stream a launcher, so a host loop on several streams takes
    one launcher a stream. ``wgmma`` launches the bf16 tensor-core route
    the same way."""

    def __init__(self, device=None, scratch: int = 0):
        self.lib = cuda_utils.load_kernels()
        self.strides = (ctypes.c_int64 * 9)()   # read by the entry point before it returns
        self.tc_strides = (ctypes.c_int64 * 11)()   # B1's other routes'

        self.tf32 = Tf32x3()
        self.device = device
        # f32 planes of the operands that a launch splits; ``scratch`` sizes
        # them ahead for a host loop whose largest split it knows
        self.scratch = torch.empty(scratch, dtype=torch.float32, device=device) if scratch else None

    def _scratch(self, stream: int, elems: int) -> int:
        """The address of ``elems`` f32 of scratch, grown where too small (the
        old buffer kept from reuse until ``stream``'s work on it is done)."""
        if self.scratch is None or self.scratch.numel() < elems:
            if self.scratch is not None and self.scratch.is_cuda:
                self.scratch.record_stream(torch.cuda.ExternalStream(stream))
            self.scratch = torch.empty(elems, dtype=torch.float32, device=self.device)
        return self.scratch.data_ptr()

    def split_bt(self, stream: int, k: int, n: int, b, hi: int, lo: int, ld: int) -> None:
        """The planes of Bᵀ (n, k) of B (k, n) = (address, row stride, column
        stride) into (hi, lo) with row stride ``ld``: the plain split of Bᵀ
        where B is a transposed view, else the transposed split of B."""
        if b[2] == 1 and b[1] >= n:
            self.tf32.split(stream, (b[0], b[1]), hi, lo, ld, k, n, TRANSPOSE)
        else:
            check(b[1] == 1 and b[2] >= k, f"B of strides {b[1:]} with a unit stride")
            self.tf32.split(stream, (b[0], b[2]), hi, lo, ld, n, k)

    def __call__(self, stream: int, m: int, n: int, k: int, d, a, b, c=None, *,
                 alpha: float = 1.0, beta: float = 0.0, bt=None):
        if _into_route(m, n, k) == "simt":
            st = self.tc_strides
            st[1], st[2], st[4], st[5], st[10] = a[1], a[2], b[1], b[2], d[1]
            st[7], st[8] = (c[1], c[2]) if c is not None else (0, 0)
            rc = self.lib.tml_gemm_epilogue(
                a[0], b[0], None if c is None else c[0], None, d[0], None, 1, m, n, k, st,
                alpha, beta, 0, 0, 0, 0, _config_id(m, n, k), stream)
            cuda_utils.check_launch(self.lib, rc, "gemm_epilogue")
            _gemm_simt.launches += 1
            pallas_matmul.launches += 1
            return
        pa = (a[0], None, a[1])   # A in place, split in the kernel's registers
        if k == 0:                # no stage is loaded: the operands are not read
            bt = (b[0], None, 0)
        else:
            bt = bt() if callable(bt) else bt
            kp = cdiv(k, 4) * 4
            split_a = _a_planes_needed(a, k)
            if split_a or bt is None:
                base = self._scratch(stream, 2 * kp * ((m if split_a else 0) + (0 if bt else n)))
                if bt is None:
                    bt = (base, base + 4 * n * kp, kp)
                    self.split_bt(stream, k, n, b, *bt)
                    base += 8 * n * kp
                if split_a:
                    pa = (base, base + 4 * m * kp, kp)
                    if a[2] == 1 and a[1] >= k:
                        self.tf32.split(stream, (a[0], a[1]), *pa, m, k)
                    else:
                        check(a[1] == 1 and a[2] >= m, f"A of strides {a[1:]} with a unit stride")
                        self.tf32.split(stream, (a[0], a[2]), *pa, k, m, TRANSPOSE)
        st = self.strides
        st[1], st[3], st[8] = pa[2], bt[2], d[1]
        st[5], st[6] = (c[1], c[2]) if c is not None else (0, 0)
        rc = self.lib.tml_gemm_tf32x3_epilogue(
            pa[0], pa[1], bt[0], bt[1], None if c is None else c[0], None, d[0], None, 1, m, n,
            k, st, alpha, beta, 0, 0, 0, stream)
        cuda_utils.check_launch(self.lib, rc, "gemm_tf32x3_epilogue")
        _gemm_tf32x3.launches += 1
        pallas_matmul.launches += 1

    def wgmma(self, stream: int, m: int, n: int, k: int, d, a, b, *, out_dtype) -> None:
        """D = A@B on the tensor-core route: bf16 A and B that ``_tc_reads``
        takes, D of ``out_dtype`` (f32 or bf16) with unit column stride,
        the tile config ``_pick`` gives one matrix."""
        st = self.tc_strides
        st[1], st[2], st[4], st[5], st[10] = a[1], a[2], b[1], b[2], d[1]
        st[7] = st[8] = 0
        bf16 = _DTYPE_CODE[torch.bfloat16]
        rc = self.lib.tml_gemm_wgmma(
            a[0], b[0], None, None, d[0], None, 1, m, n, k, st, 1.0, 0.0, 0, bf16, 0,
            _DTYPE_CODE[out_dtype], _tc_config_id(m, n, k), stream)
        cuda_utils.check_launch(self.lib, rc, "gemm_wgmma")
        _gemm_wgmma.launches += 1
        pallas_matmul.launches += 1


def _operand(t):
    return t.data_ptr(), t.stride(0), t.stride(1)


def _matmul_into(d, a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
    """D = alpha·A@B + beta·C in f32, written into ``d`` (a 2-D f32 view
    with unit column stride) by one launch of B1 (after the splits of
    ``_Into``), with no copy; A, B and C are 2-D f32 tensors, and aliasing
    is as for ``_Into``."""
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
        _Into(d.device)(torch.cuda.current_stream(d.device).cuda_stream, m, n, k, _operand(d),
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
    supported; anything else raises NotSupportedError, as does a tensor-core
    ``config`` for operands that route does not take.
    """
    # the messages are formatted only on failure: this is a launch's host path
    if epilogue not in _EPILOGUES:
        raise InvalidValueError(f"unknown epilogue {epilogue!r}")
    if out_dtype is None:
        out_dtype = a.dtype
    m, k = a.shape[-2], a.shape[-1]
    k2, n = b.shape[-2], b.shape[-1]
    if k != k2:
        raise InvalidValueError(f"inner dims differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    batch_shape = tuple(a.shape[:-2])
    if tuple(b.shape[:-2]) != batch_shape:
        raise InvalidValueError(f"batch dims differ: {tuple(a.shape)} @ {tuple(b.shape)}")
    if config is not None and config not in _CONFIGS + _TC_CONFIGS:
        raise NotSupportedError(
            f"{config} is not a compiled config; have {_CONFIGS + _TC_CONFIGS}")
    if a.dtype != b.dtype:
        common = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(common), b.to(common)

    kw = dict(out_dtype=out_dtype, epilogue=epilogue, alpha=alpha, beta=beta,
              return_aux=return_aux)
    if not on_cuda(a, b, c, bias):
        return _pallas_matmul_plain(a, b, c, bias, **kw)
    return _pallas_matmul_cuda(a, b, c, bias, config=config, **kw)


pallas_matmul.launches = 0


def _gemm_simt(lib, *args):
    """One launch of the SIMT route, csrc/gemm_epilogue.cu."""
    cuda_utils.check_launch(lib, lib.tml_gemm_epilogue(*args), "gemm_epilogue")
    _gemm_simt.launches += 1
    pallas_matmul.launches += 1


def _gemm_wgmma(lib, *args):
    """One launch of the tensor-core route, csrc/gemm_wgmma.cu (the same
    arguments)."""
    cuda_utils.check_launch(lib, lib.tml_gemm_wgmma(*args), "gemm_wgmma")
    _gemm_wgmma.launches += 1
    pallas_matmul.launches += 1


def _gemm_tf32x3(lib, *args):
    """One launch of the 3xTF32 route, csrc/gemm_tf32x3.cu's
    ``tml_gemm_tf32x3_epilogue``."""
    cuda_utils.check_launch(lib, lib.tml_gemm_tf32x3_epilogue(*args), "gemm_tf32x3_epilogue")
    _gemm_tf32x3.launches += 1
    pallas_matmul.launches += 1


_gemm_simt.launches = 0
_gemm_wgmma.launches = 0
_gemm_tf32x3.launches = 0


def _stacked_rows(t3):
    """(nb, r, c) ``t3`` as one (nb·r, c) matrix with unit column stride:
    a view where its batches are stacked rows, else a contiguous copy."""
    nb, r, c = t3.shape
    if not (t3.stride(2) == 1 and t3.stride(1) >= c and t3.stride(0) == r * t3.stride(1)):
        t3 = t3.contiguous()
    return t3.reshape(nb * r, c)


def _tf32x3_operands(a3, b3, stream: int):
    """A and Bᵀ as the 3xTF32 route reads them: ((hi, lo), (hi, lo)), each
    plane an (nb', rows, k) f32 view with unit column stride, nb' = 1 for a
    matrix that every batch shares (one matrix, or a batch stride of 0:
    split once). A is read in place where TMA takes it (lo None: the kernel
    splits it in registers), else split (transposed where A is a transposed
    view); Bᵀ is always split: plainly where B is a transposed view (Bᵀ
    then lies row-major), else transposed. A batch of distinct matrices is
    split as one matrix of stacked rows. The splits go on ``stream`` of the
    operands' device, whose context the caller holds."""
    split = functools.partial(_split_launch, Tf32x3(), stream)
    nb, m, k = a3.shape
    n = b3.shape[2]
    if nb == 1 or a3.stride(0) == 0:
        a2 = a3[0]
        if tma_ready(a2):
            a_planes = (a2[None], None)
        else:
            p = (split(a2.mT, transpose=True) if a2.stride(0) == 1 and a2.stride(1) != 1
                 else split(a2))
            a_planes = (p[0][None], p[1][None])
    elif a3.stride(0) % 4 == 0 and tma_ready(a3[0]):
        a_planes = (a3, None)
    else:
        p = split(_stacked_rows(a3)).unflatten(1, (nb, m))
        a_planes = (p[0], p[1])
    if nb == 1 or b3.stride(0) == 0:
        b2 = b3[0]
        p = (split(b2.mT) if b2.stride(0) == 1 and b2.stride(1) != 1
             else split(b2, transpose=True))
        b_planes = (p[0][None], p[1][None])
    else:
        p = split(_stacked_rows(b3.mT)).unflatten(1, (nb, n))
        b_planes = (p[0], p[1])
    return a_planes, b_planes


def _grid_pieces(nb: int, m: int, bm: int):
    """(batch slice, row slice) of each launch of a call whose batch, or
    whose row tiles of ``bm``, pass ``_GRID_MAX``: at most that many blocks
    along each (ROADMAP C21). Row offsets are multiples of ``bm`` (itself a
    multiple of 8) and batch offsets of 65535 batch strides, so a piece of
    an operand that ``_tc_layout`` takes is one that it takes too."""
    rows = _GRID_MAX * bm
    for b0 in range(0, nb, _GRID_MAX):
        for m0 in range(0, m, rows):
            yield slice(b0, b0 + _GRID_MAX), slice(m0, m0 + rows)


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
    route = _route(a3, b3, config)
    table = {"wgmma": _TC_CONFIGS, "tf32x3": _TF32X3_CONFIGS, "simt": _CONFIGS}[route]
    if config is None:
        config = _pick(table, m, n, k, nb)

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
        bias32 = bias.reshape(-1)
        if bias32.dtype != torch.float32 or not bias32.is_contiguous():
            bias32 = bias32.to(torch.float32).contiguous()
        if bias32.numel() != n:
            raise InvalidValueError(f"bias has {bias32.numel()} values for N={n}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    if nb and m and n and route == "tf32x3":
        act = _ACT_CODE.get(epilogue.split("_")[0], 0)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            (ah, al), (bh, bl) = _tf32x3_operands(a3, b3, stream)
            a_sb, b_sb = (0 if t.shape[0] == 1 else t.stride(0) for t in (ah, bh))
            strides = (ctypes.c_int64 * 9)(a_sb, ah.stride(1), b_sb, bh.stride(1), *c_strides,
                                           d.stride(0), d.stride(1))
            codes = (float(alpha), float(beta), act,
                     _DTYPE_CODE[c3.dtype] if c3 is not None else 0, _DTYPE_CODE[out_dtype])
            if nb <= _GRID_MAX and cdiv(m, config.bm) <= _GRID_MAX:
                _gemm_tf32x3(lib, ptr(ah), ptr(al), ptr(bh), ptr(bl), ptr(c3), ptr(bias32),
                             ptr(d), ptr(aux), nb, m, n, k, strides, *codes, stream)
            else:
                # C21: pieces of at most 65535 batches and row tiles
                for bs, ms in _grid_pieces(nb, m, config.bm):
                    a_bs, b_bs = (slice(None) if sb == 0 else bs for sb in (a_sb, b_sb))
                    piece = (ah[a_bs, ms], None if al is None else al[a_bs, ms], bh[b_bs],
                             bl[b_bs], None if c3 is None else c3[bs, ms], bias32, d[bs, ms],
                             None if aux is None else aux[bs, ms])
                    _gemm_tf32x3(lib, *map(ptr, piece), piece[6].shape[0], piece[6].shape[1],
                                 n, k, strides, *codes, stream)
    elif nb and m and n:
        strides = (ctypes.c_int64 * 11)(*a3.stride(), *b3.stride(), *c_strides,
                                        d.stride(0), d.stride(1))
        launch = _gemm_wgmma if route == "wgmma" else _gemm_simt
        codes = (float(alpha), float(beta), _ACT_CODE.get(epilogue.split("_")[0], 0),
                 _DTYPE_CODE[a.dtype], _DTYPE_CODE[c3.dtype] if c3 is not None else 0,
                 _DTYPE_CODE[out_dtype], table.index(config))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if nb <= _GRID_MAX and cdiv(m, config.bm) <= _GRID_MAX:
                launch(lib, ptr(a3), ptr(b3), ptr(c3), ptr(bias32), ptr(d), ptr(aux),
                       nb, m, n, k, strides, *codes, stream)
            else:
                # C21: a grid's y and z extents stop at 65535 blocks, so the
                # batch and the rows go in pieces; each piece is the same
                # operands' views, offset by their strides
                for bs, ms in _grid_pieces(nb, m, config.bm):
                    piece = (a3[bs, ms], b3[bs], None if c3 is None else c3[bs, ms], bias32,
                             d[bs, ms], None if aux is None else aux[bs, ms])
                    launch(lib, *map(ptr, piece), piece[4].shape[0], piece[4].shape[1], n, k,
                           strides, *codes, stream)

    d = d.reshape(batch_shape + (m, n))
    if return_aux:
        return d, aux.reshape(batch_shape + (m, n))
    return d
