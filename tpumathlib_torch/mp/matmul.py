"""Tensor-parallel matmul with its collectives (≙ cuBLASMp tp_matmul.cu).

Counterpart of ``tpumathlib/mp/matmul.py``:
- ``matmul_ag``  ≙ matmul_ag.cu: AllGather(A along rows) + local GEMM
- ``matmul_rs``  ≙ matmul_rs.cu: local GEMM + ReduceScatter(rows of C)
- ``matmul_allreduce`` ≙ matmul_ar.cu (CUBLASMP_MATMUL_EPILOGUE_ALLREDUCE)
- ``tp_matmul``  ≙ tp_matmul.cu: the full TP-MLP cycle (AG+GEMM → GEMM+RS)
- ``gemr2d``     ≙ cublasMpGemr2D: redistribution to another spec

The reference's ``shard_map`` bodies become loops over the ranks of a
``Grid``, and its collectives become copies between the ranks' pieces:
``all_gather`` concatenates every rank's piece on each rank's device;
``psum_scatter`` and ``psum`` sum the ranks' partial products slice by
slice, in rank order 0..P−1. These are the collective routes that the
ring kernels of ``mp.overlap`` (B12a, B12b) are held against.

Operands may be numpy arrays, tensors or ``Sharded``; each is taken with
the in-spec the reference's ``shard_map`` names, resharded first where it
has another (as ``shard_map`` would). Results are ``Sharded`` with the
reference's out-spec. Sharding conventions (row-major):
- matmul_ag:  A: (x, ·) [rows]  B: (·, x) [cols] → D: (·, x)
- matmul_rs:  A: (·, x) [cols]  B: (x, ·) [rows] → D: (x, ·)
- matmul_allreduce: as rs → D replicated, (·, ·).

The products: ``_local_gemm(use_pallas=True)`` is B1 (``dx.gemm.pallas_matmul``,
the repository's kernel); otherwise, and in ``matmul_rs`` and
``matmul_allreduce`` whatever ``use_pallas`` says (as in the reference),
``torch.matmul`` in f32, the vendor path that the reference's ``jnp.matmul``
stands for.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx.gemm import apply_epilogue, pallas_matmul
from tpumathlib_torch.fft.kernels import _f32_products  # noqa: F401  (C16: patched by name)
from tpumathlib_torch.mp.grid import Grid, Sharded, Sharding

F32 = torch.float32


def _mm32(a, b):
    """a @ b in f32 (≙ jnp.matmul(..., preferred_element_type=f32))."""
    with _f32_products():
        return torch.matmul(a.to(F32), b.to(F32))


def _local_gemm(a, b, epilogue: str = "default", bias=None, use_pallas: bool = False):
    if use_pallas:
        return pallas_matmul(a, b, bias=bias, epilogue=epilogue, out_dtype=a.dtype)
    d, _ = apply_epilogue(_mm32(a, b), epilogue, bias.to(F32) if bias is not None else None)
    return d.to(a.dtype)


def _all_gather(x: Sharded, dim: int = 0) -> list:
    """Every rank's piece concatenated along ``dim``, on each rank's device
    (≙ ``jax.lax.all_gather(..., tiled=True)``)."""
    return [torch.cat([p.to(dev) for p in x.pieces], dim=dim) for dev in x.grid.devices]


def _psum_scatter(parts: list, grid: Grid) -> list:
    """Rank r's rows of the sum of ``parts`` (one (m, ...) tensor a rank),
    summed in rank order on rank r's device (≙ ``psum_scatter(tiled=True)``)."""
    m = parts[0].shape[0]
    check(m % grid.size == 0, f"a dimension of {m} does not split over {grid.size} ranks")
    sp = m // grid.size
    out = []
    for r, dev in enumerate(grid.devices):
        acc = parts[0][r * sp:(r + 1) * sp].to(dev, copy=True)
        for q in range(1, grid.size):
            acc += parts[q][r * sp:(r + 1) * sp].to(dev)
        out.append(acc)
    return out


def _psum(parts: list, grid: Grid) -> list:
    """The sum of ``parts`` in rank order, on every rank's device (≙ ``psum``)."""
    out = []
    for dev in grid.devices:
        acc = parts[0].to(dev, copy=True)
        for q in range(1, grid.size):
            acc += parts[q].to(dev)
        out.append(acc)
    return out


def matmul_ag(a, b, grid: Grid, axis: str | None = None, *,
              epilogue: str = "default", bias=None, use_pallas: bool = False) -> Sharded:
    """AllGather+GEMM: A sharded over rows ((axis, None)), B over cols
    ((None, axis)); returns D sharded over cols ((None, axis)). ``bias``
    is sharded (axis,) with B's columns."""
    axis = grid.axis(axis)
    a, b = grid.shard(a, (axis, None)), grid.shard(b, (None, axis))
    biases = grid.shard(bias, (axis,)).pieces if bias is not None else [None] * grid.size
    outs = [_local_gemm(a_full, b_blk, epilogue, bias_blk, use_pallas)
            for a_full, b_blk, bias_blk in zip(_all_gather(a), b.pieces, biases)]
    return Sharded(grid, outs, (None, axis), (a.shape[0], b.shape[1]))


def matmul_rs(a, b, grid: Grid, axis: str | None = None, *,
              use_pallas: bool = False) -> Sharded:
    """GEMM+ReduceScatter: A sharded over cols ((None, axis)), B over rows
    ((axis, None)); partial products are reduce-scattered over output rows
    → D: (axis, None). ``use_pallas`` is accepted and, as in the reference,
    changes nothing: the partial products are ``torch.matmul``."""
    axis = grid.axis(axis)
    a, b = grid.shard(a, (None, axis)), grid.shard(b, (axis, None))
    parts = [_mm32(a_blk, b_blk) for a_blk, b_blk in zip(a.pieces, b.pieces)]
    outs = [d.to(a.dtype) for d in _psum_scatter(parts, grid)]
    return Sharded(grid, outs, (axis, None), (a.shape[0], b.shape[1]))


def matmul_allreduce(a, b, grid: Grid, axis: str | None = None) -> Sharded:
    """GEMM+AllReduce epilogue (≙ CUBLASMP_MATMUL_EPILOGUE_ALLREDUCE,
    matmul_ar.cu:131,239): D replicated on every rank."""
    axis = grid.axis(axis)
    a, b = grid.shard(a, (None, axis)), grid.shard(b, (axis, None))
    parts = [_mm32(a_blk, b_blk) for a_blk, b_blk in zip(a.pieces, b.pieces)]
    outs = [d.to(a.dtype) for d in _psum(parts, grid)]
    return Sharded(grid, outs, (None, None), (a.shape[0], b.shape[1]))


def tp_matmul(x, w1, w2, grid: Grid, axis: str | None = None, *,
              epilogue: str = "gelu", use_pallas: bool = False) -> Sharded:
    """The full TP-MLP cycle of tp_matmul.cu: Phase 1 AG+GEMM (activation
    epilogue fused), Phase 2 GEMM+RS.

    x: (axis, None) (sequence-sharded), w1: (None, axis), w2: (axis, None)
    → out: (axis, None)."""
    axis = grid.axis(axis)
    h = matmul_ag(x, w1, grid, axis, epilogue=epilogue, use_pallas=use_pallas)
    return matmul_rs(h, w2, grid, axis, use_pallas=use_pallas)


def gemr2d(x: Sharded, dst_sharding: Sharding) -> Sharded:
    """Layout redistribution (≙ cublasMpGemr2D): ``x`` resharded to
    ``dst_sharding`` (``grid.sharding(spec)``), each destination piece
    copied from the source pieces that overlap it."""
    return dst_sharding.grid.shard(x, dst_sharding.spec)
