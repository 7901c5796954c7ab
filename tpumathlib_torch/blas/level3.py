"""cuBLAS Level-3: matrix-matrix ops.

Counterpart of ``tpumathlib/blas/level3.py``, all 16 ops: gemm, gemm3m,
gemmBatched, gemmGroupedBatched, gemmStridedBatched, hemm, her2k, herk,
herkx, symm, syr2k, syrk, syrkx, trmm, trsm, trsmBatched.

``gemm`` routes as the reference does: ``backend="auto"`` and ``"xla"`` take
the vendor path (``torch.matmul``, i.e. cuBLAS on the card), and
``backend="pallas"`` takes the repository's own kernel (dx.gemm). Complex
operands always take the vendor path. Everything else is a triangle-select
plus a dense product; ``trsm`` uses ``torch.linalg.solve_triangular``, as the
reference uses jax.scipy.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.blas.level2 import _op, herm_full, sym_full, tri_full
from tpumathlib_torch.dx.gemm import pallas_matmul


def _is_complex(*xs):
    return any(torch.is_complex(x) for x in xs)


def gemm(alpha, a, b, beta=0.0, c=None, transa: str = "N", transb: str = "N",
         backend: str = "auto"):
    """C := alpha*op(A)op(B) + beta*C (cublas<t>gemm,
    cuBLAS/Level-3/gemm/cublas_gemm_example.cu:87). Supports leading batch
    dims (gemmStridedBatched when both operands carry them)."""
    a = _op_nd(a, transa)
    b = _op_nd(b, transb)
    # L3 gemm is always "plain" (no fused epilogue/scales): like the Lt
    # heuristic it takes the vendor path unless backend="pallas" forces the
    # repository's kernel.
    use_xla = backend in ("xla", "auto") or _is_complex(a, b) or a.ndim != b.ndim
    if use_xla:
        r = alpha * _bmm(a, b)
        return r if c is None else r + beta * c
    if a.ndim > 2 and a.shape[:-2] != b.shape[:-2]:
        b = b.expand(a.shape[:-2] + b.shape[-2:])  # stride-0 batch, no copy
    return pallas_matmul(a, b, c=c, alpha=float(alpha), beta=float(beta),
                         out_dtype=(c.dtype if c is not None else a.dtype))


def _op_nd(a, trans):
    trans = trans.upper()
    if trans == "N":
        return a
    return a.mH if trans == "C" else a.mT


def _bmm(a, b):
    return torch.matmul(a, b)


def gemm3m(alpha, a, b, beta=0.0, c=None, transa: str = "N", transb: str = "N"):
    """Complex GEMM with the 3-multiplication (Karatsuba) scheme
    (cublasCgemm3m): (Ar+iAi)(Br+iBi) via 3 real products instead of 4."""
    a = _op_nd(a, transa)
    b = _op_nd(b, transb)
    ar, ai = a.real, a.imag
    br, bi = b.real, b.imag
    t1 = _bmm(ar, br)
    t2 = _bmm(ai, bi)
    t3 = _bmm(ar + ai, br + bi)
    r = torch.complex(t1 - t2, t3 - t1 - t2)
    r = alpha * r.to(a.dtype)
    return r if c is None else r + beta * c


def gemm_batched(alpha, as_, bs, beta=0.0, cs=None, transa: str = "N", transb: str = "N"):
    """Pointer-array batched gemm (cublas<t>gemmBatched): list/stacked inputs,
    uniform shapes."""
    a = torch.stack(list(as_)) if isinstance(as_, (list, tuple)) else as_
    b = torch.stack(list(bs)) if isinstance(bs, (list, tuple)) else bs
    c = torch.stack(list(cs)) if isinstance(cs, (list, tuple)) else cs
    return gemm(alpha, a, b, beta, c, transa, transb)


def gemm_strided_batched(alpha, a, b, beta=0.0, c=None, transa: str = "N",
                         transb: str = "N"):
    """Strided-batch gemm — leading batch dim (cublas<t>gemmStridedBatched)."""
    return gemm(alpha, a, b, beta, c, transa, transb)


def gemm_grouped_batched(alphas, as_, bs, betas=None, cs=None,
                         transas=None, transbs=None):
    """Grouped batched gemm (cublasGemmGroupedBatchedEx): per-group shapes/
    scalars — a Python loop of engine calls."""
    n = len(as_)
    betas = betas or [0.0] * n
    cs = cs or [None] * n
    transas = transas or ["N"] * n
    transbs = transbs or ["N"] * n
    return [
        gemm(alphas[i], as_[i], bs[i], betas[i], cs[i], transas[i], transbs[i])
        for i in range(n)
    ]


# ---------- symmetric / hermitian ----------

def symm(alpha, a, b, beta=0.0, c=None, side: str = "L", uplo: str = "L"):
    """C := alpha*A*B + beta*C with A symmetric (cublas<t>symm)."""
    af = sym_full(a, uplo)
    r = alpha * (af @ b if side.upper() == "L" else b @ af)
    return r if c is None else r + beta * c


def hemm(alpha, a, b, beta=0.0, c=None, side: str = "L", uplo: str = "L"):
    af = herm_full(a, uplo)
    r = alpha * (af @ b if side.upper() == "L" else b @ af)
    return r if c is None else r + beta * c


def _tri_update(c_new, c_old, uplo):
    """syrk-family only updates the referenced triangle of C."""
    ones = torch.ones(c_new.shape[-2:], dtype=torch.bool, device=c_new.device)
    mask = torch.tril(ones) if uplo.upper() == "L" else torch.triu(ones)
    if c_old is None:
        return torch.where(mask, c_new, torch.zeros_like(c_new))
    return torch.where(mask, c_new, c_old.to(c_new.dtype))


def syrk(alpha, a, beta=0.0, c=None, uplo: str = "L", trans: str = "N"):
    """C := alpha*op(A)op(A)^T + beta*C, triangle-only update."""
    aa = a if trans.upper() == "N" else a.mT
    r = alpha * (aa @ aa.mT)
    if c is not None:
        r = r + beta * c
    return _tri_update(r, c, uplo)


def syr2k(alpha, a, b, beta=0.0, c=None, uplo: str = "L", trans: str = "N"):
    aa = a if trans.upper() == "N" else a.mT
    bb = b if trans.upper() == "N" else b.mT
    r = alpha * (aa @ bb.mT + bb @ aa.mT)
    if c is not None:
        r = r + beta * c
    return _tri_update(r, c, uplo)


def syrkx(alpha, a, b, beta=0.0, c=None, uplo: str = "L", trans: str = "N"):
    """C := alpha*op(A)op(B)^T + beta*C (syrk "extended": A,B distinct but
    assumed to produce a symmetric product)."""
    aa = a if trans.upper() == "N" else a.mT
    bb = b if trans.upper() == "N" else b.mT
    r = alpha * (aa @ bb.mT)
    if c is not None:
        r = r + beta * c
    return _tri_update(r, c, uplo)


def herk(alpha, a, beta=0.0, c=None, uplo: str = "L", trans: str = "N"):
    """C := alpha*op(A)op(A)^H + beta*C (alpha, beta real)."""
    aa = a if trans.upper() == "N" else a.mH
    r = alpha * (aa @ aa.mH)
    if c is not None:
        r = r + beta * c
    return _tri_update(r, c, uplo)


def _conj(x):
    return torch.conj(x) if isinstance(x, torch.Tensor) else x.conjugate()


def her2k(alpha, a, b, beta=0.0, c=None, uplo: str = "L", trans: str = "N"):
    aa = a if trans.upper() == "N" else a.mH
    bb = b if trans.upper() == "N" else b.mH
    r = alpha * (aa @ bb.mH) + _conj(alpha) * (bb @ aa.mH)
    if c is not None:
        r = r + beta * c
    return _tri_update(r, c, uplo)


def herkx(alpha, a, b, beta=0.0, c=None, uplo: str = "L", trans: str = "N"):
    aa = a if trans.upper() == "N" else a.mH
    bb = b if trans.upper() == "N" else b.mH
    r = alpha * (aa @ bb.mH)
    if c is not None:
        r = r + beta * c
    return _tri_update(r, c, uplo)


# ---------- triangular ----------

def trmm(alpha, a, b, side: str = "L", uplo: str = "L", transa: str = "N",
         diag: str = "N"):
    """C := alpha*op(A)*B (side=L) or alpha*B*op(A) (side=R), A triangular.
    cuBLAS out-of-place variant."""
    t = _op(tri_full(a, uplo, diag), transa)
    return alpha * (t @ b if side.upper() == "L" else b @ t)


def trsm(alpha, a, b, side: str = "L", uplo: str = "L", transa: str = "N",
         diag: str = "N"):
    """Solve op(A) X = alpha*B (side=L) or X op(A) = alpha*B (side=R)."""
    lower = uplo.upper() == "L"
    tr = transa.upper()
    op_a = _op_nd(a, tr)
    # transposing a triangle swaps lower and upper
    upper = (not lower) if tr == "N" else lower
    return torch.linalg.solve_triangular(
        op_a, alpha * b, upper=upper, left=side.upper() == "L",
        unitriangular=diag.upper() == "U")


def trsm_batched(alpha, a, b, **kw):
    """Batched trsm — leading batch dims (cublas<t>trsmBatched)."""
    return trsm(alpha, a, b, **kw)
