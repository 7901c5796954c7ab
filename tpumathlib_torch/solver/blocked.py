"""The blocked-panel Cholesky (kernel B4c) and the fused 128×128 Cholesky +
inverse sweep of the blocked factorizations.

Counterpart of ``tpumathlib/solver/blocked.py``: ``_chol_inv128`` (``:96``)
and ``potrf_blocked`` (``:203``, panel kernel ``_panel_kernel`` ``:128``).
On CUDA tensors ``_chol_inv128`` launches ``tml_chol_inv_block``
(``csrc/dense_block.cu``, which reaches the same factors in its own order);
on CPU tensors it takes ``_chol_inv128_plain``, the reference's sweep as a
torch loop.

The reference's panel kernel holds an (m, p) panel in VMEM and does, per
128-column block, the sweep, the trsm ``L21 = A21·inv(L11)ᵀ`` and the
in-panel update; between panels an XLA syrk in a 3-pass bf16 split updates
the trailing matrix. The panel is 4 MB at n = 4096 and does not fit in a
block's 227 KB of shared memory, so here the panel stays in device memory
and each step is a kernel of the repository: the sweep is
``tml_chol_inv_block`` and every product (trsm, in-panel update, trailing
syrk) is B1, ``dx.gemm.pallas_matmul``, in f32 FMA. The bf16 split is a TPU
workaround, not part of the contract; B1 reads no TF32 setting.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import _pallas_matmul_plain, pallas_matmul
from tpumathlib_torch.fft.kernels import _f32_products

_NB = 128


def _check_block(d) -> None:
    check(d.shape == (_NB, _NB) and d.dtype == torch.float32,
          f"a ({_NB}, {_NB}) f32 block, not {tuple(d.shape)} {d.dtype}")


def _chol_inv128_plain(d):
    """(L, W = inv(L)) of an SPD (128, 128) block: the reference's sweep in torch.

    Step j scales by rs = 1/sqrt(d[j, j]) (NaN for a negative pivot), updates
    the trailing block, and carries the inverse in ``r`` (W[i] = r[i]·rs_i).
    The rows of ``d`` hold L's columns, as the reference's U storage does."""
    d = d.to(torch.float32).clone()
    nb = d.shape[0]
    r = torch.eye(nb, dtype=d.dtype, device=d.device)
    rs = torch.empty(nb, dtype=d.dtype, device=d.device)
    for j in range(nb):
        s = 1.0 / torch.sqrt(d[j, j])
        rs[j] = s
        vc = (d[j + 1:, j] * s)[:, None]
        d[j + 1:, j + 1:] -= vc * (d[j, j + 1:] * s)
        r[j + 1:, :j + 1] -= vc * (r[j, :j + 1] * s)
    return torch.tril(d.T * rs), torch.tril(r * rs[:, None])


def _launch_block(entry: str, a, outs: int, extra=()) -> list:
    """Launch one 128×128 sweep of the kernel library on the current stream:
    ``entry(a, lda, out_1, ld_1, ..., out_outs, ld_outs, *extra, stream)``,
    with fresh (128, 128) f32 outputs, which it returns. Raises on a failed
    build, load or launch."""
    lib = cuda_utils.load_kernels()
    check(a.stride(-1) == 1, "the block needs unit column stride")
    res = [torch.empty((_NB, _NB), dtype=torch.float32, device=a.device) for _ in range(outs)]
    args = [a.data_ptr(), a.stride(0)]
    for t in res:
        args += [t.data_ptr(), t.stride(0)]
    with torch.cuda.device(a.device):
        rc = getattr(lib, entry)(*args, *(t.data_ptr() for t in extra),
                                 torch.cuda.current_stream(a.device).cuda_stream)
    cuda_utils.check_launch(lib, rc, entry)
    return res


def _chol_inv128(d):
    """Fused Cholesky + inverse of a (128, 128) f32 SPD block: (L, inv(L)),
    L lower with its strict upper triangle exactly 0. ``d`` is symmetric:
    the kernel reads its lower triangle, the plain version both."""
    _check_block(d)
    if not on_cuda(d):
        return _chol_inv128_plain(d)
    l, w = _launch_block("tml_chol_inv_block", d, 2)
    _chol_inv128.launches += 1
    return l, w


_chol_inv128.launches = 0


def _potrf_blocked(a, panel: int, mm, chol_inv):
    """Right-looking blocked Cholesky by panels of ``panel`` columns (the last
    may be shorter), as the reference's ``potrf_blocked``; ``mm(a, b, c,
    alpha=, beta=)`` is the product and ``chol_inv`` the 128×128 sweep. The
    strict upper triangle still holds A until the last ``tril``."""
    n = a.shape[0]
    work = a.to(torch.float32).clone(memory_format=torch.contiguous_format)
    for s in range(0, n, panel):
        p = min(panel, n - s)
        pan = work[s:, s:s + p]                  # (m, p): the panel, factored in place
        for j0 in range(0, p, _NB):
            j1 = j0 + _NB
            l, w = chol_inv(pan[j0:j1, j0:j1])
            pan[j0:j1, j0:j1] = l
            if j1 < pan.shape[0]:   # trsm: L21 = A21 · inv(L11)^T
                pan[j1:, j0:j1] = mm(pan[j1:, j0:j1], w.mT)
            if j1 < p:              # in-panel update: A[j1:, j1:p] -= L[j1:, blk] · L[j1:p, blk]^T
                pan[j1:, j1:p] = mm(pan[j1:, j0:j1], pan[j1:p, j0:j1].mT, pan[j1:, j1:p],
                                    alpha=-1.0, beta=1.0)
        if s + p < n:               # trailing syrk: A22 -= L21 · L21^T
            l21 = pan[p:]
            work[s + p:, s + p:] = mm(l21, l21.mT, work[s + p:, s + p:], alpha=-1.0, beta=1.0)
    return torch.tril(work)


def _mm_f32(a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
    """B1's plain version, alpha·A@B + beta·C, with f32 products pinned."""
    with _f32_products():
        return _pallas_matmul_plain(a, b, c, out_dtype=torch.float32, alpha=alpha, beta=beta)


def _potrf_blocked_plain(a, panel: int = 256):
    return _potrf_blocked(a, panel, _mm_f32, _chol_inv128_plain)


def potrf_blocked(a, panel: int = 256):
    """Cholesky factor (lower; strict upper triangle exactly 0) of one large
    f32 SPD matrix, read whole (both triangles), by panels of ``panel``
    columns (the last may be shorter). n and ``panel`` must be multiples of
    128: the reference sweeps only whole 128-column blocks of a panel and
    leaves the rest of a panel of another width unfactored, with no error
    (ROADMAP C19), so the port refuses it. A non-SPD input gives non-finite
    values from the failing block on; there is no ``info``.

    On CUDA tensors every 128-block sweep is one ``tml_chol_inv_block`` and
    every product one B1 launch: at n = 4096, panel 256, 32 sweeps and 62
    products (31 trsm, 16 in-panel updates, 15 trailing syrks)."""
    n = a.shape[0]
    check(a.ndim == 2 and a.shape == (n, n) and n % _NB == 0,
          f"a square matrix with n % {_NB} == 0, not {tuple(a.shape)}")
    check(panel > 0 and panel % _NB == 0,
          f"panel must be a positive multiple of {_NB}, not {panel}")
    if not on_cuda(a):
        return _potrf_blocked_plain(a, panel)
    out = _potrf_blocked(a, panel, pallas_matmul, _chol_inv128)
    potrf_blocked.launches += 1
    return out


potrf_blocked.launches = 0
