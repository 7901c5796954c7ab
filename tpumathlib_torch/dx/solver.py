"""Batched small factorizations and solves on the card: kernels B7a–B7d, B7i.

Counterpart of the factor-and-solve part of ``tpumathlib/dx/solver.py``
(the cuSolverDx tier): ``potrf_batched``, ``getrf_batched``,
``geqrf_batched``, ``gesv_batched``, ``posv_batched``, the lane-packed
``getrf_batched_packed`` and ``potrf_batched_packed``, and
``potrf_blocked``, with the reference's names, checks and return tuples.

The reference runs three step loops (Cholesky, LU with or without partial
pivoting, Householder QR) over VMEM tiles of a batch, or, for n ≤ 64 with
128 % n == 0, over 128//n matrices packed into one lane row. Lane packing is
a TPU layout; here one thread block factors one matrix, so the packed
functions launch the same kernels as the others. Three kernels in
``csrc/dx_solver.cu`` serve the five sites:

- ``tml_potrf_batched`` (B7a potrf, B7i; with a right-hand side B7c, posv),
- ``tml_getrf_batched`` (B7a getrf, B7d; with a right-hand side B7b, gesv),
- ``tml_geqrf_batched`` (B7a geqrf).

Everything is computed in f32 and cast back to the input's dtype, as the
reference does. Two faults of the reference are not copied (ROADMAP C10,
C11): every matrix is factored on its own on every route (the reference's
packed routes spread a non-finite value of one matrix to the matrices that
share its lane row), and a NaN in a pivot column is taken as larger than any
number, so the first NaN row is the pivot, as ``numpy.argmax`` picks it
(the reference's pivot becomes ``n``, out of range, and its LU comes back
finite and wrong). Among equal magnitudes the lowest row wins, as in the
reference.

On CPU tensors each wrapper (``_potrf``, ``_getrf``, ``_geqrf``) takes its
plain PyTorch version: batched step loops over j = 0 … n−1 with the
reference's formulas. On CUDA tensors it launches its kernel or raises.
``_potrf.launches``, ``_getrf.launches`` and ``_geqrf.launches`` count the
launches.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import pallas_matmul

F32 = torch.float32
# A block's opt-in shared memory on sm_90; csrc/dx_solver.cu stages a
# matrix (and its right-hand side) there when _smem_bytes fits under it
SMEM_MAX = 232_448


def _smem_bytes(n: int, k: int) -> int:
    """Shared memory of one block that holds the matrix: the (n, n | 1)
    matrix, the (n, k) right-hand side and three n-vectors plus 4 scalars,
    in 4-byte words (as ``full_bytes`` in csrc/dx_solver.cu)."""
    return 4 * (3 * n + 4 + n * (n | 1) + n * k)


# ----------------------------- plain versions -----------------------------


def _potrf_plain(a):
    """The Cholesky step loop (``_potrf_body``): f32 (B, n, n) SPD → lower L.
    Reads the lower triangle only. A non-positive pivot gives NaN from its
    column on, in the lower triangle."""
    a = a.to(F32, copy=True)
    n = a.shape[-1]
    for j in range(n):
        inv = 1.0 / torch.sqrt(a[:, j, j])
        l = a[:, j:, j] * inv[:, None]
        a[:, j:, j] = l
        a[:, j + 1:, j + 1:] -= l[:, 1:, None] * l[:, None, 1:]
    return torch.tril(a)


def _pivot_rows(cand):
    """Row of each batch's pivot in ``cand`` (B, m) of magnitudes: the first
    NaN where there is one, else the first maximum."""
    idx = torch.arange(cand.shape[1], device=cand.device)
    big = cand.shape[1]
    nan = cand.isnan()
    cmax = cand.masked_fill(nan, -1.0).amax(dim=1, keepdim=True)
    first_max = torch.where(cand == cmax, idx, big).amin(dim=1)
    first_nan = torch.where(nan, idx, big).amin(dim=1)
    return torch.where(nan.any(dim=1), first_nan, first_max)


def _getrf_plain(a, pivot: bool = True):
    """The LU step loop (``_getrf_body``): f32 (B, n, n) → (LU, piv int32),
    piv[b, j] the row swapped with j at step j (0-based LAPACK ipiv)."""
    lu = a.to(F32, copy=True)
    bsz, n = lu.shape[0], lu.shape[-1]
    piv = torch.arange(n, dtype=torch.int32, device=lu.device).repeat(bsz, 1)
    rows = torch.arange(bsz, device=lu.device)
    for j in range(n):
        if pivot:
            p = _pivot_rows(lu[:, j:, j].abs()) + j
            piv[:, j] = p.to(torch.int32)
            row_j, row_p = lu[rows, j].clone(), lu[rows, p].clone()
            lu[rows, j] = row_p
            lu[rows, p] = row_j
        l = lu[:, j + 1:, j] / lu[:, j, j, None]
        lu[:, j + 1:, j + 1:] -= l[:, :, None] * lu[:, j, None, j + 1:]
        lu[:, j + 1:, j] = l
    return lu, piv


def _geqrf_plain(a):
    """The Householder step loop (``_geqrf_body``): f32 (B, n, n) → (QR,
    taus) in LAPACK geqrf layout. dlarfg: alpha = −sign(x_j)·‖x‖ with
    sign(0) = +1; a zero tail gives tau = 0 and leaves the column as it is;
    the reflector is stored with v_j = 1 and tau = tau_h·v_j²."""
    a = a.to(F32, copy=True)
    bsz, n = a.shape[0], a.shape[-1]
    taus = a.new_zeros((bsz, n))
    for j in range(n):
        x = a[:, j:, j].clone()
        xj = x[:, 0].clone()
        normx = torch.sqrt((x * x).sum(dim=1))
        tailsq = (x[:, 1:] * x[:, 1:]).sum(dim=1)
        degenerate = tailsq == 0.0
        sign = torch.sign(torch.where(xj == 0, 1.0, xj))
        alpha = torch.where(degenerate, xj, -sign * normx)
        v = x
        v[:, 0] = xj - alpha
        v = torch.where(degenerate[:, None], 0.0, v)
        vsq = (v * v).sum(dim=1)
        safe = vsq > 0
        tau_h = torch.where(safe, 2.0 / torch.where(safe, vsq, 1.0), 0.0)
        w = (v[:, None, :] @ a[:, j:, j:])[:, 0] * tau_h[:, None]
        a[:, j:, j:] -= v[:, :, None] * w[:, None, :]
        vj = xj - alpha
        a[:, j + 1:, j] = v[:, 1:] / torch.where(vj == 0, 1.0, vj)[:, None]
        taus[:, j] = torch.where(safe, tau_h * vj * vj, 0.0)
    return a, taus


def _gesv_plain(a, b):
    """Pivoted LU, the row swaps applied to B in sequence (``_apply_piv``),
    then the unit-lower and the upper substitution (``_trsm_lower_unit``,
    ``_trsm_upper``): f32 (B, n, k)."""
    lu, piv = _getrf_plain(a, True)
    x = b.to(F32, copy=True)
    n = lu.shape[-1]
    rows = torch.arange(x.shape[0], device=x.device)
    for j in range(n):
        p = piv[:, j].long()
        row_j, row_p = x[rows, j].clone(), x[rows, p].clone()
        x[rows, j] = row_p
        x[rows, p] = row_j
    for j in range(n):
        x[:, j + 1:] -= lu[:, j + 1:, j, None] * x[:, j, None]
    for j in reversed(range(n)):
        x[:, j] = x[:, j] / lu[:, j, j, None]
        x[:, :j] -= lu[:, :j, j, None] * x[:, j, None]
    return x


def _posv_plain(a, b):
    """Cholesky, then L·y = B and Lᵀ·x = y (posv's ``fwd`` and ``bwd``):
    f32 (B, n, k)."""
    l = _potrf_plain(a)
    x = b.to(F32, copy=True)
    n = l.shape[-1]
    for j in range(n):
        x[:, j] = x[:, j] / l[:, j, j, None]
        x[:, j + 1:] -= l[:, j + 1:, j, None] * x[:, j, None]
    for j in reversed(range(n)):
        x[:, j] = x[:, j] / l[:, j, j, None]
        x[:, :j] -= l[:, j, :j, None] * x[:, j, None]
    return x


# ----------------------------- kernel wrappers -----------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _operands(a, b=None):
    """f32 contiguous copies for the kernels, and the right-hand side's k
    (0 without one)."""
    check(a.ndim == 3 and a.shape[1] == a.shape[2] >= 1, f"need (B, n, n), not {tuple(a.shape)}")
    check(b is None or (b.ndim == 3 and b.shape[:2] == a.shape[:2]),
          f"B must be (B, n, k) for A {tuple(a.shape)}, not {None if b is None else tuple(b.shape)}")
    check(b is None or b.device == a.device, "A and B on one device")
    a32 = a.to(F32).contiguous()
    b32 = None if b is None else b.to(F32).contiguous()
    return a32, b32, (0 if b is None else b.shape[2])


def _factor_out(a32, k):
    """The factor's output: none for a solve whose matrix fits in shared
    memory (the kernel keeps it there), else an f32 (B, n, n) buffer."""
    n = a32.shape[-1]
    if k and _smem_bytes(n, k) <= SMEM_MAX:
        return None
    return torch.empty_like(a32)


def _potrf(a, b=None):
    """Batched Cholesky of f32 (B, n, n) through ``tml_potrf_batched``: the
    lower factor L, or, with B (B, n, k), the solution X of A·X = B (posv)."""
    if not on_cuda(a, b):
        return _potrf_plain(a) if b is None else _posv_plain(a, b)
    a32, b32, k = _operands(a, b)
    bsz, n = a32.shape[0], a32.shape[-1]
    out = _factor_out(a32, k)
    x = None if b is None else torch.empty_like(b32)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(a.device):
        rc = lib.tml_potrf_batched(a32.data_ptr(), _ptr(out), _ptr(b32), _ptr(x), bsz, n, k,
                                   _stream(a.device))
    cuda_utils.check_launch(lib, rc, "tml_potrf_batched")
    _potrf.launches += 1
    return out if b is None else x


_potrf.launches = 0


def _getrf(a, pivot: bool = True, b=None):
    """Batched LU of f32 (B, n, n) through ``tml_getrf_batched``: (LU, piv),
    or, with B (B, n, k), the solution X of A·X = B (gesv, always
    pivoted)."""
    if not on_cuda(a, b):
        return _getrf_plain(a, pivot) if b is None else _gesv_plain(a, b)
    a32, b32, k = _operands(a, b)
    bsz, n = a32.shape[0], a32.shape[-1]
    out = _factor_out(a32, k)
    piv = torch.empty((bsz, n), dtype=torch.int32, device=a.device) if b is None else None
    x = None if b is None else torch.empty_like(b32)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(a.device):
        rc = lib.tml_getrf_batched(a32.data_ptr(), _ptr(out), _ptr(piv), _ptr(b32), _ptr(x),
                                   bsz, n, k, int(pivot), _stream(a.device))
    cuda_utils.check_launch(lib, rc, "tml_getrf_batched")
    _getrf.launches += 1
    return (out, piv) if b is None else x


_getrf.launches = 0


def _geqrf(a):
    """Batched Householder QR of f32 (B, n, n) through
    ``tml_geqrf_batched``: (QR, taus)."""
    if not on_cuda(a):
        return _geqrf_plain(a)
    a32, _, _ = _operands(a)
    bsz, n = a32.shape[0], a32.shape[-1]
    out = torch.empty_like(a32)
    taus = torch.empty((bsz, n), dtype=F32, device=a.device)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(a.device):
        rc = lib.tml_geqrf_batched(a32.data_ptr(), out.data_ptr(), taus.data_ptr(), bsz, n,
                                   _stream(a.device))
    cuda_utils.check_launch(lib, rc, "tml_geqrf_batched")
    _geqrf.launches += 1
    return out, taus


_geqrf.launches = 0


# ----------------------------- public API -----------------------------


def _packed(n: int) -> bool:
    """The reference's routing to its lane-packed kernels."""
    return n <= 64 and 128 % n == 0


def potrf_batched(a):
    """Batched Cholesky: (B, n, n) SPD → lower L with A = L Lᵀ, in a's dtype.

    ≙ cuSolverDx potrf_batched. n ≤ 64 with 128 % n == 0 goes through
    ``potrf_batched_packed``, as in the reference; both launch the same
    kernel."""
    check(a.ndim == 3 and a.shape[1] == a.shape[2], "need (B, n, n)")
    if _packed(a.shape[1]):
        return potrf_batched_packed(a)
    return _potrf(a).to(a.dtype)


def getrf_batched(a, pivot: bool = True):
    """Batched LU: returns (LU, piv) with the LAPACK packed L\\U layout;
    piv[b, j] = row swapped with j at step j (row-swap sequence, LAPACK
    ipiv convention, 0-based, int32).

    ≙ cuSolverDx getrf_batched with/without partial pivoting. n ≤ 64 with
    128 % n == 0 goes through ``getrf_batched_packed``, as in the
    reference."""
    check(a.ndim == 3 and a.shape[1] == a.shape[2], "need (B, n, n)")
    if _packed(a.shape[1]):
        return getrf_batched_packed(a, pivot)
    lu, piv = _getrf(a, pivot)
    return lu.to(a.dtype), piv


def gesv_batched(a, b):
    """Batched solve A X = B through pivoted LU and both triangular
    substitutions, in one kernel (≙ cuSolverDx gesv_batched). X in b's dtype."""
    check(a.ndim == 3 and b.ndim == 3, "need (B, n, n), (B, n, k)")
    return _getrf(a, True, b).to(b.dtype)


def posv_batched(a, b):
    """Batched SPD solve through Cholesky and two triangular substitutions,
    in one kernel (≙ cuSolverDx posv_batched). X in b's dtype."""
    check(a.ndim == 3 and b.ndim == 3, "need (B, n, n), (B, n, k)")
    return _potrf(a, b).to(b.dtype)


def geqrf_batched(a):
    """Batched Householder QR: returns (packed R + reflectors, taus) in
    LAPACK geqrf layout (≙ cuSolverDx geqrf_batched)."""
    check(a.ndim == 3 and a.shape[1] == a.shape[2], "need (B, n, n)")
    qr, taus = _geqrf(a)
    return qr.to(a.dtype), taus.to(a.dtype)


def getrf_batched_packed(a, pivot: bool = True):
    """Batched LU for n ≤ 64 with 128 % n == 0 (the reference's lane-packed
    kernel). Returns (LU, piv) as ``getrf_batched``; here it launches the
    same kernel, one matrix a block."""
    check(a.ndim == 3 and a.shape[1] == a.shape[2], "need (B, n, n)")
    n = a.shape[1]
    check(n >= 1 and 128 % n == 0, "n must divide 128")
    lu, piv = _getrf(a, pivot)
    return lu.to(a.dtype), piv


def potrf_batched_packed(a):
    """Batched Cholesky for n ≤ 64 with 128 % n == 0 (the reference's
    lane-packed kernel; ≙ cuSolverDx potrf_batched at small sizes)."""
    check(a.ndim == 3 and a.shape[1] == a.shape[2], "need (B, n, n)")
    n = a.shape[1]
    check(n >= 1 and 128 % n == 0, "n must divide 128")
    return _potrf(a).to(a.dtype)


def potrf_blocked(a, block: int = 128):
    """Single large SPD matrix Cholesky: the panel through ``potrf_batched``,
    the panel below it by ``torch.linalg.solve_triangular`` (the reference
    leaves it to XLA), and the trailing update through ``pallas_matmul``
    (B1) — ≙ the cuSolverDx 10_Advanced blocked potrf that composes cuBLASDx.
    Works on an f32 copy of ``a``, whose trailing part is updated in place;
    returns the f32 lower factor."""
    n = a.shape[0]
    check(a.ndim == 2 and a.shape[1] == n, "need square (n, n)")
    check(n % block == 0, "n must be a multiple of block")
    a = a.to(F32, copy=True)
    out = torch.zeros_like(a)
    for s in range(0, n, block):
        e = s + block
        l_ii = potrf_batched(a[None, s:e, s:e])[0]
        out[s:e, s:e] = l_ii
        if e < n:
            # L_bi = A_bi · L_ii^-T
            l_bi = torch.linalg.solve_triangular(l_ii, a[e:, s:e].mT, upper=False).mT
            out[e:, s:e] = l_bi
            a[e:, e:] -= pallas_matmul(l_bi, l_bi.mT)
    return out
