"""Batched small factorizations, solves, least squares and Jacobi eigen/SVD
on the card: kernels B7a–B7i.

Counterpart of ``tpumathlib/dx/solver.py`` (the cuSolverDx tier):
``potrf_batched``, ``getrf_batched``, ``geqrf_batched``, ``gesv_batched``,
``posv_batched``, the lane-packed ``getrf_batched_packed`` and
``potrf_batched_packed``, ``potrf_blocked``, ``unmqr_batched``,
``gels_batched``, ``syevd_batched`` and ``gesvd_batched``, with the
reference's names, checks and return tuples.

The reference runs three step loops (Cholesky, LU with or without partial
pivoting, Householder QR) over VMEM tiles of a batch, or, for n ≤ 64 with
128 % n == 0, over 128//n matrices packed into one lane row. Lane packing is
a TPU layout; here one thread block factors one matrix, so the packed
functions launch the same kernels as the others. Five kernels in
``csrc/dx_solver.cu`` serve seven sites:

- ``tml_potrf_batched`` (B7a potrf, B7i; with a right-hand side B7c, posv),
- ``tml_getrf_batched`` (B7a getrf, B7d; with a right-hand side B7b, gesv),
- ``tml_geqrf_batched`` (B7a geqrf),
- ``tml_unmqr_batched`` (B7e: Qᵀ·C or Q·C from geqrf's reflectors),
- ``tml_gels_batched`` (B7f: the QR steps on m ≥ n rows, Qᵀ·B, then the
  upper substitution);

and two in ``csrc/dx_jacobi.cu``, one thread block a matrix with A and V in
shared memory, over the round-robin schedule ``_roundrobin`` (a table here
where the reference has permutation matrices, because Mosaic cannot gather):

- ``tml_syevd_batched`` (B7g: cyclic two-sided Jacobi, 10 sweeps),
- ``tml_gesvd_batched`` (B7h: one-sided Jacobi, 12 sweeps).

The sweep counts are fixed, with no early exit, as in the reference; the
wrappers sort the results after the kernel (stable, as ``jnp.argsort``).

Everything is computed in f32 and cast back to the input's dtype, as the
reference does. Four faults of the reference are not copied (ROADMAP C10,
C11, C12 and the note under B7f): each Jacobi pair takes one rotation,
with t = 1 where its two diagonal entries (or column norms) are equal
(the reference's per-lane t is 0 there, so a matrix with a constant
diagonal comes back unrotated); gels writes X as the substitution leaves
it (the reference's kernel adds each column's sum times 0, which turns a
column holding an inf wholly to NaN);
every matrix is factored on its own on every route (the reference's
packed routes spread a non-finite value of one matrix to the matrices that
share its lane row), and a NaN in a pivot column is taken as larger than any
number, so the first NaN row is the pivot, as ``numpy.argmax`` picks it
(the reference's pivot becomes ``n``, out of range, and its LU comes back
finite and wrong). Among equal magnitudes the lowest row wins, as in the
reference.

On CPU tensors each wrapper (``_potrf``, ``_getrf``, ``_geqrf``,
``_unmqr``, ``_gels``, ``_syevd``, ``_gesvd``) takes its plain PyTorch
version: batched step loops with the reference's formulas. On CUDA tensors
it launches its kernel or raises. Each wrapper's ``.launches`` counts its
launches. The reference pads a batch to its tile; here nothing is padded.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.dx.gemm import pallas_matmul

F32 = torch.float32
# A block's opt-in shared memory on sm_90; csrc/dx_solver.cu stages a
# matrix (and its right-hand side) there when _smem_bytes fits under it
SMEM_MAX = 232_448


def _smem_bytes(n: int, k: int, m: int | None = None) -> int:
    """Shared memory of one block that holds the matrix: the (m, n | 1)
    matrix (m = n when not given), the (m, k) right-hand side, an m-vector, a
    max(n, k)-vector and an n-vector, plus 4 scalars, in 4-byte words (as
    ``full_bytes`` in csrc/dx_solver.cu)."""
    m = n if m is None else m
    return 4 * (m + max(n, k) + n + 4 + m * (n | 1) + m * k)


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
    """The Householder step loop (``_geqrf_body``, and ``_geqrf_body_rect``
    for m ≥ n): f32 (B, m, n) → (QR, taus (B, n)) in LAPACK geqrf layout.
    dlarfg: alpha = −sign(x_j)·‖x‖ with sign(0) = +1; a zero tail gives
    tau = 0 and leaves the column as it is; the reflector is stored with
    v_j = 1 and tau = tau_h·v_j²."""
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
    return _trsm_upper_rect_plain(lu, x)


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


def _apply_q_plain(qr, taus, c, trans: bool = True):
    """``_apply_q_body``: Qᵀ·C (trans, reflectors ascending) or Q·C
    (descending) from geqrf's reflectors, v_j = 1 and below it qr's column
    j: f32 (B, m, k). Reflectors j ≥ m are empty, as in the reference."""
    qr, taus = qr.to(F32), taus.to(F32)
    c = c.to(F32, copy=True)
    steps = range(min(qr.shape[1], qr.shape[2]))
    for j in (steps if trans else reversed(steps)):
        v = torch.cat([qr.new_ones((qr.shape[0], 1)), qr[:, j + 1:, j]], dim=1)
        w = (v[:, None, :] @ c[:, j:])[:, 0] * taus[:, j, None]
        c[:, j:] -= v[:, :, None] * w[:, None, :]
    return c


def _trsm_upper_rect_plain(qr, b):
    """``_trsm_upper_rect``: R·X = B[:n] with R the upper n × n block of qr
    (B, m, n): f32 (B, n, k)."""
    n = qr.shape[2]
    x = b[:, :n].to(F32, copy=True)
    for j in reversed(range(n)):
        x[:, j] = x[:, j] / qr[:, j, j, None]
        x[:, :j] -= qr[:, :j, j, None] * x[:, j, None]
    return x


def _gels_plain(a, b):
    """``gels_batched``'s kernel: Householder QR of A (B, m, n), m ≥ n, then
    Qᵀ·B and the upper substitution on its first n rows: f32 (B, n, k), as
    the substitution leaves it (the reference's kernel adds each column's
    sum times 0, which turns a column holding an inf wholly to NaN)."""
    qr, taus = _geqrf_plain(a)
    return _trsm_upper_rect_plain(qr, _apply_q_plain(qr, taus, b, True))


@functools.lru_cache(maxsize=16)
def _roundrobin(n: int) -> np.ndarray:
    """Round-robin (circle-method) pairings of n (even) indices: (n − 1,
    n/2, 2) int32, round r pairing 0 with its first rival and the rest from
    both ends — the pairs of ``tpumathlib/dx/solver.py::_roundrobin``, in its
    round order, as a table instead of permutation matrices."""
    assert n % 2 == 0
    table = np.zeros((n - 1, n // 2, 2), np.int32)
    others = list(range(1, n))
    for r in range(n - 1):
        table[r] = [(0, others[0])] + [(others[i], others[-i]) for i in range(1, n // 2)]
        others = others[1:] + others[:1]
    table.flags.writeable = False
    return table


def _live_pairs(n: int) -> np.ndarray:
    """The schedule for n indices: ``_roundrobin`` of n rounded up to even,
    without the pair of the spare index for odd n (a bye each round; the
    reference's sentinel row and column is never rotated either)."""
    table = _roundrobin(n + n % 2)
    if n % 2:
        table = table[(table < n).all(axis=2)].reshape(n, (n - 1) // 2, 2)
    return table


def _rot_t(app, aqq, apq):
    """t = tan θ of each pair's rotation zeroing its coupling apq, the pair
    then turned by [[c, s], [−s, c]] with c = 1/√(1 + t²) and s = t·c:
    tau = (aqq − app)/(2·apq), t = sign(tau)/(|tau| + √(1 + tau²)), t = 1
    at tau = 0 (ROADMAP C12: the reference takes each lane's t from
    sign(0) = 0 and never turns a pair with equal diagonal entries), and
    t = 0, no turn, where |apq| ≤ 1e-30. ``solver.jacobi`` shares it."""
    safe = apq.abs() > 1e-30
    tau = (aqq - app) / (2.0 * torch.where(safe, apq, 1.0))
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    return torch.where(safe, torch.where(tau == 0, 1.0, t), 0.0)


def _rot_pair(app, aqq, apq):
    """(c, s) from ``_rot_t``, c by rsqrt as the reference's ``_rot_coeffs``
    and the kernels take it: on the card the plain version then rounds as
    the kernel does (with 1/sqrt the two drifted 3.0e-5 apart in w at
    n = 64 on an H100)."""
    t = _rot_t(app, aqq, apq)
    c = torch.rsqrt(1.0 + t * t)
    return c, t * c


def _turn(x, p, q, c, s, dim):
    """Rotate the index pairs (p, q) of x along dim (2 columns, 1 rows) by
    (c, s), which broadcast against x[:, :, p] (or x[:, p, :])."""
    xp, xq = x.index_select(dim, p), x.index_select(dim, q)
    x.index_copy_(dim, p, c * xp - s * xq)
    x.index_copy_(dim, q, s * xp + c * xq)


def _syevd_plain(a, sweeps: int = 10):
    """``_syevd_kernel``: cyclic Jacobi over ``_live_pairs``, ``sweeps``
    sweeps: f32 (B, n, n) symmetric → (w, V) unsorted, A's diagonal and the
    product of the rotations. Each round takes every pair's (c, s) from A as
    it stood before the round, then turns A's columns, A's rows and V's
    columns."""
    a = a.to(F32, copy=True)
    bsz, n = a.shape[0], a.shape[-1]
    v = torch.eye(n, dtype=F32, device=a.device).repeat(bsz, 1, 1)
    table = torch.tensor(_live_pairs(n), dtype=torch.long, device=a.device)
    for _ in range(sweeps):
        for pairs in table:
            p, q = pairs[:, 0], pairs[:, 1]
            c, s = _rot_pair(a[:, p, p], a[:, q, q], a[:, p, q])
            c, s = c[:, None, :], s[:, None, :]
            _turn(a, p, q, c, s, 2)
            _turn(a, p, q, c.mT, s.mT, 1)
            _turn(v, p, q, c, s, 2)
    return torch.diagonal(a, dim1=1, dim2=2).clone(), v


def _gesvd_plain(a, sweeps: int = 12):
    """``_gesvd_kernel``: one-sided (Hestenes) Jacobi over ``_live_pairs``,
    ``sweeps`` sweeps: f32 (B, n, n) → (U, s, V) unsorted. Each round takes
    every pair's (c, s) from its columns' squared norms and inner product,
    then turns A's and V's columns; σ_j = ‖a_j‖ and U = A/σ (σ = 0 → 1)."""
    a = a.to(F32, copy=True)
    bsz, n = a.shape[0], a.shape[-1]
    v = torch.eye(n, dtype=F32, device=a.device).repeat(bsz, 1, 1)
    table = torch.tensor(_live_pairs(n), dtype=torch.long, device=a.device)
    for _ in range(sweeps):
        for pairs in table:
            p, q = pairs[:, 0], pairs[:, 1]
            ap, aq = a[:, :, p], a[:, :, q]
            c, s = _rot_pair((ap * ap).sum(1), (aq * aq).sum(1), (ap * aq).sum(1))
            c, s = c[:, None, :], s[:, None, :]
            _turn(a, p, q, c, s, 2)
            _turn(v, p, q, c, s, 2)
    sig = torch.sqrt((a * a).sum(1))
    return a / torch.where(sig > 0, sig, 1.0)[:, None, :], sig, v


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


def _work(a32, m, n, k):
    """The matrix's work space for a block that does not fit in shared
    memory (the kernel then works in place in device memory), else None."""
    return torch.empty_like(a32) if _smem_bytes(n, k, m) > SMEM_MAX else None


def _unmqr(qr, taus, c, trans: bool):
    """Qᵀ·C or Q·C of f32 (B, m, k) through ``tml_unmqr_batched``."""
    if not on_cuda(qr, taus, c):
        return _apply_q_plain(qr, taus, c, trans)
    q32, t32, c32 = (t.to(F32).contiguous() for t in (qr, taus, c))
    bsz, m, n = q32.shape
    k = c32.shape[2]
    x = torch.empty_like(c32)
    work = _work(q32, m, n, k)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(qr.device):
        rc = lib.tml_unmqr_batched(q32.data_ptr(), t32.data_ptr(), c32.data_ptr(), x.data_ptr(),
                                   _ptr(work), bsz, m, n, k, int(trans), _stream(qr.device))
    cuda_utils.check_launch(lib, rc, "tml_unmqr_batched")
    _unmqr.launches += 1
    return x


_unmqr.launches = 0


def _gels(a, b):
    """Least squares of f32 (B, m, n), m ≥ n, against (B, m, k) through
    ``tml_gels_batched``: X (B, n, k). A block that works in place keeps all
    m rows of its right-hand side in X."""
    if not on_cuda(a, b):
        return _gels_plain(a, b)
    a32, b32 = a.to(F32).contiguous(), b.to(F32).contiguous()
    bsz, m, n = a32.shape
    k = b32.shape[2]
    work = _work(a32, m, n, k)
    x = torch.empty((bsz, n if work is None else m, k), dtype=F32, device=a.device)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(a.device):
        rc = lib.tml_gels_batched(a32.data_ptr(), b32.data_ptr(), x.data_ptr(), _ptr(work), bsz,
                                  m, n, k, _stream(a.device))
    cuda_utils.check_launch(lib, rc, "tml_gels_batched")
    _gels.launches += 1
    return x[:, :n]


_gels.launches = 0


@functools.lru_cache(maxsize=16)
def _pair_table(npad: int, device: torch.device) -> torch.Tensor:
    """``_roundrobin(npad)`` as an int32 tensor on the device."""
    return torch.tensor(_roundrobin(npad), device=device)


def _jacobi_operands(a):
    a32 = a.to(F32).contiguous()
    n = a32.shape[-1]
    return a32, a32.shape[0], n, _pair_table(n + n % 2, a.device)


def _syevd(a, sweeps: int):
    """Jacobi eigensolver of f32 (B, n, n) through ``tml_syevd_batched``:
    (w, V) unsorted."""
    if not on_cuda(a):
        return _syevd_plain(a, sweeps)
    a32, bsz, n, pairs = _jacobi_operands(a)
    w = torch.empty((bsz, n), dtype=F32, device=a.device)
    v = torch.empty_like(a32)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(a.device):
        rc = lib.tml_syevd_batched(a32.data_ptr(), pairs.data_ptr(), w.data_ptr(), v.data_ptr(),
                                   bsz, n, sweeps, _stream(a.device))
    cuda_utils.check_launch(lib, rc, "tml_syevd_batched")
    _syevd.launches += 1
    return w, v


_syevd.launches = 0


def _gesvd(a, sweeps: int):
    """One-sided Jacobi SVD of f32 (B, n, n) through ``tml_gesvd_batched``:
    (U, s, V) unsorted."""
    if not on_cuda(a):
        return _gesvd_plain(a, sweeps)
    a32, bsz, n, pairs = _jacobi_operands(a)
    u, v = torch.empty_like(a32), torch.empty_like(a32)
    s = torch.empty((bsz, n), dtype=F32, device=a.device)
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(a.device):
        rc = lib.tml_gesvd_batched(a32.data_ptr(), pairs.data_ptr(), u.data_ptr(), s.data_ptr(),
                                   v.data_ptr(), bsz, n, sweeps, _stream(a.device))
    cuda_utils.check_launch(lib, rc, "tml_gesvd_batched")
    _gesvd.launches += 1
    return u, s, v


_gesvd.launches = 0


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


def unmqr_batched(qr, taus, c, trans: bool = True):
    """Batched ormqr/unmqr: apply Q (trans=False) or Qᵀ (trans=True) from
    geqrf_batched/gels reflectors to C (B, m, k), side L (≙ cuSolverDx
    unmqr). Returns (B, m, k) in c's dtype."""
    check(qr.ndim == 3 and c.ndim == 3, "need (B, m, n), (B, m, k)")
    check(tuple(taus.shape) == (qr.shape[0], qr.shape[2]) and c.shape[:2] == qr.shape[:2],
          f"taus must be (B, n) and C (B, m, k) for QR {tuple(qr.shape)}, not "
          f"{tuple(taus.shape)} and {tuple(c.shape)}")
    return _unmqr(qr, taus, c, trans).to(c.dtype)


def gels_batched(a, b):
    """Batched least squares: min ‖A x − b‖₂ for (B, m, n) with m ≥ n —
    QR, Qᵀb and the upper solve, all in one kernel (≙ cuSolverDx gels).
    Returns (B, n, k) in b's dtype."""
    check(a.ndim == 3 and b.ndim == 3, "need (B, m, n), (B, m, k)")
    check(a.shape[1] >= a.shape[2], "gels needs m >= n")
    check(b.shape[:2] == a.shape[:2],
          f"B must be (B, m, k) for A {tuple(a.shape)}, not {tuple(b.shape)}")
    return _gels(a, b).to(b.dtype)


def syevd_batched(a, sweeps: int = 10):
    """Batched symmetric eigendecomposition: cyclic Jacobi with round-robin
    parallel orderings, ``sweeps`` sweeps and no early exit, as the
    reference. Returns (w, V) with A ≈ V diag(w) Vᵀ, eigenvalues ascending,
    in a's dtype (≙ cuSolverDx syevd / syevjBatched). n ≤ 64."""
    check(a.ndim == 3 and a.shape[1] == a.shape[2], "need (B, n, n)")
    check(a.shape[1] <= 64, "syevd_batched: n <= 64 (VMEM permutation stack)")
    w, v = _syevd(a, sweeps)
    order = torch.argsort(w, dim=1, stable=True)
    w = torch.take_along_dim(w, order, dim=1)
    v = torch.take_along_dim(v, order[:, None, :], dim=2)
    return w.to(a.dtype), v.to(a.dtype)


def gesvd_batched(a, sweeps: int = 12):
    """Batched SVD by one-sided (Hestenes) Jacobi, ``sweeps`` sweeps.
    Returns (U, s, Vᵀ) with A ≈ U diag(s) Vᵀ, singular values descending,
    in a's dtype (≙ cuSolverDx gesvd / cusolverDnSgesvdjBatched). Square,
    n ≤ 64."""
    check(a.ndim == 3 and a.shape[1] == a.shape[2], "need (B, n, n)")
    check(a.shape[1] <= 64, "gesvd_batched: n <= 64 (VMEM permutation stack)")
    u, s, v = _gesvd(a, sweeps)
    order = torch.argsort(-s, dim=1, stable=True)
    s = torch.take_along_dim(s, order, dim=1)
    u = torch.take_along_dim(u, order[:, None, :], dim=2)
    v = torch.take_along_dim(v, order[:, None, :], dim=2)
    return u.to(a.dtype), s.to(a.dtype), v.mT.to(a.dtype)


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
