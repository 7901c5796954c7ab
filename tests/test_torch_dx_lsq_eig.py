"""Parity of tpumathlib_torch.dx.solver's least-squares and Jacobi half
(kernels B7e unmqr, B7f gels, B7g syevd, B7h gesvd) with the reference's
Pallas kernels, run in interpret mode, and with LAPACK in float64.

- Every case of tests/test_dx_solver.py:128-214, through both packages on
  the same seeded numpy inputs (drawn in the reference test's order), at
  the reference test's own bounds against float64, and port against
  reference at: eigenvalues and singular values 1e-5 max-scaled (measured
  at most 2.4e-6), gels 1e-5 (2.5e-7; 1.0e-5 on a square Gaussian system,
  whose condition multiplies the two packages' roundings: held at 1e-4),
  unmqr 1e-5 (1.8e-7). Eigenvectors and singular vectors are compared
  after aligning each column's sign, each column's difference times its
  value's gap to its neighbours over the largest value (a vector is only
  as well defined as its gap): 5e-5 against the reference (measured
  9.0e-6: the reference takes one rotation per lane from A(p,q) and
  A(q,p), which drift apart, and its vectors sit up to 1.5e-2 from float64
  at n = 31, whose smallest gap is 1.6e-4 of the largest value) and 2e-6
  against float64 (3.0e-7).
- A (qr, taus) made by the reference's geqrf_batched gives the same Q·C and
  Qᵀ·C in both packages.
- The schedule: the port's _roundrobin pairs are the reference's
  permutation matrices, round by round.
- The checks and their messages: n > 64, m < n, wrong ranks.
- C12 pinned: on 0.5·ones(8, 8) + 0.5·I, whose diagonal is constant, the
  reference returns w = 1 (×8) and s = 1.658 (×8) with no flag; the port
  returns eigvalsh's and svdvals' values.
- The CUDA branch of each wrapper against a CPU emulation of
  tml_unmqr_batched, tml_gels_batched, tml_syevd_batched and
  tml_gesvd_batched that reads the tensors through their pointers and
  shapes: the trans flag, the work space of a block that does not fit in
  shared memory, the schedule table, odd n, the Jacobi kernels' route
  (csrc/dx_jacobi.cu's rule: a warp a matrix to n = 32, a block beyond),
  the sort after the kernel and the launch counts, each route's too.
- The slice as a whole at batch 16 × n 16 (syevd, gesvd) and batch 16 ×
  (24, 10) (gels, unmqr) through the public functions, against the
  reference.

Inputs are explicit f32 on both sides: the suite turns on jax x64.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.core.errors import InvalidValueError as RefInvalidValueError
from tpumathlib.dx import solver as ref
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.core.interop import from_numpy, to_numpy
from tpumathlib_torch.dx import cuda_utils, gemm
from tpumathlib_torch.dx import solver as port
from test_torch_dx_gemm import _view
from test_torch_dx_solver import _EmulatedLib as _EmulatedSolverLib, _batch

torch.set_num_threads(1)

TOL = 1e-5       # values, X and Q·C against the reference, max-scaled
VEC_TOL = 5e-5   # vectors against the reference, signs aligned, times gap / max value
VEC64_TOL = 2e-6   # vectors against float64, the same measure
F32 = torch.float32
_COUNTS = (port._unmqr, port._gels, port._syevd, port._gesvd)


def _rng():
    return np.random.default_rng(42)   # tests/test_dx_solver.py's seed


def _spd(rng, b, n):
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)


def _close(got, want, tol=TOL):
    err = max_scaled_err(got, np.asarray(want).astype(np.float64))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


def _aligned(v, like):
    """v with each column's sign flipped to agree with the same column of like."""
    v, like = np.asarray(v, np.float64), np.asarray(like, np.float64)
    sign = np.sign(np.sum(v * like, axis=-2, keepdims=True))
    return v * np.where(sign == 0, 1.0, sign)


def _vectors_close(got, want, values, tol=VEC_TOL):
    """Each column of got against want's, signs aligned, its largest
    difference times its value's gap to the neighbouring values (float64
    ``values``, sorted) over the largest value."""
    want = np.asarray(want, np.float64)
    err = np.abs(_aligned(to_numpy(got), want) - want).max(axis=-2)
    d = np.abs(np.diff(values, axis=-1))
    inf = np.full(d.shape[:-1] + (1,), np.inf)
    gap = np.minimum(np.concatenate([inf, d], -1), np.concatenate([d, inf], -1))
    worst = (err * gap / np.abs(values).max(axis=-1, keepdims=True)).max()
    assert worst <= tol, f"vectors differ by {worst:.3e} (times gap / max value) > {tol:g}"


def _inputs(draw, sizes):
    """The reference test's inputs, drawn from one seed-42 stream in its order."""
    rng = _rng()
    return {n: draw(rng, n) for n in sizes}


_SYEVD = _inputs(lambda rng, n: _spd(rng, 5, n) - 0.5 * n * np.eye(n, dtype=np.float32),
                 (8, 16, 31))
_GESVD = _inputs(lambda rng, n: rng.normal(size=(4, n, n)).astype(np.float32), (8, 16, 32))


# ---------------------------------------------------------------------------
# tests/test_dx_solver.py:128-214, through both packages

@pytest.mark.parametrize("n", sorted(_SYEVD))
def test_syevd_batched(n):
    a = _SYEVD[n]
    w, v = port.syevd_batched(from_numpy(a))
    assert w.shape == (5, n) and v.shape == (5, n, n) and w.dtype == v.dtype == F32
    rw, rv = ref.syevd_batched(jnp.asarray(a))
    _close(w, rw)
    w64, v64 = np.linalg.eigh(a.astype(np.float64))
    _vectors_close(v, rv, w64)
    _vectors_close(v, v64, w64, VEC64_TOL)
    w, v = to_numpy(w), to_numpy(v)
    for i in range(a.shape[0]):
        wr = np.linalg.eigvalsh(a[i].astype(np.float64))
        np.testing.assert_allclose(w[i], wr, rtol=0, atol=2e-4 * np.abs(wr).max())
        res = a[i] @ v[i] - v[i] * w[i][None, :]
        assert np.abs(res).max() < 5e-4 * np.abs(a[i]).max() * n
        assert np.abs(v[i].T @ v[i] - np.eye(n)).max() < 5e-4


@pytest.mark.parametrize("n", sorted(_GESVD))
def test_gesvd_batched(n):
    a = _GESVD[n]
    u, s, vt = port.gesvd_batched(from_numpy(a))
    assert u.shape == vt.shape == (4, n, n) and s.shape == (4, n)
    ru, rs, rvt = ref.gesvd_batched(jnp.asarray(a))
    _close(s, rs)
    u64, s64, vt64 = np.linalg.svd(a.astype(np.float64))
    _vectors_close(u, ru, s64)
    _vectors_close(vt.mT, np.swapaxes(np.asarray(rvt), 1, 2), s64)
    _vectors_close(u, u64, s64, VEC64_TOL)
    _vectors_close(vt.mT, np.swapaxes(vt64, 1, 2), s64, VEC64_TOL)
    u, s, vt = to_numpy(u), to_numpy(s), to_numpy(vt)
    for i in range(a.shape[0]):
        sr = np.linalg.svd(a[i].astype(np.float64), compute_uv=False)
        np.testing.assert_allclose(s[i], sr, rtol=0, atol=2e-4 * sr.max())
        rec = (u[i] * s[i][None, :]) @ vt[i]
        assert np.abs(rec - a[i]).max() < 5e-4 * np.abs(a[i]).max() * n
        assert np.abs(u[i].T @ u[i] - np.eye(n)).max() < 1e-3
        assert np.abs(vt[i] @ vt[i].T - np.eye(n)).max() < 1e-3


def test_gels_batched():
    rng = _rng()
    b, m, n, k = 4, 24, 10, 3
    a = rng.normal(size=(b, m, n)).astype(np.float32)
    rhs = rng.normal(size=(b, m, k)).astype(np.float32)
    x = port.gels_batched(from_numpy(a), from_numpy(rhs))
    assert x.shape == (b, n, k) and x.dtype == F32
    _close(x, ref.gels_batched(jnp.asarray(a), jnp.asarray(rhs)))
    x = to_numpy(x)
    for i in range(b):
        xr = np.linalg.lstsq(a[i].astype(np.float64), rhs[i].astype(np.float64), rcond=None)[0]
        np.testing.assert_allclose(x[i], xr, rtol=0, atol=5e-4 * np.abs(xr).max())


def test_unmqr_batched_on_the_references_reflectors():
    rng = _rng()
    b, n, k = 3, 16, 5
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    qr, taus = ref.geqrf_batched(jnp.asarray(a))
    c = rng.normal(size=(b, n, k)).astype(np.float32)
    pqr, ptaus = from_numpy(np.asarray(qr)), from_numpy(np.asarray(taus))
    qtc = port.unmqr_batched(pqr, ptaus, from_numpy(c), trans=True)
    qc = port.unmqr_batched(pqr, ptaus, from_numpy(c), trans=False)
    assert qc.shape == (b, n, k) and qc.dtype == F32
    _close(qtc, ref.unmqr_batched(qr, taus, jnp.asarray(c), trans=True))
    _close(qc, ref.unmqr_batched(qr, taus, jnp.asarray(c), trans=False))
    qc = to_numpy(qc)
    for i in range(b):
        back = port.unmqr_batched(pqr[i:i + 1], ptaus[i:i + 1], from_numpy(qc[i:i + 1]), trans=True)
        np.testing.assert_allclose(to_numpy(back)[0], c[i], rtol=0, atol=5e-4)
        np.testing.assert_allclose(np.linalg.norm(qc[i], axis=0), np.linalg.norm(c[i], axis=0),
                                   rtol=5e-4)
    qta = to_numpy(port.unmqr_batched(pqr, ptaus, from_numpy(a), trans=True))
    for i in range(b):
        r = np.triu(np.asarray(qr)[i])
        np.testing.assert_allclose(qta[i], r, rtol=0, atol=5e-4 * np.abs(r).max())


def test_dtype_is_cast_back():
    """f32 arithmetic, results in the input's dtype, as the reference."""
    a = _GESVD[8].astype(np.float64)
    w, v = port.syevd_batched(from_numpy(a + a.transpose(0, 2, 1)))
    u, s, vt = port.gesvd_batched(from_numpy(a))
    assert w.dtype == v.dtype == u.dtype == s.dtype == vt.dtype == torch.float64
    x = port.gels_batched(from_numpy(a.astype(np.float32)), from_numpy(a[:, :, :2]))
    assert x.dtype == torch.float64
    assert port.unmqr_batched(from_numpy(a), from_numpy(a[:, 0]), from_numpy(a[:, :, :3]).half()
                              ).dtype == torch.float16


@pytest.mark.parametrize("m, n", [(32, 32), (64, 32), (48, 10)])
def test_gels_and_unmqr_rectangular_against_the_reference(m, n):
    rng = _rng()
    a = rng.normal(size=(6, m, n)).astype(np.float32)
    b = rng.normal(size=(6, m, 4)).astype(np.float32)
    # a square Gaussian system: its condition multiplies the roundings
    _close(port.gels_batched(from_numpy(a), from_numpy(b)),
           ref.gels_batched(jnp.asarray(a), jnp.asarray(b)), 1e-4 if m == n else TOL)
    qr, taus = port._geqrf_plain(from_numpy(a))
    for trans in (True, False):
        _close(port.unmqr_batched(qr, taus, from_numpy(b), trans),
               ref.unmqr_batched(jnp.asarray(to_numpy(qr)), jnp.asarray(to_numpy(taus)),
                                 jnp.asarray(b), trans=trans))
    # Qᵀ·A is R above, and the reflectors' Q is orthogonal
    q = port.unmqr_batched(qr, taus, torch.eye(m).expand(6, m, m), trans=False)
    assert max_scaled_err(q.mT @ q, torch.eye(m).expand(6, m, m)) < 1e-5
    assert max_scaled_err(q[:, :, :n] @ torch.triu(qr[:, :n]), from_numpy(a)) < 1e-5


# ---------------------------------------------------------------------------
# The schedule, the checks, C12

@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64])
def test_roundrobin_is_the_references(n):
    perms = ref._roundrobin(n)
    table = port._roundrobin(n)
    assert table.shape == (n - 1, n // 2, 2)
    got = np.zeros_like(perms)
    for r in range(n - 1):
        got[r, table[r, :, 0], table[r, :, 1]] = 1.0
        got[r, table[r, :, 1], table[r, :, 0]] = 1.0
    np.testing.assert_array_equal(got, perms)


@pytest.mark.parametrize("n", [1, 3, 7, 31, 63])
def test_live_pairs_of_odd_n_cover_every_pair_once(n):
    table = port._live_pairs(n)
    assert table.shape == (n, (n - 1) // 2, 2) and (table < n).all()
    pairs = {tuple(sorted(p)) for r in table for p in r}
    assert len(pairs) == n * (n - 1) // 2 == table.shape[0] * table.shape[1]


@pytest.mark.parametrize("fn", ["syevd_batched", "gesvd_batched"])
def test_n_above_64_is_refused(fn):
    a = np.broadcast_to(np.eye(65, dtype=np.float32), (1, 65, 65)).copy()
    with pytest.raises(RefInvalidValueError, match="n <= 64"):
        getattr(ref, fn)(jnp.asarray(a))
    with pytest.raises(InvalidValueError, match=f"{fn}: n <= 64"):
        getattr(port, fn)(from_numpy(a))


def test_gels_needs_m_at_least_n():
    a, b = np.ones((2, 5, 6), np.float32), np.ones((2, 5, 1), np.float32)
    with pytest.raises(RefInvalidValueError, match="gels needs m >= n"):
        ref.gels_batched(jnp.asarray(a), jnp.asarray(b))
    with pytest.raises(InvalidValueError, match="gels needs m >= n"):
        port.gels_batched(from_numpy(a), from_numpy(b))


@pytest.mark.parametrize("call, msg", [
    (lambda m: port.gels_batched(m[0], m[0, :, :1]), "need \\(B, m, n\\), \\(B, m, k\\)"),
    (lambda m: port.unmqr_batched(m, m[:, 0], m[0]), "need \\(B, m, n\\), \\(B, m, k\\)"),
    (lambda m: port.syevd_batched(m[0]), "need \\(B, n, n\\)"),
    (lambda m: port.gesvd_batched(m[:, :, :3]), "need \\(B, n, n\\)"),
    (lambda m: port.unmqr_batched(m, m[:, :2, 0], m), "taus must be \\(B, n\\)"),
    (lambda m: port.gels_batched(m, m[:, :3]), "B must be \\(B, m, k\\)"),
])
def test_wrong_ranks_and_shapes_are_refused(call, msg):
    with pytest.raises(InvalidValueError, match=msg):
        call(torch.ones((2, 4, 4)))


def test_reference_checks_the_same_ranks():
    m = jnp.ones((2, 4, 4), jnp.float32)
    for call, msg in ((lambda: ref.gels_batched(m[0], m[0, :, :1]), "need \\(B, m, n\\)"),
                      (lambda: ref.unmqr_batched(m, m[:, 0], m[0]), "need \\(B, m, n\\)"),
                      (lambda: ref.syevd_batched(m[0]), "need \\(B, n, n\\)")):
        with pytest.raises(RefInvalidValueError, match=msg):
            call()


def test_constant_diagonal_is_turned_c12():
    a = 0.5 * np.ones((1, 8, 8), np.float32) + 0.5 * np.eye(8, dtype=np.float32)
    true_w = np.linalg.eigvalsh(a[0].astype(np.float64))          # 0.5 ×7, 4.5
    true_s = np.linalg.svd(a[0].astype(np.float64), compute_uv=False)
    rw = np.asarray(ref.syevd_batched(jnp.asarray(a))[0])[0]
    rs = np.asarray(ref.gesvd_batched(jnp.asarray(a))[1])[0]
    np.testing.assert_allclose(rw, np.ones(8), atol=1e-6)          # the fault
    np.testing.assert_allclose(rs, np.full(8, np.sqrt(2.75)), atol=1e-5)
    w, v = port.syevd_batched(from_numpy(a))
    u, s, vt = port.gesvd_batched(from_numpy(a))
    np.testing.assert_allclose(to_numpy(w)[0], true_w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_numpy(s)[0], true_s, rtol=0, atol=1e-5)
    assert max_scaled_err(v[0] @ torch.diag(w[0]) @ v[0].T, a[0]) < 1e-5
    assert max_scaled_err(u[0] @ torch.diag(s[0]) @ vt[0], a[0]) < 1e-5


def test_equal_column_norms_with_coupling_are_turned_c12():
    """gesvd's tie: two columns of equal norm and non-zero inner product."""
    a = np.array([[[1.0, 0.6], [0.0, 0.8]]], np.float32)   # both columns of norm 1
    s = to_numpy(port.gesvd_batched(from_numpy(a))[1])[0]
    np.testing.assert_allclose(s, np.linalg.svd(a[0].astype(np.float64), compute_uv=False),
                               atol=1e-6)
    rs = np.asarray(ref.gesvd_batched(jnp.asarray(a))[1])[0]
    np.testing.assert_allclose(rs, [1.0, 1.0], atol=1e-6)     # the reference leaves it


def test_gels_inf_column_c18():
    """ROADMAP C18: a zero column j of A leaves R[j, j] = 0, so the back
    substitution writes ±inf in row j of X and NaN above it (0 · inf). The
    reference's kernel adds each column's sum times 0 and turns every column
    of X that holds a non-finite value wholly to NaN; the port writes X as
    its substitution leaves it, so the rows below the zero pivot stay finite
    (and equal the reference's on the other matrices of the batch)."""
    rng = _rng()
    b, m, n, k, j = 3, 12, 6, 2, 2
    a = rng.normal(size=(b, m, n)).astype(np.float32)
    a[1, :, j] = 0.0
    rhs = rng.normal(size=(b, m, k)).astype(np.float32)
    ref_x = np.asarray(ref.gels_batched(jnp.asarray(a), jnp.asarray(rhs)))
    x = to_numpy(port.gels_batched(from_numpy(a), from_numpy(rhs)))
    assert np.isnan(ref_x[1]).all()                     # the reference: whole columns NaN
    assert not np.isfinite(x[1, j]).any()               # the port: inf at the zero pivot,
    assert np.isfinite(x[1, j + 1:]).all()              # finite rows below it
    assert np.isnan(x[1, :j]).all()                     # and NaN above (0 · inf)
    for i in (0, 2):
        assert max_scaled_err(x[i], ref_x[i]) <= TOL


# ---------------------------------------------------------------------------
# The slice as a whole, through the public functions

def test_slice_against_reference():
    rng = _rng()
    g = rng.normal(size=(16, 16, 16)).astype(np.float32)
    sym = (g + g.transpose(0, 2, 1)) / 2
    w, v = port.syevd_batched(from_numpy(sym))
    rw, rv = ref.syevd_batched(jnp.asarray(sym))
    _close(w, rw)
    _vectors_close(v, rv, np.linalg.eigvalsh(sym.astype(np.float64)))
    u, s, vt = port.gesvd_batched(from_numpy(g))
    ru, rs, rvt = ref.gesvd_batched(jnp.asarray(g))
    _close(s, rs)
    _vectors_close(u, ru, np.linalg.svd(g.astype(np.float64), compute_uv=False))
    a = rng.normal(size=(16, 24, 10)).astype(np.float32)
    b = rng.normal(size=(16, 24, 4)).astype(np.float32)
    _close(port.gels_batched(from_numpy(a), from_numpy(b)),
           ref.gels_batched(jnp.asarray(a), jnp.asarray(b)))
    qr, taus = port._geqrf_plain(from_numpy(a))
    rqr, rtaus = jnp.asarray(to_numpy(qr)), jnp.asarray(to_numpy(taus))
    for trans in (True, False):
        _close(port.unmqr_batched(qr, taus, from_numpy(b), trans),
               ref.unmqr_batched(rqr, rtaus, jnp.asarray(b), trans=trans))


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

class _EmulatedLib(_EmulatedSolverLib):
    """Adds the contracts of tml_unmqr_batched, tml_gels_batched (in
    dx_solver.cu) and tml_syevd_batched, tml_gesvd_batched (dx_jacobi.cu),
    computed on the CPU from the raw arguments and the plain versions, the C
    side's refusals included."""

    def _needs_work(self, work, m, n, k):
        return not work and port._smem_bytes(n, k, m) > port.SMEM_MAX

    def tml_unmqr_batched(self, qr, tau, c, x, work, batch, m, n, k, trans, stream):
        # csrc/dx_qr_warp.cuh's unmqr_warp_route and unmqr_panel_route: a warp
        # a matrix for m <= 64, n <= 32, then panels to m = 224, neither
        # reading a work space
        route = "warp" if m <= 64 and n <= 32 else "panel" if m <= 224 else "block"
        self.solver_calls.append(dict(kernel="unmqr", batch=batch, m=m, n=n, k=k,
                                      work=bool(work), trans=trans, route=route))
        if self.rc or (route == "block" and self._needs_work(work, m, n, k)):
            return self.rc or 1
        q = _view(qr, F32, (batch, m, n), (m * n, n, 1)).clone()
        t = _view(tau, F32, (batch, n), (n, 1)).clone()
        out = port._apply_q_plain(q, t, _view(c, F32, (batch, m, k), (m * k, k, 1)).clone(),
                                  bool(trans))
        _view(x, F32, (batch, m, k), (m * k, k, 1)).copy_(out)
        return 0

    def tml_gels_batched(self, a, b, x, work, batch, m, n, k, stream):
        self.solver_calls.append(dict(kernel="gels", batch=batch, m=m, n=n, k=k, work=bool(work)))
        if self.rc or m < n or self._needs_work(work, m, n, k):
            return self.rc or 1
        out = port._gels_plain(_view(a, F32, (batch, m, n), (m * n, n, 1)).clone(),
                               _view(b, F32, (batch, m, k), (m * k, k, 1)).clone())
        rows = m if work else n   # in place: X is the first n of m rows
        _view(x, F32, (batch, rows, k), (rows * k, k, 1))[:, :n].copy_(out)
        return 0

    def _schedule(self, pairs, n):
        npad = n + n % 2
        table = _view(pairs, torch.int32, (npad - 1, npad // 2, 2), (npad, 2, 1))
        assert np.array_equal(table.numpy(), port._roundrobin(npad))
        return table

    def _route(self, n):
        return "warp" if n <= 32 else "block"

    def tml_syevd_batched(self, a, pairs, w, v, batch, n, sweeps, stream):
        self.solver_calls.append(dict(kernel="syevd", batch=batch, n=n, sweeps=sweeps,
                                      route=self._route(n)))
        if self.rc or not 1 <= n <= 64:
            return self.rc or 1
        self._schedule(pairs, n)
        ww, vv = port._syevd_plain(_batch(a, batch, n, n).clone(), sweeps)
        _view(w, F32, (batch, n), (n, 1)).copy_(ww)
        _batch(v, batch, n, n).copy_(vv)
        return 0

    def tml_gesvd_batched(self, a, pairs, u, s, v, batch, n, sweeps, stream):
        self.solver_calls.append(dict(kernel="gesvd", batch=batch, n=n, sweeps=sweeps,
                                      route=self._route(n)))
        if self.rc or not 1 <= n <= 64:
            return self.rc or 1
        self._schedule(pairs, n)
        uu, ss, vv = port._gesvd_plain(_batch(a, batch, n, n).clone(), sweeps)
        _batch(u, batch, n, n).copy_(uu)
        _view(s, F32, (batch, n), (n, 1)).copy_(ss)
        _batch(v, batch, n, n).copy_(vv)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    for mod in (port, gemm):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _grew(before):
    return [f.launches - b for f, b in zip(_COUNTS, before)]


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("m, n, k", [(32, 32, 1), (64, 32, 4), (24, 10, 3)])
def test_cuda_branch_unmqr(emulated, trans, m, n, k):
    rng = _rng()
    qr, taus = port._geqrf_plain(from_numpy(rng.normal(size=(3, m, n)).astype(np.float32)))
    c = from_numpy(rng.normal(size=(3, m, k)).astype(np.float32))
    before = [f.launches for f in _COUNTS]
    got = port.unmqr_batched(qr, taus, c, trans)
    assert _grew(before) == [1, 0, 0, 0]
    assert emulated.solver_calls == [dict(kernel="unmqr", batch=3, m=m, n=n, k=k, work=False,
                                          trans=int(trans), route="warp")]
    assert got.shape == (3, m, k) and torch.equal(got, port._apply_q_plain(qr, taus, c, trans))


@pytest.mark.parametrize("m, n, k", [(32, 32, 1), (64, 32, 4), (48, 10, 4)])
def test_cuda_branch_gels(emulated, m, n, k):
    rng = _rng()
    a = from_numpy(rng.normal(size=(3, m, n)).astype(np.float32))
    b = from_numpy(rng.normal(size=(3, m, k)).astype(np.float32))
    before = [f.launches for f in _COUNTS]
    got = port.gels_batched(a, b)
    assert _grew(before) == [0, 1, 0, 0]
    assert emulated.solver_calls == [dict(kernel="gels", batch=3, m=m, n=n, k=k, work=False)]
    assert got.shape == (3, n, k) and torch.equal(got, port._gels_plain(a, b))


def test_cuda_branch_large_blocks_pass_a_work_space(emulated):
    """m = 300 × n = 200 does not fit a block's shared memory: the kernels
    work in place, gels in all m rows of X, of which it returns n."""
    m, n, k = 300, 200, 2
    assert port._smem_bytes(n, k, m) > port.SMEM_MAX >= port._smem_bytes(32, 4, 64)
    rng = _rng()
    a = from_numpy(rng.normal(size=(1, m, n)).astype(np.float32))
    b = from_numpy(rng.normal(size=(1, m, k)).astype(np.float32))
    x = port.gels_batched(a, b)
    assert emulated.solver_calls[-1]["work"] is True and x.shape == (1, n, k)
    assert max_scaled_err(x, port._gels_plain(a, b)) == 0.0
    qr, taus = port._geqrf_plain(a)
    port.unmqr_batched(qr, taus, b)
    assert emulated.solver_calls[-1]["work"] is True


@pytest.mark.parametrize("n", [1, 2, 7, 16, 31, 32, 33, 64])
def test_cuda_branch_jacobi(emulated, n):
    """The schedule of n rounded up to even goes to the kernel (the emulation
    checks it), the route's counter grows with the launch count, and the
    wrapper sorts what comes back."""
    rng = _rng()
    g = rng.normal(size=(3, n, n)).astype(np.float32)
    sym = from_numpy((g + g.transpose(0, 2, 1)) / 2)
    route = port._jacobi_route(n)
    before = [f.launches for f in _COUNTS]
    routes = [(f.warp_launches, f.block_launches) for f in (port._syevd, port._gesvd)]
    w, v = port.syevd_batched(sym, sweeps=3)
    u, s, vt = port.gesvd_batched(from_numpy(g), sweeps=4)
    assert _grew(before) == [0, 0, 1, 1]
    grew = (1, 0) if route == "warp" else (0, 1)
    assert [(f.warp_launches - w0, f.block_launches - b0) for f, (w0, b0)
            in zip((port._syevd, port._gesvd), routes)] == [grew, grew]
    assert emulated.solver_calls == [dict(kernel="syevd", batch=3, n=n, sweeps=3, route=route),
                                     dict(kernel="gesvd", batch=3, n=n, sweeps=4, route=route)]
    w0, v0 = port._syevd_plain(sym, 3)
    order = torch.argsort(w0, dim=1, stable=True)
    assert torch.equal(w, torch.take_along_dim(w0, order, 1))
    assert torch.equal(v, torch.take_along_dim(v0, order[:, None, :], 2))
    assert bool((w[:, 1:] >= w[:, :-1]).all()) and bool((s[:, 1:] <= s[:, :-1]).all())
    u0, s0, v0 = port._gesvd_plain(from_numpy(g), 4)
    order = torch.argsort(-s0, dim=1, stable=True)
    assert torch.equal(s, torch.take_along_dim(s0, order, 1))
    assert torch.equal(u, torch.take_along_dim(u0, order[:, None, :], 2))
    assert torch.equal(vt, torch.take_along_dim(v0, order[:, None, :], 2).mT)


def test_cuda_branch_raises_on_launch_failure(emulated):
    emulated.rc = 9   # cudaErrorInvalidConfiguration
    a, wide = torch.ones((2, 8, 8)), torch.ones((2, 40, 40))
    before = [f.launches for f in _COUNTS]
    routes = [(f.warp_launches, f.block_launches) for f in (port._syevd, port._gesvd)]
    for run, name in ((lambda: port.unmqr_batched(a, a[:, 0], a), "tml_unmqr_batched"),
                      (lambda: port.gels_batched(a, a), "tml_gels_batched"),
                      (lambda: port.syevd_batched(a), "tml_syevd_batched"),
                      (lambda: port.gesvd_batched(a), "tml_gesvd_batched"),
                      (lambda: port.syevd_batched(wide), "tml_syevd_batched"),
                      (lambda: port.gesvd_batched(wide), "tml_gesvd_batched")):
        with pytest.raises(ExecutionError, match=f"{name}: CUDA error 9"):
            run()
    assert _grew(before) == [0, 0, 0, 0]
    assert [(f.warp_launches, f.block_launches) for f in (port._syevd, port._gesvd)] == routes


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    """For CUDA tensors the wrappers launch or raise, never fall back."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(port, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    a = torch.ones((2, 8, 8))
    for run in (lambda: port.unmqr_batched(a, a[:, 0], a), lambda: port.gels_batched(a, a),
                lambda: port.syevd_batched(a), lambda: port.gesvd_batched(a)):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            run()


def test_cpu_takes_plain_versions_without_launch():
    g = torch.from_numpy(_GESVD[8])
    before = [f.launches for f in _COUNTS]
    port.syevd_batched(g + g.mT)
    port.gesvd_batched(g)
    port.gels_batched(g, g)
    port.unmqr_batched(g, g[:, 0], g)
    assert _grew(before) == [0, 0, 0, 0]


# ---------------------------------------------------------------------------
# tml_gels_batched's warp route, mirrored in numpy (csrc/dx_solver.cu's
# gels_warp_kernel on csrc/dx_qr_warp.cuh's QR core; the models of the QR
# and of the reflectors' application serve tests/test_torch_dx_qr_warp.py
# too)

def _sum4(term, lo, m, shape):
    """The kernel's sum of term(r) over rows lo ≤ r < m: four partial sums by
    row mod 4, added as (s0 + s1) + (s2 + s3)."""
    part = np.zeros((4,) + shape, np.float32)
    for r in range(lo, m):
        part[r % 4] = part[r % 4] + term(r)
    return (part[0] + part[1]) + (part[2] + part[3])


def _model_warp_qr(a):
    """gels_qr_steps (csrc/dx_qr_warp.cuh) on f32 A (B, m, n), m ≤ 64, n ≤
    32, as gels_warp_kernel and geqrf_warp_kernel run it: lane c holds
    column c of A (rows to 32·R, zeros past m and n that take no part).
    Step j: the tail's sum of squares (``_sum4``), then x_j² added, and
    geqrf_steps' dlarfg scalars; every lane c ≥ j forms w_c = tau_h·Σ v_r
    a_rc (``_sum4``) and subtracts v_r w_c (lane j keeps R's entry and
    v_r / v_j below it, as the kernels' division after the last step leaves
    it). Without the kernels' FMAs. Returns (col, taus): col[:, c, r] =
    QR(r, c) as stored (B, 32, 32·R), taus (B, n)."""
    bsz, m, n = a.shape
    mm = 32 if m <= 32 else 64
    lanes = np.arange(32)
    col = np.zeros((bsz, 32, mm), np.float32)      # col[:, c, r] = A(r, c)
    col[:, :n, :m] = a.transpose(0, 2, 1)
    taus = np.zeros((bsz, n), np.float32)
    f32 = np.float32
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for j in range(n):
            cj = col[:, j]
            ts = _sum4(lambda r: cj[:, r] * cj[:, r], j + 1, m, (bsz,))
            xj = cj[:, j].copy()
            ss = ts + xj * xj
            degenerate = ts == 0
            sign = np.where(xj > 0, f32(1), np.where(xj < 0, f32(-1), np.where(xj == 0, f32(1), xj)))
            alpha = np.where(degenerate, xj, -sign * np.sqrt(ss))
            vj = xj - alpha
            vsq = np.where(degenerate, f32(0), ts + vj * vj)
            safe = vsq > 0
            tau_h = np.where(safe, f32(2) / np.where(safe, vsq, f32(1)), f32(0))
            vdiv = np.where(vj == 0, f32(1), vj)
            taus[:, j] = np.where(safe, tau_h * vj * vj, f32(0))
            v = np.where(degenerate[:, None], f32(0), cj.copy())
            v[:, j] = np.where(degenerate, f32(0), vj)
            acc = _sum4(lambda r: v[:, r, None] * col[:, :, r], j, m, (bsz, 32))
            wc = np.where(degenerate[:, None], f32(0), acc * tau_h[:, None])
            upd = (lanes >= j) & (lanes < n)
            for r in range(j, m):
                col[:, :, r] = np.where(upd, col[:, :, r] - v[:, r, None] * wc, col[:, :, r])
            col[:, j, j + 1:m] = v[:, j + 1:m] / vdiv[:, None]
    return col, taus


def _butterfly(s):
    """The 5-step xor butterfly over the lanes (axis 1) of s (B, 32, ...):
    every lane ends with the same sum."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ off]
    return s


def _model_warp_apply(qr, taus, c, trans=True, sums=_butterfly):
    """The stored reflectors of qr (B, m, n) applied to C (B, m, k), m ≤ 64,
    as gels_warp_kernel (Qᵀ·B) and unmqr_warp_kernel take them: v_j = 1 and
    below it qr's column j, tau_j; ascending for Qᵀ·C, descending for Q·C,
    over min(m, n) reflectors. Lane r holds rows r and r + 32 (zeros past
    m); each lane's rows summed (row r, then r + 32), the lanes added by
    ``sums`` (the kernel's reduction: every lane gets each column's sum),
    then each row updated. Without the kernels' FMAs. Returns (B, m, k)."""
    bsz, m, n = qr.shape
    k = c.shape[-1]
    mm = 32 if m <= 32 else 64
    xs = np.zeros((bsz, mm // 32, 32, k), np.float32)   # xs[:, q, lane] = C's row lane + 32 q
    xs.reshape(bsz, mm, k)[:, :m] = c
    steps = range(min(m, n))
    with np.errstate(invalid="ignore", over="ignore"):
        for j in (steps if trans else reversed(steps)):
            vr = np.zeros((bsz, mm), np.float32)
            vr[:, j + 1:m] = qr[:, j + 1:m, j]
            vr[:, j] = 1
            on = ((np.arange(mm) >= j) & (np.arange(mm) < m)).reshape(mm // 32, 32)
            vr = vr.reshape(bsz, mm // 32, 32)
            s = np.zeros((bsz, 32, k), np.float32)
            for q in range(mm // 32):
                s = np.where(on[q][:, None], s + vr[:, q, :, None] * xs[:, q], s)
            wq = sums(s) * taus[:, j, None, None]
            xs = np.where(on[None, :, :, None], xs - vr[..., None] * wq[:, None], xs)
    return xs.reshape(bsz, mm, k)[:, :m]


def _model_warp_gels(a, b):
    """gels_warp_kernel on f32 A (B, m, n) and B (B, m, k), m ≤ 64, n, k ≤
    32: the QR steps (``_model_warp_qr``), then B takes the stored
    reflectors in order (``_model_warp_apply``: each lane's rows summed, the
    lanes added by the 5-step xor butterfly, then each row updated), then
    R·X = Y by warp_solve_step's steps, j descending. Without the kernel's
    FMAs. Returns X (B, n, k)."""
    bsz, m, n = a.shape
    col, taus = _model_warp_qr(a)
    y = _model_warp_apply(col[:, :n, :m].transpose(0, 2, 1), taus, b)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        r_rows = col[:, :, :32].transpose(0, 2, 1)     # r_rows[:, r, c] = R(r, c)
        x = np.zeros((bsz, 32, b.shape[-1]), np.float32)
        x[:, :min(m, 32)] = y[:, :32]
        for j in reversed(range(n)):
            yj = x[:, j] / r_rows[:, j, j, None]
            x[:, j] = yj
            x[:, :j] = x[:, :j] - r_rows[:, :j, j, None] * yj[:, None]
    return x[:, :n]


def _gels_cases(m, n, k):
    rng = _rng()
    a = rng.normal(size=(5, m, n)).astype(np.float32)
    b = rng.normal(size=(5, m, k)).astype(np.float32)
    if n > 3:
        a[1, :, 3] = 0.0   # C18: R[3, 3] = 0, inf in X's row 3 and NaN above
    return a, b


@pytest.mark.parametrize("m, n, k", [(64, 32, 4), (33, 1, 1), (48, 10, 4), (32, 32, 32),
                                     (64, 32, 32)])
def test_gels_warp_model_against_the_plain_version(m, n, k):
    """The warp route's model against _gels_plain: the same NaN and inf, and
    on the finite matrices within 1e-6 of max(|X|, 1) times A's condition
    (chip_smoke.py's DXE_TOL for the kernel: the two sum in other orders) and
    within the reference test's 5e-4 of float64 least squares."""
    a, b = _gels_cases(m, n, k)
    x = _model_warp_gels(a, b)
    with np.errstate(invalid="ignore", divide="ignore"):
        want = to_numpy(port._gels_plain(from_numpy(a), from_numpy(b)))
    np.testing.assert_array_equal(np.isnan(x), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(x), np.isinf(want))
    good = [i for i in range(5) if np.isfinite(want[i]).all()]
    assert len(good) >= 4
    cond = np.linalg.cond(a[good].astype(np.float64))
    diff = np.abs(x[good] - want[good]).reshape(len(good), -1).max(1)
    scale = np.maximum(np.abs(want[good]).reshape(len(good), -1).max(1), 1)
    assert (diff / scale / cond).max() <= 1e-6
    for i in good:
        x64 = np.linalg.lstsq(a[i].astype(np.float64), b[i].astype(np.float64), rcond=None)[0]
        np.testing.assert_allclose(x[i], x64, rtol=0, atol=5e-4 * np.abs(x64).max())


def test_gels_warp_model_zero_column_c18():
    """C18 on the warp route: the zero column's row of X is inf, the rows
    above NaN (0 · inf), the rows below finite, as the plain version."""
    a, b = _gels_cases(64, 32, 4)
    x = _model_warp_gels(a, b)
    assert not np.isfinite(x[1, 3]).any() and np.isnan(x[1, :3]).all()
    assert np.isfinite(x[1, 4:]).all() and np.isfinite(x[[0, 2, 3, 4]]).all()


def test_gels_routes():
    assert [port._gels_route(m, n, k) for m, n, k in (
        (1, 1, 1), (32, 32, 32), (33, 1, 1), (64, 32, 32), (64, 32, 0), (65, 32, 4), (65, 1, 1),
        (64, 33, 4), (64, 32, 33), (300, 200, 2))] == [
        "warp", "warp", "warp", "warp", "warp", "block", "block", "block", "block", "block"]


@pytest.mark.parametrize("m, n, k", [(64, 32, 4), (33, 1, 1), (32, 32, 32), (65, 32, 4),
                                     (64, 32, 33)])
def test_cuda_branch_gels_counts_its_route(emulated, m, n, k):
    """Each gels launch grows ``_gels.launches`` and its route's count, and
    no work space goes to the warp route."""
    rng = _rng()
    a = from_numpy(rng.normal(size=(2, m, n)).astype(np.float32))
    b = from_numpy(rng.normal(size=(2, m, k)).astype(np.float32))
    before = (port._gels.launches, port._gels.warp_launches, port._gels.block_launches)
    got = port.gels_batched(a, b)
    warp = port._gels_route(m, n, k) == "warp"
    assert (port._gels.launches, port._gels.warp_launches, port._gels.block_launches) == (
        before[0] + 1, before[1] + int(warp), before[2] + int(not warp))
    assert emulated.solver_calls[-1]["work"] is False
    assert torch.equal(got, port._gels_plain(a, b))
