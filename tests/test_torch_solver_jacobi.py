"""Parity of tpumathlib_torch.solver.jacobi and of the eigen/SVD drivers of
tpumathlib_torch.solver.dense (xsyevd, xsyevdx, xsygvd, xgesvd) with the
reference's, which run no kernel of the repository.

- Every case of tests/test_solver_jacobi.py and of
  tests/test_solver_dense.py:110-146, through both packages on the same
  seeded float64 inputs (the suite's seed-1234 ``rng``), at those tests'
  tolerances against SciPy, and the two packages against each other: values
  1e-12 max-scaled, vectors 1e-10 (measured at most 1.4e-14) in float64.
- The same in float32 (tol 1e-6): values 1e-5 against the reference and
  2e-5 against SciPy.
- ``sweeps`` and ``residual`` of each matrix of a batch whose matrices stop
  at different sweeps equal the reference's: the port freezes a matrix once
  it has converged, as the reference's vmapped while_loop does, and sums
  its residuals in the reference's order. (On ill-conditioned input the
  stop hangs on the products' last bits, and the two may part: ROADMAP C13.)
- C13 pinned: a graded spectrum leaves U far from orthogonal in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from tpumathlib.solver import dense as rdense
from tpumathlib.solver import jacobi as ref
from tpumathlib_torch.core.check import assert_allclose, max_scaled_err
from tpumathlib_torch.core.errors import InvalidValueError
from tpumathlib_torch.solver import (gesvdj, gesvdj_batched, jacobi, syevj, syevj_batched, sygvj,
                                     xgesvd, xsyevd, xsyevdx, xsygvd)

torch.set_num_threads(1)

N = 24


def _same(got, want, tol=1e-12):
    err = max_scaled_err(got, np.asarray(want))
    assert err <= tol, f"port vs reference: max-scaled err {err:.3e} > {tol:g}"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# tests/test_solver_jacobi.py, through both packages

def test_round_robin_schedule():
    for n in (4, 6, 8, 10, 7, 13):
        sched = jacobi._round_robin(n)
        np.testing.assert_array_equal(sched, ref._round_robin(n))
        if n % 2 == 0:
            assert len({tuple(sorted(p)) for r in sched for p in r}) == n * (n - 1) // 2
            for r in sched:
                flat = [i for p in r for i in p]
                assert len(set(flat)) == len(flat)


@pytest.mark.parametrize("n", [8, 13, 16])
def test_syevj(rng, n):
    a0 = rng.normal(size=(n, n))
    a = (a0 + a0.T) / 2
    w, v, res, sweeps = syevj(_t(a), tol=1e-12, max_sweeps=30)
    rw, rv, rres, rsweeps = ref.syevj(jnp.asarray(a), tol=1e-12, max_sweeps=30)
    ww = scipy.linalg.eigvalsh(a)
    assert_allclose(w, ww, rtol=1e-9)
    assert_allclose(a @ v.numpy(), v.numpy() * w.numpy(), rtol=1e-8)
    assert int(sweeps) <= 30 and float(res) >= 0
    assert sweeps.dtype == torch.int32 and int(sweeps) == int(rsweeps)
    assert float(res) == pytest.approx(float(rres), abs=1e-12)
    _same(w, rw)
    _same(v, rv, 1e-10)


def test_syevj_batched(rng):
    a0 = rng.normal(size=(4, 10, 10))
    a = (a0 + np.swapaxes(a0, -1, -2)) / 2
    w, v, res, sweeps = syevj_batched(_t(a), tol=1e-12, max_sweeps=30)
    assert w.shape == (4, 10) and v.shape == (4, 10, 10) and res.shape == sweeps.shape == (4,)
    for i in range(4):
        assert_allclose(w[i], scipy.linalg.eigvalsh(a[i]), rtol=1e-8)
    rw, rv, rres, rsweeps = ref.syevj(jnp.asarray(a), tol=1e-12, max_sweeps=30)
    _same(w, rw)
    np.testing.assert_array_equal(sweeps.numpy(), np.asarray(rsweeps))


def test_sygvj(rng):
    n = 10
    a0 = rng.normal(size=(n, n))
    a = (a0 + a0.T) / 2
    b0 = rng.normal(size=(n, n))
    b = b0 @ b0.T / n + 2 * np.eye(n)
    w, x, res, sweeps = sygvj(_t(a), _t(b), tol=1e-12, max_sweeps=30)
    assert_allclose(w, scipy.linalg.eigvalsh(a, b), rtol=1e-8)
    rw, rx, rres, rsweeps = ref.sygvj(jnp.asarray(a), jnp.asarray(b), tol=1e-12, max_sweeps=30)
    _same(w, rw)
    _same(x, rx, 1e-10)
    assert int(sweeps) == int(rsweeps)


@pytest.mark.parametrize("shape", [(16, 16), (24, 10), (15, 9)])
def test_gesvdj(rng, shape):
    a = rng.normal(size=shape)
    u, s, v, res, sweeps = gesvdj(_t(a), tol=1e-12, max_sweeps=30)
    assert_allclose(s, scipy.linalg.svdvals(a), rtol=1e-9)
    assert_allclose(u.numpy() @ np.diag(s.numpy()) @ v.numpy().T, a, rtol=1e-8)
    assert_allclose(v.numpy().T @ v.numpy(), np.eye(shape[1]), rtol=1e-8)
    ru, rs, rv, rres, rsweeps = ref.gesvdj(jnp.asarray(a), tol=1e-12, max_sweeps=30)
    _same(s, rs)
    _same(u, ru, 1e-10)
    _same(v, rv, 1e-10)
    assert int(sweeps) == int(rsweeps) and float(res) == pytest.approx(float(rres), abs=1e-12)


def test_gesvdj_batched(rng):
    a = rng.normal(size=(3, 12, 8))
    u, s, v, res, sweeps = gesvdj_batched(_t(a), tol=1e-12)
    for i in range(3):
        assert_allclose(s[i], scipy.linalg.svdvals(a[i]), rtol=1e-8)
    ru, rs, rv, rres, rsweeps = ref.gesvdj_batched(jnp.asarray(a), tol=1e-12)
    _same(s, rs)
    np.testing.assert_array_equal(sweeps.numpy(), np.asarray(rsweeps))


def test_gesvda_truncated(rng):
    a = rng.normal(size=(2, 16, 12))
    u, s, v, _, _ = jacobi.gesvda_strided_batched(_t(a), rank=4, tol=1e-12)
    assert s.shape == (2, 4) and u.shape == (2, 16, 4) and v.shape == (2, 12, 4)
    for i in range(2):
        assert_allclose(s[i], scipy.linalg.svdvals(a[i])[:4], rtol=1e-8)
    _same(s, ref.gesvda_strided_batched(jnp.asarray(a), rank=4, tol=1e-12)[1])


def test_max_sweeps_cap(rng):
    a0 = rng.normal(size=(16, 16))
    a = (a0 + a0.T) / 2
    w, v, res, sweeps = syevj(_t(a), tol=0.0, max_sweeps=2)
    assert int(sweeps) == 2
    rres = ref.syevj(jnp.asarray(a), tol=0.0, max_sweeps=2)[2]
    assert float(res) == pytest.approx(float(rres), rel=1e-9)


def test_gesvdj_needs_a_tall_matrix():
    with pytest.raises(InvalidValueError, match="gesvdj expects m >= n"):
        gesvdj(torch.ones((3, 5), dtype=torch.float64))


# ---------------------------------------------------------------------------
# sweeps and residual per matrix, as the reference's vmapped while_loop

def _mixed_batch(rng, n):
    """Four symmetric matrices that stop at different sweeps: a Gaussian
    one, a nearly diagonal one, a diagonal one and another Gaussian one."""
    g = rng.normal(size=(4, n, n))
    a = (g + np.swapaxes(g, -1, -2)) / 2
    a[1] = np.diag(np.arange(n, dtype=np.float64)) + 1e-3 * a[1]
    a[2] = np.diag(np.arange(n, dtype=np.float64))
    return a


@pytest.mark.parametrize("tol, max_sweeps", [(1e-12, 30), (1e-7, 20), (0.0, 3), (1e-12, 0)])
def test_syevj_sweeps_and_residual_per_matrix(rng, tol, max_sweeps):
    a = _mixed_batch(rng, 10)
    w, v, res, sweeps = syevj(_t(a), tol=tol, max_sweeps=max_sweeps)
    rw, rv, rres, rsweeps = ref.syevj(jnp.asarray(a), tol=tol, max_sweeps=max_sweeps)
    np.testing.assert_array_equal(sweeps.numpy(), np.asarray(rsweeps))
    if tol == 1e-12 and max_sweeps:
        assert len(set(sweeps.tolist())) >= 3   # the matrices stop at different sweeps
    np.testing.assert_allclose(res.numpy(), np.asarray(rres), rtol=1e-9, atol=1e-14)
    _same(w, rw)
    _same(v, rv, 1e-10)


@pytest.mark.parametrize("tol, max_sweeps", [(1e-12, 30), (0.0, 3)])
def test_gesvdj_sweeps_and_residual_per_matrix(rng, tol, max_sweeps):
    a = rng.normal(size=(4, 14, 9))
    a[1] = np.eye(14, 9) * np.arange(1.0, 10.0) + 1e-4 * a[1]
    a[2] = np.eye(14, 9) * np.arange(1.0, 10.0)
    u, s, v, res, sweeps = gesvdj(_t(a), tol=tol, max_sweeps=max_sweeps)
    ru, rs, rv, rres, rsweeps = ref.gesvdj(jnp.asarray(a), tol=tol, max_sweeps=max_sweeps)
    np.testing.assert_array_equal(sweeps.numpy(), np.asarray(rsweeps))
    if max_sweeps == 30:
        assert len(set(sweeps.tolist())) >= 2
    np.testing.assert_allclose(res.numpy(), np.asarray(rres), rtol=1e-9, atol=1e-14)
    _same(s, rs)


def _gram_off(u, s, a):
    """Largest off-diagonal entry of (U·S)ᵀ(U·S) over ‖A‖²_F."""
    us = np.asarray(u) * np.asarray(s)
    g = us.T @ us
    return np.abs(g - np.diag(np.diag(g))).max() / np.square(a).sum()


def test_gesvdj_leaves_small_columns_unorthogonal_in_both_c13():
    """ROADMAP C13: the stop fires once the off-diagonal squares of G = AᵀA
    vanish below the last bit of ‖G‖²_F, so G keeps entries up to about
    √eps·‖A‖²_F and u_p·u_q is only bounded by that over σ_p·σ_q. On a
    32 × 32 matrix with σ from 1 down to 1e-7 both packages stop at the
    same sweep with U 0.96 from orthogonal, while V is orthogonal and the
    Gram entries stay inside the stop's resolution."""
    rng = np.random.default_rng(0)
    q1, q2 = (np.linalg.qr(rng.standard_normal((32, 32)))[0] for _ in range(2))
    a = (q1 * np.geomspace(1.0, 1e-7, 32)) @ q2.T
    u, s, v, res, sweeps = gesvdj(_t(a), tol=1e-6)
    ru, rs, rv, rres, rsweeps = ref.gesvdj(jnp.asarray(a), tol=1e-6)
    assert int(sweeps) == int(rsweeps)
    orth_u = np.abs(u.numpy().T @ u.numpy() - np.eye(32)).max()
    orth_ru = np.abs(np.asarray(ru).T @ np.asarray(ru) - np.eye(32)).max()
    assert orth_u > 0.5 and orth_ru > 0.5 and abs(orth_u - orth_ru) < 1e-6
    for uu, ss, vv in ((u, s, v), (ru, rs, rv)):
        vv = np.asarray(vv)
        assert np.abs(vv.T @ vv - np.eye(32)).max() < 1e-12
        assert _gram_off(uu, ss, a) < 1.5e-8
    _same(s, rs)


# ---------------------------------------------------------------------------
# float32

def test_syevj_and_gesvdj_in_float32(rng):
    g = rng.normal(size=(3, 12, 12))
    a = ((g + np.swapaxes(g, -1, -2)) / 2).astype(np.float32)
    w, v, res, sweeps = syevj(_t(a), tol=1e-6)
    assert w.dtype == v.dtype == res.dtype == torch.float32
    rw = ref.syevj(jnp.asarray(a), tol=1e-6)[0]
    _same(w, rw, 1e-5)
    for i in range(3):
        assert_allclose(w[i], scipy.linalg.eigvalsh(a[i].astype(np.float64)), rtol=2e-5)
    b = g[:, :, :8].astype(np.float32)
    u, s, vv, res, sweeps = gesvdj(_t(b), tol=1e-6)
    assert s.dtype == torch.float32
    _same(s, ref.gesvdj(jnp.asarray(b), tol=1e-6)[1], 1e-5)
    for i in range(3):
        assert_allclose(s[i], scipy.linalg.svdvals(b[i].astype(np.float64)), rtol=2e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dense_drivers_in_both_precisions(rng, dtype):
    g = rng.normal(size=(2, 16, 16))
    sym = ((g + np.swapaxes(g, -1, -2)) / 2).astype(dtype)
    spd = (g @ np.swapaxes(g, -1, -2) / 16 + 2 * np.eye(16)).astype(dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    w, v, info = xsyevd(_t(sym))
    _same(w, rdense.xsyevd(jnp.asarray(sym))[0], tol)
    assert info.dtype == torch.int32 and (info == 0).all()
    w, x, info = xsygvd(_t(sym), _t(spd))
    _same(w, rdense.xsygvd(jnp.asarray(sym), jnp.asarray(spd))[0], tol * 10)
    u, s, vh, info = xgesvd(_t(g.astype(dtype)))
    _same(s, rdense.xgesvd(jnp.asarray(g.astype(dtype)))[1], tol)


# ---------------------------------------------------------------------------
# tests/test_solver_dense.py:110-146, through both packages

@pytest.fixture
def spd(rng):
    a = rng.normal(size=(N, N))
    return (a @ a.T / N + 2 * np.eye(N)).astype(np.float64)


def test_xsyevd(spd):
    w, v, info = xsyevd(_t(np.tril(spd)), uplo="L")
    ww = scipy.linalg.eigvalsh(spd)
    assert_allclose(w, ww, rtol=1e-10)
    assert_allclose(spd @ v.numpy(), v.numpy() * w.numpy(), rtol=1e-9)
    assert int(info) == 0
    rw, rv, _ = rdense.xsyevd(jnp.asarray(np.tril(spd)), uplo="L")
    _same(w, rw)
    _same(v.abs(), np.abs(np.asarray(rv)), 1e-10)
    w2, v2, _ = xsyevd(_t(np.triu(spd)), uplo="U", vectors=False)
    assert v2 is None
    assert_allclose(w2, ww, rtol=1e-10)


def test_xsyevdx_ranges(spd):
    ww = scipy.linalg.eigvalsh(spd)
    w, v, nf, info = xsyevdx(_t(spd), range_="I", il=2, iu=5)
    assert nf == 4 and v.shape == (N, 4)
    assert_allclose(w, ww[2:6], rtol=1e-10)
    mid = (ww[4] + ww[-1]) / 2
    w2, v2, nf2, _ = xsyevdx(_t(spd), range_="V", vl=float(ww[4]), vu=float(mid) + 1e308)
    found = w2.numpy()[: int(nf2)]
    assert_allclose(found, ww[ww > ww[4]], rtol=1e-10)
    assert np.isnan(w2.numpy()[int(nf2):]).all() and (v2[:, int(nf2):] == 0).all()
    rw2, _, rnf2, _ = rdense.xsyevdx(jnp.asarray(spd), range_="V", vl=float(ww[4]),
                                     vu=float(mid) + 1e308)
    assert int(nf2) == int(rnf2)
    _same(w2[: int(nf2)], np.asarray(rw2)[: int(nf2)])


def test_xsygvd(spd, rng):
    a0 = rng.normal(size=(N, N))
    a = (a0 + a0.T) / 2
    w, x, info = xsygvd(_t(a), _t(spd))
    ww = scipy.linalg.eigvalsh(a, spd)
    assert_allclose(w, ww, rtol=1e-9)
    assert_allclose(a @ x.numpy(), spd @ x.numpy() * w.numpy(), rtol=1e-8)
    assert int(info) == 0
    _same(w, rdense.xsygvd(jnp.asarray(a), jnp.asarray(spd))[0])


def test_xsygvd_refuses_other_itypes(spd):
    with pytest.raises(InvalidValueError, match="itype 2/3 not implemented"):
        xsygvd(_t(spd), _t(spd), itype=2)


def test_xgesvd(rng):
    a = rng.normal(size=(32, 20))
    u, s, vh, info = xgesvd(_t(a))
    assert_allclose(s, scipy.linalg.svdvals(a), rtol=1e-10)
    assert_allclose(u.numpy() @ np.diag(s.numpy()) @ vh.numpy(), a, rtol=1e-10)
    assert u.shape == (32, 20) and int(info) == 0
    _same(s, rdense.xgesvd(jnp.asarray(a))[1])
    none_u, s2, none_vh, _ = xgesvd(_t(a), vectors=False)
    assert none_u is None and none_vh is None
    assert_allclose(s2, s.numpy(), rtol=1e-12)
    assert xgesvd(_t(a), full_matrices=True)[0].shape == (32, 32)


def test_info_flags_a_non_finite_matrix():
    """torch.linalg refuses a non-finite matrix where XLA returns NaN: the
    port returns NaN for that matrix alone and info > 0 where the reference
    has it (which entry XLA's NaN lands on, and so info's value, is XLA's
    own)."""
    a = np.stack([np.eye(4), np.eye(4), 2 * np.eye(4)])
    a[1, 2, 2] = np.nan
    a[2, 3, 0] = np.nan   # not inf: XLA's CPU SVD does not return on an inf
    for vectors in (True, False):
        w, _, info = xsyevd(_t(a), vectors=vectors)
        rinfo = np.asarray(rdense.xsyevd(jnp.asarray(a), vectors=vectors)[2])
        np.testing.assert_array_equal(info.numpy() > 0, rinfo > 0)
        assert np.isnan(w[1:].numpy()).all() and (w[0] == 1).all()
        u, s, vh, info = xgesvd(_t(a), vectors=vectors)
        rinfo = np.asarray(rdense.xgesvd(jnp.asarray(a), vectors=vectors)[3])
        np.testing.assert_array_equal(info.numpy() > 0, rinfo > 0)
        assert np.isnan(s[1:].numpy()).all() and (s[0] == 1).all()
