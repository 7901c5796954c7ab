"""Parity of tpumathlib_torch.sparse with the reference, module by module, on
the shapes and at the tolerances of tests/test_sparse.py:

- round trips dense ↔ CSR/COO (capacity padding, coo_sort, coo_to_csr):
  the same arrays, and the dense matrix back within rtol 1e-12 (:55-72);
- spmv on CSR/COO with y/beta and transposed, the ``combine`` hook, spmm 2-D
  and batched: rtol 1e-10 (:75-106);
- Blocked-ELL at bs = 4 (the masked einsum) within rtol 1e-4 and at bs = 128
  (``bell_spmm_pallas``; the reference's kernel runs in interpret mode)
  within rtol 2e-4, atol 1e-3 (:109-138);
- spsv/spsm (lower, upper, matrix RHS, unit diagonal), sddmm and the vector
  ops: rtol 1e-10, 1e-12 or exact, as there (:154-208);
- SELL, BSR and sddmm_bsr: rtol 1e-10 (:294-345);
- csr_to_blocked_ell: the same blocks, its SpMV within rtol 2e-5, atol 1e-4,
  and the refusal of an unstructured pattern (:446-472);
- SpmvAutoPlan: the engine the reference chooses, the same ``stats``, and
  results within the reference test's bounds (:475-530).
(rtol here is max-scaled, as ``core.check.allclose`` reads it in both
packages.) Also: C2 pinned (the auto-plan sums duplicate entries), the
host CSR toolkit, the sanitizer, and ``interop.from_reference`` on every
container. Inputs are the same numpy arrays on both sides, f64 where the
reference test is f64 (the suite turns on jax x64).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from tpumathlib import sparse as ref
from tpumathlib.sparse import convert as ref_convert
from tpumathlib.sparse import hostcsr as ref_hostcsr
from tpumathlib.sparse import ops as ref_ops
from tpumathlib.sparse import pallas_kernels as ref_pk
from tpumathlib.sparse.containers import BSR as RefBSR
from tpumathlib.sparse.containers import SELL as RefSELL
from tpumathlib_torch.core import device as core_device
from tpumathlib_torch import sparse as sp
from tpumathlib_torch.core.check import assert_allclose, max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.core.interop import from_numpy, from_reference, to_numpy
from tpumathlib_torch.core.sanitize import sanitize, sanitizing
from tpumathlib_torch.sparse import hostcsr, pallas_kernels as pk

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_arrays_on_the_cpu(monkeypatch):
    """The port's default device is the card (core.device.default_device);
    these tests turn host arrays into containers on the CPU."""
    monkeypatch.setattr(core_device, "default_device", lambda: torch.device("cpu"))


def rand_sparse(rng, m, n, density=0.3):
    return rng.normal(size=(m, n)) * (rng.uniform(size=(m, n)) < density)


@pytest.fixture
def amat(rng):
    return rand_sparse(rng, 16, 20)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _same_arrays(port_obj, ref_obj, fields):
    for f in fields:
        np.testing.assert_array_equal(to_numpy(getattr(port_obj, f)), np.asarray(getattr(ref_obj, f)))


# ---------------------------------------------------------------------------
# convert.py

def test_dense_csr_roundtrip(amat):
    a, r = sp.dense_to_csr(amat), ref.dense_to_csr(amat)
    _same_arrays(a, r, ("indptr", "indices", "data"))
    assert a.nnz == r.nnz and a.dtype == torch.float64
    assert_allclose(sp.csr_to_dense(a), amat, rtol=1e-12)
    a_cap, r_cap = sp.dense_to_csr(amat, nnz_cap=a.nnz + 17), ref.dense_to_csr(amat, nnz_cap=a.nnz + 17)
    assert a_cap.nnz == a.nnz + 17
    _same_arrays(a_cap, r_cap, ("indptr", "indices", "data"))
    assert_allclose(sp.csr_to_dense(a_cap), amat, rtol=1e-12)
    np.testing.assert_array_equal(to_numpy(a_cap.row_ids()), np.asarray(r_cap.row_ids()))
    with pytest.raises(InvalidValueError):
        sp.dense_to_csr(amat, nnz_cap=3)


def test_coo_roundtrip_and_sort(amat, rng):
    a, r = sp.dense_to_coo(amat), ref.dense_to_coo(amat)
    _same_arrays(a, r, ("row", "col", "data"))
    assert_allclose(sp.coo_to_dense(a), amat, rtol=1e-12)
    perm = rng.permutation(a.nnz)
    shuffled = sp.COO(a.row[perm], a.col[perm], a.data[perm], a.shape)
    ref_shuffled = type(r)(r.row[perm], r.col[perm], r.data[perm], r.shape)
    sorted_, ref_sorted = sp.coo_sort(shuffled), ref.coo_sort(ref_shuffled)
    _same_arrays(sorted_, ref_sorted, ("row", "col", "data"))
    assert bool((torch.diff(sorted_.row) >= 0).all())
    back, ref_back = sp.coo_to_csr(sorted_), ref.coo_to_csr(ref_sorted)
    _same_arrays(back, ref_back, ("indptr", "indices", "data"))
    assert_allclose(sp.csr_to_dense(back), amat, rtol=1e-12)
    _same_arrays(sp.csr_to_coo(back), ref.csr_to_coo(ref_back), ("row", "col", "data"))


def test_prune(rng):
    a = rng.normal(size=(6, 6))
    p = sp.prune_dense(_t(a), threshold=0.5)
    np.testing.assert_array_equal(to_numpy(p), np.asarray(ref.prune_dense(jnp.asarray(a), 0.5)))


def test_blocked_ell_roundtrip(rng):
    m, n, bs = 16, 24, 4
    blocks = rng.uniform(size=(m // bs, n // bs)) < 0.4
    a = np.kron(blocks, np.ones((bs, bs))) * rng.normal(size=(m, n))
    bell, ref_bell = sp.dense_to_blocked_ell(a, bs), ref.dense_to_blocked_ell(a, bs)
    _same_arrays(bell, ref_bell, ("cols", "data"))
    assert bell.ellwidth == ref_bell.ellwidth
    assert_allclose(sp.blocked_ell_to_dense(bell), a, rtol=1e-12)
    wide = sp.dense_to_blocked_ell(a, bs, ellwidth=bell.ellwidth + 2)   # more pad slots
    assert_allclose(sp.blocked_ell_to_dense(wide), a, rtol=1e-12)


def test_csr_to_blocked_ell(rng):
    m = n = 512
    a = np.zeros((m, n), np.float32)
    for (i, j) in [(0, 1), (0, 3), (1, 0), (2, 2), (3, 3), (3, 0)]:
        a[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] = (
            rng.normal(size=(128, 128)) * (rng.uniform(size=(128, 128)) < 0.6))
    bell = sp.csr_to_blocked_ell(sp.dense_to_csr(a), 128)
    ref_bell = ref_convert.csr_to_blocked_ell(ref.dense_to_csr(a), 128)
    _same_arrays(bell, ref_bell, ("cols", "data"))
    np.testing.assert_array_equal(to_numpy(sp.blocked_ell_to_dense(bell)), a)
    x = rng.normal(size=n).astype(np.float32)
    y = to_numpy(pk.bell_spmv_pallas(bell, _t(x)))
    np.testing.assert_allclose(y, a @ x, rtol=2e-5, atol=1e-4)
    u = np.zeros((256, 256), np.float32)
    idx = rng.integers(0, 256, (200, 2))
    u[idx[:, 0], idx[:, 1]] = 1.0
    with pytest.raises(InvalidValueError, match="unstructured"):
        sp.csr_to_blocked_ell(sp.dense_to_csr(u), 128, max_fill=16.0)


# ---------------------------------------------------------------------------
# ops.py

@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_spmv(amat, rng, fmt):
    conv = "dense_to_csr" if fmt == "csr" else "dense_to_coo"
    a, r = getattr(sp, conv)(amat), getattr(ref, conv)(amat)
    x, y = rng.normal(size=20), rng.normal(size=16)
    got = sp.spmv(a, _t(x), _t(y), alpha=2.0, beta=-1.0)
    assert_allclose(got, np.asarray(ref.spmv(r, jnp.asarray(x), jnp.asarray(y), alpha=2.0,
                                             beta=-1.0)), rtol=1e-10)
    assert_allclose(got, 2 * amat @ x - y, rtol=1e-10)
    gt = sp.spmv(a, _t(y), transpose=True)
    assert_allclose(gt, np.asarray(ref.spmv(r, jnp.asarray(y), transpose=True)), rtol=1e-10)
    assert_allclose(gt, amat.T @ y, rtol=1e-10)


def test_spmv_custom_op(amat, rng):
    a, r = sp.dense_to_csr(amat), ref.dense_to_csr(amat)
    x = rng.normal(size=20)
    got = sp.spmv(a, _t(x), combine=torch.maximum)
    want = ref.spmv(r, jnp.asarray(x), combine=lambda av, xv: jnp.maximum(av, xv))
    assert_allclose(got, np.asarray(want), rtol=1e-10)
    rows, cols = np.nonzero(amat)
    oracle = np.zeros(16)
    for i, j in zip(rows, cols):
        oracle[i] += max(amat[i, j], x[j])
    assert_allclose(got, oracle, rtol=1e-10)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_spmm_batched(amat, rng, fmt):
    conv = "dense_to_csr" if fmt == "csr" else "dense_to_coo"
    a, r = getattr(sp, conv)(amat), getattr(ref, conv)(amat)
    b = rng.normal(size=(20, 8))
    got = sp.spmm(a, _t(b))
    assert_allclose(got, np.asarray(ref.spmm(r, jnp.asarray(b))), rtol=1e-10)
    assert_allclose(got, amat @ b, rtol=1e-10)
    bb = rng.normal(size=(3, 20, 8))
    got3 = sp.spmm(a, _t(bb))
    assert got3.shape == (3, 16, 8)
    assert_allclose(got3, np.asarray(ref.spmm(r, jnp.asarray(bb))), rtol=1e-10)
    assert_allclose(got3, np.einsum("ij,bjk->bik", amat, bb), rtol=1e-10)
    c, bt = rng.normal(size=(20, 5)), rng.normal(size=(16, 5))
    got_t = sp.spmm(a, _t(bt), _t(c), alpha=0.5, beta=2.0, transpose_a=True)
    want_t = ref.spmm(r, jnp.asarray(bt), jnp.asarray(c), alpha=0.5, beta=2.0, transpose_a=True)
    assert_allclose(got_t, np.asarray(want_t), rtol=1e-10)
    assert_allclose(got_t, 0.5 * amat.T @ bt + 2.0 * c, rtol=1e-10)


def test_blocked_ell_einsum_route(rng):
    """bs = 4 takes the masked einsum in both packages."""
    m, n, bs = 16, 24, 4
    blocks = rng.uniform(size=(m // bs, n // bs)) < 0.4
    a = np.kron(blocks, np.ones((bs, bs))) * rng.normal(size=(m, n))
    bell, ref_bell = sp.dense_to_blocked_ell(a, bs), ref.dense_to_blocked_ell(a, bs)
    b = rng.normal(size=(n, 8)).astype(np.float32)
    got = sp.spmm(bell, _t(b))
    assert got.dtype == torch.float32
    assert_allclose(got, np.asarray(ref.spmm(ref_bell, jnp.asarray(b))), rtol=1e-4)
    assert_allclose(got, a @ b, rtol=1e-4)
    bb = rng.normal(size=(2, n, 3)).astype(np.float32)
    assert_allclose(sp.spmm(bell, _t(bb)), np.asarray(ref.spmm(ref_bell, jnp.asarray(bb))),
                    rtol=1e-4)
    x, y = rng.normal(size=n), rng.normal(size=m)
    got_v = sp.spmv(bell, _t(x), _t(y), alpha=2.0, beta=0.5)
    assert_allclose(got_v, np.asarray(ref.spmv(ref_bell, jnp.asarray(x), jnp.asarray(y),
                                               alpha=2.0, beta=0.5)), rtol=1e-4)
    assert_allclose(got_v, 2 * a @ x + 0.5 * y, rtol=1e-4)


def test_blocked_ell_kernel_route_128(rng):
    """bs = 128 routes to bell_spmm_pallas (the reference's Pallas kernel in
    interpret mode): SpMM and SpMV against the reference and the dense
    product."""
    bs, mb, nb = 128, 3, 5
    m, n = mb * bs, nb * bs
    blocks = rng.uniform(size=(mb, nb)) < 0.5
    blocks[0, 0] = True
    a = np.kron(blocks, np.ones((bs, bs))) * rng.normal(size=(m, n))
    bell, ref_bell = sp.dense_to_blocked_ell(a, bs), ref.dense_to_blocked_ell(a, bs)
    b = rng.normal(size=(n, 200)).astype(np.float32)
    got = sp.spmm(bell, _t(b))
    assert_allclose(got, np.asarray(ref.spmm(ref_bell, jnp.asarray(b))), rtol=2e-4, atol=1e-3)
    assert_allclose(got, a @ b, rtol=2e-4, atol=1e-3)
    x = rng.normal(size=n).astype(np.float32)
    gv = sp.spmv(bell, _t(x))
    assert_allclose(gv, np.asarray(ref.spmv(ref_bell, jnp.asarray(x))), rtol=2e-4, atol=1e-3)
    assert_allclose(gv, a @ x, rtol=2e-4, atol=1e-3)


def test_blocked_ell_transpose_refused(rng):
    bell = sp.dense_to_blocked_ell(np.eye(8), 4)
    with pytest.raises(InvalidValueError):
        sp.spmv(bell, torch.ones(8, dtype=torch.float64), transpose=True)
    with pytest.raises(InvalidValueError):
        sp.spmm(bell, torch.ones((8, 2), dtype=torch.float64), transpose_a=True)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_sddmm(rng, fmt):
    m, n, k = 10, 12, 6
    a, b = rng.normal(size=(m, k)), rng.normal(size=(k, n))
    pat_d = rand_sparse(rng, m, n, 0.3)
    conv = "dense_to_csr" if fmt == "csr" else "dense_to_coo"
    pat, ref_pat = getattr(sp, conv)(pat_d), getattr(ref, conv)(pat_d)
    got = sp.sddmm(_t(a), _t(b), pat, alpha=1.5, beta=0.5)
    want = ref.sddmm(jnp.asarray(a), jnp.asarray(b), ref_pat, alpha=1.5, beta=0.5)
    assert type(got).__name__ == type(want).__name__
    assert_allclose(got.data, np.asarray(want.data), rtol=1e-10)
    to_dense = sp.csr_to_dense if fmt == "csr" else sp.coo_to_dense
    oracle = np.where(pat_d != 0, 1.5 * a @ b + 0.5 * pat_d, 0)
    assert_allclose(to_dense(got), oracle, rtol=1e-10)


def test_vector_ops(rng):
    y = rng.normal(size=16)
    idx = np.array([1, 4, 7, 13], np.int32)
    xv = rng.normal(size=4)
    ty, ti, tx = _t(y), _t(idx), _t(xv)
    jy, ji, jx = jnp.asarray(y), jnp.asarray(idx), jnp.asarray(xv)
    got = sp.axpby(2.0, tx, ti, 0.5, ty)
    assert_allclose(got, np.asarray(ref.axpby(2.0, jx, ji, 0.5, jy)), rtol=1e-12)
    want = 0.5 * y.copy()
    want[idx] += 2.0 * xv
    assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_array_equal(to_numpy(sp.sp_gather(ty, ti)), y[idx])
    got2 = sp.sp_scatter(tx, ti, ty)
    np.testing.assert_array_equal(to_numpy(got2), np.asarray(ref.sp_scatter(jx, ji, jy)))
    np.testing.assert_array_equal(to_numpy(ty), y)   # the input stays as it was
    assert_allclose(sp.spvv(tx, ti, ty), float(ref.spvv(jx, ji, jy)), rtol=1e-12)
    assert_allclose(sp.spvv(tx, ti, ty), xv @ y[idx], rtol=1e-12)
    xr, yr = sp.sp_rot(tx, ti, ty, 0.6, 0.8)
    rxr, ryr = ref.sp_rot(jx, ji, jy, 0.6, 0.8)
    assert_allclose(xr, np.asarray(rxr), rtol=1e-12)
    assert_allclose(yr, np.asarray(ryr), rtol=1e-12)
    assert_allclose(xr, 0.6 * xv + 0.8 * y[idx], rtol=1e-12)


def test_sell_spmv(rng):
    a = rand_sparse(rng, 19, 24, 0.3)
    sell, ref_sell = sp.SELL.from_dense(a, slice_height=8), RefSELL.from_dense(a, slice_height=8)
    assert sell.cols.shape[0] == 3
    _same_arrays(sell, ref_sell, ("cols", "data", "widths"))
    x, y = rng.normal(size=24), rng.normal(size=19)
    got = sp.spmv(sell, _t(x), _t(y), alpha=2.0, beta=-1.0)
    want = ref.spmv(ref_sell, jnp.asarray(x), jnp.asarray(y), alpha=2.0, beta=-1.0)
    assert_allclose(got, np.asarray(want), rtol=1e-10)
    assert_allclose(got, 2 * a @ x - y, rtol=1e-10)


def _bsr_parts(a, bs):
    m, n = a.shape
    indptr, indices, data = [0], [], []
    for i in range(m // bs):
        for j in range(n // bs):
            blk = a[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]
            if np.abs(blk).sum() > 0:
                indices.append(j)
                data.append(blk)
        indptr.append(len(indices))
    return np.asarray(indptr, np.int32), np.asarray(indices, np.int32), np.stack(data)


def test_bsr_spmv_sddmm(rng):
    m = n = 16
    bs = 4
    blocks = rng.uniform(size=(m // bs, n // bs)) < 0.5
    a = np.kron(blocks, np.ones((bs, bs))) * rng.normal(size=(m, n))
    indptr, indices, data = _bsr_parts(a, bs)
    bsr = sp.BSR(_t(indptr), _t(indices), _t(data), (m, n), bs)
    ref_bsr = RefBSR(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(data), (m, n), bs)
    assert bsr.nnzb == ref_bsr.nnzb
    x = rng.normal(size=n)
    got = sp.spmv(bsr, _t(x), alpha=2.0)
    assert_allclose(got, np.asarray(ref.spmv(ref_bsr, jnp.asarray(x), alpha=2.0)), rtol=1e-10)
    assert_allclose(got, 2 * a @ x, rtol=1e-10)
    p, q = rng.normal(size=(m, 6)), rng.normal(size=(6, n))
    pat = sp.BSR(bsr.indptr, bsr.indices, torch.zeros_like(bsr.data), (m, n), bs)
    ref_pat = RefBSR(ref_bsr.indptr, ref_bsr.indices, jnp.zeros_like(ref_bsr.data), (m, n), bs)
    out = sp.sddmm_bsr(_t(p), _t(q), pat, alpha=1.0)
    want = ref_ops.sddmm_bsr(jnp.asarray(p), jnp.asarray(q), ref_pat, alpha=1.0)
    assert_allclose(out.data, np.asarray(want.data), rtol=1e-10)
    full = p @ q
    for bi, (i0, i1) in enumerate(zip(indptr[:-1], indptr[1:])):
        for pidx in range(i0, i1):
            j = indices[pidx]
            assert_allclose(out.data[pidx], full[bi * bs:(bi + 1) * bs, j * bs:(j + 1) * bs],
                            rtol=1e-10)


# ---------------------------------------------------------------------------
# spsv.py

def test_spsv_spsm(rng):
    n = 12
    lo = np.tril(rand_sparse(rng, n, n, 0.4)) + 3 * np.eye(n)
    b = rng.normal(size=n)
    bm = rng.normal(size=(n, 3))
    lu = np.tril(rand_sparse(rng, n, n, 0.4), -1) + np.eye(n)
    cases = [(lo, b, {}, b), (lo.T, b, {"lower": False}, b), (lo, bm, {"alpha": 2.0}, 2 * bm),
             (lu, b, {"unit_diag": True}, b)]
    for mat, rhs, kw, want in cases:
        solve = sp.spsm if rhs.ndim > 1 else sp.spsv
        ref_solve = ref.spsm if rhs.ndim > 1 else ref.spsv
        x = solve(sp.dense_to_csr(mat), _t(rhs), **kw)
        xr = ref_solve(ref.dense_to_csr(mat), jnp.asarray(rhs), **kw)
        assert x.shape == rhs.shape and x.dtype == torch.float64
        assert_allclose(x, np.asarray(xr), rtol=1e-10)
        assert_allclose(mat @ to_numpy(x), want, rtol=1e-10)


def test_spsv_plan_levels_match_reference(rng):
    from tpumathlib.sparse.spsv import spsv_plan as ref_spsv_plan

    lo = np.tril(rand_sparse(rng, 12, 12, 0.4)) + 3 * np.eye(12)
    plan, ref_plan = sp.spsv_plan(sp.dense_to_csr(lo)), ref_spsv_plan(ref.dense_to_csr(lo))
    assert len(plan.levels) == len(ref_plan.levels)
    for got, want in zip(plan.levels, ref_plan.levels):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(to_numpy(plan.diag_pos), np.asarray(ref_plan.diag_pos))
    with pytest.raises(InvalidValueError, match="missing diagonal"):
        sp.spsv_plan(sp.dense_to_csr(np.tril(np.ones((4, 4)), -1) + np.diag([1.0, 0, 1, 1])))


# ---------------------------------------------------------------------------
# autoplan.py

def _latent_block_csr(rng):
    m = n = 512
    d = np.zeros((m, n), np.float32)
    for (bi, bj) in ((0, 0), (1, 1), (2, 0), (2, 3), (3, 2), (3, 3)):
        d[bi * 128:(bi + 1) * 128, bj * 128:(bj + 1) * 128] = rng.normal(
            size=(128, 128)) * (rng.random((128, 128)) < 0.4)
    return d, sps.csr_matrix(d)


def _csr_pair(indptr, indices, data, shape):
    return (sp.CSR(_t(indptr), _t(indices), _t(data), shape),
            ref.CSR(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(data), shape))


def _same_stats(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


def test_spmv_auto_plan(rng):
    m = n = 512
    x = rng.normal(size=n).astype(np.float32)
    # (a) latent block structure -> Blocked-ELL
    d, s = _latent_block_csr(rng)
    a, ra = _csr_pair(s.indptr.astype(np.int32), s.indices.astype(np.int32),
                      s.data.astype(np.float32), (m, n))
    plan, ref_plan = sp.SpmvAutoPlan(a), ref.SpmvAutoPlan(ra)
    assert plan.engine == ref_plan.engine == "blockedell"
    _same_stats(plan.stats, ref_plan.stats)
    got = to_numpy(plan.execute(_t(x)))
    want = np.asarray(ref_plan.execute(jnp.asarray(x)))
    bound = 2e-3 * np.abs(d @ x).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    np.testing.assert_allclose(got, d @ x, rtol=0, atol=bound)
    assert max_scaled_err(got, d.astype(np.float64) @ x) <= 1e-5   # f32 throughout

    # (b) regular rows, no block structure -> SELL
    cols = np.sort(rng.choice(n, size=(m, 7), replace=True), axis=1)
    vals = rng.normal(size=(m, 7)).astype(np.float32)
    a2, ra2 = _csr_pair(np.arange(m + 1, dtype=np.int32) * 7, cols.ravel().astype(np.int32),
                        vals.ravel(), (m, n))
    plan2, ref_plan2 = sp.SpmvAutoPlan(a2, max_blowup=4.0), ref.SpmvAutoPlan(ra2, max_blowup=4.0)
    assert plan2.engine == ref_plan2.engine == "sell"
    _same_stats(plan2.stats, ref_plan2.stats)
    oracle = (vals.astype(np.float64) * x[cols]).sum(axis=1)
    got2 = to_numpy(plan2.execute(_t(x)))
    atol = 1e-4 * max(1.0, np.abs(oracle).max())
    np.testing.assert_allclose(got2, np.asarray(ref_plan2.execute(jnp.asarray(x))), atol=atol)
    np.testing.assert_allclose(got2, oracle, atol=atol)

    # (c) wildly irregular rows + no blocks -> CSR
    rl = np.where(np.arange(m) % 64 == 0, 200, 1)
    indptr3 = np.concatenate([[0], np.cumsum(rl)]).astype(np.int32)
    idx3 = rng.integers(0, n, int(indptr3[-1])).astype(np.int32)
    val3 = rng.normal(size=int(indptr3[-1])).astype(np.float32)
    a3, ra3 = _csr_pair(indptr3, idx3, val3, (m, n))
    kw = dict(max_blowup=2.0, sell_max_pad=1.2)
    plan3, ref_plan3 = sp.SpmvAutoPlan(a3, **kw), ref.SpmvAutoPlan(ra3, **kw)
    assert plan3.engine == ref_plan3.engine == "csr"
    _same_stats(plan3.stats, ref_plan3.stats)
    oracle3 = sps.csr_matrix((val3, idx3, indptr3), shape=(m, n)) @ x
    got3 = to_numpy(plan3.execute(_t(x)))
    atol3 = 1e-4 * max(1.0, np.abs(oracle3).max())
    np.testing.assert_allclose(got3, np.asarray(ref_plan3.execute(jnp.asarray(x))), atol=atol3)
    np.testing.assert_allclose(got3, oracle3, atol=atol3)


def test_auto_plan_coo_input_and_ragged_shape(rng):
    """A COO goes through scipy's CSR (duplicates summed) in both packages;
    a shape that is no multiple of bs keeps its own (m, n) in the
    Blocked-ELL engine's plan, which takes x unpadded."""
    m, n = 300, 260
    d = np.zeros((m, n), np.float32)
    d[:128, :128] = rng.normal(size=(128, 128))
    d[256:, 130:] = rng.normal(size=(44, 130))
    a, r = sp.dense_to_coo(d), ref.dense_to_coo(d)
    plan, ref_plan = sp.SpmvAutoPlan(a), ref.SpmvAutoPlan(r)
    assert plan.engine == ref_plan.engine == "blockedell"
    assert plan._bell.shape == (m, n)
    _same_stats(plan.stats, ref_plan.stats)
    x = rng.normal(size=n).astype(np.float32)
    got = plan.execute(_t(x), alpha=0.5)
    assert got.shape == (m,)
    assert max_scaled_err(got, 0.5 * d.astype(np.float64) @ x) <= 1e-5
    assert max_scaled_err(got, np.asarray(ref_plan.execute(jnp.asarray(x), 0.5))) <= 2e-4


def test_auto_plan_sums_duplicates_c2(rng):
    """C2, pinned: a CSR holding (0, 5) twice. The port's Blocked-ELL repack
    sums the two entries, as scipy does; the reference keeps one of them.
    The SELL engine keeps an f64 input's dtype; the reference's is f32."""
    indptr = np.array([0, 3, 4] + [4] * 126 + [4], np.int32)
    indices = np.array([5, 5, 7, 1], np.int32)
    data = np.array([1.5, 2.0, -1.0, 3.0], np.float32)
    a, r = _csr_pair(indptr, indices, data, (129, 128))
    x = rng.normal(size=128).astype(np.float32)
    want = sps.csr_matrix((data, indices, indptr), shape=(129, 128)) @ x    # sums duplicates
    plan, ref_plan = sp.SpmvAutoPlan(a, max_blowup=1e9), ref.SpmvAutoPlan(r, max_blowup=1e9)
    assert plan.engine == ref_plan.engine == "blockedell"
    assert max_scaled_err(plan.execute(_t(x)), want) <= 1e-6
    assert abs(float(ref_plan.execute(jnp.asarray(x))[0]) - want[0]) > 0.1 * abs(x[5])

    cols = np.sort(rng.choice(64, size=(64, 3)), axis=1)
    vals = rng.normal(size=(64, 3))
    a2, r2 = _csr_pair(np.arange(65, dtype=np.int32) * 3, cols.ravel().astype(np.int32),
                       vals.ravel(), (64, 64))
    plan2, ref_plan2 = sp.SpmvAutoPlan(a2, max_blowup=1.0), ref.SpmvAutoPlan(r2, max_blowup=1.0)
    assert plan2.engine == ref_plan2.engine == "sell"
    x2 = rng.normal(size=64)
    got2 = plan2.execute(_t(x2))
    assert got2.dtype == torch.float64 and ref_plan2._sell.data.dtype == jnp.float32
    assert_allclose(got2, (vals * x2[cols]).sum(axis=1), rtol=1e-12)


# ---------------------------------------------------------------------------
# The slice as a whole

def test_sparse_slice_bench_paths(rng):
    """bench.py's sparse lines at a cut size (mb = nb = 4, ellw = 2,
    bs = 128, k = 256; the generators of tpumathlib/benchmarks/__init__.py)
    through the public entry points of both packages: spmm on a bf16
    Blocked-ELL (1e-2 max-scaled, bf16 output), SpmvPlan fed back three
    times and the auto-plan of the hidden-block CSR (f32 throughout: 1e-5
    against float64; the reference's bf16-split execute within its test's
    2e-4 / 5e-4)."""
    mb = nb = 4
    ellw, bs, k = 2, 128, 256
    cols = np.sort(rng.permuted(np.tile(np.arange(nb), (mb, 1)), axis=1)[:, :ellw],
                   axis=1).astype(np.int32)
    data = rng.normal(size=(mb, ellw, bs, bs)).astype(np.float32)
    b = rng.normal(size=(nb * bs, k)).astype(np.float32)
    data16, b16 = data.astype(ml_dtypes.bfloat16), b.astype(ml_dtypes.bfloat16)
    shape = (mb * bs, nb * bs)
    got = sp.spmm(sp.BlockedELL(_t(cols), from_numpy(data16), shape, bs), from_numpy(b16))
    want = ref.spmm(ref.BlockedELL(jnp.asarray(cols), jnp.asarray(data16), shape, bs),
                    jnp.asarray(b16))
    assert got.dtype == torch.bfloat16
    assert max_scaled_err(got, np.asarray(want, np.float64)) <= 1e-2

    dense = np.zeros(shape)
    for i in range(mb):
        for j in range(ellw):
            dense[i * bs:(i + 1) * bs, cols[i, j] * bs:(cols[i, j] + 1) * bs] = data[i, j]
    x = rng.normal(size=nb * bs).astype(np.float32)
    plan = sp.SpmvPlan(sp.BlockedELL(_t(cols), _t(data), shape, bs))
    ref_plan = ref_pk.SpmvPlan(ref.BlockedELL(jnp.asarray(cols), jnp.asarray(data), shape, bs))
    v, rv, v64 = _t(x), jnp.asarray(x), x.astype(np.float64)
    for _ in range(3):
        v, rv, v64 = plan.execute(v, 1 / 16), ref_plan.execute(rv, 1 / 16), dense @ v64 / 16
        assert max_scaled_err(v, v64) <= 1e-5
        np.testing.assert_allclose(to_numpy(v), np.asarray(rv), rtol=2e-4, atol=5e-4)

    s = sps.csr_matrix(dense.astype(np.float32))
    a, ra = _csr_pair(s.indptr.astype(np.int32), s.indices.astype(np.int32), s.data, shape)
    auto, ref_auto = sp.SpmvAutoPlan(a), ref.SpmvAutoPlan(ra)
    assert auto.engine == ref_auto.engine == "blockedell"
    _same_stats(auto.stats, ref_auto.stats)
    y = auto.execute(_t(x))
    assert max_scaled_err(y, dense @ x.astype(np.float64)) <= 1e-5
    np.testing.assert_allclose(to_numpy(y), np.asarray(ref_auto.execute(jnp.asarray(x))),
                               rtol=2e-4, atol=5e-4)


# ---------------------------------------------------------------------------
# hostcsr.py, sanitize, interop

def test_hostcsr_matches_reference(rng):
    d = rand_sparse(rng, 9, 9, 0.4) + np.eye(9)
    s = sps.csr_matrix(d)
    rows, cols = np.nonzero(d)
    perm = rng.permutation(9)
    for name, args in [("row_ids", (s.indptr,)),
                       ("coo_to_csr", (9, 9, np.r_[rows, rows[:3]], np.r_[cols, cols[:3]],
                                       np.r_[d[rows, cols], np.ones(3)])),
                       ("transpose", (9, 9, s.indptr, s.indices, s.data)),
                       ("sym_pattern", (s.indptr, s.indices, 9)),
                       ("permute_sym", (s.indptr, s.indices, s.data, perm)),
                       ("to_dense", (9, 9, s.indptr, s.indices, s.data)),
                       ("spmv", (s.indptr, s.indices, s.data, rng.normal(size=(9, 2)))),
                       ("vstack", ([(s.indptr, s.indices, s.data), (s.indptr, s.indices, s.data)],))]:
        got, want = getattr(hostcsr, name)(*args), getattr(ref_hostcsr, name)(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)


def test_sanitize(monkeypatch):
    def f(x):
        return x / 0.0

    monkeypatch.delenv("TPUMATHLIB_CHECKIFY", raising=False)
    assert not sanitizing()
    assert torch.isinf(sanitize(f)(torch.ones(3))).all()          # off: no check
    with pytest.raises(ExecutionError, match="non-finite"):
        sanitize(f, force=True)(torch.ones(3))
    monkeypatch.setenv("TPUMATHLIB_CHECKIFY", "1")
    assert sanitizing()
    with pytest.raises(ExecutionError, match="non-finite"):
        sanitize(f)(torch.ones(3))
    assert torch.equal(sanitize(lambda x: (x, {"y": x + 1}))(torch.ones(2))[0], torch.ones(2))


def test_sanitized_spsv_checks_indices_and_output(monkeypatch):
    monkeypatch.setenv("TPUMATHLIB_CHECKIFY", "1")
    lo = np.tril(np.ones((4, 4)))
    a = sp.dense_to_csr(lo)
    assert_allclose(sp.spsv(a, torch.ones(4, dtype=torch.float64)), np.linalg.solve(lo, np.ones(4)),
                    rtol=1e-12)
    plan = sp.spsv_plan(a)
    plan.csr = sp.CSR(a.indptr, torch.where(a.indices == 3, 9, a.indices), a.data, a.shape)
    with pytest.raises(ExecutionError, match="column index outside"):
        plan.solve(torch.ones(4, dtype=torch.float64))
    plan = sp.spsv_plan(sp.dense_to_csr(np.tril(np.ones((3, 3)))))
    plan.csr.data[plan.diag_pos[1]] = 0.0   # a zero pivot
    with pytest.raises(ExecutionError, match="non-finite"):
        plan.solve(torch.ones(3, dtype=torch.float64))


def test_from_reference_containers(amat, rng):
    x = rng.normal(size=20)
    for conv in ("dense_to_csr", "dense_to_coo"):
        carried = from_reference(getattr(ref, conv)(amat))
        own = getattr(sp, conv)(amat)
        assert type(carried) is type(own) and carried.shape == own.shape
        assert torch.equal(sp.spmv(carried, _t(x)), sp.spmv(own, _t(x)))
    sell = from_reference(RefSELL.from_dense(amat))
    assert isinstance(sell, sp.SELL) and sell.slice_height == 8
    assert torch.equal(sp.spmv(sell, _t(x)), sp.spmv(sp.SELL.from_dense(amat), _t(x)))
    blocks = rng.uniform(size=(4, 5)) < 0.5
    d = np.kron(blocks, np.ones((4, 4))) * rng.normal(size=(16, 20))
    bell = from_reference(ref.dense_to_blocked_ell(d, 4))
    assert isinstance(bell, sp.BlockedELL) and bell.blocksize == 4
    assert torch.equal(sp.spmv(bell, _t(x)), sp.spmv(sp.dense_to_blocked_ell(d, 4), _t(x)))
    indptr, indices, data = _bsr_parts(d[:, :16], 4)
    bsr = from_reference(RefBSR(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(data),
                                (16, 16), 4))
    assert isinstance(bsr, sp.BSR) and bsr.nnzb == len(indices)
    assert_allclose(sp.spmv(bsr, _t(x[:16])), d[:, :16] @ x[:16], rtol=1e-12)
    rb = ref.dense_to_blocked_ell(d, 4)
    half = rb.data.astype(jnp.bfloat16)
    bf = from_reference(ref.BlockedELL(rb.cols, half, rb.shape, 4))
    assert bf.data.dtype == torch.bfloat16   # bf16 travels as bits
    np.testing.assert_array_equal(to_numpy(bf.data), np.asarray(half.astype(jnp.float32)))


def test_host_construction_device():
    a = sp.dense_to_csr(np.eye(3))
    assert a.data.device == sp.containers.default_device()
    assert sp.dense_to_csr(torch.eye(3)).data.device.type == "cpu"   # the input's device
    assert sp.dense_to_coo(torch.eye(3, dtype=torch.bfloat16)).data.dtype == torch.bfloat16


def test_carried_state_lands_on_the_default_device(monkeypatch, rng):
    """Carried containers and plans land on ``core.device.default_device()``
    (the card); the meta device stands in for the card here."""
    monkeypatch.setattr(core_device, "default_device", lambda: torch.device("meta"))
    d = np.kron(np.eye(2), np.ones((8, 8))) * rng.normal(size=(16, 16))
    csr = from_reference(ref.dense_to_csr(d))
    assert {t.device.type for t in (csr.indptr, csr.indices, csr.data)} == {"meta"}
    plan = from_reference(ref_pk.SpmvPlan(ref.dense_to_blocked_ell(d.astype(np.float32), 8)))
    assert isinstance(plan, sp.SpmvPlan)
    assert plan.cols.device.type == plan.data.device.type == "meta"
