"""Parity of tpumathlib_torch.dx.solver (kernels B7a–B7d and B7i) with the
reference's Pallas kernels, run in interpret mode, and with SciPy/LAPACK.

- Every test of tests/test_dx_solver.py for the ported functions, through
  both packages on the same seeded numpy inputs: the port (its plain
  versions on CPU tensors) is held to the reference at 1e-5 max-scaled on
  factors and solutions (measured: at most 3.5e-6), with identical pivots,
  and to SciPy at the reference test's own tolerances. The one Gaussian
  solve (the hard-pivot case) is held at 1e-4 (measured 1.6e-5): the
  matrix's condition multiplies the rounding differences.
- The packed functions' "n must divide 128" check.
- C10 pinned: the reference's lane-packed routes make the matrices that
  share a bad matrix's lane row non-finite; the port's equal their
  standalone factors. C11 pinned: with a NaN in a pivot column the
  reference's pivot is n (out of range) and its LU is finite; the port's
  pivot is the first NaN row and the NaN shows in the LU.
- The CUDA branch of each wrapper, with the kernel library replaced by a CPU
  emulation of tml_potrf_batched, tml_getrf_batched and tml_geqrf_batched
  that reads the tensors through their pointers and shapes: the pivot flag,
  the optional right-hand side, the factor buffer and the launch counts.
- The slice as a whole at batch 64 × n 32 and 48 through the public
  functions, against the reference.

Inputs are explicit f32 on both sides: the suite turns on jax x64.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from tpumathlib.core.errors import InvalidValueError as RefInvalidValueError
from tpumathlib.dx import solver as ref
from tpumathlib_torch import dx
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.core.interop import from_numpy, to_numpy
from tpumathlib_torch.dx import cuda_utils, gemm
from tpumathlib_torch.dx import solver as port
from test_torch_dx_gemm import _EmulatedLib as _EmulatedGemmLib, _view

torch.set_num_threads(1)

TOL = 1e-5   # port against the reference's kernels, max-scaled
F32 = torch.float32
_COUNTS = (port._potrf, port._getrf, port._geqrf, gemm.pallas_matmul)


@pytest.fixture
def rng():
    return np.random.default_rng(42)   # tests/test_dx_solver.py's seed


def _spd(rng, b, n):
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)


def _close(got, want, tol=TOL):
    err = max_scaled_err(got, np.asarray(want).astype(np.float64))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


def _swapped(a, piv):
    """a with the recorded row-swap sequence applied."""
    pa = a.copy()
    for j, p in enumerate(piv):
        pa[[j, p]] = pa[[p, j]]
    return pa


def _nonfinite_per_matrix(x):
    return (~np.isfinite(np.asarray(x))).reshape(len(x), -1).sum(axis=1).tolist()


# ---------------------------------------------------------------------------
# tests/test_dx_solver.py, through both packages

@pytest.mark.parametrize("n", [8, 32, 48, 64])
def test_potrf_batched(rng, n):
    a = _spd(rng, 5, n)
    got = dx.potrf_batched(from_numpy(a))
    assert got.dtype == F32 and got.shape == (5, n, n)
    _close(got, ref.potrf_batched(jnp.asarray(a)))
    l = to_numpy(got)
    for i in range(a.shape[0]):
        np.testing.assert_allclose(l[i], scipy.linalg.cholesky(a[i], lower=True),
                                   rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("n", [32, 48])
@pytest.mark.parametrize("pivot", [True, False])
def test_getrf_batched(rng, pivot, n):
    b = 4
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    if not pivot:
        a = a + n * np.eye(n, dtype=np.float32)
    lu, piv = dx.getrf_batched(from_numpy(a), pivot=pivot)
    rlu, rpiv = ref.getrf_batched(jnp.asarray(a), pivot=pivot)
    assert piv.dtype == torch.int32 and lu.dtype == F32
    np.testing.assert_array_equal(to_numpy(piv), np.asarray(rpiv))
    _close(lu, rlu)
    lu, piv = to_numpy(lu), to_numpy(piv)
    for i in range(b):
        l = np.tril(lu[i], -1) + np.eye(n)
        np.testing.assert_allclose(l @ np.triu(lu[i]), _swapped(a[i], piv[i]), rtol=2e-3, atol=2e-3)
        if pivot:
            assert np.abs(l).max() <= 1.0 + 1e-5


def test_getrf_pivot_hard_case(rng):
    n = 24
    a = rng.normal(size=(2, n, n)).astype(np.float32)
    a[:, 0, 0] = 1e-8
    x = rng.normal(size=(2, n, 3)).astype(np.float32)
    b = a @ x
    got = dx.gesv_batched(from_numpy(a), from_numpy(b))
    np.testing.assert_allclose(to_numpy(got), x, rtol=1e-2, atol=1e-2)
    # a Gaussian matrix: its condition (about 1e2 to 1e3) multiplies the two
    # packages' rounding differences in the solution
    _close(got, ref.gesv_batched(jnp.asarray(a), jnp.asarray(b)), 1e-4)


@pytest.mark.parametrize("k", [1, 4])
def test_gesv_batched(rng, k):
    n, bsz = 48, 6
    a = rng.normal(size=(bsz, n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
    x = rng.normal(size=(bsz, n, k)).astype(np.float32)
    b = a @ x
    got = dx.gesv_batched(from_numpy(a), from_numpy(b))
    assert got.shape == (bsz, n, k) and got.dtype == F32
    np.testing.assert_allclose(to_numpy(got), x, rtol=2e-3, atol=2e-3)
    _close(got, ref.gesv_batched(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("k", [1, 4])
def test_posv_batched(rng, k):
    n, bsz = 48, 6
    a = _spd(rng, bsz, n)
    x = rng.normal(size=(bsz, n, k)).astype(np.float32)
    b = a @ x
    got = dx.posv_batched(from_numpy(a), from_numpy(b))
    assert got.shape == (bsz, n, k) and got.dtype == F32
    np.testing.assert_allclose(to_numpy(got), x, rtol=2e-3, atol=2e-3)
    _close(got, ref.posv_batched(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("n", [32, 48])
def test_geqrf_batched(rng, n):
    bsz = 4
    a = rng.normal(size=(bsz, n, n)).astype(np.float32)
    qr, taus = dx.geqrf_batched(from_numpy(a))
    rqr, rtaus = ref.geqrf_batched(jnp.asarray(a))
    _close(qr, rqr)
    _close(taus, rtaus)
    qr, taus = to_numpy(qr), to_numpy(taus)
    for i in range(bsz):
        ref_qr, ref_tau = scipy.linalg.lapack.sgeqrf(a[i])[:2]
        np.testing.assert_allclose(qr[i], ref_qr, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(taus[i], ref_tau, rtol=2e-3, atol=2e-3)
        q = scipy.linalg.lapack.sorgqr(qr[i].copy(), taus[i].copy())[0]
        np.testing.assert_allclose(q @ np.triu(qr[i]), a[i], rtol=2e-3, atol=2e-3)


def test_potrf_blocked(rng):
    n = 256
    a = rng.normal(size=(n, n)).astype(np.float32)
    a = a @ a.T + n * np.eye(n, dtype=np.float32)
    l = dx.potrf_blocked(from_numpy(a), block=128)
    assert l.dtype == F32 and l.shape == (n, n)
    np.testing.assert_allclose(to_numpy(l), scipy.linalg.cholesky(a, lower=True),
                               rtol=2e-3, atol=2e-2)
    _close(l, ref.potrf_blocked(jnp.asarray(a), block=128))


@pytest.mark.parametrize("n", [16, 32, 64])
def test_potrf_batched_packed(rng, n):
    a = _spd(rng, 7, n)
    got = port.potrf_batched_packed(from_numpy(a))
    _close(got, ref.potrf_batched_packed(jnp.asarray(a)))
    l = to_numpy(got)
    for i in range(a.shape[0]):
        np.testing.assert_allclose(l[i], scipy.linalg.cholesky(a[i], lower=True),
                                   rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("pivot", [True, False])
def test_getrf_batched_packed(rng, n, pivot):
    a = rng.normal(size=(7, n, n)).astype(np.float32)
    if not pivot:
        a = a + n * np.eye(n, dtype=np.float32)
    lu, piv = port.getrf_batched_packed(from_numpy(a), pivot)
    rlu, rpiv = ref.getrf_batched_packed(jnp.asarray(a), pivot)
    np.testing.assert_array_equal(to_numpy(piv), np.asarray(rpiv))
    _close(lu, rlu)


@pytest.mark.parametrize("fn", ["potrf_batched_packed", "getrf_batched_packed"])
@pytest.mark.parametrize("n", [48, 256])
def test_packed_functions_need_n_dividing_128(fn, n):
    a = np.broadcast_to(np.eye(n, dtype=np.float32), (2, n, n)).copy()
    with pytest.raises(RefInvalidValueError, match="n must divide 128"):
        getattr(ref, fn)(jnp.asarray(a))
    with pytest.raises(InvalidValueError, match="n must divide 128"):
        getattr(port, fn)(from_numpy(a))


def test_dtype_is_cast_back(rng):
    """f32 arithmetic, results in the input's dtype, as the reference."""
    a = _spd(rng, 3, 32).astype(np.float64)
    got = dx.potrf_batched(from_numpy(a))
    assert got.dtype == torch.float64
    assert torch.equal(got, dx.potrf_batched(from_numpy(a.astype(np.float32))).double())
    want = ref.potrf_batched(jnp.asarray(a))
    assert want.dtype == jnp.float64
    _close(got, want)
    qr, taus = dx.geqrf_batched(from_numpy(a))
    assert qr.dtype == taus.dtype == torch.float64


# ---------------------------------------------------------------------------
# Numerical edge cases

@pytest.mark.parametrize("n", [32, 48])
def test_pivot_ties_take_the_lowest_row(rng, n):
    a = 0.01 * rng.normal(size=(2, n, n)).astype(np.float32)
    a[:, 7, 0], a[:, 12, 0] = -5.0, 5.0
    _, piv = dx.getrf_batched(from_numpy(a))
    _, rpiv = ref.getrf_batched(jnp.asarray(a))
    assert to_numpy(piv)[:, 0].tolist() == np.asarray(rpiv)[:, 0].tolist() == [7, 7]


@pytest.mark.parametrize("n", [32, 48])
def test_potrf_not_spd_gives_nan_from_the_failing_column(rng, n):
    a = _spd(rng, 3, n)
    f = 10
    a[1, f, f] = -1e4
    got = to_numpy(dx.potrf_batched(from_numpy(a)))
    low = np.tril(np.ones((n, n), bool))
    assert np.isfinite(got[1][:, :f]).all()
    assert np.isnan(got[1][f:, f:][low[f:, f:]]).all()
    assert (got[1][~low] == 0).all()
    for i in (0, 2):   # the neighbours stay their own
        assert torch.equal(torch.from_numpy(got[i]), dx.potrf_batched(from_numpy(a[i:i + 1]))[0])
    if n == 48:   # the reference's _run_batched route keeps matrices apart too
        want = np.asarray(ref.potrf_batched(jnp.asarray(a)))
        assert _nonfinite_per_matrix(want) == _nonfinite_per_matrix(got)


def test_geqrf_zero_column_and_zero_leading_entry(rng):
    n = 32
    a = rng.normal(size=(2, n, n)).astype(np.float32)
    a[0, :, 5] = 0.0          # a zero column: tau = 0
    a[1, 0, 0] = 0.0          # x_j == 0 with a non-zero tail: sign taken as +1
    qr, taus = dx.geqrf_batched(from_numpy(a))
    rqr, rtaus = ref.geqrf_batched(jnp.asarray(a))
    assert to_numpy(taus)[0, 5] == 0.0 == float(np.asarray(rtaus)[0, 5])
    _close(qr, rqr)
    _close(taus, rtaus)
    assert to_numpy(qr)[1, 0, 0] < 0   # alpha = -|x|
    ref_qr, ref_tau = scipy.linalg.lapack.sgeqrf(a[1])[:2]
    np.testing.assert_allclose(to_numpy(qr)[1], ref_qr, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(to_numpy(taus)[1], ref_tau, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# C10: the reference's packed routes spread a bad matrix to its neighbours

@pytest.mark.parametrize("what, n, bad", [("potrf", 32, 2), ("potrf", 16, 3),
                                          ("getrf nopivot", 32, 1)])
def test_bad_matrix_stays_in_its_own_factor_c10(rng, what, n, bad):
    bsz = 10
    if what == "potrf":
        a = _spd(rng, bsz, n)
        a[bad, n - 1, 3] = np.nan
        run_ref, run_port = ref.potrf_batched, dx.potrf_batched
    else:
        a = rng.normal(size=(bsz, n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
        a[bad, 4, 4] = np.inf
        run_ref = lambda x: ref.getrf_batched(x, pivot=False)[0]     # noqa: E731
        run_port = lambda x: dx.getrf_batched(x, pivot=False)[0]     # noqa: E731
    want = np.asarray(run_ref(jnp.asarray(a)))
    got = run_port(from_numpy(a))
    p = 128 // n
    row = range((bad // p) * p, (bad // p + 1) * p)   # the lane row of the bad matrix
    ref_bad = _nonfinite_per_matrix(want)
    assert all(ref_bad[i] > 0 for i in row)           # the reference: the whole lane row
    port_bad = _nonfinite_per_matrix(to_numpy(got))
    assert port_bad[bad] > 0 and sum(port_bad) == port_bad[bad]
    for i in range(bsz):
        if i != bad:
            assert torch.equal(got[i], run_port(from_numpy(a[i:i + 1]))[0])
            _close(got[i], run_ref(jnp.asarray(a[i:i + 1]))[0])


# ---------------------------------------------------------------------------
# C11: a NaN in a pivot column

@pytest.mark.parametrize("n", [32, 48])
def test_nan_in_pivot_column_c11(rng, n):
    a = rng.normal(size=(3, n, n)).astype(np.float32)
    a[0, 5, 0] = np.nan
    a[0, 9, 0] = np.nan
    lu, piv = dx.getrf_batched(from_numpy(a))
    rlu, rpiv = ref.getrf_batched(jnp.asarray(a))
    rpiv, rlu = np.asarray(rpiv), np.asarray(rlu)
    assert rpiv[0][:4].tolist() == [n] * 4 and np.isfinite(rlu[0]).all()   # the fault
    piv, lu = to_numpy(piv), to_numpy(lu)
    assert ((piv >= 0) & (piv < n)).all() and piv[0, 0] == 5
    assert np.isnan(lu[0]).any()
    # the other matrices as the reference factors them alone (at n = 32 its
    # packed route spreads the NaN to them too, C10)
    olu, opiv = ref.getrf_batched(jnp.asarray(a[1:]))
    np.testing.assert_array_equal(piv[1:], np.asarray(opiv))
    _close(lu[1:], olu)
    x = dx.gesv_batched(from_numpy(a), from_numpy(np.ones((3, n, 2), np.float32)))
    assert np.isnan(to_numpy(x)[0]).any() and np.isfinite(to_numpy(x)[1:]).all()


# ---------------------------------------------------------------------------
# The slice as a whole, through the public functions

@pytest.mark.parametrize("n", [32, 48])
def test_slice_against_reference(rng, n):
    bsz, k = 64, 4
    g = rng.normal(size=(bsz, n, n)).astype(np.float32)
    dom = g + n * np.eye(n, dtype=np.float32)
    spd = _spd(rng, bsz, n)
    rhs = rng.normal(size=(bsz, n, k)).astype(np.float32)
    _close(dx.potrf_batched(from_numpy(spd)), ref.potrf_batched(jnp.asarray(spd)))
    for pivot, m in ((True, g), (False, dom)):
        lu, piv = dx.getrf_batched(from_numpy(m), pivot=pivot)
        rlu, rpiv = ref.getrf_batched(jnp.asarray(m), pivot=pivot)
        np.testing.assert_array_equal(to_numpy(piv), np.asarray(rpiv))
        _close(lu, rlu)
    qr, taus = dx.geqrf_batched(from_numpy(g))
    rqr, rtaus = ref.geqrf_batched(jnp.asarray(g))
    _close(qr, rqr)
    _close(taus, rtaus)
    _close(dx.gesv_batched(from_numpy(dom), from_numpy(rhs)),
           ref.gesv_batched(jnp.asarray(dom), jnp.asarray(rhs)))
    _close(dx.posv_batched(from_numpy(spd), from_numpy(rhs)),
           ref.posv_batched(jnp.asarray(spd), jnp.asarray(rhs)))


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

def _batch(ptr, b, n, m):
    return _view(ptr, F32, (b, n, m), (n * m, m, 1))


class _EmulatedLib(_EmulatedGemmLib):
    """Adds the contracts of dx_solver.cu's entry points, computed on the CPU
    from the raw arguments and the plain versions, the C side's refusals
    included."""

    def __init__(self, rc=0):
        super().__init__()
        self.rc = rc
        self.solver_calls = []

    def _refuse(self, factor, n, k):
        return self.rc or (1 if k and not factor and port._smem_bytes(n, k) > port.SMEM_MAX
                           else 0)

    def tml_potrf_batched(self, a, l, b, x, batch, n, k, stream):
        self.solver_calls.append(dict(kernel="potrf", batch=batch, n=n, k=k, factor=bool(l)))
        rc = self._refuse(l, n, k)
        if rc:
            return rc
        at = _batch(a, batch, n, n).clone()
        if k:
            _batch(x, batch, n, k).copy_(port._posv_plain(at, _batch(b, batch, n, k).clone()))
        if l:
            _batch(l, batch, n, n).copy_(port._potrf_plain(at))
        return 0

    def tml_getrf_batched(self, a, lu, piv, b, x, batch, n, k, pivot, stream):
        self.solver_calls.append(dict(kernel="getrf", batch=batch, n=n, k=k, factor=bool(lu),
                                      piv=bool(piv), pivot=pivot))
        rc = self._refuse(lu, n, k) or (1 if k and not pivot else 0)
        if rc:
            return rc
        at = _batch(a, batch, n, n).clone()
        if k:
            _batch(x, batch, n, k).copy_(port._gesv_plain(at, _batch(b, batch, n, k).clone()))
        if lu:
            f, p = port._getrf_plain(at, bool(pivot))
            _batch(lu, batch, n, n).copy_(f)
            if piv:
                _view(piv, torch.int32, (batch, n), (n, 1)).copy_(p)
        return 0

    def tml_geqrf_batched(self, a, qr, tau, batch, n, stream):
        self.solver_calls.append(dict(kernel="geqrf", batch=batch, n=n))
        if self.rc:
            return self.rc
        f, t = port._geqrf_plain(_batch(a, batch, n, n).clone())
        _batch(qr, batch, n, n).copy_(f)
        _view(tau, F32, (batch, n), (n, 1)).copy_(t)
        return 0

    def tml_error_string(self, rc):
        return b"emulated failure"


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


@pytest.mark.parametrize("n", [32, 48])
@pytest.mark.parametrize("kind", ["potrf", "getrf pivot", "getrf nopivot", "geqrf"])
def test_cuda_branch_factor_marshalling(emulated, rng, kind, n):
    bsz = 5
    g = rng.normal(size=(bsz, n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
    a = from_numpy(_spd(rng, bsz, n) if kind == "potrf" else g)
    before = [f.launches for f in _COUNTS]
    if kind == "potrf":
        got, want, counter = dx.potrf_batched(a), (port._potrf_plain(a),), [1, 0, 0, 0]
        got = (got,)
        call = dict(kernel="potrf", batch=bsz, n=n, k=0, factor=True)
    elif kind.startswith("getrf"):
        pivot = kind == "getrf pivot"
        got, want = dx.getrf_batched(a, pivot=pivot), port._getrf_plain(a, pivot)
        counter = [0, 1, 0, 0]
        call = dict(kernel="getrf", batch=bsz, n=n, k=0, factor=True, piv=True, pivot=int(pivot))
    else:
        got, want, counter = dx.geqrf_batched(a), port._geqrf_plain(a), [0, 0, 1, 0]
        call = dict(kernel="geqrf", batch=bsz, n=n)
    assert _grew(before) == counter
    assert emulated.solver_calls == [call]
    for g_, w in zip(got, want):
        assert g_.dtype == w.dtype and torch.equal(g_, w)


@pytest.mark.parametrize("kind", ["gesv", "posv"])
@pytest.mark.parametrize("k", [1, 4])
def test_cuda_branch_solve_marshalling(emulated, rng, kind, k):
    """A solve hands the right-hand side to the factor's kernel and no factor
    buffer (the matrix stays in shared memory)."""
    n, bsz = 32, 3
    a = from_numpy(_spd(rng, bsz, n))
    b = from_numpy(rng.normal(size=(bsz, n, k)).astype(np.float32))
    before = [f.launches for f in _COUNTS]
    if kind == "gesv":
        got, want, counter = dx.gesv_batched(a, b), port._gesv_plain(a, b), [0, 1, 0, 0]
        call = dict(kernel="getrf", batch=bsz, n=n, k=k, factor=False, piv=False, pivot=1)
    else:
        got, want, counter = dx.posv_batched(a, b), port._posv_plain(a, b), [1, 0, 0, 0]
        call = dict(kernel="potrf", batch=bsz, n=n, k=k, factor=False)
    assert _grew(before) == counter
    assert emulated.solver_calls == [call]
    assert got.shape == (bsz, n, k) and torch.equal(got, want)


def test_cuda_branch_large_solve_passes_a_factor_buffer(emulated, rng):
    """n = 256 does not fit a block's shared memory: the kernel works in
    place in a factor buffer, which the wrapper must hand over."""
    n = 256
    assert port._smem_bytes(n, 2) > port.SMEM_MAX >= port._smem_bytes(128, 4)
    a = from_numpy(_spd(rng, 1, n))
    b = from_numpy(rng.normal(size=(1, n, 2)).astype(np.float32))
    x = dx.posv_batched(a, b)
    assert emulated.solver_calls[-1]["factor"] is True
    assert max_scaled_err(torch.bmm(a, x), b) <= 1e-5


@pytest.mark.parametrize("n", [16, 32, 64])
def test_cuda_branch_packed_routes_launch_the_same_kernels(emulated, rng, n):
    a = from_numpy(_spd(rng, 4, n))
    before = [f.launches for f in _COUNTS]
    dx.potrf_batched(a)
    port.potrf_batched_packed(a)
    dx.getrf_batched(a)
    port.getrf_batched_packed(a, pivot=False)
    assert _grew(before) == [2, 2, 0, 0]
    assert [c["n"] for c in emulated.solver_calls] == [n] * 4


def test_cuda_branch_potrf_blocked_grows_both_counts(emulated, rng):
    n = 384
    g = rng.normal(size=(n, n)).astype(np.float32)
    a = g @ g.T / n + 4 * np.eye(n, dtype=np.float32)
    before = [f.launches for f in _COUNTS]
    l = dx.potrf_blocked(from_numpy(a))
    assert _grew(before) == [3, 0, 0, 2]   # three panels, two trailing updates
    assert [c["n"] for c in emulated.solver_calls] == [128] * 3
    _close(l, scipy.linalg.cholesky(a.astype(np.float64), lower=True), 1e-5)


def test_cuda_branch_raises_on_launch_failure(emulated, rng):
    emulated.rc = 9   # cudaErrorInvalidConfiguration
    a = from_numpy(_spd(rng, 2, 32))
    before = [f.launches for f in _COUNTS]
    with pytest.raises(ExecutionError, match="tml_potrf_batched: CUDA error 9"):
        dx.potrf_batched(a)
    with pytest.raises(ExecutionError, match="tml_getrf_batched: CUDA error 9"):
        dx.gesv_batched(a, a[:, :, :2])
    with pytest.raises(ExecutionError, match="tml_geqrf_batched: CUDA error 9"):
        dx.geqrf_batched(a)
    assert _grew(before) == [0, 0, 0, 0]


def test_cuda_branch_propagates_loader_failure(monkeypatch, rng):
    """For CUDA tensors the wrappers launch or raise, never fall back."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(port, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    a = from_numpy(_spd(rng, 2, 32))
    for run in (lambda: dx.potrf_batched(a), lambda: dx.getrf_batched(a),
                lambda: dx.geqrf_batched(a), lambda: dx.posv_batched(a, a)):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            run()


def test_cpu_takes_plain_versions_without_launch(rng):
    a = from_numpy(_spd(rng, 2, 48))
    before = [f.launches for f in _COUNTS]
    assert torch.equal(dx.potrf_batched(a), port._potrf_plain(a))
    assert torch.equal(dx.posv_batched(a, a), port._posv_plain(a, a))
    dx.potrf_blocked(a[0], block=16)
    assert _grew(before) == [0, 0, 0, 0]
