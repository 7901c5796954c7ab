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
- tml_potrf_batched's three routes (a warp a matrix for n, k ≤ 32; 32-column
  panels in shared memory; the in-place column steps), mirrored in numpy
  step by step with the kernel's own order and layouts (the column layout
  and its shuffles, the padding, the transposed rows below a panel, the
  4 × 4 trailing tiles and their enumeration): without FMAs the models
  equal ``_potrf_plain``'s and ``_posv_plain``'s steps in numpy bit for bit
  (``_plain_steps``; torch's CPU ``1.0 / x`` rounds a few pivots' reciprocals
  otherwise, so against the torch functions themselves they agree to 1e-6),
  the non-positive pivot's NaN included; and the port against the reference
  at the routes' boundaries (n = 31, 32, 33, 64, 127, 128).

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


@pytest.mark.parametrize("n", [32, 33, 48])
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
        return self.rc or (1 if k and not factor and port._getrf_route(n, k) == "in place"
                           else 0)

    def tml_potrf_batched(self, a, l, b, x, batch, n, k, stream):
        self.solver_calls.append(dict(kernel="potrf", batch=batch, n=n, k=k, factor=bool(l)))
        rc = self.rc or (1 if not l and port._potrf_route(n, k) == "in place" else 0)
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
                                      piv=bool(piv), pivot=pivot, route=port._getrf_route(n, k)))
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
        # csrc/dx_qr_warp.cuh's geqrf_warp_route and geqrf_panel_route: a warp
        # a matrix to n = 32, 32-column panels to n = 224
        self.solver_calls.append(dict(kernel="geqrf", batch=batch, n=n,
                                      route="warp" if n <= 32 else "panel" if n <= 224 else "block"))
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


def _lu_routes():
    """Launches of the batched LU on each route: (warp, panel, in place)."""
    return port._getrf.warp_launches, port._getrf.panel_launches, port._getrf.in_place_launches


@pytest.mark.parametrize("n", [32, 48])
@pytest.mark.parametrize("kind", ["potrf", "getrf pivot", "getrf nopivot", "geqrf"])
def test_cuda_branch_factor_marshalling(emulated, rng, kind, n):
    bsz = 5
    g = rng.normal(size=(bsz, n, n)).astype(np.float32) + n * np.eye(n, dtype=np.float32)
    a = from_numpy(_spd(rng, bsz, n) if kind == "potrf" else g)
    before, routes = [f.launches for f in _COUNTS], _lu_routes()
    if kind == "potrf":
        got, want, counter = dx.potrf_batched(a), (port._potrf_plain(a),), [1, 0, 0, 0]
        got = (got,)
        call = dict(kernel="potrf", batch=bsz, n=n, k=0, factor=True)
    elif kind.startswith("getrf"):
        pivot = kind == "getrf pivot"
        got, want = dx.getrf_batched(a, pivot=pivot), port._getrf_plain(a, pivot)
        counter = [0, 1, 0, 0]
        call = dict(kernel="getrf", batch=bsz, n=n, k=0, factor=True, piv=True, pivot=int(pivot),
                    route="warp" if n <= 32 else "panel")
    else:
        got, want, counter = dx.geqrf_batched(a), port._geqrf_plain(a), [0, 0, 1, 0]
        call = dict(kernel="geqrf", batch=bsz, n=n, route="warp" if n <= 32 else "panel")
    assert _grew(before) == counter
    assert emulated.solver_calls == [call]
    lu_route = call.get("route") if kind.startswith("getrf") else None   # only its count grows
    assert [r - r0 for r, r0 in zip(_lu_routes(), routes)] == [
        int(lu_route == "warp"), int(lu_route == "panel"), 0]
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
    before, routes = [f.launches for f in _COUNTS], _lu_routes()
    if kind == "gesv":
        got, want, counter = dx.gesv_batched(a, b), port._gesv_plain(a, b), [0, 1, 0, 0]
        call = dict(kernel="getrf", batch=bsz, n=n, k=k, factor=False, piv=False, pivot=1,
                    route="warp")
    else:
        got, want, counter = dx.posv_batched(a, b), port._posv_plain(a, b), [1, 0, 0, 0]
        call = dict(kernel="potrf", batch=bsz, n=n, k=k, factor=False)
    assert _grew(before) == counter
    assert emulated.solver_calls == [call]
    assert [r - r0 for r, r0 in zip(_lu_routes(), routes)] == [int(kind == "gesv"), 0, 0]
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


# ---------------------------------------------------------------------------
# tml_potrf_batched's routes, mirrored in numpy (csrc/dx_solver.cu)

def _model_warp_potrf(d):
    """warp_potrf on f32 (B, 32, 32) in the row layout, d[:, r, c] = A(r, c)
    for c <= r (lane r's registers): step j takes lane j's pivot, every lane
    scales its entry j (l_r) and subtracts l_r·l_c from entry c > j, l_c
    lane c's entry j; the products above the diagonal are junk nothing
    reads. Without the kernel's FMA. Returns each lane's 1/sqrt of its
    pivot."""
    inv = np.zeros(d.shape[:2], np.float32)
    for j in range(32):
        with np.errstate(invalid="ignore"):   # a non-positive pivot: NaN, as the kernel
            ij = np.float32(1) / np.sqrt(d[:, j, j])
        inv[:, j] = ij
        d[:, :, j] = d[:, :, j] * ij[:, None]
        for c in range(j + 1, 32):
            d[:, :, c] = d[:, :, c] - d[:, :, j] * d[:, c, j, None]
    return inv


def _model_warp_route(a, b=None):
    """potrf_warp_kernel: the identity past n, the warp's 32 steps, L with
    zeros above the diagonal; with b (B, n, k ≤ 32), lane r's row of X
    through L y = b on the rows and Lᵀ x = y on the columns, each step
    dividing lane j's entry by the pivot and subtracting l·y from the lanes
    below (above) it."""
    bsz, n, _ = a.shape
    d = np.broadcast_to(np.eye(32, dtype=np.float32), (bsz, 32, 32)).copy()
    low = np.tril(np.ones((n, n), bool))
    d[:, :n, :n] = np.where(low, a, 0)
    _model_warp_potrf(d)
    l32 = np.tril(d)
    if b is None:
        return l32[:, :n, :n]
    x = np.zeros((bsz, 32, b.shape[-1]), np.float32)
    x[:, :n] = b
    for j in range(32):
        y = x[:, j] / l32[:, j, j, None]
        x[:, j] = y
        x[:, j + 1:] = x[:, j + 1:] - l32[:, j + 1:, j, None] * y[:, None]
    for j in reversed(range(32)):
        y = x[:, j] / l32[:, j, j, None]
        x[:, j] = y
        x[:, :j] = x[:, :j] - l32[:, j, :j, None] * y[:, None]
    return x[:, :n]


def _tile_of(t):
    """(row, column) of lower tile t in row-major order, as the kernel finds
    it: a float square root, then integer corrections."""
    i = int((np.sqrt(np.float32(8 * t + 1), dtype=np.float32) - np.float32(1)) * np.float32(0.5))
    while i * (i + 1) // 2 > t:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    return i, t - i * (i + 1) // 2


def _model_panel_route(a):
    """potrf_panel_kernel on f32 (B, n, n): the lower triangle in an (np, np
    + 4) buffer, np = n rounded up to 32, identity past n; for each panel,
    warp 0's steps on the diagonal block, then a row below at a time x_c =
    (a_rc − Σ_{j<c} x_j·L(c, j))·inv_c, kept in its row and transposed above
    the diagonal, then the lower 4 × 4 tiles with a row below n, each
    summing the panel's 32 columns in order from the transposed rows."""
    bsz, n, _ = a.shape
    np_ = -(-n // 32) * 32
    buf = np.zeros((bsz, np_, np_ + 4), np.float32)
    low = np.tril(np.ones((n, n), bool))
    buf[:, :n, :n] = np.where(low, a, 0)
    buf[:, np.arange(n, np_), np.arange(n, np_)] = 1
    for p0 in range(0, n, 32):
        d = buf[:, p0:p0 + 32, p0:p0 + 32].copy()
        inv = _model_warp_potrf(d)
        buf[:, p0:p0 + 32, p0:p0 + 32] = d
        rb = p0 + 32
        if rb < n:
            x = buf[:, rb:n, p0:p0 + 32].copy()
            for c in range(32):
                v = x[:, :, c]
                for j in range(c):
                    v = v - x[:, :, j] * buf[:, p0 + c, p0 + j, None]
                x[:, :, c] = v * inv[:, c, None]
            buf[:, rb:n, p0:p0 + 32] = x
            buf[:, p0:p0 + 32, rb:n] = x.transpose(0, 2, 1)
        t0, m = rb // 4, (n + 3) // 4 - rb // 4
        for t in range(m * (m + 1) // 2 if m > 0 else 0):
            i, jj = _tile_of(t)
            r0, c0 = 4 * (t0 + i), 4 * (t0 + jj)
            acc = buf[:, r0:r0 + 4, c0:c0 + 4].copy()
            for j in range(32):
                acc = acc - buf[:, p0 + j, r0:r0 + 4, None] * buf[:, p0 + j, None, c0:c0 + 4]
            buf[:, r0:r0 + 4, c0:c0 + 4] = acc
    return np.where(low, buf[:, :n, :n], 0).astype(np.float32)


def _plain_steps(a, b=None):
    """``_potrf_plain`` and ``_posv_plain``'s steps in numpy f32, with IEEE
    reciprocals of the pivots' square roots."""
    x = a.astype(np.float32).copy()
    n = x.shape[-1]
    for j in range(n):
        with np.errstate(invalid="ignore"):
            inv = np.float32(1) / np.sqrt(x[:, j, j])
        l = x[:, j:, j] * inv[:, None]
        x[:, j:, j] = l
        x[:, j + 1:, j + 1:] -= l[:, 1:, None] * l[:, None, 1:]
    l = np.tril(x)
    if b is None:
        return l
    y = b.astype(np.float32).copy()
    for j in range(n):
        y[:, j] = y[:, j] / l[:, j, j, None]
        y[:, j + 1:] -= l[:, j + 1:, j, None] * y[:, j, None]
    for j in reversed(range(n)):
        y[:, j] = y[:, j] / l[:, j, j, None]
        y[:, :j] -= l[:, j, :j, None] * y[:, j, None]
    return y


def test_potrf_routes():
    assert [port._potrf_route(n, k) for n, k in ((1, 0), (32, 32), (33, 0), (32, 33), (224, 0),
                                                 (225, 0), (256, 0), (200, 4), (128, 512))] == [
        "warp", "warp", "panel", "panel", "panel", "in place", "in place", "panel", "in place"]


@pytest.mark.parametrize("n", [1, 5, 16, 31, 32])
def test_warp_route_model_takes_the_plain_steps(rng, n):
    a = _spd(rng, 4, n)
    b = rng.normal(size=(4, n, 4)).astype(np.float32)
    np.testing.assert_array_equal(_model_warp_route(a), _plain_steps(a))
    np.testing.assert_array_equal(_model_warp_route(a, b), _plain_steps(a, b))
    _close(_model_warp_route(a), port._potrf_plain(from_numpy(a)), 1e-6)
    _close(_model_warp_route(a, b), port._posv_plain(from_numpy(a), from_numpy(b)), 1e-6)


@pytest.mark.parametrize("n", [32, 33, 64, 96, 127, 128, 224])
def test_panel_route_model_takes_the_plain_steps(rng, n):
    a = _spd(rng, 3, n)
    np.testing.assert_array_equal(_model_panel_route(a), _plain_steps(a))
    _close(_model_panel_route(a), port._potrf_plain(from_numpy(a)), 1e-6)


@pytest.mark.parametrize("n", [32, 33])
def test_route_models_nan_from_the_failing_column(rng, n):
    """C10 on the kernel's routes: a non-positive pivot at column 10 gives NaN
    in its matrix's lower triangle from that column on, as the plain version,
    and nowhere else."""
    a = _spd(rng, 3, n)
    a[1, 10, 10] = -1e4
    plain = to_numpy(port._potrf_plain(from_numpy(a)))
    models = [_model_panel_route(a)] + ([_model_warp_route(a)] if n <= 32 else [])
    for got in models:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
        assert np.isnan(got[1][10:, 10:][np.tril(np.ones((n - 10, n - 10), bool))]).all()
        assert np.isfinite(got[1][:, :10]).all() and np.isfinite(got[[0, 2]]).all()


@pytest.mark.parametrize("n", [31, 32, 33, 64, 127, 128])
def test_potrf_posv_at_route_boundaries(rng, n):
    a = _spd(rng, 3, n)
    b = rng.normal(size=(3, n, 4)).astype(np.float32)
    got = dx.potrf_batched(from_numpy(a))
    _close(got, ref.potrf_batched(jnp.asarray(a)))
    _close(dx.posv_batched(from_numpy(a), from_numpy(b)),
           ref.posv_batched(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(to_numpy(got)[0], scipy.linalg.cholesky(a[0], lower=True),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("n", [32, 33])
def test_bad_matrix_stays_in_its_own_factor_at_route_edges(rng, n):
    """C10 on the ports' routes: a NaN in one matrix stays there; its
    neighbours equal their standalone factors and the reference's."""
    a = _spd(rng, 6, n)
    a[2, n - 1, 3] = np.nan
    got = dx.potrf_batched(from_numpy(a))
    bad = _nonfinite_per_matrix(to_numpy(got))
    assert bad[2] > 0 and sum(bad) == bad[2]
    for i in (0, 1, 3, 4, 5):
        assert torch.equal(got[i], dx.potrf_batched(from_numpy(a[i:i + 1]))[0])
        _close(got[i], ref.potrf_batched(jnp.asarray(a[i:i + 1]))[0])


@pytest.mark.parametrize("n, k", [(32, 32), (33, 4), (200, 4), (225, 2)])
def test_cuda_branch_posv_factor_buffer_follows_the_route(emulated, rng, n, k):
    """The wrapper hands a factor buffer to a solve exactly where the kernel
    works in place."""
    a = from_numpy(_spd(rng, 1, n))
    b = from_numpy(rng.normal(size=(1, n, k)).astype(np.float32))
    x = dx.posv_batched(a, b)
    assert emulated.solver_calls[-1]["factor"] is (port._potrf_route(n, k) == "in place")
    assert max_scaled_err(torch.bmm(a, x), b) <= 1e-4


# ---------------------------------------------------------------------------
# tml_getrf_batched's warp route, mirrored in numpy (csrc/dx_solver.cu's
# getrf_warp_kernel)

def _before(v1, i1, v2, i2):
    """csrc/dx_solver.cu's before(): (v1, i1) ahead of (v2, i2) as a pivot."""
    n1, n2 = np.isnan(v1), np.isnan(v2)
    return np.where(n1 | n2, n1 & (~n2 | (i1 < i2)), (v1 > v2) | ((v1 == v2) & (i1 < i2)))


def _model_warp_getrf(a, pivot=True, b=None):
    """getrf_warp_kernel on f32 (B, n, n), n ≤ 32, with 32 lanes: lane r holds
    row r (the identity past n), ``pos`` its row's index after the swaps so
    far, ``live`` whether it is not yet a pivot row (never for a pad row),
    ``step`` the step at which it became one. Step j: the pivot by the
    kernel's 5-step xor reduction of (|a[j]|, pos) over the live lanes in
    before()'s order (the others carry (−1, 32)); the lane at pos j takes
    the pivot's pos, the pivot lane takes j; the live lanes divide a[j] by
    the pivot and subtract l·u_c from a[c], j < c < n. Then lane r's row goes
    to row pos. With b (B, n, k ≤ 32): L·y = P·b, lane r carrying b's row r
    and the lanes live at step j taking part in its step, then U·x = y,
    the lanes that were pivots before step j taking part; x's row r goes to
    row pos. Without the kernel's FMAs. Returns (LU, piv) or X."""
    bsz, n, _ = a.shape
    lanes, rows = np.arange(32), np.arange(bsz)
    d = np.broadcast_to(np.eye(32, dtype=np.float32), (bsz, 32, 32)).copy()
    d[:, :n, :n] = a
    pos = np.tile(lanes, (bsz, 1))
    live = np.tile(lanes < n, (bsz, 1))
    step = np.full((bsz, 32), n)
    piv = np.zeros((bsz, n), np.int32)
    pl_of = np.zeros((bsz, n), np.int64)
    for j in range(n):
        if pivot:
            bv = np.where(live, np.abs(d[:, :, j]), np.float32(-1))
            bp = np.where(live, pos, 32)
            for off in (16, 8, 4, 2, 1):
                ov, op = bv[:, lanes ^ off], bp[:, lanes ^ off]
                take = _before(ov, op, bv, bp)
                bv, bp = np.where(take, ov, bv), np.where(take, op, bp)
            assert (bp == bp[:, :1]).all()   # every lane holds the same pivot
            p = bp[:, 0]
            pl = np.argmax(live & (pos == p[:, None]), axis=1)
            piv[:, j] = p
            pos = np.where(pos == j, p[:, None], pos)
            pos[rows, pl] = j
        else:
            pl = np.full(bsz, j)
            piv[:, j] = j
        pl_of[:, j] = pl
        u = d[rows, pl].copy()                 # the pivot row, not live from here
        live[rows, pl] = False
        step[rows, pl] = j
        with np.errstate(divide="ignore", invalid="ignore"):
            l = d[:, :, j] / u[:, j, None]
            for c in range(j + 1, n):
                d[:, :, c] = np.where(live, d[:, :, c] - l * u[:, c, None], d[:, :, c])
        d[:, :, j] = np.where(live, l, d[:, :, j])
    placed = np.zeros_like(d)
    placed[rows[:, None], pos] = d
    if b is None:
        return placed[:, :n, :n], piv
    x = np.zeros((bsz, 32, 32), np.float32)
    x[:, :n, :b.shape[-1]] = b
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for j in range(n):
            y = x[rows, pl_of[:, j]]
            x = np.where((step > j)[:, :, None], x - d[:, :, j, None] * y[:, None, :], x)
        for j in reversed(range(n)):
            src = pl_of[:, j]
            y = x[rows, src] / d[rows, src, j][:, None]
            x[rows, src] = y
            x = np.where((step < j)[:, :, None], x - d[:, :, j, None] * y[:, None, :], x)
    out = np.zeros_like(x)
    out[rows[:, None], pos] = x
    return out[:, :n, :b.shape[-1]]


def _lu_cases(rng, n):
    """Gaussian matrices, and matrices with a tie, a NaN (C11) and an
    all-zero column in the pivot columns."""
    a = rng.normal(size=(5, n, n)).astype(np.float32)
    lo, hi = min(1, n - 1), min(3, n - 1)
    a[1, :, 0] = 0.01 * a[1, :, 0]
    a[1, lo, 0], a[1, hi, 0] = -5.0, 5.0            # a tie: the lower row wins
    if n > 1:
        a[2, lo, 0] = a[2, hi, 0] = np.nan          # C11: the first NaN row
    a[3, :, min(2, n - 1)] = 0.0                     # a zero pivot: 0 / 0 from there on
    return a


@pytest.mark.parametrize("n", [1, 5, 16, 31, 32])
def test_getrf_warp_model_takes_the_plain_steps(rng, n):
    """The warp route's model equals _getrf_plain bit for bit, LU and piv,
    pivoted and not, also where a tie, a NaN or a zero column decides the
    pivots (the pad rows never become pivots)."""
    a = _lu_cases(rng, n)
    for pivot in (True, False):
        m = a if pivot else a + n * np.eye(n, dtype=np.float32)
        lu, piv = _model_warp_getrf(m, pivot)
        want_lu, want_piv = (to_numpy(t) for t in port._getrf_plain(from_numpy(m), pivot))
        np.testing.assert_array_equal(piv, want_piv)
        np.testing.assert_array_equal(lu, want_lu)
        if pivot and n > 1:
            assert piv[1, 0] == piv[2, 0] == 1 and np.isnan(lu[2]).any()


@pytest.mark.parametrize("n", [1, 5, 16, 31, 32])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_gesv_warp_model_takes_the_plain_steps(rng, n, k):
    a = _lu_cases(rng, n)
    b = rng.normal(size=(5, n, k)).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        want = to_numpy(port._gesv_plain(from_numpy(a), from_numpy(b)))
    np.testing.assert_array_equal(_model_warp_getrf(a, True, b), want)


def test_getrf_routes(emulated, rng):
    """_getrf_route's rule at its edges (n and k 32/33, the last panel n
    against the first in-place one, with and without a right-hand side), and
    each call counted on its own route, with a factor buffer exactly on the
    in-place route."""
    assert [port._getrf_route(n, k) for n, k in ((1, 0), (32, 0), (32, 32), (16, 4), (33, 0),
                                                 (32, 33), (48, 4), (224, 0), (225, 0),
                                                 (256, 0), (224, 4), (224, 32), (128, 321),
                                                 (128, 322), (1, 33))] == [
        "warp", "warp", "warp", "warp", "panel", "panel", "panel", "panel", "in place",
        "in place", "panel", "in place", "panel", "in place", "panel"]
    assert port._getrf_route(224, 0) == port._potrf_route(224, 0)
    for n, k in ((32, 0), (32, 32), (33, 0), (32, 33), (225, 0), (225, 2)):
        a = from_numpy(rng.normal(size=(2, n, n)).astype(np.float32))
        routes = _lu_routes()
        if k:
            dx.gesv_batched(a, from_numpy(rng.normal(size=(2, n, k)).astype(np.float32)))
        else:
            dx.getrf_batched(a)
        route = port._getrf_route(n, k)
        assert [r - r0 for r, r0 in zip(_lu_routes(), routes)] == [
            int(route == "warp"), int(route == "panel"), int(route == "in place")]
        assert emulated.solver_calls[-1]["route"] == route
        assert emulated.solver_calls[-1]["factor"] is (not k or route == "in place")


# ---------------------------------------------------------------------------
# tml_getrf_batched's panel route, mirrored in numpy (csrc/dx_solver.cu's
# getrf_panel_kernel)

_INT_MAX = 2**31 - 1


def _pivot_key(v, live):
    """csrc/dx_solver.cu's pivot_key: |v|'s bits + 1 (a NaN above every
    number), 0 for a row that is not live."""
    m = np.abs(v).astype(np.float32)
    key = m.view(np.uint32).astype(np.int64) + 1
    return np.where(live, np.where(np.isnan(m), 2**32 - 1, key), 0)


def _model_panel_getrf(a, pivot=True, b=None):
    """getrf_panel_kernel on f32 (B, n, n): the matrix padded to np = n
    rounded up to 32 with the identity, a thread a row. A panel p0: thread
    t's 32 panel entries in "registers" with ``pos`` and ``live`` (pad rows
    never live); step j's pivot by each warp's largest pivot key then lowest
    pos among those (the warp's slot: key, pos, thread), then the first slot
    of the warps from p0 / 32 on in (key, −pos) order; the live rows divide
    by the pivot and subtract l·u_c from their entries c > j. Each row then
    goes to row pos; the panel's swaps go in sequence down every other column
    (and X's); right of the panel L11·U12 = A12 row by row in ascending j;
    then the trailing block, rows and columns to n rounded up to 4 (the
    kernel's 4 × 4 tiles), takes the panel's 32 products in ascending j.
    With b (B, n, k): after the last panel L·y = P·b and U·x = y, a column
    at a time, as gesv_solves. Without the kernel's FMAs. Returns (LU, piv)
    or X."""
    bsz, n, _ = a.shape
    np_ = -(-n // 32) * 32
    warps, rows, threads = np_ // 32, np.arange(bsz), np.arange(np_)
    buf = np.zeros((bsz, np_, np_ + 4), np.float32)
    buf[:, :n, :n] = a
    buf[:, np.arange(n, np_), np.arange(n, np_)] = 1
    x = None if b is None else b.astype(np.float32).copy()
    piv = np.zeros((bsz, n), np.int32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for p0 in range(0, n, 32):
            w = min(32, n - p0)
            reg = buf[:, :, p0:p0 + 32].copy()
            pos = np.tile(threads, (bsz, 1))
            live = np.tile((threads >= p0) & (threads < n), (bsz, 1))
            for jj in range(w):
                j = p0 + jj
                if pivot:
                    key = _pivot_key(reg[:, :, jj], live).reshape(bsz, warps, 32)
                    wkey = key.max(axis=2)
                    win = (key == wkey[..., None]) & (key != 0)
                    wpos = np.where(win, pos.reshape(bsz, warps, 32), _INT_MAX).min(axis=2)
                    wtid = np.argmax(win & (pos.reshape(bsz, warps, 32) == wpos[..., None]),
                                     axis=2) + 32 * np.arange(warps)
                    best = np.full(bsz, p0 // 32)
                    for wi in range(p0 // 32 + 1, warps):
                        bk, bp = wkey[rows, best], wpos[rows, best]
                        best = np.where((wkey[:, wi] > bk) | ((wkey[:, wi] == bk) & (wpos[:, wi] < bp)),
                                        wi, best)
                    pr, prow = wpos[rows, best], wtid[rows, best]
                    pos = np.where(pos == j, pr[:, None], pos)
                    pos[rows, prow] = j
                else:
                    pr = prow = np.full(bsz, j)
                piv[:, j] = pr
                u = reg[rows, prow].copy()
                live[rows, prow] = False
                l = reg[:, :, jj] / u[:, jj, None]
                for c in range(jj + 1, 32):
                    reg[:, :, c] = np.where(live, reg[:, :, c] - l * u[:, c, None], reg[:, :, c])
                reg[:, :, jj] = np.where(live, l, reg[:, :, jj])
            buf[rows[:, None], pos[:, p0:], p0:p0 + 32] = reg[:, p0:]
            other = [c for c in range(n) if c < p0 or c >= p0 + w]
            cols = buf[:, :, other]
            for jj in range(w):   # laswp, on the other columns and X
                pr = piv[:, p0 + jj]
                for m in (cols,) if x is None else (cols, x):
                    top, pivrow = m[rows, p0 + jj].copy(), m[rows, pr].copy()
                    m[rows, p0 + jj] = pivrow
                    m[rows, pr] = top
            buf[:, :, other] = cols
            if p0 + 32 < n:
                u12 = buf[:, p0:p0 + 32, p0 + 32:n]
                for r in range(1, 32):
                    v = u12[:, r]
                    for jj in range(r):
                        v = v - u12[:, jj] * buf[:, p0 + r, p0 + jj, None]
                    u12[:, r] = v
                rb, n4 = p0 + 32, -(-n // 4) * 4
                for jj in range(32):
                    buf[:, rb:n4, rb:n4] = (buf[:, rb:n4, rb:n4]
                                            - buf[:, rb:n4, p0 + jj, None] * buf[:, p0 + jj, None, rb:n4])
        if b is None:
            return buf[:, :n, :n], piv
        for j in range(n):
            x[:, j + 1:] = x[:, j + 1:] - buf[:, j + 1:n, j, None] * x[:, j, None]
        for j in reversed(range(n)):
            x[:, j] = x[:, j] / buf[:, j, j, None]
            x[:, :j] = x[:, :j] - buf[:, :j, j, None] * x[:, j, None]
    return x


def _panel_cases(rng, n):
    """_lu_cases (a tie, C11's NaN, a zero column), C10's bad matrix (an inf
    among good ones: it stays in its own factor), and a singular matrix
    whose first column is zero: 0 / 0 makes every live row NaN at once, and
    a pad row that took part would be NaN too and win the next pivot."""
    a = np.concatenate([_lu_cases(rng, n), rng.normal(size=(2, n, n)).astype(np.float32)])
    a[5, n - 1, 3] = np.inf
    a[6, :, 0] = 0.0
    return a


@pytest.mark.parametrize("n", [33, 48, 64, 100, 128])
def test_getrf_panel_model_takes_the_plain_steps(rng, n):
    """The panel route's model equals _getrf_plain bit for bit, LU and piv,
    pivoted and not, with ties, NaN, a zero column, an inf (C10) and a zero
    first column; no pad row is ever a pivot."""
    a = _panel_cases(rng, n)
    for pivot in (True, False):
        m = a if pivot else a + n * np.eye(n, dtype=np.float32)
        lu, piv = _model_panel_getrf(m, pivot)
        with np.errstate(invalid="ignore", over="ignore"):
            want_lu, want_piv = (to_numpy(t) for t in port._getrf_plain(from_numpy(m), pivot))
        np.testing.assert_array_equal(piv, want_piv)
        np.testing.assert_array_equal(lu, want_lu)
        assert ((piv >= 0) & (piv < n)).all()
        if pivot:
            assert piv[1, 0] == 1 and piv[2, 0] == 1 and np.isnan(lu[2]).any()
            assert np.isnan(lu[6]).any() and piv[6, 0] == 0
        bad = _nonfinite_per_matrix(lu)
        assert bad[5] > 0 and bad[0] == bad[4] == 0


@pytest.mark.parametrize("n", [33, 48, 64, 100, 128])
@pytest.mark.parametrize("k", [1, 4, 33])
def test_gesv_panel_model_takes_the_plain_steps(rng, n, k):
    a = _panel_cases(rng, n)
    b = rng.normal(size=(len(a), n, k)).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        want = to_numpy(port._gesv_plain(from_numpy(a), from_numpy(b)))
    np.testing.assert_array_equal(_model_panel_getrf(a, True, b), want)


def test_panel_model_keeps_pad_rows_out():
    """A matrix of zeros at n = 33 (31 pad rows): every step's pivot is a
    real row, 0 / 0 leaves NaN in the real rows only, as the plain loop's."""
    a = np.zeros((1, 33, 33), np.float32)
    lu, piv = _model_panel_getrf(a)
    with np.errstate(invalid="ignore"):
        want_lu, want_piv = (to_numpy(t) for t in port._getrf_plain(from_numpy(a)))
    np.testing.assert_array_equal(piv, want_piv)
    np.testing.assert_array_equal(lu, want_lu)
    assert piv[0].tolist() == list(range(33))
