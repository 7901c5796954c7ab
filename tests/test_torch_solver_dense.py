"""Parity of tpumathlib_torch.solver.dense with tpumathlib.solver.dense.

Mirrors ``tests/test_solver_dense.py:45-107`` through both packages on the
same seeded float64 inputs (``xgeqrf``/``xormqr`` at ``:93-100``), at those tests' tolerances (LAPACK-level: 1e-12
for the factors, 1e-10 for the solves), and compares the two packages'
outputs with each other. Pivots are compared as the reference returns them
(0-based). Off the kernel route the port takes torch's vendor path where
the reference takes XLA's; the route itself is tested with a stand-in.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.solver import dense as ref
from tpumathlib_torch.core.check import assert_allclose, max_scaled_err
from tpumathlib_torch.solver import dense, onelaunch, potrf_batched, xgeqrf, xgetrf, xgetrs
from tpumathlib_torch.solver import xorgqr, xormqr, xpotrf, xpotrs, xtrtri
from tpumathlib_torch.solver.qr_onelaunch import (_geqrf_onelaunch_plain, _orgqr_onelaunch_plain,
                                                  qr_onelaunch)

torch.set_num_threads(1)

N = 24


@pytest.fixture
def spd(rng):
    a = rng.normal(size=(N, N))
    return (a @ a.T / N + 2 * np.eye(N)).astype(np.float64)


@pytest.fixture
def gen(rng):
    return (rng.normal(size=(N, N)) + 3 * np.eye(N)).astype(np.float64)


def _same(got, want, tol=1e-12):
    err = max_scaled_err(got, np.asarray(want))
    assert err <= tol, f"port vs reference: max-scaled err {err:.3e} > {tol:g}"


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_xpotrf_potrs(spd, rng, uplo):
    f, info = xpotrf(torch.from_numpy(spd), uplo)
    rf, rinfo = ref.xpotrf(jnp.asarray(spd), uplo)
    assert int(info) == int(rinfo) == 0 and info.dtype == torch.int32
    _same(f, rf)
    fn = f.numpy()
    if uplo == "L":
        assert_allclose(np.tril(fn) @ np.tril(fn).T, spd, rtol=1e-12)
    else:
        assert_allclose(np.triu(fn).T @ np.triu(fn), spd, rtol=1e-12)
    b = rng.normal(size=(N, 2))
    x = xpotrs(f, torch.from_numpy(b), uplo)
    assert_allclose(spd @ x.numpy(), b, rtol=1e-10)
    _same(x, ref.xpotrs(rf, jnp.asarray(b), uplo), 1e-10)


def test_xpotrs_vector_rhs(spd, rng):
    f, _ = xpotrf(torch.from_numpy(spd))
    b = rng.normal(size=(N,))
    x = xpotrs(f, torch.from_numpy(b))
    assert x.shape == (N,)
    assert_allclose(spd @ x.numpy(), b, rtol=1e-10)


def test_xpotrf_not_spd():
    a = -np.eye(4)
    f, info = xpotrf(torch.from_numpy(a))
    rf, rinfo = ref.xpotrf(jnp.asarray(a))
    assert int(info) > 0 and int(info) == int(rinfo)  # ≙ d_info reporting the failing minor
    np.testing.assert_array_equal(f.numpy(), np.asarray(rf))   # NaN below, 0 above


def test_potrf_batched(rng):
    a = rng.normal(size=(3, 8, 8))
    spd = np.einsum("bij,bkj->bik", a, a) + 8 * np.eye(8)
    spd[1] = -np.eye(8)   # one failed member: only its info and factor go bad
    f, info = potrf_batched(torch.from_numpy(spd))
    rf, rinfo = ref.potrf_batched(jnp.asarray(spd))
    np.testing.assert_array_equal(info.numpy(), np.asarray(rinfo))
    assert list(info.numpy()) == [0, 1, 0]
    fn = np.tril(f.numpy())
    for i in (0, 2):
        assert_allclose(fn[i] @ fn[i].T, spd[i], rtol=1e-10)
        _same(f[i], np.asarray(rf)[i])
    np.testing.assert_array_equal(f[1].numpy(), np.asarray(rf)[1])


def test_xgetrf_getrs(gen, rng):
    lu, piv, info = xgetrf(torch.from_numpy(gen))
    rlu, rpiv, rinfo = ref.xgetrf(jnp.asarray(gen))
    assert int(info) == int(rinfo) == 0
    np.testing.assert_array_equal(piv.numpy(), np.asarray(rpiv))
    _same(lu, rlu)
    b = rng.normal(size=(N, 3))
    x = xgetrs(lu, piv, torch.from_numpy(b))
    assert_allclose(gen @ x.numpy(), b, rtol=1e-10)
    _same(x, ref.xgetrs(rlu, rpiv, jnp.asarray(b)), 1e-10)
    xv = xgetrs(lu, piv, torch.from_numpy(b[:, 0]))
    assert xv.shape == (N,)
    assert_allclose(gen @ xv.numpy(), b[:, 0], rtol=1e-10)


def test_xgetrf_nopivot(rng):
    # diagonally dominant → stable without pivoting
    a = rng.normal(size=(12, 12)) + 12 * np.eye(12)
    lu, piv, info = xgetrf(torch.from_numpy(a), pivot=False)
    rlu, rpiv, rinfo = ref.xgetrf(jnp.asarray(a), pivot=False)
    assert int(info) == int(rinfo) == 0
    np.testing.assert_array_equal(piv.numpy(), np.asarray(rpiv))
    _same(lu, rlu)
    lun = lu.numpy()
    l = np.tril(lun, -1) + np.eye(12)
    u = np.triu(lun)
    assert_allclose(l @ u, a, rtol=1e-10)


def test_xgetrf_nopivot_batched(rng):
    a = rng.normal(size=(3, 10, 10)) + 10 * np.eye(10)
    lu, piv, info = xgetrf(torch.from_numpy(a), pivot=False)
    rlu, rpiv, rinfo = ref.xgetrf(jnp.asarray(a), pivot=False)
    np.testing.assert_array_equal(info.numpy(), np.asarray(rinfo))
    np.testing.assert_array_equal(piv.numpy(), np.asarray(rpiv))
    assert piv.shape == (3, 10)
    _same(lu, rlu)


def test_xgeqrf_ormqr(gen, rng):
    q, r, info = xgeqrf(torch.from_numpy(gen))
    rq, rr, rinfo = ref.xgeqrf(jnp.asarray(gen))
    assert int(info) == int(rinfo) == 0 and info.dtype == torch.int32
    qn, rn = q.numpy(), r.numpy()
    assert_allclose(qn @ rn, gen, rtol=1e-10)
    assert_allclose(qn.T @ qn, np.eye(N), rtol=1e-10)
    # the two packages agree up to the signs of R's rows
    s = np.sign(np.diag(rn) / np.diag(np.asarray(rr)))
    _same(r, s[:, None] * np.asarray(rr), 1e-10)
    _same(q, np.asarray(rq) * s, 1e-10)
    c = rng.normal(size=(N, 4))
    qc = xormqr(q, torch.from_numpy(c), "L", "T")
    assert_allclose(qc.numpy(), qn.T @ c, rtol=1e-10)
    _same(qc, s[:, None] * np.asarray(ref.xormqr(rq, jnp.asarray(c), "L", "T")), 1e-10)
    ct = rng.normal(size=(4, N))
    _same(xormqr(q, torch.from_numpy(ct), "R", "N"), ct @ qn)


def test_xorgqr_returns_q(gen):
    q, r, _ = xgeqrf(torch.from_numpy(gen))
    assert xorgqr(q) is q and xorgqr(q, r) is q


@pytest.mark.parametrize("uplo,diag", [("L", "N"), ("U", "N"), ("L", "U")])
def test_xtrtri(gen, uplo, diag):
    t = np.tril(gen) if uplo == "L" else np.triu(gen)
    inv, info = xtrtri(torch.from_numpy(t), uplo, diag)
    rinv, rinfo = ref.xtrtri(jnp.asarray(t), uplo, diag)
    assert int(info) == int(rinfo) == 0
    _same(inv, rinv, 1e-9)
    if diag == "N":
        assert_allclose(inv.numpy() @ t, np.eye(N), rtol=1e-9)


def test_finite_info_matches_reference():
    x = np.ones((2, 5, 5))
    x[0, 3, 1] = np.nan
    x[1, 2, 2] = np.inf
    for diag_only in (False, True):
        got = dense._finite_info(torch.from_numpy(x), diag_only)
        want = ref._finite_info(jnp.asarray(x), diag_only)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _on_card(shape, dtype=torch.float32):
    """A stand-in for a CUDA tensor of this shape: what _use_onelaunch reads."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    return types.SimpleNamespace(is_cuda=True, ndim=t.ndim, dtype=t.dtype, shape=t.shape)


def test_use_onelaunch_bounds():
    # CPU and meta tensors never take the kernel route, at any size
    for n in (256, 2048, 4096):
        assert not dense._use_onelaunch(torch.empty((n, n), device="meta"))
    assert not dense._use_onelaunch(torch.eye(2048))
    # on the card: square 2-D f32, 2048 <= n <= 12288, n % 256 == 0
    for n in (2048, 2304, 4096, 12288):
        assert dense._use_onelaunch(_on_card((n, n)))
    for shape in ((1792, 1792), (12544, 12544), (2100, 2100), (4096, 2048), (2, 4096, 4096)):
        assert not dense._use_onelaunch(_on_card(shape))
    assert not dense._use_onelaunch(_on_card((4096, 4096), torch.float64))


def test_xgeqrf_route_bounds():
    """QR takes the kernel route of the factorizations only up to n = 8192."""
    assert not dense._use_qr_onelaunch(torch.empty((4096, 4096), device="meta"))
    assert not dense._use_qr_onelaunch(torch.eye(2048))
    for n in (2048, 4096, 8192):
        assert dense._use_qr_onelaunch(_on_card((n, n)))
    for shape in ((8448, 8448), (12288, 12288), (1792, 1792), (4096, 2048)):
        assert not dense._use_qr_onelaunch(_on_card(shape))


def test_xgeqrf_takes_the_kernel_route(monkeypatch, rng):
    """On the route, xgeqrf returns qr_onelaunch's (Q, R) with info 0; here
    the route runs the plain drivers (CPU tensors) at n=512."""
    calls = []

    def spy(a):
        calls.append("qr_onelaunch")
        return qr_onelaunch(a)

    monkeypatch.setattr(dense, "_use_onelaunch", lambda a: a.ndim == 2)
    monkeypatch.setattr(dense, "qr_onelaunch", spy)
    a = torch.from_numpy(rng.normal(size=(512, 512)).astype(np.float32))
    q, r, info = xgeqrf(a)
    assert calls == ["qr_onelaunch"] and int(info) == 0
    vr, t = _geqrf_onelaunch_plain(a)
    assert torch.equal(r, torch.triu(vr)) and torch.equal(q, _orgqr_onelaunch_plain(vr, t))
    qn, rn = q.double().numpy(), r.double().numpy()
    assert np.abs(qn @ rn - a.numpy()).max() / np.abs(a.numpy()).max() < 5e-5


def test_drivers_take_the_kernel_route(monkeypatch, rng):
    """On the route, xpotrf and xgetrf(pivot=False) return the one-launch
    factor (transposed for uplo="U") with its info and identity pivots."""
    calls = []

    def spy(fn):
        def run(a):
            calls.append(fn.__name__)
            return fn(a)
        return run

    monkeypatch.setattr(dense, "_use_onelaunch", lambda a: a.ndim == 2)
    monkeypatch.setattr(dense, "potrf_onelaunch", spy(onelaunch.potrf_onelaunch))
    monkeypatch.setattr(dense, "getrf_onelaunch", spy(onelaunch.getrf_onelaunch))
    g = rng.normal(size=(256, 256))
    a = torch.from_numpy(((g @ g.T) / 256 + 4 * np.eye(256)).astype(np.float32))
    l, info = xpotrf(a)
    u, uinfo = xpotrf(a, "U")
    assert int(info) == int(uinfo) == 0
    assert torch.equal(u, l.mT) and torch.all(torch.triu(l, 1) == 0)
    ad = torch.from_numpy((g + np.diag(1.05 * np.abs(g).sum(axis=1))).astype(np.float32))
    lu, piv, linfo = xgetrf(ad, pivot=False)
    assert int(linfo) == 0 and torch.equal(piv, torch.arange(256, dtype=torch.int32))
    assert torch.equal(lu, onelaunch._getrf_onelaunch_plain(ad))
    assert calls == ["potrf_onelaunch", "potrf_onelaunch", "getrf_onelaunch"]
