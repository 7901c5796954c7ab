"""Parity of tpumathlib_torch.blas.level3 (and the level2 helpers it uses)
with tpumathlib.blas.level3: all 16 ops on the same seeded numpy inputs.

Tolerances (max-scaled): f32 1e-5; f64 and c128 1e-12 (the same f64
products, another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.blas import level2 as ref_level2
from tpumathlib.blas import level3 as ref
from tpumathlib_torch.blas import level2, level3
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.dx import gemm

torch.set_num_threads(1)

M, N, K = 24, 20, 16


def _t(x, dtype=None):
    x = np.asarray(x) if dtype is None else np.asarray(x).astype(dtype)
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, tol):
    err = max_scaled_err(got, np.asarray(want))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


@pytest.fixture
def abc(rng):
    return (rng.normal(size=(M, K)), rng.normal(size=(K, N)), rng.normal(size=(M, N)))


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("transa,transb", [("N", "N"), ("T", "N"), ("N", "T"), ("T", "T")])
def test_gemm_trans(abc, transa, transb, backend, rng):
    a, b, c = abc
    at = a if transa == "N" else rng.normal(size=(K, M))
    bt = b if transb == "N" else rng.normal(size=(N, K))
    (ja, ta), (jb, tb), (jc, tc) = (_t(x, np.float32) for x in (at, bt, c))
    want = ref.gemm(1.2, ja, jb, 0.7, jc, transa, transb, backend=backend)
    before = gemm.pallas_matmul.launches
    got = level3.gemm(1.2, ta, tb, 0.7, tc, transa, transb, backend=backend)
    assert got.dtype == torch.float32 and gemm.pallas_matmul.launches == before
    _close(got, want, 1e-5)


def test_gemm_conj(rng):
    a = rng.normal(size=(K, M)) + 1j * rng.normal(size=(K, M))
    b = rng.normal(size=(K, N)) + 1j * rng.normal(size=(K, N))
    (ja, ta), (jb, tb) = _t(a), _t(b)
    _close(level3.gemm(1.0, ta, tb, transa="C"), ref.gemm(1.0, ja, jb, transa="C"), 1e-12)


def test_gemm3m(rng):
    a = (rng.normal(size=(M, K)) + 1j * rng.normal(size=(M, K))).astype(np.complex64)
    b = (rng.normal(size=(K, N)) + 1j * rng.normal(size=(K, N))).astype(np.complex64)
    (ja, ta), (jb, tb) = _t(a), _t(b)
    got = level3.gemm3m(1.0, ta, tb)
    assert got.dtype == torch.complex64
    _close(got, ref.gemm3m(1.0, ja, jb), 1e-5)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_gemm_batched_and_strided(rng, backend):
    (ja, ta), (jb, tb) = _t(rng.normal(size=(4, M, K)), np.float32), \
        _t(rng.normal(size=(4, K, N)), np.float32)
    want = ref.gemm_strided_batched(1.0, ja, jb)
    _close(level3.gemm_strided_batched(1.0, ta, tb), want, 1e-5)
    _close(level3.gemm_batched(1.0, list(ta), list(tb), 0.0, None), want, 1e-5)
    _close(level3.gemm(1.0, ta, tb, backend=backend), want, 1e-5)


def test_gemm_pallas_broadcast_b(rng):
    """A batched A against one B: the port broadcasts B by stride 0."""
    (ja, ta), (jb, tb) = _t(rng.normal(size=(3, M, K)), np.float32), \
        _t(rng.normal(size=(1, K, N)), np.float32)
    _close(level3.gemm(0.5, ta, tb, backend="pallas"),
           ref.gemm(0.5, ja, jb, backend="pallas"), 1e-5)


def test_gemm_grouped(rng):
    shapes = [(8, 6, 4), (16, 12, 10)]
    pairs = [(_t(rng.normal(size=(m, k)), np.float32), _t(rng.normal(size=(k, n)), np.float32))
             for m, n, k in shapes]
    want = ref.gemm_grouped_batched([1.0, 2.0], [p[0][0] for p in pairs],
                                    [p[1][0] for p in pairs])
    got = level3.gemm_grouped_batched([1.0, 2.0], [p[0][1] for p in pairs],
                                      [p[1][1] for p in pairs])
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_level2_helpers(rng, uplo):
    a = rng.normal(size=(6, 6)) + 1j * rng.normal(size=(6, 6))
    ja, ta = _t(a)
    _close(level2.sym_full(ta, uplo), ref_level2.sym_full(ja, uplo), 0)
    _close(level2.herm_full(ta, uplo), ref_level2.herm_full(ja, uplo), 0)
    for diag in ("N", "U"):
        _close(level2.tri_full(ta, uplo, diag), ref_level2.tri_full(ja, uplo, diag), 0)
    for trans in ("N", "T", "C"):
        _close(level2._op(ta, trans), ref_level2._op(ja, trans), 0)


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_symm_hemm(rng, side, uplo):
    n = 10
    (ja, ta), (jb, tb) = _t(rng.normal(size=(n, n))), _t(rng.normal(size=(n, n)))
    (jc, tc) = _t(rng.normal(size=(n, n)))
    _close(level3.symm(1.0, ta, tb, 0.5, tc, side=side, uplo=uplo),
           ref.symm(1.0, ja, jb, 0.5, jc, side=side, uplo=uplo), 1e-12)
    az = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    bz = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    (jaz, taz), (jbz, tbz) = _t(az), _t(bz)
    _close(level3.hemm(1.0, taz, tbz, side=side, uplo=uplo),
           ref.hemm(1.0, jaz, jbz, side=side, uplo=uplo), 1e-12)


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "T"])
def test_syrk_family(rng, uplo, trans):
    n, k = 10, 6
    shape = (n, k) if trans == "N" else (k, n)
    (ja, ta), (jb, tb) = _t(rng.normal(size=shape)), _t(rng.normal(size=shape))
    jc, tc = _t(rng.normal(size=(n, n)))
    _close(level3.syrk(1.5, ta, 0.5, tc, uplo, trans), ref.syrk(1.5, ja, 0.5, jc, uplo, trans),
           1e-12)
    _close(level3.syrk(1.5, ta, uplo=uplo, trans=trans),
           ref.syrk(1.5, ja, uplo=uplo, trans=trans), 1e-12)
    _close(level3.syr2k(1.5, ta, tb, 0.5, tc, uplo, trans),
           ref.syr2k(1.5, ja, jb, 0.5, jc, uplo, trans), 1e-12)
    _close(level3.syrkx(1.5, ta, tb, 0.5, tc, uplo, trans),
           ref.syrkx(1.5, ja, jb, 0.5, jc, uplo, trans), 1e-12)


@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("trans", ["N", "C"])
def test_herk_family(rng, uplo, trans):
    n, k = 8, 5
    shape = (n, k) if trans == "N" else (k, n)
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    b = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    c0 = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    (ja, ta), (jb, tb), (jc, tc) = _t(a), _t(b), _t((c0 + c0.conj().T) / 2)
    _close(level3.herk(1.5, ta, 0.5, tc, uplo, trans), ref.herk(1.5, ja, 0.5, jc, uplo, trans),
           1e-12)
    alpha = 0.3 + 0.7j
    _close(level3.her2k(alpha, ta, tb, 0.5, tc, uplo, trans),
           ref.her2k(alpha, ja, jb, 0.5, jc, uplo, trans), 1e-12)
    _close(level3.herkx(alpha, ta, tb, 0.5, tc, uplo, trans),
           ref.herkx(alpha, ja, jb, 0.5, jc, uplo, trans), 1e-12)


@pytest.mark.parametrize("side", ["L", "R"])
@pytest.mark.parametrize("uplo", ["L", "U"])
@pytest.mark.parametrize("transa", ["N", "T", "C"])
@pytest.mark.parametrize("diag", ["N", "U"])
def test_trmm_trsm(rng, side, uplo, transa, diag):
    n = 10
    a = rng.normal(size=(n, n)) + 5 * np.eye(n)
    a = a + (0.5j * rng.normal(size=(n, n)) if transa == "C" else 0)
    (ja, ta), (jb, tb) = _t(a), _t(rng.normal(size=(n, n)) + 0 * a[:1])
    _close(level3.trmm(2.0, ta, tb, side, uplo, transa, diag),
           ref.trmm(2.0, ja, jb, side, uplo, transa, diag), 1e-12)
    _close(level3.trsm(2.0, ta, tb, side, uplo, transa, diag),
           ref.trsm(2.0, ja, jb, side, uplo, transa, diag), 1e-12)


def test_trsm_batched(rng):
    n = 8
    a = rng.normal(size=(3, n, n)) + 5 * np.eye(n)
    (ja, ta), (jb, tb) = _t(np.tril(a)), _t(rng.normal(size=(3, n, n)))
    _close(level3.trsm_batched(1.0, ta, tb), ref.trsm_batched(1.0, ja, jb), 1e-12)
