"""Parity of tpumathlib_torch.mp.pblas (the eight row-sharded PBLAS ops; no
kernel) with the reference, distributed against single-device.

The reference runs on the 8-device virtual CPU mesh of tests/conftest.py,
the port on eight CPU ranks, both on the same seeded numpy inputs at
tests/test_mp_pblas.py's shapes (M, K, N = 64, 40, 24). Every op's result
is held to the reference's at rtol 1e-4, max-scaled (core.check.allclose),
and to numpy float64 at the bounds of tests/test_mp_pblas.py. The
reference's ``mp_trsm`` takes about 24 s a case on the 8-device mesh, so it
runs for one case; every trsm case is held to
``scipy.linalg.solve_triangular`` in float64. The reference runs each op
for one of its parameter cases (a few seconds each); the port runs every
case. Results are (x, None) Sharded; the triangle masks come from each
rank's global row offset.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax

from tpumathlib.mp.grid import Grid as RefGrid
from tpumathlib.mp import pblas as ref
from tpumathlib_torch import mp
from tpumathlib_torch.core.check import assert_allclose

torch.set_num_threads(1)

M, K, N = 64, 40, 24   # tests/test_mp_pblas.py's shapes; M divisible by 8 ranks
RTOL = 1e-4            # against the reference, max-scaled
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def ref_grid():
    return RefGrid.create(jax.devices())


@pytest.fixture(scope="module")
def grid():
    return mp.Grid.create(CPU8)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _tri_np(a, uplo, unit=False):
    t = np.tril(a) if uplo == "lower" else np.triu(a)
    if unit:
        np.fill_diagonal(t, 1.0)
    return t


def _check(got, want, rtol, atol, ref_out=None):
    """The port's result: row-sharded, against float64 at the reference
    test's bound, and against the reference's result at RTOL."""
    assert got.spec == ("x", None) and got.shape == want.shape
    full = got.full().numpy()
    np.testing.assert_allclose(full, want, rtol=rtol, atol=atol)
    if ref_out is not None:
        assert_allclose(full, np.asarray(ref_out), rtol=RTOL, msg="vs reference")


@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_mp_syrk_syr2k_syrkx(ref_grid, grid, rng, uplo):
    a, b = rng.normal(size=(M, K)).astype(np.float32), rng.normal(size=(M, K)).astype(np.float32)
    c = rng.normal(size=(M, M)).astype(np.float32)
    an, bn, cn = (v.astype(np.float64) for v in (a, b, c))
    inside = (np.tril if uplo == "lower" else np.triu)(np.ones((M, M))) > 0
    with_ref = uplo == "lower"

    want = np.where(inside, 2.0 * an @ an.T + 0.5 * cn, cn)
    _check(mp.mp_syrk(a, c, grid, alpha=2.0, beta=0.5, uplo=uplo), want, 2e-5, 2e-5,
           ref.mp_syrk(a, c, ref_grid, alpha=2.0, beta=0.5, uplo=uplo) if with_ref else None)
    want = np.where(inside, 1.5 * (an @ bn.T + bn @ an.T) + 0.5 * cn, cn)
    _check(mp.mp_syr2k(a, b, c, grid, alpha=1.5, beta=0.5, uplo=uplo), want, 2e-5, 2e-5,
           ref.mp_syr2k(a, b, c, ref_grid, alpha=1.5, beta=0.5, uplo=uplo) if with_ref else None)
    want = np.where(inside, 1.5 * an @ bn.T + 0.5 * cn, cn)
    _check(mp.mp_syrkx(a, b, c, grid, alpha=1.5, beta=0.5, uplo=uplo), want, 2e-5, 2e-5,
           ref.mp_syrkx(a, b, c, ref_grid, alpha=1.5, beta=0.5, uplo=uplo) if with_ref else None)


@pytest.mark.parametrize("uplo", ["lower", "upper"])
def test_mp_symm(ref_grid, grid, rng, uplo):
    a, b, c = (rng.normal(size=s).astype(np.float32) for s in ((M, M), (M, N), (M, N)))
    t = _tri_np(a.astype(np.float64), uplo)
    sym = t + t.T - np.diag(np.diag(t))
    ref_out = ref.mp_symm(a, b, c, ref_grid, alpha=2.0, beta=-1.0, uplo=uplo) \
        if uplo == "upper" else None
    _check(mp.mp_symm(a, b, c, grid, alpha=2.0, beta=-1.0, uplo=uplo),
           2.0 * sym @ b - c, 2e-5, 2e-4, ref_out)


@pytest.mark.parametrize("uplo,trans,unit", [
    ("lower", False, False), ("upper", False, True), ("lower", True, False),
    ("upper", True, True)])
def test_mp_trmm(ref_grid, grid, rng, uplo, trans, unit):
    a, b = rng.normal(size=(M, M)).astype(np.float32), rng.normal(size=(M, N)).astype(np.float32)
    t = _tri_np(a.astype(np.float64), uplo, unit)
    op = t.T if trans else t
    ref_out = ref.mp_trmm(a, b, ref_grid, alpha=1.5, uplo=uplo, trans=trans, unit=unit) \
        if (uplo, trans, unit) == ("lower", True, False) else None
    _check(mp.mp_trmm(a, b, grid, alpha=1.5, uplo=uplo, trans=trans, unit=unit),
           1.5 * op @ b, 2e-5, 2e-4, ref_out)


def _trsm_case(rng, uplo, unit):
    a = rng.normal(size=(M, M)).astype(np.float32)
    a = a + M * np.eye(M, dtype=np.float32) * np.sign(np.diag(a) + 0.1)
    b = rng.normal(size=(M, N)).astype(np.float32)
    t = _tri_np(a.astype(np.float64), uplo, unit)
    return a, b, scipy.linalg.solve_triangular(t, 2.0 * b, lower=uplo == "lower",
                                               unit_diagonal=unit)


@pytest.mark.parametrize("uplo,unit", [("lower", False), ("upper", False), ("lower", True),
                                       ("upper", True)])
def test_mp_trsm(grid, rng, uplo, unit):
    """Block substitution over the ranks against scipy in float64, at
    tests/test_mp_pblas.py's bound."""
    a, b, want = _trsm_case(rng, uplo, unit)
    _check(mp.mp_trsm(a, b, grid, alpha=2.0, uplo=uplo, unit=unit), want, 5e-4, 5e-4)


def test_mp_trsm_matches_the_reference(ref_grid, grid, rng):
    """One case through the reference's mp_trsm (about 24 s on the mesh)."""
    a, b, want = _trsm_case(rng, "upper", False)
    ref_out = ref.mp_trsm(a, b, ref_grid, alpha=2.0, uplo="upper")
    _check(mp.mp_trsm(a, b, grid, alpha=2.0, uplo="upper"), want, 5e-4, 5e-4, ref_out)


@pytest.mark.parametrize("trans", [False, True])
def test_mp_geadd_tradd(ref_grid, grid, rng, trans):
    a, c = rng.normal(size=(M, M)).astype(np.float32), rng.normal(size=(M, M)).astype(np.float32)
    an, cn = a.astype(np.float64), c.astype(np.float64)
    op = an.T if trans else an
    with_ref = trans
    _check(mp.mp_geadd(a, c, grid, alpha=2.0, beta=0.5, trans=trans), 2.0 * op + 0.5 * cn,
           1e-6, 0, ref.mp_geadd(a, c, ref_grid, alpha=2.0, beta=0.5, trans=trans)
           if with_ref else None)
    for uplo in ("upper", "lower"):
        inside = (np.triu if uplo == "upper" else np.tril)(np.ones((M, M))) > 0
        ref_out = ref.mp_tradd(a, c, ref_grid, alpha=2.0, beta=0.5, trans=trans, uplo=uplo) \
            if with_ref and uplo == "upper" else None
        _check(mp.mp_tradd(a, c, grid, alpha=2.0, beta=0.5, trans=trans, uplo=uplo),
               np.where(inside, 2.0 * op + 0.5 * cn, cn), 1e-6, 0, ref_out)


def test_sharded_operands_and_other_grids(rng):
    """Operands handed over as Sharded with another spec are resharded to
    (x, None) first; the ops run at P = 1, 2 and 4 as at 8."""
    a = rng.normal(size=(M, K)).astype(np.float32)
    c = rng.normal(size=(M, M)).astype(np.float32)
    want = np.where(np.tril(np.ones((M, M))) > 0, a.astype(np.float64) @ a.T, c)
    for nr in (1, 2, 4):
        g = mp.Grid.create([torch.device("cpu")] * nr)
        _check(mp.mp_syrk(g.shard(a, (None, None)), g.shard(c, (None, "x")), g), want,
               2e-5, 2e-5)
