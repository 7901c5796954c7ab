"""Parity of tpumathlib_torch.solver.onelaunch / blocked with the reference.

- The 128×128 sweeps (``_chol_inv128``, ``_lu128``, ``_inv_unit_lower128``,
  ``_inv_upper128``) against the reference's, called eagerly under
  ``jax.disable_jit()`` (a jitted trace of the unrolled sweep takes minutes
  on the CPU). Tolerance 1e-5 max-scaled: the same f32 steps, with the
  reductions in another order.
- ``potrf_onelaunch`` / ``getrf_onelaunch`` (their plain route on CPU
  tensors) at n=512 against the reference's public CPU path (XLA cholesky,
  the unpivoted ``lax.scan`` elimination) and float64 LAPACK, at the
  reference tests' 5e-5 rel bound (``tests/test_solver_dense.py:343,357``).
- The CUDA branch with the kernel library replaced by a CPU emulation of
  the C entry points, reading the operands through the pointers and leading
  dimensions the wrappers pass.

Inputs are explicit f32 on both sides (the suite turns on jax x64).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.solver import blocked as ref_blocked
from tpumathlib.solver import dense as ref_dense
from tpumathlib.solver import onelaunch as ref_onelaunch
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.dx import cuda_utils, gemm
from tpumathlib_torch.solver import blocked, dense, onelaunch
from test_torch_dx_gemm import _EmulatedLib as _EmulatedGemmLib, _view

torch.set_num_threads(1)

NB = 128


def _spd(rng, n):
    g = rng.normal(size=(n, n))
    return (g @ g.T) / n + 4.0 * np.eye(n)


def _barely_dominant(rng, n):
    """Multipliers O(1): the regime where a wrong inverse order shows."""
    g = rng.normal(size=(n, n))
    return g + np.diag(1.05 * np.abs(g).sum(axis=1))


def _symmetric_dominant(rng, n):
    g = rng.normal(size=(n, n))
    s = (g + g.T) / 2
    return s + np.diag(1.05 * np.abs(s).sum(axis=1))


BLOCKS = {"spd": _spd, "symmetric_dominant": _symmetric_dominant,
          "barely_dominant": _barely_dominant}


def _close(got, want, tol):
    err = max_scaled_err(got, np.asarray(want).astype(np.float64))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


@pytest.mark.parametrize("kind", ["spd", "symmetric_dominant"])
def test_chol_inv128_matches_reference(kind, rng):
    x = BLOCKS[kind](rng, NB).astype(np.float32)
    with jax.disable_jit():
        rl, rw = ref_blocked._chol_inv128(jnp.asarray(x, jnp.float32))
    l, w = blocked._chol_inv128(torch.from_numpy(x))
    assert l.dtype == w.dtype == torch.float32
    _close(l, rl, 1e-5)
    _close(w, rw, 1e-5)
    assert torch.all(torch.triu(l, 1) == 0) and torch.all(torch.triu(w, 1) == 0)
    lw = l.double() @ w.double()
    assert torch.allclose(lw, torch.eye(NB, dtype=torch.float64), atol=1e-5)


@pytest.mark.parametrize("kind", ["barely_dominant", "spd"])
def test_lu_sweeps_match_reference(kind, rng):
    x = BLOCKS[kind](rng, NB).astype(np.float32)
    with jax.disable_jit():
        rlu = ref_onelaunch._lu128(jnp.asarray(x, jnp.float32))
        rwl = ref_onelaunch._inv_unit_lower128(rlu)
        rwu = ref_onelaunch._inv_upper128(rlu)
    lu = onelaunch._lu128(torch.from_numpy(x))
    _close(lu, rlu, 1e-5)
    _close(onelaunch._inv_unit_lower128(lu), rwl, 1e-5)
    _close(onelaunch._inv_upper128(lu), rwu, 1e-5)
    # the fused wrapper gives the three in one call, and they are inverses
    flu, wl, wu = onelaunch._lu_inv128(torch.from_numpy(x))
    assert torch.equal(flu, lu)
    lu64 = lu.double()
    eye = torch.eye(NB, dtype=torch.float64)
    assert torch.allclose(wl.double() @ (torch.tril(lu64, -1) + eye), eye, atol=1e-5)
    assert torch.allclose(wu.double() @ torch.triu(lu64), eye, atol=1e-5)


def test_chol_inv128_not_spd_gives_nonfinite_diagonal(rng):
    x = _spd(rng, NB).astype(np.float32)
    x[40, 40] = -1.0
    l, _ = blocked._chol_inv128(torch.from_numpy(x))
    assert int(dense._finite_info(l, diag_only=True)) == 41
    assert torch.all(torch.isfinite(torch.diagonal(l)[:40]))
    assert torch.all(torch.triu(l, 1) == 0)


def test_potrf_onelaunch_n512(rng):
    n = 512
    a = _spd(rng, n)
    l = onelaunch.potrf_onelaunch(torch.from_numpy(a.astype(np.float32)))
    assert l.dtype == torch.float32 and l.shape == (n, n)
    assert torch.all(torch.triu(l, 1) == 0)
    ln = l.double().numpy()
    lr = np.linalg.cholesky(a)
    assert np.abs(ln - lr).max() / np.abs(lr).max() < 5e-5
    ref, info = ref_dense.xpotrf(jnp.asarray(a, jnp.float32))
    assert int(info) == 0
    ref = np.asarray(ref, np.float64)
    assert np.abs(ln - ref).max() / np.abs(ref).max() < 5e-5


def test_getrf_onelaunch_n512(rng):
    n = 512
    a = _barely_dominant(rng, n)
    lu = onelaunch.getrf_onelaunch(torch.from_numpy(a.astype(np.float32)))
    assert lu.dtype == torch.float32 and lu.shape == (n, n)
    lun = lu.double().numpy()
    lt, ut = np.tril(lun, -1) + np.eye(n), np.triu(lun)
    assert np.abs(lt @ ut - a).max() / np.abs(a).max() < 5e-5
    ref, _, info = ref_dense.xgetrf(jnp.asarray(a, jnp.float32), pivot=False)
    assert int(info) == 0
    ref = np.asarray(ref, np.float64)
    assert np.abs(lun - ref).max() / np.abs(ref).max() < 5e-5


def test_argument_checks():
    with pytest.raises(InvalidValueError):
        onelaunch.potrf_onelaunch(torch.eye(384))
    with pytest.raises(InvalidValueError):
        onelaunch.getrf_onelaunch(torch.eye(256)[:, :128])
    with pytest.raises(InvalidValueError):
        blocked._chol_inv128(torch.eye(64))
    with pytest.raises(InvalidValueError):
        onelaunch._lu_inv128(torch.eye(NB, dtype=torch.float64))


def test_cpu_takes_plain_versions_without_launch(rng):
    counts = (gemm.pallas_matmul, blocked._chol_inv128, onelaunch._lu_inv128,
              onelaunch.potrf_onelaunch, onelaunch.getrf_onelaunch)
    before = [f.launches for f in counts]
    a = torch.from_numpy(_spd(rng, 256).astype(np.float32))
    onelaunch.potrf_onelaunch(a)
    onelaunch.getrf_onelaunch(a)
    assert [f.launches for f in counts] == before


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

def _block(ptr, ld):
    return _view(ptr, torch.float32, (NB, NB), (ld, 1))


class _EmulatedLib(_EmulatedGemmLib):
    """The C entry points' contracts, computed on the CPU from the raw
    arguments: the GEMM's from tests/test_torch_dx_gemm.py, and the block
    sweeps' from their pointers and leading dimensions."""

    def __init__(self):
        super().__init__()
        self.block_calls = []

    def tml_chol_inv_block(self, a, lda, l, ldl, w, ldw, stream):
        self.block_calls.append(("chol", lda))
        gl, gw = blocked._chol_inv128_plain(_block(a, lda).clone())
        _block(l, ldl).copy_(gl)
        _block(w, ldw).copy_(gw)
        return 0

    def tml_lu_inv_block(self, a, lda, lu, ldlu, wl, ldwl, wu, ldwu, stream):
        self.block_calls.append(("lu", lda))
        outs = onelaunch._lu_inv128_plain(_block(a, lda).clone())
        for ptr, ld, t in zip((lu, wl, wu), (ldlu, ldwl, ldwu), outs):
            _block(ptr, ld).copy_(t)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    for mod in (gemm, blocked, onelaunch):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("kind", ["chol", "lu"])
def test_block_kernel_marshalling(emulated, kind, rng):
    """A block that is a view into a wider matrix reaches the entry point
    with its own leading dimension; the launch is counted once."""
    big = torch.from_numpy(_symmetric_dominant(rng, 300).astype(np.float32))
    view = big[7:7 + NB, 7:7 + NB]   # a principal block: SPD
    wrapper, plain = ((blocked._chol_inv128, blocked._chol_inv128_plain) if kind == "chol"
                      else (onelaunch._lu_inv128, onelaunch._lu_inv128_plain))
    before = wrapper.launches
    got = wrapper(view)
    assert wrapper.launches == before + 1
    assert emulated.block_calls == [(kind, 300)]
    for g, w in zip(got, plain(view)):
        assert g.shape == (NB, NB) and torch.equal(g, w)


@pytest.mark.parametrize("kind", ["potrf", "getrf"])
def test_driver_cuda_route_marshalling(emulated, kind, rng):
    """The drivers' CUDA route, with every product and sweep going through
    the emulated entry points, gives the plain route's factor; the counts
    are those of the blocked schedule at n=512 (two panels)."""
    n = 512
    x = _spd(rng, n) if kind == "potrf" else _barely_dominant(rng, n)
    a = torch.from_numpy(x.astype(np.float32))
    driver, block, plain, gemms = (
        (onelaunch.potrf_onelaunch, blocked._chol_inv128, onelaunch._potrf_onelaunch_plain, 6)
        if kind == "potrf" else
        (onelaunch.getrf_onelaunch, onelaunch._lu_inv128, onelaunch._getrf_onelaunch_plain, 11))
    before = (driver.launches, block.launches, gemm.pallas_matmul.launches)
    got = driver(a)
    assert (driver.launches - before[0], block.launches - before[1],
            gemm.pallas_matmul.launches - before[2]) == (1, n // NB, gemms)
    assert len(emulated.calls) == gemms and len(emulated.block_calls) == n // NB
    _close(got, plain(a), 1e-6)
    if kind == "potrf":
        assert torch.all(torch.triu(got, 1) == 0)


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    """For CUDA tensors the wrappers launch or raise, never fall back."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    for mod in (gemm, blocked, onelaunch):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    for fn in (blocked._chol_inv128, onelaunch._lu_inv128):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            fn(torch.eye(NB))
    for fn in (onelaunch.potrf_onelaunch, onelaunch.getrf_onelaunch):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            fn(torch.eye(256))
