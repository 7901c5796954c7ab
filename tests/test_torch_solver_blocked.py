"""Parity of tpumathlib_torch.solver.potrf_blocked (kernel B4c) with the
reference and LAPACK.

- ``potrf_blocked`` (its plain route on CPU tensors, and its CUDA route on an
  emulated kernel library) at (n, panel) = (256, 128), (384, 256) and
  (512, 384), the last with a short last panel, against float64
  ``np.linalg.cholesky`` at the reference test's 5e-5 max-relative
  (tests/test_solver_dense.py:318), with the strict upper triangle exactly 0.
- The diagonal sweeps it runs, against the reference's ``_chol_inv128``
  called eagerly under ``jax.disable_jit()`` on the same blocks (1e-5
  max-scaled: the same f32 steps, reductions in another order).
- C19 pinned: a panel that is not a multiple of 128 is refused (the
  reference sweeps only whole 128-blocks of a panel and leaves the rest
  unfactored, with no error).
- A non-SPD matrix gives non-finite values from its failing block on.
- The CUDA branch with the kernel library replaced by the CPU emulation of
  tests/test_torch_solver_onelaunch.py (B1 and the block sweeps from their
  raw arguments): the launch counts of the blocked schedule (n = 4096 at
  panel 256 gives 32 sweeps and 62 products), the plain version never
  called, a failed sweep raising.
- Gated by TPUMATHLIB_TEST_SLOW, as the reference's own test: the port
  against the reference's ``potrf_blocked`` in interpret mode at n = 256,
  panel 128 (minutes on one CPU core).

Inputs are explicit f32 on both sides (the suite turns on jax x64).
"""

import contextlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.solver import blocked as ref_blocked
from tpumathlib_torch import solver
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.dx import gemm
from tpumathlib_torch.solver import blocked
from test_torch_solver_onelaunch import _EmulatedLib as _EmulatedSolverLib
from test_torch_solver_onelaunch import emulated  # noqa: F401  (the emulated-library fixture)

torch.set_num_threads(1)

NB = 128
CASES = [(256, 128), (384, 256), (512, 384)]


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _spd(rng, n):
    g = rng.normal(size=(n, n))
    return (g @ g.T) / n + 4.0 * np.eye(n)


def _max_rel(l, a):
    lr = np.linalg.cholesky(a)
    return np.abs(np.asarray(l, np.float64) - lr).max() / np.abs(lr).max()


def _schedule(n, panel):
    """(sweeps, products) of one call: a sweep per 128-block; a trsm under
    every block but the last; an in-panel update after every block that is
    not its panel's last; a trailing syrk after every panel but the last."""
    widths = [min(panel, n - s) for s in range(0, n, panel)]
    return n // NB, (n // NB - 1) + sum(w // NB - 1 for w in widths) + (len(widths) - 1)


@pytest.mark.parametrize("n, panel", CASES)
def test_potrf_blocked_against_lapack(rng, n, panel):
    a = _spd(rng, n)
    l = solver.potrf_blocked(torch.from_numpy(a.astype(np.float32)), panel=panel)
    assert l.dtype == torch.float32 and l.shape == (n, n)
    assert _max_rel(l, a) < 5e-5
    assert torch.all(torch.triu(l, 1) == 0)


def test_default_panel_is_256(rng):
    a = torch.from_numpy(_spd(rng, 512).astype(np.float32))
    assert torch.equal(blocked.potrf_blocked(a), blocked.potrf_blocked(a, 256))


def test_sweeps_match_the_references(rng):
    """Record the diagonal blocks potrf_blocked hands its sweep at (256, 128)
    and run the reference's sweep on the same blocks."""
    a = torch.from_numpy(_spd(rng, 256).astype(np.float32))
    seen = []

    def sweep(d):
        out = blocked._chol_inv128_plain(d)
        seen.append((d.clone(), out))
        return out

    l = blocked._potrf_blocked(a, 128, blocked._mm_f32, sweep)
    assert len(seen) == 2
    for d, (pl, pw) in seen:
        with jax.disable_jit():
            rl, rw = ref_blocked._chol_inv128(jnp.asarray(d.numpy(), jnp.float32))
        assert max_scaled_err(pl, np.asarray(rl)) <= 1e-5
        assert max_scaled_err(pw, np.asarray(rw)) <= 1e-5
    assert torch.equal(l[:128, :128], seen[0][1][0])


@pytest.mark.parametrize("panel", [192, 64, 0, -128])
def test_panel_not_a_multiple_of_128_is_refused_c19(panel):
    """ROADMAP C19: the reference factors only whole 128-blocks of a panel
    and returns a finite, wrong L (1.26 max-relative at n = 256, panel =
    192); the port refuses such a panel."""
    with pytest.raises(InvalidValueError, match="panel must be a positive multiple of 128"):
        blocked.potrf_blocked(torch.eye(256), panel)


@pytest.mark.parametrize("shape", [(200, 200), (256, 128), (2, 128, 128)])
def test_shape_is_checked(shape):
    with pytest.raises(InvalidValueError, match="a square matrix with n % 128 == 0"):
        blocked.potrf_blocked(torch.zeros(shape))


def test_not_spd_is_non_finite_from_the_failing_block_on(rng):
    a = _spd(rng, 512).astype(np.float32)
    a[300, 300] = -1.0
    l = blocked.potrf_blocked(torch.from_numpy(a))
    assert torch.all(torch.isfinite(l[:, :256]))
    assert not torch.any(torch.isfinite(torch.diagonal(l)[300:]))
    assert torch.all(torch.triu(l, 1) == 0)


# ---------------------------------------------------------------------------
# The CUDA branch against the emulated kernel library

class _FailingLib(_EmulatedSolverLib):
    def tml_chol_inv_block(self, a, lda, l, ldl, w, ldw, stream):
        return 7

    def tml_error_string(self, rc):
        return b"emulated failure"


@pytest.mark.parametrize("n, panel", CASES + [(4096, 256)])
def test_schedule(n, panel):
    assert _schedule(n, panel) == {(256, 128): (2, 2), (384, 256): (3, 4), (512, 384): (4, 6),
                                   (4096, 256): (32, 62)}[(n, panel)]


@pytest.mark.parametrize("n, panel", CASES)
def test_cuda_branch(emulated, monkeypatch, rng, n, panel):  # noqa: F811
    a = torch.from_numpy(_spd(rng, n).astype(np.float32))
    want = blocked._potrf_blocked_plain(a, panel)

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on the CUDA branch")

    monkeypatch.setattr(blocked, "_potrf_blocked_plain", no_plain)
    before = (blocked.potrf_blocked.launches, blocked._chol_inv128.launches,
              gemm.pallas_matmul.launches)
    got = blocked.potrf_blocked(a, panel)
    sweeps, products = _schedule(n, panel)
    assert (blocked.potrf_blocked.launches - before[0], blocked._chol_inv128.launches - before[1],
            gemm.pallas_matmul.launches - before[2]) == (1, sweeps, products)
    assert len(emulated.block_calls) == sweeps and len(emulated.calls) == products
    assert all(kind == "chol" and ld == n for kind, ld in emulated.block_calls)
    assert max_scaled_err(got, want) <= 1e-6
    assert _max_rel(got, a.double().numpy()) < 5e-5
    assert torch.all(torch.triu(got, 1) == 0)


def test_cuda_branch_raises_on_a_failed_sweep(monkeypatch):
    lib = _FailingLib()
    monkeypatch.setattr("tpumathlib_torch.dx.cuda_utils.load_kernels", lambda: lib)
    monkeypatch.setattr(blocked, "on_cuda", lambda *t: True)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    before = blocked.potrf_blocked.launches
    with pytest.raises(ExecutionError, match="tml_chol_inv_block: CUDA error 7"):
        blocked.potrf_blocked(torch.eye(256) * 4.0)
    assert blocked.potrf_blocked.launches == before


def test_cpu_takes_the_plain_version_without_launch(rng):
    a = torch.from_numpy(_spd(rng, 256).astype(np.float32))
    before = (blocked.potrf_blocked.launches, blocked._chol_inv128.launches,
              gemm.pallas_matmul.launches)
    blocked.potrf_blocked(a, 128)
    assert (blocked.potrf_blocked.launches, blocked._chol_inv128.launches,
            gemm.pallas_matmul.launches) == before


# ---------------------------------------------------------------------------
# Gated: against the reference's panel kernel in interpret mode

@pytest.mark.skipif(not os.environ.get("TPUMATHLIB_TEST_SLOW"),
                    reason="the reference's unrolled panel kernel takes minutes in interpret "
                           "mode on the CPU (as tests/test_solver_dense.py:300-322)")
def test_against_the_references_panel_kernel(rng):
    a = _spd(rng, 256)
    ref = np.asarray(ref_blocked.potrf_blocked(jnp.asarray(a, jnp.float32), panel=128))
    got = solver.potrf_blocked(torch.from_numpy(a.astype(np.float32)), panel=128)
    assert max_scaled_err(got, ref) <= 1e-5
    assert _max_rel(got, a) < 5e-5 and _max_rel(ref, a) < 5e-5
