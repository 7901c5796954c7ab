"""Parity of tpumathlib_torch.solver.qr_onelaunch with the reference.

- The block step (``_qr_block128``: CholeskyQR2 + Householder
  reconstruction) and ``_t_from_v`` against the reference's, called eagerly
  under ``jax.disable_jit()`` (a jitted trace of the unrolled sweeps takes
  minutes on the CPU), on a seeded Gaussian block of 256 rows at j0 = 0 and
  j0 = 128. Tolerance 1e-5 max-scaled: the same f32 steps, with the
  reductions in another order.
- ``geqrf_onelaunch`` / ``orgqr_onelaunch`` / ``qr_onelaunch`` (their plain
  route on CPU tensors) at n=512 on the reference test's input
  (``tests/test_solver_dense.py:372-381``): its bounds, the reference's
  public CPU path (XLA qr) and float64 LAPACK up to the signs of R's rows,
  and the float64 product of the reflectors built from (vr, t).
- The CUDA branch with the kernel library replaced by a CPU emulation of
  the C entry points, reading the operands through the pointers and leading
  dimensions the wrappers pass.

Inputs are explicit f32 on both sides (the suite turns on jax x64).
"""

import contextlib
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.solver import dense as ref_dense
from tpumathlib.solver import onelaunch as ref_onelaunch
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.dx import cuda_utils, gemm
from tpumathlib_torch.solver import blocked, onelaunch
from test_torch_dx_gemm import _view
from test_torch_solver_onelaunch import _EmulatedLib as _EmulatedSolverLib, _block

# the packages export functions of the same names as these modules
ref_qr = importlib.import_module("tpumathlib.solver.qr_onelaunch")
qr = importlib.import_module("tpumathlib_torch.solver.qr_onelaunch")

torch.set_num_threads(1)

NB = 128
N = 512   # the reference test's size


def _close(got, want, tol):
    err = max_scaled_err(got, np.asarray(want).astype(np.float64))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


def _block_input(rng, j0):
    """A seeded Gaussian (256, 128) block with the rows above j0 zeroed, and
    the reference's E1 selector for it."""
    bm = rng.normal(size=(2 * NB, NB)).astype(np.float32)
    bm[:j0] = 0.0
    e1 = np.zeros((2 * NB, NB), np.float32)
    e1[j0 + np.arange(NB), np.arange(NB)] = 1.0
    return bm, e1


def _masked(v, j0):
    """The reference's vm: v below the diagonal of the block, unit diagonal."""
    rows, lanes = np.arange(v.shape[0])[:, None], np.arange(NB)[None, :]
    return (np.where(rows > j0 + lanes, v, 0.0) + (rows == j0 + lanes)).astype(np.float32)


@pytest.mark.parametrize("j0", [0, NB])
def test_qr_block128_matches_reference(j0, rng):
    bm, e1 = _block_input(rng, j0)
    with jax.disable_jit():
        rv, rv1, rrd = ref_qr._qr_block128(jnp.asarray(bm), jnp.asarray(e1))
        rvm = _masked(np.asarray(rv), j0)
        rt = ref_qr._t_from_v(jnp.asarray(rvm))
    v, v1, rd = qr._qr_block128(torch.from_numpy(bm), j0)
    assert v.shape == (2 * NB, NB) and v.dtype == v1.dtype == rd.dtype == torch.float32
    assert torch.all(v[:j0] == 0)
    _close(v, rv, 1e-5)
    _close(v1, rv1, 1e-5)
    _close(rd, rrd, 1e-5)
    t = qr._t_from_v(torch.from_numpy(rvm))
    _close(t, rt, 1e-5)
    # H = I − V T Vᵀ is orthogonal and maps the block to the stored D·R rows
    vm = torch.from_numpy(_masked(v.numpy(), j0)).double()
    h = torch.eye(2 * NB, dtype=torch.float64) - vm @ qr._t_from_v(vm.float()).double() @ vm.T
    assert torch.allclose(h.T @ h, torch.eye(2 * NB, dtype=torch.float64), atol=1e-5)
    hb = h.T @ torch.from_numpy(bm).double()
    assert torch.allclose(hb[j0:j0 + NB], rd.double(), atol=1e-5 * rd.abs().max())
    off = torch.cat((hb[:j0], hb[j0 + NB:]))   # zero off the block's diagonal rows
    assert off.abs().max() < 1e-5 * rd.abs().max()


def test_hh_recon128_is_the_reconstruction(rng):
    """(v1, d, inv(M)) of an orthonormal basis block satisfy
    E − Qtop·D = unit_lower(v1)·M with |M_jj| ≥ 1 and d = ±1."""
    q, _ = np.linalg.qr(rng.normal(size=(2 * NB, NB)))
    qtop = torch.from_numpy(q[:NB].astype(np.float32))
    v1, d, minv = qr._hh_recon128(qtop)
    assert torch.all(torch.triu(v1) == 0) and torch.all(torch.tril(minv, -1) == 0)
    assert set(d.tolist()) <= {-1.0, 1.0}
    m = torch.linalg.inv(minv.double())
    assert torch.all(torch.diagonal(m).abs() >= 1 - 1e-6)
    lhs = torch.eye(NB, dtype=torch.float64) - qtop.double() * d.double()
    rhs = (v1.double() + torch.eye(NB, dtype=torch.float64)) @ m
    assert torch.allclose(lhs, rhs, atol=1e-5)


def test_inv_upper128_matches_reference(rng):
    """The upper-triangular T⁻¹ of _t_from_v through the plain sweep and the
    wrapper (CPU: the plain sweep) against the reference's."""
    bm, _ = _block_input(rng, 0)
    v, _, _ = qr._qr_block128(torch.from_numpy(bm), 0)
    vm = torch.from_numpy(_masked(v.numpy(), 0))
    s = vm.T @ vm
    tinv = torch.triu(s, 1) + torch.diag(0.5 * torch.diagonal(s))
    with jax.disable_jit():
        want = ref_onelaunch._inv_upper128(jnp.asarray(tinv.numpy()))
    _close(onelaunch._inv_upper128_plain(tinv), want, 1e-5)
    assert torch.equal(onelaunch._inv_upper128(tinv), onelaunch._inv_upper128_plain(tinv))


def _row_signs(r, r_ref):
    return np.sign(np.diag(r) / np.diag(r_ref))


def test_qr_onelaunch_n512(rng):
    a = rng.normal(size=(N, N)).astype(np.float32)
    q, r = qr.qr_onelaunch(torch.from_numpy(a))
    assert q.dtype == r.dtype == torch.float32 and q.shape == r.shape == (N, N)
    qn, rn = q.double().numpy(), r.double().numpy()
    assert np.abs(qn @ rn - a).max() / np.abs(a).max() < 5e-5
    assert np.abs(qn.T @ qn - np.eye(N)).max() < 5e-5
    assert np.abs(np.tril(rn, -1)).max() == 0.0
    # the reference's public CPU path (XLA qr) and LAPACK, up to row signs of R
    rq, rr, info = ref_dense.xgeqrf(jnp.asarray(a, jnp.float32))
    assert int(info) == 0
    lq, lr = np.linalg.qr(a.astype(np.float64))
    for q_ref, r_ref in ((np.asarray(rq, np.float64), np.asarray(rr, np.float64)), (lq, lr)):
        s = _row_signs(rn, r_ref)
        assert np.abs(rn - s[:, None] * r_ref).max() / np.abs(r_ref).max() < 5e-5
        assert np.abs(qn - q_ref * s).max() < 5e-5


def test_geqrf_orgqr_n512_against_reflectors_f64(rng):
    """orgqr's Q is the product of the H_kb = I − V T Vᵀ stored in (vr, t),
    formed in float64; t holds upper-triangular panel blocks."""
    a = rng.normal(size=(N, N)).astype(np.float32)
    vr, t = qr.geqrf_onelaunch(torch.from_numpy(a))
    assert vr.shape == (N, N) and t.shape == (N, 256)
    q = qr.orgqr_onelaunch(vr, t)
    vrn, tn = vr.double().numpy(), t.double().numpy()
    want = np.eye(N)
    for k0 in range(0, N, 256):
        v = np.zeros((N, 256))
        v[k0:] = vrn[k0:, k0:k0 + 256]
        v[k0:k0 + 256] = np.tril(v[k0:k0 + 256], -1) + np.eye(256)
        tk = tn[k0:k0 + 256]
        assert np.all(np.tril(tk, -1) == 0)
        want = want @ (np.eye(N) - v @ tk @ v.T)
    _close(q, want, 1e-5)
    assert torch.equal(torch.triu(vr), qr.qr_onelaunch(torch.from_numpy(a))[1])


def test_argument_checks():
    with pytest.raises(InvalidValueError):
        qr.geqrf_onelaunch(torch.eye(384))
    with pytest.raises(InvalidValueError):
        qr.orgqr_onelaunch(torch.eye(256), torch.zeros(256, 128))
    with pytest.raises(InvalidValueError):
        qr._hh_recon128(torch.eye(64))
    with pytest.raises(InvalidValueError):
        onelaunch._inv_upper128(torch.eye(NB, dtype=torch.float64))


_COUNTS = (gemm.pallas_matmul, blocked._chol_inv128, qr._hh_recon128, onelaunch._inv_upper128,
           qr.geqrf_onelaunch, qr.orgqr_onelaunch)


def test_cpu_takes_plain_versions_without_launch(rng):
    before = [f.launches for f in _COUNTS]
    q, r = qr.qr_onelaunch(torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32)))
    assert [f.launches for f in _COUNTS] == before


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

class _EmulatedLib(_EmulatedSolverLib):
    """Adds the contracts of qr_block.cu's entry points."""

    def tml_hh_recon_block(self, q, ldq, v1, ldv1, minv, ldm, d, stream):
        self.block_calls.append(("hh_recon", ldq))
        gv1, gd, gminv = qr._hh_recon128_plain(_block(q, ldq).clone())
        _block(v1, ldv1).copy_(gv1)
        _block(minv, ldm).copy_(gminv)
        _view(d, torch.float32, (NB,), (1,)).copy_(gd)
        return 0

    def tml_inv_upper_block(self, a, lda, w, ldw, stream):
        self.block_calls.append(("inv_upper", lda))
        _block(w, ldw).copy_(onelaunch._inv_upper128_plain(_block(a, lda).clone()))
        return 0


_MODULES = (gemm, blocked, onelaunch, qr)


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    for mod in _MODULES:
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("kind", ["hh_recon", "inv_upper"])
def test_block_kernel_marshalling(emulated, kind, rng):
    """A block that is a view into a wider matrix reaches the entry point
    with its own leading dimension; the launch is counted once."""
    big = np.linalg.qr(rng.normal(size=(300, 300)))[0].astype(np.float32)
    view = torch.from_numpy(big)[7:7 + NB, 7:7 + NB]
    if kind == "hh_recon":
        wrapper, plain = qr._hh_recon128, qr._hh_recon128_plain
    else:
        view.diagonal().add_(4.0)   # a well-conditioned upper triangle
        wrapper, plain = onelaunch._inv_upper128, onelaunch._inv_upper128_plain
    before = wrapper.launches
    got = wrapper(view)
    assert wrapper.launches == before + 1
    assert emulated.block_calls == [(kind, 300)]
    want = plain(view)
    if kind == "inv_upper":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_driver_cuda_route_marshalling(emulated, rng):
    """geqrf and orgqr on the CUDA route, with every product and sweep going
    through the emulated entry points, give the plain route's (vr, t) and Q;
    the counts are those of the schedule at n=512 (two panels): per panel
    7 products for each block, 3 for block 1's update and 3 for t01, and 3
    for the trailing update of the first panel; 3 per panel in orgqr."""
    a = torch.from_numpy(rng.normal(size=(N, N)).astype(np.float32))
    before = [f.launches for f in _COUNTS]
    vr, t = qr.geqrf_onelaunch(a)
    grew = [f.launches - b for f, b in zip(_COUNTS, before)]
    assert grew == [43, 8, 4, 4, 1, 0]
    assert len(emulated.calls) == 43 and len(emulated.block_calls) == 16
    # G = BᵀB of the first block reaches B1 as a batch of four 128-row chunks
    assert emulated.calls[0]["shape"] == (4, NB, NB, NB)
    want_vr, want_t = qr._geqrf_onelaunch_plain(a)
    _close(vr, want_vr.numpy(), 1e-6)
    _close(t, want_t.numpy(), 1e-6)
    before = [f.launches for f in _COUNTS]
    q = qr.orgqr_onelaunch(want_vr, want_t)
    assert [f.launches - b for f, b in zip(_COUNTS, before)] == [6, 0, 0, 0, 0, 1]
    _close(q, qr._orgqr_onelaunch_plain(want_vr, want_t).numpy(), 1e-6)
    before = [f.launches for f in _COUNTS]
    qr.qr_onelaunch(a)
    assert [f.launches - b for f, b in zip(_COUNTS, before)] == [49, 8, 4, 4, 1, 1]


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    """For CUDA tensors the wrappers launch or raise, never fall back."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    for mod in _MODULES:
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    for fn in (qr._hh_recon128, onelaunch._inv_upper128):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            fn(torch.eye(NB))
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        qr._qr_block128(torch.eye(2 * NB, NB), 0)
    for fn, args in ((qr.geqrf_onelaunch, (torch.eye(256),)),
                     (qr.qr_onelaunch, (torch.eye(256),)),
                     (qr.orgqr_onelaunch, (torch.eye(256), torch.zeros(256, 256)))):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            fn(*args)
