"""The warp routes of B7a's geqrf and of B7e (unmqr_batched) in
tpumathlib_torch.dx.solver (csrc/dx_qr_warp.cu), mirrored in numpy, against
the plain versions and the reference's Pallas kernels in interpret mode.

- A numpy model of each kernel in its own order and layout: geqrf_warp_kernel
  is gels's QR core (``_model_warp_qr`` of tests/test_torch_dx_lsq_eig.py:
  a column a lane, four partial sums by row mod 4, v read from the warp's
  slice), unmqr_warp_kernel the reflectors' application of gels's B loop
  (``_model_warp_apply``: a lane rows r and r + 32, its rows summed, then
  the lanes) with the kernel's transposing reduction (``_warp_sums4``),
  which equals the 5-step butterfly bit for bit. Both models are held to
  _geqrf_plain / _apply_q_plain and to the reference's geqrf_batched /
  unmqr_batched at 1e-5 max-scaled, at the routes' edges: n in {1, 8, 31,
  32}; (m, n) in {(32, 32), (33, 32), (64, 32), (24, 10)} with k in {1, 4,
  5, 32} and both ways.
- The degenerate cases: a zero column (x_j = 0 and a zero tail: tau = 0),
  x_j = 0 with a non-zero tail (sign(0) = +1), an upper triangular matrix
  (every tail zero: tau = 0 and QR = A), and a NaN matrix beside finite
  ones (NaN where the plain version has it).
- The route rules, and the CUDA branch against the emulated library: each
  route's launch count, and no work space on unmqr's warp route.

Inputs are explicit f32 on both sides: the suite turns on jax x64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.dx import solver as ref
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError
from tpumathlib_torch.core.interop import from_numpy, to_numpy
from tpumathlib_torch.dx import solver as port
from test_torch_dx_lsq_eig import (_butterfly, _model_warp_apply, _model_warp_qr,
                                   emulated)  # noqa: F401  (emulated: the fixture)

torch.set_num_threads(1)

TOL = 1e-5   # each model against the plain version and the reference, max-scaled
F32 = np.float32


def _rng(seed=26):
    return np.random.default_rng(seed)


def _model_warp_geqrf(a):
    """geqrf_warp_kernel on f32 A (B, n, n), n ≤ 32: gels's QR core, then
    the stored QR (R, and v_r / v_j below the diagonal) and tau."""
    n = a.shape[-1]
    col, taus = _model_warp_qr(a)
    return col[:, :n, :n].transpose(0, 2, 1).copy(), taus


def _warp_sums4(s):
    """unmqr_warp_kernel's warp_sums4 on each 4 columns of s (B, 32 lanes,
    k): half of the four sums exchanged over lane bit 16, half of the rest
    over bit 8, a butterfly over 4, 2 and 1, then the sums handed back over
    8 and 16. Every lane ends with each column's sum."""
    bsz, _, k = s.shape
    g = -(-k // 4)
    x = np.zeros((bsz, 32, g, 4), F32)
    x.reshape(bsz, 32, 4 * g)[:, :, :k] = s
    lanes = np.arange(32)
    h = ((lanes & 16) != 0)[None, :, None]
    b = ((lanes & 8) != 0)[None, :, None]

    def xor(v, off):
        return v[:, lanes ^ off]

    s0, s1, s2, s3 = (x[..., i] for i in range(4))
    k0 = np.where(h, s2, s0) + xor(np.where(h, s0, s2), 16)
    k1 = np.where(h, s3, s1) + xor(np.where(h, s1, s3), 16)
    w = np.where(b, k1, k0) + xor(np.where(b, k0, k1), 8)   # column 2 h + b
    for off in (4, 2, 1):
        w = w + xor(w, off)
    o = xor(w, 8)
    p0, p1 = np.where(b, o, w), np.where(b, w, o)
    q0, q1 = xor(p0, 16), xor(p1, 16)
    out = np.stack([np.where(h, q0, p0), np.where(h, q1, p1), np.where(h, p0, q0),
                    np.where(h, p1, q1)], axis=-1)
    return out.reshape(bsz, 32, 4 * g)[:, :, :k]


def _model_warp_unmqr(qr, taus, c, trans):
    """unmqr_warp_kernel on QR (B, m, n), m ≤ 64, n ≤ 32, and C (B, m, k)."""
    return _model_warp_apply(qr, taus, c, trans, sums=_warp_sums4)


def _finite(*ts):
    """The matrices (batch indices) finite in every one of ts."""
    ok = np.ones(ts[0].shape[0], bool)
    for t in ts:
        ok &= np.isfinite(np.asarray(t)).reshape(t.shape[0], -1).all(axis=1)
    return ok


def _close(got, want, sel):
    err = max_scaled_err(np.asarray(got)[sel], np.asarray(want)[sel].astype(np.float64))
    assert err <= TOL, f"max-scaled err {err:.3e} > {TOL:g}"


def _geqrf_cases(n):
    """Six f32 (n, n) matrices: 0 a zero column (x_j = 0, zero tail), 1 x_0
    = 0 with a non-zero tail, 2 upper triangular (every tail zero), 3 a NaN,
    4 and 5 Gaussian."""
    a = _rng().normal(size=(6, n, n)).astype(F32)
    a[0, :, min(5, n - 1)] = 0.0
    a[1, 0, 0] = 0.0
    a[2] = np.triu(a[2])
    a[3, n - 1, min(4, n - 1)] = np.nan
    return a


# ---------------------------------------------------------------------------
# geqrf_warp_kernel

@pytest.mark.parametrize("n", [1, 8, 31, 32])
def test_geqrf_warp_model_against_the_plain_version_and_the_reference(n):
    a = _geqrf_cases(n)
    qr, taus = _model_warp_geqrf(a)
    with np.errstate(invalid="ignore"):
        qr_p, taus_p = (to_numpy(t) for t in port._geqrf_plain(from_numpy(a)))
    np.testing.assert_array_equal(np.isnan(qr), np.isnan(qr_p))
    np.testing.assert_array_equal(np.isnan(taus), np.isnan(taus_p))
    good = _finite(qr_p, taus_p)
    assert good.sum() == 5 and not good[3]
    _close(qr, qr_p, good)
    _close(taus, taus_p, good)
    rqr, rtaus = ref.geqrf_batched(jnp.asarray(a[good]))
    _close(qr[good], rqr, slice(None))
    _close(taus[good], rtaus, slice(None))


@pytest.mark.parametrize("n", [1, 8, 31, 32])
def test_geqrf_warp_model_degenerate_columns(n):
    """A zero tail gives tau = 0 and leaves its column as it is (a zero
    column at once; an upper triangular matrix at every step, so QR = A);
    x_j = 0 takes sign +1, so R's entry is −‖x‖."""
    a = _geqrf_cases(n)
    qr, taus = _model_warp_geqrf(a)
    j = min(5, n - 1)
    assert taus[0, j] == 0.0 and np.array_equal(qr[0, j:, j], a[0, j:, j])
    np.testing.assert_array_equal(taus[2], 0.0)
    np.testing.assert_array_equal(qr[2], a[2])
    if n > 1:
        norm = np.sqrt(np.sum(a[1, :, 0].astype(np.float64) ** 2))
        assert qr[1, 0, 0] < 0 and abs(qr[1, 0, 0] + norm) <= 1e-6 * norm
    assert np.isfinite(qr[[0, 1, 2, 4, 5]]).all()


# ---------------------------------------------------------------------------
# unmqr_warp_kernel

def test_transposing_reduction_is_the_butterfly():
    """warp_sums4's exchanges give every lane each column's sum, and the
    same bits as four 5-step butterflies: each sum takes the butterfly's tree,
    and an addition does not depend on its operands' order."""
    rng = _rng()
    for k in (1, 4, 5, 32):
        s = (rng.normal(size=(7, 32, k)) * np.exp(rng.normal(size=(7, 32, k)) * 4)).astype(F32)
        got, want = _warp_sums4(s), _butterfly(s)
        np.testing.assert_array_equal(got, want)
        assert (got == got[:, :1]).all()


def _unmqr_cases(m, n, k):
    """Five QR (m, n) from _geqrf_plain, A's column 3 zero in matrix 1 (tau
    = 0: an empty reflector), and C (m, k) with a NaN in matrix 2."""
    rng = _rng()
    a = rng.normal(size=(5, m, n)).astype(F32)
    a[1, :, min(3, n - 1)] = 0.0
    qr, taus = (to_numpy(t) for t in port._geqrf_plain(from_numpy(a)))
    c = rng.normal(size=(5, m, k)).astype(F32)
    c[2, m - 1, k - 1] = np.nan
    return qr, taus, c


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("k", [1, 4, 5, 32])
@pytest.mark.parametrize("m, n", [(32, 32), (33, 32), (64, 32), (24, 10)])
def test_unmqr_warp_model_against_the_plain_version_and_the_reference(m, n, k, trans):
    qr, taus, c = _unmqr_cases(m, n, k)
    assert taus[1, min(3, n - 1)] == 0.0
    x = _model_warp_unmqr(qr, taus, c, trans)
    with np.errstate(invalid="ignore"):
        x_p = to_numpy(port._apply_q_plain(from_numpy(qr), from_numpy(taus), from_numpy(c), trans))
    np.testing.assert_array_equal(np.isnan(x), np.isnan(x_p))
    good = _finite(x_p)
    assert good.sum() == 4 and not good[2]
    _close(x, x_p, good)
    want = ref.unmqr_batched(jnp.asarray(qr[good]), jnp.asarray(taus[good]), jnp.asarray(c[good]),
                             trans=trans)
    _close(x[good], want, slice(None))


# ---------------------------------------------------------------------------
# The rules, and the CUDA branch against the emulated library

def test_geqrf_and_unmqr_routes():
    """geqrf: a warp a matrix to n = 32, panels to 224 (n = 33 and 128 on
    the panel route since it came), a block beyond; unmqr: a warp a matrix
    for m ≤ 64, n ≤ 32, panels to m = 224 whatever n, a block beyond."""
    assert [port._geqrf_route(n) for n in (1, 8, 31, 32, 33, 128)] == [
        "warp", "warp", "warp", "warp", "panel", "panel"]
    assert [port._unmqr_route(m, n) for m, n in (
        (1, 1), (24, 10), (32, 32), (33, 32), (64, 32), (64, 1), (65, 32), (64, 33), (65, 1),
        (300, 200))] == ["warp"] * 6 + ["panel"] * 3 + ["block"]


def _route_counts(wrapper):
    return (wrapper.launches, wrapper.warp_launches, wrapper.panel_launches,
            wrapper.block_launches)


def _grown(wrapper, before, route):
    """The route counts of ``wrapper`` after one launch on ``route``."""
    return (before[0] + 1,) + tuple(b + (r == route) for b, r in zip(
        before[1:], ("warp", "panel", "block")))


@pytest.mark.parametrize("n", [8, 31, 32, 33, 48, 224, 225])
def test_cuda_branch_geqrf_counts_its_route(emulated, n):
    a = from_numpy(_rng().normal(size=(3, n, n)).astype(F32))
    before = _route_counts(port._geqrf)
    qr, taus = port.geqrf_batched(a)
    route = port._geqrf_route(n)
    assert _route_counts(port._geqrf) == _grown(port._geqrf, before, route)
    assert emulated.solver_calls == [dict(kernel="geqrf", batch=3, n=n, route=route)]
    want = port._geqrf_plain(a)
    assert torch.equal(qr, want[0]) and torch.equal(taus, want[1])


@pytest.mark.parametrize("m, n, k", [(32, 32, 4), (64, 32, 32), (64, 32, 33), (24, 10, 5),
                                     (65, 32, 4), (64, 33, 4), (64, 32, 1000), (224, 224, 200),
                                     (225, 32, 4), (240, 240, 200)])
def test_cuda_branch_unmqr_counts_its_route(emulated, m, n, k):
    """Each launch grows ``_unmqr.launches`` and its route's count; the warp
    and panel routes take any k and no work space, even where the block route
    would need one (k = 1000 at m = 64, k = 200 at m = 224)."""
    rng = _rng()
    qr, taus = port._geqrf_plain(from_numpy(rng.normal(size=(2, m, n)).astype(F32)))
    c = from_numpy(rng.normal(size=(2, m, k)).astype(F32))
    before = _route_counts(port._unmqr)
    got = port.unmqr_batched(qr, taus, c, trans=k % 2 == 0)
    route = port._unmqr_route(m, n)
    assert _route_counts(port._unmqr) == _grown(port._unmqr, before, route)
    call = emulated.solver_calls[-1]
    assert call["route"] == route
    assert call["work"] is (route == "block" and port._smem_bytes(n, k, m) > port.SMEM_MAX)
    assert torch.equal(got, port._apply_q_plain(qr, taus, c, trans=k % 2 == 0))


def test_cuda_branch_route_counts_hold_on_launch_failure(emulated):
    emulated.rc = 9   # cudaErrorInvalidConfiguration
    a = torch.ones((2, 8, 8))
    before = _route_counts(port._geqrf), _route_counts(port._unmqr)
    with pytest.raises(ExecutionError, match="tml_geqrf_batched: CUDA error 9"):
        port.geqrf_batched(a)
    with pytest.raises(ExecutionError, match="tml_unmqr_batched: CUDA error 9"):
        port.unmqr_batched(a, a[:, 0], a)
    assert (_route_counts(port._geqrf), _route_counts(port._unmqr)) == before
