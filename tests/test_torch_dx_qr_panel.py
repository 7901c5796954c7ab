"""The panel routes of B7a's geqrf and of B7e (unmqr_batched) in
tpumathlib_torch.dx.solver (csrc/dx_qr_panel.cu), mirrored in numpy, against
the plain versions and the reference's Pallas kernels in interpret mode.

- A numpy model of each kernel in its own order and layout.
  geqrf_panel_kernel (``_model_panel_geqrf``): 32-column panels; each column
  step sums the tail's squares and x_r·a_rc of the later panel columns over
  its rows, each warp's 32 rows by the transposing reduction
  (``_transpose_sums``, equal to a 5-step butterfly bit for bit), the warps
  in order, then w_c = tau_h·(s_c + v_j·a_jc) (the kernel holds a row's
  panel entries shifted a slot a step; each column's arithmetic is the
  same); the trailing columns take the panel's stored reflectors 8 columns
  at a time (each column's arithmetic as 4 at a time), a lane rows p0 + l + 32 q
  (``_model_lane_apply``: its rows summed, then the lanes by
  ``_warp_sums4``). unmqr_panel_kernel stages the reflectors a panel at a
  time and applies them to C's columns, a lane rows l + 32 q
  (``_model_panel_unmqr``). Held to _geqrf_plain / _apply_q_plain at 1e-4
  max-scaled (chip_smoke.py's DX_TOL["geqrf"]) and to the reference's
  geqrf_batched / unmqr_batched at n in {33, 40, 64} and (m, n) in {(65,
  32), (96, 64), (128, 128)} with k in {1, 4, 33} both ways; and to the
  plain versions alone at n in {127, 224} with the residuals Q·R − A and
  QᵀQ − I under 5e-5.
- The degenerate cases at n = 33 and 64: a zero column (tau = 0), x_j = 0
  with a non-zero tail (sign(0) = +1), an upper triangular matrix (QR = A)
  and a NaN matrix beside finite ones (NaN where the plain version has it).
- The route rules and the CUDA branch against the emulated library: each
  route's launch count, and no work space on unmqr's panel route.

Inputs are explicit f32 on both sides: the suite turns on jax x64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.dx import solver as ref
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.interop import from_numpy, to_numpy
from tpumathlib_torch.dx import solver as port
from test_torch_dx_lsq_eig import _butterfly, emulated  # noqa: F401  (emulated: the fixture)
from test_torch_dx_qr_warp import _finite, _grown, _route_counts, _warp_sums4

torch.set_num_threads(1)

TOL = 1e-4   # chip_smoke.py's DX_TOL["geqrf"]: each model against the plain version and the reference
RES = 5e-5   # the residuals' bound (phase 18)
F32 = np.float32
PANEL = 32


def _rng(seed=27):
    return np.random.default_rng(seed)


def _transpose_sums(p):
    """geqrf_panel_kernel's transposing reduction on p (B, warps, 32 lanes,
    32 slots): at each exchange (over lane bits 16, 8, 4, 2, 1) a lane keeps
    the half of its slots its bit selects and adds the partner's. Returns
    (B, warps, 32): lane l's slot 0, the warp's sum of slot l."""
    p = p.copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        hi = ((lanes & off) != 0)[None, None, :]
        for i in range(off):
            keep = np.where(hi, p[..., i + off], p[..., i])
            send = np.where(hi, p[..., i], p[..., i + off])
            p[..., i] = keep + send[:, :, lanes ^ off]
    return p[..., 0]


def _dlarfg(xj, ts):
    """dlarfg as csrc/dx_qr_warp.cuh forms it: (vj, tau_h, tau, degenerate)."""
    f32 = F32
    ss = ts + xj * xj
    degenerate = ts == 0
    sign = np.where(xj > 0, f32(1), np.where(xj < 0, f32(-1), np.where(xj == 0, f32(1), xj)))
    alpha = np.where(degenerate, xj, -sign * np.sqrt(ss))
    vj = xj - alpha
    vsq = np.where(degenerate, f32(0), ts + vj * vj)
    safe = vsq > 0
    tau_h = np.where(safe, f32(2) / np.where(safe, vsq, f32(1)), f32(0))
    return vj, tau_h, np.where(safe, tau_h * vj * vj, f32(0)), degenerate


def _model_lane_apply(v, taus, x, j0, r0, m, trans=True):
    """apply_panel on x (B, 32·R, k), row i of x being row r0 + i (a lane l
    holds rows r0 + l + 32 q): reflector j0 + jj (jj < v.shape[2]) is 1 at
    its row, below it v[:, r, jj] (v (B, m, cnt), rows absolute), tau
    taus[:, jj]; ascending for Qᵀ, descending for Q. Each lane sums its rows
    (q ascending, rows above j and past m take no part), the lanes are added
    by ``_warp_sums4``, then each row below j takes −v·(s·tau). Without the
    kernel's FMAs."""
    bsz, rows, k = x.shape
    nq = rows // 32
    r = r0 + np.arange(rows)
    xs = x.reshape(bsz, nq, 32, k).copy()
    order = range(v.shape[2])
    with np.errstate(invalid="ignore", over="ignore"):
        for jj in (order if trans else reversed(order)):
            j = j0 + jj
            on = ((r >= j) & (r < m)).reshape(nq, 32)
            vr = np.zeros((bsz, rows), F32)
            vr[:, r < m] = v[:, r[r < m], jj]
            vr[:, r == j] = 1
            vr = vr.reshape(bsz, nq, 32)
            s = np.zeros((bsz, 32, k), F32)
            for q in range(nq):
                s = np.where(on[q][:, None], s + vr[:, q, :, None] * xs[:, q], s)
            wq = _warp_sums4(s) * taus[:, jj, None, None]
            xs = np.where(on[None, :, :, None], xs - vr[..., None] * wq[:, None], xs)
    return xs.reshape(bsz, rows, k)


def _model_panel_geqrf(a):
    """geqrf_panel_kernel on f32 A (B, n, n), 32 < n ≤ 224: (QR, taus) as the
    kernel leaves them (see the module docstring). Without the kernel's
    FMAs."""
    bsz, n, _ = a.shape
    np_ = -(-n // 32) * 32
    A = np.zeros((bsz, np_, np_), F32)
    A[:, :n, :n] = a
    taus = np.zeros((bsz, n), F32)
    rows = np.arange(np_)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for p0 in range(0, n, PANEL):
            w0 = p0 // 32
            for jj in range(PANEL):
                j = p0 + jj
                if j >= n:
                    break
                cols = slice(p0, p0 + PANEL)
                tail = (rows > j) & (rows < n)
                x = np.where(tail, A[:, :, j], F32(0))
                prod = np.where(tail[None, :, None] & (np.arange(PANEL) >= jj),
                                x[:, :, None] * A[:, :, cols], F32(0))
                warp_sums = _transpose_sums(prod.reshape(bsz, np_ // 32, 32, PANEL))
                s = np.zeros((bsz, PANEL), F32)
                for w in range(w0, np_ // 32):
                    s = s + warp_sums[:, w]
                xj = A[:, j, j].copy()
                vj, tau_h, tau, degenerate = _dlarfg(xj, s[:, jj])
                vdiv = np.where(vj == 0, F32(1), vj)
                taus[:, j] = tau
                rowj = A[:, j, cols].copy()
                w = tau_h[:, None] * (s + vj[:, None] * rowj)
                upd = ~degenerate
                later = np.arange(PANEL) > jj
                below = A[:, :, cols] - x[:, :, None] * w[:, None, :]
                A[:, :, cols] = np.where(upd[:, None, None] & tail[None, :, None] & later,
                                         below, A[:, :, cols])
                own = rowj - vj[:, None] * w
                A[:, j, cols] = np.where(upd[:, None] & (np.arange(PANEL) >= jj), own, rowj)
                A[:, :, j] = np.where(tail, np.where(degenerate[:, None], F32(0), x) / vdiv[:, None],
                                      A[:, :, j])
            if p0 + PANEL < n:
                c_beg = p0 + PANEL
                c_end = c_beg + -(-(n - c_beg) // 4) * 4
                x = A[:, p0:, c_beg:c_end]
                A[:, p0:, c_beg:c_end] = _model_lane_apply(A[:, :, p0:p0 + PANEL], taus[:, p0:p0 + PANEL],
                                                           x, p0, p0, n)
    return A[:, :n, :n], taus


def _model_panel_unmqr(qr, taus, c, trans):
    """unmqr_panel_kernel on QR (B, m, n), m ≤ 224, and C (B, m, k): all m
    rows of C a lane's (rows l + 32 q), the reflectors a panel of 32 at a
    time in order."""
    bsz, m, n = qr.shape
    steps = min(m, n)
    rows = -(-m // 32) * 32
    x = np.zeros((bsz, rows, c.shape[2]), F32)
    x[:, :m] = c
    panels = range(0, steps, PANEL)
    for p0 in (panels if trans else reversed(panels)):
        cnt = min(PANEL, steps - p0)
        x = _model_lane_apply(qr[:, :, p0:p0 + cnt], taus[:, p0:p0 + cnt], x, p0, 0, m, trans)
    return x[:, :m]


def _close(got, want, sel=slice(None), tol=TOL):
    err = max_scaled_err(np.asarray(got)[sel], np.asarray(want)[sel].astype(np.float64))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


def _residuals(a, qr, taus):
    """(max|Q·R − A| / max|A|, max|QᵀQ − I|) over the batch, float64."""
    bsz, n, _ = a.shape
    q = np.tile(np.eye(n), (bsz, 1, 1))
    rows = np.arange(n)
    for j in reversed(range(n)):
        v = np.where(rows > j, qr[:, :, j], (rows == j).astype(np.float64))
        q -= taus[:, j, None, None] * v[:, :, None] * (v[:, None, :] @ q)
    res = np.abs(q @ np.triu(qr.astype(np.float64)) - a).max() / np.abs(a).max()
    return res, np.abs(q.transpose(0, 2, 1) @ q - np.eye(n)).max()


def _geqrf_cases(n):
    """Six f32 (n, n) matrices: 0 a zero column (x_j = 0, zero tail), 1 x_0
    = 0 with a non-zero tail, 2 upper triangular (every tail zero), 3 a NaN,
    4 and 5 Gaussian."""
    a = _rng().normal(size=(6, n, n)).astype(F32)
    a[0, :, 5] = 0.0
    a[1, 0, 0] = 0.0
    a[2] = np.triu(a[2])
    a[3, n - 1, 4] = np.nan
    return a


def _plain_geqrf(a):
    with np.errstate(invalid="ignore"):
        return tuple(to_numpy(t) for t in port._geqrf_plain(from_numpy(a)))


# ---------------------------------------------------------------------------
# The kernels' sums

@pytest.mark.parametrize("past", [0, 1, 7, 16, 17, 31])
def test_transposing_reduction_is_the_butterfly(past):
    """Lane l ends with slot l's sum over the warp, the bits of a 5-step
    butterfly's, also where the last slots (past the panel) hold zeros."""
    rng = _rng()
    p = (rng.normal(size=(3, 2, 32, 32)) * np.exp(rng.normal(size=(3, 2, 32, 32)) * 4)).astype(F32)
    p[..., PANEL - past:] = 0.0
    got = _transpose_sums(p)
    want = _butterfly(p.reshape(6, 32, 32)).reshape(3, 2, 32, 32)[:, :, 0]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# geqrf_panel_kernel

@pytest.mark.parametrize("n", [33, 40, 64])
def test_geqrf_panel_model_against_the_plain_version_and_the_reference(n):
    a = _geqrf_cases(n)
    qr, taus = _model_panel_geqrf(a)
    qr_p, taus_p = _plain_geqrf(a)
    np.testing.assert_array_equal(np.isnan(qr), np.isnan(qr_p))
    np.testing.assert_array_equal(np.isnan(taus), np.isnan(taus_p))
    good = _finite(qr_p, taus_p)
    assert good.sum() == 5 and not good[3]
    _close(qr, qr_p, good)
    _close(taus, taus_p, good)
    rqr, rtaus = ref.geqrf_batched(jnp.asarray(a[good]))
    _close(qr[good], rqr)
    _close(taus[good], rtaus)


@pytest.mark.parametrize("n", [127, 224])
def test_geqrf_panel_model_wide_against_the_plain_version(n):
    """Past the reference's test sizes: the model against the plain version
    and the float64 residuals of its factors."""
    a = _rng(n).normal(size=(3, n, n)).astype(F32)
    qr, taus = _model_panel_geqrf(a)
    qr_p, taus_p = _plain_geqrf(a)
    _close(qr, qr_p)
    _close(taus, taus_p)
    res, orth = _residuals(a.astype(np.float64), qr, taus)
    assert res < RES and orth < RES, (res, orth)


@pytest.mark.parametrize("n", [33, 64])
def test_geqrf_panel_model_degenerate_columns(n):
    """A zero tail gives tau = 0 and leaves its column as it is (a zero
    column at once; an upper triangular matrix at every step, so QR = A);
    x_j = 0 takes sign +1, so R's entry is −‖x‖; a NaN stays in its matrix,
    where the plain version has it."""
    a = _geqrf_cases(n)
    qr, taus = _model_panel_geqrf(a)
    assert taus[0, 5] == 0.0 and np.array_equal(qr[0, 5:, 5], a[0, 5:, 5])
    np.testing.assert_array_equal(taus[2], 0.0)
    np.testing.assert_array_equal(qr[2], a[2])
    norm = np.sqrt(np.sum(a[1, :, 0].astype(np.float64) ** 2))
    assert qr[1, 0, 0] < 0 and abs(qr[1, 0, 0] + norm) <= 1e-6 * norm
    assert np.isfinite(qr[[0, 1, 2, 4, 5]]).all() and np.isnan(qr[3]).any()
    qr_p, _ = _plain_geqrf(a)
    np.testing.assert_array_equal(np.isnan(qr), np.isnan(qr_p))


# ---------------------------------------------------------------------------
# unmqr_panel_kernel

def _unmqr_cases(m, n, k):
    """Five QR (m, n) from _geqrf_plain, A's column 3 zero in matrix 1 (tau
    = 0: an empty reflector), and C (m, k) with a NaN in matrix 2."""
    rng = _rng()
    a = rng.normal(size=(5, m, n)).astype(F32)
    a[1, :, 3] = 0.0
    qr, taus = (to_numpy(t) for t in port._geqrf_plain(from_numpy(a)))
    c = rng.normal(size=(5, m, k)).astype(F32)
    c[2, m - 1, k - 1] = np.nan
    return qr, taus, c


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("k", [1, 4, 33])
@pytest.mark.parametrize("m, n", [(65, 32), (96, 64), (128, 128)])
def test_unmqr_panel_model_against_the_plain_version_and_the_reference(m, n, k, trans):
    qr, taus, c = _unmqr_cases(m, n, k)
    assert taus[1, 3] == 0.0 and port._unmqr_route(m, n) == "panel"
    x = _model_panel_unmqr(qr, taus, c, trans)
    with np.errstate(invalid="ignore"):
        x_p = to_numpy(port._apply_q_plain(from_numpy(qr), from_numpy(taus), from_numpy(c), trans))
    np.testing.assert_array_equal(np.isnan(x), np.isnan(x_p))
    good = _finite(x_p)
    assert good.sum() == 4 and not good[2]
    _close(x, x_p, good)
    want = ref.unmqr_batched(jnp.asarray(qr[good]), jnp.asarray(taus[good]), jnp.asarray(c[good]),
                             trans=trans)
    _close(x[good], want)


@pytest.mark.parametrize("m, n, k", [(224, 224, 4), (200, 20, 9), (40, 70, 5)])
def test_unmqr_panel_model_edges_against_the_plain_version(m, n, k):
    """The panel route's largest m, a tall QR with one partial panel, and a
    QR with more columns than rows (reflectors past m are empty): Q·(Qᵀ·C)
    = C and both ways equal to the plain version."""
    rng = _rng(m)
    if m >= n:
        qr, taus = (to_numpy(t) for t in port._geqrf_plain(
            from_numpy(rng.normal(size=(3, m, n)).astype(F32))))
    else:
        qr = (0.2 * rng.normal(size=(3, m, n))).astype(F32)
        taus = rng.uniform(0, 2, size=(3, n)).astype(F32)
    c = rng.normal(size=(3, m, k)).astype(F32)
    for trans in (True, False):
        got = _model_panel_unmqr(qr, taus, c, trans)
        _close(got, to_numpy(port._apply_q_plain(from_numpy(qr), from_numpy(taus), from_numpy(c),
                                                 trans)))
    if m >= n:
        back = _model_panel_unmqr(qr, taus, _model_panel_unmqr(qr, taus, c, True), False)
        _close(back, c, tol=1e-5)


# ---------------------------------------------------------------------------
# The rules, and the CUDA branch against the emulated library

def test_panel_routes():
    """geqrf: panels for 32 < n ≤ 224 (the bytes of n = 224 fit a block);
    unmqr: panels for every (m, n) the warp route does not take, to m =
    224, whatever n."""
    assert port._geqrf_panel_bytes(224) <= port.SMEM_MAX < port._geqrf_panel_bytes(256)
    assert [port._geqrf_route(n) for n in (32, 33, 64, 127, 128, 224, 225, 256)] == [
        "warp"] + ["panel"] * 5 + ["block"] * 2
    assert [port._unmqr_route(m, n) for m, n in (
        (64, 32), (64, 33), (65, 1), (65, 32), (128, 128), (200, 20), (40, 70), (224, 300),
        (225, 32), (256, 256))] == ["warp"] + ["panel"] * 7 + ["block"] * 2


@pytest.mark.parametrize("n", [33, 64, 128, 224])
def test_cuda_branch_geqrf_panel(emulated, n):
    """geqrf_batched on the panel route grows ``_geqrf.launches`` and
    ``.panel_launches`` by one and returns the emulated kernel's factors."""
    a = from_numpy(_rng().normal(size=(2, n, n)).astype(F32))
    before = _route_counts(port._geqrf)
    qr, taus = port.geqrf_batched(a)
    assert _route_counts(port._geqrf) == _grown(port._geqrf, before, "panel")
    assert emulated.solver_calls == [dict(kernel="geqrf", batch=2, n=n, route="panel")]
    want = port._geqrf_plain(a)
    assert torch.equal(qr, want[0]) and torch.equal(taus, want[1])


@pytest.mark.parametrize("trans", [True, False])
@pytest.mark.parametrize("m, n, k", [(65, 32, 4), (128, 128, 4), (128, 128, 128), (224, 224, 33)])
def test_cuda_branch_unmqr_panel(emulated, m, n, k, trans):
    """unmqr_batched on the panel route: one launch on ``.panel_launches``,
    no work space, the emulated kernel's Q·C."""
    rng = _rng()
    qr, taus = port._geqrf_plain(from_numpy(rng.normal(size=(2, m, n)).astype(F32)))
    c = from_numpy(rng.normal(size=(2, m, k)).astype(F32))
    before = _route_counts(port._unmqr)
    got = port.unmqr_batched(qr, taus, c, trans)
    assert _route_counts(port._unmqr) == _grown(port._unmqr, before, "panel")
    assert emulated.solver_calls == [dict(kernel="unmqr", batch=2, m=m, n=n, k=k, work=False,
                                          trans=int(trans), route="panel")]
    assert torch.equal(got, port._apply_q_plain(qr, taus, c, trans))
