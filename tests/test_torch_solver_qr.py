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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.solver import dense as ref_dense
from tpumathlib.solver import onelaunch as ref_onelaunch
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.dx import cuda_utils, gemm, tf32x3
from tpumathlib_torch.solver import blocked, onelaunch
from test_torch_dx_gemm import _view
from test_torch_solver_onelaunch import (_EmulatedLib as _EmulatedSolverLib, _Event, _Stream,
                                         _block)

# the packages export functions of the same names as these modules
ref_qr = importlib.import_module("tpumathlib.solver.qr_onelaunch")
qr = importlib.import_module("tpumathlib_torch.solver.qr_onelaunch")

torch.set_num_threads(1)

NB = 128
N = 512   # the reference test's size


def _close(got, want, tol):
    err = max_scaled_err(got, np.asarray(want).astype(np.float64))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


def _mm_b1(a, b, c=None, *, alpha: float = 1.0, beta: float = 0.0):
    """B1's f32 products as the emulation computes them on the route that
    ``gemm._into_route`` gives: the SIMT kernel's f32 product, or the
    3xTF32 plain model of A's planes and Bᵀ's."""
    (m, k), n = a.shape, b.shape[1]
    if gemm._into_route(m, n, k) == "simt":
        return onelaunch._mm_plain(a, b, c, alpha=alpha, beta=beta)
    return tf32x3._gemm_tf32x3_plain(*tf32x3._split_tf32_plain(a),
                                     *tf32x3._split_tf32_plain(b, transpose=True), c,
                                     alpha=alpha, beta=beta)


def _geqrf_b1(a):
    """geqrf_onelaunch's schedule on the plain sweeps and Gram products with
    B1's products on their routes: the device route's arithmetic, so that
    the emulated device route stays within 1e-6 of it (the QR's
    conditioning carries the 3xTF32 rounding to some 1e-5 of an
    all-f32 route's)."""
    return qr._geqrf(a, qr._plain_ops()._replace(mm=_mm_b1))


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


# geqrf_onelaunch's TF32 splits at n = 512 with every B1 product on the 3xTF32
# route: the B of each of its 31 products and the A of its 7 with a transposed A
SPLITS_N = 38
_COUNTS = (gemm.pallas_matmul, blocked._chol_inv128, qr._hh_recon128, onelaunch._inv_upper128,
           qr.geqrf_onelaunch, qr.orgqr_onelaunch, qr._gram_tn, tf32x3.split_tf32,
           tf32x3.gemm_tf32x3)


def test_cpu_takes_plain_versions_without_launch(rng):
    before = [f.launches for f in _COUNTS]
    q, r = qr.qr_onelaunch(torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32)))
    assert [f.launches for f in _COUNTS] == before


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

def _gram_operand(ptr, ld, top, ldt, top_rows, k, cols):
    """tml_gram_tn's operand: rows below top_rows from top, the rest from ptr."""
    parts = [_view(top, torch.float32, (top_rows, cols), (ldt, 1))] if top_rows else []
    if k > top_rows:
        parts.append(_view(ptr + 4 * top_rows * ld, torch.float32, (k - top_rows, cols), (ld, 1)))
    return torch.cat(parts).clone()


def _gram_refused(k, m, n, flags, ncounters, ptrs, lds, tops):
    """What tml_gram_tn's entry refuses (cudaErrorInvalidValue)."""
    tiles = (m // 64) * (n // 64)
    return (k < 128 or k % 128 or m < 64 or m % 64 or n < 64 or n % 64
            or any(t < 0 or t > k or t % 128 for t in tops)
            or any(p % 16 for p in ptrs) or any(ld % 4 for ld in lds)
            or (flags & 2 and (m != n or ncounters < tiles + 1)))


class _EmulatedLib(_EmulatedSolverLib):
    """Adds the contracts of qr_block.cu's and qr_gram.cu's entry points
    (gemm_tf32x3.cu's come with B1's emulation, tests/test_torch_dx_gemm.py)."""

    def __init__(self):
        super().__init__()
        self.gram_calls = []

    def tml_gram_tn(self, x, ldx, xt, ldxt, xtop, y, ldy, yt, ldyt, ytop, c, ldc, d, ldd, k, m,
                    n, alpha, beta, ridge, flags, work, work_tiles, counters, ncounters, stream):
        """D = alpha·XᵀY + beta·C with XᵀY the two-level chunk sum (the plain
        version's), then the flags: 1 halves the diagonal, 2 adds ridge·tr
        + 1e-30 to it."""
        self.gram_calls.append(dict(k=k, m=m, n=n, flags=flags, tops=(xtop, ytop), c=bool(c),
                                    stream=stream))
        ptrs = [p for p in (x, y, d, c, xt if xtop else 0, yt if ytop else 0) if p]
        lds = [ld for ld, p in ((ldx, x), (ldy, y), (ldd, d), (ldc, c), (ldxt, xtop),
                                (ldyt, ytop)) if p]
        if _gram_refused(k, m, n, flags, ncounters, ptrs, lds, (xtop, ytop)):
            return 1
        acc = alpha * qr._gram_tn_plain(_gram_operand(x, ldx, xt, ldxt, xtop, k, m),
                                        _gram_operand(y, ldy, yt, ldyt, ytop, k, n))
        if c:
            acc = acc + beta * _view(c, torch.float32, (m, n), (ldc, 1))
        if flags & 1:
            acc.diagonal().mul_(0.5)
        if flags & 2:
            acc.diagonal().add_(ridge * acc.diagonal().sum() + 1e-30)
        _view(d, torch.float32, (m, n), (ldd, 1)).copy_(acc)
        return 0

    def tml_hh_recon_block(self, q, ldq, v1, ldv1, minv, ldm, d, stream):
        self.block_calls.append(("hh_recon", ldq))
        self.block_streams.append(stream)
        gv1, gd, gminv = qr._hh_recon128_plain(_block(q, ldq).clone())
        _block(v1, ldv1).copy_(gv1)
        _block(minv, ldm).copy_(gminv)
        _view(d, torch.float32, (NB,), (1,)).copy_(gd)
        return 0

    def tml_inv_upper_block(self, a, lda, w, ldw, stream):
        self.block_calls.append(("inv_upper", lda))
        self.block_streams.append(stream)
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
    monkeypatch.setattr(_Stream, "made", 0)
    main = _Stream()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: main)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    lib.caller = main
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


@pytest.mark.parametrize("rule", ["size rule", "all 3xTF32"])
def test_driver_cuda_route_marshalling(emulated, monkeypatch, rule, rng):
    """geqrf and orgqr on the CUDA route, with every product and sweep going
    through the emulated entry points, give the plain route's (vr, t) and Q;
    the counts are those of the schedule at n=512 (two panels). Per panel:
    each block 3 Gram products on the chain (G with the ridge, Q1ᵀQ1, VᵀV
    with the halved diagonal), 4 B1 (Q1, Q, V, D·R over V1), 2 Cholesky
    sweeps, the reconstruction and inv_upper; on the aux stream the Gram
    products V0ᵀ·C (block 1's update), V0ᵀV1 and, but for the last panel,
    Vᵀ·C of the next panel's columns; block 1's update 3 B1 (W, then V's top
    and its rows below), t01 2; and the first panel's update of the next
    panel 5 B1 (W, then the top and the rows below of each 128 columns, the
    second on the aux stream). No columns lie past the next panel at n = 512.
    orgqr (its device route): one split a call, then a Gram, a B1, a split
    and a 3xTF32 product a panel. By the size rule every B1 product here is
    SIMT's (K ≤ 256, one wave of tiles); with all on B1's 3xTF32 route each
    splits its B, and A where A is a transposed view (SPLITS_N in geqrf, one
    more a panel in orgqr). The result is held to the plain schedule with
    B1's products on those routes (``_geqrf_b1``)."""
    tc = rule == "all 3xTF32"
    if tc:
        monkeypatch.setattr(gemm, "_into_route", lambda m, n, k: "tf32x3")
    a = torch.from_numpy(rng.normal(size=(N, N)).astype(np.float32))
    before = [f.launches for f in _COUNTS]
    vr, t = qr.geqrf_onelaunch(a)
    grew = [f.launches - b for f, b in zip(_COUNTS, before)]
    assert grew == [31, 8, 4, 4, 1, 0, 17, SPLITS_N * tc, 0]
    assert len(emulated.calls) == 31 and len(emulated.block_calls) == 16
    # streams: the caller's 0, then the chain 1 and the aux 2 (high priority), the side 3
    streams = [c["stream"] for c in emulated.gram_calls]
    assert streams.count(2) == 5 and streams.count(1) == 12
    assert emulated.gemm_streams.count(2) == 2 and set(emulated.gemm_streams) == {1, 2}
    assert set(emulated.block_streams) == {1}
    assert emulated.caller.waits == [1]
    # G = BᵀB of the first block: K = 512 rows, the ridge added in the kernel
    assert emulated.gram_calls[0] == dict(k=N, m=NB, n=NB, flags=2, tops=(0, 0), c=False,
                                          stream=1)
    assert emulated.gram_calls[3] == dict(k=N, m=NB, n=NB, flags=1, tops=(NB, NB), c=False,
                                          stream=1)
    want_vr, want_t = _geqrf_b1(a)
    _close(vr, want_vr.numpy(), 1e-6)
    _close(t, want_t.numpy(), 1e-6)
    before = [f.launches for f in _COUNTS]
    q = qr.orgqr_onelaunch(want_vr, want_t)
    assert [f.launches - b for f, b in zip(_COUNTS, before)] == [2, 0, 0, 0, 0, 1, 2,
                                                                 3 + 2 * tc, 2]
    _close(q, qr._orgqr_onelaunch_plain(want_vr, want_t).numpy(), 1e-6)
    before = [f.launches for f in _COUNTS]
    qr.qr_onelaunch(a)
    assert [f.launches - b for f, b in zip(_COUNTS, before)] == [33, 8, 4, 4, 1, 1, 19,
                                                                 (SPLITS_N + 2) * tc + 3, 2]


@pytest.mark.parametrize("n", [256, 768, 1024])
def test_driver_look_ahead_streams(emulated, monkeypatch, rng, n):
    """The columns past the next panel take their update on the side stream:
    after each panel but the last two, a Gram and 3 B1 there (none at n =
    256, one panel; one update at 768, two at 1024); the result is the plain
    route's. Every B1 product on the 3xTF32 route: the side's pieces fall
    on either side of the size rule where the plain schedule's whole
    products do not."""
    monkeypatch.setattr(gemm, "_into_route", lambda m, n, k: "tf32x3")
    a = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    vr, t = qr.geqrf_onelaunch(a)
    side = [c for c in emulated.gram_calls if c["stream"] == 3]
    assert [c["n"] for c in side] == list(range(n - 512, 0, -256))
    assert emulated.gemm_streams.count(3) == 3 * len(side)
    want_vr, want_t = _geqrf_b1(a)
    _close(vr, want_vr.numpy(), 1e-6)
    _close(t, want_t.numpy(), 1e-6)


@pytest.mark.parametrize("n", [512, 1024])
def test_orgqr_device_route(emulated, rng, n):
    """orgqr_onelaunch's device route (``_DeviceOrgqr``) on the emulated
    library equals ``_orgqr``'s plain route at 1e-6 and keeps Q
    orthogonal; on the caller's stream it splits all of vr once (unit
    lower), then per panel, from the last down, launches G = Vpᵀ·C (the
    Gram kernel, Vp's unit-lower top from scratch as the split operand), W
    = T·G (B1), the planes of Wᵀ (transposed), and C −= Vp·W in place
    (3xTF32 on vr's planes at row and column k0, α = −1, β = 1, C = D, Q's
    own rows)."""
    a = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    vr, t = qr._geqrf_onelaunch_plain(a)
    for lst in (emulated.calls, emulated.gram_calls, emulated.gemm_streams):
        lst.clear()
    emulated.tf32_calls = []
    before = [f.launches for f in _COUNTS]
    q = qr.orgqr_onelaunch(vr, t)
    panels = n // 256
    # W = T·G of a panel of rows n − k0 on the 3xTF32 route splits its B, G
    w_tc = [gemm._into_route(256, n - k0, 256) == "tf32x3" for k0 in range(n - 256, -1, -256)]
    assert [f.launches - b for f, b in zip(_COUNTS, before)] == [
        panels, 0, 0, 0, 0, 1, panels, panels + 1 + sum(w_tc), panels]
    _close(q, qr._orgqr_onelaunch_plain(vr, t).numpy(), 1e-6)
    assert float((q.double().mT @ q.double() - torch.eye(n, dtype=torch.float64)).abs().max()) < 1e-5
    main = emulated.caller.cuda_stream
    assert {c["stream"] for c in emulated.gram_calls + emulated.tf32_calls} == {main}
    assert set(emulated.gemm_streams) == {main}
    assert [c["k"] for c in emulated.gram_calls] == [n - k0 for k0 in range(n - 256, -1, -256)]
    assert all(c["tops"] == (256, 0) for c in emulated.gram_calls)
    splits = [c for c in emulated.tf32_calls if c["kind"] == "split"]
    # vr once; then a panel's Wᵀ (and G, W = T·G's B, where W takes 3xTF32), transposed
    assert [c["flags"] for c in splits] == [tf32x3.UNIT_LOWER] + [tf32x3.TRANSPOSE] * (
        panels + sum(w_tc))
    assert splits[0]["shape"] == (n, n) and all(c["ld"][0] == n for c in splits)   # in place
    prods = [c for c in emulated.tf32_calls if c["kind"] == "gemm"]
    for k0, c in zip(range(n - 256, -1, -256), prods):
        assert c["shape"] == (n - k0, n - k0, 256) and c["c"] == c["d"] and c["ld"][0] == n
        assert c["d"] == q.data_ptr() + 4 * (k0 * n + k0) and (c["alpha"], c["beta"]) == (-1, 1)


@pytest.mark.parametrize("layout", ["transposed", "strided", "float64"])
def test_orgqr_device_route_takes_views(emulated, rng, layout):
    """The device route takes vr and t as any view or dtype the plain route
    takes: it reads a contiguous f32 copy (a transposed vr, vr and t as
    column slices of wider matrices, or both in float64), so Q equals the
    plain route's on the same values at 1e-6 with the same launches, and
    the split reads vr with its own row stride n."""
    n = 512
    a = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    vr, t = qr._geqrf_onelaunch_plain(a)
    if layout == "transposed":
        vr_in, t_in = vr.mT.contiguous().mT, t
    elif layout == "strided":
        vr_in = torch.zeros((n, n + 40))[:, 8:n + 8].copy_(vr)
        t_in = torch.zeros((n, 300))[:, 20:276].copy_(t)
    else:
        vr_in, t_in = vr.double(), t.double()
    assert not (vr_in.is_contiguous() and vr_in.dtype == torch.float32)
    emulated.tf32_calls = []
    before = [f.launches for f in _COUNTS]
    q = qr.orgqr_onelaunch(vr_in, t_in)
    assert [f.launches - b for f, b in zip(_COUNTS, before)] == [2, 0, 0, 0, 0, 1, 2, 3, 2]
    assert q.dtype == torch.float32
    _close(q, qr._orgqr_onelaunch_plain(vr, t).numpy(), 1e-6)
    splits = [c for c in emulated.tf32_calls if c["kind"] == "split"]
    assert splits[0]["ld"][0] == n


# ---------------------------------------------------------------------------
# tml_gram_tn: its sum modelled in numpy, and its wrapper on the emulation

def _model_gram(x, y, slices: int, finish=None):
    """tml_gram_tn's sum of xᵀ·y in numpy f32, without its FMAs: slice s
    (blockIdx.y) takes chunks [s·c/S, (s+1)·c/S) of the c 128-row chunks,
    sums each chunk in a fresh accumulator, row by row, and the chunk sums
    in order; its block writes the partial when it finishes, in the order
    ``finish``; the tile's last block sums the partials in slice order."""
    chunks = x.shape[0] // 128
    parts = {}
    for s in (finish if finish is not None else range(slices)):
        tot = None
        for c in range(s * chunks // slices, (s + 1) * chunks // slices):
            acc = np.zeros((x.shape[1], y.shape[1]), np.float32)
            for r in range(c * 128, (c + 1) * 128):
                acc = acc + x[r, :, None] * y[r, None, :]
            tot = acc if tot is None else tot + acc
        parts[s] = tot
    out = parts[0]
    for s in range(1, slices):
        out = out + parts[s]
    return out


@pytest.mark.parametrize("k", [128, 512, 4096])
def test_gram_model_two_level_split_k_sum(rng, k):
    """The kernel's sum equals the plain version's (a batched product of
    128-row chunks, then their sum) to 1e-6 relative at any slice count, is
    the same whichever block finishes last, and with one slice or one chunk
    a slice is the chunk sums in chunk order exactly."""
    x = rng.normal(size=(k, 64)).astype(np.float32)
    y = rng.normal(size=(k, 64)).astype(np.float32)
    want = qr._gram_tn_plain(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    got = {}
    for slices in (1, 2, 4, 32):
        if slices > k // 128:
            continue
        got[slices] = _model_gram(x, y, slices)
        assert max_scaled_err(got[slices], want.astype(np.float64)) <= 1e-6
        for finish in (range(slices - 1, -1, -1), rng.permutation(slices)):
            np.testing.assert_array_equal(_model_gram(x, y, slices, finish), got[slices])
    np.testing.assert_array_equal(got[1], _model_gram(x, y, k // 128))


def test_gram_wrapper_marshalling(emulated, rng):
    """_gram_tn hands a view to the entry point with its row stride, copies
    an operand whose layout the kernel does not read, and counts one launch;
    the raw route's options (a split operand, α, β, C, the halved diagonal
    and the ridge) reach the entry point as the driver passes them."""
    big = torch.from_numpy(rng.normal(size=(512, 300)).astype(np.float32))
    x, y = big[:, :128], big[:, 8:264]
    before = qr._gram_tn.launches
    got = qr._gram_tn(x, y)
    assert qr._gram_tn.launches == before + 1
    assert torch.equal(got, qr._gram_tn_plain(x, y))
    assert emulated.gram_calls[-1]["k"] == 512 and emulated.gram_calls[-1]["n"] == 256
    odd = big[:, 1:129]   # a start 4 bytes past the alignment: copied
    assert torch.equal(qr._gram_tn(odd, odd), qr._gram_tn_plain(odd, odd))
    with pytest.raises(InvalidValueError):
        qr._gram_tn(big[:200, :128], big[:200, :128])
    # the raw route: rows < 128 of x from a second matrix, C, α and β, the flags
    top = torch.from_numpy(rng.normal(size=(NB, NB)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(NB, NB)).astype(np.float32))
    d = torch.empty((NB, NB))
    gram = qr._Gram(torch.device("cpu"), 0, 4)
    rest = (big.data_ptr(), big.stride(0))
    xs = qr._split((top.data_ptr(), NB), rest, NB)
    full = torch.cat((top, big[NB:, :NB]))
    for flags in (0, 1, 2):
        gram((d.data_ptr(), NB), xs, xs, 512, NB, NB, flags=flags, c=(c.data_ptr(), NB),
             alpha=2.0, beta=-1.0)
        want = 2.0 * qr._gram_tn_plain(full, full) + -1.0 * c
        if flags == 1:
            want.diagonal().mul_(0.5)
        if flags == 2:
            want.diagonal().add_(qr._RIDGE / NB * want.diagonal().sum() + 1e-30)
        assert torch.equal(d, want)
    assert emulated.gram_calls[-1]["tops"] == (NB, NB) and emulated.gram_calls[-1]["c"]


def test_gram_entry_refusals(emulated):
    """What the C entry refuses (cudaErrorInvalidValue) raises through the
    wrapper's launch check: the ridge on a non-square output, and a top of
    rows that is not a whole number of chunks."""
    x = torch.zeros((256, 128))
    d = torch.empty((128, 256))
    gram = qr._Gram(torch.device("cpu"), 0, 8)
    op = (x.data_ptr(), 128)
    with pytest.raises(ExecutionError, match="tml_gram_tn"):
        gram((d.data_ptr(), 256), op, (torch.zeros((256, 256)).data_ptr(), 256), 256, NB, 256,
             flags=2)
    with pytest.raises(ExecutionError, match="tml_gram_tn"):
        gram((d.data_ptr(), 128), qr._split(op, op, 64), op, 256, NB, NB)


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
