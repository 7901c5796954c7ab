"""Parity of tpumathlib_torch.dx.vv10 (kernel B11: the VV10 pairwise forward
and backward sweeps behind ``_PairCore``) with the reference.

At G = 1500 with masked (ρ → 0) points, inputs as tests/test_vv10.py:84-106
makes them, the energy and its four gradients (ρ, |∇ρ|², points, weights)
through ``torch.autograd.grad`` against the reference's
``vv10_pair_energy_pallas`` (interpret mode) and its XLA
``apps.vv10.vv10_pair_energy``: the gradients within 1e-5 of their largest
value, the reference test's bound (measured at most 1.9e-7). For the
energy the reference test's 1e-7 relative is about one f32 rounding of a sum
of 1500 terms: the port measured 9.999e-8 from the reference's kernel and
from the XLA path, which both sit 1.074e-7 from a float64 numpy oracle,
while the port sits 7.4e-9 from it. So the energy is held to that oracle:
no further from it than twice the reference's kernel is, and within 2e-7 of
the reference's energy. ``torch.autograd.gradcheck`` of ``_PairCore``'s plain
route in float64 at G = 40, the kernels' plain versions against a float64
numpy loop over pairs, and the CUDA branch of both wrappers against
``_EmulatedLib``, an emulation of tml_vv10_fwd and tml_vv10_bwd.

The kernels' arithmetic, modelled in numpy: their one-reciprocal
factorization of a pair in f32 against float64 over g_i, g_j from 1e-20 to
1e20 (no overflow or underflow where the float64 terms are normal f32
numbers), the range their lean reciprocal takes (g in [2^-41, 2^41) puts
the denominator and its reciprocal among f32's normal numbers, so ftz
flushes nothing), and their tile test (a bound on g from the block's and
the tile's |p|², w0 and κ), which admits no pair outside that range. And
chip_smoke.py's far-tile case through a model of the forward kernel's
tiles: right with the kernel's own decisions, a tenth off or worse with
the lean reciprocal everywhere or a tile's decision on its neighbour.
"""

import contextlib
import importlib.util
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.apps.vv10 import vv10_beta as ref_beta
from tpumathlib.apps.vv10 import vv10_pair_energy as ref_xla
from tpumathlib.dx.vv10 import vv10_pair_energy_pallas as ref_kernel
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx import vv10 as port
from test_torch_dx_gemm import _view
from test_torch_dx_rng import _EmulatedLib as _EmulatedRngLib

torch.set_num_threads(1)

B, C = 5.9, 0.0093
GRAD_TOL = 1e-5   # of the largest |gradient| (tests/test_vv10.py:104-106)


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _inputs(rng, g):
    """tests/test_vv10.py:91-96: ρ ~ U(0.01, 0.5) with every 17th point at
    1e-12, |∇ρ|² ~ U(0, 0.1), points 3·N(0, 1), weights U(0.001, 0.02)."""
    rho = rng.uniform(0.01, 0.5, g).astype(np.float32)
    rho[::17] = 1e-12
    s2 = rng.uniform(0, 0.1, g).astype(np.float32)
    pts = (rng.normal(size=(g, 3)) * 3).astype(np.float32)
    w = rng.uniform(0.001, 0.02, g).astype(np.float32)
    return rho, s2, pts, w


def _channels64(rho, s2, w):
    """The channel chain in float64 numpy: (wr, w0, κ)."""
    rho, s2, w = (x.astype(np.float64) for x in (rho, s2, w))
    good = rho > 1e-9
    rs = np.where(good, rho, 1.0)
    w0 = np.sqrt(C * (s2 / (rs * rs)) ** 2 + (4.0 * np.pi) * rs / 3.0)
    kappa = B * (1.5 * np.pi) * (rs / (9.0 * np.pi)) ** (1.0 / 6.0)
    return np.where(good, w * rho, 0.0), w0, kappa


def _sums64(wr, w0, kappa, pts):
    """inner and the five backward sums by a float64 numpy loop over i-chunks."""
    pts = pts.astype(np.float64)
    g = wr.shape[0]
    inner, sums = np.empty(g), np.empty((5, g))
    for s in range(0, g, 256):
        d = pts[s:s + 256, None, :] - pts[None, :, :]
        r2 = (d * d).sum(-1)
        gi = w0[s:s + 256, None] * r2 + kappa[s:s + 256, None]
        gj = w0[None, :] * r2 + kappa[None, :]
        phi = -1.5 / (gi * gj * (gi + gj))
        inner[s:s + 256] = phi @ wr
        pgi = -phi * (1 / gi + 1 / (gi + gj))
        pgj = -phi * (1 / gj + 1 / (gi + gj))
        sums[0, s:s + 256] = (wr * pgi * r2).sum(1)
        sums[1, s:s + 256] = (wr * pgi).sum(1)
        tij = wr * (pgi * w0[s:s + 256, None] + pgj * w0[None, :])
        sums[2:, s:s + 256] = 2.0 * np.einsum("ij,ijc->ci", tij, d)
    return inner, sums


def _energy64(rho, s2, pts, w):
    wr, w0, kappa = _channels64(rho, s2, w)
    inner, _ = _sums64(wr, w0, kappa, pts)
    return ref_beta(B) * wr.sum() + 0.5 * (wr * inner).sum()


def _port_value_and_grad(rho, s2, pts, w):
    ts = [torch.from_numpy(x).requires_grad_() for x in (rho, s2, pts, w)]
    e = port.vv10_pair_energy_pallas(*ts, B, C)
    return e, torch.autograd.grad(e, ts)


@pytest.fixture(scope="module")
def g1500():
    """The reference test's case, through both reference routes and the port."""
    rho, s2, pts, w = _inputs(np.random.default_rng(5), 1500)
    args = tuple(jnp.asarray(x) for x in (rho, s2, pts, w))
    e_k, g_k = jax.value_and_grad(lambda *a: ref_kernel(*a, B, C), argnums=(0, 1, 2, 3))(*args)
    e_x, g_x = jax.value_and_grad(lambda *a: ref_xla(*a, B, C, chunk=500),
                                  argnums=(0, 1, 2, 3))(*args)
    e_p, g_p = _port_value_and_grad(rho, s2, pts, w)
    return dict(inputs=(rho, s2, pts, w), e64=_energy64(rho, s2, pts, w),
                kernel=(float(e_k), [np.asarray(t) for t in g_k]),
                xla=(float(e_x), [np.asarray(t) for t in g_x]),
                port=(float(e_p.detach()), [t.numpy() for t in g_p]), port_dtype=e_p.dtype)


@pytest.mark.parametrize("route", ["kernel", "xla"])
def test_gradients_match_reference(g1500, route):
    _, g_ref = g1500[route]
    for name, a, b in zip(("rho", "s2", "pts", "w"), g_ref, g1500["port"][1]):
        assert a.shape == b.shape and b.dtype == np.float32
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) < GRAD_TOL * scale, name


@pytest.mark.parametrize("route", ["kernel", "xla"])
def test_energy_matches_reference_against_float64(g1500, route):
    e_ref, _ = g1500[route]
    e_port, e64 = g1500["port"][0], g1500["e64"]
    assert g1500["port_dtype"] == torch.float32
    assert abs(e_port - e64) <= 2.0 * abs(g1500["kernel"][0] - e64)
    assert abs(e_port - e_ref) < 2e-7 * abs(e_ref)


def test_plain_sums_match_float64(g1500):
    """Both plain kernel bodies in f32 against the float64 loop: inner and
    the five sums within 1e-5 of their largest."""
    rho, s2, pts, w = g1500["inputs"]
    wr, w0, kappa = _channels64(rho, s2, w)
    inner64, sums64 = _sums64(wr, w0, kappa, pts)
    t = [torch.from_numpy(x.astype(np.float32)) for x in (wr, w0, kappa)]
    inner = port._vv10_fwd_plain(*t, torch.from_numpy(pts)).double().numpy()
    sums = port._vv10_bwd_plain(*t, torch.from_numpy(pts)).double().numpy()
    assert np.abs(inner - inner64).max() < 1e-5 * np.abs(inner64).max()
    for row, row64 in zip(sums, sums64):
        assert np.abs(row - row64).max() < 1e-5 * np.abs(row64).max()


def test_pair_core_gradcheck():
    """The hand-derived backward against finite differences, on the plain
    route in float64 at G = 40."""
    rng = np.random.default_rng(3)
    g = 40
    wr = torch.from_numpy(rng.uniform(0.0, 0.01, g)).requires_grad_()
    w0 = torch.from_numpy(rng.uniform(0.5, 2.0, g)).requires_grad_()
    kappa = torch.from_numpy(rng.uniform(5.0, 12.0, g)).requires_grad_()
    pts = torch.from_numpy(rng.normal(size=(g, 3)) * 2).requires_grad_()
    assert torch.autograd.gradcheck(lambda *a: port._PairCore.apply(*a, port.vv10_beta(B)),
                                    (wr, w0, kappa, pts), eps=1e-6, atol=1e-9, rtol=1e-6)


def test_vv10_beta_equals_reference():
    for b in (5.9, 6.0, 1.0):
        assert port.vv10_beta(b) == ref_beta(b)


def test_ragged_and_masked_g(rng):
    """G = 7 and 300 (ragged against any tile) with a masked point: the port's
    energy against the reference kernel's."""
    for g in (7, 300):
        rho, s2, pts, w = _inputs(rng, g)
        e_ref = float(ref_kernel(*(jnp.asarray(x) for x in (rho, s2, pts, w)), B, C))
        e_port, _ = _port_value_and_grad(rho, s2, pts, w)
        assert abs(float(e_port.detach()) - e_ref) < 2e-7 * abs(e_ref)


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

class _EmulatedLib(_EmulatedRngLib):
    """Adds dx_vv10.cu's contracts, computed on the CPU from the raw
    arguments: the four f32 channels through their pointers and G, the
    output (G,) or (5, G)."""

    def __init__(self, rc=0):
        super().__init__(rc)
        self.vv10_calls = []

    def _channels(self, wr, w0, kappa, pts, g):
        return ([_view(p, torch.float32, (g,), (1,)).clone() for p in (wr, w0, kappa)]
                + [_view(pts, torch.float32, (g, 3), (3, 1)).clone()])

    def tml_vv10_fwd(self, wr, w0, kappa, pts, inner, g, stream):
        self.vv10_calls.append(("fwd", g))
        if self.rc:
            return self.rc
        _view(inner, torch.float32, (g,), (1,)).copy_(
            port._vv10_fwd_plain(*self._channels(wr, w0, kappa, pts, g)))
        return 0

    def tml_vv10_bwd(self, wr, w0, kappa, pts, sums, g, stream):
        self.vv10_calls.append(("bwd", g))
        if self.rc:
            return self.rc
        _view(sums, torch.float32, (5, g), (g, 1)).copy_(
            port._vv10_bwd_plain(*self._channels(wr, w0, kappa, pts, g)))
        return 0


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    monkeypatch.setattr(port, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def test_cuda_branch_value_and_grad(emulated, rng):
    """One forward and one backward launch for energy and gradients, equal to
    the plain route's."""
    rho, s2, pts, w = _inputs(rng, 301)
    before = (port._vv10_fwd.launches, port._vv10_bwd.launches)
    e, grads = _port_value_and_grad(rho, s2, pts, w)
    assert (port._vv10_fwd.launches, port._vv10_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert emulated.vv10_calls == [("fwd", 301), ("bwd", 301)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "on_cuda", lambda *t: False)
        e_plain, g_plain = _port_value_and_grad(rho, s2, pts, w)
    assert torch.equal(e, e_plain)
    for a, b in zip(grads, g_plain):
        assert torch.equal(a, b)


def test_cuda_branch_checks_and_failures(emulated):
    ones = torch.ones(4)
    with pytest.raises(InvalidValueError, match="f32 on one device"):
        port._vv10_fwd(ones.double(), ones, ones, torch.ones(4, 3))
    emulated.rc = 5
    before = port._vv10_fwd.launches
    with pytest.raises(ExecutionError, match="tml_vv10_fwd: CUDA error 5"):
        port._vv10_fwd(ones, ones, ones, torch.ones(4, 3))
    with pytest.raises(ExecutionError, match="tml_vv10_bwd: CUDA error 5"):
        port._vv10_bwd(ones, ones, ones, torch.ones(4, 3))
    assert port._vv10_fwd.launches == before


def test_cpu_takes_the_plain_version_without_launch(rng):
    rho, s2, pts, w = _inputs(rng, 50)
    before = (port._vv10_fwd.launches, port._vv10_bwd.launches)
    _port_value_and_grad(rho, s2, pts, w)
    assert (port._vv10_fwd.launches, port._vv10_bwd.launches) == before


# ---------------------------------------------------------------------------
# The slice as a whole

def test_slice_potential_direction(rng):
    """The gradient in ρ as a potential: a small step along it changes the
    energy as the directional derivative says, in both packages (the
    reference's finite-difference check of tests/test_vv10.py:55-76, on the
    pair energy)."""
    rho, s2, pts, w = _inputs(rng, 400)
    good = rho > 1e-9
    z = np.where(good, rng.normal(size=rho.shape), 0.0).astype(np.float32)
    h = 1e-3
    e, grads = _port_value_and_grad(rho, s2, pts, w)
    ad = float((grads[0].double() * torch.from_numpy(z).double()).sum())
    fd = (_energy64(rho + h * z * rho, s2, pts, w) - _energy64(rho - h * z * rho, s2, pts, w)) / (2 * h)
    ad_scaled = float((grads[0].double() * torch.from_numpy(z * rho).double()).sum())
    assert abs(fd - ad_scaled) < 5e-3 * max(abs(fd), 1e-6), (fd, ad_scaled, ad)
    assert math.isfinite(float(e.detach()))


# ---------------------------------------------------------------------------
# The kernels' per-pair arithmetic, modelled in numpy

LOW, HIGH = 2.0 ** -41, 2.0 ** 41   # csrc/dx_vv10.cu's kLow, kHigh: the lean reciprocal's g
F32_TINY, F32_MAX = float(np.finfo(np.float32).tiny), float(np.finfo(np.float32).max)


def _factorized_f32(gi, gj):
    """The kernels' terms of a pair with wr_j = 1, in f32 with IEEE
    arithmetic: r = 1 / (g_i g_j (g_i + g_j)) (φ / −1.5), and the two
    weights (r g_j)(r (g_i + g_ij)) and (r g_i)(r (g_j + g_ij)) (pgi and pgj
    / 1.5)."""
    gi, gj = gi.astype(np.float32), gj.astype(np.float32)
    with np.errstate(all="ignore"):
        gij = gi + gj
        r = np.float32(1) / (gi * gj * gij)
        return r, (r * gj) * (r * (gi + gij)), (r * gi) * (r * (gj + gij))


def test_pair_factorization_in_f32_against_float64():
    """Over g_i, g_j from 1e-20 to 1e20 (log-spaced, every pair): wherever a
    float64 term (r, wr pgi / 1.5 = r (1/g_i + 1/g_ij), wr pgj / 1.5) is a
    normal f32 number with a factor 4 of room, the f32 factorization gives
    it finite and within 1e-5 relative: no factor overflows or underflows
    where the term does not. And every pair whose g_i and g_j lie in
    [2^-41, 2^41), the range the kernels' lean reciprocal takes, has a
    denominator and reciprocal among f32's normal numbers (rcp.approx.ftz
    flushes neither)."""
    g = np.logspace(-20, 20, 161).astype(np.float32).astype(np.float64)
    gi, gj = np.meshgrid(g, g, indexing="ij")
    r64 = 1.0 / (gi * gj * (gi + gj))
    want = (r64, r64 * (1 / gi + 1 / (gi + gj)), r64 * (1 / gj + 1 / (gi + gj)))
    for got, w in zip(_factorized_f32(gi, gj), want):
        normal = (w >= 4 * F32_TINY) & (w <= F32_MAX / 4)
        assert normal.sum() > 1000
        got64 = got.astype(np.float64)[normal]
        assert np.isfinite(got64).all() and (got64 > 0).all()
        assert np.max(np.abs(got64 - w[normal]) / w[normal]) <= 1e-5
    lean = (gi >= LOW) & (gi < HIGH) & (gj >= LOW) & (gj < HIGH)
    f32 = [t.astype(np.float32) for t in (gi, gj)]
    with np.errstate(over="ignore"):   # pairs past 2^41, outside the lean range
        d = (f32[0] * f32[1] * (f32[0] + f32[1])).astype(np.float64)[lean]
    assert lean.sum() > 1000
    assert (d >= F32_TINY).all() and (d < 2.0 ** 126).all() and (1 / d >= F32_TINY).all()


def _tile_takes_lean(pi, w0i, ki, pj, w0j, kj):
    """csrc/dx_vv10.cu's tile test in numpy f32: the block's largest |p_i|²,
    w0_i and κ_i, each staged j's bound on g_i and g_j with r² ≤ 2 (|p_i|² +
    |p_j|²), all in [kLow, kHigh) with w0 ≥ 0; NaN fails every comparison."""
    f = np.float32
    p2i = (pi.astype(f) ** 2).sum(axis=1, dtype=f)
    ok = bool(np.all(p2i < HIGH) and np.all(w0i >= 0) and np.all(ki >= LOW))
    q, a, k = p2i.max(), f(np.maximum(w0i, 0).max()), f(np.maximum(ki, 0).max())
    r2 = f(2) * (q + (pj.astype(f) ** 2).sum(axis=1, dtype=f))
    gi, gj = a * r2 + k, w0j.astype(f) * r2 + kj.astype(f)
    return ok and bool(np.all((w0j >= 0) & (kj >= LOW) & (gi < HIGH) & (gj < HIGH)))


@pytest.mark.parametrize("spread", [1.0, 1e3, 1e6])
def test_tile_test_admits_only_the_lean_range(rng, spread):
    """Random blocks of 64 i and tiles of 256 j, w0 and κ log-uniform over
    ±spread decades and points over ±spread: wherever the tile test admits
    the lean reciprocal, every pair's g_i and g_j (in f32, as the kernels
    compute them) lies in [2^-41, 2^41); and the bench's inputs are
    admitted."""
    f = np.float32
    taken = 0
    for _ in range(40):
        e = np.log10(spread)
        pi, pj = (rng.uniform(-spread, spread, (n, 3)).astype(f) for n in (64, 256))
        w0i, ki, w0j, kj = (f(10.0) ** rng.uniform(-3 * e - 1, 3 * e + 1, n).astype(f)
                            for n in (64, 64, 256, 256))
        if not _tile_takes_lean(pi, w0i, ki, pj, w0j, kj):
            continue
        taken += 1
        d = pi[:, None, :] - pj[None, :, :]
        r2 = (d * d).sum(axis=2, dtype=f)
        g = np.concatenate([(w0i[:, None] * r2 + ki[:, None]).ravel(),
                            (w0j[None, :] * r2 + kj[None, :]).ravel()])
        assert (g >= LOW).all() and (g < HIGH).all()
    if spread == 1.0:
        assert taken == 40
    rho, s2, pts, w = _inputs(np.random.default_rng(5), 1500)
    wr, w0, kappa = (np.asarray(t).astype(f) for t in _channels64(rho, s2, w))
    assert _tile_takes_lean(pts[:64].astype(f), w0[:64], kappa[:64], pts[:256].astype(f),
                            w0[:256], kappa[:256])


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fwd_model(wr, w0, kappa, pts, decide):
    """The forward kernel's inner in numpy f32 by its blocks of 64 i and
    tiles of 256 j (j ≥ G padded as the kernel pads them): a tile takes the
    lean reciprocal where ``decide(block, tile, fast)`` says so, given the
    kernel's own test ``fast`` (``_tile_takes_lean``). The lean one is
    rcp.approx.ftz and a Newton step: 1/d, but 0 for d ≥ 2^126 (the result
    flushed) and NaN for a subnormal d (read as 0: inf, then inf − inf)."""
    f = np.float32
    g = len(wr)
    tiles = -(-g // 256)
    pad = tiles * 256 - g
    wrj = np.concatenate([wr, np.zeros(pad, f)])
    w0j, kj = (np.concatenate([x, np.ones(pad, f)]) for x in (w0, kappa))
    pj = np.concatenate([pts, np.zeros((pad, 3), f)])
    inner = np.zeros(g, f)
    for blk in range(-(-g // 64)):
        rows = slice(64 * blk, min(64 * blk + 64, g))
        for t in range(tiles):
            js = slice(256 * t, 256 * t + 256)
            fast = _tile_takes_lean(pts[rows], w0[rows], kappa[rows], pj[js], w0j[js], kj[js])
            d = pts[rows, None, :] - pj[None, js, :]
            r2 = (d * d).sum(axis=2, dtype=f)
            gi, gj = w0[rows, None] * r2 + kappa[rows, None], w0j[None, js] * r2 + kj[None, js]
            with np.errstate(all="ignore"):
                den = gi * gj * (gi + gj)
                r = f(1) / den
                if decide(blk, t, fast):
                    r = np.where(den >= f(2.0 ** 126), f(0), np.where(den < F32_TINY, f(np.nan), r))
            inner[rows] += (wrj[None, js] * r).sum(axis=1, dtype=f)
    return f(-1.5) * inner


def test_far_tile_case_fails_a_misplaced_lean_reciprocal():
    """chip_smoke.py's far-tile case (``_vv10_far``), through a numpy model
    of the forward kernel's tiles: with the kernel's own per-tile decision
    it is within 1e-5 of float64 (max-scaled) and finite, and its far tile
    is the only IEEE one in the near i's blocks; with the lean reciprocal
    everywhere, or with each tile taking its neighbour's decision, it is
    off by more than a tenth. So the card's check of that case fails a
    kernel without the range test or with the test on the wrong tile."""
    cs = _load_chip_smoke()
    wr, w0, kappa, pts = (t.numpy() for t in cs._vv10_far(torch.device("cpu")))
    want = port._vv10_fwd_plain(*(torch.from_numpy(x).double() for x in (wr, w0, kappa, pts)))
    far0, far1 = cs.VV10_FAR
    assert (far1 - far0, far0 % 256) == (256, 0)
    ieee = set()

    def own(blk, t, fast):
        if not fast:
            ieee.add((blk, t))
        return fast

    got = _fwd_model(wr, w0, kappa, pts, own)
    assert np.isfinite(got).all() and max_scaled_err(got, want.numpy()) <= 1e-5
    near_blocks = [b for b in range(24) if not far0 <= 64 * b < far1]
    assert ieee >= {(b, far0 // 256) for b in near_blocks}
    assert not any((b, t) in ieee for b in near_blocks for t in range(6) if t != far0 // 256)
    for wrong in (lambda blk, t, fast: True,
                  lambda blk, t, fast: (blk, (t + 1) % 6) not in ieee):
        assert not max_scaled_err(_fwd_model(wr, w0, kappa, pts, wrong), want.numpy()) <= 0.1
