"""Parity of tpumathlib_torch.fft (plans and planar engines) with the
reference.

Mirrors the local-plan tests of ``tests/test_fft.py`` and
``tests/test_fft_kernels.py``: every case runs the same seeded numpy input
through the reference's plan (its planar path reaches ``dif_fft`` in
interpret mode on the CPU) and through the port's (its planar path reaches
``dif_fft``'s plain version on CPU tensors), and compares them, and both
with float64 numpy. Tolerances (rel-L2): 1e-5 for f32 (the reference's own
planar bar, ``tests/test_fft_kernels.py:48``), 1e-2 for bf16 planes.

The routing is checked on the CUDA branch with the kernel library replaced
by the CPU emulation of ``tml_dif_fft`` from ``test_torch_fft_stockham``:
every power-of-two axis of length ≥ 256 launches the kernel, and the
two-for-one R2C/C2R packing launches it on half the rows.

The matmul stages (``kernels._mm``) are held to f32 products whatever TF32
setting the caller made, with the caller's setting restored afterwards.

Inputs are explicit f32/complex64 on both sides (the suite turns on jax
x64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.fft import plan as ref_plan
from tpumathlib.fft import kernels as ref_kernels
from tpumathlib_torch.core import device as core_device
from tpumathlib_torch.core.check import rel_l2
from tpumathlib_torch.core.errors import InvalidValueError
from tpumathlib_torch.core.interop import from_reference
from tpumathlib_torch.fft import kernels, stockham
from tpumathlib_torch.fft import plan as fft_plan
from tpumathlib_torch.fft.plan import Direction, FftType
from test_torch_fft_stockham import emulated  # noqa: F401  (the emulated-library fixture)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_arrays_on_the_cpu(monkeypatch):
    """The port's default device is the card (core.device.default_device);
    these tests turn host arrays into containers on the CPU."""
    monkeypatch.setattr(core_device, "default_device", lambda: torch.device("cpu"))


F32_TOL = 1e-5
BF16_TOL = 1e-2


def _cplx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def _np(y):
    if isinstance(y, torch.Tensor):
        y = y.resolve_conj() if y.is_complex() else y.double()
        return y.numpy().astype(np.complex128 if y.is_complex() else np.float64)
    return np.asarray(y, np.complex128 if np.iscomplexobj(y) else np.float64)


def _pl(yr, yi):
    return _np(yr) + 1j * _np(yi)


def _both(plan_fn, *args, **kw):
    """The reference's plan and the port's, built by the same call."""
    ref_fn = getattr(ref_plan, plan_fn)
    port_fn = getattr(fft_plan, plan_fn)
    ref_kw = dict(kw)
    if "fft_type" in kw:
        ref_kw["fft_type"] = ref_plan.FftType(kw["fft_type"].value)
    return ref_fn(*args, **ref_kw), port_fn(*args, **kw)


def _rdir(d):
    return ref_plan.Direction(d.value)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# The plans

@pytest.mark.parametrize("n", [256, 360])
def test_c2c_complex_roundtrip(n, rng):
    """≙ cuFFT/1d_c2c through the complex (vendor) path of both packages."""
    x = _cplx(rng, (4, n))
    rp, pp = _both("plan_1d", n, fft_type=FftType.C2C, batch=4)
    y = pp(_t(x))
    assert y.dtype == torch.complex64
    assert rel_l2(y, rp(jnp.asarray(x))) < F32_TOL
    assert rel_l2(y, np.fft.fft(x)) < F32_TOL
    z = pp(y, Direction.INVERSE)
    assert rel_l2(z, rp(jnp.asarray(_np(y).astype(np.complex64)), _rdir(Direction.INVERSE))) < F32_TOL
    assert rel_l2(z, n * x) < F32_TOL


@pytest.mark.parametrize("n", [512, 360, 64])
def test_c2c_planar_matches_reference(n, rng):
    x = _cplx(rng, (8, n))
    rp, pp = _both("plan_many", (n,), fft_type=FftType.C2C)
    for d in (Direction.FORWARD, Direction.INVERSE):
        yr, yi = pp((_t(x.real), _t(x.imag)), d)
        rr, ri = rp((jnp.asarray(x.real), jnp.asarray(x.imag)), _rdir(d))
        assert yr.dtype == torch.float32
        assert rel_l2(_pl(yr, yi), _pl(rr, ri)) < F32_TOL
        want = np.fft.fft(x) if d == Direction.FORWARD else n * np.fft.ifft(x)
        assert rel_l2(_pl(yr, yi), want) < F32_TOL


@pytest.mark.parametrize("rows", [6, 5])
@pytest.mark.parametrize("n", [64, 256, 12, 1024])
def test_r2c_c2r_planar(n, rows, rng):
    """Even batches take the two-for-one packing at pow2 N ≥ 256, odd ones
    stream a zero imaginary plane."""
    x = rng.normal(size=(rows, n)).astype(np.float32)
    rr2c, pr2c = _both("plan_many", (n,), fft_type=FftType.R2C)
    rc2r, pc2r = _both("plan_many", (n,), fft_type=FftType.C2R)
    yr, yi = pr2c(_t(x), planar=True)
    wr, wi = rr2c(jnp.asarray(x), planar=True)
    assert yr.dtype == torch.float32 and yr.shape == (rows, n // 2 + 1)
    assert rel_l2(_pl(yr, yi), _pl(wr, wi)) < F32_TOL
    assert rel_l2(_pl(yr, yi), np.fft.rfft(x)) < F32_TOL
    z = pc2r((yr, yi), Direction.INVERSE)
    zw = rc2r((jnp.asarray(_np(yr), jnp.float32), jnp.asarray(_np(yi), jnp.float32)),
              _rdir(Direction.INVERSE))
    assert z.dtype == torch.float32 and z.shape == (rows, n)
    assert rel_l2(z, zw) < F32_TOL
    assert rel_l2(z, n * x) < F32_TOL


def test_plans_2d_3d(rng):
    x2 = _cplx(rng, (32, 16))
    rp, pp = _both("plan_2d", 32, 16)
    assert rel_l2(pp(_t(x2)), rp(jnp.asarray(x2))) < F32_TOL
    assert rel_l2(pp(_t(x2)), np.fft.fft2(x2)) < F32_TOL
    x3 = (rng.normal(size=(8, 16, 32)) + 1j * rng.normal(size=(8, 16, 32)))
    rp, pp = _both("plan_3d", 8, 16, 32)
    y3 = pp(_t(x3))
    assert y3.dtype == torch.complex128
    assert rel_l2(y3, np.fft.fftn(x3)) < 1e-12
    assert rel_l2(y3, rp(jnp.asarray(x3))) < 1e-12


@pytest.mark.parametrize("shape", [(256, 256), (16, 512, 8)])
def test_planar_nd_c2c(shape, rng):
    x = _cplx(rng, shape)
    rp, pp = _both("plan_many", shape, fft_type=FftType.C2C)
    yr, yi = pp((_t(x.real), _t(x.imag)))
    rr, ri = rp((jnp.asarray(x.real), jnp.asarray(x.imag)))
    assert rel_l2(_pl(yr, yi), _pl(rr, ri)) < F32_TOL
    assert rel_l2(_pl(yr, yi), np.fft.fftn(x)) < F32_TOL
    zr, zi = pp((yr, yi), Direction.INVERSE)
    assert rel_l2(_pl(zr, zi), x.size * x) < F32_TOL


@pytest.mark.parametrize("shape", [(16, 32), (256, 512)])
def test_planar_2d_r2c_c2r(shape, rng):
    """2D planar R2C: trailing axis halved, leading axis full C2C."""
    x = rng.normal(size=shape).astype(np.float32)
    rp, pp = _both("plan_2d", *shape, fft_type=FftType.R2C)
    yr, yi = pp(_t(x), planar=True)
    wr, wi = rp(jnp.asarray(x), planar=True)
    assert yr.shape == (shape[0], shape[1] // 2 + 1)
    assert rel_l2(_pl(yr, yi), _pl(wr, wi)) < F32_TOL
    assert rel_l2(_pl(yr, yi), np.fft.rfftn(x)) < F32_TOL
    _, pc = _both("plan_2d", *shape, fft_type=FftType.C2R)
    z = pc((yr, yi), Direction.INVERSE)
    assert rel_l2(z, x.size * x) < F32_TOL


@pytest.mark.parametrize("norm", [None, "ortho", "backward"])
def test_norm_planar_matches_complex(norm, rng):
    """The planar path scales as the complex path does, in both directions
    and in both packages."""
    n = 512
    x = _cplx(rng, (3, n))
    rp, pp = _both("plan_many", (n,), fft_type=FftType.C2C, norm=norm)
    for d in (Direction.FORWARD, Direction.INVERSE):
        want = np.asarray(rp(jnp.asarray(x), _rdir(d)))
        assert rel_l2(pp(_t(x), d), want) < F32_TOL
        pr, pi = pp((_t(x.real), _t(x.imag)), d)
        assert rel_l2(_pl(pr, pi), want) < F32_TOL, (norm, d)
        rr, ri = rp((jnp.asarray(x.real), jnp.asarray(x.imag)), _rdir(d))
        assert rel_l2(_pl(pr, pi), _pl(rr, ri)) < F32_TOL


def test_ortho_complex_roundtrip(rng):
    n = 64
    x = _cplx(rng, (n,))
    p = fft_plan.plan_many((n,), FftType.C2C, norm="ortho")
    y = p(_t(x))
    assert rel_l2(y, np.fft.fft(x, norm="ortho")) < F32_TOL
    assert rel_l2(p(y, Direction.INVERSE), x) < F32_TOL


def test_callbacks(rng):
    """≙ lto_callback_window_1d: a window as load callback, a scale as store
    callback, on the complex and the planar paths of both packages."""
    n = 512
    keep = 16
    x = rng.normal(size=(4, n)).astype(np.float32)
    win = (np.arange(n) < keep).astype(np.float32)
    tw = _t(win)
    rp = ref_plan.plan_many((n,), ref_plan.FftType.R2C, pre=lambda v: v * jnp.asarray(win))
    pp = fft_plan.plan_many((n,), FftType.R2C, pre=lambda v: v * tw)
    assert rel_l2(pp(_t(x)), rp(jnp.asarray(x))) < F32_TOL
    yr, yi = pp(_t(x), planar=True)
    assert rel_l2(_pl(yr, yi), np.fft.rfft(x * win)) < F32_TOL
    z = _cplx(rng, (4, n))
    post = fft_plan.plan_many((n,), FftType.C2C, post=lambda v: (v[0] / n, v[1] / n))
    pre = fft_plan.plan_many((n,), FftType.C2C, pre=lambda v: (v[0] * tw, v[1] * tw))
    rpre = ref_plan.plan_many((n,), ref_plan.FftType.C2C,
                              pre=lambda v: (v[0] * jnp.asarray(win), v[1] * jnp.asarray(win)))
    gr, gi = post((_t(z.real), _t(z.imag)))
    assert rel_l2(_pl(gr, gi), np.fft.fft(z) / n) < F32_TOL
    gr, gi = pre((_t(z.real), _t(z.imag)))
    wr, wi = rpre((jnp.asarray(z.real), jnp.asarray(z.imag)))
    assert rel_l2(_pl(gr, gi), _pl(wr, wi)) < F32_TOL
    # a plan with callbacks is not cached
    assert fft_plan.plan_many((n,), FftType.C2C, post=post.post) is not post


def test_plan_cache_and_rejections():
    p1 = fft_plan.plan_1d(64, FftType.C2C)
    assert p1 is fft_plan.plan_1d(64, FftType.C2C)   # cached (≙ plan reuse)
    assert p1 is not fft_plan.plan_1d(64, FftType.C2C, precision="bf16")
    with pytest.raises(InvalidValueError):
        fft_plan.plan_many((512,), FftType.C2C, precision="fp8")
    c2r = fft_plan.plan_many((16,), FftType.C2R)
    with pytest.raises(InvalidValueError):
        c2r(torch.ones(9, dtype=torch.complex64), Direction.FORWARD)
    with pytest.raises(InvalidValueError):
        c2r((torch.ones(2, 9), torch.ones(2, 9)), Direction.FORWARD)
    r2c = fft_plan.plan_many((16,), FftType.R2C)
    with pytest.raises(InvalidValueError):
        r2c(torch.ones(16), Direction.INVERSE)
    with pytest.raises(InvalidValueError):
        r2c((torch.ones(16), torch.ones(16)))
    with pytest.raises(InvalidValueError):
        fft_plan.plan_many((16,), FftType.C2C)(torch.ones(16), planar=True)


def test_precision_bf16(rng):
    """precision="bf16" plans: bf16 planes through dif_fft, within 1e-2 of
    the reference's and of float64 numpy."""
    n = 512
    x = rng.normal(size=(8, n)).astype(np.float32)
    rr2c, pr2c = _both("plan_many", (n,), fft_type=FftType.R2C, precision="bf16")
    rc2r, pc2r = _both("plan_many", (n,), fft_type=FftType.C2R, precision="bf16")
    yr, yi = pr2c._fwd_planar(_t(x))
    wr, wi = rr2c._fwd_planar(jnp.asarray(x))
    assert yr.dtype == torch.bfloat16 and wr.dtype == jnp.bfloat16
    assert rel_l2(_pl(yr, yi), _pl(wr, wi)) < BF16_TOL
    assert rel_l2(_pl(yr, yi), np.fft.rfft(x)) < BF16_TOL
    back = pc2r._inv_planar(yr, yi)
    assert back.dtype == torch.float32
    assert rel_l2(back / n, x) < BF16_TOL
    assert rel_l2(back, rc2r._inv_planar(wr, wi)) < BF16_TOL
    ai = rng.normal(size=(8, n)).astype(np.float32)
    rc, pc = _both("plan_many", (n,), fft_type=FftType.C2C, precision="bf16")
    zr, zi = pc._fwd_planar(_t(x), _t(ai))
    assert zr.dtype == torch.bfloat16
    assert rel_l2(_pl(zr, zi), _pl(*rc._fwd_planar(jnp.asarray(x), jnp.asarray(ai)))) < BF16_TOL
    assert rel_l2(_pl(zr, zi), np.fft.fft(x + 1j * ai.astype(np.float64))) < BF16_TOL


def test_one_shots(rng):
    """Unnormalised in both directions, as cuFFT and the reference are."""
    x = _cplx(rng, (3, 256))
    assert rel_l2(fft_plan.fft(_t(x)), np.fft.fft(x)) < F32_TOL
    assert rel_l2(fft_plan.ifft(_t(x)), 256 * np.fft.ifft(x)) < F32_TOL
    assert rel_l2(fft_plan.ifft(_t(x)), ref_plan.ifft(jnp.asarray(x))) < F32_TOL
    r = rng.normal(size=(3, 256)).astype(np.float32)
    y = fft_plan.rfft(_t(r))
    assert rel_l2(y, np.fft.rfft(r)) < F32_TOL
    assert rel_l2(fft_plan.irfft(y, (256,)), 256 * r) < F32_TOL
    assert rel_l2(fft_plan.irfft(y, (256,)),
                  ref_plan.irfft(jnp.asarray(_np(y).astype(np.complex64)), (256,))) < F32_TOL


# ---------------------------------------------------------------------------
# The matmul engines

@pytest.mark.parametrize("n", [16, 128, 360, 1024])
def test_mxu_fft_sizes(n, rng):
    x = _cplx(rng, (4, n))
    y = kernels.mxu_fft(_t(x))
    assert y.dtype == torch.complex64
    assert rel_l2(y, ref_kernels.mxu_fft(jnp.asarray(x))) < F32_TOL
    assert rel_l2(y, np.fft.fft(x)) < F32_TOL
    z = kernels.mxu_fft(y, inverse=True)
    assert rel_l2(z, n * x) < F32_TOL


def test_mxu_fftn_rfft_irfft(rng):
    x = _cplx(rng, (4, 16, 32))
    y = kernels.mxu_fftn(_t(x), axes=(1, 2))
    assert rel_l2(y, ref_kernels.mxu_fftn(jnp.asarray(x), axes=(1, 2))) < F32_TOL
    assert rel_l2(y, np.fft.fftn(x, axes=(1, 2))) < F32_TOL
    r = rng.normal(size=(4, 256)).astype(np.float32)
    h = kernels.mxu_rfft(_t(r))
    assert h.shape == (4, 129)
    assert rel_l2(h, ref_kernels.mxu_rfft(jnp.asarray(r))) < F32_TOL
    assert rel_l2(kernels.mxu_irfft(h, 256), 256 * r) < F32_TOL


# ---------------------------------------------------------------------------
# State carried across

def test_from_reference_fft_descriptors(rng):
    rdesc = ref_plan.FftDescriptor((512,), ref_plan.FftType.R2C, batch=4, norm="ortho",
                                   precision="f32")
    desc = from_reference(rdesc)
    assert desc == fft_plan.FftDescriptor((512,), FftType.R2C, 4, "ortho", "f32")
    assert from_reference(ref_plan.FftType.C2R) is FftType.C2R
    assert from_reference(ref_plan.Direction.INVERSE) is Direction.INVERSE
    x = rng.normal(size=(4, 512)).astype(np.float32)
    yr, yi = fft_plan.FftPlan(desc)(_t(x), planar=True)
    wr, wi = ref_plan.FftPlan(rdesc)(jnp.asarray(x), planar=True)
    assert rel_l2(_pl(yr, yi), _pl(wr, wi)) < F32_TOL


# ---------------------------------------------------------------------------
# The routing, on the CUDA branch with an emulated kernel library

@pytest.mark.parametrize("rows", [8, 7])
def test_planar_routes_launch_the_kernel(emulated, rows, rng):
    n = 512
    x = rng.normal(size=(rows, n)).astype(np.float32)
    before = stockham.dif_fft.launches
    r2c = fft_plan.plan_many((n,), FftType.R2C)
    yr, yi = r2c(_t(x), planar=True)
    c2r = fft_plan.plan_many((n,), FftType.C2R)
    z = c2r((yr, yi), Direction.INVERSE)
    assert stockham.dif_fft.launches == before + 2
    half = rows // 2 if rows % 2 == 0 else rows
    assert [(c["rows"], c["inverse"]) for c in emulated.calls] == [(half, False), (half, True)]
    assert rel_l2(_pl(yr, yi), np.fft.rfft(x)) < F32_TOL
    assert rel_l2(z, n * x) < F32_TOL


def test_non_pow2_and_short_axes_take_the_four_step(emulated, rng):
    x = _cplx(rng, (4, 360))
    p = fft_plan.plan_many((360,), FftType.C2C)
    yr, yi = p((_t(x.real), _t(x.imag)))
    x2 = _cplx(rng, (4, 128))
    fft_plan.plan_many((128,), FftType.C2C)((_t(x2.real), _t(x2.imag)))
    assert emulated.calls == []
    assert rel_l2(_pl(yr, yi), np.fft.fft(x)) < F32_TOL


def test_plan_2d_launches_per_axis(emulated, rng):
    """Each axis of a 2-D planar plan is one launch; the leading axis reaches
    the kernel as contiguous rows."""
    x = _cplx(rng, (256, 512))
    yr, yi = fft_plan.plan_2d(256, 512)((_t(x.real), _t(x.imag)))
    assert [(c["rows"], c["log_n"]) for c in emulated.calls] == [(256, 9), (512, 8)]
    assert rel_l2(_pl(yr, yi), np.fft.fft2(x)) < F32_TOL


# ---------------------------------------------------------------------------
# The matmul stages' f32 guard (C7)

@pytest.fixture
def tf32_on():
    """TF32 allowed and float32 matmul precision "high", as a caller might
    set them; the settings of before come back afterwards."""
    matmul = torch.backends.cuda.matmul
    tf32, precision = matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    matmul.allow_tf32 = True
    yield
    torch.set_float32_matmul_precision(precision)
    matmul.allow_tf32 = tf32


def _settings():
    return torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()


def test_matmul_stages_pin_f32_and_restore_the_callers_setting(tf32_on, monkeypatch):
    """_mm runs every product with TF32 off and the precision at "highest",
    whatever the caller set, and gives the caller's settings back, also when
    the product raises."""
    seen, matmul = [], torch.matmul

    def spy(a, b):
        seen.append(_settings())
        return matmul(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    kernels._mm(torch.ones(3, 4), torch.ones(4, 2))
    assert seen == [(False, "highest")] and _settings() == (True, "high")
    with pytest.raises(RuntimeError):
        kernels._mm(torch.ones(3, 4), torch.ones(3, 4))
    assert _settings() == (True, "high")
    seen.clear()
    for n in (96, 1000):   # the four-step path, N not a power of two
        kernels._fft_planar(torch.ones(2, n), torch.zeros(2, n), False)
    assert seen and set(seen) == {(False, "highest")} and _settings() == (True, "high")


def test_matmul_guard_when_the_precision_cannot_be_read(tf32_on, monkeypatch):
    """A caller who mixed torch's legacy and new precision APIs makes
    get_float32_matmul_precision raise: the guard then pins and restores
    allow_tf32 alone."""
    def unreadable():
        raise RuntimeError("mix of the legacy and new APIs")

    seen, matmul = [], torch.matmul
    monkeypatch.setattr(torch, "get_float32_matmul_precision", unreadable)
    monkeypatch.setattr(torch, "matmul",
                        lambda a, b: seen.append(torch.backends.cuda.matmul.allow_tf32) or matmul(a, b))
    kernels._mm(torch.ones(2, 2), torch.ones(2, 2))
    assert seen == [False] and torch.backends.cuda.matmul.allow_tf32
