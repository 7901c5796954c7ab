"""Parity of tpumathlib_torch.dx.fused (kernel B9, ``gemm_fft``, and the four
compositions) with the reference, whose Pallas kernel runs in interpret
mode.

- ``gemm_fft`` at the reference test's shapes (16, 32, 64) and at a ragged
  (300, 96, 80), under the three epilogues, against the reference at rel-L2
  1e-6 (measured at most 2.7e-7: the same f32 products summed in another
  order) and against float64 at rel-L2 1e-5 (the bound of
  tests/test_heuristics_grading_apps.py:148-149).
- C14 pinned: an epilogue string other than "relu" and "gelu" applies
  nothing, in both packages ("gelu_bias" gives FFT(A@B)); and the n, k ≤
  1024 check with its message.
- The four compositions at tests/test_heuristics_grading_apps.py:144-182
  (gemm_gemm rtol 1e-4, fft_convolution rel-L2 1e-4, fft_convolution_nd
  rtol 2e-4), and against the reference; gemm_fft_composed against float64
  and the reference, "gelu_bias" handed on to the GEMM.
- A model of the card kernels' arithmetic (``_model_gemm_fft``): the product
  as each route forms it (the tensor-core route's 3xTF32 stages,
  tests/test_torch_dx_comp.py::_model_tf32x3; the SIMT route's f32
  products), the epilogue, then the row FFT by
  tests/test_torch_fft_four_step.py::_model_launch on the plan the wrapper
  hands the kernel (``_gemm_fft_plan``) and the root table, at n = 64, 80,
  97, 256 and 1024, against float64 (rel-L2 1e-5) and the reference's
  ``gemm_fft`` (rel-L2 1e-5: the FFT's sums differ from its DFT products).
- The size rule ``_gemm_fft_route`` at the bench shape and phase 24's
  shapes, and the plan words as the C side reads them for every n ≤ 1024.
- The CUDA branch of ``gemm_fft`` against ``_EmulatedLib``, the codec
  emulation of tests/test_torch_dx_comp.py extended with tml_gemm_fft and
  tml_gemm_fft_simt (the model from the raw arguments: A with its row
  stride, B, on the tensor-core route Bᵀ's planes written to the wrapper's
  scratch first as the C side's split writes them, the root table, the plan
  words read and checked as the C side reads them): the epilogue code, each
  route's launch count, one split counted on the tensor-core route, a
  ragged k's copy of A, and the C side's refusals.
"""

import contextlib
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.core.errors import InvalidValueError as RefInvalidValueError
from tpumathlib.dx import fused as ref
from tpumathlib_torch.core.check import rel_l2
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.core.interop import from_numpy
from tpumathlib_torch.dx import cuda_utils, gemm, tf32x3
from tpumathlib_torch.dx import fused as port
from tpumathlib_torch.fft import kernels as fft_kernels, stockham
from test_torch_dx_comp import _EmulatedLib as _EmulatedCompLib, _model_tf32x3
from test_torch_dx_gemm import _view

torch.set_num_threads(1)

REF_TOL = 1e-6    # rel-L2 against the reference's kernel
F64_TOL = 1e-5    # rel-L2 against float64 (the reference test's bound)
F32 = torch.float32
SHAPES = [(16, 32, 64), (300, 96, 80)]
EPILOGUES = ["default", "relu", "gelu"]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _ab(rng, m, k, n):
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _epilogue64(c, epilogue):
    if epilogue == "relu":
        return np.maximum(c, 0.0)
    if epilogue == "gelu":
        return 0.5 * c * (1.0 + np.tanh(0.7978845608028654 * (c + 0.044715 * c * c * c)))
    return c


def _cplx(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gemm_fft(rng, shape, epilogue):
    m, k, n = shape
    a, b = _ab(rng, m, k, n)
    yr, yi = port.gemm_fft(from_numpy(a), from_numpy(b), epilogue)
    assert yr.dtype == yi.dtype == F32 and yr.shape == yi.shape == (m, n)
    want = np.fft.fft(_epilogue64(a.astype(np.float64) @ b.astype(np.float64), epilogue), axis=-1)
    assert rel_l2(_cplx((yr, yi)), want) < F64_TOL
    got_ref = _cplx(ref.gemm_fft(jnp.asarray(a), jnp.asarray(b), epilogue))
    assert rel_l2(_cplx((yr, yi)), got_ref) < REF_TOL


def test_gemm_fft_reference_case(rng):
    """tests/test_heuristics_grading_apps.py:144-149 in the port."""
    a = rng.normal(size=(16, 32)).astype(np.float32)
    b = rng.normal(size=(32, 64)).astype(np.float32)
    yr, yi = port.gemm_fft(from_numpy(a), from_numpy(b))
    want = np.fft.fft(a @ b, axis=-1)
    assert rel_l2(_cplx((yr, yi)), want) < 1e-5


@pytest.mark.parametrize("epilogue", ["gelu_bias", "relu_bias", "Relu", "none"])
def test_unknown_epilogue_applies_nothing_c14(rng, epilogue):
    a, b = _ab(rng, 16, 32, 64)
    plain = port.gemm_fft(from_numpy(a), from_numpy(b))
    got = port.gemm_fft(from_numpy(a), from_numpy(b), epilogue)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    want = np.fft.fft(a.astype(np.float64) @ b.astype(np.float64), axis=-1)
    assert rel_l2(_cplx(ref.gemm_fft(jnp.asarray(a), jnp.asarray(b), epilogue)), want) < F64_TOL
    assert rel_l2(_cplx(got), want) < F64_TOL


@pytest.mark.parametrize("k, n", [(32, 1025), (1025, 32)])
def test_gemm_fft_refuses_n_or_k_above_1024(k, n):
    msg = "fused gemm_fft holds B and the DFT matrices in VMEM: n, k <= 1024"
    with pytest.raises(RefInvalidValueError, match=msg):
        ref.gemm_fft(jnp.ones((4, k), jnp.float32), jnp.ones((k, n), jnp.float32))
    with pytest.raises(InvalidValueError, match=msg):
        port.gemm_fft(torch.ones((4, k)), torch.ones((k, n)))


def test_gemm_fft_inner_dims():
    with pytest.raises(InvalidValueError, match="inner dims must match"):
        port.gemm_fft(torch.ones((4, 8)), torch.ones((9, 16)))


def test_gemm_fft_casts_to_f32(rng):
    a, b = _ab(rng, 16, 32, 64)
    got = port.gemm_fft(from_numpy(a).double(), from_numpy(b).to(torch.bfloat16), "relu")
    want = port.gemm_fft(from_numpy(a), from_numpy(b).to(torch.bfloat16).float(), "relu")
    assert got[0].dtype == F32 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The compositions (tests/test_heuristics_grading_apps.py:144-182)

@pytest.mark.parametrize("epilogue", ["default", "gelu", "gelu_bias"])
def test_gemm_fft_composed(rng, epilogue):
    a, b = _ab(rng, 48, 32, 96)
    got = port.gemm_fft_composed(from_numpy(a), from_numpy(b), epilogue)
    assert got[0].dtype == F32 and got[0].shape == (48, 96)
    # pallas_matmul's gelu_bias is GELU with no bias given
    c = _epilogue64(a.astype(np.float64) @ b.astype(np.float64), epilogue.split("_")[0])
    assert rel_l2(_cplx(got), np.fft.fft(c, axis=-1)) < F64_TOL
    want = _cplx(ref.gemm_fft_composed(jnp.asarray(a), jnp.asarray(b), epilogue))
    assert rel_l2(_cplx(got), want) < REF_TOL


def test_gemm_gemm(rng):
    a = rng.normal(size=(8, 16)).astype(np.float32)
    b = rng.normal(size=(16, 24)).astype(np.float32)
    c = rng.normal(size=(24, 8)).astype(np.float32)
    got = port.gemm_gemm(from_numpy(a), from_numpy(b), from_numpy(c)).numpy()
    np.testing.assert_allclose(got, a @ b @ c, rtol=1e-4, atol=1e-4 * np.abs(a @ b @ c).max())
    np.testing.assert_allclose(got, np.asarray(ref.gemm_gemm(a, b, c)), rtol=1e-5, atol=1e-5)


def test_fft_convolution_3d(rng):
    x = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    k = rng.normal(size=(8, 16, 32)).astype(np.float32)
    got = port.fft_convolution_nd(from_numpy(x), from_numpy(k), naxes=3).numpy()
    want = np.real(np.fft.ifftn(np.fft.fftn(x, axes=(-3, -2, -1))
                                * np.fft.fftn(k, axes=(-3, -2, -1)), axes=(-3, -2, -1)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
    assert rel_l2(got, np.asarray(ref.fft_convolution_nd(jnp.asarray(x), jnp.asarray(k)))) < 1e-5


def test_fft_convolution_nd_checks_trailing_dims():
    with pytest.raises(InvalidValueError, match="kernel trailing dims must match x"):
        port.fft_convolution_nd(torch.ones((2, 8, 8)), torch.ones((4, 8)), naxes=2)


@pytest.mark.parametrize("n", [128, 256])
def test_fft_convolution(rng, n):
    """n = 128 is the reference test's (matmul engine); n = 256 takes the
    planar kernel route (dif_fft's plain version on the CPU)."""
    x = rng.normal(size=(4, n)).astype(np.float32)
    k = np.zeros(n, np.float32)
    k[:5] = rng.normal(size=5)
    got = port.fft_convolution(from_numpy(x), from_numpy(k)).numpy()
    want = np.stack([np.real(np.fft.ifft(np.fft.fft(r) * np.fft.fft(k))) for r in x])
    assert rel_l2(got, want) < 1e-4
    assert rel_l2(got, np.asarray(ref.fft_convolution(jnp.asarray(x), jnp.asarray(k)))) < 1e-5


# ---------------------------------------------------------------------------
# A model of the card kernels' arithmetic (csrc/dx_fused.cu)

TC_THREADS, SIMT_THREADS = 384, 256   # each route's block
TC_RING_BYTES = 3 * (64 * 128 + 2 * 256 * 128)   # the tensor-core route's ring, which then holds C
SMEM_MAX = 232448


def _c_bytes(n, rows):
    """Shared memory of ``rows`` rows of C as the passes read them, and the
    spare row (csrc/dx_fused.cu::row_floats)."""
    return 4 * (rows + 1) * (2 * fft_kernels._four_step_plane_floats(n, 1, False) + 1)


def _four_step_model():
    """tests/test_torch_fft_four_step.py, which imports this module: imported
    when a test runs."""
    import test_torch_fft_four_step
    return test_torch_fft_four_step


def _parse_plan(words, n, block_threads):
    """The plan's passes as csrc/dx_fused.cu::parse_plan reads them, as a
    FourStepLaunch of one lane, or None where the C side refuses them."""
    if len(words) < 4 or words[0] != n:
        return None
    threads, points, npasses = words[1:4]
    radices = tuple(words[4:])
    pow2 = n >= 4 and n & (n - 1) == 0
    if (points != (fft_kernels.FOUR_STEP_POINTS_POW2 if pow2 else port.GEMM_FFT_POINTS_MIXED)
            or not 0 <= npasses < 15 or len(radices) != npasses
            or not 1 <= threads <= block_threads or threads * points < n
            or math.prod(radices) != n or any(r < 2 for r in radices)
            or (pow2 and (not radices or any(r not in (2, 4, 8, 16) for r in radices)))):
        return None
    return fft_kernels.FourStepLaunch(n, 1, threads, 1, points, radices)


def _model_rows_fft(c, launch, roots):
    """The passes on the f32 rows of C (imaginary part 0): y as (yr, yi)."""
    w = (roots[:, 0] + 1j * roots[:, 1]).astype(np.complex64)
    y = _four_step_model()._model_launch(launch, c.numpy().astype(np.complex64), w, False)
    return (torch.from_numpy(np.ascontiguousarray(y.real)),
            torch.from_numpy(np.ascontiguousarray(y.imag)))


def _model_gemm_fft(a, b, epilogue, route):
    """B9 on the card: C = epilogue(A B), the tensor-core route's 3xTF32
    stages from Bᵀ's planes or the SIMT route's f32 products, then the row
    FFT's passes on ``_gemm_fft_plan(n)`` and the forward root table."""
    n = b.shape[1]
    if route == "tc":
        c = _model_tf32x3(a, *tf32x3._split_tf32_plain(b, transpose=True))
    else:
        c = fft_kernels._mm(a, b)
    launch = _parse_plan(list(port._gemm_fft_plan(n).words), n,
                         TC_THREADS if route == "tc" else SIMT_THREADS)
    return _model_rows_fft(port._epilogue(c, epilogue), launch, fft_kernels._roots(n, False))


@pytest.mark.parametrize("epilogue", ["gelu", "relu"])
@pytest.mark.parametrize("n", [64, 80, 97, 256, 1024])
def test_model_of_the_kernels_arithmetic(rng, n, epilogue):
    m, k = 24, 96
    a, b = _ab(rng, m, k, n)
    route = port._gemm_fft_route(n)
    got = _cplx(_model_gemm_fft(from_numpy(a), from_numpy(b), epilogue, route))
    want = np.fft.fft(_epilogue64(a.astype(np.float64) @ b.astype(np.float64), epilogue), axis=-1)
    assert rel_l2(got, want) < F64_TOL
    assert rel_l2(got, _cplx(ref.gemm_fft(jnp.asarray(a), jnp.asarray(b), epilogue))) < 1e-5
    if route == "tc":   # the SIMT route's product on the same plan
        simt = _cplx(_model_gemm_fft(from_numpy(a), from_numpy(b), epilogue, "simt"))
        assert rel_l2(simt, want) < F64_TOL


@pytest.mark.parametrize("mkn, route", [((32768, 256, 256), "tc"), ((16, 32, 64), "tc"),
                                        ((300, 96, 80), "tc"), ((4096, 1024, 1024), "simt"),
                                        ((8, 8, 257), "simt"), ((8, 8, 1), "tc")])
def test_route_rule(mkn, route):
    assert port._gemm_fft_route(mkn[2]) == route


def test_plan_words_for_every_n():
    """The wrapper's plan passes the C side's checks on its route's block for
    every n ≤ 1024, and its rows fit the route's shared memory; the main
    shape's is two radix-16 passes."""
    for n in range(1, 1025):
        words = list(port._gemm_fft_plan(n).words)
        threads = TC_THREADS if port._gemm_fft_route(n) == "tc" else SIMT_THREADS
        launch = _parse_plan(words, n, threads)
        assert launch is not None and launch.radices == fft_kernels._radix_passes(n), n
        assert _parse_plan(words, n, SIMT_THREADS) is not None, n
        if port._gemm_fft_route(n) == "tc":
            assert _c_bytes(n, 64) <= TC_RING_BYTES, n
        assert 4 * 16 * 1024 + _c_bytes(n, 16) <= SMEM_MAX, n   # the SIMT route at k = 1024
    assert list(port._gemm_fft_plan(256).words) == [256, 16, 16, 2, 16, 16]
    assert list(port._gemm_fft_plan(97).words) == [97, 4, 32, 1, 97]
    assert port._gemm_fft_plan(80) is port._gemm_fft_plan(80)


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

class _EmulatedLib(_EmulatedCompLib):
    """Adds tml_gemm_fft's and tml_gemm_fft_simt's contracts, computed on the
    CPU from the raw arguments by ``_model_gemm_fft``'s steps: A through its
    pointer and row stride, Bᵀ's planes (the tensor-core route) or B, the
    root table, the plan words read as the C side reads them, the epilogue
    from its code (1 relu, 2 gelu, else none), and the C side's refusals (n
    above 256 or 1024, k above 1024, a row stride TMA refuses)."""

    def __init__(self, rc=0):
        super().__init__(rc)
        self.fused_calls = []

    def _rows_fft(self, c, tab, plan, plan_len, yr, yi, m, n, act, block_threads):
        launch = _parse_plan(list(plan[:plan_len]), n, block_threads)
        if launch is None:
            return 1
        roots = _view(tab, F32, (n, 2), (2, 1)).numpy()
        out = _model_rows_fft(port._epilogue(c, {1: "relu", 2: "gelu"}.get(act, "default")),
                              launch, roots)
        _view(yr, F32, (m, n), (n, 1)).copy_(out[0])
        _view(yi, F32, (m, n), (n, 1)).copy_(out[1])
        return 0

    def tml_gemm_fft(self, a, lda, b, bt_hi, bt_lo, ldt, tab, plan, plan_len, yr, yi, m, k, n,
                     act, stream):
        self.fused_calls.append(dict(route="tc", m=m, k=k, n=n, act=act, lda=lda))
        if self.rc or not (0 <= k <= 1024 and 1 <= n <= 256) or lda < k or ldt < k or lda % 4 \
                or ldt % 4 or any(p % 16 for p in (a, bt_hi, bt_lo)) \
                or _c_bytes(n, 64) > TC_RING_BYTES:
            return self.rc or 1
        # the split the C side launches first: Bᵀ's planes into the scratch
        planes = tf32x3._split_tf32_plain(_view(b, F32, (k, n), (n, 1)).clone(), transpose=True)
        for dst, plane in zip((bt_hi, bt_lo), planes):
            _view(dst, F32, (n, k), (ldt, 1)).copy_(plane)
        planes = [_view(p, F32, (n, k), (ldt, 1)).clone() for p in (bt_hi, bt_lo)]
        c = _model_tf32x3(_view(a, F32, (m, k), (lda, 1)).clone(), *planes)
        return self._rows_fft(c, tab, plan, plan_len, yr, yi, m, n, act, TC_THREADS)

    def tml_gemm_fft_simt(self, a, b, tab, plan, plan_len, yr, yi, m, k, n, act, stream):
        self.fused_calls.append(dict(route="simt", m=m, k=k, n=n, act=act))
        if self.rc or not (0 <= k <= 1024 and 1 <= n <= 1024):
            return self.rc or 1
        c = fft_kernels._mm(_view(a, F32, (m, k), (k, 1)).clone(),
                            _view(b, F32, (k, n), (n, 1)).clone())
        return self._rows_fft(c, tab, plan, plan_len, yr, yi, m, n, act, SIMT_THREADS)


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    monkeypatch.setattr(port, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _route_counts():
    return (port._gemm_fft.launches, port._gemm_fft.tc_launches, port._gemm_fft.simt_launches,
            tf32x3.split_tf32.launches)


@pytest.mark.parametrize("epilogue, act", [("default", 0), ("relu", 1), ("gelu", 2),
                                           ("gelu_bias", 0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_branch_gemm_fft(emulated, rng, shape, epilogue, act):
    m, k, n = shape
    a, b = (from_numpy(t) for t in _ab(rng, m, k, n))
    before = _route_counts()
    got = port.gemm_fft(a.t().contiguous().t(), b, epilogue)   # a strided view is copied
    assert [x - y for x, y in zip(_route_counts(), before)] == [1, 1, 0, 1]
    assert emulated.fused_calls == [dict(route="tc", m=m, k=k, n=n, act=act, lda=k)]
    want = _model_gemm_fft(a, b, epilogue, "tc")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    wr, wi = (torch.from_numpy(t) for t in fft_kernels._dft_mats(n, False))
    assert rel_l2(_cplx(got), _cplx(port._gemm_fft_plain(a, b, wr, wi, epilogue))) < 1e-6


@pytest.mark.parametrize("shape", SHAPES + [(20, 40, 1024), (9, 16, 1000)])
def test_cuda_branch_simt_route(emulated, rng, shape):
    """The SIMT route: its own count, B as it lies, no split; taken by the
    size rule above n = 256 and on request below."""
    m, k, n = shape
    a, b = (from_numpy(t) for t in _ab(rng, m, k, n))
    route = None if n > 256 else "simt"
    before = _route_counts()
    got = port._gemm_fft(a, b, "gelu", route=route)
    assert [x - y for x, y in zip(_route_counts(), before)] == [1, 0, 1, 0]
    assert emulated.fused_calls == [dict(route="simt", m=m, k=k, n=n, act=2)]
    want = _model_gemm_fft(a, b, "gelu", "simt")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    f64 = np.fft.fft(_epilogue64(a.double().numpy() @ b.double().numpy(), "gelu"), axis=-1)
    assert rel_l2(_cplx(got), f64) < F64_TOL


def test_cuda_branch_ragged_k_copies_a(emulated, rng):
    """k = 30: TMA's row pitch needs a multiple of 4, so A goes as a copy
    with row stride 32; Bᵀ's planes are padded by the split."""
    a, b = (from_numpy(t) for t in _ab(rng, 40, 30, 48))
    got = port.gemm_fft(a, b, "relu")
    assert emulated.fused_calls == [dict(route="tc", m=40, k=30, n=48, act=1, lda=32)]
    want = np.fft.fft(_epilogue64(a.double().numpy() @ b.double().numpy(), "relu"), axis=-1)
    assert rel_l2(_cplx(got), want) < F64_TOL


def test_cuda_branch_refuses_a_route_the_size_rule_excludes(emulated):
    with pytest.raises(InvalidValueError, match="no gemm_fft route 'tc' at n = 300"):
        port._gemm_fft(torch.ones((4, 8)), torch.ones((8, 300)), "gelu", route="tc")
    assert emulated.fused_calls == []


def test_cuda_branch_raises_on_launch_failure(emulated):
    emulated.rc = 9
    before = _route_counts()
    with pytest.raises(ExecutionError, match="tml_gemm_fft: CUDA error 9"):
        port.gemm_fft(torch.ones((4, 8)), torch.ones((8, 16)))
    with pytest.raises(ExecutionError, match="tml_gemm_fft_simt: CUDA error 9"):
        port.gemm_fft(torch.ones((4, 8)), torch.ones((8, 300)))
    assert _route_counts()[:3] == before[:3]


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(port, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        port.gemm_fft(torch.ones((4, 8)), torch.ones((8, 16)))


def test_cpu_takes_the_plain_version_without_launch(rng):
    a, b = (from_numpy(t) for t in _ab(rng, 16, 32, 64))
    before = (port._gemm_fft.launches, gemm.pallas_matmul.launches, stockham.dif_fft.launches)
    port.gemm_fft(a, b, "gelu")
    port.gemm_fft_composed(a, b)
    port.fft_convolution(torch.ones((2, 256)), torch.ones(256))
    assert (port._gemm_fft.launches, gemm.pallas_matmul.launches,
            stockham.dif_fft.launches) == before


# ---------------------------------------------------------------------------
# The slice as a whole

def test_slice_against_reference(rng):
    """gemm_fft and gemm_fft_composed on one product, both packages, under
    "gelu": the fused and composed spellings agree with each other too."""
    a, b = _ab(rng, 64, 128, 128)
    fused = _cplx(port.gemm_fft(from_numpy(a), from_numpy(b), "gelu"))
    composed = _cplx(port.gemm_fft_composed(from_numpy(a), from_numpy(b), "gelu"))
    assert rel_l2(fused, composed) < 1e-6
    assert rel_l2(fused, _cplx(ref.gemm_fft(jnp.asarray(a), jnp.asarray(b), "gelu"))) < REF_TOL
    assert rel_l2(composed, _cplx(ref.gemm_fft_composed(jnp.asarray(a), jnp.asarray(b), "gelu"))
                  ) < REF_TOL
