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
- The CUDA branch of ``gemm_fft`` against ``_EmulatedLib``, the codec
  emulation of tests/test_torch_dx_comp.py extended with tml_gemm_fft: the
  epilogue code, the DFT matrices on the device, the launch count.
"""

import contextlib
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
from tpumathlib_torch.dx import cuda_utils, gemm
from tpumathlib_torch.dx import fused as port
from tpumathlib_torch.fft import kernels as fft_kernels, stockham
from test_torch_dx_comp import _EmulatedLib as _EmulatedCompLib
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
# The CUDA branch against an emulation of the C entry point

class _EmulatedLib(_EmulatedCompLib):
    """Adds tml_gemm_fft's contract, computed on the CPU from the raw
    arguments: the operands through their pointers and sizes, the epilogue
    from its code (0 none, 1 relu, 2 gelu), and the C side's refusal of n or
    k above 1024."""

    def __init__(self, rc=0):
        super().__init__(rc)
        self.fused_calls = []

    def tml_gemm_fft(self, a, b, wr, wi, yr, yi, m, k, n, act, stream):
        self.fused_calls.append(dict(m=m, k=k, n=n, act=act))
        if self.rc or not (0 <= k <= 1024 and 0 <= n <= 1024):
            return self.rc or 1
        w = [_view(t, F32, (n, n), (n, 1)).clone() for t in (wr, wi)]
        ref_w = [torch.from_numpy(t) for t in fft_kernels._dft_mats(n, False)]
        assert torch.equal(w[0], ref_w[0]) and torch.equal(w[1], ref_w[1])
        out = port._gemm_fft_plain(_view(a, F32, (m, k), (k, 1)).clone(),
                                   _view(b, F32, (k, n), (n, 1)).clone(), *w,
                                   {0: "default", 1: "relu", 2: "gelu"}[act])
        _view(yr, F32, (m, n), (n, 1)).copy_(out[0])
        _view(yi, F32, (m, n), (n, 1)).copy_(out[1])
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


@pytest.mark.parametrize("epilogue, act", [("default", 0), ("relu", 1), ("gelu", 2),
                                           ("gelu_bias", 0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_branch_gemm_fft(emulated, rng, shape, epilogue, act):
    m, k, n = shape
    a, b = (from_numpy(t) for t in _ab(rng, m, k, n))
    before = port._gemm_fft.launches
    got = port.gemm_fft(a.t().contiguous().t(), b, epilogue)   # a strided view is copied
    assert port._gemm_fft.launches == before + 1
    assert emulated.fused_calls == [dict(m=m, k=k, n=n, act=act)]
    wr, wi = (torch.from_numpy(t) for t in fft_kernels._dft_mats(n, False))
    want = port._gemm_fft_plain(a, b, wr, wi, epilogue)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cuda_branch_raises_on_launch_failure(emulated):
    emulated.rc = 9
    before = port._gemm_fft.launches
    with pytest.raises(ExecutionError, match="tml_gemm_fft: CUDA error 9"):
        port.gemm_fft(torch.ones((4, 8)), torch.ones((8, 16)))
    assert port._gemm_fft.launches == before


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
