"""Parity of tpumathlib_torch.dx.gemm with tpumathlib.dx.gemm.

The reference's Pallas kernel runs in interpret mode on the CPU, as its own
tests run it; the port's wrapper takes its plain version for CPU tensors.
Both get the same seeded numpy inputs. Tolerances (max-scaled, as
core.check.allclose): f32 output 1e-5 (the same f32 products summed in
another order); bf16 output 1e-2 (one output ulp); int8 exact.

The CUDA branch of the dispatch is exercised here with the kernel library
replaced: once by a loader that fails (the error must propagate), once by a
CPU emulation of the C entry point that reads the operands through the
pointers, strides and dtype codes the wrapper passes.
"""

import contextlib
import ctypes
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpumathlib.dx import gemm as ref_gemm
from tpumathlib_torch.core import device as core_device
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import (
    ExecutionError, InvalidValueError, NotSupportedError)
from tpumathlib_torch.core.interop import from_numpy, from_reference, to_numpy
from tpumathlib_torch.dx import cuda_utils, gemm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_arrays_on_the_cpu(monkeypatch):
    """The port's default device is the card (core.device.default_device);
    these tests turn host arrays into containers on the CPU."""
    monkeypatch.setattr(core_device, "default_device", lambda: torch.device("cpu"))


NP = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "i8": np.int8}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "i8": jnp.int8}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8}


def _pair(x, dt):
    """The same values as a JAX array and a CPU tensor."""
    x = np.asarray(x).astype(NP[dt])
    return jnp.asarray(x), from_numpy(x)


def _close(got, want, tol):
    err = max_scaled_err(got, np.asarray(want).astype(np.float64))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 512), (100, 50, 70)])
def test_matmul_basic(dt, shape, rng):
    m, n, k = shape
    ja, ta = _pair(rng.normal(size=(m, k)), dt)
    jb, tb = _pair(rng.normal(size=(k, n)), dt)
    want = ref_gemm.pallas_matmul(ja, jb, out_dtype=jnp.float32)
    got = gemm.pallas_matmul(ta, tb, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, want, 1e-5)


def test_matmul_alpha_beta_c(rng):
    ja, ta = _pair(rng.normal(size=(64, 128)), "f32")
    jb, tb = _pair(rng.normal(size=(128, 96)), "f32")
    jc, tc = _pair(rng.normal(size=(64, 96)), "f32")
    want = ref_gemm.pallas_matmul(ja, jb, jc, alpha=2.5, beta=-0.5)
    got = gemm.pallas_matmul(ta, tb, tc, alpha=2.5, beta=-0.5)
    _close(got, want, 1e-5)


def test_matmul_batched(rng):
    ja, ta = _pair(rng.normal(size=(3, 64, 32)), "f32")
    jb, tb = _pair(rng.normal(size=(3, 32, 48)), "f32")
    _close(gemm.pallas_matmul(ta, tb), ref_gemm.pallas_matmul(ja, jb), 1e-5)


def test_matmul_broadcast_batch(rng):
    """A stride-0 batch of B and a C broadcast over the batch."""
    ja, ta = _pair(rng.normal(size=(2, 40, 24)), "f32")
    jb, tb = _pair(rng.normal(size=(24, 16)), "f32")
    jc, tc = _pair(rng.normal(size=(40, 16)), "f32")
    want = ref_gemm.pallas_matmul(ja, jnp.broadcast_to(jb, (2, 24, 16)), jc, beta=0.5)
    got = gemm.pallas_matmul(ta, tb.expand(2, 24, 16), tc, beta=0.5)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("epi", gemm._EPILOGUES)
def test_matmul_epilogues(epi, rng):
    m, n, k = 64, 128, 64
    ja, ta = _pair(rng.normal(size=(m, k)), "f32")
    jb, tb = _pair(rng.normal(size=(k, n)), "f32")
    jbias, tbias = _pair(rng.normal(size=(n,)), "f32")
    aux = "aux" in epi
    want = ref_gemm.pallas_matmul(ja, jb, bias=jbias, epilogue=epi, return_aux=aux)
    got = gemm.pallas_matmul(ta, tb, bias=tbias, epilogue=epi, return_aux=aux)
    if aux:
        _close(got[0], want[0], 1e-5)
        _close(got[1], want[1], 1e-5)
        assert got[1].dtype == torch.float32
    else:
        _close(got, want, 1e-5)


def test_matmul_gelu_bias_bf16_out(rng):
    ja, ta = _pair(rng.normal(size=(96, 64)), "bf16")
    jb, tb = _pair(rng.normal(size=(64, 80)), "bf16")
    jbias, tbias = _pair(rng.normal(size=(80,)), "f32")
    want = ref_gemm.pallas_matmul(ja, jb, bias=jbias, epilogue="gelu_bias",
                                  out_dtype=jnp.bfloat16)
    got = gemm.pallas_matmul(ta, tb, bias=tbias, epilogue="gelu_bias",
                             out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, 1e-2)


def test_matmul_explicit_config(rng):
    ja, ta = _pair(rng.normal(size=(256, 256)), "f32")
    jb, tb = _pair(rng.normal(size=(256, 256)), "f32")
    want = ref_gemm.pallas_matmul(ja, jb, config=ref_gemm.MatmulConfig(128, 128, 128))
    got = gemm.pallas_matmul(ta, tb, config=gemm.MatmulConfig(128, 128, 16))
    _close(got, want, 1e-5)
    # the reference's TPU tile is not a compiled config of the port
    with pytest.raises(NotSupportedError):
        gemm.pallas_matmul(ta, tb, config=from_reference(ref_gemm.MatmulConfig(128, 128, 128)))


def test_matmul_int8_exact(rng):
    ja, ta = _pair(rng.integers(-4, 5, size=(64, 128)), "i8")
    jb, tb = _pair(rng.integers(-4, 5, size=(128, 64)), "i8")
    want = np.asarray(ref_gemm.pallas_matmul(ja, jb, out_dtype=jnp.float32))
    got = to_numpy(gemm.pallas_matmul(ta, tb, out_dtype=torch.float32))
    np.testing.assert_array_equal(got, want)


def test_matmul_promotes_operands(rng):
    """bf16 @ f32 promotes to f32, as jnp.dot does."""
    ja, ta = _pair(rng.normal(size=(32, 48)), "bf16")
    jb, tb = _pair(rng.normal(size=(48, 16)), "f32")
    want = ref_gemm.pallas_matmul(ja, jb, out_dtype=jnp.float32)
    _close(gemm.pallas_matmul(ta, tb, out_dtype=torch.float32), want, 1e-5)


@pytest.mark.parametrize("epi", ["default", "relu_bias", "gelu_aux", "gelu_aux_bias"])
def test_apply_epilogue_matches_reference(epi, rng):
    acc = rng.normal(size=(8, 12)).astype(np.float32) * 3
    bias = rng.normal(size=(12,)).astype(np.float32)
    rd, raux = ref_gemm.apply_epilogue(jnp.asarray(acc), epi, jnp.asarray(bias))
    pd, paux = gemm.apply_epilogue(torch.from_numpy(acc), epi, torch.from_numpy(bias))
    _close(pd, rd, 1e-6)
    _close(paux, raux, 1e-6)


def test_argument_checks(rng):
    a, b = torch.ones(4, 5), torch.ones(5, 3)
    with pytest.raises(InvalidValueError):
        gemm.pallas_matmul(a, b, epilogue="swish")
    with pytest.raises(InvalidValueError):
        gemm.pallas_matmul(a, torch.ones(4, 3))
    with pytest.raises(InvalidValueError):
        gemm.pallas_matmul(torch.ones(2, 4, 5), torch.ones(3, 5, 3))


def test_configs():
    cfgs = gemm.default_configs(torch.bfloat16)
    assert list(cfgs) == list(gemm._CONFIGS) and len(cfgs) == 3
    assert all(c.smem_bytes() <= gemm.SMEM_LIMIT for c in cfgs)
    assert gemm.MatmulConfig() in cfgs
    assert gemm._pick_config(4096, 4096, 4096) == gemm.MatmulConfig(128, 128, 16)
    assert gemm._pick_config(100, 50, 70) == gemm.MatmulConfig(64, 64, 16)
    # a batch fills the card as well as rows do
    assert gemm._pick_config(128, 128, 64, batch=256) == gemm.MatmulConfig(128, 128, 16)


def test_cpu_takes_plain_version_without_launch(rng):
    before = gemm.pallas_matmul.launches
    gemm.pallas_matmul(torch.ones(8, 8), torch.ones(8, 8))
    assert gemm.pallas_matmul.launches == before


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    """For CUDA tensors the wrapper launches or raises: a failing build or
    load must reach the caller, never fall back to the plain version."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(gemm, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        gemm.pallas_matmul(torch.ones(8, 8), torch.ones(8, 8))


def test_loader_needs_cuda_device():
    with pytest.raises(ExecutionError, match="CUDA device"):
        cuda_utils.load_kernels()


_CODE_DTYPE = {v: k for k, v in gemm._DTYPE_CODE.items()}


def _view(ptr, dtype, size, stride):
    """A tensor over raw CPU memory at ``ptr`` with the given layout."""
    extent = 1 + sum((s - 1) * st for s, st in zip(size, stride))
    buf = (ctypes.c_uint8 * (extent * dtype.itemsize)).from_address(ptr)
    flat = torch.frombuffer(buf, dtype=torch.uint8).view(dtype)
    return torch.as_strided(flat, size, stride)


class _EmulatedLib:
    """tml_gemm_epilogue's contract, computed on the CPU from the raw
    arguments: pointers, sizes, strides, codes."""

    def __init__(self):
        self.calls = []

    def tml_gemm_epilogue(self, a, b, c, bias, d, aux, nb, m, n, k, strides, alpha, beta,
                          act, ab_code, c_code, d_code, config, stream):
        s = list(strides)
        self.calls.append(dict(strides=s, act=act, ab=ab_code, c=c_code, d=d_code,
                               config=config, shape=(nb, m, n, k)))
        abt = _CODE_DTYPE[ab_code]
        acc = alpha * (_view(a, abt, (nb, m, k), s[0:3]).float()
                       @ _view(b, abt, (nb, k, n), s[3:6]).float())
        if c:
            acc = acc + beta * _view(c, _CODE_DTYPE[c_code], (nb, m, n), s[6:9]).float()
        if bias:
            acc = acc + _view(bias, torch.float32, (n,), (1,))
        if aux:
            _view(aux, torch.float32, (nb, m, n), (s[9], s[10], 1)).copy_(acc)
        if act:
            acc = gemm.apply_epilogue(acc, {1: "relu", 2: "gelu"}[act])[0]
        _view(d, _CODE_DTYPE[d_code], (nb, m, n), (s[9], s[10], 1)).copy_(acc)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    monkeypatch.setattr(gemm, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("case", ["plain", "transposed_a", "broadcast", "aux_bf16"])
def test_cuda_branch_marshalling(emulated, case, rng):
    """The pointers, strides and codes the wrapper hands the C entry point
    describe its operands: an emulation reading only those gives the plain
    version's result, and the launch is counted once."""
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    kw, c = {}, None
    if case == "plain":
        a, b = t(33, 20), t(20, 17)
    elif case == "transposed_a":
        a, b = t(20, 33).mT, t(20, 17).to(torch.bfloat16)
        kw = dict(bias=t(17), epilogue="gelu_bias")
    elif case == "broadcast":
        a, b, c = t(3, 33, 20), t(20, 17).expand(3, 20, 17), t(33, 17).to(torch.bfloat16)
        kw = dict(alpha=1.5, beta=-0.5, epilogue="relu")
    else:
        a, b = t(2, 33, 20).to(torch.bfloat16), t(2, 20, 17).to(torch.bfloat16)
        kw = dict(bias=t(17), epilogue="relu_aux_bias", return_aux=True,
                  out_dtype=torch.bfloat16)
    before = gemm.pallas_matmul.launches
    got = gemm.pallas_matmul(a, b, c, **kw)
    assert gemm.pallas_matmul.launches == before + 1 and len(emulated.calls) == 1
    want = gemm._pallas_matmul_plain(
        a, b, c, out_dtype=kw.pop("out_dtype", a.dtype), **kw)
    if kw.get("return_aux"):
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, to_numpy(want), 1e-6 if got.dtype == torch.float32 else 1e-2)
    call = emulated.calls[0]
    if case == "transposed_a":   # promoted to f32; the view is read in place
        assert call["ab"] == 0 and call["strides"][1:3] == [1, 33] and call["act"] == 2
    if case == "broadcast":      # B and C broadcast by stride 0, C read as bf16
        assert call["strides"][3] == 0 and call["strides"][6] == 0 and call["c"] == 1
    if case == "aux_bf16":
        assert (call["ab"], call["d"], call["act"]) == (1, 1, 1)


def test_cuda_branch_rejects_unsupported_dtypes(emulated):
    with pytest.raises(NotSupportedError):
        gemm.pallas_matmul(torch.ones(4, 4, dtype=torch.float64), torch.ones(4, 4))
    with pytest.raises(NotSupportedError):
        gemm.pallas_matmul(torch.ones(4, 4), torch.ones(4, 4), out_dtype=torch.int32)
    assert emulated.calls == []
