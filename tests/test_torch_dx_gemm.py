"""Parity of tpumathlib_torch.dx.gemm with tpumathlib.dx.gemm.

The reference's Pallas kernel runs in interpret mode on the CPU, as its own
tests run it; the port's wrapper takes its plain version for CPU tensors.
Both get the same seeded numpy inputs. Tolerances (max-scaled, as
core.check.allclose): f32 output 1e-5 (the same f32 products summed in
another order); bf16 output 1e-2 (one output ulp); int8 exact.

The CUDA branch of the dispatch is exercised here with the kernel library
replaced: once by a loader that fails (the error must propagate), once by a
CPU emulation of the C entry points (tml_gemm_epilogue, the SIMT route, and
tml_gemm_wgmma, the tensor-core route) that reads the operands through the
pointers, strides, dtype codes and config id the wrapper passes. The
routing rule between the two kernels is pinned case by case.
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
from tpumathlib_torch.dx import cuda_utils, gemm, tf32x3

torch.set_num_threads(1)

F32 = torch.float32


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


def _aux_close(got, want, dtype):
    """aux on the 3xTF32 route (f32 operands) within 1e-6 of the plain
    version's f32 product; on the others, whose emulation sums as the plain
    version does, bit for bit."""
    if dtype == torch.float32:
        _close(got, to_numpy(want), 1e-6)
    else:
        assert torch.equal(got, want)


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
    """One compiled table a route: the tensor-core route's for bf16 and f16,
    the 3xTF32 route's for f32, the SIMT route's for int8 (and f32 only by
    an explicit config), all three with no dtype."""
    cfgs = gemm.default_configs(torch.bfloat16)
    assert list(cfgs) == list(gemm._TC_CONFIGS) and len(cfgs) == 2
    assert list(gemm.default_configs(torch.float16)) == list(gemm._TC_CONFIGS)
    assert all(c.route == "wgmma" and c.bk == 64 for c in cfgs)
    f32 = gemm.default_configs(torch.float32)
    assert list(f32) == list(gemm._TF32X3_CONFIGS) and len(f32) == 1
    assert f32[0] == gemm.MatmulConfig(128, 128, 32, "tf32x3", 3)
    simt = gemm.default_configs(torch.int8)
    assert list(simt) == list(gemm._CONFIGS) and len(simt) == 3
    assert all(c.route == "simt" for c in simt)
    assert list(gemm.default_configs()) == (list(gemm._CONFIGS) + list(gemm._TC_CONFIGS)
                                            + list(gemm._TF32X3_CONFIGS))
    assert all(c.smem_bytes() <= gemm.SMEM_LIMIT for c in gemm.default_configs())
    # 4 stages of (128 + 256) x 64 16-bit values and the ring's alignment
    assert gemm._TC_CONFIGS[0].smem_bytes() == 4 * 2 * 64 * 384 + 1024
    # 3 stages of two f32 planes of (128 + 128) x 32 (or 4 of A in f32 and
    # B's planes: the same bytes), and the alignment
    assert gemm._TF32X3_CONFIGS[0].smem_bytes() == 3 * 2 * 4 * 32 * 256 + 1024 == \
        4 * 4 * 32 * (128 + 2 * 128) + 1024
    assert gemm.MatmulConfig() in simt
    assert gemm._pick_config(4096, 4096, 4096) == gemm.MatmulConfig(128, 128, 16)
    assert gemm._pick_config(100, 50, 70) == gemm.MatmulConfig(64, 64, 16)
    # a batch fills the card as well as rows do
    assert gemm._pick_config(128, 128, 64, batch=256) == gemm.MatmulConfig(128, 128, 16)
    # the tensor-core route: 128 x 256 tiles where they fill the card, else 128 x 128
    assert gemm._pick_config(4096, 4096, 4096, torch.bfloat16) == gemm._TC_CONFIGS[0]
    assert gemm._pick_config(1024, 2048, 4096, torch.bfloat16) == gemm._TC_CONFIGS[1]
    assert gemm._pick_config(128, 256, 64, torch.float16, batch=132) == gemm._TC_CONFIGS[0]
    assert gemm._pick_config(4096, 4096, 4096, torch.float32) == gemm._TF32X3_CONFIGS[0]
    assert gemm._pick_config(4096, 4096, 4096, torch.int8) == gemm.MatmulConfig(128, 128, 16)


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


def _major(ptr, rows, cols, sb, sr, sc, batch):
    """The tensor-core route's layout rule (csrc/gemm_wgmma.cu ``major_of``),
    written out from its statement: 0 row-major, 1 column-major, None
    refused."""
    if ptr % 16:
        return None
    if sc == 1 and sr % 8 == 0 and sr >= max(cols, 1):
        major, extent = 0, rows * sr
    elif sr == 1 and sc % 8 == 0 and sc >= max(rows, 1):
        major, extent = 1, cols * sc
    else:
        return None
    return major if batch == 1 or sb == 0 or (sb % 8 == 0 and sb >= extent) else None


_INVALID_CONFIGURATION = 9   # cudaErrorInvalidConfiguration


def _grid_refused(nb, m, config) -> bool:
    """Both kernels' launch refuses a grid of more than 65535 blocks along
    y (row tiles) or z (the batch)."""
    return nb > 65535 or -(-m // config.bm) > 65535


def _tensor_core_read(p):
    """A plane as the tensor cores read it: TF32, the low 13 bits dropped."""
    return (p.contiguous().view(torch.int32) & -0x2000).view(F32)


class Tf32x3Emulation:
    """``tml_split_tf32``'s and ``tml_gemm_tf32x3``'s contracts on the CPU,
    from the raw arguments; 1 (cudaErrorInvalidValue) for what the C
    entries refuse. Calls are recorded in ``tf32_calls``."""

    def _record(self, **kw):
        self.__dict__.setdefault("tf32_calls", []).append(kw)

    def tml_split_tf32(self, x, ldx, hi, lo, ldo, rows, cols, flags, stream):
        transpose = bool(flags & tf32x3.TRANSPOSE)
        self._record(kind="split", shape=(rows, cols), ld=(ldx, ldo), flags=flags, stream=stream)
        if (not (x and hi and lo) or rows < 0 or cols < 0 or not 0 <= flags <= 3 or ldx < cols
                or ldo < (rows if transpose else cols)):
            return 1
        if not (rows and cols):
            return 0
        src = _view(x, F32, (rows, cols), (ldx, 1)).clone()
        h, l = tf32x3._split_tf32_plain(src, transpose=transpose,
                                        unit_lower=bool(flags & tf32x3.UNIT_LOWER))
        _view(hi, F32, tuple(h.shape), (ldo, 1)).copy_(h)
        _view(lo, F32, tuple(l.shape), (ldo, 1)).copy_(l)
        return 0

    def tml_gemm_tf32x3(self, ah, al, lda, bh, bl, ldb, c, ldc, d, ldd, m, n, k, alpha, beta,
                        stream):
        split_a = not al   # A itself in f32, split in the kernel's registers
        self._record(kind="gemm", shape=(m, n, k), ld=(lda, ldb, ldc, ldd), c=c, d=d,
                     alpha=alpha, beta=beta, split_a=split_a, stream=stream)
        if not d or m < 0 or n < 0 or k < 0 or ldd < n or (c and ldc < n):
            return 1
        if not (m and n):
            return 0
        if k and (any(not p or p % 16 for p in (ah, ah if split_a else al, bh, bl)) or lda < k
                  or ldb < k or lda % 4 or ldb % 4):
            return 1
        if split_a:
            a = tf32x3._split_tf32_plain(_view(ah, F32, (m, k), (lda, 1)).clone())
        else:
            a = [_tensor_core_read(_view(p, F32, (m, k), (lda, 1))) for p in (ah, al)]
        b = [_tensor_core_read(_view(p, F32, (n, k), (ldb, 1))) for p in (bh, bl)]
        cc = _view(c, F32, (m, n), (ldc, 1)).clone() if c else None
        acc = tf32x3._gemm_tf32x3_plain(*a, *b, cc, alpha=alpha, beta=beta)
        _view(d, F32, (m, n), (ldd, 1)).copy_(acc)
        return 0

    def tml_gemm_tf32x3_epilogue(self, ah, al, bh, bl, c, bias, d, aux, nb, m, n, k, strides,
                                 alpha, beta, act, c_code, d_code, stream):
        """B1's f32 route: the 3xTF32 product of A (its planes, or A in f32
        where ``al`` is null) and of Bᵀ's planes, each (batch, rows, k) at
        the strides given (a batch stride of 0 or one matrix: shared), under
        tml_gemm_epilogue's epilogue; refuses (1) what the C entry refuses,
        and a grid past 65535 blocks along the batch or the row tiles."""
        s = list(strides[:9])
        split_a = not al
        self.__dict__.setdefault("calls", []).append(dict(
            kernel="tf32x3", strides=s, act=act, c=c_code, d=d_code, shape=(nb, m, n, k),
            split_a=split_a, stream=stream, alpha=alpha, beta=beta,
            ptrs=dict(a=ah, a_lo=al, b=bh, b_lo=bl, c=c, d=d, aux=aux)))
        if (not d or min(nb, m, n, k) < 0 or not 0 <= act <= 2 or not 0 <= c_code <= 3
                or not 0 <= d_code <= 2):
            return 1
        if not (nb and m and n):
            return 0
        if s[8] < n:
            return 1
        if nb > 65535 or -(-m // 128) > 65535:
            return _INVALID_CONFIGURATION
        a_batch, b_batch = nb > 1 and s[0] != 0, nb > 1 and s[2] != 0
        if k and (any(not p or p % 16 for p in (ah, ah if split_a else al, bh, bl))
                  or s[1] < k or s[3] < k or s[1] % 4 or s[3] % 4
                  or (a_batch and s[0] % 4) or (b_batch and s[2] % 4)):
            return 1
        acc = torch.zeros((nb, m, n))
        if k:
            a_view = lambda p: _view(p, F32, (nb if a_batch else 1, m, k),  # noqa: E731
                                     (s[0] if a_batch else 0, s[1], 1))
            a = (tf32x3._split_tf32_plain(a_view(ah).clone()) if split_a
                 else [_tensor_core_read(a_view(p)) for p in (ah, al)])
            b = [_tensor_core_read(_view(p, F32, (nb if b_batch else 1, n, k),
                                         (s[2] if b_batch else 0, s[3], 1))) for p in (bh, bl)]
            acc = tf32x3._gemm_tf32x3_plain(*a, *b).expand(nb, m, n)
        acc = alpha * acc
        if c:
            acc = acc + beta * _view(c, _CODE_DTYPE[c_code], (nb, m, n), s[4:7]).float()
        if bias:
            acc = acc + _view(bias, F32, (n,), (1,))
        if aux:
            _view(aux, F32, (nb, m, n), (s[7], s[8], 1)).copy_(acc)
        if act:
            acc = gemm.apply_epilogue(acc, {1: "relu", 2: "gelu"}[act])[0]
        _view(d, _CODE_DTYPE[d_code], (nb, m, n), (s[7], s[8], 1)).copy_(acc)
        return 0


class _EmulatedLib(Tf32x3Emulation):
    """tml_gemm_epilogue's and tml_gemm_wgmma's contracts, computed on the
    CPU from the raw arguments: pointers, sizes, strides, codes, config; a
    grid past 65535 blocks along the batch or the row tiles is refused, as
    the kernels' launches refuse it."""

    def __init__(self):
        self.calls = []

    def tml_gemm_epilogue(self, a, b, c, bias, d, aux, nb, m, n, k, strides, alpha, beta,
                          act, ab_code, c_code, d_code, config, stream):
        assert 0 <= config < len(gemm._CONFIGS)
        if _grid_refused(nb, m, gemm._CONFIGS[config]):
            return _INVALID_CONFIGURATION
        s = list(strides)
        self.calls.append(dict(kernel="simt", strides=s, act=act, ab=ab_code, c=c_code,
                               d=d_code, config=config, shape=(nb, m, n, k),
                               ptrs=dict(a=a, b=b, c=c, d=d, aux=aux)))
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

    def tml_gemm_wgmma(self, a, b, c, bias, d, aux, nb, m, n, k, strides, alpha, beta,
                       act, ab_code, c_code, d_code, config, stream):
        """The same arguments; refuses (cudaErrorInvalidValue, 1) what the
        tensor-core kernel does not take: other dtypes, configs or layouts."""
        s = list(strides)
        majors = (_major(a, m, k, *s[0:3], nb), _major(b, k, n, *s[3:6], nb))
        if ab_code not in (1, 2) or not 0 <= config < len(gemm._TC_CONFIGS) or None in majors:
            return 1
        if _grid_refused(nb, m, gemm._TC_CONFIGS[config]):
            return _INVALID_CONFIGURATION
        before = len(self.calls)
        rc = self.tml_gemm_epilogue(a, b, c, bias, d, aux, nb, m, n, k, strides, alpha, beta,
                                    act, ab_code, c_code, d_code, 0, stream)
        self.calls[before].update(kernel="wgmma", config=config, majors=majors)
        return rc

    def tml_error_string(self, rc):
        return b"invalid argument" if rc == 1 else b"emulated error"


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    monkeypatch.setattr(gemm, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("case", ["plain", "transposed_a", "broadcast", "aux_bf16",
                                  "tensor_core"])
def test_cuda_branch_marshalling(emulated, case, rng):
    """The pointers, strides and codes the wrapper hands the C entry point
    describe its operands: an emulation reading only those gives the plain
    version's result, and the launch is counted once. f32 operands (also
    bf16 @ f32, promoted) take the 3xTF32 route: A in place where TMA reads
    it, else its planes; Bᵀ's planes, split once."""
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
    elif case == "aux_bf16":
        a, b = t(2, 33, 20).to(torch.bfloat16), t(2, 20, 17).to(torch.bfloat16)
        kw = dict(bias=t(17), epilogue="relu_aux_bias", return_aux=True,
                  out_dtype=torch.bfloat16)
    else:   # 16-byte rows: the tensor-core route, A transposed, C broadcast
        a, b = t(2, 24, 40).to(torch.bfloat16).mT, t(2, 24, 48).to(torch.bfloat16)
        c = t(40, 48).to(torch.float16)
        kw = dict(bias=t(48), epilogue="gelu_aux_bias", return_aux=True, beta=2.0,
                  out_dtype=torch.float32)
    before = gemm.pallas_matmul.launches
    got = gemm.pallas_matmul(a, b, c, **kw)
    assert gemm.pallas_matmul.launches == before + 1 and len(emulated.calls) == 1
    # 20-element bf16 rows are not 16-byte multiples: aux_bf16 takes SIMT
    route = {"tensor_core": "wgmma", "aux_bf16": "simt"}.get(case, "tf32x3")
    assert emulated.calls[0]["kernel"] == route
    want = gemm._pallas_matmul_plain(
        a, b, c, out_dtype=kw.pop("out_dtype", a.dtype), **kw)
    if kw.get("return_aux"):
        _aux_close(got[1], want[1], a.dtype)
        got, want = got[0], want[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, to_numpy(want), 1e-6 if got.dtype == torch.float32 else 1e-2)
    call = emulated.calls[0]
    splits = [(x["shape"], x["flags"]) for x in emulated.__dict__.get("tf32_calls", [])]
    if case == "plain":          # A in place (80-byte rows); Bᵀ by the transposed split
        assert call["split_a"] and splits == [((20, 17), tf32x3.TRANSPOSE)]
        assert call["strides"][:4] == [0, 20, 0, 20] and call["act"] == 0
    if case == "transposed_a":   # promoted to f32; A's planes by the transposed split
        assert not call["split_a"] and call["act"] == 2
        assert splits == [((20, 33), tf32x3.TRANSPOSE), ((20, 17), tf32x3.TRANSPOSE)]
    if case == "broadcast":      # A's batch in place, B split once (stride 0), C read as bf16
        assert call["split_a"] and splits == [((20, 17), tf32x3.TRANSPOSE)]
        assert call["strides"][:3] == [660, 20, 0] and call["strides"][4] == 0
        assert call["c"] == 1 and call["shape"] == (3, 33, 17, 20)
    if case == "aux_bf16":
        assert (call["ab"], call["d"], call["act"]) == (1, 1, 1)
    if case == "tensor_core":    # A column-major, B row-major; C f16 read by stride 0
        assert call["majors"] == (1, 0) and call["strides"][0:3] == [24 * 40, 1, 40]
        assert (call["ab"], call["c"], call["d"], call["act"]) == (1, 2, 0, 2)
        assert call["strides"][6] == 0 and call["shape"] == (2, 40, 48, 24)


def test_cuda_branch_rejects_unsupported_dtypes(emulated):
    with pytest.raises(NotSupportedError):
        gemm.pallas_matmul(torch.ones(4, 4, dtype=torch.float64), torch.ones(4, 4))
    with pytest.raises(NotSupportedError):
        gemm.pallas_matmul(torch.ones(4, 4), torch.ones(4, 4), out_dtype=torch.int32)
    assert emulated.calls == []


def _bf16(rng, *shape, dtype=torch.bfloat16):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)


def _routing_case(case, rng):
    """(a, b, c, keyword arguments) of each routing case."""
    t = lambda *shape: _bf16(rng, *shape)  # noqa: E731
    if case == "bf16 row-major":
        return t(40, 24), t(24, 32), None, dict(bias=t(32).float(), epilogue="gelu_bias")
    if case == "f16 row-major":
        return t(40, 24).half(), t(24, 32).half(), None, dict(out_dtype=torch.float32)
    if case == "bf16 transposed A":
        return t(24, 40).mT, t(24, 32), None, {}
    if case == "bf16 transposed B":
        return t(40, 24), t(32, 24).mT, None, dict(out_dtype=torch.float16)
    if case == "bf16 both transposed, aux, C":
        return (t(24, 40).mT, t(32, 24).mT, t(40, 32),
                dict(epilogue="relu_aux", return_aux=True, beta=0.5))
    if case == "bf16 batch 3, broadcast B":
        return t(3, 40, 24), t(24, 32).expand(3, 24, 32), None, dict(out_dtype=torch.float32)
    if case == "bf16 K=70":   # 140-byte rows
        return t(40, 70), t(70, 32), None, {}
    if case == "bf16 misaligned view":   # the base 2 bytes past a 16-byte boundary
        return t(40 * 24 + 1)[1:].view(40, 24), t(24, 32), None, {}
    if case == "bf16 row stride not covering":   # a view whose rows overlap
        return torch.as_strided(t(40 * 8 + 24), (40, 24), (8, 1)), t(24, 32), None, {}
    if case == "bf16 batch stride 4":
        return torch.as_strided(t(3 * 4 + 40 * 24), (3, 40, 24), (4, 24, 1)), t(3, 24, 32), None, {}
    if case == "f32":
        return t(40, 24).float(), t(24, 32).float(), None, {}
    if case == "f32 transposed A and B, C":
        return (t(24, 40).float().mT, t(32, 24).float().mT, t(40, 32).float(),
                dict(beta=-1.0, epilogue="gelu_aux_bias", bias=t(32).float(), return_aux=True))
    if case == "f32 K=70, f16 D":   # 280-byte rows: A split
        return t(40, 70).float(), t(70, 32).float(), None, dict(out_dtype=torch.float16)
    if case == "f32 batch 3, distinct B":
        return t(3, 40, 24).float(), t(3, 24, 32).float(), None, dict(epilogue="relu")
    if case == "f32 explicit SIMT config":
        return t(40, 24).float(), t(24, 32).float(), None, dict(config=gemm._CONFIGS[0])
    if case == "int8":
        i8 = lambda *shape: torch.from_numpy(rng.integers(-4, 5, size=shape).astype(np.int8))  # noqa: E731
        return i8(40, 24), i8(24, 32), None, dict(out_dtype=torch.float32)
    if case == "bf16 explicit SIMT config":
        return t(40, 24), t(24, 32), None, dict(config=gemm._CONFIGS[1])
    assert case == "bf16 explicit tensor-core config"
    return t(40, 24), t(24, 32), None, dict(config=gemm._TC_CONFIGS[1])


_ROUTES = {
    "bf16 row-major": "wgmma", "f16 row-major": "wgmma", "bf16 transposed A": "wgmma",
    "bf16 transposed B": "wgmma", "bf16 both transposed, aux, C": "wgmma",
    "bf16 batch 3, broadcast B": "wgmma", "bf16 explicit tensor-core config": "wgmma",
    "bf16 K=70": "simt", "bf16 misaligned view": "simt", "bf16 row stride not covering": "simt",
    "bf16 batch stride 4": "simt", "f32": "tf32x3", "f32 transposed A and B, C": "tf32x3",
    "f32 K=70, f16 D": "tf32x3", "f32 batch 3, distinct B": "tf32x3",
    "f32 explicit SIMT config": "simt", "int8": "simt", "bf16 explicit SIMT config": "simt",
}
_COUNTS = (gemm.pallas_matmul, gemm._gemm_wgmma, gemm._gemm_tf32x3, gemm._gemm_simt)


@pytest.mark.parametrize("case", list(_ROUTES))
def test_cuda_branch_routing(emulated, case, rng):
    """The routing rule: bf16/f16 operands whose layout the tensor-core
    route takes go to tml_gemm_wgmma, f32 operands to
    tml_gemm_tf32x3_epilogue, everything else (int8, 16-bit rows that are
    not 16-byte multiples, misaligned or overlapping views, an explicit
    SIMT config) to tml_gemm_epilogue. Exactly one launch, counted in the
    total and in its route's counter; the emulation (which checks the
    layout rules on the raw strides) gives the plain version's result."""
    a, b, c, kw = _routing_case(case, rng)
    route = _ROUTES[case]
    before = [f.launches for f in _COUNTS]
    got = gemm.pallas_matmul(a, b, c, **kw)
    grew = [f.launches - x for f, x in zip(_COUNTS, before)]
    assert grew == [1, route == "wgmma", route == "tf32x3", route == "simt"]
    assert [call["kernel"] for call in emulated.calls] == [route]
    kw.pop("config", None)
    want = gemm._pallas_matmul_plain(a, b, c, out_dtype=kw.pop("out_dtype", a.dtype), **kw)
    if kw.get("return_aux"):
        _aux_close(got[1], want[1], a.dtype)
        got, want = got[0], want[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, to_numpy(want), 1e-6 if got.dtype == torch.float32 else 1e-2)
    if route == "wgmma" and case != "bf16 explicit tensor-core config":
        # the config follows the table of the route: 128 x 128 for a small problem
        assert emulated.calls[0]["config"] == 1


@pytest.mark.parametrize("case", ["f32", "bf16 K=70", "bf16 misaligned view"])
def test_cuda_branch_tensor_core_config_refuses(emulated, case, rng):
    """A tensor-core config names its route: for operands that route does
    not take it raises instead of launching another kernel."""
    a, b, _, _ = _routing_case(case, rng)
    with pytest.raises(NotSupportedError, match="tensor-core config"):
        gemm.pallas_matmul(a, b, config=gemm._TC_CONFIGS[0])
    assert emulated.calls == []


_FAILING_CASE = {"wgmma": ("bf16 row-major", "tml_gemm_wgmma", "gemm_wgmma"),
                 "tf32x3": ("f32", "tml_gemm_tf32x3_epilogue", "gemm_tf32x3_epilogue"),
                 "tf32x3 split": ("f32", "tml_split_tf32", "tml_split_tf32"),
                 "simt": ("int8", "tml_gemm_epilogue", "gemm_epilogue")}


@pytest.mark.parametrize("route", list(_FAILING_CASE))
def test_cuda_branch_failure_raises_on_each_route(monkeypatch, route, rng):
    """A loader that fails, and a launch that fails (on the 3xTF32 route
    also its split), reach the caller on every route; no route gives way to
    another or to the plain version."""
    case, name, what = _FAILING_CASE[route]
    a, b, _, kw = _routing_case(case, rng)

    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(gemm, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        gemm.pallas_matmul(a, b, **kw)

    lib = _EmulatedLib()
    monkeypatch.setattr(lib, name, lambda *args: 716)   # misaligned address
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    before = gemm.pallas_matmul.launches
    with pytest.raises(ExecutionError, match=what):
        gemm.pallas_matmul(a, b, **kw)
    assert gemm.pallas_matmul.launches == before and lib.calls == []


_OUT = {"f32": (torch.float32, jnp.float32, 1e-5), "bf16": (torch.bfloat16, jnp.bfloat16, 1e-2),
        "f16": (torch.float16, jnp.float16, 1e-2)}


@pytest.mark.parametrize("out", list(_OUT))
@pytest.mark.parametrize("epi", gemm._EPILOGUES)
def test_tf32x3_route_against_reference(emulated, epi, out, rng):
    """B1's f32 route as the 3xTF32 kernel computes it (the emulation: A
    split, Bᵀ's planes, lo·hi + hi·lo + hi·hi, then the epilogue) against
    the reference's pallas_matmul in interpret mode on the same inputs, C
    in the sum with beta: 1e-5 max-scaled for f32 D, 1e-2 for bf16 and f16
    (an output ulp); aux, the f32 value before the activation, at 1e-5."""
    m, n, k = 70, 136, 200
    ja, ta = _pair(rng.normal(size=(m, k)), "f32")
    jb, tb = _pair(rng.normal(size=(k, n)), "f32")
    jc, tc = _pair(rng.normal(size=(m, n)), "f32")
    jbias, tbias = _pair(rng.normal(size=(n,)), "f32")
    tdt, jdt, tol = _OUT[out]
    aux = "aux" in epi
    kw = dict(epilogue=epi, alpha=0.75, beta=-0.5, return_aux=aux)
    want = ref_gemm.pallas_matmul(ja, jb, jc, jbias, out_dtype=jdt, **kw)
    got = gemm.pallas_matmul(ta, tb, tc, tbias, out_dtype=tdt, **kw)
    assert [call["kernel"] for call in emulated.calls] == ["tf32x3"]
    if aux:
        _close(got[1], want[1], 1e-5)
        got, want = got[0], want[0]
    assert got.dtype == tdt
    _close(got.float(), np.asarray(want).astype(np.float32), tol)


@pytest.mark.parametrize("m, n, k, route", [
    (3968, 128, 128, "simt"), (128, 3968, 128, "simt"), (128, 128, 128, "simt"),
    (256, 256, 256, "simt"), (1024, 512, 256, "simt"), (1536, 1408, 128, "tf32x3"),
    (3968, 3968, 128, "tf32x3"), (3840, 256, 256, "tf32x3"), (128, 128, 257, "tf32x3"),
    (4224, 128, 64, "simt"), (4288, 128, 64, "tf32x3")])
def test_into_size_rule(m, n, k, route):
    """The host loops' size rule: SIMT for K ≤ 256 where its 64 × 64 tiles
    make one wave (≤ 132), the 3xTF32 route for every other product."""
    assert gemm._into_route(m, n, k) == route


def test_emulated_layout_rule_matches_wrapper(rng):
    """The wrapper's rule (``_tc_layout``) and the C side's, as the
    emulation states it, agree on every case of the routing test."""
    for case in _ROUTES:
        a, b, _, _ = _routing_case(case, rng)
        for t, rows, cols in ((a, a.shape[-2], a.shape[-1]), (b, b.shape[-2], b.shape[-1])):
            t3 = t.reshape(-1, rows, cols)
            got = gemm._tc_layout(t3)
            want = _major(t3.data_ptr(), rows, cols, *t3.stride(), t3.shape[0]) is not None
            assert got == want, case


# ---------------------------------------------------------------------------
# ROADMAP C21: grids past 65535 blocks go in pieces

@pytest.mark.parametrize("route", ["wgmma", "tf32x3", "simt"])
def test_cuda_branch_splits_a_batch_past_the_grid_c21(emulated, route, rng):
    """A batch of 70 000 products takes two launches, of 65535 and 4465
    matrices; the second's A, B and D start 65535 batch strides on (on the
    3xTF32 route B's are the batch strides of Bᵀ's planes, 16 rows of 8).
    The emulation refuses a batch past 65535, as the kernels' launches do."""
    nb, dt = 70_000, (torch.bfloat16 if route == "wgmma" else torch.float32)
    a, b = _bf16(rng, nb, 8, 8, dtype=dt), _bf16(rng, nb, 8, 16, dtype=dt)
    before = [f.launches for f in _COUNTS]
    kw = dict(config=gemm._CONFIGS[0]) if route == "simt" else {}
    got = gemm.pallas_matmul(a, b, out_dtype=torch.float32, **kw)
    assert [f.launches - x for f, x in zip(_COUNTS, before)] == [
        2, 2 * (route == "wgmma"), 2 * (route == "tf32x3"), 2 * (route == "simt")]
    first, second = emulated.calls
    assert [first["kernel"], second["kernel"]] == [route, route]
    assert first["shape"] == (65535, 8, 16, 8) and second["shape"] == (4465, 8, 16, 8)
    size = dt.itemsize
    assert second["ptrs"]["a"] - first["ptrs"]["a"] == 65535 * 64 * size
    assert second["ptrs"]["b"] - first["ptrs"]["b"] == 65535 * 128 * size
    assert second["ptrs"]["d"] - first["ptrs"]["d"] == 65535 * 128 * 4
    assert first["strides"] == second["strides"]
    want = gemm._pallas_matmul_plain(a, b, out_dtype=torch.float32)
    assert got.shape == want.shape == (nb, 8, 16)
    _close(got, to_numpy(want), 1e-6)


def _tall_case(route, rng):
    """(a, b, c, keyword arguments, the config's rows a tile) of a product
    one row tile past 65535: the tensor-core route at 128 rows a tile (A an
    M-major view with K = 2, B (2, 1) with 16-byte rows), the 3xTF32 route
    at 128 (A of 16-byte rows, read in place), the SIMT route at 64 (config
    2), the last two with C and aux, whose pieces are offset too."""
    if route == "wgmma":
        m = 65535 * 128 + 72
        a = _bf16(rng, 2, m + 8 - m % 8)[:, :m].mT
        b = torch.as_strided(_bf16(rng, 16), (2, 1), (8, 1))
        return a, b, None, dict(out_dtype=torch.bfloat16), 128
    if route == "tf32x3":
        m = 65535 * 128 + 100
        a, b = _bf16(rng, m, 4, dtype=torch.float32), _bf16(rng, 4, 1, dtype=torch.float32)
        c = _bf16(rng, m, 1, dtype=torch.float32)
        return a, b, c, dict(beta=0.5, epilogue="relu_aux", return_aux=True), 128
    m = 65535 * 64 + 100
    a, b = _bf16(rng, m, 1, dtype=torch.float32), _bf16(rng, 1, 1, dtype=torch.float32)
    c = _bf16(rng, m, 1, dtype=torch.float32)
    return a, b, c, dict(config=gemm._CONFIGS[2], beta=0.5, epilogue="relu_aux",
                         return_aux=True), 64


@pytest.mark.parametrize("route", ["wgmma", "tf32x3", "simt"])
def test_cuda_branch_splits_rows_past_the_grid_c21(emulated, route, rng):
    """A product of more than 65535 row tiles takes two launches; the
    second's A, C, D and aux start 65535 tiles of rows on, its B is the
    first's, and together they give the plain version's result."""
    a, b, c, kw, bm = _tall_case(route, rng)
    m = a.shape[0]
    before = gemm.pallas_matmul.launches
    got = gemm.pallas_matmul(a, b, c, **kw)
    assert gemm.pallas_matmul.launches == before + 2
    first, second = emulated.calls
    assert [first["kernel"], second["kernel"]] == [route, route]
    k = a.shape[1]
    assert first["shape"] == (1, 65535 * bm, 1, k) and second["shape"] == (1, m - 65535 * bm, 1, k)
    rows = 65535 * bm
    assert second["ptrs"]["a"] - first["ptrs"]["a"] == rows * a.stride(0) * a.element_size()
    assert second["ptrs"]["b"] == first["ptrs"]["b"]
    d_size = 2 if route == "wgmma" else 4
    assert second["ptrs"]["d"] - first["ptrs"]["d"] == rows * d_size
    if c is not None:
        assert second["ptrs"]["c"] - first["ptrs"]["c"] == rows * 4
        assert second["ptrs"]["aux"] - first["ptrs"]["aux"] == rows * 4
    kw.pop("config", None)
    want = gemm._pallas_matmul_plain(a, b, c, out_dtype=kw.pop("out_dtype", a.dtype), **kw)
    if kw.get("return_aux"):
        _aux_close(got[1], want[1], a.dtype)
        got, want = got[0], want[0]
    assert got.dtype == want.dtype and got.shape == want.shape == (m, 1)
    _close(got, to_numpy(want), 1e-6 if got.dtype == torch.float32 else 1e-2)


def test_grid_pieces_cover_each_block_once():
    """The pieces are every pair of a batch range and a row range, the
    ranges tiling the batch and the rows with no gap or overlap, each
    within 65535 blocks."""
    for nb, m, bm in ((1, 1, 128), (65535, 65535 * 64, 64), (65536, 1, 128),
                      (2, 65535 * 128 + 1, 128), (131071, 3 * 65535 * 64, 64)):
        pieces = [(range(nb)[bs], range(m)[ms]) for bs, ms in gemm._grid_pieces(nb, m, bm)]
        batches = list(dict.fromkeys(b for b, _ in pieces))
        rows = list(dict.fromkeys(r for _, r in pieces))
        assert pieces == [(b, r) for b in batches for r in rows]
        assert [i for b in batches for i in b] == list(range(nb))
        assert [i for r in rows for i in r] == list(range(m))
        assert all(len(b) <= 65535 for b in batches)
        assert all(r.start % bm == 0 and -(-len(r) // bm) <= 65535 for r in rows)
