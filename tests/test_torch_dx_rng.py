"""Parity of tpumathlib_torch.dx.rng (kernels B10a ``random_uniform_kernel``
and B10b ``dropout_matmul_kernel``) with the reference.

The reference's kernels seed the TPU's own PRNG, and off the TPU they draw
from ``jax.random`` (tpumathlib/dx/rng.py:33-37, :56-60), so no stream of
theirs can be matched bit for bit. The port's stream is the reference's
``rand.PhiloxGenerator(seed)``, so:
- B10a's plain version equals the reference's Philox words under the TPU
  kernel's 24-bit map, ((w & 0xFFFFFF) + 1) · 2⁻²⁴, bit for bit, at seeds 0,
  42, −1 and 2³¹ − 1 and shapes (1,), (3, 5), (64, 128), (1000, 7);
- the reference's own checks of tests/test_image.py:199-217 pass on the
  port, and a two-sample KS test against the reference's interpret-mode
  stream gives p > 1e-4;
- the dropout contract: the mask is exactly ``random_uniform_kernel(seed,
  (m, n)) > rate``, kept values are (a @ b) / (1 − rate) within 1e-5 of the
  largest value of the reference's own product, rate 0 keeps everything,
  for f32 and bf16 operands and ragged shapes.
The CUDA branch of both wrappers runs against ``_EmulatedLib``, an emulation
of tml_random_uniform and tml_dropout_matmul from their raw arguments.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from tpumathlib.dx import rng as ref
from tpumathlib.rand import PhiloxGenerator as RefPhilox
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.core.interop import from_numpy
from tpumathlib_torch.dx import cuda_utils, tf32x3
from tpumathlib_torch.dx import rng as port
from test_torch_dx_fused import _EmulatedLib as _EmulatedFusedLib
from test_torch_dx_gemm import _tensor_core_read, _view

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
SEEDS = [0, 42, -1, 2**31 - 1]
SHAPES = [(1,), (3, 5), (64, 128), (1000, 7)]
TOL = 1e-5   # kept values, of the largest |a @ b| / (1 − rate)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _ref_uniforms(seed, n):
    """The reference's Philox words of ``seed`` under the 24-bit map, in numpy."""
    w = np.asarray(RefPhilox(seed).random_bits(n)).astype(np.int64)
    return ((w & 0xFFFFFF) + 1).astype(np.float32) * np.float32(2.0**-24)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_equals_reference_philox(seed, shape):
    u = port.random_uniform_kernel(seed, shape, device="cpu")
    assert u.dtype == F32 and u.shape == shape
    np.testing.assert_array_equal(u.numpy().reshape(-1), _ref_uniforms(seed, int(np.prod(shape))))
    assert float(u.min()) > 0.0 and float(u.max()) <= 1.0


def test_reference_inkernel_rng_checks(rng):
    """tests/test_image.py:199-217 on the port."""
    u = port.random_uniform_kernel(42, (64, 128), device="cpu").numpy()
    assert 0.0 < u.min() and u.max() <= 1.0
    assert abs(u.mean() - 0.5) < 0.05
    np.testing.assert_array_equal(u, port.random_uniform_kernel(42, (64, 128), device="cpu").numpy())
    a = rng.normal(size=(32, 64)).astype(np.float32)
    b = rng.normal(size=(64, 16)).astype(np.float32)
    d = port.dropout_matmul_kernel(from_numpy(a), from_numpy(b), 7, rate=0.5).numpy()
    full = a @ b
    assert 0.3 < (d == 0).mean() < 0.7
    nz = d != 0
    assert np.allclose(d[nz], 2 * full[nz], rtol=1e-4)


def test_uniform_distribution_matches_reference_stream():
    """Two-sample KS of the port's stream against the reference's
    interpret-mode ``jax.random`` stream: the same distribution."""
    ours = port.random_uniform_kernel(3, (200, 50), device="cpu").numpy().reshape(-1)
    theirs = np.asarray(ref.random_uniform_kernel(3, (200, 50))).reshape(-1)
    assert scipy.stats.ks_2samp(ours, theirs).pvalue > 1e-4
    assert scipy.stats.kstest(ours, "uniform").pvalue > 1e-4


def test_uniform_arguments():
    np.testing.assert_array_equal(port.random_uniform_kernel(5, 7, device="cpu").numpy(),
                                  _ref_uniforms(5, 7))
    np.testing.assert_array_equal(
        port.random_uniform_kernel(torch.tensor(5), (7,), device=torch.device("cpu")).numpy(),
        _ref_uniforms(5, 7))
    assert port.random_uniform_kernel(1, (0, 3), device="cpu").shape == (0, 3)


def _dropout_case(rng, m, k, n, dtype):
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    ta, tb = from_numpy(a).to(dtype), from_numpy(b).to(dtype)
    return a, b, ta, tb


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.9])
@pytest.mark.parametrize("m, k, n", [(32, 64, 16), (300, 96, 77), (5, 3, 1)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_dropout_contract(rng, m, k, n, dtype, rate):
    """mask == uniforms > rate, bit for bit; kept values against the
    reference's own product (interpret mode), f32 out."""
    _, _, ta, tb = _dropout_case(rng, m, k, n, dtype)
    seed = 11
    d = port.dropout_matmul_kernel(ta, tb, seed, rate)
    assert d.dtype == F32 and d.shape == (m, n)
    keep = port.random_uniform_kernel(seed, (m, n), device="cpu") > rate
    acc = np.asarray(jnp.matmul(jnp.asarray(ta.float().numpy(), jnp.float32),
                                jnp.asarray(tb.float().numpy(), jnp.float32),
                                preferred_element_type=jnp.float32))
    want = acc / np.float32(1.0 - rate)
    dn = d.numpy()
    assert (dn[~keep.numpy()] == 0).all()
    assert np.abs(dn[keep.numpy()] - want[keep.numpy()]).max(initial=0.0) <= TOL * np.abs(want).max()
    assert ((dn != 0) == keep.numpy()).all()      # no kept product is exactly 0 here
    if rate == 0.0:
        assert keep.all()


def test_dropout_checks():
    with pytest.raises(InvalidValueError, match="inner dims must match"):
        port.dropout_matmul_kernel(torch.ones(2, 3), torch.ones(4, 2), 0)
    with pytest.raises(InvalidValueError, match="2-D operands"):
        port.dropout_matmul_kernel(torch.ones(2, 3, 1), torch.ones(3, 2), 0)


def test_dropout_mixed_and_f16_operands(rng):
    """Operands other than (f32, f32) and (bf16, bf16) take the f32 product,
    which holds their values exactly."""
    a, b, _, _ = _dropout_case(rng, 16, 8, 12, F32)
    ta, tb = from_numpy(a).to(torch.float16), from_numpy(b).to(BF16)
    got = port.dropout_matmul_kernel(ta, tb, 3, 0.2)
    want = port.dropout_matmul_kernel(ta.float(), tb.float(), 3, 0.2)
    assert torch.equal(got, want)


def test_reference_dropout_shape_and_rate_zero(rng):
    """The reference's interpret-mode dropout keeps everything at rate 0,
    as the port does: both are the product itself."""
    a, b, ta, tb = _dropout_case(rng, 24, 40, 10, F32)
    r = np.asarray(ref.dropout_matmul_kernel(jnp.asarray(a), jnp.asarray(b), 5, rate=0.0))
    p = port.dropout_matmul_kernel(ta, tb, 5, 0.0).numpy()
    assert r.shape == p.shape and np.abs(p - r).max() <= TOL * np.abs(r).max()


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

class _EmulatedLib(_EmulatedFusedLib):
    """Adds the contracts of dx_rng.cu's tml_random_uniform and
    gemm_tf32x3.cu's tml_dropout_matmul, computed on the CPU from the raw
    arguments: the seed from its two key words, the output's 16-byte
    alignment, the operands' planes through their pointers and row strides
    (read as the tensor cores read them), 1 − rate as passed."""

    def __init__(self, rc=0):
        super().__init__(rc)
        self.rng_calls = []

    def tml_random_uniform(self, out, n, key0, key1, stream):
        self.rng_calls.append(dict(kind="uniform", n=n, key=(key0, key1)))
        if self.rc or out % 16:
            return self.rc or 1
        seed = key0 | (key1 << 32)
        _view(out, F32, (n,), (1,)).copy_(port._random_uniform_plain(seed, (n,), "cpu"))
        return 0

    def tml_dropout_matmul(self, ah, al, lda, bh, bl, ldb, out, ldd, m, n, k, key0, key1, rate,
                           den, exact, stream):
        """The 3xTF32 product (one product of hi planes with ``exact``) of A
        (its planes, or A in f32 where ``al`` is null) and Bᵀ's planes,
        then the mask of the uniforms of (key0, key1) over the flat (m, n)
        output, the kept values divided by ``den`` in f32."""
        split_a = not al
        self.rng_calls.append(dict(kind="dropout", shape=(m, k, n), key=(key0, key1),
                                   rate=rate, den=den, exact=exact, split_a=split_a,
                                   ld=(lda, ldb, ldd)))
        if self.rc:
            return self.rc
        if not out or min(m, n, k) < 0 or ldd < n or exact not in (0, 1) or (exact and al):
            return 1
        if not (m and n):
            return 0
        if k and (any(not p or p % 16 for p in (ah, ah if split_a else al, bh,
                                                 bh if exact else bl))
                  or lda < k or ldb < k or lda % 4 or ldb % 4):
            return 1
        acc = torch.zeros((m, n))
        if k:
            av = lambda p: _view(p, F32, (m, k), (lda, 1))  # noqa: E731
            bv = lambda p: _tensor_core_read(_view(p, F32, (n, k), (ldb, 1)))  # noqa: E731
            a_hi, a_lo = (tf32x3._split_tf32_plain(av(ah).clone()) if split_a
                          else [_tensor_core_read(av(p)) for p in (ah, al)])
            if exact:
                acc = tf32x3._gemm_tf32x3_plain(a_hi, torch.zeros_like(a_hi), bv(bh),
                                                torch.zeros((n, k)))
            else:
                acc = tf32x3._gemm_tf32x3_plain(a_hi, a_lo, bv(bh), bv(bl))
        u = port._random_uniform_plain(key0 | (key1 << 32), (m, n), "cpu")
        got = torch.where(u > rate, acc / torch.tensor(den, dtype=F32), 0.0)
        _view(out, F32, (m, n), (ldd, 1)).copy_(got)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    monkeypatch.setattr(port, "on_cuda", lambda *t: True)
    monkeypatch.setattr(port, "_on_card", lambda dev: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("seed", SEEDS)
def test_cuda_branch_uniform(emulated, seed):
    before = port._random_uniform.launches
    got = port.random_uniform_kernel(seed, (37, 3), device="cpu")
    assert port._random_uniform.launches == before + 1
    assert emulated.rng_calls == [dict(kind="uniform", n=111,
                                       key=(seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF))]
    np.testing.assert_array_equal(got.numpy().reshape(-1), _ref_uniforms(seed, 111))


@pytest.mark.parametrize("dtype, code", [(F32, 0), (BF16, 1), (torch.float16, 0)])
def test_cuda_branch_dropout(emulated, rng, dtype, code):
    """f32 operands (and f16 ones, cast to f32) take the 3xTF32 product
    (code 0), A a column-major view and so split; bf16 ones the exact
    route (code 1), widened into rows padded to 16 bytes. The mask is the
    uniforms' bit for bit and the kept values within TOL of the plain
    version's."""
    _, _, ta, tb = _dropout_case(rng, 30, 17, 11, dtype)
    before = (port._dropout_matmul.launches, tf32x3.split_tf32.launches)
    got = port.dropout_matmul_kernel(ta.t().contiguous().t(), tb, -1, 0.3)   # a strided view
    assert port._dropout_matmul.launches == before[0] + 1
    # f32: A's planes (transposed split) and Bᵀ's; bf16: no split
    assert tf32x3.split_tf32.launches == before[1] + (0 if code else 2)
    (call,) = emulated.rng_calls
    assert call["shape"] == (30, 17, 11) and call["key"] == (0xFFFFFFFF, 0xFFFFFFFF)
    assert call["exact"] == code and call["split_a"] == bool(code)
    assert call["ld"] == (20, 20, 11)   # 17 values padded to 16 bytes, D's rows
    assert call["rate"] == pytest.approx(0.3) and call["den"] == pytest.approx(0.7)
    want = port._dropout_matmul_plain(ta, tb, -1, 0.3)
    keep = port._random_uniform_plain(-1, (30, 11), "cpu") > 0.3
    assert torch.equal(got != 0, keep & (want != 0))
    assert (got - want).abs().max() <= TOL * want.abs().max()


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_branch_dropout_against_reference(emulated, rng, dtype):
    """The 3xTF32 route's dropout (the emulation of tml_dropout_matmul) at
    (64, 48, 80), rate 0.25: the mask is the port's own uniforms > rate bit
    for bit, the kept values are the reference's product (interpret mode,
    f32 sums) / (1 − rate) within TOL of its largest; against the
    reference's jax.random stream only in distribution (ROADMAP C4): both
    drop a share within 5 binomial sigmas of the rate."""
    m, k, n, seed, rate = 64, 48, 80, 77, 0.25
    a, b, ta, tb = _dropout_case(rng, m, k, n, dtype)
    got = port.dropout_matmul_kernel(ta, tb, seed, rate)
    (call,) = emulated.rng_calls
    assert call["exact"] == (dtype == BF16)
    ja, jb = jnp.asarray(ta.float().numpy()), jnp.asarray(tb.float().numpy())
    prod = np.asarray(jax.jit(lambda x, y: jnp.matmul(x, y, preferred_element_type=jnp.float32,
                                                      precision="highest"))(ja, jb))
    want = prod / np.float32(1 - rate)
    u = port._random_uniform_plain(seed, (m, n), "cpu").numpy()
    keep = u > np.float32(rate)
    d = got.numpy()
    np.testing.assert_array_equal(d != 0, keep & (want != 0))
    assert np.abs(d[keep] - want[keep]).max() <= TOL * np.abs(want).max()
    theirs = np.asarray(ref.dropout_matmul_kernel(ja, jb, seed, rate=rate))
    sigma = (rate * (1 - rate) / (m * n)) ** 0.5
    for out in (d, theirs):
        assert abs(float((out == 0).mean()) - rate) <= 5 * sigma


def test_cuda_branch_raises_on_launch_failure(emulated):
    emulated.rc = 7
    before = (port._random_uniform.launches, port._dropout_matmul.launches)
    with pytest.raises(ExecutionError, match="tml_random_uniform: CUDA error 7"):
        port.random_uniform_kernel(1, (8,), device="cpu")
    with pytest.raises(ExecutionError, match="tml_dropout_matmul: CUDA error 7"):
        port.dropout_matmul_kernel(torch.ones(4, 8), torch.ones(8, 4), 1)
    assert (port._random_uniform.launches, port._dropout_matmul.launches) == before


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(port, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        port.dropout_matmul_kernel(torch.ones(4, 8), torch.ones(8, 4), 1)


def test_cpu_takes_the_plain_version_without_launch(rng):
    _, _, ta, tb = _dropout_case(rng, 8, 8, 8, F32)
    before = (port._random_uniform.launches, port._dropout_matmul.launches)
    port.random_uniform_kernel(1, (64,), device="cpu")
    port.dropout_matmul_kernel(ta, tb, 1)
    assert (port._random_uniform.launches, port._dropout_matmul.launches) == before


def test_default_device_is_the_card():
    """No device given: the card; on a torch without CUDA that raises."""
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            port.random_uniform_kernel(1, (8,))


# ---------------------------------------------------------------------------
# The slice as a whole

def test_slice_against_reference(rng):
    """One seed drives both functions: the dropout keeps exactly the uniforms
    above the rate, the uniforms are the reference's Philox stream, and the
    kept values are the reference's product scaled."""
    m, k, n, seed, rate = 64, 48, 40, 2024, 0.25
    a, b, ta, tb = _dropout_case(rng, m, k, n, F32)
    u = port.random_uniform_kernel(seed, (m, n), device="cpu").numpy()
    np.testing.assert_array_equal(u.reshape(-1), _ref_uniforms(seed, m * n))
    d = port.dropout_matmul_kernel(ta, tb, seed, rate).numpy()
    want = np.asarray(jax.jit(lambda x, y: jnp.matmul(x, y, preferred_element_type=jnp.float32))(
        jnp.asarray(a), jnp.asarray(b))) / np.float32(1 - rate)
    keep = u > np.float32(rate)
    assert ((d != 0) == keep).all()
    assert np.abs(d[keep] - want[keep]).max() <= TOL * np.abs(want).max()
