"""The 3xTF32 product of tpumathlib_torch.dx.tf32x3 (csrc/gemm_tf32x3.cu)
on the CPU.

- ``_split_tf32_plain`` against an independent rounding written in float64
  (the nearest multiple of the TF32 unit, ties away from zero): hi carries
  at most 10 mantissa bits and is RNA-rounded, bit for bit, on normal,
  subnormal, tied, signed-zero, infinite and overflowing values; lo is TF32
  too, and hi + lo is x within 2⁻²² |x| (where lo is a normal number).
- A float64 model of the kernel's sum (the plain split, then hi·hi + hi·lo
  + lo·hi) within 1e-6 of float64, max-scaled, at the ring's test shapes
  and at K = 4096; the plain version (the same in f32) within 1e-5, and
  against the reference's f32 product at HIGHEST precision; a model of the
  tensor cores' accumulation (round toward zero) showing why each stage's
  products are summed apart.
- The wrappers' CUDA branch against ``_EmulatedLib``: a CPU emulation of
  ``tml_split_tf32`` and ``tml_gemm_tf32x3`` that reads the operands
  through the pointers and row strides the wrappers pass, refuses what the
  C entries refuse, and reads each plane as the tensor cores do (its low
  13 bits dropped), so that planes that were not split show.

``Tf32x3Emulation`` (tests/test_torch_dx_gemm.py, whose emulation of B1
includes it: B1's f32 route is the 3xTF32 kernel) is the mixin that the
ring's and orgqr's emulations (tests/test_torch_mp_matmul.py,
tests/test_torch_solver_qr.py) add.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.dx import cuda_utils, tf32x3
from test_torch_dx_gemm import _EmulatedLib as _EmulatedGemmLib

torch.set_num_threads(1)

F32 = torch.float32
RING_SHAPES = ((1024, 512, 512), (1000, 300, 200), (64, 4096, 64))   # (m, k, n); K = 4096 last


class _EmulatedLib(_EmulatedGemmLib):
    """B1's emulation, which holds ``Tf32x3Emulation``."""


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    monkeypatch.setattr(tf32x3, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    return lib


# --- the split ------------------------------------------------------------------

def _rna_f64(x):
    """TF32 rounding by float64 arithmetic: the nearest multiple of the TF32
    unit of x's binade (2^(e − 10), e clamped at f32's −126), ties away
    from zero; then cast to f32 (2^128 becomes inf)."""
    x64 = x.astype(np.float64)
    out = x64.copy()
    fin = np.isfinite(x64) & (x64 != 0)
    e = np.maximum(np.floor(np.log2(np.abs(x64[fin]))), -126.0)
    unit = np.exp2(e - 10)
    out[fin] = np.sign(x64[fin]) * np.floor(np.abs(x64[fin]) / unit + 0.5) * unit
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def _special_values(rng):
    f = np.float32
    base = [0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, np.finfo(f).max, -np.finfo(f).max,
            np.finfo(f).tiny, 1e-40, -3e-42, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
            -(1.0 + 2.0 ** -11), 2.0 ** 127 * (2 - 2.0 ** -11), 65504.0]
    bits = rng.integers(0, 2 ** 31, size=200, dtype=np.int64).astype(np.uint32)
    ties = (bits & ~np.uint32(0x1FFF)) | np.uint32(0x1000)        # exactly half a TF32 unit
    wide = rng.normal(size=300) * np.exp2(rng.integers(-140, 127, size=300))
    return np.concatenate([np.array(base, f), ties.view(f), (ties | np.uint32(1 << 31)).view(f),
                           wide.astype(f), rng.normal(size=200).astype(f)])


def test_split_rounds_to_nearest_ties_away(rng):
    x = _special_values(rng)
    x = x[np.isfinite(x) | np.isinf(x)]   # the random bits hold no NaN: kept for clarity
    hi, lo = tf32x3._split_tf32_plain(torch.from_numpy(x))
    hi_bits = hi.view(torch.int32).numpy()
    assert (hi_bits & 0x1FFF == 0).all() and (lo.view(torch.int32).numpy() & 0x1FFF == 0).all()
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), _rna_f64(x).view(np.uint32))
    assert np.signbit(hi.numpy()[1]) and hi.numpy()[1] == 0   # −0 stays −0


def test_split_reconstructs_x(rng):
    """Within 2⁻²² |x| wherever lo (about 2⁻¹¹ |x|) is still a normal
    number: below 2⁻¹⁰⁰ its TF32 unit stops shrinking with it."""
    x = _special_values(rng)
    normal = np.isfinite(x) & (np.abs(x) >= 2.0 ** -100) & (np.abs(x) < 2.0 ** 127)
    x = x[normal]
    hi, lo = (t.numpy().astype(np.float64) for t in tf32x3._split_tf32_plain(torch.from_numpy(x)))
    np.testing.assert_array_equal(hi.astype(np.float32), _rna_f64(x))
    assert (np.abs(x - (hi + lo)) <= 2.0 ** -22 * np.abs(x)).all()
    assert (np.abs(lo) <= 2.0 ** -11 * np.abs(x)).all()


@pytest.mark.parametrize("transpose, unit_lower", [(False, False), (True, False),
                                                   (False, True), (True, True)])
def test_split_options(rng, transpose, unit_lower):
    x = torch.from_numpy(rng.normal(size=(70, 32)).astype(np.float32))
    hi, lo = tf32x3._split_tf32_plain(x, transpose=transpose, unit_lower=unit_lower)
    want = x.clone()
    if unit_lower:
        want[:32] = torch.tril(want[:32], -1) + torch.eye(32)
    if transpose:
        want = want.mT
    assert hi.shape == want.shape and torch.equal(hi, tf32x3._rna_tf32(want))
    assert torch.equal(lo, tf32x3._rna_tf32(want - hi))


# --- the product -----------------------------------------------------------------

@pytest.mark.parametrize("m, k, n", RING_SHAPES)
def test_model_of_the_three_products_against_float64(rng, m, k, n):
    """hi·hi + hi·lo + lo·hi in float64 from the plain split: the error the
    split leaves (lo·lo and lo's rounding) is within 1e-6 max-scaled."""
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    ah, al = (t.double() for t in tf32x3._split_tf32_plain(torch.from_numpy(a)))
    bh, bl = (t.double() for t in tf32x3._split_tf32_plain(torch.from_numpy(b)))
    model = ah @ bh + ah @ bl + al @ bh
    want = a.astype(np.float64) @ b
    assert max_scaled_err(model, want) <= 1e-6
    one_pass = ah @ bh   # plain TF32: what the split is for
    assert max_scaled_err(one_pass, want) > 1e-5


@pytest.mark.parametrize("m, k, n", RING_SHAPES[:2])
def test_plain_product_against_float64_and_the_reference(rng, m, k, n):
    """The plain version (the three products in f32) within 1e-5 of float64
    and of the reference's f32 product at HIGHEST precision."""
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    c = rng.normal(size=(m, n)).astype(np.float32)
    got = tf32x3.gemm_tf32x3(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c),
                             alpha=-1.0, beta=2.0)
    want = -(a.astype(np.float64) @ b) + 2.0 * c
    assert got.dtype == F32 and max_scaled_err(got, want) <= 1e-5
    ref = -np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b), precision=lax.Precision.HIGHEST))
    assert max_scaled_err(got, (ref + 2.0 * c).astype(np.float64)) <= 1e-5


def _rz(x64):
    """float64 values to f32, rounded toward zero (as the tensor cores add)."""
    f = x64.astype(np.float32)
    away = np.abs(f.astype(np.float64)) > np.abs(x64)
    f[away] = np.nextafter(f[away], np.float32(0))
    return f


@pytest.mark.parametrize("k", [256, 4096])
def test_accumulation_model_per_stage_partials(rng, k):
    """Why the kernel sums each stage apart: a numpy model of its
    accumulation, each wgmma adding its k8 step's 8 exact products to an
    f32 accumulator rounded toward zero. One chain of 3·k/8 such additions
    drifts with k, past 1e-5 of float64 at k = 4096; a fresh partial a
    32-deep stage (12 additions), the partials summed in f32 to nearest,
    stays within 2e-6."""
    m = n = 32
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    ah, al = (t.numpy().astype(np.float64) for t in tf32x3._split_tf32_plain(torch.from_numpy(a)))
    bh, bl = (t.numpy().astype(np.float64) for t in tf32x3._split_tf32_plain(torch.from_numpy(b)))
    want = a.astype(np.float64) @ b
    chain = np.zeros((m, n), np.float32)
    total = np.zeros((m, n), np.float32)
    for k0 in range(0, k, 32):
        part = np.zeros((m, n), np.float32)
        for s in range(k0, k0 + 32, 8):
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                step = x[:, s:s + 8] @ y[s:s + 8]
                chain = _rz(chain + step)
                part = _rz(part + step)
        total = total + part
    assert max_scaled_err(total, want) <= 2e-6
    if k == 4096:
        assert max_scaled_err(chain, want) > 1e-5


def test_bf16_values_are_exact_in_tf32(rng):
    """The premise of B10b's one-product instantiation: a bf16 value widened
    to f32 is its own TF32 hi plane (8 mantissa bits of TF32's 10) and its
    lo plane is 0, bit for bit, so hi·hi is the whole product's sum."""
    x = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32) * 1e3).to(torch.bfloat16)
    w = x.to(F32)
    hi, lo = tf32x3._split_tf32_plain(w)
    assert torch.equal(hi, w) and torch.equal(lo, torch.zeros_like(w))
    y = torch.from_numpy(rng.normal(size=(96, 40)).astype(np.float32)).to(torch.bfloat16).to(F32)
    bt_hi, bt_lo = tf32x3._split_tf32_plain(y, transpose=True)
    assert torch.equal(tf32x3._gemm_tf32x3_plain(hi, lo, bt_hi, bt_lo),
                       tf32x3._gemm_tf32x3_plain(hi, torch.zeros_like(hi), bt_hi,
                                                 torch.zeros_like(bt_hi)))


@pytest.mark.parametrize("exact", ["a", "b"])
def test_two_products_when_one_operand_is_exact(rng, exact):
    """The premise of B6a's two-product instantiations (f32 with a 16-bit
    operand): a bf16 or f16 operand widened to f32 has a zero lo plane, so
    the two products that do not read it (hi·lo + hi·hi of a 16-bit A with
    B's two planes, lo·hi + hi·hi of A's planes with a 16-bit B's hi plane)
    are the three products' sum, bit for bit, and within 1e-6 of float64;
    the f32 operand's lo plane carries what one TF32 product would lose
    (some 1e-4 of it at K = 1000)."""
    for dt in (torch.bfloat16, torch.float16):
        a, b = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                for shape in ((48, 1000), (1000, 40)))
        if exact == "a":
            a = a.to(dt).to(F32)
        else:
            b = b.to(dt).to(F32)
        (ah, al), (bh, bl) = tf32x3._split_tf32_plain(a), tf32x3._split_tf32_plain(b, transpose=True)
        zero_lo = al if exact == "a" else bl
        assert torch.equal(zero_lo, torch.zeros_like(zero_lo))
        three = tf32x3._gemm_tf32x3_plain(ah, al, bh, bl)
        two = (tf32x3._gemm_tf32x3_plain(ah, torch.zeros_like(al), bh, bl) if exact == "a"
               else tf32x3._gemm_tf32x3_plain(ah, al, bh, torch.zeros_like(bl)))
        assert torch.equal(two, three)
        want = a.double() @ b.double()
        assert max_scaled_err(two, want) <= 1e-6
        one = tf32x3._gemm_tf32x3_plain(ah, torch.zeros_like(al), bh, torch.zeros_like(bl))
        assert max_scaled_err(one, want) > 1e-5


def test_planes_pad_the_row_stride():
    p = tf32x3.planes(5, 7, torch.device("cpu"))
    assert p.shape == (2, 5, 7) and p.stride() == (40, 8, 1)


# --- the CUDA branch, emulated -----------------------------------------------------

@pytest.mark.parametrize("transpose, unit_lower", [(False, False), (True, False),
                                                   (False, True)])
def test_split_wrapper_marshalling(emulated, rng, transpose, unit_lower):
    """A view with a wide row stride reaches the entry point with it; the
    planes come back padded to 16 bytes and equal the plain split bit for
    bit; one launch counted."""
    big = torch.from_numpy(rng.normal(size=(90, 300)).astype(np.float32))
    x = big[3:73, 5:38]
    before = tf32x3.split_tf32.launches
    got = tf32x3.split_tf32(x, transpose=transpose, unit_lower=unit_lower)
    assert tf32x3.split_tf32.launches == before + 1
    call = emulated.tf32_calls[-1]
    assert call["shape"] == (70, 33) and call["ld"][0] == 300 and call["ld"][1] % 4 == 0
    assert call["stream"] == 7
    hi, lo = tf32x3._split_tf32_plain(x, transpose=transpose, unit_lower=unit_lower)
    assert torch.equal(got[0], hi) and torch.equal(got[1], lo)


@pytest.mark.parametrize("k", [70, 72])
@pytest.mark.parametrize("with_c", [True, False])
def test_gemm_wrapper_marshalling(emulated, rng, with_c, k):
    """gemm_tf32x3 on ragged shapes: B split transposed; A split into planes
    where its row stride (k = 70) is not TMA's, else (k = 72) handed to the
    kernel in f32 to split in its registers; one product, every operand
    K-major with a row stride of a multiple of 4, C (a strided view) passed
    with its row stride or null; the result, f32, equals the plain
    version's and float64 within 1e-5."""
    a = torch.from_numpy(rng.normal(size=(37, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, 45)).astype(np.float32))
    c = (torch.from_numpy(rng.normal(size=(37, 50)).astype(np.float32))[:, 3:48] if with_c
         else None)
    split_a = tf32x3.tma_ready(a)
    assert split_a == (k == 72)
    before = (tf32x3.split_tf32.launches, tf32x3.gemm_tf32x3.launches)
    got = tf32x3.gemm_tf32x3(a, b, c, alpha=0.5, beta=-1.0)
    assert (tf32x3.split_tf32.launches, tf32x3.gemm_tf32x3.launches) == (
        before[0] + (1 if split_a else 2), before[1] + 1)
    splits = [x for x in emulated.tf32_calls if x["kind"] == "split"]
    assert [s["flags"] for s in splits] == [tf32x3.TRANSPOSE] + ([] if split_a else [0])
    prod = emulated.tf32_calls[-1]
    assert prod["shape"] == (37, 45, k) and prod["ld"][:2] == (72, 72)
    assert prod["split_a"] == split_a
    assert prod["ld"][2:] == ((50, 45) if with_c else (0, 45)) and bool(prod["c"]) == with_c
    assert got.dtype == F32
    want = tf32x3._gemm_tf32x3_plain(*tf32x3._split_tf32_plain(a),
                                     *tf32x3._split_tf32_plain(b, transpose=True), c,
                                     alpha=0.5, beta=-1.0)
    assert torch.equal(got, want)
    want64 = 0.5 * (a.double() @ b.double()) - (c.double() if with_c else 0.0)
    assert max_scaled_err(got, want64) <= 1e-5


def test_emulation_reads_planes_as_tensor_cores_do(emulated, rng):
    """The control: handing the product unsplit f32 operands as hi (lo = 0)
    loses what the tensor cores drop, well past 1e-5, so a wrapper that
    skipped the split would show."""
    a = torch.from_numpy(rng.normal(size=(64, 512)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(512, 64)).astype(np.float32))
    pa, pb = tf32x3.planes(64, 512, a.device), tf32x3.planes(64, 512, a.device)
    pa[0].copy_(a), pa[1].zero_(), pb[0].copy_(b.mT), pb[1].zero_()
    d = torch.empty((64, 64))
    tf32x3.Tf32x3().gemm(0, 64, 64, 512, (d.data_ptr(), 64), tf32x3.plane_pair(pa),
                         tf32x3.plane_pair(pb))
    assert max_scaled_err(d, a.double() @ b.double()) > 1e-5


def test_in_place_product_with_c_as_d(emulated, rng):
    """C may be D: D = C − A·B written over C (B4b's trailing update)."""
    a = torch.from_numpy(rng.normal(size=(96, 40)).astype(np.float32))
    bt = torch.from_numpy(rng.normal(size=(80, 40)).astype(np.float32))
    big = torch.from_numpy(rng.normal(size=(100, 128)).astype(np.float32))
    cd = big[2:98, 8:88]
    want = cd.double() - a.double() @ bt.double().mT
    pa = tf32x3.split_tf32(a)
    pb = tf32x3.split_tf32(bt)
    op = (cd.data_ptr(), cd.stride(0))
    tf32x3.Tf32x3().gemm(0, 96, 80, 40, op, tf32x3.plane_pair(pa), tf32x3.plane_pair(pb), op,
                         alpha=-1.0, beta=1.0)
    assert max_scaled_err(cd, want) <= 1e-5
    assert emulated.tf32_calls[-1]["c"] == emulated.tf32_calls[-1]["d"]


def test_entry_refusals_raise(emulated):
    """What the C entries refuse raises through the launch check: a plane
    off 16-byte alignment, a row stride not a multiple of 4, an output
    stride below n, a transposed split whose output stride is too short."""
    p = tf32x3.planes(8, 8, torch.device("cpu"))
    d = torch.empty((8, 8))
    pp = tf32x3.plane_pair(p)
    lib = tf32x3.Tf32x3()
    for a, bt, ldd in (((pp[0] + 4, pp[1], 8), pp, 8), ((pp[0], pp[1], 6), pp, 8), (pp, pp, 7)):
        with pytest.raises(ExecutionError, match="tml_gemm_tf32x3"):
            lib.gemm(0, 8, 8, 6, (d.data_ptr(), ldd), a, bt)
    x = torch.zeros((12, 8))   # transposed: (8, 12) planes need a row stride of 12
    with pytest.raises(ExecutionError, match="tml_split_tf32"):
        lib.split(0, (x.data_ptr(), 8), pp[0], pp[1], 8, 12, 8, tf32x3.TRANSPOSE)
    with pytest.raises(InvalidValueError):
        tf32x3.split_tf32(torch.zeros((4, 4), dtype=torch.float64))


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    """For CUDA tensors the wrappers launch or raise, never fall back."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(tf32x3, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    for call in (lambda: tf32x3.split_tf32(torch.ones((4, 4))),
                 lambda: tf32x3.gemm_tf32x3(torch.ones((4, 4)), torch.ones((4, 4)))):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            call()
