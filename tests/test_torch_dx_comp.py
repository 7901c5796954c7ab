"""Parity of tpumathlib_torch.dx.comp (kernels B8a decode, B8b encode, B8c
decode fused with a product) and the device codec of tpumathlib_torch.comp
with the reference, whose Pallas kernels run in interpret mode.

- The packed words and the leaders bit for bit, at bits 1, 2, 3, 7, 8, 13,
  16, 24, 31 and 32 and n = 160 (a partial row), 128, 4096 and 65 536, on
  seeded random walks whose steps fit the width (int32, wrapping); the
  decoded values equal the reference's, and the input wherever the width
  holds the steps.
- Payloads crossed between the packages, both ways.
- ``n=None`` (the padded tail repeats the last value) and ``n`` given.
- The int32 extremes at bits = 32, and a width too narrow for the data,
  which corrupts silently in both packages alike (the contract: the caller
  validates with ``dx_required_bits``).
- Every check and its message, in both packages.
- ``dx_required_bits`` on a tensor (reduced with torch) and on numpy equal
  the reference's.
- ``dx_decompress_dot`` against float64 at rel < 1e-5 (the bound of
  tests/test_dx_gemm.py:121-124) and against the reference's kernel at 1e-6
  (measured at most 5.9e-7: the same f32 products summed in another
  order).
- tests/test_dx_gemm.py:90-124 and tests/test_native_dss_comp.py:474-545
  through both packages, the device codec's ratio equal in both.
- The CUDA branch of each wrapper against ``_EmulatedLib``, a CPU emulation
  of tml_cascaded_encode, tml_cascaded_decode and tml_cascaded_decode_dot
  that reads the tensors through their pointers and sizes, refuses what the
  C side refuses, and counts launches.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib import comp as ref_comp
from tpumathlib.core.errors import InvalidValueError as RefInvalidValueError
from tpumathlib.dx import comp as ref
from tpumathlib_torch import comp as port_comp
from tpumathlib_torch import dx
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.core.interop import from_numpy, to_numpy
from tpumathlib_torch.dx import comp as port
from tpumathlib_torch.dx import cuda_utils
from test_torch_dx_gemm import _view
from test_torch_dx_lsq_eig import _EmulatedLib as _EmulatedLsqEigLib

torch.set_num_threads(1)

DOT_TOL = 1e-5   # decode_dot against float64, rel to the largest (the reference test's bound)
REF_TOL = 1e-6   # decode_dot against the reference's kernel, the same measure
U32, I32 = torch.uint32, torch.int32
_COUNTS = (port._encode, port._decode, port._decode_dot)
BITS = [1, 2, 3, 7, 8, 13, 16, 24, 31, 32]
NS = [160, 128, 4096, 65536]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _walk(rng, n, bits):
    """int32 values whose row deltas (int32, wrapping) zigzag into ``bits``:
    steps in [−2^(bits−1), 2^(bits−1)), from a random start."""
    steps = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), n)
    steps[0] = rng.integers(-(1 << 31), 1 << 31)
    v = np.cumsum(steps)
    return (((v + (1 << 31)) % (1 << 32)) - (1 << 31)).astype(np.int32)


def _padded(v):
    """v padded to whole 128-value rows with its last value."""
    return np.concatenate([v, np.full((-len(v)) % 128, v[-1], np.int32)])


def _ref_payload(v, bits):
    p, ld = ref.dx_compress(jnp.asarray(v), bits=bits)
    return np.asarray(p), np.asarray(ld)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# The codec against the reference, bit for bit

@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("bits", BITS)
def test_encode_and_decode_bit_for_bit(rng, bits, n):
    v = _walk(rng, n, bits)
    rp, rl = _ref_payload(v, bits)
    p, ld = dx.dx_compress(from_numpy(v), bits=bits)
    rows = -(-n // 128)
    assert p.dtype == U32 and p.shape == (rows, 4 * bits)
    assert ld.dtype == I32 and ld.shape == (rows,)
    np.testing.assert_array_equal(p.numpy(), rp)
    np.testing.assert_array_equal(ld.numpy(), rl)
    out = dx.dx_decompress(p, ld, bits=bits)
    assert out.dtype == I32 and out.shape == (rows * 128,)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref.dx_decompress(rp, rl, bits=bits)))
    np.testing.assert_array_equal(out.numpy(), _padded(v))


@pytest.mark.parametrize("bits", [3, 8, 13, 32])
@pytest.mark.parametrize("n", [160, 4096])
def test_payloads_cross_packages(rng, bits, n):
    v = _walk(rng, n, bits)
    rp, rl = _ref_payload(v, bits)
    got = dx.dx_decompress(from_numpy(rp), from_numpy(rl), n, bits=bits)
    np.testing.assert_array_equal(got.numpy(), v)
    p, ld = dx.dx_compress(from_numpy(v), bits=bits)
    back = ref.dx_decompress(jnp.asarray(p.numpy()), jnp.asarray(ld.numpy()), n, bits=bits)
    np.testing.assert_array_equal(np.asarray(back), v)


@pytest.mark.parametrize("n", [None, 160, 100, 1000, -30])
def test_padded_tail_and_n(rng, n):
    """n = 160 values at bits 4: two rows, the last 96 values of the second
    repeat the last input value when n is None; n slices as the
    reference's out[:n] does."""
    v = _walk(rng, 160, 4)
    rp, rl = _ref_payload(v, 4)
    got = dx.dx_decompress(*dx.dx_compress(from_numpy(v), bits=4), n, bits=4).numpy()
    want = np.asarray(ref.dx_decompress(rp, rl, n, bits=4))
    np.testing.assert_array_equal(got, want)
    if n is None:
        assert got.shape == (256,) and (got[160:] == v[-1]).all()


def test_int32_extremes_at_32_bits():
    v = np.array([2**31 - 1, -(2**31)] * 128, np.int32)
    rp, rl = _ref_payload(v, 32)
    p, ld = dx.dx_compress(from_numpy(v), bits=32)
    np.testing.assert_array_equal(p.numpy(), rp)
    np.testing.assert_array_equal(dx.dx_decompress(p, ld, bits=32).numpy(), v)
    np.testing.assert_array_equal(np.asarray(ref.dx_decompress(rp, rl, bits=32)), v)
    for call in (lambda: ref.dx_required_bits(v), lambda: dx.dx_required_bits(from_numpy(v)),
                 lambda: dx.dx_required_bits(v)):
        with pytest.raises(ValueError, match="deltas need 33 bits"):
            call()


def test_too_narrow_width_corrupts_as_the_reference_does(rng):
    """A walk that needs 9 bits, packed at 4: nothing is raised, most values
    come back wrong, and wrong alike in both packages."""
    v = np.cumsum(rng.integers(-256, 256, 256)).astype(np.int32)
    assert dx.dx_required_bits(v) == ref.dx_required_bits(v) == 9
    rp, rl = _ref_payload(v, 4)
    p, ld = dx.dx_compress(from_numpy(v), bits=4)
    np.testing.assert_array_equal(p.numpy(), rp)
    got = dx.dx_decompress(p, ld, bits=4).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.dx_decompress(rp, rl, bits=4)))
    assert (got != v).sum() > 200


@pytest.mark.parametrize("case", ["walk", "constant", "one row", "rows of jumps", "empty",
                                  "33 bits"])
def test_required_bits_on_tensors_and_numpy(rng, case):
    v = {"walk": lambda: np.cumsum(rng.integers(-20, 21, 1000)),
         "constant": lambda: np.full(300, 7),
         "one row": lambda: np.arange(128) * 1000,
         "rows of jumps": lambda: np.repeat(rng.integers(-(2**30), 2**30, 8), 128),
         "empty": lambda: np.zeros(0),
         "33 bits": lambda: np.array([0, 2**31 - 1, -(2**31) + 1, 0] * 8)}[case]()
    v = v.astype(np.int32)
    try:
        want = ref.dx_required_bits(v)
    except ValueError as e:
        for got in (lambda: dx.dx_required_bits(v), lambda: dx.dx_required_bits(from_numpy(v))):
            with pytest.raises(ValueError, match=str(e).split(";")[0]):
                got()
        return
    assert dx.dx_required_bits(v) == dx.dx_required_bits(from_numpy(v)) == want


# ---------------------------------------------------------------------------
# The checks and their messages

_W = np.zeros((128, 4), np.float32)


def _payload(rows, bits):
    return np.zeros((rows, 4 * bits), np.uint32), np.zeros(rows, np.int32)


@pytest.mark.parametrize("case, msg", [
    ("compress bits 0", "bits must be 1..32"),
    ("compress bits 33", "bits must be 1..32"),
    ("compress n % 32", "value count must be a multiple of 32"),
    ("decompress bits 0", "bits must be 1..32"),
    ("decompress bits 33", "bits must be 1..32"),
    ("decompress packed width", "packed shape must be \\(rows, 4\\*bits\\) word rows"),
    ("decompress leaders", "one leader per 128-value row"),
    ("dot bits 33", "bits must be 1..32"),
    ("dot k", "fused dot consumes the decoded \\(rows, 128\\) layout"),
    ("dot packed width", "packed shape must be \\(rows, 4\\*bits\\) word rows"),
    ("dot rows", "rows must tile the blocking"),
])
def test_checks_and_messages(case, msg):
    p, ld = _payload(4, 8)
    calls = {
        "compress bits 0": lambda m, a: m.dx_compress(a(np.zeros(64, np.int32)), bits=0),
        "compress bits 33": lambda m, a: m.dx_compress(a(np.zeros(64, np.int32)), bits=33),
        "compress n % 32": lambda m, a: m.dx_compress(a(np.zeros(100, np.int32)), bits=8),
        "decompress bits 0": lambda m, a: m.dx_decompress(a(p[:, :0]), a(ld), bits=0),
        "decompress bits 33": lambda m, a: m.dx_decompress(a(np.zeros((4, 132), np.uint32)),
                                                           a(ld), bits=33),
        "decompress packed width": lambda m, a: m.dx_decompress(a(p), a(ld), bits=7),
        "decompress leaders": lambda m, a: m.dx_decompress(a(p), a(ld[:3]), bits=8),
        "dot bits 33": lambda m, a: m.dx_decompress_dot(a(p), a(ld), a(_W), bits=33),
        "dot k": lambda m, a: m.dx_decompress_dot(a(p), a(ld), a(_W[:64]), bits=8),
        "dot packed width": lambda m, a: m.dx_decompress_dot(a(p), a(ld), a(_W), bits=7),
        "dot rows": lambda m, a: m.dx_decompress_dot(*(a(t) for t in _payload(100, 8)), a(_W),
                                                     bits=8),
    }
    with pytest.raises(RefInvalidValueError, match=msg):
        calls[case](ref, jnp.asarray)
    with pytest.raises(InvalidValueError, match=msg):
        calls[case](dx, from_numpy)


def test_dot_rows_below_the_tile_need_not_tile(rng):
    """Fewer rows than ``tile`` (37 < 64) form one block, in both packages."""
    v = np.cumsum(rng.integers(-60, 61, 37 * 128)).astype(np.int32)
    rp, rl = _ref_payload(v, 8)
    w = rng.normal(size=(128, 3)).astype(np.float32)
    got = dx.dx_decompress_dot(from_numpy(rp), from_numpy(rl), from_numpy(w), bits=8)
    assert got.shape == (37, 3)
    want = ref.dx_decompress_dot(rp, rl, jnp.asarray(w), bits=8)
    assert _rel(got, want) < REF_TOL


# ---------------------------------------------------------------------------
# decode_dot against float64 and the reference

@pytest.mark.parametrize("scale", [1.0, 0.01])
@pytest.mark.parametrize("ncols", [1, 64, 100])
def test_decompress_dot(rng, ncols, scale):
    v = np.cumsum(rng.integers(-20, 21, 128 * 128)).astype(np.int32)
    bits = dx.dx_required_bits(v)
    p, ld = dx.dx_compress(from_numpy(v), bits=bits)
    w = rng.normal(size=(128, ncols)).astype(np.float32)
    got = dx.dx_decompress_dot(p, ld, from_numpy(w), bits=bits, scale=scale)
    assert got.dtype == torch.float32 and got.shape == (128, ncols)
    f64 = (v.reshape(-1, 128).astype(np.float64) * scale) @ w.astype(np.float64)
    assert _rel(got, f64) < DOT_TOL
    rp, rl = _ref_payload(v, bits)
    assert _rel(got, ref.dx_decompress_dot(rp, rl, jnp.asarray(w), bits=bits, scale=scale)) < REF_TOL


# ---------------------------------------------------------------------------
# tests/test_dx_gemm.py:90-124 and tests/test_native_dss_comp.py:474-545,
# through both packages

def test_dx_comp_roundtrip(rng):
    v = np.cumsum(rng.integers(-20, 21, 65536)).astype(np.int32)
    bits = dx.dx_required_bits(v)
    assert bits == ref.dx_required_bits(v)
    packed, leaders = dx.dx_compress(from_numpy(v), bits=bits)
    dec = dx.dx_decompress(packed, leaders, bits=bits).numpy()
    np.testing.assert_array_equal(dec[:len(v)], v)
    nbytes = (packed.numel() + leaders.numel()) * 4
    assert v.nbytes / nbytes > 4.0
    rp, rl = _ref_payload(v, bits)
    assert nbytes == (rp.size + rl.size) * 4


def test_dx_decompress_dot_reference_case(rng):
    v = np.cumsum(rng.integers(-20, 21, 32768)).astype(np.int32)
    bits = dx.dx_required_bits(v)
    packed, leaders = dx.dx_compress(from_numpy(v), bits=bits)
    w = rng.normal(size=(128, 64)).astype(np.float32)
    out = dx.dx_decompress_dot(packed, leaders, from_numpy(w), bits=bits, scale=0.01).numpy()
    want = (v.reshape(-1, 128).astype(np.float64) * 0.01) @ w.astype(np.float64)
    assert np.abs(out - want).max() / np.abs(want).max() < 1e-5


def test_dx_comp_bits_guard():
    v = np.array([0, 2**31 - 1, -(2**31) + 1, 0] * 8, np.int32)
    with pytest.raises(ValueError):
        dx.dx_required_bits(v)
    with pytest.raises(ValueError):
        dx.dx_required_bits(from_numpy(v))
    with pytest.raises(InvalidValueError):
        dx.dx_compress(from_numpy(v), bits=33)
    with pytest.raises(InvalidValueError):
        dx.dx_decompress(torch.zeros((4, 33), dtype=U32), torch.zeros(1, dtype=I32), bits=33)


def test_device_cascaded_roundtrip(rng):
    v = np.cumsum(rng.integers(-5, 6, 100_003)).astype(np.int32)
    payload, meta = port_comp.device_cascaded_compress(from_numpy(v))
    np.testing.assert_array_equal(port_comp.device_cascaded_decompress(payload, meta).numpy(), v)
    ratio = port_comp.device_cascaded_ratio(meta, payload)
    assert ratio > 4.0
    rpay, rmeta = ref_comp.device_cascaded_compress(jnp.asarray(v))
    assert meta == rmeta and ratio == ref_comp.device_cascaded_ratio(rmeta, rpay)
    np.testing.assert_array_equal(payload[0].numpy(), np.asarray(rpay[0]))
    np.testing.assert_array_equal(payload[1].numpy(), np.asarray(rpay[1]))
    p2, m2 = port_comp.device_cascaded_compress(from_numpy(v), bits=8)
    assert m2 == (100_003, 8)
    np.testing.assert_array_equal(port_comp.device_cascaded_decompress(p2, m2).numpy(), v)


def test_device_bitcomp_lossy(rng):
    x = 100.0 * np.sin(np.arange(1 << 16, dtype=np.float32) * 0.001)
    for delta in (1.0, 0.3):            # 0.3 rounds down to 0.25
        payload, meta = port_comp.device_bitcomp_lossy_compress(from_numpy(x), delta)
        d2 = meta[2]
        assert d2 == (1.0 if delta == 1.0 else 0.25)
        out = port_comp.device_bitcomp_lossy_decompress(payload, meta)
        assert out.dtype == torch.float32
        assert np.max(np.abs(out.numpy() - x)) <= d2 / 2 + 1e-6
        rpay, rmeta = ref_comp.device_bitcomp_lossy_compress(jnp.asarray(x), delta)
        assert meta == rmeta
        np.testing.assert_array_equal(payload[0].numpy(), np.asarray(rpay[0]))
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            ref_comp.device_bitcomp_lossy_decompress(rpay, rmeta)))
    payload, meta = port_comp.device_bitcomp_lossy_compress(from_numpy(x), 1.0)
    ratio = port_comp.device_cascaded_ratio(meta[:2], payload)
    assert ratio > 4.0
    rpay, rmeta = ref_comp.device_bitcomp_lossy_compress(jnp.asarray(x), 1.0)
    assert ratio == ref_comp.device_cascaded_ratio(rmeta[:2], rpay)
    for delta in (0.0, -1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="delta must be a positive finite float"):
            port_comp.device_bitcomp_lossy_compress(from_numpy(x), delta)


def test_lossy_rounds_half_to_even():
    """x/delta on a half rounds to the even integer, as jnp.round does."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5] * 16, np.float32)
    payload, meta = port_comp.device_bitcomp_lossy_compress(from_numpy(x), 1.0)
    got = port_comp.device_bitcomp_lossy_decompress(payload, meta).numpy()
    np.testing.assert_array_equal(got[:6], [0.0, 2.0, 2.0, -0.0, -2.0, 4.0])
    rpay, rmeta = ref_comp.device_bitcomp_lossy_compress(jnp.asarray(x), 1.0)
    np.testing.assert_array_equal(got, np.asarray(ref_comp.device_bitcomp_lossy_decompress(rpay, rmeta)))


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

class _EmulatedLib(_EmulatedLsqEigLib):
    """Adds the contracts of dx_comp.cu's entry points, computed on the CPU
    from the raw arguments and the plain versions, the C side's refusals
    included."""

    def __init__(self, rc=0):
        super().__init__(rc)
        self.comp_calls = []

    def _refuse(self, bits, *sizes):
        return self.rc or (1 if not 1 <= bits <= 32 or min(sizes) < 0 else 0)

    def tml_cascaded_encode(self, values, packed, leaders, n, bits, stream):
        self.comp_calls.append(dict(kernel="encode", n=n, bits=bits))
        rc = self._refuse(bits, n)
        if rc:
            return rc
        rows = -(-n // 128)
        p, ld = port._dx_compress_plain(_view(values, I32, (n,), (1,)).clone(), bits)
        _view(packed, I32, (rows, 4 * bits), (4 * bits, 1)).copy_(p.view(I32))
        _view(leaders, I32, (rows,), (1,)).copy_(ld)
        return 0

    def tml_cascaded_decode(self, packed, leaders, out, rows, count, bits, stream):
        self.comp_calls.append(dict(kernel="decode", rows=rows, count=count, bits=bits))
        rc = self._refuse(bits, rows, count) or (1 if count > rows * 128 else 0)
        if rc:
            return rc
        p = _view(packed, U32, (rows, 4 * bits), (4 * bits, 1)).clone()
        v = port._dx_decompress_plain(p, _view(leaders, I32, (rows,), (1,)).clone(), bits)
        _view(out, I32, (count,), (1,)).copy_(v[:count])
        return 0

    def tml_cascaded_decode_dot(self, packed, leaders, w, out, rows, ncols, bits, scale, stream):
        self.comp_calls.append(dict(kernel="decode_dot", rows=rows, ncols=ncols, bits=bits,
                                    scale=scale))
        rc = self._refuse(bits, rows, ncols)
        if rc:
            return rc
        p = _view(packed, U32, (rows, 4 * bits), (4 * bits, 1)).clone()
        y = port._dx_decompress_dot_plain(p, _view(leaders, I32, (rows,), (1,)).clone(),
                                          _view(w, torch.float32, (128, ncols), (ncols, 1)).clone(),
                                          bits, scale)
        _view(out, torch.float32, (rows, ncols), (ncols, 1)).copy_(y)
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


def _grew(before):
    return [f.launches - b for f, b in zip(_COUNTS, before)]


@pytest.mark.parametrize("bits", [1, 8, 32])
@pytest.mark.parametrize("n", [160, 4096])
def test_cuda_branch_codec(emulated, rng, bits, n):
    v = from_numpy(_walk(rng, n, bits))
    before = [f.launches for f in _COUNTS]
    p, ld = dx.dx_compress(v, bits=bits)
    out = dx.dx_decompress(p, ld, n, bits=bits)
    assert _grew(before) == [1, 1, 0]
    assert emulated.comp_calls == [dict(kernel="encode", n=n, bits=bits),
                                   dict(kernel="decode", rows=-(-n // 128), count=n, bits=bits)]
    pp, pl = port._dx_compress_plain(v, bits)
    assert p.dtype == U32 and torch.equal(p.view(I32), pp.view(I32)) and torch.equal(ld, pl)
    assert torch.equal(out, v)


def test_cuda_branch_decode_count_and_int32_words(emulated, rng):
    """n=None asks for every row's 128 values; int32 words (the uint32 bits)
    and int64 leaders are taken as they are."""
    v = from_numpy(_walk(rng, 160, 5))
    p, ld = port._dx_compress_plain(v, 5)
    out = dx.dx_decompress(p.view(I32), ld.to(torch.int64), bits=5)
    assert emulated.comp_calls == [dict(kernel="decode", rows=2, count=256, bits=5)]
    assert torch.equal(out, port._dx_decompress_plain(p, ld, 5))


@pytest.mark.parametrize("rows, ncols", [(1, 1), (37, 100), (128, 64)])
def test_cuda_branch_decode_dot(emulated, rng, rows, ncols):
    v = from_numpy(np.cumsum(rng.integers(-60, 61, rows * 128)).astype(np.int32))
    p, ld = port._dx_compress_plain(v, 8)
    w = from_numpy(rng.normal(size=(128, ncols)).astype(np.float32))
    before = [f.launches for f in _COUNTS]
    got = dx.dx_decompress_dot(p, ld, w, bits=8, scale=0.01)
    assert _grew(before) == [0, 0, 1]
    [call] = emulated.comp_calls
    assert call["kernel"] == "decode_dot" and (call["rows"], call["ncols"], call["bits"]) == (
        rows, ncols, 8) and call["scale"] == 0.01
    assert torch.equal(got, port._dx_decompress_dot_plain(p, ld, w, 8, 0.01))


def test_cuda_branch_raises_on_launch_failure(emulated):
    emulated.rc = 9
    v = torch.zeros(128, dtype=I32)
    p, ld = port._dx_compress_plain(v, 4)
    before = [f.launches for f in _COUNTS]
    for run, name in ((lambda: dx.dx_compress(v, bits=4), "tml_cascaded_encode"),
                      (lambda: dx.dx_decompress(p, ld, bits=4), "tml_cascaded_decode"),
                      (lambda: dx.dx_decompress_dot(p, ld, torch.ones(128, 2), bits=4),
                       "tml_cascaded_decode_dot")):
        with pytest.raises(ExecutionError, match=f"{name}: CUDA error 9"):
            run()
    assert _grew(before) == [0, 0, 0]


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    """For CUDA tensors the wrappers launch or raise, never fall back."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(port, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    v = torch.zeros(128, dtype=I32)
    p, ld = port._dx_compress_plain(v, 4)
    for run in (lambda: dx.dx_compress(v, bits=4), lambda: dx.dx_decompress(p, ld, bits=4),
                lambda: dx.dx_decompress_dot(p, ld, torch.ones(128, 2), bits=4)):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            run()


def test_cpu_takes_plain_versions_without_launch(rng):
    v = from_numpy(_walk(rng, 256, 6))
    before = [f.launches for f in _COUNTS]
    p, ld = dx.dx_compress(v, bits=6)
    dx.dx_decompress(p, ld, bits=6)
    dx.dx_decompress_dot(p, ld, torch.ones(128, 2), bits=6)
    port_comp.device_cascaded_decompress(*port_comp.device_cascaded_compress(v))
    assert _grew(before) == [0, 0, 0]


# ---------------------------------------------------------------------------
# The slice as a whole: the device codec and the fused product on one payload

def test_slice_against_reference(rng):
    x = np.cumsum(rng.integers(-60, 61, 64 * 128)).astype(np.int32)
    payload, meta = port_comp.device_cascaded_compress(from_numpy(x))
    rpay, rmeta = ref_comp.device_cascaded_compress(jnp.asarray(x))
    assert meta == rmeta == (len(x), 7)
    np.testing.assert_array_equal(payload[0].numpy(), np.asarray(rpay[0]))
    np.testing.assert_array_equal(port_comp.device_cascaded_decompress(payload, meta).numpy(), x)
    w = rng.normal(size=(128, 32)).astype(np.float32)
    got = dx.dx_decompress_dot(*payload, from_numpy(w), bits=7, scale=0.01)
    want = ref.dx_decompress_dot(*rpay, jnp.asarray(w), bits=7, scale=0.01)
    assert _rel(got, want) < REF_TOL
    assert to_numpy(got).shape == (64, 32)
