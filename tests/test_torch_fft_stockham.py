"""Parity of tpumathlib_torch.fft.stockham (kernel B5, ``dif_fft``) with the
reference.

- The tables (``_rowstage_twiddles``, ``_dft_tables``, ``_bitrev``,
  ``shuffle_perm``) must equal the reference's exactly.
- ``dif_fft`` (its plain route on CPU tensors) against the reference's
  ``dif_fft`` in interpret mode (``tile=4``, as ``tests/test_fft_kernels.py``
  runs it) on the same seeded f32 planes. Tolerances (rel-L2): 2e-5 against
  the reference's default product, which is a bf16x2 3M product at about
  5e-6; 2e-6 against ``exact=True``; bf16 planes within 1e-2 of each other
  and each < 8e-3 against float64 numpy (one bf16 rounding of the input and
  of the output).
- The raw order (``reorder=False``) element for element, for ``collapse``
  1 and 2: it depends on ``collapse``.
- The CUDA branch with the kernel library replaced by a CPU emulation of
  ``tml_dif_fft``, which decodes the direction, the order and the plane
  type from the pointers and sizes the wrapper passes.

Inputs are explicit f32 on both sides (the suite turns on jax x64).
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.fft import stockham as ref_st
from tpumathlib_torch.core.check import rel_l2
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.fft import stockham as st
from test_torch_dx_gemm import _view

torch.set_num_threads(1)

SIZES = [256, 1024, 4096]
TABLE_SIZES = [256 << i for i in range(9)]   # 256 .. 65536


def _planes(rng, shape):
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return x, x.real.astype(np.float32), x.imag.astype(np.float32)


def _np(y):
    return y.double().numpy() if isinstance(y, torch.Tensor) else np.asarray(y, np.float64)


def _cplx(yr, yi):
    return _np(yr) + 1j * _np(yi)


def _port(xr, xi, **kw):
    return st.dif_fft(torch.from_numpy(xr), torch.from_numpy(xi), **kw)


def _ref(xr, xi, **kw):
    return ref_st.dif_fft(jnp.asarray(xr), jnp.asarray(xi), tile=4, **kw)


# ---------------------------------------------------------------------------
# The tables

@pytest.mark.parametrize("n", TABLE_SIZES)
def test_rowstage_twiddles_equal_reference(n):
    for inverse in (False, True):
        for got, want in zip(st._rowstage_twiddles(n, inverse),
                             ref_st._rowstage_twiddles(n, inverse)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", TABLE_SIZES)
def test_shuffle_perm_equals_reference(n):
    for c in (1, 2, 4):
        if c > n // 128:
            continue
        got = st.shuffle_perm(n, c)
        np.testing.assert_array_equal(got, ref_st.shuffle_perm(n, c))
        assert np.array_equal(np.sort(got), np.arange(n))   # a permutation
    np.testing.assert_array_equal(st._bitrev_perm(n), ref_st._bitrev_perm(n))


def test_dft_and_bitrev_tables_equal_reference():
    for size in (128, 256, 512):
        for inverse in (False, True):
            for got, want in zip(st._dft_tables(size, inverse), ref_st._dft_tables(size, inverse)):
                np.testing.assert_array_equal(got, want)
    for got, want in zip(st._dft128_tables(True), ref_st._dft128_tables(True)):
        np.testing.assert_array_equal(got, want)
    for nbits in range(17):
        np.testing.assert_array_equal(st._bitrev(nbits), ref_st._bitrev(nbits))


# ---------------------------------------------------------------------------
# dif_fft against the reference's kernel (interpret mode)

@pytest.mark.parametrize("n", SIZES)
def test_natural_and_inverse_match_reference(n, rng):
    x, xr, xi = _planes(rng, (4, n))
    yr, yi = _port(xr, xi)
    rr, ri = _ref(xr, xi)
    assert yr.dtype == yi.dtype == torch.float32 and yr.shape == (4, n)
    assert rel_l2(_cplx(yr, yi), _cplx(rr, ri)) < 2e-5
    assert rel_l2(_cplx(yr, yi), np.fft.fft(x)) < 1e-6
    # the unnormalised inverse, on the reference's own forward output
    fr, fi = np.array(rr, np.float32), np.array(ri, np.float32)
    zr, zi = _port(fr, fi, inverse=True)
    wr, wi = _ref(fr, fi, inverse=True)
    assert rel_l2(_cplx(zr, zi), _cplx(wr, wi)) < 2e-5
    assert rel_l2(_cplx(zr, zi), n * x) < 1e-5


@pytest.mark.parametrize("collapse", [1, 2])
@pytest.mark.parametrize("n", SIZES)
def test_raw_order_matches_reference(n, collapse, rng):
    _, xr, xi = _planes(rng, (4, n))
    yr, yi = _port(xr, xi, reorder=False, collapse=collapse)
    rr, ri = _ref(xr, xi, reorder=False, collapse=collapse)
    # element for element: both in the raw order of shuffle_perm(n, collapse)
    got, want = _cplx(yr, yi), _cplx(rr, ri)
    assert rel_l2(got, want) < 2e-5
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-4 * scale
    perm = st.shuffle_perm(n, collapse)
    assert rel_l2(got[:, perm], np.fft.fft(xr + 1j * xi.astype(np.float64))) < 1e-6
    if n > 256:   # another collapse is another order
        other = st.shuffle_perm(n, 3 - collapse)
        assert rel_l2(got[:, other], np.fft.fft(xr + 1j * xi.astype(np.float64))) > 0.5


@pytest.mark.parametrize("n", SIZES)
def test_exact_matches_reference(n, rng):
    x, xr, xi = _planes(rng, (4, n))
    yr, yi = _port(xr, xi, exact=True)
    rr, ri = _ref(xr, xi, exact=True)
    assert rel_l2(_cplx(yr, yi), _cplx(rr, ri)) < 2e-6
    assert rel_l2(_cplx(yr, yi), np.fft.fft(x)) < 1e-6


@pytest.mark.parametrize("n", SIZES)
def test_halfplanes_match_reference(n, rng):
    _, xr, xi = _planes(rng, (4, n))
    yr, yi = _port(xr, xi, halfplanes=True)
    rr, ri = _ref(xr, xi, halfplanes=True)
    assert yr.dtype == yi.dtype == torch.bfloat16 and rr.dtype == jnp.bfloat16
    got = _cplx(yr, yi)
    want = _cplx(rr, ri)
    assert rel_l2(got, want) < 1e-2
    exact = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    assert rel_l2(got, exact) < 8e-3 and rel_l2(want, exact) < 8e-3


def test_plain_route_never_calls_torch_fft(monkeypatch, rng):
    def refuse(*a, **k):
        raise AssertionError("torch.fft on the planar route")

    for name in ("fft", "ifft", "fftn", "rfft", "irfft"):
        monkeypatch.setattr(torch.fft, name, refuse)
    _, xr, xi = _planes(rng, (2, 512))
    _port(xr, xi)
    _port(xr, xi, inverse=True, reorder=False, collapse=2, halfplanes=True)


# ---------------------------------------------------------------------------
# Input handling

def test_batch_shape_cast_and_inputs_untouched(rng):
    n = 512
    x, xr, xi = _planes(rng, (2, 3, n))
    tr, ti = torch.from_numpy(xr.astype(np.float64)), torch.from_numpy(xi.astype(np.float64))
    keep_r, keep_i = tr.clone(), ti.clone()
    yr, yi = st.dif_fft(tr, ti)
    assert yr.shape == (2, 3, n) and yr.dtype == torch.float32
    assert torch.equal(tr, keep_r) and torch.equal(ti, keep_i)
    rr, ri = ref_st.dif_fft(jnp.asarray(xr.astype(np.float64)), jnp.asarray(xi.astype(np.float64)),
                            tile=4)
    assert rr.shape == (2, 3, n)
    assert rel_l2(_cplx(yr, yi), _cplx(rr, ri)) < 2e-5
    # f32 input: the planes themselves are read, and still left as they were
    fr, fi = torch.from_numpy(xr), torch.from_numpy(xi)
    keep_r = fr.clone()
    st.dif_fft(fr, fi, inverse=True)
    assert torch.equal(fr, keep_r)


def test_non_contiguous_input(rng):
    n = 256
    x, xr, xi = _planes(rng, (n, 6))
    tr, ti = torch.from_numpy(xr).T, torch.from_numpy(xi).T   # (6, n) views, stride (1, 6)
    yr, yi = st.dif_fft(tr, ti)
    assert rel_l2(_cplx(yr, yi), np.fft.fft(x.T)) < 1e-6


@pytest.mark.parametrize("n", [384, 128])
def test_bad_lengths_rejected_by_both(n):
    z = np.zeros((2, n), np.float32)
    with pytest.raises(InvalidValueError):
        st.dif_fft(torch.from_numpy(z), torch.from_numpy(z))
    with pytest.raises(AssertionError):
        ref_st.dif_fft(jnp.asarray(z), jnp.asarray(z), tile=4)


def test_bad_collapse_and_planes_rejected():
    z = torch.zeros((2, 256))
    for c in (3, 0, 4):
        with pytest.raises(InvalidValueError):
            st.dif_fft(z, z, collapse=c)
    with pytest.raises(InvalidValueError):
        st.dif_fft(z, torch.zeros((2, 512)))


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry point

_CODE_DTYPE = {0: torch.float32, 1: torch.bfloat16}


class _EmulatedLib:
    """tml_dif_fft's contract, computed on the CPU from the raw arguments:
    the planes through their pointers, rows and log2 N; the direction from
    the twiddle table's sign (checked against float64); the order from
    log_l (natural when log_l == log_n, else groups of L = 2^log_l)."""

    def __init__(self, rc=0):
        self.calls = []
        self.rc = rc

    def tml_dif_fft(self, xr, xi, yr, yi, scratch, tw, rows, log_n, log_l, bf16, stream):
        n = 1 << log_n
        dt = _CODE_DTYPE[bf16]
        table = _view(tw, torch.float32, (n // 2, 2), (2, 1)).clone()
        inverse = bool(table[1, 1] > 0)
        ang = (2.0 if inverse else -2.0) * np.pi * np.arange(n // 2) / n
        want = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
        assert np.array_equal(table.numpy(), want)
        self.calls.append(dict(rows=rows, log_n=log_n, log_l=log_l, bf16=bf16,
                               scratch=bool(scratch), inverse=inverse))
        if self.rc:
            return self.rc
        assert bool(scratch) == (n > 16384)
        planes = [_view(p, dt, (rows, n), (n, 1)) for p in (xr, xi, yr, yi)]
        natural = log_l == log_n
        gr, gi = st._dif_fft_plain(planes[0].clone(), planes[1].clone(), inverse=inverse,
                                   reorder=natural,
                                   collapse=1 if natural else 1 << (log_l - 7),
                                   halfplanes=bool(bf16))
        planes[2].copy_(gr)
        planes[3].copy_(gi)
        return 0

    def tml_error_string(self, rc):
        return b"emulated failure"


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    monkeypatch.setattr(st, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("case", ["natural", "inverse", "raw1", "raw2", "bf16", "batch", "strided"])
def test_cuda_branch_marshalling(emulated, case, rng):
    n = 1024
    shape = (2, 3, n) if case == "batch" else (4, n)
    _, xr, xi = _planes(rng, shape)
    tr, ti = torch.from_numpy(xr), torch.from_numpy(xi)
    if case == "strided":   # every other row of a wider batch
        _, wr, wi = _planes(rng, (8, n))
        tr, ti = torch.from_numpy(wr)[::2], torch.from_numpy(wi)[::2]
    kw = {"natural": {}, "inverse": {"inverse": True}, "raw1": {"reorder": False},
          "raw2": {"reorder": False, "collapse": 2}, "bf16": {"halfplanes": True},
          "batch": {}, "strided": {}}[case]
    before = st.dif_fft.launches
    got = st.dif_fft(tr, ti, **kw)
    assert st.dif_fft.launches == before + 1
    (call,) = emulated.calls
    assert call == dict(rows=4 if case != "batch" else 6, log_n=10,
                        log_l={"raw1": 7, "raw2": 8}.get(case, 10), bf16=int(case == "bf16"),
                        scratch=False, inverse=case == "inverse")
    want = st._dif_fft_plain(tr, ti, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape == tr.shape and g.dtype == w.dtype and torch.equal(g, w)


def test_cuda_branch_long_rows_pass_scratch(emulated, rng):
    n = 32768
    _, xr, xi = _planes(rng, (2, n))
    got = st.dif_fft(torch.from_numpy(xr), torch.from_numpy(xi), reorder=False)
    assert emulated.calls[0]["scratch"] and emulated.calls[0]["log_l"] == 7
    want = st._dif_fft_plain(torch.from_numpy(xr), torch.from_numpy(xi), reorder=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cuda_branch_raises_on_launch_failure(emulated, rng):
    emulated.rc = 9   # cudaErrorInvalidConfiguration
    _, xr, xi = _planes(rng, (2, 256))
    before = st.dif_fft.launches
    with pytest.raises(ExecutionError, match="tml_dif_fft: CUDA error 9"):
        st.dif_fft(torch.from_numpy(xr), torch.from_numpy(xi))
    assert st.dif_fft.launches == before


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    """For CUDA tensors the wrapper launches or raises, never falls back."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(st, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        st.dif_fft(torch.zeros(2, 256), torch.zeros(2, 256))


def test_cpu_takes_plain_version_without_launch(rng):
    _, xr, xi = _planes(rng, (2, 256))
    before = st.dif_fft.launches
    got = _port(xr, xi, halfplanes=True)
    assert st.dif_fft.launches == before
    want = st._dif_fft_plain(torch.from_numpy(xr), torch.from_numpy(xi), halfplanes=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
