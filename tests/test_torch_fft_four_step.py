"""Parity of the port's matmul four-step FFT in one launch (kernel B5b,
``fft.kernels.pallas_fft``) and in two (B5c, ``fft.pallas_split.pallas_fft2``)
with the reference's Pallas kernels, run in interpret mode, and the device
cache of the FFT tables.

- ``pallas_fft`` at (12, 4096), ``tile=4``, as tests/test_fft_kernels.py:63-74
  runs the reference, and ``pallas_fft2`` at (12, 4096) and a padded
  (5, 360), ``tile=2``: rel-L2 ≤ 1e-5 against the reference's output (the
  same Karatsuba products in another sum order; measured below 2e-7), and the
  reference test's 1e-4 against numpy for the forward transform and the
  round trip to N·x.
- The root table the kernel reads: its gathered stage matrices and twiddle
  equal the reference's ``_dft_mats`` and ``_twiddle`` within one f32
  rounding; ``_best_split`` and the tables equal the reference's.
- The plain version at a prime N (n1 = 1), a (2, 3, N) batch, bf16 planes.
- No host copy of a table on a second call (``_fft_planar``, ``pallas_fft``,
  ``pallas_fft2``, ``gemm_fft_composed``).
- C16: the f32 product sites that missed their bound under TF32 on the card
  run their products inside ``_f32_products``, TF32 off, and the caller's
  setting comes back.
- The CUDA branch with the kernel library replaced by ``_EmulatedLib``, which
  extends the fused-kernel emulation of tests/test_torch_dx_fused.py with
  ``tml_four_step_fft`` and computes it from the raw arguments by the
  kernel's own index arithmetic on the root table: pointers, shapes, the
  scratch of mode 2, the launch counts (+1 and +2), the plain version never
  called, the N ≤ 16384 check and a failed launch raising.

Inputs are explicit f32 on both sides (the suite turns on jax x64).
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.fft import kernels as ref_kernels
from tpumathlib.fft import pallas_split as ref_split
from tpumathlib_torch.core.check import rel_l2
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.core.interop import from_numpy
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx import fused
from tpumathlib_torch.fft import kernels as port
from tpumathlib_torch.fft import pallas_split
from test_torch_dx_fused import _EmulatedLib as _EmulatedFusedLib
from test_torch_dx_gemm import _view

torch.set_num_threads(1)

REF_TOL = 1e-5    # rel-L2 against the reference's kernels
NP_TOL = 1e-4     # rel-L2 against numpy (tests/test_fft_kernels.py:71-74)
F32 = torch.float32


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _planes(rng, shape):
    x = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    return x, np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)


def _cplx(pair):
    return np.asarray(pair[0], np.float64) + 1j * np.asarray(pair[1], np.float64)


def _port_pair(pair):
    return _cplx(tuple(t.numpy() for t in pair))


# ---------------------------------------------------------------------------
# Against the reference's kernels, in interpret mode

def test_pallas_fft_against_the_reference_kernel(rng):
    x, xr, xi = _planes(rng, (12, 4096))
    ref = ref_kernels.pallas_fft(jnp.asarray(xr), jnp.asarray(xi), tile=4)
    got = port.pallas_fft(from_numpy(xr), from_numpy(xi), tile=4)
    assert got[0].dtype == got[1].dtype == F32 and got[0].shape == (12, 4096)
    y = _port_pair(got)
    assert rel_l2(y, _cplx(ref)) < REF_TOL
    assert rel_l2(y, np.fft.fft(x, axis=-1)) < NP_TOL
    back = port.pallas_fft(*got, inverse=True, tile=4)
    ref_back = ref_kernels.pallas_fft(*ref, inverse=True, tile=4)
    assert rel_l2(_port_pair(back), _cplx(ref_back)) < REF_TOL
    assert rel_l2(_port_pair(back), 4096 * x) < NP_TOL


@pytest.mark.parametrize("shape", [(12, 4096), (5, 360)])
def test_pallas_fft2_against_the_reference_kernels(rng, shape):
    """(5, 360) is padded to a whole tile in the reference (tile 2)."""
    x, xr, xi = _planes(rng, shape)
    for inverse, want in ((False, np.fft.fft(x, axis=-1)),
                          (True, np.fft.ifft(x, axis=-1) * shape[-1])):
        ref = ref_split.pallas_fft2(jnp.asarray(xr), jnp.asarray(xi), inverse=inverse, tile=2)
        got = pallas_split.pallas_fft2(from_numpy(xr), from_numpy(xi), inverse=inverse, tile=2)
        assert got[0].shape == shape and got[0].dtype == F32
        assert rel_l2(_port_pair(got), _cplx(ref)) < REF_TOL
        assert rel_l2(_port_pair(got), want) < NP_TOL


# ---------------------------------------------------------------------------
# The tables

@pytest.mark.parametrize("n", [16, 127, 360, 1000, 4096, 16384])
def test_root_table_gives_the_references_matrices(n):
    """The kernel's factors, gathered from the root table by its index
    arithmetic, against the reference's (n1, n1), (n1, n2) and (n2, n2)
    tables: within one f32 rounding."""
    n1, n2 = port._best_split(n)
    assert (n1, n2) == ref_kernels._best_split(n)
    for inverse in (False, True):
        roots = port._roots(n, inverse)
        w = roots[:, 0] + 1j * roots[:, 1]
        k1, k2 = np.arange(n1), np.arange(n2)
        gathered = {
            "w1": (w[(np.outer(k1, k1) % n1) * n2], ref_kernels._dft_mats(n1, inverse)),
            "twiddle": (w[np.outer(k1, k2)], ref_kernels._twiddle(n1, n2, inverse)),
            "w2": (w[(np.outer(k2, k2) % n2) * n1], ref_kernels._dft_mats(n2, inverse)),
        }
        for name, (got, (wr, wi)) in gathered.items():
            err = max(np.abs(got.real - wr).max(), np.abs(got.imag - wi).max())
            assert err <= np.finfo(np.float32).eps, (name, err)


def test_tables_equal_the_references():
    for n in (64, 360):
        for inverse in (False, True):
            for got, want in zip(port._dft_mats(n, inverse), ref_kernels._dft_mats(n, inverse)):
                assert np.array_equal(got, want)
    for got, want in zip(port._twiddle(18, 20, True), ref_kernels._twiddle(18, 20, True)):
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# The plain version

@pytest.mark.parametrize("n", [127, 1000])
def test_plain_version_batch_and_bf16(rng, n):
    """A prime N runs stage 2 alone (n1 = 1); a (2, 3, N) batch keeps its
    shape; bf16 planes are read as f32 (their FFT in float64 is the oracle)."""
    x, xr, xi = _planes(rng, (2, 3, n))
    for fn in (port.pallas_fft, pallas_split.pallas_fft2):
        got = fn(from_numpy(xr), from_numpy(xi))
        assert got[0].shape == (2, 3, n) and got[0].dtype == F32
        assert rel_l2(_port_pair(got), np.fft.fft(x, axis=-1)) < 1e-5
        hr, hi = from_numpy(xr).bfloat16(), from_numpy(xi).bfloat16()
        got = fn(hr, hi, inverse=True)
        assert got[0].dtype == F32
        want = np.fft.ifft(hr.double().numpy() + 1j * hi.double().numpy(), axis=-1) * n
        assert rel_l2(_port_pair(got), want) < 1e-5


# ---------------------------------------------------------------------------
# No host copy of a table on a second call

def test_tables_reach_the_device_once(rng, monkeypatch):
    _, xr, xi = _planes(rng, (4, 1000))
    a, b = (from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((8, 16), (16, 96)))
    tr, ti = from_numpy(xr), from_numpy(xi)
    calls = [lambda: port._fft_planar(tr, ti, False),
             lambda: port._fft_planar(tr, ti, True),
             lambda: port.pallas_fft(tr, ti),
             lambda: pallas_split.pallas_fft2(tr, ti, inverse=True),
             lambda: port.pallas_fft(tr[:, :997], ti[:, :997]),   # a prime N
             lambda: fused.gemm_fft_composed(a, b)]
    first = [c() for c in calls]
    copies = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda t: copies.append(t.shape) or real(t))
    hits = port._dft_on.cache_info().hits
    second = [c() for c in calls]
    assert copies == []
    assert port._dft_on.cache_info().hits > hits
    for f, s in zip(first, second):
        assert all(torch.equal(u, v) for u, v in zip(f, s))


# ---------------------------------------------------------------------------
# C16: the f32 product sites pinned with the guard

def _c16_site(name):
    from tpumathlib_torch import sparse
    from tpumathlib_torch.solver import dense, jacobi
    from tpumathlib_torch.sparse import ops

    g = torch.randn((2, 8, 8), generator=torch.Generator().manual_seed(3))
    if name == "syevj":
        return jacobi, lambda: jacobi.syevj(g + g.mT)
    if name == "gesvdj":
        return jacobi, lambda: jacobi.gesvdj(g)
    if name == "xormqr":
        return dense, lambda: dense.xormqr(g[0], g[1], "L", "T")
    pattern = sparse.BSR(torch.tensor([0, 1, 2], dtype=torch.int32),
                         torch.tensor([0, 1], dtype=torch.int32), torch.zeros((2, 4, 4)), (8, 8), 4)
    return ops, lambda: sparse.sddmm_bsr(g[0], g[1], pattern)


@pytest.mark.parametrize("site", ["syevj", "gesvdj", "xormqr", "sddmm_bsr"])
def test_c16_sites_keep_f32_products_under_tf32(site, monkeypatch):
    """ROADMAP C16: with TF32 turned on by the caller, each site the card
    showed missing its f32 bound runs its products inside the guard, with
    TF32 off, and the caller's setting comes back after."""
    mod, call = _c16_site(site)
    seen = []
    real = port._f32_products

    @contextlib.contextmanager
    def spy():
        with real():
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            yield

    monkeypatch.setattr(mod, "_f32_products", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    call()
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry point

class _EmulatedLib(_EmulatedFusedLib):
    """Adds tml_four_step_fft's contract, computed on the CPU from the raw
    arguments by the kernel's index arithmetic: the planes through their
    pointers, rows, n1 and n2; every factor gathered from the root table
    (W1 at ((k1·j) mod n1)·n2, the twiddle at k1·n2, W2 at ((j·k2) mod
    n2)·n1); in mode 2 the intermediate Cᵀ (rows, n2, k1) written to and read
    back from the scratch; the C side's refusals."""

    def __init__(self, rc=0):
        super().__init__(rc)
        self.four_step_calls = []

    def tml_four_step_fft(self, xr, xi, yr, yi, scratch, tab, rows, n1, n2, mode, stream):
        self.four_step_calls.append(dict(rows=rows, n1=n1, n2=n2, mode=mode,
                                         scratch=bool(scratch)))
        if self.rc:
            return self.rc
        n = n1 * n2
        if mode not in (1, 2) or (mode == 2) != bool(scratch) or not 1 <= n <= 16384:
            return 1
        roots = _view(tab, F32, (n, 2), (2, 1)).double()
        w = torch.complex(roots[:, 0], roots[:, 1])
        k1, k2 = torch.arange(n1), torch.arange(n2)
        w1 = w[(torch.outer(k1, k1) % n1) * n2]           # (j, k1)
        tw = w[torch.outer(k2, k1)]                        # (n2, k1)
        w2 = w[(torch.outer(k2, k2) % n2) * n1]           # (k2, j)
        x = torch.complex(*(_view(p, F32, (rows, n1, n2), (n, n2, 1)).double() for p in (xr, xi)))
        ct = torch.einsum("bjr,jc->brc", x, w1) * tw       # Cᵀ (rows, n2, k1)
        if mode == 2:
            mid = _view(scratch, F32, (2, rows, n2, n1), (rows * n, n, n1, 1))
            mid[0].copy_(ct.real)
            mid[1].copy_(ct.imag)
            ct = torch.complex(mid[0].double(), mid[1].double())
        d = torch.einsum("kj,bjc->bkc", w2, ct).reshape(rows, n)   # y[k2·n1 + k1]
        _view(yr, F32, (rows, n), (n, 1)).copy_(d.real)
        _view(yi, F32, (rows, n), (n, 1)).copy_(d.imag)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    for mod in (port, pallas_split):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args, **kw):
        raise AssertionError("the plain version ran on the CUDA branch")

    monkeypatch.setattr(port, "_four_step_plain", no_plain)
    monkeypatch.setattr(pallas_split, "_four_step_plain", no_plain)
    return lib


ROUTES = {"fused": (port.pallas_fft, 1), "split": (pallas_split.pallas_fft2, 2)}


@pytest.mark.parametrize("kind", sorted(ROUTES))
@pytest.mark.parametrize("n", [16, 127, 360, 4096])
def test_cuda_branch(emulated, rng, kind, n):
    fn, mode = ROUTES[kind]
    x, xr, xi = _planes(rng, (5, n))
    tr, ti = from_numpy(xr), from_numpy(xi)
    for inverse, want in ((False, np.fft.fft(x, axis=-1)), (True, np.fft.ifft(x, axis=-1) * n)):
        before = fn.launches
        got = fn(tr, ti, inverse=inverse)
        assert fn.launches == before + mode
        assert got[0].shape == (5, n) and got[0].dtype == F32
        assert rel_l2(_port_pair(got), want) < 1e-5
    n1, n2 = port._best_split(n)
    assert emulated.four_step_calls == [dict(rows=5, n1=n1, n2=n2, mode=mode,
                                             scratch=mode == 2)] * 2


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_cuda_branch_batch_strides_and_bf16(emulated, rng, kind):
    """A (2, 3, N) strided view and bf16 planes reach the kernel as
    contiguous f32 rows; the output keeps the batch shape."""
    fn, mode = ROUTES[kind]
    x, xr, xi = _planes(rng, (2, 3, 2 * 360))
    tr, ti = from_numpy(xr)[..., ::2], from_numpy(xi)[..., ::2].bfloat16()
    got = fn(tr, ti)
    assert got[0].shape == (2, 3, 360) and got[0].dtype == F32
    want = np.fft.fft(tr.double().numpy() + 1j * ti.double().numpy(), axis=-1)
    assert rel_l2(_port_pair(got), want) < 1e-5
    assert emulated.four_step_calls[-1]["rows"] == 6


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_cuda_branch_empty_batch_launches_nothing(emulated, kind):
    fn, _ = ROUTES[kind]
    before = fn.launches
    got = fn(torch.ones((0, 64)), torch.ones((0, 64)))
    assert got[0].shape == (0, 64) and fn.launches == before
    assert emulated.four_step_calls == []


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_cuda_branch_refuses_n_above_16384(emulated, kind):
    fn, _ = ROUTES[kind]
    before = fn.launches
    with pytest.raises(InvalidValueError, match="1 <= N <= 16384"):
        fn(torch.ones((2, 16385)), torch.ones((2, 16385)))
    assert fn.launches == before and emulated.four_step_calls == []


@pytest.mark.parametrize("kind", sorted(ROUTES))
def test_cuda_branch_raises_on_launch_failure(emulated, kind):
    fn, _ = ROUTES[kind]
    emulated.rc = 9
    before = fn.launches
    with pytest.raises(ExecutionError, match="tml_four_step_fft: CUDA error 9"):
        fn(torch.ones((2, 64)), torch.ones((2, 64)))
    assert fn.launches == before


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(port, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        port.pallas_fft(torch.ones((2, 64)), torch.ones((2, 64)))


def test_cpu_takes_the_plain_version_without_launch(rng):
    _, xr, xi = _planes(rng, (3, 256))
    before = (port.pallas_fft.launches, pallas_split.pallas_fft2.launches)
    port.pallas_fft(from_numpy(xr), from_numpy(xi))
    pallas_split.pallas_fft2(from_numpy(xr), from_numpy(xi))
    assert (port.pallas_fft.launches, pallas_split.pallas_fft2.launches) == before


def test_fft_package_exports_neither():
    """As the reference's fft/__init__.py: the two are reached by module."""
    import tpumathlib_torch.fft as pkg

    assert not hasattr(pkg, "pallas_fft") and not hasattr(pkg, "pallas_fft2")
