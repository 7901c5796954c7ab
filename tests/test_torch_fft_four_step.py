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
- The kernel's host plan (``_four_step_plan``): radices from the supported
  set whose product is each launch's length, large primes in direct passes,
  mode 2 cut at ``_best_split``, the threads and rows a block, only radix
  passes at the main shapes.
- A numpy model of the kernel's passes (``_model_launch``: the thread to
  butterfly map, the Stockham indices, the twiddles from the forward root
  table as the kernel forms them, the shared-memory padding, mode 2's C^T
  and its epilogue) against ``np.fft`` at N from 2 to 16384, both modes and
  both directions (rel-L2 1e-5: f32 sums in another order), and the bank
  wavefronts of every pass of the power-of-two main plans.
- The CUDA branch with the kernel library replaced by ``_EmulatedLib``, which
  extends the fused-kernel emulation of tests/test_torch_dx_fused.py with
  ``tml_four_step_fft``: it reads the plan words as the C side does and runs
  the model from the raw arguments (pointers, rows, the scratch of mode 2,
  the inverse flag, the forward root table): the launch counts (+1 and +2),
  the plain version never called, the N ≤ 16384 check and a failed launch
  raising.

Inputs are explicit f32 on both sides (the suite turns on jax x64).
"""

import contextlib
import math
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


@pytest.fixture
def tf32_restored():
    """The TF32 flag and the float32 matmul precision as they were, both set
    back after the test: a flag restored alone after the guard restored the
    precision it had read ("high" while TF32 was on) leaves torch's two
    precision settings disagreeing, and get_float32_matmul_precision raises
    in every later test of the process."""
    matmul = torch.backends.cuda.matmul
    tf32, precision = matmul.allow_tf32, torch.get_float32_matmul_precision()
    yield
    matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(precision)


@pytest.mark.parametrize("site", ["syevj", "gesvdj", "xormqr", "sddmm_bsr"])
def test_c16_sites_keep_f32_products_under_tf32(site, tf32_restored, monkeypatch):
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

# ---------------------------------------------------------------------------
# A numpy model of csrc/fft_four_step.cu

POINTS_MAX_THREADS = {port.FOUR_STEP_POINTS_POW2: 1024, port.FOUR_STEP_POINTS_MIXED: 256}


def _pad(f):
    """The power-of-two family's shared-memory index of flat index f: one
    float of padding after every 32."""
    return f + (f >> 5)



def _launch_passes(radices, n):
    """(radix, ns, stride) of each pass as the C side builds them: a copy
    (radix 1) first where the plan has no pass or opens with a direct one."""
    out, ns = [], 1
    if not radices or radices[0] not in port.REGISTER_RADICES:
        out.append((1, 1, n))
    for r in radices:
        out.append((r, ns, n // (ns * r)))
        ns *= r
    return out


def _dft_matrix(r):
    k = np.arange(r)
    return np.exp(-2j * np.pi * np.outer(k, k) / r).astype(np.complex64)


def _twiddle(v, w, e, r):
    """Point q of each butterfly (rows of v) times w^{q·e} as the kernel
    applies it: w^{(q mod 4)·e} (w^e from the table, w^{2e} and w^{3e} by
    products), then w^{4·(q div 4)·e} (w^{4e} from the table, its powers by
    products)."""
    one = np.ones_like(w[e])
    low = [one, w[e]]
    low += [low[1] * low[1]]
    low += [low[2] * low[1]]
    v = v * np.stack([low[q % 4] for q in range(r)], axis=-1)
    if r <= 4:
        return v
    high = [one, w[4 * e]]
    high += [high[1] * high[1]]
    high += [high[2] * high[1]]
    return v * np.stack([high[q // 4] for q in range(r)], axis=-1)


def _model_launch(lp, x, w, to_scratch):
    """One launch of the kernel on complex64 rows x (rows, N), forward; w the
    forward root table. Returns the rows it writes: y, or mode 2's first
    launch's Cᵀ (n2 rows of n1, each times w^{k1·n2})."""
    rows, n = x.shape
    pow2 = lp.points == port.FOUR_STEP_POINTS_POW2
    index = _pad if pow2 else (lambda f: f)
    ld = port._four_step_plane_floats(n, lp.lanes, to_scratch)
    smem = np.zeros((rows, ld), np.complex64)
    passes = _launch_passes(lp.radices, n)
    y = None
    for step, (r, ns, stride) in enumerate(passes):
        first, last = step == 0, step == len(passes) - 1
        nb = n // r
        read = (lambda f: x[:, f]) if first else (lambda f: smem[:, index(f)])
        if r == 1 or r in port.REGISTER_RADICES:
            b = -(-lp.points // r)
            u = (np.arange(lp.threads)[:, None] + np.arange(b)[None, :] * lp.threads).ravel()
            u = u[u < nb]
            assert np.array_equal(np.sort(u), np.arange(nb)), "a butterfly missed or taken twice"
            v = read(u[:, None] + np.arange(r)[None, :] * nb)
            j, lane = u // lp.lanes, u % lp.lanes
            k = j % ns
            if ns > 1:
                v = _twiddle(v, w, k * stride, r)
            v = v @ _dft_matrix(r)
            pos = (j - k)[:, None] * r + k[:, None] + np.arange(r)[None, :] * ns
            lane = np.broadcast_to(lane[:, None], pos.shape)
        else:   # a direct pass
            f = np.arange(n)
            u, q = f % nb, f // nb
            j, lane = u // lp.lanes, u % lp.lanes
            k = j % ns
            m, e = ns * r, np.zeros(n, np.int64)
            v = np.zeros((rows, n), np.complex64)
            for t0 in range(0, r, 64):   # the kernel's chunks of 64 terms
                part = np.zeros((rows, n), np.complex64)
                for t in range(t0, min(r, t0 + 64)):
                    part += read(u + t * nb) * w[e * stride]
                    e = e + k + q * ns
                    e = np.where(e >= m, e - m, e)
                v += part
            pos = (j - k) * r + k + q * ns
        out = pos * lp.lanes + lane
        assert np.array_equal(np.sort(out.ravel()), np.arange(n)), "an output missed or written twice"
        if last and not to_scratch:
            y = np.empty((rows, n), np.complex64)
            y[:, out] = v
        elif last:
            smem[:, lane * (lp.length + 1) + pos] = v
        else:
            smem[:, index(out)] = v
    if to_scratch:
        f = np.arange(n)
        col = f // lp.length
        k1 = f - col * lp.length
        y = smem[:, f + col] * w[k1 * col]
    return y


def _forward_roots(n):
    r = port._roots(n, False)
    return (r[:, 0] + 1j * r[:, 1]).astype(np.complex64)


def _model_fft(x, inverse, mode):
    """The kernel's transform of complex64 rows through the model: forward
    passes on the forward table, conjugated in and out for the inverse."""
    n = x.shape[-1]
    plan = port._four_step_plan(n, mode)
    w = _forward_roots(n)
    z = np.conj(x) if inverse else x
    for i, lp in enumerate(plan.launches):
        z = _model_launch(lp, z, w, mode == 2 and i == 0)
    return np.conj(z) if inverse else z


def _parse_plan(words, n1, n2, mode):
    """The plan's launches as the C side reads them, or None where it would
    refuse them."""
    n, at, launches = n1 * n2, 3, []
    if len(words) < 3 or words[:3] != [mode, n1, n2]:
        return None
    for i in range(mode):
        if at + 6 > len(words):
            return None
        length, lanes, threads, rows, points, npasses = words[at:at + 6]
        radices = tuple(words[at + 6:at + 6 + npasses])
        at += 6 + npasses
        want = (n, 1) if mode == 1 else ((n1, n2) if i == 0 else (n2, n1))
        pow2 = points == port.FOUR_STEP_POINTS_POW2
        if ((length, lanes) != want or points not in POINTS_MAX_THREADS
                or (pow2 and (n < 4 or n & (n - 1))) or threads * points < n
                or (pow2 and (not radices or radices[0] not in port.REGISTER_RADICES))
                or not 1 <= threads * rows <= POINTS_MAX_THREADS[points]
                or len(radices) != npasses or math.prod(radices) != length
                or any(r < 2 or (pow2 and r not in (2, 4, 8, 16)) for r in radices)):
            return None
        launches.append(port.FourStepLaunch(length, lanes, threads, rows, points, radices))
    return launches if at == len(words) else None


class _EmulatedLib(_EmulatedFusedLib):
    """Adds tml_four_step_fft's contract, computed on the CPU from the raw
    arguments: the plan words read and checked as the C side reads them, the
    planes through their pointers, the model's passes on the root table the
    pointer gives (forward; conjugated in and out where ``inverse``), mode 2's
    Cᵀ (rows, n2, n1) written to the scratch and read back, the C side's
    refusals."""

    def __init__(self, rc=0):
        super().__init__(rc)
        self.four_step_calls = []

    def tml_four_step_fft(self, xr, xi, yr, yi, scratch, tab, rows, n1, n2, mode, inverse,
                          plan, plan_len, stream):
        self.four_step_calls.append(dict(rows=rows, n1=n1, n2=n2, mode=mode,
                                         scratch=bool(scratch)))
        if self.rc:
            return self.rc
        n = n1 * n2
        if mode not in (1, 2) or (mode == 2) != bool(scratch) or not 1 <= n <= 16384:
            return 1
        launches = _parse_plan(list(plan[:plan_len]), n1, n2, mode)
        if launches is None:
            return 1
        roots = _view(tab, F32, (n, 2), (2, 1)).numpy()
        w = (roots[:, 0] + 1j * roots[:, 1]).astype(np.complex64)
        planes = [_view(p, F32, (rows, n), (n, 1)).numpy() for p in (xr, xi)]
        z = planes[0] + 1j * planes[1]
        z = (np.conj(z) if inverse else z).astype(np.complex64)
        if mode == 2:
            c = _model_launch(launches[0], z, w, True)
            mid = _view(scratch, F32, (2, rows, n), (rows * n, n, 1))
            mid[0].copy_(torch.from_numpy(np.ascontiguousarray(c.real)))
            mid[1].copy_(torch.from_numpy(np.ascontiguousarray(c.imag)))
            z = (mid[0].numpy() + 1j * mid[1].numpy()).astype(np.complex64)
        z = _model_launch(launches[-1], z, w, False)
        z = np.conj(z) if inverse else z
        _view(yr, F32, (rows, n), (n, 1)).copy_(torch.from_numpy(np.ascontiguousarray(z.real)))
        _view(yi, F32, (rows, n), (n, 1)).copy_(torch.from_numpy(np.ascontiguousarray(z.imag)))
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


# ---------------------------------------------------------------------------
# The kernel's plan

PLAN_NS = [1, 2, 3, 16, 49, 127, 243, 360, 625, 1000, 1021, 2048, 4096, 8192, 12289, 15625,
           16383, 16384]


def _prime_factors(n):
    out, p = [], 2
    while n > 1:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 1
    return out


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("n", PLAN_NS)
def test_plan_radices(n, mode):
    """Each launch's radices multiply to its length; each is a register
    radix or a prime above 5 (a direct pass); every prime factor above 5
    gets its own direct pass; mode 2 cuts at _best_split."""
    plan = port._four_step_plan(n, mode)
    n1, n2 = port._best_split(n)
    assert (plan.mode, plan.n1, plan.n2) == (mode, n1, n2)
    shapes = [(n, 1)] if mode == 1 else [(n1, n2), (n2, n1)]
    assert [(lp.length, lp.lanes) for lp in plan.launches] == shapes
    for lp in plan.launches:
        assert math.prod(lp.radices) == lp.length
        assert all(r in port.REGISTER_RADICES or (r > 5 and _prime_factors(r) == [r])
                   for r in lp.radices)
        big = sorted(p for p in _prime_factors(lp.length) if p > 5)
        assert sorted(r for r in lp.radices if r not in port.REGISTER_RADICES) == big
        assert sum(r in (2, 4, 8) for r in lp.radices) <= 1   # one pass for the power of two left


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("n", PLAN_NS)
def test_plan_geometry(n, mode):
    """Threads cover the row at 16 points a thread (a power of two from 4)
    or 64; rows share a block up to 256 threads (a power-of-two block has
    256 exactly, or one row of N / 16 threads from N = 4096) within the
    family's launch bound and the block's 227 KB of shared memory, as the C
    side sizes a row (two planes of _plane_floats and one float)."""
    for i, lp in enumerate(port._four_step_plan(n, mode).launches):
        pow2 = n >= 4 and n & (n - 1) == 0
        assert lp.points == (port.FOUR_STEP_POINTS_POW2 if pow2 else port.FOUR_STEP_POINTS_MIXED)
        assert lp.threads * lp.points >= n > (lp.threads - 1) * lp.points
        row_bytes = 4 * (2 * port._four_step_plane_floats(n, lp.lanes, mode == 2 and i == 0) + 1)
        assert lp.rows == max(1, min(256 // lp.threads, 232448 // row_bytes))
        assert lp.rows * row_bytes <= 232448
        assert lp.threads * lp.rows <= POINTS_MAX_THREADS[lp.points]
        if pow2:
            assert lp.threads * lp.rows == max(256, n // 16)
        if n >= 4096:
            assert lp.rows == 1


def test_main_shapes_hold_only_radix_passes():
    """4096 and 16384: radix-16 passes and one smaller power of two, no
    direct pass, 256 and 1024 threads a row."""
    want = {(4096, 1): [(16, 16, 16)], (4096, 2): [(16, 4), (16, 4)],
            (16384, 1): [(16, 16, 16, 4)], (16384, 2): [(16, 8), (16, 8)]}
    for (n, mode), radices in want.items():
        plan = port._four_step_plan(n, mode)
        assert [lp.radices for lp in plan.launches] == radices
        assert {lp.threads for lp in plan.launches} == {n // 16}


def test_plan_words_and_cache():
    """The words the C side reads, built once a (N, mode)."""
    plan = port._four_step_plan(360, 2)
    assert port._four_step_plan(360, 2) is plan
    words = list(plan.words)
    assert words[:3] == [2, 18, 20]
    assert _parse_plan(words, 18, 20, 2) == list(plan.launches)
    assert _parse_plan(words, 20, 18, 2) is None
    assert _parse_plan(words[:-1], 18, 20, 2) is None


# ---------------------------------------------------------------------------
# The model of the kernel against numpy

MODEL_NS = [2, 16, 127, 243, 360, 625, 1000, 1021, 4096, 8192, 16383, 16384]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("n", MODEL_NS)
def test_model_against_numpy(rng, n, mode, inverse):
    """The kernel's passes, in f32, against np.fft.fft and np.fft.ifft·N in
    float64: rel-L2 < 1e-5 (f32 sums in another order)."""
    x, _, _ = _planes(rng, (3, n))
    want = np.fft.ifft(x.astype(np.complex128)) * n if inverse else np.fft.fft(x.astype(np.complex128))
    assert rel_l2(_model_fft(x, inverse, mode), want) < 1e-5


def _bank_wavefronts(addresses):
    """(wavefronts, ideal) of warp-wide shared-memory accesses: each row of
    ``addresses`` is one instruction of a block's threads (-1 = inactive)."""
    got = ideal = 0
    for a in addresses:
        for w0 in range(0, len(a), 32):
            warp = a[w0:w0 + 32]
            warp = np.unique(warp[warp >= 0])
            if len(warp):
                got += np.bincount(warp % 32, minlength=32).max()
                ideal += 1
    return got, ideal


@pytest.mark.parametrize("n, mode", [(1024, 1), (2048, 1), (4096, 1), (8192, 1), (16384, 1),
                                     (4096, 2), (16384, 2)])
def test_padding_bank_wavefronts(n, mode):
    """Every shared-memory read and write of every pass, warp by warp, at the
    kernel's addresses (rows a block at their offsets, one float of padding
    after every 32, mode 2's Cᵀ rows of n1 + 1): one wavefront each, but for
    the writes of mode 1's second radix-16 pass (ns = 16: two runs of 16
    floats 256 apart), which take two on half of the banks. The padding
    keeps each row inside its plane."""
    f = np.arange(n)
    assert len(np.unique(_pad(f))) == n
    plan = port._four_step_plan(n, mode)
    for li, lp in enumerate(plan.launches):
        to_scratch = mode == 2 and li == 0
        ld = port._four_step_plane_floats(n, lp.lanes, to_scratch)
        assert _pad(n - 1) < ld and (not to_scratch or lp.lanes * (lp.length + 1) <= ld)
        tid = np.arange(lp.threads * lp.rows)
        t, base = tid % lp.threads, (tid // lp.threads) * (2 * ld + 1)
        passes = _launch_passes(lp.radices, n)
        for step, (r, ns, _) in enumerate(passes):
            first, last = step == 0, step == len(passes) - 1
            nb, reads, writes = n // r, [], []
            for i in range(-(-lp.points // r)):
                u = t + i * lp.threads
                live = u < nb
                j, lane = u // lp.lanes, u % lp.lanes
                k = j % ns
                for q in range(r):
                    if not first:
                        reads.append(np.where(live, base + _pad(np.minimum(u + q * nb, n - 1)), -1))
                    pos = (j - k) * r + k + q * ns
                    if last and not to_scratch:
                        continue
                    at = (lane * (lp.length + 1) + pos if last
                          else _pad(np.minimum(pos * lp.lanes + lane, n - 1)))
                    writes.append(np.where(live, base + at, -1))
            got, ideal = _bank_wavefronts(reads)
            assert got == ideal, (li, step, "reads", got, ideal)
            got, ideal = _bank_wavefronts(writes)
            if mode == 1 and r == 16 and ns == 16:
                assert got == 2 * ideal, (li, step, "writes", got, ideal)
            else:
                assert got == ideal, (li, step, "writes", got, ideal)

