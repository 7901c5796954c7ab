"""Parity of tpumathlib_torch.solver.onelaunch / blocked with the reference.

- The 128×128 sweeps (``_chol_inv128``, ``_lu128``, ``_inv_unit_lower128``,
  ``_inv_upper128``) against the reference's, called eagerly under
  ``jax.disable_jit()`` (a jitted trace of the unrolled sweep takes minutes
  on the CPU). Tolerance 1e-5 max-scaled: the same f32 steps, with the
  reductions in another order.
- A CPU model of the block kernels' own order of operations
  (``csrc/dense_block.cu``: the LU that carries both inverses in its
  columns, the Cholesky as LDLᵀ scaled at the end) against the plain
  sweeps at 1e-5.
- ``potrf_onelaunch`` / ``getrf_onelaunch`` (their plain route on CPU
  tensors) at n=512 and n=1024 against the reference's public CPU path (XLA
  cholesky, the unpivoted ``lax.scan`` elimination) and float64 LAPACK, at
  the reference tests' 5e-5 rel bound (``tests/test_solver_dense.py:343,357``).
- The CUDA branch with the kernel library replaced by a CPU emulation of
  the C entry points, reading the operands through the pointers and leading
  dimensions the wrappers pass; the streams and events of the look-ahead
  replaced by stand-ins that record where each launch went.

Inputs are explicit f32 on both sides (the suite turns on jax x64).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.solver import blocked as ref_blocked
from tpumathlib.solver import dense as ref_dense
from tpumathlib.solver import onelaunch as ref_onelaunch
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, InvalidValueError
from tpumathlib_torch.dx import cuda_utils, gemm, tf32x3
from tpumathlib_torch.solver import blocked, dense, onelaunch
from test_torch_dx_gemm import _EmulatedLib as _EmulatedGemmLib, _view

torch.set_num_threads(1)

NB = 128


def _spd(rng, n):
    g = rng.normal(size=(n, n))
    return (g @ g.T) / n + 4.0 * np.eye(n)


def _barely_dominant(rng, n):
    """Multipliers O(1): the regime where a wrong inverse order shows."""
    g = rng.normal(size=(n, n))
    return g + np.diag(1.05 * np.abs(g).sum(axis=1))


def _symmetric_dominant(rng, n):
    g = rng.normal(size=(n, n))
    s = (g + g.T) / 2
    return s + np.diag(1.05 * np.abs(s).sum(axis=1))


BLOCKS = {"spd": _spd, "symmetric_dominant": _symmetric_dominant,
          "barely_dominant": _barely_dominant}


def _close(got, want, tol):
    err = max_scaled_err(got, np.asarray(want).astype(np.float64))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


@pytest.mark.parametrize("kind", ["spd", "symmetric_dominant"])
def test_chol_inv128_matches_reference(kind, rng):
    x = BLOCKS[kind](rng, NB).astype(np.float32)
    with jax.disable_jit():
        rl, rw = ref_blocked._chol_inv128(jnp.asarray(x, jnp.float32))
    l, w = blocked._chol_inv128(torch.from_numpy(x))
    assert l.dtype == w.dtype == torch.float32
    _close(l, rl, 1e-5)
    _close(w, rw, 1e-5)
    assert torch.all(torch.triu(l, 1) == 0) and torch.all(torch.triu(w, 1) == 0)
    lw = l.double() @ w.double()
    assert torch.allclose(lw, torch.eye(NB, dtype=torch.float64), atol=1e-5)


@pytest.mark.parametrize("kind", ["barely_dominant", "spd"])
def test_lu_sweeps_match_reference(kind, rng):
    x = BLOCKS[kind](rng, NB).astype(np.float32)
    with jax.disable_jit():
        rlu = ref_onelaunch._lu128(jnp.asarray(x, jnp.float32))
        rwl = ref_onelaunch._inv_unit_lower128(rlu)
        rwu = ref_onelaunch._inv_upper128(rlu)
    lu = onelaunch._lu128(torch.from_numpy(x))
    _close(lu, rlu, 1e-5)
    _close(onelaunch._inv_unit_lower128(lu), rwl, 1e-5)
    _close(onelaunch._inv_upper128(lu), rwu, 1e-5)
    # the fused wrapper gives the three in one call, and they are inverses
    flu, wl, wu = onelaunch._lu_inv128(torch.from_numpy(x))
    assert torch.equal(flu, lu)
    lu64 = lu.double()
    eye = torch.eye(NB, dtype=torch.float64)
    assert torch.allclose(wl.double() @ (torch.tril(lu64, -1) + eye), eye, atol=1e-5)
    assert torch.allclose(wu.double() @ torch.triu(lu64), eye, atol=1e-5)


# ---------------------------------------------------------------------------
# A CPU model of csrc/dense_block.cu's sweeps, step for step: what step k
# hands on (the pivot column with col[k] = 1 and its copy zeroed down to
# row k, the pivot row, one scale), the pivot column's own change, and the
# FMA of every other column with the pivot-row value times the scale.

def _lu_inv_model(d):
    v = d.to(torch.float32).clone()
    nb = v.shape[0]
    lu = torch.empty_like(v)
    rows = torch.arange(nb)
    for k in range(nb):
        rp = 1.0 / v[k, k]                                    # the diagonal's owner
        col = v[:, k].clone()
        col[k] = 1.0
        below = torch.where(rows > k, col, torch.zeros_like(col))
        row = v[k].clone()
        lu[k, k + 1:] = row[k + 1:]                           # U's row k to the stage
        v[k, k + 1:] = 0.0                                    # ... and inv(U)'s row k starts at 0
        t = v[:, k] * rp                                      # the pivot column's own change
        lu[k, k], lu[k + 1:, k] = v[k, k], t[k + 1:]
        v[:, k] = torch.where(rows < k, t, torch.where(rows == k, rp, -t))
        rr = row * rp
        v[:, k + 1:] = torch.addcmul(v[:, k + 1:], -col[:, None], rr[None, k + 1:])
        v[:, :k] = torch.addcmul(v[:, :k], -below[:, None], rr[None, :k])
    eye = torch.eye(nb)
    return lu, torch.tril(v, -1) + eye, torch.triu(v)


def _chol_inv_model(d):
    v = d.to(torch.float32).clone()
    nb = v.shape[0]
    l = torch.zeros_like(v)
    rs_of = torch.empty(nb)
    rows = torch.arange(nb)
    for k in range(nb):
        rs = 1.0 / torch.sqrt(v[k, k])                        # NaN for a negative pivot
        rs_of[k] = rs
        rp = rs * rs
        below = torch.where(rows > k, v[:, k], torch.zeros(nb))
        row = torch.where(rows > k, below, v[k])              # right of k the column itself
        l[k:, k] = v[k:, k] * rs
        v[:, k] = torch.where(rows == k, 1.0, -(v[:, k] * rp))
        rr = row * rp
        keep = rows[None, :] == k                              # the pivot column is not updated
        v = torch.where(keep, v, torch.addcmul(v, -below[:, None], rr[None, :]))
    return l, torch.tril(v * rs_of[:, None])


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_lu_kernel_model_matches_plain(kind, rng):
    x = torch.from_numpy(BLOCKS[kind](rng, NB).astype(np.float32))
    for got, want in zip(_lu_inv_model(x), onelaunch._lu_inv128_plain(x)):
        _close(got, want.numpy(), 1e-5)


@pytest.mark.parametrize("kind", ["spd", "symmetric_dominant"])
def test_chol_kernel_model_matches_plain(kind, rng):
    x = torch.from_numpy(BLOCKS[kind](rng, NB).astype(np.float32))
    l, w = _chol_inv_model(x)
    want_l, want_w = blocked._chol_inv128_plain(x)
    _close(l, want_l.numpy(), 1e-5)
    _close(w, want_w.numpy(), 1e-5)
    assert torch.all(torch.triu(l, 1) == 0) and torch.all(torch.triu(w, 1) == 0)


def test_chol_kernel_model_not_spd_matches_plain_info(rng):
    x = torch.from_numpy(_spd(rng, NB).astype(np.float32))
    x[40, 40] = -1.0
    infos = [int(dense._finite_info(f(x)[0], diag_only=True))
             for f in (_chol_inv_model, blocked._chol_inv128_plain)]
    assert infos == [41, 41]


def test_chol_inv128_not_spd_gives_nonfinite_diagonal(rng):
    x = _spd(rng, NB).astype(np.float32)
    x[40, 40] = -1.0
    l, _ = blocked._chol_inv128(torch.from_numpy(x))
    assert int(dense._finite_info(l, diag_only=True)) == 41
    assert torch.all(torch.isfinite(torch.diagonal(l)[:40]))
    assert torch.all(torch.triu(l, 1) == 0)


def test_potrf_onelaunch_n512(rng):
    n = 512
    a = _spd(rng, n)
    l = onelaunch.potrf_onelaunch(torch.from_numpy(a.astype(np.float32)))
    assert l.dtype == torch.float32 and l.shape == (n, n)
    assert torch.all(torch.triu(l, 1) == 0)
    ln = l.double().numpy()
    lr = np.linalg.cholesky(a)
    assert np.abs(ln - lr).max() / np.abs(lr).max() < 5e-5
    ref, info = ref_dense.xpotrf(jnp.asarray(a, jnp.float32))
    assert int(info) == 0
    ref = np.asarray(ref, np.float64)
    assert np.abs(ln - ref).max() / np.abs(ref).max() < 5e-5


def test_getrf_onelaunch_n512(rng):
    n = 512
    a = _barely_dominant(rng, n)
    lu = onelaunch.getrf_onelaunch(torch.from_numpy(a.astype(np.float32)))
    assert lu.dtype == torch.float32 and lu.shape == (n, n)
    lun = lu.double().numpy()
    lt, ut = np.tril(lun, -1) + np.eye(n), np.triu(lun)
    assert np.abs(lt @ ut - a).max() / np.abs(a).max() < 5e-5
    ref, _, info = ref_dense.xgetrf(jnp.asarray(a, jnp.float32), pivot=False)
    assert int(info) == 0
    ref = np.asarray(ref, np.float64)
    assert np.abs(lun - ref).max() / np.abs(ref).max() < 5e-5


@pytest.mark.parametrize("kind", ["potrf", "getrf"])
def test_drivers_n1024_against_reference_and_lapack(kind, rng):
    """Eight right-looking steps, against the reference's CPU path and
    float64 LAPACK at 5e-5."""
    n = 1024
    if kind == "potrf":
        a = _spd(rng, n)
        f = onelaunch.potrf_onelaunch(torch.from_numpy(a.astype(np.float32))).double().numpy()
        assert np.all(np.triu(f, 1) == 0)
        want = np.linalg.cholesky(a)
        ref, info = ref_dense.xpotrf(jnp.asarray(a, jnp.float32))
        assert np.abs(f - want).max() / np.abs(want).max() < 5e-5
    else:
        a = _barely_dominant(rng, n)
        f = onelaunch.getrf_onelaunch(torch.from_numpy(a.astype(np.float32))).double().numpy()
        lt, ut = np.tril(f, -1) + np.eye(n), np.triu(f)
        assert np.abs(lt @ ut - a).max() / np.abs(a).max() < 5e-5
        ref, _, info = ref_dense.xgetrf(jnp.asarray(a, jnp.float32), pivot=False)
    assert int(info) == 0
    ref = np.asarray(ref, np.float64)
    assert np.abs(f - ref).max() / np.abs(ref).max() < 5e-5


def test_argument_checks():
    with pytest.raises(InvalidValueError):
        onelaunch.potrf_onelaunch(torch.eye(384))
    with pytest.raises(InvalidValueError):
        onelaunch.getrf_onelaunch(torch.eye(256)[:, :128])
    with pytest.raises(InvalidValueError):
        blocked._chol_inv128(torch.eye(64))
    with pytest.raises(InvalidValueError):
        onelaunch._lu_inv128(torch.eye(NB, dtype=torch.float64))


def test_cpu_takes_plain_versions_without_launch(rng):
    counts = (gemm.pallas_matmul, blocked._chol_inv128, onelaunch._lu_inv128,
              onelaunch.potrf_onelaunch, onelaunch.getrf_onelaunch)
    before = [f.launches for f in counts]
    a = torch.from_numpy(_spd(rng, 256).astype(np.float32))
    onelaunch.potrf_onelaunch(a)
    onelaunch.getrf_onelaunch(a)
    assert [f.launches for f in counts] == before


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

def _block(ptr, ld):
    return _view(ptr, torch.float32, (NB, NB), (ld, 1))


class _EmulatedLib(_EmulatedGemmLib):
    """The C entry points' contracts, computed on the CPU from the raw
    arguments: the GEMM's (B1's routes and the TF32 split) from
    tests/test_torch_dx_gemm.py, each launch's stream logged, and the block
    sweeps' from their pointers and leading dimensions."""

    def __init__(self):
        super().__init__()
        self.block_calls = []
        self.block_streams = []
        self.gemm_streams = []
        self.split_streams = []

    def tml_gemm_epilogue(self, *args):
        self.gemm_streams.append(args[-1])
        return super().tml_gemm_epilogue(*args)

    def tml_gemm_tf32x3_epilogue(self, *args):
        self.gemm_streams.append(args[-1])
        return super().tml_gemm_tf32x3_epilogue(*args)

    def tml_split_tf32(self, *args):
        self.split_streams.append(args[-1])
        return super().tml_split_tf32(*args)

    def tml_chol_inv_block(self, a, lda, l, ldl, w, ldw, stream):
        self.block_calls.append(("chol", lda))
        self.block_streams.append(stream)
        gl, gw = blocked._chol_inv128_plain(_block(a, lda).clone())
        _block(l, ldl).copy_(gl)
        _block(w, ldw).copy_(gw)
        return 0

    def tml_lu_inv_block(self, a, lda, lu, ldlu, wl, ldwl, wu, ldwu, stream):
        self.block_calls.append(("lu", lda))
        self.block_streams.append(stream)
        outs = onelaunch._lu_inv128_plain(_block(a, lda).clone())
        for ptr, ld, t in zip((lu, wl, wu), (ldlu, ldwl, ldwu), outs):
            _block(ptr, ld).copy_(t)
        return 0


class _Stream:
    """A stand-in for torch.cuda.Stream: the first is the caller's (handle
    0), each later one gets the next handle; waits are logged, as the
    handle of the stream waited for."""

    made = 0

    def __init__(self, device=None, priority=0):
        self.cuda_stream = _Stream.made
        _Stream.made += 1
        self.priority = priority
        self.waits = []

    def wait_event(self, event):
        self.waits.append(event.stream)

    def wait_stream(self, stream):
        self.waits.append(stream.cuda_stream)


class _Event:
    def __init__(self, **kw):
        self.stream = None

    def record(self, stream=None):
        self.stream = stream.cuda_stream


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    for mod in (gemm, blocked, onelaunch):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(_Stream, "made", 0)
    main = _Stream()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: main)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    return lib


@pytest.mark.parametrize("kind", ["chol", "lu"])
def test_block_kernel_marshalling(emulated, kind, rng):
    """A block that is a view into a wider matrix reaches the entry point
    with its own leading dimension; the launch is counted once."""
    big = torch.from_numpy(_symmetric_dominant(rng, 300).astype(np.float32))
    view = big[7:7 + NB, 7:7 + NB]   # a principal block: SPD
    wrapper, plain = ((blocked._chol_inv128, blocked._chol_inv128_plain) if kind == "chol"
                      else (onelaunch._lu_inv128, onelaunch._lu_inv128_plain))
    before = wrapper.launches
    got = wrapper(view)
    assert wrapper.launches == before + 1
    assert emulated.block_calls == [(kind, 300)]
    for g, w in zip(got, plain(view)):
        assert g.shape == (NB, NB) and torch.equal(g, w)


@pytest.fixture
def all_3xtf32(monkeypatch):
    """Every f32 ``_Into`` product on the 3xTF32 route: at these sizes the
    size rule (``gemm._into_route``) sends them all to SIMT."""
    monkeypatch.setattr(gemm, "_into_route", lambda m, n, k: "tf32x3")


@pytest.mark.parametrize("rule", ["size rule", "all 3xTF32"])
@pytest.mark.parametrize("kind", ["potrf", "getrf"])
def test_driver_cuda_route_marshalling(emulated, monkeypatch, kind, rule, rng):
    """The drivers' CUDA route, with every product and sweep going through
    the emulated entry points, gives the plain route's factor; the counts
    are those of the right-looking schedule at n=512 (four steps: per step
    L21, getrf's U12, block column j + 1 and the rest of the trailing
    matrix, potrf's in two products while two block rows remain). By the
    size rule every product here (K = 128, at most 16 tiles) is SIMT's;
    with all on B1's 3xTF32 route, the TF32 splits are one a step of the
    block the updates read (potrf's L21, getrf's U12) and one of each
    other B when its product is launched (the inverses, getrf's A12)."""
    if rule == "all 3xTF32":
        monkeypatch.setattr(gemm, "_into_route", lambda m, n, k: "tf32x3")
    n = 512
    x = _spd(rng, n) if kind == "potrf" else _barely_dominant(rng, n)
    a = torch.from_numpy(x.astype(np.float32))
    driver, block, plain, gemms, splits = (
        (onelaunch.potrf_onelaunch, blocked._chol_inv128, onelaunch._potrf_onelaunch_plain, 9,
         6) if kind == "potrf" else
        (onelaunch.getrf_onelaunch, onelaunch._lu_inv128, onelaunch._getrf_onelaunch_plain, 11,
         9))
    counts = (driver, block, gemm.pallas_matmul, gemm._gemm_tf32x3, tf32x3.split_tf32,
              gemm._gemm_simt)
    before = [f.launches for f in counts]
    got = driver(a)
    tc = rule == "all 3xTF32"
    assert [f.launches - x for f, x in zip(counts, before)] == [
        1, n // NB, gemms, gemms * tc, splits * tc, gemms * (not tc)]
    assert len(emulated.calls) == gemms and len(emulated.block_calls) == n // NB
    assert {call["kernel"] for call in emulated.calls} == {"tf32x3" if tc else "simt"}
    # every A is read in place; every B from planes split before its product
    assert all(call.get("split_a", True) for call in emulated.calls)
    _close(got, plain(a), 1e-6)
    if kind == "potrf":
        assert torch.all(torch.triu(got, 1) == 0)


@pytest.mark.parametrize("ahead", [True, False])
def test_driver_streams(emulated, all_3xtf32, ahead, rng):
    """With look-ahead every sweep goes to the second stream after waiting
    for the caller's, and the caller's waits for each sweep before it uses
    it; every product and TF32 split stays on the caller's stream. Without,
    all is on the caller's."""
    a = torch.from_numpy(_barely_dominant(rng, 512).astype(np.float32))
    ops = onelaunch._KernelOps(a.device, "tml_lu_inv_block", onelaunch._lu_inv128, ahead=ahead)
    got = onelaunch._getrf(a, ops)
    side = 1 if ahead else 0
    assert emulated.block_streams == [side] * 4
    assert set(emulated.gemm_streams) == set(emulated.split_streams) == {0}
    if ahead:
        assert ops.side.waits == [0] * 4 and ops.main.waits == [1] * 4
    else:
        assert ops.side is ops.main
    _close(got, onelaunch._getrf_onelaunch_plain(a), 1e-6)


def test_kernel_ops_split_a_declared_block_once(emulated, all_3xtf32, rng):
    """A declared block is split when the first 3xTF32 product reads it,
    once, and its planes serve a later product that reads part of it; a B
    in that matrix outside the declared blocks raises instead of reading
    planes never written."""
    x = torch.from_numpy(rng.normal(size=(384, 384)).astype(np.float32))
    d = torch.zeros((384, 384))
    ops = blocked._KernelOps(x.device, "tml_chol_inv_block", blocked._chol_inv128)
    ops.split((x, 128, 0, 128, 256, True))      # x[128:384, 0:128]ᵀ, as the updates read it
    before = tf32x3.split_tf32.launches
    for rows in (256, 128):                     # B = x[128:128 + rows, 0:128]ᵀ
        ops.mm((d, 0, 0, 384, rows, False), (x, 0, 0, 384, 128, False),
               (x, 128, 0, 128, rows, True))
        want = x[:, :128] @ x[128:128 + rows, :128].mT
        assert max_scaled_err(d[:, :rows], want) <= 1e-6
    assert tf32x3.split_tf32.launches == before + 1
    with pytest.raises(InvalidValueError, match="declared"):
        ops.mm((d, 0, 0, 384, 128, False), (x, 0, 0, 384, 128, False),
               (x, 0, 0, 128, 128, True))


@pytest.mark.parametrize("route", ["simt", "tf32x3"])
@pytest.mark.parametrize("transposed_b", [False, True])
def test_matmul_into_aliases_c(emulated, monkeypatch, transposed_b, route, rng):
    """The in-place helper writes D = alpha·A@B + beta·C into a strided view
    of a wider matrix that is C itself, from views of another: on the SIMT
    route, which the size rule gives this small product, and on the 3xTF32
    route (A's planes: its base is not 16-byte aligned)."""
    monkeypatch.setattr(gemm, "_into_route", lambda m, n, k: route)
    big = torch.from_numpy(rng.normal(size=(300, 260)).astype(np.float32))
    src = torch.from_numpy(rng.normal(size=(200, 200)).astype(np.float32))
    d = big[10:110, 30:94]                      # row stride 260
    a = src[5:105, 7:39]                        # (100, 32)
    b = src[40:104, 50:82].mT if transposed_b else src[40:72, 50:114]   # (32, 64)
    c = d.clone()
    want = gemm._pallas_matmul_plain(a, b, c, out_dtype=torch.float32, alpha=-1.0, beta=0.5)
    before = gemm.pallas_matmul.launches
    out = gemm._matmul_into(d, a, b, d, alpha=-1.0, beta=0.5)
    assert out is d and gemm.pallas_matmul.launches == before + 1
    call = emulated.calls[-1]   # D and C are the one view
    assert call["kernel"] == route and call["ptrs"]["c"] == call["ptrs"]["d"] == d.data_ptr()
    if route == "simt":
        assert call["strides"][6:] == [0, 260, 1, 0, 260]
    else:
        assert call["strides"][4:] == [0, 260, 1, 0, 260] and not call["split_a"]
    _close(big[10:110, 30:94], want.numpy(), 1e-6)
    rest = big.clone()
    rest[10:110, 30:94] = 0
    assert torch.count_nonzero(rest) == torch.count_nonzero(big) - torch.count_nonzero(d)


def test_xpotrf_not_spd_info_emulated_and_plain(emulated, monkeypatch, rng):
    """A matrix that stops being SPD at row r gives the same info through
    the kernel route (emulated) and the plain route."""
    n, r = 512, 300
    x = _spd(rng, n).astype(np.float32)
    x[r, r] = -1.0
    a = torch.from_numpy(x)
    monkeypatch.setattr(dense, "_use_onelaunch", lambda t: t.ndim == 2)
    _, info = dense.xpotrf(a)
    got = onelaunch.potrf_onelaunch(a)
    want = onelaunch._potrf_onelaunch_plain(a)
    assert int(info) == int(dense._finite_info(want, diag_only=True)) == r + 1
    assert int(dense._finite_info(got, diag_only=True)) == r + 1
    assert torch.all(torch.isfinite(torch.diagonal(got)[:r]))


def test_cuda_branch_propagates_loader_failure(monkeypatch):
    """For CUDA tensors the wrappers launch or raise, never fall back."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    for mod in (gemm, blocked, onelaunch):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    for fn in (blocked._chol_inv128, onelaunch._lu_inv128):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            fn(torch.eye(NB))
    for fn in (onelaunch.potrf_onelaunch, onelaunch.getrf_onelaunch):
        with pytest.raises(ExecutionError, match="nvcc exited 1"):
            fn(torch.eye(256))
