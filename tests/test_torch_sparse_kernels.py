"""Parity of tpumathlib_torch.sparse.pallas_kernels (kernels B6a and
B6b/B6c) with the reference's Pallas kernels, run in interpret mode.

- ``bell_spmm_pallas`` (its plain route on CPU tensors) against the
  reference's at bs = 128, mb = 3, nb = 5, k in {1, 200, 300}, alpha = 0.5,
  f32 and bf16 operands: within 1e-5 max-scaled for f32 output and 1e-2 for
  bf16 output (one output ulp where the two f32 sums round differently).
  Against the float64 product of the same (rounded) operands: f32 output
  within the reference test's own bound (rtol 2e-4, atol 1e-3,
  tests/test_sparse.py:135); bf16 output within 1e-2 max-scaled (bf16
  rounds to 2^-9 relative, too coarse for that elementwise rtol).
- ``bell_spmv_pallas`` at the same shapes.
- ``SpmvPlan.execute`` with ``rowform`` true (bs = 128) and false (bs = 64):
  against the reference within its test's bound (rtol 2e-4, atol 5e-4,
  tests/test_sparse.py:438), and against float64 within 1e-5 max-scaled,
  since the port is f32 throughout. ``from_parts`` with the reference's bf16
  (hi, lo) planes, for both ``rowform`` values (the planes hold transposed
  blocks where it is true), within 5e-5 max-scaled of the port's own
  analysis: hi + lo keeps 16 of f32's 24 mantissa bits.
- C8, pinned: a pad slot with non-zero data contributes nothing in the
  port; the reference adds it at bs = 128.
- The CUDA branch of each wrapper, with the kernel library replaced by a
  CPU emulation of ``tml_bell_spmm`` and ``tml_bell_spmv`` that decodes
  the dtypes, shapes, alpha and the cols pointer from the arguments.

Inputs are explicit f32 (or bf16) on both sides: the suite turns on jax x64.
"""

import contextlib
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpumathlib.sparse import containers as ref_c
from tpumathlib.sparse import convert as ref_convert
from tpumathlib.sparse import ops as ref_ops
from tpumathlib.sparse import pallas_kernels as ref_pk
from tpumathlib_torch.core import device as core_device
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.errors import ExecutionError, NotSupportedError
from tpumathlib_torch.core.interop import from_numpy, from_reference, to_numpy
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.sparse import BlockedELL, SpmvAutoPlan, dense_to_csr, spmm, spmv
from tpumathlib_torch.sparse import pallas_kernels as pk
from test_torch_dx_gemm import _view

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_arrays_on_the_cpu(monkeypatch):
    """The port's default device is the card (core.device.default_device);
    these tests turn host arrays into containers on the CPU."""
    monkeypatch.setattr(core_device, "default_device", lambda: torch.device("cpu"))


NP = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
MB, NB = 3, 5


def _bell(rng, bs, dt="f32", mb=MB, nb=NB):
    """(dense f64 of the stored values, reference BlockedELL, port BlockedELL)
    of a block-sparse (mb·bs, nb·bs) matrix with block (0, 0) stored."""
    m, n = mb * bs, nb * bs
    blocks = rng.uniform(size=(mb, nb)) < 0.5
    blocks[0, 0] = True
    a = (np.kron(blocks, np.ones((bs, bs))) * rng.normal(size=(m, n))).astype(NP[dt])
    ref = ref_convert.dense_to_blocked_ell(a, bs)
    return a.astype(np.float64), ref, from_reference(ref)


def _dense_operand(rng, shape, dt):
    v = rng.normal(size=shape).astype(NP[dt])
    return v, v.astype(np.float64), from_numpy(v)


# ---------------------------------------------------------------------------
# B6a against the reference's kernel (interpret mode)

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 200, 300])
def test_bell_spmm_matches_reference_kernel(rng, k, dt):
    a64, ref_a, port_a = _bell(rng, 128, dt)
    b, b64, bt = _dense_operand(rng, (NB * 128, k), dt)
    got = pk.bell_spmm_pallas(port_a, bt, alpha=0.5)
    want = ref_pk.bell_spmm_pallas(ref_a, jnp.asarray(b), alpha=0.5)
    assert got.dtype == TORCH[dt] and got.shape == (MB * 128, k) == want.shape
    tol = 1e-5 if dt == "f32" else 1e-2
    assert max_scaled_err(got, np.asarray(want, np.float64)) <= tol
    exact = 0.5 * a64 @ b64
    if dt == "f32":
        np.testing.assert_allclose(to_numpy(got), exact, rtol=2e-4, atol=1e-3)
    assert max_scaled_err(got, exact) <= tol


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_bell_spmv_matches_reference_kernel(rng, dt):
    a64, ref_a, port_a = _bell(rng, 128, dt)
    x, x64, xt = _dense_operand(rng, (NB * 128,), dt)
    got = pk.bell_spmv_pallas(port_a, xt, alpha=0.5)
    want = ref_pk.bell_spmv_pallas(ref_a, jnp.asarray(x), alpha=0.5)
    assert got.dtype == TORCH[dt] and got.shape == (MB * 128,) == want.shape
    tol = 1e-5 if dt == "f32" else 1e-2
    assert max_scaled_err(got, np.asarray(want, np.float64)) <= tol
    assert max_scaled_err(got, 0.5 * a64 @ x64) <= tol


# ---------------------------------------------------------------------------
# B6b/B6c: SpmvPlan against the reference's two execute kernels

@pytest.mark.parametrize("bs, rowform", [(128, True), (64, False)])
def test_spmv_plan_matches_reference(rng, bs, rowform):
    a64, ref_a, port_a = _bell(rng, bs)
    x, x64, xt = _dense_operand(rng, (NB * bs,), "f32")
    ref_plan, plan = ref_pk.SpmvPlan(ref_a), pk.SpmvPlan(port_a)
    assert plan.rowform == ref_plan.rowform == rowform
    assert (plan.shape, plan.bs, plan.mb, plan.ellw) == (ref_plan.shape, ref_plan.bs,
                                                         ref_plan.mb, ref_plan.ellw)
    assert plan.data.dtype == torch.float32 and plan.data.shape == port_a.data.shape
    got = plan.execute(xt, alpha=0.5)
    want = np.asarray(ref_plan.execute(jnp.asarray(x), alpha=0.5))
    assert got.dtype == torch.float32 and got.shape == want.shape == (MB * bs,)
    np.testing.assert_allclose(to_numpy(got), want, rtol=2e-4, atol=5e-4)
    assert max_scaled_err(got, 0.5 * a64 @ x64) <= 1e-5


@pytest.mark.parametrize("bs, rowform", [(128, True), (64, False)])
def test_from_parts_takes_reference_planes(rng, bs, rowform):
    a64, ref_a, port_a = _bell(rng, bs)
    _, x64, xt = _dense_operand(rng, (NB * bs,), "f32")
    ref_plan, plan = ref_pk.SpmvPlan(ref_a), pk.SpmvPlan(port_a)
    parts = pk.SpmvPlan.from_parts(*(from_numpy(np.array(v)) for v in (ref_plan.cols, ref_plan.ah,
                                                                       ref_plan.al)),
                                   ref_plan.shape, ref_plan.bs)
    assert parts.rowform == rowform
    # the planes of a rowform plan hold transposed blocks: back in place
    assert max_scaled_err(parts.data, plan.data) <= 2 ** -16
    assert max_scaled_err(parts.execute(xt), plan.execute(xt)) <= 5e-5
    assert max_scaled_err(parts.execute(xt), a64 @ x64) <= 5e-5
    # the port's own f32 blocks, al=None: the same execute
    own = pk.SpmvPlan.from_parts(plan.cols, plan.data, None, plan.shape, plan.bs)
    assert torch.equal(own.execute(xt, 0.5), plan.execute(xt, 0.5))


@pytest.mark.parametrize("bs", [128, 64])
def test_carried_reference_plan_executes_like_fresh_analysis(rng, bs):
    _, ref_a, port_a = _bell(rng, bs)
    _, _, xt = _dense_operand(rng, (NB * bs,), "f32")
    carried = from_reference(ref_pk.SpmvPlan(ref_a))
    fresh = pk.SpmvPlan(port_a)
    assert isinstance(carried, pk.SpmvPlan) and carried.rowform == fresh.rowform
    assert max_scaled_err(carried.execute(xt, 2.0), fresh.execute(xt, 2.0)) <= 5e-5


def test_from_parts_with_reference_clamped_cols(rng):
    """The reference's plan clamps pad ids to 0 (its pad data is zero): a
    plan rebuilt from it gives the masked product all the same."""
    a = np.zeros((256, 384), np.float32)
    a[:128, 128:256] = rng.normal(size=(128, 128))                # block row 1 is empty
    ref_plan = ref_pk.SpmvPlan(ref_convert.dense_to_blocked_ell(a, 128, ellwidth=2))
    assert int(np.asarray(ref_plan.cols).min()) == 0
    parts = from_reference(ref_plan)
    x = rng.normal(size=384).astype(np.float32)
    assert max_scaled_err(parts.execute(torch.from_numpy(x)), a.astype(np.float64) @ x) <= 5e-5


# ---------------------------------------------------------------------------
# C8: pad slots with non-zero data

def test_pad_slot_data_is_masked_c8(rng):
    bs, n = 128, 256
    cols = np.array([[0, -1]], np.int32)
    data = rng.normal(size=(1, 2, bs, bs)).astype(np.float32)   # the pad slot holds data
    x = rng.normal(size=n).astype(np.float32)
    stored = data[0, 0].astype(np.float64) @ x[:bs]
    a = BlockedELL(torch.from_numpy(cols), torch.from_numpy(data), (bs, n), bs)
    xt = torch.from_numpy(x)
    for got in (spmv(a, xt), pk.SpmvPlan(a).execute(xt), spmm(a, xt[:, None])[:, 0],
                pk.bell_spmv_pallas(a, xt)):
        assert max_scaled_err(got, stored) <= 1e-5
    # the reference clamps the pad id to block 0 and adds the pad data
    ref_a = ref_c.BlockedELL(jnp.asarray(cols), jnp.asarray(data), (bs, n), bs)
    ref = np.asarray(ref_ops.spmv(ref_a, jnp.asarray(x)), np.float64)
    assert np.abs(ref - stored).max() > 1.0


def test_plain_versions_mask_non_finite_pad_data(rng):
    bs, n = 64, 128
    cols = torch.tensor([[1, -1]], dtype=torch.int32)
    data = torch.from_numpy(rng.normal(size=(1, 2, bs, bs)).astype(np.float32))
    data[0, 1] = float("nan")
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    want = data[0, 0].double() @ x[bs:].double()
    y = pk._bell_spmv_plain(cols, data, x, (bs, n))
    assert bool(torch.isfinite(y).all()) and max_scaled_err(y, want) <= 1e-5


def test_ragged_n_reads_zero_past_the_end(rng):
    """n not a multiple of bs: rows of x (or B) past n read as zero."""
    bs, n = 128, 200
    cols = torch.tensor([[1, 0]], dtype=torch.int32)
    data = torch.from_numpy(rng.normal(size=(1, 2, bs, bs)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    want = data[0, 0].double() @ torch.cat([x[bs:], torch.zeros(2 * bs - n)]).double() \
        + data[0, 1].double() @ x[:bs].double()
    a = BlockedELL(cols, data, (bs - 5, n), bs)
    assert max_scaled_err(pk.SpmvPlan(a).execute(x), want[:bs - 5]) <= 1e-5
    assert max_scaled_err(pk.bell_spmv_pallas(a, x), want[:bs - 5]) <= 1e-5


# ---------------------------------------------------------------------------
# The CUDA branch against an emulation of the C entry points

_CODE_DTYPE = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}


class _EmulatedLib:
    """tml_bell_spmm's and tml_bell_spmv's contracts, computed on the CPU
    from the raw arguments: the tensors through their pointers, shapes and
    dtype codes, and the plain versions for the arithmetic."""

    def __init__(self, rc=0):
        self.calls = []
        self.rc = rc

    def tml_bell_spmm(self, cols, a, b, y, mb, ellw, bs, m, n, k, alpha, a_dt, b_dt, stream):
        c = _view(cols, torch.int32, (mb, ellw), (ellw, 1)).clone()
        self.calls.append(dict(kernel="spmm", mb=mb, ellw=ellw, bs=bs, m=m, n=n, k=k, alpha=alpha,
                               a=_CODE_DTYPE[a_dt], b=_CODE_DTYPE[b_dt], pads=int((c < 0).sum())))
        if self.rc:
            return self.rc
        for ptr in (a, b, y):
            assert ptr % 16 == 0
        at = _view(a, _CODE_DTYPE[a_dt], (mb, ellw, bs, bs), (ellw * bs * bs, bs * bs, bs, 1))
        bt = _view(b, _CODE_DTYPE[b_dt], (n, k), (k, 1))
        yt = _view(y, _CODE_DTYPE[b_dt], (m, k), (k, 1))
        yt.copy_(pk._bell_spmm_plain(BlockedELL(c, at.clone(), (m, n), bs), bt.clone(), alpha))
        return 0

    def tml_bell_spmv(self, cols, a, x, y, mb, ellw, bs, m, n, alpha, stream):
        c = _view(cols, torch.int32, (mb, ellw), (ellw, 1)).clone()
        self.calls.append(dict(kernel="spmv", mb=mb, ellw=ellw, bs=bs, m=m, n=n, alpha=alpha,
                               pads=int((c < 0).sum())))
        if self.rc:
            return self.rc
        at = _view(a, torch.float32, (mb, ellw, bs, bs), (ellw * bs * bs, bs * bs, bs, 1))
        xt = _view(x, torch.float32, (n,), (1,))
        _view(y, torch.float32, (m,), (1,)).copy_(
            pk._bell_spmv_plain(c, at.clone(), xt.clone(), (m, n), alpha))
        return 0

    def tml_error_string(self, rc):
        return b"emulated failure"


@pytest.fixture
def emulated(monkeypatch):
    lib = _EmulatedLib()
    monkeypatch.setattr(pk, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("pair", [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32")])
@pytest.mark.parametrize("bs, k", [(128, 1), (128, 200), (256, 70)])
def test_cuda_branch_spmm_marshalling(emulated, rng, pair, bs, k):
    _, _, port_a = _bell(rng, bs, pair[0], mb=2, nb=3)
    _, _, bt = _dense_operand(rng, (3 * bs, k), pair[1])
    before = pk.bell_spmm_pallas.launches
    got = pk.bell_spmm_pallas(port_a, bt, alpha=0.5)
    assert pk.bell_spmm_pallas.launches == before + 1
    (call,) = emulated.calls
    assert call == dict(kernel="spmm", mb=2, ellw=port_a.cols.shape[1], bs=bs, m=2 * bs, n=3 * bs,
                        k=k, alpha=0.5, a=TORCH[pair[0]], b=TORCH[pair[1]],
                        pads=int((port_a.cols < 0).sum()))
    want = pk._bell_spmm_plain(port_a, bt, 0.5)
    assert got.dtype == TORCH[pair[1]] and torch.equal(got, want)


def test_cuda_branch_passes_pad_slots_through(emulated, rng):
    cols = torch.tensor([[2, -1, 0], [-1, -1, 1]], dtype=torch.int32)
    data = torch.from_numpy(rng.normal(size=(2, 3, 128, 128)).astype(np.float32))
    a = BlockedELL(cols, data, (256, 384), 128)
    b = torch.from_numpy(rng.normal(size=(384, 5)).astype(np.float32))
    got = spmm(a, b)
    x = b[:, 0].contiguous()
    got_v = pk.SpmvPlan(a).execute(x)
    assert [c["pads"] for c in emulated.calls] == [3, 3]
    assert torch.equal(got, pk._bell_spmm_plain(a, b))
    assert max_scaled_err(got_v, got[:, 0]) <= 1e-6


def test_cuda_branch_batched_b_is_one_launch(emulated, rng):
    _, _, port_a = _bell(rng, 128, mb=2, nb=3)
    bb = torch.from_numpy(rng.normal(size=(4, 384, 6)).astype(np.float32))
    before = pk.bell_spmm_pallas.launches
    got = spmm(port_a, bb, alpha=2.0)
    assert pk.bell_spmm_pallas.launches == before + 1
    (call,) = emulated.calls
    assert call["k"] == 4 * 6 and call["n"] == 384
    assert got.shape == (4, 256, 6)
    for i in range(4):
        assert max_scaled_err(got[i], pk._bell_spmm_plain(port_a, bb[i], 2.0)) <= 1e-6


@pytest.mark.parametrize("what", ["A f64", "B f64", "bs 64"])
def test_cuda_branch_refuses_instead_of_falling_back(emulated, rng, what):
    bs = 64 if what == "bs 64" else 128
    _, _, port_a = _bell(rng, bs, mb=2, nb=2)
    b = torch.from_numpy(rng.normal(size=(2 * bs, 3)).astype(np.float32))
    if what == "A f64":
        port_a = BlockedELL(port_a.cols, port_a.data.double(), port_a.shape, bs)
    if what == "B f64":
        b = b.double()
    before = pk.bell_spmm_pallas.launches
    with pytest.raises(NotSupportedError):
        pk.bell_spmm_pallas(port_a, b)
    assert pk.bell_spmm_pallas.launches == before and not emulated.calls


@pytest.mark.parametrize("bs", [128, 64])
def test_cuda_branch_spmv_marshalling(emulated, rng, bs):
    _, _, port_a = _bell(rng, bs)
    _, _, xt = _dense_operand(rng, (NB * bs,), "f32")
    plan = pk.SpmvPlan(port_a)
    before = pk._bell_spmv.launches
    got = plan.execute(xt, alpha=0.25)
    assert pk._bell_spmv.launches == before + 1
    (call,) = emulated.calls
    assert call == dict(kernel="spmv", mb=MB, ellw=port_a.cols.shape[1], bs=bs, m=MB * bs,
                        n=NB * bs, alpha=0.25, pads=int((port_a.cols < 0).sum()))
    assert torch.equal(got, pk._bell_spmv_plain(plan.cols, plan.data, xt, plan.shape, 0.25))


def test_cuda_branch_autoplan_blockedell_engine_launches_spmv(emulated, rng):
    d = np.zeros((256, 256), np.float32)
    d[:128, 128:] = rng.normal(size=(128, 128))
    d[128:, :128] = rng.normal(size=(128, 128))
    plan = SpmvAutoPlan(dense_to_csr(d))
    assert plan.engine == "blockedell"
    x = rng.normal(size=256).astype(np.float32)
    before = pk._bell_spmv.launches
    got = plan.execute(torch.from_numpy(x))
    assert pk._bell_spmv.launches == before + 1
    assert max_scaled_err(got, d.astype(np.float64) @ x) <= 1e-5


def test_cuda_branch_raises_on_launch_failure(emulated, rng):
    emulated.rc = 9   # cudaErrorInvalidConfiguration
    _, _, port_a = _bell(rng, 128, mb=2, nb=2)
    b = torch.zeros((256, 3))
    before = (pk.bell_spmm_pallas.launches, pk._bell_spmv.launches)
    with pytest.raises(ExecutionError, match="tml_bell_spmm: CUDA error 9"):
        pk.bell_spmm_pallas(port_a, b)
    with pytest.raises(ExecutionError, match="tml_bell_spmv: CUDA error 9"):
        pk.SpmvPlan(port_a).execute(b[:, 0])
    assert (pk.bell_spmm_pallas.launches, pk._bell_spmv.launches) == before


def test_cuda_branch_propagates_loader_failure(monkeypatch, rng):
    """For CUDA tensors the wrappers launch or raise, never fall back."""
    def broken_loader():
        raise ExecutionError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(pk, "on_cuda", lambda *t: True)
    monkeypatch.setattr(cuda_utils, "load_kernels", broken_loader)
    _, _, port_a = _bell(rng, 128, mb=2, nb=2)
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        spmm(port_a, torch.zeros((256, 2)))
    with pytest.raises(ExecutionError, match="nvcc exited 1"):
        pk.SpmvPlan(port_a).execute(torch.zeros(256))


def test_cuda_branch_aligns_operands(emulated, rng):
    """An operand view off a 16-byte boundary is copied before the launch
    (the kernels' vector loads)."""
    _, _, port_a = _bell(rng, 128, mb=2, nb=2)
    wide = torch.from_numpy(rng.normal(size=(256 * 3 + 1,)).astype(np.float32))
    b = wide[1:].reshape(256, 3)
    assert b.data_ptr() % 16 != 0
    got = pk.bell_spmm_pallas(port_a, b)
    assert torch.equal(got, pk._bell_spmm_plain(port_a, b))


def test_cpu_takes_plain_versions_without_launch(rng):
    _, _, port_a = _bell(rng, 128, mb=2, nb=2)
    b = torch.from_numpy(rng.normal(size=(256, 4)).astype(np.float32))
    before = (pk.bell_spmm_pallas.launches, pk._bell_spmv.launches)
    assert torch.equal(spmm(port_a, b), pk._bell_spmm_plain(port_a, b))
    pk.SpmvPlan(port_a).execute(b[:, 0])
    assert (pk.bell_spmm_pallas.launches, pk._bell_spmv.launches) == before
