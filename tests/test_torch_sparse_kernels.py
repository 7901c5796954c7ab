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
  CPU emulation of ``tml_bell_spmm_wgmma``, ``tml_bell_spmm_tf32x3``,
  ``tml_split_tf32`` and ``tml_bell_spmv`` that decodes the dtypes, shapes,
  row strides, alpha and the cols pointer from the arguments: the SpMM
  routing rule (bf16 and f16 pairs to the 16-bit entry, B's rows padded to
  16 bytes where k is ragged; f32 and mixed pairs to the 3xTF32 entry, with
  A in its own dtype and one transposed split of B a call, its lo plane
  left out where B is 16-bit), a block row of pad slots only, a refusal, and
  ``spmv`` on an f32 Blocked-ELL through the SpMV kernel. The 3xTF32
  emulation computes what the kernel does from the planes it is given
  (``_tf32x3_bell``), so a result equal to that model of the caller's
  operands shows the planes right.
- A numpy model of the 3xTF32 kernel's slot walk (each 32-deep stage of a
  valid slot into a fresh partial, its k8 steps' products added rounding
  toward zero as the tensor cores add, the partials summed in f32) within
  1e-5 of float64 and of the reference's kernel.

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
from tpumathlib_torch.dx import cuda_utils, tf32x3
from tpumathlib_torch.sparse import BlockedELL, SpmvAutoPlan, dense_to_csr, spmm, spmv
from tpumathlib_torch.sparse import pallas_kernels as pk
from test_torch_dx_gemm import Tf32x3Emulation, _tensor_core_read, _view
from test_torch_tf32x3 import _rz

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_arrays_on_the_cpu(monkeypatch):
    """The port's default device is the card (core.device.default_device);
    these tests turn host arrays into containers on the CPU."""
    monkeypatch.setattr(core_device, "default_device", lambda: torch.device("cpu"))


NP = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "f16": np.float16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
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


def _tf32x3_bell(cols, a_planes, b_planes, shape, alpha, out_dtype):
    """What ``tml_bell_spmm_tf32x3`` computes from A's TF32 planes (as its
    consumers split or widen A) and B's (n, k): alpha·(lo·hi + hi·lo +
    hi·hi), each product a masked f32 einsum over the slots, in
    ``out_dtype``. A product of a zero lo plane, which the kernel leaves
    out, adds 0."""
    (ah, al), (bh, bl) = a_planes, b_planes
    acc = sum(pk._bell_product(cols, x, y, shape, torch.float32)
              for x, y in ((al, bh), (ah, bl), (ah, bh)))
    return (alpha * acc).to(out_dtype)


def _tf32x3_expected(a: BlockedELL, b, alpha):
    """``_tf32x3_bell`` of the caller's operands: A widened to f32 and split,
    B widened and split."""
    return _tf32x3_bell(a.cols, tf32x3._split_tf32_plain(a.data.float()),
                        tf32x3._split_tf32_plain(b.float()), a.shape, alpha, b.dtype)


class _EmulatedLib(Tf32x3Emulation):
    """The SpMM and SpMV entries' contracts, computed on the CPU from the raw
    arguments: the tensors through their pointers, shapes and dtype codes,
    and the plain versions for the arithmetic; ``tml_split_tf32`` from
    ``Tf32x3Emulation``."""

    def __init__(self, rc=0):
        self.calls = []
        self.b_ptrs = []   # B's address at each tensor-core launch
        self.a_ptrs = []   # A's address at each 3xTF32 launch
        self.rc = rc

    def tml_bell_spmm_tf32x3(self, cols, a, bt_hi, bt_lo, ldb, y, mb, ellw, bs, m, n, k, alpha,
                             a_dt, y_dt, stream):
        """The 3xTF32 entry: A (mb, ellw, bs, bs) in a_dt, Bᵀ's planes (k, n)
        at row stride ldb (bt_lo null: B exact, its lo plane 0), Y in y_dt;
        refuses (cudaErrorInvalidValue, 1) what the C entry refuses. A is
        widened and split as the consumers do it, each plane read as the
        tensor cores read it."""
        if (y_dt not in (0, 1, 2) or a_dt not in (0, 1, 2) or bs % 128 or ldb < n or ldb % 4
                or any(p % 16 for p in (a, bt_hi, bt_lo or 0))):
            return 1
        c = _view(cols, torch.int32, (mb, ellw), (ellw, 1)).clone()
        self.calls.append(dict(kernel="spmm_tf32x3", mb=mb, ellw=ellw, bs=bs, m=m, n=n, k=k,
                               alpha=alpha, a=_CODE_DTYPE[a_dt], b_exact=not bt_lo,
                               y=_CODE_DTYPE[y_dt], pads=int((c < 0).sum()), ldb=ldb))
        self.a_ptrs.append(a)
        if self.rc:
            return self.rc
        at = _view(a, _CODE_DTYPE[a_dt], (mb, ellw, bs, bs),
                   (ellw * bs * bs, bs * bs, bs, 1)).float()
        bh = _tensor_core_read(_view(bt_hi, torch.float32, (k, n), (ldb, 1)).mT)
        bl = (_tensor_core_read(_view(bt_lo, torch.float32, (k, n), (ldb, 1)).mT) if bt_lo
              else torch.zeros_like(bh))
        _view(y, _CODE_DTYPE[y_dt], (m, k), (k, 1)).copy_(
            _tf32x3_bell(c, tf32x3._split_tf32_plain(at), (bh, bl), (m, n), alpha,
                         _CODE_DTYPE[y_dt]))
        return 0

    def tml_bell_spmm_wgmma(self, cols, a, b, y, mb, ellw, bs, m, n, k, ldb, alpha, dt, stream):
        """The tensor-core entry: A, B and Y in one 16-bit dtype, B's rows
        ldb elements apart (a multiple of 8 and at least k), A and B 16-byte
        aligned; refuses (cudaErrorInvalidValue, 1) anything else."""
        if dt not in (1, 2) or bs % 128 or ldb < k or ldb % 8 or a % 16 or b % 16:
            return 1
        c = _view(cols, torch.int32, (mb, ellw), (ellw, 1)).clone()
        self.calls.append(dict(kernel="spmm_wgmma", mb=mb, ellw=ellw, bs=bs, m=m, n=n, k=k,
                               alpha=alpha, a=_CODE_DTYPE[dt], b=_CODE_DTYPE[dt],
                               pads=int((c < 0).sum()), ldb=ldb))
        self.b_ptrs.append(b)
        if self.rc:
            return self.rc
        t = _CODE_DTYPE[dt]
        at = _view(a, t, (mb, ellw, bs, bs), (ellw * bs * bs, bs * bs, bs, 1))
        bt = _view(b, t, (n, k), (ldb, 1))
        yt = _view(y, t, (m, k), (k, 1))
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
    lib.tf32_calls = []
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
    common = dict(mb=2, ellw=port_a.cols.shape[1], bs=bs, m=2 * bs, n=3 * bs, k=k, alpha=0.5,
                  pads=int((port_a.cols < 0).sum()))
    plain = pk._bell_spmm_plain(port_a, bt, 0.5)
    if pair == ("bf16", "bf16"):   # 16-bit pairs: B's rows padded to 16 bytes
        assert call == dict(kernel="spmm_wgmma", a=TORCH["bf16"], b=TORCH["bf16"],
                            ldb=-(-k // 8) * 8, **common)
        assert got.dtype == TORCH["bf16"] and torch.equal(got, plain)
        return
    # the 3xTF32 entry: A in f32, Bᵀ's planes from one transposed split
    assert call == dict(kernel="spmm_tf32x3", a=TORCH[pair[0]],
                        b_exact=pair[1] != "f32", y=TORCH[pair[1]], ldb=-(-3 * bs // 4) * 4,
                        **common)
    (split,) = emulated.tf32_calls
    assert split["shape"] == (3 * bs, k) and split["flags"] == tf32x3.TRANSPOSE
    assert got.dtype == TORCH[pair[1]] and torch.equal(got, _tf32x3_expected(port_a, bt, 0.5))
    assert max_scaled_err(got, plain) <= 1e-5


def test_cuda_branch_passes_pad_slots_through(emulated, rng):
    cols = torch.tensor([[2, -1, 0], [-1, -1, 1]], dtype=torch.int32)
    data = torch.from_numpy(rng.normal(size=(2, 3, 128, 128)).astype(np.float32))
    a = BlockedELL(cols, data, (256, 384), 128)
    b = torch.from_numpy(rng.normal(size=(384, 5)).astype(np.float32))
    got = spmm(a, b)
    x = b[:, 0].contiguous()
    got_v = pk.SpmvPlan(a).execute(x)
    assert [c["pads"] for c in emulated.calls] == [3, 3]
    assert torch.equal(got, _tf32x3_expected(a, b, 1.0))
    assert max_scaled_err(got, pk._bell_spmm_plain(a, b)) <= 1e-6
    assert max_scaled_err(got_v, got[:, 0]) <= 1e-6


def test_cuda_branch_batched_b_is_one_launch(emulated, rng):
    _, _, port_a = _bell(rng, 128, mb=2, nb=3)
    bb = torch.from_numpy(rng.normal(size=(4, 384, 6)).astype(np.float32))
    before = pk.bell_spmm_pallas.launches, tf32x3.split_tf32.launches
    got = spmm(port_a, bb, alpha=2.0)
    assert (pk.bell_spmm_pallas.launches, tf32x3.split_tf32.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    (call,) = emulated.calls
    assert call["kernel"] == "spmm_tf32x3" and call["k"] == 4 * 6 and call["n"] == 384
    assert [c["shape"] for c in emulated.tf32_calls] == [(384, 24)]
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
    assert not emulated.tf32_calls


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
    with pytest.raises(ExecutionError, match="tml_bell_spmm_tf32x3: CUDA error 9"):
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
    got = pk.bell_spmm_pallas(port_a, b)   # the emulation refuses a misaligned A or plane
    assert torch.equal(got, _tf32x3_expected(port_a, b, 1.0))
    assert max_scaled_err(got, pk._bell_spmm_plain(port_a, b)) <= 1e-6


def test_cpu_takes_plain_versions_without_launch(rng):
    _, _, port_a = _bell(rng, 128, mb=2, nb=2)
    b = torch.from_numpy(rng.normal(size=(256, 4)).astype(np.float32))
    before = (pk.bell_spmm_pallas.launches, pk._bell_spmv.launches)
    assert torch.equal(spmm(port_a, b), pk._bell_spmm_plain(port_a, b))
    pk.SpmvPlan(port_a).execute(b[:, 0])
    assert (pk.bell_spmm_pallas.launches, pk._bell_spmv.launches) == before


# ---------------------------------------------------------------------------
# B6a's routing rule, B's rows for TMA, pad-only block rows, and the SpMV route

_SPMM_ROUTES = {("bf16", "bf16"): "wgmma", ("f16", "f16"): "wgmma", ("f32", "f32"): "tf32x3",
                ("bf16", "f32"): "tf32x3", ("f32", "bf16"): "tf32x3", ("f16", "bf16"): "tf32x3"}


@pytest.mark.parametrize("pair", list(_SPMM_ROUTES))
def test_cuda_branch_spmm_routing(emulated, rng, pair):
    """bf16 x bf16 and f16 x f16 go to tml_bell_spmm_wgmma, every other
    pair to tml_bell_spmm_tf32x3 after one split of Bᵀ: one launch, counted
    in the total and in its route's count (the split in split_tf32's), with
    the kernel's result in B's dtype: the plain version's on the 16-bit
    route, the 3xTF32 model's (within 1e-5 of the plain version) on the
    other."""
    route = _SPMM_ROUTES[pair]
    assert pk._spmm_route(TORCH[pair[0]], TORCH[pair[1]]) == route
    _, _, port_a = _bell(rng, 128, pair[0], mb=2, nb=3)
    _, _, bt = _dense_operand(rng, (3 * 128, 40), pair[1])
    counts = (pk.bell_spmm_pallas, pk._bell_spmm_wgmma, pk._bell_spmm_tf32x3,
              tf32x3.split_tf32)
    before = [f.launches for f in counts]
    got = pk.bell_spmm_pallas(port_a, bt, alpha=0.5)
    tc = route == "tf32x3"
    assert [f.launches - x for f, x in zip(counts, before)] == [1, not tc, tc, tc]
    assert [c["kernel"] for c in emulated.calls] == ["spmm_tf32x3" if tc else "spmm_wgmma"]
    plain = pk._bell_spmm_plain(port_a, bt, 0.5)
    assert got.dtype == TORCH[pair[1]]
    if tc:
        assert torch.equal(got, _tf32x3_expected(port_a, bt, 0.5))
        assert max_scaled_err(got, plain) <= (1e-5 if pair[1] == "f32" else 1e-2)
    else:
        assert torch.equal(got, plain)


@pytest.mark.parametrize("k, view", [(1, False), (13, False), (300, False), (304, False),
                                     (10, True)])
def test_cuda_branch_tensor_core_pads_ragged_rows(emulated, rng, k, view):
    """TMA reads B's rows at a pitch of 16 bytes: a ragged k (1, 13, 300)
    reaches the kernel as a copy with rows of the next multiple of 8, a B
    whose rows are 16-byte multiples apart (k = 304, or a column slice of a
    (n, 16) B) is read in place with its own row stride."""
    _, _, port_a = _bell(rng, 128, "bf16", mb=2, nb=3)
    if view:
        b = _dense_operand(rng, (3 * 128, 16), "bf16")[2][:, :k]
    else:
        b = _dense_operand(rng, (3 * 128, k), "bf16")[2]
    got = pk.bell_spmm_pallas(port_a, b, alpha=2.0)
    (call,) = emulated.calls
    in_place = view or k % 8 == 0
    assert call["ldb"] == (b.stride(0) if in_place else -(-k // 8) * 8)
    assert (emulated.b_ptrs[0] == b.data_ptr()) == in_place
    assert torch.equal(got, pk._bell_spmm_plain(port_a, b, 2.0))


@pytest.mark.parametrize("dt", ["bf16", "f16", "f32"])
def test_cuda_branch_pad_only_block_row_is_zero(emulated, rng, dt):
    """A block row whose slots are all pads (its data non-zero) sums
    nothing: its rows of Y are 0, on either kernel."""
    cols = torch.tensor([[1, -1], [-1, -1], [0, 2]], dtype=torch.int32)
    data = torch.from_numpy(rng.normal(size=(3, 2, 128, 128)).astype(np.float32)).to(TORCH[dt])
    a = BlockedELL(cols, data, (3 * 128, 3 * 128), 128)
    b = _dense_operand(rng, (3 * 128, 24), dt)[2]
    got = pk.bell_spmm_pallas(a, b)
    (call,) = emulated.calls
    assert call["kernel"] == ("spmm_tf32x3" if dt == "f32" else "spmm_wgmma") and call["pads"] == 3
    assert torch.equal(got[128:256], torch.zeros((128, 24), dtype=TORCH[dt]))
    if dt == "f32":
        assert torch.equal(got, _tf32x3_expected(a, b, 1.0))
        assert max_scaled_err(got, pk._bell_spmm_plain(a, b)) <= 1e-6
    else:
        assert torch.equal(got, pk._bell_spmm_plain(a, b))


@pytest.mark.parametrize("entry", ["spmv", "bell_spmv_pallas"])
def test_cuda_branch_f32_spmv_takes_the_spmv_kernel(emulated, rng, entry):
    """spmv and bell_spmv_pallas on an f32 Blocked-ELL and f32 x launch
    tml_bell_spmv once and no SpMM kernel, in f32; a bf16 A keeps the SpMM
    route with one column, in x's dtype."""
    _, _, port_a = _bell(rng, 128)
    _, _, xt = _dense_operand(rng, (NB * 128,), "f32")
    _, _, yt = _dense_operand(rng, (MB * 128,), "f32")
    counts = (pk._bell_spmv, pk.bell_spmm_pallas)
    before = [f.launches for f in counts]
    if entry == "spmv":
        got = spmv(port_a, xt, yt, alpha=0.5, beta=2.0)
        want = pk._bell_spmv_plain(port_a.cols, port_a.data, xt, port_a.shape, 0.5) + 2.0 * yt
    else:
        got = pk.bell_spmv_pallas(port_a, xt, alpha=0.5)
        want = pk._bell_spmv_plain(port_a.cols, port_a.data, xt, port_a.shape, 0.5)
    assert [f.launches - x for f, x in zip(counts, before)] == [1, 0]
    assert [c["kernel"] for c in emulated.calls] == ["spmv"]
    assert got.dtype == torch.float32 and torch.equal(got, want)

    _, _, bf_a = _bell(rng, 128, "bf16")
    xb = xt.to(torch.bfloat16)
    got = spmv(bf_a, xb) if entry == "spmv" else pk.bell_spmv_pallas(bf_a, xb)
    assert [f.launches - x for f, x in zip(counts, before)] == [1, 1]
    assert emulated.calls[-1]["kernel"] == "spmm_wgmma" and emulated.calls[-1]["k"] == 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, pk._bell_spmm_plain(bf_a, xb[:, None])[:, 0])


def test_spmv_f32_blocked_ell_on_the_cpu_is_the_spmv_plain_version(rng):
    """On CPU tensors the SpMV route takes its plain version, launching
    nothing, and agrees with float64."""
    a64, _, port_a = _bell(rng, 64)
    x, x64, xt = _dense_operand(rng, (NB * 64,), "f32")
    before = (pk._bell_spmv.launches, pk.bell_spmm_pallas.launches)
    got = spmv(port_a, xt, alpha=0.5)
    assert (pk._bell_spmv.launches, pk.bell_spmm_pallas.launches) == before
    assert torch.equal(got, pk._bell_spmv_plain(port_a.cols, port_a.data, xt, port_a.shape, 0.5))
    assert max_scaled_err(got, 0.5 * a64 @ x64) <= 1e-5


# ---------------------------------------------------------------------------
# B6a's 3xTF32 route: mixed pairs, ragged shapes, refusals, and a model of its sum

@pytest.mark.parametrize("pair", [("f32", "bf16"), ("f32", "f16"), ("bf16", "f32"),
                                  ("f16", "f32"), ("bf16", "f16"), ("f16", "bf16")])
def test_cuda_branch_mixed_pairs_take_the_3xtf32_kernel(emulated, rng, pair):
    """A mixed pair reaches tml_bell_spmm_tf32x3 with A's blocks as they
    lie, in their own dtype (no widened copy: the kernel widens a 16-bit A
    in registers), and Bᵀ's planes from one transposed split of B widened
    to f32, its lo plane left out where B is 16-bit (two products where one
    operand is 16-bit, one where both are); Y in B's dtype."""
    _, _, port_a = _bell(rng, 128, pair[0], mb=2, nb=3)
    _, _, bt = _dense_operand(rng, (3 * 128, 24), pair[1])
    got = pk.bell_spmm_pallas(port_a, bt, alpha=0.5)
    (call,) = emulated.calls
    assert (call["kernel"], call["a"], call["b_exact"], call["y"]) == (
        "spmm_tf32x3", TORCH[pair[0]], pair[1] != "f32", TORCH[pair[1]])
    assert emulated.a_ptrs == [port_a.data.data_ptr()]
    (split,) = emulated.tf32_calls
    assert split["shape"] == (3 * 128, 24) and split["flags"] == tf32x3.TRANSPOSE
    if call["b_exact"]:   # the premise of leaving B's lo plane out
        assert torch.equal(tf32x3._split_tf32_plain(bt.float())[1], torch.zeros((384, 24)))
    assert got.dtype == TORCH[pair[1]] and torch.equal(got, _tf32x3_expected(port_a, bt, 0.5))
    want = 0.5 * pk._bell_product(port_a.cols, port_a.data, bt, port_a.shape, torch.float64)
    assert max_scaled_err(got, want) <= (1e-5 if pair[1] == "f32" else 1e-2)


@pytest.mark.parametrize("n, m, k", [(3 * 128 - 50, 2 * 128 - 7, 37), (3 * 128, 2 * 128, 1),
                                     (3 * 128 - 1, 2 * 128, 130)])
def test_cuda_branch_tf32x3_ragged_n_and_k(emulated, rng, n, m, k):
    """A ragged n (a block column whose rows run past it read as zero), a
    ragged m and a ragged k: Bᵀ's planes (k, n) at a row stride of n
    rounded up to 4, Y (m, k); the result is the model's and within 1e-5
    of float64."""
    cols = torch.tensor([[2, -1, 0], [1, 2, -1]], dtype=torch.int32)
    data = torch.from_numpy(rng.normal(size=(2, 3, 128, 128)).astype(np.float32))
    a = BlockedELL(cols, data, (m, n), 128)
    b = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    got = pk.bell_spmm_pallas(a, b, alpha=0.5)
    (call,) = emulated.calls
    assert (call["m"], call["n"], call["k"], call["ldb"]) == (m, n, k, -(-n // 4) * 4)
    assert got.shape == (m, k) and torch.equal(got, _tf32x3_expected(a, b, 0.5))
    assert max_scaled_err(got, 0.5 * pk._bell_product(cols, data, b, (m, n), torch.float64)) <= 1e-5


def test_cuda_branch_tf32x3_refusal_raises_without_a_launch(emulated, rng, monkeypatch):
    """Where the 3xTF32 entry refuses its arguments (cudaErrorInvalidValue),
    the wrapper raises and counts no SpMM launch; nothing gives way to
    another kernel."""
    monkeypatch.setattr(emulated, "tml_bell_spmm_tf32x3", lambda *args: 1)
    _, _, port_a = _bell(rng, 128, mb=2, nb=2)
    b = torch.zeros((256, 3))
    before = pk.bell_spmm_pallas.launches, pk._bell_spmm_tf32x3.launches
    with pytest.raises(ExecutionError, match="tml_bell_spmm_tf32x3: CUDA error 1"):
        pk.bell_spmm_pallas(port_a, b)
    assert (pk.bell_spmm_pallas.launches, pk._bell_spmm_tf32x3.launches) == before
    assert not emulated.calls


def _slot_walk_model(cols, data, b, shape, alpha):
    """tml_bell_spmm_tf32x3's sum in numpy: for each block row, the valid
    slots in order and the 32-deep stages of each, a stage's k8 steps'
    products (lo·hi, hi·lo, hi·hi: exact in float64) added into a fresh
    partial rounding toward zero, as the tensor cores add, the partials
    summed into the accumulator in f32 to nearest; then alpha."""
    m, n = shape
    mb, ellw = cols.shape
    bs, k = data.shape[-1], b.shape[1]
    bpad = np.zeros((-(-n // bs) * bs + bs, k), np.float32)
    bpad[:n] = b
    ah, al = (t.numpy().astype(np.float64) for t in tf32x3._split_tf32_plain(torch.from_numpy(data)))
    bh, bl = (t.numpy().astype(np.float64) for t in tf32x3._split_tf32_plain(torch.from_numpy(bpad)))
    y = np.zeros((mb * bs, k), np.float32)
    for i in range(mb):
        acc = np.zeros((bs, k), np.float32)
        for j in range(ellw):
            c = int(cols[i, j])
            if c < 0:
                continue
            rows = slice(c * bs, (c + 1) * bs) if c * bs < n else slice(len(bpad) - bs, len(bpad))
            for t0 in range(0, bs, 32):
                part = np.zeros((bs, k), np.float32)
                for s in range(t0, t0 + 32, 8):
                    for x, w in ((al, bh), (ah, bl), (ah, bh)):
                        part = _rz(part + x[i, j][:, s:s + 8] @ w[rows][s:s + 8])
                acc = acc + part
        y[i * bs:(i + 1) * bs] = acc
    return np.float32(alpha) * y[:m]


def test_slot_walk_3xtf32_model_against_float64_and_the_reference(rng):
    """The model of the 3xTF32 kernel's slot walk (``_slot_walk_model``) on
    a Blocked-ELL with pad slots (one with non-zero data: skipped) and a
    block column past a ragged n: within 1e-5 of float64, max-scaled, and
    of the reference's bell_spmm_pallas in interpret mode (its f32 dot at
    HIGHEST)."""
    a64, ref_a, port_a = _bell(rng, 128, "f32", mb=2, nb=3)
    b, b64, _ = _dense_operand(rng, (3 * 128, 40), "f32")
    got = _slot_walk_model(port_a.cols.numpy(), port_a.data.numpy(), b, port_a.shape, 0.5)
    assert max_scaled_err(got, 0.5 * a64 @ b64) <= 1e-5
    want = ref_pk.bell_spmm_pallas(ref_a, jnp.asarray(b), alpha=0.5)
    assert max_scaled_err(got, np.asarray(want, np.float64)) <= 1e-5
    cols = np.array([[2, -1, 0], [1, -1, -1]], np.int32)
    data = rng.normal(size=(2, 3, 128, 128)).astype(np.float32)
    bb = rng.normal(size=(3 * 128 - 50, 40)).astype(np.float32)
    got = _slot_walk_model(cols, data, bb, (256, 3 * 128 - 50), 0.5)
    want = 0.5 * pk._bell_product(torch.from_numpy(cols), torch.from_numpy(data),
                                  torch.from_numpy(bb), (256, 3 * 128 - 50), torch.float64)
    assert max_scaled_err(got, want) <= 1e-5
