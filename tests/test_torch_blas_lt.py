"""Parity of tpumathlib_torch.blas.lt with tpumathlib.blas.lt: descriptor
flow, both backends, all epilogues, narrow-precision scale modes, NVFP4
packing, int8→int32, planar complex, autotune.

Descriptors are built in the reference and carried over with
``from_reference``; inputs are the same seeded numpy arrays. Tolerances:
f32 output 1e-5 max-scaled; narrow formats at the reference tests' own
bounds against a@b (fp8 per-tensor and 128×128 blocks 0.15, MXFP8 0.1,
int8 0.1, NVFP4 rel-L2 0.15); the quantized codes themselves bit-exact
against the reference's; int8→int32 exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumathlib.blas import lt as ref
from tpumathlib_torch.core import device as core_device
from tpumathlib_torch.blas import lt
from tpumathlib_torch.core.check import max_scaled_err, rel_l2
from tpumathlib_torch.core.errors import NotSupportedError
from tpumathlib_torch.core.interop import from_numpy, from_reference, to_numpy
from tpumathlib_torch.dx import gemm

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_arrays_on_the_cpu(monkeypatch):
    """The port's default device is the card (core.device.default_device);
    these tests turn host arrays into containers on the CPU."""
    monkeypatch.setattr(core_device, "default_device", lambda: torch.device("cpu"))


M, N, K = 64, 96, 128


@pytest.fixture
def ab(rng):
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    return a, b


def _t(x):
    return from_numpy(np.asarray(x))


def _close(got, want, tol):
    err = max_scaled_err(got, np.asarray(want).astype(np.float64))
    assert err <= tol, f"max-scaled err {err:.3e} > {tol:g}"


def test_enums_and_descriptors_match_reference():
    assert [e.value for e in lt.Epilogue] == [e.value for e in ref.Epilogue]
    assert [s.value for s in lt.ScaleMode] == [s.value for s in ref.ScaleMode]
    assert [s.block for s in lt.ScaleMode] == [s.block for s in ref.ScaleMode]
    rd = ref.MatmulDesc(transa="T", epilogue=ref.Epilogue.GELU_AUX_BIAS,
                        a_scale_mode=ref.ScaleMode.VEC32_UE8M0, amax_d=True)
    assert from_reference(rd) == lt.MatmulDesc(
        transa="T", epilogue=lt.Epilogue.GELU_AUX_BIAS,
        a_scale_mode=lt.ScaleMode.VEC32_UE8M0, amax_d=True)
    assert from_reference(ref.MatrixLayout(jnp.bfloat16, 4, 8, 2)) == \
        lt.MatrixLayout(torch.bfloat16, 4, 8, 2)
    assert from_reference(ref.MatrixLayout(jnp.bfloat16, 4, 8, 2)).shape() == (2, 4, 8)
    assert from_reference(ref.Algo("pallas")) == lt.Algo("pallas")
    assert lt.MatmulPreference().max_workspace_bytes == ref.MatmulPreference().max_workspace_bytes
    for mode in lt.ScaleMode:
        for operand in "abd":
            assert lt.scale_tensor_shape(mode, 100, 70, operand) == \
                ref.scale_tensor_shape(ref.ScaleMode(mode.value), 100, 70, operand)


def test_heuristic_routing_matches_reference():
    """The default route is the vendor path in both packages."""
    desc, rdesc = lt.MatmulDesc(), ref.MatmulDesc()
    got = lt.matmul_algo_get_heuristic(desc, lt.MatrixLayout(torch.float32, M, K),
                                       lt.MatrixLayout(torch.float32, K, N), n=2)
    want = ref.matmul_algo_get_heuristic(rdesc, ref.MatrixLayout(jnp.float32, M, K),
                                         ref.MatrixLayout(jnp.float32, K, N), n=2)
    assert [a.backend for a in got] == [a.backend for a in want] == ["xla", "pallas"]
    cands = lt.matmul_algo_candidates(desc, lt.MatrixLayout(torch.float32, M, K),
                                      lt.MatrixLayout(torch.float32, K, N))
    assert [a.backend for a in cands[:2]] == ["xla", "pallas"]
    assert [a.config for a in cands[2:]] == list(gemm.default_configs())


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas"])
def test_lt_sgemm_flow(ab, backend):
    a, b = ab
    algo = ref.Algo(backend)
    want = ref.matmul(ref.MatmulDesc(), jnp.asarray(a), jnp.asarray(b), algo=algo)
    got = lt.matmul(lt.MatmulDesc(), _t(a), _t(b), algo=from_reference(algo))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_lt_trans_alpha_beta(ab, rng, backend):
    a, b = ab  # op(A) = aᵀ (K, M); op(B) = btᵀ (M, N)
    bt = rng.normal(size=(N, M)).astype(np.float32)
    c = rng.normal(size=(K, N)).astype(np.float32)
    rdesc = ref.MatmulDesc(transa="T", transb="T")
    want = ref.matmul(rdesc, jnp.asarray(a), jnp.asarray(bt), jnp.asarray(c),
                      alpha=1.5, beta=0.5, algo=ref.Algo(backend))
    got = lt.matmul(from_reference(rdesc), _t(a), _t(bt), _t(c), alpha=1.5, beta=0.5,
                    algo=lt.Algo(backend))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("epi", [e for e in ref.Epilogue
                                 if e not in (ref.Epilogue.DRELU, ref.Epilogue.DGELU,
                                              ref.Epilogue.BGRADB)])
def test_lt_epilogues(ab, rng, epi, backend):
    a, b = ab
    bias = rng.normal(size=N).astype(np.float32)
    rdesc = ref.MatmulDesc(epilogue=epi)
    want = ref.matmul(rdesc, jnp.asarray(a), jnp.asarray(b), bias=jnp.asarray(bias),
                      algo=ref.Algo(backend))
    got = lt.matmul(from_reference(rdesc), _t(a), _t(b), bias=_t(bias),
                    algo=lt.Algo(backend))
    if "aux" in epi.value:
        assert len(got) == len(want) == 2
        _close(got[1], want[1], 1e-5)
        got, want = got[0], want[0]
    _close(got, want, 1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_lt_gelu_bias_bf16(rng, backend):
    """The main path's spelling: bf16 operands, f32 bias, bf16 D."""
    a = rng.normal(size=(M, K)).astype(np.float32).astype(jnp.bfloat16)
    b = rng.normal(size=(K, N)).astype(np.float32).astype(jnp.bfloat16)
    bias = rng.normal(size=N).astype(np.float32)
    rdesc = ref.MatmulDesc(epilogue=ref.Epilogue.GELU_BIAS)
    want = ref.matmul(rdesc, jnp.asarray(a), jnp.asarray(b), bias=jnp.asarray(bias),
                      out_dtype=jnp.bfloat16, algo=ref.Algo(backend))
    got = lt.matmul(from_reference(rdesc), _t(a), _t(b), bias=_t(bias),
                    out_dtype=torch.bfloat16, algo=lt.Algo(backend))
    assert got.dtype == torch.bfloat16
    _close(got, want, 1e-2)


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2", "int8"])
def test_quantize_per_tensor_matches_reference(ab, dtype):
    a, _ = ab
    rq, rs = ref.quantize(jnp.asarray(a), getattr(jnp, dtype))
    q, s = lt.quantize(_t(a), getattr(torch, dtype))
    assert q.dtype == getattr(torch, dtype) and s.shape == ()
    assert float(s) == pytest.approx(float(rs), rel=1e-6)
    np.testing.assert_array_equal(to_numpy(q).astype(np.float32),
                                  np.asarray(rq).astype(np.float32))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_lt_fp8_per_tensor(ab, backend):
    """≙ LtFp8Matmul: e4m3 operands, per-tensor scales, amax_d out."""
    a, b = ab
    qa, sa = lt.quantize(_t(a), torch.float8_e4m3fn)
    qb, sb = lt.quantize(_t(b), torch.float8_e4m3fn)
    d, amax = lt.matmul(lt.MatmulDesc(amax_d=True), qa, qb, a_scale=sa, b_scale=sb,
                        out_dtype=torch.float32, algo=lt.Algo(backend))
    _close(d, a @ b, 0.15)
    assert float(amax) == pytest.approx(float(d.abs().max()), rel=1e-5)


@pytest.mark.parametrize("mode,tol", [("VEC32_UE8M0", 0.1), ("BLK128_F32", 0.15)])
def test_lt_block_scales(rng, mode, tol):
    """≙ LtMxfp8Matmul (1×32 UE8M0) and LtBlk128x128Fp8Matmul (128×128 f32)."""
    m = n = k = 256
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    pmode, rmode = lt.ScaleMode[mode], ref.ScaleMode[mode]
    qa, sa = lt.quantize(_t(a), torch.float8_e4m3fn, pmode, "a")
    qb, sb = lt.quantize(_t(b), torch.float8_e4m3fn, pmode, "b")
    rqa, rsa = ref.quantize(jnp.asarray(a), jnp.float8_e4m3fn, rmode, "a")
    assert tuple(sa.shape) == lt.scale_tensor_shape(pmode, m, k, "a") == rsa.shape
    np.testing.assert_array_equal(to_numpy(sa), np.asarray(rsa))
    np.testing.assert_array_equal(to_numpy(qa).astype(np.float32),
                                  np.asarray(rqa).astype(np.float32))
    desc = lt.MatmulDesc(a_scale_mode=pmode, b_scale_mode=pmode)
    d = lt.matmul(desc, qa, qb, a_scale=sa, b_scale=sb, out_dtype=torch.float32,
                  algo=lt.Algo("pallas"))
    _close(d, a @ b, tol)


def test_lt_nvfp4_packed_matches_reference(ab):
    """≙ LtNvfp4Matmul: packed e2m1 codes and e4m3 block scales bit-exact
    against the reference; the product within its rel-L2 bound."""
    a, b = ab
    mode = lt.ScaleMode.VEC16_E4M3
    qa, sa = lt.fp4_quantize(_t(a), mode, "a")
    qb, sb = lt.fp4_quantize(_t(b), mode, "b")
    rqa, rsa = ref.fp4_quantize(jnp.asarray(a), ref.ScaleMode.VEC16_E4M3, "a")
    assert qa.data.dtype == torch.uint8 and tuple(qa.data.shape) == (M, K // 2)
    assert qa.shape == tuple(rqa.shape) and qa.dtype == torch.uint8
    np.testing.assert_array_equal(to_numpy(qa.data), np.asarray(rqa.data))
    np.testing.assert_array_equal(to_numpy(sa), np.asarray(rsa).astype(np.float32))
    codes = lt.fp4_encode(_t(a))
    assert torch.equal(lt.fp4_unpack(lt.fp4_pack(codes)), codes)
    np.testing.assert_array_equal(to_numpy(codes), np.asarray(ref.fp4_encode(jnp.asarray(a))))
    vals = to_numpy(lt.fp4_dequantize(qa))
    assert set(np.unique(np.abs(vals))) <= {0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0}
    desc = lt.MatmulDesc(a_scale_mode=mode, b_scale_mode=mode, amax_d=True)
    for backend in ("xla", "pallas"):
        d, amax = lt.matmul(desc, qa, qb, a_scale=sa, b_scale=sb, out_dtype=torch.float32,
                            algo=lt.Algo(backend))
        assert rel_l2(d, a @ b) <= 0.15
        assert float(amax) == pytest.approx(float(d.abs().max()), rel=1e-5)
    q, s = lt.quantize(_t(a), "nvfp4", mode, "a")
    assert torch.equal(q.data, qa.data) and torch.equal(s.float(), sa.float())


def test_lt_int8_scaled(ab):
    a, b = ab
    qa, sa = lt.quantize(_t(a), torch.int8)
    qb, sb = lt.quantize(_t(b), torch.int8)
    for backend in ("xla", "pallas"):
        d = lt.matmul(lt.MatmulDesc(), qa, qb, a_scale=sa, b_scale=sb,
                      out_dtype=torch.float32, algo=lt.Algo(backend))
        _close(d, a @ b, 0.1)


@pytest.mark.parametrize("epi", ["DRELU", "DGELU", "BGRADB"])
def test_lt_backward_epilogues(ab, rng, epi):
    a, b = ab
    aux = rng.normal(size=(M, N)).astype(np.float32)
    c = rng.normal(size=(M, N)).astype(np.float32)
    rdesc = ref.MatmulDesc(epilogue=ref.Epilogue[epi])
    want = ref.matmul(rdesc, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                      alpha=0.5, beta=2.0, aux=jnp.asarray(aux))
    got = lt.matmul(from_reference(rdesc), _t(a), _t(b), _t(c), alpha=0.5, beta=2.0,
                    aux=_t(aux))
    if epi == "BGRADB":
        _close(got[1], want[1], 1e-5)
        got, want = got[0], want[0]
    _close(got, want, 1e-5)


def test_lt_plan_and_autotune(ab, tmp_path, monkeypatch):
    """≙ LtMatmulCustomFind: timed sweep returns a working algo."""
    import tpumathlib_torch.core.tuning as tuning

    monkeypatch.setattr(tuning, "_global_cache", tuning.AutotuneCache(str(tmp_path / "at.json")))
    a, b = ab
    desc = lt.MatmulDesc()
    algo = lt.matmul_autotune(desc, _t(a), _t(b))
    assert algo in lt.matmul_algo_candidates(desc, lt.MatrixLayout(torch.float32, M, K),
                                             lt.MatrixLayout(torch.float32, K, N))
    assert len(tuning.global_autotune_cache()._mem) == 1
    plan = lt.Matmul(desc, algo)
    _close(plan(_t(a), _t(b)), a @ b, 1e-5)


def test_lt_dgemm_emulated_not_yet_ported(rng):
    a = torch.from_numpy(rng.normal(size=(24, 32)))
    with pytest.raises(NotSupportedError, match="A2"):
        lt.matmul(lt.MatmulDesc(compute_dtype=torch.float64), a, a.mT.contiguous())


def test_igemm_int32_exact(rng):
    """≙ LtIgemmTensor: int8×int8→int32, bit-exact against the reference."""
    m, k, n = 64, 96, 48
    a = rng.integers(-128, 128, (m, k), dtype=np.int8)
    b = rng.integers(-128, 128, (k, n), dtype=np.int8)
    cmat = rng.integers(-1000, 1000, (m, n), dtype=np.int32)
    rdesc = ref.MatmulDesc(compute_dtype=jnp.int32)
    desc = from_reference(rdesc)
    d = lt.matmul(desc, _t(a), _t(b))
    assert d.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(d), np.asarray(ref.matmul(rdesc, a, b)))
    d2, amax = lt.matmul(lt.MatmulDesc(compute_dtype=torch.int32, amax_d=True), _t(a), _t(b),
                         c=_t(cmat), alpha=2, beta=-3)
    want2 = np.asarray(ref.matmul(rdesc, jnp.asarray(a), jnp.asarray(b), c=jnp.asarray(cmat),
                                  alpha=2, beta=-3))
    np.testing.assert_array_equal(to_numpy(d2), want2)
    assert float(amax) == np.abs(want2).max()
    d3 = lt.matmul(lt.MatmulDesc(compute_dtype=torch.int32, transa="T"), _t(a.T.copy()), _t(b))
    np.testing.assert_array_equal(to_numpy(d3), to_numpy(d))
    with pytest.raises(Exception):
        lt.matmul(desc, _t(a), _t(b), alpha=0.5)


@pytest.mark.parametrize("use_3m", [True, False])
def test_matmul_planar(rng, use_3m):
    xs = [rng.normal(size=s).astype(np.float32) for s in ((8, 6), (8, 6), (6, 5), (6, 5))]
    want = ref.matmul_planar(*map(jnp.asarray, xs), alpha=2.0, use_3m=use_3m)
    got = lt.matmul_planar(*map(_t, xs), alpha=2.0, use_3m=use_3m)
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-5)
