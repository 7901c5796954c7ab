"""Parity of tpumathlib_torch.core with tpumathlib.core: errors, dtype traits,
checks, timer, plans, the autotune cache and the interop helpers.

Inputs are seeded numpy arrays with explicit dtypes (the suite runs JAX with
x64 on); both packages get the same values.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpumathlib.core import check as ref_check
from tpumathlib.core import dtypes as ref_dtypes
from tpumathlib.core import errors as ref_errors
from tpumathlib.core import plan as ref_plan
from tpumathlib_torch.core import check, dtypes, errors, interop, plan, timer, tuning
from tpumathlib_torch.core import device as core_device

torch.set_num_threads(1)

# reference dtype name → (jax dtype, torch dtype)
DTYPES = {
    "f64": (jnp.float64, torch.float64),
    "f32": (jnp.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "f16": (jnp.float16, torch.float16),
    "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
    "e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
    "i8": (jnp.int8, torch.int8),
    "i32": (jnp.int32, torch.int32),
    "c64": (jnp.complex64, torch.complex64),
    "c128": (jnp.complex128, torch.complex128),
}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_traits_match_reference(name):
    jdt, tdt = DTYPES[name]
    r, p = ref_dtypes.traits(jdt), dtypes.traits(tdt)
    assert (p.name, p.is_complex, p.is_float, p.itemsize, p.rtol) == \
        (r.name, r.is_complex, r.is_float, r.itemsize, r.rtol)
    assert p.acc_dtype == interop.torch_dtype(r.acc_dtype)


def test_dtype_helpers():
    assert dtypes.default_rtol(torch.float32, torch.bfloat16) == \
        ref_dtypes.default_rtol(jnp.float32, jnp.bfloat16) == 1e-2
    assert dtypes.default_rtol(torch.int8) == ref_dtypes.default_rtol(jnp.int8) == 1e-5
    assert dtypes.real_dtype(torch.complex128) == torch.float64
    assert dtypes.complex_dtype(torch.float32) == torch.complex64
    for x, m in ((0, 8), (7, 8), (9, 128), (300, 16)):
        assert dtypes.round_up(x, m) == ref_dtypes.round_up(x, m)
        assert dtypes.cdiv(x, m) == ref_dtypes.cdiv(x, m)


@pytest.mark.parametrize("kind,dtype", [("uniform", torch.float32), ("normal", torch.bfloat16),
                                        ("posdef", torch.float64), ("diagdom", torch.float32),
                                        ("normal", torch.complex64), ("uniform", torch.int8)])
def test_random_array(kind, dtype):
    gen = torch.Generator().manual_seed(0)
    x = dtypes.random_array(gen, (6, 6), dtype, kind)
    assert x.shape == (6, 6) and x.dtype == dtype
    again = dtypes.random_array(torch.Generator().manual_seed(0), (6, 6), dtype, kind)
    assert torch.equal(x, again)
    if kind == "posdef":
        assert bool((torch.linalg.eigvalsh(x) > 0).all())
    if kind == "diagdom":
        d = x.diagonal().abs()
        assert bool((d >= x.abs().sum(-1) - d).all())


def test_errors_match_reference():
    assert [s.name for s in errors.Status] == [s.name for s in ref_errors.Status]
    assert [s.value for s in errors.Status] == [s.value for s in ref_errors.Status]
    for name in ("InvalidValueError", "NotSupportedError", "ExecutionError"):
        assert getattr(errors, name).status.name == getattr(ref_errors, name).status.name
    assert issubclass(errors.NotSupportedError, NotImplementedError)
    with pytest.raises(errors.InvalidValueError, match="bad"):
        errors.check(False, "bad")
    errors.check(True, "fine")


@pytest.mark.parametrize("rtol", [None, 1e-3, 1e-6])
def test_check_matches_reference(rng, rtol):
    want = rng.normal(size=(7, 5)).astype(np.float32)
    got = (want + 1e-4 * rng.normal(size=want.shape)).astype(np.float32)
    g_t = torch.from_numpy(got)
    assert check.allclose(g_t, want, rtol=rtol) == ref_check.allclose(got, want, rtol=rtol)
    assert check.allclose(got, want, rtol=rtol) == ref_check.allclose(got, want, rtol=rtol)
    assert check.max_abs_rel(g_t, want) == pytest.approx(ref_check.max_abs_rel(got, want))
    assert check.rel_l2(g_t, want) == pytest.approx(ref_check.rel_l2(got, want))
    assert check.rel_linf(g_t, want) == pytest.approx(ref_check.rel_linf(got, want))


def test_assert_allclose_reports(rng):
    want = rng.normal(size=(4, 4))
    check.assert_allclose(torch.from_numpy(want), want)
    with pytest.raises(AssertionError, match="max_abs"):
        check.assert_allclose(torch.from_numpy(want + 1.0), want, msg="shifted")
    assert check.max_scaled_err(torch.from_numpy(want + 0.5), want) == \
        pytest.approx(0.5 / max(np.abs(want).max(), 1.0))


def test_timer_cpu():
    x = torch.ones(64, 64)
    stats = timer.benchmark(torch.matmul, x, x, warmup=1, iters=3)
    assert set(stats) == {"avg", "med", "std", "min", "max", "times"}
    assert len(stats["times"]) == 3 and stats["min"] > 0
    assert timer.gemm_gflops(4, 4, 4, 1.0) == 128 / 1e9


def test_plan_cache_matches_reference():
    for cls in (plan.PlanCache, ref_plan.PlanCache):
        cache = cls(maxsize=2)
        calls = []
        for key in ("a", "b", "a", "c", "b"):
            cache.get_or_build((key,), lambda k=key: calls.append(k) or k)
        assert (cache.hits, cache.misses, calls) == (1, 4, ["a", "b", "c", "b"])
    assert plan.Handle().device == torch.device("cuda")   # the card, with or without one
    h = plan.Handle(device="cpu")
    assert h.device == torch.device("cpu")
    p = plan.Plan(("k",), lambda x: x + 1, h)
    assert p(1) == 2 and "k" in repr(p)


def test_autotune_cache_keys_and_tune(tmp_path):
    cache = tuning.AutotuneCache(str(tmp_path / "at.json"))
    key = cache.make_key("op", (1, 2))
    assert key == "torch|cpu|op|1/2"
    assert tuning.device_kind() == "cpu"

    def build(cfg):
        def run():
            if cfg == "unsupported":
                raise errors.NotSupportedError(cfg)
            return cfg
        return run

    times = {"slow": 2.0, "fast": 1.0}
    best = cache.tune("op", (1, 2), ["slow", "unsupported", "fast"], build,
                      measure=lambda run: times[run()])
    assert best == "fast"
    assert tuning.AutotuneCache(str(tmp_path / "at.json")).get(key) == "fast"


def test_autotune_propagates_failures(tmp_path):
    cache = tuning.AutotuneCache(str(tmp_path / "at.json"))

    def build(cfg):
        raise errors.ExecutionError("kernel did not build")

    with pytest.raises(errors.ExecutionError):
        cache.tune("op", (3,), ["a"], build, measure=lambda run: 1.0)


@pytest.mark.parametrize("dt,tdt", [(ml_dtypes.bfloat16, torch.bfloat16),
                                    (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
                                    (ml_dtypes.float8_e5m2, torch.float8_e5m2),
                                    (np.float32, torch.float32), (np.int8, torch.int8)])
def test_from_numpy_and_back(rng, dt, tdt):
    x = rng.normal(size=(5, 6)).astype(np.float32).astype(dt)
    t = interop.from_numpy(x)
    assert t.dtype == tdt and t.shape == x.shape
    np.testing.assert_array_equal(interop.to_numpy(t), x.astype(interop.to_numpy(t).dtype))
    # the same values as the reference's own array of that dtype
    np.testing.assert_array_equal(interop.to_numpy(t).astype(np.float64),
                                  np.asarray(jnp.asarray(x)).astype(np.float64))


def test_default_device_is_the_card_without_a_fallback():
    """One default device, the card: no ``torch.cuda.is_available()`` test
    picks the CPU when there is no card."""
    import inspect

    from tpumathlib_torch.sparse import containers

    assert core_device.default_device() == torch.device("cuda")
    for mod in (core_device, plan, interop, containers):
        assert "is_available" not in inspect.getsource(mod)


def test_host_array_conversion_raises_without_a_card():
    """A host array turned into a container with the default device goes to
    the card; on a torch without CUDA that raises instead of landing on the
    CPU."""
    from tpumathlib_torch import sparse

    if torch.cuda.is_available():
        assert sparse.dense_to_csr(np.eye(3)).data.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            sparse.dense_to_csr(np.eye(3))


def test_one_patch_moves_every_default(monkeypatch):
    """Handle, the sparse containers, from_reference and the generators all
    read core.device.default_device through the module, so one patch covers
    them (the meta device stands in for the card)."""
    from tpumathlib.sparse import convert as ref_convert
    from tpumathlib_torch import rand, sparse

    meta = torch.device("meta")
    monkeypatch.setattr(core_device, "default_device", lambda: meta)
    assert plan.Handle().device == meta
    assert sparse.containers.default_device() == meta
    assert sparse.dense_to_csr(np.eye(3)).data.device == meta
    assert interop.from_reference(ref_convert.dense_to_coo(np.eye(3))).data.device == meta
    assert rand.PhiloxGenerator(1).device == meta
    assert rand.SobolGenerator(2).device == meta
