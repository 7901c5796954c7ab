"""Parity of tpumathlib_torch.heuristics with tpumathlib.heuristics: the
H100 descriptor, the roofline estimate (the same formula, so the same
seconds for the same hardware numbers), config ranking, and discovery.
"""

import jax.numpy as jnp
import pytest
import torch

from tpumathlib import heuristics as ref
from tpumathlib.dx.gemm import MatmulConfig as RefConfig
from tpumathlib_torch import heuristics
from tpumathlib_torch.core import tuning
from tpumathlib_torch.dx.gemm import MatmulConfig, default_configs

torch.set_num_threads(1)


def test_h100_descriptor():
    hw = heuristics.PREDEFINED["H100"]
    assert (hw.bf16_tflops, hw.fp32_tflops, hw.int8_tops, hw.hbm_gbps) == \
        (989.0, 67.0, 1979.0, 3350.0)
    assert hw.smem_bytes == 232_448 and hw.cores == 132
    # no card here: the port's target is the default
    assert heuristics.detect_hardware() is hw


@pytest.mark.parametrize("shape", [(4096, 4096, 4096), (512, 512, 512), (4096, 512, 4096),
                                   (100, 50, 70)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_estimate_runtime_matches_reference(shape, dtype):
    """The same formula: equal seconds for the same hardware numbers."""
    hw = heuristics.PREDEFINED["H100"]
    rhw = ref.HardwareDescriptor("H100", hw.bf16_tflops, hw.fp32_tflops, hw.int8_tops,
                                 hw.hbm_gbps, cores=hw.cores)
    for cfg in default_configs():
        got = heuristics.estimate_runtime(*shape, getattr(torch, dtype), cfg, hw)
        want = ref.estimate_runtime(*shape, getattr(jnp, dtype),
                                    RefConfig(cfg.bm, cfg.bn, cfg.bk), rhw)
        assert got == pytest.approx(want, rel=1e-12)


def test_roofline_sanity():
    hw = heuristics.PREDEFINED["H100"]
    cfg = MatmulConfig()
    big = heuristics.estimate_runtime(8192, 8192, 8192, torch.bfloat16, cfg, hw)
    small = heuristics.estimate_runtime(512, 512, 512, torch.bfloat16, cfg, hw)
    assert big > small
    assert big >= 2 * 8192**3 / (hw.bf16_tflops * 1e12)


def test_get_configs(tmp_path, monkeypatch):
    monkeypatch.setattr(tuning, "_global_cache", tuning.AutotuneCache(str(tmp_path / "at.json")))
    cfgs = heuristics.get_configs(4096, 4096, 4096, torch.bfloat16, count=5)
    assert len(cfgs) == 3 and set(cfgs) == set(default_configs())
    assert cfgs[0] == MatmulConfig(128, 128, 16)   # big square problems take big tiles


def test_discovery_buckets(tmp_path, monkeypatch):
    """run_discovery times pallas_matmul per problem and calibrates per
    arithmetic-intensity bucket; the estimator uses the nearest bucket."""
    monkeypatch.setattr(tuning, "_global_cache", tuning.AutotuneCache(str(tmp_path / "at.json")))
    assert heuristics._DISCOVERY_SET == ref._DISCOVERY_SET
    for p in heuristics._DISCOVERY_SET:
        assert heuristics._intensity_bucket(*p) == ref._intensity_bucket(*p)
    cal = heuristics.run_discovery(problems=[(128, 128, 128), (128, 128, 512), (256, 256, 256)],
                                   device="cpu")
    assert cal["n"] == 3 and cal["buckets"]
    assert heuristics.load_discovery()["buckets"] == cal["buckets"]
    cfg = MatmulConfig(128, 128, 16)
    t_cal = heuristics.estimate_runtime(256, 256, 256, torch.bfloat16, cfg, calibration=cal)
    t_raw = heuristics.estimate_runtime(256, 256, 256, torch.bfloat16, cfg)
    key = str(min((int(k) for k in cal["buckets"]),
                  key=lambda x: abs(x - heuristics._intensity_bucket(256, 256, 256))))
    assert abs(t_cal - t_raw * cal["buckets"][key]) < 1e-12
