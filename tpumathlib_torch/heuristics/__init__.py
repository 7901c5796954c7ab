"""heuristics — the nvMatmulHeuristics capability surface.

Counterpart of ``tpumathlib/heuristics/__init__.py`` (nvMatmulHeuristics/
1_gemm_heuristics.cpp:33-66, 2_discovery.cpp, 5_get_configs.py):
  hardware descriptor (+ predefined GPUs) → HardwareDescriptor + PREDEFINED
  nvMatmulHeuristicsGetGemmConfig (top-N)  → get_configs
  runtime estimation                        → estimate_runtime (compute /
                                              memory roofline over the tile space)
  LoadInternalDiscoverySet (silicon scans)  → run_discovery / load_discovery
                                              (measured factors, persisted in
                                              the autotune cache, that calibrate
                                              the analytic model)
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from tpumathlib_torch.core.dtypes import cdiv, traits
from tpumathlib_torch.core.tuning import device_kind, global_autotune_cache
from tpumathlib_torch.dx.gemm import MatmulConfig


@dataclasses.dataclass(frozen=True)
class HardwareDescriptor:
    """≙ nvmmhHardwareDescriptor."""

    name: str
    bf16_tflops: float
    fp32_tflops: float
    int8_tops: float
    hbm_gbps: float
    smem_bytes: int = 232_448   # shared memory one thread block may use
    cores: int = 1              # streaming multiprocessors


PREDEFINED = {
    # NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s bf16 (tensor
    # cores), 67 TFLOP/s f32 outside the tensor cores, 1979 TOP/s int8,
    # 3350 GB/s HBM3; 227 KB of shared memory per block; 132 SMs.
    "H100": HardwareDescriptor("H100", 989.0, 67.0, 1979.0, 3350.0,
                               smem_bytes=232_448, cores=132),
}


def detect_hardware() -> HardwareDescriptor:
    """The descriptor whose name appears in the CUDA card's name; the H100
    (the port's target) when none does or there is no card."""
    kind = device_kind().replace("_", " ")
    for k, v in PREDEFINED.items():
        if k in kind:
            return v
    return PREDEFINED["H100"]


def _peak_flops(hw: HardwareDescriptor, dtype) -> float:
    t = traits(dtype)
    if t.itemsize == 1:
        return hw.int8_tops * 1e12
    if t.itemsize == 2:
        return hw.bf16_tflops * 1e12
    return hw.fp32_tflops * 1e12


def estimate_runtime(m: int, n: int, k: int, dtype, cfg: MatmulConfig,
                     hw: HardwareDescriptor | None = None,
                     calibration: dict | None = None) -> float:
    """Analytic roofline: seconds = max(compute, memory) with a tile-aware
    traffic model (A and B re-read per tile pass) + per-tile overhead.

    ``calibration`` (from discovery) multiplies the estimate by the measured
    efficiency of the nearest discovered problem."""
    hw = hw or detect_hardware()
    it = traits(dtype).itemsize
    nm, nn, nk = cdiv(m, cfg.bm), cdiv(n, cfg.bn), cdiv(k, cfg.bk)
    flops = 2.0 * m * n * k
    # each (i, j) tile streams the full K panel of A and B
    bytes_moved = (
        nm * nn * (cfg.bm * k * it + k * cfg.bn * it) + m * n * it
    )
    t_compute = flops / _peak_flops(hw, dtype)
    t_memory = bytes_moved / (hw.hbm_gbps * 1e9)
    # efficiency drops for skinny tiles (<128 in either matmul dim)
    eff = min(cfg.bm, 128) / 128 * min(cfg.bn, 128) / 128
    t = max(t_compute / max(eff, 1e-3), t_memory) + nm * nn * nk * 2e-7
    if calibration:
        buckets = calibration.get("buckets")
        if buckets:
            key = _intensity_bucket(m, n, k)
            ks = sorted(int(x) for x in buckets)
            nearest = min(ks, key=lambda x: abs(x - key))
            t *= buckets[str(nearest)]
        else:
            t *= calibration.get("factor", 1.0)
    return t


def get_configs(m: int, n: int, k: int, dtype, count: int = 8,
                hw: HardwareDescriptor | None = None) -> list[MatmulConfig]:
    """Top-``count`` kernel configs by estimated runtime (≙ get_configs.py /
    nvMatmulHeuristicsGetGemmConfig), from the compiled set."""
    from tpumathlib_torch.dx.gemm import default_configs

    cal = load_discovery()
    cands = list(default_configs(dtype))
    ranked = sorted(cands, key=lambda c: estimate_runtime(m, n, k, dtype, c, hw, cal))
    return ranked[:count]


_DISCOVERY_KEY = "mmh_discovery"


# the internal discovery set spans the shape classes the estimator must
# rank: square ladder, skinny-K/M/N panels, and a tall panel
# (≙ nvMatmulHeuristics' internal silicon scan covering problem classes)
_DISCOVERY_SET = (
    (512, 512, 512),
    (1024, 1024, 1024),
    (2048, 2048, 2048),
    (4096, 4096, 4096),
    (4096, 4096, 512),      # skinny K
    (512, 4096, 4096),      # skinny M
    (4096, 512, 4096),      # skinny N
    (8192, 1024, 1024),     # tall panel
)


def _intensity_bucket(m: int, n: int, k: int) -> int:
    """log2 bucket of arithmetic intensity — the calibration key."""
    import math as _math

    it = 2  # bf16 discovery operands
    ai = 2.0 * m * n * k / ((m * k + k * n + m * n) * it)
    return int(_math.log2(max(ai, 1.0)))


def run_discovery(problems: Sequence[tuple] | None = None,
                  device: torch.device | str = "cuda") -> dict:
    """Measured silicon scan (≙ nvMatmulHeuristicsLoadInternalDiscoverySet):
    times ``pallas_matmul`` on bf16 operands on ``device`` (CUDA events on a
    card) and stores measured/predicted factors PER arithmetic-intensity
    bucket, so skinny and square problems calibrate independently."""
    from tpumathlib_torch.core.timer import benchmark
    from tpumathlib_torch.dx.gemm import _pick_config, pallas_matmul

    problems = problems or _DISCOVERY_SET
    hw = detect_hardware()
    buckets: dict = {}
    for (m, n, k) in problems:
        a = torch.ones((m, k), dtype=torch.bfloat16, device=device)
        b = torch.ones((k, n), dtype=torch.bfloat16, device=device)
        cfg = _pick_config(m, n, k, torch.bfloat16, torch.bfloat16)
        meas = benchmark(pallas_matmul, a, b, config=cfg, warmup=1, iters=3)["min"]
        pred = estimate_runtime(m, n, k, torch.bfloat16, cfg, hw)
        buckets.setdefault(_intensity_bucket(m, n, k), []).append(meas / pred)
    cal = {"buckets": {str(kk): sum(v) / len(v)
                       for kk, v in buckets.items()},
           "factor": (sum(x for v in buckets.values() for x in v)
                      / sum(len(v) for v in buckets.values())),
           "n": sum(len(v) for v in buckets.values())}
    global_autotune_cache().put(
        global_autotune_cache().make_key(_DISCOVERY_KEY, ()), cal)
    return cal


def load_discovery() -> dict | None:
    return global_autotune_cache().get(
        global_autotune_cache().make_key(_DISCOVERY_KEY, ()))
