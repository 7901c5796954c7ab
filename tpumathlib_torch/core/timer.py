"""Benchmark timer with warm-up and avg/med/std/min/max stats.

Counterpart of ``tpumathlib/core/timer.py`` (≙ the MathDx microbench
``measure_execution_ms``, block_fft_performance.hpp:66-141). On CUDA
tensors each run sits between two CUDA events on the current stream, so the
time is the device's; on CPU tensors it is ``perf_counter`` around the call.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch


def _on_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(v) for v in x)
    return False


def benchmark(
    fn: Callable[..., Any],
    *args,
    warmup: int = 2,
    iters: int = 10,
    **kwargs,
) -> dict:
    """Time ``fn(*args)`` after warm-up; returns stats in seconds.

    Keys: avg, med, std, min, max, times. Median is the headline number."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    cuda = _on_cuda(out) or _on_cuda(args) or _on_cuda(list(kwargs.values()))
    times = []
    if cuda:
        torch.cuda.synchronize()
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    t = np.asarray(times)
    return {
        "avg": float(t.mean()),
        "med": float(np.median(t)),
        "std": float(t.std()),
        "min": float(t.min()),
        "max": float(t.max()),
        "times": times,
    }


def gemm_gflops(m: int, n: int, k: int, seconds: float, complex_op: bool = False) -> float:
    """GFlop/s = 2mnk/t (cuBLASMp/gemm.cu:501); 8mnk for complex (gemm3m aside)."""
    mult = 8 if complex_op else 2
    return mult * m * n * k / seconds / 1e9


def fft_gflops(n_total: int, seconds: float) -> float:
    """GFlop/s = 5·N·log2(N)/t."""
    return 5.0 * n_total * np.log2(max(n_total, 2)) / seconds / 1e9
