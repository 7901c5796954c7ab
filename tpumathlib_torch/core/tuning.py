"""On-disk autotune cache.

Counterpart of ``tpumathlib/core/tuning.py`` (≙ CUBLAS_GEMM_AUTOTUNE and the
Lt algo sweep, cuBLASLt/Common/LtMatmulCustomFind.h:189-274). An "algo" is
a compiled kernel config; the cache persists measured winners keyed by
(op, problem, device kind). Keys carry a ``torch|`` prefix, so the port and
the JAX package can share one cache file without colliding.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Iterable

import torch

from tpumathlib_torch.core.errors import NotSupportedError

_DEFAULT_PATH = os.environ.get(
    "TPUMATHLIB_AUTOTUNE_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "tpumathlib", "autotune.json"),
)


def device_kind() -> str:
    """The CUDA card's name (e.g. ``NVIDIA_H100_80GB_HBM3``), or ``cpu``."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name().replace(" ", "_")
    return "cpu"


class AutotuneCache:
    def __init__(self, path: str | None = None):
        self.path = path or _DEFAULT_PATH
        self._mem: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._loaded = False

    def _load(self):
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                self._mem.update(json.load(f))
        except (OSError, json.JSONDecodeError):
            pass

    def _save(self):
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._mem, f)
            os.replace(tmp, self.path)
        except OSError:
            pass

    @staticmethod
    def make_key(op: str, problem: tuple) -> str:
        return f"torch|{device_kind()}|{op}|{'/'.join(map(str, problem))}"

    def get(self, key: str):
        with self._lock:
            self._load()
            return self._mem.get(key)

    def put(self, key: str, value):
        with self._lock:
            self._load()
            self._mem[key] = value
            self._save()

    def tune(
        self,
        op: str,
        problem: tuple,
        candidates: Iterable[Any],
        build: Callable[[Any], Callable[[], Any]],
        measure: Callable[[Callable[[], Any]], float] | None = None,
    ):
        """Timed sweep over candidate configs (≙ LtMatmulCustomFind timed run
        loop). ``build(cfg)`` returns a nullary runner; returns winning cfg.

        A candidate the kernels do not support (``NotSupportedError``) is
        skipped, as a heuristic returns no algo for it; any other failure,
        a kernel that does not build or launch included, propagates."""
        key = self.make_key(op, problem)
        cached = self.get(key)
        cands = list(candidates)
        if cached is not None:
            for c in cands:
                if _cfg_to_jsonable(c) == cached:
                    return c
        if measure is None:
            from tpumathlib_torch.core.timer import benchmark

            def measure(run):  # noqa: F811
                return benchmark(run, warmup=1, iters=3)["med"]

        best, best_t = None, float("inf")
        for cfg in cands:
            try:
                t = measure(build(cfg))
            except NotSupportedError:
                continue
            if t < best_t:
                best, best_t = cfg, t
        if best is None:
            raise RuntimeError(f"autotune: no working candidate for {key}")
        self.put(key, _cfg_to_jsonable(best))
        return best


def _cfg_to_jsonable(cfg):
    if isinstance(cfg, tuple):
        return list(cfg)
    if isinstance(cfg, dict):
        return {k: _cfg_to_jsonable(v) for k, v in sorted(cfg.items())}
    return cfg


_global_cache: AutotuneCache | None = None


def global_autotune_cache() -> AutotuneCache:
    global _global_cache
    if _global_cache is None:
        _global_cache = AutotuneCache()
    return _global_cache
