"""Handle / Plan / PlanCache — the library lifecycle.

Counterpart of ``tpumathlib/core/plan.py`` (≙ cublasHandle_t and the plan
caches of cuTENSOR/cuFFT). PyTorch runs eagerly, so a ``Plan`` holds a
plain callable; ``Handle.device`` is the ``torch.device`` it runs on.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import torch

from tpumathlib_torch.core import device as _device


@dataclasses.dataclass
class Handle:
    """Library context (≙ cublasHandle_t). Work is ordered on the device's
    current stream; ``device`` pins placement, by default the card
    (``core.device.default_device()``)."""

    device: Any = None
    mesh: Any = None

    def __post_init__(self):
        if self.device is None:
            self.device = _device.default_device()
        self.device = torch.device(self.device)


_default_handle: Handle | None = None
_lock = threading.Lock()


def default_handle() -> Handle:
    global _default_handle
    with _lock:
        if _default_handle is None:
            _default_handle = Handle()
        return _default_handle


class Plan:
    """An execution plan: descriptor key + callable.

    ``key`` must be a hashable full description (shapes, dtypes, flags) —
    identical keys share one plan via PlanCache.
    """

    def __init__(self, key: tuple, fn: Callable, handle: Handle | None = None):
        self.key = key
        self.fn = fn
        self.handle = handle or default_handle()

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __repr__(self):
        return f"{type(self).__name__}(key={self.key!r})"


class PlanCache:
    """Keyed plan cache (≙ cutensorPlanCache / cufftPlan caching).

    Thread-safe; bounded LRU.
    """

    def __init__(self, maxsize: int = 256):
        self._cache: dict[tuple, Any] = {}
        self._order: list[tuple] = []
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: tuple, builder: Callable[[], Any]):
        with self._lock:
            if key in self._cache:
                self.hits += 1
                self._order.remove(key)
                self._order.append(key)
                return self._cache[key]
        plan = builder()
        with self._lock:
            self.misses += 1
            self._cache[key] = plan
            self._order.append(key)
            while len(self._order) > self._maxsize:
                old = self._order.pop(0)
                self._cache.pop(old, None)
        return plan

    def clear(self):
        with self._lock:
            self._cache.clear()
            self._order.clear()
