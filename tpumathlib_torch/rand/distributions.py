"""Distribution transforms over raw 32-bit words (≙ curandGenerateUniform /
Normal / LogNormal / Poisson).

Counterpart of ``tpumathlib/rand/distributions.py``, with its conventions:
- uniform: (0, 1] (cuRAND excludes 0, includes 1), (bits + 1) / 2³² in
  float64, then cast;
- normal: Box–Muller over uniform pairs, in float32;
- poisson: Knuth's product of uniforms for λ ≤ 64, each sample's uniforms
  drawn from Philox blocks keyed by its first two words; the normal
  approximation above.

Words arrive as ``torch.uint32`` tensors (or any integer tensor holding
values below 2³²); torch cannot shift or add ``uint32``, so they are read
as int64 (``words``).
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF


def words(bits: torch.Tensor) -> torch.Tensor:
    """The 32-bit words of ``bits`` as int64 values in [0, 2³²)."""
    if bits.dtype in (torch.uint32, torch.int32):
        return bits.view(torch.int32).to(torch.int64) & _MASK
    return bits.to(torch.int64) & _MASK


def as_uint32(w: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit words → ``torch.uint32``, through their int32
    bits (a conversion to int32 and a view, which torch has on every
    device)."""
    return (((w + 2**31) & _MASK) - 2**31).to(torch.int32).view(torch.uint32)


def bits_to_uniform(bits, dtype=torch.float32):
    """uint32 → (0, 1] (cuRAND's curand_uniform convention)."""
    u = (words(bits).to(torch.float64) + 1.0) / 4294967296.0
    return u.to(dtype)


def bits_to_normal(bits, mean=0.0, stddev=1.0):
    """Box–Muller over consecutive uniform pairs; input length must be even;
    returns same length."""
    u = bits_to_uniform(bits, torch.float32).reshape(-1, 2)
    r = torch.sqrt(-2.0 * torch.log(u[:, 0]))
    theta = 2.0 * math.pi * u[:, 1]
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1).reshape(-1)
    return mean + stddev * z


def bits_to_lognormal(bits, mean=0.0, stddev=1.0):
    return torch.exp(bits_to_normal(bits, mean, stddev))


def bits_to_poisson(bits, lam: float):
    """Poisson(λ) from 4 words per sample, ``bits`` of shape (n, 4): the
    product of uniforms for λ ≤ 64, at most λ + 10√λ + 16 factors, the
    uniforms from Philox blocks (counter (i, 0, 0, 0), key the sample's first
    two words); the normal approximation with continuity correction above
    (curand_poisson splits its regimes the same way)."""
    from tpumathlib_torch.rand.generators import philox4x32_10

    w = words(bits)
    n = w.shape[0]
    if lam <= 64.0:
        kmax = int(lam + 10 * lam**0.5 + 16)
        key = w[:, :2]
        ctr = torch.zeros((n, 4), dtype=torch.int64, device=w.device)
        limit = math.exp(-lam)
        count = torch.full((n,), -1, dtype=torch.int32, device=w.device)
        prod = torch.ones(n, dtype=torch.float32, device=w.device)
        for i in range(kmax):
            ctr[:, 0] = i
            u = bits_to_uniform(philox4x32_10(ctr, key)[:, 0], torch.float32)
            alive = prod >= limit
            count = count + alive.to(torch.int32)
            prod = torch.where(alive, prod * u, prod)
        return torch.clamp_min(count, 0)
    z = bits_to_normal(w[:, :2].reshape(-1))[:n]
    return torch.clamp_min(torch.round(lam + math.sqrt(lam) * z - 0.5), 0.0).to(torch.int32)
