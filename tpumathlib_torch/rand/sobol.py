"""Sobol quasi-random generator, 32- and 64-bit (+ scrambled variants).

Counterpart of ``tpumathlib/rand/sobol.py`` (CURAND_RNG_QUASI_SOBOL32 /
SCRAMBLED_SOBOL32 / SOBOL64 / SCRAMBLED_SOBOL64, with dimension count and
offset semantics), bit for bit.

Direction numbers come from the Joe–Kuo new-joe-kuo-6.21201 table, the
public table cuRAND ships, kept beside this module (``rand/_joekuo.npz``, a
copy of the reference's: primitive polynomials and initial m values for
21201 dimensions). 32-bit words are generated on the device by the
Gray-code XOR recurrence vectorised over dimensions; 64-bit words on the
host, handed to the device as a planar (hi, lo) pair of uint32 tensors, as
the reference does. Scrambling is a random digital shift (XOR of a
per-dimension word drawn from ``np.random.RandomState(seed or 1)``).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.rand import distributions as dist
from tpumathlib_torch.rand.generators import _on

_MAX_DIM = 21201


@functools.lru_cache(maxsize=1)
def _joekuo_table():
    path = os.path.join(os.path.dirname(__file__), "_joekuo.npz")
    z = np.load(path)
    return z["poly"].astype(np.int64), z["vinit"].astype(np.int64)


def _direction_numbers(dim: int, bits: int = 32) -> np.ndarray:
    """(dim, bits) uint64 direction numbers v_k scaled to ``bits`` bits."""
    check(1 <= dim <= _MAX_DIM, f"sobol supports 1..{_MAX_DIM} dimensions")
    poly, vinit = _joekuo_table()
    top = bits - 1
    vs = np.zeros((dim, bits), np.uint64)
    # dimension 0: van der Corput (v_k = 2^(bits-1-k))
    vs[0] = np.uint64(1) << np.arange(top, -1, -1, dtype=np.uint64)
    for d in range(1, dim):
        p = int(poly[d])
        s = p.bit_length() - 1
        m = vinit[d, :s]
        v = [int(m[k]) << (top - k) for k in range(min(s, bits))]
        for k in range(s, bits):
            new = v[k - s] ^ (v[k - s] >> s)
            for j in range(1, s):
                if (p >> (s - j)) & 1:
                    new ^= v[k - j]
            v.append(new)
        vs[d] = np.asarray(v[:bits], np.uint64)
    return vs


def _sobol_words(v: np.ndarray, offset: int, count: int, bits: int) -> np.ndarray:
    """Host Gray-code recurrence: (count, dim) uint64 raw Sobol words."""
    idx = (np.arange(1, count + 1, dtype=np.int64) + offset).astype(np.uint64)
    gray = idx ^ (idx >> np.uint64(1))
    kbits = ((gray[:, None] >> np.arange(bits, dtype=np.uint64)[None, :])
             & np.uint64(1))                      # (count, bits)
    out = np.zeros((count, v.shape[0]), np.uint64)
    for k in range(bits):
        sel = kbits[:, k:k + 1].astype(bool)
        out ^= np.where(sel, v[None, :, k], np.uint64(0))
    return out


class SobolGenerator:
    """≙ curandCreateGenerator(CURAND_RNG_QUASI_SOBOL32/64) +
    SetQuasiRandomGeneratorDimensions + SetGeneratorOffset.

    ``bits=64`` selects the sobol64 family; ``random_bits`` then returns a
    planar (hi, lo) pair of uint32 tensors (``random_bits64`` gives host
    uint64 words directly). Tensors land on ``device``, by default the card.
    """

    def __init__(self, dimensions: int = 1, scrambled: bool = False,
                 seed: int = 0, bits: int = 32, device=None):
        check(bits in (32, 64), "sobol bits must be 32 or 64")
        self.dim = int(dimensions)
        self.bits = bits
        self.offset = 0
        self.scrambled = scrambled
        self.device = _on(device)
        self._vnp = _direction_numbers(self.dim, bits)
        if scrambled:
            rs = np.random.RandomState(seed or 1)
            hi = rs.randint(0, 2**32, size=self.dim, dtype=np.uint64)
            lo = rs.randint(0, 2**32, size=self.dim, dtype=np.uint64)
            self._shift_np = hi << np.uint64(32) | lo if bits == 64 else lo
        else:
            self._shift_np = np.zeros(self.dim, np.uint64)

    def set_offset(self, offset: int):
        self.offset = int(offset)
        return self

    def random_bits64(self, count: int) -> np.ndarray:
        """(count, dim) host uint64 Sobol words (64-bit family only)."""
        check(self.bits == 64, "random_bits64 requires bits=64")
        w = _sobol_words(self._vnp, self.offset, count, 64)
        self.offset += count
        return w ^ self._shift_np[None, :]

    def random_bits(self, count: int):
        """32-bit family: (count, dim) uint32 tensor.
        64-bit family: planar (hi, lo) uint32 pair."""
        if self.bits == 64:
            w = self.random_bits64(count)
            return tuple(dist.as_uint32(torch.from_numpy(h.astype(np.int64)).to(self.device))
                         for h in (w >> np.uint64(32), w & np.uint64(0xFFFFFFFF)))
        idx = torch.arange(1, count + 1, dtype=torch.int64, device=self.device) + self.offset
        self.offset += count
        # x_n = XOR of v_k where bit k is set in gray(n)
        gray = idx ^ (idx >> 1)
        v = torch.from_numpy(self._vnp.astype(np.int64)).to(self.device)   # (dim, 32)
        x = torch.zeros((count, self.dim), dtype=torch.int64, device=self.device)
        for k in range(32):
            x ^= ((gray >> k) & 1)[:, None] * v[None, :, k]
        shift = torch.from_numpy((self._shift_np & np.uint64(0xFFFFFFFF)).astype(np.int64))
        return dist.as_uint32(x ^ shift.to(self.device)[None, :])

    def uniform(self, count: int, dtype=torch.float32):
        if self.bits == 64:
            # f32 holds 24 mantissa bits — the top 32-bit word carries all
            # the precision the output dtype can represent
            hi, _ = self.random_bits(count)
            return dist.bits_to_uniform(hi, dtype)
        return dist.bits_to_uniform(self.random_bits(count), dtype)

    def normal(self, count: int, mean=0.0, stddev=1.0):
        """Inverse-CDF mapping in float64 (quasi-random sequences must not
        use Box–Muller pairing — dimension structure matters)."""
        u = self.uniform(count, torch.float64)
        z = torch.special.ndtri(torch.clamp(u, 1e-12, 1 - 1e-12))
        return (mean + stddev * z).to(torch.float32)

    def lognormal(self, count: int, mean=0.0, stddev=1.0):
        return torch.exp(self.normal(count, mean, stddev))
