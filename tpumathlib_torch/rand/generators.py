"""PRNG generator families with cuRAND seed/offset semantics.

Counterpart of ``tpumathlib/rand/generators.py``, bit for bit. Every
generator exposes:
  gen = Family(seed, device=None)  ≙ curandCreateGenerator + SetPseudoRandomGeneratorSeed
  gen.set_offset(n)                ≙ curandSetGeneratorOffset (skip-ahead)
  gen.random_bits(count)           → torch.uint32 tensor (advances the offset)
  gen.uniform/normal/lognormal/poisson(count, ...) — distribution wrappers

The words land on ``device``; ``None`` is the port's default, the card
(``core.device.default_device()``). torch cannot shift or add ``uint32``, so
the arithmetic runs in int64 holding 32-bit values, masked after each
operation that can carry past bit 31; a product of two words is formed from
16-bit halves, since the full product reaches 2⁶⁴ and would overflow int64.

- Philox4x32-10 and threefry2x32 are counter-based: every word is computed
  on the device from its index, in O(1) skip-ahead.
- MT19937 and MTGP32 twist on the device (the reference's three-pass
  vectorised twist); only their seeding runs on the host.
- xorwow and MRG32k3a are sequential recurrences of one word a step. The
  reference scans them step by step on its device; here the recurrence runs
  on the host in exact integer arithmetic and the words are copied to the
  device once, since a device loop of one small launch a step would take
  seconds. Neither family has a kernel in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from tpumathlib_torch.core import device as _device
from tpumathlib_torch.rand import distributions as dist

_MASK = 0xFFFFFFFF
I64 = torch.int64


def _on(device) -> torch.device:
    return torch.device(device) if device is not None else _device.default_device()


# ---------------- Philox4x32-10 (exact, Random123-compatible) ----------------

_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) words of the 64-bit product of the word ``a`` and the words
    ``b`` (int64 in [0, 2³²)), from b's 16-bit halves: each partial product
    is below 2⁴⁸."""
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + p0) & _MASK
    return hi, lo


def _philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 words; the keys may be ints or tensors."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK
        k1 = (k1 + _PHILOX_W1) & _MASK
    return c0, c1, c2, c3


def philox4x32_10(ctr, key):
    """One Philox4x32-10 block: ctr (..., 4), key (..., 2) integer tensors
    (uint32, or int64 holding 32-bit words) → (..., 4) uint32. Bitwise-exact
    vs the Random123 reference."""
    c, k = dist.words(ctr), dist.words(key)
    out = _philox(c[..., 0], c[..., 1], c[..., 2], c[..., 3], k[..., 0], k[..., 1])
    return dist.as_uint32(torch.stack(out, dim=-1))


def philox_words(seed: int, start: int, count: int, device) -> torch.Tensor:
    """Words [start, start + count) of the Philox stream of ``seed`` as int64:
    word w is word w % 4 of the block with counter (w // 4 low word, high
    word, 0, 0) and key (seed low word, seed high word)."""
    first = start // 4
    nblk = -(-(start % 4 + count) // 4)
    blk = first + torch.arange(nblk, dtype=I64, device=device)
    zero = torch.zeros_like(blk)
    out = _philox(blk & _MASK, (blk >> 32) & _MASK, zero, zero,
                  seed & _MASK, (seed >> 32) & _MASK)
    flat = torch.stack(out, dim=-1).reshape(-1)
    return flat[start % 4:start % 4 + count]


class _GeneratorBase:
    def __init__(self, seed: int = 0, device=None):
        self.seed = int(seed)
        self.offset = 0
        self.device = _on(device)

    def set_offset(self, offset: int):
        """≙ curandSetGeneratorOffset."""
        self.offset = int(offset)
        return self

    # distribution wrappers (≙ curandGenerateUniform/Normal/...)
    def uniform(self, count: int, dtype=torch.float32):
        return dist.bits_to_uniform(self.random_bits(count), dtype)

    def normal(self, count: int, mean=0.0, stddev=1.0):
        return dist.bits_to_normal(self.random_bits(2 * count), mean, stddev)[:count]

    def lognormal(self, count: int, mean=0.0, stddev=1.0):
        return dist.bits_to_lognormal(self.random_bits(2 * count), mean, stddev)[:count]

    def poisson(self, count: int, lam: float):
        return dist.bits_to_poisson(self.random_bits(4 * count).reshape(count, 4), lam)


class PhiloxGenerator(_GeneratorBase):
    """≙ CURAND_RNG_PSEUDO_PHILOX4_32_10. The offset counts 32-bit outputs;
    each counter block yields 4."""

    def random_bits(self, count: int):
        start = self.offset
        self.offset += count
        return dist.as_uint32(philox_words(self.seed, start, count, self.device))


# ---------------- threefry2x32, as JAX draws it ----------------

_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def _threefry2x32(k1, k2, x0, x1):
    """JAX's threefry2x32 hash (jax/_src/prng.py, ``_threefry2x32_lowering``)
    on int64 words: 20 rounds in five groups of four, a key injection after
    each group."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for g in range(5):
        for r in _THREEFRY_ROT[g % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _MASK
    return x0, x1


class ThreefryGenerator(_GeneratorBase):
    """≙ CURAND_RNG_PSEUDO_THREEFRY-class: the words of JAX's
    ``jax.random.bits(jax.random.fold_in(jax.random.key(seed), b), (65536,),
    uint32)`` for block b = word index // 65536, under
    ``jax_threefry_partitionable`` (the default) and 64-bit seeds: the key is
    (seed >> 32, seed & 0xFFFFFFFF); fold_in hashes the counter pair (0, b)
    into the block's key; word i of a block is the XOR of the hash of the
    counter pair (0, i)."""

    _BLK = 1 << 16

    def random_bits(self, count: int):
        start = self.offset
        self.offset += count
        first = start // self._BLK
        blocks = torch.arange(first, (start + max(count, 1) - 1) // self._BLK + 1, dtype=I64)
        sk1, sk2 = _threefry2x32((self.seed >> 32) & _MASK, self.seed & _MASK,
                                 torch.zeros_like(blocks), blocks & _MASK)
        idx = start + torch.arange(count, dtype=I64, device=self.device)
        sel = idx // self._BLK - first
        w = idx % self._BLK
        b1, b2 = _threefry2x32(sk1.to(self.device)[sel], sk2.to(self.device)[sel],
                               torch.zeros_like(w), w)
        return dist.as_uint32(b1 ^ b2)


# ---------------- the sequential recurrences, on the host ----------------

class XorwowGenerator(_GeneratorBase):
    """≙ CURAND_RNG_PSEUDO_XORWOW — the exact xorwow recurrence, run on the
    host (one word a step) and copied to the device once."""

    def _init_state(self):
        # cuRAND-style seeding: splitmix-ish fill from the seed
        st = []
        x = int(self.seed if self.seed else 1)
        for _ in range(5):
            x = ((x ^ (x >> 12)) * 25214903917 + 11) & 0xFFFFFFFFFFFFFFFF
            st.append(x & _MASK)
        return st, (6615241 + self.seed % 1000) & _MASK

    def random_bits(self, count: int):
        st, d = self._init_state()
        total = self.offset + count
        out = np.empty(total, np.uint32)
        s0, s1, s2, s3, s4 = st
        for i in range(total):
            t = s0 ^ (s0 >> 2)
            new = (s4 ^ ((s4 << 4) & _MASK) ^ t ^ ((t << 1) & _MASK))
            s0, s1, s2, s3, s4 = s1, s2, s3, s4, new
            d = (d + 362437) & _MASK
            out[i] = (new + d) & _MASK
        self.offset = total
        return torch.from_numpy(out[total - count:].copy()).to(self.device)


class Mrg32k3aGenerator(_GeneratorBase):
    """≙ CURAND_RNG_PSEUDO_MRG32K3A — L'Ecuyer's combined MRG, the exact
    integer recurrence, run on the host (one word a step) and copied to the
    device once."""

    M1 = 4294967087  # 2^32 - 209
    M2 = 4294944443  # 2^32 - 22853

    def random_bits(self, count: int):
        """Bit-source view: the raw combined output z ∈ [1, m1] (the top 209
        uint32 values never occur — negligible for the bit view)."""
        z = self._raw(self.offset + count)[self.offset:]
        self.offset += count
        return z

    def uniform(self, count: int, dtype=torch.float32):
        z = self._raw(self.offset + count)[self.offset:]
        self.offset += count
        # the scalar is rounded to f32 and the product taken in f32, as the
        # reference's jnp.float32(1 / (M1 + 1)) is
        return (dist.words(z).to(torch.float32) * (1.0 / (self.M1 + 1.0))).to(dtype)

    def _raw(self, total: int):
        m1, m2 = self.M1, self.M2
        s10 = s11 = s12 = self.seed % m1 or 12345
        s20 = s21 = s22 = self.seed % m2 or 12345
        out = np.empty(total, np.uint32)
        for i in range(total):
            p1 = (1403580 * s11 - 810728 * s10) % m1
            p2 = (527612 * s22 - 1370589 * s20) % m2
            s10, s11, s12 = s11, s12, p1
            s20, s21, s22 = s21, s22, p2
            z = (p1 - p2) % m1
            out[i] = z if z > 0 else m1
        return torch.from_numpy(out).to(self.device)


# ---------------- Mersenne Twister ----------------

def _mt_init_by_array(key_arr: np.ndarray) -> np.ndarray:
    """MT19937 init_by_array seeding (what numpy RandomState uses for a
    scalar seed) — host-side, O(624)."""
    mt = np.zeros(624, np.uint64)
    mt[0] = 19650218
    for i in range(1, 624):
        mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
    i, j = 1, 0
    for _ in range(max(624, len(key_arr))):
        mt[i] = ((mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1664525))
                 + int(key_arr[j]) + j) & 0xFFFFFFFF
        i += 1
        j += 1
        if i >= 624:
            mt[0] = mt[623]
            i = 1
        if j >= len(key_arr):
            j = 0
    for _ in range(623):
        mt[i] = ((mt[i] ^ ((mt[i - 1] ^ (mt[i - 1] >> 30)) * 1566083941))
                 - i) & 0xFFFFFFFF
        i += 1
        if i >= 624:
            mt[0] = mt[623]
            i = 1
    mt[0] = 0x80000000
    return mt.astype(np.uint32)


def _mt_init_genrand(seed: int) -> np.ndarray:
    """Classic MT19937 scalar seeding (what numpy RandomState uses for a
    plain int seed)."""
    mt = np.zeros(624, np.uint64)
    mt[0] = seed & 0xFFFFFFFF
    for i in range(1, 624):
        mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
    return mt.astype(np.uint32)


_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF


def _mag(y):
    return torch.where((y & 1).bool(), _MATRIX_A, 0)


def _mt19937_blocks(state: torch.Tensor, nblocks: int) -> torch.Tensor:
    """MT19937 on the device: ``nblocks`` twists of the (..., 624) int64
    state, each giving 624 tempered words, (..., nblocks · 624) int64. The
    in-place twist is vectorised as three passes (each reads only results
    of the one before) and the i = 623 wrap."""
    mt, outs = state, []
    for _ in range(nblocks):
        # pass 1: i in [0, 227): src = old mt[i+397]
        y1 = (mt[..., 0:227] & _UPPER) | (mt[..., 1:228] & _LOWER)
        p1 = mt[..., 397:624] ^ (y1 >> 1) ^ _mag(y1)
        # pass 2: i in [227, 454): src = new[i-227] ∈ p1
        y2 = (mt[..., 227:454] & _UPPER) | (mt[..., 228:455] & _LOWER)
        p2 = p1[..., 0:227] ^ (y2 >> 1) ^ _mag(y2)
        # pass 3: i in [454, 623): src = new[i-227] ∈ [227, 396) = p2
        y3 = (mt[..., 454:623] & _UPPER) | (mt[..., 455:624] & _LOWER)
        p3 = p2[..., 0:169] ^ (y3 >> 1) ^ _mag(y3)
        # i = 623 wrap: y from old mt[623], NEW mt[0] = p1[0]
        y4 = (mt[..., 623:624] & _UPPER) | (p1[..., 0:1] & _LOWER)
        p4 = p2[..., 169:170] ^ (y4 >> 1) ^ _mag(y4)
        mt = torch.cat([p1, p2, p3, p4], dim=-1)
        y = mt ^ (mt >> 11)
        y = y ^ ((y << 7) & 0x9D2C5680)
        y = y ^ ((y << 15) & 0xEFC60000)
        outs.append(y ^ (y >> 18))
    return torch.cat(outs, dim=-1)


class Mt19937Generator(_GeneratorBase):
    """≙ CURAND_RNG_PSEUDO_MT19937 — Mersenne Twister twisting on the device,
    bit-exact vs numpy's RandomState (the same init_genrand scalar
    seeding, on the host)."""

    def random_bits(self, count: int):
        state = torch.from_numpy(_mt_init_genrand(self.seed % (2 ** 32)).astype(np.int64))
        total = self.offset + count
        out = _mt19937_blocks(state.to(self.device), -(-total // 624))
        bits = out[self.offset:total]
        self.offset = total
        return dist.as_uint32(bits)


class Mtgp32Generator(_GeneratorBase):
    """≙ CURAND_RNG_PSEUDO_MTGP32 — ``nstreams`` independent MT19937 streams
    (init_by_array keys [seed, stream]) twisted together on the device, the
    output interleaved by blocks of 624 (MTGP's per-block layout)."""

    def __init__(self, seed: int = 0, nstreams: int = 64, device=None):
        super().__init__(seed, device)
        self.nstreams = nstreams

    def random_bits(self, count: int):
        total = self.offset + count
        per = -(-total // (624 * self.nstreams))
        states = np.stack([
            _mt_init_by_array(np.array([self.seed % (2 ** 32), s], np.uint64))
            for s in range(self.nstreams)])
        outs = _mt19937_blocks(torch.from_numpy(states.astype(np.int64)).to(self.device), per)
        flat = outs.reshape(self.nstreams, per, 624).transpose(0, 1).reshape(-1)
        bits = flat[self.offset:total]
        self.offset = total
        return dist.as_uint32(bits)
