"""rand — the cuRAND capability surface (counterpart of ``tpumathlib.rand``).

Generator families, each bit for bit equal to the reference's:
- philox:   exact Philox4x32-10, counter-based, computed on the device
            (bitwise-verified against the Random123 known-answer vectors);
            the stream of the in-kernel generator of ``dx.rng``
- threefry: JAX's threefry2x32 as ``jax.random`` draws it, with cuRAND
            seed/offset/ordering semantics
- xorwow / mrg32k3a: the exact sequential recurrences, run on the host and
            copied to the device (offset = skip-ahead)
- mt19937:  Mersenne Twister twisting on the device, bit-exact vs NumPy's
            RandomState
- mtgp32:   N independent MT19937 streams twisted together, block-
            interleaved output
- sobol32/sobol64 (+scrambled): quasi-random with the Joe–Kuo
            new-joe-kuo-6.21201 direction vectors, Gray-code generation,
            digital-shift scrambling (64-bit words as planar (hi, lo) uint32
            pairs)

Distributions: uniform, normal (Box–Muller), lognormal, poisson — transforms
over raw words from any generator (≙ curandGenerateUniform/Normal/LogNormal/
Poisson). Generators take ``device=``; the default is the card.
"""

from tpumathlib_torch.rand.generators import (  # noqa: F401
    PhiloxGenerator,
    ThreefryGenerator,
    XorwowGenerator,
    Mrg32k3aGenerator,
    Mt19937Generator,
    Mtgp32Generator,
    philox4x32_10,
)
from tpumathlib_torch.rand.distributions import (  # noqa: F401
    bits_to_uniform,
    bits_to_normal,
    bits_to_lognormal,
    bits_to_poisson,
)
from tpumathlib_torch.rand.sobol import SobolGenerator  # noqa: F401
