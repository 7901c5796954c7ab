"""Parity of tpumathlib_torch.rand with tpumathlib.rand, bit for bit.

Every family's words equal the reference's at the same seed and offset:
Philox (with the Random123 known answers and offsets 0, 13 and 3, mid-block),
threefry (JAX's own stream), xorwow, MRG32k3a, MT19937 (also against
numpy's RandomState), MTGP32 with 8 streams, Sobol 32 and 64, plain and
scrambled, at 1, 2 and 50 dimensions. ``uniform`` is equal bit for bit; the
Box–Muller normal and lognormal within 1e-6 of the largest value (torch's
and XLA's float32 log, cos and sin differ in the last bits: measured 9.5e-7
absolute at stddev 2 over 20000 values, elementwise up to 2.8e-4 relative
next to the zeros of cos and sin); the Poisson counts are equal, at λ = 8
(the product of uniforms) and λ = 200 (the normal approximation), with any
mismatch reported with its share. The reference runs as tests/test_rand.py
runs it, with float64 on (tests/conftest.py). Also the reference's own
statistical checks run on the port, the checks' messages, the carrying of a
reference generator through ``from_reference``, and the default device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from tpumathlib import rand as ref
from tpumathlib.core.errors import InvalidValueError as RefInvalidValueError
from tpumathlib_torch import rand as port
from tpumathlib_torch.core import device as core_device
from tpumathlib_torch.core.errors import InvalidValueError
from tpumathlib_torch.core.interop import from_reference

torch.set_num_threads(1)

CPU = "cpu"
FAMILIES = ["PhiloxGenerator", "ThreefryGenerator", "XorwowGenerator",
            "Mrg32k3aGenerator", "Mt19937Generator"]


def _np32(t: torch.Tensor) -> np.ndarray:
    """A uint32 tensor as a numpy uint32 array (through its int32 bits)."""
    return t.view(torch.int32).numpy().view(np.uint32)


def _port(name, seed, **kw):
    return getattr(port, name)(seed, device=CPU, **kw)


def test_philox_known_answer():
    """Random123 KAT vectors for philox4x32-10 (tests/test_rand.py:23-34)."""
    out = port.philox4x32_10(torch.zeros((1, 4), dtype=torch.int64),
                             torch.zeros((1, 2), dtype=torch.int64))
    assert [hex(int(v)) for v in _np32(out)[0]] == [
        "0x6627e8d5", "0xe169c58d", "0xbc57ac4c", "0x9b00dbd8"]
    ones = torch.full((1, 4), -1, dtype=torch.int32).view(torch.uint32)
    out = port.philox4x32_10(ones, ones[:, :2])
    assert out.dtype == torch.uint32
    assert [hex(int(v)) for v in _np32(out)[0]] == [
        "0x408f276d", "0x41c83b0e", "0xa20bc7c6", "0x6d5451fd"]


@pytest.mark.parametrize("seed, offset, count", [(42, 0, 64), (42, 13, 20), (7, 3, 9),
                                                 (-1, 5, 100), (2**33 + 5, 0, 17)])
def test_philox_bits(seed, offset, count):
    want = np.asarray(ref.PhiloxGenerator(seed).set_offset(offset).random_bits(count))
    gen = _port("PhiloxGenerator", seed).set_offset(offset)
    np.testing.assert_array_equal(_np32(gen.random_bits(count)), want)
    assert gen.offset == offset + count


@pytest.mark.parametrize("name", FAMILIES[1:])
@pytest.mark.parametrize("seed, offset, count", [(7, 0, 300), (12345, 13, 70000), (0, 3, 9)])
def test_generator_bits(name, seed, offset, count):
    """threefry (the 70000 words cross a block of 65536), xorwow, MRG32k3a
    and MT19937, offsets as skip-ahead."""
    want = np.asarray(getattr(ref, name)(seed).set_offset(offset).random_bits(count))
    got = _port(name, seed).set_offset(offset).random_bits(count)
    assert got.dtype == torch.uint32 and got.shape == (count,)
    np.testing.assert_array_equal(_np32(got), want)


def test_generator_bits_draw_on():
    """Consecutive draws continue the stream, as the reference's do."""
    for name in FAMILIES:
        r, p = getattr(ref, name)(5), _port(name, 5)
        for count in (10, 7, 33):
            np.testing.assert_array_equal(_np32(p.random_bits(count)),
                                          np.asarray(r.random_bits(count)))


def test_mtgp32_bits():
    for offset, count in ((0, 624 * 8), (1000, 20000)):
        want = np.asarray(ref.Mtgp32Generator(seed=7, nstreams=8).set_offset(offset)
                          .random_bits(count))
        got = port.Mtgp32Generator(seed=7, nstreams=8, device=CPU).set_offset(offset)
        np.testing.assert_array_equal(_np32(got.random_bits(count)), want)


def test_mt19937_equals_numpy_randomstate():
    """tests/test_rand.py:150-164 on the port."""
    want = np.random.RandomState(1234).randint(0, 2**32, size=1500, dtype=np.uint64)
    got = _port("Mt19937Generator", 1234).random_bits(1500)
    np.testing.assert_array_equal(_np32(got), want.astype(np.uint32))
    g2 = _port("Mt19937Generator", 1234).set_offset(700)
    np.testing.assert_array_equal(_np32(g2.random_bits(100)), want[700:800].astype(np.uint32))


@pytest.mark.parametrize("dim", [1, 2, 50])
@pytest.mark.parametrize("bits, scrambled", [(32, False), (32, True), (64, False), (64, True)])
@pytest.mark.parametrize("offset", [0, -1, 10])
def test_sobol_bits(dim, bits, scrambled, offset):
    r = ref.SobolGenerator(dim, scrambled, seed=99, bits=bits).set_offset(offset)
    p = port.SobolGenerator(dim, scrambled, seed=99, bits=bits, device=CPU).set_offset(offset)
    want, got = r.random_bits(33), p.random_bits(33)
    if bits == 64:
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_np32(g), np.asarray(w))
        np.testing.assert_array_equal(p.random_bits64(5), r.random_bits64(5))
    else:
        assert got.shape == (33, dim)
        np.testing.assert_array_equal(_np32(got), np.asarray(want))
    np.testing.assert_array_equal(p.uniform(40).numpy(), np.asarray(r.uniform(40)))
    np.testing.assert_array_equal(p.normal(40, 1.0, 2.0).numpy(), np.asarray(r.normal(40, 1.0, 2.0)))


def test_sobol_directions_and_table():
    """The direction numbers equal the reference's, from a byte-identical
    copy of its Joe–Kuo table."""
    from pathlib import Path

    import tpumathlib.rand as ref_pkg
    from tpumathlib.rand.sobol import _direction_numbers as ref_dirs
    from tpumathlib_torch.rand.sobol import _direction_numbers

    for name in ("_joekuo.npz",):
        assert (Path(port.__file__).parent / name).read_bytes() == \
            (Path(ref_pkg.__file__).parent / name).read_bytes()
    for bits in (32, 64):
        np.testing.assert_array_equal(_direction_numbers(200, bits), ref_dirs(200, bits))


def test_sobol_checks():
    for kw, msg in ((dict(dimensions=0), "sobol supports 1..21201 dimensions"),
                    (dict(bits=16), "sobol bits must be 32 or 64")):
        with pytest.raises(RefInvalidValueError, match=msg):
            ref.SobolGenerator(**kw)
        with pytest.raises(InvalidValueError, match=msg):
            port.SobolGenerator(device=CPU, **kw)
    with pytest.raises(InvalidValueError, match="random_bits64 requires bits=64"):
        port.SobolGenerator(2, device=CPU).random_bits64(4)


@pytest.mark.parametrize("name", FAMILIES + ["Mtgp32Generator"])
def test_uniform_bitwise(name):
    r, p = getattr(ref, name)(11), _port(name, 11)
    got = p.uniform(5000)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(r.uniform(5000)))
    np.testing.assert_array_equal(p.uniform(100, torch.float64).numpy(),
                                  np.asarray(r.uniform(100, jnp.float64)))


@pytest.mark.parametrize("seed", [3, 5])
def test_normal_lognormal(seed):
    for fn, args in (("normal", (20000, 1.0, 2.0)), ("lognormal", (20000, 0.0, 0.5))):
        want = np.asarray(getattr(ref.PhiloxGenerator(seed), fn)(*args))
        got = getattr(_port("PhiloxGenerator", seed), fn)(*args).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("lam, seed", [(8.0, 9), (200.0, 11)])
def test_poisson_counts(lam, seed):
    want = np.asarray(ref.PhiloxGenerator(seed).poisson(8000, lam))
    got = _port("PhiloxGenerator", seed).poisson(8000, lam).numpy()
    assert got.dtype == np.int32
    share = float((got != want).mean())
    assert share == 0.0, f"{share:.2%} of the counts differ"


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_statistics(name):
    """tests/test_rand.py's statistical checks on the port's uniforms."""
    u = _port(name, 7 if name != "Mrg32k3aGenerator" else 12345).uniform(20000).numpy()
    assert 0.0 < u.min() and u.max() <= 1.0
    assert abs(u.mean() - 0.5) < 0.02
    assert abs(u.var() - 1 / 12) < 0.005
    assert scipy.stats.kstest(u[:5000], "uniform").pvalue > 1e-4


def test_reference_sobol_statistics():
    """tests/test_rand.py:83-100 on the port."""
    u = port.SobolGenerator(dimensions=2, device=CPU).uniform(1024).numpy()
    assert u.shape == (1024, 2) and abs(u[0, 0] - 0.5) < 1e-6
    assert abs(u[:, 0].mean() - 0.5) < 2e-3 and abs(u[:, 1].mean() - 0.5) < 2e-3
    assert np.all(np.histogram(u[:, 0], bins=16, range=(0, 1))[0] == 64)
    n = port.SobolGenerator(dimensions=1, device=CPU).normal(2048).numpy()
    assert abs(n.mean()) < 0.02 and abs(n.std() - 1) < 0.05


def test_from_reference_carries_generators(monkeypatch):
    """A reference generator part-way through its stream becomes the port's,
    which draws the same next words."""
    monkeypatch.setattr(core_device, "default_device", lambda: torch.device(CPU))
    gens = [getattr(ref, name)(5) for name in FAMILIES] + [
        ref.Mtgp32Generator(2, nstreams=4), ref.SobolGenerator(3, True, seed=9),
        ref.SobolGenerator(2, True, seed=9, bits=64)]
    for g in gens:
        g.random_bits(37)
        carried = from_reference(g)
        assert type(carried).__name__ == type(g).__name__ and carried.offset == 37
        want, got = g.random_bits(20), carried.random_bits(20)
        for w, c in zip(*((want, got) if isinstance(want, tuple) else ((want,), (got,)))):
            np.testing.assert_array_equal(_np32(c), np.asarray(w))


def test_generators_default_to_the_card():
    """No device given: the card. On a torch without CUDA, drawing raises
    instead of landing on the CPU."""
    for gen in (port.PhiloxGenerator(1), port.Mt19937Generator(1), port.SobolGenerator(2)):
        assert gen.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            port.PhiloxGenerator(1).random_bits(8)
