"""The GEMM slice end to end in both packages, and the port's import rule.

- The Lt ``Algo("pallas")`` gelu+bias path and the entry point's function at
  256³ bf16 give the same result in both packages (bf16 output: 1e-2
  max-scaled, one output ulp).
- Importing tpumathlib_torch and every submodule pulls in neither jax nor
  tpumathlib (checked in a fresh interpreter).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from tpumathlib.blas import lt as ref_lt
from tpumathlib_torch.core import device as core_device
from tpumathlib_torch.blas import lt
from tpumathlib_torch.core.check import max_scaled_err
from tpumathlib_torch.core.interop import from_numpy, from_reference
from tpumathlib_torch.entry import entry

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_arrays_on_the_cpu(monkeypatch):
    """The port's default device is the card (core.device.default_device);
    these tests turn host arrays into containers on the CPU."""
    monkeypatch.setattr(core_device, "default_device", lambda: torch.device("cpu"))


S = 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(rng):
    a = rng.normal(size=(S, S)).astype(np.float32).astype(ml_dtypes.bfloat16)
    b = rng.normal(size=(S, S)).astype(np.float32).astype(ml_dtypes.bfloat16)
    bias = rng.normal(size=(S,)).astype(np.float32)
    return a, b, bias


def test_lt_pallas_gelu_bias_slice(rng):
    a, b, bias = _inputs(rng)
    rdesc = ref_lt.MatmulDesc(epilogue=ref_lt.Epilogue.GELU_BIAS)
    want = ref_lt.matmul(rdesc, jnp.asarray(a), jnp.asarray(b), bias=jnp.asarray(bias),
                         algo=ref_lt.Algo("pallas"), out_dtype=jnp.bfloat16)
    got = lt.matmul(from_reference(rdesc), from_numpy(a), from_numpy(b),
                    bias=from_numpy(bias), algo=from_reference(ref_lt.Algo("pallas")),
                    out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (S, S)
    assert max_scaled_err(got, np.asarray(want).astype(np.float64)) <= 1e-2


def test_entry_function_slice(rng, monkeypatch):
    # the reference entry() would point JAX's compilation cache outside the repo
    monkeypatch.setattr(graft, "_persistent_cache", lambda: None)
    ref_fwd, _ = graft.entry()
    fwd, (pa, pb, pbias) = entry(torch.device("cpu"), S, S, S, seed=0)
    assert (pa.shape, pb.shape, pbias.shape) == ((S, S), (S, S), (S,))
    assert (pa.dtype, pbias.dtype) == (torch.bfloat16, torch.float32)
    a, b, bias = _inputs(rng)
    want = np.asarray(ref_fwd(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias)))
    got = fwd(from_numpy(a), from_numpy(b), from_numpy(bias))
    assert got.dtype == torch.bfloat16 and got.shape == (S, S)
    assert max_scaled_err(got, want.astype(np.float64)) <= 1e-2
    # the same seed draws the same operands
    again = entry(torch.device("cpu"), S, S, S, seed=0)[1]
    assert all(torch.equal(x, y) for x, y in zip((pa, pb, pbias), again))


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpumathlib_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tpumathlib_torch.__path__,"
        " 'tpumathlib_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpumathlib'))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
