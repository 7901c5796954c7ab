"""In-kernel random number generation (≙ cuRANDDx: the generator runs inside
the kernel that uses its numbers): kernels B10a and B10b.

Counterpart of ``tpumathlib/dx/rng.py``. The TPU kernels seed the TPU's own
PRNG, whose bits no card reproduces. The port's stream is Philox4x32-10, the
generator of cuRAND and cuRANDDx, drawn exactly as ``rand.PhiloxGenerator(seed)``
draws it: word w of the flat output is word w % 4 of Philox block w // 4,
keyed by the seed's low and high words. The words are mapped to uniforms as
the TPU kernel maps its bits (``_uniform_from_bits``): ((w & 0xFFFFFF) + 1)
· 2⁻²⁴, exact in f32, on (0, 1].

The contract between the two functions, which the TPU kernels keep too (the
same seed and shape draw the same bits): for any a, b, seed and rate, the
mask of ``dropout_matmul_kernel(a, b, seed, rate)`` is exactly
``random_uniform_kernel(seed, (m, n)) > rate``.

Both kernels are in ``csrc/dx_rng.cu``. On CPU tensors (or ``device="cpu"``)
the wrappers take the plain versions, ``_random_uniform_plain`` and
``_dropout_matmul_plain``; on the card they launch the kernels or raise.
``_random_uniform.launches`` and ``_dropout_matmul.launches`` count the
launches.
"""

from __future__ import annotations

import math

import torch

from tpumathlib_torch.core import device as _device
from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda
from tpumathlib_torch.fft.kernels import _mm
from tpumathlib_torch.rand.generators import philox_words

F32 = torch.float32
_MASK = 0xFFFFFFFF
# operand dtype codes of tml_dropout_matmul; other dtypes are cast to f32,
# which holds their values exactly
_AB_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _uniform_from_words(w: torch.Tensor) -> torch.Tensor:
    """int64 words → ((w & 0xFFFFFF) + 1) · 2⁻²⁴ in f32 (exact), on (0, 1]."""
    return ((w & 0xFFFFFF) + 1).to(F32) * (1.0 / 16777216.0)


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _random_uniform_plain(seed: int, shape: tuple, device) -> torch.Tensor:
    """B10a's plain version: the Philox words of ``rand.PhiloxGenerator(seed)``
    under the 24-bit map, in torch."""
    return _uniform_from_words(philox_words(seed, 0, math.prod(shape), device)).reshape(shape)


def _random_uniform(seed: int, shape: tuple, device: torch.device) -> torch.Tensor:
    """B10a through ``tml_random_uniform``: f32 of ``shape`` on ``device``."""
    if not _on_card(device):
        return _random_uniform_plain(seed, shape, device)
    out = torch.empty(shape, dtype=F32, device=device)
    if out.numel():
        lib = cuda_utils.load_kernels()
        with torch.cuda.device(device):
            rc = lib.tml_random_uniform(out.data_ptr(), out.numel(), seed & _MASK,
                                        (seed >> 32) & _MASK,
                                        torch.cuda.current_stream(device).cuda_stream)
        cuda_utils.check_launch(lib, rc, "tml_random_uniform")
        _random_uniform.launches += 1
    return out


_random_uniform.launches = 0


def random_uniform_kernel(seed, shape: tuple, *, device=None):
    """Uniforms on (0, 1], generated entirely in one kernel (≙ cuRANDDx
    thread API sample: seed → generate → use). ``device`` defaults to the
    card."""
    shape = (shape,) if isinstance(shape, int) else tuple(int(d) for d in shape)
    device = torch.device(device) if device is not None else _device.default_device()
    return _random_uniform(int(seed), shape, device)


def _dropout_matmul_plain(a, b, seed: int, rate: float) -> torch.Tensor:
    """B10b's plain version: the product in f32 (TF32 off), then the plain
    uniforms' mask over the (m, n) output."""
    acc = _mm(a.to(F32), b.to(F32))
    u = _random_uniform_plain(seed, tuple(acc.shape), acc.device)
    return torch.where(u > rate, acc / (1.0 - rate), 0.0)


def _dropout_matmul(a, b, seed: int, rate: float) -> torch.Tensor:
    """B10b through ``tml_dropout_matmul``: (m, n) f32."""
    if not on_cuda(a, b):
        return _dropout_matmul_plain(a, b, seed, rate)
    check(a.device == b.device, "A and B on one device")
    if not (a.dtype == b.dtype and a.dtype in _AB_CODE):
        a, b = a.to(F32), b.to(F32)
    a, b = a.contiguous(), b.contiguous()
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=F32, device=a.device)
    if m and n:
        lib = cuda_utils.load_kernels()
        with torch.cuda.device(a.device):
            rc = lib.tml_dropout_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
                                        seed & _MASK, (seed >> 32) & _MASK, rate, 1.0 - rate,
                                        _AB_CODE[a.dtype],
                                        torch.cuda.current_stream(a.device).cuda_stream)
        cuda_utils.check_launch(lib, rc, "tml_dropout_matmul")
        _dropout_matmul.launches += 1
    return out


_dropout_matmul.launches = 0


def dropout_matmul_kernel(a, b, seed, rate: float = 0.1):
    """Matmul with the dropout noise drawn inside the same kernel (the
    cuRANDDx use case: a stochastic op without a mask in device memory):
    where(u > rate, (a @ b) / (1 − rate), 0), the product summed in f32, so
    the output is f32 (m, n) for f32 or bf16 operands. u is
    ``random_uniform_kernel(seed, (m, n))``."""
    check(a.ndim == 2 and b.ndim == 2, "dropout_matmul_kernel takes 2-D operands")
    check(a.shape[1] == b.shape[0], "inner dims must match")
    return _dropout_matmul(a, b, int(seed), float(rate))
