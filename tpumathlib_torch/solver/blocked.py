"""The fused 128×128 Cholesky + inverse sweep of the blocked factorizations.

Counterpart of ``tpumathlib/solver/blocked.py::_chol_inv128`` (``:96``).
On CUDA tensors ``_chol_inv128`` launches ``tml_chol_inv_block``
(``csrc/dense_block.cu``); on CPU tensors it takes ``_chol_inv128_plain``,
the same sweep as a torch loop. ``potrf_blocked`` (B4c) is not ported yet.
"""

from __future__ import annotations

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda

_NB = 128


def _check_block(d) -> None:
    check(d.shape == (_NB, _NB) and d.dtype == torch.float32,
          f"a ({_NB}, {_NB}) f32 block, not {tuple(d.shape)} {d.dtype}")


def _chol_inv128_plain(d):
    """(L, W = inv(L)) of an SPD (128, 128) block: the kernel's sweep in torch.

    Step j scales by rs = 1/sqrt(d[j, j]) (NaN for a negative pivot), updates
    the trailing block, and carries the inverse in ``r`` (W[i] = r[i]·rs_i).
    The rows of ``d`` hold L's columns, as the reference's U storage does."""
    d = d.to(torch.float32).clone()
    nb = d.shape[0]
    r = torch.eye(nb, dtype=d.dtype, device=d.device)
    rs = torch.empty(nb, dtype=d.dtype, device=d.device)
    for j in range(nb):
        s = 1.0 / torch.sqrt(d[j, j])
        rs[j] = s
        vc = (d[j + 1:, j] * s)[:, None]
        d[j + 1:, j + 1:] -= vc * (d[j, j + 1:] * s)
        r[j + 1:, :j + 1] -= vc * (r[j, :j + 1] * s)
    return torch.tril(d.T * rs), torch.tril(r * rs[:, None])


def _launch_block(entry: str, a, outs: int, extra=()) -> list:
    """Launch one 128×128 sweep of the kernel library on the current stream:
    ``entry(a, lda, out_1, ld_1, ..., out_outs, ld_outs, *extra, stream)``,
    with fresh (128, 128) f32 outputs, which it returns. Raises on a failed
    build, load or launch."""
    lib = cuda_utils.load_kernels()
    check(a.stride(-1) == 1, "the block needs unit column stride")
    res = [torch.empty((_NB, _NB), dtype=torch.float32, device=a.device) for _ in range(outs)]
    args = [a.data_ptr(), a.stride(0)]
    for t in res:
        args += [t.data_ptr(), t.stride(0)]
    with torch.cuda.device(a.device):
        rc = getattr(lib, entry)(*args, *(t.data_ptr() for t in extra),
                                 torch.cuda.current_stream(a.device).cuda_stream)
    cuda_utils.check_launch(lib, rc, entry)
    return res


def _chol_inv128(d):
    """Fused Cholesky + inverse of a (128, 128) f32 SPD block: (L, inv(L)),
    L lower with its strict upper triangle exactly 0."""
    _check_block(d)
    if not on_cuda(d):
        return _chol_inv128_plain(d)
    l, w = _launch_block("tml_chol_inv_block", d, 2)
    _chol_inv128.launches += 1
    return l, w


_chol_inv128.launches = 0
