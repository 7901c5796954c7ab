"""The fused VV10 pairwise kernels, the nonlocal-correlation hotspot
(≙ the cuEST nonlocal-XC device kernels): kernel B11.

Counterpart of ``tpumathlib/dx/vv10.py``. The pairwise energy core

    E        = β Σ wr_i + ½ Σ_ij wr_i wr_j Φ_ij,   Φ = −3 / (2 g_i g_j (g_i + g_j)),
    g_i      = w0_i r²_ij + κ_i

runs as two kernels in ``csrc/dx_vv10.cu``: ``tml_vv10_fwd`` computes
inner_i = Σ_j wr_j Φ_ij, and ``tml_vv10_bwd`` the five sums of the
hand-derived gradient (the reference's ``_pair_bwd``):

    ∂E/∂wr_k = β + inner_k
    ∂E/∂w0_k = wr_k Σ_j wr_j Φ'ᵍ(k,j) r²_kj                    (s1)
    ∂E/∂κ_k  = wr_k Σ_j wr_j Φ'ᵍ(k,j)                          (s2)
    ∂E/∂x_k  = 2 wr_k Σ_j wr_j [Φ'ᵍ(k,j) w0_k + Φ'ᵍ'(k,j) w0_j](x_k − x_j)

``_PairCore``, a ``torch.autograd.Function``, takes the place of the
reference's ``custom_vjp``: its forward launches the forward sweep and saves
(wr, w0, κ, pts, inner), its backward launches the backward sweep. The ρ →
(wr, w0, κ) channel chain stays in torch autograd, so ``torch.autograd.grad``
through ``vv10_pair_energy_pallas`` gives the gradients in ρ, |∇ρ|², the
points and the weights. The kernels mask j ≥ G as the reference pads (wr = 0,
w0 = κ = 1), so nothing is padded here.

On CPU tensors the wrappers ``_vv10_fwd`` and ``_vv10_bwd`` take the plain
versions (the two kernel bodies in torch over (chunk, G) tiles, in the
inputs' dtype); on the card they launch the kernels (f32) or raise.
``_vv10_fwd.launches`` and ``_vv10_bwd.launches`` count the launches.
"""

from __future__ import annotations

import math

import torch

from tpumathlib_torch.core.errors import check
from tpumathlib_torch.dx import cuda_utils
from tpumathlib_torch.dx.cuda_utils import on_cuda

F32 = torch.float32
_CHUNK = 512   # i-rows a tile of the plain versions


def vv10_beta(b: float) -> float:
    """β = (1/32)(3/b²)^{3/4} — makes E_nl vanish for the uniform gas (the
    port's copy of ``tpumathlib/apps/vv10.py::vv10_beta``)."""
    return (1.0 / 32.0) * (3.0 / (b * b)) ** 0.75


def _pairs(w0, kappa, pts, s: int, e: int):
    """The pair terms of rows s:e against every j: (dx, dy, dz, r², g_i, g_j)."""
    d = [pts[s:e, c, None] - pts[None, :, c] for c in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    gi = w0[s:e, None] * r2 + kappa[s:e, None]
    gj = w0[None, :] * r2 + kappa[None, :]
    return d, r2, gi, gj


def _vv10_fwd_plain(wr, w0, kappa, pts):
    """The forward kernel's sum in torch, as the reference's body writes it
    (the kernel takes one reciprocal a pair instead): inner_i = Σ_j wr_j Φ_ij."""
    g = wr.shape[0]
    inner = torch.empty_like(wr)
    for s in range(0, g, _CHUNK):
        _, _, gi, gj = _pairs(w0, kappa, pts, s, min(s + _CHUNK, g))
        phi = -1.5 / (gi * gj * (gi + gj))
        inner[s:s + _CHUNK] = (phi * wr[None, :]).sum(dim=1)
    return inner


def _vv10_bwd_plain(wr, w0, kappa, pts):
    """The backward kernel's sums in torch, as the reference's body writes
    them (the kernel takes one reciprocal a pair instead): (5, G) of s1, s2,
    sx, sy, sz."""
    g = wr.shape[0]
    out = torch.empty((5, g), dtype=wr.dtype, device=wr.device)
    for s in range(0, g, _CHUNK):
        e = min(s + _CHUNK, g)
        d, r2, gi, gj = _pairs(w0, kappa, pts, s, e)
        gij = gi + gj
        phi = -1.5 / (gi * gj * gij)
        pgi = -phi * (1.0 / gi + 1.0 / gij)
        pgj = -phi * (1.0 / gj + 1.0 / gij)
        wrj = wr[None, :]
        out[0, s:e] = (wrj * pgi * r2).sum(dim=1)
        out[1, s:e] = (wrj * pgi).sum(dim=1)
        tij = wrj * (pgi * w0[s:e, None] + pgj * w0[None, :])
        for c in range(3):
            out[2 + c, s:e] = 2.0 * (tij * d[c]).sum(dim=1)
    return out


def _launch(name: str, out, wr, w0, kappa, pts):
    for t in (wr, w0, kappa, pts):
        check(t.dtype == F32 and t.device == wr.device, "the VV10 kernels take f32 on one device")
    wr, w0, kappa, pts = (t.contiguous() for t in (wr, w0, kappa, pts))
    lib = cuda_utils.load_kernels()
    with torch.cuda.device(wr.device):
        rc = getattr(lib, name)(wr.data_ptr(), w0.data_ptr(), kappa.data_ptr(), pts.data_ptr(),
                                out.data_ptr(), wr.shape[0],
                                torch.cuda.current_stream(wr.device).cuda_stream)
    cuda_utils.check_launch(lib, rc, name)


def _vv10_fwd(wr, w0, kappa, pts):
    """B11's forward sweep through ``tml_vv10_fwd``: inner (G,)."""
    if not on_cuda(wr, w0, kappa, pts):
        return _vv10_fwd_plain(wr, w0, kappa, pts)
    inner = torch.empty(wr.shape, dtype=F32, device=wr.device)
    if wr.shape[0]:
        _launch("tml_vv10_fwd", inner, wr, w0, kappa, pts)
        _vv10_fwd.launches += 1
    return inner


def _vv10_bwd(wr, w0, kappa, pts):
    """B11's backward sweep through ``tml_vv10_bwd``: (5, G) of s1, s2, sx,
    sy, sz."""
    if not on_cuda(wr, w0, kappa, pts):
        return _vv10_bwd_plain(wr, w0, kappa, pts)
    sums = torch.empty((5, wr.shape[0]), dtype=F32, device=wr.device)
    if wr.shape[0]:
        _launch("tml_vv10_bwd", sums, wr, w0, kappa, pts)
        _vv10_bwd.launches += 1
    return sums


_vv10_fwd.launches = 0
_vv10_bwd.launches = 0


class _PairCore(torch.autograd.Function):
    """E = β Σ wr + ½ Σ wr_i wr_j Φ_ij, with the hand-derived backward."""

    @staticmethod
    def forward(ctx, wr, w0, kappa, pts, beta: float):
        inner = _vv10_fwd(wr, w0, kappa, pts)
        ctx.save_for_backward(wr, w0, kappa, pts, inner)
        ctx.beta = beta
        return beta * wr.sum() + 0.5 * (wr * inner).sum()

    @staticmethod
    def backward(ctx, g):
        wr, w0, kappa, pts, inner = ctx.saved_tensors
        s1, s2, sx, sy, sz = _vv10_bwd(wr, w0, kappa, pts)
        dwr = g * (ctx.beta + inner)
        dw0 = g * wr * s1
        dk = g * wr * s2
        dpts = g * (wr[:, None] * torch.stack([sx, sy, sz], dim=1))
        return dwr, dw0, dk, dpts, None


def vv10_pair_energy_pallas(rho, s2, pts, w, b: float, c: float):
    """Drop-in for the reference's ``apps.vv10.vv10_pair_energy``, the
    pairwise sweep in the two kernels. Differentiable in (rho, s2, pts, w):
    the channel chain is torch autograd, the pairwise core ``_PairCore``."""
    good = rho > 1e-9
    rs = torch.where(good, rho, 1.0)
    wg2 = c * (s2 / (rs * rs)) ** 2
    wp2 = (4.0 * math.pi) * rs
    w0 = torch.sqrt(wg2 + wp2 / 3.0)
    kappa = b * (1.5 * math.pi) * (rs / (9.0 * math.pi)) ** (1.0 / 6.0)
    wr = torch.where(good, w * rho, 0.0)
    return _PairCore.apply(wr.to(F32), w0.to(F32), kappa.to(F32), pts.to(F32), vv10_beta(b))
