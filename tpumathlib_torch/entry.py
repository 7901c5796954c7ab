"""Entry point of the port's main path (counterpart of
``__graft_entry__.entry``): the fused bias+GELU bf16 GEMM through the
repository's own kernel."""

from __future__ import annotations

import torch

from tpumathlib_torch.dx.gemm import pallas_matmul


def entry(device: torch.device, m: int = 512, n: int = 512, k: int = 512, seed: int = 0):
    """(fn, args): ``fn(*args)`` is the bf16 matmul with the bias+GELU
    epilogue fused, on (m, k) @ (k, n) normal operands and an (n,) f32 bias
    drawn on ``device`` from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device=device).to(torch.bfloat16)
    bias = torch.randn((n,), generator=gen, device=device)

    def fwd(a, b, bias):
        return pallas_matmul(a, b, bias=bias, epilogue="gelu_bias",
                             out_dtype=torch.bfloat16)

    return fwd, (a, b, bias)
