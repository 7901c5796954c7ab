"""Entry points of the port (counterparts of ``__graft_entry__``):
``entry``, the fused bias+GELU bf16 GEMM through the repository's own
kernel, and ``dryrun_multichip``, the TP-MLP cycle over a grid of ranks."""

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


def dryrun_multichip(n_ranks: int = 4, devices=None, *, s: int | None = None, h: int = 16,
                     f: int | None = None, seed: int = 0) -> dict:
    """One distributed step over ``n_ranks`` ranks (counterpart of the TP
    part of ``__graft_entry__.dryrun_multichip``): the TP-MLP cycle
    (AllGather+GEMM on B1 with the GELU epilogue fused, then GEMM+ReduceScatter)
    and a gemr2d reshard, checked against a single-device float64 product
    at rtol 1e-4, max-scaled (tests/test_mp_matmul.py's bound).

    ``devices`` defaults to ``n_ranks`` ranks on the card (``cuda:0``); the
    sizes to the reference's s = f = 8 · n_ranks, h = 16. x (s, h), w1
    (h, f) and w2 (f, h) are normal f32, scaled by 1/sqrt(fan-in), drawn
    from ``seed`` on rank 0's device. Returns the output, the reshard, the
    max-scaled error and the inputs."""
    from tpumathlib_torch.core.check import max_scaled_err
    from tpumathlib_torch.dx.gemm import apply_epilogue
    from tpumathlib_torch.mp import Grid, tp_matmul
    from tpumathlib_torch.mp.matmul import gemr2d

    if devices is None:
        devices = [torch.device("cuda", 0)] * n_ranks
    grid = Grid.create(devices)
    s, f = s or 8 * grid.size, f or 8 * grid.size
    gen = torch.Generator(device=grid.devices[0]).manual_seed(seed)
    x = torch.randn((s, h), generator=gen, device=grid.devices[0])
    w1 = torch.randn((h, f), generator=gen, device=grid.devices[0]) / h ** 0.5
    w2 = torch.randn((f, h), generator=gen, device=grid.devices[0]) / f ** 0.5
    out = tp_matmul(grid.shard(x, ("x", None)), grid.shard(w1, (None, "x")),
                    grid.shard(w2, ("x", None)), grid, epilogue="gelu", use_pallas=True)
    if out.shape != (s, h) or out.spec != ("x", None):
        raise AssertionError(f"tp_matmul gave {out.shape} {out.spec}")
    y = gemr2d(out, grid.sharding((None, "x")))   # the resharding collective
    want = apply_epilogue(x.double() @ w1.double(), "gelu")[0] @ w2.double()
    err = max(max_scaled_err(out.full(), want), max_scaled_err(y.full(), want))
    if not err <= 1e-4:
        raise AssertionError(f"tp_matmul + gemr2d: max-scaled error {err:.3e} > 1e-4")
    return {"out": out, "resharded": y, "max_scaled_err": err, "inputs": (x, w1, w2)}
