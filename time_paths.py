#!/usr/bin/env python3
"""Times the port's redesigned paths at the bench's sizes on one CUDA card.

The paths, each through its public function:
- with their products on B1's f32 routes: potrf_onelaunch and
  getrf_onelaunch (B2, B3), geqrf_onelaunch (B4a) and orgqr_onelaunch (B4b,
  on geqrf's output) at n = 4096, solver.blocked.potrf_blocked (B4c, panel
  256) at n = 4096, and dx.rng.dropout_matmul_kernel (B10b) at 4096^3, rate
  0.1, f32 and bf16;
- B1: dx.gemm.pallas_matmul at 4096^3 with the bias + GELU epilogue, bf16
  (the tensor-core route) and f32;
- the Blocked-ELL lines of bench.py: sparse.spmm on a bf16 Blocked-ELL
  (mb = nb = 128, ellw = 16, bs = 128, k = 4096; B6a) with a bf16 B, with
  an f32 B (a mixed pair), and on the same blocks in f32 with an f32 B;
  sparse.spmv on an f32 one (ellw = 32), and on its blocks in bf16 with an
  f32 x (the SpMM route with one column);
- the FFTs at batch 4096 x N 4096: fft.stockham.dif_fft (B5) on f32 planes
  in natural order and on bf16 planes in raw order, fft.kernels.pallas_fft
  (B5b) and fft.pallas_split.pallas_fft2 (B5c);
- the batched solvers of dx.solver (B7a, B7b, B7d, B7f): potrf_batched at
  1024 x 128 and 8192 x 32, posv_batched and gesv_batched at 8192 x 32 with
  4 right-hand sides, getrf_batched at 8192 x 32 (pivoted and not) and 1024
  x 128, geqrf_batched at both, unmqr_batched both ways on geqrf_batched's
  8192 x 32 x 32 factors with 4 columns of C (B7e) and on its 1024 x 128 x
  128 factors with 4 columns of C, and Q·I there (C = I, k = 128), and
  gels_batched at 8192 x 64 x 32 with 4 right-hand sides;
- the Jacobi kernels of dx.solver (B7g, B7h): syevd_batched and
  gesvd_batched at 8192 x 32 (the warp route) and 2048 x 64 (the block
  route);
- the fused kernels of dx (B8c, B9) at chip_smoke.py's phase 25 sizes:
  dx.dx_decompress_dot on 64 Mi int32 packed at bits 8 (524288 rows) against
  W (128, 128), and dx.fused.gemm_fft at (32768, 256, 256) with gelu;
- VV10 (B11) at G = 40960 (chip_smoke.py's inputs): the energy alone
  (dx.vv10.vv10_pair_energy_pallas, the forward sweep) and value plus
  gradient through torch.autograd.grad (both sweeps);
- the Mp rings (B12a, B12b): mp.overlap.matmul_ag_overlapped and
  matmul_rs_overlapped at GPT-J-6B's MLP, 8192 tokens, (8192, 4096) @ (4096,
  16384) and (8192, 16384) @ (16384, 4096) f32, on 4 ranks of the one card,
  timed last: their inputs are made once the other paths' are freed.
Each is timed three ways: CUDA events around one call after a synchronise
(median of 5, as chip_smoke.py's ``_median_ms``), CUDA events around 5
back-to-back calls (median of 3 samples, as its ``_loop_ms``), and the
host clock around 5 calls with no synchronise (the host's enqueue time a
call).

It imports ``tpumathlib_torch`` from ``PYTHONPATH`` (``-P``: not from the
script's own directory), so that two checkouts can be compared on one card
in one run, in turns (a, b, b, a):

    PYTHONPATH=path/to/checkout python3 -P time_paths.py --tree a

``--paths`` names substrings of the paths to time (all when not given),
e.g. ``--paths _batched`` for the batched solvers alone.

Each run prints the card's name and power limit, then one JSON line
{"tree": ..., "package": ..., "card": ..., "smi": {"before", "after"}, "ms":
{path: {"call", "loop", "enqueue"}}}, "smi" holding the card's SM and
memory clocks, temperature and power draw before the first path and after
the last. Build each checkout's kernels first (their build is not
timed): ``python3 -c "from tpumathlib_torch.dx import cuda_utils;
cuda_utils.build_kernels()"`` from its root.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import time

import numpy as np
import torch

import tpumathlib_torch
from tpumathlib_torch import dx, mp, sparse
from tpumathlib_torch.dx import cuda_utils, fused, gemm
from tpumathlib_torch.dx import rng as dxr
from tpumathlib_torch.dx import solver as dxs
from tpumathlib_torch.dx import vv10
from tpumathlib_torch.fft import kernels as fft_kernels
from tpumathlib_torch.fft import pallas_split, stockham
from tpumathlib_torch.mp import overlap
from tpumathlib_torch.solver import blocked, onelaunch

qr = importlib.import_module("tpumathlib_torch.solver.qr_onelaunch")  # the package exports a function of this name

N = 4096
PANEL = 256
SPMM = (128, 128, 16, 128, 4096)   # (mb, nb, ellw, bs, k) of bench_spmm_bell
SPMV = (128, 128, 32, 128)         # (mb, nb, ellw, bs) of bench_spmv_bell
FFT = (4096, 4096)                 # (batch, N) of the bench's FFT lines
BATCHED = ((8192, 32), (1024, 128))   # (batch, n) of the batched solvers' lines
JACOBI = ((8192, 32), (2048, 64))     # (batch, n) of syevd_batched and gesvd_batched
CODEC_N = 64 << 20                    # int32 values of the codec line, packed at bits 8
GEMM_FFT = (32768, 256, 256)          # (m, k, n): chip_smoke.py's GEMM_FFT_MAIN
GELS = (8192, 64, 32, 4)              # (batch, m, n, k): chip_smoke.py's DXE_GELS
VV10 = 40960                          # G: chip_smoke.py's VV10_MAIN
MP = (8192, 4096, 16384)              # (tokens, n_embd, n_inner): chip_smoke.py's MP_MAIN
RANKS = 4                             # the rings' ranks, all on the one card


def _bell(gen, mb, nb, ellw, bs, dtype, dev):
    """A Blocked-ELL with ellw distinct sorted block columns a block row,
    drawn as the bench draws them, and normal blocks."""
    rng = np.random.default_rng(0)
    cols = np.sort(rng.permuted(np.tile(np.arange(nb), (mb, 1)), axis=1)[:, :ellw], axis=1)
    data = torch.randn((mb, ellw, bs, bs), generator=gen, device=dev).to(dtype)
    return sparse.BlockedELL(torch.from_numpy(cols.astype(np.int32)).to(dev), data,
                             (mb * bs, nb * bs), bs)


def _vv10_inputs(dev):
    """chip_smoke.py's ``_vv10_inputs(VV10, dev)``: (rho, s2, pts, w) f32."""
    rs = np.random.default_rng(5)
    rho = rs.uniform(0.01, 0.5, VV10).astype(np.float32)
    rho[::17] = 1e-12
    cols = (rho, rs.uniform(0, 0.1, VV10), rs.normal(size=(VV10, 3)) * 3,
            rs.uniform(0.001, 0.02, VV10))
    return [torch.tensor(np.asarray(c, np.float32), device=dev) for c in cols]


def _vv10_value_and_grad(rho, s2, pts, w):
    """The energy and its four gradients, as one tuple."""
    ts = [t.detach().clone().requires_grad_() for t in (rho, s2, pts, w)]
    e = vv10.vv10_pair_energy_pallas(*ts, 5.9, 0.0093)
    return (e, *torch.autograd.grad(e, ts))


def _vv10_energy(rho, s2, pts, w):
    with torch.no_grad():
        return vv10.vv10_pair_energy_pallas(rho, s2, pts, w, 5.9, 0.0093)


def _paths(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(2024)
    g = torch.randn((N, N), generator=gen, device=dev)
    spd = g @ g.T / N + 4.0 * torch.eye(N, device=dev)
    g = torch.randn((N, N), generator=gen, device=dev)
    dom = g + torch.diag(1.05 * g.abs().sum(dim=1))
    q = torch.randn((N, N), generator=gen, device=dev)
    vr, t = qr.geqrf_onelaunch(q)
    a = torch.randn((N, N), generator=gen, device=dev)
    b = torch.randn((N, N), generator=gen, device=dev)
    ah, bh = a.bfloat16(), b.bfloat16()
    bias = torch.randn((N,), generator=gen, device=dev)
    mb, nb, ellw, bs, k = SPMM
    a_mm = _bell(gen, mb, nb, ellw, bs, torch.bfloat16, dev)
    b_mm = torch.randn((nb * bs, k), generator=gen, device=dev).bfloat16()
    b_f32 = b_mm.float()
    a_f32 = sparse.BlockedELL(a_mm.cols, a_mm.data.float(), a_mm.shape, bs)
    mb, nb, ellw, bs = SPMV
    a_mv = _bell(gen, mb, nb, ellw, bs, torch.float32, dev)
    a_mv_bf16 = sparse.BlockedELL(a_mv.cols, a_mv.data.bfloat16(), a_mv.shape, bs)
    x_mv = torch.randn((nb * bs,), generator=gen, device=dev)
    vv = _vv10_inputs(dev)
    fr, fi = (torch.randn(FFT, generator=gen, device=dev) for _ in range(2))
    hr, hi = fr.bfloat16(), fi.bfloat16()
    batched = {}   # n: (SPD matrices, Gaussian ones)
    for bsz, order in BATCHED:
        m = torch.randn((bsz, order, order), generator=gen, device=dev)
        batched[order] = (m @ m.mT + order * torch.eye(order, device=dev), m)
    rhs = torch.randn((BATCHED[0][0], BATCHED[0][1], 4), generator=gen, device=dev)
    dom32 = batched[32][1] + 32 * torch.eye(32, device=dev)   # no pivoting needed
    qr32, taus32 = dx.geqrf_batched(batched[32][1])
    bg, mg, ng, kg = GELS
    gels_a = torch.randn((bg, mg, ng), generator=gen, device=dev)
    gels_b = torch.randn((bg, mg, kg), generator=gen, device=dev)
    jacobi = []   # (symmetric matrices, Gaussian ones) at each shape of JACOBI
    for bsz, order in JACOBI:
        m = torch.randn((bsz, order, order), generator=gen, device=dev)
        jacobi.append(((m + m.mT) / 2, m))
    walk = torch.cumsum(torch.randint(-60, 61, (CODEC_N,), generator=gen, device=dev), 0)
    packed, leaders = dx.dx_compress(walk.to(torch.int32), bits=8)
    del walk
    w_dot = torch.randn((128, 128), generator=gen, device=dev)
    fm, fk, fn = GEMM_FFT
    a_fft = torch.randn((fm, fk), generator=gen, device=dev)
    b_fft = torch.randn((fk, fn), generator=gen, device=dev)
    bw, nw = BATCHED[1]
    qr128, taus128 = dx.geqrf_batched(batched[128][1])
    c128 = torch.randn((bw, nw, 4), generator=gen, device=dev)
    eye128 = torch.eye(nw, device=dev).repeat(bw, 1, 1)
    return {
        "potrf_onelaunch": lambda: onelaunch.potrf_onelaunch(spd),
        "getrf_onelaunch": lambda: onelaunch.getrf_onelaunch(dom),
        "geqrf_onelaunch": lambda: qr.geqrf_onelaunch(q),
        "orgqr_onelaunch": lambda: qr.orgqr_onelaunch(vr, t),
        "potrf_blocked": lambda: blocked.potrf_blocked(spd, PANEL),
        "dropout_matmul_kernel": lambda: dxr.dropout_matmul_kernel(a, b, 20240601, 0.1),
        "dropout_matmul_kernel_bf16": lambda: dxr.dropout_matmul_kernel(ah, bh, 20240601, 0.1),
        "pallas_matmul_bf16_gelu_bias": lambda: gemm.pallas_matmul(ah, bh, bias=bias,
                                                                   epilogue="gelu_bias"),
        "pallas_matmul_f32_gelu_bias": lambda: gemm.pallas_matmul(a, b, bias=bias,
                                                                  epilogue="gelu_bias"),
        "spmm_bell_bf16": lambda: sparse.spmm(a_mm, b_mm),
        "spmm_bell_f32": lambda: sparse.spmm(a_f32, b_f32),
        "spmm_bell_bf16_f32": lambda: sparse.spmm(a_mm, b_f32),
        "spmv_bell_f32": lambda: sparse.spmv(a_mv, x_mv),
        "spmv_bell_bf16_f32": lambda: sparse.spmv(a_mv_bf16, x_mv),
        "vv10_energy": lambda: _vv10_energy(*vv),
        "vv10_value_and_grad": lambda: _vv10_value_and_grad(*vv),
        "dif_fft_f32_natural": lambda: stockham.dif_fft(fr, fi),
        "dif_fft_bf16_raw": lambda: stockham.dif_fft(hr, hi, reorder=False, halfplanes=True),
        "pallas_fft": lambda: fft_kernels.pallas_fft(fr, fi),
        "pallas_fft2": lambda: pallas_split.pallas_fft2(fr, fi),
        "potrf_batched_1024x128": lambda: dx.potrf_batched(batched[128][0]),
        "potrf_batched_8192x32": lambda: dx.potrf_batched(batched[32][0]),
        "posv_batched_8192x32_k4": lambda: dx.posv_batched(batched[32][0], rhs),
        "getrf_batched_8192x32": lambda: dx.getrf_batched(batched[32][1]),
        "getrf_batched_nopivot_8192x32": lambda: dx.getrf_batched(dom32, pivot=False),
        "gesv_batched_8192x32_k4": lambda: dx.gesv_batched(batched[32][1], rhs),
        "getrf_batched_1024x128": lambda: dx.getrf_batched(batched[128][1]),
        "geqrf_batched_8192x32": lambda: dx.geqrf_batched(batched[32][1]),
        "geqrf_batched_1024x128": lambda: dx.geqrf_batched(batched[128][1]),
        "unmqr_batched_trans_8192x32x32_k4": lambda: dxs.unmqr_batched(qr32, taus32, rhs, True),
        "unmqr_batched_8192x32x32_k4": lambda: dxs.unmqr_batched(qr32, taus32, rhs, False),
        "unmqr_batched_trans_1024x128x128_k4": lambda: dxs.unmqr_batched(qr128, taus128, c128, True),
        "unmqr_batched_1024x128x128_k4": lambda: dxs.unmqr_batched(qr128, taus128, c128, False),
        "unmqr_batched_QI_1024x128x128_k128": lambda: dxs.unmqr_batched(qr128, taus128, eye128,
                                                                        False),
        "gels_batched_8192x64x32_k4": lambda: dxs.gels_batched(gels_a, gels_b),
        "syevd_batched_8192x32": lambda: dxs.syevd_batched(jacobi[0][0]),
        "gesvd_batched_8192x32": lambda: dxs.gesvd_batched(jacobi[0][1]),
        "syevd_batched_2048x64": lambda: dxs.syevd_batched(jacobi[1][0]),
        "gesvd_batched_2048x64": lambda: dxs.gesvd_batched(jacobi[1][1]),
        "dx_decompress_dot_524288x128x128": lambda: dx.dx_decompress_dot(packed, leaders, w_dot,
                                                                         bits=8, scale=0.01),
        "gemm_fft_32768x256x256_gelu": lambda: fused.gemm_fft(a_fft, b_fft, "gelu"),
    }


def _mp_paths(dev) -> dict:
    """The rings' paths. Their inputs (1.5 GB) and the grid's streams are
    made only after ``_paths``' inputs are freed, so no other path is timed
    beside them."""
    gen = torch.Generator(device=dev).manual_seed(2025)
    s, hd, f = MP
    grid = mp.Grid.create([dev] * RANKS)
    xs = grid.shard(torch.randn((s, hd), generator=gen, device=dev), ("x", None))
    w1 = grid.shard(torch.randn((hd, f), generator=gen, device=dev) / hd ** 0.5, (None, "x"))
    hs = grid.shard(torch.randn((s, f), generator=gen, device=dev), (None, "x"))
    w2 = grid.shard(torch.randn((f, hd), generator=gen, device=dev) / f ** 0.5, ("x", None))
    return {
        "matmul_ag_overlapped": lambda: overlap.matmul_ag_overlapped(xs, w1, grid).pieces[0],
        "matmul_rs_overlapped": lambda: overlap.matmul_rs_overlapped(hs, w2, grid).pieces[0],
    }


def _events(fn, calls: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _time(fn) -> dict:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    call = [_events(fn, 1) for _ in range(5)]
    loop = [_events(fn, 5) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    enqueue = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.synchronize()
    return {"call": float(np.median(call)), "loop": float(np.median(loop)), "enqueue": enqueue}


def _clocks() -> str:
    """The card's SM and memory clocks (MHz), temperature (C) and power
    draw (W) now, as nvidia-smi reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
                           "power.draw", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="a label for the checkout, printed back")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="time only the paths whose names hold one of these")
    args = ap.parse_args()

    def wanted(name: str) -> bool:
        return args.paths is None or any(p in name for p in args.paths)

    if not torch.cuda.is_available():
        raise SystemExit("time_paths: no CUDA device")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("time_paths: torch.backends.cuda.matmul.allow_tf32 must be False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cuda_utils.load_kernels()
    dev = torch.device("cuda", 0)
    smi = {"before": _clocks()}
    ms = {name: _time(fn) for name, fn in _paths(dev).items() if wanted(name)}
    if any(wanted(name) for name in ("matmul_ag_overlapped", "matmul_rs_overlapped")):
        ms |= {name: _time(fn) for name, fn in _mp_paths(dev).items() if wanted(name)}
    smi["after"] = _clocks()
    print(card, flush=True)
    print(json.dumps({"tree": args.tree, "package": tpumathlib_torch.__file__, "card": card,
                      "smi": smi, "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
