#!/usr/bin/env python3
"""Smoke run of tpumathlib_torch's main path on one CUDA card (an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises and the exit code is non-zero:
1. device — needs a CUDA card of compute capability 9.0; prints its name and
   power limit (nvidia-smi); f32 matmuls must not use TF32.
2. build  — compiles tpumathlib_torch/csrc into build/tpumathlib_torch/.
3. kernel — the GEMM kernel against its plain PyTorch version on the card:
   every operand/output dtype pair under all ten epilogues, alpha/beta with
   C, a batch with broadcast B and C, a transposed operand, ragged edges
   under each compiled tile config, and the entry point at 256^3 against a
   float64 host reference.
4. main path — 4096^3 bf16 with the bias+GELU epilogue through entry(),
   lt.matmul(Algo("pallas")) and level3.gemm(backend="pallas"): the
   kernel's launch count must grow on each; the default Algo("auto") route
   (the vendor path) must agree too.
5. times — CUDA events, 3 warm-ups, median of 20 runs (twice, in turns):
   the kernel, its plain version and the vendor route at the main path's
   shape; then each route of phase 4 on the host clock, end to end.
6. block kernels — the two 128x128 sweeps of csrc/dense_block.cu against
   their plain versions: Cholesky + inverse on SPD input, LU + both inverses
   on barely dominant and SPD input, and a non-SPD block that must give
   info > 0; then each sweep's device time (back to back behind a spin)
   against its plain version's, with its registers and spills from nvcc.log.
7. solver main path — n=4096 f32 through xpotrf(a), xpotrf(a, "U"),
   potrf_onelaunch(a), xgetrf(a, pivot=False) and getrf_onelaunch(a): each
   must grow its driver's count by 1, its block kernel's and the GEMM
   kernel's (printed: the launches of each call); the factor is held against
   a float64 factor (potrf) or the residual L·U − A (getrf), with info == 0,
   and against the plain version; a matrix that stops being SPD at row
   2088 must give the same info through the kernel and the plain route.
8. solver times — CUDA events around a call for the kernel route, the same
   schedule with every block in order on one stream, the plain version and
   the vendor route (torch.linalg) of each factorization, and for potrf the
   left-looking order (the schedule not taken); then each kernel route's
   device time with the host out of the way, its host enqueue time a call
   and the device's idle share; then each route of phase 7 on the host
   clock.
9. QR block kernels — the Householder reconstruction and the upper-
   triangular inverse of csrc/qr_block.cu, and the whole block step
   _qr_block128 at j0 = 0 and 128, against their plain versions on a
   Gaussian (512, 128) block orthonormalised by the plain CholeskyQR2 steps.
10. QR main path — n=4096 f32 through xgeqrf(a), qr_onelaunch(a) and
   geqrf_onelaunch(a) then orgqr_onelaunch(vr, t): each must grow both
   driver counts by 1 and the counts of every sweep and of the GEMM kernel;
   Q·R − A, QᵀQ − I, tril(R, −1) == 0, info == 0, Q and R against the plain
   drivers, and xormqr against Qᵀ·C. Prints the worst block's condition.
11. QR times — CUDA events for the kernel route, the plain version and the
   vendor route (torch.linalg.qr, torch.geqrf) of geqrf, orgqr and both,
   geqrf's device time behind a spin and host enqueue, and each new block
   kernel against its plain version; then each route of phase 10 on the
   host clock.
12. FFT kernel — dif_fft (csrc/fft_dif.cu) against its plain version and a
   float64 FFT at N = 256 .. 65536: forward and inverse, natural and raw
   order (collapse 1 and 2), f32 and bf16 planes, a strided (2, 3, N)
   batch, and the round trip.
13. FFT main path — batch 4096 x N 4096 f32 planes through plan_many C2C
   (both directions), dif_fft(reorder=False) in f32 and bf16 planes, the
   R2C -> C2R cycle in f32 and precision="bf16", and plan_2d on one
   4096 x 4096 pair: each must grow dif_fft's count and agree with the plain
   version and with float64.
14. FFT times — CUDA events over back-to-back calls for the kernel route,
   the plain version and one torch.fft call of each of bench.py's FFT lines,
   with GB/s, TFLOP/s and the share of the bound; then each route of
   phase 13 on the host clock. Then, with TF32 turned on by the caller
   (phase_tf32), the matmul four-step FFT (N = 96 and 1000) and the f32
   product sites of ROADMAP C16 (syevj, gesvdj, spmv on a BSR matrix,
   sddmm_bsr, xormqr, and the Mp slice's torch.matmul sites) must still
   agree with float64 at their f32 bounds;
   each C16 site is also run with its pin lifted, to show what it keeps
   out. TF32 is off again after.
15. sparse kernels — tml_bell_spmm (csrc/bell_sparse.cu) against its plain
   version and float64: f32, bf16, f16 and bf16 A with f32 B, bs 128 and
   256, k = 1 .. 4096, alpha 0.5, pad slots with zero and non-zero data, a
   3-D batched B; tml_bell_spmv through SpmvPlan with rowform true and
   false, a ragged n and pad slots.
16. sparse main path — bench.py's four sparse lines through the public
   entry points: spmm on a bf16 Blocked-ELL (mb = nb = 128, ellw = 16,
   bs = 128, k = 4096), SpmvPlan.execute (also 20 calls fed back) and spmv
   on an f32 Blocked-ELL (ellw = 32, 268 MB), SpmvAutoPlan on the hidden-
   block CSR (33.5 M nnz, engine "blockedell") and spmv on a CSR with
   n = 100 000 and 32 entries a row (torch's route, no kernel); each kernel
   route must grow its kernel's count and agree with the plain version and
   float64.
17. sparse times — CUDA events for each line's route, the plain version and
   the library call (torch.bmm on gathered blocks, or torch's sparse CSR
   product), with TFLOP/s or GB/s and the share of the bound; then each
   route of phase 16 on the host clock.
18. dx solver kernels — tml_potrf_batched, tml_getrf_batched (pivot on and
   off) and tml_geqrf_batched (csrc/dx_solver.cu) against their plain
   versions and float64 at n = 8 … 256 (256 works in place in device memory)
   on a batch of 37, gesv and posv with 1 and 4 right-hand sides, with the
   residuals L·Lᵀ − A, P·A − L·U (|L| ≤ 1), Q·R − A, QᵀQ − I and A·X − B,
   and a bf16 control that each tolerance must stay under; pivot ties, a non-SPD matrix among SPD ones (C10) and a NaN in a pivot
   column (C11), and a zero column for geqrf.
19. dx main path — bench.py's batch 8192 × n 32 through potrf_batched and
   getrf_batched (pivot on and off; the packed routes), geqrf_batched,
   gesv_batched and posv_batched (4 right-hand sides), potrf and getrf at
   batch 1024 × n 128, and potrf_blocked at n = 4096: each must grow its
   kernel's count (potrf_blocked also B1's), and is held against its plain
   version (pivot mismatches counted) and its residuals.
20. dx times — CUDA events over back-to-back calls for each route of phase
   19, its plain version and its torch.linalg call, with the share of the
   bound.
21. dx least squares and Jacobi — tml_unmqr_batched, tml_gels_batched
   (csrc/dx_solver.cu), tml_syevd_batched and tml_gesvd_batched
   (csrc/dx_jacobi.cu) through the public functions against their plain
   versions and float64 at batch 37: syevd and gesvd at n = 2 … 64, unmqr at
   m = n = 32 and m = 64 × n = 32 both ways, gels at (32, 32), (64, 32) and
   (48, 10) with 1 and 4 right-hand sides; circulant matrices and
   0.5·ones + 0.5·I, whose ties the reference never turns (ROADMAP C12),
   against eigvalsh and svdvals; a bf16 control above every tolerance.
22. dx lsq/eig main path — gels_batched at 8192 × 64 × 32 (k = 4),
   unmqr_batched both ways on geqrf_batched's 8192 × 32 factors, syevd and
   gesvd at 8192 × 32 and 2048 × 64: each must grow its kernel's count by
   one and agree with its plain version and float64; then syevj_batched,
   gesvdj_batched (8192 × 32, float64), xsyevd (n = 2048) and xgesvd (4096²), which
   launch no kernel, against float64.
23. dx lsq/eig times — CUDA events for each route of phase 22, the plain
   version and the library call (lstsq, ormqr, eigh, svd), with the share of
   the bound.
24. codec and fused kernels — tml_cascaded_encode, tml_cascaded_decode,
   tml_cascaded_decode_dot (csrc/dx_comp.cu) and tml_gemm_fft
   (csrc/dx_fused.cu) against their plain versions and float64: the codec at
   every width 1 … 32 and n = 160 … 2^20, its words and leaders bit for bit,
   the int32 extremes and a width too narrow; decode_dot at rows 1, 37 and
   4096, W widths 1 … 256; gemm_fft up to (4096, 1024, 1024) under every
   epilogue and an unknown string (ROADMAP C14); a bf16 control above each
   tolerance.
25. codec and fused main path — bench.py's codec line (64 Mi int32, bits 8)
   through comp.device_cascaded_compress and _decompress, with bits unset
   and the ratio; the lossy codec on 64 Mi f32 at delta 1.0 and 0.3;
   dx_decompress_dot on that payload (524288 rows, W 128 x 128); gemm_fft at
   (32768, 256, 256) with gelu; gemm_fft_composed, gemm_gemm,
   fft_convolution (4096 x 4096) and fft_convolution_nd (8 x 64^3): each
   step must grow exactly its kernels' counts, and agree with the plain
   version and float64.
26. codec and fused times — CUDA events for each kernel route of phase 25
   and its plain version (decode and encode also in GB/s), with the share of
   the bound, and the compositions that stand in for a library call.
27. RNG kernels — tml_random_uniform and tml_dropout_matmul (csrc/dx_rng.cu)
   against their plain versions: the uniforms bit for bit at five shapes up
   to 8192 x 8192 and four seeds, the Random123 known answers through
   rand.philox4x32_10 on the card, the dropout's mask bit for bit against
   the uniforms > rate and its kept values within 1e-5, f32 and bf16
   operands, rates 0 .. 0.9, a ragged (300, 96, 77).
28. RNG main path — random_uniform_kernel(seed, (8192, 8192)) and
   dropout_matmul_kernel at 4096^3 f32, rate 0.1: each grows its count by
   one; mean, variance and KS of the uniforms, the dropout's zero share and
   mask; PhiloxGenerator's 64 Mi words equal to B10a's bits, and every rand
   family on the card equal to its CPU words and its known answers.
29. RNG times — CUDA events for both kernels, their plain versions and the
   yardsticks (torch.rand; F.dropout(torch.matmul(a, b))), with GB/s and the
   share of the bound (B10a's integer bound from its SASS).
30. VV10 kernels — tml_vv10_fwd and tml_vv10_bwd (csrc/dx_vv10.cu) against
   their plain versions and float64 at G = 7, 1500 and 5000.
31. VV10 main path — vv10_pair_energy_pallas at G = 40960 and its four
   gradients through torch.autograd.grad: each kernel's count grows by one;
   the energy and gradients against the f32 plain route and float64.
32. VV10 times — CUDA events for each sweep, the energy and value plus
   gradient, kernel and plain routes, with Gpairs/s and the share of the
   bound.
33. four-step and blocked kernels — pallas_fft (one launch) and
   pallas_fft2 (two) of csrc/fft_four_step.cu against their plain version
   and a float64 FFT at N = 2, 16, 127 (prime), 243, 360, 625, 1000, 4096,
   8192, 12289 (prime), 16383 (3·43·127) and 16384 on a batch of 37, so
   that every radix and the direct pass run: forward, inverse, a strided
   (2, 3, N) batch, bf16 planes and the round trip; solver.potrf_blocked at n = 256/panel 128, 384/256 and
   512/384 against its plain version and a float64 factor, a non-SPD matrix
   (non-finite from its failing block on) and a panel of 192 (refused, C19).
34. four-step and blocked main path — pallas_fft and pallas_fft2 at batch
   4096 x N 4096 and 1024 x 16384 f32 planes, both directions (+1 and +2
   launches a call), and potrf_blocked at n = 4096, panel 256 (+32 sweeps,
   +62 B1 launches), against the plain versions and float64.
35. four-step and blocked times — CUDA events for each route of phase 34,
   its plain version and the library call (torch.fft.fft / ifft on
   complex64, unnormalised; torch.linalg.cholesky), with the share of the
   bound (B5c also against its own, 32·b·N bytes); each four-step route's
   host clock per call beside its device time (wall − device), and
   potrf_blocked's device time behind a spin beside its host enqueue; the
   four-step kernels' registers, spills and blocks an SM from nvcc.log.
36. ring kernels — matmul_ag_overlapped (B12a) and matmul_rs_overlapped
   (B12b) through tml_ring_gemm and tml_ring_accumulate
   (csrc/mp_overlap.cu) against their plain versions (the same schedule with
   torch ops) at P = 1, 2 and 4 ranks on this card, f32 and bf16, (1024,
   512, 512), 20 calls each, every call checked and counted (P² GEMMs,
   P(P − 1) accumulates); then once each at full width.
37. Mp main path — four ranks on the card: entry.dryrun_multichip over
   GPT-J-6B's MLP (8192 tokens, n_embd 4096, n_inner 16384; tp_matmul with
   B1 and GELU, then gemr2d; +4 B1 launches), the overlapped pair
   matmul_rs_overlapped(matmul_ag_overlapped(x, w1), w2) (+16, +16, +12),
   matmul_allreduce and the eight PBLAS ops at m = 4096, each against a
   single-device float64 result at rtol 1e-4.
38. Mp times — CUDA events for each ring, its GEMMs alone, its copies alone,
   the collective routes (B1 and torch.matmul), its plain version and one
   torch.matmul of the whole product; the overlap share with its spread
   (unresolved where it leaves [0, 1] or its spread reaches 1) and the share
   of the bound. Four ranks share one card: its copies are HBM to HBM, not
   NVLink.
The line before the last is a JSON record of the kernels, each with its
bound (the larger of its operations over the card's published peak and its
bytes over 3.35 TB/s); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import itertools
import json
import math
import re
import subprocess
import time
import warnings

from pathlib import Path

import numpy as np
import torch

from tpumathlib_torch import comp, fft, mp, rand, sparse
from tpumathlib_torch.blas import level3, lt
from tpumathlib_torch.core.check import max_abs_rel, max_scaled_err
from tpumathlib_torch.core.errors import InvalidValueError
from tpumathlib_torch.core.interop import to_numpy
from tpumathlib_torch.core.timer import benchmark
from tpumathlib_torch.dx import comp as dxc
from tpumathlib_torch.dx import cuda_utils, fused, gemm
from tpumathlib_torch.dx import rng as dxr
from tpumathlib_torch.dx import vv10
from tpumathlib_torch.dx import solver as dxs
from tpumathlib_torch.dx.gemm import _pallas_matmul_plain, pallas_matmul
from tpumathlib_torch.entry import dryrun_multichip, entry
from tpumathlib_torch.fft import kernels as fft_kernels
from tpumathlib_torch.fft import pallas_split, stockham
from tpumathlib_torch.mp import matmul as mp_matmul, overlap, pblas as mp_pblas
from tpumathlib_torch.solver import blocked, dense, jacobi, onelaunch
from tpumathlib_torch.sparse import ops as sparse_ops
from tpumathlib_torch.sparse import pallas_kernels as spk

qr = importlib.import_module("tpumathlib_torch.solver.qr_onelaunch")  # the package exports a function of this name

F32, BF16, F16, I8 = torch.float32, torch.bfloat16, torch.float16, torch.int8
MAIN = (4096, 4096, 4096)  # (M, N, K) of the bench headline
SOLVER_N = 4096            # the factorizations' bench size


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability 9.0 (sm_90a), found {cap}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: torch.backends.cuda.matmul.allow_tf32 must be False")
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return torch.device("cuda", 0), card


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = cuda_utils.load_kernels()
    secs = time.perf_counter() - t0
    buf = (ctypes.c_int * 30)()
    count = lib.tml_gemm_configs(buf, 10)
    compiled = [gemm.MatmulConfig(*buf[3 * i:3 * i + 3]) for i in range(min(count, 10))]
    if tuple(compiled) != tuple(gemm.default_configs()):
        raise SystemExit(f"chip_smoke: compiled configs {compiled} differ from "
                         f"dx/gemm.py's {gemm.default_configs()}")
    print(f"[build] tpumathlib_torch/csrc -> {cuda_utils.build_kernels()} in {secs:.1f} s",
          flush=True)


def _operand(gen, shape, dtype, dev):
    if dtype == I8:  # small enough that f16 outputs stay finite
        return torch.randint(-8, 9, shape, generator=gen, device=dev, dtype=I8)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


class Checker:
    """Runs kernel-vs-plain cases and keeps the worst error per group."""

    def __init__(self):
        self.worst: dict[str, float] = {}
        self.failures: list[str] = []
        self.cases = 0

    def compare(self, group: str, case: str, got, want, tol: float):
        err = max_scaled_err(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        self.cases += 1
        self.worst[group] = max(self.worst.get(group, 0.0), err)
        if err > tol or not finite or got.shape != want.shape:
            self.failures.append(f"{case}: max-scaled err {err:.3e} > tol {tol:g} "
                                 f"(finite={finite}, shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)})")

    def run(self, group: str, case: str, args, kw, tol_d: float, tol_aux: float = 1e-5):
        got = pallas_matmul(*args, **kw)
        plain_kw = {k: v for k, v in kw.items() if k != "config"}
        plain_kw.setdefault("out_dtype", args[0].dtype)
        want = _pallas_matmul_plain(*args, **plain_kw)
        torch.cuda.synchronize()
        if kw.get("return_aux"):
            self.compare(group, case + " d", got[0], want[0], tol_d)
            self.compare(group + " aux", case + " aux", got[1], want[1], tol_aux)
        else:
            self.compare(group, case, got, want, tol_d)


def phase_kernel(dev) -> Checker:
    """Kernel against its plain version. Tolerances (max-scaled, as
    core.check.allclose): f32 output 1e-5 (the same f32 products, summed in
    another order); bf16/f16 output 1e-2 (one output ulp apart where the two
    f32 sums round differently); int8 operands with f32 output and no GELU
    exact, since integer sums below 2^24 are exact in f32."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    chk = Checker()
    m, n, k = 200, 136, 264
    for ab in (F32, BF16, F16, I8):
        a, b = _operand(gen, (m, k), ab, dev), _operand(gen, (k, n), ab, dev)
        bias = torch.randn((n,), generator=gen, device=dev)
        for out in (F32, BF16, F16):
            group = f"{str(ab)[6:]}->{str(out)[6:]}"
            for epi in gemm._EPILOGUES:
                exact = ab == I8 and out == F32 and "gelu" not in epi
                tol = 0.0 if exact else (1e-5 if out == F32 else 1e-2)
                kw = dict(bias=bias if "bias" in epi else None, epilogue=epi,
                          out_dtype=out, return_aux="aux" in epi)
                chk.run(group, f"{group} {epi} {m}x{n}x{k}", (a, b), kw, tol,
                        tol_aux=0.0 if ab == I8 else 1e-5)

    # alpha/beta with C, for C in f32 and bf16
    a, b = _operand(gen, (m, k), F32, dev), _operand(gen, (k, n), F32, dev)
    bias = torch.randn((n,), generator=gen, device=dev)
    for cdt in (F32, BF16):
        c = _operand(gen, (m, n), cdt, dev)
        chk.run("alpha/beta/C", f"alpha=1.5 beta=-0.5 C={cdt}", (a, b, c),
                dict(bias=bias, epilogue="gelu_bias", alpha=1.5, beta=-0.5,
                     out_dtype=F32), 1e-5)

    # batch of 3 with B and C broadcast (stride 0), and a transposed A view
    a3 = _operand(gen, (3, 130, 96), BF16, dev)
    b1 = _operand(gen, (96, 70), BF16, dev)
    c1 = _operand(gen, (130, 70), F32, dev)
    chk.run("batched", "batch 3, broadcast B and C", (a3, b1.expand(3, 96, 70), c1),
            dict(beta=0.25, epilogue="relu", out_dtype=BF16), 1e-2)
    at = _operand(gen, (k, m), F32, dev).mT
    chk.run("strided", "transposed A view", (at, b), dict(out_dtype=F32), 1e-5)

    # ragged (100, 50, 70) and (257, 129, 65) under each compiled config
    for cfg in gemm.default_configs():
        for (mm, nn, kk) in ((100, 50, 70), (257, 129, 65)):
            for ab in (F32, BF16):
                a, b = _operand(gen, (mm, kk), ab, dev), _operand(gen, (kk, nn), ab, dev)
                chk.run("ragged/config", f"{cfg} {mm}x{nn}x{kk} {ab}", (a, b),
                        dict(config=cfg, out_dtype=F32), 1e-5)

    # the entry point at 256^3 against a float64 host reference
    fn, args = entry(dev, 256, 256, 256)
    got = fn(*args)
    a64, b64, bias64 = (to_numpy(t).astype(np.float64) for t in args)
    pre = a64 @ b64 + bias64
    want = 0.5 * pre * (1 + np.tanh(np.sqrt(2 / np.pi) * (pre + 0.044715 * pre**3)))
    chk.compare("entry vs f64 host", "entry 256^3 vs numpy f64", got,
                torch.from_numpy(want), 1e-2)

    for group, err in chk.worst.items():
        print(f"[kernel] {group:24s} worst max-scaled err {err:.3e}", flush=True)
    for f in chk.failures:
        print(f"[kernel] FAIL {f}", flush=True)
    if chk.failures:
        raise SystemExit(f"chip_smoke: {len(chk.failures)} of {chk.cases} kernel cases disagree")
    print(f"[kernel] {chk.cases} cases agree with the plain version", flush=True)
    return chk


def phase_main_path(dev) -> dict:
    """The main path once, through the entry points a user calls."""
    m, n, k = MAIN
    fn, args = entry(dev, m, n, k)
    a, b, bias = args
    desc = lt.MatmulDesc(epilogue=lt.Epilogue.GELU_BIAS)
    routes = {
        "entry": lambda: fn(*args),
        "lt.matmul(Algo('pallas'))": lambda: lt.matmul(
            desc, a, b, bias=bias, algo=lt.Algo("pallas"), out_dtype=BF16),
        "level3.gemm(backend='pallas')": lambda: level3.gemm(1.0, a, b, backend="pallas"),
        "lt.matmul(Algo('auto'))": lambda: lt.matmul(desc, a, b, bias=bias, out_dtype=BF16),
    }
    torch.cuda.synchronize()
    pallas_matmul.launches = 0
    outs, grew = {}, {}
    for name, route in routes.items():
        before = pallas_matmul.launches
        outs[name] = route()
        grew[name] = pallas_matmul.launches - before
    torch.cuda.synchronize()
    launches = pallas_matmul.launches

    want_epi = _pallas_matmul_plain(a, b, None, bias, out_dtype=BF16, epilogue="gelu_bias")
    want_l3 = _pallas_matmul_plain(a, b, out_dtype=BF16)
    wants = {"entry": want_epi, "lt.matmul(Algo('pallas'))": want_epi,
             "level3.gemm(backend='pallas')": want_l3, "lt.matmul(Algo('auto'))": want_epi}
    max_abs, failures = 0.0, []
    for name, out in outs.items():
        err = max_scaled_err(out, wants[name])
        abs_err = max_abs_rel(out, wants[name])[0]
        finite = bool(torch.isfinite(out.float()).all())
        ok = err <= 1e-2 and finite and out.shape == (m, n) and out.dtype == BF16
        print(f"[main] {name:30s} launches +{grew[name]} | {tuple(out.shape)} {out.dtype} "
              f"finite={finite} | vs plain: max-scaled {err:.3e} max-abs {abs_err:.3e} "
              f"(tol 1e-2) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
        if name != "lt.matmul(Algo('auto'))":
            max_abs = max(max_abs, abs_err)
            if grew[name] < 1:
                failures.append(f"{name} did not launch the kernel")
    if failures:
        raise SystemExit(f"chip_smoke: main path failed: {failures}")
    return {"launches": launches, "max_abs_err": max_abs, "args": args, "desc": desc,
            "routes": routes}


def _median_ms(runs: dict, warmup: int, iters: int) -> dict:
    """Median device ms per route, CUDA events, timed twice in turns."""
    times: dict[str, list[float]] = {name: [] for name in runs}
    for name in list(runs) + list(reversed(runs)):
        times[name] += benchmark(runs[name], warmup=warmup, iters=iters)["times"]
    return {name: float(np.median(t)) * 1e3 for name, t in times.items()}


def _wall_ms(route, calls: int) -> float:
    """Host-clock ms per call over back-to-back calls, after one warm-up."""
    route()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        route()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def phase_times(main: dict, card: str) -> dict:
    m, n, k = MAIN
    a, b, bias = main["args"]
    desc = main["desc"]
    runs = {
        "kernel": lambda: pallas_matmul(a, b, bias=bias, epilogue="gelu_bias",
                                        out_dtype=BF16),
        "plain": lambda: _pallas_matmul_plain(a, b, None, bias, out_dtype=BF16,
                                              epilogue="gelu_bias"),
        "vendor": lambda: lt.matmul(desc, a, b, bias=bias, algo=lt.Algo("xla"),
                                    out_dtype=BF16),
    }
    ms = _median_ms(runs, warmup=3, iters=20)
    flop = 2.0 * m * n * k
    for name, t in ms.items():
        print(f"[times] {name:7s} {m}x{n}x{k} bf16 gelu+bias: {t:.4f} ms = "
              f"{flop / t / 1e9:.2f} TFLOP/s | {card}", flush=True)
    # each user route end to end: host clock over 10 back-to-back calls
    for name, route in main["routes"].items():
        print(f"[times] wall {name:30s} {_wall_ms(route, 10):.4f} ms per call "
              f"(host clock, 10 calls) | {card}", flush=True)
    return ms


def _spd(gen, n, dev):
    g = torch.randn((n, n), generator=gen, device=dev)
    return g @ g.T / n + 4.0 * torch.eye(n, device=dev)


def _barely_dominant(gen, n, dev):
    """g + diag(1.05·|g| row sums): multipliers O(1), the reference tests' input."""
    g = torch.randn((n, n), generator=gen, device=dev)
    return g + torch.diag(1.05 * g.abs().sum(dim=1))


SPIN_HZ = 2.5e9   # cycles a second that torch.cuda._sleep is sized by: above the SM clock


def _queued_ms(fn, reps: int) -> tuple[float, float, bool]:
    """(device ms, host enqueue ms, covered) a call of ``fn``: the host clock
    around ``reps`` calls without a synchronise, then CUDA events around
    ``reps`` calls enqueued behind a spin kernel sized to outlast their
    enqueue, so that the device runs them back to back with the host out of
    the way. ``covered`` says the spin was still running when the last call
    was enqueued (else the device time may hold host gaps)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_HZ * (2 * host * reps + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    covered = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps, host * 1e3, covered


# the block kernels' entry functions in nvcc.log, by their names in phases 6 and 8
BLOCK_KERNELS = {"chol_inv_block": "chol_inv_kernel", "lu_inv_block": "lu_inv_kernel"}


def phase_blocks(dev, card: str) -> dict:
    """6. Each block kernel against its plain version. Tolerance 1e-5
    max-scaled: the same factors and inverses by another order of
    operations (inv(U) column by column as the LU runs; the Cholesky as LDLᵀ
    scaled at the end), apart from the FMAs nvcc contracts. Then each
    kernel's device time (back to back behind a spin, ``_queued_ms``)
    against its plain version's, and its registers and spills."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    spd, dom = _spd(gen, 128, dev), _barely_dominant(gen, 128, dev)
    cases = [("chol_inv_block", "SPD", blocked._chol_inv128, blocked._chol_inv128_plain, spd),
             ("lu_inv_block", "barely dominant", onelaunch._lu_inv128,
              onelaunch._lu_inv128_plain, dom),
             ("lu_inv_block", "SPD", onelaunch._lu_inv128, onelaunch._lu_inv128_plain, spd)]
    failures = []
    for name, what, kernel, plain, x in cases:
        got, want = kernel(x), plain(x)
        torch.cuda.synchronize()
        errs = [max_scaled_err(g, w) for g, w in zip(got, want)]
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ok = max(errs) <= 1e-5 and finite
        print(f"[blocks] {name:15s} {what:16s} max-scaled err per output "
              f"{', '.join(f'{e:.3e}' for e in errs)} (tol 1e-5) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"{name} {what}")
    bad = spd.clone()
    bad[40, 40] = -1.0   # not SPD from pivot 40 on
    infos = [int(dense._finite_info(f(bad)[0], diag_only=True))
             for f in (blocked._chol_inv128, blocked._chol_inv128_plain)]
    ok = infos[0] > 0 and infos[0] == infos[1]
    print(f"[blocks] chol_inv_block  not SPD          info kernel {infos[0]} plain {infos[1]} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("chol_inv_block non-SPD info")
    if failures:
        raise SystemExit(f"chip_smoke: block kernels failed: {failures}")

    times = {}
    for name, kernel, plain, x in (("chol_inv_block", blocked._chol_inv128,
                                    blocked._chol_inv128_plain, spd),
                                   ("lu_inv_block", onelaunch._lu_inv128,
                                    onelaunch._lu_inv128_plain, dom)):
        samples = [_queued_ms(lambda: kernel(x), 50) for _ in range(5)]
        ms = float(np.median([t[0] for t in samples]))
        plain_ms = _median_ms({"plain": lambda: plain(x)}, warmup=2, iters=10)["plain"]
        (res,) = _ptxas_entries(BLOCK_KERNELS[name])
        times[name] = {"ms": ms, "plain_ms": plain_ms, "ptxas": res}
        print(f"[blocks] {name:15s} 128x128 f32: kernel {ms:.4f} ms (device, back to back; "
              f"samples {', '.join(f'{t[0]:.4f}' for t in samples)}; host enqueue "
              f"{samples[0][1]:.4f} ms a call, spin covered {all(t[2] for t in samples)}) vs "
              f"plain {plain_ms:.4f} | {res.get('registers')} registers, {res.get('stack')} "
              f"bytes stack, spill stores {res.get('spill_stores')} / loads "
              f"{res.get('spill_loads')} bytes (nvcc.log) | {card}", flush=True)
    return times


_SOLVER_COUNTS = (pallas_matmul, blocked._chol_inv128, onelaunch._lu_inv128,
                  onelaunch.potrf_onelaunch, onelaunch.getrf_onelaunch)


def phase_solver_main(dev) -> dict:
    """The factorizations at n=SOLVER_N through the public drivers."""
    n = SOLVER_N
    gen = torch.Generator(device=dev).manual_seed(2024)
    a, ag = _spd(gen, n, dev), _barely_dominant(gen, n, dev)
    routes = {
        "xpotrf(a)": lambda: dense.xpotrf(a),
        "xpotrf(a, 'U')": lambda: dense.xpotrf(a, "U"),
        "potrf_onelaunch(a)": lambda: (onelaunch.potrf_onelaunch(a), None),
        "xgetrf(a, pivot=False)": lambda: dense.xgetrf(ag, pivot=False)[::2],  # (lu, info)
        "getrf_onelaunch(a)": lambda: (onelaunch.getrf_onelaunch(ag), None),
    }
    torch.cuda.synchronize()
    for f in _SOLVER_COUNTS:
        f.launches = 0
    outs, grew = {}, {}
    for name, route in routes.items():
        before = {f.__name__: f.launches for f in _SOLVER_COUNTS}
        outs[name] = route()
        grew[name] = {f.__name__: f.launches - before[f.__name__] for f in _SOLVER_COUNTS}
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in _SOLVER_COUNTS}
    print(f"[solver] launches in the main path: {launches}", flush=True)

    l64 = torch.linalg.cholesky(a.double())
    want = {"potrf": onelaunch._potrf_onelaunch_plain(a),
            "getrf": onelaunch._getrf_onelaunch_plain(ag)}
    eye64 = torch.eye(n, dtype=torch.float64, device=dev)
    max_abs = {"potrf": 0.0, "getrf": 0.0}
    failures = []
    for name, (out, info) in outs.items():
        kind = "potrf" if "potrf" in name else "getrf"
        f = out.mT if name.endswith("'U')") else out   # the lower factor
        if kind == "potrf":
            rel = float((f.double() - l64).abs().max() / l64.abs().max())
            upper_zero = bool((torch.triu(f, 1) == 0).all())
        else:
            lu64 = f.double()
            l_u = (torch.tril(lu64, -1) + eye64) @ torch.triu(lu64)
            rel = float((l_u - ag.double()).abs().max() / ag.double().abs().max())
            upper_zero = True
        vs_plain = max_scaled_err(f, want[kind])
        abs_err = max_abs_rel(f, want[kind])[0]
        max_abs[kind] = max(max_abs[kind], abs_err)
        info_ok = info is None or int(info) == 0
        g = grew[name]
        driver = g[f"{kind}_onelaunch"]
        block = g["_chol_inv128" if kind == "potrf" else "_lu_inv128"]
        launched = g["pallas_matmul"] > 0 and block > 0 and driver == 1
        finite = bool(torch.isfinite(f).all())
        ok = (rel < 5e-5 and upper_zero and info_ok and vs_plain <= 1e-5 and launched
              and finite and f.shape == (n, n) and f.dtype == F32)
        print(f"[solver] {name:24s} launches gemm +{g['pallas_matmul']} block +{block} "
              f"driver +{driver} | rel {'vs f64' if kind == 'potrf' else 'LU-A'} "
              f"{rel:.3e} (tol 5e-5) upper=0 {upper_zero} info "
              f"{'-' if info is None else int(info)} | vs plain max-scaled {vs_plain:.3e} "
              f"max-abs {abs_err:.3e} (tol 1e-5) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
    bad = a.clone()
    r = n // 2 + 40
    bad[r, r] = -1.0   # not SPD from row r on: the block of row r fails
    infos = [int(dense._finite_info(f(bad), diag_only=True))
             for f in (onelaunch.potrf_onelaunch, onelaunch._potrf_onelaunch_plain)]
    ok = 0 < infos[0] <= r + 1 and infos[0] == infos[1]
    print(f"[solver] potrf not SPD from row {r}: info kernel {infos[0]} plain {infos[1]} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("potrf non-SPD info")
    if failures:
        raise SystemExit(f"chip_smoke: solver main path failed: {failures}")
    per_call = {"potrf": grew["potrf_onelaunch(a)"], "getrf": grew["getrf_onelaunch(a)"]}
    return {"launches": launches, "max_abs_err": max_abs, "a": a, "ag": ag, "routes": routes,
            "per_call": per_call}


def _potrf_left_looking(a):
    """The Cholesky in the reference's left-looking order, which
    potrf_onelaunch does not take, on the same kernels: 256-wide panels,
    each updated from all panels left of it by one B1 product (a narrow
    (n − s, 256) output, K = s), then its two 128-blocks factored, their
    trsm and the in-panel update. n³/3 flops against the right-looking
    2n³/3; phase 8 times the two."""
    n = a.shape[0]
    out = a.to(F32).clone(memory_format=torch.contiguous_format)
    with torch.cuda.device(a.device):
        for s0 in range(0, n, 256):
            p1 = s0 + 256
            if s0:   # A[s0:, strip] -= L[s0:, :s0] · L[strip, :s0]^T
                strip = out[s0:, s0:p1]
                gemm._matmul_into(strip, out[s0:, :s0], out[s0:p1, :s0].mT, strip,
                                  alpha=-1.0, beta=1.0)
            for j0 in (s0, s0 + 128):
                j1 = j0 + 128
                l, w = blocked._chol_inv128(out[j0:j1, j0:j1])
                out[j0:j1, j0:j1] = l
                if j1 < n:   # trsm, through a fresh output: D may not overlap A
                    out[j1:, j0:j1] = pallas_matmul(out[j1:, j0:j1], w.mT)
                if j1 < p1:  # in-panel update of the strip's second block column
                    out[j0:j1, j1:p1] = 0.0
                    rest = out[j1:, j1:p1]
                    gemm._matmul_into(rest, out[j1:, j0:j1], out[j1:p1, j0:j1].mT, rest,
                                      alpha=-1.0, beta=1.0)
            out[:s0, s0:p1] = 0.0
    return out


def phase_solver_times(solver: dict, card: str) -> dict:
    """8. Each factorization's kernel route, plain version and vendor route:
    CUDA events around one call after a synchronise (the time a caller
    sees, the host's enqueue included); then each kernel route's device
    time with the host out of the way (``_queued_ms``), its host enqueue
    time a call (no synchronise), and the device's idle share of the call,
    1 − device / events; the same schedules with every block in order on
    one stream (no look-ahead); and the left-looking potrf, the schedule
    not taken, against the plain version and timed the same ways."""
    n = SOLVER_N
    a, ag = solver["a"], solver["ag"]
    left = _potrf_left_looking(a)
    torch.cuda.synchronize()
    err = max_scaled_err(left, onelaunch._potrf_onelaunch_plain(a))
    print(f"[solver-times] left-looking potrf vs plain: max-scaled {err:.3e} (tol 1e-5) "
          f"{'ok' if err <= 1e-5 else 'FAIL'}", flush=True)
    if err > 1e-5:
        raise SystemExit("chip_smoke: the left-looking potrf disagrees with the plain version")
    runs = {
        "potrf kernel": lambda: onelaunch.potrf_onelaunch(a),
        "potrf in order": lambda: onelaunch._potrf(a, onelaunch._KernelOps(
            a.device, "tml_chol_inv_block", blocked._chol_inv128, ahead=False)),
        "potrf left-looking": lambda: _potrf_left_looking(a),
        "potrf plain": lambda: onelaunch._potrf_onelaunch_plain(a),
        "potrf vendor": lambda: torch.linalg.cholesky(a),
        "getrf kernel": lambda: onelaunch.getrf_onelaunch(ag),
        "getrf in order": lambda: onelaunch._getrf(ag, onelaunch._KernelOps(
            ag.device, "tml_lu_inv_block", onelaunch._lu_inv128, ahead=False)),
        "getrf plain": lambda: onelaunch._getrf_onelaunch_plain(ag),
        "getrf vendor": lambda: torch.linalg.lu_factor_ex(ag, pivot=False),
    }
    ms = _median_ms(runs, warmup=1, iters=5)
    for name, t in ms.items():
        flop = (n**3 / 3 if name.startswith("potrf") else 2 * n**3 / 3)
        print(f"[solver-times] {name:18s} n={n} f32: {t:.4f} ms = {flop / t / 1e6:.1f} GFLOP/s "
              f"(CUDA events around a call) | {card}", flush=True)
    for name in ("potrf kernel", "potrf in order", "potrf left-looking", "getrf kernel",
                 "getrf in order"):
        samples = [_queued_ms(runs[name], 3) for _ in range(3)]
        dev_ms = float(np.median([t[0] for t in samples]))
        host_ms = float(np.median([t[1] for t in samples]))
        ms[f"{name} device"], ms[f"{name} host"] = dev_ms, host_ms
        ms[f"{name} idle"] = 1.0 - dev_ms / ms[name]
        print(f"[solver-times] {name:18s} device {dev_ms:.4f} ms (back to back behind a spin; "
              f"samples {', '.join(f'{t[0]:.4f}' for t in samples)}, spin covered "
              f"{all(t[2] for t in samples)}) | host enqueue {host_ms:.4f} ms a call (no "
              f"synchronise) | device idle share of a call {ms[f'{name} idle']:.3f} | {card}",
              flush=True)
    for name, route in solver["routes"].items():
        print(f"[solver-times] wall {name:24s} {_wall_ms(route, 3):.4f} ms per call "
              f"(host clock, 3 calls) | {card}", flush=True)
    return ms


def _cholqr2_plain(b):
    """The orthonormal basis of an (m, 128) block by the plain CholeskyQR2 steps."""
    mm = onelaunch._mm_plain
    _, w1 = blocked._chol_inv128_plain(mm(b.mT, b))
    q1 = mm(b, w1.mT)
    _, w2 = blocked._chol_inv128_plain(mm(q1.mT, q1))
    return mm(q1, w2.mT)


def _half_diag_gram(v):
    """T⁻¹ as _t_from_v builds it: VᵀV with its diagonal halved."""
    s = onelaunch._mm_plain(v.mT, v)
    s.diagonal().mul_(0.5)
    return s


def phase_qr_blocks(dev) -> None:
    """The QR block kernels and the block step against their plain versions.
    Tolerance 1e-5 max-scaled per output: the same f32 steps, apart from the
    FMAs nvcc contracts and B1's order of summation."""
    gen = torch.Generator(device=dev).manual_seed(8128)
    b = torch.randn((512, 128), generator=gen, device=dev)
    q = _cholqr2_plain(b)
    vm = qr._unit_lower(qr._qr_block128_plain(b, 0)[0])
    tinv = _half_diag_gram(vm)
    cases = [("hh_recon_block", "(v1, d, inv M)", qr._hh_recon128(q[:128]),
              qr._hh_recon128_plain(q[:128])),
             ("inv_upper_block", "T^-1 of a block", (onelaunch._inv_upper128(tinv),),
              (onelaunch._inv_upper128_plain(tinv),)),
             ("_t_from_v", "B1 + inv_upper", (qr._t_from_v(vm),),
              (qr._t_from_v(vm, qr._plain_ops()),))]
    cases += [("_qr_block128", f"j0={j0} (v, v1, rd)", qr._qr_block128(b, j0),
               qr._qr_block128_plain(b, j0)) for j0 in (0, 128)]
    torch.cuda.synchronize()
    failures = []
    for name, what, got, want in cases:
        errs = [max_scaled_err(g, w) for g, w in zip(got, want)]
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ok = max(errs) <= 1e-5 and finite
        print(f"[qr-blocks] {name:15s} {what:20s} max-scaled err per output "
              f"{', '.join(f'{e:.3e}' for e in errs)} (tol 1e-5) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"{name} {what}")
    if failures:
        raise SystemExit(f"chip_smoke: QR block kernels failed: {failures}")


_QR_COUNTS = (pallas_matmul, blocked._chol_inv128, qr._hh_recon128, onelaunch._inv_upper128,
              qr.geqrf_onelaunch, qr.orgqr_onelaunch)


def _geqrf_then_orgqr(a):
    vr, t = qr.geqrf_onelaunch(a)
    return qr.orgqr_onelaunch(vr, t), torch.triu(vr)


def _qr_plain(a):
    vr, t = qr._geqrf_onelaunch_plain(a)
    return qr._orgqr_onelaunch_plain(vr, t), torch.triu(vr)


def phase_qr_main(dev) -> dict:
    """The QR slice at n=SOLVER_N through the public drivers. Bounds of the
    reference test (tests/test_solver_dense.py:377-381): rel(Q·R − A) and
    max|QᵀQ − I| < 5e-5, tril(R, −1) exactly 0. Against the plain drivers
    1e-4 max-scaled: summation-order differences pass through two Gram-matrix
    Cholesky factorizations per block, which square its condition number."""
    n = SOLVER_N
    gen = torch.Generator(device=dev).manual_seed(2025)
    a = torch.randn((n, n), generator=gen, device=dev)
    routes = {
        "xgeqrf(a)": lambda: dense.xgeqrf(a),
        "qr_onelaunch(a)": lambda: (*qr.qr_onelaunch(a), None),
        "geqrf_onelaunch+orgqr_onelaunch": lambda: (*_geqrf_then_orgqr(a), None),
    }
    torch.cuda.synchronize()
    for f in _QR_COUNTS:
        f.launches = 0
    outs, grew = {}, {}
    for name, route in routes.items():
        before = {f.__name__: f.launches for f in _QR_COUNTS}
        outs[name] = route()
        grew[name] = {f.__name__: f.launches - before[f.__name__] for f in _QR_COUNTS}
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in _QR_COUNTS}
    print(f"[qr] launches in the main path: {launches}", flush=True)

    q_p, r_p = _qr_plain(a)
    conds = [float(torch.linalg.cond(r_p[j:j + 128, j:j + 128].double()))
             for j in range(0, n, 128)]
    print(f"[qr] worst 128-block 2-norm condition (plain route's R blocks) {max(conds):.3e} "
          f"(CholeskyQR2 keeps f32 orthogonality below about 4e3)", flush=True)
    a64 = a.double()
    eye64 = torch.eye(n, dtype=torch.float64, device=dev)
    max_abs = {"geqrf": 0.0, "orgqr": 0.0}
    failures = []
    for name, (q, r, info) in outs.items():
        q64, r64 = q.double(), r.double()
        rel = float((q64 @ r64 - a64).abs().max() / a64.abs().max())
        orth = float((q64.mT @ q64 - eye64).abs().max())
        lower_zero = bool((torch.tril(r, -1) == 0).all())
        vs_q, vs_r = max_scaled_err(q, q_p), max_scaled_err(r, r_p)
        max_abs["orgqr"] = max(max_abs["orgqr"], max_abs_rel(q, q_p)[0])
        max_abs["geqrf"] = max(max_abs["geqrf"], max_abs_rel(r, r_p)[0])
        g = grew[name]
        launched = (g["geqrf_onelaunch"] == 1 and g["orgqr_onelaunch"] == 1
                    and min(g["pallas_matmul"], g["_chol_inv128"], g["_hh_recon128"],
                            g["_inv_upper128"]) > 0)
        finite = bool(torch.isfinite(q).all() and torch.isfinite(r).all())
        info_ok = info is None or int(info) == 0
        ok = (rel < 5e-5 and orth < 5e-5 and lower_zero and info_ok and max(vs_q, vs_r) <= 1e-4
              and launched and finite and q.shape == r.shape == (n, n)
              and q.dtype == r.dtype == F32)
        print(f"[qr] {name:32s} launches gemm +{g['pallas_matmul']} chol +{g['_chol_inv128']} "
              f"recon +{g['_hh_recon128']} inv_upper +{g['_inv_upper128']} drivers "
              f"+{g['geqrf_onelaunch']}/+{g['orgqr_onelaunch']} | rel QR-A {rel:.3e} "
              f"orth {orth:.3e} (tol 5e-5) tril(R)=0 {lower_zero} info "
              f"{'-' if info is None else int(info)} | vs plain max-scaled Q {vs_q:.3e} "
              f"R {vs_r:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
    q = outs["xgeqrf(a)"][0]
    c = torch.randn((n, 64), generator=gen, device=dev)
    err = max_scaled_err(dense.xormqr(q, c, "L", "T"), q.mT @ c)
    print(f"[qr] xormqr(q, c, 'L', 'T') vs q.mT @ c: max-scaled {err:.3e} (tol 1e-6) "
          f"{'ok' if err <= 1e-6 else 'FAIL'}", flush=True)
    if err > 1e-6:
        failures.append("xormqr")
    if failures:
        raise SystemExit(f"chip_smoke: QR main path failed: {failures}")
    return {"launches": launches, "max_abs_err": max_abs, "a": a, "routes": routes}


def phase_qr_times(qrd: dict, card: str) -> dict:
    n = SOLVER_N
    a = qrd["a"]
    vr, t = qr.geqrf_onelaunch(a)
    runs = {
        "qr kernel": lambda: qr.qr_onelaunch(a),
        "qr plain": lambda: _qr_plain(a),
        "qr vendor": lambda: torch.linalg.qr(a),
        "geqrf kernel": lambda: qr.geqrf_onelaunch(a),
        "geqrf plain": lambda: qr._geqrf_onelaunch_plain(a),
        "geqrf vendor": lambda: torch.geqrf(a),
        "orgqr kernel": lambda: qr.orgqr_onelaunch(vr, t),
        "orgqr plain": lambda: qr._orgqr_onelaunch_plain(vr, t),
    }
    ms = _median_ms(runs, warmup=1, iters=3)
    dev_ms, host_ms, covered = _queued_ms(runs["geqrf kernel"], 2)
    print(f"[qr-times] geqrf kernel device {dev_ms:.4f} ms (back to back behind a spin, spin "
          f"covered {covered}) | host enqueue {host_ms:.4f} ms a call (no synchronise) | {card}",
          flush=True)
    for name, tm in ms.items():
        flop = 8 * n**3 / 3 if name.startswith("qr") else 4 * n**3 / 3
        print(f"[qr-times] {name:12s} n={n} f32: {tm:.4f} ms = {flop / tm / 1e6:.1f} GFLOP/s "
              f"({'8' if name.startswith('qr') else '4'}n^3/3) | {card}", flush=True)
    b = a[:, :128]   # the first block of the main path
    qtop = _cholqr2_plain(b)[:128]
    tinv = _half_diag_gram(qr._unit_lower(qr._qr_block128_plain(b, 0)[0]))
    blocks = {
        "hh_recon_block kernel": lambda: qr._hh_recon128(qtop),
        "hh_recon_block plain": lambda: qr._hh_recon128_plain(qtop),
        "inv_upper_block kernel": lambda: onelaunch._inv_upper128(tinv),
        "inv_upper_block plain": lambda: onelaunch._inv_upper128_plain(tinv),
        "_qr_block128 kernel": lambda: qr._qr_block128(b, 0),
        "_qr_block128 plain": lambda: qr._qr_block128_plain(b, 0),
    }
    for name, tm in _median_ms(blocks, warmup=2, iters=10).items():
        shape = f"({n}, 128)" if name.startswith("_qr") else "128x128"
        print(f"[qr-times] {name:23s} {shape} f32: {tm:.4f} ms | {card}", flush=True)
    for name, route in qrd["routes"].items():
        print(f"[qr-times] wall {name:32s} {_wall_ms(route, 3):.4f} ms per call "
              f"(host clock, 3 calls) | {card}", flush=True)
    return ms


# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): the least time
# a function could take is the larger of its operations over the peak of their
# type and its bytes (inputs read once, outputs written once) over HBM3's rate.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_S = 3.35e12


def _bound(ops: float, peak: float, nbytes: float) -> dict:
    """The record keys bound_ms and bound_by of a function with ``ops``
    operations at ``peak`` per second and ``nbytes`` of device memory traffic."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    if t_ops >= t_bytes:
        return {"bound_ms": t_ops, "bound_by": "operations"}
    return {"bound_ms": t_bytes, "bound_by": "bytes"}


FFT_KERNEL_NS = (256, 1024, 4096, 16384, 65536)   # phase 12's lengths
FFT_MAIN = (4096, 4096)                           # (batch, N) of the bench's FFT lines


DIF_FFT = stockham.dif_fft   # the kernel's wrapper, whose count the main path must grow


def _c128(yr, yi):
    return torch.complex(yr.double(), yi.double())


def _rel(got, want) -> float:
    """Relative L2 error, in float64 on the device."""
    got = got.to(torch.complex128) if got.is_complex() else got.double()
    want = want.to(torch.complex128) if want.is_complex() else want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _raw_to_natural(y, n: int, collapse: int):
    return y[..., torch.from_numpy(stockham.shuffle_perm(n, collapse).astype(np.int64)).to(y.device)]


@contextlib.contextmanager
def _plain_fft_engine():
    """Route every call of ``stockham.dif_fft`` (the plans reach it through
    ``fft.kernels``) to its plain version, for the plain side of a comparison."""
    kernel = stockham.dif_fft
    stockham.dif_fft = stockham._dif_fft_plain
    try:
        yield
    finally:
        stockham.dif_fft = kernel


def phase_fft_kernel(dev) -> None:
    """dif_fft (csrc/fft_dif.cu) against its plain version and float64 on the
    card. Bounds: against the plain version rel-L2 ≤ 5e-6 for f32 planes (the
    same transform, another order of sums) and ≤ 8e-3 for bf16 (an output
    ulp where the two roundings differ); against float64, f32 < 1e-6 at
    N ≤ 4096 (the reference's exact=True bound, tests/test_fft_kernels.py:89)
    and < 1e-5 above (:85), bf16 < 8e-3 (:106); the inverse of the forward
    against N·x < 1e-5 (:92)."""
    gen = torch.Generator(device=dev).manual_seed(5150)
    failures, cases = [], 0
    for n in FFT_KERNEL_NS:
        rows = 4 if n <= 16384 else 2
        xr = torch.randn((rows, n), generator=gen, device=dev)
        xi = torch.randn((rows, n), generator=gen, device=dev)
        x64 = _c128(xr, xi)
        f64, i64 = torch.fft.fft(x64), torch.fft.ifft(x64) * n
        wide = torch.randn((2, 3, 2 * n), generator=gen, device=dev)[..., ::2]   # (2, 3, n), stride 2
        cases_n = [("fwd natural f32", (xr, xi), {}, f64),
                   ("inv natural f32", (xr, xi), {"inverse": True}, i64),
                   ("fwd raw c=1 f32", (xr, xi), {"reorder": False}, f64),
                   ("fwd raw c=2 f32", (xr, xi), {"reorder": False, "collapse": 2}, f64),
                   ("inv raw c=2 f32", (xr, xi), {"reorder": False, "collapse": 2, "inverse": True},
                    i64),
                   ("fwd natural bf16", (xr.bfloat16(), xi.bfloat16()), {"halfplanes": True}, f64),
                   ("inv raw c=1 bf16", (xr.bfloat16(), xi.bfloat16()),
                    {"halfplanes": True, "reorder": False, "inverse": True}, i64),
                   ("(2,3,N) strided f32", (wide, wide.flip(0)), {},
                    torch.fft.fft(_c128(wide, wide.flip(0))))]
        for what, (ar, ai), kw, want in cases_n:
            got = stockham.dif_fft(ar, ai, **kw)
            plain = stockham._dif_fft_plain(ar, ai, **kw)
            torch.cuda.synchronize()
            bf16 = kw.get("halfplanes", False)
            g, p = _c128(*got), _c128(*plain)
            if not kw.get("reorder", True):
                g = _raw_to_natural(g, n, kw.get("collapse", 1))
                p = _raw_to_natural(p, n, kw.get("collapse", 1))
            vs_plain, vs_f64 = _rel(g, p), _rel(g, want)
            tol_plain = 8e-3 if bf16 else 5e-6
            tol_f64 = 8e-3 if bf16 else (1e-6 if n <= 4096 else 1e-5)
            ok = (vs_plain <= tol_plain and vs_f64 < tol_f64 and got[0].shape == ar.shape
                  and got[0].dtype == (BF16 if bf16 else F32) and bool(torch.isfinite(g).all()))
            cases += 1
            if not ok:
                failures.append(f"N={n} {what}")
            print(f"[fft-kernel] N={n:5d} {what:20s} vs plain {vs_plain:.3e} (tol {tol_plain:g}) "
                  f"vs f64 {vs_f64:.3e} (tol {tol_f64:g}) {'ok' if ok else 'FAIL'}", flush=True)
        back = stockham.dif_fft(*stockham.dif_fft(xr, xi), inverse=True)
        err = _rel(_c128(*back), n * x64)
        cases += 1
        if err >= 1e-5:
            failures.append(f"N={n} round trip")
        print(f"[fft-kernel] N={n:5d} inverse(forward(x)) vs N·x {err:.3e} (tol 1e-5) "
              f"{'ok' if err < 1e-5 else 'FAIL'}", flush=True)
    if failures:
        raise SystemExit(f"chip_smoke: {len(failures)} of {cases} FFT kernel cases failed: {failures}")
    print(f"[fft-kernel] {cases} cases agree", flush=True)


def _as_c128(out):
    return out.double() if isinstance(out, torch.Tensor) else _c128(*out)


def phase_fft_main(dev) -> dict:
    """The FFT slice at batch 4096 x N 4096 f32 planes (bench.py:137-207)
    through the plans and dif_fft. Each route must grow dif_fft.launches and
    is held against the plain version (the same routes with dif_fft's plain
    version) and against float64, rel-L2 < 1e-5 for f32 planes
    (tests/test_fft_kernels.py:85) and < 8e-3 for bf16 (:106)."""
    b, n = FFT_MAIN
    gen = torch.Generator(device=dev).manual_seed(4096)
    xr = torch.randn((b, n), generator=gen, device=dev)
    xi = torch.randn((b, n), generator=gen, device=dev)
    br, bi = xr.bfloat16(), xi.bfloat16()
    x = torch.randn((b, n), generator=gen, device=dev)
    sq = (torch.randn((n, n), generator=gen, device=dev), torch.randn((n, n), generator=gen, device=dev))
    c2c = fft.plan_many((n,), fft.FftType.C2C)
    r2c, c2r = fft.plan_many((n,), fft.FftType.R2C), fft.plan_many((n,), fft.FftType.C2R)
    r2c_h = fft.plan_many((n,), fft.FftType.R2C, precision="bf16")
    c2r_h = fft.plan_many((n,), fft.FftType.C2R, precision="bf16")
    p2d = fft.plan_2d(n, n)
    routes = {
        "plan_many C2C forward": lambda: c2c((xr, xi)),
        "plan_many C2C inverse": lambda: c2c((xr, xi), fft.Direction.INVERSE),
        "dif_fft(reorder=False)": lambda: stockham.dif_fft(xr, xi, reorder=False),
        "dif_fft(reorder=False, halfplanes)": lambda: stockham.dif_fft(br, bi, reorder=False,
                                                                       halfplanes=True),
        "R2C->C2R cycle f32": lambda: c2r(r2c(x, planar=True), fft.Direction.INVERSE) / n,
        "R2C->C2R cycle bf16": lambda: c2r_h(r2c_h(x, planar=True), fft.Direction.INVERSE) / n,
        "plan_2d C2C": lambda: p2d(sq),
    }
    torch.cuda.synchronize()
    DIF_FFT.launches = 0
    outs, grew = {}, {}
    for name, route in routes.items():
        before = DIF_FFT.launches
        outs[name] = route()
        grew[name] = DIF_FFT.launches - before
    torch.cuda.synchronize()
    launches = DIF_FFT.launches
    print(f"[fft] dif_fft launches in the main path: {launches}", flush=True)

    def f64_of(name):
        if name == "plan_many C2C forward":
            return torch.fft.fft(_c128(xr, xi))
        if name == "plan_many C2C inverse":
            return torch.fft.ifft(_c128(xr, xi)) * n
        if name == "dif_fft(reorder=False)":
            return torch.fft.fft(_c128(xr, xi))
        if name.startswith("dif_fft"):
            return torch.fft.fft(_c128(br, bi))
        if name.startswith("R2C"):
            return x.double()
        return torch.fft.fft2(_c128(*sq))

    max_abs, failures = 0.0, []
    for name, route in routes.items():
        with _plain_fft_engine():
            plain = route()
        got, plain = _as_c128(outs[name]), _as_c128(plain)
        if "reorder=False" in name:
            got, plain = _raw_to_natural(got, n, 1), _raw_to_natural(plain, n, 1)
        bf16 = "bf16" in name or "halfplanes" in name
        tol = 8e-3 if bf16 else 1e-5
        vs_plain, vs_f64 = _rel(got, plain), _rel(got, f64_of(name))
        abs_err = float((got - plain).abs().max())
        del plain
        finite = bool(torch.isfinite(got).all())
        shape = tuple((outs[name] if isinstance(outs[name], torch.Tensor) else outs[name][0]).shape)
        ok = vs_plain < tol and vs_f64 < tol and finite and grew[name] >= 1 and shape[-1] == n
        if not bf16:
            max_abs = max(max_abs, abs_err)
        print(f"[fft] {name:36s} launches +{grew[name]} | {shape} finite={finite} | vs plain "
              f"{vs_plain:.3e} (max-abs {abs_err:.3e}) vs f64 {vs_f64:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
    if failures:
        raise SystemExit(f"chip_smoke: FFT main path failed: {failures}")
    return {"launches": launches, "max_abs_err": max_abs, "routes": routes,
            "args": (xr, xi, br, bi, x)}


def _loop_ms(runs: dict, warmup: int, reps: int, samples: int,
             spread: dict | None = None) -> dict:
    """Median device ms per call of each route: CUDA events around ``reps``
    back-to-back calls (so the host's launch cost overlaps the device's
    work), ``samples`` times, twice in turns. ``spread``, where given,
    receives each route's fastest and slowest sample."""
    times: dict[str, list[float]] = {name: [] for name in runs}
    for name in list(runs) + list(reversed(runs)):
        fn = runs[name]
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        for _ in range(samples):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    if spread is not None:
        spread.update({name: (min(t), max(t)) for name, t in times.items()})
    return {name: float(np.median(t)) for name, t in times.items()}


def _plain(route):
    def run():
        with _plain_fft_engine():
            return route()
    return run


def phase_fft_times(fftd: dict, card: str) -> dict:
    """CUDA-event times of the kernel route, the plain version and one
    torch.fft call (library) for each FFT line of bench.py, at batch 4096 x
    N 4096; then each route of phase 13 on the host clock."""
    b, n = FFT_MAIN
    xr, xi, br, bi, x = fftd["args"]
    xc = torch.complex(xr, xi)
    r2c, c2r = fft.plan_many((n,), fft.FftType.R2C), fft.plan_many((n,), fft.FftType.C2R)
    r2c_h = fft.plan_many((n,), fft.FftType.R2C, precision="bf16")
    c2r_h = fft.plan_many((n,), fft.FftType.C2R, precision="bf16")
    lines = {
        "c2c natural": (lambda: stockham.dif_fft(xr, xi), lambda: torch.fft.fft(xc), 4),
        "c2c shuffled": (lambda: stockham.dif_fft(xr, xi, reorder=False), lambda: torch.fft.fft(xc), 4),
        "c2c shuffled bf16": (lambda: stockham.dif_fft(br, bi, reorder=False, halfplanes=True),
                              lambda: torch.fft.fft(xc), 2),
        "r2c/c2r cycle": (lambda: c2r(r2c(x, planar=True), fft.Direction.INVERSE) / n,
                          lambda: torch.fft.irfft(torch.fft.rfft(x), n), 4),
        "r2c/c2r cycle bf16": (lambda: c2r_h(r2c_h(x, planar=True), fft.Direction.INVERSE) / n,
                               lambda: torch.fft.irfft(torch.fft.rfft(x), n), 2),
    }
    fast, slow = {}, {}
    for line, (kernel, library, _) in lines.items():
        fast[f"{line} kernel"] = kernel
        fast[f"{line} library"] = library
        slow[f"{line} plain"] = _plain(kernel)
    ms = _loop_ms(fast, warmup=3, reps=20, samples=5)
    ms.update(_loop_ms(slow, warmup=1, reps=2, samples=3))
    logn = math.log2(n)
    for line, (_, _, width) in lines.items():
        if line.startswith("c2c"):   # the planes in and out
            nbytes = 4 * b * n * width
        else:   # R2C: x in, the half spectrum's planes out; C2R: back
            nbytes = 2 * (b * n * 4 + 2 * b * (n // 2 + 1) * width)
        bound = _bound(5.0 * b * n * logn * (2 if "cycle" in line else 1), PEAK_F32, nbytes)
        bound_ms, by = bound["bound_ms"], bound["bound_by"]
        for route in ("kernel", "plain", "library"):
            t = ms[f"{line} {route}"]
            print(f"[fft-times] {line:18s} {route:7s} b={b} N={n}: {t:.4f} ms = "
                  f"{2.0 * b * n * 8 / t / 1e6:.1f} GB/s (2·b·N·8/t) = "
                  f"{5.0 * b * n * logn / t / 1e9:.2f} TFLOP/s (5·N·log2 N) | bound {bound_ms:.4f} ms "
                  f"({by}), {bound_ms / t:.1%} of it | {card}", flush=True)
    for name, route in fftd["routes"].items():
        print(f"[fft-times] wall {name:36s} {_wall_ms(route, 5):.4f} ms per call "
              f"(host clock, 5 calls) | {card}", flush=True)
    return ms


TF32_TOL = 1e-5   # the reference's f32 verification rtol (core.dtypes.default_rtol), max-scaled


@contextlib.contextmanager
def _unpinned():
    """The C16 product sites with their f32 pin lifted: their products follow
    the caller's TF32 setting, as they did before the pin."""
    mods = (jacobi, sparse_ops, dense, mp_matmul, mp_pblas, overlap)
    saved = [m._f32_products for m in mods]
    for m in mods:
        m._f32_products = contextlib.nullcontext
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m._f32_products = f


def _bsr_case(gen, dev, m: int = 512, bs: int = 32):
    """A BSR matrix with about half of its (bs, bs) blocks present, and its
    dense float64 copy."""
    mb = m // bs
    present = torch.rand((mb, mb), generator=gen, device=dev) < 0.5
    present[:, 0] = True   # no empty block row
    blocks = torch.randn((mb, mb, bs, bs), generator=gen, device=dev)
    rows, cols = torch.nonzero(present, as_tuple=True)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(present.sum(1), 0).to(torch.int32)])
    data = blocks[rows, cols]
    bsr = sparse.BSR(indptr, cols.to(torch.int32), data, (m, m), bs)
    dense64 = (blocks * present[:, :, None, None]).permute(0, 2, 1, 3).reshape(m, m).double()
    return bsr, dense64, (rows, cols)


def _tf32_sites(gen, dev) -> dict:
    """The f32 product sites of ROADMAP C16 through their public functions at
    a small size, name: a function that runs the site and returns its
    errors against float64, max-scaled: the checks of the reference's tests
    (tests/test_solver_jacobi.py:24-55, tests/test_sparse.py:307-341,
    tests/test_solver_dense.py:93-100) at the f32 rtol."""
    g = torch.randn((4, 32, 32), generator=gen, device=dev)
    sym = (g + g.mT) / 2
    tall = torch.randn((4, 48, 32), generator=gen, device=dev)
    eye = torch.eye(32, device=dev).expand(4, 32, 32)
    bsr, a64, (rows, cols) = _bsr_case(gen, dev)
    xv = torch.randn(512, generator=gen, device=dev)
    p = torch.randn((512, 64), generator=gen, device=dev)
    q = torch.randn((64, 512), generator=gen, device=dev)
    pattern = sparse.BSR(bsr.indptr, bsr.indices, torch.zeros_like(bsr.data), bsr.shape, 32)
    qm = dense.xgeqrf(torch.randn((256, 256), generator=gen, device=dev))[0]
    c = torch.randn((256, 16), generator=gen, device=dev)

    def syevj():
        w, v, _, _ = jacobi.syevj(sym)
        return {"w": max_scaled_err(w, torch.linalg.eigvalsh(sym.double())),
                "VᵀV−I": max_scaled_err(v.double().mT @ v.double(), eye.double())}

    def gesvdj():
        u, sv, v, _, _ = jacobi.gesvdj(tall)
        return {"s": max_scaled_err(sv, torch.linalg.svdvals(tall.double())),
                "U·S·Vᵀ−A": max_scaled_err(u.double() @ torch.diag_embed(sv.double())
                                           @ v.double().mT, tall.double()),
                "VᵀV−I": max_scaled_err(v.double().mT @ v.double(), eye.double())}

    def spmv():
        return {"y": max_scaled_err(sparse.spmv(bsr, xv, alpha=2.0), 2.0 * a64 @ xv.double())}

    def sddmm():
        out = sparse.sddmm_bsr(p, q, pattern, alpha=1.0)
        full = (p.double() @ q.double()).reshape(16, 32, 16, 32).permute(0, 2, 1, 3)
        return {"blocks": max_scaled_err(out.data, full[rows, cols])}

    def ormqr():
        return {"QᵀC": max_scaled_err(dense.xormqr(qm, c, "L", "T"), qm.double().mT @ c.double())}

    return {"syevj (jacobi.py:127)": syevj, "gesvdj (jacobi.py:182, :185)": gesvdj,
            "spmv BSR (sparse/ops.py:103)": spmv, "sddmm_bsr (sparse/ops.py:115)": sddmm,
            "xormqr (solver/dense.py:159)": ormqr}


def _tf32_mp_sites(gen, dev) -> dict:
    """The f32 product sites of the Mp slice, through their public functions
    on MP_RANKS ranks at (m, k, n) = 256³, name: a function that runs the
    site and returns its errors against float64, max-scaled, held at
    MP_F64_TOL (tests/test_mp_matmul.py's and test_mp_pblas.py's rtol)."""
    grid = mp.Grid.create([dev] * MP_RANKS)
    m = 256
    a, b, c = (torch.randn((m, m), generator=gen, device=dev) for _ in range(3))
    a64, b64, c64 = a.double(), b.double(), c.double()
    low = torch.ones((m, m), device=dev, dtype=torch.bool).tril()
    solve = a + m * torch.eye(m, device=dev)

    def local_gemm():
        want = gemm.apply_epilogue(a64 @ b64, "gelu")[0]
        return {"D": _mp64_err(mp.matmul_ag(a, b, grid, epilogue="gelu"), want)}

    def reductions():
        return {"rs": _mp64_err(mp.matmul_rs(a, b, grid), a64 @ b64),
                "allreduce": _mp64_err(mp.matmul_allreduce(a, b, grid), a64 @ b64)}

    thin = a[:, :32]   # syrk's diagonal outweighs its other entries by about sqrt(k)

    def pblas():
        return {"syrk": _mp64_err(mp.mp_syrk(a, c, grid), torch.where(low, a64 @ a64.mT, c64)),
                "syrk k=32": _mp64_err(mp.mp_syrk(thin, c, grid),
                                       torch.where(low, a64[:, :32] @ a64[:, :32].mT, c64)),
                "syr2k": _mp64_err(mp.mp_syr2k(a, b, c, grid),
                                   torch.where(low, a64 @ b64.mT + b64 @ a64.mT, c64)),
                "syrkx": _mp64_err(mp.mp_syrkx(a, b, c, grid), torch.where(low, a64 @ b64.mT, c64)),
                "symm": _mp64_err(mp.mp_symm(a, b, c, grid), torch.where(low, a64, a64.mT) @ b64),
                "trmm": _mp64_err(mp.mp_trmm(a, b, grid), torch.tril(a64) @ b64)}

    def trsm():
        return {"X": _mp64_err(mp.mp_trsm(solve, b, grid), torch.linalg.solve_triangular(
            torch.tril(solve.double()), b64, upper=False))}

    def ring_plain():
        with _ring_plain():
            return {"ag": _mp64_err(overlap.matmul_ag_overlapped(a, b, grid), a64 @ b64),
                    "rs": _mp64_err(overlap.matmul_rs_overlapped(a, b, grid), a64 @ b64)}

    return {"mp _local_gemm (mp/matmul.py)": local_gemm,
            "mp matmul_rs/_allreduce (mp/matmul.py)": reductions,
            "mp PBLAS products (mp/pblas.py)": pblas,
            "mp_trsm's update (mp/pblas.py)": trsm,
            "mp _ring_gemm_plain (mp/overlap.py)": ring_plain}


def phase_tf32(dev) -> None:
    """With TF32 turned on by the caller, the f32 products the port pins must
    stay f32. First the matmul four-step FFT (_fft_planar, N = 96 and 1000):
    rel-L2 against float64 < 1e-5 (tests/test_fft_kernels.py:85), with the
    caller's setting back after, and a bare torch.matmul of one DFT stage
    beside it. Then the C16 sites (syevj, gesvdj, spmv on a BSR matrix,
    sddmm_bsr, xormqr) through their public functions against float64 at
    TF32_TOL, and the Mp slice's sites (``_tf32_mp_sites``) at MP_F64_TOL;
    each is also run with its pin lifted (``_unpinned``), to show what the
    pin keeps out. TF32 is turned off again at the end."""
    gen = torch.Generator(device=dev).manual_seed(9632)
    matmul = torch.backends.cuda.matmul
    failures = []
    torch.set_float32_matmul_precision("high")
    matmul.allow_tf32 = True
    try:
        for n in (96, 1000):
            xr = torch.randn((64, n), generator=gen, device=dev)
            xi = torch.randn((64, n), generator=gen, device=dev)
            got = _c128(*fft_kernels._fft_planar(xr, xi, False))
            err = _rel(got, torch.fft.fft(_c128(xr, xi)))
            restored = matmul.allow_tf32 and torch.get_float32_matmul_precision() == "high"
            w = torch.randn((n, n), generator=gen, device=dev)
            bare = _rel(xr @ w, xr.double() @ w.double())
            ok = err < 1e-5 and restored
            print(f"[tf32] TF32 on, _fft_planar N={n:4d}: rel-L2 vs f64 {err:.3e} (tol 1e-5), "
                  f"caller's setting restored {restored} | bare torch.matmul (64,{n})@({n},{n}) "
                  f"under TF32 {bare:.3e} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"_fft_planar N={n}")
        sites = [(name, site, TF32_TOL) for name, site in _tf32_sites(gen, dev).items()]
        sites += [(name, site, MP_F64_TOL) for name, site in _tf32_mp_sites(gen, dev).items()]
        for name, site, tol in sites:
            errs = site()
            with _unpinned():
                bare = site()
            restored = matmul.allow_tf32 and torch.get_float32_matmul_precision() == "high"
            ok = max(errs.values()) <= tol and restored
            print(f"[tf32] TF32 on, {name:30s} pinned: "
                  f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol {tol:g}) | "
                  f"pin lifted: {', '.join(f'{k} {v:.3e}' for k, v in bare.items())} "
                  f"({'would miss' if max(bare.values()) > tol else 'would pass'}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(name)
    finally:
        torch.set_float32_matmul_precision("highest")
        matmul.allow_tf32 = False
    if failures:
        raise SystemExit(f"chip_smoke: TF32 reached f32 products: {failures}")


SPMM_MAIN = (128, 128, 16, 128, 4096)   # (mb, nb, ellw, bs, k) of bench_spmm_bell
SPMV_MAIN = (128, 128, 32, 128)         # (mb, nb, ellw, bs) of bench_spmv_bell
AUTOPLAN_MAIN = (64, 64, 32, 128)       # (mb, nb, ellw, bs) of bench_spmv_autoplan
CSR_MAIN = (100_000, 32)                # (n, nnz per row) of bench_spmv
SPARSE_COUNTS = (spk.bell_spmm_pallas, spk._bell_spmv)


def _bell_cols(rng, mb, nb, ellw):
    """Sorted distinct block columns per block row, as the bench draws them
    (tpumathlib/benchmarks/__init__.py:124-125)."""
    return np.sort(rng.permuted(np.tile(np.arange(nb), (mb, 1)), axis=1)[:, :ellw],
                   axis=1).astype(np.int32)


def _bell_random(rng, gen, mb, nb, ellw, bs, dtype, dev, pads=None, n=None, m=None):
    """A Blocked-ELL on the card with normal blocks. pads = "zero" or
    "data": the last slot of every other block row becomes a pad slot, whose
    data is zeroed or left as it is."""
    cols = torch.from_numpy(_bell_cols(rng, mb, nb, ellw)).to(dev)
    data = torch.randn((mb, ellw, bs, bs), generator=gen, device=dev).to(dtype)
    if pads is not None:
        cols[::2, -1] = -1
        if pads == "zero":
            data[cols < 0] = 0
    return sparse.BlockedELL(cols, data, (m or mb * bs, n or nb * bs), bs)


def _spmm64(a, b):
    """A@B in float64 over the stored blocks (pad slots masked)."""
    return spk._bell_product(a.cols, a.data, b, a.shape, torch.float64)


def phase_sparse_kernel(dev) -> None:
    """tml_bell_spmm and tml_bell_spmv against their plain versions and
    float64 (on the host) on the card. Tolerances, max-scaled: 1e-5 for f32
    output (the same f32 products, summed in another order), 1e-2 for bf16
    or f16 output (an output ulp where the two f32 sums round apart)."""
    gen = torch.Generator(device=dev).manual_seed(6161)
    rng = np.random.default_rng(6161)
    chk = Checker()

    def hold(group, case, got, plain, f64, tol):
        chk.compare(group, case + " vs plain", got, plain, tol)
        chk.compare(group + " vs f64", case + " vs f64", got, f64, tol)

    pairs = ((F32, F32), (BF16, BF16), (BF16, F32), (F16, F16))
    for adt, bdt in pairs:
        for bs in (128, 256):
            for k in (1, 200, 1000, 4096):
                if adt == F16 and (bs, k) != (128, 200):
                    continue
                pads = "data" if k in (1, 1000) else "zero"
                a = _bell_random(rng, gen, 3, 5, 3, bs, adt, dev, pads=pads)
                b = torch.randn((5 * bs, k), generator=gen, device=dev).to(bdt)
                got = spk.bell_spmm_pallas(a, b, alpha=0.5)
                plain = spk._bell_spmm_plain(a, b, 0.5)
                torch.cuda.synchronize()
                want = 0.5 * _spmm64(sparse.BlockedELL(a.cols.cpu(), a.data.cpu(), a.shape, bs),
                                     b.cpu())
                group = f"spmm {str(adt)[6:]}x{str(bdt)[6:]}"
                hold(group, f"{group} bs={bs} k={k} pads={pads}", got, plain, want,
                     1e-5 if bdt == F32 else 1e-2)
    # a 3-D batched B: one launch for the batch
    a = _bell_random(rng, gen, 3, 5, 3, 128, BF16, dev, pads="data")
    b3 = torch.randn((3, 640, 100), generator=gen, device=dev).to(BF16)
    before = spk.bell_spmm_pallas.launches
    got = sparse.spmm(a, b3, alpha=0.5)
    torch.cuda.synchronize()
    one = spk.bell_spmm_pallas.launches - before == 1
    for i in range(3):
        want = 0.5 * _spmm64(sparse.BlockedELL(a.cols.cpu(), a.data.cpu(), a.shape, 128),
                             b3[i].cpu())
        hold("spmm batched", f"spmm batched B[{i}]", got[i], spk._bell_spmm_plain(a, b3[i], 0.5),
             want, 1e-2)
    if not one:
        chk.failures.append("spmm with a 3-D B did not take exactly one launch")

    # tml_bell_spmv through SpmvPlan: rowform true and false, ragged n, pads
    for what, bs, pads, ragged in (("rowform bs=128", 128, None, 0),
                                   ("bs=64", 64, None, 0),
                                   ("rowform bs=128 pads", 128, "data", 0),
                                   ("ragged n bs=128 pads", 128, "data", 37),
                                   ("ragged n bs=64", 64, "zero", 21)):
        mb, nb = 4, 6
        a = _bell_random(rng, gen, mb, nb, 5, bs, F32, dev, pads=pads,
                         n=nb * bs - ragged, m=mb * bs - (5 if ragged else 0))
        plan = spk.SpmvPlan(a)
        x = torch.randn((a.shape[1],), generator=gen, device=dev)
        got = plan.execute(x, alpha=0.5)
        plain = spk._bell_spmv_plain(plan.cols, plan.data, x, plan.shape, 0.5)
        torch.cuda.synchronize()
        want = 0.5 * _spmm64(sparse.BlockedELL(a.cols.cpu(), a.data.cpu(), a.shape, bs),
                             x.cpu()[:, None])[:, 0]
        hold("spmv", f"spmv {what} rowform={plan.rowform}", got, plain, want, 1e-5)

    for group, err in chk.worst.items():
        print(f"[sparse-kernel] {group:24s} worst max-scaled err {err:.3e}", flush=True)
    for f in chk.failures:
        print(f"[sparse-kernel] FAIL {f}", flush=True)
    if chk.failures:
        raise SystemExit(f"chip_smoke: {len(chk.failures)} of {chk.cases} sparse kernel cases "
                         f"disagree")
    print(f"[sparse-kernel] {chk.cases} cases agree with the plain versions and float64",
          flush=True)


def _hidden_block_csr(dev, mb, nb, ellw, bs):
    """bench_spmv_autoplan's CSR (tpumathlib/benchmarks/__init__.py:545-560):
    ellw random dense blocks per block row, stored as plain CSR rows."""
    rng = np.random.default_rng(0)
    m, n = mb * bs, nb * bs
    cols_blk = np.stack([np.sort(rng.choice(nb, ellw, replace=False)) for _ in range(mb)])
    rowlen = ellw * bs
    indptr = np.arange(m + 1, dtype=np.int64) * rowlen
    cidx = cols_blk[:, None, :, None] * bs + np.arange(bs)[None, None, None, :]
    cidx = np.broadcast_to(cidx, (mb, bs, ellw, bs)).reshape(-1)
    data = rng.normal(size=m * rowlen).astype(np.float32)
    return sparse.CSR(torch.from_numpy(indptr.astype(np.int32)).to(dev),
                      torch.from_numpy(cidx.astype(np.int32)).to(dev),
                      torch.from_numpy(data).to(dev), (m, n))


def _random_csr(dev, n, per_row):
    """bench_spmv's CSR (tpumathlib/benchmarks/__init__.py:91-97)."""
    rng = np.random.default_rng(0)
    nnz = n * per_row
    indptr = torch.from_numpy((np.arange(n + 1) * per_row).astype(np.int32)).to(dev)
    indices = torch.from_numpy(rng.integers(0, n, nnz).astype(np.int32)).to(dev)
    data = torch.from_numpy(rng.normal(size=nnz).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    return sparse.CSR(indptr, indices, data, (n, n)), x


def _library_csr(a, dtype=None):
    """torch's sparse CSR tensor (cuSPARSE) of the same matrix."""
    data = a.data if dtype is None else a.data.to(dtype)
    return torch.sparse_csr_tensor(a.indptr.long(), a.indices.long(), data, a.shape,
                                   check_invariants=False)


def _chain(product, x, calls: int):
    """``calls`` products fed back, as bench_spmv_bell's loop."""
    v = x
    for _ in range(calls):
        v = product(v)
    return v


def phase_sparse_main(dev) -> dict:
    """bench.py's sparse lines through the public entry points. Each
    kernel route must grow its kernel's count and is held against the plain
    version and float64: bf16 output 1e-2 max-scaled, f32 output 1e-5, the
    fed-back chain 1e-4 (20 products, each within 1e-6). The CSR route runs
    no kernel (the reference's is XLA) and is held against float64."""
    gen = torch.Generator(device=dev).manual_seed(2468)
    mb, nb, ellw, bs, k = SPMM_MAIN
    a_mm = sparse.BlockedELL(torch.from_numpy(_bell_cols(np.random.default_rng(0), mb, nb, ellw))
                             .to(dev), torch.randn((mb, ellw, bs, bs), generator=gen, device=dev)
                             .to(BF16), (mb * bs, nb * bs), bs)
    b_mm = torch.randn((nb * bs, k), generator=gen, device=dev).to(BF16)
    mb, nb, ellw, bs = SPMV_MAIN
    a_mv = sparse.BlockedELL(torch.from_numpy(_bell_cols(np.random.default_rng(0), mb, nb, ellw))
                             .to(dev), torch.randn((mb, ellw, bs, bs), generator=gen, device=dev),
                             (mb * bs, nb * bs), bs)
    x_mv = torch.randn((nb * bs,), generator=gen, device=dev)
    plan = sparse.SpmvPlan(a_mv)
    # alpha of the fed-back chain: a product grows the vector by about
    # sqrt(ellw·bs) (64 at the bench shape), so this keeps it near its size
    shrink = 1 / math.sqrt(ellw * bs)
    t0 = time.perf_counter()
    csr_ap = _hidden_block_csr(dev, *AUTOPLAN_MAIN)
    auto = sparse.SpmvAutoPlan(csr_ap)
    print(f"[sparse] SpmvAutoPlan analysis of {csr_ap.nnz} nnz on the host: "
          f"{time.perf_counter() - t0:.1f} s (CSR built and repacked), engine {auto.engine}, "
          f"stats {auto.stats}", flush=True)
    x_ap = torch.randn((csr_ap.shape[1],), generator=gen, device=dev)
    csr, x_csr = _random_csr(dev, *CSR_MAIN)
    routes = {
        "spmm(BlockedELL bf16, B bf16)": lambda: sparse.spmm(a_mm, b_mm),
        "SpmvPlan(BlockedELL f32).execute": lambda: plan.execute(x_mv),
        "SpmvPlan.execute x20 fed back": lambda: _chain(lambda v: plan.execute(v, shrink), x_mv, 20),
        "spmv(BlockedELL f32)": lambda: sparse.spmv(a_mv, x_mv),
        "SpmvAutoPlan(CSR).execute": lambda: auto.execute(x_ap),
        "spmv(CSR)": lambda: sparse.spmv(csr, x_csr),
    }
    kernel_of = {"spmm(BlockedELL bf16, B bf16)": "bell_spmm_pallas",
                 "SpmvPlan(BlockedELL f32).execute": "_bell_spmv",
                 "SpmvPlan.execute x20 fed back": "_bell_spmv",
                 "spmv(BlockedELL f32)": "bell_spmm_pallas",
                 "SpmvAutoPlan(CSR).execute": "_bell_spmv",
                 "spmv(CSR)": None}
    torch.cuda.synchronize()
    for f in SPARSE_COUNTS:
        f.launches = 0
    outs, grew = {}, {}
    for name, route in routes.items():
        before = {f.__name__: f.launches for f in SPARSE_COUNTS}
        outs[name] = route()
        grew[name] = {f.__name__: f.launches - before[f.__name__] for f in SPARSE_COUNTS}
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in SPARSE_COUNTS}
    print(f"[sparse] launches in the main path: {launches}", flush=True)

    def plain_chain(v0, f64):
        if f64:
            return _chain(lambda v: shrink * _spmm64(a_mv, v[:, None])[:, 0], v0.double(), 20)
        return _chain(lambda v: spk._bell_spmv_plain(plan.cols, plan.data, v, plan.shape, shrink),
                      v0, 20)

    sub = sparse.BlockedELL(a_mm.cols[:4], a_mm.data[:4], (4 * SPMM_MAIN[3], a_mm.shape[1]),
                            SPMM_MAIN[3])
    bell_ap = auto._bell
    checks = {   # name: (plain, float64 reference, the part of the output it covers, tol)
        "spmm(BlockedELL bf16, B bf16)": (lambda: spk._bell_spmm_plain(a_mm, b_mm),
                                          lambda: _spmm64(sub, b_mm), 4 * SPMM_MAIN[3], 1e-2),
        "SpmvPlan(BlockedELL f32).execute": (
            lambda: spk._bell_spmv_plain(plan.cols, plan.data, x_mv, plan.shape),
            lambda: _spmm64(a_mv, x_mv[:, None])[:, 0], None, 1e-5),
        "SpmvPlan.execute x20 fed back": (lambda: plain_chain(x_mv, False),
                                          lambda: plain_chain(x_mv, True), None, 1e-4),
        "spmv(BlockedELL f32)": (
            lambda: spk._bell_spmv_plain(plan.cols, plan.data, x_mv, plan.shape),
            lambda: _spmm64(a_mv, x_mv[:, None])[:, 0], None, 1e-5),
        "SpmvAutoPlan(CSR).execute": (
            lambda: spk._bell_spmv_plain(bell_ap.cols, bell_ap.data, x_ap, bell_ap.shape),
            lambda: _library_csr(csr_ap, torch.float64) @ x_ap.double(), None, 1e-5),
        "spmv(CSR)": (None, lambda: sparse.spmv(sparse.CSR(csr.indptr, csr.indices,
                                                            csr.data.double(), csr.shape),
                                                 x_csr.double()), None, 1e-5),
    }
    max_abs = {"bell_spmm_pallas": 0.0, "_bell_spmv": 0.0}
    failures = []
    for name, out in outs.items():
        plain_fn, f64_fn, rows, tol = checks[name]
        vs_plain = abs_err = 0.0
        if plain_fn is not None:
            plain = plain_fn()
            vs_plain, abs_err = max_scaled_err(out, plain), max_abs_rel(out, plain)[0]
            del plain
        vs_f64 = max_scaled_err(out if rows is None else out[:rows], f64_fn())
        kernel = kernel_of[name]
        launched = kernel is None or grew[name][kernel] >= 1
        if kernel is not None:
            max_abs[kernel] = max(max_abs[kernel], abs_err)
        finite = bool(torch.isfinite(out.float()).all())
        ok = vs_plain <= tol and vs_f64 <= tol and launched and finite
        if name == "SpmvAutoPlan(CSR).execute" and auto.engine != "blockedell":
            ok = False
        print(f"[sparse] {name:34s} launches {grew[name]} | {tuple(out.shape)} {out.dtype} "
              f"finite={finite} | vs plain max-scaled {vs_plain:.3e} max-abs {abs_err:.3e} "
              f"vs f64{'' if rows is None else f' (first {rows} rows)'} {vs_f64:.3e} "
              f"(tol {tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
    if failures:
        raise SystemExit(f"chip_smoke: sparse main path failed: {failures}")
    return {"launches": launches, "max_abs_err": max_abs, "routes": routes,
            "args": (a_mm, b_mm, a_mv, x_mv, plan, csr_ap, auto, x_ap, csr, x_csr)}


def phase_sparse_times(spd: dict, card: str) -> dict:
    """CUDA-event times of each sparse line of bench.py: the route, its
    plain version and the library call (torch.bmm of the (mb, bs, ellw·bs)
    block rows against the rows of B or x gathered beforehand, the gather
    timed apart; cuSPARSE through torch's sparse CSR tensor for the CSR
    lines); then each route of phase 16 on the host clock."""
    a_mm, b_mm, a_mv, x_mv, plan, csr_ap, auto, x_ap, csr, x_csr = spd["args"]

    def rows_and_gather(a, v):
        mb, ellw = a.cols.shape
        bs = a.blocksize
        rows = a.data.permute(0, 2, 1, 3).reshape(mb, bs, ellw * bs).contiguous()
        ids = a.cols.long()

        def gather():
            return v.reshape(-1, bs, v.shape[-1])[ids].reshape(mb, ellw * bs, v.shape[-1])
        return rows, gather

    rows_mm, gather_mm = rows_and_gather(a_mm, b_mm)
    rows_mv, gather_mv = rows_and_gather(a_mv, x_mv[:, None])
    g_mm, g_mv = gather_mm(), gather_mv()
    lib_ap, lib_csr = _library_csr(csr_ap), _library_csr(csr)
    bell_ap = auto._bell
    fast = {
        "spmm kernel": lambda: sparse.spmm(a_mm, b_mm),
        "spmm library": lambda: torch.bmm(rows_mm, g_mm),
        "spmm gather": gather_mm,
        "spmv kernel": lambda: plan.execute(x_mv),
        "spmv library": lambda: torch.bmm(rows_mv, g_mv),
        "spmv gather": gather_mv,
        "autoplan kernel": lambda: auto.execute(x_ap),
        "autoplan library": lambda: lib_ap @ x_ap,
        "csr route": lambda: sparse.spmv(csr, x_csr),
        "csr library": lambda: lib_csr @ x_csr,
    }
    slow = {
        "spmm plain": lambda: spk._bell_spmm_plain(a_mm, b_mm),
        "spmv plain": lambda: spk._bell_spmv_plain(plan.cols, plan.data, x_mv, plan.shape),
        "autoplan plain": lambda: spk._bell_spmv_plain(bell_ap.cols, bell_ap.data, x_ap,
                                                       bell_ap.shape),
    }
    ms = _loop_ms(fast, warmup=3, reps=20, samples=5)
    ms.update(_loop_ms(slow, warmup=1, reps=2, samples=3))

    mb, nb, ellw, bs, k = SPMM_MAIN
    nnz_mm = mb * ellw * bs * bs
    spmm_bytes = 2 * (nnz_mm + 2 * nb * bs * k)          # A, B and Y in bf16
    mb, nb, ellw, bs = SPMV_MAIN
    nnz_mv, n_mv = mb * ellw * bs * bs, nb * bs
    mb, nb, ellw, bs = AUTOPLAN_MAIN
    nnz_ap = mb * ellw * bs * bs
    n_csr, per_row = CSR_MAIN
    lines = {   # line: (flop, bytes as bench.py counts them, the rate's unit, bound)
        "spmm": (2.0 * nnz_mm * k, spmm_bytes, "TFLOP/s", _bound(2.0 * nnz_mm * k, PEAK_BF16,
                                                                 spmm_bytes)),
        "spmv": (2.0 * nnz_mv, nnz_mv * 4 + 2 * n_mv * 4, "GB/s",
                 _bound(2.0 * nnz_mv, PEAK_F32, nnz_mv * 4 + 2 * n_mv * 4)),
        "autoplan": (2.0 * nnz_ap, nnz_ap * 4 + 2 * mb * bs * 4, "GB/s",
                     _bound(2.0 * nnz_ap, PEAK_F32, nnz_ap * 4 + 2 * mb * bs * 4)),
        "csr": (2.0 * n_csr * per_row, n_csr * per_row * 12 + n_csr * 8, "GB/s",
                _bound(2.0 * n_csr * per_row, PEAK_F32, n_csr * per_row * 12 + n_csr * 8)),
    }
    for line, (flop, nbytes, unit, bound) in lines.items():
        if f"{line} gather" in ms:   # the library call's operand, not the function
            print(f"[sparse-times] {line:8s} gather  {ms[f'{line} gather']:.4f} ms (the rows "
                  f"torch.bmm takes, gathered; not in its time) | {card}", flush=True)
        for route in ("kernel", "route", "plain", "library"):
            t = ms.get(f"{line} {route}")
            if t is None:
                continue
            rate = flop / t / 1e9 if unit == "TFLOP/s" else nbytes / t / 1e6
            print(f"[sparse-times] {line:8s} {route:7s} {t:.4f} ms = {rate:.2f} {unit} | bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), {bound['bound_ms'] / t:.1%} "
                  f"of it | {card}", flush=True)
    for name, route in spd["routes"].items():
        print(f"[sparse-times] wall {name:34s} {_wall_ms(route, 5):.4f} ms per call "
              f"(host clock, 5 calls) | {card}", flush=True)
    ms["bounds"] = {line: v[3] for line, v in lines.items()}
    return ms


DX_KERNEL_NS = (8, 16, 24, 32, 48, 64, 128, 256)   # phase 18's sizes (256 works in place)
DX_KERNEL_BATCH = 37                                # a batch that is a multiple of nothing
DX_MAIN = (8192, 32)   # (batch, n) of bench.py's batched lines (bench.py:366)
DX_WIDE = (1024, 128)  # (batch, n) of the _run_batched route
DX_K = 4               # right-hand sides of gesv and posv
DX_COUNTS = (dxs._potrf, dxs._getrf, dxs._geqrf, pallas_matmul)
# Max-scaled tolerance of each kernel's factors against its plain version, on
# the matrices whose pivots agree. The kernels contract multiply-adds to FMAs
# and sum in their own order, and elimination carries those roundings on, so
# the two agree to rounding only. PERF.md records the sound run's maxima under
# these and the bf16 control (_dx_control) above them.
DX_TOL = {"potrf": 1e-5, "getrf": 1e-4, "geqrf": 1e-4}


def _dx_spd(gen, b, n, dev):
    """SPD input as bench.py:367-368: G·Gᵀ + n·I."""
    g = torch.randn((b, n, n), generator=gen, device=dev)
    return g @ g.mT + n * torch.eye(n, device=dev)


def _amax(x):
    return x.abs().flatten(1).amax(dim=1)


def _swap_rows(a, piv):
    """a with each batch's row-swap sequence piv applied, j = 0 … n−1."""
    a = a.clone()
    rows = torch.arange(a.shape[0], device=a.device)
    for j in range(piv.shape[1]):
        p = piv[:, j].long()
        row_j = a[rows, j].clone()
        a[rows, j] = a[rows, p]
        a[rows, p] = row_j
    return a


def _chol_residual(a, l) -> float:
    """max over the batch of max|L·Lᵀ − A| / max|A|, in float64."""
    a64, l64 = a.double(), l.double()
    return float((_amax(l64 @ l64.mT - a64) / _amax(a64)).max())


def _lu_residual(a, lu, piv) -> tuple[float, float]:
    """(max over the batch of max|P·A − L·U| / max|A|, max|L|), in float64."""
    a64, lu64 = a.double(), lu.double()
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    l = torch.tril(lu64, -1) + eye
    res = _amax(l @ torch.triu(lu64) - _swap_rows(a64, piv)) / _amax(a64)
    return float(res.max()), float(l.abs().max())


def _q_of(qr, taus):
    """Q = H_0 ⋯ H_{n−1} (m × m) from geqrf's reflectors of an m × n QR,
    m ≥ n (v_j = 1, below it qr's column j), in float64."""
    qr64, t64 = qr.double(), taus.double()
    b, m, n = qr.shape
    q = torch.eye(m, dtype=torch.float64, device=qr.device).repeat(b, 1, 1)
    rows = torch.arange(m, device=qr.device)
    for j in reversed(range(n)):
        v = torch.where(rows > j, qr64[:, :, j], (rows == j).double())
        q -= t64[:, j, None, None] * v[:, :, None] * (v[:, None, :] @ q)
    return q


def _qr_residual(a, qr, taus) -> tuple[float, float]:
    """(max|Q·R − A| / max|A|, max|QᵀQ − I|), worst over the batch, float64."""
    q = _q_of(qr, taus)
    a64 = a.double()
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    res = _amax(q @ torch.triu(qr.double()) - a64) / _amax(a64)
    return float(res.max()), float(_amax(q.mT @ q - eye).max())


def _solve_residual(a, x, b) -> float:
    """Normwise backward error, worst over the batch:
    max|A·X − B| / (n·max|A|·max|X| + max|B|), in float64."""
    a64, x64, b64 = a.double(), x.double(), b.double()
    n = a.shape[-1]
    return float((_amax(a64 @ x64 - b64) / (n * _amax(a64) * _amax(x64) + _amax(b64))).max())


def _pivots_agree(piv, piv_plain):
    """Per matrix: the kernel's and the plain version's pivots are the same."""
    return (piv == piv_plain).all(dim=1)


def _dx_control(kind: str, m) -> float:
    """Max-scaled distance of the plain version on m from the plain version
    on m rounded to bf16 (on matrices whose pivots agree): what a kernel that
    lost f32 precision would show. DX_TOL[kind] must sit below it."""
    lo = m.to(BF16).to(F32)
    if kind == "potrf":
        return max_scaled_err(dxs._potrf_plain(lo), dxs._potrf_plain(m))
    if kind == "geqrf":
        (q_lo, t_lo), (q, t) = dxs._geqrf_plain(lo), dxs._geqrf_plain(m)
        return max(max_scaled_err(q_lo, q), max_scaled_err(t_lo, t))
    (lu_lo, p_lo), (lu, p) = dxs._getrf_plain(lo), dxs._getrf_plain(m)
    agree = _pivots_agree(p_lo, p)
    return max_scaled_err(lu_lo[agree], lu[agree])


def phase_dx_kernel(dev) -> None:
    """The three kernels of csrc/dx_solver.cu against their plain versions
    and float64 on the host, at n = 8 … 256 (n = 256 takes the instantiation
    that works in place in device memory) and a batch of 37. Against the
    plain version, max-scaled, DX_TOL on the factors of the matrices whose
    pivots agree (the kernels' FMAs and order of summation round otherwise,
    and a near-tie may pick another pivot: the count of matrices whose
    pivots differ is printed, at most 3 of 37); a solution's difference,
    over the matrix's condition number, 5e-5 (the factors' differences
    passed through two substitutions). The tight checks are the float64
    residuals, which do not depend on the order of the roundings: L·Lᵀ − A,
    P·A − L·U and Q·R − A below 5e-5 of max|A| (phase 7's bound), QᵀQ − I
    below 5e-5, |L| ≤ 1 with pivoting, and the solves' normwise backward
    error below 1e-5. At n = 32 and 128 the bf16 control (_dx_control) must
    exceed each tolerance. Then the cases of ROADMAP C10 and C11, ties and
    a zero column."""
    gen = torch.Generator(device=dev).manual_seed(7373)
    failures, cases = [], 0

    def hold(what, ok, detail):
        nonlocal cases
        cases += 1
        if not ok:
            failures.append(what)
        print(f"[dx-kernel] {what:34s} {detail} {'ok' if ok else 'FAIL'}", flush=True)

    bsz = DX_KERNEL_BATCH
    for n in DX_KERNEL_NS:
        spd = _dx_spd(gen, bsz, n, dev)
        g = torch.randn((bsz, n, n), generator=gen, device=dev)
        dom = g + n * torch.eye(n, device=dev)
        where = "in place" if dxs._smem_bytes(n, 0) > dxs.SMEM_MAX else "shared"
        l, l_p = dxs._potrf(spd), dxs._potrf_plain(spd)
        torch.cuda.synchronize()
        l64 = torch.linalg.cholesky(spd.double().cpu())
        vs_p, vs_64 = max_scaled_err(l, l_p), max_scaled_err(l, l64)
        res = _chol_residual(spd.cpu(), l.cpu())
        hold(f"potrf n={n} ({where})", vs_p <= DX_TOL["potrf"] and vs_64 < 5e-5 and res < 5e-5
             and bool(torch.isfinite(l).all()) and bool((torch.triu(l, 1) == 0).all()),
             f"vs plain {vs_p:.3e} vs f64 {vs_64:.3e} LLᵀ−A {res:.3e}")
        for pivot, m in ((True, g), (False, dom)):
            (lu, piv), (lu_p, piv_p) = dxs._getrf(m, pivot), dxs._getrf_plain(m, pivot)
            torch.cuda.synchronize()
            agree = _pivots_agree(piv, piv_p)
            vs_p = max_scaled_err(lu[agree], lu_p[agree]) if bool(agree.any()) else 0.0
            res, lmax = _lu_residual(m.cpu(), lu.cpu(), piv.cpu())
            in_range = bool(((piv >= 0) & (piv < n)).all())
            hold(f"getrf pivot={pivot} n={n} ({where})",
                 vs_p <= DX_TOL["getrf"] and res < 5e-5 and (lmax <= 1 + 1e-6 or not pivot)
                 and in_range
                 and int((~agree).sum()) <= 3,
                 f"pivots differ in {int((~agree).sum())}/{bsz} | vs plain {vs_p:.3e} "
                 f"PA−LU {res:.3e} max|L| {lmax:.4f}")
        (qr, taus), (qr_p, taus_p) = dxs._geqrf(g), dxs._geqrf_plain(g)
        torch.cuda.synchronize()
        vs_p = max(max_scaled_err(qr, qr_p), max_scaled_err(taus, taus_p))
        res, orth = _qr_residual(g.cpu(), qr.cpu(), taus.cpu())
        hold(f"geqrf n={n} ({where})", vs_p <= DX_TOL["geqrf"] and res < 5e-5 and orth < 5e-5,
             f"vs plain {vs_p:.3e} QR−A {res:.3e} QᵀQ−I {orth:.3e}")
        if n in (32, 128):
            for kind, m in (("potrf", spd), ("getrf", g), ("geqrf", g)):
                ctl = _dx_control(kind, m)
                hold(f"{kind} bf16 control n={n}", ctl > DX_TOL[kind],
                     f"{ctl:.3e} above the tolerance {DX_TOL[kind]:g}")
        piv_agree = _pivots_agree(dxs._getrf(g)[1], dxs._getrf_plain(g)[1])
        for k in (1, DX_K):
            rhs = torch.randn((bsz, n, k), generator=gen, device=dev)
            for kind, m, run, plain in (("gesv", g, lambda m, b: dxs._getrf(m, True, b),
                                         dxs._gesv_plain),
                                        ("posv", spd, dxs._potrf, dxs._posv_plain)):
                x, x_p = run(m, rhs), plain(m, rhs)
                torch.cuda.synchronize()
                sel = piv_agree if kind == "gesv" else torch.ones_like(piv_agree)
                # a solution's difference grows with the matrix's condition
                cond = torch.linalg.cond(m[sel].double().cpu())
                fwd = float(((x[sel] - x_p[sel]).double().cpu().flatten(1).abs().amax(1)
                             / _amax(x_p[sel].double().cpu()).clamp(min=1) / cond).max())
                res = _solve_residual(m.cpu(), x.cpu(), rhs.cpu())
                hold(f"{kind} n={n} k={k} ({where})", fwd <= 5e-5 and res < 1e-5
                     and bool(torch.isfinite(x).all()),
                     f"vs plain / cond {fwd:.3e} backward error {res:.3e}")

    for n in (32, 48):   # ties: -5 at row 7 and 5 at row 12 give pivot 7
        m = 0.01 * torch.randn((3, n, n), generator=gen, device=dev)
        m[:, 7, 0], m[:, 12, 0] = -5.0, 5.0
        p0 = dxs._getrf(m)[1][:, 0].tolist()
        hold(f"tie n={n}", p0 == [7, 7, 7] == dxs._getrf_plain(m)[1][:, 0].tolist(),
             f"pivots {p0}")
    # C10: a non-SPD matrix among SPD ones: NaN from its failing column on,
    # the neighbours equal to their standalone factors
    spd = _dx_spd(gen, 8, 32, dev)
    spd[2, 10, 10] = -1e4
    l = dxs._potrf(spd)
    low = torch.tril(torch.ones((32, 32), dtype=torch.bool, device=dev))
    alone = all(torch.equal(l[i], dxs._potrf(spd[i:i + 1])[0]) for i in range(8) if i != 2)
    pattern = bool(torch.isfinite(l[2][:, :10]).all() and l[2][10:, 10:][low[10:, 10:]].isnan().all())
    same = torch.equal(l.isnan(), dxs._potrf_plain(spd).isnan())
    hold("C10 non-SPD among SPD n=32", alone and pattern and same,
         f"neighbours alone {alone}, NaN from column 10 on {pattern}, as plain {same}")
    # C11: NaN in a pivot column: pivots in range, the first NaN row, NaN in LU
    for n in (32, 48):
        m = torch.randn((3, n, n), generator=gen, device=dev)
        m[0, 5, 0] = m[0, 9, 0] = float("nan")
        lu, piv = dxs._getrf(m)
        piv_p = dxs._getrf_plain(m)[1]
        ok = (bool(((piv >= 0) & (piv < n)).all()) and int(piv[0, 0]) == 5
              and bool(lu[0].isnan().any()) and torch.equal(piv, piv_p))
        hold(f"C11 NaN in pivot column n={n}", ok,
             f"piv[0][:4] {piv[0, :4].tolist()}, NaN in LU {bool(lu[0].isnan().any())}")
    m = torch.randn((2, 32, 32), generator=gen, device=dev)
    m[0, :, 5] = 0.0
    m[1, 0, 0] = 0.0
    (qr, taus), (qr_p, taus_p) = dxs._geqrf(m), dxs._geqrf_plain(m)
    err = max(max_scaled_err(qr, qr_p), max_scaled_err(taus, taus_p))
    hold("geqrf zero column, x_j = 0", float(taus[0, 5]) == 0.0 and err <= DX_TOL["geqrf"],
         f"tau {float(taus[0, 5])} vs plain {err:.3e}")
    if failures:
        raise SystemExit(f"chip_smoke: {len(failures)} of {cases} dx solver cases failed: {failures}")
    print(f"[dx-kernel] {cases} cases agree", flush=True)


def _dx_inputs(gen, dev):
    b, n = DX_MAIN
    bw, nw = DX_WIDE
    g = torch.randn((b, n, n), generator=gen, device=dev)
    return {"spd": _dx_spd(gen, b, n, dev), "g": g, "dom": g + n * torch.eye(n, device=dev),
            "rhs": torch.randn((b, n, DX_K), generator=gen, device=dev),
            "spd_w": _dx_spd(gen, bw, nw, dev),
            "g_w": torch.randn((bw, nw, nw), generator=gen, device=dev),
            "big": _spd(gen, SOLVER_N, dev)}


def _dx_routes(x):
    """name: (public call, its kernel's counter, its plain version, its
    library call); the kernel counter's name as in DX_COUNTS."""
    spd, g, dom, rhs, spd_w, g_w, big = (x[k] for k in ("spd", "g", "dom", "rhs", "spd_w", "g_w",
                                                       "big"))
    return {
        "potrf_batched b8192 n32": (lambda: dxs.potrf_batched(spd), "_potrf",
                                    lambda: dxs._potrf_plain(spd),
                                    lambda: torch.linalg.cholesky_ex(spd)),
        "getrf_batched b8192 n32": (lambda: dxs.getrf_batched(g), "_getrf",
                                    lambda: dxs._getrf_plain(g, True),
                                    lambda: torch.linalg.lu_factor_ex(g)),
        "getrf_batched nopivot b8192 n32": (lambda: dxs.getrf_batched(dom, pivot=False), "_getrf",
                                            lambda: dxs._getrf_plain(dom, False),
                                            lambda: torch.linalg.lu_factor_ex(dom, pivot=False)),
        "geqrf_batched b8192 n32": (lambda: dxs.geqrf_batched(g), "_geqrf",
                                    lambda: dxs._geqrf_plain(g), lambda: torch.geqrf(g)),
        "gesv_batched b8192 n32 k4": (lambda: dxs.gesv_batched(g, rhs), "_getrf",
                                      lambda: dxs._gesv_plain(g, rhs),
                                      lambda: torch.linalg.solve(g, rhs)),
        "posv_batched b8192 n32 k4": (lambda: dxs.posv_batched(spd, rhs), "_potrf",
                                      lambda: dxs._posv_plain(spd, rhs),
                                      lambda: torch.linalg.solve(spd, rhs)),
        "potrf_batched b1024 n128": (lambda: dxs.potrf_batched(spd_w), "_potrf",
                                     lambda: dxs._potrf_plain(spd_w),
                                     lambda: torch.linalg.cholesky_ex(spd_w)),
        "getrf_batched b1024 n128": (lambda: dxs.getrf_batched(g_w), "_getrf",
                                     lambda: dxs._getrf_plain(g_w, True),
                                     lambda: torch.linalg.lu_factor_ex(g_w)),
        "potrf_blocked n4096": (lambda: dxs.potrf_blocked(big), "_potrf", None,
                                lambda: torch.linalg.cholesky(big)),
    }


def phase_dx_main(dev) -> dict:
    """The batched solver slice through the public functions: bench.py's
    batch 8192 × n 32 (potrf and getrf through the packed routes, geqrf,
    gesv and posv with 4 right-hand sides), potrf and getrf at batch 1024 ×
    n 128, and potrf_blocked at n = 4096. Each must grow its kernel's count
    (potrf_blocked also B1's). Held against the plain version (DX_TOL on
    factors where the pivots agree, which at most 1 in 128 matrices may not;
    solutions over the matrix's condition, 5e-5) and the residuals of phase
    18; potrf_blocked against a float64 factor (5e-5)."""
    gen = torch.Generator(device=dev).manual_seed(8192)
    x = _dx_inputs(gen, dev)
    routes = _dx_routes(x)
    torch.cuda.synchronize()
    for f in DX_COUNTS:
        f.launches = 0
    outs, grew = {}, {}
    for name, (route, _, _, _) in routes.items():
        before = {f.__name__: f.launches for f in DX_COUNTS}
        outs[name] = route()
        grew[name] = {f.__name__: f.launches - before[f.__name__] for f in DX_COUNTS}
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in DX_COUNTS}
    print(f"[dx] launches in the main path: {launches}", flush=True)

    piv_agree = None
    max_abs, failures = {}, []
    for name, (_, count, plain_fn, _) in routes.items():
        out = outs[name]
        launched = grew[name][count] >= 1
        if name == "potrf_blocked n4096":
            launched = launched and grew[name]["pallas_matmul"] >= 1
            big = x["big"]
            rel = float((out.double() - torch.linalg.cholesky(big.double())).abs().max()
                        / big.double().abs().max())
            ok = rel < 5e-5 and launched and bool(torch.isfinite(out).all())
            detail = f"vs f64 cholesky {rel:.3e} (tol 5e-5)"
            max_abs[name] = 0.0
        else:
            plain = plain_fn()
            if name.startswith(("potrf", "posv")):
                m = x["spd"] if name.endswith(("n32", "k4")) else x["spd_w"]
            elif "nopivot" in name:
                m = x["dom"]
            else:
                m = x["g"] if name.endswith(("n32", "k4")) else x["g_w"]
            if name.startswith("potrf"):
                vs_p = max_scaled_err(out, plain)
                max_abs[name] = max_abs_rel(out, plain)[0]
                res = _chol_residual(m, out)
                ok = (vs_p <= DX_TOL["potrf"] and res < 5e-5
                      and bool((torch.triu(out, 1) == 0).all()))
                detail = f"vs plain {vs_p:.3e} LLᵀ−A {res:.3e}"
            elif name.startswith("getrf"):
                (lu, piv), (lu_p, piv_p) = out, plain
                agree = _pivots_agree(piv, piv_p)
                if name == "getrf_batched b8192 n32":
                    piv_agree = agree
                vs_p = max_scaled_err(lu[agree], lu_p[agree])
                max_abs[name] = max_abs_rel(lu[agree], lu_p[agree])[0]
                res, lmax = _lu_residual(m, lu, piv)
                ok = (vs_p <= DX_TOL["getrf"] and res < 5e-5
                      and ("nopivot" in name or lmax <= 1 + 1e-6)
                      and int((~agree).sum()) <= m.shape[0] // 128)
                detail = (f"pivots differ in {int((~agree).sum())}/{m.shape[0]} | vs plain "
                          f"{vs_p:.3e} PA−LU {res:.3e} max|L| {lmax:.4f}")
            elif name.startswith("geqrf"):
                vs_p = max(max_scaled_err(out[0], plain[0]), max_scaled_err(out[1], plain[1]))
                max_abs[name] = max(max_abs_rel(out[0], plain[0])[0],
                                    max_abs_rel(out[1], plain[1])[0])
                res, orth = _qr_residual(m, *out)
                ok = vs_p <= DX_TOL["geqrf"] and res < 5e-5 and orth < 5e-5
                detail = f"vs plain {vs_p:.3e} QR−A {res:.3e} QᵀQ−I {orth:.3e}"
            else:
                sel = piv_agree if name.startswith("gesv") else torch.ones(
                    m.shape[0], dtype=torch.bool, device=dev)
                cond = torch.linalg.cond(m[sel].double())
                diff = (out[sel] - plain[sel]).double().flatten(1).abs().amax(1)
                fwd = float((diff / _amax(plain[sel].double()).clamp(min=1) / cond).max())
                max_abs[name] = max_abs_rel(out[sel], plain[sel])[0]
                res = _solve_residual(m, out, x["rhs"])
                ok = fwd <= 5e-5 and res < 1e-5
                detail = f"vs plain / cond {fwd:.3e} backward error {res:.3e}"
            del plain
            ok = ok and launched and all(bool(torch.isfinite(t).all()) for t in
                                         (out if isinstance(out, tuple) else (out,)))
        print(f"[dx] {name:32s} launches {grew[name]} | {detail} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(name)
    if failures:
        raise SystemExit(f"chip_smoke: dx solver main path failed: {failures}")
    return {"launches": launches, "grew": grew, "max_abs_err": max_abs, "routes": routes}


def _dx_bound(name: str) -> dict:
    """The bound of a line of phase 20: inputs read and outputs written
    once, f32 (of A only the lower triangle for potrf and posv, which read
    no more), and its flop at the f32 peak (potrf n³/3, getrf 2n³/3, geqrf
    4n³/3 a matrix, and 2n²k for a solve's two substitutions)."""
    b, n = DX_WIDE if "n128" in name else DX_MAIN
    if name.startswith("potrf_blocked"):
        b, n = 1, SOLVER_N
    k = DX_K if name.startswith(("gesv", "posv")) else 0
    flop = {"potrf": n**3 / 3, "posv": n**3 / 3, "getrf": 2 * n**3 / 3, "gesv": 2 * n**3 / 3,
            "geqrf": 4 * n**3 / 3}[name.split("_")[0]] + 2 * n * n * k
    a_words = n * (n + 1) // 2 if name.startswith(("potrf", "posv")) else n * n
    if k:
        nbytes = 4 * b * (a_words + 2 * n * k)   # A and B read, X written
    else:
        extra = n if name.startswith(("getrf", "geqrf")) else 0   # piv or taus
        nbytes = 4 * b * (a_words + n * n + extra)
    return _bound(b * flop, PEAK_F32, nbytes)


def phase_dx_times(dxd: dict, card: str) -> dict:
    """CUDA events around back-to-back calls (``_loop_ms``) of each route of
    phase 19, its plain version and its library call (torch.linalg's
    cholesky_ex, lu_factor_ex with pivot on and off, torch.geqrf,
    torch.linalg.solve for gesv and posv, torch.linalg.cholesky for
    potrf_blocked), each beside its bound."""
    fast, slow = {}, {}
    for name, (route, _, plain, library) in dxd["routes"].items():
        target = slow if name.startswith("potrf_blocked") else fast
        target[f"{name} kernel"] = route
        target[f"{name} library"] = library
        if plain is not None:
            slow[f"{name} plain"] = plain
    ms = _loop_ms(fast, warmup=3, reps=20, samples=5)
    ms.update(_loop_ms(slow, warmup=1, reps=2, samples=3))
    bounds = {}
    for name in dxd["routes"]:
        bounds[name] = bound = _dx_bound(name)
        for route in ("kernel", "plain", "library"):
            t = ms.get(f"{name} {route}")
            if t is not None:
                print(f"[dx-times] {name:32s} {route:7s} {t:.4f} ms | bound {bound['bound_ms']:.4f} "
                      f"ms ({bound['bound_by']}), {bound['bound_ms'] / t:.1%} of it | {card}",
                      flush=True)
    ms["bounds"] = bounds
    return ms


DXE_KERNEL_NS = (2, 7, 16, 31, 32, 63, 64)   # phase 21's Jacobi sizes
DXE_LSQ = ((32, 32), (64, 32), (48, 10))     # phase 21's (m, n) of gels and unmqr
DXE_GELS = (8192, 64, 32, 4)   # (batch, m, n, k): 8192 fits of 32 coefficients to 64 samples
DXE_SQ = (8192, 32)            # (batch, n) of unmqr (k = 4), syevd and gesvd
DXE_WIDE = (2048, 64)          # (batch, n) of syevd and gesvd at the reference's largest n
XSYEVD_N = 2048                # bench.py:354-362
XGESVD_N = 4096
DXE_COUNTS = (dxs._unmqr, dxs._gels, dxs._syevd, dxs._gesvd)
# Tolerances of each kernel against its plain version (kernels B7e-B7h): values
# (w, s) max-scaled; vectors signed and scaled by their gap (_vec_err); X over
# max|X| and A's condition (_x_err); Q·C max-scaled. Set from the card's
# readings recorded in PERF.md §6 (maxima 4.0e-6, 7.2e-7, 1.4e-7 and 6.2e-7
# on an H100 at 700 W); a bf16 control sits above each.
DXE_TOL = {"values": 1e-5, "vectors": 1e-5, "x": 1e-6, "qc": 1e-5}


@contextlib.contextmanager
def _dx_plain():
    """The public functions of dx.solver with the four new kernels' plain
    versions in their wrappers' place."""
    saved = dxs._unmqr, dxs._gels, dxs._syevd, dxs._gesvd
    dxs._unmqr, dxs._gels = dxs._apply_q_plain, dxs._gels_plain
    dxs._syevd, dxs._gesvd = dxs._syevd_plain, dxs._gesvd_plain
    try:
        yield
    finally:
        dxs._unmqr, dxs._gels, dxs._syevd, dxs._gesvd = saved


def _plain_of(route):
    def run():
        with _dx_plain():
            return route()
    return run


def _vec_err(v, v_ref, values) -> float:
    """Worst column of v against v_ref, signs aligned, its largest difference
    times its value's gap to the neighbouring values over the largest value:
    a vector is only as well defined as its gap."""
    v, v_ref, values = v.double(), v_ref.double(), values.double()
    sign = torch.sign((v * v_ref).sum(-2, keepdim=True))
    err = (v * torch.where(sign == 0, 1.0, sign) - v_ref).abs().amax(-2)
    d = (values[:, 1:] - values[:, :-1]).abs()
    inf = torch.full_like(d[:, :1], math.inf)
    gap = torch.minimum(torch.cat([inf, d], 1), torch.cat([d, inf], 1))
    return float((err * gap / values.abs().amax(1, keepdim=True)).max())


def _x_err(a, x, x_ref) -> float:
    """max|X − X_ref| / max(max|X_ref|, 1) over A's condition, worst matrix."""
    diff = (x - x_ref).double().flatten(1).abs().amax(1)
    return float((diff / _amax(x_ref.double()).clamp(min=1) / torch.linalg.cond(a.double())).max())


def _eig_f64(a, w, v) -> tuple[float, float, float]:
    """(|w − w64| / max|w64|, max|AV − VΛ| / (max|A|·n), max|VᵀV − I|),
    worst over the batch, in float64 (the reference test's measures)."""
    a64, w64, v64 = a.double(), w.double(), v.double()
    n = a.shape[-1]
    wt = torch.linalg.eigvalsh(a64)
    e_w = float(((w64 - wt).abs().amax(1) / wt.abs().amax(1)).max())
    res = float(((a64 @ v64 - v64 * w64[:, None, :]).flatten(1).abs().amax(1) / (_amax(a64) * n)).max())
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    return e_w, res, float((v64.mT @ v64 - eye).abs().max())


def _svd_f64(a, u, s, vt, st=None) -> tuple[float, float, float]:
    """(|s − s64| / max s64, max|U·S·Vᵀ − A| / (max|A|·n), max of |UᵀU − I|
    and |VᵀV − I|), worst over the batch, in float64; st: A's float64
    singular values, if already known."""
    a64, u64, s64, vt64 = a.double(), u.double(), s.double(), vt.double()
    n = a.shape[-1]
    st = torch.linalg.svdvals(a64) if st is None else st
    e_s = float(((s64 - st).abs().amax(1) / st.amax(1)).max())
    rec = float((((u64 * s64[:, None, :]) @ vt64 - a64).flatten(1).abs().amax(1)
                 / (_amax(a64) * n)).max())
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    orth = max(float((u64.mT @ u64 - eye).abs().max()), float((vt64 @ vt64.mT - eye).abs().max()))
    return e_s, rec, orth


def _gesvdj_f64(a, u, s, v) -> tuple[float, float, float, float]:
    """Float64 gesvdj against what its stopping test (ROADMAP C13) can
    promise, worst over the batch: (the largest off-diagonal entry of G =
    (U·S)ᵀ(U·S) over ‖A‖²_F; max |s² − σ²| less ‖off(G)‖_F, over ‖A‖²_F,
    which Weyl's theorem puts at rounding; max|UᵀU − I|; max|VᵀV − I|). The
    stop fires once G's off-diagonal squares vanish below the last bit of
    ‖G‖²_F, at about √eps·‖A‖²_F, so U's columns p, q are orthogonal only to
    that over σ_p·σ_q, as in the reference."""
    us = u * s[:, None, :]
    g = us.mT @ us
    off = g - torch.diag_embed(torch.diagonal(g, dim1=1, dim2=2))
    fro2 = a.double().square().sum((1, 2))
    st = torch.linalg.svdvals(a.double())
    weyl = (s.square() - st.square()).abs().amax(1) - torch.linalg.matrix_norm(off)
    eye = torch.eye(v.shape[-1], dtype=torch.float64, device=v.device)
    return (float((off.abs().amax((1, 2)) / fro2).max()), float((weyl / fro2).max()),
            float((u.mT @ u - eye).abs().max()), float((v.mT @ v - eye).abs().max()))


def _lstsq64(a, b):
    return torch.linalg.lstsq(a.double(), b.double(), driver="gels").solution


def _circulant(gen, b, n, dev):
    """Symmetric circulant matrices: a constant diagonal, and every column a
    shift of the first, so all column norms are equal with non-zero
    couplings (ROADMAP C12's ties, for syevd and gesvd at once)."""
    c = torch.randn((b, n), generator=gen, device=dev)
    c = (c + torch.roll(c.flip(1), 1, 1)) / 2
    idx = (torch.arange(n, device=dev)[None, :] - torch.arange(n, device=dev)[:, None]) % n
    return c[:, idx]


def _dxe_control(kind, m, k_or_b=None) -> float:
    """Distance of the plain version on m from the plain version on m
    rounded to bf16 (values, Q·C or X): what a kernel that lost f32
    precision would show. DXE_TOL must sit below it."""
    lo = m.to(BF16).to(F32)
    with _dx_plain():
        if kind == "syevd":
            return max_scaled_err(dxs.syevd_batched(lo)[0], dxs.syevd_batched(m)[0])
        if kind == "vectors":
            (_, v_lo), (w, v) = dxs.syevd_batched(lo), dxs.syevd_batched(m)
            return _vec_err(v_lo, v, w)
        if kind == "gesvd":
            return max_scaled_err(dxs.gesvd_batched(lo)[1], dxs.gesvd_batched(m)[1])
        if kind == "gels":
            return _x_err(m, dxs.gels_batched(lo, k_or_b), dxs.gels_batched(m, k_or_b))
        qr, taus = dxs._geqrf_plain(m)
        lo_qr, lo_taus = dxs._geqrf_plain(lo)
        return max_scaled_err(dxs.unmqr_batched(lo_qr, lo_taus, k_or_b),
                              dxs.unmqr_batched(qr, taus, k_or_b))


def phase_dxe_kernel(dev) -> None:
    """Kernels B7e-B7h (tml_unmqr_batched, tml_gels_batched in
    csrc/dx_solver.cu; tml_syevd_batched, tml_gesvd_batched in
    csrc/dx_jacobi.cu) against their plain versions and float64, batch 37,
    through the public functions (which sort the Jacobi results): syevd and
    gesvd at n = 2 … 64, unmqr at (m, n) = (32, 32) and (64, 32) with both
    trans, gels at (32, 32), (64, 32), (48, 10), k = 1 and 4. Against the
    plain version DXE_TOL; against float64 the reference test's bounds
    (tests/test_dx_solver.py:128-214): w and s within 2e-4 of the largest,
    AV − VΛ and U·S·Vᵀ − A below 5e-4·max|A|·n, VᵀV − I below 5e-4 (syevd)
    and 1e-3 (gesvd), gels within 5e-4·max|x| of float64 least squares,
    unmqr within 5e-4 of float64 Q·C. Then C12's ties (circulant matrices:
    constant diagonal, equal column norms) against eigvalsh and svdvals, and
    a bf16 control above every tolerance."""
    gen = torch.Generator(device=dev).manual_seed(2121)
    failures, cases = [], 0
    worst: dict[str, float] = {}

    def hold(what, ok, detail, **errs):
        nonlocal cases
        cases += 1
        for key, err in errs.items():
            worst[key] = max(worst.get(key, 0.0), err)
        if not ok:
            failures.append(what)
        print(f"[dxe-kernel] {what:30s} {detail} {'ok' if ok else 'FAIL'}", flush=True)

    bsz, tol = DX_KERNEL_BATCH, DXE_TOL
    for n in DXE_KERNEL_NS:
        g = torch.randn((bsz, n, n), generator=gen, device=dev)
        sym = (g + g.mT) / 2
        (w, v), (w_p, v_p) = dxs.syevd_batched(sym), _plain_of(lambda: dxs.syevd_batched(sym))()
        e_v, e_vec = max_scaled_err(w, w_p), _vec_err(v, v_p, w_p)
        e_w, res, orth = _eig_f64(sym, w, v)
        hold(f"syevd n={n}", e_v <= tol["values"] and e_vec <= tol["vectors"] and e_w < 2e-4
             and res < 5e-4 and orth < 5e-4,
             f"vs plain w {e_v:.3e} V {e_vec:.3e} | f64 w {e_w:.3e} AV−VΛ {res:.3e} VᵀV−I {orth:.3e}",
             values=e_v, vectors=e_vec)
        (u, s, vt), (u_p, s_p, vt_p) = dxs.gesvd_batched(g), _plain_of(lambda: dxs.gesvd_batched(g))()
        e_v = max_scaled_err(s, s_p)
        e_vec = max(_vec_err(u, u_p, s_p), _vec_err(vt.mT, vt_p.mT, s_p))
        e_s, rec, orth = _svd_f64(g, u, s, vt)
        hold(f"gesvd n={n}", e_v <= tol["values"] and e_vec <= tol["vectors"] and e_s < 2e-4
             and rec < 5e-4 and orth < 1e-3,
             f"vs plain s {e_v:.3e} U,V {e_vec:.3e} | f64 s {e_s:.3e} USVᵀ−A {rec:.3e} orth {orth:.3e}",
             values=e_v, vectors=e_vec)
    for m, n in DXE_LSQ:
        a = torch.randn((bsz, m, n), generator=gen, device=dev)
        qr, taus = dxs._geqrf_plain(a)
        q64 = _q_of(qr, taus)
        for k in (1, DX_K):
            b = torch.randn((bsz, m, k), generator=gen, device=dev)
            x, x_p = dxs.gels_batched(a, b), _plain_of(lambda: dxs.gels_batched(a, b))()
            e_x, x64 = _x_err(a, x, x_p), _lstsq64(a, b)
            e_64 = float(((x.double() - x64).flatten(1).abs().amax(1) / _amax(x64)).max())
            hold(f"gels m={m} n={n} k={k}", e_x <= tol["x"] and e_64 < 5e-4
                 and bool(torch.isfinite(x).all()),
                 f"vs plain / cond {e_x:.3e} | vs f64 lstsq {e_64:.3e}", x=e_x)
            if n == 10:   # unmqr at (32, 32) and (64, 32)
                continue
            for trans in (True, False):
                qc = dxs.unmqr_batched(qr, taus, b, trans)
                qc_p = _plain_of(lambda: dxs.unmqr_batched(qr, taus, b, trans))()
                want = (q64.mT if trans else q64) @ b.double()
                e_q, e_64 = max_scaled_err(qc, qc_p), float((qc.double() - want).abs().max())
                hold(f"unmqr m={m} n={n} k={k} trans={trans}", e_q <= tol["qc"] and e_64 < 5e-4,
                     f"vs plain {e_q:.3e} | vs f64 Q·C {e_64:.3e}", qc=e_q)
    for n in (8, 32, 64):   # C12: ties the reference never turns
        c = _circulant(gen, 4, n, dev)
        w, _ = dxs.syevd_batched(c)
        s = dxs.gesvd_batched(c)[1]
        wt, st = torch.linalg.eigvalsh(c.double()), torch.linalg.svdvals(c.double())
        e_w = float(((w.double() - wt).abs().amax(1) / wt.abs().amax(1)).max())
        e_s = float(((s.double() - st).abs().amax(1) / st.amax(1)).max())
        hold(f"C12 circulant n={n}", e_w < 2e-4 and e_s < 2e-4,
             f"w vs eigvalsh {e_w:.3e} s vs svdvals {e_s:.3e}")
    tie = 0.5 * torch.ones((1, 8, 8), device=dev) + 0.5 * torch.eye(8, device=dev)
    w, s = dxs.syevd_batched(tie)[0], dxs.gesvd_batched(tie)[1]
    hold("C12 0.5·ones + 0.5·I n=8", abs(float(w[0, -1]) - 4.5) < 1e-5
         and abs(float(s[0, 0]) - 4.5) < 1e-5 and float((w[0, :-1] - 0.5).abs().max()) < 1e-5,
         f"w {[round(float(t), 6) for t in w[0]]} s[0] {float(s[0, 0]):.6f}")
    g = torch.randn((bsz, 32, 32), generator=gen, device=dev)
    a, b = torch.randn((bsz, 64, 32), generator=gen, device=dev), torch.randn(
        (bsz, 64, DX_K), generator=gen, device=dev)
    for kind, key, m, extra in (("syevd", "values", (g + g.mT) / 2, None),
                                ("vectors", "vectors", (g + g.mT) / 2, None),
                                ("gesvd", "values", g, None), ("gels", "x", a, b),
                                ("unmqr", "qc", g, torch.randn((bsz, 32, DX_K), generator=gen,
                                                               device=dev))):
        ctl = _dxe_control(kind, m, extra)
        hold(f"{kind} bf16 control", ctl > tol[key], f"{ctl:.3e} above the tolerance {tol[key]:g}")
    torch.cuda.synchronize()
    print(f"[dxe-kernel] worst against the plain version: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)
    if failures:
        raise SystemExit(f"chip_smoke: {len(failures)} of {cases} dx lsq/eig cases failed: {failures}")
    print(f"[dxe-kernel] {cases} cases agree", flush=True)


def _dxe_routes(x):
    """name: (public call, its kernel's counter or None, plain route or None,
    library call or None)."""
    a, b, qr, taus, c = x["a"], x["b"], x["qr"], x["taus"], x["c"]
    sq, sym, wide, sym_w, big_sym, big = (x[k] for k in ("sq", "sym", "wide", "sym_w", "big_sym",
                                                         "big"))
    routes = {
        "gels_batched b8192 m64 n32 k4": (lambda: dxs.gels_batched(a, b), "_gels",
                                          lambda: torch.linalg.lstsq(a, b, driver="gels")),
        "unmqr_batched trans b8192 n32 k4": (lambda: dxs.unmqr_batched(qr, taus, c, True),
                                             "_unmqr", lambda: torch.ormqr(qr, taus, c,
                                                                           transpose=True)),
        "unmqr_batched b8192 n32 k4": (lambda: dxs.unmqr_batched(qr, taus, c, False), "_unmqr",
                                       lambda: torch.ormqr(qr, taus, c)),
        "syevd_batched b8192 n32": (lambda: dxs.syevd_batched(sym), "_syevd",
                                    lambda: torch.linalg.eigh(sym)),
        "gesvd_batched b8192 n32": (lambda: dxs.gesvd_batched(sq), "_gesvd",
                                    lambda: torch.linalg.svd(sq)),
        "syevd_batched b2048 n64": (lambda: dxs.syevd_batched(sym_w), "_syevd",
                                    lambda: torch.linalg.eigh(sym_w)),
        "gesvd_batched b2048 n64": (lambda: dxs.gesvd_batched(wide), "_gesvd",
                                    lambda: torch.linalg.svd(wide)),
        # the ride-along routes: no kernel of the repository
        "syevj_batched f64 b8192 n32": (lambda: jacobi.syevj_batched(sym.double(), tol=1e-6), None,
                                        None),
        "gesvdj_batched f64 b8192 n32": (lambda: jacobi.gesvdj_batched(sq.double(), tol=1e-6),
                                         None, None),
        f"xsyevd n{XSYEVD_N}": (lambda: dense.xsyevd(big_sym), None, None),
        f"xgesvd n{XGESVD_N}": (lambda: dense.xgesvd(big), None, None),
    }
    return {name: (route, count, None if count is None else _plain_of(route), library)
            for name, (route, count, library) in routes.items()}


def phase_dxe_main(dev) -> dict:
    """The slice's main path through the public functions: gels_batched at
    batch 8192 × m 64 × n 32, k 4; unmqr_batched both ways on
    geqrf_batched's factors of 8192 × 32 × 32 and C (8192, 32, 4);
    syevd_batched and gesvd_batched at 8192 × 32 and 2048 × 64. Each must
    grow its kernel's count by one and is held to its plain version
    (DXE_TOL) and to float64 (phase 21's bounds). Then the routes that
    launch no kernel, against float64: syevj_batched and gesvdj_batched at
    8192 × 32 (tol 1e-6, float64: in f32 the reference's stopping test,
    which the port keeps, stops gesvdj early, ROADMAP C13; gesvdj is held
    to what that test promises, _gesvdj_f64), xsyevd at n = 2048
    (bench.py:354-362) and xgesvd at 4096 × 4096 (cuSOLVER's gesvd driver
    through torch.linalg, beside torch's default driver for comparison)."""
    gen = torch.Generator(device=dev).manual_seed(8282)
    bg, mg, ng, kg = DXE_GELS
    bs, ns = DXE_SQ
    bw, nw = DXE_WIDE
    sq, wide = (torch.randn((b_, n_, n_), generator=gen, device=dev) for b_, n_ in ((bs, ns), (bw, nw)))
    x = {"a": torch.randn((bg, mg, ng), generator=gen, device=dev),
         "b": torch.randn((bg, mg, kg), generator=gen, device=dev),
         "sq": sq, "sym": (sq + sq.mT) / 2, "wide": wide, "sym_w": (wide + wide.mT) / 2,
         "c": torch.randn((bs, ns, DX_K), generator=gen, device=dev),
         "big": torch.randn((XGESVD_N, XGESVD_N), generator=gen, device=dev)}
    g = torch.randn((XSYEVD_N, XSYEVD_N), generator=gen, device=dev)
    x["big_sym"] = (g + g.T) / 2
    x["qr"], x["taus"] = dxs.geqrf_batched(sq)
    routes = _dxe_routes(x)
    torch.cuda.synchronize()
    for f in DXE_COUNTS:
        f.launches = 0
    outs, grew, events = {}, {}, {}
    for name, (route, _, _, _) in routes.items():
        before = {f.__name__: f.launches for f in DXE_COUNTS}
        events[name] = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        events[name][0].record()
        outs[name] = route()
        events[name][1].record()
        grew[name] = {f.__name__: f.launches - before[f.__name__] for f in DXE_COUNTS}
    torch.cuda.synchronize()
    once_ms = {name: start.elapsed_time(end) for name, (start, end) in events.items()}
    launches = {f.__name__: f.launches for f in DXE_COUNTS}
    print(f"[dxe] launches in the main path: {launches}", flush=True)

    tol, max_abs, failures = DXE_TOL, {}, []
    for name, (route, count, plain_fn, _) in routes.items():
        out = outs[name]
        if count is None:
            launched = sum(grew[name].values()) == 0
        else:
            launched = grew[name][count] == 1 and sum(grew[name].values()) == 1
        if name.startswith("gels"):
            x_p = plain_fn()
            e_x, x64 = _x_err(x["a"], out, x_p), _lstsq64(x["a"], x["b"])
            e_64 = float(((out.double() - x64).flatten(1).abs().amax(1) / _amax(x64)).max())
            ok = e_x <= tol["x"] and e_64 < 5e-4
            max_abs[name] = max_abs_rel(out, x_p)[0]
            detail = f"vs plain / cond {e_x:.3e} | vs f64 lstsq {e_64:.3e}"
        elif name.startswith("unmqr"):
            qc_p = plain_fn()
            q64 = _q_of(x["qr"], x["taus"])
            want = (q64.mT if "trans" in name else q64) @ x["c"].double()
            e_q, e_64 = max_scaled_err(out, qc_p), float((out.double() - want).abs().max())
            back = dxs.unmqr_batched(x["qr"], x["taus"], out, "trans" not in name)
            e_back = max_scaled_err(back, x["c"])
            ok = e_q <= tol["qc"] and e_64 < 5e-4 and e_back < 1e-5
            max_abs[name] = max_abs_rel(out, qc_p)[0]
            detail = f"vs plain {e_q:.3e} | vs f64 Q·C {e_64:.3e}, round trip {e_back:.3e}"
        elif name.startswith("syevd"):
            (w, v), (w_p, v_p) = out, plain_fn()
            a = x["sym"] if "n32" in name else x["sym_w"]
            e_v, e_vec = max_scaled_err(w, w_p), _vec_err(v, v_p, w_p)
            e_w, res, orth = _eig_f64(a, w, v)
            ok = (e_v <= tol["values"] and e_vec <= tol["vectors"] and e_w < 2e-4 and res < 5e-4
                  and orth < 5e-4)
            max_abs[name] = max_abs_rel(w, w_p)[0]
            detail = (f"vs plain w {e_v:.3e} V {e_vec:.3e} | f64 w {e_w:.3e} AV−VΛ {res:.3e} "
                      f"VᵀV−I {orth:.3e}")
        elif name.startswith("gesvd_"):
            (u, s, vt), (u_p, s_p, vt_p) = out, plain_fn()
            a = x["sq"] if "n32" in name else x["wide"]
            e_v = max_scaled_err(s, s_p)
            e_vec = max(_vec_err(u, u_p, s_p), _vec_err(vt.mT, vt_p.mT, s_p))
            e_s, rec, orth = _svd_f64(a, u, s, vt)
            ok = (e_v <= tol["values"] and e_vec <= tol["vectors"] and e_s < 2e-4 and rec < 5e-4
                  and orth < 1e-3)
            max_abs[name] = max_abs_rel(s, s_p)[0]
            detail = (f"vs plain s {e_v:.3e} U,V {e_vec:.3e} | f64 s {e_s:.3e} USVᵀ−A {rec:.3e} "
                      f"orth {orth:.3e}")
        elif name.startswith("syevj"):
            w, v, res, sweeps = out
            e_w, r, orth = _eig_f64(x["sym"], w, v)
            # tol 1e-6 stops at off(A) < 1e-6·‖A‖: AV − VΛ of that order
            ok = e_w < 1e-9 and r < 1e-6 and orth < 1e-12
            detail = (f"f64 w {e_w:.3e} AV−VΛ {r:.3e} VᵀV−I {orth:.3e} | sweeps "
                      f"{int(sweeps.min())}–{int(sweeps.max())}")
        elif name.startswith("gesvdj"):
            u, s, v, res, sweeps = out
            e_s, rec, _ = _svd_f64(x["sq"], u, s, v.mT)
            e_off, e_weyl, orth_u, orth_v = _gesvdj_f64(x["sq"], u, s, v)
            # the stop (ROADMAP C13) leaves Gram entries up to √eps·‖A‖²_F:
            # |u_pᵀu_q| ≤ that/(σ_p·σ_q), and by Weyl |s² − σ²| ≤ ‖off(G)‖
            ok = e_off < 1.5e-8 and e_weyl < 1e-12 and rec < 1e-12 and orth_v < 1e-12
            detail = (f"f64 s {e_s:.3e} (Weyl {e_weyl:.1e}) USVᵀ−A {rec:.3e} off(G) {e_off:.3e} "
                      f"UᵀU−I {orth_u:.3e} VᵀV−I {orth_v:.3e} | sweeps "
                      f"{int(sweeps.min())}–{int(sweeps.max())}")
        elif name.startswith("xsyevd"):
            w, v, info = out
            e_w, r, orth = _eig_f64(x["big_sym"][None], w[None], v[None])
            ok = e_w < 2e-4 and r < 5e-4 and orth < 5e-4 and int(info) == 0
            detail = f"f64 w {e_w:.3e} AV−VΛ {r:.3e} VᵀV−I {orth:.3e} info {int(info)}"
        else:
            u, s, vh, info = out
            st = torch.linalg.svdvals(x["big"].double())[None]
            e_s, rec, orth = _svd_f64(x["big"][None], u[None], s[None], vh[None], st)
            ok = e_s < 2e-4 and rec < 5e-4 and orth < 1e-3 and int(info) == 0
            # what xgesvd's driver choice keeps out: torch's default, gesvdj
            d_s, d_rec, d_orth = _svd_f64(x["big"][None], *(t[None] for t in torch.linalg.svd(
                x["big"], full_matrices=False)), st)
            detail = (f"f64 s {e_s:.3e} USVᵀ−A {rec:.3e} orth {orth:.3e} info {int(info)} | "
                      f"torch's default driver: s {d_s:.3e} USVᵀ−A {d_rec:.3e} orth {d_orth:.3e}")
        ok = ok and launched and all(bool(torch.isfinite(t).all()) for t in
                                     (out if isinstance(out, tuple) else (out,)) if t is not None)
        print(f"[dxe] {name:34s} launches {grew[name]} | {detail} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(name)
    if failures:
        raise SystemExit(f"chip_smoke: dx lsq/eig main path failed: {failures}")
    return {"launches": launches, "max_abs_err": max_abs, "routes": routes, "once_ms": once_ms}


def _dxe_bound(name: str) -> dict:
    """The bound of a line of phase 23, f32: inputs read and outputs written
    once, and the flop at the f32 peak. gels: A and B read, X written;
    2mn² − 2n³/3 for QR, 4mnk − 2n²k for Qᵀ·B, n²k for R·X = Y. unmqr: the
    reflectors below the diagonal and tau read, C read and written;
    4mnk − 2n²k. syevd: 12n flop a pair turned in a round (A stays
    symmetric, so Jᵀ·A·J needs one triangle of A's columns and rows, 6n,
    and V's columns 6n); gesvd: 18n (A's and V's columns and the three
    sums); over the sweeps and the schedule's live pairs; A read, V and w
    (U, s, V) written."""
    if name.startswith("gels"):
        b, m, n, k = DXE_GELS
        flop = 2 * m * n * n - 2 * n**3 / 3 + 4 * m * n * k - 2 * n * n * k + n * n * k
        return _bound(b * flop, PEAK_F32, 4 * b * (m * n + m * k + n * k))
    if name.startswith("unmqr"):
        (b, n), k = DXE_SQ, DX_K
        words = n * n - n * (n + 1) // 2 + n + 2 * n * k
        return _bound(b * (4 * n * n * k - 2 * n * n * k), PEAK_F32, 4 * b * words)
    b, n = DXE_WIDE if "n64" in name else DXE_SQ
    sweeps, outs, per_pair = ((10, 2 * n * n + n, 12 * n) if name.startswith("syevd")
                              else (12, 3 * n * n + n, 18 * n))
    live = dxs._live_pairs(n)
    flop = sweeps * live.shape[0] * live.shape[1] * per_pair
    return _bound(b * flop, PEAK_F32, 4 * b * (n * n + outs))


def phase_dxe_times(dxe: dict, card: str) -> dict:
    """CUDA events around back-to-back calls (``_loop_ms``) of each route of
    phase 22, its plain version (short loops) and its library call
    (torch.linalg.lstsq with driver gels, torch.ormqr, torch.linalg.eigh,
    torch.linalg.svd), each beside its bound. A call that takes more than
    100 ms (the Jacobi plain versions, torch.ormqr, which loops over the
    batch, and eigh and svd at n = 64) is timed once in each turn; the
    routes that launch no kernel keep their one call of phase 22."""
    fast, slow, slowest = {}, {}, {}
    for name, (route, count, plain, library) in dxe["routes"].items():
        if count is None:
            continue
        fast[f"{name} kernel"] = route
        slow_library = name.startswith("unmqr") or "n64" in name
        (slowest if slow_library else slow)[f"{name} library"] = library
        (slowest if name.startswith(("syevd", "gesvd")) else slow)[f"{name} plain"] = plain
    ms = _loop_ms(fast, warmup=2, reps=10, samples=3)
    ms.update(_loop_ms(slow, warmup=1, reps=2, samples=2))
    ms.update(_loop_ms(slowest, warmup=0, reps=1, samples=1))
    ms.update({f"{name} route": t for name, t in dxe["once_ms"].items()
               if dxe["routes"][name][1] is None})
    bounds = {}
    for name, (_, count, _, _) in dxe["routes"].items():
        if count is None:
            print(f"[dxe-times] {name:34s} route   {ms[f'{name} route']:.4f} ms (one call, phase "
                  f"22; no kernel of the repository) | {card}", flush=True)
            continue
        bounds[name] = bound = _dxe_bound(name)
        for route in ("kernel", "plain", "library"):
            t = ms[f"{name} {route}"]
            print(f"[dxe-times] {name:34s} {route:7s} {t:.4f} ms | bound {bound['bound_ms']:.4f} "
                  f"ms ({bound['bound_by']}), {bound['bound_ms'] / t:.1%} of it | {card}",
                  flush=True)
    ms["bounds"] = bounds
    return ms


DXC_WALK_NS = (160, 128, 32 * 1001, 1 << 20)   # phase 24's value counts (160: a partial row)
DXC_DOT_ROWS = (1, 37, 4096)                   # phase 24's decode_dot rows (37 < the tile, 64)
DXC_DOT_COLS = (1, 64, 100, 256)
GEMM_FFT_SHAPES = ((16, 32, 64), (300, 96, 80), (4096, 1024, 1024))   # (m, k, n)
GEMM_FFT_EPILOGUES = ("default", "relu", "gelu", "gelu_bias")   # gelu_bias: none (C14)
DXC_N, DXC_BITS = 64 << 20, 8        # bench.py:403-407: 256 MB of int32, bits 8
DXC_W = 128                          # W (128, 128) of decode_dot on that payload
GEMM_FFT_MAIN = (32768, 256, 256)    # (m, k, n): the n at which dx/fused.py:37-40 compares
CONV_MAIN = (4096, 4096)             # fft_convolution's (batch, n)
CONV_ND = (8, 64)                    # fft_convolution_nd's batch and side: 8 × 64³
DXC_COUNTS = (dxc._encode, dxc._decode, dxc._decode_dot, fused._gemm_fft, pallas_matmul, DIF_FFT)
# Tolerances against the plain version (max over the output of |kernel −
# plain| over max|plain|): decode_dot 1e-5 and gemm_fft 1e-5, the same f32
# products summed in another order; the codec is held bit for bit.
DXC_TOL = {"dot": 1e-5, "gemm_fft": 1e-5}


def _scaled(got, want) -> float:
    """max|got − want| / max|want|, over tensors or (re, im) pairs."""
    if isinstance(got, tuple):
        top = max(float(w.abs().max()) for w in want)
        return max(float((g - w).abs().max()) for g, w in zip(got, want)) / top
    return float((got - want).abs().max() / want.abs().max())


def _walk(gen, n, bits, dev):
    """int32 values whose row deltas (int32, wrapping) zigzag into ``bits``:
    steps in [−2^(bits−1), 2^(bits−1)) from a random start."""
    half = 1 << (bits - 1)
    steps = torch.randint(-half, half, (n,), generator=gen, device=dev)
    steps[0] = torch.randint(-(2**31), 2**31, (1,), generator=gen, device=dev)
    return ((torch.cumsum(steps, 0) + 2**31) % 2**32 - 2**31).to(torch.int32)


def _gemm_fft64(a, b, epilogue):
    """FFT(epilogue(A@B)) over the rows in float64 (torch.fft on complex128)."""
    c = a.double() @ b.double()
    c = fused._epilogue(c, epilogue)
    return torch.fft.fft(c.to(torch.complex128), dim=-1)


def _pair_rel_l2(pair, want) -> float:
    return _rel(torch.complex(pair[0].double(), pair[1].double()), want)


def phase_dxc_kernel(dev) -> None:
    """Kernels B8a, B8b (tml_cascaded_decode, tml_cascaded_encode), B8c
    (tml_cascaded_decode_dot, csrc/dx_comp.cu) and B9 (tml_gemm_fft,
    csrc/dx_fused.cu) against their plain versions and float64. The codec at
    every width 1 … 32 on random walks whose steps fit the width, n = 160,
    128, 32·1001 and 2^20: packed words and leaders equal the plain
    encoder's bit for bit, the decode equals the plain decoder's and gives
    the input back; the int32 extremes at 32 bits; a width too narrow
    (corrupt, as the plain version corrupts). decode_dot at rows 1, 37 and
    4096, W widths 1, 64, 100, 256, scale 1 and 0.01: DXC_TOL against the
    plain version, rel < 1e-5 against float64 (tests/test_dx_gemm.py:121-124).
    gemm_fft at (16, 32, 64), (300, 96, 80) and (4096, 1024, 1024) under
    every epilogue and an unknown string (C14: none): DXC_TOL against the
    plain version, rel-L2 < 1e-5 against float64
    (tests/test_heuristics_grading_apps.py:148-149). A bf16 control above
    each tolerance."""
    gen = torch.Generator(device=dev).manual_seed(2424)
    failures, cases = [], 0
    worst: dict[str, float] = {}

    def hold(what, ok, detail, quiet=False, **errs):
        nonlocal cases
        cases += 1
        for key, err in errs.items():
            worst[key] = max(worst.get(key, 0.0), err)
        if not ok:
            failures.append(what)
        if not quiet or not ok:
            print(f"[dxc-kernel] {what:36s} {detail} {'ok' if ok else 'FAIL'}", flush=True)

    for bits in range(1, 33):
        for n in DXC_WALK_NS:
            v = _walk(gen, n, bits, dev)
            p, ld = dxc.dx_compress(v, bits=bits)
            p_p, ld_p = dxc._dx_compress_plain(v, bits)
            words = torch.equal(p.view(torch.int32), p_p.view(torch.int32)) and torch.equal(ld, ld_p)
            out = dxc.dx_decompress(p, ld, bits=bits)
            same = torch.equal(out, dxc._dx_decompress_plain(p, ld, bits))
            back = torch.equal(out[:n], v) and bool((out[n:] == v[-1]).all())
            try:
                req = dxc.dx_required_bits(v)
            except ValueError:
                req = 33   # a wrapped walk: the unwrapped deltas need 33 bits
            hold(f"codec bits={bits} n={n}", words and same and back and p.shape == (
                -(-n // 128), 4 * bits), f"words {words} decode {same} round trip {back} "
                 f"required {req}", quiet=True)
    print(f"[dxc-kernel] codec: widths 1..32 × n {DXC_WALK_NS}, words and leaders bit for bit, "
          f"decode equal, round trip exact", flush=True)
    ext = torch.tensor([2**31 - 1, -(2**31)], dtype=torch.int32, device=dev).repeat(1 << 19)
    p, ld = dxc.dx_compress(ext, bits=32)
    p_p, _ = dxc._dx_compress_plain(ext, 32)
    hold("int32 extremes bits=32 n=2^20", torch.equal(p.view(torch.int32), p_p.view(torch.int32))
         and torch.equal(dxc.dx_decompress(p, ld, bits=32), ext), "words and round trip exact")
    nine = torch.cumsum(torch.randint(-256, 256, (1 << 20,), generator=gen, device=dev),
                        0).to(torch.int32)
    p, ld = dxc.dx_compress(nine, bits=4)
    p_p, _ = dxc._dx_compress_plain(nine, 4)
    out = dxc.dx_decompress(p, ld, bits=4)
    wrong = int((out != nine).sum())
    hold("too narrow: 9-bit walk at bits=4", dxc.dx_required_bits(nine) == 9 and torch.equal(
        p.view(torch.int32), p_p.view(torch.int32)) and torch.equal(
        out, dxc._dx_decompress_plain(p, ld, 4)) and wrong > (1 << 19),
         f"{wrong} of {1 << 20} values wrong, as the plain version, nothing raised")

    tol = DXC_TOL
    for rows in DXC_DOT_ROWS:
        v = torch.cumsum(torch.randint(-60, 61, (rows * 128,), generator=gen, device=dev),
                         0).to(torch.int32)
        p, ld = dxc.dx_compress(v, bits=8)
        for ncols in DXC_DOT_COLS:
            w = torch.randn((128, ncols), generator=gen, device=dev)
            for scale in (1.0, 0.01):
                got = dxc.dx_decompress_dot(p, ld, w, bits=8, scale=scale)
                e_p = _scaled(got, dxc._dx_decompress_dot_plain(p, ld, w, 8, scale))
                f64 = (v.reshape(-1, 128).double() * scale) @ w.double()
                e_64 = _scaled(got.double(), f64)
                hold(f"decode_dot rows={rows} N={ncols} scale={scale}",
                     e_p <= tol["dot"] and e_64 < 1e-5 and got.shape == (rows, ncols),
                     f"vs plain {e_p:.3e} | vs f64 {e_64:.3e}", dot=e_p)
    for m, k, n in GEMM_FFT_SHAPES:
        a = torch.randn((m, k), generator=gen, device=dev)
        b = torch.randn((k, n), generator=gen, device=dev)
        wr, wi = fft_kernels._dft_on(n, False, dev)
        for epilogue in GEMM_FFT_EPILOGUES:
            got = fused.gemm_fft(a, b, epilogue)
            e_p = _scaled(got, fused._gemm_fft_plain(a, b, wr, wi, epilogue))
            e_64 = _pair_rel_l2(got, _gemm_fft64(a, b, epilogue))
            hold(f"gemm_fft ({m}, {k}, {n}) {epilogue}", e_p <= tol["gemm_fft"] and e_64 < 1e-5,
                 f"vs plain {e_p:.3e} | vs f64 rel-L2 {e_64:.3e}", gemm_fft=e_p)
        if (m, k, n) == GEMM_FFT_SHAPES[0]:   # C14: any other string is no epilogue
            none, unknown = fused.gemm_fft(a, b), fused.gemm_fft(a, b, "gelu_bias")
            hold("gemm_fft C14 gelu_bias == default", torch.equal(none[0], unknown[0])
                 and torch.equal(none[1], unknown[1]), "no epilogue applied")
    # bf16 controls: the plain versions on inputs rounded to bf16, against f32
    v = torch.cumsum(torch.randint(-60, 61, (4096 * 128,), generator=gen, device=dev),
                     0).to(torch.int32)
    p, ld = dxc.dx_compress(v, bits=8)
    w = torch.randn((128, 256), generator=gen, device=dev)
    ctl = _scaled(dxc._dx_decompress_dot_plain(p, ld, w.to(BF16).float(), 8, 0.01),
                  dxc._dx_decompress_dot_plain(p, ld, w, 8, 0.01))
    hold("decode_dot bf16 control", ctl > tol["dot"], f"{ctl:.3e} above the tolerance {tol['dot']:g}")
    m, k, n = GEMM_FFT_SHAPES[-1]
    a, b = (torch.randn(s, generator=gen, device=dev) for s in ((m, k), (k, n)))
    wr, wi = fft_kernels._dft_on(n, False, dev)
    ctl = _scaled(fused._gemm_fft_plain(a.to(BF16).float(), b.to(BF16).float(), wr, wi, "gelu"),
                  fused._gemm_fft_plain(a, b, wr, wi, "gelu"))
    hold("gemm_fft bf16 control", ctl > tol["gemm_fft"],
         f"{ctl:.3e} above the tolerance {tol['gemm_fft']:g}")
    torch.cuda.synchronize()
    print("[dxc-kernel] worst against the plain version: "
          + ", ".join(f"{key} {err:.3e}" for key, err in worst.items()), flush=True)
    if failures:
        raise SystemExit(f"chip_smoke: {len(failures)} of {cases} codec/fused cases failed: "
                         f"{failures}")
    print(f"[dxc-kernel] {cases} cases agree", flush=True)


def _dxc_inputs(gen, dev) -> dict:
    """bench.py's codec input (a walk of steps uniform in −60..60, as
    jax.random draws them; not the same bits), the lossy codec's
    100·sin(0.001·i) in f32, W for decode_dot and the fused product's and
    the convolutions' operands."""
    n = DXC_N
    m, k, nf = GEMM_FFT_MAIN
    b, nc = CONV_MAIN
    bn, side = CONV_ND
    kern = torch.zeros(nc, device=dev)
    kern[:5] = torch.randn(5, generator=gen, device=dev)
    return {
        "x": torch.cumsum(torch.randint(-60, 61, (n,), generator=gen, device=dev), 0).to(torch.int32),
        "sin": (100.0 * torch.sin(torch.arange(n, dtype=torch.float64, device=dev) * 0.001)).float(),
        "w": torch.randn((128, DXC_W), generator=gen, device=dev),
        "a": torch.randn((m, k), generator=gen, device=dev),
        "b": torch.randn((k, nf), generator=gen, device=dev),
        "c": torch.randn((nf, nf), generator=gen, device=dev),
        "conv_x": torch.randn((b, nc), generator=gen, device=dev),
        "conv_k": kern,
        "nd_x": torch.randn((bn, side, side, side), generator=gen, device=dev),
        "nd_k": torch.randn((side, side, side), generator=gen, device=dev),
    }


def _dxc_steps(x: dict, outs: dict) -> dict:
    """The main path in order, name: (public call, the launches it must add;
    every other count must stay)."""
    mkn = "({}, {}, {})".format(*GEMM_FFT_MAIN)
    nf = GEMM_FFT_MAIN[2]
    return {
        "device_cascaded_compress bits=8": (
            lambda: comp.device_cascaded_compress(x["x"], bits=DXC_BITS), {"_encode": 1}),
        "device_cascaded_decompress": (
            lambda: comp.device_cascaded_decompress(*outs["device_cascaded_compress bits=8"]),
            {"_decode": 1}),
        "device_cascaded_compress bits=None": (
            lambda: comp.device_cascaded_compress(x["x"]), {"_encode": 1}),
        "bitcomp_lossy_compress delta=1.0": (
            lambda: comp.device_bitcomp_lossy_compress(x["sin"], 1.0), {"_encode": 1}),
        "bitcomp_lossy_decompress delta=1.0": (
            lambda: comp.device_bitcomp_lossy_decompress(*outs["bitcomp_lossy_compress delta=1.0"]),
            {"_decode": 1}),
        "bitcomp_lossy_compress delta=0.3": (
            lambda: comp.device_bitcomp_lossy_compress(x["sin"], 0.3), {"_encode": 1}),
        "bitcomp_lossy_decompress delta=0.3": (
            lambda: comp.device_bitcomp_lossy_decompress(*outs["bitcomp_lossy_compress delta=0.3"]),
            {"_decode": 1}),
        f"dx_decompress_dot rows={DXC_N // 128} N={DXC_W}": (
            lambda: dxc.dx_decompress_dot(*outs["device_cascaded_compress bits=8"][0], x["w"],
                                          bits=DXC_BITS, scale=0.01), {"_decode_dot": 1}),
        f"gemm_fft {mkn} gelu": (
            lambda: fused.gemm_fft(x["a"], x["b"], "gelu"), {"_gemm_fft": 1}),
        f"gemm_fft_composed {mkn} gelu": (
            lambda: fused.gemm_fft_composed(x["a"], x["b"], "gelu"), {"pallas_matmul": 1}),
        f"gemm_gemm {mkn} x ({nf}, {nf})": (
            lambda: fused.gemm_gemm(x["a"], x["b"], x["c"]), {"pallas_matmul": 2}),
        "fft_convolution {} x {}".format(*CONV_MAIN): (
            lambda: fused.fft_convolution(x["conv_x"], x["conv_k"]), {"dif_fft": 3}),
        "fft_convolution_nd {} x {}^3".format(*CONV_ND): (
            lambda: fused.fft_convolution_nd(x["nd_x"], x["nd_k"]), {}),
    }


def phase_dxc_main(dev) -> dict:
    """The slice's main path through the public functions, each step's
    launches counted (every count set to 0 just before): bench.py's codec
    line (bench.py:403-407), 64 Mi int32 of a walk of steps −60..60, through
    comp.device_cascaded_compress at bits 8 and device_cascaded_decompress
    (exact, the words equal the plain encoder's), the same with bits unset
    (must choose 7: steps ≤ 60 zigzag to ≤ 120) and the ratio (3.88: 32/8
    less a leader a row); device_bitcomp_lossy_compress and _decompress on 64
    Mi f32 of 100·sin(0.001·i) at delta 1.0 and 0.3 (floors to 0.25), error
    ≤ delta/2 (tests/test_native_dss_comp.py:525-544); dx_decompress_dot on
    the bits-8 payload, 524288 rows against W (128, 128), scale 0.01
    (DXC_TOL against the plain version, rel < 1e-5 against float64);
    gemm_fft at (32768, 256, 256) with gelu; then the compositions at the same
    sizes (gemm_fft_composed, gemm_gemm with C (256, 256)), fft_convolution
    4096 × 4096 and fft_convolution_nd 8 × 64³ against float64, with the B1
    and dif_fft launches each reaches."""
    gen = torch.Generator(device=dev).manual_seed(2525)
    x = _dxc_inputs(gen, dev)
    outs: dict = {}
    steps = _dxc_steps(x, outs)
    torch.cuda.synchronize()
    for f in DXC_COUNTS:
        f.launches = 0
    grew = {}
    for name, (step, _) in steps.items():
        before = {f.__name__: f.launches for f in DXC_COUNTS}
        outs[name] = step()
        grew[name] = {f.__name__: f.launches - before[f.__name__] for f in DXC_COUNTS}
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in DXC_COUNTS}
    print(f"[dxc] launches in the main path: {launches}", flush=True)

    n, tol, failures, max_abs = DXC_N, DXC_TOL, [], {}
    (packed, leaders), meta = outs["device_cascaded_compress bits=8"]
    for name, (_, want) in steps.items():
        out = outs[name]
        if name == "device_cascaded_compress bits=8":
            p_p, ld_p = dxc._dx_compress_plain(x["x"], DXC_BITS)
            ratio = comp.device_cascaded_ratio(meta, out[0])
            ok = (torch.equal(packed.view(torch.int32), p_p.view(torch.int32))
                  and torch.equal(leaders, ld_p) and meta == (n, DXC_BITS)
                  and f"{ratio:.2f}" == "3.88")
            max_abs["encode"] = 0.0 if ok else float("nan")
            detail = f"words and leaders equal the plain encoder's; ratio {ratio:.4f}"
        elif name == "device_cascaded_decompress":
            ok = torch.equal(out, x["x"]) and torch.equal(
                out, dxc._dx_decompress_plain(packed, leaders, DXC_BITS))
            max_abs["decode"] = 0.0 if ok else float("nan")
            detail = "equals the input and the plain decoder's"
        elif name == "device_cascaded_compress bits=None":
            (p7, l7), m7 = out
            ok = m7 == (n, 7) and torch.equal(comp.device_cascaded_decompress((p7, l7), m7), x["x"])
            detail = f"chose bits {m7[1]}; its round trip exact"
        elif name.startswith("bitcomp_lossy_compress"):
            ok = out[1][2] == (1.0 if "1.0" in name else 0.25)
            detail = f"meta {out[1]}"
        elif name.startswith("bitcomp_lossy_decompress"):
            d2 = 1.0 if "1.0" in name else 0.25
            err = float((out.double() - x["sin"].double()).abs().max())
            ok = err <= d2 / 2
            detail = f"max error {err:.6f} ≤ {d2 / 2}"
        elif name.startswith("dx_decompress_dot"):
            plain = dxc._dx_decompress_dot_plain(packed, leaders, x["w"], DXC_BITS, 0.01)
            e_p = _scaled(out, plain)
            f64 = (x["x"].reshape(-1, 128).double() * 0.01) @ x["w"].double()
            e_64 = _scaled(out.double(), f64)
            max_abs["decode_dot"] = max_abs_rel(out, plain)[0]
            ok = e_p <= tol["dot"] and e_64 < 1e-5
            detail = f"vs plain {e_p:.3e} | vs f64 {e_64:.3e}"
            del plain, f64
        elif name.startswith("gemm_fft "):
            wr, wi = fft_kernels._dft_on(GEMM_FFT_MAIN[2], False, dev)
            plain = fused._gemm_fft_plain(x["a"], x["b"], wr, wi, "gelu")
            e_p = _scaled(out, plain)
            e_64 = _pair_rel_l2(out, _gemm_fft64(x["a"], x["b"], "gelu"))
            max_abs["gemm_fft"] = max(max_abs_rel(g, w)[0] for g, w in zip(out, plain))
            ok = e_p <= tol["gemm_fft"] and e_64 < 1e-5
            detail = f"vs plain {e_p:.3e} | vs f64 rel-L2 {e_64:.3e}"
        elif name.startswith("gemm_fft_composed"):
            e_64 = _pair_rel_l2(out, _gemm_fft64(x["a"], x["b"], "gelu"))
            ok = e_64 < 1e-5
            detail = f"vs f64 rel-L2 {e_64:.3e}"
        elif name.startswith("gemm_gemm"):
            want64 = (x["a"].double() @ x["b"].double()) @ x["c"].double()
            e_64 = max_scaled_err(out, want64)
            ok = e_64 < 1e-4   # tests/test_heuristics_grading_apps.py:152-157, rtol 1e-4
            detail = f"vs f64 max-scaled {e_64:.3e}"
        elif name.startswith("fft_convolution "):
            xs, ks = x["conv_x"].double(), x["conv_k"].double()
            want64 = torch.fft.ifft(torch.fft.fft(xs) * torch.fft.fft(ks)).real
            e_64 = _rel(out, want64)
            ok = e_64 < 1e-4   # :175-182, rel-L2 1e-4
            detail = f"vs f64 rel-L2 {e_64:.3e}"
        else:
            dims = (-3, -2, -1)
            want64 = torch.fft.ifftn(torch.fft.fftn(x["nd_x"].double(), dim=dims)
                                     * torch.fft.fftn(x["nd_k"].double(), dim=dims), dim=dims).real
            e_64 = max_scaled_err(out, want64)
            ok = e_64 < 2e-4   # :160-172, rtol 2e-4
            detail = f"vs f64 max-scaled {e_64:.3e}"
        expect = {key: want.get(key, 0) for key in grew[name]}
        launched = grew[name] == expect
        tensors = [t for t in (out if isinstance(out, tuple) else (out,)) if isinstance(t, torch.Tensor)]
        ok = ok and launched and all(bool(torch.isfinite(t.float()).all()) for t in tensors)
        print(f"[dxc] {name:42s} launches {grew[name]} | {detail} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(name)
    if failures:
        raise SystemExit(f"chip_smoke: codec/fused main path failed: {failures}")
    return {"launches": launches, "max_abs_err": max_abs, "x": x, "payload": (packed, leaders)}


def _dxc_bound(name: str) -> dict:
    """The bound of a line of phase 26: inputs read and outputs written once.
    decode and encode: the words (rows·4·bits), the leaders (rows) and the
    values (n), 4 bytes each; their integer work is not counted (the peak
    table has no int32 rate). decode_dot: 2·rows·128·N flop at the f32 peak;
    words, leaders, W and the output. gemm_fft: the product's 2mkn flop and
    an FFT's 5·n·log2 n a row, counted as phase 14 counts B5 (the kernel's
    two DFT products do 4mn², more than the function needs); A, B and the
    two output planes."""
    n, rows = DXC_N, DXC_N // 128
    codec = 4 * (rows * 4 * DXC_BITS + rows + n)
    if name in ("decode", "encode"):
        return _bound(0.0, PEAK_F32, codec)
    if name == "decode_dot":
        return _bound(2.0 * rows * 128 * DXC_W, PEAK_F32,
                      4 * (rows * 4 * DXC_BITS + rows + 128 * DXC_W + rows * DXC_W))
    m, k, nf = GEMM_FFT_MAIN
    return _bound(2.0 * m * k * nf + 5.0 * m * nf * math.log2(nf), PEAK_F32,
                  4 * (m * k + k * nf + 2 * m * nf))


def _syncs_per_call(fn) -> int:
    """Host-device synchronisations in one call of ``fn``, as torch's sync
    debug mode reports them."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def phase_dxc_times(dxc_run: dict, card: str) -> dict:
    """CUDA events around back-to-back calls (``_loop_ms``) of each kernel
    route of phase 25 and its plain version (short loops), each beside its
    bound; decode and encode also as GB/s = 4n/t (bench.py:447-448). No
    single torch call computes any of the four (nvCOMP is not installed; no
    torch call fuses a decode with a product or a GEMM with an FFT), so
    library_ms is null; the compositions timed instead: for decode_dot, the
    decode kernel then torch.matmul with f32 products; for gemm_fft,
    torch.fft.fft(gelu(A @ B)) on complex64 and the port's
    gemm_fft_composed."""
    x = dxc_run["x"]
    p, ld = dxc_run["payload"]
    n = DXC_N
    wr, wi = fft_kernels._dft_on(GEMM_FFT_MAIN[2], False, x["a"].device)

    def decoded_then_matmul():
        return fft_kernels._mm(dxc.dx_decompress(p, ld, bits=DXC_BITS).view(-1, 128).float() * 0.01,
                               x["w"])

    def gelu_fft():
        return torch.fft.fft(fused._epilogue(x["a"] @ x["b"], "gelu"))

    kernels = {
        "decode kernel": lambda: dxc.dx_decompress(p, ld, n, bits=DXC_BITS),
        "encode kernel": lambda: dxc.dx_compress(x["x"], bits=DXC_BITS),
        "decode_dot kernel": lambda: dxc.dx_decompress_dot(p, ld, x["w"], bits=DXC_BITS,
                                                           scale=0.01),
        "gemm_fft kernel": lambda: fused.gemm_fft(x["a"], x["b"], "gelu"),
    }
    composed = {
        "decode_dot composed (decode, torch.matmul)": decoded_then_matmul,
        "gemm_fft composed (torch.fft.fft(gelu(A @ B)))": gelu_fft,
        "gemm_fft composed (gemm_fft_composed)": lambda: fused.gemm_fft_composed(x["a"], x["b"],
                                                                                 "gelu"),
    }
    plains = {
        "decode plain": lambda: dxc._dx_decompress_plain(p, ld, DXC_BITS)[:n],
        "encode plain": lambda: dxc._dx_compress_plain(x["x"], DXC_BITS),
        "decode_dot plain": lambda: dxc._dx_decompress_dot_plain(p, ld, x["w"], DXC_BITS, 0.01),
        "gemm_fft plain": lambda: fused._gemm_fft_plain(x["a"], x["b"], wr, wi, "gelu"),
    }
    ms = _loop_ms(kernels, warmup=2, reps=10, samples=5)
    # The compositions launch many small kernels (the matmul FFT's tables
    # now stay on the card between calls); more samples, with their spread
    # and the host-device synchronisations of one call, show how far the
    # host sets their time.
    spread: dict = {}
    ms.update(_loop_ms(composed, warmup=3, reps=10, samples=15, spread=spread))
    for route in composed:
        lo, hi = spread[route]
        print(f"[dxc-times] {route:48s} samples {lo:.4f}..{hi:.4f} ms | "
              f"{_syncs_per_call(composed[route])} host syncs a call | {card}", flush=True)
    ms.update(_loop_ms(plains, warmup=1, reps=2, samples=2))
    bounds = {}
    for name in ("decode", "encode", "decode_dot", "gemm_fft"):
        bounds[name] = bound = _dxc_bound(name)
        for route in [r for r in list(kernels) + list(composed) + list(plains)
                      if r.startswith(name + " ")]:
            t = ms[route]
            rate = f" {4.0 * n / t / 1e6:.1f} GB/s |" if name in ("decode", "encode") else ""
            print(f"[dxc-times] {route:48s} {t:.4f} ms |{rate} bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']}), {bound['bound_ms'] / t:.1%} of it | {card}", flush=True)
    ms["bounds"] = bounds
    return ms

RNG_SEEDS = (0, 42, -1, 2**31 - 1)
RNG_SHAPES = ((1,), (3, 5), (64, 128), (1000, 7), (8192, 8192))   # phase 27's B10a shapes
DROPOUT_CASES = ((300, 96, 77), (256, 512, 128), (1, 1, 1))        # phase 27's (m, k, n)
DROPOUT_RATES = (0.0, 0.1, 0.5, 0.9)
RNG_MAIN = (8192, 8192)             # B10a's full-size call: 64 Mi f32
DROPOUT_MAIN = (4096, 4096, 4096)   # (m, k, n) of B10b, f32: the bench GEMM's shape
DROPOUT_RATE = 0.1
RNG_SEED = 20240601
RNG_COUNTS = (dxr._random_uniform, dxr._dropout_matmul)
# B10b's kept values against its plain version, max-scaled: the same f32
# products summed in another order, as DXC_TOL["dot"].
DROPOUT_TOL = 1e-5
SMS = 132                  # the H100 SXM's SMs
INT_PER_CLK = 64           # 32-bit integer add/logic/shift and IMAD a clock an SM (CUDA C++
                           # Programming Guide, throughput table, compute capability 9.0)
DISPATCH_PER_CLK = 128     # one warp instruction a clock in each of the four partitions
MUFU_PER_CLK = 16          # reciprocals and conversions a clock an SM, the same table


def _card_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0]) * 1e6


def _sass_counts(kernel: str) -> dict:
    """Instruction counts of ``kernel``'s SASS in the built library
    (cuobjdump -sass), from its entry to the first EXIT that no predicate
    guards: the straight path a thread of a full block takes. Integer ALU
    (IADD3, LOP3, SHF, LEA, ISETP, SEL, PRMT, MOV, VIADD), IMAD of every
    form (the FMA pipe), conversions (I2F, I2FP, F2I) and all (the uniform
    datapath's U* instructions take issue slots too)."""
    sass = subprocess.run([str(Path(cuda_utils._nvcc()).parent / "cuobjdump"), "-sass",
                           str(cuda_utils.build_kernels())],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            body.append(m.group(2).split(".")[0])
            if body[-1] == "EXIT" and not m.group(1):   # a predicated EXIT is the early out
                break
    if not body:
        raise SystemExit(f"chip_smoke: no SASS found for {kernel}")
    alu = {"IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT", "MOV", "IABS", "IMNMX", "FLO",
           "VIADD"}
    return {"all": len(body), "alu": sum(op in alu for op in body),
            "imad": sum(op.startswith("IMAD") for op in body),
            "cvt": sum(op in ("I2F", "F2I", "I2FP", "F2IP") for op in body)}


def _rng_bound(name: str, sass: dict | None = None) -> dict:
    """The bound of B10a or B10b at the main path's shapes. B10a: bytes, 4 a
    uniform written; or its integer work, one thread a Philox block running
    the SASS counted by _sass_counts, at INT_PER_CLK for the ALU and the IMAD
    pipes, MUFU_PER_CLK for conversions and DISPATCH_PER_CLK for all of it, at
    the card's highest clock: the larger. B10b: 2mkn flop at the f32 peak
    (the epilogue's Philox blocks are under 1 % of it); A and B read, the
    output written."""
    if name == "uniform":
        n = RNG_MAIN[0] * RNG_MAIN[1]
        threads = -(-n // 4)
        per_clk = max(sass["alu"] / INT_PER_CLK, sass["imad"] / INT_PER_CLK,
                      sass["cvt"] / MUFU_PER_CLK, sass["all"] / DISPATCH_PER_CLK)
        t_int = threads * per_clk / (SMS * _card_clock_hz()) * 1e3
        t_bytes = 4.0 * n / HBM_BYTES_S * 1e3
        if t_int >= t_bytes:
            return {"bound_ms": t_int, "bound_by": "operations"}
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    m, k, n = DROPOUT_MAIN
    return _bound(2.0 * m * k * n, PEAK_F32, 4 * (m * k + k * n + m * n))


def _check_dropout(d, a, b, seed, rate, keep) -> tuple[float, float, bool]:
    """(max-scaled and max absolute error of the output against the plain
    version, and whether the mask is exactly ``keep``: every dropped output
    0, every kept one the plain product's)."""
    plain = dxr._dropout_matmul_plain(a, b, seed, rate)
    diff = float((d - plain).abs().max())
    err = diff / float(plain.abs().max().clamp_min(1e-30)) if keep.any() else 0.0
    mask_ok = (bool((d[~keep] == 0).all()) and bool(((d != 0) == keep).all())
               and bool(((plain != 0) == keep).all()))
    return err, diff, mask_ok


def phase_rng_kernel(dev) -> None:
    """Kernels B10a (tml_random_uniform) and B10b (tml_dropout_matmul,
    csrc/dx_rng.cu) against their plain versions. B10a bit for bit at shapes
    (1,), (3, 5), (64, 128), (1000, 7), (8192, 8192) and seeds 0, 42, −1,
    2³¹ − 1; the Random123 known answers through rand.philox4x32_10 on the
    card (tests/test_rand.py:23-34). B10b's mask bit for bit against
    random_uniform_kernel(seed, (m, n)) > rate, its kept values within
    DROPOUT_TOL of the plain version's largest, f32 and bf16 operands, rates
    0, 0.1, 0.5 and 0.9, shapes (300, 96, 77), (256, 512, 128), (1, 1, 1)."""
    failures, cases, worst = [], 0, 0.0
    for seed in RNG_SEEDS:
        for shape in RNG_SHAPES:
            got = dxr.random_uniform_kernel(seed, shape, device=dev)
            ok = got.dtype == F32 and torch.equal(got, dxr._random_uniform_plain(seed, shape, dev))
            cases += 1
            if not ok:
                failures.append(f"uniform seed {seed} shape {shape}")
    for ctr, key, want in (((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
                           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
                            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD))):
        out = rand.philox4x32_10(torch.tensor([ctr], device=dev), torch.tensor([key], device=dev))
        got = [int(v) & 0xFFFFFFFF for v in out.view(torch.int32)[0].tolist()]
        cases += 1
        if got != list(want):
            failures.append(f"philox KAT {ctr}: {[hex(v) for v in got]}")
    gen = torch.Generator(device=dev).manual_seed(2727)
    for dtype in (F32, BF16):
        for m, k, n in DROPOUT_CASES:
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            for rate in DROPOUT_RATES:
                seed = 97 + m
                d = dxr.dropout_matmul_kernel(a, b, seed, rate)
                keep = dxr.random_uniform_kernel(seed, (m, n), device=dev) > rate
                err, _, mask_ok = _check_dropout(d, a, b, seed, rate, keep)
                cases += 1
                worst = max(worst, err)
                if not (mask_ok and err <= DROPOUT_TOL and d.dtype == F32 and d.shape == (m, n)):
                    failures.append(f"dropout {dtype} {(m, k, n)} rate {rate}: err {err:.3e} "
                                    f"mask {mask_ok}")
    torch.cuda.synchronize()
    print(f"[rng-kernel] {cases} cases, uniforms bit for bit, dropout worst vs plain "
          f"{worst:.3e} (tol {DROPOUT_TOL:g})", flush=True)
    if failures:
        raise SystemExit(f"chip_smoke: RNG kernel checks failed: {failures}")


def _ks_uniform(u) -> tuple[float, float]:
    """Kolmogorov–Smirnov statistic of the samples ``u`` against U(0, 1],
    sorted on the card, and its asymptotic p-value."""
    x = torch.sort(u.reshape(-1).double()).values
    n = x.numel()
    i = torch.arange(1, n + 1, device=x.device, dtype=torch.float64)
    d = float(torch.maximum(i / n - x, x - (i - 1) / n).max())
    lam = (math.sqrt(n) + 0.12 + 0.11 / math.sqrt(n)) * d
    p = 2.0 * sum((-1) ** (j - 1) * math.exp(-2.0 * j * j * lam * lam) for j in range(1, 101))
    return d, min(max(p, 0.0), 1.0)


def _generators_on_card(dev) -> list[str]:
    """Each rand family on the card against its words on the CPU, and the
    known answers: MT19937 against numpy's RandomState(1234) for 1500 words
    and at offset 700, Sobol's first words against the Gray-code recurrence
    on the host (and dimension 0's 0x80000000, 0xC0000000, 0x40000000)."""
    failures = []

    def bits(t):
        return t.view(torch.int32).cpu()

    for name, kw, count, off in (("PhiloxGenerator", {}, 100000, 13),
                                 ("ThreefryGenerator", {}, 100000, 65530),
                                 ("XorwowGenerator", {}, 20000, 5),
                                 ("Mrg32k3aGenerator", {}, 20000, 5),
                                 ("Mt19937Generator", {}, 20000, 700),
                                 ("Mtgp32Generator", {"nstreams": 8}, 20000, 100)):
        card = getattr(rand, name)(7, device=dev, **kw).set_offset(off)
        host = getattr(rand, name)(7, device="cpu", **kw).set_offset(off)
        for _ in range(2):
            if not torch.equal(bits(card.random_bits(count)), bits(host.random_bits(count))):
                failures.append(f"{name} card vs CPU")
        if not torch.equal(card.uniform(1000).cpu(), host.uniform(1000)):
            failures.append(f"{name} uniform card vs CPU")
    want = np.random.RandomState(1234).randint(0, 2**32, size=1500, dtype=np.uint64).astype(np.uint32)
    got = rand.Mt19937Generator(1234, device=dev).random_bits(1500)
    if not np.array_equal(bits(got).numpy().view(np.uint32), want):
        failures.append("MT19937 vs RandomState(1234)")
    got = rand.Mt19937Generator(1234, device=dev).set_offset(700).random_bits(100)
    if not np.array_equal(bits(got).numpy().view(np.uint32), want[700:800]):
        failures.append("MT19937 at offset 700")
    from tpumathlib_torch.rand import sobol
    for dim, scrambled in ((1, False), (50, False), (3, True)):
        g = rand.SobolGenerator(dim, scrambled, seed=99, device=dev)
        got = bits(g.random_bits(4096)).numpy().view(np.uint32)
        want = (sobol._sobol_words(sobol._direction_numbers(dim, 32), 0, 4096, 32)
                ^ g._shift_np[None, :]).astype(np.uint32)
        if not np.array_equal(got, want):
            failures.append(f"Sobol dim {dim} scrambled {scrambled}")
    first = bits(rand.SobolGenerator(1, device=dev).random_bits(3)).numpy().view(np.uint32)
    if first.reshape(-1).tolist() != [0x80000000, 0xC0000000, 0x40000000]:
        failures.append(f"Sobol dim 0 first words {first.reshape(-1)}")
    hi, lo = rand.SobolGenerator(12, bits=64, device=dev).random_bits(64)
    w64 = rand.SobolGenerator(12, bits=64, device="cpu").random_bits64(64)
    if not (np.array_equal(bits(hi).numpy().view(np.uint32), (w64 >> np.uint64(32)).astype(np.uint32))
            and np.array_equal(bits(lo).numpy().view(np.uint32), w64.astype(np.uint32))):
        failures.append("Sobol64 planar pair")
    return failures


def phase_rng_main(dev) -> dict:
    """The RNG main path, both counts set to 0 just before:
    random_uniform_kernel(seed, (8192, 8192)) and dropout_matmul_kernel at
    4096³ f32 with rate 0.1 and the same seed; each must grow its wrapper's
    count by one. The uniforms equal their plain version bit for bit, their
    mean, variance and a KS test against U(0, 1] (all 64 Mi, sorted on the
    card); the dropout's mask equals the first 4096² uniforms > 0.1 (the flat
    (4096, 4096) stream is the first 16 Mi words of the (8192, 8192) one),
    its zero share within ±0.002 of the rate, its kept values within
    DROPOUT_TOL of the plain version. Then PhiloxGenerator(seed)'s 64 Mi
    words on the card under the 24-bit map equal the uniforms, and every rand
    family on the card equals its CPU words (_generators_on_card)."""
    m, k, n = DROPOUT_MAIN
    gen = torch.Generator(device=dev).manual_seed(3131)
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    torch.cuda.synchronize()
    for f in RNG_COUNTS:
        f.launches = 0
    u = dxr.random_uniform_kernel(RNG_SEED, RNG_MAIN, device=dev)
    d = dxr.dropout_matmul_kernel(a, b, RNG_SEED, DROPOUT_RATE)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in RNG_COUNTS}
    print(f"[rng] launches in the main path: {launches}", flush=True)
    failures = [] if launches == {"_random_uniform": 1, "_dropout_matmul": 1} else ["launches"]

    exact = torch.equal(u, dxr._random_uniform_plain(RNG_SEED, RNG_MAIN, dev))
    mean, var = float(u.double().mean()), float(u.double().var())
    ks_d, ks_p = _ks_uniform(u)
    in_range = float(u.min()) > 0.0 and float(u.max()) <= 1.0
    ok = exact and in_range and abs(mean - 0.5) < 1e-3 and abs(var - 1 / 12) < 1e-3 and ks_p > 1e-4
    print(f"[rng] uniform {RNG_MAIN}: equals plain {exact} | mean {mean:.6f} var {var:.6f} "
          f"(1/12 = {1 / 12:.6f}) | KS D {ks_d:.3e} p {ks_p:.3f} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        failures.append("uniform")

    keep = u.reshape(-1)[:m * n].reshape(m, n) > DROPOUT_RATE
    err, diff, mask_ok = _check_dropout(d, a, b, RNG_SEED, DROPOUT_RATE, keep)
    zero_share = float((d == 0).double().mean())
    ok = mask_ok and err <= DROPOUT_TOL and abs(zero_share - DROPOUT_RATE) <= 0.002
    print(f"[rng] dropout {DROPOUT_MAIN} f32 rate {DROPOUT_RATE}: mask equals the uniforms' "
          f"{mask_ok} | kept vs plain {err:.3e} (tol {DROPOUT_TOL:g}) | zero share "
          f"{zero_share:.6f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append("dropout")

    words = rand.PhiloxGenerator(RNG_SEED, device=dev).random_bits(RNG_MAIN[0] * RNG_MAIN[1])
    same = torch.equal(dxr._uniform_from_words(rand.distributions.words(words)), u.reshape(-1))
    del words
    gen_fail = _generators_on_card(dev)
    print(f"[rng] PhiloxGenerator's 64 Mi words equal B10a's bits: {same} | every family on the "
          f"card equals its CPU words: {not gen_fail} {gen_fail}", flush=True)
    if not same or gen_fail:
        failures.append("generators")
    if failures:
        raise SystemExit(f"chip_smoke: RNG main path failed: {failures}")
    return {"launches": launches, "max_abs_err": {"uniform": 0.0, "dropout": diff},
            "args": (a, b)}


def phase_rng_times(run: dict, card: str) -> dict:
    """CUDA events around back-to-back calls (``_loop_ms``): B10a at (8192,
    8192) and B10b at 4096³ f32, their plain versions, and the yardsticks:
    torch.rand with a CUDA generator (torch's own Philox: the same
    distribution, other bits) and F.dropout(torch.matmul(a, b), 0.1) with
    TF32 off (no single torch call fuses the two), each beside its bound;
    GB/s for the uniforms."""
    a, b = run["args"]
    dev = a.device
    gen = torch.Generator(device=dev).manual_seed(5)
    n = RNG_MAIN[0] * RNG_MAIN[1]
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("chip_smoke: the dropout yardstick needs TF32 off")
    runs = {
        "uniform kernel": lambda: dxr.random_uniform_kernel(RNG_SEED, RNG_MAIN, device=dev),
        "uniform library": lambda: torch.rand(RNG_MAIN, device=dev, generator=gen),
        "dropout kernel": lambda: dxr.dropout_matmul_kernel(a, b, RNG_SEED, DROPOUT_RATE),
        "dropout composed": lambda: torch.nn.functional.dropout(torch.matmul(a, b), DROPOUT_RATE),
    }
    ms = _loop_ms(runs, warmup=2, reps=10, samples=5)
    ms.update(_loop_ms({
        "uniform plain": lambda: dxr._random_uniform_plain(RNG_SEED, RNG_MAIN, dev),
        "dropout plain": lambda: dxr._dropout_matmul_plain(a, b, RNG_SEED, DROPOUT_RATE),
    }, warmup=1, reps=2, samples=3))
    sass = _sass_counts("uniform_kernel")
    print(f"[rng-times] uniform_kernel SASS a thread (one Philox block): {sass}; clock "
          f"{_card_clock_hz() / 1e9:.3f} GHz", flush=True)
    ms["bounds"] = {"uniform": _rng_bound("uniform", sass), "dropout": _rng_bound("dropout")}
    for line in ("uniform", "dropout"):
        bound = ms["bounds"][line]
        for route in [r for r in ms if r.startswith(line + " ")]:
            t = ms[route]
            rate = f" {4.0 * n / t / 1e6:.1f} GB/s |" if line == "uniform" else \
                f" {2.0 * math.prod(DROPOUT_MAIN) / t / 1e9:.2f} TFLOP/s |"
            print(f"[rng-times] {route:18s} {t:.4f} ms |{rate} bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), {bound['bound_ms'] / t:.1%} "
                  f"of it | {card}", flush=True)
    return ms


VV10_KERNEL_GS = (7, 1500, 5000)   # phase 30's G: ragged against the 64-row block and 256-j tile
VV10_MAIN = 40960                  # G at which the reference's notes say XLA's value_and_grad ran
                                   # out of memory (tpumathlib/apps/vv10.py:69-73)
VV10_B, VV10_C = 5.9, 0.0093
VV10_COUNTS = (vv10._vv10_fwd, vv10._vv10_bwd)
# Kernel against its plain version and float64, max-scaled (each of the six
# sums over its largest; the energy relative): f32 sums of G terms in
# another order (the kernel's four strided lanes and a shuffle, torch's
# pairwise reduction).
VV10_TOL = {"sums": 1e-5, "energy": 1e-5, "grad": 1e-5}
VV10_FLOP = {"fwd": 17, "bwd": 36}   # a pair, an FMA as 2 (csrc/dx_vv10.cu's header)
VV10_RCP = {"fwd": 1, "bwd": 1}      # reciprocals a pair: one of g_i g_j (g_i + g_j)


def _vv10_inputs(g: int, dev, seed: int = 5):
    """tests/test_vv10.py:91-96's inputs, from a seed with numpy."""
    rs = np.random.default_rng(seed)
    rho = rs.uniform(0.01, 0.5, g).astype(np.float32)
    rho[::17] = 1e-12
    cols = (rho, rs.uniform(0, 0.1, g), rs.normal(size=(g, 3)) * 3, rs.uniform(0.001, 0.02, g))
    return [torch.tensor(np.asarray(c, np.float32), device=dev) for c in cols]


def _vv10_channels(rho, s2, w, dtype):
    """(wr, w0, κ) of the reference's channel chain, in ``dtype``."""
    rho, s2, w = (t.to(dtype) for t in (rho, s2, w))
    good = rho > 1e-9
    rs = torch.where(good, rho, 1.0)
    w0 = torch.sqrt(VV10_C * (s2 / (rs * rs)) ** 2 + (4.0 * math.pi) * rs / 3.0)
    kappa = VV10_B * (1.5 * math.pi) * (rs / (9.0 * math.pi)) ** (1.0 / 6.0)
    return torch.where(good, w * rho, 0.0), w0, kappa


def _sums_err(got, want) -> float:
    """The worst of each row's max|got − want| / max|want|."""
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    return max(float((g.double() - w.double()).abs().max() / w.double().abs().max())
               for g, w in zip(got, want))


@contextlib.contextmanager
def _vv10_plain():
    """_PairCore with the plain versions in the two wrappers' place."""
    saved = vv10._vv10_fwd, vv10._vv10_bwd
    vv10._vv10_fwd, vv10._vv10_bwd = vv10._vv10_fwd_plain, vv10._vv10_bwd_plain
    try:
        yield
    finally:
        vv10._vv10_fwd, vv10._vv10_bwd = saved


def phase_vv10_kernel(dev) -> None:
    """Kernel B11 (tml_vv10_fwd, tml_vv10_bwd, csrc/dx_vv10.cu) against its
    plain versions at G = 7, 1500 and 5000 (ragged against the tiles), with
    masked points: inner and the five backward sums each within
    VV10_TOL["sums"] of their largest; the plain versions in float64 as the
    oracle, at the same bound."""
    failures = []
    for g in VV10_KERNEL_GS:
        rho, s2, pts, w = _vv10_inputs(g, dev)
        ch = _vv10_channels(rho, s2, w, F32)
        ch64 = [t.double() for t in ch] + [pts.double()]
        for kind, kern, plain in (("fwd", vv10._vv10_fwd, vv10._vv10_fwd_plain),
                                  ("bwd", vv10._vv10_bwd, vv10._vv10_bwd_plain)):
            got = kern(*ch, pts)
            e_p = _sums_err(got, plain(*ch, pts))
            e_64 = _sums_err(got, plain(*ch64))
            ok = (e_p <= VV10_TOL["sums"] and e_64 <= VV10_TOL["sums"]
                  and bool(torch.isfinite(got).all()))
            print(f"[vv10-kernel] G={g:5d} {kind}: vs plain {e_p:.3e} | vs f64 {e_64:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"{kind} G={g}")
    if failures:
        raise SystemExit(f"chip_smoke: VV10 kernel checks failed: {failures}")


def _vv10_value_and_grad(rho, s2, pts, w):
    ts = [t.detach().clone().requires_grad_() for t in (rho, s2, pts, w)]
    e = vv10.vv10_pair_energy_pallas(*ts, VV10_B, VV10_C)
    return e, torch.autograd.grad(e, ts)


def _vv10_f64(rho, s2, pts, w):
    """Energy and gradients in float64 through the plain route: the chain in
    float64 and _PairCore's plain versions on float64."""
    ts = [t.double().requires_grad_() for t in (rho, s2, pts, w)]
    wr, w0, kappa = _vv10_channels(ts[0], ts[1], ts[3], torch.float64)
    with _vv10_plain():
        e = vv10._PairCore.apply(wr, w0, kappa, ts[2], vv10.vv10_beta(VV10_B))
        return e, torch.autograd.grad(e, ts)


def phase_vv10_main(dev) -> dict:
    """The VV10 main path at G = 40960 (1.68e9 pairs), both counts set to 0
    just before: vv10_pair_energy_pallas's energy and its gradients in ρ,
    |∇ρ|², the points and the weights through torch.autograd.grad; each
    kernel's count must grow by one. The energy (relative) and each gradient
    (max-scaled) against the f32 plain route and against float64, within
    VV10_TOL."""
    rho, s2, pts, w = _vv10_inputs(VV10_MAIN, dev)
    torch.cuda.synchronize()
    for f in VV10_COUNTS:
        f.launches = 0
    e, grads = _vv10_value_and_grad(rho, s2, pts, w)
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in VV10_COUNTS}
    print(f"[vv10] launches in the main path: {launches}", flush=True)
    with _vv10_plain():
        e_p, g_p = _vv10_value_and_grad(rho, s2, pts, w)
    e_64, g_64 = _vv10_f64(rho, s2, pts, w)
    e, e_p, e_64 = e.detach(), e_p.detach(), e_64.detach()
    rel = {"plain": abs(float(e) - float(e_p)) / abs(float(e_p)),
           "f64": abs(float(e) - float(e_64)) / abs(float(e_64))}
    ok = launches == {"_vv10_fwd": 1, "_vv10_bwd": 1} and max(rel.values()) <= VV10_TOL["energy"]
    print(f"[vv10] G={VV10_MAIN} energy {float(e):.9e} | rel vs plain {rel['plain']:.3e} | "
          f"vs f64 {rel['f64']:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    grad_abs = 0.0
    for name, g, gp, g64 in zip(("rho", "s2", "pts", "w"), grads, g_p, g_64):
        e_pl, e_f64 = _scaled(g, gp), _scaled(g.double(), g64)
        grad_abs = max(grad_abs, float((g - gp).abs().max()))
        good = e_pl <= VV10_TOL["grad"] and e_f64 <= VV10_TOL["grad"] and bool(torch.isfinite(g).all())
        ok = ok and good
        print(f"[vv10] d/d{name:4s} vs plain {e_pl:.3e} | vs f64 {e_f64:.3e} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("chip_smoke: VV10 main path failed")
    return {"launches": launches, "inputs": (rho, s2, pts, w),
            "max_abs_err": {"fwd": abs(float(e) - float(e_p)), "bwd": grad_abs}}


def _vv10_bound(kind: str) -> dict:
    """The bound of one sweep at G = VV10_MAIN: its flop at the f32 peak, or
    its reciprocals at MUFU_PER_CLK at the card's highest
    clock, the larger (the inputs' bytes are negligible)."""
    pairs = float(VV10_MAIN) ** 2
    t_flop = pairs * VV10_FLOP[kind] / PEAK_F32 * 1e3
    t_rcp = pairs * VV10_RCP[kind] / (SMS * MUFU_PER_CLK * _card_clock_hz()) * 1e3
    return {"bound_ms": max(t_flop, t_rcp), "bound_by": "operations"}


def phase_vv10_times(run: dict, card: str) -> dict:
    """CUDA events around back-to-back calls: the energy alone (the forward
    sweep) and value plus gradient (both sweeps), kernel route and plain
    route, and each sweep's kernel alone against its plain version, with
    Gpairs/s and the share of the bound. No torch call computes these sums,
    so there is no library yardstick: the plain version is timed instead."""
    rho, s2, pts, w = run["inputs"]
    ch = _vv10_channels(rho, s2, w, F32)

    def energy():
        with torch.no_grad():
            return vv10.vv10_pair_energy_pallas(rho, s2, pts, w, VV10_B, VV10_C)

    def plain(route):
        def call():
            with _vv10_plain():
                return route()
        return call

    runs = {"fwd kernel": lambda: vv10._vv10_fwd(*ch, pts),
            "bwd kernel": lambda: vv10._vv10_bwd(*ch, pts),
            "energy kernel": energy,
            "value_and_grad kernel": lambda: _vv10_value_and_grad(rho, s2, pts, w)}
    ms = _loop_ms(runs, warmup=2, reps=5, samples=5)
    ms.update(_loop_ms({"fwd plain": lambda: vv10._vv10_fwd_plain(*ch, pts),
                        "bwd plain": lambda: vv10._vv10_bwd_plain(*ch, pts),
                        "energy plain": plain(energy),
                        "value_and_grad plain": plain(lambda: _vv10_value_and_grad(rho, s2, pts, w))},
                       warmup=1, reps=2, samples=3))
    bounds = {"fwd": _vv10_bound("fwd"), "bwd": _vv10_bound("bwd")}
    bounds["energy"] = bounds["fwd"]
    bounds["value_and_grad"] = {"bound_ms": bounds["fwd"]["bound_ms"] + bounds["bwd"]["bound_ms"],
                                "bound_by": "operations"}
    pairs = float(VV10_MAIN) ** 2
    for line in ("fwd", "bwd", "energy", "value_and_grad"):
        bound = bounds[line]
        for kind in ("kernel", "plain"):
            t = ms[f"{line} {kind}"]
            print(f"[vv10-times] {line + ' ' + kind:22s} {t:.4f} ms | {pairs / t / 1e6:.1f} "
                  f"Gpairs/s | bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                  f"{bound['bound_ms'] / t:.1%} of it | {card}", flush=True)
    ms["bounds"] = bounds
    return ms


# ---------------------------------------------------------------------------
# Phases 33-35: the matmul four-step FFT in one and two launches (B5b, B5c)
# and the blocked-panel Cholesky (B4c)

# phase 33's N: every radix (2, 3, 4, 5, 8, 16) and the direct pass (127 and 12289 are prime,
# n1 = 1; 16383 = 3·43·127) in both modes
FOUR_STEP_NS = (2, 16, 127, 243, 360, 625, 1000, 4096, 8192, 12289, 16383, 16384)
FOUR_STEP_ROWS = 37                                 # a batch that is a multiple of no tile
FOUR_STEP_MAIN = ((4096, 4096), (1024, 16384))      # phase 34's (batch, N); the first is FFT_MAIN
BLOCKED_CASES = ((256, 128), (384, 256), (512, 384))   # (n, panel); 512/384 ends on a short panel
BLOCKED_PANEL = 256                                 # potrf_blocked's default panel
FOUR_STEP_TOL = 5e-6    # rel-L2 against the plain version: the same f32 sums in another order
FOUR_STEP_ROUTES = {"fused": fft_kernels.pallas_fft, "split": pallas_split.pallas_fft2}
BLOCKED_COUNTS = (blocked.potrf_blocked, blocked._chol_inv128, pallas_matmul)


def _blocked_counts(n: int, panel: int) -> tuple[int, int]:
    """(sweeps, B1 launches) of one potrf_blocked call: a sweep per 128-block;
    a trsm under every block but the last; an in-panel update after every
    block that is not its panel's last; a trailing syrk after every panel
    but the last."""
    widths = [min(panel, n - s) for s in range(0, n, panel)]
    blocks = n // 128
    return blocks, (blocks - 1) + sum(w // 128 - 1 for w in widths) + (len(widths) - 1)


def _blocked_failure_ok(l, pivot: int) -> bool:
    """Finite before the failing 128-block, non-finite on the diagonal from
    the failing pivot on."""
    b0 = pivot // 128 * 128
    return (bool(torch.isfinite(l[:, :b0]).all())
            and not bool(torch.isfinite(torch.diagonal(l)[pivot:]).any()))


def phase_four_step_kernel(dev) -> None:
    """33. pallas_fft (B5b, one launch) and pallas_fft2 (B5c, two launches),
    csrc/fft_four_step.cu, against their plain version (rel-L2 ≤
    FOUR_STEP_TOL) and a float64 FFT (rel-L2 < 1e-5,
    tests/test_fft_kernels.py:85) at each N of FOUR_STEP_NS on a batch of
    37: forward, inverse, a strided (2, 3, N) batch and bf16 planes; the
    round trip against N·x < 1e-4 (:63-74).
    Then potrf_blocked (B4c) at n = 256/panel 128, 384/256 and 512/384
    against its plain version (max-scaled 1e-5) and a float64 factor (5e-5
    max-relative, tests/test_solver_dense.py:318), with triu(L, 1) == 0; a
    non-SPD matrix, non-finite from its failing block on; and a panel of 192,
    which must raise."""
    gen = torch.Generator(device=dev).manual_seed(3333)
    failures, cases = [], 0
    for n in FOUR_STEP_NS:
        xr = torch.randn((FOUR_STEP_ROWS, n), generator=gen, device=dev)
        xi = torch.randn((FOUR_STEP_ROWS, n), generator=gen, device=dev)
        wide = torch.randn((2, 3, 2 * n), generator=gen, device=dev)[..., ::2]   # stride 2
        hr, hi = xr.bfloat16(), xi.bfloat16()
        x64 = _c128(xr, xi)
        inputs = [("fwd", (xr, xi), False, torch.fft.fft(x64)),
                  ("inv", (xr, xi), True, torch.fft.ifft(x64) * n),
                  ("(2,3,N) strided", (wide, wide.flip(0)), False,
                   torch.fft.fft(_c128(wide, wide.flip(0)))),
                  ("bf16 planes", (hr, hi), False, torch.fft.fft(_c128(hr, hi)))]
        for kind, fn in FOUR_STEP_ROUTES.items():
            for what, (ar, ai), inverse, want in inputs:
                got = fn(ar, ai, inverse=inverse)
                plain = fft_kernels._four_step_plain(ar, ai, inverse)
                torch.cuda.synchronize()
                g = _c128(*got)
                vs_plain, vs_f64 = _rel(g, _c128(*plain)), _rel(g, want)
                ok = (vs_plain <= FOUR_STEP_TOL and vs_f64 < 1e-5 and got[0].dtype == F32
                      and got[0].shape == ar.shape and bool(torch.isfinite(g).all()))
                cases += 1
                if not ok:
                    failures.append(f"{kind} N={n} {what}")
                print(f"[four-step] {kind:5s} N={n:5d} {what:16s} vs plain {vs_plain:.3e} "
                      f"(tol {FOUR_STEP_TOL:g}) vs f64 {vs_f64:.3e} (tol 1e-5) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
            back = fn(*fn(xr, xi), inverse=True)
            err = _rel(_c128(*back), n * x64)
            cases += 1
            if not err < 1e-4:
                failures.append(f"{kind} N={n} round trip")
            print(f"[four-step] {kind:5s} N={n:5d} inverse(forward(x)) vs N·x {err:.3e} (tol 1e-4) "
                  f"{'ok' if err < 1e-4 else 'FAIL'}", flush=True)
    for n, panel in BLOCKED_CASES:
        a = _spd(gen, n, dev)
        got = blocked.potrf_blocked(a, panel)
        plain = blocked._potrf_blocked_plain(a, panel)
        l64 = torch.linalg.cholesky(a.double())
        rel = float((got.double() - l64).abs().max() / l64.abs().max())
        vs_plain = max_scaled_err(got, plain)
        upper_zero = bool((torch.triu(got, 1) == 0).all())
        ok = (rel < 5e-5 and vs_plain <= 1e-5 and upper_zero and got.dtype == F32
              and bool(torch.isfinite(got).all()))
        cases += 1
        if not ok:
            failures.append(f"potrf_blocked n={n} panel={panel}")
        print(f"[four-step] potrf_blocked n={n} panel={panel}: vs f64 max-rel {rel:.3e} (tol 5e-5) "
              f"vs plain max-scaled {vs_plain:.3e} (tol 1e-5) upper=0 {upper_zero} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    bad = _spd(gen, 512, dev)
    bad[300, 300] = -1.0   # the factor fails at pivot 300, in its third 128-block
    got, plain = blocked.potrf_blocked(bad, BLOCKED_PANEL), blocked._potrf_blocked_plain(bad)
    ok = _blocked_failure_ok(got, 300) and _blocked_failure_ok(plain, 300)
    cases += 1
    if not ok:
        failures.append("potrf_blocked not SPD")
    print(f"[four-step] potrf_blocked not SPD at pivot 300: finite before its block, non-finite "
          f"diagonal from it on (kernel and plain) {'ok' if ok else 'FAIL'}", flush=True)
    try:
        blocked.potrf_blocked(_spd(gen, 256, dev), 192)
        refused = False
    except InvalidValueError:
        refused = True
    cases += 1
    if not refused:
        failures.append("potrf_blocked panel 192 accepted")
    print(f"[four-step] potrf_blocked panel=192 refused (C19) {refused}", flush=True)
    if failures:
        raise SystemExit(f"chip_smoke: {len(failures)} of {cases} four-step/blocked cases "
                         f"failed: {failures}")
    print(f"[four-step] {cases} cases agree", flush=True)


def _four_step_steps(x: dict) -> dict:
    """Phase 34's calls in order, name: (call, the launches it must add; every
    other count must stay)."""
    steps = {}
    for (b, n), (xr, xi) in x["planes"].items():
        for kind, fn in FOUR_STEP_ROUTES.items():
            for inverse in (False, True):
                steps[f"{kind} b{b} N{n} {'inverse' if inverse else 'forward'}"] = (
                    lambda fn=fn, xr=xr, xi=xi, inverse=inverse: fn(xr, xi, inverse=inverse),
                    {fn.__name__: 1 if kind == "fused" else 2})
    sweeps, gemms = _blocked_counts(SOLVER_N, BLOCKED_PANEL)
    steps[f"potrf_blocked n{SOLVER_N} panel{BLOCKED_PANEL}"] = (
        lambda: blocked.potrf_blocked(x["a"], BLOCKED_PANEL),
        {"potrf_blocked": 1, "_chol_inv128": sweeps, "pallas_matmul": gemms})
    return steps


def phase_four_step_main(dev) -> dict:
    """34. The slice at full width, each call's launches counted (every count
    set to 0 just before): pallas_fft and pallas_fft2 at batch 4096 × N 4096
    f32 planes (the bench FFT shape) and 1024 × 16384, both directions (+1
    launch a call for B5b, +2 for B5c), against the plain version (rel-L2 ≤
    FOUR_STEP_TOL) and float64 (< 1e-5); then solver.potrf_blocked at n =
    4096, panel 256 (+32 sweeps, +62 B1), against its plain version
    (max-scaled 1e-5) and a float64 factor (5e-5 max-relative), upper
    triangle exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(3434)
    x = {"planes": {(b, n): (torch.randn((b, n), generator=gen, device=dev),
                             torch.randn((b, n), generator=gen, device=dev))
                    for b, n in FOUR_STEP_MAIN},
         "a": _spd(gen, SOLVER_N, dev)}
    steps = _four_step_steps(x)
    counts = tuple(FOUR_STEP_ROUTES.values()) + BLOCKED_COUNTS
    torch.cuda.synchronize()
    for f in counts:
        f.launches = 0
    outs, grew = {}, {}
    for name, (step, _) in steps.items():
        before = {f.__name__: f.launches for f in counts}
        outs[name] = step()
        grew[name] = {f.__name__: f.launches - before[f.__name__] for f in counts}
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counts}
    print(f"[four-step-main] launches in the main path: {launches}", flush=True)

    failures, max_abs = [], {"fused": 0.0, "split": 0.0, "blocked": 0.0}
    for name, (_, want) in steps.items():
        out = outs.pop(name)
        launched = grew[name] == {key: want.get(key, 0) for key in grew[name]}
        if name.startswith("potrf_blocked"):
            a = x["a"]
            l64 = torch.linalg.cholesky(a.double())
            rel = float((out.double() - l64).abs().max() / l64.abs().max())
            plain = blocked._potrf_blocked_plain(a, BLOCKED_PANEL)
            vs_plain = max_scaled_err(out, plain)
            max_abs["blocked"] = max_abs_rel(out, plain)[0]
            upper_zero = bool((torch.triu(out, 1) == 0).all())
            ok = rel < 5e-5 and vs_plain <= 1e-5 and upper_zero and out.dtype == F32
            detail = (f"vs f64 max-rel {rel:.3e} (tol 5e-5) vs plain max-scaled {vs_plain:.3e} "
                      f"(tol 1e-5) upper=0 {upper_zero}")
            tensors = (out,)
        else:
            kind, size, n_tag, direction = name.split()
            b, n = int(size[1:]), int(n_tag[1:])
            xr, xi = x["planes"][(b, n)]
            inverse = direction == "inverse"
            x64 = _c128(xr, xi)
            want64 = torch.fft.ifft(x64) * n if inverse else torch.fft.fft(x64)
            del x64
            got = _c128(*out)
            plain = _c128(*fft_kernels._four_step_plain(xr, xi, inverse))
            vs_plain, vs_f64 = _rel(got, plain), _rel(got, want64)
            max_abs[kind] = max(max_abs[kind], float((got - plain).abs().max()))
            del plain, want64, got
            ok = vs_plain <= FOUR_STEP_TOL and vs_f64 < 1e-5 and out[0].shape == (b, n)
            detail = (f"vs plain {vs_plain:.3e} (tol {FOUR_STEP_TOL:g}) vs f64 {vs_f64:.3e} "
                      f"(tol 1e-5)")
            tensors = out
        ok = ok and launched and all(bool(torch.isfinite(t).all()) for t in tensors)
        print(f"[four-step-main] {name:34s} launches {grew[name]} | {detail} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(name)
    if failures:
        raise SystemExit(f"chip_smoke: four-step/blocked main path failed: {failures}")
    return {"launches": launches, "max_abs_err": max_abs, "x": x}


def _four_step_bound(kind: str, b: int = 0, n: int = 0) -> dict:
    """The function's bound: for the FFT, an FFT's 5·N·log2 N flop a row at
    the f32 peak against its planes read and written once, 16·b·N bytes (as
    phase 14 counts B5; the DFT products do 8·N·(n1 + n2) flop a row, more
    than the function needs); for potrf_blocked, n³/3 flop against the
    matrix read and its factor written."""
    if kind == "blocked":
        return _bound(SOLVER_N ** 3 / 3, PEAK_F32, 2 * 4 * SOLVER_N ** 2)
    return _bound(5.0 * b * n * math.log2(n), PEAK_F32, 16.0 * b * n)


def _split_own_bound(b: int, n: int) -> dict:
    """B5c's own floor: its two launches read and write the planes twice
    (32·b·N bytes), where the function needs 16·b·N."""
    return _bound(0.0, PEAK_F32, 32.0 * b * n)


def _host_ms(fn, reps: int = 20) -> tuple[float, float]:
    """(enqueue, wall) ms a call of ``reps`` calls back to back on the host
    clock: the enqueue before the closing synchronize, the wall after it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / reps * 1e3, (t2 - t0) / reps * 1e3


def _ptxas_entries(name: str) -> list[dict]:
    """Registers, stack and spills of each compiled kernel whose mangled name
    holds ``name``, from nvcc.log beside the built library."""
    log = (cuda_utils.build_kernels().parent / "nvcc.log").read_text()
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"entry": m.group(1)} if name in m.group(1) else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def _blocks_per_sm(threads: int, registers: int, smem: int) -> int:
    """Blocks an H100 SM holds: 65536 registers (allocated 256 a warp at a
    time), 228 KB of shared memory (1 KB reserved a block), 2048 threads, 32
    blocks."""
    warps = -(-threads // 32)
    regs = warps * (-(-registers * 32 // 256) * 256)
    return min(65536 // regs, (228 * 1024) // (smem + 1024), 2048 // threads, 32)


def _four_step_resources() -> dict:
    """Each four-step kernel's ptxas report, and each main-path launch's
    threads, shared memory and blocks an SM (as the C side sizes them)."""
    kernels = {}
    for e in _ptxas_entries("four_step_kernel"):
        m = re.search(r"four_step_kernelILi(\d+)E", e["entry"])
        points = int(m.group(1)) if m else 0
        label = (f"four_step_kernel<{points}> "
                 f"({'power of two' if points == fft_kernels.FOUR_STEP_POINTS_POW2 else 'other N'})")
        e["points"] = points
        kernels[label] = e
        print(f"[four-step-times] {label}: {e.get('registers')} registers, {e.get('stack')} bytes "
              f"stack, spill stores {e.get('spill_stores')} / loads {e.get('spill_loads')} bytes "
              f"(nvcc.log)", flush=True)
    launches = {}
    regs = {e["points"]: e.get("registers", 0) for e in kernels.values()}
    for _, n in FOUR_STEP_MAIN:
        for mode in (1, 2):
            for i, lp in enumerate(fft_kernels._four_step_plan(n, mode).launches):
                ld = fft_kernels._four_step_plane_floats(n, lp.lanes, mode == 2 and i == 0)
                smem = 4 * lp.rows * (2 * ld + 1)
                per_sm = _blocks_per_sm(lp.threads * lp.rows, regs[lp.points], smem) \
                    if regs.get(lp.points) else None
                key = f"N{n} mode {mode} launch {i + 1}"
                launches[key] = {"radices": lp.radices, "threads": lp.threads * lp.rows,
                                 "smem": smem, "blocks_per_sm": per_sm}
                print(f"[four-step-times] {key}: radices {lp.radices}, {lp.threads * lp.rows} "
                      f"threads, {smem} B shared memory, {per_sm} blocks an SM "
                      f"({None if per_sm is None else per_sm * lp.threads * lp.rows // 32} warps)",
                      flush=True)
    return {"kernels": kernels, "launches": launches}


def phase_four_step_times(run: dict, card: str) -> dict:
    """35. CUDA events around back-to-back calls (``_loop_ms``: warm-ups,
    medians of samples taken twice in turns) of each route of phase 34, its
    plain version and the library call for the same function
    (torch.fft.fft / torch.fft.ifft(norm="forward"), unnormalised, on the
    complex64 equivalent;
    torch.linalg.cholesky at n = 4096), each beside its bound; B5c also
    beside its own two-pass bound. Then each four-step route's host clock
    per call of 20 back to back (enqueue, wall, wall − device) and the
    kernels' resources."""
    x = run["x"]
    kernels, plains, library, bounds = {}, {}, {}, {}
    for (b, n), (xr, xi) in x["planes"].items():
        xc = torch.complex(xr, xi)
        library[f"fft b{b} N{n} forward library"] = lambda xc=xc: torch.fft.fft(xc)
        library[f"fft b{b} N{n} inverse library"] = (   # unnormalised, as the kernel's
            lambda xc=xc: torch.fft.ifft(xc, norm="forward"))
        for kind, fn in FOUR_STEP_ROUTES.items():
            bounds[kind if (b, n) == FOUR_STEP_MAIN[0] else f"{kind} b{b} N{n}"] = \
                _four_step_bound(kind, b, n)
            for inverse in (False, True):
                line = f"{kind} b{b} N{n} {'inverse' if inverse else 'forward'}"
                kernels[f"{line} kernel"] = (lambda fn=fn, xr=xr, xi=xi, inverse=inverse:
                                             fn(xr, xi, inverse=inverse))
                plains[f"{line} plain"] = (lambda xr=xr, xi=xi, inverse=inverse:
                                           fft_kernels._four_step_plain(xr, xi, inverse))
    ms = _loop_ms({**kernels, **library}, warmup=3, reps=10, samples=5)
    ms.update(_loop_ms(plains, warmup=1, reps=3, samples=3))
    a = x["a"]
    ms.update(_loop_ms({"blocked kernel": lambda: blocked.potrf_blocked(a, BLOCKED_PANEL),
                        "blocked library": lambda: torch.linalg.cholesky(a)},
                       warmup=2, reps=3, samples=5))
    ms.update(_loop_ms({"blocked plain": lambda: blocked._potrf_blocked_plain(a, BLOCKED_PANEL)},
                       warmup=1, reps=1, samples=2))
    dev_ms, host_ms, covered = _queued_ms(lambda: blocked.potrf_blocked(a, BLOCKED_PANEL), 3)
    print(f"[four-step-times] blocked kernel device {dev_ms:.4f} ms (back to back behind a spin, "
          f"spin covered {covered}) | host enqueue {host_ms:.4f} ms a call (no synchronise) | "
          f"{card}", flush=True)
    bounds["blocked"] = _four_step_bound("blocked")
    for route, t in ms.items():
        own = ""
        if route.startswith("blocked"):
            bound = bounds["blocked"]
            rate = f"{SOLVER_N ** 3 / 3 / t / 1e6:.1f} GFLOP/s (n³/3)"
        elif route.endswith("library"):
            continue
        else:
            kind, size, n_tag = route.split()[:3]
            b, n = int(size[1:]), int(n_tag[1:])
            bound = bounds[kind if (b, n) == FOUR_STEP_MAIN[0] else f"{kind} b{b} N{n}"]
            rate = f"{16.0 * b * n / t / 1e6:.1f} GB/s (16·b·N/t)"
            if kind == "split":
                mine = _split_own_bound(b, n)
                own = (f" | own bound {mine['bound_ms']:.4f} ms (32·b·N bytes), "
                       f"{mine['bound_ms'] / t:.1%} of it")
        print(f"[four-step-times] {route:36s} {t:.4f} ms | {rate} | bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), {bound['bound_ms'] / t:.1%} of it{own} | {card}", flush=True)
    for route, t in ms.items():
        if route.endswith("library") and not route.startswith("blocked"):
            b, n = (int(v[1:]) for v in route.split()[1:3])
            bound = _four_step_bound("fused", b, n)
            print(f"[four-step-times] {route:36s} {t:.4f} ms | {16.0 * b * n / t / 1e6:.1f} GB/s | "
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                  f"{bound['bound_ms'] / t:.1%} of it | {card}", flush=True)
    host = {}
    for route, fn in kernels.items():
        enqueue, wall = _host_ms(fn)
        host[route] = {"enqueue_ms": enqueue, "wall_ms": wall, "wall_minus_device_ms": wall - ms[route]}
        print(f"[four-step-times] {route:36s} host clock, 20 calls back to back: enqueue "
              f"{enqueue:.4f} ms a call, wall {wall:.4f} ms, device {ms[route]:.4f} ms, wall − device "
              f"{wall - ms[route]:+.4f} ms | {card}", flush=True)
    ms["host"] = host
    ms["resources"] = _four_step_resources()
    ms["bounds"] = bounds
    ms["split own bounds"] = {f"b{b} N{n}": _split_own_bound(b, n) for b, n in FOUR_STEP_MAIN}
    return ms


# ---------------------------------------------------------------------------
# Phases 36-38: the Mp tier's tensor-parallel matmul and the ring-overlapped
# AllGather+GEMM / GEMM+ReduceScatter (B12a, B12b), four ranks on one card

MP_RANKS = 4                        # the TP degree; all four ranks on the one card
MP_KERNEL_P = (1, 2, 4)             # phase 36's ring sizes
# phase 36's (m, k, n); the second leaves ragged tiles (k a rank 75 or 150, n 50 or 100)
MP_KERNEL_SHAPES = ((1024, 512, 512), (1000, 300, 200))
MP_REPS = 20                        # phase 36's calls a case, each held against the plain version
# (tokens, n_embd, n_inner): GPT-J-6B's MLP (EleutherAI/gpt-j-6b config.json: n_embd 4096,
# n_inner null so 4 · 4096) over 8192 tokens, 4 × its n_positions 2048
MP_MAIN = (8192, 4096, 16384)
MP_PBLAS = (4096, 512, 512)         # phase 37's PBLAS (m, k, n) over MP_RANKS ranks
MP_TOL = {F32: 1e-5, BF16: 1e-2}    # kernel route against the plain version, max-scaled
MP_F64_TOL = 1e-4                   # tests/test_mp_matmul.py's and test_mp_pblas.py's rtol
MP_RING = {"ag": overlap.matmul_ag_overlapped, "rs": overlap.matmul_rs_overlapped}


def _ring_counts() -> tuple:
    return (overlap.matmul_ag_overlapped.launches, overlap.matmul_rs_overlapped.launches,
            overlap.matmul_rs_overlapped.accumulates)


def _ring_expect(kind: str, nr: int) -> tuple:
    """(ring AG GEMMs, ring RS GEMMs, accumulates) one call launches."""
    return (nr * nr, 0, 0) if kind == "ag" else (0, nr * nr, nr * (nr - 1))


@contextlib.contextmanager
def _ring_plain():
    """The rings with their two kernels' plain versions in the wrappers'
    place: the same schedule, streams and events, torch ops on each stream."""
    saved = overlap._ring_gemm, overlap._ring_accumulate
    overlap._ring_gemm = lambda a, b, out, count: overlap._ring_gemm_plain(a, b, out)
    overlap._ring_accumulate = overlap._ring_accumulate_plain
    try:
        yield
    finally:
        overlap._ring_gemm, overlap._ring_accumulate = saved


def _ring_operands(grid, kind, a, b):
    """a and b sharded with the ring's in-specs."""
    if kind == "ag":
        return grid.shard(a, ("x", None)), grid.shard(b, (None, "x"))
    return grid.shard(a, (None, "x")), grid.shard(b, ("x", None))


def phase_mp_kernel(dev) -> None:
    """36. The two rings (csrc/mp_overlap.cu: tml_ring_gemm, and
    tml_ring_accumulate for B12b) against their plain versions (the same
    schedule with torch ops), P ranks on this one card: at P = 1, 2, 4, f32
    and bf16, each (m, k, n) of MP_KERNEL_SHAPES, MP_REPS calls each, every
    call held to MP_TOL (max-scaled: 1e-5 f32, the same f32 products summed
    in another order where cuBLAS splits k, bit for bit where it does not;
    1e-2 bf16, an output ulp where the two sums round apart) and growing the
    counts by exactly P² GEMMs (and P(P − 1) accumulates); then twice at
    full width, 4 ranks, f32."""
    gen = torch.Generator(device=dev).manual_seed(3636)
    failures, cases = [], 0

    def run(kind, grid, a, b, tol, reps, label):
        """Calls alternate between A and −A: the ring's buffers come back
        from the allocator holding the last call's values, which are then
        wrong, so a read that does not wait for its write shows."""
        nonlocal cases
        fn, nr = MP_RING[kind], grid.size
        operands = [_ring_operands(grid, kind, sign * a, b) for sign in (1, -1)]
        with _ring_plain():
            wants = [fn(*ops, grid).full() for ops in operands]
        worst, bad = 0.0, 0
        for rep in range(reps):
            before = _ring_counts()
            got = fn(*operands[rep % 2], grid)
            grew = tuple(y - x for x, y in zip(before, _ring_counts()))
            full, want = got.full(), wants[rep % 2]
            torch.cuda.synchronize()
            err = max_scaled_err(full, want)
            worst = max(worst, err)
            ok = (err <= tol and grew == _ring_expect(kind, nr) and full.shape == want.shape
                  and full.dtype == a.dtype and bool(torch.isfinite(full.float()).all()))
            bad += not ok
            cases += 1
        if bad:
            failures.append(f"{label} ({bad} of {reps} calls)")
        print(f"[mp-kernel] {label}: {reps} calls, worst max-scaled err vs plain {worst:.3e} "
              f"(tol {tol:g}), launches a call {_ring_expect(kind, nr)} "
              f"{'ok' if not bad else 'FAIL'}", flush=True)
        return worst

    for (m, k, n), nr, dtype in itertools.product(MP_KERNEL_SHAPES, MP_KERNEL_P, (F32, BF16)):
        grid = mp.Grid.create([dev] * nr)
        a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
        for kind in MP_RING:
            run(kind, grid, a, b, MP_TOL[dtype], MP_REPS,
                f"{kind} P={nr} {str(dtype)[6:]} ({m}, {k}, {n})")
    s, hd, f = MP_MAIN
    grid = mp.Grid.create([dev] * MP_RANKS)
    x = torch.randn((s, hd), generator=gen, device=dev)
    w = torch.randn((hd, f), generator=gen, device=dev) / math.sqrt(hd)
    run("ag", grid, x, w, MP_TOL[F32], 2, f"ag P={MP_RANKS} float32 ({s}, {hd}, {f})")
    del x, w
    hmid = torch.randn((s, f), generator=gen, device=dev)
    w = torch.randn((f, hd), generator=gen, device=dev) / math.sqrt(f)
    run("rs", grid, hmid, w, MP_TOL[F32], 2, f"rs P={MP_RANKS} float32 ({s}, {f}, {hd})")
    if failures:
        raise SystemExit(f"chip_smoke: ring kernels disagree with their plain versions: "
                         f"{failures}")
    print(f"[mp-kernel] {cases} calls agree", flush=True)


def _mp64_err(got, want64) -> float:
    """Max-scaled error of a Sharded result against a float64 tensor."""
    return max_scaled_err(got.full(), want64)


def _pblas_steps(grid, gen, dev) -> dict:
    """Phase 37's PBLAS calls at MP_PBLAS over the grid, name: (call, its
    float64 result), the checks of tests/test_mp_pblas.py."""
    m, k, n = MP_PBLAS
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)   # noqa: E731
    a, b, c, sq, bn, cn = rnd(m, k), rnd(m, k), rnd(m, m), rnd(m, m), rnd(m, n), rnd(m, n)
    a64, b64, c64, sq64, bn64, cn64 = (t.double() for t in (a, b, c, sq, bn, cn))
    low = torch.ones((m, m), device=dev, dtype=torch.bool).tril()
    tsolve = sq + m * torch.eye(m, device=dev) * torch.sign(torch.diagonal(sq) + 0.1)
    sym = torch.where(low, sq64, sq64.mT)
    return {
        "mp_syrk lower": (lambda: mp.mp_syrk(a, c, grid, alpha=2.0, beta=0.5),
                          torch.where(low, 2.0 * a64 @ a64.mT + 0.5 * c64, c64)),
        "mp_syr2k upper": (lambda: mp.mp_syr2k(a, b, c, grid, alpha=1.5, beta=0.5, uplo="upper"),
                           torch.where(low.mT, 1.5 * (a64 @ b64.mT + b64 @ a64.mT) + 0.5 * c64,
                                       c64)),
        "mp_syrkx lower": (lambda: mp.mp_syrkx(a, b, c, grid, alpha=1.5, beta=0.5),
                           torch.where(low, 1.5 * a64 @ b64.mT + 0.5 * c64, c64)),
        "mp_symm lower": (lambda: mp.mp_symm(sq, bn, cn, grid, alpha=2.0, beta=-1.0),
                          2.0 * sym @ bn64 - cn64),
        "mp_trmm upper trans unit": (
            lambda: mp.mp_trmm(sq, bn, grid, alpha=1.5, uplo="upper", trans=True, unit=True),
            1.5 * (torch.triu(sq64, 1) + torch.eye(m, device=dev, dtype=torch.float64)).mT
            @ bn64),
        "mp_trsm lower": (lambda: mp.mp_trsm(tsolve, bn, grid, alpha=2.0),
                          torch.linalg.solve_triangular(torch.tril(tsolve.double()), 2.0 * bn64,
                                                        upper=False)),
        "mp_geadd trans": (lambda: mp.mp_geadd(sq, c, grid, alpha=2.0, beta=0.5, trans=True),
                           2.0 * sq64.mT + 0.5 * c64),
        "mp_tradd upper": (lambda: mp.mp_tradd(sq, c, grid, alpha=2.0, beta=0.5, uplo="upper"),
                           torch.where(low.mT, 2.0 * sq64 + 0.5 * c64, c64)),
    }


def phase_mp_main(dev) -> dict:
    """37. The Mp slice at full width, four ranks on the card, every count
    set to 0 just before: entry.dryrun_multichip (tp_matmul with B1 and the
    GELU epilogue over GPT-J-6B's MLP, MP_MAIN, then gemr2d; +4 B1
    launches); the overlapped pair matmul_rs_overlapped(matmul_ag_overlapped(x,
    w1), w2) (+16 and +16 ring GEMMs, +12 accumulates); matmul_allreduce; and
    the eight PBLAS ops at MP_PBLAS. Each against a single-device float64
    result at MP_F64_TOL, max-scaled; the pair also against its plain
    version."""
    s, hd, f = MP_MAIN
    gen = torch.Generator(device=dev).manual_seed(3737)
    grid = mp.Grid.create([dev] * MP_RANKS)
    counts = (overlap.matmul_ag_overlapped, overlap.matmul_rs_overlapped, pallas_matmul)
    torch.cuda.synchronize()
    for fn in counts:
        fn.launches = 0
    overlap.matmul_rs_overlapped.accumulates = 0
    failures, grew, errs = [], {}, {}

    def step(name, call):
        before = (*_ring_counts(), pallas_matmul.launches)
        out = call()
        torch.cuda.synchronize()
        grew[name] = tuple(y - x for x, y in zip(before, (*_ring_counts(),
                                                          pallas_matmul.launches)))
        return out

    dry = step("dryrun_multichip", lambda: dryrun_multichip(MP_RANKS, [dev] * MP_RANKS, s=s, h=hd,
                                                            f=f, seed=3737))
    x, w1, w2 = dry["inputs"]
    errs["dryrun_multichip"] = dry["max_scaled_err"]
    xs, w1s = grid.shard(x, ("x", None)), grid.shard(w1, (None, "x"))
    w2s = grid.shard(w2, ("x", None))
    h = step("matmul_ag_overlapped", lambda: overlap.matmul_ag_overlapped(xs, w1s, grid))
    out = step("matmul_rs_overlapped", lambda: overlap.matmul_rs_overlapped(h, w2s, grid))
    allreduce = step("matmul_allreduce", lambda: mp.matmul_allreduce(h, w2s, grid))
    pblas = {name: (step(name, call), want) for name, (call, want)
             in _pblas_steps(grid, gen, dev).items()}
    launches = {"matmul_ag_overlapped": overlap.matmul_ag_overlapped.launches,
                "matmul_rs_overlapped": overlap.matmul_rs_overlapped.launches,
                "accumulates": overlap.matmul_rs_overlapped.accumulates,
                "pallas_matmul": pallas_matmul.launches}
    print(f"[mp-main] launches in the main path: {launches}", flush=True)

    h64 = x.double() @ w1.double()
    errs["matmul_ag_overlapped"] = _mp64_err(h, h64)
    want64 = h64 @ w2.double()
    del h64
    errs["matmul_rs_overlapped"] = _mp64_err(out, want64)
    errs["matmul_allreduce"] = _mp64_err(allreduce, want64)
    del want64
    with _ring_plain():
        h_plain = overlap.matmul_ag_overlapped(xs, w1s, grid)
        out_plain = overlap.matmul_rs_overlapped(h_plain, w2s, grid)
    max_abs = {"ag": max_abs_rel(h.full(), h_plain.full())[0],
               "rs": max_abs_rel(out.full(), out_plain.full())[0]}
    vs_plain = {"matmul_ag_overlapped": max_scaled_err(h.full(), h_plain.full()),
                "matmul_rs_overlapped": max_scaled_err(out.full(), out_plain.full())}
    del h_plain, out_plain
    for name, (got, want) in pblas.items():
        errs[name] = _mp64_err(got, want)
    expect = {"dryrun_multichip": (0, 0, 0, MP_RANKS),
              "matmul_ag_overlapped": (*_ring_expect("ag", MP_RANKS), 0),
              "matmul_rs_overlapped": (*_ring_expect("rs", MP_RANKS), 0)}
    specs = {"dryrun_multichip": (dry["out"], ("x", None)),
             "matmul_ag_overlapped": (h, (None, "x")), "matmul_rs_overlapped": (out, ("x", None)),
             "matmul_allreduce": (allreduce, (None, None)),
             **{name: (got, ("x", None)) for name, (got, _) in pblas.items()}}
    for name, err in errs.items():
        got_spec = specs[name][0].spec
        ok = (err <= MP_F64_TOL and grew[name] == expect.get(name, (0, 0, 0, 0))
              and got_spec == specs[name][1] and vs_plain.get(name, 0.0) <= MP_TOL[F32])
        extra = (f" | vs plain max-scaled {vs_plain[name]:.3e} (tol {MP_TOL[F32]:g})"
                 if name in vs_plain else "")
        print(f"[mp-main] {name:26s} launches (ag, rs, acc, B1) {grew[name]} | vs f64 max-scaled "
              f"{err:.3e} (tol {MP_F64_TOL:g}) | spec {got_spec}{extra} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(name)
    if failures:
        raise SystemExit(f"chip_smoke: Mp main path failed: {failures}")
    return {"launches": launches, "max_abs_err": max_abs, "grid": grid,
            "operands": {"ag": (xs, w1s), "rs": (h, w2s)}}


def _ring_parts(kind: str, grid, a, b) -> dict:
    """The ring's P² GEMM launches alone (no copies; B12b's accumulates
    alone too) and its copies alone (no GEMMs, each chunk's chain of sends
    kept), each on the grid's own streams between the ring's entry and exit
    waits, calling the kernel wrappers directly."""
    ring, nr = overlap._Ring(grid), grid.size
    count = MP_RING[kind]
    dev = grid.devices
    if kind == "ag":
        mloc, k = a.shape[0] // nr, a.shape[1]
        full = [a.full(d) for d in dev]
        outs = [torch.empty((a.shape[0], bp.shape[1]), device=d) for bp, d in zip(b.pieces, dev)]
        slots = [[torch.empty((mloc, k), device=d) for _ in range(nr)] for d in dev]

        def gemms():
            ring.enter()
            for r in range(nr):
                with ring.on(r, overlap.COMPUTE):
                    for c in range(nr):
                        overlap._ring_gemm(full[r][c * mloc:(c + 1) * mloc], b.pieces[r],
                                           outs[r][c * mloc:(c + 1) * mloc], count)
            ring.exit()

        def chunk(r, step):
            c = (r - step) % nr
            return a.pieces[r] if step == 0 else slots[r][c], c
    else:
        sp, h = a.shape[0] // nr, b.shape[1]
        slots = [torch.empty((nr, sp, h), device=d) for d in dev]
        mine = [torch.empty((sp, h), device=d) for d in dev]

        def gemms():
            ring.enter()
            for r in range(nr):
                with ring.on(r, overlap.COMPUTE):
                    for c in range(nr):
                        overlap._ring_gemm(a.pieces[r][c * sp:(c + 1) * sp], b.pieces[r],
                                           slots[r][0] if c == 0 else mine[r], count)
            ring.exit()

        def accumulates():
            ring.enter()
            for r in range(nr):
                with ring.on(r, overlap.COMPUTE):
                    for s in range(1, nr):
                        overlap._ring_accumulate(mine[r], slots[r][s])
            ring.exit()

        def chunk(r, step):
            return slots[r][step], None

    def copies():
        ring.enter()
        arrived = [None] * nr
        for step in range(nr - 1):
            landed = [None] * nr
            for r in range(nr):
                right = (r + 1) % nr
                src, c = chunk(r, step)
                dst = slots[right][c] if kind == "ag" else slots[right][step + 1]
                with ring.on(r, overlap.COMM):
                    ring.wait(r, overlap.COMM, arrived[r])
                    overlap._send(dst, src)
                    landed[right] = ring.record(r, overlap.COMM)
            arrived = landed
        ring.exit()

    parts = {"gemms": gemms, "copies": copies}
    if kind == "rs":
        parts["accumulates"] = accumulates
    return parts


def phase_mp_times(run: dict, card: str) -> dict:
    """38. CUDA events around back-to-back calls (``_loop_ms``) at MP_MAIN,
    4 ranks on the card, for each ring: the ring route; its P² GEMM launches
    alone on the same streams (and B12b's accumulates alone); its copies
    alone; the collective route (matmul_ag with use_pallas True, on B1, and
    False, on torch.matmul; matmul_rs, whose product is torch.matmul either
    way, as in the reference); the plain version (the ring with torch ops);
    and one torch.matmul of the whole product. Prints the overlap share,
    (kernels + copies − ring) / copies, with its spread (the half-ranges of
    the samples of ring, kernels and copies, over copies), and each route's
    share of the bound. The share is resolved only where it lies in [0, 1]
    and its spread is under 1: else it is printed as unresolved and stored
    as None. One card shows HBM copies, not NVLink (450 GB/s each way)."""
    grid = run["grid"]
    nr = grid.size
    s, hd, f = MP_MAIN
    flop = 2.0 * s * hd * f
    ms, bounds, spread = {}, {}, {}
    for kind, (a, b) in run["operands"].items():
        fn = MP_RING[kind]
        a_full, b_full = a.full(), b.full()
        routes = {f"{kind} ring": lambda fn=fn, a=a, b=b: fn(a, b, grid),
                  f"{kind} library": lambda a=a_full, b=b_full: torch.matmul(a, b)}
        for part, call in _ring_parts(kind, grid, a, b).items():
            routes[f"{kind} {part}"] = call
        if kind == "ag":
            routes["ag collective B1"] = lambda: mp.matmul_ag(a, b, grid, use_pallas=True)
            routes["ag collective torch"] = lambda: mp.matmul_ag(a, b, grid)
        else:
            routes["rs collective torch"] = lambda: mp.matmul_rs(a, b, grid)
        ms.update(_loop_ms(routes, warmup=1, reps=3, samples=3, spread=spread))

        def plain(fn=fn, a=a, b=b):
            with _ring_plain():
                return fn(a, b, grid)
        ms[f"{kind} plain"] = _loop_ms({"p": plain}, warmup=1, reps=3, samples=3)["p"]
        del a_full, b_full
        # P(P − 1) chunks of (s / P, n_embd) f32 a call, each read and written once
        copy_bytes = 2 * nr * (nr - 1) * 4.0 * (s // nr) * hd
        in_out = 4.0 * (s * hd + hd * f + s * f)
        bounds[kind] = _bound(flop, PEAK_F32, in_out)
        bounds[f"{kind} copies"] = _bound(0.0, PEAK_F32, copy_bytes)
        if kind == "rs":   # P(P − 1) accumulates: partial and slot read, slot or D written
            bounds["rs accumulates"] = _bound(0.0, PEAK_F32, nr * (nr - 1) * 3 * 4.0 * (s // nr) * hd)
        kernels = ms[f"{kind} gemms"] + ms.get(f"{kind} accumulates", 0.0)
        copies = ms[f"{kind} copies"]
        share = (kernels + copies - ms[f"{kind} ring"]) / copies
        parts = [f"{kind} {p}" for p in ("ring", "gemms", "accumulates", "copies")]
        share_spread = sum((spread[p][1] - spread[p][0]) / 2 for p in parts if p in spread) / copies
        resolved = 0.0 <= share <= 1.0 and share_spread < 1.0
        ms[f"{kind} overlap share"] = share if resolved else None
        for route, t in ms.items():
            if not route.startswith(kind + " ") or route.endswith("share"):
                continue
            bound = bounds.get(route, bounds[kind])
            print(f"[mp-times] {route:22s} {t:.4f} ms | {flop / t / 1e9:.2f} TFLOP/s of the "
                  f"function | bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
                  f"{bound['bound_ms'] / t:.1%} of it | {card}", flush=True)
        print(f"[mp-times] {kind} overlap share (kernels {kernels:.4f} + copies "
              f"{copies:.4f} - ring {ms[f'{kind} ring']:.4f}) / copies = {share:.3f} "
              f"± {share_spread:.3f}{'' if resolved else ', unresolved'} | {nr} ranks on one "
              f"card: the copies are HBM to HBM, not NVLink | {card}", flush=True)
    ms["bounds"] = bounds
    return ms


def main() -> None:
    dev, card = phase_device()
    phase_build()
    phase_kernel(dev)
    main_run = phase_main_path(dev)
    ms = phase_times(main_run, card)
    block_ms = phase_blocks(dev, card)
    solver = phase_solver_main(dev)
    solver_ms = phase_solver_times(solver, card)
    phase_qr_blocks(dev)
    qrd = phase_qr_main(dev)
    qr_ms = phase_qr_times(qrd, card)
    phase_fft_kernel(dev)
    fftd = phase_fft_main(dev)
    fft_ms = phase_fft_times(fftd, card)
    phase_tf32(dev)
    phase_sparse_kernel(dev)
    spd = phase_sparse_main(dev)
    sp_ms = phase_sparse_times(spd, card)
    phase_dx_kernel(dev)
    dxd = phase_dx_main(dev)
    dx_ms = phase_dx_times(dxd, card)
    phase_dxe_kernel(dev)
    dxe = phase_dxe_main(dev)
    dxe_ms = phase_dxe_times(dxe, card)
    phase_dxc_kernel(dev)
    dxc_run = phase_dxc_main(dev)
    dxc_ms = phase_dxc_times(dxc_run, card)
    phase_rng_kernel(dev)
    rng_run = phase_rng_main(dev)
    rng_ms = phase_rng_times(rng_run, card)
    phase_vv10_kernel(dev)
    vv10_run = phase_vv10_main(dev)
    vv10_ms = phase_vv10_times(vv10_run, card)
    phase_four_step_kernel(dev)
    fs_run = phase_four_step_main(dev)
    fs_ms = phase_four_step_times(fs_run, card)
    phase_mp_kernel(dev)
    mp_run = phase_mp_main(dev)
    mp_ms = phase_mp_times(mp_run, card)

    m, n, k = MAIN
    ns = SOLVER_N
    solver_bytes = 2 * 4 * ns * ns   # the matrix in and its factor out, f32
    b, nf = FFT_MAIN
    record = {"kernels": [{
        "name": "gemm_epilogue",
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/gemm_epilogue.cu",
        "replaces": "tpumathlib/dx/gemm.py:193",
        "launches": main_run["launches"],
        "max_abs_err": main_run["max_abs_err"],
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        **_bound(2.0 * m * n * k, PEAK_BF16, 2 * (m * k + k * n + m * n) + 4 * n),
        "library_ms": None,   # bias + GELU after the product is no single torch call
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/dense_block.cu",
        "replaces": replaces,
        "launches": solver["launches"][block],
        "max_abs_err": solver["max_abs_err"][kind],
        "ms": solver_ms[f"{kind} kernel"],
        "plain_ms": solver_ms[f"{kind} plain"],
        **_bound(flop, PEAK_F32, solver_bytes),
        "library_ms": solver_ms[f"{kind} vendor"],
        "gemm_launches": solver["per_call"][kind]["pallas_matmul"],
        "device_ms": solver_ms[f"{kind} kernel device"],
        "host_enqueue_ms": solver_ms[f"{kind} kernel host"],
        "idle_share": solver_ms[f"{kind} kernel idle"],
        **({"left_looking_ms": solver_ms["potrf left-looking"],
            "left_looking_device_ms": solver_ms["potrf left-looking device"]}
           if kind == "potrf" else {}),
        "block_ms": block_ms[block_name]["ms"],
        "block_plain_ms": block_ms[block_name]["plain_ms"],
        "block_ptxas": block_ms[block_name]["ptxas"],
    } for name, kind, block, block_name, replaces, flop in (
        ("potrf_onelaunch (chol_inv_block + gemm_epilogue)", "potrf", "_chol_inv128",
         "chol_inv_block", "tpumathlib/solver/onelaunch.py:231", ns**3 / 3),
        ("getrf_onelaunch (lu_inv_block + gemm_epilogue)", "getrf", "_lu_inv128",
         "lu_inv_block", "tpumathlib/solver/onelaunch.py:481", 2 * ns**3 / 3))] + [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": qrd["launches"][count],
        "max_abs_err": qrd["max_abs_err"][kind],
        "ms": qr_ms[f"{kind} kernel"],
        "plain_ms": qr_ms[f"{kind} plain"],
        **_bound(4 * ns**3 / 3, PEAK_F32, nbytes),
        "library_ms": library,
    } for name, kind, count, source, replaces, nbytes, library in (
        ("geqrf_onelaunch (chol_inv_block + hh_recon_block + inv_upper_block + gemm_epilogue)",
         "geqrf", "_hh_recon128", "tpumathlib_torch/csrc/qr_block.cu",
         "tpumathlib/solver/qr_onelaunch.py:318", solver_bytes + 4 * ns * 256,
         qr_ms["geqrf vendor"]),
        # torch's Householder product takes LAPACK's (a, tau), not (vr, t): no like call
        ("orgqr_onelaunch (gemm_epilogue)", "orgqr", "orgqr_onelaunch",
         "tpumathlib_torch/csrc/gemm_epilogue.cu", "tpumathlib/solver/qr_onelaunch.py:439",
         solver_bytes + 4 * ns * 256, None))] + [{
        "name": "dif_fft",
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/fft_dif.cu",
        "replaces": "tpumathlib/fft/stockham.py:382",
        "launches": fftd["launches"],
        "max_abs_err": fftd["max_abs_err"],
        "ms": fft_ms["c2c natural kernel"],
        "plain_ms": fft_ms["c2c natural plain"],
        **_bound(5.0 * b * nf * math.log2(nf), PEAK_F32, 4 * 4 * b * nf),
        "library_ms": fft_ms["c2c natural library"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/bell_sparse.cu",
        "replaces": replaces,
        "launches": spd["launches"][count],
        "max_abs_err": spd["max_abs_err"][count],
        "ms": sp_ms[f"{line} kernel"],
        "plain_ms": sp_ms[f"{line} plain"],
        **sp_ms["bounds"][line],
        "library_ms": sp_ms[f"{line} library"],
    } for name, count, line, replaces in (
        ("bell_spmm", "bell_spmm_pallas", "spmm", "tpumathlib/sparse/pallas_kernels.py:123"),
        ("bell_spmv", "_bell_spmv", "spmv", "tpumathlib/sparse/pallas_kernels.py:404 and :450"))] + [{
        "name": name,
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/dx_solver.cu",
        "replaces": f"tpumathlib/dx/solver.py:{site}",
        "launches": dxd["grew"][line][count],
        "max_abs_err": dxd["max_abs_err"][line],
        "ms": dx_ms[f"{line} kernel"],
        "plain_ms": dx_ms[f"{line} plain"],
        **dx_ms["bounds"][line],
        "library_ms": dx_ms[f"{line} library"],
    } for name, line, count, site in (
        ("potrf_batched_packed (tml_potrf_batched)", "potrf_batched b8192 n32", "_potrf", "977"),
        ("getrf_batched_packed (tml_getrf_batched)", "getrf_batched b8192 n32", "_getrf", "480"),
        ("getrf_batched_packed pivot=False (tml_getrf_batched)", "getrf_batched nopivot b8192 n32",
         "_getrf", "480"),
        ("geqrf_batched (tml_geqrf_batched)", "geqrf_batched b8192 n32", "_geqrf", "222"),
        ("gesv_batched (tml_getrf_batched with a right-hand side)", "gesv_batched b8192 n32 k4",
         "_getrf", "301"),
        ("posv_batched (tml_potrf_batched with a right-hand side)", "posv_batched b8192 n32 k4",
         "_potrf", "359"),
        ("potrf_batched n=128 (tml_potrf_batched)", "potrf_batched b1024 n128", "_potrf", "222"),
        ("getrf_batched n=128 (tml_getrf_batched)", "getrf_batched b1024 n128", "_getrf", "222"))] + [{
        "name": name,
        "route": "cuda",
        "source": f"tpumathlib_torch/csrc/{source}",
        "replaces": f"tpumathlib/dx/solver.py:{site}",
        "launches": dxe["launches"][count],
        "max_abs_err": dxe["max_abs_err"][line],
        "ms": dxe_ms[f"{line} kernel"],
        "plain_ms": dxe_ms[f"{line} plain"],
        **dxe_ms["bounds"][line],
        "library_ms": dxe_ms[f"{line} library"],
    } for name, line, count, source, site in (
        ("unmqr_batched (tml_unmqr_batched)", "unmqr_batched trans b8192 n32 k4", "_unmqr",
         "dx_solver.cu", "597"),
        ("gels_batched (tml_gels_batched)", "gels_batched b8192 m64 n32 k4", "_gels",
         "dx_solver.cu", "637"),
        ("syevd_batched (tml_syevd_batched)", "syevd_batched b8192 n32", "_syevd",
         "dx_jacobi.cu", "758"),
        ("gesvd_batched (tml_gesvd_batched)", "gesvd_batched b8192 n32", "_gesvd",
         "dx_jacobi.cu", "843"))] + [{
        "name": name,
        "route": "cuda",
        "source": f"tpumathlib_torch/csrc/{source}",
        "replaces": replaces,
        "launches": dxc_run["launches"][count],
        "max_abs_err": dxc_run["max_abs_err"][line],
        "ms": dxc_ms[f"{line} kernel"],
        "plain_ms": dxc_ms[f"{line} plain"],
        **dxc_ms["bounds"][line],
        "library_ms": None,
        "library_ms_null_because": why,
        "composed_ms": {route[len(line) + 10:]: t for route, t in dxc_ms.items()
                        if route.startswith(f"{line} composed")},
    } for name, line, count, source, replaces, why in (
        ("cascaded_decode (tml_cascaded_decode)", "decode", "_decode", "dx_comp.cu",
         "tpumathlib/dx/comp.py:186", "no torch call decodes the cascaded format (nvCOMP is not "
         "installed)"),
        ("cascaded_encode (tml_cascaded_encode)", "encode", "_encode", "dx_comp.cu",
         "tpumathlib/dx/comp.py:233", "no torch call encodes the cascaded format (nvCOMP is not "
         "installed)"),
        ("cascaded_decode_dot (tml_cascaded_decode_dot)", "decode_dot", "_decode_dot",
         "dx_comp.cu", "tpumathlib/dx/comp.py:302", "no torch call fuses a decode with a "
         "product; composed_ms times the decode kernel then torch.matmul"),
        ("gemm_fft (tml_gemm_fft)", "gemm_fft", "_gemm_fft", "dx_fused.cu",
         "tpumathlib/dx/fused.py:70", "no torch call fuses a GEMM with an FFT; composed_ms times "
         "torch.fft.fft(gelu(A @ B)) and gemm_fft_composed"))] + [{
        "name": name,
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/dx_rng.cu",
        "replaces": replaces,
        "launches": rng_run["launches"][count],
        "max_abs_err": rng_run["max_abs_err"][line],
        "ms": rng_ms[f"{line} kernel"],
        "plain_ms": rng_ms[f"{line} plain"],
        **rng_ms["bounds"][line],
        **extra,
    } for name, line, count, replaces, extra in (
        ("random_uniform (tml_random_uniform)", "uniform", "_random_uniform",
         "tpumathlib/dx/rng.py:44", {
             "library_ms": rng_ms["uniform library"],
             "library_is": "torch.rand with a CUDA generator (torch's Philox: the same "
                           "distribution, other bits)"}),
        ("dropout_matmul (tml_dropout_matmul)", "dropout", "_dropout_matmul",
         "tpumathlib/dx/rng.py:70", {
             "library_ms": None,
             "library_ms_null_because": "no torch call fuses dropout into a product; "
                                        "composed_ms times F.dropout(torch.matmul(a, b), 0.1) "
                                        "with TF32 off",
             "composed_ms": rng_ms["dropout composed"]}))] + [{
        "name": name,
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/dx_vv10.cu",
        "replaces": replaces,
        "launches": vv10_run["launches"][count],
        "max_abs_err": vv10_run["max_abs_err"][line],
        "ms": vv10_ms[f"{line} kernel"],
        "plain_ms": vv10_ms[f"{line} plain"],
        **vv10_ms["bounds"][line],
        "library_ms": None,
        "library_ms_null_because": "no torch call computes the VV10 pair sums; plain_ms is the "
                                   "yardstick",
    } for name, line, count, replaces in (
        ("vv10_fwd (tml_vv10_fwd)", "fwd", "_vv10_fwd", "tpumathlib/dx/vv10.py:121 (_fwd_kernel :53)"),
        ("vv10_bwd (tml_vv10_bwd)", "bwd", "_vv10_bwd",
         "tpumathlib/dx/vv10.py:121 (_bwd_kernel :72)"))] + [{
        "name": name,
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/fft_four_step.cu",
        "replaces": replaces,
        "launches": fs_run["launches"][count],
        "max_abs_err": fs_run["max_abs_err"][kind],
        "ms": fs_ms[f"{kind} b{b} N{nf} forward kernel"],
        "plain_ms": fs_ms[f"{kind} b{b} N{nf} forward plain"],
        **fs_ms["bounds"][kind],
        "library_ms": fs_ms[f"fft b{b} N{nf} forward library"],
        **({"own_bound_ms": fs_ms["split own bounds"][f"b{b} N{nf}"]["bound_ms"]}
           if kind == "split" else {}),
        "ms_1024x16384": fs_ms[f"{kind} b1024 N16384 forward kernel"],
        "library_ms_1024x16384": fs_ms["fft b1024 N16384 forward library"],
        "ptxas": fs_ms["resources"]["kernels"],
    } for name, kind, count, replaces in (
        ("four_step_fft fused (tml_four_step_fft mode 1)", "fused", "pallas_fft",
         "tpumathlib/fft/kernels.py:217"),
        ("four_step_fft split (tml_four_step_fft mode 2)", "split", "pallas_fft2",
         "tpumathlib/fft/pallas_split.py:95"))] + [{
        "name": "potrf_blocked (chol_inv_block + gemm_epilogue)",
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/dense_block.cu",
        "replaces": "tpumathlib/solver/blocked.py:172",
        "launches": fs_run["launches"]["_chol_inv128"],
        "gemm_launches": fs_run["launches"]["pallas_matmul"],
        "max_abs_err": fs_run["max_abs_err"]["blocked"],
        "ms": fs_ms["blocked kernel"],
        "plain_ms": fs_ms["blocked plain"],
        **fs_ms["bounds"]["blocked"],
        "library_ms": fs_ms["blocked library"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/mp_overlap.cu",
        "replaces": replaces,
        "launches": mp_run["launches"][count],
        **({"accumulate_launches": mp_run["launches"]["accumulates"]} if kind == "rs" else {}),
        "max_abs_err": mp_run["max_abs_err"][kind],
        "ms": mp_ms[f"{kind} ring"],
        "plain_ms": mp_ms[f"{kind} plain"],
        **mp_ms["bounds"][kind],
        "library_ms": mp_ms[f"{kind} library"],
        "library_is": "one torch.matmul of the whole f32 product on the card",
        "overlap_share": mp_ms[f"{kind} overlap share"],   # None where unresolved
        "ranks": f"{MP_RANKS} on one card",
    } for name, kind, count, replaces in (
        ("ring_ag_gemm (tml_ring_gemm)", "ag", "matmul_ag_overlapped",
         "tpumathlib/mp/overlap.py:112"),
        ("ring_rs_gemm (tml_ring_gemm + tml_ring_accumulate)", "rs", "matmul_rs_overlapped",
         "tpumathlib/mp/overlap.py:190"))]}
    print(card_line(), flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
