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
The line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time

import numpy as np
import torch

from tpumathlib_torch.blas import level3, lt
from tpumathlib_torch.core.check import max_abs_rel, max_scaled_err
from tpumathlib_torch.core.interop import to_numpy
from tpumathlib_torch.core.timer import benchmark
from tpumathlib_torch.dx import cuda_utils, gemm
from tpumathlib_torch.dx.gemm import _pallas_matmul_plain, pallas_matmul
from tpumathlib_torch.entry import entry

F32, BF16, F16, I8 = torch.float32, torch.bfloat16, torch.float16, torch.int8
MAIN = (4096, 4096, 4096)  # (M, N, K) of the bench headline


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
    times: dict[str, list[float]] = {name: [] for name in runs}
    for name in list(runs) + list(reversed(runs)):
        times[name] += benchmark(runs[name], warmup=3, iters=20)["times"]
    ms = {name: float(np.median(t)) * 1e3 for name, t in times.items()}
    flop = 2.0 * m * n * k
    for name, t in ms.items():
        print(f"[times] {name:7s} {m}x{n}x{k} bf16 gelu+bias: {t:.4f} ms = "
              f"{flop / t / 1e9:.2f} TFLOP/s | {card}", flush=True)
    # each user route end to end: host clock over 10 back-to-back calls
    for name, route in main["routes"].items():
        route()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            route()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 10 * 1e3
        print(f"[times] wall {name:30s} {wall:.4f} ms per call (host clock, 10 calls) | {card}",
              flush=True)
    return ms


def main() -> None:
    dev, card = phase_device()
    phase_build()
    phase_kernel(dev)
    main_run = phase_main_path(dev)
    ms = phase_times(main_run, card)
    record = {"kernels": [{
        "name": "gemm_epilogue",
        "route": "cuda",
        "source": "tpumathlib_torch/csrc/gemm_epilogue.cu",
        "replaces": "tpumathlib/dx/gemm.py:193",
        "launches": main_run["launches"],
        "max_abs_err": main_run["max_abs_err"],
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
    }]}
    print(card_line(), flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
