#!/usr/bin/env python3
"""Times variants of the Jacobi block route (csrc/dx_jacobi_block.cu, B7g
syevd and B7h gesvd for 33 <= n <= 64) against the source as it stands, on
one CUDA card, at chip_smoke.py's main-path shape (DXE_WIDE: 2048 x 64).

Each variant is the source with a few text edits (VARIANTS below), built
with nvcc beside the kernel library into build/jacobi_variants/<name>/ with
a C entry of its own, all builds started together. Then, in two turns, each
build's syevd (10 sweeps) and gesvd (12 sweeps) by raw launches: CUDA
events around 10 back-to-back launches after 2, the share of
chip_smoke.py's bound, and the largest difference of its sorted values from
the source's over their largest. It prints the card's name and power limit,
each source's compile time (the library's compile_seconds.json) and each
build's registers and spills at n = 64 (ptxas).

    python3 jacobi_variants.py [variant ...]   # all variants when none is named
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from tpumathlib_torch.dx import cuda_utils, solver as dxs

ROOT = Path(__file__).resolve().parent
SRC = cuda_utils.CSRC / "dx_jacobi_block.cu"
OUT = ROOT / "build" / "jacobi_variants"
SYEVD_LOOP = ("#pragma unroll 2\n  for (int64_t round = 0; round < int64_t(m.sweeps) * C::kM; "
              "++round) {\n    const float4* cs")
GESVD_LOOP = ("#pragma unroll 2\n  for (int64_t round = 0; round < int64_t(m.sweeps) * C::kM; "
              "++round) {\n    float al")
VARIANTS = {
    # the spare pair found at run time in every round, odd n or not (a
    # branch a pair in the column turns), and the row turn behind its test
    # for even n too
    "skip": [("turn_columns<NPAD, ODD>(a, v, cs, C::dead(ODD, r));",
              "turn_columns<NPAD, true>(a, v, cs, C::dead(n < NPAD, r));"),
             ("turn_columns<NPAD, ODD>(a, v, sm.cs[warp][buf], C::dead(ODD, r));",
              "turn_columns<NPAD, true>(a, v, sm.cs[warp][buf], C::dead(n < NPAD, r));"),
             ("if (!ODD || (i < n && partner < n))", "if (i < n && partner < n)")],
    # gesvd's warp sums by the warp route's pair_sums (no fused first step)
    "pair_sums": [("warp_sums<NPAD>(a, lane, al, be, ga);",
                   "pair_sums<NPAD, kWarpN>(a, lane, al, be, ga);"),
                  ('#include "dx_jacobi.cuh"\n',
                   '#include "dx_jacobi.cuh"\n#include "pair_sums.cuh"\n')],
    "syevd_unroll1": [(SYEVD_LOOP, SYEVD_LOOP.replace("unroll 2", "unroll 1"))],
    "gesvd_unroll1": [(GESVD_LOOP, GESVD_LOOP.replace("unroll 2", "unroll 1"))],
    # 5 blocks an SM: 10 warps, 3 on some of an SM's four schedulers, so at
    # most 168 registers a thread
    "blocks5": [("constexpr int kBlocksPerSm = 4;", "constexpr int kBlocksPerSm = 5;")],
}
ENTRY = r'''
#include "dx_jacobi.cuh"
extern "C" int variant_launch(int svd, const void* a, void* u, void* d, void* v, long long batch,
                              int n, int sweeps, void* stream) {
  return tml_jacobi::launch_block_route(svd, (const float*)a, (float*)u, (float*)d, (float*)v,
                                        batch, n, sweeps, (cudaStream_t)stream);
}
'''


def edited(name: str) -> str:
    s = SRC.read_text()
    for old, new in VARIANTS[name]:
        if old not in s:
            raise SystemExit(f"jacobi_variants: {name}: the source no longer holds {old!r}")
        s = s.replace(old, new)
    return s


def pair_sums_header() -> str:
    """The warp route's products and pair_sums, cut from csrc/dx_jacobi.cu."""
    s = (cuda_utils.CSRC / "dx_jacobi.cu").read_text()
    start = s.index("// Pair k's products in this lane's row")
    end = s.index("// One-sided Jacobi, a warp a matrix.")
    return "#pragma once\nnamespace tml_jacobi {\nnamespace {\n" + s[start:end] + "}\n}\n"


def start_build(name: str):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "dx_jacobi_block.cu").write_text(edited(name))
    (d / "dx_jacobi.cuh").write_text((cuda_utils.CSRC / "dx_jacobi.cuh").read_text())
    (d / "pair_sums.cuh").write_text(pair_sums_header())
    (d / "entry.cu").write_text(ENTRY)
    cmd = [cuda_utils._nvcc(), *cuda_utils.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
           str(d / "dx_jacobi_block.cu"), str(d / "entry.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d


def ptxas_at_64(log: str) -> list[str]:
    """Registers and spills of the n = 64 kernels (NPAD 64, not odd)."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if "'" in line else None
        elif cur and "ILi64ELb0E" in cur and ("registers" in line or "spill" in line):
            out.append(f"{cur[cur.find('_block_kernel') - 5:][:18]}: {line.strip()}")
    return out


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    dev, card = cs.phase_device()
    t0 = time.perf_counter()
    builds = {name: start_build(name) for name in names}
    lib = cuda_utils.load_kernels()
    built = cuda_utils.build_kernels()
    each = built.parent / "compile_seconds.json"
    if each.exists():
        print(f"[variants] compile seconds: {each.read_text()}", flush=True)
    for line in ptxas_at_64((built.parent / "nvcc.log").read_text()):
        print(f"[variants] source: {line}", flush=True)
    launch = {"source": None}
    for name, (proc, d) in builds.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"jacobi_variants: {name} did not build:\n{out[-4000:]}")
        for line in ptxas_at_64(out):
            print(f"[variants] {name}: {line}", flush=True)
        v = ctypes.CDLL(str(d / "lib.so"))
        v.variant_launch.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 4, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        v.variant_launch.restype = ctypes.c_int
        launch[name] = v.variant_launch
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(24)
    b, n = cs.DXE_WIDE
    g = torch.randn((b, n, n), generator=gen, device=dev)
    sym = (g + g.mT) / 2
    pairs = dxs._pair_table(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    u, v, d = torch.empty_like(g), torch.empty_like(g), torch.empty((b, n), device=dev)

    def call(name, svd):
        x, sweeps = (g, 12) if svd else (sym, 10)
        if name != "source":
            return launch[name](int(svd), x.data_ptr(), u.data_ptr(), d.data_ptr(), v.data_ptr(),
                                b, n, sweeps, stream)
        if svd:
            return lib.tml_gesvd_batched(x.data_ptr(), pairs.data_ptr(), u.data_ptr(),
                                         d.data_ptr(), v.data_ptr(), b, n, sweeps, stream)
        return lib.tml_syevd_batched(x.data_ptr(), pairs.data_ptr(), d.data_ptr(), v.data_ptr(), b,
                                     n, sweeps, stream)

    want = {}
    for turn in range(2):
        for name in launch:
            for svd in (False, True):
                kind = "gesvd" if svd else "syevd"
                if call(name, svd) != 0:
                    raise SystemExit(f"jacobi_variants: {name} {kind} did not launch")
                torch.cuda.synchronize()
                got = torch.sort(d, dim=1)[0]
                want.setdefault(svd, got.clone())
                err = float((got - want[svd]).abs().max() / want[svd].abs().max())
                for _ in range(2):
                    call(name, svd)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call(name, svd)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / 10
                bound = cs._dxe_bound(f"{kind}_batched b{b} n{n}")["bound_ms"]
                print(f"[variants] turn {turn} {name:14s} {kind} {b} x {n}: {ms:.4f} ms, "
                      f"{bound / ms:.1%} of {bound:.4f}; sorted values vs the source's {err:.2e} "
                      f"| {card}", flush=True)


if __name__ == "__main__":
    main()
