#!/usr/bin/env python3
"""Times variants of the batched QR's warp routes (csrc/dx_qr_warp.cu: B7a's
geqrf for n <= 32 and B7e's unmqr for m <= 64, n <= 32) against the source as
it stands, on one CUDA card, at chip_smoke.py's main-path shapes: geqrf at
8192 x 32, unmqr both ways on its factors with C (8192, 32, 4), and Q^T B on
gels's reflectors (8192 x 64 x 32, k = 4).

Each variant is the source with a few text edits (VARIANTS below); the
source and every variant are built with nvcc into build/qr_warp_variants/
<name>/ with a C entry of their own, all builds started together. Then, in
two turns, each build's kernels by raw launches: CUDA events around 20
back-to-back launches after 3, the share of chip_smoke.py's bound, and the
largest difference of its output from the source build's over the largest
entry. It prints the card's name and power limit and each build's registers,
spills (ptxas) and SASS instructions a kernel (cuobjdump).

    python3 qr_warp_variants.py [variant ...]   # all variants when none is named
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from tpumathlib_torch.dx import cuda_utils, solver as dxs

ROOT = Path(__file__).resolve().parent
SRC = cuda_utils.CSRC / "dx_qr_warp.cu"
OUT = ROOT / "build" / "qr_warp_variants"
VARIANTS = {
    "source": [],
    # four 5-step butterflies in place of the transposing reduction: 20
    # shuffles a reflector where warp_sums4 takes 9, the same sums
    "butterfly": [("      warp_sums4(s, lane);\n",
                   "#pragma unroll\n      for (int cc = 0; cc < KG; ++cc)\n#pragma unroll\n"
                   "        for (int off = 16; off > 0; off >>= 1)\n"
                   "          s[cc] += __shfl_xor_sync(kFull, s[cc], off);\n")],
    # more warps an SM: unmqr at 8 blocks (a cap of 64 registers), geqrf at 6 (80)
    "unmqr_blocks8": [("__launch_bounds__(kWarpMatrices * 32, 4)\n    unmqr_warp_kernel",
                       "__launch_bounds__(kWarpMatrices * 32, 8)\n    unmqr_warp_kernel")],
    "geqrf_blocks6": [("__launch_bounds__(kWarpMatrices * 32, 4)\n    geqrf_warp_kernel",
                       "__launch_bounds__(kWarpMatrices * 32, 6)\n    geqrf_warp_kernel")],
    # geqrf's steps in a loop that is not unrolled (ROLLED below): one step's
    # code, some 300 instructions, where the unrolled steps are some 10k a
    # copy and two copies (n = 32 and n < 32); each step then runs over all
    # 32 rows, v zero above row j
    "geqrf_rolled": [("__global__ void __launch_bounds__(kWarpMatrices * 32, 4)\n    geqrf_warp_kernel",
                      "ROLLED\n__global__ void __launch_bounds__(kWarpMatrices * 32, 4)\n"
                      "    geqrf_warp_kernel"),
                     ("    gels_qr_steps<1, true>(col, slices[wi], tau_of[wi], vdiv, lane, n, n);",
                      "    rolled_qr_steps<true>(col, slices[wi], tau_of[wi], vdiv, lane, n, n);"),
                     ("    gels_qr_steps<1, false>(col, slices[wi], tau_of[wi], vdiv, lane, n, n);",
                      "    rolled_qr_steps<false>(col, slices[wi], tau_of[wi], vdiv, lane, n, n);")],
}
ROLLED = r'''
template <bool FULL>
__device__ __forceinline__ void rolled_qr_steps(float (&a)[32], float* v, float* taus, float& vdiv,
                                                int lane, int m, int n) {
  auto real = [m](int r) { return FULL || r < m; };
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    if (lane == j) {
      float sq[4] = {0.f, 0.f, 0.f, 0.f}, xj = 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if (r == j) xj = a[r];
        if (r > j && real(r)) sq[r & 3] = fmaf(a[r], a[r], sq[r & 3]);
      }
      float tau_h, tau;
      bool degenerate;
      const float vj = dlarfg(xj, sum4(sq), tau_h, tau, degenerate);
      vdiv = vj == 0.f ? 1.f : vj;
      taus[j] = tau;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float e4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * q + e;
          e4[e] = degenerate || r < j ? 0.f : r == j ? vj : a[r];
        }
        reinterpret_cast<float4*>(v)[q] = make_float4(e4[0], e4[1], e4[2], e4[3]);
        reinterpret_cast<float4*>(v + 32)[q] = make_float4(e4[0], e4[1], e4[2], e4[3]);
      }
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (degenerate && r > j) a[r] = 0.f;
      reinterpret_cast<float4*>(v + 64)[0] = make_float4(tau_h, 0.f, 0.f, degenerate ? 1.f : 0.f);
    }
    __syncwarp();
    const float4 sc = reinterpret_cast<const float4*>(v + 64)[0];
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 vq = reinterpret_cast<const float4*>(v)[q];
      const float ve[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e >= j && real(4 * q + e)) part[e] = fmaf(ve[e], a[4 * q + e], part[e]);
    }
    const float wc = sc.w != 0.f ? 0.f : sum4(part) * sc.x;
    const bool update = lane > j && lane < n;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 vq = reinterpret_cast<const float4*>(v + 32)[q];
      const float ve[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * q + e;
        if (r >= j && real(r) && (update || (lane == j && r == j))) a[r] = fmaf(-ve[e], wc, a[r]);
      }
    }
    __syncwarp();
  }
}
'''
ENTRY = r'''
#include "dx_qr_warp.cuh"
extern "C" int variant_geqrf(const void* a, void* qr, void* tau, long long batch, int n, void* s) {
  return tml_qr::launch_geqrf_warp((const float*)a, (float*)qr, (float*)tau, batch, n,
                                   (cudaStream_t)s);
}
extern "C" int variant_unmqr(const void* qr, const void* tau, const void* c, void* x,
                             long long batch, int m, int n, int k, int trans, void* s) {
  return tml_qr::launch_unmqr_warp((const float*)qr, (const float*)tau, (const float*)c,
                                   (float*)x, batch, m, n, k, trans != 0, (cudaStream_t)s);
}
'''


def edited(name: str) -> str:
    s = SRC.read_text()
    for old, new in VARIANTS[name]:
        new = new.replace("ROLLED", ROLLED)
        if old not in s:
            raise SystemExit(f"qr_warp_variants: {name}: the source no longer holds {old!r}")
        s = s.replace(old, new)
    return s


def start_build(name: str):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "dx_qr_warp.cu").write_text(edited(name))
    (d / "dx_qr_warp.cuh").write_text((cuda_utils.CSRC / "dx_qr_warp.cuh").read_text())
    (d / "entry.cu").write_text(ENTRY)
    cmd = [cuda_utils._nvcc(), *cuda_utils.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
           str(d / "dx_qr_warp.cu"), str(d / "entry.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d


def ptxas(log: str) -> list[str]:
    """Registers and spills of each warp kernel of a build."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((k for k in ("geqrf_warp", "unmqr_warp_kernelILi1", "unmqr_warp_kernelILi2")
                        if k in line), None)
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.strip()}")
    return out


def sass_sizes(lib: Path) -> dict:
    """Instructions in each warp kernel's SASS (cuobjdump -sass), all paths:
    its code's size, 16 bytes an instruction."""
    sass = subprocess.run([str(Path(cuda_utils._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    sizes, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = next((k for k in ("geqrf_warp", "unmqr_warp_kernelILi1", "unmqr_warp_kernelILi2")
                        if k in line), None)
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            sizes[cur] = sizes.get(cur, 0) + 1
    return sizes


def main() -> None:
    names = ["source"] + [v for v in (sys.argv[1:] or list(VARIANTS)) if v != "source"]
    dev, card = cs.phase_device()
    t0 = time.perf_counter()
    builds = {name: start_build(name) for name in names}
    libs = {}
    for name, (proc, d) in builds.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"qr_warp_variants: {name} did not build:\n{out[-4000:]}")
        for line in ptxas(out):
            print(f"[variants] {name}: {line}", flush=True)
        print(f"[variants] {name}: SASS instructions {sass_sizes(d / 'lib.so')}", flush=True)
        v = ctypes.CDLL(str(d / "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        v.variant_geqrf.argtypes = [p, p, p, ctypes.c_longlong, i, p]
        v.variant_unmqr.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, p]
        libs[name] = v
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(26)
    b, n = cs.DXE_SQ
    bg, mg, ng, kg = cs.DXE_GELS
    a = torch.randn((b, n, n), generator=gen, device=dev)
    c = torch.randn((b, n, cs.DX_K), generator=gen, device=dev)
    qr, taus = dxs._geqrf_plain(a)
    qr64, taus64 = dxs._geqrf_plain(torch.randn((bg, mg, ng), generator=gen, device=dev))
    c64 = torch.randn((bg, mg, kg), generator=gen, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = {name: {} for name in names}

    def runs(name: str) -> dict:
        v, o = libs[name], outs[name]
        o.setdefault("geqrf", (torch.empty_like(a), torch.empty((b, n), device=dev)))
        for key, shape in (("unmqr trans", c), ("unmqr", c), ("unmqr m64", c64)):
            o.setdefault(key, torch.empty_like(shape))
        return {
            "geqrf_batched b8192 n32": lambda: v.variant_geqrf(
                a.data_ptr(), o["geqrf"][0].data_ptr(), o["geqrf"][1].data_ptr(), b, n, stream),
            "unmqr_batched trans b8192 n32 k4": lambda: v.variant_unmqr(
                qr.data_ptr(), taus.data_ptr(), c.data_ptr(), o["unmqr trans"].data_ptr(), b, n,
                n, cs.DX_K, 1, stream),
            "unmqr_batched b8192 n32 k4": lambda: v.variant_unmqr(
                qr.data_ptr(), taus.data_ptr(), c.data_ptr(), o["unmqr"].data_ptr(), b, n, n,
                cs.DX_K, 0, stream),
            "unmqr_batched trans b8192 m64 n32 k4": lambda: v.variant_unmqr(
                qr64.data_ptr(), taus64.data_ptr(), c64.data_ptr(), o["unmqr m64"].data_ptr(),
                bg, mg, ng, kg, 1, stream),
        }

    fns = {f"{name} | {line}": fn for name in names for line, fn in runs(name).items()}
    ms = cs._loop_ms(fns, warmup=3, reps=20, samples=3)
    torch.cuda.synchronize()
    for key, t in ms.items():
        name, line = key.split(" | ")
        bound = (cs._dx_bound(line) if line.startswith("geqrf") else cs._dxe_bound(line))["bound_ms"]
        out_key = {"geqrf_batched b8192 n32": "geqrf", "unmqr_batched trans b8192 n32 k4": "unmqr trans",
                   "unmqr_batched b8192 n32 k4": "unmqr",
                   "unmqr_batched trans b8192 m64 n32 k4": "unmqr m64"}[line]
        got, ref = outs[name][out_key], outs["source"][out_key]
        got, ref = (got[0], ref[0]) if isinstance(got, tuple) else (got, ref)
        diff = float((got - ref).abs().max() / ref.abs().max())
        print(f"[variants] {name:14s} {line:38s} {t:.4f} ms, {bound / t:.1%} of the bound "
              f"{bound:.4f} | vs source {diff:.2e} | {card}", flush=True)


if __name__ == "__main__":
    main()
