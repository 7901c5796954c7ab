#!/usr/bin/env python3
"""Times variants of the batched QR's panel routes (csrc/dx_qr_panel.cu: B7a's
geqrf for 32 < n <= 224 and B7e's unmqr past the warp route, m <= 224)
against the source as it stands, on one CUDA card, at chip_smoke.py's
main-path shapes: geqrf at 1024 x 128, unmqr both ways on its factors with C
(1024, 128, 4), and Q·I at k = 128.

The source's trailing update of a geqrf panel is design (i): a warp takes 8
trailing columns at a time, rows in its lanes' registers, and applies the
panel's 32 reflectors one after another, each 4 columns' sums by
warp_sums4, no barrier between them. The variants "trailing4" and "unmqr4"
take 4 columns a warp at a time in geqrf's trailing update and in unmqr;
"unmqr_blocks2" caps unmqr's registers at 128 (two blocks an SM);
"unmqr16" takes 16 columns a warp where k > 12, "unmqr16_w4" also 4
warps a block whatever k.
The variant "wy" is design (ii), the compact WY form: G = VᵀV (strictly
upper, in the column steps' buffers), then for each chunk of 48 trailing
columns W = VᵀA₂ in 4 x 4 tiles a thread, Y = TᵀW column by column as y_i =
tau_i (W_i − Σ_{p<i} G_pi y_p) (T itself is never formed), and A₂ −= V·Y
in 4 x 4 tiles: three barriers a chunk and 6 KB more shared memory a
block.

Each variant is the source with a few text edits (VARIANTS below); the
source and every variant are built with nvcc into build/qr_panel_variants/
<name>/ with a C entry of their own, all builds started together. Then, in
two turns, each build's kernels by raw launches: CUDA events around 20
back-to-back launches after 3, the share of chip_smoke.py's bound, and the
largest difference of its output from the source build's over the largest
entry, and of geqrf's factors from the plain version's. It prints the card's
name and power limit and each build's registers and spills (ptxas).

    python3 qr_panel_variants.py [variant ...]   # all variants when none is named
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
SRC = cuda_utils.CSRC / "dx_qr_panel.cu"
OUT = ROOT / "build" / "qr_panel_variants"
WY_CHUNK = 48   # trailing columns a chunk of design (ii): W (32 x 48) fits beside n = 128's matrix

WY = r'''
// Design (ii): the compact WY form of a panel's trailing update.
constexpr int kWyChunk = WY_CHUNK;

// V(r, 4 jq ... 4 jq + 3) of the panel at p0: 1 on the diagonal, 0 above,
// the stored reflector below.
__device__ __forceinline__ void v_row4(const float* A, int ld, int p0, int r, int jq, float (&e)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(A + r * ld + p0 + 4 * jq);
  const float s[4] = {a.x, a.y, a.z, a.w};
  const int d = r - p0 - 4 * jq;
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = d == i ? 1.f : d > i ? s[i] : 0.f;
}

__device__ void trailing_wy(float* A, int ld, int n, int p0, const float* taus, float* G, float* W,
                            int tid, int nthreads) {
  for (int t = tid; t < 36; t += nthreads) {   // G = V^T V, its 4 x 4 tiles (a, b), a <= b
    int a = 0, b = t;
    while (b >= 8 - a) { b -= 8 - a; ++a; }
    b += a;
    float acc[4][4] = {};
    for (int r = p0 + 4 * a; r < n; ++r) {
      float va[4], vb[4];
      v_row4(A, ld, p0, r, a, va);
      v_row4(A, ld, p0, r, b, vb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[i][f] = fmaf(va[i], vb[f], acc[i][f]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int ri = 4 * a + i, pf = 4 * b + f;
        if (ri < pf) G[pf * (pf - 1) / 2 + ri] = acc[i][f];
      }
  }
  for (int c_lo = p0 + kPanel; c_lo < n; c_lo += kWyChunk) {
    const int nc = min(kWyChunk, (n - c_lo + 3) / 4 * 4), ncg = nc / 4;
    for (int t = tid; t < 8 * ncg; t += nthreads) {   // W = V^T A2, 4 reflectors x 4 columns a thread
      const int a = t % 8, cg = t / 8;
      float acc[4][4] = {};
      for (int r = p0 + 4 * a; r < n; ++r) {
        float va[4];
        v_row4(A, ld, p0, r, a, va);
        const float4 x = *reinterpret_cast<const float4*>(A + r * ld + c_lo + 4 * cg);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[i][f] = fmaf(va[i], xs[f], acc[i][f]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int f = 0; f < 4; ++f) W[(4 * a + i) * kWyChunk + 4 * cg + f] = acc[i][f];
    }
    __syncthreads();
    for (int c = tid; c < nc; c += nthreads) {   // Y = T^T W, a column a thread
      float y[kPanel];
#pragma unroll
      for (int i = 0; i < kPanel; ++i) {
        float s = W[i * kWyChunk + c];
#pragma unroll
        for (int p = 0; p < i; ++p) s = fmaf(-G[i * (i - 1) / 2 + p], y[p], s);
        y[i] = taus[i] * s;
      }
#pragma unroll
      for (int i = 0; i < kPanel; ++i) W[i * kWyChunk + c] = y[i];
    }
    __syncthreads();
    const int rt = (n - p0 + 3) / 4;
    for (int t = tid; t < rt * ncg; t += nthreads) {   // A2 -= V Y, 4 rows x 4 columns a thread
      const int r0 = p0 + 4 * (t / ncg), c0 = c_lo + 4 * (t % ncg);
      float acc[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 x = *reinterpret_cast<const float4*>(A + (r0 + e) * ld + c0);
        acc[e][0] = x.x;
        acc[e][1] = x.y;
        acc[e][2] = x.z;
        acc[e][3] = x.w;
      }
#pragma unroll 1
      for (int jq = 0; jq < kPanel / 4; ++jq) {
        float v[4][4], y[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v_row4(A, ld, p0, r0 + e, jq, v[e]);
          const float4 yv = *reinterpret_cast<const float4*>(W + (4 * jq + e) * kWyChunk + c0 - c_lo);
          y[e][0] = yv.x;
          y[e][1] = yv.y;
          y[e][2] = yv.z;
          y[e][3] = yv.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int f = 0; f < 4; ++f) acc[e][f] = fmaf(-v[e][i], y[i][f], acc[e][f]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<float4*>(A + (r0 + e) * ld + c0) =
            make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
    }
    __syncthreads();
  }
}
'''.replace("WY_CHUNK", str(WY_CHUNK))

UNMQR16 = [("  const int ng = k > 4 ? 2 : 1,", "  const int ng = k > 12 ? 4 : k > 4 ? 2 : 1,"),
           ("    default: kernel = trans ? unmqr_kernel_for<2, true>(m)",
            "    case 4: kernel = trans ? unmqr_kernel_for<4, true>(m) : unmqr_kernel_for<4, false>(m);"
            " break;\n    default: kernel = trans ? unmqr_kernel_for<2, true>(m)")]

VARIANTS = {
    "source": [],
    # design (ii) in place of design (i): G, W and Y in shared memory (G in
    # the column steps' 512 words, W behind the panel's tau)
    "wy": [("// 168 registers a thread let three blocks",
            WY + "\n// 168 registers a thread let three blocks"),
           ("""      switch ((n - p0 + 31) / 32) {   // rows from p0, in chunks of 32
        case 2: trailing_update<2>(A, ld, n, p0, taus, warp, nw, lane); break;
        case 3: trailing_update<3>(A, ld, n, p0, taus, warp, nw, lane); break;
        case 4: trailing_update<4>(A, ld, n, p0, taus, warp, nw, lane); break;
        case 5: trailing_update<5>(A, ld, n, p0, taus, warp, nw, lane); break;
        case 6: trailing_update<6>(A, ld, n, p0, taus, warp, nw, lane); break;
        default: trailing_update<7>(A, ld, n, p0, taus, warp, nw, lane); break;
      }
""", "      trailing_wy(A, ld, n, p0, taus, part, taus + kPanel, tid, np);\n"),
           ("  const int64_t bytes = geqrf_panel_bytes(n);",
            f"  const int64_t bytes = geqrf_panel_bytes(n) + 4 * kPanel * {WY_CHUNK};")],
    # design (i) with one group of 4 columns a warp at a time (the source
    # takes two: two reflector sums in flight)
    "trailing4": [("  constexpr int NG = 2;\n", "  constexpr int NG = 1;\n")],
    # unmqr with one group of 4 columns a warp at a time whatever k
    "unmqr4": [("  const int ng = k > 4 ? 2 : 1,", "  const int ng = 1,")],
    # unmqr's registers capped for two blocks of 256 threads an SM
    "unmqr_blocks2": [("__launch_bounds__(256, 1) unmqr_panel_kernel",
                       "__launch_bounds__(256, 2) unmqr_panel_kernel")],
    # unmqr with 16 columns a warp where k > 12 (four reflector sums in flight)
    "unmqr16": UNMQR16,
    # and blocks of 4 warps whatever k
    "unmqr16_w4": UNMQR16 + [("  const int warps = units > 7 ? 8 : 4;\n", "  const int warps = 4;\n")],
}
ENTRY = r'''
#include "dx_qr_warp.cuh"
extern "C" int variant_geqrf(const void* a, void* qr, void* tau, long long batch, int n, void* s) {
  return tml_qr::launch_geqrf_panel((const float*)a, (float*)qr, (float*)tau, batch, n,
                                    (cudaStream_t)s);
}
extern "C" int variant_unmqr(const void* qr, const void* tau, const void* c, void* x,
                             long long batch, int m, int n, int k, int trans, void* s) {
  return tml_qr::launch_unmqr_panel((const float*)qr, (const float*)tau, (const float*)c,
                                    (float*)x, batch, m, n, k, trans != 0, (cudaStream_t)s);
}
'''
KERNELS = ("geqrf_panel", "unmqr_panel_kernelILi4ELi1ELb1", "unmqr_panel_kernelILi4ELi2ELb0")


def edited(name: str) -> str:
    s = SRC.read_text()
    for old, new in VARIANTS[name]:
        if old not in s:
            raise SystemExit(f"qr_panel_variants: {name}: the source no longer holds {old!r}")
        s = s.replace(old, new)
    return s


def start_build(name: str):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "dx_qr_panel.cu").write_text(edited(name))
    (d / "dx_qr_warp.cuh").write_text((cuda_utils.CSRC / "dx_qr_warp.cuh").read_text())
    (d / "entry.cu").write_text(ENTRY)
    cmd = [cuda_utils._nvcc(), *cuda_utils.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
           str(d / "dx_qr_panel.cu"), str(d / "entry.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d


def ptxas(log: str) -> list[str]:
    """Registers and spills of geqrf's panel kernel and unmqr's at m = 128."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((k for k in KERNELS if k in line), None)
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.strip()}")
    return out


def main() -> None:
    names = ["source"] + [v for v in (sys.argv[1:] or list(VARIANTS)) if v != "source"]
    dev, card = cs.phase_device()
    t0 = time.perf_counter()
    builds = {name: start_build(name) for name in names}
    libs = {}
    for name, (proc, d) in builds.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"qr_panel_variants: {name} did not build:\n{out[-4000:]}")
        for line in ptxas(out):
            print(f"[variants] {name}: {line}", flush=True)
        v = ctypes.CDLL(str(d / "lib.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        v.variant_geqrf.argtypes = [p, p, p, ctypes.c_longlong, i, p]
        v.variant_unmqr.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, p]
        libs[name] = v
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(27)
    b, n = cs.DX_WIDE
    a = torch.randn((b, n, n), generator=gen, device=dev)
    c = torch.randn((b, n, cs.DX_K), generator=gen, device=dev)
    eye = torch.eye(n, device=dev).expand(b, n, n).contiguous()
    qr_p, taus_p = dxs._geqrf_plain(a)
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = {name: {} for name in names}
    lines = {"geqrf_batched b1024 n128": "geqrf", "unmqr_batched trans b1024 n128 k4": "unmqr trans",
             "unmqr_batched b1024 n128 k4": "unmqr", "unmqr_batched Q·I b1024 n128 k128": "unmqr QI"}

    def runs(name: str) -> dict:
        v, o = libs[name], outs[name]
        o.setdefault("geqrf", (torch.empty_like(a), torch.empty((b, n), device=dev)))
        for key, like in (("unmqr trans", c), ("unmqr", c), ("unmqr QI", eye)):
            o.setdefault(key, torch.empty_like(like))

        def unmqr(key, rhs, k, trans):
            return lambda: v.variant_unmqr(qr_p.data_ptr(), taus_p.data_ptr(), rhs.data_ptr(),
                                           o[key].data_ptr(), b, n, n, k, trans, stream)
        return {
            "geqrf_batched b1024 n128": lambda: v.variant_geqrf(
                a.data_ptr(), o["geqrf"][0].data_ptr(), o["geqrf"][1].data_ptr(), b, n, stream),
            "unmqr_batched trans b1024 n128 k4": unmqr("unmqr trans", c, cs.DX_K, 1),
            "unmqr_batched b1024 n128 k4": unmqr("unmqr", c, cs.DX_K, 0),
            "unmqr_batched Q·I b1024 n128 k128": unmqr("unmqr QI", eye, n, 0),
        }

    fns = {f"{name} | {line}": fn for name in names for line, fn in runs(name).items()}
    for turn in (1, 2):
        ms = cs._loop_ms(fns, warmup=3, reps=20, samples=3)
        torch.cuda.synchronize()
        for key, t in ms.items():
            name, line = key.split(" | ")
            bound = (cs._dx_bound(line) if line.startswith("geqrf")
                     else cs._dxe_bound(line))["bound_ms"]
            got, want = outs[name][lines[line]], outs["source"][lines[line]]
            got, want = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
            diff = float((got - want).abs().max() / want.abs().max())
            plain = (f", vs plain {cs.max_scaled_err(got, qr_p):.2e}" if line.startswith("geqrf")
                     else "")
            print(f"[variants] turn {turn} {name:8s} {line:36s} {t:.4f} ms, {bound / t:.1%} of the "
                  f"bound {bound:.4f} | vs source {diff:.2e}{plain} | {card}", flush=True)


if __name__ == "__main__":
    main()
