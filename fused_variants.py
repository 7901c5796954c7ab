#!/usr/bin/env python3
"""Times variants of the fused kernels of dx, B8c (csrc/dx_comp.cu,
decode_dot_kernel) and B9's tensor-core route (csrc/dx_fused.cu,
gemm_fft_tc_kernel), against the sources as they stand, on one CUDA card, at
chip_smoke.py's main-path calls: dx_decompress_dot on 64 Mi int32 of a walk
of steps -60..60 packed at bits 8 (524288 rows) against W (128, 128), scale
0.01; gemm_fft at (32768, 256, 256) with gelu.

Each variant is a source with a few text edits (VARIANTS below, named
kernel:variant); the variants that leave work out show which part of a
kernel sets its pace. Each builds alone with nvcc (the source holds its own
C entries) into build/fused_variants/<kernel>-<variant>/, all builds started
together. Then, in two turns, each build's C entry by raw launches: CUDA
events around 10 back-to-back launches after 2, the share of chip_smoke.py's
bound, and the largest difference of its output from the source's over the
source's largest (a variant that leaves work out differs by design). It
prints the card's name and power limit and each build's registers and
spills; the decode_dot:stamps variant also prints where its blocks' clocks
go.

    python3 fused_variants.py [kernel:variant ...]   # all variants when none is named
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from tpumathlib_torch.dx import comp as dxc
from tpumathlib_torch.dx import cuda_utils, fused, tf32x3
from tpumathlib_torch.fft import kernels as fft_kernels

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "fused_variants"
SOURCES = {"decode_dot": ("dx_comp.cu", "decode_dot_kernel"),
           "gemm_fft": ("dx_fused.cu", "gemm_fft_tc_kernelILi16E")}
EXTRA = {"gemm_fft": ("gemm_tf32x3.cu",)}   # tml_gemm_fft launches its tml_split_tf32
HEADERS = ("hopper_ring.cuh", "stockham_passes.cuh", "philox.cuh")

DECODE = ("sum += static_cast<uint32_t>(zigzag_dec(__funnelshift_r(w[wi], w[wi + 1], bit & 31) & "
          "mask));")
POW2 = "sum += static_cast<uint32_t>(zigzag_dec((w[j * BITS / 32] >> (j * BITS % 32)) & kMask));"
STAMP = r"""
__device__ unsigned long long g_stamps[4][6][32][8];
extern "C" int variant_stamps(void* dst) {
  return cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
#define STAMP(role, tile, slot)                                                                \
  do {                                                                                         \
    if (blockIdx.x < 4 && blockIdx.y == 0 && threadIdx.x % 32 == 0 && (tile) < 32)             \
      g_stamps[blockIdx.x][role][tile][slot] = clock64();                                      \
  } while (0)
"""
VARIANTS = {
    # the decode warps add their word index instead of a decoded field: the
    # pace of the products, the hand-over and the stores
    "decode_dot:no_decode": [(DECODE, "sum += static_cast<uint32_t>(wi);"),
                             (POW2, "sum += static_cast<uint32_t>(j);")],
    # the consumers run no products (a zero partial a stage): the pace of
    # the decode, the hand-over and the stores
    "decode_dot:no_products": [(
        "stage_tf32x3_at(part, tile + q * kDotChunk, w_u + q * kDotWChunk, "
        "w_u + (4 + q) * kDotWChunk);", "for (int j = 0; j < 64; ++j) part[j] = 0.f;")],
    # the consumers store nothing
    "decode_dot:no_stores": [("if (row < rows && col < ncols)", "if (row < 0)")],
    # the decode warps copy no words (they decode what the buffers hold)
    "decode_dot:no_fetch": [("cp_async4(dst + rr * stride, src + rr * nw);", "(void)src;")],
    # every width read as two words a value (no compile-time power-of-two path)
    "decode_dot:funnel_only": [("          switch (bits) {", "          switch (0) {")],
    # the consumers' stores marked streaming (evict first)
    "decode_dot:stores_cs": [(
        "store_pair(out, row * ncols + col, acc[j], acc[j + 1], col + 1 < ncols, two);",
        "__stcs(reinterpret_cast<float2*>(out + row * ncols + col), "
        "make_float2(acc[j], acc[j + 1]));")],
    # the source with clock64 stamps of blocks 0-3 (STAMP_SLOTS), read back
    # by variant_stamps and summed up after the timing
    "decode_dot:stamps": [
        ('#include "hopper_ring.cuh"\n', '#include "hopper_ring.cuh"\n' + STAMP),
        ("      for (int g0 = 0; g0 < 4; g0 += groups, ++k) {\n",
         "      STAMP(2 + dw, i >> 1, 0);\n      for (int g0 = 0; g0 < 4; g0 += groups, ++k) {\n"),
        ("        const uint32_t* w = area + (k & 1) * kDotStage + lane * stride;\n",
         "        const uint32_t* w = area + (k & 1) * kDotStage + lane * stride;\n"
         "        STAMP(2 + dw, i >> 1, 1);\n"),
        ("          mbar_arrive(smem_u32(&full[p][q]));\n",
         "          STAMP(2 + dw, i >> 1, 2 + q);\n          mbar_arrive(smem_u32(&full[p][q]));\n"),
        ("#pragma unroll 1\n    for (int q = 0; q < 4; ++q) {\n",
         "    STAMP(cg, i >> 1, 0);\n#pragma unroll 1\n    for (int q = 0; q < 4; ++q) {\n"),
        ("      mbar_wait(smem_u32(&full[cg][q]), (i >> 1) & 1);\n",
         "      mbar_wait(smem_u32(&full[cg][q]), (i >> 1) & 1);\n      STAMP(cg, i >> 1, 1 + q);\n"),
        ("        store_pair(out, row * ncols + col, acc[j], acc[j + 1], col + 1 < ncols, two);\n"
         "    }\n",
         "        store_pair(out, row * ncols + col, acc[j], acc[j + 1], col + 1 < ncols, two);\n"
         "    }\n    STAMP(cg, i >> 1, 5);\n")],
    # gemm_fft's tensor-core route without its row FFTs (C written to the
    # ring, nothing to y), or without its products (C = epilogue(0))
    "gemm_fft:no_fft": [("  row_ffts<P>(lp, c, kTcBM, m0, m, yr, yi, tab);\n", "")],
    "gemm_fft:no_products": [("      stage_tf32x3_at(part, sa, sb, sb + kTcPlaneBytes);\n",
                              "      for (int i = 0; i < 64; ++i) part[i] = 0.f;\n")],
}
# decode_dot:stamps' slots: consumers (roles 0, 1) tile start, chunk q landed
# (1-4), stores done (5); decode warps (roles 2-5) tile start, words staged
# (1), chunk q written (2-5)
STAMP_SLOTS = {"consumer": ("start", "chunk 0 in", "chunk 1 in", "chunk 2 in", "chunk 3 in",
                            "stored"),
               "decoder": ("start", "staged", "chunk 0 out", "chunk 1 out", "chunk 2 out",
                           "chunk 3 out")}


def edited(name: str) -> str:
    kernel = name.split(":")[0]
    s = (cuda_utils.CSRC / SOURCES[kernel][0]).read_text()
    for old, new in VARIANTS[name]:
        if old not in s:
            raise SystemExit(f"fused_variants: {name}: the source no longer holds {old!r}")
        s = s.replace(old, new)
    return s


def start_build(name: str):
    kernel = name.split(":")[0]
    d = OUT / name.replace(":", "-")
    d.mkdir(parents=True, exist_ok=True)
    src = d / SOURCES[kernel][0]
    src.write_text(edited(name))
    extra = [d / e for e in EXTRA.get(kernel, ())]
    for f in HEADERS + EXTRA.get(kernel, ()):
        (d / f).write_text((cuda_utils.CSRC / f).read_text())
    cmd = [cuda_utils._nvcc(), *cuda_utils.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(src),
           *map(str, extra)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d


def ptxas(log: str, entry: str) -> list[str]:
    """Registers and spills of the kernels whose names hold ``entry``."""
    out, cur = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = entry in line
        elif cur and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def bind(lib, kernel: str):
    """The variant's C entry, with the argument types of cuda_utils's."""
    name = {"decode_dot": "tml_cascaded_decode_dot", "gemm_fft": "tml_gemm_fft"}[kernel]
    fn, ref = getattr(lib, name), getattr(cuda_utils.load_kernels(), name)
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return fn


def print_stamps(stamps_of) -> None:
    """Each role's clocks from one slot to the next, the median over blocks
    0-3 and their tiles 1-29 (the first and the last left out), and the
    clocks from one tile's start to the next."""
    buf = np.zeros((4, 6, 32, 8), np.uint64)
    stamps_of.argtypes = [ctypes.c_void_p]
    if stamps_of(buf.ctypes.data) != 0:
        raise SystemExit("fused_variants: the stamps did not copy")
    st = buf.astype(np.int64)[:, :, 1:30]
    for role in range(6):
        kind = "consumer" if role < 2 else "decoder"
        slots = STAMP_SLOTS[kind]
        s = st[:, role, :, :len(slots)]
        steps = [f"{slots[k - 1]}->{slots[k]} {int(np.median(s[..., k] - s[..., k - 1]))}"
                 for k in range(1, len(slots))]
        period = int(np.median(s[:, 1:, 0] - s[:, :-1, 0]))
        print(f"[stamps] {kind} {role if role < 2 else role - 2}: tile to tile {period} clocks | "
              + ", ".join(steps), flush=True)


def calls(dev) -> dict:
    """kernel: (call(entry) -> status, output, bound ms) at the main-path sizes."""
    gen = torch.Generator(device=dev).manual_seed(25)
    stream = torch.cuda.current_stream(dev).cuda_stream
    walk = torch.cumsum(torch.randint(-60, 61, (cs.DXC_N,), generator=gen, device=dev), 0)
    packed, leaders = dxc.dx_compress(walk.to(torch.int32), bits=cs.DXC_BITS)
    del walk
    w = torch.randn((128, cs.DXC_W), generator=gen, device=dev)
    rows = packed.shape[0]
    dot = torch.empty((rows, cs.DXC_W), device=dev)
    m, k, n = cs.GEMM_FFT_MAIN
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    bt = tf32x3.planes(n, k, dev)
    y = torch.empty((2, m, n), device=dev)
    plan = fused._gemm_fft_plan(n)
    roots = fft_kernels._roots_on(n, False, dev)
    return {
        "decode_dot": (lambda fn: fn(packed.data_ptr(), leaders.data_ptr(), w.data_ptr(),
                                     dot.data_ptr(), rows, cs.DXC_W, cs.DXC_BITS, 0.01, stream),
                       dot, cs._dxc_bound("decode_dot")["bound_ms"]),
        "gemm_fft": (lambda fn: fn(a.data_ptr(), a.stride(0), b.data_ptr(), bt[0].data_ptr(),
                                   bt[1].data_ptr(), bt.stride(1), roots.data_ptr(), plan.words,
                                   len(plan.words),
                                   y[0].data_ptr(), y[1].data_ptr(), m, k, n,
                                   fused._ACT_CODE["gelu"], stream),
                     y, cs._dxc_bound("gemm_fft")["bound_ms"]),
    }


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    dev, card = cs.phase_device()
    t0 = time.perf_counter()
    builds = {name: start_build(name) for name in names}
    built = cuda_utils.build_kernels()
    lib = cuda_utils.load_kernels()
    entries = [(kernel, "source", bind(lib, kernel)) for kernel in SOURCES
               if any(n.startswith(kernel + ":") for n in names)]
    for kernel, _, _ in entries:
        for line in ptxas((built.parent / "nvcc.log").read_text(), SOURCES[kernel][1]):
            print(f"[variants] {kernel}:source: {line}", flush=True)
    stamps_of = None
    for name, (proc, d) in builds.items():
        out = proc.communicate()[0]
        kernel = name.split(":")[0]
        if proc.returncode:
            raise SystemExit(f"fused_variants: {name} did not build:\n{out[-4000:]}")
        for line in ptxas(out, SOURCES[kernel][1]):
            print(f"[variants] {name}: {line}", flush=True)
        variant = ctypes.CDLL(str(d / "lib.so"))
        entries.append((kernel, name.split(":")[1], bind(variant, kernel)))
        if name == "decode_dot:stamps":
            stamps_of = variant.variant_stamps
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)

    run = calls(dev)
    want = {}
    for turn in range(2):
        for kernel, name, fn in entries:
            call, out, bound = run[kernel]
            if call(fn) != 0:
                raise SystemExit(f"fused_variants: {kernel}:{name} did not launch")
            torch.cuda.synchronize()
            ref = want.setdefault(kernel, out.clone())
            err = float((out - ref).abs().max() / ref.abs().max())
            for _ in range(2):
                call(fn)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call(fn)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 10
            print(f"[variants] turn {turn} {kernel}:{name:12s} {ms:.4f} ms, {bound / ms:.1%} of "
                  f"{bound:.4f}; output vs the source's {err:.2e} | {card}", flush=True)
    if stamps_of is not None:
        print_stamps(stamps_of)


if __name__ == "__main__":
    main()
