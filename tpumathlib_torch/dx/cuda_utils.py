"""Device detection and the kernel library's build and loader.

Counterpart of ``tpumathlib/dx/pallas_utils.py``. A Pallas kernel has an
interpret mode off the TPU; a CUDA kernel has none. So a wrapper in this
package takes its plain PyTorch version only for tensors on the CPU, and
for CUDA tensors it launches its kernel or raises.

The kernels are compiled at first use, never at import, so the package
imports on machines without ``nvcc``. One ``nvcc`` per ``csrc/*.cu``, all
started together, compiles each source to an object; one more links them
into a shared library with a plain C interface,
``build/tpumathlib_torch/<hash>/libtml_kernels.so`` under the repository
root. The hash covers the sources and the flags, so an edited source
rebuilds. The library is loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from tpumathlib_torch.core.errors import ExecutionError

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "tpumathlib_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def on_cuda(*tensors) -> bool:
    """True when any of the given tensors (None skipped) lies on a CUDA device."""
    return any(t is not None and t.is_cuda for t in tensors)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise ExecutionError("nvcc not found: the kernels build only where the CUDA toolkit is")
    return found


def _communicate_all(procs) -> tuple[list[str], list[float]]:
    """Each process's output and the seconds, from this call, at which it
    ended: one thread a process reads its pipe while it runs."""
    t0 = time.perf_counter()
    outs, secs = [""] * len(procs), [0.0] * len(procs)

    def wait(j):
        outs[j] = procs[j].communicate()[0]
        secs[j] = time.perf_counter() - t0

    threads = [threading.Thread(target=wait, args=(j,)) for j in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs, secs


def build_kernels() -> Path:
    """Compile ``csrc/*.cu`` (once per content hash); returns the library path.
    Raises ExecutionError with nvcc's output when the build fails. The
    compiler's resource report (registers, shared memory, spills) is kept
    beside the library as ``nvcc.log``, and each source's compile time (in
    seconds from the start of all: they run at once) as
    ``compile_seconds.json``."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libtml_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in srcs]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    outs, secs = _communicate_all(procs)
    (out_dir / "nvcc.log").write_text("".join(outs))
    (out_dir / "compile_seconds.json").write_text(json.dumps(
        {src.name: round(t, 1) for src, t in zip(srcs, secs)}, indent=1))
    for cmd, proc, out in zip(compiles, procs, outs):
        if proc.returncode != 0:
            raise ExecutionError(
                f"kernel build failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}")
    tmp = out_dir / f"libtml_kernels.{tag}.tmp"
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise ExecutionError(
            f"kernel link failed (exit {proc.returncode}): {' '.join(link)}\n{proc.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
    lib.tml_gemm_epilogue.argtypes = [
        p, p, p, p, p, p,                       # a, b, c, bias, d, aux
        i64, i64, i64, i64,                     # batch, m, n, k
        ctypes.POINTER(i64),                    # strides[11]
        f32, f32,                               # alpha, beta
        i32, i32, i32, i32, i32,                # act, ab/c/d dtype codes, config
        p,                                      # stream
    ]
    lib.tml_gemm_epilogue.restype = i32
    # gemm_wgmma.cu: the same arguments, bf16/f16 A and B
    lib.tml_gemm_wgmma.argtypes = lib.tml_gemm_epilogue.argtypes
    lib.tml_gemm_wgmma.restype = i32
    # dense_block.cu: (a, lda, out, ld, ..., stream), f32 blocks of 128 x 128
    lib.tml_chol_inv_block.argtypes = [p, i64, p, i64, p, i64, p]
    lib.tml_chol_inv_block.restype = i32
    lib.tml_lu_inv_block.argtypes = [p, i64, p, i64, p, i64, p, i64, p]
    lib.tml_lu_inv_block.restype = i32
    # qr_block.cu: the same layout; hh_recon also writes d, 128 floats
    lib.tml_hh_recon_block.argtypes = [p, i64, p, i64, p, i64, p, p]
    lib.tml_hh_recon_block.restype = i32
    lib.tml_inv_upper_block.argtypes = [p, i64, p, i64, p]
    lib.tml_inv_upper_block.restype = i32
    # qr_gram.cu: (x, ldx, xtop, ldxt, xtop_rows, the same for y, c, ldc, d, ldd, k, m, n,
    # alpha, beta, ridge, flags, work, work_tiles, counters, ncounters, stream)
    lib.tml_gram_tn.argtypes = [p, i64, p, i64, i64, p, i64, p, i64, i64, p, i64, p, i64,
                                i64, i64, i64, f32, f32, f32, i32, p, i64, p, i64, p]
    lib.tml_gram_tn.restype = i32
    # fft_dif.cu: (xr, xi, yr, yi, scratch, twiddles, rows, log_n, log_l, bf16, stream)
    lib.tml_dif_fft.argtypes = [p, p, p, p, p, p, i64, i32, i32, i32, p]
    lib.tml_dif_fft.restype = i32
    # fft_four_step.cu: (xr, xi, yr, yi, scratch, roots, rows, n1, n2, mode, inverse,
    # plan words, their count, stream)
    lib.tml_four_step_fft.argtypes = [p, p, p, p, p, p, i64, i64, i64, i32, i32,
                                      ctypes.POINTER(i32), i64, p]
    lib.tml_four_step_fft.restype = i32
    # bell_wgmma.cu: (cols, a, b, y, mb, ellw, bs, m, n, k, ldb, alpha, dtype code, stream)
    lib.tml_bell_spmm_wgmma.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, i64, f32, i32,
                                        p]
    lib.tml_bell_spmm_wgmma.restype = i32
    # (cols, a, bt_hi, bt_lo, ldb, y, mb, ellw, bs, m, n, k, alpha, a and y dtype codes,
    # stream)
    lib.tml_bell_spmm_tf32x3.argtypes = [p, p, p, p, i64, p, i64, i64, i64, i64, i64, i64, f32,
                                         i32, i32, p]
    lib.tml_bell_spmm_tf32x3.restype = i32
    # bell_sparse.cu: (cols, a, x, y, mb, ellw, bs, m, n, alpha, stream), f32
    lib.tml_bell_spmv.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, f32, p]
    lib.tml_bell_spmv.restype = i32
    # dx_solver.cu, f32: (a, factor, [piv,] b, x, batch, n, k, [pivot,] stream);
    # b = x = null and k = 0 without a right-hand side
    lib.tml_potrf_batched.argtypes = [p, p, p, p, i64, i64, i64, p]
    lib.tml_potrf_batched.restype = i32
    lib.tml_getrf_batched.argtypes = [p, p, p, p, p, i64, i64, i64, i32, p]
    lib.tml_getrf_batched.restype = i32
    # (a, qr, tau, batch, n, stream)
    lib.tml_geqrf_batched.argtypes = [p, p, p, i64, i64, p]
    lib.tml_geqrf_batched.restype = i32
    # (qr, tau, c, x, work, batch, m, n, k, trans, stream)
    lib.tml_unmqr_batched.argtypes = [p, p, p, p, p, i64, i64, i64, i64, i32, p]
    lib.tml_unmqr_batched.restype = i32
    # (a, b, x, work, batch, m, n, k, stream)
    lib.tml_gels_batched.argtypes = [p, p, p, p, i64, i64, i64, i64, p]
    lib.tml_gels_batched.restype = i32
    # dx_jacobi.cu, f32: (a, pairs, [u,] w or s, v, batch, n, sweeps, stream)
    lib.tml_syevd_batched.argtypes = [p, p, p, p, i64, i64, i64, p]
    lib.tml_syevd_batched.restype = i32
    lib.tml_gesvd_batched.argtypes = [p, p, p, p, p, i64, i64, i64, p]
    lib.tml_gesvd_batched.restype = i32
    # dx_comp.cu: decode (packed, leaders, out, rows, count, bits, stream),
    # encode (values, packed, leaders, n, bits, stream), decode_dot (packed,
    # leaders, w, out, rows, ncols, bits, scale, stream)
    lib.tml_cascaded_decode.argtypes = [p, p, p, i64, i64, i32, p]
    lib.tml_cascaded_decode.restype = i32
    lib.tml_cascaded_encode.argtypes = [p, p, p, i64, i32, p]
    lib.tml_cascaded_encode.restype = i32
    lib.tml_cascaded_decode_dot.argtypes = [p, p, p, p, i64, i64, i32, f32, p]
    lib.tml_cascaded_decode_dot.restype = i32
    # dx_fused.cu, f32: (a, lda, b, scratch bt_hi, bt_lo, ldt, roots, plan words, plan length,
    # yr, yi, m, k, n, epilogue code, stream); the SIMT route (a, b, roots, plan, plan length,
    # yr, yi, m, k, n, epilogue code, stream)
    lib.tml_gemm_fft.argtypes = [p, i64, p, p, p, i64, p, ctypes.POINTER(i32), i64, p, p, i64, i64,
                                 i64, i32, p]
    lib.tml_gemm_fft.restype = i32
    lib.tml_gemm_fft_simt.argtypes = [p, p, p, ctypes.POINTER(i32), i64, p, p, i64, i64, i64, i32,
                                      p]
    lib.tml_gemm_fft_simt.restype = i32
    # dx_rng.cu: uniform (out, n, key0, key1, stream)
    u32 = ctypes.c_uint32
    lib.tml_random_uniform.argtypes = [p, i64, u32, u32, p]
    lib.tml_random_uniform.restype = i32
    # dx_vv10.cu, f32: (wr, w0, kappa, pts, inner (G,) or sums (5, G), G, stream)
    lib.tml_vv10_fwd.argtypes = [p, p, p, p, p, i64, p]
    lib.tml_vv10_fwd.restype = i32
    lib.tml_vv10_bwd.argtypes = [p, p, p, p, p, i64, p]
    lib.tml_vv10_bwd.restype = i32
    # mp_overlap.cu: (partial, slot, d or null, count, d dtype code, stream)
    lib.tml_ring_accumulate.argtypes = [p, p, p, i64, i32, p]
    lib.tml_ring_accumulate.restype = i32
    # gemm_tf32x3.cu: split (x, ldx, hi, lo, ldo, rows, cols, flags, stream); the product
    # (a_hi, a_lo, lda, b_hi, b_lo, ldb, c, ldc, d, ldd, m, n, k, alpha, beta, stream)
    lib.tml_split_tf32.argtypes = [p, i64, p, p, i64, i64, i64, i32, p]
    lib.tml_split_tf32.restype = i32
    lib.tml_gemm_tf32x3.argtypes = [p, p, i64, p, p, i64, p, i64, p, i64, i64, i64, i64, f32, f32,
                                    p]
    lib.tml_gemm_tf32x3.restype = i32
    # B1's f32 route: (a_hi, a_lo, b_hi, b_lo, c, bias, d, aux, batch, m, n, k, strides[9],
    # alpha, beta, act, c/d dtype codes, stream)
    lib.tml_gemm_tf32x3_epilogue.argtypes = [p, p, p, p, p, p, p, p, i64, i64, i64, i64,
                                             ctypes.POINTER(i64), f32, f32, i32, i32, i32, p]
    lib.tml_gemm_tf32x3_epilogue.restype = i32
    # B10b: (a_hi, a_lo, lda, b_hi, b_lo, ldb, d, ldd, m, n, k, key0, key1, rate, 1 - rate,
    # exact, stream)
    lib.tml_dropout_matmul.argtypes = [p, p, i64, p, p, i64, p, i64, i64, i64, i64, u32, u32,
                                       f32, f32, i32, p]
    lib.tml_dropout_matmul.restype = i32
    lib.tml_gemm_configs.argtypes = [ctypes.POINTER(i32), i32]
    lib.tml_gemm_configs.restype = i32
    lib.tml_gemm_wgmma_configs.argtypes = [ctypes.POINTER(i32), i32]
    lib.tml_gemm_wgmma_configs.restype = i32
    lib.tml_error_string.argtypes = [i32]
    lib.tml_error_string.restype = ctypes.c_char_p
    return lib


def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; the handle is cached
    for the process. Raises when there is no CUDA device or the build or
    load fails."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise ExecutionError("the CUDA kernels need a CUDA device")
            path = build_kernels()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise ExecutionError(f"cannot load {path}: {e}") from e
            _lib = _bind(lib)
        return _lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise ExecutionError for a non-zero CUDA status from a launch."""
    if rc != 0:
        msg = lib.tml_error_string(rc).decode(errors="replace")
        raise ExecutionError(f"{what}: CUDA error {rc} ({msg})")
