"""CPU tests of the card scripts' host-side parts: chip_smoke.py's split of a
tile's time from csrc/gemm_wgmma.cu's stamps, and time_paths.py's paths
(run at a small n on the CPU, where every wrapper takes its plain version)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stamps(blocks):
    """(blocks, 5) stamps from (sm, start ns, prologue, main loop, epilogue) rows."""
    return np.array([[t0, t0 + p, t0 + p + ml, t0 + p + ml + e, sm]
                     for sm, t0, p, ml, e in blocks], dtype=np.int64)


@pytest.mark.parametrize("blocks, want", [
    # two SMs, two blocks each: 300 ns between a block's end and the next start
    ([(0, 1000, 1700, 41200, 8600), (0, 52800, 1700, 41200, 8600),
      (1, 1100, 1800, 41000, 8700), (1, 52900, 1800, 41000, 8700)],
     {"prologue_us": 1.75, "main_loop_us": 41.1, "epilogue_us": 8.65, "gap_us": 0.3,
      "tiles_per_sm": (2, 2), "span_ms": (52900 + 1800 + 41000 + 8700 - 1000) / 1e6}),
    # one block an SM: no gap to measure
    ([(3, 0, 2000, 40000, 9000), (7, 500, 2000, 40000, 9000), (5, 250, 2000, 40000, 9000)],
     {"prologue_us": 2.0, "main_loop_us": 40.0, "epilogue_us": 9.0, "gap_us": None,
      "tiles_per_sm": (1, 1), "span_ms": 51500 / 1e6}),
    # blocks out of order in the buffer, three on one SM and one on another
    ([(2, 120000, 1500, 40000, 8000), (2, 0, 1500, 40000, 8000),
      (4, 10, 1500, 40000, 8000), (2, 60000, 1500, 40000, 8000)],
     {"prologue_us": 1.5, "main_loop_us": 40.0, "epilogue_us": 8.0, "gap_us": 10.5,
      "tiles_per_sm": (1, 3), "span_ms": 169500 / 1e6}),
])
def test_tile_split_from_stamps(blocks, want):
    got = _load("chip_smoke")._split(_stamps(blocks))
    assert got["tiles_per_sm"] == want["tiles_per_sm"]
    for key in ("prologue_us", "main_loop_us", "epilogue_us", "span_ms"):
        assert got[key] == pytest.approx(want[key]), key
    if want["gap_us"] is None:
        assert got["gap_us"] is None
    else:
        assert got["gap_us"] == pytest.approx(want["gap_us"])


def test_f32_paths_run_on_the_cpu(monkeypatch):
    mod = _load("time_paths")
    monkeypatch.setattr(mod, "N", 256)
    monkeypatch.setattr(mod, "PANEL", 128)
    monkeypatch.setattr(mod, "SPMM", (4, 4, 2, 128, 64))
    monkeypatch.setattr(mod, "SPMV", (4, 4, 2, 128))
    monkeypatch.setattr(mod, "FFT", (4, 256))
    monkeypatch.setattr(mod, "BATCHED", ((8, 32), (2, 128)))
    monkeypatch.setattr(mod, "JACOBI", ((4, 32), (2, 64)))
    monkeypatch.setattr(mod, "GELS", (8, 64, 32, 4))
    monkeypatch.setattr(mod, "MP", (64, 32, 128))
    monkeypatch.setattr(mod, "VV10", 300)
    monkeypatch.setattr(mod, "CODEC_N", 64 * 128)
    monkeypatch.setattr(mod, "GEMM_FFT", (32, 16, 64))
    paths = mod._paths(torch.device("cpu"))
    mp_paths = mod._mp_paths(torch.device("cpu"))
    assert not set(paths) & set(mp_paths)   # the rings' inputs are made apart, timed last
    paths |= mp_paths
    assert sorted(paths) == sorted(["potrf_onelaunch", "getrf_onelaunch", "geqrf_onelaunch",
                                    "orgqr_onelaunch", "potrf_blocked", "dropout_matmul_kernel",
                                    "dropout_matmul_kernel_bf16", "pallas_matmul_bf16_gelu_bias",
                                    "pallas_matmul_f32_gelu_bias", "spmm_bell_bf16",
                                    "spmm_bell_f32", "spmm_bell_bf16_f32", "spmv_bell_f32",
                                    "spmv_bell_bf16_f32", "vv10_energy", "vv10_value_and_grad",
                                    "dif_fft_f32_natural", "dif_fft_bf16_raw",
                                    "pallas_fft", "pallas_fft2", "potrf_batched_1024x128",
                                    "potrf_batched_8192x32", "posv_batched_8192x32_k4",
                                    "getrf_batched_8192x32", "getrf_batched_nopivot_8192x32",
                                    "gesv_batched_8192x32_k4", "getrf_batched_1024x128",
                                    "geqrf_batched_8192x32", "geqrf_batched_1024x128",
                                    "unmqr_batched_trans_8192x32x32_k4",
                                    "unmqr_batched_8192x32x32_k4",
                                    "unmqr_batched_trans_1024x128x128_k4",
                                    "unmqr_batched_1024x128x128_k4",
                                    "unmqr_batched_QI_1024x128x128_k128",
                                    "gels_batched_8192x64x32_k4",
                                    "syevd_batched_8192x32", "gesvd_batched_8192x32",
                                    "syevd_batched_2048x64", "gesvd_batched_2048x64",
                                    "dx_decompress_dot_524288x128x128",
                                    "gemm_fft_32768x256x256_gelu",
                                    "matmul_ag_overlapped", "matmul_rs_overlapped"])
    for name, fn in paths.items():
        out = fn()
        for t in out if isinstance(out, tuple) else (out,):
            assert torch.isfinite(t).all(), name
    chol = paths["potrf_blocked"]()
    assert torch.allclose(chol, paths["potrf_onelaunch"](), atol=1e-4)


def test_f32_paths_imports_neither_jax_nor_reference():
    code = ("import sys, runpy\n"
            "sys.argv = ['time_paths.py']\n"
            "runpy.run_path('time_paths.py', run_name='not_main')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpumathlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_qr_panel_variants_imports_neither_jax_nor_reference():
    code = ("import sys, runpy\n"
            "sys.argv = ['qr_panel_variants.py']\n"
            "runpy.run_path('qr_panel_variants.py', run_name='not_main')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpumathlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_qr_panel_variants_edit_the_source():
    """The WY variant's edits still find their text in csrc/dx_qr_panel.cu:
    design (ii) takes the place of design (i)'s trailing update, and its
    launch asks for W's shared memory."""
    mod = _load("qr_panel_variants")
    assert sorted(mod.VARIANTS) == ["source", "trailing4", "unmqr16", "unmqr16_w4", "unmqr4",
                                    "unmqr_blocks2", "wy"]
    for name in ("trailing4", "unmqr4", "unmqr_blocks2", "unmqr16", "unmqr16_w4"):
        assert mod.edited(name) != mod.SRC.read_text()
    got = mod.edited("wy")
    assert got != mod.SRC.read_text()
    assert "trailing_wy(A, ld, n, p0, taus, part, taus + kPanel, tid, np);" in got
    assert "trailing_update<" not in got.split("geqrf_panel_kernel(")[1]
    assert f"geqrf_panel_bytes(n) + 4 * kPanel * {mod.WY_CHUNK}" in got


def test_jacobi_variants_imports_neither_jax_nor_reference():
    code = ("import sys, runpy\n"
            "sys.argv = ['jacobi_variants.py']\n"
            "runpy.run_path('jacobi_variants.py', run_name='not_main')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpumathlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("name", ["skip", "pair_sums", "syevd_unroll1", "gesvd_unroll1",
                                  "blocks5"])
def test_jacobi_variants_edit_the_source(name):
    """Each variant's edits still find their text in csrc/dx_jacobi_block.cu
    and change it; the pair_sums variant's header holds the warp route's
    pair_sums."""
    mod = _load("jacobi_variants")
    assert sorted(mod.VARIANTS) == sorted(["skip", "pair_sums", "syevd_unroll1", "gesvd_unroll1",
                                           "blocks5"])
    assert mod.edited(name) != mod.SRC.read_text()
    if name == "pair_sums":
        assert "void pair_sums(" in mod.pair_sums_header()


FUSED_VARIANTS = ["decode_dot:no_decode", "decode_dot:no_products", "decode_dot:no_stores",
                  "decode_dot:no_fetch", "decode_dot:funnel_only", "decode_dot:stores_cs",
                  "decode_dot:stamps", "gemm_fft:no_fft", "gemm_fft:no_products"]


def test_fused_variants_imports_neither_jax_nor_reference():
    code = ("import sys, runpy\n"
            "sys.argv = ['fused_variants.py']\n"
            "runpy.run_path('fused_variants.py', run_name='not_main')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpumathlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("name", FUSED_VARIANTS)
def test_fused_variants_edit_the_source(name):
    """Each variant's edits still find their text in csrc/dx_comp.cu or
    csrc/dx_fused.cu and change it; the stamped variant stamps every slot
    the summary reads."""
    mod = _load("fused_variants")
    assert sorted(mod.VARIANTS) == sorted(FUSED_VARIANTS)
    kernel = name.split(":")[0]
    src = (mod.cuda_utils.CSRC / mod.SOURCES[kernel][0]).read_text()
    got = mod.edited(name)
    assert got != src
    if name == "decode_dot:stamps":   # the consumers' slots 0, 1 + q, 5 and the decoders' 0, 1, 2 + q
        for stamp in ("STAMP(cg, i >> 1, 0)", "STAMP(cg, i >> 1, 1 + q)", "STAMP(cg, i >> 1, 5)",
                      "STAMP(2 + dw, i >> 1, 0)", "STAMP(2 + dw, i >> 1, 1)",
                      "STAMP(2 + dw, i >> 1, 2 + q)"):
            assert stamp in got
