"""Build the CUDA kernels of `csrc/` into one shared library, on first use.

Every `csrc/*.cu` is compiled by its own `nvcc` process (all started
together) for `sm_90a`, then linked into one shared library with a
plain C interface, which is loaded with `ctypes`. The library lands in
`atmvfi_tpu_torch/_build/` (git-ignored) under a name that hashes the
sources and flags, so an edited source is rebuilt and an unchanged one
is reused. A failed build or load raises.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()
build_seconds = None  # wall time of the build this process ran, if any
ptxas_log = ""  # nvcc -Xptxas -v output of the library's build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(srcs, out_path: str) -> None:
    global build_seconds, ptxas_log
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for s in srcs:
            obj = os.path.join(tmp, os.path.basename(s) + ".o")
            objs.append(obj)
            procs.append((s, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", s, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        logs, failed = [], []
        for s, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(s)}\n{out}")
            if p.returncode != 0:
                failed.append(s)
        ptxas_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{ptxas_log}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *objs, "-o", tmp_so], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        with open(out_path + ".ptxas.txt", "w") as f:
            f.write(ptxas_log)
        os.replace(tmp_so, out_path)  # atomic: readers see all or nothing
    build_seconds = time.perf_counter() - t0


def _declare(lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attention_single_pass_keys.argtypes = []
    lib.attention_single_pass_keys.restype = I
    for dt in ("f32", "bf16"):
        fn = getattr(lib, f"atm_block_{dt}")
        # x, wqkv, wproj, bproj, weight maps (bf16), ln_g, ln_b, rel,
        # mask, mask_windows, labels, coords, xn, qkv, app, y, motion,
        # BW, N, C, heads, swap, scale, stream
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, P, P, P, P, P, P, P,
                       I, I, I, I, I, F, P]
        fn.restype = I
        fn = getattr(lib, f"atm_block_launch_{dt}")
        # launch (0 all, or 1, 2, 3 alone), then atm_block's arguments
        fn.argtypes = [I, P, P, P, P, P, P, P, P, P, I, P, P, P, P, P, P,
                       P, I, I, I, I, I, F, P]
        fn.restype = I
        fn = getattr(lib, f"window_attention_{dt}")
        # q, k, v, (sw, sh, sn) x 5 (q, k, v, out, motion), out, motion,
        # rel, mask, mask_windows, labels, coords, BW, N, head_dim, heads,
        # scale, stream
        fn.argtypes = [P, P, P, ctypes.POINTER(ctypes.c_int64), P, P, P, P,
                       I, P, P, I, I, I, I, F, P]
        fn.restype = I
        fn = getattr(lib, f"conv3x3_pair_{dt}")
        # source descriptor (int64 x 5), B, H, W, packed weight a, Kp a,
        # bias a, slope a, Cmid, packed weight b, Kp b, bias b, slope b,
        # out, Cout, out pixel stride, stream
        fn.argtypes = [ctypes.POINTER(ctypes.c_int64), I, I, I, P, I, P, P,
                       I, P, I, P, P, P, I, ctypes.c_int64, P]
        fn.restype = I
        fn = getattr(lib, f"warp_{dt}")
        # img0, img1, flow0, flow1, out0, out1, n_img, B, H, W, C,
        # in_pixel_stride, stream
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, ctypes.c_int64, P]
        fn.restype = I
        for name in ("conv3x3", "conv3x3s2", "conv3x3_multi"):
            fn = getattr(lib, f"{name}_{dt}")
            # source descriptors (int64 x 5 each), nsrc, B, H, W, stride,
            # packed weight, Kp, bias, slope, out, Cout, out pixel stride,
            # stream
            fn.argtypes = [ctypes.POINTER(ctypes.c_int64), I, I, I, I, I, P,
                           I, P, P, P, I, ctypes.c_int64, P]
            fn.restype = I
        fn = getattr(lib, f"deconv2x_{dt}")
        # x, pixel stride, C, x is f32, x vec, B, H, W, packed weight, Kp,
        # bias, slope, out, Cout, out pixel stride, stream
        fn.argtypes = [P, ctypes.c_int64, I, I, I, I, I, I, P, I, P, P, P, I,
                       ctypes.c_int64, P]
        fn.restype = I
        fn = getattr(lib, f"flow_warp_rows_{dt}")
        # img, flow, out, B, H_out, H_src, W, C, in_pixel_stride, row0,
        # stream
        fn.argtypes = [P, P, P, I, I, I, I, I, ctypes.c_int64, I, P]
        fn.restype = I
    # img0, img1, flow0, flow1, out0, out1, H_out, H_src, W, C,
    # in_pixel_stride, row0, stream
    lib.warp_pair_srcfull_f32.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                          ctypes.c_int64, I, P]
    lib.warp_pair_srcfull_f32.restype = I
    # img0, img1, flow0, flow1, occ, out, B, H, W, C, in_pixel_stride,
    # stream
    lib.warp_blend_f32.argtypes = [P, P, P, P, P, P, I, I, I, I,
                                   ctypes.c_int64, P]
    lib.warp_blend_f32.restype = I
    # a, b, out, M, N, K, stream (row P's gridded matmul)
    lib.grid_matmul_f32.argtypes = [P, P, P, I, I, I, P]
    lib.grid_matmul_f32.restype = I
    # bf16 weight [N, K], N, K, CUtensorMap out (128 bytes)
    lib.atm_block_weight_map.argtypes = [P, I, I, P]
    lib.atm_block_weight_map.restype = I
    # packed weight, Kp, Cout, stride, taps (9, or 1 for K5's fold),
    # CUtensorMap out (128 bytes), BN out
    lib.conv3x3_wgmma_weight_map.argtypes = [P, I, I, I, I, P,
                                             ctypes.POINTER(ctypes.c_int)]
    lib.conv3x3_wgmma_weight_map.restype = I
    # x, pixel stride, B, H, W, Cin, stride, weight map, BN, bias, slope,
    # out, Cout, out pixel stride, stream
    lib.conv3x3_wgmma_bf16.argtypes = [P, ctypes.c_int64, I, I, I, I, I, P,
                                       I, P, P, P, I, ctypes.c_int64, P]
    lib.conv3x3_wgmma_bf16.restype = I
    # BN, stride
    lib.conv3x3_wgmma_smem_bytes.argtypes = [I, I]
    lib.conv3x3_wgmma_smem_bytes.restype = I
    # K5: source descriptors (int64 x 5 each), nsrc, B, H, W, weight map,
    # BN, fold, bias, slope, out, Cout, out pixel stride, stream
    lib.conv3x3_multi_wgmma_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_int64), I, I, I, I, P, I, I, P, P, P, I,
        ctypes.c_int64, P]
    lib.conv3x3_multi_wgmma_bf16.restype = I
    # K6: packed weight [N, Kp], N, Kp, column tile (0: the plan's),
    # CUtensorMap out (128 bytes), column tile out
    lib.deconv2x_wgmma_weight_map.argtypes = [P, I, I, I, P,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.deconv2x_wgmma_weight_map.restype = I
    # x, pixel stride, B, H, W, Cin, weight map, column tile, bias, slope,
    # out, Cout, out pixel stride, stream
    lib.deconv2x_wgmma_bf16.argtypes = [P, ctypes.c_int64, I, I, I, I, P, I,
                                        P, P, P, I, ctypes.c_int64, P]
    lib.deconv2x_wgmma_bf16.restype = I


def load_library():
    """Return the loaded kernel library, building it first if needed
    (`ptxas_log` holds the build's register and spill report either way)."""
    global _lib, ptxas_log
    with _lock:
        if _lib is None:
            srcs = _sources()
            path = os.path.join(BUILD_DIR,
                                f"libatmvfi_kernels_{_digest(srcs)}.so")
            if not os.path.exists(path):
                _build(srcs, path)
            elif os.path.exists(path + ".ptxas.txt"):
                with open(path + ".ptxas.txt") as f:
                    ptxas_log = f.read()
            lib = ctypes.CDLL(path)
            _declare(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error code."""
    if rc != 0:
        name = load_library().cuda_error_name
        name.restype = ctypes.c_char_p
        name.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({name(rc).decode()})")
