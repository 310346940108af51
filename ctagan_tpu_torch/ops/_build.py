"""Build and load the port's CUDA kernels.

The sources in ``ctagan_tpu_torch/csrc/`` have a plain C interface. On first
use each ``.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all at
once, and the objects are linked into one shared library under
``build/ctagan_tpu_torch/`` at the repository root, which is rebuilt whenever
a source is newer than it, and loaded with ``ctypes``. Every C entry point
returns ``cudaGetLastError()`` after its launch; :func:`launch` raises on a
nonzero code, and a failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ctagan_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libctagan_kernels.so")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# entry point -> argtypes (pointers and the stream as c_void_p)
_SIGNATURES = {
    # x, skip, w_hi, w_lo, b, norm, out, stats, xnew, n, h, w, c, cout, relu,
    # bf16, stream
    "ctk_conv3x3_reflect_stats": [_P] * 9 + [_I] * 7 + [_P],
    # x, w_hi, w_lo, b, norm, out, stats, n, h, w, c, cout, relu, bf16,
    # stream
    "ctk_conv3x3_s2_zero_stats": [_P] * 7 + [_I] * 7 + [_P],
    # x, w_hi, w_lo, b, norm, out, stats, n, h, w, c, cout, relu, bf16,
    # stream
    "ctk_convt2x_stats": [_P] * 7 + [_I] * 7 + [_P],
    # g, w_hi, w_lo, out, n, h, w, c, cout, bf16, stream
    "ctk_conv3x3_zero_corr": [_P] * 4 + [_I] * 6 + [_P],
    # x, skip, g_hi, g_lo, norm, dw, n, h, w, c, cout, hwp, relu, bn, per,
    # splits, bf16, stream
    "ctk_conv3x3_weight_grad": [_P] * 6 + [_I] * 11 + [_P],
    # g, hi, lo, n, hw, hwp, cout, bf16, stream
    "ctk_k5_operands": [_P] * 3 + [_I] * 5 + [_P],
    # x, w, scale, b, norm, out, stats, n, h, w, c, cout, in_kind, out_bf16,
    # qmul, stream
    "ctk_conv3x3_reflect_s8": [_P] * 7 + [_I] * 7 + [_F, _P],
    # x, out, scratch, counters, n, h, w, c, act, bf16, eps, vec, group,
    # cluster, band, chunks, stream
    "ctk_instance_norm": [_P] * 4 + [_I] * 6 + [_F] + [_I] * 5 + [_P],
    # bf16, vec, group, cluster, band, &count
    "ctk_instance_norm_clusters": [_I] * 5 + [ctypes.POINTER(_I)],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))), sorted(
        glob.glob(os.path.join(SRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library is missing or older than a source;
    returns the library path. ``verbose``: pass ``-Xptxas -v`` and print
    what nvcc reports (each kernel's registers, shared memory, spills)."""
    cu, cuh = _sources()
    if not cu:
        raise RuntimeError(f"no CUDA sources in {SRC_DIR}")
    newest = max(os.path.getmtime(f) for f in cu + cuh)
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(f)}.{tag}.o")
            for f in cu]
    jobs = [[nvcc, *flags, "-c", src, "-o", obj]
            for src, obj in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for cmd in jobs]  # one nvcc per source, all at once
    results = [(cmd, p.communicate()[1], p.returncode)
               for cmd, p in zip(jobs, procs)]
    tmp = f"{LIB_PATH}.{tag}.tmp"
    if all(rc == 0 for _, _, rc in results):
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        link = subprocess.run(cmd, capture_output=True, text=True)
        results.append((cmd, link.stderr, link.returncode))
    for f in objs:
        if os.path.exists(f):
            os.remove(f)
    for cmd, err, rc in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
        if verbose and err:
            print(err, end="", flush=True)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build(verbose))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ctk_error_string.argtypes = [ctypes.c_int]
            lib.ctk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if its launch reported a CUDA error."""
    lib = load_library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.ctk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
