"""On-demand build of the CUDA kernels into one shared library.

Every `csrc/*.cu` file is plain CUDA C++ with `extern "C"` launchers (no
PyTorch, pybind11 or CUTLASS headers; `csrc/*.cuh` holds device code they
share), so each compiles with `nvcc` in seconds. The sources compile in
parallel, one `nvcc -c` each, and one `nvcc -shared` links them. The
library is named by a hash of the sources, headers and flags, written
under a temporary name and `os.replace`d into place under a file lock,
so processes started together (the ranks of a data-parallel run) build
it once and a killed build never leaves a half-written library behind. The wrappers
bind it through `ctypes` and pass raw device pointers and the current
stream.

Counterpart of the on-demand C++ build in `dram_tpu/native/__init__.py`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the Hopper conv kernels find cuTensorMapEncodeTiled with dlopen/dlsym
LINK_FLAGS = ("-ldl",)
BUILD_TIMEOUT_S = 180

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int32)
# launcher name -> argtypes (every launcher returns cudaGetLastError(), or
# a negative code of csrc/conv_wgmma.cuh)
SIGNATURES = {
    "conv3x3x3_wgmma_bf16": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                             _P, _I, _P, _I, _I, _I, _I, _PI64, _P],
    "colsum_f32": [_P, _I64, _I64, _I, _P, _P],
    "conv3x3x3_dw_wgmma_bf16": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                                _I, _PI64, _P, _P],
    # queries, not launchers: the wgmma kernels' dynamic shared memory
    "conv3x3x3_wgmma_smem": [_I, _I],
    "conv3x3x3_dw_wgmma_smem": [],
    "conv3x3x3_c1_bf16": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _PI64,
                          _P],
    "conv3x3x3_c1_dw_bf16": [_P, _P, _I, _I, _I, _I, _I, _PI64, _P, _P],
    # queries: the c1 kernels' dynamic shared memory and blocks per SM
    "conv3x3x3_c1_smem": [_I, _I],
    "conv3x3x3_c1_occupancy": [_I, _I],
    "maxpool2_bf16": [_P, _P, _I64, _I64, _I64, _I64, _I64, _P],
    "maxpool2_bwd_bf16": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _P],
    "upsample2x_bf16": [_P, _P, _I64, _I64, _I64, _I64, _I64, _PI64, _P],
    "upsample2x_bwd_bf16": [_P, _P, _I64, _I64, _I64, _I64, _I64, _PI64,
                            _P],
    "stencil_attention_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                              _PI64, _P],
    "stencil_attention_scal_f32": [_P, _P, _P, _P, _P, _I64, _I64, _I64,
                                   _I64, _P],
    "stencil_attention_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                  _I64, _I64, _I64, _PI64, _P],
    "stencil_attention_generic_f32": [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                      _I64, _I64, _PI32, _I64, _PI64, _P],
    "stencil_attention_scal_generic_f32": [_P, _P, _P, _P, _P, _I64, _I64,
                                           _I64, _I64, _I64, _I64, _PI32,
                                           _I64, _P],
    "stencil_attention_bwd_generic_f32": [_P, _P, _P, _P, _P, _P, _P, _P,
                                          _I64, _I64, _I64, _I64, _I64, _I64,
                                          _PI32, _I64, _PI64, _P],
    # queries: blocks per SM of the generic plane-ring kernels
    "stencil_attention_generic_occupancy": [_I, _I, _I],
    "stencil_attention_bwd_generic_occupancy": [_I, _I, _I, _I],
}

_lock = threading.Lock()
_lib = None


def _sources(suffixes=(".cu",)):
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(suffixes))


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of dram_tpu_torch cannot be built")


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources((".cu", ".cuh")):
        with open(src, "rb") as fp:
            h.update(os.path.basename(src).encode() + fp.read())
    return os.path.join(BUILD_DIR, f"libdram_kernels_{h.hexdigest()[:16]}.so")


def ptxas_log_path():
    """Where a build keeps ptxas's report (-Xptxas -v: registers, shared
    memory and spills of every kernel), beside the library."""
    return library_path()[:-len(".so")] + ".ptxas.txt"


def _compile(out):
    """Compile every source in parallel, then link; raise with nvcc's
    stderr on a failure or when BUILD_TIMEOUT_S runs out. ptxas's report
    goes to ptxas_log_path()."""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    deadline = time.monotonic() + BUILD_TIMEOUT_S
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors, logs = [], []
        for src, p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for _, q in procs:
                    q.kill()
                raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s "
                                   f"compiling {src}") from None
            if p.returncode != 0:
                errors.append(f"{src}:\n{err}")
            logs.append(f"# {os.path.basename(src)}\n{err}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = os.path.join(tmp, "lib.so")
        try:
            res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                                  tmp_lib, *LINK_FLAGS],
                                 capture_output=True, text=True,
                                 timeout=max(1.0,
                                             deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"nvcc link timed out after "
                               f"{BUILD_TIMEOUT_S} s") from None
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stderr)
        tmp_log = os.path.join(tmp, "ptxas.txt")
        with open(tmp_log, "w") as fp:
            fp.write("\n".join(logs))
        os.replace(tmp_log, out[:-len(".so")] + ".ptxas.txt")
        os.replace(tmp_lib, out)


def ensure_built(path, compile_fn=None):
    """Build the library at `path` unless it exists, under a file lock
    in BUILD_DIR: of processes that race here, the first builds and the
    others wait for it and find the library built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "kernels.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(path):
            (compile_fn or _compile)(path)
    return path


def load():
    """The kernels' ctypes library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(ensure_built(library_path()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_operand(t, dtype, name):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` whose data
    pointer is 16-byte aligned (the kernels use 128-bit accesses)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def launch(name, *args):
    """Call launcher `name` on the current stream; raise on a CUDA error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(load(), name)(*args, stream)
    if err < 0:
        raise RuntimeError(f"{name}: launcher error {err} (-1: plan not "
                           "this build's, -2: no cuTensorMapEncodeTiled, "
                           "-100 - r: tensor map encode returned r)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
